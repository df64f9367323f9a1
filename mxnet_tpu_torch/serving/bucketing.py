"""Shape bucketing of the port (mirrors ``mxnet_tpu/serving/bucketing.py``):
pad ragged request batches to a fixed bucket set.

A serving queue that hands the model whatever batch size happens to be
waiting (1, 3, 7, 5, ...) would need one program per size. The fix
(TensorFlow Serving's BatchingSession) is to admit only a small fixed
set of batch shapes: pad every micro-batch up to the nearest *bucket*
(powers of two up to the max batch size) and prepare every bucket once
at startup. On the card ``ModelServer.warmup()`` captures one CUDA graph
per bucket, so after it no request can trigger a capture.

Padding rows are zeros; because rows of a batched forward pass are
computed independently, the padded rows change nothing about the real
rows, and the only cost is the wasted work of the pad — tracked per
batch as ``padded_waste`` so the bucket set can be tuned against real
traffic. Pure numpy, the reference's bucket math unchanged.
"""
from __future__ import annotations

import numpy as np

__all__ = ["bucket_sizes", "pick_bucket", "pad_batch", "pad_to_bucket",
           "waste_fraction", "BucketSpec"]


def bucket_sizes(max_batch, min_bucket=1):
    """Powers of two from ``min_bucket`` up to ``max_batch``; a
    non-power-of-two ``max_batch`` is appended as the top bucket."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if min_bucket < 1 or min_bucket > max_batch:
        raise ValueError(
            f"min_bucket must be in [1, {max_batch}], got {min_bucket}")
    out = []
    b = 1
    while b <= max_batch:
        if b >= min_bucket:
            out.append(b)
        b *= 2
    if not out or out[-1] != max_batch:
        out.append(max_batch)
    return out


def pick_bucket(n, buckets):
    """Smallest bucket >= n. ``buckets`` must be sorted ascending."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(
        f"batch of {n} exceeds the largest bucket {buckets[-1]}; the "
        "batcher must cap micro-batches at max(buckets)")


def pad_to_bucket(rows, bucket, axis=0):
    """Zero-pad ``rows`` along ``axis`` up to ``bucket`` entries.

    The one padding primitive behind both serving paths: the single-shot
    server pads the BATCH axis of a stacked micro-batch, the LLM prefill
    path pads the LENGTH axis of a prompt. Returns the input itself when
    the axis is already bucket-sized, so the full-bucket fast path
    copies nothing.
    """
    n = rows.shape[axis]
    if n == bucket:
        return rows
    if n > bucket:
        raise ValueError(f"batch of {n} does not fit bucket {bucket}")
    widths = [(0, 0)] * rows.ndim
    widths[axis] = (0, bucket - n)
    return np.pad(rows, widths)


def pad_batch(rows, bucket):
    """Zero-pad a stacked ``(n, *item)`` batch up to ``(bucket, *item)``."""
    return pad_to_bucket(rows, bucket, axis=0)


def waste_fraction(n, bucket):
    """Fraction of the bucket's rows that are padding."""
    return (bucket - n) / float(bucket)


class BucketSpec:
    """One bucket set + its pick/pad/waste/warmup discipline.

    Owns what used to be copy-pasted bucket math at each call site: the
    sorted bucket list, smallest-fitting-bucket selection, zero-pad to
    the bucket along a configurable axis, padded-waste accounting, and
    the warmup iteration order (every bucket exactly once, ascending, so
    warmup prepares every shape the caller can emit). ``ModelServer``
    uses it over the batch axis.
    """

    def __init__(self, buckets, axis=0):
        buckets = sorted(set(int(b) for b in buckets))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be >= 1, got {buckets}")
        self.buckets = buckets
        self.axis = axis

    @classmethod
    def pow2(cls, max_size, min_bucket=1, axis=0, multiple_of=1):
        """Powers of two up to ``max_size`` (the classic serving set),
        each rounded UP to a multiple of ``multiple_of`` and de-duped —
        the page-aligned variant the paged-KV prefill path needs.
        ``max_size`` must itself be aligned, or the rounded top bucket
        would exceed it (shapes past the caller's cap)."""
        if multiple_of > 1 and max_size % multiple_of:
            raise ValueError(
                f"max_size {max_size} is not a multiple of "
                f"{multiple_of}; the top bucket must cover max_size "
                "without exceeding it")
        sizes = bucket_sizes(max_size, min_bucket=min_bucket)
        if multiple_of > 1:
            sizes = [-(-b // multiple_of) * multiple_of for b in sizes]
        return cls(sizes, axis=axis)

    @property
    def max_size(self):
        return self.buckets[-1]

    def pick(self, n):
        """Smallest bucket >= n."""
        return pick_bucket(n, self.buckets)

    def pad(self, rows, bucket=None):
        """Pad ``rows`` along the spec's axis to ``bucket`` (default:
        the smallest fitting bucket). Returns (padded, bucket)."""
        n = rows.shape[self.axis]
        if bucket is None:
            bucket = self.pick(n)
        return pad_to_bucket(rows, bucket, axis=self.axis), bucket

    def waste(self, n, bucket=None):
        if bucket is None:
            bucket = self.pick(n)
        return waste_fraction(n, bucket)

    def warmup_shapes(self, item_shape):
        """(bucket, shape) per bucket, ascending: the shapes a warmup
        loop must prepare so steady state can never capture again."""
        item_shape = tuple(item_shape)
        out = []
        for b in self.buckets:
            shape = (item_shape[:self.axis] + (b,)
                     + item_shape[self.axis:])
            out.append((b, shape))
        return out

    def __iter__(self):
        return iter(self.buckets)

    def __len__(self):
        return len(self.buckets)

    def __repr__(self):
        return f"BucketSpec({self.buckets}, axis={self.axis})"

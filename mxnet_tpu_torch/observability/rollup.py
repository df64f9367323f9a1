"""Device-trace rollup of the port: per-kernel-family time attribution
(the port of ``mxnet_tpu/observability/rollup.py``).

It reads the gzipped Chrome trace ``mx.profiler`` writes
(``<dir>/plugins/profile/<run>/<host>.trace.json.gz``, torch's profiler
export). Entry points, with the reference's JSON shapes:

- :func:`rollup` — sum the durations of the card's events (the
  categories that ``mx.profiler``'s :data:`LANE_OF_CATEGORY` puts on the
  ``device`` lane: ``kernel``, ``gpu_memcpy``, ``gpu_memset``) grouped by
  :func:`family_of`;
- :func:`diff` / :func:`format_diff` — the before/after report between
  two captures;
- :func:`summary` — a compact JSON-able digest: total ms/step plus the
  top families with their share.

Families (:func:`family_of`): the port's own kernels by their entry
names (``paged_ring``, ``flash_fwd``, ``flash_bwd_dkv``, ``flash_bwd_dq``,
their ``_sm90`` 16-bit versions, ``wq_matmul``, ``multi_tensor_update``);
library matrix products as ``gemm`` and convolutions as ``conv`` (by the
cuBLAS, cuBLASLt, CUTLASS and cuDNN kernel names); torch's elementwise
and reduction kernels as ``elementwise`` and ``reduce``; copies and fills
as ``memcpy`` and ``memset``; anything else by its bare function name.

The reference excludes the scan wrapper (``while.*``), whose body XLA
counts once inside it. A CUDA trace has no such wrapper: a kernel event
is one launch, so nothing is excluded here.

A capture with no device events (a CPU run) raises :class:`RollupError`
rather than passing host time off as device time.
"""
from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re

from ..profiler import LANE_OF_CATEGORY

__all__ = ["RollupError", "find_trace", "rollup", "family_table",
           "diff", "format_diff", "summary", "family_of"]

# (substring of the kernel's name, family), first match wins: the
# port's kernels (csrc/), longest names first
_PORT_KERNELS = (
    ("flash_fwd_sm90_kernel", "flash_fwd_sm90"),
    ("flash_dkv_sm90_kernel", "flash_bwd_dkv_sm90"),
    ("flash_dq_sm90_kernel", "flash_bwd_dq_sm90"),
    ("flash_fwd_kernel", "flash_fwd"),
    ("flash_dkv_kernel", "flash_bwd_dkv"),
    ("flash_dq_kernel", "flash_bwd_dq"),
    ("paged_ring_kernel", "paged_ring"),
    ("wq_mma_kernel", "wq_matmul"),
    ("multi_update_kernel", "multi_tensor_update"),
)
# library kernels by a substring of the name (lower case), in order: a
# cuDNN convolution kernel's name holds "gemm" too
_LIBRARY = (
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "cudnn")),
    ("gemm", ("gemm", "gemv", "nvjet", "cutlass", "cublas",
              "splitkreduce")),
    ("elementwise", ("elementwise_kernel",)),
    ("reduce", ("reduce_kernel",)),
)


class RollupError(ValueError):
    """The capture cannot be rolled up (no trace file, no device events).
    ValueError so library callers can catch it without importing this
    module's internals."""


def find_trace(path):
    """Resolve ``path`` (a trace file, or a capture directory holding
    one) to the newest ``*.trace.json.gz`` under it."""
    if os.path.isfile(path):
        return path
    hits = glob.glob(os.path.join(path, "**", "*.trace.json.gz"),
                     recursive=True)
    if not hits:
        raise RollupError(f"no *.trace.json.gz under {path}")
    return sorted(hits)[-1]


def _load_events(trace):
    opener = gzip.open if trace.endswith(".gz") else open
    with opener(trace) as f:
        data = json.load(f)
    return data.get("traceEvents", [])


def _bare(name):
    """The function's own name: no ``void``, return type, namespaces,
    template arguments or parameter list."""
    n = name.replace("(anonymous namespace)::", "").strip()
    for cut in ("<", "("):
        i = n.find(cut)
        if i > 0:
            n = n[:i]
    n = n.split()[-1] if n.split() else n
    return n.split("::")[-1]


def family_of(op_name):
    """The family of a device event's name (see the module's docstring);
    for an unknown kernel its bare name, trailing digits/dots stripped."""
    for key, fam in _PORT_KERNELS:
        if key in op_name:
            return fam
    low = op_name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    for fam, keys in _LIBRARY:
        if any(k in low for k in keys):
            return fam
    return re.sub(r"[.\d]+$", "", _bare(op_name)) or op_name


def rollup(path):
    """Per-family device time of one capture.

    Returns ``(families, total_us)`` where ``families`` is a Counter of
    microseconds by family. A capture with no device event raises
    :class:`RollupError`.
    """
    cats = {c for c, lane in LANE_OF_CATEGORY.items() if lane == "device"}
    trace = find_trace(path)
    fam = collections.Counter()
    total = 0
    seen = False
    for e in _load_events(trace):
        if e.get("ph") != "X" or e.get("cat") not in cats:
            continue
        seen = True
        d = e.get("dur", 0)
        fam[family_of(e.get("name", ""))] += d
        total += d
    if not seen:
        raise RollupError(
            f"{trace}: no device events ({'/'.join(sorted(cats))}) — "
            "this is not a capture of the card")
    if total == 0:
        raise RollupError(f"{trace}: device events present but empty")
    return fam, total


def family_table(fam, total, steps=50, top=12):
    """Printable ms/step + share table of one rollup."""
    lines = [f"{total / 1e3:.1f} ms device time over {steps} steps -> "
             f"{total / 1e3 / steps:.2f} ms/step"]
    for name, d in fam.most_common(top):
        lines.append(f"  {d / 1e3 / steps:7.2f} ms/step "
                     f"{100 * d / total:5.1f}%  {name}")
    return "\n".join(lines)


def diff(before, after, steps=50):
    """Structured A→B comparison of two captures (paths or pre-computed
    ``(families, total)`` pairs): per-family ms/step deltas sorted by
    magnitude plus the total shift."""
    fa, ta = before if isinstance(before, tuple) else rollup(before)
    fb, tb = after if isinstance(after, tuple) else rollup(after)
    fams = sorted(set(fa) | set(fb),
                  key=lambda k: -abs(fb.get(k, 0) - fa.get(k, 0)))
    rows = []
    for k in fams:
        a_us, b_us = fa.get(k, 0), fb.get(k, 0)
        rows.append({
            "family": k,
            "before_ms_per_step": round(a_us / 1e3 / steps, 4),
            "after_ms_per_step": round(b_us / 1e3 / steps, 4),
            "delta_ms_per_step": round((b_us - a_us) / 1e3 / steps, 4),
        })
    return {
        "steps": steps,
        "total_before_ms_per_step": round(ta / 1e3 / steps, 4),
        "total_after_ms_per_step": round(tb / 1e3 / steps, 4),
        "total_delta_ms_per_step": round((tb - ta) / 1e3 / steps, 4),
        "families": rows,
    }


def format_diff(report, top=12, threshold_ms=0.005):
    """Human rendering of a :func:`diff` report (B - A, ms/step)."""
    lines = [
        "delta (B - A), ms/step: total "
        f"{report['total_delta_ms_per_step']:+.2f} "
        f"({report['total_before_ms_per_step']:.2f} -> "
        f"{report['total_after_ms_per_step']:.2f})"]
    for row in report["families"][:top]:
        d = row["delta_ms_per_step"]
        if abs(d) > threshold_ms:
            lines.append(f"  {d:+7.2f}  {row['family']}")
    return "\n".join(lines)


def summary(path, steps=50, top=8):
    """Compact digest of a capture: total ms/step plus the top families
    with their share. Returns a plain-JSON dict; raises
    :class:`RollupError` like :func:`rollup`."""
    fam, total = rollup(path)
    return {
        "trace": find_trace(path),
        "steps": steps,
        "device_ms_per_step": round(total / 1e3 / steps, 4),
        "families": [
            {"family": name,
             "ms_per_step": round(d / 1e3 / steps, 4),
             "share_pct": round(100 * d / total, 2)}
            for name, d in fam.most_common(top)],
    }

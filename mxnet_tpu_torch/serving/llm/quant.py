"""Weight quantization for LLM serving (the port of
``mxnet_tpu/serving/llm/quant.py``).

A float32 param tree is converted offline and deterministically to
per-output-channel int8, or fp8-e4m3, weights plus an f32 scale vector
per 2-D matrix. The arithmetic is the JAX package's, on host numpy, so
the int8 bytes and every scale are identical; only the fp8 cast runs in
torch (``torch.float8_e4m3fn``), because numpy has no fp8 type without
``ml_dtypes``. Quantized leaves come back as CPU torch tensors.

Quantization is symmetric per output channel (the last axis of every
2-D float leaf): ``scale[c] = range(W[:, c]) / QMAX`` and
``W_q[:, c] = round/cast(W[:, c] / scale[c])``, with ``range`` the
absmax, a percentile of ``|W|``, or (``auto``) whichever of the two
gives the lower matmul error on a calibration batch.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["QuantizedWeights", "quantize_weights", "quantize_leaf",
           "dequantize_leaf", "fp8_supported", "resolve_weight_dtype",
           "calibration_error", "flatten_params", "unflatten_params",
           "FP8_NAME", "FP8_MAX", "WEIGHT_DTYPES"]

FP8_NAME = "float8_e4m3fn"
FP8_MAX = 448.0                      # e4m3fn finite max
_SCALE_FLOOR = 1e-8                  # all-zero channels quantize to 0
WEIGHT_DTYPES = ("int8", "fp8", FP8_NAME)


def fp8_supported():
    """True when this torch build carries ``float8_e4m3fn``."""
    return hasattr(torch, FP8_NAME)


def resolve_weight_dtype(name):
    """Canonicalize a weight/KV dtype request. Returns
    ``(canonical_name_or_None, fell_back)`` — ``None`` means full
    precision; ``fell_back`` is True when fp8 was requested but torch
    lacks the dtype (callers count a warning and serve int8)."""
    if name is None:
        return None, False
    name = str(name).strip().lower()
    if name in ("", "float32", "f32", "fp32", "none"):
        return None, False
    if name == "int8":
        return "int8", False
    if name in ("fp8", "e4m3", "float8", FP8_NAME, "float8_e4m3"):
        if fp8_supported():
            return FP8_NAME, False
        return "int8", True
    raise ValueError(
        f"unsupported weight dtype {name!r} (expected float32, int8 "
        f"or fp8/{FP8_NAME})")


def flatten_params(tree, prefix=""):
    """Flatten a nested dict/list param tree to ``{dot.path: leaf}``
    (list positions become digit segments)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_params(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_params(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


def unflatten_params(flat):
    """Inverse of :func:`flatten_params`."""
    params = {}
    for key, arr in flat.items():
        parts = str(key).split(".")
        node = params
        for i, p in enumerate(parts[:-1]):
            nxt = [] if parts[i + 1].isdigit() else {}
            if p.isdigit():
                p = int(p)
                while len(node) <= p:
                    node.append(type(nxt)())
            elif p not in node:
                node[p] = nxt
            node = node[p]
        leaf = parts[-1]
        if leaf.isdigit():
            while len(node) <= int(leaf):
                node.append(None)
            node[int(leaf)] = arr
        else:
            node[leaf] = arr
    return params


def _channel_range(w, method, percentile):
    a = np.abs(w)
    if method == "percentile":
        return np.percentile(a, percentile, axis=0).astype(np.float32)
    if method == "absmax":
        return a.max(axis=0).astype(np.float32)
    raise ValueError(f"unknown calibration method {method!r}")


def _as_numpy(w):
    if isinstance(w, torch.Tensor):
        return w.detach().cpu().numpy()
    return np.asarray(w)


def quantize_leaf(w, dtype="int8", method="absmax", percentile=99.9,
                  per_channel=True):
    """Quantize one 2-D f32 matrix. Returns ``(q, scale)`` as CPU
    tensors: ``q`` int8 or float8_e4m3fn, ``scale`` f32 ``[cols]`` (or
    ``[1]`` with ``per_channel=False``). fp8 values are clipped to ±448
    before the cast, as the JAX package does (its numpy cast would NaN;
    torch's saturates — the clip makes both the same)."""
    w = _as_numpy(w).astype(np.float32, copy=False)
    if w.ndim != 2:
        raise ValueError(f"quantize_leaf wants 2-D weights, got {w.shape}")
    if per_channel:
        rng = _channel_range(w, method, percentile)
    else:
        rng = np.asarray(
            [_channel_range(w.reshape(-1, 1), method, percentile)[0]],
            np.float32)
    if dtype in ("fp8", "e4m3", "float8", "float8_e4m3"):
        dtype = FP8_NAME
    if dtype == "int8":
        scale = np.maximum(rng / 127.0, _SCALE_FLOOR).astype(np.float32)
        q = torch.from_numpy(
            np.clip(np.rint(w / scale), -127, 127).astype(np.int8))
    elif dtype == FP8_NAME:
        scale = np.maximum(rng / FP8_MAX, _SCALE_FLOOR).astype(np.float32)
        q = torch.from_numpy(
            np.clip(w / scale, -FP8_MAX, FP8_MAX).astype(np.float32)
        ).to(torch.float8_e4m3fn)
    else:
        raise ValueError(f"unsupported quantized dtype {dtype!r}")
    return q, torch.from_numpy(scale)


def dequantize_leaf(q, scale):
    """f32 reconstruction ``q * scale`` (broadcast over the channel
    axis)."""
    return q.float() * scale.float()


def calibration_error(w, q, scale, xs):
    """Mean absolute matmul error ``|xs @ W - (xs @ W_q) * scale|``
    over a calibration batch ``xs [B, K]`` (host numpy, f32)."""
    w = _as_numpy(w).astype(np.float32, copy=False)
    xs = _as_numpy(xs).astype(np.float32, copy=False)
    ref = xs @ w
    got = (xs @ q.float().numpy()) * scale.numpy()
    return float(np.mean(np.abs(ref - got)))


class QuantizedWeights:
    """A quantized checkpoint: ``params`` (the fp32 tree's structure,
    2-D float leaves replaced by int8/fp8 tensors), ``scales`` (flat
    ``{dot.path: [cols] f32}`` over exactly the quantized leaves) plus
    the dtype/calibration provenance. ``LLMEngine`` accepts it in place
    of a param tree."""

    def __init__(self, params, scales, dtype, method="absmax",
                 methods=None):
        self.params = params
        self.scales = dict(scales)
        self.dtype = str(dtype)
        self.method = str(method)
        self.methods = dict(methods or {})

    def dequantize(self):
        """fp32 reconstruction of the full tree."""
        out = {}
        for path, arr in flatten_params(self.params).items():
            out[path] = (dequantize_leaf(arr, self.scales[path])
                         if path in self.scales else arr)
        return unflatten_params(out)

    def nbytes(self):
        """Device-resident weight bytes: quantized leaves + their f32
        scales + untouched leaves."""
        leaves = list(flatten_params(self.params).values())
        leaves += list(self.scales.values())
        return int(sum(a.numel() * a.element_size() for a in leaves))

    def num_params(self):
        return int(sum(a.numel() for a in
                       flatten_params(self.params).values()))

    def __repr__(self):
        return (f"QuantizedWeights(dtype={self.dtype!r}, "
                f"method={self.method!r}, "
                f"quantized_leaves={len(self.scales)})")


def _probe_batch(k, seed, rows=8):
    rs = np.random.RandomState((seed * 1000003 + k) % (2 ** 31 - 1))
    return rs.randn(rows, k).astype(np.float32)


def quantize_weights(params, dtype="int8", method="absmax",
                     percentile=99.9, calib=None, calib_seed=0):
    """Calibration pass: fp32 param tree (numpy arrays or tensors) →
    :class:`QuantizedWeights` on the CPU. Every 2-D float32 leaf is
    quantized per output channel; 1-D leaves stay f32. ``method``:
    ``absmax`` | ``percentile`` | ``auto`` (``calib``: optional flat
    ``{dot.path: [B, K] f32}`` batches, else a seeded Gaussian probe).
    Deterministic: same inputs → bit-identical output."""
    dtype, _ = resolve_weight_dtype(dtype)
    if dtype is None:
        raise ValueError("quantize_weights needs a quantized dtype "
                         "(int8 or fp8); got a full-precision request")
    if method not in ("absmax", "percentile", "auto"):
        raise ValueError(f"unknown calibration method {method!r}")
    flat = flatten_params(params)
    qflat, scales, methods = {}, {}, {}
    for path in sorted(flat):
        w = _as_numpy(flat[path])
        if w.ndim != 2 or w.dtype != np.float32:
            qflat[path] = torch.from_numpy(np.array(w))
            continue
        if method == "auto":
            xs = None if calib is None else calib.get(path)
            if xs is None:
                xs = _probe_batch(w.shape[0], calib_seed)
            best = None
            for m in ("absmax", "percentile"):
                q, s = quantize_leaf(w, dtype, m, percentile)
                err = calibration_error(w, q, s, xs)
                if best is None or err < best[0]:
                    best = (err, m, q, s)
            _, m, q, s = best
        else:
            m = method
            q, s = quantize_leaf(w, dtype, m, percentile)
        qflat[path] = q
        scales[path] = s
        methods[path] = m
    if not scales:
        raise ValueError("param tree has no 2-D float32 leaves to "
                         "quantize")
    return QuantizedWeights(unflatten_params(qflat), scales, dtype,
                            method=method, methods=methods)

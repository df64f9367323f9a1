"""Decoder artifacts of the port (the decoder half of
``mxnet_tpu/deploy.py``): a paged-decode model's config and parameters
in one self-contained file that ``LLMServer`` serves.

The format is the reference's, so either package loads the other's
artifacts: the ``MXTPULLM01`` magic, a u32 header length, a JSON header
(``format: "mxtpu-llm-decoder/npz"``, the ``DecoderConfig`` dict, the
array list and, for a ``QuantizedWeights`` artifact, ``weight_dtype``,
``weight_calib``, ``weight_methods`` and the scaled leaves) and an npz
of the flat ``{dot.path: array}`` tree, each quantized leaf's
per-channel scale under ``scale.<path>``.

numpy cannot name fp8 or bfloat16 without ``ml_dtypes``, so those leaves
are written as void views of their bytes (``|V1``, ``|V2``), the descr
the reference's own npz carries for them, and read back through
:func:`~mxnet_tpu_torch.convert.tensor_from_numpy`.

Not ported (ROADMAP.md, section 1 item 14): ``export_predictor`` /
``load_predictor``, which serialize a ``jax.export`` program.
"""
from __future__ import annotations

import io
import json
import struct

import numpy as _np
import torch

from .convert import numpy_from_tensor, params_from_numpy, \
    tensor_from_numpy
from .resilience.atomic import atomic_write
from .serving.llm.quant import unflatten_params

__all__ = ["export_decoder", "load_decoder", "flatten_params",
           "unflatten_params", "params_from_arrays"]

_LLM_MAGIC = b"MXTPULLM01"
_FORMAT = "mxtpu-llm-decoder/npz"
# scale arrays ride in the same npz under a reserved prefix; the prefix
# contains "." so flatten_params can never produce a colliding path (it
# refuses dotted dict keys)
_SCALE_PREFIX = "scale."


def flatten_params(tree, prefix=""):
    """Flatten a param tree (nested dict/list/tuple of arrays or
    tensors) to a flat ``{dot.joined.path: leaf}`` dict — the shape
    decoder artifacts serialize. Invert with :func:`unflatten_params`
    (all-digit segments become list indices, the rest dict keys).
    Refuses what would not round-trip: an empty subtree, and a dict key
    that is empty, all digits or dotted."""
    out = {}
    if isinstance(tree, (dict, list, tuple)) and not tree:
        raise ValueError(
            f"empty subtree at {prefix[:-1] or '<root>'!r} cannot "
            "round-trip through a decoder artifact")
    if isinstance(tree, dict):
        for k, v in tree.items():
            # the loader treats all-digit segments as list indices
            k = str(k)
            if "." in k or k.isdigit() or not k:
                raise ValueError(
                    f"unsupported param key {prefix + k!r}: decoder "
                    "artifact keys must be non-empty, non-numeric and "
                    "'.'-free (list positions serialize as digits)")
            out.update(flatten_params(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_params(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


def _is_quantized(params):
    return all(hasattr(params, a) for a in ("params", "scales", "dtype"))


def export_decoder(model, params, path=None):
    """Serialize a paged-decode model (a ``TinyDecoder``: ``.config`` and
    its param tree of tensors or numpy arrays, or a ``QuantizedWeights``)
    into a decoder artifact. Returns the bytes; writes ``path``
    atomically if given. Load with :func:`load_decoder` (or the
    reference's), serve with ``serving.llm.LLMServer``."""
    meta = {"format": _FORMAT, "config": model.config.to_dict()}
    qw = None
    if _is_quantized(params):
        qw, params = params, params.params
    flat = {k: numpy_from_tensor(v)
            for k, v in flatten_params(params).items()}
    if qw is not None:
        meta["weight_dtype"] = qw.dtype
        meta["weight_calib"] = qw.method
        if getattr(qw, "methods", None):
            meta["weight_methods"] = dict(qw.methods)
        meta["scales"] = sorted(qw.scales)
        for k, v in qw.scales.items():
            flat[_SCALE_PREFIX + k] = numpy_from_tensor(v)
    buf = io.BytesIO()
    _np.savez(buf, **flat)
    meta["arrays"] = sorted(flat)
    header = json.dumps(meta).encode()
    artifact = _LLM_MAGIC + struct.pack("<I", len(header)) + header \
        + buf.getvalue()
    if path:
        with atomic_write(path) as f:
            f.write(artifact)
    return artifact


def _dtype_name(leaf):
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return leaf.dtype.name


def params_from_arrays(flat, weight_dtype=None, method="absmax",
                       methods=None):
    """Rebuild decoder params from a flat ``{path: array}`` dict, every
    leaf a CPU tensor. With ``scale.``-prefixed entries (a quantized
    weight set) the result is a ``serving.llm.QuantizedWeights`` of
    ``weight_dtype`` (default: the dtype of its first scaled leaf), else
    a plain tree."""
    leaves = {k: tensor_from_numpy(v, "cpu") for k, v in flat.items()}
    scales = {k[len(_SCALE_PREFIX):]: v for k, v in leaves.items()
              if k.startswith(_SCALE_PREFIX)}
    if not scales:
        return unflatten_params(leaves)
    from .serving.llm.quant import QuantizedWeights
    weights = {k: v for k, v in leaves.items()
               if not k.startswith(_SCALE_PREFIX)}
    if weight_dtype is None:
        weight_dtype = _dtype_name(weights[min(scales)])
    return QuantizedWeights(unflatten_params(weights), scales, weight_dtype,
                            method=method, methods=methods)


def load_decoder(path_or_bytes, device="cuda"):
    """Load an artifact of :func:`export_decoder` (or of the reference's).
    Returns ``(model, params)``: a ``TinyDecoder`` on ``device`` (default
    the card; raises without CUDA unless ``device="cpu"``) and its
    params, tensors on ``device`` (a ``QuantizedWeights`` for a
    quantized artifact), ready for ``LLMServer(model, params)``. Raises
    ``ValueError`` on a file that is not a decoder artifact, an unknown
    format or a missing array."""
    from .serving.llm.model import DecoderConfig, TinyDecoder
    artifact = path_or_bytes
    if isinstance(artifact, str):
        with open(artifact, "rb") as f:
            artifact = f.read()
    if not artifact.startswith(_LLM_MAGIC):
        raise ValueError("not an mxnet_tpu decoder artifact")
    off = len(_LLM_MAGIC)
    (hlen,) = struct.unpack_from("<I", artifact, off)
    off += 4
    meta = json.loads(artifact[off:off + hlen].decode())
    if meta.get("format") != _FORMAT:
        raise ValueError(f"unknown decoder format {meta.get('format')!r}")
    flat = dict(_np.load(io.BytesIO(artifact[off + hlen:])))
    missing = set(meta.get("arrays", [])) - set(flat)
    if missing:
        raise ValueError(f"decoder artifact missing arrays: "
                         f"{sorted(missing)[:4]}")
    model = TinyDecoder(DecoderConfig.from_dict(meta["config"]),
                        device=device)
    wdt = meta.get("weight_dtype")
    if not wdt:
        return model, params_from_numpy(unflatten_params(flat),
                                        model.device)
    qw = params_from_arrays(flat, wdt, meta.get("weight_calib", "absmax"),
                            meta.get("weight_methods"))
    return model, params_from_numpy(qw, model.device)

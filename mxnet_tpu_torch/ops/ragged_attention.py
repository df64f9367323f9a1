"""Flat ragged paged attention (the port of the flat path of
``mxnet_tpu/ops/ragged_attention.py``).

A packed ``[T, H, D]`` batch of query tokens from many sequences attends
over a paged KV pool ``[N, bs, H, D]``: token ``t`` belongs to row
``seq_ids[t]`` of ``block_tables [S, MB]`` and sits at absolute position
``positions[t]``, attending causally over positions ``<= positions[t]``
of its sequence's pages. With ``k_scales``/``v_scales`` ``[N, bs, H]``
f32 the pages are int8 or fp8-e4m3 and are dequantised per slot and head.

- :func:`ragged_flat_attention_reference` — the plain gather-based
  version: gather every page of the token's table row, mask, one softmax.
- :func:`ragged_flat_attention` — the entry point. A CPU tensor takes the
  plain version; a CUDA tensor launches ``csrc/ragged_flat.cu`` (f32
  pages: kernel ``flat_attention``, the port of ``_flat_kernel``;
  quantised pages: ``flat_attention_quant.int8`` / ``.fp8``, the port of
  ``_flat_quant_kernel``) or raises. Each launch counts under that name
  in :func:`mxnet_tpu_torch.kernels.launch_counts`.

Outputs of tokens whose table row is padding (the engine's padded tail
tokens) are unspecified and discarded by callers, as on the TPU.
"""
from __future__ import annotations

import torch

from .. import kernels
from .flash_attention import _NEG_INF

__all__ = ["ragged_flat_attention", "ragged_flat_attention_reference",
           "gather_rows", "kernel_name"]

# page dtype -> (C entry point, launch-counter name)
_KERNELS = {
    torch.float32: ("mxt_ragged_flat_f32", "flat_attention"),
    torch.int8: ("mxt_ragged_flat_int8", "flat_attention_quant.int8"),
    torch.float8_e4m3fn: ("mxt_ragged_flat_fp8",
                          "flat_attention_quant.fp8"),
}


def kernel_name(page_dtype):
    """Launch-counter name of the kernel for pages of ``page_dtype``."""
    return _KERNELS[page_dtype][1]


def gather_rows(pool, idx):
    """``pool[idx]`` for any pool dtype: fp8 pools are gathered through a
    byte view, so the index never needs an fp8 kernel."""
    if pool.dtype == torch.float8_e4m3fn:
        return pool.view(torch.uint8)[idx].view(pool.dtype)
    return pool[idx]


def ragged_flat_attention_reference(q, k_pages, v_pages, block_tables,
                                    seq_ids, positions, scale=None,
                                    k_scales=None, v_scales=None):
    """Gather-based plain version: ``q [T, H, D]``, pages ``[N, bs, H,
    D]``, ``block_tables [S, MB]``, ``seq_ids``/``positions [T]``."""
    T, H, D = q.shape
    bs = k_pages.shape[1]
    MB = block_tables.shape[1]
    s = scale if scale is not None else float(1.0 / (D ** 0.5))
    tbl = block_tables[seq_ids.long()].long()             # (T, MB)
    k = gather_rows(k_pages, tbl)
    v = gather_rows(v_pages, tbl)
    if k_scales is not None:
        k = k.float() * k_scales[tbl][..., None]
        v = v.float() * v_scales[tbl][..., None]
    k = k.reshape(T, MB * bs, H, D)
    v = v.reshape(T, MB * bs, H, D)
    logits = torch.einsum("thd,tkhd->htk", q.float(), k.float()) * s
    pos = torch.arange(MB * bs, dtype=torch.int64, device=q.device)
    mask = pos[None, None, :] <= positions.long()[None, :, None]
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("htk,tkhd->thd", probs, v.float())
    return out.to(q.dtype)


def _flat_cuda(q, k_pages, v_pages, block_tables, seq_ids, positions,
               scale, k_scales, v_scales):
    T, H, D = q.shape
    N, bs = k_pages.shape[0], k_pages.shape[1]
    S, MB = block_tables.shape
    dev = q.device
    quant = k_scales is not None
    if D not in (32, 64, 128, 256):
        raise ValueError(f"flat attention kernel takes head_dim 32, 64, "
                         f"128 or 256, got {D}")
    fn, counter = _KERNELS.get(k_pages.dtype, (None, None))
    if fn is None or (k_pages.dtype == torch.float32) == quant:
        raise TypeError(f"unsupported page dtype {k_pages.dtype} "
                        f"({'with' if quant else 'without'} scales)")
    req = kernels.require
    req(q, "q", torch.float32, (T, H, D), dev)
    req(k_pages, "k_pages", k_pages.dtype, (N, bs, H, D), dev)
    req(v_pages, "v_pages", k_pages.dtype, (N, bs, H, D), dev)
    req(block_tables, "block_tables", torch.int32, (S, MB), dev)
    req(seq_ids, "seq_ids", torch.int32, (T,), dev)
    req(positions, "positions", torch.int32, (T,), dev)
    if quant:
        req(k_scales, "k_scales", torch.float32, (N, bs, H), dev)
        req(v_scales, "v_scales", torch.float32, (N, bs, H), dev)
    out = torch.empty((T, H, D), dtype=torch.float32, device=dev)
    if T == 0:
        return out
    lib = kernels.library("ragged_flat")
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    if quant:
        ptrs += [k_scales.data_ptr(), v_scales.data_ptr()]
    ptrs += [block_tables.data_ptr(), seq_ids.data_ptr(),
             positions.data_ptr(), out.data_ptr()]
    rc = getattr(lib, fn)(*ptrs, T, H, D, bs, N, S, MB, float(scale),
                          kernels.stream_handle(dev))
    kernels.check(rc, fn)
    kernels.count_launch(counter)
    return out


def ragged_flat_attention(q, k_pages, v_pages, block_tables, seq_ids,
                          positions, scale=None, k_scales=None,
                          v_scales=None):
    """Flat ragged paged attention. CPU tensors take the plain version;
    CUDA tensors launch the kernel (int32 tables/ids/positions, f32
    ``q``, contiguous) or raise."""
    if scale is None:
        scale = float(1.0 / (q.shape[-1] ** 0.5))
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales or neither")
    if q.device.type == "cpu":
        return ragged_flat_attention_reference(
            q, k_pages, v_pages, block_tables, seq_ids, positions, scale,
            k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no flat attention kernel for {q.device}")
    return _flat_cuda(q, k_pages, v_pages, block_tables, seq_ids,
                      positions, scale, k_scales, v_scales)

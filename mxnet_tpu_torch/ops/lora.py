"""Paged LoRA delta: the adapter-augmented projection of the flat step
(the port of ``mxnet_tpu/ops/lora.py``).

An adapter's low-rank factors live in a fixed paged pool
(:class:`~mxnet_tpu_torch.serving.adapters.AdapterBank`): ``a_pages [P,
L, 4, d, r]`` and ``b_pages [P, L, 4, r, d]``, axis 2 the four attention
projections ``(wq, wk, wv, wo)``, ``r`` the page rank. An adapter of
rank ``R`` owns ``ceil(R / r)`` pages (the tail page zero-padded); page
0 is the all-zero null page. Per-row page tables and scales ride the
step's batch as tensors, so a mixed-adapter pack, adapter-less rows
included, runs in one captured graph and switching adapters captures
nothing.

Two forms of the same delta ``scale * (x @ A) @ B``:

- :func:`paged_lora_delta` over per-token gathered pages
  (:func:`gather_adapter`): the reference's einsum form, which the
  oracles (``TinyDecoder.forward``, ``_incremental_step``) use, as the
  JAX package's do;
- :func:`pool_lora_delta`, the flat step's: one product with the whole
  pool of one (layer, projection), ``x @ A_pool`` (``[T, P_pool * r]``),
  each token keeping only its own pages' columns (a select, not a
  product with a 0/1 mask, so an infinity or NaN in another adapter's
  columns cannot reach it), then ``@ B_pool``, then the scale — the
  reference's order, products first. The reference's gather copies a
  ``[P, d, r]`` factor set per token (about 300 MB a step at 128 tokens
  and GPT-2-small widths); this form reads each pool page once. A row
  whose table holds only the null page (scale 0) gets an exactly-zero
  delta: every column it keeps is the null page's. The second product
  multiplies the zeroed columns by every page's B, so the bank admits
  only finite factors (``AdapterBank.publish``).

The JAX package computes the delta with XLA einsums, outside any Pallas
kernel, so the port computes it with torch products: no kernel of its
own. ``lora_delta`` is the registered dense one-adapter op (``nd``
reaches it).
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["PROJ_Q", "PROJ_K", "PROJ_V", "PROJ_O", "NUM_PROJ",
           "paged_lora_delta", "gather_adapter", "pool_lora_delta",
           "page_mask", "lora_delta"]

# index of each projection along the factor pools' axis 2
PROJ_Q, PROJ_K, PROJ_V, PROJ_O = 0, 1, 2, 3
NUM_PROJ = 4


def paged_lora_delta(x, a_sel, b_sel, scale):
    """Per-token paged low-rank delta ``scale * (x @ A) @ B``.

    x [T, d]; a_sel [T, P, d, r] and b_sel [T, P, r, d], each token's
    gathered factor pages; scale [T] (alpha / rank; 0 = off). Pages are
    rank slices of one factor, so summing their contributions is the
    full-rank product; null and padded pages are all-zero and add an
    exact zero."""
    xa = torch.einsum("td,tpdr->tpr", x, a_sel)
    delta = torch.einsum("tpr,tprd->td", xa, b_sel)
    return delta * scale[:, None]


def gather_adapter(a_pages, b_pages, pages_tok, layer, proj):
    """One (layer, projection)'s factor pages for every token:
    ``pages_tok [T, P]`` page ids (0 = null) into ``a_pages [P_pool, L,
    4, d, r]`` / ``b_pages [P_pool, L, 4, r, d]``; returns (a_sel [T, P,
    d, r], b_sel [T, P, r, d]) for :func:`paged_lora_delta`."""
    idx = pages_tok.long()
    return a_pages[idx, layer, proj], b_pages[idx, layer, proj]


def page_mask(pages_tok, num_pages):
    """``[T, num_pages]`` bool: True where the page is in the token's
    table (the null page's column for every token with a padded table;
    its factors are zero, so it adds an exact zero)."""
    mask = torch.zeros((pages_tok.shape[0], num_pages), dtype=torch.bool,
                       device=pages_tok.device)
    return mask.scatter_(1, pages_tok.long(), True)


def pool_lora_delta(x, a_pool, b_pool, mask, scale):
    """The flat step's delta over the whole pool of one (layer,
    projection): ``a_pool [d, P, r]`` and ``b_pool [P, r, d]`` (views of
    the bank's storage, :meth:`AdapterBank.step_pools`), ``mask [T, P]``
    (:func:`page_mask`), ``scale [T]``. ``where(mask, x @ A, 0) @ B *
    scale``: equal to :func:`paged_lora_delta` over the tokens' gathered
    pages up to the order of the f32 sums."""
    d, P, r = a_pool.shape
    a = a_pool.reshape(d, P * r).to(x.dtype)
    b = b_pool.reshape(P * r, -1).to(x.dtype)
    xa = torch.where(mask[:, :, None], (x @ a).view(-1, P, r), 0.0)
    return (xa.view(-1, P * r) @ b) * scale[:, None]


@register("lora_delta")
def lora_delta(x, a, b, alpha=1.0):
    """Dense single-adapter LoRA delta ``(alpha / rank) * x @ a @ b``
    (a ``[d, R]``, b ``[R, d]``, x ``[..., d]``): the eager and registry
    form of the serving side's :func:`paged_lora_delta`."""
    rank = a.shape[-1]
    return (x @ a) @ b * (float(alpha) / float(rank))

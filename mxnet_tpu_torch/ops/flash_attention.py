"""Dense attention of the port: the plain oracle only.

Mirrors ``mxnet_tpu/ops/flash_attention.py``. The flash forward and
backward kernels there are still to be ported (ROADMAP); what the
serving slice needs is the masked-score constant and the plain
attention the model's dense ``forward`` runs.
"""
from __future__ import annotations

import torch

__all__ = ["attention_reference"]

_NEG_INF = -1e30


def attention_reference(q, k, v, bias=None, causal=False, scale=None):
    """Plain attention, numerically the oracle for the kernels.

    q/k/v: (B, H, T, D); bias: (B, Tk) additive (0 keep / -inf drop).
    """
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / float(d) ** 0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * s
    if bias is not None:
        logits = logits + bias[:, None, None, :].float()
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(diagonal=tk - tq)
        logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)

"""Attention layer of the port (mirrors ``mxnet_tpu/gluon/nn/attention.py``):
projections are ``Dense`` layers and the core is the flash attention op
(:func:`mxnet_tpu_torch.ops.flash_attention.scaled_dot_product_attention`,
CUDA kernels on the card)."""
from __future__ import annotations

from ...ops.flash_attention import scaled_dot_product_attention
from ..block import HybridBlock
from .basic_layers import Dense, Dropout

__all__ = ["MultiHeadAttention"]


class MultiHeadAttention(HybridBlock):
    """Multi-head scaled-dot-product attention.

    Inputs: query (B, Tq, units); optional key/value default to query
    (self-attention); optional ``mask`` is an additive row (B, Tk)
    (0 = attend, large negative = drop). The op sees (B, H, T, D).
    """

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 causal=False, flash=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None):
        super().__init__(prefix=prefix)
        if units % num_heads != 0:
            raise ValueError(
                f"units ({units}) must be divisible by num_heads "
                f"({num_heads})")
        self._num_heads = num_heads
        self._causal = causal
        self._flash = flash
        with self.name_scope():
            common = dict(flatten=False, use_bias=use_bias,
                          weight_initializer=weight_initializer,
                          bias_initializer=bias_initializer)
            self.query_proj = Dense(units, prefix="query_", **common)
            self.key_proj = Dense(units, prefix="key_", **common)
            self.value_proj = Dense(units, prefix="value_", **common)
            self.out_proj = Dense(units, prefix="out_", **common)
            self.dropout_layer = Dropout(dropout) if dropout else None

    def _split_heads(self, x):
        # (B, T, U) -> (B, H, T, D)
        b, t, _ = x.shape
        return x.reshape(b, t, self._num_heads, -1).permute(0, 2, 1, 3)

    def _merge_heads(self, x):
        b, h, t, d = x.shape
        return x.permute(0, 2, 1, 3).reshape(b, t, h * d)

    def forward(self, query, key=None, value=None, mask=None):
        if key is None:
            key = query
        if value is None:
            value = key
        q = self._split_heads(self.query_proj(query))
        k = self._split_heads(self.key_proj(key))
        v = self._split_heads(self.value_proj(value))
        out = scaled_dot_product_attention(q, k, v, mask,
                                           causal=self._causal,
                                           flash=self._flash)
        out = self.out_proj(self._merge_heads(out))
        if self.dropout_layer is not None:
            out = self.dropout_layer(out)
        return out

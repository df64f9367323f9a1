"""BERT of the port (mirrors ``mxnet_tpu/gluon/model_zoo/bert.py``):
learned token/segment/position embeddings, post-LN transformer encoder
on the flash attention op, GELU FFN, tanh pooler. ``bert_base`` is the
published BERT-base configuration (12 layers, 768 units, 3072 hidden,
12 heads, 512 positions, vocab 30522)."""
from __future__ import annotations

import torch

from ..block import HybridBlock
from ..nn import Activation, Dense, Dropout, Embedding, LayerNorm
from ..nn.attention import MultiHeadAttention

__all__ = ["BERTEncoderLayer", "BERTEncoder", "BERTModel", "bert_base",
           "bert_small", "get_bert"]


class BERTEncoderLayer(HybridBlock):
    """One post-LN transformer encoder layer."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.1,
                 flash=True, prefix=None):
        super().__init__(prefix=prefix)
        with self.name_scope():
            self.attention = MultiHeadAttention(units, num_heads,
                                                dropout=dropout,
                                                flash=flash,
                                                prefix="attn_")
            self.attn_ln = LayerNorm(prefix="attn_ln_")
            self.ffn1 = Dense(hidden_size, flatten=False, prefix="ffn1_")
            self.ffn_act = Activation("gelu", prefix="gelu_")
            self.ffn2 = Dense(units, flatten=False, prefix="ffn2_")
            self.ffn_ln = LayerNorm(prefix="ffn_ln_")
            self.dropout_layer = Dropout(dropout) if dropout else None

    def forward(self, x, mask=None):
        att = self.attention(x, None, None, mask)
        x = self.attn_ln(x + att)
        h = self.ffn2(self.ffn_act(self.ffn1(x)))
        if self.dropout_layer is not None:
            h = self.dropout_layer(h)
        return self.ffn_ln(x + h)


class BERTEncoder(HybridBlock):
    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.1, flash=True, prefix=None):
        super().__init__(prefix=prefix)
        with self.name_scope():
            self.layers = []
            for i in range(num_layers):
                layer = BERTEncoderLayer(units, hidden_size, num_heads,
                                         dropout=dropout, flash=flash,
                                         prefix=f"layer{i}_")
                self.register_child(layer, f"layer{i}")
                self.layers.append(layer)

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class BERTModel(HybridBlock):
    """BERT encoder with embeddings and pooler.

    forward(token_ids (B, T), token_types (B, T) | None,
            valid_length (B,) | None) -> (sequence (B, T, U), pooled (B, U))
    """

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 type_vocab_size=2, dropout=0.1, flash=True, prefix=None):
        super().__init__(prefix=prefix)
        self._units = units
        with self.name_scope():
            self.word_embed = Embedding(vocab_size, units,
                                        prefix="word_embed_")
            self.token_type_embed = Embedding(type_vocab_size, units,
                                              prefix="type_embed_")
            self.position_weight = self.params.get(
                "position_embed", shape=(max_length, units))
            self.embed_ln = LayerNorm(prefix="embed_ln_")
            self.embed_dropout = Dropout(dropout) if dropout else None
            self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                       num_heads, dropout=dropout,
                                       flash=flash, prefix="enc_")
            self.pooler = Dense(units, activation="tanh", flatten=False,
                                prefix="pooler_")

    def forward(self, inputs, token_types=None, valid_length=None):
        b, t = inputs.shape
        x = self.word_embed(inputs)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        pos = self.position_weight.data()[:t]
        x = x + pos.reshape(1, t, self._units)
        x = self.embed_ln(x)
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        mask = None
        if valid_length is not None:
            # additive padding row (B, T): 0 for valid, -1e30 for padding
            arange = torch.arange(t, device=x.device).reshape(1, t)
            keep = (arange < valid_length.reshape(-1, 1)).to(x.dtype)
            mask = (1.0 - keep) * -1e30
        seq = self.encoder(x, mask)
        pooled = self.pooler(seq[:, 0, :])
        return seq, pooled


_BERT_CONFIGS = {
    # name: (num_layers, units, hidden, heads)
    "bert_base": (12, 768, 3072, 12),
    "bert_large": (24, 1024, 4096, 16),
    "bert_small": (4, 128, 512, 4),
}


def get_bert(name, vocab_size=30522, **kwargs):
    layers, units, hidden, heads = _BERT_CONFIGS[name]
    return BERTModel(vocab_size=vocab_size, units=units,
                     hidden_size=hidden, num_layers=layers,
                     num_heads=heads, **kwargs)


def bert_base(**kwargs):
    """BERT-base: 12 layers, 768 units, 12 heads."""
    return get_bert("bert_base", **kwargs)


def bert_small(**kwargs):
    """Small BERT for tests: 4 layers, 128 units, 4 heads."""
    return get_bert("bert_small", **kwargs)

"""A small decoder-only transformer in paged-decode form (the port of
``mxnet_tpu/serving/llm/model.py``).

- :meth:`TinyDecoder.forward` — dense causal forward over ``[B, T]``
  tokens, returning logits and the per-layer K/V (the eager oracle);
- :meth:`TinyDecoder.decode_flat` — the engine's step: a packed ``[T]``
  batch of query tokens from many sequences writes its K/V into the
  paged pools IN PLACE and attends over them through
  :func:`~mxnet_tpu_torch.ops.ragged_attention.ragged_flat_attention`
  (f32, int8 or fp8 pages), with int8/fp8 weights routed through
  :func:`~mxnet_tpu_torch.ops.quantization.quantized_matmul`;
- :func:`greedy_decode_reference` — per-sequence greedy decoding over a
  dense cache, the oracle continuous batching must match.

Learned absolute positions, pre-LN blocks, a tanh-approximated GELU MLP
(``jax.nn.gelu``'s default), no q/k/v/o biases, an untied LM head.
Params are a dict tree of tensors (:meth:`TinyDecoder.init_params`
draws the JAX package's numbers from the same numpy seed).
"""
from __future__ import annotations

import numpy as np
import torch

from ..._device import resolve_device
from ...convert import params_from_numpy
from ...ops.flash_attention import _NEG_INF, attention_reference
from ...ops.quantization import quantized_matmul
from ...ops.ragged_attention import gather_rows, ragged_flat_attention

__all__ = ["DecoderConfig", "TinyDecoder", "greedy_decode_reference"]


class DecoderConfig:
    """Shape of a :class:`TinyDecoder`."""

    FIELDS = ("vocab_size", "d_model", "num_layers", "num_heads",
              "d_ff", "max_context")

    def __init__(self, vocab_size=32, d_model=32, num_layers=2,
                 num_heads=2, d_ff=64, max_context=128):
        self.vocab_size = int(vocab_size)
        self.d_model = int(d_model)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.d_ff = int(d_ff)
        self.max_context = int(max_context)
        for f in self.FIELDS:
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1, got {getattr(self, f)}")
        if self.d_model % self.num_heads:
            raise ValueError(
                f"d_model {d_model} not divisible by heads {num_heads}")
        self.head_dim = self.d_model // self.num_heads

    def __repr__(self):
        return ("DecoderConfig(" + ", ".join(
            f"{f}={getattr(self, f)}" for f in self.FIELDS) + ")")


def _layer_norm(x, g, b, eps=1e-5):
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return (x - m) / torch.sqrt(v + eps) * g + b


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def _mlp(h, lp, mm):
    """The residual MLP branch, ``b2`` excluded (callers add it last,
    in the JAX package's order)."""
    x2 = _layer_norm(h, lp["ln2_g"], lp["ln2_b"])
    return mm(_gelu(mm(x2, "w1") + lp["b1"]), "w2")


class TinyDecoder:
    """Decoder-only transformer with paged-decode support, on one
    ``device`` (default ``"cuda"``; raises when CUDA is absent unless
    ``device="cpu"``)."""

    def __init__(self, config=None, device="cuda", **kw):
        self.config = config if config is not None else DecoderConfig(**kw)
        self.device = resolve_device(device)

    @property
    def num_layers(self):
        return self.config.num_layers

    @property
    def num_heads(self):
        return self.config.num_heads

    @property
    def head_dim(self):
        return self.config.head_dim

    @property
    def vocab_size(self):
        return self.config.vocab_size

    @property
    def max_context(self):
        return self.config.max_context

    # ------------------------------------------------------- params --
    def init_params_numpy(self, seed=0):
        """Deterministic random params as host numpy float32 — the same
        numbers, drawn in the same order, as the JAX package's
        ``TinyDecoder.init_params(seed)``."""
        c = self.config
        rs = np.random.RandomState(seed)

        def w(*shape, scale=None):
            scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
            return (rs.randn(*shape) * scale).astype(np.float32)

        layers = []
        for _ in range(c.num_layers):
            layers.append({
                "ln1_g": np.ones(c.d_model, np.float32),
                "ln1_b": np.zeros(c.d_model, np.float32),
                "wq": w(c.d_model, c.d_model),
                "wk": w(c.d_model, c.d_model),
                "wv": w(c.d_model, c.d_model),
                "wo": w(c.d_model, c.d_model),
                "ln2_g": np.ones(c.d_model, np.float32),
                "ln2_b": np.zeros(c.d_model, np.float32),
                "w1": w(c.d_model, c.d_ff),
                "b1": np.zeros(c.d_ff, np.float32),
                "w2": w(c.d_ff, c.d_model),
                "b2": np.zeros(c.d_model, np.float32),
            })
        return {
            "embed": w(c.vocab_size, c.d_model, scale=0.5),
            "pos": w(c.max_context, c.d_model, scale=0.1),
            "lnf_g": np.ones(c.d_model, np.float32),
            "lnf_b": np.zeros(c.d_model, np.float32),
            "head": w(c.d_model, c.vocab_size),
            "layers": layers,
        }

    def init_params(self, seed=0):
        """:meth:`init_params_numpy` as tensors on the model's device."""
        return params_from_numpy(self.init_params_numpy(seed), self.device)

    # ------------------------------------------------------ prefill --
    def forward(self, params, tokens):
        """Dense causal forward. tokens: int [B, T] (T <= max_context).
        Returns (logits [B, T, V], k, v) with k/v [L, B, T, H, Dh]."""
        c = self.config
        B, T = tokens.shape
        tokens = tokens.long()
        h = params["embed"][tokens] + params["pos"][:T][None, :, :]
        ks, vs = [], []
        for lp in params["layers"]:
            x = _layer_norm(h, lp["ln1_g"], lp["ln1_b"])
            q = (x @ lp["wq"]).reshape(B, T, c.num_heads, c.head_dim)
            k = (x @ lp["wk"]).reshape(B, T, c.num_heads, c.head_dim)
            v = (x @ lp["wv"]).reshape(B, T, c.num_heads, c.head_dim)
            ks.append(k)
            vs.append(v)
            att = attention_reference(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True)
            att = att.transpose(1, 2).reshape(B, T, c.d_model)
            h = h + att @ lp["wo"]
            h = h + _mlp(h, lp, lambda a, n, _lp=lp: a @ _lp[n]) \
                + lp["b2"]
        logits = _layer_norm(h, params["lnf_g"],
                             params["lnf_b"]) @ params["head"]
        return logits, torch.stack(ks), torch.stack(vs)

    # ------------------------------------------------------- decode --
    def decode_flat(self, params, tokens, positions, seq_ids, valid,
                    k_pages, v_pages, block_tables, k_scales=None,
                    v_scales=None, w_scales=None):
        """The FLAT ragged step over a packed ``[T]`` batch of query
        tokens from many sequences.

        tokens/positions/seq_ids: int32 [T] (entries with ``valid[t] ==
        0`` are bucket padding: their K/V writes go to the null block
        and their outputs are garbage the caller discards); valid:
        int32/bool [T]; pools ``[L, N, bs, H, Dh]``; block_tables:
        int32 [S, MB]. Token ``t`` attends over positions ``<=
        positions[t]`` of sequence ``seq_ids[t]``; callers pack each
        sequence's tokens in position order. The K/V of every token is
        written into the pools IN PLACE before the layer's attention.
        Returns logits [T, V].

        Quantized KV: with ``k_scales``/``v_scales`` ``[L, N, bs, H]``
        the pools are int8 or fp8; each token's K/V is quantized per
        (slot, head) on write (scale = max|x| / QMAX, QMAX 127 or 448)
        and dequantized inside the ragged kernel on read.

        Quantized weights: ``w_scales`` is the flat ``{dot.path: [cols]
        f32}`` dict of a :class:`~.quant.QuantizedWeights`; matching
        ``params`` leaves are int8/fp8 and every base matmul goes
        through ``quantized_matmul``, the embedding/position gathers
        dequantize after the lookup."""
        c = self.config
        T = tokens.shape[0]
        bs = k_pages.shape[2]
        MB = block_tables.shape[1]
        quantized = k_scales is not None
        vmask = valid.bool()
        pos_l = positions.long()
        # padded tokens may carry stale positions: clamp the table
        # column before indexing (the TPU gather clamps on its own)
        col = torch.clamp(pos_l // bs, 0, MB - 1)
        bidx = torch.where(vmask, block_tables[seq_ids.long(), col].long(),
                           0)                               # null block
        slot = torch.where(vmask, pos_l % bs, 0)
        ws = w_scales if w_scales is not None else {}

        def lookup(name, idx):
            s = ws.get(name)
            g = gather_rows(params[name], idx)
            return g if s is None else g.float() * s

        h = lookup("embed", tokens.long()) + lookup("pos", pos_l)
        for li, lp in enumerate(params["layers"]):
            def mm(x2d, name, _li=li, _lp=lp):
                s = ws.get(f"layers.{_li}.{name}")
                if s is None:
                    return x2d @ _lp[name]
                return quantized_matmul(x2d, _lp[name], s)

            x = _layer_norm(h, lp["ln1_g"], lp["ln1_b"])
            q = mm(x, "wq").reshape(T, c.num_heads, c.head_dim)
            k = mm(x, "wk").reshape(T, c.num_heads, c.head_dim)
            v = mm(x, "wv").reshape(T, c.num_heads, c.head_dim)
            if quantized:
                kq, ksc = _quantize_kv(k, k_pages.dtype)
                vq, vsc = _quantize_kv(v, v_pages.dtype)
                _write(k_pages[li], bidx, slot, kq)
                _write(v_pages[li], bidx, slot, vq)
                k_scales[li, bidx, slot] = ksc
                v_scales[li, bidx, slot] = vsc
                att = ragged_flat_attention(
                    q, k_pages[li], v_pages[li], block_tables, seq_ids,
                    positions, k_scales=k_scales[li],
                    v_scales=v_scales[li])
            else:
                _write(k_pages[li], bidx, slot, k.to(k_pages.dtype))
                _write(v_pages[li], bidx, slot, v.to(v_pages.dtype))
                att = ragged_flat_attention(q, k_pages[li], v_pages[li],
                                            block_tables, seq_ids,
                                            positions)
            h = h + mm(att.reshape(T, c.d_model), "wo")
            h = h + _mlp(h, lp, mm) + lp["b2"]
        x = _layer_norm(h, params["lnf_g"], params["lnf_b"])
        s = ws.get("head")
        if s is None:
            return x @ params["head"]
        return quantized_matmul(x, params["head"], s)


def _quantize_kv(x, dtype):
    """Symmetric per-(token, head) quantization of ``x [T, H, D]``:
    int8 rounds half-to-even to ±127 steps; fp8-e4m3 scales into the
    ±448 finite range, clipped before the cast as the JAX package does.
    Returns (values, scales [T, H])."""
    int8 = dtype == torch.int8
    qmax = 127.0 if int8 else 448.0
    sc = torch.clamp(x.abs().amax(dim=-1) / qmax, min=1e-8)
    y = x / sc[..., None]
    if int8:
        return torch.clamp(torch.round(y), -127, 127).to(torch.int8), sc
    return torch.clamp(y, -qmax, qmax).to(dtype), sc


def _write(pool, bidx, slot, val):
    """``pool[bidx, slot] = val`` in place (fp8 through a byte view)."""
    if pool.dtype == torch.float8_e4m3fn:
        pool.view(torch.uint8)[bidx, slot] = val.view(torch.uint8)
    else:
        pool[bidx, slot] = val


def _incremental_step(model, params, token, pos, k_cache, v_cache):
    """One appended token against a dense KV cache ``[L, max_context,
    H, Dh]`` (written in place at ``pos``); attends over positions
    ``<= pos``. token/pos: python ints. Returns logits [V]."""
    c = model.config
    scale = 1.0 / (c.head_dim ** 0.5)
    mask = torch.arange(c.max_context, device=k_cache.device) <= pos
    h = params["embed"][token] + params["pos"][pos]
    for li, lp in enumerate(params["layers"]):
        x = _layer_norm(h, lp["ln1_g"], lp["ln1_b"])
        q = (x @ lp["wq"]).reshape(c.num_heads, c.head_dim)
        k_cache[li, pos] = (x @ lp["wk"]).reshape(c.num_heads, c.head_dim)
        v_cache[li, pos] = (x @ lp["wv"]).reshape(c.num_heads, c.head_dim)
        s = torch.einsum("hd,thd->ht", q, k_cache[li]) * scale
        s = torch.where(mask[None, :], s, _NEG_INF)
        p = torch.softmax(s, dim=-1)
        att = torch.einsum("ht,thd->hd", p, v_cache[li]).reshape(c.d_model)
        h = h + att @ lp["wo"]
        h = h + _mlp(h, lp, lambda a, n, _lp=lp: a @ _lp[n]) + lp["b2"]
    return _layer_norm(h, params["lnf_g"], params["lnf_b"]) @ params["head"]


def greedy_decode_reference(model, params, prompt_tokens, max_new_tokens,
                            stop_token=None, return_logits=False):
    """Per-sequence eager greedy decoding — the oracle continuous
    batching must match token for token. One dense causal forward over
    the ``max_context``-padded prompt fills the KV cache and emits the
    first token; each later token is one incremental step. Returns the
    generated tokens (prompt excluded); with ``return_logits`` also the
    logits each token was chosen from."""
    toks = [int(t) for t in prompt_tokens]
    out, chosen_from = [], []
    ctx = model.max_context
    dev = params["embed"].device
    padded = torch.zeros((1, ctx), dtype=torch.int64, device=dev)
    padded[0, :len(toks)] = torch.tensor(toks, device=dev)
    logits, k, v = model.forward(params, padded)
    # positions past the prompt hold pad garbage; each is overwritten by
    # the incremental step that lands there before any mask exposes it
    k_cache, v_cache = k[:, 0].contiguous(), v[:, 0].contiguous()
    cur = logits[0, len(toks) - 1]
    for i in range(max_new_tokens):
        nxt = int(torch.argmax(cur))
        out.append(nxt)
        chosen_from.append(cur)
        toks.append(nxt)
        if stop_token is not None and nxt == stop_token:
            break
        if len(toks) >= ctx or i == max_new_tokens - 1:
            break
        cur = _incremental_step(model, params, nxt, len(toks) - 1,
                                k_cache, v_cache)
    if return_logits:
        return out, torch.stack(chosen_from)
    return out

"""A small decoder-only transformer in paged-decode form (the port of
``mxnet_tpu/serving/llm/model.py``).

- :meth:`TinyDecoder.forward` — dense causal forward over ``[B, T]``
  tokens, returning logits and the per-layer K/V (the eager oracle);
- :meth:`TinyDecoder.decode_flat` — the engine's step: a packed ``[T]``
  batch of query tokens from many sequences writes its K/V into the
  paged pools IN PLACE and attends over them through
  :func:`~mxnet_tpu_torch.ops.ragged_attention.ragged_flat_attention`
  (f32, bf16, f16, int8 or fp8 pages), with int8/fp8 weights routed
  through :func:`~mxnet_tpu_torch.ops.quantization.quantized_matmul`;
- :meth:`TinyDecoder.decode_chunk` / :meth:`TinyDecoder.decode_step` —
  the model interface's paged step: up to Q tokens per sequence (decode
  is the Q=1 slice) write their K/V into f32, bf16 or f16 pools in
  place and attend through :func:`~mxnet_tpu_torch.ops.ragged_attention
  .ragged_paged_attention` (the chunk kernel);
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
from ...ops.lora import (PROJ_K, PROJ_O, PROJ_Q, PROJ_V, page_mask,
                         paged_lora_delta, pool_lora_delta)
from ...ops.quantization import quantized_matmul
from ...ops.ragged_attention import (gather_rows, ragged_flat_attention,
                                     ragged_paged_attention)

__all__ = ["DecoderConfig", "TinyDecoder", "greedy_decode_reference",
           "DENSE_ROWS"]

# The row count of a flat step's pack-independent route
# (``decode_flat(dense_rows=DENSE_ROWS)``): the dense part (layer norms,
# projections, the LM head) runs on the pack padded with zero rows to a
# multiple of it, each product taking it rows at a time. A library
# product picks its algorithm, and a row reduction its lane split, by the
# row count, so a row's bits would follow the pack's size; at one count
# they do not, and with the attention kernels' pack-independent plan a
# row writes the same KV and logits alone and in any pack. The engine's
# draft steps take this route (they write into prefix blocks other
# sequences share); its target steps run at the pack's own count
# (``dense_rows=None``, the default: their shared blocks are copied on
# write).
DENSE_ROWS = 128


class DecoderConfig:
    """Shape of a :class:`TinyDecoder` (serializable for deploy: the
    reference's dict, so either package reads the other's artifacts)."""

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

    def to_dict(self):
        return {f: getattr(self, f) for f in self.FIELDS}

    @classmethod
    def from_dict(cls, d):
        return cls(**{f: d[f] for f in cls.FIELDS})

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


def _lora_all_rows(x2d, a_sel, b_sel, li, proj, scale):
    """Single-adapter LoRA delta for every row of ``x2d [N, d]``: the
    oracle's twin of the flat step's per-token pages. ``a_sel``/``b_sel``
    ``[P, L, 4, d|r, r|d]`` are one adapter's padded factor pages
    (:meth:`AdapterBank.adapter_arrays`), broadcast to every row so the
    einsum is :func:`~mxnet_tpu_torch.ops.lora.paged_lora_delta`'s, as
    in the JAX package."""
    n = x2d.shape[0]
    a = a_sel[:, li, proj]                       # [P, d, r]
    b = b_sel[:, li, proj]                       # [P, r, d]
    return paged_lora_delta(
        x2d, a[None].expand((n,) + a.shape), b[None].expand((n,) + b.shape),
        torch.full((n,), float(scale), dtype=x2d.dtype, device=x2d.device))


def _by_rows(fn, rows, *xs):
    """``fn(*xs)`` taken ``rows`` rows of each of ``xs`` at a time (they
    have the same multiple of ``rows`` rows; ``rows`` None: at once)."""
    n = xs[0].shape[0]
    if rows is None or n <= rows:
        return fn(*xs)
    return torch.cat([fn(*(x[i:i + rows] for x in xs))
                      for i in range(0, n, rows)])


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
    def forward(self, params, tokens, lora=None):
        """Dense causal forward. tokens: int [B, T] (T <= max_context).
        Returns (logits [B, T, V], k, v) with k/v [L, B, T, H, Dh].

        ``lora``: optional single-adapter factors ``(a_sel, b_sel,
        scale)`` as :meth:`AdapterBank.adapter_arrays` returns them,
        applied to every row (the per-adapter oracle of the flat step's
        per-token adapters)."""
        c = self.config
        B, T = tokens.shape
        tokens = tokens.long()
        h = params["embed"][tokens] + params["pos"][:T][None, :, :]

        def delta(x, li, proj):
            return _lora_all_rows(x.reshape(B * T, c.d_model), *lora[:2],
                                  li, proj, lora[2]).reshape(B, T, c.d_model)
        ks, vs = [], []
        for li, lp in enumerate(params["layers"]):
            x = _layer_norm(h, lp["ln1_g"], lp["ln1_b"])
            q = x @ lp["wq"]
            k = x @ lp["wk"]
            v = x @ lp["wv"]
            if lora is not None:
                q = q + delta(x, li, PROJ_Q)
                k = k + delta(x, li, PROJ_K)
                v = v + delta(x, li, PROJ_V)
            q = q.reshape(B, T, c.num_heads, c.head_dim)
            k = k.reshape(B, T, c.num_heads, c.head_dim)
            v = v.reshape(B, T, c.num_heads, c.head_dim)
            ks.append(k)
            vs.append(v)
            att = attention_reference(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True)
            att = att.transpose(1, 2).reshape(B, T, c.d_model)
            o = att @ lp["wo"]
            if lora is not None:
                o = o + delta(att, li, PROJ_O)
            h = h + o
            h = h + _mlp(h, lp, lambda a, n, _lp=lp: a @ _lp[n]) \
                + lp["b2"]
        logits = _layer_norm(h, params["lnf_g"],
                             params["lnf_b"]) @ params["head"]
        return logits, torch.stack(ks), torch.stack(vs)

    # ------------------------------------------------------- decode --
    def decode_flat(self, params, tokens, positions, seq_ids, valid,
                    k_pages, v_pages, block_tables, k_scales=None,
                    v_scales=None, adapter=None, axis_name=None,
                    w_scales=None, *, dense_rows=None, out_rows=None):
        """The FLAT ragged step over a packed ``[T]`` batch of query
        tokens from many sequences.

        tokens/positions/seq_ids: int32 [T] (entries with ``valid[t] ==
        0`` are bucket padding: their K/V writes go to the null block
        and their outputs are garbage the caller discards); valid:
        int32/bool [T]; pools ``[L, N, bs, H, Dh]``; block_tables:
        int32 [S, MB]. Token ``t`` attends over positions ``<=
        positions[t]`` of sequence ``seq_ids[t]``; callers pack each
        sequence's tokens in position order. The K/V of every token is
        written into the pools IN PLACE before the layer's attention,
        cast to the pools' dtype (bf16/f16 pools: rounded to nearest
        even, as ``astype`` rounds in the reference; q stays f32).
        Returns logits [T, V] (``out_rows``: the logits of those rows of
        the pack only, the LM head taken on them alone).

        ``dense_rows`` (:data:`DENSE_ROWS`, the draft's route): the
        layer norms, projections and LM head run on the pack padded with
        zero rows to a multiple of it, that many rows a product, and the
        attention kernels take their pack-independent plan, so a row's
        KV and logits have the same bits alone and in any pack; ``None``
        (the target's): the pack's own row count and the plan chosen for
        the pack.

        Quantized KV: with ``k_scales``/``v_scales`` ``[L, N, bs, H]``
        the pools are int8 or fp8; each token's K/V is quantized per
        (slot, head) on write (scale = max|x| / QMAX, QMAX 127 or 448)
        and dequantized inside the ragged kernel on read.

        Quantized weights: ``w_scales`` is the flat ``{dot.path: [cols]
        f32}`` dict of a :class:`~.quant.QuantizedWeights`; matching
        ``params`` leaves are int8/fp8 and every base matmul goes
        through ``quantized_matmul``, the embedding/position gathers
        dequantize after the lookup. LoRA deltas stay f32, added after
        the base product.

        Multi-LoRA: ``adapter = (a_pages, b_pages, a_tables, a_scales)``,
        the reference's form: the factor pools ``a_pages [P, L, 4, d, r]``
        and ``b_pages [P, L, 4, r, d]``, each row's page table ``a_tables
        [S, P]`` int32 and scale ``a_scales [S]`` f32; or ``(bank,
        a_tables, a_scales)``, an
        :class:`~mxnet_tpu_torch.serving.adapters.AdapterBank` whose
        pools (:attr:`~.AdapterBank.a_pages` / ``b_pages``, views of its
        storage) the deltas read. Each token takes its row's pages and
        adds the low-rank delta to the four attention projections
        (:func:`~mxnet_tpu_torch.ops.lora.pool_lora_delta`: one product
        with the whole pool of a (layer, projection), a page mask, the
        second product, the scale); over the bank's views the pool of a
        (layer, projection) is a view of its storage, copied nowhere. A
        row whose table holds only the null page (scale 0) gets an
        exactly-zero delta, so one graph serves any adapter mix.

        ``axis_name`` (the reference's tensor-parallel shard body) must
        be None: the port has no tensor-parallel step yet (ROADMAP.md
        §1 item 9)."""
        if axis_name is not None:
            raise NotImplementedError(
                f"axis_name={axis_name!r}: the tensor-parallel step is "
                "not ported yet (ROADMAP.md, section 1 item 9)")
        c = self.config
        T = tokens.shape[0]
        bs = k_pages.shape[2]
        MB = block_tables.shape[1]
        quantized = k_scales is not None
        fixed = dense_rows is not None
        R = T if not fixed else -(-T // dense_rows) * dense_rows
        if R > T:
            def pad(x):
                return torch.cat([x, x.new_zeros(R - T)])
            tokens, positions, seq_ids, valid = (
                pad(x) for x in (tokens, positions, seq_ids, valid))
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

        def rows(fn, *xs):
            return _by_rows(fn, dense_rows, *xs)

        if adapter is not None:
            if len(adapter) == 3:               # (bank, tables, scales)
                bank, a_tables, a_scales = adapter
                a_pages, b_pages = bank.a_pages, bank.b_pages
            else:
                a_pages, b_pages, a_tables, a_scales = adapter
            sid = seq_ids.long()
            mask = page_mask(a_tables[sid], a_pages.shape[0])   # [R, P]
            scale_tok = a_scales[sid]                           # [R]

            def delta(x2d, li, proj):
                # [d, P, r] and [P, r, d]: over the bank's views, its
                # storage of this (layer, projection) as it lies
                a_pool = a_pages[:, li, proj].permute(1, 0, 2)
                b_pool = b_pages[:, li, proj]
                return rows(lambda z, m, sc: pool_lora_delta(
                    z, a_pool, b_pool, m, sc), x2d, mask, scale_tok)

        h = lookup("embed", tokens.long()) + lookup("pos", pos_l)
        for li, lp in enumerate(params["layers"]):
            def mm(x2d, name, _li=li, _lp=lp):
                s = ws.get(f"layers.{_li}.{name}")
                if s is None:
                    return rows(lambda z: z @ _lp[name], x2d)
                return rows(lambda z: quantized_matmul(z, _lp[name], s), x2d)

            x = rows(lambda z: _layer_norm(z, lp["ln1_g"], lp["ln1_b"]), h)
            q = mm(x, "wq")
            k = mm(x, "wk")
            v = mm(x, "wv")
            if adapter is not None:
                q = q + delta(x, li, PROJ_Q)
                k = k + delta(x, li, PROJ_K)
                v = v + delta(x, li, PROJ_V)
            q = q.reshape(R, c.num_heads, c.head_dim)
            k = k.reshape(R, c.num_heads, c.head_dim)
            v = v.reshape(R, c.num_heads, c.head_dim)
            if quantized:
                kq, ksc = _quantize_kv(k, k_pages.dtype)
                vq, vsc = _quantize_kv(v, v_pages.dtype)
                _write(k_pages[li], bidx, slot, kq)
                _write(v_pages[li], bidx, slot, vq)
                k_scales[li, bidx, slot] = ksc
                v_scales[li, bidx, slot] = vsc
                att = ragged_flat_attention(
                    q[:T], k_pages[li], v_pages[li], block_tables,
                    seq_ids[:T], positions[:T], k_scales=k_scales[li],
                    v_scales=v_scales[li], pack_independent=fixed)
            else:
                _write(k_pages[li], bidx, slot, k.to(k_pages.dtype))
                _write(v_pages[li], bidx, slot, v.to(v_pages.dtype))
                att = ragged_flat_attention(q[:T], k_pages[li], v_pages[li],
                                            block_tables, seq_ids[:T],
                                            positions[:T],
                                            pack_independent=fixed)
            att = att.reshape(T, c.d_model)
            if R > T:
                att = torch.cat([att, att.new_zeros(R - T, c.d_model)])
            o = mm(att, "wo")
            if adapter is not None:
                o = o + delta(att, li, PROJ_O)
            h = h + o
            h = h + rows(lambda z: _mlp(z, lp, mm), h) + lp["b2"]
        s = ws.get("head")

        def head(z):
            z = _layer_norm(z, params["lnf_g"], params["lnf_b"])
            if s is None:
                return z @ params["head"]
            return quantized_matmul(z, params["head"], s)
        if out_rows is not None:
            return head(h[out_rows.long()])
        return rows(head, h)[:T]

    def decode_chunk(self, params, tokens, positions, q_lens, k_pages,
                     v_pages, block_tables, kv_lens):
        """Up to Q tokens per sequence against the paged cache: the one
        multi-query-token step that chunked prefill, plain decode (the
        Q=1 slice) and speculative verify run through.

        tokens/positions: int32 [S, Q]; q_lens: int32 [S] valid token
        counts (0 = inactive row); pools ``[L, N, bs, H, Dh]`` f32, bf16
        or f16 (K/V rounded to nearest even on write, q f32);
        block_tables: int32 [S, MB]; kv_lens: int32 [S], the valid length
        including this chunk's tokens (token ``t`` of row ``i`` sits at
        ``kv_lens[i] - q_lens[i] + t``, which ``positions[i, t]`` must
        equal for ``t < q_lens[i]``; padded tails carry an in-range
        position).

        Each layer first writes the chunk's K/V IN PLACE at
        ``(block_tables[i, pos // bs], pos % bs)`` (padded tokens and
        inactive rows write to the null block), then attends causally over
        the paged history through the chunk kernel. Returns (logits [S, Q,
        V], k_pages, v_pages), the pools being the tensors passed in, as
        the JAX package's functional interface returns its updated pools.
        """
        c = self.config
        S, Q = tokens.shape
        bs = k_pages.shape[2]
        MB = block_tables.shape[1]
        valid = (torch.arange(Q, device=tokens.device)[None, :]
                 < q_lens.long()[:, None])                   # [S, Q]
        pos_l = positions.long()
        # padded tails may carry any in-range position: clamp the table
        # column before indexing (the TPU gather clamps on its own)
        col = torch.clamp(pos_l // bs, 0, MB - 1)
        bidx = torch.where(valid, torch.gather(block_tables.long(), 1, col),
                           0)                                # null block
        slot = torch.where(valid, pos_l % bs, 0)
        h = params["embed"][tokens.long()] + params["pos"][pos_l]
        for li, lp in enumerate(params["layers"]):
            x = _layer_norm(h, lp["ln1_g"], lp["ln1_b"])
            q = (x @ lp["wq"]).reshape(S, Q, c.num_heads, c.head_dim)
            k = (x @ lp["wk"]).reshape(S, Q, c.num_heads, c.head_dim)
            v = (x @ lp["wv"]).reshape(S, Q, c.num_heads, c.head_dim)
            _write(k_pages[li], bidx, slot, k.to(k_pages.dtype))
            _write(v_pages[li], bidx, slot, v.to(v_pages.dtype))
            att = ragged_paged_attention(q, k_pages[li], v_pages[li],
                                         block_tables, kv_lens,
                                         q_lens=q_lens)
            h = h + att.reshape(S, Q, c.d_model) @ lp["wo"]
            h = h + _mlp(h, lp, lambda a, n, _lp=lp: a @ _lp[n]) \
                + lp["b2"]
        logits = _layer_norm(h, params["lnf_g"],
                             params["lnf_b"]) @ params["head"]
        return logits, k_pages, v_pages

    def decode_step(self, params, tokens, positions, k_pages, v_pages,
                    block_tables, kv_lens):
        """One decode token per sequence: the Q=1 slice of
        :meth:`decode_chunk`, so it runs the chunk kernel, as the JAX
        package's does (tokens/positions int32 [S]). Returns (logits [S,
        V], k_pages, v_pages)."""
        S = tokens.shape[0]
        logits, k_pages, v_pages = self.decode_chunk(
            params, tokens[:, None], positions[:, None],
            torch.ones(S, dtype=torch.int32, device=tokens.device),
            k_pages, v_pages, block_tables, kv_lens)
        return logits[:, 0], k_pages, v_pages


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


def _incremental_step(model, params, token, pos, k_cache, v_cache,
                      lora=None):
    """One appended token against a dense KV cache ``[L, max_context,
    H, Dh]`` (written in place at ``pos``); attends over positions
    ``<= pos``. token/pos: python ints. ``lora``: optional ``(a_sel,
    b_sel, scale)`` single-adapter factors (as :meth:`TinyDecoder
    .forward` takes them). Returns logits [V]."""
    c = model.config
    scale = 1.0 / (c.head_dim ** 0.5)
    mask = torch.arange(c.max_context, device=k_cache.device) <= pos

    def delta(x1d, li, proj):
        return _lora_all_rows(x1d[None], lora[0], lora[1], li, proj,
                              lora[2])[0]
    h = params["embed"][token] + params["pos"][pos]
    for li, lp in enumerate(params["layers"]):
        x = _layer_norm(h, lp["ln1_g"], lp["ln1_b"])
        q = x @ lp["wq"]
        k = x @ lp["wk"]
        v = x @ lp["wv"]
        if lora is not None:
            q = q + delta(x, li, PROJ_Q)
            k = k + delta(x, li, PROJ_K)
            v = v + delta(x, li, PROJ_V)
        q = q.reshape(c.num_heads, c.head_dim)
        k_cache[li, pos] = k.reshape(c.num_heads, c.head_dim)
        v_cache[li, pos] = v.reshape(c.num_heads, c.head_dim)
        s = torch.einsum("hd,thd->ht", q, k_cache[li]) * scale
        s = torch.where(mask[None, :], s, _NEG_INF)
        p = torch.softmax(s, dim=-1)
        att = torch.einsum("ht,thd->hd", p, v_cache[li]).reshape(c.d_model)
        o = att @ lp["wo"]
        if lora is not None:
            o = o + delta(att, li, PROJ_O)
        h = h + o
        h = h + _mlp(h, lp, lambda a, n, _lp=lp: a @ _lp[n]) + lp["b2"]
    return _layer_norm(h, params["lnf_g"], params["lnf_b"]) @ params["head"]


def greedy_decode_reference(model, params, prompt_tokens, max_new_tokens,
                            stop_token=None, return_logits=False,
                            lora=None):
    """Per-sequence eager greedy decoding — the oracle continuous
    batching must match token for token. One dense causal forward over
    the ``max_context``-padded prompt fills the KV cache and emits the
    first token; each later token is one incremental step. Returns the
    generated tokens (prompt excluded); with ``return_logits`` also the
    logits each token was chosen from.

    ``lora``: optional single-adapter ``(a_sel, b_sel, scale)`` from
    :meth:`AdapterBank.adapter_arrays` (tensors or numpy arrays): the
    per-adapter oracle of mixed-adapter engine batches."""
    toks = [int(t) for t in prompt_tokens]
    out, chosen_from = [], []
    ctx = model.max_context
    dev = params["embed"].device
    if lora is not None:
        lora = (torch.as_tensor(lora[0], device=dev),
                torch.as_tensor(lora[1], device=dev), float(lora[2]))
    padded = torch.zeros((1, ctx), dtype=torch.int64, device=dev)
    padded[0, :len(toks)] = torch.tensor(toks, device=dev)
    logits, k, v = model.forward(params, padded, lora=lora)
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
                                k_cache, v_cache, lora=lora)
    if return_logits:
        return out, torch.stack(chosen_from)
    return out

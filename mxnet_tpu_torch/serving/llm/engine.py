"""Continuous-batching decode engine (the port of
``mxnet_tpu/serving/llm/engine.py``): admit, step, evict — every step.

One engine iteration (:meth:`LLMEngine.step`):

1. **admit** — while a decode slot is free and the pool can hold the
   prompt, pop the oldest waiting sequence into a slot. The prefix cache
   is consulted first: the longest registered chain of block-aligned
   prompt-prefix blocks is ref()'d into the sequence's table, so those
   tokens' KV is served, not recomputed (at least the last prompt token
   is always recomputed: its logits emit the first generated token).
   The rest of the prompt is written in CHUNKS of ``prefill_chunk``
   tokens scheduled into the regular step;
2. **plan + allocate** — each running sequence declares this step's
   query tokens (its next prompt chunk, its one decode token, or, in
   speculative decode, its last committed token and up to ``spec_k``
   draft proposals); blocks covering the step's KV writes are allocated
   up front, and a write into a block still shared with another
   sequence is preceded by a copy-on-write. Under KV pressure the
   newest sequence is preempted (blocks freed, generation folded into
   its prompt, requeued — the position-keyed sampling noise resumes the
   exact stream);
3. **draft** (with a draft model) — the draft mirrors prefill chunks
   into its own pools, catches its committed prefix up and proposes up
   to ``spec_k`` tokens a speculating row, one draft dispatch a round;
4. **step** — ONE launch sequence for the whole mixed batch in the FLAT
   ragged layout: every row's query tokens packed into one
   ``[total_q_tokens]`` batch (tokens / positions / seq_ids / valid) +
   ``[max_seqs, mb]`` block tables, copied to the device in one
   transfer; :meth:`~.model.TinyDecoder.decode_flat` writes the KV in
   place and attends through the flat ragged kernel; the accept rule
   (greedy argmax, or temperature / top-k / top-p sampling with
   position-keyed noise) runs on the device over each row's ``K + 1``
   scored positions; ONE device-to-host copy (the step's only
   synchronisation) brings the committed tokens back. The packed length
   and the table width are bucketed on small ladders (pure decode or
   verify, the commonest mixed steps, full prefill; half and full table
   width).

Speculative decoding: a small DRAFT model proposes up to ``spec_k``
tokens a sequence, its KV pages indexed by the SAME block ids the
target allocator hands out (one strict accounting for both pools); the
step scores all ``K + 1`` positions in one target dispatch and the
accept rule commits ``n_acc + 1`` tokens. Rejected draft KV is rolled
back by trimming the sequence's surplus blocks through the strict
allocator, and the draft's committed-prefix watermark
(``Sequence.draft_len``) rolls back with them. A failing draft dispatch
degrades that step to plain decode (counted in ``spec_degraded``); a
graph capture or a kernel build never degrades, it raises. The draft's
probabilities stay on the device: each sampled draft round's ``[S, V]``
output is copied, device to device, into a static ``[S, K, V]`` tensor
that the verify step reads (the reference carries them through the
host).

The programs (the port of the reference's ``_make_step_fn`` /
``_make_draft_fn`` and their per-variant jit caches): one
:class:`_StepProgram` per (packed length, table width, greedy|sampled)
rung of the target's ladder and, with a draft, one per rung of the
draft's own ladder, each holding the rung's static batch buffers and
output and, on CUDA, a ``torch.cuda.CUDAGraph`` of the whole program
over them, captured by :meth:`LLMEngine.warmup` (or at the rung's first
use, as the reference jits lazily). A capture counts as a compile
(:func:`~..telemetry.compile_count`), so after ``warmup()`` a verify or
a draft round is: fill the rung's pinned host buffer, one host-to-device
copy, one graph replay, one device-to-host copy; no model code runs in
Python. A capture that fails raises, naming the rung: the engine never
steps eagerly on the card. On the CPU there is nothing to capture, and
the same functions run eagerly on the same static buffers.

Multi-LoRA: with an :class:`~..adapters.AdapterBank` (``adapter_bank=``)
every rung's graph also reads the bank's factor pools (fixed storage,
installed into in place) and two more static buffers, each row's adapter
page table and scale (``a_tables [S, P]``, ``a_scales [S]``), filled per
row like the sampling vectors: the null page and scale 0 on a base-model
row, whose delta is then exactly zero. A sequence pins its adapter
version at admission, before the prefix lookup (the pinned
``name@version`` salts its prefix hashes, so adapter KV never aliases
base-model or other-version KV), and releases it on every terminal
state; preemption keeps it. The draft model of speculative decoding
proposes without an adapter; the adapter-bearing target verifies.

Row bits: the draft's steps take ``decode_flat``'s pack-independent
route (the dense part at :data:`~.model.DENSE_ROWS` rows, the attention
kernels' pack-independent plan) and the LM head on the rows they
propose from, so a row's draft KV and proposals do not depend on the
rows packed beside it (the draft writes into prefix blocks whose target
KV other sequences share). The target's steps run at the pack's own row
count and the plan chosen for the pack (``dense_rows=None``): their
writes into shared blocks are copied on write first, and the fixed
route would cost a plain step time (PERF.md §6).

Single-threaded by design: :class:`~.server.LLMServer` owns the thread,
the queue and the futures; the engine owns device state and
determinism. Tensor-parallel meshes are not ported yet (ROADMAP.md
§1); asking for one raises ``NotImplementedError``.
"""
from __future__ import annotations

import collections
import time
import warnings

import numpy as np
import torch

from ... import kernels
from ..._device import resolve_device
from ...convert import params_from_numpy
from ..envutil import env_int as _env_int, env_str as _env_str
from ..adapters.bank import AdapterError, NULL_ADAPTER_PAGE
from .kv_cache import (PagedKVCache, KVCacheError, NULL_BLOCK,
                       prefix_block_hashes)
from .model import DENSE_ROWS
from .quant import (FP8_NAME, fp8_supported, quantize_weights,
                    flatten_params, resolve_weight_dtype)
from .scheduler import Scheduler, Sequence, RUNNING, FINISHED, EVICTED
from .sampling import (TAG_SAMPLE, TAG_ACCEPT, TAG_DRAFT, row_keys,
                       sample_and_probs, spec_accept, spec_accept_greedy)

__all__ = ["LLMEngine"]

_DEFERRED = {
    "mesh": "tensor-parallel meshes",
}

# the float types of the KV pools that ``dtype=`` takes
_POOL_DTYPES = ("float32", "bfloat16", "float16")


def _dtype_name(dtype):
    """``"bfloat16"`` for ``"bfloat16"`` or ``torch.bfloat16``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def _resolve_kv_dtype(name):
    """Map an ``fp8`` KV-dtype request onto torch (the port of the
    reference's ``_resolve_kv_dtype``): returns ``(dtype_name,
    fell_back)``, ``float8_e4m3fn`` where torch carries the dtype, else
    ``int8`` with ``fell_back=True`` (the caller counts a warning).
    Other names, and torch dtypes by their names, pass through."""
    name = _dtype_name(name)
    if name.strip().lower() in ("fp8", "float8", "e4m3", "float8_e4m3",
                                FP8_NAME):
        if fp8_supported():
            return FP8_NAME, False
        return "int8", True
    return name, False


class _Buffers:
    """Host batch arrays of one (packed length ``t``, table width
    ``mb``) rung, all views into ONE int32 buffer (pinned when the
    engine runs on CUDA) so a dispatch's batch reaches the device in one
    copy, and the matching views of its static device twin
    (``device_views``), which a captured program reads: :meth:`upload`
    copies the host buffer into it. On the CPU the twin is the host
    buffer. Subclasses name the fields and their shapes.

    The host writes the pinned buffer only between dispatches: each
    dispatch ends in a device-to-host copy that waits for the whole
    stream, the upload included."""

    _INT_FIELDS = ()
    _F32_FIELDS = ("temperature", "top_p")

    def _shapes(self, t, mb, S, K, P):
        shapes = {"tokens": (t,), "positions": (t,), "seq_ids": (t,),
                  "valid": (t,), "tables": (S, mb)}
        shapes.update(dict.fromkeys(("top_k", "seeds", "counters",
                                     "temperature", "top_p"), (S,)))
        return shapes

    def __init__(self, t, mb, S, device, K=0, P=0):
        shapes = self._shapes(t, mb, S, K, P)
        fields = self._INT_FIELDS + self._F32_FIELDS
        if P:
            fields += ("a_tables", "a_scales")
        slices = {}
        off = 0
        for name in fields:
            n = int(np.prod(shapes[name]))
            slices[name] = (off, off + n)
            off += n
        host = torch.zeros(off, dtype=torch.int32)
        if device.type == "cuda":
            host = host.pin_memory()
        self._host = host
        self._dev = host if device.type == "cpu" else torch.zeros_like(
            host, device=device)
        self.device_views = {}
        flat = host.numpy()
        for name, (a, b) in slices.items():
            view, dview = flat[a:b], self._dev[a:b]
            if name in self._F32_FIELDS + ("a_scales",):
                view, dview = view.view(np.float32), dview.view(
                    torch.float32)
            setattr(self, name, view.reshape(shapes[name]))
            self.device_views[name] = dview.view(shapes[name])
        self.tables.fill(NULL_BLOCK)
        self.top_p.fill(1.0)

    def upload(self):
        if self._dev is not self._host:
            self._dev.copy_(self._host, non_blocking=True)


class _StepBuffers(_Buffers):
    """The verify step's batch: the packed tokens and tables, each row's
    ``K + 1`` scored positions (``win_idx [S, K+1]``: flat indices into
    the pack), its draft proposals (``draft_tokens [S, K]``) and their
    count (``n_draft [S]``, 0 on a plain row), the sampling vectors and,
    with an adapter bank (``P`` its pages an adapter), each row's
    adapter page table and scale (``a_tables [S, P]``, the null page 0
    on a base-model row; ``a_scales [S]``, 0 there)."""

    _INT_FIELDS = ("tokens", "positions", "seq_ids", "valid", "tables",
                   "win_idx", "draft_tokens", "n_draft", "top_k", "seeds",
                   "counters")

    def _shapes(self, t, mb, S, K, P):
        shapes = super()._shapes(t, mb, S, K, P)
        shapes.update(win_idx=(S, K + 1), draft_tokens=(S, K),
                      n_draft=(S,), a_tables=(S, P), a_scales=(S,))
        return shapes


class _DraftBuffers(_Buffers):
    """A draft round's batch: the packed feed tokens and tables, the
    flat index of each row's last fed token (``last_idx [S]``) and the
    sampling vectors."""

    _INT_FIELDS = ("tokens", "positions", "seq_ids", "valid", "tables",
                   "last_idx", "top_k", "seeds", "counters")

    def _shapes(self, t, mb, S, K, P):
        shapes = super()._shapes(t, mb, S, K, P)
        shapes["last_idx"] = (S,)
        return shapes


def _make_step_fn(model, spec_k, sampled, bank=None):
    """The step program body of one variant (the port of the
    reference's ``_make_step_fn``): the flat ragged step over a packed
    batch, then the accept rule over each row's ``K + 1`` scored
    positions — the raw argmax (``sampled`` False: no sampling
    arithmetic) or the speculative-sampling rule with position-keyed
    noise (accept keys at the first ``K`` positions, sample keys at all
    ``K + 1``). A plain row (``n_draft`` 0) commits one token.

    ``step(params, kv, draft_probs, b, out)`` reads only tensors: the
    params, ``kv`` (the pools and their scales, and ``w_scales``, as
    ``decode_flat`` keywords; written in place), the draft's adjusted
    probabilities ``[S, K, V]`` and the batch views ``b`` of
    :class:`_StepBuffers`; it writes the committed tokens and the
    accepted counts into ``out [S, K+2]`` int32 (tokens in the first
    ``K + 1`` columns). It reads nothing back to the host and its
    shapes depend on the rung alone, so on CUDA it is captured as it
    is.

    ``bank`` (the reference's ``lora`` variant): the
    :class:`~..adapters.AdapterBank` whose pools the step reads, with
    each row's pages and scale from the batch (``a_tables``,
    ``a_scales``)."""
    K = spec_k

    def step(params, kv, draft_probs, b, out):
        lora = {} if bank is None else {
            "adapter": (bank, b["a_tables"], b["a_scales"])}
        logits = model.decode_flat(
            params, b["tokens"], b["positions"], b["seq_ids"], b["valid"],
            block_tables=b["tables"], **lora, **kv)
        win = logits[b["win_idx"].long()]                   # [S, K+1, V]
        if not sampled:
            toks, n_acc = spec_accept_greedy(win, b["draft_tokens"],
                                             b["n_draft"])
        else:
            ctr = b["counters"][:, None].long() + torch.arange(
                K + 1, device=win.device)
            seeds = b["seeds"][:, None].expand(-1, K + 1)
            toks, n_acc = spec_accept(
                win, b["draft_tokens"], draft_probs, b["n_draft"],
                b["temperature"], b["top_k"], b["top_p"],
                row_keys(seeds[:, :K], ctr[:, :K], TAG_ACCEPT),
                row_keys(seeds, ctr, TAG_SAMPLE))
        out[:, :K + 1].copy_(toks)
        out[:, K + 1].copy_(n_acc)
    return step


def _make_draft_fn(model, sampled):
    """The draft program body of one variant (the port of the
    reference's ``_make_draft_fn``): the flat step against the draft's
    pools, then one proposal a row from its last fed position — the raw
    argmax (greedy: the greedy accept rule reads no probabilities, so
    none are produced) or a draw under ``TAG_DRAFT`` keys of (seed,
    counter) together with the full adjusted probability vector.

    ``draft(params, kv, probs, b, out)`` writes the proposals into
    ``out [S, 1]`` int32 and, sampled, the probabilities into the static
    ``probs [S, V]``; like the step it reads nothing back to the host.
    The draft takes ``decode_flat``'s pack-independent route (its dense
    part at :data:`~.model.DENSE_ROWS` rows) and its LM head on the
    ``S`` proposing rows alone, so a row's draft KV and proposal have
    the same bits in every pack."""
    def draft(params, kv, probs, b, out):
        last = model.decode_flat(
            params, b["tokens"], b["positions"], b["seq_ids"], b["valid"],
            block_tables=b["tables"], dense_rows=DENSE_ROWS,
            out_rows=b["last_idx"], **kv)                   # [S, V]
        if not sampled:
            out[:, 0].copy_(torch.argmax(last, dim=-1))
            return
        toks, p = sample_and_probs(
            last, b["temperature"], b["top_k"], b["top_p"],
            row_keys(b["seeds"], b["counters"], TAG_DRAFT))
        out[:, 0].copy_(toks)
        probs.copy_(p)
    return draft


class _StepProgram:
    """A program at one (packed length, table width, greedy|sampled)
    rung — the verify step's, or with ``kind="draft"`` a draft round's:
    the rung's static batch (its buffers, shared by both variants of the
    rung), its static output ``[S, width]`` int32 and, once
    :meth:`capture` ran, the CUDA graph of the program over them.

    :meth:`run`: one host-to-device copy of the batch, then one graph
    replay (the CPU: the function, eagerly), then ONE device-to-host
    copy of the output, the dispatch's only synchronisation. The copies
    stay outside the graph: the graph reads only device memory, and the
    pinned buffer is the host's to fill between dispatches."""

    def __init__(self, rung, fn, args, bufs, width, S, device,
                 kind="step"):
        self.rung = rung
        self.kind = kind
        self.bufs = bufs
        self.device = device
        out = torch.zeros((S, width), dtype=torch.int32, device=device)
        self._out = out
        self._host_out = out if device.type == "cpu" else torch.zeros(
            (S, width), dtype=torch.int32).pin_memory()
        self.fn = lambda: fn(*args, bufs.device_views, out)
        self.graph = None
        self.runs = 0
        self.replays = 0

    def __str__(self):
        t, mb, sampled = self.rung
        return f"t{t}mb{mb}_{'sampled' if sampled else 'greedy'}"

    def capture(self, stream, pool):
        """Capture the program into a CUDA graph on the engine's side
        ``stream`` in its ``pool``; raises naming the rung when the
        capture fails."""
        self.graph = kernels.capture(self.fn, stream, pool,
                                     what=f"the {self.kind} rung {self}")

    def run(self):
        """Returns host arrays (tokens [S, K+1], n_accepted [S]); a
        draft round's: the proposals [S]."""
        self.bufs.upload()
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
        elif self.device.type == "cpu":
            self.fn()
        else:
            raise RuntimeError(f"{self.kind} rung {self} has no captured "
                               f"graph")
        self.runs += 1
        if self._host_out is not self._out:
            self._host_out.copy_(self._out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        out = self._host_out.numpy().copy()
        if self.kind == "draft":
            return out[:, 0]
        return out[:, :-1], out[:, -1]


class LLMEngine:
    """Token-level scheduler + the flat ragged step, on one device.

    ``model`` is a :class:`~.model.TinyDecoder` (or any object with its
    shape attributes and ``decode_flat``); ``params`` its param tree —
    host numpy (as ``init_params_numpy`` or the JAX package's
    ``init_params`` return it) or tensors — or a
    :class:`~.quant.QuantizedWeights`.

    Config resolution: constructor arg > ``MXNET_TPU_LLM_*`` env var >
    default. ``max_context`` must be a multiple of ``block_size``;
    ``num_blocks`` must leave room for one full-context sequence.
    ``dtype`` is the float type of the KV pools and the fallback of
    ``kv_dtype``, in the reference's position: ``"float32"`` (default),
    ``"bfloat16"`` or ``"float16"``, or their ``torch.dtype``; 16-bit
    pools store K/V rounded to nearest even and the paged kernels read
    them as f32 (weights, activations and logits stay f32, as in the
    reference).
    ``kv_dtype`` (``MXNET_TPU_LLM_KV_DTYPE``, else ``dtype``): a pool
    dtype above, ``int8`` or ``fp8`` (``float8_e4m3fn``; int8 with a
    counted warning where torch lacks it); ``weight_dtype``
    (``MXNET_TPU_LLM_WEIGHT_DTYPE``): ``int8`` or ``fp8`` quantizes a
    f32 tree per output channel.
    ``device`` defaults to ``"cuda"`` and must be the model's.

    Speculative decoding: ``draft_model`` / ``draft_params`` (a smaller
    model of the same vocab whose ``max_context`` covers the engine's)
    and ``spec_k`` (``MXNET_TPU_LLM_SPEC_K``, else 3 with a draft and 0
    without; proposals a row a step); ``draft_weight_dtype``
    (``MXNET_TPU_LLM_DRAFT_WEIGHT_DTYPE``) quantizes the draft's f32
    tree as ``weight_dtype`` does the target's. The draft's pools take
    the target's KV dtype and block ids.

    Multi-LoRA: ``adapter_bank``, an
    :class:`~..adapters.AdapterBank` shaped for the model (its layers
    and ``d_model``) on the engine's device; a sequence's ``adapter``
    names a published adapter.
    """

    def __init__(self, model, params, max_seqs=None, block_size=None,
                 num_blocks=None, max_context=None, prefill_chunk=None,
                 draft_model=None, draft_params=None, spec_k=None,
                 stats=None, dtype="float32", breaker=None,
                 prefix_cache=None, kv_dtype=None, adapter_bank=None,
                 mesh=None, weight_dtype=None, weight_calib=None,
                 draft_weight_dtype=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                f"mesh=: {_DEFERRED['mesh']} is not ported to the "
                f"PyTorch engine yet (ROADMAP.md, section 1)")
        if adapter_bank is not None:
            d_model = model.num_heads * model.head_dim
            if (adapter_bank.num_layers != model.num_layers
                    or adapter_bank.d_model != d_model):
                raise ValueError(
                    f"adapter bank shaped for {adapter_bank.num_layers}"
                    f" layers x d_model {adapter_bank.d_model}, model "
                    f"has {model.num_layers} x {d_model}")
        self.bank = adapter_bank
        if _dtype_name(dtype) not in _POOL_DTYPES:
            raise ValueError(
                f"dtype={dtype!r}: the KV pools take "
                f"{', '.join(_POOL_DTYPES)} (or int8/fp8 through "
                f"kv_dtype)")
        self.device = resolve_device(device)
        if adapter_bank is not None and adapter_bank.device != self.device:
            raise ValueError(f"adapter_bank is on {adapter_bank.device}, "
                             f"engine on {self.device}")
        for which, m in (("model", model), ("draft_model", draft_model)):
            if m is not None and getattr(m, "device",
                                         self.device) != self.device:
                raise ValueError(f"{which} is on {m.device}, engine on "
                                 f"{self.device}")
        self.model = model
        if max_seqs is None:
            max_seqs = _env_int("MXNET_TPU_LLM_MAX_SEQS", 8)
        if block_size is None:
            block_size = _env_int("MXNET_TPU_LLM_BLOCK_SIZE", 16)
        if max_context is None:
            max_context = _env_int("MXNET_TPU_LLM_MAX_CONTEXT",
                                   model.max_context)
        if max_context > model.max_context:
            raise ValueError(
                f"max_context {max_context} exceeds the model's "
                f"{model.max_context}")
        if max_context % block_size:
            raise ValueError(
                f"max_context {max_context} must be a multiple of "
                f"block_size {block_size}")
        blocks_per_seq = max_context // block_size
        if num_blocks is None:
            num_blocks = _env_int("MXNET_TPU_LLM_NUM_BLOCKS",
                                  max_seqs * blocks_per_seq + 1)
        if num_blocks - 1 < blocks_per_seq:
            raise ValueError(
                f"num_blocks {num_blocks} cannot hold one full-context "
                f"sequence ({blocks_per_seq} blocks + the null block)")
        self.max_seqs = int(max_seqs)
        self.max_context = int(max_context)
        if prefill_chunk is None:
            prefill_chunk = _env_int("MXNET_TPU_LLM_PREFILL_CHUNK", 16)
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.prefill_chunk = min(int(prefill_chunk), self.max_context)
        if spec_k is None:
            spec_k = _env_int("MXNET_TPU_LLM_SPEC_K",
                              3 if draft_model is not None else 0)
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        self.spec_k = int(spec_k) if draft_model is not None else 0
        self.draft_model = draft_model if self.spec_k > 0 else None
        # per-row query budget: a prefill chunk or a K+1-position
        # speculative verify, whichever is wider
        self.q_tokens = max(self.prefill_chunk, self.spec_k + 1)
        # packed-length ladder: all-rows decode/verify, the EXACT
        # lengths of the commonest mixed steps (one or two rows
        # mid-prefill while the rest decode/verify, so those dispatch
        # pad-free), full prefill; table-width ladder: half and full
        # table
        K1 = self.spec_k + 1
        t_lo = self.max_seqs * K1
        t_hi = max(t_lo, self.max_seqs * self.q_tokens)
        mids = {min(t_hi, i * self.q_tokens + (self.max_seqs - i) * K1)
                for i in (1, 2) if i <= self.max_seqs}
        self._t_buckets = sorted({t_lo, t_hi} | mids)
        # draft feeds are 1-2 tokens a row in steady state (catch-up +
        # proposal) and chunk-wide while they mirror prefill
        if self.draft_model is not None:
            d_lo = self.max_seqs * min(2, self.q_tokens)
            self._draft_t_buckets = sorted(
                {d_lo, t_hi} | {max(d_lo, m) for m in mids})
        else:
            self._draft_t_buckets = []
        mb = max_context // block_size
        self._mb_widths = sorted({max(1, -(-mb // 2)), mb})
        if prefix_cache is None:
            prefix_cache = bool(_env_int("MXNET_TPU_LLM_PREFIX_CACHE", 1))
        self.prefix_enabled = bool(prefix_cache)
        if kv_dtype is None:
            kv_dtype = _env_str("MXNET_TPU_LLM_KV_DTYPE",
                                _dtype_name(dtype))
        kv_dtype, kv_fell_back = _resolve_kv_dtype(kv_dtype)
        self.kv_dtype_fallbacks = int(kv_fell_back)
        if kv_fell_back:
            if stats is not None:
                stats.record_quant_fallback()
            warnings.warn(
                "fp8 KV requested but float8_e4m3fn is unavailable; "
                "serving int8 KV instead", RuntimeWarning, stacklevel=2)
        self.cache = PagedKVCache(
            model.num_layers, model.num_heads, model.head_dim,
            block_size, num_blocks, max_context,
            dtype=kv_dtype, prefix_cache=self.prefix_enabled,
            device=self.device)
        self.quantized = self.cache.quantized
        self.scheduler = Scheduler(self.max_seqs)
        self._stats = stats
        if adapter_bank is not None and stats is not None:
            adapter_bank.attach_stats(stats)
        if self.prefix_enabled:
            self.cache.on_prefix_evict = self._on_prefix_evict
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefill_tokens_saved = 0
        qw = self._resolve_weight_input(params, weight_dtype,
                                        weight_calib,
                                        "MXNET_TPU_LLM_WEIGHT_DTYPE")
        self.params, self.w_scales, qw = self._place_weights(params, qw)
        if qw is None:
            leaves = list(flatten_params(self.params).values())
            self.weight_dtype = "float32"
            self.weight_bytes = int(sum(a.numel() * a.element_size()
                                        for a in leaves))
            self.weight_params = int(sum(a.numel() for a in leaves))
        else:
            self.weight_dtype = qw.dtype
            self.weight_bytes = qw.nbytes()
            self.weight_params = qw.num_params()
        self.weight_quantized = qw is not None
        if self._stats is not None:
            self._stats.record_weight_quant(
                self.weight_dtype, self.weight_bytes, self.weight_params)
        S, V, K = self.max_seqs, model.vocab_size, self.spec_k
        self._kv = self._kv_args(self.cache, self.w_scales)
        self.draft_cache = self.draft_params = self.draft_w_scales = None
        self.draft_weight_dtype = None
        self.draft_weight_quantized = False
        if self.draft_model is not None:
            self._init_draft(draft_model, draft_params, draft_weight_dtype,
                             weight_calib, block_size, num_blocks,
                             max_context, kv_dtype)
        # the verify step reads the draft's adjusted probabilities from
        # here: each sampled draft round copies its [S, V] output into
        # its column (device to device); empty without a draft
        self._draft_probs = torch.zeros((S, K, V), dtype=torch.float32,
                                        device=self.device)
        # every rung's buffers now: a pinned allocation must never run
        # inside a capture
        P = 0 if self.bank is None else self.bank.max_pages_per_adapter
        self._bufs = {(t, mb): _StepBuffers(t, mb, S, self.device, K, P)
                      for t in self._t_buckets for mb in self._mb_widths}
        self._draft_bufs = {(t, mb): _DraftBuffers(t, mb, S, self.device)
                            for t in self._draft_t_buckets
                            for mb in self._mb_widths}
        self._programs = {}
        self._draft_programs = {}
        # one graph memory pool and one capture stream an engine (the
        # step's and the draft's graphs alike), made at its first
        # capture
        self._graph_pool = self._capture_stream = None
        self.capture_seconds = 0.0
        self._arange = np.arange(self.q_tokens, dtype=np.int32)
        self._breaker = breaker
        # sequences finished but not yet handed to the caller — kept
        # OUTSIDE step()'s event list so a step that finishes A and then
        # raises on B cannot lose A
        self._finished_pending = []
        # (seq, reason) whose deadline expired / cancel was requested
        self._dead_pending = []
        # (seq, exc) isolated out of a failing dispatch
        self._poison_pending = []

    def _init_draft(self, draft_model, draft_params, draft_weight_dtype,
                    weight_calib, block_size, num_blocks, max_context,
                    kv_dtype):
        """The draft model's pools, weights and round-output tensor."""
        if draft_model.vocab_size != self.model.vocab_size:
            raise ValueError(
                f"draft vocab {draft_model.vocab_size} != target vocab "
                f"{self.model.vocab_size}")
        if draft_model.max_context < self.max_context:
            raise ValueError(
                f"draft max_context {draft_model.max_context} < engine "
                f"max_context {self.max_context}")
        # the draft's pages are indexed by the SAME block ids the target
        # allocator hands out — its own allocator is never touched, so
        # there is exactly one strict accounting
        self.draft_cache = PagedKVCache(
            draft_model.num_layers, draft_model.num_heads,
            draft_model.head_dim, block_size, num_blocks, max_context,
            dtype=kv_dtype, device=self.device)
        # a quantized draft is the cheap-draft lever: its quality moves
        # only the accept rate, never the committed stream
        dqw = self._resolve_weight_input(
            draft_params, draft_weight_dtype, weight_calib,
            "MXNET_TPU_LLM_DRAFT_WEIGHT_DTYPE")
        self.draft_weight_dtype = "float32" if dqw is None else dqw.dtype
        self.draft_weight_quantized = dqw is not None
        self.draft_params, self.draft_w_scales, _ = self._place_weights(
            draft_params, dqw)
        self._draft_kv = self._kv_args(self.draft_cache,
                                       self.draft_w_scales)
        # a sampled draft round's adjusted probabilities [S, V]
        self._draft_round_probs = torch.zeros(
            (self.max_seqs, self.model.vocab_size), dtype=torch.float32,
            device=self.device)

    def _place_weights(self, params, qw):
        """``(params, w_scales, checkpoint)`` on the engine's device: the
        f32 tree (``qw`` None: no scales, no checkpoint) or the quantized
        checkpoint ``qw``."""
        if qw is None:
            return params_from_numpy(params, self.device), None, None
        qw = params_from_numpy(qw, self.device)
        return qw.params, qw.scales, qw

    @staticmethod
    def _kv_args(cache, w_scales):
        """``decode_flat``'s keywords for ``cache``'s pools (and scales)
        and the weights' scales."""
        kv = {"k_pages": cache.k_pages, "v_pages": cache.v_pages}
        if cache.quantized:
            kv.update(k_scales=cache.k_scales, v_scales=cache.v_scales)
        if w_scales is not None:
            kv["w_scales"] = w_scales
        return kv

    def _resolve_weight_input(self, params, weight_dtype, weight_calib,
                              env_name):
        """A quantized checkpoint (the port's or the JAX package's
        ``QuantizedWeights``) passes through; a f32 tree is quantized
        here when ``weight_dtype`` (or the ``env_name`` env var) asks;
        ``None`` = full precision."""
        if all(hasattr(params, a) for a in ("params", "scales", "dtype")):
            return params
        req = weight_dtype if weight_dtype is not None \
            else _env_str(env_name, "")
        wd, fell_back = resolve_weight_dtype(req)
        if fell_back:
            if self._stats is not None:
                self._stats.record_quant_fallback()
            warnings.warn(
                "fp8 weights requested but float8_e4m3fn is unavailable; "
                "quantizing to int8 instead", RuntimeWarning, stacklevel=3)
        if wd is None:
            return None
        calib = weight_calib if weight_calib is not None \
            else _env_str("MXNET_TPU_LLM_WEIGHT_CALIB", "absmax")
        pct = float(_env_str("MXNET_TPU_LLM_WEIGHT_PERCENTILE", "99.9"))
        return quantize_weights(params, dtype=wd, method=calib,
                                percentile=pct)

    # ------------------------------------------------ the device step --
    def _program(self, t, mb, sampled):
        """The rung's step program, built (and on CUDA captured) at its
        first use. The capture's warm run steps on the rung's device
        batch, so the batch the host has just filled is uploaded first:
        the warm run then writes only the K/V that the step itself
        writes again, the same values, and never through an older
        step's tables into blocks that may belong to another sequence
        since."""
        key = (t, mb, sampled)
        prog = self._programs.get(key)
        if prog is None:
            step = _make_step_fn(self.model, self.spec_k, sampled,
                                 bank=self.bank)
            prog = _StepProgram(key, step,
                                (self.params, self._kv, self._draft_probs),
                                self._bufs[(t, mb)], self.spec_k + 2,
                                self.max_seqs, self.device)
            self._programs[key] = prog
        return self._captured(prog)

    def _draft_program(self, t, mb, sampled):
        """The draft rung's program, built (and on CUDA captured) at its
        first use, as :meth:`_program` builds the step's."""
        key = (t, mb, sampled)
        prog = self._draft_programs.get(key)
        if prog is None:
            draft = _make_draft_fn(self.draft_model, sampled)
            prog = _StepProgram(key, draft,
                                (self.draft_params, self._draft_kv,
                                 self._draft_round_probs),
                                self._draft_bufs[(t, mb)], 1,
                                self.max_seqs, self.device, kind="draft")
            self._draft_programs[key] = prog
        return self._captured(prog)

    def _captured(self, prog):
        if prog.graph is None and self.device.type == "cuda":
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._capture_stream = torch.cuda.Stream(self.device)
            t0 = time.monotonic()
            prog.bufs.upload()
            prog.capture(self._capture_stream, self._graph_pool)
            self.capture_seconds += time.monotonic() - t0
        return prog

    def _all_programs(self):
        return list(self._programs.values()) + list(
            self._draft_programs.values())

    def release_graphs(self):
        """Drop every captured graph and the engine's graph memory pool
        (the server does it at shutdown); a later dispatch captures its
        rung again, counted as a compile."""
        for prog in self._all_programs():
            prog.graph = None
        self._graph_pool = self._capture_stream = None

    def graph_pool_bytes(self):
        """Device bytes the engine's graph memory pool holds (0 on the
        CPU or with no graph held)."""
        if self._graph_pool is None:
            return 0
        pool = tuple(self._graph_pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def programs(self):
        """The programs, as the reference's statusz reports them: the
        step's and the draft's ladders, the step and draft variants
        built (one per rung reached; each a captured graph on CUDA), the
        graphs held, the replays and the dispatches (every program run,
        verify steps and draft rounds; the draft's also apart), and the
        seconds spent capturing."""
        progs = self._all_programs()
        drafts = self._draft_programs.values()
        return {"t_buckets": list(self._t_buckets),
                "mb_widths": list(self._mb_widths),
                "draft_t_buckets": list(self._draft_t_buckets),
                "step_variants": len(self._programs),
                "draft_variants": len(self._draft_programs),
                "graphs": sum(p.graph is not None for p in progs),
                "draft_graphs": sum(p.graph is not None for p in drafts),
                "replays": sum(p.replays for p in progs),
                "dispatches": sum(p.runs for p in progs),
                "draft_dispatches": sum(p.runs for p in drafts),
                "capture_seconds": self.capture_seconds}

    # ------------------------------------------------ prefix caching --
    def _prefix_salt(self, seq):
        """The sequence's prefix-cache namespace. Adapter KV is not
        base-model KV (the LoRA delta rides the K/V projections), so
        cached blocks are reusable only under the same adapter name and
        version: the pinned handle's identity seeds the hash chain.
        Base-model sequences share the unsalted namespace."""
        h = seq.adapter_handle
        return b"" if h is None else f"{h.name}@{h.version}".encode()

    def _prefix_lookup(self, seq):
        """Longest chain of registered blocks matching the prompt's
        full-block prefix. Pure read — no refcounts move until the
        admission proceeds. Returns ``(block_ids, hit_tokens)`` with
        ``hit_tokens <= len(prompt) - 1``: at least one prompt token is
        always recomputed, because its logits emit the first generated
        token. When the whole prompt is block-aligned and cached, that
        last token's chunk rewrites the final SHARED block — the
        copy-on-write in :meth:`_allocate` gives the sequence its own
        copy first."""
        T = len(seq.prompt)
        bs = self.cache.block_size
        if seq.prefix_hashes is None:
            seq.prefix_hashes = prefix_block_hashes(
                seq.prompt, bs, salt=self._prefix_salt(seq))
        hit = []
        for h in seq.prefix_hashes:
            bid = self.cache.prefix_get(h)
            if bid is None:
                break
            hit.append(bid)
        hit_tokens = min(len(hit) * bs, T - 1)
        n_keep = -(-hit_tokens // bs) if hit_tokens > 0 else 0
        return hit[:n_keep], hit_tokens

    def _register_blocks(self, seq):
        """Register the sequence's FULL, immutable blocks in the prefix
        index (chained hashes over prompt + generated tokens, truncated
        to KV actually written). First registration of a hash wins."""
        if not self.prefix_enabled:
            return
        bs = self.cache.block_size
        tokens = seq.prompt + seq.generated
        n_full = min(seq.seq_len, len(tokens)) // bs
        n_full = min(n_full, len(seq.block_ids))
        if n_full <= 0:
            return
        hashes = seq.prefix_hashes or []
        if len(hashes) < n_full:
            hashes = prefix_block_hashes(tokens[:n_full * bs], bs,
                                         salt=self._prefix_salt(seq))
            seq.prefix_hashes = hashes
        for k in range(n_full):
            self.cache.register(hashes[k], seq.block_ids[k])

    def _caches(self):
        return [self.cache] + ([self.draft_cache]
                               if self.draft_cache is not None else [])

    def _cow_block(self, seq, bi):
        """Copy-on-write block ``seq.block_ids[bi]``: allocate a private
        copy, copy the page row in every pool in place (the target's
        and the draft's, with their scales), repoint the sequence's
        table and drop one reference on the shared original."""
        old = seq.block_ids[bi]
        new = self.cache.allocator.alloc(1)[0]
        try:
            for cache in self._caches():
                cache.copy_block(old, new)
        except BaseException:
            # the private block is in no table yet: nothing else frees it
            self.cache.allocator.free([new])
            raise
        seq.block_ids[bi] = new
        self.cache.allocator.free([old])
        self.cache.cow_count += 1

    # ------------------------------------------------------- warmup --
    def warmup(self):
        """Build the program of every rung steady state can reach — the
        draft's (packed length, table width, greedy|sampled) rungs with
        a draft model, then the step's — on CUDA, capture its graph,
        whose warm run builds and loads every kernel it launches, and
        run it once; then the copy-on-write once. After this no traffic
        the ladders cover builds or captures anything; a rung that fails
        raises, naming it. With an adapter bank, its install path runs
        first (``adapter_install``). Returns {rung: seconds}."""
        timings = {}
        if self.bank is not None:
            t0 = time.monotonic()
            self.bank.warmup()
            timings["adapter_install"] = time.monotonic() - t0
        for kind, ladder, bufs_of, program in (
                ("draft", self._draft_t_buckets, self._draft_bufs,
                 self._draft_program),
                ("step", self._t_buckets, self._bufs, self._program)):
            for T in ladder:
                for MB in self._mb_widths:
                    bufs = bufs_of[(T, MB)]
                    bufs.valid.fill(0)
                    bufs.tables.fill(NULL_BLOCK)
                    if kind == "step":
                        bufs.n_draft.fill(0)
                        if self.bank is not None:
                            bufs.a_tables.fill(NULL_ADAPTER_PAGE)
                            bufs.a_scales.fill(0.0)
                    for sampled in (False, True):
                        t0 = time.monotonic()
                        prog = program(T, MB, sampled)
                        prog.run()
                        timings[f"{kind}_{prog}"] = time.monotonic() - t0
        if self.prefix_enabled:
            t0 = time.monotonic()
            for cache in self._caches():
                cache.copy_block(NULL_BLOCK, NULL_BLOCK)
            timings["cow_copy"] = time.monotonic() - t0
        return timings

    # ---------------------------------------------------- admission --
    def add_validate(self, seq):
        """Validate a sequence WITHOUT enqueueing it — the server runs
        this on the caller's thread so shape/vocab errors raise at
        submit time, not inside the engine loop."""
        if not isinstance(seq, Sequence):
            raise TypeError(f"add() wants a Sequence, got {type(seq)}")
        if len(seq.prompt) > self.max_context - 1:
            raise ValueError(
                f"prompt of {len(seq.prompt)} tokens leaves no room to "
                f"generate (max_context={self.max_context})")
        vocab = self.model.vocab_size
        bad = [t for t in seq.prompt if not (0 <= t < vocab)]
        if bad:
            raise ValueError(
                f"prompt tokens {bad[:4]} out of vocab [0, {vocab})")
        return seq

    def add(self, seq):
        """Enqueue a WAITING sequence."""
        self.scheduler.add(self.add_validate(seq))

    def has_work(self):
        return self.scheduler.has_work()

    def _record_block_gauges(self):
        if self._stats:
            a = self.cache.allocator
            self._stats.record_blocks(
                a.num_used, a.num_usable, cached=a.num_cached,
                shared=a.num_shared, free=a.num_free - a.num_cached)
            self._stats.record_admission_state(
                self.scheduler.num_waiting, self.scheduler.num_running)

    def _on_prefix_evict(self, n=1):
        if self._stats:
            self._stats.record_prefix_evict(n)

    def _admit(self, events):
        """Place waiting sequences into free slots. The KV gate (the
        full prompt + one decode block must fit, prefix-hit blocks
        discounted — they are ref'd, not allocated) keeps FIFO admission
        from thrashing the preemption path."""
        while self.scheduler.num_waiting:
            slot = self.scheduler.free_slot()
            if slot is None:
                break
            seq = self.scheduler.peek_waiting()
            if (self.bank is not None and seq.adapter is not None
                    and seq.adapter_handle is None):
                # pin the adapter version BEFORE the prefix lookup: the
                # pinned (name, version) salts the hash chain. A failed
                # pin (unknown name) poisons the sequence without
                # touching cache state; a later KV gate break leaves the
                # pin on the waiting sequence, reused at its next
                # admission and released on its terminal state
                try:
                    seq.adapter_handle = self.bank.acquire(
                        seq.adapter, tenant=seq.tenant)
                except AdapterError as exc:
                    self.scheduler.waiting.popleft()
                    self._poison(seq, exc, events)
                    continue
            T = len(seq.prompt)
            hit, hit_tokens = ([], 0)
            if self.prefix_enabled:
                hit, hit_tokens = self._prefix_lookup(seq)
            need = self.cache.blocks_for(T) - len(hit)
            if T % self.cache.block_size == 0:
                need += 1           # first decode opens a new page
            if hit_tokens and hit_tokens < len(hit) * \
                    self.cache.block_size:
                # truncated (block-aligned full) hit: the recompute
                # chunk rewrites the FINAL hit block, which COWs when
                # shared — reserve its private copy up front
                need += 1
            # hit blocks in the cached LRU count toward num_free but are
            # about to be ref()'d by THIS admission
            cached_hits = sum(
                1 for bid in hit
                if self.cache.allocator.refcount(bid) == 0)
            if not self.cache.allocator.can_alloc(need + cached_hits):
                break               # FIFO: no head-of-line skipping
            for bid in hit:
                self.cache.allocator.ref(bid)
            self.scheduler.place(seq, slot)
            seq.block_ids = list(hit)
            seq.seq_len = hit_tokens
            seq.draft_len = 0
            seq.cache_hit_tokens = hit_tokens
            if self.prefix_enabled:
                self.prefix_lookups += 1
                if hit_tokens > 0:
                    self.prefix_hits += 1
                    self.prefill_tokens_saved += hit_tokens
                if self._stats:
                    self._stats.record_prefix_lookup(hit_tokens)
            events.append(("admitted", seq))

    def _release_adapter(self, seq):
        """Drop the sequence's adapter pin on a terminal release.
        Preemption keeps it: the pinned version is what makes a
        preempted sequence's re-prefill bit-identical even if the
        adapter was republished in between."""
        if seq.adapter_handle is not None and self.bank is not None:
            self.bank.release(seq.adapter_handle)
            seq.adapter_handle = None

    def _finish(self, seq, events):
        self._register_blocks(seq)
        self.cache.allocator.free(seq.block_ids)
        seq.block_ids = []
        self._release_adapter(seq)
        reason = ("stop_token" if (seq.stop_token is not None
                                   and seq.generated
                                   and seq.generated[-1]
                                   == seq.stop_token)
                  else "length" if seq.num_generated
                  < seq.max_new_tokens else "max_new_tokens")
        self.scheduler.release(seq, FINISHED, reason)
        self._finished_pending.append(seq)
        events.append(("finished", seq))

    def _preempt(self, seq):
        self.cache.allocator.free(seq.block_ids)
        seq.block_ids = []
        self.scheduler.preempt(seq)
        if self._stats:
            self._stats.record_preemption()

    def _poison(self, seq, exc, events):
        """Release ``seq`` as poison-isolated: blocks freed, slot freed,
        the ORIGINAL exception queued for the server."""
        if seq.block_ids:
            self.cache.allocator.free(seq.block_ids)
            seq.block_ids = []
        self._release_adapter(seq)
        self.scheduler.release(seq, EVICTED, "poison")
        self._poison_pending.append((seq, exc))
        if self._stats:
            self._stats.record_poison()
        events.append(("poisoned", seq))

    def _expire(self, events):
        """Release sequences whose end-to-end deadline expired or whose
        caller cancelled them. Waiting ones die before costing any
        prefill; running ones free their KV blocks and slot now."""
        now = time.monotonic()
        if self.scheduler.waiting:
            keep = collections.deque()
            while self.scheduler.waiting:
                seq = self.scheduler.waiting.popleft()
                reason = ("timeout" if seq.cancelled
                          else "deadline" if seq.expired(now) else None)
                if reason is None:
                    keep.append(seq)
                    continue
                self._release_adapter(seq)
                self.scheduler.release(seq, EVICTED, reason)
                self._dead_pending.append((seq, reason))
                events.append(("expired", seq))
            self.scheduler.waiting = keep
        for seq in self.scheduler.running():
            reason = ("timeout" if seq.cancelled
                      else "deadline" if seq.expired(now) else None)
            if reason is None:
                continue
            self.cache.allocator.free(seq.block_ids)
            seq.block_ids = []
            self._release_adapter(seq)
            self.scheduler.release(seq, EVICTED, reason)
            self._dead_pending.append((seq, reason))
            events.append(("expired", seq))

    # ----------------------------------------------------- planning --
    def _plan(self, seq):
        """This step's work for one running sequence: its next prompt
        chunk while the prompt is being written (preemption folds the
        generation into the prompt, so an empty generation list means
        "prompt not complete"), else its decode token and, with a draft,
        how many proposals it may verify (``k``): a row speculates when
        the draft's committed prefix can catch up within ONE feed
        (steady state: 1-2 tokens behind; a degraded draft recovers over
        catch-up-only feeds first)."""
        if not seq.generated:
            committed = seq.prompt
            cl = len(committed)
            ntok = min(self.prefill_chunk, cl - seq.seq_len)
            return {"kind": "prefill",
                    "tokens": committed[seq.seq_len:seq.seq_len + ntok],
                    "ntok": ntok, "cl": cl, "committed": committed,
                    "k": 0, "emit": seq.seq_len + ntok == cl,
                    "draft_tokens": []}
        cl = len(seq.prompt) + len(seq.generated)
        k = 0
        committed = None
        if self.draft_model is not None:
            committed = seq.prompt + seq.generated
            if cl - seq.draft_len <= self.q_tokens:
                rem_new = seq.max_new_tokens - seq.num_generated
                k = max(0, min(self.spec_k, rem_new - 1,
                               self.max_context - 1 - seq.seq_len))
        return {"kind": "decode", "tokens": [seq.last_token],
                "ntok": 1 + k, "cl": cl, "committed": committed,
                "k": k, "emit": True, "draft_tokens": []}

    def _allocate(self, seq, plan, events):
        """Blocks covering this step's KV writes (positions ``seq_len ..
        seq_len + ntok - 1``), allocated ONTO the sequence before the
        dispatch; under pressure preempt newest-arrived first. A
        write-range block the sequence still SHARES is copied to a
        private block first, so shared prefix KV stays immutable."""
        need = self.cache.blocks_for(seq.seq_len + plan["ntok"]) \
            - len(seq.block_ids)
        cow = []
        if self.prefix_enabled and seq.block_ids:
            bs = self.cache.block_size
            first = seq.seq_len // bs
            last = min((seq.seq_len + plan["ntok"] - 1) // bs,
                       len(seq.block_ids) - 1)
            cow = [bi for bi in range(first, last + 1)
                   if self.cache.allocator.refcount(
                       seq.block_ids[bi]) > 1]
        total = max(need, 0) + len(cow)
        while total > 0 and not self.cache.allocator.can_alloc(total):
            victim = self.scheduler.pick_victim(exclude=(seq,))
            if victim is None:
                raise KVCacheError(
                    "lone sequence cannot allocate — num_blocks too "
                    "small for max_context")
            self._preempt(victim)
            events.append(("preempted", victim))
        for bi in cow:
            # a victim preemption above may have dropped the share
            if self.cache.allocator.refcount(seq.block_ids[bi]) > 1:
                self._cow_block(seq, bi)
        if need > 0:
            seq.block_ids.extend(self.cache.allocator.alloc(need))

    # -------------------------------------------------- draft phase --
    def _draft_dispatch(self, rows, feeds, counters_v, r):
        """One draft round (narrow rungs for 1-2-token proposal feeds,
        chunk-wide while mirroring prefill). ``feeds``: {seq: (tokens,
        start_pos)}; rows not in it ride along inactive. A sampled
        round's probabilities go, device to device, into column ``r`` of
        the verify's draft probabilities. Returns the proposals [S] as a
        host array."""
        t_need = sum(len(t) for t, _ in feeds.values())
        t = next(w for w in self._draft_t_buckets if w >= t_need)
        mb_need = max(self.cache.blocks_for(start + len(toks))
                      for toks, start in feeds.values())
        mb = next(w for w in self._mb_widths if w >= mb_need)
        b = self._draft_bufs[(t, mb)]
        b.valid.fill(0)         # see _build_batch: never-stale writes
        off = 0
        for seq in rows:
            feed = feeds.get(seq)
            if feed is None:
                continue
            toks, start = feed
            i, n = seq.slot, len(toks)
            b.tokens[off:off + n] = toks
            b.positions[off:off + n] = start + self._arange[:n]
            b.seq_ids[off:off + n] = i
            b.valid[off:off + n] = 1
            b.last_idx[i] = off + n - 1
            nb = min(len(seq.block_ids), mb)
            b.tables[i, :nb] = seq.block_ids[:nb]
            b.tables[i, nb:] = NULL_BLOCK
            sp = seq.sampling
            b.temperature[i] = sp.temperature
            b.top_k[i] = sp.top_k
            b.top_p[i] = sp.top_p
            b.seeds[i] = sp.seed
            b.counters[i] = counters_v.get(seq, 0)
            off += n
        sampled = any(s.sampling.temperature > 0 for s in feeds)
        tok = self._draft_program(t, mb, sampled).run()
        if sampled:
            self._draft_probs[:, r].copy_(self._draft_round_probs)
        return tok

    def _draft_propose(self, rows, plans):
        """Run the draft model: mirror prefill chunks into the draft
        pools, catch its committed prefix up, and propose up to K tokens
        a speculating row (kept on the row's plan; their probabilities
        stay on the device). A failing draft dispatch DEGRADES the step
        to plain decode — never poisons, never leaks (the draft's pages
        share the target's block accounting); a graph capture (which
        builds the kernels it launches) raises instead.

        Prefix-cache interaction: catch-up feeds for a cache-hit
        sequence write DRAFT-pool KV into rows of blocks whose TARGET KV
        is shared, without a copy-on-write. This rests on the draft KV
        of position p being a pure function of the committed prefix, so
        every owner of a shared block writes the same draft rows. Only
        the TARGET pool is strictly immutable under sharing: its writes
        carry new per-sequence content and always copy first
        (:meth:`_allocate`)."""
        if self.draft_model is None:
            return
        feeds, counters, proposing = {}, {}, []
        for seq in rows:
            plan = plans[seq]
            if plan["kind"] == "prefill":
                # mirror the target's chunk. Normally draft_len ==
                # seq_len and this IS the same chunk; after a degraded
                # draft step the mirror restarts from the draft's own
                # watermark so its KV prefix never gaps
                end = min(seq.seq_len + plan["ntok"],
                          seq.draft_len + self.q_tokens)
                feeds[seq] = (plan["committed"][seq.draft_len:end],
                              seq.draft_len)
                plan["draft_fed"] = end - seq.draft_len
            elif plan["k"] > 0:
                # catch-up (<= 2 tokens in steady state) + the proposal
                # input
                feed = plan["committed"][seq.draft_len:plan["cl"]]
                feeds[seq] = (feed, seq.draft_len)
                plan["draft_fed"] = len(feed)
                counters[seq] = plan["cl"]
                proposing.append(seq)
            elif seq.draft_len < plan["cl"]:
                # a draft that fell behind (an earlier degraded step):
                # catch-up-only feed, one chunk a step, until the
                # speculation gate in _plan opens again
                end = min(plan["cl"], seq.draft_len + self.q_tokens)
                feeds[seq] = (plan["committed"][seq.draft_len:end],
                              seq.draft_len)
                plan["draft_fed"] = end - seq.draft_len
        if not feeds:
            return
        try:
            tok = self._draft_dispatch(rows, feeds, counters, 0)
            for seq in proposing:
                plans[seq]["draft_tokens"].append(int(tok[seq.slot]))
            for r in range(1, self.spec_k):
                feeds, counters = {}, {}
                for seq in proposing:
                    plan = plans[seq]
                    if plan["k"] <= r:
                        continue
                    feeds[seq] = ([plan["draft_tokens"][-1]],
                                  plan["cl"] + r - 1)
                    counters[seq] = plan["cl"] + r
                    plan["draft_fed"] += 1
                if not feeds:
                    break
                tok = self._draft_dispatch(rows, feeds, counters, r)
                for seq in feeds:
                    plans[seq]["draft_tokens"].append(int(tok[seq.slot]))
        except kernels.CaptureError:
            raise
        except Exception:
            # degrade: this step decodes without speculation; the draft
            # prefix watermark is simply not advanced, so the next
            # step's catch-up re-feeds deterministically
            for seq in rows:
                plan = plans[seq]
                if plan["kind"] == "decode":
                    plan["k"] = 0
                    plan["ntok"] = 1
                    plan["tokens"] = [seq.last_token]
                    plan["draft_tokens"] = []
                plan.pop("draft_fed", None)
            if self._stats:
                self._stats.record_spec_degraded()
        else:
            for seq in proposing:
                plan = plans[seq]
                plan["k"] = len(plan["draft_tokens"])
                plan["ntok"] = 1 + plan["k"]
                plan["tokens"] = [seq.last_token] + plan["draft_tokens"]

    # ------------------------------------------------- the one step --
    def _build_batch(self, rows, plans, t, mb):
        """Fill the rung's host buffers. ``valid`` and ``n_draft`` are
        reset EVERY dispatch — a stale valid flag would scatter garbage
        K/V through a stale (seq_id, position, table) combination into
        blocks another sequence may own now, a stale draft count would
        verify another step's proposals; everything else stale is
        masked or discarded."""
        b = self._bufs[(t, mb)]
        b.valid.fill(0)
        b.n_draft.fill(0)
        K1 = self.spec_k + 1
        off = 0
        for seq in rows:
            plan = plans[seq]
            i, n = seq.slot, len(plan["tokens"])
            b.tokens[off:off + n] = plan["tokens"]
            b.positions[off:off + n] = seq.seq_len + self._arange[:n]
            b.seq_ids[off:off + n] = i
            b.valid[off:off + n] = 1
            # the K+1 scored positions end at this row's last token
            k = plan["k"]
            b.win_idx[i] = np.clip(off + n - 1 - k + self._arange[:K1], 0,
                                   t - 1)
            b.n_draft[i] = k
            if k:
                b.draft_tokens[i, :k] = plan["draft_tokens"]
            # blocks past the sliced width only cover positions the
            # causal mask can never reach — truncation is invisible
            nb = min(len(seq.block_ids), mb)
            b.tables[i, :nb] = seq.block_ids[:nb]
            b.tables[i, nb:] = NULL_BLOCK
            sp = seq.sampling
            b.temperature[i] = sp.temperature
            b.top_k[i] = sp.top_k
            b.top_p[i] = sp.top_p
            b.seeds[i] = sp.seed
            b.counters[i] = plan["cl"]
            if self.bank is not None:
                # each row's adapter rides the batch like the sampling
                # vectors: its pages and scale, or the all-zero null page
                # and scale 0 on a base-model row (an exactly-zero delta)
                h = seq.adapter_handle
                if h is None:
                    b.a_tables[i] = NULL_ADAPTER_PAGE
                    b.a_scales[i] = 0.0
                else:
                    b.a_tables[i] = h.pages_padded
                    b.a_scales[i] = h.scale
            off += n
        return b

    def _dispatch(self, rows, plans):
        """ONE step for ``rows`` (slots not in ``rows`` ride along
        inactive on the null block). Returns host arrays (tokens [S,
        K+1], n_accepted [S]); row i commits ``tokens[i, :n_accepted[i]
        + 1]``. Failures propagate to the isolation logic in
        :meth:`step`."""
        t_need = sum(len(plans[s]["tokens"]) for s in rows)
        t = next(w for w in self._t_buckets if w >= t_need)
        mb_need = max(self.cache.blocks_for(
            s.seq_len + plans[s]["ntok"]) for s in rows)
        mb = next(w for w in self._mb_widths if w >= mb_need)
        sampled = any(s.sampling.temperature > 0 for s in rows)
        self._build_batch(rows, plans, t, mb)
        return self._program(t, mb, sampled).run()

    def _sites(self, rows, plans):
        return {"prefill" if plans[s]["kind"] == "prefill" else "decode"
                for s in rows}

    def _record_breaker(self, rows, plans, ok):
        if self._breaker is None:
            return
        for site in self._sites(rows, plans):
            if ok:
                self._breaker.record_success(site=site)
            else:
                self._breaker.record_failure(site=site)

    def _commit(self, rows, plans, toks, n_acc, events):
        """Apply one successful dispatch's results to host state.
        Returns the number of committed decode/verify tokens (the
        throughput numerator; chunk-emitted first tokens count as
        prefill)."""
        decoded = 0
        for seq in rows:
            plan = plans[seq]
            cl = plan["cl"]
            if plan["kind"] == "prefill":
                seq.seq_len += plan["ntok"]
                if "draft_fed" in plan:
                    seq.draft_len += plan["draft_fed"]
                if self._stats:
                    self._stats.record_prefill_chunk(plan["ntok"])
                if not plan["emit"]:
                    continue
                # the prompt completed: register its full immutable
                # blocks, then commit the first generated token (from
                # this chunk's last position)
                self._register_blocks(seq)
                tok = int(toks[seq.slot, 0])
                seq.generated.append(tok)
                seq.last_token = tok
                events.append(("token", seq))
                if self._stats:
                    self._stats.record_prefill(cl - seq.cache_hit_tokens)
                    self._stats.record_prefill_token()
                if seq.t_first_token is None:
                    seq.t_first_token = time.monotonic()
                    if self._stats:
                        self._stats.record_first_token(
                            seq.t_first_token - seq.t_submit)
                if seq.done or seq.seq_len + 1 >= self.max_context:
                    self._finish(seq, events)
                continue
            # decode / speculative verify: commit the accepted drafts
            # plus the replacement/bonus token, stopping at stop /
            # max_new_tokens
            acc = int(n_acc[seq.slot])
            kept = 0
            for j in range(acc + 1):
                tok = int(toks[seq.slot, j])
                seq.generated.append(tok)
                seq.last_token = tok
                kept += 1
                events.append(("token", seq))
                if seq.done:
                    break
            seq.seq_len += kept
            decoded += kept
            if plan["k"]:
                if self._stats:
                    self._stats.record_spec(plan["k"], acc)
                # roll rejected draft KV back through the STRICT
                # allocator: blocks past the committed length return to
                # the pool (their garbage is never read: attention stops
                # at each token's position, and a block handed out again
                # is written before any position reaches it)
                seq.draft_len = min(cl + plan["k"] - 1, cl + kept - 1)
                keep_blocks = self.cache.blocks_for(max(seq.seq_len, 1))
                if len(seq.block_ids) > keep_blocks:
                    self.cache.allocator.free(seq.block_ids[keep_blocks:])
                    del seq.block_ids[keep_blocks:]
            elif "draft_fed" in plan:
                # a catch-up-only feed advanced the draft prefix
                seq.draft_len += plan["draft_fed"]
            if seq.done or seq.seq_len + 1 >= self.max_context:
                self._finish(seq, events)
        return decoded

    def _isolate(self, rows, plans, events):
        """Bisect-retry a failing dispatch to isolate the poison
        row(s): a failing singleton is evicted with its dispatch
        exception, everything else keeps its tokens. Returns the
        committed decode-token count."""
        if len(rows) == 1:
            try:
                toks, n_acc = self._dispatch(rows, plans)
            except Exception as exc:
                self._poison(rows[0], exc, events)
                return 0
            self._record_breaker(rows, plans, True)
            return self._commit(rows, plans, toks, n_acc, events)
        decoded = 0
        mid = len(rows) // 2
        for half in (rows[:mid], rows[mid:]):
            try:
                toks, n_acc = self._dispatch(half, plans)
            except Exception:
                decoded += self._isolate(half, plans, events)
            else:
                self._record_breaker(half, plans, True)
                decoded += self._commit(half, plans, toks, n_acc, events)
        return decoded

    # --------------------------------------------------------- step --
    def step(self):
        """One engine iteration. Returns events:
        ``[("admitted"|"token"|"finished"|"preempted"|"expired"|
        "poisoned", Sequence)]``."""
        events = []
        self._expire(events)
        self._admit(events)
        running = sorted(self.scheduler.running(),
                         key=lambda s: s.admit_index)
        plans = {}
        for seq in running:
            if seq.state != RUNNING:
                continue            # preempted by an earlier victim
            plan = self._plan(seq)
            self._allocate(seq, plan, events)
            plans[seq] = plan
        rows = [s for s in running if s.state == RUNNING and s in plans]
        if not rows:
            self._record_block_gauges()
            return events
        self._draft_propose(rows, plans)
        t0 = time.monotonic()
        try:
            toks, n_acc = self._dispatch(rows, plans)
        except Exception:
            self._record_breaker(rows, plans, False)
            decoded = self._isolate(rows, plans, events)
        else:
            self._record_breaker(rows, plans, True)
            decoded = self._commit(rows, plans, toks, n_acc, events)
        step_s = time.monotonic() - t0
        if self._stats and any(plans[s]["kind"] == "decode"
                               for s in rows):
            self._stats.record_decode_step(decoded, step_s)
        self._record_block_gauges()
        return events

    def pop_finished(self):
        """Drain the finished-but-unreported sequences."""
        out, self._finished_pending = self._finished_pending, []
        return out

    def pop_dead(self):
        """Drain the deadline-expired / cancelled ``(seq, reason)``
        records."""
        out, self._dead_pending = self._dead_pending, []
        return out

    def pop_poison(self):
        """Drain the poison-isolated ``(seq, exc)`` records."""
        out, self._poison_pending = self._poison_pending, []
        return out

    # -------------------------------------------------------- drain --
    def evict_all(self, reason="evicted"):
        """Release every live sequence (running AND waiting) into the
        EVICTED state, freeing its blocks. Returns the evicted
        sequences — the server turns them into typed resolutions
        carrying partial tokens, never silent drops."""
        out = []
        for seq in self.scheduler.running():
            self.cache.allocator.free(seq.block_ids)
            seq.block_ids = []
            self._release_adapter(seq)
            self.scheduler.release(seq, EVICTED, reason)
            out.append(seq)
        while self.scheduler.waiting:
            seq = self.scheduler.waiting.popleft()
            self._release_adapter(seq)
            self.scheduler.release(seq, EVICTED, reason)
            out.append(seq)
        self._record_block_gauges()
        return out

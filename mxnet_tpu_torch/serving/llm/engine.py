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
   query tokens (its next prompt chunk, or its one decode token);
   blocks covering the step's KV writes are allocated up front, and a
   write into a block still shared with another sequence is preceded by
   a copy-on-write. Under KV pressure the newest sequence is preempted
   (blocks freed, generation folded into its prompt, requeued — the
   position-keyed sampling noise resumes the exact stream);
3. **step** — ONE launch sequence for the whole mixed batch in the FLAT
   ragged layout: every row's query tokens packed into one
   ``[total_q_tokens]`` batch (tokens / positions / seq_ids / valid) +
   ``[max_seqs, mb]`` block tables, copied to the device in one
   transfer; :meth:`~.model.TinyDecoder.decode_flat` writes the KV in
   place and attends through the flat ragged kernel; greedy argmax or
   temperature / top-k / top-p sampling runs on the device on each row's
   last-position logits; ONE device-to-host copy (the step's only
   synchronisation) brings the committed tokens back. The packed length
   and the table width are bucketed on small ladders (pure decode, the
   commonest mixed steps, full prefill; half and full table width).

The step program (the port of the reference's ``_make_step_fn`` and its
per-variant jit cache): one :class:`_StepProgram` per (packed length,
table width, greedy|sampled) rung holds the rung's static batch buffers
and output and, on CUDA, a ``torch.cuda.CUDAGraph`` of the whole step
over them, captured by :meth:`LLMEngine.warmup` (or at the rung's first
use, as the reference jits lazily). A capture counts as a compile
(:func:`~..telemetry.compile_count`), so after ``warmup()`` a step is:
fill the rung's pinned host buffer, one host-to-device copy, one graph
replay, one device-to-host copy; no model code runs in Python. A capture
that fails raises, naming the rung: the engine never steps eagerly on
the card. On the CPU there is nothing to capture, and the same step
function runs eagerly on the same static buffers.

Single-threaded by design: :class:`~.server.LLMServer` owns the thread,
the queue and the futures; the engine owns device state and
determinism. Speculative decoding (a draft model), multi-LoRA adapter
banks and tensor-parallel meshes are not ported yet (ROADMAP.md §1);
asking for one raises ``NotImplementedError``.
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
from .kv_cache import (PagedKVCache, KVCacheError, NULL_BLOCK,
                       prefix_block_hashes)
from .quant import (FP8_NAME, fp8_supported, quantize_weights,
                    flatten_params, resolve_weight_dtype)
from .scheduler import Scheduler, Sequence, RUNNING, FINISHED, EVICTED
from .sampling import (TAG_SAMPLE, TAG_ACCEPT, row_keys, spec_accept,
                       spec_accept_greedy)

__all__ = ["LLMEngine"]

_DEFERRED = {
    "draft_model": "speculative decoding (a draft model)",
    "draft_params": "speculative decoding (a draft model)",
    "spec_k": "speculative decoding (a draft model)",
    "draft_weight_dtype": "speculative decoding (a draft model)",
    "adapter_bank": "multi-LoRA adapter banks",
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


class _StepBuffers:
    """Host batch arrays of one (packed length ``t``, table width
    ``mb``) rung, all views into ONE int32 buffer (pinned when the
    engine runs on CUDA) so a step's batch reaches the device in one
    copy, and the matching views of its static device twin
    (``device_views``), which a captured step reads: :meth:`upload`
    copies the host buffer into it. On the CPU the twin is the host
    buffer.

    The host writes the pinned buffer only between steps: each step ends
    in a device-to-host copy that waits for the whole stream, the upload
    included."""

    _INT_FIELDS = ("tokens", "positions", "seq_ids", "valid", "tables",
                   "win_idx", "top_k", "seeds", "counters")
    _F32_FIELDS = ("temperature", "top_p")

    def __init__(self, t, mb, S, device):
        sizes = {"tokens": t, "positions": t, "seq_ids": t, "valid": t,
                 "tables": S * mb}
        sizes.update(dict.fromkeys(("win_idx", "top_k", "seeds",
                                    "counters", "temperature", "top_p"),
                                   S))
        slices = {}
        off = 0
        for name in self._INT_FIELDS + self._F32_FIELDS:
            slices[name] = (off, off + sizes[name])
            off += sizes[name]
        shapes = {"tables": (S, mb)}
        host = torch.zeros(off, dtype=torch.int32)
        if device.type == "cuda":
            host = host.pin_memory()
        self._host = host
        self._dev = host if device.type == "cpu" else torch.zeros_like(
            host, device=device)
        self.device_views = {}
        flat = host.numpy()
        for name, (a, b) in slices.items():
            shape = shapes.get(name, (b - a,))
            view, dview = flat[a:b], self._dev[a:b]
            if name in self._F32_FIELDS:
                view, dview = view.view(np.float32), dview.view(
                    torch.float32)
            setattr(self, name, view.reshape(shape))
            self.device_views[name] = dview.view(shape)
        self.tables.fill(NULL_BLOCK)
        self.top_p.fill(1.0)

    def upload(self):
        if self._dev is not self._host:
            self._dev.copy_(self._host, non_blocking=True)


def _make_step_fn(model, sampled):
    """The step program body of one variant (the port of the
    reference's ``_make_step_fn`` at ``spec_k = 0``): the flat ragged
    step over a packed batch, then each row's token from its scored
    position — the raw argmax (``sampled`` False: no sampling
    arithmetic) or the accept rule with position-keyed noise.

    ``step(params, kv, no_draft, b, out)`` reads only tensors: the
    params, ``kv`` (the pools and their scales, and ``w_scales``, as
    ``decode_flat`` keywords; written in place), the empty draft inputs
    and the batch views ``b`` of :class:`_StepBuffers`; it writes the
    tokens and the accepted counts into ``out [S, 2]`` int32. It reads
    nothing back to the host and its shapes depend on the rung alone,
    so on CUDA it is captured as it is."""
    def step(params, kv, no_draft, b, out):
        logits = model.decode_flat(
            params, b["tokens"], b["positions"], b["seq_ids"], b["valid"],
            block_tables=b["tables"], **kv)
        win = logits[b["win_idx"].long()][:, None, :]       # [S, 1, V]
        d_toks, d_probs, n_draft = no_draft
        if not sampled:
            toks, n_acc = spec_accept_greedy(win, d_toks, n_draft)
        else:
            ctr = b["counters"][:, None]
            seeds = b["seeds"][:, None]
            toks, n_acc = spec_accept(
                win, d_toks, d_probs, n_draft, b["temperature"],
                b["top_k"], b["top_p"],
                row_keys(seeds[:, :0], ctr[:, :0], TAG_ACCEPT),
                row_keys(seeds, ctr, TAG_SAMPLE))
        out[:, :1].copy_(toks)
        out[:, 1].copy_(n_acc)
    return step


class _StepProgram:
    """The step at one (packed length, table width, greedy|sampled)
    rung: the rung's static batch (its :class:`_StepBuffers`, shared by
    both variants of the rung), its static output and, once
    :meth:`capture` ran, the CUDA graph of the step over them.

    :meth:`run`: one host-to-device copy of the batch, then one graph
    replay (the CPU: the step function, eagerly), then ONE
    device-to-host copy of the tokens, the step's only synchronisation.
    The copies stay outside the graph: the graph reads only device
    memory, and the pinned buffer is the host's to fill between steps."""

    def __init__(self, rung, step, args, bufs, S, device):
        self.rung = rung
        self.bufs = bufs
        self.device = device
        out = torch.zeros((S, 2), dtype=torch.int32, device=device)
        self._out = out
        self._host_out = out if device.type == "cpu" else torch.zeros(
            (S, 2), dtype=torch.int32).pin_memory()
        self.fn = lambda: step(*args, bufs.device_views, out)
        self.graph = None
        self.runs = 0
        self.replays = 0

    def __str__(self):
        t, mb, sampled = self.rung
        return f"t{t}mb{mb}_{'sampled' if sampled else 'greedy'}"

    def capture(self, stream, pool):
        """Capture the step into a CUDA graph on the engine's side
        ``stream`` in its ``pool``; raises naming the rung when the
        capture fails."""
        self.graph = kernels.capture(self.fn, stream, pool,
                                     what=f"the step rung {self}")

    def run(self):
        """Returns host arrays (tokens [S, 1], n_accepted [S])."""
        self.bufs.upload()
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
        elif self.device.type == "cpu":
            self.fn()
        else:
            raise RuntimeError(f"step rung {self} has no captured graph")
        self.runs += 1
        if self._host_out is not self._out:
            self._host_out.copy_(self._out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        both = self._host_out.numpy().copy()
        return both[:, :1], both[:, 1]


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
    """

    def __init__(self, model, params, max_seqs=None, block_size=None,
                 num_blocks=None, max_context=None, prefill_chunk=None,
                 draft_model=None, draft_params=None, spec_k=None,
                 stats=None, dtype="float32", breaker=None,
                 prefix_cache=None, kv_dtype=None, adapter_bank=None,
                 mesh=None, weight_dtype=None, weight_calib=None,
                 draft_weight_dtype=None, device="cuda"):
        deferred = dict(draft_model=draft_model, draft_params=draft_params,
                        spec_k=spec_k,
                        draft_weight_dtype=draft_weight_dtype,
                        adapter_bank=adapter_bank, mesh=mesh)
        for arg, value in deferred.items():
            if value is not None and not (arg == "spec_k" and value == 0):
                raise NotImplementedError(
                    f"{arg}=: {_DEFERRED[arg]} is not ported to the "
                    f"PyTorch engine yet (ROADMAP.md, section 1)")
        if _dtype_name(dtype) not in _POOL_DTYPES:
            raise ValueError(
                f"dtype={dtype!r}: the KV pools take "
                f"{', '.join(_POOL_DTYPES)} (or int8/fp8 through "
                f"kv_dtype)")
        self.device = resolve_device(device)
        if getattr(model, "device", self.device) != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
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
        self.spec_k = 0
        self.q_tokens = self.prefill_chunk
        # packed-length ladder: all-rows decode, the EXACT lengths of
        # the commonest mixed steps (one or two rows mid-prefill while
        # the rest decode, so those dispatch pad-free), full prefill;
        # table-width ladder: half and full table
        t_lo = self.max_seqs
        t_hi = max(t_lo, self.max_seqs * self.q_tokens)
        mids = {min(t_hi, i * self.q_tokens + (self.max_seqs - i))
                for i in (1, 2) if i <= self.max_seqs}
        self._t_buckets = sorted({t_lo, t_hi} | mids)
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
        if self.prefix_enabled:
            self.cache.on_prefix_evict = self._on_prefix_evict
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefill_tokens_saved = 0
        qw = self._resolve_weight_input(params, weight_dtype,
                                        weight_calib)
        if qw is None:
            self.params = params_from_numpy(params, self.device)
            self.w_scales = None
            leaves = list(flatten_params(self.params).values())
            self.weight_dtype = "float32"
            self.weight_bytes = int(sum(a.numel() * a.element_size()
                                        for a in leaves))
            self.weight_params = int(sum(a.numel() for a in leaves))
        else:
            qw = params_from_numpy(qw, self.device)
            self.params, self.w_scales = qw.params, qw.scales
            self.weight_dtype = qw.dtype
            self.weight_bytes = qw.nbytes()
            self.weight_params = qw.num_params()
        if self._stats is not None:
            self._stats.record_weight_quant(
                self.weight_dtype, self.weight_bytes, self.weight_params)
        S, V = self.max_seqs, model.vocab_size
        # the accept rule's draft inputs: empty (no draft model), built
        # once
        self._no_draft = (
            torch.zeros((S, 0), dtype=torch.int32, device=self.device),
            torch.zeros((S, 0, V), dtype=torch.float32,
                        device=self.device),
            torch.zeros(S, dtype=torch.int64, device=self.device))
        # every rung's buffers now: a pinned allocation must never run
        # inside a capture
        self._bufs = {(t, mb): _StepBuffers(t, mb, S, self.device)
                      for t in self._t_buckets for mb in self._mb_widths}
        self._kv = {"k_pages": self.cache.k_pages,
                    "v_pages": self.cache.v_pages}
        if self.quantized:
            self._kv.update(k_scales=self.cache.k_scales,
                            v_scales=self.cache.v_scales)
        if self.w_scales is not None:
            self._kv["w_scales"] = self.w_scales
        self._programs = {}
        # one graph memory pool and one capture stream an engine, made
        # at its first capture
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

    def _resolve_weight_input(self, params, weight_dtype, weight_calib):
        """A quantized checkpoint (the port's or the JAX package's
        ``QuantizedWeights``) passes through; a f32 tree is quantized
        here when ``weight_dtype`` (or ``MXNET_TPU_LLM_WEIGHT_DTYPE``)
        asks; ``None`` = full precision."""
        if all(hasattr(params, a) for a in ("params", "scales", "dtype")):
            return params
        req = weight_dtype if weight_dtype is not None \
            else _env_str("MXNET_TPU_LLM_WEIGHT_DTYPE", "")
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
            step = _make_step_fn(self.model, sampled)
            prog = _StepProgram(key, step,
                                (self.params, self._kv, self._no_draft),
                                self._bufs[(t, mb)], self.max_seqs,
                                self.device)
            self._programs[key] = prog
        if prog.graph is None and self.device.type == "cuda":
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._capture_stream = torch.cuda.Stream(self.device)
            t0 = time.monotonic()
            prog.bufs.upload()
            prog.capture(self._capture_stream, self._graph_pool)
            self.capture_seconds += time.monotonic() - t0
        return prog

    def release_graphs(self):
        """Drop every captured graph and the engine's graph memory pool
        (the server does it at shutdown); a later step captures its
        rung again, counted as a compile."""
        for prog in self._programs.values():
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
        """The step programs, as the reference's statusz reports them:
        the ladders, the step variants built (one per rung reached;
        each a captured graph on CUDA), the graphs held, the replays and
        the dispatches (every step program run), and the seconds spent
        capturing."""
        progs = self._programs.values()
        return {"t_buckets": list(self._t_buckets),
                "mb_widths": list(self._mb_widths),
                "step_variants": len(self._programs),
                "graphs": sum(p.graph is not None for p in progs),
                "replays": sum(p.replays for p in progs),
                "dispatches": sum(p.runs for p in progs),
                "capture_seconds": self.capture_seconds}

    # ------------------------------------------------ prefix caching --
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
            seq.prefix_hashes = prefix_block_hashes(seq.prompt, bs)
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
            hashes = prefix_block_hashes(tokens[:n_full * bs], bs)
            seq.prefix_hashes = hashes
        for k in range(n_full):
            self.cache.register(hashes[k], seq.block_ids[k])

    def _cow_block(self, seq, bi):
        """Copy-on-write block ``seq.block_ids[bi]``: allocate a private
        copy, copy the page row in every pool in place, repoint the
        sequence's table and drop one reference on the shared
        original."""
        old = seq.block_ids[bi]
        new = self.cache.allocator.alloc(1)[0]
        try:
            self.cache.copy_block(old, new)
        except BaseException:
            # the private block is in no table yet: nothing else frees it
            self.cache.allocator.free([new])
            raise
        seq.block_ids[bi] = new
        self.cache.allocator.free([old])
        self.cache.cow_count += 1

    # ------------------------------------------------------- warmup --
    def warmup(self):
        """Build the step program of every (packed length, table width,
        greedy|sampled) rung steady state can reach — on CUDA, capture
        its graph, whose warm run builds and loads every kernel it
        launches — and run it once; then the copy-on-write once. After
        this no traffic the ladders cover builds or captures anything.
        Returns {rung: seconds}."""
        timings = {}
        for T in self._t_buckets:
            for MB in self._mb_widths:
                bufs = self._bufs[(T, MB)]
                bufs.valid.fill(0)
                bufs.tables.fill(NULL_BLOCK)
                for sampled in (False, True):
                    t0 = time.monotonic()
                    prog = self._program(T, MB, sampled)
                    prog.run()
                    timings[f"step_{prog}"] = time.monotonic() - t0
        if self.prefix_enabled:
            t0 = time.monotonic()
            self.cache.copy_block(NULL_BLOCK, NULL_BLOCK)
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
        if seq.adapter is not None:
            raise NotImplementedError(
                f"adapter={seq.adapter!r}: {_DEFERRED['adapter_bank']} "
                f"is not ported to the PyTorch engine yet (ROADMAP.md, "
                f"section 1)")
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
            seq.cache_hit_tokens = hit_tokens
            if self.prefix_enabled:
                self.prefix_lookups += 1
                if hit_tokens > 0:
                    self.prefix_hits += 1
                    self.prefill_tokens_saved += hit_tokens
                if self._stats:
                    self._stats.record_prefix_lookup(hit_tokens)
            events.append(("admitted", seq))

    def _finish(self, seq, events):
        self._register_blocks(seq)
        self.cache.allocator.free(seq.block_ids)
        seq.block_ids = []
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
            self.scheduler.release(seq, EVICTED, reason)
            self._dead_pending.append((seq, reason))
            events.append(("expired", seq))

    # ----------------------------------------------------- planning --
    def _plan(self, seq):
        """This step's work for one running sequence: its next prompt
        chunk while the prompt is being written (preemption folds the
        generation into the prompt, so an empty generation list means
        "prompt not complete"), else its one decode token."""
        if not seq.generated:
            committed = seq.prompt
            cl = len(committed)
            ntok = min(self.prefill_chunk, cl - seq.seq_len)
            return {"kind": "prefill",
                    "tokens": committed[seq.seq_len:seq.seq_len + ntok],
                    "ntok": ntok, "cl": cl,
                    "emit": seq.seq_len + ntok == cl}
        return {"kind": "decode", "tokens": [seq.last_token], "ntok": 1,
                "cl": len(seq.prompt) + len(seq.generated),
                "emit": True}

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

    # ------------------------------------------------- the one step --
    def _build_batch(self, rows, plans, t, mb):
        """Fill the rung's host buffers. ``valid`` is reset EVERY
        dispatch — a stale valid flag would scatter garbage K/V through
        a stale (seq_id, position, table) combination into blocks
        another sequence may own now; everything else stale is masked
        or discarded."""
        b = self._bufs[(t, mb)]
        b.valid.fill(0)
        off = 0
        for seq in rows:
            plan = plans[seq]
            i, n = seq.slot, len(plan["tokens"])
            b.tokens[off:off + n] = plan["tokens"]
            b.positions[off:off + n] = seq.seq_len + self._arange[:n]
            b.seq_ids[off:off + n] = i
            b.valid[off:off + n] = 1
            # the scored position is this row's last token
            b.win_idx[i] = off + n - 1
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
            off += n
        return b

    def _dispatch(self, rows, plans):
        """ONE step for ``rows`` (slots not in ``rows`` ride along
        inactive on the null block). Failures propagate to the isolation
        logic in :meth:`step`."""
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

    def _commit(self, rows, plans, toks, events):
        """Apply one successful dispatch's results to host state.
        Returns the number of committed decode tokens (the throughput
        numerator; chunk-emitted first tokens count as prefill)."""
        decoded = 0
        for seq in rows:
            plan = plans[seq]
            tok = int(toks[seq.slot, 0])
            if plan["kind"] == "prefill":
                seq.seq_len += plan["ntok"]
                if self._stats:
                    self._stats.record_prefill_chunk(plan["ntok"])
                if not plan["emit"]:
                    continue
                # the prompt completed: register its full immutable
                # blocks, then commit the first generated token (from
                # this chunk's last position)
                self._register_blocks(seq)
                seq.generated.append(tok)
                seq.last_token = tok
                events.append(("token", seq))
                if self._stats:
                    self._stats.record_prefill(
                        plan["cl"] - seq.cache_hit_tokens)
                    self._stats.record_prefill_token()
                if seq.t_first_token is None:
                    seq.t_first_token = time.monotonic()
                    if self._stats:
                        self._stats.record_first_token(
                            seq.t_first_token - seq.t_submit)
                if seq.done or seq.seq_len + 1 >= self.max_context:
                    self._finish(seq, events)
                continue
            seq.generated.append(tok)
            seq.last_token = tok
            events.append(("token", seq))
            seq.seq_len += 1
            decoded += 1
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
                toks, _ = self._dispatch(rows, plans)
            except Exception as exc:
                self._poison(rows[0], exc, events)
                return 0
            self._record_breaker(rows, plans, True)
            return self._commit(rows, plans, toks, events)
        decoded = 0
        mid = len(rows) // 2
        for half in (rows[:mid], rows[mid:]):
            try:
                toks, _ = self._dispatch(half, plans)
            except Exception:
                decoded += self._isolate(half, plans, events)
            else:
                self._record_breaker(half, plans, True)
                decoded += self._commit(half, plans, toks, events)
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
        t0 = time.monotonic()
        try:
            toks, _ = self._dispatch(rows, plans)
        except Exception:
            self._record_breaker(rows, plans, False)
            decoded = self._isolate(rows, plans, events)
        else:
            self._record_breaker(rows, plans, True)
            decoded = self._commit(rows, plans, toks, events)
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
            self.scheduler.release(seq, EVICTED, reason)
            out.append(seq)
        while self.scheduler.waiting:
            seq = self.scheduler.waiting.popleft()
            self.scheduler.release(seq, EVICTED, reason)
            out.append(seq)
        self._record_block_gauges()
        return out

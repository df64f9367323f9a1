"""Ragged paged attention (the port of
``mxnet_tpu/ops/ragged_attention.py``).

Query tokens attend over a paged KV pool ``[N, bs, H, D]`` through
per-sequence block tables ``[S, MB]`` (int32 page ids, unused entries
pointing at the null block 0). Pages are f32, bf16 or f16 (the TPU
kernels cast any float page to f32 in the kernel; so do these), or, in
the flat shape, int8/fp8 with scales. ``q`` is f32, bf16 or f16 over
any of them (the TPU kernels cast q to f32 too), and the output takes
``q``'s dtype. K and V float pages may differ in dtype: the wrappers
widen both to f32 for the kernel, which is exact (the kernels read every
page element as f32) and costs one copy of a pool; the serving path's
pools are always alike. Three shapes,
one kernel template (``csrc/paged_ring.cuh``, built from
``csrc/ragged_flat.cu`` for f32/int8/fp8 pages and
``csrc/ragged_flat_lp.cu`` for bf16/f16 pages):

- flat: a packed ``[T, H, D]`` batch; token ``t`` belongs to row
  ``seq_ids[t]`` and sits at absolute position ``positions[t]``,
  attending causally over positions ``<= positions[t]``. With
  ``k_scales``/``v_scales`` ``[N, bs, H]`` f32 the pages are int8 or
  fp8-e4m3 and are dequantised per slot and head.
  :func:`ragged_flat_attention` (kernel ``flat_attention``, the port of
  ``_flat_kernel``, ``flat_attention.bf16`` / ``.f16`` over 16-bit
  pages; quantised pages ``flat_attention_quant.int8`` / ``.fp8``, the
  port of ``_flat_quant_kernel``) and its plain version
  :func:`ragged_flat_attention_reference`.
- decode: ``q [S, H, D]``, one query per row over its ``kv_lens[i]``
  valid tokens. :func:`ragged_paged_attention` with a 3-D ``q`` (kernel
  ``decode_attention``, the port of ``_decode_kernel``); plain version
  :func:`ragged_attention_reference`.
- chunk: ``q [S, Q, H, D]`` with ``q_lens [S]``; token ``t`` of row
  ``i`` sits at ``kv_lens[i] - q_lens[i] + t`` and attends causally up
  to there (chunked prefill, decode as Q=1, speculative verify).
  :func:`ragged_paged_attention` with a 4-D ``q`` (kernel
  ``chunk_attention``, the port of ``_chunk_kernel``); plain version
  :func:`ragged_chunk_attention_reference`.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. The kernels take every head dim from 1 to 256. All four are
one staged kernel (``paged_ring_kernel``): a query tile of up to 16
tokens of one table row reads each page once through shared memory, and
a row's pages are split over a thread-block cluster, by the launch plan
of :func:`paged_plan` (:func:`flat_plan` for the flat shape, whose tiles
the kernel cuts from the pack's runs of consecutive tokens);
:func:`page_shares` is the split the kernel makes.
Each launch counts under its kernel's name in
:func:`mxnet_tpu_torch.kernels.launch_counts` (:func:`kernel_name`; the
16-bit chunk and decode kernels' names end in ``.bf16`` or ``.f16``).
``ragged_paged_attention`` is also the registered op
``nd.ragged_paged_attention`` (non-differentiable, as in the JAX
package).

Outputs with no contract, discarded by callers as on the TPU: tokens
whose table row is padding (flat), padded chunk tokens (``t >=
q_lens[i]``) and rows with ``q_lens[i] == 0``, and rows with
``kv_lens[i] == 0`` (the decode kernel gives 0 there, the plain version
the mean of ``v``). Data past ``kv_lens[i]`` and in the null block never
reaches a valid output.
"""
from __future__ import annotations

import functools

import torch

from .. import kernels
from .flash_attention import _NEG_INF
from .registry import register

__all__ = ["ragged_flat_attention", "ragged_flat_attention_reference",
           "ragged_paged_attention", "ragged_attention_reference",
           "ragged_chunk_attention_reference", "gather_rows",
           "kernel_name", "paged_plan", "flat_plan", "flat_subs",
           "page_shares", "live_pages", "ring_smem_bytes", "CHUNK_KERNEL",
           "DECODE_KERNEL"]

# launch-counter names of the chunk (K4) and decode (K5) kernels over
# f32 pages
CHUNK_KERNEL = "chunk_attention"
DECODE_KERNEL = "decode_attention"

# page dtype -> (library, C entry point, launch-counter name) of the flat
# kernel
_KERNELS = {
    torch.float32: ("ragged_flat", "mxt_ragged_flat_f32", "flat_attention"),
    torch.int8: ("ragged_flat", "mxt_ragged_flat_int8",
                 "flat_attention_quant.int8"),
    torch.float8_e4m3fn: ("ragged_flat", "mxt_ragged_flat_fp8",
                          "flat_attention_quant.fp8"),
}
# the 16-bit page dtypes and their entry-point and counter suffixes: the
# flat, chunk and decode kernels of csrc/ragged_flat_lp.cu
_LOWP = {torch.bfloat16: "bf16", torch.float16: "f16"}
_KERNELS.update({dt: ("ragged_flat_lp", f"mxt_ragged_flat_{sfx}",
                       f"flat_attention.{sfx}")
                  for dt, sfx in _LOWP.items()})
_QUANT = (torch.int8, torch.float8_e4m3fn)
# the float page dtypes the chunk and decode kernels take
_FLOAT_PAGES = (torch.float32,) + tuple(_LOWP)
# q's dtype -> the kernels' q_dtype code (q and the output)
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def kernel_name(page_dtype, shape="flat"):
    """Launch-counter name of the ``shape`` ("flat", "chunk" or
    "decode") kernel for pages of ``page_dtype``."""
    if shape == "flat":
        return _KERNELS[page_dtype][2]
    base = CHUNK_KERNEL if shape == "chunk" else DECODE_KERNEL
    return base if page_dtype == torch.float32 else \
        f"{base}.{_LOWP[page_dtype]}"


MAX_HEAD_DIM = 256
# the staged kernel (csrc/paged_ring.cuh paged_ring_kernel): query
# tokens per CTA, warps per CTA, most heads per CTA, ring stages, the
# CTAs one launch should put on the card's 132 SMs (a CTA's page walk is
# a chain of dependent steps, so the card wants many short walks in
# flight: 8 an SM), the largest cluster (the portable size), the largest
# stage of sub-walk pages; shared memory that lets two or three CTAs
# share an SM (228 KB an SM, 1 KB reserved per CTA) and the most one CTA
# may take
_Q_TILE = 16
_RING_WARPS = 8
_MAX_HEADS = 4
_MAX_STAGES = 4
_SMS = 132
_TARGET_CTAS = 8 * _SMS
_MAX_SPLITS = 8
_MAX_STAGE = 32 * 1024
_TWO_PER_SM = 228 * 1024 // 2 - 1024
_THREE_PER_SM = 228 * 1024 // 3 - 1024
_MAX_SMEM = 232448
# the most (sub-walk, pair) states a CTA takes (the kernel's launch check)
_MAX_STATES = 64


def _a16(n):
    return -(-n // 16) * 16


def ring_smem_bytes(bs, heads, D, page_dtype, qt, stages, MB, subs=1):
    """``(stage bytes, shared bytes per CTA)`` of the staged kernel
    (``RingLayout`` in ``csrc/paged_ring.cuh``): a stage holds one page
    per sub-walk, each page's K and V for ``heads`` heads (and, for
    int8/fp8 pages, both ``[bs, heads]`` f32 scale tiles; bf16/f16 pages
    take 2 bytes an element and no scales); the CTA adds
    its q tile, the (m, l, acc) of each of the ``subs`` sub-walks of its
    ``qt * heads`` (token, head) pairs and its share's page ids (at most
    ``MB``)."""
    elem = page_dtype.itemsize
    pairs = qt * heads
    sc = _a16(bs * heads * 4) if page_dtype in _QUANT else 0
    stage = subs * (2 * _a16(bs * heads * D * elem) + 2 * sc)
    state = _a16(4 * (pairs * D * (1 + subs) + 2 * subs * pairs + MB))
    return stage, state + stages * stage


@functools.lru_cache(maxsize=256)
def paged_plan(rows, Q, H, D, bs, MB, page_dtype):
    """The staged kernel's launch plan: ``(heads per CTA, splits, stages,
    subs)``. ``rows`` query rows of ``Q`` tokens each (packed tokens:
    ``Q = 1``); a CTA takes up to 16 tokens of a row and ``heads`` heads,
    ``pairs = tokens x heads`` (token, head) pairs.

    - heads: the largest divisor of ``H`` up to 4 that keeps a CTA at
      <= 16 pairs (one head for a 16-token chunk) and two or more ring
      stages within the shared memory that lets two CTAs share an SM;
    - splits: 1 when the CTAs already number 8 x 132, else enough for
      that, at most 8 (one cluster) and at most ``MB``;
    - subs: where even 8 splits leave fewer CTAs than that, each pair
      gets up to ``8 // pairs`` warps (sub-walks, each taking every
      subs-th page of the share), as long as a stage of ``subs`` pages
      stays within 32 KB;
    - stages: as many, up to 4, as that memory holds; in a launch of
      more CTAs than two an SM take at once, as many as the memory that
      lets three CTAs share an SM holds, where two or more fit (each
      CTA's page walk waits on its own chain of steps, so more walks an
      SM beat a deeper ring: K5 at 64 rows of f32 pages).

    Raises ``ValueError`` when one head of a page does not fit."""
    qt = min(Q, _Q_TILE)

    def stages_for(heads, subs, budget):
        return next((n for n in range(_MAX_STAGES, 1, -1)
                     if ring_smem_bytes(bs, heads, D, page_dtype, qt, n, MB,
                                        subs)[1] <= budget), None)
    heads = next((h for h in range(min(H, _MAX_HEADS), 0, -1)
                  if H % h == 0 and (h == 1 or qt * h <= _Q_TILE)
                  and stages_for(h, 1, _TWO_PER_SM)), None)
    if heads is None:
        if stages_for(1, 1, _MAX_SMEM) is None:
            raise ValueError(
                f"block_size {bs} x head_dim {D}: two pages of one head "
                f"do not fit the paged kernel's shared memory")
        return 1, min(_MAX_SPLITS, MB), 2, 1
    ctas = rows * -(-Q // _Q_TILE) * (H // heads)
    splits = 1 if ctas >= _TARGET_CTAS else min(
        _MAX_SPLITS, MB, -(-_TARGET_CTAS // ctas))
    subs = 1
    if ctas * splits < _TARGET_CTAS:
        page = ring_smem_bytes(bs, heads, D, page_dtype, qt, 1, MB)[0]
        subs = next(n for n in range(max(1, _RING_WARPS // (qt * heads)),
                                     0, -1)
                    if n == 1 or (n * page <= _MAX_STAGE
                                  and stages_for(heads, n, _TWO_PER_SM)))
    budget = _TWO_PER_SM
    if ctas * splits > 2 * _SMS and stages_for(heads, subs, _THREE_PER_SM):
        budget = _THREE_PER_SM
    return heads, splits, stages_for(heads, subs, budget), subs


def flat_plan(T, S, H, D, bs, MB, page_dtype, pack_independent=True):
    """The flat kernel's launch plan for ``T`` packed tokens over ``S``
    table rows: ``(qt, heads, splits, stages, subs)``.

    The kernel cuts the pack into slots of ``qt`` tokens and each slot
    into tiles at the starts of its runs (consecutive tokens of one
    ``seq_id``; a tile reads the pages up to its largest position once,
    each token masking by its own); the host cannot see the runs without
    a sync, so ``qt`` is the pack's mean tokens per row, at most 16: 1
    for a decode step (``T <= S``), 16 for a prefill pack of 16-token
    chunks.

    ``pack_independent=False``: the rest is :func:`paged_plan` sized for
    ``ceil(T / qt)`` tiles of ``qt`` tokens, and the kernel gives each
    cluster rank a contiguous share of a row's live pages. Splits,
    sub-walks and shares then follow the pack, and so do a row's bits.

    ``pack_independent=True`` (a draft writes its KV into prefix blocks
    other sequences share): the kernel deals the live pages to the
    cluster's ranks in turn (:func:`page_shares` with ``dealt``), so a
    token's arithmetic depends only on ``splits`` and ``subs``, and
    those are fixed for the page geometry whatever ``T``: 8 splits, and
    the sub-walks a one-token tile takes (:func:`flat_subs`); ``heads``
    and ``stages`` are sized for ``ceil(T / qt)`` tiles as
    :func:`paged_plan` sizes them."""
    qt = min(_Q_TILE, max(1, -(-T // max(S, 1))))
    if not pack_independent:
        return (qt,) + paged_plan(-(-T // qt), qt, H, D, bs, MB, page_dtype)
    subs = flat_subs(H, D, bs, MB, page_dtype)

    def stages_for(heads, budget):
        return next((n for n in range(_MAX_STAGES, 1, -1)
                     if ring_smem_bytes(bs, heads, D, page_dtype, qt, n, MB,
                                        subs)[1] <= budget), None)
    heads = next((h for h in range(min(H, _MAX_HEADS), 0, -1)
                  if H % h == 0 and (h == 1 or qt * h <= _Q_TILE)
                  and stages_for(h, _TWO_PER_SM)), None)
    if heads is None:
        if stages_for(1, _MAX_SMEM) is None:
            raise ValueError(
                f"block_size {bs} x head_dim {D}: two pages of one head "
                f"do not fit the paged kernel's shared memory")
        return qt, 1, _MAX_SPLITS, 2, subs
    ctas = -(-T // qt) * (H // heads)
    budget = _TWO_PER_SM
    if ctas * _MAX_SPLITS > 2 * _SMS and stages_for(heads, _THREE_PER_SM):
        budget = _THREE_PER_SM
    return qt, heads, _MAX_SPLITS, stages_for(heads, budget), subs


@functools.lru_cache(maxsize=256)
def flat_subs(H, D, bs, MB, page_dtype):
    """The flat kernel's sub-walks a pair, for any pack: those of a
    one-token tile (the decode step, where the CTA holds fewest pairs),
    as :func:`paged_plan` gives a launch too small to fill the card, at
    most 4 (so that 16-token tiles keep 64 or fewer (sub-walk, pair)
    states)."""
    subs = paged_plan(1, 1, H, D, bs, MB, page_dtype)[3]
    return min(subs, _MAX_STATES // _Q_TILE)


def live_pages(horizon, bs, MB):
    """Pages of a row a token at causal ``horizon`` reads: those holding
    a position ``<= horizon``, within the row's ``MB`` table entries."""
    return 0 if horizon < 0 else min(MB, horizon // bs + 1)


def page_shares(n_pages, splits, dealt=False):
    """The kernel's kv split: the page indices of each cluster rank.
    Contiguous shares of ``ceil(n_pages / splits)`` pages (the last ones
    shorter or empty); ``dealt`` (the flat kernel's pack-independent
    plan): ``[r, r + splits, r + 2 splits, ...]`` below ``n_pages``,
    dealt in turn, so rank ``r`` reads the same pages, in the same
    order, for any count of live pages past them."""
    if dealt:
        return [list(range(r, n_pages, splits)) for r in range(splits)]
    share = -(-n_pages // splits)
    return [list(range(min(n_pages, r * share),
                       min(n_pages, (r + 1) * share)))
            for r in range(splits)]


def _check_head_dim(D):
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"paged attention kernels take head_dim 1 to "
                         f"{MAX_HEAD_DIM}, got {D}")


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
               scale, k_scales, v_scales, pack_independent):
    T, H, D = q.shape
    N, bs = k_pages.shape[0], k_pages.shape[1]
    S, MB = block_tables.shape
    dev = q.device
    quant = k_scales is not None
    _check_head_dim(D)
    if not quant:
        k_pages, v_pages = _alike(k_pages, v_pages)
    lib, fn, counter = _KERNELS.get(k_pages.dtype, (None, None, None))
    if fn is None or (k_pages.dtype in _QUANT) != quant:
        raise TypeError(f"unsupported page dtype {k_pages.dtype} "
                        f"({'with' if quant else 'without'} scales)")
    req = kernels.require
    req(q, "q", q.dtype, (T, H, D), dev)
    req(k_pages, "k_pages", k_pages.dtype, (N, bs, H, D), dev)
    req(v_pages, "v_pages", k_pages.dtype, (N, bs, H, D), dev)
    req(block_tables, "block_tables", torch.int32, (S, MB), dev)
    req(seq_ids, "seq_ids", torch.int32, (T,), dev)
    req(positions, "positions", torch.int32, (T,), dev)
    if quant:
        req(k_scales, "k_scales", torch.float32, (N, bs, H), dev)
        req(v_scales, "v_scales", torch.float32, (N, bs, H), dev)
    out = torch.empty((T, H, D), dtype=q.dtype, device=dev)
    if T == 0:
        return out
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    if quant:
        ptrs += [k_scales.data_ptr(), v_scales.data_ptr()]
    ptrs += [block_tables.data_ptr(), seq_ids.data_ptr(),
             positions.data_ptr(), out.data_ptr()]
    rc = getattr(kernels.library(lib), fn)(
        *ptrs, T, H, D, bs, N, S, MB,
        *flat_plan(T, S, H, D, bs, MB, k_pages.dtype, pack_independent),
        int(pack_independent), _Q_DTYPES[q.dtype], float(scale),
        kernels.stream_handle(dev))
    kernels.check(rc, fn)
    kernels.count_launch(counter)
    return out


def ragged_flat_attention(q, k_pages, v_pages, block_tables, seq_ids,
                          positions, scale=None, k_scales=None,
                          v_scales=None, pack_independent=True):
    """Flat ragged paged attention. CPU tensors take the plain version;
    CUDA tensors launch the kernel (int32 tables/ids/positions, ``q``
    f32, bf16 or f16, contiguous; float pages of any two of f32, bf16
    and f16, or int8/fp8 pages, K and V alike, with scales) or raise.
    ``pack_independent``: the kernel's plan (:func:`flat_plan`); with
    it a token's output has the same bits whatever else is packed
    beside it, without it the plan follows the pack, for speed."""
    if scale is None:
        scale = float(1.0 / (q.shape[-1] ** 0.5))
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales or neither")
    _check_q_dtype(q)
    if q.device.type == "cpu":
        return ragged_flat_attention_reference(
            q, k_pages, v_pages, block_tables, seq_ids, positions, scale,
            k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no flat attention kernel for {q.device}")
    return _flat_cuda(q, k_pages, v_pages, block_tables, seq_ids,
                      positions, scale, k_scales, v_scales,
                      pack_independent)


def _gather_pages(pages, block_tables):
    """``pages[block_tables]`` as ``[S, MB * bs, H, D]`` f32."""
    S, MB = block_tables.shape
    g = pages[block_tables.long()].float()
    return g.reshape(S, MB * pages.shape[1], *pages.shape[2:])


def ragged_attention_reference(q, k_pages, v_pages, block_tables, kv_lens,
                               scale=None):
    """Gather-based plain version of the decode shape: ``q [S, H, D]``,
    pages ``[N, bs, H, D]``, ``block_tables [S, MB]``, ``kv_lens [S]``;
    row ``i`` attends over positions ``< kv_lens[i]``."""
    D = q.shape[-1]
    s = scale if scale is not None else float(1.0 / (D ** 0.5))
    k = _gather_pages(k_pages, block_tables)
    v = _gather_pages(v_pages, block_tables)
    logits = torch.einsum("shd,skhd->shk", q.float(), k) * s
    pos = torch.arange(k.shape[1], dtype=torch.int64, device=q.device)
    mask = pos[None, None, :] < kv_lens.long()[:, None, None]
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("shk,skhd->shd", probs, v)
    return out.to(q.dtype)


def ragged_chunk_attention_reference(q, k_pages, v_pages, block_tables,
                                     kv_lens, q_lens, scale=None):
    """Gather-based plain version of the chunk shape: ``q [S, Q, H, D]``,
    ``kv_lens``/``q_lens [S]``; token ``t`` of row ``i`` attends over
    positions ``<= kv_lens[i] - q_lens[i] + t``."""
    Q, D = q.shape[1], q.shape[-1]
    s = scale if scale is not None else float(1.0 / (D ** 0.5))
    k = _gather_pages(k_pages, block_tables)
    v = _gather_pages(v_pages, block_tables)
    logits = torch.einsum("sqhd,skhd->shqk", q.float(), k) * s
    pos = torch.arange(k.shape[1], dtype=torch.int64, device=q.device)
    qpos = (kv_lens.long()[:, None] - q_lens.long()[:, None]
            + torch.arange(Q, dtype=torch.int64, device=q.device)[None, :])
    mask = pos[None, None, None, :] <= qpos[:, None, :, None]
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("shqk,skhd->sqhd", probs, v)
    return out.to(q.dtype)


def _check_q_dtype(q):
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"q has dtype {q.dtype}: the paged attention "
                        f"kernels take float32, bfloat16 or float16 q")


def _alike(k_pages, v_pages):
    """K and V float pools in one dtype, as the kernels take them: two
    of f32, bf16 and f16 both widened to f32 (exact: the kernels read
    every page element as f32); any other pair as it is, for the
    kernels' checks to refuse."""
    pair = {k_pages.dtype, v_pages.dtype}
    if len(pair) == 1 or not pair <= set(_FLOAT_PAGES):
        return k_pages, v_pages
    return k_pages.float(), v_pages.float()


def _paged_cuda(q, k_pages, v_pages, block_tables, kv_lens, q_lens, scale):
    chunked = q.dim() == 4
    S, MB = block_tables.shape
    Q = q.shape[1] if chunked else 1
    H, D = q.shape[-2:]
    N, bs = k_pages.shape[0], k_pages.shape[1]
    k_pages, v_pages = _alike(k_pages, v_pages)
    dt = k_pages.dtype
    dev = q.device
    _check_head_dim(D)
    req = kernels.require
    req(q, "q", q.dtype, (S, Q, H, D) if chunked else (S, H, D), dev)
    req(k_pages, "k_pages", dt, (N, bs, H, D), dev)
    req(v_pages, "v_pages", dt, (N, bs, H, D), dev)
    req(block_tables, "block_tables", torch.int32, (S, MB), dev)
    req(kv_lens, "kv_lens", torch.int32, (S,), dev)
    if chunked:
        req(q_lens, "q_lens", torch.int32, (S,), dev)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = kernels.library("ragged_flat" if dt == torch.float32
                          else "ragged_flat_lp")
    sfx = _LOWP.get(dt, "f32")
    plan = paged_plan(S, Q, H, D, bs, MB, dt)
    tail = (*plan, _Q_DTYPES[q.dtype], float(scale),
            kernels.stream_handle(dev))
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), kv_lens.data_ptr()]
    if chunked:
        fn, counter = f"mxt_ragged_chunk_{sfx}", kernel_name(dt, "chunk")
        rc = getattr(lib, fn)(*ptrs, q_lens.data_ptr(), out.data_ptr(), S,
                              Q, H, D, bs, N, MB, *tail)
    else:
        fn, counter = f"mxt_ragged_decode_{sfx}", kernel_name(dt, "decode")
        rc = getattr(lib, fn)(*ptrs, out.data_ptr(), S, H, D, bs, N, MB,
                              *tail)
    kernels.check(rc, fn)
    kernels.count_launch(counter)
    return out


def ragged_paged_attention(q, k_pages, v_pages, block_tables, kv_lens,
                           q_lens=None, scale=None):
    """Paged attention, decode and chunk shapes.

    ``q [S, H, D]``: one query per row over its ``kv_lens[i]`` valid
    tokens (the decode kernel). ``q [S, Q, H, D]`` with ``q_lens [S]``:
    up to Q query tokens per row, token ``t`` at absolute position
    ``kv_lens[i] - q_lens[i] + t``, causal (the chunk kernel). Pages
    ``[N, bs, H, D]`` f32, bf16 or f16, K and V in the same or two of
    these dtypes (read as f32, as the TPU kernels read them),
    ``block_tables [S, MB]``, ``kv_lens`` counting this chunk's tokens;
    ``q`` f32, bf16 or f16, and the output in ``q``'s dtype; any other
    page or ``q`` dtype raises ``TypeError``. CPU tensors take the plain
    versions; CUDA tensors launch the kernel (int32 tables and lengths,
    contiguous) or raise."""
    if q.dim() not in (3, 4):
        raise ValueError(f"q must be (S, H, D) or (S, Q, H, D), got shape "
                         f"{tuple(q.shape)}")
    chunked = q.dim() == 4
    if chunked and q_lens is None:
        raise ValueError("chunk-shaped q (S, Q, H, D) requires q_lens")
    if k_pages.dtype not in _FLOAT_PAGES or v_pages.dtype not in _FLOAT_PAGES:
        raise TypeError(
            f"pages of dtype {k_pages.dtype} / {v_pages.dtype}: the chunk "
            f"and decode kernels take float32, bfloat16 or float16 pages")
    _check_q_dtype(q)
    if scale is None:
        scale = float(1.0 / (q.shape[-1] ** 0.5))
    if q.device.type == "cpu":
        if chunked:
            return ragged_chunk_attention_reference(
                q, k_pages, v_pages, block_tables, kv_lens, q_lens, scale)
        return ragged_attention_reference(q, k_pages, v_pages,
                                          block_tables, kv_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention kernel for {q.device}")
    return _paged_cuda(q, k_pages, v_pages, block_tables, kv_lens, q_lens,
                       scale)


@register("ragged_paged_attention", differentiable=False)
def _ragged_op(q, k_pages, v_pages, block_tables, kv_lens, *, q_lens=None,
               scale=None):
    """Registered paged-attention op (decode and chunk shapes): the
    kernels on the card, the plain versions on the CPU. ``q_lens`` may be
    any int32 array-like."""
    if q_lens is not None and not isinstance(q_lens, torch.Tensor):
        q_lens = torch.as_tensor(q_lens, dtype=torch.int32, device=q.device)
    return ragged_paged_attention(q, k_pages, v_pages, block_tables,
                                  kv_lens, q_lens=q_lens, scale=scale)

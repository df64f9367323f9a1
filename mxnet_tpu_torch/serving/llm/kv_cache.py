"""Paged KV cache: a fixed pool of KV blocks + a refcounted allocator.

The memory model behind continuous batching (vLLM's PagedAttention,
and the TPU-side "Ragged Paged Attention" kernel shape): instead of one
contiguous ``[max_seqs, max_context, ...]`` KV tensor — whose worst-case
shape wastes almost all of it on short sequences — the cache is a pool
of ``num_blocks`` fixed-size blocks, ``[block_size]`` token slots each,
handed out on demand:

- a sequence owns ``ceil(seq_len / block_size)`` blocks, listed in its
  *block table* — an int32 row of page indices, padded with the
  reserved NULL block 0;
- the attention kernel indirects every KV read through the block
  table (:mod:`mxnet_tpu_torch.ops.ragged_attention` — one flat packed
  shape for prefill chunks and decode), so blocks never need to be
  contiguous or ordered;
- block 0 is never allocated: padded table entries and padded tokens
  of the packed batch all point at it. Block 0's contents are scratch:
  the causal mask at each token's position keeps every live output off
  it, and padded tokens' outputs are discarded, never interpreted.

Cross-request prefix caching (ISSUE 13) extends the ownership model
from exclusive to REFCOUNTED: a full, immutable block of a prompt
prefix is content-addressed by a chained per-block hash
(:func:`prefix_block_hashes`) and can back many sequences at once —
each owner holds a normal entry in its block table, the allocator
holds one refcount per block. The lifecycle:

- ``alloc()`` hands out blocks at refcount 1 (exclusive, as before);
- a prefix-cache hit ``ref()``-s an existing block instead of
  allocating and prefilling it;
- ``free()`` DECREMENTS; a block only leaves circulation at zero;
- a zero-refcount block that is registered in the prefix index
  (:meth:`PagedKVCache.register`) is not returned to the free list —
  it parks in an LRU of CACHED blocks, its contents preserved for
  future hits, but remains fully reclaimable: ``alloc()`` evicts the
  oldest cached blocks (dropping their index entries) whenever the
  strict free list runs short. Cached blocks are spare capacity, so
  ``num_free``/``can_alloc`` count them — they can never read as a
  leak;
- TARGET-pool writes into a block whose refcount is above 1 are
  forbidden; the engine copy-on-writes the block first (the "first
  divergence" of two sequences sharing a prefix).

The allocator stays strict by design: over-allocating raises
:class:`NoFreeBlocksError` (the scheduler's signal to evict), freeing a
block that is not currently allocated raises
:class:`BlockAccountingError` — a leak, double-free or refcount drift
is a bug worth crashing on, not a statistic (pinned by the 1k-schedule
fuzz tests).

The block arrays themselves are torch tensors ``[num_layers,
num_blocks, block_size, heads, head_dim]`` on the cache's device,
written IN PLACE by the model's step (the JAX package threads them
through donated programs and swaps the results back in; here the cache
keeps ownership and nothing is swapped). With ``dtype="int8"`` or
``"float8_e4m3fn"`` the pages store per-slot-scale quantized K/V
(``k_scales``/``v_scales`` f32 ``[num_layers, num_blocks, block_size,
heads]`` ride along) and the ragged kernel dequantizes in-kernel.
"""
from __future__ import annotations

import collections
import hashlib

import numpy as np
import torch

__all__ = ["KVCacheError", "NoFreeBlocksError", "BlockAccountingError",
           "BlockAllocator", "PagedKVCache", "NULL_BLOCK",
           "prefix_block_hashes"]

# block 0 is reserved: the write/read sink for padding and inactive rows
NULL_BLOCK = 0


class KVCacheError(RuntimeError):
    """Base class for paged-KV-cache failures."""


class NoFreeBlocksError(KVCacheError):
    """alloc() could not satisfy the request; evict and retry."""


class BlockAccountingError(KVCacheError):
    """free() of a block that is not allocated (double-free / corrupt
    table), or a refcount/partition drift — always a caller bug."""


def prefix_block_hashes(tokens, block_size, salt=b""):
    """Chained content hashes of the FULL blocks of ``tokens``: hash k
    covers tokens ``[0, (k+1)*block_size)`` — block k's content chained
    onto hash k-1 — so equal hashes imply equal whole prefixes, not
    just equal blocks. The partial tail block is never hashed (it is
    mutable). ``salt`` seeds the chain: KV written under a LoRA
    adapter embeds that adapter's K/V deltas, so the engine namespaces
    the whole chain by the pinned adapter identity — equal tokens
    under different adapters (or versions) never share blocks.
    Returns a list of hex digests, one per full block."""
    out = []
    h = bytes(salt)
    n_full = len(tokens) // block_size
    for k in range(n_full):
        m = hashlib.blake2b(digest_size=16)
        m.update(h)
        m.update(np.asarray(tokens[k * block_size:(k + 1) * block_size],
                            np.int64).tobytes())
        h = m.digest()
        out.append(h.hex())
    return out


class BlockAllocator:
    """Refcounted free-list allocator over block ids ``1..num_blocks-1``.

    All-or-nothing ``alloc(n)``; strict double-free detection; O(1)
    occupancy accounting. Zero-refcount blocks marked *cacheable*
    (prefix-cache registration) park in an LRU instead of the free
    list and are reclaimed — oldest first, via ``reclaim_cb`` so the
    index can drop them — when a later ``alloc`` outgrows the strict
    free list. Not thread-safe — the engine loop is the only caller
    (one thread), matching the serving worker discipline.
    """

    def __init__(self, num_blocks, reclaim_cb=None):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (1 usable + the reserved null block "
                f"{NULL_BLOCK}), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._free = collections.deque(range(1, num_blocks))
        self._ref = {}                      # block id -> refcount >= 1
        # zero-refcount blocks with live cached contents, oldest first
        self._cached = collections.OrderedDict()
        self._cacheable = set()             # registered in a prefix index
        self._reclaim_cb = reclaim_cb
        # blocks at refcount > 1, maintained incrementally on the
        # 1<->2 crossings — the per-step metrics hook reads this every
        # engine iteration, so it must not rescan the refcount dict
        self._num_shared = 0

    @property
    def num_usable(self):
        """Total allocatable blocks (the pool minus the null block)."""
        return self.num_blocks - 1

    @property
    def num_free(self):
        """Blocks an ``alloc`` can draw on NOW: the strict free list
        plus the reclaimable cached LRU (cached blocks are spare
        capacity, never a leak)."""
        return len(self._free) + len(self._cached)

    @property
    def num_used(self):
        """Blocks with refcount >= 1 (owned by at least one sequence)."""
        return len(self._ref)

    @property
    def num_cached(self):
        """Zero-refcount blocks parked in the prefix-cache LRU."""
        return len(self._cached)

    @property
    def num_shared(self):
        """Blocks owned by MORE than one live sequence (refcount > 1)."""
        return self._num_shared

    def occupancy(self):
        """Fraction of usable blocks currently allocated."""
        return self.num_used / float(self.num_usable)

    def can_alloc(self, n):
        return n <= self.num_free

    def refcount(self, block):
        """Live owners of ``block`` (0 = free or cached)."""
        return self._ref.get(block, 0)

    def alloc(self, n=1):
        """Allocate ``n`` blocks at refcount 1; returns their ids.
        All-or-nothing: raises NoFreeBlocksError without touching the
        pool when fewer than ``n`` are free+cached. Draws the strict
        free list first, then reclaims cached blocks LRU-oldest-first
        (``reclaim_cb(block)`` fires per reclaim so the prefix index
        drops its entry before the block is rewritten)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > self.num_free:
            raise NoFreeBlocksError(
                f"need {n} blocks, {self.num_free} free "
                f"({self.num_used}/{self.num_usable} in use, "
                f"{self.num_cached} cached)")
        out = []
        for _ in range(n):
            if self._free:
                b = self._free.popleft()
            else:
                b, _ = self._cached.popitem(last=False)   # LRU evict
                self._cacheable.discard(b)
                if self._reclaim_cb is not None:
                    self._reclaim_cb(b)
            self._ref[b] = 1
            out.append(b)
        return out

    def ref(self, block):
        """Take one more reference on a live or cached block (a
        prefix-cache hit). A cached block revives at refcount 1 — its
        contents are live again, its index registration stands."""
        if block in self._cached:
            del self._cached[block]
            self._ref[block] = 1
        elif block in self._ref:
            if self._ref[block] == 1:
                self._num_shared += 1
            self._ref[block] += 1
        else:
            raise BlockAccountingError(
                f"ref() of block {block} which is neither allocated "
                "nor cached")

    def mark_cacheable(self, block):
        """Flag a LIVE block as prefix-index-registered: when its
        refcount drops to zero it parks in the cached LRU instead of
        the free list."""
        if block not in self._ref:
            raise BlockAccountingError(
                f"mark_cacheable() of unallocated block {block}")
        self._cacheable.add(block)

    def free(self, blocks):
        """Drop one reference per block. A block reaching refcount 0
        returns to the free list — or to the cached LRU when it is
        prefix-registered. Raises BlockAccountingError on the null
        block, an out-of-range id, a block with no live references
        (double-free), or a duplicate within one call (a sequence
        cannot own the same block twice)."""
        blocks = list(blocks)
        for b in blocks:                      # validate before mutating
            if b == NULL_BLOCK:
                raise BlockAccountingError(
                    f"block {NULL_BLOCK} is the reserved null block")
            if not (0 < b < self.num_blocks):
                raise BlockAccountingError(f"block {b} out of range")
            if b not in self._ref:
                raise BlockAccountingError(
                    f"block {b} is not allocated (double free?)")
        if len(set(blocks)) != len(blocks):
            raise BlockAccountingError(
                f"duplicate blocks in free(): {blocks}")
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 1:
                self._num_shared -= 1
            elif self._ref[b] == 0:
                del self._ref[b]
                if b in self._cacheable:
                    self._cached[b] = None    # most-recently released
                else:
                    self._free.append(b)

    def check(self):
        """Invariant: every block is exactly one of {null, free,
        refcounted, cached}; refcounts are positive; every cached
        block is registered cacheable. Raises BlockAccountingError on
        violation; returns True."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise BlockAccountingError("duplicate ids in free list")
        cached = set(self._cached)
        used = set(self._ref)
        if free & used or free & cached or used & cached:
            raise BlockAccountingError(
                "blocks in more than one of free/used/cached: "
                f"{sorted((free & used) | (free & cached) | (used & cached))}")
        if len(free) + len(used) + len(cached) != self.num_usable:
            raise BlockAccountingError(
                f"leak: {self.num_usable - len(free) - len(used) - len(cached)} "
                "blocks neither free, used nor cached")
        bad = [b for b, c in self._ref.items() if c < 1]
        if bad:
            raise BlockAccountingError(f"non-positive refcounts: {bad}")
        shared = sum(1 for c in self._ref.values() if c > 1)
        if shared != self._num_shared:
            raise BlockAccountingError(
                f"shared-block counter drift: {self._num_shared} "
                f"tracked, {shared} actual")
        if not cached <= self._cacheable:
            raise BlockAccountingError(
                f"cached blocks missing their cacheable flag: "
                f"{sorted(cached - self._cacheable)}")
        return True


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "int8": torch.int8,
                 "float8_e4m3fn": torch.float8_e4m3fn}


class PagedKVCache:
    """The block pool's storage + allocator + block-table helpers +
    the cross-request prefix index.

    K and V pages are torch tensors of shape ``[num_layers, num_blocks,
    block_size, num_heads, head_dim]`` on ``device``, written in place
    by the model's step, in ``dtype``: ``"float32"``, or ``"bfloat16"``
    / ``"float16"`` (2 bytes an element; the step rounds K/V to nearest
    even on write and the kernels read them as f32), or a quantized
    dtype below.

    ``dtype="int8"`` selects quantized storage: pages hold int8 values
    and per-(layer, block, slot, head) f32 scales ride in
    ``k_scales``/``v_scales`` — the step quantizes on write and the
    ragged kernel dequantizes on read. ``dtype="float8_e4m3fn"`` stores
    the same scale-per-slot layout at fp8 width.

    ``prefix_cache=True`` enables the content-addressed prefix index:
    :meth:`register` maps a chained block hash to a live block,
    :meth:`prefix_get` answers hit lookups, and LRU reclaims (the
    allocator outgrowing its strict free list) drop entries and count
    on ``prefix_evictions`` / fire ``on_prefix_evict``.
    """

    QUANTIZED_DTYPES = ("int8", "float8_e4m3fn")

    def __init__(self, num_layers, num_heads, head_dim, block_size,
                 num_blocks, max_context, dtype="float32",
                 prefix_cache=False, device="cuda"):
        if max_context < 1:
            raise ValueError(f"max_context must be >= 1, {max_context}")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.max_context = int(max_context)
        if dtype not in _TORCH_DTYPES:
            raise ValueError(f"unsupported KV dtype {dtype!r} (expected "
                             f"one of {', '.join(_TORCH_DTYPES)})")
        self.dtype_name = dtype
        self.dtype = _TORCH_DTYPES[dtype]
        self.quantized = dtype in self.QUANTIZED_DTYPES
        # every sequence's table has room for a full-context sequence
        self.max_blocks_per_seq = -(-self.max_context // self.block_size)
        self.prefix_enabled = bool(prefix_cache)
        self.allocator = BlockAllocator(
            self.num_blocks,
            reclaim_cb=self._on_reclaim if self.prefix_enabled else None)
        self._hash_to_block = {}
        self._block_to_hash = {}
        self.prefix_evictions = 0
        self.cow_count = 0                 # engine-maintained
        self.on_prefix_evict = None        # optional stats hook
        self.device = torch.device(device)
        shape = (self.num_layers, self.num_blocks, self.block_size,
                 self.num_heads, self.head_dim)
        # zero bytes are zero in every pool dtype; allocating bytes
        # keeps fp8 pools off fp8 fill kernels
        raw = torch.uint8 if self.dtype.itemsize == 1 else self.dtype
        self.k_pages = torch.zeros(shape, dtype=raw,
                                   device=self.device).view(self.dtype)
        self.v_pages = torch.zeros(shape, dtype=raw,
                                   device=self.device).view(self.dtype)
        if self.quantized:
            sshape = shape[:-1]            # [L, N, bs, H]
            self.k_scales = torch.ones(sshape, dtype=torch.float32,
                                       device=self.device)
            self.v_scales = torch.ones(sshape, dtype=torch.float32,
                                       device=self.device)
        else:
            self.k_scales = None
            self.v_scales = None

    def pools(self):
        """Every device pool tensor, in a fixed order (pages, then the
        scales of a quantized pool)."""
        out = [self.k_pages, self.v_pages]
        if self.quantized:
            out += [self.k_scales, self.v_scales]
        return out

    def copy_block(self, src, dst):
        """Copy-on-write: copy block row ``src`` onto ``dst`` in every
        pool tensor, in place."""
        for a in self.pools():
            a[:, dst] = a[:, src]

    def nbytes(self):
        return int(sum(a.numel() * a.element_size() for a in self.pools()))

    # ------------------------------------------------------- tables --
    def blocks_for(self, num_tokens):
        """Blocks needed to hold ``num_tokens`` KV entries."""
        return -(-int(num_tokens) // self.block_size)

    # ------------------------------------------------- prefix index --
    def _on_reclaim(self, block):
        h = self._block_to_hash.pop(block, None)
        if h is not None:
            self._hash_to_block.pop(h, None)
        self.prefix_evictions += 1
        if self.on_prefix_evict is not None:
            self.on_prefix_evict()

    def prefix_get(self, h):
        """Block id registered for chained hash ``h`` (None = miss)."""
        return self._hash_to_block.get(h)

    def register(self, h, block):
        """Register a LIVE, FULL, immutable block under its chained
        hash. First registration wins (an identical block computed
        concurrently by another sequence stays private and is freed
        normally). Returns True when the entry was installed."""
        if not self.prefix_enabled:
            return False
        if h in self._hash_to_block or block in self._block_to_hash:
            return False
        self.allocator.mark_cacheable(block)
        self._hash_to_block[h] = block
        self._block_to_hash[block] = h
        return True

    @property
    def prefix_blocks(self):
        """Blocks currently registered in the prefix index."""
        return len(self._hash_to_block)

    # ---------------------------------------------------- invariants --
    def check(self, live_block_ids=None):
        """Pool-level invariant (the chaos-matrix gate): the allocator
        accounting is consistent, and — when ``live_block_ids`` (an
        iterable of per-sequence block-id lists) is given — the
        refcounts are EXACTLY the per-block owner counts over live
        sequences: no leaked blocks, no unaccounted sharing, no
        sequence owning one block twice. Cached (zero-refcount,
        prefix-registered) blocks are reclaimable capacity and never
        count as leaks. Raises :class:`BlockAccountingError`; returns
        True."""
        self.allocator.check()
        if live_block_ids is not None:
            owned = collections.Counter()
            for ids in live_block_ids:
                ids = list(ids)
                if len(set(ids)) != len(ids):
                    raise BlockAccountingError(
                        "a sequence owns the same KV block twice")
                owned.update(ids)
            if dict(owned) != self.allocator._ref:
                leaked = sorted(set(self.allocator._ref) - set(owned))
                phantom = sorted(set(owned) - set(self.allocator._ref))
                drift = sorted(
                    b for b in set(owned) & set(self.allocator._ref)
                    if owned[b] != self.allocator._ref[b])
                raise BlockAccountingError(
                    f"block accounting drift: leaked={leaked} "
                    f"unallocated-but-owned={phantom} "
                    f"refcount-drift={drift}")
        return True

    # -------------------------------------------------------- stats --
    def stats(self):
        a = self.allocator
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "blocks_used": a.num_used,
            "blocks_shared": a.num_shared,
            "blocks_cached": a.num_cached,
            # strictly free (same definition as the
            # mxtpu_llm_kv_blocks_free gauge); cached LRU blocks are
            # counted separately and the sum is blocks_reclaimable
            "blocks_free": a.num_free - a.num_cached,
            "blocks_reclaimable": a.num_free,
            "occupancy": a.occupancy(),
            "max_blocks_per_seq": self.max_blocks_per_seq,
            "kv_dtype": self.dtype_name,
            "prefix_blocks": self.prefix_blocks,
            "prefix_evictions": self.prefix_evictions,
            "cow_copies": self.cow_count,
        }

"""AdapterBank: a fixed paged pool of LoRA factor pages on the device
(the port of ``mxnet_tpu/serving/adapters/bank.py``).

The KV cache's memory model (``llm/kv_cache.py``) applied to LoRA
adapters: the bank owns a fixed pool of factor *pages*, ``a_pages [P, L,
4, d, r]`` and ``b_pages [P, L, 4, r, d]`` (axis 2 the four attention
projections q/k/v/o, ``r`` the page rank), handed out by the same strict
refcounted :class:`~..llm.kv_cache.BlockAllocator`:

- an adapter of rank ``R`` owns ``ceil(R / r)`` pages (the tail page
  zero-padded: zero factor columns add an exactly-zero delta); page 0 is
  the reserved null page, all zeros forever: adapter-less rows point
  their page table at it and get an exact-zero delta;
- while resident, the bank holds one baseline reference a page; every
  in-flight request using the adapter holds one more (taken at
  admission, released on finish, evict or expiry, kept across
  preemption, so a restarted request keeps the factors it started with);
- a resident adapter with no in-flight user is cold: it parks in an
  adapter-level LRU and is reclaimed, oldest first, when a publish
  outgrows the pool (``evictions["capacity"]``), the whole multi-page
  adapter at once;
- republishing a live adapter never blocks: the new version installs
  into fresh pages and the name flips; the old version's pages are
  detached (baseline dropped, in-flight users keep theirs) and drain to
  the free list as those requests finish;
- publish refuses factors or an alpha that are not finite
  (:class:`AdapterError`, the bank left as it was): the flat step's delta
  multiplies every pool page's B for every row, so one NaN would reach
  them all (the reference gathers only a row's own pages);
- over-allocation, double release and refcount drift raise typed errors
  (:class:`NoFreeAdapterPagesError`, :class:`AdapterAccountingError`),
  and :meth:`check` proves the partition invariant: every page is owned
  by exactly one live adapter record with allocator refcount == baseline
  + users.

The pools are device tensors of fixed storage, made once: an install
copies the factors **in place** into freshly allocated pages, so every
captured step graph, which reads the pools' storage, sees a publish with
no recapture (the reference's install is one warmed jitted program; a
copy needs no build). Storage is laid out for the step
(:meth:`step_pools`: one (layer, projection)'s pages as ``[d, P, r]``
and ``[P, r, d]``, so ``x @ A`` over the whole pool is one product);
``a_pages``/``b_pages`` are views of it in the reference's layout.

Threads: publisher threads, caller threads (``known``) and the engine
thread all enter, under one lock. An install's copies are complete on
the device before the new name becomes visible to :meth:`acquire`
(synchronised under the lock), so a step that replays on another
stream after an admission reads the installed factors; pages that
in-flight requests use are never rewritten, so a step racing a publish
reads valid factors for every row of its batch.

Every retirement drops an ``adapter.evict`` event into the flight
recorder (reason, version, users left).

Not ported yet (ROADMAP.md, section 1 item 6b): the on-disk
``AdapterRegistry`` (``registry=`` raises ``NotImplementedError``), with
the fault-in path whose ``adapter.fault_in`` event it carries, and the
fine-tune-and-publish loop.
"""
from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from ..._device import resolve_device
from ...observability.flightrecorder import get_flightrecorder
from ...ops.lora import NUM_PROJ
from ..envutil import env_int
from ..llm.kv_cache import BlockAllocator, NoFreeBlocksError

__all__ = ["AdapterBank", "AdapterHandle", "AdapterError",
           "UnknownAdapterError", "NoFreeAdapterPagesError",
           "AdapterAccountingError", "NULL_ADAPTER_PAGE"]

# page 0 is reserved and all-zero: the null adapter's factor source
NULL_ADAPTER_PAGE = 0

_DEFERRED = {
    "registry": "the adapter registry (it needs the port's "
                "resilience/checkpoint.py)",
}


class AdapterError(RuntimeError):
    """Base class for adapter-bank failures."""


class UnknownAdapterError(AdapterError, KeyError):
    """The adapter name is not resident."""

    def __str__(self):          # KeyError quotes its arg; keep prose
        return RuntimeError.__str__(self)


class NoFreeAdapterPagesError(AdapterError):
    """publish could not get pages even after evicting every cold
    adapter: the pool is pinned by in-flight requests."""


class AdapterAccountingError(AdapterError):
    """Refcount or partition drift, double release, or eviction of an
    in-use adapter: always a caller bug worth crashing on."""


class AdapterHandle:
    """An in-flight request's pin on one published adapter version.

    ``pages_padded`` is the page-table row the batch carries (padded to
    the bank's ``max_pages_per_adapter`` with the null page) and
    ``scale`` the row's LoRA scaling (``alpha / rank``). The handle stays
    valid across a republish of the same name: it pins the version it
    was acquired against."""

    __slots__ = ("name", "version", "rank", "scale", "pages_padded",
                 "_rec")

    def __init__(self, rec, pages_padded):
        self.name = rec.name
        self.version = rec.version
        self.rank = rec.rank
        self.scale = rec.scale
        self.pages_padded = pages_padded
        self._rec = rec


class _Resident:
    """One published (name, version): its pages and user accounting."""

    __slots__ = ("name", "version", "rank", "scale", "pages", "users",
                 "detached")

    def __init__(self, name, version, rank, scale, pages):
        self.name = name
        self.version = version
        self.rank = rank
        self.scale = scale
        self.pages = tuple(pages)
        self.users = 0
        self.detached = False


class AdapterBank:
    """Paged resident pool of LoRA adapters for one base model, on one
    ``device`` (default ``"cuda"``; raises when CUDA is absent unless
    ``device="cpu"``).

    ``num_layers``/``d_model`` must match the decoder the bank serves
    (the engine checks). ``max_adapters`` full-rank adapters fit
    resident (env ``MXNET_TPU_LLM_MAX_ADAPTERS``, default 8);
    ``page_rank`` is the rank of one page (env
    ``MXNET_TPU_LLM_ADAPTER_RANK``, default 4); ``max_pages_per_adapter``
    caps one adapter's rank at ``page_rank * max_pages_per_adapter``.
    ``dtype`` is the pools' float type (``"float32"`` default).
    Thread-safe."""

    def __init__(self, num_layers, d_model, max_adapters=None,
                 page_rank=None, max_pages_per_adapter=2,
                 registry=None, stats=None, dtype="float32",
                 device="cuda"):
        if registry is not None:
            raise NotImplementedError(
                f"registry=: {_DEFERRED['registry']} is not ported to the "
                f"PyTorch bank yet (ROADMAP.md, section 1)")
        if max_adapters is None:
            max_adapters = env_int("MXNET_TPU_LLM_MAX_ADAPTERS", 8)
        if page_rank is None:
            page_rank = env_int("MXNET_TPU_LLM_ADAPTER_RANK", 4)
        if max_adapters < 1:
            raise ValueError(f"max_adapters must be >= 1, got "
                             f"{max_adapters}")
        if page_rank < 1:
            raise ValueError(f"page_rank must be >= 1, got {page_rank}")
        if max_pages_per_adapter < 1:
            raise ValueError(f"max_pages_per_adapter must be >= 1, got "
                             f"{max_pages_per_adapter}")
        self.device = resolve_device(device)
        self.num_layers = int(num_layers)
        self.d_model = int(d_model)
        self.max_adapters = int(max_adapters)
        self.page_rank = int(page_rank)
        self.max_pages_per_adapter = int(max_pages_per_adapter)
        self.num_pages = (self.max_adapters * self.max_pages_per_adapter
                          + 1)
        name = dtype if isinstance(dtype, str) else \
            str(dtype).removeprefix("torch.")
        self.dtype = getattr(torch, name)
        self._lock = threading.Lock()

        L, d, r, P = (self.num_layers, self.d_model, self.page_rank,
                      self.num_pages)
        # the step's layout; a_pages / b_pages are views of it in the
        # reference's [P, L, 4, ...] layout, written in place
        self._a_store = torch.zeros((L, NUM_PROJ, d, P, r),
                                    dtype=self.dtype, device=self.device)
        self._b_store = torch.zeros((L, NUM_PROJ, P, r, d),
                                    dtype=self.dtype, device=self.device)
        self.a_pages = self._a_store.permute(3, 0, 1, 2, 4)
        self.b_pages = self._b_store.permute(2, 0, 1, 3, 4)
        self._alloc = BlockAllocator(P)                # guarded-by: _lock
        self._resident = {}                            # guarded-by: _lock
        # current residents with zero users, oldest-idle first
        self._cold = collections.OrderedDict()         # guarded-by: _lock
        # republished-from-under records still pinned by in-flight users
        self._detached = []                            # guarded-by: _lock
        self._versions = {}                            # guarded-by: _lock
        self._publishes = 0                            # guarded-by: _lock
        self._acquires = 0                             # guarded-by: _lock
        self._evictions = {"capacity": 0, "explicit": 0,
                           "republish": 0}             # guarded-by: _lock
        self._stats = stats                            # guarded-by: _lock
        self._flight = get_flightrecorder()
        self._warmed = False                           # guarded-by: _lock

    # -------------------------------------------------------- metrics --
    def attach_stats(self, stats):
        """Late-bind an :class:`~..llm.metrics.LLMStats` (the server
        makes it after the bank exists)."""
        with self._lock:
            if self._stats is None:
                self._stats = stats
                self._gauge_locked()

    # guarded-by: caller
    def _gauge_locked(self):
        if self._stats is not None:
            self._stats.record_adapters_resident(len(self._resident))

    # -------------------------------------------------------- install --
    # guarded-by: caller
    def _install_locked(self, page, a_src, b_src):
        """Copy one page's factors (``[L, 4, d, r]``, ``[L, 4, r, d]``)
        into the pools in place."""
        self.a_pages[page].copy_(torch.as_tensor(a_src, dtype=self.dtype))
        self.b_pages[page].copy_(torch.as_tensor(b_src, dtype=self.dtype))

    # guarded-by: caller
    def _installed_locked(self):
        """Every install's copies done on the device before a name they
        serve becomes visible (the engine may replay on another
        stream)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self):
        """Run the install path once, into the null page with zero
        factors (no change to the pools). The engine's ``warmup()`` calls
        it when a bank is attached."""
        with self._lock:
            if self._warmed:
                return
            L, d, r = self.num_layers, self.d_model, self.page_rank
            self._install_locked(
                NULL_ADAPTER_PAGE,
                np.zeros((L, NUM_PROJ, d, r), np.float32),
                np.zeros((L, NUM_PROJ, r, d), np.float32))
            self._installed_locked()
            self._warmed = True

    def pools(self):
        """(a_pages, b_pages), the reference's views of the pools (fixed
        storage: a captured step reads every later install)."""
        return self.a_pages, self.b_pages

    def step_pools(self, layer, proj):
        """One (layer, projection)'s whole pool in the step's layout:
        (``[d, P, r]``, ``[P, r, d]``) views, for
        :func:`~mxnet_tpu_torch.ops.lora.pool_lora_delta`."""
        return self._a_store[layer, proj], self._b_store[layer, proj]

    def nbytes(self):
        """Device bytes of the two pools."""
        return sum(t.numel() * t.element_size()
                   for t in (self._a_store, self._b_store))

    # -------------------------------------------------------- publish --
    def publish(self, name, a, b, alpha=None, persist=True):
        """Install adapter ``name`` (factors ``a [L, 4, d, R]``, ``b [L,
        4, R, d]``) into the bank; returns the new version. A republish
        of a live name detaches the old version's pages to its in-flight
        users and flips the name. ``persist`` is the reference's
        registry flag (no registry here: nothing to persist)."""
        L, d = self.num_layers, self.d_model
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        if a.ndim != 4 or a.shape[:3] != (L, NUM_PROJ, d):
            raise AdapterError(
                f"adapter {name!r}: A factors must be [num_layers={L}, "
                f"4, d_model={d}, R], got {a.shape}")
        rank = a.shape[3]
        if b.shape != (L, NUM_PROJ, rank, d):
            raise AdapterError(
                f"adapter {name!r}: B factors must be [num_layers={L}, "
                f"4, R={rank}, d_model={d}], got {b.shape}")
        if rank < 1:
            raise AdapterError(f"adapter {name!r}: rank must be >= 1")
        n_pages = -(-rank // self.page_rank)
        if n_pages > self.max_pages_per_adapter:
            raise AdapterError(
                f"adapter {name!r}: rank {rank} needs {n_pages} pages "
                f"of rank {self.page_rank}, bank caps at "
                f"{self.max_pages_per_adapter} pages per adapter")
        scale = (float(alpha) if alpha is not None else float(rank)) \
            / float(rank)
        # the step's delta multiplies every pool page's B by the zeros of
        # the columns a row does not keep (ops/lora.py pool_lora_delta):
        # one NaN or infinity in the pool would reach every row
        if not (np.isfinite(a).all() and np.isfinite(b).all()
                and np.isfinite(scale)):
            raise AdapterError(
                f"adapter {name!r}: factors and alpha must be finite")
        with self._lock:
            version = self._versions.get(name, 0) + 1
            return self._publish_locked(name, a, b, rank, scale, version)

    # guarded-by: caller
    def _publish_locked(self, name, a, b, rank, scale, version):
        n_pages = -(-rank // self.page_rank)
        old = self._resident.get(name)
        if old is not None and old.users == 0:
            # a cold old version is the best victim for its own
            # replacement: retire it up front so its pages can serve
            # the new install
            self._retire_locked(old, reason="republish")
            old = None
        pages = self._alloc_pages_locked(n_pages)
        r0 = self.page_rank
        r_pad = n_pages * r0
        if rank != r_pad:                  # zero-pad the tail page
            a_pad = np.zeros(a.shape[:3] + (r_pad,), np.float32)
            a_pad[..., :rank] = a
            b_pad = np.zeros(b.shape[:2] + (r_pad,) + b.shape[3:],
                             np.float32)
            b_pad[:, :, :rank] = b
            a, b = a_pad, b_pad
        for i, p in enumerate(pages):
            self._install_locked(p, a[..., i * r0:(i + 1) * r0],
                                 b[:, :, i * r0:(i + 1) * r0, :])
        self._installed_locked()
        if old is not None:      # live old version: detach to its users
            self._retire_locked(old, reason="republish")
        rec = _Resident(name, version, rank, scale, pages)
        self._resident[name] = rec
        self._cold[name] = None
        self._versions[name] = max(self._versions.get(name, 0), version)
        self._publishes += 1
        if self._stats is not None:
            self._stats.record_adapter_publish()
        self._gauge_locked()
        return version

    # guarded-by: caller
    def _alloc_pages_locked(self, n):
        """All-or-nothing page grab, evicting cold adapters
        oldest-idle-first until it fits."""
        while not self._alloc.can_alloc(n):
            victim = next(iter(self._cold), None)
            if victim is None:
                raise NoFreeAdapterPagesError(
                    f"need {n} pages, {self._alloc.num_free} free and "
                    f"no cold adapter to evict "
                    f"({len(self._resident)} resident, "
                    f"{len(self._detached)} detached draining)")
            self._retire_locked(self._resident[victim],
                                reason="capacity")
        try:
            return self._alloc.alloc(n)
        except NoFreeBlocksError as e:  # pragma: no cover - guarded above
            raise NoFreeAdapterPagesError(str(e)) from e

    # guarded-by: caller
    def _retire_locked(self, rec, reason):
        """Drop the bank's baseline reference on ``rec``. Zero users:
        the pages return to the free list and the name leaves the
        resident set. Live users: the record detaches and its pages
        drain as those requests release."""
        self._alloc.free(rec.pages)
        self._cold.pop(rec.name, None)
        if self._resident.get(rec.name) is rec:
            del self._resident[rec.name]
        if rec.users > 0:
            rec.detached = True
            self._detached.append(rec)
        self._evictions[reason] += 1
        if self._stats is not None:
            self._stats.record_adapter_evicted(reason)
        if self._flight.enabled:
            self._flight.event(
                "adapter.evict",
                attrs={"adapter": rec.name, "version": rec.version,
                       "reason": reason, "users": rec.users})
        self._gauge_locked()

    def evict(self, name, reason="explicit"):
        """Evict a resident adapter with no in-flight users. Raises
        :class:`AdapterAccountingError` if it is in use (republish is
        the path for live names) and :class:`UnknownAdapterError` if it
        is not resident."""
        with self._lock:
            rec = self._resident.get(name)
            if rec is None:
                raise UnknownAdapterError(
                    f"adapter {name!r} is not resident")
            if rec.users > 0:
                raise AdapterAccountingError(
                    f"adapter {name!r} has {rec.users} in-flight "
                    "users; republish instead of evicting")
            self._retire_locked(rec, reason=reason)

    # -------------------------------------------------------- serving --
    def known(self, name):
        """True when ``name`` can be acquired (resident now). The server
        checks ``submit(adapter=...)`` here, on the caller's thread."""
        with self._lock:
            return name in self._resident

    def acquire(self, name, tenant=None):
        """Pin adapter ``name`` for one in-flight request: +1 user, +1
        allocator reference a page. Returns an :class:`AdapterHandle`;
        every successful acquire is paired with one :meth:`release`."""
        with self._lock:
            rec = self._resident.get(name)
            if rec is None:
                raise UnknownAdapterError(
                    f"adapter {name!r} is not resident (and the port's "
                    f"bank has no registry to load it from)")
            self._acquires += 1
            rec.users += 1
            self._cold.pop(name, None)
            for p in rec.pages:
                self._alloc.ref(p)
            if self._stats is not None:
                self._stats.record_adapter_request(name, tenant=tenant)
            pad = (NULL_ADAPTER_PAGE,) * (self.max_pages_per_adapter
                                          - len(rec.pages))
            return AdapterHandle(rec, rec.pages + pad)

    def release(self, handle):
        """Drop one request's pin. The last release of a current version
        parks it cold (LRU-evictable); the last release of a detached
        version returns its pages to the free list."""
        with self._lock:
            rec = handle._rec
            if rec.users <= 0:
                raise AdapterAccountingError(
                    f"release of adapter {rec.name!r} v{rec.version} "
                    "with no live users (double release?)")
            self._alloc.free(rec.pages)
            rec.users -= 1
            if rec.users == 0:
                if rec.detached:
                    self._detached.remove(rec)
                elif self._resident.get(rec.name) is rec:
                    self._cold[rec.name] = None   # most-recently idle

    # ------------------------------------------------------ inspection --
    def names(self):
        with self._lock:
            return sorted(self._resident)

    def resident_version(self, name):
        """Version currently serving for ``name`` (None if not
        resident)."""
        with self._lock:
            rec = self._resident.get(name)
            return None if rec is None else rec.version

    def adapter_arrays(self, name):
        """Oracle view: the padded factor pages a batch row of this
        adapter reads, ``(a_sel [P, L, 4, d, r], b_sel [P, L, 4, r, d],
        scale)`` with ``P = max_pages_per_adapter`` (null-page padded),
        copied from the pools on the bank's device, so the oracle sees
        the bytes the step reads."""
        with self._lock:
            rec = self._resident.get(name)
            if rec is None:
                raise UnknownAdapterError(
                    f"adapter {name!r} is not resident")
            pad = (NULL_ADAPTER_PAGE,) * (self.max_pages_per_adapter
                                          - len(rec.pages))
            idx = torch.tensor(rec.pages + pad, device=self.device)
            return (self.a_pages[idx].contiguous(),
                    self.b_pages[idx].contiguous(), rec.scale)

    def stats(self):
        """Snapshot for ``LLMServer.stats()``."""
        with self._lock:
            return {
                "resident": len(self._resident),
                "cold": len(self._cold),
                "detached": len(self._detached),
                "in_use": sum(1 for r in self._resident.values()
                              if r.users > 0),
                "pages_total": self._alloc.num_usable,
                "pages_used": self._alloc.num_used,
                "pages_free": self._alloc.num_free,
                "publishes": self._publishes,
                "acquires": self._acquires,
                # every acquire finds its adapter resident: the port has
                # no registry to fault one in from
                "acquire_hits": self._acquires,
                "registry_loads": 0,
                "evictions": dict(self._evictions),
                "max_adapters": self.max_adapters,
                "page_rank": self.page_rank,
                "max_pages_per_adapter": self.max_pages_per_adapter,
                "pool_bytes": self.nbytes(),
            }

    def check(self):
        """Partition invariant over the whole bank. Every page is owned
        by exactly one live record; a current resident's pages carry
        refcount ``users + 1`` (the +1 is the bank's baseline), a
        detached record's exactly ``users``; no allocated page is
        orphaned; the cold LRU lists exactly the zero-user residents.
        Raises :class:`AdapterAccountingError` on drift; returns True."""
        with self._lock:
            self._alloc.check()
            owned = {}
            for rec in self._resident.values():
                for p in rec.pages:
                    if p in owned:
                        raise AdapterAccountingError(
                            f"page {p} owned by two adapters")
                    owned[p] = rec.users + 1
            for rec in self._detached:
                if rec.users <= 0:
                    raise AdapterAccountingError(
                        f"detached record {rec.name!r} v{rec.version} "
                        "with no users should have drained")
                for p in rec.pages:
                    if p in owned:
                        raise AdapterAccountingError(
                            f"page {p} owned by two adapters")
                    owned[p] = rec.users
            for p, want in owned.items():
                got = self._alloc.refcount(p)
                if got != want:
                    raise AdapterAccountingError(
                        f"page {p}: refcount {got}, accounting says "
                        f"{want}")
            for p in range(1, self.num_pages):
                if p not in owned and self._alloc.refcount(p) > 0:
                    raise AdapterAccountingError(
                        f"page {p} allocated but owned by no adapter")
            for nm in self._cold:
                rec = self._resident.get(nm)
                if rec is None or rec.users != 0:
                    raise AdapterAccountingError(
                        f"cold LRU entry {nm!r} is not a zero-user "
                        "resident")
            for nm, rec in self._resident.items():
                if rec.users == 0 and nm not in self._cold:
                    raise AdapterAccountingError(
                        f"zero-user resident {nm!r} missing from the "
                        "cold LRU")
            return True

"""FleetRouter of the port (mirrors ``mxnet_tpu/serving/fleet/router.py``):
N named models behind one front end, with atomic weight hot-swap,
per-tenant quotas, and priority lanes.

The fleet layer composes the per-server primitives the serving stack
ships — admission gates + breaker + deadlines (ModelServer /
LLMServer), ``quiesce()``/``resume()``, sharded-manifest checkpoints
(``resilience.checkpoint``), and the chaos harness
(``resilience.faults``) — into a zero-downtime rollout story:

``publish(model, version, ...)`` runs five phases::

    load ----> warm ----> drain ----> handover ----> prune
    (read      (build +   (route to   (COMMIT:       (retire the
     sharded    warm the   the new     active =       old replica;
     manifest)  replica    replica;    new; gauge     stragglers
                OFF the    quiesce     moves)         evict typed)
                serving    the old)
                path)

On the card the warm phase is where the new replica captures its CUDA
graphs (an ``LLMServer``'s step ladder, a ``ModelServer``'s bucket
graphs: each replica's graphs are over its own weights and pools); it
runs on the publisher's thread while the old replica keeps replaying
its own on its worker thread (captures are ``thread_local``, see
:func:`mxnet_tpu_torch.kernels.capture`). No serving path builds or
captures anything before, during or after a swap.

The handover commit is the atomicity point (``resilience/atomic.py``
semantics, applied to routing state): any crash BEFORE it rolls back —
the old version keeps serving, admission resumes, and the
half-published replica is shut down (invisible); a crash AFTER it
rolls forward — the new version is already committed, the failure
handler finishes retiring the old replica. Either way every in-flight
Future resolves served / shed / evicted-typed; nothing is dropped.

During the drain phase NEW traffic already flows to the warmed new
replica — a caller can never observe a "closed" fleet mid-swap. The
submit path re-reads the routing table on ``ServerClosed`` so the
quiesce/handover flips are invisible races, not caller errors.

Chaos sites: ``fleet.route`` (scripted exceptions on the submit path —
poison one tenant's routing), ``fleet.publish:<phase>`` (kill the
publisher at any phase boundary), ``fleet.drain`` (kill or block
between the route flip and the old replica's quiesce).

Config: constructor arg > ``MXNET_TPU_FLEET_*`` env var > default —
``MXNET_TPU_FLEET_QUOTA_RPS`` (0 = quotas off),
``MXNET_TPU_FLEET_QUOTA_BURST`` (0 = 2x rate),
``MXNET_TPU_FLEET_BATCH_DEPTH`` (0 = batch lane unbounded),
``MXNET_TPU_FLEET_DRAIN_MS`` (0 = unbounded drain).
"""
from __future__ import annotations

import threading
import time

from ..envutil import env_float as _env_float, env_int as _env_int
from ..errors import Overloaded, ServerClosed
from ..telemetry import compile_count
from ...observability.flightrecorder import get_flightrecorder
from ...resilience import faults
from .metrics import FleetStats
from .quota import LANES, TenantQuota

__all__ = ["FleetRouter", "PUBLISH_PHASES"]

PUBLISH_PHASES = ("load", "warm", "drain", "handover", "prune")


def _server_kind(server):
    """'llm' for LLMServer-shaped objects (decode engine + generate),
    'serving' for single-shot ModelServer-shaped ones."""
    return "llm" if hasattr(server, "engine") else "serving"


class _Handle:
    """One live (version, server) pair of a model entry."""

    __slots__ = ("version", "server", "kind")

    def __init__(self, version, server, kind):
        self.version = version
        self.server = server
        self.kind = kind


class _Entry:
    """Routing-table row for one named model. ``active`` is the
    committed handle (moves only at the handover commit); ``route`` is
    where NEW traffic goes (moves early, at drain, so callers never
    hit a quiescing replica). Both only mutate under the router lock."""

    __slots__ = ("name", "kind", "builder", "active", "route")

    def __init__(self, name, handle, builder):
        self.name = name
        self.kind = handle.kind
        self.builder = builder
        self.active = handle
        self.route = handle


class FleetRouter:
    """Host N named models behind one ``submit``/``generate`` front
    end; see the module docstring for rollout, quota, and chaos
    semantics. Servers are registered warmed+started via
    :meth:`add_model`; ``builder(arrays)`` (required for
    :meth:`publish`) must return an UNSTARTED server of the same kind
    — the router warms and starts it off the serving path."""

    def __init__(self, name="fleet", registry=None, quota_rps=None,
                 quota_burst=None, batch_lane_depth=None,
                 drain_ms=None):
        self.name = name
        if quota_rps is None:
            quota_rps = _env_float("MXNET_TPU_FLEET_QUOTA_RPS", 0.0)
        if quota_burst is None:
            quota_burst = _env_float("MXNET_TPU_FLEET_QUOTA_BURST", 0.0)
        if batch_lane_depth is None:
            batch_lane_depth = _env_int("MXNET_TPU_FLEET_BATCH_DEPTH", 0)
        if drain_ms is None:
            drain_ms = _env_float("MXNET_TPU_FLEET_DRAIN_MS", 0.0)
        self.batch_lane_depth = int(batch_lane_depth)
        self.default_drain_s = (drain_ms / 1e3 if drain_ms and
                                drain_ms > 0 else None)
        self._stats = FleetStats(registry=registry, fleet=name)
        self._quota = TenantQuota(quota_rps, quota_burst or None)
        self._lock = threading.RLock()
        self._models = {}       # guarded-by: _lock  (the routing table)
        self._lane_live = dict.fromkeys(LANES, 0)   # guarded-by: _lock
        self._closed = False    # guarded-by: _lock
        self._publishing = set()    # guarded-by: _lock
        self._flight = get_flightrecorder()
        self._flight.register(f"fleet:{name}", self)
        # the last publish's {"phases": {phase: seconds}, "compiles":
        # {phase: builds + captures}} for the phases it completed
        self.last_publish = None

    def _swap_event(self, model, phase, outcome, version=None):
        """Swap phases are control-plane decisions: mirror every
        ``record_swap`` onto the flight decision log."""
        if self._flight.enabled:
            attrs = {"fleet": self.name, "model": model,
                     "phase": phase, "outcome": outcome}
            if version is not None:
                attrs["version"] = version
            self._flight.event("fleet.swap", attrs=attrs)

    # ----------------------------------------------------- registry --
    def add_model(self, name, server, *, version=0, builder=None):
        """Register a warmed+started server under ``name``.
        ``builder(arrays) -> server`` enables :meth:`publish`. The
        replica it builds is warmed in the publish's warm phase: nothing
        to build or capture on the CPU; on the card, its own graphs."""
        handle = _Handle(version, server, _server_kind(server))
        with self._lock:
            if name in self._models:
                raise ValueError(f"model {name!r} already registered")
            self._models[name] = _Entry(name, handle, builder)
        self._stats.set_active_version(name, version)
        return self

    def models(self):
        with self._lock:
            return sorted(self._models)

    def active_version(self, model):
        with self._lock:
            return self._models[model].active.version

    def server(self, model):
        """The committed (active) server — for stats/introspection."""
        with self._lock:
            return self._models[model].active.server

    @property
    def stats(self):
        return self._stats

    def debug_status(self):
        """Structured routing-table snapshot for the flight recorder's
        statusz surface: per-model active/route versions (a mismatch
        means a swap is mid-drain), lane occupancy, in-flight
        publishes, and each backing server's own ``debug_status()``
        (best-effort — a server mid-teardown reports its error)."""
        with self._lock:
            models = {
                name: {"kind": e.kind,
                       "active_version": e.active.version,
                       "route_version": e.route.version,
                       "swapping": e.route is not e.active}
                for name, e in self._models.items()}
            lanes = dict(self._lane_live)
            closed = self._closed
            publishing = sorted(self._publishing)
            servers = {name: e.active.server
                       for name, e in self._models.items()}
        for name, srv in servers.items():
            ds = getattr(srv, "debug_status", None)
            if ds is None:
                continue
            try:
                models[name]["server"] = ds()
            except Exception as exc:   # pragma: no cover - defensive
                models[name]["server"] = {"error": repr(exc)}
        return {"kind": "fleet", "fleet": self.name, "closed": closed,
                "publishing": publishing, "lanes": lanes,
                "models": models}

    # ------------------------------------------------------- submit --
    def _admit(self, model, tenant, lane):
        """Shared admission: chaos site, lane check, quota gate, entry
        lookup. Raises typed; returns the entry."""
        faults.check("fleet.route")
        if lane not in LANES:
            raise ValueError(f"unknown lane {lane!r}; lanes are {LANES}")
        with self._lock:
            if self._closed:
                raise ServerClosed(f"fleet {self.name!r} is shut down")
            entry = self._models.get(model)
            known = sorted(self._models)
            batch_live = self._lane_live["batch"]
        if entry is None:
            raise KeyError(f"unknown model {model!r}; registered: "
                           f"{known}")
        if not self._quota.allow(tenant):
            self._stats.record_quota_shed(tenant)
            if self._flight.enabled:
                self._flight.event(
                    "fleet.shed", tenant=tenant,
                    attrs={"fleet": self.name, "model": model,
                           "reason": "quota"})
            raise Overloaded(
                f"tenant {tenant!r} over fleet quota "
                f"({self._quota.rate:g} req/s, burst "
                f"{self._quota.burst:g}); request shed", reason="quota")
        if (lane == "batch" and self.batch_lane_depth > 0
                and batch_live >= self.batch_lane_depth):
            if self._flight.enabled:
                self._flight.event(
                    "fleet.shed", tenant=tenant,
                    attrs={"fleet": self.name, "model": model,
                           "reason": "lane_full",
                           "depth": batch_live})
            raise Overloaded(
                f"batch lane full ({batch_live} >= "
                f"{self.batch_lane_depth}); request shed",
                reason="lane_full", depth=batch_live)
        return entry

    def _track_lane(self, fut, lane):
        with self._lock:
            self._lane_live[lane] += 1
            self._stats.set_lane_depth(lane, self._lane_live[lane])
        fut.add_done_callback(lambda _f: self._lane_done(lane))

    def _lane_done(self, lane):
        with self._lock:
            self._lane_live[lane] -= 1
            self._stats.set_lane_depth(lane, self._lane_live[lane])

    def submit(self, model, *args, tenant=None, lane="interactive",
               **kw):
        """Route one request to ``model``'s live replica; returns the
        server's Future. Positional/keyword args pass through to the
        backing server's ``submit`` (sample for single-shot entries;
        ``prompt_tokens, max_new_tokens, ...`` for LLM entries), so
        one front end serves both kinds.

        Typed failures: :class:`Overloaded` ``reason="quota"`` (this
        tenant's bucket is empty), ``reason="lane_full"`` (batch lane
        depth-capped), plus everything the backing server can raise.
        A hot-swap in progress is NOT a failure: on ``ServerClosed``
        from a quiescing replica the router re-reads the routing table
        and retries against the replacement."""
        entry = self._admit(model, tenant, lane)
        for _ in range(8):
            with self._lock:
                srv = entry.route.server
            try:
                fut = srv.submit(*args, tenant=tenant, **kw)
            except ServerClosed:
                # a swap flipped the route after we read it — retry
                # against the current target; re-raise only when the
                # route still points at the closed server (a real
                # shutdown, not a swap race)
                with self._lock:
                    if entry.route.server is srv:
                        raise
                continue
            self._track_lane(fut, lane)
            self._stats.record_routed(model, lane)
            return fut
        raise ServerClosed(
            f"model {model!r}: route kept moving across 8 retries")

    def generate(self, model, *args, timeout=None, tenant=None,
                 lane="interactive", **kw):
        """Blocking front end: ``submit(...).result(timeout)``."""
        fut = self.submit(model, *args, tenant=tenant, lane=lane, **kw)
        return fut.result(timeout=timeout)

    predict = generate

    # ------------------------------------------------------ publish --
    def publish(self, model, version, arrays=None, run_dir=None,
                ckpt_dir=None, manifest=None, drain_timeout=None,
                verify=True):
        """Atomic weight hot-swap: load ``version``'s weights, warm a
        new replica off the serving path, drain the old one, commit,
        retire. Returns ``version`` on success.

        Weights come from ``arrays`` (dict name -> array) or a
        checkpoint of :mod:`mxnet_tpu_torch.resilience.checkpoint`:
        ``ckpt_dir`` (+ optional pre-validated ``manifest``) or
        ``run_dir`` (newest valid checkpoint wins —
        ``latest_checkpoint`` semantics, a torn write is invisible).
        ``drain_timeout`` (seconds; default ``MXNET_TPU_FLEET_DRAIN_MS``)
        bounds the old replica's quiesce; stragglers past it are
        evicted TYPED at prune. ``verify`` re-checks every array
        against the manifest CRCs before any replica is built.

        Crash contract (the chaos matrix runs every row): a failure —
        including an injected ``BaseException`` — before the handover
        commit ROLLS BACK (old version serving, admission resumed, new
        replica shut down and invisible); after it ROLLS FORWARD (new
        version serving, old replica retired here). Every in-flight
        Future resolves either way.

        :attr:`last_publish` records each completed phase's seconds and
        its builds + graph captures (the process-wide
        :func:`~..telemetry.compile_count`)."""
        t0 = time.monotonic()
        with self._lock:
            entry = self._models.get(model)
            if entry is None:
                raise KeyError(f"unknown model {model!r}; registered: "
                               f"{sorted(self._models)}")
            if model in self._publishing:
                raise RuntimeError(
                    f"a publish for {model!r} is already in flight")
            self._publishing.add(model)
        try:
            return self._publish_locked(entry, model, version, arrays,
                                        run_dir, ckpt_dir, manifest,
                                        drain_timeout, verify, t0)
        finally:
            with self._lock:
                self._publishing.discard(model)

    def _publish_locked(self, entry, model, version, arrays, run_dir,
                        ckpt_dir, manifest, drain_timeout, verify, t0):
        if entry.builder is None:
            raise RuntimeError(
                f"model {model!r} was registered without a builder; "
                "publish() needs builder(arrays) -> server")
        if drain_timeout is None:
            drain_timeout = self.default_drain_s
        old = entry.active
        phase, committed, quiesced, new = "load", False, False, None
        log = self.last_publish = {"version": version, "phases": {},
                                   "compiles": {}}
        mark = [time.monotonic(), compile_count()]

        def done(phase):
            now, compiles = time.monotonic(), compile_count()
            log["phases"][phase] = now - mark[0]
            log["compiles"][phase] = compiles - mark[1]
            mark[:] = [now, compiles]
            self._stats.record_swap(model, phase, "ok")
            self._swap_event(model, phase, "ok", version)
        try:
            # load: resolve + read the sharded manifest. A missing /
            # torn / CRC-failing checkpoint dies HERE, before any
            # serving state moved.
            faults.point("fleet.publish:load")
            if arrays is None:
                arrays = self._load_arrays(run_dir, ckpt_dir, manifest,
                                           verify)
            done("load")

            # warm: build + warm the new replica OFF the serving path
            # (on the card: capture its graphs) — the old version
            # serves undisturbed meanwhile.
            phase = "warm"
            faults.point("fleet.publish:warm")
            srv = entry.builder(arrays)
            if _server_kind(srv) != entry.kind:
                raise TypeError(
                    f"builder for {model!r} returned a "
                    f"{_server_kind(srv)} server; entry is {entry.kind}")
            srv.warmup()
            srv.start()
            new = _Handle(version, srv, entry.kind)
            done("warm")

            # drain: flip NEW traffic to the new replica first (a
            # caller must never see a closed fleet), then quiesce the
            # old one — stop admitting, finish everything in flight.
            phase = "drain"
            faults.point("fleet.publish:drain")
            with self._lock:
                entry.route = new
            faults.point("fleet.drain")
            quiesced = True
            old.server.quiesce(timeout=drain_timeout)
            done("drain")

            # handover: THE commit point — active moves, the version
            # gauge moves, and from here failure rolls forward.
            phase = "handover"
            faults.point("fleet.publish:handover")
            with self._lock:
                entry.active = new
            committed = True
            self._stats.set_active_version(model, version)
            done("handover")

            # prune: retire the old replica. Anything that outlived a
            # bounded drain resolves TYPED here (evicted with partial
            # tokens / served from the queue), never dropped.
            phase = "prune"
            faults.point("fleet.publish:prune")
            self._retire(old)
            done("prune")
            self._stats.record_swap_seconds(model,
                                            time.monotonic() - t0)
            return version
        except BaseException:
            # InjectedCrash is a BaseException on purpose: the chaos
            # matrix exercises exactly this handler.
            if committed:
                self._stats.record_swap(model, phase, "failed")
                self._swap_event(model, phase, "failed", version)
                try:
                    self._retire(old)
                except Exception:
                    pass
                raise
            self._stats.record_swap(model, phase, "rolled_back")
            self._swap_event(model, phase, "rolled_back", version)
            if quiesced:
                old.server.resume()
            with self._lock:
                entry.route = entry.active
            if new is not None:
                try:
                    new.server.shutdown(drain=True)
                except Exception:
                    pass
            raise

    @staticmethod
    def _load_arrays(run_dir, ckpt_dir, manifest, verify):
        from ...convert import numpy_from_tensor
        from ...resilience.checkpoint import (latest_checkpoint,
                                              read_arrays)
        if ckpt_dir is None:
            if run_dir is None:
                raise ValueError(
                    "publish() needs arrays=, ckpt_dir=, or run_dir=")
            ckpt_dir, manifest = latest_checkpoint(run_dir)
            if ckpt_dir is None:
                raise FileNotFoundError(
                    f"no valid checkpoint under {run_dir!r}")
        arrays = read_arrays(ckpt_dir, manifest, verify_arrays=verify)
        # checkpoint reads come back as CPU tensors; builders get plain
        # host numpy, as the reference's do (fp8 and bf16 leaves as
        # |V1 / |V2 views, which deploy.params_from_arrays and
        # convert.tensor_from_numpy read back)
        return {k: numpy_from_tensor(v) for k, v in arrays.items()}

    def _retire(self, handle):
        """Close a replaced replica. After a successful quiesce this
        is instantaneous (nothing queued, nothing live); after a
        drain-deadline quiesce the LLM path evicts stragglers NOW,
        typed with their partial tokens, while the single-shot path
        serves out its bounded queue."""
        if handle.kind == "llm":
            handle.server.shutdown(drain=True, deadline_ms=0)
        else:
            handle.server.shutdown(drain=True)

    # ----------------------------------------------------- lifecycle --
    def shutdown(self, drain=True):
        """Close every hosted server (drained by default). Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            handles = []
            for entry in self._models.values():
                handles.append(entry.active)
                if entry.route is not entry.active:
                    handles.append(entry.route)
        for handle in handles:
            try:
                handle.server.shutdown(drain=drain)
            except Exception:
                pass

    close = shutdown

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

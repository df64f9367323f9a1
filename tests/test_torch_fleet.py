"""PyTorch port, the zero-downtime fleet: ``mxnet_tpu_torch.serving.fleet``'s
``FleetRouter`` (atomic weight hot-swap, per-tenant quotas, priority
lanes), ``quiesce()``/``resume()`` and the fine-tune -> publish loop
(the port of ``tests/test_fleet.py``), on the CPU.

The chat model is that file's 1-layer ``TinyDecoder`` (vocab 17,
d_model 16, 2 heads, blocks of 8, context 32) built by the port, its
v1/v2 weights the JAX model's ``init_params(0)`` / ``init_params(1)``;
every served stream is held token for token against the JAX package's
``greedy_decode_reference`` over the same numpy params. The rank model
is a numpy ``tanh(x @ W)`` behind a ``ModelServer``; the fine-tune loop
trains a port ``Dense`` with the port's ``Trainer`` and serves it as a
gluon block, held against the JAX Trainer's steps on the same data.

The reference marks the crash matrix and the bounded-drain eviction
``slow``: they are slow there only because of XLA compiles. On the
port's eager CPU engine the whole matrix takes about a second a row,
so nothing here is marked slow. ``test_fleet_replay_capacity`` is not
ported: it needs ``tools/load_replay.py`` in port mode.

On the CPU nothing is built or captured, so the reference's
``CompileCounter`` assertion holds as it stands; on the card a
published replica's warm phase captures its own graphs
(``tests/test_torch_cuda.py``).
"""
import os
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.autograd as jag  # noqa: E402
from mxnet_tpu import gluon as jgluon, nd  # noqa: E402
from mxnet_tpu.serving import llm as jllm  # noqa: E402
from mxnet_tpu.serving.adapters import AdapterBank as JBank  # noqa: E402
from mxnet_tpu_torch import deploy, serving  # noqa: E402
from mxnet_tpu_torch.convert import (load_gluon_params,  # noqa: E402
                                     tensor_from_numpy)
from mxnet_tpu_torch.gluon import Trainer, loss as tloss  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tnn  # noqa: E402
from mxnet_tpu_torch.observability import get_registry  # noqa: E402
from mxnet_tpu_torch.resilience import (CheckpointManager,  # noqa: E402
                                        faults)
from mxnet_tpu_torch.resilience.checkpoint import (  # noqa: E402
    latest_checkpoint)
from mxnet_tpu_torch.resilience.faults import InjectedCrash  # noqa: E402
from mxnet_tpu_torch.serving import (  # noqa: E402
    DeadlineExceededError, Overloaded, SequenceEvictedError,
    ServerClosed)
from mxnet_tpu_torch.serving import llm as tllm  # noqa: E402
from mxnet_tpu_torch.serving.adapters import (  # noqa: E402
    AdapterBank, UnknownAdapterError)
from mxnet_tpu_torch.serving.fleet import FineTunePublisher  # noqa: E402

torch.set_num_threads(2)

VOCAB, BS, CTX, DIM = 17, 8, 32, 4
CFG = dict(vocab_size=VOCAB, d_model=16, num_layers=1, num_heads=2,
           d_ff=32, max_context=CTX)


@pytest.fixture(autouse=True)
def _reset_faults():
    faults.reset()
    yield
    faults.reset()


def _expo():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from metrics_dump import parse_exposition
    finally:
        sys.path.pop(0)
    return parse_exposition(get_registry().expose())


class Kit:
    """Module-scoped kit: the JAX decoder (the oracle), the port's
    decoder object every chat replica shares, v1/v2 numpy params, the
    rank model's weights."""

    def __init__(self):
        self.jmodel = jllm.TinyDecoder(jllm.DecoderConfig(**CFG))
        self.model = tllm.TinyDecoder(tllm.DecoderConfig(**CFG),
                                      device="cpu")
        self.params1 = self.jmodel.init_params(0)
        self.params2 = self.jmodel.init_params(1)
        self.w1 = np.random.RandomState(7).randn(DIM, DIM) \
            .astype(np.float32)
        self._memo = {}

    def ref(self, params, prompt, n):
        key = (id(params), tuple(prompt), n)
        if key not in self._memo:
            self._memo[key] = list(jllm.greedy_decode_reference(
                self.jmodel, params, prompt, n))
        return self._memo[key]

    # publish() hands builders the FLAT checkpoint array dict; the chat
    # builder restores the decoder tree from it
    def chat_builder(self, name, **kw):
        def build(arrays):
            return tllm.LLMServer(self.model,
                                  deploy.params_from_arrays(arrays),
                                  name=name, max_seqs=2, block_size=BS,
                                  max_context=CTX, device="cpu", **kw)
        return build

    def rank_builder(self, name):
        def build(arrays):
            w = np.asarray(arrays["w"], np.float32)
            return serving.ModelServer(
                lambda batch: np.tanh(batch @ w),
                buckets=[1, 2], max_delay_ms=1.0, item_shape=(DIM,),
                dtype="float32", name=name)
        return build

    def chat_router(self, tag_, **router_kw):
        build = self.chat_builder(f"fc_{tag_}")
        srv = build(deploy.flatten_params(self.params1))
        srv.warmup()
        srv.start()
        router = serving.FleetRouter(name=f"fleet_{tag_}", **router_kw)
        router.add_model("chat", srv, version=1, builder=build)
        return router

    def rank_router(self, tag_, **router_kw):
        build = self.rank_builder(f"fr_{tag_}")
        srv = build({"w": self.w1})
        srv.warmup()
        srv.start()
        router = serving.FleetRouter(name=f"fleet_{tag_}", **router_kw)
        router.add_model("rank", srv, version=1, builder=build)
        return router


@pytest.fixture(scope="module")
def kit():
    return Kit()


# ------------------------------------------------- quiesce / resume --
def test_quiesce_resume_model_server(kit):
    srv = kit.rank_builder("fq1")({"w": kit.w1})
    srv.warmup()
    srv.start()
    x = np.ones(DIM, np.float32)
    gate = faults.block_at("serving.dispatch")
    f1 = srv.submit(x)
    assert gate.wait_reached(30)
    assert srv.quiesce(timeout=0.2) is False
    assert not srv.admitting
    with pytest.raises(ServerClosed, match="quiesced"):
        srv.submit(x)
    gate.release()
    assert srv.quiesce(timeout=30) is True
    np.testing.assert_allclose(f1.result(timeout=30),
                               np.tanh(x @ kit.w1), rtol=1e-5)
    srv.resume()
    assert srv.admitting
    np.testing.assert_allclose(srv.submit(x).result(timeout=30),
                               np.tanh(x @ kit.w1), rtol=1e-5)
    srv.shutdown()


def test_quiesce_resume_llm_server(kit):
    srv = kit.chat_builder("fq2")(deploy.flatten_params(kit.params1))
    srv.warmup()
    srv.start()
    gate = faults.block_at("llm.decode")
    f1 = srv.submit([1, 2, 3], 4)
    assert gate.wait_reached(30)
    assert srv.quiesce(timeout=0.2) is False
    with pytest.raises(ServerClosed, match="quiesced"):
        srv.submit([1], 1)
    gate.release()
    assert srv.quiesce(timeout=60) is True
    assert f1.result(timeout=30).tokens == kit.ref(kit.params1,
                                                   [1, 2, 3], 4)
    srv.resume()
    assert srv.admitting
    assert srv.submit([2, 3], 2).result(timeout=30).tokens \
        == kit.ref(kit.params1, [2, 3], 2)
    srv.shutdown()


# ------------------------------------------------------- hot swap --
def _pump_and_publish(kit, router, publish):
    """Two threads submit 24 chat prompts while ``publish()`` runs;
    returns (outcome counts, untyped submit errors, prompts)."""
    prompts = [[(i % (VOCAB - 1)) + 1, ((i + 3) % (VOCAB - 1)) + 1]
               for i in range(24)]
    futs, errs = [], []
    outcomes = dict.fromkeys(("served", "shed", "evicted", "expired"), 0)
    olock = threading.Lock()

    def pump(k):
        for i in range(k, len(prompts), 2):
            try:
                fut = router.submit("chat", prompts[i], 4,
                                    tenant=f"t{i % 3}")
                with olock:
                    futs.append((prompts[i], fut))
            except Overloaded:
                with olock:
                    outcomes["shed"] += 1
            except Exception as exc:        # pragma: no cover
                errs.append(exc)
            time.sleep(0.02)

    threads = [threading.Thread(target=pump, args=(k,))
               for k in range(2)]
    for th in threads:
        th.start()
    time.sleep(0.05)
    publish()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    served = []
    for prompt, f in futs:
        try:
            res = f.result(timeout=60)
            outcomes["served"] += 1
            served.append((prompt, res.tokens))
        except SequenceEvictedError:
            outcomes["evicted"] += 1
        except Overloaded:
            outcomes["shed"] += 1
        except DeadlineExceededError:
            outcomes["expired"] += 1
    return outcomes, errs, prompts, served


def test_hot_swap_zero_loss_bitexact(kit):
    """Publish v2 while two threads submit: no compile (the CPU captures
    nothing), every Future typed, the partition exact, every served
    stream one version's oracle, post-swap streams the v2 oracle."""
    router = kit.chat_router("swap")
    with serving.CompileCounter() as cc:
        outcomes, errs, prompts, served = _pump_and_publish(
            kit, router, lambda: router.publish(
                "chat", 2, arrays=deploy.flatten_params(kit.params2)))
    assert cc.count == 0
    assert not errs, errs
    assert sum(outcomes.values()) == len(prompts)
    assert outcomes["served"] >= 1
    for prompt, tokens in served:
        assert tokens in (kit.ref(kit.params1, prompt, 4),
                          kit.ref(kit.params2, prompt, 4))
    assert router.active_version("chat") == 2
    for p in prompts[:2]:
        assert router.generate("chat", p, 5, timeout=60).tokens \
            == kit.ref(kit.params2, p, 5)
    assert router.server("chat").engine.cache.check(live_block_ids=[])
    log = router.last_publish
    assert log["version"] == 2
    assert list(log["phases"]) == list(serving.fleet.PUBLISH_PHASES)
    assert all(v == 0 for v in log["compiles"].values())
    router.shutdown()


def test_hot_swap_from_a_sharded_checkpoint(kit, tmp_path):
    """v2 written through a 2-shard checkpoint and published with
    ``ckpt_dir=`` (then v1 again with ``run_dir=``): ``_load_arrays``
    hands the builder host numpy, the streams follow the oracle."""
    router = kit.chat_router("ckpt")
    mgr = CheckpointManager(str(tmp_path), async_=False, num_shards=2)
    ckpt = mgr.save(deploy.flatten_params(kit.params2), step=1)
    assert any(f.startswith("shard-") for f in os.listdir(ckpt))
    outcomes, errs, prompts, _ = _pump_and_publish(
        kit, router, lambda: router.publish("chat", 2, ckpt_dir=ckpt))
    assert not errs and sum(outcomes.values()) == len(prompts)
    assert router.generate("chat", [4, 5], 4, timeout=60).tokens \
        == kit.ref(kit.params2, [4, 5], 4)
    mgr.save(deploy.flatten_params(kit.params1), step=2)
    assert router.publish("chat", 3, run_dir=str(tmp_path)) == 3
    assert router.generate("chat", [4, 5], 4, timeout=60).tokens \
        == kit.ref(kit.params1, [4, 5], 4)
    with pytest.raises(FileNotFoundError):
        router.publish("chat", 4, run_dir=str(tmp_path / "empty"))
    assert router.active_version("chat") == 3
    router.shutdown()


def test_load_arrays_keeps_16bit_leaves(tmp_path):
    """A bf16 leaf comes out of a sharded checkpoint as a |V2 numpy view
    (fp8 has no dtype code in the checkpoint format; its |V1 view is
    ``convert.numpy_from_tensor``'s too), which
    ``convert.tensor_from_numpy`` reads back to the same bits."""
    from mxnet_tpu_torch.convert import numpy_from_tensor
    g = torch.Generator().manual_seed(3)
    arrays = {"a": torch.randn(6, 4, generator=g).to(torch.bfloat16),
              "c": torch.randn(7, generator=g)}
    ckpt = CheckpointManager(str(tmp_path), async_=False,
                             num_shards=2).save(arrays, step=1)
    host = serving.FleetRouter._load_arrays(None, ckpt, None, True)
    assert {k: v.dtype.str for k, v in host.items()} == \
        {"a": "|V2", "c": "<f4"}
    fp8 = torch.randn(5, 3, generator=g).to(torch.float8_e4m3fn)
    host["b"], arrays["b"] = numpy_from_tensor(fp8), fp8
    assert host["b"].dtype.str == "|V1"
    for k, t in arrays.items():
        back = tensor_from_numpy(host[k], "cpu")
        assert back.dtype == t.dtype
        assert torch.equal(back.view(torch.uint8), t.view(torch.uint8))


def test_kill_mid_swap_rolls_back(kit):
    router = kit.chat_router("kill")
    old_srv = router.server("chat")
    faults.crash_at_point("fleet.publish:drain")
    f = router.submit("chat", [1, 2], 3)
    with pytest.raises(InjectedCrash):
        router.publish("chat", 2,
                       arrays=deploy.flatten_params(kit.params2))
    assert router.active_version("chat") == 1
    assert router.server("chat") is old_srv
    assert old_srv.admitting
    assert f.result(timeout=30).tokens == kit.ref(kit.params1, [1, 2], 3)
    assert router.generate("chat", [3], 2, timeout=30).tokens \
        == kit.ref(kit.params1, [3], 2)
    samples = _expo()
    key = ("mxtpu_fleet_swap_total",
           (("fleet", "fleet_kill"), ("model", "chat"),
            ("outcome", "rolled_back"), ("phase", "drain")))
    assert samples.get(key) == 1
    router.shutdown()


CRASH_SITES = ("fleet.publish:load", "fleet.publish:warm",
               "fleet.publish:drain", "fleet.drain",
               "fleet.publish:handover", "fleet.publish:prune")


@pytest.mark.parametrize("site", CRASH_SITES)
def test_publish_crash_matrix(kit, site):
    """A crash at each publish phase boundary (and the route-flip /
    quiesce gap) with requests in flight: before the handover commit
    the fleet rolls back (v1 serving, admission open, every Future
    served as the v1 oracle); at prune it rolls forward (v2 serving,
    the old replica retired typed, both pools clean)."""
    tag_ = "matrix_" + site.replace(":", "_").replace(".", "_")
    router = kit.chat_router(tag_)
    old_srv = router.server("chat")
    faults.crash_at_point(site)
    futs = [router.submit("chat", [1, 2], 3),
            router.submit("chat", [4], 2)]
    with pytest.raises(InjectedCrash):
        router.publish("chat", 2,
                       arrays=deploy.flatten_params(kit.params2))
    assert futs[0].result(timeout=60).tokens \
        == kit.ref(kit.params1, [1, 2], 3)
    assert futs[1].result(timeout=60).tokens \
        == kit.ref(kit.params1, [4], 2)
    samples = _expo()
    phase = site.split(":")[-1] if ":" in site else "drain"
    if site != "fleet.publish:prune":
        assert router.active_version("chat") == 1
        srv = router.server("chat")
        assert srv is old_srv and srv.admitting
        assert router.generate("chat", [5], 2, timeout=60).tokens \
            == kit.ref(kit.params1, [5], 2)
        assert srv.engine.cache.check(live_block_ids=[])
        outcome = "rolled_back"
    else:
        assert router.active_version("chat") == 2
        new_srv = router.server("chat")
        assert new_srv is not old_srv
        assert router.generate("chat", [1, 2], 3, timeout=60).tokens \
            == kit.ref(kit.params2, [1, 2], 3)
        assert not old_srv.admitting
        with pytest.raises(ServerClosed):
            old_srv.submit([1], 1)
        assert old_srv.engine.cache.check(live_block_ids=[])
        assert new_srv.engine.cache.check(live_block_ids=[])
        outcome = "failed"
    key = ("mxtpu_fleet_swap_total",
           (("fleet", f"fleet_{tag_}"), ("model", "chat"),
            ("outcome", outcome), ("phase", phase)))
    assert samples.get(key) == 1
    router.shutdown()


def test_bounded_drain_evicts_typed(kit):
    router = kit.chat_router("evict")
    old_srv = router.server("chat")
    faults.delay_at("llm.decode", 0.1)
    straggler = router.submit("chat", [1, 2], 28)
    time.sleep(0.3)
    with serving.CompileCounter() as cc:
        assert router.publish(
            "chat", 2, arrays=deploy.flatten_params(kit.params2),
            drain_timeout=0.05) == 2
    faults.reset()
    assert cc.count == 0
    with pytest.raises(SequenceEvictedError) as ei:
        straggler.result(timeout=60)
    assert isinstance(ei.value.tokens, list)
    assert router.active_version("chat") == 2
    assert router.generate("chat", [3], 2, timeout=60).tokens \
        == kit.ref(kit.params2, [3], 2)
    assert old_srv.engine.cache.check(live_block_ids=[])
    router.shutdown()


def test_publish_refuses_without_builder_or_twice(kit):
    router = serving.FleetRouter(name="fleet_refuse")
    srv = kit.rank_builder("fr_refuse")({"w": kit.w1}).start()
    router.add_model("rank", srv, version=1)
    with pytest.raises(ValueError, match="already registered"):
        router.add_model("rank", srv)
    with pytest.raises(RuntimeError, match="without a builder"):
        router.publish("rank", 2, arrays={"w": kit.w1})
    with pytest.raises(KeyError):
        router.publish("nope", 2, arrays={})
    with pytest.raises(KeyError):
        router.submit("nope", np.ones(DIM, np.float32))
    st = router.debug_status()
    assert st["models"]["rank"]["active_version"] == 1
    assert not st["models"]["rank"]["swapping"]
    router.shutdown()
    with pytest.raises(ServerClosed):
        router.submit("rank", np.ones(DIM, np.float32))


# -------------------------------------------------- quotas and lanes --
def test_quota_shed_isolation(kit):
    router = kit.rank_router("quota", quota_rps=0.001, quota_burst=2)
    x = np.ones(DIM, np.float32)
    greedy = [router.submit("rank", x, tenant="greedy")
              for _ in range(2)]
    with pytest.raises(Overloaded) as ei:
        router.submit("rank", x, tenant="greedy")
    assert ei.value.reason == "quota"
    ok = [router.submit("rank", x, tenant="polite"),
          router.submit("rank", x)]
    for f in greedy + ok:
        np.testing.assert_allclose(f.result(timeout=30),
                                   np.tanh(x @ kit.w1), rtol=1e-5)
    samples = _expo()
    key = ("mxtpu_fleet_quota_shed_total",
           (("fleet", "fleet_quota"), ("tenant", "greedy")))
    assert samples.get(key) == 1
    router.shutdown()


def test_batch_lane_depth_cap(kit):
    router = kit.rank_router("lane", batch_lane_depth=1)
    x = np.ones(DIM, np.float32)
    gate = faults.block_at("serving.dispatch")
    f1 = router.submit("rank", x, lane="batch")
    assert gate.wait_reached(30)
    with pytest.raises(Overloaded) as ei:
        router.submit("rank", x, lane="batch")
    assert ei.value.reason == "lane_full"
    f2 = router.submit("rank", x)
    with pytest.raises(ValueError, match="unknown lane"):
        router.submit("rank", x, lane="bulk")
    gate.release()
    for f in (f1, f2):
        np.testing.assert_allclose(f.result(timeout=30),
                                   np.tanh(x @ kit.w1), rtol=1e-5)
    router.shutdown()


def test_route_poison_surfaces_typed(kit):
    router = kit.rank_router("poison")
    x = np.ones(DIM, np.float32)
    faults.script("fleet.route",
                  [Overloaded("injected upstream shed", reason="quota")])
    with pytest.raises(Overloaded):
        router.submit("rank", x)
    np.testing.assert_allclose(router.generate("rank", x, timeout=30),
                               np.tanh(x @ kit.w1), rtol=1e-5)
    router.shutdown()


def test_env_var_config(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FLEET_QUOTA_RPS", "5")
    monkeypatch.setenv("MXNET_TPU_FLEET_BATCH_DEPTH", "3")
    monkeypatch.setenv("MXNET_TPU_FLEET_DRAIN_MS", "250")
    router = serving.FleetRouter(name="fleet_env")
    assert router._quota.rate == 5.0 and router._quota.burst == 10.0
    assert router.batch_lane_depth == 3
    assert router.default_drain_s == pytest.approx(0.25)
    router.shutdown()


# ------------------------------------------- fine-tune -> publish ----
def test_finetune_publish_loop(kit, tmp_path):
    """Port ``Trainer.compile_step`` steps (SGD, ``L2Loss``), as
    ``tests/test_fleet.py`` trains -> sharded-manifest checkpoint ->
    publish into the live router, whose builder serves a fresh gluon
    ``Dense`` from the checkpoint's arrays; the served output is the
    trained weights', and the trained weights are the JAX Trainer's
    after the same 4 steps on the same data (1e-6: the same f32 SGD
    arithmetic, sums in another order). One registry carries the
    training steps (``mxtpu_train_step_dispatch_total``: one a step)
    and the swaps."""
    mx.random.seed(3)
    # explicit prefixes: a root block named by the process-wide counter
    # would shift the names (and the sorted order) of later tests' blocks
    jnet = jgluon.nn.Dense(DIM, prefix="ft_")
    jnet.initialize()
    rng = np.random.RandomState(5)
    X = rng.randn(8, DIM).astype(np.float32)
    Y = rng.randn(8, DIM).astype(np.float32)
    with jag.pause(train_mode=False):
        jnet(nd.array(X[:1]))
    arrays0 = {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()}
    net = tnn.Dense(DIM, prefix="ft_")
    net.initialize(device="cpu")
    load_gluon_params(net, arrays0)
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.05})
    loss = tloss.L2Loss()
    step = tr.compile_step(lambda a, b: loss(net(a), b))
    dispatch = get_registry().counter("mxtpu_train_step_dispatch_total")
    d0 = dispatch.value

    def train_step():
        step(torch.from_numpy(X), torch.from_numpy(Y))

    def get_arrays():
        return {k: p.data().detach().numpy().copy()
                for k, p in net.collect_params().items()}

    def build(arrays):
        blk = tnn.Dense(DIM, activation="tanh", prefix="ft_")
        blk.initialize(device="cpu")
        load_gluon_params(blk, arrays)
        return serving.ModelServer(
            blk, buckets=[1, 2], max_delay_ms=1.0, item_shape=(DIM,),
            dtype="float32", name="fleet_ft_m")

    srv = build(get_arrays())
    srv.warmup()
    srv.start()
    router = serving.FleetRouter(name="fleet_ft")
    router.add_model("m", srv, version=0, builder=build)
    pub = FineTunePublisher(router, "m", train_step, get_arrays,
                            str(tmp_path), steps_per_publish=2,
                            num_shards=2, version_start=1)
    assert pub.run(rounds=2) == 2
    assert pub.step == 4
    assert router.active_version("m") == 2
    arrays = get_arrays()
    wk = next(k for k in arrays if k.endswith("weight"))
    bk = next(k for k in arrays if k.endswith("bias"))
    x = np.ones(DIM, np.float32)
    np.testing.assert_allclose(
        router.generate("m", x, timeout=30),
        np.tanh(x @ arrays[wk].T + arrays[bk]), rtol=1e-5, atol=1e-6)
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd",
                         {"learning_rate": 0.05})
    jloss = jgluon.loss.L2Loss()
    for _ in range(4):
        with jag.record():
            out = jloss(jnet(nd.array(X)), nd.array(Y))
        out.backward()
        jtr.step(len(X))
    for k, p in jnet.collect_params().items():
        np.testing.assert_allclose(arrays[k], p.data().asnumpy(),
                                   rtol=1e-6, atol=1e-6)
    ckpt_dir, _manifest = latest_checkpoint(str(tmp_path))
    assert ckpt_dir is not None
    assert any(f.startswith("shard-") for f in os.listdir(ckpt_dir))
    samples = _expo()
    key = ("mxtpu_fleet_swap_total",
           (("fleet", "fleet_ft"), ("model", "m"),
            ("outcome", "ok"), ("phase", "handover")))
    assert samples.get(key) == 2
    assert step.last_reason is None
    assert dispatch.value - d0 == 4
    assert samples.get(("mxtpu_train_step_dispatch_total", ())) == \
        dispatch.value
    router.shutdown()


# ------------------------------------------------ adapters through --
def test_fleet_router_plumbs_adapter_through(kit):
    """``FleetRouter.submit(..., adapter=)`` reaches the backing
    ``LLMServer`` untouched (``tests/test_adapters.py:452``): routed
    generation matches the per-adapter oracle of the JAX package;
    unknown names fail typed at the router's front door."""
    D, L = CFG["d_model"], CFG["num_layers"]
    jb = JBank(L, D, max_adapters=4, page_rank=4)
    tb = AdapterBank(L, D, max_adapters=4, page_rank=4, device="cpu")
    rng = np.random.RandomState(2)
    a = (rng.randn(L, 4, D, 8) * 0.05).astype(np.float32)
    b = (rng.randn(L, 4, 8, D) * 0.05).astype(np.float32)
    assert jb.publish("bob", a, b, alpha=4.0) == \
        tb.publish("bob", a, b, alpha=4.0)
    srv = tllm.LLMServer(kit.model, kit.params1, name="adapters_fleet",
                         max_seqs=4, block_size=BS, max_context=CTX,
                         prefix_cache=True, adapter_bank=tb, device="cpu")
    srv.warmup()
    srv.start()
    router = serving.FleetRouter(name="fleet_adapters")
    router.add_model("chat", srv, version=1)
    try:
        prompt = [3, 1, 4, 1, 5]
        out = router.generate("chat", prompt, 6, adapter="bob",
                              timeout=60, tenant="acme")
        assert out.tokens == list(jllm.greedy_decode_reference(
            kit.jmodel, kit.params1, prompt, 6,
            lora=jb.adapter_arrays("bob")))
        base = router.generate("chat", prompt, 6, timeout=60)
        assert base.tokens == kit.ref(kit.params1, prompt, 6)
        with pytest.raises(UnknownAdapterError):
            router.submit("chat", prompt, 2, adapter="ghost")
    finally:
        router.shutdown()
    assert tb.stats()["in_use"] == 0 and tb.check()


# ------------------------------------------------ metric families --
def test_metric_family_names_equal_reference(kit):
    """The ``mxtpu_fleet_*`` and ``mxtpu_serving_*`` families a fleet
    publishes equal the reference's, by name and kind."""
    from mxnet_tpu import serving as jserving
    from mxnet_tpu.observability import get_registry as jget_registry

    def families(registry, prefixes):
        return {m.name: type(m).__name__ for m in registry.metrics()
                if m.name.startswith(prefixes)}

    for pkg, tag_ in ((jserving, "jax"), (serving, "torch")):
        router = pkg.FleetRouter(name=f"fleet_names_{tag_}",
                                 quota_rps=0.001, quota_burst=1)
        srv = pkg.ModelServer(lambda b: b, buckets=[1], item_shape=(2,),
                              dtype="float32", name=f"names_{tag_}")
        srv.start()
        router.add_model("m", srv, version=1,
                         builder=lambda arrays, p=pkg, t=tag_:
                         p.ModelServer(lambda b: b, buckets=[1],
                                       item_shape=(2,), dtype="float32",
                                       name=f"names2_{t}"))
        router.generate("m", np.zeros(2, np.float32), timeout=30,
                        tenant="x")
        with pytest.raises(pkg.Overloaded):
            router.submit("m", np.zeros(2, np.float32), tenant="x")
        router.publish("m", 2, arrays={})
        router.shutdown()
    prefixes = ("mxtpu_fleet_", "mxtpu_serving_")
    ours = families(get_registry(), prefixes)
    theirs = families(jget_registry(), prefixes)
    assert ours == theirs
    assert {"mxtpu_fleet_swap_total", "mxtpu_fleet_swap_seconds",
            "mxtpu_fleet_routed_total", "mxtpu_fleet_quota_shed_total",
            "mxtpu_fleet_lane_depth", "mxtpu_fleet_active_version",
            "mxtpu_serving_bucket_hits_total",
            "mxtpu_serving_latency_seconds"} <= set(ours)

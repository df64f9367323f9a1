"""PyTorch port, ``mx.profiler`` over ``torch.profiler``
(``mxnet_tpu_torch/profiler.py``) and the trace rollup
(``mxnet_tpu_torch/observability/rollup.py``), on the cases of
``tests/test_profiler.py``:

- a capture of real work writes ``<filename>/plugins/profile/<run>/
  <host>.trace.json.gz``; ``dumps()`` gives the reference's table header
  and ``{name: (total_us, count)}`` dict; on the CPU there is no device
  event, so ``dumps()`` falls back to the host lanes, as the reference's
  does on a CPU backend; Block scopes and ``scope``/``host_scope`` ranges
  are on the host lane while the capture runs, and only then;
- state transitions (``run``/``stop``, ``pause``/``resume`` each a new
  capture section, ``dump``), ``scopes_enabled``;
- config validation: the same exception types and messages as the
  reference's;
- lanes by event category (``kernel``/``gpu_memcpy``/``gpu_memset``
  device, ``cpu_op``/``user_annotation``/``python_function`` host, else
  unknown) on a synthetic trace, with ``lane='both'``;
- the rollup of a synthetic card trace (the port's kernels, library GEMMs
  and convolutions, torch's elementwise kernels) into families, and
  ``summary``/``diff``/``family_table`` with the reference's shapes and
  values; the CPU capture is refused as a device trace and rolled up on
  request as a host one.
"""
import glob
import gzip
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

from mxnet_tpu import profiler as jprof  # noqa: E402
from mxnet_tpu.observability import rollup as jroll  # noqa: E402
from mxnet_tpu_torch import autograd as tag  # noqa: E402
from mxnet_tpu_torch import profiler as tprof  # noqa: E402
from mxnet_tpu_torch.gluon import nn  # noqa: E402
from mxnet_tpu_torch.observability import rollup as troll  # noqa: E402

torch.set_num_threads(2)

SUMMARY_KEYS = {"trace", "steps", "device_ms_per_step", "families"}


@pytest.fixture
def out(tmp_path, monkeypatch):
    path = str(tmp_path / "prof")
    monkeypatch.setitem(tprof._config, "filename", path)
    yield path
    tprof.set_state("stop")


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """One capture of three forwards of a small MLP inside
    ``scope('bench_region')`` and a ``host_scope``."""
    path = str(tmp_path_factory.mktemp("cap") / "prof")
    saved = dict(tprof._config)
    tprof.set_config(filename=path, aggregate_stats=True)
    net = nn.HybridSequential(prefix="profmlp_")
    with net.name_scope():
        net.add(nn.Dense(32, activation="relu"), nn.Dense(8))
    net.initialize(device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(16, 12)
                         .astype(np.float32))
    with tag.pause():
        net(x)                       # deferred shapes outside the capture
    states = [tprof.state()]
    tprof.set_state("run")
    states += [tprof.state(), tprof.scopes_enabled()]
    with tprof.scope("bench_region"):
        with tprof.host_scope("mxtpu.bench.host"):
            with tag.pause():
                for _ in range(3):
                    y = net(x)
        float(y.sum())
    tprof.set_state("stop")
    states += [tprof.state(), tprof.scopes_enabled()]
    result = {"dir": path, "states": states,
              "table": tprof.dumps(), "dict": tprof.dumps(format_="dict"),
              "both": tprof.dumps(format_="dict", lane="both"),
              "net": net, "x": x}
    tprof._config.clear()
    tprof._config.update(saved)
    return result


def test_capture_states_and_trace_layout(capture):
    assert capture["states"] == ["stop", "run", True, "stop", False]
    files = glob.glob(os.path.join(capture["dir"], "plugins", "profile",
                                   "*", "*.trace.json.gz"))
    assert len(files) == 1
    assert os.path.basename(files[0]).endswith(".trace.json.gz")
    with gzip.open(files[0]) as f:
        assert json.load(f)["traceEvents"]
    assert troll.find_trace(capture["dir"]) == files[0]


def test_dumps_header_and_dict_shape_fall_back_to_host(capture):
    assert capture["table"].splitlines()[0] == \
        f"{'Name':<48} {'Total(us)':>12} {'Count':>8} {'Avg(us)':>10}"
    stats = capture["dict"]
    assert isinstance(stats, dict) and stats
    for total, count in stats.values():
        assert count > 0 and total >= 0
    both = capture["both"]
    assert both["device"]["count"] == 0          # the CPU has no card
    assert stats == both["host"]["ops"] | both["unknown"]["ops"]
    assert set(both) == {"device", "host", "unknown"}


def test_scopes_and_block_ranges_on_the_host_lane(capture):
    host = capture["both"]["host"]["ops"]
    for name in ("bench_region", "mxtpu", "profmlp_dense0",
                 "profmlp_dense1", "profmlp"):
        assert name in host, (name, sorted(host))
    assert host["profmlp_dense0"][1] == 3


def test_block_scopes_only_while_capturing(capture):
    assert not tprof.scopes_enabled()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        with tag.pause():
            capture["net"](capture["x"])
    names = {e.name for e in p.events()}
    assert "profmlp_dense0" not in names      # no mx.profiler capture


def test_rollup_refuses_a_cpu_capture_as_device_time(capture):
    with pytest.raises(troll.RollupError, match="not a capture of the card"):
        troll.rollup(capture["dir"])
    with pytest.raises(troll.RollupError, match="not a capture of the card"):
        troll.summary(capture["dir"], steps=3)


def test_pause_resume_make_new_sections(out):
    tprof.set_state("run")
    tprof.pause()
    assert tprof.state() == "stop"
    tprof.resume()
    assert tprof.state() == "run"
    tprof.dump(finished=True)
    assert tprof.state() == "stop"
    runs = glob.glob(os.path.join(out, "plugins", "profile", "*"))
    assert len(runs) == 2
    for r in runs:
        assert len(glob.glob(os.path.join(r, "*.trace.json.gz"))) == 1


@pytest.mark.parametrize("call", [
    lambda p: p.set_config(not_an_option=True),
    lambda p: p.set_config(filename="x", bogus=1, also_bogus=2),
    lambda p: p.set_state("bogus"),
    lambda p: p.profiler_set_state("Run"),
    lambda p: p.dumps(lane="both"),
    lambda p: p.dumps(format_="dict", lane="bogus"),
], ids=["unknown_option", "unknown_options", "bad_state", "alias_state",
        "both_needs_dict", "bad_lane"])
def test_validation_errors_match_the_reference(call, tmp_path,
                                               monkeypatch):
    monkeypatch.setitem(jprof._config, "filename", str(tmp_path / "j"))
    monkeypatch.setitem(tprof._config, "filename", str(tmp_path / "t"))
    with pytest.raises(ValueError) as jerr:
        call(jprof)
    with pytest.raises(ValueError) as terr:
        call(tprof)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


def _write(path, events):
    run = os.path.join(path, "plugins", "profile", "run")
    os.makedirs(run, exist_ok=True)
    trace = os.path.join(run, "host.trace.json.gz")
    with gzip.open(trace, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return trace


def test_dumps_lane_classification(out):
    events = [
        {"ph": "X", "cat": "kernel", "name": "void flash_fwd_kernel<64>",
         "dur": 100.0, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "dur": 4.0, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 30.0,
         "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "mxtpu.train_step",
         "dur": 50.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "dur": 7.0, "pid": 1, "tid": 1},
        {"ph": "i", "cat": "kernel", "name": "instant", "pid": 0},
    ]
    _write(out, events)
    dev = tprof.dumps(format_="dict")
    assert dev == {"void flash_fwd_kernel<64>": (100.0, 1),
                   "Memcpy HtoD": (4.0, 1)}
    both = tprof.dumps(format_="dict", lane="both")
    assert both["device"]["total_us"] == 104.0
    assert both["host"]["ops"] == {"aten::mm": (30.0, 1),
                                   "mxtpu": (50.0, 1)}
    assert both["unknown"]["ops"] == {"cudaLaunchKernel": (7.0, 1)}
    assert tprof.dumps(format_="dict", lane="host") == \
        both["host"]["ops"]
    _write(out, [e for e in events if e.get("pid") != 0])
    assert tprof.dumps(format_="dict") == {
        "aten::mm": (30.0, 1), "mxtpu": (50.0, 1),
        "cudaLaunchKernel": (7.0, 1)}


CARD_EVENTS = [
    ("void flash_fwd_kernel<64, 64, false>(FlashParams)", 120.0),
    ("void flash_dkv_kernel<64>(FlashBwdParams)", 200.0),
    ("void flash_dq_kernel<64>(FlashBwdParams)", 150.0),
    ("void flash_fwd_sm90_kernel<__nv_bfloat16, 64>(Params)", 60.0),
    ("void multi_update_kernel<3, float>(Row const*, int)", 40.0),
    ("void paged_ring_kernel<ChunkTiles, 2>(Args)", 30.0),
    ("void wq_mma_kernel<int8_t, 4>(Args)", 20.0),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNN", 500.0),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32", 250.0),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwkc", 300.0),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >"
     "(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)",
     45.0),
    ("void at::native::reduce_kernel<512, 1, "
     "at::native::ReduceOp<float, at::native::func_wrapper_t<float> > >"
     "(at::native::ReduceOp<float>)", 15.0),
    ("void at::native::(anonymous namespace)::softmax_warp_forward<"
     "float, float, float, 9, false, false>(float*, float const*, int)",
     25.0),
]
FAMILIES = {"flash_fwd": 120.0, "flash_bwd_dkv": 200.0,
            "flash_bwd_dq": 150.0, "flash_fwd_sm90": 60.0,
            "multi_tensor_update": 40.0, "paged_ring": 30.0,
            "wq_matmul": 20.0, "gemm": 750.0, "conv": 300.0,
            "elementwise": 45.0, "reduce": 15.0,
            "softmax_warp_forward": 25.0, "memcpy": 8.0, "memset": 2.0}


def _card_trace(path, scale=1.0):
    events = [{"ph": "X", "cat": "kernel", "name": n, "dur": d * scale,
               "pid": 0, "tid": 7} for n, d in CARD_EVENTS]
    events += [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD "
                "(Device -> Device)", "dur": 8.0 * scale, "pid": 0,
                "tid": 7},
               {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
                "dur": 2.0 * scale, "pid": 0, "tid": 7},
               {"ph": "X", "cat": "cpu_op", "name": "aten::mm",
                "dur": 999.0, "pid": 1, "tid": 1},
               {"ph": "X", "cat": "user_annotation",
                "name": "mxtpu.train_step", "dur": 999.0, "pid": 1,
                "tid": 1},
               {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "dur": 999.0, "pid": 1, "tid": 1}]
    return _write(path, events)


def test_rollup_families_and_the_reference_shapes(tmp_path, monkeypatch):
    a = _card_trace(str(tmp_path / "a"))
    b = _card_trace(str(tmp_path / "b"), scale=0.5)
    fam, total = troll.rollup(a)
    assert dict(fam) == FAMILIES
    assert total == sum(FAMILIES.values())
    # one lane table: the rollup reads what dumps() puts on the device lane
    monkeypatch.setitem(tprof._config, "filename", str(tmp_path / "a"))
    assert tprof.dumps(format_="dict", lane="both")["device"]["total_us"] \
        == total
    s = troll.summary(a, steps=2, top=100)
    assert set(s) == SUMMARY_KEYS and s["trace"] == a
    assert s["device_ms_per_step"] == round(total / 1e3 / 2, 4)
    assert abs(sum(f["share_pct"] for f in s["families"]) - 100) < 0.1
    assert s["families"][0]["family"] == "gemm"
    fb = troll.rollup(b)
    # the diff and the tables are the reference's functions of the rollup
    assert troll.diff((fam, total), fb, steps=2) == \
        jroll.diff((fam, total), fb, steps=2)
    assert troll.format_diff(troll.diff(a, b, steps=2)) == \
        jroll.format_diff(jroll.diff((fam, total), fb, steps=2))
    assert troll.family_table(fam, total, steps=2) == \
        jroll.family_table(fam, total, steps=2)
    with pytest.raises(troll.RollupError):
        troll.find_trace(str(tmp_path / "nothing"))

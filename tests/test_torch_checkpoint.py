"""PyTorch port, the on-disk tier: ``nd.save``/``nd.load`` and the
checkpoint stack of ``mxnet_tpu_torch.resilience`` (``checkpoint``,
``sharded``, ``async_writer``, ``retry``) and ``mxnet_tpu_torch.error``
against the JAX package's, on the CPU.

- ``nd.save`` writes the reference's ``MXTPU1`` file byte for byte for
  the same host arrays (every dtype code, 0-d, empty, named and
  unnamed), with the same metadata; each package loads the other's;
- the typed corruption errors, and a write killed at any byte;
- v1 and v2 checkpoints written by either package are validated, found
  ``latest`` and read by the other; reshard reads at world sizes 1, 2,
  3 and 5; the kill-at-byte-N crash matrix resumes the newest committed
  checkpoint; a stale or lagging ``LATEST``; prune never removes an
  in-flight directory;
- ``backoff_schedule`` equals the reference's number for number;
- async saves: snapshot immunity, a typed error on the next save, at
  most one save in flight, a reader joining its own in-flight save;
- the checkpoint and async metrics under the reference's names and
  buckets.

Mirrors ``tests/test_resilience.py`` and ``tests/test_checkpoint_sharded
.py`` where they need no sharded trainer or compiled step.
"""
import os
import sys
import threading

import ml_dtypes
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

from mxnet_tpu import nd as jnd  # noqa: E402
from mxnet_tpu import resilience as jrz  # noqa: E402
from mxnet_tpu import base as jbase  # noqa: E402
from mxnet_tpu import error as jerror  # noqa: E402
from mxnet_tpu.resilience import async_writer as jaw  # noqa: E402
from mxnet_tpu.resilience import checkpoint as jckpt  # noqa: E402
from mxnet_tpu.resilience import faults as jfaults  # noqa: E402
from mxnet_tpu.resilience import sharded as jsh  # noqa: E402
from mxnet_tpu_torch import base, error  # noqa: E402
from mxnet_tpu_torch import nd  # noqa: E402
from mxnet_tpu_torch import resilience as rz  # noqa: E402
from mxnet_tpu_torch.observability import get_registry  # noqa: E402
from mxnet_tpu_torch.resilience import async_writer as aw  # noqa: E402
from mxnet_tpu_torch.resilience import checkpoint as ckpt  # noqa: E402
from mxnet_tpu_torch.resilience import faults  # noqa: E402
from mxnet_tpu_torch.resilience import sharded as sh  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("MXNET_TPU_CKPT_ASYNC", "MXNET_TPU_CKPT_SHARDED",
                "MXNET_TPU_CKPT_WRITERS"):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()           # releases any armed gates first ...
    jfaults.reset()
    aw._reset_for_tests()    # ... so joining the writers cannot hang
    jaw._reset_for_tests()


def _np_arrays():
    """One host array of every dtype code, 0-d and empty included."""
    rs = np.random.RandomState(0)
    return {
        "f32": rs.randn(3, 4).astype(np.float32),
        "f64": rs.randn(2).astype(np.float64),
        "f16": rs.randn(5).astype(np.float16),
        "bf16": rs.randn(2, 3).astype(ml_dtypes.bfloat16),
        "i8": rs.randint(-100, 100, size=(4,)).astype(np.int8),
        "u8": rs.randint(0, 255, size=(2, 2)).astype(np.uint8),
        "i32": rs.randint(-9, 9, size=(2, 3)).astype(np.int32),
        "i64": rs.randint(-9, 9, size=(3,)).astype(np.int64),
        "bool": np.array([True, False, True]),
        "zero_d": np.array(np.float32(4.25)),
        "empty": np.zeros((0, 3), np.float32),
    }


def _tensor(a):
    """The tensor of a host array, bf16 through its bytes."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x):
    """Raw bytes of a tensor, an NDArray of either package or a numpy
    array."""
    if isinstance(getattr(x, "_data", None), torch.Tensor):
        x = x._data                     # the port's NDArray
    if isinstance(x, torch.Tensor):
        x = x.contiguous().reshape(-1)
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        return x.view(torch.uint8).numpy().tobytes()
    if hasattr(x, "asnumpy"):
        x = x.asnumpy()
    return np.ascontiguousarray(x).tobytes()


def _arrays(rows=8):
    rs = np.random.RandomState(3)
    return {"w": torch.from_numpy(rs.randn(rows, 3).astype(np.float32)),
            "b": torch.from_numpy(rs.randn(2).astype(np.float32)),
            "s": torch.tensor(4.25)}


# --------------------------------------------------- the dtype table ----
def test_dtype_codes_are_the_reference_codes():
    for code, np_t in jbase._DTYPE_CODE_TO_NP.items():
        name = np.dtype(np_t).name
        assert base.dtype_code(name) == code == jbase.dtype_code(np_t)
        assert base.dtype_name(code) == jbase.dtype_name(np_t)
    assert base.torch_dtype(12) is torch.bfloat16
    assert base.itemsize("bfloat16") == 2 and base.itemsize(7) == 1


def test_error_hierarchy_mirrors_the_reference():
    for name in ("InternalError", "ValueError", "TypeError", "IndexError",
                 "CheckpointCorruptError", "CheckpointWriteError"):
        mine, theirs = getattr(error, name), getattr(jerror, name)
        assert [c.__name__ for c in mine.__mro__] == \
            [c.__name__ for c in theirs.__mro__], name
    assert issubclass(error.CheckpointCorruptError, error.InternalError)
    assert issubclass(error.ValueError, ValueError)

    @error.register_error
    class MyError(error.MXNetError):
        pass
    assert error._ERROR_REGISTRY["MyError"] is MyError
    error.register_error("Alias", MyError)
    assert error._ERROR_REGISTRY["Alias"] is MyError


# ------------------------------------------------------- the container --
@pytest.mark.parametrize("named", [True, False])
def test_nd_save_is_the_reference_file_byte_for_byte(tmp_path, named):
    """The same host arrays through both ``nd.save``s: the same bytes and
    the same metadata; each package loads the other's file to the same
    bits (the JAX side compared where JAX keeps the dtype: without x64
    it narrows 64-bit arrays)."""
    host = _np_arrays()
    if named:
        jdata, tdata = host, {k: _tensor(v) for k, v in host.items()}
    else:
        jdata = list(host.values())
        tdata = [_tensor(v) for v in host.values()]
    jp, tp = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jmeta = jnd.save(jp, jdata)
    tmeta = nd.save(tp, tdata)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    assert jmeta == tmeta
    back = nd.load(jp)
    jback = jnd.load(tp)
    if not named:
        back = dict(zip(host, back))
        jback = dict(zip(host, jback))
    for k, want in host.items():
        assert tuple(back[k].shape) == want.shape, k
        assert _bits(back[k]) == want.tobytes(), k
        assert back[k].context.device_type == "cpu"
        if want.dtype.itemsize < 8:
            assert _bits(jback[k]) == want.tobytes(), k


def test_nd_save_takes_host_numpy_and_one_tensor(tmp_path):
    """Host numpy arrays (the async snapshot's form) and a single tensor
    (an unnamed one-array container, as the reference's single
    NDArray)."""
    p = str(tmp_path / "h.params")
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    meta = nd.save(p, {"w": w})
    back = nd.load(p, manifest=meta["arrays"])
    assert np.array_equal(back["w"].asnumpy(), w)
    nd.save(p, torch.from_numpy(w))
    jnd.save(str(tmp_path / "j.params"), jnd.array(w))
    assert open(p, "rb").read() == \
        open(str(tmp_path / "j.params"), "rb").read()
    (t,) = nd.load(p, device="cpu")
    assert torch.equal(t, torch.from_numpy(w))


def _truncate(p):
    raw = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(raw[:len(raw) - 3])


def _bad_magic(p):
    with open(p, "wb") as f:
        f.write(b"\x00" * 64)


def _flip_payload(p):
    raw = bytearray(open(p, "rb").read())
    raw[-2] ^= 0xFF       # a payload bit; sizes stay right
    with open(p, "wb") as f:
        f.write(bytes(raw))


def _bad_dtype_code(p):
    raw = bytearray(open(p, "rb").read())
    # the first record's dtype code follows magic, count, name len, name
    at = 16 + 4 + 1
    raw[at:at + 4] = (99).to_bytes(4, "little")
    with open(p, "wb") as f:
        f.write(bytes(raw))


@pytest.mark.parametrize("corrupt", [_truncate, _bad_magic, _flip_payload,
                                     _bad_dtype_code],
                         ids=["truncated", "bad_magic", "crc_mismatch",
                              "bad_dtype_code"])
def test_load_raises_typed_corruption_errors(tmp_path, corrupt):
    """The same damaged file: both packages raise their
    ``CheckpointCorruptError`` (the CRC case against the manifest)."""
    p = str(tmp_path / "c.params")
    meta = nd.save(p, {"w": torch.tensor([1.0, 2.0, 3.0])})
    corrupt(p)
    with pytest.raises(error.CheckpointCorruptError):
        nd.load(p, manifest=meta["arrays"])
    with pytest.raises(jerror.CheckpointCorruptError):
        jnd.load(p, manifest=meta["arrays"])


def test_nd_save_killed_at_any_byte_never_corrupts(tmp_path):
    """Kill the container write at many byte offsets: a reader always
    sees the previous intact file."""
    path = str(tmp_path / "w.params")
    old = {"w": torch.tensor([1.0, 2.0, 3.0]), "b": torch.tensor([[9.0]])}
    meta = nd.save(path, old)
    new = {"w": torch.tensor([4.0, 5.0, 6.0]), "b": torch.tensor([[-1.0]])}
    for cut in range(0, meta["nbytes"] + 1, 13):
        faults.kill_write_at("w.params", cut)
        with pytest.raises(rz.InjectedCrash):
            nd.save(path, new)
        faults.reset()
        back = nd.load(path, manifest=meta["arrays"])
        assert torch.equal(back["w"], old["w"])
    nd.save(path, new)
    assert torch.equal(nd.load(path)["w"], new["w"])


# ----------------------------------------- checkpoints across packages --
@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("num_shards", [None, 3])
def test_checkpoints_cross_read(tmp_path, writer, num_shards):
    """A v1 or v2 checkpoint written by one package is validated, found
    ``latest`` and read by the other; the shard files and the layout are
    the same bytes and plan either package would write."""
    host = {k: v.numpy() for k, v in _arrays(rows=11).items()}
    host["bf"] = np.arange(6, dtype=np.float32).reshape(3, 2).astype(
        ml_dtypes.bfloat16)
    runs = {w: str(tmp_path / w) for w in ("jax", "torch")}
    jpath = jrz.write_checkpoint(runs["jax"], host, step=4,
                                 num_shards=num_shards, extra={"k": 1})
    tpath = rz.write_checkpoint(
        runs["torch"], {k: _tensor(v) for k, v in host.items()}, step=4,
        num_shards=num_shards, extra={"k": 1})
    jm, tm = jrz.validate_checkpoint(jpath), rz.validate_checkpoint(tpath)
    for key in ("format", "step", "epoch", "files", "arrays", "extra",
                "layout"):
        assert jm.get(key) == tm.get(key), key
    # the other package reads it
    if writer == "jax":
        path, manifest = rz.latest_checkpoint(runs["jax"])
        assert path == jpath and manifest["step"] == 4
        back = rz.read_arrays(path, manifest, verify_arrays=True)
    else:
        path, manifest = jrz.latest_checkpoint(runs["torch"])
        assert path == tpath and manifest["step"] == 4
        back = jrz.read_arrays(path, manifest, verify_arrays=True)
    assert sorted(back) == sorted(host)
    for k, want in host.items():
        assert _bits(back[k]) == want.tobytes(), k
    if num_shards:
        assert sh.check_layout(path, manifest) == []
        assert jsh.check_layout(path, manifest) == []


def test_plan_layout_is_the_reference_plan():
    meta = {"w": ((8, 3), "float32"), "b": ((2,), "float32"),
            "s": ((), "float32"), "big": ((100, 4), "float32"),
            "h": ((7, 5), "float16"), "i": ((3,), "int64")}
    for n in (1, 2, 3, 4, 5, 8):
        assert sh.plan_layout(meta, n) == jsh.plan_layout(meta, n)
    # bf16 (which numpy cannot name here) plans as a 2-byte dtype
    bf = {"x": ((6, 2), "bfloat16"), "y": ((3,), "float32")}
    assert sh.plan_layout(bf, 4) == jsh.plan_layout(
        {"x": ((6, 2), "float16"), "y": ((3,), "float32")}, 4)


@pytest.mark.parametrize("new_world", [1, 2, 3, 5])
def test_reshard_reader_assembles_any_world_size(tmp_path, new_world):
    """A 4-shard checkpoint read back at world size M: the slices each
    new shard owns assemble every array, and the dry run names the
    source files the reference's dry run names."""
    run = str(tmp_path / "run")
    arrays = _arrays(rows=11)
    path = rz.write_checkpoint(run, arrays, step=1, num_shards=4)
    manifest = rz.validate_checkpoint(path)
    got = {}
    for shard_id in range(new_world):
        piece = sh.read_for_shard(path, manifest, shard_id, new_world)
        jpiece = jsh.read_for_shard(path, manifest, shard_id, new_world)
        assert sorted(piece) == sorted(jpiece)
        for name, v in piece.items():
            assert _bits(v) == np.asarray(jpiece[name]).tobytes(), name
            got.setdefault(name, []).append(v)
    for name, want in arrays.items():
        have = got[name]
        v = torch.cat(have, 0) if want.ndim and len(have) > 1 else have[0]
        assert torch.equal(v, want), name
    assert sh.reshard_check(path, manifest, new_world) == \
        jsh.reshard_check(path, manifest, new_world)


# --------------------------------------------------------- fault matrix --
_PHASES = [
    ("shard_first_bytes", lambda: faults.kill_write_at("shard-00000", 10),
     1),
    ("after_2_of_4_shards",
     lambda: faults.crash_at_point("ckpt.shard:2"), 1),
    ("shard_last_bytes", lambda: faults.kill_write_at("shard-00003", 40),
     1),
    ("manifest_body", lambda: faults.kill_write_at("MANIFEST.json", 5),
     1),
    ("manifest_rename",
     lambda: faults.crash_at_point("atomic.replace:MANIFEST.json"), 1),
    ("latest_pointer", lambda: faults.crash_at_point("ckpt.latest"), 2),
    ("prune", lambda: faults.crash_at_point("ckpt.prune"), 2),
]


@pytest.mark.parametrize("phase,arm,expect_step", _PHASES,
                         ids=[p[0] for p in _PHASES])
def test_crash_matrix_resumes_newest_committed(tmp_path, monkeypatch,
                                               phase, arm, expect_step):
    """Every phase of a sharded save killed: the resumed run (the port's
    reader and the reference's) lands on the newest committed
    checkpoint, never on a partial one."""
    monkeypatch.setenv("MXNET_TPU_CKPT_WRITERS", "1")  # deterministic
    run = str(tmp_path / "run")
    vals = {1: _arrays(), 2: {k: v + 100.0 for k, v in _arrays().items()}}
    assert rz.write_checkpoint(run, vals[1], step=1, num_shards=4)
    arm()
    with pytest.raises(rz.InjectedCrash):
        rz.write_checkpoint(run, vals[2], step=2, num_shards=4, keep=5)
    faults.reset()
    path, manifest = rz.latest_checkpoint(run)
    assert manifest["step"] == expect_step, phase
    assert jrz.latest_checkpoint(run)[1]["step"] == expect_step
    back = rz.read_arrays(path, manifest)
    assert torch.equal(back["w"], vals[expect_step]["w"])
    if expect_step == 1:
        partial = os.path.join(run, ckpt.checkpoint_dirname(2))
        assert os.path.isdir(partial)
        with pytest.raises(error.CheckpointCorruptError):
            rz.validate_checkpoint(partial)
        rz.prune_checkpoints(run, keep=5)
        assert not os.path.isdir(partial)


def test_crashed_shard_write_then_clean_retry_commits(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("MXNET_TPU_CKPT_WRITERS", "1")
    run = str(tmp_path / "run")
    faults.crash_at_point("ckpt.shard:1")
    with pytest.raises(rz.InjectedCrash):
        rz.write_checkpoint(run, _arrays(), step=3, num_shards=2)
    faults.reset()
    path = rz.write_checkpoint(run, _arrays(), step=3, num_shards=2)
    manifest = rz.validate_checkpoint(path)
    assert manifest["step"] == 3 and sh.check_layout(path, manifest) == []


def test_manager_skips_corrupt_and_falls_back(tmp_path):
    run = str(tmp_path / "run")
    mgr = rz.CheckpointManager(run, keep=10)
    for s in (1, 2, 3):
        mgr.save({"w": torch.tensor([float(s)])}, step=s)
    newest = os.path.join(run, ckpt.checkpoint_dirname(3), ckpt.DATA_FILE)
    with open(newest, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\xff")
    path, manifest = mgr.latest()
    assert manifest["step"] == 2
    assert torch.equal(mgr.load_arrays(path, manifest)["w"],
                       torch.tensor([2.0]))
    corrupt = get_registry().counter(
        "mxtpu_resilience_checkpoint_corrupt_total")
    before = corrupt.value
    mgr.latest()
    assert corrupt.value == before + 1


def test_crashed_save_ignored_previous_restorable(tmp_path):
    run = str(tmp_path / "run")
    mgr = rz.CheckpointManager(run)
    mgr.save({"w": torch.tensor([1.0])}, step=1)
    faults.kill_write_at(ckpt.DATA_FILE, 25)
    with pytest.raises(rz.InjectedCrash):
        mgr.save({"w": torch.tensor([2.0])}, step=2)
    faults.reset()
    assert mgr.latest()[1]["step"] == 1
    partial = os.path.join(run, ckpt.checkpoint_dirname(2))
    assert os.path.isdir(partial)
    with pytest.raises(error.CheckpointCorruptError):
        rz.validate_checkpoint(partial)
    rz.prune_checkpoints(run, keep=5)
    assert not os.path.isdir(partial)


def test_checkpoint_write_retries_transient_oserrors(tmp_path,
                                                     monkeypatch):
    from mxnet_tpu_torch.resilience import retry as retry_mod
    monkeypatch.setattr(retry_mod.time, "sleep", lambda s: None)
    faults.script("checkpoint.write", [OSError("flaky-1"),
                                       OSError("flaky-2")])
    run = str(tmp_path / "run")
    retries = get_registry().counter("mxtpu_resilience_retry_total",
                                     labelnames=("op",))
    before = retries.labels(op="checkpoint.write").value
    assert rz.write_checkpoint(run, {"w": torch.tensor([5.0])}, step=7)
    assert rz.latest_checkpoint(run)[1]["step"] == 7
    assert retries.labels(op="checkpoint.write").value == before + 2


def test_latest_pointer_stale_falls_back_to_scan(tmp_path):
    run = str(tmp_path / "run")
    mgr = rz.CheckpointManager(run)
    mgr.save({"w": torch.tensor([1.0])}, step=1)
    with open(os.path.join(run, ckpt.LATEST_NAME), "w") as f:
        f.write("ckpt-0000009999")   # points at nothing
    assert rz.latest_checkpoint(run)[1]["step"] == 1


def test_latest_pointer_behind_does_not_hide_newer(tmp_path):
    run = str(tmp_path / "run")
    mgr = rz.CheckpointManager(run)
    mgr.save({"w": torch.tensor([1.0])}, step=1)
    mgr.save({"w": torch.tensor([2.0])}, step=2)
    with open(os.path.join(run, ckpt.LATEST_NAME), "w") as f:
        f.write(ckpt.checkpoint_dirname(1))   # one save stale
    assert rz.latest_checkpoint(run)[1]["step"] == 2
    assert open(os.path.join(run, ckpt.LATEST_NAME)).read() == \
        ckpt.checkpoint_dirname(1)


# ---------------------------------------------------- prune protection --
def test_prune_never_removes_inflight_dir(tmp_path):
    run = str(tmp_path / "run")
    mgr = rz.CheckpointManager(run, keep=1, async_=True, num_shards=2)
    assert mgr.save(_arrays(), step=1).result(30)
    gate = faults.block_at("checkpoint.write")
    handle = mgr.save(_arrays(), step=2)
    assert gate.wait_reached(), "writer never reached the write site"
    skipped = get_registry().counter("mxtpu_ckpt_prune_skipped_total",
                                     labelnames=("reason",))
    before = skipped.labels(reason="in_flight").value
    rz.prune_checkpoints(run, keep=1)
    for step in (1, 2):
        assert os.path.isdir(os.path.join(run,
                                          ckpt.checkpoint_dirname(step)))
    assert skipped.labels(reason="in_flight").value == before + 1
    gate.release()
    handle.result(30)
    faults.reset()
    assert mgr.latest()[1]["step"] == 2
    assert not os.path.isdir(os.path.join(run, ckpt.checkpoint_dirname(1)))


def test_prune_counts_deletions(tmp_path):
    run = str(tmp_path / "run")
    for s in (1, 2, 3):
        rz.write_checkpoint(run, _arrays(), step=s)
    pruned = get_registry().counter("mxtpu_ckpt_pruned_total",
                                    labelnames=("reason",))
    before = pruned.labels(reason="retention").value
    rz.prune_checkpoints(run, keep=1)
    assert pruned.labels(reason="retention").value == before + 2
    assert [s for s, _ in ckpt.list_checkpoints(run)] == [3]


# --------------------------------------------------------- retry/backoff --
@pytest.mark.parametrize("cfg", [
    dict(max_attempts=6, base_delay=0.1, max_delay=1.0, jitter=0.5, seed=3),
    dict(max_attempts=4, base_delay=0.02, max_delay=0.5, seed=0),
    dict(max_attempts=9, base_delay=0.05, factor=3.0, jitter=0.9, seed=17),
])
def test_backoff_schedule_is_the_reference_schedule(cfg):
    assert rz.backoff_schedule(**cfg) == jrz.backoff_schedule(**cfg)


def test_call_with_retry_schedule_and_exhaustion():
    slept, calls = [], []

    def flaky():
        calls.append(1)
        raise OSError("down")

    with pytest.raises(rz.RetryError) as ei:
        rz.call_with_retry(flaky, max_attempts=4, base_delay=0.1, seed=11,
                           sleep=slept.append)
    assert len(calls) == 4
    assert slept == jrz.backoff_schedule(max_attempts=4, base_delay=0.1,
                                         seed=11)
    assert isinstance(ei.value.last, OSError)

    def bad():
        calls.append(1)
        raise KeyError("no")
    calls.clear()
    with pytest.raises(KeyError):
        rz.call_with_retry(bad, max_attempts=4, sleep=slept.append)
    assert len(calls) == 1
    wrapped = rz.with_retry(max_attempts=2, sleep=slept.append)(flaky)
    with pytest.raises(rz.RetryError):
        wrapped()


# ------------------------------------------------------------ async path --
def test_snapshot_arrays_copies():
    src = {"w": np.ones((2, 2), np.float32), "t": torch.ones(3)}
    snap = rz.snapshot_arrays(src)
    src["w"][:] = 7.0
    src["t"].add_(1.0)
    assert np.array_equal(snap["w"], np.ones((2, 2), np.float32))
    assert torch.equal(snap["t"], torch.ones(3))


def test_async_snapshot_is_immune_to_later_mutation(tmp_path):
    """In-place updates after ``save`` returns (as the fused update
    kernel makes them) never reach the bytes on disk."""
    run = str(tmp_path / "run")
    live = _arrays()
    want = {k: v.clone() for k, v in live.items()}
    mgr = rz.CheckpointManager(run, keep=5, async_=True, num_shards=2)
    gate = faults.block_at("checkpoint.write")
    handle = mgr.save(live, step=1)
    assert gate.wait_reached()
    for v in live.values():
        v.mul_(3.0).add_(1.0)
    gate.release()
    handle.result(30)
    faults.reset()
    back = mgr.load_arrays()
    for k, v in want.items():
        assert torch.equal(back[k], v), k


def test_async_write_error_typed_on_next_save(tmp_path, monkeypatch):
    from mxnet_tpu_torch.resilience import retry as retry_mod
    monkeypatch.setattr(retry_mod.time, "sleep", lambda s: None)
    run = str(tmp_path / "run")
    mgr = rz.CheckpointManager(run, keep=5, async_=True)
    faults.script("checkpoint.write", [OSError("disk gone")] * 4)
    handle = mgr.save(_arrays(), step=1)
    with pytest.raises(rz.RetryError):
        handle.result(30)
    errors = get_registry().counter("mxtpu_ckpt_async_errors_total")
    assert errors.value >= 1
    with pytest.raises(error.CheckpointWriteError) as ei:
        mgr.save(_arrays(), step=2)
    assert isinstance(ei.value.__cause__, rz.RetryError)
    faults.reset()
    assert mgr.save(_arrays(), step=3).result(30)
    assert mgr.latest()[1]["step"] == 3


def test_async_backpressure_at_most_one_in_flight(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_CKPT_ASYNC", "1")
    run = str(tmp_path / "run")
    mgr = rz.CheckpointManager(run, keep=5)
    hist = get_registry().histogram("mxtpu_ckpt_async_backpressure_seconds")
    count0 = hist.count
    gate = faults.block_at("checkpoint.write")
    h1 = mgr.save(_arrays(), step=1)
    assert gate.wait_reached()
    assert mgr.in_flight and aw.any_in_flight()
    releaser = threading.Thread(target=gate.release)
    releaser.start()
    h2 = mgr.save(_arrays(), step=2)   # joins save 1 first
    assert h1.done()
    releaser.join(30)
    assert not releaser.is_alive()
    assert h1.result(30) and h2.result(30)
    faults.reset()
    assert mgr.latest()[1]["step"] == 2
    assert hist.count >= count0 + 2
    mgr.close()
    assert not mgr.in_flight


def test_latest_checkpoint_joins_own_inflight_save(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_CKPT_ASYNC", "1")
    run = str(tmp_path / "run")
    mgr = rz.CheckpointManager(run, keep=5)
    mgr.save(_arrays(), step=7)
    path, manifest = rz.latest_checkpoint(run)   # no explicit wait()
    assert manifest is not None and manifest["step"] == 7


def test_resilience_exports_the_reference_names():
    assert set(rz.__all__) == set(jrz.__all__)
    assert set(ckpt.__all__) == set(jckpt.__all__)
    assert set(sh.__all__) == set(jsh.__all__)
    assert set(aw.__all__) == set(jaw.__all__)
    assert (ckpt.FORMAT, ckpt.FORMAT_SHARDED) == \
        (jckpt.FORMAT, jckpt.FORMAT_SHARDED)


def test_checkpoint_metrics_are_the_reference_series(tmp_path):
    """Every checkpoint and async series under the reference's name,
    kind, labels and buckets, and a sync save moves the write series."""
    from mxnet_tpu.observability import get_registry as jreg
    mine, theirs = ckpt._obs(), jckpt._obs()
    mine.update(aw._obs())
    theirs.update(jaw._obs())
    assert sorted(mine) == sorted(theirs)
    for key in mine:
        a, b = mine[key], theirs[key]
        assert (a.name, type(a).__name__, tuple(a.labelnames)) == \
            (b.name, type(b).__name__, tuple(b.labelnames)), key
        if hasattr(b, "buckets"):
            assert tuple(a.buckets) == tuple(b.buckets), key
    assert jreg().get(mine["writes"].name) is not None
    writes, nbytes = mine["writes"].value, mine["write_bytes"].value
    path = rz.write_checkpoint(str(tmp_path / "run"), _arrays(), step=9)
    assert mine["writes"].value == writes + 1
    assert mine["write_bytes"].value - nbytes == sum(
        int(r["nbytes"]) for r in rz.validate_checkpoint(path)["files"]
        .values())
    assert mine["last_step"].value == 9

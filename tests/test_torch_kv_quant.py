"""PyTorch port, host-side serving state: the block allocator, prefix
hashes, weight quantization and the weight converter of
``mxnet_tpu_torch`` against the JAX package on the same inputs.

All of these are exact: the allocator replays the same operation
sequence op for op, hashes are byte strings, int8 quantization runs the
same numpy arithmetic, and the fp8 cast (torch here, ml_dtypes there)
rounds to nearest-even on the same clipped f32 values.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch  # noqa: E402

from mxnet_tpu.serving.llm import kv_cache as jkv  # noqa: E402
from mxnet_tpu.serving.llm import quant as jquant  # noqa: E402
from mxnet_tpu.serving.llm import TinyDecoder as JTinyDecoder  # noqa: E402
from mxnet_tpu_torch.convert import params_from_numpy  # noqa: E402
from mxnet_tpu_torch.serving.llm import kv_cache as tkv  # noqa: E402
from mxnet_tpu_torch.serving.llm import quant as tquant  # noqa: E402
from mxnet_tpu_torch.serving.llm.quant import flatten_params  # noqa: E402

torch.set_num_threads(2)


def _bytes(a):
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


def _state(alloc):
    return (sorted(alloc._free), dict(alloc._ref), list(alloc._cached),
            sorted(alloc._cacheable), alloc.num_shared, alloc.num_free)


def test_block_allocator_fuzz_replays_jax_op_for_op():
    """1000 random alloc / free / ref / mark_cacheable operations on
    both allocators: same results, same errors, same reclaims, equal
    state and a passing check() after every op."""
    rng = np.random.RandomState(0)
    rec_j, rec_t = [], []
    ja = jkv.BlockAllocator(24, reclaim_cb=rec_j.append)
    ta = tkv.BlockAllocator(24, reclaim_cb=rec_t.append)
    owned = []                      # one entry per reference held
    for _ in range(1000):
        op = rng.randint(4)
        if op == 0:
            n = int(rng.randint(0, 5))
            args = ("alloc", n)
        elif op == 1 and owned:
            k = int(rng.randint(1, min(3, len(owned)) + 1))
            pick = sorted(set(rng.choice(len(owned), k, replace=False)))
            args = ("free", [owned[i] for i in pick])
        elif op == 2:
            args = ("ref", int(rng.randint(0, 24)))
        else:
            args = ("mark_cacheable", int(rng.randint(0, 24)))
        outs = []
        for a in (ja, ta):
            try:
                outs.append(("ok", getattr(a, args[0])(args[1])))
            except (jkv.KVCacheError, tkv.KVCacheError, ValueError) as e:
                outs.append(("err", type(e).__name__))
        assert outs[0] == outs[1], args
        if outs[0][0] == "ok":
            if args[0] == "alloc":
                owned += outs[0][1]
            elif args[0] == "free":
                for b in args[1]:
                    owned.remove(b)
            elif args[0] == "ref":
                owned.append(args[1])
        assert ja.check() and ta.check()
        assert _state(ja) == _state(ta)
        assert rec_j == rec_t


@pytest.mark.parametrize("salt", [b"", b"adapter@3"])
@pytest.mark.parametrize("bs", [4, 16])
def test_prefix_block_hashes_identical(salt, bs):
    rng = np.random.RandomState(bs)
    toks = rng.randint(0, 50257, size=5 * bs + 3).tolist()
    assert tkv.prefix_block_hashes(toks, bs, salt=salt) == \
        jkv.prefix_block_hashes(toks, bs, salt=salt)


def test_paged_cache_prefix_index_and_cow_copy():
    c = tkv.PagedKVCache(2, 2, 4, 4, 9, 16, dtype="int8",
                         prefix_cache=True, device="cpu")
    b = c.allocator.alloc(2)
    assert c.register("h0", b[0]) and not c.register("h0", b[1])
    c.k_pages[:, b[0]] = 7
    c.k_scales[:, b[0]] = 0.5
    c.copy_block(b[0], b[1])
    assert torch.equal(c.k_pages[:, b[1]], c.k_pages[:, b[0]])
    assert torch.equal(c.k_scales[:, b[1]], c.k_scales[:, b[0]])
    c.allocator.free(b)
    assert c.prefix_get("h0") == b[0] and c.allocator.num_cached == 1
    c.allocator.alloc(8)                        # reclaims the cached one
    assert c.prefix_get("h0") is None and c.prefix_evictions == 1


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("method", ["absmax", "percentile"])
def test_quantize_leaf_identical_bytes(dtype, method):
    rng = np.random.RandomState(1)
    w = (rng.randn(64, 48) * rng.rand(48) * 3).astype(np.float32)
    w[:, 5] = 0.0                               # an all-zero channel
    jq, js = jquant.quantize_leaf(w, dtype, method)
    tq, ts = tquant.quantize_leaf(w, dtype, method)
    assert _bytes(tq) == _bytes(jq)
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantize_weights_tree_identical(dtype):
    params = JTinyDecoder(vocab_size=40, d_model=32, num_layers=2,
                          num_heads=2, d_ff=64,
                          max_context=32).init_params(3)
    jqw = jquant.quantize_weights(params, dtype=dtype, method="auto")
    tqw = tquant.quantize_weights(params, dtype=dtype, method="auto")
    assert tqw.dtype == jqw.dtype and tqw.methods == jqw.methods
    from mxnet_tpu.deploy import flatten_params as jflat
    jp, tp = jflat(jqw.params), flatten_params(tqw.params)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert _bytes(tp[k]) == _bytes(jp[k]), k
    for k in jqw.scales:
        assert tqw.scales[k].numpy().tobytes() == \
            np.asarray(jqw.scales[k]).tobytes()
    assert tqw.nbytes() == jqw.nbytes()


def test_params_from_numpy_carries_jax_fp8_checkpoint():
    params = JTinyDecoder(vocab_size=24, d_model=16, num_layers=1,
                          num_heads=2, d_ff=32,
                          max_context=16).init_params(0)
    jqw = jquant.quantize_weights(params, dtype="fp8")
    tqw = params_from_numpy(jqw, "cpu")
    assert tqw.params["head"].dtype == torch.float8_e4m3fn
    assert _bytes(tqw.params["head"]) == _bytes(jqw.params["head"])
    assert torch.equal(tqw.params["layers"][0]["ln1_g"],
                       torch.from_numpy(params["layers"][0]["ln1_g"]))
    deq = tqw.dequantize()
    np.testing.assert_array_equal(
        deq["head"].numpy(),
        np.asarray(jquant.dequantize_leaf(jqw.params["head"],
                                          jqw.scales["head"])))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys; import mxnet_tpu_torch, mxnet_tpu_torch.kernels,"
            " mxnet_tpu_torch.convert, mxnet_tpu_torch.serving.llm, "
            "chip_smoke; bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.') or m == 'ml_dtypes']; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_never_name_jax_imports():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "mxnet_tpu_torch")):
        paths += [os.path.join(root, f) for f in files
                  if f.endswith(".py")]
    for p in paths:
        with open(p) as f:
            for line in f:
                s = line.strip()
                assert not (s.startswith("import jax")
                            or s.startswith("from jax")
                            or s.startswith("import mxnet_tpu ")
                            or s.startswith("import mxnet_tpu.")
                            or s.startswith("from mxnet_tpu ")
                            or s.startswith("from mxnet_tpu.")), (p, s)

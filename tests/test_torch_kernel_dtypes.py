"""PyTorch port, the kernels' input dtypes: every dtype mix the TPU
kernels take, through the port's public functions on the CPU (where each
kernel wrapper takes its plain version) against the JAX package's
public functions with the Pallas kernels in interpret mode, on the same
numpy inputs.

- ``ragged_paged_attention`` (decode and chunk shapes, K5 and K4) and
  ``ragged_flat_attention`` over float pages (K1): q f32, bf16 or f16
  over K and V pages of f32, bf16 or f16, alike or not. The TPU kernels
  read q and every page element as f32 and write the output in q's
  dtype.
- ``ragged_flat_attention`` over int8 / fp8 pages with scales (K2) with
  16-bit q: the output in q's dtype.
- ``quantized_matmul`` (K3) with bf16 and f16 x: f32 out.

Tolerances: output dtypes equal; f32 outputs within ``F32_TOL = 1e-5``
(the same f32 arithmetic summed in another order; attention outputs are
O(1), the matmul's is scaled by its largest magnitude); a 16-bit output
within one ulp of its dtype at the output's largest magnitude (both
sides round the same f32 result, which may sit on a rounding boundary).

The kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import os
import sys

import ml_dtypes
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

from mxnet_tpu.ops import quantization as jqz  # noqa: E402
from mxnet_tpu.ops import ragged_attention as jra  # noqa: E402
from mxnet_tpu.serving.llm import quant as jquant  # noqa: E402
from mxnet_tpu_torch import kernels  # noqa: E402
from mxnet_tpu_torch.convert import tensor_from_numpy  # noqa: E402
from mxnet_tpu_torch.ops import quantization as tqz  # noqa: E402
from mxnet_tpu_torch.ops import ragged_attention as tra  # noqa: E402
from mxnet_tpu_torch.serving.llm import quant as tquant  # noqa: E402
from mxnet_tpu_torch.serving.llm.model import _quantize_kv  # noqa: E402

torch.set_num_threads(2)

F32_TOL = 1e-5
BS, H, D = 8, 2, 16
NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
      "float16": np.float16}
# (q, K pages, V pages): 16-bit q over f32 and over the other 16-bit
# pages, f32 q over K and V of two dtypes, 16-bit q over mixed pages
MIXES = [("bfloat16", "float32", "float32"),
         ("float16", "float32", "float32"),
         ("float16", "bfloat16", "bfloat16"),
         ("bfloat16", "float16", "float16"),
         ("float32", "bfloat16", "float16"),
         ("float32", "float32", "bfloat16"),
         ("bfloat16", "bfloat16", "float16")]
MIX_IDS = ["-".join(m) for m in MIXES]


def _tables():
    return np.array([[9, 2, 5, 0], [7, 10, 3, 1], [4, 8, 6, 11]], np.int32)


def _paged_case(mix, chunk, seed=0):
    """Rows at kv lengths bs-1, bs+1, 3bs+2 over fragmented tables;
    chunk rows query their last (3, 1, 5) positions of Q=5."""
    qd, kd, vd = mix
    rng = np.random.RandomState(seed)
    qshape = (3, 5, H, D) if chunk else (3, H, D)
    c = dict(q=rng.randn(*qshape).astype(NP[qd]),
             k_pages=rng.randn(12, BS, H, D).astype(NP[kd]),
             v_pages=rng.randn(12, BS, H, D).astype(NP[vd]),
             block_tables=_tables(),
             kv_lens=np.array([BS - 1, BS + 1, 3 * BS + 2], np.int32))
    if chunk:
        c["q_lens"] = np.array([3, 1, 5], np.int32)
    return c


def _flat_case(mix, seed=1):
    """Packed tokens of three rows at block edges and mid-page."""
    qd, kd, vd = mix
    rng = np.random.RandomState(seed)
    seq_ids = np.array([0, 0, 0, 1, 1, 2, 2, 0], np.int32)
    return dict(q=rng.randn(len(seq_ids), H, D).astype(NP[qd]),
                k_pages=rng.randn(12, BS, H, D).astype(NP[kd]),
                v_pages=rng.randn(12, BS, H, D).astype(NP[vd]),
                block_tables=_tables(), seq_ids=seq_ids,
                positions=np.array([BS - 1, BS, BS + 1, 0, 31, 3, 20, 0],
                                   np.int32))


def _quant_case(q_dtype, page_dtype, seed=2):
    """The flat case over int8 / fp8 pages with per-slot scales, quantized
    by the port and viewed as the JAX package's dtypes."""
    c = _flat_case((q_dtype, "float32", "float32"), seed)
    tdt = torch.int8 if page_dtype == "int8" else torch.float8_e4m3fn
    for name in ("k", "v"):
        pq, sc = _quantize_kv(torch.from_numpy(c[f"{name}_pages"]), tdt)
        raw = pq.view(torch.uint8).numpy()
        c[f"{name}_pages"] = (raw.view(np.int8) if page_dtype == "int8"
                              else raw.view(np.dtype(jquant.FP8_NAME)))
        c[f"{name}_scales"] = sc.numpy()
    return c


def _port(fn, c):
    return fn(**{k: tensor_from_numpy(v, "cpu") for k, v in c.items()})


def _valid(c, out):
    if "q_lens" not in c:
        return out
    return np.concatenate([out[i, :n] for i, n in enumerate(c["q_lens"])])


def _assert_matches(c, got, want):
    """Same dtype as the JAX output (q's), values within F32_TOL or one
    ulp of the 16-bit dtype."""
    want = np.asarray(want)
    assert want.dtype == np.dtype(c["q"].dtype)
    assert got.dtype == tensor_from_numpy(c["q"][:1], "cpu").dtype
    g = _valid(c, got.float().numpy())
    w = _valid(c, want.astype(np.float32))
    tol = F32_TOL
    if want.dtype != np.float32:
        tol = float(ml_dtypes.finfo(want.dtype).eps) * float(np.abs(w).max())
    np.testing.assert_allclose(g, w, atol=tol, rtol=0)


@pytest.mark.parametrize("mix", MIXES, ids=MIX_IDS)
@pytest.mark.parametrize("shape", ["decode", "chunk"])
def test_paged_attention_takes_every_dtype_the_jax_kernel_takes(shape, mix):
    before = kernels.launch_counts()
    c = _paged_case(mix, shape == "chunk")
    got = _port(tra.ragged_paged_attention, c)
    want = jra.ragged_paged_attention(**c, use_pallas=True, interpret=True)
    assert kernels.launch_counts() == before   # plain versions on the CPU
    _assert_matches(c, got, want)


# the flat mixes add 16-bit q over K and V of two dtypes, one f32
FLAT_MIXES = MIXES + [("float16", "float32", "bfloat16")]


@pytest.mark.parametrize("mix", FLAT_MIXES,
                         ids=["-".join(m) for m in FLAT_MIXES])
def test_flat_attention_takes_every_float_dtype_the_jax_kernel_takes(mix):
    c = _flat_case(mix)
    got = _port(tra.ragged_flat_attention, c)
    want = jra.ragged_flat_attention(**c, use_pallas=True, interpret=True)
    _assert_matches(c, got, want)


@pytest.mark.parametrize("q_dtype,page_dtype", [
    ("bfloat16", "int8"), ("float16", "int8"), ("bfloat16", "fp8"),
    ("float16", "fp8")])
def test_quantized_flat_attention_takes_16bit_q(q_dtype, page_dtype):
    c = _quant_case(q_dtype, page_dtype)
    got = _port(tra.ragged_flat_attention, c)
    want = jra.ragged_flat_attention(**c, use_pallas=True, interpret=True)
    _assert_matches(c, got, want)


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("w_dtype", ["int8", "fp8"])
def test_quantized_matmul_takes_16bit_x(w_dtype, x_dtype):
    """f32 out, as the JAX reference and its Pallas kernel give."""
    rng = np.random.RandomState(3)
    w = rng.randn(48, 80).astype(np.float32) / 7
    x = rng.randn(5, 48).astype(NP[x_dtype])
    jq, js = jquant.quantize_leaf(w, w_dtype)
    tq, ts = tquant.quantize_leaf(w, w_dtype)
    got = tqz.quantized_matmul(tensor_from_numpy(x, "cpu"), tq, ts)
    ref = np.asarray(jqz.quantized_matmul_reference(x, jq, js))
    pal = np.asarray(jqz.quantized_matmul(x, jq, js, use_pallas=True,
                                          interpret=True, block_t=8,
                                          block_n=32))
    assert got.dtype == torch.float32
    assert ref.dtype == pal.dtype == np.float32
    tol = F32_TOL * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.numpy(), ref, atol=tol, rtol=0)
    np.testing.assert_allclose(got.numpy(), pal, atol=tol, rtol=0)


def test_only_float_pool_pairs_are_widened():
    """The wrappers widen K and V of two of f32, bf16 and f16 to f32 for
    the kernel; an f64 or integer pool is left as it is, for the kernel's
    checks to refuse, never narrowed; the public function refuses f64
    pages on the CPU too."""
    k = torch.zeros(2, dtype=torch.float64)
    v = torch.zeros(2, dtype=torch.bfloat16)
    assert [x.dtype for x in tra._alike(k, v)] == [torch.float64,
                                                   torch.bfloat16]
    assert [x.dtype for x in tra._alike(v, torch.zeros(2, dtype=torch.int8))
            ] == [torch.bfloat16, torch.int8]
    assert [x.dtype for x in tra._alike(v, v.half())] == [torch.float32] * 2
    c = _paged_case(("float32", "float32", "bfloat16"), False)
    c["k_pages"] = c["k_pages"].astype(np.float64)
    with pytest.raises(TypeError, match="pages of dtype"):
        _port(tra.ragged_paged_attention, c)


@pytest.mark.parametrize("shape", ["decode", "chunk", "flat"])
def test_f64_q_is_refused(shape):
    """No kernel takes f64 q (the JAX package computes it in f32 at best):
    the port refuses it on the CPU as on the card."""
    mix = ("float32", "bfloat16", "float16")
    if shape == "flat":
        c, fn = _flat_case(mix), tra.ragged_flat_attention
    else:
        c, fn = _paged_case(mix, shape == "chunk"), tra.ragged_paged_attention
    c["q"] = c["q"].astype(np.float64)
    with pytest.raises(TypeError, match="q has dtype"):
        _port(fn, c)

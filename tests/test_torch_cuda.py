"""PyTorch port, on the card: each CUDA kernel of ``mxnet_tpu_torch``
against its plain PyTorch version on the same CUDA tensors.

Marked ``cuda``; each test skips (in a fixture, never at import) where
torch sees no CUDA device, since a CUDA kernel has no CPU mode. The file
imports neither ``jax`` nor ``mxnet_tpu``, so it runs where the port runs:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: ``ATT_TOL = 2e-5`` for flat attention (f32 online softmax and
dot products summed in another order; outputs are O(1)); ``WQ_TOL =
1e-5`` of the output's magnitude for the quantized matmul (one f32 sum of
K terms in another order, split-K partials summed in split order).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

from mxnet_tpu_torch import kernels  # noqa: E402
from mxnet_tpu_torch.ops import ragged_attention as tra  # noqa: E402
from mxnet_tpu_torch.ops import quantization as tqz  # noqa: E402
from mxnet_tpu_torch.serving.llm import quant as tquant  # noqa: E402
from mxnet_tpu_torch.serving.llm.model import _quantize_kv  # noqa: E402

ATT_TOL = 2e-5
WQ_TOL = 1e-5
BS = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _attention_inputs(dtype, dev, H=12, D=64, n_blocks=40):
    """Fragmented tables, positions at the block boundaries bs-1/bs/bs+1,
    a first token and long ones, and a padded token on seq 0."""
    g = torch.Generator().manual_seed(0)
    tables = torch.tensor([[9, 2, 5, 0, 0], [7, 10, 30, 31, 0],
                           [3, 8, 6, 4, 22]], dtype=torch.int32)
    seq_ids = torch.tensor([0, 0, 0, 1, 1, 2, 2, 0], dtype=torch.int32)
    positions = torch.tensor([BS - 1, BS, BS + 1, 0, 63, 3, 79, 0],
                             dtype=torch.int32)
    q = torch.randn(len(positions), H, D, generator=g)
    out = dict(q=q, block_tables=tables, seq_ids=seq_ids,
               positions=positions)
    for name in ("k", "v"):
        x = torch.randn(n_blocks, BS, H, D, generator=g)
        if dtype == "float32":
            out[f"{name}_pages"] = x
        else:
            dt = torch.int8 if dtype == "int8" else torch.float8_e4m3fn
            xq, sc = _quantize_kv(x.reshape(-1, H, D), dt)
            out[f"{name}_pages"] = xq.reshape(x.shape)
            out[f"{name}_scales"] = sc.reshape(x.shape[:-1])
    return {k: v.to(dev) for k, v in out.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8", "fp8"])
def test_flat_attention_kernel_matches_plain(cuda, dtype):
    t = _attention_inputs(dtype, cuda)
    name = tra.kernel_name(t["k_pages"].dtype)
    before = kernels.launch_counts().get(name, 0)
    got = tra.ragged_flat_attention(**t)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    want = tra.ragged_flat_attention_reference(**t)
    assert float((got - want).abs().max()) < ATT_TOL


@pytest.mark.cuda
def test_flat_attention_kernel_garbage_invisible(cuda):
    t = _attention_inputs("float32", cuda)
    clean = tra.ragged_flat_attention(**t)
    for name in ("k_pages", "v_pages"):
        t[name][0] = 1e4                        # the null block
        t[name][2, 2:] = 1e4                    # past seq 0's last token
    got = tra.ragged_flat_attention(**t)
    assert torch.equal(got[:7], clean[:7])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("T,K,N", [(8, 768, 50257), (8, 3072, 768),
                                   (23, 768, 3072), (128, 3072, 768)])
def test_wq_matmul_kernel_matches_plain(cuda, dtype, T, K, N):
    rng = np.random.RandomState(7)
    q, s = tquant.quantize_leaf(
        rng.randn(K, N).astype(np.float32) / np.sqrt(K), dtype)
    x = torch.from_numpy(rng.randn(T, K).astype(np.float32)).to(cuda)
    q, s = q.to(cuda), s.to(cuda)
    got = tqz.quantized_matmul(x, q, s)
    torch.cuda.synchronize()
    want = tqz.quantized_matmul_reference(x, q, s)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) < WQ_TOL * scale


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    t = _attention_inputs("float32", cuda)
    with pytest.raises(TypeError):
        tra.ragged_flat_attention(**dict(
            t, block_tables=t["block_tables"].long()))
    with pytest.raises(ValueError, match="head_dim"):
        tra.ragged_flat_attention(**dict(
            t, q=t["q"][..., :16].contiguous(),
            k_pages=t["k_pages"][..., :16].contiguous(),
            v_pages=t["v_pages"][..., :16].contiguous()))
    q, s = tquant.quantize_leaf(np.eye(64, dtype=np.float32), "int8")
    with pytest.raises(ValueError, match="on cpu"):
        tqz.quantized_matmul(torch.ones(2, 64, device=cuda), q, s)

"""PyTorch port, on the card: each CUDA kernel of ``mxnet_tpu_torch``
against its plain PyTorch version on the same CUDA tensors.

Marked ``cuda``; each test skips (in a fixture, never at import) where
torch sees no CUDA device, since a CUDA kernel has no CPU mode. The file
imports neither ``jax`` nor ``mxnet_tpu``, so it runs where the port runs:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: ``ATT_TOL = 2e-5`` for flat attention (f32 online softmax and
dot products summed in another order; outputs are O(1)); ``WQ_TOL =
1e-5`` of the output's magnitude for the quantized matmul (one f32 sum of
K terms in another order, the cluster's K-slice partials summed in slice
order, x split into two TF32 parts: ~2^-22 relative per product);
``FLASH_TOL = 2e-5`` of the output's magnitude for the flash attention
kernels (f32 sums over up to 512 keys or queries in another order,
online softmax against one softmax; the kernels' split-TF32 products
drop only lo*lo, ~2^-22 of each product), also against the twins
evaluated in float64; ``FLASH_GRAD_TOL = 1e-4`` for the
autograd Function against autograd through ``attention_reference``
(the reference differentiates softmax itself instead of working from
the saved logsumexp, which reorders more sums); ``FLASH_LP_TOL`` (bf16
``2e-2``, f16 ``5e-3`` of each result's magnitude) for the bf16 and f16
flash kernels against their twins (both round P, dS and the outputs to
the input dtype from f32 sums taken in another order: one ulp, 2^-8 or
2^-11 relative, where a value sits on a rounding boundary). The chunk and decode
paged attention kernels take ``ATT_TOL`` too, and so do the paged kernels
over bf16/f16 pages with f32 q (kernel and twin read the same 16-bit
values as f32); with q in the pages' 16-bit dtype, both round the f32
result to it, so they agree within one ulp of that dtype at the output's
largest magnitude (``_lp_tol``); the user kernels of
``chip_smoke.RTC_SOURCES`` registered through ``rtc`` take ``RTC_TOL =
1e-5`` of the output's magnitude (``2x + y`` fused into one FMA, a row
sum in another order). The optimizer update kernel
(``csrc/multi_tensor_update.cu``) is held to its twins bit for bit, and
the fused Trainer step to the per-parameter loop. The registered K3
(``nd.contrib.quantized_matmul``) gives the function's bits; the int8
products accumulate to the CPU's int32 bits; detection rows on a tie keep
the CPU's rows, within 1e-6 (the card's exp in the box decode).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from mxnet_tpu_torch import autograd as ag  # noqa: E402
from mxnet_tpu_torch import kernels, nd  # noqa: E402
from mxnet_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from mxnet_tpu_torch.ops import ragged_attention as tra  # noqa: E402
from mxnet_tpu_torch.ops import quantization as tqz  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch.ops import optimizer_ops as topt_ops  # noqa: E402
from mxnet_tpu_torch.ops.invoke import apply_op  # noqa: E402
from mxnet_tpu_torch.ops.registry import get as get_op  # noqa: E402
from mxnet_tpu_torch.serving.llm import quant as tquant  # noqa: E402
from mxnet_tpu_torch.serving.llm.model import (  # noqa: E402
    DENSE_ROWS, _quantize_kv)

ATT_TOL = 2e-5
WQ_TOL = 1e-5
FLASH_TOL = 2e-5
FLASH_GRAD_TOL = 1e-4
FLASH_LP_TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3}
RTC_TOL = 1e-5
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


def _wq_case(dev, dtype, T, K, N, x_range=None):
    rng = np.random.RandomState(7)
    q, s = tquant.quantize_leaf(
        rng.randn(K, N).astype(np.float32) / np.sqrt(K), dtype)
    x = rng.randn(T, K)
    if x_range is not None:       # column k scaled by lo .. hi, log-spaced
        x *= np.logspace(np.log10(x_range[0]), np.log10(x_range[1]), K)
    return (torch.from_numpy(x.astype(np.float32)).to(dev), q.to(dev),
            s.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("T", [1, 8, 16, 17, 23, 38, 128])
@pytest.mark.parametrize("K,N", [(768, 50257), (3072, 768), (768, 3072),
                                 (768, 768), (203, 130)])
def test_wq_matmul_kernel_matches_plain(cuda, dtype, T, K, N):
    """T over the M-tile edge (16/17) and the engine's packed-length
    ladder; (K, N) the model's four shapes and a ragged one, K and N
    multiples of no tile (K = 203 leaves x's rows and N = 130 the weight
    rows off 16-byte boundaries)."""
    x, q, s = _wq_case(cuda, dtype, T, K, N)
    name = tqz.kernel_name(q.dtype)
    before = kernels.launch_counts().get(name, 0)
    got = tqz.quantized_matmul(x, q, s)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    want = tqz.quantized_matmul_reference(x, q, s)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) < WQ_TOL * scale


def _tf32_hi(x):
    """x rounded to TF32 (nearest, ties away), as cvt.rna.tf32.f32."""
    b = x.view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("T,K,N", [(8, 3072, 768), (38, 768, 3072)])
def test_wq_matmul_kernel_keeps_f32_accuracy_over_a_wide_range(
        cuda, dtype, T, K, N):
    """x's columns span 1e-3 .. 1e3: the kernel's error stays within
    ``WQ_TOL``, where the same product with x rounded once to TF32 (a
    kernel without the lo pass) does not."""
    x, q, s = _wq_case(cuda, dtype, T, K, N, x_range=(1e-3, 1e3))
    got = tqz.quantized_matmul(x, q, s)
    torch.cuda.synchronize()
    want = (x.double() @ q.double()) * s.double()
    tol = WQ_TOL * max(1.0, float(want.abs().max()))
    hi_only = (_tf32_hi(x).double() @ q.double()) * s.double()
    assert float((hi_only - want).abs().max()) > tol
    assert float((got.double() - want).abs().max()) < tol


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    t = _attention_inputs("float32", cuda)
    with pytest.raises(TypeError):
        tra.ragged_flat_attention(**dict(
            t, block_tables=t["block_tables"].long()))
    # every head dim up to 256 is taken; 264 is not
    big = _attention_inputs("float32", cuda, H=2, D=264, n_blocks=32)
    with pytest.raises(ValueError, match="head_dim"):
        tra.ragged_flat_attention(**big)
    q, s = tquant.quantize_leaf(np.eye(64, dtype=np.float32), "int8")
    with pytest.raises(ValueError, match="on cpu"):
        tqz.quantized_matmul(torch.ones(2, 64, device=cuda), q, s)
    # rows of 65 bytes: the view from row 1 starts off a 16-byte boundary
    q, s = tquant.quantize_leaf(np.ones((65, 65), np.float32), "int8")
    with pytest.raises(ValueError, match="16-byte"):
        tqz.quantized_matmul(torch.ones(2, 64, device=cuda),
                             q.to(cuda)[1:], s.to(cuda))


def _flash_inputs(dev, B, H, Tq, Tk, D, padding, seed=0, amp=1.0):
    g = torch.Generator().manual_seed(seed)
    q, dout = (torch.randn(B, H, Tq, D, generator=g) for _ in range(2))
    k, v = (torch.randn(B, H, Tk, D, generator=g) for _ in range(2))
    q, k = q * amp, k * amp
    bias = None
    if padding:
        lens = torch.randint(1, Tk + 1, (B,), generator=g)
        lens[0] = Tk
        bias = torch.where(torch.arange(Tk)[None, :] < lens[:, None], 0.0,
                           -1e30)
    return [t.to(dev) if t is not None else None
            for t in (q, k, v, bias, dout)]


def _rel(got, want):
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max()) / max(
        1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Tq,Tk,D,padding,causal,amp", [
    (2, 3, 64, 64, 64, False, False, 1.0),
    (2, 2, 100, 37, 64, True, True, 1.0),   # ragged, Tq > Tk, one key tile
    (1, 2, 130, 200, 32, True, False, 1.0),  # three query, four key tiles
    (2, 1, 17, 17, 128, False, True, 1.0),
    (1, 1, 5, 70, 16, True, False, 1.0),
    # q and k scaled so that scores reach +-30: the lo passes and the
    # online rescale carry weight
    (2, 2, 192, 256, 64, True, False, 2.8),
])
def test_flash_kernels_match_plain(cuda, B, H, Tq, Tk, D, padding, causal,
                                   amp):
    q, k, v, bias, dout = _flash_inputs(cuda, B, H, Tq, Tk, D, padding,
                                        amp=amp)
    if amp != 1.0:
        scores = (q @ k.transpose(-1, -2)) * D ** -0.5
        assert float(scores.abs().max()) >= 30.0
    scale = D ** -0.5
    before = kernels.launch_counts()
    out, lse = tfa.flash_forward(q, k, v, bias, causal, scale)
    torch.cuda.synchronize()
    ref_out, ref_lse = tfa.flash_forward_reference(q, k, v, bias, causal,
                                                   scale)
    assert _rel(out, ref_out) < FLASH_TOL
    assert _rel(lse, ref_lse) < FLASH_TOL
    delta = (dout * ref_out).sum(-1).reshape(B * H, Tq)
    args = (q, k, v, bias, dout, ref_lse, delta, causal, scale)
    got = tfa.flash_bwd_dkv(*args, want_dbias=padding)
    dq = tfa.flash_bwd_dq(*args)
    torch.cuda.synchronize()
    want = tfa.flash_bwd_dkv_reference(*args, want_dbias=padding)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert _rel(g, w) < FLASH_TOL
    assert _rel(dq, tfa.flash_bwd_dq_reference(*args)) < FLASH_TOL
    after = kernels.launch_counts()
    for name in tfa.KERNEL_NAMES:
        assert after[name] == before.get(name, 0) + 1


def _flash_backward(args, want_dbias):
    """``(dk, dv, dbias, dq)`` of the two backward kernels."""
    dk, dv, db = tfa.flash_bwd_dkv(*args, want_dbias=want_dbias)
    dq = tfa.flash_bwd_dq(*args)
    torch.cuda.synchronize()
    return dk, dv, db, dq


def _bert_backward_case(dev, padding, causal):
    """One attention layer of BERT-base's backward at batch 2 (B=2, H=12,
    T=512, D=64): the backward kernels' arguments, lse and delta from
    the forward's twin."""
    B, H, T, D = 2, 12, 512, 64
    q, k, v, bias, dout = _flash_inputs(dev, B, H, T, T, D, padding)
    scale = D ** -0.5
    out, lse = tfa.flash_forward_reference(q, k, v, bias, causal, scale)
    delta = (dout * out).sum(-1).reshape(B * H, T)
    return (q, k, v, bias, dout, lse, delta, causal, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("padding,causal", [(True, False), (False, True)],
                         ids=["padding", "causal"])
def test_flash_backward_keeps_f32_accuracy_at_bert_shapes(cuda, padding,
                                                          causal):
    """dK, dV, dbias and dQ against the twins evaluated in float64 on the
    same inputs: the split-TF32 products stay within ``FLASH_TOL`` of the
    exact result, where the same backward with q, k, v and dout rounded
    once to TF32 (a kernel without the lo passes) does not."""
    args = _bert_backward_case(cuda, padding, causal)
    got = _flash_backward(args, padding)
    wide = tuple(a.double() for a in args[:3]) + (args[3], args[4].double(),
                                                  *args[5:])
    dk, dv, db = tfa.flash_bwd_dkv_reference(*wide, want_dbias=padding)
    want = (dk, dv, db, tfa.flash_bwd_dq_reference(*wide))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert _rel(g.double(), w) < FLASH_TOL
    hi = tuple(_tf32_hi(a).double() for a in args[:3]) + (
        args[3], _tf32_hi(args[4]).double(), *args[5:])
    hk, hv, _ = tfa.flash_bwd_dkv_reference(*hi)
    hq = tfa.flash_bwd_dq_reference(*hi)
    assert max(_rel(h, w) for h, w in
               zip((hk, hv, hq), (want[0], want[1], want[3]))) > FLASH_TOL


@pytest.mark.cuda
def test_flash_backward_is_deterministic(cuda):
    """Two launches of each backward kernel on the same inputs give
    bit-identical dK, dV, dbias and dQ: every output element is written
    once, by one thread, with no atomics."""
    args = _bert_backward_case(cuda, True, False)
    first = _flash_backward(args, True)
    second = _flash_backward(args, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_function_grads_match_reference_autograd(cuda, causal):
    """The autograd.Function (forward kernel, saved logsumexp, backward
    kernels) against torch autograd through ``attention_reference``, on
    the card; Tq == Tk, where the two causal masks agree."""
    q, k, v, bias, dout = _flash_inputs(cuda, 2, 3, 96, 96, 64, True, 1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out = tfa.flash_attention(*leaves[:3], bias=leaves[3], causal=causal)
    out.backward(dout)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    ref = tfa.attention_reference(*ref_leaves, causal=causal)
    ref.backward(dout)
    assert _rel(out, ref) < FLASH_TOL
    for a, b in zip(leaves, ref_leaves):
        assert _rel(a.grad, b.grad) < FLASH_GRAD_TOL


@pytest.mark.cuda
def test_flash_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v, bias, _ = _flash_inputs(cuda, 1, 2, 8, 8, 64, True)
    with pytest.raises(TypeError):
        tfa.flash_forward(q.double(), k.double(), v.double(), None, False,
                          None)
    # every head dim up to 256 is taken (padded); 264 is not
    q2, k2, v2, _, _ = _flash_inputs(cuda, 1, 2, 8, 8, 264, False)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_forward(q2, k2, v2, None, False, None)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_forward(q.transpose(2, 3).contiguous().transpose(2, 3),
                          k, v, bias, False, None)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["none", "padding", "causal"])
@pytest.mark.parametrize("D", [16, 33, 64, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_flash_16bit_kernels_match_twins(cuda, dtype, D, mask):
    """The bf16 and f16 forward, dK/dV and dQ kernels against their twins
    (which round P and dS where the TPU kernels do) over head dims that
    hit every instantiation (33 and 192 zero-padded), ragged tiles (Tq
    100, Tk 130) and each mask; two launches give the same bits, and
    each launch counts under its dtype's name."""
    causal, padding = mask == "causal", mask == "padding"
    B, H, Tq, Tk = 2, 3, 100, 100 if causal else 130
    q, k, v, bias, dout = _flash_inputs(cuda, B, H, Tq, Tk, D, padding,
                                        seed=D)
    q, k, v, dout = (t.to(dtype) for t in (q, k, v, dout))
    scale = D ** -0.5
    before = kernels.launch_counts()
    out, lse = tfa.flash_forward(q, k, v, bias, causal, scale)
    again = tfa.flash_forward(q, k, v, bias, causal, scale)
    ref_out, ref_lse = tfa.flash_forward_reference(q, k, v, bias, causal,
                                                   scale)
    torch.cuda.synchronize()
    tol = FLASH_LP_TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert _rel(out.float(), ref_out.float()) < tol
    assert _rel(lse, ref_lse) < FLASH_TOL
    delta = (dout.float() * ref_out.float()).sum(-1).reshape(B * H, Tq)
    args = (q, k, v, bias, dout, ref_lse, delta, causal, scale)
    got = _flash_backward(args, padding)
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(got, _flash_backward(args, padding)))
    dk, dv, db = tfa.flash_bwd_dkv_reference(*args, want_dbias=padding)
    want = (dk, dv, db, tfa.flash_bwd_dq_reference(*args))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype
            assert _rel(g.float(), w.float()) < tol
    after = kernels.launch_counts()
    for name in tfa.KERNEL_NAMES:
        lp = tfa.kernel_name(name, dtype)
        assert after[lp] == before.get(lp, 0) + 2
        assert after.get(name, 0) == before.get(name, 0)


@pytest.mark.cuda
def test_flash_wrappers_raise_on_dtypes_without_a_kernel(cuda):
    """No quiet upcast: a CUDA tensor in a dtype without a kernel (f64),
    or q, k, v, dout of mixed dtypes, or a bias in another 16-bit type,
    raises, and nothing launches."""
    q, k, v, bias, dout = _flash_inputs(cuda, 1, 2, 8, 8, 64, True)
    bf = [t.bfloat16() for t in (q, k, v, dout)]
    lse = torch.zeros(2, 8, device=cuda)
    before = kernels.launch_counts()
    with pytest.raises(TypeError):
        tfa.flash_forward(q.double(), k.double(), v.double(), None, False,
                          None)
    with pytest.raises(TypeError):
        tfa.flash_forward(bf[0], k, v, None, False, None)
    with pytest.raises(TypeError):
        tfa.flash_forward(bf[0], bf[1], v.half(), None, False, None)
    with pytest.raises(TypeError):
        tfa.flash_forward(*bf[:3], bias.half(), False, None)
    with pytest.raises(TypeError):
        tfa.flash_bwd_dq(*bf[:3], None, dout, lse, lse, False, None)
    with pytest.raises(TypeError):
        tfa.flash_bwd_dkv(*bf[:3], None, bf[3], lse.bfloat16(), lse, False,
                          None)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.double(), k.double(), v.double())
    assert kernels.launch_counts() == before
    # the 16-bit bias AMP passes is taken (widened once, exactly)
    out, _ = tfa.flash_forward(*bf[:3], bias.bfloat16(), False, None)
    ref, _ = tfa.flash_forward(*bf[:3], bias.bfloat16().float(), False,
                               None)
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_small_bert_under_amp_matches_its_plain_path(cuda):
    """A 2-layer BERT (units 64, 4 heads, T 128) under ``amp.init()``:
    one step through the bf16 flash kernels against the op's plain path
    under AMP, on the flash path's ReLU gates (a gate at a bf16 tie may
    flip between the paths): the loss within 1e-3, every gradient within
    chip_smoke's ``AMP_GRAD_REL_TOL`` (norm-relative); each bf16 kernel
    launched once a layer. The key projections' biases are left out:
    their gradient is zero in exact arithmetic (softmax does not move
    when a constant is added to a query's every score), so both paths
    give rounding noise."""
    from mxnet_tpu_torch import amp, gluon
    from mxnet_tpu_torch.initializer import Xavier
    cfg = dict(vocab_size=30522, units=64, hidden_size=128, num_layers=2,
               num_heads=4, max_length=128)
    rng = np.random.RandomState(0)
    data = [(x.int(), y, w, vl) for x, y, w, vl in chip_smoke.bert_batches(
        torch, rng, 1, cfg["vocab_size"], 4, 128, cuda)]
    net = chip_smoke.make_bert_mlm(0.0, **cfg)
    net.initialize(Xavier(), device=cuda,
                   generator=torch.Generator().manual_seed(0))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    gate = {}

    def hook(mod, inputs, out):
        if "g" not in gate:
            gate["g"] = inputs[0] > 0
            return None
        return inputs[0] * gate["g"].to(inputs[0].dtype)
    # torch's own hook (its return value replaces the output); gluon's
    # register_forward_hook has the reference's, which ignores it
    handle = torch.nn.Module.register_forward_hook(net.transform.act, hook)
    amp.init()
    try:
        res = {}
        for flash in (True, False):
            chip_smoke.set_flash(net, flash)
            before = kernels.launch_counts()
            with ag.record():
                loss = chip_smoke.mlm_loss(net, loss_fn, data[0],
                                           cfg["vocab_size"])
            loss.backward()
            after = kernels.launch_counts()
            for name in tfa.KERNEL_NAMES:
                lp = tfa.kernel_name(name, torch.bfloat16)
                assert after.get(lp, 0) - before.get(lp, 0) == (
                    2 if flash else 0)
            res[flash] = (float(loss.detach()), {
                n: p.grad().clone() for n, p in
                net.collect_params().items()})
    finally:
        amp.uninit()
        handle.remove()
    assert abs(res[True][0] - res[False][0]) <= 1e-3 * abs(res[False][0])
    for name, g in res[False][1].items():
        assert res[True][1][name].dtype == torch.float32
        if not name.endswith("attn_key_bias"):
            assert chip_smoke.norm_rel(res[True][1][name], g) <= \
                chip_smoke.AMP_GRAD_REL_TOL, name


def _paged_inputs(dev, chunk, H=4, D=64, n_blocks=40):
    """Fragmented tables over 4 rows with kv lengths at block edges
    (bs-1, bs, 2bs+1) and a long one; chunk rows query their last
    q_lens = (5, 1, 16, 7) positions of Q=16 (padded tails on three)."""
    g = torch.Generator().manual_seed(1)
    tables = torch.tensor([[9, 0, 0, 0, 0], [3, 0, 0, 0, 0],
                           [7, 12, 30, 0, 0], [2, 8, 6, 4, 22]],
                          dtype=torch.int32)
    kv = torch.tensor([BS - 1, BS, 2 * BS + 1, 5 * BS], dtype=torch.int32)
    out = dict(block_tables=tables, kv_lens=kv)
    if chunk:
        out["q"] = torch.randn(4, 16, H, D, generator=g)
        out["q_lens"] = torch.tensor([5, 1, 16, 7], dtype=torch.int32)
    else:
        out["q"] = torch.randn(4, H, D, generator=g)
    for name in ("k_pages", "v_pages"):
        out[name] = torch.randn(n_blocks, BS, H, D, generator=g)
    return {k: v.to(dev) for k, v in out.items()}


def _valid(t, out):
    if "q_lens" not in t:
        return out
    return torch.cat([out[i, :n] for i, n in
                      enumerate(t["q_lens"].tolist())])


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_paged_kernels_match_plain(cuda, chunk):
    t = _paged_inputs(cuda, chunk)
    name = tra.CHUNK_KERNEL if chunk else tra.DECODE_KERNEL
    before = kernels.launch_counts().get(name, 0)
    got = tra.ragged_paged_attention(**t)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    want = (tra.ragged_chunk_attention_reference(**t) if chunk else
            tra.ragged_attention_reference(**t))
    assert float((_valid(t, got) - _valid(t, want)).abs().max()) < ATT_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_paged_kernels_garbage_invisible(cuda, chunk):
    t = _paged_inputs(cuda, chunk)
    clean = tra.ragged_paged_attention(**t)
    used = set(t["block_tables"].flatten().tolist()) - {0}
    for name, val in (("k_pages", 1e6), ("v_pages", -1e6)):
        for b in range(t[name].shape[0]):
            if b not in used:
                t[name][b] = val
        for i, n in enumerate(t["kv_lens"].tolist()):
            last = int(t["block_tables"][i, (n - 1) // BS])
            t[name][last, n % BS or BS:] = val
    if chunk:
        for i, n in enumerate(t["q_lens"].tolist()):
            t["q"][i, n:] = 1e6
    got = tra.ragged_paged_attention(**t)
    assert torch.equal(_valid(t, got), _valid(t, clean))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_paged_wrappers_reject_what_the_kernels_do_not_take(cuda, chunk):
    t = _paged_inputs(cuda, chunk)
    call = tra.ragged_paged_attention
    with pytest.raises(TypeError):
        call(**dict(t, kv_lens=t["kv_lens"].long()))
    with pytest.raises(TypeError, match="bfloat16 or float16 pages"):
        call(**dict(t, k_pages=t["k_pages"].double(),
                    v_pages=t["v_pages"].double()))
    with pytest.raises(ValueError, match="shape"):
        call(**dict(t, block_tables=t["block_tables"][:2]))
    with pytest.raises(ValueError, match="on cpu"):
        call(**dict(t, kv_lens=t["kv_lens"].cpu()))
    with pytest.raises(ValueError, match="contiguous"):
        call(**dict(t, k_pages=t["k_pages"].transpose(2, 3)
                    .contiguous().transpose(2, 3)))
    big = _paged_inputs(cuda, chunk, H=1, D=264)
    with pytest.raises(ValueError, match="head_dim"):
        call(**big)


@pytest.fixture
def rtc_ops(cuda):
    from mxnet_tpu_torch.ops.registry import _REGISTRY
    names, plain = chip_smoke.register_rtc_ops("cuda_test_")
    yield names, plain
    for n in names.values():
        _REGISTRY.pop(n, None)


@pytest.mark.cuda
def test_rtc_kernels_match_plain(cuda, rtc_ops):
    names, plain = rtc_ops
    g = torch.Generator().manual_seed(2)
    x, y = (torch.randn(300, 1000, generator=g).to(cuda) for _ in range(2))
    before = kernels.launch_counts()
    for k, args in (("scale_add", (x, y)), ("square", (x,)),
                    ("rowsum", (x,))):
        got = getattr(nd, names[k])(*args)
        torch.cuda.synchronize()
        want = plain[k](*args)
        assert got.shape == want.shape
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= RTC_TOL * scale
        counter = f"rtc.{names[k]}"
        assert kernels.launch_counts()[counter] == before.get(counter,
                                                              0) + 1


@pytest.mark.cuda
def test_rtc_square_gradient_and_no_second_build(cuda, rtc_ops):
    names, _ = rtc_ops
    x = torch.linspace(-3, 3, 1000, device=cuda).requires_grad_()
    with ag.record():
        y = getattr(nd, names["square"])(x).sum()
    y.backward()
    assert torch.equal(x.grad, 2 * x.detach())
    builds = kernels.build_count()
    again, _ = chip_smoke.register_rtc_ops("cuda_test_again_")
    try:
        getattr(nd, again["square"])(x.detach())
        torch.cuda.synchronize()
        assert kernels.build_count() == builds
    finally:
        from mxnet_tpu_torch.ops.registry import _REGISTRY
        for n in again.values():
            _REGISTRY.pop(n, None)


# -------------------------------------------- every head dim up to 256 --
def _ring_flat_case(dev, dtype, D, H=4, seed=0):
    """Packed tokens over fragmented tables at kv lengths 15/16/17/1024
    (positions 14/15/16/1023) and mid-page, one corrupt table entry
    (clamped into the pool by the kernel; the plain twin gets the clamped
    table)."""
    rng = np.random.RandomState(seed)
    S, MB = 4, 64
    N = S * MB + 3
    tables = rng.permutation(np.arange(1, N)).astype(np.int32)[
        :S * MB].reshape(S, MB)
    seq_ids = np.array([0, 1, 2, 3, 3, 2, 1], np.int32)
    positions = np.array([14, 15, 16, 1023, 700, 33, 0], np.int32)
    q = rng.randn(len(seq_ids), H, D).astype(np.float32)
    kf, vf = (torch.from_numpy(rng.randn(N, BS, H, D).astype(np.float32))
              for _ in range(2))
    t = dict(q=torch.from_numpy(q), seq_ids=torch.from_numpy(seq_ids),
             positions=torch.from_numpy(positions))
    if dtype == "float32":
        t["k_pages"], t["v_pages"] = kf, vf
    else:
        dt = torch.int8 if dtype == "int8" else torch.float8_e4m3fn
        for name, x in (("k", kf), ("v", vf)):
            xq, sc = _quantize_kv(x.reshape(-1, H, D), dt)
            t[f"{name}_pages"] = xq.reshape(N, BS, H, D)
            t[f"{name}_scales"] = sc.reshape(N, BS, H)
    clamped = torch.from_numpy(tables.copy())
    tables[3, 10] = 10 ** 7
    tables[3, 11] = -5
    clamped[3, 10], clamped[3, 11] = N - 1, 0
    t["block_tables"] = torch.from_numpy(tables)
    t = {k: v.to(dev) for k, v in t.items()}
    return t, dict(t, block_tables=clamped.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("D,H", [(16, 4), (48, 4), (64, 4), (96, 4),
                                 (256, 4), (15, 3)])
@pytest.mark.parametrize("dtype", ["float32", "int8", "fp8"])
def test_flat_kernels_every_head_dim(cuda, D, H, dtype):
    """K1 (f32) and the staged K2 (int8, fp8) against the plain twin;
    two launches give the same bits. At D=15 with 3 heads a staged slot
    run is 45 bytes: the pages are copied a byte at a time."""
    t, ref = _ring_flat_case(cuda, dtype, D, H=H)
    name = tra.kernel_name(t["k_pages"].dtype)
    before = kernels.launch_counts().get(name, 0)
    got = tra.ragged_flat_attention(**t)
    again = tra.ragged_flat_attention(**t)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 2
    want = tra.ragged_flat_attention_reference(**ref)
    assert float((got - want).abs().max()) < ATT_TOL
    assert torch.equal(got, again)


def _ring_chunk_case(dev, D, Q, H=4, seed=1):
    """Chunk rows at kv lengths 15/16/17/1024 and 40 with q_len 0 (no
    output contract), fragmented tables, a corrupt entry past the live
    pages of row 0 (never read)."""
    rng = np.random.RandomState(seed)
    S, MB = 5, 64
    N = S * MB + 2
    tables = rng.permutation(np.arange(1, N)).astype(np.int32)[
        :S * MB].reshape(S, MB)
    tables[0, 5] = 10 ** 7
    kv = np.array([15, 16, 17, 1024, 40], np.int32)
    ql = np.minimum(Q, kv).astype(np.int32)
    ql[4] = 0
    t = dict(q=torch.from_numpy(rng.randn(S, Q, H, D).astype(np.float32)),
             k_pages=torch.from_numpy(
                 rng.randn(N, BS, H, D).astype(np.float32)),
             v_pages=torch.from_numpy(
                 rng.randn(N, BS, H, D).astype(np.float32)),
             block_tables=torch.from_numpy(tables),
             kv_lens=torch.from_numpy(kv), q_lens=torch.from_numpy(ql))
    return {k: v.to(dev) for k, v in t.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 48, 64, 96, 256])
@pytest.mark.parametrize("Q", [1, 16, 20])
def test_chunk_kernel_every_head_dim(cuda, D, Q):
    """The staged K4 on its valid tokens against the plain twin; two
    launches give the same bits; K5 on the same pools at Q=1."""
    t = _ring_chunk_case(cuda, D, Q)
    before = kernels.launch_counts().get(tra.CHUNK_KERNEL, 0)
    got = tra.ragged_paged_attention(**t)
    again = tra.ragged_paged_attention(**t)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[tra.CHUNK_KERNEL] == before + 2
    ref = dict(t, block_tables=t["block_tables"].clamp(
        0, t["k_pages"].shape[0] - 1))
    want = tra.ragged_chunk_attention_reference(**ref)
    assert float((_valid(t, got) - _valid(t, want)).abs().max()) < ATT_TOL
    assert torch.equal(got, again)
    if Q == 1:
        d = dict(ref, q=t["q"][:, 0].contiguous())
        d.pop("q_lens")
        got = tra.ragged_paged_attention(**d)
        want = tra.ragged_attention_reference(**d)
        assert float((got - want).abs().max()) < ATT_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("D", [48, 96])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_pad_other_head_dims(cuda, D, causal):
    q, k, v, bias, dout = _flash_inputs(cuda, 2, 3, 70, 90, D, True)
    scale = D ** -0.5
    out, lse = tfa.flash_forward(q, k, v, bias, causal, None)
    assert out.shape == q.shape and out.is_contiguous()
    wo, wl = tfa.flash_forward_reference(q, k, v, bias, causal, scale)
    assert _rel(out, wo) < FLASH_TOL
    assert _rel(lse, wl) < FLASH_TOL
    got = tfa.flash_backward(q, k, v, bias, out, lse, dout, causal, None)
    want = tfa.flash_backward_reference(q, k, v, bias, wo, wl, dout,
                                        causal, scale)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel(a, b) < FLASH_TOL


@pytest.mark.cuda
def test_default_decoder_config_serves_through_the_kernels(cuda):
    """The reference's default DecoderConfig (head dim 16) through
    LLMServer with dtype="float32": the greedy oracle's streams."""
    from mxnet_tpu_torch.serving.llm import (LLMServer, TinyDecoder,
                                             greedy_decode_reference)
    model = TinyDecoder(device=cuda)
    params = model.init_params_numpy(0)
    srv = LLMServer(model, params, max_seqs=4, block_size=BS,
                    dtype="float32", device=cuda)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, model.vocab_size, size=n).tolist()
               for n in (1, 15, 17, 40)]
    srv.start()
    before = kernels.launch_counts().get("flat_attention", 0)
    try:
        got = [f.result(timeout=120).tokens
               for f in [srv.submit(p, 12) for p in prompts]]
    finally:
        srv.shutdown()
    assert kernels.launch_counts()["flat_attention"] > before
    p = srv.engine.params
    assert got == [greedy_decode_reference(model, p, pr, 12)
                   for pr in prompts]


# ------------------- K1 and K5 on the staged kernel, flash at D <= 256 --
def _run(seq, p0, n):
    return [seq] * n, list(range(p0, p0 + n))


def _packed(*runs):
    ids, pos = [], []
    for a, b in runs:
        ids += a
        pos += b
    return ids, pos


# (seq_ids, positions), table rows: block 16, 64 table columns
_PACKS = {
    # a prefill pack: 8 rows' 16-token chunks, across page edges
    "prefill": (_packed(*(_run(s, 16 * s + 7 * s, 16) for s in range(8))),
                8),
    # 7 decode tokens, a 16-token chunk and a 5-token prompt tail
    "mixed": (_packed(_run(0, 1023, 1), _run(1, 15, 1), _run(2, 100, 16),
                      _run(3, 16, 1), _run(4, 0, 5), _run(5, 511, 1),
                      _run(6, 700, 1), _run(7, 47, 1)), 8),
    # three 16-token chunks, then the step's padding: one stale entry
    # (a fresh buffer's zeros) repeated
    "padded": (_packed(_run(0, 0, 16), _run(3, 16, 16), _run(5, 40, 16),
                       ([0] * 80, [0] * 80)), 8),
    # unsorted, repeated, gapped, stale padding, rows out of range, a run
    # of 40
    "adversarial": (_packed(_run(1, 9, 1), _run(1, 8, 1), _run(1, 7, 1),
                            _run(0, 5, 3), _run(0, 7, 2),
                            ([2, 2, 2], [3, 5, 6]), _run(9, 31, 4),
                            _run(-3, 64, 2), _run(3, 200, 40),
                            _run(0, 0, 1), _run(0, 0, 1)), 4),
}


def _pack_case(dev, dtype, D, pack, H=4, seed=2):
    """Pools and q for a pack of ``_PACKS``; returns the kernel's
    arguments and the plain twin's (seq_ids clamped into the table, as
    the kernel clamps them)."""
    (seq_ids, positions), S = _PACKS[pack]
    rng = np.random.RandomState(seed)
    MB = 64
    N = S * MB + 1
    tables = rng.permutation(np.arange(1, N)).astype(np.int32)[
        :S * MB].reshape(S, MB)
    t = dict(q=torch.from_numpy(
                 rng.randn(len(seq_ids), H, D).astype(np.float32)),
             block_tables=torch.from_numpy(tables),
             seq_ids=torch.tensor(seq_ids, dtype=torch.int32),
             positions=torch.tensor(positions, dtype=torch.int32))
    for name in ("k", "v"):
        x = torch.from_numpy(rng.randn(N, BS, H, D).astype(np.float32))
        if dtype == "float32":
            t[f"{name}_pages"] = x
        else:
            xq, sc = _quantize_kv(x.reshape(-1, H, D), torch.int8)
            t[f"{name}_pages"] = xq.reshape(N, BS, H, D)
            t[f"{name}_scales"] = sc.reshape(N, BS, H)
    t = {k: v.to(dev) for k, v in t.items()}
    return t, dict(t, seq_ids=t["seq_ids"].clamp(0, S - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 33, 64, 96, 128, 256])
@pytest.mark.parametrize("pack", sorted(_PACKS))
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_flat_kernels_tile_the_pack_by_runs(cuda, D, pack, dtype):
    """K1 (and K2, which shares its tiles) on the staged kernel, whose
    query tiles are the pack's runs of one seq_id cut into slots:
    engine-shaped (padding included) and adversarial packs against the
    plain twin; two launches give the same bits."""
    t, ref = _pack_case(cuda, dtype, D, pack)
    name = tra.kernel_name(t["k_pages"].dtype)
    before = kernels.launch_counts().get(name, 0)
    got = tra.ragged_flat_attention(**t)
    again = tra.ragged_flat_attention(**t)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 2
    want = tra.ragged_flat_attention_reference(**ref)
    assert float((got - want).abs().max()) < ATT_TOL
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 33, 64, 96, 128, 256])
def test_decode_kernel_every_head_dim(cuda, D):
    """K5 on the staged kernel: rows at kv lengths 1, 15, 16, 17, 300,
    1024 against the plain twin, rows with kv_len 0 give exactly 0, a
    corrupt table entry past a row's live pages is never read; two
    launches give the same bits."""
    rng = np.random.RandomState(D)
    H, MB = 4, 64
    kv = np.array([0, 1, 15, 16, 17, 1024, 300, 0], np.int32)
    S = len(kv)
    N = S * MB + 1
    tables = rng.permutation(np.arange(1, N)).astype(np.int32)[
        :S * MB].reshape(S, MB)
    tables[2, 1] = 10 ** 7
    t = dict(q=torch.from_numpy(rng.randn(S, H, D).astype(np.float32)),
             k_pages=torch.from_numpy(
                 rng.randn(N, BS, H, D).astype(np.float32)),
             v_pages=torch.from_numpy(
                 rng.randn(N, BS, H, D).astype(np.float32)),
             block_tables=torch.from_numpy(tables),
             kv_lens=torch.from_numpy(kv))
    t = {k: v.to(cuda) for k, v in t.items()}
    before = kernels.launch_counts().get(tra.DECODE_KERNEL, 0)
    got = tra.ragged_paged_attention(**t)
    again = tra.ragged_paged_attention(**t)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[tra.DECODE_KERNEL] == before + 2
    assert torch.equal(got, again)
    live = torch.from_numpy(kv > 0).to(cuda)
    assert not got[~live].any()
    want = tra.ragged_attention_reference(**dict(
        t, block_tables=t["block_tables"].clamp(0, N - 1)))
    assert float((got[live] - want[live]).abs().max()) < ATT_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("D", [129, 192, 256])
@pytest.mark.parametrize("padding,causal", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_flash_kernels_wide_head_dims(cuda, D, padding, causal):
    """Head dims 129 to 256 (the 256 instantiation, 32-row tiles; 129
    and 192 zero-padded to it): forward, dK/dV(/dbias) and dQ against
    the plain twins, ragged Tq != Tk; two launches give the same bits."""
    q, k, v, bias, dout = _flash_inputs(cuda, 2, 3, 70, 90, D, padding,
                                        seed=D)
    scale = D ** -0.5
    before = kernels.launch_counts()
    out, lse = tfa.flash_forward(q, k, v, bias, causal, None)
    wo, wl = tfa.flash_forward_reference(q, k, v, bias, causal, scale)
    assert out.shape == q.shape
    assert _rel(out, wo) < FLASH_TOL
    assert _rel(lse, wl) < FLASH_TOL
    delta = (dout * wo).sum(-1).reshape(-1, q.shape[2])
    args = (q, k, v, bias, dout, wl, delta, causal, scale)
    got = _flash_backward(args, padding)
    want = tfa.flash_bwd_dkv_reference(*args, want_dbias=padding) + (
        tfa.flash_bwd_dq_reference(*args),)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.shape == w.shape
            assert _rel(g, w) < FLASH_TOL
    after = kernels.launch_counts()
    for name in tfa.KERNEL_NAMES:
        assert after[name] == before.get(name, 0) + 1
    out2, lse2 = tfa.flash_forward(q, k, v, bias, causal, None)
    again = _flash_backward(args, padding)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    for g, a in zip(got, again):
        assert (g is None and a is None) or torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["default", "gpt2_small",
                                    "gpt2_small_int8"])
def test_llm_server_serves_the_oracle_streams_after_warmup(cuda, config):
    """``LLMServer`` on the reference's default config (head dim 16), at
    GPT-2-small widths, and there with int8 KV + int8 weights, serving
    greedy and sampled requests. Greedy streams equal
    ``greedy_decode_reference`` (or leave it only on a near tie, as
    chip_smoke.check_greedy allows); int8's oracle is the same engine
    on the CPU (every kernel's plain version); a sampled stream repeats
    under its seed. Every dispatch after ``warmup()`` is one graph
    replay: ``decode_flat`` never runs in Python, nothing is built or
    captured, and the flat kernel launched once a layer a dispatch,
    counted through the replays."""
    from mxnet_tpu_torch.serving.llm import (LLMEngine, LLMServer,
                                             Sequence, TinyDecoder)
    kw = {} if config == "default" else chip_smoke.GPT2_SMALL
    quant = dict(kv_dtype="int8", weight_dtype="int8") \
        if config.endswith("int8") else {}
    model = TinyDecoder(device=cuda, **kw)
    params = model.init_params_numpy(0)
    srv = LLMServer(model, params, max_seqs=8, block_size=BS,
                    dtype="float32", device=cuda, **quant)
    srv.warmup()
    compiles = srv.stats()["compiles"]
    before = srv.stats()["programs"]
    assert before["graphs"] == before["step_variants"] == 2 * len(
        before["t_buckets"]) * len(before["mb_widths"])
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, model.vocab_size, size=n).tolist()
               for n in (1, 15, 16, 17, 40, 100)]
    name = tra.kernel_name(srv.engine.cache.k_pages.dtype)
    launched = kernels.launch_counts().get(name, 0)
    calls = []
    step = model.decode_flat
    model.decode_flat = lambda *a, **k: (calls.append(1), step(*a, **k))[1]
    samp = dict(temperature=0.8, top_p=0.9, seed=7)
    srv.start()
    try:
        futs = [srv.submit(p, 8) for p in prompts]
        futs += [srv.submit(prompts[4], 8, sampling=samp) for _ in range(2)]
        got = [f.result(timeout=300).tokens for f in futs]
    finally:
        srv.shutdown()
        del model.decode_flat
    after = srv.stats()["programs"]
    dispatches = after["dispatches"] - before["dispatches"]
    assert dispatches > 0
    assert after["replays"] - before["replays"] == dispatches
    assert calls == []
    assert srv.stats()["compiles"] == compiles
    assert kernels.launch_counts()[name] - launched == \
        dispatches * model.num_layers
    assert got[-1] == got[-2]
    if quant:
        cpu = LLMEngine(TinyDecoder(device="cpu", **kw), params,
                        max_seqs=8, block_size=BS, device="cpu", **quant)
        seqs = [Sequence(p, 8) for p in prompts]
        for s in seqs:
            cpu.add(s)
        while cpu.has_work():
            cpu.step()
        assert got[:len(prompts)] == [s.output_tokens() for s in seqs]
        return
    p = srv.engine.params
    for i, (prompt, toks) in enumerate(zip(prompts, got)):
        chip_smoke.check_greedy(model, p, prompt, toks,
                                chip_smoke.F32_LOGIT_TOL,
                                f"{config} request {i}")


@pytest.mark.cuda
def test_lazy_captures_step_on_the_batch_they_are_given(cuda):
    """An engine with no ``warmup()`` captures each rung at its first
    use. Greedy traffic runs and frees its blocks; then greedy and
    sampled requests reuse those blocks, each sampled rung captured in
    the middle of the traffic: every greedy stream equals the oracle's
    and the sampled pair agrees. Then, with the graphs released and
    every block but the null one zeroed, ``warmup()`` captures all
    rungs again: its warm run steps on the all-padding batch it filled,
    not on the last batch a rung uploaded, so no block but the null one
    is written."""
    from mxnet_tpu_torch.serving.llm import LLMEngine, Sequence, TinyDecoder
    from mxnet_tpu_torch.serving.llm.sampling import SamplingParams
    model = TinyDecoder(device=cuda, vocab_size=512, d_model=64,
                        num_heads=4, d_ff=128, max_context=64)
    params = model.init_params_numpy(0)
    eng = LLMEngine(model, params, max_seqs=4, block_size=BS,
                    prefill_chunk=16, prefix_cache=False, device=cuda)
    rng = np.random.RandomState(11)

    def serve(seqs):
        for s in seqs:
            eng.add(s)
        while eng.has_work():
            eng.step()
        return [s.output_tokens() for s in seqs]

    short = [rng.randint(0, model.vocab_size, size=n).tolist()
             for n in (20, 9, 26, 3)]
    long = [rng.randint(0, model.vocab_size, size=n).tolist()
            for n in (40, 33, 47)]
    first = serve([Sequence(p, 8) for p in short])
    greedy_graphs = eng.programs()["graphs"]
    samp = SamplingParams(temperature=0.8, top_p=0.9, seed=7)
    second = serve([Sequence(p, 8) for p in long]
                   + [Sequence(long[0], 8, sampling=samp) for _ in "ab"])
    progs = eng.programs()
    assert progs["graphs"] > greedy_graphs
    assert progs["replays"] == progs["dispatches"]
    assert second[-1] == second[-2]
    for i, (prompt, toks) in enumerate(zip(short + long,
                                           first + second[:-2])):
        chip_smoke.check_greedy(model, eng.params, prompt, toks,
                                chip_smoke.F32_LOGIT_TOL, f"request {i}")
    eng.release_graphs()
    for pages in (eng.cache.k_pages, eng.cache.v_pages):
        pages[:, 1:].zero_()
    eng.warmup()
    torch.cuda.synchronize()
    warm = eng.programs()
    assert warm["graphs"] == warm["step_variants"] == 2 * len(
        warm["t_buckets"]) * len(warm["mb_widths"])
    for pages in (eng.cache.k_pages, eng.cache.v_pages):
        assert not pages[:, 1:].any()


# ---------------------------------- the serving step under CUDA graphs --
def _step_pack(dev, dtype, T, H=12, D=64, S=8, MB=64, seed=3):
    """A packed step of ``T`` tokens over ``S`` rows of fragmented
    64-page tables: runs of ``T / S`` consecutive positions a row, at
    random depths (one token a row at T = S: a decode step)."""
    rng = np.random.RandomState(seed)
    N = S * MB + 1
    tables = rng.permutation(np.arange(1, N)).astype(np.int32).reshape(
        S, MB)
    run = T // S
    starts = rng.randint(0, MB * BS - run, size=S)
    seq_ids = np.repeat(np.arange(S, dtype=np.int32), run)
    positions = (starts[:, None] + np.arange(run)[None, :]).reshape(-1)
    t = dict(q=torch.from_numpy(rng.randn(T, H, D).astype(np.float32)),
             block_tables=torch.from_numpy(tables),
             seq_ids=torch.from_numpy(seq_ids),
             positions=torch.from_numpy(positions.astype(np.int32)))
    for name in ("k", "v"):
        x = torch.from_numpy(rng.randn(N, BS, H, D).astype(np.float32))
        if dtype == "float32":
            t[f"{name}_pages"] = x
        else:
            dt = torch.int8 if dtype == "int8" else torch.float8_e4m3fn
            xq, sc = _quantize_kv(x.reshape(-1, H, D), dt)
            t[f"{name}_pages"] = xq.reshape(x.shape)
            t[f"{name}_scales"] = sc.reshape(x.shape[:-1])
    return {k: v.to(dev) for k, v in t.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flat.float32", "flat.int8", "flat.fp8",
                                    "wq.int8", "wq.fp8"])
@pytest.mark.parametrize("T", [8, 128])
def test_step_kernels_replay_their_eager_bits_under_capture(cuda, kernel, T):
    """Each kernel of the serving step (K1, K2 int8/fp8, K3 int8/fp8:
    cluster launches through ``cudaLaunchKernelEx``) captured alone in a
    CUDA graph at the step's shapes (T = 8 decode, T = 128 prefill; K3
    at the MLP's 768 x 3072 and, at T = 8, the LM head's 50257 columns
    split over a cluster): a replay gives the eager launch's bits. The
    warm run counts as a launch, the capture adds nothing, each replay
    adds the capture's one launch."""
    family, dtype = kernel.split(".")
    if family == "flat":
        t = _step_pack(cuda, dtype, T)
        name = tra.kernel_name(t["k_pages"].dtype)
        shapes = [t]

        def op(t):
            return tra.ragged_flat_attention(**t)
    else:
        shapes = [_wq_case(cuda, dtype, T, 768, 3072)]
        if T == 8:
            shapes.append(_wq_case(cuda, dtype, T, 768, 50257))
        name = tqz.kernel_name(shapes[0][1].dtype)

        def op(t):
            return tqz.quantized_matmul(*t)
    for args in shapes:
        eager = op(args)
        res = {}

        def fn():
            res["out"] = op(args)
        before = kernels.launch_counts().get(name, 0)
        captures = kernels.capture_count()
        g = kernels.capture(fn, torch.cuda.Stream(cuda), what=kernel)
        assert kernels.capture_count() == captures + 1
        assert kernels.launch_counts()[name] == before + 1
        assert g.tally == {name: 1}
        res["out"].fill_(float("nan"))
        for i in range(2):
            g.replay()
            torch.cuda.synchronize()
            assert torch.equal(res["out"], eager)
            assert kernels.launch_counts()[name] == before + 2 + i


# ------------------------------------------------ bf16 and f16 pages --
LP_PAGES = [torch.bfloat16, torch.float16]


def _lp_tol(want):
    """One ulp of ``want``'s 16-bit dtype at its largest magnitude."""
    return torch.finfo(want.dtype).eps * float(want.float().abs().max())


def _lp_case(dev, shape, dtype, q16, D, H=4):
    """The every-head-dim cases above (fragmented 64-page tables, kv
    lengths 15/16/17/1024, corrupt table entries) with the pages, and
    with ``q16`` q too, in ``dtype``: ``(kernel args, twin args)``."""
    if shape == "flat":
        t, ref = _ring_flat_case(dev, "float32", D, H=H)
    else:
        t = _ring_chunk_case(dev, D, 16 if shape == "chunk16" else 1, H=H)
        if shape == "decode":
            t["q"] = t["q"][:, 0].contiguous()
            t.pop("q_lens")
        ref = dict(t, block_tables=t["block_tables"].clamp(
            0, t["k_pages"].shape[0] - 1))
    cast = ["k_pages", "v_pages"] + (["q"] if q16 else [])
    lp = {k: t[k].to(dtype) for k in cast}
    return dict(t, **lp), dict(ref, **lp)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 24, 64, 128])
@pytest.mark.parametrize("q16", [False, True], ids=["q32", "q16"])
@pytest.mark.parametrize("dtype", LP_PAGES, ids=["bf16", "f16"])
@pytest.mark.parametrize("shape", ["flat", "chunk16", "chunk1", "decode"])
def test_paged_kernels_over_16bit_pages_match_plain(cuda, shape, dtype, q16,
                                                    D):
    """K1, K4 (Q=16 and Q=1) and K5 over bf16/f16 pages, q f32 or in the
    pages' dtype, against their plain twins on the same 16-bit values;
    the output in q's dtype; two launches give the same bits; one
    launch counted under the 16-bit kernel's name. D=24: a 16-bit page
    row of 48 bytes, the predicated path."""
    t, ref = _lp_case(cuda, shape, dtype, q16, D)
    kind = {"flat": "flat", "decode": "decode"}.get(shape, "chunk")
    name = tra.kernel_name(dtype, kind)
    before = kernels.launch_counts().get(name, 0)
    if kind == "flat":
        got = tra.ragged_flat_attention(**t)
        again = tra.ragged_flat_attention(**t)
        want = tra.ragged_flat_attention_reference(**ref)
    else:
        got = tra.ragged_paged_attention(**t)
        again = tra.ragged_paged_attention(**t)
        want = (tra.ragged_chunk_attention_reference(**ref)
                if kind == "chunk" else tra.ragged_attention_reference(**ref))
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 2
    assert got.dtype == want.dtype == (dtype if q16 else torch.float32)
    tol = _lp_tol(want) if q16 else ATT_TOL
    assert float((_valid(t, got).float()
                  - _valid(t, want).float()).abs().max()) <= tol
    assert torch.equal(got, again)


def _paged_call(shape):
    """(kernel wrapper, plain twin, launch-counter kind) of a case of
    ``_lp_case``."""
    if shape == "flat":
        return (tra.ragged_flat_attention,
                tra.ragged_flat_attention_reference, "flat")
    if shape == "decode":
        return (tra.ragged_paged_attention, tra.ragged_attention_reference,
                "decode")
    return (tra.ragged_paged_attention,
            tra.ragged_chunk_attention_reference, "chunk")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", LP_PAGES, ids=["bf16", "f16"])
def test_16bit_wrappers_reject_what_the_kernels_do_not_take(cuda, dtype):
    """f64 pages (K and V, or K beside 16-bit V, which the wrapper must
    not narrow) and f64 q raise ``TypeError``, in all three shapes. K and
    V of two dtypes and q of the other 16-bit dtype were refused too until
    the kernels took every dtype the TPU kernels take: they now launch
    (V pages of another dtype: both pools widened to f32, the f32-page
    kernel) and agree with the plain twin, the output in q's dtype."""
    other = torch.float16 if dtype == torch.bfloat16 else torch.bfloat16
    for shape in ("flat", "chunk16", "decode"):
        t, ref = _lp_case(cuda, shape, dtype, False, 64)
        call, twin, kind = _paged_call(shape)
        for bad in (dict(k_pages=t["k_pages"].double(),
                         v_pages=t["v_pages"].double()),
                    dict(k_pages=t["k_pages"].double()),
                    dict(q=t["q"].double())):
            with pytest.raises(TypeError):
                call(**dict(t, **bad))
        for mix, page_dt in ((dict(v_pages=t["v_pages"].to(other)),
                              torch.float32),
                             (dict(q=t["q"].to(other)), dtype)):
            name = tra.kernel_name(page_dt, kind)
            before = kernels.launch_counts().get(name, 0)
            got = call(**dict(t, **mix))
            want = twin(**dict(ref, **mix))
            torch.cuda.synchronize()
            assert kernels.launch_counts()[name] == before + 1
            assert got.dtype == want.dtype == mix.get("q", t["q"]).dtype
            tol = _lp_tol(want) if "q" in mix else ATT_TOL
            assert float((_valid(t, got).float()
                          - _valid(t, want).float()).abs().max()) <= tol


# ------------------------------ every input dtype the TPU kernels take --
# (q, K pages, V pages) beyond q f32 or in the pages' own dtype
DTYPE_MIXES = [(torch.bfloat16, torch.float32, torch.float32),
               (torch.float16, torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float16, torch.float16),
               (torch.float32, torch.bfloat16, torch.float16),
               (torch.float32, torch.float32, torch.bfloat16),
               (torch.float16, torch.float32, torch.bfloat16)]
_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16",
          torch.float16: "f16"}


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 24, 64, 128])
@pytest.mark.parametrize("mix", DTYPE_MIXES, ids=[
    "q{}-k{}-v{}".format(*(_SHORT[d] for d in m)) for m in DTYPE_MIXES])
@pytest.mark.parametrize("shape", ["flat", "chunk16", "decode"])
def test_paged_kernels_take_every_q_and_page_dtype(cuda, shape, mix, D):
    """K1, K4 and K5 with q of any float dtype over K and V pages of any
    float dtypes, against the plain twin on the same tensors: the output
    in q's dtype (within one ulp of it for 16-bit q, ATT_TOL for f32);
    K and V of two dtypes run the f32-page kernel on pools widened to
    f32 (exact); two launches give the same bits."""
    qd, kd, vd = mix
    t, ref = _lp_case(cuda, shape, torch.float32, False, D)
    cast = dict(q=t["q"].to(qd), k_pages=t["k_pages"].to(kd),
                v_pages=t["v_pages"].to(vd))
    t, ref = dict(t, **cast), dict(ref, **cast)
    call, twin, kind = _paged_call(shape)
    name = tra.kernel_name(kd if kd == vd else torch.float32, kind)
    before = kernels.launch_counts().get(name, 0)
    got, again = call(**t), call(**t)
    want = twin(**ref)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 2
    assert got.dtype == want.dtype == qd
    tol = ATT_TOL if qd == torch.float32 else _lp_tol(want)
    assert float((_valid(t, got).float()
                  - _valid(t, want).float()).abs().max()) <= tol
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 24, 64, 128])
@pytest.mark.parametrize("q_dtype", LP_PAGES, ids=["bf16", "f16"])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_flat_kernel_takes_16bit_q(cuda, dtype, q_dtype, D):
    """K2 with bf16 / f16 q: the output in q's dtype, within one ulp of
    it of the plain twin."""
    t, ref = _ring_flat_case(cuda, dtype, D)
    t = dict(t, q=t["q"].to(q_dtype))
    ref = dict(ref, q=t["q"])
    name = tra.kernel_name(t["k_pages"].dtype)
    before = kernels.launch_counts().get(name, 0)
    got = tra.ragged_flat_attention(**t)
    want = tra.ragged_flat_attention_reference(**ref)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    assert got.dtype == want.dtype == q_dtype
    assert float((got.float() - want.float()).abs().max()) <= _lp_tol(want)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", LP_PAGES, ids=["bf16", "f16"])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("T", [1, 8, 17, 128])
@pytest.mark.parametrize("K,N", [(768, 3072), (768, 50257), (203, 130)])
def test_wq_matmul_kernel_takes_16bit_x(cuda, dtype, x_dtype, T, K, N):
    """K3 with bf16 / f16 x (exact in TF32: one pass) against the twin,
    which widens x to f32: f32 out within WQ_TOL; K = 203 takes the
    element-wise x loads."""
    x, q, s = _wq_case(cuda, dtype, T, K, N)
    x = x.to(x_dtype)
    name = tqz.kernel_name(q.dtype)
    before = kernels.launch_counts().get(name, 0)
    got = tqz.quantized_matmul(x, q, s)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    want = tqz.quantized_matmul_reference(x, q, s)
    assert got.dtype == want.dtype == torch.float32
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) < WQ_TOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 100, 130), (1, 2, 500, 500),
                                   (1, 2, 128, 512)],
                         ids=["ragged", "T500", "Tq128-Tk512"])
@pytest.mark.parametrize("mask", ["none", "padding", "causal"])
@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", LP_PAGES, ids=["bf16", "f16"])
def test_flash_16bit_forward_matches_twin(cuda, dtype, D, mask, shape):
    """The TMA / wgmma forward against its twin at every instantiated head
    dim, each mask, ragged tile edges (Tq = Tk = 500) and Tq != Tk: out
    within FLASH_LP_TOL, lse within FLASH_TOL, the same bits twice, one
    ``flash_fwd.bf16`` / ``.f16`` launch a call; and the 16-bit backward
    kernels give the same gradients from its lse as from the twin's."""
    B, H, Tq, Tk = shape
    causal, padding = mask == "causal", mask == "padding"
    q, k, v, bias, dout = _flash_inputs(cuda, B, H, Tq, Tk, D, padding,
                                        seed=D + Tq)
    q, k, v, dout = (x.to(dtype) for x in (q, k, v, dout))
    scale = D ** -0.5
    name = tfa.kernel_name("flash_fwd", dtype)
    before = kernels.launch_counts().get(name, 0)
    out, lse = tfa.flash_forward(q, k, v, bias, causal, scale)
    again = tfa.flash_forward(q, k, v, bias, causal, scale)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 2
    ref_out, ref_lse = tfa.flash_forward_reference(q, k, v, bias, causal,
                                                   scale)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert _rel(out.float(), ref_out.float()) < FLASH_LP_TOL[dtype]
    assert _rel(lse, ref_lse) < FLASH_TOL
    delta = (dout.float() * ref_out.float()).sum(-1).reshape(B * H, Tq)
    grads = [_flash_backward((q, k, v, bias, dout, l, delta, causal, scale),
                             padding) for l in (lse, ref_lse)]
    for g, w in zip(*grads):
        assert (g is None) == (w is None)
        if w is not None:
            assert _rel(g.float(), w.float()) < FLASH_LP_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 100, 130), (2, 2, 500, 500),
                                   (2, 2, 128, 512), (2, 3, 130, 130)],
                         ids=["ragged", "T500", "Tq128-Tk512", "T130"])
@pytest.mark.parametrize("mask", ["none", "padding", "causal"])
@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", LP_PAGES, ids=["bf16", "f16"])
def test_flash_16bit_backward_matches_twins(cuda, dtype, D, mask, shape):
    """The TMA / wgmma backward (dK/dV/dbias and dQ) against its twins at
    every instantiated head dim, each mask, ragged tile edges (Tq = Tk =
    500), Tq != Tk and T = 130 (Tq % 4 != 0: rows of lse and delta that
    are not 16-byte aligned), from the twin's lse and delta; with the
    padding mask the second batch row has valid length 0 (its lse is
    -1e30, and every key weighs alike): finite gradients within
    FLASH_LP_TOL, the same bits twice, one ``flash_bwd_dkv`` and one
    ``flash_bwd_dq`` launch of the dtype a call."""
    B, H, Tq, Tk = shape
    causal, padding = mask == "causal", mask == "padding"
    q, k, v, bias, dout = _flash_inputs(cuda, B, H, Tq, Tk, D, padding,
                                        seed=D + Tq + Tk)
    if padding:
        bias[1] = -1e30
    q, k, v, dout = (x.to(dtype) for x in (q, k, v, dout))
    scale = D ** -0.5
    ref_out, ref_lse = tfa.flash_forward_reference(q, k, v, bias, causal,
                                                   scale)
    delta = (dout.float() * ref_out.float()).sum(-1).reshape(B * H, Tq)
    args = (q, k, v, bias, dout, ref_lse, delta, causal, scale)
    names = [tfa.kernel_name(n, dtype) for n in ("flash_bwd_dkv",
                                                 "flash_bwd_dq")]
    before = kernels.launch_counts()
    got = _flash_backward(args, padding)
    after = kernels.launch_counts()
    assert [after.get(n, 0) - before.get(n, 0) for n in names] == [1, 1]
    again = _flash_backward(args, padding)
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(got, again))
    dk, dv, db = tfa.flash_bwd_dkv_reference(*args, want_dbias=padding)
    want = (dk, dv, db, tfa.flash_bwd_dq_reference(*args))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype
            assert bool(torch.isfinite(g).all())
            assert _rel(g.float(), w.float()) < FLASH_LP_TOL[dtype]


@pytest.mark.cuda
def test_llm_server_bf16_pools_serve_the_plain_step(cuda):
    """``LLMServer(dtype="bfloat16")`` at GPT-2-small widths: bf16
    pools; after ``warmup()`` every dispatch is one graph replay,
    ``decode_flat`` never runs in Python, nothing is built or captured,
    and the bf16 flat kernel launches once a layer a dispatch. Each
    greedy stream is held, token by token, against the port's plain step
    on the CPU over bf16 pools (``chip_smoke.check_greedy_plain``); one
    mixed packed step against the same step on the CPU."""
    from mxnet_tpu_torch.convert import params_from_numpy
    from mxnet_tpu_torch.serving.llm import LLMServer, TinyDecoder
    model = TinyDecoder(device=cuda, **chip_smoke.GPT2_SMALL)
    params = model.init_params_numpy(0)
    srv = LLMServer(model, params, max_seqs=8, block_size=BS,
                    dtype="bfloat16", device=cuda)
    assert srv.engine.cache.k_pages.dtype == torch.bfloat16
    srv.warmup()
    compiles = srv.stats()["compiles"]
    before = srv.stats()["programs"]
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, model.vocab_size, size=n).tolist()
               for n in (1, 15, 16, 17, 40, 100)]
    name = tra.kernel_name(torch.bfloat16)
    launched = kernels.launch_counts().get(name, 0)
    srv.start()
    try:
        got = [f.result(timeout=300).tokens
               for f in [srv.submit(p, 8) for p in prompts]]
    finally:
        srv.shutdown()
    after = srv.stats()["programs"]
    dispatches = after["dispatches"] - before["dispatches"]
    assert dispatches > 0
    assert after["replays"] - before["replays"] == dispatches
    assert srv.stats()["compiles"] == compiles
    assert srv.stats()["kv_dtype"] == "bfloat16"
    assert kernels.launch_counts()[name] - launched == \
        dispatches * model.num_layers
    cpu = TinyDecoder(device="cpu", **chip_smoke.GPT2_SMALL)
    cpu_params = params_from_numpy(params, "cpu")
    for i, (prompt, toks) in enumerate(zip(prompts, got)):
        chip_smoke.check_greedy_plain(
            cpu, cpu_params, prompt, toks, "bfloat16",
            chip_smoke.LP_LOGIT_TOL["bfloat16"], f"bf16 request {i}")
    batch, _ = chip_smoke.mixed_batch(model, rng, cuda)
    mine = chip_smoke.step_logits(model, srv.engine.params, batch,
                                  "bfloat16", None)
    want = chip_smoke.step_logits(cpu, cpu_params,
                                  {k: v.cpu() for k, v in batch.items()},
                                  "bfloat16", None)
    n = int(batch["valid"].sum())
    assert float((mine[:n].cpu() - want[:n]).abs().max()) <= \
        chip_smoke.LP_LOGIT_TOL["bfloat16"]


# ------------------------------------------------ optimizer update kernel --
UPDATE_SIZES = ((1,), (3,), (4099,), (7, 11), (2 * 32768 + 5,))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("name", sorted(topt_ops.RULES))
def test_update_kernel_matches_twin_bitwise(cuda, name, offset):
    """Each update op's kernel, one launch over tensors of odd sizes (one
    over two chunks), each with its own scalar row and the gradient clip
    on and off, against its twin on the same CUDA tensors: the same bits
    in every written tensor; 16-byte aligned and misaligned views; the mp
    ops on bf16 and f16 weights. One launch, counted under the op."""
    rule = topt_ops.RULES[name]
    for wdtype in ((torch.bfloat16, torch.float16) if rule.mp
                   else (torch.float32,)):
        lists = chip_smoke.update_case(torch, name, UPDATE_SIZES, wdtype,
                                       cuda, seed=len(name), offset=offset)
        assert offset == 0 or lists[2][0].data_ptr() % 16 != 0
        kws = [chip_smoke.update_kwargs(name, k) for k in range(len(lists))]
        before = kernels.launch_counts().get(name, 0)
        bad, err, nans = chip_smoke.kernel_vs_twin(torch, name, lists, kws)
        assert (bad, nans) == (0, 0), f"{name} {wdtype}: {bad} elements " \
            f"differ (max {err})"
        assert kernels.launch_counts()[name] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adam_update", "mp_sgd_mom_update"])
def test_update_op_takes_the_kernel_per_parameter(cuda, name):
    """Through ``apply_op`` (the loop's path) a CUDA parameter takes the
    kernel over one tensor, in place, with the bits of the launch over
    many."""
    rule = topt_ops.RULES[name]
    wdtype = torch.bfloat16 if rule.mp else torch.float32
    many = chip_smoke.update_case(torch, name, UPDATE_SIZES, wdtype, cuda, 3)
    one = [[x.clone() for x in xs] for xs in many]
    kws = [chip_smoke.update_kwargs(name, k) for k in range(len(many))]
    topt_ops.multi_update(name, many, kws)
    before = kernels.launch_counts().get(name, 0)
    for xs, kw in zip(one, kws):
        ids = [id(x) for x in xs]
        got = apply_op(name, xs, kw)
        got = got if isinstance(got, tuple) else (got,)
        assert [id(g) for g in got] == [ids[m] for m in rule.mutates]
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + len(one)
    for xs, ys in zip(many, one):
        for m in rule.mutates:
            assert torch.equal(xs[m], ys[m])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
def test_update_kernel_takes_the_rescale_array(cuda, offset):
    """``_adamw_update``'s rescale array on the card: the kernel reads
    the scale from the one-element tensor (a new one each step, beside a
    float ``rescale_grad`` it replaces), in a fresh launch table and in a
    cached one, with the twin's bits; through ``nd`` the fifth input
    takes the kernel too."""
    name = "_adamw_update"
    lists = chip_smoke.update_case(torch, name, UPDATE_SIZES, torch.float32,
                                   cuda, seed=3, offset=offset)
    before = kernels.launch_counts().get(name, 0)
    bad, err, nans, n = chip_smoke.adamw_rescale_check(torch, lists, 5)
    assert (bad, nans) == (0, 0), f"{bad} elements differ (max {err})"
    assert kernels.launch_counts()[name] == before + n
    xs = [x.clone() for x in lists[3]]
    r = torch.tensor([0.375], device=cuda)
    want = topt_ops.RULES[name].twin(*[x.clone() for x in xs], r,
                                     **chip_smoke.update_kwargs(name))
    got = nd._adamw_update(*xs, r, **chip_smoke.update_kwargs(name))
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + n + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_update_kernel_raises_on_dtypes_without_a_kernel(cuda):
    """No quiet cast: f64 or 16-bit weights for an f32 rule, an mp rule
    on f32 weights or with mixed 16-bit dtypes raise, nothing launches."""
    w = torch.ones(8, device=cuda)
    before = kernels.launch_counts()
    with pytest.raises(TypeError):
        apply_op("sgd_update", [w.double(), w.double()], {"lr": 0.1})
    with pytest.raises(TypeError):
        apply_op("adam_update", [w.bfloat16(), w.bfloat16(), w, w], {})
    with pytest.raises(TypeError):
        apply_op("mp_sgd_update", [w, w, w.clone()], {})
    with pytest.raises(TypeError):
        apply_op("mp_sgd_update", [w.bfloat16(), w.half(), w.clone()], {})
    with pytest.raises(TypeError):
        topt_ops.multi_update("sgd_update", [[w.clone(), w], [w.half(),
                                                              w.half()]],
                              [{}, {}])
    assert kernels.launch_counts() == before


def _bert_trainer_run(cuda, params, init, grads, fused, opt, kw, steps=2):
    os.environ["MXNET_TPU_FUSED_UPDATE"] = "1" if fused else "0"
    try:
        for p, w in zip(params, init):
            p.set_data(w)
        trainer = tgluon.Trainer(params, opt, dict(kw))
        launches = []
        for s in range(steps):
            # a new gradient tensor a step, as a backward hands out
            for p, g in zip(params, grads):
                p.data().grad = g * (1 + s)
            before = kernels.launch_counts()
            trainer.step(8)
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            launches.append({k: v - before.get(k, 0) for k, v in after.items()
                             if v != before.get(k, 0)})
            if s == 0:
                builds = kernels.build_count()
        assert kernels.build_count() == builds
        return ([p.data().detach().clone() for p in params],
                trainer, launches)
    finally:
        del os.environ["MXNET_TPU_FUSED_UPDATE"]


@pytest.mark.cuda
def test_fused_matches_loop_on_bert_base_params(cuda):
    """BERT-base's parameters (203 tensors, 110.1M f32) with seeded
    gradients: two Adam steps fused (one launch a step, nothing built
    after the first) and through the loop (one launch per parameter) give
    the same bits in weights and states."""
    _, _, params = chip_smoke.bert_base_params(torch)
    gen = torch.Generator(device=cuda).manual_seed(0)
    init = [p.data().detach().clone() for p in params]
    grads = [torch.randn(p.shape, generator=gen, device=cuda) * 1e-2
             for p in params]
    kw = {"learning_rate": 1e-3, "wd": 0.01, "clip_gradient": 0.02}
    a, ta, la = _bert_trainer_run(cuda, params, init, grads, True, "adam",
                                  kw)
    b, tb, lb = _bert_trainer_run(cuda, params, init, grads, False, "adam",
                                  kw)
    assert la == [{"adam_update": 1}] * 2
    assert ta._fused.last_dispatches == 1 and ta._fused.fallbacks == {}
    assert ta._fused.tables_built == 1
    assert lb == [{"adam_update": len(params)}] * 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for i in ta._updaters[0].states:
        for x, y in zip(ta._updaters[0].states[i], tb._updaters[0].states[i]):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_fused_launches_once_per_op_and_dtype_group(cuda):
    """SGD with momentum and multi_precision over f32 and bf16
    parameters: two groups, two launches a step (``sgd_mom_update``,
    ``mp_sgd_mom_update``), the loop's bits."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    params, init, grads = [], [], []
    for i, n in enumerate((5, 4099, 70000, 33, 12)):
        dtype = "bfloat16" if i % 2 else "float32"
        p = tgluon.Parameter(f"p{i}", shape=(n,), dtype=dtype)
        p.initialize(device=cuda)
        params.append(p)
        init.append(torch.randn(n, generator=gen, device=cuda).to(
            p.data().dtype))
        grads.append(torch.randn(n, generator=gen, device=cuda).to(
            p.data().dtype))
    kw = {"learning_rate": 0.05, "momentum": 0.9, "multi_precision": True}
    a, ta, la = _bert_trainer_run(cuda, params, init, grads, True, "sgd", kw)
    b, _, lb = _bert_trainer_run(cuda, params, init, grads, False, "sgd", kw)
    assert la == [{"sgd_mom_update": 1, "mp_sgd_mom_update": 1}] * 2
    assert ta._fused.last_dispatches == 2 and ta._fused.tables_built == 2
    assert lb == [{"sgd_mom_update": 3, "mp_sgd_mom_update": 2}] * 2
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


# --------------------------------------------- speculative decoding --
_SPEC_CFG = dict(vocab_size=48, d_model=32, num_layers=2, num_heads=2,
                 d_ff=64, max_context=64)


def _spec_engine(dev, **kw):
    """A small speculative engine on ``dev``: the target of ``_SPEC_CFG``
    and its truncation to one layer as the draft, ``spec_k`` 2, two
    rows. Returns (engine, stats)."""
    from mxnet_tpu_torch.serving.llm import LLMEngine, LLMStats, TinyDecoder
    model = TinyDecoder(device=dev, **_SPEC_CFG)
    draft = TinyDecoder(device=dev, **dict(_SPEC_CFG, num_layers=1))
    params = model.init_params_numpy(0)
    stats = LLMStats()
    eng = LLMEngine(model, params, max_seqs=2, block_size=BS,
                    draft_model=draft,
                    draft_params=dict(params, layers=params["layers"][:1]),
                    spec_k=2, stats=stats, device=dev, **kw)
    return eng, stats


def _spec_drain(eng, prompts, n, sampling=None):
    from mxnet_tpu_torch.serving.llm import Sequence
    seqs = [Sequence(p, n, sampling=sampling) for p in prompts]
    for s in seqs:
        eng.add(s)
    while eng.has_work():
        eng.step()
    eng.pop_finished()
    return [s.output_tokens() for s in seqs]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"kv_dtype": "int8"},
                                {"draft_weight_dtype": "int8"}],
                         ids=["f32", "int8_kv", "int8_draft"])
def test_spec_engine_on_the_card_matches_the_cpu(cuda, kw):
    """A small speculative engine on the card, after ``warmup()``: its
    greedy streams equal the same engine's on the CPU (every kernel's
    plain version); the compile count does not move; every verify and
    every draft round is one graph replay (the draft's ladder captured
    too) and no ``decode_flat`` runs in Python; a sampled stream repeats
    under its seed; nothing degrades."""
    from mxnet_tpu_torch.serving.telemetry import compile_count
    eng, stats = _spec_engine(cuda, **kw)
    eng.warmup()
    progs = eng.programs()
    assert progs["graphs"] == progs["step_variants"] + \
        progs["draft_variants"] == 2 * len(progs["mb_widths"]) * (
            len(progs["t_buckets"]) + len(progs["draft_t_buckets"]))
    compiles = compile_count()
    calls = []
    for m in (eng.model, eng.draft_model):
        fn = m.decode_flat
        m.decode_flat = lambda *a, _fn=fn, **k: (calls.append(1),
                                                 _fn(*a, **k))[1]
    launched = kernels.launch_counts()
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, 48, size=n).tolist()
               for n in (1, 7, 16, 17, 30)]
    samp = dict(temperature=0.8, top_p=0.9, seed=4)
    from mxnet_tpu_torch.serving.llm import SamplingParams
    try:
        got = _spec_drain(eng, prompts, 12)
        sampled = [_spec_drain(eng, prompts[2:3], 12,
                               SamplingParams(**samp)) for _ in range(2)]
    finally:
        for m in (eng.model, eng.draft_model):
            del m.decode_flat
    after = eng.programs()
    assert after["draft_dispatches"] > progs["draft_dispatches"]
    assert after["replays"] - progs["replays"] == \
        after["dispatches"] - progs["dispatches"]
    assert calls == []
    assert compile_count() == compiles
    counts = kernels.launch_counts()
    flat = tra.kernel_name(eng.cache.k_pages.dtype)
    assert counts[flat] > launched.get(flat, 0)
    if "draft_weight_dtype" in kw:
        wq = tqz.kernel_name(torch.int8)
        assert counts[wq] > launched.get(wq, 0)
    snap = stats.snapshot()
    assert snap["spec_proposed"] > 0 and snap["spec_degraded"] == 0
    assert sampled[0] == sampled[1]
    cpu, _ = _spec_engine(torch.device("cpu"), **kw)
    assert got == _spec_drain(cpu, prompts, 12)
    eng.release_graphs()


def _row_pack(dev, n_row, beside, seed=3, H=12, D=64, dtype="float32"):
    """Flat attention inputs of one row (seq 0, ``n_row`` tokens ending
    at position 300) packed alone, and packed between rows of other
    lengths (``beside``: token counts of seqs 1.., placed around it).
    Returns (alone kwargs, beside kwargs, the row's slice in the second
    pack)."""
    rng = np.random.RandomState(seed)
    S, MB = 8, 64
    N = S * MB + 1
    tables = torch.from_numpy(rng.permutation(np.arange(1, N)).astype(
        np.int32)[:S * MB].reshape(S, MB))
    pools = {}
    for name in ("k", "v"):
        x = torch.from_numpy(rng.randn(N, BS, H, D).astype(np.float32))
        if dtype == "float32":
            pools[f"{name}_pages"] = x
        else:
            xq, sc = _quantize_kv(x.reshape(-1, H, D), torch.int8)
            pools[f"{name}_pages"] = xq.reshape(N, BS, H, D)
            pools[f"{name}_scales"] = sc.reshape(N, BS, H)
    q_row = torch.from_numpy(rng.randn(n_row, H, D).astype(np.float32))
    pos_row = list(range(301 - n_row, 301))
    ids, pos, qs = [], [], []
    half = len(beside) // 2
    row_at, sid = None, 0
    for m in beside[:half] + [None] + beside[half:]:
        if m is None:
            row_at = len(ids)
            ids += [0] * n_row
            pos += pos_row
            qs.append(q_row)
            continue
        sid += 1
        end = int(rng.randint(m, MB * BS))
        ids += [sid] * m
        pos += list(range(end - m, end))
        qs.append(torch.from_numpy(rng.randn(m, H, D).astype(np.float32)))

    def pack(i, p, q):
        return dict(q=q, seq_ids=torch.tensor(i, dtype=torch.int32),
                    positions=torch.tensor(p, dtype=torch.int32),
                    block_tables=tables, **pools)
    alone = pack([0] * n_row, pos_row, q_row)
    mixed = pack(ids, pos, torch.cat(qs))
    to = lambda d: {k: v.to(dev) for k, v in d.items()}  # noqa: E731
    return to(alone), to(mixed), slice(row_at, row_at + n_row)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("n_row,beside", [
    (3, [3] * 7),                   # the verify pack (spec_k 2)
    (2, [2] * 7),                   # the draft round's pack
    (1, [2, 1, 2, 1, 2, 1, 2]),     # catch-up and proposal feeds
    (2, [16, 1, 3, 16, 2, 9]),      # beside prefill mirrors
    (16, [1] * 7)])                 # a mirrored prefill chunk
def test_flat_kernel_row_is_the_same_alone_and_in_a_pack(cuda, dtype, n_row,
                                                         beside):
    """K1 (and K2) give a row the same bits whether it is packed alone
    or beside rows of other lengths, as the draft's KV writes into
    shared prefix blocks assume: the plan (``qt``, splits) follows the
    pack."""
    alone, mixed, sl = _row_pack(cuda, n_row, beside, dtype=dtype)
    a = tra.ragged_flat_attention(**alone)
    b = tra.ragged_flat_attention(**mixed)[sl]
    torch.cuda.synchronize()
    want = tra.ragged_flat_attention_reference(**alone)
    assert float((a - want).abs().max()) < ATT_TOL
    assert torch.equal(a, b), (
        f"max difference {float((a - b).abs().max()):.3e}; plans "
        f"{tra.flat_plan(a.shape[0], 8, 12, 64, BS, 64, torch.float32)} "
        f"alone, {tra.flat_plan(mixed['q'].shape[0], 8, 12, 64, BS, 64, torch.float32)} "
        f"packed")


@pytest.mark.cuda
@pytest.mark.parametrize("n_row,beside", [(2, [2] * 7), (1, [16, 3, 1])])
def test_draft_step_writes_a_rows_kv_alone_as_in_a_pack(cuda, n_row,
                                                        beside):
    """The whole draft step at GPT-2-small widths (one layer), on the
    draft's route (``dense_rows=DENSE_ROWS``): the K/V a row writes and
    its logits have the same bits whether the row is fed alone or beside
    others (the matmuls see another row count)."""
    from mxnet_tpu_torch.convert import params_from_numpy
    from mxnet_tpu_torch.serving.llm import TinyDecoder
    from mxnet_tpu_torch.serving.llm.kv_cache import PagedKVCache
    cfg = dict(chip_smoke.GPT2_SMALL, num_layers=1)
    model = TinyDecoder(device=cuda, **cfg)
    params = params_from_numpy(model.init_params_numpy(0), cuda)
    runs = []
    for feeds in ([n_row], beside[:len(beside) // 2] + [n_row]
                  + beside[len(beside) // 2:]):
        row = feeds.index(n_row) if len(feeds) == 1 else len(beside) // 2
        cache = PagedKVCache(1, 12, 64, BS, 65, 1024, device=cuda)
        tables = torch.zeros((8, 8), dtype=torch.int32)
        tok, pos, sid = [], [], []
        for j, m in enumerate(feeds):
            tables[j] = torch.arange(1 + 8 * j, 9 + 8 * j)
            r = np.random.RandomState(100 + (0 if j == row else j + 1))
            tok += r.randint(0, cfg["vocab_size"], size=m).tolist()
            pos += list(range(40, 40 + m))
            sid += [j] * m
        logits = model.decode_flat(
            params, torch.tensor(tok, dtype=torch.int32, device=cuda),
            torch.tensor(pos, dtype=torch.int32, device=cuda),
            torch.tensor(sid, dtype=torch.int32, device=cuda),
            torch.ones(len(tok), dtype=torch.int32, device=cuda),
            cache.k_pages, cache.v_pages, tables.to(cuda),
            dense_rows=DENSE_ROWS)
        off = sum(feeds[:row])
        blk = 1 + 8 * row + 40 // BS
        runs.append((logits[off:off + n_row],
                     cache.k_pages[:, blk].clone(),
                     cache.v_pages[:, blk].clone()))
    for x, y in zip(*runs):
        assert torch.equal(x, y), float((x - y).abs().max())


# ------------------------------------------------------ multi-LoRA --
_LORA_CFG = dict(vocab_size=48, d_model=32, num_layers=2, num_heads=2,
                 d_ff=64, max_context=64)


def _lora_factors(seed, rank, L=2, d=32, scale=0.05):
    rng = np.random.RandomState(seed)
    return ((rng.randn(L, 4, d, rank) * scale).astype(np.float32),
            (rng.randn(L, 4, rank, d) * scale).astype(np.float32))


def _lora_engine(dev, bank, **kw):
    from mxnet_tpu_torch.serving.llm import LLMEngine, TinyDecoder
    model = TinyDecoder(device=dev, **_LORA_CFG)
    return LLMEngine(model, model.init_params_numpy(0), max_seqs=4,
                     block_size=BS, adapter_bank=bank, device=dev, **kw)


def _lora_drain(eng, cases):
    from mxnet_tpu_torch.serving.llm import Sequence
    seqs = [Sequence(p, n, adapter=a) for p, n, a in cases]
    for s in seqs:
        eng.add(s)
    while eng.has_work():
        eng.step()
    eng.pop_finished()
    return [s.output_tokens() for s in seqs]


@pytest.mark.cuda
def test_bank_install_is_seen_by_an_already_captured_graph(cuda):
    """Graphs captured in ``warmup()`` before any adapter exists serve
    adapters published afterwards (the install copies into the pools'
    storage in place): the streams equal the oracle with the factors the
    bank holds, the CPU engine's with the same bank contents, and
    nothing is built or captured."""
    from mxnet_tpu_torch.serving.adapters import AdapterBank
    from mxnet_tpu_torch.serving.llm import greedy_decode_reference
    from mxnet_tpu_torch.serving.telemetry import compile_count
    bank = AdapterBank(2, 32, max_adapters=3, page_rank=4, device=cuda)
    eng = _lora_engine(cuda, bank)
    eng.warmup()
    compiles, progs = compile_count(), eng.programs()
    bank.publish("ada", *_lora_factors(1, 4))
    bank.publish("bob", *_lora_factors(2, 8), alpha=4.0)
    rng = np.random.RandomState(3)
    cases = [(rng.randint(0, 48, size=n).tolist(), 10, a)
             for n, a in ((5, "ada"), (17, "bob"), (9, None), (30, "ada"))]
    got = _lora_drain(eng, cases)
    assert compile_count() == compiles
    after = eng.programs()
    assert after["graphs"] == progs["graphs"]
    assert after["replays"] - progs["replays"] == \
        after["dispatches"] - progs["dispatches"] > 0
    params = {k: v for k, v in eng.params.items()}
    for (p, n, a), toks in zip(cases, got):
        lora = None if a is None else bank.adapter_arrays(a)
        assert toks == greedy_decode_reference(eng.model, params, p, n,
                                               lora=lora)
    cpu_bank = AdapterBank(2, 32, max_adapters=3, page_rank=4, device="cpu")
    cpu_bank.publish("ada", *_lora_factors(1, 4))
    cpu_bank.publish("bob", *_lora_factors(2, 8), alpha=4.0)
    assert got == _lora_drain(_lora_engine(torch.device("cpu"), cpu_bank),
                              cases)
    eng.release_graphs()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_base_rows_are_the_same_with_and_without_a_bank(cuda, kv_dtype):
    """On the card, a base-model row beside adapter rows has the same
    tokens and the same KV bytes as in the same traffic through an
    engine without a bank (the null page's delta is exactly zero)."""
    from mxnet_tpu_torch.serving.adapters import AdapterBank
    bank = AdapterBank(2, 32, max_adapters=3, page_rank=4, device=cuda)
    bank.publish("ada", *_lora_factors(1, 4))
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 48, size=n).tolist() for n in (6, 19, 11)]
    runs = []
    for b, ads in ((bank, ("ada", None, "ada")), (None, (None,) * 3)):
        eng = _lora_engine(cuda, b, kv_dtype=kv_dtype, prefix_cache=False)
        eng.warmup()
        blocks = {}
        finish = eng._finish

        def kept(seq, events, _finish=finish, _blocks=blocks):
            _blocks[seq.seq_id] = list(seq.block_ids)
            return _finish(seq, events)
        eng._finish = kept
        toks = _lora_drain(eng, [(p, 8, a) for p, a in zip(prompts, ads)])
        base = blocks[sorted(blocks)[1]]
        runs.append((toks, base, eng.cache.k_pages[:, base].clone(),
                     eng.cache.v_pages[:, base].clone()))
        eng.release_graphs()
    (ta, ba, ka, va), (tb, bb, kb, vb) = runs
    assert ta[1] == tb[1] and ta[0] != tb[0]
    # the same lengths allocate the same blocks in both engines
    assert ba == bb
    assert torch.equal(ka, kb) and torch.equal(va, vb)


@pytest.mark.cuda
@pytest.mark.parametrize("n_row,beside", [(2, [2] * 7), (1, [16, 3, 1]),
                                          (16, [1] * 7)])
def test_adapter_rows_are_the_same_alone_and_in_a_pack(cuda, n_row, beside):
    """``decode_flat`` at GPT-2-small widths (one layer) with an adapter
    bank, on the draft's pack-independent route (``dense_rows=
    DENSE_ROWS``; the engine's target steps run at the pack's own row
    count and copy shared blocks on write): an adapter row's logits and
    KV have the same bits fed alone and beside rows of other lengths and
    adapters (the fixed dense row count covers the delta's products
    too)."""
    from mxnet_tpu_torch.convert import params_from_numpy
    from mxnet_tpu_torch.serving.adapters import AdapterBank
    from mxnet_tpu_torch.serving.llm import TinyDecoder
    from mxnet_tpu_torch.serving.llm.kv_cache import PagedKVCache
    cfg = dict(chip_smoke.GPT2_SMALL, num_layers=1)
    model = TinyDecoder(device=cuda, **cfg)
    params = params_from_numpy(model.init_params_numpy(0), cuda)
    bank = AdapterBank(1, 768, max_adapters=4, page_rank=4, device=cuda)
    handles = []
    for i, rank in enumerate((4, 8, 4, 6)):
        a, b = _lora_factors(10 + i, rank, L=1, d=768)
        bank.publish(f"a{i}", a, b)
        handles.append(bank.acquire(f"a{i}"))
    tables = torch.tensor([list(h.pages_padded) for h in handles] * 2,
                          dtype=torch.int32, device=cuda)
    scales = torch.tensor([h.scale for h in handles] * 2,
                          dtype=torch.float32, device=cuda)
    runs = []
    for feeds in ([n_row], beside[:len(beside) // 2] + [n_row]
                  + beside[len(beside) // 2:]):
        row = 0 if len(feeds) == 1 else len(beside) // 2
        cache = PagedKVCache(1, 12, 64, BS, 65, 1024, device=cuda)
        btables = torch.zeros((8, 8), dtype=torch.int32)
        tok, pos, sid = [], [], []
        for j, m in enumerate(feeds):
            btables[j] = torch.arange(1 + 8 * j, 9 + 8 * j)
            r = np.random.RandomState(100 + (0 if j == row else j + 1))
            tok += r.randint(0, cfg["vocab_size"], size=m).tolist()
            pos += list(range(40, 40 + m))
            sid += [j] * m
        # the row always takes adapter a1; its neighbours the others
        order = [1] + [k for k in range(8) if k != 1]
        t_tab = torch.stack([tables[order[0]] if j == row else
                             tables[order[1 + j % 7]] for j in range(8)])
        t_sc = torch.stack([scales[order[0]] if j == row else
                            scales[order[1 + j % 7]] for j in range(8)])
        logits = model.decode_flat(
            params, torch.tensor(tok, dtype=torch.int32, device=cuda),
            torch.tensor(pos, dtype=torch.int32, device=cuda),
            torch.tensor(sid, dtype=torch.int32, device=cuda),
            torch.ones(len(tok), dtype=torch.int32, device=cuda),
            cache.k_pages, cache.v_pages, btables.to(cuda),
            adapter=(bank, t_tab, t_sc), dense_rows=DENSE_ROWS)
        off = sum(feeds[:row])
        blk = 1 + 8 * row + 40 // BS
        runs.append((logits[off:off + n_row],
                     cache.k_pages[:, blk].clone(),
                     cache.v_pages[:, blk].clone()))
    for x, y in zip(*runs):
        assert torch.equal(x, y), float((x - y).abs().max())
    for h in handles:
        bank.release(h)


@pytest.mark.cuda
def test_a_huge_cold_adapter_reaches_no_other_row(cuda):
    """On the card, a resident cold adapter whose ``x @ A`` overflows
    (finite factors of +-3e38) leaves the base row and the other
    adapters' rows with the bits they get from a bank without it: the
    step's logits and KV (``decode_flat``) and the streams served
    through captured graphs. A NaN factor is refused."""
    from mxnet_tpu_torch.convert import params_from_numpy
    from mxnet_tpu_torch.serving.adapters import AdapterBank, AdapterError
    from mxnet_tpu_torch.serving.llm import TinyDecoder
    from mxnet_tpu_torch.serving.llm.kv_cache import PagedKVCache
    banks = []
    for huge in (False, True):
        bank = AdapterBank(2, 32, max_adapters=3, page_rank=4, device=cuda)
        bank.publish("ada", *_lora_factors(1, 4))
        bank.publish("bob", *_lora_factors(2, 8), alpha=4.0)
        if huge:
            a, b = _lora_factors(3, 8)
            bank.publish("big", np.sign(a) * np.float32(3e38), b)
            bank.release(bank.acquire("big"))          # used, now cold
            a[0, 1, 2, 3] = np.nan
            with pytest.raises(AdapterError, match="finite"):
                bank.publish("nan", a, b)
        banks.append(bank)
    a_pool, _ = banks[1].step_pools(0, 0)
    x = torch.ones(1, 32, device=cuda)
    assert not bool(torch.isfinite(x @ a_pool.reshape(32, -1)).all())
    model = TinyDecoder(device=cuda, **_LORA_CFG)
    params = params_from_numpy(model.init_params_numpy(0), cuda)
    rng = np.random.RandomState(5)
    btables = torch.zeros((4, 4), dtype=torch.int32)
    tok, pos, sid = [], [], []
    for j, m in enumerate((6, 4, 10)):
        btables[j] = torch.arange(1 + 4 * j, 5 + 4 * j)
        tok += rng.randint(0, 48, size=m).tolist()
        pos += list(range(m))
        sid += [j] * m
    feed = [torch.tensor(v, dtype=torch.int32, device=cuda)
            for v in (tok, pos, sid, [1] * len(tok))]
    runs = []
    for bank in banks:
        hs = [bank.acquire("ada"), bank.acquire("bob")]
        tables = torch.zeros((4, 2), dtype=torch.int32)
        scales = torch.zeros(4)
        for i, h in enumerate(hs, start=1):
            tables[i] = torch.tensor(h.pages_padded)
            scales[i] = h.scale
        cache = PagedKVCache(2, 2, 16, BS, 17, 64, device=cuda)
        logits = model.decode_flat(
            params, *feed, cache.k_pages, cache.v_pages, btables.to(cuda),
            adapter=(bank, tables.to(cuda), scales.to(cuda)))
        runs.append((logits, cache.k_pages.clone(), cache.v_pages.clone()))
        for h in hs:
            bank.release(h)
    (la, ka, va), (lb, kb, vb) = runs
    assert bool(torch.isfinite(la).all())
    assert torch.equal(la, lb)
    assert torch.equal(ka, kb) and torch.equal(va, vb)
    cases = [(rng.randint(0, 48, size=n).tolist(), 8, a)
             for n, a in ((5, None), (13, "ada"), (9, "bob"), (20, None))]
    streams = []
    for bank in banks:
        eng = _lora_engine(cuda, bank)
        eng.warmup()
        streams.append(_lora_drain(eng, cases))
        eng.release_graphs()
    assert streams[0] == streams[1]


# ------------------------------------- chaos and observability on graphs --
@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fault", "tracer", "recorder"])
def test_captured_step_under_faults_tracer_and_recorder(cuda, mode,
                                                        tmp_path):
    """``LLMServer`` on the card after ``warmup()``: the same prompts
    served plainly, then with one scripted ``llm.decode`` raise (the
    bisect re-dispatches each half through its own graph), with the
    tracer on, or with the flight recorder on: the same greedy streams,
    no build or capture (``compile_count`` flat), one replay per
    dispatch; the spans and events land, and the pool is clean."""
    from mxnet_tpu_torch.observability import (
        get_flightrecorder, get_tracer, validate_chrome_trace)
    from mxnet_tpu_torch.resilience import faults
    from mxnet_tpu_torch.serving.llm import LLMServer, TinyDecoder
    from mxnet_tpu_torch.serving.telemetry import compile_count
    model = TinyDecoder(device=cuda, **_SPEC_CFG)
    srv = LLMServer(model, model.init_params_numpy(0), name=f"cc_{mode}",
                    max_seqs=2, block_size=BS, device=cuda)
    srv.warmup()
    srv.start()
    rng = np.random.RandomState(8)
    # under one block: no prefix hit between the passes
    prompts = [rng.randint(0, 48, size=n).tolist() for n in (5, 13)]
    tracer, fl = get_tracer(), get_flightrecorder()

    def serve():
        futs = chip_smoke.submit_together(srv, prompts, 10)
        return [f.result(timeout=300).tokens for f in futs]
    try:
        plain = serve()
        compiles = compile_count()
        before = srv.stats()["programs"]
        faults.reset()
        if mode == "fault":
            faults.script("llm.decode", [None, RuntimeError("transient")])
            got = serve()
        elif mode == "tracer":
            tracer.clear()
            tracer.enable()
            got = serve()
        else:
            fl.clear()
            fl.enable(out_dir=str(tmp_path))
            got = serve()
    finally:
        faults.reset()
        tracer.disable()
        fl.disable()
        srv.shutdown()
    after = srv.stats()["programs"]
    dispatches = after["dispatches"] - before["dispatches"]
    assert got == plain
    assert compile_count() == compiles
    assert dispatches > 0
    assert after["replays"] - before["replays"] == dispatches
    if mode == "fault":
        assert srv.stats()["poison_isolated"] == 0
    elif mode == "tracer":
        names = [s["name"] for s in tracer.snapshot()]
        assert names.count("mxtpu.llm.request") == 2
        assert names.count("mxtpu.llm.step") == dispatches
        assert validate_chrome_trace(tracer.to_chrome_trace()) == len(names)
        tracer.clear()
    else:
        kinds = [e["kind"] for e in fl.snapshot()]
        assert kinds.count("llm.step") == dispatches
        assert {"llm.submit", "llm.admit", "llm.prefill",
                "llm.served"} <= set(kinds)
        fl.clear()
    assert srv.engine.cache.allocator.num_used == 0
    assert srv.engine.cache.check(live_block_ids=[])


# ------------------------------------------------------ the on-disk tier --
@pytest.mark.cuda
def test_nd_save_of_cuda_tensors(cuda, tmp_path):
    """``nd.save`` of CUDA tensors (bf16 through its bytes) writes the
    file of the same tensors on the host but for each record's ctx code
    (2, the reference's gpu); ``load(device=)`` brings the same bits back
    to the card."""
    rng = np.random.RandomState(0)
    host = {"bf": torch.from_numpy(rng.randn(3, 5).astype(np.float32)).to(
                torch.bfloat16),
            "f32": torch.from_numpy(rng.randn(4).astype(np.float32)),
            "i8": torch.arange(-3, 3, dtype=torch.int8),
            "zero_d": torch.tensor(2.5, dtype=torch.bfloat16)}
    pc, pd = str(tmp_path / "c.params"), str(tmp_path / "d.params")
    mc = nd.save(pc, host)
    md = nd.save(pd, {k: v.to(cuda) for k, v in host.items()})
    assert mc["arrays"] == md["arrays"]
    a, b = open(pc, "rb").read(), open(pd, "rb").read()
    assert len(a) == len(b)
    diff = [i for i in range(len(a)) if a[i] != b[i]]
    assert len(diff) == len(host)        # one ctx byte a record
    assert all(a[i] == 1 and b[i] == 2 for i in diff)
    back = nd.load(pd, manifest=md["arrays"], device=cuda)
    for k, v in host.items():
        t = torch.from_dlpack(back[k])        # the NDArray's tensor
        assert t.device.type == "cuda" and t.dtype == v.dtype
        assert torch.equal(t.cpu(), v), k


@pytest.mark.cuda
def test_snapshot_is_immune_to_the_fused_update(cuda, tmp_path,
                                                monkeypatch):
    """An async ``save_state`` snapshots on the card's step boundary; the
    fused update kernel then rewrites weights and Adam slots in place
    while the writer is parked: the checkpoint holds the bits of the
    saved step (restored into a fresh Trainer), not the later ones."""
    from mxnet_tpu_torch import resilience as rz
    from mxnet_tpu_torch.gluon.parameter import Parameter
    from mxnet_tpu_torch.resilience import async_writer as aw
    from mxnet_tpu_torch.resilience import faults
    monkeypatch.setenv("MXNET_TPU_CKPT_ASYNC", "1")
    monkeypatch.setenv("MXNET_TPU_FUSED_UPDATE", "1")

    def make(seed):
        rs = np.random.RandomState(seed)
        params = []
        for i in range(6):
            p = Parameter(f"w{i}", shape=(256 + 64 * i, 96))
            p.initialize(device=cuda)
            p.set_data(torch.from_numpy(rs.randn(*p.shape).astype(
                np.float32)))
            params.append(p)
        return params, tgluon.Trainer(params, "adam",
                                      {"learning_rate": 1e-2})

    def step(params, tr, seed):
        rs = np.random.RandomState(seed)
        for p in params:
            p.grad().copy_(torch.from_numpy(rs.randn(*p.shape).astype(
                np.float32)))
        tr.step(4)
    params, tr = make(0)
    step(params, tr, 1)
    want = [p.data().detach().clone() for p in params]
    want += [s.clone() for i in sorted(tr._updaters[0].states)
             for s in tr._updaters[0].states[i]]
    run = str(tmp_path / "run")
    gate = faults.block_at("checkpoint.write")
    try:
        handle = tr.save_state(run, num_shards=2)
        assert gate.wait_reached()
        launches = kernels.launch_counts().get("adam_update", 0)
        for s in range(3):
            step(params, tr, 2 + s)     # in place, while the save waits
        assert kernels.launch_counts().get("adam_update", 0) > launches
        assert tr._fused.last_dispatches == 1
        assert not torch.equal(params[0].data(), want[0])
        gate.release()
        handle.result(120)
    finally:
        faults.reset()
        aw._reset_for_tests()
    params2, tr2 = make(9)
    tr2.restore_state(run)
    step(params2, tr2, 2)       # moves the restored slots to the card
    got = [p.data().detach() for p in params2]
    params3, tr3 = make(9)
    tr3.restore_state(run)
    for p, w in zip(params3, want[:len(params)]):
        assert torch.equal(p.data().detach(), w)
    slots = [torch.as_tensor(np.asarray(s)) for i in
             sorted(tr3._updaters[0].states)
             for s in tr3._updaters[0].states[i]]
    for s, w in zip(slots, want[len(params):]):
        assert torch.equal(s.cpu(), w.cpu())
    params4, tr4 = make(0)
    step(params4, tr4, 1)
    step(params4, tr4, 2)
    for a, b in zip(got, params4):
        assert torch.equal(a, b.data().detach())


@pytest.mark.cuda
def test_registry_fault_in_under_the_captured_step(cuda, tmp_path):
    """Graphs captured before any adapter is resident; adapters only the
    registry holds (and one evicted for capacity) fault in at admission,
    copied into the pools in place and synchronised before the replay
    that reads them: the streams equal a CPU engine's over a bank with
    the same factors published, nothing is built or captured, one
    replay a dispatch, and ``registry_loads`` counts every fault-in."""
    from mxnet_tpu_torch.serving.adapters import (AdapterBank,
                                                  AdapterRegistry)
    from mxnet_tpu_torch.serving.telemetry import compile_count
    reg = AdapterRegistry(str(tmp_path / "reg"), num_shards=2)
    names = {"ada": (1, 4), "bob": (2, 8), "cal": (3, 8), "dan": (4, 8)}
    for n, (seed, rank) in names.items():
        reg.save(n, *_lora_factors(seed, rank))
    bank = AdapterBank(2, 32, max_adapters=3, page_rank=4, registry=reg,
                       device=cuda)
    eng = _lora_engine(cuda, bank)
    eng.warmup()
    compiles, progs = compile_count(), eng.programs()
    rng = np.random.RandomState(5)
    waves = [("ada", "bob", None), ("cal", "dan", "ada"),
             ("bob", None, "cal")]
    cases = [[(rng.randint(0, 48, size=n).tolist(), 8, a)
              for n, a in zip((5, 17, 9), w)] for w in waves]
    got = [_lora_drain(eng, c) for c in cases]
    st = bank.stats()
    assert st["registry_loads"] == 7 and st["evictions"]["capacity"] == 4
    assert eng.pop_poison() == []
    assert compile_count() == compiles
    after = eng.programs()
    assert after["graphs"] == progs["graphs"]
    assert after["replays"] - progs["replays"] == \
        after["dispatches"] - progs["dispatches"] > 0
    cpu_bank = AdapterBank(2, 32, max_adapters=4, page_rank=4,
                           max_pages_per_adapter=2, device="cpu")
    for n, (seed, rank) in names.items():
        cpu_bank.publish(n, *_lora_factors(seed, rank))
    cpu = _lora_engine(torch.device("cpu"), cpu_bank)
    assert got == [_lora_drain(cpu, c) for c in cases]
    assert bank.check() and bank.stats()["in_use"] == 0
    eng.release_graphs()


# ----------------------------- single-shot serving and the fleet --
_ENC_CFG = dict(vocab_size=30522, units=64, hidden_size=128, num_layers=2,
                num_heads=4, max_length=32)


def _encoder(dev):
    """chip_smoke's encode model (pooled BERT output) at small widths,
    seeded Xavier, deferred shapes set."""
    from mxnet_tpu_torch.initializer import Xavier
    enc = chip_smoke.make_bert_encoder(**_ENC_CFG)
    enc.initialize(Xavier(), device=dev,
                   generator=torch.Generator().manual_seed(0))
    with ag.pause():
        enc(torch.zeros((1, 32), dtype=torch.int32, device=dev))
    return enc


@pytest.mark.cuda
def test_model_server_captures_one_graph_per_bucket(cuda):
    """``ModelServer`` over a 2-layer BERT encoder: ``warmup()`` captures
    one graph a bucket (and counts each once); ragged traffic builds and
    captures nothing, each batch is one replay launching the flash
    forward once a layer; each output is within K6's tolerance
    (chip_smoke's ``ENCODE_REL_TOL``) of the plain path; a ``Trainer.step``
    on the block after the server is built leaves what it serves
    unchanged, bit for bit."""
    from mxnet_tpu_torch import gluon, serving
    from mxnet_tpu_torch.serving.telemetry import compile_count
    enc = _encoder(cuda)
    srv = serving.ModelServer(enc, buckets=[1, 2, 4], max_delay_ms=2.0,
                              item_shape=(32,), dtype="int32",
                              name="cuda_encode")
    compiles = compile_count()
    srv.warmup()
    assert compile_count() - compiles == 3
    assert srv.programs()["graphs"] == 3 and srv.graph_pool_bytes() > 0
    srv.start()
    rng = np.random.RandomState(3)
    x = rng.randint(0, 30522, size=(14, 32)).astype(np.int32)
    compiles, before = compile_count(), srv.programs()
    launched = kernels.launch_counts().get("flash_fwd", 0)
    got, i = [], 0
    for k in (1, 3, 4, 2, 4):
        futs = [srv.submit(r) for r in x[i:i + k]]
        got += [f.result(timeout=300) for f in futs]
        i += k
    after = srv.programs()
    batches = srv.stats()["batches"]
    assert compile_count() == compiles
    assert after["replays"] - before["replays"] == batches == \
        after["dispatches"] - before["dispatches"]
    assert kernels.launch_counts()["flash_fwd"] - launched == 2 * batches
    chip_smoke.set_flash(enc, False)
    with ag.pause():
        plain = enc(torch.from_numpy(x).to(cuda)).cpu().numpy()
    chip_smoke.set_flash(enc, True)
    assert np.abs(np.stack(got) - plain).max() <= \
        chip_smoke.ENCODE_REL_TOL * np.abs(plain).max()
    trainer = gluon.Trainer(enc.collect_params(), "adam",
                            {"learning_rate": 1e-2})
    with ag.record():
        out = gluon.loss.L2Loss()(enc(torch.from_numpy(x[:4]).to(cuda)),
                                  torch.ones(4, 64, device=cuda))
    out.backward(torch.ones_like(out))
    trainer.step(4)
    with ag.pause():
        moved = enc(torch.from_numpy(x[:1]).to(cuda)).cpu().numpy()[0]
    assert np.abs(moved - got[0]).max() > 1e-4
    assert np.array_equal(srv.predict(x[0], timeout=300), got[0])
    srv.shutdown()
    assert srv.programs()["graphs"] == 0


@pytest.mark.cuda
def test_model_server_batch_rows_are_the_same_alone(cuda):
    """A bucket of 4: a sample's row is the same bits batched with any
    others as alone (padded with zeros) through the same graph."""
    from mxnet_tpu_torch import serving
    srv = serving.ModelServer(_encoder(cuda), buckets=[4],
                              max_delay_ms=20.0, item_shape=(32,),
                              dtype="int32", name="cuda_rows")
    srv.warmup()
    srv.start()
    x = np.random.RandomState(4).randint(0, 30522, size=(10, 32)) \
        .astype(np.int32)
    got = [f.result(timeout=300) for f in [srv.submit(r) for r in x]]
    for r, g in zip(x, got):
        assert np.array_equal(srv._fn(serving.pad_batch(r[None], 4))[0], g)
    srv.shutdown()


@pytest.mark.cuda
def test_model_server_capture_failure_names_the_bucket(cuda):
    """A forward that fails under capture (its warm run passes) makes
    ``warmup()`` raise ``CaptureError`` naming the bucket; nothing steps
    eagerly in its place."""
    from mxnet_tpu_torch import gluon, serving
    from mxnet_tpu_torch.gluon import nn

    class Refuses(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.dense = nn.Dense(4, in_units=4)

        def forward(self, x):
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("refused under capture")
            return self.dense(x)
    blk = Refuses()
    blk.initialize(device=cuda)
    srv = serving.ModelServer(blk, buckets=[2], item_shape=(4,),
                              dtype="float32", name="cuda_refuses")
    with pytest.raises(kernels.CaptureError, match="bucket 2"):
        srv.warmup()
    srv.start()
    with pytest.raises(kernels.CaptureError, match="bucket 2"):
        srv.predict(np.ones(4, np.float32), timeout=300)
    assert srv.programs()["graphs"] == 0
    srv.shutdown()


@pytest.mark.cuda
def test_chat_hot_swap_captures_only_in_the_warm_phase(cuda):
    """A ``FleetRouter`` hot swap of a small decoder under two submitting
    threads: nothing is built; the only captures are the new replica's
    ladder, in the publish's warm phase; every dispatch of both
    replicas is one replay; every Future typed; the post-swap greedy
    streams the oracle's over v2."""
    import threading
    from mxnet_tpu_torch import deploy, serving
    from mxnet_tpu_torch.serving.llm import LLMServer, TinyDecoder
    from mxnet_tpu_torch.serving.telemetry import compile_count
    model = TinyDecoder(device=cuda, **_SPEC_CFG)
    p1, p2 = model.init_params_numpy(0), model.init_params_numpy(1)

    def build(arrays):
        return LLMServer(model, deploy.params_from_arrays(arrays),
                         name="cuda_fleet_chat", max_seqs=4,
                         block_size=BS, device=cuda)
    old = build(deploy.flatten_params(p1))
    old.warmup()
    router = serving.FleetRouter(name="cuda_fleet")
    router.add_model("chat", old.start(), version=1, builder=build)
    builds, compiles = kernels.build_count(), compile_count()
    stop, futs, lock = threading.Event(), [], threading.Lock()

    def pump(seed):
        rng = np.random.RandomState(seed)
        while not stop.is_set():
            p = rng.randint(0, 48, size=rng.randint(3, 20)).tolist()
            f = router.submit("chat", p, 6)
            with lock:
                futs.append(f)
            f.result(timeout=300)
    threads = [threading.Thread(target=pump, args=(s,)) for s in (1, 2)]
    for th in threads:
        th.start()
    try:
        assert router.publish("chat", 2,
                              arrays=deploy.flatten_params(p2)) == 2
    finally:
        stop.set()
        for th in threads:
            th.join(300)
    assert not any(th.is_alive() for th in threads)
    for f in futs:
        assert f.result(timeout=300).tokens is not None
    new = router.server("chat")
    log = router.last_publish
    assert kernels.build_count() == builds
    assert log["compiles"]["warm"] == new.engine.programs()["graphs"] > 0
    assert compile_count() - compiles == log["compiles"]["warm"]
    assert not any(v for p, v in log["compiles"].items() if p != "warm")
    rng = np.random.RandomState(9)
    for n in (5, 17, 30):
        prompt = rng.randint(0, 48, size=n).tolist()
        toks = router.generate("chat", prompt, 8, timeout=300).tokens
        chip_smoke.check_greedy(model, new.engine.params, prompt, toks,
                                chip_smoke.F32_LOGIT_TOL, f"v2 prompt {n}")
    for srv in (old, new):
        progs = srv.engine.programs()
        assert progs["replays"] == progs["dispatches"] > 0
    router.shutdown()
    assert new.engine.cache.check(live_block_ids=[])


# ----------------------------------------- framework core: update tail --
MULTI_OPS = (
    # op, the rule it runs, inputs per weight, 16-bit weight dtype or None
    ("multi_sgd_update", "sgd_update", 2, None),
    ("multi_sgd_mom_update", "sgd_mom_update", 3, None),
    ("multi_mp_sgd_update", "mp_sgd_update", 3, torch.bfloat16),
    ("multi_mp_sgd_mom_update", "mp_sgd_mom_update", 4, torch.float16),
)


@pytest.mark.cuda
@pytest.mark.parametrize("preloaded", [False, True],
                         ids=["host_lists", "preloaded"])
@pytest.mark.parametrize("op,rule,n_per,low", MULTI_OPS,
                         ids=[m[0] for m in MULTI_OPS])
def test_variadic_update_op_is_one_launch_and_leaves_inputs(cuda, op, rule,
                                                           n_per, low,
                                                           preloaded):
    """A ``multi_*`` / ``preloaded_multi_*`` op on the card: one launch of
    the update kernel, counted under the op's name; its outputs the bits
    of the rule's twin on clones (with per-weight lr and wd, from host
    lists or from arrays on the card); its inputs unchanged."""
    lists = chip_smoke.update_case(torch, rule, UPDATE_SIZES,
                                   low or torch.float32, cuda, seed=21)
    lrs = [0.01 * (1 + k) for k in range(len(lists))]
    wds = [1e-3 * (1 + k % 3) for k in range(len(lists))]
    common = dict(rescale_grad=0.125, clip_gradient=2.0)
    if "mom" in rule:
        common["momentum"] = 0.9
    flat = [x for xs in lists for x in xs]
    before = [x.clone() for x in flat]
    name = ("preloaded_" if preloaded else "") + op
    n0 = kernels.launch_counts().get(name, 0)
    if preloaded:
        got = getattr(nd, name)(*flat, torch.tensor(lrs, device=cuda),
                                torch.tensor(wds, device=cuda), **common)
    else:
        got = getattr(nd, name)(*flat, num_weights=len(lists), lrs=lrs,
                                wds=wds, **common)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == n0 + 1
    want = []
    for k, xs in enumerate(lists):
        lr = torch.tensor(lrs[k], device=cuda) if preloaded else lrs[k]
        wd = torch.tensor(wds[k], device=cuda) if preloaded else wds[k]
        out = topt_ops.RULES[rule].twin(*[x.clone() for x in xs], lr=lr,
                                        wd=wd, **common)
        want += list(out if isinstance(out, tuple) else (out,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g._data, w)
    for x, b in zip(flat, before):
        assert torch.equal(x, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mp", [False, True], ids=["f32", "mp_bf16"])
def test_multi_adamw_reads_the_rescale_array_on_the_card(cuda, mp):
    rule = "_mp_adamw_update" if mp else "_adamw_update"
    lists = chip_smoke.update_case(torch, rule, UPDATE_SIZES,
                                   torch.bfloat16 if mp else torch.float32,
                                   cuda, seed=22)
    rescale = torch.tensor([0.375], device=cuda)
    kw = dict(lrs=[0.01] * len(lists), wds=[0.001] * len(lists),
              etas=[0.5] * len(lists), beta1=0.8, beta2=0.99, epsilon=1e-6)
    flat = [x for xs in lists for x in xs]
    name = "_multi_mp_adamw_update" if mp else "_multi_adamw_update"
    n0 = kernels.launch_counts().get(name, 0)
    got = getattr(nd, name)(*flat, rescale, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == n0 + 1
    twin = topt_ops.RULES[rule].twin
    want = []
    for xs in lists:
        want += list(twin(*[x.clone() for x in xs], lr=0.01, wd=0.001,
                          eta=0.5, beta1=0.8, beta2=0.99, epsilon=1e-6,
                          rescale_grad_arr=rescale))
    for g, w in zip(got, want):
        assert torch.equal(g._data, w)


@pytest.mark.cuda
def test_host_op_raises_under_capture(cuda):
    """An op that sizes its output from its data (``host_op``) raises,
    naming itself, inside a CUDA-graph capture; outside it runs."""
    from mxnet_tpu_torch.ops import registry as treg
    name = "_cuda_test_host_op"
    treg._REGISTRY[name] = treg.Operator(
        name, lambda x: x[x > 0], differentiable=False, host_op=True)
    try:
        x = torch.tensor([1.0, -2.0, 3.0], device=cuda)
        assert apply_op(name, [x]).shape == (2,)
        graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            with pytest.raises(RuntimeError, match=name):
                with torch.cuda.graph(graph, stream=side):
                    apply_op(name, [x])
        torch.cuda.synchronize()
    finally:
        treg._REGISTRY.pop(name, None)


@pytest.mark.cuda
def test_nd_random_on_the_card_keeps_seed_and_position(cuda):
    from mxnet_tpu_torch import _rng
    from mxnet_tpu_torch.ndarray import random as ndr
    ndr.seed(17)
    a = ndr.normal(shape=(4096,), ctx=cuda).asnumpy()
    b = ndr.uniform(shape=(4096,), ctx=cuda).asnumpy()
    assert _rng.get_state() == {"seed": 17, "draws": 2}
    ndr.seed(17)
    assert np.array_equal(ndr.normal(shape=(4096,), ctx=cuda).asnumpy(), a)
    state = _rng.get_state()
    c = ndr.gamma(2.0, shape=(4096,), ctx=cuda).asnumpy()
    _rng.set_state(state)
    assert np.array_equal(ndr.gamma(2.0, shape=(4096,), ctx=cuda).asnumpy(),
                          c)
    ndr.seed(18)
    assert not np.array_equal(ndr.normal(shape=(4096,), ctx=cuda).asnumpy(),
                              a)
    assert not np.array_equal(a[:16], b[:16])


@pytest.mark.cuda
def test_update_tail_out_as_its_inputs_updates_in_place(cuda):
    """``out=`` the op's own weights and momenta: one launch updates them
    in place, to the twin's bits (the reference's ``out=weights``)."""
    lists = chip_smoke.update_case(torch, "sgd_mom_update", UPDATE_SIZES,
                                   torch.float32, cuda, seed=23)
    want = []
    for xs in lists:
        want += list(topt_ops.RULES["sgd_mom_update"].twin(
            *[x.clone() for x in xs], lr=0.01, wd=0.001, momentum=0.9))
    flat = [x for xs in lists for x in xs]
    own = [x for xs in lists for x in (xs[0], xs[2])]
    n0 = kernels.launch_counts().get("multi_sgd_mom_update", 0)
    res = nd.multi_sgd_mom_update(*flat, num_weights=len(lists),
                                  lrs=[0.01] * len(lists),
                                  wds=[0.001] * len(lists), momentum=0.9,
                                  out=own)
    torch.cuda.synchronize()
    assert res is own
    assert kernels.launch_counts()["multi_sgd_mom_update"] == n0 + 1
    for o, w in zip(own, want):
        assert torch.equal(o, w)


# --------------------------- the op registry's tail (detection, int8, K3) --
def _impl(name):
    from mxnet_tpu_torch.ops import registry as treg
    return treg.get(name).impl


def _graph_raises(fn, match):
    """``fn`` raises a RuntimeError matching ``match`` inside a CUDA-graph
    capture."""
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with pytest.raises(RuntimeError, match=match):
            with torch.cuda.graph(graph, stream=side):
                fn()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_registered_quantized_matmul_launches_k3(cuda):
    """``nd.contrib.quantized_matmul`` (the registered K3) launches the
    kernel once and gives the function's bits; ``use_pallas=False`` is
    the twin, with no launch."""
    rng = np.random.RandomState(31)
    for wdt in ("int8", "float8_e4m3fn"):
        w = rng.randn(768, 256).astype(np.float32) / np.sqrt(768)
        q, s = tquant.quantize_leaf(w, wdt)
        q, s = q.to(cuda), s.to(cuda)
        x = torch.from_numpy(rng.randn(64, 768).astype(np.float32)).to(cuda)
        name = tqz.kernel_name(q.dtype)
        n0 = kernels.launch_counts().get(name, 0)
        got = nd.contrib.quantized_matmul(nd.NDArray(x), q, s)
        torch.cuda.synchronize()
        assert kernels.launch_counts()[name] == n0 + 1
        assert torch.equal(got._data, tqz.quantized_matmul(x, q, s))
        plain = nd.quantized_matmul(nd.NDArray(x), q, s, use_pallas=False)
        assert kernels.launch_counts()[name] == n0 + 2
        ref = tqz.quantized_matmul_reference(x, q, s)
        assert torch.equal(plain._data, ref)
        tol = WQ_TOL * max(1.0, float(ref.abs().max()))
        assert float((got._data - ref).abs().max()) <= tol


@pytest.mark.cuda
def test_int8_fc_and_conv_bit_for_bit_with_the_cpu(cuda):
    """The int8 x int8 products accumulate to the CPU's int32 bits (f64
    products, exact below 2^53) at BERT-base's K = 3072."""
    rng = np.random.RandomState(32)
    qx = torch.from_numpy(rng.randint(-127, 128, (64, 3072)).astype(
        np.int8))
    qw = torch.from_numpy(rng.randint(-127, 128, (96, 3072)).astype(
        np.int8))
    fc = _impl("_contrib_quantized_fully_connected")
    assert torch.equal(fc(qx.to(cuda), qw.to(cuda), x_scale=0.01,
                          w_scale=0.02).cpu(),
                       fc(qx, qw, x_scale=0.01, w_scale=0.02))
    cx = torch.from_numpy(rng.randint(-127, 128, (2, 14, 14, 64)).astype(
        np.int8))
    cw = torch.from_numpy(rng.randint(-127, 128, (3, 3, 64, 64)).astype(
        np.int8))
    conv = _impl("_contrib_quantized_conv")
    kw = dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), x_scale=0.1,
              w_scale=0.05)
    assert torch.equal(conv(cx.to(cuda), cw.to(cuda), **kw).cpu(),
                       conv(cx, cw, **kw))


@pytest.mark.cuda
def test_detection_keeps_the_cpu_rows_on_a_tie(cuda):
    """Equal scores everywhere: MultiBoxDetection and box_nms keep the
    same rows on the card as on the CPU (stable sorts), the rows within
    1e-6."""
    rng = np.random.RandomState(33)
    A = 48
    anchors = torch.from_numpy(chip_smoke._cboxes(A, seed=34)[None].astype(
        np.float32))
    probs = torch.full((2, 3, A), 1.0 / 3)
    loc = torch.from_numpy(rng.randn(2, A * 4).astype(np.float32) * 0.1)
    det = _impl("_contrib_MultiBoxDetection")
    kw = dict(nms_threshold=0.3, nms_topk=16, threshold=0.1)
    got = det(probs.to(cuda), loc.to(cuda), anchors.to(cuda), **kw).cpu()
    want = det(probs, loc, anchors, **kw)
    assert torch.equal(got[..., 0], want[..., 0])
    assert float((got - want).abs().max()) <= 1e-6
    rows = torch.cat([torch.zeros(1, 12, 1), torch.full((1, 12, 1), 0.5),
                      torch.from_numpy(chip_smoke._cboxes(
                          12, seed=35)[None].astype(np.float32))], dim=-1)
    nms = _impl("_contrib_box_nms")
    got = nms(rows.to(cuda), overlap_thresh=0.3, id_index=0).cpu()
    want = nms(rows, overlap_thresh=0.3, id_index=0)
    assert torch.equal(got[..., 0], want[..., 0])
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_while_loop_captures(cuda):
    """``nd.contrib.while_loop`` reads nothing on the host: its fixed trip
    captures in a CUDA graph, and a replay on new inputs gives the eager
    result (the rows after the exit zero)."""
    from mxnet_tpu_torch.ndarray import contrib
    i0 = torch.zeros((), device=cuda)
    s0 = torch.ones((), device=cuda)

    def run():
        outs, (fi, fs) = contrib.while_loop(
            lambda i, s: i < 5, lambda i, s: (s + i, (i + 1, s + i)),
            [nd.NDArray(i0), nd.NDArray(s0)], max_iterations=8)
        return outs._data, fi._data, fs._data
    eager = [t.clone() for t in run()]
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
        with torch.cuda.graph(graph, stream=side):
            static = run()
    torch.cuda.synchronize()
    i0.fill_(2.0)
    graph.replay()
    torch.cuda.synchronize()
    i0.fill_(0.0)
    want = run()
    assert not torch.equal(static[0], want[0])
    i0.fill_(0.0)
    graph.replay()
    torch.cuda.synchronize()
    for s, e in zip(static, eager):
        assert torch.equal(s, e)
    assert not eager[0][5:].any()


@pytest.mark.cuda
def test_cond_and_a_host_op_raise_inside_a_capture(cuda):
    x = nd.NDArray(torch.tensor([1.0, -2.0, 3.0], device=cuda))
    m = nd.NDArray(torch.tensor([1.0, 0.0, 1.0], device=cuda))
    _graph_raises(lambda: nd.contrib.cond(
        lambda a: a.sum() > 0, lambda a: a * 2, lambda a: a, [x]), "cond")
    _graph_raises(lambda: nd.contrib.boolean_mask(x, m),
                  "_contrib_boolean_mask")
    _graph_raises(lambda: nd._npx_nonzero(x), "_npx_nonzero")
    # outside a capture both run
    assert nd.contrib.cond(lambda a: a.sum() > 0, lambda a: a * 2,
                           lambda a: a, [x]).shape == (3,)
    assert nd._npx_nonzero(x).shape == (3, 1)


# ------------------------- sign, relu, topk's ties and the vision path --
SPECIALS = chip_smoke.SPECIALS.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["signsgd_update", "signum_update",
                                  "ftrl_update"])
def test_update_kernel_keeps_the_twin_bits_on_nan_zeros_and_inf(cuda, name):
    """NaN, ±0 and ±inf gradients (and states) through the sign-taking
    rules: the kernel's sgn is jnp.sign's, as the twin's, bit for bit; a
    NaN gradient gives a NaN weight."""
    rule = topt_ops.RULES[name]
    n = len(SPECIALS)
    xs = [torch.ones(n, device=cuda), torch.tensor(SPECIALS, device=cuda)]
    xs += [torch.tensor(np.roll(SPECIALS, k + 1), device=cuda)
           for k in range(rule.n_in - 2)]
    if name == "ftrl_update":
        xs[3] = xs[3].abs()
    kw = dict(lr=0.1, wd=0.0)
    if name == "signum_update":
        kw.update(momentum=0.9, wd_lh=0.01)
    want = rule.twin(*[x.clone() for x in xs], **kw)
    want = (want,) if isinstance(want, torch.Tensor) else want
    topt_ops.multi_update(name, [xs], [kw])
    torch.cuda.synchronize()
    for m, w in zip(rule.mutates, want):
        assert xs[m].cpu().numpy().tobytes() == w.cpu().numpy().tobytes()
    if name == "signsgd_update":
        assert torch.isnan(xs[0][0])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("name", sorted(
    n for n, r in topt_ops.RULES.items() if r.low16))
def test_update_kernel_on_16bit_weights_matches_twin_bitwise(cuda, name,
                                                             wdtype, offset):
    """A non-mp rule on bf16 / f16 weights, gradients and states (a net
    cast to 16 bits without multi_precision): each operation rounded to
    the dtype, as the twin's torch ops; bit for bit, counted under
    ``<op>.bf16`` / ``<op>.f16``."""
    lists = chip_smoke.update_case(torch, name, UPDATE_SIZES, wdtype, cuda,
                                   seed=len(name) + 1, offset=offset)
    assert all(x.dtype == wdtype for x in lists[0])
    kws = [chip_smoke.update_kwargs(name, k) for k in range(len(lists))]
    counter = f"{name}.{'bf16' if wdtype == torch.bfloat16 else 'f16'}"
    before = kernels.launch_counts().get(counter, 0)
    bad, err, nans = chip_smoke.kernel_vs_twin(torch, name, lists, kws)
    assert (bad, nans) == (0, 0), f"{name} {wdtype}: {bad} elements " \
        f"differ (max {err})"
    assert kernels.launch_counts()[counter] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sign", "cbrt", "relu", "_npx_relu"])
def test_sign_and_relu_keep_their_bits_on_the_card(cuda, name):
    """NaN, ±0 and ±inf as on the CPU: the same bits (cbrt's finite
    values within an ulp: the card's pow is not the CPU's)."""
    got = getattr(nd, name)(nd.NDArray(torch.tensor(
        SPECIALS, device=cuda))).asnumpy()
    want = getattr(nd, name)(nd.NDArray(torch.tensor(SPECIALS))).asnumpy()
    if name != "cbrt":
        assert got.tobytes() == want.tobytes()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.signbit(got), np.signbit(want))
    np.testing.assert_allclose(got, want, rtol=2e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("is_ascend", [False, True])
def test_topk_ties_on_the_card(cuda, is_ascend):
    """The stable sort's order on the card: the lower index first among
    ties, NaN and ±0 by totalOrder, as on the CPU."""
    for x, k in ((chip_smoke.TIES, 3), (np.zeros(64), 3), (SPECIALS, 7)):
        x = x.astype(np.float32)
        for typ in ("value", "indices", "both"):
            got = nd.topk(nd.NDArray(torch.tensor(x, device=cuda)), k=k,
                          ret_typ=typ, is_ascend=is_ascend)
            want = nd.topk(nd.NDArray(torch.tensor(x)), k=k, ret_typ=typ,
                           is_ascend=is_ascend)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                assert g.asnumpy().tobytes() == w.asnumpy().tobytes()
    ties = nd.NDArray(torch.tensor(chip_smoke.TIES, dtype=torch.float32,
                                   device=cuda))
    assert nd.topk(ties, k=3).asnumpy().tolist() == [0, 1, 2]


def _layer_cases():
    from mxnet_tpu_torch.gluon import nn
    return [
        ("conv1d", lambda: nn.Conv1D(4, 3, padding=1), (2, 3, 9)),
        ("conv2d", lambda: nn.Conv2D(4, 3, strides=2, padding=1,
                                     groups=1), (2, 6, 9, 9)),
        ("conv2d_nhwc", lambda: nn.Conv2D(4, 3, padding=1, layout="NHWC",
                                          activation="relu"), (2, 9, 9, 6)),
        ("conv2d_groups", lambda: nn.Conv2D(6, 3, groups=3, dilation=2),
         (2, 6, 9, 9)),
        ("conv3d", lambda: nn.Conv3D(4, 3, padding=1), (2, 3, 5, 6, 7)),
        ("conv1d_t", lambda: nn.Conv1DTranspose(4, 3, strides=2,
                                                output_padding=1),
         (2, 3, 7)),
        ("conv2d_t", lambda: nn.Conv2DTranspose(4, 3, strides=2, padding=1,
                                                output_padding=1),
         (2, 3, 7, 7)),
        ("conv3d_t", lambda: nn.Conv3DTranspose(2, 3, strides=2),
         (1, 3, 4, 5, 5)),
        ("maxpool2d_ceil", lambda: nn.MaxPool2D(3, 2, ceil_mode=True),
         (2, 3, 10, 10)),
        ("avgpool2d_nopad", lambda: nn.AvgPool2D(3, 2, 1,
                                                 count_include_pad=False),
         (2, 3, 9, 9)),
        ("globalavg_nhwc", lambda: nn.GlobalAvgPool2D(layout="NHWC"),
         (2, 5, 5, 3)),
        ("globalmax3d", lambda: nn.GlobalMaxPool3D(), (2, 3, 4, 4, 4)),
        ("avgpool1d", lambda: nn.AvgPool1D(2), (2, 3, 8)),
        ("batchnorm", lambda: nn.BatchNorm(), (4, 3, 5, 5)),
        ("batchnorm_nhwc", lambda: nn.BatchNorm(axis=3), (4, 5, 5, 3)),
        ("instancenorm", lambda: nn.InstanceNorm(scale=True),
         (2, 3, 5, 5)),
        ("groupnorm", lambda: nn.GroupNorm(num_groups=2), (2, 4, 5, 5)),
        ("reflectionpad", lambda: nn.ReflectionPad2D(2), (2, 3, 5, 5)),
        ("leakyrelu", lambda: nn.LeakyReLU(0.1), (2, 3, 4)),
        ("prelu", lambda: nn.PReLU(in_channels=3), (2, 3, 4)),
        ("elu", lambda: nn.ELU(), (2, 3, 4)),
        ("selu", lambda: nn.SELU(), (2, 3, 4)),
        ("swish", lambda: nn.Swish(), (2, 3, 4)),
        ("gelu", lambda: nn.GELU(), (2, 3, 4)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(24))
def test_vision_layer_on_the_card_matches_the_cpu(cuda, case):
    """Each new layer, forward (training mode) and backward on the card
    against the same layer on the CPU from the same weights, TF32 off:
    outputs, input gradients, parameter gradients, BatchNorm's running
    statistics; within 1e-5 of each one's magnitude (f32 sums in cuDNN's
    order against oneDNN's)."""
    name, make, shape = _layer_cases()[case]
    torch.backends.cudnn.allow_tf32 = False
    x = np.random.RandomState(case).randn(*shape).astype(np.float32)
    outs = []
    for dev in ("cpu", cuda):
        layer = make()
        layer.initialize(device=dev, generator=torch.Generator()
                         .manual_seed(case))
        xt = torch.tensor(x, device=dev, requires_grad=True)
        with ag.record():
            y = layer(xt)
        y.backward(torch.ones_like(y))
        params = layer._collect_params_with_prefix()
        outs.append((y.detach().cpu(), xt.grad.cpu(),
                     {k: (p.data().detach().cpu(),
                          None if p.grad_req == "null" else
                          p.grad().detach().cpu())
                      for k, p in params.items()}))
    (ya, ga, pa), (yb, gb, pb) = outs

    def close(a, b):
        return float((a - b).abs().max()) <= 1e-5 * max(
            float(a.abs().max()), 1.0)
    assert close(yb, ya) and close(gb, ga), name
    for k in pa:
        assert close(pb[k][0], pa[k][0]), (name, k)
        if pa[k][1] is not None:
            assert close(pb[k][1], pa[k][1]), (name, k)


@pytest.mark.cuda
def test_resnet18_thumbnail_step_on_the_card_matches_the_cpu(cuda,
                                                              tmp_path):
    """resnet18_v1(thumbnail=True), one SGD-momentum step of bench.py's
    loss at batch 4 on 32x32 on the card against the CPU from the same
    weights (the card net's parameter file), TF32 off: the per-sample
    losses within 1e-5, each parameter's update within 0.1 of its
    2-norm (a ReLU gate that flips at a tie moves a whole gradient
    entry, and through the training-mode BatchNorms the updates before
    it: a few percent at this batch), the running statistics within
    1e-5; the update takes the fused kernel, one launch."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.initializer import Xavier
    torch.backends.cudnn.allow_tf32 = False
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(4, 3, 32, 32).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, 4).astype(np.int32))
    card = vision.resnet18_v1(thumbnail=True, classes=10, prefix="r18c_")
    card.initialize(Xavier(), device=cuda,
                    generator=torch.Generator().manual_seed(0))
    with ag.pause():
        card(x.to(cuda))
    path = str(tmp_path / "r18.params")
    card.save_parameters(path)
    cpu = vision.resnet18_v1(thumbnail=True, classes=10, prefix="r18c_")
    cpu.load_parameters(path, ctx="cpu")
    before = {k: p.data().detach().clone()
              for k, p in cpu._collect_params_with_prefix().items()}
    losses = []
    for net, dev in ((card, cuda), (cpu, "cpu")):
        trainer = tgluon.Trainer(net.collect_params(), "sgd",
                                 {"learning_rate": 1e-3, "momentum": 0.9})
        launches = kernels.launch_counts().get("sgd_mom_update", 0)
        losses.append(chip_smoke.resnet_step(nd, ag, net, trainer,
                                             x.to(dev), y.to(dev))
                      .asnumpy())
        if dev == cuda:
            torch.cuda.synchronize()
            assert kernels.launch_counts()["sgd_mom_update"] == launches + 1
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    mine = card._collect_params_with_prefix()
    for key, p in cpu._collect_params_with_prefix().items():
        got, want = mine[key].data().detach().cpu(), p.data().detach()
        if p.grad_req == "null":
            assert chip_smoke.norm_ratio(got, want) <= 1e-5, key
        else:
            assert chip_smoke.norm_ratio(got - before[key],
                                         want - before[key]) <= 0.1, key


# ------------------------------------------------- the compiled step --
def _cs_mlp(cuda, seed=0, bn=False, dropout=0.0, prefix="cs"):
    """The reference's compiled-step MLP on the card (seeded Xavier),
    optionally with a BatchNorm or a gluon Dropout."""
    from mxnet_tpu_torch.initializer import Xavier
    net = tgluon.nn.HybridSequential(prefix=f"{prefix}{seed}_")
    with net.name_scope():
        net.add(tgluon.nn.Dense(16))
        if bn:
            net.add(tgluon.nn.BatchNorm())
        net.add(tgluon.nn.Activation("relu"))
        if dropout:
            net.add(tgluon.nn.Dropout(dropout))
        net.add(tgluon.nn.Dense(4))
    net.initialize(Xavier(), device=cuda,
                   generator=torch.Generator().manual_seed(seed))
    with ag.pause():
        net(torch.zeros(1, 6, device=cuda))
    return net


def _cs_data(cuda, steps=5, n=32):
    rng = np.random.RandomState(7)
    X = torch.from_numpy(rng.randn(steps, n, 6).astype(np.float32))
    Y = torch.from_numpy((np.arange(steps * n).reshape(steps, n) % 4)
                         .astype(np.float32))
    return X.to(cuda), Y.to(cuda)


def _cs_params(net):
    return {k: p.data().detach().clone()
            for k, p in sorted(net.collect_params().items())}


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [False, True], ids=["mlp", "bn"])
@pytest.mark.parametrize("opt,args", [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 1e-3, "wd": 1e-3})], ids=["sgd", "adam"])
def test_compiled_step_graph_matches_eager_bit_for_bit(cuda, opt, args, bn):
    """Five steps across lr and batch-size changes: the compiled step's
    graphs give the eager record/backward/step's losses, weights and
    running statistics bit for bit; one capture per bucket, one replay
    per later step, the update kernel launched once a step (counted
    through the replays), its rows read from one persistent buffer."""
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    sizes, lrs = [32, 16, 32, 16, 32], [0.05, 0.02, 0.05, 0.01, 0.03]
    X, Y = _cs_data(cuda)
    net_e = _cs_mlp(cuda, bn=bn)
    tr_e = tgluon.Trainer(net_e.collect_params(), opt, dict(args))
    el = []
    for s, n in enumerate(sizes):
        tr_e.set_learning_rate(lrs[s])
        with ag.record():
            loss = loss_fn(net_e(X[s][:n]), Y[s][:n])
        ag.backward(loss)
        tr_e.step(n)
        el.append(loss.detach().clone())
    net_c = _cs_mlp(cuda, bn=bn)
    tr_c = tgluon.Trainer(net_c.collect_params(), opt, dict(args))
    step = tr_c.compile_step(lambda x, y: loss_fn(net_c(x), y))
    rule = "adam_update" if opt == "adam" else "sgd_mom_update"
    captures, cl, rows = kernels.capture_count(), [], set()
    for s, n in enumerate(sizes):
        tr_c.set_learning_rate(lrs[s])
        before = kernels.launch_counts().get(rule, 0)
        replays = step.replays
        cl.append(step(X[s][:n], Y[s][:n]))
        torch.cuda.synchronize()
        assert kernels.launch_counts()[rule] == before + 1, s
        if s >= 2:
            assert step.replays == replays + 1
        rows |= {e.prog.rows.ptr for e in step._cache.values()}
    assert step.last_reason is None
    assert kernels.capture_count() == captures + 2
    assert step.cache_size() == 2 and len(rows) == 2
    for s in range(5):
        assert torch.equal(el[s], cl[s]), f"step {s} loss"
    pe, pc = _cs_params(net_e), _cs_params(net_c)
    for k in pe:
        assert torch.equal(pe[k], pc[k]), k


@pytest.mark.cuda
def test_compiled_step_padded_tail_and_lr_never_recapture(cuda):
    """Ragged tails pad to a warm bucket and lr changes ride the rows:
    no capture after warmup; the tail's per-sample losses equal the
    unpadded eager step's bit for bit."""
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    X, Y = _cs_data(cuda, 10)
    net = _cs_mlp(cuda, 1)
    ref = _cs_mlp(cuda, 1)
    tr = tgluon.Trainer(net.collect_params(), "sgd", {"learning_rate": .05})
    tr_r = tgluon.Trainer(ref.collect_params(), "sgd",
                          {"learning_rate": .05})
    step = tr.compile_step(lambda x, y: loss_fn(net(x), y))
    step(X[0], Y[0])
    step(X[1][:7], Y[1][:7])                 # bucket 8
    captures = kernels.capture_count()
    for s, n in enumerate([20, 32, 7, 19, 32], start=2):
        tr.set_learning_rate(0.01 * s)
        tr_r.set_learning_rate(0.01 * s)
        got = step(X[s][:n], Y[s][:n])
        assert got.shape == (n,)
    assert kernels.capture_count() == captures
    assert step.cache_size() == 2
    # an unpadded eager step from the same weights: the same tail losses
    for p, q in zip(ref.collect_params().values(),
                    net.collect_params().values()):
        p.set_data(q.data().detach())
    got = step(X[8][:20], Y[8][:20])
    with ag.record():
        want = loss_fn(ref(X[8][:20]), Y[8][:20])
    assert torch.equal(got, want.detach())


@pytest.mark.cuda
def test_compiled_step_replays_draw_fresh_dropout_masks(cuda):
    """gluon's Dropout (torch's default generator, registered by the
    capture) and ``nd.Dropout`` (the step's own generator, registered
    with the graph) draw new masks at every replay; one draw position a
    call."""
    from mxnet_tpu_torch import _rng
    net = _cs_mlp(cuda, 2, dropout=0.5)
    tr = tgluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.0})
    X, _ = _cs_data(cuda, 1)

    def loss(x):
        h = net(x)
        return (h ** 2).sum(axis=1), nd.Dropout(nd.NDArray(h), p=0.5)._data
    step = tr.compile_step(loss)
    outs = [step(X[0]) for _ in range(4)]
    torch.cuda.synchronize()
    for a, b in zip(outs[1:], outs[2:]):
        assert not torch.equal(a[0], b[0]), "gluon Dropout mask repeated"
        assert not torch.equal(a[1] != 0, b[1] != 0), \
            "nd.Dropout mask repeated"
    assert step.replays == 3
    d0 = _rng.get_state()["draws"]
    step(X[0])
    assert _rng.get_state()["draws"] == d0 + 1


@pytest.mark.cuda
def test_compiled_step_float16_scaler_skips_on_overflow(cuda):
    """An engaged float16 loss scaler: two graphs (forward and backward
    with the finiteness flag, then the update); bit for bit with the
    eager AMP step at scale 64; at a scale past float32's range the
    update graph does not replay, the weights stay, the scale halves."""
    from mxnet_tpu_torch import amp
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    X, Y = _cs_data(cuda, 4, 16)
    net_e, net_c = _cs_mlp(cuda, 3), _cs_mlp(cuda, 3)
    tr_e = tgluon.Trainer(net_e.collect_params(), "sgd",
                          {"learning_rate": .05})
    amp.init_trainer(tr_e, loss_scaler=amp.LossScaler(
        init_scale=64.0, target_dtype="float16"))
    for s in range(4):
        with ag.record():
            loss = loss_fn(net_e(X[s]), Y[s])
            with amp.scale_loss(loss, tr_e) as scaled:
                pass
        ag.backward(scaled)
        tr_e.step(16)
    tr_c = tgluon.Trainer(net_c.collect_params(), "sgd",
                          {"learning_rate": .05})
    amp.init_trainer(tr_c, loss_scaler=amp.LossScaler(
        init_scale=64.0, target_dtype="float16"))
    step = tr_c.compile_step(lambda x, y: loss_fn(net_c(x), y))
    for s in range(4):
        step(X[s], Y[s])
    assert step.last_reason is None and step.cache_size() == 2
    pe, pc = _cs_params(net_e), _cs_params(net_c)
    for k in pe:
        assert torch.equal(pe[k], pc[k]), k
    net_o = _cs_mlp(cuda, 4)
    tr_o = tgluon.Trainer(net_o.collect_params(), "sgd",
                          {"learning_rate": .05})
    amp.init_trainer(tr_o, loss_scaler=amp.LossScaler(
        init_scale=1e39, target_dtype="float16"))
    st = tr_o.compile_step(lambda x, y: loss_fn(net_o(x), y))
    before = _cs_params(net_o)
    for s in range(2):
        with pytest.warns(UserWarning, match="overflow"):
            st(X[s], Y[s])
    assert tr_o._step_count == 0 and tr_o._amp_loss_scaler.loss_scale == \
        2.5e38
    after = _cs_params(net_o)
    for k in before:
        assert torch.equal(before[k], after[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_compiled_step_remat_on_the_card(cuda, remat):
    """remat recomputes the forward inside the captured backward: the
    same bits as the eager step, and the BatchNorm's running statistics
    written once a step."""
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    X, Y = _cs_data(cuda, 3)
    net_e, net_c = _cs_mlp(cuda, 5, bn=True), _cs_mlp(cuda, 5, bn=True)
    tr_e = tgluon.Trainer(net_e.collect_params(), "sgd",
                          {"learning_rate": .05})
    for s in range(3):
        with ag.record():
            loss = loss_fn(net_e(X[s]), Y[s])
        ag.backward(loss)
        tr_e.step(32)
    tr_c = tgluon.Trainer(net_c.collect_params(), "sgd",
                          {"learning_rate": .05})
    step = tr_c.compile_step(lambda x, y: loss_fn(net_c(x), y),
                             remat=remat)
    for s in range(3):
        step(X[s], Y[s])
    assert step.last_reason is None
    pe, pc = _cs_params(net_e), _cs_params(net_c)
    for k in pe:
        assert torch.equal(pe[k], pc[k]), k


@pytest.mark.cuda
def test_compiled_step_host_read_is_trace_failed_on_the_card(cuda):
    """A host read inside loss_fn is the sticky trace_failed fallback on
    the card too (found in the warm run, before any capture); eager
    training goes on."""
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    X, Y = _cs_data(cuda, 2)
    net = _cs_mlp(cuda, 6)
    tr = tgluon.Trainer(net.collect_params(), "sgd", {"learning_rate": .05})

    def branchy(x, y):
        out = net(x)
        if float(nd.sum(nd.NDArray(out)).asscalar()) > 1e9:
            out = out * 2
        return loss_fn(out, y)
    step = tr.compile_step(branchy)
    captures = kernels.capture_count()
    w0 = _cs_params(net)
    with pytest.warns(UserWarning, match="trace failed"):
        step(X[0], Y[0])
    step(X[1], Y[1])
    assert step.last_reason == "trace_failed"
    assert kernels.capture_count() == captures
    assert any(not torch.equal(w0[k], v)
               for k, v in _cs_params(net).items())


@pytest.mark.cuda
def test_hybridized_block_replays_its_graph_bit_for_bit(cuda, tmp_path):
    """A hybridized block: one capture per signature (the forward, or
    under record the forward and backward pair), none on a repeated
    call; its outputs and gradients are the eager call's bits; a BN's
    running statistics update once a training call; new weights loaded
    in place are what the next replay computes with."""
    net = _cs_mlp(cuda, 7, bn=True, prefix="hy")
    ref = _cs_mlp(cuda, 7, bn=True, prefix="hy")
    net.hybridize()
    x = torch.randn(8, 6, device=cuda)
    captures = kernels.capture_count()
    with ag.pause():
        want = ref(x)
        got1, got2 = net(x), net(x)
    assert kernels.capture_count() == captures + 1
    assert torch.equal(got1, want) and torch.equal(got2, want)
    assert got1.data_ptr() != got2.data_ptr()     # copies, not the buffer
    for _ in range(2):
        xe = x.clone().requires_grad_(True)
        xh = x.clone().requires_grad_(True)
        with ag.record():
            le = (ref(xe) ** 2).sum()
            lh = (net(xh) ** 2).sum()
        ag.backward(le)
        ag.backward(lh)
        assert torch.equal(le, lh)
        assert torch.equal(xe.grad, xh.grad)
        for (k, p), q in zip(sorted(ref.collect_params().items()),
                             [q for _, q in
                              sorted(net.collect_params().items())]):
            if p.grad_req != "null":
                assert torch.equal(p.grad(), q.grad()), k
            else:
                assert torch.equal(p.data(), q.data()), k
    assert kernels.capture_count() == captures + 3   # + fwd/bwd pair
    path = str(tmp_path / "hy.params")
    for p in ref.collect_params().values():
        p.set_data(p.data().detach() * 0.5)
    ref.save_parameters(path)
    net.load_parameters(path)
    with ag.pause():
        assert torch.equal(net(x), ref(x))
    assert kernels.capture_count() == captures + 3
    assert net._cached_op.graphs == 3


# ------------------------------ the sparse tier and the optimizer tail --
# Card against CPU copies: the lazy updates' arithmetic is the same
# operations in the same order on both (the repeats' sum in a fixed
# order), held within SPARSE_TOL = 1e-6 of the weights' scale; untouched
# rows, the segment sum's repeat, 2-bit compression and the store's pulls
# bit for bit; sparse.dot and its gradient (an atomic sum on the card)
# within 1e-5 of the output's magnitude; the LAMB/AdaGrad update tail's
# corpus cases as phase 7b holds them (chip_smoke.corpus_tol).
SPARSE_TOL = 1e-6


def _sparse_emb(dev, vocab, dim, seed, sparse_grad=True, prefix="se_"):
    emb = tgluon.nn.Embedding(vocab, dim, sparse_grad=sparse_grad,
                              prefix=prefix)
    emb.initialize(device=dev)
    w = torch.Generator().manual_seed(seed)
    emb.weight.set_data(torch.randn(vocab, dim, generator=w) * 0.1)
    return emb


def _emb_step(emb, tr, ids, dev):
    x = nd.array(ids, ctx=dev)
    with ag.record():
        loss = ((emb(x) - 0.25) ** 2).sum()
    loss.backward()
    tr.step(len(ids))


@pytest.mark.cuda
@pytest.mark.parametrize("opt,args", [
    ("sgd", {"learning_rate": 0.5}),
    ("sgd", {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.05, "wd": 1e-3}),
    ("adagrad", {"learning_rate": 0.1})])
def test_lazy_updates_on_the_card_keep_untouched_rows(cuda, opt, args):
    """Three steps on the card and on the CPU from the same weights and
    ids (repeats included): the same rows move, by the CPU's amounts;
    every other row of the weight and of the states keeps its bits; the
    fused updater counts ``sparse_grad``."""
    rs = np.random.RandomState(2)
    batches = [rs.randint(0, 40, 24) for _ in range(3)]
    runs = []
    for dev in (cuda, torch.device("cpu")):
        emb = _sparse_emb(dev, 300, 16, 1)
        tr = tgluon.Trainer(emb.collect_params(), opt, dict(args))
        w0 = emb.weight.data().detach().clone()
        for ids in batches:
            _emb_step(emb, tr, ids, dev)
        assert dict(tr._fused.fallbacks) == {"sparse_grad": 3}
        runs.append((emb.weight.data().detach().cpu(), w0.cpu(),
                     [s.cpu() for s in chip_smoke._state_leaves(
                         tr._updaters[0].states[0])]))
    (w, w0, st), (wc, _, stc) = runs
    rest = sorted(set(range(300)) - set(np.concatenate(batches).tolist()))
    assert torch.equal(w[rest], w0[rest])
    for s in st:
        assert not s[rest].any()
    assert float((w - wc).abs().max()) <= SPARSE_TOL * float(
        wc.abs().max())
    for s, sc in zip(st, stc):
        assert float((s - sc).abs().max()) <= SPARSE_TOL * max(
            1.0, float(sc.abs().max()))


@pytest.mark.cuda
def test_segment_sum_repeats_its_bits_on_the_card(cuda):
    """The repeats of a row summed in a fixed order: twice the same bits
    on the card, and the CPU's bits (one sum order on both)."""
    from mxnet_tpu_torch.ndarray.sparse import summed_rows
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(0, 64, (1 << 14,), generator=g)
    vals = torch.randn(1 << 14, 32, generator=g)
    r1, s1 = summed_rows(ids.to(cuda), vals.to(cuda))
    r2, s2 = summed_rows(ids.to(cuda), vals.to(cuda))
    rc, sc = summed_rows(ids, vals)
    assert torch.equal(r1, r2) and torch.equal(s1, s2)
    assert torch.equal(r1.cpu(), rc) and torch.equal(s1.cpu(), sc)


@pytest.mark.cuda
def test_sparse_embedding_grad_and_fallbacks_on_the_card(cuda):
    """The card's row-sparse gradient is the CPU's (ids in lookup order,
    rows equal); ``compile_step`` falls back with ``sparse_grad``; a
    hybridized block (CUDA graphs) takes the dense gradient, equal to
    the sparse one densified."""
    ids = np.array([[3, 9, 3], [1, 9, 0]])
    grads = []
    for dev in (cuda, torch.device("cpu")):
        emb = _sparse_emb(dev, 50, 8, 3, prefix="sg_")
        with ag.record():
            loss = (emb(nd.array(ids, ctx=dev)) ** 2).sum()
        loss.backward()
        grads.append(emb.weight.grad())
    g, gc = grads
    assert g.indices.asnumpy().tolist() == [3, 9, 3, 1, 9, 0] == \
        gc.indices.asnumpy().tolist()
    assert torch.equal(g.data._data.cpu(), gc.data._data)
    emb = _sparse_emb(cuda, 50, 8, 3, prefix="sg2_")
    tr = tgluon.Trainer(emb.collect_params(), "adam",
                        {"learning_rate": 0.01})
    step = tr.compile_step(lambda x: emb(x).sum(axis=1))
    step(nd.array(ids, ctx=cuda))
    assert step.last_reason == "sparse_grad"
    hyb = _sparse_emb(cuda, 50, 8, 3, prefix="sg3_")
    hyb.hybridize()
    for _ in range(2):
        with ag.record():
            loss = (hyb(nd.array(ids, ctx=cuda)) ** 2).sum()
        loss.backward()
        dense = hyb.weight.grad()
        assert isinstance(dense, torch.Tensor) and not dense.is_sparse
        assert float((dense.cpu() - gc.asnumpy()).abs().max()) <= 1e-6
    assert hyb._cached_op.graphs == 2


@pytest.mark.cuda
def test_sparse_dot_and_its_gradient_on_the_card(cuda):
    from mxnet_tpu_torch.ndarray import sparse
    rs = np.random.RandomState(6)
    n, feat, nnz = 256, 1 << 16, 39
    cols = np.stack([rs.choice(feat, nnz, replace=False) for _ in range(n)])
    indptr = np.arange(0, n * nnz + 1, nnz)
    data = rs.randn(n * nnz).astype(np.float32)
    w_np = rs.randn(feat, 1).astype(np.float32)
    dy = rs.randn(n, 1).astype(np.float32)
    outs = []
    for dev in (cuda, "cpu"):
        csr = sparse.csr_matrix((data, cols.reshape(-1), indptr),
                                shape=(n, feat), ctx=dev)
        w = nd.array(w_np, ctx=dev)
        w.attach_grad()
        with ag.record():
            out = sparse.dot(csr, w)
            loss = (out * nd.array(dy, ctx=dev)).sum()
        loss.backward()
        assert not csr.densified
        outs.append((out.asnumpy(), w.grad.asnumpy()))
    for got, want in zip(*outs):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(sum(
    1 for c in chip_smoke.CORPUS if c[3] == "update")))
def test_lamb_and_adagrad_tail_on_the_card(cuda, k):
    """The update tail's corpus cases through ``nd`` on the card and on
    the CPU (phase 7b's comparison)."""
    case = [c for c in chip_smoke.CORPUS if c[3] == "update"][k]
    name, inputs, kwargs, family = case
    op = get_op(name)
    got, _ = chip_smoke.corpus_run(torch, nd, ag, op, name, inputs, kwargs,
                                   cuda)
    want, _ = chip_smoke.corpus_run(torch, nd, ag, op, name, inputs, kwargs,
                                    "cpu")
    rtol, atol = chip_smoke.corpus_tol(op, family, True)
    for (gs, gd, g), (ws, wd, w) in zip(got, want):
        assert gs == ws and gd == wd
        assert chip_smoke._close(g, w, rtol, atol), name


@pytest.mark.cuda
def test_two_bit_compression_on_the_card_bit_for_bit(cuda):
    from mxnet_tpu_torch.kvstore import compression as gc
    g = torch.Generator().manual_seed(8)
    grad = torch.randn(1 << 20, generator=g) * 0.7
    res = torch.randn(1 << 20, generator=g) * 0.1
    comp = gc.TwoBitCompression(0.5)
    packed, new_res = comp.compress(grad.to(cuda), res.to(cuda))
    packed_c, new_res_c = comp.compress(grad, res)
    assert torch.equal(packed.cpu(), packed_c)
    assert torch.equal(new_res.cpu(), new_res_c)
    assert torch.equal(comp.decompress(packed, grad.shape,
                                       torch.float32).cpu(),
                       comp.decompress(packed_c, grad.shape, torch.float32))


@pytest.mark.cuda
def test_kvstore_row_sparse_pull_on_the_card(cuda):
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.ndarray import sparse
    table = torch.randn(1000, 64, device=cuda)
    kv = tmx.kv.create("local")
    kv.init("emb", table)
    out = sparse.zeros("row_sparse", (1000, 64), ctx=cuda)
    rows = torch.tensor([7, 999, 7, 0, 512], device=cuda)
    kv.row_sparse_pull("emb", out=out, row_ids=rows)
    assert out.indices.asnumpy().tolist() == [0, 7, 512, 999]
    assert torch.equal(out.data._data, table[[0, 7, 512, 999]])
    a = sparse.row_sparse_array((torch.ones(2, 64, device=cuda),
                                 torch.tensor([4, 4], device=cuda)),
                                shape=(1000, 64))
    kv.push("emb", [a, a])
    dense = torch.zeros(1000, 64, device=cuda)
    kv.pull("emb", out=dense)
    assert torch.equal(dense[4], torch.full((64,), 4.0, device=cuda))
    assert int((dense != 0).any(dim=1).sum()) == 1


# ------------------------------------------------- the rest of gluon ------
@pytest.mark.cuda
def test_context_places_tensors_on_the_card(cuda):
    import mxnet_tpu_torch as tmx
    a = nd.zeros((2, 3), ctx=tmx.gpu(0))
    assert a._data.is_cuda and a.context == tmx.gpu(0)
    with tmx.gpu(0):
        assert nd.ones((2,)).context == tmx.gpu(0)
        net = tgluon.nn.Dense(4, in_units=3, prefix="cudactx_")
        net.initialize()
    assert net.weight.data().is_cuda
    net2 = tgluon.nn.Dense(4, in_units=3, prefix="cudactx2_")
    net2.initialize(ctx=tmx.gpu(0))
    assert net2.weight.data().is_cuda
    assert nd.array(np.ones(2), ctx=tmx.tpu(0)).context == tmx.gpu(0)
    assert nd.zeros((1,)).context == tmx.gpu(0)     # the default: the card
    assert a.as_in_context(tmx.cpu()).context == tmx.cpu()
    free, total = tmx.gpu(0).memory_info()
    assert 0 < free <= total


def _host_dataset(n=40):
    rs = np.random.RandomState(0)
    return (rs.randn(n, 3, 8, 8).astype(np.float32),
            rs.randint(0, 5, n).astype(np.float32))


@pytest.mark.cuda
def test_dataloader_workers_with_the_card_initialised(cuda):
    from mxnet_tpu_torch.gluon import data as tdata
    torch.zeros(1, device=cuda).sum().item()        # CUDA is initialised
    x, y = _host_dataset()
    ds = tdata.ArrayDataset(x, y)
    serial = [(a.asnumpy(), b.asnumpy())
              for a, b in tdata.DataLoader(ds, batch_size=8)]
    loader = tdata.DataLoader(ds, batch_size=8, num_workers=2,
                              pin_memory=True)
    got = []
    for a, b in loader:
        assert a._data.is_pinned() and b._data.is_pinned()
        got.append((a.asnumpy(), b.asnumpy()))
    loader.close()
    assert len(got) == len(serial) == 5
    for (a, b), (c, d) in zip(got, serial):
        assert np.array_equal(a, c) and np.array_equal(b, d)


@pytest.mark.cuda
def test_prefetch_staging_reads_back_bit_for_bit(cuda):
    """Staged batches come out on the card in order, each equal to the
    host's: the consumer's stream waits on the copy's event, and work it
    queues on a staged batch reads the batch's bits."""
    from mxnet_tpu_torch.gluon import data as tdata
    x, y = _host_dataset(96)
    loader = tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=8,
                              num_workers=2, pin_memory=True,
                              device_prefetch=3)
    for epoch in range(2):
        sums = []
        for i, (a, b) in enumerate(loader):
            assert a._data.is_cuda and b._data.is_cuda
            sums.append(a._data.double().sum(dim=(1, 2, 3)))
            np.testing.assert_array_equal(a.asnumpy(), x[i * 8:i * 8 + 8])
            np.testing.assert_array_equal(b.asnumpy(), y[i * 8:i * 8 + 8])
            torch.cuda._sleep(2_000_000)   # a busy consumer stream
        got = torch.cat(sums).cpu().numpy()
        np.testing.assert_array_equal(
            got, x.astype(np.float64).sum(axis=(1, 2, 3)))
    loader.close()


@pytest.mark.cuda
def test_rnn_layers_cells_and_losses_on_the_card_match_cpu(cuda):
    torch.backends.cudnn.allow_tf32 = False
    worst = chip_smoke.run_g_parts(torch, np.random.RandomState(0))
    assert len(worst) == 22


@pytest.mark.cuda
def test_ssd_step_on_the_card_matches_cpu(cuda):
    """The small SSD of ``tests/test_detection.py``: one training step's
    loss and every gradient on the card against the CPU from the same
    weights, TF32 off; then ``detect()``'s rows."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo import ssd
    torch.backends.cudnn.allow_tf32 = False

    def build(dev):
        s1 = nn.HybridSequential(prefix="")
        s1.add(nn.Conv2D(16, 3, strides=2, padding=1, activation="relu"))
        s1.add(nn.Conv2D(16, 3, strides=2, padding=1, activation="relu"))
        s2 = nn.HybridSequential(prefix="")
        s2.add(nn.Conv2D(16, 3, strides=2, padding=1, activation="relu"))
        net = ssd.SSD([s1, s2], sizes=[(0.3,), (0.6,)],
                      ratios=[(1.0, 2.0), (1.0, 2.0)], steps=[-1.0, -1.0],
                      classes=2, prefix="cudassd_")
        net.initialize(device=dev,
                       generator=torch.Generator().manual_seed(0))
        return net
    imgs, labels = chip_smoke.g_ssd_data(3, 8, 32, 2)
    res = {}
    for dev in (cuda, "cpu"):
        net = build(dev)
        with ag.record():
            c, lo, a = net(torch.from_numpy(imgs).to(dev))
            loss = ssd.MultiBoxLoss()(c, lo, torch.from_numpy(labels).to(
                dev), a).mean()
        loss.backward()
        res[str(dev)] = (loss.item(), {
            k: p.grad().cpu() for k, p in
            net._collect_params_with_prefix().items()})
        if dev == cuda:
            with ag.pause():
                det = net.detect(torch.from_numpy(imgs).to(dev)).cpu()
    (l1, g1), (l2, g2) = res[str(cuda)], res["cpu"]
    assert abs(l1 - l2) <= 1e-5 * abs(l2)
    for k in g2:
        err = float((g1[k] - g2[k]).abs().max())
        assert err <= 1e-4 * max(float(g2[k].abs().max()), 1e-6), k
    assert det.shape[0] == 8 and det.shape[-1] == 6
    live = det[det[..., 0] >= 0]
    assert ((live[:, 1] >= 0) & (live[:, 1] <= 1)).all()


@pytest.mark.cuda
def test_profiler_device_lane_holds_a_flash_forward(cuda, tmp_path,
                                                    monkeypatch):
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.observability import rollup
    monkeypatch.setitem(profiler._config, "filename", str(tmp_path / "p"))
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 4, 256, 64, generator=g, device=cuda)
               for _ in range(3))
    tfa.flash_attention(q, k, v)                 # built outside the capture
    torch.cuda.synchronize()
    profiler.set_state("run")
    tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    profiler.set_state("stop")
    dev = profiler.dumps(format_="dict", lane="device")
    fwd = [us for name, (us, _) in dev.items() if "flash_fwd_kernel" in name]
    assert fwd and fwd[0] > 0, sorted(dev)
    assert profiler.dumps().splitlines()[0].startswith("Name")
    fam, total = rollup.rollup(str(tmp_path / "p"))
    assert fam["flash_fwd"] > 0 and total >= fam["flash_fwd"]


@pytest.mark.cuda
def test_compile_count_reads_the_counter_after_a_capture(cuda):
    from mxnet_tpu_torch.observability import compilemon, get_registry
    from mxnet_tpu_torch.serving import telemetry
    x = torch.ones(64, device=cuda)
    out = torch.empty_like(x)
    reg = get_registry()
    c0 = compilemon.compile_count()
    s0 = reg.histogram("mxtpu_xla_compile_seconds").count
    b0 = kernels.build_count() + kernels.capture_count()
    graph = kernels.capture(lambda: out.copy_(x * 2), torch.cuda.Stream(),
                            what="a doubling")
    graph.replay()
    torch.cuda.synchronize()
    assert bool((out == 2).all())
    assert compilemon.compile_count() - c0 == 1
    assert kernels.build_count() + kernels.capture_count() - b0 == 1
    assert reg.histogram("mxtpu_xla_compile_seconds").count - s0 == 1
    # the registry's counter restarts with the registry, the kernels'
    # counts with the process: the views agree on what moved
    assert telemetry.compile_count() == compilemon.compile_count()


@pytest.mark.cuda
def test_estimator_compiled_fit_matches_a_bare_compiled_loop(cuda):
    from mxnet_tpu_torch import metric
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.contrib.estimator import Estimator
    rs = np.random.RandomState(0)
    batches = [(torch.from_numpy(rs.randn(16, 8).astype(np.float32))
                .to(cuda), torch.from_numpy(rs.randint(0, 3, 16).astype(
                    np.float32)).to(cuda)) for _ in range(4)]
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()

    def build(prefix):
        net = nn.HybridSequential(prefix=prefix)
        with net.name_scope():
            net.add(nn.Dense(32, activation="relu", in_units=8),
                    nn.Dense(3, in_units=32))
        net.initialize(device=cuda,
                       generator=torch.Generator().manual_seed(0))
        tr = tgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
        return net, tr
    net_b, tr_b = build("estb_")

    def loss_and_pred(x, y):
        pred = net_b(x)
        return loss_fn(pred, y), pred
    step = tr_b.compile_step(loss_and_pred)
    for x, y in batches:
        step(x, y)
    net, tr = build("esta_")
    est = Estimator(net, loss_fn, train_metrics=[metric.Accuracy()],
                    trainer=tr)
    c0 = kernels.capture_count()
    est.fit(batches, epochs=1, compiled_step=True)
    torch.cuda.synchronize()
    assert est._compiled_step_auto.replays == len(batches) - 1
    assert kernels.capture_count() - c0 == 1
    for (_, a), (_, b) in zip(sorted(net.collect_params().items()),
                              sorted(net_b.collect_params().items())):
        assert torch.equal(a.data(), b.data())
    assert 0.0 <= est.train_metrics[0].get()[1] <= 1.0


@pytest.mark.cuda
def test_metrics_on_bf16_cuda_tensors_equal_f32(cuda):
    from mxnet_tpu_torch import metric
    rs = np.random.RandomState(3)
    label = torch.from_numpy(rs.randint(0, 10, 64).astype(np.float32))
    pred16 = torch.from_numpy(rs.uniform(0.01, 1, (64, 10)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    pred32 = pred16.float()
    for make in (metric.Accuracy, lambda: metric.TopKAccuracy(3),
                 metric.CrossEntropy, metric.MAE):
        a, b = make(), make()
        lab = label if not isinstance(a, metric.MAE) else \
            torch.from_numpy(rs.uniform(size=(64, 10)).astype(np.float32))
        a.update([lab.to(cuda)], [pred16])
        b.update([lab], [pred32.cpu()])
        assert a.get() == b.get(), (a.get(), b.get())

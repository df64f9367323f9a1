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
the fused Trainer step to the per-parameter loop.
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
    handle = net.transform.act.register_forward_hook(hook)
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

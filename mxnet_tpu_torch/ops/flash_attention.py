"""Flash attention of the port: forward and backward kernels, their plain
twins, and the attention op (mirrors ``mxnet_tpu/ops/flash_attention.py``).

- :func:`attention_reference` — plain attention, the oracle (end-aligned
  causal mask ``tril(k=Tk-Tq)``, as in the JAX package).
- :func:`flash_forward_reference` / :func:`flash_backward_reference` —
  the plain twins of the kernels: the forward returns ``(out, lse)``; the
  backward works from the saved ``lse`` and ``delta = rowsum(dO * O)``,
  as ``_flash_backward`` does, and splits into the dK/dV(/dbias) part
  (:func:`flash_bwd_dkv_reference`) and the dQ part
  (:func:`flash_bwd_dq_reference`), so that each kernel has its own twin.
- :func:`flash_forward`, :func:`flash_bwd_dkv`, :func:`flash_bwd_dq` — the
  kernel wrappers. A CPU tensor takes the twin; a CUDA tensor launches
  ``csrc/flash_attention.cu`` for f32 (``flash_fwd``, the port of
  ``_fwd_kernel``; ``flash_bwd_dkv`` and ``flash_bwd_dq``, the ports of
  ``_dkv_kernel`` and ``_dq_kernel``) or, for bf16 and f16, the forward
  of ``csrc/flash_fwd_lp_sm90.cu`` and the backward of
  ``csrc/flash_bwd_lp_sm90.cu`` (TMA copies and warpgroup MMAs), or
  raises. Each launch counts in
  :func:`mxnet_tpu_torch.kernels.launch_counts` under
  :func:`kernel_name`: the f32 kernels under those names, the 16-bit ones
  as ``flash_fwd.bf16``, ``flash_bwd_dkv.f16`` and so on.
- :func:`flash_attention` — the ``custom_vjp`` pair as one
  ``torch.autograd.Function``; :func:`scaled_dot_product_attention` — the
  op (``flash=False`` is :func:`attention_reference`), registered as
  ``nd.scaled_dot_product_attention``.

16-bit inputs (bf16 or f16 q, k, v and dout, all of one dtype) follow
the TPU kernels' native-rate path: scores, softmax statistics and every
accumulator in f32; P rounded to V's dtype before ``P V``, P^T and dS^T
to q's dtype before dV and dK, dS to k's dtype before dQ; out, dq, dk
and dv in the input dtype; lse, delta and the per-head bias gradient in
f32. The bias may be f32 or the 16-bit type (AMP casts the mask too);
the wrappers widen it to f32 once, which is exact.

Semantics kept from the JAX flash path: the causal mask compares absolute
query and key positions (``row >= col``, also when ``Tq != Tk``); masked
scores are ``-1e30``, never ``-inf``; the denominator is floored at
``1e-30``. A row whose every key the bias masks attends uniformly over all
keys (``out`` is the mean of ``v``), as the JAX kernel gives when no key
padding is added. The kernels mask the ragged edge themselves: keys past
``Tk`` and queries past ``Tq`` take no part, with no padded copy.

The kernels are instantiated for head dims 16, 32, 64, 128 and 256 (the
f32 ``mma.sync`` kernels at 256 with 32-row tiles: a 64-row tile does not
fit one SM's shared memory in the f32 forward, nor dK/dV in the
registers of the backward; the 16-bit kernels keep 64 rows a CTA, the
backward streaming 32-row tiles where registers need it). Any other
``D <= 256`` runs at the next of those: the wrappers zero-pad q, k, v
(and dout) along ``D``, pass the scale of the true ``D`` and slice the
outputs back. That is exact: zero columns add nothing to a score, and
the padded output and gradient columns are dropped. ``D > 256`` raises.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .. import kernels
from .invoke import amp_cast
from .registry import register

__all__ = ["attention_reference", "flash_forward_reference",
           "flash_backward_reference", "flash_bwd_dkv_reference",
           "flash_bwd_dq_reference", "flash_forward", "flash_bwd_dkv",
           "flash_bwd_dq", "flash_backward", "flash_attention",
           "scaled_dot_product_attention", "kernel_head_dim",
           "kernel_name", "KERNEL_NAMES"]

_NEG_INF = -1e30
# launch-counter names of the three f32 kernels (forward, dK/dV, dQ)
KERNEL_NAMES = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
_HEAD_DIMS = (16, 32, 64, 128, 256)
# the dtypes the kernels take: (entry-point suffix, the backward's
# library)
_ROUTES = {torch.float32: ("f32", "flash_attention"),
           torch.bfloat16: ("bf16", "flash_bwd_lp_sm90"),
           torch.float16: ("f16", "flash_bwd_lp_sm90")}
# the forward's library, where it is not the backward's: the 16-bit
# forward and backward are sources of their own (TMA and wgmma)
_FWD_LIBS = {torch.bfloat16: "flash_fwd_lp_sm90",
             torch.float16: "flash_fwd_lp_sm90"}


def kernel_name(base, dtype):
    """The launch-counter name of kernel ``base`` (one of
    :data:`KERNEL_NAMES`) on ``dtype`` inputs: ``base`` for f32,
    ``base + ".bf16"`` or ``".f16"`` for the 16-bit kernels."""
    tag = _ROUTES[dtype][0]
    return base if tag == "f32" else f"{base}.{tag}"


def attention_reference(q, k, v, bias=None, causal=False, scale=None):
    """Plain attention, numerically the oracle for the kernels.

    q/k/v: (B, H, T, D); bias: (B, Tk) additive (0 keep / -inf drop).
    """
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / float(d) ** 0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * s
    if bias is not None:
        logits = logits + bias[:, None, None, :].float()
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(diagonal=tk - tq)
        logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _default_scale(q, scale):
    return float(scale) if scale is not None else float(
        1.0 / (q.shape[-1] ** 0.5))


def _wide(x):
    """``x`` in the twins' arithmetic type: f32, or f64 for f64 inputs
    (an exact reference for the f32 kernels)."""
    return x if x.dtype == torch.float64 else x.float()


def _lowp(x):
    """The 16-bit type the TPU kernels round P and dS to for ``x``'s
    dtype (bf16 or f16), else None: f32 and f64 round nothing."""
    return x.dtype if x.dtype in (torch.bfloat16, torch.float16) else None


def _round(x, dtype):
    """``x`` rounded to ``dtype`` and widened back to f32, as a product
    operand the TPU kernels cast with ``astype``; ``x`` itself where
    ``dtype`` is None."""
    return x if dtype is None else x.to(dtype).float()


def _scores(q, k, bias, scale):
    """``q k^T * scale + bias`` in f32 (f64 for f64 q), (B, H, Tq, Tk)."""
    s = torch.einsum("bhqd,bhkd->bhqk", _wide(q), _wide(k)) * scale
    if bias is not None:
        s = s + _wide(bias)[:, None, None, :]
    return s


def _causal_keep(tq, tk, device):
    """The flash path's causal mask: query row i sees key j <= i
    (absolute positions, not end-aligned)."""
    rows = torch.arange(tq, device=device)[:, None]
    cols = torch.arange(tk, device=device)[None, :]
    return rows >= cols


def flash_forward_reference(q, k, v, bias, causal, scale):
    """Plain twin of the forward kernel: ``(out (B, H, Tq, D),
    lse (B*H, Tq) f32)``."""
    B, H, Tq, _ = q.shape
    s = _scores(q, k, bias, scale)
    if causal:
        s = torch.where(_causal_keep(Tq, k.shape[2], q.device), s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", _round(p, _lowp(v)),
                       _wide(v)) / l_safe
    lse = (m + torch.log(l_safe)).reshape(B * H, Tq)
    return out.to(q.dtype), lse


def _probs(q, k, bias, lse, causal, scale):
    """Recomputed probabilities ``exp(s - lse)``, zero where the causal
    mask drops the pair (the backward kernels' ``_bwd_scores``)."""
    B, H, Tq, _ = q.shape
    s = _scores(q, k, bias, scale)
    p = torch.exp(s - lse.reshape(B, H, Tq, 1))
    if causal:
        p = torch.where(_causal_keep(Tq, k.shape[2], q.device), p, 0.0)
    return p


def _dscores(q, k, v, bias, dout, lse, delta, causal, scale):
    B, H, Tq, _ = q.shape
    p = _probs(q, k, bias, lse, causal, scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", _wide(dout), _wide(v))
    return p, p * (dp - delta.reshape(B, H, Tq, 1))


def flash_bwd_dkv_reference(q, k, v, bias, dout, lse, delta, causal,
                            scale, want_dbias=False):
    """Plain twin of the dK/dV kernel: ``(dk, dv, dbias)`` with ``dbias``
    per head, ``(B*H, Tk)`` f32 (f64 for f64 inputs) from the unrounded
    dS, or None unless ``want_dbias``."""
    B, H, _, _ = q.shape
    lp = _lowp(q)
    p, ds = _dscores(q, k, v, bias, dout, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", _round(p, lp), _wide(dout))
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", _round(ds, lp), _wide(q))
    dbias = ds.sum(dim=2).reshape(B * H, -1) if want_dbias else None
    return dk.to(k.dtype), dv.to(v.dtype), dbias


def flash_bwd_dq_reference(q, k, v, bias, dout, lse, delta, causal, scale):
    """Plain twin of the dQ kernel."""
    _, ds = _dscores(q, k, v, bias, dout, lse, delta, causal, scale)
    return (scale * torch.einsum("bhqk,bhkd->bhqd", _round(ds, _lowp(k)),
                                 _wide(k))).to(q.dtype)


def _delta(out, dout):
    B, H, Tq, _ = out.shape
    return (dout.float() * out.float()).sum(dim=-1).reshape(B * H, Tq)


def _backward(dkv, dq, q, k, v, bias, out, lse, dout, causal, scale,
              want_dbias):
    """``(dq, dk, dv, dbias)`` through the given dK/dV and dQ functions
    (kernel wrappers or twins); ``delta`` and the head-sum of the bias
    gradient stay in torch, as the JAX package keeps them in XLA."""
    want = bias is not None and want_dbias
    scale = _default_scale(q, scale)
    delta = _delta(out, dout)
    dk, dv, db = dkv(q, k, v, bias, dout, lse, delta, causal, scale,
                     want_dbias=want)
    dq_ = dq(q, k, v, bias, dout, lse, delta, causal, scale)
    if want:
        db = db.reshape(q.shape[0], -1, db.shape[-1]).sum(dim=1).to(
            bias.dtype)
    return dq_, dk, dv, db


def flash_backward_reference(q, k, v, bias, out, lse, dout, causal, scale,
                             want_dbias=True):
    """Plain backward from the saved ``lse``: ``(dq, dk, dv, dbias)``;
    ``dbias`` (B, Tk) is computed when a bias was passed and
    ``want_dbias``, else None."""
    return _backward(flash_bwd_dkv_reference, flash_bwd_dq_reference, q, k,
                     v, bias, out, lse, dout, causal, scale, want_dbias)


# ---------------------------------------------------------------- kernels --

def _check_cuda(q, k, v, bias, dout=None, lse=None, delta=None):
    """Validate what the kernels take: q, k, v (and dout) of one dtype
    the kernels have (f32, bf16, f16), a bias of f32 or that dtype, f32
    lse and delta. Returns ``(B, H, Tq, Tk, D, bias as f32, entry-point
    suffix, library)``."""
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for {q.device}")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if not 1 <= D <= _HEAD_DIMS[-1]:
        raise ValueError(f"flash attention kernels take head_dim 1 to "
                         f"{_HEAD_DIMS[-1]}, got {D}")
    dt = q.dtype
    if dt not in _ROUTES:
        raise TypeError(f"flash attention kernels take float32, bfloat16 "
                        f"or float16 q, got {dt}")
    dev, f32, req = q.device, torch.float32, kernels.require
    req(q, "q", dt, (B, H, Tq, D), dev)
    req(k, "k", dt, (B, H, Tk, D), dev)
    req(v, "v", dt, (B, H, Tk, D), dev)
    if bias is not None:
        req(bias, "bias", dt if bias.dtype == dt else f32, (B, Tk), dev)
        bias = bias.float()
    if dout is not None:
        req(dout, "dout", dt, (B, H, Tq, D), dev)
        req(lse, "lse", f32, (B * H, Tq), dev)
        req(delta, "delta", f32, (B * H, Tq), dev)
    return (B, H, Tq, Tk, D, bias) + _ROUTES[dt]


def _ptr(t):
    return None if t is None else t.data_ptr()


def kernel_head_dim(D):
    """The instantiated head dim a kernel runs ``D`` at: the least of
    16, 32, 64, 128, 256 that is ``>= D``."""
    return next(d for d in _HEAD_DIMS if d >= D)


def _pad(x, Dp):
    """``x`` zero-padded along its last axis to ``Dp``."""
    if x.shape[-1] == Dp:
        return x
    return torch.nn.functional.pad(x, (0, Dp - x.shape[-1]))


def _unpad(x, D):
    return x if x.shape[-1] == D else x[..., :D].contiguous()


# FLOPs of the kernels' launches while an :func:`opaque_flops` count is
# open: torch's FlopCounterMode cannot see a ctypes launch. Counted from
# the shapes: 4·D a (query, key) pair forward (QK^T and PV), 8·D
# backward (dV, dP, dK, dQ; the recomputed QK^T not counted), as
# PERF.md §6's bounds count them. The backward's launches run on
# autograd's thread: one count for the process, under a lock.
_OPAQUE = {"depth": 0, "flops": 0}
_OPAQUE_LOCK = threading.Lock()


@contextlib.contextmanager
def opaque_flops():
    """Count the flash kernels' FLOPs launched inside the block; yields a
    dict whose ``"flops"`` holds the count at the block's end."""
    res = {"flops": 0}
    with _OPAQUE_LOCK:
        _OPAQUE["depth"] += 1
        start = _OPAQUE["flops"]
    try:
        yield res
    finally:
        with _OPAQUE_LOCK:
            res["flops"] = _OPAQUE["flops"] - start
            _OPAQUE["depth"] -= 1
            if not _OPAQUE["depth"]:
                _OPAQUE["flops"] = 0


def _tally(B, H, Tq, Tk, D, causal, per_pair):
    if _OPAQUE["depth"]:
        pairs = B * H * (Tq * (Tk + 1) // 2 if causal else Tq * Tk)
        with _OPAQUE_LOCK:
            _OPAQUE["flops"] += per_pair * D * pairs


def flash_forward(q, k, v, bias, causal, scale):
    """Forward kernel wrapper: ``(out, lse (B*H, Tq))``. CPU tensors take
    the plain twin; CUDA tensors (f32, bf16 or f16, contiguous) launch
    the forward kernel of their dtype or raise."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, bias, causal, scale)
    B, H, Tq, Tk, D, bias, tag, libname = _check_cuda(q, k, v, bias)
    Dp = kernel_head_dim(D)
    q, k, v = (_pad(t, Dp) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
    if B * H * Tq == 0:
        return _unpad(out, D), lse
    entry = f"mxt_flash_fwd_{tag}"
    libname = _FWD_LIBS.get(q.dtype, libname)
    rc = getattr(kernels.library(libname), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
        out.data_ptr(), lse.data_ptr(), B * H, H, Tq, Tk, Dp,
        int(bool(causal)), scale, kernels.stream_handle(q.device))
    kernels.check(rc, entry)
    kernels.count_launch(kernel_name("flash_fwd", q.dtype))
    _tally(B, H, Tq, Tk, D, causal, 4)
    return _unpad(out, D), lse


def flash_bwd_dkv(q, k, v, bias, dout, lse, delta, causal, scale,
                  want_dbias=False):
    """dK/dV(/dbias) kernel wrapper: ``(dk, dv, dbias (B*H, Tk) or
    None)``; ``delta = rowsum(dout * out)`` (B*H, Tq)."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, bias, dout, lse, delta,
                                       causal, scale, want_dbias)
    if want_dbias and bias is None:
        raise ValueError("want_dbias needs a bias")
    B, H, Tq, Tk, D, bias, tag, libname = _check_cuda(q, k, v, bias, dout,
                                                      lse, delta)
    Dp = kernel_head_dim(D)
    q, k, v, dout = (_pad(t, Dp) for t in (q, k, v, dout))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dbias = (torch.empty((B * H, Tk), dtype=torch.float32,
                         device=q.device) if want_dbias else None)
    if B * H * Tk == 0:
        return _unpad(dk, D), _unpad(dv, D), dbias
    entry = f"mxt_flash_dkv_{tag}"
    rc = getattr(kernels.library(libname), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(bias), dk.data_ptr(),
        dv.data_ptr(), _ptr(dbias), B * H, H, Tq, Tk, Dp,
        int(bool(causal)), scale, kernels.stream_handle(q.device))
    kernels.check(rc, entry)
    kernels.count_launch(kernel_name("flash_bwd_dkv", q.dtype))
    _tally(B, H, Tq, Tk, D, causal, 4)
    return _unpad(dk, D), _unpad(dv, D), dbias


def flash_bwd_dq(q, k, v, bias, dout, lse, delta, causal, scale):
    """dQ kernel wrapper; arguments as :func:`flash_bwd_dkv`."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, bias, dout, lse, delta,
                                      causal, scale)
    B, H, Tq, Tk, D, bias, tag, libname = _check_cuda(q, k, v, bias, dout,
                                                      lse, delta)
    Dp = kernel_head_dim(D)
    q, k, v, dout = (_pad(t, Dp) for t in (q, k, v, dout))
    dq = torch.empty_like(q)
    if B * H * Tq == 0:
        return _unpad(dq, D)
    entry = f"mxt_flash_dq_{tag}"
    rc = getattr(kernels.library(libname), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(bias), dq.data_ptr(),
        B * H, H, Tq, Tk, Dp, int(bool(causal)), scale,
        kernels.stream_handle(q.device))
    kernels.check(rc, entry)
    kernels.count_launch(kernel_name("flash_bwd_dq", q.dtype))
    _tally(B, H, Tq, Tk, D, causal, 4)
    return _unpad(dq, D)


def flash_backward(q, k, v, bias, out, lse, dout, causal, scale,
                   want_dbias=True):
    """The backward through the two kernel wrappers: ``(dq, dk, dv,
    dbias)``, as :func:`flash_backward_reference`."""
    return _backward(flash_bwd_dkv, flash_bwd_dq, q, k, v, bias, out, lse,
                     dout, causal, scale, want_dbias)


class _FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` pair of the JAX package as one Function: the
    forward saves ``(q, k, v, bias, out, lse)``; the backward recomputes
    the probabilities from ``lse``. The bias gradient is computed only
    when autograd asks for it (BERT's padding mask needs none)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if bias is not None:
            bias = bias.contiguous()
        out, lse = flash_forward(q, k, v, bias, causal, scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = flash_backward(
            q, k, v, bias, out, lse, dout.contiguous(), ctx.causal,
            ctx.scale, want_dbias=ctx.needs_input_grad[3])
        return dq, dk, dv, dbias, None, None


def flash_attention(q, k, v, bias=None, causal=False, scale=None):
    """Flash attention entry point. q/k/v: (B, H, T, D); bias: (B, Tk)
    additive row (0 = keep, large-negative = drop). Differentiable in
    q, k, v and bias."""
    return _FlashAttention.apply(q, k, v, bias, bool(causal),
                                 _default_scale(q, scale))


@register("scaled_dot_product_attention")
@amp_cast("scaled_dot_product_attention")
def scaled_dot_product_attention(q, k, v, bias=None, *, causal=False,
                                 scale=None, flash=True):
    """The attention op: the flash kernels (their plain twins on the
    CPU), or with ``flash=False`` :func:`attention_reference`. Inputs
    (B, H, T, D); under AMP q, k, v and the bias run in the target
    dtype."""
    if not flash:
        return attention_reference(q, k, v, bias, causal, scale)
    return flash_attention(q, k, v, bias=bias, causal=causal, scale=scale)

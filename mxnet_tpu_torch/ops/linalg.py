"""Linear-algebra ops, the ``linalg_*`` family (the port of
``mxnet_tpu/ops/linalg.py``).

These are plain products and factorizations: the JAX package leaves them
to XLA, outside any Pallas kernel, so ``torch.matmul`` and
``torch.linalg`` compute them here. On the card each op runs with TF32
off (:func:`_f32_products`, restored after), so f32 keeps f32 accuracy
whatever the caller set. ``syevd`` returns ``(eigenvalues,
eigenvectors)`` as ``jnp.linalg.eigh`` does; an eigenvector's sign is
LAPACK's (cuSOLVER's on the card), so compare them up to sign.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from .registry import _REGISTRY, Operator, alias


@contextlib.contextmanager
def _f32_products(xs):
    if not any(isinstance(x, torch.Tensor) and x.is_cuda for x in xs):
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _reg(name, fn, nout=1, differentiable=True):
    @functools.wraps(fn)
    def impl(*xs, **kw):
        with _f32_products(xs):
            return fn(*xs, **kw)
    _REGISTRY[name] = Operator(name, impl, nout=nout,
                               differentiable=differentiable)
    if name.startswith("_linalg_"):
        alias(name[1:], name)


def _t(a):
    return torch.swapaxes(a, -1, -2)


def _gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0, axis=-2):
    if transpose_a:
        a = _t(a)
    if transpose_b:
        b = _t(b)
    return alpha * torch.matmul(a, b)


def _gemm(a, b, c, transpose_a=False, transpose_b=False, alpha=1.0,
          beta=1.0, axis=-2):
    return _gemm2(a, b, transpose_a, transpose_b, alpha) + beta * c


def _potri(a):
    # the input is the Cholesky factor L (the reference's potri contract)
    eye = torch.eye(a.shape[-1], dtype=a.dtype,
                    device=a.device).expand(a.shape)
    linv = torch.linalg.solve_triangular(a, eye, upper=False)
    return torch.matmul(_t(linv), linv)


def _trsm(a, b, transpose=False, rightside=False, lower=True, alpha=1.0):
    if transpose:
        a, lower = _t(a), not lower
    return torch.linalg.solve_triangular(a, alpha * b, upper=not lower,
                                         left=not rightside)


def _trmm(a, b, transpose=False, rightside=False, lower=True, alpha=1.0):
    tri = torch.tril(a) if lower else torch.triu(a)
    if transpose:
        tri = _t(tri)
    return alpha * (torch.matmul(b, tri) if rightside
                    else torch.matmul(tri, b))


def _syrk(a, transpose=False, alpha=1.0):
    return alpha * (torch.matmul(_t(a), a) if transpose
                    else torch.matmul(a, _t(a)))


def _syevd(a):
    w, v = torch.linalg.eigh(a)
    return w, v


def _gelqf(a):
    q, r = torch.linalg.qr(_t(a))
    return _t(r), _t(q)


def _makediag(a, offset=0):
    return torch.diag_embed(a, offset=offset)


def _khatri_rao(*mats):
    out = mats[0]
    for m in mats[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            out.shape[0] * m.shape[0], *out.shape[1:])
    return out


_reg("_linalg_gemm2", _gemm2)
_reg("_linalg_gemm", _gemm)
_reg("_linalg_potrf", lambda a: torch.linalg.cholesky(a))
_reg("_linalg_potri", _potri)
_reg("_linalg_trsm", _trsm)
_reg("_linalg_trmm", _trmm)
_reg("_linalg_syrk", _syrk)
_reg("_linalg_syevd", _syevd, nout=2)
_reg("_linalg_gelqf", _gelqf, nout=2)
_reg("_linalg_sumlogdiag", lambda a: torch.sum(
    torch.log(torch.diagonal(a, dim1=-2, dim2=-1)), dim=-1))
_reg("_linalg_extractdiag", lambda a, offset=0: torch.diagonal(
    a, offset=offset, dim1=-2, dim2=-1))
_reg("_linalg_makediag", _makediag)
_reg("_linalg_inverse", lambda a: torch.linalg.inv(a))
_reg("_linalg_det", lambda a: torch.linalg.det(a))
_reg("_linalg_slogdet", lambda a: tuple(torch.linalg.slogdet(a)), nout=2)
_reg("khatri_rao", _khatri_rao)

"""Numeric-testing harness of the port (mirrors ``mxnet_tpu/test_utils.py``).

Reference: python/mxnet/test_utils.py (assert_almost_equal :561,
check_numeric_gradient :987, check_symbolic_forward :1130,
check_consistency, rand_ndarray :388, default_context :57). The reference
checks symbolic executors' hand-written backward kernels against finite
differences; here every gradient comes from one AD engine (torch's
autograd under the port's tape), so the same harness pins the *framework
path* — registered op -> invoke chokepoint -> tape -> backward — against
central finite differences of the eager forward. "Consistency" is the
reference's: one op on the CPU and on the card (each dtype), and, in
:func:`check_eager_jit_consistency`, the op's impl called directly
against the same op through the ``nd`` chokepoint.
"""
from __future__ import annotations

import numpy as np

from . import ndarray as nd
from .ndarray import NDArray
from . import autograd


__all__ = ["default_context", "rand_ndarray", "assert_almost_equal",
           "numeric_grad", "check_numeric_gradient",
           "check_eager_jit_consistency", "check_consistency", "same",
           "almost_equal", "check_symbolic_forward",
           "check_symbolic_backward"]


def default_context():
    from .context import current_context
    return current_context()


def _to_np(a):
    if isinstance(a, NDArray):
        return a.asnumpy()
    return np.asarray(a)


def rand_ndarray(shape, dtype=np.float32, scale=1.0, rng=None):
    rng = rng or np.random
    return nd.array((rng.standard_normal(size=shape) * scale).astype(dtype))


def same(a, b):
    return np.array_equal(_to_np(a), _to_np(b))


def almost_equal(a, b, rtol=1e-5, atol=1e-20, equal_nan=False):
    return np.allclose(_to_np(a), _to_np(b), rtol=rtol, atol=atol,
                       equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20, names=("a", "b"),
                        equal_nan=False):
    """Same contract as the reference's assert_almost_equal
    (test_utils.py:561): elementwise closeness with named operands in the
    failure message."""
    a_np, b_np = _to_np(a), _to_np(b)
    if a_np.shape != b_np.shape:
        raise AssertionError(
            f"shape mismatch: {names[0]}{a_np.shape} vs "
            f"{names[1]}{b_np.shape}")
    if np.allclose(a_np, b_np, rtol=rtol, atol=atol, equal_nan=equal_nan):
        return
    err = np.abs(a_np - b_np)
    denom = np.maximum(np.abs(b_np), 1e-30)
    idx = np.unravel_index(np.argmax(err / (atol + rtol * denom)),
                           err.shape)
    raise AssertionError(
        f"{names[0]} and {names[1]} differ beyond rtol={rtol}, "
        f"atol={atol}: max violation at {tuple(int(i) for i in idx)}: "
        f"{a_np[idx]!r} vs {b_np[idx]!r} (|diff|={err[idx]:.3g})")


def numeric_grad(f, inputs, eps=1e-4):
    """Central finite differences of scalar-valued ``f`` over a list of
    numpy arrays (reference: test_utils.py numeric_grad inside
    check_numeric_gradient)."""
    grads = []
    for i, x in enumerate(inputs):
        g = np.zeros_like(x, dtype=np.float64)
        flat = x.reshape(-1)
        gflat = g.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            fp = f(*inputs)
            flat[j] = orig - eps
            fm = f(*inputs)
            flat[j] = orig
            gflat[j] = (fp - fm) / (2 * eps)
        grads.append(g.astype(x.dtype))
    return grads


def check_numeric_gradient(op_name, inputs, kwargs=None, rtol=1e-2,
                           atol=1e-3, eps=1e-3, rng=None,
                           grad_inputs=None):
    """Pin the autograd gradient of a registered op against central
    finite differences (reference: test_utils.py:987).

    op_name: name in the op registry (or a callable taking NDArrays).
    inputs: list of numpy float arrays (keep them small — numeric diff is
    O(size) forward evaluations).
    grad_inputs: indices of inputs to check (default: all).
    """
    kwargs = kwargs or {}
    rng = rng or np.random.RandomState(0)
    op = getattr(nd, op_name) if isinstance(op_name, str) else op_name
    inputs = [np.asarray(x, dtype=np.float64).astype(np.float32)
              for x in inputs]
    if grad_inputs is None:
        grad_inputs = range(len(inputs))

    # random fixed projection makes the output scalar without zeroing
    # any gradient component
    with autograd.pause():
        probe = op(*[nd.array(x) for x in inputs], **kwargs)
    proj = rng.standard_normal(size=probe.shape).astype(np.float32)

    def scalar_f(*xs):
        with autograd.pause():
            out = op(*[nd.array(x) for x in xs], **kwargs)
        return float((out * nd.array(proj)).sum().asnumpy())

    arrs = [nd.array(x) for x in inputs]
    for i in grad_inputs:
        arrs[i].attach_grad()
    with autograd.record():
        out = op(*arrs, **kwargs)
        loss = (out * nd.array(proj)).sum()
    loss.backward()

    expected = numeric_grad(scalar_f, [x.copy() for x in inputs], eps=eps)
    for i in grad_inputs:
        assert_almost_equal(
            arrs[i].grad, expected[i], rtol=rtol, atol=atol,
            names=(f"autograd_d{op_name if isinstance(op_name, str) else 'f'}"
                   f"/dx{i}", "numeric"))


def _symbol_location(sym, location):
    """Normalize the reference's location convention: a dict of
    name->array, or a positional list matching list_arguments()."""
    arg_names = sym.list_arguments()
    if isinstance(location, dict):
        unknown = set(location) - set(arg_names)
        if unknown:
            raise ValueError(f"location names {sorted(unknown)} are not "
                             f"arguments of the symbol {arg_names}")
        missing = set(arg_names) - set(location)
        if missing:
            raise ValueError(f"location is missing arrays for arguments "
                             f"{sorted(missing)}")
        loc = location
    else:
        if len(location) != len(arg_names):
            raise ValueError(
                f"expected {len(arg_names)} positional arrays for "
                f"{arg_names}, got {len(location)}")
        loc = dict(zip(arg_names, location))
    return {k: (v if isinstance(v, NDArray) else nd.array(np.asarray(v)))
            for k, v in loc.items()}


def check_symbolic_forward(sym, location, expected, rtol=1e-4, atol=1e-6,
                           aux_states=None, equal_nan=False):
    """Bind a symbol, run forward, compare each output against
    ``expected`` (reference: test_utils.py:1130 check_symbolic_forward).

    location: dict name->array or positional list; expected: list of
    numpy arrays (one per output). Returns the outputs as numpy.
    """
    loc = _symbol_location(sym, location)
    exe = sym.bind(args=loc, grad_req="null",
                   aux_states={k: nd.array(np.asarray(v))
                               for k, v in (aux_states or {}).items()})
    outputs = exe.forward(is_train=False)
    if len(outputs) != len(expected):
        raise AssertionError(
            f"symbol has {len(outputs)} outputs, expected list has "
            f"{len(expected)}")
    for i, (out, exp) in enumerate(zip(outputs, expected)):
        assert_almost_equal(out, exp, rtol=rtol, atol=atol,
                            names=(f"output[{i}]", f"expected[{i}]"),
                            equal_nan=equal_nan)
    return [o.asnumpy() for o in outputs]


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-4,
                            atol=1e-6, aux_states=None, grad_req="write",
                            equal_nan=False):
    """Bind a symbol, run forward+backward with ``out_grads``, compare
    each requested input gradient against ``expected`` (reference:
    test_utils.py:1187 check_symbolic_backward).

    expected: dict name->array (only those names are checked) or a
    positional list over list_arguments(). grad_req: str or dict; args
    with req "null" are skipped. Returns the gradients as a dict.
    """
    loc = _symbol_location(sym, location)
    arg_names = sym.list_arguments()
    if isinstance(expected, dict):
        unknown = set(expected) - set(arg_names)
        if unknown:
            raise ValueError(f"expected-grad names {sorted(unknown)} are "
                             f"not arguments of the symbol {arg_names}")
    else:
        if len(expected) != len(arg_names):
            raise ValueError(
                f"expected {len(arg_names)} positional grad arrays for "
                f"{arg_names}, got {len(expected)}")
        expected = dict(zip(arg_names, expected))
    if isinstance(grad_req, str):
        req_of = {n: grad_req for n in arg_names}
    else:
        req_of = {n: grad_req.get(n, "null") for n in arg_names}
    args_grad = {n: nd.zeros(loc[n].shape, ctx=loc[n].context)
                 for n in arg_names if req_of[n] != "null"}
    exe = sym.bind(args=loc, args_grad=args_grad, grad_req=req_of,
                   aux_states={k: nd.array(np.asarray(v))
                               for k, v in (aux_states or {}).items()})
    exe.forward(is_train=True)
    if out_grads is not None and not isinstance(out_grads, (list, tuple)):
        out_grads = [out_grads]
    if out_grads is not None:
        out_grads = [g if isinstance(g, NDArray) else nd.array(np.asarray(g))
                     for g in out_grads]
    exe.backward(out_grads)
    grads = {n: g.asnumpy() for n, g in exe.grad_dict.items()
             if req_of.get(n, "null") != "null"}
    for name, exp in expected.items():
        if req_of.get(name, "null") == "null":
            continue
        assert_almost_equal(grads[name], exp, rtol=rtol, atol=atol,
                            names=(f"grad[{name}]", f"expected[{name}]"),
                            equal_nan=equal_nan)
    return grads


def check_eager_jit_consistency(op_name, inputs, kwargs=None, rtol=1e-5,
                                atol=1e-6):
    """A registered op's impl called directly and the same op through the
    ``nd`` chokepoint must agree (the JAX package compares eager with
    jit-compiled execution; the port's ops run eagerly both ways)."""
    import torch
    from .ops.registry import _REGISTRY

    kwargs = kwargs or {}
    op = _REGISTRY[op_name]
    dev = default_context().torch_device
    xs = [torch.as_tensor(np.asarray(x)).to(dev) for x in inputs]
    with torch.no_grad():
        direct = op.impl(*xs, **kwargs)
        via = getattr(nd, op_name)(*xs, **kwargs)
    if not isinstance(direct, (tuple, list)):
        direct, via = [direct], [via]
    for d, v in zip(direct, via):
        assert_almost_equal(_to_np(v), d.detach().cpu().numpy(), rtol=rtol,
                            atol=atol, names=("nd", "impl"))


def check_consistency(op_name, inputs, kwargs=None, dtypes=None,
                      rtol=None, atol=None):
    """Run one op on every available context and dtype and compare the
    results pairwise (reference: test_utils.py:1460 check_consistency,
    which compared CPU vs GPU executors). Contexts: the CPU, plus the
    card when CUDA is available; dtypes default to (float64, float32).
    The highest-precision result is the reference; every other
    (ctx, dtype) result must match within its dtype tolerance.
    """
    import torch
    from .context import cpu, gpu, num_gpus
    from .ops.registry import get as get_op

    kwargs = kwargs or {}
    dtypes = dtypes or [np.float64, np.float32]
    tol = {np.dtype(np.float64): (1e-10, 1e-12),
           np.dtype(np.float32): (1e-4, 1e-5),
           np.dtype(np.float16): (1e-2, 1e-2)}
    if rtol is not None:
        tol = {k: (rtol, atol if atol is not None else 0.0) for k in tol}

    ctxs = [cpu()]
    if num_gpus() > 0:
        ctxs.append(gpu())
    op = get_op(op_name)

    results = {}
    for ctx in ctxs:
        for dt in dtypes:
            cast = [np.asarray(x).astype(dt)
                    if np.issubdtype(np.asarray(x).dtype, np.floating)
                    else np.asarray(x) for x in inputs]
            arrays = [torch.as_tensor(c).to(ctx.torch_device) for c in cast]
            with torch.no_grad():
                out = op.impl(*arrays, **kwargs)
            out0 = out[0] if isinstance(out, (tuple, list)) else out
            results[(str(ctx), np.dtype(dt))] = \
                out0.detach().cpu().double().numpy()

    ref_key = min(results, key=lambda k: np.dtype(k[1]).itemsize * -1)
    ref = results[ref_key]
    for key, val in results.items():
        if key == ref_key:
            continue
        r, a = tol[np.dtype(key[1])]
        assert_almost_equal(val, ref, rtol=r, atol=a,
                            names=(str(key), str(ref_key)))
    return results

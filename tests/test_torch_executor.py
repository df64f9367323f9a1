"""PyTorch port, the executor (``mxnet_tpu_torch/executor.py``,
``Symbol.bind`` / ``simple_bind``) and ``test_utils`` against the JAX
package's ``Executor`` on the same numpy inputs:

- an MLP with ``SoftmaxOutput``: outputs, and ``backward()`` with no head
  gradient (``(softmax - onehot) * grad_scale`` whatever the head);
- a conv-BN-ReLU net: outputs, gradients and the BatchNorm running
  statistics after a training forward (the momentum blend), then the
  inference forward on them;
- ``grad_req`` ``add`` and ``null``, two ``backward()`` after one forward,
  ``reshape``, ``copy_params_from``, the monitor callback, ``output_dict``
  and the array views;
- the loss heads ``LinearRegressionOutput``, ``LogisticRegressionOutput``,
  ``MAERegressionOutput``, ``SVMOutput`` and ``MakeLoss``;
- ``Dropout``: the backward applies the forward's mask;
- ``scaled_dot_product_attention`` as a symbol, its flash path (the plain
  twins on the CPU) and ``flash=False``;
- the cases of ``tests/test_check_symbolic.py`` and
  ``tests/test_ops_symbolic_oracles.py`` run through the port's
  ``test_utils`` (the JAX suite's own files, their imports turned to the
  port's).

Tolerances (f32): rtol 1e-5, atol 1e-6, except 1e-4 / 1e-5 for the
convolution net (sums over more than 1k terms) and the BatchNorm
variance.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _symbol_tests():
    spec = importlib.util.spec_from_file_location(
        "_torch_symbol_cases", os.path.join(HERE, "test_torch_symbol.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SYM = _symbol_tests()
CHECK_CASES = SYM.load_reference_tests("test_check_symbolic")
ORACLE_CASES = SYM.load_reference_tests("test_ops_symbolic_oracles")


def _np(a):
    return None if a is None else a.asnumpy()


def bind_pair(build, shapes, seed=0, grad_req="write", fix=None):
    """The same graph bound in both packages (the port's on the CPU) to
    the same seeded arrays; ``fix`` maps a name to a function of its
    shape giving its array."""
    SYM.reset_names()
    jsym = build(jmx)
    SYM.reset_names()
    tsym = build(tmx)
    arg_shapes, _, aux_shapes = jsym.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    args = {n: rs.randn(*s).astype(np.float32)
            for n, s in zip(jsym.list_arguments(), arg_shapes)}
    aux = {n: (np.abs(rs.randn(*s)) + 0.5).astype(np.float32)
           for n, s in zip(jsym.list_auxiliary_states(), aux_shapes)}
    for n, f in (fix or {}).items():
        (args if n in args else aux)[n] = f(
            (args if n in args else aux)[n].shape)
    jex = jsym.bind(args={k: jmx.nd.array(v) for k, v in args.items()},
                    args_grad={k: jmx.nd.zeros(v.shape)
                               for k, v in args.items()},
                    grad_req=grad_req,
                    aux_states={k: jmx.nd.array(v) for k, v in aux.items()})
    with tmx.cpu():
        tex = tsym.bind(
            ctx=tmx.cpu(), args={k: tmx.nd.array(v) for k, v in args.items()},
            args_grad={k: tmx.nd.zeros(v.shape) for k, v in args.items()},
            grad_req=grad_req,
            aux_states={k: tmx.nd.array(v) for k, v in aux.items()})
    return jex, tex


def close(got, want, rtol=RTOL, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=atol)


def grads_close(jex, tex, rtol=RTOL, atol=ATOL):
    assert sorted(tex.grad_dict) == sorted(jex.grad_dict)
    for n in jex.grad_dict:
        np.testing.assert_allclose(_np(tex.grad_dict[n]),
                                   _np(jex.grad_dict[n]), rtol=rtol,
                                   atol=atol, err_msg=n)


def labels(n):
    return lambda shape: (np.arange(int(np.prod(shape))) % n).reshape(
        shape).astype(np.float32)


# ---------------------------------------------------------------- graphs ---
def test_mlp_softmax_output_matches_the_reference():
    jex, tex = bind_pair(SYM.mlp, {"data": (6, 10), "softmax_label": (6,)},
                         fix={"softmax_label": labels(4)})
    close(tex.forward(is_train=True), jex.forward(is_train=True))
    jex.backward()
    tex.backward()
    grads_close(jex, tex)
    # the head gradient does not enter SoftmaxOutput's
    tex.backward(out_grads=tmx.nd.array(np.full((6, 4), 7.0, np.float32),
                                        ctx="cpu"))
    grads_close(jex, tex)
    # fc2's bias gradient is the head's (softmax - onehot), summed
    p = tex.outputs[0].asnumpy()
    onehot = np.eye(4, dtype=np.float32)[np.arange(6) % 4]
    np.testing.assert_allclose(tex.grad_dict["fc2_bias"].asnumpy(),
                               (p - onehot).sum(0), rtol=RTOL, atol=ATOL)


def test_conv_bn_aux_updates_match_the_reference():
    jex, tex = bind_pair(SYM.conv_bn, {"data": (2, 3, 8, 8)}, seed=1)
    close(tex.forward(is_train=True), jex.forward(is_train=True),
          1e-4, 1e-5)
    for n in jex.aux_dict:
        np.testing.assert_allclose(tex.aux_dict[n].asnumpy(),
                                   jex.aux_dict[n].asnumpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    assert not np.allclose(tex.aux_dict["bn1_moving_var"].asnumpy(),
                           tex.arg_dict["bn1_gamma"].asnumpy() * 0 + 1)
    jex.backward()
    tex.backward()
    grads_close(jex, tex, 1e-4, 1e-5)
    close(tex.forward(is_train=False), jex.forward(is_train=False),
          1e-4, 1e-5)


def test_grad_req_add_null_and_two_backwards():
    req = {"data": "null", "fc1_weight": "add", "fc1_bias": "write",
           "fc2_weight": "add", "fc2_bias": "null",
           "softmax_label": "null"}
    jex, tex = bind_pair(SYM.mlp, {"data": (4, 10), "softmax_label": (4,)},
                         seed=2, grad_req=req,
                         fix={"softmax_label": labels(4)})
    for ex in (jex, tex):
        ex.forward(is_train=True)
        ex.backward()
        ex.backward()
    grads_close(jex, tex)
    once = tex.grad_dict["fc1_bias"].asnumpy()
    twice = tex.grad_dict["fc1_weight"].asnumpy()
    tex2 = bind_pair(SYM.mlp, {"data": (4, 10), "softmax_label": (4,)},
                     seed=2, fix={"softmax_label": labels(4)})[1]
    tex2.forward(is_train=True)
    tex2.backward()
    np.testing.assert_allclose(once, tex2.grad_dict["fc1_bias"].asnumpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(twice,
                               2 * tex2.grad_dict["fc1_weight"].asnumpy(),
                               rtol=RTOL, atol=ATOL)
    assert not tex.grad_dict["fc2_bias"].asnumpy().any()


def test_reshape_copy_params_monitor_and_views():
    jex, tex = bind_pair(SYM.mlp, {"data": (4, 10), "softmax_label": (4,)},
                         seed=3, fix={"softmax_label": labels(4)})
    seen = {"j": [], "t": []}
    jex.set_monitor_callback(lambda n, a: seen["j"].append(
        (n, a.asnumpy())))
    tex.set_monitor_callback(lambda n, a: seen["t"].append(
        (n, a.asnumpy())))
    jr = jex.reshape(data=(7, 10), softmax_label=(7,))
    tr = tex.reshape(data=(7, 10), softmax_label=(7,))
    x = np.random.RandomState(4).randn(7, 10).astype(np.float32)
    y = labels(4)((7,))
    close(tr.forward(is_train=False, data=x, softmax_label=y),
          jr.forward(is_train=False, data=jmx.nd.array(x),
                     softmax_label=jmx.nd.array(y)))
    new = {n: np.full(v.shape, 0.01, np.float32)
           for n, v in jex.arg_dict.items() if n.startswith("fc")}
    jex.copy_params_from({k: jmx.nd.array(v) for k, v in new.items()})
    tex.copy_params_from({k: tmx.nd.array(v, ctx="cpu")
                          for k, v in new.items()})
    with pytest.raises(ValueError, match="not in the arguments"):
        tex.copy_params_from({"nope": tmx.nd.zeros((1,), ctx="cpu")})
    tex.copy_params_from({"nope": tmx.nd.zeros((1,), ctx="cpu")},
                         allow_extra_params=True)
    close(tex.forward(), jex.forward())
    assert [n for n, _ in seen["t"]] == [n for n, _ in seen["j"]] == \
        ["softmax_output"]
    np.testing.assert_allclose(seen["t"][0][1], seen["j"][0][1],
                               rtol=RTOL, atol=ATOL)
    assert list(tex.output_dict) == list(jex.output_dict)
    assert [a.shape for a in tex.arg_arrays] == \
        [a.shape for a in jex.arg_arrays]
    assert [a is tex.arg_dict[n] for a, n in zip(
        tex.arg_arrays, tex.arg_names)] == [True] * len(tex.arg_names)
    assert len(tex.grad_arrays) == len(jex.grad_arrays)
    assert tex.aux_arrays == [] == jex.aux_arrays
    with pytest.raises(tmx.MXNetError):
        bind_pair(SYM.mlp, {"data": (4, 10), "softmax_label": (4,)})[1] \
            .backward()


# ------------------------------------------------------------ loss heads ---
def _head(op, **kw):
    def build(mx):
        d = mx.sym.var("data")
        h = mx.sym.FullyConnected(d, num_hidden=3, name="fc")
        if op == "MakeLoss":
            return mx.sym.MakeLoss(mx.sym.square(h), name="loss", **kw)
        return getattr(mx.sym, op)(h, mx.sym.var("out_label"), name="out",
                                   **kw)
    return build


HEADS = {
    "LinearRegressionOutput": ({}, None),
    "LogisticRegressionOutput": ({}, "binary"),
    "MAERegressionOutput": ({"grad_scale": 0.5}, None),
    "SVMOutput": ({"margin": 1.0}, "class"),
    "SVMOutput_l1": ({"use_linear": True}, "class"),
    "MakeLoss": ({}, None),
}


@pytest.mark.parametrize("name", sorted(HEADS))
def test_loss_heads_backward_matches_the_reference(name):
    kw, lab = HEADS[name]
    op = name.split("_")[0]
    shapes = {"data": (5, 4)}
    if op != "MakeLoss":
        shapes["out_label"] = (5,) if lab == "class" else (5, 3)
    fix = {}
    if lab == "class":
        fix["out_label"] = labels(3)
    elif lab == "binary":
        fix["out_label"] = lambda s: (np.arange(np.prod(s)) % 2).reshape(
            s).astype(np.float32)
    jex, tex = bind_pair(_head(op, **kw), shapes, seed=5, fix=fix)
    close(tex.forward(is_train=True), jex.forward(is_train=True))
    jex.backward()
    tex.backward()
    grads_close(jex, tex)


def test_dropout_backward_takes_the_forward_mask():
    def build(mx):
        return mx.sym.Dropout(mx.sym.var("x"), p=0.5, name="drop")
    x = np.random.RandomState(6).rand(64, 32).astype(np.float32) + 0.5
    with tmx.cpu():
        ex = build(tmx).simple_bind(ctx=tmx.cpu(), x=(64, 32))
        out = ex.forward(is_train=True, x=x)[0].asnumpy()
        ex.backward()
        g = ex.grad_dict["x"].asnumpy()
        ex.backward()
        np.testing.assert_array_equal(ex.grad_dict["x"].asnumpy(), g)
    kept = out != 0
    assert 0.35 < kept.mean() < 0.65
    np.testing.assert_allclose(out[kept], 2 * x[kept], rtol=RTOL)
    np.testing.assert_array_equal(g, 2.0 * kept)
    np.testing.assert_array_equal(ex.forward(is_train=False, x=x)[0]
                                  .asnumpy(), x)


@pytest.mark.parametrize("flash", [True, False])
def test_attention_symbol_matches_the_reference(flash):
    def build(mx):
        q, k, v, b = (mx.sym.var(n) for n in ("q", "k", "v", "bias"))
        return mx.sym.scaled_dot_product_attention(
            q, k, v, b, name="att",
            flash=flash if mx is tmx else False)
    shapes = {n: (2, 2, 16, 8) for n in "qkv"}
    shapes["bias"] = (2, 16)
    mask = np.zeros((2, 16), np.float32)
    mask[1, 11:] = -1e30
    jex, tex = bind_pair(build, shapes, seed=7, fix={"bias": lambda s: mask})
    close(tex.forward(is_train=True), jex.forward(is_train=True))
    og = np.random.RandomState(8).randn(2, 2, 16, 8).astype(np.float32)
    jex.backward(jmx.nd.array(og))
    tex.backward(tmx.nd.array(og, ctx="cpu"))
    for n in "qkv":
        np.testing.assert_allclose(tex.grad_dict[n].asnumpy(),
                                   jex.grad_dict[n].asnumpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=n)


# ----------------------------------------------------- reference cases ---
@pytest.mark.parametrize("case", list(CHECK_CASES))
def test_check_symbolic_case_through_the_port(case, tmp_path):
    SYM.run_reference_test(CHECK_CASES[case], tmp_path)


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_symbolic_oracle_case_through_the_port(case, tmp_path):
    SYM.run_reference_test(ORACLE_CASES[case], tmp_path)

"""PyTorch port, gluon's layers and Block members against the JAX
package's: every layer class of ``conv_layers.py``, ``activations.py``
and ``basic_layers.py`` (both layouts where it has two) on the same
weights and inputs, forward in training mode and the gradients of the
input and of every parameter; BatchNorm's running statistics after
three training steps, and ``use_global_stats``; ``save_parameters`` /
``load_parameters`` across the two packages, ``ParameterDict.save`` /
``load``, ``cast``, ``apply``, ``zero_grad``, the forward hooks and
``summary``'s rows.

Tolerance: ``LAYER_TOL = 1e-5`` of each result's magnitude (f32 sums of
a convolution or a normalisation in oneDNN's or torch's order against
XLA's).
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.convert import load_gluon_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

torch.set_num_threads(2)

LAYER_TOL = 1e-5

# (class, args, kwargs, input shape)
LAYERS = [
    ("Conv1D", (4, 3), dict(padding=1), (2, 3, 9)),
    ("Conv1D", (4, 3), dict(strides=2, layout="NWC"), (2, 9, 3)),
    ("Conv2D", (4, 3), dict(strides=2, padding=1), (2, 6, 9, 9)),
    ("Conv2D", (4, 3), dict(padding=1, layout="NHWC", activation="relu"),
     (2, 9, 9, 6)),
    ("Conv2D", (6, 3), dict(groups=3, dilation=2, use_bias=False),
     (2, 6, 9, 9)),
    ("Conv3D", (4, 3), dict(padding=1), (2, 3, 5, 6, 7)),
    ("Conv3D", (4, 2), dict(layout="NDHWC"), (2, 5, 6, 7, 3)),
    ("Conv1DTranspose", (4, 3), dict(strides=2, output_padding=1),
     (2, 3, 7)),
    ("Conv2DTranspose", (4, 3), dict(strides=2, padding=1,
                                     output_padding=1), (2, 3, 7, 7)),
    ("Conv2DTranspose", (4, 3), dict(strides=2, layout="NHWC"),
     (2, 7, 7, 3)),
    ("Conv3DTranspose", (2, 3), dict(strides=2), (1, 3, 4, 5, 5)),
    ("MaxPool1D", (), dict(pool_size=3, strides=2), (2, 3, 10)),
    ("MaxPool2D", (3, 2), dict(ceil_mode=True), (2, 3, 10, 10)),
    ("MaxPool2D", (3, 2, 1), dict(layout="NHWC"), (2, 9, 9, 3)),
    ("MaxPool3D", (), dict(), (2, 3, 4, 6, 6)),
    ("AvgPool1D", (3,), dict(padding=1, count_include_pad=False),
     (2, 3, 8)),
    ("AvgPool2D", (3, 2, 1), dict(count_include_pad=False), (2, 3, 9, 9)),
    ("AvgPool2D", (2,), dict(layout="NHWC", ceil_mode=True), (2, 7, 7, 3)),
    ("AvgPool3D", (), dict(), (2, 3, 4, 4, 4)),
    ("GlobalMaxPool1D", (), dict(), (2, 3, 7)),
    ("GlobalMaxPool2D", (), dict(layout="NHWC"), (2, 5, 5, 3)),
    ("GlobalMaxPool3D", (), dict(), (2, 3, 4, 4, 4)),
    ("GlobalAvgPool1D", (), dict(), (2, 3, 7)),
    ("GlobalAvgPool2D", (), dict(), (2, 3, 5, 5)),
    ("GlobalAvgPool3D", (), dict(layout="NDHWC"), (2, 4, 4, 4, 3)),
    ("ReflectionPad2D", (2,), dict(), (2, 3, 5, 5)),
    ("LeakyReLU", (0.1,), dict(), (2, 3, 4)),
    ("PReLU", (), dict(in_channels=3), (2, 3, 4)),
    ("ELU", (), dict(alpha=0.7), (2, 3, 4)),
    ("SELU", (), dict(), (2, 3, 4)),
    ("Swish", (), dict(beta=1.5), (2, 3, 4)),
    ("GELU", (), dict(), (2, 3, 4)),
    ("BatchNorm", (), dict(), (4, 3, 5, 5)),
    ("BatchNorm", (), dict(axis=3, scale=False, center=False),
     (4, 5, 5, 3)),
    ("InstanceNorm", (), dict(scale=True), (2, 3, 5, 5)),
    ("InstanceNorm", (), dict(axis=2), (2, 5, 3, 4)),
    ("GroupNorm", (), dict(num_groups=2), (2, 4, 5, 5)),
    ("LayerNorm", (), dict(), (2, 3, 6)),
    ("Dense", (5,), dict(activation="tanh"), (2, 3, 4)),
    ("Dense", (5,), dict(flatten=False, use_bias=False), (2, 3, 4)),
    ("Flatten", (), dict(), (2, 3, 4)),
    ("Identity", (), dict(), (2, 3)),
    ("Activation", ("relu",), dict(), (2, 3, 4)),
    ("Dropout", (0.0,), dict(), (2, 3)),
    ("Lambda", ("tanh",), dict(), (2, 3)),
    ("HybridLambda", ("tanh",), dict(), (2, 3)),
]


def _rel_close(got, want, what):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max() if want.size \
        else 0.0
    assert err <= LAYER_TOL * max(np.abs(want).max(), 1.0), (what, err)


def _pair(cls, args, kw, shape, prefix="l_"):
    """The JAX layer and the port's, on the JAX layer's weights (its
    deferred shapes resolved by one forward)."""
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    j = getattr(jnn, cls)(*args, prefix=prefix, **kw)
    t = getattr(tnn, cls)(*args, prefix=prefix, **kw)
    if cls in ("Lambda",):
        return j, t, x
    j.initialize(jmx.initializer.Xavier())
    t.initialize(device="cpu")
    with jag.pause():
        j(jmx.nd.array(x))
    with tag.pause():
        t(torch.from_numpy(x))
    rs = np.random.RandomState(7)
    arrays = {}
    for name, p in j.collect_params().items():
        a = p.data().asnumpy()
        if name.endswith(("gamma", "running_var")):
            a = rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif name.endswith(("beta", "running_mean", "bias")):
            a = rs.uniform(-0.3, 0.3, a.shape).astype(np.float32)
        p.set_data(jmx.nd.array(a))
        arrays[name] = a
    load_gluon_params(t, arrays)
    return j, t, x


@pytest.mark.parametrize("case", range(len(LAYERS)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LAYERS)])
def test_layer_matches_jax(case):
    cls, args, kw, shape = LAYERS[case]
    j, t, x = _pair(cls, args, kw, shape)
    jx = jmx.nd.array(x)
    jx.attach_grad()
    with jag.record():
        jy = j(jx)
    head = np.random.RandomState(3).randn(*jy.shape).astype(np.float32)
    jy.backward(jmx.nd.array(head))
    tx = torch.from_numpy(x.copy()).requires_grad_()
    with tag.record():
        ty = t(tx)
    ty.backward(torch.from_numpy(head))
    _rel_close(ty.detach().numpy(), jy.asnumpy(), f"{cls} output")
    _rel_close(tx.grad.numpy(), jx.grad.asnumpy(), f"{cls} input grad")
    tparams = t.collect_params()
    for name, p in j.collect_params().items():
        q = tparams[name]
        _rel_close(q.data().detach().numpy(), p.data().asnumpy(), name)
        if p.grad_req != "null":
            _rel_close(q.grad().numpy(), p.grad().asnumpy(),
                       f"{name} grad")
    assert repr(t) == repr(j)


@pytest.mark.parametrize("kw,shape", [({}, (4, 3, 5, 5)),
                                      (dict(axis=3), (4, 5, 5, 3))])
def test_batchnorm_running_statistics_and_global_stats(kw, shape):
    """Three training forwards move the running statistics as the
    reference's (momentum on the batch mean and biased variance); then a
    ``use_global_stats`` layer normalises by them in training mode."""
    j, t, x = _pair("BatchNorm", (), dict(momentum=0.8, **kw), shape,
                    prefix="bn_")
    rs = np.random.RandomState(11)
    for _ in range(3):
        xs = (rs.randn(*shape) * 2 + 1).astype(np.float32)
        with jag.record():
            j(jmx.nd.array(xs))
        with tag.record():
            t(torch.from_numpy(xs))
    for name in ("bn_running_mean", "bn_running_var"):
        _rel_close(t.collect_params()[name].data().numpy(),
                   j.collect_params()[name].data().asnumpy(), name)
    g = {}
    for mod, pkg in ((jnn, "j"), (tnn, "t")):
        g[pkg] = mod.BatchNorm(use_global_stats=True, prefix="bng_", **kw)
    arrays = {k.replace("bn_", "bng_"): v.data().asnumpy()
              for k, v in j.collect_params().items()}
    g["j"].initialize()
    g["t"].initialize(device="cpu")
    with jag.pause():
        g["j"](jmx.nd.array(x))
    with tag.pause():
        g["t"](torch.from_numpy(x))
    for k, v in g["j"].collect_params().items():
        v.set_data(jmx.nd.array(arrays[k]))
    load_gluon_params(g["t"], arrays)
    with jag.record():
        want = g["j"](jmx.nd.array(x)).asnumpy()
    with tag.record():
        got = g["t"](torch.from_numpy(x)).detach().numpy()
    _rel_close(got, want, "use_global_stats")


def test_sequential_family_matches_jax():
    """``Sequential`` / ``HybridSequential`` (len, iteration, slicing),
    ``Concatenate`` / ``HybridConcatenate`` over the same children."""
    def build(nn, pkg):
        seq = nn.HybridSequential(prefix="s_")
        with seq.name_scope():
            cat = nn.HybridConcatenate(axis=1)
            with cat.name_scope():
                cat.add(nn.Dense(3), nn.Dense(2, activation="relu"))
            plain = nn.Concatenate(axis=1)
            with plain.name_scope():
                plain.add(nn.Identity(), nn.Dense(4))
            seq.add(nn.Dense(6), cat, plain)
        outer = nn.Sequential(prefix="o_")
        outer.add(seq, nn.Dense(3, prefix="head_"))
        return outer
    j, t = build(jnn, "j"), build(tnn, "t")
    x = np.random.RandomState(0).randn(2, 5).astype(np.float32)
    j.initialize(jmx.initializer.Xavier())
    t.initialize(device="cpu")
    with jag.pause():
        j(jmx.nd.array(x))
    with tag.pause():
        t(torch.from_numpy(x))
    arrays = {k: v.data().asnumpy() for k, v in j.collect_params().items()}
    for k, v in t.collect_params().items():
        v.set_data(torch.tensor(arrays[k]))
    with tag.pause():
        _rel_close(t(torch.from_numpy(x)).numpy(),
                   j(jmx.nd.array(x)).asnumpy(), "sequential")
    assert list(t.collect_params()) == list(j.collect_params())
    assert len(t) == len(j) == 2 and len(t[0]) == 3
    assert [type(b).__name__ for b in t] == [type(b).__name__ for b in j]
    sl = t[0][1:]
    assert type(sl) is tnn.HybridSequential and len(sl) == 2
    assert sl.prefix == j[0][1:].prefix


# ----------------------------------------------------------- Block members
def _resnets(prefix):
    j = jvision.resnet18_v1(thumbnail=True, classes=10, prefix=prefix)
    t = tvision.resnet18_v1(thumbnail=True, classes=10, prefix=prefix)
    return j, t


def test_parameter_files_load_across_the_two_packages(tmp_path):
    """A JAX ``save_parameters`` file loads into the port's ResNet (never
    initialized: shapes from the file) and a port file into the JAX
    package's, each giving the other's logits; keys are structural
    (``features.0.weight``) on both sides."""
    x = np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32)
    j, _ = _resnets("a_")
    j.initialize(jmx.initializer.Xavier())
    with jag.pause():
        want = j(jmx.nd.array(x)).asnumpy()
    path = str(tmp_path / "jax.params")
    j.save_parameters(path)
    _, t = _resnets("b_")
    t.load_parameters(path, ctx="cpu")
    assert list(t._collect_params_with_prefix()) == \
        list(j._collect_params_with_prefix())
    with tag.pause():
        _rel_close(t(torch.from_numpy(x)).numpy(), want, "jax -> port")
    # and back: the port's file into a fresh JAX net
    for p in t.collect_params().values():
        with torch.no_grad():
            p.data().mul_(0.9)
    with tag.pause():
        want = t(torch.from_numpy(x)).numpy()
    path2 = str(tmp_path / "port.params")
    t.save_parameters(path2)
    j2, _ = _resnets("c_")
    j2.load_parameters(path2)
    with jag.pause():
        _rel_close(j2(jmx.nd.array(x)).asnumpy(), want, "port -> jax")
    # missing / extra names
    small = tnn.Dense(3, in_units=2, prefix="d_")
    with pytest.raises(AssertionError, match="missing"):
        small.load_parameters(path2, ctx="cpu")
    with pytest.raises(ValueError, match="not present"):
        small.load_parameters(path2, ctx="cpu", allow_missing=True)
    small.load_parameters(path2, ctx="cpu", ignore_extra=True,
                          allow_missing=True)


def test_parameter_dict_save_and_load_across_packages(tmp_path):
    j, t = _resnets("pd_")
    j.initialize(jmx.initializer.Xavier())
    x = np.ones((1, 3, 32, 32), np.float32)
    with jag.pause():
        j(jmx.nd.array(x))
    path = str(tmp_path / "pd.params")
    j.collect_params().save(path, strip_prefix="pd_")
    t.collect_params().load(path, ctx="cpu", restore_prefix="pd_")
    for k, p in j.collect_params().items():
        np.testing.assert_array_equal(
            t.collect_params()[k].data().detach().numpy(),
            p.data().asnumpy())
    # the legacy branch of load_parameters: full-prefix names
    _, t2 = _resnets("pd_")
    t2.load_parameters(path, ctx="cpu")
    path2 = str(tmp_path / "pd2.params")
    t2.collect_params().save(path2)
    j2, _ = _resnets("pd_")
    j2.collect_params().load(path2)
    with jag.pause():
        a = j2(jmx.nd.array(x)).asnumpy()
    with tag.pause():
        b = t2(torch.from_numpy(x)).numpy()
    _rel_close(b, a, "ParameterDict round trip")
    assert "Parameter pd_conv2d0_weight" in repr(t2.collect_params())


def test_cast_apply_zero_grad_hooks_and_summary(capsys):
    j, t = _resnets("m_")
    x = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    j.initialize(jmx.initializer.Xavier())
    t.initialize(device="cpu")
    with jag.pause():
        j(jmx.nd.array(x))
    with tag.pause():
        t(torch.from_numpy(x))
    # apply: children first, then the block
    seen = {"j": [], "t": []}
    j.apply(lambda b: seen["j"].append(b.name))
    assert t.apply(lambda b: seen["t"].append(b.name)) is t
    assert seen["t"] == seen["j"]
    # hooks: pre-hook (block, inputs), hook (block, inputs, output)
    calls = []
    pre = t.features.register_forward_pre_hook(
        lambda b, a: calls.append(("pre", b.name, tuple(a[0].shape))))
    post = t.output.register_forward_hook(
        lambda b, a, out: calls.append(("post", b.name, tuple(out.shape))))
    with tag.pause():
        t(torch.from_numpy(x))
    assert calls == [("pre", t.features.name, (2, 3, 32, 32)),
                     ("post", t.output.name, (2, 10))]
    pre.detach()
    post.detach()
    with tag.pause():
        t(torch.from_numpy(x))
    assert len(calls) == 2
    # zero_grad: every gradient zero, in place
    with tag.record():
        t(torch.from_numpy(x)).sum().backward()
    w = t.features[0].weight
    g = w.grad()
    assert float(g.abs().sum()) > 0
    t.zero_grad()
    assert w.grad() is g and float(g.abs().sum()) == 0
    # summary: the reference's rows
    j.summary(jmx.nd.array(x))
    want = capsys.readouterr().out
    t.summary(torch.from_numpy(x))
    got = capsys.readouterr().out
    assert got == want
    # cast: 16-bit keeps BatchNorm's parameters f32, as the reference
    j.cast("bfloat16")
    t.cast("bfloat16")
    jd = {k: str(v.data().dtype) for k, v in j.collect_params().items()}
    td = {k: str(v.data().dtype).replace("torch.", "")
          for k, v in t.collect_params().items()}
    assert td == jd
    assert t.features[0].weight.dtype == "bfloat16"
    assert t.features[0].weight.list_ctx() == [torch.device("cpu")]
    assert t.name == "m" and "BasicBlockV1" in repr(t)


def test_parameter_members():
    from mxnet_tpu_torch.gluon import Constant, Parameter, ParameterDict
    p = Parameter("p_weight", shape=(2, 3))
    p.initialize(device="cpu")
    assert p.list_data()[0] is p.data() and p.list_ctx() == [
        torch.device("cpu")]
    p.grad().fill_(1.0)
    p.zero_grad()
    assert float(p.list_grad()[0].abs().sum()) == 0
    with pytest.raises(NotImplementedError, match="item 14"):
        p.var()
    # a default-stype parameter has no row-sparse view (the reference's
    # RuntimeError; tests/test_torch_sparse.py holds the row-sparse one)
    with pytest.raises(RuntimeError, match="requires stype='row_sparse'"):
        p.row_sparse_data(torch.tensor([0]))
    c = Constant("c_const", np.arange(6, dtype=np.float32).reshape(2, 3))
    c.initialize(device="cpu")
    assert c.grad_req == "null" and torch.equal(
        c.data(), torch.arange(6.0).reshape(2, 3))
    d = ParameterDict("x_")
    d.get("w", shape=(2,))
    d.get_constant("k", [1.0, 2.0])
    d.initialize(device="cpu")
    d.setattr("lr_mult", 0.5)
    assert all(v.lr_mult == 0.5 for v in d.values())
    assert d.list_ctx() == [torch.device("cpu")]
    shared = ParameterDict("y_", shared=d)
    assert shared.get("w") is not d["x_w"]
    dense = tnn.Dense(2, in_units=3, prefix="sh_")
    twin = tnn.Dense(2, in_units=3, prefix="sh_", params=dense.params)
    assert twin.weight is dense.weight
    with pytest.raises(AssertionError, match="does not match"):
        d.get("w", dtype="float16")


def test_lazy_package_names_reach_the_new_modules():
    assert tmx.gluon.nn.Conv2D is tnn.Conv2D
    assert tmx.gluon.model_zoo.get_model("alexnet", classes=3,
                                         prefix="lz_") is not None
    assert os.path.basename(tmx.gluon.model_zoo.vision.__file__) == \
        "__init__.py"

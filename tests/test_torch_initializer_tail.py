"""PyTorch port, the initializer tail (``mxnet_tpu_torch/initializer.py``:
``InitDesc``, ``Orthogonal``, ``MSRAPrelu``, ``Bilinear``, ``LSTMBias``,
``FusedRNN``, ``Mixed``, ``Load``, the ``dumps``/``create`` round trip)
against the JAX package's on the CPU.

The drawing initializers (Orthogonal, MSRAPrelu) draw from torch's
generator, not the JAX package's stream: both packages' draws are held
to the reference's properties (tests/test_optimizer.py:154-175): finite,
orthonormal rows or columns to 1e-5, a gaussian's mean and standard
deviation within 4 standard errors. The others compute their values:
held equal to the reference's, exactly (Bilinear: the same float64
arithmetic rounded to f32 once).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.initializer as jinit
import mxnet_tpu_torch.initializer as tinit

torch.set_num_threads(2)


def _both(name_or_init, jname_or_init, name, shape, seed=0):
    """(port's values, reference's values) of one call each, both
    seeded with ``seed``."""
    mx.random.seed(seed)
    t = torch.zeros(shape, dtype=torch.float32)
    tinit.create(name_or_init)(name, t, torch.Generator().manual_seed(seed))
    a = np.zeros(shape, np.float32)
    # the reference's create() takes names and Initializers (not Load)
    (jinit.create(jname_or_init) if isinstance(jname_or_init, str)
     else jname_or_init)(name, a)
    return t.numpy(), a


@pytest.mark.parametrize("shape", [(16, 16), (8, 24), (24, 3, 2, 2)])
@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_is_orthonormal(shape, rand_type):
    got, want = _both(tinit.Orthogonal(scale=1.0, rand_type=rand_type),
                      jinit.Orthogonal(scale=1.0, rand_type=rand_type),
                      "q_weight", shape)
    for m in (got, want):
        assert np.all(np.isfinite(m))
        m = m.reshape(shape[0], -1)
        gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        np.testing.assert_allclose(gram, np.eye(gram.shape[0]), atol=1e-5)
    scaled, _ = _both(tinit.Orthogonal(scale=2.0), "zeros", "q_weight",
                      (4, 4))
    np.testing.assert_allclose(scaled @ scaled.T, 4 * np.eye(4), atol=1e-5)


def test_msraprelu_draws_he_gaussian():
    shape = (256, 128)
    slope = 0.25
    got, want = _both(tinit.MSRAPrelu(slope=slope), jinit.MSRAPrelu(
        slope=slope), "fc_weight", shape)
    std = np.sqrt(2.0 / (1 + slope ** 2) / ((shape[0] + shape[1]) / 2.0))
    n = got.size
    for m in (got, want):
        assert abs(m.mean()) < 4 * std / np.sqrt(n)
        assert abs(m.std() - std) < 4 * std / np.sqrt(2 * n)
    assert tinit.MSRAPrelu(slope=slope).dumps() == \
        jinit.MSRAPrelu(slope=slope).dumps()
    assert isinstance(tinit.create("msraprelu"), tinit.MSRAPrelu)


@pytest.mark.parametrize("shape", [(2, 3, 4, 4), (1, 1, 5, 3), (3, 2, 6, 7)])
def test_bilinear_matches(shape):
    got, want = _both("bilinear", "bilinear", "up_weight", shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["lstm_i2h_bias", "lstm_h2h_weight",
                                  "lstm_state"])
def test_lstm_bias_matches(name):
    got, want = _both(tinit.LSTMBias(forget_bias=2.5),
                      jinit.LSTMBias(forget_bias=2.5), name, (12,))
    np.testing.assert_array_equal(got, want)
    assert got[3:6].tolist() == [2.5] * 3 and got[:3].sum() == 0


@pytest.mark.parametrize("mode,layers,bidir", [
    ("lstm", 2, True), ("gru", 1, False), ("rnn_tanh", 2, False)])
def test_fused_rnn_layout_matches(mode, layers, bidir):
    """The flat vector of the fused RNN op: each weight block through the
    inner initializer, biases zero, the LSTM forget biases
    ``forget_bias``, in the reference's layout (input width inferred
    from the vector's length)."""
    from mxnet_tpu_torch.ops.rnn import rnn_param_size
    size = rnn_param_size(3, 4, layers, mode, bidir)
    kw = dict(num_hidden=4, num_layers=layers, mode=mode,
              bidirectional=bidir, forget_bias=2.0)
    got, want = _both(tinit.FusedRNN(tinit.Constant(0.5), **kw),
                      jinit.FusedRNN(jinit.Constant(0.5), **kw),
                      "lstm_parameters", (size,))
    np.testing.assert_array_equal(got, want)
    assert (got == 0.5).any() and (got == 0).any()
    assert ((got == 2.0).sum() > 0) == (mode == "lstm")
    # the dumped form carries the inner initializer through create()
    dumped = tinit.FusedRNN(tinit.Constant(0.5), **kw).dumps()
    assert isinstance(tinit.create(dumped), tinit.FusedRNN)
    again, _ = _both(dumped, "zeros", "lstm_parameters", (size,))
    np.testing.assert_array_equal(again, got)


def test_mixed_matches():
    pats = [".*bias", ".*gamma", ".*"]
    got, want = _both(
        tinit.Mixed(pats, [tinit.Constant(0.25), tinit.One(),
                           tinit.Constant(-1.0)]),
        jinit.Mixed(pats, [jinit.Constant(0.25), jinit.One(),
                           jinit.Constant(-1.0)]), "fc_bias", (3,))
    np.testing.assert_array_equal(got, want)
    got, want = _both(
        tinit.Mixed(pats, [tinit.Zero(), tinit.One(), tinit.Constant(-1.0)]),
        jinit.Mixed(pats, [jinit.Zero(), jinit.One(), jinit.Constant(-1.0)]),
        "fc_weight", (2, 2))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="did not match"):
        tinit.Mixed(["a.*"], [tinit.Zero()])("b", torch.zeros(1))


def test_load_matches():
    rs = np.random.RandomState(2)
    saved = {"arg:fc_weight": rs.randn(3, 2).astype(np.float32),
             "aux:bn_moving_var": rs.rand(3).astype(np.float32)}
    for name, shape in (("fc_weight", (3, 2)), ("bn_moving_var", (3,)),
                        ("other_bias", (2,))):
        got, want = _both(tinit.Load(saved, default_init=tinit.Constant(7)),
                          jinit.Load(saved,
                                     default_init=jinit.Constant(7)),
                          name, shape)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(AssertionError, match="Shape mismatch"):
        tinit.Load(saved)("fc_weight", torch.zeros(2, 3))
    with pytest.raises(AssertionError, match="no default"):
        tinit.Load(saved)("missing_weight", torch.zeros(1))


def test_init_desc_attrs_and_global_init():
    """An ``InitDesc`` whose attrs name an initializer takes its weight
    rule; a call records itself as the desc's global initializer."""
    attrs = {"__init__": tinit.Constant(3.0).dumps()}
    assert attrs["__init__"] == jinit.Constant(3.0).dumps()
    t = torch.zeros(2, 2)
    desc = tinit.InitDesc("any_bias", attrs=attrs)
    glob = tinit.Uniform()
    glob(desc, t)
    a = np.zeros((2, 2), np.float32)
    jdesc = jinit.InitDesc("any_bias", attrs={"__init__": attrs["__init__"]})
    jinit.Uniform()(jdesc, a)
    np.testing.assert_array_equal(t.numpy(), a)
    assert desc.global_init is glob and desc.attrs is attrs
    assert isinstance(tinit.create(None), tinit.Uniform)


def test_initializers_by_name_are_finite():
    """tests/test_optimizer.py's sweep of names, including the new ones;
    a bias takes zeros."""
    for name, cls in [("xavier", tinit.Xavier), ("normal", tinit.Normal),
                      ("uniform", tinit.Uniform), ("zeros", tinit.Zero),
                      ("ones", tinit.One), ("orthogonal", tinit.Orthogonal),
                      ("msraprelu", tinit.MSRAPrelu)]:
        t = torch.empty(8, 4)
        i = tinit.create(name)
        assert isinstance(i, cls)
        i("fc1_weight", t)
        assert torch.isfinite(t).all()
    t = torch.full((8,), 5.0)
    tinit.Xavier()("fc1_bias", t)
    assert not t.any()

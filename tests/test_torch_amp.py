"""PyTorch port, mixed precision: ``mxnet_tpu_torch.amp`` against the JAX
package's ``mxnet_tpu.amp`` on the same numpy inputs.

The model is a 2-layer BERT (units 64, 4 heads, T 32) with the tied
masked-LM head of ``examples/bert_pretrain_mlm.py`` (``nd.dot`` in the
JAX package, ``F.dot`` in the port), fed ``int32`` token ids (float ids
would be cast to bf16 under AMP, as in the reference: ``Embedding`` is a
low-precision op). On the CPU the port runs its flash kernels' plain
twins, the JAX package its Pallas kernels in interpret mode.

Tolerances, each with its reason:

- ``AMP_LOSS_TOL = 2e-3`` relative — the masked-LM loss of each of 3
  Adam steps under ``amp.init()``: bf16 forwards through 2 layers in two
  frameworks, whose f32 sums (matmuls, attention) differ in order, so a
  value on a bf16 rounding boundary lands one ulp (2^-8) apart and the
  difference carries on; the losses are means over ~20 positions.
- ``AMP_LOGIT_TOL = 5e-2`` — the bf16 logits after the 3 steps,
  relative to their largest magnitude: besides the forward's rounding,
  Adam's first steps move every weight by about ``lr`` whatever the
  gradient's size, so bf16 noise in small gradients becomes weight
  differences of up to ``2 lr`` per step.
- ``CAST_TOL = 3e-2`` — a block cast whole to bf16 against the JAX
  package's cast block: bf16 arithmetic end to end (LayerNorm included),
  summed in another order.
"""
import os
import sys
import warnings

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.autograd as jag  # noqa: E402
import mxnet_tpu.ndarray as jnd  # noqa: E402
from mxnet_tpu import amp as jamp  # noqa: E402
from mxnet_tpu import gluon as jgluon, nd  # noqa: E402
from mxnet_tpu.gluon import nn as jnn  # noqa: E402
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JBERT  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu_torch import amp as tamp  # noqa: E402
from mxnet_tpu_torch import autograd as tag  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch import kernels  # noqa: E402
from mxnet_tpu_torch.convert import load_gluon_params  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tnn  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel as TBERT  # noqa
from mxnet_tpu_torch.gluon.nn import attention as tattention  # noqa: E402
from mxnet_tpu_torch.ops import nn as tF  # noqa: E402

torch.set_num_threads(2)

AMP_LOSS_TOL = 2e-3
AMP_LOGIT_TOL = 5e-2
CAST_TOL = 3e-2
LR = 1e-3
VOCAB, T, BATCH, STEPS, MASK = 100, 32, 4, 3, 1
CFG = dict(vocab_size=VOCAB, units=64, hidden_size=128, num_layers=2,
           num_heads=4, max_length=T, dropout=0.0, flash=True)


class JBertForMLM(jgluon.HybridBlock):
    def __init__(self):
        super().__init__(prefix="bertformlm0_")
        with self.name_scope():
            self.bert = JBERT(**CFG)
            self.transform = jnn.Dense(CFG["units"], activation="relu",
                                       flatten=False)
            self.ln = jnn.LayerNorm()

    def forward(self, tokens, valid_length):
        seq, _ = self.bert(tokens, None, valid_length)
        h = self.ln(self.transform(seq))
        w = self.bert.word_embed.weight.data()
        return nd.dot(h.reshape((-1, h.shape[-1])), w,
                      transpose_b=True).reshape((h.shape[0], h.shape[1], -1))


class TBertForMLM(tgluon.HybridBlock):
    def __init__(self):
        super().__init__(prefix="bertformlm0_")
        with self.name_scope():
            self.bert = TBERT(**CFG)
            self.transform = tnn.Dense(CFG["units"], activation="relu",
                                       flatten=False)
            self.ln = tnn.LayerNorm()

    def forward(self, tokens, valid_length):
        seq, _ = self.bert(tokens, None, valid_length)
        h = self.ln(self.transform(seq))
        w = self.bert.word_embed.weight.data()
        return tF.dot(h.reshape(-1, h.shape[-1]), w,
                      transpose_b=True).reshape(h.shape[0], h.shape[1], -1)


def _batches(seed, n=STEPS):
    """The example's bigram corpus with 15% masking: int32 ids, f32
    targets, weights and valid lengths (only valid masked positions
    carry loss)."""
    rng = np.random.RandomState(seed)
    trans = rng.randint(2, VOCAB, VOCAB)
    out = []
    for _ in range(n):
        toks = np.zeros((BATCH, T), np.int32)
        toks[:, 0] = rng.randint(2, VOCAB, BATCH)
        for t in range(1, T):
            toks[:, t] = trans[toks[:, t - 1]]
        masked = toks.copy()
        pos = rng.rand(BATCH, T) < 0.15
        pos[:, 0] = False
        masked[pos] = MASK
        vlen = np.array([T, 21, 9, 27], np.float32)
        pos &= np.arange(T)[None, :] < vlen[:, None]
        pos[:, 1] = True      # at least one loss position per row
        out.append((masked, toks.astype(np.float32),
                    pos.astype(np.float32), vlen))
    return out


@pytest.fixture(scope="module")
def nets():
    """One JAX net and its port copy (the same weights), shared by the
    module's tests that do not train."""
    mx.random.seed(0)
    jnet = JBertForMLM()
    jnet.initialize(init=mx.initializer.Xavier())
    x, _, _, vlen = _batches(0)[0]
    with jag.pause():     # resolve the deferred Dense shapes
        jnet(nd.array(x), nd.array(vlen))
    tnet = TBertForMLM()
    tnet.initialize(device="cpu")
    load_gluon_params(tnet, {k: v.data().asnumpy() for k, v in
                             jnet.collect_params().items()})
    return jnet, tnet


@pytest.fixture(autouse=True)
def _amp_off():
    yield
    jamp.uninit()
    tamp.uninit()


def _dtype_name(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.dtype(x.dtype).name


def _record_dtypes(net, forward, attention_owner, patch):
    """``[(block prefix, output dtype)]`` of every block of ``net`` and
    of the attention op, in call order, over one ``forward()``."""
    seen = []

    def hook(block, _args, out):
        outs = out if isinstance(out, (tuple, list)) else (out,)
        seen.append((block.prefix, tuple(_dtype_name(o) for o in outs)))

    blocks = []

    def walk(b):
        blocks.append(b)
        kids = (b._children.values() if hasattr(b, "_children")
                else b._modules.values())
        for c in kids:
            walk(c)
    walk(net)
    handles = [b.register_forward_hook(hook) for b in blocks]
    op = getattr(attention_owner, "scaled_dot_product_attention")

    def recorded(*a, **kw):
        out = op(*a, **kw)
        seen.append(("scaled_dot_product_attention",
                     (_dtype_name(out),)))
        return out
    with patch.context() as m:
        m.setattr(attention_owner, "scaled_dot_product_attention", recorded)
        forward()
    for h in handles:
        h.remove() if hasattr(h, "remove") else h.detach()
    return seen


def test_op_output_dtypes_under_amp_match_the_jax_package(nets,
                                                          monkeypatch):
    """Under ``amp.init()`` every block's output, and the attention op's,
    has the JAX package's dtype (Dense and attention bf16, LayerNorm and
    the residual sums f32, the MLM logits bf16); after ``uninit()``
    every one is f32 again."""
    jnet, tnet = nets
    x, _, _, vlen = _batches(0)[0]

    def jfwd():
        jnet(nd.array(x), nd.array(vlen))

    def tfwd():
        with torch.no_grad():
            tnet(torch.from_numpy(x), torch.from_numpy(vlen))
    runs = {}
    for on in (True, False):
        if on:
            jamp.init()
            tamp.init()
        runs[on] = (_record_dtypes(jnet, jfwd, jnd, monkeypatch),
                    _record_dtypes(tnet, tfwd, tattention, monkeypatch))
        jamp.uninit()
        tamp.uninit()
    j_on, t_on = runs[True]
    assert len(t_on) == len(j_on) > 30
    assert [d for _, d in t_on] == [d for _, d in j_on]
    on = dict(t_on)
    assert on["scaled_dot_product_attention"] == ("bfloat16",)
    assert {d for _, d in t_on} == {("bfloat16",), ("float32",),
                                    ("float32", "bfloat16")}
    j_off, t_off = runs[False]
    assert [d for _, d in t_off] == [d for _, d in j_off]
    assert {x for _, d in t_off for x in d} == {"float32"}


def _j_step(trainer, jnet, loss_fn, batch):
    x, y, w, vlen = batch
    with jag.record():
        logits = jnet(nd.array(x), nd.array(vlen))
        per_tok = loss_fn(logits.reshape((-1, VOCAB)),
                          nd.array(y).reshape((-1,)))
        wf = nd.array(w).reshape((-1,))
        loss = (per_tok * wf).sum() / (wf.sum() + 1e-6)
        with jamp.scale_loss(loss, trainer) as scaled:
            pass
    scaled.backward()
    trainer.step(BATCH)
    return float(loss.asnumpy())


def _t_step(trainer, tnet, loss_fn, batch):
    x, y, w, vlen = (torch.from_numpy(a) for a in batch)
    with tag.record():
        logits = tnet(x, vlen)
        per_tok = loss_fn(logits.reshape(-1, VOCAB), y.reshape(-1))
        wf = w.reshape(-1)
        loss = (per_tok * wf).sum() / (wf.sum() + 1e-6)
        with tamp.scale_loss(loss, trainer) as scaled:
            pass
    scaled.backward()
    trainer.step(BATCH)
    return float(loss.detach())


def test_bert_three_adam_steps_under_amp_match_jax():
    """3 Adam steps of the 2-layer BERT under ``amp.init()`` with
    ``init_trainer`` (bf16: scale 1): the losses, and the bf16 logits of
    the trained nets, within the stated bf16 tolerances of the JAX
    package's; f32 master weights throughout, no kernel launch on the
    CPU."""
    mx.random.seed(1)
    jnet = JBertForMLM()
    jnet.initialize(init=mx.initializer.Xavier())
    batches = _batches(1, STEPS + 1)
    with jag.pause():
        jnet(nd.array(batches[0][0]), nd.array(batches[0][3]))
    tnet = TBertForMLM()
    tnet.initialize(device="cpu")
    load_gluon_params(tnet, {k: v.data().asnumpy() for k, v in
                             jnet.collect_params().items()})
    jamp.init()
    tamp.init()
    jtr = jamp.init_trainer(jgluon.Trainer(jnet.collect_params(), "adam",
                                           {"learning_rate": LR}))
    ttr = tamp.init_trainer(tgluon.Trainer(tnet.collect_params(), "adam",
                                           {"learning_rate": LR}))
    assert ttr._amp_loss_scaler.loss_scale == 1.0
    jloss, tloss = (jgluon.loss.SoftmaxCrossEntropyLoss(),
                    tgluon.loss.SoftmaxCrossEntropyLoss())
    before = kernels.launch_counts()
    j_losses = [_j_step(jtr, jnet, jloss, b) for b in batches[:STEPS]]
    t_losses = [_t_step(ttr, tnet, tloss, b) for b in batches[:STEPS]]
    assert kernels.launch_counts() == before
    np.testing.assert_allclose(t_losses, j_losses, rtol=AMP_LOSS_TOL)
    assert all(p.data().dtype == torch.float32
               for p in tnet.collect_params().values())
    x, _, _, vlen = batches[STEPS]
    j_logits = jnet(nd.array(x), nd.array(vlen))
    with torch.no_grad():
        t_logits = tnet(torch.from_numpy(x), torch.from_numpy(vlen))
    assert t_logits.dtype == torch.bfloat16
    assert np.dtype(j_logits.dtype).name == "bfloat16"
    want = j_logits.astype("float32").asnumpy()
    err = np.abs(t_logits.float().numpy() - want).max()
    assert err <= AMP_LOGIT_TOL * np.abs(want).max(), err


def _scaler_run(pkg, nd_, gluon_, autograd_, amp_, inputs):
    """Dense(4) under f16 AMP with a LossScaler of window 2: one step per
    input (1e5 overflows f16 in the forward). Returns the scale after
    each step and whether the weight moved."""
    amp_.init(target_dtype="float16")
    if pkg == "jax":
        net = jnn.Dense(4, in_units=4)
        net.initialize(init=mx.initializer.Constant(0.1))
        scaler = jamp.LossScaler(target_dtype="float16", scale_window=2)
        trainer = gluon_.Trainer(net.collect_params(), "adam",
                                 {"learning_rate": 0.1})

        def weight():
            return net.weight.data().asnumpy().copy()

        def arr(a):
            return nd_.array(a)
    else:
        net = tnn.Dense(4, in_units=4)
        net.initialize(device="cpu")
        with torch.no_grad():
            net.weight.data().fill_(0.1)
        scaler = tamp.LossScaler(target_dtype="float16", scale_window=2)
        trainer = gluon_.Trainer(net.collect_params(), "adam",
                                 {"learning_rate": 0.1})

        def weight():
            return net.weight.data().detach().numpy().copy()

        def arr(a):
            return torch.from_numpy(a)
    amp_.init_trainer(trainer, scaler)
    scales, moved = [], []
    for x in inputs:
        w0 = weight()
        with autograd_.record():
            out = net(arr(x))
            # the reference's ``sum`` is an f32 op under AMP; the port's
            # tensor methods do not pass the op chokepoint, so the port
            # widens first
            loss = out.sum() if pkg == "jax" else out.float().sum()
            with amp_.scale_loss(loss, trainer) as scaled:
                pass
        scaled.backward()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            trainer.step(2)
        scales.append(scaler.loss_scale)
        moved.append(bool(np.any(weight() != w0)))
    amp_.uninit()
    return scales, moved


def test_loss_scaler_sequence_and_skipped_steps_match_the_reference():
    """f16: the scale starts at 2^16, halves (and the step is skipped)
    on each overflow, doubles after 2 clean steps; the port's scale
    sequence and skipped steps equal the JAX package's. The first step
    overflows in both: the scaled loss's gradient reaching the f16
    output is 2^16, above f16's largest finite 65504."""
    ok = np.full((2, 4), 0.5, np.float32)
    bad = ok.copy()
    bad[0, 0] = 1e5                       # inf in f16
    inputs = [ok, bad, bad, ok, ok, ok, bad, ok]
    j = _scaler_run("jax", nd, jgluon, jag, jamp, inputs)
    t = _scaler_run("torch", None, tgluon, tag, tamp, inputs)
    assert t == j
    scales, moved = t
    assert scales == [2.0 ** e for e in (15, 14, 13, 13, 14, 14, 13, 13)]
    assert moved == [False, False, False, True, True, True, False, True]


def test_has_overflow_finds_one_poisoned_gradient_among_many():
    params = []
    for i in range(40):
        p = tgluon.parameter.Parameter(f"p{i}", shape=(3, 5))
        p.initialize(device="cpu")
        p.grad().normal_()
        params.append(p)
    frozen = tgluon.parameter.Parameter("frozen", shape=(2,),
                                        grad_req="null")
    frozen.initialize(device="cpu")
    scaler = tamp.LossScaler(target_dtype="float16")
    assert not scaler.has_overflow(params + [frozen])
    for bad in (float("inf"), float("-inf"), float("nan")):
        params[23].grad()[1, 2] = bad
        assert scaler.has_overflow(params)
        params[23].grad()[1, 2] = 0.0
    assert not scaler.has_overflow(params)
    assert not scaler.has_overflow([])


def test_scale_loss_multiplies_by_the_scale():
    net = tnn.Dense(2, in_units=2)
    net.initialize(device="cpu")
    trainer = tgluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": 0.1})
    loss = torch.tensor([1.5, -2.0])
    with tamp.scale_loss(loss, trainer) as same:   # no scaler attached
        assert same is loss
    tamp.init(target_dtype="float16")
    tamp.init_trainer(trainer)
    with tamp.scale_loss(loss, trainer) as scaled:
        assert torch.equal(scaled, loss * 2.0 ** 16)
    with tamp.scale_loss([loss, loss], trainer) as scaled:
        assert isinstance(scaled, list) and len(scaled) == 2
        assert torch.equal(scaled[1], loss * 2.0 ** 16)


def test_loss_scaler_state_round_trips_as_the_reference():
    t = tamp.LossScaler(target_dtype="float16", scale_window=3)
    j = jamp.LossScaler(target_dtype="float16", scale_window=3)
    for s in (t, j):
        for ov in (False, True, False, False, False):
            s.update_scale(ov)
    assert t.state_dict() == j.state_dict()
    u = tamp.LossScaler()
    assert u.loss_scale == 1.0
    u.load_state_dict(t.state_dict())
    assert u.state_dict() == t.state_dict()


def test_convert_hybrid_block_gives_a_bf16_forward(nets):
    """A BERT cast whole to bf16 (no AMP): bf16 parameters and outputs,
    within ``CAST_TOL`` of the JAX package's cast block on the same
    input; the cast copies leave the shared nets unchanged."""
    jnet, _ = nets
    x, _, _, vlen = _batches(2)[0]
    arrays = {k: v.data().asnumpy() for k, v in
              jnet.collect_params().items()}
    jcast = JBertForMLM()
    jcast.initialize(init=mx.initializer.Xavier())
    with jag.pause():
        jcast(nd.array(x), nd.array(vlen))
    for name, p in jcast.collect_params().items():
        p.set_data(nd.array(arrays[name.replace(jcast.prefix,
                                                jnet.prefix, 1)]))
    tcast = TBertForMLM()
    tcast.initialize(device="cpu")
    load_gluon_params(tcast, arrays)
    assert jamp.convert_hybrid_block(jcast) is jcast
    assert tamp.convert_hybrid_block(tcast) is tcast
    assert {p.data().dtype for p in tcast.collect_params().values()} == {
        torch.bfloat16}
    vl = vlen.astype(np.float32)
    want = jcast(nd.array(x), nd.array(vl)).astype("float32").asnumpy()
    with torch.no_grad():
        got = tcast(torch.from_numpy(x), torch.from_numpy(vl).to(
            torch.bfloat16))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= CAST_TOL * max(1.0, np.abs(want).max()), err


def test_convert_model_casts_float_leaves_of_numpy_and_tensor_dicts():
    args = {"w": np.ones((2, 2), np.float32), "i": np.arange(3),
            "t": torch.ones(2), "ti": torch.arange(2)}
    sym, a16, aux = tamp.convert_model("net", args, {"m": np.zeros(2)},
                                       target_dtype="float16")
    assert sym == "net"
    assert a16["w"].dtype == np.float16 and a16["i"].dtype == args["i"].dtype
    assert a16["t"].dtype == torch.float16 and a16["ti"].dtype == torch.int64
    assert aux["m"].dtype == np.float16
    _, abf, _ = tamp.convert_model(None, args, {})
    assert abf["w"].dtype == torch.bfloat16      # numpy has no bfloat16
    assert abf["t"].dtype == torch.bfloat16


def test_trainer_step_takes_the_reference_signature():
    net = tnn.Dense(2, in_units=2)
    net.initialize(device="cpu")
    trainer = tgluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": 0.1})
    trainer.step(1, ignore_stale_grad=False)
    before = net.weight.data().detach().clone()
    net.weight.grad().fill_(1.0)
    # as in the reference: the per-parameter loop instead of the fused
    # step, every parameter with a gradient updated
    trainer.step(1, ignore_stale_grad=True)
    assert trainer._fused.fallbacks == {"ignore_stale_grad": 1}
    assert not torch.equal(net.weight.data(), before)


def test_amp_casts_by_the_reference_rule():
    """A float32 or target-dtype tensor input of a low-precision op goes
    to the target, of an f32 op to f32; integer inputs, float64 inputs
    and ops in neither list pass through; nothing is cast after
    ``uninit()``."""
    x = torch.randn(3, 4)
    w = torch.randn(5, 4)
    tamp.init(target_dtype="float16")
    assert tF.FullyConnected(x, w).dtype == torch.float16
    assert tF.FullyConnected(x.double(), w.double()).dtype == torch.float64
    assert tF.log_softmax(x.half()).dtype == torch.float32
    assert tF.Activation(x.half(), act_type="tanh").dtype == torch.float16
    ids = torch.tensor([[1, 3]], dtype=torch.int32)
    assert tF.Embedding(ids, w).dtype == torch.float16
    tamp.init(target_dtype="bfloat16", target_precision_ops=["Activation"])
    assert tF.Activation(x, act_type="tanh").dtype == torch.bfloat16
    tamp.uninit()
    assert tF.FullyConnected(x, w).dtype == torch.float32
    assert tF.Activation(x, act_type="tanh").dtype == torch.float32

"""PyTorch port, the training slice as a whole: masked-LM training of a small
BERT with the tied decoder of ``examples/bert_pretrain_mlm.py``
(``BertForMLM``, defined here in both packages), through gluon, the
flash attention op (on the CPU the port runs its kernels' plain twins,
the JAX package its Pallas kernels in interpret mode), ``backward()``
and ``Trainer.step`` with Adam. The JAX package's initialised weights
are carried across with ``convert.load_gluon_params``; both take three
steps on the same synthetic bigram batches with ``valid_length``
padding.

Tolerances, each with its reason:

- ``LOSS_TOL = 1e-5`` relative — the masked-LM loss of each step: f32
  forward through 2 layers, the sums of every matmul and of attention in
  another order.
- ``PARAM_TOL = 1e-5`` — every parameter after step 3: the weights move
  by at most ``3 * lr = 3e-3``, and Adam's ``m / sqrt(v)`` carries the
  relative difference of the gradients (~1e-6) into the step.
- The attention key-projection biases are held to ``2 * 3 * lr``
  instead: their gradient is zero in exact arithmetic (softmax does not
  change when one constant is added to a query's every score), so both
  packages hand Adam float noise of differing sign, and Adam's first
  steps turn noise into ``+-lr``. Both losses stay equal all the same,
  which the loss check shows.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.autograd as jag  # noqa: E402
from mxnet_tpu import gluon as jgluon, nd  # noqa: E402
from mxnet_tpu.gluon import nn as jnn  # noqa: E402
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JBERT  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu_torch import autograd as tag  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch import kernels  # noqa: E402
from mxnet_tpu_torch.convert import load_gluon_params  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tnn  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel as TBERT  # noqa

torch.set_num_threads(2)

LOSS_TOL = 1e-5
PARAM_TOL = 1e-5
LR = 1e-3
KEY_BIAS_TOL = 2 * 3 * LR
VOCAB, T, BATCH, STEPS, MASK = 50, 12, 4, 3, 1
CFG = dict(vocab_size=VOCAB, units=32, hidden_size=64, num_layers=2,
           num_heads=2, max_length=32, dropout=0.0, flash=True)


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
        return (h.reshape(-1, h.shape[-1]) @ w.t()).reshape(
            h.shape[0], h.shape[1], -1)


def _batches(seed):
    """The example's bigram corpus with 15% masking, plus valid lengths;
    only valid masked positions carry loss."""
    rng = np.random.RandomState(seed)
    trans = rng.randint(2, VOCAB, VOCAB)
    out = []
    for _ in range(STEPS):
        toks = np.zeros((BATCH, T), np.int32)
        toks[:, 0] = rng.randint(2, VOCAB, BATCH)
        for t in range(1, T):
            toks[:, t] = trans[toks[:, t - 1]]
        masked = toks.copy()
        pos = rng.rand(BATCH, T) < 0.15
        pos[:, 0] = False
        masked[pos] = MASK
        vlen = np.array([T, 9, 5, 11], np.float32)
        pos &= np.arange(T)[None, :] < vlen[:, None]
        pos[:, 1] = True      # at least one loss position per row
        out.append((masked.astype(np.float32), toks.astype(np.float32),
                    pos.astype(np.float32), vlen))
    return out


def _train_jax(net, batches):
    trainer = jgluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": LR})
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for x, y, w, vlen in batches:
        with jag.record():
            logits = net(nd.array(x), nd.array(vlen))
            per_tok = loss_fn(logits.reshape((-1, VOCAB)),
                              nd.array(y).reshape((-1,)))
            wf = nd.array(w).reshape((-1,))
            loss = (per_tok * wf).sum() / (wf.sum() + 1e-6)
        loss.backward()
        trainer.step(BATCH)
        losses.append(float(loss.asnumpy()))
    return losses


def _train_port(net, batches):
    trainer = tgluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": LR})
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for x, y, w, vlen in batches:
        with tag.record():
            logits = net(torch.from_numpy(x), torch.from_numpy(vlen))
            per_tok = loss_fn(logits.reshape(-1, VOCAB),
                              torch.from_numpy(y).reshape(-1))
            wf = torch.from_numpy(w).reshape(-1)
            loss = (per_tok * wf).sum() / (wf.sum() + 1e-6)
        loss.backward()
        trainer.step(BATCH)
        losses.append(float(loss.detach()))
    return losses


def test_bert_mlm_three_adam_steps_match_jax():
    mx.random.seed(0)
    jnet = JBertForMLM()
    jnet.initialize(init=mx.initializer.Xavier())
    batches = _batches(0)
    with jag.pause():     # resolve the deferred Dense shapes
        jnet(nd.array(batches[0][0]), nd.array(batches[0][3]))
    tnet = TBertForMLM()
    tnet.initialize(device="cpu")
    load_gluon_params(tnet, {k: v.data().asnumpy() for k, v in
                             jnet.collect_params().items()})
    before = kernels.launch_counts()
    j_losses = _train_jax(jnet, batches)
    t_losses = _train_port(tnet, batches)
    assert kernels.launch_counts() == before   # CPU: the plain twins
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_TOL)
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(jp.keys()) == list(tp.keys())
    checked = 0
    for name in jp.keys():
        want = jp[name].data().asnumpy()
        got = tp[name].data().detach().numpy()
        tol = KEY_BIAS_TOL if name.endswith("attn_key_bias") else PARAM_TOL
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=name)
        checked += 1
    assert checked == 43

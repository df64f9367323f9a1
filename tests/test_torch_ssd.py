"""PyTorch port, SSD (``gluon.model_zoo.ssd``) against the JAX
package's: ``MultiBoxLoss`` and its gradients on the same predictions,
labels and anchors; two training steps of the small SSD of
``tests/test_detection.py``'s convergence test through each package's
``Trainer`` from the same weights; ``detect()``'s rows; SSD-300
(``ssd_300_vgg16_reduced``): its 8732 anchors and output shapes at 300 x
300 (``tests/test_detection.py``'s forward test), its parameters' names,
and one forward at batch 1 against the JAX net's on the same weights, at
257 x 257, the least input its last stage takes (one XLA compile of the
whole net at the smaller size).

The port's weights go into the JAX net through ``save_parameters`` /
``load_parameters``, which key by structural path, so the JAX net needs
no forward to shape them.

Tolerance: ``LOSS_TOL = 2e-5`` of each result's magnitude for the loss,
its gradients and the small net's two steps (f32 sums in torch's order
against XLA's); ``SSD_TOL = 1e-4`` for SSD-300's predictions (fifteen
f32 convolutions deep, oneDNN's sums against XLA's).
"""
import numpy as np
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import ssd as jssd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.gluon.model_zoo import ssd as tssd

torch.set_num_threads(2)

LOSS_TOL = 2e-5
SSD_TOL = 1e-4


def _rel_close(got, want, what, tol):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), (what, err)


def _carry(t, j, path):
    """The port's parameters into the JAX net by structural path (the
    stages' layers are named by each package's own counters)."""
    t.save_parameters(str(path))
    j.load_parameters(str(path))


def _small(pkg, nn):
    stage1 = nn.HybridSequential(prefix="")
    stage1.add(nn.Conv2D(16, 3, strides=2, padding=1, activation="relu"))
    stage1.add(nn.Conv2D(16, 3, strides=2, padding=1, activation="relu"))
    stage2 = nn.HybridSequential(prefix="")
    stage2.add(nn.Conv2D(16, 3, strides=2, padding=1, activation="relu"))
    return pkg.SSD([stage1, stage2], sizes=[(0.3,), (0.6,)],
                   ratios=[(1.0, 2.0), (1.0, 2.0)], steps=[-1.0, -1.0],
                   classes=2, prefix="small_")


def _boxes(n, seed):
    """The convergence test's task: one bright square an image, its
    class the half it lies in."""
    rng = np.random.RandomState(seed)
    imgs = rng.randn(n, 3, 32, 32).astype(np.float32) * 0.05
    labels = np.full((n, 2, 6), -1.0, np.float32)
    for i in range(n):
        cx, cy = rng.uniform(0.25, 0.75, 2)
        x1, y1, x2, y2 = cx - 0.15, cy - 0.15, cx + 0.15, cy + 0.15
        c = 0 if cx < 0.5 else 1
        imgs[i, c, int(y1 * 32):int(y2 * 32), int(x1 * 32):int(x2 * 32)] \
            += 1.0
        labels[i, 0] = [c, x1, y1, x2, y2, 0]
    return imgs, labels


def test_small_ssd_two_training_steps_match_jax(tmp_path):
    j = _small(jssd, jgluon.nn)
    t = _small(tssd, tgluon.nn)
    imgs, labels = _boxes(4, 0)
    t.initialize(tmx.initializer.Xavier(), device="cpu")
    with tag.pause():
        t(torch.from_numpy(imgs))
    _carry(t, j, tmp_path / "small.params")
    jloss, tloss = jssd.MultiBoxLoss(), tssd.MultiBoxLoss()
    j.hybridize()
    jloss.hybridize()
    jtr = jgluon.Trainer(j.collect_params(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9})
    ttr = tgluon.Trainer(t.collect_params(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9})
    for step in range(2):
        with jag.record():
            c, lo, a = j(jmx.nd.array(imgs))
            jl = jloss(c, lo, jmx.nd.array(labels), a).mean()
        jl.backward()
        jtr.step(1)
        with tag.record():
            c, lo, a = t(torch.from_numpy(imgs))
            tl = tloss(c, lo, torch.from_numpy(labels), a).mean()
        tl.backward()
        ttr.step(1)
        _rel_close(tl.item(), jl.asscalar(), f"loss {step}", LOSS_TOL)
    tp = t._collect_params_with_prefix()
    for key, p in j._collect_params_with_prefix().items():
        _rel_close(tp[key].data().detach().numpy(), p.data().asnumpy(),
                   key, LOSS_TOL)
    with tag.pause():
        det = t.detect(torch.from_numpy(imgs), threshold=0.0)
    assert tuple(det.shape[:1]) == (4,) and det.shape[-1] == 6
    rows = det.numpy().reshape(-1, 6)
    live = rows[rows[:, 0] >= 0]
    assert len(live) and (live[:, 0] < 2).all()
    assert ((live[:, 1] >= 0) & (live[:, 1] <= 1)).all()


def test_multibox_loss_and_gradients_match_jax():
    rs = np.random.RandomState(3)
    n, A, C = 3, 64, 4
    anchors = np.sort(rs.uniform(0, 1, (1, A, 4)).astype(np.float32),
                      axis=-1)[..., [0, 1, 2, 3]]
    anchors[..., 2:] = anchors[..., :2] + rs.uniform(
        0.1, 0.4, (1, A, 2)).astype(np.float32)
    cls_preds = rs.randn(n, C + 1, A).astype(np.float32)
    loc_preds = (rs.randn(n, A * 4) * 0.1).astype(np.float32)
    labels = np.full((n, 3, 6), -1.0, np.float32)
    for i in range(n):
        for g in range(1 + i % 3):
            x1, y1 = rs.uniform(0, 0.6, 2)
            labels[i, g] = [rs.randint(0, C), x1, y1, x1 + 0.3, y1 + 0.3, 0]
    jl, tl = jssd.MultiBoxLoss(lambd=0.7), tssd.MultiBoxLoss(lambd=0.7)
    jl.hybridize()
    jc, jo = jmx.nd.array(cls_preds), jmx.nd.array(loc_preds)
    jc.attach_grad()
    jo.attach_grad()
    tc = torch.from_numpy(cls_preds.copy()).requires_grad_()
    to = torch.from_numpy(loc_preds.copy()).requires_grad_()
    with jag.record():
        jy = jl(jc, jo, jmx.nd.array(labels), jmx.nd.array(anchors))
    with tag.record():
        ty = tl(tc, to, torch.from_numpy(labels), torch.from_numpy(anchors))
    assert tuple(ty.shape) == (n,)
    _rel_close(ty.detach().numpy(), jy.asnumpy(), "loss", LOSS_TOL)
    jy.backward()
    ty.backward(torch.ones_like(ty))
    _rel_close(tc.grad.numpy(), jc.grad.asnumpy(), "class grad", LOSS_TOL)
    _rel_close(to.grad.numpy(), jo.grad.asnumpy(), "box grad", LOSS_TOL)


def test_ssd_300_anchors_shapes_and_forward_match_jax(tmp_path):
    t = tssd.ssd_300_vgg16_reduced(classes=20, prefix="ssd_")
    t.initialize(device="cpu")
    with tag.pause():
        tc, tl, ta = t(torch.zeros(1, 3, 300, 300))
    # 38^2*4 + 19^2*6 + 10^2*6 + 5^2*6 + 3^2*4 + 1^2*4 = 8732
    assert tuple(ta.shape) == (1, 8732, 4)
    assert tuple(tc.shape) == (1, 21, 8732)
    assert tuple(tl.shape) == (1, 8732 * 4)
    j = jssd.ssd_300_vgg16_reduced(classes=20, prefix="ssd_")
    _carry(t, j, tmp_path / "ssd.params")
    j.hybridize()
    x = (np.random.RandomState(0).randn(1, 3, 257, 257) * 0.1).astype(
        np.float32)
    with tag.pause():
        tc, tl, ta = t(torch.from_numpy(x))
    with jag.pause():
        jc, jl, ja = j(jmx.nd.array(x))
    # 33^2*4 + 17^2*6 + 9^2*6 + 5^2*6 + 3^2*4 + 1^2*4
    assert tuple(ta.shape) == (1, 6766, 4)
    np.testing.assert_allclose(ta.numpy(), ja.asnumpy(), rtol=0, atol=1e-6)
    _rel_close(tc.numpy(), jc.asnumpy(), "class predictions", SSD_TOL)
    _rel_close(tl.numpy(), jl.asnumpy(), "box predictions", SSD_TOL)
    assert [k.split("_", 1)[1] for k in t.collect_params().keys()
            if not k.startswith("ssd_conv")] == \
        [k.split("_", 1)[1] for k in j.collect_params().keys()
         if not k.startswith("ssd_conv")]

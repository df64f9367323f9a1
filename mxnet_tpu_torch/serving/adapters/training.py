"""The fine-tune -> publish loop for LoRA adapters (mirrors
``mxnet_tpu/serving/adapters/training.py``).

Per-tenant adapters are cheap to TRAIN for the same reason they are
cheap to SERVE: the base model never moves. :class:`LoRAFineTuneJob`
builds a :class:`~mxnet_tpu_torch.jit.CompiledTrainStep` in which the
base decoder's attention projections are frozen gluon Parameters
(``grad_req='null'``, never in the Trainer) and only the low-rank A/B
factors train. The compiled step reads a frozen parameter by address
(on the card its CUDA graph does), so one captured step serves every
adapter trained against that base, and an in-place refresh of the base
weights (``set_data``) is seen by the next step without a new capture.

:class:`AdapterFineTunePublisher` mirrors the fleet's
``FineTunePublisher`` one level down: train N steps, then
``bank.publish()``, which commits the factors through the bank's
:class:`~.registry.AdapterRegistry` (when it has one) BEFORE installing
them into the live device pool, so a crash anywhere leaves the previous
version serving.
"""
from __future__ import annotations

import numpy as np

from ..envutil import env_int as _env_int
from ...ops.lora import NUM_PROJ

__all__ = ["LoRAFineTuneJob", "AdapterFineTunePublisher"]

_PROJ_KEYS = ("wq", "wk", "wv", "wo")


def _host(v):
    """A weight of the decoder's parameter tree as f32 numpy."""
    if hasattr(v, "detach"):
        v = v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


class LoRAFineTuneJob:
    """Train ONLY the LoRA A/B factors of ``name`` against a frozen
    base decoder.

    ``model``/``base_params``: the serving decoder (see
    :class:`~..llm.model.TinyDecoder`) and its parameter tree (tensors
    or numpy) — the per-layer ``wq/wk/wv/wo`` projections become frozen
    Parameters on ``device`` (default: the model's). The training
    objective is projection distillation: regress ``x @ (W + scale * A @
    B)`` onto per-projection targets, per sample — enough to drive real
    gradients through every factor while staying one dense step.
    ``make_batch`` synthesizes ``(x, y)`` pairs from a hidden teacher
    adapter so the loss has a nonzero optimum to descend toward.

    ``rank`` defaults to ``MXNET_TPU_LLM_ADAPTER_RANK`` (the bank's
    page rank — a job at that rank publishes into one page).
    """

    def __init__(self, model, base_params, name, rank=None, alpha=None,
                 learning_rate=0.05, seed=0, device=None):
        import torch
        from ... import nd
        from ...gluon import Trainer
        from ...gluon.loss import L2Loss
        from ...gluon.parameter import Parameter

        self.name = str(name)
        self.num_layers = int(model.num_layers)
        self.d_model = int(model.num_heads * model.head_dim)
        if rank is None:
            rank = _env_int("MXNET_TPU_LLM_ADAPTER_RANK", 4)
        self.rank = int(rank)
        self.alpha = float(alpha) if alpha is not None else float(rank)
        self.scale = self.alpha / float(self.rank)
        self.device = device if device is not None else model.device
        self._nd = nd
        L, d, R = self.num_layers, self.d_model, self.rank
        rs = np.random.RandomState(seed)

        def param(pname, grad_req, value):
            p = Parameter(pname, grad_req=grad_req, shape=value.shape)
            p.initialize(device=self.device)
            p.set_data(torch.from_numpy(value))
            return p

        # frozen base projections: grad_req='null' keeps them out of the
        # Trainer; the compiled step reads them by address
        self._frozen = [
            {key: param(f"{name}_base_l{li}_{key}", "null", _host(lp[key]))
             for key in _PROJ_KEYS}
            for li, lp in enumerate(base_params["layers"])]

        # trainable factors: A small-normal, B zero (the standard LoRA
        # init — the adapter starts as an exact no-op delta)
        self._a, self._b = [], []
        for li in range(L):
            arow, brow = [], []
            for pi in range(NUM_PROJ):
                arow.append(param(f"{name}_lora_a_l{li}_p{pi}", "write",
                                  (rs.randn(d, R) * 0.1).astype(np.float32)))
                brow.append(param(f"{name}_lora_b_l{li}_p{pi}", "write",
                                  np.zeros((R, d), np.float32)))
            self._a.append(arow)
            self._b.append(brow)

        # hidden teacher delta the synthetic batches regress toward
        self._teacher = (rs.randn(L, NUM_PROJ, d, d) * 0.05
                         ).astype(np.float32)
        self._base_np = np.stack(
            [np.stack([_host(lp[key]) for key in _PROJ_KEYS])
             for lp in base_params["layers"]])          # [L, 4, d, d]

        self._l2 = L2Loss()
        trainable = [p for row in self._a for p in row] + \
                    [p for row in self._b for p in row]
        self._trainer = Trainer(trainable, "sgd",
                                {"learning_rate": float(learning_rate)})
        self.step_fn = self._trainer.compile_step(self._loss)
        self.steps = 0

    # ------------------------------------------------------ training --
    def _loss(self, x, y):
        """Per-sample distillation loss. ``x`` [B, d]; ``y`` [B, L*4*d]
        — the concatenated per-(layer, projection) targets."""
        nd = self._nd
        preds = []
        for li in range(self.num_layers):
            for pi, key in enumerate(_PROJ_KEYS):
                w = self._frozen[li][key].data()
                a = self._a[li][pi].data()
                b = self._b[li][pi].data()
                h = nd.dot(x, w) + nd.dot(nd.dot(x, a), b) * self.scale
                preds.append(h)
        return self._l2(nd.concatenate(preds, axis=1), y)

    def make_batch(self, batch_size=4, rng=None):
        """Synthesize one ``(x, y)`` training pair from the hidden
        teacher: ``y = x @ (W + teacher_delta)`` per projection."""
        rng = rng if rng is not None else np.random.RandomState(
            self.steps)
        x = rng.randn(batch_size, self.d_model).astype(np.float32)
        w_t = self._base_np + self._teacher            # [L, 4, d, d]
        y = np.einsum("bd,lpde->lpbe", x, w_t)
        y = np.transpose(y, (2, 0, 1, 3)).reshape(batch_size, -1)
        return (self._nd.array(x, ctx=self.device),
                self._nd.array(y.astype(np.float32), ctx=self.device))

    def step(self, batch_size=4, rng=None):
        """ONE compiled optimization step on a fresh synthetic batch;
        returns the mean loss (host float)."""
        from ...ndarray.ndarray import unwrap
        x, y = self.make_batch(batch_size, rng)
        loss = unwrap(self.step_fn(x, y))
        self.steps += 1
        return float(loss.detach().float().mean().cpu())

    # ----------------------------------------------------- exporting --
    def get_ab(self):
        """Current factors stacked for :meth:`AdapterBank.publish`:
        ``(a [L, 4, d, R], b [L, 4, R, d])`` host numpy."""
        a = np.stack([np.stack([_host(p.data()) for p in row])
                      for row in self._a])
        b = np.stack([np.stack([_host(p.data()) for p in row])
                      for row in self._b])
        return a, b


class AdapterFineTunePublisher:
    """Drive rounds of (train ``steps_per_publish`` steps ->
    ``bank.publish``) for one adapter name — the multi-LoRA analogue of
    the fleet's ``FineTunePublisher``. The bank persists each version
    through its registry BEFORE touching the device pool, so in-flight
    generations pinned to the old version keep decoding it while new
    admissions pick up the new one — and no publish captures or builds
    anything."""

    def __init__(self, bank, name, train_step, get_ab,
                 steps_per_publish=1, alpha=None):
        self.bank = bank
        self.name = str(name)
        self.train_step = train_step
        self.get_ab = get_ab
        self.steps_per_publish = int(steps_per_publish)
        self.alpha = alpha
        self.step = 0
        self.version = None

    @classmethod
    def from_job(cls, bank, job, steps_per_publish=1):
        """Wire a :class:`LoRAFineTuneJob` directly."""
        return cls(bank, job.name, job.step, job.get_ab,
                   steps_per_publish=steps_per_publish,
                   alpha=job.alpha)

    def run_once(self):
        """One round; returns the published version number."""
        for _ in range(self.steps_per_publish):
            self.train_step()
            self.step += 1
        a, b = self.get_ab()
        self.version = self.bank.publish(self.name, a, b,
                                         alpha=self.alpha)
        return self.version

    def run(self, rounds):
        """``rounds`` back-to-back rounds; returns the last version."""
        version = None
        for _ in range(int(rounds)):
            version = self.run_once()
        return version

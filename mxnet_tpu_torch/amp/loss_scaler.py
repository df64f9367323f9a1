"""Dynamic loss scaling of the port (mirrors
``mxnet_tpu/amp/loss_scaler.py``).

Reference: python/mxnet/contrib/amp/loss_scaler.py: multiply the loss by
a scale before backward so small gradients survive reduced precision,
check the gradients for overflow, halve the scale on overflow (the
update is skipped) and double it after ``scale_window`` clean steps.
bfloat16 has float32's exponent range, so its default scale is 1.0 and
scaling only engages for float16.
"""
from __future__ import annotations

import torch

__all__ = ["LossScaler"]


def _all_finite(grads):
    """True when every gradient (all on one device) is finite: one
    multi-tensor check (``torch._amp_foreach_non_finite_check_and_
    unscale_`` at an unscale of 1, which leaves the values as they are)
    into one flag on the device, then one host read of it."""
    found = torch.zeros(1, device=grads[0].device)
    torch._amp_foreach_non_finite_check_and_unscale_(
        grads, found, torch.ones(1, device=found.device))
    return not bool(found.item())


class LossScaler:
    def __init__(self, init_scale=None, scale_factor=2.0,
                 scale_window=2000, target_dtype="bfloat16"):
        if init_scale is None:
            init_scale = 1.0 if target_dtype == "bfloat16" else 2.0 ** 16
        self.loss_scale = float(init_scale)
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0

    def has_overflow(self, params):
        """True if any gradient of ``params`` is non-finite: one device
        check over all of them and one host sync, never a read per
        parameter (the reference's one jitted reduction)."""
        grads = [p.grad() for p in params
                 if p.grad_req != "null" and p._data is not None]
        if not grads:
            return False
        with torch.no_grad():
            return not _all_finite(grads)

    def update_scale(self, overflow: bool):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale = min(self.loss_scale * self._scale_factor,
                                      2.0 ** 24)
                self._unskipped = 0

    # ------------------------------------------------------ checkpoint --
    def state_dict(self):
        """Checkpointable state: a resumed run must keep the adapted
        scale and window position or it replays the warmup overflows."""
        return {"loss_scale": self.loss_scale,
                "unskipped": self._unskipped,
                "scale_factor": self._scale_factor,
                "scale_window": self._scale_window}

    def load_state_dict(self, state):
        self.loss_scale = float(state["loss_scale"])
        self._unskipped = int(state["unskipped"])
        self._scale_factor = float(state.get("scale_factor",
                                             self._scale_factor))
        self._scale_window = int(state.get("scale_window",
                                           self._scale_window))

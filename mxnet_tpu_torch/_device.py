"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None):
    """The ``torch.device`` that ``device`` names: a
    :class:`~.context.Context`, a string or a ``torch.device``; None is
    the innermost ``with Context`` block's device, else the card. Raises
    when it names CUDA and CUDA is absent: the port's entry points run on
    the card unless the caller asks for the CPU."""
    if device is None:
        from .context import Context
        device = Context.innermost() or "cuda"
    dev = getattr(device, "torch_device", None)
    dev = torch.device(device) if dev is None else dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or ctx=mx.cpu()) "
            "to run the port on the CPU (its plain PyTorch versions of "
            "every kernel)")
    return dev

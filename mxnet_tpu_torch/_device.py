"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda"):
    """``torch.device(device)``, raising when it names CUDA and CUDA is
    absent: the port's entry points run on the card unless the caller
    asks for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU (its plain PyTorch versions of every kernel)")
    return dev

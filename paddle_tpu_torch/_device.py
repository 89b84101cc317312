"""Device resolution for the port's entry points.

Every entry point runs on the card unless its caller names another
device: ``device=None`` means CUDA, and on a machine without a GPU it
raises rather than dropping to the CPU behind the caller's back. The
CPU is reached only by asking for it (``device="cpu"``), which is what
the tests do.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no GPU is present); anything
    else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)

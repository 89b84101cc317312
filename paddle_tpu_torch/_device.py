"""Device resolution for the port's entry points.

Every entry point runs on the card unless its caller names another
device: ``device=None`` means the device set by
``paddle_tpu_torch.set_device`` when one was set, else CUDA, and on a
machine without a GPU it raises rather than dropping to the CPU behind
the caller's back. The CPU is reached only by asking for it
(``device="cpu"``, or ``set_device("cpu")`` once), which is what the
tests do.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "set_default_device"]

_DEFAULT = [None]


def set_default_device(device) -> None:
    """Make ``device`` (a ``torch.device``, a string, or None to forget
    it) what ``resolve_device(None)`` returns."""
    _DEFAULT[0] = None if device is None else torch.device(device)


def resolve_device(device=None) -> torch.device:
    """``None`` -> the device set by ``set_device``, else ``cuda``
    (raises when no GPU is present); anything else is taken as given."""
    if device is None:
        if _DEFAULT[0] is not None:
            return _DEFAULT[0]
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' or call "
                "paddle_tpu_torch.set_device('cpu') to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)

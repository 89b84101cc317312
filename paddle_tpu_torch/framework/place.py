"""Places: the device an :class:`~paddle_tpu_torch.static.Executor` runs on.

Port of ``paddle_tpu/framework/place.py``'s ``CPUPlace`` and
``CUDAPlace``. A place names a torch device; :func:`place_device` maps a
place (or ``None``) onto one through ``_device.resolve_device``, so
``None`` means CUDA and raises on a machine without a GPU.
"""
from __future__ import annotations

import torch

from .._device import resolve_device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "place_device"]


class Place:
    """Names a device. Equality is structural."""

    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def torch_device(self) -> torch.device:
        raise NotImplementedError


class CPUPlace(Place):
    device_type = "cpu"

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    device_type = "cuda"

    def torch_device(self) -> torch.device:
        return torch.device("cuda", self.device_id)


def place_device(place=None) -> torch.device:
    """The torch device of ``place``: a :class:`Place`, a device string or
    ``torch.device``, or ``None`` for CUDA (raising without a GPU)."""
    if isinstance(place, Place):
        return place.torch_device()
    return resolve_device(place)

"""Places and the default device.

Port of ``paddle_tpu/framework/place.py``. A place names a torch device;
:func:`place_device` maps a place (or ``None``) onto one through
``_device.resolve_device``, so ``None`` means the device chosen by
:func:`set_device`, else CUDA, and raises on a machine without a GPU.
The JAX package's names map onto the card as its own map CUDA code onto
the TPU: ``TPUPlace`` and ``XPUPlace`` are the card (the accelerator),
``CUDAPinnedPlace`` the host.

``set_device("cpu")`` is how a caller asks for the CPU for everything
that is not given a device; ``set_device("gpu")`` (or ``"cuda"``,
``"tpu"``) for the card. The JAX package's bring-up probe
(``framework/bringup.py``, which drops to the CPU when the TPU backend
fails) has no counterpart: ``resolve_device`` never drops to the CPU.
"""
from __future__ import annotations

import torch

from .._device import resolve_device, set_default_device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "TPUPlace", "XPUPlace",
           "CUDAPinnedPlace", "place_device", "set_device", "get_device",
           "device_count", "is_compiled_with_cuda", "is_compiled_with_tpu",
           "get_default_place", "place_of"]


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


class TPUPlace(CUDAPlace):
    """The JAX package's accelerator place: the card here."""


class XPUPlace(CUDAPlace):
    pass


class CUDAPinnedPlace(CPUPlace):
    pass


def place_device(place=None) -> torch.device:
    """The torch device of ``place``: a :class:`Place`, a device string or
    ``torch.device``, or ``None`` for the default device."""
    if isinstance(place, Place):
        return place.torch_device()
    return resolve_device(place)


def place_of(device: torch.device) -> Place:
    """The :class:`Place` of a torch device."""
    if device.type == "cuda":
        return CUDAPlace(device.index or 0)
    return CPUPlace(device.index or 0)


_KINDS = {"tpu": "cuda", "gpu": "cuda", "cuda": "cuda", "xpu": "cuda",
          "cpu": "cpu"}


def set_device(device: str) -> Place:
    """``"gpu"``, ``"gpu:0"``, ``"cuda"``, ``"tpu"`` (the card) or
    ``"cpu"``: the device of everything later made without one (tensors,
    parameters, the ops' outputs)."""
    kind, _, idx = str(device).partition(":")
    kind = kind.lower()
    if kind not in _KINDS:
        raise ValueError(f"Unknown device {device!r}")
    idx = int(idx) if idx else 0
    if _KINDS[kind] == "cpu":
        set_default_device("cpu")
        return CPUPlace(idx)
    set_default_device(torch.device("cuda", idx))
    return CUDAPlace(idx)


def get_device() -> str:
    """``"gpu:<i>"`` on the card, ``"cpu"`` after ``set_device("cpu")``;
    raises, as every entry point does, when neither is available."""
    dev = resolve_device(None)
    if dev.type == "cuda":
        return f"gpu:{dev.index or 0}"
    return "cpu"


def device_count(device_type: str = "tpu") -> int:
    """The number of cards (``"tpu"``, ``"gpu"``, ``"cuda"``), at least
    1 as in the JAX package; 1 for the CPU."""
    if _KINDS.get(device_type.lower(), "cuda") == "cpu":
        return 1
    return torch.cuda.device_count() or 1


def is_compiled_with_cuda() -> bool:
    return True


def is_compiled_with_tpu() -> bool:
    return False


def get_default_place() -> Place:
    return place_of(resolve_device(None))

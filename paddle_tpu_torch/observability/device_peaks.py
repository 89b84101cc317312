"""Device peak rates (port of ``paddle_tpu/observability/
device_peaks.py``'s ``peaks_for``): the denominators of the decode
engine's ``mfu`` gauge. One row, the card the port runs on: the NVIDIA
H100 SXM's data-sheet peaks, 989 TFLOP/s of dense bf16 on the tensor
cores and 3.35 TB/s of device memory (rates at the full 700 W power
limit; a card set lower runs slower). Matching is by lowercased
substring of the device name (``torch.cuda.get_device_name``); an
unknown device resolves to ``None`` (the engine then gauges mfu 0),
never to a guess. Stdlib only."""
from __future__ import annotations

from typing import NamedTuple, Optional

__all__ = ["DevicePeak", "DEVICE_PEAKS", "peaks_for"]


class DevicePeak(NamedTuple):
    """A card's peaks: bf16 FLOP/s and device-memory bytes/s."""

    kind: str
    flops: float            # peak dense bf16 FLOP/s
    hbm_bytes_per_s: float  # device-memory bytes/s


# (device name substring, bf16 dense FLOP/s, device memory GB/s)
DEVICE_PEAKS = (
    ("h100", 989e12, 3350.0),
)


def peaks_for(kind: str) -> Optional[DevicePeak]:
    """The peaks of the device named ``kind``; None when unknown."""
    k = (kind or "").lower()
    return next((DevicePeak(sub, fl, bw * 1e9)
                 for sub, fl, bw in DEVICE_PEAKS if sub in k), None)

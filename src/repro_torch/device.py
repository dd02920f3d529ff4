"""Device resolution shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a
``device`` of ``None`` means ``"cuda"``, and asking for CUDA on a
machine without a usable card raises instead of quietly running on the
CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


class NoCudaDeviceError(RuntimeError):
    """CUDA was asked for (or defaulted to) but no card is available."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain torch versions "
            "of the kernels on the CPU")
    return dev


def device_info(device: torch.device) -> dict:
    """Where a measurement ran: ``backend`` (``"cuda"`` or ``"cpu"``),
    ``device`` (the card's name, or ``"cpu"``) and, on a card,
    ``power_limit`` as ``nvidia-smi`` reports it (``None`` where
    ``nvidia-smi`` cannot be run). A time taken on the CPU through the
    kernels' plain versions carries ``backend: "cpu"``, so it is never
    read as the card's."""
    if device.type != "cuda":
        return {"backend": "cpu", "device": "cpu", "power_limit": None}
    import subprocess
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=30)
        limit = smi.stdout.strip() if smi.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"backend": "cuda",
            "device": torch.cuda.get_device_name(index),
            "power_limit": limit or None}

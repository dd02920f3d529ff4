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


"""Argument checks and launch plumbing shared by the kernel wrappers."""
from __future__ import annotations

import torch

INT32_INDEX_LIMIT = 1 << 31


def check_tensor(name: str, t: torch.Tensor, device: torch.device,
                 ndim: int, dtype: torch.dtype) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous ``ndim``-D
    ``dtype`` tensor on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.numel() >= INT32_INDEX_LIMIT:
        raise ValueError(f"{name}: {t.numel()} elements exceed the "
                         "kernels' int32 indexing")


def check_int32(name: str, t: torch.Tensor, device: torch.device,
                ndim: int) -> None:
    check_tensor(name, t, device, ndim, torch.int32)


def words_to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 view of the same 32 bits
    (torch has no uint32 arithmetic on CUDA; packed words travel as
    int32, as the reference passes them)."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def require_cuda(device: torch.device, kernel: str) -> None:
    if device.type != "cuda":
        raise ValueError(f"{kernel}: tensors on {device}; the kernel runs "
                         "on CUDA and the plain version on the CPU")


def stream_of(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of torch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream

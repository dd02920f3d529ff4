"""Argument checks and launch plumbing shared by the kernel wrappers,
and the plain arithmetic rules shared by the plain versions and the
model layers (``models/layers.py``): the reference's mask value, its
softmax, and the CPU rule for a bfloat16 product."""
from __future__ import annotations

import torch

INT32_INDEX_LIMIT = 1 << 31
NEG = -1e30                   # the reference's mask value


def cpu_low_precision(t: torch.Tensor) -> bool:
    """A bfloat16 or float16 tensor on the CPU, whose products take the
    float32 rule of ``einsum``."""
    return t.device.type == "cpu" and t.dtype in (torch.bfloat16,
                                                  torch.float16)


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the operands' type; a bfloat16 product on the
    CPU in float32, rounded once, as XLA's CPU backend computes it
    (torch's own CPU bfloat16 GEMM differs from it in the last bit of
    some products)."""
    if cpu_low_precision(ops[0]):
        return torch.einsum(eq, *(o.float() for o in ops)).to(ops[0].dtype)
    return torch.einsum(eq, *ops)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: exp(x - max) / sum (torch's
    own softmax multiplies by the sum's reciprocal)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


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

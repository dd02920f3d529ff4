"""Wrapper of the fanin_matmul kernel (``csrc/fanin_matmul.cu``).

Checks types, shapes and devices, allocates the output and launches the
kernel on torch's current stream for CUDA tensors, or runs the plain
version (``ref.py``) for CPU tensors; counts its launches in
``.launches``. ``x``, ``w`` and ``bias`` are each float32, bfloat16 or
float16, mixed as the reference kernel takes them: each product in
``torch.promote_types(x, w)`` (JAX's promotion gives the same type for
these three), summed in float32, the bias added in float32, the output
in x's type. On the card a ``w`` or ``bias`` of another type than x's
is cast to float32 first, which rounds nothing (the kernel's note says
why the products then round as the reference's). Indices follow the reference
kernel: one in ``[-n_in, 0)`` wraps, any other outside ``[0, n_in)``
makes its output NaN; the kernel checks each index as it gathers.
``plan_fanin`` sizes the launch.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from .. import build
from ..common import check_int32, check_tensor, require_cuda, stream_of
from ..spec import DEFAULT_SMEM_BUDGET
from .ref import fanin_matmul_ref

MIN_BLOCKS = 128           # blocks a launch aims for (132 SMs)
BAR_BYTES = 16             # the mbarrier before the staged rows
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@dataclasses.dataclass(frozen=True)
class FaninPlan:
    """One launch: ``rows`` (1 or 2) batch rows and ``span`` neurons a
    block, the rows staged in ``smem_bytes`` of shared memory
    (``staged``) or gathered from device memory."""

    staged: bool
    rows: int
    span: int
    smem_bytes: int


def staged_bytes(rows: int, n_in: int, dtype: torch.dtype) -> int:
    """Shared memory of a block that stages ``rows`` rows of x: the
    mbarrier, the rows' bytes rounded up to 16, and 16 more, so the copy
    keeps their address mod 16."""
    row = n_in * torch.empty((), dtype=dtype).element_size()
    return BAR_BYTES + -(-rows * row // 16) * 16 + 16


@functools.lru_cache(maxsize=256)
def plan_fanin(b: int, n_in: int, n: int, dtype: torch.dtype) -> FaninPlan:
    """The launch of ``b`` rows of ``n_in`` inputs through ``n`` neurons
    in ``dtype`` (the fanin does not change it: a thread holds eight
    terms in registers at a time).

    A block stages its rows of x in shared memory when a row fits the
    227 KB budget, else gathers them from device memory. It takes 2 rows
    where that still gives ``MIN_BLOCKS`` blocks (and 2 rows fit), else
    1. Where the row blocks are fewer than ``MIN_BLOCKS``, the neurons
    are split over more blocks, in spans of whole warps."""
    budget = DEFAULT_SMEM_BUDGET
    staged = staged_bytes(1, n_in, dtype) <= budget
    rows = (2 if -(-b // 2) >= MIN_BLOCKS
            and (not staged or staged_bytes(2, n_in, dtype) <= budget) else 1)
    splits = max(1, min(-(-n // 32), -(-MIN_BLOCKS // -(-b // rows))))
    span = -(-(-(-n // splits)) // 32) * 32
    return FaninPlan(staged, rows, span,
                     staged_bytes(rows, n_in, dtype) if staged else 0)


def fanin_matmul(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """FCP-sparse linear: x (B, n_in), idx / w (N, K), bias (N,) ->
    (B, N) in x's type. ``idx`` is cast to int32."""
    dev = x.device
    for name, t in (("x", x), ("w", w), ("bias", bias)):
        if t.dtype not in DTYPE_CODES:
            raise ValueError(f"{name}: expected float32, bfloat16 or "
                             f"float16, got {t.dtype}")
    idx = idx.to(device=dev, dtype=torch.int32).contiguous()
    check_tensor("x", x, dev, 2, x.dtype)
    check_int32("idx", idx, dev, 2)
    check_tensor("w", w, dev, 2, w.dtype)
    check_tensor("bias", bias, dev, 1, bias.dtype)
    b, n_in = x.shape
    n, k = idx.shape
    if w.shape != (n, k) or bias.shape != (n,):
        raise ValueError(f"w {tuple(w.shape)} and bias {tuple(bias.shape)} "
                         f"do not match idx {tuple(idx.shape)}")
    if dev.type == "cpu":
        return fanin_matmul_ref(x, idx, w, bias)
    require_cuda(dev, "fanin_matmul")
    out = torch.empty((b, n), dtype=x.dtype, device=dev)
    check_tensor("out", out, dev, 2, x.dtype)
    if b == 0 or n == 0:
        return out
    if w.dtype != x.dtype:
        w = w.float()
    if bias.dtype != x.dtype:
        bias = bias.float()
    return launch_plan(x, idx, w, bias, out,
                       plan_fanin(b, n_in, n, x.dtype))


def launch_plan(x, idx, w, bias, out, plan: FaninPlan) -> torch.Tensor:
    """Launch the kernel under ``plan`` on operands that ``fanin_matmul``
    has checked (CUDA tensors; ``w`` and ``bias`` of x's type or
    float32), into ``out``; the wrapper passes ``plan_fanin``'s plan, a
    measurement may pass another."""
    b, n_in = x.shape
    n, k = idx.shape
    for name, t in (("w", w), ("bias", bias)):
        if t.dtype not in (x.dtype, torch.float32):
            raise ValueError(f"{name}: the kernel takes x's type or "
                             f"float32, got {t.dtype}")
    build.launch("fanin_matmul",
        x.data_ptr(), idx.data_ptr(), w.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, n_in, n, k, DTYPE_CODES[x.dtype],
        int(w.dtype != x.dtype), int(bias.dtype != x.dtype), plan.rows,
        int(plan.staged), plan.span, plan.smem_bytes, stream_of(x.device))
    fanin_matmul.launches += 1
    return out


fanin_matmul.launches = 0

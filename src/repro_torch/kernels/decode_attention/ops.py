"""Wrapper of the decode_attention kernel (``csrc/decode_attention.cu``):
one query token's attention over the serving ring KV cache, read where
it lies and only at its valid slots.

  decode_attention — q (B, 1, H, dh); the layer's ring caches k, v (B, W,
                     KV, dh); cache_positions (B, W), the position each
                     ring slot holds (-1: empty); positions (B,), each
                     row's current position; ``window`` > 0 keeps a
                     row's last ``window`` positions. Returns (B, 1, H,
                     dh) in q's type. Counts its launches in
                     ``.launches`` and keeps the last launch's splits of
                     the ring in ``.splits``.

Takes q, k and v of one type (float32 or bfloat16 on the card; float64
too in the plain version, as the exact value), positions int32 (int64
too in the plain version), H a multiple of KV and 1 <= dh <= 256
(``MAX_DH``), on either device. A CPU tensor runs the plain version
(``ref.py``). A CUDA tensor launches the kernel on torch's current
stream, with the same checks plus contiguous operands and W <=
``MAX_W``; the wrapper allocates the output and, for a split ring, the
float32 partials. Nothing falls back to the plain version: a shape the
kernel does not take raises.
"""
from __future__ import annotations

import math

import torch

from .. import build
from ..common import require_cuda, stream_of
from .ref import decode_attention_ref

MAX_DH = 256
MAX_W = 1 << 16              # ring slots (the kernel's bitmap of them)
ROWS = 16                    # query heads a block: the mma tile's rows
SMS = 132                    # the H100's SMs
TARGET_BLOCKS = 3 * SMS      # blocks a launch aims for
MAX_SPLITS = 64
MAX_GRID_YZ = 65535
DTYPES = (torch.float32, torch.bfloat16)
PLAIN_DTYPES = DTYPES + (torch.float64,)
POSITION_DTYPES = (torch.int32,)                 # what init_cache makes
PLAIN_POSITION_DTYPES = POSITION_DTYPES + (torch.int64,)

Tensor = torch.Tensor


def tile_keys(dtype: torch.dtype) -> int:
    """Ring slots a tile of the kernel: 64 in bf16, 32 in float32."""
    return 64 if dtype == torch.bfloat16 else 32


def split_count(b: int, kv: int, g: int, w: int, dtype: torch.dtype) -> int:
    """Splits of each row's ring, a function of the shapes alone: enough
    that the (row, KV head, 16-head chunk) pairs make TARGET_BLOCKS
    blocks, at most one a tile of W and MAX_SPLITS."""
    pairs = b * kv * -(-g // ROWS)
    tiles = -(-w // tile_keys(dtype))
    return max(1, min(-(-TARGET_BLOCKS // pairs), tiles, MAX_SPLITS))


def _check(q: Tensor, k: Tensor, v: Tensor, cache_positions: Tensor,
           positions: Tensor) -> None:
    named = (("q", q), ("k_cache", k), ("v_cache", v),
             ("cache_positions", cache_positions), ("positions", positions))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, expected {q.device}")
    card = q.device.type == "cuda"
    dtypes = DTYPES if card else PLAIN_DTYPES
    if q.dtype not in dtypes:
        raise ValueError(f"q: expected one of {dtypes}, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"k_cache {k.dtype} and v_cache {v.dtype} are not "
                         f"q's {q.dtype}")
    allowed = POSITION_DTYPES if card else PLAIN_POSITION_DTYPES
    for name, t in named[3:]:
        if t.dtype not in allowed:
            raise ValueError(f"{name}: expected one of {allowed}, got "
                             f"{t.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} and k_cache {tuple(k.shape)} "
                         "are not (B, 1, H, dh) and (B, W, KV, dh)")
    b, _, h, dh = q.shape
    w, kv = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != dh or v.shape != k.shape
            or kv == 0 or h % kv):
        raise ValueError(f"q {tuple(q.shape)}, k_cache {tuple(k.shape)} and "
                         f"v_cache {tuple(v.shape)} are not (B, 1, H, dh) "
                         "and (B, W, KV, dh) with H % KV == 0")
    if tuple(cache_positions.shape) != (b, w) or \
            tuple(positions.shape) != (b,):
        raise ValueError(f"cache_positions {tuple(cache_positions.shape)} and "
                         f"positions {tuple(positions.shape)} are not "
                         f"({b}, {w}) and ({b},)")
    if w == 0:
        raise ValueError("attention over zero ring slots")
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"the kernel takes 1 <= dh <= {MAX_DH}, got {dh}")
    if not card:
        return
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if w > MAX_W:
        raise ValueError(f"the kernel takes W <= {MAX_W} ring slots, got {w}")
    if b > MAX_GRID_YZ or kv * -(-(h // kv) // ROWS) > MAX_GRID_YZ:
        raise ValueError(f"B {b} or the KV heads' blocks exceed the grid")


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     cache_positions: Tensor, positions: Tensor,
                     window: int = 0) -> Tensor:
    """Attention of each row's one query token over its ring cache:
    q (B, 1, H, dh), caches (B, W, KV, dh), cache_positions (B, W),
    positions (B,) -> (B, 1, H, dh) in q's type."""
    _check(q, k_cache, v_cache, cache_positions, positions)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, cache_positions,
                                    positions, window=window)
    require_cuda(q.device, "decode_attention")
    b, _, h, dh = q.shape
    w, kv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    splits = split_count(b, kv, h // kv, w, q.dtype)
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((b, h, splits, dh), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((b, h, splits, 2), dtype=torch.float32,
                              device=q.device)
    build.launch(
        "decode_attention", q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), cache_positions.data_ptr(), positions.data_ptr(),
        out.data_ptr(), None if part_o is None else part_o.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), b, w, h, kv, dh,
        splits, int(window), 1.0 / math.sqrt(dh),
        int(q.dtype == torch.bfloat16), stream_of(q.device))
    decode_attention.launches += 1
    decode_attention.splits = splits
    return out


decode_attention.launches = 0
decode_attention.splits = 0

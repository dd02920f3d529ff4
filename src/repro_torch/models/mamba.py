"""Mamba-1 selective SSM mixer (falcon-mamba-7b family; Hymba SSM heads).

The sequence form scans the diagonal linear recurrence
h_t = abar_t * h_{t-1} + bbar_t x_t with the combine
(al·ar, br + ar·bl): a doubling (Hillis-Steele) scan within chunks of
``SCAN_CHUNK`` steps and a sequential carry across chunks, or one
doubling scan over the whole sequence where S <= SCAN_CHUNK or S is not
a multiple of it, as the reference's ``_chunked_linear_scan`` does.
Decode is the O(1)-per-token state update. Plain torch on every device:
the scan has no kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import einsum, matmul, ninit, silu

Tensor = torch.Tensor

SCAN_CHUNK = 256


def init_mamba(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, Tensor]:
    d = cfg.d_model
    di, n, r, cw = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_, cfg.ssm_conv
    dev, f32 = gen.device, torch.float32
    # S4D-real initialisation of A
    a = torch.arange(1, n + 1, dtype=f32, device=dev).expand(di, n)
    return {
        "in_proj": ninit(gen, (d, 2 * di), 1 / math.sqrt(d)),
        "conv_w": ninit(gen, (cw, di), 1 / math.sqrt(cw)),
        "conv_b": torch.zeros((di,), dtype=f32, device=dev),
        "x_proj": ninit(gen, (di, r + 2 * n), 1 / math.sqrt(di)),
        "dt_proj_w": ninit(gen, (r, di), 1 / math.sqrt(r)),
        "dt_proj_b": torch.log(torch.expm1(  # softplus^-1 of dt = 0.01
            torch.full((di,), 0.01, dtype=f32, device=dev))),
        "A_log": torch.log(a),
        "D": torch.ones((di,), dtype=f32, device=dev),
        "out_proj": ninit(gen, (di, d), 1 / math.sqrt(di)),
    }


def _doubling_scan(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Inclusive scan of the pairs (a_t, b_t) along axis 1 under the
    combine (al·ar, br + ar·bl), in ceil(log2 S) passes."""
    s, d = a.shape[1], 1
    while d < s:
        a, b = (torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1),
                torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]],
                          dim=1))
        d *= 2
    return a, b


def _chunked_linear_scan(abar: Tensor, bx: Tensor,
                         chunk: int = SCAN_CHUNK) -> Tensor:
    """Cumulative h_t = abar_t * h_{t-1} + bx_t along axis 1 (h_0 = 0)."""
    s = abar.shape[1]
    if s <= chunk or s % chunk != 0:
        return _doubling_scan(abar, bx)[1]
    carry = torch.zeros_like(abar[:, 0])
    out = []
    for i in range(0, s, chunk):
        a_cum, b_cum = _doubling_scan(abar[:, i: i + chunk],
                                      bx[:, i: i + chunk])
        h = a_cum * carry[:, None] + b_cum            # inject carry h0
        carry = h[:, -1]
        out.append(h)
    return torch.cat(out, dim=1)


def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv over S. x: (B, S, Di); w: (CW, Di)."""
    cw = w.shape[0]
    acc = x * w[cw - 1]
    for t in range(1, cw):
        shifted = F.pad(x, (0, 0, t, 0))[:, : x.shape[1]]
        acc = acc + shifted * w[cw - 1 - t]
    return acc + b


def _softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``), operation by operation
    in x's type: max(x, 0) + log1p(exp(-|x|))."""
    return (torch.maximum(x, torch.zeros_like(x))
            + torch.log1p(torch.exp(-x.abs())))


def _ssm_params(p, xz: Tensor, cfg: ArchConfig):
    """Common projections. xz: (..., Di) post-conv activations."""
    n, r = cfg.ssm_state, cfg.dt_rank_
    dt = xz.dtype
    proj = matmul(xz, p["x_proj"])                            # (..., r+2n)
    dt_r, b_ssm, c_ssm = torch.split(proj, [r, n, proj.shape[-1] - r - n],
                                     dim=-1)
    delta = _softplus(matmul(dt_r, p["dt_proj_w"])
                      + p["dt_proj_b"].to(dt))                # (..., Di)
    return delta, b_ssm, c_ssm


def mamba_forward(x: Tensor, p, cfg: ArchConfig, return_state: bool = False):
    """x: (B, S, D) -> (B, S, D) [, final (ssm, conv) states].

    The conv state is the last ``ssm_conv - 1`` pre-conv inputs; a
    prompt shorter than that gives a shorter state, as in the reference
    (ROADMAP, "Reference caveats")."""
    dt = x.dtype
    xz = matmul(x, p["in_proj"])                              # (B, S, 2Di)
    xs_raw, z = xz.chunk(2, dim=-1)
    xs = _causal_conv(xs_raw, p["conv_w"].to(dt), p["conv_b"].to(dt))
    xs = silu(xs)

    delta, b_ssm, c_ssm = _ssm_params(p, xs, cfg)
    a = -torch.exp(p["A_log"].float())                        # (Di, N)
    abar = torch.exp(delta.float()[..., None] * a)            # (B,S,Di,N)
    bx = (delta[..., None] * b_ssm[..., None, :]
          * xs[..., None]).float()                            # (B,S,Di,N)
    h = _chunked_linear_scan(abar, bx)
    y = einsum("bsdn,bsn->bsd", h.to(dt), c_ssm)
    y = y + xs * p["D"].to(dt)
    y = y * silu(z)
    out = matmul(y, p["out_proj"])
    if return_state:
        cw = cfg.ssm_conv
        conv_tail = xs_raw[:, -(cw - 1):]                     # (B, CW-1, Di)
        return out, {"ssm": h[:, -1], "conv": conv_tail}
    return out


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device=None) -> Dict[str, Tensor]:
    di, n, cw = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "ssm": torch.zeros((batch, di, n), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cw - 1, di), dtype=dtype, device=device),
    }


def mamba_step(x: Tensor, cache: Dict[str, Tensor], p, cfg: ArchConfig
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Single-token decode. x: (B, D) -> (B, D), updated cache (new
    tensors; ``cache`` is not written)."""
    dt = x.dtype
    xz = matmul(x, p["in_proj"])
    xs, z = xz.chunk(2, dim=-1)                               # (B, Di)
    # conv ring: history (B, CW-1, Di)
    hist = cache["conv"]
    w = p["conv_w"].to(dt)                                    # (CW, Di)
    acc = xs * w[-1]
    cw = w.shape[0]
    for t in range(1, cw):
        acc = acc + hist[:, cw - 1 - t] * w[cw - 1 - t]
    xs_c = silu(acc + p["conv_b"].to(dt))
    new_hist = torch.cat([hist[:, 1:], xs[:, None]], dim=1)

    delta, b_ssm, c_ssm = _ssm_params(p, xs_c, cfg)           # (B, Di), (B,N)
    a = -torch.exp(p["A_log"].float())
    abar = torch.exp(delta.float()[..., None] * a)            # (B, Di, N)
    bx = (delta[..., None] * b_ssm[:, None, :] * xs_c[..., None]).float()
    h = abar * cache["ssm"] + bx                              # (B, Di, N)
    y = einsum("bdn,bn->bd", h.to(dt), c_ssm)
    y = y + xs_c * p["D"].to(dt)
    y = y * silu(z)
    out = matmul(y, p["out_proj"])
    return out, {"ssm": h, "conv": new_hist}

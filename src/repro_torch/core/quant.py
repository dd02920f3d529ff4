"""Quantization-aware training primitives (NullaNet Tiny §QAT), in torch.

The paper's per-layer activation selection: a signed quantizer
(``sign`` / bipolar / symmetric multi-bit) where a layer's inputs take
both signs, PACT (parameterized clipping activation) where they are
non-negative.

Every quantizer is differentiable through straight-through estimators
(STE): ``ste_round`` / ``ste_floor`` pass the gradient unchanged,
``sign_ste`` passes it where |x| <= 1 (hard tanh) and ``binary_ste``
where 0 <= x <= 1. ``pact`` and ``signed_uniform`` clip with
``torch.maximum`` / ``torch.minimum``, which give each side half the
gradient at a tie, as the reference's ``jnp.clip`` does, so the
gradients in ``x`` and ``alpha`` at x = 0 and x = +-alpha are the
reference's too.

Each function keeps the reference's float32 operation order
(``repro/core/quant.py``), so that codes agree bit for bit on the same
inputs: ``ste_round``'s forward is ``x + (round(x) - x)``, not
``round(x)``, and ``encode_levels`` computes ``round(x * half / alpha)
+ half`` left to right. ``torch.round`` and ``jnp.round`` both round
half to even.

Subnormal inputs are flushed to (signed) zero where values enter the
quantizers (``apply_act_quant``, ``encode_levels``), as the reference's
XLA CPU build does: ``-1e-40`` quantizes like ``-0.0``, to ``+1``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor


def _as(value, like: Tensor) -> Tensor:
    # ``scalar / tensor`` in torch is ``reciprocal(tensor) * scalar``,
    # which rounds differently from the reference's true division: divide
    # tensors only
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def flush_subnormals(x: Tensor) -> Tensor:
    """Subnormal floats -> zero of the same sign (XLA's denormals-are-zero
    on the CPU), on any device; NaN, infinities and normal floats pass."""
    tiny = torch.finfo(x.dtype).tiny
    return torch.where(x.abs() < tiny, torch.zeros_like(x).copysign(x), x)


def ste_round(x: Tensor) -> Tensor:
    """round(x) in the forward pass, identity gradient."""
    return x + (torch.round(x) - x).detach()


def ste_floor(x: Tensor) -> Tensor:
    """floor(x) in the forward pass, identity gradient."""
    return x + (torch.floor(x) - x).detach()


class _SignSTE(torch.autograd.Function):
    """Bipolar sign forward; the gradient passes where |x| <= 1 (hard
    tanh, Hubara et al.)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (torch.abs(x) <= 1.0).to(g.dtype)


class _BinarySTE(torch.autograd.Function):
    """{0, 1} step forward; the gradient passes where 0 <= x <= 1."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return (x >= 0.5).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * ((x >= 0.0) & (x <= 1.0)).to(g.dtype)


def sign_ste(x: Tensor) -> Tensor:
    """Bipolar sign {-1, +1} (sign(0) is +1), clipped-identity STE."""
    return _SignSTE.apply(x)


def binary_ste(x: Tensor) -> Tensor:
    """Binary {0, 1} step at 0.5, clipped-identity STE on [0, 1]."""
    return _BinarySTE.apply(x)


def pact(x: Tensor, alpha, bits: int) -> Tensor:
    """PACT: clip(x, 0, alpha) quantized to 2^bits levels. The gradient
    reaches ``alpha`` through the clip and through the scale."""
    alpha = _as(alpha, x)
    levels = (1 << bits) - 1
    # maximum(x, 0) gives -0.0 for -0.0 (the reference +0.0; equal)
    y = torch.minimum(torch.maximum(x, torch.zeros_like(alpha)), alpha)
    scale = _as(levels, x) / torch.clamp(alpha, min=1e-8)
    return ste_round(y * scale) / scale


def pact_levels(alpha: float, bits: int) -> np.ndarray:
    """The discrete value set PACT can emit."""
    levels = (1 << bits) - 1
    return (np.arange(levels + 1, dtype=np.float32)
            * np.float32(alpha / levels))


def signed_uniform(x: Tensor, alpha, bits: int) -> Tensor:
    """Symmetric signed quantizer on [-alpha, alpha] with 2^bits - 1
    levels; bits=1 is bipolar sign * alpha."""
    alpha = _as(alpha, x)
    if bits == 1:
        return sign_ste(x) * alpha
    half = (1 << (bits - 1)) - 1
    y = torch.minimum(torch.maximum(x, -alpha), alpha)
    scale = _as(half, x) / torch.clamp(alpha, min=1e-8)
    return ste_round(y * scale) / scale


def signed_levels(alpha: float, bits: int) -> np.ndarray:
    if bits == 1:
        return np.array([-alpha, alpha], dtype=np.float32)
    half = (1 << (bits - 1)) - 1
    return (np.arange(-half, half + 1, dtype=np.float32)
            * np.float32(alpha / half))


def dorefa_weight(w: Tensor, bits: int) -> Tensor:
    """DoReFa-Net weight quantization (Zhou et al. 2016).

    bits=1: sign(w) * E[|w|] (XNOR-Net-style scaling, the scale carries
    no gradient). bits>1: tanh-normalised uniform quantization to
    [-1, 1]."""
    if bits >= 32:
        return w
    if bits == 1:
        return sign_ste(w) * torch.mean(torch.abs(w)).detach()
    t = torch.tanh(w)
    t = t / torch.clamp(torch.amax(torch.abs(t)), min=1e-8)
    u = (t + 1.0) * 0.5
    levels = (1 << bits) - 1
    q = ste_round(u * levels) / levels
    return 2.0 * q - 1.0


@dataclasses.dataclass(frozen=True)
class ActQuantSpec:
    """Per-layer activation quantizer choice.

    kind: 'sign' (bipolar), 'binary' ({0,1}), 'pact' (non-negative
          multi-bit), 'signed' (symmetric multi-bit), 'none'.
    bits: output bit-width (1 for sign/binary).
    """

    kind: str = "sign"
    bits: int = 1

    @property
    def n_levels(self) -> int:
        if self.kind == "none":
            raise ValueError("unquantized activation has no level set")
        if self.kind in ("sign", "binary"):
            return 2
        if self.kind == "pact":
            return 1 << self.bits
        if self.kind == "signed":
            if self.bits == 1:
                return 2
            return 2 * ((1 << (self.bits - 1)) - 1) + 1
        raise ValueError(self.kind)

    @property
    def code_bits(self) -> int:
        """Bits needed to index the level set (for truth-table packing)."""
        return max(1, (self.n_levels - 1).bit_length())

    def levels(self, alpha: float) -> np.ndarray:
        """The level values, float32, indexed by code."""
        if self.kind == "sign":
            return np.array([-alpha, alpha], dtype=np.float32)
        if self.kind == "binary":
            return np.array([0.0, alpha], dtype=np.float32)
        if self.kind == "pact":
            return pact_levels(alpha, self.bits)
        if self.kind == "signed":
            return signed_levels(alpha, self.bits)
        raise ValueError(self.kind)


def select_activation(inputs_nonnegative: bool, bits: int = 1) -> ActQuantSpec:
    """PACT for non-negative ranges, sign/signed for ranges spanning
    both signs."""
    if inputs_nonnegative:
        return (ActQuantSpec("pact", max(bits, 1)) if bits > 1
                else ActQuantSpec("binary", 1))
    return ActQuantSpec("signed", bits) if bits > 1 else ActQuantSpec("sign", 1)


def apply_act_quant(spec: ActQuantSpec, x: Tensor, alpha) -> Tensor:
    """Quantized activation values (forward)."""
    if spec.kind == "none":
        return x
    x = flush_subnormals(x)
    if spec.kind == "sign":
        return sign_ste(x) * _as(alpha, x)
    if spec.kind == "binary":
        return binary_ste(x) * _as(alpha, x)
    if spec.kind == "pact":
        return pact(x, alpha, spec.bits)
    if spec.kind == "signed":
        return signed_uniform(x, alpha, spec.bits)
    raise ValueError(spec.kind)


def encode_levels(spec: ActQuantSpec, x: Tensor, alpha) -> Tensor:
    """Quantized activation values -> int32 level codes [0, n_levels)."""
    xf = flush_subnormals(x.to(torch.float32))
    alpha = _as(alpha, xf)
    if spec.kind == "sign":
        return (xf > 0).to(torch.int32)
    if spec.kind == "binary":
        return (xf > alpha * 0.5).to(torch.int32)
    if spec.kind == "pact":
        levels = (1 << spec.bits) - 1
        return torch.clamp(torch.round(xf * levels / alpha),
                           0, levels).to(torch.int32)
    if spec.kind == "signed":
        if spec.bits == 1:
            return (xf > 0).to(torch.int32)
        half = (1 << (spec.bits - 1)) - 1
        return torch.clamp(torch.round(xf * half / alpha) + half,
                           0, 2 * half).to(torch.int32)
    raise ValueError(spec.kind)


def decode_levels(spec: ActQuantSpec, codes: Tensor, alpha: float) -> Tensor:
    """Integer level codes -> real activation values (float32, on the
    codes' device)."""
    lv = torch.as_tensor(spec.levels(alpha), device=codes.device)
    return lv[codes.long()]


def fold_bn(w: Tensor, b: Tensor, gamma: Tensor, beta: Tensor, mean: Tensor,
            var: Tensor, eps: float = 1e-5):
    """Fold BN(gamma, beta, mean, var) after y = x W^T + b into (w', b')
    so that BN(x W^T + b) == x w'^T + b' (float32, the reference's
    operation order)."""
    inv = gamma / torch.sqrt(var + eps)
    w2 = w * inv[:, None]
    b2 = (b - mean) * inv + beta
    return w2, b2

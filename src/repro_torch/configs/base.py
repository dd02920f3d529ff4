"""Architecture config schema + shape registry of the LM stack.

Every architecture is an ``ArchConfig``; the four LM shape points
(train_4k / prefill_32k / decode_32k / long_500k) are ``ShapeConfig``s.
The dtype policy stays two strings, as in the reference;
``torch_dtype`` maps one to its ``torch.dtype``.

The paper's technique surfaces as first-class knobs:
  quant_bits / quant_weights — QAT (PACT or signed per the paper's
      per-layer activation-selection rule, see core/quant.py)
  fcp_fanin                  — fanin-constrained pruning of MLP weights
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` / ... -> the ``torch.dtype``."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int                  # 0 for attn-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0               # 0 -> d_model // n_heads
    act: str = "swiglu"           # swiglu | relu2 | gelu
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)
    # attention flavour
    window: int = 0               # sliding-window size; 0 = full attention
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    # enc-dec
    n_enc_layers: int = 0         # >0 => encoder-decoder
    cross_attention: bool = False
    # modality frontend stub: 'tokens' | 'frames' (precomputed embeddings)
    frontend: str = "tokens"
    frontend_frames_div: int = 8  # frames = seq_len // div for 'frames'
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # ---- paper technique knobs (QAT + FCP) ----
    quant_bits: int = 0           # 0 = off; activation bits for MLP QAT
    quant_weights: int = 0        # DoReFa weight bits; 0 = off
    fcp_fanin: int = 0            # 0 = off; per-neuron fanin cap on MLP
    # dtype policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # citation tag
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(1, math.ceil(self.d_model / 16))

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, 256)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def n_dec_layers(self) -> int:
        return self.n_layers

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context? (SSM / SWA / hybrid)."""
        return self.family in ("ssm", "hybrid") or self.window > 0

    def supports_shape(self, shape: ShapeConfig) -> bool:
        if shape.name == "long_500k":
            return self.subquadratic
        return True

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        h, kv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        n = 0
        n += v * d                                  # embed
        if not self.tie_embeddings:
            n += d * v                              # head

        def attn_params():
            return d * h * dh + 2 * d * kv * dh + h * dh * d

        def mlp_params():
            mats = 3 if self.act == "swiglu" else 2
            return mats * d * f

        def moe_params():
            mats = 3 if self.act == "swiglu" else 2
            return d * self.n_experts + self.n_experts * mats * d * f

        def mamba_params():
            di, s, r = self.d_inner, self.ssm_state, self.dt_rank_
            return (d * 2 * di + di * self.ssm_conv + di * (r + 2 * s)
                    + r * di + di * s + di + di * d)

        per_layer = 2 * d  # norms
        if self.family == "ssm":
            per_layer += mamba_params()
        elif self.family == "hybrid":
            per_layer += attn_params() + mamba_params() + mlp_params() + 2 * d
        elif self.family == "moe":
            per_layer += attn_params() + moe_params()
        else:
            per_layer += attn_params() + mlp_params()
        n += self.n_layers * per_layer
        if self.is_encdec:
            enc_layer = 2 * d + attn_params() + mlp_params()
            dec_cross = attn_params() + d  # cross-attn + its norm
            n += self.n_enc_layers * enc_layer + self.n_layers * dec_cross
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mats = 3 if self.act == "swiglu" else 2
        inactive = (self.n_experts - self.moe_top_k) * mats * d * f
        return self.param_count() - self.n_layers * inactive


# ---------------------------------------------------------------------------
# Input specs (dry-run stand-ins; zero allocation)
# ---------------------------------------------------------------------------

class TensorSpec(NamedTuple):
    """A model input's shape and dtype, with no data (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, TensorSpec]:
    """A ``TensorSpec`` for every model input of the given shape point,
    by the names the model's entry points take them."""
    B, S = shape.global_batch, shape.seq_len

    def tok(b, s):
        return TensorSpec((b, s), torch.int32)

    def frames(n):
        return TensorSpec((B, n, cfg.d_model), torch.bfloat16)

    specs: Dict[str, TensorSpec] = {}
    if shape.kind in ("train", "prefill"):
        if cfg.is_encdec:
            specs["enc_embeds"] = frames(S // cfg.frontend_frames_div)
            specs["tokens"] = tok(B, S)
        elif cfg.frontend == "frames" and shape.kind == "train":
            specs["frames"] = frames(S)
        else:
            specs["tokens"] = tok(B, S)
        if shape.kind == "train":
            specs["labels"] = tok(B, S)
    else:  # decode: one new token against a seq_len cache
        specs["tokens"] = tok(B, 1)
        specs["positions"] = TensorSpec((B,), torch.int32)
    return specs

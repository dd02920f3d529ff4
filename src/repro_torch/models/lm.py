"""The LM of the port: dense / GQA / SWA / SSM / hybrid decoders.

One parameter schema and four entry points, as in the reference:

  init_params(cfg, generator)             -> Params (an nn.Module)
  forward(cfg, params, tokens)            -> hidden states (prefill form)
  prefill(cfg, params, tokens, max_seq)   -> last-token logits + cache
  decode_step(cfg, params, cache, ...)    -> next-token logits + cache

The reference stacks the layers on a leading L axis and runs them with
``lax.scan``; here ``Params.layers`` is an ``nn.ModuleList`` and a Python
loop runs it. The reference's sharding constraints are no-ops without a
mesh and are left out: ``dist/`` brings placement back (ROADMAP Queue 1).
``decode_step`` writes the cache in place (the reference returns a new
one). The ``moe`` family and the encoder-decoder family raise
``NotImplementedError`` (ROADMAP Queue 1); the training loss waits for
the training slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M

Tensor = torch.Tensor
FAMILIES = ("dense", "ssm", "hybrid")
# the weight matrices cast once to the compute type (``cast_weights_``)
MATRICES = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("w1", "w2", "w3"),
            "mamba": ("in_proj", "x_proj", "dt_proj_w", "out_proj")}


class Params(nn.Module):
    """The reference's parameter pytree as a module: a dict of tensors
    (parameters; ``mask_*`` entries are buffers), dicts (sub-modules) and
    lists of dicts (``nn.ModuleList``), read by key as the reference
    reads its dicts (``p["wq"]``, ``p.get("mask_w1")``, ``"attn" in p``).
    ``prepared`` is set on an MLP whose matrices already carry DoReFa and
    the FCP mask (``cast_weights_``)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self.prepared = False
        for key, v in tree.items():
            if isinstance(v, dict):
                self.add_module(key, Params(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(key, nn.ModuleList(Params(t) for t in v))
            elif key.startswith("mask_"):
                self.register_buffer(key, v)
            else:
                self.register_parameter(key, nn.Parameter(
                    v, requires_grad=False))

    def __contains__(self, key: str) -> bool:
        return (key in self._parameters or key in self._buffers
                or key in self._modules)

    def __getitem__(self, key: str):
        if key not in self:
            raise KeyError(key)
        return getattr(self, key)

    def get(self, key: str, default=None):
        return self[key] if key in self else default

    def keys(self):
        return [*self._parameters, *self._buffers, *self._modules]


def _require_supported(cfg: ArchConfig) -> None:
    if cfg.family == "moe":
        raise NotImplementedError(
            f"{cfg.name}: the moe family is not ported yet (ROADMAP Queue 1:"
            " MoE with dist/)")
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is not ported yet "
            "(ROADMAP Queue 1)")
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_dec_layer(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, Any]:
    d, dev = cfg.d_model, gen.device

    def ones():
        return torch.ones((d,), dtype=torch.float32, device=dev)

    p: Dict[str, Any] = {"ln1": ones()}
    if cfg.family == "ssm":
        p["mamba"] = M.init_mamba(gen, cfg)
        return p
    p["attn"] = L.init_attn(gen, cfg)
    if cfg.family == "hybrid":
        p["mamba"] = M.init_mamba(gen, cfg)
        p["ln_attn_out"] = ones()
        p["ln_mamba_out"] = ones()
    p["ln2"] = ones()
    p["mlp"] = L.init_mlp(gen, cfg)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator) -> Params:
    """Seeded float32 parameters on ``generator.device``."""
    _require_supported(cfg)
    vp, d, dev = cfg.padded_vocab, cfg.d_model, generator.device
    tree: Dict[str, Any] = {
        "embed": L.ninit(generator, (vp, d), 0.02),
        "final_norm": torch.ones((d,), dtype=torch.float32, device=dev),
        "layers": [_init_dec_layer(generator, cfg)
                   for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = L.ninit(generator, (d, vp), 1.0 / math.sqrt(d))
    return Params(tree)


@torch.no_grad()
def cast_weights_(cfg: ArchConfig, params: Params) -> Params:
    """Cast every weight matrix (``embed``, ``lm_head`` and ``MATRICES``)
    to the compute type in place, leaf by leaf, so the float32 copy of a
    leaf is freed before the next is cast. The values are those the
    reference computes at each use; an MLP with ``quant_weights`` or FCP
    masks gets DoReFa and the mask first and is marked ``prepared``.
    Norm scales, ``D``, ``A_log``, ``conv_*`` and ``dt_proj_b`` stay as
    they are. Idempotent."""
    dt = L.cdtype(cfg)

    def cast(mod: Params, name: str, value: Tensor) -> None:
        mod._parameters[name] = nn.Parameter(value.to(dt),
                                             requires_grad=False)

    for name in ("embed", "lm_head"):
        if name in params:
            cast(params, name, params[name])
    for lp in params.layers:
        for sub, names in MATRICES.items():
            if sub not in lp:
                continue
            mod = lp[sub]
            for name in names:
                if name not in mod:
                    continue
                w = mod[name]
                if sub == "mlp" and name != "w3" and not mod.prepared:
                    w = L.effective_weight(w, cfg, mod.get("mask_" + name))
                cast(mod, name, w)
            if sub == "mlp":
                mod.prepared = True
    return params


# ---------------------------------------------------------------------------
# Blocks (sequence / prefill form)
# ---------------------------------------------------------------------------

def _attention_mixer(cfg: ArchConfig, p, x: Tensor, positions: Tensor,
                     window: int = 0):
    """Causal self-attention over x (B, S, D) -> (y, (k, v)); the
    attention itself is ``layers.attention`` (the flash kernel on the
    card)."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.matmul(x, p["wq"]).reshape(b, s, h, dh)
    k = L.matmul(x, p["wk"]).reshape(b, s, kv, dh)
    v = L.matmul(x, p["wv"]).reshape(b, s, kv, dh)
    q = L.apply_rope(q, positions, cfg)
    k = L.apply_rope(k, positions, cfg)
    out = L.attention(q, k, v, causal=True, window=window)
    y = L.matmul(out.reshape(b, s, h * dh), p["wo"])
    return y, (k, v)


def _dec_block(cfg: ArchConfig, p, x: Tensor, positions: Tensor,
               collect_kv: bool):
    """One decoder block. Returns (x, aux): aux carries the layer's K, V
    and SSM states for the prefill cache when ``collect_kv``."""
    eps = cfg.norm_eps
    aux: Dict[str, Tensor] = {}
    hin = L.rms_norm(x, p["ln1"], eps)
    if cfg.family == "ssm":
        y, states = M.mamba_forward(hin, p["mamba"], cfg, return_state=True)
        if collect_kv:
            aux.update(states)
        return x + y, aux
    a_out, (k, v) = _attention_mixer(cfg, p["attn"], hin, positions,
                                     window=cfg.window)
    if cfg.family == "hybrid":
        m_out, states = M.mamba_forward(hin, p["mamba"], cfg,
                                        return_state=True)
        if collect_kv:
            aux.update(states)
        mixed = 0.5 * (L.rms_norm(a_out, p["ln_attn_out"], eps)
                       + L.rms_norm(m_out, p["ln_mamba_out"], eps))
        x = x + mixed
    else:
        x = x + a_out
    if collect_kv:
        aux["k"], aux["v"] = k, v
    h2 = L.rms_norm(x, p["ln2"], eps)
    return x + L.mlp(h2, p["mlp"], cfg), aux


# ---------------------------------------------------------------------------
# Forward (prefill form)
# ---------------------------------------------------------------------------

def forward(cfg: ArchConfig, params: Params, tokens: Tensor,
            collect_kv: bool = False) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Sequence forward over tokens (B, S). Returns (hidden, stack):
    hidden (B, S, D) are the pre-head normalised states; ``stack`` holds,
    when ``collect_kv``, each cache leaf stacked on a leading L axis
    (k, v: (L, B, S, KV, dh); ssm: (L, B, Di, N); conv: (L, B, CW-1, Di)),
    else nothing."""
    _require_supported(cfg)
    x = params["embed"].to(L.cdtype(cfg))[tokens]
    positions = torch.arange(x.shape[1], device=x.device)
    auxes = []
    for lp in params.layers:
        x, aux = _dec_block(cfg, lp, x, positions, collect_kv)
        auxes.append(aux)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    stack = ({key: torch.stack([a[key] for a in auxes]) for key in auxes[0]}
             if collect_kv else {})
    return x, stack


def logits_head(cfg: ArchConfig, params: Params, hidden: Tensor) -> Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.matmul(hidden, head)


# ---------------------------------------------------------------------------
# KV / SSM caches
# ---------------------------------------------------------------------------

def cache_len(cfg: ArchConfig, max_seq: int) -> int:
    """Ring-buffer length: window-bounded for SWA archs."""
    if cfg.window > 0:
        return min(max_seq, cfg.window)
    return max_seq


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device=None) -> Dict[str, Tensor]:
    _require_supported(cfg)
    dt = L.cdtype(cfg)
    ln = cfg.n_layers
    cache: Dict[str, Tensor] = {}
    w = cache_len(cfg, max_seq)
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    if cfg.family != "ssm":
        cache["k"] = torch.zeros((ln, batch, w, kv, dh), dtype=dt,
                                 device=device)
        cache["v"] = torch.zeros_like(cache["k"])
        cache["positions"] = torch.full((batch, w), -1, dtype=torch.int32,
                                        device=device)
    if cfg.family in ("ssm", "hybrid"):
        di, n, cw = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
        cache["ssm"] = torch.zeros((ln, batch, di, n), dtype=torch.float32,
                                   device=device)
        cache["conv"] = torch.zeros((ln, batch, cw - 1, di), dtype=dt,
                                    device=device)
    return cache


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def _attn_step(cfg: ArchConfig, p, x: Tensor, kc: Tensor, vc: Tensor,
               positions: Tensor, slot: Tensor, cpos: Tensor) -> Tensor:
    """One token's attention; writes its K, V into ring slot ``slot`` of
    the layer's caches kc, vc (B, W, KV, dh) in place (the reference's
    one-hot blend gives the same values)."""
    b = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.matmul(x, p["wq"]).reshape(b, 1, h, dh)
    k1 = L.matmul(x, p["wk"]).reshape(b, 1, kv, dh)
    v1 = L.matmul(x, p["wv"]).reshape(b, 1, kv, dh)
    q = L.apply_rope(q, positions[:, None], cfg)
    k1 = L.apply_rope(k1, positions[:, None], cfg)
    rows = torch.arange(b, device=x.device)
    kc[rows, slot] = k1[:, 0]
    vc[rows, slot] = v1[:, 0]
    out = L.decode_attention(q, kc, vc, cpos, positions, window=cfg.window)
    return L.matmul(out.reshape(b, h * dh), p["wo"])


def _mamba_step_into(cfg: ArchConfig, p, x: Tensor, cache, layer: int
                     ) -> Tensor:
    y, ms = M.mamba_step(x, {"ssm": cache["ssm"][layer],
                             "conv": cache["conv"][layer]}, p, cfg)
    cache["ssm"][layer].copy_(ms["ssm"])
    cache["conv"][layer].copy_(ms["conv"])
    return y


def _dec_block_step(cfg: ArchConfig, p, x: Tensor, cache, layer: int,
                    positions: Tensor, slot: Optional[Tensor],
                    cpos: Optional[Tensor]) -> Tensor:
    """Single-token decoder block. x: (B, D)."""
    eps = cfg.norm_eps
    hin = L.rms_norm(x, p["ln1"], eps)
    if cfg.family == "ssm":
        return x + _mamba_step_into(cfg, p["mamba"], hin, cache, layer)
    a_out = _attn_step(cfg, p["attn"], hin, cache["k"][layer],
                       cache["v"][layer], positions, slot, cpos)
    if cfg.family == "hybrid":
        m_out = _mamba_step_into(cfg, p["mamba"], hin, cache, layer)
        x = x + 0.5 * (L.rms_norm(a_out, p["ln_attn_out"], eps)
                       + L.rms_norm(m_out, p["ln_mamba_out"], eps))
    else:
        x = x + a_out
    h2 = L.rms_norm(x, p["ln2"], eps)
    return x + L.mlp(h2, p["mlp"], cfg)


def decode_step(cfg: ArchConfig, params: Params, cache: Dict[str, Tensor],
                tokens: Tensor, positions: Tensor
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One decode step. tokens: (B, 1); positions: (B,). Returns
    (logits (B, Vp), cache), the cache updated in place."""
    _require_supported(cfg)
    x = params["embed"].to(L.cdtype(cfg))[tokens[:, 0]]       # (B, D)
    slot = cpos = None
    if cfg.family != "ssm":
        cpos = cache["positions"]
        slot = positions % cpos.shape[1]
        cpos[torch.arange(x.shape[0], device=x.device), slot] = \
            positions.to(cpos.dtype)
    for i, lp in enumerate(params.layers):
        x = _dec_block_step(cfg, lp, x, cache, i, positions, slot, cpos)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_head(cfg, params, x), cache


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def prefill(cfg: ArchConfig, params: Params, tokens: Tensor,
            max_seq: Optional[int] = None
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Run the full prompt; return (last-token logits, decode cache).

    ``max_seq`` sizes the returned cache (>= prompt length + planned new
    tokens); defaults to the prompt length. Absolute position p lives in
    ring slot p % w; empty slots carry position -1."""
    hidden, stack = forward(cfg, params, tokens, collect_kv=True)
    b, s, _ = hidden.shape
    w = cache_len(cfg, max_seq or s)
    cache: Dict[str, Tensor] = {}
    if cfg.family != "ssm":
        k, v = stack["k"], stack["v"]              # (L, B, S, KV, dh)
        keep = min(s, w)
        pos = torch.arange(s - keep, s, device=k.device)
        slots = pos % w
        kr = k.new_zeros(k.shape[:2] + (w,) + k.shape[3:])
        vr = torch.zeros_like(kr)
        kr[:, :, slots] = k[:, :, s - keep:]
        vr[:, :, slots] = v[:, :, s - keep:]
        cpos = torch.full((b, w), -1, dtype=torch.int32, device=k.device)
        cpos[:, slots] = pos.to(torch.int32)
        cache["k"], cache["v"], cache["positions"] = kr, vr, cpos
    if cfg.family in ("ssm", "hybrid"):
        cache["ssm"] = stack["ssm"]                # (L, B, Di, N)
        cache["conv"] = stack["conv"]              # (L, B, CW-1, Di)
    return logits_head(cfg, params, hidden[:, -1]), cache

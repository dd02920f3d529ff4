"""The LM of the port: dense / GQA / SWA / MoE / SSM / hybrid /
encoder-decoder.

One parameter schema and five entry points, as in the reference:

  init_params(cfg, generator)             -> Params (an nn.Module)
  forward(cfg, params, tokens, ...)       -> hidden states (train/prefill)
  lm_loss(cfg, params, hidden, labels)    -> chunked cross-entropy
  prefill(cfg, params, tokens, ...)       -> last-token logits + cache
  decode_step(cfg, params, cache, ...)    -> next-token logits + cache

The reference stacks the layers on a leading L axis and runs them with
``lax.scan``; here ``Params.layers`` is an ``nn.ModuleList`` and a Python
loop runs it. The reference's sharding constraints (``constrain_*``)
sit at its call sites, ``redistribute`` of placed (DTensor) tensors
under ``dist.shardings.use_mesh`` and no-ops otherwise.
``decode_step`` writes the cache in place (the reference returns a new
one). The encoder-decoder family takes the encoder's input as
``enc_embeds`` (B, F, D), stubbed frame embeddings, as the reference
does.

Training (``repro_torch.train.loop``) differentiates ``forward`` and
``lm_loss`` with autograd, from float32 ``Params`` (never from
``cast_weights_``'d ones). With grad mode on, ``forward`` recomputes each
block in the backward (``torch.utils.checkpoint``), as the reference
wraps each in ``jax.checkpoint``; on the card its attention is then the
flash forward and backward kernels. ``leaves`` lists the trained
tensors in the reference's order of leaves (keys sorted, layers in
order), the FCP masks among them: the reference's train step
differentiates and steps them too, while serving keeps them buffers.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import shardings as sh
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.obs.trace import NULL_SPAN, program_tracer

Tensor = torch.Tensor
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")
LOSS_CHUNK = 512              # sequence chunk for cross-entropy
# the weight matrices cast once to the compute type (``cast_weights_``);
# the MoE router stays float32, the type the reference computes it in
MATRICES = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("w1", "w2", "w3"),
            "mamba": ("in_proj", "x_proj", "dt_proj_w", "out_proj"),
            "moe": ("w1", "w2", "w3"), "cross": ("wq", "wk", "wv", "wo")}


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


def named_leaves(params: Params, prefix: str = "") -> List[Tuple[str, Tensor]]:
    """Every tensor of ``params`` (parameters and the ``mask_*`` buffers)
    as (``::``-joined key, tensor), keys sorted at each level and layers
    in order: the reference's order of leaves, with ``layers`` unstacked
    (``layers::0::attn::wq``)."""
    out: List[Tuple[str, Tensor]] = []
    for key in sorted(params.keys()):
        v = params[key]
        name = prefix + key
        if isinstance(v, nn.ModuleList):
            for i, sub in enumerate(v):
                out += named_leaves(sub, f"{name}::{i}::")
        elif isinstance(v, Params):
            out += named_leaves(v, name + "::")
        else:
            out.append((name, v))
    return out


def leaves(params: Params) -> List[Tensor]:
    """The tensors of ``named_leaves``, in its order."""
    return [t for _, t in named_leaves(params)]


def leaf_names(params: Params) -> List[str]:
    return [name for name, _ in named_leaves(params)]


def reference_ndims(params: Params) -> List[int]:
    """Each leaf's dimensions as the reference's parameter tree has them:
    one more for a leaf of ``layers`` or ``enc_layers``, which the
    reference stacks on a leading layer axis. AdamW decays a leaf of
    ndim >= 2, so the reference decays every per-layer leaf, norm scales
    and biases included (ROADMAP "Reference caveats")."""
    return [t.ndim + (name.startswith(("layers::", "enc_layers::")))
            for name, t in named_leaves(params)]


def require_trainable(params: Params) -> None:
    """Raise unless ``params`` are as ``init_params`` makes them: an MLP
    whose matrices ``cast_weights_`` prepared for serving cannot be
    trained (its DoReFa and FCP mask are folded in)."""
    for mod in params.modules():
        if getattr(mod, "prepared", False):
            raise ValueError("training starts from float32 Params, not "
                             "from cast_weights_'d ones")


def _require_supported(cfg: ArchConfig) -> None:
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
    if cfg.is_encdec:
        p["ln_cross"] = ones()
        p["cross"] = L.init_attn(gen, cfg)
    p["ln2"] = ones()
    if cfg.family == "moe":
        p["moe"] = L.init_moe(gen, cfg)
    else:
        p["mlp"] = L.init_mlp(gen, cfg)
    return p


def _init_enc_layer(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, Any]:
    d, dev = cfg.d_model, gen.device
    return {"ln1": torch.ones((d,), dtype=torch.float32, device=dev),
            "attn": L.init_attn(gen, cfg),
            "ln2": torch.ones((d,), dtype=torch.float32, device=dev),
            "mlp": L.init_mlp(gen, cfg)}


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
    if cfg.is_encdec:
        tree["enc_layers"] = [_init_enc_layer(generator, cfg)
                              for _ in range(cfg.n_enc_layers)]
        tree["enc_norm"] = torch.ones((d,), dtype=torch.float32, device=dev)
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
    Norm scales, the MoE router, ``D``, ``A_log``, ``conv_*`` and
    ``dt_proj_b`` stay as they are. Decoder and encoder layers alike.
    Idempotent."""
    dt = L.cdtype(cfg)

    def cast(mod: Params, name: str, value: Tensor) -> None:
        mod._parameters[name] = nn.Parameter(value.to(dt),
                                             requires_grad=False)

    for name in ("embed", "lm_head"):
        if name in params:
            cast(params, name, params[name])
    for lp in [*params.layers, *params.get("enc_layers", ())]:
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
                     kv_src: Optional[Tensor] = None, causal: bool = True,
                     window: int = 0):
    """Attention of x (B, S, D) over itself (RoPE on q and k) or, for
    cross-attention, over ``kv_src`` (B, F, D) (no RoPE) -> (y, (k, v));
    the attention itself is ``layers.attention`` (the flash kernel on
    the card)."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_src is None else kv_src
    q = sh.whole_heads(L.matmul(x, p["wq"]), h).reshape(b, s, h, dh)
    k = sh.whole_heads(L.matmul(src, p["wk"]), kv).reshape(
        b, src.shape[1], kv, dh)
    v = sh.whole_heads(L.matmul(src, p["wv"]), kv).reshape(
        b, src.shape[1], kv, dh)
    if kv_src is None:
        q = L.apply_rope(q, positions, cfg)
        k = L.apply_rope(k, positions, cfg)
    q = sh.constrain_heads(q)
    k = sh.constrain_heads(k)
    out = sh.constrain_heads(L.attention(q, k, v, causal=causal,
                                         window=window))
    y = L.matmul(out.reshape(b, s, h * dh), p["wo"])
    return y, (k, v)


def _dec_block(cfg: ArchConfig, p, x: Tensor, positions: Tensor,
               enc_out: Optional[Tensor], collect_kv: bool):
    """One decoder block. Returns (x, aux): aux carries the layer's K, V
    and SSM states for the prefill cache when ``collect_kv``."""
    eps = cfg.norm_eps
    aux: Dict[str, Tensor] = {}
    hin = L.rms_norm(x, p["ln1"], eps)
    if cfg.family == "ssm":
        y, states = M.mamba_forward(hin, p["mamba"], cfg, return_state=True)
        if collect_kv:
            aux.update(states)
        return sh.constrain_hidden(x + y), aux
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
    if cfg.is_encdec:
        hc = L.rms_norm(x, p["ln_cross"], eps)
        x = x + _attention_mixer(cfg, p["cross"], hc, positions,
                                 kv_src=enc_out, causal=False)[0]
    x = x + _ffn(cfg, p, L.rms_norm(x, p["ln2"], eps))
    return sh.constrain_hidden(x), aux


def _ffn(cfg: ArchConfig, p, x: Tensor) -> Tensor:
    """The block's MoE or dense MLP."""
    if cfg.family == "moe":
        return L.moe(x, p["moe"], cfg)
    return L.mlp(x, p["mlp"], cfg)


def _enc_block(cfg: ArchConfig, p, x: Tensor, positions: Tensor) -> Tensor:
    eps = cfg.norm_eps
    hin = L.rms_norm(x, p["ln1"], eps)
    x = x + _attention_mixer(cfg, p["attn"], hin, positions,
                             causal=False)[0]
    x = x + L.mlp(L.rms_norm(x, p["ln2"], eps), p["mlp"], cfg)
    return sh.constrain_hidden(x)


# ---------------------------------------------------------------------------
# Forward (prefill form)
# ---------------------------------------------------------------------------

def _remat(fn, *args):
    """``fn(*args)``; with grad mode on, recomputed in the backward
    instead of keeping its activations (the reference's
    ``jax.checkpoint`` of each block). The blocks draw no random
    numbers, so the RNG state is not saved."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def encode(cfg: ArchConfig, params: Params, enc_embeds: Tensor) -> Tensor:
    """Encoder stack over stubbed frame embeddings (B, F, D)."""
    x = enc_embeds.to(L.cdtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in params.enc_layers:
        x = _remat(_enc_block, cfg, lp, x, positions)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def forward(cfg: ArchConfig, params: Params, tokens: Optional[Tensor] = None,
            frames: Optional[Tensor] = None,
            enc_embeds: Optional[Tensor] = None, collect_kv: bool = False
            ) -> Tuple[Tensor, Optional[Tensor], Dict[str, Tensor]]:
    """Sequence forward over tokens (B, S), or over ``frames`` (B, S, D)
    taken as the decoder's input embeddings. Returns (hidden, enc_out,
    stack): hidden (B, S, D) are the pre-head normalised states;
    enc_out the encoder's output over ``enc_embeds`` (encoder-decoder
    family, which needs them; else None); ``stack`` holds, when
    ``collect_kv``, each cache leaf stacked on a leading L axis (k, v:
    (L, B, S, KV, dh); ssm: (L, B, Di, N); conv: (L, B, CW-1, Di)), else
    nothing."""
    _require_supported(cfg)
    dt = L.cdtype(cfg)
    x = sh.constrain_hidden(frames.to(dt) if frames is not None else
                            params["embed"].to(dt)[sh.one_axis_a_dim(tokens)])
    positions = torch.arange(x.shape[1], device=x.device)
    enc_out = None
    if cfg.is_encdec:
        if enc_embeds is None:
            raise ValueError(
                f"{cfg.name}: the encoder-decoder family needs enc_embeds, "
                "the encoder's frame embeddings (B, F, D)")
        enc_out = encode(cfg, params, enc_embeds)
    auxes = []
    for lp in params.layers:
        x, aux = _remat(_dec_block, cfg, lp, x, positions, enc_out,
                        collect_kv)
        auxes.append(aux)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    stack = ({key: torch.stack([a[key] for a in auxes]) for key in auxes[0]}
             if collect_kv else {})
    return x, enc_out, stack


def logits_head(cfg: ArchConfig, params: Params, hidden: Tensor) -> Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.matmul(hidden, head)


def _gold(logits: Tensor, labels: Tensor) -> Tensor:
    """Each row's logit of its label. Placed, each rank gathers from its
    own rows of the logits with the vocab whole (DTensor's gather cannot
    select one column a row over a sharded vocab)."""
    if not sh.is_placed(logits):
        return logits.gather(-1, labels[..., None])[..., 0]
    from torch.distributed.tensor import DTensor
    mesh = logits.device_mesh
    rows = sh.to_placements(mesh, sh._prune_spec(
        mesh, tuple(labels.shape), (sh.batch_axes(), None)))
    gold = sh.to_local(logits, mesh, rows).gather(
        -1, sh.to_local(labels, mesh, rows)[..., None])[..., 0]
    return DTensor.from_local(gold, mesh, rows)


def lm_loss(cfg: ArchConfig, params: Params, hidden: Tensor,
            labels: Tensor) -> Tensor:
    """Chunked cross-entropy: never materialises (B, S, V) logits.

    Sequence chunks of LOSS_CHUNK: each chunk's logits are float32
    (B, chunk, Vp) from the compute-type product, the padded-vocab
    columns masked with -1e30; the sum of logsumexp - gold over chunks,
    divided by B * S (a float32 tensor, as the reference divides in
    float32)."""
    b, s, _ = hidden.shape
    vp, v = cfg.padded_vocab, cfg.vocab_size
    chunk = min(LOSS_CHUNK, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the loss "
                         f"chunk {chunk}")
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    dev = hidden.device
    pad = None
    if vp > v:
        pad = torch.cat([torch.zeros((v,), dtype=torch.float32, device=dev),
                         torch.full((vp - v,), L.NEG, dtype=torch.float32,
                                    device=dev)])
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for c in range(s // chunk):
        hk = hidden[:, c * chunk:(c + 1) * chunk]
        lk = labels[:, c * chunk:(c + 1) * chunk].long()
        logits = sh.constrain_logits(L.matmul(hk, head).float())
        if pad is not None:
            logits = logits + pad
        lse = torch.logsumexp(logits, dim=-1)
        gold = _gold(logits, lk)
        total = total + torch.sum(lse - gold)
    return total / torch.full((), b * s, dtype=torch.float32, device=dev)


# ---------------------------------------------------------------------------
# KV / SSM caches
# ---------------------------------------------------------------------------

def cache_len(cfg: ArchConfig, max_seq: int) -> int:
    """Ring-buffer length: window-bounded for SWA archs."""
    if cfg.window > 0:
        return min(max_seq, cfg.window)
    return max_seq


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               enc_frames: int = 0, device=None) -> Dict[str, Tensor]:
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
    if cfg.is_encdec:
        cache["enc_out"] = torch.zeros((batch, enc_frames, cfg.d_model),
                                       dtype=dt, device=device)
    return cache


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def _ring_hit(w: int, slot: Tensor) -> Tensor:
    """(B, W): each row's ring slot ``slot``."""
    return torch.arange(w, device=slot.device) == slot[:, None]


def _attn_step(cfg: ArchConfig, p, x: Tensor, kc: Tensor, vc: Tensor,
               positions: Tensor, slot: Tensor, cpos: Tensor,
               layer: int = 0) -> Tensor:
    """One token's attention; writes its K, V into ring slot ``slot`` of
    the layer's caches kc, vc (B, W, KV, dh) in place (the reference's
    one-hot blend gives the same values, and is what a placed cache
    takes: DTensor has no in-place indexed write into a sharded
    ring). The attention over the ring is the program tracer's
    ``lm.decode_attention`` span (args ``layer``, with a device
    interval)."""
    b = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = sh.whole_heads(L.matmul(x, p["wq"]), h).reshape(b, 1, h, dh)
    k1 = sh.whole_heads(L.matmul(x, p["wk"]), kv).reshape(b, 1, kv, dh)
    v1 = sh.whole_heads(L.matmul(x, p["wv"]), kv).reshape(b, 1, kv, dh)
    q = L.apply_rope(q, positions[:, None], cfg)
    k1 = L.apply_rope(k1, positions[:, None], cfg)
    if sh.is_placed(kc):
        hit = _ring_hit(kc.shape[1], slot)[:, :, None, None]
        kc.copy_(torch.where(hit, k1, kc))
        vc.copy_(torch.where(hit, v1, vc))
    else:
        rows = torch.arange(b, device=x.device)
        kc[rows, slot] = k1[:, 0]
        vc[rows, slot] = v1[:, 0]
    tr = program_tracer()
    with (tr.span("lm.decode_attention", args={"layer": layer},
                  device=q.device) if tr.enabled else NULL_SPAN):
        out = L.decode_attention(q, kc, vc, cpos, positions,
                                 window=cfg.window)
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
    """Single-token decoder block. x: (B, D). Cross-attention reads the
    cache's ``enc_out`` and recomputes its K, V each step, as the
    reference does."""
    eps = cfg.norm_eps
    hin = L.rms_norm(x, p["ln1"], eps)
    if cfg.family == "ssm":
        return x + _mamba_step_into(cfg, p["mamba"], hin, cache, layer)
    a_out = _attn_step(cfg, p["attn"], hin, cache["k"][layer],
                       cache["v"][layer], positions, slot, cpos, layer)
    if cfg.family == "hybrid":
        m_out = _mamba_step_into(cfg, p["mamba"], hin, cache, layer)
        x = x + 0.5 * (L.rms_norm(a_out, p["ln_attn_out"], eps)
                       + L.rms_norm(m_out, p["ln_mamba_out"], eps))
    else:
        x = x + a_out
    if cfg.is_encdec:
        hc = L.rms_norm(x, p["ln_cross"], eps)
        y, _ = _attention_mixer(cfg, p["cross"], hc[:, None], positions,
                                kv_src=cache["enc_out"], causal=False)
        x = x + y[:, 0]
    return x + _ffn(cfg, p, L.rms_norm(x, p["ln2"], eps)[:, None])[:, 0]


def decode_step(cfg: ArchConfig, params: Params, cache: Dict[str, Tensor],
                tokens: Tensor, positions: Tensor
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One decode step. tokens: (B, 1); positions: (B,). Returns
    (logits (B, Vp), cache), the cache updated in place."""
    _require_supported(cfg)
    x = sh.constraint(params["embed"].to(L.cdtype(cfg))[
        sh.one_axis_a_dim(tokens)[:, 0]], sh.batch_axes(), None)  # (B, D)
    slot = cpos = None
    if cfg.family != "ssm":
        cpos = cache["positions"]
        slot = positions % cpos.shape[1]
        if sh.is_placed(cpos):
            cpos.copy_(torch.where(_ring_hit(cpos.shape[1], slot),
                                   positions[:, None].to(cpos.dtype), cpos))
        else:
            cpos[torch.arange(x.shape[0], device=x.device), slot] = \
                positions.to(cpos.dtype)
    for i, lp in enumerate(params.layers):
        x = _dec_block_step(cfg, lp, x, cache, i, positions, slot, cpos)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_head(cfg, params, x), cache


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def _ring_gather(k: Tensor, pos: Tensor, w: int) -> Tensor:
    """The ring (L, B, W, KV, dh) of the kept positions ``pos`` of a
    placed stack k (L, B, S, KV, dh), read slot by slot (DTensor has no
    indexed write into a placed ring); empty slots are zero."""
    src = torch.full((w,), -1, dtype=torch.long, device=pos.device)
    src[pos % w] = pos
    ring = k.index_select(2, torch.clamp(src, min=0))
    return torch.where((src >= 0)[:, None, None], ring,
                       torch.zeros((), dtype=k.dtype, device=k.device))


def prefill(cfg: ArchConfig, params: Params, tokens: Optional[Tensor] = None,
            frames: Optional[Tensor] = None,
            enc_embeds: Optional[Tensor] = None,
            max_seq: Optional[int] = None
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Run the full prompt; return (last-token logits, decode cache).

    ``max_seq`` sizes the returned cache (>= prompt length + planned new
    tokens); defaults to the prompt length. Absolute position p lives in
    ring slot p % w; empty slots carry position -1. The encoder-decoder
    family keeps the encoder's output as the cache's ``enc_out``."""
    hidden, enc_out, stack = forward(cfg, params, tokens, frames, enc_embeds,
                                     collect_kv=True)
    b, s, _ = hidden.shape
    w = cache_len(cfg, max_seq or s)
    cache: Dict[str, Tensor] = {}
    if cfg.family != "ssm":
        k, v = stack["k"], stack["v"]              # (L, B, S, KV, dh)
        keep = min(s, w)
        pos = torch.arange(s - keep, s, device=k.device)
        slots = pos % w
        if sh.is_placed(k):
            kr, vr = _ring_gather(k, pos, w), _ring_gather(v, pos, w)
        else:
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
    if cfg.is_encdec:
        cache["enc_out"] = enc_out                 # (B, F, D)
    return logits_head(cfg, params, hidden[:, -1]), cache

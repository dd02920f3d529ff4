"""Shared neural layers of the LM stack: norms, RoPE, attention (full /
chunked / decode, and the prefill entry point ``attention``), QAT+FCP-aware
linears, the dense MLP, the mixture-of-experts layer and the
initialisers.

Functional style, as in the reference: parameters are read by key from a
``repro_torch.models.lm.Params`` (or any mapping), and every function
takes (cfg, params, inputs). Dtype policy: parameters live in float32 and
are cast to ``cfg.compute_dtype`` at use (``LMEngine`` casts the weight
matrices once, see ``lm.cast_weights_``).

Each function keeps the reference's rounding order in the compute type:
the full-attention logits are scaled in the compute type before the cast
to float32, the chunked ones after it, probabilities are rounded to the
compute type before P·V, and ``rms_norm`` works in float32. Scalars are
multiplied as tensors of the operand's type, since torch keeps a Python
scalar at higher precision where JAX rounds it to the operand's type,
and the activations are written out operation by operation (``silu``,
``gelu_tanh``), since XLA on the CPU rounds after each one where torch's
fused versions round once.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, torch_dtype
from repro_torch.core import quant as Q
from repro_torch.dist import shardings as sh

Tensor = torch.Tensor

NEG = -1e30                   # the reference's mask value
ATTN_CHUNK_THRESHOLD = 2048   # CPU: chunked (online-softmax) attention above
ATTN_CHUNK = 1024


def cdtype(cfg: ArchConfig) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


def _scalar(value: float, like: Tensor) -> Tensor:
    """A 0-d tensor of ``like``'s type and device, filled on the device
    (``torch.tensor`` would copy it from the host and synchronize)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _cpu_low_precision(t: Tensor) -> bool:
    return t.device.type == "cpu" and t.dtype in (torch.bfloat16,
                                                  torch.float16)


def matmul(x: Tensor, w: Tensor) -> Tensor:
    """x @ w in x's type (w cast to it first, as the reference casts at
    use). On the CPU a bfloat16 product is taken in float32 and rounded
    once, which is what XLA's CPU backend computes for the reference
    (torch's own CPU bfloat16 GEMM differs from it in the last bit of
    some products); on the card the operands go to the GEMM as they are
    (float32 accumulation, one rounding)."""
    w = w.to(x.dtype)
    if _cpu_low_precision(x):
        return (x.float() @ w.float()).to(x.dtype)
    return x @ w


def einsum(eq: str, *ops: Tensor) -> Tensor:
    """``torch.einsum`` in the operands' type, with ``matmul``'s rule for
    a bfloat16 product on the CPU."""
    if _cpu_low_precision(ops[0]):
        return torch.einsum(eq, *(o.float() for o in ops)).to(ops[0].dtype)
    return torch.einsum(eq, *ops)


def silu(x: Tensor) -> Tensor:
    """``jax.nn.silu``, operation by operation in x's type:
    x * (1 / (1 + exp(-x)))."""
    one = _scalar(1.0, x)
    return x * (one / (one + torch.exp(-x)))


def gelu_tanh(x: Tensor) -> Tensor:
    """``jax.nn.gelu`` (its default tanh form), operation by operation
    in x's type with its constants rounded to that type."""
    def c(value):
        return _scalar(value, x)
    inner = c(math.sqrt(2.0 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


def _softmax(x: Tensor) -> Tensor:
    """``jax.nn.softmax`` over the last axis: exp(x - max) / sum (torch's
    own softmax multiplies by the sum's reciprocal)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(cfg: ArchConfig, device=None) -> Tensor:
    dh = cfg.head_dim
    rot = int(dh * cfg.rotary_pct) // 2 * 2
    f32 = torch.float32
    expo = torch.arange(0, rot, 2, dtype=f32, device=device)
    expo = expo / _scalar(rot, expo)
    return _scalar(1.0, expo) / _scalar(cfg.rope_theta, expo) ** expo


def apply_rope(x: Tensor, positions: Tensor, cfg: ArchConfig) -> Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S). Rotates
    the first ``rot`` channels as interleaved pairs (x[0::2], x[1::2]),
    in float32, and passes the rest."""
    dh = x.shape[-1]
    inv = rope_freqs(cfg, x.device)
    rot = inv.shape[0] * 2
    ang = positions[..., None].float() * inv               # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    if rot < dh:
        y = torch.cat([y, x_pass.to(y.dtype)], dim=-1)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _repeat_kv(k: Tensor, n_rep: int) -> Tensor:
    """(B, S, KV, dh) -> (B, S, KV*n_rep, dh)."""
    if n_rep == 1:
        return k
    b, s, kv, dh = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, dh).reshape(
        b, s, kv * n_rep, dh)


def _mask(sq: int, sk: int, causal: bool, window: int, device) -> Tensor:
    qpos = torch.arange(sq, device=device)
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def full_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                   window: int = 0) -> Tensor:
    """q: (B, Sq, H, dh); k, v: (B, Sk, KV, dh). Materialises Sq x Sk."""
    h, kv = q.shape[2], k.shape[2]
    k = _repeat_kv(k, h // kv)
    v = _repeat_kv(v, h // kv)
    scale = _scalar(1.0 / math.sqrt(q.shape[-1]), q)
    logits = einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    logits = logits.float().masked_fill(~mask, NEG)
    probs = _softmax(logits).to(q.dtype)
    return einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                      window: int = 0, chunk: int = 1024) -> Tensor:
    """Online-softmax (flash-style) attention: a loop over KV chunks.

    Memory O(Sq * chunk) instead of O(Sq * Sk); the CPU's prefill
    attention above ``ATTN_CHUNK_THRESHOLD``.
    """
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    k = _repeat_kv(k, h // kvh)
    v = _repeat_kv(v, h // kvh)
    pad = (-sk) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    f32 = torch.float32
    scale = torch.full((), 1.0 / math.sqrt(dh), dtype=f32, device=q.device)
    qpos = torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), -math.inf, dtype=f32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=f32, device=q.device)
    acc = torch.zeros((b, h, sq, dh), dtype=f32, device=q.device)
    for ci in range(k.shape[1] // chunk):
        kb = k[:, ci * chunk: (ci + 1) * chunk]
        vb = v[:, ci * chunk: (ci + 1) * chunk]
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        logits = einsum("bqhd,bkhd->bhqk", q, kb).float() * scale
        mask = (kpos[None, :] < sk).expand(sq, chunk)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window > 0:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        logits = logits.masked_fill(~mask, NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), vb).float()
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)               # (B, Sq, H, dh)


def attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
              window: int = 0) -> Tensor:
    """The prefill path's attention, q (B, S, H, dh), k, v (B, S, KV, dh).

    On a CUDA tensor it is the hand-written ``flash_attention`` kernel,
    which raises on a shape it does not take (dh > 128) rather than
    handing it to a plain version. On a CPU tensor it is the twin of
    the reference's ``full_attention``, or of ``chunked_attention``
    above ``ATTN_CHUNK_THRESHOLD`` tokens. On placed (DTensor) q, k, v
    each rank runs the same on its local heads (``_placed_attention``).
    """
    if sh.is_placed(q):
        return _placed_attention(q, k, v, causal, window)
    if q.device.type == "cuda":
        from repro_torch.kernels.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal, window=window)
    if max(q.shape[1], k.shape[1]) > ATTN_CHUNK_THRESHOLD:
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 chunk=ATTN_CHUNK)
    return full_attention(q, k, v, causal=causal, window=window)


def _placed_attention(q, k, v, causal: bool, window: int):
    """``attention`` of placed q, k, v on each rank's whole KV groups.

    Over each mesh dim the batch keeps its shards; over 'model' the
    heads are sharded when the KV heads divide it (q's heads with them,
    so a rank holds whole groups), else replicated there: the rule
    table shards ``wk``'s columns whenever KV * dh divides, which can
    leave a rank half a head (glm4-9b: KV 2 on a 4-way axis). q, k and v
    are redistributed to those placements before the local attention,
    never inside it, and the output keeps them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    kvh = k.shape[2]
    place = []
    for i, name in enumerate(mesh.mesh_dim_names):
        if q.placements[i] == Shard(0):
            place.append(Shard(0))
        elif name == "model" and kvh % mesh.size(i) == 0:
            place.append(Shard(2))
        else:
            place.append(Replicate())
    ql, kl, vl = (sh.as_placed(t, mesh).redistribute(mesh, place).to_local()
                  for t in (q, k, v))
    sh.COUNTS["attention"] += 1
    out = attention(ql, kl, vl, causal=causal, window=window)
    return DTensor.from_local(out, mesh, place)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     cache_positions: Tensor, positions: Tensor,
                     *, window: int = 0) -> Tensor:
    """Single-token attention against a (possibly ring) KV cache, in
    plain torch on every device.

    q: (B, 1, H, dh); caches: (B, W, KV, dh); cache_positions: (B, W)
    absolute position per slot (-1 = empty); positions: (B,) current pos.
    Grouped-GQA form: KV is never repeated. On a mesh, with q or the
    cache placed, it is ``_placed_decode_attention``.
    """
    mesh = sh.active_mesh()
    if mesh is not None and (sh.is_placed(q) or sh.is_placed(k_cache)):
        return _placed_decode_attention(q, k_cache, v_cache,
                                        cache_positions, positions, window,
                                        mesh)
    b, _, h, dh = q.shape
    logits = _decode_logits(q, k_cache, cache_positions, positions, window)
    probs = _softmax(logits).to(q.dtype)
    out = einsum("bkgqw,bwkd->bqkgd", probs, v_cache)
    return out.reshape(b, 1, h, dh)


def _decode_logits(q: Tensor, k_cache: Tensor, cache_positions: Tensor,
                   positions: Tensor, window: int) -> Tensor:
    """Masked float32 scores (B, KV, G, 1, W) of the one query token."""
    b, _, h, dh = q.shape
    kvh = k_cache.shape[2]
    q5 = q.reshape(b, 1, kvh, h // kvh, dh)
    scale = torch.full((), 1.0 / math.sqrt(dh), dtype=torch.float32,
                       device=q.device)
    logits = einsum("bqkgd,bwkd->bkgqw", q5, k_cache).float() * scale
    valid = (cache_positions >= 0) & \
        (cache_positions <= positions[:, None])              # (B, W)
    if window > 0:
        valid &= cache_positions > (positions[:, None] - window)
    return logits.masked_fill(~valid[:, None, None, None, :], NEG)


def _placed_decode_attention(q, k_cache, v_cache, cache_positions,
                             positions, window: int, mesh):
    """``decode_attention`` on a mesh, as the reference places it: the
    batch over the widest data-parallel axes that divide it; heads over
    'model' when the KV heads divide it, each rank attending with its
    own heads; otherwise the cache stays sequence-sharded over 'model'
    and q is replicated (it is tiny): each rank scores its slots of the
    ring, and the softmax's max and sum and the P.V sum (in float32,
    rounded once after it) reduce over 'model'. Runs on each rank's
    local tensors with explicit all-reduces; the output keeps q's
    placement of the branch."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    b, _, h, dh = q.shape
    kvh, w = k_cache.shape[2], k_cache.shape[1]
    msize = sh._mesh_axis_size(mesh, "model")
    dp = sh._dp_for(mesh, b)
    if kvh % msize == 0:
        branch, qs, ks = "decode_heads", (dp, None, "model", None), \
            (dp, None, "model", None)
    elif w % msize == 0:
        branch, qs, ks = "decode_sequence", (dp, None, None, None), \
            (dp, "model", None, None)
    else:
        branch, qs, ks = "decode_replicated", (dp, None, None, None), \
            (dp, None, None, None)
    sh.COUNTS[branch] += 1

    def local(t, spec):
        return sh.to_local(t, mesh, sh.to_placements(
            mesh, sh._prune_spec(mesh, tuple(t.shape), spec)))

    q_place = sh.to_placements(mesh, sh._prune_spec(mesh, tuple(q.shape), qs))
    ql, kl, vl = local(q, qs), local(k_cache, ks), local(v_cache, ks)
    cl = local(cache_positions, ks[:2])
    pl = local(positions, ks[:1])
    bl, hl = ql.shape[0], ql.shape[2]
    logits = _decode_logits(ql, kl, cl, pl, window)
    if branch != "decode_sequence" or msize == 1:
        probs = _softmax(logits).to(ql.dtype)
        out = einsum("bkgqw,bwkd->bqkgd", probs, vl)
    else:
        group = mesh.get_group("model")
        m = logits.amax(dim=-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m)
        total = e.sum(dim=-1, keepdim=True)
        dist.all_reduce(total, group=group)
        probs = (e / total).to(ql.dtype)
        out = torch.einsum("bkgqw,bwkd->bqkgd", probs.float(), vl.float())
        dist.all_reduce(out, group=group)
        out = out.to(ql.dtype)
    return DTensor.from_local(out.reshape(bl, 1, hl, dh), mesh, q_place)


# ---------------------------------------------------------------------------
# QAT + FCP aware linear (the paper's technique inside LM blocks)
# ---------------------------------------------------------------------------

def effective_weight(w: Tensor, cfg: ArchConfig,
                     mask: Optional[Tensor] = None) -> Tensor:
    """DoReFa (``cfg.quant_weights``) and the FCP mask applied to a weight
    matrix, as the reference's ``quant_linear`` applies them before its
    cast to the compute type."""
    if cfg.quant_weights > 0:
        w = Q.dorefa_weight(w.float(), cfg.quant_weights)
    if mask is not None:
        w = w * mask.to(w.dtype)
    return w


def quant_linear(x: Tensor, w: Tensor, cfg: ArchConfig,
                 mask: Optional[Tensor] = None,
                 alpha: Optional[Tensor] = None,
                 nonnegative: bool = False,
                 prepared: bool = False) -> Tensor:
    """x @ w with optional QAT (activations) + DoReFa (weights) + FCP mask.

    The paper's per-layer activation selection: PACT when the input
    range is non-negative (e.g. after relu^2), symmetric signed
    quantization otherwise. ``prepared``: ``w`` already went through
    ``effective_weight`` (``lm.cast_weights_``), so neither DoReFa nor
    the mask is applied again.
    """
    if cfg.quant_bits > 0:
        a = alpha if alpha is not None else torch.full(
            (), 1.0, dtype=torch.float32, device=x.device)
        spec = Q.select_activation(nonnegative, cfg.quant_bits)
        x = Q.apply_act_quant(spec, x, a.to(x.dtype))
    if not prepared:
        w = effective_weight(w, cfg, mask)
    return matmul(x, w)


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

def mlp(x: Tensor, p, cfg: ArchConfig) -> Tensor:
    dt = x.dtype
    mask1, mask2 = p.get("mask_w1"), p.get("mask_w2")
    alpha = p.get("pact_alpha")
    prepared = getattr(p, "prepared", False)
    if cfg.act == "swiglu":
        g = quant_linear(x, p["w1"], cfg, mask1, alpha, False, prepared)
        u = matmul(x, p["w3"])
        h = silu(g) * u
        nonneg = False  # silu-gated products take both signs
    elif cfg.act == "relu2":
        h = quant_linear(x, p["w1"], cfg, mask1, alpha, False, prepared)
        h = torch.square(torch.relu(h))
        nonneg = True   # squared ReLU is non-negative -> PACT branch
    else:  # gelu
        h = quant_linear(x, p["w1"], cfg, mask1, alpha, False, prepared)
        h = gelu_tanh(h)
        nonneg = False
    return quant_linear(h, p["w2"], cfg, mask2, alpha, nonneg, prepared)


# ---------------------------------------------------------------------------
# MoE (sort-based routing, per-sequence capacity)
# ---------------------------------------------------------------------------

def top_k(x: Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest values and their
    indices, the lower index first among equal values (a stable sort;
    ``torch.topk`` promises no order on ties)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _routing_indices(top_e: Tensor, cap: int, e: int):
    """Capacity routing of each batch row, vectorised over the rows.

    top_e: (B, S, k) experts. Flattened token-major to A = S*k
    assignments and stably sorted by expert (``order``), an assignment
    takes the next slot of its expert, ``pos``; the first ``cap`` are
    kept, the rest go to the overflow slot E*cap. Returns order, slot
    and keep, each (B, A) in sorted order."""
    b, a = top_e.shape[0], top_e.shape[1] * top_e.shape[2]
    eflat = top_e.reshape(b, a)
    order = torch.argsort(eflat, dim=1, stable=True)
    es = eflat.gather(1, order)
    dev = eflat.device
    counts = (eflat[..., None] == torch.arange(e, device=dev)).sum(1)
    starts = counts.cumsum(1) - counts
    pos = torch.arange(a, device=dev) - starts.gather(1, es)
    keep = pos < cap
    slot = torch.where(keep, es * cap + pos, e * cap)
    return order, slot, keep


def moe(x: Tensor, p, cfg: ArchConfig) -> Tensor:
    """Top-k mixture of experts with per-sequence capacity, x (B, S, D).

    The reference's single-device path (``route_one`` under ``vmap``),
    vectorised over the batch rows as its ``_moe_shard_map`` block is:
    a float32 router, softmax, top-k renormalised, capacity
    cap = max(k, ceil(S k cf / E)) per expert and row; one (B, E, cap,
    D) token buffer and one batched product per expert matrix, so each
    expert's weights are read once for the whole batch. Every expert's
    buffer is computed, full or not, as in the reference. Dropped
    assignments contribute zero. Each token's k weighted outputs are
    summed in ascending expert order, one rounding to x's type per
    addition: the order of the reference's scatter-add, which sorts the
    assignments by expert (``index_add_`` on the card would add in any
    order). Nothing here synchronizes the host. Under ``moe_ep`` on a
    mesh whose data-parallel size exceeds 1 and divides the batch it is
    ``_moe_expert_parallel``, as the reference takes its
    ``_moe_shard_map``."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = max(k, int(math.ceil(s * k * cfg.capacity_factor / e)))
    dt = x.dtype
    mesh = sh.active_mesh()
    if (sh.OPTS["moe_ep"] and mesh is not None and _dp_size(mesh) > 1
            and b % _dp_size(mesh) == 0):
        return _moe_expert_parallel(x, p, cfg, cap, mesh)
    if mesh is not None and sh.is_placed(x):
        return _moe_rule_table(x, p, cfg, cap, mesh)
    top_p, top_e = _route(x, p["router"], k)
    w3 = p["w3"].to(dt) if cfg.act == "swiglu" else None
    return _experts(x, top_p, top_e, p["w1"].to(dt), p["w2"].to(dt), w3,
                    cfg, cap)


def _route(x: Tensor, router: Tensor, k: int):
    """(top_p, top_e) (B, S, k): the float32 router's softmax, its top k
    renormalised, each token's choices in ascending expert order (the
    same slots, as an expert's assignments keep their token order, and
    the reference's order of summation)."""
    probs = _softmax(x.float() @ router.float())                # (B, S, E)
    top_p, top_e = top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    top_e, perm = torch.sort(top_e, dim=-1)
    return top_p.gather(-1, perm), top_e


def _experts(x: Tensor, top_p: Tensor, top_e: Tensor, w1: Tensor,
             w2: Tensor, w3: Optional[Tensor], cfg: ArchConfig,
             cap: int) -> Tensor:
    """Dispatch, the expert MLPs over (E, D, F) w1 / w3 and (E, F, D) w2
    in x's type (or an F slice of them: the result is then that slice's
    share of the sum over F), and the combine."""
    xe, slot, keep = _dispatch(x, top_e, cfg, cap)
    g = einsum("becd,edf->becf", xe, w1)
    if cfg.act == "swiglu":
        h = silu(g) * einsum("becd,edf->becf", xe, w3)
    elif cfg.act == "relu2":
        h = torch.square(torch.relu(g))
    else:
        h = gelu_tanh(g)
    return _combine(einsum("becf,efd->becd", h, w2), slot, keep, top_p, cfg)


def _dispatch(x: Tensor, top_e: Tensor, cfg: ArchConfig, cap: int):
    """(xe, slot, keep): x's rows in their experts' capacity slots, the
    (B, E, cap, D) token buffer (empty slots zero), and each (token,
    choice)'s slot and whether it was kept, (B, S k)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    dt = x.dtype
    order, slot, keep = _routing_indices(top_e, cap, e)
    # back from sorted order to the (token, choice) layout
    slot = torch.empty_like(slot).scatter_(1, order, slot)
    keep = torch.empty_like(keep).scatter_(1, order, keep)
    a = s * k
    vals = torch.where(keep[..., None],
                       x[:, :, None].expand(b, s, k, d).reshape(b, a, d),
                       torch.zeros((), dtype=dt, device=x.device))
    xe = x.new_zeros((b, e * cap + 1, d))
    xe.scatter_(1, slot[..., None].expand(b, a, d), vals)       # (B, A) rows
    return xe[:, :-1].reshape(b, e, cap, d), slot, keep


def _combine(ye: Tensor, slot: Tensor, keep: Tensor, top_p: Tensor,
             cfg: ArchConfig) -> Tensor:
    """Each token's k weighted expert outputs, summed in ascending
    expert order; dropped assignments give zero."""
    b, e, cap, d = ye.shape
    k = cfg.moe_top_k
    a = slot.shape[1]
    dt = ye.dtype
    ye = ye.reshape(b, e * cap, d)
    ya = ye.gather(1, torch.clamp(slot, max=e * cap - 1)[..., None]
                   .expand(b, a, d))
    ya = torch.where(keep[..., None], ya,
                     torch.zeros((), dtype=dt, device=ye.device))
    ya = (ya * top_p.reshape(b, a, 1).to(dt)).reshape(b, a // k, k, d)
    out = ya[:, :, 0]
    for j in range(1, k):
        out = out + ya[:, :, j]
    return out


def _moe_rule_table(x, p, cfg: ArchConfig, cap: int, mesh):
    """The MoE block on leaves placed by the rule table, without
    ``moe_ep``: the reference's default, which GSPMD partitions. Routing,
    dispatch and combine run on each rank's rows as local tensors (the
    unplaced block's function, row by row); the token buffer is placed
    like the rows, and the expert products run on DTensors whose
    weights keep the rule table's placement, DTensor choosing the
    collectives (it gathers what the product needs). The products take
    the buffer expert-major and contiguous, (E, B cap, D) @ (E, D, F):
    DTensor's einsum takes views of non-contiguous local shards, which
    it cannot."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    b, s, d = x.shape
    e = cfg.n_experts
    dt = x.dtype
    rows = sh.to_placements(mesh, sh._prune_spec(
        mesh, tuple(x.shape), (sh._dp_for(mesh, b), None, None)))
    # a rank's router gradient is its rows' share where the rows split
    router = sh.to_local(p["router"], mesh, [Replicate()] * mesh.ndim,
                         [Partial() if r == Shard(0) else Replicate()
                          for r in rows])
    xl = sh.to_local(x, mesh, rows)
    top_p, top_e = _route(xl, router, cfg.moe_top_k)
    xe, slot, keep = _dispatch(xl, top_e, cfg, cap)
    xe = DTensor.from_local(xe, mesh, rows, run_check=False)
    xe = xe.permute(1, 0, 2, 3).contiguous().reshape(e, b * cap, d)

    def bmm(a, w):                      # ``einsum``'s rule for CPU bf16
        w = w.to(dt)
        if _cpu_low_precision(a):
            return torch.bmm(a.float(), w.float()).to(dt)
        return torch.bmm(a, w)

    g = bmm(xe, p["w1"])
    if cfg.act == "swiglu":
        h = silu(g) * bmm(xe, p["w3"])
    elif cfg.act == "relu2":
        h = torch.square(torch.relu(g))
    else:
        h = gelu_tanh(g)
    ye = bmm(h, p["w2"]).reshape(e, b, cap, d)
    ye = ye.permute(1, 0, 2, 3).contiguous()
    out = _combine(sh.to_local(ye, mesh, rows), slot, keep, top_p, cfg)
    sh.COUNTS["moe_rule_table"] += 1
    return DTensor.from_local(out, mesh, rows, run_check=False)


def _dp_size(mesh) -> int:
    return (sh._mesh_axis_size(mesh, "data")
            * sh._mesh_axis_size(mesh, "pod"))


def _moe_expert_parallel(x, p, cfg: ArchConfig, cap: int, mesh):
    """The MoE block with explicit collectives on local tensors, the
    reference's ``_moe_shard_map``: batch rows local to each dp shard;
    expert weights stored 2-D sharded ((None, 'data', 'model') for w1 /
    w3, (None, 'model', 'data') for w2), all-gathered over 'data' and
    then cast to the compute type (the gathered copy is still d_ff-
    sharded over 'model'); routing and dispatch on the rank's rows; each
    rank computes its d_ff slice of every expert and combines it
    locally (the combine is linear); one all-reduce over 'model' sums
    the slices. Differentiable: the gather's gradient is a
    reduce-scatter, the all-reduce's the identity (its result is
    replicated over 'model')."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    dt = x.dtype
    names = sh.axis_names(mesh)
    rows = sh.to_placements(mesh, sh._prune_spec(
        mesh, tuple(x.shape), (sh._dp_for(mesh, x.shape[0]), None, None)))

    def partial_grads(place, model: bool):
        # a rank's gradient is its share over the dims its rows split,
        # and over 'model' where it holds an F slice of the sum
        return [Partial() if isinstance(pl, Replicate) and (
            rl == Shard(0) or (model and n == "model")) else pl
            for pl, rl, n in zip(place, rows, names)]

    xl = sh.to_local(x, mesh, rows, partial_grads(rows, True))

    def weight(name: str, spec, dim: int) -> Tensor:
        t = p[name]
        pruned = sh._prune_spec(mesh, tuple(t.shape), spec)
        place = sh.to_placements(mesh, pruned)
        local = sh.to_local(t, mesh, place, partial_grads(place, False))
        if pruned[dim] == "data":
            local = sh.gather_local(local, "data", dim, mesh)
        return local.to(dt)

    w_in, w_out = (None, "data", "model"), (None, "model", "data")
    w1, w2 = weight("w1", w_in, 1), weight("w2", w_out, 2)
    w3 = weight("w3", w_in, 1) if cfg.act == "swiglu" else None
    router = sh.to_local(p["router"], mesh, [Replicate()] * mesh.ndim,
                         partial_grads([Replicate()] * mesh.ndim, True))
    top_p, top_e = _route(xl, router, cfg.moe_top_k)
    out = _experts(xl, top_p, top_e, w1, w2, w3, cfg, cap)
    sh.COUNTS["moe_expert_parallel"] += 1
    return DTensor.from_local(sh.all_reduce_sum(out, mesh, "model"), mesh,
                              rows)


# ---------------------------------------------------------------------------
# Initialisers (seeded from an explicit torch.Generator, on its device)
# ---------------------------------------------------------------------------

def ninit(gen: torch.Generator, shape, scale: Optional[float] = None
          ) -> Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).mul_(scale)


def init_attn(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, Tensor]:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": ninit(gen, (d, h * dh)),
        "wk": ninit(gen, (d, kv * dh)),
        "wv": ninit(gen, (d, kv * dh)),
        "wo": ninit(gen, (h * dh, d)),
    }


def init_mlp(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    dev = gen.device
    p = {"w1": ninit(gen, (d, f)), "w2": ninit(gen, (f, d))}
    if cfg.act == "swiglu":
        p["w3"] = ninit(gen, (d, f))
    if cfg.quant_bits > 0:
        p["pact_alpha"] = torch.tensor(6.0, dtype=torch.float32, device=dev)
    if cfg.fcp_fanin > 0:
        p["mask_w1"] = torch.ones((d, f), dtype=torch.float32, device=dev)
        p["mask_w2"] = torch.ones((f, d), dtype=torch.float32, device=dev)
    return p


def init_moe(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, Tensor]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": ninit(gen, (d, e)),
         "w1": ninit(gen, (e, d, f), 1.0 / math.sqrt(d)),
         "w2": ninit(gen, (e, f, d), 1.0 / math.sqrt(f))}
    if cfg.act == "swiglu":
        p["w3"] = ninit(gen, (e, d, f), 1.0 / math.sqrt(d))
    return p

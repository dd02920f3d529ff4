"""A dense decoder in plain PyTorch, float32, with no kernels, cache or
batching: the reference of the benchmark's LM cells.

It follows the port's equations, which depart from the published models
where each configuration's ``assumed`` says (RMSNorm in every block,
RoPE on interleaved pairs of the first ``rotary_pct`` of each head, no
biases, an untied head, squared ReLU or SwiGLU). It takes only what the
harness made: a ``leaf(name)`` callable giving each weight (``weights.py``
draws it from the seed) and token ids; the cast to the compute type,
the cache and the optimizer state it works out again, in float32 with
TF32 off.

``Products`` carries the one choice of precision: float32, or the
control's e4m3 (every matrix product's operands rounded to float8 e4m3
with one scale a tensor, amax / 448, and multiplied in float32; the
rounding passes gradients straight through).

Memory: attention runs a block of queries at a time, training
recomputes each layer and each loss chunk in its backward, and serving
runs layer by layer over the sampled sequences with one layer's weights
upcast at a time.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from perfbench import work

Tensor = torch.Tensor
QUERY_BLOCK = 1024
LOSS_CHUNK = 512
VOCAB_BLOCK = 32768


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Products:
    """Matrix products in float32 (``precision="float32"``) or with both
    operands rounded to float8 e4m3 first (``"e4m3"``)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "e4m3"):
            raise ValueError(f"precision float32 or e4m3, got {precision!r}")
        self.precision = precision

    def round(self, t: Tensor) -> Tensor:
        if self.precision == "float32":
            return t
        scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
        q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32)
        return t + (q * scale - t).detach()

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        return self.round(a) @ self.round(b)

    def einsum(self, eq: str, a: Tensor, b: Tensor) -> Tensor:
        return torch.einsum(eq, self.round(a), self.round(b))


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x: Tensor, positions: Tensor, arch: Dict) -> Tensor:
    """x (B, S, H, dh): the first ``rot`` channels of each head rotated
    as interleaved pairs (x[0::2], x[1::2]), the rest passed."""
    dh = x.shape[-1]
    rot = int(dh * arch.get("rotary_pct", 1.0)) // 2 * 2
    theta = float(arch.get("rope_theta", 10000.0))
    inv = 1.0 / theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                       device=x.device) / rot)
    ang = positions.float()[:, None] * inv                   # (S, rot/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0:rot:2], x[..., 1:rot:2]
    y = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([y.flatten(-2), x[..., rot:]], dim=-1)


def attention(q: Tensor, k: Tensor, v: Tensor, pr: Products) -> Tensor:
    """Causal attention, q (B, S, H, dh), k, v (B, S, KV, dh): query
    head j reads KV head j // (H / KV). A block of queries at a time."""
    b, s, h, dh = q.shape
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(dh)
    outs = []
    for c0 in range(0, s, QUERY_BLOCK):
        c1 = min(s, c0 + QUERY_BLOCK)
        scores = pr.einsum("bqhd,bkhd->bhqk", q[:, c0:c1], k[:, :c1]) * scale
        qpos = torch.arange(c0, c1, device=q.device)[:, None]
        kpos = torch.arange(c1, device=q.device)[None, :]
        scores = scores.masked_fill(kpos > qpos, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        outs.append(pr.einsum("bhqk,bkhd->bqhd", probs, v[:, :c1]))
    return torch.cat(outs, dim=1)


def layer(x: Tensor, w: Dict[str, Tensor], arch: Dict, pr: Products
          ) -> Tensor:
    """One decoder layer over x (B, S, D); ``w`` by the names after
    ``layers::i::``."""
    k = work.dims(arch)
    b, s, _ = x.shape
    eps = float(arch.get("norm_eps", 1e-5))
    pos = torch.arange(s, device=x.device)
    hin = rms_norm(x, w["ln1"], eps)
    q = pr.mm(hin, w["attn::wq"]).view(b, s, k["h"], k["dh"])
    kk = pr.mm(hin, w["attn::wk"]).view(b, s, k["kv"], k["dh"])
    vv = pr.mm(hin, w["attn::wv"]).view(b, s, k["kv"], k["dh"])
    a = attention(rope(q, pos, arch), rope(kk, pos, arch), vv, pr)
    x = x + pr.mm(a.reshape(b, s, k["h"] * k["dh"]), w["attn::wo"])
    hin = rms_norm(x, w["ln2"], eps)
    g = pr.mm(hin, w["mlp::w1"])
    if arch.get("act", "swiglu") == "swiglu":
        m = torch.nn.functional.silu(g) * pr.mm(hin, w["mlp::w3"])
    elif arch["act"] == "relu2":
        m = torch.relu(g).square()
    else:
        raise ValueError(f"activation {arch['act']!r} is not a dense "
                         "decoder's of this benchmark")
    return x + pr.mm(m, w["mlp::w2"])


def layer_names(arch: Dict) -> List[str]:
    names = ["attn::wk", "attn::wo", "attn::wq", "attn::wv", "ln1", "ln2",
             "mlp::w1", "mlp::w2"]
    if work.dims(arch)["mats"] == 3:
        names.append("mlp::w3")
    return names


# ---------------------------------------------------------------------------
# Training: loss, gradients, AdamW
# ---------------------------------------------------------------------------

def loss(params: Dict[str, Tensor], arch: Dict, tokens: Tensor,
         labels: Tensor, pr: Products) -> Tensor:
    """Mean cross-entropy of next tokens over B x S, the logits in
    float32 over the padded vocabulary (its padding masked)."""
    k = work.dims(arch)
    eps = float(arch.get("norm_eps", 1e-5))
    x = params["embed"][tokens.long()]
    for i in range(k["L"]):
        w = {n: params[f"layers::{i}::{n}"] for n in layer_names(arch)}
        x = checkpoint(layer, x, w, arch, pr, use_reentrant=False)
    x = rms_norm(x, params["final_norm"], eps)
    b, s, _ = x.shape

    def chunk_loss(h, lab, head):
        logits = pr.mm(h, head)
        if k["vp"] > k["v"]:
            logits[..., k["v"]:] = float("-inf")
        gold = logits.gather(-1, lab.long()[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - gold).sum()

    total = x.new_zeros(())
    for c0 in range(0, s, LOSS_CHUNK):
        total = total + checkpoint(chunk_loss, x[:, c0:c0 + LOSS_CHUNK],
                                   labels[:, c0:c0 + LOSS_CHUNK],
                                   params["lm_head"], use_reentrant=False)
    return total / (b * s)


def lr_at(step: int, opt: Dict) -> float:
    """Warmup over ``warmup_steps``, then cosine to a tenth of ``lr``
    at ``total_steps``, in float32."""
    f32 = np.float32
    peak, warm, total = f32(opt["lr"]), opt["warmup_steps"], opt["total_steps"]
    t = f32(step)
    if t < warm:
        return float(peak * t / f32(max(warm, 1)))
    prog = np.clip((t - f32(warm)) / f32(max(total - warm, 1)), 0, 1)
    return float(peak * (f32(0.1) + f32(0.9) * f32(0.5)
                         * (f32(1) + np.cos(f32(math.pi) * prog))))


def decayed(name: str, t: Tensor) -> bool:
    """AdamW decays a leaf of two or more dimensions as the port counts
    them: a per-layer leaf carries the stacked layer axis."""
    return t.ndim + name.startswith("layers::") >= 2


def train(arch: Dict, opt: Dict, leaf: Callable[[str], Tensor],
          names: Sequence[str], batches: Sequence[Dict[str, Tensor]],
          pr: Products) -> Dict:
    """``len(batches)`` steps of loss, gradients and AdamW (clip by the
    global norm, decay added to the update, eps after the bias
    corrections) from the leaves ``leaf(name)`` gives. Returns each
    step's loss, each leaf's first gradient as the optimizer takes it
    (after the clip) and before the clip, and each leaf's change after
    the last step."""
    params = {n: leaf(n).float().requires_grad_(True) for n in names}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    out = {"losses": []}
    for step, batch in enumerate(batches, start=1):
        value = loss(params, arch, batch["tokens"], batch["labels"], pr)
        grads = torch.autograd.grad(value, [params[n] for n in names])
        out["losses"].append(float(value.detach()))
        with torch.no_grad():
            sq = torch.zeros((), device=value.device)
            for g in grads:
                sq = sq + g.square().sum()
            scale = torch.clamp(opt["grad_clip"] / (torch.sqrt(sq) + 1e-9),
                                max=1.0)
            if step == 1:
                out["grad_raw"] = {n: float(g.norm())
                                   for n, g in zip(names, grads)}
                out["grad"] = {n: float((g * scale).norm())
                               for n, g in zip(names, grads)}
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
            lr = lr_at(step, opt)
            for n, g in zip(names, grads):
                p, m, v = params[n], mu[n], nu[n]
                g = g * scale
                m.mul_(b1).add_(g * (1 - b1))
                v.mul_(b2).add_(g * g * (1 - b2))
                u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                if opt["weight_decay"] > 0 and decayed(n, p):
                    u = u + opt["weight_decay"] * p
                p.sub_(lr * u)
        del grads
    with torch.no_grad():
        out["change"] = {n: float((params[n] - leaf(n).float()).norm())
                         for n in names}
    return out


# ---------------------------------------------------------------------------
# Serving: logits of sampled sequences
# ---------------------------------------------------------------------------

@torch.no_grad()
def logits_at(arch: Dict, leaf: Callable[[str], Tensor],
              seqs: Sequence[np.ndarray], rows: Sequence[np.ndarray],
              pr: Products, device) -> List[Tensor]:
    """The float32 logits (len(rows[j]), Vp) at positions ``rows[j]`` of
    each whole sequence ``seqs[j]`` (one forward pass each), layer by
    layer over every sequence. The padded columns are not masked: the
    port's greedy argmax runs over them too."""
    k = work.dims(arch)
    eps = float(arch.get("norm_eps", 1e-5))
    embed = leaf("embed")
    xs = [embed[torch.as_tensor(s, device=device).long()].float()[None]
          for s in seqs]
    del embed
    for i in range(k["L"]):
        w = {n: leaf(f"layers::{i}::{n}").float()
             for n in layer_names(arch)}
        xs = [layer(x, w, arch, pr) for x in xs]
        del w
    norm = leaf("final_norm").float()
    hs = torch.cat([rms_norm(x[0, torch.as_tensor(r, device=device).long()],
                             norm, eps) for x, r in zip(xs, rows)])
    del xs
    head = leaf("lm_head")
    logits = torch.empty((hs.shape[0], k["vp"]), dtype=torch.float32,
                         device=device)
    for c0 in range(0, k["vp"], VOCAB_BLOCK):
        logits[:, c0:c0 + VOCAB_BLOCK] = pr.mm(
            hs, head[:, c0:c0 + VOCAB_BLOCK].float())
    return list(torch.split(logits, [len(r) for r in rows]))

"""Operations and bytes from shapes, and the card's peaks.

Frozen here, so a roofline reads the same work whatever implements it.
Every count is what the algorithm needs at the given shapes: each input
byte read once, each output byte written once, matrix products at 2
operations a multiply-add. ``arch`` is a configuration's ``arch`` block
(a dict, or any object with the same attributes).
"""
from __future__ import annotations

# Published peaks (NVIDIA's data sheet, SXM part, dense, at 700 W).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}
DEFAULT_PEAK = "NVIDIA H100 80GB HBM3"


def peak(kind: str | None = None) -> dict:
    return PEAKS.get(kind or DEFAULT_PEAK, PEAKS[DEFAULT_PEAK])


def _get(arch, key, default=None):
    if isinstance(arch, dict):
        return arch.get(key, default)
    return getattr(arch, key, default)


def dims(arch) -> dict:
    """The sizes every count below reads, with the port's defaults:
    head size d_model / n_heads unless given, the vocabulary padded to a
    multiple of 256 (the port's layout of embed and lm_head)."""
    d, h = _get(arch, "d_model"), _get(arch, "n_heads")
    dh = _get(arch, "d_head", 0) or d // h
    v = _get(arch, "vocab_size")
    return {"d": d, "h": h, "kv": _get(arch, "n_kv_heads"), "dh": dh,
            "f": _get(arch, "d_ff"), "L": _get(arch, "n_layers"),
            "v": v, "vp": (v + 255) // 256 * 256,
            "mats": 3 if _get(arch, "act", "swiglu") == "swiglu" else 2}


def layer_matrix_params(arch) -> int:
    """Parameters of one dense decoder layer's matrices (attention and
    MLP; the norm scales are not products)."""
    k = dims(arch)
    d, h, kv, dh, f = k["d"], k["h"], k["kv"], k["dh"], k["f"]
    return 2 * d * h * dh + 2 * d * kv * dh + k["mats"] * d * f


def head_params(arch) -> int:
    k = dims(arch)
    return k["d"] * k["vp"]


def causal_pairs(sq: int, sk: int | None = None) -> int:
    """(query, key) pairs a causal mask keeps, queries aligned to the
    last ``sq`` of ``sk`` keys."""
    sk = sq if sk is None else sk
    off = sk - sq
    return sq * off + sq * (sq + 1) // 2


def attention_flops(arch, pairs: int) -> int:
    """Q K^T and P V over ``pairs`` kept pairs, every head, one layer."""
    k = dims(arch)
    return 4 * k["dh"] * k["h"] * pairs


def train_model_flops(arch, batch: int, seq: int) -> int:
    """Model FLOPs of one training step: 6 N T over the layers' and the
    head's matrices (the embedding is a lookup), and attention's causal
    products three times (forward and backward). Recomputation is not
    counted."""
    k = dims(arch)
    n = k["L"] * layer_matrix_params(arch) + head_params(arch)
    tokens = batch * seq
    return (6 * n * tokens
            + 3 * k["L"] * attention_flops(arch, batch * causal_pairs(seq)))


def prefill_flops(arch, seq: int) -> int:
    """One prompt of ``seq`` tokens: every token through the layers,
    the head for the last token only."""
    k = dims(arch)
    return (2 * k["L"] * layer_matrix_params(arch) * seq
            + k["L"] * attention_flops(arch, causal_pairs(seq))
            + 2 * head_params(arch))


def decode_flops(arch, active: int, contexts: int) -> int:
    """One decode step of ``active`` slots whose contexts (cached tokens
    and the new one) sum to ``contexts`` keys."""
    k = dims(arch)
    per_token = 2 * (k["L"] * layer_matrix_params(arch) + head_params(arch))
    return per_token * active + k["L"] * attention_flops(arch, contexts)


def decode_bytes(arch, active: int, contexts: int, n_slots: int,
                 weight_bytes: int = 2, cache_bytes: int = 2) -> int:
    """Least bytes of one decode step: every layer matrix and the head
    read once in the served type, the norm scales in float32, one
    embedding row a slot, the active slots' cached K and V read at their
    lengths (``contexts - active`` tokens) and their new K and V
    written, and the logits of every slot written."""
    k = dims(arch)
    L, d = k["L"], k["d"]
    weights = (L * layer_matrix_params(arch) + head_params(arch)) \
        * weight_bytes + (2 * L + 1) * d * 4
    kv_token = L * 2 * k["kv"] * k["dh"] * cache_bytes
    return (weights + n_slots * d * weight_bytes + contexts * kv_token
            + n_slots * k["vp"] * weight_bytes)


def flash_forward_work(b: int, sq: int, sk: int, h: int, kv: int, dh: int,
                       with_lse: bool, elem: int = 2):
    """(operations, bytes) of one causal attention forward launch."""
    pairs = b * causal_pairs(sq, sk)
    flops = 4 * dh * h * pairs
    nbytes = elem * (2 * b * sq * h * dh + 2 * b * sk * kv * dh)
    if with_lse:
        nbytes += 4 * b * h * sq
    return flops, nbytes


def flash_backward_work(b: int, sq: int, sk: int, h: int, kv: int, dh: int,
                        elem: int = 2):
    """(operations, bytes) of one causal attention backward launch: S
    recomputed, dP, dV, dQ and dK at 2 dh a kept pair each; q, k, v, out,
    dout and the log-sum-exp read, dq, dk, dv written."""
    pairs = b * causal_pairs(sq, sk)
    flops = 10 * dh * h * pairs
    q_like = b * sq * h * dh
    kv_like = b * sk * kv * dh
    nbytes = elem * (3 * q_like + 2 * kv_like      # q, out, dout; k, v
                     + q_like + 2 * kv_like)       # dq; dk, dv
    return flops, nbytes + 4 * b * h * sq


def bound_s(flops: float, nbytes: float, kind: str | None = None) -> float:
    """The least time: operations at the bf16 peak or bytes at the HBM
    peak, whichever is longer."""
    p = peak(kind)
    return max(flops / p["bf16_flops"], nbytes / p["hbm_bytes"])

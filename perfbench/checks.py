"""The comparisons that decide ``correct``.

Training: each checked step's loss, the first gradient of every leaf as
the optimizer takes it, and every leaf's change after the checked
steps, each against the reference. A norm is compared by the gap
between the port's and the reference's norms of a leaf (not the norm of
their difference), over the larger of the reference's norm of that leaf
and of the median leaf; the worst leaf is the number. A leaf whose
reference gradient is under a thousandth of the median leaf's moves by
round-off alone and is left out of the change.

Serving: the widest gap by which a served token's reference logit lies
below the reference's best logit at its position.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np

from perfbench.harness import Check

NEGLIGIBLE_GRADIENT = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    med = statistics.median(ref[n] for n in ref)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def train_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` / ``ref``: ``losses`` (each checked step), ``grad`` (each
    leaf's first gradient norm, clipped), ``change`` (each leaf's change
    norm after the checked steps); ``ref`` also ``grad_raw``."""
    losses = max(abs(a - b) / abs(b)
                 for a, b in zip(prog["losses"], ref["losses"]))
    return {"loss": losses,
            "grad": max(leaf_gaps(prog["grad"], ref["grad"],
                                  ref["grad"]).values()),
            "change": max(leaf_gaps(prog["change"], ref["change"],
                                    moved_leaves(ref)).values())}


def moved_leaves(ref: Dict):
    """Leaves whose first reference gradient is not negligible."""
    med = statistics.median(ref["grad_raw"].values())
    return [n for n, g in ref["grad_raw"].items()
            if g >= NEGLIGIBLE_GRADIENT * med]


def judge(readings: Dict[str, float], limits: Dict) -> List[Check]:
    """Each number compared beside its limit, by the number's name."""
    return [Check(name, value, limits[name])
            for name, value in readings.items()]


def correct(found: List[Check]) -> bool:
    return bool(found) and all(c.ok for c in found)


def train_named(readings: Dict[str, float]) -> Dict[str, float]:
    """``train_readings``'s numbers under their limits' names."""
    return {f"train_{k}_gap": v for k, v in readings.items()}


def train_checks(prog: Dict, ref: Dict, limits: Dict) -> List[Check]:
    readings = train_readings(prog, ref)
    if len(prog["losses"]) != len(ref["losses"]):
        readings["loss"] = float("inf")
    return judge(train_named(readings), limits)


def served_gaps(logits, tokens) -> np.ndarray:
    """Per row: the reference's best logit minus its logit of the token
    served there."""
    import torch
    best = logits.max(dim=-1).values
    got = logits.gather(-1, torch.as_tensor(tokens, device=logits.device)
                        .long()[:, None])[:, 0]
    return (best - got).cpu().numpy()


def serve_readings(gaps: np.ndarray) -> Dict[str, float]:
    return {"served_logit_gap": float(gaps.max()) if len(gaps)
            else float("inf")}


def serve_checks(gaps: np.ndarray, limits: Dict) -> List[Check]:
    return judge(serve_readings(gaps), limits)

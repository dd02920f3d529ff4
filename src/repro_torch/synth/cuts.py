"""Priority k-feasible-cut enumeration over an AIG.

The shared engine under both the rewriter (k=4 resynthesis windows) and
the LUT mapper (k=6 FlowMap-style covering). For each AND node the
bottom-up merge of its fanins' cut sets is filtered to <= k leaves,
deduplicated, pruned for dominance (a cut that is a superset of another
cut of the same node is never useful), and truncated to the ``n_cuts``
best by (depth, area-flow) — the standard priority-cuts scheme that
keeps the exact-FlowMap depth optimum in practice while staying linear
in network size.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from .aig import AIG, lit_var


@dataclasses.dataclass(frozen=True)
class Cut:
    leaves: Tuple[int, ...]     # sorted node ids
    depth: int                  # 1 + max leaf arrival (0 for the PI cut)
    aflow: float                # area flow of the cone rooted here


def enumerate_cuts(aig: AIG, k: int = 6, n_cuts: int = 8
                   ) -> Tuple[List[List[Cut]], List[int], List[float]]:
    """Returns (cuts-per-node, arrival-per-node, area-flow-per-node).

    ``arrival[n]`` is the depth-optimal k-LUT arrival time of node n;
    cut lists are sorted best-first by (depth, aflow, size).
    """
    n = aig.n_nodes
    fanout = aig.fanout_counts()
    cuts: List[List[Cut]] = [[] for _ in range(n)]
    arrival = [0] * n
    aflow = [0.0] * n
    cuts[0] = [Cut((), 0, 0.0)]
    for p in range(1, aig.n_pis + 1):
        cuts[p] = [Cut((p,), 0, 0.0)]

    for node in range(aig.n_pis + 1, n):
        f0, f1 = aig.fanins(node)
        c0s, c1s = cuts[lit_var(f0)], cuts[lit_var(f1)]
        merged = {}
        for c0 in c0s:
            s0 = set(c0.leaves)
            for c1 in c1s:
                leaves = s0 | set(c1.leaves)
                if len(leaves) > k:
                    continue
                key = tuple(sorted(leaves))
                if key in merged:
                    continue
                d = 1 + max((arrival[x] for x in key), default=0)
                af = 1.0 + sum(aflow[x] for x in key)
                merged[key] = Cut(key, d, af)
        cands = sorted(merged.values(),
                       key=lambda c: (c.depth, c.aflow, len(c.leaves)))
        # dominance pruning: drop cuts containing an earlier (better) cut
        kept: List[Cut] = []
        for c in cands:
            cs = set(c.leaves)
            if any(set(b.leaves) <= cs for b in kept):
                continue
            kept.append(c)
            if len(kept) >= n_cuts:
                break
        best = kept[0]
        arrival[node] = best.depth
        aflow[node] = best.aflow / max(1, int(fanout[node]))
        # the trivial cut lets parents treat this node as a leaf
        kept.append(Cut((node,), arrival[node], aflow[node]))
        cuts[node] = kept
    return cuts, arrival, aflow

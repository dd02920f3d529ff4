"""Orchestration: run the check passes over a real synth pipeline.

``check_synth_pipeline`` re-runs the stages of
``synth.compile_logic_network`` one at a time — raw AIG, optimized AIG,
k-LUT mapping, DevicePlan — linting each artifact and proving each
adjacent pair equivalent, so a regression in any single transform is
pinned to its stage rather than surfacing as a wrong argmax three
layers later. ``preflight`` is the cheap subset the serving entry point
runs before accepting traffic; ``verify_synthesis`` / ``verify_plan``
back the ``verify=`` flags on the synth entry points.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.synth.aig import AIG
from repro_torch.synth.executor import (DevicePlan, MappedNetwork,
                                        compile_device_plan,
                                        compile_tile_plan)
from repro_torch.synth.from_sop import network_to_aig, table_to_aig
from repro_torch.synth.lutmap import map_aig
from repro_torch.synth.rewrite import optimize

from . import concurrency, srclint
from .equiv import (equiv_aig_mapped, equiv_aigs, equiv_cover_aig,
                    equiv_mapped_plan, equiv_network_mapped)
from .netlist_lint import lint_aig, lint_mapped
from .plan_check import DEFAULT_SMEM_BUDGET, validate_device_plan
from .report import CheckReport, require_ok


def check_sop_stage(net, n_samples: int = 4, seed: int = 0,
                    name: str = "sop-aig") -> CheckReport:
    """SOP <-> AIG on sampled neuron output-bit functions of the first
    layer: minimize the dense table with espresso, rebuild it with
    ``table_to_aig``, and miter cover against AIG on the care set."""
    from repro_torch.core.espresso import minimize
    from repro_torch.core.logic_infer import _bitexpand
    from repro_torch.core.truthtable import onset_of

    rep = CheckReport(name)
    lt = net.layers[0]
    in_bits = lt.in_spec.code_bits
    out_bits = lt.out_spec.code_bits
    rng = np.random.default_rng(seed)
    pairs = [(int(j), int(ob))
             for j in range(lt.n_neurons) for ob in range(out_bits)]
    if len(pairs) > n_samples:
        pairs = [pairs[i] for i in
                 rng.choice(len(pairs), n_samples, replace=False)]
    n_vars = lt.fanin * in_bits
    for j, ob in pairs:
        onset, dc = _bitexpand(onset_of(np.asarray(lt.tables[j]), ob),
                               lt, in_bits)
        cover = minimize(np.asarray(onset, bool),
                         None if dc is None else np.asarray(dc, bool))
        a = AIG(n_vars)
        in_lits = [2 * (p + 1) for p in range(n_vars)]
        a.outputs = [table_to_aig(a, onset, dc, in_lits)]
        sub = equiv_cover_aig(cover, a, dc_mask=dc,
                              name=f"sop-aig[n{j}b{ob}]")
        rep.merge(sub)
    rep.info["sampled_functions"] = len(pairs)
    return rep


def check_synth_pipeline(net=None, aig: Optional[AIG] = None,
                         effort: int = 1, k: int = 6, fast: bool = False,
                         smem_budget_bytes: int = DEFAULT_SMEM_BUDGET,
                         seed: int = 0, formal: bool = False,
                         conflict_budget: Optional[int] = None
                         ) -> CheckReport:
    """Lint + stage-by-stage equivalence for one synthesis run.

    Accepts either a compiled ``LogicNetwork`` (full pipeline including
    the SOP stage and the valid-code oracle check) or a bare ``AIG``
    (transform stages only). ``fast`` trades vector count for CI time.
    ``formal=True`` escalates every wide-cone miter to the SAT engine
    (per-stage UNSAT/SAT/UNPROVEN verdicts land in ``info["formal[..]"]``)
    and runs the SAT-sweep duplicate-LUT lint over the mapped net.
    """
    assert (net is None) != (aig is None), "pass exactly one of net/aig"
    n_rand = 16 if fast else 64
    fkw = {"formal": formal, "conflict_budget": conflict_budget}
    rep = CheckReport("synth-pipeline")
    if net is not None:
        rep.merge(check_sop_stage(net, n_samples=2 if fast else 4,
                                  seed=seed))
        aig = network_to_aig(net)
    rep.merge(lint_aig(aig, "aig"))
    opt = optimize(aig, rounds=effort) if effort > 0 else aig
    if effort > 0:
        rep.merge(lint_aig(opt, "aig-optimized"))
        rep.merge(equiv_aigs(aig, opt, n_random_words=n_rand, seed=seed,
                             **fkw))
    mapped = map_aig(opt, k=k)
    rep.merge(lint_mapped(mapped))
    rep.merge(equiv_aig_mapped(opt, mapped, n_random_words=n_rand,
                               seed=seed, **fkw))
    dplan = compile_device_plan(mapped)
    rep.merge(validate_device_plan(dplan,
                                   smem_budget_bytes=smem_budget_bytes))
    rep.merge(equiv_mapped_plan(mapped, dplan, n_random_words=n_rand,
                                seed=seed, **fkw))
    if net is not None:
        rep.merge(equiv_network_mapped(net, mapped,
                                       n_samples=256 if fast else 1024,
                                       seed=seed, **fkw))
    if formal:
        from .sat import check_duplicate_lut_outputs
        rep.merge(check_duplicate_lut_outputs(
            mapped, seed=seed,
            **({} if conflict_budget is None
               else {"conflict_budget": conflict_budget})))
    rep.info["n_luts"] = mapped.n_luts
    rep.info["depth"] = mapped.depth
    return rep


def preflight(bitnet, smem_budget_bytes: int = DEFAULT_SMEM_BUDGET,
              n_samples: int = 256, seed: int = 0) -> CheckReport:
    """Serving preflight for a compiled ``BitplaneNetwork``: lint the
    mapped netlist, validate + miter the DevicePlan its executors
    launch (built from the network's own levelized plan, with the tile
    schedule the streamed executor takes: its spec, else the autotune
    cache's geometry for this plan and device), reckon both walks'
    shared memory at the serving batch, and spot-check the
    netlist against the truth-table oracle on valid codes. Host code
    only, so it launches nothing; cheap enough to run at every
    ``launch.serve --check`` startup."""
    from repro_torch.kernels.lut_eval.autotune import tuned_spec

    rep = CheckReport("preflight")
    rep.merge(lint_mapped(bitnet.mapped))
    dplan = compile_device_plan(bitnet.mapped, bitnet._plan)
    spec = tuned_spec(dplan, bitnet.device, bitnet.spec)
    kw = dict(smem_budget_bytes=smem_budget_bytes,
              block_w=spec.tile.block_w)
    plan_rep = validate_device_plan(dplan, **kw)
    if plan_rep.ok:
        # the tile schedule renumbers wires through the plan's indices,
        # so it is built (and checked) only from a plan that passed
        dplan.tiles = compile_tile_plan(bitnet._plan, dplan.n_pis, dplan.k,
                                        spec.tile.tile_rows)
        plan_rep = validate_device_plan(dplan, **kw)
    rep.merge(plan_rep)
    if plan_rep.ok:     # the host interpreter indexes by the plan too
        rep.merge(equiv_mapped_plan(bitnet.mapped, dplan, n_random_words=16,
                                    seed=seed))
    if getattr(bitnet, "net", None) is not None:
        rep.merge(equiv_network_mapped(bitnet.net, bitnet.mapped,
                                       n_samples=n_samples, seed=seed))
    return rep


def check_static(fast: bool = False) -> CheckReport:
    """The pure-source passes (no model needed): concurrency lint over
    the serving stack and the duplicate-definition watchlist."""
    rep = CheckReport("static")
    rep.merge(concurrency.check_concurrency())
    rep.merge(srclint.check_duplicate_definitions())
    return rep


# ---------------------------------------------------------------------------
# verify= hooks (raise CheckFailure on any error)
# ---------------------------------------------------------------------------

def verify_synthesis(raw: AIG, opt: AIG, mapped: MappedNetwork,
                     formal: bool = False) -> None:
    """Backs ``synthesize(..., verify=True)``: the optimized AIG must
    match the raw one everywhere, and the mapping must match the
    optimized AIG everywhere. ``formal=True`` (``verify="formal"``)
    escalates wide cones to SAT proofs."""
    rep = CheckReport("verify-synthesis")
    rep.merge(lint_aig(opt, "aig-optimized"))
    if opt is not raw:
        rep.merge(equiv_aigs(raw, opt, n_random_words=16, formal=formal))
    rep.merge(lint_mapped(mapped))
    rep.merge(equiv_aig_mapped(opt, mapped, n_random_words=16,
                               formal=formal))
    require_ok(rep)


def verify_plan(mapped: MappedNetwork, dplan: DevicePlan,
                formal: bool = False) -> None:
    """Backs ``compile_device_plan(..., verify=True)``."""
    rep = CheckReport("verify-plan")
    rep.merge(validate_device_plan(dplan))
    if rep.ok:          # the host interpreter indexes by the plan too
        rep.merge(equiv_mapped_plan(mapped, dplan, n_random_words=16,
                                    formal=formal))
    require_ok(rep)

"""repro_torch.synth — multi-level logic synthesis, k-LUT technology
mapping and mapped-netlist execution.

    SOP covers (core.espresso)
      -> AIG with structural hashing          (synth.aig / synth.from_sop)
      -> balance + DAG-aware rewriting        (synth.rewrite)
      -> depth-optimal 6-LUT mapping + area   (synth.lutmap)
      -> bit-parallel execution on the host   (synth.executor,
         or on the card through the lut_eval   synth.simulate)
         kernels, and structural Verilog      (synth.executor.emit_verilog)

The host pipeline is numpy (a copy of ``repro.synth``'s);
``compile_logic_network(net)`` is the one-call pipeline from a compiled
``LogicNetwork`` to its executable mapped netlist.
"""
from typing import Optional

from .aig import AIG, CONST0, CONST1, lit, lit_compl, lit_not, lit_var
from .cuts import Cut, enumerate_cuts
from . import executors
from .executor import (BitplaneNetwork, DevicePlan, TilePlan,
                       compile_device_plan, compile_tile_plan,
                       emit_verilog, execute_packed)
from .from_sop import cover_to_aig, layer_to_aig, network_to_aig, table_to_aig
from .lutmap import MappedLUT, MappedNetwork, map_aig
from .rewrite import balance, optimize, rewrite
from .simulate import (exhaustive_equiv, input_patterns, pack_bits,
                       random_equiv, random_words, simulate, unpack_bits)


def synthesize(aig: AIG, effort: int = 1, k: int = 6,
               verify=False) -> MappedNetwork:
    """balance/rewrite rounds (``effort``; 0 = map the raw AIG) followed
    by k-LUT mapping with area recovery.

    ``verify=True`` miters every transform against its input (rewrite
    must preserve the function everywhere, the LUT cover must match the
    optimized AIG everywhere) and raises ``repro_torch.check.CheckFailure``
    with a counterexample on any disagreement. Cones wider than the
    20-PI exhaustive limit are only *sampled*; ``verify="formal"``
    escalates them to the ``repro_torch.check.sat`` engine, which proves
    the miter UNSAT at any width (or fails with a replayed SAT
    counterexample / an explicit UNPROVEN warning)."""
    raw = aig
    if effort > 0:
        aig = optimize(aig, rounds=effort)
    mapped = map_aig(aig, k=k)
    if verify:
        from repro_torch.check.pipeline import verify_synthesis
        verify_synthesis(raw, aig, mapped, formal=(verify == "formal"))
    return mapped


def compile_logic_network(net, effort: int = 1, k: int = 6,
                          engine: Optional[str] = None, device=None,
                          spec=None, verify=False) -> BitplaneNetwork:
    """LogicNetwork -> optimized mapped netlist, ready to execute.

    ``engine`` names an executor in the ``repro_torch.synth.executors``
    registry: ``"cuda"`` runs the netlist through the monolithic
    ``lut_eval`` kernel, ``"cuda-streamed"`` through the streamed one,
    ``"numpy"`` folds on the host; ``None`` picks ``"cuda-streamed"`` on
    a CUDA device and ``"numpy"`` elsewhere. ``device`` defaults to
    ``"cuda"``. ``verify=True`` additionally runs the
    ``repro_torch.check`` lint + equivalence passes over every synthesis
    stage and the serving preflight (CheckFailure on the first
    counterexample; ``"formal"`` proves wide cones by SAT)."""
    return BitplaneNetwork.from_logic_network(net, effort=effort, k=k,
                                              engine=engine, device=device,
                                              spec=spec, verify=verify)

"""repro_torch.synth — multi-level logic synthesis, k-LUT technology
mapping and mapped-netlist execution.

    SOP covers (core.espresso)
      -> AIG with structural hashing          (synth.aig / synth.from_sop)
      -> balance + DAG-aware rewriting        (synth.rewrite)
      -> depth-optimal 6-LUT mapping + area   (synth.lutmap)
      -> bit-parallel execution on the host   (synth.executor,
         or on the card through the lut_eval   synth.simulate)
         kernels

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
                       execute_packed)
from .from_sop import cover_to_aig, layer_to_aig, network_to_aig, table_to_aig
from .lutmap import MappedLUT, MappedNetwork, map_aig
from .rewrite import balance, optimize, rewrite
from .simulate import (exhaustive_equiv, input_patterns, pack_bits,
                       random_equiv, random_words, simulate, unpack_bits)


def synthesize(aig: AIG, effort: int = 1, k: int = 6) -> MappedNetwork:
    """balance/rewrite rounds (``effort``; 0 = map the raw AIG) followed
    by k-LUT mapping with area recovery."""
    if effort > 0:
        aig = optimize(aig, rounds=effort)
    return map_aig(aig, k=k)


def compile_logic_network(net, effort: int = 1, k: int = 6,
                          engine: Optional[str] = None, device=None,
                          spec=None) -> BitplaneNetwork:
    """LogicNetwork -> optimized mapped netlist, ready to execute.

    ``engine`` names an executor in the ``repro_torch.synth.executors``
    registry: ``"cuda"`` runs the netlist through the monolithic
    ``lut_eval`` kernel, ``"cuda-streamed"`` through the streamed one,
    ``"numpy"`` folds on the host; ``None`` picks ``"cuda-streamed"`` on
    a CUDA device and ``"numpy"`` elsewhere. ``device`` defaults to
    ``"cuda"``."""
    return BitplaneNetwork.from_logic_network(net, effort=effort, k=k,
                                              engine=engine, device=device,
                                              spec=spec)

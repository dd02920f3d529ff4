"""repro_torch.check.sat — formal equivalence via a self-contained CDCL SAT
solver.

The sampled miter in :mod:`repro_torch.check.equiv` is a proof only up to 20
primary inputs.  This package turns the wide-cone check into a proof at
any width:

  * :mod:`.solver` — CDCL (two-watched-literal propagation, VSIDS
    activity, Luby restarts, learned-clause DB reduction, conflict
    budget), pure stdlib;
  * :mod:`.cnf` — Tseitin encoding of AND gates, per-INIT-row and
    ISOP (Minato-Morreale) encodings of LUTs, quantizer care-set
    blocking clauses, miter construction;
  * :mod:`.engine` — unified-netlist import of both miter sides plus
    simulation-guided SAT sweeping; verdicts are ``UNSAT`` (proved),
    ``SAT`` (counterexample, replayed before reporting) or
    ``UNPROVEN`` (budget exhausted — callers fall back to sampling
    *loudly*);
  * :mod:`.sweep` — duplicate-LUT-output detection/merge over the
    mapped net (signature candidates, SAT confirmation).
"""
from .engine import (DEFAULT_CONFLICT_BUDGET, SAT, UNPROVEN, UNSAT,
                     CareSet, FormalResult, UNet, import_aig,
                     import_mapped, import_plan, prove_aig_equiv,
                     prove_aig_mapped, prove_mapped_equiv,
                     prove_mapped_plan, prove_network_mapped, prove_pairs)
from .solver import Solver, luby
from .sweep import (check_duplicate_lut_outputs, find_duplicate_lut_outputs,
                    merge_duplicate_lut_outputs)

__all__ = [
    "DEFAULT_CONFLICT_BUDGET", "SAT", "UNPROVEN", "UNSAT",
    "CareSet", "FormalResult", "Solver", "UNet",
    "check_duplicate_lut_outputs", "find_duplicate_lut_outputs",
    "import_aig", "import_mapped", "import_plan", "luby",
    "merge_duplicate_lut_outputs",
    "prove_aig_equiv", "prove_aig_mapped", "prove_mapped_equiv",
    "prove_mapped_plan", "prove_network_mapped", "prove_pairs",
]

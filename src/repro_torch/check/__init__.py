"""repro_torch.check — static analysis and verification for the
synth->serve stack (a copy of the reference's ``repro.check``, numpy and
the standard library only; the plan check reckons the CUDA walks'
shared memory where the reference reckons TPU VMEM).

Five passes, all runnable via ``python -m repro_torch.check``:

  1. **netlist lint** (``netlist_lint``) — structural invariants of the
     AIG and the mapped k-LUT netlist;
  2. **equivalence** (``equiv``) — miter-style functional equivalence
     between adjacent pipeline stages, exhaustive up to ~20 inputs,
     counterexample-reporting beyond;
  3. **device-plan validation** (``plan_check``) — shape/dtype/index
     contracts of ``DevicePlan`` tensors and the CUDA walks' shared
     memory at the serving batch, cached by plan hash;
  4. **concurrency lint** (``concurrency``) — AST lock-discipline and
     reject-reason coverage over ``repro_torch.serve``;
  5. **trace schema** (``tracecheck``) — invariants of exported
     ``repro_torch.obs`` traces: span-time monotonicity/nesting, async
     begin/end pairing with no orphans, flush-reason and terminal-
     outcome vocabularies;
  6. **formal equivalence** (``sat``) — SAT-proved miters for cones
     beyond the exhaustive limit: Tseitin/ISOP CNF of both sides,
     quantizer care set as blocking clauses, a self-contained CDCL
     solver, and a SAT-sweep duplicate-LUT lint; verdicts are UNSAT
     (proof), SAT (replayed counterexample) or UNPROVEN (budget
     exhausted, falls back to sampling loudly).

``pipeline.check_synth_pipeline`` chains 1–3 (and 6 with
``formal=True``) over a real synthesis run; ``pipeline.preflight`` is
the serving-startup subset behind ``python -m repro_torch.launch.serve
--check``.
"""
from .concurrency import check_concurrency
from .equiv import (equiv_aig_mapped, equiv_aigs, equiv_cover_aig,
                    equiv_mapped_plan, equiv_network_mapped,
                    execute_plan_host, miter)
from .sat import (DEFAULT_CONFLICT_BUDGET, CareSet, FormalResult,
                  check_duplicate_lut_outputs, find_duplicate_lut_outputs,
                  merge_duplicate_lut_outputs, prove_aig_equiv,
                  prove_aig_mapped, prove_mapped_equiv, prove_mapped_plan,
                  prove_network_mapped)
from .netlist_lint import lint_aig, lint_mapped
from .pipeline import (check_sop_stage, check_static, check_synth_pipeline,
                       preflight, verify_plan, verify_synthesis)
from .plan_check import (DEFAULT_SMEM_BUDGET, estimate_smem_bytes,
                         estimate_tile_smem_bytes, plan_fingerprint,
                         validate_device_plan)
from .report import (Counterexample, CheckFailure, CheckReport, Issue,
                     require_ok)
from .srclint import check_duplicate_definitions
from .tracecheck import (check_trace, check_trace_file,
                         synthetic_trace_events)

__all__ = [
    "CheckFailure", "CheckReport", "Counterexample", "Issue",
    "CareSet", "FormalResult",
    "DEFAULT_CONFLICT_BUDGET", "DEFAULT_SMEM_BUDGET",
    "check_concurrency", "check_duplicate_definitions",
    "check_duplicate_lut_outputs", "check_sop_stage",
    "check_static", "check_synth_pipeline", "check_trace",
    "check_trace_file", "find_duplicate_lut_outputs",
    "merge_duplicate_lut_outputs",
    "prove_aig_equiv", "prove_aig_mapped", "prove_mapped_equiv",
    "prove_mapped_plan", "prove_network_mapped",
    "equiv_aig_mapped", "equiv_aigs", "equiv_cover_aig",
    "equiv_mapped_plan", "equiv_network_mapped", "execute_plan_host",
    "estimate_smem_bytes", "estimate_tile_smem_bytes", "lint_aig",
    "lint_mapped", "miter",
    "plan_fingerprint", "preflight", "require_ok",
    "synthetic_trace_events",
    "validate_device_plan", "verify_plan", "verify_synthesis",
]

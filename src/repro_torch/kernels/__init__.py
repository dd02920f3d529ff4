"""Hand-written CUDA kernels of the port, each beside its plain torch
version.

  lut_eval   — whole mapped-netlist evaluation over packed bitplanes,
               monolithic (``lut_eval``, over a ``DevicePlan``) and
               streamed (``lut_eval_streamed``, over a ``TilePlan``);
  lut_layer  — the truth-table-lookup layer of a ``LogicNetwork``.

Each kernel directory holds ops.py (the wrapper: checks, allocation,
launch, launch counter) and ref.py (the plain torch version). A wrapper
runs the plain version for a tensor on the CPU and launches its kernel
(``csrc/*.cu``, built by ``build.py`` at first use) for a CUDA tensor;
it never falls back from one to the other.
"""


def wrappers():
    """Kernel name -> wrapper (each counts its launches in ``.launches``)."""
    from .lut_eval import lut_eval, lut_eval_streamed
    from .lut_layer import lut_layer
    return {"lut_eval": lut_eval, "lut_eval_streamed": lut_eval_streamed,
            "lut_layer": lut_layer}


def launch_counts():
    """Kernel name -> launches counted so far in this process."""
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0

"""Hand-written CUDA kernels of the port, each beside its plain torch
version.

  lut_eval        — whole mapped-netlist evaluation over packed
                    bitplanes, monolithic (``lut_eval``, over a
                    ``DevicePlan``) and streamed (``lut_eval_streamed``,
                    over a ``TilePlan``);
  lut_layer       — the truth-table-lookup layer of a ``LogicNetwork``;
  aig_sim         — the AIG walk (``aig_sim_walk``: sweeps over all
                    nodes until the plane stops changing), and the
                    public ``aig_sim`` route through
                    ``lut_eval_streamed``;
  xnor_popcount   — packed bipolar matmul (``xnor_matmul_packed``,
                    ``xnor_matmul``);
  fanin_matmul    — the fanin-K gather-matmul of an FCP-sparse layer;
  flash_attention — online-softmax attention forward with causal,
                    sliding-window and grouped-query heads
                    (``flash_attention``), and its backward
                    (``flash_attention_backward``, the gradient of the
                    forward's ``torch.autograd`` Function on the card);
  decode_attention — one query token's attention over the serving ring
                    KV cache, read in place at its valid slots, split
                    across blocks (``decode_attention``).

Each kernel directory holds ops.py (the wrapper: checks, allocation,
launch, launch counter) and ref.py (the plain torch version). A wrapper
runs the plain version for a tensor on the CPU and launches its kernel
(``csrc/*.cu``, built by ``build.py`` at first use) for a CUDA tensor;
it never falls back from one to the other.
"""


def wrappers():
    """Kernel name -> wrapper (each counts its launches in ``.launches``)."""
    from .aig_sim import aig_sim_walk
    from .decode_attention import decode_attention
    from .fanin_matmul import fanin_matmul
    from .flash_attention import flash_attention, flash_attention_backward
    from .lut_eval import lut_eval, lut_eval_streamed
    from .lut_layer import lut_layer
    from .xnor_popcount import xnor_matmul_packed
    return {"lut_eval": lut_eval, "lut_eval_streamed": lut_eval_streamed,
            "lut_layer": lut_layer, "aig_sim": aig_sim_walk,
            "xnor_popcount": xnor_matmul_packed,
            "fanin_matmul": fanin_matmul,
            "flash_attention": flash_attention,
            "flash_attention_backward": flash_attention_backward,
            "decode_attention": decode_attention}


def launch_counts():
    """Kernel name -> launches counted so far in this process."""
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0

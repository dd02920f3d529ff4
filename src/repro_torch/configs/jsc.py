"""JSC-S/M/L — jet substructure classification MLPs (LogicNets
architectures [34], as evaluated by NullaNet Tiny Table I).

Topologies follow LogicNets: 16 inputs, 5 classes.
  JSC-S: 64-32-32-32   fanin 2-3, low bitwidth  -> tiny (paper: 39 LUTs)
  JSC-M: 64-32-32-32   wider fanin/bits          (paper: 1,553 LUTs)
  JSC-L: 32-64-192-192-16 fanin 4, higher bits   (paper: 11,752 LUTs)

The exact LogicNets (fanin, bits) pairs are approximated where the papers
leave them implicit; the reproduction target is the relative claim
structure (accuracy >= LogicNets at multiple-x fewer LUTs) on identical
synthetic data — see DESIGN.md §7.
"""
from repro_torch.models.mlp import MLPConfig

JSC_S = MLPConfig(
    name="jsc-s", n_inputs=16,
    features=(64, 32, 5), fanins=(3, 3, 3),
    act_bits=(2, 2, 3), in_bits=2, n_classes=5, alpha=1.0,
)

JSC_M = MLPConfig(
    name="jsc-m", n_inputs=16,
    features=(64, 32, 32, 5), fanins=(4, 4, 4, 4),
    act_bits=(2, 2, 2, 4), in_bits=2, n_classes=5, alpha=1.0,
)

JSC_L = MLPConfig(
    name="jsc-l", n_inputs=16,
    features=(32, 64, 192, 16, 5), fanins=(4, 4, 4, 4, 4),
    act_bits=(2, 2, 2, 2, 4), in_bits=3, n_classes=5, alpha=1.0,
)

# reduced config for examples / fast tests
JSC_DEMO = MLPConfig(
    name="jsc-demo", n_inputs=16,
    features=(16, 8, 5), fanins=(3, 3, 3),
    act_bits=(2, 2, 3), in_bits=2, n_classes=5, alpha=1.0,
)

JSC = {"jsc-s": JSC_S, "jsc-m": JSC_M, "jsc-l": JSC_L}

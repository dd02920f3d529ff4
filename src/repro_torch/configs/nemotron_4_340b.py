"""nemotron-4-340b — dense decoder, GQA kv=8, squared-ReLU MLP
[arXiv:2402.16819; unverified]. The squared-ReLU activation is
non-negative, so the paper's per-layer activation-selection rule picks
the PACT branch for QAT here (see DESIGN.md §4)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab_size=256000, act="relu2",
    rope_theta=10000.0, rotary_pct=0.5, source="arXiv:2402.16819",
)

SMOKE = ArchConfig(
    name="nemotron-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab_size=512, act="relu2", rotary_pct=0.5,
)

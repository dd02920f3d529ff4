"""phi4-mini-3.8b — dense decoder, RoPE (partial), SwiGLU, GQA kv=8
[arXiv:2412.08905; hf]. 24 heads is not divisible by the 16-way model
axis; GSPMD pads (cost discussed in EXPERIMENTS.md §Roofline)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=200064, act="swiglu",
    rope_theta=10000.0, rotary_pct=0.75, source="arXiv:2412.08905",
)

SMOKE = ArchConfig(
    name="phi4-mini-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab_size=512, act="swiglu", rotary_pct=0.75,
)

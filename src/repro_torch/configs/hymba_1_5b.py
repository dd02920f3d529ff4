"""hymba-1.5b — hybrid-head LM: parallel attention + Mamba heads in every
block, GQA kv=5, SWA [arXiv:2411.13676; hf]. Attention uses a 1024
sliding window (the paper mixes SWA + a few global layers; we model all-
SWA and note the simplification in DESIGN.md). Sub-quadratic: runs
long_500k. 25 heads is not 16-divisible; GSPMD pads."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001, act="swiglu",
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    window=1024, rope_theta=10000.0, source="arXiv:2411.13676",
)

SMOKE = ArchConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512, act="swiglu",
    ssm_state=8, ssm_conv=4, ssm_expand=2, window=64,
)

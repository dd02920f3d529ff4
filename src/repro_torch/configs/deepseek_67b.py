"""deepseek-67b — llama-architecture dense decoder, GQA kv=8
[arXiv:2401.02954; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=102400, act="swiglu",
    rope_theta=10000.0, source="arXiv:2401.02954",
)

SMOKE = ArchConfig(
    name="deepseek-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab_size=512, act="swiglu",
)

"""mixtral-8x22b — sparse MoE decoder: 8 experts top-2, GQA kv=8, SWA
[arXiv:2401.04088; hf]. Sliding window -> sub-quadratic decode: runs
long_500k with a ring KV cache."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768, act="swiglu",
    n_experts=8, moe_top_k=2, capacity_factor=1.25,
    window=4096, rope_theta=1000000.0, source="arXiv:2401.04088",
)

SMOKE = ArchConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512, act="swiglu",
    n_experts=4, moe_top_k=2, window=64,
)

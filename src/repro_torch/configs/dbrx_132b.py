"""dbrx-132b — fine-grained sparse MoE decoder: 16 experts top-4,
GQA kv=8 [hf:databricks/dbrx-base; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352, act="swiglu",
    n_experts=16, moe_top_k=4, capacity_factor=1.25,
    rope_theta=500000.0, source="hf:databricks/dbrx-base",
)

SMOKE = ArchConfig(
    name="dbrx-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab_size=512, act="swiglu",
    n_experts=4, moe_top_k=2,
)

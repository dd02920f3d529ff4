"""glm4-9b — dense decoder, RoPE (partial rotary), extreme GQA (kv=2)
[hf:THUDM/glm-4-9b; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=151552, act="swiglu",
    rope_theta=10000.0, rotary_pct=0.5, source="hf:THUDM/glm-4-9b",
)

SMOKE = ArchConfig(
    name="glm4-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab_size=512, act="swiglu", rotary_pct=0.5,
)

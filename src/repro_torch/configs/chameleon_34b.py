"""chameleon-34b — early-fusion VLM, dense decoder over text+VQ image
tokens [arXiv:2405.09818; unverified]. Backbone only; the VQ tokenizer is
a stub (image content arrives as token ids in the shared 65536 vocab)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536, act="swiglu",
    rope_theta=10000.0, source="arXiv:2405.09818",
)

SMOKE = ArchConfig(
    name="chameleon-34b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab_size=512, act="swiglu",
)

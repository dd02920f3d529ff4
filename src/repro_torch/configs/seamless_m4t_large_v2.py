"""seamless-m4t-large-v2 — multimodal encoder-decoder
[arXiv:2308.11596; hf]. Transformer backbone only: the speech frontend is
a stub; ``input_specs`` supplies precomputed frame embeddings
(B, seq/8, d_model) to the encoder. MHA (kv == heads)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206, act="gelu", cross_attention=True,
    frontend="frames", frontend_frames_div=8,
    source="arXiv:2308.11596",
)

SMOKE = ArchConfig(
    name="seamless-m4t-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, act="gelu", cross_attention=True,
    frontend="frames", frontend_frames_div=8,
)

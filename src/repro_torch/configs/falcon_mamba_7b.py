"""falcon-mamba-7b — attention-free Mamba-1 SSM LM
[arXiv:2410.05355; unverified]. 64 blocks, d_model 4096, d_inner 8192,
ssm_state 16, conv 4. Sub-quadratic: runs long_500k."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024, ssm_state=16, ssm_conv=4, ssm_expand=2,
    source="arXiv:2410.05355",
)

SMOKE = ArchConfig(
    name="falcon-mamba-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=512, ssm_state=8, ssm_conv=4, ssm_expand=2,
)

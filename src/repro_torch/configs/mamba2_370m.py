"""mamba2-370m — pure SSM, SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSM

CONFIG = ModelConfig(
    name="mamba2-370m",
    family=SSM,
    n_layers=48,
    d_model=1024,
    n_heads=1,       # attention-free; kept for config uniformity
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    d_state=128,
    ssm_headdim=64,
    expand=2,
    norm_type="rmsnorm",
    grad_accum=2,
    source="[arXiv:2405.21060; unverified]",
)

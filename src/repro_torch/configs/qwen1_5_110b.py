"""qwen1.5-110b — dense, GQA kv=8, QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.configs.base import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family=DENSE,
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    opt_moment_dtype="bfloat16",  # fits the v5e HBM budget
    grad_accum=4,
    source="[hf:Qwen/Qwen1.5-0.5B; hf]",
)

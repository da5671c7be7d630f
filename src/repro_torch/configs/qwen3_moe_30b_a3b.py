"""qwen3-moe-30b-a3b — 128 experts top-8, GQA kv=4, head_dim=128, QK-norm.

[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import ModelConfig, MOE

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family=MOE,
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    qk_norm=True,
    rope_theta=1e6,
    grad_accum=4,
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
)

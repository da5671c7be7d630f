"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.base import ModelConfig, MOE

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family=MOE,
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    n_experts=64,
    top_k=6,
    rope_theta=5e4,
    grad_accum=2,
    source="[hf:moonshotai/Moonlight-16B-A3B; hf]",
)

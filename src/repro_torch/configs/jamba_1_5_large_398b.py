"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

Period-8 block: 7 mamba + 1 attention layer; MoE every 2nd layer.

[arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import ModelConfig, HYBRID

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family=HYBRID,
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    attn_every=8,
    d_state=128,
    ssm_headdim=64,
    expand=2,
    opt_moment_dtype="bfloat16",  # 398B: fp32 moments would blow the v5e HBM budget
    grad_accum=16,
    source="[arXiv:2403.19887; hf]",
)

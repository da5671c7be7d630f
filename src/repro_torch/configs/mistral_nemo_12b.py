"""mistral-nemo-12b — dense, GQA kv=8, head_dim=128, 128k ctx.

[hf:mistralai/Mistral-Nemo-Base-2407; hf]
"""
from repro_torch.configs.base import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family=DENSE,
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e6,
    max_seq_len=131072,
    grad_accum=2,
    source="[hf:mistralai/Mistral-Nemo-Base-2407; hf]",
)

"""deepseek-7b — dense llama-arch, MHA (kv=32).

[arXiv:2401.02954; hf]
"""
from repro_torch.configs.base import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="deepseek-7b",
    family=DENSE,
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    rope_theta=1e4,
    grad_accum=2,
    source="[arXiv:2401.02954; hf]",
)

"""olmo-1b — dense with non-parametric LayerNorm (no scale/bias).

[arXiv:2402.00838; hf]
"""
from repro_torch.configs.base import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="olmo-1b",
    family=DENSE,
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm_type="nonparametric_ln",
    rope_theta=1e4,
    source="[arXiv:2402.00838; hf]",
)

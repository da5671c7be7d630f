"""llama-3.2-vision-90b — cross-attention image layers every 5th layer.

Vision frontend is a STUB: ``input_specs()`` supplies precomputed patch
embeddings of shape (batch, n_frontend_tokens, d_model).

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.configs.base import ModelConfig, VLM

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family=VLM,
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    n_frontend_tokens=1601,  # 1 image tile of 40x40 patches + cls
    rope_theta=5e5,
    remat_policy="nothing",
    grad_accum=4,
    source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
)

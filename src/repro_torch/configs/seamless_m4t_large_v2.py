"""seamless-m4t-large-v2 — encoder-decoder multimodal backbone.

The speech/text frontend is a STUB: ``input_specs()`` supplies precomputed
frame embeddings (batch, src_len, d_model) for the encoder.

[arXiv:2308.11596; hf]
"""
from repro_torch.configs.base import ModelConfig, ENCDEC

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family=ENCDEC,
    n_layers=48,            # 24 enc + 24 dec
    n_enc_layers=24,
    n_dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    norm_type="layernorm",
    rope_theta=1e4,
    grad_accum=4,
    source="[arXiv:2308.11596; hf]",
)

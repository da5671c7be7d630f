"""A llama-style dense decoder (``model_type`` ``llama``: deepseek-llm):
pre-norm attention with RoPE and a SwiGLU MLP in every layer, served by the
port's DENSE family."""
from __future__ import annotations

from trimsbench import flops, weights


def port_config(c: dict):
    from repro_torch.configs.base import DENSE
    from trimsbench.serve import decoder_config
    return decoder_config(c, family=DENSE, d_ff=c["intermediate_size"])


def layout(c: dict) -> list:
    d, lead = c["hidden_size"], (c["num_hidden_layers"],)
    return (weights.stem(c) + weights.norms(lead, d, "layers/ln1", "layers/ln2")
            + weights.attention(c, lead) + weights.mlp(lead, d, c["intermediate_size"]))


def layer_params_per_token(c: dict) -> int:
    return flops.attention_params(c) + 3 * c["hidden_size"] * c["intermediate_size"]


def request_flops(c: dict, B: int, S: int, new: int) -> float:
    L = c["num_hidden_layers"]
    return flops.decoder_flops(c, B, S, new, L * layer_params_per_token(c), L)


def request_kernel_bounds(c: dict, B: int, S: int, new: int) -> dict:
    return flops.attention_kernel_bounds(c, B, S, new, c["num_hidden_layers"])


def tiny(c: dict) -> dict:
    """The sizes of the CPU tests' copy."""
    return dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
                num_key_value_heads=4, vocab_size=512)

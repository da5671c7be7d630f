"""A Qwen3-MoE decoder (``model_type`` ``qwen3_moe``): pre-norm GQA
attention with RoPE and a per-head RMSNorm of the queries and keys
(QK-norm), and a top-k MoE of SwiGLU experts in every layer, served by the
port's MOE family with capacity dispatch."""
from __future__ import annotations

from trimsbench import flops, weights


def port_config(c: dict):
    from repro_torch.configs.base import MOE
    from trimsbench.serve import decoder_config
    return decoder_config(c, family=MOE, d_ff=c["moe_intermediate_size"], qk_norm=True,
                          n_experts=c["num_experts"], top_k=c["num_experts_per_tok"])


def layout(c: dict) -> list:
    d, L, E = c["hidden_size"], c["num_hidden_layers"], c["num_experts"]
    hd = weights.head_dim(c)
    return (weights.stem(c) + weights.norms((L,), d, "layers/ln1", "layers/ln2")
            + weights.attention(c, (L,))
            + [("layers/attn/q_norm", (L, hd), "norm", weights.NORM_SPREAD),
               ("layers/attn/k_norm", (L, hd), "norm", weights.NORM_SPREAD),
               ("layers/ffn/router", (L, d, E), "router", weights.EMBED_STD)]
            + weights.mlp((L, E), d, c["moe_intermediate_size"]))


def layer_params_per_token(c: dict) -> int:
    d = c["hidden_size"]
    return (flops.attention_params(c) + c["num_experts_per_tok"] * 3 * d
            * c["moe_intermediate_size"] + d * c["num_experts"])


def request_flops(c: dict, B: int, S: int, new: int) -> float:
    L = c["num_hidden_layers"]
    return flops.decoder_flops(c, B, S, new, L * layer_params_per_token(c), L)


def request_kernel_bounds(c: dict, B: int, S: int, new: int) -> dict:
    return flops.attention_kernel_bounds(c, B, S, new, c["num_hidden_layers"])


def tiny(c: dict) -> dict:
    """The sizes of the CPU tests' copy."""
    return dict(hidden_size=64, moe_intermediate_size=32, num_attention_heads=4,
                num_key_value_heads=2, head_dim=16, num_experts=8, num_experts_per_tok=2,
                vocab_size=500)

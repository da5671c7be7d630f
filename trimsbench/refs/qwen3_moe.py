"""The plain float32 forward of a Qwen3-MoE decoder (``model_type``
``qwen3_moe``): pre-norm GQA attention with QK-norm and RoPE, a top-k MoE
with capacity dispatch in every layer, the head tied to the embedding."""
from __future__ import annotations

import torch

from trimsbench.reference import Linear, Weights, attention, layer, moe, rmsnorm


def final_hidden(c: dict, w: Weights, tokens: torch.Tensor, prompt_len: int,
                 lin: Linear) -> torch.Tensor:
    eps = c["rms_norm_eps"]
    x = w["embed"][tokens].float()
    for i in range(c["num_hidden_layers"]):
        x = x + attention(c, layer(w, "layers/attn/", i),
                          rmsnorm(x, w["layers/ln1/scale"][i], eps), lin)
        x = x + moe(c, layer(w, "layers/ffn/", i), rmsnorm(x, w["layers/ln2/scale"][i], eps),
                    prompt_len, lin)
    return rmsnorm(x[:, prompt_len - 1:], w["final_norm/scale"], eps)


def logits(c: dict, w: Weights, h: torch.Tensor, lin: Linear) -> torch.Tensor:
    return lin(h, w["embed"][:c["vocab_size"]].T)

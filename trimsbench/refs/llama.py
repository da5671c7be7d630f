"""The plain float32 forward of a llama-style dense decoder (``model_type``
``llama``): pre-norm attention with RoPE and a SwiGLU MLP in every layer,
the head tied to the embedding."""
from __future__ import annotations

import torch

from trimsbench.reference import Linear, Weights, attention, layer, mlp, rmsnorm


def final_hidden(c: dict, w: Weights, tokens: torch.Tensor, prompt_len: int,
                 lin: Linear) -> torch.Tensor:
    eps = c["rms_norm_eps"]
    x = w["embed"][tokens].float()
    for i in range(c["num_hidden_layers"]):
        x = x + attention(c, layer(w, "layers/attn/", i),
                          rmsnorm(x, w["layers/ln1/scale"][i], eps), lin)
        x = x + mlp(layer(w, "layers/ffn/", i), rmsnorm(x, w["layers/ln2/scale"][i], eps), lin)
    return rmsnorm(x[:, prompt_len - 1:], w["final_norm/scale"], eps)


def logits(c: dict, w: Weights, h: torch.Tensor, lin: Linear) -> torch.Tensor:
    return lin(h, w["embed"][:c["vocab_size"]].T)

"""Plain PyTorch oracles for every kernel (allclose targets).

Mirror the JAX package's ``kernels/ref.py`` one for one, in the same
``(B, H, S, D)`` layout and with the same ``-inf`` mask constant (the model
code masks with ``-1e30``).
"""
from __future__ import annotations

import math

import torch


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, S, D); k, v: (B, Hkv, T, D). GQA via head grouping.

    fp32 softmax, output in q.dtype.
    """
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, S, D)
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, k).float() / math.sqrt(D)
    if causal:
        mask = torch.arange(S, device=q.device)[:, None] >= torch.arange(T, device=q.device)[None, :]
        s = torch.where(mask[None, None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgst,bhtd->bhgsd", p.to(q.dtype), v)
    return o.reshape(B, Hq, S, v.shape[-1])


def decode_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, D) one token; k, v: (B, Hkv, T, D); kv_len: (B,)."""
    B, Hq, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,bhtd->bhgt", qg, k).float() / math.sqrt(D)
    valid = torch.arange(T, device=q.device)[None, :] < kv_len[:, None]   # (B, T)
    s = torch.where(valid[:, None, None, :], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgt,bhtd->bhgd", p.to(q.dtype), v)
    return o.reshape(B, Hq, D)


def rmsnorm_reference(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)

"""Dense layers in PyTorch: norms, RoPE, GQA attention, SwiGLU.

Mirrors the JAX package's ``models/layers.py`` (dense parts). Parameters are
plain dicts of tensors in the ``.trims`` layout: weights are ``(in, out)``
and used as ``x @ W``, never transposed into ``nn.Linear``. The JAX
``part.shard_*`` layout constraints are the identity on one card and are
dropped. On CUDA the rmsnorms, prefill attention and decode attention go
through the hand-written kernels (``repro_torch.kernels``); on the CPU the
same functions take their plain versions.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(shape, dtype, generator: Optional[torch.Generator], device,
               scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def embed_init(shape, dtype, generator, device) -> torch.Tensor:
    return dense_init(shape, dtype, generator, device, scale=0.02)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, lead: Tuple[int, ...], device) -> Params:
    d = cfg.d_model
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones(*lead, d, dtype=cfg.pdtype, device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(*lead, d, dtype=cfg.pdtype, device=device),
                "bias": torch.zeros(*lead, d, dtype=cfg.pdtype, device=device)}
    if cfg.norm_type == "nonparametric_ln":  # olmo: no learned affine
        return {}
    raise ValueError(cfg.norm_type)


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type == "rmsnorm":
        return kops.rmsnorm(x, p["scale"], cfg.norm_eps)
    xf = x.float()  # layernorm / nonparametric_ln stay plain torch, as in JAX
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    if p:
        out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """QK-norm over head_dim (qwen3)."""
    return kops.rmsnorm(x, scale, eps)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Split
    halves, not interleaved pairs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, lead: Tuple[int, ...], generator, device) -> Params:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dt = cfg.pdtype
    p: Params = {
        "wq": dense_init((*lead, d, qd), dt, generator, device),
        "wk": dense_init((*lead, d, kvd), dt, generator, device),
        "wv": dense_init((*lead, d, kvd), dt, generator, device),
        "wo": dense_init((*lead, qd, d), dt, generator, device,
                         scale=1.0 / math.sqrt(qd * 2 * cfg.n_layers)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(*lead, qd, dtype=dt, device=device)
        p["bk"] = torch.zeros(*lead, kvd, dtype=dt, device=device)
        p["bv"] = torch.zeros(*lead, kvd, dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(*lead, cfg.head_dim, dtype=dt, device=device)
        p["k_norm"] = torch.ones(*lead, cfg.head_dim, dtype=dt, device=device)
    return p


def qkv_project(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: Optional[torch.Tensor], rope: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if "q_norm" in p:
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])
    if rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mha_chunk(q, k, v, *, causal: bool, q_offset: int,
               kv_len: Optional[torch.Tensor]) -> torch.Tensor:
    """One dense attention block: q (B,Sq,H,hd), k/v (B,Skv,G,hd).

    Returns (B, Sq, H, hd). fp32 softmax. ``kv_len`` masks a padded KV cache.
    """
    B, Sq, H, hd = q.shape
    Skv, G = k.shape[1], k.shape[2]
    rep = H // G
    qg = q.reshape(B, Sq, G, rep, hd)
    scores = torch.einsum("bqgrh,bkgh->bgrqk", qg, k).float()
    scores = scores / math.sqrt(hd)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        kpos = torch.arange(Skv, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask[None, None, None], scores, -1e30)
    if kv_len is not None:
        valid = torch.arange(Skv, device=q.device)[None, :] < kv_len[:, None]   # (B, Skv)
        scores = torch.where(valid[:, None, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgh->bqgrh", probs, v)
    return out.reshape(B, Sq, H, hd)


def attention_core(cfg: ModelConfig, q, k, v, *, causal: bool = True,
                   kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,T,G,hd). Returns (B,S,H,hd).

    ``q.is_cuda`` stands where the JAX model tests ``cfg.use_pallas``: on
    CUDA the flash kernel takes exactly the case the JAX model sends to its
    Pallas kernel (causal, no ``kv_len``, S == T); every other case, and
    every case on the CPU, runs the query-chunked model path, as JAX does
    without Pallas."""
    if q.is_cuda and causal and kv_len is None and q.shape[1] == k.shape[1]:
        return kops.flash_attention(q, k, v, causal=True)
    B, S, H, hd = q.shape
    chunk = min(cfg.attn_chunk, S)
    if S % chunk != 0:
        chunk = S  # dense for ragged shapes, as in JAX
    outs = [_mha_chunk(q[:, i:i + chunk], k, v, causal=causal, q_offset=i, kv_len=kv_len)
            for i in range(0, S, chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def decode_attention_core(cfg: ModelConfig, q, k_cache, v_cache, kv_len) -> torch.Tensor:
    """Single-token attention against a padded KV cache.

    q: (B,1,H,hd); caches: (B,T,G,hd); kv_len: (B,) int32 valid lengths.
    On CUDA (the port's ``cfg.use_pallas``) the decode kernel reads the
    cache in place by strides; elsewhere the chunked model path runs."""
    if q.is_cuda:
        return kops.decode_attention(q, k_cache, v_cache, kv_len)
    return _mha_chunk(q, k_cache, v_cache, causal=False, q_offset=0, kv_len=kv_len)


def attention_out(cfg: ModelConfig, p: Params, o: torch.Tensor) -> torch.Tensor:
    B, S = o.shape[:2]
    return o.reshape(B, S, cfg.q_dim) @ p["wo"].to(o.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, lead: Tuple[int, ...], generator, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.pdtype
    return {
        "w_gate": dense_init((*lead, d, f), dt, generator, device),
        "w_up": dense_init((*lead, d, f), dt, generator, device),
        "w_down": dense_init((*lead, f, d), dt, generator, device,
                             scale=1.0 / math.sqrt(f * 2 * cfg.n_layers)),
    }


def apply_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p["w_gate"].to(x.dtype))
    u = x @ p["w_up"].to(x.dtype)
    return (g * u) @ p["w_down"].to(x.dtype)

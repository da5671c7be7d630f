"""Dense layers in PyTorch: norms, RoPE, GQA attention, latent attention
(MLA), SwiGLU.

Mirrors the JAX package's ``models/layers.py`` (dense parts). Parameters are
plain dicts of tensors in the ``.trims`` layout: weights are ``(in, out)``
and used as ``x @ W``, never transposed into ``nn.Linear``. The
``part.shard_*`` layout constraints stand where the reference has them: the
identity with no mesh, a ``DTensor`` redistribution under one. On CUDA the
rmsnorms, prefill attention and decode attention go through the
hand-written kernels (``repro_torch.kernels``); on the CPU the same
functions take their plain versions.

Latent attention (MLA, DeepSeek-V2/V3; the port's own, the JAX package has
none) projects each token to a latent ``c_kv`` of ``kv_lora_rank`` values,
normed, and one RoPE key part ``k_pe`` shared by the heads; the decode cache
holds those two and nothing per head. Prefill expands the latent into each
head's keys and values (the non-absorbed form, through the ``flash_fwd``
kernel instantiated for 192-wide keys and 128-wide values); a decode step folds the key expansion
into the query and the value expansion into the output (the absorbed form)
and attends over the latent cache with the ``mla_decode`` kernel
(``docs/TORCH_DESIGN.md`` section 10).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import partitioning as part
from repro_torch.runtime import trace

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


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               interleave: bool = False) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Split
    halves; with ``interleave``, pairs (2i, 2i + 1) are rotated by frequency
    i and the result is laid out as split halves (DeepSeek-V3's modeling
    code de-interleaves before ``rotate_half``)."""
    hd = x.shape[-1]
    if interleave:
        x = x.unflatten(-1, (hd // 2, 2)).transpose(-1, -2).flatten(-2)
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
    q = part.shard_heads(part.splittable(q, cfg.n_heads).reshape(B, S, cfg.n_heads,
                                                                 cfg.head_dim))
    k = part.shard_heads(part.splittable(k, cfg.n_kv_heads).reshape(B, S, cfg.n_kv_heads,
                                                                    cfg.head_dim))
    v = part.shard_heads(part.splittable(v, cfg.n_kv_heads).reshape(B, S, cfg.n_kv_heads,
                                                                    cfg.head_dim))
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
    if part.is_distributed(q):     # on local shards, as the kernels (kernels/ops.py)
        return kops.local_attention(
            lambda q, k, v, *kl: _chunked(cfg, q, k, v, causal, kl[0] if kl else None),
            q, k, v, kv_len)
    return _chunked(cfg, q, k, v, causal, kv_len)


def _chunked(cfg: ModelConfig, q, k, v, causal: bool, kv_len) -> torch.Tensor:
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
    k_cache = part.shard_cache(k_cache)
    v_cache = part.shard_cache(v_cache)
    if part.is_distributed(q):
        return kops.local_attention(
            lambda q, k, v, kl: _mha_chunk(q, k, v, causal=False, q_offset=0, kv_len=kl),
            q, k_cache, v_cache, kv_len)
    return _mha_chunk(q, k_cache, v_cache, causal=False, q_offset=0, kv_len=kv_len)


def attention_out(cfg: ModelConfig, p: Params, o: torch.Tensor) -> torch.Tensor:
    B, S = o.shape[:2]
    return o.reshape(B, S, cfg.q_dim) @ p["wo"].to(o.dtype)


# ---------------------------------------------------------------------------
# latent attention (MLA)
# ---------------------------------------------------------------------------

MLA_NORM_EPS = 1e-6     # the latent's RMSNorm: DeepSeek-V3 builds it with the default eps


def init_mla(cfg: ModelConfig, lead: Tuple[int, ...], generator, device) -> Params:
    """``wq`` (d, H * (nope + rope)), ``w_kv_a`` (d, r + rope), ``kv_norm``
    (r,), ``w_kv_b`` (r, H * (nope + v)) and ``wo`` (H * v, d); each head's
    columns are contiguous, nope first."""
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = cfg.pdtype
    return {"wq": dense_init((*lead, d, H * (dn + dr)), dt, generator, device),
            "w_kv_a": dense_init((*lead, d, r + dr), dt, generator, device),
            "kv_norm": torch.ones(*lead, r, dtype=dt, device=device),
            "w_kv_b": dense_init((*lead, r, H * (dn + dv)), dt, generator, device),
            "wo": dense_init((*lead, H * dv, d), dt, generator, device,
                             scale=1.0 / math.sqrt(H * dv * 2 * cfg.n_layers))}


def mla_project(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor):
    """x (B, S, d) -> (q_nope (B, S, H, nope), q_pe (B, S, H, rope),
    c_kv (B, S, 1, r) normed, k_pe (B, S, 1, rope)): RoPE on ``q_pe`` and
    ``k_pe``; ``c_kv`` and ``k_pe`` are what the cache holds."""
    B, S, _ = x.shape
    H, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = (x @ p["wq"].to(x.dtype)).view(B, S, H, dn + dr)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    c_kv, k_pe = (x @ p["w_kv_a"].to(x.dtype)).split([r, dr], dim=-1)
    c_kv = kops.rmsnorm(c_kv, p["kv_norm"], MLA_NORM_EPS)
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta, interleave=True)
    k_pe = apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta, interleave=True)
    return q_nope, q_pe, c_kv[:, :, None, :], k_pe


def mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def mla_attention(cfg: ModelConfig, p: Params, q_nope, q_pe, c_kv, k_pe, *,
                  causal: bool = True) -> torch.Tensor:
    """The non-absorbed form over a whole sequence: each head's keys
    ``[c_kv @ W_UK, k_pe]`` and values ``c_kv @ W_UV``, then attention at
    scale 1/sqrt(nope + rope). Returns (B, S, H * v) before ``wo``."""
    B, S, H, dn = q_nope.shape
    dv = cfg.v_head_dim
    with trace.span("mla.attn", rows=B * S):
        kv = (c_kv[:, :, 0] @ p["w_kv_b"].to(c_kv.dtype)).view(B, S, H, dn + dv)
        k_nope, v = kv.split([dn, dv], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(B, S, H, k_pe.shape[-1])], dim=-1)
        o = kops.flash_attention(q, k, v, causal=causal)     # scale 1/sqrt(nope + rope)
    return o.reshape(B, S, H * dv)


def mla_decode_attention(cfg: ModelConfig, p: Params, q_nope, q_pe, c_cache, pe_cache,
                         kv_len: torch.Tensor, known_len: Optional[int] = None
                         ) -> torch.Tensor:
    """The absorbed form for one token against the latent cache:
    ``q_lat = q_nope @ W_UK`` (r a head), scores of ``[q_lat, q_pe]``
    against each cached ``[c_kv, k_pe]``, then ``(P @ c_kv) @ W_UV``.
    q_nope (B, 1, H, nope), q_pe (B, 1, H, rope); caches (B, T, 1, r) and
    (B, T, 1, rope); kv_len (B,) int32. Returns (B, 1, H * v) before
    ``wo``. ``known_len`` is the valid length where the host knows it (the
    span's attribute; None in a step captured with its position on the
    device)."""
    B, _, H, dn = q_nope.shape
    r, dv = cfg.kv_lora_rank, cfg.v_head_dim
    w = p["w_kv_b"].to(q_nope.dtype).view(r, H, dn + dv)
    with trace.span("mla.decode", kv_len=known_len):
        q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w[..., :dn])
        q = torch.cat([q_lat, q_pe[:, 0]], dim=-1)                   # (B, H, r + rope)
        o_lat = kops.mla_decode(q, c_cache, pe_cache, kv_len, mla_scale(cfg))
        o = torch.einsum("bhr,rhv->bhv", o_lat, w[..., dn:])
    return o.reshape(B, 1, H * dv)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, lead: Tuple[int, ...], generator, device,
             d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
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
    h = part.shard_ffn(g * u)
    return h @ p["w_down"].to(x.dtype)

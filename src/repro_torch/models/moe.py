"""Token-choice top-k Mixture-of-Experts in PyTorch.

Mirrors the JAX package's ``models/moe.py``. Parameters are plain dicts of
tensors, as in ``layers.py``; the MRM hands every handle the same device
copy, so nothing here is an ``nn.Module``. The reference has no Pallas
kernel in this module: its einsums and ``lax.ragged_dot`` are plain
products, and here they are ``torch.bmm`` / ``@``.

``capacity``  GShard/Switch capacity-bounded dispatch into (E, C, D) expert
              buffers and one batched product per weight. The default.
``ragged``    sort-by-expert and one product per non-empty expert over its
              contiguous rows. No capacity drops.
``grouped``   capacity dispatch per batch row, (B, E, C, D) buffers.
``ep``        on one device, the grouped path (see :func:`apply_moe`).

Two choices keep every path exact and repeatable, on the CPU and on CUDA:

- Top-k is a stable descending sort, so tied router probabilities go to
  the lower expert index, as ``jax.lax.top_k`` breaks them. ``torch.topk``
  promises no order on ties.
- The combine gathers each token's K assignment rows into (T, K, D) and
  sums them in float32 in the order k = 0..K-1, then casts once. The
  reference scatter-adds (``.at[].add``); ``index_add_`` on CUDA is
  atomic, and its float sums would vary from run to run.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init

Params = Dict[str, torch.Tensor]


def init_moe(cfg: ModelConfig, lead: Tuple[int, ...], generator, device) -> Params:
    """The JAX init's shapes, dtypes and scales, with a leading ``lead``
    axis. The JAX ``dense_init`` takes its fan-in from the first axis, which
    is E for the (E, d, f) expert banks, so their scale is given here."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.pdtype
    p: Params = {
        "router": dense_init((*lead, d, e), torch.float32, generator, device, scale=0.02),
        "w_gate": dense_init((*lead, e, d, f), dt, generator, device,
                             scale=1.0 / math.sqrt(e)),
        "w_up": dense_init((*lead, e, d, f), dt, generator, device,
                           scale=1.0 / math.sqrt(e)),
        "w_down": dense_init((*lead, e, f, d), dt, generator, device,
                             scale=1.0 / math.sqrt(f * 2 * cfg.n_layers)),
    }
    if cfg.n_shared_experts:
        sf = f * cfg.n_shared_experts
        p["shared_gate"] = dense_init((*lead, d, sf), dt, generator, device)
        p["shared_up"] = dense_init((*lead, d, sf), dt, generator, device)
        p["shared_down"] = dense_init((*lead, sf, d), dt, generator, device)
    return p


def router_topk(cfg: ModelConfig, p: Params, x2d: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (weights (T,k) in x's dtype, indices (T,k), aux_loss scalar).

    Logits are a product in x's dtype, then cast to float32, as in the
    reference. Ties go to the lower expert index (stable sort)."""
    E, K = cfg.n_experts, cfg.top_k
    logits = (x2d @ p["router"].to(x2d.dtype)).float()               # (T,E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :K], topi[:, :K]
    topw = topw / topw.sum(-1, keepdim=True)
    # load-balancing aux: E * sum_e (frac_tokens_e * mean_prob_e)
    onehot = F.one_hot(topi, E).float()                              # (T,k,E)
    frac = onehot.sum(1).mean(0)
    aux = E * (frac * probs.mean(0)).sum()
    return topw.to(x2d.dtype), topi, aux


def _expert_ffn_batched(p: Params, xe: torch.Tensor, dtype) -> torch.Tensor:
    """xe: (E, C, D) -> (E, C, D) via per-expert SwiGLU."""
    g = F.silu(torch.bmm(xe, p["w_gate"].to(dtype)))
    u = torch.bmm(xe, p["w_up"].to(dtype))
    return torch.bmm(g * u, p["w_down"].to(dtype))


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert, on the host with the reference's float operations."""
    return max(1, int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))


def _slot_positions(e_flat: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """Slot of each assignment along the last axis of ``e_flat`` (..., N):
    ``e * C + (assignments to e before it)``, or the trash slot ``E * C``
    once expert e's C slots are taken (dropped, in that order)."""
    onehot = F.one_hot(e_flat, E)                                     # (..., N, E)
    before = onehot.cumsum(-2) - onehot
    pos = before.gather(-1, e_flat[..., None])[..., 0]
    return torch.where(pos < C, e_flat * C + pos, E * C)


def _combine(g: torch.Tensor, K: int, dtype) -> torch.Tensor:
    """Sum each token's K assignment rows. ``g`` holds them gathered,
    (..., T*K, D) in (t, k) order; they are added in float32 in the order
    k = 0..K-1 and cast once to ``dtype``. Deterministic: gathers and adds,
    no atomic scatter."""
    g = g.reshape(*g.shape[:-2], g.shape[-2] // K, K, g.shape[-1])
    out = g[..., 0, :].float()
    for k in range(1, K):
        out = out + g[..., k, :].float()
    return out.to(dtype)


def moe_capacity(cfg: ModelConfig, p: Params, x2d: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded dispatch. x2d: (T, D). Returns (out (T,D), aux).

    No host sync: C comes from the shapes, everything else stays on the
    device."""
    T, D = x2d.shape
    E, K = cfg.n_experts, cfg.top_k
    dt = x2d.dtype
    topw, topi, aux = router_topk(cfg, p, x2d)

    C = _capacity(T, cfg)
    slot = _slot_positions(topi.reshape(-1), E, C)                   # (T*K,)
    tok_flat = torch.arange(T, device=x2d.device).repeat_interleave(K)
    # token ids and weights into slots; duplicates land only in the trash
    # slot E*C, which is cut off
    slot_tok = torch.full((E * C + 1,), T, dtype=torch.long, device=x2d.device)
    slot_tok[slot] = tok_flat
    slot_w = torch.zeros(E * C + 1, dtype=dt, device=x2d.device)
    slot_w[slot] = topw.reshape(-1)
    slot_tok, slot_w = slot_tok[:-1], slot_w[:-1]

    x_pad = torch.cat([x2d, x2d.new_zeros(1, D)])
    xe = x_pad[slot_tok].reshape(E, C, D)                            # empty slot -> zero row
    ye = _expert_ffn_batched(p, xe, dt).reshape(E * C, D)
    ye = ye * slot_w[:, None]
    # each assignment reads its slot's row; a dropped one reads the zero row
    out = _combine(torch.cat([ye, ye.new_zeros(1, D)])[slot], K, dt)
    if cfg.n_shared_experts:
        out = out + _shared_ffn(p, x2d)
    return out, aux


def moe_ragged(cfg: ModelConfig, p: Params, x2d: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-by-expert and one product per non-empty expert. No token drops.
    Reads the group sizes on the host once."""
    T, D = x2d.shape
    E, K = cfg.n_experts, cfg.top_k
    dt = x2d.dtype
    topw, topi, aux = router_topk(cfg, p, x2d)

    e_flat = topi.reshape(-1)
    tok_flat = torch.arange(T, device=x2d.device).repeat_interleave(K)
    order = torch.argsort(e_flat, stable=True)                       # jnp.argsort is stable
    xs = x2d[tok_flat[order]]                                        # (T*K, D)
    sizes = torch.bincount(e_flat, minlength=E).tolist()

    ys = torch.empty_like(xs)
    start = 0
    for e, n in enumerate(sizes):
        if n:
            xg = xs[start:start + n]
            g = F.silu(xg @ p["w_gate"][e].to(dt))
            u = xg @ p["w_up"][e].to(dt)
            ys[start:start + n] = (g * u) @ p["w_down"][e].to(dt)
        start += n
    ys = ys * topw.reshape(-1)[order][:, None]
    # row of assignment j is ys[inverse[j]]; assignments run (t, k) in order
    out = _combine(ys[torch.argsort(order)], K, dt)
    if cfg.n_shared_experts:
        out = out + _shared_ffn(p, x2d)
    return out, aux


def _shared_ffn(p: Params, x2d: torch.Tensor) -> torch.Tensor:
    g = F.silu(x2d @ p["shared_gate"].to(x2d.dtype))
    u = x2d @ p["shared_up"].to(x2d.dtype)
    return (g * u) @ p["shared_down"].to(x2d.dtype)


def moe_capacity_grouped(cfg: ModelConfig, p: Params, x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-local capacity dispatch: one dispatch problem per batch row,
    C from S (the reference's GSPMD 'group' pattern). x: (B, S, D)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    dt = x.dtype
    topw, topi, aux = router_topk(cfg, p, x.reshape(B * S, D))

    C = _capacity(S, cfg)
    slot = _slot_positions(topi.reshape(B, S * K), E, C)             # (B, S*K)
    rows = torch.arange(B, device=x.device)[:, None]
    tok_flat = torch.arange(S, device=x.device).repeat_interleave(K).expand(B, S * K)
    slot_tok = torch.full((B, E * C + 1), S, dtype=torch.long, device=x.device)
    slot_tok[rows, slot] = tok_flat
    slot_w = torch.zeros(B, E * C + 1, dtype=dt, device=x.device)
    slot_w[rows, slot] = topw.reshape(B, S * K)
    slot_tok, slot_w = slot_tok[:, :-1], slot_w[:, :-1]

    x_pad = torch.cat([x, x.new_zeros(B, 1, D)], dim=1)
    xe = x_pad[rows, slot_tok]                                       # (B, E*C, D)
    xe = xe.reshape(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)
    ye = _expert_ffn_batched(p, xe, dt)
    ye = ye.reshape(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)
    ye = ye * slot_w[..., None]

    out = _combine(torch.cat([ye, ye.new_zeros(B, 1, D)], dim=1)[rows, slot], K, dt)
    if cfg.n_shared_experts:
        out = out + _shared_ffn(p, x.reshape(B * S, D)).reshape(B, S, D)
    return out, aux


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss)."""
    B, S, D = x.shape
    if cfg.moe_impl == "ragged":
        out, aux = moe_ragged(cfg, p, x.reshape(B * S, D))
        return out.reshape(B, S, D), aux
    if cfg.moe_impl in ("grouped", "ep"):
        # "ep" without a mesh is the grouped path, as in the reference;
        # expert-parallel sharding belongs to the distribution slice
        return moe_capacity_grouped(cfg, p, x)
    out, aux = moe_capacity(cfg, p, x.reshape(B * S, D))
    return out.reshape(B, S, D), aux

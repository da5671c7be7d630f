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
``ep``        expert parallelism over the mesh's ``model`` axis
              (:func:`moe_ep`); the grouped path without a mesh.

Under a device mesh (``DTensor`` inputs) ``ep`` is the reference's
``moe_ep_shardmap``: each rank of the ``model`` axis owns E/TP experts,
routes its rows of the token block (replicated over ``model``), computes
only the assignments that land on its experts, and one all-reduce over
``model`` adds the partial outputs. The other paths index and scatter in
ways DTensor has no rule for, so they run whole on every rank: the tokens
and expert weights gathered, the result replicated (the reference leaves
their partitioning to GSPMD).

Routing is softmax over the router's logits by default. With
``cfg.router_scoring == "sigmoid"`` (DeepSeek-V3's ``noaux_tc`` with one
group, the port's own: the JAX package has no such router) the scores are
the logits' sigmoids, in float32; the top k are chosen on the scores plus a
float32 ``router_bias`` (E,) and weighted by the unbiased scores,
normalised over the k, times ``cfg.routed_scaling_factor``.

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
from repro_torch.models import partitioning as part
from repro_torch.models.layers import dense_init
from repro_torch.runtime import trace

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
    if cfg.router_scoring == "sigmoid":
        p["router_bias"] = torch.zeros(*lead, e, dtype=torch.float32, device=device)
    if cfg.n_shared_experts:
        sf = f * cfg.n_shared_experts
        p["shared_gate"] = dense_init((*lead, d, sf), dt, generator, device)
        p["shared_up"] = dense_init((*lead, d, sf), dt, generator, device)
        p["shared_down"] = dense_init((*lead, sf, d), dt, generator, device)
    return p


def router_topk(cfg: ModelConfig, p: Params, x2d: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (weights (T,k) in x's dtype, indices (T,k), aux_loss scalar).

    Softmax: logits are a product in x's dtype, then cast to float32, as in
    the reference. Sigmoid: a float32 product, as DeepSeek-V3's gate; the
    aux loss is the same formula over the scores normalised per token. Ties
    go to the lower expert index (stable sort)."""
    E, K = cfg.n_experts, cfg.top_k
    with trace.span("moe.route", scoring=cfg.router_scoring):
        if cfg.router_scoring == "sigmoid":
            scores = torch.sigmoid(x2d.float() @ p["router"].float())   # (T,E)
            _, topi = torch.sort(scores + p["router_bias"].float(), dim=-1, descending=True,
                                 stable=True)
            topi = topi[:, :K]
            topw = scores.gather(-1, topi)
            topw = topw / (topw.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
            probs = scores / scores.sum(-1, keepdim=True)
        else:
            logits = (x2d @ p["router"].to(x2d.dtype)).float()           # (T,E)
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
    with trace.span("moe.experts"):
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
    with trace.span("moe.dispatch", rows=T):
        slot = _slot_positions(topi.reshape(-1), E, C)               # (T*K,)
        tok_flat = torch.arange(T, device=x2d.device).repeat_interleave(K)
        # token ids and weights into slots; duplicates land only in the trash
        # slot E*C, which is cut off
        slot_tok = torch.full((E * C + 1,), T, dtype=torch.long, device=x2d.device)
        slot_tok[slot] = tok_flat
        slot_w = torch.zeros(E * C + 1, dtype=dt, device=x2d.device)
        slot_w[slot] = topw.reshape(-1)
        slot_tok, slot_w = slot_tok[:-1], slot_w[:-1]

        x_pad = torch.cat([x2d, x2d.new_zeros(1, D)])
        xe = x_pad[slot_tok].reshape(E, C, D)                        # empty slot -> zero row
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


def _apply_local(cfg: ModelConfig, p: Params, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x.shape
    if cfg.moe_impl == "ragged":
        out, aux = moe_ragged(cfg, p, x.reshape(B * S, D))
        return out.reshape(B, S, D), aux
    if cfg.moe_impl in ("grouped", "ep"):
        # "ep" without a mesh is the grouped path, as in the reference
        return moe_capacity_grouped(cfg, p, x)
    out, aux = moe_capacity(cfg, p, x.reshape(B * S, D))
    return out.reshape(B, S, D), aux


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss)."""
    if not part.is_distributed(x):
        return _apply_local(cfg, p, x)
    if cfg.moe_impl == "ep":
        return moe_ep(cfg, p, x)
    return _replicated(cfg, p, x)


# ---------------------------------------------------------------------------
# under a device mesh
# ---------------------------------------------------------------------------


def _replicated(cfg: ModelConfig, p: Params, x):
    """A non-EP path on DTensors: every rank runs it on the whole token
    block with the whole weights; the output is replicated, then pinned to
    the batch axes."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    rep = (Replicate(),) * mesh.ndim
    names = sorted(p)
    fn = local_map(lambda x, *w: _apply_local(cfg, dict(zip(names, w)), x),
                   out_placements=(rep, rep), in_placements=(rep,) * (1 + len(names)),
                   device_mesh=mesh, redistribute_inputs=True)
    out, aux = fn(x, *(p[k] for k in names))
    return part.shard_btd(out), aux


def moe_ep(cfg: ModelConfig, p: Params, x):
    """Explicit expert parallelism over the ``model`` axis of ``x``'s mesh
    (the reference's ``moe_ep_shardmap``). Falls back to the grouped path
    (replicated) without a ``model`` axis or when E % TP != 0.

    Each rank keeps its rows of the batch (the batch axes), all of S and D,
    and E/TP experts with their whole FFN width. It routes its rows over
    all E experts, dispatches per row with the grouped path's capacity
    C = ceil(S*K/E * cf), runs its experts, and combines each token's K
    rows by gather and an ordered float32 sum (no atomics); the rows of
    experts it does not own are zero. The partial outputs are a DTensor
    ``Partial`` over ``model``, whose redistribution is the one all-reduce.
    The aux loss needs the global means of the routing: each rank returns
    its sums (model rank 0's alone, so the other ranks' identical routing is
    not counted again, in value or in gradient), and the mesh adds them."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if cfg.router_scoring != "softmax":
        raise NotImplementedError("expert parallelism routes by softmax only; "
                                  f"{cfg.name} scores by {cfg.router_scoring}")
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    if "model" not in sizes or cfg.n_experts % sizes["model"]:
        return _replicated(cfg.replace(moe_impl="grouped"), p, x)
    mdim = names.index("model")
    tp = sizes["model"]
    m = mesh.get_local_rank(mdim)
    E = cfg.n_experts
    E_l = E // tp
    B, S, D = x.shape
    C = _capacity(S, cfg)

    x_pl, out_pl, sum_pl, w_pl, w_grad, r_grad, x_grad = [], [], [], [], [], [], []
    for i, name in enumerate(names):
        if i == mdim:
            x_pl.append(Replicate()); x_grad.append(Partial())
            out_pl.append(Partial()); sum_pl.append(Partial())
            w_pl.append(Shard(0)); w_grad.append(Shard(0)); r_grad.append(Partial())
        elif name in ("pod", "data", part.FLAT) and B % mesh.shape[i] == 0 and \
                isinstance(x.placements[i], Shard) and x.placements[i].dim == 0:
            x_pl.append(Shard(0)); x_grad.append(Shard(0))
            out_pl.append(Shard(0)); sum_pl.append(Partial())
            w_pl.append(Replicate()); w_grad.append(Partial()); r_grad.append(Partial())
        else:
            for lst in (x_pl, x_grad, out_pl, sum_pl, w_pl, w_grad, r_grad):
                lst.append(Replicate())
    x_pl, out_pl, sum_pl, w_pl = tuple(x_pl), tuple(out_pl), tuple(sum_pl), tuple(w_pl)
    rep = (Replicate(),) * mesh.ndim

    def local(xl, router, wg, wu, wd):
        out, frac_sum, prob_sum = _ep_local(cfg, xl, router, wg, wu, wd, m * E_l, C)
        if m != 0:      # one model rank's routing sums count
            frac_sum, prob_sum = frac_sum * 0, prob_sum * 0
        return out, frac_sum, prob_sum

    fn = local_map(local, out_placements=(out_pl, sum_pl, sum_pl),
                   in_placements=(x_pl, rep, w_pl, w_pl, w_pl),
                   in_grad_placements=(tuple(x_grad), tuple(r_grad), tuple(w_grad),
                                       tuple(w_grad), tuple(w_grad)),
                   device_mesh=mesh, redistribute_inputs=True)
    out, frac_sum, prob_sum = fn(x, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    out = part.shard_btd(out.redistribute(mesh, tuple(Replicate() if isinstance(pl, Partial)
                                                      else pl for pl in out_pl)))
    n_tok = B * S
    aux = E * ((frac_sum / n_tok) * (prob_sum / n_tok)).sum()
    aux = aux.redistribute(mesh, rep) if part.is_distributed(aux) else aux
    if cfg.n_shared_experts:
        out = out + _shared_ffn(p, x.reshape(B * S, D)).reshape(B, S, D)
    return out, aux


def _ep_local(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor, wg, wu, wd,
              e0: int, C: int):
    """One rank's share of :func:`moe_ep`: x (b, S, D) its rows, the
    experts ``e0 .. e0 + E_l - 1`` (``wg``/``wu``/``wd`` their banks).
    Returns (the partial output (b, S, D), the per-expert sums over its
    tokens of the top-k indicator and of the router probabilities)."""
    b, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    E_l = wg.shape[0]
    dt = x.dtype
    logits = (x.reshape(b * S, D) @ router.to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :K], topi[:, :K]
    topw = (topw / topw.sum(-1, keepdim=True)).to(dt)
    frac_sum = F.one_hot(topi, E).float().sum((0, 1))
    prob_sum = probs.sum(0)

    rel = topi.reshape(b, S * K) - e0
    valid = (rel >= 0) & (rel < E_l)
    e_loc = torch.where(valid, rel, E_l)                             # E_l: not ours
    slot = _slot_positions(e_loc, E_l + 1, C)
    slot = torch.where(valid & (slot < E_l * C), slot, E_l * C)      # others, drops -> trash
    rows = torch.arange(b, device=x.device)[:, None]
    tok_flat = torch.arange(S, device=x.device).repeat_interleave(K).expand(b, S * K)
    slot_tok = torch.full((b, E_l * C + 1), S, dtype=torch.long, device=x.device)
    slot_tok[rows, slot] = tok_flat
    slot_w = torch.zeros(b, E_l * C + 1, dtype=dt, device=x.device)
    slot_w[rows, slot] = topw.reshape(b, S * K)
    slot_tok, slot_w = slot_tok[:, :-1], slot_w[:, :-1]

    x_pad = torch.cat([x, x.new_zeros(b, 1, D)], dim=1)
    xe = x_pad[rows, slot_tok]                                       # (b, E_l*C, D)
    xe = xe.reshape(b, E_l, C, D).transpose(0, 1).reshape(E_l, b * C, D)
    ye = _expert_ffn_batched({"w_gate": wg, "w_up": wu, "w_down": wd}, xe, dt)
    ye = ye.reshape(E_l, b, C, D).transpose(0, 1).reshape(b, E_l * C, D)
    ye = ye * slot_w[..., None]
    out = _combine(torch.cat([ye, ye.new_zeros(b, 1, D)], dim=1)[rows, slot], K, dt)
    return out, frac_sum, prob_sum

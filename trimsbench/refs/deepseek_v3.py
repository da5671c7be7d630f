"""The plain float32 forward of a DeepSeek-V3 decoder (``model_type``
``deepseek_v3``), from its published description (DeepSeek-V3 technical
report, arXiv:2412.19437; the Hugging Face modeling code of
``deepseek_v3``): pre-norm latent attention in every layer, the leading
``first_k_dense_replace`` layers with a SwiGLU MLP, then MoE layers.

- Attention (MLA) in the non-absorbed form: each head's query
  ``[q_nope, q_pe]`` from ``wq``; the latent ``[c_kv, k_pe]`` from
  ``w_kv_a``, ``c_kv`` normed (RMSNorm, eps 1e-6, the modeling code's
  default); each head's keys ``[c_kv @ W_UK, k_pe]`` and values
  ``c_kv @ W_UV`` from ``w_kv_b``; RoPE on ``q_pe`` and the one ``k_pe``
  on interleaved pairs; scale 1/sqrt(nope + rope).
- MoE: sigmoid scores of the router's logits; the top k chosen on score +
  ``router_bias`` (ties to the lower expert index); their unbiased scores
  normalised and times ``routed_scaling_factor``; plus the shared experts'
  SwiGLU of width ``n_shared_experts * moe_intermediate_size`` on every
  token.

Departures, each stated by the configuration's file: the head is tied to
the embedding; the routed experts take their assignments with a capacity
(``reference.py``'s rule, ``assumed.capacity_factor``) where the published
router is dropless; ``n_group`` and ``topk_group`` are 1, so the group
choice of ``noaux_tc`` is the identity and is left out.
"""
from __future__ import annotations

import math

import torch

from trimsbench.reference import Linear, Weights, capacity, layer, mlp, rmsnorm, rope

LATENT_EPS = 1e-6


def _rope_pairs(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE on interleaved pairs (2i, 2i + 1), laid out as split halves, as
    the modeling code de-interleaves before ``rotate_half``."""
    hd = x.shape[-1]
    return rope(x.unflatten(-1, (hd // 2, 2)).transpose(-1, -2).flatten(-2), pos, theta)


def mla(c: dict, p: Weights, h: torch.Tensor, lin: Linear) -> torch.Tensor:
    """Causal latent attention of one layer over h (B, T, d), one sequence
    at a time."""
    B, T, _ = h.shape
    H, r = c["num_attention_heads"], c["kv_lora_rank"]
    dn, dr, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    pos = torch.arange(T, device=h.device)
    causal = pos[:, None] >= pos[None, :]
    out = torch.empty(B, T, H * dv, device=h.device)
    for b in range(B):
        q = lin(h[b], p["wq"]).view(T, H, dn + dr)
        q_nope, q_pe = q[..., :dn], _rope_pairs(q[..., dn:], pos, c["rope_theta"])
        latent = lin(h[b], p["w_kv_a"])
        c_kv = rmsnorm(latent[:, :r], p["kv_norm"], LATENT_EPS)
        k_pe = _rope_pairs(latent[:, None, r:], pos, c["rope_theta"])       # (T, 1, dr)
        kv = lin(c_kv, p["w_kv_b"]).view(T, H, dn + dv)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        s = (torch.einsum("qhd,khd->hqk", q_nope, k_nope)
             + torch.einsum("qhd,kd->hqk", q_pe, k_pe[:, 0])) / math.sqrt(dn + dr)
        p_attn = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        out[b] = torch.einsum("hqk,khd->qhd", p_attn, v).reshape(T, H * dv)
    return lin(out, p["wo"])


def moe(c: dict, p: Weights, x: torch.Tensor, prompt_len: int, lin: Linear) -> torch.Tensor:
    """Sigmoid-routed top-k MoE of one layer with shared experts over x
    (B, T, d), dispatched with a capacity in groups as ``reference.moe``:
    the first ``prompt_len`` positions of all rows form one group
    (row-major), every later position one group of B tokens; an expert
    takes at most ``capacity`` assignments of a group, in the order token
    by token, then by rank; a dropped one adds nothing."""
    B, T, d = x.shape
    E, K = c["n_routed_experts"], c["num_experts_per_tok"]
    parts = [x[:, :prompt_len].reshape(B * prompt_len, d)]
    parts += [x[:, t] for t in range(prompt_len, T)]
    sizes = [q.shape[0] for q in parts]
    flat = torch.cat(parts)                                            # (N, d)
    scores = torch.sigmoid(lin(flat, p["router"]))
    topi = torch.sort(scores + p["router_bias"].float(), dim=-1, descending=True,
                      stable=True).indices[:, :K]
    topw = scores.gather(-1, topi)
    topw = topw / (topw.sum(-1, keepdim=True) + 1e-20) * c["routed_scaling_factor"]
    group = torch.repeat_interleave(torch.arange(len(sizes), device=x.device),
                                    torch.tensor(sizes, device=x.device))
    cfg = {"assumed": c["assumed"], "num_experts_per_tok": K, "num_experts": E}
    cap = torch.tensor([capacity(n, cfg) for n in sizes], device=x.device)
    key = (group[:, None] * E + topi).reshape(-1)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    rank = torch.empty_like(key)
    rank[order] = torch.arange(key.numel(), device=x.device) - torch.searchsorted(sk, sk)
    keep = rank < cap[group].repeat_interleave(K)
    tok = torch.arange(flat.shape[0], device=x.device).repeat_interleave(K)
    e_flat, w_flat = topi.reshape(-1), topw.reshape(-1)
    out = torch.zeros_like(flat)
    for e in range(E):
        sel = keep & (e_flat == e)
        if sel.any():
            t = tok[sel]
            out.index_add_(0, t, mlp(p, flat[t], lin, e=e) * w_flat[sel][:, None])
    shared = {"w_gate": p["shared_gate"], "w_up": p["shared_up"], "w_down": p["shared_down"]}
    out = out + mlp(shared, flat, lin)
    y = torch.empty_like(x)
    y[:, :prompt_len] = out[:sizes[0]].view(B, prompt_len, d)
    if T > prompt_len:
        y[:, prompt_len:] = out[sizes[0]:].view(T - prompt_len, B, d).transpose(0, 1)
    return y


def final_hidden(c: dict, w: Weights, tokens: torch.Tensor, prompt_len: int,
                 lin: Linear) -> torch.Tensor:
    eps = c["rms_norm_eps"]
    n_dense = c["first_k_dense_replace"]
    x = w["embed"][tokens].float()
    for i in range(c["num_hidden_layers"]):
        dense = i < n_dense
        pre, j = ("dense_layers/", i) if dense else ("layers/", i - n_dense)
        x = x + mla(c, layer(w, pre + "attn/", j), rmsnorm(x, w[pre + "ln1/scale"][j], eps), lin)
        h = rmsnorm(x, w[pre + "ln2/scale"][j], eps)
        ffn = layer(w, pre + "ffn/", j)
        x = x + (mlp(ffn, h, lin) if dense else moe(c, ffn, h, prompt_len, lin))
    return rmsnorm(x[:, prompt_len - 1:], w["final_norm/scale"], eps)


def logits(c: dict, w: Weights, h: torch.Tensor, lin: Linear) -> torch.Tensor:
    return lin(h, w["embed"][:c["vocab_size"]].T)

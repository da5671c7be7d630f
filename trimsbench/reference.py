"""Plain float32 forward of the benchmark's configurations, in PyTorch.

The yardstick that decides ``correct``. Each architecture's decoder is
written from its published description over the weights of ``weights.py``
in ``refs/<model_type>.py`` (``final_hidden`` and ``logits``), from the
blocks here; ``final_hidden`` and ``logits`` below find it by the
configuration's ``model_type``. Neither imports anything of the program or
uses a kernel of it: every product is a plain ``@`` in float32, with TF32
off (set here, before every call of an architecture's forward).

Departures from the published models, each stated by the configuration's
file: the input embedding is tied to the output head (``tie_word_embeddings``
true), and the MoE layers dispatch with a capacity, as the configuration
states (``assumed.moe_dispatch``): in every dispatch group (the prompt's
tokens together, then each decode position's batch) expert ``e`` takes at
most ``ceil(n * top_k / num_experts * capacity_factor)`` assignments, in
the order token by token, then by rank; a dropped assignment adds nothing
and the kept weights are not renormalised.

``precision`` rounds both operands of every product of activations and
weights (routers and head included) before the float32 product:
``"float8"`` to float8 e4m3 with a scale per row of the activations and per
output column of the weights, the control of the correctness check (the
precision below the configurations' bfloat16); ``"bfloat16"`` to bfloat16,
a witness of what rounding to the configurations' own precision does.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from trimsbench import spec

Weights = Dict[str, torch.Tensor]
E4M3_MAX = 448.0


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _bf16(t: torch.Tensor, dim: int) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


ROUND = {"float32": None, "float8": _fp8, "bfloat16": _bf16}


class Linear:
    """``x @ w`` in float32, its operands first rounded to ``precision``."""

    def __init__(self, precision: str = "float32"):
        self.round = ROUND[precision]

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.round is not None:
            return self.round(x, -1) @ self.round(w, -2)
        return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (T, H, hd) at ``positions`` (T,), rotating the
    two halves of each head (``rotate_half``)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device, dtype=torch.float64) / hd)
    ang = positions.double()[:, None] * inv[None, :]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def layer(w: Weights, prefix: str, i: int) -> Weights:
    """Layer ``i`` of every stacked leaf under ``prefix``, by the rest of
    its name: ``layer(w, "layers/attn/", 0)["wq"]``."""
    return {k[len(prefix):]: v[i] for k, v in w.items() if k.startswith(prefix)}


def attention(c: dict, p: Weights, h: torch.Tensor, lin: Linear) -> torch.Tensor:
    """Causal self-attention of one layer (``p``: ``wq``, ``wk``, ``wv``,
    ``wo`` and, with QK-norm, ``q_norm`` and ``k_norm``) over h (B, T, d),
    one sequence at a time, with RoPE."""
    B, T, d = h.shape
    H, G = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c.get("head_dim") or d // H
    pos = torch.arange(T, device=h.device)
    causal = pos[:, None] >= pos[None, :]
    out = torch.empty(B, T, H * hd, device=h.device)
    for b in range(B):
        q = lin(h[b], p["wq"]).view(T, H, hd)
        k = lin(h[b], p["wk"]).view(T, G, hd)
        v = lin(h[b], p["wv"]).view(T, G, hd)
        if "q_norm" in p:
            q = rmsnorm(q, p["q_norm"], c["rms_norm_eps"])
            k = rmsnorm(k, p["k_norm"], c["rms_norm_eps"])
        q, k = rope(q, pos, c["rope_theta"]), rope(k, pos, c["rope_theta"])
        k = k.repeat_interleave(H // G, dim=1)            # query head j reads kv head j // (H/G)
        v = v.repeat_interleave(H // G, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
        p_attn = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        out[b] = torch.einsum("hqk,khd->qhd", p_attn, v).reshape(T, H * hd)
    return lin(out, p["wo"])


def mlp(p: Weights, x: torch.Tensor, lin: Linear, e: Optional[int] = None) -> torch.Tensor:
    """SwiGLU of ``p``'s ``w_gate``, ``w_up``, ``w_down`` (expert ``e`` of
    them where given)."""
    def weight(n):
        return p[n] if e is None else p[n][e]
    g = lin(x, weight("w_gate"))
    return lin(torch.nn.functional.silu(g) * lin(x, weight("w_up")), weight("w_down"))


def capacity(n_tokens: int, c: dict) -> int:
    cf = c["assumed"]["capacity_factor"]
    return max(1, int(math.ceil(n_tokens * c["num_experts_per_tok"] / c["num_experts"] * cf)))


def moe(c: dict, p: Weights, x: torch.Tensor, prompt_len: int, lin: Linear) -> torch.Tensor:
    """Top-k MoE of one layer (``p``: ``router`` and the experts' stacked
    ``w_gate``, ``w_up``, ``w_down``) over x (B, T, d) with capacity
    dispatch: the first ``prompt_len`` positions of all rows form one group
    (row-major), every later position one group of B tokens."""
    B, T, d = x.shape
    E, K = c["num_experts"], c["num_experts_per_tok"]
    parts = [x[:, :prompt_len].reshape(B * prompt_len, d)]
    parts += [x[:, t] for t in range(prompt_len, T)]
    sizes = [p.shape[0] for p in parts]
    flat = torch.cat(parts)                                            # (N, d)
    probs = torch.softmax(lin(flat, p["router"]), dim=-1)
    topw, topi = torch.topk(probs, K, dim=-1)
    if c.get("norm_topk_prob", True):
        topw = topw / topw.sum(-1, keepdim=True)
    group = torch.repeat_interleave(torch.arange(len(sizes), device=x.device),
                                    torch.tensor(sizes, device=x.device))
    cap = torch.tensor([capacity(n, c) for n in sizes], device=x.device)
    # rank of each assignment among those of its expert in its group, in
    # (token, k) order
    key = (group[:, None] * E + topi).reshape(-1)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    first = torch.searchsorted(sk, sk)
    rank = torch.empty_like(key)
    rank[order] = torch.arange(key.numel(), device=x.device) - first
    keep = rank < cap[group].repeat_interleave(K)
    tok = torch.arange(flat.shape[0], device=x.device).repeat_interleave(K)
    e_flat, w_flat = topi.reshape(-1), topw.reshape(-1)
    out = torch.zeros_like(flat)
    for e in range(E):
        sel = keep & (e_flat == e)
        if sel.any():
            t = tok[sel]
            y = mlp(p, flat[t], lin, e=e) * w_flat[sel][:, None]
            out.index_add_(0, t, y)
    y = torch.empty_like(x)
    y[:, :prompt_len] = out[:sizes[0]].view(B, prompt_len, d)
    if T > prompt_len:
        y[:, prompt_len:] = out[sizes[0]:].view(T - prompt_len, B, d).transpose(0, 1)
    return y


def final_hidden(c: dict, w: Weights, tokens: torch.Tensor, prompt_len: int,
                 precision: str = "float32") -> torch.Tensor:
    """The final-normed hidden state (B, T - prompt_len + 1, d) at the
    positions whose logits pick a served token: the prompt's last and
    every later one. ``tokens`` (B, T) is the prompt followed by all served
    tokens but the last."""
    _tf32_off()
    return spec.refs(c).final_hidden(c, w, tokens, prompt_len, Linear(precision))


def logits(c: dict, w: Weights, h: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """Logits over the vocabulary (rows past ``vocab_size`` cut) for h
    (..., d)."""
    _tf32_off()
    return spec.refs(c).logits(c, w, h, Linear(precision))


def _tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def gaps(c: dict, w: Weights, h_ref: torch.Tensor, served: torch.Tensor,
         others: Optional[Dict[str, torch.Tensor]] = None,
         rows: int = 1024) -> Dict[str, torch.Tensor]:
    """For each position of h_ref (N, d): how far the reference's logit of
    the served token (N,) lies below its best logit (``"program"``); for
    each ``precision: h`` of ``others``, the same gap of the token that the
    reference computed in that precision puts first. Blocks of ``rows``
    positions keep the logits small."""
    others = others or {}
    out: Dict[str, list] = {"program": [], **{k: [] for k in others}}
    for a in range(0, h_ref.shape[0], rows):
        lr = logits(c, w, h_ref[a:a + rows])
        best = lr.max(-1).values
        out["program"].append(best - lr.gather(-1, served[a:a + rows, None])[:, 0])
        for prec, h in others.items():
            top = logits(c, w, h[a:a + rows], prec).argmax(-1)
            out[prec].append(best - lr.gather(-1, top[:, None])[:, 0])
    return {k: torch.cat(v) for k, v in out.items()}

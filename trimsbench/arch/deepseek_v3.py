"""A DeepSeek-V3 decoder (``model_type`` ``deepseek_v3``: Moonlight,
DeepSeek-V3, Kimi-K2): latent attention (MLA) in every layer, leading dense
layers (``first_k_dense_replace``) with a SwiGLU MLP, then MoE layers of
sigmoid-routed experts with a float32 routing bias (``noaux_tc``) and
shared experts, served by the port's MOE family with capacity dispatch.

Counts (``request_flops``), by the rule of ``flops.py``, as the port runs
the layers: every token multiplies ``wq``, ``w_kv_a``, ``wo``, its FFN (a
dense layer's MLP; an MoE layer's router, top-k experts and shared
experts) and the latent expansion ``w_kv_b`` (prefill: keys and values of
each head from the latent; a decode step: the same weights folded into the
query and the output, the same count). Prefill attention is the
non-absorbed form, causal: scores over nope + rope, sums over v. A decode
step's attention is the absorbed form over the latent cache: scores over
r + rope and sums over r for every head and valid row. The head at the
prompt's last position and each step.
"""
from __future__ import annotations

import torch

from trimsbench import faults, flops, weights

# the float32 routing bias (``e_score_correction_bias``), drawn apart
KINDS = {"route_bias": (torch.float32, lambda t, s: t.mul_(s))}


def _dims(c: dict):
    return (c["num_attention_heads"], c["kv_lora_rank"], c["qk_nope_head_dim"],
            c["qk_rope_head_dim"], c["v_head_dim"])


def port_config(c: dict):
    from repro_torch.configs.base import MOE
    from trimsbench.serve import decoder_config
    if not (c["norm_topk_prob"] and c["scoring_func"] == "sigmoid" and c["n_group"] == 1
            and c["topk_group"] == 1 and c["q_lora_rank"] is None):
        raise ValueError(f"{c['name']}: the port runs sigmoid routing in one group, "
                         "normalised, with queries projected without a rank")
    return decoder_config(
        c, family=MOE, d_ff=c["moe_intermediate_size"], n_experts=c["n_routed_experts"],
        top_k=c["num_experts_per_tok"], n_shared_experts=c["n_shared_experts"],
        kv_lora_rank=c["kv_lora_rank"], qk_nope_head_dim=c["qk_nope_head_dim"],
        qk_rope_head_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"],
        n_dense_layers=c["first_k_dense_replace"],
        dense_d_ff=c["intermediate_size"], router_scoring="sigmoid",
        routed_scaling_factor=float(c["routed_scaling_factor"]))


def _mla(c: dict, lead: tuple, prefix: str) -> list:
    d = c["hidden_size"]
    H, r, dn, dr, dv = _dims(c)
    return [(prefix + "wq", (*lead, d, H * (dn + dr)), "normal", (2.0 / d) ** 0.5),
            (prefix + "w_kv_a", (*lead, d, r + dr), "normal", (2.0 / d) ** 0.5),
            (prefix + "kv_norm", (*lead, r), "norm", weights.NORM_SPREAD),
            (prefix + "w_kv_b", (*lead, r, H * (dn + dv)), "normal", (2.0 / r) ** 0.5),
            (prefix + "wo", (*lead, H * dv, d), "normal", (H * dv) ** -0.5)]


def layout(c: dict) -> list:
    d, E = c["hidden_size"], c["n_routed_experts"]
    n_dense = c["first_k_dense_replace"]
    dense, moe = (n_dense,), (c["num_hidden_layers"] - n_dense,)
    f_shared = c["n_shared_experts"] * c["moe_intermediate_size"]
    return (weights.stem(c)
            + weights.norms(dense, d, "dense_layers/ln1", "dense_layers/ln2")
            + _mla(c, dense, "dense_layers/attn/")
            + weights.mlp(dense, d, c["intermediate_size"], prefix="dense_layers/ffn/")
            + weights.norms(moe, d, "layers/ln1", "layers/ln2")
            + _mla(c, moe, "layers/attn/")
            + [("layers/ffn/router", (*moe, d, E), "router", weights.EMBED_STD),
               ("layers/ffn/router_bias", (*moe, E), "route_bias",
                c["assumed"]["router_bias_std"])]
            + weights.mlp((*moe, E), d, c["moe_intermediate_size"])
            + [("layers/ffn/shared_gate", (*moe, d, f_shared), "normal", d ** -0.5),
               ("layers/ffn/shared_up", (*moe, d, f_shared), "normal", d ** -0.5),
               ("layers/ffn/shared_down", (*moe, f_shared, d), "normal", f_shared ** -0.5)])


def _attn_params(c: dict) -> int:
    """Weights every token multiplies in a layer's attention, ``w_kv_b``
    included (see the module's rule)."""
    d = c["hidden_size"]
    H, r, dn, dr, dv = _dims(c)
    return d * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv) + H * dv * d


def layer_params_per_token(c: dict) -> int:
    """Weights a token multiplies in one MoE layer (routed experts: top_k);
    ``request_flops`` adds the leading dense layers' own."""
    d = c["hidden_size"]
    f = c["moe_intermediate_size"]
    return (_attn_params(c) + d * c["n_routed_experts"]
            + (c["num_experts_per_tok"] + c["n_shared_experts"]) * 3 * d * f)


def request_flops(c: dict, B: int, S: int, new: int) -> float:
    d, V, L = c["hidden_size"], c["vocab_size"], c["num_hidden_layers"]
    n_dense = c["first_k_dense_replace"]
    H, r, dn, dr, dv = _dims(c)
    per_tok = 2.0 * ((L - n_dense) * layer_params_per_token(c)
                     + n_dense * (_attn_params(c) + 3 * d * c["intermediate_size"]))
    head = 2.0 * B * d * V
    prefill_attn = 2.0 * B * H * S * S * (dn + dr + dv) / 2          # causal
    total = per_tok * B * S + L * prefill_attn + head
    for i in range(new - 1):
        total += per_tok * B + L * 2.0 * B * H * (S + i + 1) * (2 * r + dr) + head
    return total


def mla_decode_call(c: dict, B: int, kv_len: int):
    """(operations, bytes) of one ``mla_decode_kernel`` call: q of every
    head read, the ``kv_len`` valid latent rows of each sequence read once,
    the output written, bf16."""
    H, r, _, dr, _ = _dims(c)
    nbytes = flops.BF16 * B * (H * (r + dr) + kv_len * (r + dr) + H * r)
    return 2.0 * B * H * kv_len * (2 * r + dr), float(nbytes)


def request_kernel_bounds(c: dict, B: int, S: int, new: int) -> dict:
    """One ``mla_decode_kernel`` call a layer in each decode step."""
    L = c["num_hidden_layers"]
    out = []
    for i in range(new - 1):
        out += [flops.bound_s(*mla_decode_call(c, B, S + i + 1))] * L
    return {"mla_decode_kernel": out}


def tiny(c: dict) -> dict:
    """The sizes of the CPU tests' copy."""
    return dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
                num_experts_per_tok=2, vocab_size=512)


def _no_route_bias(M) -> list:
    orig = M.MoE.router_topk

    def router_topk(cfg, p, x2d):
        if "router_bias" in p:
            p = dict(p, router_bias=torch.zeros_like(p["router_bias"]))
        return orig(cfg, p, x2d)
    return [(M.MoE, "router_topk", router_topk)]


def _latent_no_rope(M) -> list:
    orig = M.L.mla_project

    def mla_project(cfg, p, x, positions):
        q_nope, q_pe, c_kv, k_pe = orig(cfg, p, x, positions)
        # the rotation undone: k_pe as projected, in the layout RoPE leaves
        k_pe = M.L.apply_rope(k_pe, -positions, cfg.rope_theta)
        return q_nope, q_pe, c_kv, k_pe
    return [(M.L, "mla_project", mla_project)]


# ``no_route_bias``: routing chooses on the scores alone; ``latent_no_rope``:
# the shared key part goes to attention and into the latent cache unrotated
FAULTS = {"no_route_bias": faults.Fault(_no_route_bias),
          "latent_no_rope": faults.Fault(_latent_no_rope)}

"""A configuration's weights, drawn on the device from a seed.

The benchmark makes the weights and hands the same values to both sides:
the program gets them published into its store, the plain reference draws
them again after the window. Every leaf is named and shaped as the
``.trims`` files of the port store them (layers stacked on a leading axis,
products as ``x @ W``), and is drawn in the type it is served in: one
``randn`` for all leaves in the configuration's ``torch_dtype`` and one for
the float32 router, then each leaf is a scaled view. The same seed on the same device gives the same
bits.

Scales: the embedding as the published initializer (0.02); every other
product by its fan-in, so that attention, the MLP and the experts each move
the residual stream by about as much as the others and the logits are not
dominated by the tied embedding of the input token; the query and key
projections by sqrt(2) more, so that attention is not flat. Norm scales
spread around 1 (1 + 0.2 n), so that a skipped scale multiply shows.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

NORM_SPREAD = 0.2
EMBED_STD = 0.02


def padded_vocab(c: dict) -> int:
    """Rows of the embedding: the vocabulary rounded up to 256 (the rows
    past ``vocab_size`` are never looked up and their logits are masked)."""
    return (c["vocab_size"] + 255) // 256 * 256


def head_dim(c: dict) -> int:
    return c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"]


def is_moe(c: dict) -> bool:
    return bool(c.get("num_experts"))


def expert_width(c: dict) -> int:
    return c["moe_intermediate_size"] if is_moe(c) else c["intermediate_size"]


def layout(c: dict) -> List[Tuple[str, tuple, str, float]]:
    """``(name, shape, kind, scale)`` of every leaf: ``kind`` is ``normal``
    (std ``scale``) or ``norm`` (1 + scale * n), both in the configuration's
    ``torch_dtype``, or ``router`` (float32, std ``scale``)."""
    d, L = c["hidden_size"], c["num_hidden_layers"]
    hd = head_dim(c)
    qd, kvd = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd
    f = expert_width(c)
    out = [("embed", (padded_vocab(c), d), "normal", EMBED_STD),
           ("final_norm/scale", (d,), "norm", NORM_SPREAD),
           ("layers/ln1/scale", (L, d), "norm", NORM_SPREAD),
           ("layers/ln2/scale", (L, d), "norm", NORM_SPREAD),
           ("layers/attn/wq", (L, d, qd), "normal", math.sqrt(2.0 / d)),
           ("layers/attn/wk", (L, d, kvd), "normal", math.sqrt(2.0 / d)),
           ("layers/attn/wv", (L, d, kvd), "normal", 1 / math.sqrt(d)),
           ("layers/attn/wo", (L, qd, d), "normal", 1 / math.sqrt(qd))]
    if c.get("model_type") == "qwen3_moe":
        out += [("layers/attn/q_norm", (L, hd), "norm", NORM_SPREAD),
                ("layers/attn/k_norm", (L, hd), "norm", NORM_SPREAD)]
    if is_moe(c):
        E = c["num_experts"]
        out += [("layers/ffn/router", (L, d, E), "router", EMBED_STD),
                ("layers/ffn/w_gate", (L, E, d, f), "normal", 1 / math.sqrt(d)),
                ("layers/ffn/w_up", (L, E, d, f), "normal", 1 / math.sqrt(d)),
                ("layers/ffn/w_down", (L, E, f, d), "normal", 1 / math.sqrt(f))]
    else:
        out += [("layers/ffn/w_gate", (L, d, f), "normal", 1 / math.sqrt(d)),
                ("layers/ffn/w_up", (L, d, f), "normal", 1 / math.sqrt(d)),
                ("layers/ffn/w_down", (L, f, d), "normal", 1 / math.sqrt(f))]
    return out


def dtype(c: dict) -> torch.dtype:
    return getattr(torch, c["torch_dtype"])


def nbytes(c: dict) -> int:
    size = torch.empty((), dtype=dtype(c)).element_size()
    return sum(math.prod(s) * (4 if k == "router" else size) for _, s, k, _ in layout(c))


def n_params(c: dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in layout(c))


def tenant_seed(seed: int, tenant: int) -> int:
    """The generator seed of tenant ``tenant`` under the run's ``seed``:
    distinct tenants get distinct weights."""
    return (seed * 1_000_003 + 7919 * (tenant + 1)) % 2 ** 63


def draw(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``layout(c)`` from ``seed``, on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    leaves = layout(c)
    out: Dict[str, torch.Tensor] = {}
    for kinds, dt in ((("normal", "norm"), dtype(c)), (("router",), torch.float32)):
        mine = [leaf for leaf in leaves if leaf[2] in kinds]
        if not mine:
            continue
        flat = torch.randn(sum(math.prod(s) for _, s, _, _ in mine), generator=g,
                           dtype=dt, device=device)
        at = 0
        for name, shape, kind, scale in mine:
            n = math.prod(shape)
            t = flat[at:at + n].view(shape)
            t.mul_(scale)
            if kind == "norm":
                t.add_(1.0)
            out[name] = t
            at += n
    return out


def as_tree(flat: Dict[str, torch.Tensor]) -> dict:
    """``{"layers/attn/wq": t}`` as the nested dict the port publishes."""
    root: dict = {}
    for path, t in flat.items():
        node = root
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = t
    return root

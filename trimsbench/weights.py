"""A configuration's weights, drawn on the device from a seed.

The benchmark makes the weights and hands the same values to both sides:
the program gets them published into its store, the plain reference draws
them again after the window. Every leaf is named and shaped as the
``.trims`` files of the port store them (layers stacked on a leading axis,
products as ``x @ W``), and is drawn in the type it is served in: one
``randn`` for all leaves in the configuration's ``torch_dtype``, one for
the float32 router and one for each leaf kind of the architecture's own,
then each leaf is a scaled view. The same seed on the same device gives the
same bits. Which leaves a configuration has is its architecture's
(``arch/<model_type>.py`` ``layout``, built from the pieces below).

Scales: the embedding as the published initializer (0.02); every other
product by its fan-in, so that attention, the MLP and the experts each move
the residual stream by about as much as the others and the logits are not
dominated by the tied embedding of the input token; the query and key
projections by sqrt(2) more, so that attention is not flat. Norm scales
spread around 1 (1 + 0.2 n), so that a skipped scale multiply shows.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

from trimsbench import spec

Leaf = Tuple[str, tuple, str, float]
NORM_SPREAD = 0.2
EMBED_STD = 0.02


def padded_vocab(c: dict) -> int:
    """Rows of the embedding: the vocabulary rounded up to 256 (the rows
    past ``vocab_size`` are never looked up and their logits are masked)."""
    return (c["vocab_size"] + 255) // 256 * 256


def head_dim(c: dict) -> int:
    return c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"]


def stem(c: dict) -> List[Leaf]:
    """The embedding and the final norm."""
    d = c["hidden_size"]
    return [("embed", (padded_vocab(c), d), "normal", EMBED_STD),
            ("final_norm/scale", (d,), "norm", NORM_SPREAD)]


def norms(lead: tuple, d: int, *names: str) -> List[Leaf]:
    """A norm scale of width ``d`` under each of ``names``."""
    return [(f"{n}/scale", (*lead, d), "norm", NORM_SPREAD) for n in names]


def attention(c: dict, lead: tuple, prefix: str = "layers/attn/") -> List[Leaf]:
    """The query, key, value and output products of an attention layer."""
    d, hd = c["hidden_size"], head_dim(c)
    qd, kvd = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd
    return [(prefix + "wq", (*lead, d, qd), "normal", math.sqrt(2.0 / d)),
            (prefix + "wk", (*lead, d, kvd), "normal", math.sqrt(2.0 / d)),
            (prefix + "wv", (*lead, d, kvd), "normal", 1 / math.sqrt(d)),
            (prefix + "wo", (*lead, qd, d), "normal", 1 / math.sqrt(qd))]


def mlp(lead: tuple, d: int, f: int, prefix: str = "layers/ffn/") -> List[Leaf]:
    """A SwiGLU MLP of width ``f`` (``lead`` ends in the experts' axis where
    there are experts)."""
    return [(prefix + "w_gate", (*lead, d, f), "normal", 1 / math.sqrt(d)),
            (prefix + "w_up", (*lead, d, f), "normal", 1 / math.sqrt(d)),
            (prefix + "w_down", (*lead, f, d), "normal", 1 / math.sqrt(f))]


def layout(c: dict) -> List[Leaf]:
    """``(name, shape, kind, scale)`` of every leaf, from the architecture's
    file (``arch/<model_type>.py``), in the order they are drawn: ``kind``
    is ``normal`` (std ``scale``) or ``norm`` (1 + scale * n), both in the
    configuration's ``torch_dtype``, ``router`` (float32, std ``scale``), or
    one of the architecture's own ``KINDS``."""
    return spec.arch(c).layout(c)


def kinds(c: dict) -> Dict[str, Tuple[torch.dtype, Callable]]:
    """``kind: (dtype, fill)`` of every leaf kind of ``c``: ``fill(t, scale)``
    makes a leaf from a standard normal draw ``t`` of its shape. An
    architecture's own kinds (its ``KINDS``) come last; a dtype of ``None``
    is the configuration's."""
    dt = dtype(c)
    out = {"normal": (dt, lambda t, s: t.mul_(s)),
           "norm": (dt, lambda t, s: t.mul_(s).add_(1.0)),
           "router": (torch.float32, lambda t, s: t.mul_(s))}
    own = getattr(spec.arch(c), "KINDS", {})
    if set(own) & set(out):
        raise ValueError(f"{c['model_type']} redefines the leaf kinds {set(own) & set(out)}")
    return {**out, **{k: (kdt or dt, fill) for k, (kdt, fill) in own.items()}}


def dtype(c: dict) -> torch.dtype:
    return getattr(torch, c["torch_dtype"])


def nbytes(c: dict) -> int:
    size = {k: torch.empty((), dtype=dt).element_size() for k, (dt, _) in kinds(c).items()}
    return sum(math.prod(s) * size[k] for _, s, k, _ in layout(c))


def n_params(c: dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in layout(c))


def tenant_seed(seed: int, tenant: int) -> int:
    """The generator seed of tenant ``tenant`` under the run's ``seed``:
    distinct tenants get distinct weights."""
    return (seed * 1_000_003 + 7919 * (tenant + 1)) % 2 ** 63


def draw(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``layout(c)`` from ``seed``, on ``device``: one
    ``randn`` for the ``normal`` and ``norm`` leaves, one for the routers,
    then one for each of the architecture's own kinds, in the order of
    ``kinds(c)``; each leaf is its kind's fill of a view of its draw."""
    g = torch.Generator(device=device).manual_seed(seed)
    leaves, kind = layout(c), kinds(c)
    groups = [("normal", "norm"), ("router",)] + [(k,) for k in list(kind)[3:]]
    out: Dict[str, torch.Tensor] = {}
    for group in groups:
        mine = [leaf for leaf in leaves if leaf[2] in group]
        if not mine:
            continue
        flat = torch.randn(sum(math.prod(s) for _, s, _, _ in mine), generator=g,
                           dtype=kind[group[0]][0], device=device)
        at = 0
        for name, shape, k, scale in mine:
            n = math.prod(shape)
            out[name] = kind[k][1](flat[at:at + n].view(shape), scale)
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

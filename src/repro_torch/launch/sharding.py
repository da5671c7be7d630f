"""Logical-axis sharding rules: parameter, optimizer, batch and cache specs.

A copy of the JAX package's ``launch/sharding.py``. 2-D layout
(MaxText-style):

  * ``tensor``  -> mesh axis "model": heads / ffn-hidden / experts / vocab
  * ``fsdp``    -> mesh axes ("pod","data"): ZeRO-3 parameter+optimizer
                   sharding along the data-parallel axes
  * batch       -> ("pod","data")

Rules are keyed on the leaf's dict name; leading layer-stack dimensions are
padded with None. A dimension that does not divide by its axis size is
replicated (e.g. kv-head counts below the TP degree), never sharded
unevenly. A spec is a tuple per tensor dimension of ``None``, an axis name
or a tuple of names (the reference's ``PartitionSpec``, equal to it as a
tuple); a :class:`NamedSharding` is a spec on a mesh, with its DTensor
placements, and :func:`distribute` places a tree of tensors by them.

A mesh here is a ``DeviceMesh`` or, for the rules alone, a mapping
``{axis: size}`` in mesh order (no process group needed).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import batch_axes
from repro_torch.models.partitioning import mesh_sizes, placements

Spec = Tuple[Any, ...]

# leaf name -> (base_ndim, logical axes over trailing base dims)
# "F" = fsdp, "T" = tensor, None = replicate
_RULES: Dict[str, Tuple[int, Tuple[Optional[str], ...]]] = {
    "embed": (2, ("T", "F")),
    # attention
    "wq": (2, ("F", "T")),
    "wk": (2, ("F", "T")),
    "wv": (2, ("F", "T")),
    "wo": (2, ("T", "F")),
    "bq": (1, ("T",)),
    "bk": (1, ("T",)),
    "bv": (1, ("T",)),
    "q_norm": (1, (None,)),
    "k_norm": (1, (None,)),
    # dense mlp
    "w_gate": (2, ("F", "T")),
    "w_up": (2, ("F", "T")),
    "w_down": (2, ("T", "F")),
    # moe shared experts + router
    "router": (2, ("F", None)),
    "shared_gate": (2, ("F", "T")),
    "shared_up": (2, ("F", "T")),
    "shared_down": (2, ("T", "F")),
    # mamba
    "in_proj": (2, ("F", "T")),
    "out_proj": (2, ("T", "F")),
    "conv_w": (2, (None, "T")),
    "conv_b": (1, ("T",)),
    "A_log": (1, (None,)),
    "D": (1, (None,)),
    "dt_bias": (1, (None,)),
    "out_norm": (1, ("T",)),
    # norms / gates
    "scale": (1, (None,)),
    "bias": (1, (None,)),
    "gate_attn": (0, ()),
    "gate_mlp": (0, ()),
}

# routed expert tensors (E, D, F): expert-parallel over "model" + fsdp on the
# FFN dim (not D)
_MOE_RULES: Dict[str, Tuple[int, Tuple[Optional[str], ...]]] = {
    "w_gate": (3, ("T", None, "F")),
    "w_up": (3, ("T", None, "F")),
    "w_down": (3, ("T", "F", None)),
}


def _axis(logical: Optional[str], mesh):
    if logical is None:
        return None
    if logical == "T":
        return "model" if "model" in mesh_sizes(mesh) else None
    if logical == "F":
        ax = batch_axes(mesh)
        return ax if len(ax) > 1 else (ax[0] if ax else None)
    raise ValueError(logical)


def axis_size(mesh, ax) -> int:
    if ax is None:
        return 1
    sizes = mesh_sizes(mesh)
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= sizes[a]
        return n
    return sizes[ax]


def _spec_from_rule(rule, shape, mesh) -> Spec:
    base_ndim, logical = rule
    n_stack = len(shape) - base_ndim
    if n_stack < 0:
        return ()
    axes = [None] * n_stack + [_axis(l, mesh) for l in logical]
    # replicate dims that do not divide the axis size
    return tuple(ax if ax is not None and dim % axis_size(mesh, ax) == 0 else None
                 for dim, ax in zip(shape, axes))


def _map_with_path(fn, tree, path=()):
    return {k: _map_with_path(fn, v, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
            for k, v in tree.items()}


def _collect_moe_paths(tree) -> set:
    """Paths of routed-expert leaves: siblings of a 'router' key."""
    found = set()

    def walk(path, node):
        if isinstance(node, dict):
            has_router = "router" in node
            for k, v in node.items():
                p = path + (k,)
                if has_router and k in _MOE_RULES:
                    found.add(p)
                walk(p, v)

    walk((), tree)
    return found


def make_param_specs(cfg: ModelConfig, params_shape, mesh):
    """Spec of every leaf of ``params_shape`` (tensors, meta tensors or
    anything with ``.shape``)."""
    moe_paths = _collect_moe_paths(params_shape)

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        if path in moe_paths:
            return _spec_from_rule(_MOE_RULES[path[-1]], shape, mesh)
        rule = _RULES.get(path[-1])
        if rule is None:
            return ()  # replicate unknown leaves
        return _spec_from_rule(rule, shape, mesh)

    return _map_with_path(spec_for, params_shape)


def batch_spec(mesh) -> Spec:
    ax = batch_axes(mesh)
    return (ax if len(ax) > 1 else (ax[0] if ax else None),)


def batch_leaf_spec(leaf, mesh) -> Spec:
    """A batch leaf: dim 0 over the batch axes, the rest replicated."""
    return (batch_spec(mesh)[0],) + (None,) * (len(leaf.shape) - 1)


def cache_spec(path, leaf, mesh, batch_size: int) -> Spec:
    """Decode-cache sharding: 2-D shard the big KV/state tensors.

    Heuristics per leaf kind (names from ``models.model``):
      k/v/xk/xv (..., B, T, K, hd): B->fsdp if divisible, else T->fsdp
                                    (long-context batch=1); K->model if
                                    divisible, else hd->model
      ssm       (..., B, H, N, P):  B->fsdp; H->model
      conv      (..., B, dc-1, ci): B->fsdp; ci->model
    ``path`` is the leaf's key path (its last key names it)."""
    name = path[-1] if path else ""
    fsdp = _axis("F", mesh)
    tensor = _axis("T", mesh)
    fsdp_n = axis_size(mesh, fsdp)
    tensor_n = axis_size(mesh, tensor)
    shape = tuple(leaf.shape)
    ndim = len(shape)
    spec = [None] * ndim

    bdim = next((i for i, d in enumerate(shape) if d == batch_size), None)
    if name in ("k", "v", "xk", "xv"):
        tdim = (bdim + 1) if bdim is not None else None
        kdim, hdim = ndim - 2, ndim - 1
        if fsdp is not None and bdim is not None and shape[bdim] % fsdp_n == 0:
            spec[bdim] = fsdp
        elif fsdp is not None and tdim is not None and shape[tdim] % fsdp_n == 0:
            spec[tdim] = fsdp
        if tensor is not None:
            if shape[kdim] % tensor_n == 0:
                spec[kdim] = tensor
            elif shape[hdim] % tensor_n == 0:
                spec[hdim] = tensor
    elif name == "ssm":
        hdim = ndim - 3
        if fsdp is not None and bdim is not None and shape[bdim] % fsdp_n == 0:
            spec[bdim] = fsdp
        if tensor is not None and shape[hdim] % tensor_n == 0:
            spec[hdim] = tensor
    elif name == "conv":
        cdim = ndim - 1
        if fsdp is not None and bdim is not None and shape[bdim] % fsdp_n == 0:
            spec[bdim] = fsdp
        if tensor is not None and shape[cdim] % tensor_n == 0:
            spec[cdim] = tensor
    return tuple(spec)


def make_cache_specs(cache_shape, mesh, batch_size: int):
    return _map_with_path(lambda p, l: cache_spec(p, l, mesh, batch_size), cache_shape)


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """One rank's shard shape of a ``shape`` leaf placed by ``spec`` (the
    reference's ``NamedSharding.shard_shape``)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // axis_size(mesh, ax) for d, ax in zip(shape, spec))


class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh, spec: Spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        return local_shape(shape, self.spec, self.mesh)

    def __repr__(self):
        return f"NamedSharding({self.spec})"


def specs_to_shardings(specs, mesh):
    if isinstance(specs, dict):
        return {k: specs_to_shardings(v, mesh) for k, v in specs.items()}
    return NamedSharding(mesh, specs)


def make_param_shardings(cfg, params_shape, mesh):
    return specs_to_shardings(make_param_specs(cfg, params_shape, mesh), mesh)


def place(t: torch.Tensor, sh: "NamedSharding"):
    """The full tensor ``t`` (the same on every rank) as a DTensor placed by
    ``sh``: each rank keeps its shard, with no communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sh.mesh, sh.placements, src_data_rank=None)


def distribute(tree, shardings):
    """Each full tensor of ``tree`` placed by its sharding (:func:`place`)."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    return place(tree, shardings)

"""Activation sharding constraints, and the spec -> DTensor placement map.

A copy of the JAX package's ``models/partitioning.py``. The reference pins
activation layouts at block boundaries with ``with_sharding_constraint``
(the MaxText pattern), so that sharding propagation does not pick
pathological layouts. The port's activations under a mesh are ``DTensor``s,
and a constraint is ``DTensor.redistribute`` to the placements that the
reference's ``PartitionSpec`` names.

Model code stays mesh-agnostic: the launcher registers the physical axis
names here (:class:`activation_axes`) and makes a mesh ambient
(``launch.mesh.set_mesh``). The reference's constraint is a no-op exactly
when there is no mesh in context or an axis is missing; here those cases are
no mesh, no axes registered, or an input that is not a ``DTensor`` (the
local tensors inside a ``local_map`` body, the counterpart of a
``shard_map`` body's manual axes). Every other failure raises. With no axes
registered each call returns its input, the same object, after one
thread-local read: the serving path runs that way.

A spec is a tuple with one entry per tensor dimension: ``None``, a mesh-axis
name, or a tuple of names (one dimension over several mesh dimensions,
major first) -- the reference's ``PartitionSpec``. :func:`placements` turns
it into DTensor placements.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.device import is_distributed

_state = threading.local()

Axes = Union[None, str, Tuple[str, ...]]


def set_activation_axes(batch: Axes, model: Optional[str]) -> None:
    _state.batch = batch
    _state.model = model


def clear_activation_axes() -> None:
    _state.batch = None
    _state.model = None


def get_axes():
    return getattr(_state, "batch", None), getattr(_state, "model", None)


class activation_axes:
    """Context manager used by launchers around the steps they run."""

    def __init__(self, batch, model):
        self.axes = (batch, model)

    def __enter__(self):
        self.prev = get_axes()
        set_activation_axes(*self.axes)
        return self

    def __exit__(self, *exc):
        set_activation_axes(*self.prev)
        return False


# ---------------------------------------------------------------------------
# the ambient mesh (``launch.mesh.set_mesh``)
# ---------------------------------------------------------------------------

def _cur_mesh():
    """The mesh made ambient by ``launch.mesh.set_mesh``, or None."""
    return getattr(_state, "mesh", None)


def _swap_mesh(mesh):
    prev = _cur_mesh()
    _state.mesh = mesh
    return prev


# A mesh ("pod", "data", "model") computes on its 2-D view ("pod_data",
# "model") (``launch.mesh.compute_mesh``): DTensor's sharding propagation
# searches placements over every mesh dim, which takes minutes an op on
# three. The view keeps the axis sizes of the mesh it came from, and the
# spec entry ("pod", "data") names its first dim.
FLAT = "pod_data"
FLAT_AXES = ("pod", "data")


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order, for a ``DeviceMesh`` or a mapping
    (a 2-D view of a pod mesh answers with the pod mesh's axes)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    axes = getattr(mesh, "trims_axes", None)
    return dict(axes) if axes is not None else dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(spec: Sequence[Axes], mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: mesh dimension i is
    ``Shard(d)`` where spec entry d names it (alone or in a tuple), else
    ``Replicate()``. DTensor nests the shards of one tensor dimension in
    mesh order, which is the major-first order of a tuple entry, since the
    rules only ever write ``("pod", "data")`` for the mesh
    ``("pod", "data", "model")``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names) if hasattr(mesh, "mesh_dim_names") else list(mesh)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if FLAT in names and ax == FLAT_AXES:
            ax = FLAT
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {a!r} used twice in {spec}")
            out[i] = Shard(d)
    return tuple(out)


def _size(ax) -> int:
    mesh = _cur_mesh()
    if mesh is None or ax is None:
        return 1
    sizes = mesh_sizes(mesh)
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(ax, 1)


def _constraint(x, spec):
    mesh = _cur_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    sizes = mesh_sizes(mesh)
    if any(a not in sizes for ax in spec if ax is not None
           for a in ((ax,) if isinstance(ax, str) else ax)):
        return x
    # a dimension that does not divide stays replicated, never uneven
    spec = [ax if ax is None or x.shape[d] % _size(ax) == 0 else None
            for d, ax in enumerate(spec)]
    want = placements(tuple(spec) + (None,) * (x.ndim - len(spec)), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def shard_btd(x):
    """(batch, seq, d_model) -- replicated d, batch-sharded."""
    b, _ = get_axes()
    if b is None:
        return x
    return _constraint(x, (b, *([None] * (x.ndim - 1))))


def shard_residual(x, allow_seq: bool = True):
    """Residual stream (batch, seq, d): batch-sharded, the rest replicated.

    The reference makes it sequence-parallel over the tensor axis where the
    family allows it (Korthikanti-style SP; ``allow_seq``). The port does
    not: DTensor (torch 2.11, the card's) cannot flatten a sequence-sharded
    (B, S) into the rows of the products that follow, forward or backward,
    where GSPMD inserts the gathers itself. The values are the same; the
    saved residuals are TP times larger than the reference's (ROADMAP)."""
    b, m = get_axes()
    if b is None and m is None:
        return x
    return shard_btd(x)


def splittable(x, n: int):
    """x (..., n * hd) before its reshape into n heads: a mesh dim that
    shards the last dim but does not divide n is replicated first (DTensor
    cannot split such a shard; GSPMD reshards it itself). The identity for
    a plain tensor."""
    if not is_distributed(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim in (x.ndim - 1, -1)
          and n % mesh.size(i) else p for i, p in enumerate(x.placements)]
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


def shard_heads(x):
    """(batch, seq, heads, head_dim) -- heads on the tensor axis."""
    b, m = get_axes()
    if b is None and m is None:
        return x
    if x.ndim != 4:
        return x
    return _constraint(x, (b, None, m if m and x.shape[2] % _size(m) == 0 else None, None))


def shard_ffn(x):
    """(batch, seq, ffn_hidden) -- hidden on the tensor axis."""
    b, m = get_axes()
    if b is None and m is None:
        return x
    return _constraint(x, (b, None, m if m and x.shape[-1] % _size(m) == 0 else None))


def shard_logits(x):
    """(..., vocab) -- vocab on the tensor axis."""
    b, m = get_axes()
    if b is None and m is None:
        return x
    return _constraint(x, (b, *([None] * (x.ndim - 2)),
                           m if m and x.shape[-1] % _size(m) == 0 else None))


def shard_bhd(x, head_dim: int):
    """Batch on dim 0, tensor axis on ``head_dim``, rest replicated."""
    b, m = get_axes()
    if b is None and m is None:
        return x
    spec = [None] * x.ndim
    spec[0] = b
    if m and x.shape[head_dim] % _size(m) == 0:
        spec[head_dim] = m
    return _constraint(x, spec)


def shard_cache(x):
    """KV cache (B, T, K, hd): batch on fsdp (or T when batch=1), K on the
    tensor axis (hd as fallback) -- must match ``launch.sharding.cache_spec``."""
    b, m = get_axes()
    if b is None and m is None:
        return x
    if x.ndim != 4:
        return x
    B, T, K, hd = x.shape
    spec = [None, None, None, None]
    if b:
        if B % _size(b) == 0:
            spec[0] = b
        elif T % _size(b) == 0:
            spec[1] = b
    if m:
        if K % _size(m) == 0:
            spec[2] = m
        elif hd % _size(m) == 0:
            spec[3] = m
    return _constraint(x, spec)


def shard_tokens2d(x):
    """(tokens, d) flattened MoE token tables -- tokens batch-sharded."""
    b, _ = get_axes()
    if b is None:
        return x
    return _constraint(x, (b, *([None] * (x.ndim - 1))))


def shard_expert_tokens(x):
    """(experts, capacity, d) -- experts on the tensor axis."""
    b, m = get_axes()
    if m is None:
        return x
    spec = [None] * x.ndim
    if x.shape[0] % _size(m) == 0:
        spec[0] = m
    return _constraint(x, spec)


def shard_expert_hidden(x):
    """(experts, capacity, d_ff) -- experts on the tensor axis, ffn dim on
    the batch/fsdp axes (the (E, D, F->fsdp) expert weight layout)."""
    b, m = get_axes()
    if b is None and m is None:
        return x
    spec = [None] * x.ndim
    if m and x.shape[0] % _size(m) == 0:
        spec[0] = m
    if b and x.shape[-1] % _size(b) == 0:
        spec[-1] = b
    return _constraint(x, spec)


def gather_fsdp(tree):
    """Parameters (a tensor or a dict of them) whole over the batch axes
    (their ZeRO-3 shards all-gathered; shards over ``model`` kept), for the
    products of one layer: FSDP's gather before use, whose backward
    reduce-scatters the gradient. Without it DTensor may gather the
    activations instead (a global batch per chip). The identity for plain
    tensors."""
    if isinstance(tree, dict):
        return {k: gather_fsdp(v) for k, v in tree.items()}
    if not is_distributed(tree):
        return tree
    from torch.distributed.tensor import Replicate, Shard
    mesh = tree.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and name in (*FLAT_AXES, FLAT) else p
          for name, p in zip(mesh.mesh_dim_names, tree.placements)]
    return tree if pl == list(tree.placements) else tree.redistribute(mesh, pl)


def embed_lookup(table, tokens):
    """``table[tokens]``. Under a mesh (a DTensor table) on local shards
    (``local_map``): the table gathered whole, each rank's rows of the
    tokens looked up, the rows keeping the tokens' placements; the table's
    gradient is partial over the mesh dims that split the tokens. DTensor's
    own rule for the lookup's backward (``index_put``) fails on a sharded
    table in torch 2.11."""
    if not is_distributed(table):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    rep = (Replicate(),) * mesh.ndim
    if not is_distributed(tokens):
        tokens = DTensor.from_local(tokens, mesh, rep, run_check=False)
    t_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in tokens.placements)
    g_pl = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in t_pl)
    fn = local_map(lambda w, t: w[t], out_placements=(t_pl,), in_placements=(rep, t_pl),
                   in_grad_placements=(g_pl, t_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(table, tokens)


def vocab_parallel_nll(logits, labels):
    """``models.model.softmax_cross_entropy`` of DTensor logits, on local
    shards (``local_map``): each rank shifts its slice of the vocab by the
    max over the slices (an all-reduce of a constant), and the sums of exp
    and of the picked logit over the slices are partial. GSPMD partitions
    the reference's ops so; DTensor would gather the logits whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    last = logits.ndim - 1
    l_pl, lab_pl, out_pl, vdims = [], [], [], []
    v0, n_vocab = 0, 1
    for i, p in enumerate(logits.placements):
        if isinstance(p, Shard) and p.dim == 0:
            l_pl.append(p); lab_pl.append(p); out_pl.append(p)
        elif isinstance(p, Shard) and p.dim in (last, -1):
            l_pl.append(Shard(last)); lab_pl.append(Replicate()); out_pl.append(Partial())
            v0, n_vocab = v0 * mesh.size(i) + mesh.get_local_rank(i), n_vocab * mesh.size(i)
            vdims.append(i)
        else:
            l_pl.append(Replicate()); lab_pl.append(Replicate()); out_pl.append(Replicate())
    v_local = logits.shape[-1] // n_vocab

    def local(lg, lab):
        lg = lg.float()
        with torch.no_grad():
            m = lg.amax(-1, keepdim=True)
            for i in vdims:
                torch.distributed.all_reduce(m, op=torch.distributed.ReduceOp.MAX,
                                             group=mesh.get_group(i))
        shifted = lg - m
        vocab = torch.arange(v0 * v_local, (v0 + 1) * v_local, device=lg.device)
        return (torch.exp(shifted).sum(-1),
                torch.where(vocab == lab[..., None], shifted, 0.0).sum(-1))

    if not is_distributed(labels):
        labels = DTensor.from_local(labels, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    out_pl, l_pl, lab_pl = tuple(out_pl), tuple(l_pl), tuple(lab_pl)
    fn = local_map(local, out_placements=(out_pl, out_pl), in_placements=(l_pl, lab_pl),
                   in_grad_placements=(l_pl, lab_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    sum_exp, picked = fn(logits, labels)
    return torch.log(sum_exp) - picked


"""AdamW over the port's params trees (nested dicts of tensors), with
moments in ``moment_dtype``.

A functional copy of the JAX package's ``optim/adamw.py``: ``adamw(lr_fn,
...)`` returns ``(init, update)``, and ``update`` keeps the reference's
order: clip by the global norm, then the bias corrections, then ``delta =
mhat / (sqrt(vhat) + eps) + weight_decay * p``, then ``p - lr * delta``,
each leaf in float32 and cast back to its parameter's (and moment's) dtype.
``torch.optim.AdamW`` decays the parameter before the step and in the
parameter's dtype, which rounds otherwise in bf16.

``update`` writes the new parameters and moments into the tensors it was
given, as the reference's train step donates them, and returns those trees:
the state is never held twice.

Under a device mesh the parameters, gradients and moments are ``DTensor``s
with equal placements. The update is elementwise, so it runs on each
rank's local shards (``to_local()``) without DTensor dispatch and without a
collective, as ZeRO does; only the global gradient norm sums each rank's
partial sum of squares (a replicated shard counted once) over the mesh.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import is_distributed


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32, on the parameters' device
    mu: Any
    nu: Any


def _leaves(tree) -> Iterator[torch.Tensor]:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _sorted(tree):
    """``tree`` with its dict keys in sorted order (the order of ``_leaves``)."""
    return {k: _sorted(tree[k]) if isinstance(tree[k], dict) else tree[k] for k in sorted(tree)}


def _map(fn, tree, *rest):
    return {k: _map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself otherwise)."""
    return t.to_local() if is_distributed(t) else t


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, leaf by leaf in order. For
    DTensors each rank sums its shards' squares, a shard replicated over n
    ranks divided by n, and the mesh adds the partial sums."""
    leaves = list(_leaves(tree))
    if not leaves or not is_distributed(leaves[0]):
        return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves))
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = leaves[0].device_mesh

    def part_sum(l):
        s = torch.sum(torch.square(l.to_local().float()))
        n = 1
        for size, p in zip(mesh.shape, l.placements):
            n *= size if isinstance(p, Replicate) else 1
        return s / n if n > 1 else s

    total = sum(part_sum(l) for l in leaves)
    total = DTensor.from_local(total, mesh, (Partial(),) * mesh.ndim, run_check=False)
    return torch.sqrt(total.full_tensor())


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled so that its global norm is at most ``max_norm``, the
    norm). DTensor leaves come back as their local shards."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return _map(lambda g: (_local(g).float() * scale).to(g.dtype), tree), norm


def adamw(lr_fn: Callable[[torch.Tensor], torch.Tensor],
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, moment_dtype: str = "float32",
          max_grad_norm: Optional[float] = 1.0):
    mdt = getattr(torch, moment_dtype)

    def init(params) -> AdamWState:
        device = next(_leaves(params)).device
        zeros = lambda p: torch.zeros_like(p, dtype=mdt)  # noqa: E731 (a DTensor keeps its placements)
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                          mu=_map(zeros, params), nu=_map(zeros, params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        gnorm = torch.zeros((), dtype=torch.float32, device=state.step.device)
        if max_grad_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        lr = lr_fn(step)
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()

        def upd(g, m, v, p):
            gf = g.float()
            mf = b1 * m.float() + (1 - b1) * gf
            vf = b2 * v.float() + (1 - b2) * torch.square(gf)
            mhat = mf / bc1
            vhat = vf / bc2
            delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(mf)
            v.copy_(vf)

        _map(lambda g, m, v, p: upd(_local(g), _local(m), _local(v), _local(p)),
             grads, state.mu, state.nu, params)
        return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}

    return init, update

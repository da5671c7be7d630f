"""Train and serve step factories (plain functions; the loops live in
``launch/train.py`` and ``serving/engine.py``). A copy of the JAX package's
``launch/train_step.py``, without jit.

The steps take plain tensors on one device, or ``DTensor``s placed on a
device mesh by ``launch/sharding.py``; the caller runs them under
``partitioning.activation_axes`` and ``mesh.set_mesh``, as the reference
runs its jitted steps (``launch/train.py``, ``launch/dryrun.py``). Under a
mesh the plain tensors the model makes (positions, masks) stand for
replicated DTensors (``implicit_replication``), each gradient is reduced
onto its parameter's placements, and a microbatch is the reference's: rows
``i*B/accum .. (i+1)*B/accum`` of the global batch, re-sharded over the
batch axes.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models import partitioning as part
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.optim.adamw import _leaves, _map, _sorted


def make_optimizer(cfg: ModelConfig, peak_lr: float = 3e-4,
                   warmup: int = 100, total: int = 10_000):
    return adamw(warmup_cosine(peak_lr, warmup, total),
                 moment_dtype=cfg.opt_moment_dtype)


def value_and_grad(cfg: ModelConfig, params, batch,
                   mark: Callable[[str], None] = lambda label: None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: (total, metrics,
    grads), the grads in each parameter's dtype and zeros for a parameter
    the batch does not reach (an expert no token chose, on the ragged
    path). ``params`` are not modified; ``mark`` is called with
    ``"forward"`` and ``"backward"`` after each pass."""
    leaf = _map(lambda t: t.detach().requires_grad_(), params)
    with _replicate_plain(params):
        total, metrics = M.loss_fn(cfg, leaf, batch)
        mark("forward")
        grads = iter(torch.autograd.grad(total, list(_leaves(leaf)), allow_unused=True))
        grads = _map(lambda t: _on_placements(_zeros_if_none(next(grads), t), t), _sorted(leaf))
    mark("backward")
    return _host_scalar(total.detach()), {k: _host_scalar(v.detach()) for k, v in metrics.items()}, grads


def _replicate_plain(params):
    """``implicit_replication`` when the params are DTensors, else nothing."""
    import contextlib
    if not part.is_distributed(next(_leaves(params))):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _on_placements(g, p):
    """A DTensor gradient reduced onto its parameter's placements. Where
    the gradient comes out replicated over a mesh dim (each rank computed
    it whole) its copies agree only to rounding, which AdamW would turn
    into diverging replicas of the parameter: they are averaged over that
    dim, so every replica takes the same update."""
    if not part.is_distributed(g):
        return g
    from torch.distributed.tensor import Replicate
    mesh = g.device_mesh
    computed = [i for i, (a, b) in enumerate(zip(g.placements, p.placements))
                if isinstance(a, Replicate) and isinstance(b, Replicate) and mesh.size(i) > 1]
    if tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(mesh, p.placements)
    if computed:
        local = g.to_local()
        for i in computed:
            torch.distributed.all_reduce(local, group=mesh.get_group(i))
            local.div_(mesh.size(i))
    return g


def _host_scalar(v):
    """A replicated DTensor scalar as its (same) local value."""
    if part.is_distributed(v):
        return v.full_tensor()
    return v


def microbatch(v, accum: int, i: int):
    """Microbatch ``i`` of ``accum`` of the batch leaf ``v``: rows
    ``i*B/accum .. (i+1)*B/accum``. A DTensor batch is gathered (token ids:
    a small collective) and the microbatch re-sharded as ``v`` is, each
    rank keeping its rows without communication."""
    if not part.is_distributed(v):
        return v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
    from torch.distributed.tensor import distribute_tensor
    full = v.full_tensor()
    mb = full.reshape(accum, full.shape[0] // accum, *full.shape[1:])[i]
    return distribute_tensor(mb, v.device_mesh, v.placements, src_data_rank=None)


def _zeros_if_none(g: Optional[torch.Tensor], t: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(t) if g is None else g


def make_train_step(cfg: ModelConfig, opt_update,
                    mark: Optional[Callable[[str], None]] = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``cfg.grad_accum > 1`` splits the global batch into microbatches in
    order and sums their gradients in ``cfg.opt_moment_dtype``, then
    divides by the count, as the reference's ``lax.scan``: activation memory
    scales down by the accumulation factor while the optimizer sees the
    same effective batch. The metrics are ``loss``, ``aux_loss`` and
    ``perplexity`` (averaged over microbatches), ``grad_norm``, ``lr`` and
    ``total_loss``. ``mark``, when given, is called with ``"start"``, then
    ``"forward"`` and ``"backward"`` after each microbatch's passes and
    ``"optimizer"`` after the update (a timing hook)."""
    accum = max(1, cfg.grad_accum)
    mark = mark or (lambda label: None)

    def train_step(params, opt_state, batch):
        mark("start")
        if accum == 1:
            loss, metrics, grads = value_and_grad(cfg, params, batch, mark)
        else:
            adt = getattr(torch, cfg.opt_moment_dtype)
            dev = next(_leaves(params)).device
            gsum = _map(lambda p: torch.zeros_like(p, dtype=adt), params)
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            msum = {k: torch.zeros((), dtype=torch.float32, device=dev)
                    for k in ("loss", "aux_loss", "perplexity")}
            for i in range(accum):
                mb = {k: microbatch(v, accum, i) for k, v in batch.items()}
                loss, metrics, g = value_and_grad(cfg, params, mb, mark)
                _map(lambda a, b: a.add_(b.to(adt)), gsum, g)
                lsum = lsum + loss
                msum = {k: msum[k] + v for k, v in metrics.items()}
                del g
            # the averaged grads stay in the accumulator dtype; the
            # optimizer upcasts each leaf
            grads = _map(lambda a: a.div_(accum), gsum)
            loss = lsum / accum
            metrics = {k: v / accum for k, v in msum.items()}
        new_params, new_opt, opt_metrics = opt_update(grads, opt_state, params)
        mark("optimizer")
        return new_params, new_opt, {**metrics, **opt_metrics, "total_loss": loss}

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, batch):
        with _replicate_plain(params):
            return M.prefill(cfg, params, batch, max_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache, token, pos):
        with _replicate_plain(params):
            return M.decode_step(cfg, params, cache, token, pos)

    return serve_step

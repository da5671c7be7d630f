"""Stand-ins for every input of a cell's step (the dry run's arguments).

A copy of the JAX package's ``launch/specs.py``: where the reference makes
``jax.ShapeDtypeStruct``s through ``jax.eval_shape``, the port makes
tensors on the ``meta`` device (shapes and dtypes, no storage) through the
same init functions. ``input_specs`` covers the step's whole argument list
for each (architecture x shape-cell) kind, with the shardings of its
arguments and outputs.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ENCDEC, VLM, ModelConfig, ShapeCell
from repro_torch.launch import sharding as shd
from repro_torch.launch.train_step import make_optimizer
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWState

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in (``jax.ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device=META)


def batch_struct(cfg: ModelConfig, shape: ShapeCell, with_labels: bool = True
                 ) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {"tokens": sds((B, S), torch.int32)}
    if with_labels:
        out["labels"] = sds((B, S), torch.int32)
    if cfg.family == VLM:
        out["frontend"] = sds((B, cfg.n_frontend_tokens, cfg.d_model), torch.float32)
    elif cfg.family == ENCDEC:
        out["frontend"] = sds((B, S, cfg.d_model), torch.float32)
    return out


def params_struct(cfg: ModelConfig):
    return M.init_params(cfg, None, device=META)


def opt_struct(cfg: ModelConfig, params_shape) -> AdamWState:
    opt_init, _ = make_optimizer(cfg)
    return opt_init(params_shape)


def cache_struct(cfg: ModelConfig, shape: ShapeCell):
    B, T = shape.global_batch, shape.seq_len
    n_ctx = cfg.n_frontend_tokens if cfg.family == VLM else (
        T if cfg.family == ENCDEC else None)
    return M.init_cache(cfg, B, T, device=META, n_ctx=n_ctx)


def opt_shardings(opt_shape: AdamWState, param_shardings, mesh) -> AdamWState:
    """Optimizer moments mirror parameter sharding; step is replicated."""
    return AdamWState(step=shd.NamedSharding(mesh, ()), mu=param_shardings,
                      nu=param_shardings)


def _axes_size(mesh, axes) -> int:
    return shd.axis_size(mesh, axes)


def input_specs(cfg: ModelConfig, shape: ShapeCell, mesh
                ) -> Tuple[Tuple[Any, ...], Tuple[Any, ...], Any]:
    """Returns (args, in_shardings, out_shardings) for the cell's step:
    trees of meta tensors and of ``NamedSharding``s."""
    pshape = params_struct(cfg)
    psh = shd.make_param_shardings(cfg, pshape, mesh)
    repl = shd.NamedSharding(mesh, ())
    baxes = shd.batch_spec(mesh)[0]

    def batch_shardings(bshape):
        return {k: shd.NamedSharding(mesh, shd.batch_leaf_spec(v, mesh))
                for k, v in bshape.items()}

    if shape.kind == "train":
        bshape = batch_struct(cfg, shape)
        oshape = opt_struct(cfg, pshape)
        osh = opt_shardings(oshape, psh, mesh)
        metrics_sh = {k: repl for k in
                      ("loss", "aux_loss", "perplexity", "grad_norm", "lr", "total_loss")}
        return ((pshape, oshape, bshape), (psh, osh, batch_shardings(bshape)),
                (psh, osh, metrics_sh))

    model_ax = "model" if "model" in shd.mesh_sizes(mesh) else None
    vocab_ax = (model_ax if model_ax and
                cfg.vocab_size % _axes_size(mesh, model_ax) == 0 else None)
    batch_ax = (baxes if shape.global_batch % _axes_size(mesh, baxes) == 0 else None)
    cache_sh = lambda cshape: shd.specs_to_shardings(  # noqa: E731
        shd.make_cache_specs(cshape, mesh, shape.global_batch), mesh)

    if shape.kind == "prefill":
        bshape = batch_struct(cfg, shape, with_labels=False)
        cshape = cache_struct(cfg, shape)
        logits_sh = shd.NamedSharding(mesh, (batch_ax, vocab_ax))
        return ((pshape, bshape), (psh, batch_shardings(bshape)), (logits_sh, cache_sh(cshape)))

    if shape.kind == "decode":
        cshape = cache_struct(cfg, shape)
        csh = cache_sh(cshape)
        token = sds((shape.global_batch,), torch.int32)
        pos = sds((), torch.int32)
        token_sh = shd.NamedSharding(mesh, (batch_ax,))
        logits_sh = shd.NamedSharding(mesh, (batch_ax, vocab_ax))
        return ((pshape, cshape, token, pos), (psh, csh, token_sh, repl), (logits_sh, csh))

    raise ValueError(shape.kind)

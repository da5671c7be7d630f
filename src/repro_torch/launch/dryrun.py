"""Dry run: every (architecture x shape x mesh) cell's step at full width
and depth on stand-in tensors, with its per-chip memory and work.

The port's counterpart of the JAX package's ``launch/dryrun.py``. The
reference lowers and compiles each cell on 512 placeholder devices and
reads XLA's memory and cost analyses and the compiled HLO. The port has no
compiler to ask: each cell builds the production mesh over a fake process
group of 256 or 512 ranks (``torch.testing``'s ``FakeStore``, backend
``"fake"``, created inside :func:`run_cell`, never at import, and never
in a process that holds a real group), places the cell's arguments as
DTensors whose local shards are ``meta`` tensors (shapes only), and runs
the step once as rank 0 under ``op_analysis.OpAnalysis``. It records

  * ``per_device.argument_bytes`` / ``output_bytes`` / ``alias_bytes``:
    exact, from the rules' local shard shapes (donated arguments alias
    their outputs: params and moments in train, the cache in decode);
  * ``per_device.temp_bytes``: the high-water mark of the bytes of the
    tensors the step makes and still holds, and ``peak_hbm_bytes`` =
    arguments + that (method ``"live-tensor high-water mark"``): eager
    execution frees a tensor when its last reference goes, which is what
    the caching allocator sees on a card;
  * ``op_analysis``: per-chip dot FLOPs, traffic proxy and ring-model
    collective bytes;
  * ``param_count`` / ``active_param_count``.

The reference's ``cpu_bf16_staging_bytes`` / ``peak_hbm_bytes_tpu`` correct
an XLA:CPU artefact (fp32 staging twins of bf16 loop buffers that a TPU
does not make); no compiler stages anything here, so they have no
counterpart. A decode cell's position is the host int the port's
``decode_step`` takes (the cache length, ``seq_len - 1``).

Usage (CPU, no card)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

Records are written under ``build/dryrun`` by default.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional, Tuple

import torch

from repro_torch.configs import (SHAPES_BY_NAME, ShapeCell, cell_applicable, get_config,
                                 list_archs)
from repro_torch.launch.mesh import (act_axes, compute_mesh, make_mesh, make_production_mesh,
                                     n_chips, set_mesh)
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.launch.specs import input_specs
from repro_torch.launch.train_step import (make_decode_step, make_optimizer,
                                           make_prefill_step, make_train_step)
from repro_torch.models import partitioning as part
from repro_torch.optim.adamw import AdamWState

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")
PEAK_METHOD = "live-tensor high-water mark"


def init_fake_group(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks, this process rank 0
    (collectives are no-ops). Replaces an earlier fake group of another
    size; refuses to replace a real one."""
    dist = torch.distributed
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run's fake process group cannot share a process "
                               f"with a real {dist.get_backend()!r} group")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _stand_in(leaf: torch.Tensor, sh) -> torch.Tensor:
    """A DTensor over ``sh``'s mesh whose local shard is a meta tensor."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(sh.shard_shape(tuple(leaf.shape)), dtype=leaf.dtype, device="meta")
    return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                              shape=leaf.shape, stride=leaf.stride())


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, AdamWState):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _pairs(args, shardings):
    """(leaf, sharding) pairs of two trees of one structure."""
    return list(zip(_leaves(args), _leaves(shardings)))


def _place(tree, shardings):
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, AdamWState):
        return AdamWState(*(_place(v, s) for v, s in zip(tree, shardings)))
    return _stand_in(tree, shardings)


def _local_bytes(args, shardings) -> int:
    total = 0
    for leaf, sh in _pairs(args, shardings):
        n = 1
        for d in sh.shard_shape(tuple(leaf.shape)):
            n *= d
        total += n * leaf.element_size()
    return total


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             cfg_overrides: Optional[dict] = None, *, cell: Optional[ShapeCell] = None,
             mesh_shape: Optional[Tuple[int, int]] = None) -> dict:
    """One cell's record. ``cell`` replaces the named shape cell, and
    ``mesh_shape`` = (data, model) a mesh over a fake group of that many
    ranks replaces the production mesh (a smaller mesh, e.g. one chip's,
    to hold the prediction against a card)."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = cell or SHAPES_BY_NAME[shape_name]
    rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
           "kind": shape.kind, "ok": False}
    if not cell_applicable(cfg, shape):
        rec.update(ok=True, skipped=True,
                   reason="long_500k needs sub-quadratic attention "
                          "(see DESIGN.md §4)")
        return rec
    if mesh_shape is not None:
        init_fake_group(mesh_shape[0] * mesh_shape[1])
        mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
    else:
        init_fake_group(512 if multi_pod else 256)
        mesh = compute_mesh(make_production_mesh(multi_pod=multi_pod, device_type="cpu"))
    args, in_sh, out_sh = input_specs(cfg, shape, mesh)

    if shape.kind == "train":
        _, opt_update = make_optimizer(cfg)
        params, opt, batch = args
        placed = (_place(params, in_sh[0]),
                  AdamWState(args[1].step, _place(opt.mu, in_sh[1].mu),
                             _place(opt.nu, in_sh[1].nu)),
                  _place(batch, in_sh[2]))
        step_fn = make_train_step(cfg, opt_update)
        state = _local_bytes(params, in_sh[0]) + _local_bytes((opt.mu, opt.nu),
                                                              (in_sh[1].mu, in_sh[1].nu))
        arg_bytes = state + opt.step.element_size() + _local_bytes(batch, in_sh[2])
        alias = arg_bytes - _local_bytes(batch, in_sh[2])          # params, opt donated
        out_bytes = alias + 4 * len(out_sh[2])                      # + f32 metrics
        extra = {"state_bytes": state}                              # params and moments
    elif shape.kind == "prefill":
        params, batch = args
        placed = (_place(params, in_sh[0]), _place(batch, in_sh[1]))
        step_fn = make_prefill_step(cfg, max_len=shape.seq_len)
        arg_bytes = _local_bytes(params, in_sh[0]) + _local_bytes(batch, in_sh[1])
        logits = torch.empty((shape.global_batch, cfg.padded_vocab), dtype=cfg.cdtype,
                             device="meta")
        from repro_torch.launch.specs import cache_struct
        out_bytes = (_local_bytes(logits, out_sh[0])
                     + _local_bytes(cache_struct(cfg, shape), out_sh[1]))
        alias, extra = 0, {}
    else:
        params, cache, token, _ = args
        placed = (_place(params, in_sh[0]), _place(cache, in_sh[1]),
                  _stand_in(token, in_sh[2]), shape.seq_len - 1)
        step_fn = make_decode_step(cfg)
        cache_bytes = _local_bytes(cache, in_sh[1])
        arg_bytes = (_local_bytes(params, in_sh[0]) + cache_bytes
                     + _local_bytes(token, in_sh[2]) + 4)
        logits = torch.empty((shape.global_batch, cfg.padded_vocab), dtype=cfg.cdtype,
                             device="meta")
        out_bytes = _local_bytes(logits, out_sh[0]) + cache_bytes
        alias, extra = cache_bytes, {}                              # cache donated

    t0 = time.time()
    with part.activation_axes(*act_axes(mesh)), set_mesh(mesh), OpAnalysis() as oa:
        step_fn(*placed)
    run_s = time.time() - t0
    summary = oa.summary()
    temp = oa.peak_live_bytes
    rec.update(
        ok=True,
        chips=n_chips(mesh),
        run_s=round(run_s, 2),
        per_device={
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "alias_bytes": alias,
            "temp_bytes": temp,
            "peak_hbm_bytes": arg_bytes + temp,
            "peak_method": PEAK_METHOD,
            **extra,
        },
        op_analysis=summary.to_dict(),
        param_count=cfg.param_count(),
        active_param_count=cfg.active_param_count(),
    )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=sorted(SHAPES_BY_NAME))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--override", default=None,
                    help="json dict of ModelConfig overrides")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    overrides = json.loads(args.override) if args.override else None

    if args.all:
        cells = [(a, s) for a in list_archs() for s in sorted(SHAPES_BY_NAME)]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_fail = 0
    for arch, shape_name in cells:
        for mp in meshes:
            tag = f"{arch}.{shape_name}.{'mp' if mp else 'sp'}"
            try:
                rec = run_cell(arch, shape_name, mp, overrides)
            except Exception as e:  # noqa: BLE001 - recorded per cell
                rec = {"arch": arch, "shape": shape_name, "multi_pod": mp,
                       "ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                n_fail += 1
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            status = "SKIP" if rec.get("skipped") else "OK" if rec.get("ok") else "FAIL"
            extra = ""
            if rec.get("ok") and not rec.get("skipped"):
                pk = rec["per_device"]["peak_hbm_bytes"] / 2 ** 30
                extra = (f" run={rec['run_s']}s peak_hbm={pk:.2f}GiB"
                         f" coll={rec['op_analysis']['total_coll_bytes']/2**30:.2f}GiB")
            print(f"[{status}] {tag}{extra}", flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()

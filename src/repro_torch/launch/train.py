"""Training loop of the PyTorch port: data prefetch, async checkpointing,
a failure-injection-aware restart loop, a straggler watchdog.

A copy of the JAX package's ``launch/train.py``. With a device mesh the
parameters and moments are ``DTensor``s placed by the rules of
``launch/sharding.py``, each rank builds its rows of the batch, and the
step runs under ``activation_axes`` and ``set_mesh``, as the reference's.
The step updates the parameters and moments in place, as the reference's
jitted step donates them.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch olmo-1b --reduced --steps 20 [--ckpt-dir DIR]

trains a reduced model on the CPU; without ``--device`` it needs a card.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, restore_into
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import Prefetcher
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import act_axes, compute_mesh, make_local_mesh, set_mesh
from repro_torch.launch.train_step import make_optimizer, make_train_step
from repro_torch.models import model as M
from repro_torch.models import partitioning as part
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime.fault import FailureInjector, SimulatedFailure, Watchdog


@dataclass
class TrainerConfig:
    batch_size: int = 8
    seq_len: int = 128
    steps: int = 50
    peak_lr: float = 3e-4
    warmup: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 20
    log_every: int = 10
    watchdog_timeout: float = 120.0


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainerConfig,
                 injector: Optional[FailureInjector] = None, device="cuda",
                 mark=None, mesh=None):
        """``mark``: the train step's timing hook (``make_train_step``).
        ``mesh``: the device mesh; by default ``make_local_mesh()`` over the
        ranks of the process group when one is up, else none (plain tensors
        on ``device``: what a one-device mesh computes, without DTensors)."""
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        if mesh is None and torch.distributed.is_available() and torch.distributed.is_initialized():
            mesh = make_local_mesh(torch.distributed.get_world_size(), 1)
        self.mesh = None if mesh is None else compute_mesh(mesh)
        self.injector = injector
        self.history: List[Dict[str, float]] = []
        self.restarts = 0

        opt_init, opt_update = make_optimizer(
            cfg, tc.peak_lr, tc.warmup, max(tc.steps, 1))
        self._opt_init = opt_init
        self.step_fn = make_train_step(cfg, opt_update, mark)
        self.ckpt = (CheckpointManager(tc.ckpt_dir, every=tc.ckpt_every)
                     if tc.ckpt_dir else None)

    # ------------------------------------------------------------ lifecycle
    def init_state(self, device=None):
        """Fresh state from seed 0 (``device="meta"``: its shape template,
        never sharded). Under a mesh every rank draws the same full
        parameters and keeps its shards."""
        device = device or self.device
        meta = torch.device(device).type == "meta"
        gen = None if meta else torch.Generator(device=device).manual_seed(0)
        params = M.init_params(self.cfg, gen, device=device)
        if self.mesh is not None and not meta:
            params = shd.distribute(params, self.param_shardings(params))
        opt = self._opt_init(params)
        return {"params": params, "opt_mu": opt.mu, "opt_nu": opt.nu,
                "opt_step": opt.step}, 0

    def param_shardings(self, params):
        return shd.make_param_shardings(self.cfg, params, self.mesh)

    def state_shardings(self, template):
        """The shardings of a state tree: moments as their parameters,
        the step whole."""
        psh = self.param_shardings(template["params"])
        return {"params": psh, "opt_mu": psh, "opt_nu": psh, "opt_step": None}

    def restore_or_init(self):
        """(state, start step): the newest checkpoint restored onto the
        device through a shape template (no second copy of the state is
        made), or a fresh state at step 0."""
        if self.tc.ckpt_dir and latest_step(self.tc.ckpt_dir) is not None:
            template, _ = self.init_state(device="meta")
            shardings = None if self.mesh is None else self.state_shardings(template)
            step, state = restore_into(template, self.tc.ckpt_dir, device=self.device,
                                       shardings=shardings)
            return state, step
        return self.init_state()

    # ------------------------------------------------------------ run loops
    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        steps = steps or self.tc.steps
        state, start = self.restore_or_init()
        params = state["params"]
        opt = AdamWState(state["opt_step"], state["opt_mu"], state["opt_nu"])
        del state
        wd = Watchdog(timeout=self.tc.watchdog_timeout)
        pf = Prefetcher(self.cfg, self.tc.batch_size, self.tc.seq_len,
                        start_step=start, device=self.device,
                        sharding=None if self.mesh is None else shd.NamedSharding(
                            self.mesh, shd.batch_spec(self.mesh)))
        next_step = start
        try:
            with self._on_mesh():
                for _ in range(start, steps):
                    step_idx, batch = next(pf)
                    t0 = time.perf_counter()
                    if self.injector is not None:
                        self.injector.maybe_fail(step_idx)
                    params, opt, metrics = self.step_fn(params, opt, batch)
                    metrics = {k: float(v) for k, v in metrics.items()}
                    metrics["step"] = step_idx
                    metrics["step_s"] = time.perf_counter() - t0
                    self.history.append(metrics)
                    next_step = step_idx + 1
                    wd.beat(step_idx)
                    if self.ckpt:
                        self.ckpt.save(step_idx + 1, {
                            "params": params, "opt_mu": opt.mu,
                            "opt_nu": opt.nu, "opt_step": opt.step})
                    if step_idx % self.tc.log_every == 0:
                        print(f"step {step_idx}: loss={metrics['loss']:.4f} "
                              f"({metrics['step_s']*1e3:.0f}ms)", flush=True)
        finally:
            pf.stop()
            wd.stop()
            if self.ckpt:
                self.ckpt.save(next_step,
                               {"params": params, "opt_mu": opt.mu,
                                "opt_nu": opt.nu, "opt_step": opt.step},
                               force=True)
                self.ckpt.wait()
        return {"params": params, "opt": opt, "history": self.history}

    def _on_mesh(self):
        """``activation_axes`` and ``set_mesh`` of the mesh (nothing without one)."""
        stack = contextlib.ExitStack()
        if self.mesh is not None:
            stack.enter_context(part.activation_axes(*act_axes(self.mesh)))
            stack.enter_context(set_mesh(self.mesh))
        return stack

    def run_with_restarts(self, max_restarts: int = 3) -> Dict[str, Any]:
        """Supervisor loop: every SimulatedFailure triggers restore+resume."""
        while True:
            try:
                return self.run()
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > max_restarts:
                    raise


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (CPU-sized) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--moe-impl", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.moe_impl:
        cfg = cfg.replace(moe_impl=args.moe_impl)
    tc = TrainerConfig(batch_size=args.batch_size, seq_len=args.seq_len,
                       steps=args.steps, ckpt_dir=args.ckpt_dir)
    tr = Trainer(cfg, tc, device=args.device)
    out = tr.run_with_restarts()
    losses = [h["loss"] for h in out["history"]]
    print(f"done: first loss={losses[0]:.4f} last loss={losses[-1]:.4f}")


if __name__ == "__main__":
    main()

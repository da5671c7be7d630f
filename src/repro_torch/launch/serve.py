"""Serving launcher of the PyTorch port: stand up the TrIMS MRM (+ optional
cross-process shm server) and drive an inference engine over the published
model store.

  PYTHONPATH=src python -m repro_torch.launch.serve [--store /path/to/models] \\
      --arch deepseek-7b --requests 8 [--no-trims] [--device cuda] \\
      [--shm-socket /tmp/mrm.sock]

The store defaults to ``build/serve_store`` in the checkout, so two
checkouts never share one.

If the store does not hold the model, a reduced-config model for --arch is
published first (so the command is self-contained for demos/smoke); a MoE
arch is published with ``moe_impl="ragged"``, as the JAX launcher does
(the DENSE and MoE families). With ``--shm-socket`` the MRM's host tier
lives in shared memory and other processes open models through
``core.shm_ipc.RemoteTrimsClient`` on that unix socket while the requests
run; the server stops when they are done.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import DENSE, MOE, ARCHS, get_config
from repro_torch.core.costmodel import get_hardware
from repro_torch.core.mrm import MRM, ModelKey
from repro_torch.core.store import DiskStore

ROOT = Path(__file__).resolve().parents[3]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", default=str(ROOT / "build" / "serve_store"))
    ap.add_argument("--arch", default="olmo-1b",
                    choices=sorted(n for n, c in ARCHS.items() if c.family in (DENSE, MOE)))
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--no-trims", action="store_true")
    ap.add_argument("--device-capacity-gb", type=float, default=8.0)
    ap.add_argument("--policy", default="lru",
                    choices=["lru", "lcu", "fifo", "largest"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shm-socket", default=None,
                    help="also expose the MRM to other processes here")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    from repro_torch.serving import FRAMEWORK, InferenceEngine, publish_model

    device = resolve_device(args.device)
    disk = DiskStore(args.store)
    if not disk.contains(ModelKey(FRAMEWORK, args.arch, "1")):
        cfg = get_config(args.arch).reduced()
        if cfg.n_experts:
            cfg = cfg.replace(moe_impl="ragged")
        print(f"store empty: publishing reduced {args.arch} "
              f"({cfg.param_count()/1e6:.1f}M params)")
        gen = torch.Generator(device=device).manual_seed(args.seed)
        publish_model(disk, cfg, init_params(cfg, gen, device=device), name=args.arch)

    mrm = None
    server = None
    if not args.no_trims:
        mrm = MRM(disk, device_capacity=int(args.device_capacity_gb * 2 ** 30),
                  policy=args.policy, hw=get_hardware(), device=device,
                  use_shm=args.shm_socket is not None)
        if args.shm_socket:
            from repro_torch.core.shm_ipc import MRMServer
            server = MRMServer(mrm, args.shm_socket)
            print(f"MRM shm server listening on {args.shm_socket}")
    try:
        return _drive(args, disk, mrm, device)
    finally:
        if server is not None:
            server.stop()
            for e in list(mrm.host.entries.values()):
                if e.payload is not None:
                    e.payload.release()  # the daemon owns its segments


def _drive(args, disk, mrm, device):
    from repro_torch.serving import InferenceEngine

    engine = InferenceEngine(disk, mrm, use_trims=mrm is not None, device=device)
    cfgv = get_config(args.arch).reduced()
    toks = np.random.default_rng(args.seed).integers(
        0, cfgv.vocab_size - 1,
        size=(args.batch, args.prompt_len)).astype(np.int32)

    for i in range(args.requests):
        out, st = engine.generate(args.arch, toks, args.max_new)
        print(f"req{i}: tier={st.tier_hit:<12} load={st.model_load_s*1e3:8.2f}ms "
              f"compute={st.compute_s*1e3:8.1f}ms total={st.total_s*1e3:8.1f}ms")
    if mrm is not None:
        s = mrm.stats()
        print(f"MRM: {s['opens']} opens, {s['disk_loads']} disk loads, "
              f"device hits {s['device']['hits']}")
    return engine


if __name__ == "__main__":
    main()

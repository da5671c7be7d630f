"""Where the time of one warm serving request goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--model A|Q|M] [--trace out.json]

Publishes a full-width model (random weights from a fixed seed) into a store
under ``build/``: ``A``, deepseek-7b cut to 4 layers (the default), ``Q``,
qwen3-moe-30b-a3b cut to 2 layers (``chip_smoke.py``'s phase 6), or ``M``,
mamba2-370m at its full 48 layers (phase 9). Serves one cold request
through the MRM and the engine, then one warm (device-hit) request under
``torch.profiler``. Prints one JSON object: the request's host-clock split,
the device's busy and idle share over the request (union of kernel and copy
intervals), device time by kernel name and summed for each of the port's
kernels over its template instances. The request has the shape of
``chip_smoke.py``'s: batch 2, a 512-token prompt, 16 new tokens. CUDA only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[3]
MODELS = {"A": ("deepseek-7b", 4), "Q": ("qwen3-moe-30b-a3b", 2),   # arch, layers
          "M": ("mamba2-370m", 48)}
B, PROMPT, NEW, SEED = 2, 512, 16, 0
PORT_KERNELS = ("flash_fwd", "decode_split_kernel", "rmsnorm_kernel")


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="A", choices=sorted(MODELS))
    ap.add_argument("--trace", default=None, help="also export a chrome trace here")
    args = ap.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import get_hardware
    from repro_torch.core.mrm import MRM
    from repro_torch.core.store import DiskStore
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine, publish_model

    device = resolve_device("cuda")
    arch, layers = MODELS[args.model]
    cfg = get_config(arch).replace(n_layers=layers)
    store = ROOT / "build" / "profile_store"
    shutil.rmtree(store, ignore_errors=True)
    try:
        disk = DiskStore(str(store))
        gen = torch.Generator(device=device).manual_seed(SEED)
        publish_model(disk, cfg, init_params(cfg, gen, device=device), name="A")
        torch.cuda.empty_cache()
        mrm = MRM(disk, hw=get_hardware(), device=device)
        engine = InferenceEngine(disk, mrm, device=device)
        toks = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
        _, cold = engine.generate("A", toks, NEW)

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, warm = engine.generate("A", toks, NEW)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(store, ignore_errors=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)

    cuda = torch.autograd.DeviceType.CUDA
    dev_events = [e for e in prof.events() if getattr(e, "device_type", None) == cuda]
    by_name = {}
    for e in dev_events:
        d = by_name.setdefault(e.name, {"count": 0, "ms": 0.0})
        d["count"] += 1
        d["ms"] += (e.time_range.end - e.time_range.start) / 1e3
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in dev_events]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])
    # the 25 largest, and every kernel of the port wherever it ranks
    top = [kv for i, kv in enumerate(top) if i < 25 or any(n in kv[0] for n in PORT_KERNELS)]
    out = {
        "device": torch.cuda.get_device_name(0),
        "config": {"arch": cfg.name, "layers": layers, "batch": B,
                   "prompt": PROMPT, "new": NEW},
        "cold": dataclasses.asdict(cold), "warm": dataclasses.asdict(warm),
        "profiled_wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / (wall_s * 1e3)) if dev_events else None,
        "device_events": len(dev_events),
        # each port kernel summed over its template instances (one name each)
        "port_kernels": {k: {"count": sum(v["count"] for n, v in by_name.items() if k in n),
                             "ms": sum(v["ms"] for n, v in by_name.items() if k in n)}
                         for k in PORT_KERNELS},
        "kernels": [{"name": n[:120], **v} for n, v in top],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

"""End-to-end LLM serving driver on the PyTorch port: publish real models from
the zoo, serve batched generate() requests through the TrIMS-backed engine,
and compare the FaaS cold-start baseline against warm shared serving.

    PYTHONPATH=src python examples_torch/serve_llm.py [--arch olmo-1b] \\
        [--requests 4] [--device cpu]

The model runs on the card (through the port's kernels) unless ``--device
cpu`` is given; without a card the default raises.
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core import DiskStore, MRM, ModelKey
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import (FRAMEWORK, InferenceEngine, Request, ServingWorkers,
                                 publish_model)


def run(arch="olmo-1b", requests=4, batch=2, prompt_len=32, max_new=8, device="cuda",
        disk=None):
    """Serve ``arch`` (reduced) cold, through TrIMS, then through the worker
    pool; returns what it measured. ``disk``: a store that may already hold
    the published model (else it is published from seed 0 into a fresh
    store under a temporary directory)."""
    dev = resolve_device(device)
    if disk is None:
        root = tempfile.mkdtemp(prefix="trims_serve_")
        disk = DiskStore(f"{root}/models")
    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        cfg = cfg.replace(moe_impl="ragged")
    if not disk.contains(ModelKey(FRAMEWORK, arch, "1")):
        print(f"publishing {arch} (reduced: {cfg.param_count()/1e6:.1f}M params)")
        gen = torch.Generator(device=dev).manual_seed(0)
        publish_model(disk, cfg, init_params(cfg, gen, device=dev), name=arch)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size - 1, size=(batch, prompt_len)).astype(np.int32)

    served = {}
    for use_trims in (False, True):
        mrm = MRM(disk, device_capacity=8 << 30, device=dev) if use_trims else None
        engine = InferenceEngine(disk, mrm, use_trims=use_trims, device=dev)
        label = "TrIMS" if use_trims else "baseline(cold)"
        t0 = time.perf_counter()
        for i in range(requests):
            out, st = engine.generate(arch, toks, max_new)
            served.setdefault(label, []).append((out, st))
            print(f"  [{label}] req{i}: load={st.model_load_s*1e3:7.1f}ms "
                  f"compute={st.compute_s*1e3:7.1f}ms tier={st.tier_hit} "
                  f"tokens={out[0][:4].tolist()}...")
        wall = time.perf_counter() - t0
        print(f"  [{label}] {requests} requests in {wall:.2f}s\n")

    # concurrent serving through the worker pool
    mrm = MRM(disk, device_capacity=8 << 30, device=dev)
    engine = InferenceEngine(disk, mrm, device=dev)
    workers = ServingWorkers(engine, n_workers=4)
    reqs = [workers.submit(Request(model=arch, tokens=toks, max_new=max_new))
            for _ in range(requests * 2)]
    t0 = time.perf_counter()
    workers.drain(reqs)
    wall = time.perf_counter() - t0
    workers.stop()
    ok = sum(1 for r in reqs if not isinstance(r.result, Exception))
    print(f"concurrent: {ok}/{len(reqs)} requests ok in {wall:.2f}s, "
          f"disk loads={mrm.stats()['disk_loads']}, "
          f"exe cache hits={engine.exe_cache_hits}")
    return {"served": served, "concurrent": reqs, "concurrent_ok": ok,
            "disk_loads": mrm.stats()["disk_loads"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    run(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    main()

"""TrIMS quickstart on the PyTorch port: share one model across isolated loads.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The weights land on the card unless ``--device cpu`` is given; without a
card the default raises.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.core import DiskStore, MRM, ModelKey, TrimsClient, cold_load, load_model
from repro_torch.device import resolve_device


def run(device="cuda", disk=None):
    """Cold load, then two TrIMS opens of one model; returns what it measured.
    ``disk``: a store to deploy into (a fresh one under a temporary
    directory by default)."""
    dev = resolve_device(device)
    if disk is None:
        root = tempfile.mkdtemp(prefix="trims_quickstart_")
        disk = DiskStore(f"{root}/models")

    # 1. deploy a model (100MB of weights) to the local store
    rng = np.random.default_rng(0)
    weights = {f"layer{i}_w": rng.standard_normal((512, 512)).astype(np.float32)
               for i in range(100)}
    key = ModelKey("repro-torch", "demo-model", "1")
    disk.put(key, weights)
    print(f"deployed {sum(w.nbytes for w in weights.values())/2**20:.0f}MB model")

    # 2. the FaaS baseline: every invocation cold-loads a private copy
    m = cold_load(disk, key, device=dev)
    print(f"cold load : {m.timings.total_s*1e3:8.2f} ms "
          f"(disk {m.timings.disk_read_s*1e3:.2f} + "
          f"deserialize {m.timings.deserialize_s*1e3:.2f} + "
          f"stage {m.timings.h2d_measured_s*1e3:.2f})")

    # 3. TrIMS: the MRM owns one copy; opens are refcounted handles
    mrm = MRM(disk, device_capacity=1 << 30, host_capacity=4 << 30, device=dev)
    client = TrimsClient(mrm)
    m1 = load_model("repro-torch", "demo-model", trims=client)   # first: loads
    m2 = load_model("repro-torch", "demo-model", trims=client)   # second: shares
    print(f"trims #1  : {m1.timings.total_s*1e3:8.2f} ms (tier={m1.timings.tier_hit})")
    print(f"trims #2  : {m2.timings.total_s*1e3:8.2f} ms (tier={m2.timings.tier_hit})  "
          f"<- {m1.timings.total_s/max(m2.timings.total_s,1e-9):.0f}x faster")
    assert m1.weights["layer0_w"] is m2.weights["layer0_w"]  # same buffer
    if dev.type == "cuda":  # one allocation on the card
        assert m1.weights["layer0_w"].data_ptr() == m2.weights["layer0_w"].data_ptr()
    print("same underlying buffers:", m1.weights["layer0_w"] is m2.weights["layer0_w"])
    stats = {k: v for k, v in mrm.stats().items()
             if k in ("opens", "disk_loads", "coalesced_loads")}
    print("MRM stats:", stats)
    return {"cold": m, "trims": [m1, m2], "stats": stats, "mrm": mrm, "client": client}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    run(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    main()

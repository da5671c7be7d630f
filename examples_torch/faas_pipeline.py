"""The paper's motivating example (Fig. 3/6) on the PyTorch port: an image ->
scene-description -> audio pipeline built from modular DL functions on a
FaaS platform, with TrIMS folding the four containers' private model copies
into shared ones.

    PYTHONPATH=src python examples_torch/faas_pipeline.py [--device cpu]

The weights land on the card unless ``--device cpu`` is given; without a
card the default raises.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.core import DiskStore, FaaSPlatform, MRM, ModelKey
from repro_torch.core.proxyzoo import build_proxy_tensors, proxy_forward, small_specs
from repro_torch.device import resolve_device

MODELS = ("AlexNet", "ResNet50", "GoogLeNet")


def run(device="cuda", disk=None):
    """Deploy the four functions, run the pipeline and the second tenant's
    call; returns what it measured. ``disk``: a store that may already hold
    the three proxy models (they are written at scale 0.02 where missing;
    a fresh store under a temporary directory by default)."""
    dev = resolve_device(device)
    if disk is None:
        root = tempfile.mkdtemp(prefix="trims_faas_")
        disk = DiskStore(f"{root}/models")
    zoo = {s.name: s for s in small_specs(scale=0.02)}
    for name in MODELS:
        key = ModelKey("repro-torch", name, "1")
        if not disk.contains(key):
            disk.put(key, build_proxy_tensors(zoo[name]))

    mrm = MRM(disk, device_capacity=2 << 30, host_capacity=8 << 30, device=dev)
    platform = FaaSPlatform(mrm)

    # -- user functions (isolated containers) -----------------------------
    def classify(ctx, image):
        m = ctx.load_model("repro-torch", "AlexNet")
        return {"label": float(proxy_forward(m.weights, image).sum()),
                "image": image}

    def scene(ctx, payload):
        m = ctx.load_model("repro-torch", "ResNet50")
        return {**payload,
                "scene": float(proxy_forward(m.weights, payload["image"]).mean())}

    def tts(ctx, payload):
        m = ctx.load_model("repro-torch", "GoogLeNet")
        return f"<audio label={payload['label']:.3f} scene={payload['scene']:.3f}>"

    # two tenants deploy the same classifier — the paper's sharing scenario
    platform.deploy("tenant_a/classify", classify)
    platform.deploy("tenant_b/classify", classify)
    platform.deploy("scene", scene, allowed_models=[("repro-torch", "ResNet50")])
    platform.deploy("tts", tts)

    image = np.random.default_rng(0).standard_normal((1, 64)).astype(np.float32)
    out = platform.invoke_pipeline(["tenant_a/classify", "scene", "tts"], image)
    print("pipeline output:", out)
    platform.invoke("tenant_b/classify", image)  # second tenant, same model

    stats = platform.mrm.stats()
    print(f"models loaded from disk: {stats['disk_loads']} "
          f"(opens: {stats['opens']}) — AlexNet loaded once, shared by both tenants")
    refcount = mrm.refcount(ModelKey('repro-torch', 'AlexNet', '1'))
    print(f"AlexNet refcount: {refcount}")
    for name, c in platform.containers.items():
        print(f"  {name:<20} invocations={c.acct.invocations} "
              f"load_time={c.acct.model_load_s*1e3:.1f}ms")
    return {"output": out, "stats": stats, "alexnet_refcount": refcount,
            "platform": platform, "mrm": mrm}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    run(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    main()

"""Train a small LM end to end on the PyTorch port with the full substrate:
data prefetch, async checkpointing, failure injection + automatic restart —
then publish the trained model into the TrIMS store and serve it.

    PYTHONPATH=src python examples_torch/train_small.py [--device cpu]   # quick demo
    PYTHONPATH=src python examples_torch/train_small.py --model-100m --steps 300

It trains on the card (through the port's kernels) unless ``--device cpu``
is given; without a card the default raises.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import DiskStore, MRM
from repro_torch.device import resolve_device
from repro_torch.launch.train import Trainer, TrainerConfig
from repro_torch.runtime import FailureInjector
from repro_torch.serving import InferenceEngine, publish_model


def run(steps=60, batch=4, seq=64, model_100m=False, inject_failures=True, device="cuda",
        cfg=None, root=None):
    """Train, publish and serve; returns what it measured. ``cfg``: the
    model config in place of the flags' olmo variant; ``root``: the working
    directory (checkpoints in ``root/ckpt``, where a checkpoint already
    there is resumed; a fresh temporary directory by default)."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = get_config("olmo-1b")
        if model_100m:
            cfg = cfg.replace(n_layers=8, d_model=768, n_heads=12, d_head=64,
                              d_ff=3072, remat_policy="none")
        else:
            cfg = cfg.reduced().replace(d_model=128, n_heads=4, d_head=32,
                                        d_ff=512, n_layers=4, remat_policy="none")
    print(f"training {cfg.param_count()/1e6:.1f}M-param olmo variant "
          f"for {steps} steps")

    root = root or tempfile.mkdtemp(prefix="trims_train_")
    tc = TrainerConfig(batch_size=batch, seq_len=seq,
                       steps=steps, ckpt_dir=f"{root}/ckpt",
                       ckpt_every=20, log_every=10)
    injector = FailureInjector(fail_at_steps=[steps // 2]) \
        if inject_failures else None
    tr = Trainer(cfg, tc, injector=injector, device=dev)
    out = tr.run_with_restarts(max_restarts=2)
    losses = [h["loss"] for h in out["history"]]
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({tr.restarts} simulated-failure restart(s) survived)")

    # hand the trained weights to the serving tier through the model store
    disk = DiskStore(f"{root}/models")
    publish_model(disk, cfg, out["params"], name="olmo-trained")
    engine = InferenceEngine(disk, MRM(disk, device_capacity=4 << 30, device=dev), device=dev)
    toks = np.arange(1, 1 + seq // 2, dtype=np.int32)[None, :]
    gen, st = engine.generate("olmo-trained", toks, max_new_tokens=8)
    print(f"served trained model: tier={st.tier_hit} tokens={gen[0].tolist()}")
    return {"cfg": cfg, "history": out["history"], "losses": losses,
            "restarts": tr.restarts, "tokens": gen, "stats": st}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--model-100m", action="store_true",
                    help="~100M-param config instead of the tiny demo one")
    ap.add_argument("--inject-failures", action="store_true", default=True)
    ap.add_argument("--device", default="cuda")
    run(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    main()

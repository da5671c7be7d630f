"""Set up the system under test and drive it with closed-loop clients.

The system is the port, ``repro_torch``: a ``DiskStore`` that the tenants'
weights are published into, the MRM over it, an ``InferenceEngine`` with
TrIMS on, and ``ServingWorkers`` draining one queue. Each client sends its
next request only when the previous one has returned; the tenant of the
n-th request of the run is ``order[n % len(order)]``, whatever the seed, and
its prompt the ``n % prompts``-th batch of a pool drawn from the seed.
"""
from __future__ import annotations

import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.client import TrimsClient
from repro_torch.core.mrm import MRM
from repro_torch.core.store import DiskStore
from repro_torch.models import model as M
from repro_torch.serving.engine import InferenceEngine, Request, ServingWorkers, publish_model

from trimsbench import spec, weights

REQUEST_TIMEOUT_S = 120.0


def port_config(c: dict) -> ModelConfig:
    """The port's ``ModelConfig`` for a configuration file (Hugging Face
    keys, as run), from its architecture's file."""
    return spec.arch(c).port_config(c)


def decoder_config(c: dict, **fields) -> ModelConfig:
    """A ``ModelConfig`` with the fields every decoder of Hugging Face keys
    shares, and ``fields`` (the family and what belongs to it) besides."""
    return ModelConfig(
        name=c["name"], n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        d_head=c.get("head_dim"), vocab_size=c["vocab_size"],
        rope_theta=float(c["rope_theta"]), norm_eps=float(c["rms_norm_eps"]),
        capacity_factor=float(c.get("assumed", {}).get("capacity_factor", 1.25)),
        moe_impl="capacity", tie_embeddings=bool(c["tie_word_embeddings"]),
        param_dtype=c["torch_dtype"], compute_dtype=c["torch_dtype"], **fields)


def prompt_pool(c: dict, t: dict, seed: int) -> List[np.ndarray]:
    rng = np.random.default_rng(seed % 2 ** 63)
    return [rng.integers(0, c["vocab_size"], (t["batch"], t["prompt"]), dtype=np.int32)
            for _ in range(t["prompts"])]


class RecordingClient(TrimsClient):
    """The engine's TrIMS client, noting each open's tier, bytes and
    measured H2D seconds (``OpenTimings``) as it returns."""

    def __init__(self, mrm: MRM, log: list):
        super().__init__(mrm, "engine")
        self.log = log

    def open(self, *args, **kwargs):
        h = super().open(*args, **kwargs)
        self.log.append((time.perf_counter(), h.timings.tier_hit, h.nbytes,
                         h.timings.h2d_measured_s))
        return h


@dataclass
class Record:
    n: int
    tenant: int
    prompt: int
    submit: float = 0.0
    done: float = 0.0
    submit_ns: int = 0
    done_ns: int = 0
    tokens: Optional[np.ndarray] = None
    stats: object = None            # the engine's RequestStats
    error: Optional[str] = None

    @property
    def latency_s(self) -> float:
        return self.done - self.submit


@dataclass
class System:
    mrm: MRM
    engine: InferenceEngine
    workers: ServingWorkers
    opens: list = field(default_factory=list)
    store_dir: Optional[Path] = None

    def close(self) -> None:
        """Stop the workers and drop every reference to the program's state."""
        self.workers.stop()
        self.mrm.shutdown()
        self.workers = self.engine = self.mrm = None
        if self.store_dir is not None:
            shutil.rmtree(self.store_dir, ignore_errors=True)


def build(c: dict, t: dict, seed: int, device) -> System:
    """Publish every tenant's weights (drawn on ``device`` from the seed)
    into a store under the temporary directory and start the MRM, the
    engine and the workers."""
    cfg = port_config(c)
    template = _flat_shapes(M.init_params(cfg, device="meta"))
    mine = {n: tuple(s) for n, s, _, _ in weights.layout(c)}
    if template != mine:
        raise ValueError(f"the port's layout differs from the benchmark's: "
                         f"{sorted(set(template.items()) ^ set(mine.items()))}")
    store_dir = Path(tempfile.mkdtemp(prefix="trimsbench_store_"))
    disk = DiskStore(str(store_dir))
    for i in range(t["tenants"]):
        flat = weights.draw(c, weights.tenant_seed(seed, i), device)
        publish_model(disk, cfg, weights.as_tree(flat), name=f"t{i}")
        del flat
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cap = t.get("device_tier_models")
    if cap is not None:
        cap = int(cap * weights.nbytes(c) * t["device_tier_headroom"])
    elif device.type != "cuda":
        cap = 64 * 2 ** 30
    mrm = MRM(disk, device_capacity=cap, device=device)
    engine = InferenceEngine(disk, mrm, device=device)
    opens: list = []
    engine.trims = RecordingClient(mrm, opens)
    workers = ServingWorkers(engine, n_workers=t["clients"])
    return System(mrm, engine, workers, opens, store_dir)


def _flat_shapes(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat_shapes(v, path) if isinstance(v, dict) else {path: tuple(v.shape)})
    return out


class ClosedLoop:
    """The traffic's ``clients`` threads, each sending its next request when the last one
    returned. The request counter runs on across phases, so the tenant order
    continues from warm-up into the window."""

    def __init__(self, system: System, t: dict, pool: List[np.ndarray]):
        self.system, self.t, self.pool = system, t, pool
        self.lock = threading.Lock()
        self.next = 0
        self.failed_to_return = False

    def run(self, count: Optional[int] = None, seconds: Optional[float] = None
            ) -> Tuple[List[Record], Optional[float]]:
        """One phase: ``count`` requests, or every request sent before
        ``seconds`` have passed since the phase's first one. Returns the
        phase's records and the time its first request was sent."""
        state = {"issued": 0, "t_open": None}
        records: List[Record] = []

        def client():
            while not self.failed_to_return:
                with self.lock:
                    now = time.perf_counter()
                    if count is not None and state["issued"] >= count:
                        return
                    if seconds is not None and state["t_open"] is not None \
                            and now - state["t_open"] >= seconds:
                        return
                    if state["t_open"] is None:
                        state["t_open"] = now
                    state["issued"] += 1
                    n = self.next
                    self.next += 1
                rec = self._one(n)
                with self.lock:
                    records.append(rec)

        threads = [threading.Thread(target=client, name=f"client{k}")
                   for k in range(self.t["clients"])]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        records.sort(key=lambda r: r.n)
        return records, state["t_open"]

    def _one(self, n: int) -> Record:
        order = self.t["order"]
        rec = Record(n=n, tenant=order[n % len(order)], prompt=n % len(self.pool))
        req = Request(model=f"t{rec.tenant}", tokens=self.pool[rec.prompt],
                      max_new=self.t["new_tokens"])
        rec.submit, rec.submit_ns = time.perf_counter(), time.time_ns()
        self.system.workers.submit(req)
        returned = req.done.wait(REQUEST_TIMEOUT_S)
        rec.done, rec.done_ns = time.perf_counter(), time.time_ns()
        if not returned:
            rec.error = f"no answer in {REQUEST_TIMEOUT_S} s"
            self.failed_to_return = True
        elif isinstance(req.result, Exception):
            rec.error = repr(req.result)
        else:
            rec.tokens, rec.stats = req.result, req.stats
        return rec

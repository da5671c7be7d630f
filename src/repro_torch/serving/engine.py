"""Inference engine of the PyTorch port: the FaaS-side consumer of TrIMS.

Mirrors the JAX package's ``serving/engine.py`` batch path. Requests are
served against models resolved through the TrIMS client (warm path) or a
cold disk load (the baseline). Weights arrive as the MRM's shared device
tensors and are used in place: every handle of one model computes on the
same device copy.

PyTorch runs eagerly, so there is no compiled program to cache: the
"executable" of a (topology, batch, shape) signature is the model function
itself, and ``compile_s`` is the measured time of its first call (library
builds, kernel loads, cuBLAS set-up), timed the way the JAX engine times
XLA's first run. Layer streaming and the prefix-KV cache belong to later
slices of the port.

Latency accounting per request mirrors paper Fig. 1/9:
  model_load_s (disk+deserialize+H2D | share), compile_s, compute_s.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cache import Tier
from repro_torch.core.client import LoadedModel, TrimsClient, cold_load, free_model
from repro_torch.core.mrm import MRM, ModelKey
from repro_torch.core.store import DiskStore
from repro_torch.device import resolve_device, synchronize, tensor_from_numpy
from repro_torch.models import model as M
from repro_torch.serving.weights_io import flat_to_params_like, params_to_flat

FRAMEWORK = "repro-torch"
_LATER_SLICE = "belongs to a later slice of the PyTorch port"


def arch_signature(cfg: ModelConfig) -> str:
    payload = json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str)
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


def publish_model(disk: DiskStore, cfg: ModelConfig, params,
                  name: Optional[str] = None, version: str = "1",
                  framework: str = FRAMEWORK) -> ModelKey:
    """Serialize a params tree into the store (deploy path / train export)."""
    key = ModelKey(framework, name or cfg.name, version)
    disk.put(key, params_to_flat(params),
             meta={"config": dataclasses.asdict(cfg)})
    return key


@dataclass
class ServableModel:
    key: ModelKey
    cfg: ModelConfig
    params: Any
    loaded: LoadedModel
    nbytes: int


@dataclass
class RequestStats:
    model: str
    cold: bool
    tier_hit: str
    model_load_s: float
    compile_s: float
    compute_s: float
    total_s: float
    modeled_load_s: float = 0.0
    ttft_s: float = 0.0          # submit -> first token materialized
    streamed: bool = False       # layer-streaming path (a later slice)


class InferenceEngine:
    def __init__(self, disk: DiskStore, mrm: Optional[MRM] = None,
                 use_trims: bool = True,
                 prefix_cache_bytes: int = 0,
                 streaming: bool = False,
                 device="cuda",
                 framework: str = FRAMEWORK):
        if streaming:
            raise NotImplementedError(f"streaming (layer-streamed serving) {_LATER_SLICE}")
        if prefix_cache_bytes > 0:
            raise NotImplementedError(f"the prefix-KV cache {_LATER_SLICE}")
        self.device = resolve_device(device)
        if mrm is not None and mrm.device_name != self.device:
            raise ValueError(f"engine on {self.device} but the MRM's device tier is "
                             f"{mrm.device_name}")
        self.disk = disk
        self.mrm = mrm
        self.framework = framework
        self.use_trims = use_trims and mrm is not None
        self.trims = TrimsClient(mrm, "engine") if self.use_trims else None
        # exe cache is keyed by architecture signature (not model identity) so
        # same-topology models share entries; cfg cache keys by (name,
        # version) — version "2" of a model may ship a different architecture.
        self._exe_cache: Dict[Tuple[str, str, int, int, int], Any] = {}
        self._exe_compiled: set = set()   # sigs whose first call was timed
        self._cfg_cache: Dict[Tuple[str, str], ModelConfig] = {}
        self._lock = threading.RLock()
        self.stats: List[RequestStats] = []
        self.exe_cache_hits = 0
        self.exe_cache_misses = 0

    # ------------------------------------------------------------- loading
    def _config_for(self, key: ModelKey) -> ModelConfig:
        mf = self.disk.open(key)
        raw = dict(mf.meta["config"])
        return ModelConfig(**raw)

    def load_model(self, name: str, version: str = "1"
                   ) -> Tuple[ServableModel, float]:
        """Resolve weights (TrIMS or cold) -> params tree. Returns
        (model, load_seconds)."""
        key = ModelKey(self.framework, name, version)
        cfg = self._cfg_cache.get((name, version)) or self._config_for(key)
        self._cfg_cache[(name, version)] = cfg
        t0 = time.perf_counter()
        if self.use_trims:
            h = self.trims.open(self.framework, name, version)
            loaded = LoadedModel(key, h.weights, h.nbytes, h.timings,
                                 via_trims=True, handle=h)
        else:
            loaded = cold_load(self.disk, key, device=self.device)
        load_s = time.perf_counter() - t0
        template = M.init_params(cfg, device="meta")
        params = flat_to_params_like(
            template, loaded.weights,
            convert=lambda v: v if torch.is_tensor(v) else tensor_from_numpy(v, self.device))
        return ServableModel(key, cfg, params, loaded, loaded.nbytes), load_s

    def release(self, sm: ServableModel):
        free_model(sm.loaded, self.trims)

    def prefetch(self, name: str, version: str = "1"):
        """Warm the next model's weights toward the device tier in the
        background — issued by workers so the next request's load overlaps
        the current request's compute. No-op without TrIMS.

        Device-tier prefetch is gated on free device memory: staging into a
        full device tier would evict (or capacity-block) the model the
        *current* request is about to open. Without headroom we still warm
        the host tier — that is where the expensive disk+deserialize work
        lives."""
        if not self.use_trims:
            return None
        key = ModelKey(self.framework, name, version)
        if not self.disk.contains(key):
            return None
        tier = "device"
        try:
            if self.mrm.device.free_bytes() < self.disk.open(key).total_bytes:
                tier = "host"
        except Exception:  # noqa: BLE001 — a hint must never fail the worker
            tier = "host"
        return self.mrm.prefetch(key, tier=tier)

    # ------------------------------------------------------------- compile
    def _executable(self, cfg: ModelConfig, kind: str, B: int, S: int,
                    max_len: int) -> Tuple[Any, tuple]:
        """The model function for ``kind``, cached by topology signature.
        Returns ``(fn, sig)``: there is nothing to trace, and
        :meth:`_run_exe` times the first call against ``sig``."""
        sig = (arch_signature(cfg), kind, B, S, max_len)
        with self._lock:
            exe = self._exe_cache.get(sig)
            if exe is not None:
                self.exe_cache_hits += 1
                return exe, sig
            self.exe_cache_misses += 1
            if kind == "prefill":
                exe = functools.partial(M.prefill, cfg, max_len=max_len)
            elif kind == "decode":
                exe = functools.partial(M.decode_step, cfg)
            else:
                raise ValueError(f"unknown executable kind {kind!r}")
            self._exe_cache[sig] = exe
        return exe, sig

    def _run_exe(self, sig: tuple, exe, *args) -> Tuple[Any, float]:
        """Run a cached model function, timing its FIRST call (to its
        completion on the device) so one-time set-up lands in ``compile_s``
        instead of ``compute_s``. Returns ``(out, extra_compile_s)``."""
        with self._lock:
            first = sig not in self._exe_compiled
            if first:
                self._exe_compiled.add(sig)
        if not first:
            return exe(*args), 0.0
        t0 = time.perf_counter()
        out = exe(*args)
        synchronize(self.device)
        return out, time.perf_counter() - t0

    # --------------------------------------------------------------- infer
    def generate(self, name: str, tokens: np.ndarray, max_new_tokens: int = 8,
                 version: str = "1") -> Tuple[np.ndarray, RequestStats]:
        """Prefill + greedy decode. tokens: (B, S) int32."""
        return self._generate_batch(name, tokens, max_new_tokens, version)

    def _generate_batch(self, name: str, tokens: np.ndarray,
                        max_new_tokens: int, version: str
                        ) -> Tuple[np.ndarray, RequestStats]:
        t_start = time.perf_counter()
        sm, load_s = self.load_model(name, version)
        try:
            B, S = tokens.shape
            max_len = S + max_new_tokens
            exe_p, sig_p = self._executable(sm.cfg, "prefill", B, S, max_len)
            exe_d, sig_d = self._executable(sm.cfg, "decode", B, 1, max_len)
            extra_c = 0.0

            t0 = time.perf_counter()
            batch = {"tokens": torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                               device=self.device)}
            (logits, cache), dc = self._run_exe(sig_p, exe_p, sm.params, batch)
            extra_c += dc
            tok = logits.argmax(-1)
            synchronize(self.device)
            ttft_s = time.perf_counter() - t_start
            out = [tok]
            for i in range(max_new_tokens - 1):
                (logits, cache), dc = self._run_exe(
                    sig_d, exe_d, sm.params, cache, tok, S + i)
                extra_c += dc
                tok = logits.argmax(-1)
                out.append(tok)
            result = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
            compute_s = max(0.0, time.perf_counter() - t0 - extra_c)
        finally:
            self.release(sm)

        tm = sm.loaded.timings
        st = RequestStats(
            model=name, cold=not sm.loaded.via_trims or tm.tier_hit != "device",
            tier_hit=tm.tier_hit, model_load_s=load_s,
            compile_s=extra_c, compute_s=compute_s,
            total_s=time.perf_counter() - t_start,
            modeled_load_s=tm.modeled_total(), ttft_s=ttft_s)
        with self._lock:
            self.stats.append(st)
        return result, st


# ---------------------------------------------------------------------------
# request queue + batching (workload-modeling harness, paper Fig. 11)
# ---------------------------------------------------------------------------

@dataclass
class Request:
    model: str
    tokens: np.ndarray
    max_new: int = 4
    submitted: float = field(default_factory=time.perf_counter)
    done: Optional[threading.Event] = None
    result: Any = None
    stats: Optional[RequestStats] = None


class ServingWorkers:
    """N concurrent workers draining a shared queue — the paper's
    'concurrency level'."""

    def __init__(self, engine: InferenceEngine, n_workers: int = 4,
                 lookahead_prefetch: bool = True, lookahead: int = 1):
        self.engine = engine
        self.n_workers = n_workers
        self.lookahead_prefetch = lookahead_prefetch
        self.lookahead = max(1, lookahead)   # distinct queued models to warm
        import queue as _q
        self.q: "_q.Queue[Optional[Request]]" = _q.Queue()
        self.threads = [threading.Thread(target=self._run, daemon=True)
                        for _ in range(n_workers)]
        for t in self.threads:
            t.start()

    def submit(self, req: Request) -> Request:
        req.done = threading.Event()
        self.q.put(req)
        return req

    def _peek_next_models(self, n: int) -> List[str]:
        """First ``n`` DISTINCT models in the queue (no dequeue) — the
        prefetch targets. Deduped so a burst of requests for one model
        costs one hint."""
        out: List[str] = []
        seen = set()
        with self.q.mutex:
            for item in self.q.queue:
                if item is None or item.model in seen:
                    continue
                seen.add(item.model)
                out.append(item.model)
                if len(out) >= n:
                    break
        return out

    def _peek_next_model(self) -> Optional[str]:
        """Model of the next queued request (no dequeue) — prefetch target."""
        nxt = self._peek_next_models(1)
        return nxt[0] if nxt else None

    def _run(self):
        while True:
            req = self.q.get()
            if req is None:
                return
            if self.lookahead_prefetch:
                eng = self.engine
                for nxt in self._peek_next_models(self.lookahead):
                    if nxt == req.model:
                        continue
                    if eng.use_trims:
                        k = ModelKey(eng.framework, nxt, "1")
                        if eng.mrm.resident(k, Tier.DEVICE):
                            continue   # already staged: the hint is free work
                    # overlap the NEXT requests' model staging with THIS
                    # request's load+compute (async MRM load, zero refs)
                    eng.prefetch(nxt)
            try:
                req.result, req.stats = self.engine.generate(
                    req.model, req.tokens, req.max_new)
            except Exception as e:  # noqa: BLE001
                req.result = e
            finally:
                req.done.set()

    def drain(self, reqs: List[Request], timeout: float = 600.0):
        for r in reqs:
            r.done.wait(timeout)

    def stop(self):
        for _ in self.threads:
            self.q.put(None)
        for t in self.threads:
            t.join(timeout=5)

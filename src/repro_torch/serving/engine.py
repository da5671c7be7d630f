"""Inference engine of the PyTorch port: the FaaS-side consumer of TrIMS.

Mirrors the JAX package's ``serving/engine.py``. Requests are
served against models resolved through the TrIMS client (warm path) or a
cold disk load (the baseline). Weights arrive as the MRM's shared device
tensors and are used in place: every handle of one model computes on the
same device copy.

PyTorch runs eagerly, so there is no compiled program to cache: the
"executable" of a (topology, batch, shape) signature is the model function
itself, and ``compile_s`` is the measured time of its first call (library
builds, kernel loads, cuBLAS set-up), timed the way the JAX engine times
XLA's first run. With ``streaming`` on, a cold DENSE or MoE model is served
layer by layer against a partial open (DESIGN.md §9); with ``prefix_cache_bytes``
the batch path reuses the prefill of a prompt it has seen
(``serving/prefix_cache.py``).

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

from repro_torch.configs.base import DENSE, MOE, ModelConfig
from repro_torch.core.cache import Tier
from repro_torch.core.client import LoadedModel, TrimsClient, cold_load, free_model
from repro_torch.core.mrm import MRM, ModelKey
from repro_torch.core.store import DiskStore
from repro_torch.device import resolve_device, synchronize, tensor_from_numpy
from repro_torch.models import model as M
from repro_torch.serving.prefix_cache import PrefixKVStore, prompt_key
from repro_torch.serving.weights_io import flat_to_params_like, params_to_flat

FRAMEWORK = "repro-torch"


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
    streamed: bool = False       # served via the layer-streaming path (§9)


class InferenceEngine:
    def __init__(self, disk: DiskStore, mrm: Optional[MRM] = None,
                 use_trims: bool = True,
                 prefix_cache_bytes: int = 0,
                 streaming: bool = False,
                 device="cuda",
                 framework: str = FRAMEWORK):
        self.device = resolve_device(device)
        if mrm is not None and mrm.device_name != self.device:
            raise ValueError(f"engine on {self.device} but the MRM's device tier is "
                             f"{mrm.device_name}")
        self.disk = disk
        self.mrm = mrm
        self.framework = framework
        self.use_trims = use_trims and mrm is not None
        # streaming (DESIGN.md §9): serve DENSE/MoE requests layer by layer
        # against a partial open — prefill starts once stem+layer0 land.
        # Other families (or warm hits) fall back to the batch path.
        self.streaming = streaming and self.use_trims
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
        self.prefix_kv = (PrefixKVStore(prefix_cache_bytes)
                          if prefix_cache_bytes > 0 else None)

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
        lives.

        With ``streaming`` on, a model that is not yet disk-resident but is
        reachable (cloud) is warmed through a partial open instead
        (``MRM.open_stream``): when a request for it arrives mid-flight, its
        streaming open coalesces onto this one and inherits the per-window
        readiness already accumulated."""
        if not self.use_trims:
            return None
        key = ModelKey(self.framework, name, version)
        if not self.disk.contains(key):
            if self.streaming and self._fetchable(key):
                return self.mrm.open_stream(key, want_handle=False)
            return None
        tier = "device"
        try:
            if self.mrm.device.free_bytes() < self.disk.open(key).total_bytes:
                tier = "host"
        except Exception:  # noqa: BLE001 — a hint must never fail the worker
            tier = "host"
        return self.mrm.prefetch(key, tier=tier)

    def _fetchable(self, key: ModelKey) -> bool:
        """Whether the MRM can fetch ``key`` from outside the local disk (the
        CLOUD tier's object store or legacy store, or a peer hook)."""
        m = self.mrm
        try:
            return ((m.objectstore is not None and m.objectstore.contains(key))
                    or (m.cloud is not None and m.cloud.contains(key))
                    or m.remote_fetch is not None)
        except Exception:  # noqa: BLE001 — a hint must never fail the worker
            return False

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
            elif kind == "sembed":
                exe = functools.partial(M.stream_prefill_embed, cfg)
            elif kind == "slayer":
                exe = functools.partial(M.stream_prefill_layer, cfg, max_len=max_len)
            elif kind == "slogits":
                exe = functools.partial(M.stream_logits, cfg)
            elif kind == "sdembed":
                exe = functools.partial(M.stream_decode_embed, cfg)
            elif kind == "sdlayer":
                exe = functools.partial(M.stream_decode_layer, cfg)
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
        """Prefill + greedy decode. tokens: (B, S) int32.

        With ``streaming`` on, cold DENSE/MoE loads are served layer by layer
        against a partial open (same tokens, earlier first token); anything
        else falls through to the batch path below."""
        if self.streaming:
            r = self._generate_streaming(name, tokens, max_new_tokens, version)
            if r is not None:
                return r
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
            pkey = hit = None
            if self.prefix_kv is not None:
                pkey = prompt_key(name, tokens, max_len)
                hit = self.prefix_kv.lookup(pkey)
            if hit is not None:
                logits, cache = hit     # the cache is this request's own clone
            else:
                (logits, cache), dc = self._run_exe(sig_p, exe_p, sm.params, batch)
                extra_c += dc
                if self.prefix_kv is not None:
                    self.prefix_kv.insert(pkey, logits, cache,
                                          time.perf_counter() - t0)
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

    def _generate_streaming(self, name: str, tokens: np.ndarray,
                            max_new_tokens: int, version: str
                            ) -> Optional[Tuple[np.ndarray, RequestStats]]:
        """Layer-streaming serve (DESIGN.md §9): open the model through
        :meth:`MRM.open_stream`, start prefill as soon as the stem and
        layer-0 windows are resident, and chase the stream layer by layer.
        Each window's rows are copied to the device once and reused by every
        decode step (the host arrays become the host tier's entry, so they
        are never aliased). MoE expert windows of the NEXT layer are
        demanded while the current layer computes. Returns None to fall back
        to the batch path (warm hit, a family other than DENSE/MoE, or no
        layer plan)."""
        t_start = time.perf_counter()
        key = ModelKey(self.framework, name, version)
        cfg = self._cfg_cache.get((name, version))
        if cfg is None and self.disk.contains(key):
            cfg = self._config_for(key)
        if cfg is None and not self._fetchable(key):
            return None
        if cfg is not None and cfg.family not in (DENSE, MOE):
            return None
        if self.mrm.resident(key, Tier.DEVICE) or \
                self.mrm.resident(key, Tier.HOST):
            return None            # warm model: batch path is strictly better

        fut = self.mrm.open_stream(key)
        blocked_s = 0.0
        t0 = time.perf_counter()
        fut.wait_prefix(1)          # stem (+ layer 0) landing / plan known
        blocked_s += time.perf_counter() - t0
        if cfg is None:             # cloud-only model: config rides the meta
            raw = (fut.meta or {}).get("config")
            if raw is not None:
                cfg = ModelConfig(**dict(raw))
                self._cfg_cache[(name, version)] = cfg
        if fut.plan is None or cfg is None or cfg.family not in (DENSE, MOE):
            # warm hit / non-streaming primary / unknown config: batch path
            # (the close below just drops our reference; bytes stay cached)
            h = fut.result()
            if h is not None:
                self.mrm.close(h)
            return None

        plan = fut.plan
        # windows needed before layer i can run: every window up to and
        # including layer i's last (expert windows follow their base window)
        n_layers = cfg.n_layers
        per_layer_prefix = [0] * n_layers
        expert_windows: Dict[int, List[int]] = {}
        for w in plan:
            if w.layer_index >= 0 and w.layer_index < n_layers:
                per_layer_prefix[w.layer_index] = max(
                    per_layer_prefix[w.layer_index], w.index + 1)
                if w.group == "expert":
                    expert_windows.setdefault(w.layer_index, []).append(w.index)
        if any(p == 0 for p in per_layer_prefix):
            h = fut.result()
            if h is not None:
                self.mrm.close(h)
            return None

        try:
            B, S = tokens.shape
            max_len = S + max_new_tokens
            exe_e, sig_e = self._executable(cfg, "sembed", B, S, max_len)
            exe_l, sig_l = self._executable(cfg, "slayer", B, S, max_len)
            exe_g, sig_g = self._executable(cfg, "slogits", B, S, max_len)
            exe_de, sig_de = self._executable(cfg, "sdembed", B, 1, max_len)
            exe_dl, sig_dl = self._executable(cfg, "sdlayer", B, 1, max_len)
            extra_c = 0.0

            template = M.init_params(cfg, device="meta")
            stem_tpl = {k: v for k, v in template.items() if k != "layers"}

            def conv(a):
                return tensor_from_numpy(a, self.device)

            def stem_params():
                flat = {n: a for n, a in fut.arrays.items()
                        if not n.startswith("layers/")}
                return flat_to_params_like(stem_tpl, flat, convert=conv)

            def layer_params(i):
                flat = {n[len("layers/"):]: fut.arrays[n][i]
                        for n in fut.arrays if n.startswith("layers/")}
                return flat_to_params_like(template["layers"], flat, convert=conv)

            t_c0 = time.perf_counter()
            tw = time.perf_counter()
            fut.wait_prefix(per_layer_prefix[0])
            blocked_s += time.perf_counter() - tw
            stem = stem_params()
            positions = torch.arange(S, device=self.device)[None, :]
            toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)
            x, dc = self._run_exe(sig_e, exe_e, stem, toks)
            extra_c += dc
            layers: List[Any] = []
            caches: List[Any] = []
            for i in range(n_layers):
                tw = time.perf_counter()
                fut.wait_prefix(per_layer_prefix[i])
                blocked_s += time.perf_counter() - tw
                layers.append(layer_params(i))
                for wi in expert_windows.get(i + 1, ()):   # overlap next layer's
                    fut.demand(wi)                         # expert bank with math
                (x, cl), dc = self._run_exe(sig_l, exe_l, layers[i], x, positions)
                extra_c += dc
                caches.append(cl)
            logits, dc = self._run_exe(sig_g, exe_g, stem, x)
            extra_c += dc
            tok = logits.argmax(-1)
            synchronize(self.device)
            ttft_s = time.perf_counter() - t_start
            out = [tok]
            for step in range(max_new_tokens - 1):
                pos = S + step
                x, dc = self._run_exe(sig_de, exe_de, stem, tok)
                extra_c += dc
                for i in range(n_layers):
                    (x, caches[i]), dc = self._run_exe(
                        sig_dl, exe_dl, layers[i], x, caches[i], pos)
                    extra_c += dc
                logits, dc = self._run_exe(sig_g, exe_g, stem, x)
                extra_c += dc
                tok = logits.argmax(-1)
                out.append(tok)
            result = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
            compute_s = max(0.0, time.perf_counter() - t_c0 - extra_c)
        finally:
            h = fut.result()            # loader done (verifies all windows)
            if h is not None:
                self.mrm.close(h)

        tm = fut.timings
        st = RequestStats(
            model=name, cold=True, tier_hit=tm.tier_hit,
            model_load_s=blocked_s,   # critical-path wait, not wall staging
            compile_s=extra_c, compute_s=compute_s,
            total_s=time.perf_counter() - t_start,
            modeled_load_s=tm.modeled_total(), ttft_s=ttft_s, streamed=True)
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

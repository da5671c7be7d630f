"""Sharing-granularity cost model (paper §5.2).

``rho = b / q - n * (o + s)``
  b: bytes the model occupies on disk
  q: disk I/O bandwidth
  n: number of shared objects (1 at model granularity, n_layers at layer
     granularity, or layer-group count in between)
  o: overhead of sharing one memory object (CUDA-IPC open in the paper;
     shm-segment attach here)
  s: overhead of obtaining a usable pointer from a shared handle

If rho > 0, sharing at that granularity beats a cold load; its magnitude
correlates with the speedup. Constants are measured once at startup and
cached (paper: "computed once at system startup").
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.costmodel import get_hardware


@dataclass
class SharingConstants:
    o: float   # per-object share overhead (seconds)
    s: float   # per-object map/pointer overhead (seconds)
    q: float   # disk bandwidth (bytes/second)


def measure_constants(n_trials: int = 20) -> SharingConstants:
    """Microbenchmark o and s with real shm segments; q from the hw model."""
    from multiprocessing import shared_memory

    o_times, s_times = [], []
    for i in range(n_trials):
        t0 = time.perf_counter()
        seg = shared_memory.SharedMemory(create=True, size=4096,
                                         name=f"trims_probe_{os.getpid()}_{i}")
        o_times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        att = shared_memory.SharedMemory(name=seg.name)
        arr = np.frombuffer(att.buf, dtype=np.uint8)
        _ = arr[0]
        s_times.append(time.perf_counter() - t0)
        del arr  # release the exported buffer before closing the segment
        att.close()
        seg.close()
        seg.unlink()
    hw = get_hardware()
    return SharingConstants(o=float(np.median(o_times)),
                            s=float(np.median(s_times)),
                            q=hw.disk_bw)


_CACHE = os.path.join(tempfile.gettempdir(), "trims_torch_sharing_constants.json")
_cached: SharingConstants | None = None


def get_constants(refresh: bool = False) -> SharingConstants:
    global _cached
    if _cached is not None and not refresh:
        return _cached
    if not refresh and os.path.exists(_CACHE):
        try:
            with open(_CACHE) as f:
                _cached = SharingConstants(**json.load(f))
            return _cached
        except Exception:
            pass
    _cached = measure_constants()
    try:
        with open(_CACHE, "w") as f:
            json.dump(asdict(_cached), f)
    except OSError:
        pass
    return _cached


def rho(b: int, n: int, consts: SharingConstants) -> float:
    """Paper's sharing-benefit estimate; positive => share."""
    return b / consts.q - n * (consts.o + consts.s)


def plan_granularity(tensor_sizes: Sequence[int],
                     consts: SharingConstants | None = None,
                     group_target: int = 32 << 20
                     ) -> Tuple[str, int, float]:
    """Pick the finest granularity with positive rho.

    Finer granularity maximizes partial-sharing opportunities (e.g.
    transfer-learned models with shared frozen layers) but costs n*(o+s).
    Returns (granularity, n_objects, rho_value).
    """
    consts = consts or get_constants()
    b = int(sum(tensor_sizes))
    n_layers = len(tensor_sizes)
    options: List[Tuple[str, int]] = [("layer", n_layers)]
    # group layers into ~group_target-byte blocks
    groups, acc = 1, 0
    for sz in tensor_sizes:
        acc += sz
        if acc >= group_target:
            groups += 1
            acc = 0
    options.append(("layer_group", max(1, groups)))
    options.append(("model", 1))
    for gran, n in options:  # finest-first
        r = rho(b, n, consts)
        if r > 0:
            return gran, n, r
    return "model", 1, rho(b, 1, consts)

"""TrIMS model store: serialization format + disk/cloud tiers.

Format (``.trims`` files)::

    MAGIC b"TRIMS001"
    uint64 header_len
    header json: {"tensors": [{"name","dtype","shape","offset","nbytes","crc32"}, ...],
                  "meta": {...}}
    payload: 64-byte-aligned raw little-endian tensor bytes

Per-tensor offsets enable **layer-granularity** reads (paper §4.2 sharing
granularity) and ``np.memmap`` enables zero-copy disk->host mapping.
``CloudStore`` here is the legacy throttled-directory remote tier; the
real CLOUD tier is the content-addressed ``repro_torch.core.objectstore``
(DESIGN.md §6), which new code should prefer.
"""
from __future__ import annotations

import io
import json
import os
import tempfile
import time
import zlib
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.bf16 import BF16_BITS

MAGIC = b"TRIMS001"
ALIGN = 64


@contextmanager
def atomic_dest_file(dst: str, prefix: str = ".tmp-"):
    """Atomic-write idiom shared by every transfer path: a UNIQUE temp
    file in ``dst``'s directory (concurrent writers of one destination
    must not share a staging name), renamed onto ``dst`` on clean exit,
    unlinked on error. Yields ``(fd, tmp_path)``; the caller owns the fd
    and must close it before the context exits."""
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dst), prefix=prefix)
    try:
        yield fd, tmp
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, dst)


@dataclass(frozen=True)
class TensorMeta:
    name: str
    dtype: str
    shape: Tuple[int, ...]
    offset: int
    nbytes: int
    crc32: int


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def write_model(path: str, tensors: Dict[str, np.ndarray],
                meta: Optional[dict] = None, checksum: bool = True) -> int:
    """Serialize ``tensors`` (flat name->array). Returns total bytes written."""
    entries: List[dict] = []
    offset = 0
    blobs: List[bytes] = []
    for name, arr in tensors.items():
        arr = np.asarray(arr)
        if not arr.flags.c_contiguous:
            # NB: np.ascontiguousarray promotes 0-d to 1-d; preserve shape
            arr = np.ascontiguousarray(arr).reshape(arr.shape)
        raw = arr.tobytes()
        entries.append({
            "name": name, "dtype": _dtype_name(arr.dtype),
            "shape": list(arr.shape), "offset": offset, "nbytes": len(raw),
            "crc32": zlib.crc32(raw) if checksum else 0,
        })
        blobs.append(raw)
        offset = _align(offset + len(raw))
    header = json.dumps({"tensors": entries, "meta": meta or {}}).encode()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        base = f.tell()
        pad = _align(base) - base
        f.write(b"\0" * pad)
        pos = 0
        for e, raw in zip(entries, blobs):
            f.write(b"\0" * (e["offset"] - pos))
            f.write(raw)
            pos = e["offset"] + len(raw)
        total = f.tell()
    os.replace(tmp, path)
    return total


def _np_dtype(name: str):
    if name == "bfloat16":
        return BF16_BITS
    return np.dtype(name)


def _dtype_name(dtype: np.dtype) -> str:
    """Header dtype name: bf16 arrays (tagged uint16 bits, or the JAX
    package's ``ml_dtypes.bfloat16``) are written as ``"bfloat16"``."""
    md = dtype.metadata
    if md and md.get("trims") == "bfloat16":
        return "bfloat16"
    return str(dtype.name)


class ModelFile:
    """Reader with per-tensor (layer-granular) access."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            if f.read(8) != MAGIC:
                raise ValueError(f"{path}: bad magic")
            hlen = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(hlen))
            self.payload_base = _align(f.tell())
        self.meta = header["meta"]
        self.tensors: Dict[str, TensorMeta] = {
            e["name"]: TensorMeta(e["name"], e["dtype"], tuple(e["shape"]),
                                  e["offset"], e["nbytes"], e["crc32"])
            for e in header["tensors"]
        }

    @property
    def total_bytes(self) -> int:
        return sum(t.nbytes for t in self.tensors.values())

    def read_tensor(self, name: str, verify: bool = False,
                    out: Optional[memoryview] = None) -> np.ndarray:
        t = self.tensors[name]
        with open(self.path, "rb") as f:
            f.seek(self.payload_base + t.offset)
            raw = f.read(t.nbytes)
        if verify and t.crc32 and zlib.crc32(raw) != t.crc32:
            raise IOError(f"{self.path}:{name}: checksum mismatch")
        if out is not None:
            out[:t.nbytes] = raw
            arr = np.frombuffer(out, dtype=_np_dtype(t.dtype), count=int(np.prod(t.shape)) if t.shape else 1)
            return arr.reshape(t.shape)
        return np.frombuffer(raw, dtype=_np_dtype(t.dtype)).reshape(t.shape)

    def read_all(self, verify: bool = False) -> Dict[str, np.ndarray]:
        return {n: self.read_tensor(n, verify=verify) for n in self.tensors}

    def mmap_tensor(self, name: str) -> np.ndarray:
        """Zero-copy view backed by the page cache (cold-load fast path)."""
        t = self.tensors[name]
        mm = np.memmap(self.path, dtype=np.uint8, mode="r",
                       offset=self.payload_base + t.offset, shape=(t.nbytes,))
        return mm.view(_np_dtype(t.dtype)).reshape(t.shape)


class DiskStore:
    """Local-storage tier: a directory of .trims files keyed by model key."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def path_for(self, key) -> str:
        fw, name, ver = key
        return os.path.join(self.root, fw, f"{name}@{ver}.trims")

    def contains(self, key) -> bool:
        return os.path.exists(self.path_for(key))

    def put(self, key, tensors: Dict[str, np.ndarray], meta=None) -> int:
        return write_model(self.path_for(key), tensors, meta)

    def open(self, key) -> ModelFile:
        return ModelFile(self.path_for(key))

    def delete(self, key):
        try:
            os.unlink(self.path_for(key))
        except FileNotFoundError:
            pass

    def keys(self):
        out = []
        for fw in os.listdir(self.root):
            d = os.path.join(self.root, fw)
            if not os.path.isdir(d):
                continue
            for fn in os.listdir(d):
                if fn.endswith(".trims"):
                    name, ver = fn[:-len(".trims")].rsplit("@", 1)
                    out.append((fw, name, ver))
        return out


class CloudStore:
    """Remote-storage tier: DiskStore behind a bandwidth/latency throttle.

    ``download`` copies a model into a local DiskStore at ``cloud_bw``
    (sleep-throttled so benchmark timings reflect the modeled network).
    """

    def __init__(self, root: str, bw: float = 1e9, rtt: float = 20e-3,
                 simulate_time: bool = True):
        self.store = DiskStore(root)
        self.bw, self.rtt = bw, rtt
        self.simulate_time = simulate_time

    def contains(self, key) -> bool:
        return self.store.contains(key)

    def put(self, key, tensors, meta=None) -> int:
        return self.store.put(key, tensors, meta)

    def download(self, key, dest: DiskStore) -> Tuple[float, int]:
        """Copy key into ``dest``; returns (modeled_seconds, nbytes).

        Concurrent downloads of one key are safe: each writes a unique
        temp file (the shared ``dst + ".tmp"`` name would let one racer
        unlink the other's staging file out from under its replace)."""
        src = self.store.path_for(key)
        dst = dest.path_for(key)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        nbytes = os.path.getsize(src)
        modeled = self.rtt + nbytes / self.bw
        t0 = time.perf_counter()
        with atomic_dest_file(dst, prefix=".dl-") as (fd, _):
            with open(src, "rb") as fs, os.fdopen(fd, "wb") as fdst:
                while True:
                    chunk = fs.read(8 << 20)
                    if not chunk:
                        break
                    fdst.write(chunk)
        elapsed = time.perf_counter() - t0
        if self.simulate_time and elapsed < modeled:
            time.sleep(min(modeled - elapsed, 0.25))  # cap: keep benches fast
        return modeled, nbytes

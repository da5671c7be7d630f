"""Deterministic synthetic token pipeline, prefetched.

A copy of the JAX package's ``data/pipeline.py``. Data comes from a
counter-based hash (stateless: any (step, position) can be recomputed
after a restart, so exact resume needs no data state in the checkpoint).
The numpy batches are byte-equal to the reference's; ``make_batch`` puts
them on ``device``. With ``sharding`` (a ``launch.sharding.NamedSharding``
of the batch) each rank builds only its rows of the global batch, the rows
``jax.make_array_from_callback`` gives that device, and the batch is a
``DTensor`` over the batch axes.

Straggler mitigation: the prefetch thread keeps a bounded queue ahead of
the training loop, so a slow generation step does not stall the device
while queued batches remain.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ENCDEC, VLM, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.partitioning import FLAT, FLAT_AXES


def _hash_tokens(step: int, shape, vocab: int, salt: int = 0x9E3779B9) -> np.ndarray:
    """Counter-based stateless PRNG (splitmix-style) -> tokens in [0, vocab)."""
    return _hash_rows(step, shape, slice(0, shape[0]), vocab, salt)


def _hash_rows(step: int, shape, rows: slice, vocab: int, salt: int = 0x9E3779B9
               ) -> np.ndarray:
    """Rows ``rows`` of ``_hash_tokens(step, shape, vocab, salt)``, computed
    alone (the hash is per flat index)."""
    n = int(np.prod(shape))
    per_row = n // shape[0]
    lo, hi = rows.start * per_row, rows.stop * per_row
    idx = (np.arange(lo, hi, dtype=np.uint64) + np.uint64(step) * np.uint64(n + 1)
           + np.uint64(salt))
    z = (idx + np.uint64(0x9E3779B97F4A7C15))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(vocab)).astype(np.int32).reshape(rows.stop - rows.start, *shape[1:])


def make_batch_numpy(cfg: ModelConfig, step: int, batch_size: int, seq_len: int,
                     frontend_len: Optional[int] = None, rows: Optional[slice] = None
                     ) -> Dict[str, np.ndarray]:
    """One global batch on the host: int32 ``tokens`` and ``labels`` (B, S)
    and, for VLM and ENCDEC, a float32 ``frontend`` (B, S_ctx, d_model).
    ``rows``: only those rows of it, each computed alone.

    Sequences are modular arithmetic progressions with hash-random starts
    and strides: deterministic, unique per step, and learnable (a model
    that infers the stride from context beats the uniform baseline)."""
    rows = rows or slice(0, batch_size)
    starts = _hash_rows(step, (batch_size, 1), rows, cfg.vocab_size)
    strides = _hash_rows(step, (batch_size, 1), rows, 7, salt=0x51DE) + 1
    idx = np.arange(seq_len + 1, dtype=np.int64)[None, :]
    toks = ((starts.astype(np.int64) + idx * strides.astype(np.int64))
            % cfg.vocab_size).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family in (ENCDEC, VLM):
        fl = frontend_len or (cfg.n_frontend_tokens or seq_len)
        fe = (_hash_rows(step, (batch_size, fl, cfg.d_model), rows, 2048, salt=0xABCD)
              .astype(np.float32) / 1024.0 - 1.0)
        batch["frontend"] = fe.astype(np.float32)
    return batch


def local_rows(sharding, batch_size: int) -> slice:
    """This rank's rows of a global batch of ``batch_size`` placed by the
    batch ``sharding``: dim 0 split over its axes, major first."""
    ax = sharding.spec[0] if sharding.spec else None
    axes = () if ax is None else ((ax,) if isinstance(ax, str) else tuple(ax))
    mesh = sharding.mesh
    names = list(mesh.mesh_dim_names)
    if FLAT in names and axes == FLAT_AXES:
        axes = (FLAT,)
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for a in axes:
        size = mesh.shape[names.index(a)]
        idx, n = idx * size + coord[names.index(a)], n * size
    per = batch_size // n
    return slice(idx * per, (idx + 1) * per)


def make_batch(cfg: ModelConfig, step: int, batch_size: int, seq_len: int,
               frontend_len: Optional[int] = None, device="cuda",
               sharding=None) -> Dict[str, torch.Tensor]:
    """:func:`make_batch_numpy` as tensors on ``device`` (CUDA by default:
    raises where there is none). With ``sharding`` (the batch's
    ``NamedSharding``), each leaf is a DTensor of which this rank built
    only its own rows."""
    device = resolve_device(device)
    rows = None if sharding is None else local_rows(sharding, batch_size)
    host = make_batch_numpy(cfg, step, batch_size, seq_len, frontend_len, rows)
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()}
    if sharding is None:
        return out
    from torch.distributed.tensor import DTensor
    pl = sharding.placements
    return {k: DTensor.from_local(v, sharding.mesh, pl, run_check=False,
                                  shape=torch.Size((batch_size, *v.shape[1:])),
                                  stride=torch.empty((batch_size, *v.shape[1:]),
                                                     device="meta").stride())
            for k, v in out.items()}


class Prefetcher:
    """Background thread generating batches ``depth`` steps ahead."""

    def __init__(self, cfg: ModelConfig, batch_size: int, seq_len: int,
                 depth: int = 2, start_step: int = 0, device="cuda", sharding=None):
        self.cfg, self.bs, self.sl = cfg, batch_size, seq_len
        self.device = device
        self.sharding = sharding
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        s = self.step
        while not self._stop.is_set():
            try:
                b = make_batch(self.cfg, s, self.bs, self.sl, device=self.device,
                               sharding=self.sharding)
            except Exception as e:  # noqa: BLE001 - queued, raised by __next__
                b = e
            while not self._stop.is_set():
                try:
                    self.q.put((s, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(b, Exception):
                return
            s += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        s, b = self.q.get()
        if isinstance(b, Exception):
            raise b
        return s, b

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=2)

"""Async checkpoint manager: the training thread snapshots the state to
the host (``tensor_to_numpy``, a copy, before the next step updates the
parameters in place); a background thread serializes it, so the step loop
never blocks on disk. A queue of one applies back-pressure instead of
unbounded host memory. A copy of the JAX package's ``checkpoint/manager.py``.

Under a process group of several ranks every rank takes the snapshot (a
sharded state is gathered whole, a collective) and rank 0 alone writes;
:meth:`wait` ends with a barrier, so no rank reads a step before it is on
disk."""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint.checkpoint import _flatten, _unflatten, retain, save_checkpoint, to_host


class CheckpointManager:
    def __init__(self, ckpt_dir: str, every: int = 100, keep: int = 3,
                 async_mode: bool = True):
        self.ckpt_dir = ckpt_dir
        self.every = every
        self.keep = keep
        self.async_mode = async_mode
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self.saved_steps = []
        if async_mode:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def save(self, step: int, state: Dict[str, Any], meta=None, force=False):
        if not force and not self.should_save(step):
            return
        if self._err is not None:
            raise self._err
        # snapshot to the host NOW: the next step overwrites the state in place
        host = _unflatten({k: to_host(v) for k, v in _flatten(state).items()})
        if not _is_writer():
            return
        if self.async_mode:
            self._q.put((step, host, meta))  # back-pressure if one in flight
        else:
            self._write(step, host, meta)

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is not None:
                    self._write(*item)
            except BaseException as e:  # noqa: BLE001 - re-raised by save()/wait()
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step, host, meta):
        save_checkpoint(self.ckpt_dir, step, host, meta)
        self.saved_steps.append(step)
        retain(self.ckpt_dir, self.keep)

    def wait(self):
        """Block until all queued saves hit disk."""
        if self.async_mode:
            self._q.join()
        if self._err is not None:
            raise self._err
        if _group_size() > 1:
            torch.distributed.barrier()


def _group_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _is_writer() -> bool:
    return _group_size() == 1 or torch.distributed.get_rank() == 0

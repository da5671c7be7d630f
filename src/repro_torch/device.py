"""Device selection and the numpy <-> torch array bridge.

Entry points of the port take an explicit ``device`` (default ``"cuda"``)
and raise when CUDA is absent: they never drop to the CPU on their own. The
CPU is used only when a caller asks for it, as the tests do.

bfloat16 has no numpy dtype without ``ml_dtypes`` (which ships with JAX and
is not a dependency of the port), so the port holds bf16 host arrays as
``uint16`` bit patterns tagged with ``bf16.BF16_BITS`` (a ``uint16`` dtype
carrying ``{"trims": "bfloat16"}`` metadata, which numpy keeps through
views, reshapes and copies). Arrays from the JAX package whose dtype is
``ml_dtypes.bfloat16`` are recognised by name and read through the same
``uint16`` view.
"""
from __future__ import annotations

import contextlib
import threading
import warnings

import numpy as np
import torch

from repro_torch.bf16 import BF16_BITS


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and there is
    none. On CUDA, float32 matmuls and convolutions run in full float32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


class _CaptureGate:
    """Device syncs against CUDA graph captures. A device-wide sync while any
    stream of the process captures is an error, from whatever thread, and it
    breaks the capture. So a sync (:func:`synchronize`) waits while a
    capture is open, and a capture (:func:`capturing`) holds new syncs off,
    waits for those under way, and is the only one open."""

    def __init__(self):
        self.cv = threading.Condition()
        self.syncs = 0
        self.open = False


_gate = _CaptureGate()


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU); on a card,
    not while a CUDA graph capture is open (:func:`capturing`)."""
    if device.type != "cuda":
        return
    with _gate.cv:
        _gate.cv.wait_for(lambda: not _gate.open)
        _gate.syncs += 1
    try:
        torch.cuda.synchronize(device)
    finally:
        with _gate.cv:
            _gate.syncs -= 1
            _gate.cv.notify_all()


@contextlib.contextmanager
def capturing():
    """Hold the process's :func:`synchronize` calls off while the block
    captures a CUDA graph: the MRM's staging and prefetch threads and other
    requests sync the device as they go. The block itself must not sync."""
    with _gate.cv:
        _gate.cv.wait_for(lambda: not _gate.open)
        _gate.open = True
        _gate.cv.wait_for(lambda: _gate.syncs == 0)
    try:
        yield
    finally:
        with _gate.cv:
            _gate.open = False
            _gate.cv.notify_all()


def is_distributed(x) -> bool:
    """True for a ``DTensor`` (the kernels reach such a tensor's local
    shards through ``local_map``). A plain tensor answers on its type
    alone, without importing ``torch.distributed``."""
    if type(x) is torch.Tensor or not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def is_bf16(arr: np.ndarray) -> bool:
    md = arr.dtype.metadata
    return arr.dtype.name == "bfloat16" or bool(md and md.get("trims") == "bfloat16")


def as_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """bf16 host array (tagged uint16, or ``ml_dtypes.bfloat16``) as tagged
    uint16 bits."""
    return arr.view(np.uint16).view(BF16_BITS)


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """A copy of ``arr`` on ``device`` (synchronous). bf16 goes through its
    uint16 bits and comes out as ``torch.bfloat16``."""
    a = np.asarray(arr)
    bf16 = is_bf16(a)
    if bf16:
        a = a.view(np.int16)
    with warnings.catch_warnings():
        # read-only host buffers (np.frombuffer over file bytes) are fine:
        # the tensor is copied before anyone could write to it
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a)
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(device, copy=True)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy of ``t``; bf16 comes back as tagged uint16 bits."""
    c = t.detach().to("cpu", copy=True).contiguous()
    if c.dtype == torch.bfloat16:
        return c.view(torch.int16).numpy().view(BF16_BITS)
    return c.numpy()


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The host dtype that holds a tensor of ``dtype``: tagged uint16 bits
    for bf16, numpy's own dtype otherwise."""
    if dtype == torch.bfloat16:
        return BF16_BITS
    return torch.empty((), dtype=dtype).numpy().dtype


def tensor_into_numpy(t: torch.Tensor, out: np.ndarray) -> np.ndarray:
    """Copy ``t`` into the writable host array ``out`` (same shape, dtype
    ``numpy_dtype(t.dtype)``) with one copy from the tensor's device, and
    return ``out``. The copy is synchronous."""
    dst = torch.from_numpy(out.view(np.int16) if t.dtype == torch.bfloat16 else out)
    if t.dtype == torch.bfloat16:
        dst = dst.view(torch.bfloat16)
    dst.copy_(t.detach())
    return out

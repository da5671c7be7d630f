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


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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

"""Row RMSNorm: hand-written CUDA kernel (``csrc/rmsnorm.cu``) and its plain
PyTorch version.

Replaces the Pallas kernel ``src/repro/kernels/rmsnorm.py::rmsnorm``
(``_rmsnorm_kernel``). On the H100 it is bound by bytes: one read of each
row for the sum of squares, one more (from cache) for the scaled write, one
write. One warp owns one row, so the reduction needs no shared memory or
barrier, and any row count works without the Pallas wrapper's padding copy.
At decode (a few rows) a launch costs more than the bytes.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _lib

launches = 0            # kernel launches since the last reset (a plain int)
_count_lock = threading.Lock()


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,). A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    global launches
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, scale on {scale.device}")
    D = x.shape[-1]
    if scale.shape != (D,) or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} for rows of {D}")
    if x.stride(-1) != 1:
        raise ValueError("rmsnorm: the last dim of x must be contiguous")
    try:
        rows = x.view(-1, D)       # rows at one stride (e.g. x[:, -1:] of (B, S, D))
    except RuntimeError as e:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} strides {x.stride()} are not "
                         "rows at one stride") from e
    xd, sd = _lib.dtype_code(x.dtype), _lib.dtype_code(scale.dtype)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    lib = _lib.load()
    rc = lib.trims_rmsnorm(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows.shape[0], D,
                           rows.stride(0), D, float(eps), xd, sd, _lib.stream_ptr(x))
    _lib.check(rc, "trims_rmsnorm")
    with _count_lock:
        launches += 1
    return out

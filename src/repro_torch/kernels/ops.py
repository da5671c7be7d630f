"""Kernel entry points in the model's layout.

Mirrors the JAX package's ``kernels/ops.py``: models call these with
``(B, S, H, D)`` tensors. The wrappers already take that layout, so flash
attention and RMSNorm are the kernel modules' own wrappers; only decode
attention adds the ``(B, 1, Hq, D)`` form. The choice of path is made once,
in each wrapper, by the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor launches the hand-written kernel or raises. There is
no fallback and no ``use_pallas`` gate. No ``autograd.Function`` yet: the
custom VJP belongs to the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: F401

KERNEL_MODULES = (_flash, _decode, _rmsnorm)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, D) or (B, 1, Hq, D); caches: (B, T, Hkv, D)."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    out = _decode.decode_attention(q, k_cache, v_cache, kv_len)
    return out[:, None] if squeeze else out


def reset_launches() -> None:
    for m in KERNEL_MODULES:
        m.launches = 0

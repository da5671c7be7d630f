"""Kernel entry points in the model's layout, differentiable where the
training path needs them.

Mirrors the JAX package's ``kernels/ops.py``: models call these with
``(B, S, H, D)`` tensors. The choice of path is made once, in each kernel
wrapper, by the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the hand-written kernel or raises. There is no
fallback and no ``use_pallas`` gate.

Flash attention and RMSNorm are ``torch.autograd.Function``s, the
counterpart of the reference's ``custom_vjp``: the forward is the kernel
(on CUDA) or its plain version (on the CPU), and the backward recomputes
the VJP of the plain formula, as the reference's ``_flash_bwd`` takes the
VJP of ``ref.mha_reference``. Neither package has a backward kernel. The
Functions run on every device, so the CPU tests reach the same backward
that the card runs; the serving path calls them under ``inference_mode``,
where they record nothing. Decode attention is inference-only.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm

KERNEL_MODULES = (_flash, _decode, _rmsnorm)


class FlashAttentionFn(torch.autograd.Function):
    """Causal or full GQA attention, q: (B, S, Hq, D); k, v: (B, T, Hkv, D).
    Backward: the VJP of ``ref.mha_reference`` in its (B, H, S, D) layout,
    recomputed from the saved q, k, v (``_flash_bwd`` of the reference)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _flash.flash_attention(q, k, v, causal=causal)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            o = ref.mha_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), g.transpose(1, 2))
        return dq, dk, dv, None


class RmsnormFn(torch.autograd.Function):
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis. Backward:
    the VJP of that float32 formula (the reference's ``apply_norm`` and
    ``rms_head_norm``), giving the gradients of ``x`` and ``scale``."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return _rmsnorm.rmsnorm(x, scale, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, scale = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            y = ref.rmsnorm_reference(x, scale, ctx.eps)
            dx, dscale = torch.autograd.grad(y, (x, scale), g)
        return dx, dscale, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, D); k, v: (B, T, Hkv, D) -> (B, S, Hq, D). Differentiable."""
    return FlashAttentionFn.apply(q, k, v, causal)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,). Differentiable in ``x`` and ``scale``."""
    return RmsnormFn.apply(x, scale, eps)


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

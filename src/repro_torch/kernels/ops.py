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

Under a device mesh the model's tensors are ``DTensor``s. The kernels write
through ``data_ptr()`` and cannot take one, so each entry point below runs
its kernel (or, on the CPU, its plain version) on the local shards through
``local_map``, with the reference's placements: RMSNorm keeps its rows
where they are and replicates the normed axis and the scale; attention
keeps the batch on the batch axes and the query heads on the model axis,
and replicates the rest (the sequence, a KV cache's time axis). Where the
KV heads are replicated but the query heads are not, each rank picks the KV
heads of its own query heads. A weight replicated over an axis its input
is sharded on gets a partial gradient, summed by DTensor.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.device import is_distributed
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mla_decode as _mla
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm

KERNEL_MODULES = (_flash, _decode, _rmsnorm)   # the ports of the JAX package's Pallas kernels


class FlashAttentionFn(torch.autograd.Function):
    """Causal or full GQA attention, q: (B, S, Hq, D); k: (B, T, Hkv, D);
    v: (B, T, Hkv, Dv), Dv = D or, for latent attention, narrower.
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
    """q: (B, S, Hq, D); k: (B, T, Hkv, D); v: (B, T, Hkv, Dv) -> (B, S, Hq, Dv).
    Differentiable."""
    if is_distributed(q):
        return local_attention(lambda q, k, v: FlashAttentionFn.apply(q, k, v, causal),
                                q, k, v)
    return FlashAttentionFn.apply(q, k, v, causal)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,). Differentiable in ``x`` and ``scale``."""
    if is_distributed(x):
        return _local_rmsnorm(x, scale, eps)
    return RmsnormFn.apply(x, scale, eps)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, D) or (B, 1, Hq, D); caches: (B, T, Hkv, D)."""
    squeeze = q.dim() == 4
    if is_distributed(q):
        out = local_attention(_decode.decode_attention, q if squeeze else q[:, None],
                               k_cache, v_cache, kv_len, squeeze_q=True)
    else:
        out = _decode.decode_attention(q[:, 0] if squeeze else q, k_cache, v_cache, kv_len)
    return out[:, None] if squeeze else out


def mla_decode(q: torch.Tensor, c_kv: torch.Tensor, k_pe: torch.Tensor,
               kv_len: torch.Tensor, scale: float) -> torch.Tensor:
    """Latent attention of one token: q (B, H, r + rope) against the latent
    cache c_kv (B, T, 1, r), k_pe (B, T, 1, rope) -> (B, H, r).
    Inference-only; no mesh (a DTensor raises in the wrapper)."""
    return _mla.mla_decode(q, c_kv, k_pe, kv_len, scale)


# ---------------------------------------------------------------------------
# DTensor inputs: the kernels on local shards (``local_map``)
# ---------------------------------------------------------------------------

def _local_rmsnorm(x, scale, eps):
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    last = x.ndim - 1
    # rows stay where they are; the normed axis and partial sums are made whole
    x_pl = tuple(p if isinstance(p, Shard) and p.dim not in (last, -1) else Replicate()
                 for p in x.placements)
    rep = (Replicate(),) * mesh.ndim
    # rows split over a mesh dim give the scale a partial gradient there
    g_pl = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in x_pl)
    scale = _as_dtensor(scale, mesh)
    fn = local_map(lambda x, s: RmsnormFn.apply(x, s, eps), out_placements=(x_pl,),
                   in_placements=(x_pl, rep), in_grad_placements=(x_pl, g_pl),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, scale)


def _as_dtensor(t, mesh):
    """A plain tensor beside DTensors is the same on every rank: a
    replicated DTensor."""
    if is_distributed(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim, run_check=False)


def _kv_heads(a: int, h: int, group: int, k: torch.Tensor) -> torch.Tensor:
    """The KV heads (axis 2 of ``k``, all of them) that query heads
    ``a .. a+h-1`` read with ``group`` query heads a KV head."""
    if h % group == 0:
        return k[:, :, a // group:(a + h) // group]
    if group % h == 0:
        return k[:, :, a // group:a // group + 1]
    idx = (a + torch.arange(h, device=k.device)) // group
    return k[:, :, idx]


def local_attention(kernel, q, k, v, kv_len=None, squeeze_q=False):
    """``kernel`` on each rank's shards of q (B, S, Hq, D) and k, v
    (B, T, Hkv, D) [and kv_len (B,)]: the batch stays on the mesh dims
    that shard q's dim 0, the query heads on the one that shards its dim 2,
    and every other dim is replicated. K/V heads are sharded alongside the
    query heads where they divide, else replicated and picked per rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    Hq, Hkv = q.shape[2], k.shape[2]
    sizes = mesh.shape
    q_pl, kv_pl, kv_grad, b_pl = [], [], [], []
    head_dim = None
    for i, p in enumerate(q.placements):
        if isinstance(p, Shard) and p.dim == 0:
            q_pl.append(Shard(0)); kv_pl.append(Shard(0)); kv_grad.append(Shard(0))
            b_pl.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 2 and head_dim is None:
            head_dim = i
            q_pl.append(Shard(2))
            if Hkv % sizes[i] == 0:
                kv_pl.append(Shard(2)); kv_grad.append(Shard(2))
            else:   # each rank reads a part of the replicated heads
                kv_pl.append(Replicate()); kv_grad.append(Partial())
            b_pl.append(Replicate())
        else:
            q_pl.append(Replicate()); kv_pl.append(Replicate()); kv_grad.append(Replicate())
            b_pl.append(Replicate())
    pick = None
    if head_dim is not None and isinstance(kv_pl[head_dim], Replicate):
        h = Hq // sizes[head_dim]
        pick = (mesh.get_local_rank(head_dim) * h, h, Hq // Hkv)

    def local(q, k, v, *rest):
        if pick is not None:
            k, v = _kv_heads(*pick, k), _kv_heads(*pick, v)
        if squeeze_q:
            return kernel(q[:, 0], k, v, *rest)
        return kernel(q, k, v, *rest)

    q_pl, kv_pl, kv_grad = tuple(q_pl), tuple(kv_pl), tuple(kv_grad)
    out_pl = tuple(Shard(1) if isinstance(p, Shard) and p.dim == 2 and squeeze_q else p
                   for p in q_pl)
    args, in_pl, grad_pl = [q, k, v], [q_pl, kv_pl, kv_pl], [q_pl, kv_grad, kv_grad]
    if kv_len is not None:
        args.append(_as_dtensor(kv_len, mesh))
        in_pl.append(tuple(b_pl))
        grad_pl.append(tuple(b_pl))
    fn = local_map(local, out_placements=(out_pl,), in_placements=tuple(in_pl),
                   in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(*args)


def reset_launches() -> None:
    for m in (*KERNEL_MODULES, _mla):
        m.launches = 0

"""Attention forward with online softmax: hand-written CUDA kernels
(``csrc/flash_attention.cu``) and their plain PyTorch version.

Replaces the Pallas kernel ``src/repro/kernels/flash_attention.py::
flash_attention`` (``_fwd_kernel``). Same function: fp32 softmax, scale
``1/sqrt(D)``, GQA through ``h // group``, a top-left aligned causal mask
(``row >= col``), and rows with no valid key written as 0. Ragged S and T
are masked, not asserted on.

The port keeps the model's ``(B, S, H, D)`` layout here: the kernels read
q/k/v by strides, so the three ``swapaxes`` copies of the JAX wrapper are
gone. bf16, the serving path's type, runs on the tensor cores: one CUDA
block owns one (q head, batch, 128-row q tile), and the blocks are launched
longest tile first; a producer warp streams 64-key K/V tiles in by TMA into
a 3-stage ring, and two consumer warpgroups compute ``QK^T`` and ``PV``
with ``wgmma`` and the online softmax in registers. TMA reads q, k and v
through 4-D tensor maps, so their base addresses and strides must be
multiples of 16 bytes (:func:`tma_strides` checks, and the wrapper raises
where they are not). For contiguous inputs that means a head dim that is a
multiple of 8: D = 100 in bf16 raises, while float32 and the plain version
take it. Head dims below 64 or between 64 and 128 are zero-filled to the
kernel's 64 or 128. Latent attention's prefill gives q and k a head dim of
up to 192 and v one of up to 128: the kernel instantiated for 192-wide keys
and 128-wide values takes it, scaled by ``1/sqrt`` of the key width, and
the output has the value's width. With no keys (T == 0) every row is 0, and the wrapper
returns zeros without a launch. float32 takes a SIMT kernel (fp32 FMAs),
chosen by dtype: the tensor cores would read it as TF32. See the note in
the source.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import _lib

launches = 0            # kernel launches since the last reset (a plain int)
_count_lock = threading.Lock()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, D); k: (B, T, Hkv, D); v: (B, T, Hkv, Dv) -> (B, S, Hq, Dv),
    fp32 inside."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.float().reshape(B, S, Hkv, g, D)
    s = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) / math.sqrt(D)
    if causal:
        mask = torch.arange(S, device=q.device)[:, None] >= torch.arange(T, device=q.device)[None]
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)   # fully masked row -> 0
    o = torch.einsum("bhgst,bthd->bshgd", p, v.float())
    return o.reshape(B, S, Hq, v.shape[3]).to(q.dtype)


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


TMA_ALIGN = 16   # bytes: a TMA tensor map's base address and strides


def tma_strides(t: torch.Tensor, name: str = "tensor"):
    """The (batch, seq, head) strides, in elements, by which the bf16
    kernel's tensor maps read ``t`` (B, L, H, D). Raises ``ValueError``
    where TMA cannot take ``t``: a head dim that is not contiguous, or a base
    address or a stride that is not a multiple of 16 bytes. A dimension of
    size 1 is never stepped: where its stride does not suit TMA, the stride
    of a contiguous tensor of the same shape stands in for it."""
    es = t.element_size()
    if t.dim() != 4 or (t.stride(3) != 1 and t.shape[3] > 1):
        raise ValueError(f"flash_attention: {name} must be (B, L, H, D) with D contiguous")
    if t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"flash_attention: {name}'s base address is not {TMA_ALIGN}-byte aligned")
    _, L, H, D = t.shape
    contiguous = (L * H * D, H * D, D)
    out = []
    for dim in range(3):
        st = t.stride(dim)
        if t.shape[dim] == 1 and (st <= 0 or (st * es) % TMA_ALIGN):
            st = contiguous[dim]
        if st <= 0 or (st * es) % TMA_ALIGN:
            raise ValueError(f"flash_attention: {name}'s stride {st} along dim {dim} is not a "
                             f"positive multiple of {TMA_ALIGN} bytes")
        out.append(st)
    return tuple(out)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, D); k: (B, T, Hkv, D); v: (B, T, Hkv, Dv) -> (B, S, Hq, Dv),
    with Dv = D up to 128, or D up to 192 and Dv up to 128. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    global launches
    if q.device.type in ("cpu", "meta"):     # meta: shapes only (the dry run)
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}, v on {v.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    Dv = v.shape[3]
    if not (D == Dv <= 128 or (128 < D <= 192 and Dv <= 128)):
        raise ValueError(f"flash_attention: head dims {D} (q, k) and {Dv} (v) are not "
                         "supported: equal and at most 128, or at most 192 and 128")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    code = _lib.dtype_code(q.dtype)
    if code == _lib.BF16:
        if T == 0:   # no keys: every row is 0, as in the plain version
            return torch.zeros(B, S, Hq, Dv, dtype=q.dtype, device=q.device)
        ins = [tma_strides(t, n) if t.numel() else _strides(t)
               for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    else:
        ins = [_strides(t) for t in (q, k, v)]
    out = torch.empty(B, S, Hq, Dv, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*ins[0], *ins[1], *ins[2], *_strides(out))
    lib = _lib.load()
    rc = lib.trims_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   B, S, T, Hq, Hkv, D, Dv, strides, 1.0 / math.sqrt(D),
                                   int(causal), code, _lib.stream_ptr(q))
    _lib.check(rc, "trims_flash_attention")
    with _count_lock:
        launches += 1
    return out

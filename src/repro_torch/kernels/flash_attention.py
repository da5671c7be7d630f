"""Attention forward with online softmax: hand-written CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

Replaces the Pallas kernel ``src/repro/kernels/flash_attention.py::
flash_attention`` (``_fwd_kernel``). Same function: fp32 softmax, scale
``1/sqrt(D)``, GQA through ``h // group``, a top-left aligned causal mask
(``row >= col``), and rows with no valid key written as 0. Ragged S and T
are masked, not asserted on.

The port keeps the model's ``(B, S, H, D)`` layout here: the kernel reads
q/k/v by strides, so the three ``swapaxes`` copies of the JAX wrapper are
gone. One CUDA block owns one (batch, q head, 64-row q tile) and loops over
k tiles up to the diagonal. On the H100 a tensor-core version of this
function is bound by bytes at the slice's shapes; this first kernel does its
products on the fp32 FMA pipe and is bound by those operations (see the note
in the source).
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
    """q: (B, S, Hq, D); k, v: (B, T, Hkv, D) -> (B, S, Hq, D), fp32 inside."""
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
    return o.reshape(B, S, Hq, D).to(q.dtype)


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, D); k, v: (B, T, Hkv, D) -> (B, S, Hq, D). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}, v on {v.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if D > 128:
        raise ValueError(f"flash_attention: head dim {D} > 128 is not supported")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    code = _lib.dtype_code(q.dtype)
    out = torch.empty(B, S, Hq, D, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*_strides(q), *_strides(k), *_strides(v), *_strides(out))
    lib = _lib.load()
    rc = lib.trims_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   B, S, T, Hq, Hkv, D, strides, 1.0 / math.sqrt(D),
                                   int(causal), code, _lib.stream_ptr(q))
    _lib.check(rc, "trims_flash_attention")
    with _count_lock:
        launches += 1
    return out

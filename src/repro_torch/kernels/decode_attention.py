"""Single-token attention against a padded KV cache: hand-written CUDA
kernel (``csrc/decode_attention.cu``) and its plain PyTorch version.

Replaces the Pallas kernel ``src/repro/kernels/decode_attention.py::
decode_attention`` (``_decode_kernel``). Same function: keys at or past
``kv_len[b]`` are masked, the query heads of one KV head are processed
together, and ``kv_len == 0`` gives zeros (the Pallas ``l == 0`` guard). A
cache length that is not a multiple of the tile is masked, not asserted on.

The cache stays in the model's ``(B, T, Hkv, D)`` layout and is read by
strides (no per-step ``swapaxes``). One CUDA block owns one (KV head,
sequence) pair and walks the cache up to ``kv_len[b]``. On the H100 it is
bound by the bytes of the valid K/V rows; with ``B * Hkv`` blocks (64 at the
slice's shape, for 132 SMs) it cannot reach that rate, and splitting the
cache across blocks is the first item of its redesign.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import _lib

launches = 0            # kernel launches since the last reset (a plain int)
_count_lock = threading.Lock()
_SMEM_LIMIT = 227 * 1024


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, T, Hkv, D); kv_len: (B,) -> (B, Hq, D)."""
    B, Hq, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    qg = q.float().reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,bthd->bhgt", qg, k_cache.float()) / math.sqrt(D)
    valid = torch.arange(T, device=q.device)[None, :] < kv_len.to(q.device)[:, None].long()
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)   # kv_len == 0 -> 0
    o = torch.einsum("bhgt,bthd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, T, Hkv, D); kv_len: (B,) int32 -> (B, Hq, D).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_len)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k_cache, v_cache, kv_len)):
        raise ValueError("decode_attention: q, caches and kv_len must share one CUDA device")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs cache {tuple(k_cache.shape)}")
    if kv_len.shape != (B,) or kv_len.dtype != torch.int32 or not kv_len.is_contiguous():
        raise ValueError("decode_attention: kv_len must be a contiguous (B,) int32 tensor")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"decode_attention: dtypes {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if q.stride(2) != 1 or k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("decode_attention: the head dim must be contiguous")
    code = _lib.dtype_code(q.dtype)
    lib = _lib.load()
    if lib.trims_decode_smem_bytes(Hq // Hkv, D) > _SMEM_LIMIT:
        raise ValueError(f"decode_attention: group {Hq // Hkv} x head dim {D} does not fit "
                         "in shared memory")
    out = torch.empty(B, Hq, D, dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        out.stride(0), out.stride(1))
    rc = lib.trims_decode_attention(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                    kv_len.data_ptr(), out.data_ptr(), B, T, Hq, Hkv, D,
                                    strides, 1.0 / math.sqrt(D), code, _lib.stream_ptr(q))
    _lib.check(rc, "trims_decode_attention")
    with _count_lock:
        launches += 1
    return out

"""Single-token attention against a padded KV cache: hand-written CUDA
kernels (``csrc/decode_attention.cu``) and their plain PyTorch version.

Replaces the Pallas kernel ``src/repro/kernels/decode_attention.py::
decode_attention`` (``_decode_kernel``). Same function: keys at or past
``kv_len[b]`` are masked, the query heads of one KV head are served by each
cache row read, and ``kv_len == 0`` gives zeros (the Pallas ``l == 0``
guard). A cache length that is not a multiple of a tile is masked, not
asserted on.

The cache stays in the model's ``(B, T, Hkv, D)`` layout and is read by
strides (no per-step ``swapaxes``). The kernel is split-KV, in one launch:
each CUDA block takes one contiguous range of cache rows of one (KV head,
sequence), read with 16-byte loads by warps that each run their own online
softmax, and keeps its partial (m, l, acc) in shared memory; the blocks of
one (KV head, sequence) form a thread-block cluster, whose first block
merges the partials and writes the output. :func:`plan_splits` picks the
number of ranges on the host from the cache capacity ``T``, ``B``, ``Hkv``
and the SM count, never from ``kv_len``, which stays on the device (no
sync, and the call can be captured in a CUDA graph). On the H100 the
function is bound by the bytes of the valid K/V rows.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import _lib

launches = 0            # kernel launches since the last reset (a plain int)
_count_lock = threading.Lock()

CTAS_PER_SM = 3         # blocks the planner aims for on each SM
MIN_SPLIT_ROWS = 32     # a split shorter than this costs more to merge than it saves
MAX_SPLITS = 8          # the splits of one (KV head, sequence) form one cluster: at most 8
GROUP_CHUNK = 8         # query heads one block serves; larger groups take several blocks
LOAD_ALIGN = 16         # bytes: the kernel reads the cache in 16-byte vectors


def plan_splits(T: int, B: int, Hkv: int, n_sm: int, group: int = 1):
    """``(n_split, chunk)`` for a cache of capacity ``T``: split ``s`` covers
    rows ``[s * chunk, min(T, (s + 1) * chunk))``, so the splits cover
    ``[0, T)`` exactly once and none is empty. Aims at ``CTAS_PER_SM``
    blocks per SM, with no split shorter than ``MIN_SPLIT_ROWS`` rows where
    ``T`` allows and at most ``MAX_SPLITS`` splits."""
    per_split = B * Hkv * -(-group // GROUP_CHUNK)        # blocks of one split
    want = max(1, round(CTAS_PER_SM * n_sm / max(per_split, 1)))
    n_split = max(1, min(want, T // MIN_SPLIT_ROWS, MAX_SPLITS))
    chunk = max(1, -(-T // n_split))
    return max(1, -(-T // chunk)), chunk


def check_cache_layout(t: torch.Tensor, name: str = "cache") -> None:
    """Raise ``ValueError`` unless the kernel can read ``t`` (B, T, Hkv, D)
    in 16-byte vectors: D contiguous, base address and the strides of every
    dimension longer than 1 multiples of 16 bytes."""
    es = t.element_size()
    if t.dim() != 4 or (t.stride(3) != 1 and t.shape[3] > 1):
        raise ValueError(f"decode_attention: {name} must be (B, T, Hkv, D) with D contiguous")
    if t.data_ptr() % LOAD_ALIGN:
        raise ValueError(f"decode_attention: {name}'s base address is not "
                         f"{LOAD_ALIGN}-byte aligned")
    for dim in range(3):
        if t.shape[dim] > 1 and (t.stride(dim) * es) % LOAD_ALIGN:
            raise ValueError(f"decode_attention: {name}'s stride {t.stride(dim)} along dim "
                             f"{dim} is not a multiple of {LOAD_ALIGN} bytes")


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
    if D % 8 or D > 256:
        raise ValueError(f"decode_attention: head dim {D} is not a multiple of 8 up to 256")
    code = _lib.dtype_code(q.dtype)
    check_cache_layout(k_cache, "k_cache")
    check_cache_layout(v_cache, "v_cache")
    lib = _lib.load()
    n_split, chunk = plan_splits(T, B, Hkv, _lib.sm_count(q.get_device()), Hq // Hkv)
    out = torch.empty(B, Hq, D, dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        out.stride(0), out.stride(1))
    rc = lib.trims_decode_attention(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                    kv_len.data_ptr(), out.data_ptr(), B, T, Hq, Hkv, D,
                                    strides, 1.0 / math.sqrt(D), n_split, chunk, code,
                                    _lib.stream_ptr(q))
    _lib.check(rc, "trims_decode_attention")
    with _count_lock:
        launches += 1
    return out

"""Single-token latent attention (MLA's absorbed decode) against the latent
cache: a hand-written CUDA kernel (``csrc/mla_decode.cu``,
``mla_decode_kernel``) and its plain PyTorch version.

Replaces no TPU kernel: the JAX package has no latent attention. A decode
step of a DeepSeek-V3 block folds each head's key expansion into its query
(``q_lat = q_nope @ W_UK``), so every head scores ``[q_lat, q_pe]`` against
the same cached row ``[c_kv, k_pe]`` (r + rope values a position: 512 + 64
in the published models) and sums the same ``c_kv`` rows by its
probabilities. Keys at or past ``kv_len[b]`` are masked; ``kv_len == 0``
gives zeros.

Bound on the H100: bytes. The row is shared by the heads, so each valid
row is read once for all of them: 1152 B a position in bf16, against 2 x
2 x H x 128 B for the K/V of the same heads. The kernel is split-KV in one
launch, with the heads as the 16 rows of tensor-core products
(``mma.sync`` m16n8k16, bf16 in, float32 sums): see the source.
:func:`plan_splits` picks the number of ranges from the cache capacity
``T``, ``B`` and the SM count, never from ``kv_len``, which stays on the
device (no host read: the call can be captured in a CUDA graph).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _lib

launches = 0            # kernel launches since the last reset (a plain int)
_count_lock = threading.Lock()

HEADS = 16              # query heads a block serves: the rows of one mma tile
TILE = 64               # cache rows a block reads per step
MAX_SPLITS = 8          # the splits of one sequence form one cluster: at most 8
CTAS_PER_SM = 1         # a block holds ~160 KB of shared memory


def plan_splits(T: int, B: int, n_sm: int):
    """``(n_split, chunk)`` for a cache of capacity ``T``: split ``s``
    covers rows ``[s * chunk, min(T, (s + 1) * chunk))``, ``chunk`` a
    multiple of ``TILE``, no split empty; about ``CTAS_PER_SM`` blocks an SM
    over the ``B`` sequences, at most ``MAX_SPLITS``."""
    want = max(1, round(CTAS_PER_SM * n_sm / max(B, 1)))
    tiles = -(-T // TILE)
    n_split = max(1, min(want, tiles, MAX_SPLITS))
    chunk = -(-tiles // n_split) * TILE
    return max(1, -(-T // chunk)), chunk


def mla_decode_plain(q: torch.Tensor, c_kv: torch.Tensor, k_pe: torch.Tensor,
                     kv_len: torch.Tensor, scale: float) -> torch.Tensor:
    """q: (B, H, r + rope); c_kv: (B, T, 1, r); k_pe: (B, T, 1, rope);
    kv_len: (B,) -> (B, H, r), in float32 then cast to q's dtype."""
    B, H, _ = q.shape
    T = c_kv.shape[1]
    c = c_kv[:, :, 0].float()
    row = torch.cat([c, k_pe[:, :, 0].float()], dim=-1)              # (B, T, r + rope)
    s = torch.einsum("bhd,btd->bht", q.float(), row) * scale
    valid = torch.arange(T, device=q.device)[None, :] < kv_len.to(q.device)[:, None].long()
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)          # kv_len == 0 -> 0
    return torch.einsum("bht,btr->bhr", p, c).to(q.dtype)


def _check_rows(t: torch.Tensor, name: str, width: int, B: int) -> None:
    """(B, T, 1, width) with the width contiguous and 16-byte aligned rows."""
    if t.dim() != 4 or t.shape[0] != B or t.shape[2] != 1 or t.shape[3] != width:
        raise ValueError(f"mla_decode: {name} {tuple(t.shape)} is not (B, T, 1, {width})")
    es = t.element_size()
    if t.stride(3) != 1 or t.data_ptr() % 16 or (t.stride(0) * es) % 16 \
            or (t.stride(1) * es) % 16:
        raise ValueError(f"mla_decode: {name} must have contiguous 16-byte aligned rows "
                         f"(strides {t.stride()})")


def mla_decode(q: torch.Tensor, c_kv: torch.Tensor, k_pe: torch.Tensor,
               kv_len: torch.Tensor, scale: float) -> torch.Tensor:
    """q: (B, H, r + rope); c_kv: (B, T, 1, r); k_pe: (B, T, 1, rope);
    kv_len: (B,) int32 -> (B, H, r). A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    global launches
    if q.device.type in ("cpu", "meta"):
        return mla_decode_plain(q, c_kv, k_pe, kv_len, scale)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (c_kv, k_pe, kv_len)):
        raise ValueError("mla_decode: q, caches and kv_len must share one CUDA device")
    if q.dtype != torch.bfloat16 or c_kv.dtype != q.dtype or k_pe.dtype != q.dtype:
        raise TypeError(f"mla_decode: takes bfloat16, not {q.dtype}, {c_kv.dtype}, "
                        f"{k_pe.dtype}")
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError(f"mla_decode: q {tuple(q.shape)} must be a contiguous (B, H, D)")
    B, H, D = q.shape
    r, rope = c_kv.shape[-1], k_pe.shape[-1]
    if H != HEADS or r != 512 or rope != 64 or D != r + rope:
        raise ValueError(f"mla_decode: built for 16 heads, a latent of 512 and a rope part "
                         f"of 64; got q {tuple(q.shape)}, c_kv {tuple(c_kv.shape)}, "
                         f"k_pe {tuple(k_pe.shape)}")
    _check_rows(c_kv, "c_kv", r, B)
    _check_rows(k_pe, "k_pe", rope, B)
    if kv_len.shape != (B,) or kv_len.dtype != torch.int32 or not kv_len.is_contiguous():
        raise ValueError("mla_decode: kv_len must be a contiguous (B,) int32 tensor")
    T = c_kv.shape[1]
    n_split, chunk = plan_splits(T, B, _lib.sm_count(q.get_device()))
    out = torch.empty(B, H, r, dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 4)(c_kv.stride(0), c_kv.stride(1),
                                      k_pe.stride(0), k_pe.stride(1))
    rc = _lib.load().trims_mla_decode(q.data_ptr(), c_kv.data_ptr(), k_pe.data_ptr(),
                                      kv_len.data_ptr(), out.data_ptr(), B, T, strides,
                                      scale, n_split, chunk, _lib.stream_ptr(q))
    _lib.check(rc, "trims_mla_decode")
    with _count_lock:
        launches += 1
    return out


"""Row RMSNorm: hand-written CUDA kernel (``csrc/rmsnorm.cu``) and its plain
PyTorch version.

Replaces the Pallas kernel ``src/repro/kernels/rmsnorm.py::rmsnorm``
(``_rmsnorm_kernel``). On the H100 it is bound by bytes at prefill rows and
by latency at decode rows, so the kernel is built for memory in flight: a
group of threads owns a row, issues all its 16-byte loads of ``x`` and
``scale`` before any arithmetic, keeps the row in registers and writes it
once (``x`` is read from HBM once). :func:`plan_rmsnorm` chooses on the
host, from shapes, alignment and the SM count only (never from values, so
a CUDA-graph capture sees the same launch), the threads per row, the rows
per block and the vectors each thread holds; where ``D``, the row stride
or a base pointer forbids 16-byte access the kernel takes its scalar
branch. Any row count works without the Pallas wrapper's padding copy.
"""
from __future__ import annotations

import functools
import threading
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _lib

launches = 0            # kernel launches since the last reset (a plain int)
_count_lock = threading.Lock()

LOAD_BYTES = 16         # the kernel's vector: 8 bf16 or 4 fp32 elements ("chunk")
MAX_VECS = 8            # chunks one thread holds in registers
PAYLOAD = 2048          # chunks one block holds in registers (threads x chunks each)
MAX_THREADS = 1024      # threads per row (and per block) at most
BLOCK_THREADS = 256     # the block size the planner starts from
BLOCKS_PER_SM = 2       # blocks the planner aims for on each SM

_fn = None


class RmsnormPlan(NamedTuple):
    """The launch, in the order ``trims_rmsnorm`` takes it."""
    vec: bool            # the 16-byte branch (else scalar, masked element loads)
    threads: int         # threads per row: a power of two, 32..1024
    rows_per_block: int
    vecs: int            # chunks a thread holds in registers: 1, 2, 4 or 8


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def plan_rmsnorm(rows: int, D: int, itemsize: int, aligned: bool, n_sm: int) -> RmsnormPlan:
    """The launch for ``rows`` rows of ``D`` elements of ``itemsize`` bytes.
    ``aligned``: both base pointers and the row stride are multiples of 16
    bytes. Block ``b`` takes rows ``[b * rows_per_block, (b + 1) *
    rows_per_block)``; thread ``lane`` of a row holds its chunks ``lane +
    j * threads`` for ``j < vecs`` (and, for rows of more than ``PAYLOAD``
    chunks, streams those past ``vecs * threads`` through a second read).

    Many rows: the fewest threads per row that hold it in ``MAX_VECS``
    chunks each (most loads in flight per thread), ``BLOCK_THREADS`` a
    block, fewer rows per block until there are ``BLOCKS_PER_SM`` blocks an
    SM. Few rows (one per block and still short of that): each row spreads
    over more threads, up to one chunk a thread, so the whole row arrives in
    one round of loads."""
    per_vec = LOAD_BYTES // itemsize
    vec = bool(aligned) and D % per_vec == 0
    chunks = -(-D // per_vec)
    tpr = min(max(32, _pow2(-(-chunks // MAX_VECS))), PAYLOAD // MAX_VECS)
    rpb = max(1, BLOCK_THREADS // tpr)
    want = BLOCKS_PER_SM * n_sm
    while rpb > 1 and -(-rows // rpb) < want:
        rpb //= 2
    top = min(MAX_THREADS, max(32, _pow2(chunks)))
    while rpb == 1 and rows < want and tpr < top:
        tpr *= 2
    vecs = min(MAX_VECS, _pow2(-(-chunks // tpr)), PAYLOAD // (tpr * rpb))
    return RmsnormPlan(vec, tpr, rpb, vecs)


_plan = functools.lru_cache(maxsize=1024)(plan_rmsnorm)


def row_stride(shape, strides) -> Optional[int]:
    """The one stride between consecutive rows of ``x.view(-1, D)``, or None
    where ``x`` is not rows at one stride (as ``view`` decides, without
    making the view)."""
    stride = span = None
    for n, s in zip(reversed(shape[:-1]), reversed(strides[:-1])):
        if n == 1:
            continue
        if stride is None:
            stride = s
        elif s != span:
            return None
        span = s * n
    return shape[-1] if stride is None else stride


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,). A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    global launches, _fn
    if x.is_cpu or x.is_meta:       # meta: shapes only (the dry run)
        return rmsnorm_plain(x, scale, eps)
    idx = x.get_device()
    if not x.is_cuda or scale.get_device() != idx:
        raise ValueError(f"rmsnorm: x on {x.device}, scale on {scale.device}")
    shape = x.shape
    D = shape[-1]
    if scale.shape != (D,) or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} for rows of {D}")
    if x.is_contiguous():
        stride = D
    else:                      # rows at one stride (e.g. x[:, -1:] of (B, S, D)), or raise
        strides = x.stride()
        if strides[-1] != 1:
            raise ValueError("rmsnorm: the last dim of x must be contiguous")
        stride = row_stride(shape, strides)
        if stride is None:
            raise ValueError(f"rmsnorm: x {tuple(shape)} strides {strides} are not "
                             "rows at one stride")
    xd, sd = _lib.dtype_code(x.dtype), _lib.dtype_code(scale.dtype)
    out = torch.empty_like(x)  # contiguous: x is, or its rows are not dense
    n = x.numel()
    if n == 0:
        return out
    if _fn is None:
        _fn = _lib.load().trims_rmsnorm
    xp, sp, es = x.data_ptr(), scale.data_ptr(), x.element_size()
    plan = _plan(n // D, D, es, not ((xp | sp) % LOAD_BYTES or stride * es % LOAD_BYTES),
                 _lib.sm_count(idx))
    rc = _fn(xp, sp, out.data_ptr(), n // D, D, stride, eps, xd, sd, *plan, _lib.stream_ptr(x))
    _lib.check(rc, "trims_rmsnorm")
    with _count_lock:
        launches += 1
    return out

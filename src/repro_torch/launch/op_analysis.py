"""Per-chip work of a torch program: dot FLOPs, an HBM-traffic proxy and
ring-model collective bytes.

The port's counterpart of the JAX package's ``launch/hlo_analysis.py``.
There is no HLO here to parse: the reference reads a compiled, partitioned
module; this module watches the program run. :class:`OpAnalysis` is a
``TorchDispatchMode``; under a device mesh it sees each rank's local ops
(what DTensor dispatch runs on the local shards) and the
``_c10d_functional`` collectives DTensor emits, so every number is per
chip, as the reference's per-device SPMD module is. A layer loop, and the
recompute that ``torch.utils.checkpoint`` runs in the backward, are
counted each time they run: the trip counts that ``_while_trip_counts``
recovers from HLO come for free. It accumulates

  * dot FLOPs            ``torch.utils.flop_counter``'s formulas (mm, bmm,
                         addmm, baddbmm, convolutions, attention ops)
  * HBM traffic proxy    operand + result bytes of every op that is not a
                         view (views, metadata and allocation move nothing)
  * collective traffic   per-chip ring-model bytes from RESULT sizes R,
                         copied from the reference:
        all-reduce          2 * R * (n-1)/n
        all-gather          R * (n-1)/n        (result = gathered size)
        reduce-scatter      R * (n-1)          (result = shard)
        all-to-all          R * (n-1)/n
        collective-permute  R

Unlike the reference's post-fusion HLO, eager ops are not fused, so the
traffic proxy counts every elementwise intermediate a fused kernel would
keep on chip: it is an upper bound of the reference's number. It also
runs on meta tensors (shapes only), which is how the dry run uses it.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.device import is_distributed

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional (DTensor) and c10d collective op names -> reference kind
_COLL_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}

# ops that move no HBM bytes: allocation and synchronisation
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "wait_tensor", "lift_fresh", "_local_scalar_dense", "detach", "alias",
               "_to_copy_meta"}


@dataclass
class OpSummary:
    dot_flops: float
    traffic_bytes: float
    coll_bytes: Dict[str, float]
    coll_counts: Dict[str, float]
    total_coll_bytes: float

    def to_dict(self) -> dict:
        """The reference's ``HloSummary.to_dict`` keys."""
        return {"dot_flops": self.dot_flops, "traffic_bytes": self.traffic_bytes,
                "coll_bytes": dict(self.coll_bytes),
                "coll_counts": dict(self.coll_counts),
                "total_coll_bytes": self.total_coll_bytes}


def _bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


def _group_size(func, args, kwargs) -> int:
    """n of a collective: its ``group_size`` argument, or the size of the
    process group it names or holds."""
    from torch.distributed import distributed_c10d as c10d
    schema_args = func._schema.arguments
    for a, v in zip(schema_args, args):
        if a.name == "group_size":
            return int(v)
    for a, v in zip(schema_args, args):
        if a.name in ("group_name", "tag") and isinstance(v, str) and v:
            try:
                return c10d._resolve_process_group(v).size()
            except Exception:  # noqa: BLE001 - a tag, not a name
                continue
    for v in args:
        if hasattr(v, "size") and not isinstance(v, torch.Tensor) and callable(v.size):
            return int(v.size())
    return 1


class OpAnalysis(TorchDispatchMode):
    """Accumulates per-chip dot FLOPs, traffic and collective bytes of
    every op run under it (``with OpAnalysis() as oa: step(...)``; then
    ``oa.summary()``). An op on DTensors is not counted itself: the mode
    hands it to DTensor (``NotImplemented``), and the local ops and
    collectives DTensor runs for it come back here and are. The fake
    tensors of DTensor's shape propagation (the op again, at global
    shapes) are run and not counted."""

    def __init__(self):
        super().__init__()
        self.live_bytes = 0          # bytes of tensors made under the mode, still alive
        self.peak_live_bytes = 0     # their high-water mark (the dry run's temp estimate)
        self.dot_flops = 0.0
        self.traffic_bytes = 0.0
        self.coll_bytes: Dict[str, float] = defaultdict(float)
        self.coll_counts: Dict[str, float] = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves, _ = tree_flatten((args, kwargs))
        if any(is_distributed(x) for x in leaves):
            return NotImplemented       # DTensor runs it; its local ops come back here
        try:
            out = func(*args, **kwargs)
        except RuntimeError:
            # meta kernels' strides differ from the CPU's in places (a
            # backward product's transposed result); a view those strides
            # cannot take is taken as a reshape, shapes being all that
            # meta tensors carry
            if func is not torch.ops.aten.view.default or not args[0].is_meta:
                raise
            out = torch.ops.aten.reshape.default(*args, **kwargs)
        if not any(isinstance(x, FakeTensor) for x in leaves + tree_flatten(out)[0]):
            self._count(func, args, kwargs, out)    # fakes: DTensor's shape propagation
        return out

    def _count(self, func, args, kwargs, out):
        packet = func.overloadpacket
        name = packet.__name__
        kind = _COLL_KIND.get(name)
        if kind is not None and func.namespace in ("_c10d_functional", "c10d",
                                                   "_c10d_functional_autograd"):
            n = _group_size(func, args, kwargs)
            R = float(_bytes(out))
            if name.endswith("_") and func.namespace == "c10d":
                R = float(_bytes(args[0]))     # in-place c10d: the result is the buffer
            if kind == "all-reduce":
                traffic = 2.0 * R * (n - 1) / max(n, 1)
            elif kind == "all-gather":
                traffic = R * (n - 1) / max(n, 1)
            elif kind == "reduce-scatter":
                traffic = R * (n - 1)
            elif kind == "all-to-all":
                traffic = R * (n - 1) / max(n, 1)
            else:
                traffic = R
            self.coll_bytes[kind] += traffic
            self.coll_counts[kind] += 1
            self.traffic_bytes += R           # the local read/write share
            return
        if packet in flop_registry:
            self.dot_flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
        if func.is_view:
            return
        if not func._schema.is_mutable:
            self._track(out)
        if name not in _NO_TRAFFIC:
            self.traffic_bytes += _bytes(out) + _bytes((args, kwargs))

    def _track(self, out):
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                n = t.numel() * t.element_size()
                self.live_bytes += n
                self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
                weakref.finalize(t, self._free, n)

    def _free(self, n: int):
        self.live_bytes -= n

    def summary(self) -> OpSummary:
        return OpSummary(self.dot_flops, self.traffic_bytes, dict(self.coll_bytes),
                         dict(self.coll_counts), sum(self.coll_bytes.values()))


def analyze(fn, *args, **kwargs):
    """(fn's result, the :class:`OpSummary` of its run)."""
    with OpAnalysis() as oa:
        out = fn(*args, **kwargs)
    return out, oa.summary()

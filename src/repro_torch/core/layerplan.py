"""Layer-granular streaming plans over the .trims format (DESIGN.md §9).

A *layer window* is the set of file byte ranges that must be resident
before one execution step of the model can run: the stem (embedding +
final norm + header), each encoder layer, each decoder/trunk layer, and
optionally the MoE expert bank of each layer split into its own window.

Because the models stack per-layer parameters along the leading axis
(as the ``.trims`` file stores them), a single tensor ``layers/attn/wq`` of shape
(L, D, D) spans *all* layers; layer ``i`` owns the contiguous row slice
``[offset + i*stride, stride)`` with ``stride = nbytes // L``. A layer
window is therefore a union of non-contiguous ranges, one row per stacked
tensor. Ranges are gap-closed — extended to swallow the header, alignment
padding and inter-tensor gaps — so the union of all windows covers the
whole file byte-for-byte and a top-level digest still verifies after a
range-wise reassembly.

``StreamAssembler`` is the receiving half: it scatters verified shard
bytes into live per-tensor host arrays as they arrive (wire or disk) and
fires a readiness event the moment a window's last byte lands.
"""
from __future__ import annotations

import bisect
import json
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.store import MAGIC, ModelFile, TensorMeta, _align, _np_dtype

# window groups, in execution order; ``components`` filters select these
STEM, ENCODER, LAYER, EXPERT = "stem", "encoder", "layer", "expert"
GROUPS = (STEM, ENCODER, LAYER, EXPERT)

# stacked-prefix -> group of the trunk it belongs to. ``enc_layers`` runs
# before the decoder trunk; everything else unstacked lands in the stem.
_STACKED_PREFIXES = (
    ("enc_layers/", ENCODER),
    ("dec_layers/", LAYER),
    ("layers/", LAYER),
    ("blocks/", LAYER),
)
# MoE expert banks (models/moe.py): (E, d, f)-shaped per-layer tensors that
# dominate layer bytes and are only touched by routed tokens — splittable
# into on-demand windows. Router + shared-expert weights stay in the base
# layer window (every token needs them).
_EXPERT_LEAVES = frozenset({"w_gate", "w_up", "w_down"})


@dataclass(frozen=True)
class LayerWindow:
    """One readiness unit of a streaming load."""
    index: int                              # ordinal in execution order
    group: str                              # stem | encoder | layer | expert
    layer_index: int                        # -1 for the stem
    tensor_names: Tuple[str, ...]
    ranges: Tuple[Tuple[int, int], ...]     # gap-closed (offset, nbytes)

    @property
    def nbytes(self) -> int:
        return sum(n for _, n in self.ranges)


def _classify(name: str, shape: Tuple[int, ...]) -> Tuple[str, str]:
    """(group, stacked_prefix) for a flat tensor name; stem has prefix ''."""
    for prefix, group in _STACKED_PREFIXES:
        if name.startswith(prefix) and len(shape) >= 1 and shape[0] > 0:
            # expert banks are (L, E, d, f) — the extra expert axis is what
            # separates them from a dense MLP's same-named (L, d, f) weights
            if group == LAYER and name.rsplit("/", 1)[-1] in _EXPERT_LEAVES \
                    and "/ffn/" in name and len(shape) >= 4:
                return EXPERT, prefix
            return group, prefix
    return STEM, ""


def build_layer_plan(tensors: Dict[str, TensorMeta], payload_base: int,
                     file_size: Optional[int] = None) -> List[LayerWindow]:
    """Execution-ordered windows for one .trims file.

    Offsets in ``tensors`` are payload-relative (as in the header); the
    returned ranges are absolute file offsets, gap-closed to cover
    ``[0, file_size)`` exactly.
    """
    if file_size is None:
        file_size = payload_base + max(
            (t.offset + t.nbytes for t in tensors.values()), default=0)

    # group tensors; stacked groups must agree on the leading dim or the
    # dissenters fall back to the stem (correct, just coarser)
    by_group: Dict[Tuple[str, str], List[TensorMeta]] = {}
    stem: List[TensorMeta] = []
    for t in tensors.values():
        group, prefix = _classify(t.name, t.shape)
        if group == STEM:
            stem.append(t)
        else:
            by_group.setdefault((prefix, group), []).append(t)
    for gkey in list(by_group):
        ts = by_group[gkey]
        depth = ts[0].shape[0]
        if any(t.shape[0] != depth or t.nbytes % depth for t in ts):
            stem.extend(ts)
            del by_group[gkey]

    # raw atoms: (file_offset, nbytes, window_ordinal) — windows numbered in
    # execution order: stem, encoder rows, then per-layer base/expert rows
    protos: List[Tuple[str, int, List[TensorMeta]]] = [(STEM, -1, stem)]
    for prefix, order_group in (("enc_layers/", ENCODER),):
        for (pfx, group), ts in sorted(by_group.items()):
            if pfx == prefix:
                depth = ts[0].shape[0]
                for i in range(depth):
                    protos.append((group, i, ts))
    trunk = [(pfx, g) for (pfx, g) in by_group if g in (LAYER, EXPERT)]
    if trunk:
        depth = by_group[trunk[0]][0].shape[0]
        base = sorted((t for k in trunk if k[1] == LAYER
                       for t in by_group[k]), key=lambda t: t.name)
        experts = sorted((t for k in trunk if k[1] == EXPERT
                          for t in by_group[k]), key=lambda t: t.name)
        for i in range(depth):
            protos.append((LAYER, i, base))
            if experts:
                protos.append((EXPERT, i, experts))

    atoms: List[Tuple[int, int, int]] = []  # (start, nbytes, window_ordinal)
    windows: List[Tuple[str, int, Tuple[str, ...]]] = []
    for group, li, ts in protos:
        if not ts:
            continue
        widx = len(windows)
        windows.append((group, li, tuple(sorted(t.name for t in ts))))
        for t in ts:
            if group == STEM:
                atoms.append((payload_base + t.offset, t.nbytes, widx))
            else:
                stride = t.nbytes // t.shape[0]
                atoms.append(
                    (payload_base + t.offset + li * stride, stride, widx))

    # gap closure: sort by offset, stretch each atom to the next one's start
    # (first back to 0, last out to file_size) so the window union covers
    # the entire file and whole-file digests verify after reassembly
    atoms.sort()
    closed: List[List[Tuple[int, int]]] = [[] for _ in windows]
    for j, (start, n, widx) in enumerate(atoms):
        lo = 0 if j == 0 else start
        hi = atoms[j + 1][0] if j + 1 < len(atoms) else file_size
        closed[widx].append((lo, hi - lo))

    plan = []
    for widx, (group, li, names) in enumerate(windows):
        # merge adjacent ranges within a window (stem tensors are contiguous)
        merged: List[Tuple[int, int]] = []
        for off, n in sorted(closed[widx]):
            if merged and merged[-1][0] + merged[-1][1] == off:
                merged[-1] = (merged[-1][0], merged[-1][1] + n)
            else:
                merged.append((off, n))
        plan.append(LayerWindow(widx, group, li, names,
                                tuple((o, n) for o, n in merged)))
    return plan


def plan_for_file(path: str) -> Tuple[List[LayerWindow], ModelFile]:
    import os
    mf = ModelFile(path)
    return build_layer_plan(mf.tensors, mf.payload_base,
                            os.path.getsize(path)), mf


def parse_header(buf: bytes):
    """Parse a .trims header from a byte prefix.

    Returns (tensors, payload_base, meta, file_size) or None if ``buf`` is
    too short to contain the full header yet.
    """
    if len(buf) < 16:
        return None
    if buf[:8] != MAGIC:
        raise ValueError("bad .trims magic in stream")
    hlen = int.from_bytes(buf[8:16], "little")
    if len(buf) < 16 + hlen:
        return None
    header = json.loads(buf[16:16 + hlen])
    payload_base = _align(16 + hlen)
    tensors = {
        e["name"]: TensorMeta(e["name"], e["dtype"], tuple(e["shape"]),
                              e["offset"], e["nbytes"], e["crc32"])
        for e in header["tensors"]
    }
    file_size = payload_base + max(
        (t.offset + t.nbytes for t in tensors.values()), default=0)
    return tensors, payload_base, header.get("meta", {}), file_size


class StreamAssembler:
    """Scatter verified file bytes into live host tensors, window by window.

    Feeds are (absolute_offset, bytes) fragments in any order, from any
    source (wire shards, gather assembly, local disk reads). The first
    feeds are buffered until the header prefix is complete; then the plan
    is built, per-tensor buffers are allocated, buffered feeds replay, and
    each subsequent feed lands directly in the tensors it overlaps.
    ``on_window(window)`` fires exactly once per window when its last byte
    arrives; ``on_plan(plan, arrays, meta)`` fires once when the header
    parses.

    ``components`` restricts deserialization to a subset of window groups
    (e.g. ``("stem", "layer")`` skips MoE expert banks and the encoder
    half of vlm/encdec checkpoints): excluded tensors are never allocated,
    their windows are marked complete immediately, and bytes aimed at them
    are dropped on the floor.
    """

    def __init__(self, on_plan: Optional[Callable] = None,
                 on_window: Optional[Callable] = None,
                 components: Optional[Sequence[str]] = None):
        self._lock = threading.Lock()
        self._on_plan = on_plan
        self._on_window = on_window
        self.components = tuple(components) if components else None
        self._pre: List[Tuple[int, bytes]] = []   # feeds before header parse
        self.plan: Optional[List[LayerWindow]] = None
        self.arrays: Optional[Dict[str, np.ndarray]] = None
        self.meta: Dict = {}
        self.file_size = 0
        self.payload_base = 0
        self.tensor_bytes = 0                     # included tensors only
        self.scatter_s = 0.0                      # time spent copying bytes
        self._bufs: Dict[str, bytearray] = {}
        self._starts: List[int] = []              # tensor extents, sorted
        self._extents: List[Tuple[int, int, str]] = []
        self._wstarts: List[int] = []             # window atoms, sorted
        self._watoms: List[Tuple[int, int, int]] = []
        self._remaining: List[int] = []
        self._done: List[bool] = []

    # ------------------------------------------------------------ queries
    def included(self, w: LayerWindow) -> bool:
        return self.components is None or w.group in self.components

    def window_complete(self, index: int) -> bool:
        with self._lock:
            return bool(self._done) and self._done[index]

    def complete_count(self) -> int:
        with self._lock:
            return sum(self._done)

    # ------------------------------------------------------------ feeding
    def feed(self, offset: int, data: bytes) -> None:
        """Scatter one verified fragment at absolute file ``offset``."""
        fired: List[LayerWindow] = []
        with self._lock:
            if self.plan is None:
                self._pre.append((offset, bytes(data)))
                if not self._try_build_locked():
                    return
                fired = [w for w in self.plan if self._done[w.index]]
                for off, frag in self._pre:
                    fired += self._scatter_locked(off, frag)
                self._pre.clear()
            else:
                fired = self._scatter_locked(offset, data)
        for w in fired:
            if self._on_window is not None:
                self._on_window(w)

    def feed_shard(self, row: Dict, data: bytes) -> None:
        """Feed a shard-table row's payload (split across its ranges)."""
        off = 0
        for ro, rn in row_ranges(row):
            self.feed(ro, data[off:off + rn])
            off += rn

    def ensure_plan_from_file(self, mf: ModelFile,
                              file_size: Optional[int] = None) -> None:
        """Build the plan from an on-disk file (no bytes fed yet)."""
        with self._lock:
            if self.plan is not None:
                return
            import os
            if file_size is None:
                file_size = os.path.getsize(mf.path)
            self._build_locked(mf.tensors, mf.payload_base, mf.meta, file_size)
            fired = [w for w in self.plan if self._done[w.index]]
        for w in fired:
            if self._on_window is not None:
                self._on_window(w)

    # ----------------------------------------------------------- internals
    def _try_build_locked(self) -> bool:
        """Attempt a header parse from the buffered prefix feeds."""
        end = 0
        frags = sorted(self._pre)
        buf = bytearray()
        for off, data in frags:
            if off > end:
                break
            take = data[end - off:] if off < end else data
            buf += take
            end = max(end, off + len(data))
        parsed = parse_header(bytes(buf)) if buf else None
        if parsed is None:
            return False
        tensors, payload_base, meta, file_size = parsed
        self._build_locked(tensors, payload_base, meta, file_size)
        return True

    def _build_locked(self, tensors, payload_base, meta, file_size) -> None:
        self.plan = build_layer_plan(tensors, payload_base, file_size)
        self.meta = meta or {}
        self.payload_base = payload_base
        self.file_size = file_size
        included_names = set()
        for w in self.plan:
            if self.included(w):
                included_names.update(w.tensor_names)
        self.arrays = {}
        for name in sorted(included_names):
            t = tensors[name]
            buf = bytearray(t.nbytes)
            self._bufs[name] = buf
            count = int(np.prod(t.shape)) if t.shape else 1
            self.arrays[name] = np.frombuffer(
                buf, dtype=_np_dtype(t.dtype), count=count).reshape(t.shape)
            self._extents.append(
                (payload_base + t.offset, payload_base + t.offset + t.nbytes,
                 name))
            self.tensor_bytes += t.nbytes
        self._extents.sort()
        self._starts = [e[0] for e in self._extents]
        self._watoms = sorted(
            (off, off + n, w.index) for w in self.plan for off, n in w.ranges)
        self._wstarts = [a[0] for a in self._watoms]
        self._remaining = [w.nbytes for w in self.plan]
        self._done = [False] * len(self.plan)
        for w in self.plan:          # excluded windows are born complete
            if not self.included(w):
                self._done[w.index] = True
        if self._on_plan is not None:
            self._on_plan(self.plan, self.arrays, self.meta)

    def _scatter_locked(self, offset: int, data: bytes
                        ) -> List[LayerWindow]:
        t0 = time.perf_counter()
        end = offset + len(data)
        mv = memoryview(data)
        # copy overlapping slices into tensor buffers
        i = bisect.bisect_right(self._starts, offset) - 1
        if i < 0:
            i = 0
        while i < len(self._extents) and self._extents[i][0] < end:
            ts, te, name = self._extents[i]
            lo, hi = max(ts, offset), min(te, end)
            if lo < hi:
                self._bufs[name][lo - ts:hi - ts] = mv[lo - offset:hi - offset]
            i += 1
        # account window coverage; duplicate feeds (a full-fetch fallback
        # re-delivering already-fed shards) push ``remaining`` negative,
        # which is harmless — completion still requires every byte at
        # least once on any path that terminates successfully
        fired = []
        j = bisect.bisect_right(self._wstarts, offset) - 1
        if j < 0:
            j = 0
        while j < len(self._watoms) and self._watoms[j][0] < end:
            ws, we, widx = self._watoms[j]
            got = min(we, end) - max(ws, offset)
            if got > 0 and not self._done[widx]:
                self._remaining[widx] -= got
                if self._remaining[widx] <= 0:
                    self._done[widx] = True
                    fired.append(self.plan[widx])
            j += 1
        self.scatter_s += time.perf_counter() - t0
        return fired


def row_ranges(row: Dict) -> List[Tuple[int, int]]:
    """Absolute byte ranges of one shard-table row (layer-planned rows
    carry explicit ``ranges``; classic fixed-size rows derive one from
    their offset)."""
    r = row.get("ranges")
    if r:
        return [(int(a), int(b)) for a, b in r]
    return [(int(row["offset"]), int(row["nbytes"]))]

"""Spans of the port's layers, kept in memory, on the clock and thread ids
of the CUDA profiler's trace.

A span is a named interval of one host thread::

    with trace.span("engine.decode_step", batch=B):
        ...

Each finished span is one record, a plain tuple::

    (name, start_ns, end_ns, thread_id, span_id, parent_id, request_id, attrs)

- ``start_ns``/``end_ns`` come from ``time.time_ns()``, the clock on which
  ``torch.profiler`` stamps the CUDA runtime calls;
- ``thread_id`` is the id the profiler gives the runtime calls made by the
  same thread (``device_resource_id()`` of its events: the low 32 bits of
  ``pthread_self()``, signed), so a kernel can be traced through its
  launch's correlation id to the span that launched it;
- ``parent_id`` is the innermost span open on the same thread when the span
  opened, 0 for none;
- ``request_id`` is shared by every span of one request on its thread
  (:func:`request`), 0 outside a request;
- ``attrs`` holds counts taken at the same boundary (``bytes``, ``batch``).

The recorder is off until :func:`enable`. Off, :func:`span` and
:func:`request` return one shared no-op object and take no timestamp.
:func:`drain` returns the finished records and clears them; nothing is
written anywhere else. :func:`summarize` gives each name's count, seconds
and self seconds.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Tuple

Record = Tuple[str, int, int, int, int, int, int, dict]


class _NoSpan:
    """What :func:`span` and :func:`request` return while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


def _profiler_thread_id() -> int:
    t = threading.get_ident() & 0xFFFFFFFF
    return t - (1 << 32) if t >= 1 << 31 else t


class _Span:
    __slots__ = ("rec", "name", "attrs", "start_ns", "sid", "parent")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def set(self, **attrs) -> None:
        """Add attributes known only once the span's work has run."""
        self.attrs.update(attrs)

    def __enter__(self):
        local = self.rec._thread()
        stack = local.stack
        self.parent = stack[-1] if stack else 0
        self.sid = next(self.rec._ids)
        stack.append(self.sid)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        local = self.rec._thread()
        local.stack.pop()
        if self.rec.on:
            self.rec._records.append((self.name, self.start_ns, end, local.tid, self.sid,
                                      self.parent, local.rid, self.attrs))
        return False


class _Request:
    """Gives the thread a request id for its duration, unless it has one."""
    __slots__ = ("rec", "opened")

    def __init__(self, rec: "Recorder"):
        self.rec = rec

    def __enter__(self):
        local = self.rec._thread()
        self.opened = local.rid == 0
        if self.opened:
            local.rid = next(self.rec._ids)
        return self

    def __exit__(self, *exc):
        if self.opened:
            self.rec._thread().rid = 0
        return False


class Recorder:
    """One process's spans. The module's functions use one shared instance."""

    def __init__(self):
        self.on = False
        self._records: List[Record] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def _thread(self):
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.rid, local.tid = [], 0, _profiler_thread_id()
        return local

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        """Stop recording; spans still open then are dropped when they close."""
        self.on = False

    def drain(self) -> List[Record]:
        """The records finished so far, in the order they finished; clears them."""
        with self._lock:
            out, self._records = self._records, []
        return out

    def span(self, name: str, **attrs):
        return _Span(self, name, attrs) if self.on else NO_SPAN

    def request(self):
        return _Request(self) if self.on else NO_SPAN

    def record(self, name: str, start_ns: int, end_ns: int, **attrs) -> None:
        """A span timed elsewhere, such as one that started on another
        thread; its parent and request are those of the calling thread."""
        if not self.on:
            return
        local = self._thread()
        self._records.append((name, start_ns, end_ns, local.tid, next(self._ids),
                              local.stack[-1] if local.stack else 0, local.rid, attrs))


_RECORDER = Recorder()
enable = _RECORDER.enable
disable = _RECORDER.disable
drain = _RECORDER.drain
span = _RECORDER.span
request = _RECORDER.request
record = _RECORDER.record


def enabled() -> bool:
    return _RECORDER.on


def summarize(records: List[Record]) -> Dict[str, Tuple[int, float, float]]:
    """Per span name: (count, seconds, self seconds). A span's self time is
    its length less the part of it that its children cover."""
    children: Dict[int, List[Tuple[int, int]]] = {}
    for r in records:
        if r[5]:
            children.setdefault(r[5], []).append((r[1], r[2]))
    out: Dict[str, List] = {}
    for name, s, e, _, sid, _, _, _ in records:
        covered, reach = 0, s
        for cs, ce in sorted(children.get(sid, ())):
            cs, ce = max(cs, reach), min(ce, e)
            if ce > cs:
                covered += ce - cs
                reach = ce
        row = out.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (e - s) / 1e9
        row[2] += (e - s - covered) / 1e9
    return {n: (c, t, st) for n, (c, t, st) in out.items()}

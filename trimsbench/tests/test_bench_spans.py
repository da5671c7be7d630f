"""The join of spans to the device trace (``spans.py``) on synthetic events,
and ``devtrace.summarize`` pinned on the same events.

Times are in milliseconds below (``M`` ns each). Thread A serves a request
with two decode steps, each with a dispatch and an expert span; thread B
stages a model (``mrm.stage`` inside ``engine.load``) whose copies thread C
launches; a queued request waits on thread A while A still works.
"""
from __future__ import annotations

import pytest

from trimsbench import devtrace, spans

M = 1_000_000
A, B, C = 11, -22, 33


def _span(name, s, e, tid, sid, parent, rid, **attrs):
    return (name, s * M, e * M, tid, sid, parent, rid, attrs)


SPANS = [
    _span("engine.load", 1, 5, A, 12, 1, 5, tier="device"),
    _span("moe.dispatch", 22, 26, A, 3, 2, 5),
    _span("moe.experts", 26, 34, A, 4, 2, 5),
    _span("engine.decode_step", 20, 40, A, 2, 1, 5, batch=32),
    _span("moe.dispatch", 42, 45, A, 6, 5, 5),
    _span("moe.experts", 45, 55, A, 7, 5, 5),
    _span("engine.decode_step", 40, 60, A, 5, 1, 5, batch=32),
    _span("mrm.stage", 65, 91, B, 11, 10, 6, bytes=1000),
    _span("engine.load", 60, 95, B, 10, 0, 6, tier="host"),
    _span("engine.request", 0, 100, A, 1, 0, 5),
    _span("workers.queue", 90, 130, A, 8, 0, 9),
]


def _call(name, s, tid, corr, e=None):
    return (name, int(s * M), int((s + 0.5 if e is None else e) * M), tid, corr)


RUNTIME = [
    _call("cudaLaunchKernel", 2, A, 12),
    _call("cudaLaunchKernel", 23, A, 1),
    _call("cudaLaunchKernel", 24, A, 2),
    _call("cudaLaunchKernel", 27, A, 3),
    _call("cudaMemcpyAsync", 35, A, 4),
    _call("cudaStreamSynchronize", 36, A, 5, e=43.5),
    _call("cudaLaunchKernel", 43, A, 6),
    _call("cudaLaunchKernel", 46, A, 7),
    _call("cudaMemcpyAsync", 70, C, 8),          # no span on C: the open mrm.stage's
    _call("cudaLaunchKernel", 92, A, 10),        # the request's, not the queued one's
    _call("cudaMemcpyAsync", 97, C, 9),          # no span open anywhere fits
    _call("cudaLaunchKernel", 110, A, 11),
]
DEVICE = [
    ("moe_dispatch_a", 24 * M, 25 * M, 1),
    ("moe_dispatch_b", 25 * M, 26 * M, 2),
    ("expert_gemm", 28 * M, 33 * M, 3),
    ("Memcpy HtoD (Pageable)", 35 * M, 36 * M, 4),
    ("moe_dispatch_a", 44 * M, 45 * M, 6),
    ("expert_gemm", 47 * M, 53 * M, 7),
    ("Memcpy HtoD (Pageable)", 70 * M, 88 * M, 8),
    ("Memcpy DtoH (Pageable)", 97 * M, 99 * M, 9),
    ("head_gemm", 92 * M, 96 * M, 10),
    ("head_gemm", 111 * M, 125 * M, 11),         # clipped at the window's end
    ("embed", 2 * M, 4 * M, 12),
    ("warm_up", -5 * M, 1 * M, 99),              # no runtime call in the trace
]
T0, T1 = 0, 120 * M


@pytest.fixture(scope="module")
def joined():
    return spans.join(SPANS, RUNTIME, DEVICE, T0, T1)


def _by_sid(joined, values):
    return {r[spans.SID]: float(v) for r, v in zip(joined.spans, values)}


def test_kernels_belong_to_the_innermost_span_of_their_launching_thread(joined):
    dev = _by_sid(joined, joined.device_s)
    want = {3: 2, 4: 5, 2: 1, 6: 1, 7: 6, 11: 18, 1: 4, 12: 2, 5: 0, 10: 0, 8: 0}
    assert dev == pytest.approx({k: v / 1e3 for k, v in want.items()})
    assert joined.no_span["device_s"] == pytest.approx((2 + 9 + 1) / 1e3)
    launches = _by_sid(joined, joined.launches)
    assert launches == {3: 2, 4: 1, 2: 1, 6: 1, 7: 1, 11: 1, 1: 1, 12: 1, 5: 0, 10: 0, 8: 0}
    assert joined.no_span["launches"] == 2      # the synchronise is not a launch


def test_idle_gaps_belong_to_the_latest_started_open_span(joined):
    idle = _by_sid(joined, joined.idle_s)
    want = {12: 1, 1: 20 + 1, 4: 2, 2: 2, 5: 8, 7: 2, 10: 17, 11: 4, 3: 0, 6: 0, 8: 0}
    assert idle == pytest.approx({k: v / 1e3 for k, v in want.items()})
    assert joined.no_span["idle_s"] == pytest.approx(12 / 1e3)
    assert sum(idle.values()) + joined.no_span["idle_s"] == pytest.approx(0.069)


def test_summary_per_name(joined):
    got = joined.summary()
    assert list(got)[-1] == spans.NO_SPAN
    req = got["engine.request"]
    assert req["count"] == 1 and req["host_s"] == pytest.approx(0.1)
    assert req["self_s"] == pytest.approx(0.1 - 0.004 - 0.040)
    step = got["engine.decode_step"]
    assert step["count"] == 2 and step["host_s"] == pytest.approx(0.040)
    assert step["self_s"] == pytest.approx(0.040 - 0.012 - 0.013)
    assert step["device_s"] == pytest.approx(0.001) and step["launches"] == 1
    assert step["idle_s"] == pytest.approx(0.010)
    assert got["mrm.stage"] == pytest.approx(dict(count=1, host_s=0.026, self_s=0.026,
                                                  device_s=0.018, launches=1, idle_s=0.004))
    assert got["workers.queue"]["device_s"] == got["workers.queue"]["idle_s"] == 0
    total_dev = sum(r["device_s"] for r in got.values())
    assert total_dev == pytest.approx(0.051)    # every busy second has one owner


def test_metrics(joined):
    want = {
        "workers.queue_wait_s.serve": 0.040,
        "engine.load_s.serve": 0.004,           # device hits only
        "mrm.stage_s.swap": 0.026,
        "mrm.stage_idle_s.swap": 0.004,
        "engine.step_host_s.decode": 0.020,
        "engine.launches_per_step.decode": (4 + 2) / 2,   # nested spans' launches count
        "moe.dispatch_device_s.decode": 0.003 / 2,
        "moe.experts_device_s.decode": 0.011 / 2,
    }
    got = {name: fn(joined) for name, fn in spans.METRICS.items()}
    assert got == pytest.approx(want)


def test_no_spans_read_as_none():
    empty = spans.join([], RUNTIME, DEVICE, T0, T1)
    assert all(fn(empty) is None for fn in spans.METRICS.values())
    assert empty.no_span["device_s"] == pytest.approx(0.051)
    assert empty.summary() == {spans.NO_SPAN: empty.no_span}


def test_devtrace_summary_is_unchanged_on_the_same_events():
    s = devtrace.summarize([d[:3] for d in DEVICE], [c[:3] for c in RUNTIME], T0, T1,
                           [(0, 100 * M), (106 * M, 120 * M)])
    assert s.window_s == pytest.approx(0.12) and s.busy_s == pytest.approx(0.051)
    assert s.kernels == pytest.approx({
        "moe_dispatch_a": (2, 0.002), "moe_dispatch_b": (1, 0.001), "expert_gemm": (2, 0.011),
        "Memcpy HtoD (Pageable)": (2, 0.019), "Memcpy DtoH (Pageable)": (1, 0.002),
        "head_gemm": (2, 0.013), "embed": (1, 0.002), "warm_up": (1, 0.001)})
    assert [n for n, _ in s.device_ops] == [
        "Memcpy HtoD (Pageable)", "head_gemm", "expert_gemm", "moe_dispatch_a",
        "Memcpy DtoH (Pageable)", "embed", "moe_dispatch_b", "warm_up"]
    assert s.idle_gaps == [
        ("host_between_calls", pytest.approx(0.020)), ("host_between_calls", pytest.approx(0.017)),
        ("no_request_in_flight", pytest.approx(0.012)),
        ("cudaStreamSynchronize", pytest.approx(0.008)),
        ("host_between_calls", pytest.approx(0.004)), ("cudaLaunchKernel", pytest.approx(0.002)),
        ("host_between_calls", pytest.approx(0.002)), ("cudaLaunchKernel", pytest.approx(0.002)),
        ("host_between_calls", pytest.approx(0.001)), ("host_between_calls", pytest.approx(0.001))]


@pytest.mark.cuda
def test_events_of_a_card_trace_join_their_spans(cuda_device):
    """On the card: ``events`` reads a real profiler trace, and the join
    gives each span the kernel its thread launched inside it."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import trace

    torch.cuda._sleep(1000)
    torch.cuda.synchronize(cuda_device)
    rec = trace.Recorder()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    rec.enable()
    t0 = time.time_ns()
    with rec.span("outer"):
        torch.ones(1 << 20, device=cuda_device)
        with rec.span("inner"):
            torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize(cuda_device)
    t1 = time.time_ns()
    rec.disable()
    prof.stop()
    runtime, device = spans.events(prof)
    got = spans.join(rec.drain(), runtime, device, t0, t1).summary()
    assert got["inner"]["launches"] == 1 and got["inner"]["device_s"] > 5e-4
    assert got["outer"]["launches"] == 1 and got["outer"]["device_s"] > 0
    assert got[spans.NO_SPAN]["device_s"] == 0 and got[spans.NO_SPAN]["launches"] == 0

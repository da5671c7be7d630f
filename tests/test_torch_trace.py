"""The port's span recorder (``runtime/trace.py``) and the spans the
serving path records, on the CPU.

The recorder alone: off it records nothing, nesting and threads give the
right parents, requests share one id, self time is the span less its
children. Then a reduced qwen3-moe (capacity dispatch, as the benchmark's
decode cell serves it) through ``ServingWorkers``: one set of request spans
per request, one decode-step span per decode step, one dispatch and one
expert span per MoE layer of every forward, a staging span with the model's
bytes on a host hit, and the same tokens with spans on and off.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import costmodel
from repro_torch.core.mrm import MRM
from repro_torch.core.store import DiskStore
from repro_torch.models import model as M
from repro_torch.runtime import trace
from repro_torch.serving.engine import InferenceEngine, Request, ServingWorkers, publish_model

NAME, START, END, TID, SID, PARENT, RID, ATTRS = range(8)


@pytest.fixture
def rec():
    return trace.Recorder()


@pytest.fixture
def spans_on():
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.drain()


def test_off_records_nothing_and_returns_the_shared_no_op(rec):
    assert not rec.on and not trace.enabled()
    assert rec.span("a", bytes=1) is trace.NO_SPAN
    assert rec.request() is trace.NO_SPAN
    assert trace.span("a") is trace.NO_SPAN and trace.request() is trace.NO_SPAN
    with rec.request(), rec.span("a") as sp:
        sp.set(tier="device")
        rec.record("b", 1, 2)
    assert rec.drain() == []


def test_nesting_gives_parent_ids_and_attrs(rec):
    rec.enable()
    with rec.span("outer", batch=4) as outer:
        with rec.span("inner") as inner:
            pass
        with rec.span("inner2") as sp:
            sp.set(tier="host")
    with rec.span("after"):
        pass
    got = {r[NAME]: r for r in rec.drain()}
    assert [n for n in got] == ["inner", "inner2", "outer", "after"]
    assert got["outer"][PARENT] == 0 and got["after"][PARENT] == 0
    assert got["inner"][PARENT] == got["inner2"][PARENT] == outer.sid == got["outer"][SID]
    assert got["inner"][SID] == inner.sid
    assert got["outer"][ATTRS] == {"batch": 4} and got["inner2"][ATTRS] == {"tier": "host"}
    for r in got.values():
        assert r[START] <= r[END]
        assert r[TID] == trace._profiler_thread_id()
    assert got["outer"][START] <= got["inner"][START] <= got["inner2"][END] <= got["outer"][END]
    assert rec.drain() == []


def test_profiler_thread_id_is_the_signed_low_word_of_the_thread_ident():
    tid = trace._profiler_thread_id()
    assert -2 ** 31 <= tid < 2 ** 31
    assert tid & 0xFFFFFFFF == threading.get_ident() & 0xFFFFFFFF


def test_request_ids_are_shared_within_a_request_and_not_across(rec):
    rec.enable()
    with rec.span("outside"):
        pass
    with rec.request():
        with rec.request(), rec.span("a"):      # an inner request keeps the outer id
            rec.record("q", 1, 2)
        with rec.span("b"):
            pass
    with rec.request(), rec.span("c"):
        pass
    got = {r[NAME]: r for r in rec.drain()}
    assert got["outside"][RID] == 0
    assert got["a"][RID] == got["b"][RID] == got["q"][RID] != 0
    assert got["c"][RID] not in (0, got["a"][RID])
    assert got["q"][PARENT] == got["a"][SID]


def test_per_thread_stacks_stay_apart(rec):
    rec.enable()
    barrier = threading.Barrier(2, timeout=10)

    def work(tag):
        with rec.request(), rec.span(f"outer{tag}"):
            barrier.wait()                      # both outer spans open at once
            with rec.span(f"inner{tag}"):
                barrier.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    got = {r[NAME]: r for r in rec.drain()}
    assert len(got) == 4
    for t in "ab":
        assert got[f"inner{t}"][PARENT] == got[f"outer{t}"][SID]
        assert got[f"outer{t}"][PARENT] == 0
        assert got[f"inner{t}"][TID] == got[f"outer{t}"][TID]
        assert got[f"inner{t}"][RID] == got[f"outer{t}"][RID] != 0
    assert got["outera"][TID] != got["outerb"][TID]
    assert got["outera"][RID] != got["outerb"][RID]


def test_record_works_across_threads(rec):
    rec.enable()
    start = {}

    def submit():
        start["ns"] = time.time_ns()

    th = threading.Thread(target=submit)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    with rec.request(), rec.span("worker") as sp:
        rec.record("queue", start["ns"], time.time_ns(), depth=1)
    got = {r[NAME]: r for r in rec.drain()}
    q = got["queue"]
    assert q[START] == start["ns"] <= q[END]
    assert q[TID] == trace._profiler_thread_id()       # the thread that recorded it
    assert q[PARENT] == sp.sid and q[RID] == got["worker"][RID] != 0
    assert q[ATTRS] == {"depth": 1}


def test_self_time_is_the_span_less_its_children():
    ms = 1_000_000
    records = [
        ("p", 0, 100 * ms, 1, 1, 0, 7, {}),
        ("c", 10 * ms, 30 * ms, 1, 2, 1, 7, {}),
        ("c", 20 * ms, 50 * ms, 2, 3, 1, 7, {}),       # overlaps the first child
        ("c", 90 * ms, 120 * ms, 2, 4, 1, 7, {}),      # ends after the parent
        ("g", 12 * ms, 14 * ms, 1, 5, 2, 7, {}),       # a grandchild: not the parent's
    ]
    got = trace.summarize(records)
    assert got["p"][0] == 1 and got["p"][1] == pytest.approx(0.1)
    assert got["p"][2] == pytest.approx(0.1 - 0.040 - 0.010)
    assert got["c"][0] == 3 and got["c"][1] == pytest.approx(0.08)
    assert got["c"][2] == pytest.approx(0.08 - 0.002)
    assert got["g"] == (1, pytest.approx(0.002), pytest.approx(0.002))


def test_recorded_self_times_add_up(rec):
    rec.enable()
    with rec.span("p"):
        time.sleep(0.002)
        with rec.span("c"):
            time.sleep(0.002)
    got = trace.summarize(rec.drain())
    assert got["p"][2] + got["c"][1] == pytest.approx(got["p"][1], abs=1e-9)
    assert got["p"][2] >= 0.002 and got["c"][2] == got["c"][1]


# ------------------------------------------------------ the serving path

NEW = 4


@pytest.fixture(scope="module")
def moe_store(tmp_path_factory):
    """Two reduced qwen3-moe tenants (float32, capacity dispatch) and the
    bytes one of them holds."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced().replace(
        param_dtype="float32", compute_dtype="float32", moe_impl="capacity")
    root = str(tmp_path_factory.mktemp("trace_store"))
    disk = DiskStore(root)
    for i in range(2):
        g = torch.Generator().manual_seed(i)
        publish_model(disk, cfg, M.init_params(cfg, g, device="cpu"), name=f"m{i}")
    nbytes = disk.open(next(iter(disk.keys()))).total_bytes
    return root, cfg, nbytes


def _serve(root, nbytes, order):
    """A fresh MRM whose device tier holds one tenant, an engine and one
    worker; the requests of ``order`` are served one after another."""
    mrm = MRM(DiskStore(root), device_capacity=nbytes * 3 // 2, hw=costmodel.HardwareModel(),
              device="cpu")
    eng = InferenceEngine(DiskStore(root), mrm, device="cpu")
    workers = ServingWorkers(eng, n_workers=1)
    toks = np.random.default_rng(0).integers(0, 200, (2, 8)).astype(np.int32)
    out = []
    try:
        for name in order:
            req = workers.submit(Request(model=name, tokens=toks, max_new=NEW))
            assert req.done.wait(120)
            assert not isinstance(req.result, Exception), req.result
            out.append(req)
    finally:
        workers.stop()
        mrm.shutdown()
    return out


ORDER = ["m0", "m1", "m0", "m0"]          # disk, disk, host (m0 was demoted), device


def test_serving_spans_per_request(moe_store, spans_on):
    root, cfg, nbytes = moe_store
    reqs = _serve(root, nbytes, ORDER)
    trace.disable()
    records = trace.drain()
    assert [r.stats.tier_hit for r in reqs] == ["disk", "disk", "host", "device"]
    by_rid = {}
    for r in records:
        by_rid.setdefault(r[RID], []).append(r)
    assert 0 not in by_rid                  # every span belongs to a request
    requests = sorted((r for r in records if r[NAME] == "engine.request"),
                      key=lambda r: r[START])
    assert len(requests) == len(reqs) == len(by_rid)
    for req, top in zip(reqs, requests):
        mine = by_rid[top[RID]]
        names = [r[NAME] for r in mine]
        for n in ("workers.queue", "engine.request", "engine.load"):
            assert names.count(n) == 1, (n, names)
        spans = {r[NAME]: r for r in mine}
        assert spans["engine.request"][PARENT] == 0 and spans["workers.queue"][PARENT] == 0
        assert spans["engine.load"][PARENT] == top[SID]
        assert spans["engine.load"][ATTRS] == {"tier": req.stats.tier_hit}
        assert spans["workers.queue"][END] <= top[START]
        host_s = (top[END] - top[START]) / 1e9
        assert abs(host_s - req.stats.total_s) < 1e-3

        steps = [r for r in mine if r[NAME] == "engine.decode_step"]
        assert len(steps) == NEW - 1
        assert all(s[PARENT] == top[SID] and s[ATTRS] == {"batch": 2, "graph": False}
                   for s in steps)
        # one dispatch and one expert product per MoE layer of every forward:
        # the prefill's and each decode step's
        step_ids = {s[SID] for s in steps}
        for n in ("moe.dispatch", "moe.experts"):
            layer = [r for r in mine if r[NAME] == n]
            assert len(layer) == cfg.n_layers * NEW
            under = [r for r in layer if r[PARENT] in step_ids]
            assert len(under) == cfg.n_layers * (NEW - 1)
            assert all(r[PARENT] == top[SID] for r in layer if r not in under)
        assert all(r[ATTRS] == {"rows": 2 * 8} for r in mine
                   if r[NAME] == "moe.dispatch" and r[PARENT] == top[SID])

        stage = [r for r in mine if r[NAME] == "mrm.stage"]
        if req.stats.tier_hit == "host":
            assert len(stage) == 1
            assert stage[0][ATTRS] == {"bytes": nbytes}
            assert stage[0][PARENT] == spans["engine.load"][SID]
        else:
            assert stage == []
    assert len({r[SID] for r in records}) == len(records)


def test_tokens_equal_with_spans_on_and_off(moe_store):
    root, _, nbytes = moe_store
    trace.drain()
    off = _serve(root, nbytes, ORDER)
    assert trace.drain() == []              # off, the serving path records nothing
    trace.enable()
    try:
        on = _serve(root, nbytes, ORDER)
    finally:
        trace.disable()
        assert trace.drain()
    for a, b in zip(off, on):
        assert a.stats.tier_hit == b.stats.tier_hit
        np.testing.assert_array_equal(a.result, b.result)

"""The port's placement planner against the JAX package's: the same arrival
traces give the same detected patterns and the same actions (``kind``,
``key``, ``nodes``, ``at_s``) and metrics, including the membership
rebalance over a real cluster; ``apply`` on a port cluster prepositions
and replicates as the reference's does, with batch-class admission, and
the scatter and predictor regressions hold on the port."""
import dataclasses
import random
import time

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as P
from repro_torch.core import (Cluster, DiskStore, HardwareModel, MRM, ModelKey,
                              NextUsePredictor, ObjectStore, PLANNER_TENANT,
                              PlacementAction, PlacementPlanner, PlannerConfig,
                              RequestContext, TenantRegistry, planner_ctx)

MB = 1 << 20
SHARD = 256 << 10


def _cfg(m):
    return m.PlannerConfig(bin_s=1.0, min_bursts=3, min_arrivals=4, lead_s=1.0)


def _tensors(nbytes=2 * MB, n=8, seed=0):
    rng = np.random.default_rng(seed)
    per = nbytes // n // 4
    return {f"w{i}": rng.standard_normal(per).astype(np.float32) for i in range(n)}


# ------------------------------------------------------------ the traces
# each is a list of (key name, node, time, kind) events

def _periodic(name="m", node="node0", period=5.0, n=6, t0=0.25):
    return [(name, node, t0 + i * period, "open") for i in range(n)]


def _sparse_duty():
    return [("m", "node3", i * 10.0 + dt, "open") for i in range(4) for dt in (0.1, 2.1)]


def _background():
    spikes = [("m", f"node{i % 2}", i * 6.0 + 0.1, "open") for i in range(5) for _ in range(8)]
    return spikes + [("m", None, t + 0.5, "open") for t in range(30)]


def _noise(seed=3, n=300):
    rng = random.Random(seed)
    return [(f"m{rng.randrange(8)}", f"node{rng.randrange(4)}", rng.uniform(0.0, 30.0), "open")
            for _ in range(n)]


def _irregular():
    return [("m", None, t, "open") for t in (0.5, 4.5, 14.5, 17.5, 30.5)]


def _with_gathers():
    return _periodic() + [("m", "node2", 25.3, "gather")] * 3


def _two_keys():
    return (_periodic("a", "node1", 5.0, 6) + _periodic("b", "node2", 4.0, 8, t0=0.6)
            + _periodic("b", "node3", 4.0, 4, t0=0.7))


TRACES = {"periodic": (_periodic, (26.0, 29.5, 29.6, 34.5)),
          "periodic_node1": (lambda: _periodic(node="node1"), (29.5,)),
          "sparse_duty": (_sparse_duty, (39.5, 49.5)),
          "background": (_background, (29.5, 35.5)),
          "noise": (_noise, (5.0, 15.0, 29.0)),
          "irregular": (_irregular, (31.0, 40.0)),
          "gathers": (_with_gathers, (29.5, 34.5)),
          "two_keys": (_two_keys, (28.5, 29.5, 30.5, 31.5, 32.5))}


def _run_trace(m, name):
    trace, plan_at = TRACES[name]
    p = m.PlacementPlanner(cfg=_cfg(m))
    keys = {}
    for kname, node, t, kind in trace():
        key = keys.setdefault(kname, m.ModelKey("jax", kname, "1"))
        p.observe(key, node=node, now=t, kind=kind)
    patterns = {k: (dataclasses.asdict(p.pattern(key)) if p.pattern(key) else None)
                for k, key in sorted(keys.items())}
    plans = [[(a.kind, tuple(a.key), a.nodes, a.at_s, a.reason) for a in p.plan(now=t)]
             for t in plan_at]
    return patterns, plans, p.stats()


@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_actions_match_reference(name):
    got = _run_trace(P, name)
    assert got == _run_trace(J, name)
    if name == "periodic":
        patterns, plans, stats = got
        assert plans[0] == [] and [a[0] for a in plans[1]] == ["preposition"]
        assert 29.5 < plans[1][0][3] <= 30.5 and plans[2] == []
        assert stats["prepositions"] == 2
    if name == "gathers":
        assert {a[0] for a in got[1][0]} == {"replicate", "preposition"}


def _cluster(m, tmp, n=3, key=None, **mrm_kw):
    obj = m.ObjectStore(f"{tmp}/cloud", shard_bytes=SHARD)
    if key is not None:
        obj.put(key, _tensors())
    c = m.Cluster(objectstore=obj)
    extra = {} if m is J else {"device": "cpu"}
    for i in range(n):
        c.add_node(f"node{i}", m.MRM(m.DiskStore(f"{tmp}/disk{i}"), device_capacity=64 * MB,
                                     host_capacity=256 * MB, hw=m.HardwareModel(),
                                     **extra, **mrm_kw))
    return c


def _rebalance(m, tmp):
    key = m.ModelKey("jax", "m", "1")
    c = _cluster(m, tmp, key=key)
    c.scatter(key)
    p = m.PlacementPlanner(directory=c.directory, cfg=_cfg(m))
    first = p.plan(now=0.0)
    c.directory.drop_node("node1")
    acts = [(a.kind, tuple(a.key), a.nodes, a.at_s, a.reason) for a in p.plan(now=1.0)]
    applied = p.apply(c, actions=p.plan(now=1.5) + [
        m.PlacementAction("rebalance", key, ("node0", "node2"), at_s=1.5)])
    held = {n: c.node(n).local_shards(key) for n in ("node0", "node2")}
    return first, acts, p.plan(now=2.0), [a.kind for a in applied], held, p.stats()


def test_rebalance_matches_reference(tmp_path):
    got = _rebalance(P, tmp_path / "port")
    assert got == _rebalance(J, tmp_path / "jax")
    first, acts, quiet, applied, held, stats = got
    assert first == [] and quiet == [] and [a[0] for a in acts] == ["rebalance"]
    assert set(acts[0][2]) == {"node0", "node2"} and stats["rebalances"] == 1


def _apply(m, tmp):
    """Preposition (host tier) then replicate, applied to a real cluster;
    a failed action does not abort the rest."""
    key, bad = m.ModelKey("jax", "m", "1"), m.ModelKey("jax", "missing", "1")
    c = _cluster(m, tmp, key=key)
    p = m.PlacementPlanner(cfg=_cfg(m))
    for _, node, t, kind in _periodic(node="node1"):
        p.observe(key, node=node, now=t, kind=kind)
    for _ in range(3):
        p.observe(key, node="node2", now=25.3, kind="gather")
    applied = p.apply(c, now=29.5)
    deadline = time.time() + 30.0
    while c.node("node1").mrm.host.peek(key) is None and time.time() < deadline:
        time.sleep(0.01)
    failed = p.apply(c, actions=[m.PlacementAction("replicate", k, ("node0",), at_s=0.0)
                                 for k in (bad, key)])
    return ([(a.kind, a.nodes) for a in applied],
            c.node("node1").mrm.host.peek(key) is not None,
            c.node("node2").local_shards(key), [tuple(a.key) for a in failed],
            {k: v for k, v in p.stats().items() if not k.startswith("predictor_")},
            c.node("node1").mrm.metrics["cloud_downloads"])


def test_apply_matches_reference(tmp_path):
    got = _apply(P, tmp_path / "port")
    assert got == _apply(J, tmp_path / "jax")
    applied, warm, shards, failed, stats, _ = got
    assert applied == [("replicate", ("node2",)), ("preposition", ("node1",))]
    assert warm and shards and failed == [("jax", "m", "1")]
    assert stats["apply_errors"] == 1


def test_preposition_to_device_tier(tmp_path):
    """``apply(tier="device")`` pulls the model onto the node's device: a
    peer fetch from the holder, then the device copy; the next open is a
    device hit."""
    key = ModelKey("jax", "m", "1")
    c = _cluster(P, tmp_path, key=key)
    holder = c.node("node0")
    holder.mrm.close(holder.mrm.open(key))
    p = PlacementPlanner(cfg=_cfg(P))
    for _, node, t, kind in _periodic(node="node2"):
        p.observe(key, node=node, now=t, kind=kind)
    futs, real = [], c.node("node2").mrm.prefetch
    c.node("node2").mrm.prefetch = lambda *a, **kw: futs.append(real(*a, **kw)) or futs[-1]
    applied = p.apply(c, now=29.5, tier="device")
    assert [(a.kind, a.nodes) for a in applied] == [("preposition", ("node2",))]
    futs[0].result(timeout=30)
    assert futs[0].timings.tier_hit == "peer"
    h = c.node("node2").mrm.open(key)
    assert h.timings.tier_hit == "device"
    c.node("node2").mrm.close(h)
    assert c.node("node2").mrm.metrics["peer_fetches"] == 1


def test_planner_context_is_batch_class():
    ctx = planner_ctx()
    assert ctx.tenant == PLANNER_TENANT and ctx.slo_class == "batch"


# ------------------------------------------- admission under pressure

def _pressured(tmp_path, n_fill=4):
    disk = DiskStore(str(tmp_path / "disk"))
    per = sum(a.nbytes for a in _tensors(nbytes=1 * MB, seed=9).values())
    cap = int(n_fill * per * 1.01)
    mrm = MRM(disk, device_capacity=cap, host_capacity=cap, hw=HardwareModel(), device="cpu")
    TenantRegistry().attach(mrm)
    handles = []
    for i in range(n_fill):
        k = ModelKey("jax", f"fill{i}", "1")
        disk.put(k, _tensors(nbytes=1 * MB, seed=i))
        handles.append(mrm.open(k))
    key = ModelKey("jax", "wanted", "1")
    disk.put(key, _tensors(nbytes=1 * MB, seed=99))
    return mrm, key, handles


@pytest.mark.parametrize("ctx", ["planner", "none", "critical"])
def test_prefetch_admission(tmp_path, ctx):
    mrm, key, handles = _pressured(tmp_path)
    if ctx == "critical":
        for h in handles:
            mrm.close(h)
        h = mrm.open(key, ctx=RequestContext(tenant="svc", slo_class="critical"))
        assert h.weights["w0"].numel() > 0
        mrm.close(h)
        assert mrm.metrics["prefetch_suppressed"] == 0
        return
    fut = mrm.prefetch(key, tier="host", ctx=planner_ctx() if ctx == "planner" else None)
    fut.result()
    assert fut.suppressed == (ctx == "planner")
    assert mrm.metrics["prefetch_suppressed"] == (1 if ctx == "planner" else 0)
    for h in handles:
        mrm.close(h)


# -------------------------------------------------- scatter regressions

def test_scatter_rejects_unknown_nodes_and_rolls_back(tmp_path, monkeypatch):
    key = ModelKey("jax", "m", "1")
    c = _cluster(P, tmp_path, n=2, key=key)
    with pytest.raises(KeyError, match="unknown node"):
        c.scatter(key, node_names=["node0", "nope"])
    assert all(c.node(n).local_shards(key) == [] for n in ("node0", "node1"))
    victim, real, calls = c.node("node1"), c.node("node1").store_shard, {"n": 0}

    def flaky(key, index, data):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("disk full")
        return real(key, index, data)

    monkeypatch.setattr(victim, "store_shard", flaky)
    with pytest.raises(OSError):
        c.scatter(key, node_names=["node1"])
    assert victim.local_shards(key) == [] and c.directory.shards_on(key, "node1") == []
    monkeypatch.undo()
    out = c.scatter(key)
    assert sum(len(v) for v in out.values()) == len(c.objectstore.shard_table(key))
    assert c.directory.shard_keys() == [key]


def test_predictor_keeps_live_streams_and_drop_model_forgets(tmp_path):
    p = NextUsePredictor(clock=lambda: 0.0, max_keys=8)
    hot = ModelKey("jax", "hot", "1")
    for t in (0.0, 1.0, 2.0, 3.0):
        p.record(hot, now=t)
    for i in range(50):
        p.record(ModelKey("jax", f"scan{i}", "1"), now=10.0 + i)
    assert p.stats()["evicted_streams"] == 0
    assert p.predict_next_use_s(hot, now=3.0) == pytest.approx(1.0, rel=0.3)
    disk = DiskStore(str(tmp_path / "disk"))
    key = ModelKey("jax", "m", "1")
    disk.put(key, _tensors(nbytes=1 * MB))
    mrm = MRM(disk, device_capacity=64 * MB, host_capacity=256 * MB, policy="slo",
              hw=HardwareModel(), device="cpu")
    mrm.close(mrm.open(key))
    out = mrm.drop_model(key)
    assert out["host"] or out["device"]
    assert mrm.slo.predictor.predict_next_use_s(key) is None and disk.contains(key)


def test_planner_on_a_port_cluster_uses_port_types():
    assert Cluster is P.Cluster and ObjectStore is P.ObjectStore
    assert isinstance(PlacementPlanner().cfg, PlannerConfig)
    assert PlacementAction("preposition", ModelKey("jax", "m"), ("n",), 0.0).kind == "preposition"

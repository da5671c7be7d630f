"""The port's cluster layer (``repro_torch.core.cluster``) against the JAX
package's: the reference's peer-fetch, sharded-gather, scatter, stale-hint,
fault and peer-codec scenarios run on both packages, with the same link
constants given to both ``HardwareModel``s, and give the same tier hits,
the same MRM metrics (``peer_fetches``, ``gather_fetches``,
``modeled_fetch_s``, ...), the same node ``stats()`` and directory answers,
and the same weights. The streamed gather (windows fed by the shards, a
source dropped mid-stream, a corrupt shard) runs on the port, the
reference's directory property runs on the same drawn operations through
both packages, and greedy tokens of a reduced dense model that a port node
got by peer fetch and by gather equal the JAX engine's on a JAX cluster.
Everything here is a host decision or a byte copy, so it is compared
exactly. Models are small random float32 and bf16 tensors from a seed."""
import dataclasses
import hashlib
import os
import random
import tempfile
import threading

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.cluster as jax_cluster_mod
import repro.core.mrm as jax_mrm_mod
import repro_torch.core as P
import repro_torch.core.cluster as cluster_mod
import repro_torch.core.mrm as mrm_mod
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serving import InferenceEngine as JaxInferenceEngine
from repro.serving import publish_model as jax_publish_model
from repro_torch.bf16 import BF16_BITS
from repro_torch.serving import InferenceEngine

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - minimal containers
    HAVE_HYPOTHESIS = False

KB = 1 << 10
MB = 1 << 20
SHARD = 256 << 10
# the reference HardwareModel's link and I/O constants, given to both sides
HW_FIELDS = {f.name: getattr(J.HardwareModel(), f.name)
             for f in dataclasses.fields(J.HardwareModel)
             if f.init and f.name in {g.name for g in dataclasses.fields(P.HardwareModel)}}


class Pkg:
    """One package's cluster-layer names, so a scenario runs on either."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        self.m = J if jax_side else P
        self.cluster_mod = jax_cluster_mod if jax_side else cluster_mod
        self.mrm_mod = jax_mrm_mod if jax_side else mrm_mod
        self.Tier = self.m.Tier

    def key(self, *parts):
        return self.m.ModelKey(*parts)

    def hw(self, **over):
        return self.m.HardwareModel(**{**HW_FIELDS, **over})

    def mrm(self, root, dev=64 * MB, host=256 * MB, hw=None, **kw):
        extra = {} if self.jax else {"device": "cpu"}
        return self.m.MRM(self.m.DiskStore(str(root)), device_capacity=dev,
                          host_capacity=host, hw=hw or self.hw(), **extra, **kw)

    def objstore(self, root, **kw):
        return self.m.ObjectStore(str(root), **kw)

    def cluster(self, tmp, obj, n=3, populate=(), hw=None, names=None, **mrm_kw):
        for key, tensors in populate:
            obj.put(key, tensors)
        c = self.m.Cluster(objectstore=obj)
        for i in range(n):
            name = names[i] if names else f"node{i}"
            c.add_node(name, self.mrm(f"{tmp}/disk{i}", hw=hw, **mrm_kw))
        return c

    def weights(self, h, name):
        """A weight's bits as numpy, whichever package's device array it is."""
        a = h.weights[name]
        if isinstance(a, torch.Tensor):
            if a.dtype == torch.bfloat16:
                return a.view(torch.int16).numpy()
            return a.numpy()
        a = np.asarray(a)
        return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


JAX, PORT = Pkg(True), Pkg(False)


def _tensors(nbytes=2 * MB, n=8, seed=0):
    rng = np.random.default_rng(seed)
    per = nbytes // n // 4
    return {f"w{i}": rng.standard_normal(per).astype(np.float32) for i in range(n)}


def _bf16_tensors(pkg, seed=5):
    """Random bf16 bits (tagged ``uint16`` in the port, ``ml_dtypes`` in
    JAX): the two stores write the same bytes."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << 16, size=(8, 128, 64), dtype=np.uint16)
    dt = ml_dtypes.bfloat16 if pkg.jax else BF16_BITS
    return {"embed": bits.view(dt), "layers/w": bits[:, :32].copy().view(dt),
            "scale": np.linspace(-1, 1, 64, dtype=np.float32)}


def _quantized(nbytes=2 * MB, n=4, seed=0):
    rng = np.random.default_rng(seed)
    per = nbytes // n // 4
    return {f"w{i}": (np.round(rng.standard_normal(per) * 64) / 64).astype(np.float32)
            for i in range(n)}


def _metrics(mrm):
    return {k: mrm.metrics[k] for k in ("peer_fetches", "gather_fetches", "modeled_fetch_s",
                                         "cloud_downloads", "disk_loads", "opens")}


def _timings(h):
    t = h.timings
    return {"tier_hit": t.tier_hit, "peer_s": t.peer_s, "gather_s": t.gather_s,
            "cloud_s": t.cloud_s}


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _dir_state(pkg, c, keys, n_indices=12):
    d = c.directory
    out = {"stats": d.stats()}
    for key in keys:
        out[tuple(key)] = (
            [(n, t.value) for n, t in d.holders(key)],
            [[(n, t.value) for n, t in d.shard_holders(key, i)] for i in range(n_indices)],
            {name: (None if d.tier_on(key, name) is None else d.tier_on(key, name).value,
                    d.shards_on(key, name)) for name in c.nodes})
    return out


def _observe(pkg, c, handles, keys):
    """Tier hits, modeled link times, weights, metrics, node stats and the
    directory's answers of one scenario run."""
    return {"timings": [_timings(h) for h in handles],
            "weights": [{n: pkg.weights(h, n).tobytes() for n in sorted(h.weights)}
                        for h in handles],
            "mrm": {name: _metrics(node.mrm) for name, node in c.nodes.items()},
            "nodes": {name: node.stats() for name, node in c.nodes.items()},
            "directory": _dir_state(pkg, c, keys)}


# ------------------------------------------------------------- scenarios
# each runs one reference scenario on ``pkg`` and returns what it saw

def s_peer_preferred(pkg, tmp):
    key = pkg.key("jax", "m", "1")
    c = pkg.cluster(tmp, pkg.objstore(f"{tmp}/cloud"), n=2, populate=[(key, _tensors())])
    n0, n1 = c.node("node0"), c.node("node1")
    h0, h1 = n0.mrm.open(key), n1.mrm.open(key)
    assert (h0.timings.tier_hit, h1.timings.tier_hit) == ("cloud", "peer")
    assert 0 < h1.timings.peer_s < h0.timings.cloud_s
    assert _digest(n0.mrm.disk.path_for(key)) == _digest(n1.mrm.disk.path_for(key))
    return _observe(pkg, c, [h0, h1], [key])


def s_bf16_peer(pkg, tmp):
    key = pkg.key("jax", "b", "1")
    c = pkg.cluster(tmp, pkg.objstore(f"{tmp}/cloud"), n=2, populate=[(key, _bf16_tensors(pkg))])
    h0 = c.node("node0").mrm.open(key)
    h1 = c.node("node1").mrm.open(key)
    assert h1.timings.tier_hit == "peer"
    return _observe(pkg, c, [h0, h1], [key])


def s_cloud_when_peer_slow(pkg, tmp):
    key = pkg.key("jax", "m", "1")
    c = pkg.cluster(tmp, pkg.objstore(f"{tmp}/cloud"), n=2, populate=[(key, _tensors())],
                    hw=pkg.hw(peer_bw=1e6, peer_rtt=1.0))
    c.node("node0").mrm.close(c.node("node0").mrm.open(key))
    h1 = c.node("node1").mrm.open(key)
    assert h1.timings.tier_hit == "cloud"
    return _observe(pkg, c, [h1], [key])


def s_stale_hint(pkg, tmp):
    key = pkg.key("jax", "m", "1")
    c = pkg.cluster(tmp, pkg.objstore(f"{tmp}/cloud"), n=2, populate=[(key, _tensors())])
    n0, n1 = c.node("node0"), c.node("node1")
    n0.mrm.close(n0.mrm.open(key))
    n0.mrm.disk.delete(key)        # the directory still says node0 holds it
    h1 = n1.mrm.open(key)
    assert h1.timings.tier_hit == "cloud" and n1.metrics["peer_fetches"] == 0
    return _observe(pkg, c, [h1], [key])


def s_directory_follows_demotion(pkg, tmp):
    """DEVICE on load, HOST after a device eviction, DISK after a host
    eviction; then the node is dropped and stops publishing."""
    a, b, cc = (pkg.key("jax", n) for n in "abc")
    c = pkg.cluster(tmp, pkg.objstore(f"{tmp}/cloud"), n=1,
                    populate=[(k, _tensors(1 * MB, 4, seed=i)) for i, k in enumerate((a, b, cc))],
                    dev=int(1.5 * MB), host=int(2.5 * MB))
    node, d = c.node("node0"), c.directory
    seen = []
    for k in (a, b, cc):
        node.mrm.close(node.mrm.open(k))
        seen.append([None if d.tier_on(x, "node0") is None else d.tier_on(x, "node0").value
                     for x in (a, b, cc)])
    assert seen[-1][0] == pkg.Tier.DISK.value
    obs = _observe(pkg, c, [], [a, b, cc])
    d.drop_node("node0")
    node.mrm.close(node.mrm.open(a))
    obs["after_drop"] = (d.tier_on(a, "node0"), d.stats())
    obs["seen"] = seen
    return obs


def s_scatter_round_robin(pkg, tmp):
    key = pkg.key("jax", "big", "1")
    obj = pkg.objstore(f"{tmp}/cloud", shard_bytes=SHARD)
    c = pkg.cluster(tmp, obj, populate=[(key, _tensors())])
    placement = c.scatter(key, node_names=["node1", "node2"])
    n1 = c.node("node1")
    assert n1.local_shards(key) == placement["node1"]
    return {"placement": placement, "fraction": n1.shard_fraction(key),
            "directory": _dir_state(pkg, c, [key])}


def s_gather_scattered(pkg, tmp):
    key = pkg.key("jax", "big", "1")
    obj = pkg.objstore(f"{tmp}/cloud", shard_bytes=SHARD)
    c = pkg.cluster(tmp, obj, n=4, populate=[(key, _tensors())])
    c.scatter(key, node_names=["node1", "node2", "node3"])
    n0 = c.node("node0")
    h = n0.mrm.open(key)
    h2 = n0.mrm.open(key)
    assert (h.timings.tier_hit, h2.timings.tier_hit) == ("gather", "device")
    assert 0 < h.timings.gather_s < obj.modeled_fetch_s(key)
    assert _digest(n0.mrm.disk.path_for(key)) == obj.stat(key)["digest"]
    return _observe(pkg, c, [h, h2], [key])


def s_gather_full_holders(pkg, tmp):
    key = pkg.key("jax", "big", "1")
    obj = pkg.objstore(f"{tmp}/cloud", shard_bytes=SHARD)
    c = pkg.cluster(tmp, obj, populate=[(key, _tensors())])
    for name in ("node1", "node2"):
        obj.fetch(key, c.node(name).mrm.disk)
        c.directory.publish(name, key, pkg.Tier.DISK)
    h = c.node("node0").mrm.open(key)
    assert h.timings.tier_hit == "gather"
    return _observe(pkg, c, [h], [key])


def s_gather_declined_single_source(pkg, tmp):
    key = pkg.key("jax", "big", "1")
    obj = pkg.objstore(f"{tmp}/cloud", shard_bytes=SHARD)
    c = pkg.cluster(tmp, obj, n=2, populate=[(key, _tensors())])
    obj.fetch(key, c.node("node1").mrm.disk)
    c.directory.publish("node1", key, pkg.Tier.DISK)
    h = c.node("node0").mrm.open(key)
    assert h.timings.tier_hit == "peer"
    return _observe(pkg, c, [h], [key])


def s_local_shards_free(pkg, tmp):
    key = pkg.key("jax", "big", "1")
    obj = pkg.objstore(f"{tmp}/cloud", shard_bytes=SHARD)
    c = pkg.cluster(tmp, obj, populate=[(key, _tensors())])
    c.scatter(key, node_names=["node0", "node1", "node2"])
    n0 = c.node("node0")
    mine = list(n0.local_shards(key))
    h = n0.mrm.open(key)
    assert n0.stats()["shards_local"] == len(mine) > 0
    assert n0.local_shards(key) == []
    return _observe(pkg, c, [h], [key])


def s_gather_disabled_and_no_peer_fetch(pkg, tmp):
    key = pkg.key("jax", "big", "1")
    obj = pkg.objstore(f"{tmp}/cloud", shard_bytes=SHARD)
    obj.put(key, _tensors())
    c = pkg.m.Cluster(objectstore=obj)
    c.add_node("node0", pkg.mrm(f"{tmp}/d0"), gather=False)
    c.add_node("node1", pkg.mrm(f"{tmp}/d1"), peer_fetch=False)
    c.add_node("node2", pkg.mrm(f"{tmp}/d2"))
    c.scatter(key, node_names=["node2"])
    hs = [c.node(n).mrm.open(key) for n in ("node0", "node1")]
    assert [h.timings.tier_hit for h in hs] == ["cloud", "cloud"]
    return _observe(pkg, c, hs, [key])


def s_host_tier_gather(pkg, tmp):
    key = pkg.key("jax", "big", "1")
    obj = pkg.objstore(f"{tmp}/cloud", shard_bytes=SHARD)
    c = pkg.cluster(tmp, obj, populate=[(key, _tensors())], dev=1 * MB)
    c.scatter(key, node_names=["node1", "node2"])
    n0 = c.node("node0")
    h = n0.mrm.open(key, tier="host")
    assert h.timings.tier_hit == "gather" and n0.mrm.resident(key, pkg.Tier.HOST)
    obs = _observe(pkg, c, [], [key])
    obs["host"] = {n: np.asarray(a).tobytes() for n, a in h.weights.items()}
    return obs


def s_corrupt_peer(pkg, tmp):
    key = pkg.key("jax", "big", "1")
    obj = pkg.objstore(f"{tmp}/cloud", shard_bytes=SHARD)
    c = pkg.cluster(tmp, obj, populate=[(key, _tensors())])
    for name in ("node1", "node2"):
        obj.fetch(key, c.node(name).mrm.disk)
        c.directory.publish(name, key, pkg.Tier.DISK)
    path = c.node("node1").mrm.disk.path_for(key)
    with open(path, "r+b") as f:
        f.write(b"\xff" * os.path.getsize(path))
    h = c.node("node0").mrm.open(key)
    st = c.node("node0").stats()
    assert h.timings.tier_hit == "gather" and st["gather_fallbacks"] > 0
    assert _digest(c.node("node0").mrm.disk.path_for(key)) == obj.stat(key)["digest"]
    return _observe(pkg, c, [h], [key])


def s_corrupt_shard_cache(pkg, tmp):
    key = pkg.key("jax", "big", "1")
    obj = pkg.objstore(f"{tmp}/cloud", shard_bytes=SHARD)
    c = pkg.cluster(tmp, obj, populate=[(key, _tensors())])
    c.scatter(key, node_names=["node1", "node2"])
    n1 = c.node("node1")
    with open(n1._shard_path(key, n1.local_shards(key)[0]), "r+b") as f:
        f.write(b"\x00" * 64)
    h = c.node("node0").mrm.open(key)
    assert h.timings.tier_hit == "gather"
    assert c.node("node0").stats()["gather_fallbacks"] >= 1
    return _observe(pkg, c, [h], [key])


def s_drop_mid_copy(pkg, tmp):
    """A peer dropped while it copies: never charged, the fetch re-plans
    onto the CLOUD."""
    key = pkg.key("jax", "m", "1")
    obj = pkg.objstore(f"{tmp}/cloud")
    obj.put(key, _tensors(), shard_bytes=0)
    c = pkg.cluster(tmp, obj, n=2)
    c.node("node1").mrm.close(c.node("node1").mrm.open(key))
    cls = pkg.cluster_mod.ClusterNode
    real = cls.read_model

    def drop_mid_copy(self, key, write, **kw):
        out = real(self, key, write, **kw)
        c.directory.drop_node("node1")
        return out

    cls.read_model = drop_mid_copy
    try:
        h = c.node("node0").mrm.open(key)
    finally:
        cls.read_model = real
    assert h.timings.tier_hit == "cloud" and h.timings.peer_s == 0.0
    assert c.node("node0").stats()["plan_replans"] == 1
    return _observe(pkg, c, [h], [key])


def s_compressed_peer_wire(pkg, tmp):
    hw = pkg.hw(peer_bw=0.5e9, disk_bw=5e9, compress_bw=5e9)
    c = pkg.m.Cluster(peer_codec="zlib")
    for i in range(2):
        c.add_node(f"node{i}", pkg.mrm(f"{tmp}/peer{i}", dev=64 * MB, host=128 * MB, hw=hw))
    key = pkg.key("jax", "m", "1")
    c.node("node0").mrm.disk.put(key, _quantized())
    c.directory.publish("node0", key, pkg.Tier.DISK)
    h = c.node("node1").mrm.open(key)
    st = c.node("node1").stats()
    assert h.timings.tier_hit == "peer" and h.timings.decompress_s > 0
    assert 0 < st["bytes_on_wire"] < st["bytes_from_peers"]
    return _observe(pkg, c, [h], [key])


def s_raw_copy_when_compression_does_not_pay(pkg, tmp):
    hw = pkg.hw(peer_bw=10e9, disk_bw=500e6)
    c = pkg.m.Cluster(peer_codec="zlib")
    for i in range(2):
        c.add_node(f"node{i}", pkg.mrm(f"{tmp}/peer{i}", dev=64 * MB, host=128 * MB, hw=hw))
    key = pkg.key("jax", "m", "1")
    c.node("node0").mrm.disk.put(key, _quantized())
    c.directory.publish("node0", key, pkg.Tier.DISK)
    h = c.node("node1").mrm.open(key)
    st = c.node("node1").stats()
    assert h.timings.tier_hit == "peer" and st["bytes_on_wire"] == st["bytes_from_peers"]
    return _observe(pkg, c, [h], [key])


def s_wire_ratio_own_codec(pkg, tmp):
    hw = pkg.hw(peer_bw=0.5e9, disk_bw=5e9, compress_bw=5e9)
    obj = pkg.objstore(f"{tmp}/cloud", codec="lzma")
    c = pkg.m.Cluster(objectstore=obj, peer_codec="zlib")
    for i in range(2):
        c.add_node(f"node{i}", pkg.mrm(f"{tmp}/peer{i}", hw=hw))
    key = pkg.key("jax", "m", "1")
    obj.put(key, _quantized())
    c.node("node0").mrm.disk.put(key, _quantized())
    st = obj.stat(key)
    got = c.node("node1")._wire_ratio(key, c.node("node0"))
    assert got != pytest.approx(st["nbytes"] / st["stored_nbytes"])
    assert key in c.node("node1")._ratio_cache
    tuned = pkg.m.Cluster(peer_codec=pkg.m.get_codec("zlib").__class__(level=9))
    node = tuned.add_node("n0", pkg.mrm(f"{tmp}/tuned"))
    return {"ratio": got, "tuned": (node.peer_codec, node._peer_codec.level)}


SCENARIOS = {f.__name__[2:]: f for f in (
    s_peer_preferred, s_bf16_peer, s_cloud_when_peer_slow, s_stale_hint,
    s_directory_follows_demotion, s_scatter_round_robin, s_gather_scattered,
    s_gather_full_holders, s_gather_declined_single_source, s_local_shards_free,
    s_gather_disabled_and_no_peer_fetch, s_host_tier_gather, s_corrupt_peer,
    s_corrupt_shard_cache, s_drop_mid_copy, s_compressed_peer_wire,
    s_raw_copy_when_compression_does_not_pay, s_wire_ratio_own_codec)}


def _plainify(obs):
    """Tiers to their values, model keys to tuples: the two packages'
    enums and named tuples are different classes."""
    if isinstance(obs, dict):
        return {(tuple(k) if isinstance(k, tuple) else k): _plainify(v) for k, v in obs.items()}
    if isinstance(obs, (list, tuple)):
        return [_plainify(v) for v in obs]
    if isinstance(obs, (J.Tier, P.Tier)):
        return obs.value
    return obs


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name, tmp_path):
    want = _plainify(SCENARIOS[name](JAX, tmp_path / "jax"))
    got = _plainify(SCENARIOS[name](PORT, tmp_path / "port"))
    assert got == want


# ------------------------------------------ faults whose counts race

def _peer_dies_mid_gather(pkg, tmp):
    key = pkg.key("jax", "big", "1")
    tensors = _tensors()
    obj = pkg.objstore(f"{tmp}/cloud", shard_bytes=SHARD)
    c = pkg.cluster(tmp, obj, populate=[(key, tensors)])
    for name in ("node1", "node2"):
        obj.fetch(key, c.node(name).mrm.disk)
        c.directory.publish(name, key, pkg.Tier.DISK)
    n0 = c.node("node0")
    real = n0._fetch_one_shard
    state = {"fetched": 0}

    def dying_fetch(k, st, row, plan_gen, loads):
        data = real(k, st, row, plan_gen, loads)
        state["fetched"] += 1
        if state["fetched"] == 1:
            c.directory.drop_node("node2")
        return data

    n0._fetch_one_shard = dying_fetch
    h = n0.mrm.open(key)
    stats = n0.stats()
    assert stats["plan_replans"] >= 1 and stats["shards_from_cloud"] >= 1
    np.testing.assert_array_equal(pkg.weights(h, "w0"), tensors["w0"])
    return (h.timings.tier_hit, _digest(n0.mrm.disk.path_for(key)),
            [n for n, _ in c.directory.holders(key)])


def test_peer_dies_mid_gather_matches_reference(tmp_path):
    """Which shards the dead peer served first is a race; the outcome is not."""
    assert _peer_dies_mid_gather(PORT, tmp_path / "port") == \
        _peer_dies_mid_gather(JAX, tmp_path / "jax")


def test_concurrent_opens_share_one_gather(tmp_path):
    key = PORT.key("jax", "big", "1")
    tensors = _tensors()
    obj = PORT.objstore(tmp_path / "cloud", shard_bytes=SHARD)
    c = PORT.cluster(tmp_path, obj, populate=[(key, tensors)])
    c.scatter(key, node_names=["node1", "node2"])
    n0 = c.node("node0")
    handles, errs = [None] * 8, []

    def worker(i):
        try:
            handles[i] = n0.mrm.open(key)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs
    assert n0.stats()["gather_fetches"] == 1 and n0.mrm.metrics["disk_loads"] == 1
    for h in handles:
        np.testing.assert_array_equal(PORT.weights(h, "w0"), tensors["w0"])
        n0.mrm.close(h)


def test_concurrent_gathers_coalesce(tmp_path):
    key = PORT.key("jax", "big", "1")
    obj = PORT.objstore(tmp_path / "cloud", shard_bytes=SHARD)
    c = PORT.cluster(tmp_path, obj, populate=[(key, _tensors())])
    c.scatter(key, node_names=["node1", "node2"])
    n0 = c.node("node0")
    started, release = threading.Event(), threading.Event()
    real = n0._fetch_one_shard

    def slow_fetch(*a, **kw):
        started.set()
        release.wait(timeout=30)
        return real(*a, **kw)

    n0._fetch_one_shard = slow_fetch
    results = {}

    def gather(tag):
        t = mrm_mod.OpenTimings()
        results[tag] = (n0.fetch_for(key, t), t.tier_hit)

    t1 = threading.Thread(target=gather, args=("a",))
    t1.start()
    assert started.wait(timeout=30)
    t2 = threading.Thread(target=gather, args=("b",))
    t2.start()
    while n0.stats()["gather_coalesced"] == 0:
        t2.join(timeout=0.01)
    release.set()
    t1.join(timeout=30)
    t2.join(timeout=30)
    assert results == {"a": (True, "gather"), "b": (True, "gather")}
    assert (n0.stats()["gather_fetches"], n0.stats()["gather_coalesced"]) == (1, 1)


# ---------------------------------------------------- streamed gather

def _layered(L=6, d=64, seed=2):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"embed": f32(64, d), "final_norm/scale": f32(d),
            "layers/attn/wq": f32(L, d, d), "layers/attn/wo": f32(L, d, d),
            "layers/ffn/w1": f32(L, d, 4 * d), "layers/ffn/w2": f32(L, 4 * d, d)}


def _layered_cluster(pkg, tmp):
    tensors = _layered()
    obj = pkg.objstore(f"{tmp}/cloud", shard_bytes=SHARD)
    key = pkg.key("jax", "big", "1")
    obj.put(key, tensors, shard_plan="layers")
    c = pkg.m.Cluster(objectstore=obj)
    for i in range(3):
        c.add_node(f"node{i}", pkg.mrm(f"{tmp}/disk{i}", pipelined_staging=False))
    c.scatter(key, node_names=["node1", "node2"])
    return c, obj, key, tensors


def _stream(pkg, tmp, corrupt=False):
    """A streamed open on node0 gathered from the two shard holders: tier
    hit, the order windows became ready, and whether every shard was fed
    before the file was complete."""
    c, obj, key, tensors = _layered_cluster(pkg, tmp)
    n0 = c.node("node0")
    if corrupt:
        n1 = c.node("node1")
        with open(n1._shard_path(key, n1.local_shards(key)[0]), "r+b") as f:
            f.write(b"\xff" * 64)
    order, fed_early = [], []
    mark = pkg.mrm_mod.LoadFuture._mark_window
    dst = n0.mrm.disk.path_for(key)
    gather_run = n0._gather_run

    def watching(k, st, timings, on_shard=None, ctx=None):
        def cb(row, data):
            fed_early.append(not os.path.exists(dst))
            on_shard(row, data)
        return gather_run(k, st, timings, cb if on_shard else None, ctx=ctx)

    def recording(fut, index):
        if fut.streaming:
            order.append(index)
        mark(fut, index)

    n0._gather_run = watching
    pkg.mrm_mod.LoadFuture._mark_window = recording
    try:
        fut = n0.mrm.open_stream(key)
        h = fut.result(timeout=60)
    finally:
        pkg.mrm_mod.LoadFuture._mark_window = mark
    assert fut.windows_ready() == len(fut.plan)
    for name, ref in tensors.items():
        np.testing.assert_array_equal(np.asarray(fut.arrays[name]), ref)
    assert _digest(dst) == obj.stat(key)["digest"]
    out = {"tier_hit": fut.timings.tier_hit, "order": order, "windows": len(fut.plan),
           "fed_early": all(fed_early), "n_fed": len(fed_early),
           "mrm": _metrics(n0.mrm), "node": n0.stats()}
    n0.mrm.close(h)
    return out


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "corrupt_shard"])
def test_streamed_gather_matches_reference(tmp_path, corrupt):
    got = _stream(PORT, tmp_path / "port", corrupt)
    assert got == _stream(JAX, tmp_path / "jax", corrupt)
    assert got["tier_hit"] == "gather" and got["order"] == list(range(got["windows"]))
    assert got["fed_early"] and got["mrm"]["gather_fetches"] == 1
    if corrupt:
        assert got["node"]["gather_fallbacks"] > 0
        assert 0 < got["node"]["shards_from_cloud"] < got["n_fed"]


def test_streamed_gather_source_death_keeps_readiness(tmp_path):
    c, obj, key, tensors = _layered_cluster(PORT, tmp_path)
    n0 = c.node("node0")
    state = {"fetched": 0, "prefix": None, "fut": None}
    real = n0._fetch_one_shard

    def dying_fetch(k, st, row, plan_gen, loads):
        data = real(k, st, row, plan_gen, loads)
        state["fetched"] += 1
        if state["fetched"] == 2:
            state["prefix"] = state["fut"].windows_ready() if state["fut"] else 0
            c.directory.drop_node("node2")
        return data

    n0._fetch_one_shard = dying_fetch
    fut = n0.mrm.open_stream(key)
    state["fut"] = fut
    h = fut.result(timeout=60)
    assert state["prefix"] is not None
    assert fut.windows_ready() == len(fut.plan) >= state["prefix"]
    assert fut.timings.tier_hit == "gather" and n0.stats()["plan_replans"] >= 1
    for name, ref in tensors.items():
        np.testing.assert_array_equal(fut.arrays[name], ref)
    assert _digest(n0.mrm.disk.path_for(key)) == obj.stat(key)["digest"]
    n0.mrm.close(h)


# ------------------------------------------- the reference's properties

NAMES = [f"n{i}" for i in range(4)]
OP_KINDS = ["register", "drop", "publish", "withdraw", "publish_shard", "withdraw_shard"]


class _FakeNode:
    def __init__(self, name):
        self.name = name
        self.detached = 0

    def detach(self):
        self.detached += 1


def _answers(pkg, dirs, keys):
    out = []
    for d in dirs:
        for k in keys:
            out.append(([(n, t.value) for n, t in d.holders(k)],
                        [[(n, t.value) for n, t in d.shard_holders(k, i)] for i in range(4)],
                        [d.shards_on(k, n) for n in NAMES], d.generation))
    return out


def _directory_ops(ops):
    """The reference's directory property, each op applied to both
    packages' single-map and sharded directories; every answer compared
    after every op."""
    sides = []
    for pkg in (JAX, PORT):
        dirs = [pkg.m.ClusterDirectory(), pkg.m.ShardedClusterDirectory(n_shards=4)]
        keys = [pkg.key("jax", f"m{i}") for i in range(3)]
        tiers = [pkg.Tier.DEVICE, pkg.Tier.HOST, pkg.Tier.DISK]
        sides.append((pkg, dirs, keys, tiers, set()))
    for kind, a, b, c in ops:
        name = NAMES[a % 4]
        seen = []
        for pkg, dirs, keys, tiers, alive in sides:
            key, tier, index = keys[b % 3], tiers[c % 3], c % 4
            for d in dirs:
                if kind == "register":
                    if name in alive:
                        with pytest.raises(KeyError):
                            d.register(_FakeNode(name))
                    else:
                        d.register(_FakeNode(name))
                elif kind == "drop":
                    d.drop_node(name)
                elif kind == "publish":
                    d.publish(name, key, tier)
                elif kind == "withdraw":
                    d.withdraw(name, key, tier)
                elif kind == "publish_shard":
                    d.publish_shard(name, key, index, tier)
                else:
                    d.withdraw_shard(name, key, index, tier)
            if kind == "register":
                alive.add(name)
            elif kind == "drop":
                alive.discard(name)
            seen.append(_answers(pkg, dirs, keys))
        assert seen[0] == seen[1]
        half = len(seen[1]) // 2
        assert [s[:3] for s in seen[1][:half]] == [s[:3] for s in seen[1][half:]]


if HAVE_HYPOTHESIS:

    @given(st.lists(st.tuples(st.sampled_from(OP_KINDS), st.integers(0, 7),
                              st.integers(0, 7), st.integers(0, 7)),
                    min_size=1, max_size=60))
    @settings(max_examples=40, deadline=None)
    def test_directory_property_matches_reference(ops):
        _directory_ops(ops)


@pytest.mark.parametrize("seed", range(4))
def test_directory_property_seeded(seed):
    rng = random.Random(seed)
    _directory_ops([(rng.choice(OP_KINDS), rng.randrange(8), rng.randrange(8),
                     rng.randrange(8)) for _ in range(80)])


def _owner_failover(pkg, policy, victim_idx, drop_after):
    """The reference's owner-failover property: a shard owner dropped
    mid-gather never loses the open."""
    with tempfile.TemporaryDirectory() as tmp:
        obj = pkg.objstore(f"{tmp}/cloud", shard_bytes=SHARD)
        key = pkg.key("jax", "big", "1")
        tensors = _tensors()
        obj.put(key, tensors)
        c = pkg.m.Cluster(objectstore=obj, directory=policy)
        for i in range(3):
            c.add_node(f"node{i}", pkg.mrm(f"{tmp}/disk{i}"))
        c.scatter(key, node_names=["node1", "node2"])
        victim, n0 = f"node{victim_idx}", c.node("node0")
        real = n0._fetch_one_shard
        state = {"fetched": 0, "dropped": False}

        def dying_fetch(k, st, row, plan_gen, loads):
            data = real(k, st, row, plan_gen, loads)
            state["fetched"] += 1
            if state["fetched"] == drop_after and not state["dropped"]:
                state["dropped"] = True
                c.directory.drop_node(victim)
            return data

        n0._fetch_one_shard = dying_fetch
        h = n0.mrm.open(key)
        stats = n0.stats()
        n_shards = len(obj.shard_table(key))
        if drop_after <= n_shards // 2 - 1:
            assert stats["plan_replans"] >= 1 and stats["shards_from_cloud"] >= 1
        np.testing.assert_array_equal(pkg.weights(h, "w0"), tensors["w0"])
        out = (h.timings.tier_hit, state["dropped"], _digest(n0.mrm.disk.path_for(key)),
               victim in dict(c.directory.holders(key)),
               any(victim in dict(c.directory.shard_holders(key, i))
                   for i in range(n_shards)))
        n0.mrm.close(h)
        return out


if HAVE_HYPOTHESIS:

    @pytest.mark.parametrize("policy", ["single", "sharded"])
    @given(victim_idx=st.sampled_from([1, 2]), drop_after=st.integers(1, 8))
    @settings(max_examples=4, deadline=None)
    def test_owner_failover_property_matches_reference(policy, victim_idx, drop_after):
        got = _owner_failover(PORT, policy, victim_idx, drop_after)
        assert got == _owner_failover(JAX, policy, victim_idx, drop_after)
        assert got[:2] == ("gather", True) and not any(got[3:])


def _residency(pkg, tmp, seed):
    """The reference's real-cluster residency walk (open / close / evict /
    shard / drop) with the directory's answers after every step."""
    rng = random.Random(seed)
    obj = pkg.objstore(f"{tmp}/cloud", shard_bytes=16 * KB)
    keys = [pkg.key("jax", f"m{i}") for i in range(3)]
    for i, key in enumerate(keys):
        obj.put(key, {f"w{j}": np.full((16 * KB // 4,), i * 8 + j, np.float32)
                      for j in range(2)})
    c = pkg.m.Cluster(objectstore=obj)
    for i in range(3):
        c.add_node(f"node{i}", pkg.mrm(f"{tmp}/disk{i}", dev=80 * KB, host=160 * KB))
    alive, handles, dropped, trail = set(c.nodes), [], False, []
    for _ in range(30):
        op = rng.choice(["open", "open", "close", "evict_dev", "evict_host", "shard", "drop"])
        name = rng.choice(sorted(alive))
        node, key = c.nodes[name], keys[rng.randrange(3)]
        if op == "open":
            try:
                handles.append((name, node.mrm.open(key)))
            except pkg.m.CapacityError:
                pass
        elif op == "close" and handles:
            hname, h = handles.pop(rng.randrange(len(handles)))
            c.nodes[hname].mrm.close(h)
        elif op in ("evict_dev", "evict_host"):
            cache = node.mrm.device if op == "evict_dev" else node.mrm.host
            with cache.lock:
                e = cache.peek(key)
                if e is not None and e.refcount == 0 and not e.pinned \
                        and e.payload is not None:
                    cache.remove(key)
        elif op == "shard":
            table = obj.shard_table(key)
            s = table[rng.randrange(len(table))]
            node.store_shard(key, s["index"], obj.fetch_shard(key, s["index"])[1])
        elif op == "drop" and not dropped and len(alive) > 1:
            dropped = True
            victim = rng.choice(sorted(alive - {"node0"}))
            for hname, h in [x for x in handles if x[0] == victim]:
                c.nodes[hname].mrm.close(h)
            handles = [x for x in handles if x[0] != victim]
            c.directory.drop_node(victim)
            alive.discard(victim)
        trail.append((op, _dir_state(pkg, c, keys, n_indices=4)))
    for hname, h in handles:
        c.nodes[hname].mrm.close(h)
    return trail


@pytest.mark.parametrize("seed", range(2))
def test_real_cluster_residency_matches_reference(tmp_path, seed):
    assert _plainify(_residency(PORT, tmp_path / "port", seed)) == \
        _plainify(_residency(JAX, tmp_path / "jax", seed))


# ------------------------------------------------------------- tokens

@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """A reduced dense model in a JAX store, and the same file in a
    layer-sharded object store."""
    root = tmp_path_factory.mktemp("cluster_tokens")
    cfg = jax_get_config("olmo-1b").reduced().replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    disk = J.DiskStore(str(root / "src"))
    key = jax_publish_model(disk, cfg, jax_init_params(cfg, jax.random.PRNGKey(0)),
                            name="olmo")
    store = P.ObjectStore(str(root / "cloud"), shard_bytes=64 << 10)
    store.put_file(P.ModelKey(*key), disk.path_for(key), shard_plan="layers")
    return root, cfg, tuple(key)


def _serving_cluster(pkg, root, tmp, gather):
    """Node a holds the model on its disk (peer leg) or nodes a and b hold
    its layer shards (gather leg); node c is cold."""
    obj = pkg.objstore(f"{root}/cloud")
    c = pkg.m.Cluster(objectstore=obj)
    for name in "abc":
        disk_root = f"{root}/src" if (name == "a" and not gather) else f"{tmp}/{name}"
        c.add_node(name, pkg.mrm(disk_root, dev=1 << 30, host=1 << 30))
    if gather:
        c.scatter(pkg.key("repro-jax", "olmo", "1"), ["a", "b"])
    return c


def _jax_tokens(root, tmp, toks, gather):
    c = _serving_cluster(JAX, root, tmp, gather)
    node = c.node("c")
    h = node.mrm.open(("repro-jax", "olmo", "1"))
    hit = h.timings.tier_hit
    node.mrm.close(h)
    out, _ = JaxInferenceEngine(node.mrm.disk, node.mrm).generate("olmo", toks, max_new_tokens=4)
    return out, hit


@pytest.mark.parametrize("leg", ["peer", "gather", "gather_streamed"])
def test_cluster_tokens_match_jax(published, tmp_path, leg):
    """Greedy tokens of a port node that got the model by peer fetch, by a
    batch gather, and by a streamed gather equal the JAX engine's on a JAX
    node that got it the same way."""
    root, cfg, key = published
    gather, streaming = leg != "peer", leg == "gather_streamed"
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    want, jax_hit = _jax_tokens(root, tmp_path / "jax", toks, gather)
    c = _serving_cluster(PORT, root, tmp_path / "port", gather)
    node = c.node("c")
    eng = InferenceEngine(node.mrm.disk, node.mrm, device="cpu", framework="repro-jax",
                          streaming=streaming)
    if not streaming:         # the batch engine reads the config from the local file
        h = node.mrm.open(P.ModelKey(*key))
        assert h.timings.tier_hit == jax_hit
        node.mrm.close(h)
    got, stats = eng.generate("olmo", toks, max_new_tokens=4)
    np.testing.assert_array_equal(got, want)
    assert jax_hit == ("gather" if gather else "peer")
    if streaming:
        assert (stats.tier_hit, stats.streamed) == ("gather", True)
    assert node.mrm.metrics["gather_fetches" if gather else "peer_fetches"] == 1
    assert node.mrm.metrics["cloud_downloads"] == 0

"""The port's placement directory against the JAX package's: the blake2b
hash ring gives the same owner for every key, and the same operation
sequence leaves both packages' directories (single-map and sharded, and
two sharded replicas reconciled by anti-entropy) in the same state:
holders, shard holders, generation, ``stats()`` and the exported
snapshot, compared exactly."""
import random

import pytest

from repro.core import ClusterDirectory as JaxClusterDirectory
from repro.core import HashRing as JaxHashRing
from repro.core import ModelKey as JaxModelKey
from repro.core import ShardedClusterDirectory as JaxSharded
from repro.core import Tier as JaxTier
from repro.core import make_directory as jax_make_directory
from repro.core.directory import _key_token as jax_key_token
from repro_torch.core import (Cluster, ClusterDirectory, HashRing, ModelKey,
                              ShardedClusterDirectory, Tier, make_directory)
from repro_torch.core.directory import _key_token

N_KEYS = 40
NAMES = [f"n{i}" for i in range(6)]
OPS = ["register", "drop", "publish", "publish", "withdraw", "publish_shard",
       "withdraw_shard"]


class _FakeNode:
    def __init__(self, name):
        self.name = name
        self.detached = 0

    def detach(self):
        self.detached += 1


class _Side:
    """One package's directory names, so a scenario runs on either."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        self.Tier = JaxTier if jax_side else Tier
        self.single = JaxClusterDirectory if jax_side else ClusterDirectory
        self.sharded = JaxSharded if jax_side else ShardedClusterDirectory
        self.make = jax_make_directory if jax_side else make_directory
        self.keys = [(JaxModelKey if jax_side else ModelKey)("jax", f"m{i}")
                     for i in range(N_KEYS)]

    def tier(self, i):
        return [self.Tier.DEVICE, self.Tier.HOST, self.Tier.DISK][i]


SIDES = (_Side(True), _Side(False))


def _plain(pairs):
    return [(n, t.value) for n, t in pairs]


def _state(d, keys, n_indices=6):
    """Every answer the directory gives, with tiers as their values."""
    out = {"generation": d.generation, "stats": d.stats(),
           "nodes": sorted(n.name for n in d.nodes()),
           "shard_keys": [tuple(k) for k in d.shard_keys()]}
    for i, key in enumerate(keys):
        out[f"holders{i}"] = _plain(d.holders(key))
        out[f"warmest{i}"] = _plain([d.warmest(key)] if d.warmest(key) else [])
        for j in range(n_indices):
            out[f"shard{i}.{j}"] = _plain(d.shard_holders(key, j))
        for name in NAMES:
            t = d.tier_on(key, name)
            out[f"tier{i}.{name}"] = None if t is None else t.value
            out[f"shards_on{i}.{name}"] = d.shards_on(key, name)
    return out


def _trace(seed, n_ops=300):
    rng = random.Random(seed)
    return [(rng.choice(OPS), rng.choice(NAMES), rng.randrange(N_KEYS),
             rng.randrange(3), rng.randrange(6)) for _ in range(n_ops)]


def _replay(side, d, ops):
    alive = set()
    for kind, name, ki, ti, idx in ops:
        key, tier = side.keys[ki], side.tier(ti)
        if kind == "register":
            if name in alive:
                with pytest.raises(KeyError):
                    d.register(_FakeNode(name))
            else:
                d.register(_FakeNode(name))
                alive.add(name)
        elif kind == "drop":
            d.drop_node(name)
            alive.discard(name)
        elif kind == "publish":
            d.publish(name, key, tier)
        elif kind == "withdraw":
            d.withdraw(name, key, tier)
        elif kind == "publish_shard":
            d.publish_shard(name, key, idx, tier)
        elif kind == "withdraw_shard":
            d.withdraw_shard(name, key, idx, tier)


# ------------------------------------------------------------------ the ring

@pytest.mark.parametrize("n_shards,vnodes", [(1, 1), (4, 1), (8, 8), (32, 8),
                                             (7, 64)])
def test_ring_owners_match_reference(n_shards, vnodes):
    mine, ref = HashRing(range(n_shards), vnodes), JaxHashRing(range(n_shards), vnodes)
    keys = [ModelKey("jax", f"model{i}", str(i % 3)) for i in range(1000)]
    tokens = [_key_token(k) for k in keys]
    assert tokens == [jax_key_token(tuple(k)) for k in keys]
    assert [mine.owner(t) for t in tokens] == [ref.owner(t) for t in tokens]
    assert mine._points == ref._points
    if n_shards > 1:   # removing a shard re-homes the same keys on both
        mine.remove(n_shards // 2)
        ref.remove(n_shards // 2)
        assert [mine.owner(t) for t in tokens] == [ref.owner(t) for t in tokens]
    for ring in (mine, ref):
        for sid in list(ring.shard_ids()):
            ring.remove(sid)
        with pytest.raises(LookupError):
            ring.owner("jax/m@1")


@pytest.mark.parametrize("n_shards", [4, 32])
def test_sharded_directory_shard_of_matches(n_shards):
    mine, ref = ShardedClusterDirectory(n_shards=n_shards), JaxSharded(n_shards=n_shards)
    for i in range(1000):
        assert mine.shard_of(ModelKey("jax", f"m{i}")) == \
            ref.shard_of(JaxModelKey("jax", f"m{i}"))


# ----------------------------------------------------------- directory state

@pytest.mark.parametrize("policy", ["single", "sharded"])
@pytest.mark.parametrize("seed", range(4))
def test_same_ops_same_state(policy, seed):
    """One seeded trace of register / drop / publish / withdraw / shard
    ops through both packages' directories: every answer is equal."""
    ops = _trace(seed)
    states = []
    for side in SIDES:
        d = side.make(policy) if policy == "single" else side.make(policy, n_shards=8)
        _replay(side, d, ops)
        states.append(_state(d, side.keys))
        if policy == "sharded":
            states[-1]["snapshot"] = d.export_snapshot()
            states[-1]["shard_ops"] = d.shard_ops()
            states[-1]["gen_of"] = [d.generation_of(k) for k in side.keys]
    assert states[0] == states[1]


def test_single_and_sharded_agree_on_the_port():
    """The reference's differential oracle, on the port's two policies."""
    side = SIDES[1]
    ops = _trace(11)
    single, sharded = ClusterDirectory(), ShardedClusterDirectory(n_shards=8)
    _replay(side, single, ops)
    _replay(side, sharded, ops)
    a, b = _state(single, side.keys), _state(sharded, side.keys)
    for s in (a, b):
        for f in ("n_shards", "placement_ops", "sync_rounds", "records_merged",
                  "records_purged"):
            s["stats"].pop(f, None)
    assert a == b


def _two_views(side, n_shards=8):
    a = side.sharded(n_shards=n_shards, name="viewA")
    b = side.sharded(n_shards=n_shards, name="viewB")
    for name in ("n0", "n1", "n2"):
        a.register(_FakeNode(name))
        b.register(_FakeNode(name))
    return a, b


def _anti_entropy(side):
    """Partitioned writes, a drop and a re-registration on one view, a
    partial sync, then full rounds; the state after every round."""
    a, b = _two_views(side)
    rng = random.Random(0)
    keys = side.keys
    for i, key in enumerate(keys):
        view = a if i % 2 == 0 else b
        view.publish(f"n{i % 3}", key, side.tier(rng.randrange(3)))
        view.publish_shard(f"n{(i + 1) % 3}", key, i % 4, side.tier(rng.randrange(3)))
    b.publish("n0", keys[0], side.tier(2))
    a.drop_node("n0")
    a.register(_FakeNode("n0"))
    a.publish("n0", keys[1], side.tier(1))
    a.drop_node("n2")
    rounds = [a.sync_with(b, shard_ids={0, 1, 2})]
    rounds += [a.sync_with(b) for _ in range(3)]
    b.publish("n2", keys[2], side.tier(0))   # stale: n2 is dead everywhere now
    return rounds, [_state(v, keys) for v in (a, b)], [v.export_snapshot() for v in (a, b)]


def test_anti_entropy_matches_reference():
    mine, ref = _anti_entropy(SIDES[1]), _anti_entropy(SIDES[0])
    assert mine == ref
    rounds, (sa, sb), _ = mine
    assert rounds[-1] == 0
    sa["stats"].pop("sync_rounds")
    sb["stats"].pop("sync_rounds")
    for f in ("records_merged", "records_purged", "placement_ops"):
        sa["stats"].pop(f)
        sb["stats"].pop(f)
    assert sa == sb       # the two views converged


def test_snapshot_crosses_packages():
    """A JAX replica's snapshot merges into a port replica and back: the
    snapshots are the same plain data on both sides."""
    jax_side, port_side = SIDES
    ja, _ = _two_views(jax_side)
    pa, _ = _two_views(port_side)
    for i in range(10):
        ja.publish("n1", jax_side.keys[i], JaxTier.DISK)
        pa.publish_shard("n2", port_side.keys[i], i % 3, Tier.HOST)
    ja.drop_node("n0")
    merged = pa.merge_snapshot(ja.export_snapshot())
    merged += ja.merge_snapshot(pa.export_snapshot())
    assert merged > 0
    assert _state(pa, port_side.keys)["holders3"] == _state(ja, jax_side.keys)["holders3"]
    for i in range(10):
        assert _plain(pa.holders(port_side.keys[i])) == _plain(ja.holders(jax_side.keys[i]))
        assert _plain(pa.shard_holders(port_side.keys[i], i % 3)) == \
            _plain(ja.shard_holders(jax_side.keys[i], i % 3))
    assert pa.node("n0") is None and ja.node("n0") is None


def test_make_directory_and_cluster_policy():
    assert isinstance(make_directory("single"), ClusterDirectory)
    d = make_directory("sharded", n_shards=4)
    assert isinstance(d, ShardedClusterDirectory) and d.n_shards == 4
    with pytest.raises(ValueError):
        make_directory("quorum")
    with pytest.raises(ValueError):
        ShardedClusterDirectory(n_shards=0)
    assert isinstance(Cluster(directory="sharded").directory, ShardedClusterDirectory)
    assert isinstance(Cluster().directory, ClusterDirectory)


def test_reregister_is_new_incarnation():
    d = ShardedClusterDirectory(n_shards=8)
    key = ModelKey("jax", "m0")
    d.register(_FakeNode("a"))
    d.publish("a", key, Tier.DISK)
    d.drop_node("a")
    d.register(_FakeNode("a"))
    assert d.holders(key) == []
    d.publish("a", key, Tier.HOST)
    assert d.holders(key) == [("a", Tier.HOST)]

"""The port's streaming opens (``MRM.open_stream``) on the disk leg, and its
layer-streamed engine, against the JAX package: the counterparts of
``tests/test_streaming.py::TestOpenStream`` and ``TestStreamingEngine``."""
import threading

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import MRM as JaxMRM
from repro.core import DiskStore as JaxDiskStore
from repro.core import HardwareModel as JaxHardwareModel
from repro.models import init_params as jax_init_params
from repro.serving import InferenceEngine as JaxInferenceEngine
from repro.serving import publish_model as jax_publish_model
from repro_torch.core import costmodel
from repro_torch.core import mrm as mrm_mod
from repro_torch.core.cache import Tier
from repro_torch.core.layerplan import StreamAssembler
from repro_torch.core.mrm import MRM, ModelKey
from repro_torch.core.store import DiskStore
from repro_torch.serving import InferenceEngine

MB = 1 << 20


def _layered_tensors(L=4, d=16, moe=False, seed=0):
    rng = np.random.default_rng(seed)

    def f32(*s):
        return rng.standard_normal(s).astype(np.float32)

    t = {
        "embed": f32(64, d),
        "final_norm/scale": f32(d),
        "layers/attn/wq": f32(L, d, d),
        "layers/attn/wo": f32(L, d, d),
        "layers/ffn/w1": f32(L, d, 4 * d),
        "layers/ffn/w2": f32(L, 4 * d, d),
    }
    if moe:
        t["layers/ffn/w_gate"] = f32(L, 8, d)
        t["layers/ffn/w_up"] = f32(L, 8, d, 2 * d)
        t["layers/ffn/w_down"] = f32(L, 8, 2 * d, d)
    return t


def _mrm(disk, dev=64 * MB, host=256 * MB):
    return MRM(disk, device_capacity=dev, host_capacity=host,
               hw=costmodel.HardwareModel(), pipelined_staging=False, device="cpu")


def _put(tmp_path, tensors, name="m"):
    disk = DiskStore(str(tmp_path / "disk"))
    key = ModelKey("torch", name, "1")
    disk.put(key, tensors)
    return disk, key


@pytest.fixture
def window_order(monkeypatch):
    """Windows as they become ready on streaming futures, in order."""
    order = []
    mark = mrm_mod.LoadFuture._mark_window

    def recording(fut, index):
        if fut.streaming and not fut.coalesced:
            order.append(index)
        mark(fut, index)

    monkeypatch.setattr(mrm_mod.LoadFuture, "_mark_window", recording)
    return order


@pytest.fixture
def pause_feed(monkeypatch):
    """Pause the stream inside its first feed until ``resume`` is set."""
    paused, resume = threading.Event(), threading.Event()
    feed = StreamAssembler.feed

    def pausing(asm, offset, data):
        feed(asm, offset, data)
        if not paused.is_set():
            paused.set()
            assert resume.wait(30)

    monkeypatch.setattr(StreamAssembler, "feed", pausing)
    yield paused, resume
    resume.set()


def test_windows_arrive_in_execution_order(tmp_path, window_order):
    tensors = _layered_tensors(L=4)
    disk, key = _put(tmp_path, tensors)
    mrm = _mrm(disk)
    fut = mrm.open_stream(key)
    assert fut.wait_prefix(2, timeout=30) >= 2
    h = fut.result(timeout=30)
    assert fut.windows_ready() == len(fut.plan) == 5
    assert window_order == list(range(5))
    assert [w.layer_index for w in fut.plan] == [-1, 0, 1, 2, 3]
    for name, ref in tensors.items():
        np.testing.assert_array_equal(fut.arrays[name], ref)
        np.testing.assert_array_equal(h.weights[name], ref)
    assert h.tier == "host" and not h.private and mrm.resident(key, Tier.HOST)
    st = mrm.stats()
    assert (st["stream_opens"], st["stream_loads"], st["disk_loads"]) == (1, 1, 1)
    assert fut.timings.tier_hit == "disk" and fut.timings.disk_read_s > 0
    mrm.close(h)
    warm = mrm.open_stream(key)                    # a host hit: nothing to stream
    h_warm = warm.result(timeout=30)
    assert warm.plan is None and warm.wait_prefix(3) == 3
    assert h_warm.timings.tier_hit == "host" and mrm.stats()["stream_loads"] == 1
    mrm.close(h_warm)


def test_concurrent_wait_prefix_and_result(tmp_path):
    """A wait_prefix(k) caller and a full result() caller racing on one
    future both complete."""
    disk, key = _put(tmp_path, _layered_tensors(L=6))
    mrm = _mrm(disk)
    fut = mrm.open_stream(key)
    got = {}

    def waiter():
        got["prefix"] = fut.wait_prefix(3, timeout=30)

    def resolver():
        got["handle"] = fut.result(timeout=30)

    ts = [threading.Thread(target=waiter), threading.Thread(target=resolver)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert not any(t.is_alive() for t in ts)
    assert got["prefix"] >= 3
    assert got["handle"] is not None
    assert fut.wait_prefix(10 ** 6) == len(fut.plan)   # clamped, done
    mrm.close(got["handle"])


def test_coalesced_stream_mirrors_windows(tmp_path, pause_feed):
    paused, resume = pause_feed
    tensors = _layered_tensors(L=4)
    disk, key = _put(tmp_path, tensors)
    mrm = _mrm(disk)
    f1 = mrm.open_stream(key)
    assert paused.wait(30)                   # the stem is in, the rest is not
    f2 = mrm.open_stream(key)
    assert f2.coalesced and f2.plan is f1.plan and f2.arrays is f1.arrays
    assert f2.windows_ready() == f1.windows_ready() == 1
    resume.set()
    assert f2.wait_prefix(len(f1.plan), timeout=30) == len(f1.plan)
    h1, h2 = f1.result(timeout=30), f2.result(timeout=30)
    assert mrm.stats()["coalesced_loads"] == 1 and mrm.stats()["stream_loads"] == 1
    assert h2.timings.tier_hit == "host"
    for h in (h1, h2):
        mrm.close(h)
    assert mrm.host.peek(key).refcount == 0


def test_private_components_load_bypasses_cache(tmp_path):
    tensors = _layered_tensors(L=3, moe=True)
    disk, key = _put(tmp_path, tensors)
    mrm = _mrm(disk)
    fut = mrm.open_stream(key, components=("stem", "layer"))
    h = fut.result(timeout=30)
    assert h.private
    assert "layers/ffn/w_up" not in h.weights and "layers/attn/wq" in h.weights
    assert not mrm.resident(key, Tier.HOST)      # never cached
    assert mrm.stats()["partial_loads"] == 1
    mrm.close(h)                                  # must not underflow
    full = mrm.open(key, tier="host")             # full load still clean
    np.testing.assert_array_equal(full.weights["layers/ffn/w_up"], tensors["layers/ffn/w_up"])
    assert mrm.host.peek(key).refcount == 1
    mrm.close(full)


def test_eviction_pressure_mid_stream_spares_placeholder(tmp_path, pause_feed):
    """Host-tier pressure while a stream is in flight: the pinned
    placeholder reservation survives make_room; victims come from the
    unpinned population and the stream completes intact."""
    paused, resume = pause_feed
    big = _layered_tensors(L=8, d=64, seed=1)
    disk, key = _put(tmp_path, big, name="big")
    big_nb = sum(a.nbytes for a in big.values())
    small = {f"s{i}": np.zeros(big_nb // 16, np.float32) for i in range(4)}
    small_nb = sum(a.nbytes for a in small.values())
    mrm = _mrm(disk, host=big_nb + 3 * small_nb)
    skeys = []
    for i in range(4):
        sk = ModelKey("torch", f"small{i}", "1")
        disk.put(sk, small)
        skeys.append(sk)
    for sk in skeys[:2]:             # resident, unpinned, evictable
        mrm.close(mrm.open(sk, tier="host"))

    fut = mrm.open_stream(key)
    assert paused.wait(30)
    for sk in skeys[2:]:             # mid-stream: thrash the host tier
        mrm.close(mrm.open(sk, tier="host"))
    with mrm.host.lock:
        e = mrm.host.peek(key)
        assert e is not None and e.pinned and e.payload is None   # placeholder survived
    assert mrm.host.evictions >= 1
    resume.set()
    h = fut.result(timeout=60)
    for name, ref in big.items():
        np.testing.assert_array_equal(fut.arrays[name], ref)
    assert mrm.resident(key, Tier.HOST) and not mrm.host.peek(key).pinned
    mrm.close(h)


def test_demand_jumps_an_expert_window_to_the_head(tmp_path, pause_feed, window_order):
    paused, resume = pause_feed
    disk, key = _put(tmp_path, _layered_tensors(L=3, moe=True))
    mrm = _mrm(disk)
    fut = mrm.open_stream(key)
    assert paused.wait(30)                   # inside the stem window's feed
    last_expert = [w.index for w in fut.plan if w.group == "expert"][-1]
    assert fut.demand(last_expert)
    resume.set()
    h = fut.result(timeout=30)
    assert window_order[:2] == [0, last_expert]
    assert sorted(window_order) == list(range(len(fut.plan)))
    assert not fut.demand(1)                 # the stream is done: no more hints
    mrm.close(h)


def _stream_script(mrm, key):
    """One sequence of streaming and plain opens; returns the tier hits."""
    hits = []
    for name, kw in (("A", {}), ("A", {}), ("B", {"components": ("stem", "layer")}),
                     ("A", {"components": ("stem",)})):
        h = mrm.open_stream(key(name), **kw).result(timeout=60)
        hits.append(h.timings.tier_hit)
        mrm.close(h)
    h = mrm.open(key("A"))
    hits.append(h.timings.tier_hit)
    mrm.close(h)
    mrm.open_stream(key("B"), want_handle=False).result(timeout=60)
    return hits


def test_streaming_metrics_match_jax(tmp_path):
    root = str(tmp_path / "store")
    jdisk = JaxDiskStore(root)
    for name, seed in (("A", 0), ("B", 1)):
        jdisk.put(("t", name, "1"), _layered_tensors(L=3, moe=True, seed=seed))
    jmrm = JaxMRM(JaxDiskStore(root), device_capacity=64 * MB, host_capacity=256 * MB,
                  hw=JaxHardwareModel(), pipelined_staging=False)
    tmrm = _mrm(DiskStore(root))
    jhits = _stream_script(jmrm, lambda n: ("t", n, "1"))
    thits = _stream_script(tmrm, lambda n: ModelKey("t", n, "1"))
    assert thits == jhits == ["disk", "host", "disk", "host", "host"]
    js, ts = jmrm.stats(), tmrm.stats()
    for m in ("stream_opens", "stream_loads", "partial_loads", "disk_loads", "opens",
              "prefetches", "h2d_stages", "bytes_from_disk"):
        assert ts[m] == js[m], m
    assert (ts["stream_opens"], ts["stream_loads"], ts["partial_loads"]) == (5, 3, 1)


# ---------------------------------------------------------------- the engine

@pytest.fixture(scope="module")
def published(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stream_engine"))
    cfg = jax_get_config("mistral-nemo-12b").reduced().replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    jax_publish_model(JaxDiskStore(root), cfg, jax_init_params(cfg, jax.random.PRNGKey(0)),
                      name="nemo")
    return root, cfg


def _engine(root, **kw):
    return InferenceEngine(DiskStore(root), _mrm(DiskStore(root), dev=1 << 30, host=1 << 30),
                           device="cpu", framework="repro-jax", **kw)


def test_streamed_tokens_match_jax_and_batch(published):
    root, cfg = published
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jeng = JaxInferenceEngine(JaxDiskStore(root),
                              JaxMRM(JaxDiskStore(root), device_capacity=1 << 30),
                              streaming=True)
    want, jst = jeng.generate("nemo", toks, max_new_tokens=5)
    assert jst.streamed
    eng = _engine(root, streaming=True)
    got, st = eng.generate("nemo", toks, max_new_tokens=5)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (2, 5)
    assert st.streamed and st.tier_hit == "disk" and st.ttft_s > 0 and st.compile_s > 0
    assert 0 <= st.model_load_s <= st.total_s
    assert eng.mrm.stats()["stream_loads"] == 1
    # warm re-serve falls back to the batch path, same tokens
    got2, st2 = eng.generate("nemo", toks, max_new_tokens=5)
    assert not st2.streamed and st2.tier_hit == "host"
    np.testing.assert_array_equal(got2, want)
    batch, _ = _engine(root).generate("nemo", toks, max_new_tokens=5)
    np.testing.assert_array_equal(batch, want)
    assert eng.mrm.host.peek(ModelKey("repro-jax", "nemo", "1")).refcount == 0


def test_streaming_prefetch_and_fallbacks(published, tmp_path):
    root, cfg = published
    toks = np.arange(8, dtype=np.int32).reshape(1, 8)
    eng = _engine(root, streaming=True)
    assert eng.prefetch("absent") is None               # nowhere to fetch it from
    assert eng._generate_streaming("absent", toks, 2, "1") is None
    eng.mrm.close(eng.mrm.open(ModelKey("repro-jax", "nemo", "1")))
    _, st = eng.generate("nemo", toks, max_new_tokens=2)   # device-resident: batch
    assert not st.streamed and st.tier_hit == "device"
    assert eng.mrm.stats()["stream_opens"] == 0

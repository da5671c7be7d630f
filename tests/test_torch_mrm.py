"""The port's MRM against the JAX package's MRM: one scripted sequence of
opens, prefetches and evictions on one store gives the same tier hits and
metrics. On the CPU the port's device tier is ``"cpu"``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import DiskStore as JaxDiskStore
from repro.core import MRM as JaxMRM
from repro.core.costmodel import HardwareModel as JaxHardwareModel
from repro.core.costmodel import _CACHE_PATH as JAX_HW_CACHE
from repro.core.sharing import _CACHE as JAX_SHARING_CACHE
from repro.models import init_params as jax_init_params
from repro.serving import publish_model as jax_publish_model
from repro_torch.core import costmodel, sharing
from repro_torch.core.mrm import MRM, ModelKey
from repro_torch.core.store import BF16_BITS, DiskStore
from repro_torch.device import tensor_to_numpy

METRICS = ("opens", "disk_loads", "h2d_stages", "bytes_h2d", "bytes_from_disk",
           "demotion_saved_reloads", "pipelined_loads")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A (4 layers), B and C (2 layers each), bf16, published by JAX."""
    root = str(tmp_path_factory.mktemp("mrm_parity"))
    disk = JaxDiskStore(root)
    base = jax_get_config("deepseek-7b").reduced()
    for name, n_layers, seed in (("A", 4, 0), ("B", 2, 1), ("C", 2, 2)):
        cfg = base.replace(n_layers=n_layers)
        jax_publish_model(disk, cfg, jax_init_params(cfg, jax.random.PRNGKey(seed)), name=name)
    sizes = {n: disk.open(("repro-jax", n, "1")).total_bytes for n in "ABC"}
    return root, sizes


def _script(mrm, key):
    """The chip smoke test's sequence, at CPU scale."""
    hits = []

    def open_close(name):
        h = mrm.open(key(name))
        hits.append(h.timings.tier_hit)
        mrm.close(h)
        return h

    open_close("A")                                   # disk
    open_close("A")                                   # device
    mrm.prefetch(key("B"), tier="host").result()      # host: A, B
    mrm.prefetch(key("C"), tier="host").result()      # host: B, C (A's host copy dropped)
    open_close("B")                                   # host; A demoted D2H, C displaced
    h = open_close("A")                               # host (saved by the demotion)
    return hits, h


def _caps(sizes):
    a, b = sizes["A"], sizes["B"]
    return dict(device_capacity=a + b // 2, host_capacity=a + b + b // 2)


def test_scripted_sequence_matches_jax(store):
    root, sizes = store
    jmrm = JaxMRM(JaxDiskStore(root), hw=JaxHardwareModel(), **_caps(sizes))
    tmrm = MRM(DiskStore(root), hw=costmodel.HardwareModel(), device="cpu", **_caps(sizes))
    jhits, _ = _script(jmrm, lambda n: ("repro-jax", n, "1"))
    thits, h = _script(tmrm, lambda n: ModelKey("repro-jax", n, "1"))
    assert thits == jhits == ["disk", "device", "host", "host"]
    js, ts = jmrm.stats(), tmrm.stats()
    for m in METRICS:
        assert ts[m] == js[m], m
    assert ts["demotions"] == js["demotions"] >= 1
    assert ts["demotion_saved_reloads"] >= 1
    assert all(torch.is_tensor(w) and w.device.type == "cpu" for w in h.weights.values())


def test_device_weights_are_shared_and_demotion_is_byte_exact(store):
    root, sizes = store
    disk = DiskStore(root)
    mrm = MRM(disk, hw=costmodel.HardwareModel(), device="cpu", **_caps(sizes))
    key = ModelKey("repro-jax", "A", "1")
    h1, h2 = mrm.open(key), mrm.open(key)
    assert {n: t.data_ptr() for n, t in h1.weights.items()} == \
        {n: t.data_ptr() for n, t in h2.weights.items()}
    assert h1.weights["embed"].dtype == torch.bfloat16
    want = disk.open(key).read_all()
    mrm.close(h1)
    mrm.close(h2)
    entry = mrm.device.peek(key)
    demoted = mrm._demote_device_payload(entry)
    for n, a in want.items():
        got = demoted.arrays[n]
        assert got.tobytes() == a.tobytes() and got.shape == a.shape, n
        assert got.dtype.metadata == a.dtype.metadata, n


def test_device_put_round_trips_bf16(store):
    root, _ = store
    mrm = MRM(DiskStore(root), device_capacity=1 << 20, hw=costmodel.HardwareModel(),
              device="cpu")
    bits = np.arange(12, dtype=np.uint16).reshape(3, 4)
    t = mrm.device_put_fn(bits.view(BF16_BITS))
    assert t.dtype == torch.bfloat16 and t.shape == (3, 4)
    assert tensor_to_numpy(t).tobytes() == bits.tobytes()


def test_later_slices_raise(store):
    root, _ = store
    for kw in ({"use_shm": True}, {"objectstore": object()}, {"writeback_to_cloud": True},
               {"cloud_codec": "zlib"}):
        with pytest.raises(NotImplementedError, match="later slice"):
            MRM(DiskStore(root), device_capacity=1 << 20, device="cpu", **kw)
    mrm = MRM(DiskStore(root), device_capacity=1 << 20, hw=costmodel.HardwareModel(),
              device="cpu")
    h = mrm.open_stream(ModelKey("repro-jax", "A", "1")).result(timeout=60)
    assert h.tier == "host" and h.timings.tier_hit == "disk"
    assert mrm.stats()["stream_loads"] == 1
    mrm.close(h)
    with pytest.raises(ValueError, match="device_capacity"):
        MRM(DiskStore(root), device="cpu")


def test_cost_model_is_h100_and_has_its_own_cache():
    hw = costmodel.HardwareModel()
    assert hw.peak_flops == 989e12 and hw.hbm_bw == 3.35e12
    assert hw.d2h_time(int(hw.d2h_bw)) == pytest.approx(1.0)
    assert costmodel._CACHE_PATH != JAX_HW_CACHE
    assert sharing._CACHE != JAX_SHARING_CACHE
    assert "d2h_bw" in dataclasses.asdict(hw)

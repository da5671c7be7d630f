"""The port's serving engine: it serves a model the JAX package published,
token for token as the JAX engine does, and shares one device copy."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import MRM as JaxMRM
from repro.core import DiskStore as JaxDiskStore
from repro.models import init_params as jax_init_params
from repro.serving import InferenceEngine as JaxInferenceEngine
from repro.serving import publish_model as jax_publish_model
from repro_torch.core import costmodel
from repro_torch.core.mrm import MRM
from repro_torch.core.store import DiskStore
from repro_torch.launch import serve
from repro_torch.serving import InferenceEngine, Request, ServingWorkers


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("engine_parity"))
    disk = JaxDiskStore(root)
    cfg = jax_get_config("mistral-nemo-12b").reduced().replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    jax_publish_model(disk, cfg, jax_init_params(cfg, jax.random.PRNGKey(0)), name="nemo")
    return root, cfg


def _engine(root, **kw):
    mrm = MRM(DiskStore(root), device_capacity=1 << 30, host_capacity=1 << 30,
              hw=costmodel.HardwareModel(), device="cpu")
    return InferenceEngine(DiskStore(root), mrm, device="cpu", framework="repro-jax", **kw)


def test_tokens_match_jax_engine_and_second_open_hits_device(store):
    root, cfg = store
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jeng = JaxInferenceEngine(JaxDiskStore(root), JaxMRM(JaxDiskStore(root),
                                                         device_capacity=1 << 30))
    want, _ = jeng.generate("nemo", toks, max_new_tokens=5)
    eng = _engine(root)
    got, st1 = eng.generate("nemo", toks, max_new_tokens=5)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (2, 5)
    got2, st2 = eng.generate("nemo", toks, max_new_tokens=5)
    np.testing.assert_array_equal(got2, want)
    assert (st1.tier_hit, st2.tier_hit) == ("disk", "device")
    assert st1.compile_s > 0 and st2.compile_s == 0.0
    assert eng.exe_cache_misses == 2 and eng.exe_cache_hits == 2
    assert eng.mrm.stats()["disk_loads"] == 1


def test_cold_path_matches(store):
    root, cfg = store
    toks = np.ones((1, 8), np.int32)
    eng = _engine(root)
    warm, _ = eng.generate("nemo", toks, max_new_tokens=3)
    cold_eng = InferenceEngine(DiskStore(root), None, device="cpu", framework="repro-jax")
    cold, st = cold_eng.generate("nemo", toks, max_new_tokens=3)
    np.testing.assert_array_equal(cold, warm)
    assert st.tier_hit == "none(cold)"


def test_workers_share_one_device_copy(store):
    root, cfg = store
    eng = _engine(root)
    toks = np.arange(8, dtype=np.int32).reshape(1, 8)
    ref, _ = eng.generate("nemo", toks, max_new_tokens=3)
    seen = []
    load = eng.load_model

    def recording_load(name, version="1"):
        sm, s = load(name, version)
        seen.append({n: t.data_ptr() for n, t in sm.loaded.weights.items()})
        return sm, s

    eng.load_model = recording_load
    workers = ServingWorkers(eng, n_workers=2)
    reqs = [workers.submit(Request("nemo", toks, max_new=3)) for _ in range(4)]
    workers.drain(reqs, timeout=120)
    workers.stop()
    for r in reqs:
        np.testing.assert_array_equal(r.result, ref)
        assert r.stats.tier_hit == "device"
    assert len(seen) == 4 and all(s == seen[0] for s in seen)
    assert eng.mrm.stats()["disk_loads"] == 1


def test_later_slices_raise(store, tmp_path):
    """Streaming and the prefix-KV cache are on; a family of a later slice
    (SSM) falls from the streaming path to the batch path, which raises.
    MoE, which streams, is served in tests/test_torch_moe.py."""
    root, _ = store
    eng = _engine(root, streaming=True, prefix_cache_bytes=1 << 20)
    assert eng.streaming and eng.prefix_kv.tier.capacity == 1 << 20
    assert not _engine(root, streaming=True, use_trims=False).streaming
    cfg = jax_get_config("mamba2-370m").reduced()
    jax_publish_model(JaxDiskStore(str(tmp_path)), cfg,
                      jax_init_params(cfg, jax.random.PRNGKey(0)), name="ssm")
    ssm = _engine(str(tmp_path), streaming=True)
    with pytest.raises(NotImplementedError, match="later slice"):
        ssm.generate("ssm", np.ones((1, 4), np.int32), max_new_tokens=2)
    assert ssm.mrm.stats()["stream_opens"] == 0


def test_serve_cli_on_cpu(tmp_path, capsys):
    eng = serve.main(["--device", "cpu", "--store", str(tmp_path), "--arch", "deepseek-7b",
                      "--requests", "2", "--prompt-len", "8", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "req1: tier=device" in out and "1 disk loads" in out
    assert [s.tier_hit for s in eng.stats] == ["disk", "device"]
    assert all(isinstance(v, torch.Tensor) for v in
               eng.mrm.device.peek(("repro-torch", "deepseek-7b", "1")).payload.values())

"""The port's prefix-KV cache against the JAX package's: the counterparts of
``tests/test_prefix_cache.py``. The port's decode writes its KV cache in
place, so a shared prefill must come back as a copy on every hit."""
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
from repro.serving.prefix_cache import prompt_key as jax_prompt_key
from repro_torch.core import costmodel
from repro_torch.core.mrm import MRM
from repro_torch.core.store import DiskStore
from repro_torch.serving import InferenceEngine, PrefixKVStore, prompt_key


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("prefix"))
    cfg = jax_get_config("olmo-1b").reduced().replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    jax_publish_model(JaxDiskStore(root), cfg, jax_init_params(cfg, jax.random.PRNGKey(0)),
                      name="olmo-1b")
    return root, cfg


@pytest.fixture(scope="module")
def engine(published):
    root, _ = published
    mrm = MRM(DiskStore(root), device_capacity=1 << 30, host_capacity=1 << 30,
              hw=costmodel.HardwareModel(), device="cpu")
    return InferenceEngine(DiskStore(root), mrm, prefix_cache_bytes=256 << 20,
                           device="cpu", framework="repro-jax")


def _stored(engine, toks, max_len):
    return engine.prefix_kv.tier.entries[prompt_key("olmo-1b", toks, max_len)].payload


def test_same_prompt_skips_prefill_and_matches(engine):
    toks = np.arange(1, 17, dtype=np.int32)[None, :]
    out1, st1 = engine.generate("olmo-1b", toks, max_new_tokens=4)
    assert (engine.prefix_kv.misses, engine.prefix_kv.hits) == (1, 0)
    out2, st2 = engine.generate("olmo-1b", toks, max_new_tokens=4)
    assert engine.prefix_kv.hits == 1
    np.testing.assert_array_equal(out1, out2)   # shared prefill, same result
    assert st2.tier_hit == "device"


def test_different_prompt_misses(engine):
    toks = np.arange(20, 36, dtype=np.int32)[None, :]
    misses = engine.prefix_kv.misses
    engine.generate("olmo-1b", toks, max_new_tokens=2)
    assert engine.prefix_kv.misses == misses + 1


def test_shared_cache_not_mutated_by_decodes(engine):
    """Decodes from one shared prefill must not write into it: the stored
    K/V stays bit-for-bit what the prefill left, and the two requests give
    the same tokens."""
    toks = np.arange(40, 56, dtype=np.int32)[None, :]
    out_a, _ = engine.generate("olmo-1b", toks, max_new_tokens=6)
    logits, stored = _stored(engine, toks, 16 + 6)
    snap = {kv: stored["attn"][kv].clone() for kv in ("k", "v")}
    assert not snap["k"][:, :, 16:].any()      # the miss's decodes did not land here
    out_b, _ = engine.generate("olmo-1b", toks, max_new_tokens=6)
    np.testing.assert_array_equal(out_a, out_b)
    for kv, t in snap.items():
        assert torch.equal(stored["attn"][kv], t), kv
    hit_logits, hit_cache = engine.prefix_kv.lookup(prompt_key("olmo-1b", toks, 22))
    assert hit_logits is logits
    assert hit_cache["attn"]["k"].data_ptr() != stored["attn"]["k"].data_ptr()
    assert torch.equal(hit_cache["attn"]["k"], stored["attn"]["k"])


def test_concurrent_hits_decode_in_isolation(engine):
    """Threads decoding from one stored prefill at once all match."""
    import threading
    toks = np.arange(60, 76, dtype=np.int32)[None, :]
    want, _ = engine.generate("olmo-1b", toks, max_new_tokens=5)
    outs = [None] * 4

    def run(i):
        outs[i], _ = engine.generate("olmo-1b", toks, max_new_tokens=5)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts)
    for out in outs:
        np.testing.assert_array_equal(out, want)


def test_store_capacity_eviction():
    store = PrefixKVStore(capacity_bytes=100)
    big = {"k": torch.zeros((10, 4), dtype=torch.float32)}  # 160B > 100
    store.insert("a", None, big)
    assert store.lookup("a") is None  # larger than tier: served uncached
    small = {"k": torch.zeros((5,), dtype=torch.float32)}   # 20B
    store.insert("b", None, small)
    store.insert("c", None, small)
    assert store.lookup("b") is not None
    assert store.lookup("c") is not None
    for i in range(4):                # 6 x 20B: the oldest go first
        store.insert(f"d{i}", None, small)
    assert store.lookup("b") is None and store.lookup("d3") is not None
    assert store.tier.used <= 100


def test_prompt_key_distinct_and_as_jax():
    t1 = np.ones((1, 8), np.int32)
    t2 = np.ones((1, 8), np.int32)
    t3 = np.arange(8, dtype=np.int32)[None]
    assert prompt_key("m", t1, 16) == prompt_key("m", t2, 16)
    assert prompt_key("m", t1, 16) != prompt_key("m", t3, 16)
    assert prompt_key("m", t1, 16) != prompt_key("m2", t1, 16)
    assert prompt_key("m", t1, 16) != prompt_key("m", t1, 32)
    for t in (t1, t3):
        assert prompt_key("m", t, 16) == jax_prompt_key("m", t, 16)


def test_tokens_match_jax_engine_with_prefix_cache(published):
    root, cfg = published
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jeng = JaxInferenceEngine(JaxDiskStore(root),
                              JaxMRM(JaxDiskStore(root), device_capacity=1 << 30),
                              prefix_cache_bytes=64 << 20)
    mrm = MRM(DiskStore(root), device_capacity=1 << 30, host_capacity=1 << 30,
              hw=costmodel.HardwareModel(), device="cpu")
    eng = InferenceEngine(DiskStore(root), mrm, prefix_cache_bytes=64 << 20, device="cpu",
                          framework="repro-jax")
    for _ in range(2):                # a miss, then a hit, on both
        want, _ = jeng.generate("olmo-1b", toks, max_new_tokens=5)
        got, _ = eng.generate("olmo-1b", toks, max_new_tokens=5)
        np.testing.assert_array_equal(got, want)
    assert (eng.prefix_kv.misses, eng.prefix_kv.hits) == \
        (jeng.prefix_kv.misses, jeng.prefix_kv.hits) == (1, 1)

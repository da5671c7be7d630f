"""The port's serving engine on the SSM, HYBRID, VLM and ENCDEC families,
against the JAX engine over the same published store: tokens, tier hits,
MRM metrics and prefix hits, with layer streaming on (these families take
the batch path in both packages, so no stream is opened), and the serve CLI
publishing and serving each family on the CPU."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import MRM as JaxMRM
from repro.core import DiskStore as JaxDiskStore
from repro.core.costmodel import HardwareModel as JaxHardwareModel
from repro.models import init_params as jax_init_params
from repro.serving import InferenceEngine as JaxInferenceEngine
from repro.serving import publish_model as jax_publish_model
from repro.serving.weights_io import flat_to_params_like as jax_flat_to_params_like
from repro.serving.weights_io import params_to_flat as jax_params_to_flat
from repro_torch.core import costmodel
from repro_torch.core.mrm import MRM
from repro_torch.core.store import DiskStore
from repro_torch.launch import serve
from repro_torch.serving import InferenceEngine

ARCHS = ["mamba2-370m", "jamba-1.5-large-398b", "llama-3.2-vision-90b",
         "seamless-m4t-large-v2"]
METRICS = ("opens", "disk_loads", "h2d_stages", "bytes_from_disk", "stream_opens",
           "stream_loads", "partial_loads")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The four reduced models in float32, published by the JAX package;
    the VLM gates at 0.5, so that its cross layer is not the identity."""
    root = str(tmp_path_factory.mktemp("families"))
    disk = JaxDiskStore(root)
    cfgs = {}
    for i, arch in enumerate(ARCHS):
        cfg = jax_get_config(arch).reduced().replace(param_dtype="float32",
                                                     compute_dtype="float32")
        params = jax_init_params(cfg, jax.random.PRNGKey(i))
        flat = jax_params_to_flat(params)
        for n in flat:
            if n.endswith(("gate_attn", "gate_mlp")):
                flat[n] = np.full(flat[n].shape, 0.5, np.float32)
        jax_publish_model(disk, cfg, jax_flat_to_params_like(params, flat), name=arch)
        cfgs[arch] = cfg
    return root, cfgs


def _requests(eng, arch, toks, n=3):
    out = []
    for _ in range(n):
        got, st = eng.generate(arch, toks, max_new_tokens=5)
        out.append((got, st.tier_hit, st.streamed))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_tokens_tiers_metrics_and_prefix_hits_match_jax(store, arch):
    """Three requests (disk, device with a prefix hit, and again) through a
    streaming, prefix-caching engine in each package: equal tokens, tier
    hits, MRM metrics and prefix-store counts; no stream is opened."""
    root, cfgs = store
    toks = np.random.default_rng(3).integers(0, cfgs[arch].vocab_size, (2, 9)).astype(np.int32)
    jeng = JaxInferenceEngine(JaxDiskStore(root), JaxMRM(
        JaxDiskStore(root), device_capacity=1 << 30, host_capacity=1 << 30,
        hw=JaxHardwareModel()), streaming=True, prefix_cache_bytes=16 << 20)
    eng = InferenceEngine(DiskStore(root), MRM(
        DiskStore(root), device_capacity=1 << 30, host_capacity=1 << 30,
        hw=costmodel.HardwareModel(), device="cpu"), device="cpu", framework="repro-jax",
        streaming=True, prefix_cache_bytes=16 << 20)
    want, got = _requests(jeng, arch, toks), _requests(eng, arch, toks)
    for (w, wt, ws), (g, gt, gs) in zip(want, got):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.int32 and g.shape == (2, 5)
        assert (gt, gs) == (wt, ws)
    assert [t for _, t, _ in got] == ["disk", "device", "device"]
    js, ts = jeng.mrm.stats(), eng.mrm.stats()
    for m in METRICS:
        assert ts[m] == js[m], m
    assert ts["stream_opens"] == 0 and ts["disk_loads"] == 1
    assert (eng.prefix_kv.misses, eng.prefix_kv.hits) == \
        (jeng.prefix_kv.misses, jeng.prefix_kv.hits) == (1, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_hit_leaves_the_stored_state_untouched(store, arch):
    """The port decodes into its cache in place: a hit gets a clone of
    every leaf (K/V, SSM and conv states, cross K/V), and the stored tree
    stays equal to what the prefill wrote after the hit's decodes."""
    root, cfgs = store
    toks = np.random.default_rng(4).integers(0, cfgs[arch].vocab_size, (2, 9)).astype(np.int32)
    eng = InferenceEngine(DiskStore(root), MRM(
        DiskStore(root), device_capacity=1 << 30, host_capacity=1 << 30,
        hw=costmodel.HardwareModel(), device="cpu"), device="cpu", framework="repro-jax",
        prefix_cache_bytes=16 << 20)
    first, _ = eng.generate(arch, toks, max_new_tokens=5)
    (entry,) = eng.prefix_kv.tier.entries.values()
    stored = entry.payload[1]

    def leaves(tree, pre=""):
        for k, v in tree.items():
            yield from (leaves(v, f"{pre}{k}/") if isinstance(v, dict) else [(pre + k, v)])

    before = {n: t.clone() for n, t in leaves(stored)}
    want = {"ssm": {"mamba/ssm", "mamba/conv"}, "hybrid": {"attn/k", "mamba/ssm"},
            "vlm": {"self/k", "xk", "xv"}, "encdec": {"attn/v", "xk", "xv"}}
    assert want[cfgs[arch].family] <= before.keys()
    hit = eng.prefix_kv.lookup(entry.key)[1]
    assert all(a.data_ptr() != b.data_ptr() for (_, a), (_, b) in zip(
        leaves(hit), leaves(stored)))
    second, _ = eng.generate(arch, toks, max_new_tokens=5)
    np.testing.assert_array_equal(second, first)
    assert eng.prefix_kv.hits == 2
    for n, t in leaves(stored):
        assert torch.equal(t, before[n]), n


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_publishes_and_serves_each_family_on_cpu(tmp_path, capsys, arch):
    eng = serve.main(["--device", "cpu", "--store", str(tmp_path), "--arch", arch,
                      "--requests", "2", "--prompt-len", "8", "--max-new", "3"])
    out = capsys.readouterr().out
    assert f"store empty: publishing reduced {arch}" in out
    assert "req1: tier=device" in out and "1 disk loads" in out
    assert [s.tier_hit for s in eng.stats] == ["disk", "device"]
    meta = eng.disk.open(("repro-torch", arch, "1")).meta["config"]
    assert meta["family"] == jax_get_config(arch).family
    assert meta["moe_impl"] == ("ragged" if meta["n_experts"] else "capacity")

"""The port's FaaS platform (``repro_torch.core.faas``): the reference's
seven scenarios (sharing, entitlements, handle ownership, pipelines, teardown,
router affinity, the no-TrIMS baseline) on the port with ``device="cpu"``,
and greedy tokens of a function that loads a reduced dense model through
``ctx.load_model`` against the same function on the JAX package's platform
(tokens compared exactly)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import MRM as JaxMRM
from repro.core import DiskStore as JaxDiskStore
from repro.core import FaaSPlatform as JaxFaaSPlatform
from repro.models import init_params as jax_init_params
from repro.models import model as JM
from repro.serving import publish_model as jax_publish_model
from repro.serving.weights_io import flat_to_params_like as jax_flat_to_params_like
from repro_torch.configs import ModelConfig
from repro_torch.core import (DiskStore, FaaSPlatform, IsolationError, MRM, ModelKey,
                              ObjectStore, RequestContext, Router)
from repro_torch.models import model as M
from repro_torch.serving.weights_io import flat_to_params_like

MB = 1 << 20


def _tensors(nbytes=1 * MB, n=4, seed=0):
    rng = np.random.default_rng(seed)
    per = nbytes // n // 4
    return {f"w{i}": rng.standard_normal(per).astype(np.float32) for i in range(n)}


def _mrm(disk, **kw):
    kw.setdefault("device_capacity", 64 * MB)
    return MRM(disk, device="cpu", **kw)


@pytest.fixture
def platform(tmp_path):
    disk = DiskStore(str(tmp_path / "disk"))
    for name, seed in (("alexnet", 1), ("scene", 2), ("tts", 3)):
        disk.put(ModelKey("jax", name), _tensors(seed=seed))
    return FaaSPlatform(_mrm(disk, host_capacity=256 * MB))


def test_sharing_across_containers(platform):
    """Two isolated functions using the same model trigger ONE load, and
    both hold the same device storage."""
    ptrs = []

    def fn(ctx, payload):
        m = ctx.load_model("jax", "alexnet")
        ptrs.append(m.weights["w0"].data_ptr())
        return float(m.weights["w0"].sum())

    platform.deploy("user_a", fn)
    platform.deploy("user_b", fn)
    assert platform.invoke("user_a") == platform.invoke("user_b")
    assert platform.mrm.stats()["disk_loads"] == 1
    assert platform.mrm.refcount(ModelKey("jax", "alexnet")) == 2
    assert ptrs[0] == ptrs[1]
    assert platform.device == torch.device("cpu")


def test_isolation_entitlements(platform):
    platform.deploy("restricted", lambda ctx, p: ctx.load_model("jax", "scene"),
                    allowed_models=[("jax", "alexnet")])
    with pytest.raises(IsolationError):
        platform.invoke("restricted")


def test_handles_do_not_cross_containers(platform):
    captured = {}

    def fn_a(ctx, payload):
        captured["model"] = ctx.load_model("jax", "alexnet")
        captured["ctx"] = ctx

    platform.deploy("a", fn_a)
    platform.deploy("b", lambda ctx, p: ctx.owns(captured["model"]))
    platform.invoke("a")
    assert captured["ctx"].owns(captured["model"])
    assert platform.invoke("b") is False


def test_pipeline_and_cold_vs_warm(platform):
    def stage(name):
        def fn(ctx, payload):
            ctx.load_model("jax", name)
            return payload + [name]
        return fn

    platform.deploy("s1", stage("alexnet"))
    platform.deploy("s2", stage("scene"))
    assert platform.invoke_pipeline(["s1", "s2"], []) == ["alexnet", "scene"]
    cold = sum(platform.containers[s].acct.latencies[0] for s in ("s1", "s2"))
    assert platform.invoke_pipeline(["s1", "s2"], []) == ["alexnet", "scene"]
    warm = sum(platform.containers[s].acct.latencies[1] for s in ("s1", "s2"))
    assert warm <= cold


def test_teardown_releases_refs(platform):
    platform.deploy("f", lambda ctx, p: ctx.load_model("jax", "alexnet"))
    platform.invoke("f")
    assert platform.mrm.refcount(ModelKey("jax", "alexnet")) == 1
    platform.undeploy("f")
    assert platform.mrm.refcount(ModelKey("jax", "alexnet")) == 0


def test_router_affinity(tmp_path):
    nodes = []
    for i in range(2):
        disk = DiskStore(str(tmp_path / f"disk{i}"))
        disk.put(ModelKey("jax", "m"), _tensors(seed=i))
        node = FaaSPlatform(_mrm(disk), name=f"node{i}")
        node.deploy("f", lambda ctx, p: ctx.load_model("jax", "m").nbytes)
        nodes.append(node)
    router = Router(nodes)
    router.invoke("f", needed_models=[("jax", "m", "1")])
    warm_node = max(nodes, key=lambda n: len(n.advertised_models()))
    assert router.route("f", [("jax", "m", "1")]) is warm_node
    assert router.dispatches[warm_node.name] == 1


def test_no_trims_fallback_counts_cold_starts(tmp_path):
    disk = DiskStore(str(tmp_path / "disk"))
    disk.put(ModelKey("jax", "m"), _tensors())
    obj = ObjectStore(str(tmp_path / "cloud"))
    obj.put(ModelKey("jax", "cloudy"), _tensors(seed=5))
    platform = FaaSPlatform(mrm=None, disk=disk, objectstore=obj, device="cpu")

    def fn(ctx, payload):
        m = ctx.load_model("jax", payload)
        assert m.weights["w0"].device.type == "cpu"
        ctx.unload_model(m)  # private copy destroyed at request end

    platform.deploy("f", fn, use_trims=False)
    for name in ("m", "m", "cloudy"):
        platform.invoke("f", name)
    assert platform.containers["f"].acct.cold_starts == 3
    assert platform.can_resolve(ModelKey("jax", "cloudy"))
    if not torch.cuda.is_available():   # no MRM and no device given: CUDA, absent here
        cold = FaaSPlatform(mrm=None, disk=disk)
        cold.deploy("g", fn, use_trims=False)
        with pytest.raises(RuntimeError, match="CUDA"):
            cold.invoke("g", "m")


# ---------------------------------------------------------------- tokens

NEW = 4


def _port_generate(cfg, weights, toks):
    params = flat_to_params_like(M.init_params(cfg, device="meta"), weights)
    t = torch.as_tensor(toks, dtype=torch.long)
    S = toks.shape[1]
    logits, cache = M.prefill(cfg, params, {"tokens": t}, max_len=S + NEW)
    tok = logits.argmax(-1)
    out = [tok]
    for i in range(NEW - 1):
        logits, cache = M.decode_step(cfg, params, cache, tok, S + i)
        tok = logits.argmax(-1)
        out.append(tok)
    return torch.stack(out, 1).numpy().astype(np.int32)


def _jax_generate(cfg, weights, toks):
    template = jax.eval_shape(lambda k: JM.init_params(cfg, k), jax.random.PRNGKey(0))
    params = jax_flat_to_params_like(template, weights,
                                     convert=lambda v: v if hasattr(v, "devices")
                                     else jnp.asarray(v))
    S = toks.shape[1]
    logits, cache = JM.prefill(cfg, params, {"tokens": jnp.asarray(toks)}, S + NEW)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out = [tok]
    for i in range(NEW - 1):
        logits, cache = JM.decode_step(cfg, params, cache, tok, jnp.int32(S + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.stack(out, axis=1))


def test_function_tokens_match_jax_faas(tmp_path):
    """One function body per package, deployed in two containers of two
    tenants: both invocations give the JAX platform's tokens, the second
    is a device hit on the same storage, and teardown drops the refs."""
    jcfg = jax_get_config("deepseek-7b").reduced().replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    root = str(tmp_path / "store")
    jax_publish_model(JaxDiskStore(root), jcfg, jax_init_params(jcfg, jax.random.PRNGKey(3)),
                      name="ds")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    jplat = JaxFaaSPlatform(JaxMRM(JaxDiskStore(root), device_capacity=1 << 30))
    jplat.deploy("gen", lambda ctx, p: _jax_generate(jcfg, ctx.load_model("repro-jax", "ds")
                                                     .weights, p),
                 allowed_models=[("repro-jax", "ds")])
    want = jplat.invoke("gen", toks)

    disk = DiskStore(root)
    cfg = ModelConfig(**dict(disk.open(ModelKey("repro-jax", "ds", "1")).meta["config"]))
    plat = FaaSPlatform(_mrm(disk, device_capacity=1 << 30, host_capacity=1 << 30))
    seen = []

    def fn(ctx, payload):
        m = ctx.load_model("repro-jax", "ds")
        seen.append((m.timings.tier_hit, m.weights["embed"].data_ptr()))
        return _port_generate(cfg, m.weights, payload)

    for tenant in ("t1", "t2"):
        plat.deploy(f"gen-{tenant}", fn, allowed_models=[("repro-jax", "ds")])
    for tenant in ("t1", "t2"):
        got = plat.invoke(f"gen-{tenant}", toks, ctx=RequestContext(tenant=tenant))
        np.testing.assert_array_equal(got, want)
    # deploy prewarms the entitled model, so the first open may already find it
    assert seen[0][0] in ("disk", "device") and seen[1][0] == "device"
    assert seen[0][1] == seen[1][1]
    assert sorted(plat.tenant_acct) == ["t1", "t2"]
    key = ModelKey("repro-jax", "ds", "1")
    assert plat.mrm.refcount(key) == 2
    for tenant in ("t1", "t2"):
        plat.undeploy(f"gen-{tenant}")
    assert plat.mrm.refcount(key) == 0

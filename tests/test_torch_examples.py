"""The port's four examples (``examples_torch/``) against the JAX package's
(``examples/``), on the CPU.

Each JAX script runs as its own ``__main__`` (``runpy``, its temporary
directories under ``tmp_path``); spies on the JAX classes it uses record what
it computed. The port's script runs through its work function ``run`` with
``device="cpu"``, under the same spies on the port's classes.

- quickstart: the MRM's ``opens``/``disk_loads``/``coalesced_loads`` and the
  two opens' tier hits (disk, then device) equal; the handles share one
  buffer.
- faas_pipeline: the pipeline's ``label`` and ``scene`` within 1e-5
  relative of the JAX values (``scene``, a mean of tanh outputs that nearly
  cancel, within 1e-5 of the largest |tanh| it averages, 1); ``disk_loads``,
  ``opens``, AlexNet's refcount and each container's invocations equal.
- serve_llm: the JAX script's weights (``init_params(cfg, PRNGKey(0))``)
  published as the JAX script does, under the port's framework name, and
  handed to the port's script: tier hits per sequential request, the worker
  pool's ``disk_loads`` and every request's greedy tokens equal.
- train_small (``--steps 12``, failure at step 6): from one JAX checkpoint
  of the JAX script's own initial state (step 0) in float32, the port's
  losses within 1e-4 relative of the JAX Trainer's, one restart each; at the
  script's own dtype (bf16) one restart and a falling loss.
- Without ``--device cpu`` and without a card, each script raises.
"""
import dataclasses
import importlib.util
import itertools
import runpy
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.configs
import repro.core
from repro.core import faas as jax_faas
from repro.core import mrm as jax_mrm
from repro.core.store import DiskStore as JaxDiskStore
from repro.launch import train as jax_train
from repro.serving import engine as jax_engine
from repro_torch.core import faas as port_faas
from repro_torch.core.store import DiskStore
from repro_torch.serving import engine as port_engine

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ("quickstart", "faas_pipeline", "serve_llm", "train_small")
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spy(monkeypatch, owner, attr):
    """Record ``(args, result)`` of every call of ``owner.attr``."""
    calls = []
    orig = getattr(owner, attr)

    def wrapper(*a, **k):
        r = orig(*a, **k)
        calls.append((a, r))
        return r

    monkeypatch.setattr(owner, attr, wrapper)
    return calls


def _run_jax_script(name, monkeypatch, tmp_path, *argv):
    """``examples/<name>.py`` as ``__main__``, its temporary directories
    under ``tmp_path``."""
    n = itertools.count()

    def mkdtemp(prefix="tmp", **_):
        d = tmp_path / f"{prefix}{next(n)}"
        d.mkdir(parents=True)
        return str(d)

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")


def test_quickstart_matches_jax(monkeypatch, tmp_path):
    loads = _spy(monkeypatch, repro.core, "load_model")
    mrms = _spy(monkeypatch, jax_mrm.MRM, "__init__")
    _run_jax_script("quickstart", monkeypatch, tmp_path / "jax")
    jmrm = mrms[0][0][0]
    want_stats = {k: v for k, v in jmrm.stats().items()
                  if k in ("opens", "disk_loads", "coalesced_loads")}
    want_hits = [m.timings.tier_hit for _, m in loads]

    out = _example("quickstart").run(device="cpu", disk=DiskStore(str(tmp_path / "port")))
    assert out["stats"] == want_stats == {"opens": 2, "disk_loads": 1, "coalesced_loads": 0}
    assert [m.timings.tier_hit for m in out["trims"]] == want_hits == ["disk", "device"]
    assert out["cold"].timings.tier_hit == "none(cold)"
    m1, m2 = out["trims"]
    assert all(m1.weights[n] is m2.weights[n] for n in m1.weights)
    assert out["mrm"].refcount(m1.key) == 2


def _faas_record(invokes):
    rec = {}
    for (self, name, *_), r in invokes:
        if isinstance(r, dict):
            rec.setdefault(name, r)
    return rec


def test_faas_pipeline_matches_jax(monkeypatch, tmp_path):
    jinv = _spy(monkeypatch, jax_faas.FaaSPlatform, "invoke")
    _run_jax_script("faas_pipeline", monkeypatch, tmp_path / "jax")
    jplat = jinv[0][0][0]
    pinv = _spy(monkeypatch, port_faas.FaaSPlatform, "invoke")
    out = _example("faas_pipeline").run(device="cpu", disk=DiskStore(str(tmp_path / "port")))
    plat = out["platform"]
    assert pinv[0][0][0] is plat

    want, got = _faas_record(jinv), _faas_record(pinv)
    assert set(got) == set(want) == {"tenant_a/classify", "tenant_b/classify", "scene"}
    for fn in ("tenant_a/classify", "tenant_b/classify"):
        np.testing.assert_allclose(got[fn]["label"], want[fn]["label"], rtol=1e-5)
    np.testing.assert_allclose(got["scene"]["scene"], want["scene"]["scene"], rtol=1e-5,
                               atol=1e-5)
    assert got["scene"]["label"] == got["tenant_a/classify"]["label"]
    assert [r for (_, name, *_), r in pinv if name == "tts"] == \
        [r for (_, name, *_), r in jinv if name == "tts"]

    jstats, stats = jplat.mrm.stats(), out["stats"]
    assert (stats["disk_loads"], stats["opens"]) == (jstats["disk_loads"], jstats["opens"]) \
        == (3, 4)
    assert out["alexnet_refcount"] == jplat.mrm.refcount(
        jax_mrm.ModelKey("repro-jax", "AlexNet", "1")) == 2
    assert {n: c.acct.invocations for n, c in plat.containers.items()} == \
        {n: c.acct.invocations for n, c in jplat.containers.items()}
    with pytest.raises(port_faas.IsolationError):
        plat.containers["scene"].load_model("repro-torch", "AlexNet")


def _by_engine(inits, gens):
    """Each engine's requests, in the order the engines were made: a list of
    (engine, [(tokens, stats), ...])."""
    engines = [a[0] for a, _ in inits]
    return [(e, [r for a, r in gens if a[0] is e]) for e in engines]


def test_serve_llm_matches_jax(monkeypatch, tmp_path):
    from repro.models import init_params as jax_init_params
    from repro.serving.weights_io import params_to_flat as jax_params_to_flat
    import jax

    jinit = _spy(monkeypatch, jax_engine.InferenceEngine, "__init__")
    jgen = _spy(monkeypatch, jax_engine.InferenceEngine, "generate")
    _run_jax_script("serve_llm", monkeypatch, tmp_path / "jax")
    jax_runs = _by_engine(jinit, jgen)

    # the JAX script's weights, published under the port's framework name
    cfg = repro.configs.get_config("olmo-1b").reduced()
    JaxDiskStore(str(tmp_path / "store")).put(
        jax_mrm.ModelKey("repro-torch", "olmo-1b", "1"),
        jax_params_to_flat(jax_init_params(cfg, jax.random.PRNGKey(0))),
        meta={"config": dataclasses.asdict(cfg)})
    pinit = _spy(monkeypatch, port_engine.InferenceEngine, "__init__")
    pgen = _spy(monkeypatch, port_engine.InferenceEngine, "generate")
    out = _example("serve_llm").run(device="cpu", disk=DiskStore(str(tmp_path / "store")))
    port_runs = _by_engine(pinit, pgen)

    assert len(port_runs) == len(jax_runs) == 3
    for (_, p), (_, j) in zip(port_runs[:2], jax_runs[:2]):
        assert [st.tier_hit for _, st in p] == [st.tier_hit for _, st in j]
    assert [st.tier_hit for _, st in port_runs[1][1]] == ["disk"] + ["device"] * 3
    assert {st.tier_hit for _, st in port_runs[0][1]} == {"none(cold)"}
    assert len(port_runs[2][1]) == len(jax_runs[2][1]) == 8 == out["concurrent_ok"]
    assert out["disk_loads"] == jax_runs[2][0].mrm.stats()["disk_loads"] == 1
    want = jax_runs[0][1][0][0]
    for _, runs in port_runs + jax_runs:
        for toks, _ in runs:
            np.testing.assert_array_equal(np.asarray(toks), want)


def test_train_small_matches_jax_from_one_checkpoint(monkeypatch, tmp_path):
    from repro.checkpoint import CheckpointManager as JaxCheckpointManager
    from repro_torch.configs import get_config

    def f32(cfg):
        return cfg.reduced().replace(d_model=128, n_heads=4, d_head=32, d_ff=512,
                                     n_layers=4, remat_policy="none", **F32)

    get = repro.configs.get_config
    monkeypatch.setattr(repro.configs, "get_config", lambda a: get(a).replace(**F32))
    runs = _spy(monkeypatch, jax_train.Trainer, "run_with_restarts")
    _run_jax_script("train_small", monkeypatch, tmp_path / "jax", "--steps", "12")
    (jtr, *_), jout = runs[0]
    assert jtr.cfg == f32(get("olmo-1b"))

    # the JAX script's initial state (PRNGKey(0)) as a step-0 checkpoint
    state, _ = jtr.init_state()
    mgr = JaxCheckpointManager(str(tmp_path / "port" / "ckpt"), every=20)
    mgr.save(0, state, force=True)
    mgr.wait()
    out = _example("train_small").run(steps=12, device="cpu", cfg=f32(get_config("olmo-1b")),
                                      root=str(tmp_path / "port"))
    assert out["restarts"] == jtr.restarts == 1
    jh = jout["history"]
    assert [h["step"] for h in out["history"]] == [h["step"] for h in jh] == list(range(12))
    for a, b in zip(out["history"], jh):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=f"{k} step {b['step']}")
    assert out["stats"].tier_hit == "disk" and out["tokens"].shape == (1, 8)


def test_train_small_at_its_own_dtype(tmp_path):
    out = _example("train_small").run(steps=12, device="cpu", root=str(tmp_path))
    assert out["cfg"].param_dtype == "bfloat16"
    assert out["restarts"] == 1 and len(out["losses"]) == 12
    assert out["losses"][-1] < out["losses"][0]


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_needs_a_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(name).main([])

"""Expert parallelism (``moe_impl="ep"``) of the port on a 2x2 gloo mesh (4
processes, a ``FileStore`` under ``tmp_path``), with the config of
``tests/test_moe_ep.py`` (reduced qwen3-moe, 4 experts, top 2, capacity
factor 4: no drops), float32:

- the EP output equals the port's ragged path within that test's bound
  (5e-2; the float32 difference is far below it) and its aux loss within
  1e-3;
- it equals the JAX package's ``moe_ep_shardmap`` on its (2, 2) fake mesh
  (a subprocess with 4 host devices) within 1e-5, aux loss included;
- the gradients of ``out.sum()`` for every weight are finite and within
  1e-5 of JAX's, relative to each leaf's largest value (the router's
  gradient reaches ~100).
"""
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

JAX_EP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.launch.mesh import make_mesh, set_mesh
    from repro.models.moe import apply_moe, init_moe
    from repro.models import partitioning as part

    mesh = make_mesh((2, 2), ("data", "model"))
    cfg = get_config("qwen3-moe-30b-a3b").reduced().replace(
        n_experts=4, top_k=2, capacity_factor=4.0, param_dtype="float32",
        compute_dtype="float32")
    p = init_moe(cfg, jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 16, cfg.d_model), jnp.float32)
    ep = cfg.replace(moe_impl="ep")
    with part.activation_axes("data", "model"), set_mesh(mesh):
        oe, ae = jax.jit(lambda p, x: apply_moe(ep, p, x))(p, x)
        g = jax.jit(jax.grad(lambda p, x: apply_moe(ep, p, x)[0].sum()))(p, x)
    np.savez(sys.argv[1], x=np.asarray(x), out=np.asarray(oe), aux=np.asarray(ae),
             **{"p_" + k: np.asarray(v) for k, v in p.items()},
             **{"g_" + k: np.asarray(v) for k, v in g.items()})
""")


def spawn(fn, world, *args, timeout=240):
    """``fn(rank, world, *args)`` in ``world`` spawned processes."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.time() + timeout
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} did not finish in {timeout} s")


def _cfg():
    from repro_torch.configs import get_config
    return get_config("qwen3-moe-30b-a3b").reduced().replace(
        n_experts=4, top_k=2, capacity_factor=4.0, param_dtype="float32",
        compute_dtype="float32")


def _ranks(rank, world, store, npz, out_path):
    import torch.distributed as dist
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import act_axes, make_mesh, set_mesh
    from repro_torch.models import moe as MoE
    from repro_torch.models import partitioning as part
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        cfg = _cfg()
        ref = np.load(npz)
        p = {k[2:]: torch.from_numpy(ref[k]) for k in ref.files if k.startswith("p_")}
        x = torch.from_numpy(ref["x"])
        sh = shd.make_param_shardings(cfg, {"ffn": p}, mesh)["ffn"]
        pd = {k: shd.place(v, sh[k]).requires_grad_() for k, v in p.items()}
        xd = shd.place(x, shd.NamedSharding(mesh, shd.batch_leaf_spec(x, mesh)))
        with part.activation_axes(*act_axes(mesh)), set_mesh(mesh):
            out, aux = MoE.apply_moe(cfg.replace(moe_impl="ep"), pd, xd)
            grads = torch.autograd.grad(out.sum(), list(pd.values()))
            again, _ = MoE.apply_moe(cfg.replace(moe_impl="ep"), pd, xd)
        res = {"out": out.full_tensor().detach().numpy().tolist(),
               "aux": float(aux.full_tensor()),
               "rerun_equal": bool(torch.equal(out.full_tensor(), again.full_tensor())),
               "grads": {k: g.full_tensor().numpy().tolist() for k, g in zip(pd, grads)}}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    npz = str(tmp / "jax.npz")
    r = subprocess.run([sys.executable, "-c", JAX_EP, npz], cwd=ROOT, capture_output=True,
                       text=True, timeout=400)
    assert r.returncode == 0, r.stderr[-2000:]
    spawn(_ranks, 4, str(tmp / "store"), npz, str(tmp / "port.json"))
    with open(tmp / "port.json") as f:
        port = json.load(f)
    return np.load(npz), port


def test_ep_equals_the_ragged_path(runs):
    from repro_torch.models import moe as MoE
    ref, port = runs
    cfg = _cfg()
    p = {k[2:]: torch.from_numpy(ref[k]) for k in ref.files if k.startswith("p_")}
    out, aux = MoE.apply_moe(cfg.replace(moe_impl="ragged"), p, torch.from_numpy(ref["x"]))
    assert np.abs(np.array(port["out"]) - out.numpy()).max() < 5e-2
    assert abs(port["aux"] - float(aux)) < 1e-3
    assert port["rerun_equal"]


def test_ep_equals_jax_ep(runs):
    ref, port = runs
    assert np.abs(np.array(port["out"]) - ref["out"]).max() < 1e-5
    assert abs(port["aux"] - float(ref["aux"])) < 1e-5


def test_ep_gradients_equal_jax(runs):
    ref, port = runs
    for k, g in port["grads"].items():
        g = np.array(g)
        assert np.isfinite(g).all(), k
        want = ref["g_" + k]
        assert np.abs(g - want).max() < 1e-5 * max(1.0, np.abs(want).max()), k

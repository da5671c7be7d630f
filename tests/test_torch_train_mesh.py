"""Training through a device mesh: the port's Trainer on a 2x2 gloo mesh
(4 processes, a ``FileStore`` under ``tmp_path``) against the single-rank
port Trainer and the JAX Trainer, and checkpoints across meshes and
packages.

- A reduced olmo-1b and a reduced qwen3-moe (float32; qwen3-moe's
  capacity path, grad_accum 4, and its ``"ep"`` path) train 3 steps on the
  mesh, resuming a checkpoint the JAX Trainer wrote after its first 3
  steps (the two packages draw different initial weights): losses and grad
  norms within 1e-5 relative of the single-rank port Trainer's and the JAX
  Trainer's, each resuming its own copy of that checkpoint (float32, other
  sum orders).
- Each rank's batch rows equal its slice of the global batch (exact).
- A checkpoint saved on the 2x2 mesh restores onto a (4, 1) mesh and onto
  one rank with equal state (exact), and a checkpoint the JAX Trainer wrote
  restores onto the 2x2 mesh with every leaf equal to the file's (exact).
"""
import json
import time

import numpy as np
import pytest
import torch

F32 = dict(param_dtype="float32", compute_dtype="float32")
KW = dict(batch_size=8, seq_len=32, log_every=100, warmup=2)
CASES = (("olmo-1b", {}), ("qwen3-moe-30b-a3b", {}), ("qwen3-moe-30b-a3b", {"moe_impl": "ep"}))


def spawn(fn, world, *args, timeout=300):
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


def _cfg(arch, over):
    from repro_torch.configs import get_config
    return get_config(arch).reduced().replace(**F32, **over)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _state(res):
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731
    return {**{"p/" + k: full(v) for k, v in _flat(res["params"]).items()},
            **{"m/" + k: full(v) for k, v in _flat(res["opt"].mu).items()},
            **{"v/" + k: full(v) for k, v in _flat(res["opt"].nu).items()}}


def _tag(arch, over):
    return f"{arch}_{over.get('moe_impl', 'default')}"


def _ranks(rank, world, store, tmp):
    import torch.distributed as dist
    from repro_torch.checkpoint import restore_into
    from repro_torch.data.pipeline import make_batch, make_batch_numpy
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import Trainer, TrainerConfig
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        out = {}
        for arch, over in CASES:
            cfg = _cfg(arch, over)
            ckpt = f"{tmp}/mesh_{_tag(arch, over)}"
            tr = Trainer(cfg, TrainerConfig(ckpt_dir=ckpt, ckpt_every=100, steps=6, **KW),
                         device="cpu", mesh=mesh)
            res = tr.run()
            out[f"{arch}/{over}"] = [(h["loss"], h["grad_norm"]) for h in tr.history]
            if over:
                continue
            saved = _state(res)
            # the same checkpoint onto a (4, 1) mesh
            mesh41 = make_mesh((4, 1), ("data", "model"), "cpu")
            tr41 = Trainer(cfg, TrainerConfig(ckpt_dir=ckpt, steps=6, **KW), device="cpu",
                           mesh=mesh41)
            state, step = tr41.restore_or_init()
            assert step == 6
            p = state["params"]
            some = next(iter(_flat(p).values()))
            assert tuple(some.device_mesh.shape) == (4, 1)
            got = {**{"p/" + k: v.full_tensor() for k, v in _flat(p).items()},
                   **{"m/" + k: v.full_tensor() for k, v in _flat(state["opt_mu"]).items()},
                   **{"v/" + k: v.full_tensor() for k, v in _flat(state["opt_nu"]).items()}}
            assert all(torch.equal(got[k], saved[k]) for k in saved), (arch, rank, [(k, (got[k] - saved[k]).abs().max().item()) for k in saved if not torch.equal(got[k], saved[k])][:6])
            if rank == 0:
                torch.save(saved, f"{tmp}/saved_{arch}.pt")
        # each rank's rows of a sharded batch
        cfg = _cfg("olmo-1b", {})
        sh = shd.NamedSharding(mesh, shd.batch_spec(mesh))
        b = make_batch(cfg, 5, 8, 32, device="cpu", sharding=sh)
        whole = make_batch_numpy(cfg, 5, 8, 32)
        d = mesh.get_coordinate()[0]
        for k, v in b.items():
            assert np.array_equal(v.to_local().numpy(), whole[k][d * 4:(d + 1) * 4]), k
            assert torch.equal(v.full_tensor(), torch.from_numpy(whole[k]))
        # the JAX Trainer's checkpoint onto the 2x2 mesh
        from repro_torch.checkpoint.checkpoint import _read
        jax_ckpt = f"{tmp}/jax_first_{_tag('olmo-1b', {})}"
        tr = Trainer(cfg, TrainerConfig(ckpt_dir=jax_ckpt, steps=6, **KW), device="cpu",
                     mesh=mesh)
        template, _ = tr.init_state(device="meta")
        step, state = restore_into(template, jax_ckpt, device="cpu",
                                   shardings=tr.state_shardings(template))
        _, flat = _read(jax_ckpt, step)
        for k, v in _flat(state["params"]).items():
            assert torch.equal(v.full_tensor(), torch.from_numpy(np.asarray(
                flat["params/" + k]))), k
        if rank == 0:
            with open(f"{tmp}/mesh.json", "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX Trainer's first 3 steps into a checkpoint, copied for each
    resumed run: JAX's, the single-rank port's, then the four ranks'."""
    import shutil
    from repro.configs import get_config as jax_get_config
    from repro.launch.train import Trainer as JaxTrainer
    from repro.launch.train import TrainerConfig as JaxTrainerConfig
    from repro_torch.launch.train import Trainer, TrainerConfig
    tmp = tmp_path_factory.mktemp("mesh")
    jax_hist, single = {}, {}
    for arch, over in CASES:
        key = f"{arch}/{over}"
        jover = {"moe_impl": "grouped"} if over.get("moe_impl") == "ep" else over
        jcfg = jax_get_config(arch).reduced().replace(**F32, **jover)
        first = tmp / f"jax_first_{_tag(arch, over)}"
        JaxTrainer(jcfg, JaxTrainerConfig(ckpt_dir=str(first), steps=3, **KW)).run()
        for d in ("jax", "port", "mesh"):
            shutil.copytree(first, tmp / f"{d}_{_tag(arch, over)}")
        jt = JaxTrainer(jcfg, JaxTrainerConfig(ckpt_dir=str(tmp / f"jax_{_tag(arch, over)}"),
                                               steps=6, **KW))
        jt.run()
        jax_hist[key] = [(h["loss"], h["grad_norm"]) for h in jt.history]
        tr = Trainer(_cfg(arch, over), TrainerConfig(
            ckpt_dir=str(tmp / f"port_{_tag(arch, over)}"), steps=6, **KW), device="cpu")
        res = tr.run()
        single[key] = [(h["loss"], h["grad_norm"]) for h in tr.history]
        if not over:
            single[arch + "/state"] = _state(res)
    spawn(_ranks, 4, str(tmp / "store"), str(tmp))
    with open(tmp / "mesh.json") as f:
        mesh = json.load(f)
    return {"jax": jax_hist, "single": single, "mesh": mesh, "tmp": tmp}


@pytest.mark.parametrize("arch,over", CASES)
def test_mesh_training_equals_single_rank_and_jax(runs, arch, over):
    key = f"{arch}/{over}"
    mesh = np.array(runs["mesh"][key])
    for ref in (runs["single"][key], runs["jax"][key]):
        np.testing.assert_allclose(mesh, np.array(ref), rtol=1e-5, atol=0)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-moe-30b-a3b"])
def test_mesh_checkpoint_restores_on_one_rank(runs, arch):
    """The 2x2 mesh's checkpoint restored by a Trainer without a mesh
    equals the state the mesh saved."""
    from repro_torch.launch.train import Trainer, TrainerConfig
    tmp = runs["tmp"]
    saved = torch.load(tmp / f"saved_{arch}.pt")
    tr = Trainer(_cfg(arch, {}), TrainerConfig(ckpt_dir=str(tmp / f"mesh_{arch}_default"),
                                               steps=6, **KW), device="cpu")
    state, step = tr.restore_or_init()
    assert step == 6
    got = {**{"p/" + k: v for k, v in _flat(state["params"]).items()},
           **{"m/" + k: v for k, v in _flat(state["opt_mu"]).items()},
           **{"v/" + k: v for k, v in _flat(state["opt_nu"]).items()}}
    assert set(got) == set(saved)
    assert all(torch.equal(got[k], saved[k]) for k in saved)

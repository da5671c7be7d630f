"""Cross-pod int8 gradient compression of the port (``runtime/compression.py``)
on 8 gloo ranks, a (2, 2, 2) ("pod", "data", "model") mesh, with the loss
and data of ``tests/test_compression_mesh.py`` (taken from the JAX
package's own run, a subprocess with 8 host devices, which also gives its
compressed gradient):

- the port's compressed gradient is within scale/2 of the exact one, where
  scale is the wire scale: max over pods of |that pod's gradient| / 127
  (each pod's error is at most scale/2; their mean is too);
- it is within one quantum (that scale) of the JAX package's compressed
  gradient;
- every tensor handed to ``all_gather_into_tensor`` is int8.
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

JAX_RUN = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch.mesh import make_mesh, set_mesh
    from repro.runtime.compression import make_compressed_grad_fn

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return jnp.mean((pred - batch["y"]) ** 2)

    k = jax.random.PRNGKey(0)
    params = {"w": jax.random.normal(k, (16, 4), jnp.float32)}
    batch = {"x": jax.random.normal(k, (8, 16), jnp.float32),
             "y": jax.random.normal(k, (8, 4), jnp.float32)}
    grad_fn = make_compressed_grad_fn(loss_fn, mesh, pod_axis="pod")
    with set_mesh(mesh):
        g_comp = jax.jit(grad_fn)(params, batch)
    np.savez(sys.argv[1], w=np.asarray(params["w"]), x=np.asarray(batch["x"]),
             y=np.asarray(batch["y"]), g_comp=np.asarray(g_comp["w"]),
             g_exact=np.asarray(jax.grad(loss_fn)(params, batch)["w"]))
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


def loss_fn(params, batch):
    pred = batch["x"] @ params["w"]
    return torch.mean((pred - batch["y"]) ** 2)


def _ranks(rank, world, store, npz, out_path):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.compression import make_compressed_grad_fn
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        ref = np.load(npz)
        wire = []
        gather = dist.all_gather_into_tensor

        def recording(out, inp, *a, **k):
            wire.append(str(inp.dtype))
            return gather(out, inp, *a, **k)

        dist.all_gather_into_tensor = recording
        try:
            g = make_compressed_grad_fn(loss_fn, mesh, "pod")(
                {"w": torch.from_numpy(ref["w"])},
                {"x": torch.from_numpy(ref["x"]), "y": torch.from_numpy(ref["y"])})
        finally:
            dist.all_gather_into_tensor = gather
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump({"g": g["w"].numpy().tolist(), "wire": wire}, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comp")
    npz = str(tmp / "jax.npz")
    r = subprocess.run([sys.executable, "-c", JAX_RUN, npz], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    spawn(_ranks, 8, str(tmp / "store"), npz, str(tmp / "port.json"))
    with open(tmp / "port.json") as f:
        port = json.load(f)
    ref = np.load(npz)
    # the wire scale: max over pods of |the pod's gradient| / 127
    w = torch.from_numpy(ref["w"])
    per_pod = []
    for p in range(2):
        wl = w.clone().requires_grad_()
        b = {k: torch.from_numpy(ref[k])[4 * p:4 * (p + 1)] for k in ("x", "y")}
        per_pod.append(torch.autograd.grad(loss_fn({"w": wl}, b), wl)[0])
    scale = max(g.abs().max().item() for g in per_pod) / 127
    return ref, port, scale


def test_compressed_gradient_within_half_a_quantum(runs):
    ref, port, scale = runs
    exact = ref["g_exact"]
    assert np.abs(np.array(port["g"]) - exact).max() <= scale / 2 + 1e-7


def test_compressed_gradient_equals_jax_within_one_quantum(runs):
    ref, port, scale = runs
    assert np.abs(np.array(port["g"]) - ref["g_comp"]).max() <= scale


def test_wire_is_int8(runs):
    _, port, _ = runs
    assert port["wire"] and set(port["wire"]) == {"torch.int8"}

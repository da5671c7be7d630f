"""Activation constraints (``models/partitioning.py``) and the kernels'
local-shard route (``kernels/ops.py``) of the port.

- With no axes registered, or no mesh, or a plain tensor, every
  ``shard_*`` returns its input: the same object.
- On a 2x2 gloo mesh (4 processes, a ``FileStore`` under ``tmp_path``),
  each call gives the placements of the reference's ``PartitionSpec`` for
  that shape (divisible and non-divisible cases) and leaves the values as
  they were (exact).
- On that mesh, flash attention, RMSNorm and decode attention on DTensors
  (heads on ``model``, batch on ``data``; 2 KV heads for 8 query heads and
  1 KV head, so ranks pick their KV heads; RMSNorm also of partial sums
  over ``model``) equal the plain versions on
  the whole tensors (float32, 1e-5 absolute: other sum orders), and so do
  the gradients of q, k, v, x and the scale (1e-5 of each gradient's
  largest value; 1e-4 for the scale's, a sum over every row).
"""
import time

import pytest
import torch

from repro_torch.models import partitioning as part

SHARD_FNS = [
    ("shard_btd", (8, 16, 12), (), ("data", None, None)),
    ("shard_residual", (8, 16, 12), (), ("data", None, None)),     # no SP (see its docstring)
    ("shard_residual", (8, 15, 12), (), ("data", None, None)),
    ("shard_heads", (8, 16, 4, 6), (), ("data", None, "model", None)),
    ("shard_heads", (8, 16, 3, 6), (), ("data", None, None, None)),
    ("shard_ffn", (8, 16, 10), (), ("data", None, "model")),
    ("shard_ffn", (8, 16, 9), (), ("data", None, None)),
    ("shard_logits", (8, 16, 20), (), ("data", None, "model")),
    ("shard_bhd", (8, 4, 6, 5), (1,), ("data", "model", None, None)),
    ("shard_cache", (8, 16, 4, 6), (), ("data", None, "model", None)),
    ("shard_cache", (1, 16, 3, 6), (), (None, "data", None, "model")),
    ("shard_tokens2d", (32, 12), (), ("data", None)),
    ("shard_expert_tokens", (4, 5, 12), (), ("model", None, None)),
    ("shard_expert_hidden", (4, 5, 12), (), ("model", None, "data")),
]


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


def _init(rank, world, store):
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((2, 2), ("data", "model"), "cpu")


@pytest.mark.parametrize("name,shape,args,spec", SHARD_FNS)
def test_no_axes_no_mesh_is_the_identity(name, shape, args, spec):
    x = torch.randn(shape)
    fn = getattr(part, name)
    assert fn(x, *args) is x
    with part.activation_axes("data", "model"):       # axes but no mesh
        assert fn(x, *args) is x
    from repro_torch.launch.mesh import set_mesh
    with part.activation_axes("data", "model"), set_mesh({"data": 2, "model": 2}):
        assert fn(x, *args) is x                      # a plain tensor: a local body


def _constraints(rank, world, store):
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor, Replicate
    from repro_torch.launch.mesh import set_mesh
    mesh = _init(rank, world, store)
    try:
        g = torch.Generator().manual_seed(0)
        with part.activation_axes("data", "model"), set_mesh(mesh):
            for name, shape, args, spec in SHARD_FNS:
                full = torch.randn(shape, generator=g)
                x = distribute_tensor(full, mesh, (Replicate(), Replicate()))
                y = getattr(part, name)(x, *args)
                assert tuple(y.placements) == part.placements(spec, mesh), (name, shape)
                assert torch.equal(y.full_tensor(), full), name
    finally:
        dist.destroy_process_group()


def test_constraints_give_the_reference_placements(tmp_path):
    spawn(_constraints, 4, str(tmp_path / "store"))


def _kernels(rank, world, store):
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.rmsnorm import rmsnorm_plain
    mesh = _init(rank, world, store)
    try:
        g = torch.Generator().manual_seed(1)
        for hkv in (2, 1):
            q = torch.randn(4, 16, 8, 16, generator=g)
            k = torch.randn(4, 16, hkv, 16, generator=g)
            v = torch.randn(4, 16, hkv, 16, generator=g)
            heads = (Shard(0), Shard(2))
            kv_pl = heads if hkv % 2 == 0 else (Shard(0), Replicate())
            qd, kd, vd = (distribute_tensor(t, mesh, pl).requires_grad_()
                          for t, pl in ((q, heads), (k, kv_pl), (v, kv_pl)))
            out = ops.flash_attention(qd, kd, vd, causal=True)
            want = flash_attention_plain(q, k, v, causal=True)
            assert (out.full_tensor() - want).abs().max() < 1e-5, hkv
            gq, gk, gv = torch.autograd.grad((out * out).sum(), (qd, kd, vd))
            qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
            w = flash_attention_plain(qr, kr, vr, causal=True)
            wq, wk, wv = torch.autograd.grad((w * w).sum(), (qr, kr, vr))
            for a, b in ((gq, wq), (gk, wk), (gv, wv)):
                assert (a.full_tensor() - b).abs().max() < 1e-5 * b.abs().max(), hkv
            # decode: q (B, 1, H, D) over a cache of 16 with 11 valid
            kv_len = torch.full((4,), 11, dtype=torch.int32)
            dq = distribute_tensor(q[:, :1], mesh, heads)
            got = ops.decode_attention(dq, kd.detach(), vd.detach(), kv_len)
            want = decode_attention_plain(q[:, 0], k, v, kv_len)[:, None]
            assert (got.full_tensor() - want).abs().max() < 1e-5, hkv
        x = torch.randn(4, 16, 32, generator=g)
        s = torch.rand(32, generator=g) + 0.5
        xd = distribute_tensor(x, mesh, (Shard(0), Shard(1))).requires_grad_()
        sd = distribute_tensor(s, mesh, (Replicate(), Replicate())).requires_grad_()
        y = ops.rmsnorm(xd, sd, 1e-6)
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert (y.full_tensor() - rmsnorm_plain(x, s, 1e-6)).abs().max() < 1e-5
        # partial sums over the model axis (a row-parallel product's output)
        d = mesh.get_coordinate()[0]
        xp = DTensor.from_local(x[2 * d:2 * (d + 1)] / 2, mesh, (Shard(0), Partial()),
                                run_check=False, shape=x.shape, stride=x.stride())
        assert (ops.rmsnorm(xp, sd, 1e-6).full_tensor() - rmsnorm_plain(x, s, 1e-6)
                ).abs().max() < 1e-5
        gx, gs = torch.autograd.grad((y * y).sum(), (xd, sd))
        xr, sr = x.clone().requires_grad_(), s.clone().requires_grad_()
        yr = rmsnorm_plain(xr, sr, 1e-6)
        wx, ws = torch.autograd.grad((yr * yr).sum(), (xr, sr))
        assert (gx.full_tensor() - wx).abs().max() < 1e-5 * wx.abs().max()
        assert (gs.full_tensor() - ws).abs().max() < 1e-4 * ws.abs().max()
    finally:
        dist.destroy_process_group()


def test_kernels_on_local_shards_equal_the_whole(tmp_path):
    spawn(_kernels, 4, str(tmp_path / "store"))

"""RMSNorm: the port's plain version and oracle against the JAX Pallas
kernel (interpret mode), the JAX oracle and the JAX model norm. The CUDA
kernel is held against its plain version in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ref import rmsnorm_reference as jax_rmsnorm_reference
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.models.layers import apply_norm as jax_apply_norm
from repro.models.layers import rms_head_norm as jax_rms_head_norm
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as trms
from repro_torch.kernels.ref import rmsnorm_reference
from repro_torch.models.layers import apply_norm, rms_head_norm

# tests/test_kernels.py's shapes, then the d_model widths of the repo's configs
SHAPES = [(8, 64), (3, 5, 128), (1, 256), (17, 96), (2, 4096), (3, 5120), (2, 8192)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, shape, name):
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(seed)
    jx = jnp.asarray(rng.standard_normal(shape), jnp.float32).astype(jdt)
    js = (jnp.asarray(rng.standard_normal(shape[-1]), jnp.float32) + 1.0).astype(jdt)
    to_t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(tdt)  # noqa: E731
    return jx, js, to_t(jx), to_t(js)


def _np(t):
    return np.asarray(t.float() if torch.is_tensor(t) else t, np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_plain_matches_pallas_and_oracle(shape, name):
    jx, js, x, s = _inputs(SHAPES.index(shape) * 2 + (name == "bfloat16"), shape, name)
    pallas = jax_rmsnorm(jx, js, interpret=True, block_rows=8)
    plain = trms.rmsnorm_plain(x, s)
    assert plain.dtype == x.dtype and plain.shape == x.shape
    np.testing.assert_allclose(_np(plain), _np(pallas), **_tol(name))
    np.testing.assert_allclose(_np(rmsnorm_reference(x, s)),
                               _np(jax_rmsnorm_reference(jx, js)), **_tol(name))
    np.testing.assert_array_equal(_np(ops.rmsnorm(x, s)), _np(plain))


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_model_norms_match_jax(name):
    """apply_norm (rmsnorm, eps 1e-5) and rms_head_norm (eps 1e-6) route
    through the kernel wrapper and compute the JAX model's norms."""
    jcfg = jax_get_config("deepseek-7b").reduced().replace(param_dtype=name, compute_dtype=name)
    cfg = get_config("deepseek-7b").reduced().replace(param_dtype=name, compute_dtype=name)
    jx, js, x, s = _inputs(5, (2, 7, cfg.d_model), name)
    np.testing.assert_allclose(_np(apply_norm(cfg, {"scale": s}, x)),
                               _np(jax_apply_norm(jcfg, {"scale": js}, jx)), **_tol(name))
    jh, jhs, h, hs = _inputs(6, (2, 7, cfg.n_heads, cfg.head_dim), name)
    np.testing.assert_allclose(_np(rms_head_norm(h, hs)), _np(jax_rms_head_norm(jh, jhs)),
                               **_tol(name))


@pytest.mark.parametrize("norm_type", ["layernorm", "nonparametric_ln"])
def test_layernorm_variants_match_jax(norm_type):
    jcfg = jax_get_config("olmo-1b").reduced().replace(norm_type=norm_type,
                                                       compute_dtype="float32")
    cfg = get_config("olmo-1b").reduced().replace(norm_type=norm_type, compute_dtype="float32")
    jx, js, x, s = _inputs(9, (3, 4, cfg.d_model), "float32")
    jp, p = ({"scale": js, "bias": js - 1.0}, {"scale": s, "bias": s - 1.0}) \
        if norm_type == "layernorm" else ({}, {})
    np.testing.assert_allclose(_np(apply_norm(cfg, p, x)), _np(jax_apply_norm(jcfg, jp, jx)),
                               rtol=2e-5, atol=2e-5)


# The CUDA kernel's launch plan (kernels/rmsnorm.py::plan_rmsnorm), at the
# row counts and widths where its choices change; the card-only tests run
# the kernel at the same edges.
PLAN_ROWS = [1, 2, 131, 133, 1024, 4096]
PLAN_WIDTHS = [8, 96, 100, 128, 4096, 5120, 8192, 40000]
N_SM = 132


def _chunks_of_row(plan, chunks):
    """The chunk indices each thread of a row takes, as the kernel walks
    them: ``vecs`` in registers, then any past the payload one by one."""
    held = []
    for lane in range(plan.threads):
        held += [j * plan.threads + lane for j in range(plan.vecs)
                 if j * plan.threads + lane < chunks]
        held += list(range(plan.vecs * plan.threads + lane, chunks, plan.threads))
    return held


@pytest.mark.parametrize("rows", PLAN_ROWS)
@pytest.mark.parametrize("D", PLAN_WIDTHS)
def test_plan_rmsnorm_covers_every_row_and_chunk_once(rows, D):
    for itemsize in (2, 4):
        per_vec = trms.LOAD_BYTES // itemsize
        chunks = -(-D // per_vec)
        for aligned in (True, False):
            plan = trms.plan_rmsnorm(rows, D, itemsize, aligned, N_SM)
            # the 16-byte branch only where D, the stride and the pointers allow it
            assert plan.vec == (aligned and D % per_vec == 0)
            # threads: a power of two from 32 to 1024, at most 1024 a block
            assert plan.threads in (32, 64, 128, 256, 512, 1024)
            assert 1 <= plan.rows_per_block and plan.threads * plan.rows_per_block <= 1024
            # payload: at most 8 vectors a thread and PAYLOAD a block
            assert plan.vecs in (1, 2, 4, 8)
            assert plan.threads * plan.rows_per_block * plan.vecs <= trms.PAYLOAD
            # every row taken by exactly one row slot of one block, as the
            # kernel indexes them over the grid csrc/rmsnorm.cu launches
            grid = -(-rows // plan.rows_per_block)
            taken = [b * plan.rows_per_block + r for b in range(grid)
                     for r in range(plan.rows_per_block)]
            assert [t for t in taken if t < rows] == list(range(rows))
            # every chunk of a row read by exactly one thread
            held = _chunks_of_row(plan, chunks)
            assert sorted(held) == list(range(chunks))
            if chunks <= trms.PAYLOAD:        # the row stays in registers: one HBM pass
                assert plan.threads * plan.vecs >= chunks
            if rows >= 2 * N_SM:              # many rows: at least 2 blocks an SM
                assert grid >= 2 * N_SM
            elif chunks <= trms.MAX_THREADS:  # few rows: the row arrives in one round
                assert plan.vecs == 1


def test_plan_rmsnorm_at_the_serving_shapes():
    """(2, 512, 4096) bf16: 2 rows of 64 threads a block (512 blocks), 8
    vectors each; (2, 1, 4096): one row of 512 threads, one vector each."""
    assert trms.plan_rmsnorm(1024, 4096, 2, True, N_SM) == (True, 64, 2, 8)
    assert trms.plan_rmsnorm(2, 4096, 2, True, N_SM) == (True, 512, 1, 1)
    assert trms.plan_rmsnorm(2, 4096, 2, False, N_SM).vec is False


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(2, 5, 8), lambda: torch.zeros(2, 5, 8)[:, -1:],
    lambda: torch.zeros(4, 6, 8).transpose(0, 1)[:, ::2], lambda: torch.zeros(3, 1, 4, 8)[:, :, 1:],
    lambda: torch.zeros(6, 8)[::2], lambda: torch.zeros(8), lambda: torch.zeros(1, 1, 8),
    lambda: torch.zeros(4, 3, 8).transpose(0, 1), lambda: torch.zeros(2, 3, 4, 8)[:, 1:2],
    lambda: torch.zeros(5, 1, 8).expand(5, 3, 8)])
def test_row_stride_agrees_with_view(make):
    """The wrapper finds the rows' one stride without making the view."""
    x = make()
    try:
        want = x.view(-1, x.shape[-1]).stride(0) if x.numel() // x.shape[-1] > 1 else None
        viewable = True
    except RuntimeError:
        viewable = False
    got = trms.row_stride(x.shape, x.stride())
    assert (got is not None) == viewable
    if viewable and want is not None:
        assert got == want

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

SHAPES = [(8, 64), (3, 5, 128), (1, 256), (17, 96)]   # tests/test_kernels.py
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

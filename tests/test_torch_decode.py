"""Decode attention: the port's plain version and oracle against the JAX
Pallas kernel (interpret mode) and the JAX oracle. The CUDA kernel is held
against its plain version in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.ref import decode_reference as jax_decode_reference
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import ops
from repro_torch.kernels.ref import decode_reference

# same cases as tests/test_kernels.py: (B, Hq, Hkv, T, D, bk)
DECODE_CASES = [
    (1, 4, 4, 128, 64, 64),
    (2, 8, 2, 256, 64, 128),
    (3, 8, 1, 512, 128, 256),
    (2, 4, 4, 64, 32, 64),
]
# cache lengths the Pallas kernel asserts on (T % block_k), vs the oracle
RAGGED_CASES = [
    (2, 32, 32, 528, 128),
    (2, 32, 8, 528, 128),
    (3, 4, 2, 300, 32),
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, B, Hq, Hkv, T, D, name):
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.standard_normal(s), jnp.float32).astype(jdt)
          for s in ((B, Hq, D), (B, Hkv, T, D), (B, Hkv, T, D))]
    ts = [torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in js]
    kv_len = rng.integers(1, T + 1, size=(B,)).astype(np.int32)   # >= 1: the oracle is NaN at 0
    return js, ts, kv_len


def _np(t):
    return np.asarray(t.float() if torch.is_tensor(t) else t, np.float32)


def _cache(t):  # (B, Hkv, T, D) -> the model's (B, T, Hkv, D), as a view
    return t.transpose(1, 2)


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_plain_matches_pallas_and_oracle(case, name):
    B, Hq, Hkv, T, D, bk = case
    (jq, jk, jv), (q, k, v), kv_len = _inputs(
        DECODE_CASES.index(case) * 2 + (name == "bfloat16"), B, Hq, Hkv, T, D, name)
    jlen = jnp.asarray(kv_len)
    pallas = jax_decode(jq, jk, jv, jlen, block_k=bk, interpret=True)
    oracle = jax_decode_reference(jq, jk, jv, jlen)
    tlen = torch.from_numpy(kv_len)
    plain = tdecode.decode_attention_plain(q, _cache(k), _cache(v), tlen)
    assert plain.dtype == q.dtype and plain.shape == (B, Hq, D)
    np.testing.assert_allclose(_np(plain), _np(pallas), **_tol(name))
    np.testing.assert_allclose(_np(decode_reference(q, k, v, tlen)), _np(oracle), **_tol(name))
    got = ops.decode_attention(q[:, None], _cache(k), _cache(v), tlen)   # (B, 1, Hq, D)
    np.testing.assert_array_equal(_np(got[:, 0]), _np(plain))


@pytest.mark.parametrize("case", RAGGED_CASES)
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_plain_ragged_matches_oracle(case, name):
    B, Hq, Hkv, T, D = case
    (jq, jk, jv), (q, k, v), kv_len = _inputs(
        11 + RAGGED_CASES.index(case), B, Hq, Hkv, T, D, name)
    kv_len[0] = T                                        # one full cache
    oracle = jax_decode_reference(jq, jk, jv, jnp.asarray(kv_len))
    plain = tdecode.decode_attention_plain(q, _cache(k), _cache(v), torch.from_numpy(kv_len))
    np.testing.assert_allclose(_np(plain), _np(oracle), **_tol(name))


def test_plain_zero_length_gives_zeros():
    """kv_len == 0 -> 0, as the Pallas kernel's l == 0 guard gives."""
    _, (q, k, v), _ = _inputs(0, 2, 4, 2, 64, 32, "float32")
    kv_len = torch.tensor([0, 5], dtype=torch.int32)
    out = tdecode.decode_attention_plain(q, _cache(k), _cache(v), kv_len)
    assert torch.all(out[0] == 0) and torch.isfinite(out).all()
    jout = jax_decode(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                      jnp.asarray(kv_len.numpy()), block_k=64, interpret=True)
    np.testing.assert_allclose(_np(out), _np(jout), rtol=2e-5, atol=2e-5)

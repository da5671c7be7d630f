"""Flash attention: the port's plain version and oracle against the JAX
Pallas kernel (interpret mode) and the JAX oracle. The CUDA kernel is held
against its plain version in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import mha_reference as jax_mha_reference
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mha_reference
from repro_torch.models.layers import attention_core

# same cases as tests/test_kernels.py: (B, Hq, Hkv, S, T, D, bq, bk)
FLASH_CASES = [
    (1, 2, 2, 128, 128, 64, 64, 64),
    (2, 4, 2, 256, 256, 64, 128, 64),
    (1, 8, 1, 128, 128, 128, 64, 128),
    (1, 4, 4, 512, 512, 32, 128, 128),
    (2, 2, 2, 64, 64, 8, 64, 64),
]
# shapes the Pallas kernel asserts on (S % bq, T % bk), held against the oracle
RAGGED_CASES = [
    (1, 4, 2, 200, 200, 64),
    (2, 8, 8, 130, 70, 32),
    (1, 2, 1, 33, 97, 128),
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, shapes, name):
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.standard_normal(s), jnp.float32).astype(jdt) for s in shapes]
    ts = [torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in js]
    return js, ts


def _np(t):
    return np.asarray(t.float() if torch.is_tensor(t) else t, np.float32)


def _bshd(t):  # (B, H, S, D) -> (B, S, H, D) view
    return t.transpose(1, 2)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_and_oracle(case, name, causal):
    B, Hq, Hkv, S, T, D, bq, bk = case
    (jq, jk, jv), (q, k, v) = _inputs(
        FLASH_CASES.index(case) * 4 + int(causal) * 2 + (name == "bfloat16"),
        [(B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, D)], name)
    pallas = jax_flash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk, interpret=True)
    oracle = jax_mha_reference(jq, jk, jv, causal=causal)
    plain = tflash.flash_attention_plain(_bshd(q), _bshd(k), _bshd(v), causal=causal)
    assert plain.dtype == q.dtype and plain.shape == (B, S, Hq, D)
    np.testing.assert_allclose(_np(_bshd(plain)), _np(pallas), **_tol(name))
    np.testing.assert_allclose(_np(mha_reference(q, k, v, causal=causal)), _np(oracle),
                               **_tol(name))
    # on the CPU the wrapper and the ops entry point take the plain version
    np.testing.assert_array_equal(
        _np(ops.flash_attention(_bshd(q), _bshd(k), _bshd(v), causal=causal)), _np(plain))


@pytest.mark.parametrize("case", RAGGED_CASES)
@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_plain_ragged_matches_oracle(case, name, causal):
    B, Hq, Hkv, S, T, D = case
    (jq, jk, jv), (q, k, v) = _inputs(
        7 + RAGGED_CASES.index(case), [(B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, D)], name)
    oracle = jax_mha_reference(jq, jk, jv, causal=causal)
    plain = tflash.flash_attention_plain(_bshd(q), _bshd(k), _bshd(v), causal=causal)
    np.testing.assert_allclose(_np(_bshd(plain)), _np(oracle), **_tol(name))


def test_plain_matches_model_chunked_attention():
    """The kernel's function is the model's causal attention (chunked path)."""
    cfg = get_config("deepseek-7b").reduced().replace(attn_chunk=32, compute_dtype="float32")
    _, (q, k, v) = _inputs(1, [(2, 128, cfg.n_heads, cfg.head_dim)] * 3, "float32")
    want = attention_core(cfg, q, k, v, causal=True)
    got = tflash.flash_attention_plain(q, k, v, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 512, 32, 128), (2, 64, 2, 8), (1, 130, 1, 64)])
def test_tma_strides_of_contiguous_and_view_layouts(shape):
    t = torch.zeros(*shape, dtype=torch.bfloat16)
    B, L, H, D = shape
    assert tflash.tma_strides(t, "q") == (L * H * D, H * D, D)
    # a (B, H, L, D) tensor viewed as (B, L, H, D), as the JAX layout gives it
    v = torch.zeros(B, H, L, D, dtype=torch.bfloat16).transpose(1, 2)
    assert tflash.tma_strides(v, "k") == (H * L * D, D, L * D)


def test_tma_strides_replace_the_stride_of_a_size_one_dim():
    t = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16).as_strided((1, 8, 1, 64), (3, 64, 5, 1))
    assert tflash.tma_strides(t, "q") == (8 * 64, 64, 64)


def test_tma_strides_raise_on_misaligned_layouts():
    base = torch.zeros(2, 16, 4, 72, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        tflash.tma_strides(base[..., 1:65], "q")          # base 2 bytes past 16
    with pytest.raises(ValueError, match="stride"):
        tflash.tma_strides(torch.zeros(2, 16, 4, 60, dtype=torch.bfloat16), "k")   # 120-byte rows
    with pytest.raises(ValueError, match="stride"):
        tflash.tma_strides(torch.zeros(2, 16, 4, 100, dtype=torch.bfloat16), "k")  # D % 8 != 0
    with pytest.raises(ValueError, match="stride"):
        tflash.tma_strides(torch.zeros(2, 16, 3, 68, dtype=torch.bfloat16)[:, :, :, :64], "v")
    with pytest.raises(ValueError, match="contiguous"):
        tflash.tma_strides(base.transpose(2, 3), "q")

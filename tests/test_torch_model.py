"""DENSE model parity: the port's prefill, decode and greedy generation
against the JAX package on the same (published) weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import greedy_generate as jax_greedy_generate
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.serving.weights_io import flat_to_params_like as jax_flat_to_params_like
from repro.serving.weights_io import params_to_flat as jax_params_to_flat
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.serving import to_torch_tree

# (arch, overrides): reduced configs at 2 layers; vocab 250 exercises the
# vocab-pad mask (padded to 256), qk_norm the qwen3 head norm
CASES = [
    ("deepseek-7b", {}),
    ("mistral-nemo-12b", {}),
    ("qwen1.5-110b", {}),
    ("olmo-1b", {}),
    ("deepseek-7b", {"vocab_size": 250}),
    ("deepseek-7b", {"qk_norm": True}),
]
IDS = ["deepseek-7b", "mistral-nemo-12b", "qwen1.5-110b", "olmo-1b", "vocab250", "qk_norm"]
B, S, N_NEW = 2, 16, 4


def _configs(arch, over, dtype):
    kw = dict(n_layers=2, param_dtype=dtype, compute_dtype=dtype, **over)
    return jax_get_config(arch).reduced().replace(**kw), get_config(arch).reduced().replace(**kw)


def _weights(jcfg, seed):
    """JAX init, with biases and norm scales moved off their 0/1 init so
    that every parameter matters; returns (jax params, flat numpy)."""
    params = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    flat = jax_params_to_flat(params)
    rng = np.random.default_rng(seed)
    for n, a in flat.items():
        if n.split("/")[-1] in ("bq", "bk", "bv", "q_norm", "k_norm", "scale", "bias"):
            noise = 0.1 * rng.standard_normal(a.shape).astype(np.float32)
            flat[n] = (np.asarray(a, np.float32) + noise).astype(a.dtype)
    return jax_flat_to_params_like(params, flat, convert=jnp.asarray), flat


def _tokens(cfg, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_float32_logits_and_tokens_match(arch, over):
    jcfg, cfg = _configs(arch, over, "float32")
    jparams, flat = _weights(jcfg, CASES.index((arch, over)))
    params = to_torch_tree(flat, "cpu", template=M.init_params(cfg, device="meta"))
    toks = _tokens(cfg, 1)
    max_len = S + N_NEW

    jlogits, jcache = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, max_len)
    logits, cache = M.prefill(cfg, params, {"tokens": torch.from_numpy(toks).long()}, max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cache["attn"]["k"].numpy(), np.asarray(jcache["attn"]["k"]),
                               rtol=1e-4, atol=1e-4)

    tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    jlogits2, _ = jax_decode_step(jcfg, jparams, jcache, jnp.asarray(tok), jnp.int32(S))
    logits2, _ = M.decode_step(cfg, params, cache, torch.from_numpy(tok).long(), S)
    np.testing.assert_allclose(logits2.numpy(), np.asarray(jlogits2), rtol=1e-4, atol=1e-4)
    if cfg.padded_vocab != cfg.vocab_size:
        assert torch.all(logits2[:, cfg.vocab_size:] == -1e30)

    want = jax_greedy_generate(jcfg, jparams, {"tokens": jnp.asarray(toks)}, N_NEW, max_len)
    got = M.greedy_generate(cfg, params, {"tokens": torch.from_numpy(toks).long()},
                            N_NEW, max_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch,over", CASES[:4], ids=IDS[:4])
def test_bfloat16_logits_match(arch, over):
    """bf16 keeps 8 mantissa bits and the two frameworks round at different
    points (matmul accumulation, where casts fall), so the logits agree to a
    few bf16 steps of their own scale: atol is 3% of max |logit|, rtol 3%."""
    jcfg, cfg = _configs(arch, over, "bfloat16")
    jparams, flat = _weights(jcfg, 10 + CASES.index((arch, over)))
    params = to_torch_tree(flat, "cpu", template=M.init_params(cfg, device="meta"))
    assert params["embed"].dtype == torch.bfloat16
    toks = _tokens(cfg, 2)
    max_len = S + 2
    jlogits, jcache = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, max_len)
    logits, cache = M.prefill(cfg, params, {"tokens": torch.from_numpy(toks).long()}, max_len)
    want = np.asarray(jlogits, np.float32)
    tol = dict(rtol=3e-2, atol=3e-2 * np.abs(want).max())
    np.testing.assert_allclose(logits.float().numpy(), want, **tol)

    tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    jlogits2, _ = jax_decode_step(jcfg, jparams, jcache, jnp.asarray(tok), jnp.int32(S))
    logits2, _ = M.decode_step(cfg, params, cache, torch.from_numpy(tok).long(), S)
    want2 = np.asarray(jlogits2, np.float32)
    np.testing.assert_allclose(logits2.float().numpy(), want2,
                               rtol=3e-2, atol=3e-2 * np.abs(want2).max())


def test_other_families_raise():
    with pytest.raises(NotImplementedError, match="later slice"):
        M.init_params(get_config("mamba2-370m").reduced(), device="meta")

"""Gradients of the port's training path against the JAX package's.

The two ``autograd.Function``s (``kernels/ops.py``) against ``jax.grad``
through the reference's ``custom_vjp`` flash attention (Pallas in
interpret mode) and through ``apply_norm`` / ``rms_head_norm``; then
``loss_fn``'s value, metrics and every parameter's gradient for each
family's reduced config in float32 against ``jax.value_and_grad`` of the
reference's ``loss_fn`` (``use_pallas=False``), on the same weights (JAX
init -> ``params_to_flat`` -> ``to_torch_tree``) and the same batch.

Tolerances (float32, the two frameworks sum in other orders): kernels
2e-5 of the largest |grad| (bf16: 2e-2); losses and metrics 1e-5
relative; each parameter's gradient 1e-4 of that leaf's largest |grad|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import loss_fn as jax_loss_fn
from repro.serving.weights_io import flat_to_params_like as jax_flat_to_params_like
from repro.serving.weights_io import params_to_flat as jax_params_to_flat
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import rmsnorm as trms
from repro_torch.launch.train_step import value_and_grad
from repro_torch.models import model as M
from repro_torch.serving import to_torch_tree

F32 = dict(param_dtype="float32", compute_dtype="float32")
B, S = 2, 21          # S is not a multiple of the SSM chunk (16)
N_CTX = 13            # the ENCDEC source length (VLM: n_frontend_tokens)


def _np(t):
    return np.asarray(t.detach().float() if torch.is_tensor(t) else t, np.float32)


def _close_to_max(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------

# (B, S, T, Hq, Hkv, D, causal): GQA causal (the training path's case), MHA
# full, and a cross-attention shape (T != S, full, group 4)
FLASH_CASES = {"gqa-causal": (1, 64, 64, 4, 2, 16, True), "mha-full": (2, 64, 64, 2, 2, 32, False),
               "ragged-T-full": (1, 64, 32, 4, 1, 16, False)}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_fn_grads_match_jax_custom_vjp(case):
    Bq, Sq, T, Hq, Hkv, D, causal = FLASH_CASES[case]
    rng = np.random.default_rng(Sq + Hq + D + causal)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((Bq, Sq, Hq, D), (Bq, T, Hkv, D), (Bq, T, Hkv, D)))
    w = rng.standard_normal((Bq, Sq, Hq, D)).astype(np.float32)   # the cotangent

    def jax_loss(q, k, v):
        o = jax_ops.flash_attention(q, k, v, causal=causal, block_q=32, block_k=32)
        return jnp.sum(o * w)

    jg = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for got, want in zip(tg, jg):
        _close_to_max(got, want, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head", [False, True], ids=["apply_norm", "rms_head_norm"])
def test_rmsnorm_fn_grads_match_jax(dtype, head):
    rng = np.random.default_rng(3 + head)
    shape = (2, 5, 4, 16) if head else (2, 5, 48)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    cfg = jax_get_config("deepseek-7b").reduced()

    def jax_loss(x, s):
        y = JL.rms_head_norm(x, s) if head else JL.apply_norm(cfg, {"scale": s}, x)
        return jnp.sum(y.astype(jnp.float32) * w)

    jgx, jgs = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x, jdt), jnp.asarray(s, jdt))
    tdt = getattr(torch, dtype)
    tx, ts = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (x, s))
    y = ops.rmsnorm(tx, ts, 1e-6 if head else cfg.norm_eps)
    gx, gs = torch.autograd.grad((y.float() * torch.from_numpy(w)).sum(), (tx, ts))
    assert gx.dtype == tdt and gs.dtype == tdt
    rel = 2e-5 if dtype == "float32" else 2e-2
    _close_to_max(gx, jgx, rel)
    _close_to_max(gs, jgs, rel)


def test_functions_record_nothing_under_inference_mode():
    """The serving path calls the Functions under inference_mode: the same
    values as the kernel modules' wrappers, no graph, no launches on the CPU."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 16, 4, 8, generator=g) for _ in range(3))
    x, s = torch.randn(3, 7, 32, generator=g), torch.randn(32, generator=g)
    ops.reset_launches()
    with torch.inference_mode():
        o = ops.flash_attention(q, k, v)
        y = ops.rmsnorm(x, s)
    assert o.grad_fn is None and y.grad_fn is None
    assert torch.equal(o, tflash.flash_attention_plain(q, k, v))
    assert torch.equal(y, trms.rmsnorm_plain(x, s))
    assert (tflash.launches, trms.launches) == (0, 0)


# ---------------------------------------------------------------------------
# loss_fn of every family
# ---------------------------------------------------------------------------

# (arch, overrides); deepseek at vocab 250 exercises the vocab-pad mask
# (padded to 256); qwen3-moe has QK-norm through RmsnormFn
LOSS_CASES = {
    "deepseek-7b-vocab250": ("deepseek-7b", {"vocab_size": 250}),
    "olmo-1b": ("olmo-1b", {}),
    "qwen3-moe-capacity": ("qwen3-moe-30b-a3b", {"moe_impl": "capacity"}),
    "qwen3-moe-ragged": ("qwen3-moe-30b-a3b", {"moe_impl": "ragged"}),
    "mamba2-370m": ("mamba2-370m", {}),
    "jamba-1.5-large-398b": ("jamba-1.5-large-398b", {}),
    "llama-3.2-vision-90b": ("llama-3.2-vision-90b", {}),
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2", {}),
}


def _weights(jcfg, seed):
    """JAX init with the norm scales and biases, the conv bias, the QK-norm
    scales and the VLM gates moved off their 1/0 init, so every parameter
    has a gradient that matters."""
    params = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    flat = jax_params_to_flat(params)
    rng = np.random.default_rng(seed)
    for n, a in flat.items():
        leaf = n.split("/")[-1]
        if leaf in ("gate_attn", "gate_mlp"):
            flat[n] = np.full(a.shape, 0.5, np.float32).astype(a.dtype)
        elif leaf in ("scale", "bias", "out_norm", "conv_b", "q_norm", "k_norm"):
            noise = 0.1 * rng.standard_normal(a.shape).astype(np.float32)
            flat[n] = (np.asarray(a, np.float32) + noise).astype(a.dtype)
    return jax_flat_to_params_like(params, flat, convert=jnp.asarray), flat


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    np_batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family in ("vlm", "encdec"):
        np_batch["frontend"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens or N_CTX, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in np_batch.items()})


@pytest.fixture(scope="module", params=sorted(LOSS_CASES))
def case(request):
    """One family's reduced float32 config: the JAX loss, metrics and grads
    (computed once per module), the port's weights and batch."""
    arch, over = LOSS_CASES[request.param]
    jcfg = jax_get_config(arch).reduced().replace(**F32, **over)
    tcfg = get_config(arch).reduced().replace(**F32, **over)
    seed = sorted(LOSS_CASES).index(request.param)
    jparams, flat = _weights(jcfg, seed)
    jb, tb = _batch(jcfg, seed)
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(jcfg, p, b), has_aux=True))(jparams, jb)
    return {"cfg": tcfg, "flat": flat, "batch": tb, "total": float(jtotal),
            "metrics": {k: float(v) for k, v in jmetrics.items()},
            "grads": jax_params_to_flat(jgrads)}


def _port(case, **over):
    cfg = case["cfg"].replace(**over)
    params = to_torch_tree(case["flat"], "cpu", template=M.init_params(cfg, device="meta"))
    return value_and_grad(cfg, params, case["batch"])


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def test_loss_fn_and_grads_match_jax(case):
    total, metrics, grads = _port(case)
    np.testing.assert_allclose(total.item(), case["total"], rtol=1e-5)
    assert set(metrics) == set(case["metrics"]) == {"loss", "aux_loss", "perplexity"}
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), case["metrics"][k], rtol=1e-5, atol=1e-6)
    got = dict(_flat(grads))
    assert set(got) == set(case["grads"])
    for name, want in case["grads"].items():
        assert got[name].dtype == torch.float32, name
        _close_to_max(got[name], want, 1e-4)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_gives_the_gradients_of_none(case, policy):
    """Checkpointed layers recompute the same operations on the CPU: the
    same loss and the same gradients, bit for bit, as remat "none"."""
    want_total, want_metrics, want = _port(case, remat_policy="none")
    total, metrics, grads = _port(case, remat_policy=policy)
    assert torch.equal(total, want_total)
    for (name, g), (_, w) in zip(_flat(grads), _flat(want)):
        assert torch.equal(g, w), name


def test_remat_rejects_an_unknown_policy():
    cfg = get_config("deepseek-7b").reduced().replace(remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        M._maybe_remat(cfg, lambda x: x)

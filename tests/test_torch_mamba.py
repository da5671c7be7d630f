"""The port's Mamba-2 block (``repro_torch.models.mamba``) against the JAX
package's ``models/mamba.py`` on the same inputs: the chunked SSD scan and
its sequential oracle on hypothesis draws (lengths that are not a multiple
of the chunk included, so the zero-padded tail runs), the mixer with its
decode state, and one recurrent step. Tolerances: the scan 2e-4 as
tests/test_property.py holds JAX's own; the mixer in float32 1e-4 of its
scale; in bf16 3e-2, as tests/test_torch_model.py, because the two
frameworks round at other points."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jax_get_config
from repro.models import mamba as JS
from repro.serving.weights_io import params_to_flat as jax_params_to_flat
from repro_torch.configs import get_config
from repro_torch.models import mamba as S
from repro_torch.serving import to_torch_tree


def _ssd_inputs(b, seqlen, seed, H=2, P=4, N=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, seqlen, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, seqlen, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((H,))).astype(np.float32)
    Bm = rng.standard_normal((b, seqlen, N)).astype(np.float32)
    Cm = rng.standard_normal((b, seqlen, N)).astype(np.float32)
    s0 = rng.standard_normal((b, H, N, P)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


def _close(got, want, tol=2e-4):
    np.testing.assert_allclose(got.float().numpy() if torch.is_tensor(got) else got,
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@given(st.integers(1, 2), st.sampled_from([5, 8, 16, 23, 32]),
       st.sampled_from([4, 8, 16]), st.integers(0, 10_000), st.booleans())
@settings(max_examples=25, deadline=None)
def test_ssd_chunked_matches_jax(b, seqlen, chunk, seed, with_state):
    """The same draws through both packages' ``ssd_chunked`` (padded tails
    where ``seqlen % chunk``), with and without an initial state, and the
    port's chunked scan against its own sequential oracle."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(b, seqlen, seed)
    init = s0 if with_state else None
    jy, js = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
                            init_state=None if init is None else jnp.asarray(init))
    y, s = S.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk,
                         init_state=None if init is None else torch.from_numpy(init))
    assert y.shape == (b, seqlen, 2, 4) and s.shape == (b, 2, 8, 4)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    _close(y, jy)
    _close(s, js)
    ry, rs = S.ssd_reference(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                             init_state=None if init is None else torch.from_numpy(init))
    _close(y, ry.numpy())
    _close(s, rs.numpy())


@given(st.integers(1, 2), st.sampled_from([1, 7, 16]), st.integers(0, 10_000))
@settings(max_examples=10, deadline=None)
def test_ssd_reference_matches_jax(b, seqlen, seed):
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(b, seqlen, seed)
    jy, js = JS.ssd_reference(*map(jnp.asarray, (x, dt, A, Bm, Cm)), jnp.asarray(s0))
    y, s = S.ssd_reference(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), torch.from_numpy(s0))
    _close(y, jy)
    _close(s, js)


def test_ssd_chunked_stays_finite_under_strong_decay():
    """A chunk of 64 steps with dt * A around -50 a step: the decay matrix's
    upper triangle has exponents up to +3000. Masking the exponent (not the
    exp) keeps every output finite."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(1, 64, 3)
    dt = np.full_like(dt, 50.0)
    A = np.full_like(A, -1.0)
    y, s = S.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), 64)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    ry, rs = S.ssd_reference(*map(torch.from_numpy, (x, dt, A, Bm, Cm)))
    _close(y, ry.numpy())


def _mixer(dtype, seed):
    """A reduced mamba2 config in ``dtype`` and one mixer's params, drawn by
    the JAX init and carried across; ``out_norm`` and ``conv_b`` moved off
    their 1/0 init so that every parameter matters."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg = jax_get_config("mamba2-370m").reduced().replace(**kw)
    cfg = get_config("mamba2-370m").reduced().replace(**kw)
    jp = JS.init_mamba(jcfg, jax.random.PRNGKey(seed))
    flat = jax_params_to_flat(jp)
    rng = np.random.default_rng(seed)
    for n in ("out_norm", "conv_b"):
        a = flat[n]
        flat[n] = (np.asarray(a, np.float32)
                   + 0.1 * rng.standard_normal(a.shape).astype(np.float32)).astype(a.dtype)
    jp = {n: jnp.asarray(a) for n, a in flat.items()}
    return jcfg, cfg, jp, to_torch_tree(flat, "cpu")


def test_init_mamba_matches_the_reference_layout():
    """Shapes and dtypes of the JAX init, float32 for A_log, D and dt_bias
    in a bf16 model, the deterministic A_log and D, and dt = softplus(dt_bias)
    within [1e-3, 1e-1]; a leading axis stacks layers; meta is a template."""
    cfg = get_config("mamba2-370m").reduced()
    jp = JS.init_mamba(jax_get_config("mamba2-370m").reduced(), jax.random.PRNGKey(0))
    g = torch.Generator().manual_seed(0)
    p = S.init_mamba(cfg, (3,), g, "cpu")
    meta = S.init_mamba(cfg, (), None, "meta")
    for n, a in jax_params_to_flat(jp).items():
        assert tuple(p[n].shape) == (3, *a.shape), n
        assert tuple(meta[n].shape) == a.shape and meta[n].is_meta, n
        want = torch.float32 if n in ("A_log", "D", "dt_bias") else torch.bfloat16
        assert p[n].dtype == meta[n].dtype == want, n
    nh = cfg.n_ssm_heads
    torch.testing.assert_close(p["A_log"][1], torch.log(torch.arange(1, nh + 1).float()))
    assert torch.equal(p["D"], torch.ones(3, nh))
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)
    assert torch.equal(p["conv_b"], torch.zeros_like(p["conv_b"]))


@pytest.mark.parametrize("L", [1, 2, 16, 21])
def test_apply_mamba_with_state_matches_jax(L):
    """float32: the mixer's output, final SSM state and conv tail (left
    padded when L < d_conv - 1), then two recurrent steps from that state."""
    jcfg, cfg, jp, p = _mixer("float32", L)
    rng = np.random.default_rng(L)
    x = rng.standard_normal((2, L, cfg.d_model)).astype(np.float32)
    jo, (jssm, jconv) = JS.apply_mamba(jcfg, jp, jnp.asarray(x), return_state=True)
    o, (ssm, conv) = S.apply_mamba(cfg, p, torch.from_numpy(x), return_state=True)
    scale = float(np.abs(np.asarray(jo)).max())
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-4, atol=1e-4 * scale)
    _close(ssm, jssm, 1e-4)
    assert conv.shape == (2, cfg.d_conv - 1, cfg.d_inner + 2 * cfg.d_state)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(jconv))
    assert torch.equal(o, S.apply_mamba(cfg, p, torch.from_numpy(x)))
    for step in range(2):
        t = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jo, jssm, jconv = JS.mamba_decode_step(jcfg, jp, jnp.asarray(t), jssm, jconv)
        o, ssm, conv = S.mamba_decode_step(cfg, p, torch.from_numpy(t), ssm, conv)
        scale = float(np.abs(np.asarray(jo)).max())
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-4, atol=1e-4 * scale)
        _close(ssm, jssm, 1e-4)
        _close(conv, jconv, 1e-6)


def test_decode_steps_continue_the_prefill():
    """The recurrence is the scan: prefill over L tokens then one step
    equals prefill over L + 1 (the last position), in float32."""
    _, cfg, _, p = _mixer("float32", 7)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32))
    _, (ssm, conv) = S.apply_mamba(cfg, p, x[:, :9], return_state=True)
    o, _, _ = S.mamba_decode_step(cfg, p, x[:, 9:], ssm, conv)
    full = S.apply_mamba(cfg, p, x)
    torch.testing.assert_close(o[:, 0], full[:, -1], rtol=1e-4, atol=1e-5)


def test_apply_mamba_bfloat16_matches_jax():
    """bf16: the conv, the gated norm and the products round at other points
    in the two frameworks, so 3e-2 of the output's scale."""
    jcfg, cfg, jp, p = _mixer("bfloat16", 5)
    x = np.random.default_rng(5).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    jo, (jssm, _) = JS.apply_mamba(jcfg, jp, jnp.asarray(x, jnp.bfloat16), return_state=True)
    o, (ssm, conv) = S.apply_mamba(cfg, p, torch.from_numpy(x).bfloat16(), return_state=True)
    assert o.dtype == conv.dtype == torch.bfloat16 and ssm.dtype == torch.float32
    want = np.asarray(jo, np.float32)
    np.testing.assert_allclose(o.float().numpy(), want, rtol=3e-2,
                               atol=3e-2 * np.abs(want).max())
    ws = np.asarray(jssm)
    np.testing.assert_allclose(ssm.numpy(), ws, rtol=3e-2, atol=3e-2 * np.abs(ws).max())

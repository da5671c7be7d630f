"""The port's AdamW, schedules and gradient clipping against the JAX
package's, over 3 updates of the same params and grads (made with numpy),
with float32 and bf16 parameters and float32 and bf16 moments.

Tolerances: float32 leaves 1e-6 relative (the two frameworks' float32 pow,
sqrt and division may differ in the last bit); bf16 leaves one bf16 step
(2**-7 relative), where a last-bit difference in the float32 update can
round to the neighbouring bf16 value."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import constant as jax_constant
from repro.optim import global_norm as jax_global_norm
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro_torch.optim import adamw, clip_by_global_norm, constant, global_norm
from repro_torch.optim import warmup_cosine

SHAPES = {"embed": (16, 8), "layers": {"w": (3, 8, 8), "scale": (3, 8)}, "final": {"b": (8,)}}


def _tree(shapes, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(k, v) for k, v in shapes.items()}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _assert_trees(got, want, dtype):
    tol = dict(rtol=1e-6, atol=1e-7) if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-6)
    for (n, g), (m, w) in zip(_leaves(got), _leaves(want)):
        assert n == m
        assert str(g.dtype).split(".")[-1] == str(w.dtype), n
        np.testing.assert_allclose(_np(g), _np(w), err_msg=n, **tol)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_over_three_updates(param_dtype, moment_dtype):
    rng = np.random.default_rng(0)
    p0 = _tree(SHAPES, lambda k, s: rng.standard_normal(s).astype(np.float32))
    grads = [_tree(SHAPES, lambda k, s: (3 * rng.standard_normal(s)).astype(np.float32))
             for _ in range(3)]
    tdt, jdt = getattr(torch, param_dtype), jnp.dtype(param_dtype)
    sched = dict(peak_lr=1e-2, warmup_steps=2, total_steps=5)
    j_init, j_update = jax_adamw(jax_warmup_cosine(**sched), moment_dtype=moment_dtype,
                                 max_grad_norm=1.0)
    t_init, t_update = adamw(warmup_cosine(**sched), moment_dtype=moment_dtype,
                             max_grad_norm=1.0)
    jp = _map_np(p0, lambda a: jnp.asarray(a, jdt))
    tp = _map_np(p0, lambda a: torch.from_numpy(a).to(tdt))
    js, ts = j_init(jp), t_init(tp)
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    for g in grads:
        jp, js, jm = j_update(_map_np(g, lambda a: jnp.asarray(a, jdt)), js, jp)
        tp, ts, tm = t_update(_map_np(g, lambda a: torch.from_numpy(a).to(tdt)), ts, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    _assert_trees(tp, jp, param_dtype)
    _assert_trees(ts.mu, js.mu, moment_dtype)
    _assert_trees(ts.nu, js.nu, moment_dtype)


def _map_np(tree, fn):
    return {k: _map_np(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def test_adamw_updates_in_place_and_without_clipping():
    """``update`` writes into the tensors it was given and returns them;
    ``max_grad_norm=None`` leaves the grads unclipped, as JAX."""
    p = {"w": torch.ones(4, 4)}
    init, update = adamw(constant(0.1), max_grad_norm=None)
    st = init(p)
    w = p["w"]
    new, st2, m = update({"w": torch.full((4, 4), 100.0)}, st, p)
    assert new["w"] is w and st2.mu["w"] is st.mu["w"]
    assert m["grad_norm"].item() == 0.0
    ji, ju = jax_adamw(jax_constant(0.1), max_grad_norm=None)
    jw, _, _ = ju({"w": jnp.full((4, 4), 100.0)}, ji({"w": jnp.ones((4, 4))}),
                  {"w": jnp.ones((4, 4))})
    np.testing.assert_allclose(w.numpy(), np.asarray(jw["w"]), rtol=1e-6)


@pytest.mark.parametrize("kind", ["warmup_cosine", "constant"])
def test_schedules_match_jax(kind):
    if kind == "constant":
        jf, tf = jax_constant(3e-4), constant(3e-4)
    else:
        jf, tf = jax_warmup_cosine(3e-4, 10, 100), warmup_cosine(3e-4, 10, 100)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got = tf(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.item(), float(jf(jnp.int32(s))), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_jax(max_norm):
    rng = np.random.default_rng(1)
    tree = _tree(SHAPES, lambda k, s: rng.standard_normal(s).astype(np.float32))
    jt = _map_np(tree, jnp.asarray)
    tt = _map_np(tree, torch.from_numpy)
    np.testing.assert_allclose(global_norm(tt).item(), float(jax_global_norm(jt)), rtol=1e-6)
    (tc, tn), (jc, jn) = clip_by_global_norm(tt, max_norm), jax_clip(jt, max_norm)
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    _assert_trees(tc, jc, "float32")

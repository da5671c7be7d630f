"""MoE parity: the port's ``models/moe.py``, the MoE model and the engine's
MoE serving (batch, layer-streamed with expert windows demanded, prefix
hit) against the JAX package on the same inputs and published weights.

Tolerances: float32 functions 1e-5 (rtol and atol; the two frameworks sum
the products and the combine in other orders, ~1e-6 at these widths);
float32 model logits 1e-4, as ``test_torch_model.py``; the bf16 case as
stated there. Routing indices and greedy tokens must be equal exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import MRM as JaxMRM
from repro.core import DiskStore as JaxDiskStore
from repro.models import greedy_generate as jax_greedy_generate
from repro.models import init_params as jax_init_params
from repro.models import moe as JM
from repro.models import prefill as jax_prefill
from repro.serving import InferenceEngine as JaxInferenceEngine
from repro.serving import publish_model as jax_publish_model
from repro.serving.weights_io import flat_to_params_like as jax_flat_to_params_like
from repro.serving.weights_io import params_to_flat as jax_params_to_flat
from repro_torch.configs import get_config
from repro_torch.core import costmodel
from repro_torch.core import mrm as mrm_mod
from repro_torch.core.mrm import MRM
from repro_torch.core.store import DiskStore
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models import moe as TM
from repro_torch.serving import InferenceEngine, to_torch_tree

F32 = dict(rtol=1e-5, atol=1e-5)
IMPLS = ("capacity", "ragged", "grouped", "ep")


def _configs(arch="qwen3-moe-30b-a3b", dtype="float32", **over):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **over)
    return (jax_get_config(arch).reduced().replace(**kw),
            get_config(arch).reduced().replace(**kw))


def _moe_params(jcfg, seed=0, router_scale=1.0, tie=None):
    """JAX init of one MoE layer as numpy. ``router_scale`` sharpens the
    router (margins between experts well above float rounding); ``tie``
    = (src, dst) copies router column src into dst, so the two experts'
    probabilities are equal for every token."""
    p = {k: np.array(v, np.float32)
         for k, v in JM.init_moe(jcfg, jax.random.PRNGKey(seed)).items()}
    p["router"] = p["router"] * router_scale
    if tie is not None:
        p["router"][:, tie[1]] = p["router"][:, tie[0]]
    return p


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(p, x, dtype=np.float32):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jp = {k: jnp.asarray(v).astype(jd) if k != "router" else jnp.asarray(v)
          for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()).to(td) if k != "router" else torch.from_numpy(v.copy())
          for k, v in p.items()}
    return jp, jnp.asarray(x).astype(jd), tp, torch.from_numpy(x.copy()).to(td)


# ------------------------------------------------------------- function level

@pytest.mark.parametrize("tie", [None, (5, 2)], ids=["distinct", "tied"])
def test_router_topk_matches_and_ties_go_to_the_lower_index(tie):
    jcfg, cfg = _configs()
    p = _moe_params(jcfg, router_scale=20.0, tie=tie)
    jp, jx, tp, tx = _both(p, _x((48, jcfg.d_model)))
    jw, ji, jaux = JM.router_topk(jcfg, jp, jx)
    tw, ti, taux = TM.router_topk(cfg, tp, tx)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **F32)
    np.testing.assert_allclose(taux.item(), float(jaux), **F32)
    if tie is not None:
        # experts 2 and 5 tie for every token: wherever one is chosen with
        # the other left out, the chosen one is 2, and 2 comes first
        lo, hi = 2, 5
        has_lo, has_hi = (ti == lo).any(-1), (ti == hi).any(-1)
        assert bool((has_lo | ~has_hi).all())
        assert bool((has_lo & ~has_hi).any())          # the tie decided a choice
        both = has_lo & has_hi
        pos = lambda e: (ti[both] == e).float().argmax(-1)  # noqa: E731
        assert bool((pos(lo) < pos(hi)).all())


@pytest.mark.parametrize("cf", [0.5, 8.0], ids=["drops", "no_drops"])
def test_moe_capacity_matches_with_and_without_drops(cf):
    jcfg, cfg = _configs(capacity_factor=cf)
    p = _moe_params(jcfg, router_scale=20.0)
    T = 40
    jp, jx, tp, tx = _both(p, _x((T, jcfg.d_model)))
    jo, jaux = JM.moe_capacity(jcfg, jp, jx)
    to, taux = TM.moe_capacity(cfg, tp, tx)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
    np.testing.assert_allclose(taux.item(), float(jaux), **F32)
    _, topi, _ = TM.router_topk(cfg, tp, tx)
    C = TM._capacity(T, cfg)
    dropped = int((TM._slot_positions(topi.reshape(-1), cfg.n_experts, C)
                   == cfg.n_experts * C).sum())
    assert (dropped > 0) == (cf < 1)
    if cf < 1:                          # a drop changes the output, not just its bits
        full, _ = TM.moe_capacity(cfg.replace(capacity_factor=8.0), tp, tx)
        assert (full - to).abs().max() > 1e-2


def test_slot_positions_follow_cumsum_order():
    """Assignments to one expert take its slots in flat (t, k) order and
    the ones past C are dropped to the trash slot E*C."""
    e_flat = torch.tensor([1, 0, 1, 2, 1, 0, 1, 1])
    slot = TM._slot_positions(e_flat, E=3, C=2)
    assert slot.tolist() == [2, 0, 3, 4, 6, 1, 6, 6]


@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared_expert"])
@pytest.mark.parametrize("fn", ["moe_ragged", "moe_capacity_grouped"])
def test_ragged_and_grouped_match(fn, shared):
    jcfg, cfg = _configs(n_shared_experts=shared, capacity_factor=0.75)
    p = _moe_params(jcfg, seed=2, router_scale=20.0)
    x = _x((2, 16, jcfg.d_model), seed=3)
    if fn == "moe_ragged":
        x = x.reshape(32, -1)
    jp, jx, tp, tx = _both(p, x)
    jo, jaux = getattr(JM, fn)(jcfg, jp, jx)
    to, taux = getattr(TM, fn)(cfg, tp, tx)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
    np.testing.assert_allclose(taux.item(), float(jaux), **F32)
    if shared:
        np.testing.assert_allclose(TM._shared_ffn(tp, tx.reshape(32, -1)).numpy(),
                                   np.asarray(JM._shared_ffn(jp, jx.reshape(32, -1))), **F32)


@pytest.mark.parametrize("impl", IMPLS)
def test_apply_moe_matches_for_each_impl(impl):
    jcfg, cfg = _configs("moonshot-v1-16b-a3b", moe_impl=impl)
    p = _moe_params(jcfg, seed=4, router_scale=20.0)
    jp, jx, tp, tx = _both(p, _x((2, 12, jcfg.d_model), seed=5))
    jo, jaux = JM.apply_moe(jcfg, jp, jx)
    to, taux = TM.apply_moe(cfg, tp, tx)
    assert to.shape == (2, 12, cfg.d_model)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
    np.testing.assert_allclose(taux.item(), float(jaux), **F32)


@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_apply_moe_bfloat16(impl):
    """bf16, on inputs whose top-k logit margins lie far above bf16
    rounding: the router's first E rows are the identity, and each token
    has logit ~6 for one expert, ~4 for a second and at most ~2.4 for the
    rest (margins >= 1, a bf16 step at 6 is 0.03), so the routing is the
    same on both sides and asserted so. The two frameworks round the
    expert products and the combine at different points (the port sums
    the K rows in float32), so the outputs agree to a few bf16 steps: rtol
    3e-2, atol 3% of max |out|, as test_torch_model.py's bf16 logits."""
    jcfg, cfg = _configs(dtype="bfloat16", moe_impl=impl)
    E, d = cfg.n_experts, cfg.d_model
    p = _moe_params(jcfg, seed=6)
    rng = np.random.default_rng(7)
    p["router"] = 0.01 * rng.standard_normal((d, E)).astype(np.float32)
    p["router"][np.arange(E), np.arange(E)] += 1.0
    x = np.clip(rng.standard_normal((32, d)), -2, 2).astype(np.float32)
    for t in range(32):
        a, b = rng.choice(E, 2, replace=False)
        x[t, a], x[t, b] = 6.0, 4.0
    jp, jx, tp, tx = _both(p, x.reshape(2, 16, d), dtype="bfloat16")
    logits = (tx.reshape(32, d) @ tp["router"].to(torch.bfloat16)).float()
    top = logits.sort(-1, descending=True).values
    assert float((top[:, :cfg.top_k] - top[:, 1:cfg.top_k + 1]).min()) > 1.0
    _, ji, _ = JM.router_topk(jcfg, jp, jx.reshape(32, d))
    _, ti, _ = TM.router_topk(cfg, tp, tx.reshape(32, d))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jo, _ = JM.apply_moe(jcfg, jp, jx)
    to, _ = TM.apply_moe(cfg, tp, tx)
    assert to.dtype == torch.bfloat16
    want = np.asarray(jo, np.float32)
    np.testing.assert_allclose(to.float().numpy(), want, rtol=3e-2,
                               atol=3e-2 * np.abs(want).max())


def test_init_moe_shapes_dtypes_and_scales():
    _, cfg = _configs("qwen3-moe-30b-a3b", dtype="bfloat16", n_shared_experts=1)
    cfg = cfg.replace(d_model=128, d_ff=256, n_experts=16)
    gen = torch.Generator().manual_seed(0)
    p = TM.init_moe(cfg, (3,), gen, "cpu")
    d, f, e = 128, 256, 16
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (3, d, e), "w_gate": (3, e, d, f), "w_up": (3, e, d, f),
        "w_down": (3, e, f, d), "shared_gate": (3, d, f), "shared_up": (3, d, f),
        "shared_down": (3, f, d)}
    assert p["router"].dtype == torch.float32 and p["w_gate"].dtype == torch.bfloat16
    # the JAX init's scales: fan-in from the first axis of each layer's array
    want = {"router": 0.02, "w_gate": e ** -0.5, "w_up": e ** -0.5,
            "w_down": (f * 2 * cfg.n_layers) ** -0.5, "shared_gate": d ** -0.5,
            "shared_down": f ** -0.5}
    for k, s in want.items():
        assert abs(p[k].float().std().item() / s - 1) < 0.05, k
    meta = M.init_params(cfg, device="meta")["layers"]["ffn"]
    assert meta["w_up"].shape == (cfg.n_layers, e, d, f) and meta["w_up"].is_meta


# ---------------------------------------------------------------- model level

def _weights(jcfg, seed):
    """JAX init with the norm scales moved off 1 and the router sharpened
    (margins between the k-th and (k+1)-th expert far above the two
    frameworks' float32 rounding); returns (jax params, flat numpy)."""
    params = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    flat = jax_params_to_flat(params)
    rng = np.random.default_rng(seed)
    for n, a in flat.items():
        leaf = n.split("/")[-1]
        if leaf in ("q_norm", "k_norm", "scale"):
            flat[n] = (np.asarray(a, np.float32)
                       + 0.1 * rng.standard_normal(a.shape).astype(np.float32)).astype(a.dtype)
        elif leaf == "router":
            flat[n] = np.asarray(a) * 20.0
    return jax_flat_to_params_like(params, flat, convert=jnp.asarray), flat


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"])
def test_model_logits_and_greedy_tokens_match(arch):
    jcfg, cfg = _configs(arch, n_layers=2)
    jparams, flat = _weights(jcfg, 0)
    params = to_torch_tree(flat, "cpu", template=M.init_params(cfg, device="meta"))
    assert params["layers"]["ffn"]["w_gate"].shape == (2, cfg.n_experts, cfg.d_model,
                                                       cfg.d_ff)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    max_len = 16 + 5
    jlogits, _ = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, max_len)
    logits, _ = M.prefill(cfg, params, {"tokens": torch.from_numpy(toks).long()}, max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    want = jax_greedy_generate(jcfg, jparams, {"tokens": jnp.asarray(toks)}, 5, max_len)
    got = M.greedy_generate(cfg, params, {"tokens": torch.from_numpy(toks).long()}, 5,
                            max_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------- engine level

@pytest.fixture(scope="module", params=["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"])
def published(request, tmp_path_factory):
    """A reduced MoE model published by the JAX package (capacity path:
    decode steps at batch 2 run with C = 1 and drop assignments)."""
    root = str(tmp_path_factory.mktemp("moe_engine"))
    jcfg, _ = _configs(request.param, n_layers=3)
    jparams, _ = _weights(jcfg, 3)
    jax_publish_model(JaxDiskStore(root), jcfg, jparams, name="moe")
    return root, jcfg


def _engine(root, **kw):
    mrm = MRM(DiskStore(root), device_capacity=1 << 30, host_capacity=1 << 30,
              hw=costmodel.HardwareModel(), pipelined_staging=False, device="cpu")
    return InferenceEngine(DiskStore(root), mrm, device="cpu", framework="repro-jax", **kw)


def _jax_tokens(root, toks, **kw):
    jeng = JaxInferenceEngine(JaxDiskStore(root),
                              JaxMRM(JaxDiskStore(root), device_capacity=1 << 30), **kw)
    return jeng.generate("moe", toks, max_new_tokens=5)


def test_batch_tokens_match_jax_engine(published):
    root, cfg = published
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want, _ = _jax_tokens(root, toks)
    eng = _engine(root)
    for tier in ("disk", "device"):
        got, st = eng.generate("moe", toks, max_new_tokens=5)
        np.testing.assert_array_equal(got, want)
        assert st.tier_hit == tier and not st.streamed


def test_streamed_tokens_match_jax_and_demand_expert_windows(published, monkeypatch):
    root, cfg = published
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want, jst = _jax_tokens(root, toks, streaming=True)
    assert jst.streamed
    demanded = []
    demand = mrm_mod.LoadFuture.demand

    def recording(fut, index):
        demanded.append(index)
        return demand(fut, index)

    monkeypatch.setattr(mrm_mod.LoadFuture, "demand", recording)
    eng = _engine(root, streaming=True, prefix_cache_bytes=16 << 20)
    got, st = eng.generate("moe", toks, max_new_tokens=5)
    assert st.streamed and st.tier_hit == "disk"
    np.testing.assert_array_equal(got, want)
    assert eng.mrm.stats()["stream_opens"] == 1
    # the plan: stem, then each layer's base and expert windows; the engine
    # demands layer i+1's experts before it runs layer i
    plan = eng.mrm.host.peek(("repro-jax", "moe", "1")).payload.arrays
    assert plan["layers/ffn/w_gate"].shape[:2] == (3, cfg.n_experts)
    assert demanded == [4, 6]
    # host hit through the batch path (a prefix miss), then a prefix hit
    for hits in (0, 1):
        got2, st2 = eng.generate("moe", toks, max_new_tokens=5)
        assert not st2.streamed and eng.prefix_kv.hits == hits
        np.testing.assert_array_equal(got2, want)
    assert eng.mrm.stats()["stream_opens"] == 1


def test_serve_cli_publishes_a_ragged_moe_on_cpu(tmp_path, capsys):
    eng = serve.main(["--device", "cpu", "--store", str(tmp_path), "--arch",
                      "qwen3-moe-30b-a3b", "--requests", "2", "--prompt-len", "8",
                      "--max-new", "3"])
    out = capsys.readouterr().out
    assert "req1: tier=device" in out and "1 disk loads" in out
    key = ("repro-torch", "qwen3-moe-30b-a3b", "1")
    assert eng.disk.open(key).meta["config"]["moe_impl"] == "ragged"
    assert eng.mrm.device.peek(key).payload["layers/ffn/router"].dtype == torch.float32

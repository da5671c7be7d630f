"""The port's training step and Trainer against the JAX package's, and the
reference's end-to-end system scenario on the port.

- ``make_train_step`` with ``grad_accum=2`` (float32 reduced configs):
  metrics and the updated params, moments and step against JAX's
  ``make_train_step`` on the same weights and batch, two steps. Tolerances
  (float32, other sum orders): metrics 1e-5 relative; moments 1e-5 of
  each leaf's largest value; params 1e-5 absolute (1% of the peak lr) for
  all but 0.1% of a leaf's elements, and the rest within AdamW's own
  bound, twice the summed lr: AdamW moves a weight by ``lr * m / (sqrt(v)
  + eps)`` whatever the size of its gradient, so where a gradient is at
  the level of eps (1e-8), its rounding noise moves the weight by a
  visible part of lr.
- Trainer resume: JAX's Trainer trains a float32 reduced olmo for 3 steps
  into a checkpoint directory; then the port's Trainer and JAX's, each on
  its own copy of it, resume to 6 steps. Their losses agree within 1e-4
  relative.
- ``tests/test_system.py`` on the port: train through an injected failure
  (losses fall), publish, serve twice through the port's MRM and engine
  (equal tokens, a device hit with one disk load, tokens equal to greedy
  generation on the trained params).
"""
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import make_batch as jax_make_batch
from repro.launch.train import Trainer as JaxTrainer
from repro.launch.train import TrainerConfig as JaxTrainerConfig
from repro.launch.train_step import make_optimizer as jax_make_optimizer
from repro.launch.train_step import make_train_step as jax_make_train_step
from repro.models import init_params as jax_init_params
from repro.serving.weights_io import params_to_flat as jax_params_to_flat
from repro_torch.configs import get_config
from repro_torch.core import costmodel
from repro_torch.core.mrm import MRM
from repro_torch.core.store import DiskStore
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import Trainer, TrainerConfig
from repro_torch.launch.train_step import (make_decode_step, make_optimizer,
                                           make_prefill_step, make_train_step)
from repro_torch.models import model as M
from repro_torch.optim import AdamWState
from repro_torch.runtime import FailureInjector
from repro_torch.serving import InferenceEngine, params_to_flat, publish_model, to_torch_tree

F32 = dict(param_dtype="float32", compute_dtype="float32")


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _assert_tree_close(got, want_flat, rel):
    got = dict(_leaves(got))
    assert set(got) == set(want_flat)
    for n, w in want_flat.items():
        w = np.asarray(w, np.float32)
        g = got[n].float().numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-30),
                                   err_msg=n)


@pytest.mark.parametrize("arch,over", [("deepseek-7b", {}),
                                       ("qwen3-moe-30b-a3b", {"moe_impl": "capacity"})],
                         ids=["deepseek-7b", "qwen3-moe-capacity"])
def test_train_step_with_grad_accum_matches_jax(arch, over):
    jcfg = jax_get_config(arch).reduced().replace(grad_accum=2, **F32, **over)
    tcfg = get_config(arch).reduced().replace(grad_accum=2, **F32, **over)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    flat = jax_params_to_flat(jparams)
    jinit, jupd = jax_make_optimizer(jcfg, 1e-3, 2, 10)
    jstep = jax.jit(jax_make_train_step(jcfg, jupd))
    tinit, tupd = make_optimizer(tcfg, 1e-3, 2, 10)
    tstep = make_train_step(tcfg, tupd)
    tparams = to_torch_tree(flat, "cpu", template=M.init_params(tcfg, device="meta"))
    jopt, topt = jinit(jparams), tinit(tparams)
    lrs = []
    for step in range(2):
        jb = jax_make_batch(jcfg, step, 4, 16)
        tb = make_batch(tcfg, step, 4, 16, device="cpu")
        jparams, jopt, jm = jstep(jparams, jopt, jb)
        tparams, topt, tm = tstep(tparams, topt, tb)
        assert set(tm) == set(jm) == {"loss", "aux_loss", "perplexity", "grad_norm", "lr",
                                      "total_loss"}
        for k in tm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        lrs.append(tm["lr"].item())
    assert int(topt.step) == int(jopt.step) == 2
    got = dict(_leaves(tparams))
    for n, w in jax_params_to_flat(jparams).items():
        d = np.abs(got[n].numpy() - np.asarray(w))
        assert d.max() <= 2 * sum(lrs) and (d > 1e-5).mean() <= 1e-3, (n, d.max())
    _assert_tree_close(topt.mu, jax_params_to_flat(jopt.mu), 1e-5)
    _assert_tree_close(topt.nu, jax_params_to_flat(jopt.nu), 1e-5)


def test_trainer_resumes_a_jax_checkpoint_as_jax_does(tmp_path):
    jcfg = jax_get_config("olmo-1b").reduced().replace(n_layers=2, **F32)
    tcfg = get_config("olmo-1b").reduced().replace(n_layers=2, **F32)
    kw = dict(batch_size=2, seq_len=16, warmup=2, peak_lr=1e-3, ckpt_every=100, log_every=100)
    first = JaxTrainer(jcfg, JaxTrainerConfig(steps=3, ckpt_dir=str(tmp_path / "k"), **kw))
    first.run()
    for d in ("jax", "port"):
        shutil.copytree(tmp_path / "k", tmp_path / d)
    jax_run = JaxTrainer(jcfg, JaxTrainerConfig(steps=6, ckpt_dir=str(tmp_path / "jax"), **kw))
    port_run = Trainer(tcfg, TrainerConfig(steps=6, ckpt_dir=str(tmp_path / "port"), **kw),
                       device="cpu")
    jh, th = jax_run.run()["history"], port_run.run()["history"]
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [3, 4, 5]
    for a, b in zip(th, jh):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``tests/test_system.py``'s training run, on the port, at batch 4 and
    a peak lr of 1e-2. At the reference's batch 2 and 1e-3, 16 steps move
    the loss by less than its batch-to-batch noise (about 0.02 around
    ln 256): JAX's own run falls by 0.009 and the port's, from other
    random weights, rises by 0.005. At 1e-2 both fall by 0.3."""
    tmp = tmp_path_factory.mktemp("system")
    cfg = get_config("olmo-1b").reduced().replace(n_layers=2, d_model=64)
    tc = TrainerConfig(batch_size=4, seq_len=32, steps=16, warmup=2,
                       peak_lr=1e-2, ckpt_dir=str(tmp / "ckpt"),
                       ckpt_every=4, log_every=100)
    tr = Trainer(cfg, tc, injector=FailureInjector(fail_at_steps=[5]), device="cpu")
    out = tr.run_with_restarts(max_restarts=2)
    disk = DiskStore(str(tmp / "models"))
    publish_model(disk, cfg, out["params"], name="sysmodel")
    return cfg, disk, tr, out


def test_training_converged_through_failure(trained):
    _, _, tr, out = trained
    assert tr.restarts == 1
    assert [h["step"] for h in out["history"]] == list(range(16))
    losses = [h["loss"] for h in out["history"]]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) - 0.1


def test_trained_model_served_through_trims(trained):
    cfg, disk, _, out = trained
    mrm = MRM(disk, device_capacity=2 << 30, hw=costmodel.HardwareModel(), device="cpu")
    engine = InferenceEngine(disk, mrm, device="cpu")
    toks = np.arange(1, 17, dtype=np.int32)[None, :]
    gen1, st1 = engine.generate("sysmodel", toks, max_new_tokens=4)
    gen2, st2 = engine.generate("sysmodel", toks, max_new_tokens=4)
    np.testing.assert_array_equal(gen1, gen2)       # deterministic
    assert (st1.tier_hit, st2.tier_hit) == ("disk", "device")
    assert mrm.stats()["disk_loads"] == 1
    batch = {"tokens": torch.from_numpy(toks).long()}
    want = M.greedy_generate(cfg, out["params"], batch, 4, max_len=20)
    np.testing.assert_array_equal(gen1, want.numpy())
    # the step factories run the same functions
    logits, cache = make_prefill_step(cfg, 20)(out["params"], batch)
    logits2, _ = make_decode_step(cfg)(out["params"], cache, logits.argmax(-1), 16)
    assert torch.equal(logits2.argmax(-1), want[:, 1])


def test_published_weights_are_the_trained_params(trained):
    cfg, disk, _, out = trained
    stored = disk.open(("repro-torch", "sysmodel", "1")).read_all()
    assert stored.keys() == params_to_flat(out["params"]).keys()
    for n, a in params_to_flat(out["params"]).items():
        assert stored[n].tobytes() == a.tobytes(), n


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    train_mod.main(["--device", "cpu", "--arch", "mamba2-370m", "--reduced", "--steps", "3",
                    "--batch-size", "2", "--seq-len", "16", "--ckpt-dir", str(tmp_path)])
    assert "done: first loss=" in capsys.readouterr().out
    assert (tmp_path / "LATEST").read_text() == "step_00000003"


def test_trainer_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    cfg = get_config("olmo-1b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, TrainerConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch(cfg, 0, 2, 8)


def test_state_after_restore_is_the_state_saved(tmp_path):
    """init_state, save, restore: the Trainer's restore gives back every
    leaf byte for byte, the 0-d int32 step included, on its device."""
    cfg = get_config("deepseek-7b").reduced().replace(remat_policy="nothing")
    tc = TrainerConfig(batch_size=2, seq_len=16, steps=2, ckpt_dir=str(tmp_path), log_every=100)
    tr = Trainer(cfg, tc, device="cpu")
    out = tr.run()
    state, step = tr.restore_or_init()
    assert step == 2
    opt = out["opt"]
    assert isinstance(opt, AdamWState) and state["opt_step"].dtype == torch.int32
    want = {"params": out["params"], "opt_mu": opt.mu, "opt_nu": opt.nu, "opt_step": opt.step}
    got, exp = dict(_leaves(state)), dict(_leaves(want))
    assert got.keys() == exp.keys()
    for n in exp:
        assert torch.equal(got[n], exp[n]), n

"""The port's checkpoints against the JAX package's: a state written by
either package restores in the other byte for byte (bf16, float32 and the
0-d int32 ``opt_step``), the two packages write the same ``state.trims``
bytes for the same state, and a training state of a reduced olmo (empty
norm subtrees) written by JAX restores into the port's template. Also the
port's retention, ``LATEST`` and async manager (the reference's own
checkpoint tests)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as jax_latest_step
from repro.checkpoint import restore_checkpoint as jax_restore_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.optim import adamw as jax_adamw
from repro.optim import constant as jax_constant
from repro_torch.checkpoint import (CheckpointManager, latest_step, restore_checkpoint,
                                    restore_into, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.device import tensor_to_numpy
from repro_torch.models import model as M
from repro_torch.optim import adamw, constant


def _np_state(seed=0):
    """A state as numpy: bf16 (as float32 values to cast), float32, int32."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((8, 16)).astype(np.float32),
                       "layers": {"ln": rng.standard_normal(4).astype(np.float32)}},
            "opt_mu": {"w": rng.standard_normal((8, 16)).astype(np.float32),
                       "layers": {"ln": np.zeros(4, np.float32)}},
            "opt_step": np.int32(7 + seed)}


def _jax_state(s):
    return {"params": {"w": jnp.asarray(s["params"]["w"], jnp.bfloat16),
                       "layers": {"ln": jnp.asarray(s["params"]["layers"]["ln"])}},
            "opt_mu": jax.tree.map(jnp.asarray, s["opt_mu"]),
            "opt_step": jnp.int32(s["opt_step"])}


def _torch_state(s):
    return {"params": {"w": torch.from_numpy(s["params"]["w"]).to(torch.bfloat16),
                       "layers": {"ln": torch.from_numpy(s["params"]["layers"]["ln"])}},
            "opt_mu": {"w": torch.from_numpy(s["opt_mu"]["w"]),
                       "layers": {"ln": torch.from_numpy(s["opt_mu"]["layers"]["ln"])}},
            "opt_step": torch.tensor(int(s["opt_step"]), dtype=torch.int32)}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _bytes(x):
    """(dtype name, shape, raw bytes) of a tensor or a host array."""
    if torch.is_tensor(x):
        x = tensor_to_numpy(x)
    a = np.asarray(x)
    name = "bfloat16" if a.dtype.name == "bfloat16" or (
        a.dtype.metadata or {}).get("trims") == "bfloat16" else a.dtype.name
    return name, a.shape, a.tobytes()


def _assert_same(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert set(g) == set(w)
    for n in w:
        assert _bytes(g[n]) == _bytes(w[n]), n


def test_jax_writes_port_restores(tmp_path):
    s = _np_state()
    jax_save_checkpoint(str(tmp_path), 7, _jax_state(s))
    assert latest_step(str(tmp_path)) == 7
    step, host = restore_checkpoint(str(tmp_path))
    assert step == 7
    _assert_same(host, _jax_state(s))
    step, back = restore_into(_torch_state(_np_state(1)), str(tmp_path))
    _assert_same(back, _torch_state(s))
    assert back["opt_step"].dtype == torch.int32 and back["opt_step"].shape == ()
    assert back["params"]["w"].dtype == torch.bfloat16


def test_port_writes_jax_restores(tmp_path):
    s = _np_state(2)
    save_checkpoint(str(tmp_path), 9, _torch_state(s))
    assert jax_latest_step(str(tmp_path)) == 9
    step, back = jax_restore_checkpoint(str(tmp_path))
    assert step == 9
    _assert_same(back, _jax_state(s))
    assert np.asarray(back["opt_step"]).shape == () and back["opt_step"].dtype == np.int32


def test_both_packages_write_the_same_file(tmp_path):
    s = _np_state(3)
    jax_save_checkpoint(str(tmp_path / "jax"), 5, _jax_state(s))
    save_checkpoint(str(tmp_path / "port"), 5, _torch_state(s))
    read = lambda d: (tmp_path / d / "step_00000005" / "state.trims").read_bytes()  # noqa: E731
    assert read("jax") == read("port")
    assert (tmp_path / "jax" / "LATEST").read_text() == (tmp_path / "port" / "LATEST").read_text()


def test_jax_training_state_restores_into_port_template(tmp_path):
    """A Trainer-shaped state of reduced olmo (non-parametric norms: empty
    subtrees) written by JAX, restored into the port's meta template."""
    jcfg = jax_get_config("olmo-1b").reduced()
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    opt = jax_adamw(jax_constant(1e-3))[0](params)
    state = {"params": params, "opt_mu": opt.mu, "opt_nu": opt.nu, "opt_step": opt.step}
    jax_save_checkpoint(str(tmp_path), 3, state)
    cfg = get_config("olmo-1b").reduced()
    meta = M.init_params(cfg, device="meta")
    init = adamw(constant(1e-3))[0](meta)
    template = {"params": meta, "opt_mu": init.mu, "opt_nu": init.nu, "opt_step": init.step}
    step, back = restore_into(template, str(tmp_path), device="cpu")
    assert step == 3 and back["params"]["final_norm"] == {}
    _assert_same(back, state)
    with pytest.raises(KeyError, match="missing leaf"):
        restore_into({**template, "extra": torch.zeros(1)}, str(tmp_path), device="cpu")


def test_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1, keep=2, async_mode=False)
    for s in range(1, 5):
        mgr.save(s, _torch_state(_np_state(s)))
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004"]
    assert latest_step(str(tmp_path)) == 4
    _, back = restore_checkpoint(str(tmp_path))
    assert int(back["opt_step"]) == 7 + 4


def test_async_manager_snapshots_before_the_next_update(tmp_path):
    """Saves land on disk in the background; each holds the state as it
    was when ``save`` returned, though the tensors are then overwritten in
    place (as the optimizer does)."""
    mgr = CheckpointManager(str(tmp_path), every=2, keep=5)
    st = _torch_state(_np_state())
    for s in range(1, 7):
        st["params"]["layers"]["ln"].fill_(float(s))
        mgr.save(s, st)
    mgr.wait()
    assert sorted(mgr.saved_steps) == [2, 4, 6]
    for s in (2, 4, 6):
        _, back = restore_checkpoint(str(tmp_path), step=s)
        assert (np.asarray(back["params"]["layers"]["ln"]) == s).all()


def test_async_manager_raises_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    mgr = CheckpointManager(str(blocker), every=1)
    mgr.save(1, _torch_state(_np_state()))
    with pytest.raises(OSError):
        mgr.wait()

"""The port's fault tolerance (``runtime/fault.py``) and the Trainer's
restart loop on the CPU: the reference's fault tests on the port, and the
injector's and supervisor's behaviour held to the JAX package's."""
import time

import pytest

from repro.runtime import FailureInjector as JaxFailureInjector
from repro.runtime import SimulatedFailure as JaxSimulatedFailure
from repro_torch.configs import get_config
from repro_torch.launch.train import Trainer, TrainerConfig
from repro_torch.runtime import FailureInjector, SimulatedFailure, Watchdog, run_with_restarts


def _fired(inj, error, steps):
    out = []
    for s in steps:
        try:
            inj.maybe_fail(s)
            out.append(None)
        except error as e:
            out.append(str(e))
    return out


def test_injector_fires_as_the_reference_at_its_steps():
    steps = [0, 1, 2, 2, 3, 4, 5, 5, 6, 7]
    got = _fired(FailureInjector(fail_at_steps=[2, 5]), SimulatedFailure, steps)
    assert got == _fired(JaxFailureInjector(fail_at_steps=[2, 5]), JaxSimulatedFailure, steps)
    assert [s for s, e in zip(steps, got) if e] == [2, 5]


def test_random_injector_is_deterministic():
    """The same seed fires at the same steps, about ``probability`` of
    them, each step once it has fired. (The reference's random injector
    seeds ``random.Random`` with a tuple, which Python 3.11 and later
    refuse; the port seeds it with a string.)"""
    steps = list(range(200))
    a = _fired(FailureInjector(probability=0.3, seed=4), SimulatedFailure, steps)
    b = _fired(FailureInjector(probability=0.3, seed=4), SimulatedFailure, steps)
    c = _fired(FailureInjector(probability=0.3, seed=5), SimulatedFailure, steps)
    assert a == b != c
    assert 30 <= sum(map(bool, a)) <= 90


def test_run_with_restarts_bounds_the_restarts():
    calls = []

    def run(i):
        calls.append(i)
        if i < 2:
            raise SimulatedFailure("x")
        return "done"

    assert run_with_restarts(run, max_restarts=3) == ("done", 2)
    assert calls == [0, 1, 2]
    with pytest.raises(SimulatedFailure):
        run_with_restarts(lambda i: (_ for _ in ()).throw(SimulatedFailure("y")), max_restarts=1)


def test_watchdog_detects_stall():
    seen = []
    wd = Watchdog(timeout=0.15, poll=0.02, on_stall=seen.append)
    wd.beat()
    time.sleep(0.4)
    wd.stop()
    assert len(wd.stalls) >= 1 and seen == wd.stalls
    assert not wd._thread.is_alive()


def test_watchdog_quiet_when_beating():
    wd = Watchdog(timeout=0.3, poll=0.02)
    for _ in range(10):
        wd.beat()
        time.sleep(0.03)
    wd.stop()
    assert wd.stalls == []


def test_training_survives_injected_failures(tmp_path):
    cfg = get_config("olmo-1b").reduced().replace(n_layers=2)
    tc = TrainerConfig(batch_size=2, seq_len=32, steps=12,
                       ckpt_dir=str(tmp_path), ckpt_every=3, log_every=100)
    tr = Trainer(cfg, tc, injector=FailureInjector(fail_at_steps=[5, 9]), device="cpu")
    out = tr.run_with_restarts(max_restarts=4)
    assert tr.restarts == 2
    assert max(h["step"] for h in tr.history) == 11          # completed all 12 steps
    assert out["history"][-1]["loss"] < out["history"][0]["loss"] + 0.5


def test_restart_resumes_from_checkpoint_not_scratch(tmp_path):
    cfg = get_config("olmo-1b").reduced().replace(n_layers=2)
    tc = TrainerConfig(batch_size=2, seq_len=32, steps=8,
                       ckpt_dir=str(tmp_path), ckpt_every=4, log_every=100)
    tr = Trainer(cfg, tc, injector=FailureInjector(fail_at_steps=[6]), device="cpu")
    tr.run_with_restarts()
    steps = [h["step"] for h in tr.history]
    assert steps == [0, 1, 2, 3, 4, 5, 6, 7]     # the forced save at the fault resumes at 6


def test_too_many_failures_reraise(tmp_path):
    cfg = get_config("olmo-1b").reduced().replace(n_layers=2)
    tc = TrainerConfig(batch_size=2, seq_len=16, steps=4, log_every=100)
    tr = Trainer(cfg, tc, injector=FailureInjector(probability=1.0), device="cpu")
    with pytest.raises(SimulatedFailure):
        tr.run_with_restarts(max_restarts=1)
    assert tr.restarts == 2 and tr.history == []

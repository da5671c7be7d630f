"""The port's synthetic token pipeline against the JAX package's: batches
byte-equal for every architecture's config (tokens, labels and the VLM and
ENCDEC frontends), and the Prefetcher's order from a ``start_step``."""
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import _hash_tokens as jax_hash_tokens
from repro.data.pipeline import make_batch as jax_make_batch
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import Prefetcher, _hash_tokens, make_batch, make_batch_numpy


def test_same_architectures():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("step", [0, 7])
def test_batches_byte_equal_to_jax(arch, step):
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    want = {k: np.asarray(v) for k, v in jax_make_batch(jcfg, step, 4, 24).items()}
    got = make_batch(tcfg, step, 4, 24, device="cpu")
    assert set(got) == set(want)
    assert ("frontend" in got) == (tcfg.family in ("vlm", "encdec"))
    for k, v in want.items():
        t = got[k]
        assert t.device.type == "cpu" and t.numpy().dtype == v.dtype and t.shape == v.shape
        assert t.numpy().tobytes() == v.tobytes(), k
    assert make_batch_numpy(tcfg, step, 4, 24)["tokens"].tobytes() == want["tokens"].tobytes()


def test_full_width_vocab_and_hash_byte_equal():
    """deepseek-7b's full vocab (102400) and the raw hash at a large step."""
    want = np.asarray(jax_make_batch(jax_get_config("deepseek-7b"), 123456, 2, 64)["tokens"])
    assert make_batch_numpy(get_config("deepseek-7b"), 123456, 2, 64)["tokens"].tobytes() == \
        want.tobytes()
    assert _hash_tokens(2 ** 40, (3, 5), 1000, salt=7).tobytes() == \
        np.asarray(jax_hash_tokens(2 ** 40, (3, 5), 1000, salt=7)).tobytes()


def test_prefetcher_order_survives_start_step():
    cfg = get_config("olmo-1b").reduced()
    pf = Prefetcher(cfg, 2, 16, depth=2, start_step=5, device="cpu")
    try:
        got = [next(pf) for _ in range(4)]
    finally:
        pf.stop()
    assert not pf.thread.is_alive()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    for s, b in got:
        ref = jax_make_batch(jax_get_config("olmo-1b").reduced(), s, 2, 16)
        assert b["tokens"].numpy().tobytes() == np.asarray(ref["tokens"]).tobytes()
        assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_prefetcher_raises_what_the_generator_raised():
    """A batch that cannot be made surfaces in the training loop instead of
    leaving it waiting on an empty queue."""
    pf = Prefetcher(get_config("olmo-1b").reduced(), 2, 16, device="nowhere")
    try:
        with pytest.raises(RuntimeError):
            next(pf)
    finally:
        pf.stop()

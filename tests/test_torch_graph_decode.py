"""Graph decode on the CPU: the decode step with its position on the device
gives the int form's logits and cache bits, the engine's graph gate reads
its input, and the graph's static step and the engine's pool of lent
graphs behave as the card's path needs. Capture and replay themselves run
only on a card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.mrm import MRM
from repro_torch.core.store import DiskStore
from repro_torch.models import model as M
from repro_torch.serving import InferenceEngine, publish_model
from repro_torch.serving import engine as E

CUDA = torch.device("cuda")     # a device object only: nothing is placed on it


def _model(arch, **over):
    cfg = get_config(arch).reduced().replace(n_layers=2, param_dtype="float32",
                                             compute_dtype="float32", **over)
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def _prefill(cfg, params, B=2, S=6, max_len=10):
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    logits, cache = M.prefill(cfg, params, {"tokens": toks}, max_len)
    return logits.argmax(-1), cache


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("form", ["0d", "1d"])
def test_device_position_gives_the_int_forms_logits_and_cache_bits(arch, where, form):
    """DENSE and capacity MoE (qwen3-moe: GQA, QK-norm): a step at the first
    decode position and at the cache's last row, with ``pos`` a 0-d or (1,)
    int tensor, equals the int step bit for bit."""
    cfg, params = _model(arch)
    tok, cache = _prefill(cfg, params)
    pos = 6 if where == "first" else 9
    a, b = _clone(cache), _clone(cache)
    want, a = M.decode_step(cfg, params, a, tok, pos)
    t = torch.tensor(pos) if form == "0d" else torch.tensor([pos], dtype=torch.int32)
    got, b = M.decode_step(cfg, params, b, tok, t)
    assert torch.equal(got, want)
    for k in ("k", "v"):
        assert torch.equal(b["attn"][k], a["attn"][k])
        assert not torch.equal(a["attn"][k], cache["attn"][k])   # row ``pos`` was written


def test_static_step_tokens_equal_greedy_generate():
    """The graph's step run eagerly on its static tensors (as the card runs it
    before capture): primed from prefill, it writes greedy_generate's tokens
    into its output columns and advances its own position."""
    cfg, params = _model("qwen3-moe-30b-a3b")
    toks = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(1))
    want = M.greedy_generate(cfg, params, {"tokens": toks}, 4, 10)
    tok, cache = _prefill(cfg, params)
    g = E.DecodeGraph(cfg, 2, 10, torch.device("cpu"))
    g.prime(cache, tok, 6)
    for _ in range(3):
        g.step(cfg, params)
    assert torch.equal(torch.cat([tok[:, None], g.out[:, 6:9]], 1), want)
    assert int(g.pos) == 9 and torch.equal(g.token, want[:, -1])
    assert g.nbytes == sum(t.numel() * t.element_size()
                           for t in (g.cache["attn"]["k"], g.cache["attn"]["v"], g.token,
                                     g.pos, g.out))


def _params_of(cfg):
    return M.init_params(cfg, device="meta")


@pytest.mark.parametrize("arch,impl,want", [
    ("deepseek-7b", "capacity", True), ("qwen3-moe-30b-a3b", "capacity", True),
    ("qwen3-moe-30b-a3b", "grouped", True), ("qwen3-moe-30b-a3b", "ragged", False),
    ("mamba2-370m", "capacity", False), ("jamba-1.5-large-398b", "capacity", False),
    ("llama-3.2-vision-90b", "capacity", False), ("seamless-m4t-large-v2", "capacity", False)])
def test_graph_gate_reads_family_and_moe_impl(arch, impl, want):
    cfg = get_config(arch).reduced().replace(moe_impl=impl)
    params = _params_of(cfg)
    assert E.graph_decode_ok(cfg, params, CUDA) is want
    assert E.graph_decode_ok(cfg, params, torch.device("cpu")) is False


def test_graph_gate_is_false_for_dtensor_params(tmp_path):
    """A DTensor embedding (a mesh step) keeps the eager step, on CUDA too."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate

    cfg = get_config("deepseek-7b").reduced()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", [0])
        params = {"embed": DTensor.from_local(torch.zeros(4, 4), mesh, [Replicate()])}
        assert E.graph_decode_ok(cfg, params, CUDA) is False
        assert E.graph_decode_ok(cfg, {"embed": torch.zeros(4, 4)}, CUDA) is True
    finally:
        dist.destroy_process_group()


def test_param_layout_follows_addresses_shapes_and_dtypes():
    a = {"embed": torch.zeros(4, 8), "layers": {"w": torch.zeros(2, 8, 8)}}
    same = E.param_layout(a)
    assert E.param_layout(a) == same
    assert E.param_layout({"embed": a["embed"], "layers": {"w": a["layers"]["w"].clone()}}) != same
    assert E.param_layout({"embed": a["embed"], "layers": {"w": a["layers"]["w"][:1]}}) != same
    assert len(same) == 2 and same[1][1:] == ((2, 8, 8), (64, 8, 1), torch.float32)


@pytest.fixture
def cpu_engine(tmp_path):
    cfg = get_config("deepseek-7b").reduced().replace(n_layers=2)
    disk = DiskStore(str(tmp_path))
    publish_model(disk, cfg, M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
                  name="m")
    mrm = MRM(disk, device_capacity=1 << 30, host_capacity=1 << 30, device="cpu")
    return InferenceEngine(disk, mrm, device="cpu"), cfg


def test_cpu_requests_replay_nothing(cpu_engine):
    eng, cfg = cpu_engine
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    for _ in range(2):
        _, st = eng.generate("m", toks, max_new_tokens=4)
        assert st.graph_steps == 0
    assert (eng.graph_captures, eng.graph_replays, eng.graph_eager_steps) == (0, 0, 0)
    assert eng.graph_pool_bytes == 0


def test_pool_lends_one_graph_at_a_time_and_keeps_the_most_recent(cpu_engine):
    """The pool's rules, driven without a card: a key's first request gets a
    new graph, pooled and lent at once; a lent graph is not lent again (the
    second request steps eagerly); a returned one is lent as it is; beyond
    GRAPH_POOL the least recently used graph not lent out goes."""
    eng, cfg = cpu_engine
    g0 = eng._lend_graph(("k", 0), cfg, 1, 4)
    assert isinstance(g0, E.DecodeGraph) and g0.busy and g0.graph is None
    assert list(eng._graphs) == [("k", 0)]
    assert eng._lend_graph(("k", 0), cfg, 1, 4) is None    # still lent
    g0.busy = False
    assert eng._lend_graph(("k", 0), cfg, 1, 4) is g0      # lent again, as it is
    lent = eng._lend_graph(("k", 1), cfg, 1, 4)            # stays lent throughout
    for i in range(2, E.GRAPH_POOL + 2):
        g0.busy = False
        eng._lend_graph(("k", i), cfg, 1, 4).busy = False
    assert lent.busy and ("k", 1) in eng._graphs
    assert list(eng._graphs) == [("k", 1)] + [("k", i) for i in range(3, E.GRAPH_POOL + 2)]
    assert len(eng._graphs) == E.GRAPH_POOL
    assert eng.graph_pool_bytes == sum(g.nbytes for g in eng._graphs.values()) > 0


def test_a_capture_holds_device_syncs_off(monkeypatch):
    """On a card, ``synchronize`` waits while ``capturing()`` is open, and a
    capture waits for the syncs under way, so no thread's device sync (the
    MRM's staging and prefetch threads, other requests) falls inside a
    capture. The card's own sync is replaced by a recorder."""
    import threading

    from repro_torch import device as D

    cuda, log = torch.device("cuda"), []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev: log.append("sync"))
    with D.capturing():
        t = threading.Thread(target=D.synchronize, args=(cuda,))
        t.start()
        t.join(0.2)
        assert t.is_alive() and log == []
        log.append("capture end")
    t.join(5)
    assert log == ["capture end", "sync"]

    log.clear()
    started, go = threading.Event(), threading.Event()

    def slow(dev):
        started.set()
        go.wait(5)
        log.append("sync")

    def capture():
        with D.capturing():
            log.append("capture")

    monkeypatch.setattr(torch.cuda, "synchronize", slow)
    s = threading.Thread(target=D.synchronize, args=(cuda,))
    s.start()
    assert started.wait(5)
    c = threading.Thread(target=capture)
    c.start()
    c.join(0.2)
    assert c.is_alive() and log == []
    go.set()
    s.join(5)
    c.join(5)
    assert log == ["sync", "capture"]

"""The cell ``moon.decode_b64`` (Moonlight-16B-A3B, ``model_type``
``deepseek_v3``) on the CPU, at its architecture's tiny sizes in float32
and with its own traffic cut here (``conftest.TINY_TRAFFIC`` cuts the
three traffic files it names): a sound run is correct, and each fault the
cell can have (the shared ``stale_kv``, ``half_batch`` and
``altered_token``, and the architecture's ``no_route_bias`` and
``latent_no_rope``) fails its limit. Then the cell's counts against hand
figures.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from conftest import REPO, TINY_LIMIT, make_tiny_root
from trimsbench import faults, flops, weights
from trimsbench.run import run_cell
from trimsbench.spec import load_cell

CELL = "moon.decode_b64"
CUT = dict(batch=4, prompt=12, new_tokens=6)   # an even batch: half_batch halves it


@pytest.fixture(scope="module")
def moon_root(tmp_path_factory) -> Path:
    root = make_tiny_root(tmp_path_factory.mktemp("moon"))
    path = _traffic_path(root)
    t = json.loads(path.read_text())
    t.update(CUT)
    path.write_text(json.dumps(t))
    return root


def _traffic_path(root: Path) -> Path:
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    name = next(w["traffic"] for w in bench["workloads"] if w["name"] == CELL)
    return root / "trimsbench" / "traffic" / f"{name}.json"


def _run(root):
    return run_cell(load_cell(CELL, root), 2 ** 31 + 41, 0.3, False, torch.device("cpu"), 0.0)


FAULTS = faults.of_cell(load_cell(CELL).config, load_cell(CELL).traffic)


def test_the_cell_can_have_its_architectures_faults():
    assert FAULTS == ["altered_token", "half_batch", "latent_no_rope", "no_route_bias",
                      "stale_kv"]


def test_a_sound_tiny_run_is_correct(moon_root):
    res = _run(moon_root)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["logit_gap_mean"]["value"] <= TINY_LIMIT
    assert set(res["metrics"]) == {"tokens_per_s", "setup_s"}
    untraced = res["per_layer_untraced"]
    # the accepted decode readers read this cell too
    assert untraced["engine.graph_share.decode"] == 0.0        # no CUDA graph on the CPU
    assert untraced["engine.step_s.decode"] > 0 and untraced["model.mfu.decode"] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_each_fault_fails_its_limit(moon_root, monkeypatch, fault):
    c = load_cell(CELL, moon_root).config
    for mod, attr, fn in faults.patches(fault, c):
        monkeypatch.setattr(mod, attr, fn)
    res = _run(moon_root)
    assert not res["correct"]
    assert res["checks"]["logit_gap_max"]["value"] > 10 * TINY_LIMIT
    assert res["checks"]["logit_gap_mean"]["value"] > TINY_LIMIT


def test_the_control_fails_where_the_program_passes_at_a_small_size(moon_root):
    from trimsbench import check, serve
    got = load_cell(CELL, moon_root)
    c, t = got.config, got.traffic
    pool = serve.prompt_pool(c, t, 4)
    system = serve.build(c, t, 4, torch.device("cpu"))
    try:
        recs, _ = serve.ClosedLoop(system, t, pool).run(count=3)
    finally:
        system.close()
    g = check.served_gaps(c, 4, check.sample(recs, t["check_per_tenant"], 4), pool,
                          torch.device("cpu"), ("float8",))
    assert g["program"].max() <= TINY_LIMIT < g["float8"].max()


MOON = json.loads((REPO / "trimsbench/configs/moonlight-16b-a3b.l5.json").read_text())


def test_parameters_bytes_and_cache_of_the_configuration():
    assert weights.padded_vocab(MOON) == MOON["vocab_size"] == 163840
    assert round(weights.n_params(MOON) / 1e6, 1) == 2757.9
    assert round(weights.nbytes(MOON) / 1e9, 3) == 5.517
    # every width as published; only depth and the head's tie are cut
    assert MOON["reduced"] == ["num_hidden_layers", "tie_word_embeddings"]
    assert MOON["published"] == {"num_hidden_layers": 27, "tie_word_embeddings": False}
    assert (MOON["n_routed_experts"], MOON["num_experts_per_tok"], MOON["kv_lora_rank"]) == \
        (64, 6, 512)


def test_operations_of_a_request_by_hand():
    d, V, H = 2048, 163840, 16
    attn = d * H * 192 + d * 576 + 512 * H * 256 + H * 128 * d
    moe = attn + d * 64 + (6 + 2) * 3 * d * 1408
    dense = attn + 3 * d * 11264
    assert flops.layer_params_per_token(MOON) == moe
    B, S, new = 4, 100, 3
    per_tok = 2 * (4 * moe + dense)
    want = (per_tok * B * S + 5 * 2 * B * H * S * S * (192 + 128) / 2 + 2 * B * d * V
            + sum(per_tok * B + 5 * 2 * B * H * (S + i + 1) * (1024 + 64) + 2 * B * d * V
                  for i in range(new - 1)))
    assert flops.request_flops(MOON, B, S, new) == pytest.approx(want, rel=1e-12)
    bounds = flops.request_kernel_bounds(MOON, 64, 2048, 256)["mla_decode_kernel"]
    assert len(bounds) == 255 * 5
    # the first call reads 64 x 2049 rows of 1152 B: bound by bytes
    nbytes = 2 * (64 * 16 * 576 + 64 * 2049 * 576 + 64 * 16 * 512)
    assert bounds[0] == pytest.approx(nbytes / 3.35e12)


@pytest.mark.cuda
def test_the_control_fails_the_cells_limit_on_the_card(cuda_device):
    from trimsbench.calibrate import reading
    from trimsbench.run import ROOT
    got = load_cell(CELL, ROOT)
    r = reading(got, 2 ** 31 + 99, 3.0, True, cuda_device)
    for name, limit in got.config["limits"].items():
        stat = name.replace("logit_", "")
        assert r[f"program_{stat}"] <= limit < r[f"control_{stat}"], name

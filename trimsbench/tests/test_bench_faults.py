"""A run with the timed path broken underneath comes out not correct.

Each fault is planted in the port at run time and the rest of a run is
driven on the CPU (the harness's look for a card skipped), at a small size
served in float32, where a sound run reads a gap of rounding alone. The
faults (``faults.py``) are those each cell can have: decode steps that
leave the KV cache unchanged (only where requests decode), half of the
batch left out (its rows served the other half's tokens), and a served
token altered where it is produced. One card holds every cell, so no
exchange between cards can be left out.
"""
from __future__ import annotations

import pytest
import torch

from conftest import TINY_LIMIT
from trimsbench import faults
from trimsbench.run import run_cell
from trimsbench.spec import load_cell

CELLS = ["dsk7.faas_swap", "dsk7.faas_warm", "qmoe.decode_b32"]
CASES = [(cell, fault) for cell in CELLS
         for fault in faults.of_cell(load_cell(cell).config, load_cell(cell).traffic)]


def _run(root, cell, seed=21):
    return run_cell(load_cell(cell, root), seed, 0.5, False, torch.device("cpu"), 0.0)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_root, cell):
    res = _run(tiny_root, cell)
    assert res["correct"] and res["checks"]["logit_gap_max"]["value"] <= TINY_LIMIT


@pytest.mark.parametrize("cell, fault", CASES)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    for mod, attr, fn in faults.patches(fault, load_cell(cell, tiny_root).config):
        monkeypatch.setattr(mod, attr, fn)
    res = _run(tiny_root, cell)
    assert not res["correct"]
    assert res["checks"]["logit_gap_max"]["value"] > 10 * TINY_LIMIT
    assert res["checks"]["logit_gap_mean"]["value"] > TINY_LIMIT


def test_a_tenant_served_another_tenants_weights_is_not_correct(tiny_root, monkeypatch):
    from trimsbench import serve
    orig = serve.Request

    def swapped(model, tokens, max_new):
        return orig(model={"t2": "t1"}.get(model, model), tokens=tokens, max_new=max_new)
    monkeypatch.setattr(serve, "Request", swapped)
    res = _run(tiny_root, "dsk7.faas_swap")
    assert not res["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes_at_a_small_size(tiny_root, cell):
    """The float8 control at the tiny size against the float32 program's
    gaps; the card's readings at the cells' own sizes are in PERF.md."""
    from trimsbench import check, serve
    got = load_cell(cell, tiny_root)
    c, t = got.config, got.traffic
    pool = serve.prompt_pool(c, t, 4)
    system = serve.build(c, t, 4, torch.device("cpu"))
    try:
        recs, _ = serve.ClosedLoop(system, t, pool).run(count=6)
    finally:
        system.close()
    g = check.served_gaps(c, 4, check.sample(recs, t["check_per_tenant"], 4), pool,
                          torch.device("cpu"), ("float8",))
    assert g["program"].max() <= TINY_LIMIT < g["float8"].max()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cells_limit_on_the_card(cuda_device, cell):
    from trimsbench.calibrate import reading
    from trimsbench.run import ROOT
    got = load_cell(cell, ROOT)
    r = reading(got, 2 ** 31 + 99, 3.0, True, cuda_device)
    for name, limit in got.config["limits"].items():
        stat = name.replace("logit_", "")
        assert r[f"program_{stat}"] <= limit < r[f"control_{stat}"], name

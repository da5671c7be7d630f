"""The reader of ``engine.graph_share.decode``: decode steps replayed from a
CUDA graph over all decode steps of the window's requests."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from conftest import REPO
from trimsbench.spec import _load_reader

read = _load_reader(REPO, "engine.graph_share.decode")


def _run(*records):
    """A run of finished requests, each ``(new tokens, stats fields)``."""
    return SimpleNamespace(done=[SimpleNamespace(tokens=np.zeros((4, n), np.int32),
                                                 stats=SimpleNamespace(**kw))
                                 for n, kw in records])


def test_stats_without_graph_steps_read_as_nothing():
    assert read(_run((128, {}), (128, {}))) is None
    assert read(_run((128, {"graph_steps": 127}), (128, {}))) is None
    assert read(_run()) is None
    assert read(_run((1, {"graph_steps": 0}))) is None          # no decode step


def test_every_step_replayed_reads_100():
    assert read(_run((128, {"graph_steps": 127}), (128, {"graph_steps": 127}))) == 100.0


def test_mixed_records_weigh_by_decode_steps():
    # 126 + 0 + 9 replayed of 127 + 127 + 9 steps
    got = read(_run((128, {"graph_steps": 126}), (128, {"graph_steps": 0}),
                    (10, {"graph_steps": 9})))
    assert got == pytest.approx(100.0 * 135 / 263)

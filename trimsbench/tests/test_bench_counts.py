"""The counters of parameters, operations and bytes against hand figures,
and the traffic's tenant order against the MRM's LRU tier."""
from __future__ import annotations

import json
from collections import OrderedDict

import numpy as np
import pytest
import torch

from conftest import REPO
from trimsbench import flops, serve, weights

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def _config(name):
    return json.loads((REPO / f"trimsbench/configs/{name}.json").read_text())


def _traffic(name):
    return json.loads((REPO / f"trimsbench/traffic/{name}.json").read_text())


DSK, QMOE = _config("deepseek-7b.l2"), _config("qwen3-moe-30b-a3b.l2")


def test_parameters_and_bytes_of_each_configuration():
    assert weights.padded_vocab(DSK) == DSK["vocab_size"]
    assert round(weights.n_params(DSK) / 1e6, 1) == 824.2
    assert round(weights.nbytes(DSK) / 1e9, 3) == 1.648
    pad = (152064 - 151936) * 2048             # the port pads the vocabulary
    assert weights.padded_vocab(QMOE) == 152064
    assert round((weights.n_params(QMOE) - pad) / 1e6, 1) == 1557.4
    assert round(weights.nbytes(QMOE) / 1e9, 3) == 3.116


def test_operations_of_a_deepseek_request():
    # 16 x 1024 and 16 new tokens: 2 x 404.8 M x 16384 of prefill, 0.27
    # TFLOP of causal attention, 15 decode steps of 26.4 GFLOP
    assert round(flops.request_flops(DSK, 16, 1024, 16) / 1e12, 2) == 13.95
    # the cells' 16 x 2048 and 1 new token: 26.53 of prefill, 1.10 of
    # attention, the head at the last position only
    t = _traffic("faas_warm")
    total = flops.request_flops(DSK, t["batch"], t["prompt"], t["new_tokens"])
    n = 2 * (4 * 4096 ** 2 + 3 * 4096 * 11008)                     # 404.75 M
    prefill = 2 * n * 16 * 2048 + 2 * (2 * 16 * 32 * 2048 ** 2 * 128)
    head = 2 * 16 * 4096 * 102400
    assert t["new_tokens"] == 1
    assert total == pytest.approx(prefill + head, rel=1e-4)
    assert round(total / 1e12, 2) == 27.64
    # attention of one prefill layer, causal: 2 * B * H * S^2 * hd
    ops, nbytes = flops.flash_call(DSK, 16, 1024)
    assert ops == 2 * 16 * 32 * 1024 ** 2 * 128 and nbytes == 2 * 16 * 1024 * 128 * 128
    bounds = flops.request_kernel_bounds(DSK, 16, 1024, 16)
    assert len(bounds["flash_fwd"]) == 2 and len(bounds["decode_split_kernel"]) == 15 * 2
    assert bounds["flash_fwd"][0] == pytest.approx(nbytes / 3.35e12)


def test_moe_operations_count_the_routed_top_k():
    per_tok = flops.layer_params_per_token(QMOE)
    attn = 2048 * 4096 + 2 * 2048 * 512 + 4096 * 2048
    assert per_tok == attn + 8 * 3 * 2048 * 768 + 2048 * 128
    ops, nbytes = flops.decode_call(QMOE, 32, 300)
    assert ops == 4 * 32 * 32 * 300 * 128
    assert nbytes == 2 * 32 * 128 * (2 * 32 + 2 * 4 * 300)


def _lru_host_hits(order, n, slots=2):
    tier, hits = OrderedDict(), []
    for i in range(n):
        m = order[i % len(order)]
        if m in tier:
            tier.move_to_end(m)
            hits.append(False)
        else:
            if len(tier) == slots:
                tier.popitem(last=False)
            tier[m] = True
            hits.append(True)
    return hits


def test_the_cyclic_order_gives_a_third_host_hits_under_a_two_model_lru():
    t = _traffic("faas_swap")
    hits = _lru_host_hits(t["order"], 12 + 600)[12:]       # after the warm-up
    assert sum(hits) * 3 == len(hits)
    for k in range(0, 600, 6):
        assert sum(hits[k:k + 6]) == 2


def test_the_window_holds_enough_requests_for_its_tail():
    # the lowest rate measured on the card for each latency cell (PERF.md)
    lowest = {"dsk7.faas_swap": 5.5, "dsk7.faas_warm": 12.0}
    for cell, rate in lowest.items():
        assert rate * BENCH["run_seconds"] >= 200, cell


def test_prompts_depend_on_the_seed_and_their_sizes_do_not():
    t = _traffic("faas_swap")
    a, b = serve.prompt_pool(DSK, t, 1), serve.prompt_pool(DSK, t, 2 ** 31 + 5)
    assert [p.shape for p in a] == [p.shape for p in b] == [(16, 2048)] * t["prompts"]
    assert not np.array_equal(a[0], b[0])
    assert np.array_equal(a[3], serve.prompt_pool(DSK, t, 1)[3])
    assert all(p.max() < DSK["vocab_size"] for p in a)


def test_weights_are_drawn_from_the_seed_and_differ_by_tenant():
    c = dict(DSK, hidden_size=64, intermediate_size=96, num_attention_heads=4,
             num_key_value_heads=4, vocab_size=300)
    w0 = weights.draw(c, weights.tenant_seed(9, 0), "cpu")
    again = weights.draw(c, weights.tenant_seed(9, 0), "cpu")
    w1 = weights.draw(c, weights.tenant_seed(9, 1), "cpu")
    assert all(torch.equal(w0[k], again[k]) for k in w0)
    assert not torch.equal(w0["layers/attn/wq"], w1["layers/attn/wq"])
    norm = w0["layers/ln1/scale"].float()
    assert 0.1 < norm.std() < 0.3 and abs(norm.mean() - 1) < 0.1
    assert sum(t.numel() * t.element_size() for t in w0.values()) == weights.nbytes(c)


def test_the_mrm_serves_the_cyclic_order_with_a_third_host_hits(tiny_root):
    from trimsbench.spec import load_cell
    cell = load_cell("dsk7.faas_swap", tiny_root)
    t = dict(cell.traffic, clients=1)
    system = serve.build(cell.config, t, 3, torch.device("cpu"))
    try:
        loop = serve.ClosedLoop(system, t, serve.prompt_pool(cell.config, t, 3))
        loop.run(count=t["warmup_requests"])
        recs, _ = loop.run(count=24)
    finally:
        system.close()
    tiers = [r.stats.tier_hit for r in recs]
    assert tiers.count("host") == 8 and tiers.count("device") == 16

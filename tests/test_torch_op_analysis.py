"""The port's ``launch/op_analysis.py`` on the cases of
``tests/test_hlo_analysis.py``, as torch programs (exact counts):

- a loop of N layers counts N times one layer's dot FLOPs, forward and
  backward, and the recompute of ``torch.utils.checkpoint`` once more;
- each collective kind on a fake process group of 8 gives the ring-model
  bytes (a subprocess: the fake group stays out of the test process);
- views and reshapes add no traffic; a product adds its operands' and
  result's bytes.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch.utils.checkpoint

from repro_torch.launch.op_analysis import OpAnalysis, analyze

ROOT = Path(__file__).resolve().parents[1]
L, B, D = 6, 32, 16


def _layers(remat: bool):
    a = torch.randn(B, D, requires_grad=True)
    ws = [torch.randn(D, D, requires_grad=True) for _ in range(L)]

    def body(x, w):
        return torch.tanh(x @ w)

    def run():
        x = a
        for w in ws:
            x = (torch.utils.checkpoint.checkpoint(body, x, w, use_reentrant=False)
                 if remat else body(x, w))
        torch.autograd.grad(x.sum(), [a, *ws])

    return run


def test_layer_loop_counts_every_trip():
    one = 2 * B * D * D
    _, fwd = analyze(lambda: torch.tanh(torch.randn(B, D) @ torch.randn(D, D)))
    assert fwd.dot_flops == one
    _, s = analyze(_layers(remat=False))
    assert s.dot_flops == L * 3 * one          # forward, and the two backward products
    _, r = analyze(_layers(remat=True))
    assert r.dot_flops == L * 4 * one          # + the recomputed forward


def test_views_add_no_traffic():
    x = torch.randn(64, 32)
    with OpAnalysis() as oa:
        y = x.view(32, 64).reshape(2048).unsqueeze(0).transpose(0, 1)[:, 0]
    assert y.shape == (2048,)
    assert oa.traffic_bytes == 0
    w = torch.randn(32, 16)
    with OpAnalysis() as oa:
        x @ w
    assert oa.traffic_bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4


PROBE = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, "src")
    import torch, torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    from repro_torch.launch.op_analysis import OpAnalysis
    group = dist.group.WORLD
    x = torch.randn(128, 64)
    with OpAnalysis() as oa:
        funcol.all_reduce(x, "sum", group).wait()
        funcol.all_gather_tensor(x, 0, group).wait()
        funcol.reduce_scatter_tensor(x, "sum", 0, group).wait()
        funcol.all_to_all_single(x, None, None, group).wait()
    s = oa.summary()
    print(json.dumps({"bytes": s.coll_bytes, "counts": s.coll_counts,
                      "total": s.total_coll_bytes}))
""")


def test_collectives_on_a_fake_group_of_eight():
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    R, n = 128 * 64 * 4, 8
    assert out["bytes"]["all-reduce"] == pytest.approx(2 * R * (n - 1) / n)
    assert out["bytes"]["all-gather"] == pytest.approx(n * R * (n - 1) / n)   # result = n x R
    assert out["bytes"]["reduce-scatter"] == pytest.approx(R / n * (n - 1))   # result = R / n
    assert out["bytes"]["all-to-all"] == pytest.approx(R * (n - 1) / n)
    assert all(c == 1 for c in out["counts"].values())
    assert out["total"] == pytest.approx(sum(out["bytes"].values()))

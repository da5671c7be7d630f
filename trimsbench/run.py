"""Run one cell of the port's benchmark once and print its result line.

    python3 trimsbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. Set-up
publishes the cell's tenants (weights drawn on the card from the seed),
starts the MRM, the engine and the workers, and sends the traffic's warm-up
requests, which build the kernels and touch every shape the window uses.
The window opens at its first request and closes when the last request
sent before ``--seconds`` have passed returns. With ``--trace 1`` the
profiler records the card over the whole window and the per-layer metrics
are reported instead of the end-to-end ones; without it, the per-layer
metrics that need no trace are given apart (``per_layer_untraced``), so
that the profiler's cost to the spans can be read. Then the program's state is
freed and a sample of the served tokens is held against the plain
reference (``check.py``). The numbers compared, each beside its limit, are
the last lines on standard error; the result is the last line on standard
output, one JSON object whose last key, ``checks``, holds them again.

Exits with 3, printing no result, where the card or cards are missing, and
with 4 where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()     # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _prepare_process() -> None:
    """Import paths (the harness and the program, from this checkout) and
    fixed cache directories inside the checkout."""
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != Path(here)]
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = ROOT / "build" / "trimsbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


@dataclass
class Run:
    """What a metric's reader reads: the cell's configuration ``c`` and
    traffic ``t``; every request of the window (``records``: latency, the
    engine's ``RequestStats``, tokens, error); the window's length and the
    set-up time (host clock); each MRM open in the window as (time, tier
    hit, bytes, measured H2D seconds); the trace summary (``--trace 1``)."""
    c: dict
    t: dict
    records: list
    window_s: float
    setup_s: float
    opens: list
    trace: object = None

    @property
    def done(self) -> list:
        return [r for r in self.records if r.error is None]


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


@dataclass
class Served:
    """One cell set up, warmed and measured, its program state freed."""
    run: Run
    pool: list
    peak_bytes: int


def serve_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Served:
    """Set up and warm up one cell, measure its window (traced with
    ``trace``), read the memory peak and free the program's state."""
    import torch

    from trimsbench import devtrace, serve

    c, t = cell.config, cell.traffic
    pool = serve.prompt_pool(c, t, seed)
    system = serve.build(c, t, seed, device)
    loop = serve.ClosedLoop(system, t, pool)
    bad = [r.error for r in loop.run(count=t["warmup_requests"])[0] if r.error is not None]
    if bad:
        raise RuntimeError(f"a warm-up request failed: {bad[0]}")
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        # events are read raw (devtrace), so none need accumulating
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events")
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    records, t_open = loop.run(seconds=seconds)
    if prof is not None:
        torch.cuda.synchronize(device)
        prof.stop()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run = Run(c, t, records, max(r.done for r in records) - t_open, t_open - t_start,
              [o for o in system.opens if o[0] >= t_open])
    if prof is not None:
        run.trace = devtrace.from_profiler(prof, min(r.submit_ns for r in records),
                                           max(r.done_ns for r in records),
                                           [(r.submit_ns, r.done_ns) for r in records])
        del prof
    system.close()
    del system, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return Served(run, pool, int(peak))


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Serve, check and report one cell; returns the result line."""
    import torch

    from trimsbench import check

    served = serve_cell(cell, seed, seconds, trace, device, t_start)
    run = served.run
    checks = check.run_check(run.c, run.t, seed, run.records, served.pool, device)
    metrics, untraced = {}, {}
    for m in cell.metrics:
        if m.per_layer == bool(trace):
            v = m.read(run)
            if v is not None:
                metrics[m.name] = {"value": float(v), "unit": m.unit}
        elif m.per_layer:
            # spans and counters read without the profiler, beside the traced run's
            v = m.read(run)
            if v is not None:
                untraced[m.name] = float(v)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": served.peak_bytes}
    result = {"correct": all(v["value"] <= v["limit"] for v in checks.values()),
              "attempted": len(run.records), "failed": len(run.records) - len(run.done),
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace.busy_s, run.trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in run.trace.device_ops],
                               "idle_gaps": [list(x) for x in run.trace.idle_gaps]}
    result["card"] = {"power_limit_w": power_limit_w() if device.type == "cuda" else None}
    if untraced:
        result["per_layer_untraced"] = untraced
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _prepare_process()
    from trimsbench.spec import load_cell
    cell = load_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_PROCESS)
    found = loaded_forbidden()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 4
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the limits of the correctness check are set from.

    python3 trimsbench/calibrate.py --workload <name> --seeds 11 12 13 \
        [--control 3] [--seconds 8] [--fault stale_kv] [--out cal.jsonl]

For each seed, in one process: set the cell up as a run does, send its
warm-up, run a short window at the cell's own load, free the program's
state, and read how far the sampled served tokens lie below the float32
reference's best (the program's readings: widest, mean, quantiles). For
the first ``--control`` seeds also read the control: at the same positions
of the same prompts and served tokens, the gap of the token that the
reference computed in float8 e4m3 puts first; ``--witness bfloat16`` reads
the same for the reference with bf16 operands. ``--fault`` plants one of
``faults.py``'s faults in the program first, so that the program's
readings are the fault's. One JSON line per seed. Not part of a benchmark
run; it needs the cell's cards.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional

sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]
sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]

from trimsbench import faults  # noqa: E402
from trimsbench.run import ROOT, _prepare_process, serve_cell  # noqa: E402


def reading(cell, seed: int, seconds: float, control: bool, device,
            witness: tuple = (), fault: Optional[str] = None) -> dict:
    from trimsbench import check
    t0 = time.perf_counter()
    served = serve_cell(cell, seed, seconds, False, device, t0)
    run = served.run
    reqs = check.sample(run.records, run.t["check_per_tenant"], seed)
    t1 = time.perf_counter()
    others = (("float8",) if control else ()) + tuple(witness)
    g = check.served_gaps(run.c, seed, reqs, served.pool, device, others)
    out = {"workload": cell.name, "seed": seed, "fault": fault, "setup_s": run.setup_s,
           "requests": len(run.records), "failed": len(run.records) - len(run.done),
           "tokens": int(g["program"].numel()),
           "host_hits_sampled": sum(r.stats.tier_hit == "host" for r in reqs),
           "check_s": time.perf_counter() - t1}
    for k, v in g.items():
        name = {"program": "program", "float8": "control"}.get(k, k)
        out.update({f"{name}_gap_max": float(v.max()), f"{name}_gap_mean": float(v.mean()),
                    f"{name}_gap_p99": float(v.quantile(0.99)),
                    f"{name}_gap_p90": float(v.quantile(0.90)),
                    f"{name}_not_top": float((v > 0).float().mean())})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", default=None,
                    help="plant this fault of the timed path first (faults.of_cell)")
    ap.add_argument("--witness", nargs="*", default=[],
                    help="also read the reference in these precisions (bfloat16)")
    args = ap.parse_args(argv)
    _prepare_process()
    import torch

    from trimsbench.spec import load_cell
    cell = load_cell(args.workload, ROOT)
    if args.fault:
        can = faults.of_cell(cell.config, cell.traffic)
        if args.fault not in can:
            ap.error(f"--fault: {cell.name} can have {can}, not {args.fault!r}")
        faults.plant(args.fault, cell.config)
    device = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        line = json.dumps(reading(cell, seed, args.seconds, i < args.control, device,
                                  tuple(args.witness), args.fault))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

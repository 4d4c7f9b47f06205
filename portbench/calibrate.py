"""Readings that a cell's limits are set from, on the card, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 101-112 \
        [--control-seeds 101-103] [--fault half_batch --fault-seeds 301-303] \
        [--seconds 30] --out readings/cal_<cell>.jsonl

For each seed it runs the cell as ``run.py`` does (set-up, a window of
``--seconds``, release, check) and writes one JSON line: the readings
of the sound program; on a control seed also the control's (the plain
reference in float8 put in the program's place); on a fault seed those
of the program with the fault planted.  Each set of readings goes
through the harness's own comparison under the cell's limits, and the
line says whether it came out ``correct``.  Never part of a benchmark
run.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

from portbench.harness import bench, spec  # noqa: E402


def seeds(text: str):
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: CUDA is not available", file=sys.stderr)
        return 2
    cell = spec.Cell(args.workload, spec.benchmark())
    control = set(seeds(args.control_seeds))
    plan = [(s, None) for s in seeds(args.seeds)]
    plan += [(s, None) for s in sorted(control - {s for s, _ in plan})]
    plan += [(s, args.fault) for s in seeds(args.fault_seeds)]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed, fault in plan:
        t0 = time.time()
        ctx = bench.Ctx(cell, seed, args.seconds, False, "cuda", t0)
        res = bench.execute(ctx, cell.mix(), fault,
                            control=fault is None and seed in control)
        control_readings = getattr(ctx, "control", None)
        rec = {"cell": cell.name, "seed": seed, "fault": fault,
               "readings": res["readings"],
               "correct": bench.is_correct(res["readings"], cell.limits,
                                           res["failed"]),
               "checks": bench.checks_of(res["readings"], cell.limits),
               "control": control_readings,
               "e2e": res["e2e"], "attempted": res["attempted"],
               "setup_s": res["setup_s"], "check_s": res["check_s"],
               "peak": res["peak"],
               "checked": getattr(ctx, "n_checked", None),
               "kv_checked": getattr(ctx, "n_kv_checked", None),
               "detail": getattr(ctx, "detail", None),
               "control_detail": getattr(ctx, "control_detail", None),
               "wall_s": time.time() - t0,
               "device": torch.cuda.get_device_name(0)}
        if control_readings is not None:
            rec["control_correct"] = bench.is_correct(control_readings,
                                                      cell.limits, 0)
            rec["control_checks"] = bench.checks_of(control_readings,
                                                    cell.limits)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
        del ctx, res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

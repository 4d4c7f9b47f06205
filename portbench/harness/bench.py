"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's mix (``portbench/mixes/<mix>.py``) builds the program under
test from the cell's configuration and seed, drives it through its first
work and warms every shape it will use (set-up), then runs it for
``--seconds`` (the window).  With ``--trace 1`` the port's layer calls
run inside spans during the window, and a ``torch.profiler`` window of a
few more steps or requests follows it.  Then the peak memory is read,
the program's state is freed, and the mix's plain reference judges what
the program produced.  The last line on standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared, beside its limit.  The same numbers end standard error.

Without CUDA, or with fewer cards than the cell asks for, it prints no
result and exits 2.  If ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the
JAX package) is loaded once the window has closed it exits 3.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from typing import Any, Dict, Optional

from portbench.harness import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Ctx:
    """What a mix and a metric reader see of one run."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float,
                 trace: bool, device: str, t_start: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.t_start = trace, device, t_start
        self.m = cell.conf["model"]          # the sizes as run
        self.p = cell.params                 # the traffic parameters
        self.spans = None                    # harness.spans.Spans, traced
        self.span_ms: Dict[str, float] = {}
        self.units = 0                       # steps or requests in window
        self.window_s = 0.0
        self.flops = 0.0                     # model FLOPs of the window
        self.prof: Optional[Dict] = None     # harness.profile summary
        self.prof_units = 0
        self.prof_fwht_bytes = 0.0
        self.marks = []                      # (set-up phase, s from start)

    def mark(self, phase: str) -> None:
        self.marks.append((phase, time.time() - self.t_start))


def loaded_forbidden() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(ctx: Ctx, mix, fault: Optional[str] = None,
            control: bool = False) -> Dict[str, Any]:
    """Set-up, window, (profile), peak, release, check: the run's
    numbers.  ``fault``: a fault that the mix plants in the program;
    ``control``: the mix also reads the control (the reference in float8
    in the program's place) into ``ctx.control``.  Both are for
    ``portbench/calibrate.py`` and the tests, never a run of the
    benchmark."""
    import torch
    from portbench.harness import profile, spans
    cuda = ctx.device != "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ctx.mark("imports")
    mix.setup(ctx, fault)
    setup_s = time.time() - ctx.t_start
    if ctx.trace:
        ctx.spans = spans.Spans()
        ctx.spans.install(mix.SPANS)
    e2e, attempted, failed = mix.window(ctx)
    if ctx.trace:
        ctx.span_ms = ctx.spans.totals_ms()
        ctx.spans.on = False
        ctx.prof = profile.run(lambda: mix.profile_work(ctx))
        ctx.spans.uninstall()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    mix.release(ctx)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.time()
    readings = mix.check(ctx, control)
    return {"setup_s": setup_s, "e2e": e2e, "attempted": attempted,
            "failed": failed, "peak": peak, "readings": readings,
            "check_s": time.time() - t_check}


def per_layer(ctx: Ctx) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in ctx.cell.per_layer:
        value = ctx.cell.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def checks_of(readings: Dict[str, float], limits: Dict[str, float]):
    """Each limit's reading; a reading that is missing or not finite
    fails."""
    out = {}
    for name, limit in limits.items():
        value = readings.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        out[name] = {"value": _num(value), "limit": limit, "ok": ok}
    return out


def is_correct(readings: Dict[str, float], limits: Dict[str, float],
               failed: int) -> bool:
    """``correct``: every reading within its limit, and no failed unit."""
    return (all(c["ok"] for c in checks_of(readings, limits).values())
            and failed == 0)


def _num(x):
    return float(x) if x is not None and math.isfinite(x) else None


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = spec.benchmark()
    cell = spec.Cell(args.workload, bench)
    import torch
    if not torch.cuda.is_available():
        print("portbench: CUDA is not available; this benchmark runs on "
              "the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.entry["chips"]:
        print(f"portbench: {cell.name} needs {cell.entry['chips']} cards, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    ctx = Ctx(cell, args.seed, args.seconds, bool(args.trace), "cuda",
              t_start)
    res = execute(ctx, cell.mix())
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {bad} (the JAX package or JAX); "
              "no result", file=sys.stderr)
        return 3
    checks = checks_of(res["readings"], cell.limits)
    correct = is_correct(res["readings"], cell.limits, res["failed"])
    if args.trace:
        metrics = per_layer(ctx)
    else:
        metrics = {"setup_s": {"value": res["setup_s"], "unit": "s"}}
        for m in cell.end_to_end:
            if m["name"] != "setup_s":
                metrics[m["name"]] = {"value": res["e2e"][m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.entry["chips"],
              "memory_peak_bytes": int(res["peak"])}
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = ctx.prof["busy_s"]
        device["window_s"] = ctx.prof["window_s"]
        line["breakdown"] = {"device_ops": ctx.prof["device_ops"],
                             "idle_gaps": ctx.prof["idle_gaps"]}
    line["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                      for k, v in checks.items()}
    sys.stdout.flush()
    print("set-up: " + ", ".join(f"{p} {t:.2f} s" for p, t in ctx.marks),
          file=sys.stderr)
    print(f"reference check {res['check_s']:.2f} s", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


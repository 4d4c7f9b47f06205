"""A copy of the benchmark's tree with small cells of the same
configurations (the port's smoke presets), for the CPU tests."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from portbench.harness import bench, spec

SMALL_GLM = dict(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                 head_dim=16, d_ff=384, vocab_size=512, preset="smoke")
SMALL_GRANITE = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                     head_dim=32, d_ff=128, vocab_size=512, preset="smoke")
# serving's control drifts from the reference as the stack deepens: at
# two layers it stays under the full-size cell's limits, at six it does
# not, as at 28 on the card
SERVE_LAYERS = 6
CELLS = {"p-smoke": ("chatglm3-prefill-long", "glm-serve-smoke"),
         "t-smoke": ("chatglm3-train-4k", "glm-smoke"),
         "g-smoke": ("granite-moe-train-2k", "granite-smoke")}


def tree(dst: Path) -> Path:
    """The benchmark copied under ``dst`` with the cells of ``CELLS``
    added as files, and their entries in ``dst/BENCHMARK.json``."""
    base = dst / "portbench"
    shutil.copytree(spec.PORTBENCH, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = spec.benchmark()
    for name, src, small in (("glm-smoke", "chatglm3-6b", SMALL_GLM),
                             ("glm-serve-smoke", "chatglm3-6b",
                              dict(SMALL_GLM, n_layers=SERVE_LAYERS)),
                             ("granite-smoke", "granite-moe-3b-a800m",
                              SMALL_GRANITE)):
        c = spec.read_json(base / "configs" / f"{src}.json")
        c["name"] = name
        c["model"].update(small)
        if c["model"]["moe"]:
            c["model"]["moe"].update(n_experts=8, top_k=2, d_expert=64)
        (base / "configs" / f"{name}.json").write_text(json.dumps(c))
    for name, (like, conf) in CELLS.items():
        w = spec.read_json(base / "workloads" / f"{like}.json")
        w["config"] = conf
        if w["mix"] == "prefill_ship":
            w["params"]["lengths"].update(min=64, max=512, round=64,
                                          round_tiled=128, tiled_above=256,
                                          pool=8)
            w["params"].update(max_requests=512, sample=0.5)
        else:
            w["params"].update(batch=4, seq=64, min_coded_size=4096)
        (base / "workloads" / f"{name}.json").write_text(json.dumps(w))
        b["workloads"].append({"name": name, "config": conf,
                               "traffic": w["traffic"], "chips": 1,
                               "why": "small cell for the CPU tests"})
        for m in b["end_to_end"] + b["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    (dst / "BENCHMARK.json").write_text(json.dumps(b))
    return dst


def run(root: Path, cell: str, seed: int = 1234567890123, seconds=0.3,
        fault=None, control=False, device="cpu"):
    """One run of a cell of the tree at ``root`` past the look for a
    card: (ctx, result)."""
    c = spec.Cell(cell, spec.benchmark(root), root / "portbench")
    ctx = bench.Ctx(c, seed, seconds, False, device, time.time())
    res = bench.execute(ctx, c.mix(), fault, control=control)
    return ctx, res


def correct(ctx, readings) -> bool:
    """``correct`` as the harness decides it, under the limits of the
    full-size cell that the small one stands for."""
    like = CELLS[ctx.cell.name][0]
    limits = spec.read_json(spec.PORTBENCH / "workloads"
                            / f"{like}.json")["limits"]
    return bench.is_correct(readings, limits, 0)

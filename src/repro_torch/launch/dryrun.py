"""Production-scale dry run: trace every (arch x shape x mesh) cell of a
rank on torch's fake process group (port of ``repro/launch/dryrun.py``).

One process plays one rank (``--rank``, 0 by default) of a mesh of 256,
512 or 1,024 ranks: it joins a ``fake`` process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``), sets the mesh as the
global one, and runs the builders the card runs (``make_train_step(...,
donate=True)``, ``serve_step.make_prefill``/``make_decode`` with the
rank's ``tp`` and ``rows``) on the rank's meta tensors
(``launch/specs.py``).  :class:`repro_torch.launch.costs.CostMode` sees
every op and collective the rank issues, backward and remat recompute
included.  That is torch's counterpart of lowering on forced host
devices: it proves the distribution config is coherent (the shards
partition, the collectives are legal on the mesh's groups) and reckons
each rank's memory, FLOPs, HBM bytes and collective bytes.

The fake group moves no bytes and times nothing: its collectives return
at once and leave their outputs as they were, so every number here is
reckoned from shapes, and ``trace_s`` is the host's time to trace, not a
step time.  This entry point runs no device by design (every tensor is
on meta), so it is the one entry point that does not go through
``repro_torch.resolve_device``.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --multi-pod
    python -m repro_torch.launch.dryrun --scale-check   # 512, 1,024 ranks
    python -m repro_torch.launch.dryrun --serve-check   # 256, 512 ranks
    python -m repro_torch.launch.dryrun --all           # every runnable cell

Each record is written to ``results/dryrun/`` (ignored by git).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch.distributed as dist

import repro_torch
import repro_torch.configs as C
from repro_torch import sharding as shd
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core.transport.coupling import CollectiveMode
from repro_torch.launch import costs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs
from repro_torch.models import convert
from repro_torch.optim import adamw
from repro_torch.serve import serve_step
from repro_torch.train import train_step as ts

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "..", "results", "dryrun")
DROP = 0.05                  # the traced step's drop rate (shapes only)
PLAIN_COLLECTIVES = {"all_reduce", "all_gather", "all_to_all",
                     "reduce_scatter"}


def fake_world(n_ranks: int, rank: int = 0) -> None:
    """Join a ``fake`` process group of ``n_ranks`` as ``rank`` (leaving
    any group this process is in)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n_ranks)


def config(arch: str, layers=None):
    """``arch``'s config, its depth cut to ``layers`` where given (the
    widths stay the published ones)."""
    cfg = C.get(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.mesh.shape)


def microbatches(cfg) -> int:
    """JAX's rule (``dryrun.py:81``): accumulation so multi-billion
    parameter train cells fit."""
    n = cfg.param_count()
    return 4 if n >= 6e9 else (2 if n >= 2e9 else 1)


def _train_call(cfg, shape, mesh, mode, micro=1, quantize_wire=False):
    """(the step, its arguments) of one train cell on this rank."""
    parsed = CollectiveMode.parse(mode)
    state = specs.locals_of(specs.abstract_state(cfg, mesh))
    batch = specs.locals_of(specs.train_input_specs(cfg, shape, mesh))
    drop = DROP
    if parsed.hierarchical:
        n_pods = shd.axis_sizes(mesh).get(shd.POD_AXIS, 1)
        if n_pods > 1:            # the per-pod (n_pods + 1,) drop vector
            drop = np.full(n_pods + 1, DROP, np.float32)
    step = ts.make_train_step(
        cfg, mesh, adamw.OptConfig(),
        ts.CelerisConfig(mode=mode, lossy_moe=parsed.lossy
                         and cfg.moe is not None,
                         quantize_wire=quantize_wire),
        microbatches=micro, donate=True)
    return step, (state, batch, repro_torch.generator("meta"), drop)


def _serve_call(cfg, shape, mesh):
    """One prefill or decode cell on this rank, as a call that takes no
    arguments."""
    tp, rows = serve_step.mesh_groups(cfg, mesh)
    leaves = [p.local for p in specs.abstract_params(cfg, mesh)]
    params = convert.params_from_leaves(leaves, cfg)
    if shape.kind == "prefill":
        batch = specs.locals_of(specs.prefill_input_specs(cfg, shape, mesh))
        fn = serve_step.make_prefill(cfg, shape.seq_len, tp, rows)
        tokens = batch.pop("tokens")
        return lambda: fn(params, tokens, **batch)
    if shape.kind == "decode":
        batch, caches, _ = specs.decode_input_specs(cfg, shape, mesh, tp)
        batch, caches = specs.locals_of(batch), specs.locals_of(caches)
        fn = serve_step.make_decode(cfg, tp, rows)
        return lambda: fn(params, caches, batch["tokens"],
                          shape.seq_len - 1, batch.get("memory"))
    raise ValueError(f"{shape.name} is not a serve shape")


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               celeris: bool = True, quantize_wire: bool = False,
               rank: int = 0, layers=None):
    """One cell on the production mesh (16 x 16, or 2 x 16 x 16): the
    record of JAX's ``lower_cell`` under its keys where they mean the
    same (``memory.peak_bytes``, ``collectives``,
    ``collective_bytes_total``, ``model_flops``, ``roofline``), ``costs``
    for ``jaxpr_costs``, ``trace_s`` for ``lower_s``/``compile_s``, and
    ``fits``: the peak within the card's memory.  ``layers``: the depth,
    cut (the config's by default)."""
    cfg = config(arch, layers)
    shape = SHAPES[shape_name]
    if shape_name not in C.runnable_shapes(cfg):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "long_500k needs sub-quadratic attention"}
    n = 512 if multi_pod else 256
    fake_world(n, rank)
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                         device_type="cpu")
    shd.set_global_mesh(mesh)
    t0 = time.perf_counter()
    micro = None
    if shape.kind == "train":
        micro = microbatches(cfg)
        step, args = _train_call(
            cfg, shape, mesh, "lossy_hadamard" if celeris else "exact",
            micro, quantize_wire)
        c = costs.trace_costs(step, *args)
        model_flops = (6.0 * cfg.active_param_count() * shape.global_batch
                       * shape.seq_len)
    else:
        fn = _serve_call(cfg, shape, mesh)
        c = costs.trace_costs(fn)
        tokens = shape.global_batch * (shape.seq_len if shape.kind
                                       == "prefill" else 1)
        model_flops = 2.0 * cfg.active_param_count() * tokens
    trace_s = time.perf_counter() - t0
    rec = {
        "arch": arch, "layers": cfg.n_layers, "shape": shape_name,
        "mesh": mesh_name(mesh),
        "n_devices": n, "rank": rank, "celeris": celeris,
        "kind": shape.kind, "microbatches": micro,
        "trace_s": round(trace_s, 2),
        "memory": {"peak_bytes": c["peak_bytes"]},
        "collectives": c["collectives"],
        "collective_bytes_total": c["coll_bytes"],
        "costs": {k: c[k] for k in ("flops", "matmul_flops",
                                    "transcendental_flops", "hbm_bytes")},
        "model_flops": model_flops,
        "roofline": costs.roofline(c["flops"], c["hbm_bytes"],
                                   c["coll_bytes"], n, model_flops),
        "fits": c["peak_bytes"] <= costs.HW["hbm_bytes"],
    }
    shd.set_global_mesh(None)
    return rec


def one_device_cell(arch: str, rows: int, seq: int,
                    mode: str = "lossy_hadamard"):
    """One device's train step (no mesh, no process group) on ``rows``
    rows of ``seq`` tokens at the config's full depth: its costs and
    peak, as the card's one-device phases run it (with remat, as the
    step always takes ``lm_loss``'s default)."""
    cfg = C.get(arch)
    shape = ShapeConfig("one_device", seq + cfg.n_front, rows, "train")
    step, args = _train_call(cfg, shape, None, mode)
    t0 = time.perf_counter()
    c = costs.trace_costs(step, *args)
    return {"arch": arch, "layers": cfg.n_layers, "rows": rows, "seq": seq,
            "mode": mode,
            "trace_s": round(time.perf_counter() - t0, 2),
            "peak_bytes": c["peak_bytes"],
            "fits": c["peak_bytes"] <= costs.HW["hbm_bytes"],
            "costs": {k: c[k] for k in ("flops", "matmul_flops", "hbm_bytes",
                                        "coll_bytes")}}


def census_ok(kinds, need) -> tuple[dict, bool]:
    """(the collectives outside the plain four, ok): ok when there are
    none and at least one of ``need`` is present."""
    illegal = {k: v for k, v in kinds.items() if k not in PLAIN_COLLECTIVES}
    return illegal, not illegal and any(k in kinds for k in need)


def scale_check_cell(arch: str, n_devices: int,
                     mode: str = "lossy_hadamard",
                     shape_name: str = "train_4k", rank: int = 0,
                     step_fn=None, layers=None):
    """Trace one lossy train step at ``n_devices`` ranks
    (``make_scale_mesh``) and census its collectives: ``ok`` only when
    every one is an all_reduce, all_gather, all_to_all or reduce_scatter
    and at least one all_reduce is present (JAX's ``dryrun.py:170-171``:
    the paper's claim that best-effort transport changes no collective
    contract).  ``step_fn(step)``, where given, wraps the step (the
    tests plant a collective that is not plain); ``layers``: the depth,
    cut."""
    cfg = config(arch, layers)
    shape = SHAPES[shape_name]
    fake_world(n_devices, rank)
    mesh = mesh_mod.make_scale_mesh(n_devices, device_type="cpu")
    shd.set_global_mesh(mesh)
    t0 = time.perf_counter()
    step, args = _train_call(cfg, shape, mesh, mode)
    c = costs.trace_costs(step_fn(step) if step_fn else step, *args)
    counts = {k: v["count"] for k, v in c["collectives"].items()}
    illegal, ok = census_ok(counts, ("all_reduce",))
    shd.set_global_mesh(None)
    return {"arch": arch, "layers": cfg.n_layers, "shape": shape_name,
            "mode": mode, "n_devices": n_devices, "rank": rank, "mesh": mesh_name(mesh),
            "dp_degree": n_devices // 16,
            "trace_s": round(time.perf_counter() - t0, 2),
            "collective_ops": counts, "illegal_collectives": illegal,
            "peak_bytes": c["peak_bytes"], "ok": ok}


def _save(name, recs):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, name)
    with open(path, "w") as f:
        json.dump(recs, f, indent=1)
    print(f"saved -> {path}", flush=True)


def scale_check(n_devices_list=(512, 1024), arch: str = "qwen2-0.5b",
                mode: str = "lossy_hadamard", ranks=None):
    """:func:`scale_check_cell` at each size, for rank 0 and the last
    rank (or ``ranks``)."""
    recs = []
    for n in n_devices_list:
        for r in (ranks if ranks is not None else (0, n - 1)):
            rec = scale_check_cell(arch, n, mode=mode, rank=r)
            recs.append(rec)
            print(f"{'OK ' if rec['ok'] else 'BAD'} {arch} {mode} "
                  f"n_devices={n} rank={r} mesh={rec['mesh']} "
                  f"trace={rec['trace_s']}s "
                  f"collectives={rec['collective_ops']}", flush=True)
    _save(f"scale_check__{arch}__{mode}.json", recs)
    if not all(r["ok"] for r in recs):
        raise SystemExit("scale check FAILED: non-plain collectives in "
                         "the traced lossy train step")
    return recs


def serve_check_cell(arch: str, shape_name: str, multi_pod: bool,
                     rank: int = 0, layers=None):
    """Trace one prefill or decode step on the production mesh (256 or
    512 ranks) and census its collectives: ``ok`` as JAX's
    (``dryrun.py:296-308``): only plain collectives, and some all_reduce
    or reduce_scatter (tensor parallelism reduces somewhere); ``layers``:
    the depth, cut."""
    cfg = config(arch, layers)
    shape = SHAPES[shape_name]
    n = 512 if multi_pod else 256
    fake_world(n, rank)
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                         device_type="cpu")
    shd.set_global_mesh(mesh)
    t0 = time.perf_counter()
    fn = _serve_call(cfg, shape, mesh)
    c = costs.trace_costs(fn)
    counts = {k: v["count"] for k, v in c["collectives"].items()}
    illegal, ok = census_ok(counts, ("all_reduce", "reduce_scatter"))
    shd.set_global_mesh(None)
    return {"arch": arch, "layers": cfg.n_layers, "shape": shape_name,
            "kind": shape.kind, "mesh": mesh_name(mesh), "n_devices": n,
            "rank": rank,
            "trace_s": round(time.perf_counter() - t0, 2),
            "collective_ops": counts, "illegal_collectives": illegal,
            "peak_bytes": c["peak_bytes"], "ok": ok}


def serve_check(arch: str = "qwen2-0.5b",
                shapes=("prefill_32k", "decode_32k"),
                multi_pods=(False, True)):
    """:func:`serve_check_cell` for each shape on each production mesh
    (``multi_pods``: the 16 x 16 one, False, and the 2 x 16 x 16 one,
    True; one mesh alone saves under its own name, so two processes can
    check the two meshes at once)."""
    recs = []
    for multi_pod in multi_pods:
        for shape_name in shapes:
            rec = serve_check_cell(arch, shape_name, multi_pod)
            recs.append(rec)
            print(f"{'OK ' if rec['ok'] else 'BAD'} {arch} {shape_name:12s} "
                  f"mesh={rec['mesh']:8s} trace={rec['trace_s']}s "
                  f"collectives={rec['collective_ops']}", flush=True)
    meshes = "" if len(multi_pods) > 1 else "__" + recs[0]["mesh"]
    _save(f"serve_check__{arch}{meshes}.json", recs)
    if not all(r["ok"] for r in recs):
        raise SystemExit("serve check FAILED: non-plain collectives in "
                         "the traced serve path")
    return recs


def run_and_save(arch, shape_name, multi_pod, celeris=True,
                 quantize_wire=False, rank=0):
    rec = lower_cell(arch, shape_name, multi_pod, celeris, quantize_wire,
                     rank)
    tag = (f"{C.canonical(arch)}__{shape_name}__"
           f"{'2x16x16' if multi_pod else '16x16'}")
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, tag + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec, path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str)
    ap.add_argument("--shape", type=str)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-celeris", action="store_true",
                    help="baseline (exact collectives) variant")
    ap.add_argument("--quantize-wire", action="store_true",
                    help="int8 wire codes on one scale a wire row")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--scale-check", action="store_true",
                    help="trace the lossy train step at 512 and 1,024 "
                         "ranks; assert plain collectives only")
    ap.add_argument("--serve-check", action="store_true",
                    help="trace prefill + decode on the single- and "
                         "multi-pod production meshes; assert plain "
                         "collectives only")
    ap.add_argument("--mode", type=str, default="lossy_hadamard",
                    help="collective mode for --scale-check")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank this process plays")
    ap.add_argument("--one-device", type=int, metavar="ROWS",
                    help="reckon one device's train step on ROWS rows of "
                         "--seq tokens (no mesh)")
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args(argv)

    if args.one_device:
        rec = one_device_cell(args.arch or "qwen2-0.5b", args.one_device,
                              args.seq, args.mode)
        print(json.dumps(rec))
        return

    if args.scale_check:
        scale_check(arch=args.arch or "qwen2-0.5b", mode=args.mode)
        return
    if args.serve_check:
        serve_check(arch=args.arch or "qwen2-0.5b")
        return
    if args.all:
        failures = 0
        for arch in C.ARCHS:
            for shape_name in C.runnable_shapes(C.get(arch)):
                for mp in (False, True):
                    try:
                        rec, _ = run_and_save(arch, shape_name, mp,
                                              celeris=not args.no_celeris,
                                              rank=args.rank)
                        peak = rec["memory"]["peak_bytes"] / 2 ** 30
                        coll = rec["collective_bytes_total"] / 2 ** 20
                        print(f"OK  {arch:24s} {shape_name:12s} "
                              f"{rec['mesh']:8s} trace={rec['trace_s']:7.1f}s"
                              f" peak/rank={peak:6.2f}GiB "
                              f"coll={coll:8.1f}MiB", flush=True)
                    except Exception as e:  # noqa: BLE001
                        failures += 1
                        print(f"FAIL {arch} {shape_name} mp={mp}: "
                              f"{type(e).__name__}: {e}", flush=True)
        sys.exit(1 if failures else 0)
    rec, path = run_and_save(args.arch, args.shape, args.multi_pod,
                             celeris=not args.no_celeris,
                             quantize_wire=args.quantize_wire,
                             rank=args.rank)
    print(json.dumps(rec, indent=1))
    print(f"saved -> {path}")


if __name__ == "__main__":
    main()

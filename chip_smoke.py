"""Drive the PyTorch/CUDA port's serve and train paths on one NVIDIA card
and check them.

    python3 chip_smoke.py

The kernels: ``fwht`` and ``fwht_quantize`` (``csrc/fwht.cu``),
``masked_unbias`` (``csrc/unbias.cu``) and ``quantize_int8``
(``csrc/quantize.cu``).  Phases (any failure exits non-zero; nothing is
caught and carried on):

1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a, one compiler per source, all at once;
2. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes (FWHT at every coded leaf's tiles and at the
   gradient payload, unbias at its wire layout) and over
   ``tests/test_kernels.py``'s shapes (the
   quantizers: codes and scales equal, and the fused kernel equal to the
   kernel pair), and time kernel, plain version, a PyTorch yardstick,
   and the bound;
3. serve qwen2-0.5b at full width (24 layers, d 896, 14 heads padded to
   16, kv 2, vocab 151,936, bf16, random weights from seed 0): prefill
   8 prompts of 512 tokens, ship the KV caches through the coded lossy
   transfer at a delivered fraction of 0.9 (64 wire rows, fig8's cell),
   greedy-decode 32 tokens.  Uncoded and clean decodes, a full-mask
   round trip, and a smoke-size run against the CPU check the results;
4. the kernel bench (``benchmarks/kernel_bench.py``'s quantize rows) at
   (256, 4096) through ``kernels.ops``;
5. train qwen2-0.5b at full width through ``Trainer``: batch 8 x 128
   Markov tokens, AdamW (lr 1e-3, warmup 10), three steps in each of
   ``exact``, ``lossy`` and ``lossy_hadamard``, with 16 FWHT launches a
   coded step (8 coded leaves, encode + decode);
6. the gradient all-reduce: one step's gradient (499,540,864 values)
   through ``lossy_pmean`` on a one-rank NCCL group, on the int8 wire
   (one fused rotate+quantize launch a call) at drop 0 and 0.05 and on
   the float32 wire at 0.05;
7. smoke-size training on the card against the CPU (float32, the same
   masks, signs and batch: loss, the first moments, i.e. the synced
   gradient, and the updated parameters), and 14 coded steps that must
   lower the loss.

Each path (3-6) runs with the kernels' launch counts set to 0 just
before it and read just after.  The last line is ``{"ok": true,
"device": {...}}``; the lines before it carry the card's name and power
limit and a ``{"kernels": [...]}`` record.  Needs CUDA: without it the
script raises before printing any result.
"""
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")

BATCH, PROMPT, GEN = 8, 512, 32
N_ROT, TAU, KV_FRAC = 64, 0.6, 0.9         # fig8's coded-KV recovery cell
SWEEP = [(8, 128), (3, 256), (100, 4096), (1, 2), (16, 1024), (257, 512)]
# the quantizers: the main paths' (121,959, 4096), kernel_bench.py's
# (256, 4096), tests/test_kernels.py's shapes, and the two tile extremes
QUANT_SHAPES = [(121959, 4096), (256, 4096), (8, 128), (64, 512), (3, 64),
                (3, 256), (100, 1024), (4097, 2), (33, 32)]
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, SMOKE_STEPS = 8, 128, 3, 14
MODES = ("exact", "lossy", "lossy_hadamard")
CODED_LEAVES = 8           # qwen2-0.5b leaves >= min_coded_size (65,536)
GRAD_VALUES, GRAD_PAYLOAD = 499_540_864, (121_959, 4096)   # its gradient
# the FWHT's rows on the train path: the tiles of 4096 of each coded leaf
# (wk/wv, wq/wo, the MLP weights, embed.table)
TRAIN_FWHT_ROWS = (672, 5376, 25536, 33236)
ALLREDUCE_PEERS = (1, 4)   # unbias counts: the one-rank group's and 4 peers'
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 outside the
# tensor cores (the kernels' arithmetic) in operations/s
HBM_BPS, F32_OPS = 3.35e12, 67e12
TIMING_ITERS, WARMUP, TOP_KERNELS = 30, 3, 4


def _sync():
    torch.cuda.synchronize()


def time_ms(fn):
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(WARMUP):
        fn()
    _sync()
    times = []
    for _ in range(TIMING_ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / HBM_BPS, n_ops / F32_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check(name, got, want, rtol, atol):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item() if got.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: {m}")
    return err


def profile_window(fn):
    """Host wall time, device busy time (union of kernel intervals) and
    the kernels that took the most device time, for one call of fn."""
    from torch.profiler import ProfilerActivity, profile
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, -math.inf
    by_name = {}
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[e.name] = by_name.get(e.name, 0.0) + (stop - start) / 1e3
    if not kernels:                  # the profiler saw no device activity
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured"}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e3 / wall_ms,
            "n_kernel_launches": len(kernels),
            "top_kernels_ms": {k[:60]: v for k, v in ranked}}


SOURCES = ("fwht", "unbias", "quantize")


class Launches:
    """The kernel wrappers' launch counters, by kernel name: a path is
    driven with them set to 0 just before it and read just after."""

    def __init__(self, kfwht, kunbias, kquant):
        self.kfwht, self.kunbias, self.kquant = kfwht, kunbias, kquant

    def reset(self):
        self.kfwht.launches = self.kfwht.quantize_launches = 0
        self.kunbias.launches = self.kquant.launches = 0

    def read(self):
        return {"fwht": self.kfwht.launches,
                "fwht_quantize": self.kfwht.quantize_launches,
                "masked_unbias": self.kunbias.launches,
                "quantize_int8": self.kquant.launches}


def check_equal(name, got, want):
    """Kernel codes and scales against the plain version's: equal, not
    close.  Returns the max abs difference (0)."""
    err = max((g.float() - w.float()).abs().max().item() if g.numel() else 0.0
              for g, w in zip(got, want))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), (
            f"{name}: differs from its plain version (max abs err {err})")
    return err


def quantize_expression(x, noise):
    """The library yardstick for the quantizers: one torch expression,
    timed only, never called by the port."""
    a = x.abs().amax(-1, keepdim=True)
    s = torch.where(a > 0, a / 127.0, 1.0)
    return (torch.clamp(torch.floor(x / s + noise), -127, 127)
            .to(torch.int8), s[:, 0])


def phase_build(_build):
    t0 = time.perf_counter()
    _build.build(*SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, "
          f"{' + '.join(n + '.cu' for n in SOURCES)} in parallel)")
    for name in SOURCES:
        log = (_build.BUILD / f"{name}.log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def phase_kernels(dev, cfg, kfwht, kunbias, ref, coding, coupling):
    """Kernel vs plain version; returns the timing records."""
    g = torch.Generator(dev).manual_seed(0)
    # one stacked K (or V) cache of the main path is one coded payload
    kv_elems = (cfg.n_layers * BATCH * (PROMPT + GEN) * cfg.n_kv_heads
                * cfg.resolved_head_dim)
    code = coding.plan(kv_elems, n_rot=N_ROT)
    rows, n = code.n_blocks, code.n_rot          # (208,896, 64)
    records = []

    # FWHT at encode's shape: (n_blocks, n_rot) f32, fused signs and scale
    x = torch.randn(rows, n, generator=g, device=dev)
    signs = coding.rademacher(g, code)
    scale = n ** -0.5
    err = check("fwht main", kfwht.fwht_cuda(x, signs, scale),
                ref.fwht(x, signs=signs, scale=scale), 1e-4, 1e-4)
    h = ref.hadamard_matrix(n, device=dev)
    folded = signs[:, None] * h * scale          # diag(signs) H scale
    nb, ops = 2 * rows * n * 4 + n * 4, rows * n * (int(math.log2(n)) + 2)
    b_ms, b_by = bound_ms(nb, ops)
    records.append({
        "name": "fwht", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fwht.cu",
        "replaces": "src/repro/kernels/fwht.py:141",
        "shape": [rows, n], "dtype": "float32", "max_abs_err": err,
        "ms": time_ms(lambda: kfwht.fwht_cuda(x, signs, scale)),
        "plain_ms": time_ms(lambda: ref.fwht(x, signs=signs, scale=scale)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: x @ folded),
        "library": "torch.matmul(x, diag(signs) H scale), TF32 off"})

    # unbias at decode's shape: the wire layout (n_rot, n_blocks) f32
    y = torch.randn(n, rows, generator=g, device=dev)
    mask = coupling.kv_hole_masks(np.array([KV_FRAC]), N_ROT, seed=0)[0]
    counts = torch.as_tensor(mask, dtype=torch.float32, device=dev)
    err = check("unbias main", kunbias.masked_unbias_cuda(y, counts, 1),
                ref.masked_unbias(y, counts, 1), 1e-6, 0.0)
    nb, ops = 2 * n * rows * 4 + n * 4, n * rows + n
    b_ms, b_by = bound_ms(nb, ops)
    c2 = counts[:, None]
    records.append({
        "name": "masked_unbias", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/unbias.cu",
        "replaces": "src/repro/kernels/unbias.py:25",
        "shape": [n, rows], "dtype": "float32", "max_abs_err": err,
        "ms": time_ms(lambda: kunbias.masked_unbias_cuda(y, counts, 1)),
        "plain_ms": time_ms(lambda: ref.masked_unbias(y, counts, 1)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(
            lambda: torch.where(c2 > 0, y * (1 / c2.clamp(min=1)), 0.0)),
        "library": "torch.where(c > 0, y * (total / max(c, 1)), 0)"})

    # sweep at tests/test_kernels.py's shapes and tolerances
    worst = {"fwht": 0.0, "masked_unbias": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for r, m in SWEEP:
            xs = torch.randn(r, m, generator=g, device=dev).to(dtype)
            tol = 1e-4 if dtype == torch.float32 else 8e-2 * math.sqrt(m)
            tag = f"{r}x{m} {dtype}"
            e1 = check(f"fwht {tag}", kfwht.fwht_cuda(xs), ref.fwht(xs),
                       tol, tol)
            sg = torch.randint(0, 2, (m,), generator=g,
                               device=dev).float() * 2 - 1
            e2 = check(f"fwht signs {tag}", kfwht.fwht_cuda(xs, sg, m ** -0.5),
                       ref.fwht(xs, signs=sg, scale=m ** -0.5), tol, tol)
            cs = torch.randint(0, 5, (r,), generator=g, device=dev).float()
            e3 = check(f"unbias {tag}", kunbias.masked_unbias_cuda(xs, cs, 4),
                       ref.masked_unbias(xs, cs, 4), 1e-6, 0.0)
            worst["fwht"] = max(worst["fwht"], e1, e2)
            worst["masked_unbias"] = max(worst["masked_unbias"], e3)
    path_err = check_train_shapes(dev, g, kfwht, kunbias, ref)
    _sync()
    for rec in records:
        rec["max_abs_err"] = max(rec["max_abs_err"], path_err[rec["name"]])
        print(f"kernel {rec['name']} {rec['shape']}: max_abs_err "
              f"{rec['max_abs_err']:.3g} (with the train and all-reduce "
              f"shapes), {rec['ms']:.4f} ms (plain "
              f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f}, "
              f"bound {rec['bound_ms']:.4f} by {rec['bound_by']}); sweep "
              f"of {len(SWEEP)} shapes x f32/bf16 worst err "
              f"{worst[rec['name']]:.3g}")
    return records


def check_train_shapes(dev, g, kfwht, kunbias, ref):
    """FWHT (signs and scale fused) at each coded leaf's tiles and at the
    gradient payload, and masked unbias at the payload's wire layout
    with counts from drop-0.05 masks, against the plain versions at the
    serve shapes' tolerances.  Returns the worst error by kernel."""
    rows_all, n = TRAIN_FWHT_ROWS + (GRAD_PAYLOAD[0],), GRAD_PAYLOAD[1]
    signs = torch.randint(0, 2, (n,), generator=g, device=dev).float() * 2 - 1
    worst = {"fwht": 0.0, "masked_unbias": 0.0}
    for rows in rows_all:
        x = torch.randn(rows, n, generator=g, device=dev)
        worst["fwht"] = max(worst["fwht"], check(
            f"fwht train/all-reduce {rows}x{n}",
            kfwht.fwht_cuda(x, signs, n ** -0.5),
            ref.fwht(x, signs=signs, scale=n ** -0.5), 1e-4, 1e-4))
        del x
    y = torch.randn(n, GRAD_PAYLOAD[0], generator=g, device=dev)
    for peers in ALLREDUCE_PEERS:
        counts = (torch.rand(peers, n, generator=g, device=dev) >= 0.05
                  ).sum(0).float()
        worst["masked_unbias"] = max(worst["masked_unbias"], check(
            f"unbias all-reduce {n}x{GRAD_PAYLOAD[0]} {peers} peers",
            kunbias.masked_unbias_cuda(y, counts, peers),
            ref.masked_unbias(y, counts, peers), 1e-6, 0.0))
    print(f"train/all-reduce shapes: fwht at {list(rows_all)} x {n} worst "
          f"err {worst['fwht']:.3g}; masked_unbias at ({n}, "
          f"{GRAD_PAYLOAD[0]}), counts of {list(ALLREDUCE_PEERS)} peers at "
          f"drop 0.05, worst err {worst['masked_unbias']:.3g}")
    return worst


def phase_quant_kernels(dev, kfwht, kquant, ref):
    """The fused rotate+quantize and the int8 quantize kernels against
    their plain versions (codes and scales equal) and the fused kernel
    against the kernel pair, over QUANT_SHAPES; returns the timing
    records at the main paths' shape."""
    g = torch.Generator(dev).manual_seed(5)
    records = []
    for rows, n in QUANT_SHAPES:
        x = torch.randn(rows, n, generator=g, device=dev) * 3
        noise = torch.rand(rows, n, generator=g, device=dev)
        signs = torch.randint(0, 2, (n,), generator=g,
                              device=dev).float() * 2 - 1
        scale = n ** -0.5
        tag = f"{rows}x{n}"
        e_q = check_equal(f"quantize_int8 {tag}",
                          kquant.quantize_int8_cuda(x, noise),
                          ref.quantize_int8(x, noise))
        fused = kfwht.fwht_quantize_cuda(x, noise, signs, scale)
        e_f = check_equal(f"fwht_quantize {tag}", fused,
                          ref.fwht_quantize(x, noise, signs=signs,
                                            scale=scale))
        check_equal(f"fwht_quantize {tag} vs the kernel pair", fused,
                    kquant.quantize_int8_cuda(
                        kfwht.fwht_cuda(x, signs, scale), noise))
        check_equal(f"fwht_quantize {tag} unsigned",
                    kfwht.fwht_quantize_cuda(x, noise),
                    ref.fwht_quantize(x, noise))
        if (rows, n) != QUANT_SHAPES[0]:
            continue
        # timing records at the main shape: x and noise read once, int8
        # codes and a float32 scale per row written once
        nb = rows * n * (4 + 4 + 1) + rows * 4
        log_n = int(math.log2(n))
        h = ref.hadamard_matrix(n, device=dev)
        folded = signs[:, None] * h * scale            # diag(signs) H scale
        for name, err, fn, plain, lib, ops_per, extra_b, src, rep, lname in (
                ("fwht_quantize", e_f,
                 lambda: kfwht.fwht_quantize_cuda(x, noise, signs, scale),
                 lambda: ref.fwht_quantize(x, noise, signs=signs,
                                           scale=scale),
                 lambda: quantize_expression(x @ folded, noise),
                 log_n + 8, n * 4, "src/repro_torch/kernels/csrc/fwht.cu",
                 "src/repro/kernels/fwht.py:94",
                 "torch.matmul(x, diag(signs) H scale), TF32 off, then "
                 "amax/where/div/add/floor/clamp/to(int8)"),
                ("quantize_int8", e_q,
                 lambda: kquant.quantize_int8_cuda(x, noise),
                 lambda: ref.quantize_int8(x, noise),
                 lambda: quantize_expression(x, noise), 7, 0,
                 "src/repro_torch/kernels/csrc/quantize.cu",
                 "src/repro/kernels/quantize.py:31",
                 "amax/where/div/add/floor/clamp/to(int8)")):
            b_ms, b_by = bound_ms(nb + extra_b, rows * n * ops_per)
            records.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": rep, "shape": [rows, n], "dtype": "float32",
                "max_abs_err": err, "ms": time_ms(fn),
                "plain_ms": time_ms(plain), "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": time_ms(lib),
                "library": lname})
        del x, noise, fused, h, folded
    _sync()
    for rec in records:
        print(f"kernel {rec['name']} {rec['shape']}: codes and scales "
              f"equal to the plain version over {len(QUANT_SHAPES)} shapes "
              f"(fused == kernel pair), {rec['ms']:.4f} ms (plain "
              f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f}, "
              f"bound {rec['bound_ms']:.4f} by {rec['bound_by']})")
    return records


def phase_kernel_bench(dev, ops, counts):
    """benchmarks/kernel_bench.py's quantize rows at (256, 4096) through
    ``kernels.ops``: fused-signs FWHT, quantize, the unfused pair and the
    fused kernel.  One pass with the launch counts read around it, then
    the timings."""
    g = torch.Generator(dev).manual_seed(6)
    x = torch.randn(256, 4096, generator=g, device=dev)
    signs = torch.randint(0, 2, (4096,), generator=g,
                          device=dev).float() * 2 - 1
    noise = torch.rand(256, 4096, generator=g, device=dev)
    sc = 4096 ** -0.5
    rows = {
        "fwht_fused_signs": lambda: ops.fwht(x, signs=signs, scale=sc),
        "quantize": lambda: ops.quantize_int8(x, noise),
        "fwht_quant_unfused": lambda: ops.quantize_int8(
            ops.fwht(x, signs=signs, scale=sc), noise),
        "fwht_quant_fused": lambda: ops.fwht_quantize(x, noise, signs=signs,
                                                      scale=sc)}
    _sync()
    counts.reset()
    out = {k: fn() for k, fn in rows.items()}
    _sync()
    launches = counts.read()
    check_equal("kernel bench fused vs unfused", out["fwht_quant_fused"],
                out["fwht_quant_unfused"])
    assert launches == {"fwht": 2, "fwht_quantize": 1, "masked_unbias": 0,
                        "quantize_int8": 2}, launches
    times = {k: time_ms(fn) for k, fn in rows.items()}
    print(f"kernel bench (256, 4096) ms: {times}; launches {launches}")
    return {"ms": times, "launches": launches}


def phase_train(dev, C, ts, Trainer, DataConfig, OptConfig, counts):
    """qwen2-0.5b at full width through Trainer, three steps a mode.
    Returns the records and the last (lossy_hadamard) trainer."""
    cfg = C.get("qwen2-0.5b")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=1)
    opt = OptConfig(lr=1e-3, warmup_steps=10, total_steps=500)
    out, total = {}, {}
    tr = None
    for mode in MODES:
        del tr
        torch.cuda.empty_cache()
        tr = Trainer(cfg, data_cfg=data_cfg, opt_cfg=opt,
                     celeris=ts.CelerisConfig(mode=mode), seed=0,
                     device=str(dev))
        torch.cuda.reset_peak_memory_stats()
        steps = []

        def on_metrics(step, m):
            steps.append(dict(m, launches=counts.read()))
            counts.reset()

        _sync()
        counts.reset()
        hist = tr.run(TRAIN_STEPS, on_metrics=on_metrics)
        for rec in steps:
            for k, v in rec["launches"].items():
                total[k] = total.get(k, 0) + v
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

        assert np.isfinite(hist["loss"]).all(), (mode, hist["loss"])
        fwht_per_step = [rec["launches"]["fwht"] for rec in steps]
        if mode == "lossy_hadamard":
            assert fwht_per_step == [2 * CODED_LEAVES] * TRAIN_STEPS, (
                f"{mode}: FWHT launches per step {fwht_per_step}")
        else:
            assert fwht_per_step == [0] * TRAIN_STEPS, (mode, fwht_per_step)
        if mode != "exact":
            assert all(0.4 <= f <= 1.0 for f in hist["recv_frac"]), (
                mode, hist["recv_frac"])
        step_ms = [rec["wall_s"] * 1e3 for rec in steps]
        out[mode] = {"loss": hist["loss"], "recv_frac": hist["recv_frac"],
                     "drop_rate": hist["drop_rate"], "step_ms": step_ms,
                     "median_step_ms_after_first":
                         statistics.median(step_ms[1:]),
                     "fwht_launches_per_step": fwht_per_step,
                     "peak_mem_gib": peak_gib}
        print(f"train {mode}: loss {hist['loss']}, recv_frac "
              f"{hist['recv_frac']}, step ms {step_ms} (median after the "
              f"first {out[mode]['median_step_ms_after_first']:.1f}), "
              f"FWHT launches/step {fwht_per_step}, peak {peak_gib:.2f} GiB")
    batch = tr.put_batch(TRAIN_STEPS)
    out["profile_lossy_hadamard_step"] = profile_window(
        lambda: tr.step_fn(tr.state, batch, tr.step_generator(99), 0.05))
    print(f"profile lossy_hadamard step: "
          f"{out['profile_lossy_hadamard_step']}")
    out["launches"] = total
    return out, tr


def phase_allreduce(dev, ts, tr, coding, lc, counts):
    """One full-width gradient through lossy_pmean on a one-rank NCCL
    group: int8 wire at drop 0 and 0.05, float32 wire at 0.05."""
    import socket
    import torch.distributed as dist
    from repro_torch import generator
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        *_, grads = ts.loss_and_grads(tr.cfg, tr.state["params"],
                                      tr.put_batch(TRAIN_STEPS + 1))
        flat, _ = coding.tree_ravel(grads)
        del grads
        code = coding.plan(flat.numel())
        assert flat.numel() == GRAD_VALUES, flat.numel()
        assert (code.n_blocks, code.n_rot) == GRAD_PAYLOAD, code
        signs = coding.rademacher(generator(dev, 2), code)
        lc.exact_psum(torch.ones(8, device=dev))         # NCCL set-up

        def call(drop, quantize_wire, seed):
            return lc.lossy_pmean(flat, seed=seed, drop_rate=drop,
                                  signs=signs, code=code,
                                  quantize_wire=quantize_wire)

        call(0.0, True, 10)                               # warm-up
        out, total = {}, {}
        norm = flat.norm().item()
        for name, drop, q in (("int8_drop0", 0.0, True),
                              ("int8_drop0.05", 0.05, True),
                              ("f32_drop0.05", 0.05, False)):
            _sync()
            counts.reset()
            t0 = time.perf_counter()
            est, frac = call(drop, q, 11)
            _sync()
            ms = (time.perf_counter() - t0) * 1e3
            launches = counts.read()
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            want = ({"fwht": 1, "fwht_quantize": 1, "masked_unbias": 1,
                     "quantize_int8": 0} if q else
                    {"fwht": 2, "fwht_quantize": 0, "masked_unbias": 1,
                     "quantize_int8": 0})
            assert launches == want, (name, launches)
            rel = (est - flat).norm().item() / norm
            frac = frac.item()
            assert torch.isfinite(est).all() and est.shape == flat.shape
            if drop == 0.0:
                assert frac == 1.0 and rel < 0.05, (name, frac, rel)
            else:
                assert abs(frac - 0.95) < 0.04, (name, frac)
            out[name] = {"ms": ms, "recv_frac": frac, "rel_l2_err": rel,
                         "launches": launches}
            print(f"all-reduce {name}: {ms:.2f} ms, recv_frac {frac:.4f}, "
                  f"relative L2 error {rel:.4f}, launches {launches}")
            del est
        out["launches"] = total
        out["payload"] = [code.n_blocks, code.n_rot]
        return out
    finally:
        dist.destroy_process_group()


def check_first_step(name, new_dev, new_cpu, opt):
    """One AdamW step's state, card against CPU.  The first moment is
    (1 - b1) times the synced, clipped gradient g, so it holds whatever
    the sync (masking, the FWHT encode and decode) made of the gradient:
    rtol 1e-4 plus 1e-4 of its leaf's largest entry.  The first update
    is lr * g / (|g| + eps), i.e. lr (1e-3) per entry, whose slope near
    g = 0 is lr / eps: each parameter is held to 2e-4 plus the update
    difference that the two sides' own g explain, so a sign that rounds
    the other way at |g| ~ eps is not taken for a fault."""
    for i, (mu_d, mu_c, p_d, p_c) in enumerate(zip(
            new_dev["opt"]["mu"], new_cpu["opt"]["mu"], new_dev["params"],
            new_cpu["params"])):
        mu_d = mu_d.cpu()
        check(f"{name} leaf {i} first moment card vs cpu", mu_d, mu_c, 1e-4,
              1e-4 * mu_c.abs().max().item())
        g_d, g_c = (mu.double() / (1 - opt.b1) for mu in (mu_d, mu_c))
        explained = opt.lr * ((g_d / (g_d.abs() + opt.eps))
                              - (g_c / (g_c.abs() + opt.eps))).abs()
        diff = (p_d.cpu().double() - p_c.double()).abs()
        bad = diff > 2e-4 + explained
        assert not bad.any(), (
            f"{name} leaf {i} params card vs cpu: {int(bad.sum())} entries "
            f"beyond 2e-4 + explained, max diff {diff.max().item():.3g}")


def phase_small_train(dev, C, ts, OptConfig, DataConfig, make_source):
    """Smoke-size qwen2-0.5b in float32: one step a mode on the card
    (kernels) against the CPU (plain versions), same weights, batch,
    masks and signs, with the full learning rate from the first step so
    that the update outweighs the tolerance; then 14 coded steps on the
    card at drop 0.05 must lower the loss (tests/test_distribution.py's
    check)."""
    from repro_torch import generator
    cfg = dataclasses.replace(C.get_smoke("qwen2-0.5b"), dtype="float32")
    cpu = torch.device("cpu")
    state = ts.init_state(torch.Generator(cpu).manual_seed(0), cfg)
    src = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                 global_batch=8, seed=1))
    batch = {k: torch.as_tensor(v, dtype=torch.long)
             for k, v in src.global_batch(0).items()}
    opt = OptConfig(lr=1e-3, warmup_steps=1)
    celeris = dict(min_coded_size=1024)
    g = torch.Generator(cpu).manual_seed(3)
    masks, signs = {}, {}
    for i, leaf in enumerate(state["params"]):
        if leaf.numel() >= celeris["min_coded_size"]:
            masks[i] = torch.rand(4096, generator=g) >= 0.05
            signs[i] = torch.randint(0, 2, (4096,),
                                     generator=g).float() * 2 - 1

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, d) for v in tree]
        return tree.to(d)

    for mode in MODES:
        step = ts.make_train_step(cfg, None, opt,
                                  ts.CelerisConfig(mode=mode, **celeris))
        (new_cpu, m_cpu), (new_dev, m_dev) = [
            step(to(state, d), to(batch, d), None, 0.05, masks=masks,
                 signs=signs) for d in (cpu, dev)]
        for k in ("loss", "recv_frac"):
            check(f"smoke train {mode} {k} card vs cpu", m_dev[k].cpu(),
                  m_cpu[k], 2e-4, 2e-4)
        check_first_step(f"smoke train {mode}", new_dev, new_cpu, opt)

    step = ts.make_train_step(cfg, None, OptConfig(lr=1e-3), ts.CelerisConfig(
        mode="lossy_hadamard", **celeris))
    st, losses, fracs = to(state, dev), [], []
    for i in range(SMOKE_STEPS):
        b = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
             for k, v in src.global_batch(i).items()}
        st, m = step(st, b, generator(dev, 3, i), 0.05)
        losses.append(m["loss"].item())
        fracs.append(m["recv_frac"].item())
    assert np.isfinite(losses).all(), losses
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert all(0.9 < f < 1.0 for f in fracs), fracs
    print(f"smoke train f32, card vs CPU: loss, recv_frac, first moments "
          f"and updated params agree in {', '.join(MODES)}; {SMOKE_STEPS} "
          f"coded steps "
          f"at drop 0.05 on the card: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    return {"losses": losses, "recv_frac": fracs}


def phase_main_path(dev, C, M, serve_step, coupling, counts):
    """qwen2-0.5b at full width through prefill, coded KV, greedy decode."""
    cfg = C.get("qwen2-0.5b")
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev)
    prefill = serve_step.make_prefill(cfg, PROMPT + GEN)
    mask = torch.as_tensor(coupling.kv_hole_masks(
        np.array([KV_FRAC]), N_ROT, seed=0)[0], device=dev)

    def signs_gen():
        return torch.Generator(dev).manual_seed(2)

    # warm-up: cuBLAS handles, allocator pools, kernel modules
    _, warm = prefill(params, prompt)
    serve_step.greedy_decode(cfg, params, serve_step.degrade_caches(
        warm, mask, signs_gen()), prompt[:, -1:], PROMPT, 3)
    del warm
    _sync()

    # --- the main path, with the launch counts read around it ---
    counts.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, clean = prefill(params, prompt)
    _sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    first = torch.argmax(logits, -1)[:, None]
    t0 = time.perf_counter()
    coded = serve_step.degrade_caches(clean, mask, signs_gen())
    _sync()
    degrade_ms = (time.perf_counter() - t0) * 1e3
    err_coded = serve_step.kv_position_error(clean, coded, PROMPT)
    t0 = time.perf_counter()
    coded_toks = serve_step.greedy_decode(cfg, params, coded, first, PROMPT,
                                          GEN)
    _sync()
    decode_s = time.perf_counter() - t0
    launches = counts.read()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    assert logits.shape == (BATCH, cfg.vocab_size), logits.shape
    assert torch.isfinite(logits.float()).all(), "non-finite prefill logits"
    assert coded_toks.shape == (BATCH, GEN), coded_toks.shape
    assert launches["fwht"] >= 4 and launches["masked_unbias"] >= 2, (
        f"main path missed the kernels: {launches}")

    # --- the references the main path is checked against ---
    clean_toks = serve_step.greedy_decode(cfg, params, clean.clone(), first,
                                          PROMPT, GEN)
    uncoded = serve_step.degrade_caches(clean, mask, coded=False)
    err_uncoded = serve_step.kv_position_error(clean, uncoded, PROMPT)
    uncoded_toks = serve_step.greedy_decode(cfg, params, uncoded, first,
                                            PROMPT, GEN)
    full = serve_step.degrade_caches(
        clean, torch.ones(N_ROT, dtype=torch.bool, device=dev), signs_gen())
    err_full = serve_step.kv_position_error(clean, full, PROMPT).max().item()
    assert err_full <= 1e-2, (
        f"full mask is not a bf16-noise round trip: {err_full}")
    assert torch.isfinite(err_coded).all()
    assert torch.isfinite(err_uncoded).all()

    # where the time goes: one profiled call of each stage
    decode = serve_step.make_decode(cfg)
    steps = 4

    def decode_steps():
        caches, tok = full.clone(), first
        for i in range(steps):
            logits, caches = decode(params, caches, tok, PROMPT + i)
            tok = torch.argmax(logits, -1)[:, None]

    profile = {
        "prefill": profile_window(lambda: prefill(params, prompt)),
        "degrade_caches": profile_window(
            lambda: serve_step.degrade_caches(clean, mask, signs_gen())),
        f"decode_{steps}_steps": profile_window(decode_steps)}

    usable_coded = (err_coded <= TAU).float().mean().item()
    usable_uncoded = (err_uncoded <= TAU).float().mean().item()
    assert usable_coded >= usable_uncoded, (usable_coded, usable_uncoded)
    out = {
        "model": cfg.name, "batch": BATCH, "prompt": PROMPT, "gen": GEN,
        "kv_frac": KV_FRAC, "wire_rows_lost": int(N_ROT - mask.sum().item()),
        "prefill_ms": prefill_ms, "degrade_caches_ms": degrade_ms,
        "decode_s": decode_s,
        "decode_tok_per_s": BATCH * (GEN - 1) / decode_s,
        "usable_coded": usable_coded, "usable_uncoded": usable_uncoded,
        "token_agree_coded": (coded_toks == clean_toks).float().mean().item(),
        "token_agree_uncoded":
            (uncoded_toks == clean_toks).float().mean().item(),
        "full_mask_max_err": err_full, "peak_mem_gib": peak_gib,
        "launches": launches, "profile": profile}
    print(f"prefill {BATCH}x{PROMPT}: {prefill_ms:.2f} ms; coded KV "
          f"transfer: {degrade_ms:.2f} ms; decode: {BATCH * (GEN - 1)} "
          f"tokens in {decode_s:.3f} s = {out['decode_tok_per_s']:.1f} tok/s")
    print(f"usable context (err <= {TAU}): coded {usable_coded:.4f}, "
          f"uncoded {usable_uncoded:.4f}; token agreement with clean: coded "
          f"{out['token_agree_coded']:.4f}, uncoded "
          f"{out['token_agree_uncoded']:.4f}; launches {launches}")
    for stage, rec in profile.items():
        print(f"profile {stage}: {rec}")
    return out


def phase_small_reference(dev, C, M, serve_step):
    """Smoke-size qwen2-0.5b in float32: the card (kernels) against the
    CPU (plain versions), same weights, prompt, mask and signs."""
    cfg = dataclasses.replace(C.get_smoke("qwen2-0.5b"), dtype="float32")
    cpu = torch.device("cpu")
    params = M.init_params(cfg, torch.Generator(cpu).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator(cpu).manual_seed(1))
    mask = torch.rand(N_ROT,
                      generator=torch.Generator(cpu).manual_seed(3)) < 0.8
    signs = torch.randint(0, 2, (N_ROT,),
                          generator=torch.Generator(cpu).manual_seed(4)
                          ).float() * 2 - 1
    res = {}
    for d in (cpu, dev):
        p = {k: v.to(d) for k, v in params.items()}
        logits, caches = serve_step.make_prefill(cfg, 24)(p, prompt.to(d))
        deg = serve_step.degrade_caches(caches, mask.to(d),
                                        signs=signs.to(d))
        toks = serve_step.greedy_generate(cfg, p, prompt.to(d), 6)
        res[d.type] = [t.cpu() for t in (logits, deg.k, deg.v, toks)]
    for name, a, b in zip(("logits", "degraded k", "degraded v"),
                          res["cpu"], res["cuda"]):
        check(f"smoke {name} card vs cpu", b, a, 2e-4, 2e-4)
    assert torch.equal(res["cpu"][3], res["cuda"][3]), "smoke greedy tokens"
    print("smoke qwen2-0.5b f32, card vs CPU: logits, degraded caches, "
          "greedy tokens agree")


def main():
    sys.path.insert(0, SRC)
    from repro_torch import resolve_device
    dev = resolve_device("cuda")            # raises without CUDA
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch.configs as C
    from repro_torch.core import coding
    from repro_torch.core import lossy_collectives as lc
    from repro_torch.core.transport import coupling
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.kernels import _build
    from repro_torch.kernels import fwht as kfwht
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as kquant
    from repro_torch.kernels import ref
    from repro_torch.kernels import unbias as kunbias
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.serve import serve_step
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    counts = Launches(kfwht, kunbias, kquant)
    phase_build(_build)
    records = phase_kernels(dev, C.get("qwen2-0.5b"), kfwht, kunbias, ref,
                            coding, coupling)
    records += phase_quant_kernels(dev, kfwht, kquant, ref)
    main_path = phase_main_path(dev, C, M, serve_step, coupling, counts)
    phase_small_reference(dev, C, M, serve_step)
    bench = phase_kernel_bench(dev, ops, counts)
    train, tr = phase_train(dev, C, ts, Trainer, DataConfig, OptConfig,
                            counts)
    allreduce = phase_allreduce(dev, ts, tr, coding, lc, counts)
    del tr
    torch.cuda.empty_cache()
    small_train = phase_small_train(dev, C, ts, OptConfig, DataConfig,
                                    make_source)
    by_path = {"serve": main_path["launches"],
               "kernel_bench": bench["launches"],
               "train": train["launches"],
               "allreduce": allreduce["launches"]}
    for rec in records:
        rec["launches_by_path"] = {p: c[rec["name"]]
                                   for p, c in by_path.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        assert rec["launches"] > 0, f"no path launched {rec['name']}"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"main_path": main_path, "kernel_bench": bench,
                      "train": train, "allreduce": allreduce,
                      "small_train": small_train,
                      "seconds": time.perf_counter() - t_start}))
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

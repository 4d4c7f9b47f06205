"""Drive the PyTorch/CUDA port's serve path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a, one compiler per source, all at once;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and over ``tests/test_kernels.py``'s shapes in
   float32 and bfloat16, and time kernel, plain version, a one-call
   PyTorch yardstick, and the bytes bound;
3. serve qwen2-0.5b at full width (24 layers, d 896, 14 heads padded to
   16, kv 2, vocab 151,936, bf16, random weights from seed 0): prefill
   8 prompts of 512 tokens, ship the KV caches through the coded lossy
   transfer at a delivered fraction of 0.9 (64 wire rows, fig8's cell),
   greedy-decode 32 tokens; the kernel launch counts of that run show it
   went through the kernels.  Uncoded and clean decodes, a full-mask
   round trip, and a smoke-size run against the CPU check the results.

The last line is ``{"ok": true, "device": {...}}``; the lines before it
carry the card's name and power limit and a ``{"kernels": [...]}``
record.  Needs CUDA: without it the script raises before printing any
result.
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


def phase_build(_build):
    t0 = time.perf_counter()
    _build.build("fwht", "unbias")
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, "
          "fwht.cu + unbias.cu in parallel)")
    for name in ("fwht", "unbias"):
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
    _sync()
    for rec in records:
        print(f"kernel {rec['name']} {rec['shape']}: max_abs_err "
              f"{rec['max_abs_err']:.3g}, {rec['ms']:.4f} ms (plain "
              f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f}, "
              f"bound {rec['bound_ms']:.4f} by {rec['bound_by']}); sweep "
              f"of {len(SWEEP)} shapes x f32/bf16 worst err "
              f"{worst[rec['name']]:.3g}")
    return records


def phase_main_path(dev, C, M, serve_step, coupling, kfwht, kunbias):
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
    kfwht.launches = kunbias.launches = 0
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
    launches = {"fwht": kfwht.launches, "masked_unbias": kunbias.launches}
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
    from repro_torch.core.transport import coupling
    from repro_torch.kernels import _build
    from repro_torch.kernels import fwht as kfwht
    from repro_torch.kernels import ref
    from repro_torch.kernels import unbias as kunbias
    from repro_torch.models import model as M
    from repro_torch.serve import serve_step

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    phase_build(_build)
    records = phase_kernels(dev, C.get("qwen2-0.5b"), kfwht, kunbias, ref,
                            coding, coupling)
    main_path = phase_main_path(dev, C, M, serve_step, coupling, kfwht,
                                kunbias)
    phase_small_reference(dev, C, M, serve_step)
    for rec in records:
        rec["launches"] = main_path["launches"][rec["name"]]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"main_path": main_path}))
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

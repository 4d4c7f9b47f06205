"""Serving launcher: batched prefill + greedy decode, optionally from KV
caches shipped through the coded lossy transport (port of
``repro/launch/serve.py`` with ``examples/serve_batched.py --kv-frac``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --batch 8 --prompt-len 512 --gen 32 --kv-frac 0.9
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --smoke --device cpu

Runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
missing.  Weights are random, from seed 0; the prompt from seed 1; the
rotation signs from seed 2.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch import resolve_device
from repro_torch.core.transport import coupling
from repro_torch.models import model as M
from repro_torch.serve import serve_step

N_ROT = 64        # wire rows per KV payload (fig8's coded-KV cell)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kv-frac", type=float, default=1.0,
                    help="delivered KV fraction; < 1 ships the caches "
                         "through the coded wire layout before decoding")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev)
    s_max = args.prompt_len + args.gen

    t0 = time.perf_counter()
    logits, caches = serve_step.make_prefill(cfg, s_max)(params, prompt)
    _sync(dev)
    print(f"prefill: {time.perf_counter() - t0:.3f}s")
    first = torch.argmax(logits, -1)[:, None]

    if args.kv_frac < 1.0:
        mask = torch.as_tensor(coupling.kv_hole_masks(
            np.array([args.kv_frac]), N_ROT, seed=0)[0], device=dev)
        caches = serve_step.degrade_caches(
            caches, mask, torch.Generator(dev).manual_seed(2))
        print(f"KV shipped at delivered fraction {args.kv_frac:g} "
              f"({N_ROT - int(mask.sum())}/{N_ROT} wire rows lost, coded)")

    t0 = time.perf_counter()
    out = serve_step.greedy_decode(cfg, params, caches, first,
                                   args.prompt_len, args.gen)
    _sync(dev)
    dt = time.perf_counter() - t0
    n = args.batch * (args.gen - 1)
    print(f"decode: {n} tokens in {dt:.3f}s ({n / dt:.1f} tok/s, {dev})")
    print("sample:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()

"""Serving launcher: batched prefill + greedy decode, optionally from KV
caches shipped through the coded lossy transport (port of
``repro/launch/serve.py`` with ``examples/serve_batched.py --kv-frac``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --batch 8 --prompt-len 512 --gen 32 --kv-frac 0.9
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --batch 8 --prompt-len 512 --gen 32 --kv-frac 0.9

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
        --batch 8 --prompt-len 512 --gen 32 --kv-frac 0.9
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --batch 8 --prompt-len 512 --gen 32 \
        --kv-frac 0.9
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi-3-vision-4.2b --batch 8 --prompt-len 512 --gen 32 \
        --kv-frac 0.9
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-medium --smoke --device cpu --kv-frac 0.9

``--arch`` takes any ported family: qwen2-0.5b, gemma2-9b, chatglm3-6b,
nemotron-4-15b, the MoE models qwen2-moe-a2.7b and granite-moe-3b-a800m,
the recurrent models recurrentgemma-9b (its local-attention layers'
K/V ship; the RG-LRU state is not coded) and xlstm-350m (no K/V cache:
nothing ships), and the modality stubs phi-3-vision-4.2b (144 image
positions prepended to the prompt; their K/V ship with the text's) and
seamless-m4t-medium (one frame a prompt token through the encoder,
encoded once; its memory reaches prefill and every decode step and is
not shipped) (full width, or ``--smoke`` for the reduced config).

On a mesh, one process a rank under ``torch.distributed.run``:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch gemma2-9b --smoke \
        --device cpu --mesh host --prompt-len 80 --kv-frac 0.9

``--mesh host`` is ``(max(n // 2, 1), min(2, n))`` over (data, model),
the JAX package's container-scale mesh (``make_host_mesh``);
``single``/``multi`` are the production meshes (256 and 512 ranks).
Every rank builds the whole weights from seed 0 and keeps its
``convert.shard_leaves``, takes its rows of the seed-1 prompt and the
seed-3 frontend inputs (``--batch`` is the global batch, which the dp
ranks must divide), and serves them tensor parallel over ``model``
(``serve_step.mesh_groups``); with ``--kv-frac`` each rank ships its own
K/V slices and prints the bytes it ships.  The backend is NCCL when
every local rank has a card of its own and gloo otherwise; the choice
is printed.

Runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
missing.  Weights are random, from seed 0; the prompt from seed 1; the
rotation signs from seed 2; the image or frame embeddings (standard
normal, bfloat16, as ``serve_step.frontend_inputs`` shapes them) from
seed 3.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.configs as C
from repro_torch import resolve_device
from repro_torch.core.transport import coupling
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import convert
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
    ap.add_argument("--mesh", choices=["none", "host", "single", "multi"],
                    default="none",
                    help="mesh over the ranks of torch.distributed.run: "
                    "host = (max(n // 2, 1), min(2, n)) over (data, model); "
                    "single/multi = the 16x16 and 2x16x16 production "
                    "meshes")
    args = ap.parse_args(argv)

    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    mesh, rank, tp, rows = None, 0, None, None
    if args.mesh != "none":
        backend, device = mesh_mod.init_ranks(args.device)
        dev, rank = torch.device(device), dist.get_rank()
        n = dist.get_world_size()
        if rank == 0:
            print(f"backend {backend}, {n} ranks, rank 0 on {device}",
                  flush=True)
        if args.mesh == "host":
            mesh = mesh_mod.make_host_mesh((max(n // 2, 1), min(2, n)),
                                           device_type=dev.type)
        else:
            mesh = mesh_mod.make_production_mesh(
                multi_pod=args.mesh == "multi", device_type=dev.type)
        tp, rows = serve_step.mesh_groups(cfg, mesh)
    else:
        dev = resolve_device(args.device)
    try:
        return _serve(args, cfg, dev, mesh, rank, tp, rows)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _serve(args, cfg, dev, mesh, rank, tp, rows):
    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev)
    extra = serve_step.frontend_inputs(
        cfg, args.batch, args.prompt_len, torch.Generator(dev).manual_seed(3))
    if mesh is not None:     # this rank's shards and rows
        names = convert.leaf_names(cfg)
        params = convert.params_from_leaves(convert.shard_leaves(
            convert.jax_leaves(params, cfg), mesh, names), cfg)
        mine = serve_step.local_batch(mesh, dict(extra, tokens=prompt))
        prompt = mine.pop("tokens")
        extra = mine
    start = cfg.n_front + args.prompt_len    # the first decoded position
    s_max = start + args.gen

    t0 = time.perf_counter()
    if "frame_embeds" in extra:              # encode once
        extra["memory"] = M.encode(params, cfg, extra.pop("frame_embeds"),
                                   tp)
    logits, caches = serve_step.make_prefill(cfg, s_max, tp, rows)(
        params, prompt, **extra)
    _sync(dev)
    say(f"prefill: {time.perf_counter() - t0:.3f}s")
    first = torch.argmax(logits, -1)[:, None]

    if args.kv_frac < 1.0:
        mask = torch.as_tensor(coupling.kv_hole_masks(
            np.array([args.kv_frac]), N_ROT, seed=0)[0], device=dev)
        wire = serve_step.kv_wire_bytes(caches, N_ROT)
        caches = serve_step.degrade_caches(
            caches, mask, torch.Generator(dev).manual_seed(2))
        if caches.leaves():
            say(f"KV shipped at delivered fraction {args.kv_frac:g} "
                f"({N_ROT - int(mask.sum())}/{N_ROT} wire rows lost, "
                "coded)")
            if mesh is not None:
                sizes = [None] * dist.get_world_size()
                dist.all_gather_object(sizes, wire)
                say("bytes a rank ships: " + ", ".join(
                    f"rank {r} {b:,}" for r, b in enumerate(sizes)))
        else:
            say("no K/V cache to ship: the recurrent state is not coded")
        if "memory" in extra:
            mem = extra["memory"]
            say(f"encoder memory {tuple(mem.shape)} {mem.dtype} "
                f"({mem.numel() * mem.element_size() / 2 ** 20:g} MiB) "
                "stays with the decoder: not coded, not shipped")

    t0 = time.perf_counter()
    out = serve_step.greedy_decode(cfg, params, caches, first, start,
                                   args.gen, memory=extra.get("memory"),
                                   tp=tp, rows=rows)
    _sync(dev)
    dt = time.perf_counter() - t0
    n = args.batch * (args.gen - 1)
    say(f"decode: {n} tokens in {dt:.3f}s ({n / dt:.1f} tok/s, {dev})")
    say(f"sample: {out[0, :16].tolist()}")
    return out


if __name__ == "__main__":
    main()

"""Training launcher (port of ``repro/launch/train.py``).

One device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 50 --celeris
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --smoke --device cpu --celeris --steps 3

On a mesh, one process a rank under ``torch.distributed.run``:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --arch qwen2-0.5b --smoke \
        --device cpu --mesh host --celeris --steps 3

``--mesh host`` is the JAX launcher's ``(max(n // 2, 1), min(2, n))``
over (data, model): data parallel over pairs of ranks that split the
model between them (tensor parallelism); ``single``/``multi`` are the
production meshes (256 and 512 ranks).  The backend is NCCL when every
local rank has a card of its own and gloo otherwise (ranks that share a
card, or the CPU); the choice is printed, and a backend that fails
raises.

With ``--ckpt-dir D`` the trainer checkpoints into D every
``--ckpt-every`` steps (default 50) and, started again, resumes from
D's ``LATEST``; on a mesh rank 0 writes, and a checkpoint restores on
any mesh:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --smoke --device cpu --steps 4 --ckpt-dir /tmp/run1 --ckpt-every 2

MoE (qwen2-moe-a2.7b): on a mesh with a ``model`` axis the MoE layers
run expert parallel, and ``--lossy-moe`` turns on the lossy expert
dispatch at the step's drop rate:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --arch qwen2-moe-a2.7b --smoke \
        --device cpu --mesh host --celeris --lossy-moe --steps 3

The other dense families and granite-moe train the same way, on one
device or a mesh (``--arch gemma2-9b``, ``chatglm3-6b``,
``nemotron-4-15b``, ``granite-moe-3b-a800m``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \
        --smoke --device cpu --celeris --steps 3

The recurrent families (``recurrentgemma-9b``, ``xlstm-350m``) and the
modality stubs (``phi-3-vision-4.2b``, ``seamless-m4t-medium``) train on
one device or any mesh, tensor parallel on a ``model`` axis too; the
launcher feeds them text alone, as the JAX launcher does, so a stub's
frontend, encoder and cross-attention take zero gradients and AdamW's
decay:

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \
        --smoke --device cpu --celeris --steps 3
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --arch xlstm-350m --smoke \
        --device cpu --mesh host --celeris --steps 3

Runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
missing.  Weights are random, from seed 0.
"""
from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

import repro_torch.configs as C
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.train_step import CelerisConfig
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--celeris", action="store_true")
    ap.add_argument("--lossy-moe", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["none", "host", "single", "multi"],
                    default="none",
                    help="mesh over the ranks of torch.distributed.run: "
                    "host = (max(n // 2, 1), min(2, n)) over (data, model), "
                    "data and tensor parallel; single/multi = the 16x16 "
                    "and 2x16x16 production meshes")
    args = ap.parse_args(argv)

    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    mesh, device, rank = None, args.device, 0
    if args.mesh != "none":
        backend, device = mesh_mod.init_ranks(args.device)
        rank = dist.get_rank()
        kind = torch.device(device).type
        if rank == 0:
            print(f"backend {backend}, {dist.get_world_size()} ranks, rank 0 "
                  f"on {device}", flush=True)
        if args.mesh == "host":
            n = dist.get_world_size()
            mesh = mesh_mod.make_host_mesh((max(n // 2, 1), min(2, n)),
                                           device_type=kind)
        else:
            mesh = mesh_mod.make_production_mesh(
                multi_pod=args.mesh == "multi", device_type=kind)

    def report(step, m):
        if rank == 0:
            print(f"step {step:4d} loss {m['loss']:.4f} nll {m['nll']:.4f} "
                  f"recv {m['recv_frac']:.3f} lr {m['lr']:.2e} "
                  f"({m['wall_s']:.2f}s)", flush=True)

    try:
        tr = Trainer(
            cfg,
            data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                seq_len=args.seq_len,
                                global_batch=args.global_batch),
            opt_cfg=OptConfig(lr=args.lr, total_steps=args.steps),
            celeris=CelerisConfig(
                mode="lossy_hadamard" if args.celeris else "exact",
                lossy_moe=args.lossy_moe),
            mesh=mesh, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            device=device)
        return tr.run(args.steps, on_metrics=report)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

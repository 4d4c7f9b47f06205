"""Training launcher (port of ``repro/launch/train.py``, one device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 50 --celeris
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --smoke --device cpu --celeris --steps 3

Runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
missing.  Weights are random, from seed 0.  There is no ``--mesh`` and
no checkpointing yet.
"""
from __future__ import annotations

import argparse

import repro_torch.configs as C
from repro_torch.data.pipeline import DataConfig
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    tr = Trainer(
        cfg,
        data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                            global_batch=args.global_batch),
        opt_cfg=OptConfig(lr=args.lr, total_steps=args.steps),
        celeris=CelerisConfig(
            mode="lossy_hadamard" if args.celeris else "exact"),
        device=args.device)
    return tr.run(args.steps, on_metrics=lambda s, m: print(
        f"step {s:4d} loss {m['loss']:.4f} nll {m['nll']:.4f} "
        f"recv {m['recv_frac']:.3f} lr {m['lr']:.2e} ({m['wall_s']:.2f}s)",
        flush=True))


if __name__ == "__main__":
    main()

"""Training launcher: any registered architecture on the redundant-assignment
trainer's host path at a chosen scale (the counterpart of the reference's
``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --scale smoke \\
        --steps 100 --redundancy 2 --scheme cyclic --ckpt /tmp/ck --device cpu

Runs on the card by default (``--device cuda``) and raises without one.
The scales are the reference's (``launch.serve.scaled_config``); weights
are random from ``--seed``, tokens from the reference's Markov table.
"""

from __future__ import annotations

import argparse

from ..launch.serve import _SCALES, scaled_config
from ..train.compression import CompressionConfig
from ..train.optimizer import AdamWConfig
from ..train.trainer import Trainer, TrainerConfig


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--scale", default="smoke", choices=list(_SCALES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--groups", type=int, default=4)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--redundancy", type=int, default=2)
    ap.add_argument("--scheme", default="cyclic", choices=("cyclic", "fr", "singleton"))
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--no-stragglers", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-vocab", type=int, default=None,
                    help="draw the token streams over the ids below this (the Markov table is its square)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = scaled_config(args.arch, args.scale)
    tcfg = TrainerConfig(
        num_groups=args.groups, num_shards=args.shards,
        redundancy=args.redundancy, scheme=args.scheme,
        microbatch=args.microbatch, seq_len=args.seq_len, steps=args.steps,
        ckpt_dir=args.ckpt, ckpt_every=max(args.steps // 4, 1), seed=args.seed, data_vocab=args.data_vocab,
        simulate_stragglers=not args.no_stragglers,
        compression=CompressionConfig() if args.compress else None,
    )
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1), total_steps=args.steps)
    trainer = Trainer(cfg, tcfg, ocfg, device=args.device)
    print(
        f"arch={cfg.name} scale={args.scale} on {trainer.device} | groups={args.groups} "
        f"ell={args.redundancy} scheme={args.scheme} steps={args.steps}"
    )

    def on_step(step, rec):
        if step % 10 == 0 or rec["stragglers"]:
            print(
                f"step {step:4d} loss={rec['loss']:.4f} "
                f"stragglers={rec['stragglers']} covered={rec['covered']:.2f}"
            )

    trainer.run(on_step=on_step)
    losses = [h["loss"] for h in trainer.history if "loss" in h]
    print(f"final: {losses[0]:.4f} -> {losses[-1]:.4f} ({len(losses)} steps)")
    return trainer.history


if __name__ == "__main__":
    main()

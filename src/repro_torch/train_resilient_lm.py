"""End to end: train a qwen3-family LM with straggler-resilient
redundant data assignment, deadline straggling, checkpoint/restart and
gradient compression — the paper's technique as a training feature (the
twin of ``examples/train_resilient_lm.py``, on the trainer's host path).

    PYTHONPATH=src python -m repro_torch.train_resilient_lm                  # smoke (~2M params)
    PYTHONPATH=src python -m repro_torch.train_resilient_lm --preset 100m    # ~100M params
    PYTHONPATH=src python -m repro_torch.train_resilient_lm --resume         # restart from checkpoint

Runs on the card unless ``--device cpu`` is given, and raises without one.
Checkpoints go to ``--ckpt-dir`` (by default ``repro_torch_ckpt_<preset>``
in the temporary directory); without ``--resume`` the directory is
cleared first.  ``--data-vocab N`` draws the token streams over the ids
below N (the Markov table is N² f64: 8.6 GB at the 100m preset's vocab
of 32,768).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile

from .configs.qwen3_4b import config as qwen3_4b_config
from .models.registry import ModelConfig
from .train.compression import CompressionConfig
from .train.optimizer import AdamWConfig
from .train.trainer import Trainer, TrainerConfig


def preset(name: str, ckpt_dir: str) -> tuple[ModelConfig, TrainerConfig, AdamWConfig]:
    base = qwen3_4b_config()
    if name == "smoke":
        cfg = dataclasses.replace(
            base, vocab=512, d_model=128, n_layers=4, n_heads=4, n_kv_heads=2,
            d_ff=384, head_dim=32,
        )
        tcfg = TrainerConfig(
            num_groups=4, num_shards=4, redundancy=2, scheme="cyclic",
            microbatch=2, seq_len=128, steps=150, ckpt_every=50,
            ckpt_dir=ckpt_dir, simulate_stragglers=True,
            compression=CompressionConfig(block=256),
        )
        ocfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=150)
    elif name == "100m":
        # ~100M params: 12L, d=768, dff=3072, vocab 32k.
        cfg = dataclasses.replace(
            base, vocab=32768, d_model=768, n_layers=12, n_heads=12,
            n_kv_heads=4, d_ff=3072, head_dim=64,
        )
        tcfg = TrainerConfig(
            num_groups=8, num_shards=8, redundancy=2, scheme="cyclic",
            microbatch=4, seq_len=1024, steps=300, ckpt_every=50,
            ckpt_dir=ckpt_dir, simulate_stragglers=True,
            compression=CompressionConfig(block=256),
        )
        ocfg = AdamWConfig(lr=6e-4, warmup_steps=30, total_steps=300)
    else:
        raise SystemExit(f"unknown preset {name}")
    return cfg.validate(), tcfg, ocfg


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="smoke", choices=("smoke", "100m"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data-vocab", type=int, default=None,
                    help="draw the token streams over the ids below this (the Markov table is its square)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), f"repro_torch_ckpt_{args.preset}")
    cfg, tcfg, ocfg = preset(args.preset, ckpt_dir)
    tcfg = dataclasses.replace(tcfg, data_vocab=args.data_vocab)
    if args.steps:
        tcfg = dataclasses.replace(tcfg, steps=args.steps)
        ocfg = dataclasses.replace(ocfg, total_steps=args.steps)
    trainer = Trainer(cfg, tcfg, ocfg, device=args.device)
    if not args.resume:
        shutil.rmtree(tcfg.ckpt_dir, ignore_errors=True)

    print(
        f"preset={args.preset}: {cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab} on {trainer.device} | "
        f"G={tcfg.num_groups} groups, ell={tcfg.redundancy} ({tcfg.scheme}), "
        f"{tcfg.steps} steps, ckpt every {tcfg.ckpt_every} -> {tcfg.ckpt_dir}"
    )

    def on_step(step, rec):
        if step % 10 == 0 or rec["stragglers"]:
            print(
                f"step {step:4d}  loss={rec['loss']:.4f}  gnorm={rec['grad_norm']:.2f}  "
                f"stragglers={rec['stragglers']}  delta={rec['delta']:.3f}  "
                f"covered={rec['covered']:.2f}"
            )

    trainer.run(on_step=on_step)
    losses = [h["loss"] for h in trainer.history if "loss" in h]
    if not losses:
        print(f"\ndone: the checkpoint in {tcfg.ckpt_dir} is already at step {tcfg.steps}; no step to run.")
        return trainer.history
    straggled_steps = sum(1 for h in trainer.history if h.get("stragglers", 0) > 0)
    print(
        f"\ndone: loss {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps; "
        f"{straggled_steps} steps had stragglers and still contributed via recovery weights."
    )
    return trainer.history


if __name__ == "__main__":
    main()

"""Serving launcher: batched decode for a registered architecture, dense,
MoE or xLSTM (the counterpart of the reference's ``launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --scale smoke \\
        --batch 4 --prompt-len 16 --gen 32 --device cpu

Runs on the card by default (``--device cuda``); ``--scale full`` is the
architecture's own config.  Weights are random from a fixed seed, drawn
directly in the compute dtype that the matmuls read (the reference draws
f32 and casts per call; drawn so, deepseek-moe-16b's 16.9 B parameters fit
one 80 GB card, where an f32 tree and its bf16 copy would not).  The
tokens/s is timed on the device's clock (after a synchronize on the card).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..device import resolve_device
from ..models import transformer as T
from ..models.registry import get_config
from ..serve.decode import greedy_generate

# The reference's scales (its launch/train.py).
_SCALES = {
    # (d_model, n_layers, heads, kv, d_ff, vocab, head_dim)
    "smoke": dict(d_model=128, n_layers=4, n_heads=4, n_kv_heads=2, d_ff=384,
                  vocab=512, head_dim=32),
    "100m": dict(d_model=768, n_layers=12, n_heads=12, n_kv_heads=4, d_ff=3072,
                 vocab=32768, head_dim=64),
    "full": None,  # the exact assigned config
}


def scaled_config(arch: str, scale: str):
    """The architecture at a scale, as the reference's launcher sizes it: an
    MoE config keeps its routing but takes 8 experts, top-2, width 64, one
    shared expert, and as many KV heads as query heads; an ``ssm`` or
    ``hybrid`` config keeps its own ``d_ff`` and KV heads; the depth is
    rounded down to whole scan units (at least one)."""
    cfg = get_config(arch)
    if _SCALES[scale] is not None:
        over = dict(_SCALES[scale])
        if cfg.moe is not None:
            over.pop("d_ff")
            over["moe"] = dataclasses.replace(cfg.moe, num_experts=8, top_k=2, d_expert=64, num_shared=1)
            over["n_kv_heads"] = over["n_heads"]
        if cfg.family in ("ssm", "hybrid"):
            over.pop("d_ff", None)
            over.pop("n_kv_heads", None)
        scan_len = len(cfg.scan_unit)
        body = over.get("n_layers", cfg.n_layers) - len(cfg.tail)
        over["n_layers"] = max(scan_len, body - body % scan_len) + len(cfg.tail)
        cfg = dataclasses.replace(cfg, **over)
    return cfg.validate()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--scale", default="smoke", choices=list(_SCALES))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = scaled_config(args.arch, args.scale)
    cfg = dataclasses.replace(cfg, param_dtype=cfg.compute_dtype)
    device = resolve_device(args.device)
    model = T.init_params(cfg, generator=torch.Generator(device=device).manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    out = greedy_generate(
        model, cfg, prompt, steps=args.gen, temperature=args.temperature, generator=gen
    )
    sync()
    dt = time.perf_counter() - t0
    print(
        f"{cfg.name} [{args.scale}]  batch={args.batch} prompt={args.prompt_len} "
        f"gen={args.gen}  {args.batch * args.gen / dt:.1f} tok/s on {device}"
    )
    print("row 0:", out[0].tolist())


if __name__ == "__main__":
    main()

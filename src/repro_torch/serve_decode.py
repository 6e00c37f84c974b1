"""Batched serving demo: token-by-token decode with a KV cache on a reduced
qwen3-style model, and the recurrent-state decode of the xLSTM family (no
KV cache at all); the twin of the reference's ``examples/serve_decode.py``.

    PYTHONPATH=src python -m repro_torch.serve_decode --device cpu

Runs on the card unless ``--device cpu`` is given.  Weights are random
from seed 0, prompts from seed 1, and the temperature-0.8 draws from an
explicit ``torch.Generator`` seeded with 2.  The tokens/s is timed on the
host's clock after a synchronise on the card.
"""

from __future__ import annotations

import argparse
import time

import torch

from .configs.qwen3_4b import smoke_config as qwen_smoke
from .configs.xlstm_1_3b import smoke_config as xlstm_smoke
from .device import resolve_device
from .models import transformer as T
from .serve.decode import greedy_generate


def demo(name: str, cfg, device: torch.device, B: int = 4, prompt_len: int = 16, gen: int = 24) -> None:
    """Serve ``cfg`` at random weights: ``gen`` tokens after a prompt of
    ``prompt_len`` for ``B`` requests.  Prints the rate and row 0."""
    cfg = cfg.validate()
    model = T.init_params(cfg, generator=torch.Generator(device=device).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab, (B, prompt_len), device=device,
                           generator=torch.Generator(device=device).manual_seed(1))
    draws = torch.Generator(device=device).manual_seed(2)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = greedy_generate(model, cfg, prompt, steps=gen, temperature=0.8, generator=draws)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"{name:12s} batch={B} prompt={prompt_len} generated={gen} ({B * gen / dt:.1f} tok/s on {device})")
    print(f"  sample row 0: {out[0].tolist()}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Batched greedy/temperature decode demo.")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("Serving demo — batched greedy/temperature decode\n")
    demo("qwen3-smoke", qwen_smoke(), device)
    demo("xlstm-smoke", xlstm_smoke(), device)
    print("\nxLSTM decodes from an O(1)-size recurrent state — no KV cache.")


if __name__ == "__main__":
    main()

"""Serving entry points: batched prefill + single-token decode steps (the
counterpart of the reference's ``serve/decode.py``), and the generation
loop of the serving launcher: greedy or temperature sampling over a batch
of requests with a shared-step K/V cache."""

from __future__ import annotations

from typing import Optional

import torch

from ..models import transformer as T
from ..models.registry import ModelConfig

__all__ = ["make_prefill_fn", "make_decode_fn", "greedy_generate"]


def make_prefill_fn(cfg: ModelConfig, ctx: T.ModelContext):
    def prefill_fn(model, batch):
        return T.prefill(model, batch, cfg, ctx)

    return prefill_fn


def make_decode_fn(cfg: ModelConfig, ctx: T.ModelContext):
    def decode_fn(model, cache, tokens_t, cur_len):
        return T.decode_step(model, cache, tokens_t, cur_len, cfg, ctx)

    return decode_fn


@torch.no_grad()
def greedy_generate(
    model,
    cfg: ModelConfig,
    prompt_tokens: torch.Tensor,
    *,
    steps: int,
    max_len: Optional[int] = None,
    ctx: Optional[T.ModelContext] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Decode ``steps`` tokens after teacher-forcing the prompt through the
    decode path, token by token, as the reference does.

    prompt_tokens: (B, T₀), or (B, K, T₀) for a codebook model, on the
    model's device.  At temperature 0 the next token is the argmax (the
    first index on ties), per codebook; above 0 it is drawn from
    softmax(logits / temperature) with ``generator``, which is then
    required.  Returns (B, steps) int64 token ids (the first codebook's
    for a codebook model, as the reference returns).
    """
    if temperature > 0 and generator is None:
        raise ValueError("greedy_generate: temperature > 0 needs an explicit torch.Generator")
    ctx = ctx or T.ModelContext()
    B, T0 = prompt_tokens.shape[0], prompt_tokens.shape[-1]
    max_len = max_len or (T0 + steps)
    cache = T.init_cache(cfg, B, max_len, device=prompt_tokens.device)
    decode = make_decode_fn(cfg, ctx)

    logits = None
    for t in range(T0):
        logits, cache = decode(model, cache, prompt_tokens[..., t : t + 1], t)

    outs = []
    for s in range(steps):
        lg = logits[:, -1]  # (B, V), or (B, K, V) for a codebook model
        if temperature > 0:
            probs = torch.softmax(lg.float() / temperature, dim=-1)
            flat = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=generator)
            nxt = flat.reshape(lg.shape[:-1])
        else:
            nxt = torch.argmax(lg, dim=-1)
        outs.append(nxt[:, 0] if cfg.num_codebooks > 0 else nxt)
        logits, cache = decode(model, cache, nxt[..., None], T0 + s)
    return torch.stack(outs, dim=1)

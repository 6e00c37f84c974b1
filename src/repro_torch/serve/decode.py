"""Serving entry points: batched prefill + single-token decode steps (the
counterpart of the reference's ``serve/decode.py``), and the generation
loop of the serving launcher: greedy or temperature sampling over a batch
of requests with a shared-step K/V cache.

Under an LM mesh (``ctx.mesh``) each rank decodes its data shard's rows.
Temperature sampling draws for the global batch on every rank, from a
generator seeded alike on every rank, over the logits gathered from every
shard, and keeps the rank's rows: the draws are the meshless run's, and
the ranks' draws are checked equal by hash at the end
(``launch.distributed.digest``); greedy ids are checked equal among the
ranks of each data shard."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..launch.distributed import digest
from ..launch.sharding import gather_rows, local_rows
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
    for a codebook model, as the reference returns).  Under a mesh, B is
    the rank's rows and so are the ids returned.
    """
    if temperature > 0 and generator is None:
        raise ValueError("greedy_generate: temperature > 0 needs an explicit torch.Generator")
    ctx = ctx or T.ModelContext()
    B, T0 = prompt_tokens.shape[0], prompt_tokens.shape[-1]
    max_len = max_len or (T0 + steps)
    mesh = ctx.mesh
    cache = T.init_cache(cfg, B, max_len, device=prompt_tokens.device, model=model, ctx=ctx)
    decode = make_decode_fn(cfg, ctx)
    drawn = []

    logits = None
    for t in range(T0):
        logits, cache = decode(model, cache, prompt_tokens[..., t : t + 1], t)

    outs = []
    for s in range(steps):
        lg = logits[:, -1]  # (B, V), or (B, K, V) for a codebook model
        if temperature > 0:
            lg = gather_rows(lg, mesh)  # the global batch: every rank draws it alike
            probs = torch.softmax(lg.float() / temperature, dim=-1)
            flat = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=generator)
            nxt = flat.reshape(lg.shape[:-1])
            drawn.append(nxt)
            nxt = local_rows(nxt, mesh)
        else:
            nxt = torch.argmax(lg, dim=-1)
        outs.append(nxt[:, 0] if cfg.num_codebooks > 0 else nxt)
        logits, cache = decode(model, cache, nxt[..., None], T0 + s)
    out = torch.stack(outs, dim=1)
    if mesh is not None:
        _check_lockstep(mesh, drawn, out)
    return out


def _check_lockstep(mesh, drawn, out) -> None:
    """Every rank drew the same global ids, and the ranks of each data
    shard return the same ids; raises otherwise."""
    shard = tuple(mesh.coord(a) for a in mesh.axis_names if a != "model")
    mine = (shard, digest(drawn), digest(out))
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, mine)
    if len({d for _, d, _ in seen}) != 1 or len({(s, o) for s, _, o in seen}) != len({s for s, _, _ in seen}):
        raise RuntimeError(f"greedy_generate: the ranks' ids part under the mesh: {seen}")

"""Zero-allocation input stand-ins for every (arch × shape) dry-run cell
(the twin of the reference's ``launch/specs.py``).

The reference's ``jax.ShapeDtypeStruct`` becomes a tensor on the ``meta``
device: a shape and a dtype, no storage.  ``input_specs`` covers the model
inputs; state and cache structures come from the real initialisers on the
``meta`` device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.registry import ModelConfig

__all__ = ["SHAPES", "ShapeCell", "input_specs", "cell_is_applicable", "all_cells"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_is_applicable(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """long_500k requires sub-quadratic decode (SSM/hybrid); all ten assigned
    archs are decoders, so decode shapes otherwise always apply.  The
    port's latent-attention arch (deepseek-v2-lite) trains meshless only,
    so no cell of the multi-pod mesh applies to it."""
    if cfg.mla is not None:
        return False, "latent attention (MLA): the port has no mesh or decode path for it yet"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, (
            "pure full-attention arch: a 524288-token dense KV pass is "
            "architecturally quadratic — skipped per assignment "
            "(DESIGN.md §6)"
        )
    return True, ""


def all_cells(cfg: ModelConfig) -> list[ShapeCell]:
    return [s for s in SHAPES.values() if cell_is_applicable(cfg, s)[0]]


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeCell, *, num_groups: int = 32) -> dict:
    """Model-input stand-ins for one cell.

    train  → {tokens, group_weights[, prefix_embeds]}
    prefill→ {tokens[, prefix_embeds]}
    decode → {tokens_t, cur_len} (cache/state come from the initialisers)
    """
    B, T = shape.global_batch, shape.seq_len
    i32 = torch.int32
    cd = getattr(torch, cfg.compute_dtype)
    if shape.kind in ("train", "prefill"):
        batch: dict = {}
        if cfg.num_codebooks > 0:
            batch["tokens"] = _spec((B, cfg.num_codebooks, T), i32)
        elif cfg.num_prefix_tokens > 0:
            p = cfg.num_prefix_tokens
            batch["tokens"] = _spec((B, T - p), i32)
            batch["prefix_embeds"] = _spec((B, p, cfg.d_model), cd)
        else:
            batch["tokens"] = _spec((B, T), i32)
        if shape.kind == "train":
            batch["group_weights"] = _spec((num_groups,), torch.float32)
        return batch
    # decode: one new token against a seq_len-deep cache
    if cfg.num_codebooks > 0:
        tok = _spec((B, cfg.num_codebooks, 1), i32)
    else:
        tok = _spec((B, 1), i32)
    return {"tokens_t": tok, "cur_len": _spec((), i32)}

"""Decoder assembly for the dense ``attn_mlp`` family (the serving subset of
the reference's ``models/transformer.py``).

The model is an ``nn.Module`` tree: an embedding, one :class:`Block` per
layer in a ``ModuleList``, a final norm and a head.  The reference stacks
the layers' parameters along a leading ``reps`` axis and runs ``lax.scan``;
here a Python loop walks the blocks (``convert.transformer_params_from_jax``
unstacks the reference's tree).  Parameters are held in ``param_dtype``, and
every matmul casts its weight to ``compute_dtype`` as the reference does;
:func:`cast_params` makes, once, a copy whose matmul weights already are in
``compute_dtype``, so the casts do nothing.

Entry points:
  * :func:`forward_train` — (B, T) tokens → logits (forward only for now;
    the decode oracle of the tests)
  * :func:`prefill` / :func:`decode_step` — serving with a per-layer K/V
    cache; ``decode_step`` writes the cache in place

MoE, xLSTM, RG-LRU and local-attention blocks, the modality frontends,
``loss_fn`` and meshes are not ported yet; they raise with the ROADMAP item
that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from . import attention as A
from . import layers as L
from .registry import ModelConfig

__all__ = [
    "Block",
    "ModelContext",
    "Transformer",
    "cast_params",
    "decode_step",
    "forward_train",
    "init_cache",
    "init_params",
    "model_from_state_dict",
    "param_count",
    "prefill",
]

# Block types of the reference that the port does not run yet, with the
# ROADMAP item (queue 1) that ports them.
_UNPORTED_BLOCKS = {
    "attn_moe": "item 13.1 (MoE blocks)",
    "mlstm": "item 13.2 (xLSTM blocks)",
    "slstm": "item 13.2 (xLSTM blocks)",
    "rglru_mlp": "item 13.3 (RG-LRU and local attention)",
    "lattn_mlp": "item 13.3 (RG-LRU and local attention)",
}


@dataclasses.dataclass(frozen=True)
class ModelContext:
    """Implementation switches.  ``attn_impl`` is ``auto`` (the kernel on
    the card, the plain version on the CPU), ``cuda`` or ``torch_ref``."""

    attn_impl: str = "auto"
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "ModelContext: LM meshes are not ported yet (ROADMAP queue 1, item 9, "
                "what waits: launch/{mesh,sharding,specs}.py)")


def _check_supported(cfg: ModelConfig) -> None:
    for bt in cfg.block_types:
        if bt != "attn_mlp":
            raise NotImplementedError(
                f"{cfg.name}: block type {bt!r} is not ported yet: ROADMAP queue 1, "
                f"{_UNPORTED_BLOCKS.get(bt, 'item 13')}")
    if cfg.num_codebooks > 0 or cfg.num_prefix_tokens > 0:
        raise NotImplementedError(
            f"{cfg.name}: modality frontends are not ported yet: ROADMAP queue 1, item 13.4")


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ------------------------------------------------------------------ params


class Block(nn.Module):
    """One ``attn_mlp`` layer: pre-norm GQA attention, pre-norm MLP."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.attn_norm = L.rmsnorm_init(cfg.d_model, dtype=dtype, device=device)
        self.attn = A.attn_init(cfg, **kw)
        self.mlp_norm = L.rmsnorm_init(cfg.d_model, dtype=dtype, device=device)
        self.mlp = L.mlp_init(cfg.d_model, cfg.d_ff, gated=cfg.mlp_act != "gelu", **kw)


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator):
        super().__init__()
        _check_supported(cfg)
        dtype = getattr(torch, cfg.param_dtype)
        d, V = cfg.d_model, cfg.vocab
        embed = torch.randn((V, d), generator=generator, device=device, dtype=dtype)
        self.embed = nn.Parameter(embed.mul_(0.02), requires_grad=False)
        self.blocks = nn.ModuleList(
            Block(cfg, dtype=dtype, device=device, generator=generator) for _ in range(cfg.n_layers)
        )
        self.final_norm = L.rmsnorm_init(d, dtype=dtype, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = L.dense_init(d, V, dtype=dtype, device=device, generator=generator, scale=0.02)


def init_params(cfg: ModelConfig, *, generator: torch.Generator) -> Transformer:
    """Random weights drawn from ``generator`` directly on its device (the
    reference's initialisation laws, not its random stream)."""
    return Transformer(cfg, device=generator.device, generator=generator)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def model_from_state_dict(cfg: ModelConfig, state_dict) -> Transformer:
    """A model that holds the given tensors themselves (device and dtype
    as they are; nothing is drawn or copied)."""
    model = Transformer(cfg, device="meta", generator=None)
    model.load_state_dict(state_dict, assign=True)
    return model


def cast_params(model: Transformer, cfg: ModelConfig) -> Transformer:
    """A model whose embedding and matmul weights are held in
    ``compute_dtype``: the values every per-call cast would give, made once.
    The norm scales, which the forward reads in f32, are shared as they are."""
    cd = _compute_dtype(cfg)
    sd = {
        name: t if name.endswith("norm") else t.to(cd)
        for name, t in model.state_dict().items()
    }
    return model_from_state_dict(cfg, sd)


# ------------------------------------------------------------------ blocks


def _block_apply(p: Block, x, cfg: ModelConfig, ctx: ModelContext, positions):
    """Training/prefill forward of one ``attn_mlp`` block.  Returns (x, cache)."""
    xn = L.rmsnorm(x, p.attn_norm, eps=cfg.rms_eps)
    a, (k, v) = A.attn_apply(p.attn, xn, cfg, positions=positions, impl=ctx.attn_impl)
    x = x + a
    xn2 = L.rmsnorm(x, p.mlp_norm, eps=cfg.rms_eps)
    x = x + L.mlp_apply(p.mlp, xn2, act=cfg.mlp_act, compute_dtype=_compute_dtype(cfg)).to(x.dtype)
    return x, {"k": k, "v": v}


def _block_decode(p: Block, x_t, cache, cur_len: int, cfg: ModelConfig):
    """One-token decode of one ``attn_mlp`` block.  Returns (x_t, cache)."""
    xn = L.rmsnorm(x_t, p.attn_norm, eps=cfg.rms_eps)
    a, ck, cv = A.attn_decode_step(p.attn, xn, cache["k"], cache["v"], cur_len, cfg)
    x_t = x_t + a
    xn2 = L.rmsnorm(x_t, p.mlp_norm, eps=cfg.rms_eps)
    x_t = x_t + L.mlp_apply(p.mlp, xn2, act=cfg.mlp_act, compute_dtype=_compute_dtype(cfg)).to(x_t.dtype)
    return x_t, {"k": ck, "v": cv}


# ------------------------------------------------------------------ embed


def _embed(model: Transformer, batch, cfg: ModelConfig):
    """Token embedding.  Returns (x (B, T, d) in compute dtype, label_mask)."""
    tokens = batch["tokens"]
    x = model.embed[tokens].to(_compute_dtype(cfg))
    return x, torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)


def _logits(model: Transformer, x, cfg: ModelConfig):
    cd = _compute_dtype(cfg)
    x = L.rmsnorm(x, model.final_norm, eps=cfg.rms_eps)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    return x.to(cd) @ head.to(cd)


# ------------------------------------------------------------------ train


@torch.no_grad()
def forward_train(model: Transformer, batch, cfg: ModelConfig, ctx: ModelContext):
    """Full forward.  Returns (logits (B, T, V), aux (0: no MoE), label_mask)."""
    x, mask = _embed(model, batch, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for blk in model.blocks:
        x, _ = _block_apply(blk, x, cfg, ctx, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(model, x, cfg), aux, mask


# ------------------------------------------------------------------ serve


def init_cache(cfg: ModelConfig, B: int, max_len: int, *, device) -> list[dict]:
    """One {"k", "v"} pair of zeros (B, max_len, KV, dh) in compute dtype per
    layer (the reference stacks them along a leading ``reps`` axis)."""
    _check_supported(cfg)
    shape = (B, max_len, cfg.n_kv_heads, cfg.head_dim)
    cd = _compute_dtype(cfg)
    return [
        {"k": torch.zeros(shape, dtype=cd, device=device), "v": torch.zeros(shape, dtype=cd, device=device)}
        for _ in range(cfg.n_layers)
    ]


@torch.no_grad()
def decode_step(model: Transformer, cache, tokens_t, cur_len: int, cfg: ModelConfig, ctx: ModelContext):
    """One decode step.  tokens_t: (B, 1); cur_len: the count of tokens
    already in the cache.  Writes the cache in place; returns (logits_t
    (B, 1, V), cache)."""
    x = model.embed[tokens_t].to(_compute_dtype(cfg))
    new_cache = []
    for blk, c in zip(model.blocks, cache):
        x, nc = _block_decode(blk, x, c, int(cur_len), cfg)
        new_cache.append(nc)
    return _logits(model, x, cfg), new_cache


@torch.no_grad()
def prefill(model: Transformer, batch, cfg: ModelConfig, ctx: ModelContext):
    """Prefill forward: the next-token logits (B, 1, V) and the per-layer
    K/V cache (B, T, KV, dh).  Only the last position reaches the head."""
    x, _ = _embed(model, batch, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    cache = []
    for blk in model.blocks:
        x, c = _block_apply(blk, x, cfg, ctx, positions)
        cache.append(c)
    return _logits(model, x[:, -1:], cfg), cache

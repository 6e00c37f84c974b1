"""Decoder assembly for the ``attn_mlp``, ``attn_moe``, ``mlstm`` and
``slstm`` block types (the serving subset of the reference's
``models/transformer.py``).

The model is an ``nn.Module`` tree: an embedding, one block per layer in a
``ModuleList`` (:class:`Block` for attention layers,
:class:`~repro_torch.models.xlstm.MLSTMBlock` and
:class:`~repro_torch.models.xlstm.SLSTMBlock` for the xLSTM ones), a final
norm and a head.  The reference stacks
the layers' parameters along a leading ``reps`` axis and runs ``lax.scan``;
here a Python loop walks the blocks (``convert.transformer_params_from_jax``
unstacks the reference's tree).  Parameters are held in ``param_dtype``, and
every matmul casts its weight to ``compute_dtype`` as the reference does;
:func:`cast_params` makes, once, a copy whose matmul weights already are in
``compute_dtype``, so the casts do nothing.

Entry points:
  * :func:`forward_train` — (B, T) tokens → logits and the layers' summed
    MoE aux loss (forward only for now; the decode oracle of the tests)
  * :func:`prefill` / :func:`decode_step` — serving with a per-layer cache:
    K/V for attention layers, which ``decode_step`` writes in place, and
    the recurrent state of an xLSTM layer, which it replaces.  As in the
    reference, ``prefill`` returns ``{}`` as a recurrent layer's cache: an
    xLSTM model is served by teacher-forcing the prompt through
    ``decode_step`` (``serve.decode.greedy_generate``).

RG-LRU and local-attention blocks, the modality frontends, ``loss_fn`` and
meshes are not ported yet; they raise with the ROADMAP item that ports
them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from . import attention as A
from . import layers as L
from . import moe as M
from . import xlstm as X
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

_BLOCKS = ("attn_mlp", "attn_moe", "mlstm", "slstm")  # the block types the port runs
# Block types of the reference that the port does not run yet, with the
# ROADMAP item (queue 1) that ports them.
_UNPORTED_BLOCKS = {
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
        if bt not in _BLOCKS:
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
    """One layer: pre-norm GQA attention, then a pre-norm MLP
    (``attn_mlp``) or routed experts (``attn_moe``, parameters ``moe``)."""

    def __init__(self, cfg: ModelConfig, block_type: str, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.block_type = block_type
        self.attn_norm = L.rmsnorm_init(cfg.d_model, dtype=dtype, device=device)
        self.attn = A.attn_init(cfg, **kw)
        self.mlp_norm = L.rmsnorm_init(cfg.d_model, dtype=dtype, device=device)
        if block_type == "attn_moe":
            self.moe = M.MoE(cfg, **kw)
        else:
            self.mlp = L.mlp_init(cfg.d_model, cfg.d_ff, gated=cfg.mlp_act != "gelu", **kw)


def _block(cfg: ModelConfig, block_type: str, **kw) -> nn.Module:
    if block_type == "mlstm":
        return X.MLSTMBlock(cfg, **kw)
    if block_type == "slstm":
        return X.SLSTMBlock(cfg, **kw)
    return Block(cfg, block_type, **kw)


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator):
        super().__init__()
        _check_supported(cfg)
        dtype = getattr(torch, cfg.param_dtype)
        d, V = cfg.d_model, cfg.vocab
        embed = torch.randn((V, d), generator=generator, device=device, dtype=dtype)
        self.embed = nn.Parameter(embed.mul_(0.02), requires_grad=False)
        self.blocks = nn.ModuleList(_block(cfg, bt, dtype=dtype, device=device, generator=generator)
                                    for bt in cfg.block_types)
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


# Parameters the forward reads in f32 whatever the compute dtype.
_READ_IN_F32 = ("norm", "moe.router", ".r_z", ".r_i", ".r_f", ".r_o")


def cast_params(model: Transformer, cfg: ModelConfig) -> Transformer:
    """A model whose embedding and matmul weights are held in
    ``compute_dtype``: the values every per-call cast would give, made once.
    The norm scales, the MoE routers and the sLSTM's recurrent matrices
    ``r_{z,i,f,o}``, which the forward reads in f32, are shared as they are
    (a rounded router would move routing decisions, a rounded recurrence
    would round every step of the cell).
    It serves a tree held in f32, such as one carried from the reference;
    the MoE launcher and the smoke script draw their weights in the compute
    dtype and never call it."""
    cd = _compute_dtype(cfg)
    sd = {
        name: t if name.endswith(_READ_IN_F32) else t.to(cd)
        for name, t in model.state_dict().items()
    }
    return model_from_state_dict(cfg, sd)


# ------------------------------------------------------------------ blocks


def _ffn(p: Block, xn2, cfg: ModelConfig):
    """The block's feed-forward on the normed residual.  Returns (out in
    xn2's dtype, MoE aux loss or None)."""
    if p.block_type == "attn_moe":
        return M.moe_apply(p.moe, xn2, cfg)
    out = L.mlp_apply(p.mlp, xn2, act=cfg.mlp_act, compute_dtype=_compute_dtype(cfg))
    return out.to(xn2.dtype), None


def _block_apply(p, x, cfg: ModelConfig, ctx: ModelContext, positions):
    """Training/prefill forward of one block.  Returns (x, aux or None,
    cache: K/V for attention, ``{}`` for a recurrent block)."""
    if p.block_type == "mlstm":
        return X.mlstm_apply(p, x, cfg), None, {}
    if p.block_type == "slstm":
        return X.slstm_apply(p, x, cfg), None, {}
    xn = L.rmsnorm(x, p.attn_norm, eps=cfg.rms_eps)
    a, (k, v) = A.attn_apply(p.attn, xn, cfg, positions=positions, impl=ctx.attn_impl)
    x = x + a
    f, aux = _ffn(p, L.rmsnorm(x, p.mlp_norm, eps=cfg.rms_eps), cfg)
    return x + f, aux, {"k": k, "v": v}


def _block_decode(p, x_t, cache, cur_len: int, cfg: ModelConfig, ctx: ModelContext):
    """One-token decode of one block.  Returns (x_t, cache)."""
    if p.block_type == "mlstm":
        return X.mlstm_decode_step(p, cache, x_t, cfg)
    if p.block_type == "slstm":
        return X.slstm_decode_step(p, cache, x_t, cfg)
    xn = L.rmsnorm(x_t, p.attn_norm, eps=cfg.rms_eps)
    a, ck, cv = A.attn_decode_step(p.attn, xn, cache["k"], cache["v"], cur_len, cfg)
    x_t = x_t + a
    f, _ = _ffn(p, L.rmsnorm(x_t, p.mlp_norm, eps=cfg.rms_eps), cfg)
    return x_t + f, {"k": ck, "v": cv}


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
    """Full forward.  Returns (logits (B, T, V), aux (the layers' MoE aux
    losses summed, f32; 0 without MoE), label_mask)."""
    x, mask = _embed(model, batch, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in model.blocks:
        x, a, _ = _block_apply(blk, x, cfg, ctx, positions)
        if a is not None:
            aux = aux + a
    return _logits(model, x, cfg), aux, mask


# ------------------------------------------------------------------ serve


def _block_cache_init(bt: str, cfg: ModelConfig, B: int, max_len: int, device) -> dict:
    if bt == "mlstm":
        return X.mlstm_init_state(cfg, B, device=device)
    if bt == "slstm":
        return X.slstm_init_state(cfg, B, device=device)
    shape = (B, max_len, cfg.n_kv_heads, cfg.head_dim)
    cd = _compute_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=cd, device=device), "v": torch.zeros(shape, dtype=cd, device=device)}


def init_cache(cfg: ModelConfig, B: int, max_len: int, *, device) -> list[dict]:
    """One cache per layer (the reference stacks them along a leading
    ``reps`` axis): a {"k", "v"} pair of zeros (B, max_len, KV, dh) in
    compute dtype for an attention layer, the zero recurrent state in f32
    for an xLSTM one (mLSTM ``{C, n, m, conv}``, sLSTM ``{h, c, n, m}``)."""
    _check_supported(cfg)
    return [_block_cache_init(bt, cfg, B, max_len, device) for bt in cfg.block_types]


@torch.no_grad()
def decode_step(model: Transformer, cache, tokens_t, cur_len: int, cfg: ModelConfig, ctx: ModelContext):
    """One decode step.  tokens_t: (B, 1); cur_len: the count of tokens
    already in the cache.  Writes an attention layer's K/V in place and
    replaces a recurrent layer's state; returns (logits_t (B, 1, V), cache)."""
    x = model.embed[tokens_t].to(_compute_dtype(cfg))
    new_cache = []
    for blk, c in zip(model.blocks, cache):
        x, nc = _block_decode(blk, x, c, int(cur_len), cfg, ctx)
        new_cache.append(nc)
    return _logits(model, x, cfg), new_cache


@torch.no_grad()
def prefill(model: Transformer, batch, cfg: ModelConfig, ctx: ModelContext):
    """Prefill forward: the next-token logits (B, 1, V) and the per-layer
    cache, K/V (B, T, KV, dh) for attention and ``{}`` for a recurrent
    layer.  Only the last position reaches the head."""
    x, _ = _embed(model, batch, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    cache = []
    for blk in model.blocks:
        x, _, c = _block_apply(blk, x, cfg, ctx, positions)
        cache.append(c)
    return _logits(model, x[:, -1:], cfg), cache

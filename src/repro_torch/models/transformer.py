"""Decoder assembly for the ``attn_mlp``, ``attn_moe``, ``mlstm``,
``slstm``, ``rglru_mlp`` and ``lattn_mlp`` block types and the two
modality frontends (the reference's ``models/transformer.py`` without its
meshes), and for the port's latent-attention blocks ``mla_mlp`` and
``mla_moe`` (:mod:`.mla`: training and prefill's forward, meshless; no
decode yet).

The model is an ``nn.Module`` tree: an embedding, one block per layer in a
``ModuleList`` (:class:`Block` for attention layers, global or local,
:class:`~repro_torch.models.xlstm.MLSTMBlock` and
:class:`~repro_torch.models.xlstm.SLSTMBlock` for the xLSTM ones,
:class:`~repro_torch.models.rglru.RGLRUBlock` for the RG-LRU ones), a final
norm and a head.  The reference stacks the body's layers' parameters along
a leading ``reps`` axis and runs ``lax.scan``, then its ``tail`` blocks;
here a Python loop walks the blocks, the tail last
(``convert.transformer_params_from_jax`` unstacks the reference's tree).
Parameters are held in ``param_dtype``, and every matmul casts its weight
to ``compute_dtype`` as the reference does; :func:`cast_params` makes,
once, a copy whose matmul weights already are in ``compute_dtype``, so the
casts do nothing.  :func:`init_params` can draw the embedding and the
matmul weights in another dtype than the parameters the forward reads in
f32 (:data:`_READ_IN_F32`), as the serving launcher does.

The frontends are the reference's stubs: a codebook model
(``num_codebooks`` K > 0, musicgen-large) embeds K parallel token streams
(B, K, T) with a (K, V, d) embedding, sums the K embeddings, and its
(d, V·K) head gives (B, T, K, V) logits; a prefix model
(``num_prefix_tokens`` > 0, internvl2-1b) prepends the batch's
``prefix_embeds`` (B, P, d), precomputed patch embeddings, to the text
embeddings, with a zero label mask over them.

Entry points:
  * :func:`forward_train` — tokens → logits and the layers' summed MoE aux
    loss; differentiable (the trainer's forward)
  * :func:`loss_fn` — the group-weighted causal-LM cross entropy; the
    recovery weights of the paper's Lemma 3 enter here
  * :func:`prefill` / :func:`decode_step` — serving with a per-layer cache,
    under ``torch.no_grad``:
    K/V for attention layers, which ``decode_step`` writes in place, and
    the recurrent state of an xLSTM or RG-LRU layer, which it replaces.
    A local-attention layer's cache is a ring of the window's size.  As in
    the reference, ``prefill`` returns ``{}`` as a recurrent layer's cache:
    a recurrent model is served by teacher-forcing the prompt through
    ``decode_step`` (``serve.decode.greedy_generate``).

Under an LM mesh (``ModelContext(mesh=...)``, from
``launch.sharding.make_context``) every rank runs this code on its data
shard's rows with its blocks of the parameters (``launch.sharding``): the
embedding is vocab-parallel (each model rank looks up the ids in its vocab
range, then one sum over ``model``), the head too (the logits gathered
over ``model``), attention, MLP, MoE and sLSTM blocks run as their modules
say, and the mLSTM, RG-LRU and local-attention blocks run whole on the
rank's rows with their weights gathered.  Each rank returns its rows'
logits with the vocabulary whole; every model rank of a data shard
returns the same bits.

Training on a mesh differentiates through the collectives
(``launch.collectives``: over the batch axes shard_map's unreplicated
transposes, each rank backpropagating ``loss / nd`` over the nd data
shards, the shards' parts of a gradient summed; over ``model`` Megatron's
rule, every model rank holding the whole cotangent of what the model
ranks hold alike, the split products' backward formed whole).
:func:`loss_fn` sums each group's Σ ce·m and Σ m by the rows' GLOBAL
index over the batch axes, so every rank returns the global loss and
metrics (``train.train_step`` sums each block's gradient over the batch
axes its spec leaves replicated).  :func:`forward_train` orders the
collectives of its backward (``collectives.sequence``) and, with
``ctx.remat`` ``full`` or ``dots``, recomputes each layer's block in the
backward (``torch.utils.checkpoint``, non-reentrant, early stop off so
that a recompute issues all of the block's collectives on every rank),
meshless too, as the reference does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Optional

import torch
from torch import nn

from ..launch import collectives as C
from ..launch.mesh import Mesh
from . import attention as A
from . import layers as L
from . import mla as MLA
from . import moe as M
from . import rglru as G
from . import taps
from . import xlstm as X
from .registry import ModelConfig

__all__ = [
    "Block",
    "ModelContext",
    "Transformer",
    "aux_layers",
    "cast_params",
    "decode_step",
    "forward_train",
    "group_losses",
    "init_cache",
    "init_params",
    "loss_fn",
    "model_from_state_dict",
    "param_count",
    "prefill",
]

_REMAT = ("none", "full", "dots")
_CACHE_LAYOUTS = ("feature", "seq")
_BLOCKS = ("attn_mlp", "attn_moe", "lattn_mlp", "mlstm", "slstm", "rglru_mlp")  # every block type of the reference
_MLA = ("mla_mlp", "mla_moe")  # the port's own: latent attention
_MOE = ("attn_moe", "mla_moe")


@dataclasses.dataclass(frozen=True)
class ModelContext:
    """Execution context: the mesh and implementation switches, the
    reference's fields.  ``attn_impl`` is ``auto`` (the kernel on the
    card, the plain version on the CPU; a local-attention layer's window
    takes the chunked attention on both), ``cuda``, ``torch_ref`` or
    ``torch_chunked`` (``cuda`` and ``torch_ref`` refuse a window).
    ``remat`` is ``none``, ``full`` (each layer's block recomputed in the
    backward) or ``dots`` (the same, keeping the outputs of the
    unbatched matmuls: the reference's ``dots_with_no_batch_dims_saveable``).
    ``mesh`` is a :class:`~repro_torch.launch.mesh.Mesh` or ``None``;
    ``batch_axes``, ``model_axis`` and ``fsdp_axis`` name its axes
    (``launch.sharding.make_context`` fills them).  ``moe_routing`` is
    ``pjit`` or ``local`` (``models.moe``).  ``collective_dtype`` is
    declared as the reference declares it, and read nowhere, as there.
    ``cache_layout`` is the decode cache's layout under a mesh, the
    layouts of the reference's ``cache_shardings``: ``feature`` (an
    attention layer's cache holds the rank's KV heads of its rows) or
    ``seq`` (all KV heads of the rank's contiguous block of the cache
    slots, the softmax's statistics combined over the model axis:
    ``models.attention``).  The reference names it by the shardings it
    passes to ``jax.jit``; the port's collectives are explicit, so the
    context names it."""

    attn_impl: str = "auto"
    mesh: Any = None
    batch_axes: tuple = ()
    model_axis: Optional[str] = None
    fsdp_axis: Optional[str] = None
    moe_routing: str = "pjit"  # pjit | local
    collective_dtype: str = "default"
    remat: str = "none"  # none | full | dots
    cache_layout: str = "feature"  # feature | seq

    def __post_init__(self):
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise TypeError(f"ModelContext: mesh must be a launch.mesh.Mesh, got {type(self.mesh).__name__}")
        if self.remat not in _REMAT:
            raise ValueError(f"ModelContext: remat {self.remat!r}, expected one of {_REMAT}")
        if self.cache_layout not in _CACHE_LAYOUTS:
            raise ValueError(f"ModelContext: cache_layout {self.cache_layout!r}, expected one of {_CACHE_LAYOUTS}")

    @property
    def batch_spec(self):
        if not self.batch_axes:
            return None
        return tuple(self.batch_axes) if len(self.batch_axes) > 1 else self.batch_axes[0]

    def local(self) -> "ModelContext":
        """The meshless context with the same switches (a block that runs
        whole on the rank's rows)."""
        return ModelContext(attn_impl=self.attn_impl, moe_routing=self.moe_routing, remat=self.remat,
                            cache_layout=self.cache_layout)

    def seq_split(self) -> Optional[tuple]:
        """(m, r): the model axis's size and this rank's coordinate on it,
        when the decode cache splits its slots over that axis
        (``cache_layout="seq"`` on a model axis of size > 1), else None."""
        if self.cache_layout != "seq" or self.mesh is None or self.model_axis is None:
            return None
        m = self.mesh.shape.get(self.model_axis, 1)
        return (m, self.mesh.coord(self.model_axis)) if m > 1 else None


def _check_supported(cfg: ModelConfig, *, serve: bool = False) -> None:
    """Every block type known; with ``serve`` (prefill, the decode cache
    and decode), none of latent attention, which has no decode path yet."""
    for bt in cfg.block_types:
        if bt not in _BLOCKS + _MLA:
            raise ValueError(f"{cfg.name}: unknown block type {bt!r}")
        if serve and bt in _MLA:
            raise ValueError(f"{cfg.name}: {bt} blocks (latent attention, MLA) train but do not serve yet: "
                             "prefill, the decode cache and decode_step have no MLA path")


def aux_layers(cfg: ModelConfig) -> int:
    """What the layers' summed balance loss times ``router_aux_weight`` is
    divided by in the loss: the layer count (the Switch loss's weight
    spread over the layers), or 1 under ``balance="seq"`` (DeepSeek-V2's α
    a layer)."""
    return 1 if cfg.moe is not None and cfg.moe.balance == "seq" else max(1, cfg.n_layers)


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ------------------------------------------------------------------ params


class Block(nn.Module):
    """One layer: pre-norm GQA attention, global or over ``cfg.window``
    (``lattn_mlp``), or latent attention (``mla_*``, :func:`.mla.mla_init`),
    then a pre-norm MLP (``attn_mlp``, ``lattn_mlp``, ``mla_mlp``) or
    routed experts (``attn_moe``, ``mla_moe``, parameters ``moe``)."""

    def __init__(self, cfg: ModelConfig, block_type: str, *, dtype, device, generator, f32_read_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        rd = f32_read_dtype or dtype
        self.block_type = block_type
        self.attn_norm = L.rmsnorm_init(cfg.d_model, dtype=rd, device=device)
        init = MLA.mla_init if block_type in _MLA else A.attn_init
        self.attn = init(cfg, f32_read_dtype=rd, **kw)
        self.mlp_norm = L.rmsnorm_init(cfg.d_model, dtype=rd, device=device)
        if block_type in _MOE:
            self.moe = M.MoE(cfg, f32_read_dtype=rd, **kw)
        else:
            self.mlp = L.mlp_init(cfg.d_model, cfg.d_ff, gated=cfg.mlp_act != "gelu", **kw)


def _block(cfg: ModelConfig, block_type: str, **kw) -> nn.Module:
    if block_type == "mlstm":
        return X.MLSTMBlock(cfg, **kw)
    if block_type == "slstm":
        return X.SLSTMBlock(cfg, **kw)
    if block_type == "rglru_mlp":
        return G.RGLRUBlock(cfg, **kw)
    return Block(cfg, block_type, **kw)


class Transformer(nn.Module):
    """The model.  Its embedding and matmul weights are drawn in
    ``matmul_dtype`` (``param_dtype`` by default), the parameters the
    forward reads in f32 (:data:`_READ_IN_F32`) in ``param_dtype``.  A
    codebook model's embedding is (K, V, d) and its head (d, V·K)."""

    def __init__(self, cfg: ModelConfig, *, device, generator, matmul_dtype=None, keep=None):
        super().__init__()
        _check_supported(cfg)
        keep = keep or (lambda prefix, module: None)
        rd = getattr(torch, cfg.param_dtype)
        dtype = matmul_dtype or rd
        d, V, K = cfg.d_model, cfg.vocab, cfg.num_codebooks
        shape = (K, V, d) if K > 0 else (V, d)
        embed = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        self.embed = L._param(embed.mul_(0.02))
        keep("", self)  # ``keep(prefix, module)`` may narrow what was drawn before the next draw
        blocks = []
        for i, bt in enumerate(cfg.block_types):
            blocks.append(_block(cfg, bt, dtype=dtype, device=device, generator=generator, f32_read_dtype=rd))
            keep(f"blocks.{i}.", blocks[-1])
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = L.rmsnorm_init(d, dtype=rd, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = L.dense_init(d, V * max(K, 1), dtype=dtype, device=device, generator=generator,
                                        scale=0.02)
        keep("", self)


def init_params(cfg: ModelConfig, *, generator: torch.Generator, matmul_dtype=None) -> Transformer:
    """Random weights drawn from ``generator`` directly on its device (the
    reference's initialisation laws, not its random stream): the embedding
    and the matmul weights in ``matmul_dtype`` (``cfg.param_dtype`` by
    default), the parameters the forward reads in f32 in
    ``cfg.param_dtype``.  Each is drawn in its own dtype, so no copy of the
    tree in another dtype is ever held."""
    return Transformer(cfg, device=generator.device, generator=generator, matmul_dtype=matmul_dtype)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def model_from_state_dict(cfg: ModelConfig, state_dict) -> Transformer:
    """A model that holds the given tensors themselves (device and dtype
    as they are; nothing is drawn or copied)."""
    model = Transformer(cfg, device="meta", generator=None)
    model.load_state_dict(state_dict, assign=True)
    return model


# Parameters the forward reads in f32 whatever the compute dtype (the
# suffixes of their names).
_READ_IN_F32 = ("norm", "moe.router", ".r_z", ".r_i", ".r_f", ".r_o", ".lam")


def cast_params(model: Transformer, cfg: ModelConfig) -> Transformer:
    """A model whose embedding and matmul weights are held in
    ``compute_dtype``: the values every per-call cast would give, made once.
    The norm scales, the MoE routers, the sLSTM's recurrent matrices
    ``r_{z,i,f,o}`` and the RG-LRU's ``lam``, which the forward reads in
    f32, are shared as they are (a rounded router would move routing
    decisions, a rounded recurrence would round every step of the cell).
    It serves a tree held in f32, such as one carried from the reference;
    the serving launcher draws its weights in their dtypes
    (``init_params(matmul_dtype=...)``) and never calls it."""
    cd = _compute_dtype(cfg)
    sd = {
        name: t if name.endswith(_READ_IN_F32) else t.to(cd)
        for name, t in model.state_dict().items()
    }
    return model_from_state_dict(cfg, sd)


# ------------------------------------------------------------------ blocks


def _ffn(p: Block, xn2, cfg: ModelConfig, ctx: ModelContext, rows_valid=None):
    """The block's feed-forward on the normed residual.  Returns (out in
    xn2's dtype, MoE aux loss or None)."""
    if p.block_type in _MOE:
        return M.moe_apply(p.moe, xn2, cfg, ctx, rows_valid)
    out = L.mlp_apply(p.mlp, xn2, act=cfg.mlp_act, compute_dtype=_compute_dtype(cfg), ctx=ctx)
    return out.to(xn2.dtype), None


def _window(p, cfg: ModelConfig):
    """The attention window of a layer: ``cfg.window`` for local attention,
    read at every call as the reference does."""
    return cfg.window if p.block_type == "lattn_mlp" else None


# Blocks that run whole on a rank's rows under a mesh, their weights gathered.
_GATHERED = ("mlstm", "rglru_mlp", "lattn_mlp")


def _on_rank(p, ctx: ModelContext):
    """(the block, the context) it runs with: a block of :data:`_GATHERED`
    under a mesh runs meshless with its weights gathered."""
    if ctx.mesh is not None and p.block_type in _GATHERED:
        return L.gathered(p, ctx), ctx.local()
    return p, ctx


def _block_apply(p, x, cfg: ModelConfig, ctx: ModelContext, positions, rows_valid=None):
    """Training/prefill forward of one block.  Returns (x, aux or None,
    cache: K/V for attention, ``{}`` for a recurrent block).
    ``rows_valid`` (B,) marks the real rows for an MoE layer
    (``models.moe.moe_apply``)."""
    p, ctx = _on_rank(p, ctx)
    if p.block_type == "mlstm":
        return X.mlstm_apply(p, x, cfg), None, {}
    if p.block_type == "slstm":
        return X.slstm_apply(p, x, cfg, ctx=ctx), None, {}
    if p.block_type == "rglru_mlp":
        return G.rglru_apply(p, x, cfg), None, {}
    xn = L.rmsnorm(x, p.attn_norm, eps=cfg.rms_eps)
    if p.block_type in _MLA:
        if ctx.mesh is not None:
            raise ValueError(f"{cfg.name}: {p.block_type} blocks (latent attention) have no mesh path yet")
        x = x + MLA.mla_apply(p.attn, xn, cfg, positions=positions, impl=ctx.attn_impl)
        f, aux = _ffn(p, L.rmsnorm(x, p.mlp_norm, eps=cfg.rms_eps), cfg, ctx, rows_valid)
        return x + f, aux, {}
    window = _window(p, cfg)
    a, (k, v) = A.attn_apply(p.attn, xn, cfg, positions=positions, window=window, impl=ctx.attn_impl, ctx=ctx)
    x = x + a
    f, aux = _ffn(p, L.rmsnorm(x, p.mlp_norm, eps=cfg.rms_eps), cfg, ctx, rows_valid)
    if window is not None:
        # The reference keeps the last min(window, T) positions: position
        # T − W + i lands in slot i, where decode's ring puts it only when
        # T % W == 0 (ROADMAP queue 3; no path decodes on from a prefill).
        keep = min(window, k.shape[1])
        k, v = k[:, -keep:], v[:, -keep:]
    return x + f, aux, {"k": k, "v": v}


def _block_decode(p, x_t, cache, cur_len: int, cfg: ModelConfig, ctx: ModelContext):
    """One-token decode of one block.  Returns (x_t, cache).  A local
    attention block runs meshless on the rank's rows (:func:`_on_rank`),
    but under ``cache_layout="seq"`` its ring holds the rank's slots, so its
    attention keeps the mesh to combine the softmax over the model axis
    (its weights gathered, it runs all heads)."""
    p, rctx = _on_rank(p, ctx)
    if p.block_type == "mlstm":
        return X.mlstm_decode_step(p, cache, x_t, cfg)
    if p.block_type == "slstm":
        return X.slstm_decode_step(L.gathered(p, rctx), cache, x_t, cfg)
    if p.block_type == "rglru_mlp":
        return G.rglru_decode_step(p, cache, x_t, cfg)
    xn = L.rmsnorm(x_t, p.attn_norm, eps=cfg.rms_eps)
    a, ck, cv = A.attn_decode_step(p.attn, xn, cache["k"], cache["v"], cur_len, cfg, window=_window(p, cfg),
                                   ctx=ctx if ctx.seq_split() else rctx)
    x_t = x_t + a
    f, _ = _ffn(p, L.rmsnorm(x_t, p.mlp_norm, eps=cfg.rms_eps), cfg, rctx)
    taps.tap("ffn", f)
    return x_t + f, {"k": ck, "v": cv}


# ------------------------------------------------------------------ embed


def _token_embed(model: Transformer, tokens, cfg: ModelConfig, ctx: Optional[ModelContext] = None):
    """tokens (B, T), or (B, K, T) for a codebook model → (B, T, d) in
    compute dtype.  The K codebooks' embeddings are summed in the order
    of the reference's ``sum`` (0 + e_0 + e_1 + …), in param dtype.  Under
    a mesh that splits the vocabulary, each model rank looks up the ids in
    its range (zero rows elsewhere) and one sum over the model axis, exact,
    joins the lookups before the codebooks are summed."""
    vdim = model.embed.dim() - 2
    lo, hi, split = L.tp_part(model.embed, vdim, ctx)
    table = L.weight(model.embed, ctx, vdim, lo, hi)
    ids = (tokens - lo).clamp(0, hi - lo - 1) if split else tokens
    if cfg.num_codebooks > 0:
        parts = [table[kb][ids[:, kb]] for kb in range(cfg.num_codebooks)]
    else:
        parts = [table[ids]]
    if split:
        inside = (tokens >= lo) & (tokens < hi)
        if cfg.num_codebooks > 0:
            inside = inside.transpose(0, 1)  # (K, B, T)
        stacked = torch.stack(parts) * inside.reshape(len(parts), *parts[0].shape[:-1], 1).to(table.dtype)
        parts = list(C.psum(stacked, ctx.mesh, ctx.model_axis).unbind(0))
    x = parts[0]
    for e in parts[1:]:
        x = x + e
    return x.to(_compute_dtype(cfg))


def _embed(model: Transformer, batch, cfg: ModelConfig, ctx: Optional[ModelContext] = None):
    """Token (and prefix) embedding.  Returns (x (B, P + T, d) in compute
    dtype, label_mask (B, P + T) f32, zero over the P prefix positions)."""
    tokens = batch["tokens"]
    x = _token_embed(model, tokens, cfg, ctx)
    mask = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
    if cfg.num_prefix_tokens > 0 and "prefix_embeds" in batch:
        pre = batch["prefix_embeds"].to(x.dtype)  # (B, P, d)
        x = torch.cat([pre, x], dim=1)
        mask = torch.cat([torch.zeros(pre.shape[:2], dtype=torch.float32, device=x.device), mask], dim=1)
    return x, mask


def _logits(model: Transformer, x, cfg: ModelConfig, ctx: Optional[ModelContext] = None):
    """(B, T, V) logits, or (B, T, K, V) for a codebook model.  Under a
    mesh that splits the head's vocabulary, each model rank computes its
    columns and the logits are gathered over the model axis."""
    cd = _compute_dtype(cfg)
    x = L.rmsnorm(x, model.final_norm, eps=cfg.rms_eps)
    if cfg.tie_embeddings:
        lo, hi, split = L.tp_part(model.embed, 0, ctx)
        head = L.weight(model.embed, ctx, 0, lo, hi).T
    else:
        lo, hi, split = L.tp_part(model.lm_head, 1, ctx)
        head = L.weight(model.lm_head, ctx, 1, lo, hi)
    if split:
        logits = C.split_linear(x.to(cd), head.to(cd), ctx.mesh, ctx.model_axis, gather_out=True)
    else:
        logits = x.to(cd) @ head.to(cd)
    if cfg.num_codebooks > 0:
        return logits.reshape(*x.shape[:2], cfg.num_codebooks, cfg.vocab)
    return logits


# ------------------------------------------------------------------ train


def _saved_by_dots(ctx, op, *args, **kwargs):
    """``dots``: keep the outputs of the unbatched matmuls, recompute the
    rest (the batched attention products and the flash Function too)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_apply(blk, x, cfg: ModelConfig, ctx: ModelContext, positions, rows_valid=None):
    """One block under ``ctx.remat``: (x, aux or None).  The block's output
    is multiplied by a ones tensor made inside it, so the first node of
    the block that the backward reaches unpacks a saved tensor: every rank
    recomputes the block before any of its backward collectives runs."""
    from torch.utils import checkpoint as ckpt

    def run(x):
        y, a, _ = _block_apply(blk, x, cfg, ctx, positions, rows_valid)
        return y * torch.ones((), dtype=y.dtype, device=y.device), a

    kw = {}
    if ctx.remat == "dots":
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts, _saved_by_dots)
    with ckpt.set_checkpoint_early_stop(False):
        return ckpt.checkpoint(run, x, use_reentrant=False, **kw)


def forward_train(model: Transformer, batch, cfg: ModelConfig, ctx: ModelContext):
    """Full forward, differentiable.  ``batch``: ``tokens`` (B, T), or
    (B, K, T) for a codebook model, and for a prefix model optionally
    ``prefix_embeds`` (B, P, d), and ``rows_valid`` (B,) (1 a real row,
    0 a padding slot's, for an MoE layer: ``models.moe``).  Returns
    (logits (B, P + T, V) or (B, T, K, V), aux (the layers' MoE aux losses summed, f32; 0 without
    MoE), label_mask (B, P + T)).  Under a mesh, the rank's rows; with
    grad mode on, the collectives' backward is ordered and the last token
    of the order is folded into aux with weight 0."""
    grad = torch.is_grad_enabled()
    ordered = C.sequence(model.embed.device) if grad and ctx.mesh is not None else contextlib.nullcontext(False)
    with ordered as opened:
        x, mask = _embed(model, batch, cfg, ctx)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        rows_valid = batch.get("rows_valid")
        for blk in model.blocks:
            if grad and ctx.remat != "none":
                x, a = _remat_apply(blk, x, cfg, ctx, positions, rows_valid)
            else:
                x, a, _ = _block_apply(blk, x, cfg, ctx, positions, rows_valid)
            if a is not None:
                aux = aux + a
        logits = _logits(model, x, cfg, ctx)
        if opened:
            aux = aux + 0.0 * C.sequence_token()
    return logits, aux, mask


def _label_ce(model: Transformer, batch, cfg: ModelConfig, ctx: ModelContext):
    """forward_train and each label's cross entropy: (ce (B, T'), label
    mask (B, T'), aux).  A codebook model's CE is the mean over its K
    codebooks; a prefix model's labels start after the prefix."""
    logits, aux, mask = forward_train(model, batch, cfg, ctx)
    tokens = batch["tokens"]
    if cfg.num_codebooks > 0:
        targets = tokens[:, :, 1:].transpose(1, 2)  # (B, T−1, K)
        lg = logits[:, :-1].float()  # (B, T−1, K, V)
        lse = torch.logsumexp(lg, dim=-1)
        tgt = torch.gather(lg, -1, targets[..., None].long())[..., 0]
        return (lse - tgt).mean(-1), mask[:, 1:], aux  # the mean over codebooks
    prefix = logits.shape[1] - tokens.shape[1]
    lg = logits[:, prefix:][:, :-1].float()
    lg = lg - torch.logsumexp(lg, dim=-1, keepdim=True)
    ce = -torch.gather(lg, -1, tokens[:, 1:][..., None].long())[..., 0]
    return ce, mask[:, prefix:][:, 1:], aux


def _group_sums(ce, m, groups: int, ctx: ModelContext):
    """Each group's Σ ce·m and Σ m (groups,) over the GLOBAL batch, whose
    rows split group-major into ``groups`` equal groups.  Meshless, or with
    one data shard, the reshape of the reference; otherwise each local
    row's sums go to the group of its global index (the data shard's
    rows, row-major over the batch axes, as ``launch.sharding.local_rows``
    slices them) and the partial sums are summed over the batch axes."""
    nd, shard = M._data_shard(ctx.mesh, ctx.batch_axes) if ctx.mesh is not None else (1, 0)
    if nd == 1:
        ce_g, m_g = ce.reshape(groups, -1), m.reshape(groups, -1)
        return torch.sum(ce_g * m_g, dim=1), torch.sum(m_g, dim=1)
    rows = ce.shape[0]
    if (rows * nd) % groups:
        raise ValueError(f"loss_fn: a global batch of {rows} x {nd} rows does not split into {groups} groups")
    per = rows * nd // groups
    grp = torch.div(shard * rows + torch.arange(rows, device=ce.device), per, rounding_mode="floor")
    part = torch.zeros((2, groups), dtype=ce.dtype, device=ce.device)
    part = part.index_add(1, grp, torch.stack([torch.sum(ce * m, dim=1), torch.sum(m, dim=1)]))
    s, c = C.psum(part, ctx.mesh, ctx.batch_axes).unbind(0)
    return s, c


def loss_fn(model: Transformer, batch, cfg: ModelConfig, ctx: ModelContext):
    """Group-weighted causal-LM cross entropy, as the reference's.

    ``batch["group_weights"]`` (G,) carries the paper's recovery weights
    b_g (zero at straggling groups); the global batch's leading dim must be
    divisible by G, and the loss is Σ_g b_g·L_g / max(Σ_g b_g, 1e-6) over
    the per-group masked means L_g.  Without the key, plain uniform
    weighting.  A codebook model's CE is the mean over its K codebooks; a
    prefix model's labels start after the prefix.  The MoE aux term
    ``router_aux_weight · aux / aux_layers(cfg)`` is added.  Returns (total,
    metrics {"ce", "aux", "tokens"}).  Under a mesh ``batch`` holds the
    rank's rows and the loss and metrics are the global batch's, the same
    on every rank (:func:`_group_sums`)."""
    ce, m, aux = _label_ce(model, batch, cfg, ctx)
    gw = batch.get("group_weights")
    if gw is None:
        if ctx.mesh is None:
            s, c = torch.sum(ce * m), torch.sum(m)
        else:
            s, c = _group_sums(ce, m, 1, ctx)
            s, c = s[0], c[0]
        loss = s / torch.clamp_min(c, 1.0)
        tokens = c
    else:
        s, c = _group_sums(ce, m, gw.shape[0], ctx)
        per_group = s / torch.clamp_min(c, 1.0)
        loss = torch.sum(gw * per_group) / torch.clamp_min(torch.sum(gw), 1e-6)
        tokens = torch.sum(m) if ctx.mesh is None else torch.sum(c)
    aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    total = loss + aux_w * aux / aux_layers(cfg)
    return total, {"ce": loss, "aux": aux, "tokens": tokens}


def group_losses(model: Transformer, batch, cfg: ModelConfig, ctx: ModelContext, groups: int):
    """One forward of the batch split group-major into ``groups`` equal
    groups of rows: (each group's masked mean CE (groups,), each group's
    label count (groups,), aux over the whole batch).  ``loss_fn`` is
    their ``group_weights``-weighted mean.  Under a mesh, the groups of the
    global batch (:func:`_group_sums`)."""
    ce, m, aux = _label_ce(model, batch, cfg, ctx)
    s, tok = _group_sums(ce, m, groups, ctx)
    return s / torch.clamp_min(tok, 1.0), tok, aux


# ------------------------------------------------------------------ serve


def _block_cache_init(bt: str, cfg: ModelConfig, B: int, max_len: int, device, kv_heads=None,
                      seq_split=None) -> dict:
    if bt == "mlstm":
        return X.mlstm_init_state(cfg, B, device=device)
    if bt == "slstm":
        return X.slstm_init_state(cfg, B, device=device)
    cd = _compute_dtype(cfg)
    if bt == "rglru_mlp":
        return G.rglru_init_state(cfg, B, device=device, dtype=cd)
    S = min(cfg.window or max_len, max_len) if bt == "lattn_mlp" else max_len
    if seq_split is not None:  # all KV heads of the rank's block of the slots
        m = seq_split[0]
        if S % m:
            raise ValueError(f"init_cache: cache_layout 'seq' splits the {S} slots of a {bt} layer over a "
                             f"model axis of {m} ranks, which does not divide them")
        S, kv_heads = S // m, cfg.n_kv_heads
    shape = (B, S, kv_heads or cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cd, device=device), "v": torch.zeros(shape, dtype=cd, device=device)}


def _kv_heads(blk, cfg: ModelConfig, ctx: ModelContext) -> int:
    """The KV heads a rank's decode cache holds for an attention layer."""
    _, (k0, k1), pick, _ = A.local_heads(blk.attn, cfg, ctx)
    return len(pick) if pick is not None else k1 - k0


def init_cache(cfg: ModelConfig, B: int, max_len: int, *, device, model=None,
               ctx: Optional[ModelContext] = None) -> list[dict]:
    """One cache per layer (the reference stacks them along a leading
    ``reps`` axis): a {"k", "v"} pair of zeros (B, S, KV, dh) in compute
    dtype for an attention layer, S = max_len, or min(window, max_len) for
    a local one; the zero recurrent state in f32 for an xLSTM one (mLSTM
    ``{C, n, m, conv}``, sLSTM ``{h, c, n, m}``), and for an RG-LRU one
    ``{h}`` in f32 and ``{conv}`` in compute dtype.  Under a mesh, B is
    the rank's rows and a tensor-parallel attention layer holds the rank's
    KV heads (read from ``model``'s blocks); under ``ctx.cache_layout ==
    "seq"`` on a model axis of m > 1 ranks every attention layer, global
    or local, holds all KV heads of model rank r's slots [r·S/m,
    (r + 1)·S/m) instead, and an S that m does not divide raises."""
    _check_supported(cfg, serve=True)
    mesh = ctx is not None and ctx.mesh is not None
    if mesh and model is None:
        raise ValueError("init_cache: under a mesh, pass the model whose blocks the cache serves")
    seq = ctx.seq_split() if mesh else None
    return [_block_cache_init(bt, cfg, B, max_len, device,
                              _kv_heads(model.blocks[i], cfg, ctx) if mesh and bt in ("attn_mlp", "attn_moe")
                              else None, seq)
            for i, bt in enumerate(cfg.block_types)]


@torch.no_grad()
def decode_step(model: Transformer, cache, tokens_t, cur_len: int, cfg: ModelConfig, ctx: ModelContext):
    """One decode step.  tokens_t: (B, 1), or (B, K, 1) for a codebook
    model; cur_len: the count of tokens already in the cache.  Writes an
    attention layer's K/V in place and replaces a recurrent layer's state;
    returns (logits_t (B, 1, V) or (B, 1, K, V), cache).  Under a mesh,
    the rank's rows and the cache of :func:`init_cache` under the mesh."""
    _check_supported(cfg, serve=True)
    x = _token_embed(model, tokens_t, cfg, ctx)
    taps.tap("embed", x)
    new_cache = []
    for blk, c in zip(model.blocks, cache):
        x, nc = _block_decode(blk, x, c, int(cur_len), cfg, ctx)
        taps.tap("block", x)
        new_cache.append(nc)
    logits = _logits(model, x, cfg, ctx)
    taps.tap("logits", logits)
    return logits, new_cache


@torch.no_grad()
def prefill(model: Transformer, batch, cfg: ModelConfig, ctx: ModelContext):
    """Prefill forward: the next-token logits (B, 1, V) and the per-layer
    cache, K/V (B, T, KV, dh) for attention (the last min(window, T)
    positions for local attention) and ``{}`` for a recurrent layer.  Only
    the last position reaches the head.  Under a mesh, the rank's rows of
    the batch, and K/V of the rank's KV heads."""
    _check_supported(cfg, serve=True)
    x, _ = _embed(model, batch, cfg, ctx)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    cache = []
    for blk in model.blocks:
        x, _, c = _block_apply(blk, x, cfg, ctx, positions)
        cache.append(c)
    return _logits(model, x[:, -1:], cfg, ctx), cache

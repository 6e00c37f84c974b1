"""The training step: loss → grad → (optional compression) → AdamW (the
twin of the reference's ``train/train_step.py``, in one process).

``group_weights`` carries the recovery vector of the step (Lemma 3 applied
to gradients) into :func:`repro_torch.models.transformer.loss_fn`.  The
parameters live in the model (an ``nn.Module``); the step takes their
gradients with ``torch.autograd.grad`` (nothing is left in ``.grad``) and
updates them and the moments in place.  The mesh-native resilient path's
pieces are :func:`make_group_grad_fn` (per-group gradients for the
executor's Lemma-3 combine) and :func:`make_recovered_apply_fn`.

Under an LM mesh (``ctx.mesh``, from ``launch.sharding.make_context``) the
model holds this rank's blocks and the batch this rank's rows
(``launch.sharding.local_rows``).  The step backpropagates ``loss /
nd`` over the nd data shards through the collectives
(``launch.collectives``: a gathered weight's gradient comes back summed
over ``data`` into its block, the FSDP reduction; the model ranks hold
whole cotangents), then sums each block's gradient over the batch axes its
spec leaves replicated (the data-parallel sum), in one ``all_reduce`` per
set of axes and dtype;
the global norm and AdamW run on the blocks.  ``accum_steps > 1`` needs
whole groups on every data shard.  Compression quantizes the summed
gradient's blocks in the global tensor's quantization blocks
(``train.compression``), its error-feedback buffers on the parameters'
blocks.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..analysis import compiled_path
from ..models import moe as M
from ..models import transformer as T
from ..models.registry import ModelConfig
from ..obs import trace_span
from .compression import CompressionConfig, compress_with_error_feedback, init_ef_state
from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state

__all__ = [
    "TrainState",
    "init_train_state",
    "make_train_step",
    "make_eval_step",
    "make_grad_fn",
    "make_group_grad_fn",
    "make_recovered_apply_fn",
    "reduce_block_grads",
]


class TrainState(NamedTuple):
    params: Any  # the model, a repro_torch.models.transformer.Transformer
    opt: OptState
    ef: Any  # error-feedback buffers (None unless compression is on)


def init_train_state(
    cfg: ModelConfig, *, generator: torch.Generator, compression: Optional[CompressionConfig] = None,
    model=None, mesh=None,
) -> TrainState:
    """A fresh state on ``generator``'s device: random weights drawn from
    it (or ``model``, e.g. weights carried from the reference), zero
    moments, zero error-feedback buffers when compression is on.  Under a
    ``mesh`` the rank's blocks: drawn by ``launch.sharding.init_sharded``
    (the meshless draw's values), or ``model`` narrowed by
    ``launch.sharding.shard_model``; the moments and the error-feedback
    buffers on the same blocks."""
    if mesh is not None:
        from ..launch.sharding import init_sharded, shard_model

        model = shard_model(model, mesh) if model is not None else init_sharded(cfg, generator=generator, mesh=mesh)
    model = model if model is not None else T.init_params(cfg, generator=generator)
    params = dict(model.named_parameters())
    ef = init_ef_state(params) if (compression and compression.enabled) else None
    return TrainState(params=model, opt=init_opt_state(params, mesh), ef=ef)


def _data_shards(ctx: T.ModelContext) -> int:
    """The number of data shards of ``ctx``'s mesh (1 without one)."""
    return M._data_shard(ctx.mesh, ctx.batch_axes)[0] if ctx.mesh is not None else 1


def _specs(params: dict) -> dict:
    return {n: getattr(p, "mesh_spec", None) for n, p in params.items()}


@torch.no_grad()
def reduce_block_grads(grads: dict, params: dict, mesh) -> dict:
    """Each block's gradient summed over the live batch axes its
    parameter's spec does not split (all of them for an untagged
    parameter; the model ranks hold the whole already,
    ``launch.collectives``): one ``all_reduce`` (kind ``grad_sum``) per
    set of axes and dtype, of the gradients concatenated flat in name
    order."""
    from ..launch import collectives as C
    from ..launch.sharding import split_axes

    if mesh is None or mesh.size == 1:
        return grads
    buckets: dict = {}
    for n, g in grads.items():
        spec = getattr(params[n], "mesh_spec", None)
        axes = tuple(a for a in C.live_axes(mesh, mesh.axis_names) if a != C.MODEL and a not in split_axes(spec))
        if axes:
            buckets.setdefault((axes, g.dtype), []).append(n)
    out = dict(grads)
    for (axes, _), names in buckets.items():
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        flat = C.psum(flat, mesh, axes, kind="grad_sum")
        for n, part in zip(names, flat.split([grads[n].numel() for n in names])):
            out[n] = part.view_as(grads[n])
    return out


def _split_microbatches(batch: dict, accum: int, num_groups: int) -> dict:
    """Group-aligned microbatch split: every tensor with a leading batch
    dim (G·per_g, …) becomes (A, G·per_g/A, …) with each microbatch holding
    an equal slice of EVERY group — so per-microbatch group-weighted losses
    average exactly to the full-batch weighted loss."""
    out = {}
    for k, v in batch.items():
        if k == "group_weights" or v.dim() == 0:
            out[k] = v
            continue
        b = v.shape[0]
        per_g = b // num_groups
        if per_g % accum:
            raise ValueError(f"_split_microbatches: {k} {tuple(v.shape)} has {per_g} rows a group, "
                             f"not divisible by accum_steps={accum}")
        chunk = per_g // accum
        resh = v.reshape((num_groups, accum, chunk) + tuple(v.shape[1:])).movedim(1, 0)  # (A, G, chunk, …)
        out[k] = resh.reshape((accum, num_groups * chunk) + tuple(v.shape[1:]))
    return out


def make_grad_fn(cfg: ModelConfig, ctx: T.ModelContext):
    """Returns grad_of(model, batch) -> (loss, metrics, grads): the loss
    and metrics detached, and each parameter's gradient by name (zeros
    where it has none).  Under ``ctx.mesh`` the rank backpropagates
    ``loss / nd`` over the nd data shards, so each block's gradient is the
    rank's share: :func:`reduce_block_grads` sums the shares."""
    nd = _data_shards(ctx)

    def grad_of(model, batch):
        names, params = zip(*model.named_parameters())
        loss, metrics = T.loss_fn(model, batch, cfg, ctx)
        share = loss if nd == 1 else loss * (1.0 / nd)
        grads = torch.autograd.grad(share, params, allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, params, grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    return grad_of


@compiled_path("train.train_step", kind="factory")
def make_train_step(
    cfg: ModelConfig,
    ctx: T.ModelContext,
    opt_cfg: AdamWConfig,
    *,
    compression: Optional[CompressionConfig] = None,
    accum_steps: int = 1,
    num_groups: Optional[int] = None,
):
    """Returns train_step(state, batch) -> (state, metrics).

    ``accum_steps > 1`` runs gradient-accumulation microbatching over A
    group-aligned microbatches: the gradients summed in f32, then divided
    by A, the loss and ce the means of the microbatches' (aux and tokens
    read 0, as in the reference).  The metrics are 0-dim tensors, but
    ``lr``, a float.  Under ``ctx.mesh`` the batch is the rank's rows and
    the state the rank's blocks (module docstring); the metrics are the
    global ones, the same on every rank.

    The step's two halves are ``train_step.grads(state, batch) -> (loss,
    metrics, grads)``, the gradients it applies (accumulated, each block
    reduced over the axes that replicate it), and ``train_step.apply(state,
    loss, metrics, grads) -> (state, metrics)``; ``train_step(state,
    batch)`` is the one after the other."""
    mesh = ctx.mesh
    grad_of = make_grad_fn(cfg, ctx)

    def step_grads(state: TrainState, batch):
        if accum_steps == 1:
            loss, metrics, grads = grad_of(state.params, batch)
        else:
            gw = batch.get("group_weights")
            G = num_groups or (gw.shape[0] if gw is not None else 1)
            nd = _data_shards(ctx)
            if G % nd:
                raise ValueError(f"make_train_step: accum_steps={accum_steps} needs whole groups on every data "
                                 f"shard; {G} groups over the {nd} data shards of the mesh {dict(mesh.shape)} "
                                 f"split a group")
            micro = _split_microbatches(batch, accum_steps, G // nd)
            gsum, losses, ces = None, [], []
            for a in range(accum_steps):
                mb = {k: v[a] for k, v in micro.items() if k != "group_weights"}
                if gw is not None:
                    mb["group_weights"] = gw
                loss, metrics, g = grad_of(state.params, mb)
                if gsum is None:
                    gsum = {n: t.float() for n, t in g.items()}
                else:
                    for n, t in g.items():
                        gsum[n] += t.float()
                del g
                losses.append(loss)
                ces.append(metrics["ce"])
            grads = {n: t / accum_steps for n, t in gsum.items()}
            loss = torch.stack(losses).mean()
            zero = torch.zeros((), device=loss.device)
            metrics = {"ce": torch.stack(ces).mean(), "aux": zero, "tokens": zero}
        return loss, metrics, reduce_block_grads(grads, dict(state.params.named_parameters()), mesh)

    def apply(state: TrainState, loss, metrics, grads):
        params = dict(state.params.named_parameters())
        specs = _specs(params)
        ef = state.ef
        if compression is not None and compression.enabled:
            grads, ef = compress_with_error_feedback(compression, grads, ef, mesh=mesh, specs=specs)
        with trace_span("optimizer.adamw", tensors=len(params)):
            _, opt, opt_metrics = adamw_update(opt_cfg, params, grads, state.opt, mesh, specs)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(params=state.params, opt=opt, ef=ef), metrics

    def train_step(state: TrainState, batch):
        return apply(state, *step_grads(state, batch))

    train_step.grads = step_grads
    train_step.apply = apply
    return train_step


def _grads(total, names, params) -> dict:
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, params, grads)}


@compiled_path("train.group_grad", kind="factory")
def make_group_grad_fn(cfg: ModelConfig, ctx: T.ModelContext):
    """Per-group statistics function for ``Executor.resilient_reduce_masked``
    — the mesh-native resilient train step (Lemma 3 on gradients).

    Returns ``fn(tokens_pool, valid, model, pool_idx, *, b=None)``,
    written batched over a block of G groups, as every node function of
    the port is, where

    * ``tokens_pool`` — ``(G, P, C·mb, T)`` integer: each group's resident
      microbatch pool (``P`` step batches, ``C`` shard slots of ``mb``
      sequences each — ``C`` may exceed a group's load to leave headroom
      for elastic patches);
    * ``valid`` — ``(G, C)`` float32: 1 for slots holding a real shard, 0
      for padding (padded slots are inert in every statistic);
    * ``model`` — the model (broadcast);
    * ``pool_idx`` — which pool entry this step consumes.

    A group's statistics are its **shard-sum** ``{"grads", "loss", "ce",
    "tok"}``: the per-shard token-normalised losses summed over the
    group's valid slots (plus, for an MoE model, the valid slot count
    times the group's aux term), the gradient of that sum (a dict by
    parameter name), and the group's label count.  Without ``b`` the
    function returns them stacked over the groups, the reference's
    meaning (a gradient per group: G copies of the model).  With ``b``
    (``(G,)``, the block's recovery weights) it returns their Lemma-3
    combine Σ_g b_g·stat_g (:func:`repro_torch.core.executor.takes_weights`):
    each group's forward and backward in turn, each gradient multiplied
    by b_g and added into one float64 buffer, so the block holds one
    gradient besides the one being formed.  The products of float32
    values are exact in float64 and their sum carries 29 bits more than
    float32, so once rounded to the parameters' dtype (by
    :func:`make_recovered_apply_fn`) the combine does not depend on the
    order of the groups, nor, summed over the ranks in float64, on the
    mesh's split.  The combined statistics are float64.  A group's forward is its own, as
    under the reference's vmap (an MoE model routes, caps its experts and
    counts its aux loss over one group's tokens).

    The executor's combine then yields  Σ_g b_g Σ_{s∈P_g} ∇L̄_s
    = Σ_s a_s ∇L̄_s  with ``a = bᵀA ∈ [1, 1+δ]ⁿ``: for δ = 0 (fractional
    repetition under any coverage-preserving pattern) this is EXACTLY
    ``n·∇(mean shard loss)`` — the full-data gradient, independent of the
    straggler pattern (to the bit, where the weights are powers of two:
    replicas of a shard hold the same rows).  :func:`make_recovered_apply_fn`
    divides by ``n``.
    """
    aux_w = cfg.moe.router_aux_weight / max(1, cfg.n_layers) if cfg.moe else 0.0

    def shard_sum(model, tokens, valid):
        """One group's forward: (its shard-sum loss, CE, label count) over
        its rows ``tokens`` (C·mb, T) and slot validity ``valid`` (C,)."""
        per_slot, tok, aux = T.group_losses(model, {"tokens": tokens.long()}, cfg, ctx, valid.shape[0])
        ce = torch.sum(valid * per_slot)
        loss = ce + torch.sum(valid) * (aux_w * aux) if aux_w else ce
        return loss, ce, torch.sum(tok)

    def group_stats(tokens_pool, valid, model, pool_idx, *, b=None):
        names, params = zip(*model.named_parameters())
        tokens = tokens_pool[:, int(pool_idx)]
        valid = valid.float()
        per, out = [], None
        for g in range(valid.shape[0]):
            with trace_span("train.forward", group=g):
                loss, ce, tok = shard_sum(model, tokens[g], valid[g])
            with trace_span("train.backward", group=g):
                grads = _grads(loss, names, params)
            if b is None:
                per.append((grads, loss.detach(), ce.detach(), tok))
                continue
            with trace_span("train.combine", group=g):
                bg = b[g].to(device=valid.device, dtype=torch.float64)
                if out is None:
                    out = {"grads": {n: torch.zeros_like(p, dtype=torch.float64) for n, p in zip(names, params)},
                           "loss": 0.0, "ce": 0.0, "tok": 0.0}
                for n in names:
                    out["grads"][n].addcmul_(grads[n], bg)
                del grads
                for key, v in (("loss", loss), ("ce", ce), ("tok", tok)):
                    out[key] = out[key] + bg * v.detach().double()
        if b is not None:
            return out
        return {"grads": {n: torch.stack([st[0][n] for st in per]) for n in names},
                **{key: torch.stack([st[i] for st in per]) for i, key in enumerate(("loss", "ce", "tok"), 1)}}

    group_stats.takes_weights = True
    return group_stats


@compiled_path("train.recovered_apply", kind="factory")
def make_recovered_apply_fn(
    opt_cfg: AdamWConfig,
    num_shards: int,
    *,
    compression: Optional[CompressionConfig] = None,
):
    """Returns ``apply(state, stats) -> (state, metrics)``.

    ``stats`` is the Lemma-3-combined output of :func:`make_group_grad_fn`
    (shard-sum gradients/losses weighted by the recovery vector); dividing by
    the TOTAL shard count ``n`` — a pattern-independent constant — recovers
    the mean-loss gradient, so straggler and no-straggler steps apply
    numerically identical updates whenever the recovery band is exact.
    The parameters and moments are updated in place, as
    :func:`make_train_step`'s are; the gradients are scaled in their own
    dtype (float64 from the combine) and rounded to the parameters'.  The
    metrics are 0-dim float32 tensors, but ``lr``, a float.
    """
    scale = 1.0 / float(num_shards)

    def apply(state: TrainState, stats):
        params = dict(state.params.named_parameters())
        with trace_span("train.combine"):
            grads = {n: (g * scale).to(params[n].dtype) for n, g in stats["grads"].items()}
        ef = state.ef
        if compression is not None and compression.enabled:
            grads, ef = compress_with_error_feedback(compression, grads, ef)
        with trace_span("optimizer.adamw", tensors=len(params)):
            _, opt, opt_metrics = adamw_update(opt_cfg, params, grads, state.opt)
        metrics = {"loss": (stats["loss"] * scale).float(), "ce": (stats["ce"] * scale).float(),
                   "tokens": stats["tok"].float()}
        metrics.update(opt_metrics)
        return TrainState(params=state.params, opt=opt, ef=ef), metrics

    return apply


@compiled_path("train.eval_step", kind="factory")
def make_eval_step(cfg: ModelConfig, ctx: T.ModelContext):
    @torch.no_grad()
    def eval_step(model, batch):
        loss, metrics = T.loss_fn(model, batch, cfg, ctx)
        return {"loss": loss, **metrics}

    return eval_step

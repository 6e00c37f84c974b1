"""The training step: loss → grad → (optional compression) → AdamW (the
twin of the reference's ``train/train_step.py``, in one process).

``group_weights`` carries the recovery vector of the step (Lemma 3 applied
to gradients) into :func:`repro_torch.models.transformer.loss_fn`.  The
parameters live in the model (an ``nn.Module``); the step takes their
gradients with ``torch.autograd.grad`` (nothing is left in ``.grad``) and
updates them and the moments in place.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..models import transformer as T
from ..models.registry import ModelConfig
from .compression import CompressionConfig, compress_with_error_feedback, init_ef_state
from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state

__all__ = [
    "TrainState",
    "init_train_state",
    "make_train_step",
    "make_eval_step",
    "make_group_grad_fn",
    "make_recovered_apply_fn",
]


class TrainState(NamedTuple):
    params: Any  # the model, a repro_torch.models.transformer.Transformer
    opt: OptState
    ef: Any  # error-feedback buffers (None unless compression is on)


def init_train_state(
    cfg: ModelConfig, *, generator: torch.Generator, compression: Optional[CompressionConfig] = None,
    model=None,
) -> TrainState:
    """A fresh state on ``generator``'s device: random weights drawn from
    it (or ``model``, e.g. weights carried from the reference), zero
    moments, zero error-feedback buffers when compression is on."""
    model = model if model is not None else T.init_params(cfg, generator=generator)
    params = dict(model.named_parameters())
    ef = init_ef_state(params) if (compression and compression.enabled) else None
    return TrainState(params=model, opt=init_opt_state(params), ef=ef)


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
    ``lr``, a float."""

    def grad_of(model, batch):
        names, params = zip(*model.named_parameters())
        loss, metrics = T.loss_fn(model, batch, cfg, ctx)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, params, grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state: TrainState, batch):
        if accum_steps == 1:
            loss, metrics, grads = grad_of(state.params, batch)
        else:
            gw = batch.get("group_weights")
            G = num_groups or (gw.shape[0] if gw is not None else 1)
            micro = _split_microbatches(batch, accum_steps, G)
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
        ef = state.ef
        if compression is not None and compression.enabled:
            grads, ef = compress_with_error_feedback(compression, grads, ef)
        _, opt, opt_metrics = adamw_update(opt_cfg, dict(state.params.named_parameters()), grads, state.opt)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(params=state.params, opt=opt, ef=ef), metrics

    return train_step


def make_group_grad_fn(cfg: ModelConfig, ctx: T.ModelContext):
    """The per-group statistics of the mesh-native resilient step: not
    ported yet."""
    raise NotImplementedError(
        "make_group_grad_fn (the device_recovery path) is not ported yet: ROADMAP queue 1, item 13.5b")


def make_recovered_apply_fn(opt_cfg: AdamWConfig, num_shards: int, *, compression=None):
    """The apply step of the mesh-native resilient path: not ported yet."""
    raise NotImplementedError(
        "make_recovered_apply_fn (the device_recovery path) is not ported yet: ROADMAP queue 1, item 13.5b")


def make_eval_step(cfg: ModelConfig, ctx: T.ModelContext):
    @torch.no_grad()
    def eval_step(model, batch):
        loss, metrics = T.loss_fn(model, batch, cfg, ctx)
        return {"loss": loss, **metrics}

    return eval_step

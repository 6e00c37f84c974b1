"""AdamW + schedules written out (the twin of the reference's
``train/optimizer.py``; not ``torch.optim.AdamW``, whose order of
operations differs).

The parameters, their gradients and the moments are dicts of tensors keyed
by the model's parameter names.  :func:`adamw_update` updates the
parameters and the moments IN PLACE (the reference returns new trees): a
second copy of a full-width model's parameters and moments would not fit
beside them on the card.

Under an LM mesh every tensor is this rank's block of the parameter
(``launch.sharding``): the moments are made on the blocks that
``launch.sharding.state_shardings`` gives, the update is elementwise on
them, and :func:`global_norm` sums each block's Σ g² over the axes that
split it, so a block that several ranks hold alike counts once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "adamw_update", "cosine_schedule", "global_norm",
           "moment_blocks"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: int
    m: dict
    v: dict


def moment_blocks(params: dict, mesh) -> dict:
    """The shape of each parameter's moments under ``mesh``: the block that
    ``launch.sharding.state_shardings`` gives the moment of the whole
    parameter.  Raises where a parameter's block is not that block (a model
    sharded under another layout, or not sharded)."""
    from ..launch import sharding as S

    whole = {n: torch.empty(S.full_shape(tuple(p.shape), getattr(p, "mesh_spec", (None,) * p.dim()), mesh),
                            device="meta") for n, p in params.items()}
    specs = S.state_shardings({"opt": {"m": whole}}, mesh)["opt"]["m"]
    out = {}
    for n, p in params.items():
        out[n] = S.block_shape(tuple(whole[n].shape), specs[n], mesh)
        if out[n] != tuple(p.shape):
            raise ValueError(f"init_opt_state: {n}'s block {tuple(p.shape)} is not state_shardings' block "
                             f"{out[n]} (spec {specs[n]}) of {tuple(whole[n].shape)}")
    return out


def init_opt_state(params: dict, mesh=None) -> OptState:
    """Zero moments in f32, one per parameter, on its device; under a
    ``mesh``, on the blocks of :func:`moment_blocks`."""
    shapes = {n: tuple(p.shape) for n, p in params.items()} if mesh is None else moment_blocks(params, mesh)
    return OptState(
        step=0,
        m={n: torch.zeros(shapes[n], dtype=torch.float32, device=p.device) for n, p in params.items()},
        v={n: torch.zeros(shapes[n], dtype=torch.float32, device=p.device) for n, p in params.items()},
    )


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def cosine_schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warm-up to ``lr``, then a cosine down to ``min_lr_ratio·lr``,
    in f32 as the reference computes it; returns the f32 value as a float."""
    s = _f32(step)
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * prog))
    return float(_f32(cfg.lr) * warm * (cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos))


def global_norm(tree: dict, mesh=None, specs: Optional[dict] = None) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²) in f32 (a 0-dim tensor on the leaves'
    device).  Under a ``mesh`` of more than one rank each leaf is a block
    of its tensor under ``specs[name]`` (replicated where absent): the Σ x²
    of the leaves that one set of axes splits are summed in order, that sum
    is summed over those axes, and the sets' totals are added, so every
    rank returns the same norm and a replicated leaf counts once."""
    if mesh is None or mesh.size == 1:
        total = None
        for x in tree.values():
            sq = torch.sum(x.float() ** 2)
            total = sq if total is None else total + sq
        return torch.sqrt(total)
    from ..launch import collectives as C
    from ..launch.sharding import split_axes

    by_axes: dict = {}
    for name, x in tree.items():
        axes = C.live_axes(mesh, split_axes((specs or {}).get(name)))
        sq = torch.sum(x.float() ** 2)
        by_axes[axes] = sq if axes not in by_axes else by_axes[axes] + sq
    total = None
    for axes in sorted(by_axes):
        part = C.psum(by_axes[axes], mesh, axes)
        total = part if total is None else total + part
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: OptState, mesh=None,
                 specs: Optional[dict] = None):
    """One AdamW step with global-norm clipping and decoupled weight decay,
    every parameter decayed, in the reference's order of operations:
    g ← g·min(1, clip/max(‖g‖, 1e-9)); m ← b1·m + (1−b1)·g;
    v ← b2·v + (1−b2)·g²; p ← p − lr·(m̂/(√v̂ + eps) + wd·p), in f32 and
    rounded back to p's dtype.  ``params`` and the moments are updated in
    place.  Under a ``mesh`` the tensors are blocks and the norm is
    :func:`global_norm`'s over the mesh (``specs``: each parameter's).
    Returns (params, the new OptState, {"lr", "grad_norm"})."""
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads, mesh, specs)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    b1t = float(1.0 - _f32(cfg.b1) ** step)
    b2t = float(1.0 - _f32(cfg.b2) ** step)
    for name, p in params.items():
        m, v = state.m[name], state.v[name]
        g = grads[name].float() * clip
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g * g)
        delta = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, OptState(step=step, m=state.m, v=state.v), {"lr": lr, "grad_norm": gnorm}

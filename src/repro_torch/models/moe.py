"""Mixture-of-Experts layer with capacity-bounded expert dispatch (the
mesh-free branch of the reference's ``models/moe.py``).

Each token's router scores pick its top-k experts; each expert then takes
the top-C tokens of its combine-weight column (C = the capacity), runs its
gated FFN on them as one batched matmul over all experts, and adds the
weighted outputs back into their tokens' rows in the reference's order
(:func:`_combine`); the shared experts see every token.  A token
that more than C tokens outbid at an expert is dropped there, and a slot
of an expert with fewer than C routed tokens carries weight 0, so its
output is inert.  Nothing here is a hand-written kernel: the reference
runs the same steps as XLA ops outside any Pallas kernel.

Selection follows ``jax.lax.top_k``: the larger value first and, among
equal values, the lower index (:func:`_topk`).  Ties are real: two equal
token rows have equal combine weights, and when the capacity binds the
order decides which one an expert drops.

Every selection goes through :func:`_topk`, and :func:`recorded_routing`
records them (each layer's experts of each token, then each expert's kept
tokens) or makes a run take an earlier run's selections, so that two runs
with different arithmetic route alike and can be held to one band.

The reference's ``shard_map`` branches (experts over a model axis, FSDP
weights, ``routing="local"`` inside the map) wait for the LM meshes
(ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L
from .registry import ModelConfig, MoEConfig

__all__ = ["MoE", "capacity", "kept_tokens", "moe_apply", "recorded_routing", "routing_differences"]


class MoE(nn.Module):
    """Parameters of one MoE layer: ``router`` (d, E), ``w_gate`` and
    ``w_up`` (E, d, f), ``w_down`` (E, f, d), and ``shared``, the gated
    MLP of the shared experts at width f·num_shared (``None`` without
    them).  The reference's initialisation laws."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, generator):
        super().__init__()
        m = cfg.moe
        d, f, E = cfg.d_model, m.d_expert, m.num_experts
        kw = dict(dtype=dtype, device=device, generator=generator)

        def experts(din, dout):
            w = torch.randn((E, din, dout), **kw)
            return nn.Parameter(w.mul_(1.0 / math.sqrt(din)), requires_grad=False)

        self.router = L.dense_init(d, E, scale=0.02, **kw)
        self.w_gate = experts(d, f)
        self.w_up = experts(d, f)
        self.w_down = experts(f, d)
        self.shared = L.mlp_init(d, f * m.num_shared, gated=True, **kw) if m.num_shared > 0 else None


def _topk(x, k: int):
    """The k largest entries of each row of x and their indices, in
    ``jax.lax.top_k``'s order: descending, the lower index first among
    equal values (a stable sort; ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(n: int, m: MoEConfig) -> int:
    """The reference's expert capacity for n tokens:
    max(1, int(n·top_k·capacity_factor / E))."""
    return max(1, int(n * m.top_k * m.capacity_factor / m.num_experts))


def kept_tokens(w, m: MoEConfig):
    """Each expert's kept tokens (E, C) under combine weights w (N, E):
    the top C = min(capacity, N) of its column, in ``jax.lax.top_k``'s order."""
    n = w.shape[0]
    return _topk(w.T, min(capacity(n, m), n))[1]


@contextlib.contextmanager
def recorded_routing(replay=None):
    """Record every selection the MoE layers make while the block runs:
    yields a list that gains, per layer, each token's experts (N, k) and then
    each expert's kept tokens (E, C).  Given ``replay``, such a list from an
    earlier run, each selection takes the recorded indices instead and reads
    their values from this run's scores and weights."""
    global _topk
    select, log = _topk, []
    queue = None if replay is None else list(replay)

    def recorded(x, k):
        if queue is None:
            vals, idx = select(x, k)
        else:
            if not queue:
                raise RuntimeError("recorded_routing: more selections than the replayed run made")
            idx = queue.pop(0).to(x.device)
            if idx.shape != (*x.shape[:-1], k):
                raise RuntimeError(f"recorded_routing: replayed indices {tuple(idx.shape)}, "
                                   f"this run selects {k} of {tuple(x.shape)}")
            vals = x.gather(-1, idx)
        log.append(idx)
        return vals, idx

    _topk = recorded
    try:
        yield log
    finally:
        _topk = select
    if queue:
        raise RuntimeError(f"recorded_routing: {len(queue)} replayed selections left unused")


def routing_differences(log_a, log_b):
    """Per MoE layer, the routing decisions two recorded runs made
    differently: the tokens whose expert set differs plus the experts whose
    kept-token set differs."""
    if len(log_a) != len(log_b) or len(log_a) % 2:
        raise ValueError(f"routing_differences: logs of {len(log_a)} and {len(log_b)} selections")

    def rows(a, b):
        a, b = a.sort(-1).values.cpu(), b.sort(-1).values.cpu()
        return int((a != b).any(-1).sum())

    per = [rows(a, b) for a, b in zip(log_a, log_b)]
    return [per[i] + per[i + 1] for i in range(0, len(per), 2)]


def _routing(router, x, m: MoEConfig):
    """Router scores of x (B, T, d) → (sparse combine weights (N, E) f32,
    Switch aux loss, a f32 scalar).  The router runs in f32."""
    d = x.shape[-1]
    logits = x.reshape(-1, d).float() @ router.float()
    if m.router_score == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    vals, idx = _topk(scores, m.top_k)  # (N, k)
    if m.renorm_topk:
        vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # top-k indices are distinct, so the scatter equals the one-hot einsum bit for bit
    w_sparse = torch.zeros_like(scores).scatter_(1, idx, vals)
    # Switch-style load-balance aux: E · Σ_e (token fraction)·(prob mass);
    # the mass is the softmax of the logits under either score.
    frac = torch.zeros_like(scores).scatter_(1, idx, 1.0).mean(0) / m.top_k
    prob = torch.softmax(logits, dim=-1).mean(0)
    return w_sparse, m.num_experts * torch.sum(frac * prob)


def _combine(out, idx, vals, n: int, k: int):
    """The expert outputs out (E, C, d), each slot times its combine weight,
    summed into their tokens' rows (n, d) as the reference's serial
    scatter-add ``flat.at[idx].add``: each token's contributions added in
    the order of the flattened idx (expert-major, then slot), rounded to
    out's dtype after every add, and the same bits on every run
    (``index_add_`` on the card adds in the order its atomics land).

    One expert keeps C distinct tokens, so a token has at most one slot at
    an expert.  A slot of weight 0 adds ±0, which leaves every sum as it
    is, so only the live slots (weight ≠ 0) count, and a token has at most
    k of them, one at each of its top-k experts.  Each token gathers its
    live slots in expert order (their flat positions e·C + c ascend with e)
    and sums them in k rounded adds: one pass, no atomics.

    idx, vals: (E, C) kept tokens and their combine weights (f32).  Returns
    (n, d) in out's dtype."""
    E, C, d = out.shape
    none = E * C  # the position of a zero row: a slot no token has
    rows = out.new_empty((none + 1, d))
    torch.mul(out, vals[..., None].to(out.dtype), out=rows[:none].view(E, C, d))
    rows[none].zero_()
    slot = torch.arange(none, device=out.device).reshape(E, C).masked_fill_(vals == 0, none)
    pos = torch.full((E, n), none, dtype=torch.long, device=out.device).scatter_(1, idx, slot)  # (E, n)
    order = torch.topk(pos, k, dim=0, largest=False).values  # (k, n): each token's live slots, in order
    flat = torch.zeros((n, d), dtype=out.dtype, device=out.device)
    for part in rows[order]:  # (n, d) each
        flat = flat + part
    return flat


def _expert_compute(x_flat, w_cols, wg, wu, wd, cap: int, compute_dtype, top_k: int):
    """Top-C dispatch → batched expert FFN → weighted combine.

    x_flat: (N, d); w_cols: (N, E) combine weights, at most ``top_k``
    nonzero a row; wg/wu/wd: (E, d, f)/(E, d, f)/(E, f, d).  Returns (N, d)
    in ``compute_dtype``."""
    n, d = x_flat.shape
    e = w_cols.shape[1]
    c = min(cap, n)
    vals, idx = _topk(w_cols.T, c)  # (E, C) each
    xe = x_flat[idx.reshape(-1)].reshape(e, c, d).to(compute_dtype)
    h = F.silu(torch.bmm(xe, wg.to(compute_dtype))) * torch.bmm(xe, wu.to(compute_dtype))
    return _combine(torch.bmm(h, wd.to(compute_dtype)), idx, vals, n, top_k)


def moe_apply(p: MoE, x, cfg: ModelConfig):
    """MoE block forward.  x: (B, T, d) → (out (B, T, d) in x's dtype, aux
    loss, a f32 scalar), at the capacity of N = B·T tokens."""
    m = cfg.moe
    compute_dtype = getattr(torch, cfg.compute_dtype)
    B, T, d = x.shape
    n = B * T
    x_flat = x.reshape(n, d)
    w_sparse, aux = _routing(p.router, x, m)
    out = _expert_compute(x_flat, w_sparse, p.w_gate, p.w_up, p.w_down, capacity(n, m), compute_dtype,
                          m.top_k)
    if p.shared is not None:
        out = out + L.mlp_apply(p.shared, x_flat, act=cfg.mlp_act, compute_dtype=compute_dtype)
    return out.reshape(B, T, d).to(x.dtype), aux

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

A layer told which experts it holds (``MoEConfig.experts_held`` = [lo,
hi), expert parallelism's share of one chip) keeps their weights alone,
(hi − lo, ·, ·), routes over all ``num_experts`` with the router whole,
and computes only its own experts' part: the column block [lo, hi) of the
combine weights enters the dispatch, the capacity is the whole layer's,
and the shared experts see every token, as the model-axis branch below
does on one rank, here without its exchange.  The capacity rule is the
port's: each expert keeps the top C = int(n·top_k·capacity_factor / E) of
the n tokens of one forward (one group's), where DeepSeek-V2 bounds each
device's tokens instead.  The balance loss is the Switch loss over the
batch, or under ``balance="seq"`` DeepSeek-V2's expert-level loss taken
per sequence (:func:`_routing`).

Under ``padding_routes=False`` the rows of padding slots (``rows_valid``
0, the train step's headroom) take no part: their combine weights are 0,
n counts the real tokens alone, and the balance loss is the mean over the
real sequences.  The selection keeps its shape, the top C of all rows,
and a slot past the real tokens' C carries weight 0 (C is a count on the
device: no host sync).  Otherwise padding rows route like any row, as in
the reference's vmap.

The meshless forward's stages are the spans ``moe.route``,
``moe.experts`` (routed and shared) and ``moe.combine``; with spans on
(``obs.obs_enabled``) the counters ``moe.routed`` (routed (token,
expert) pairs at the held experts) and ``moe.dropped`` (those the
capacity dropped) add up on the device (``obs.default_counters``).

Every selection goes through :func:`_topk`, and :func:`recorded_routing`
records them (each layer's experts of each token, then each expert's kept
tokens) or makes a run take an earlier run's selections, so that two runs
with different arithmetic route alike and can be held to one band.

Under an LM mesh (``ctx.mesh``) the reference's three branches are
mirrored:

* **Model axis of size 1.**  The mesh-free branch: a global capacity and a
  global top-C over all N tokens.  Under data shards that is a cross-rank
  top-k, so the rank gathers every shard's rows, runs the mesh-free MoE on
  them and keeps its own rows.
* **Model axis m > 1** (the reference's ``shard_map`` branches).  Each
  model rank holds E/m experts; the capacity comes from the data shard's
  tokens; the expert weights are gathered over ``data`` where FSDP splits
  them.  The dispatch and the combine run on the rank's columns of the
  combine weights, the shared experts' ``d_ff`` split over the model axis
  (``layers.mlp_apply``).  Where the reference sums each rank's combine
  and shared part in one ``psum``, the port keeps the meshless model's
  roundings: the combine is chained over the model ranks
  (``collectives.chain``: each rank continues the previous rank's serial
  sums over the experts before its own, so each token's contributions are
  added in expert order, as the meshless combine adds them).  A sum of
  parts rounds where the meshless model does not, and this random model
  amplifies one rounding into 2e-2 of the logits' scale by the last of 28
  layers (PERF.md, PR 24); in f32, as the reference's CPU tests run it,
  the two agree to 1e-6.  ``routing="pjit"`` routes the rank's rows
  and takes the global aux loss (token fractions and probability mass
  summed over the batch axes before their product); ``routing="local"``
  takes each shard's aux and their mean over the batch axes.  The outputs
  of the two are equal; their aux losses differ, as in the reference.

:func:`recorded_routing` records and replays each rank's own selections.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..launch import collectives as C
from ..obs import default_counters, obs_enabled, trace_span
from . import layers as L
from . import taps
from .registry import ModelConfig, MoEConfig

__all__ = ["MoE", "capacity", "kept_tokens", "moe_apply", "recorded_routing", "routing_differences"]


class MoE(nn.Module):
    """Parameters of one MoE layer: ``router`` (d, E), ``w_gate`` and
    ``w_up`` (E_held, d, f), ``w_down`` (E_held, f, d), E_held the experts
    held (E unless ``experts_held`` says otherwise), and ``shared``, the
    gated MLP of the shared experts at width f·num_shared (``None``
    without them).  The reference's initialisation laws."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, generator, f32_read_dtype=None):
        super().__init__()
        m = cfg.moe
        d, f, E = cfg.d_model, m.d_expert, m.num_experts
        lo, hi = held(m)
        kw = dict(dtype=dtype, device=device, generator=generator)

        def experts(din, dout):
            w = torch.randn((hi - lo, din, dout), **kw)
            return L._param(w.mul_(1.0 / math.sqrt(din)))

        self.router = L.dense_init(d, E, scale=0.02, dtype=f32_read_dtype or dtype, device=device,
                                   generator=generator)
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


def held(m: MoEConfig) -> tuple[int, int]:
    """[lo, hi): the experts this layer holds."""
    lo, hi = m.experts_held or (0, m.num_experts)
    if not 0 <= lo < hi <= m.num_experts:
        raise ValueError(f"experts_held {m.experts_held} of {m.num_experts} experts")
    return lo, hi


def capacity(n, m: MoEConfig):
    """The reference's expert capacity for n tokens:
    max(1, int(n·top_k·capacity_factor / E)); for n a 0-dim tensor (a count
    on the device), the same in float64 as a 0-dim tensor."""
    if isinstance(n, torch.Tensor):
        return torch.clamp_min(torch.floor(n.double() * m.top_k * m.capacity_factor / m.num_experts), 1)
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


def _seq_balance(picked, prob, seqs: int, m: MoEConfig, valid=None):
    """DeepSeek-V2's expert-level balance loss per sequence, the mean over
    the ``seqs`` sequences of Σ_e f_e·P_e, where f_e = E/(K·T)·(the
    sequence's tokens routed to e) and P_e is the mean router probability
    of e over its T tokens.  picked, prob: (seqs·T, E), sequence-major.
    Given ``valid`` (seqs·T,), the mean over the real sequences alone."""
    n, E = prob.shape
    T = n // seqs
    f = picked.reshape(seqs, T, E).sum(1) * (E / (m.top_k * T))
    per = torch.sum(f * prob.reshape(seqs, T, E).mean(1), dim=-1)
    if valid is None:
        return torch.mean(per)
    real = valid.reshape(seqs, T)[:, 0]
    return torch.sum(per * real) / torch.clamp_min(torch.sum(real), 1.0)


def _routing(router, x, m: MoEConfig, mesh=None, batch_axes=(), seqs: int = 1, valid=None):
    """Router scores of x (N, d) → (sparse combine weights (N, E) f32,
    balance loss, a f32 scalar).  The router runs in f32.  Given a mesh
    and batch axes over which the tokens are split, the Switch loss is the
    global one: the token fractions and the probability mass are summed
    over those axes first.  Under ``balance="seq"`` x holds ``seqs``
    sequences, row-major, and the loss is :func:`_seq_balance` (the mean of
    the shards' means under a mesh's batch axes).  Given ``valid`` (N,)
    (1 a real token, 0 a padding one; meshless only), padding tokens
    route nowhere and the loss is over the real tokens."""
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
    picked = torch.zeros_like(scores).scatter_(1, idx, 1.0)
    probs = torch.softmax(logits, dim=-1)
    if valid is not None:
        w_sparse, picked = w_sparse * valid[:, None], picked * valid[:, None]
    nd = 1
    for a in batch_axes:
        nd *= mesh.shape.get(a, 1) if mesh is not None else 1
    if m.balance == "seq":
        aux = _seq_balance(picked, probs, seqs, m, valid)
        taps.tap("router", w_sparse)
        return w_sparse, aux if nd == 1 else C.pmean(aux, mesh, batch_axes)
    if valid is not None:
        n = torch.clamp_min(valid.sum(), 1.0)
        frac = picked.sum(0) / n / m.top_k
        prob = (probs * valid[:, None]).sum(0) / n
    elif nd == 1:
        frac = picked.mean(0) / m.top_k
        prob = probs.mean(0)
    else:
        n = logits.shape[0] * nd
        frac = C.psum(picked.sum(0), mesh, batch_axes) / n / m.top_k
        prob = C.psum(probs.sum(0), mesh, batch_axes) / n
    taps.tap("router", w_sparse)
    return w_sparse, m.num_experts * torch.sum(frac * prob)


def _combine(out, idx, vals, n: int, k: int, start=None):
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
    and sums them in k rounded adds: one pass, no atomics.  A token's
    places beyond its live slots read a zero row of its own, so that the
    gather's backward meets no long run of one repeated row (a layer that
    holds few of the experts leaves most places empty).  Every step is
    out of place, so autograd differentiates it (the gradient reaches out
    and the router's weights vals).

    idx, vals: (E, C) kept tokens and their combine weights (f32).  Returns
    (n, d) in out's dtype.  Given ``start`` (n, d), the sums continue from
    it: a model rank of a mesh continues the previous rank's sums over the
    experts before its own."""
    E, C, d = out.shape
    none = E * C  # past the slots: token t's zero row is none + t
    rows = torch.cat([(out * vals[..., None].to(out.dtype)).reshape(none, d), out.new_zeros((n, d))])
    slot = torch.arange(none, device=out.device).reshape(E, C).masked_fill_(vals == 0, none)
    pos = torch.full((E, n), none, dtype=torch.long, device=out.device).scatter_(1, idx, slot)  # (E, n)
    order = torch.topk(pos, k, dim=0, largest=False).values  # (k, n): each token's live slots, in order
    order = torch.where(order == none, order + torch.arange(n, device=out.device), order)
    flat = torch.zeros((n, d), dtype=out.dtype, device=out.device) if start is None else start
    for part in rows[order]:  # (n, d) each
        flat = flat + part
    return flat


def _expert_outputs(x_flat, w_cols, wg, wu, wd, cap: int, compute_dtype, live=None):
    """Top-C dispatch → batched expert FFN: (the outputs (E, C, d) in
    ``compute_dtype``, the kept tokens idx (E, C), their weights (E, C)).
    Given ``live`` (a 0-dim count ≤ C), the slots from ``live`` on keep
    nothing: their weights are 0."""
    n, d = x_flat.shape
    e = w_cols.shape[1]
    c = min(cap, n)
    vals, idx = _topk(w_cols.T, c)  # (E, C) each
    if live is not None:
        vals = vals * (torch.arange(c, device=vals.device) < live)
    xe = x_flat[idx.reshape(-1)].reshape(e, c, d).to(compute_dtype)
    h = F.silu(torch.bmm(xe, wg.to(compute_dtype))) * torch.bmm(xe, wu.to(compute_dtype))
    out = torch.bmm(h, wd.to(compute_dtype))
    taps.tap("experts", out, 0)  # a model axis splits the experts
    return out, idx, vals


def _data_shard(mesh, batch_axes) -> tuple[int, int]:
    """(the number of data shards, this rank's index among them)."""
    n, shard = 1, 0
    for a in batch_axes:
        n, shard = n * mesh.shape[a], shard * mesh.shape[a] + mesh.coord(a)
    return n, shard


def moe_apply(p: MoE, x, cfg: ModelConfig, ctx=None, rows_valid=None):
    """MoE block forward.  x: (B, T, d) → (out (B, T, d) in x's dtype, aux
    loss, a f32 scalar).  Meshless, at the capacity of N = B·T tokens;
    under a mesh, the branches of the module docstring.  ``rows_valid``
    (B,), 1 a real row and 0 a padding slot's, counts where
    ``padding_routes`` is False (the module docstring)."""
    m = cfg.moe
    compute_dtype = getattr(torch, cfg.compute_dtype)
    B, T, d = x.shape
    n = B * T
    x_flat = x.reshape(n, d)
    mesh = None if ctx is None else ctx.mesh
    msize = mesh.shape.get(ctx.model_axis, 1) if (mesh is not None and ctx.model_axis) else 1
    valid = None if rows_valid is None or m.padding_routes else rows_valid.float().repeat_interleave(T)
    if valid is not None and mesh is not None:
        raise ValueError(f"{cfg.name}: padding_routes=False has no mesh path")
    if msize == 1:
        nd, shard = _data_shard(mesh, ctx.batch_axes) if mesh is not None else (1, 0)
        xg = C.gather_axes(x_flat, mesh, ctx.batch_axes, 0) if nd > 1 else x_flat
        lo, hi = held(m)
        with trace_span("moe.route"):
            w_sparse, aux = _routing(p.router, xg, m, seqs=B * nd, valid=valid)
        with trace_span("moe.experts"):
            eo, idx, vals = _expert_outputs(xg, w_sparse[:, lo:hi], L.weight(p.w_gate, ctx), L.weight(p.w_up, ctx),
                                            L.weight(p.w_down, ctx), capacity(n * nd, m), compute_dtype,
                                            None if valid is None else capacity(valid.sum(), m))
            shared = (L.mlp_apply(p.shared, xg, act=cfg.mlp_act, compute_dtype=compute_dtype, ctx=ctx)
                      if p.shared is not None else None)
        with trace_span("moe.combine"):
            out = _combine(eo, idx, vals, n * nd, min(m.top_k, hi - lo))
            if shared is not None:
                out = out + shared
        if obs_enabled():
            routed = torch.count_nonzero(w_sparse[:, lo:hi])
            default_counters().add("moe.routed", routed)
            default_counters().add("moe.dropped", routed - torch.count_nonzero(vals))
        return out[shard * n:(shard + 1) * n].reshape(B, T, d).to(x.dtype), aux

    if m.experts_held is not None:
        raise ValueError(f"{cfg.name}: experts_held {m.experts_held} is one chip's share of a model axis; "
                         f"under a model axis of {msize} ranks each rank holds its own share")
    e_loc = m.num_experts // msize
    r = mesh.coord(ctx.model_axis)
    lo, hi = r * e_loc, (r + 1) * e_loc
    if ctx.moe_routing == "local":
        w_sparse, aux = _routing(p.router, x_flat, m)
        aux = C.pmean(aux, mesh, ctx.batch_axes)
    elif ctx.moe_routing == "pjit":
        w_sparse, aux = _routing(p.router, x_flat, m, mesh, ctx.batch_axes)
    else:
        raise ValueError(f"moe_apply: routing {ctx.moe_routing!r}, expected 'pjit' or 'local'")
    # The tokens and the combine weights, alike on every model rank, enter
    # the rank's experts (collectives.enter: their cotangents are summed).
    eo, idx, vals = _expert_outputs(
        C.enter(x_flat, mesh, ctx.model_axis), C.enter(w_sparse, mesh, ctx.model_axis)[:, lo:hi],
        L.weight(p.w_gate, ctx, 0, lo, hi), L.weight(p.w_up, ctx, 0, lo, hi),
        L.weight(p.w_down, ctx, 0, lo, hi), capacity(n, m), compute_dtype)
    out = C.chain(lambda start: _combine(eo, idx, vals, n, min(m.top_k, e_loc), start),
                  torch.zeros((n, d), dtype=eo.dtype, device=eo.device), mesh, ctx.model_axis)
    if p.shared is not None:
        out = out + L.mlp_apply(p.shared, x_flat, act=cfg.mlp_act, compute_dtype=compute_dtype, ctx=ctx)
    return out.reshape(B, T, d).to(x.dtype), aux

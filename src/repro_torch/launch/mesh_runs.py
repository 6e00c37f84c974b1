"""Rank programs: the workloads that run on every rank of a mesh.

Each ``*_rank`` function is what :func:`repro_torch.launch.distributed.run_ranks`
starts on every rank (it must live in a module, not in a script's
``__main__``).  It drives the same workload as its plain twin does through
:class:`~repro_torch.core.executor.LocalExecutor`, with
``executor="mesh"``, and reports rank 0's results beside the lockstep
checks: whether every rank holds the same bits (recovery weights, packed
shards, results) and what each rank did (launches, rows written, block).

The workloads are those of the reference's multi-device tests:

* :func:`fig1` — the Figure-1 parity of ``tests/test_distributed_executor.py``
  (``n=600, s=10, t=3, k=8``, ``franti_s1_like``, Bernoulli ℓ=2 and the
  singleton baseline);
* :func:`multiround` — the elastic multi-round session of
  ``tests/test_resilience.py`` (12 rounds of a deadline scenario, patience 2);
* :func:`stream` — the streaming session of ``tests/test_stream.py``
  (8 batches, iid stragglers, the mask stream replayed);
* :func:`train` — the mesh-native resilient trainer of
  ``tests/test_training.py:459`` (``Trainer(device_recovery=True)``: the
  groups' gradients combined across the ranks, the resident token pools
  placed as blocks and patched on the owning rank);
* :func:`full_width_rank` — the mesh phase of ``chip_smoke.py`` at the
  shape of SIFT1M;
* :func:`lm_rank` — the LM mesh jobs of ``tests/test_torch_lm_mesh.py``,
  ``tests/test_torch_moe_mesh.py`` and ``tests/test_torch_seq_decode.py``
  (a model's prefill and teacher-forced decode, one MoE layer, one sLSTM
  block, a teacher-forced decode under a cache layout), each on a mesh of
  the world's size, their outputs gathered whole on every rank;
* :func:`moe_serve_rank` — phase "serve mesh" of ``chip_smoke.py``:
  deepseek-moe-16b at full width, each rank drawing only its blocks, its
  decode under both cache layouts;
* :func:`train_lm_rank` — the LM mesh training jobs of
  ``tests/test_torch_lm_mesh_train.py`` (each collective's backward, the
  train step, the trainer), each on a mesh of the world's size;
* :func:`train_mesh_rank` — phase "train mesh" of ``chip_smoke.py``:
  qwen3-1.7b at full width, one train step a rank against the meshless
  oracle's gradient blocks, and with ``compress`` the mesh compression of
  the oracle's gradient against the meshless one;
* :func:`ckpt_mesh_rank` — phase "train mesh" (e) and the checkpoint
  tests of ``tests/test_torch_lm_mesh_ckpt.py``: a compressed ``Trainer``
  on the mesh checkpointed, resumed, and restored from meshless, mesh and
  reference files;
* :func:`dryrun_twin_rank` — the real run of a ``launch.dryrun`` cell on
  the mesh (``tests/test_torch_dryrun.py``): drawn values, real
  collectives, counted by ``launch.op_analysis``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch

from ..core import (
    ElasticPolicy,
    ResilienceSession,
    bernoulli_assignment,
    cyclic_assignment,
    fixed_count_stragglers,
    get_executor,
    ignore_stragglers_kmedian,
    make_scenario,
    resilient_kmedian,
    singleton_assignment,
)
from ..core.aggregation import resilient_psum
from ..data.synthetic import franti_s1_like, gaussian_mixture
from ..kernels import dispatch

__all__ = [
    "fig1", "fig1_rank", "multiround", "multiround_rank", "stream", "stream_rank",
    "eight_rank_twins", "update_rows_rank", "alg1_problem", "alg1_rank", "full_width_rank",
    "train", "train_rank", "lm_rank", "lm_job", "decode_taps", "first_difference", "moe_mesh_oracle",
    "moe_serve_rank", "train_lm_rank", "train_mesh_batches", "train_mesh_rank", "compression_check",
    "block_digests", "ckpt_mesh_rank", "narrowed_digests", "dryrun_twin_rank",
]


def _mesh():
    return get_executor("mesh")


# ---------------------------------------------------------------- Figure 1


def _fig1(executor, device, *, n=600, s=10, t=3, k=8, local_iters=6, coord_iters=10):
    pts, _, _ = franti_s1_like(n)
    alive = fixed_count_stragglers(s, t, np.random.default_rng(0))
    a = bernoulli_assignment(n, s, ell=2.0, rng=np.random.default_rng(1))
    kw = dict(local_iters=local_iters, coord_iters=coord_iters, device=device)
    sess = ResilienceSession(a, executor=executor, device=device)
    out = resilient_kmedian(pts, k, a, alive, session=sess, **kw)
    base = ignore_stragglers_kmedian(pts, k, singleton_assignment(n, s), alive, executor=executor, **kw)
    record = {"resilient_kmedian": out.cost, "ignore_stragglers_kmedian": base.cost}
    return record, (out.recovery.b_full, sess._packed, out.centers, base.centers, out.cost, base.cost)


def fig1(executor, device) -> dict:
    """The Figure-1 costs through ``executor`` on ``device``."""
    return _fig1(executor, device)[0]


def fig1_rank() -> dict:
    ex = _mesh()
    record, held = _fig1(ex, ex.mesh.device)
    return {**record, "describe": ex.describe(), "device": str(ex.mesh.device),
            "lockstep": ex.same_on_all_ranks(*held)}


# ------------------------------------------------------ multi-round session


def multiround(executor, device, centers, *, rounds: int = 12) -> dict:
    """The elastic multi-round run: per round ``observe`` then ``step_cost``
    (``None`` for an all-dead round)."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(160, 3)).astype(np.float32)
    sess = ResilienceSession(cyclic_assignment(160, 8, 2), executor=executor, device=device,
                             elastic=ElasticPolicy(enabled=True, patience=2))
    scen = make_scenario("deadline", 8, seed=6, p_spike=0.06, persistence=1.0,
                         spike_scale=6.0, deadline=2.0)
    costs, uncovered, moved = [], [], []
    for _ in range(rounds):
        step = next(scen)
        ev = sess.observe(step)
        uncovered.append(ev["uncovered"])
        moved.append(ev["moved_nodes"])
        costs.append(sess.step_cost(pts, centers, step.alive) if step.alive.any() else None)
    return {"costs": costs, "uncovered": uncovered, "moved_nodes": moved,
            "stats": sess.stats.as_dict(), "matrix": sess.assignment.matrix.copy()}


def multiround_rank(centers) -> dict:
    ex = _mesh()
    written = ex.rows_written
    out = multiround(ex, ex.mesh.device, centers)
    mine = ex.rows_written - written
    out["lockstep"] = ex.same_on_all_ranks(out["costs"], out["uncovered"], out["matrix"], out["stats"])
    out["rows_written"] = ex.gather_object(mine)
    return out


# ----------------------------------------------------------- streaming tree


def stream(executor, device, *, stragglers: bool = True) -> dict:
    """8 ingests of 192 2-D rows (iid stragglers, p = 0.2, or all alive),
    a solve, then the mask stream replayed over the same batches."""
    rng = np.random.default_rng(0)
    batches = [rng.normal(size=(192, 2)).astype(np.float32) for _ in range(8)]
    from ..stream import StreamingSession

    scen = make_scenario("iid", 8, p_straggler=0.2, seed=5) if stragglers else None
    sess = StreamingSession(2, 3, num_nodes=8, fanout=3, leaf_size=64, coreset_size=16,
                            scenario=scen, executor=executor, seed=0,
                            elastic=ElasticPolicy(enabled=False), device=device)
    for b in batches:
        sess.ingest(b)
    cost = sess.solve(iters=8).cost
    xs, ws = sess.frontier()
    out = {"cost": cost, "levels": [len(lv) for lv in sess.buffer.levels],
           "frontier": (xs.cpu().numpy(), ws.cpu().numpy()),
           "host_solves": sess.resilience.stats.host_solves}
    if scen is not None:
        scen.reset()
        for b in batches:
            sess.ingest(b)
        out["host_solves_after_replay"] = sess.resilience.stats.host_solves
    return out


def stream_rank() -> dict:
    ex = _mesh()
    out = stream(ex, ex.mesh.device)
    out["lockstep"] = ex.same_on_all_ranks(out["cost"], out["frontier"], out["levels"])
    return out


def eight_rank_twins(centers) -> dict:
    """The three multi-device twins in one start of the ranks."""
    return {"fig1": fig1_rank(), "multiround": multiround_rank(centers), "stream": stream_rank()}


# ------------------------------------------------------------ placement


def update_rows_rank() -> dict:
    """Placement and the combine on a mesh.  (1) Rows 1 and 4 of a (6, 4)
    node-stacked array rewritten: each rank's block before and after and
    the rows it wrote.  (2) An elastic patch inside the shards' padding (8
    nodes, 20 shards, nodes 6 and 7 persistent stragglers): the session
    rewrites the moved rows of its resident blocks, each rank only its own;
    each rank's block against the pack of the patched assignment.  (3)
    ``resilient_psum`` of a small tree, rank ``r`` weighted ``r + 1``."""
    from ..core.assignment import Assignment
    from ..core.kmedian import pack_local_shards

    ex = _mesh()
    arr = ex.place_node_stacked(np.arange(24, dtype=np.float32).reshape(6, 4))
    before = arr.local.cpu().numpy().copy()
    written = ex.rows_written
    out = ex.update_node_rows(arr, [1, 4], np.full((2, 4), 7.0, np.float32))
    rows = {"offset": out.offset, "before": before, "after": out.local.cpu().numpy(),
            "written": ex.rows_written - written, "same_storage": out is arr}
    whole = ex.gather_node_stacked(out).cpu().numpy()

    mat = np.zeros((8, 20), dtype=np.uint8)
    mat[0, 0:8] = mat[2, 0:8] = 1
    mat[1, 8:16] = mat[3, 8:16] = 1
    mat[4, 0:4] = 1
    mat[5, 4:8] = 1
    mat[6, 16:20] = mat[7, 16:20] = 1
    pts = np.random.default_rng(3).normal(size=(20, 3)).astype(np.float32)
    sess = ResilienceSession(Assignment(matrix=mat, scheme="skewed", params={}), executor=ex,
                             elastic=ElasticPolicy(enabled=True, patience=2), device=ex.mesh.device)
    dead = np.ones(8, dtype=bool)
    dead[[6, 7]] = False
    sess.step_cost(pts, np.zeros((2, 3), np.float32), dead)
    xs0 = sess._resident[0]
    written = ex.rows_written
    moved: set = set()
    for _ in range(3):
        moved.update(sess.observe(dead)["moved_nodes"])
    xs1, ws1, _ = sess._resident
    want_x, want_w = pack_local_shards(pts, sess.assignment)
    lo, hi = xs1.offset, min(xs1.offset + xs1.local.shape[0], 8)
    patch = {"offset": xs1.offset, "written": ex.rows_written - written,
             "in_place": xs1 is xs0,
             "equal": bool(np.array_equal(xs1.local[: hi - lo].cpu().numpy(), want_x[lo:hi])
                           and np.array_equal(ws1.local[: hi - lo].cpu().numpy(), want_w[lo:hi]))}
    # Lemma 3 across the ranks: rank r contributes (r + 1) · x_r.
    r = float(ex.rank)
    psum = resilient_psum({"a": torch.full((2,), r + 1.0), "b": (torch.tensor([r]),)}, r + 1.0,
                          ex.mesh.group)
    return {"whole": whole, "ranks": ex.gather_object(rows), "moved": sorted(moved),
            "psum": (psum["a"].numpy(), psum["b"][0].numpy()),
            "stats": sess.stats.as_dict(), "patch": ex.gather_object(patch),
            "cost_after": sess.step_cost(pts, np.zeros((2, 3), np.float32), dead)}


# ------------------------------------------------------------- training


def train(executor: str, device, cfg, tcfg_kw: dict, ocfg_kw: dict) -> dict:
    """``Trainer(device_recovery=True)`` through ``executor`` ("local" or
    "mesh") from the seeded initial weights: the final parameters, the
    history, the session's counters and the resident validity mask."""
    from ..train.optimizer import AdamWConfig
    from ..train.trainer import Trainer, TrainerConfig

    t = Trainer(cfg, TrainerConfig(device_recovery=True, executor=executor, **tcfg_kw), AdamWConfig(**ocfg_kw),
                device=device)
    state = t.run()
    valid = t._res_valid
    return {"params": {n: p.detach().cpu().numpy() for n, p in state.params.named_parameters()},
            "history": t.history, "stats": t.plan.session.stats.as_dict(),
            "valid": getattr(valid, "local", valid).cpu().numpy()}


def train_rank(runs: dict) -> dict:
    """Each of ``runs`` (name → (cfg, trainer kwargs, optimizer kwargs))
    through the mesh on this rank: rank 0's results, the rows each rank
    wrote, each rank's block of the validity mask, and whether the ranks
    hold the same parameters."""
    ex = _mesh()
    out = {}
    for name, (cfg, tcfg_kw, ocfg_kw) in runs.items():
        written = ex.rows_written
        rec = train("mesh", ex.mesh.device or "cpu", cfg, tcfg_kw, ocfg_kw)
        rec["rows_written"] = ex.gather_object(ex.rows_written - written)
        rec["valid_blocks"] = ex.gather_object(rec.pop("valid"))
        rec["lockstep"] = ex.same_on_all_ranks(rec["params"], rec["history"])
        rec["describe"] = ex.describe()
        out[name] = rec
    return out


# ------------------------------------------------------- Algorithm 1, card


def alg1_problem(n: int, d: int, k: int, s: int, seed: int):
    pts, _, _ = gaussian_mixture(n, k, d, rng=np.random.default_rng(seed))
    a = bernoulli_assignment(n, s, ell=2.0, rng=np.random.default_rng(seed + 1))
    alive = fixed_count_stragglers(s, 2, np.random.default_rng(seed + 2))
    return pts, a, alive


def alg1_rank(n: int, d: int, k: int, s: int, seed: int) -> dict:
    """Algorithm 1 on :func:`alg1_problem` through the mesh, each rank's
    kernel launches counted around the call."""
    ex = _mesh()
    pts, a, alive = alg1_problem(n, d, k, s, seed)
    dispatch.reset_launch_counts()
    out = resilient_kmedian(pts, k, a, alive, local_iters=5, coord_iters=8, seed=seed,
                            executor=ex, device=ex.mesh.device)
    return {"cost": out.cost, "centers": out.centers, "describe": ex.describe(),
            "launches": ex.gather_object(dispatch.launch_counts()),
            "lockstep": ex.same_on_all_ranks(out.recovery.b_full, out.centers, out.cost)}


# ---------------------------------------------------------- full width, card


def _peak(device: torch.device):
    """Peak device memory (GiB) since the last reset; None on the CPU, where
    it is not measured."""
    return torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def full_width_rank(seed: int, centers_c: np.ndarray, rounds: int, n_batch: int, *,
                    n: int = 1_000_000, d: int = 128, k: int = 256, leaf: int = 16384) -> dict:
    """The mesh phase of ``chip_smoke.py`` on one rank: (b) Algorithm 1 at
    the shape of SIFT1M (k=256, s=10, t=3, Bernoulli p_a=0.2, 15 / 30
    iterations) with the seconds split into host prelude, local solves and
    collectives; (c) ``rounds`` rounds of ``observe`` + ``step_cost`` on
    ``cyclic_assignment(1M, 10, 4)`` under the "fixed" scenario (t=3,
    patience 2) at ``centers_c``; (d) ``n_batch`` ingests of 15,625 rows into
    a ``StreamingSession`` (d=128, k=256, 8 nodes, FR ℓ=2, fanout 4, leaf
    16384, coreset 4096) under the stream phase's iid stragglers.  Each
    part reports every rank's figures and whether the ranks agree.  The
    keywords cut the shape (the CPU test runs it small)."""
    from ..stream import StreamingSession

    from .distributed import _sync

    ex = _mesh()
    dev = ex.mesh.device
    sync = lambda: _sync(dev)  # noqa: E731
    n_full, d_full, k_full, s, t = n, d, k, 10, 3
    t0 = time.perf_counter()
    pts, _, _ = gaussian_mixture(n_full, k_full, d_full, rng=np.random.default_rng(seed))
    a = bernoulli_assignment(n_full, s, ell=0.2 * s, rng=np.random.default_rng(seed + 1))
    alive = fixed_count_stragglers(s, t, np.random.default_rng(seed + 2))
    data_s = time.perf_counter() - t0
    report: dict = {"describe": ex.describe(), "data_s": ex.gather_object(data_s)}

    # (b) Algorithm 1: the host prelude, then the run, the executor timing
    # its local calls and its collectives.
    _reset_peak(dev)
    sess = ResilienceSession(a, executor=ex, device=dev)
    t0 = time.perf_counter()
    _, _, rec, _, xs_np, ws_np = sess.prepare(pts, alive)
    _, xs, _ = sess.device_shards(dev)
    sync()
    prelude = time.perf_counter() - t0
    shard_bytes = xs.local.numel() * 4 * (1 + 1.0 / d_full)
    ex.timing = {"local": 0.0, "collectives": 0.0}
    dispatch.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    out = resilient_kmedian(pts, k_full, a, alive, local_iters=15, coord_iters=30, seed=seed,
                            session=sess, device=dev)
    sync()
    run = time.perf_counter() - t0
    timing, ex.timing = ex.timing, None
    report["alg1"] = {
        "cost": out.cost,
        "lockstep": ex.same_on_all_ranks(rec.b_full, xs_np, ws_np, out.centers, out.cost),
        "ranks": ex.gather_object({
            "prelude_s": prelude, "run_s": run, "local_s": timing["local"],
            "collectives_s": timing["collectives"],
            "rest_s": run - timing["local"] - timing["collectives"],
            "block": (xs.offset, xs.local.shape[0]), "shard_bytes": shard_bytes,
            "peak_gib": _peak(dev), "launches": dispatch.launch_counts()}),
    }
    del sess, xs, xs_np, ws_np, out
    _reset_peak(dev)

    # (c) the session rounds: device solves only, elastic patches written
    # by the owning rank.
    t0 = time.perf_counter()
    sess = ResilienceSession(cyclic_assignment(n_full, s, 4), executor=ex, device=dev,
                             elastic=ElasticPolicy(enabled=True, patience=2))
    scen = make_scenario("fixed", s, t=3, seed=seed + 3)
    written = ex.rows_written
    ests, round_s, patches = [], [], []
    dispatch.reset_launch_counts()
    for _ in range(rounds):
        step = next(scen)
        r0 = time.perf_counter()
        ev = sess.observe(step)
        ests.append(sess.step_cost(pts, centers_c, step.alive, median=True))
        round_s.append(time.perf_counter() - r0)
        patches.append(ev["moved_nodes"])
    stats = sess.stats.as_dict()
    xs_p = sess._resident[0]
    report["session"] = {
        "estimates": ests, "stats": stats, "moved_nodes": patches,
        "lockstep": ex.same_on_all_ranks(ests, sess.assignment.matrix, stats),
        "ranks": ex.gather_object({
            "seconds": time.perf_counter() - t0, "round_s": round_s,
            "rows_written": ex.rows_written - written,
            "block": (xs_p.offset, xs_p.local.shape[0]),
            "peak_gib": _peak(dev), "launches": dispatch.launch_counts()}),
    }
    del sess, xs_p
    _reset_peak(dev)

    # (d) the streaming service, cut in depth: every rank holds the tree.
    rows = n_full // 64
    sess = StreamingSession(d_full, k_full, num_nodes=8, scheme="fractional_repetition", ell=2,
                            fanout=4, leaf_size=leaf, seed=seed, device=dev, executor=ex,
                            scenario=make_scenario("iid", 8, p_straggler=0.15, seed=seed + 5))
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(n_batch):
        sess.ingest(pts[i * rows: (i + 1) * rows])
    sync()
    ingest_s = time.perf_counter() - t0
    xf, wf = sess.frontier()
    report["stream"] = {
        "frontier": (xf.cpu().numpy(), wf.cpu().numpy()),
        "levels": [len(lv) for lv in sess.buffer.levels],
        "lockstep": ex.same_on_all_ranks(xf, wf),
        "ranks": ex.gather_object({"ingest_s": ingest_s, "peak_gib": _peak(dev),
                                   "launches": dispatch.launch_counts(),
                                   "host_solves": sess.resilience.stats.host_solves}),
    }
    return report


# ---------------------------------------------------------------- LM meshes


def _same_in_shards(mesh, *values) -> bool:
    """Whether every model rank of each data shard holds the same bits."""
    import torch.distributed as dist

    from .distributed import digest

    shard = tuple(mesh.coord(a) for a in mesh.axis_names if a != "model")
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, (shard, digest(*values)))
    return len(set(seen)) == len({s for s, _ in seen})


def _whole(x: torch.Tensor, mesh, heads_dim=None) -> np.ndarray:
    """A rank's rows (and, given ``heads_dim``, its heads over ``model``)
    gathered whole, as a numpy array (a rank returns no tensor: its
    storage would be shared with the parent through a descriptor that the
    rank's exit can close before the parent reads it)."""
    from . import collectives as C
    from .sharding import gather_rows

    if heads_dim is not None:
        x = C.gather(x, mesh, "model", heads_dim)
    return gather_rows(x, mesh).float().cpu().numpy()


def _routing_for_rank(weights, cfg, mesh):
    """The selections one rank of ``mesh`` makes under given combine
    weights, in :func:`~repro_torch.models.moe.recorded_routing`'s form:
    per MoE layer, the experts of the rank's tokens (N_loc, k) and the
    kept tokens of its experts (E/m, C) at its shard's capacity.
    ``weights``: each layer's global combine weights (N, E), data shards'
    rows in order (the reference's pjit-routing ``w_sparse``)."""
    from ..models import moe as M
    from .sharding import _axes_of, local_rows

    _, model, _ = _axes_of(mesh)
    m = mesh.shape.get(model, 1) if model else 1
    e_loc = cfg.moe.num_experts // m
    r = mesh.coord(model) if model else 0
    log = []
    for w in weights:
        w = torch.as_tensor(np.asarray(w))
        if m > 1:
            w = local_rows(w, mesh)
        wl = w[:, r * e_loc:(r + 1) * e_loc]
        log += [M._topk(w, cfg.moe.top_k)[1], M._topk(wl.T, min(M.capacity(w.shape[0], cfg.moe), w.shape[0]))[1]]
    return log


def _serve_job(mesh, cfg, sd, tokens, decode_tokens, reference_routing=None):
    """Prefill of the global batch ``tokens`` (B, T), or (B, K, T) for a
    codebook model, and teacher-forced decode of ``decode_tokens`` (B, n)
    or (B, K, n) from an empty cache, on the rank's
    rows, each returned whole: the prefill's last-position logits, the
    decode logits (B, n, V) and, for an MoE model, each layer's K cache
    and the routing decisions that differ from ``reference_routing`` by
    layer (every rank's), then the same prefill with those decisions
    replayed."""
    from ..models import moe as M
    from ..models import transformer as T
    from .sharding import local_rows, make_context, shard_model

    ctx = make_context(mesh)
    model = shard_model(T.model_from_state_dict(cfg, sd), mesh)
    toks = local_rows(tokens, mesh)
    with torch.no_grad(), M.recorded_routing() as log:
        logits, cache = T.prefill(model, {"tokens": toks}, cfg, ctx)
    dec = local_rows(decode_tokens, mesh)
    dcache = T.init_cache(cfg, dec.shape[0], dec.shape[-1], device=toks.device, model=model, ctx=ctx)
    steps = []
    with torch.no_grad(), M.recorded_routing():
        for t in range(dec.shape[-1]):
            lg, dcache = T.decode_step(model, dcache, dec[..., t:t + 1], t, cfg, ctx)
            steps.append(lg[:, 0])
    out = {"prefill": _whole(logits, mesh), "decode": _whole(torch.stack(steps, 1), mesh),
           "lockstep": _same_in_shards(mesh, logits, steps)}
    if cfg.moe is not None:
        import torch.distributed as dist

        out["k_cache"] = [_whole(c["k"], mesh, heads_dim=2) for c in cache]
        if reference_routing is not None:
            ref = _routing_for_rank(reference_routing, cfg, mesh)
            differ = [None] * dist.get_world_size()
            dist.all_gather_object(differ, M.routing_differences(log, ref))
            with torch.no_grad(), M.recorded_routing(replay=ref):
                replayed, _ = T.prefill(model, {"tokens": toks}, cfg, ctx)
            out.update(differ=differ, replayed=_whole(replayed, mesh))
    return out


def _moe_job(mesh, cfg, sd, x):
    """One MoE layer (parameters ``sd`` under the names ``moe.*``) on the
    rank's rows of x (B, T, d) under both routings: each output whole and
    each aux loss."""
    from torch import nn

    from ..models import moe as M
    from .sharding import local_rows, make_context, shard_model

    holder = nn.Module()
    holder.moe = M.MoE(cfg, dtype=torch.float32, device="meta", generator=None)
    holder.load_state_dict(sd, assign=True)
    shard_model(holder, mesh)
    xl = local_rows(x, mesh)
    out, same = {}, []
    for routing in ("pjit", "local"):
        with torch.no_grad():
            o, aux = M.moe_apply(holder.moe, xl, cfg, make_context(mesh, moe_routing=routing))
        out[routing] = (_whole(o, mesh), float(aux))
        same += [o, aux]
    out["lockstep"] = _same_in_shards(mesh, *same)
    return out


def _slstm_job(mesh, cfg, sd, x):
    """One sLSTM block on the rank's rows of x (B, T, d), returned whole."""
    from ..models import xlstm as X
    from .sharding import local_rows, make_context, shard_model

    blk = X.SLSTMBlock(cfg, dtype=torch.float32, device="meta", generator=None)
    blk.load_state_dict(sd, assign=True)
    shard_model(blk, mesh)
    with torch.no_grad():
        y = X.slstm_apply(blk, local_rows(x, mesh), cfg, ctx=make_context(mesh))
    return {"out": _whole(y, mesh), "lockstep": _same_in_shards(mesh, y)}


def _decode_collectives(model, cfg, rows: int, slots: int, ctx, device) -> dict:
    """The collectives of one decode step (at slot 0 of a fresh cache)
    under ``ctx``: calls and bytes by kind."""
    from ..models import transformer as T
    from . import collectives as C

    cache = T.init_cache(cfg, rows, slots, device=device, model=model, ctx=ctx)
    tok = torch.zeros((rows, 1), dtype=torch.long, device=device)
    C.STATS.reset()
    with torch.no_grad():
        T.decode_step(model, cache, tok, 0, cfg, ctx)
    return {"calls": dict(C.STATS.calls), "bytes": dict(C.STATS.bytes)}


def _seq_decode_job(mesh, cfg, sd, decode_tokens, cache_layout: str = "seq", count: bool = False):
    """Teacher-forced decode of ``decode_tokens`` (B, n) from an empty
    cache of n slots under ``cache_layout``, on the
    rank's rows: the logits whole (B, n, V), the rank's cache shapes, each
    rank's (coordinates, first attention layer's K block) and, with
    ``count``, the collectives of one step under each layout."""
    import torch.distributed as dist

    from ..models import transformer as T
    from .sharding import local_rows, make_context, shard_model

    ctx = make_context(mesh, cache_layout=cache_layout)
    model = shard_model(T.model_from_state_dict(cfg, sd), mesh)
    dec = local_rows(decode_tokens, mesh)
    slots = dec.shape[-1]
    cache = T.init_cache(cfg, dec.shape[0], slots, device=dec.device, model=model, ctx=ctx)
    steps = []
    with torch.no_grad():
        for t in range(dec.shape[-1]):
            lg, cache = T.decode_step(model, cache, dec[:, t:t + 1], t, cfg, ctx)
            steps.append(lg[:, 0])
    first = next(c["k"] for c in cache if "k" in c)
    blocks = [None] * dist.get_world_size()
    dist.all_gather_object(blocks, (mesh.coords, first.float().cpu().numpy()))
    out = {"decode": _whole(torch.stack(steps, 1), mesh), "lockstep": _same_in_shards(mesh, steps),
           "k_shapes": [tuple(c["k"].shape) for c in cache if "k" in c], "k_blocks": blocks}
    if count:
        out["collectives"] = {layout: _decode_collectives(model, cfg, dec.shape[0], slots,
                                                          make_context(mesh, cache_layout=layout), dec.device)
                              for layout in ("feature", "seq")}
    return out


_LM_JOBS = {"serve": _serve_job, "moe": _moe_job, "slstm": _slstm_job, "seq_decode": _seq_decode_job}


def lm_job(kind: str, shape, **kw) -> dict:
    """One LM mesh job on a mesh of ``shape`` over the current ranks (axes
    ``("data", "model")``, or with ``pod`` for a 3-tuple)."""
    from .mesh import make_test_mesh

    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return _LM_JOBS[kind](make_test_mesh(tuple(shape), axes), **kw)


def lm_rank(jobs: list) -> list:
    """Every job ``(kind, shape, kwargs)`` of the list, in order (the rank
    program of the LM mesh tests)."""
    return [lm_job(kind, shape, **kw) for kind, shape, kw in jobs]


# ------------------------------------------------------ LM mesh, card


def _experts_of(log, r: int, e_loc: int) -> list:
    """A meshless routing record as model rank r of a model axis of
    E/e_loc ranks makes it: each token's experts as they are, the kept
    tokens of the rank's experts."""
    return [t if i % 2 == 0 else t[r * e_loc:(r + 1) * e_loc] for i, t in enumerate(log)]


@contextlib.contextmanager
def decode_taps(ctx=None):
    """Record the output of every op of the decode steps run while the
    block is open (``models.taps``), in call order and whole, as a list of
    (name, tensor on the host); a name reads ``step<t>/layer<i>/<op>``
    (``step<t>/embed`` and ``step<t>/logits`` outside the layers), counting
    the steps from the block's first.  Under an LM mesh (``ctx.mesh``) a
    rank's heads and experts are gathered over the model axis first, so
    that two runs' records compare op by op (:func:`first_difference`).
    Every rank must open it alike: the gathers are collectives."""
    from ..models import taps
    from . import collectives as C

    mesh = None if ctx is None else ctx.mesh
    axis = None if mesh is None else ctx.model_axis
    split = axis is not None and mesh.shape.get(axis, 1) > 1
    log, step, layer = [], [-1], [0]

    def record(op, t, dim):
        if split and dim is not None:
            t = C.gather(t, mesh, axis, dim)
        if op == "embed":
            step[0], layer[0] = step[0] + 1, 0
        inside = op not in ("embed", "logits")
        log.append((f"step{step[0]}/" + (f"layer{layer[0]}/{op}" if inside else op), t.detach().cpu()))
        if op == "block":
            layer[0] += 1

    with taps.recording(record):
        yield log


def first_difference(got: list, want: list, band: float = 0.0) -> Optional[tuple]:
    """The first op of two :func:`decode_taps` records (over the steps
    both ran) whose outputs are not the same bits, or with ``band`` > 0
    whose outputs part by more than ``band``: (its name,
    max|a-b|/max|b|), or None when every op agrees."""
    n = min(len(got), len(want))
    if [k for k, _ in got[:n]] != [k for k, _ in want[:n]]:
        raise ValueError(f"first_difference: records of {len(got)} and {len(want)} ops that do not line up")
    for (name, a), (_, b) in zip(got, want):
        if not torch.equal(a, b):
            a, b = a.float(), b.float()
            gap = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            if not gap <= band:
                return name, gap
    return None


def moe_mesh_oracle(served, cfg, tokens, kept: dict, out_dir: str, half_decode_steps: int) -> None:
    """The meshless oracles of :func:`moe_serve_rank`, written to
    ``out_dir``: ``full.pt`` (the meshless prefill of the 4 rows of
    ``tokens``: its last-position logits and routing record, which must be
    ``kept``'s bit for bit, the kept greedy ids and prompt, and the
    teacher-forced decode of prompt + ids, each step's logits and routing
    record) and, per half of the batch, ``half<s>.pt`` (the same prefill of
    its 2 rows, and the first ``half_decode_steps`` teacher-forced steps);
    each prefill's K caches ``<name>_k<layer>.pt``, read by the flip rule."""
    import os

    from ..models import moe as moe_mod
    from ..models import transformer as T

    ctx = T.ModelContext()
    seq = torch.cat([kept["prompt"], kept["ids"]], 1).to(tokens.device)

    def run(name, rows, steps):
        with moe_mod.recorded_routing() as log:
            logits, cache = T.prefill(served, {"tokens": tokens[rows]}, cfg, ctx)
        for li, c in enumerate(cache):
            torch.save(c["k"].cpu(), os.path.join(out_dir, f"{name}_k{li}.pt"))
        del cache
        dcache = T.init_cache(cfg, seq[rows].shape[0], steps, device=tokens.device)
        dec_logits, dec_routing = [], []
        with decode_taps() as taps:
            for t in range(steps):
                with moe_mod.recorded_routing() as dlog:
                    lg, dcache = T.decode_step(served, dcache, seq[rows, t:t + 1], t, cfg, ctx)
                dec_logits.append(lg[:, 0].cpu())
                dec_routing.append([x.cpu() for x in dlog])
        torch.save({"logits": logits.cpu(), "routing": [x.cpu() for x in log], "prompt": kept["prompt"][rows],
                    "ids": kept["ids"][rows], "decode_logits": torch.stack(dec_logits, 1),
                    "decode_routing": dec_routing, "decode_taps": taps}, os.path.join(out_dir, f"{name}.pt"))
        return logits, log

    logits, log = run("full", slice(0, 4), seq.shape[1])
    same = torch.equal(logits.cpu(), kept["logits"]) and all(
        torch.equal(a.cpu(), b) for a, b in zip(log, kept["routing"]))
    if not same:
        raise RuntimeError("moe_mesh_oracle: the meshless prefill is not the kept one bit for bit")
    for half in range(2):
        run(f"half{half}", slice(2 * half, 2 * half + 2), half_decode_steps)


def moe_serve_rank(seed: int, shape, oracle_dir: str, decode_steps: int, greedy: bool, warm_up: bool,
                   cfg_overrides: Optional[dict] = None, seq_len: int = 2048,
                   decode_slots: Optional[int] = None, seq_steps: int = 0, seq_band: float = 2e-2,
                   greedy_steps: Optional[int] = None) -> dict:
    """Phase "serve mesh" of ``chip_smoke.py`` on one rank: deepseek-moe-16b
    at full width and depth in bf16 on a ``shape`` (data, model) mesh,
    drawn by :func:`~repro_torch.launch.sharding.init_sharded` from
    ``seed`` (the meshless draw's values, the rank's blocks only), then the
    rank's rows of the 4 x 2048 prefill, held to the meshless oracle that
    ``oracle_dir`` holds for the rank's data shard (``full.pt`` or
    ``half<s>.pt``, their K caches ``<name>_k<layer>.pt``): by the flip
    rule, and with the oracle's routing replayed (a run that made none of
    its decisions differently is its own replay); then ``greedy`` decode
    4 x (16 + ``greedy_steps``) (the oracle's 32 by default; its ids are
    compared with the oracle's first ones), and ``decode_steps`` teacher-forced decode steps with the
    oracle's routing replayed, against its logits, in a cache of
    ``decode_slots`` slots (the oracle's count by default: the softmax
    and the products over the slots round by their count, so another
    count is another computation); where a step's logits are not the
    oracle's bits, the steps again with each op's output held to the
    oracle's (:func:`decode_taps`).  With ``seq_steps``, the first
    ``seq_steps`` of the oracle's teacher-forced steps again under
    ``cache_layout="seq"`` (all KV heads of the rank's block of the
    slots), the routing replayed, each step's logits held to the oracle's
    within ``seq_band`` (where one parts by more, the steps again under
    :func:`decode_taps` name the first op over the band); one step's
    collectives under each layout are counted.  Returns every rank's
    figures (seconds, launches, sums and their seconds and bytes, peak
    memory) and the gaps.  ``cfg_overrides`` and ``seq_len`` cut the
    model and the prompt (a rehearsal at the smoke size on the CPU)."""
    import os

    import torch.distributed as dist

    from ..models import attention as A
    from ..models import moe as M
    from ..models import transformer as T
    from ..models.registry import get_config
    from ..serve import decode as SD
    from . import collectives as C
    from .mesh import make_test_mesh
    from .sharding import init_sharded, local_rows, make_context

    from .distributed import _RANK_DEVICE, _sync

    dev = _RANK_DEVICE[0] or torch.device("cuda", torch.cuda.current_device())
    sync = lambda: _sync(dev)  # noqa: E731
    cfg = get_config("deepseek-moe-16b", **{"param_dtype": "bfloat16", **(cfg_overrides or {})})
    mesh = make_test_mesh(tuple(shape))
    ctx = make_context(mesh)
    nd = mesh.shape["data"]
    name = "full" if nd == 1 else f"half{mesh.coord('data')}"
    oracle = torch.load(os.path.join(oracle_dir, f"{name}.pt"))
    e_loc = cfg.moe.num_experts // mesh.shape["model"]
    r = mesh.coord("model")
    mine = lambda log: _experts_of(log, r, e_loc)  # noqa: E731

    def gap(a, b) -> float:
        a, b = a.float(), b.to(a.device).float()
        return float((a - b).abs().max() / b.abs().max())

    _reset_peak(dev)
    t0 = time.perf_counter()
    model = init_sharded(cfg, generator=torch.Generator(device=dev).manual_seed(seed), mesh=mesh)
    sync()
    draw_s = time.perf_counter() - t0
    held = sum(p.numel() for p in model.parameters())
    held_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    weights_gib = torch.cuda.memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
    tokens = torch.randint(0, cfg.vocab, (4, seq_len), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))
    toks = local_rows(tokens, mesh)
    (h0, h1), (k0, k1), _, tp = A.local_heads(model.blocks[0].attn, cfg, ctx)
    if warm_up:
        T.prefill(model, {"tokens": toks[:, :64]}, cfg, ctx)
    sync()
    C.STATS.timing = {}
    C.STATS.reset()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    with M.recorded_routing() as log:
        logits, cache = T.prefill(model, {"tokens": toks}, cfg, ctx)
        sync()
    prefill_s = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    sums = {"calls": dict(C.STATS.calls), "bytes": dict(C.STATS.bytes), "seconds": dict(C.STATS.timing)}
    k_shape = tuple(cache[0]["k"].shape)
    differ = M.routing_differences(log, mine(oracle["routing"]))
    first = next((li for li, n in enumerate(differ) if n), None)
    flip = {"differ": differ, "first": first}
    if first is None:
        flip["logits_gap"] = gap(logits[:, 0], oracle["logits"][:, 0])
    else:
        flip["k_gaps"] = []
        for li in range(first + 1):
            want = torch.load(os.path.join(oracle_dir, f"{name}_k{li}.pt"))[:, :, k0:k1].to(dev).float()
            got = cache[li]["k"].float()
            flip["k_gaps"].append(float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)))
    del cache
    if first is None:  # the replay would make the same selections: it is this run
        replayed = logits
    else:
        with M.recorded_routing(replay=mine(oracle["routing"])):
            replayed, cache = T.prefill(model, {"tokens": toks}, cfg, ctx)
        del cache
    replay_gap = gap(replayed[:, 0], oracle["logits"][:, 0])
    lockstep = _same_in_shards(mesh, logits, replayed)
    report = {"replay_gap": replay_gap}

    prompt = toks[:, :16].contiguous()
    if greedy:
        sync()
        t0 = time.perf_counter()
        ids = SD.greedy_generate(model, cfg, prompt, steps=greedy_steps or oracle["ids"].shape[1], ctx=ctx)
        sync()
        report["greedy_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / (prompt.shape[1] + ids.shape[1])
        report["greedy_steps"] = ids.shape[1]
        report["greedy_agree"] = float((ids.cpu() == oracle["ids"][:, :ids.shape[1]]).float().mean())
        lockstep = lockstep and _same_in_shards(mesh, ids)
    slots = decode_slots or oracle["decode_logits"].shape[1]
    seq = torch.cat([oracle["prompt"], oracle["ids"]], 1).to(dev)[:, :decode_steps]
    def counted_step(t, c, dcache, dctx, counts):
        """Decode step t with the oracle's routing replayed; step 0's
        collectives recorded in ``counts``."""
        if t == 0:
            C.STATS.reset()
        with M.recorded_routing(replay=mine(oracle["decode_routing"][t])):
            lg, dcache = T.decode_step(model, dcache, c[:, t:t + 1], t, cfg, dctx)
        if t == 0:
            counts.update(calls=dict(C.STATS.calls), bytes=dict(C.STATS.bytes))
        return lg, dcache

    cache_bytes = lambda dc: sum(t.numel() * t.element_size() for c in dc for t in c.values())  # noqa: E731
    dcache = T.init_cache(cfg, seq.shape[0], slots, device=dev, model=model, ctx=ctx)
    feature_step: dict = {}
    gaps = []
    sync()
    t0 = time.perf_counter()
    for t in range(seq.shape[1]):
        lg, dcache = counted_step(t, seq, dcache, ctx, feature_step)
        gaps.append(gap(lg[:, 0], oracle["decode_logits"][:, t]))
    sync()
    report.update(decode_gap=max(gaps), decode_ms_per_step=1e3 * (time.perf_counter() - t0) / seq.shape[1],
                  decode_steps=seq.shape[1], decode_gaps=gaps, decode_slots=slots, feature_step=feature_step,
                  feature_cache_bytes=cache_bytes(dcache))
    del dcache
    first_diff = None
    if any(gaps):  # the same steps again, each op's output held to the oracle's
        dcache = T.init_cache(cfg, seq.shape[0], slots, device=dev, model=model, ctx=ctx)
        with decode_taps(ctx) as taps:
            for t in range(seq.shape[1]):
                with M.recorded_routing(replay=mine(oracle["decode_routing"][t])):
                    _, dcache = T.decode_step(model, dcache, seq[:, t:t + 1], t, cfg, ctx)
        first_diff = first_difference(taps, oracle["decode_taps"])
        del dcache, taps
    report["decode_first_difference"] = first_diff
    if seq_steps:  # the oracle's decode again, the cache's slots split over the model axis
        sctx = make_context(mesh, cache_layout="seq")
        full = torch.cat([oracle["prompt"], oracle["ids"]], 1).to(dev)[:, :seq_steps]
        dcache = T.init_cache(cfg, full.shape[0], slots, device=dev, model=model, ctx=sctx)
        seq_step: dict = {}
        seq_gaps = []
        sync()
        t0 = time.perf_counter()
        for t in range(full.shape[1]):
            lg, dcache = counted_step(t, full, dcache, sctx, seq_step)
            seq_gaps.append(gap(lg[:, 0], oracle["decode_logits"][:, t]))
        sync()
        s_loc = dcache[0]["k"].shape[1]
        report.update(seq_steps=full.shape[1], seq_gaps=seq_gaps, seq_gap=max(seq_gaps),
                      seq_exact=sum(g == 0.0 for g in seq_gaps),
                      seq_gap_late=max(seq_gaps[s_loc:], default=None), seq_step=seq_step,
                      seq_ms_per_step=1e3 * (time.perf_counter() - t0) / full.shape[1],
                      seq_k_cache_shape=tuple(dcache[0]["k"].shape), seq_cache_bytes=cache_bytes(dcache))
        del dcache
        seq_first = None
        if max(seq_gaps) > seq_band:  # the steps again, each op's output held to the oracle's
            dcache = T.init_cache(cfg, full.shape[0], slots, device=dev, model=model, ctx=sctx)
            with decode_taps(sctx) as taps:
                for t in range(full.shape[1]):
                    _, dcache = counted_step(t, full, dcache, sctx, {})
            seq_first = first_difference(taps, oracle["decode_taps"], band=seq_band)
            del dcache, taps
        report["seq_first_difference"] = seq_first
    report["ranks"] = [None] * dist.get_world_size()
    dist.all_gather_object(report["ranks"], {
        "coords": mesh.coords, "heads": (h0, h1), "kv_heads": (k0, k1), "tensor_parallel": tp,
        "params_held": held, "params_bytes": held_bytes, "weights_gib": weights_gib, "draw_s": draw_s, "prefill_s": prefill_s,
        "launches": launches, "k_cache_shape": k_shape, "sums": sums, "flip": flip,
        "replay_gap": replay_gap, "peak_gib": _peak(dev),
        **{k: v for k, v in report.items() if k != "ranks"}})
    report["lockstep"] = lockstep
    return report


# ------------------------------------------------------ LM mesh training


def _gather_blocks(tensors: dict, mesh) -> tuple:
    """The whole tensors of every rank's blocks (``tensors``: name → (spec,
    the rank's block)) as numpy arrays on every rank, and whether the ranks
    that hold the same block hold the same bits: ({name: array}, bool)."""
    import torch.distributed as dist

    from .sharding import full_shape

    mine = {n: (tuple(spec) if spec else None, t.detach().float().cpu().numpy()) for n, (spec, t) in tensors.items()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (mesh.coords, mine))
    out, same = {}, True
    for name in mine:
        spec, blk = mine[name]
        spec = spec or (None,) * blk.ndim
        whole = np.full(full_shape(blk.shape, spec, mesh), np.nan, dtype=np.float32)
        for coords, theirs in every:
            b = theirs[name][1]
            at = tuple(slice(coords[mesh.axis_names.index(ax)] * n, (coords[mesh.axis_names.index(ax)] + 1) * n)
                       if ax is not None else slice(None) for ax, n in zip(spec, b.shape))
            held = whole[at]
            if not np.isnan(held).all():
                same = same and bool(np.array_equal(held, b))
            whole[at] = b
        out[name] = whole
    return out, same


def _blocks(model, tree: dict) -> dict:
    """(spec, tensor) by name for a dict keyed by ``model``'s parameter names."""
    specs = {n: getattr(p, "mesh_spec", None) for n, p in model.named_parameters()}
    return {n: (specs[n], t) for n, t in tree.items()}


def _collective_cases(mesh) -> dict:
    """The cases of :func:`_collectives_job`: name → (whether the input is
    one that the model ranks of a data shard hold alike, fn(x, a, c, w)
    → the output, whether the output is alike on the model ranks)."""
    from . import collectives as C

    axes = mesh.axis_names
    live = [a for a in axes if mesh.shape[a] > 1]
    cases = {"psum": (False, lambda x, a, c, w: C.psum(x, mesh, axes), True),
             "gather_axes": (False, lambda x, a, c, w: C.gather_axes(x, mesh, axes, -1), True)}
    for ax in live:
        cases[f"gather_{ax}"] = (False, lambda x, a, c, w, ax=ax: C.gather(x, mesh, ax, -1), ax == C.MODEL)
    if C.MODEL in live:
        cases["chain_model"] = (False, lambda x, a, c, w: C.chain(lambda s: s * c + a, x, mesh, C.MODEL), True)
        cases["enter"] = (True, lambda x, a, c, w: x, True)
        cases["split_linear"] = (True, lambda x, a, c, w: C.split_linear(x, w, mesh, C.MODEL), False)
        cases["split_linear_gathered"] = (
            True, lambda x, a, c, w: C.split_linear(x, w, mesh, C.MODEL, gather_out=True), True)
    return cases


def _collectives_job(mesh, seed: int) -> dict:
    """Each collective's backward under ``launch.collectives``' convention,
    every rank ``r`` with its own weights ``W_r``: the global loss L = Σ
    over ranks of Σ W_r ⊙ z_r, where z_r is the case's output (passed
    through ``collectives.enter`` when the model ranks hold it alike, since
    each reads it with its own weights), L summed by ``psum`` over every
    axis, and each rank backpropagating ``L / nd``.  A case's input is the
    rank's own ``X[r]``, or ``XR[d]``, which the model ranks of data shard
    ``d`` hold alike; ``a``, ``c`` (the chain's steps) and ``w`` (the split
    product's columns) are the rank's own.  Returns each case's gradients
    on every rank and the collectives it counted.  The inputs come from
    ``seed``; the test holds the gradients against autograd of the meshless
    L."""
    import torch.distributed as dist

    from . import collectives as C

    g = torch.Generator().manual_seed(seed)
    world = mesh.size
    r = dist.get_rank()
    d = r // mesh.shape.get(C.MODEL, 1)
    nd = world // mesh.shape.get(C.MODEL, 1)
    dev = _rank_dev()
    X = torch.randn((world, 3, 4), generator=g, dtype=torch.float64)
    XR = torch.randn((nd, 3, 4), generator=g, dtype=torch.float64)
    W = torch.randn((world, 3, 4 * world), generator=g, dtype=torch.float64)
    A = torch.randn((world, 3, 4), generator=g, dtype=torch.float64)
    Cm = torch.randn((world, 3, 4), generator=g, dtype=torch.float64)
    Wl = torch.randn((world, 4, 2), generator=g, dtype=torch.float64)
    out = {}
    for name, (alike_in, fn, alike_out) in _collective_cases(mesh).items():
        leaves = [t.clone().to(dev).requires_grad_(True) for t in ((XR[d] if alike_in else X[r]), A[r], Cm[r], Wl[r])]
        C.STATS.reset()
        with C.sequence(dev) as opened:
            y = fn(*leaves)
            z = C.enter(y, mesh, C.MODEL) if alike_out else y
            loss = C.psum((W[r, :, :z.shape[-1]].to(dev) * z).sum(), mesh, mesh.axis_names)
            if opened:
                loss = loss + 0.0 * C.sequence_token()
        grads = torch.autograd.grad(loss * (1.0 / nd), leaves, allow_unused=True)
        every = [None] * world
        dist.all_gather_object(every, [None if t is None else t.cpu().numpy() for t in grads])
        out[name] = {"grads": every, "calls": dict(C.STATS.calls)}
    return out


def _rank_dev():
    from .distributed import _RANK_DEVICE

    return _RANK_DEVICE[0] or torch.device("cpu")


def _step_job(mesh, cfg, sd, batches, ocfg: dict, remat: str = "none", accum_steps: int = 1,
              routing: str = "pjit", replay=None) -> dict:
    """``len(batches)`` steps of ``train_step.make_train_step`` from the
    weights ``sd``, each through its two halves: the first step's
    gradients (whole, as the step applies them), each step's loss and grad
    norm, the parameters and the first moments after the last step
    (whole), each moment's block shape beside ``state_shardings``', the
    attention calls a step, the first step's collectives, the MoE routing
    of the first forward (every rank's record), and whether the ranks
    agree.  ``replay``: a routing record for each rank (a list by rank) to
    replay in every forward."""
    import torch.distributed as dist

    from ..models import moe as M
    from ..models import transformer as T
    from ..train.optimizer import AdamWConfig, moment_blocks
    from ..train.train_step import init_train_state, make_train_step
    from . import collectives as C
    from .sharding import local_rows, make_context

    dev = _rank_dev()
    ctx = make_context(mesh, remat=remat, moe_routing=routing)
    state = init_train_state(cfg, generator=None, model=T.model_from_state_dict(cfg, {
        k: v.to(dev).clone() for k, v in sd.items()}), mesh=mesh)
    rank = dist.get_rank()

    def rows(batch):
        return {k: (v if k == "group_weights" else local_rows(v, mesh)).to(dev) for k, v in batch.items()}

    mine = None if replay is None else replay[rank]
    step = make_train_step(cfg, ctx, AdamWConfig(**ocfg), accum_steps=accum_steps)
    hist, first, grads_whole, same, routing_log = [], None, None, True, None
    for i, batch in enumerate(batches):
        record = cfg.moe is not None and i == 0
        C.STATS.reset()
        dispatch.reset_call_counts()
        with (M.recorded_routing(replay=mine) if record or mine is not None else contextlib.nullcontext()) as log:
            loss, metrics, grads = step.grads(state, rows(batch))
        calls = dispatch.call_counts().get("flash_attention", 0)
        if i == 0:
            first = {"loss": float(loss), "attention_calls": calls, "calls": dict(C.STATS.calls),
                     "bytes": dict(C.STATS.bytes), "tokens": float(metrics["tokens"])}
            grads_whole, same = _gather_blocks(_blocks(state.params, grads), mesh)
            if record:
                routing_log = [None] * dist.get_world_size()
                dist.all_gather_object(routing_log, [t.cpu().numpy() for t in log])
        state, m = step.apply(state, loss, metrics, grads)
        del grads
        hist.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "attention_calls": calls})
    params = dict(state.params.named_parameters())
    whole, same_p = _gather_blocks(_blocks(state.params, params), mesh)
    m_whole, _ = _gather_blocks(_blocks(state.params, state.opt.m), mesh)
    blocks = moment_blocks(params, mesh)
    moments = {n: (tuple(state.opt.m[n].shape), tuple(state.opt.v[n].shape), blocks[n]) for n in params}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (first["loss"], [h["loss"] for h in hist], [h["grad_norm"] for h in hist]))
    return {"first": first, "grads": grads_whole, "history": hist, "params": whole, "m": m_whole,
            "moments": moments, "routing": routing_log,
            "lockstep": same and same_p and len(set(map(repr, every))) == 1}


def _trainer_job(mesh, cfg, sd, tcfg_kw: dict, ocfg: dict) -> dict:
    """``Trainer(ctx=make_context(mesh))``'s host path from the weights
    ``sd``: its history, the parameters whole, and whether every rank
    recorded the same lockstep hash each step and holds the same blocks."""
    import torch.distributed as dist

    from ..models import transformer as T
    from ..train.optimizer import AdamWConfig
    from ..train.train_step import TrainState
    from ..train.trainer import Trainer, TrainerConfig
    from .sharding import make_context

    dev = _rank_dev()
    model = T.model_from_state_dict(cfg, {k: v.to(dev).clone() for k, v in sd.items()})
    t = Trainer(cfg, TrainerConfig(**tcfg_kw), None if ocfg is None else AdamWConfig(**ocfg), make_context(mesh),
                device=dev,
                initial_state=TrainState(params=model, opt=None, ef=None))
    state = t.run()
    whole, same = _gather_blocks(_blocks(state.params, dict(state.params.named_parameters())), mesh)
    hashes = [None] * dist.get_world_size()
    dist.all_gather_object(hashes, [h.get("lockstep") for h in t.history])
    return {"history": [{k: v for k, v in h.items() if k != "lockstep"} for h in t.history], "params": whole,
            "lockstep": same and len({repr(h) for h in hashes}) == 1,
            "hashes_per_step": len(hashes[0])}


def _compress_job(mesh, cfg, sd, batches, ocfg: dict, block: int) -> dict:
    """``len(batches)`` compressed steps of ``train_step.make_train_step``
    (``CompressionConfig(block=block)``) from the weights ``sd``, each
    through its two halves: the step's summed gradient whole (the one that
    ``apply`` compresses) and :func:`compression_check` of it, from the
    buffers whole before the step, against the buffers ``apply`` left; the
    loss.  Then the parameters and the buffers whole, the buffers' shapes
    beside ``state_shardings``' blocks, and whether the ranks agree."""
    from ..models import transformer as T
    from ..train.compression import CompressionConfig
    from ..train.optimizer import AdamWConfig, moment_blocks
    from ..train.train_step import init_train_state, make_train_step
    from .sharding import local_rows, make_context

    dev = _rank_dev()
    ccfg = CompressionConfig(block=block)
    state = init_train_state(cfg, generator=None, compression=ccfg, mesh=mesh, model=T.model_from_state_dict(
        cfg, {k: v.to(dev).clone() for k, v in sd.items()}))
    step = make_train_step(cfg, make_context(mesh), AdamWConfig(**ocfg), compression=ccfg)
    specs = {n: getattr(p, "mesh_spec", None) for n, p in state.params.named_parameters()}
    steps, same = [], True
    for batch in batches:
        rows = {k: (v if k == "group_weights" else local_rows(v, mesh)).to(dev) for k, v in batch.items()}
        loss, metrics, grads = step.grads(state, rows)
        grads_whole, alike = _gather_blocks(_blocks(state.params, grads), mesh)
        ef_whole, alike_ef = _gather_blocks(_blocks(state.params, state.ef), mesh)
        state, m = step.apply(state, loss, metrics, grads)
        check = compression_check({n: torch.from_numpy(a) for n, a in grads_whole.items()},
                                  {n: torch.from_numpy(a) for n, a in ef_whole.items()}, specs, mesh, dev, ccfg,
                                  applied=state.ef)
        steps.append({"grads": grads_whole, "check": check, "loss": float(m["loss"])})
        same = same and alike and alike_ef
        del grads
    params = dict(state.params.named_parameters())
    whole, alike = _gather_blocks(_blocks(state.params, params), mesh)
    ef, alike_ef = _gather_blocks(_blocks(state.params, state.ef), mesh)
    blocks = moment_blocks(params, mesh)
    return {"steps": steps, "params": whole, "ef": ef, "lockstep": same and alike and alike_ef,
            "ef_on_blocks": all(tuple(state.ef[n].shape) == blocks[n] for n in params)}


def _card_job(mesh, **kw) -> dict:
    """:func:`train_mesh_rank`, the card phase's rank program, on a mesh of
    ``mesh``'s shape (a rehearsal at a cut size)."""
    return train_mesh_rank(shape=mesh.sizes, **kw)


def _ckpt_job(mesh, **kw) -> dict:
    """:func:`ckpt_mesh_rank`, the card phase's checkpoint rank program, on
    a mesh of ``mesh``'s shape (at a cut size)."""
    return ckpt_mesh_rank(shape=mesh.sizes, **kw)


_TRAIN_JOBS = {"collectives": _collectives_job, "step": _step_job, "trainer": _trainer_job, "card": _card_job,
               "compress": _compress_job, "ckpt": _ckpt_job}


def train_lm_rank(jobs: list) -> list:
    """Every training job ``(kind, shape, kwargs)`` of the list, in order,
    each on a mesh of ``shape`` over the current ranks (the rank program of
    the LM mesh training tests)."""
    from .mesh import make_test_mesh

    out = []
    for kind, shape, kw in jobs:
        axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
        out.append(_TRAIN_JOBS[kind](make_test_mesh(tuple(shape), axes), **kw))
    return out


# ------------------------------------------------------ LM mesh training, card


def train_mesh_batches(cfg, seed: int, device, n: int, *, rows: int = 8, seq_len: int = 512,
                       data_vocab: int = 8192) -> list:
    """``n`` global batches of phase "train mesh": ``rows`` × ``seq_len``
    tokens over the ids below ``data_vocab`` drawn on ``device`` from
    ``seed`` (the same on every rank), 4 groups weighted (1, 0.5, 1, 0)."""
    g = torch.Generator(device=device).manual_seed(seed + 7)
    return [{"tokens": torch.randint(0, min(data_vocab, cfg.vocab), (rows, seq_len), generator=g, device=device),
             "group_weights": torch.tensor([1.0, 0.5, 1.0, 0.0], device=device)} for _ in range(n)]


def compression_check(grads: dict, ef: Optional[dict], specs: dict, mesh, dev, ccfg,
                      applied: Optional[dict] = None) -> dict:
    """The mesh compression of a global gradient, held on one rank: each
    whole tensor of ``grads`` (by parameter name, on the host), narrowed to
    the rank's block and compressed through the mesh path from the rank's
    block of the whole buffer in ``ef`` (None: zero), against the meshless
    ``compress_with_error_feedback`` of the whole tensor and buffer
    narrowed alike (the dequantized gradient and the buffer), tensor by
    tensor, so that no second copy of the gradient is held; with
    ``applied`` (the rank's buffers that a train step's ``apply`` left),
    the mesh path's buffers against those too.  Also ``lm_head``'s first
    straddling block: its columns on this rank, its scale at the rank's
    first row and the whole tensor's.  Phase "train mesh" (d) runs it on
    the meshless oracle's gradient, the tests on a mesh step's."""
    from ..train.compression import _quantize_split, compress_with_error_feedback, quantize_int8
    from . import collectives as C
    from .distributed import _sync
    from .sharding import _block_of

    sync = lambda: _sync(dev)  # noqa: E731
    C.STATS.reset()
    differ, unapplied, mesh_s = [], [], 0.0
    for name, whole in grads.items():
        spec = specs[name] or (None,) * whole.dim()
        w = whole.to(dev)
        e = torch.zeros_like(w) if ef is None else ef[name].to(dev)
        g, eb = _block_of(w, spec, mesh), _block_of(e, spec, mesh)
        sync()
        t0 = time.perf_counter()
        deq, ef_out = compress_with_error_feedback(ccfg, {name: g}, {name: eb}, mesh=mesh, specs={name: spec})
        sync()
        mesh_s += time.perf_counter() - t0
        wdeq, wef = compress_with_error_feedback(ccfg, {name: w}, {name: e})
        if not (torch.equal(deq[name], _block_of(wdeq[name], spec, mesh))
                and torch.equal(ef_out[name], _block_of(wef[name], spec, mesh))):
            differ.append(name)
        if applied is not None and not torch.equal(ef_out[name], applied[name]):
            unapplied.append(name)
        del w, e, g, eb, deq, ef_out, wdeq, wef
    pmax = {"calls": C.STATS.calls.get("pmax", 0), "bytes": C.STATS.bytes.get("pmax", 0)}
    out = {"bitwise": not differ, "differ": differ[:4], "tensors": len(grads), "mesh_s": mesh_s, "pmax": pmax,
           "applied": None if applied is None else not unapplied}
    head = grads["lm_head"]
    spec = specs["lm_head"] or (None,) * head.dim()
    axis, bk = spec[-1], ccfg.block
    blk = _block_of(head, spec, mesh)
    cols = blk.shape[-1]
    r = mesh.coord(axis) if axis is not None else 0
    first = r * cols
    b = first // bk if first % bk else ((first + cols) // bk if (first + cols) % bk else None)
    if axis is not None and cols % bk:  # blocks straddle: every rank joins the pmax
        _, scale, _ = _quantize_split(blk.to(dev).float(), bk, mesh, axis)
    if axis is not None and cols % bk and b is not None:  # the lowest block the rank shares with a neighbour
        row = mesh.coord(spec[0]) * blk.shape[0] if spec[0] is not None else 0
        _, whole_scale, _ = quantize_int8(head[row:row + 1].to(dev).float(), bk)
        out["lm_head"] = {"block": b, "columns": (max(first, b * bk), min(first + cols, (b + 1) * bk)),
                          "row": row, "scale": float(scale[0, b - first // bk, 0]),
                          "whole_scale": float(whole_scale[0, b, 0]),
                          "padded_block": -(-head.shape[-1] // bk) - 1}
    return out


def train_mesh_rank(seed: int, shape, oracle_path: str, remat: str = "full",
                    cfg_overrides: Optional[dict] = None, seq_len: int = 512, compress: bool = False) -> dict:
    """Phase "train mesh" of ``chip_smoke.py`` on one rank: qwen3-1.7b
    (f32 parameters, bf16 compute) on a ``shape`` (data, model) mesh, the
    rank's blocks drawn by ``init_sharded`` from ``seed`` (the meshless
    draw's values), one train step on its rows of the first batch of
    :func:`train_mesh_batches` under ``remat`` through the two halves of
    ``train_step.make_train_step``: the gradients it applies (reduced over
    the replicated axes) held block by block against the meshless oracle
    in ``oracle_path`` (``{"grads", "loss", "grad_norm", "top"}``, read
    memory-mapped), then AdamW on the blocks.  Returns every
    rank's figures: parameters held, peak memory, seconds, flash launches
    and their shape, the collectives' count, bytes and seconds by kind, the
    gaps, the moments' shapes against ``state_shardings``' blocks.
    ``cfg_overrides`` and ``seq_len`` cut the model (a rehearsal at the
    smoke size on the CPU).  ``compress`` (phase "train mesh" (d)): the
    state carries error-feedback buffers, :func:`compression_check` of the
    oracle's gradient runs first (the peak memory is then reset), and the step compresses
    (``CompressionConfig()``); the buffers' shapes are held to
    ``state_shardings``' blocks."""
    import torch.distributed as dist

    from ..models import attention as A
    from ..models.registry import get_config
    from ..train.compression import CompressionConfig
    from ..train.optimizer import AdamWConfig, moment_blocks
    from ..train.train_step import init_train_state, make_train_step
    from . import collectives as C
    from .distributed import _RANK_DEVICE, _sync
    from .mesh import make_test_mesh
    from .sharding import _block_of, local_rows, make_context

    dev = _RANK_DEVICE[0] or torch.device("cpu")
    sync = lambda: _sync(dev)  # noqa: E731
    cfg = get_config("qwen3-1.7b", **(cfg_overrides or {}))
    mesh = make_test_mesh(tuple(shape))
    ctx = make_context(mesh, remat=remat)
    ccfg = CompressionConfig() if compress else None
    _reset_peak(dev)
    t0 = time.perf_counter()
    state = init_train_state(cfg, generator=torch.Generator(device=dev).manual_seed(seed), mesh=mesh,
                             compression=ccfg)
    sync()
    draw_s = time.perf_counter() - t0
    params = dict(state.params.named_parameters())
    held = sum(p.numel() for p in params.values())
    held_bytes = sum(p.numel() * p.element_size() for p in params.values())
    check = None
    if compress:
        specs = {n: getattr(p, "mesh_spec", None) for n, p in params.items()}
        check = compression_check(torch.load(oracle_path, mmap=True)["grads"], None, specs, mesh, dev, ccfg)
        check["peak_gib"] = _peak(dev)
        _reset_peak(dev)
    batch = train_mesh_batches(cfg, seed, dev, 1, seq_len=seq_len)[0]
    rows = {"tokens": local_rows(batch["tokens"], mesh), "group_weights": batch["group_weights"]}
    (h0, h1), (k0, k1), pick, _ = A.local_heads(state.params.blocks[0].attn, cfg, ctx)
    kv = len(pick) if pick is not None else k1 - k0
    flash_shape = (rows["tokens"].shape[0], seq_len, seq_len, h1 - h0, kv, cfg.head_dim)
    C.STATS.timing = {}
    C.STATS.reset()
    dispatch.reset_launch_counts()
    sync()
    step = make_train_step(cfg, ctx, AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=8), compression=ccfg)
    t0 = time.perf_counter()
    loss, metrics, grads = step.grads(state, rows)
    sync()
    grad_s = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    specs = {n: getattr(p, "mesh_spec", None) for n, p in params.items()}
    t0 = time.perf_counter()
    state, om = step.apply(state, loss, metrics, grads)
    opt = state.opt
    sync()
    update_s = time.perf_counter() - t0
    sums = {"calls": dict(C.STATS.calls), "bytes": dict(C.STATS.bytes), "seconds": dict(C.STATS.timing)}
    C.STATS.timing = None
    peak = _peak(dev)
    oracle = torch.load(oracle_path, mmap=True)
    floor = 1e-5 * oracle["top"]
    worst, where = 0.0, None
    for name, g in grads.items():
        want = _block_of(oracle["grads"][name], specs[name] or (None,) * g.dim(), mesh).to(dev)
        gap = float((g.float() - want).abs().max()) / max(float(want.abs().max()), floor)
        if gap > worst:
            worst, where = gap, name
        del want
    blocks = moment_blocks(params, mesh)
    moments_ok = all(tuple(opt.m[n].shape) == tuple(opt.v[n].shape) == blocks[n] for n in params)
    ef_ok = None if not compress else all(tuple(state.ef[n].shape) == blocks[n] for n in params)
    mine = {"compression": check, "ef_ok": ef_ok,
            "coords": mesh.coords, "params_held": held, "params_bytes": held_bytes, "draw_s": draw_s,
            "grad_s": grad_s,
            "update_s": update_s, "step_s": grad_s + update_s, "peak_gib": peak, "launches": launches,
            "flash_shape": flash_shape, "sums": sums, "grad_gap": worst, "grad_gap_at": where,
            "loss": float(loss), "grad_norm": float(om["grad_norm"]), "tokens": float(metrics["tokens"]),
            "moments_ok": moments_ok}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    return {"ranks": ranks, "oracle_loss": oracle["loss"], "oracle_grad_norm": oracle["grad_norm"]}


# ------------------------------------------------------ LM mesh checkpoints, card


def _digests(tensors: dict) -> dict:
    """A digest of each tensor by name: the int64 sums, on its device, of
    its 32-bit words and of every other word."""
    sums = {}
    for key, t in tensors.items():
        words = t.detach().contiguous().reshape(-1).view(torch.int32)
        sums[key] = torch.stack([words.sum(dtype=torch.int64), words[::2].sum(dtype=torch.int64)])
    stacked = torch.stack(list(sums.values())).cpu().tolist()
    return dict(zip(sums, map(tuple, stacked)))


def block_digests(state) -> dict:
    """The digest of each tensor of a train state by checkpoint name (the
    rank's blocks under a mesh)."""
    from ..train.checkpoint import _named_tensors

    return _digests({key: t for key, (t, _) in _named_tensors(state).items()})


def narrowed_digests(state, specs: dict, shape) -> dict:
    """:func:`block_digests` of the blocks that each rank of a ``shape``
    (data, model) mesh holds of a whole (meshless) train state, by the
    rank's coordinates, from the parameters' ``specs`` (by parameter name)
    that the ranks hold."""
    from ..train.checkpoint import _named_tensors
    from .mesh import Mesh
    from .sharding import _block_of

    out = {}
    for coords in np.ndindex(*shape):
        grid = Mesh(("data", "model"), tuple(shape), coords=tuple(int(c) for c in coords))
        blocks = {}
        for key, (t, _) in _named_tensors(state).items():
            spec = specs[key.split("/")[-1]]  # params/<name>, opt/m/<name>, …: names hold no "/"
            blocks[key] = _block_of(t.detach(), spec or (None,) * t.dim(), grid)
        out[grid.coords] = _digests(blocks)
    return out


def ckpt_mesh_rank(seed: int, shape, ckpt_dir: str, restore_dirs: dict, cfg_overrides: Optional[dict] = None,
                   seq_len: int = 512, data_vocab: int = 8192, steps: int = 3) -> dict:
    """Phase "train mesh" (e) of ``chip_smoke.py`` on one rank:
    qwen3-1.7b (``cfg_overrides`` cut it) through
    ``Trainer(ctx=..., ckpt_dir=...)`` on a ``shape`` (data, model) mesh
    with compression, drawn from ``seed``: ``steps`` steps uninterrupted;
    ``steps - 1`` steps with a checkpoint in ``ckpt_dir``; a new trainer
    that resumes from it (its straggler stream advanced past those steps)
    and runs the last.
    Then each checkpoint of ``restore_dirs`` (label → directory) restored
    onto the mesh into a fresh state.  Returns every rank's figures: each
    run's history (its lockstep hashes aside) and the digests
    (:func:`block_digests`) of its state at its end, with the trainer's
    write seconds (the history's ``ckpt_write_s``) and the resume's read
    seconds (``ckpt_read_s``); each restore's step, optimizer step, digests
    and read seconds; the parameters' specs and the peak memory.  The
    checkpoint tests run it at the smoke size."""
    import torch.distributed as dist

    from ..models.registry import get_config
    from ..train.checkpoint import restore_checkpoint
    from ..train.compression import CompressionConfig
    from ..train.optimizer import AdamWConfig
    from ..train.train_step import init_train_state
    from ..train.trainer import Trainer, TrainerConfig
    from .distributed import _RANK_DEVICE, _sync
    from .mesh import make_test_mesh
    from .sharding import make_context

    dev = _RANK_DEVICE[0] or torch.device("cpu")
    cfg = get_config("qwen3-1.7b", **(cfg_overrides or {}))
    mesh = make_test_mesh(tuple(shape))
    ctx = make_context(mesh)
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=8)
    runs, restored = {}, {}
    _reset_peak(dev)
    first = steps - 1
    # The first run writes its checkpoint at its end; the resumed run writes none.
    for label, n_steps, ckpt, skip, every in (("whole", steps, None, 0, first), ("first", first, ckpt_dir, 0, first),
                                              ("resumed", steps, ckpt_dir, first, steps + 1)):
        tcfg = TrainerConfig(num_groups=4, num_shards=4, redundancy=2, scheme="cyclic", microbatch=1,
                             seq_len=seq_len, steps=n_steps, ckpt_every=every, ckpt_dir=ckpt, ckpt_keep=1, seed=seed,
                             data_vocab=data_vocab, straggler_deadline=1.4, warm_start=False,
                             compression=CompressionConfig())
        t = Trainer(cfg, tcfg, ocfg, ctx, device=dev)
        for _ in range(skip):
            next(t.scenario)
        t0 = time.perf_counter()
        state, start = t.init_state()
        state = t.run(state, start_step=start)
        _sync(dev)
        runs[label] = {"start": start, "history": [{k: v for k, v in h.items() if k != "lockstep"}
                                                   for h in t.history],
                       "seconds": time.perf_counter() - t0, "read_s": t.ckpt_read_s, "digests": block_digests(state)}
        specs = {n: getattr(p, "mesh_spec", None) for n, p in state.params.named_parameters()}
        del state, t
    for label, path in restore_dirs.items():
        template = init_train_state(cfg, generator=torch.Generator(device=dev).manual_seed(seed + 1),
                                    compression=CompressionConfig(), mesh=mesh)
        _sync(dev)
        t0 = time.perf_counter()
        state, step = restore_checkpoint(path, template, mesh=mesh)
        _sync(dev)
        restored[label] = {"step": step, "opt_step": state.opt.step, "read_s": time.perf_counter() - t0,
                           "digests": block_digests(state)}
        del state, template
    mine = {"coords": mesh.coords, "runs": runs, "restored": restored, "specs": specs, "peak_gib": _peak(dev)}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    return {"ranks": ranks}


# ------------------------------------------------------ the dry run's twin


def dryrun_twin_rank(arch: str, kind: str, shape, batch: int, seq_len: int, cfg_overrides: dict,
                     remat: str = "full", num_groups: Optional[int] = None, compress: bool = False,
                     seed: int = 0) -> dict:
    """The real run of a ``launch.dryrun`` cell on a ``shape`` mesh of the
    current ranks, as the card's mesh phases run it: the rank's blocks
    drawn from ``seed``, its rows of a ``batch`` x ``seq_len`` batch of
    random tokens, and the step (``kind`` ``"train"``, its gradients
    compressed when ``compress``, or ``"prefill"``, its routing recorded)
    run once under ``launch.op_analysis``.  Returns every rank's parameter
    bytes, FLOPs and collectives by kind."""
    import torch.distributed as dist

    from ..models import moe as M
    from ..models import transformer as T
    from ..models.registry import get_config
    from ..train.compression import CompressionConfig
    from ..train.optimizer import AdamWConfig
    from ..train.train_step import init_train_state, make_train_step
    from .mesh import make_test_mesh
    from .op_analysis import analyze
    from .sharding import init_sharded, local_rows, make_context

    cfg = get_config(arch, **cfg_overrides)
    mesh = make_test_mesh(tuple(shape))
    ctx = make_context(mesh, remat=remat)
    gen = torch.Generator().manual_seed(seed)
    model = init_sharded(cfg, generator=gen, mesh=mesh)
    tokens = local_rows(torch.randint(0, cfg.vocab, (batch, seq_len), generator=gen), mesh)
    if kind == "train":
        groups = num_groups or mesh.shape.get("data", 1)
        ccfg = CompressionConfig() if compress else None
        state = init_train_state(cfg, generator=gen, model=model, mesh=mesh, compression=ccfg)
        step = make_train_step(cfg, ctx, AdamWConfig(), compression=ccfg, num_groups=groups)
        got = analyze(step, state, {"tokens": tokens, "group_weights": torch.ones((groups,))})
    else:
        with M.recorded_routing():
            got = analyze(T.prefill, model, {"tokens": tokens}, cfg, ctx)
    mine = {"coords": mesh.coords, "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
            "flops": got["flops"], "by_kind": got["collectives_by_kind"],
            "calls_by_kind": got["collective_calls_by_kind"], "kernel_ops": got["kernel_ops"]}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    return {"ranks": ranks}

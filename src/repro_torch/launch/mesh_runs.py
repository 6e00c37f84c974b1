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
  shape of SIFT1M.
"""

from __future__ import annotations

import time

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
    "train", "train_rank",
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

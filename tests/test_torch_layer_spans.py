"""The spans at the layer boundaries of the port's two measured paths:
Algorithm 1 through ``ResilienceSession.kmedian`` and the trainer's
``device_recovery=True`` step.

The benchmark reads these spans by name (``perfbench/metrics/``), so the
names, where each span sits in the tree and how many a unit records are
held here: a solve's spans are roots (the benchmark's own wrappers are not
program spans), a step's nest under ``trainer.step``; a solve records at
most 16 spans and a step at most 24, so a traced window stays far inside
the ring.  The clustering engine's spans also fire in the stream's
compactions, three rows a compaction.  With ``REPRO_OBS=0`` nothing is
recorded and the answers are the same, bit for bit.
"""

from __future__ import annotations

import collections
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import qwen3_4b
from repro_torch.core.assignment import cyclic_assignment
from repro_torch.core.resilience import ResilienceSession
from repro_torch.obs import trace as trace_mod
from repro_torch.stream.session import StreamingSession
from repro_torch.train.trainer import Trainer, TrainerConfig

SOLVE_BUDGET = 16
STEP_BUDGET = 24
NODES, GROUPS = 6, 4


def recorded(fn):
    """(fn(), the spans it recorded) on a fresh ring, the old one restored."""
    prev = trace_mod._BUFFER
    buf = trace_mod.configure_buffer(4096)
    try:
        return fn(), buf.rows()
    finally:
        trace_mod._BUFFER = prev


def solves():
    """Two solves on one session, each with a pattern of its own: the
    second finds the pack and the device copies cached, and records the
    same spans."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(600, 4)).astype(np.float32)
    sess = ResilienceSession(cyclic_assignment(600, NODES, 3), device="cpu")
    out = []
    for u in range(2):
        alive = np.ones(NODES, dtype=bool)
        alive[u] = False
        out.append(recorded(lambda: sess.kmedian(pts, 4, alive, local_iters=3, coord_iters=3, seed=u, device="cpu")))
    return out


def train(tmp_path, executor="local"):
    """Two steps of the tiny trainer's fused path: all groups alive, then
    groups 0 and 2, which hold the same shards, lost (the host fallback).
    ``executor="mesh"`` runs them on a world of one."""
    path = tmp_path / "alive.jsonl"
    path.write_text("".join(json.dumps({"alive": a}) + "\n" for a in ([1, 1, 1, 1], [0, 1, 0, 1])))
    cfg = dataclasses.replace(qwen3_4b.smoke_config(), compute_dtype="float32").validate()
    tc = TrainerConfig(num_groups=GROUPS, num_shards=4, redundancy=2, scheme="fr", microbatch=1, seq_len=16, steps=2,
                       straggler_scenario="trace", scenario_kwargs={"path": str(path)}, device_recovery=True,
                       resident_steps=1, warm_start=False, executor=executor)
    t = Trainer(cfg, tc, device="cpu")
    state = t.run()
    return [h["loss"] for h in t.history], {n: p.detach().clone() for n, p in state.params.named_parameters()}


def by_step(rows):
    """{trainer.step span id: the spans of its subtree, itself included}."""
    parent = {r["span"]: r["parent"] for r in rows}

    def root(i):
        while parent.get(i) is not None:
            i = parent[i]
        return i

    steps = collections.defaultdict(list)
    for r in rows:
        steps[root(r["span"])].append(r)
    return steps


ONE_SOLVE = {"session.recovery_solve": 1, "session.fingerprint": 1, "kmeans.seed": 2, "kmeans.iterate": 2}


@pytest.fixture(scope="module")
def solve_spans():
    return solves()


@pytest.mark.parametrize("which", [0, 1])
def test_a_solve_records_its_span_tree(solve_spans, which):
    """One fingerprint a solve, one recovery solve a new pattern, and two
    seedings and iterations: the local solves' batch over the 6 nodes'
    shards, then the coordinator's over their 6·4 centers, each a root."""
    _, rows = solve_spans[which]
    assert collections.Counter(r["name"] for r in rows) == ONE_SOLVE
    assert all(r["parent"] is None for r in rows)
    seeds = [r["attrs"] for r in rows if r["name"] == "kmeans.seed"]
    assert [(a["B"], a["k"]) for a in seeds] == [(NODES, 4), (1, 4)]
    assert seeds[1]["n"] == NODES * 4
    assert [r["attrs"] for r in rows if r["name"] == "kmeans.iterate"] == [
        {"iters": 3, "median": True}, {"iters": 3, "median": True}]
    assert {r["name"]: r["attrs"] for r in rows}["session.fingerprint"] == {"bytes": 600 * 4 * 4}


@pytest.fixture(scope="module")
def train_spans(tmp_path_factory):
    return recorded(lambda: train(tmp_path_factory.mktemp("spans")))


@pytest.fixture(scope="module")
def mesh_train_spans(tmp_path_factory):
    return recorded(lambda: train(tmp_path_factory.mktemp("spans"), "mesh"))


@pytest.mark.parametrize("executor", ["local", "mesh"])
def test_a_step_records_its_span_tree(executor, request):
    """Each step: one in-step recovery solve; each group's forward,
    backward and combine; the combine's scale and cast; one AdamW.  The
    host fallback's step adds its host recovery solve.  The mesh executor's
    step records the same tree."""
    _, rows = request.getfixturevalue("train_spans" if executor == "local" else "mesh_train_spans")
    names = {r["span"]: r["name"] for r in rows}
    steps = list(by_step(rows).values())
    assert len(steps) == 2 and all(names[s[-1]["span"]] == "trainer.step" for s in steps)
    common = {"trainer.step": 1, "executor.masked_reduce": 1, "recovery.device_solve": 1, "train.forward": GROUPS,
              "train.backward": GROUPS, "train.combine": GROUPS + 1, "optimizer.adamw": 1}
    assert collections.Counter(r["name"] for r in steps[0]) == common
    assert collections.Counter(r["name"] for r in steps[1]) == {**common, "session.recovery_solve": 1}
    links = {("executor.masked_reduce", "trainer.step"), ("recovery.device_solve", "executor.masked_reduce"),
             ("train.forward", "executor.masked_reduce"), ("train.backward", "executor.masked_reduce"),
             ("train.combine", "executor.masked_reduce"), ("train.combine", "trainer.step"),
             ("optimizer.adamw", "trainer.step")}
    for s, extra in zip(steps, (set(), {("session.recovery_solve", "trainer.step")})):
        assert {(r["name"], names[r["parent"]]) for r in s if r["parent"] is not None} == links | extra
        assert sorted(r["attrs"].get("group") for r in s if r["name"] == "train.combine"
                      and names[r["parent"]] == "executor.masked_reduce") == list(range(GROUPS))


def ingests():
    """Three stream ingests of four leaves each (fanout 4): every ingest
    reduces four leaves and merges them one level up."""
    sess = StreamingSession(d=4, k=3, num_nodes=4, leaf_size=64, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    return [recorded(lambda: sess.ingest(rng.normal(size=(256, 4)).astype(np.float32))) for _ in range(3)]


@pytest.mark.parametrize("path", ["solve", "step", "ingest"])
def test_a_unit_stays_inside_its_span_budget(path, solve_spans, train_spans):
    """A solve and a step stay inside their budgets.  A stream ingest
    records one span, three a compaction (the compaction and its seeding
    and iterations, which nest in it) and one recovery solve a new pattern."""
    if path == "solve":
        assert max(len(rows) for _, rows in solve_spans) <= SOLVE_BUDGET
    elif path == "step":
        assert max(len(s) for s in by_step(train_spans[1]).values()) <= STEP_BUDGET
    else:
        for i, (report, rows) in enumerate(ingests()):
            compactions = report["leaves"] + report["compactions"]
            assert compactions == 5
            names = {r["span"]: r["name"] for r in rows}
            assert len(rows) == 1 + 3 * compactions + (i == 0)
            for r in rows:
                if r["name"] in ("kmeans.seed", "kmeans.iterate"):
                    assert names[r["parent"]] == "stream.compaction"


@pytest.mark.parametrize("path", ["solve", "step"])
def test_obs_off_records_nothing_and_answers_alike(path, solve_spans, train_spans, monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_OBS", "0")
    if path == "solve":
        off = solves()
        for (want, _), (got, rows) in zip(solve_spans, off):
            assert rows == []
            for key in ("centers", "summary_points", "summary_weights"):
                np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
            assert got.cost == want.cost
    else:
        (losses, params), rows = recorded(lambda: train(tmp_path))
        assert rows == []
        want_losses, want_params = train_spans[0]
        assert losses == want_losses
        for n, p in params.items():
            assert torch.equal(p, want_params[n]), n

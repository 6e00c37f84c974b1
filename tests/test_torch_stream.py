"""The port's streaming layer against the reference's, on the CPU.

``repro_torch.stream`` beside ``repro.stream`` at the sizes of
``tests/test_stream.py`` (d=2, s=6, fanout=3, leaf=64, m=16, k=3), the
same numpy batches and straggler masks fed to both.  ``torch.Generator``
and ``jax.random`` draw different streams, so:

* exact: tree structure (buckets per level, each bucket's level and seq),
  every counter (leaf and level compactions, blocking compactions, host
  solves, cache hits, elastic patches), the recovered per-bucket masses
  and merged weights, query answers for given centers (indices outside near
  ties; distances within rtol 1e-5, atol 1e-6) and query buckets;
* within the port: the FR tree under a coverage-preserving straggler
  pattern equals the all-alive tree at 1e-5 (the reference's tolerance);
* in the reference's bands: merged coresets within 0.35 of the full cost
  and 0.6 of each other; the streamed model's frontier cost within 0.35 of
  its cost on every ingested point (at the session's default leaf 512);
* carried over by ``convert.streaming_state_from_jax``: the frontier
  exactly, and ``lloyd`` from the same ``init_centers`` over it within
  1e-4 of the reference's.

The mesh tests of ``tests/test_stream.py`` have their twins in
``tests/test_torch_mesh.py``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import ElasticPolicy as RefElasticPolicy
from repro.core import ResilienceSession as RefResilienceSession
from repro.core import fractional_repetition_assignment as ref_fr
from repro.core import make_assignment as ref_make_assignment
from repro.core import make_scenario as ref_make_scenario
from repro.stream import StreamBuffer as RefStreamBuffer
from repro.stream import StreamingSession as RefStreamingSession
from repro.stream.buffer import Bucket as RefBucket
from repro.stream.query import QueryEngine as RefQueryEngine
from repro_torch import convert
from repro_torch.core import ElasticPolicy, ResilienceSession, make_scenario
from repro_torch.stream import StreamBuffer, StreamingSession
from repro_torch.stream.buffer import Bucket
from repro_torch.stream.query import QueryEngine

D, S, FANOUT, LEAF, M, K = 2, 6, 3, 64, 16, 3
CPU = "cpu"


def _buffers(seed=0, assignment=None):
    """(reference buffer, port buffer) over one FR(3 buckets, 6 nodes, ℓ=2)
    assignment: bucket j lives on nodes {j, 3+j}."""
    a = assignment if assignment is not None else ref_fr(FANOUT, S, 2)
    ref = RefStreamBuffer(D, K, session=RefResilienceSession(a), leaf_size=LEAF, coreset_size=M, seed=seed)
    port = StreamBuffer(
        D, K, session=ResilienceSession(convert.to_assignment(a.matrix, a.scheme, a.params), device=CPU),
        leaf_size=LEAF, coreset_size=M, seed=seed, device=CPU,
    )
    return ref, port


def _batches(n_batches, batch=LEAF, seed=0, d=D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(batch, d)).astype(np.float32) for _ in range(n_batches)]


def _structure(buf):
    return (
        [[(b.level, b.seq, b.size) for b in lv] for lv in buf.levels],
        buf.leaf_compactions, buf.compactions, buf.blocking_compactions,
        buf.num_buckets, buf.summary_points, buf._pending_n,
    )


def _np(t):
    return t.cpu().numpy()


def _session(pkg, scenario=None, **kw):
    base = dict(num_nodes=S, fanout=FANOUT, leaf_size=LEAF, coreset_size=M, scenario=scenario, seed=0)
    if pkg == "ref":
        return RefStreamingSession(D, K, **base, **kw)
    return StreamingSession(D, K, **base, device=CPU, **kw)


# ----------------------------------------------------------- tree mechanics


def test_tree_structure_and_bounded_memory_match_the_reference():
    ref, port = _buffers()
    for b in _batches(12):
        assert ref.add_batch(b) == port.add_batch(b)  # the per-batch reports
        assert all(len(lv) < FANOUT for lv in port.levels)
        assert port.summary_points == port.num_buckets * M
    assert _structure(port) == _structure(ref)
    assert (port.leaf_compactions, port.compactions) == (12, 5)
    assert [len(lv) for lv in port.levels] == [0, 1, 1]
    x, w = port.frontier()
    assert x.shape == (2 * M, D) and w.shape == (2 * M,) and x.device.type == CPU
    assert float(w.sum()) == pytest.approx(12 * LEAF, rel=0.5)  # the reference's mass band


def test_partial_batches_pop_exact_leaves():
    ref, port = _buffers()
    rng = np.random.default_rng(3)
    for n in (10, 100, 7, 64, 30):  # misaligned with LEAF
        b = rng.normal(size=(n, D)).astype(np.float32)
        ref.add_batch(b)
        port.add_batch(b)
    assert _structure(port) == _structure(ref)
    x, _ = port.frontier()
    xr, wr = ref.frontier()
    assert x.shape[0] == xr.shape[0] == port.summary_points + 211 % LEAF
    # The pending leaf rides along at weight 1, bit for bit.
    np.testing.assert_array_equal(_np(x)[-(211 % LEAF):], xr[-(211 % LEAF):])


def test_tree_deterministic_given_inputs():
    _, b1 = _buffers(seed=5)
    _, b2 = _buffers(seed=5)
    for b in _batches(7, seed=9):
        b1.add_batch(b)
        b2.add_batch(b)
    for t1, t2 in zip(b1.frontier(), b2.frontier()):
        assert torch.equal(t1, t2)


def test_buffer_rejects_bad_shapes_and_sizes():
    _, port = _buffers()
    with pytest.raises(ValueError, match="expected"):
        port.add_batch(np.zeros((4, D + 1), np.float32))
    with pytest.raises(ValueError, match="coreset_size"):
        StreamBuffer(D, K, session=port.session, leaf_size=8, coreset_size=9, device=CPU)


# ------------------------------------------------- coreset composability


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_of_coresets_stays_in_the_reference_band(seed):
    """merge(coreset(P1), coreset(P2)) within 0.35 of the full cost and 0.6
    of coreset(P1 ∪ P2): the merge-and-reduce invariant, in the bands of
    ``tests/test_stream.py``."""
    from repro.data.synthetic import gaussian_mixture
    from repro_torch.core import clustering_cost, merge_coresets, sensitivity_coreset

    rng = np.random.default_rng(seed)
    p1, _, _ = gaussian_mixture(600, K, D, rng=rng)
    p2, _, _ = gaussian_mixture(600, K, D, box=2.0, rng=rng)
    union = torch.from_numpy(np.concatenate([p1, p2]))
    g = torch.Generator().manual_seed(seed)
    merged = merge_coresets(
        sensitivity_coreset(torch.from_numpy(p1), K, 200, generator=g),
        sensitivity_coreset(torch.from_numpy(p2), K, 200, generator=g),
    )
    direct = sensitivity_coreset(union, K, 400, generator=g)
    for i in range(3):
        C = torch.from_numpy(rng.normal(size=(K, D)).astype(np.float32))
        full = float(clustering_cost(union, C))
        via_merge = float(clustering_cost(merged.points, C, weights=merged.weights))
        via_direct = float(clustering_cost(direct.points, C, weights=direct.weights))
        assert abs(via_merge - full) / full < 0.35, (seed, i)
        assert abs(via_direct - full) / full < 0.35, (seed, i)
        assert abs(via_merge - via_direct) / full < 0.6, (seed, i)


# ------------------------------------------- straggler-proof compactions


def test_straggler_during_compaction_parity():
    """Under a coverage-preserving pattern the FR tree equals the all-alive
    tree at 1e-5; the counters equal the reference's."""
    _, all_alive = _buffers(seed=1)
    ref, hit = _buffers(seed=1)
    dead = np.ones(S, dtype=bool)
    dead[2] = False  # bucket 2 keeps its node-5 replica
    for b in _batches(9, seed=4):
        all_alive.add_batch(b)
        hit.add_batch(b, dead)
        ref.add_batch(b, dead)
    assert hit.compactions == all_alive.compactions == 4 and hit.blocking_compactions == 0
    assert _structure(hit) == _structure(ref) == _structure(all_alive)
    for th, tr in zip(hit.frontier(), all_alive.frontier()):
        np.testing.assert_allclose(_np(th), _np(tr), atol=1e-5)


def test_orphaning_pattern_blocks_instead_of_losing_level():
    """Killing both replicas of bucket 0 (nodes 0 and 3) falls back to the
    all-alive recovery: counted, no level lost, same contents."""
    _, all_alive = _buffers(seed=2)
    ref, hit = _buffers(seed=2)
    dead = np.ones(S, dtype=bool)
    dead[[0, 3]] = False
    for b in _batches(6, seed=8):
        all_alive.add_batch(b)
        hit.add_batch(b, dead)
        ref.add_batch(b, dead)
    assert hit.compactions == all_alive.compactions == 2
    assert hit.blocking_compactions == ref.blocking_compactions == 2
    np.testing.assert_allclose(_np(hit.frontier()[0]), _np(all_alive.frontier()[0]), atol=1e-5)
    assert hit.session.stats.host_solves == ref.session.stats.host_solves == 2


def test_all_dead_round_blocks():
    ref, port = _buffers(seed=3)
    for b in _batches(3, seed=2):
        ref.add_batch(b, np.zeros(S, dtype=bool))
        port.add_batch(b, np.zeros(S, dtype=bool))
    assert (port.compactions, port.blocking_compactions) == (1, 1)
    assert _structure(port) == _structure(ref)


@pytest.mark.parametrize("scheme", ["fractional_repetition", "cyclic", "bernoulli"])
def test_recovered_masses_and_blocking_match_the_reference(scheme):
    """Every one of the 64 masks: the merged points and the mass-scaled
    weights of one level group equal the reference's bit for bit, and so
    do the blocking compactions."""
    a = ref_make_assignment(scheme, FANOUT, S, ell=2, rng=np.random.default_rng(7))
    ref, port = _buffers(assignment=a)
    rng = np.random.default_rng(1)
    pts = [rng.normal(size=(M, D)).astype(np.float32) for _ in range(FANOUT)]
    wts = [rng.random(M).astype(np.float32) + 0.5 for _ in range(FANOUT)]
    ref_group = [RefBucket(points=p, weights=w, level=0, seq=j) for j, (p, w) in enumerate(zip(pts, wts))]
    port_group = [Bucket(points=torch.from_numpy(p), weights=torch.from_numpy(w), level=0, seq=j)
                  for j, (p, w) in enumerate(zip(pts, wts))]
    nontrivial = 0
    for code in range(2 ** S):
        alive = np.array([(code >> i) & 1 for i in range(S)], dtype=bool)
        xr, wr = ref._recovered_merge(ref_group, alive)
        xp, wp = port._recovered_merge(port_group, alive)
        np.testing.assert_array_equal(_np(xp), xr)
        np.testing.assert_array_equal(_np(wp), wr)
        nontrivial += int(not np.array_equal(wr, np.concatenate(wts)))
        assert port.blocking_compactions == ref.blocking_compactions, code
    assert port.session.stats.host_solves == ref.session.stats.host_solves
    if scheme != "fractional_repetition":
        assert nontrivial > 0, "no mask gave a mass other than 1: the case is vacuous"


# ------------------------------------------------------------- query path


def test_query_engine_matches_the_reference_and_buckets_shapes():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(K, D)).astype(np.float32)
    ref, port = RefQueryEngine(), QueryEngine(device=CPU)
    for n in (37, 5, 65, 1000):
        q = rng.normal(size=(n, D)).astype(np.float32)
        want = ref.assign(q, centers, staleness_points=11, version=2)
        got = port.assign(q, torch.from_numpy(centers), staleness_points=11, version=2)
        assert got.indices.dtype == np.int32 and got.distances.dtype == np.float32
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5, atol=1e-6)
        assert got[2:] == want[2:] == (11, 0, 2)
        assert port.compiled_buckets == ref.compiled_buckets
    assert port.compiled_buckets == 3  # 64 (37, 5), 128 (65), 1024
    one = port.assign(np.zeros(D, np.float32), centers)  # a 1-D query point, numpy centers
    assert one.indices.shape == (1,)
    assert port.assign(np.zeros((0, D), np.float32), centers).indices.shape == (0,)
    assert port.queries_served == 37 + 5 + 65 + 1000 + 1


def test_query_engine_warmup_reruns_observed_buckets():
    rng = np.random.default_rng(4)
    centers = torch.from_numpy(rng.normal(size=(K, D)).astype(np.float32))
    engine = QueryEngine()
    engine.assign(rng.normal(size=(37, D)).astype(np.float32), centers)
    engine.assign(rng.normal(size=(65, D)).astype(np.float32), centers)
    report = engine.warmup(centers)
    assert (report.errors, report.warmed, engine.warmups) == (0, 2, 1)
    assert report.labels == ("query[64x2]k3", "query[128x2]k3")
    fresh = QueryEngine()
    report = fresh.warmup(centers)
    assert (report.warmed, report.errors) == (1, 0)


def test_session_query_staleness_and_autosolve():
    for pkg in ("ref", "port"):
        sess = _session(pkg)
        with pytest.raises(ValueError, match="nothing ingested"):
            sess.solve()
        sess.ingest(_batches(1, batch=2 * LEAF)[0])
        res = sess.query(np.zeros((4, D), np.float32))  # auto-solves first
        assert res.version == 1 and res.staleness_points == 0
        sess.ingest(_batches(1, batch=30, seed=1)[0])
        res = sess.query(np.zeros((4, D), np.float32))
        assert (res.staleness_points, res.staleness_ingests) == (30, 1)
        sess.solve()
        assert sess.staleness == {"points": 0, "ingests": 0, "version": 2}
        assert sess.generation == (2, 2)
    assert isinstance(sess.centers, torch.Tensor) and sess.centers.shape == (K, D)


def test_solve_warm_starts_query_engine_and_fires_listeners(monkeypatch):
    monkeypatch.delenv("REPRO_WARM_START", raising=False)
    sess = _session("port")
    seen = []
    sess.add_solve_listener(lambda s: seen.append(s.version))
    sess.ingest(_batches(1, batch=2 * LEAF)[0])
    sess.solve()
    assert seen == [1] and sess.stats["query_warmups"] == 1
    monkeypatch.setenv("REPRO_WARM_START", "0")
    sess.ingest(_batches(1, batch=30, seed=2)[0])
    sess.solve()
    assert seen == [1, 2] and sess.stats["query_warmups"] == 1


def test_frontier_solve_pads_with_weight_zero_rows_it_never_draws():
    """The solve pads the frontier to its bucket with weight-0 rows; the ++
    seeding gives them probability exactly 0, so no center starts there."""
    from repro_torch.core.kmeans import plusplus_init

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(100, D)).astype(np.float32) + 50.0)
    xp = torch.cat([x, torch.zeros(28, D)])  # padding rows at the origin, far away
    wp = torch.cat([torch.from_numpy(rng.random(100).astype(np.float32)), torch.zeros(28)])
    for seed in range(20):
        c = plusplus_init(xp, 8, weights=wp, median=True, generator=torch.Generator().manual_seed(seed))
        assert bool((c.abs().sum(-1) > 1.0).all()), seed


# -------------------------------------------------- session end-to-end


def test_streaming_session_end_to_end_matches_the_reference():
    """8 ingests under iid stragglers: every counter equals the reference's
    on the same mask stream; solve and frontier equal the port's
    no-straggler run at 1e-5; replaying the masks costs no host solve."""
    batches = _batches(8, batch=3 * LEAF, seed=6)  # every ingest compacts

    def run(pkg, scenario):
        policy = (RefElasticPolicy if pkg == "ref" else ElasticPolicy)(enabled=False)
        sess = _session(pkg, scenario, elastic=policy)
        return sess, [sess.ingest(b) for b in batches]

    sess, reports = run("port", make_scenario("iid", S, p_straggler=0.25, seed=11))
    ref, ref_reports = run("ref", ref_make_scenario("iid", S, p_straggler=0.25, seed=11))
    assert sum(int((~r["alive"]).sum()) for r in reports) > 0, "no straggler: vacuous"
    for r, rr in zip(reports, ref_reports):
        np.testing.assert_array_equal(r.pop("alive"), rr.pop("alive"))
        assert r.pop("elastic") == rr.pop("elastic")
        assert r == rr
    stats, ref_stats = sess.stats, ref.stats
    assert {k: stats[k] for k in ref_stats} == ref_stats
    clean, _ = run("port", None)
    cost, clean_cost = sess.solve(iters=8).cost, clean.solve(iters=8).cost
    assert cost == pytest.approx(clean_cost, rel=1e-5)
    assert [len(lv) for lv in sess.buffer.levels] == [len(lv) for lv in clean.buffer.levels]
    for ts, tc in zip(sess.frontier(), clean.frontier()):
        np.testing.assert_allclose(_np(ts), _np(tc), atol=1e-5)
    before = sess.resilience.stats.host_solves
    assert before > 0
    sess.scenario.reset()
    for b in _batches(8, batch=3 * LEAF, seed=7):
        sess.ingest(b)
    assert sess.resilience.stats.host_solves == before
    assert sess.resilience.stats.cache_hits > 0


def test_elastic_patches_match_the_reference():
    """A persistent straggler trips ElasticPolicy(patience=2) at the same
    ingest on both packages, with the same moved nodes and assignment."""
    alive = np.array([False] + [True] * (S - 1))
    events = {}
    for pkg in ("ref", "port"):
        sess = _session(pkg)
        events[pkg] = [sess.ingest(b, alive=alive)["elastic"] for b in _batches(5, batch=2 * LEAF, seed=3)]
        events[pkg + "_matrix"] = np.asarray(sess.resilience.assignment.matrix)
        events[pkg + "_stats"] = _structure(sess.buffer)
    assert events["port"] == events["ref"] and any(e["patched"] for e in events["port"])
    np.testing.assert_array_equal(events["port_matrix"], events["ref_matrix"])
    assert events["port_stats"] == events["ref_stats"]


@pytest.mark.parametrize("seed", [0, 1])
def test_streamed_model_cost_stays_in_the_merge_and_reduce_band(seed):
    """The frontier's weighted cost of the streamed centers within 0.35 of
    their cost on every ingested point, at the session's default leaf (512)
    and coreset size (leaf/4); at leaf 64 with m=16 the solve over-fits its
    16-point samples on both packages (ratios 0.46–0.81)."""
    from repro_torch.core import clustering_cost

    sess = StreamingSession(D, K, num_nodes=S, fanout=FANOUT, seed=seed, device=CPU)
    batches = _batches(6, batch=1536, seed=21)
    for b in batches:
        sess.ingest(b)
    out = sess.solve(iters=10)
    x, w = sess.frontier()
    via_frontier = float(clustering_cost(x, out.centers, weights=w, median=True))
    full = float(clustering_cost(torch.from_numpy(np.concatenate(batches)), out.centers, median=True))
    assert out.cost == pytest.approx(via_frontier, rel=1e-5)
    assert abs(via_frontier - full) / full < 0.35


def test_session_validation_and_env_defaults(monkeypatch):
    with pytest.raises(ValueError, match="nodes"):
        StreamingSession(D, K, num_nodes=S, scenario=make_scenario("iid", S + 1), device=CPU)
    mesh = StreamingSession(D, K, num_nodes=S, executor="mesh", device=CPU)
    assert mesh.resilience.executor.name == "mesh"
    assert mesh.ingest(np.zeros((8, D), np.float32))["pending"] == 8
    monkeypatch.setenv("REPRO_STREAM_LEAF_SIZE", "96")
    monkeypatch.setenv("REPRO_STREAM_FANOUT", "5")
    sess = StreamingSession(D, K, num_nodes=S, device=CPU)
    assert (sess.buffer.leaf_size, sess.buffer.fanout, sess.resilience.assignment.num_shards) == (96, 5, 5)


def test_session_without_a_card_raises_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingSession(D, K, num_nodes=S)
    from repro_torch import streaming

    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming.main([])


def test_solve_pca_tracks_frontier_subspace():
    rng = np.random.default_rng(0)
    basis_true = np.linalg.qr(rng.normal(size=(4, 1)))[0]
    sess = StreamingSession(4, 2, num_nodes=S, fanout=FANOUT, leaf_size=LEAF, coreset_size=M, device=CPU)
    for _ in range(4):
        z = rng.normal(size=(LEAF, 1)).astype(np.float32)
        sess.ingest((z @ basis_true.T + 0.01 * rng.normal(size=(LEAF, 4))).astype(np.float32))
    v = sess.solve_pca(1)
    assert v.shape == (4, 1)
    assert abs(float(v[:, 0].double() @ torch.from_numpy(basis_true[:, 0]))) > 0.99


# ----------------------------------------------- state carried from the reference


def test_streaming_state_from_jax_continues_the_reference_tree():
    from repro.core import kmeans as ref_kmeans
    from repro_torch.core import kmeans

    ref = _session("ref")
    batches = _batches(7, batch=LEAF + 13, seed=5)
    for b in batches[:5]:
        ref.ingest(b)
    ref.solve(iters=3)
    port = convert.streaming_state_from_jax(ref, device=CPU)
    assert _structure(port.buffer) == _structure(ref.buffer)
    assert (port.version, port.generation, port.staleness) == (ref.version, ref.generation, ref.staleness)
    np.testing.assert_array_equal(_np(port.centers), np.asarray(ref.centers))
    xr, wr = ref.frontier()
    xp, wp = port.frontier()
    np.testing.assert_array_equal(_np(xp), xr)
    np.testing.assert_array_equal(_np(wp), wr)
    # One Lloyd solve over the carried frontier from the same start (not a
    # frontier point: Weiszfeld's 1/max(d, 1e-6) weight would pin it there).
    init = np.random.default_rng(9).normal(size=(K, D)).astype(np.float32)
    want = ref_kmeans.lloyd(jax.random.PRNGKey(0), xr, K, weights=wr, iters=10,
                            median=True, init_centers=init)
    got = kmeans.lloyd(xp, K, weights=wp, iters=10, median=True, init_centers=torch.from_numpy(init))
    np.testing.assert_allclose(_np(got.centers), np.asarray(want.centers), atol=1e-4, rtol=1e-4)
    assert float(got.cost) == pytest.approx(float(want.cost), rel=1e-4)
    # Both continue from one tree: the structure and counters stay equal.
    for b in batches[5:]:
        assert ref.ingest(b)["buckets"] == port.ingest(b)["buckets"]
    assert _structure(port.buffer) == _structure(ref.buffer)
    assert port.query(np.zeros((3, D), np.float32)).version == ref.version


def test_streaming_twin_runs_on_the_cpu():
    from repro_torch import streaming

    out = streaming.run(CPU, verbose=False)
    assert out["max_center_error"] < 0.2
    assert out["stats"]["leaf_compactions"] == 14 and out["stats"]["compactions"] == 5

"""The port's query-serving tier against the reference's, on the CPU.

The virtual-clock scripts of ``tests/test_serve_frontend.py`` and
``tests/test_serve_cache.py`` run on ``repro.serve`` and on
``repro_torch.serve`` over one stub session per tenant: fixed centers
(numpy for the reference, a CPU tensor for the port), whose ``ingest`` and
``solve`` move only the staleness clock and the generation.  Every ticket's
state, rows, cache flag, rejection reason, indices, staleness and version,
every admission error, batch count, close reason, counter, cache statistic
and latency count must be equal; the distances within rtol 1e-5, atol 1e-6
(the two packages compute them in other summation orders).  Indices are
compared exactly: the queries are Gaussian, so no row is a near tie.

``batcher``, ``cache`` and ``clock`` run the reference's cases on both
packages.  Two tests drive the port's frontend over real
``StreamingSession``s on the CPU (tenant isolation, an elastic patch in
flight, re-warming on a generation bump), as the reference's suite does.
"""

import asyncio
import types

import numpy as np
import pytest
import torch

import repro.serve as ref_serve
import repro_torch.serve as port_serve
from repro.stream.query import QueryEngine as RefQueryEngine
from repro.stream.query import QueryResult as RefQueryResult
from repro_torch.stream import StreamingSession
from repro_torch.stream.query import QueryEngine, QueryResult

D, K = 3, 3
WINDOW = 0.002

REF = types.SimpleNamespace(
    name="ref", serve=ref_serve, centers=lambda c: c, engine=RefQueryEngine, result=RefQueryResult)
PORT = types.SimpleNamespace(
    name="port", serve=port_serve, centers=torch.from_numpy,
    engine=lambda: QueryEngine(device="cpu"), result=QueryResult)
PKGS = [pytest.param(REF, id="ref"), pytest.param(PORT, id="port")]


class _Resilience:
    def __init__(self):
        self.listeners = []

    def add_patch_listener(self, cb):
        self.listeners.append(cb)

    def patch(self):
        for cb in self.listeners:
            cb([0], 1, 1)


class StubSession:
    """What the frontend reads of a StreamingSession, over fixed centers."""

    def __init__(self, pkg, d=D, seed=0):
        rng = np.random.default_rng(100 + seed)
        self.centers_np = rng.normal(size=(K, d)).astype(np.float32)
        self._centers = pkg.centers(self.centers_np)
        self.resilience = _Resilience()
        self._engine = pkg.engine()
        self._version, self._ingested, self._ingests = 1, 0, 0
        self._points_at_solve = self._ingests_at_solve = 0
        self._listeners = []

    def add_solve_listener(self, fn):
        self._listeners.append(fn)

    @property
    def centers(self):
        return self._centers

    @property
    def version(self):
        return self._version

    @property
    def generation(self):
        return (self._version, self._ingests)

    @property
    def staleness(self):
        return {"points": self._ingested - self._points_at_solve,
                "ingests": self._ingests - self._ingests_at_solve, "version": self._version}

    def ensure_model(self):
        return self._centers

    def ingest(self, batch):
        self._ingested += len(batch)
        self._ingests += 1

    def solve(self):
        self._version += 1
        self._points_at_solve, self._ingests_at_solve = self._ingested, self._ingests
        for fn in self._listeners:
            fn(self)

    def query(self, q):
        st = self.staleness
        return self._engine.assign(q, self._centers, staleness_points=st["points"],
                                   staleness_ingests=st["ingests"], version=self._version)


class Run:
    """One script's frontend on one package, and what it observed."""

    def __init__(self, pkg, *, max_batch=64, cache_size=128, window=WINDOW, tenants=(("a", D, 0),)):
        self.pkg = pkg
        self.clk = pkg.serve.VirtualClock()
        self.fe = pkg.serve.ServingFrontend(window=window, max_batch=max_batch,
                                            cache_size=cache_size, clock=self.clk)
        self.sess = {}
        for name, d, seed in tenants:
            self.sess[name] = StubSession(pkg, d=d, seed=seed)
            self.fe.add_tenant(name, self.sess[name])
        self.trace, self.dists = [], []

    def ticket(self, t):
        r = t.result
        if r is not None:
            self.dists.append(np.asarray(r.distances))
            assert r.indices.dtype == np.int32 and r.distances.dtype == np.float32
        self.trace.append(("ticket", t.state, t.rows, t.from_cache, t.error, None if r is None else (
            r.indices.tolist(), r.staleness_points, r.staleness_ingests, r.version)))

    def submit(self, tenant, q, **bounds):
        try:
            t = self.fe.submit(tenant, q, **bounds)
        except self.pkg.serve.AdmissionError as e:
            self.trace.append(("rejected", str(e), e.tenant, e.staleness))
            return None
        return t

    def flush(self):
        n = self.fe.flush()
        self.trace.append(("flush", n))
        return n

    def finish(self, tickets=()):
        for t in tickets:
            self.ticket(t)
        stats = dict(self.fe.stats)
        self.trace.append(("stats", stats))
        for name in self.sess:
            snap = self.fe.latency_snapshot(name)
            self.trace.append(("latency", name, snap.count, snap.total))
            st = self.fe.tenant(name)
            self.trace.append(("tenant", name, st.queries_served, st.batches, st.elastic_patches,
                               st.warmups, sorted(st.observed_buckets)))
        return self.trace, self.dists


def _q(rng, m, d=D):
    return rng.normal(size=(m, d)).astype(np.float32)


# ------------------------------------------------------------- the scripts


def s_batch_window(pkg):
    r, rng = Run(pkg), np.random.default_rng(1)
    tickets = [r.submit("a", _q(rng, 2)) for _ in range(5)]
    assert r.flush() == 0
    r.clk.advance(WINDOW / 2)
    assert r.flush() == 0
    r.clk.advance(WINDOW / 2)
    assert r.flush() == 1 and all(t.state == "done" for t in tickets)
    assert r.fe.dispatches == 1 and r.fe.served == 10
    return r.finish(tickets)


def s_window_anchor(pkg):
    r, rng = Run(pkg), np.random.default_rng(2)
    t1 = r.submit("a", _q(rng, 1))
    r.clk.advance(WINDOW * 0.9)
    t2 = r.submit("a", _q(rng, 1))
    r.clk.advance(WINDOW * 0.1)
    assert r.flush() == 1 and t1.done and t2.done
    return r.finish([t1, t2])


def s_max_batch(pkg):
    r, rng = Run(pkg, max_batch=8), np.random.default_rng(3)
    tickets = [r.submit("a", _q(rng, 1)) for _ in range(8)]
    assert r.flush() == 1 and all(t.done for t in tickets)
    assert (r.fe.batcher.size_closes, r.fe.batcher.window_closes) == (1, 0)
    return r.finish(tickets)


def s_due(pkg):
    r = Run(pkg)
    r.trace.append(("due", r.fe.due()))
    r.submit("a", np.zeros((1, D), np.float32))
    r.trace.append(("due", r.fe.due()))
    r.clk.advance(2 * WINDOW)
    r.trace.append(("due", r.fe.due()))
    assert r.fe.due() == pytest.approx(r.clk.now())
    return r.finish()


def s_tenants_and_dims(pkg):
    r, rng = Run(pkg, tenants=(("a", D, 0), ("b", 5, 1))), np.random.default_rng(4)
    qa, qb = _q(rng, 3), _q(rng, 2, d=5)
    ta, tb = r.submit("a", qa), r.submit("b", qb)
    r.clk.advance(WINDOW)
    assert r.flush() == 2 and r.fe.dispatches == 2
    for t, q, name in ((ta, qa, "a"), (tb, qb, "b")):
        np.testing.assert_array_equal(t.result.indices, r.sess[name].query(q).indices)
    return r.finish([ta, tb])


def s_mixed_rows(pkg):
    r, rng = Run(pkg), np.random.default_rng(5)
    tickets = [r.submit("a", _q(rng, m)) for m in (1, 4, 2, 7)]
    r.clk.advance(WINDOW)
    assert r.flush() == 1 and 0.0 < r.fe.occupancy <= 1.0
    return r.finish(tickets)


def s_admission_at_submit(pkg):
    r, rng = Run(pkg), np.random.default_rng(6)
    r.sess["a"].ingest(_q(rng, 50))
    assert r.submit("a", _q(rng, 1), max_staleness_points=49) is None
    assert r.fe.rejected == 1
    t = r.submit("a", _q(rng, 1), max_staleness_points=50)
    assert not t.done
    return r.finish()


def s_admission_at_dispatch(pkg):
    r, rng = Run(pkg), np.random.default_rng(7)
    tb = r.submit("a", _q(rng, 2), max_staleness_points=10)
    tf = r.submit("a", _q(rng, 2))
    r.sess["a"].ingest(_q(rng, 50))
    r.clk.advance(WINDOW)
    assert r.flush() == 1
    assert tb.state == "rejected" and "bound" in tb.error and tf.state == "done"
    assert tf.result.staleness_points == 50
    return r.finish([tb, tf])


def s_waiter_woken(pkg):
    r, rng = Run(pkg), np.random.default_rng(8)
    t = r.submit("a", _q(rng, 1), max_staleness_ingests=0)
    woken = []
    t.waiter = lambda tk: woken.append(tk.state)
    r.sess["a"].ingest(_q(rng, 20))
    r.clk.advance(WINDOW)
    r.flush()
    assert woken == ["rejected"]
    r.trace.append(("woken", woken))
    return r.finish([t])


def s_patch_in_flight(pkg):
    r, rng = Run(pkg), np.random.default_rng(9)
    t = r.submit("a", _q(rng, 4))
    for _ in range(4):
        r.sess["a"].ingest(_q(rng, 40))
    r.sess["a"].resilience.patch()
    r.clk.advance(WINDOW)
    assert r.flush() == 1 and t.state == "done"
    assert (t.result.staleness_points, t.result.staleness_ingests) == (160, 4)
    np.testing.assert_array_equal(t.result.indices, r.sess["a"].query(t.queries).indices)
    return r.finish([t])


def s_scripted(pkg):
    r, rng = Run(pkg, max_batch=8), np.random.default_rng(11)
    tickets = []
    for step in range(12):
        tickets.append(r.submit("a", _q(rng, 1 + step % 3)))
        if step % 3 == 2:
            r.clk.advance(WINDOW)
            r.flush()
    r.clk.advance(WINDOW)
    r.flush()
    return r.finish(tickets)


def s_warmup(pkg):
    r, rng = Run(pkg), np.random.default_rng(21)
    r.submit("a", _q(rng, 2))
    r.clk.advance(WINDOW)
    assert r.flush() == 1
    rep = r.fe.warmup("a")
    assert rep.errors == 0 and rep.warmed == 1
    r.trace.append(("warmup", rep.warmed, rep.errors, rep.labels))
    r.sess["fresh"] = StubSession(pkg, seed=3)
    r.fe.add_tenant("fresh", r.sess["fresh"])
    rep = r.fe.warmup("fresh")
    r.trace.append(("warmup", rep.warmed, rep.errors, rep.labels))
    return r.finish()


def s_generation_bump(pkg):
    r, rng = Run(pkg), np.random.default_rng(22)
    r.submit("a", _q(rng, 2))
    r.clk.advance(WINDOW)
    r.flush()
    before = r.fe.warmups
    r.sess["a"].ingest(_q(rng, 80))
    r.sess["a"].solve()  # the solve listener re-warms the observed buckets
    assert r.fe.warmups == before + 1
    t = r.submit("a", _q(rng, 2))
    r.clk.advance(WINDOW)
    r.flush()
    return r.finish([t])


def _answer(r, q, **bounds):
    t = r.submit("a", q, **bounds)
    if t is not None and not t.done:
        r.clk.advance(r.fe.batcher.window)
        r.flush()
    if t is not None:
        r.ticket(t)
    return t


def s_cache(pkg):
    r, rng = Run(pkg, window=0.001), np.random.default_rng(1)
    q = _q(rng, 4)
    t1 = _answer(r, q)
    t2 = _answer(r, q)  # repeat: a hit at submit time
    assert not t1.from_cache and t2.from_cache and r.fe.dispatches == 1
    np.testing.assert_array_equal(t2.result.distances, t1.result.distances)
    assert _answer(r, q + 1e-8).from_cache  # jitter under the quantization step
    r.sess["a"].ingest(_q(rng, 30))
    t3 = _answer(r, q)
    assert not t3.from_cache and t3.result.staleness_points == 30
    r.sess["a"].solve()
    t4 = _answer(r, q)
    assert not t4.from_cache and t4.result.version == t1.result.version + 1
    r.sess["a"].ingest(_q(rng, 20))
    _answer(r, q)  # cached at staleness 20
    assert _answer(r, q, max_staleness_points=10) is None  # a hit is admitted first
    assert _answer(r, q, max_staleness_points=20).from_cache
    return r.finish()


def s_property(pkg):
    """The randomized ingest/solve/query schedule of the reference's
    property test: every answer satisfies the bound it was admitted under,
    and equals the synchronous path's answer and staleness."""
    rng = np.random.default_rng(42)
    r = Run(pkg, window=0.001, cache_size=64, tenants=(("a", D, 7),))
    sess = r.sess["a"]
    pool = [_q(rng, m) for m in (1, 2, 3)]
    served = rejected = hits = 0
    for _ in range(120):
        act = rng.random()
        if act < 0.25:
            sess.ingest(_q(rng, int(rng.integers(1, 40))))
        elif act < 0.35:
            sess.solve()
        else:
            q = pool[int(rng.integers(len(pool)))]
            bound = int(rng.integers(0, 120)) if rng.random() < 0.5 else None
            live = sess.staleness["points"]
            t = _answer(r, q, max_staleness_points=bound)
            if t is None:
                rejected += 1
                assert bound is not None and live > bound
                continue
            served += 1
            hits += t.from_cache
            if bound is not None:
                assert t.result.staleness_points <= bound
            ref = sess.query(q)
            np.testing.assert_array_equal(t.result.indices, ref.indices)
            assert (t.result.staleness_points, t.result.version) == (ref.staleness_points, ref.version)
    assert served > 30 and hits > 5 and rejected > 0
    return r.finish()


def s_async(pkg):
    rng = np.random.default_rng(12)
    sess = StubSession(pkg)
    qs = [_q(rng, 2) for _ in range(6)]

    async def main():
        af = pkg.serve.AsyncFrontend(window=0.0, max_batch=64, cache_size=32)
        af.core.add_tenant("a", sess)
        results = await asyncio.gather(*[af.query("a", q) for q in qs])
        sess.ingest(_q(rng, 30))
        with pytest.raises(pkg.serve.AdmissionError):
            await af.query("a", _q(rng, 1), max_staleness_points=5)
        return af, results

    af, results = asyncio.run(main())
    for q, res in zip(qs, results):
        np.testing.assert_array_equal(res.indices, sess.query(q).indices)
    stats = dict(af.core.stats)
    return [("async", [res.indices.tolist() for res in results], stats["dispatches"],
             stats["served"], stats["rejected"])], [res.distances for res in results]


SCRIPTS = [s_batch_window, s_window_anchor, s_max_batch, s_due, s_tenants_and_dims, s_mixed_rows,
           s_admission_at_submit, s_admission_at_dispatch, s_waiter_woken, s_patch_in_flight,
           s_scripted, s_warmup, s_generation_bump, s_cache, s_property, s_async]


@pytest.mark.parametrize("script", SCRIPTS, ids=[s.__name__[2:] for s in SCRIPTS])
def test_frontend_script_matches_the_reference(script, monkeypatch):
    monkeypatch.delenv("REPRO_WARM_START", raising=False)
    ref_trace, ref_dists = script(REF)
    trace, dists = script(PORT)
    assert trace == ref_trace
    assert len(dists) == len(ref_dists)
    for got, want in zip(dists, ref_dists):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_frontend_answers_equal_the_query_engine():
    """Each dispatch's answer, row for row, is the port's query engine's for
    the same rows, centers and version (indices exactly; distances within
    1e-6, the CPU's product of another row count may round apart)."""
    r, rng = Run(PORT, max_batch=256), np.random.default_rng(31)
    tickets = [r.submit("a", _q(rng, int(m))) for m in rng.integers(1, 17, size=40)]
    r.clk.advance(WINDOW)
    r.flush()
    engine = QueryEngine(device="cpu")
    for t in tickets:
        want = engine.assign(t.queries, r.sess["a"].centers, version=1)
        np.testing.assert_array_equal(t.result.indices, want.indices)
        np.testing.assert_allclose(t.result.distances, want.distances, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("pkg", PKGS)
def test_unknown_tenant_and_bad_shapes_fail_fast(pkg):
    r = Run(pkg)
    with pytest.raises(KeyError):
        r.fe.submit("ghost", np.zeros((1, D), np.float32))
    with pytest.raises(ValueError):
        r.fe.submit("a", np.zeros((0, D), np.float32))
    with pytest.raises(ValueError):
        r.fe.add_tenant("a", StubSession(pkg))


# ------------------------------------------------------- real sessions (port)


def _real_session(d=D, seed=0, rounds=2, n=160):
    rng = np.random.default_rng(seed)
    s = StreamingSession(d=d, k=K, num_nodes=4, leaf_size=64, seed=seed, device="cpu")
    for _ in range(rounds):
        s.ingest(rng.normal(size=(n, d)).astype(np.float32))
    s.solve()
    return s


def test_port_frontend_over_real_sessions_isolates_tenants_and_survives_a_patch():
    sa, sb = _real_session(rounds=3), _real_session(d=5, seed=1)
    clk = port_serve.VirtualClock()
    fe = port_serve.ServingFrontend(window=WINDOW, max_batch=64, cache_size=64, clock=clk)
    fe.add_tenant("a", sa)
    fe.add_tenant("b", sb)
    rng = np.random.default_rng(9)
    qa, qb = _q(rng, 4), _q(rng, 2, d=5)
    ta, tb = fe.submit("a", qa), fe.submit("b", qb)
    alive = np.array([False, True, True, True])  # node 0 persistent: patience 2 trips
    for _ in range(4):
        sa.ingest(_q(rng, 40), alive=alive)
    assert fe.tenant("a").elastic_patches >= 1
    clk.advance(WINDOW)
    assert fe.flush() == 2
    assert (ta.result.staleness_points, ta.result.staleness_ingests) == (160, 4)
    np.testing.assert_array_equal(ta.result.indices, sa.query(qa).indices)
    np.testing.assert_array_equal(tb.result.indices, sb.query(qb).indices)
    assert (ta.result.version, tb.result.version) == (sa.version, sb.version)


def test_port_generation_bump_auto_warms_and_env_opts_out(monkeypatch):
    monkeypatch.delenv("REPRO_WARM_START", raising=False)
    sess = _real_session()
    clk = port_serve.VirtualClock()
    fe = port_serve.ServingFrontend(window=WINDOW, max_batch=64, cache_size=128, clock=clk)
    fe.add_tenant("a", sess)
    rng = np.random.default_rng(22)
    fe.submit("a", _q(rng, 2))
    clk.advance(WINDOW)
    fe.flush()
    before = fe.warmups
    sess.ingest(_q(rng, 80))
    sess.solve()
    assert fe.warmups == before + 1
    t = fe.submit("a", _q(rng, 2))
    clk.advance(WINDOW)
    fe.flush()
    assert t.state == "done"
    monkeypatch.setenv("REPRO_WARM_START", "0")
    sess.ingest(_q(rng, 80))
    sess.solve()
    assert fe.warmups == before + 1


# ------------------------------------------- batcher, cache, clock (copies)


def _res(pkg, i):
    return pkg.result(np.array([i], np.int32), np.zeros((1,), np.float32), 0, 0, 1)


@pytest.mark.parametrize("pkg", PKGS)
def test_cache_lru_keys_and_invalidation(pkg):
    c = pkg.serve.AssignmentCache(maxsize=2)
    q = np.ones((1, 4), np.float32)
    k1 = c.key("t", (1, 0), q)
    assert c.get(k1) is None and c.misses == 1
    c.put(k1, _res(pkg, 1))
    assert c.get(k1).indices[0] == 1 and c.hits == 1
    c.put(c.key("t", (1, 0), 2 * q), _res(pkg, 2))
    c.put(c.key("t", (1, 0), 3 * q), _res(pkg, 3))
    assert c.evictions == 1 and c.get(k1) is None and 0.0 < c.hit_rate < 1.0
    c = pkg.serve.AssignmentCache(maxsize=8, quantize=6)
    q = np.array([[0.123456789, 1.0]], np.float32)
    assert c.key("t", (1, 0), q) == c.key("t", (1, 0), q + 1e-9)
    assert c.key("t", (1, 0), q) != c.key("t", (1, 0), q + 1e-3)
    q = np.ones((2, 3), np.float32)
    keys = [c.key("a", (1, 0), q), c.key("b", (1, 0), q), c.key("a", (1, 1), q),
            c.key("a", (2, 0), q), c.key("a", (1, 0), q.reshape(3, 2))]
    assert len(set(keys)) == 5
    c = pkg.serve.AssignmentCache(maxsize=16)
    q = np.ones((1, 2), np.float32)
    for gen in [(1, 0), (1, 1), (2, 2)]:
        c.put(c.key("a", gen, q), _res(pkg, 0))
    c.put(c.key("b", (1, 0), q), _res(pkg, 9))
    assert c.invalidate("a", keep_generation=(2, 2)) == 2 and len(c) == 2
    assert c.invalidate("a") == 1 and c.invalidations == 3
    z = pkg.serve.AssignmentCache(maxsize=0)
    z.put(z.key("t", (1, 0), q), _res(pkg, 1))
    assert len(z) == 0


def test_cache_keys_equal_the_reference():
    q = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    assert (port_serve.AssignmentCache().key("t", (2, 5), q)
            == ref_serve.AssignmentCache().key("t", (2, 5), q))


@pytest.mark.parametrize("pkg", PKGS)
def test_batcher_windows_sizes_and_validation(pkg):
    B = pkg.serve.MicroBatcher
    with pytest.raises(ValueError):
        B(window=-1.0, max_batch=4)
    with pytest.raises(ValueError):
        B(window=0.1, max_batch=0)
    b = B(window=0.01, max_batch=4)
    mk = pkg.serve.Ticket
    b.submit(mk(tenant="a", queries=np.zeros((3, 2)), submitted_at=0.0), 0.0)
    b.submit(mk(tenant="a", queries=np.zeros((1, 5)), submitted_at=0.0), 0.0)
    assert b.due(0.0) == pytest.approx(0.01) and b.poll(0.005) == []
    b.submit(mk(tenant="a", queries=np.zeros((1, 2)), submitted_at=0.0), 0.006)  # fills (a, 2)
    assert b.due(0.006) == 0.006
    closed = b.poll(0.006)
    assert [x.key for x in closed] == [("a", 2)] and closed[0].rows == 4
    assert [x.key for x in b.poll(0.02)] == [("a", 5)]
    b.submit(mk(tenant="b", queries=np.zeros((1, 2)), submitted_at=0.0), 0.03)
    assert b.pending == 1 and len(b.drain()) == 1 and b.pending == 0
    assert (b.rows_in, b.batches_closed, b.size_closes, b.window_closes) == (6, 3, 1, 2)


@pytest.mark.parametrize("pkg", PKGS)
def test_clock_moves_only_forward(pkg):
    clk = pkg.serve.VirtualClock(1.0)
    assert clk.advance(0.5) == 1.5 and clk.set(2.0) == 2.0 and clk.now() == 2.0
    with pytest.raises(ValueError):
        clk.advance(-0.1)
    with pytest.raises(ValueError):
        clk.set(1.0)
    sys_clk = pkg.serve.SystemClock()
    assert sys_clk.now() <= sys_clk.now()

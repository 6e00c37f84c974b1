"""Straggler models (paper §3.4 random model + systems-grade extensions).

The paper analyses the *random straggler model*: each node straggles
independently with probability ``p_t``.  Real clusters also exhibit
correlated slowdowns and adversarial worst cases, and at the training-loop
level straggling is *deadline-based* (a node that misses the step deadline is
treated as failed for that step).  All are modelled here; every model yields
a boolean alive-mask consumed by :mod:`repro.core.recovery`.

Two API layers:

* **One-shot samplers** (:func:`random_stragglers`,
  :func:`fixed_count_stragglers`, :func:`adversarial_stragglers`) — a single
  alive mask, the paper's per-experiment view.
* **Scenarios** (:class:`StragglerScenario` and subclasses) — an *iterator of
  per-step* :class:`ScenarioStep` records, the multi-round view consumed
  uniformly by :class:`repro.core.resilience.ResilienceSession`, the trainer,
  and ``benchmarks/bench_scenarios.py``.  Every scenario is deterministic
  given its seed and supports :meth:`~StragglerScenario.reset` (same seed →
  same mask stream; reset → replay).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterator, NamedTuple, Optional

import numpy as np

from .assignment import Assignment

__all__ = [
    "random_stragglers",
    "fixed_count_stragglers",
    "adversarial_stragglers",
    "DeadlineStragglerSimulator",
    "ScenarioStep",
    "StragglerScenario",
    "IIDScenario",
    "FixedCountScenario",
    "AdversarialScenario",
    "DeadlineScenario",
    "TraceScenario",
    "record_trace",
    "make_scenario",
]


def random_stragglers(
    s: int, p_straggler: float, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Paper's model: iid Bern(p_t) stragglers. Returns alive mask (True=alive)."""
    rng = rng or np.random.default_rng(0)
    return rng.random(s) >= p_straggler


def fixed_count_stragglers(
    s: int, t: int, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Exactly ``t`` uniformly-random stragglers (the paper's experiments)."""
    rng = rng or np.random.default_rng(0)
    mask = np.ones(s, dtype=bool)
    if t > 0:
        mask[rng.choice(s, size=min(t, s), replace=False)] = False
    return mask


def adversarial_stragglers(assignment: Assignment, t: int) -> np.ndarray:
    """Greedy worst case: kill the ``t`` nodes that maximize lost coverage.

    Iteratively removes the node whose removal minimizes the resulting minimum
    shard-replication (ties broken towards more shards at the minimum, then
    towards larger load, then towards the smallest node index).  Used to
    stress-test constructions: fractional-repetition/cyclic with ``ell ≥ t+1``
    must survive this; Bernoulli only survives w.h.p. for random stragglers.

    The candidate scoring is vectorized: one ``(alive, n)`` coverage matrix
    per removal round instead of a Python loop over candidates — O(t·s·n)
    numpy work with no inner interpreter loop.
    """
    A = assignment.matrix.astype(np.int64)
    alive = np.ones(assignment.num_nodes, dtype=bool)
    for _ in range(min(t, assignment.num_nodes - 1)):
        cand = np.flatnonzero(alive)
        # Row c: shard coverage after killing candidate cand[c].
        C = A[alive].sum(axis=0)[None, :] - A[cand]  # (|cand|, n)
        cmin = C.min(axis=1)
        n_at_min = (C == cmin[:, None]).sum(axis=1)
        load = A[cand].sum(axis=1)
        # Lexicographic argmin of (cmin, -n_at_min, -load); np.lexsort is
        # stable, so full ties resolve to the smallest node index — the same
        # choice the scalar greedy loop made.
        order = np.lexsort((-load, -n_at_min, cmin))
        alive[cand[order[0]]] = False
    return alive


class ScenarioStep(NamedTuple):
    """One step of a straggler scenario — everything the step observed.

    ``latencies`` and ``spiked`` are populated by the deadline simulator
    (correlated-spike state included so a step record fully determines the
    simulator's externally-visible state); mask-only scenarios leave them as
    empty arrays.
    """

    alive: np.ndarray      # (s,) bool, True = alive
    latencies: np.ndarray  # (s,) float step latencies (empty if not modelled)
    spiked: np.ndarray     # (s,) bool correlated-slowdown state (empty if n/a)
    index: int             # 0-based step number since construction/reset


@dataclasses.dataclass
class DeadlineStragglerSimulator:
    """Deadline-based per-step straggling, the training-loop reality.

    Each node's step latency is lognormal(μ=0, σ) · base; with probability
    ``p_spike`` a node suffers a multiplicative slowdown (background task,
    checkpoint flush, network congestion).  A node is a straggler for the step
    iff its latency exceeds ``deadline``.  Slowdowns persist with probability
    ``persistence`` (correlated stragglers across steps — the hard case for
    non-redundant schemes).

    Deterministic: the stream of step records is a pure function of the seed,
    and :meth:`reset` replays it from the start.
    """

    num_nodes: int
    deadline: float = 2.0
    sigma: float = 0.25
    p_spike: float = 0.08
    spike_scale: float = 4.0
    persistence: float = 0.5
    seed: int = 0

    def __post_init__(self):
        self.reset()

    def reset(self) -> None:
        """Rewind to step 0: same seed → the exact same step-record stream."""
        self._rng = np.random.default_rng(self.seed)
        self._spiked = np.zeros(self.num_nodes, dtype=bool)
        self._index = 0

    def step(self) -> ScenarioStep:
        """Advance one training step; the record carries the spike state."""
        rng = self._rng
        fresh = rng.random(self.num_nodes) < self.p_spike
        stay = self._spiked & (rng.random(self.num_nodes) < self.persistence)
        self._spiked = fresh | stay
        lat = rng.lognormal(mean=0.0, sigma=self.sigma, size=self.num_nodes)
        lat = np.where(self._spiked, lat * self.spike_scale, lat)
        rec = ScenarioStep(
            alive=lat <= self.deadline,
            latencies=lat,
            spiked=self._spiked.copy(),
            index=self._index,
        )
        self._index += 1
        return rec


# --------------------------------------------------------------- scenarios


class StragglerScenario:
    """Iterator protocol over per-step alive masks.

    Subclasses implement :meth:`_next` (one :class:`ScenarioStep`) and
    :meth:`reset`.  Scenarios are infinite iterators — consumers decide the
    round count — and deterministic given their construction arguments.
    """

    name = "abstract"

    def __init__(self, num_nodes: int):
        self.num_nodes = int(num_nodes)
        self._index = 0

    def reset(self) -> None:
        self._index = 0

    def __iter__(self) -> Iterator[ScenarioStep]:
        return self

    def __next__(self) -> ScenarioStep:
        step = self._next()
        self._index += 1
        return step

    def _next(self) -> ScenarioStep:
        raise NotImplementedError

    def _mask_step(self, alive: np.ndarray) -> ScenarioStep:
        empty = np.zeros((0,), dtype=np.float64)
        return ScenarioStep(
            alive=np.asarray(alive, dtype=bool),
            latencies=empty,
            spiked=np.zeros((0,), dtype=bool),
            index=self._index,
        )


class IIDScenario(StragglerScenario):
    """Paper §3.4: every node straggles iid Bern(p) each step."""

    name = "iid"

    def __init__(self, num_nodes: int, p_straggler: float = 0.1, seed: int = 0):
        super().__init__(num_nodes)
        self.p_straggler = float(p_straggler)
        self.seed = int(seed)
        self.reset()

    def reset(self) -> None:
        super().reset()
        self._rng = np.random.default_rng(self.seed)

    def _next(self) -> ScenarioStep:
        return self._mask_step(random_stragglers(self.num_nodes, self.p_straggler, self._rng))


class FixedCountScenario(StragglerScenario):
    """Exactly ``t`` uniformly-random stragglers per step (paper experiments)."""

    name = "fixed"

    def __init__(self, num_nodes: int, t: int = 1, seed: int = 0):
        super().__init__(num_nodes)
        self.t = int(t)
        self.seed = int(seed)
        self.reset()

    def reset(self) -> None:
        super().reset()
        self._rng = np.random.default_rng(self.seed)

    def _next(self) -> ScenarioStep:
        return self._mask_step(fixed_count_stragglers(self.num_nodes, self.t, self._rng))


class AdversarialScenario(StragglerScenario):
    """Greedy worst-case pattern, re-targeted against the CURRENT assignment.

    Holds a reference to the assignment so an elastic session that patches the
    assignment mid-run faces a re-aimed adversary on the next step (call
    :meth:`rebind` after a patch).  The mask is recomputed per step — the
    adversary is stateless, so the stream is constant between rebinds.
    """

    name = "adversarial"

    def __init__(self, assignment: Assignment, t: int = 1):
        super().__init__(assignment.num_nodes)
        self.t = int(t)
        self.rebind(assignment)

    def rebind(self, assignment: Assignment) -> None:
        self.assignment = assignment
        # The greedy is deterministic, so the mask is constant until the next
        # rebind — compute it once here, not per step.
        self._mask = adversarial_stragglers(assignment, self.t)

    def _next(self) -> ScenarioStep:
        return self._mask_step(self._mask.copy())  # records own their masks


class DeadlineScenario(StragglerScenario):
    """Deadline/correlated model: wraps :class:`DeadlineStragglerSimulator`."""

    name = "deadline"

    def __init__(self, num_nodes: int, **sim_kwargs):
        super().__init__(num_nodes)
        self.sim = DeadlineStragglerSimulator(num_nodes=num_nodes, **sim_kwargs)

    def reset(self) -> None:
        super().reset()
        self.sim.reset()

    def _next(self) -> ScenarioStep:
        rec = self.sim.step()
        return ScenarioStep(
            alive=rec.alive, latencies=rec.latencies, spiked=rec.spiked,
            index=self._index,
        )


class TraceScenario(StragglerScenario):
    """Replay a recorded alive-mask sequence from a JSONL trace file.

    Each line is a JSON object with an ``"alive"`` array of 0/1 (or bools),
    one entry per node; ``"latencies"`` is optional.  Extra keys (``name``,
    ``index``, ``derived`` … — the ``BENCH_scenarios.json`` row fields) are
    ignored, so annotated benchmark rows replay as-is.  The trace is loaded
    once at construction: replay is deterministic, :meth:`reset` rewinds to
    step 0, and — scenarios being infinite iterators — the stream wraps
    around at the end of the trace (``loop=False`` raises ``StopIteration``
    instead, for consumers that want exactly the recorded rounds).
    """

    name = "trace"

    def __init__(self, num_nodes: int, path: str, *, loop: bool = True):
        super().__init__(num_nodes)
        self.path = str(path)
        self.loop = bool(loop)
        self._masks: list[np.ndarray] = []
        self._lats: list[np.ndarray] = []
        with open(self.path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError as e:
                    raise ValueError(f"{self.path}:{lineno}: not JSON ({e})") from None
                if not isinstance(row, dict) or "alive" not in row:
                    raise ValueError(
                        f"{self.path}:{lineno}: trace rows need an 'alive' array"
                    )
                alive = np.asarray(row["alive"], dtype=bool)
                if alive.shape != (self.num_nodes,):
                    raise ValueError(
                        f"{self.path}:{lineno}: alive has {alive.size} entries, "
                        f"scenario has {self.num_nodes} nodes"
                    )
                self._masks.append(alive)
                lat = row.get("latencies")
                self._lats.append(
                    np.asarray(lat, np.float64)
                    if lat is not None
                    else np.zeros((0,), np.float64)
                )
        if not self._masks:
            raise ValueError(f"{self.path}: empty trace")

    def __len__(self) -> int:
        return len(self._masks)

    def _next(self) -> ScenarioStep:
        if self._index >= len(self._masks) and not self.loop:
            raise StopIteration
        i = self._index % len(self._masks)
        return ScenarioStep(
            alive=self._masks[i].copy(),
            latencies=self._lats[i].copy(),
            spiked=np.zeros((0,), dtype=bool),
            index=self._index,
        )


def record_trace(scenario: StragglerScenario, rounds: int, path: str) -> int:
    """Record ``rounds`` steps of any scenario to a JSONL trace file.

    The rows are the :class:`TraceScenario` input schema (``alive`` +
    optional ``latencies``, annotated with the source scenario's ``name`` and
    step ``index``).  Returns the number of rows written.
    """
    with open(path, "w", encoding="utf-8") as f:
        for _ in range(rounds):
            step = next(scenario)
            row: dict = {
                "name": scenario.name,
                "index": int(step.index),
                "alive": np.asarray(step.alive, dtype=int).tolist(),
            }
            if step.latencies.size:
                row["latencies"] = [float(x) for x in step.latencies]
            f.write(json.dumps(row) + "\n")
    return rounds


def make_scenario(
    name: str,
    num_nodes: int,
    *,
    assignment: Optional[Assignment] = None,
    path: Optional[str] = None,
    **kwargs,
) -> StragglerScenario:
    """Factory over the five models: iid / fixed / adversarial / deadline /
    trace.

    ``assignment`` is required (and only used) by the adversarial scenario;
    ``path`` (a JSONL trace file) by the trace scenario.  Remaining kwargs go
    to the scenario constructor (``p_straggler``, ``t``, ``seed``, ``loop``,
    or the deadline-simulator knobs).
    """
    if name == "iid":
        return IIDScenario(num_nodes, **kwargs)
    if name == "fixed":
        return FixedCountScenario(num_nodes, **kwargs)
    if name == "adversarial":
        if assignment is None:
            raise ValueError("adversarial scenario needs assignment=")
        return AdversarialScenario(assignment, **kwargs)
    if name == "deadline":
        return DeadlineScenario(num_nodes, **kwargs)
    if name == "trace":
        if path is None:
            raise ValueError("trace scenario needs path= (a JSONL trace file)")
        return TraceScenario(num_nodes, path, **kwargs)
    raise ValueError(
        f"unknown scenario {name!r}; expected iid/fixed/adversarial/deadline/trace"
    )

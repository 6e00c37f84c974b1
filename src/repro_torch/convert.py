"""Carry the reference package's state into the port, through numpy only.

The port never imports the reference package; a caller that holds its
objects passes their numpy fields here:

* an assignment's ``matrix``, ``scheme`` and ``params`` → :class:`Assignment`;
* a recovery result's fields → :class:`RecoveryResult`;
* centers, shards or any array → a tensor on the chosen device;
* a coreset's points and weights → :class:`Coreset` (:func:`coreset_from_jax`),
  and a subspace clustering's bases and means → (bases, means) tensors
  (:func:`subspace_from_jax`);
* a transformer's params pytree → the port's ``state_dict``
  (:func:`transformer_params_from_jax`), its cache of K/V and recurrent
  states → the port's (:func:`cache_from_jax`), and a K/V cache back
  (:func:`cache_to_jax`);
* a streaming session's tree, pending leaf, counters and model → a port
  :class:`~repro_torch.stream.StreamingSession`
  (:func:`streaming_state_from_jax`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.assignment import Assignment
from .core.coreset import Coreset
from .core.recovery import RecoveryResult

__all__ = [
    "cache_from_jax",
    "coreset_from_jax",
    "subspace_from_jax",
    "cache_to_jax",
    "streaming_state_from_jax",
    "to_assignment",
    "to_recovery",
    "to_tensor",
    "transformer_params_from_jax",
]


def to_assignment(matrix, scheme: str, params: dict) -> Assignment:
    return Assignment(matrix=np.array(matrix, dtype=np.uint8), scheme=str(scheme), params=dict(params))


def to_recovery(
    *, b, b_full, a, delta: float, feasible: bool, uncovered, method: str
) -> RecoveryResult:
    return RecoveryResult(
        b=np.array(b, dtype=np.float64),
        b_full=np.array(b_full, dtype=np.float64),
        a=np.array(a, dtype=np.float64),
        delta=float(delta),
        feasible=bool(feasible),
        uncovered=np.array(uncovered, dtype=np.int64),
        method=str(method),
    )


def to_tensor(array, device, dtype=torch.float32) -> torch.Tensor:
    """A copy of a numpy array as a tensor on ``device``."""
    return torch.as_tensor(np.array(array), dtype=dtype, device=torch.device(device))


def coreset_from_jax(points, weights) -> Coreset:
    """A reference coreset's ``points`` (m, d) and ``weights`` (m,) → the
    port's :class:`Coreset` of f32 CPU tensors."""
    return Coreset(
        points=torch.tensor(np.asarray(points), dtype=torch.float32),
        weights=torch.tensor(np.asarray(weights), dtype=torch.float32),
    )


def subspace_from_jax(bases, means) -> tuple[torch.Tensor, torch.Tensor]:
    """A reference subspace clustering's ``bases`` (k, d, r) and ``means``
    (k, d) → f32 CPU tensors, as :func:`~repro_torch.core.subspace.subspace_cost`
    takes them."""
    return (
        torch.tensor(np.asarray(bases), dtype=torch.float32),
        torch.tensor(np.asarray(means), dtype=torch.float32),
    )


def _tensor(a) -> torch.Tensor:
    """A numpy array (bfloat16 from ml_dtypes included) as a CPU tensor of
    the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def transformer_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The reference's params pytree (leaves as numpy arrays) → the state
    dict of :class:`repro_torch.models.transformer.Transformer` (CPU tensors).

    The leaves of ``tree["unit"]["slot<i>"]`` carry a leading ``reps`` axis;
    layer ``r·len(unit) + i`` is rep ``r`` of slot ``i``.  Nested dicts give
    dotted names, so an ``attn_moe`` layer's subtree lands as
    ``blocks.<l>.moe.router``, ``blocks.<l>.moe.w_gate`` …
    ``blocks.<l>.moe.shared.down``, the names of :class:`~repro_torch.models.moe.MoE`.
    """
    if "tail" in tree:
        raise NotImplementedError("transformer_params_from_jax: tail blocks are not ported yet")
    sd = {}
    unit = tree["unit"]
    n_slots = len(unit)
    for si in range(n_slots):
        for name, leaf in _flatten(unit[f"slot{si}"]):
            leaf = np.asarray(leaf)
            for r in range(leaf.shape[0]):
                sd[f"blocks.{r * n_slots + si}.{name}"] = _tensor(leaf[r])
    for name in ("embed", "final_norm", "lm_head"):
        if name in tree:
            sd[name] = _tensor(tree[name])
    return sd


def cache_from_jax(tree, n_layers: int | None = None) -> list[dict[str, torch.Tensor]]:
    """The reference's cache {"unit": {"slot<i>": {...}}}, whose leaves carry a
    leading ``reps`` axis → the port's per-layer list of dicts: layer
    ``r·len(unit) + i`` takes rep ``r`` of every leaf of slot ``i``.  An
    attention slot gives {"k", "v"} (B, S, KV, dh), an mLSTM slot
    {"C", "n", "m", "conv"}, an sLSTM slot {"h", "c", "n", "m"}, and a
    recurrent slot of the reference's ``prefill``, ``{}``, gives ``{}``.
    ``n_layers`` is needed only when every slot is ``{}``."""
    if "tail" in tree:
        raise NotImplementedError("cache_from_jax: tail blocks are not ported yet")
    unit = tree["unit"]
    n_slots = len(unit)
    leaves = [np.asarray(leaf) for slot in unit.values() for leaf in slot.values()]
    if leaves:
        n = leaves[0].shape[0] * n_slots
        if n_layers is not None and n_layers != n:
            raise ValueError(f"cache_from_jax: the cache holds {n} layers, not {n_layers}")
    elif n_layers is None:
        raise ValueError("cache_from_jax: every slot is empty; pass n_layers")
    else:
        n = n_layers
    return [
        {key: _tensor(np.asarray(leaf)[li // n_slots]) for key, leaf in unit[f"slot{li % n_slots}"].items()}
        for li in range(n)
    ]


def cache_to_jax(cache) -> dict:
    """The port's per-layer cache → the reference's layout, as numpy f32
    arrays (reps, B, S, KV, dh) of one slot."""
    return {"unit": {"slot0": {
        key: np.stack([c[key].float().cpu().numpy() for c in cache]) for key in ("k", "v")
    }}}


def streaming_state_from_jax(session, *, device=None, scenario=None):
    """A reference ``StreamingSession`` → a port one that continues from the
    same state, on ``device`` (the card by default).

    Carried: the configuration (d, k, nodes, leaf size, fanout, coreset
    size, bicriteria iterations, squared, seed, solve iterations, elastic
    policy, recovery method), the bucket→node assignment as it stands
    (elastic patches included), every bucket with its level and ``seq``,
    the pending leaf, the tree's counters, and the serving model (centers,
    version and the staleness clock).  Not carried: the pattern cache and
    the straggle streaks, which start afresh, and the scenario (pass
    ``scenario=``).  The reduce's draws come from ``(seed, seq)`` in the
    port's stream, so trees built on from here part from the reference's
    after the next compaction.
    """
    from .core.resilience import ElasticPolicy
    from .stream import Bucket, StreamingSession

    buf, res = session.buffer, session.resilience
    a = res.assignment
    port = StreamingSession(
        session.d, session.k,
        num_nodes=int(a.num_nodes),
        scheme=str(a.scheme).split("+")[0],
        ell=a.params.get("ell", 2),
        leaf_size=buf.leaf_size,
        fanout=buf.fanout,
        coreset_size=buf.m,
        scenario=scenario,
        elastic=ElasticPolicy(**dataclasses.asdict(res.elastic)),
        recovery_method=res.recovery_method,
        squared=buf.squared,
        seed=session.seed,
        solve_iters=session.solve_iters,
        device=device,
    )
    dev = port.device
    assignment = to_assignment(a.matrix, a.scheme, a.params)
    port.resilience.assignment = assignment
    port.resilience._assignment_lineage.add(id(assignment))
    pb = port.buffer
    pb.bicriteria_iters = buf.bicriteria_iters
    pb.levels = [
        [
            Bucket(points=to_tensor(b.points, dev), weights=to_tensor(b.weights, dev),
                   level=int(b.level), seq=int(b.seq))
            for b in lv
        ]
        for lv in buf.levels
    ]
    pb._pending = [to_tensor(p, dev) for p in buf._pending]
    pb._pending_n = int(buf._pending_n)
    pb.compactions = int(buf.compactions)
    pb.leaf_compactions = int(buf.leaf_compactions)
    pb.blocking_compactions = int(buf.blocking_compactions)
    pb._seq = int(buf._seq)
    if session._centers is not None:
        port._centers = to_tensor(session._centers, dev)
    port._version = int(session._version)
    port._ingested = int(session._ingested)
    port._ingests = int(session._ingests)
    port._points_at_solve = int(session._points_at_solve)
    port._ingests_at_solve = int(session._ingests_at_solve)
    return port

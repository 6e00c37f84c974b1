"""The registered hot paths the sync audit runs (the twin of the
reference's ``analysis/hotpaths.py``).

Each :class:`HotPathSpec` binds a ``@compiled_path`` registry name to a
concrete, *small* instantiation of that path: the raw callable the
production code runs, plus its declared shape buckets.  The audit
(:mod:`repro_torch.analysis.sync_audit`) then runs each bucket twice, with
different values, and proves per path:

* **zero host syncs**: no aten op moves a value to the host;
* **one program per bucket**: the two calls run the same sequence of aten
  ops with the same shapes (nothing value-dependent changes the launches,
  the twin of the reference's one trace per bucket).

The paths are the reference's four, on the port's callables:

``train.train_step``
    loss → grad → AdamW (:func:`repro_torch.train.train_step.make_train_step`'s
    product; a tiny config, since the audit checks structure, not numerics).
``local.masked_reduce``
    the fused mask → on-device recovery solve → Lemma-3 combine that
    :meth:`repro_torch.core.executor.LocalExecutor.resilient_reduce_masked`
    runs (``_masked_step_raw``), over :func:`repro_torch.core.kmeans._local_cost_fn`.
``query.assign_min``
    the query engine's nearest-center step (:func:`repro_torch.stream.query._assign_run`),
    bucketed by padded batch size.
``serve.batch_assign``
    the serving frontend's micro-batch step
    (:func:`repro_torch.serve.frontend._batch_assign_run`).

``build(device)`` places everything on ``device``, so the same spec runs on
the CPU (the plain versions of the kernels) in the tests and on the card
(the hand-written kernels) in ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

__all__ = ["HotPathSpec", "hot_path_specs"]


@dataclasses.dataclass(frozen=True)
class HotPathSpec:
    """One auditable hot path.

    ``build(device)`` returns ``(fn, buckets)``: ``fn`` is the raw callable
    and ``buckets`` a sequence of ``(label, calls)``, ``calls`` two argument
    tuples of one shape and different values.
    """

    name: str               # audit display name
    registry_name: str      # must exist in repro_torch.analysis.registry after build
    description: str
    build: Callable[..., tuple]


def _gen(device, seed: int):
    import torch

    return torch.Generator(device=device).manual_seed(seed)


def _build_train_step(device):
    import dataclasses as dc

    import torch

    from ..configs.qwen3_4b import smoke_config
    from ..models import transformer as T
    from ..train.optimizer import AdamWConfig
    from ..train.train_step import init_train_state, make_train_step

    cfg = dc.replace(
        smoke_config(), n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
        d_ff=64, head_dim=16, vocab=64,
    ).validate()
    state = init_train_state(cfg, generator=_gen(device, 0))
    step = make_train_step(cfg, T.ModelContext(), AdamWConfig())
    gen = _gen(device, 1)

    def batch(n_tok: int, seq: int):
        return {
            "tokens": torch.randint(0, cfg.vocab, (n_tok, seq), device=device, generator=gen),
            "group_weights": torch.ones((4,), dtype=torch.float32, device=device),
        }

    buckets = [
        ("b8xt16", [(state, batch(8, 16)), (state, batch(8, 16))]),
        ("b16xt16", [(state, batch(16, 16)), (state, batch(16, 16))]),
    ]
    return step, buckets


def _build_masked_reduce(device):
    import torch

    from ..core.assignment import cyclic_assignment
    from ..core.executor import LocalExecutor
    from ..core.kmeans import _local_cost_fn

    step = LocalExecutor()._masked_step_raw(_local_cost_fn(False, "auto"), n_node=2, iters=8)
    A = torch.as_tensor(cyclic_assignment(8, 4, 2).matrix, dtype=torch.float32, device=device)
    use_ov = torch.zeros((), dtype=torch.bool, device=device)
    b_ov = torch.zeros((4,), dtype=torch.float32, device=device)
    gen = _gen(device, 2)
    centers = torch.randn((3, 5), generator=gen, device=device)

    def call(m: int, alive):
        xs = torch.randn((4, m, 5), generator=gen, device=device)
        ws = torch.ones((4, m), dtype=torch.float32, device=device)
        return (A, torch.as_tensor(alive, device=device), use_ov, b_ov, xs, ws, centers)

    # The second call of a bucket loses another node: a new straggler
    # pattern is data for the same launches.
    patterns = ([True, True, True, False], [False, True, True, True])
    buckets = [(f"m{m}", [call(m, p) for p in patterns]) for m in (8, 16)]
    return step, buckets


def _build_assign(factory, c_shape, sizes, seed: int):
    def build(device):
        import torch

        run = factory("auto")
        gen = _gen(device, seed)
        c = torch.randn(c_shape, generator=gen, device=device)

        def call(n: int):
            return (torch.randn((n, c_shape[1]), generator=gen, device=device), c)

        return run, [(f"q{n}", [call(n), call(n)]) for n in sizes]

    return build


def _build_query_assign(device):
    from ..stream.query import _assign_run

    return _build_assign(_assign_run, (6, 4), (64, 128), 3)(device)


def _build_serve_batch_assign(device):
    from ..serve.frontend import _batch_assign_run

    return _build_assign(_batch_assign_run, (5, 3), (64, 256), 4)(device)


def hot_path_specs() -> Sequence[HotPathSpec]:
    """The four registered hot paths, in tier order."""
    return (
        HotPathSpec(
            name="train_step",
            registry_name="train.train_step",
            description="loss → grad → AdamW train step (tiny config)",
            build=_build_train_step,
        ),
        HotPathSpec(
            name="masked_reduce",
            registry_name="local.masked_reduce",
            description="fused on-device recovery solve + Lemma-3 combine",
            build=_build_masked_reduce,
        ),
        HotPathSpec(
            name="query_assign",
            registry_name="query.assign_min",
            description="streaming nearest-center dispatch (bucketed batches)",
            build=_build_query_assign,
        ),
        HotPathSpec(
            name="serve_batch_assign",
            registry_name="serve.batch_assign",
            description="frontend micro-batch dispatch (serving tier)",
            build=_build_serve_batch_assign,
        ),
    )

"""The control of ``sift1m-s10-cyclic4``, and the faults planted in the
program that its check has to catch.  Each entry of :data:`PLANTED` is a
context manager of the configuration; while it is open, every solve runs
with it.

* ``control``: the plain reference computed in TF32, where the
  configuration states float32, put in the program's place: the program's
  ``assign_min`` runs the reference's :func:`assign_min_tf32` and its
  on-device recovery solve the reference's :func:`device_recovery_tf32`;
  the rest of Algorithm 1 is the program's.
* ``lloyd_skipped``, ``lloyd_halved``: the workers' local Lloyd iterations
  cut to none (the local centers are the seeding's), or to half their
  count.
* ``weiszfeld_one``: one Weiszfeld step a Lloyd iteration, where the
  configuration states ``weiszfeld_iters``.
* ``coordinator_skipped``: the coordinator's iterations cut to none.
* ``seeding_collapsed``: the k-median++ loop skipped, every center left at
  the first draw.
* ``seeding_uniform``: the seeding draws its centers by weight alone, not
  by distance.
"""

from __future__ import annotations

import contextlib

import torch

from harness import files


@contextlib.contextmanager
def _replaced(module, name: str, make):
    """``module.name`` replaced by ``make(the original)`` while open."""
    inner = getattr(module, name)
    setattr(module, name, make(inner))
    try:
        yield
    finally:
        setattr(module, name, inner)


@contextlib.contextmanager
def installed(cfg: dict):
    from repro_torch.core import recovery
    from repro_torch.kernels import dispatch

    ref = files.reference(cfg["name"])
    impls = dispatch._REGISTRY["assign_min"]
    saved = dict(impls)

    def solve(A_R, *, iters: int = 500, lr: float = 1.0, device=None):
        A_R = torch.as_tensor(A_R, dtype=torch.float32, device=recovery.resolve_device(device))
        return ref.device_recovery_tf32(A_R, iters=iters, lr=lr)

    impls["cuda"] = impls["torch_ref"] = ref.assign_min_tf32
    try:
        with _replaced(recovery, "device_recovery", lambda inner: solve):
            yield
    finally:
        impls.update(saved)


def _local_iters(scale: float):
    from repro_torch.core import kmedian

    return _replaced(kmedian, "_local_solve",
                     lambda inner: lambda *a, **kw: inner(*a, **{**kw, "iters": int(kw["iters"] * scale)}))


def weiszfeld_one(cfg: dict):
    from repro_torch.core import kmeans

    return _replaced(kmeans, "_weiszfeld_update", lambda inner: lambda *a, **kw: inner(*a, **{**kw, "iters": 1}))


def coordinator_skipped(cfg: dict):
    """The coordinator's solve is the one ``lloyd`` call on a single set of
    points (the workers' are batched)."""
    from repro_torch.core import kmeans

    def make(inner):
        return lambda x, k, **kw: inner(x, k, **({**kw, "iters": 0} if x.dim() == 2 else kw))

    return _replaced(kmeans, "lloyd", make)


def seeding_collapsed(cfg: dict):
    from repro_torch.core import kmeans

    def seeding(x, w, k, median, gen, impl):
        B, _, d = x.shape
        first = kmeans._sample(kmeans._logits(w, torch.ones_like(w)), gen)
        return x[torch.arange(B, device=x.device), first].unsqueeze(1).expand(B, k, d).contiguous()

    return _replaced(kmeans, "_plusplus_batched", lambda inner: seeding)


def seeding_uniform(cfg: dict):
    from repro_torch.core import kmeans

    def seeding(x, w, k, median, gen, impl):
        pick = torch.multinomial(w, k, replacement=True, generator=gen)
        return x[torch.arange(x.shape[0], device=x.device)[:, None], pick].contiguous()

    return _replaced(kmeans, "_plusplus_batched", lambda inner: seeding)


PLANTED = {
    "control": installed,
    "lloyd_skipped": lambda cfg: _local_iters(0.0),
    "lloyd_halved": lambda cfg: _local_iters(0.5),
    "weiszfeld_one": weiszfeld_one,
    "coordinator_skipped": coordinator_skipped,
    "seeding_collapsed": seeding_collapsed,
    "seeding_uniform": seeding_uniform,
}

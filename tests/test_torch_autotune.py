"""Shape buckets, warm-up plans and ``auto`` dispatch of the port, on the CPU.

``repro_torch.kernels.autotune`` beside ``repro.kernels.autotune``:

* ``shape_bucket``, the ``REPRO_WARM_START`` switch and
  ``WarmupReport.merge`` equal the reference's (the reference's report also
  counts measurements, which the port does not make).
* ``warmup`` runs its plan in order, labels what it completed, and counts a
  failing entry without raising it.
* ``auto`` is a function of the tensors' device alone: a CPU tensor gets the
  plain version at every size, whatever ``REPRO_AUTOTUNE`` says, so a CPU
  result never depends on timing or on a file an earlier process wrote; a
  CUDA tensor gets the kernel.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.kernels import autotune as ref_at
from repro_torch.kernels import autotune, dispatch
from repro_torch.kernels.pairwise_dist import ops as pd
from repro_torch.kernels.weighted_segsum import ops as ss


def test_shape_bucket_matches_the_reference():
    for v in list(range(0, 70)) + [127, 128, 129, 1000, 4096, 4097, 10**6]:
        assert autotune.shape_bucket(v) == ref_at.shape_bucket(v), v


def test_warm_start_switch_matches_the_reference(monkeypatch):
    assert autotune.WARM_START_ENV == ref_at.WARM_START_ENV
    monkeypatch.delenv(autotune.WARM_START_ENV, raising=False)
    assert autotune.warm_start_enabled() and ref_at.warm_start_enabled()
    for value in ("0", "off", "False", "NO", "none", "model", "analytic", "1", "on", "yes"):
        monkeypatch.setenv(autotune.WARM_START_ENV, value)
        assert autotune.warm_start_enabled() == ref_at.warm_start_enabled(), value


def test_warmup_report_merge_matches_the_reference():
    a = dict(warmed=2, errors=1, seconds=0.5, labels=("x", "y"))
    b = dict(warmed=1, errors=2, seconds=0.25, labels=("z",))
    got = autotune.WarmupReport(**a).merge(autotune.WarmupReport(**b))
    want = ref_at.WarmupReport(**a).merge(ref_at.WarmupReport(**b))
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(want) if f.name != "measured"]
    assert got.__dict__ == {n: getattr(want, n) for n in names}


def test_warmup_runs_plan_counts_errors_and_reports():
    def boom():
        raise RuntimeError("build failed")

    def bucket_c():
        return (torch.zeros(3), [torch.ones(1)])

    plan = [("bucket-a", lambda: torch.zeros(4, 4)), boom, ("bucket-b", lambda: torch.ones(2) * 2), bucket_c]
    report = autotune.warmup(plan)
    assert (report.warmed, report.errors, report.labels) == (3, 1, ("bucket-a", "bucket-b", "bucket_c"))
    assert report.seconds >= 0.0


# (n, k, d): small shapes and ones whose (n, k) matrix passes the reference's
# 1 MB measuring threshold and 32 MiB materialization budget.
AUTO_GRID = [(64, 4, 2), (4096, 300, 17), (65536, 256, 8), (40000, 300, 3)]


@pytest.mark.parametrize("autotune_env", [None, "1", "0"])
@pytest.mark.parametrize("n,k,d", AUTO_GRID, ids=[f"n{n}k{k}d{d}" for n, k, d in AUTO_GRID])
def test_cpu_auto_is_the_plain_version_at_every_size(monkeypatch, autotune_env, n, k, d):
    if autotune_env is None:
        monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    else:
        monkeypatch.setenv("REPRO_AUTOTUNE", autotune_env)
    rng = np.random.default_rng(n + k + d)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32))
    for op in ("assign_min", "weighted_segsum", "pairwise_sqdist"):
        assert dispatch.resolve(op, "auto", x, c)[0] == "torch_ref"
    if n * k <= 4096 * 300:  # the whole product only where it stays small
        ai, ad = pd.assign_min(x, c)
        ri, rd = pd.assign_min(x, c, impl="torch_ref")
        assert torch.equal(ai, ri) and torch.equal(ad, rd)
        w = torch.from_numpy(rng.random(n).astype(np.float32))
        got = ss.weighted_segsum(x, w, ai, k)
        want = ss.weighted_segsum(x, w, ai, k, impl="torch_ref")
        assert all(torch.equal(g, h) for g, h in zip(got, want))


def test_cuda_tensor_always_resolves_to_the_kernel():
    fake = types.SimpleNamespace(device=torch.device("cuda", 0))
    for op in ("assign_min", "weighted_segsum", "pairwise_sqdist"):
        assert dispatch.resolve(op, "auto", fake, fake)[0] == "cuda"
        assert dispatch.resolve(op, "torch_ref", fake, fake)[0] == "torch_ref"

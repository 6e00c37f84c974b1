"""Each cell rehearsed on the CPU at a tiny size: the driver, the window and
the check against the plain reference, run as ``run.execute`` runs them
(only the look for a card is skipped).  A sound run comes out correct; the
control, and each fault that the cell can have planted underneath the timed
path, come out not correct.

The tiny sizes read other gaps than the cell's own, so these runs hold
them to limits of their own (``*_TINY_LIMITS``), set from these runs as the
cell's are from its runs on the card.
"""

import contextlib

import numpy as np
import pytest
import torch

import run
from harness import files

SOLVE = "solve-sift1m-k1024-t3"
SOLVE_TINY = dict(points=3000, dim=8, local_iters=10, coord_iters=20,
                  data={"kind": "gaussian_mixture", "components": 16, "mean_low": 0.0, "mean_high": 64.0,
                        "spread": 8.0})
SOLVE_TINY_LIMITS = {"b_gap": 1e-5, "mass_gap": 1e-5, "cost_gap": 1e-6, "local_drop": 0.05,
                     "coord_residual": 0.05, "dup_share": 0.01}
TRAIN = "train-qwen3-1.7b-fr4-iid"
TRAIN_TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=16, seq_len=32, data_vocab=256)
TRAIN_TINY_LIMITS = {"loss_gap": 1e-3, "grad_gap": 2e-2, "update_gap": 2e-2}
SEED = 2**31 + 977


@pytest.fixture(autouse=True)
def cpu_solver(monkeypatch):
    """The session's on-device recovery solve on the CPU (it asks for the
    card by default)."""
    from repro_torch.core import recovery

    monkeypatch.setattr(recovery, "resolve_device", lambda device=None: torch.device("cpu"))


def execute(cell, seed=SEED):
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", "0", "--trace", "0"])
    if cell == SOLVE:
        return run.execute(args, torch.device("cpu"), cfg_over=SOLVE_TINY, traffic_over={"k": 8},
                           limits_over=SOLVE_TINY_LIMITS)
    return run.execute(args, torch.device("cpu"), cfg_over=TRAIN_TINY, limits_over=TRAIN_TINY_LIMITS)


def test_solve_sound_run_is_correct():
    res = execute(SOLVE)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"solve_s", "setup_s"}
    assert list(res)[-1] == "checks" and set(res["checks"]) == set(SOLVE_TINY_LIMITS)


SOLVE_CONTROLS = files.load_module(files.BENCH / "controls" / "sift1m-s10-cyclic4.py", "control")


def planted(name):
    return SOLVE_CONTROLS.PLANTED[name]({**files.config("sift1m-s10-cyclic4"), **SOLVE_TINY})


def test_solve_control_is_not_correct():
    """The reference in TF32 in the program's place reads over the gaps'
    limits; its solve is as good as the program's, and reads under the
    others."""
    with planted("control"):
        res = execute(SOLVE)
    assert not res["correct"]
    assert all(res["checks"][k]["value"] > 3 * SOLVE_TINY_LIMITS[k] for k in ("b_gap", "mass_gap", "cost_gap"))


@pytest.mark.parametrize("fault, number", [("lloyd_skipped", "local_drop"), ("coordinator_skipped", "coord_residual"),
                                           ("seeding_collapsed", "dup_share")])
def test_solve_cut_iterations_and_a_collapsed_seeding_are_not_correct(fault, number):
    """A solve whose local or coordinator iterations were skipped, or whose
    seeding left every center on one point, reads over the limit of the
    number that looks at that stage, though its answer agrees with
    itself."""
    with planted(fault):
        res = execute(SOLVE)
    assert not res["correct"]
    assert res["checks"][number]["value"] > 3 * SOLVE_TINY_LIMITS[number], res["checks"]
    assert res["checks"]["cost_gap"]["value"] <= SOLVE_TINY_LIMITS["cost_gap"]


@contextlib.contextmanager
def stale_answers():
    """A solve that returns its state unchanged: every call answers with
    the session's first answer."""
    from repro_torch.core.resilience import ResilienceSession

    inner, first = ResilienceSession.kmedian, []

    def kmedian(self, *args, **kwargs):
        if not first:
            first.append(inner(self, *args, **kwargs))
        return first[0]

    ResilienceSession.kmedian = kmedian
    try:
        yield
    finally:
        ResilienceSession.kmedian = inner


@contextlib.contextmanager
def half_the_points():
    """The full-data cost over half of the points, their mean taken over
    that half (doubled)."""
    from repro_torch.core import kmeans

    inner = kmeans.clustering_cost

    def cost(x, centers, **kwargs):
        return 2.0 * inner(x[: x.shape[0] // 2], centers, **kwargs)

    kmeans.clustering_cost = cost
    try:
        yield
    finally:
        kmeans.clustering_cost = inner


@contextlib.contextmanager
def altered_center():
    """One coordinator center moved where the answer is produced."""
    from repro_torch.core import kmedian

    inner = kmedian._coordinator_pipeline

    def pipeline(*args, **kwargs):
        centers, cost, y, wy = inner(*args, **kwargs)
        centers = centers.copy()
        centers[0] += 1.0
        return centers, cost, y, wy

    kmedian._coordinator_pipeline = pipeline
    try:
        yield
    finally:
        kmedian._coordinator_pipeline = inner


@pytest.mark.parametrize("fault", [stale_answers, half_the_points, altered_center])
def test_solve_faults_are_not_correct(fault):
    with fault():
        res = execute(SOLVE)
    assert not res["correct"] and res["failed"] == 1


def test_train_sound_run_is_correct():
    res = execute(TRAIN)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert res["metrics"]["train_tokens_per_s"]["value"] > 0


def test_train_mfu_reads_the_window_steps():
    """The MFU reader counts the distinct sequences of the window's steps."""
    from types import SimpleNamespace

    cfg = {**files.config("qwen3-1.7b-fr4"), **TRAIN_TINY}
    runner = files.driver(cfg["driver"]).setup(cfg, files.traffic("closed-iid-p015"), SEED, torch.device("cpu"))
    runner.step(0)
    view = SimpleNamespace(runner=runner, units=1, window_s=1.0, config=cfg, files=files, peaks=files.peaks())
    seqs = cfg["shards"] * cfg["microbatch"]  # step 3 keeps every shard
    per_seq = files.mfu(cfg["name"]).flops_per_sequence(cfg)
    assert files.metric("train_mfu").read(view) == pytest.approx(100.0 * per_seq * seqs / files.peaks()["flops_per_s"]["bf16"])


@contextlib.contextmanager
def unchanged_state():
    """A step that returns its state unchanged: AdamW updates nothing."""
    from repro_torch.train import train_step
    from repro_torch.train.optimizer import OptState

    inner = train_step.adamw_update

    def adamw_update(cfg, params, grads, state, mesh=None, specs=None):
        zero = torch.zeros((), device=next(iter(params.values())).device)
        return params, OptState(step=state.step + 1, m=state.m, v=state.v), {"lr": 0.0, "grad_norm": zero}

    train_step.adamw_update = adamw_update
    try:
        yield
    finally:
        train_step.adamw_update = inner


@contextlib.contextmanager
def half_the_batch():
    """Each group's loss over half of its shards, their mean taken over
    that half: the second slot reads the first's loss."""
    from repro_torch.models import transformer

    inner = transformer.group_losses

    def group_losses(*args, **kwargs):
        per_slot, tok, aux = inner(*args, **kwargs)
        per_slot = torch.cat([per_slot[:1], per_slot[:1], per_slot[2:]])
        return per_slot, tok, aux

    transformer.group_losses = group_losses
    try:
        yield
    finally:
        transformer.group_losses = inner


@pytest.mark.parametrize("fault", [unchanged_state, half_the_batch])
def test_train_faults_are_not_correct(fault):
    with fault():
        res = execute(TRAIN)
    assert not res["correct"], res["checks"]


def test_train_reference_control_and_fault_read_over_the_tiny_limits():
    """The control (the reference in float8) and the half-batch fault read
    on the reference itself, as ``calibrate.py --read`` reads them."""
    cfg = {**files.config("qwen3-1.7b-fr4"), **TRAIN_TINY}
    controls = files.load_module(files.BENCH / "controls" / "qwen3-1.7b-fr4.py", "control")
    driver = files.driver(cfg["driver"])
    for read in (controls.control, controls.half_batch):
        runner = driver.setup(cfg, files.traffic("closed-iid-p015"), SEED, torch.device("cpu"))
        got = read(runner)
        assert any(got[k] > TRAIN_TINY_LIMITS[k] for k in got), (read.__name__, got)
    assert np.isfinite(list(got.values())).all()

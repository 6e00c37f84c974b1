"""``train-deepseek-v2-lite-ep8-4k-iid`` rehearsed on the CPU at a tiny size,
as ``run.execute`` runs it: a sound run comes out correct; faults planted in
the program under the timed path come out not correct; the control (the
reference in float8) and the same faults read on the reference, as
``calibrate.py --read`` reads them, read over the tiny limits.  The tiny
sizes read other gaps than the cell's own, so they are held to limits of
their own, set from these runs as the cell's are from its runs on the
card."""

import contextlib

import numpy as np
import pytest
import torch

import run
from harness import files

CELL = "train-deepseek-v2-lite-ep8-4k-iid"
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, seq_len=32, n_routed_experts=4, experts_held=[0, 4],
            published={"n_routed_experts": 16, "vocab_size": 102400, "num_hidden_layers": 27})
TINY_LIMITS = {"loss_gap": 1.5e-3, "grad_gap": 2e-2, "update_gap": 1e-2, "route_diff_share": 2e-2}
SEED = 2**31 + 977


@pytest.fixture(autouse=True)
def cpu_solver(monkeypatch):
    from repro_torch.core import recovery

    monkeypatch.setattr(recovery, "resolve_device", lambda device=None: torch.device("cpu"))


def execute():
    args = run.parse(["--workload", CELL, "--seed", str(SEED), "--seconds", "0", "--trace", "0"])
    return run.execute(args, torch.device("cpu"), cfg_over=TINY, limits_over=TINY_LIMITS)


def test_sound_run_is_correct():
    res = execute()
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"} and res["attempted"] == 1
    assert set(res["checks"]) == set(TINY_LIMITS)


@contextlib.contextmanager
def patched(module, name, make):
    inner = getattr(module, name)
    setattr(module, name, make(inner))
    try:
        yield
    finally:
        setattr(module, name, inner)


def shared_skipped():
    """The MoE layers without their shared experts."""
    from repro_torch.models import moe

    def make(inner):
        def moe_apply(p, x, cfg, ctx=None, rows_valid=None):
            shared = p.shared
            p.shared = None
            try:
                return inner(p, x, cfg, ctx, rows_valid)
            finally:
                p.shared = shared
        return moe_apply

    return patched(moe, "moe_apply", make)


def latent_norm_skipped():
    """The latent c of each attention layer not normalised."""
    from types import SimpleNamespace

    from repro_torch.models import layers, mla

    proxy = SimpleNamespace(**{k: getattr(layers, k) for k in dir(layers) if not k.startswith("__")})
    proxy.rmsnorm = lambda x, scale, eps=1e-6: x
    return patched(mla, "L", lambda inner: proxy)


def mscale_left_out():
    """The softmax scale without YaRN's mscale²."""
    from repro_torch.models import mla

    def scale(cfg):
        return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5

    return patched(mla, "mla_scale", lambda inner: scale)


def unchanged_state():
    """AdamW updates nothing."""
    from repro_torch.train import train_step
    from repro_torch.train.optimizer import OptState

    def make(inner):
        def adamw_update(cfg, params, grads, state, mesh=None, specs=None):
            zero = torch.zeros((), device=next(iter(params.values())).device)
            return params, OptState(step=state.step + 1, m=state.m, v=state.v), {"lr": 0.0, "grad_norm": zero}
        return adamw_update

    return patched(train_step, "adamw_update", make)


@pytest.mark.parametrize("fault", [shared_skipped, latent_norm_skipped, mscale_left_out, unchanged_state])
def test_faults_planted_in_the_program_are_not_correct(fault):
    with fault():
        res = execute()
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("read", ["control", "shared_skipped", "latent_norm_skipped", "mscale_left_out"])
def test_control_and_faults_on_the_reference_read_over_the_tiny_limits(read):
    cfg = {**files.config("deepseek-v2-lite-ep8"), **TINY}
    controls = files.load_module(files.BENCH / "controls" / "deepseek-v2-lite-ep8.py", "control")
    runner = files.driver(cfg["driver"]).setup(cfg, files.traffic("closed-iid-p015"), SEED, torch.device("cpu"))
    runner.step(0)
    got = getattr(controls, read)(runner)
    assert set(got) == set(TINY_LIMITS) and np.isfinite(list(got.values())).all()
    assert any(got[k] > TINY_LIMITS[k] for k in got), got

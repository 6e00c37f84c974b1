"""Gradients through the MoE, xLSTM and RecurrentGemma blocks on an LM mesh
against the meshless port, on the CPU over gloo ranks (one start per
world size, ``mesh_runs.train_lm_rank``).  All f32 smoke configs.

* MoE (deepseek-moe-16b's smoke config: 8 experts, top-2, 2 shared) on
  (1, 2) and (2, 2) under both routings: the experts over ``model``, the
  combine chained over the model ranks (its backward the chain reversed),
  the shared experts' ``d_ff`` split.  Routing is held as in
  ``tests/test_torch_moe.py``: the mesh run's selections (each rank's
  tokens' experts and its experts' kept tokens at its data shard's
  capacity) are joined into the meshless form and replayed into the
  meshless port (``models.moe.recorded_routing``), so both route alike;
  on (2, 2) the union of the shards' kept tokens is the meshless capacity.
  Under ``local`` routing the mesh's aux loss is the mean of the data
  shards' own; the meshless oracle takes that mean from the same router
  scores.  One (1, 2) case replays a record in which no token picks model
  rank 1's experts: its combine weights are all zero, and its backward
  collectives still run (no deadlock).
* xLSTM (the sLSTM head-parallel, the mLSTM with its weights gathered)
  and RecurrentGemma (RG-LRU and local attention with their weights
  gathered) on (2, 2).

Bands: the loss within 1e-6 relative; every first-step gradient block
within 1e-5 of its parameter's meshless max|g| (floored at 1e-5 of the
model's largest).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import deepseek_moe_16b, recurrentgemma_9b, xlstm_1_3b
from repro_torch.launch import distributed as D
from repro_torch.launch import mesh_runs
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.train.train_step import make_grad_fn

DEADLINE = 240.0  # seconds for one start of the ranks, setup to exit
OCFG = dict(lr=5e-3, warmup_steps=2, total_steps=5)
MOE_CASES = [((1, 2), "pjit", False), ((1, 2), "local", False), ((1, 2), "pjit", True),
             ((2, 2), "pjit", False), ((2, 2), "local", False)]
RECURRENT = {"xlstm-1.3b": xlstm_1_3b, "recurrentgemma-9b": recurrentgemma_9b}


def _f32(mod):
    return dataclasses.replace(mod.smoke_config(), compute_dtype="float32").validate()


def _case_id(case):
    shape, routing, idle = case
    return "x".join(map(str, shape)) + f"-{routing}" + ("-idle-rank" if idle else "")


def _weights(cfg, seed):
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _steered_routing(cfg, sd, batch, idle: range) -> list:
    """A meshless run's routing record in which no token picks an expert
    of ``idle``: each layer's first selection (the tokens' top-k experts)
    is made with those experts' scores at −inf; the experts' kept tokens
    follow as the run selects them (an idle expert's column is all zero,
    so it keeps the first C tokens at weight 0)."""
    select, calls = M._topk, [0]

    def steered(x, k):
        if calls[0] % 2 == 0:
            x = x.clone()
            x[:, list(idle)] = float("-inf")
        calls[0] += 1
        return select(x, k)

    model = T.model_from_state_dict(cfg, {k: v.clone() for k, v in sd.items()})
    M._topk = steered
    try:
        with torch.no_grad(), M.recorded_routing() as log:
            T.loss_fn(model, batch, cfg, T.ModelContext())
    finally:
        M._topk = select
    return log


def _batch(cfg, seed=0, rows=8, T_len=16):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab, (rows, T_len), generator=g),
            "group_weights": torch.tensor([1.0, 0.0, 1.0, 0.5])}


@pytest.fixture(scope="module")
def inputs():
    moe = _f32(deepseek_moe_16b)
    sd, batch = _weights(moe, 1), _batch(moe)
    out = {"moe": moe, "moe_sd": sd, "moe_batch": batch,
           "steered": _steered_routing(moe, sd, batch, range(moe.moe.num_experts // 2, moe.moe.num_experts))}
    for name, mod in RECURRENT.items():
        cfg = _f32(mod)
        out[name] = (cfg, _weights(cfg, 2), _batch(cfg, seed=3))
    return out


@pytest.fixture(scope="module")
def port(inputs):
    jobs: dict = {}
    cfg = inputs["moe"]
    e_loc = cfg.moe.num_experts // 2
    for case in MOE_CASES:
        shape, routing, idle = case
        kw = dict(cfg=cfg, sd=inputs["moe_sd"], batches=[inputs["moe_batch"]], ocfg=OCFG, routing=routing)
        if idle:  # each model rank replays its part of the steered record
            kw["replay"] = [mesh_runs._experts_of(inputs["steered"], r, e_loc) for r in range(2)]
        jobs.setdefault(int(np.prod(shape)), []).append((case, ("step", shape, kw)))
    for name in RECURRENT:
        cfg, sd, batch = inputs[name]
        jobs[4].append((name, ("step", (2, 2), dict(cfg=cfg, sd=sd, batches=[batch], ocfg=OCFG))))
    got = {}
    for world, todo in sorted(jobs.items()):
        results = D.run_ranks(mesh_runs.train_lm_rank, world, backend="gloo", device="cpu", timeout=DEADLINE,
                              args=([job for _, job in todo],))
        got.update({key: res for (key, _), res in zip(todo, results)})
    return got


def _meshless_replay(routing, shape, n_loc: int) -> list:
    """The mesh run's selections (``routing[rank]``: per MoE layer, the
    rank's tokens' experts (N_loc, k) and its experts' kept tokens
    (E/m, C_s) in its shard's indices) in the meshless form: every token's
    experts (N, k) and every expert's kept tokens (E, nd·C_s)."""
    nd, m = shape
    grid = np.arange(nd * m).reshape(nd, m)
    routing = [[torch.from_numpy(t) for t in rank] for rank in routing]
    out = []
    for i in range(0, len(routing[0]), 2):
        out.append(torch.cat([routing[grid[s, 0]][i] for s in range(nd)]))
        out.append(torch.cat([torch.cat([routing[grid[s, r]][i + 1] + s * n_loc for s in range(nd)], dim=1)
                              for r in range(m)]))
    return out


def _shard_mean_aux(experts: list, nd: int):
    """``moe_apply`` with its aux loss replaced by the mean over nd data
    shards (rows in order) of each shard's own aux from the same router
    scores and the recorded experts: the mesh's ``local`` routing."""
    plain = M.moe_apply
    layer = [0]

    def apply(p, x, cfg, ctx=None):
        out, _ = plain(p, x, cfg, ctx)
        m = cfg.moe
        idx = experts[layer[0]]
        layer[0] += 1
        logits = x.reshape(-1, x.shape[-1]).float() @ p.router.float()
        per = []
        for lg, ix in zip(logits.chunk(nd), idx.chunk(nd)):
            frac = torch.zeros_like(lg).scatter_(1, ix, 1.0).mean(0) / m.top_k
            per.append(m.num_experts * torch.sum(frac * torch.softmax(lg, dim=-1).mean(0)))
        return out, torch.stack(per).mean()

    return apply


def _meshless_grads(cfg, sd, batch, replay=None):
    model = T.model_from_state_dict(cfg, {k: v.clone() for k, v in sd.items()})
    ctx = T.ModelContext()
    if replay is None:
        loss, _, grads = make_grad_fn(cfg, ctx)(model, batch)
    else:
        with M.recorded_routing(replay=replay):
            loss, _, grads = make_grad_fn(cfg, ctx)(model, batch)
    return float(loss), {n: g.numpy() for n, g in grads.items()}


def _assert_grads(got_loss, got, want_loss, want):
    assert abs(got_loss - want_loss) <= 1e-6 * abs(want_loss), (got_loss, want_loss)
    top = max(float(np.abs(w).max()) for w in want.values())
    gap, name = max((float(np.abs(got[n] - w).max()) / max(float(np.abs(w).max()), 1e-5 * top), n)
                    for n, w in want.items())
    assert gap <= 1e-5, (gap, name)


@pytest.mark.parametrize("case", MOE_CASES, ids=_case_id)
def test_moe_gradients_on_a_mesh_match_the_meshless_port(case, inputs, port, monkeypatch):
    shape, routing, idle = case
    cfg, batch = inputs["moe"], inputs["moe_batch"]
    res = port[case]
    assert res["lockstep"]
    n_loc = batch["tokens"].numel() // shape[0]
    replay = _meshless_replay(res["routing"], shape, n_loc)
    assert tuple(replay[1].shape) == (cfg.moe.num_experts, M.capacity(batch["tokens"].numel(), cfg.moe))
    if idle:
        assert all(int(e.max()) < 4 for e in replay[0::2]), "a token picked one of model rank 1's experts"
    if routing == "local" and shape[0] > 1:
        monkeypatch.setattr(M, "moe_apply", _shard_mean_aux(replay[0::2], shape[0]))
    want_loss, want = _meshless_grads(cfg, inputs["moe_sd"], batch, replay)
    _assert_grads(res["first"]["loss"], res["grads"], want_loss, want)
    assert res["first"]["calls"].get("chain_bwd", 0) > 0, res["first"]["calls"]
    if idle:
        assert not np.any(res["grads"]["blocks.0.moe.w_gate"][4:])


@pytest.mark.parametrize("name", list(RECURRENT))
def test_recurrent_gradients_on_a_2x2_mesh_match_the_meshless_port(name, inputs, port):
    cfg, sd, batch = inputs[name]
    res = port[name]
    assert res["lockstep"]
    want_loss, want = _meshless_grads(cfg, sd, batch)
    _assert_grads(res["first"]["loss"], res["grads"], want_loss, want)

"""Compression and checkpoints on an LM mesh (``train.compression`` and
``train.checkpoint`` under ``ctx.mesh``, ``Trainer(ctx=..., ckpt_dir=...)``)
against the reference and the meshless port, on the CPU over gloo ranks.

Each world size starts once (``run_ranks(mesh_runs.train_lm_rank, world)``
with every job of that world); a rank runs one intra-op thread.  The model
is qwen3-1.7b's smoke config in f32 at 2 layers with a vocab of 640: its
widths split so that quantization blocks straddle two ranks' columns.  At
block 256, ``lm_head`` (64, 640) gives each model rank 320 columns, so
global block 1 holds 64 of rank 0's and 192 of rank 1's, and the padded
block 2 lies on rank 1; the 32 columns a rank of ``wq`` and of the
FSDP-split ``embed`` share one block.  At block 48 every split last dim
straddles; at block 16 none does, and no ``pmax`` runs.

Bands:

* the mesh compression against the reference's
  ``compress_with_error_feedback`` on the same global gradient (the mesh
  step's, gathered), step after step with its own buffers: bit for bit.
  On each rank ``mesh_runs.compression_check`` (the card phase's check)
  holds the mesh path's dequantized gradient and buffer blocks to the
  meshless port's compression of the whole tensors narrowed, and to the
  buffers the step's ``apply`` left; here the meshless port's compression
  of the gathered gradient is held to the reference's fed the same numpy
  arrays through ``jnp``, and the mesh's buffers, gathered after the last
  step, to the reference's; the buffers lie on ``state_shardings``'
  blocks;
* three compressed mesh steps against three compressed meshless ones: the
  loss within 1e-6 relative, as ``tests/test_torch_lm_mesh_train.py``
  holds the uncompressed step; the parameters within ``lr`` (5e-3), not
  that file's 5e-5: an entry of the summed gradient within an f32
  rounding of a quantization boundary takes the neighbouring code, and
  AdamW's first steps move an entry by ~lr whatever its size, so one code
  flipped between 0 and ±1 moves a parameter by ~lr.  Measured after 3
  steps: up to 2.8e-5 on (1, 2), 3.2e-4 to 1.1e-3 on (2, 2) (``lm_head``,
  whose gradient sums the data shards' parts).  An update of the wrong
  sign or on the wrong block moves an entry by ~2·lr a step;
* checkpoints through ``mesh_runs.ckpt_mesh_rank`` (the card phase's rank
  program): an interrupted mesh ``Trainer`` (2 steps and a checkpoint, a
  new trainer resumed from it for the third) against the uninterrupted
  one: its history, and the digest of every block of params, m, v and ef,
  bit for bit; its file, restored meshless and narrowed to each rank's
  blocks, the digests of the state the ranks saved; a meshless port's file
  and the reference's file, restored onto (1, 2) and (2, 2), the digests of
  the file's arrays narrowed (each file restored meshless is its arrays bit
  for bit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_1_7b as jq
from repro.train import checkpoint as JC
from repro.train import compression as JCOMP
from repro.train import optimizer as JO
from repro.train.train_step import init_train_state as j_init_train_state
from repro_torch import convert
from repro_torch.configs import qwen3_1_7b
from repro_torch.launch import distributed as D
from repro_torch.launch import mesh_runs
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.sharding import param_shardings
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as C
from repro_torch.models.registry import get_config
from repro_torch.train.compression import CompressionConfig
from repro_torch.train.compression import compress_with_error_feedback as port_compress
from repro_torch.train.optimizer import AdamWConfig, global_norm
from repro_torch.train.train_step import init_train_state, make_grad_fn, make_train_step

DEADLINE = 240.0  # seconds for one start of the ranks, setup to exit
MESHES = [(1, 2), (2, 2)]
BLOCKS = (256, 48, 16)
OCFG = dict(lr=5e-3, warmup_steps=2, total_steps=5)
WIDTHS = dict(n_layers=2, vocab=640, compute_dtype="float32")
CARD_CUT = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, head_dim=16, vocab=320,
                compute_dtype="float32")  # chip_smoke.py's phase "train mesh" (d), (e) cut to the smoke widths, f32
CKPT_CUT = dict(CARD_CUT, vocab=WIDTHS["vocab"])  # the checkpoint rank program at the test's config


def _tag(shape):
    return "x".join(map(str, shape))


def _cfg():
    return dataclasses.replace(qwen3_1_7b.smoke_config(), **WIDTHS).validate()


def _weights(cfg, seed=1):
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _batches(cfg, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [{"tokens": torch.randint(0, cfg.vocab, (8, 16), generator=g),
             "group_weights": torch.tensor([1.0, 0.0, 1.0, 0.5])} for _ in range(n)]


def _state_arrays(state) -> dict:
    out = {"params": {n: p.detach().numpy().copy() for n, p in state.params.named_parameters()},
           "m": {n: t.numpy().copy() for n, t in state.opt.m.items()},
           "v": {n: t.numpy().copy() for n, t in state.opt.v.items()}}
    if state.ef is not None:
        out["ef"] = {n: t.numpy().copy() for n, t in state.ef.items()}
    return out


def _assert_same_state(got: dict, want: dict):
    assert set(got) == set(want)
    for part in want:
        assert set(got[part]) == set(want[part]), part
        for name, w in want[part].items():
            np.testing.assert_array_equal(got[part][name], w, err_msg=f"{part}/{name}")


def _restored(path):
    """A checkpoint directory restored meshless into a fresh state."""
    template = init_train_state(_cfg(), generator=torch.Generator().manual_seed(9), compression=CompressionConfig())
    return C.restore_checkpoint(path, template)


def _specs(rank) -> dict:
    return {n: None if s is None else tuple(s) for n, s in rank["specs"].items()}


def _jax_state(cfg_j):
    """A reference TrainState at the smoke size after one AdamW step, its
    buffers drawn: every part of it nonzero."""
    js = j_init_train_state(jax.random.PRNGKey(0), cfg_j, compression=JCOMP.CompressionConfig())
    rng = np.random.default_rng(0)
    draw = lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32))  # noqa: E731
    params, opt, _ = JO.adamw_update(JO.AdamWConfig(), js.params, jax.tree_util.tree_map(draw, js.params), js.opt)
    return js._replace(params=params, opt=opt, ef=jax.tree_util.tree_map(draw, params))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The checkpoints the ranks restore: the meshless port's (a state
    after one step with drawn moments and buffers) and the reference's."""
    cfg = _cfg()
    root = tmp_path_factory.mktemp("lm_mesh_ckpt")
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(3), compression=CompressionConfig())
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for t in list(state.opt.m.values()) + list(state.opt.v.values()) + list(state.ef.values()):
            t.copy_(torch.rand(t.shape, generator=g))
    state = state._replace(opt=state.opt._replace(step=6))
    C.save_checkpoint(str(root / "meshless"), 6, state)
    cfg_j = dataclasses.replace(jq.smoke_config(), **WIDTHS).validate()
    jstate = _jax_state(cfg_j)
    JC.save_checkpoint(str(root / "reference"), 5, jstate)
    want_j = {}
    for part, tree in (("params", jstate.params), ("m", jstate.opt.m), ("v", jstate.opt.v), ("ef", jstate.ef)):
        want_j[part] = {n: t.numpy() for n, t in convert.transformer_params_from_jax(
            jax.tree_util.tree_map(np.asarray, tree)).items()}
    # The oracle of chip_smoke.py's phase "train mesh" rank program at CARD_CUT, written as the card writes it.
    card_cfg = get_config("qwen3-1.7b", **CARD_CUT)
    card = init_train_state(card_cfg, generator=torch.Generator().manual_seed(0))
    batch = mesh_runs.train_mesh_batches(card_cfg, 0, torch.device("cpu"), 1, seq_len=32)[0]
    loss, _, grads = make_grad_fn(card_cfg, T.ModelContext())(card.params, batch)
    torch.save({"grads": grads, "loss": float(loss), "grad_norm": float(global_norm(grads)),
                "top": max(float(g.abs().max()) for g in grads.values())}, str(root / "card_oracle.pt"))
    assert get_config("qwen3-1.7b", **CKPT_CUT) == cfg
    return {"root": root, "meshless": _state_arrays(state), "reference": want_j}


@pytest.fixture(scope="module")
def port(files):
    cfg = _cfg()
    sd = _weights(cfg)
    batches = _batches(cfg, 3)
    got = {}
    for shape in MESHES:
        jobs = [("compress", shape, dict(cfg=cfg, sd=sd, batches=batches, ocfg=OCFG, block=b)) for b in BLOCKS]
        restore = {label: str(files["root"] / label) for label in ("meshless", "reference")}
        jobs.append(("ckpt", shape, dict(seed=0, ckpt_dir=str(files["root"] / f"mesh{_tag(shape)}"),
                                         restore_dirs=restore, cfg_overrides=CKPT_CUT, seq_len=16,
                                         data_vocab=cfg.vocab)))
        jobs.append(("card", shape, dict(seed=0, oracle_path=str(files["root"] / "card_oracle.pt"), remat="none",
                                         cfg_overrides=CARD_CUT, seq_len=32, compress=True)))
        results = D.run_ranks(mesh_runs.train_lm_rank, int(np.prod(shape)), backend="gloo", device="cpu",
                              timeout=DEADLINE, args=(jobs,))
        for block, res in zip(BLOCKS, results):
            got[("compress", shape, block)] = res
        got[("ckpt", shape)], got[("card", shape)] = results[-2:]
    return got


@pytest.fixture(scope="module")
def meshless():
    """Three compressed meshless steps a block size: their losses and the
    parameters after them."""
    cfg = _cfg()
    sd = _weights(cfg)
    out = {}
    for block in BLOCKS:
        ccfg = CompressionConfig(block=block)
        state = init_train_state(cfg, generator=None, compression=ccfg,
                                 model=T.model_from_state_dict(cfg, {k: v.clone() for k, v in sd.items()}))
        step = make_train_step(cfg, T.ModelContext(), AdamWConfig(**OCFG), compression=ccfg)
        losses = []
        for b in _batches(cfg, 3):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        out[block] = {"losses": losses, "params": {n: p.detach().numpy().copy()
                                                   for n, p in state.params.named_parameters()}}
    return out


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_mesh_compression_is_the_reference_on_the_global_gradient(shape, block, port):
    res = port[("compress", shape, block)]
    assert res["lockstep"] and res["ef_on_blocks"]
    ccfg, jcfg = CompressionConfig(block=block), JCOMP.CompressionConfig(block=block)
    ef = jef = None
    for rec in res["steps"]:
        check = rec["check"]
        assert check["bitwise"] and check["applied"], check["differ"]
        assert check["tensors"] == len(rec["grads"])
        g = {n: torch.from_numpy(a) for n, a in rec["grads"].items()}
        ef = ef if ef is not None else {n: torch.zeros_like(t) for n, t in g.items()}
        jef = jef if jef is not None else {n: jnp.zeros(a.shape, jnp.float32) for n, a in rec["grads"].items()}
        deq, ef = port_compress(ccfg, g, ef)
        jg, jef = JCOMP.compress_with_error_feedback(jcfg, {n: jnp.asarray(a) for n, a in rec["grads"].items()}, jef)
        for name in g:
            np.testing.assert_array_equal(deq[name].numpy(), np.asarray(jg[name]), err_msg=name)
            np.testing.assert_array_equal(ef[name].numpy(), np.asarray(jef[name]), err_msg=name)
    for name, a in res["ef"].items():  # the mesh's buffers after the last step, gathered
        np.testing.assert_array_equal(a, np.asarray(jef[name]), err_msg=name)
    pmax = [rec["check"]["pmax"]["calls"] for rec in res["steps"]]
    # Straddling blocks take one pmax a split tensor; blocks of 16 cut no block.
    assert (all(p == 0 for p in pmax) if block == 16 else all(p > 0 for p in pmax)), pmax


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_compressed_mesh_steps_track_the_meshless_ones(shape, block, port, meshless):
    res, want = port[("compress", shape, block)], meshless[block]
    got = [rec["loss"] for rec in res["steps"]]
    for g, w in zip(got, want["losses"]):
        assert abs(g - w) <= 1e-6 * abs(w), (got, want["losses"])
    assert set(res["params"]) == set(want["params"])
    gaps = {n: float(np.abs(a - want["params"][n]).max()) for n, a in res["params"].items()}
    assert max(gaps.values()) <= OCFG["lr"], sorted(gaps.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_the_card_phase_compression_check_at_the_smoke_size(shape, port):
    """``chip_smoke.py``'s phase "train mesh" (d) rank program at the smoke
    widths under remat none: the oracle's gradient compressed through the
    mesh path bit for bit the meshless compression narrowed, ``lm_head``'s
    straddling block (its 320 columns split at 160: block 0 holds 160 of
    model rank 0's and 96 of rank 1's, the padded block 1 the last 64 of
    rank 1's) at the whole tensor's scale, the buffers on
    ``state_shardings``' blocks, the gradient blocks within 1e-5 of the
    oracle's scale."""
    rep = port[("card", shape)]
    for r in rep["ranks"]:
        comp, head = r["compression"], r["compression"]["lm_head"]
        assert comp["bitwise"] and comp["tensors"] == 2 * 11 + 3 and comp["pmax"]["calls"] > 0
        assert comp["applied"] is None
        assert head["scale"] == head["whole_scale"] and head["block"] == 0 and head["padded_block"] == 1
        assert r["ef_ok"] and r["moments_ok"] and r["grad_gap"] <= 1e-5, r["grad_gap"]


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_an_interrupted_mesh_trainer_resumes_bit_for_bit(shape, port):
    ranks = port[("ckpt", shape)]["ranks"]
    assert len(ranks) == int(np.prod(shape))
    # A new trainer's pattern cache starts empty: its host-solve count is its own.
    hist = lambda rows: [{k: v for k, v in h.items() if k not in ("host_solves", "ckpt_write_s")}  # noqa: E731
                         for h in rows]
    for r in ranks:
        whole, first, resumed = r["runs"]["whole"], r["runs"]["first"], r["runs"]["resumed"]
        assert (whole["start"], first["start"], resumed["start"]) == (0, 0, 2)
        assert [h["step"] for h in resumed["history"]] == [2]
        assert hist(whole["history"][:2]) == hist(first["history"])
        assert hist(whole["history"][2:]) == hist(resumed["history"])
        assert sum(h["stragglers"] for h in whole["history"]) > 0
        assert resumed["digests"] == whole["digests"]
        assert resumed["digests"] != first["digests"]  # the third step moved every part of the state
    assert len({repr(r["runs"]["whole"]["history"]) for r in ranks}) == 1


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_a_mesh_checkpoint_restores_meshless_to_the_mesh_state(shape, port, files):
    ranks = port[("ckpt", shape)]["ranks"]
    state, step = _restored(str(files["root"] / f"mesh{_tag(shape)}"))
    assert step == 2 and state.opt.step == 2
    read = mesh_runs.narrowed_digests(state, _specs(ranks[0]), shape)
    for r in ranks:
        assert r["runs"]["first"]["digests"] == read[tuple(r["coords"])]


@pytest.mark.parametrize("label,step", [("meshless", 6), ("reference", 5)])
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_meshless_and_reference_checkpoints_restore_onto_the_mesh(shape, label, step, port, files):
    ranks = port[("ckpt", shape)]["ranks"]
    state, _ = _restored(str(files["root"] / label))
    _assert_same_state(_state_arrays(state), files[label])
    want = mesh_runs.narrowed_digests(state, _specs(ranks[0]), shape)
    for r in ranks:
        res = r["restored"][label]
        assert res["step"] == step and res["opt_step"] == (6 if label == "meshless" else 1)
        assert res["digests"] == want[tuple(r["coords"])]


def test_the_card_checkpoint_rank_program_at_the_smoke_size(port):
    """``chip_smoke.py``'s phase "train mesh" (e) rank program on (2, 2) at
    the smoke widths: the specs it reports are the parameters' shardings;
    the one checkpoint write (the trainer's ``ckpt_write_s``, after the
    second step of the interrupted run) and the reads (the resume's
    ``ckpt_read_s``, each restore's) are timed; the uninterrupted run's
    state differs from a fresh draw's in every tensor's digest."""
    cfg = _cfg()
    ranks = port[("ckpt", (2, 2))]["ranks"]
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    want = param_shardings(dict(model.named_parameters()), MeshShape(("data", "model"), (2, 2)))
    for r in ranks:
        assert _specs(r) == {n: tuple(s) for n, s in want.items()}
        runs = r["runs"]
        writes = [h.get("ckpt_write_s") for h in runs["first"]["history"]]
        assert writes[0] is None and writes[1] > 0
        assert all("ckpt_write_s" not in h for h in runs["whole"]["history"] + runs["resumed"]["history"])
        assert runs["whole"]["read_s"] is None and runs["first"]["read_s"] is None and runs["resumed"]["read_s"] > 0
        assert all(res["read_s"] > 0 for res in r["restored"].values())
        assert all(runs["whole"]["digests"][k] != d for k, d in r["restored"]["meshless"]["digests"].items())

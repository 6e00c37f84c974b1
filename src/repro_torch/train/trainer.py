"""The training loop: redundant pipeline + deadline straggling + recovery
weighting + checkpoint/restart (the twin of the reference's
``train/trainer.py``).  The step runs on ``device`` (the card unless the
caller asks for the CPU).  Two recovery paths:

* **Host path** (default, ``device_recovery=False``) — each step the
  scenario stream gives the alive mask over the DP groups, the plan's
  session solves the recovery weights on the host (LP/NNLS, cached per
  pattern: :meth:`ElasticGroupManager.step_weights`), and the weights
  enter :func:`~repro_torch.models.transformer.loss_fn` as the batch's
  ``group_weights``.  Exact, but every pattern not seen before costs one
  host solve.
* **Mesh-native path** (``device_recovery=True``) — per-group gradients
  run through ``Executor.resilient_reduce_masked`` (``executor="local"``,
  or ``"mesh"``: the groups over the ranks of a ``torch.distributed``
  group), so the recovery solve (projected gradient over the alive mask)
  runs on the device inside the step: no host solve on a pattern not seen
  before.  The group token pools stay resident on the executor
  (node-stacked, one row per DP group, packed for ``resident_steps`` step
  batches and cycled); when the session's
  :class:`~repro_torch.core.resilience.ElasticPolicy` re-replicates
  at-risk shards away from persistent stragglers, the trainer re-packs
  ONLY the moved groups' rows and writes them through
  ``Executor.update_node_rows`` (a patch that outgrows the headroom
  capacity forces a counted full re-place instead).  Degenerate patterns
  (some shard with no alive replica) run the host-solved best-effort
  weights through the same step as ``b_override``.  Each step makes one
  device-to-host read, of all its scalars.

The host path also runs on an LM mesh (``ctx`` from
``launch.sharding.make_context``, inside a rank program such as
``launch.mesh_runs.train_lm_rank``), as the reference reaches its mesh:
each rank holds its blocks of the weights and the moments, draws the same
global batch, pattern and host solve as every other rank, feeds its rows
(``launch.sharding.local_rows``) to the mesh step
(``train_step.make_train_step``), and records a hash of the step's losses,
recovery weights and pattern (``lockstep``), equal on every rank.
Compression quantizes in the global tensors' blocks, and a checkpoint
holds the whole tensors, written by rank 0 and narrowed to each rank's
blocks on restore (``train.compression``, ``train.checkpoint``), so a
mesh run resumes from a meshless checkpoint and the other way round.  The
mesh-native path with an LM mesh does not exist in the reference and
raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..analysis import compiled_path
from ..core.resilience import ElasticPolicy
from ..core.stragglers import StragglerScenario, make_scenario
from ..data.pipeline import RedundantDataPipeline
from ..device import resolve_device
from ..kernels import autotune
from ..models import transformer as T
from ..models.registry import ModelConfig
from ..obs import trace_span
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .compression import CompressionConfig
from .elastic import ElasticGroupManager
from .optimizer import AdamWConfig
from .resilient import make_plan
from .train_step import (
    TrainState,
    init_train_state,
    make_group_grad_fn,
    make_recovered_apply_fn,
    make_train_step,
)

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    num_groups: int = 8
    num_shards: int = 8
    redundancy: int = 2
    scheme: str = "cyclic"
    microbatch: int = 2
    seq_len: int = 128
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    seed: int = 0
    simulate_stragglers: bool = True
    straggler_scenario: str = "deadline"  # any repro_torch.core.stragglers scenario
    straggler_deadline: float = 2.0
    scenario_kwargs: Optional[dict] = None  # extra make_scenario kwargs
                                            # (e.g. path= for trace replay)
    compression: Optional[CompressionConfig] = None
    # The token streams' Markov table is data_vocab x data_vocab f64
    # (data/tokens.py): 184 GB at a vocab of 151,936.  None draws over the
    # model's whole vocab, as the reference does; a smaller value draws the
    # ids below it.
    data_vocab: Optional[int] = None
    # ---- mesh-native resilient path (on-device gradient recovery) ----
    device_recovery: bool = False  # recovery solve inside the step
    executor: str = "local"        # "local" (the node axis a batch) or "mesh"
                                   # (torch.distributed ranks); only consumed
                                   # by the device_recovery path
    elastic_patience: int = 0      # >0 arms ElasticPolicy(patience=...)
    patch_headroom: int = 1        # spare shard slots per group for patches
    warm_start: bool = True        # one discarded forward + backward before
                                   # the loop; REPRO_WARM_START=0 also disables it
    resident_steps: int = 4        # device-resident step batches, cycled by
                                   # step % resident_steps: the fused path
                                   # trains over this FIXED pool, unlike the
                                   # host path's fresh pipeline.batch(step)
    recovery_iters: Optional[int] = None  # PGD iters (default: env/300)


class Trainer:
    """``initial_state`` (a :class:`TrainState`) replaces the random
    initial weights, e.g. weights carried from the reference; a checkpoint
    in ``ckpt_dir`` still takes precedence, as a resume does.  Under an LM
    mesh (``ctx.mesh``) only its weights are taken, narrowed to the rank's
    blocks, and the moments start from zero on the same blocks.

    A step that writes a checkpoint records its seconds in its history
    entry (``ckpt_write_s``); a resume's read seconds are ``ckpt_read_s``
    (None until :meth:`init_state` restores)."""

    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainerConfig,
        opt_cfg: Optional[AdamWConfig] = None,
        ctx: Optional[T.ModelContext] = None,
        *,
        device=None,
        initial_state: Optional[TrainState] = None,
    ):
        if not tcfg.device_recovery and tcfg.executor != "local":
            raise ValueError(
                f"executor={tcfg.executor!r} is only consumed by the device_recovery path; the host path "
                "always runs the single-process step (set device_recovery=True)")
        self.mesh = None if ctx is None else ctx.mesh
        if self.mesh is not None:
            if tcfg.device_recovery:
                raise ValueError("device_recovery=True runs the groups over an executor's ranks; with an LM mesh "
                                 "in ctx it does not exist (the reference's trainer has no such path): use the "
                                 "host path, device_recovery=False")
        self.cfg = cfg
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or AdamWConfig(total_steps=tcfg.steps)
        self.ctx = ctx or T.ModelContext()
        self.device = resolve_device(device)
        # The plan's session owns the executor, the elastic policy and the
        # pattern cache.
        session_kwargs = dict(device=self.device)
        if tcfg.device_recovery:
            session_kwargs.update(
                executor=tcfg.executor,
                elastic=ElasticPolicy(enabled=tcfg.elastic_patience > 0, patience=max(1, tcfg.elastic_patience)),
                device_iters=tcfg.recovery_iters,
            )
        plan = make_plan(
            tcfg.num_groups, tcfg.num_shards,
            redundancy=tcfg.redundancy, scheme=tcfg.scheme,
            session_kwargs=session_kwargs,
        )
        self.plan = plan
        self.elastic = ElasticGroupManager(plan)
        self.pipeline = RedundantDataPipeline(
            plan, vocab=min(cfg.vocab, tcfg.data_vocab or cfg.vocab), microbatch=tcfg.microbatch,
            seq_len=tcfg.seq_len, seed=tcfg.seed,
        )
        scen_kw = {}
        if tcfg.straggler_scenario in ("iid", "fixed", "deadline"):
            scen_kw["seed"] = tcfg.seed + 1
        if tcfg.straggler_scenario == "deadline":
            scen_kw["deadline"] = tcfg.straggler_deadline
        scen_kw.update(tcfg.scenario_kwargs or {})
        self.scenario: StragglerScenario = make_scenario(
            tcfg.straggler_scenario, tcfg.num_groups,
            assignment=plan.assignment, **scen_kw,
        )
        if tcfg.device_recovery:
            self._init_device_recovery()
        else:
            self._step_fn = make_train_step(cfg, self.ctx, self.opt_cfg, compression=tcfg.compression)
        self._initial_state = initial_state
        self.history: list[dict] = []
        self.ckpt_read_s: Optional[float] = None
        self.warmup_report: Optional[autotune.WarmupReport] = None

    # ------------------------------------------- mesh-native resident state

    def _init_device_recovery(self) -> None:
        tcfg = self.tcfg
        self._capacity = self.plan.shards_per_group + max(0, tcfg.patch_headroom)
        self._pool = max(1, tcfg.resident_steps)
        self._group_fn = make_group_grad_fn(self.cfg, self.ctx)
        self._apply_fn = make_recovered_apply_fn(self.opt_cfg, self.plan.num_shards, compression=tcfg.compression)
        self._place_resident(full=False)
        self.plan.session.add_patch_listener(self._on_patch)

    def _pack_group_rows(self, g: int) -> tuple[np.ndarray, np.ndarray]:
        """(P, C·mb, T) token pool + (C,) validity for group ``g`` under the
        CURRENT assignment."""
        shards = self.plan.current_group_shards(g)
        toks, valid = [], None
        for p in range(self._pool):
            rows, valid = self.pipeline.shard_rows(shards, p, self._capacity)
            toks.append(rows)
        return np.stack(toks, axis=0), valid

    def _place_resident(self, *, full: bool) -> None:
        packed = [self._pack_group_rows(g) for g in range(self.plan.num_groups)]
        ex = self.plan.session.executor
        self._res_tokens = ex.place_node_stacked(np.stack([t for t, _ in packed]), self.device)  # (G, P, C·mb, T)
        self._res_valid = ex.place_node_stacked(np.stack([v for _, v in packed]), self.device)   # (G, C)
        if full:
            self.plan.session.stats.full_repacks += 1

    def _on_patch(self, moved: list[int], old_m: int, new_m: int) -> None:
        """Patch-aware data movement: re-place ONLY the moved groups' token
        blocks (``Executor.update_node_rows``); a patch that outgrew the
        slot capacity forces a counted full re-place at the new capacity."""
        if new_m > self._capacity:
            self._capacity = new_m + max(0, self.tcfg.patch_headroom)
            self._place_resident(full=True)
            return
        ex = self.plan.session.executor
        rows = [self._pack_group_rows(g) for g in moved]
        self._res_tokens = ex.update_node_rows(self._res_tokens, moved, np.stack([t for t, _ in rows]))
        self._res_valid = ex.update_node_rows(self._res_valid, moved, np.stack([v for _, v in rows]))
        self.plan.session.stats.moved_node_blocks += len(moved)

    # -------------------------------------------------------------- state

    def init_state(self) -> tuple[TrainState, int]:
        """The initial state, or the newest checkpoint's if one exists."""
        state = self._initial_state
        if state is None or self.mesh is not None:
            gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
            model = None if state is None else state.params
            state = init_train_state(self.cfg, generator=gen, compression=self.tcfg.compression, model=model,
                                     mesh=self.mesh)
        start = 0
        if self.tcfg.ckpt_dir and latest_step(self.tcfg.ckpt_dir) is not None:
            t0 = time.perf_counter()
            state, start = restore_checkpoint(self.tcfg.ckpt_dir, state, mesh=self.mesh)
            self.ckpt_read_s = time.perf_counter() - t0
        return state, start

    def _batch(self, step: int, weights: np.ndarray) -> dict:
        """The step's batch: the global one, or this rank's rows of it
        under an LM mesh; the group weights whole."""
        tokens = torch.from_numpy(self.pipeline.batch(step))
        if self.mesh is not None:
            from ..launch.sharding import local_rows

            tokens = local_rows(tokens, self.mesh)
        return {"tokens": tokens.to(device=self.device, dtype=torch.long),
                "group_weights": torch.as_tensor(weights, device=self.device)}

    # -------------------------------------------------- mesh-native step

    def _recovered_stats(self, state: TrainState, step: int, alive_t: np.ndarray, b_override=None):
        """The step's Lemma-3-combined statistics and the weights b: the
        recovery solved on the device (or ``b_override``), the resident
        pools' entry ``step % resident_steps``."""
        sess = self.plan.session
        return sess.executor.resilient_reduce_masked(
            self._group_fn, (self._res_tokens, self._res_valid), (state.params, step % self._pool),
            sess.assignment.matrix.astype(np.float32), alive_t,
            iters=sess.device_iters, b_override=b_override,
        )

    @compiled_path("trainer.device_recovery_step", kind="host")
    def _device_recovery_step(
        self, state: TrainState, step: int, alive_t: np.ndarray
    ) -> tuple[TrainState, Optional[dict]]:
        """One step of the fused path.  Returns (state, record) — record is
        ``None`` when every group straggled (step skipped)."""
        sess = self.plan.session
        covered = sess.pattern_covers(alive_t)
        b_override = None
        if not covered:
            # Degenerate pattern: host best-effort weights keep the covered
            # shards' mass instead of silently dropping the lost ones; they
            # ride through the same step as data.
            b_override = self.plan.step_weights(alive_t)
            if not b_override.any():
                return state, None  # every group straggled: skip the step
        stats, b_dev = self._recovered_stats(state, step, alive_t, b_override)
        if covered:
            sess.stats.device_solves += 1
        state, metrics = self._apply_fn(state, stats)
        # ONE blocking device-to-host read per step, of every scalar.
        loss, ce, grad_norm, b_sum = torch.stack(
            [metrics["loss"], metrics["ce"], metrics["grad_norm"], torch.sum(b_dev)]).tolist()
        record = {
            "step": step,
            "loss": loss,
            "ce": ce,
            "grad_norm": grad_norm,
            "stragglers": int((~alive_t).sum()),
            "fallback": not covered,
            "b_sum": b_sum,
            "host_solves": sess.stats.host_solves,
            "device_solves": sess.stats.device_solves,
            "patches": sess.stats.elastic_patches,
        }
        return state, record

    # ------------------------------------------------------------- warm-up

    def warmup(self, state: Optional[TrainState] = None) -> "autotune.WarmupReport":
        """One throwaway all-alive forward and backward of step 0's batch
        before the loop (on the mesh-native path: step 0's recovered
        statistics, the device solve included): it loads (and if need be
        builds) the kernel libraries and sets up the BLAS handles off the
        timed steps.  Its gradients are discarded and nothing is updated,
        so the state is untouched; the session's counters are snapshotted
        and restored, so the extra pass is invisible to every stat."""
        if state is None:
            state, _ = self.init_state()
        sess = self.plan.session
        stats_snapshot = sess.stats.snapshot()

        def one_step():
            if self.tcfg.device_recovery:
                stats, _ = self._recovered_stats(state, 0, np.ones(self.tcfg.num_groups, dtype=bool))
                return list(stats["grads"].values())
            batch = self._batch(0, np.ones(self.tcfg.num_groups, dtype=np.float32))
            loss, _ = T.loss_fn(state.params, batch, self.cfg, self.ctx)
            grads = torch.autograd.grad(loss, [p for p in state.params.parameters()], allow_unused=True)
            return [g for g in grads if g is not None]

        try:
            report = autotune.warmup([("train_step", one_step)])
        finally:
            sess.stats.restore(stats_snapshot)
        self.warmup_report = report
        return report

    # -------------------------------------------------------------- loop

    def run(
        self,
        state: Optional[TrainState] = None,
        *,
        start_step: Optional[int] = None,
        on_step: Optional[Callable[[int, dict], None]] = None,
    ) -> TrainState:
        if state is None:
            state, resumed = self.init_state()
            start_step = resumed if start_step is None else start_step
        start_step = start_step or 0
        if (
            self.tcfg.warm_start
            and autotune.warm_start_enabled()
            and self.warmup_report is None
            and start_step < self.tcfg.steps
        ):
            self.warmup(state)
        for step in range(start_step, self.tcfg.steps):
            if self.tcfg.simulate_stragglers:
                srec = next(self.scenario)
                alive_t, latencies = srec.alive, srec.latencies
            else:
                srec = None
                alive_t = np.ones(self.tcfg.num_groups, dtype=bool)
                latencies = np.zeros((0,))  # scenario-less: not modelled
            if self.tcfg.device_recovery:
                if srec is not None:
                    ev = self.plan.session.observe(srec)
                    if ev["patched"] and hasattr(self.scenario, "rebind"):
                        # Re-aim the adversary at the patched assignment.
                        self.scenario.rebind(self.plan.current_assignment)
                with trace_span(
                    "trainer.step", step=step, path="device_recovery",
                    stragglers=int((~alive_t).sum()),
                ):
                    state, record = self._device_recovery_step(state, step, alive_t)
                if record is None:
                    self.history.append({"step": step, "skipped": True})
                    continue
            else:
                weights, rec = self.elastic.step_weights(~alive_t)
                if not weights.any():  # every group straggled: skip the step
                    self.history.append({"step": step, "skipped": True})
                    continue
                batch = self._batch(step, weights)
                with trace_span(
                    "trainer.step", step=step, path="host_weights",
                    stragglers=int((~alive_t).sum()),
                ):
                    state, metrics = self._step_fn(state, batch)
                record = {
                    "step": step,
                    "loss": float(metrics["loss"]),
                    "ce": float(metrics["ce"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "stragglers": int((~alive_t).sum()),
                    "delta": float(rec.delta) if np.isfinite(rec.delta) else -1.0,
                    "covered": float(rec.covered_fraction),
                    "host_solves": self.plan.session.stats.host_solves,
                }
                if self.mesh is not None:
                    from ..launch.distributed import digest

                    record["lockstep"] = digest(record["loss"], record["ce"], record["grad_norm"], weights,
                                                alive_t)
            if latencies.size == self.tcfg.num_groups:
                # Only the deadline scenario models latency.
                record["mean_latency"] = float(latencies.mean())
            self.history.append(record)
            if on_step:
                on_step(step, record)
            if self.tcfg.ckpt_dir and (step + 1) % self.tcfg.ckpt_every == 0:
                t0 = time.perf_counter()
                save_checkpoint(self.tcfg.ckpt_dir, step + 1, state, keep=self.tcfg.ckpt_keep, mesh=self.mesh)
                record["ckpt_write_s"] = time.perf_counter() - t0
        return state

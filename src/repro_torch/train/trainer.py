"""The training loop: redundant pipeline + deadline straggling + recovery
weighting + checkpoint/restart (the twin of the reference's
``train/trainer.py``, its host path).

Each step the scenario stream gives the alive mask over the DP groups, the
plan's session solves the recovery weights on the host (LP/NNLS, cached
per pattern: :meth:`ElasticGroupManager.step_weights`), and the weights
enter :func:`~repro_torch.models.transformer.loss_fn` as the batch's
``group_weights``; the step runs on ``device`` (the card unless the caller
asks for the CPU).  The reference's mesh-native path
(``device_recovery=True``: per-group gradients through the executor, the
recovery solved inside the step) is not ported yet and raises
(ROADMAP queue 1, item 13.5b).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

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
from .train_step import TrainState, init_train_state, make_train_step

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
    # ---- the reference's mesh-native path: not ported (ROADMAP 13.5b) ----
    device_recovery: bool = False
    executor: str = "local"
    warm_start: bool = True        # one discarded forward + backward before
                                   # the loop; REPRO_WARM_START=0 also disables it


class Trainer:
    """``initial_state`` (a :class:`TrainState`) replaces the random
    initial weights, e.g. weights carried from the reference; a checkpoint
    in ``ckpt_dir`` still takes precedence, as a resume does."""

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
        if tcfg.device_recovery or tcfg.executor != "local":
            raise NotImplementedError(
                "Trainer: the device_recovery path (and its executors) is not ported yet: "
                "ROADMAP queue 1, item 13.5b; the host path runs with device_recovery=False, executor='local'")
        self.cfg = cfg
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or AdamWConfig(total_steps=tcfg.steps)
        self.ctx = ctx or T.ModelContext()
        self.device = resolve_device(device)
        plan = make_plan(
            tcfg.num_groups, tcfg.num_shards,
            redundancy=tcfg.redundancy, scheme=tcfg.scheme,
            session_kwargs=dict(device=self.device),
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
        self._step_fn = make_train_step(cfg, self.ctx, self.opt_cfg, compression=tcfg.compression)
        self._initial_state = initial_state
        self.history: list[dict] = []
        self.warmup_report: Optional[autotune.WarmupReport] = None

    # -------------------------------------------------------------- state

    def init_state(self) -> tuple[TrainState, int]:
        """The initial state, or the newest checkpoint's if one exists."""
        state = self._initial_state
        if state is None:
            gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
            state = init_train_state(self.cfg, generator=gen, compression=self.tcfg.compression)
        start = 0
        if self.tcfg.ckpt_dir and latest_step(self.tcfg.ckpt_dir) is not None:
            state, start = restore_checkpoint(self.tcfg.ckpt_dir, state)
        return state, start

    def _batch(self, step: int, weights: np.ndarray) -> dict:
        tokens = torch.from_numpy(self.pipeline.batch(step)).to(device=self.device, dtype=torch.long)
        return {"tokens": tokens, "group_weights": torch.as_tensor(weights, device=self.device)}

    # ------------------------------------------------------------- warm-up

    def warmup(self, state: Optional[TrainState] = None) -> "autotune.WarmupReport":
        """One throwaway all-alive forward and backward of step 0's batch
        before the loop: it loads (and if need be builds) the kernel
        libraries and sets up the BLAS handles off the timed steps.  Its
        gradients are discarded and nothing is updated, so the state is
        untouched; the session's counters are snapshotted and restored, so
        the extra pass is invisible to every stat."""
        if state is None:
            state, _ = self.init_state()
        sess = self.plan.session
        stats_snapshot = sess.stats.snapshot()

        def one_step():
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
                alive_t = np.ones(self.tcfg.num_groups, dtype=bool)
                latencies = np.zeros((0,))  # scenario-less: not modelled
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
            if latencies.size == self.tcfg.num_groups:
                # Only the deadline scenario models latency.
                record["mean_latency"] = float(latencies.mean())
            self.history.append(record)
            if on_step:
                on_step(step, record)
            if self.tcfg.ckpt_dir and (step + 1) % self.tcfg.ckpt_every == 0:
                save_checkpoint(self.tcfg.ckpt_dir, step + 1, state, keep=self.tcfg.ckpt_keep)
        return state

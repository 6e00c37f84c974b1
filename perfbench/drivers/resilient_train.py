"""Driver: resilient data-parallel training through the port's ``Trainer`` on
its ``device_recovery=True`` path, one training step a unit.

Set-up draws the weights and the training data from the seed on the
device (the reference's ``make_weights`` and ``make_tokens``, one call
each), hands the weights to the trainer as its initial state and the data
as its token rows in place of the program's own data pipeline, writes the
traffic's alive masks as the trainer's straggler trace, and drives the
first three steps through the trainer's own ``run``: they warm every
shape, the first of them loses a shard and takes the host fallback (the
traffic puts a lost shard at every 22nd step from the first), and they are
the steps the check follows.  Each unit of the window is the next step,
through the same call, the device synchronised at its end.

The program's readings are taken as they happen, on the device, and kept
as a few numbers: each followed step's loss and the loss of the window's
first step, the first step's gradient per leaf as the optimizer got it
(its first moment over 1 − β1), and each leaf's change after the third
step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from harness import files
from harness.checks import worst_of
from harness.traffic import alive_masks

MAX_STEPS = 4096
FOLLOWED = 3


def port_name(name: str) -> str:
    """The port's name of a reference weight."""
    if not name.startswith("layers."):
        return name
    _, i, key = name.split(".", 2)
    where = {"wq": "attn.wq", "wk": "attn.wk", "wv": "attn.wv", "wo": "attn.wo", "q_norm": "attn.q_norm",
             "k_norm": "attn.k_norm", "gate": "mlp.gate", "up": "mlp.up", "down": "mlp.down"}
    return f"blocks.{i}.{where.get(key, key)}"


class SeedRows:
    """The trainer's token rows, made by the benchmark: what the program's
    data pipeline gives its resident pools, from ``tokens`` (resident
    steps, shards, microbatch, seq_len)."""

    def __init__(self, tokens: np.ndarray):
        self.tokens = tokens

    def shard_rows(self, shard_ids, step: int, capacity: int) -> tuple[np.ndarray, np.ndarray]:
        pool, _, mb, T = self.tokens.shape
        rows = np.zeros((capacity * mb, T), dtype=np.int32)
        valid = np.zeros((capacity,), dtype=np.float32)
        for i, s in enumerate(shard_ids):
            rows[i * mb: (i + 1) * mb] = self.tokens[step % pool, int(s)]
            valid[i] = 1.0
        return rows, valid


@contextlib.contextmanager
def seed_rows(tokens: np.ndarray):
    """Trainers built while open take their rows from ``tokens``."""
    from repro_torch.train import trainer

    inner = trainer.RedundantDataPipeline
    trainer.RedundantDataPipeline = lambda *a, **kw: SeedRows(tokens)
    try:
        yield
    finally:
        trainer.RedundantDataPipeline = inner


def port_config(cfg: dict):
    """The port's model configuration, checked against the file's."""
    from repro_torch.models.registry import get_config

    mc = get_config(cfg["port_arch"], tie_embeddings=cfg["tie_word_embeddings"])
    want = {"vocab": cfg["vocab_size"], "d_model": cfg["hidden_size"], "d_ff": cfg["intermediate_size"],
            "n_layers": cfg["num_hidden_layers"], "n_heads": cfg["num_attention_heads"],
            "n_kv_heads": cfg["num_key_value_heads"], "head_dim": cfg["head_dim"],
            "rope_theta": float(cfg["rope_theta"]), "rms_eps": cfg["rms_norm_eps"],
            "qkv_bias": cfg["attention_bias"], "param_dtype": cfg["param_dtype"],
            "compute_dtype": cfg["compute_dtype"]}
    over = {k: v for k, v in want.items() if getattr(mc, k) != v}
    return dataclasses.replace(mc, **over) if over else mc


class Runner:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch.models import transformer as T
        from repro_torch.train.optimizer import AdamWConfig
        from repro_torch.train.train_step import init_train_state
        from repro_torch.train.trainer import Trainer, TrainerConfig

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.ref = files.reference(cfg["name"])
        mc = port_config(cfg)
        G = cfg["groups"]
        self.groups = self.ref.fr_groups(cfg)
        self.masks = alive_masks(traffic["stragglers"], G, seed, MAX_STEPS,
                                 lambda m: all(m[gs].any() for gs in self.groups))
        self._tmp = tempfile.TemporaryDirectory(prefix="perfbench-")
        trace = os.path.join(self._tmp.name, "alive.jsonl")
        with open(trace, "w", encoding="utf-8") as f:
            f.writelines(json.dumps({"alive": [int(a) for a in row]}) + "\n" for row in self.masks)
        opt = {k: v for k, v in cfg["optimizer"].items() if k != "kind"}
        tcfg = TrainerConfig(
            num_groups=G, num_shards=cfg["shards"], redundancy=cfg["redundancy"], scheme=cfg["scheme"],
            microbatch=cfg["microbatch"], seq_len=cfg["seq_len"], steps=MAX_STEPS, seed=int(seed),
            straggler_scenario="trace", scenario_kwargs={"path": trace}, device_recovery=True,
            resident_steps=cfg["resident_steps"], patch_headroom=cfg["patch_headroom"],
            recovery_iters=cfg["recovery_iters"])
        t0 = time.perf_counter()
        weights = self.ref.make_weights(cfg, seed, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        tw = time.perf_counter()
        model = T.model_from_state_dict(mc, {port_name(k): v for k, v in weights.items()})
        del weights
        self.tokens = self.ref.make_tokens(cfg, seed, self.device)
        t1 = time.perf_counter()
        with seed_rows(self.tokens):
            self.trainer = Trainer(mc, tcfg, AdamWConfig(**opt), device=self.device,
                                   initial_state=init_train_state(mc, generator=None, model=model))
        t2 = time.perf_counter()
        self.state = None
        self.next_step = 0
        self.counted: list[int] = []
        self.setup_log: list[str] = []
        self.program = self._follow(FOLLOWED)
        print(f"perfbench: set-up: weights {tw - t0:.3f} s, model and data {t1 - tw:.3f} s, trainer {t2 - t1:.3f} s, "
              f"warm-up and {FOLLOWED} followed steps {time.perf_counter() - t2:.3f} s "
              f"({', '.join(self.setup_log)})", file=sys.stderr)

    def _run_step(self) -> dict:
        """One step through the trainer's own loop; its record."""
        out = {}
        step = self.next_step
        self.trainer.tcfg.steps = step + 1
        self.state = self.trainer.run(self.state, start_step=step, on_step=lambda s, rec: out.update(rec))
        self.next_step += 1
        return out

    def _follow(self, steps: int) -> dict:
        """The first ``steps`` steps, with the program's readings of them."""
        losses = []
        self.state, _ = self.trainer.init_state()
        for t in range(steps):
            t0 = time.perf_counter()
            losses.append(self._run_step()["loss"])
            self.setup_log.append(f"step {t}{' with the warm-up' if t == 0 else ''} {time.perf_counter() - t0:.3f} s")
            if t == 0:
                b1 = float(self.trainer.opt_cfg.b1)
                grad_norms = self._leaf_norms(lambda n, p: self.state.opt.m[n] / (1.0 - b1))
        t0 = time.perf_counter()
        theta0 = self.ref.make_weights(self.cfg, self.seed, self.device)
        change = self._leaf_norms(lambda n, p: p - theta0[_ref_name(n)])
        del theta0
        self.setup_log.append(f"readings {time.perf_counter() - t0:.3f} s")
        return {"loss": losses, "grad_norms": grad_norms, "change_norms": change}

    def _leaf_norms(self, fn) -> dict:
        with torch.no_grad():
            return {_ref_name(n): float(torch.linalg.vector_norm(fn(n, p).double()))
                    for n, p in self.state.params.named_parameters()}

    def step(self, i: int) -> None:
        rec = self._run_step()
        if rec["step"] == FOLLOWED:
            self.program["loss"].append(rec["loss"])
        alive = self.masks[rec["step"]]
        self.counted.append(int(sum(any(alive[g] for g in gs) for gs in self.groups))
                            * self.cfg["microbatch"] * self.cfg["seq_len"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def end_to_end(self, window_s: float, units: int) -> dict:
        return {"train_tokens_per_s": sum(self.counted) / window_s}

    def layer_targets(self):
        from repro_torch.core import executor
        from repro_torch.core.resilience import ResilienceSession
        from repro_torch.models import transformer
        from repro_torch.train import train_step
        from repro_torch.train.trainer import Trainer

        return [
            (Trainer, "_device_recovery_step", "trainer.device_recovery_step"),
            (ResilienceSession, "observe", "session.observe"),
            (executor, "device_recovery_masked", "recovery.device_masked"),
            (transformer, "group_losses", "model.forward"),
            (train_step, "_grads", "model.backward"),
            (train_step, "adamw_update", "optimizer.adamw"),
        ]

    def free(self) -> None:
        self.state = self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict) -> tuple[list[dict], int]:
        """The followed steps and the window's first step against the
        reference, which runs them again from the same weights, data and
        masks."""
        self.free()
        self._tmp.cleanup()
        return worst_of([self.ref.compare(self.program, self.reference())], limits)

    def reference(self, **kw) -> dict:
        """The reference over the followed steps, and the loss of the
        window's first step, from the weights and data drawn again."""
        weights = self.ref.make_weights(self.cfg, self.seed, self.device)
        tokens = self.ref.make_tokens(self.cfg, self.seed, self.device)
        steps = FOLLOWED + 1
        pool, n, mb, T = tokens.shape
        batches = [torch.from_numpy(tokens[t % pool].reshape(n * mb, T)).to(self.device) for t in range(steps)]
        return self.ref.train(self.cfg, weights, batches, list(self.masks[:steps]), updates=FOLLOWED, **kw)


def _ref_name(port: str) -> str:
    if not port.startswith("blocks."):
        return port
    _, i, key = port.split(".", 2)
    return f"layers.{i}.{key.split('.')[-1]}"


def setup(cfg: dict, traffic: dict, seed: int, device, *, warm: bool = True) -> Runner:
    """The cell set up and warm.  ``warm`` changes nothing here: the three
    followed steps, which the check needs, warm every shape."""
    return Runner(cfg, traffic, seed, device)

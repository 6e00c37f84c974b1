"""Driver: resilient data-parallel training of a latent-attention MoE model
(DeepSeek-V2's blocks, ``mla_mlp``/``mla_moe``) through the port's
``Trainer`` on its ``device_recovery=True`` path, one training step a unit.

It is ``resilient_train``'s driver with three differences.  The port's
configuration is built from the file's DeepSeek-V2 keys and the chip's
share of the experts (``port_config``), and the weights carry their own
names (``port_name``: the MoE's and the dense MLP's leaves share short
names).  The check follows the first ``FOLLOWED`` = 2 steps, the fewest
that hold both the host fallback (step 0 loses a shard) and the device
path (step 1), and the routing of the window's first step.  The program's
routing decisions in those steps are recorded
(``models.moe.recorded_routing``: each group's selections, in order) and
the reference replays them, so that both train along the same routing;
the reference counts the selections its own scores would have made
otherwise (``route_diff_share``).  The warm-up runs before the first
followed step, outside the recording.

The program's device counters (``obs.default_counters``: routed and
dropped (token, expert) pairs) are cleared at the end of set-up, so that
they count the window's steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time

import torch

from harness import files
from harness.checks import worst_of
from harness.traffic import alive_masks

RT = files.driver("resilient_train")
FOLLOWED = 2

_PORT = {"wq": "attn.wq", "wkv_a": "attn.wkv_a", "kv_norm": "attn.kv_norm", "wkv_b": "attn.wkv_b", "wo": "attn.wo",
         "gate": "mlp.gate", "up": "mlp.up", "down": "mlp.down", "router": "moe.router", "w_gate": "moe.w_gate",
         "w_up": "moe.w_up", "w_down": "moe.w_down", "shared_gate": "moe.shared.gate",
         "shared_up": "moe.shared.up", "shared_down": "moe.shared.down"}
_REF = {v: k for k, v in _PORT.items()}


def port_name(name: str) -> str:
    """The port's name of a reference weight."""
    if name == "head":
        return "lm_head"
    if not name.startswith("layers."):
        return name
    _, i, key = name.split(".", 2)
    return f"blocks.{i}.{_PORT.get(key, key)}"


def ref_name(port: str) -> str:
    if port == "lm_head":
        return "head"
    if not port.startswith("blocks."):
        return port
    _, i, key = port.split(".", 2)
    return f"layers.{i}.{_REF.get(key, key)}"


def port_config(cfg: dict):
    """The port's model configuration from the file's keys.  A program
    without latent attention fails here, before anything is drawn."""
    from repro_torch.models.registry import MLAConfig, MoEConfig, get_config

    rs = cfg["rope_scaling"]
    plain = {"q_lora_rank": None, "scoring_func": "softmax", "topk_method": "greedy", "norm_topk_prob": False,
             "routed_scaling_factor": 1, "seq_aux": True, "n_group": 1, "topk_group": 1, "moe_layer_freq": 1,
             "tie_word_embeddings": False, "attention_bias": False, "hidden_act": "silu"}
    other = {k: cfg[k] for k, v in plain.items() if cfg[k] != v}
    if other or rs["type"] != "yarn":
        raise ValueError(f"the port's {cfg['port_arch']} runs {plain} with YaRN rope, not {other}, {rs['type']}")
    moe = MoEConfig(num_experts=cfg["published"]["n_routed_experts"], top_k=cfg["num_experts_per_tok"],
                    d_expert=cfg["moe_intermediate_size"], num_shared=cfg["n_shared_experts"],
                    capacity_factor=cfg["capacity_factor"], router_aux_weight=cfg["aux_loss_alpha"],
                    router_score="softmax", renorm_topk=False, experts_held=tuple(cfg["experts_held"]),
                    balance="seq", padding_routes=False)
    mla = MLAConfig(kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=cfg["qk_nope_head_dim"],
                    qk_rope_head_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
                    rope_factor=float(rs["factor"]), rope_original_max=rs["original_max_position_embeddings"],
                    rope_beta_fast=float(rs["beta_fast"]), rope_beta_slow=float(rs["beta_slow"]),
                    rope_mscale=rs["mscale"], rope_mscale_all_dim=rs["mscale_all_dim"])
    return dataclasses.replace(
        get_config(cfg["port_arch"]), vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        head_dim=cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"], lead=("mla_mlp",) * cfg["first_k_dense_replace"],
        scan_unit=("mla_moe",), rope_theta=float(cfg["rope_theta"]), rms_eps=cfg["rms_norm_eps"],
        tie_embeddings=False, moe=moe, mla=mla, param_dtype=cfg["param_dtype"],
        compute_dtype=cfg["compute_dtype"]).validate()


class Runner:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        mc = port_config(cfg)
        from repro_torch.models import transformer as T
        from repro_torch.obs import default_counters
        from repro_torch.train.optimizer import AdamWConfig
        from repro_torch.train.train_step import init_train_state
        from repro_torch.train.trainer import Trainer, TrainerConfig

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.ref = files.reference(cfg["name"])
        G = cfg["groups"]
        self.groups = self.ref.fr_groups(cfg)
        self.masks = alive_masks(traffic["stragglers"], G, seed, RT.MAX_STEPS,
                                 lambda m: all(m[gs].any() for gs in self.groups))
        self._tmp = tempfile.TemporaryDirectory(prefix="perfbench-")
        trace = os.path.join(self._tmp.name, "alive.jsonl")
        with open(trace, "w", encoding="utf-8") as f:
            f.writelines(json.dumps({"alive": [int(a) for a in row]}) + "\n" for row in self.masks)
        opt = {k: v for k, v in cfg["optimizer"].items() if k != "kind"}
        tcfg = TrainerConfig(
            num_groups=G, num_shards=cfg["shards"], redundancy=cfg["redundancy"], scheme=cfg["scheme"],
            microbatch=cfg["microbatch"], seq_len=cfg["seq_len"], steps=RT.MAX_STEPS, seed=int(seed),
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
        with RT.seed_rows(self.tokens):
            self.trainer = Trainer(mc, tcfg, AdamWConfig(**opt), device=self.device,
                                   initial_state=init_train_state(mc, generator=None, model=model))
        t2 = time.perf_counter()
        self.state = None
        self.next_step = 0
        self.counted: list[int] = []
        self.routing: dict[int, list] = {}
        self.setup_log: list[str] = []
        self.program = self._follow(FOLLOWED)
        default_counters().clear()
        print(f"perfbench: set-up: weights {tw - t0:.3f} s, model and data {t1 - tw:.3f} s, trainer {t2 - t1:.3f} s, "
              f"warm-up and {FOLLOWED} followed steps {time.perf_counter() - t2:.3f} s "
              f"({', '.join(self.setup_log)})", file=sys.stderr)

    def _run_step(self, record: bool = False) -> dict:
        """One step through the trainer's own loop; its record.  With
        ``record``, the step's routing selections are kept, by group."""
        from repro_torch.models.moe import recorded_routing

        out = {}
        step = self.next_step
        self.trainer.tcfg.steps = step + 1
        with recorded_routing() if record else contextlib.nullcontext() as log:
            self.state = self.trainer.run(self.state, start_step=step, on_step=lambda s, rec: out.update(rec))
        if record:
            G = self.cfg["groups"]
            if len(log) % G:
                raise RuntimeError(f"step {step}: {len(log)} routing selections over {G} groups")
            per = len(log) // G
            self.routing[step] = [log[g * per:(g + 1) * per] for g in range(G)]
        self.next_step += 1
        return out

    def _follow(self, steps: int) -> dict:
        """The warm-up, then the first ``steps`` steps with the program's
        readings of them."""
        losses = []
        self.state, _ = self.trainer.init_state()
        t0 = time.perf_counter()
        self.trainer.warmup(self.state)
        self.setup_log.append(f"warm-up {time.perf_counter() - t0:.3f} s")
        for t in range(steps):
            t0 = time.perf_counter()
            losses.append(self._run_step(record=True)["loss"])
            self.setup_log.append(f"step {t} {time.perf_counter() - t0:.3f} s")
            if t == 0:
                b1 = float(self.trainer.opt_cfg.b1)
                grad_norms = self._leaf_norms(lambda n, p: self.state.opt.m[n] / (1.0 - b1))
        t0 = time.perf_counter()
        theta0 = self.ref.make_weights(self.cfg, self.seed, self.device)
        change = self._leaf_norms(lambda n, p: p - theta0[ref_name(n)])
        del theta0
        self.setup_log.append(f"readings {time.perf_counter() - t0:.3f} s")
        return {"loss": losses, "grad_norms": grad_norms, "change_norms": change}

    def _leaf_norms(self, fn) -> dict:
        with torch.no_grad():
            return {ref_name(n): float(torch.linalg.vector_norm(fn(n, p).double()))
                    for n, p in self.state.params.named_parameters()}

    def step(self, i: int) -> None:
        rec = self._run_step(record=self.next_step == FOLLOWED)
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
        return RT.Runner.layer_targets(self)

    def free(self) -> None:
        RT.Runner.free(self)

    def check(self, limits: dict) -> tuple[list[dict], int]:
        """The followed steps and the window's first step against the
        reference, which runs them again from the same weights, data, masks
        and routing."""
        self.free()
        self._tmp.cleanup()
        return worst_of([self.ref.compare(self.program, self.reference())], limits)

    def reference(self, *, routing=None, own_routing: bool = False, **kw) -> dict:
        """The reference over the followed steps, and the window's first
        step's forward, from the weights and data drawn again, along
        the program's routing, or ``routing`` (a reference's), or with
        ``own_routing`` its own."""
        tokens = self.ref.make_tokens(self.cfg, self.seed, self.device)
        steps = sorted(self.routing)
        batches = [torch.from_numpy(tokens[t % tokens.shape[0]]).to(self.device) for t in steps]
        routes = [None] * len(steps) if own_routing else routing or [self.routing[t] for t in steps]
        return self.ref.train(self.cfg, lambda: self.ref.make_weights(self.cfg, self.seed, self.device), batches,
                              [self.masks[t] for t in steps], routes, updates=FOLLOWED, **kw)


def setup(cfg: dict, traffic: dict, seed: int, device, *, warm: bool = True) -> Runner:
    """The cell set up and warm.  ``warm`` changes nothing here: the
    warm-up and the followed steps, which the check needs, warm every
    shape."""
    return Runner(cfg, traffic, seed, device)

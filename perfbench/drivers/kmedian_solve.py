"""Driver: Algorithm 1 through ``ResilienceSession.kmedian``, one solve a unit.

Set-up draws the points from the seed on the device as a Gaussian mixture
(the configuration's ``data``), hands them to the session as a host array,
as its users pass them, builds the assignment and the session, and runs
one solve to warm every shape.  Each unit of the window is one solve, from
the call into ``session.kmedian`` to its return, which ends in host copies
of the answer, so the device has finished.  A unit gets the next alive mask
and seed of the traffic mix.

The check holds every solve of the window against the plain reference
(``configs/<config>.py``) once the session's device state is freed.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from harness import files
from harness.checks import worst_of
from harness.traffic import alive_masks, unit_seeds

MAX_UNITS = 1024


def make_points(cfg: dict, seed: int, device) -> np.ndarray:
    """(n, d) float32 host array: a Gaussian mixture drawn on ``device``
    in a few large calls."""
    data = cfg["data"]
    if data["kind"] != "gaussian_mixture":
        raise ValueError(f"unknown data kind {data['kind']!r}")
    n, d, m = cfg["points"], cfg["dim"], data["components"]
    g = torch.Generator(device=device).manual_seed(int(seed))
    means = torch.rand((m, d), generator=g, device=device, dtype=torch.float32)
    means = means * (data["mean_high"] - data["mean_low"]) + data["mean_low"]
    comp = torch.randint(0, m, (n,), generator=g, device=device)
    x = torch.randn((n, d), generator=g, device=device, dtype=torch.float32).mul_(data["spread"])
    x += means[comp]
    return x.cpu().numpy()


class Runner:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, *, warm: bool = True):
        from repro_torch.core.assignment import cyclic_assignment
        from repro_torch.core.resilience import ResilienceSession

        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        t0 = time.perf_counter()
        self.points = make_points(cfg, seed, self.device)
        t1 = time.perf_counter()
        n, s = cfg["points"], cfg["workers"]
        self.session = ResilienceSession(
            cyclic_assignment(n, s, cfg["ell"]), recovery_method=cfg["recovery_method"], device=self.device)
        t2 = time.perf_counter()
        self.masks = alive_masks(traffic["stragglers"], s, seed, MAX_UNITS + 1)
        self.seeds = unit_seeds(seed, MAX_UNITS + 1)
        self.answers: list[tuple[int, dict]] = []
        if warm:
            self.solve(0)
        print(f"perfbench: set-up: points {t1 - t0:.3f} s, assignment and session {t2 - t1:.3f} s, "
              f"warm-up solve {time.perf_counter() - t2:.3f} s", file=sys.stderr)

    def solve(self, u: int) -> dict:
        cfg = self.cfg
        out = self.session.kmedian(
            self.points, self.traffic["k"], self.masks[u], local_iters=cfg["local_iters"],
            coord_iters=cfg["coord_iters"], seed=self.seeds[u], device=self.device)
        return {"b": np.asarray(out.recovery.b_full, dtype=np.float64), "centers": out.centers,
                "cost": float(out.cost), "summary_points": out.summary_points,
                "summary_weights": out.summary_weights}

    def step(self, i: int) -> None:
        u = i + 1
        self.answers.append((u, self.solve(u)))

    def end_to_end(self, window_s: float, units: int) -> dict:
        return {"solve_s": window_s / units}

    def layer_targets(self):
        from repro_torch.core import kmeans, kmedian, recovery
        from repro_torch.core.resilience import ResilienceSession

        return [
            (ResilienceSession, "prepare", "session.prepare"),
            (ResilienceSession, "_fingerprint", "session.fingerprint"),
            (ResilienceSession, "device_shards", "session.device_shards"),
            (recovery, "device_recovery", "recovery.device_recovery"),
            (kmedian, "_coordinator_pipeline", "kmedian.device_pipeline"),
            (kmeans, "lloyd", "kmeans.lloyd"),
            (kmeans, "_plusplus_batched", "kmeans.plusplus"),
            (kmeans, "_weiszfeld_update", "kmeans.weiszfeld"),
            (kmeans, "clustering_cost", "kmeans.cost"),
        ]

    def free(self) -> None:
        self.session = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict) -> tuple[list[dict], int]:
        """Every solve of the window against the reference: the worst of
        each number, and how many solves read over a limit."""
        self.free()
        ref = files.reference(self.cfg["name"])
        pts = torch.from_numpy(self.points).to(self.device, torch.float64)
        return worst_of([ref.compare(pts, self.masks[u], answer, self.cfg) for u, answer in self.answers], limits)


def setup(cfg: dict, traffic: dict, seed: int, device, *, warm: bool = True) -> Runner:
    return Runner(cfg, traffic, seed, device, warm=warm)

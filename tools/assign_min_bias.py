#!/usr/bin/env python3
"""How far the port's `assign_min` minima sit from float64, on the card.

Points from `gaussian_mixture(1M, 256, 128)` packed on the shards of
`cyclic_assignment(1M, 10, 4)` (10 x 400,000 x 128, as in chip_smoke.py's
session phase), against the mixture's own 256 centers (every point near its
center: |x|^2 ~ 43, d2 ~ 0.2) and against 256 random rows.  For each, the
median cost sum(sqrt(d2)) through the kernel and through the plain version
against the float64 cost at the chosen centers, and the mean and spread of
each side's d2 error.

Run:  python3 tools/assign_min_bias.py [--src PATH]   (one CUDA card;
--src picks the port's sources, e.g. a `git archive` of another commit)
"""

import argparse
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("assign_min_bias: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import cyclic_assignment
    from repro_torch.core.kmedian import pack_local_shards
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.kernels import _build
    from repro_torch.kernels.pairwise_dist import ops as pd

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    dev = torch.device("cuda")
    pts, gen_centers, _ = gaussian_mixture(1_000_000, 256, 128, rng=np.random.default_rng(0))
    xs, ws = pack_local_shards(pts, cyclic_assignment(1_000_000, 10, 4))
    xs, ws = torch.from_numpy(xs).to(dev), torch.from_numpy(ws).to(dev).double()
    m = ws > 0
    rows = pts[np.random.default_rng(1).choice(len(pts), 256, replace=False)]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"sources {args.src}  [{card}]")
    for name, c in (("mixture centers", gen_centers), ("random rows", rows)):
        cb = torch.from_numpy(c).to(dev).unsqueeze(0).expand(10, -1, -1).contiguous()
        out = {"kernel": pd.assign_min(xs, cb), "plain": pd.assign_min(xs, cb, impl="torch_ref")}
        for side, (idx, d2) in out.items():
            own = torch.gather(cb.double(), 1, idx.long().unsqueeze(-1).expand(-1, -1, 128))
            d64 = ((xs.double() - own) ** 2).sum(-1)
            err = (d2.double() - d64)[m]
            cost, cost64 = (float((ws * torch.sqrt(v)).sum()) for v in (d2.double(), d64))
            print(f"{name}, {side}: median cost rel error {(cost - cost64) / cost64:+.3e}; d2 error "
                  f"mean {float(err.mean()):+.3e} std {float(err.std()):.3e} "
                  f"(mean d2 {float(d64[m].mean()):.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

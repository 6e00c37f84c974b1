#!/usr/bin/env python3
"""How far the xLSTM chunkwise forward and the stepwise decode part, and why.

Card (default): xlstm-1.3b at full width, depth cut to 8 layers (7 mLSTM,
1 sLSTM), random weights from --seed, 4 x 512 tokens (two chunks of 256):
``forward_train`` against 512 teacher-forced ``decode_step`` calls, each in
f32 (TF32 off), in bf16, and in an f64 twin of the port's
``models/xlstm.py`` (built in memory: every f32 cast of the cell made f64,
RMSNorm in f64), with each path also held against the f64 twin.  If the
two forms are one function, the f64 twin's gap is at f64 rounding and the
f32 gap is each path's f32 rounding.

Reference (--reference, CPU, JAX): the reference's own bf16 gap between
its jitted ``forward_train`` and its jitted decode step at d_model 64 and
256 (8 layers, 4 x 512 tokens), the twin of the card's bf16 comparison at
widths the CPU can run.

Run:  python3 tools/xlstm_consistency.py [--seed N]          (one CUDA card)
      PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/xlstm_consistency.py --reference
"""

import argparse
import dataclasses
import sys
import types
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def _gap(a, b):
    return float(abs(a - b).max() / abs(b).max())


def reference(seed: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.models import transformer as JT
    from repro.models.registry import get_config
    from repro.serve import decode as JD

    for d in (64, 256):
        cfg = dataclasses.replace(get_config("xlstm-1.3b"), n_layers=8, d_model=d, vocab=256,
                                  head_dim=16).validate()
        params = JT.init_params(jax.random.PRNGKey(seed), cfg)
        toks = jax.random.randint(jax.random.PRNGKey(seed + 1), (4, 512), 0, cfg.vocab)
        full, _, _ = jax.jit(lambda p, t: JT.forward_train(p, {"tokens": t}, cfg, JT.ModelContext()))(params, toks)
        step, cache, outs = JD._decode_fn(cfg, JT.ModelContext()), JT.init_cache(cfg, 4, 512), []
        for t in range(512):
            lg, cache = step(params, cache, toks[:, t : t + 1], jnp.asarray(t, jnp.int32))
            outs.append(lg[:, 0])
        a = np.asarray(jnp.stack(outs, 1).astype(jnp.float32))
        b = np.asarray(full.astype(jnp.float32))
        print(f"reference, bf16, d_model {d}, 8 layers: stepwise vs chunkwise max|a-b|/max|b| over the first "
              f"12 tokens {_gap(a[:, :12], b[:, :12]):.3e}, over 512 {_gap(a, b):.3e} (CPU, jax {jax.__version__})")


def card(seed: int) -> int:
    sys.path.insert(0, str(SRC))
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("xlstm_consistency: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models import xlstm as X
    from repro_torch.models.registry import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev, ctx = torch.device("cuda"), T.ModelContext()
    toks = torch.randint(0, 50304, (4, 2048), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(seed))[:, :512]

    def both(model, cfg):
        chunk = T.forward_train(model, {"tokens": toks}, cfg, ctx)[0].double()
        cache, steps = T.init_cache(cfg, 4, 512, device=dev), []
        for t in range(512):
            lg, cache = T.decode_step(model, cache, toks[:, t : t + 1], t, cfg, ctx)
            steps.append(lg[:, 0])
        return chunk, torch.stack(steps, 1).double()

    cfg32 = get_config("xlstm-1.3b", n_layers=8, compute_dtype="float32")
    m32 = T.init_params(cfg32, generator=torch.Generator(device=dev).manual_seed(seed))
    c32, s32 = both(m32, cfg32)
    cfg16 = get_config("xlstm-1.3b", n_layers=8)
    c16, s16 = both(T.cast_params(m32, cfg16), cfg16)

    # The f64 twin: the port's cell with its f32 casts made f64, in memory.
    text = (Path(X.__file__).read_text().replace(".float()", ".double()").replace("torch.float32", "torch.float64")
            .replace("from . import layers as L", "from repro_torch.models import layers as L")
            .replace("from .registry import", "from repro_torch.models.registry import"))
    x64 = types.ModuleType("xlstm_f64")
    exec(compile(text, "xlstm_f64", "exec"), x64.__dict__)
    rmsnorm = L.rmsnorm

    def rmsnorm64(x, scale, *, eps=1e-6):
        xd = x.double()
        return (xd * torch.rsqrt(torch.mean(xd * xd, dim=-1, keepdim=True) + eps) * scale.double()).to(x.dtype)

    cfg64 = get_config("xlstm-1.3b", n_layers=8, compute_dtype="float64", param_dtype="float64")
    T.X, L.rmsnorm = x64, rmsnorm64
    try:
        m64 = T.model_from_state_dict(cfg64, {k: v.double() for k, v in m32.state_dict().items()})
        c64, s64 = both(m64, cfg64)
    finally:
        T.X, L.rmsnorm = X, rmsnorm
    print(f"xlstm-1.3b, 8 layers, 4 x 512 tokens, stepwise vs chunkwise max|a-b|/max|b|: f64 twin "
          f"{_gap(s64, c64):.3e}, f32 {_gap(s32, c32):.3e}, bf16 {_gap(s16, c16):.3e}  [{smi}]")
    print(f"against the f64 twin: f32 chunkwise {_gap(c32, c64):.3e}, f32 stepwise {_gap(s32, s64):.3e}, "
          f"bf16 chunkwise {_gap(c16, c64):.3e}, bf16 stepwise {_gap(s16, s64):.3e}  [{smi}]")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reference", action="store_true", help="the reference's bf16 gap on the CPU (JAX)")
    args = ap.parse_args()
    if args.reference:
        reference(args.seed)
        return 0
    return card(args.seed)


if __name__ == "__main__":
    sys.exit(main())

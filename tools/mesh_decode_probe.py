#!/usr/bin/env python3
"""Where a (1, 2) mesh's teacher-forced decode of deepseek-moe-16b parts
from the meshless one, and why (phase "serve mesh" (b) of chip_smoke.py).

On one CUDA card, deepseek-moe-16b at full width and depth in bf16 from
--seed:

1. a model rank's products at decode's few rows against the same columns
   of the whole product (its query, key and value projections, the shared
   experts' gate and up, the vocab-parallel head): bit for bit or not, by
   the number of rows; ``decode_attention`` over half the heads and over
   half the rows against the whole, length by length, and its two
   products on their own (``_attention_split``);
2. the meshless teacher-forced decode of 16 steps in a cache of 16 slots
   against the same decode in the 48 slots of the oracle's cache;
3. two gloo ranks on the card, mesh (1, 2), each decoding the 16 steps
   with the oracle's routing replayed (``launch.mesh_runs.moe_serve_rank``)
   in 16 slots and in the oracle's 48, against the meshless oracle: the
   worst gap, the gap by step and the first op whose output differs
   (``launch.mesh_runs.decode_taps``).

Run:  python3 tools/mesh_decode_probe.py [--seed N]          (one CUDA card)
"""

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _products(dev) -> None:
    import torch

    torch.manual_seed(0)
    bf = torch.bfloat16
    for name, K, N in (("q/k/v", 2048, 2048), ("shared gate/up", 2048, 2816), ("lm_head", 2048, 102400)):
        same = {}
        for M in (1, 4, 8, 64, 8192):
            x = (torch.randn(M, K, device=dev) * 0.05).to(bf)
            w = (torch.randn(K, N, device=dev) * 0.05).to(bf)
            whole, h = x @ w, N // 2
            same[M] = all(torch.equal(whole[:, r * h:(r + 1) * h], x @ w[:, r * h:(r + 1) * h].contiguous())
                          for r in range(2))
        print(f"{name} ({K} x {N}): a rank's half of the columns bit for bit the whole product's, by rows {same}")
    _attention_split(dev)


def _attention_split(dev) -> None:
    """``decode_attention`` over half the heads (a (1, 2) mesh's model rank)
    and over half the rows (a (2, 1) mesh's data rank) against the whole, at
    each length of a 48-slot cache: the lengths where it differs, how many
    outputs and by how much; then which of its two f32 products differs on
    the same operands, in 48 and in 2048 slots, and whether the second
    product in f64, rounded to f32, is the same bits on every split."""
    import torch

    from repro_torch.kernels.flash_attention.ops import decode_attention

    torch.manual_seed(0)
    bf = torch.bfloat16
    B, H, dh = 4, 16, 128
    q = torch.randn(B, 1, H, dh, device=dev).to(bf)
    k, v = (torch.randn(B, 48, H, dh, device=dev).to(bf) for _ in range(2))
    halves = {"heads": (2, [slice(0, H // 2), slice(H // 2, H)]), "rows": (0, [slice(0, B // 2), slice(B // 2, B)])}

    def part(t, dim, sl):
        return (t[:, :, sl] if dim == 2 else t[sl]).contiguous()

    for split, (dim, sls) in halves.items():
        differ = {}
        for cur in range(1, 49):
            whole = decode_attention(q, k, v, cur)
            got = torch.cat([decode_attention(part(q, dim, sl), part(k, dim, sl), part(v, dim, sl), cur)
                             for sl in sls], dim)
            if not torch.equal(got, whole):
                gap = (got.float() - whole.float()).abs()
                differ[cur] = (int((gap > 0).sum()), float(gap.max()), float(whole.float().abs().max()))
        print(f"decode_attention over half the {split} in 48 slots: bit for bit the whole's at {48 - len(differ)} "
              f"of 48 lengths; where not, length: (outputs that differ of {whole.numel()}, max |diff|, max "
              f"|whole|) {differ}")
    for S in (48, 2048):
        k, v = (torch.randn(B, S, H, dh, device=dev).to(bf) for _ in range(2))
        qg = (q.reshape(B, H, 1, dh) * torch.tensor(dh ** -0.5, dtype=bf)).to(bf).float()
        s = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
        p = torch.softmax(s, dim=-1).to(bf)
        same = {}
        for split, (dim, sls) in halves.items():
            hd = 1 if dim == 2 else 0  # the heads of (B, KV, g, ·) lie on dim 1
            cut = lambda t, sl, d: (t[:, sl] if d == 1 else t[sl]).contiguous()  # noqa: E731
            kk = lambda sl: part(k, dim, sl).float()  # noqa: E731
            vv = lambda sl, dt: part(v, dim, sl).to(dt)  # noqa: E731
            s_parts = torch.cat([torch.einsum("bkgd,bskd->bkgs", cut(qg, sl, hd), kk(sl)) for sl in sls], hd)
            o_whole = torch.einsum("bkgs,bskd->bkgd", p.float(), v.float())
            o_parts = torch.cat([torch.einsum("bkgs,bskd->bkgd", cut(p, sl, hd).float(), vv(sl, torch.float32))
                                 for sl in sls], hd)
            o64 = torch.einsum("bkgs,bskd->bkgd", p.double(), v.double()).float()
            o64_parts = torch.cat([torch.einsum("bkgs,bskd->bkgd", cut(p, sl, hd).double(),
                                                vv(sl, torch.float64)).float() for sl in sls], hd)
            same[split] = {"q.K": torch.equal(s_parts, s), "p.V": torch.equal(o_parts, o_whole),
                           "p.V max |diff|": float((o_parts - o_whole).abs().max()),
                           "p.V in f64": torch.equal(o64_parts, o64)}
        print(f"decode_attention's products in {S} slots, half of each split against the whole, bit for bit: "
              f"{same}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mesh_decode_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.launch import distributed as mesh_dist
    from repro_torch.launch import mesh_runs
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.serve import decode as D

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda")
    _products(dev)
    _build.build(("flash_attention",))
    with torch.no_grad():
        cfg = get_config("deepseek-moe-16b", param_dtype="bfloat16")
        served = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(args.seed))
        tokens = torch.randint(0, cfg.vocab, (4, 2048), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(args.seed))
        with moe_mod.recorded_routing() as log:
            logits, cache = D.make_prefill_fn(cfg, T.ModelContext())(served, {"tokens": tokens})
        del cache
        prompt = tokens[:, :16].contiguous()
        kept = {"logits": logits.cpu(), "routing": [t.cpu() for t in log], "prompt": prompt.cpu(),
                "ids": D.greedy_generate(served, cfg, prompt, steps=32).cpu()}
        seq = torch.cat([kept["prompt"], kept["ids"]], 1).to(dev)
        runs = {}
        for slots in (48, 16):
            c, out = T.init_cache(cfg, 4, slots, device=dev), []
            for t in range(16):
                lg, c = T.decode_step(served, c, seq[:, t:t + 1], t, cfg, T.ModelContext())
                out.append(lg)
            runs[slots] = torch.stack(out)
        a, b = runs[16].float(), runs[48].float()
        print(f"meshless decode, 16 steps in 16 slots against 48: bit for bit {torch.equal(runs[16], runs[48])}, "
              f"max|a-b|/max|b| {float((a - b).abs().max() / b.abs().max()):.3e}  [{card}]")
        with tempfile.TemporaryDirectory(prefix="repro-decode-probe-") as tmp:
            mesh_runs.moe_mesh_oracle(served, cfg, tokens, kept, tmp, half_decode_steps=2)
            del served
            torch.cuda.empty_cache()
            for slots in (16, None):
                rep = mesh_dist.run_ranks(mesh_runs.moe_serve_rank, 2, backend="gloo", device="cuda", timeout=600,
                                          args=(args.seed, (1, 2), tmp, 16, False, True, None, 2048, slots))
                r = rep["ranks"][0]
                print(f"(1, 2) decode, 16 steps in {r['decode_slots']} slots against the oracle's 48: worst gap "
                      f"{r['decode_gap']:.3e}, by step {[f'{g:.2e}' for g in r['decode_gaps']]}; the first op "
                      f"that differs {r['decode_first_difference']}  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card, then drives the paper's
Algorithms 1, 2 and 3 through the port's public entry points, at the
paper's size and at full width, runs the elastic resilience runtime
(ResilienceSession: on-device recovery in step_cost, elastic patching,
placement), runs Algorithm 1, the session and the streaming tree through
the torch.distributed mesh executor (a world of one over NCCL, two ranks
over gloo), runs the streaming clustering service (the coreset tree, the
query engine, the micro-batching frontend) on the same 1M points,
serves qwen3-4b, the MoE model deepseek-moe-16b and the xLSTM model
xlstm-1.3b at full width and depth (prefill and greedy decode) and
moonshot-v1-16b-a3b at full width, and fails loudly: there is no CPU
fallback and no caught phase.  Every phase prints its seconds beside the card's name and
power limit.

Phases:
  1. device      the card's name, count, power limit
  2. build       nvcc for sm_90a, one process per source, all at once
  3. prelude     full-width data, assignment, stragglers; host recovery
                 solve, shard packing and host-to-device copy, timed apart
  4. kernels     each kernel against its plain version at the shapes of the
                 runs below, plus edge cases; flash attention in bf16 at
                 (B, T, S, H, KV, dh) = (2, 100, 100, 8, 2, 64), the ragged
                 T < S case (2, 300, 337, 8, 2, 128) and the prefill shape
                 (4, 2048, 2048, 32, 8, 128) (the tma-wgmma kernel), the
                 T < S case (1, 16, 32, 4, 2, 16) and f32 (the mma-sync
                 one), and the MoE prefill shape (4, 2048, 2048, 16, 16,
                 128) (group size 1); pairwise_sqdist at its edges
                 and at (1,000,000 x 128) x (256 x 128), the op's own path:
                 launch counts are read just around that call
  5. paper size  the twin of examples/quickstart.py; the p_a=0.2 run is
                 also held against the plain path; then the twin of
                 examples/distributed_pca.py (Algorithm 3)
  6. full width  centralized k-median and Algorithm 1 at the shape of SIFT1M
                 (1,000,000 x 128 f32), k=256, s=10, t=3, p_a=0.2, which
                 leaves shards with no alive replica (feasible and uncovered
                 are printed beside the ratio); launch counts are read from
                 each of the two runs apart, and the kernel line reports
                 Algorithm 1's
  7. profile     Algorithm 1 once more under torch.profiler: kernel time by
                 name against the wall time
  8. session full width  the elastic resilience runtime on the same points:
                 (a) Algorithm 1 through session.kmedian on the covered
                 cyclic_assignment(1M, 10, 4) with the same 3 stragglers:
                 feasible=True, uncovered=0, the Lemma-3 mass within 1e-4;
                 (b) 8 rounds of the "fixed" scenario (t=3) with
                 ElasticPolicy(patience=2): observe, then step_cost with
                 the recovery solved on the card (no host solve), each
                 round's seconds split into fingerprint, host and device,
                 every covered round inside the Lemma-3 band, one round
                 again through the plain versions (1e-5); (c) at the
                 paper's size (n=320, s=8, k=4) the 5 x 4 x 5 grid of
                 schemes x scenarios x rounds, each first-round pattern's
                 device solve held to the host LP's band, then a permanent
                 loss and join on a session with placement; launch counts
                 are read around (a) and each round of (b)
  9. mesh full width  the torch.distributed executor on the same points:
                 (a) a world of one over NCCL in this process runs phase 6's
                 Algorithm-1 cell, within 1e-5 of its cost (bit for bit
                 printed); (b)-(d) two ranks over gloo on this card,
                 spawned, 5 nodes each: (b) the same cell within 1e-5, the
                 ranks' b, packed shards and centers identical by hash,
                 each rank's peak memory, shard bytes and seconds (host
                 prelude, local solves, collectives); (c) 8 rounds of
                 observe + step_cost on phase 8's covered cell, each within
                 1e-5 of phase 8 (b)'s round, 0 host solves, rows written
                 only by the owning rank; (d) the stream cell of phase 10
                 cut to 16 batches: both ranks' frontiers bit for bit, within
                 1e-5 of a local session fed the same batches; each rank's
                 launches are read around each part
  10. stream full width  the streaming service on the same 1M x 128 points,
                 every warm-up pass's errors counted (any error fails):
                 the kernels first at each shape the phase sends them;
                 (a) StreamingSession(d=128, k=256, 8 nodes, FR ell=2,
                 fanout 4, leaf 16384, coreset 4096) ingests 64 batches of
                 15,625 rows under make_scenario("iid", 8, p=0.15): exactly
                 61 leaf and 18 level compactions, buckets by level
                 [1, 3, 3], 28,672 summary points, 576 pending; rows/s,
                 ingest ms, launches per ingest; (b) a second session fed
                 the first 16 batches with every node alive: its frontier
                 within 1e-5 of (a)'s after 16 (bit for bit printed);
                 (c) solve(iters=20) over the frontier padded to 32,768
                 rows; the stream model's cost on the 1M points against the
                 centralized lloyd's; the frontier's cost within 0.35 of it;
                 (d) the query engine after a warm-up: the first query
                 launches assign_min once; batches of 1, 63, 64, 1000 and
                 4096 rows against the plain version (idx outside near
                 ties, d^2 in the kernel band, distances within 1e-5 of
                 float64), one launch each; p50/p99 over 200 calls of 256
                 rows; (e) AsyncFrontend(window 2 ms, max batch 256, cache
                 1024) over (a)'s session and a second one fed 4 x 65,536
                 rows of another mixture: a burst of 4096 queries of 1-16
                 rows, 30% repeats; rows/s, p50/p99/p999, dispatches,
                 occupancy, cache hit rate; assign_min launches equal the
                 dispatches; every answer bit for bit the query engine's
  11. alg3 full width  Algorithm 3 (resilient_pca) at the shape of SIFT1M:
                 planted_subspaces(1M, 1, 128, 8, noise 0.05), centred;
                 s=10, Bernoulli ell=8, t=3, r=8, delta=0.25; host prelude,
                 sketch SVDs, coordinator SVD and cost timed apart;
                 centralized_pca on all rows; the ratio must lie within
                 the Theorem-5 band 1 + 4 max(delta, achieved) times 1.05
  12. alg2 full width  Algorithm 2 (resilient_subspace_clustering) on
                 planted_subspaces(1M, 16, 128, 8, noise 0.05) with the same
                 s, ell, t and stragglers; k=16, r=8, coreset_size=4096;
                 steps timed apart; a centralized lloyd_subspace on all
                 rows; the cost must lie within max(5 central, central + 2)
  13. serve      qwen3-4b (36 layers, d_model 2560, 32 heads over 8 KV
                 heads, vocab 151936), random weights from --seed drawn on
                 the card, cast once to bf16: (a) prefill of 4 x 2048
                 tokens through the kernel, exactly 36 flash launches;
                 (b) the same prefill through the plain attention, the
                 last-position logits within 2e-2; (c) greedy_generate,
                 batch 4, prompt 16, gen 32, no flash launch; then one
                 prefill and 8 decode steps under torch.profiler (kernel
                 time by name, device idle share)
  14. serve moe  deepseek-moe-16b (28 layers, d_model 2048, 16 heads over 16
                 KV heads, 64 routed experts top-6 of width 1408, 2 shared,
                 softmax router, vocab 102400; 16.879 B parameters), drawn in
                 bf16 on the card from --seed: (a) prefill of 4 x 2048 tokens,
                 exactly 28 flash launches, seconds, tokens/s, peak memory;
                 (b) the kernel prefill again, bit for bit equal to (a)'s:
                 the logits and every layer's routing record (each token's
                 experts, each expert's kept tokens; models.moe.
                 recorded_routing); the plain-attention prefill, its routing
                 recorded too: with
                 no routing difference the logits within 2e-2, else every
                 K cache up to and including the first layer that differs
                 within 2e-2 relative in norm; then the plain prefill with
                 the kernel run's routing replayed, its logits and every
                 layer's K and V caches within 2e-2; the combine
                 (models.moe._combine) against index_add_ at the prefill and
                 the decode shape, timed, two combines bit for bit; (c)
                 greedy_generate, batch 4, prompt 16, gen 32 (capacity 1 a
                 step), no kernel launch; (d) one prefill and 8 decode
                 steps under torch.profiler; (b') the comparisons of (b) in
                 f32 (the mma-sync kernel) at full width, depth cut to 4
                 layers, at 1e-4, and a control that must exceed 1e-4:
                 the replayed plain prefill with TF32 matmuls; (e)
                 moonshot-v1-16b-a3b (sigmoid router,
                 top-k renormalised) at full width, depth cut 48 -> 4, bf16:
                 prefill (4 flash launches), 8 decode steps, and (b)'s check
  15. serve xlstm  xlstm-1.3b (48 layers: 42 mLSTM, 6 sLSTM; d_model 2048,
                 4 heads, mLSTM heads 1024 wide, vocab 50304; 3,631,155,536
                 parameters, the count held to the one from the widths),
                 drawn in bf16 on the card from --seed: (a) prefill of
                 4 x 2048 tokens: seconds, tokens/s, peak memory, 0 kernel
                 launches, finite logits (4, 1, 50304), {} a layer as the
                 cache; (b) forward_train (chunkwise, two chunks of 256)
                 against 512 teacher-forced decode_step calls on 4 x 512
                 tokens: f32 at full width cut to 8 layers (7 mLSTM, 1
                 sLSTM) within 5e-4 of the logits' scale (the reference's
                 band for this comparison) beside a TF32 control that must
                 exceed it, bf16 at 8 and at 48 layers printed; (c) greedy_generate, batch 4, prompt 16,
                 gen 32, 0 kernel launches, the recurrent state's bytes;
                 (d) one prefill and 8 decode steps under torch.profiler
  16. timing     each kernel, its plain version and one library call
                 (weighted_segsum also at the coordinator's (1, 2560, 256,
                 128), with its launches in Algorithm 1 by shape); the
                 bound of rows assign_min and pairwise_sqdist is three TF32
                 passes (3xTF32, the least this card needs for fp32-accurate
                 distances; one fp32 CUDA-core pass beside it), the flash
                 row adds the floor of its split p (1.5 x its bound); these
                 computed figures and the shapes go on the printed timing
                 lines, the kernels line holds the measured numbers and
                 bound_ms; flash is timed at the MoE shape too, and its row
                 lists its launches by path

The last two lines are the card's name and power limit and
{"ok": true, "device": {...}}; the line before them lists the kernels.

Run:  python3 chip_smoke.py [--seed N]
Needs one CUDA card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_FP32_FLOPS = 67e12  # H100 SXM, non-tensor-core fp32 (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense TF32 tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3


CARD = {"smi": ""}  # the card's name and power limit, printed beside every time


@contextlib.contextmanager
def phase(name: str):
    print(f"=== phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[seconds] {name}: {time.perf_counter() - t0:.3f}  [{CARD['smi']}]", flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def timed_steps(module, names, sync, log: list):
    """While the block runs, time every outermost call of the named
    functions of ``module`` (the card synchronised before and after each)
    into ``log`` as (name, seconds); a call made inside another timed call
    is part of that one.  The functions are restored afterwards."""
    saved = {name: getattr(module, name) for name in names}
    depth = [0]

    def timed(name, fn):
        def call(*args, **kw):
            if depth[0]:
                return fn(*args, **kw)
            sync()
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                out = fn(*args, **kw)
            finally:
                depth[0] -= 1
            sync()
            log.append((name, time.perf_counter() - t0))
            return out
        return call

    for name, fn in saved.items():
        setattr(module, name, timed(name, fn))
    try:
        yield log
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def profiled(tag, fn, top=12):
    """Run fn under torch.profiler; print kernel time by name.  Returns
    the seconds of kernel time (device busy)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # Kernels only: an aten op's entry repeats the time of its kernels.
    kernels = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=dev_us, reverse=True,
    )
    busy = sum(dev_us(e) for e in kernels) / 1e6
    print(f"{tag} under the profiler: wall {wall:.3f} s, kernels {busy:.3f} s "
          f"({100 * busy / wall:.1f}% of the profiled wall, which the profiler inflates)")
    for e in kernels[:top]:
        print(f"  {dev_us(e) / 1e3:10.1f} ms  {e.count:7d} launches  {e.key[:90]}")
    return busy


def cuda_ms(fn, reps):
    """Milliseconds per call of fn on the card: CUDA events around ``reps``
    calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def moe_combine_timing(seed: int, card: str) -> None:
    """The MoE combine (``models.moe._combine``: each token's contributions
    gathered and added in the reference's order) against ``index_add_``
    (atomics) of the same weighted rows, at deepseek-moe-16b's prefill
    shape (8192 tokens, 64 experts top-6, capacity 960, d_model 2048) and
    its decode shape (4 tokens, capacity 1), timed in this call; two
    combines must give the same bits."""
    import torch

    from repro_torch.models import moe as M

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    for tag, n in (("prefill", 8192), ("decode", 4)):
        E, k, d = 64, 6, 2048
        cap = min(max(1, int(n * k * 1.25 / E)), n)
        vals, experts = M._topk(torch.rand((n, E), generator=g, device=dev), k)
        w = torch.zeros((n, E), device=dev).scatter_(1, experts, vals)
        vals, idx = M._topk(w.T, cap)
        out = torch.randn((E, cap, d), generator=g, device=dev).bfloat16()
        flat_idx = idx.reshape(-1)

        def atomics():
            weighted = out * vals[..., None].bfloat16()
            return torch.zeros((n, d), dtype=torch.bfloat16, device=dev).index_add_(
                0, flat_idx, weighted.reshape(-1, d))

        a, b = M._combine(out, idx, vals, n, k), M._combine(out, idx, vals, n, k)
        x, y = atomics(), atomics()
        ms, lib_ms = cuda_ms(lambda: M._combine(out, idx, vals, n, k), 20), cuda_ms(atomics, 20)
        print(f"MoE combine at the {tag} shape ({n} tokens, capacity {cap}): {ms:.3f} ms, index_add_ "
              f"{lib_ms:.3f} ms (weighting included in both); two combines bit for bit {torch.equal(a, b)}, "
              f"two index_add_ bit for bit {torch.equal(x, y)}, combine vs index_add_ max|a-b| "
              f"{float((a.float() - x.float()).abs().max()):.3e}  [{card}]")
        if not torch.equal(a, b):
            raise AssertionError(f"MoE combine at the {tag} shape: two runs differ")


def xlstm_param_count(cfg) -> int:
    """The parameters of an mLSTM/sLSTM model from its config's widths."""
    d, H, W = cfg.d_model, cfg.n_heads, cfg.conv_width
    di, dh, f = int(cfg.mlstm_proj_factor * d), d // H, int(cfg.slstm_proj_factor * d)
    mlstm = 2 * d * di + W * di + di + 3 * di * di + 2 * (di * H + H) + di * d + d + di
    slstm = 4 * (d * d + H * dh * dh + d) + d * d + 3 * d * f + 3 * d
    kinds = cfg.block_types
    return kinds.count("mlstm") * mlstm + kinds.count("slstm") * slstm + 2 * cfg.vocab * d + d


def serve_xlstm(seed: int, card: str) -> None:
    """Phase "serve xlstm": xlstm-1.3b at full width and depth in bf16, then
    chunkwise against stepwise at depth 8 in f32 and bf16 and at full depth;
    greedy decode; a profile.  No kernel of the port runs on this path."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.serve import decode as D

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    ctx = T.ModelContext()
    # (a) 48 layers (42 mLSTM, 6 sLSTM), drawn in bf16 on the card
    cfg = get_config("xlstm-1.3b", param_dtype="bfloat16")
    B_s, T_s, prompt_len, gen_len = 4, 2048, 16, 32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    served = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(seed))
    sync()
    n_params = T.param_count(served)
    kinds = cfg.block_types
    print(f"xlstm-1.3b: {n_params:,} parameters ({kinds.count('mlstm')} mLSTM and {kinds.count('slstm')} sLSTM "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads (mLSTM heads "
          f"{int(cfg.mlstm_proj_factor * cfg.d_model) // cfg.n_heads} wide), vocab {cfg.vocab}); drawn in bf16 "
          f"on the card in {time.perf_counter() - t0:.3f} s; "
          f"{torch.cuda.memory_allocated() / 2**30 - base:.3f} GiB")
    if n_params != xlstm_param_count(cfg):
        raise AssertionError(f"xlstm-1.3b holds {n_params} parameters, its widths give {xlstm_param_count(cfg)}")
    tokens = torch.randint(0, cfg.vocab, (B_s, T_s), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))
    prefill = D.make_prefill_fn(cfg, ctx)
    prefill(served, {"tokens": tokens[:, :64]})  # warm-up
    sync()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(served, {"tokens": tokens})
    sync()
    prefill_s = time.perf_counter() - t0
    counts = dispatch.launch_counts()
    print(f"(a) prefill {B_s} x {T_s} tokens: {prefill_s:.3f} s  ({B_s * T_s / prefill_s:.0f} tokens/s)  "
          f"launches {counts}  peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{card}]")
    if sum(counts.values()) != 0:
        raise AssertionError(f"xLSTM prefill launched {counts}; its path runs no kernel of the port")
    if logits.shape != (B_s, 1, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"xLSTM prefill logits of shape {tuple(logits.shape)} or not finite")
    if cache != [{}] * cfg.n_layers:
        raise AssertionError("xLSTM prefill returned a recurrent cache; the reference returns {} a layer")
    del logits, cache

    # (b) chunkwise (forward_train) against stepwise (decode_step, teacher-
    # forced) on 4 x 512 tokens: two chunks of 256, the carry exercised.
    toks = tokens[:, :512]

    def gap(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def chunk_vs_step(tag, model, cfg_b, tol):
        t0 = time.perf_counter()
        full, _, _ = T.forward_train(model, {"tokens": toks}, cfg_b, ctx)
        sync()
        fwd_s = time.perf_counter() - t0
        cache, steps = T.init_cache(cfg_b, B_s, toks.shape[1], device=dev), []
        t0 = time.perf_counter()
        for t in range(toks.shape[1]):
            lg, cache = T.decode_step(model, cache, toks[:, t : t + 1], t, cfg_b, ctx)
            steps.append(lg[:, 0])
        sync()
        dec_s = time.perf_counter() - t0
        a, b = torch.stack(steps, 1).float(), full.float()
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            raise AssertionError(f"{tag}: logits are not finite")
        g = gap(a, b)
        fro = float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
        print(f"{tag}: forward_train {fwd_s:.3f} s, {toks.shape[1]} decode steps {dec_s:.3f} s; logits "
              f"max|a-b|/max|b| {g:.3e} (limit {tol}), |a-b|/|b| {fro:.3e}, argmax agrees "
              f"{float((a.argmax(-1) == b.argmax(-1)).float().mean()):.4f}  [{card}]")
        if tol is not None and g > tol:
            raise AssertionError(f"{tag}: chunkwise and stepwise logits differ by {g:.3e} of their scale (> {tol:g})")
        return a

    # f32 at 5e-4 of the scale, the band of the reference's own chunkwise-
    # against-stepwise test (tests/test_cells_property.py): the two forms are
    # one function (an f64 twin agrees to 1e-13, tools/xlstm_f64_control.py),
    # and f32 sums over heads of 1024 part them by ~1e-4.  The control: the
    # forward with TF32 matmuls must part from the f32 decode by more.
    cfg8 = get_config("xlstm-1.3b", n_layers=8, compute_dtype="float32")
    model8 = T.init_params(cfg8, generator=torch.Generator(device=dev).manual_seed(seed))
    stepwise = chunk_vs_step("(b) f32, 8 of 48 layers (7 mLSTM, 1 sLSTM)", model8, cfg8, 5e-4)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32, _, _ = T.forward_train(model8, {"tokens": toks}, cfg8, ctx)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    control = gap(tf32.float(), stepwise)
    print(f"(b) control: the f32 forward with TF32 matmuls against the f32 decode: max|a-b|/max|b| "
          f"{control:.3e} (must exceed 5e-4)  [{card}]")
    if not control > 5e-4:
        raise AssertionError(f"(b): TF32 arithmetic parts by only {control:.3e}: the 5e-4 check cannot tell it")
    del stepwise, tf32
    # bf16: printed.  The forward rounds the conv output, q and k to bf16 and
    # the decode keeps them f32 (the reference's dtypes), and this random
    # model amplifies the difference: the reference itself parts by 0.14-0.26
    # on the CPU at d_model 64-256 (PERF.md).
    cfg8b = get_config("xlstm-1.3b", n_layers=8)
    chunk_vs_step("(b) bf16, 8 of 48 layers", T.cast_params(model8, cfg8b), cfg8b, None)
    del model8
    torch.cuda.empty_cache()
    chunk_vs_step("(b) bf16, 48 layers", served, cfg, None)

    # (c) greedy decode from the recurrent state: no KV cache
    prompt = tokens[:, :prompt_len].contiguous()
    D.greedy_generate(served, cfg, prompt[:, :2], steps=2)  # warm-up
    dispatch.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    out = D.greedy_generate(served, cfg, prompt, steps=gen_len)
    sync()
    dec_s = time.perf_counter() - t0
    counts = dispatch.launch_counts()
    steps = prompt_len + gen_len
    state = T.init_cache(cfg, B_s, steps, device=dev)
    state_bytes = sum(t.numel() * t.element_size() for c in state for t in c.values())
    mlstm_bytes = sum(t.numel() * t.element_size() for c, bt in zip(state, kinds) if bt == "mlstm"
                      for t in c.values())
    del state
    print(f"(c) greedy_generate batch {B_s}, prompt {prompt_len}, gen {gen_len}: {dec_s:.3f} s, "
          f"{B_s * gen_len / dec_s:.1f} generated tokens/s ({1e3 * dec_s / steps:.2f} ms/step)  launches {counts}; "
          f"recurrent state {state_bytes / 2**30:.4f} GiB (mLSTM {mlstm_bytes / 2**30:.4f} GiB)  [{card}]")
    if sum(counts.values()) != 0:
        raise AssertionError(f"xLSTM decode launched {counts}")
    if out.shape != (B_s, gen_len) or bool((out < 0).any() or (out >= cfg.vocab).any()):
        raise AssertionError(f"greedy_generate returned {tuple(out.shape)} or ids outside the vocab")
    print(f"row 0: {out[0].tolist()}")

    # (d) where the time goes
    busy = profiled(f"xLSTM prefill {B_s} x {T_s}", lambda: prefill(served, {"tokens": tokens}), top=12)
    print(f"xLSTM prefill device busy {busy:.3f} s of {prefill_s:.3f} s unprofiled "
          f"(idle share {1 - busy / prefill_s:.3f})")
    busy = profiled("xLSTM greedy_generate, prompt 4, gen 4 (8 steps)",
                    lambda: D.greedy_generate(served, cfg, prompt[:, :4], steps=4), top=12)
    print(f"xLSTM decode device busy {1e3 * busy / 8:.3f} ms per step of {1e3 * dec_s / steps:.3f} ms "
          f"unprofiled (idle share {1 - busy / 8 / (dec_s / steps):.3f})")
    print(f"xlstm-1.3b max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{card}]")
    del served
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one GPU.")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.stdout.reconfigure(line_buffering=True)  # each line reaches a log even if the run is cut

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2

    import asyncio

    import numpy as np

    from repro_torch import distributed_pca, quickstart, scenarios
    from repro_torch.core import (
        ElasticPolicy,
        LocalExecutor,
        PlacementOptimizer,
        ResilienceSession,
        bernoulli_assignment,
        clustering_cost,
        cyclic_assignment,
        device_recovery_masked,
        fixed_count_stragglers,
        lloyd,
        lp_recovery,
        make_assignment,
        make_scenario,
        resilient_kmedian,
    )
    from repro_torch.core import pca as pca_mod
    from repro_torch.core import subspace as sub_mod
    from repro_torch.data.synthetic import franti_s1_like, gaussian_mixture, planted_subspaces
    from repro_torch.kernels import _build, autotune, dispatch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.obs import Histogram
    from repro_torch.serve import AsyncFrontend
    from repro_torch.serve import decode as D
    from repro_torch.stream import StreamingSession
    from repro_torch.stream.query import QueryEngine, bucket_size
    from repro_torch.kernels.pairwise_dist import ops as pd_ops
    from repro_torch.kernels.pairwise_dist import ref as pd_ref
    from repro_torch.kernels.weighted_segsum import ops as ss_ops

    # The plain side runs in full fp32: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    errs: dict[str, float] = {
        "assign_min": 0.0, "weighted_segsum": 0.0, "flash_attention": 0.0, "pairwise_sqdist": 0.0}

    with phase("device"):
        kind = torch.cuda.get_device_name(0)
        print(f"device: {kind}  count={torch.cuda.device_count()}  torch={torch.__version__} "
              f"cuda={torch.version.cuda}")
        card = CARD["smi"] = smi()
        print(f"nvidia-smi: {card}")

    with phase("build"):
        t0 = time.perf_counter()
        for name, rep in _build.build().items():
            print(f"built {name}: {rep.library.name}  nvcc {rep.seconds:.1f} s")
            for line in rep.ptxas:
                print(f"  {line}")
        print(f"build seconds (parallel): {time.perf_counter() - t0:.3f}")

    # ------------------------------------------------------------- checks

    def check_assign(tag, x, c, k_valid=None):
        k = c.shape[-2]
        kv = k if k_valid is None else k_valid
        idx_k, dist_k = pd_ops.assign_min(x, c, k_valid=k_valid)
        idx_r, dist_r = pd_ops.assign_min(x, c, k_valid=k_valid, impl="torch_ref")
        sync()
        if idx_k.shape != idx_r.shape or dist_k.dtype != torch.float32:
            raise AssertionError(f"assign_min {tag}: shape or dtype differs from the plain version")
        scale = float(dist_r.max())
        err = (dist_k - dist_r).abs()
        bad = err > 1e-5 * dist_r.abs() + 1e-4 * scale
        if bool(bad.any()):
            raise AssertionError(f"assign_min {tag}: {int(bad.sum())} distances outside "
                                 f"rtol 1e-5 / atol 1e-4*max, max err {float(err.max()):.3e}")
        # idx must agree wherever the two nearest distances differ by more
        # than 1e-5 relative to |x|^2 + d^2, the magnitude whose rounding the
        # decomposition carries; rows closer than that are near ties (exact
        # duplicate centers among them).
        ties = 0
        if kv >= 2:
            d2 = pd_ref.pairwise_sqdist_ref(x, c)[..., :kv]
            top2 = torch.topk(d2, 2, dim=-1, largest=False).values
            del d2
            x2 = torch.sum(x.float() ** 2, dim=-1)
            decided = (top2[..., 1] - top2[..., 0]) > 1e-5 * (x2 + top2[..., 1])
            ties = int((~decided).sum())
            wrong = decided & (idx_k != idx_r)
            if bool(wrong.any()):
                raise AssertionError(f"assign_min {tag}: {int(wrong.sum())} rows pick "
                                     "another center than the plain version")
        if bool((idx_k < 0).any() or (idx_k >= max(kv, 1)).any()):
            raise AssertionError(f"assign_min {tag}: index outside [0, k_valid)")
        errs["assign_min"] = max(errs["assign_min"], float(err.max()))
        print(f"assign_min {tag}: x {tuple(x.shape)} c {tuple(c.shape)} k_valid={kv} "
              f"max_abs_err={float(err.max()):.3e} near_ties={ties}")
        return idx_k

    def check_segsum(tag, x, w, idx, k):
        s1, t1 = ss_ops.weighted_segsum(x, w, idx, k)
        s2, t2 = ss_ops.weighted_segsum(x, w, idx, k)
        sr, tr = ss_ops.weighted_segsum(x, w, idx, k, impl="torch_ref")
        sa, ta = ss_ops.weighted_segsum(x.abs(), w.abs(), idx, k, impl="torch_ref")
        sync()
        if not (torch.equal(s1, s2) and torch.equal(t1, t2)):
            raise AssertionError(f"weighted_segsum {tag}: two runs differ bitwise")
        es, et = (s1 - sr).abs(), (t1 - tr).abs()
        if bool((es > 1e-5 * sa).any() or (et > 1e-5 * ta).any()):
            raise AssertionError(
                f"weighted_segsum {tag}: error beyond 1e-5 of sum|w*x|: "
                f"sums {float((es / sa.clamp_min(1e-30)).max()):.3e} "
                f"totals {float((et / ta.clamp_min(1e-30)).max()):.3e}")
        err = max(float(es.max()), float(et.max()))
        rel = max(float((es / sa.clamp_min(1e-30)).max()), float((et / ta.clamp_min(1e-30)).max()))
        errs["weighted_segsum"] = max(errs["weighted_segsum"], err)
        print(f"weighted_segsum {tag}: x {tuple(x.shape)} k={k} max_abs_err={err:.3e} "
              f"max_err/sum|w*x|={rel:.2e} bitwise-reproducible")

    def check_flash(tag, B, Tq, S, H, KV, dh, dtype=torch.bfloat16, g=gen):
        """The kernel against the plain version on random inputs: rtol 2^-7,
        atol 1e-3 in bf16 (both round the output to bf16 after f32 sums in
        other orders); rtol 1e-5, atol 1e-5 in f32."""
        q = torch.randn((B, Tq, H, dh), generator=g, device=dev).to(dtype)
        k = torch.randn((B, S, KV, dh), generator=g, device=dev).to(dtype)
        v = torch.randn((B, S, KV, dh), generator=g, device=dev).to(dtype)
        got = fa_ops.flash_attention(q, k, v)
        want = fa_ops.flash_attention(q, k, v, impl="torch_ref")
        sync()
        rtol, atol = (2.0 ** -7, 1e-3) if dtype == torch.bfloat16 else (1e-5, 1e-5)
        if got.shape != want.shape or got.dtype != dtype:
            raise AssertionError(f"flash_attention {tag}: shape or dtype differs from the plain version")
        err = (got.float() - want.float()).abs()
        bad = err > atol + rtol * want.float().abs()
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {tag}: {int(bad.sum())} outputs outside rtol {rtol:.3g} / "
                                 f"atol {atol:g}, max err {float(err.max()):.3e}")
        errs["flash_attention"] = max(errs["flash_attention"], float(err.max()))
        print(f"flash_attention {tag}: (B,T,S,H,KV,dh)={(B, Tq, S, H, KV, dh)} {str(dtype)[6:]} "
              f"{fa_kernel.route(dtype, dh)} max_abs_err={float(err.max()):.3e}")

    def check_sqdist(tag, x, c):
        """The kernel against the plain version: |d| <= 1e-5 (|x_i|^2 + |c_j|^2)
        + 1e-6 per element, nothing negative, one launch per call (none for
        an empty output).  Returns the kernel's output."""
        before = dispatch.launch_counts()["pairwise_sqdist"]
        got = pd_ops.pairwise_sqdist(x, c)
        launched = dispatch.launch_counts()["pairwise_sqdist"] - before
        want = pd_ops.pairwise_sqdist(x, c, impl="torch_ref")
        sync()
        if launched != (1 if got.numel() else 0):
            raise AssertionError(f"pairwise_sqdist {tag}: {launched} launches for one call")
        if got.shape != want.shape or got.dtype != torch.float32:
            raise AssertionError(f"pairwise_sqdist {tag}: shape or dtype differs from the plain version")
        err = (got - want).abs()
        allowed = 1e-5 * (torch.sum(x * x, 1)[:, None] + torch.sum(c * c, 1)[None, :]) + 1e-6
        bad = int((err > allowed).sum()) + int((got < 0).sum())
        worst = float(err.max()) if err.numel() else 0.0
        if bad or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"pairwise_sqdist {tag}: {bad} outputs negative or outside "
                                 f"1e-5 (|x|^2 + |c|^2) + 1e-6, max err {worst:.3e}")
        errs["pairwise_sqdist"] = max(errs["pairwise_sqdist"], worst)
        rel = float((err / (allowed - 1e-6).clamp_min(1e-30)).max()) * 1e-5 if err.numel() else 0.0
        print(f"pairwise_sqdist {tag}: x {tuple(x.shape)} c {tuple(c.shape)} max_abs_err={worst:.3e} "
              f"max_err/(|x|^2+|c|^2)={rel:.2e}")
        return got

    def rows_of(x, k):
        """k random rows of each batch of x, as centers (B, k, d)."""
        pick = torch.randint(0, x.shape[1], (x.shape[0], k), generator=gen, device=dev)
        return torch.gather(x, 1, pick.unsqueeze(-1).expand(-1, -1, x.shape[2])).contiguous()

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    # -------------------------------------------------------------- prelude

    n_full, d_full, k_full, s, t = 1_000_000, 128, 256, 10, 3
    with phase("prelude"):
        t0 = time.perf_counter()
        pts, _, _ = gaussian_mixture(n_full, k_full, d_full, rng=np.random.default_rng(args.seed))
        a = bernoulli_assignment(n_full, s, ell=0.2 * s, rng=np.random.default_rng(args.seed + 1))
        alive = fixed_count_stragglers(s, t, np.random.default_rng(args.seed + 2))
        print(f"data + assignment (host): {time.perf_counter() - t0:.3f} s; "
              f"stragglers {sorted(np.flatnonzero(~alive).tolist())}")
        session = ResilienceSession(a)
        t0 = time.perf_counter()
        rec = session.recovery(alive)
        print(f"recovery solve (host, {rec.method}): {time.perf_counter() - t0:.3f} s  "
              f"delta={rec.delta:.3f} feasible={rec.feasible} uncovered={len(rec.uncovered)}")
        t0 = time.perf_counter()
        _, _, _, _, xs_np, _ = session.prepare(pts, alive)
        print(f"pack (host): {time.perf_counter() - t0:.3f} s  shards {xs_np.shape}")
        t0 = time.perf_counter()
        pts_d, xs_d, ws_d = session.device_shards(dev)
        sync()
        print(f"host-to-device copy: {time.perf_counter() - t0:.3f} s  "
              f"({(pts_d.numel() + xs_d.numel() + ws_d.numel()) * 4 / 1e9:.2f} GB)")

    with phase("kernels"):
        # Edges: d=2 with k=15 (no block multiple), odd d, duplicate centers,
        # masked columns, zero-weight rows, empty clusters, k over one tile.
        x = rand(3, 1000, 2)
        check_assign("edge d=2 k=15", x, rows_of(x, 15))
        x = rand(2, 777, 13) - 0.5
        check_assign("edge d=13 k=70", x, rows_of(x, 70))
        c = rows_of(x, 20).repeat_interleave(2, dim=1)
        idx = check_assign("edge duplicate centers", x, c.contiguous())
        if bool((idx % 2 != 0).any()):
            raise AssertionError("assign_min: a tie did not resolve to the earlier duplicate")
        c = torch.cat([rows_of(x, 13), torch.zeros(2, 7, 13, device=dev)], dim=1)
        check_assign("edge k_valid=13 of 20", x, c, k_valid=13)
        w = rand(2, 777) * (rand(2, 777) > 0.5)
        idx = torch.randint(-2, 40, (2, 777), generator=gen, device=dev, dtype=torch.int32)
        check_segsum("edge zero weights, empty clusters, idx outside [0,k)", x, w, idx, 50)
        x = rand(1, 5000, 5)
        idx = torch.randint(0, 1000, (1, 5000), generator=gen, device=dev, dtype=torch.int32)
        check_segsum("edge k=1000 d=5 (whole k in shared memory)", x, rand(1, 5000), idx, 1000)

        # Paper size: local shards (s, m, 2), coordinator (1, s*k, 2), full cost.
        p_pts, _, _ = franti_s1_like(5000)
        p_a = bernoulli_assignment(5000, s, ell=2.0, rng=np.random.default_rng(1))
        _, _, _, _, p_xs, p_ws = ResilienceSession(p_a).prepare(p_pts, alive)
        px = torch.from_numpy(p_xs).to(dev)
        idx = check_assign("paper local", px, rows_of(px, 15))
        check_segsum("paper local", px, torch.from_numpy(p_ws).to(dev) * rand(*p_ws.shape), idx, 15)
        py = rand(1, s * 15, 2)
        idx = check_assign("paper coordinator", py, rows_of(py, 15))
        check_segsum("paper coordinator", py, rand(1, s * 15), idx, 15)
        pp = torch.from_numpy(p_pts).to(dev)[None]
        check_assign("paper full cost", pp, rows_of(pp, 15))

        # Full width: local solves (10, m, 128), coordinator, full cost.
        idx = check_assign("full local", xs_d, rows_of(xs_d, k_full))
        check_segsum("full local", xs_d, ws_d * rand(*ws_d.shape), idx, k_full)
        fy = rows_of(xs_d, k_full).reshape(1, s * k_full, d_full)
        idx = check_assign("full coordinator", fy, rows_of(fy, k_full))
        check_segsum("full coordinator", fy, rand(1, s * k_full) * (rand(1, s * k_full) > 0.3), idx, k_full)
        check_assign("full cost", pts_d[None], rows_of(pts_d[None], k_full))
        del fy, idx

        # Flash attention: ragged T = S, T < S (the decode alignment), and
        # the prefill shape of the serve phase (bf16 at dh 64 and 128 takes
        # the tma-wgmma kernel, dh 16 and f32 the mma-sync one); f32 once.
        check_flash("ragged", 2, 100, 100, 8, 2, 64)
        check_flash("ragged T<S dh128", 2, 300, 337, 8, 2, 128)
        check_flash("T<S", 1, 16, 32, 4, 2, 16)
        check_flash("prefill", 4, 2048, 2048, 32, 8, 128)
        check_flash("ragged f32", 2, 100, 100, 8, 2, 64, dtype=torch.float32)
        # deepseek-moe-16b's prefill: group size 1 (H = KV = 16); inputs from
        # a generator of their own, so the draws of later phases stay as they were.
        check_flash("prefill moe H=KV=16", 4, 2048, 2048, 16, 16, 128,
                    g=torch.Generator(device=dev).manual_seed(args.seed))

        # pairwise_sqdist: ragged n and k, odd d, k = 1, k over one tile,
        # duplicate rows, n = 0; then the op's own path at full width, its
        # launch count read just around the call.
        x = rand(1000, 13) - 0.5
        check_sqdist("edge n=1000 k=15 d=13", x, x[:15].contiguous())
        check_sqdist("edge k=1", x, x[7:8].contiguous())
        check_sqdist("edge k=300 over tiles d=2", rand(777, 2), rand(300, 2))
        xd = x[:40].repeat_interleave(2, dim=0)
        check_sqdist("edge duplicate rows", xd, xd[:70].contiguous())
        check_sqdist("edge n=0", x[:0], x[:5].contiguous())
        sq_c = rows_of(pts_d[None], k_full)[0]
        dispatch.reset_launch_counts()
        sq_out = pd_ops.pairwise_sqdist(pts_d, sq_c)
        sync()
        sq_counts = dispatch.launch_counts()
        print(f"pairwise_sqdist at full width: launches {sq_counts}")
        if sq_counts["pairwise_sqdist"] != 1 or sum(sq_counts.values()) != 1:
            raise AssertionError(f"pairwise_sqdist path: expected one launch of its kernel, got {sq_counts}")
        if not torch.equal(check_sqdist("full x (1M, 128) c (256, 128)", pts_d, sq_c), sq_out):
            raise AssertionError("pairwise_sqdist: two calls on the same inputs differ")
        del sq_out

    with phase("paper size"):
        dispatch.reset_launch_counts()
        ratios = quickstart.run(dev)
        print(f"paper-size ratios: {json.dumps(ratios)}  launches {dispatch.launch_counts()}")
        if not all(np.isfinite(r) and r > 0 for r in ratios.values()):
            raise AssertionError(f"paper-size ratios not finite: {ratios}")
        # The same run through the kernels and through the plain versions.
        kw = dict(local_iters=15, coord_iters=30, device=dev)
        out_k = resilient_kmedian(p_pts, 15, p_a, alive, **kw)
        out_r = resilient_kmedian(p_pts, 15, p_a, alive, impl="torch_ref", **kw)
        rel = abs(out_k.cost - out_r.cost) / out_r.cost
        print(f"paper p_a=0.2 cost: kernels {out_k.cost:.4f}  plain {out_r.cost:.4f}  rel {rel:.2e}")
        if rel > 1e-3:
            raise AssertionError("paper-size run through the kernels disagrees with the plain path")
        rows3 = distributed_pca.run(dev)
        for row in rows3:
            if not (np.isfinite(row["cost"]) and row["factor"] <= row["bound"] * 1.05):
                raise AssertionError(f"paper-size Algorithm 3 outside the Theorem-5 band: {row}")

    @contextlib.contextmanager
    def launches_by_shape(op, tally):
        """While the block runs, count the CUDA launches of ``op`` by the
        shape of their first argument into ``tally``."""
        real = dispatch.resolve(op, "cuda", torch.empty(0, device=dev))[1]

        def counted(x, *rest):
            tally[tuple(x.shape)] = tally.get(tuple(x.shape), 0) + 1
            return real(x, *rest)

        dispatch.register_impl(op, "cuda", counted)
        try:
            yield tally
        finally:
            dispatch.register_impl(op, "cuda", real)

    def run_alg1():
        return resilient_kmedian(
            pts, k_full, a, alive, local_iters=15, coord_iters=30, seed=args.seed,
            session=session, device=dev,
        )

    with phase("full width"):
        torch.cuda.reset_peak_memory_stats()
        sync()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        central = lloyd(pts_d, k_full, iters=40, median=True,
                        generator=torch.Generator(device=dev).manual_seed(args.seed))
        central_cost = float(central.cost)
        central_counts = dispatch.launch_counts()
        dispatch.reset_launch_counts()
        t1 = time.perf_counter()
        with launches_by_shape("weighted_segsum", {}) as seg_shapes:
            out = run_alg1()
            sync()
        t2 = time.perf_counter()
        counts = dispatch.launch_counts()  # Algorithm 1's own launches
        t3 = time.perf_counter()
        session.prepare(pts, alive)  # what the run spent on the host before the device work
        host = time.perf_counter() - t3
        print(f"centralized lloyd (device): {t1 - t0:.3f} s  cost={central_cost:.2f}")
        print(f"Algorithm 1: {t2 - t1:.3f} s  cost={out.cost:.2f}; of which host prepare with "
              f"cached solve and pack (content fingerprint) {host:.3f} s, device {t2 - t1 - host:.3f} s")
        print(f"full-width cost ratio (Algorithm 1 / centralized): {out.cost / central_cost:.6f}  "
              f"feasible={out.recovery.feasible} uncovered={len(out.recovery.uncovered)} "
              f"(Bernoulli p_a=0.2: shards with no alive replica are dropped)")
        print(f"max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        print(f"launches: centralized {central_counts}  Algorithm 1 {counts}  "
              f"session {session.stats.as_dict()}")
        print(f"Algorithm 1 weighted_segsum launches by x shape: {seg_shapes}")
        for tag, got in (("centralized", central_counts), ("Algorithm 1", counts)):
            if not all(got.get(name, 0) > 0 for name in ("assign_min", "weighted_segsum")):
                raise AssertionError(f"{tag}: a kernel of the path was never launched: {got}")
        if out.centers.shape != (k_full, d_full) or not np.isfinite(out.centers).all():
            raise AssertionError("Algorithm 1 centers are not finite (k, d)")
        if not (np.isfinite(out.cost) and np.isfinite(central_cost) and out.cost > 0):
            raise AssertionError("full-width costs are not finite")
        # Lemma 3 on the summary: Σ_i b_i·|P_i| = Σ_j a_j exactly.
        mass, want = float(out.summary_weights.sum()), float(rec.a.sum())
        print(f"summary weight mass {mass:.1f} vs sum(a) {want:.1f}")
        if abs(mass - want) > 1e-4 * want:
            raise AssertionError("summary weights do not carry the recovery mass")

    with phase("profile"):
        profiled("Algorithm 1", run_alg1)

    class EventExecutor(LocalExecutor):
        """The local executor with CUDA events around each masked reduce:
        the device span of the solve and the combine (from the first
        launch to the last kernel's end), and the weights it used."""

        def __init__(self):
            self.spans, self.b = [], None

        def resilient_reduce_masked(self, *a, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = super().resilient_reduce_masked(*a, **kw)
            e1.record()
            self.spans.append((e0, e1))
            self.b = out[1]
            return out

    session_rounds: dict = {"estimates": []}  # (b)'s rounds, for the mesh phase

    def run_session():
        """The elastic resilience runtime at full width, then the scenario
        grid at the paper's size."""
        # (a) Algorithm 1 on a covered assignment: cyclic ell=4 keeps every
        # shard under any 3 stragglers.
        t0 = time.perf_counter()
        ex_ev = EventExecutor()
        sess = ResilienceSession(cyclic_assignment(n_full, s, 4), executor=ex_ev,
                                 elastic=ElasticPolicy(enabled=True, patience=2), device=dev)
        print(f"(a) cyclic_assignment({n_full}, {s}, 4): {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        rec_c = sess.recovery(alive)
        print(f"(a) recovery solve (host, {rec_c.method}): {time.perf_counter() - t0:.3f} s  "
              f"delta={rec_c.delta:.3f} feasible={rec_c.feasible} uncovered={len(rec_c.uncovered)}")
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        out_c = sess.kmedian(pts, k_full, alive, local_iters=15, coord_iters=30, seed=args.seed)
        sync()
        wall = time.perf_counter() - t0
        counts_a = dispatch.launch_counts()
        mass, want = float(out_c.summary_weights.sum()), float(rec_c.a.sum())
        print(f"(a) session.kmedian: {wall:.3f} s (with the pack of shards {sess._packed[0].shape}, "
              f"{sess._packed[0].nbytes / 1e9:.2f} GB, and its copy to the card)  cost={out_c.cost:.2f}  "
              f"ratio to the centralized run {out_c.cost / central_cost:.6f}  "
              f"feasible={out_c.recovery.feasible} uncovered={len(out_c.recovery.uncovered)}  "
              f"summary mass {mass:.1f} vs sum(a) {want:.1f}  launches {counts_a}  [{card}]")
        if not (out_c.recovery.feasible and len(out_c.recovery.uncovered) == 0):
            raise AssertionError("the cyclic ell=4 assignment left shards uncovered under 3 stragglers")
        if abs(mass - want) > 1e-4 * want:
            raise AssertionError("session.kmedian: summary weights do not carry the recovery mass")
        if not all(counts_a.get(name, 0) > 0 for name in ("assign_min", "weighted_segsum")):
            raise AssertionError(f"session.kmedian: a kernel of the path was never launched: {counts_a}")
        if not (np.isfinite(out_c.cost) and out_c.cost > 0 and np.isfinite(out_c.centers).all()):
            raise AssertionError("session.kmedian: cost or centers not finite")

        # (b) rounds of a straggler scenario through step_cost.
        centers_c = out_c.centers
        session_rounds["centers"] = centers_c
        true = float(clustering_cost(pts_d, torch.from_numpy(centers_c).to(dev), median=True))
        fp_log: list = []
        real_fp = ResilienceSession._fingerprint

        def timed_fp(points):
            t = time.perf_counter()
            out = real_fp(points)
            fp_log.append(time.perf_counter() - t)
            return out

        sess._fingerprint = timed_fp  # the content hash of every step_cost, timed
        scen = make_scenario("fixed", s, t=3, seed=args.seed + 3)
        before = sess.stats.as_dict()
        torch.cuda.reset_peak_memory_stats()
        splits = []
        for r in range(8):
            step = next(scen)
            fp_log.clear()
            copies = sess.stats.device_copies
            sync()
            dispatch.reset_launch_counts()
            t0 = time.perf_counter()
            ev = sess.observe(step)
            t_obs = time.perf_counter() - t0
            est = sess.step_cost(pts, centers_c, step.alive, median=True)
            wall = time.perf_counter() - t0
            session_rounds["estimates"].append(est)
            launches = dispatch.launch_counts()
            e0, e1 = ex_ev.spans[-1]
            dev_s, fp_s = e0.elapsed_time(e1) / 1e3, sum(fp_log)
            b = ex_ev.b.cpu().numpy().astype(np.float64)
            A = sess.assignment.matrix
            ach = b @ A
            cov = A[step.alive].sum(axis=0) > 0
            d_dev = float(ach[cov].max() - 1.0)
            in_band = true * (1 - 1e-4) <= est <= (1 + d_dev) * true * (1 + 1e-4)
            splits.append((wall, fp_s, wall - fp_s - dev_s, dev_s))
            print(f"(b) round {r}: stragglers {np.flatnonzero(~step.alive).tolist()} "
                  f"persistent {ev['persistent']} patched={ev['patched']} moved_nodes={len(ev['moved_nodes'])} "
                  f"uncovered={ev['uncovered']}  est={est:.2f} est/true={est / true:.6f} "
                  f"delta_dev={d_dev:.6f} in_band={in_band}  seconds {wall:.3f} = fingerprint {fp_s:.3f} "
                  f"+ host {wall - fp_s - dev_s:.3f} (observe {t_obs:.3f}) + device {dev_s:.3f}  "
                  f"assign_min launches {launches['assign_min']}  full copies "
                  f"{sess.stats.device_copies - copies}  [{card}]")
            if launches["assign_min"] < 1:
                raise AssertionError(f"round {r}: step_cost did not launch assign_min: {launches}")
            if cov.all() and not in_band:
                raise AssertionError(f"round {r}: estimate {est} outside the Lemma-3 band of {true} "
                                     f"(delta_dev {d_dev})")
        after = sess.stats.as_dict()
        solves = {k: after[k] - before[k] for k in ("host_solves", "device_solves")}
        mean = np.mean(np.asarray(splits), axis=0)
        print(f"(b) 8 rounds: true cost {true:.2f}; solves {solves}; session {after}; mean seconds per "
              f"round {mean[0]:.3f} = fingerprint {mean[1]:.3f} + host {mean[2]:.3f} + device {mean[3]:.3f}  "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{card}]")
        if solves != {"host_solves": 0, "device_solves": 8}:
            raise AssertionError(f"8 rounds gave {solves}, expected 0 host and 8 device solves")
        profiled("one step_cost round (fingerprint, solve, combine)",
                 lambda: sess.step_cost(pts, centers_c, step.alive, median=True), top=10)
        est_ref = sess.step_cost(pts, centers_c, step.alive, median=True, impl="torch_ref")
        rel = abs(est_ref - est) / abs(est)
        print(f"(b) the last round through the plain versions: {est_ref:.4f} vs {est:.4f}, rel {rel:.2e}")
        if rel > 1e-5:
            raise AssertionError("step_cost through the kernel disagrees with the plain path")
        del sess, ex_ev
        torch.cuda.empty_cache()

        # (c) the scenario grid at the paper's size (n=320, s=8, k=4).
        pp, _, _ = gaussian_mixture(320, 4, 3, rng=np.random.default_rng(args.seed))
        pp_d = torch.from_numpy(pp).to(dev)
        pc = lloyd(pp_d, 4, iters=5, median=True,
                   generator=torch.Generator(device=dev).manual_seed(args.seed)).centers.cpu().numpy()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        cells = scenarios.run(pp, pc, device=dev, seed=args.seed)
        grid_s = time.perf_counter() - t0
        counts_g = dispatch.launch_counts()
        n_rounds = sum(c is not None for cell in cells for c in cell["costs"])
        host = sum(cell["stats"]["host_solves"] for cell in cells)
        device = sum(cell["stats"]["device_solves"] for cell in cells)
        per_round = np.median([t for cell in cells for t in cell["seconds"]])
        print(f"(c) grid: {len(cells)} cells, {n_rounds} step_cost rounds in {grid_s:.3f} s (median round "
              f"{1e3 * per_round:.2f} ms); host solves {host}, device solves {device}; "
              f"patches {sum(c['stats']['elastic_patches'] for c in cells)}; launches {counts_g}  [{card}]")
        if host != 0 or device != n_rounds or counts_g["assign_min"] != n_rounds:
            raise AssertionError("the grid's step_cost rounds did not each solve on the card and launch "
                                 "assign_min once")
        for cell in cells:
            a_g, al = cell["assignment"], cell["alive"][0]
            b = device_recovery_masked(a_g.matrix.astype(np.float32), al, device=dev).cpu().numpy()
            lp = lp_recovery(a_g, al)
            ach = b.astype(np.float64) @ a_g.matrix
            cov = a_g.matrix[al].sum(axis=0) > 0
            ok = bool((b[~al] == 0).all() and np.isfinite(b).all() and ach[cov].min() >= 1 - 1e-3
                      and (ach[~cov] == 0).all())
            if lp.feasible:
                ok = ok and ach[cov].max() <= 4.0 * (1.0 + lp.delta)
            print(f"(c) {cell['scheme']:>9s} x {cell['scenario']:<11s} first pattern: device a in "
                  f"[{ach[cov].min():.6f}, {ach[cov].max():.4f}], LP delta {lp.delta:.4f} "
                  f"feasible={lp.feasible} uncovered={len(lp.uncovered)}  band {'ok' if ok else 'FAILED'}")
            if not ok:
                raise AssertionError(f"device recovery outside the LP band: {cell['scheme']} x {cell['scenario']}")
        true_p = float(clustering_cost(pp_d, torch.from_numpy(pc).to(dev), median=True))
        sess_h = ResilienceSession(make_assignment("health", 320, 8, ell=2),
                                   placement=PlacementOptimizer(ell=2), device=dev)
        flaky = np.ones(8, dtype=bool)
        flaky[5] = False
        for _ in range(6):
            sess_h.observe(flaky)
        ests = {"before": (sess_h.step_cost(pp, pc, flaky, median=True), sess_h.pattern_covers(flaky))}
        res = sess_h.permanent_loss(0)
        row0 = int(sess_h.assignment.matrix[0].sum())
        live = sess_h.alive_mask()
        ests["after loss"] = (sess_h.step_cost(pp, pc, live, median=True), sess_h.pattern_covers(live))
        sess_h.permanent_join(0)
        live = sess_h.alive_mask()
        ests["after join"] = (sess_h.step_cost(pp, pc, live, median=True), sess_h.pattern_covers(live))
        print(f"(c) placement session: loss of node 0 feasible={res.feasible} (its row holds {row0}), "
              f"after the join it holds {int(sess_h.assignment.matrix[0].sum())}; estimates "
              f"{ {k: (round(v, 4), c) for k, (v, c) in ests.items()} } (estimate, covered) vs true "
              f"{true_p:.4f}; "
              f"health {np.round(sess_h.node_health(), 3).tolist()}; session {sess_h.stats.as_dict()}")
        if not (res.feasible and row0 == 0 and sess_h.stats.placement_reoptimizes == 2
                and sess_h.assignment.matrix[0].sum() > 0 and sess_h.stats.host_solves > 0):
            raise AssertionError("permanent loss / join on the placement session went wrong")
        if not all(np.isfinite(v) and (v >= true_p * (1 - 1e-4) or not c) for v, c in ests.values()):
            raise AssertionError(f"placement session: a covered round's estimate is below the true cost: {ests}")

    with phase("session full width"):
        run_session()

    def run_mesh():
        """The mesh executor at full width: (a) a world of one over NCCL in
        this process; (b)-(d) two ranks over gloo on this card, spawned."""
        import torch.distributed as dist

        from repro_torch.launch import distributed as mesh_dist
        from repro_torch.launch import mesh_runs

        # (a) Algorithm 1 on the full-width cell through a world of one.
        ex1 = mesh_dist.MeshExecutor(mesh_dist.node_mesh(backend="nccl", device=dev))
        try:
            t0 = time.perf_counter()
            sess1 = ResilienceSession(a, executor=ex1, device=dev)
            sess1.prepare(pts, alive)
            _, xs1, ws1 = sess1.device_shards(dev)
            sync()
            host = time.perf_counter() - t0
            bytes1 = (xs1.local.numel() + ws1.local.numel()) * 4
            dispatch.reset_launch_counts()
            t0 = time.perf_counter()
            out1 = resilient_kmedian(pts, k_full, a, alive, local_iters=15, coord_iters=30, seed=args.seed,
                                     session=sess1, device=dev)
            sync()
            run1 = time.perf_counter() - t0
            counts1 = dispatch.launch_counts()
        finally:
            dist.destroy_process_group()
        rel1 = abs(out1.cost - out.cost) / out.cost
        bit1 = out1.cost == out.cost and np.array_equal(out1.centers, out.centers)
        print(f"(a) {ex1.describe()}: host prelude {host:.3f} s (LP, pack, copy of {bytes1 / 1e9:.3f} GB), "
              f"Algorithm 1 {run1:.3f} s  cost {out1.cost:.4f} vs local {out.cost:.4f}: rel {rel1:.2e}, "
              f"bit for bit {bit1}; launches {counts1}  [{card}]")
        if rel1 > 1e-5:
            raise AssertionError("the world of one over NCCL departs from the local executor by more than 1e-5")
        if not all(counts1.get(name, 0) > 0 for name in ("assign_min", "weighted_segsum")):
            raise AssertionError(f"(a): a kernel of the path was never launched: {counts1}")
        del sess1, xs1, ws1
        torch.cuda.empty_cache()

        # The local twin of (d): a session fed the same 16 batches.
        rows, n_batch = n_full // 64, 16
        loc = StreamingSession(d_full, k_full, num_nodes=8, scheme="fractional_repetition", ell=2, fanout=4,
                               leaf_size=16384, seed=args.seed, device=dev,
                               scenario=make_scenario("iid", 8, p_straggler=0.15, seed=args.seed + 5))
        for i in range(n_batch):
            loc.ingest(pts[i * rows: (i + 1) * rows])
        xl, wl = (v.cpu().numpy() for v in loc.frontier())
        levels_l = [len(lv) for lv in loc.buffer.levels]
        del loc

        # (b)-(d): two ranks over gloo, both on this card.
        t0 = time.perf_counter()
        rep = mesh_dist.run_ranks(mesh_runs.full_width_rank, 2, backend="gloo", device="cuda", timeout=600,
                                  args=(args.seed, session_rounds["centers"], 8, n_batch))
        print(f"{rep['describe']}: {time.perf_counter() - t0:.3f} s with the ranks' start; data (host) "
              f"{[round(v, 3) for v in rep['data_s']]} s per rank  [{card}]")

        alg = rep["alg1"]
        rel = abs(alg["cost"] / out.cost - 1.0)
        print(f"(b) Algorithm 1: cost {alg['cost']:.4f} vs local {out.cost:.4f}: rel {rel:.2e}, bit for bit "
              f"{alg['cost'] == out.cost}; ranks identical (b, packed shards, centers, cost) {alg['lockstep']}")
        for r, st in enumerate(alg["ranks"]):
            print(f"(b) rank {r}: nodes {st['block']}, shards {st['shard_bytes'] / 1e9:.3f} GB of (a)'s "
                  f"{bytes1 / 1e9:.3f}, peak {st['peak_gib']:.3f} GiB; host prelude {st['prelude_s']:.3f} s, "
                  f"Algorithm 1 {st['run_s']:.3f} s = local solves {st['local_s']:.3f} + collectives "
                  f"{st['collectives_s']:.3f} + the rest {st['rest_s']:.3f} (host prepare with its fingerprint, "
                  f"coordinator, cost); launches "
                  f"{st['launches']}  [{card}]")
        if rel > 1e-5 or not alg["lockstep"]:
            raise AssertionError("(b): the mesh departs from the local run, or its ranks differ")
        for st in alg["ranks"]:
            if not all(st["launches"].get(name, 0) > 0 for name in ("assign_min", "weighted_segsum")):
                raise AssertionError(f"(b): a rank never launched a kernel of the path: {st['launches']}")

        ses = rep["session"]
        want = session_rounds["estimates"]
        worst = max(abs(e / w - 1.0) for e, w in zip(ses["estimates"], want))
        written = [st["rows_written"] for st in ses["ranks"]]
        print(f"(c) {len(ses['estimates'])} rounds of observe + step_cost: max rel vs the local session's rounds "
              f"{worst:.2e}; solves {ses['stats']['host_solves']} host, {ses['stats']['device_solves']} device; "
              f"patches {ses['stats']['elastic_patches']}, moved_node_blocks {ses['stats']['moved_node_blocks']}, "
              f"rows written per rank {written}; ranks identical {ses['lockstep']}")
        for r, st in enumerate(ses["ranks"]):
            print(f"(c) rank {r}: nodes {st['block']}, {st['seconds']:.3f} s (with the pack), rounds "
                  f"{[round(v, 3) for v in st['round_s']]} s, peak {st['peak_gib']:.3f} GiB, launches "
                  f"{st['launches']}  [{card}]")
        if len(want) != len(ses["estimates"]) or worst > 1e-5 or not ses["lockstep"]:
            raise AssertionError("(c): the mesh session departs from the local one by more than 1e-5")
        if ses["stats"]["host_solves"] != 0 or ses["stats"]["device_solves"] != len(want):
            raise AssertionError(f"(c): expected 0 host solves, got {ses['stats']}")
        if sum(written) != 2 * ses["stats"]["moved_node_blocks"]:
            raise AssertionError("(c): the ranks wrote other rows than the moved nodes of their own blocks")
        if not all(st["launches"].get("assign_min", 0) >= len(want) for st in ses["ranks"]):
            raise AssertionError("(c): a rank's step_cost did not launch assign_min")

        stm = rep["stream"]
        xm, wm = stm["frontier"]
        gap = max(float(np.abs(xm - xl).max()), float(np.abs(wm - wl).max())) if xm.shape == xl.shape else np.inf
        print(f"(d) {n_batch} ingests of {rows} rows: frontier {xm.shape}, levels {stm['levels']} (local "
              f"{levels_l}); both ranks bit for bit {stm['lockstep']}; vs the local session max |diff| "
              f"{gap:.3e}, bit for bit {bool(np.array_equal(xm, xl) and np.array_equal(wm, wl))}")
        for r, st in enumerate(stm["ranks"]):
            print(f"(d) rank {r}: ingest {st['ingest_s']:.3f} s, peak {st['peak_gib']:.3f} GiB, host solves "
                  f"{st['host_solves']}, launches {st['launches']}  [{card}]")
        if not stm["lockstep"] or gap > 1e-5 or stm["levels"] != levels_l:
            raise AssertionError("(d): the ranks' trees differ, or depart from the local tree by more than 1e-5")
        for st in stm["ranks"]:
            if not all(st["launches"].get(name, 0) > 0 for name in ("assign_min", "weighted_segsum")):
                raise AssertionError(f"(d): a rank never launched a kernel of the path: {st['launches']}")

    with phase("mesh full width"):
        run_mesh()

    def run_stream():
        """The streaming service at the shape of SIFT1M: (a) ingest of the
        1M points into the coreset tree, (b) the FR tree under stragglers
        against an all-alive one, (c) the frontier solve, (d) the query
        engine, (e) the micro-batching frontend over two tenants."""
        reports = []
        real_warmup = autotune.warmup

        def recorded_warmup(plan):  # every warm-up pass of the phase, kept
            rep = real_warmup(plan)
            reports.append(rep)
            return rep

        autotune.warmup = recorded_warmup
        try:
            _run_stream(reports)
        finally:
            autotune.warmup = real_warmup
        errors = sum(r.errors for r in reports)
        print(f"warm-up passes {len(reports)}: warmed {sum(r.warmed for r in reports)}, errors {errors}, "
              f"{sum(r.seconds for r in reports):.3f} s in all")
        if errors:
            raise AssertionError(f"{errors} warm-up entries failed: a kernel did not build or launch")

    stream_launches: dict = {}

    def _run_stream(reports):
        n_batch, rows = 64, n_full // 64
        leaf, fanout, nodes = 16384, 4, 8

        def session(seed=args.seed, scenario=None):
            return StreamingSession(d_full, k_full, num_nodes=nodes, scheme="fractional_repetition",
                                    ell=2, fanout=fanout, leaf_size=leaf, scenario=scenario,
                                    seed=seed, device=dev)

        # The kernels at every shape this phase sends them: a compaction's
        # bicriteria solve (16384 rows, 2k = 512 centers) and its sums, the
        # frontier solve (32768 rows, k = 256), the query and frontend buckets.
        xl = pts_d[:leaf][None]
        idx = check_assign("stream compaction", xl, rows_of(xl, 2 * k_full))
        check_segsum("stream compaction", xl, rand(1, leaf), idx, 2 * k_full)
        xs2 = torch.cat([pts_d[:29248], torch.zeros(32768 - 29248, d_full, device=dev)])[None]
        idx = check_assign("stream solve", xs2, rows_of(xs2[:, :29248], k_full))
        check_segsum("stream solve", xs2, rand(1, 32768) * (torch.arange(32768, device=dev) < 29248), idx,
                     k_full)
        for b in (64, 128, 256, 512, 1024, 4096):
            xq = pts_d[b: 2 * b][None]
            check_assign(f"stream query bucket {b}", xq, rows_of(pts_d[None], k_full))
        del xl, xs2, xq, idx

        # (a) ingest: iid stragglers (p = 0.15) over 8 nodes, FR ell=2.
        sess = session(scenario=make_scenario("iid", nodes, p_straggler=0.15, seed=args.seed + 5))
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launch_counts()
        ingest_s, front16 = [], None
        for i in range(n_batch):
            batch = pts[i * rows: (i + 1) * rows]
            sync()
            t0 = time.perf_counter()
            sess.ingest(batch)
            sync()
            ingest_s.append(time.perf_counter() - t0)
            if i == 15:
                front16 = tuple(t.clone() for t in sess.frontier())
        counts_i = dispatch.launch_counts()
        stream_launches.update({f"{k}_per_ingest": v / n_batch for k, v in counts_i.items()})
        st = sess.stats
        levels = [len(lv) for lv in sess.buffer.levels]
        total = sum(ingest_s)
        print(f"(a) ingest {n_batch} x {rows} rows: {total:.3f} s, {n_full / total:.0f} rows/s; ingest ms "
              f"median {1e3 * np.median(ingest_s):.3f} max {1e3 * max(ingest_s):.3f}  [{card}]")
        print(f"(a) leaf compactions {st['leaf_compactions']}, level compactions {st['compactions']}, "
              f"buckets by level {levels}, summary points {st['summary_points']}, pending "
              f"{sess.buffer._pending_n}; blocking {st['blocking_compactions']}, host solves "
              f"{st['recovery_host_solves']}, cache hits {st['recovery_cache_hits']}, elastic patches "
              f"{st['recovery_elastic_patches']}, uncovered rounds {st['recovery_uncovered_rounds']}")
        print(f"(a) launches {counts_i} ({counts_i['assign_min'] / n_batch:.1f} assign_min and "
              f"{counts_i['weighted_segsum'] / n_batch:.1f} weighted_segsum per ingest); "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        want = (61, 18, [1, 3, 3], 28672, 576)
        got = (st["leaf_compactions"], st["compactions"], levels, st["summary_points"], sess.buffer._pending_n)
        if got != want:
            raise AssertionError(f"stream tree {got}, expected {want}")
        if not all(counts_i.get(name, 0) > 0 for name in ("assign_min", "weighted_segsum")):
            raise AssertionError(f"stream ingest: a kernel of the path was never launched: {counts_i}")

        # (b) the same 16 batches with every node alive.
        clean = session()
        for i in range(16):
            clean.ingest(pts[i * rows: (i + 1) * rows], alive=np.ones(nodes, dtype=bool))
        xc, wc = clean.frontier()
        xa, wa = front16
        if xc.shape != xa.shape:
            raise AssertionError(f"all-alive frontier {tuple(xc.shape)}, under stragglers {tuple(xa.shape)}")
        gap = max(float((xc - xa).abs().max()), float((wc - wa).abs().max()))
        bitwise = bool(torch.equal(xc, xa) and torch.equal(wc, wa))
        print(f"(b) all-alive tree after 16 batches vs (a)'s: {tuple(xc.shape)} rows, max |diff| {gap:.3e}, "
              f"bit for bit {bitwise}; (a)'s elastic patches by then are in its stats above")
        if gap > 1e-5:
            raise AssertionError("the FR tree under stragglers departs from the all-alive tree")
        # Where an ingest's time goes: the 17th batch again (its leaf
        # compaction cascades into two level compactions, as in (a)).
        busy = profiled("the 17th ingest on the all-alive session (3 reductions)",
                        lambda: clean.ingest(pts[16 * rows: 17 * rows], alive=np.ones(nodes, dtype=bool)), top=8)
        print(f"(b) that ingest's device busy {1e3 * busy:.1f} ms of its unprofiled {1e3 * ingest_s[16]:.1f} ms "
              f"in (a) (idle share {1 - busy / ingest_s[16]:.3f})")
        del clean, xc, wc, xa, wa, front16

        # (c) the frontier solve, padded to 32768 rows.
        dispatch.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        sol = sess.solve(iters=20)
        sync()
        solve_s = time.perf_counter() - t0
        counts_s = dispatch.launch_counts()
        xf, wf = sess.frontier()
        full_cost = float(clustering_cost(pts_d, sol.centers, median=True))
        front_cost = float(clustering_cost(xf, sol.centers, weights=wf, median=True))
        band = abs(front_cost - full_cost) / full_cost
        print(f"(c) solve(iters=20) over {sol.frontier_size} frontier rows (padded to "
              f"{bucket_size(sol.frontier_size)}): {solve_s:.3f} s (with the query warm-up)  cost {sol.cost:.2f}  "
              f"launches {counts_s}  [{card}]")
        print(f"(c) stream model on the 1M points: {full_cost:.2f}; centralized lloyd {central_cost:.2f}; "
              f"ratio {full_cost / central_cost:.6f}; frontier cost {front_cost:.2f}, |frontier - full| / full "
              f"{band:.4f} (band 0.35)")
        if sol.centers.shape != (k_full, d_full) or not bool(torch.isfinite(sol.centers).all()):
            raise AssertionError("stream centers are not finite (k, d)")
        if band > 0.35:
            raise AssertionError("the frontier's cost of the stream centers is outside the 0.35 band")
        del xf, wf

        # (d) the query engine after a warm-up: the first query, then the
        # answers against the plain version, then the steady state.
        rng = np.random.default_rng(args.seed + 6)

        def queries(n):
            pick = rng.integers(0, n_full, size=n)
            return (pts[pick] + rng.normal(scale=0.01, size=(n, d_full))).astype(np.float32)

        engine = sess.query_engine
        rep = engine.warmup(sess.centers, sess.version)
        print(f"(d) warm-up: {rep.warmed} buckets {rep.labels}, errors {rep.errors}, {rep.seconds:.3f} s")
        if rep.errors or not rep.warmed:
            raise AssertionError("the query engine's warm-up failed")
        q256 = queries(256)
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        sess.query(q256)
        first = time.perf_counter() - t0
        if dispatch.launch_counts()["assign_min"] != 1:
            raise AssertionError("the first query after the warm-up did not launch assign_min")
        plain = QueryEngine(impl="torch_ref", device=dev)
        c_np = sess.centers.cpu().numpy().astype(np.float64)

        for n in (1, 63, 64, 1000, 4096):
            q = queries(n)
            dispatch.reset_launch_counts()
            got = sess.query(q)
            launched = dispatch.launch_counts()["assign_min"]
            want = plain.assign(q, sess.centers, version=sess.version)
            exact = np.sqrt(((q.astype(np.float64)[:, None] - c_np[None]) ** 2).sum(-1))
            d2k, d2r = got.distances.astype(np.float64) ** 2, want.distances.astype(np.float64) ** 2
            top2 = np.sort(exact ** 2, axis=1)[:, :2]
            decided = (top2[:, 1] - top2[:, 0]) > 1e-5 * ((q.astype(np.float64) ** 2).sum(1) + top2[:, 1])
            wrong = int((decided & (got.indices != want.indices)).sum())
            band_bad = int((np.abs(d2k - d2r) > 1e-5 * d2r + 1e-4 * d2r.max()).sum())
            own = exact[np.arange(n), got.indices]
            rel = float(np.max(np.abs(got.distances - own) / own))
            print(f"(d) query {n} rows: launches {launched}; idx differs from the plain version on {wrong} "
                  f"decided rows ({int((~decided).sum())} near ties); d^2 outside the kernel band {band_bad}; "
                  f"distance vs float64 max rel {rel:.2e}")
            if launched != 1 or wrong or band_bad or rel > 1e-5:
                raise AssertionError(f"query engine at {n} rows: wrong answer or not one assign_min launch")
        lat = []
        for _ in range(200):
            q = queries(256)
            t0 = time.perf_counter()
            sess.query(q)
            lat.append(time.perf_counter() - t0)
        lat = np.sort(lat)
        print(f"(d) 256-row queries: first after the warm-up {1e3 * first:.3f} ms; steady over 200 calls p50 "
              f"{1e3 * lat[100]:.3f} ms p99 {1e3 * lat[197]:.3f} ms  [{card}]")
        qs50 = [queries(256) for _ in range(50)]
        busy = profiled("50 queries of 256 rows", lambda: [sess.query(q) for q in qs50], top=6)
        print(f"(d) query device busy {1e6 * busy / 50:.1f} us per call of the unprofiled p50 "
              f"{1e3 * lat[100]:.3f} ms (idle share {1 - busy / 50 / lat[100]:.3f})")

        # (e) the frontend: two tenants, an open-loop burst.
        other, _, _ = gaussian_mixture(4 * 65536, k_full, d_full, rng=np.random.default_rng(args.seed + 7))
        sess_b = session(seed=args.seed + 1)
        for i in range(4):
            sess_b.ingest(other[i * 65536: (i + 1) * 65536])
        sess_b.solve(iters=20)
        af = AsyncFrontend(window=0.002, max_batch=256, cache_size=1024)
        af.core.add_tenant("a", sess)
        af.core.add_tenant("b", sess_b)
        rep = af.core.warmup()
        if rep.errors:
            raise AssertionError("the frontend's warm-up failed")
        tenants = ("a", "b")

        async def burst(qs):
            async def one(i, q):
                t0 = time.perf_counter()
                res = await af.query(tenants[i % 2], q)
                return res, time.perf_counter() - t0

            return await asyncio.gather(*[one(i, q) for i, q in enumerate(qs)])

        pool = [queries(int(m)) for m in rng.integers(1, 17, size=32)]
        asyncio.run(burst([q for q in pool for _ in tenants]))  # each answered once on each tenant
        # The burst: 30% of its queries repeat one of the pool (bench_serve's REPEAT_FRACTION).
        qs = [pool[int(rng.integers(len(pool)))] if rng.random() < 0.3 else queries(int(rng.integers(1, 17)))
              for _ in range(4096)]
        core = af.core
        d0, h0, m0, o0 = core.dispatches, core.cache.hits, core.cache.misses, core._c_occupancy.value
        sc0, wc0 = core.batcher.size_closes, core.batcher.window_closes
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        out = asyncio.run(burst(qs))
        wall = time.perf_counter() - t0
        launched = dispatch.launch_counts()["assign_min"]
        dispatches = core.dispatches - d0
        hits, misses = core.cache.hits - h0, core.cache.misses - m0
        hist = Histogram()
        hist.observe_many([t * 1e6 for _, t in out])
        snap = hist.snapshot()
        n_rows = sum(q.shape[0] for q in qs)
        print(f"(e) burst of {len(qs)} queries ({n_rows} rows, 30% repeats) over 2 tenants: {wall:.3f} s, "
              f"{n_rows / wall:.0f} rows/s; latency p50 {snap.percentile(0.50) / 1e3:.3f} ms p99 "
              f"{snap.percentile(0.99) / 1e3:.3f} ms p999 {snap.percentile(0.999) / 1e3:.3f} ms; dispatches "
              f"{dispatches}, mean occupancy {(core._c_occupancy.value - o0) / max(dispatches, 1):.3f}; cache "
              f"hit rate {hits / max(hits + misses, 1):.3f}; assign_min launches {launched}; closes "
              f"{core.batcher.size_closes - sc0} by size, {core.batcher.window_closes - wc0} by window  [{card}]")
        if launched != dispatches or dispatches == 0:
            raise AssertionError(f"{launched} assign_min launches for {dispatches} dispatches")
        by = {"a": sess, "b": sess_b}
        for i, (q, (res, _)) in enumerate(zip(qs, out)):
            want = by[tenants[i % 2]].query(q)
            if not (np.array_equal(res.indices, want.indices) and np.array_equal(res.distances, want.distances)
                    and res.version == want.version):
                raise AssertionError(f"frontend answer {i} differs from the query engine's")
        print(f"(e) all {len(qs)} answers bit for bit the query engine's (same rows, centers, version)")
        del sess, sess_b, af, other
        torch.cuda.empty_cache()

    with phase("stream full width"):
        run_stream()

    def step_seconds(log, wall):
        total = sum(t for _, t in log)
        for name, t in log:
            print(f"  {name}: {t:.3f} s")
        print(f"  rest of the call (host work and copies between the steps): {wall - total:.3f} s")

    def run_alg3():
        """Algorithm 3 at full width, the regime of test_algorithm3_pca_theorem5_band."""
        r3, delta3 = 8, 0.25
        t0 = time.perf_counter()
        X3, _ = planted_subspaces(n_full, 1, d_full, r3, noise=0.05, rng=np.random.default_rng(args.seed + 3))
        X3 -= X3.mean(0, keepdims=True)
        a3 = bernoulli_assignment(n_full, s, ell=8.0, rng=np.random.default_rng(args.seed + 4))
        print(f"data + assignment (host): {time.perf_counter() - t0:.3f} s")
        session3 = ResilienceSession(a3)
        t0 = time.perf_counter()
        rec3 = session3.recovery(alive)
        print(f"host prelude: recovery solve ({rec3.method}) {time.perf_counter() - t0:.3f} s  "
              f"delta={rec3.delta:.3f} feasible={rec3.feasible} uncovered={len(rec3.uncovered)}")
        t0 = time.perf_counter()
        _, _, _, _, xs3, _ = session3.prepare(X3, alive)
        print(f"host prelude: pack {time.perf_counter() - t0:.3f} s  shards {xs3.shape} "
              f"({xs3.nbytes / 1e9:.2f} GB)")
        t0 = time.perf_counter()
        x3_d, _, _ = session3.device_shards(dev)
        sync()
        print(f"host prelude: host-to-device copy {time.perf_counter() - t0:.3f} s")
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launch_counts()
        steps: list = []
        with timed_steps(pca_mod, ("local_relaxed_coresets", "centralized_pca", "pca_cost"), sync, steps):
            t0 = time.perf_counter()
            out3 = pca_mod.resilient_pca(X3, r3, delta3, a3, alive, session=session3, device=dev)
            sync()
            wall = time.perf_counter() - t0
        print(f"resilient_pca: {wall:.3f} s (sketch SVDs = local_relaxed_coresets, coordinator SVD = "
              f"centralized_pca of the {out3.sketch_rows} sketch rows, full-data cost = pca_cost)  "
              f"launches {dispatch.launch_counts()}  [{card}]")
        step_seconds(steps, wall)
        peak = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        opt_basis = pca_mod.centralized_pca(x3_d, r3)
        sync()
        central_s = time.perf_counter() - t0
        opt = float(pca_mod.pca_cost(x3_d, opt_basis))
        band = 1.0 + 4.0 * max(delta3, rec3.delta)
        ratio = out3.cost / opt
        print(f"centralized_pca on {n_full} rows: {central_s:.3f} s  OPT={opt:.2f}")
        print(f"Algorithm 3 cost {out3.cost:.2f}, r1={out3.r1}; ratio to OPT {ratio:.6f} against the "
              f"Theorem-5 band {band:.3f} (x 1.05 = {band * 1.05:.3f})")
        print(f"max_memory_allocated (shards resident): {peak:.3f} GiB")
        if out3.basis.shape != (d_full, r3) or not np.isfinite(out3.basis).all():
            raise AssertionError("Algorithm 3 basis is not a finite (d, r) matrix")
        if not (np.isfinite(out3.cost) and out3.cost > 0 and ratio <= band * 1.05):
            raise AssertionError(f"Algorithm 3 outside the Theorem-5 band: ratio {ratio}, band {band}")
        return a3

    def run_alg2(a2):
        """Algorithm 2 at full width, the regime of test_algorithm2_subspace_clustering_quality."""
        k2, r2 = 16, 8
        t0 = time.perf_counter()
        X2, _ = planted_subspaces(n_full, k2, d_full, r2, noise=0.05, rng=np.random.default_rng(args.seed + 5))
        print(f"data (host): {time.perf_counter() - t0:.3f} s; the assignment and stragglers of alg3")
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launch_counts()
        steps: list = []
        with timed_steps(sub_mod, ("solve_recovery", "pack_local_shards", "sensitivity_coreset",
                                   "weighted_union", "lloyd_subspace", "subspace_cost"), sync, steps):
            t0 = time.perf_counter()
            out2 = sub_mod.resilient_subspace_clustering(
                X2, r2, k2, a2, alive, coreset_size=4096, seed=args.seed, device=dev)
            sync()
            wall = time.perf_counter() - t0
        counts2 = dispatch.launch_counts()
        print(f"resilient_subspace_clustering: {wall:.3f} s (host prelude = solve_recovery + "
              f"pack_local_shards; coreset = sensitivity_coreset; coordinator = lloyd_subspace on "
              f"{len(out2.coreset_weights)} rows; full cost = subspace_cost)  launches {counts2}  [{card}]")
        step_seconds(steps, wall)
        print(f"max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if not all(counts2.get(name, 0) > 0 for name in ("assign_min", "weighted_segsum")):
            raise AssertionError(f"Algorithm 2: a kernel of the path was never launched: {counts2}")
        x2_d = torch.from_numpy(X2).to(dev)
        est = float(sub_mod.subspace_cost(
            torch.from_numpy(out2.coreset_points).to(dev), torch.from_numpy(out2.bases).to(dev),
            torch.from_numpy(out2.means).to(dev),
            weights=torch.as_tensor(out2.coreset_weights, dtype=torch.float32, device=dev)))
        print(f"coreset estimate of the returned solution's cost {est:.2f} vs its full cost "
              f"{out2.cost:.2f}: relative error {abs(est - out2.cost) / out2.cost:.4f} (0.35 is the "
              f"band of the single-coreset test; Lemma 3 allows the union up to 1 + delta over)")
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        central2 = sub_mod.lloyd_subspace(x2_d, k2, r2, generator=torch.Generator(device=dev).manual_seed(args.seed))
        central_cost = float(central2.cost)
        print(f"centralized lloyd_subspace on {n_full} rows: {time.perf_counter() - t0:.3f} s  "
              f"cost={central_cost:.2f}  launches {dispatch.launch_counts()}  "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        band = max(5.0 * central_cost, central_cost + 2.0)
        print(f"Algorithm 2 cost {out2.cost:.2f}; ratio to the centralized run {out2.cost / central_cost:.6f}; "
              f"band max(5 central, central + 2) = {band:.2f}")
        if out2.bases.shape != (k2, d_full, r2) or not np.isfinite(out2.bases).all():
            raise AssertionError("Algorithm 2 bases are not finite (k, d, r)")
        if not (np.isfinite(out2.cost) and np.isfinite(central_cost) and out2.cost <= band):
            raise AssertionError(f"Algorithm 2 outside the band: cost {out2.cost}, band {band}")

    with phase("alg3 full width"):
        a_sub = run_alg3()
        torch.cuda.empty_cache()

    with phase("alg2 full width"):
        run_alg2(a_sub)
        del a_sub
        torch.cuda.empty_cache()

    with phase("serve"):
        cfg = get_config("qwen3-4b")
        B_s, T_s, prompt_len, gen_len = 4, 2048, 16, 32
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(args.seed))
        sync()
        t1 = time.perf_counter()
        served = T.cast_params(model, cfg)  # the bf16 weights, made once
        sync()
        print(f"qwen3-4b: {T.param_count(model) / 1e9:.3f} B parameters; init on the card "
              f"{t1 - t0:.3f} s, bf16 copy {time.perf_counter() - t1:.3f} s")
        # Tokens from a generator of their own: checks added before serve
        # leave them as they are.
        tokens = torch.randint(0, cfg.vocab, (B_s, T_s), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(args.seed))
        prefill = D.make_prefill_fn(cfg, T.ModelContext())
        prefill_ref = D.make_prefill_fn(cfg, T.ModelContext(attn_impl="torch_ref"))
        prefill(served, {"tokens": tokens[:, :64]})  # warm-up: cuBLAS handles, library load
        sync()

        # (a) prefill through the kernel, launches counted just around it
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(served, {"tokens": tokens})
        sync()
        prefill_s = time.perf_counter() - t0
        serve_counts = dispatch.launch_counts()
        print(f"(a) prefill {B_s} x {T_s} tokens: {prefill_s:.3f} s  "
              f"({B_s * T_s / prefill_s:.0f} tokens/s)  launches {serve_counts}  [{card}]")
        if serve_counts.get("flash_attention") != cfg.n_layers:
            raise AssertionError(f"prefill launched flash_attention {serve_counts.get('flash_attention')} "
                                 f"times, expected {cfg.n_layers}")
        if logits.shape != (B_s, 1, cfg.vocab) or len(cache) != cfg.n_layers:
            raise AssertionError(f"prefill returned logits {tuple(logits.shape)} and {len(cache)} cache layers")
        if cache[-1]["k"].shape != (B_s, T_s, cfg.n_kv_heads, cfg.head_dim):
            raise AssertionError(f"prefill cache of shape {tuple(cache[-1]['k'].shape)}")
        cache_a = cache

        # (b) the same prefill through the plain attention
        t0 = time.perf_counter()
        logits_ref, cache = prefill_ref(served, {"tokens": tokens})
        sync()
        ref_s = time.perf_counter() - t0
        # How the two part with depth: k of layer l depends on l attentions.
        k_gap = {li: round(float(torch.linalg.vector_norm(cache_a[li]["k"].float() - cache[li]["k"].float())
                                 / torch.linalg.vector_norm(cache[li]["k"].float())), 5)
                 for li in (0, 1, 2, 4, 8, 16, 35)}
        print(f"relative gap of the K cache by layer, kernel vs plain prefill: {k_gap}")
        del cache, cache_a
        la, lb = logits.float()[:, 0], logits_ref.float()[:, 0]
        if not (bool(torch.isfinite(la).all()) and bool(torch.isfinite(lb).all())):
            raise AssertionError("prefill logits are not finite")
        gap = float((la - lb).abs().max() / lb.abs().max())
        fro = float(torch.linalg.vector_norm(la - lb) / torch.linalg.vector_norm(lb))
        agree = (la.argmax(-1) == lb.argmax(-1)).tolist()
        print(f"(b) plain-attention prefill: {ref_s:.3f} s; last-position logits max|a-b|/max|b| "
              f"{gap:.3e}, |a-b|/|b| {fro:.3e}, argmax agrees per request {agree}")
        if gap > 2e-2:
            raise AssertionError(f"kernel and plain prefill logits differ by {gap:.3e} of their scale (> 2e-2)")

        # (c) greedy decode, the launcher's defaults at temperature 0
        prompt = tokens[:, :prompt_len].contiguous()
        dispatch.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        out = D.greedy_generate(served, cfg, prompt, steps=gen_len)
        sync()
        dec_s = time.perf_counter() - t0
        dec_counts = dispatch.launch_counts()
        steps = prompt_len + gen_len
        print(f"(c) greedy_generate batch {B_s}, prompt {prompt_len}, gen {gen_len}: {dec_s:.3f} s, "
              f"{B_s * gen_len / dec_s:.1f} generated tokens/s, {B_s * steps / dec_s:.1f} tokens/s over "
              f"all {steps} steps ({1e3 * dec_s / steps:.2f} ms/step)  launches {dec_counts}  [{card}]")
        if dec_counts.get("flash_attention", 0) != 0:
            raise AssertionError("greedy decode launched the flash kernel")
        if out.shape != (B_s, gen_len) or bool((out < 0).any() or (out >= cfg.vocab).any()):
            raise AssertionError(f"greedy_generate returned {tuple(out.shape)} or ids outside the vocab")
        short, _ = prefill(served, {"tokens": prompt})
        first = (short[:, 0].argmax(-1) == out[:, 0]).tolist()
        if not bool(torch.isfinite(short).all()):
            raise AssertionError("prefill logits of the prompt are not finite")
        print(f"first generated token equals the argmax of the prompt's prefill: {first}")
        print(f"row 0: {out[0].tolist()}")

        # Where the time goes: kernel time against the unprofiled wall above.
        busy = profiled(f"prefill {B_s} x {T_s}", lambda: prefill(served, {"tokens": tokens}), top=8)
        print(f"prefill device busy {busy:.3f} s of {prefill_s:.3f} s unprofiled "
              f"(idle share {1 - busy / prefill_s:.3f})")
        busy = profiled("greedy_generate, prompt 4, gen 4 (8 steps)",
                        lambda: D.greedy_generate(served, cfg, prompt[:, :4], steps=4), top=8)
        print(f"decode device busy {1e3 * busy / 8:.3f} ms per step of {1e3 * dec_s / steps:.3f} ms "
              f"unprofiled (idle share {1 - busy / 8 / (dec_s / steps):.3f})")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"max_memory_allocated (f32 weights + bf16 copy + activations): {peak:.3f} GiB")
        del model, served

    def moe_param_count(cfg):
        """The parameters of an attn_moe model from its config's widths."""
        d, m = cfg.d_model, cfg.moe
        attn = d * cfg.head_dim * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
        moe = d * m.num_experts + 3 * m.num_experts * d * m.d_expert + 3 * d * m.d_expert * m.num_shared
        return cfg.n_layers * (attn + moe + 2 * d) + 2 * cfg.vocab * d + d

    def kernel_vs_plain(tag, served, cfg, tokens, tol):
        """The prefill through the kernel, then through the plain attention
        twice, each run's routing recorded (``models.moe.recorded_routing``).
        The free plain run is held by the flip rule: with no routing
        difference the last-position logits lie within ``tol`` of their
        scale (max|a-b|/max|b|, as phase "serve" holds them); otherwise every
        layer up to and including the first that differs has its K cache
        within ``tol`` relative in norm.  The second plain run replays the
        kernel run's decisions, so the two differ only in arithmetic: its
        logits and every layer's K and V caches must lie within ``tol``.
        Returns (the kernel run's logits, its routing log, the replayed plain
        run's logits)."""
        plain = D.make_prefill_fn(cfg, T.ModelContext(attn_impl="torch_ref"))
        with moe_mod.recorded_routing() as log_k:
            logits, cache = D.make_prefill_fn(cfg, T.ModelContext())(served, {"tokens": tokens})
        with moe_mod.recorded_routing() as log_p:
            t0 = time.perf_counter()
            logits_p, cache_p = plain(served, {"tokens": tokens})
            sync()
            ref_s = time.perf_counter() - t0
        differ = moe_mod.routing_differences(log_k, log_p)
        first = next((li for li, n in enumerate(differ) if n), None)

        def cache_gap(a, b, key):
            return [float(torch.linalg.vector_norm(x[key].float() - y[key].float())
                          / torch.linalg.vector_norm(y[key].float())) for x, y in zip(a, b)]

        def logits_gap(a, b):
            a, b = a.float()[:, 0], b.float()[:, 0]
            if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
                raise AssertionError(f"{tag}: prefill logits are not finite")
            return float((a - b).abs().max() / b.abs().max())

        k_gap, gap = cache_gap(cache, cache_p, "k"), logits_gap(logits, logits_p)
        print(f"{tag}: plain-attention prefill {ref_s:.3f} s; routing decisions that differ "
              f"{sum(differ)} (by layer {differ}), first layer with a difference {first}; "
              f"last-position logits max|a-b|/max|b| {gap:.3e}; argmax agrees per request "
              f"{(logits[:, 0].argmax(-1) == logits_p[:, 0].argmax(-1)).tolist()}")
        print(f"{tag}: relative gap of the K cache by layer {[round(g, 6) for g in k_gap]}")
        if first is None:
            if gap > tol:
                raise AssertionError(f"{tag}: no routing difference, yet the logits differ by {gap:.3e} of "
                                     f"their scale (> {tol:g})")
        else:
            far = [li for li in range(first + 1) if k_gap[li] > tol]
            if far:
                raise AssertionError(f"{tag}: K caches of layers {far}, at or before the first routing "
                                     f"difference (layer {first}), differ by more than {tol:g}")
        del cache_p, logits_p
        with moe_mod.recorded_routing(replay=log_k):
            logits_r, cache_r = plain(served, {"tokens": tokens})
        gap = logits_gap(logits, logits_r)
        k_gap, v_gap = cache_gap(cache, cache_r, "k"), cache_gap(cache, cache_r, "v")
        print(f"{tag}: plain prefill given the kernel run's routing: last-position logits max|a-b|/max|b| "
              f"{gap:.3e}; worst K / V cache gap {max(k_gap):.3e} / {max(v_gap):.3e} (layers "
              f"{k_gap.index(max(k_gap))} / {v_gap.index(max(v_gap))})")
        far = [li for li in range(cfg.n_layers) if max(k_gap[li], v_gap[li]) > tol]
        if gap > tol or far:
            raise AssertionError(f"{tag}: with the routing replayed, the logits differ by {gap:.3e} of their "
                                 f"scale and the caches of layers {far} by more than {tol:g}")
        del cache, cache_r
        return logits, log_k, logits_r

    with phase("serve moe"):
        # (a) deepseek-moe-16b at full width and depth, drawn in bf16 on the
        # card: an f32 tree (67.5 GB) and its bf16 copy would not fit.
        cfg = get_config("deepseek-moe-16b", param_dtype="bfloat16")
        B_s, T_s, prompt_len, gen_len = 4, 2048, 16, 32
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        served = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(args.seed))
        sync()
        n_params = T.param_count(served)
        print(f"deepseek-moe-16b: {n_params / 1e9:.3f} B parameters ({n_params:,}; {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, {cfg.moe.num_experts} experts top-"
              f"{cfg.moe.top_k} of width {cfg.moe.d_expert}, {cfg.moe.num_shared} shared, "
              f"{cfg.moe.router_score} router, vocab {cfg.vocab}); drawn in bf16 on the card in "
              f"{time.perf_counter() - t0:.3f} s; {torch.cuda.memory_allocated() / 2**30 - base:.3f} GiB")
        if n_params != moe_param_count(cfg):
            raise AssertionError(f"deepseek-moe-16b holds {n_params} parameters, its widths give {moe_param_count(cfg)}")
        if served.blocks[0].moe.router.dtype != torch.bfloat16 or served.blocks[0].moe.w_gate.dtype != torch.bfloat16:
            raise AssertionError("deepseek-moe-16b: expected its weights in bf16")
        tokens = torch.randint(0, cfg.vocab, (B_s, T_s), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(args.seed))
        prefill = D.make_prefill_fn(cfg, T.ModelContext())
        prefill(served, {"tokens": tokens[:, :64]})  # warm-up
        sync()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        with moe_mod.recorded_routing() as log_a:
            logits, cache = prefill(served, {"tokens": tokens})
            sync()
        moe_prefill_s = time.perf_counter() - t0
        moe_counts = dispatch.launch_counts()
        print(f"(a) prefill {B_s} x {T_s} tokens: {moe_prefill_s:.3f} s  ({B_s * T_s / moe_prefill_s:.0f} tokens/s)  "
              f"launches {moe_counts}  peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{card}]")
        if moe_counts.get("flash_attention") != cfg.n_layers or sum(moe_counts.values()) != cfg.n_layers:
            raise AssertionError(f"MoE prefill launched {moe_counts}, expected {cfg.n_layers} flash_attention")
        if logits.shape != (B_s, 1, cfg.vocab) or len(cache) != cfg.n_layers:
            raise AssertionError(f"MoE prefill returned logits {tuple(logits.shape)} and {len(cache)} cache layers")
        if cache[-1]["k"].shape != (B_s, T_s, cfg.n_kv_heads, cfg.head_dim) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"MoE prefill cache of shape {tuple(cache[-1]['k'].shape)}, or logits not finite")
        del cache

        # (b) the same prefill through the plain attention, by the flip rule;
        # the kernel run again beside (a): the combine adds in one order, so
        # the two runs must route alike and give the same bits.
        again, log_again, _ = kernel_vs_plain("(b) bf16", served, cfg, tokens, 2e-2)
        la, lb = again.float()[:, 0], logits.float()[:, 0]
        same_routing = len(log_a) == len(log_again) and all(
            torch.equal(x, y) for x, y in zip(log_a, log_again))
        print(f"(b) two kernel prefills: logits bit for bit {torch.equal(again, logits)}, every layer's "
              f"routing record bit for bit {same_routing} ({len(log_a)} selections), last-position logits "
              f"max|a-b|/max|b| {float((la - lb).abs().max() / lb.abs().max()):.3e}")
        if not (torch.equal(again, logits) and same_routing):
            raise AssertionError("(b): two kernel prefills of the same tokens differ")
        del again, logits, log_a, log_again
        moe_combine_timing(args.seed, card)

        # (c) greedy decode: capacity max(1, int(4 * 6 * 1.25 / 64)) = 1 a step
        prompt = tokens[:, :prompt_len].contiguous()
        D.greedy_generate(served, cfg, prompt[:, :2], steps=2)  # warm-up
        dispatch.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        out = D.greedy_generate(served, cfg, prompt, steps=gen_len)
        sync()
        moe_dec_s = time.perf_counter() - t0
        dec_counts = dispatch.launch_counts()
        steps = prompt_len + gen_len
        print(f"(c) greedy_generate batch {B_s}, prompt {prompt_len}, gen {gen_len}: {moe_dec_s:.3f} s, "
              f"{B_s * gen_len / moe_dec_s:.1f} generated tokens/s ({1e3 * moe_dec_s / steps:.2f} ms/step)  "
              f"launches {dec_counts}  [{card}]")
        if sum(dec_counts.values()) != 0:
            raise AssertionError(f"MoE decode launched {dec_counts}")
        if out.shape != (B_s, gen_len) or bool((out < 0).any() or (out >= cfg.vocab).any()):
            raise AssertionError(f"greedy_generate returned {tuple(out.shape)} or ids outside the vocab")
        print(f"row 0: {out[0].tolist()}")

        # (d) where the time goes
        busy = profiled(f"MoE prefill {B_s} x {T_s}", lambda: prefill(served, {"tokens": tokens}), top=10)
        print(f"MoE prefill device busy {busy:.3f} s of {moe_prefill_s:.3f} s unprofiled "
              f"(idle share {1 - busy / moe_prefill_s:.3f})")
        busy = profiled("MoE greedy_generate, prompt 4, gen 4 (8 steps)",
                        lambda: D.greedy_generate(served, cfg, prompt[:, :4], steps=4), top=10)
        print(f"MoE decode device busy {1e3 * busy / 8:.3f} ms per step of {1e3 * moe_dec_s / steps:.3f} ms "
              f"unprofiled (idle share {1 - busy / 8 / (moe_dec_s / steps):.3f})")
        print(f"deepseek-moe-16b max_memory_allocated (bf16 weights, caches, activations): "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{card}]")
        del served, out
        torch.cuda.empty_cache()

        # (b') f32 at full width, depth cut to 4 layers: the mma-sync kernel,
        # whose f32 products run as bf16 pieces on the tensor cores (~1e-5 of
        # an attention output at this shape), so 1e-4 of the logits' scale.
        # The control: the replayed plain prefill with TF32 matmuls must part
        # from the f32 one by more than that, or the check could not tell.
        cfg32 = get_config("deepseek-moe-16b", n_layers=4, compute_dtype="float32")
        served = T.init_params(cfg32, generator=torch.Generator(device=dev).manual_seed(args.seed))
        _, log_k, logits_r = kernel_vs_plain("(b') f32, 4 of 28 layers", served, cfg32, tokens, 1e-4)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with moe_mod.recorded_routing(replay=log_k):
                logits_c, _ = D.make_prefill_fn(cfg32, T.ModelContext(attn_impl="torch_ref"))(
                    served, {"tokens": tokens})
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        a, b = logits_c.float()[:, 0], logits_r.float()[:, 0]
        control = float((a - b).abs().max() / b.abs().max())
        print(f"(b') control: the same replayed plain prefill with TF32 matmuls, last-position logits "
              f"max|a-b|/max|b| {control:.3e} against the f32 one (limit 1e-4)  [{card}]")
        if not control > 1e-4:
            raise AssertionError(f"(b'): TF32 arithmetic parts by only {control:.3e}: the 1e-4 check cannot tell it")
        del served, log_k, logits_r, logits_c
        torch.cuda.empty_cache()

        # (e) moonshot-v1-16b-a3b at full width, depth cut 48 -> 4 layers: the
        # sigmoid router with top-k renormalisation
        cfg_m = get_config("moonshot-v1-16b-a3b", n_layers=4, param_dtype="bfloat16")
        served = T.init_params(cfg_m, generator=torch.Generator(device=dev).manual_seed(args.seed))
        tokens_m = torch.randint(0, cfg_m.vocab, (B_s, T_s), device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(args.seed))
        dispatch.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        logits_m, _ = D.make_prefill_fn(cfg_m, T.ModelContext())(served, {"tokens": tokens_m})
        sync()
        m_s = time.perf_counter() - t0
        m_counts = dispatch.launch_counts()
        t0 = time.perf_counter()
        out_m = D.greedy_generate(served, cfg_m, tokens_m[:, :8].contiguous(), steps=8)
        sync()
        m_dec = time.perf_counter() - t0
        dec_counts = dispatch.launch_counts()
        print(f"(e) moonshot-v1-16b-a3b (depth cut 48 -> 4 layers; full width: {T.param_count(served) / 1e9:.3f} B "
              f"parameters held): prefill {B_s} x {T_s} {m_s:.3f} s (first call), launches {m_counts}; greedy "
              f"prompt 8 gen 8 {1e3 * m_dec / 16:.2f} ms/step, launches after it {dec_counts}  [{card}]")
        if m_counts.get("flash_attention") != cfg_m.n_layers or dec_counts != m_counts:
            raise AssertionError(f"moonshot: prefill launched {m_counts}, decode added {dec_counts}")
        if logits_m.shape != (B_s, 1, cfg_m.vocab) or not bool(torch.isfinite(logits_m).all()):
            raise AssertionError("moonshot: prefill logits of the wrong shape or not finite")
        if out_m.shape != (B_s, 8) or bool((out_m < 0).any() or (out_m >= cfg_m.vocab).any()):
            raise AssertionError("moonshot: greedy ids outside the vocab")
        kernel_vs_plain("(e) moonshot bf16", served, cfg_m, tokens_m, 2e-2)
        del served, logits_m
        torch.cuda.empty_cache()

    with phase("serve xlstm"):
        serve_xlstm(args.seed, card)

    with phase("timing"):
        B, m, d = xs_d.shape
        c = rows_of(xs_d, k_full)
        idx, _ = pd_ops.assign_min(xs_d, c)
        w = ws_d * rand(B, m)
        a_flops = 2.0 * B * m * k_full * d
        a_bytes = 4.0 * (B * m * d + B * k_full * d) + 8.0 * B * m
        s_flops = 2.0 * B * m * (d + 1)
        s_bytes = 4.0 * B * m * (d + 2) + 4.0 * B * k_full * (d + 1)
        wx1 = torch.cat([w.unsqueeze(-1) * xs_d, w.unsqueeze(-1)], dim=-1).reshape(B * m, d + 1)
        flat = (idx.long() + k_full * torch.arange(B, device=dev)[:, None]).reshape(-1)
        acc = torch.zeros(B * k_full, d + 1, device=dev)

        def bound(flops, nbytes, peak=PEAK_FP32_FLOPS):
            tf, tb = flops / peak, nbytes / PEAK_BYTES
            return 1e3 * max(tf, tb), ("operations" if tf >= tb else "bytes")

        # fp32-accurate distances: three TF32 tensor-core passes (3xTF32) are
        # the least this card needs; one fp32 CUDA-core pass is kept beside.
        a_bound, a_by = bound(3 * a_flops, a_bytes, PEAK_TF32_FLOPS)
        s_bound, s_by = bound(s_flops, s_bytes)
        rows = [
            {
                "name": "assign_min", "route": "cuda",
                "source": "src/repro_torch/csrc/assign_min.cu",
                "replaces": "src/repro/kernels/pairwise_dist/kernel.py:71",
                "launches": counts["assign_min"], "max_abs_err": errs["assign_min"],
                "ms": cuda_ms(lambda: pd_ops.assign_min(xs_d, c), 20),
                "plain_ms": cuda_ms(lambda: pd_ops.assign_min(xs_d, c, impl="torch_ref"), 5),
                "bound_ms": a_bound, "bound_by": a_by,
                "library_ms": cuda_ms(lambda: torch.cdist(xs_d, c).min(-1), 5),
                "library_call": "torch.cdist(x, c).min(-1) (two calls)",
                "design": "3xtf32-wgmma",
            },
            {
                "name": "weighted_segsum", "route": "cuda",
                "source": "src/repro_torch/csrc/weighted_segsum.cu",
                "replaces": "src/repro/kernels/weighted_segsum/kernel.py:24",
                "launches": counts["weighted_segsum"], "max_abs_err": errs["weighted_segsum"],
                "ms": cuda_ms(lambda: ss_ops.weighted_segsum(xs_d, w, idx, k_full), 20),
                "plain_ms": cuda_ms(
                    lambda: ss_ops.weighted_segsum(xs_d, w, idx, k_full, impl="torch_ref"), 5),
                "bound_ms": s_bound, "bound_by": s_by,
                "library_ms": cuda_ms(lambda: acc.index_add_(0, flat, wx1), 20),
                "library_call": "index_add_ of the (B*n, d+1) rows [w*x, w] (atomics)",
                "design": "streamed-shared-acc",
            },
        ]
        # Computed figures beside each row, printed on its timing line only.
        beside = {
            "assign_min": {"shape": [B, m, k_full, d],
                           "fp32_bound_ms": 1e3 * max(a_flops / PEAK_FP32_FLOPS, a_bytes / PEAK_BYTES),
                           "stream_launches_per_ingest": stream_launches["assign_min_per_ingest"],
                           "launches_per_query_batch": 1, "launches_per_frontend_dispatch": 1},
            "weighted_segsum": {"shape": [B, m, k_full, d],
                                "stream_launches_per_ingest": stream_launches["weighted_segsum_per_ingest"],
                                "launches_by_x_shape": {
                str(list(shape)): n for shape, n in seg_shapes.items()}},
        }
        # weighted_segsum at the coordinator's shape too: (1, s*k, 256, 128)
        cy = rows_of(xs_d, k_full).reshape(1, s * k_full, d)
        cidx, _ = pd_ops.assign_min(cy, rows_of(cy, k_full))
        cw = rand(1, s * k_full)
        c_bound, _ = bound(2.0 * s * k_full * (d + 1),
                           4.0 * s * k_full * (d + 2) + 4.0 * k_full * (d + 1))
        cwx1 = torch.cat([cw.unsqueeze(-1) * cy, cw.unsqueeze(-1)], dim=-1).reshape(s * k_full, d + 1)
        cacc = torch.zeros(k_full, d + 1, device=dev)
        beside["weighted_segsum"].update({
            "coordinator_shape": [1, s * k_full, k_full, d],
            "coordinator_ms": cuda_ms(lambda: ss_ops.weighted_segsum(cy, cw, cidx, k_full), 50),
            "coordinator_plain_ms": cuda_ms(
                lambda: ss_ops.weighted_segsum(cy, cw, cidx, k_full, impl="torch_ref"), 20),
            "coordinator_library_ms": cuda_ms(lambda: cacc.index_add_(0, cidx[0].long(), cwx1), 50),
            "coordinator_bound_ms": c_bound,
        })

        # Flash attention at the prefill shape, bf16: causal pairs t, s <= t.
        fB, fT, fH, fKV, fdh = 4, 2048, 32, 8, 128
        fq = torch.randn((fB, fT, fH, fdh), generator=gen, device=dev).bfloat16()
        fk = torch.randn((fB, fT, fKV, fdh), generator=gen, device=dev).bfloat16()
        fv = torch.randn((fB, fT, fKV, fdh), generator=gen, device=dev).bfloat16()
        f_flops = 4.0 * fB * fH * fdh * (fT * (fT + 1) / 2)
        f_bytes = 2.0 * (2 * fB * fT * fH * fdh + 2 * fB * fT * fKV * fdh)
        f_bound, f_by = (1e3 * max(f_flops / PEAK_BF16_FLOPS, f_bytes / PEAK_BYTES),
                         "operations" if f_flops / PEAK_BF16_FLOPS >= f_bytes / PEAK_BYTES else "bytes")
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (fq, fk, fv))  # (B, heads, T, dh)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rows.append({
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:29",
            "launches": serve_counts["flash_attention"], "max_abs_err": errs["flash_attention"],
            "launches_by_path": {"serve qwen3-4b prefill": serve_counts["flash_attention"],
                                 "serve moe deepseek-moe-16b prefill": moe_counts["flash_attention"],
                                 "serve moe moonshot-v1-16b-a3b prefill (4 layers)": m_counts["flash_attention"]},
            "ms": cuda_ms(lambda: fa_ops.flash_attention(fq, fk, fv), 20),
            "plain_ms": cuda_ms(lambda: fa_ops.flash_attention(fq, fk, fv, impl="torch_ref"), 3),
            "bound_ms": f_bound, "bound_by": f_by,
            "library_ms": cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=True, enable_gqa=True), 20),
            "library_call": "scaled_dot_product_attention(is_causal=True, enable_gqa=True) on (B, H, T, dh)",
            "design": fa_kernel.route(torch.bfloat16, fdh),
        })
        beside["flash_attention"] = {
            "shape": [fB, fT, fT, fH, fKV, fdh],
            # p.v runs twice (p split into hi + lo bf16 pieces): 1.5 x the products
            "split_floor_ms": 1.5 * f_bound,
            "fp32_bound_ms": 1e3 * f_flops / PEAK_FP32_FLOPS,
            "bytes_bound_ms": 1e3 * f_bytes / PEAK_BYTES,
        }
        # ... and at deepseek-moe-16b's prefill shape: group size 1, half the heads
        mH = mKV = 16
        mq = torch.randn((fB, fT, mH, fdh), generator=gen, device=dev).bfloat16()
        mk = torch.randn((fB, fT, mKV, fdh), generator=gen, device=dev).bfloat16()
        mv = torch.randn((fB, fT, mKV, fdh), generator=gen, device=dev).bfloat16()
        m_flops = 4.0 * fB * mH * fdh * (fT * (fT + 1) / 2)
        m_bytes = 2.0 * (2 * fB * fT * mH * fdh + 2 * fB * fT * mKV * fdh)
        mqh, mkh, mvh = (t.transpose(1, 2).contiguous() for t in (mq, mk, mv))
        beside["flash_attention"].update({
            "moe_shape": [fB, fT, fT, mH, mKV, fdh],
            "moe_ms": cuda_ms(lambda: fa_ops.flash_attention(mq, mk, mv), 20),
            "moe_plain_ms": cuda_ms(lambda: fa_ops.flash_attention(mq, mk, mv, impl="torch_ref"), 3),
            "moe_library_ms": cuda_ms(lambda: sdpa(mqh, mkh, mvh, is_causal=True), 20),
            "moe_bound_ms": 1e3 * max(m_flops / PEAK_BF16_FLOPS, m_bytes / PEAK_BYTES),
        })
        # pairwise_sqdist at its full-width path shape: the full (n, k) output.
        n_q, k_q = pts_d.shape[0], k_full
        q_flops = 2.0 * n_q * k_q * d_full
        q_bytes = 4.0 * (n_q * d_full + k_q * d_full + n_q * k_q)
        q_bound, q_by = bound(3 * q_flops, q_bytes, PEAK_TF32_FLOPS)  # as assign_min's
        rows.append({
            "name": "pairwise_sqdist", "route": "cuda",
            "source": "src/repro_torch/csrc/pairwise_sqdist.cu",
            "replaces": "src/repro/kernels/pairwise_dist/kernel.py:48",
            "launches": sq_counts["pairwise_sqdist"], "max_abs_err": errs["pairwise_sqdist"],
            "ms": cuda_ms(lambda: pd_ops.pairwise_sqdist(pts_d, sq_c), 20),
            "plain_ms": cuda_ms(lambda: pd_ops.pairwise_sqdist(pts_d, sq_c, impl="torch_ref"), 5),
            "bound_ms": q_bound, "bound_by": q_by,
            "library_ms": cuda_ms(lambda: torch.cdist(pts_d, sq_c).pow(2), 5),
            "library_call": "torch.cdist(x, c).pow(2) (two calls)",
            "design": "3xtf32-wgmma-tma-store",
        })
        beside["pairwise_sqdist"] = {
            "shape": [n_q, k_q, d_full],
            "fp32_bound_ms": 1e3 * max(q_flops / PEAK_FP32_FLOPS, q_bytes / PEAK_BYTES),
        }
        for r in rows:
            print(f"{r['name']} ({r['design']}): {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  "
                  f"library {r['library_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms ({r['bound_by']}, "
                  f"share {r['bound_ms'] / r['ms']:.1%})  {beside[r['name']]}  [{card}]")

    print(json.dumps({"kernels": rows}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
serves qwen3-4b, the MoE model deepseek-moe-16b, the xLSTM model
xlstm-1.3b, the RG-LRU / local-attention model recurrentgemma-9b and the
two modality frontends musicgen-large and internvl2-1b at full width and
depth (prefill and greedy decode) and moonshot-v1-16b-a3b at full width,
trains qwen3-1.7b at full width and depth and the launcher's 100m scale
through the trainer's host path and through its mesh-native path (the
recovery solved on the card, resident token pools, an elastic patch, the
mesh executor over NCCL), audits the hot paths for host syncs on the card,
runs the multi-pod dry run of the port on a fake 256-rank group and holds
its predictions against the mesh phases' ranks, and fails loudly: there is
no CPU fallback and no caught phase.  Every phase prints its seconds beside the card's name and
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
                 128) (group size 1), the frontends' prefill shapes
                 (4, 2048, 2048, 14, 2, 64) (group size 7) and (4, 2048,
                 2048, 32, 32, 64); the autograd Function of flash
                 (the kernel forward, the plain attention_bwd_ref
                 backward) against torch.autograd.grad of the plain
                 attention at qwen3-1.7b's training shape (8, 512, 512,
                 16, 8, 128) bf16 (2e-2 of each gradient's scale) and a
                 ragged f32 one (1e-4), timed beside
                 scaled_dot_product_attention's forward plus backward,
                 and the raw wrapper must refuse inputs that require
                 grad; pairwise_sqdist at its edges
                 and at (1,000,000 x 128) x (256 x 128), the op's own path:
                 launch counts are read just around that call;
                 min_dist_update over three seeding steps on each side at
                 d = 3 and 130 (the scalar path), at the local solves'
                 (10, m, 128), at the benchmark solve's (10, 400000, 128)
                 and at its coordinator's (1, 10240, 128) at k = 1024
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
                 prelude, local solves, collectives); (c) the first 4
                 rounds of observe + step_cost on phase 8's covered cell,
                 each within 1e-5 of phase 8 (b)'s round, 0 host solves, rows written
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
                 exceed it; (c) greedy_generate, batch 4, prompt 16,
                 gen 32, 0 kernel launches, the recurrent state's bytes;
                 (d) a prefill at 8 of the 48 layers (7 mLSTM, 1 sLSTM),
                 timed, and 8 decode steps under torch.profiler
  16. serve rglru  recurrentgemma-9b (38 layers: 26 RG-LRU, 12 local
                 attention over a window of 2048, 16 heads over 1 KV head
                 of 256, d_model 4096, vocab 256000; 10,444,984,320
                 parameters, the count held to the one from the widths),
                 drawn as the serving launcher draws it (matmul weights
                 in bf16, norms and lam in f32): (a) prefill of 4 x 4096
                 tokens (twice the window: the K/V clip and the skipped
                 key blocks bind): seconds, tokens/s, peak memory, 0 kernel
                 launches, finite logits (4, 1, 256000), a (4, 2048, 1,
                 256) K and V cache a local layer, {} a recurrent one;
                 (b) the windowed chunked attention against a masked dense
                 oracle: f32 at (1, 4096, 16, 1, 256) within rtol 2e-5,
                 atol 2e-4, bf16 at (4, 4096, 16, 1, 256) within 2e-2 of
                 the oracle's scale, timed; (c) the ring: 2112 tokens
                 teacher-forced through decode_step against forward_train
                 in f32 at full width, depth 5 (one unit and the tail),
                 within 1e-4 of the logits' scale over all positions and
                 over positions >= 2048 (the ring wrapped), and the same
                 decode at window 4096 must part by more; (d)
                 greedy_generate, batch 4, prompt 16, gen 32, 0 kernel
                 launches, the cache's bytes; (e) one prefill and 8 decode
                 steps under torch.profiler
  17. serve frontends  musicgen-large (48 layers, d_model 2048, 32 heads
                 over 32 of 64, 4 codebooks of 2048; 2,449,672,192
                 parameters) and internvl2-1b (24 layers, d_model 896,
                 14 heads over 2 of 64, 256 prefix embeddings, vocab
                 151655; 629,663,872 parameters), each drawn as the
                 serving launcher draws it, the count held to the
                 widths': a prefill of 4 x 2048 (musicgen's (4, 4, 2048)
                 tokens; internvl's 256 seeded prefix embeddings and 1792
                 text tokens) with exactly 48 / 24 flash launches,
                 tokens/s, profiled (busy, idle share); greedy_generate
                 batch 4, prompt 16, gen 32, ms a step; decode against the
                 teacher-forced forward_train in f32 at full width, depth
                 4, 64 tokens, within rtol 2e-2, atol 2e-2 (the band of
                 tests/test_models_smoke.py:142)
  18. train full width  qwen3-1.7b (28 layers, d_model 2048; 2,031,739,904
                 f32 parameters, bf16 compute) through Trainer's host path:
                 4 groups, 4 shards, redundancy 2 cyclic, microbatch 1,
                 seq_len 512, 8 steps under the deadline scenario, tokens
                 over 8192 ids (DATA_VOCAB); each step's seconds, tokens/s,
                 flash launches (exactly 28), host solves, loss; two more
                 steps profiled (busy, idle share); the peak memory; every
                 parameter's .grad present and nonzero after one backward;
                 one step's gradient through the kernel against the plain
                 attention at 2 layers of that width in f32, each
                 parameter within 1e-4 of its scale
  19. train 100m the launcher's 100m scale (qwen3-4b's family, d_model 768,
                 12 layers, vocab 32768): 30 steps under the deadline
                 scenario with a checkpoint every 10; the mean loss of the
                 last 8 steps below the first 8's by 0.01 (the twin of
                 tests/test_training.py:298); 15 steps, an interrupt, and
                 a resume from the checkpoint to step 30 (its straggler
                 stream advanced past the 15 steps taken): its losses
                 within 1e-3 of the uninterrupted run's, bit for bit
                 printed
  20. train device recovery  qwen3-1.7b at full width and depth (f32 master
                 weights, bf16 compute) through Trainer's mesh-native path
                 (device_recovery=True): FR over 4 groups and 4 shards,
                 redundancy 2, microbatch 1, seq_len 512, 2 resident step
                 batches, one headroom slot a group (a (4, 2, 3, 512) token
                 pool, 8 of 12 slots valid); a trace of the 6 first
                 coverage-preserving patterns, then one that loses a shard:
                 each step's seconds, tokens/s (8 x 512 valid), flash
                 launches (exactly 4 x 28: a forward a group), the device
                 solve's time and launches alone, device and host solves,
                 fallback, b_sum, loss; 0 host solves and a device solve a
                 step on the covered steps, one host solve on the last; the
                 peak memory; one step profiled (busy, idle share); the
                 δ = 0 claim from one state (one straggler against all
                 alive) at full width within 2e-2 of each gradient's scale
                 and at 2 layers of that width in f32 within 1e-5; the same
                 step through MeshExecutor over a world of one over NCCL
                 against the local executor (2e-2 at full width; at 2
                 layers in f32 within 1e-6, or to the bit); an elastic
                 patch at the launcher's 100m scale (cyclic, 6 groups,
                 [1,1,1,1,0,0] for good, patience 2, headroom 2): patches
                 >= 1, moved rows >= 1, no full repack, the last step off
                 the fallback; the host path's step time beside the
                 device path's
  20a. serve mesh  deepseek-moe-16b on LM meshes: (a) a world of one over
                 NCCL, mesh (1, 1), bit for bit the meshless model; (b) two
                 gloo ranks on the card, mesh (1, 2), (c) four, mesh (2, 2)
                 with FSDP: each rank draws its blocks, prefills its rows
                 (28 flash launches), is held to the meshless oracle by the
                 flip rule and with its routing replayed, and decodes
                 teacher-forced in the oracle's cache slots with the routing
                 replayed: bit for bit, or the first op whose output
                 differs (launch.mesh_runs.decode_taps) is printed; then
                 the sequence-parallel decode (cache_layout="seq": all KV
                 heads of a rank's block of the slots, the softmax's
                 statistics summed over model): 8 steps on (1, 1) bit for
                 bit, and on (b)'s ranks the full oracle's 48 steps in its
                 48 slots, 24 a rank, each within 2e-2 of the oracle
  20b. train mesh  qwen3-1.7b at full width, 8 of its 28 layers, on LM
                 meshes: (a) a world of one over NCCL, 2 steps bit for bit
                 the meshless ones; (b) (1, 2) and (c) (2, 2) gloo ranks,
                 remat full, one compressed step a rank, every gradient
                 block within 2e-2 of the meshless oracle's; (d) in those
                 runs the oracle's gradient compressed through the mesh
                 path bit for bit the meshless compression, lm_head's
                 straddling block printed, the error-feedback buffers on
                 state_shardings' blocks; (e) at 2 layers on (c)'s ranks
                 with FSDP, TP and compression, Trainer(ctx=...,
                 ckpt_dir=...): 2 steps with a checkpoint after the first,
                 a resume bit for bit, the file restored meshless equal to
                 the ranks' saved blocks, a meshless file restored onto the
                 ranks; the file's bytes, the write and read seconds and
                 the free disk
  20c. analysis  the port's host-sync analysis (repro_torch.analysis):
                 layer 1, the AST lint over src/repro_torch, clean modulo
                 the port's baseline; layer 2, the four registered hot
                 paths (train.train_step, local.masked_reduce,
                 query.assign_min, serve.batch_assign) on CUDA tensors,
                 two shape buckets each, two calls a bucket with other
                 values: 0 host syncs counted by a TorchDispatchMode and
                 none raised under torch.cuda.set_sync_debug_mode("error"),
                 the same aten ops on the same shapes in both calls, and
                 the kernel launches by path (flash_attention in the train
                 step, assign_min in the other three)
  20d. dry run   python -m repro_torch.launch.dryrun, one process a cell,
                 all started at nice 19 before phase "serve xlstm", on the
                 host beside the card's phases (rank 0 of a fake process
                 group, meta tensors): (a) deepseek-moe-16b's prefill of
                 4 x 2048 and qwen3-1.7b's compressed step at 8 x 512 under remat
                 full, each on (1, 2) and (2, 2): rank (0, 0)'s predicted
                 parameter bytes and collectives (calls and bytes by kind)
                 equal to what phases 20a and 20b measured on that gloo
                 rank, the predicted peak beside max_memory_allocated,
                 their ratio printed; the (1, 2) decode of 20a under each
                 cache layout, its seq-minus-feature collectives equal to
                 what that rank counted; (b) qwen3-1.7b train_4k on (16, 16),
                 deepseek-moe-16b prefill at 32 x 8192 on (16, 16) (the
                 prefill_32k cell's length cut: on meta tensors its
                 32768-token chunked attention takes about 100 s of host
                 time) and qwen3-4b decode_32k on (2, 16, 16) under each
                 cache layout, rendered by launch.make_tables; an error
                 record fails the phase
                 Phases "serve" (13) and "train full width" (18) also run
                 one untimed prefill / step under launch.op_analysis and
                 print the roofline (launch.roofline on H100 terms):
                 model_flops, the op count's FLOPs and bytes, the dominant
                 term, roofline_fraction, the measured share of 989 TF/s,
                 and the flash calls counted against the launch counter
  21. timing     each kernel, its plain version and one library call
                 (weighted_segsum also at the coordinator's (1, 2560, 256,
                 128), with its launches in Algorithm 1 by shape;
                 min_dist_update also at the benchmark solve's (10, 400000,
                 128) and its coordinator's (1, 10240, 128),
                 with its launches in Algorithm 1 by shape, its bound the
                 bytes of one step); the
                 bound of rows assign_min and pairwise_sqdist is three TF32
                 passes (3xTF32, the least this card needs for fp32-accurate
                 distances; one fp32 CUDA-core pass beside it), the flash
                 row adds the floor of its split p (1.5 x its bound); these
                 computed figures and the shapes go on the printed timing
                 lines, the kernels line holds the measured numbers and
                 bound_ms; flash is timed at the MoE shape too, and its row
                 lists its launches by path (the training steps' forward
                 among them) and the autograd Function's numbers

The last two lines are the card's name and power limit and
{"ok": true, "device": {...}}; the line before them lists the kernels.

Run:  python3 chip_smoke.py [--seed N]
Needs one CUDA card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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


def device_activity(prof) -> list:
    """The device's activity of a finished ``torch.profiler`` run, summed by
    name: [(name, microseconds, count)], longest first.  It reads the raw
    Kineto events: ``key_averages()`` first parses every event into a tree
    on the host, which took 57 s over the script's 17 traces on an H100
    host (133-157 s while the host's op events were recorded too)."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            row = by_name.setdefault(e.name(), [0, 0])
            row[0] += e.duration_ns() / 1e3
            row[1] += 1
    return sorted(((name, us, n) for name, (us, n) in by_name.items()), key=lambda r: r[1], reverse=True)


def profiled(tag, fn, top=12):
    """Run fn under torch.profiler; print kernel time by name.  Returns
    the seconds of kernel time (device busy).  It records the CUDA activity
    alone: the kernels are all it reads (:func:`device_activity`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    t0 = time.perf_counter()
    kernels = device_activity(prof)
    busy = sum(us for _, us, _ in kernels) / 1e6
    print(f"{tag} under the profiler: wall {wall:.3f} s, kernels {busy:.3f} s "
          f"({100 * busy / wall:.1f}% of the profiled wall, which the profiler inflates); the trace read in "
          f"{time.perf_counter() - t0:.3f} s on the host")
    for name, us, n in kernels[:top]:
        print(f"  {us / 1e3:10.1f} ms  {n:7d} launches  {name[:90]}")
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
    chunkwise against stepwise at depth 8 in f32; greedy decode; a profile.
    No kernel of the port runs on this path."""
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
    # The bf16 gap at 8 layers, a print with no limit, is cut to make room for
    # phase "train mesh": tools/xlstm_consistency.py prints it (the forward
    # rounds the conv output, q and k to bf16, the decode keeps them f32; the
    # reference itself parts by 0.14-0.26 on the CPU, PERF.md).
    del model8
    torch.cuda.empty_cache()

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

    # (d) where the time goes.  The prefill is profiled at 8 of 48 layers (7
    # mLSTM, 1 sLSTM), timed unprofiled beside: at full depth reading its
    # trace (the sLSTM's ~200k launches) took 85.6 s of the host, more than
    # the script's time allows (PERF.md, PR 26).
    cfg_p = get_config("xlstm-1.3b", n_layers=8, param_dtype="bfloat16")
    model_p = T.init_params(cfg_p, generator=torch.Generator(device=dev).manual_seed(seed))
    prefill_p = D.make_prefill_fn(cfg_p, ctx)
    prefill_p(model_p, {"tokens": tokens[:, :64]})  # warm-up
    sync()
    t0 = time.perf_counter()
    prefill_p(model_p, {"tokens": tokens})
    sync()
    prefill_p_s = time.perf_counter() - t0
    busy = profiled(f"xLSTM prefill {B_s} x {T_s} at 8 of 48 layers (7 mLSTM, 1 sLSTM)",
                    lambda: prefill_p(model_p, {"tokens": tokens}), top=12)
    print(f"xLSTM prefill at 8 layers device busy {busy:.3f} s of {prefill_p_s:.3f} s unprofiled "
          f"(idle share {1 - busy / prefill_p_s:.3f}); at 48 layers {prefill_s:.3f} s unprofiled")
    del model_p
    busy = profiled("xLSTM greedy_generate, prompt 4, gen 4 (8 steps)",
                    lambda: D.greedy_generate(served, cfg, prompt[:, :4], steps=4), top=12)
    print(f"xLSTM decode device busy {1e3 * busy / 8:.3f} ms per step of {1e3 * dec_s / steps:.3f} ms "
          f"unprofiled (idle share {1 - busy / 8 / (dec_s / steps):.3f})")
    print(f"xlstm-1.3b max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{card}]")
    del served
    torch.cuda.empty_cache()


def rglru_param_count(cfg) -> int:
    """The parameters of an RG-LRU / local-attention model from its
    config's widths."""
    d, dr, W, f = cfg.d_model, cfg.d_rnn or cfg.d_model, cfg.conv_width, cfg.d_ff
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rglru = 2 * d + 3 * d * dr + W * dr + dr + 2 * (dr * dr + dr) + dr + 3 * d * f
    lattn = 2 * d + 2 * d * H * dh + 2 * d * KV * dh + 3 * d * f
    kinds = cfg.block_types
    head = 0 if cfg.tie_embeddings else d * cfg.vocab
    return kinds.count("rglru_mlp") * rglru + kinds.count("lattn_mlp") * lattn + cfg.vocab * d + head + d


def windowed_oracle(q, k, v, window):
    """Dense attention with the causal and window masks, in f32, one batch
    row at a time: the oracle of the chunked attention."""
    import torch

    T_len, g = q.shape[1], q.shape[2] // k.shape[2]
    pos = torch.arange(T_len, device=q.device)
    mask = (pos[:, None] >= pos[None, :]) & (pos[None, :] > pos[:, None] - window)
    out = []
    for b in range(q.shape[0]):
        kb, vb = k[b].float().repeat_interleave(g, 1), v[b].float().repeat_interleave(g, 1)
        s = torch.einsum("thd,shd->hts", q[b].float(), kb) * q.shape[-1] ** -0.5
        p = torch.softmax(s.masked_fill_(~mask, float("-inf")), dim=-1)
        del s
        out.append(torch.einsum("hts,shd->thd", p, vb))
        del p
    return torch.stack(out)


def serve_rglru(seed: int, card: str) -> None:
    """Phase "serve rglru": recurrentgemma-9b at full width and depth drawn
    as the serving launcher draws it; the windowed attention against a
    masked dense oracle; the ring decode against the forward in f32 at
    depth 5; greedy decode; a profile.  No kernel of the port runs on this
    path (the reference's windowed attention and RG-LRU scan are XLA ops)."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.serve import decode as D

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    ctx = T.ModelContext()
    torch.backends.cuda.matmul.allow_tf32 = False
    # (a) 38 layers (26 RG-LRU, 12 local attention), drawn as the launcher
    # draws them: the embedding and the matmul weights in bf16, the norms
    # and lam in f32.
    cfg = get_config("recurrentgemma-9b")
    B_s, T_s, prompt_len, gen_len = 4, 4096, 16, 32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    served = launch_serve.init_model(cfg, dev, seed)
    sync()
    n_params = T.param_count(served)
    kinds = cfg.block_types
    f32 = {name for name, t in served.state_dict().items() if t.dtype == torch.float32}
    print(f"recurrentgemma-9b: {n_params:,} parameters ({kinds.count('rglru_mlp')} RG-LRU and "
          f"{kinds.count('lattn_mlp')} local-attention layers, d_model {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} KV head of {cfg.head_dim}, window {cfg.window}, d_rnn {cfg.d_rnn}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}); drawn on the card in {time.perf_counter() - t0:.3f} s (already on the card "
          f"{base:.3f} GiB); {torch.cuda.memory_allocated() / 2**30 - base:.3f} GiB; {len(f32)} tensors in f32 "
          f"({sum(served.state_dict()[n].numel() for n in f32):,} values), the rest bf16  [{card}]")
    if n_params != rglru_param_count(cfg) or n_params != 10_444_984_320:
        raise AssertionError(f"recurrentgemma-9b holds {n_params} parameters, its widths give "
                             f"{rglru_param_count(cfg)}")
    if f32 != {n for n in served.state_dict() if n.endswith(T._READ_IN_F32)} or not any(
            n.endswith(".lam") for n in f32):
        raise AssertionError("the launcher's f32 parameters are not the ones the forward reads in f32")
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
        raise AssertionError(f"RecurrentGemma prefill launched {counts}; its path runs no kernel of the port")
    if logits.shape != (B_s, 1, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"RecurrentGemma prefill logits of shape {tuple(logits.shape)} or not finite")
    ring = (B_s, cfg.window, cfg.n_kv_heads, cfg.head_dim)
    for li, (c, bt) in enumerate(zip(cache, kinds)):
        want = {"k": ring, "v": ring} if bt == "lattn_mlp" else {}
        if {key: tuple(t.shape) for key, t in c.items()} != want:
            raise AssertionError(f"layer {li} ({bt}): prefill cache {({k: tuple(t.shape) for k, t in c.items()})}")
    del logits, cache

    # (b) the windowed attention on the card against the masked dense oracle
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    H, KV, dh, W = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window

    def qkv(B, dtype):
        return [torch.randn((B, T_s, h, dh), generator=g, device=dev).to(dtype) for h in (H, KV, KV)]

    q, k, v = qkv(1, torch.float32)
    dispatch.reset_launch_counts()
    got = fa_ops.flash_attention(q, k, v, causal=True, window=W)
    want = windowed_oracle(q, k, v, W)
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= 2e-4 + 2e-5 * want.abs()).all())
    print(f"(b) windowed chunked attention f32 (1, {T_s}, {H}, {KV}, {dh}), window {W}, TF32 off: max|a-b| "
          f"{err:.3e} (rtol 2e-5, atol 2e-4: {ok}), launches {dispatch.launch_counts()}  [{card}]")
    if not ok or sum(dispatch.launch_counts().values()):
        raise AssertionError("(b) f32 windowed attention outside rtol 2e-5 / atol 2e-4 of the oracle, or a launch")
    q, k, v = qkv(B_s, torch.bfloat16)
    got = fa_ops.flash_attention(q, k, v, causal=True, window=W)
    want = windowed_oracle(q, k, v, W)
    gap = float((got.float() - want).abs().max() / want.abs().max())
    ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True, window=W), 3)
    # The work it needs: scores and p·v over the T·W causal window band.
    band = sum(min(t + 1, W) for t in range(T_s))
    flops = 4.0 * B_s * H * dh * band
    print(f"(b) windowed chunked attention bf16 ({B_s}, {T_s}, {H}, {KV}, {dh}): max|a-b|/max|b| {gap:.3e} "
          f"(limit 2e-2); {ms:.3f} ms a call, {flops / 1e12:.3f} TFLOP of the window band (f32 bound "
          f"{1e3 * flops / PEAK_FP32_FLOPS:.3f} ms)  [{card}]")
    if gap > 2e-2:
        raise AssertionError(f"(b) bf16 windowed attention parts from the oracle by {gap:.3e} of its scale")
    del q, k, v, got, want

    # (c) the ring: 2112 tokens teacher-forced through decode_step (the ring
    # of 2048 wraps at 2048) against forward_train, f32, depth 5 (one unit
    # and the tail), batch 1; then a control with the window at 4096.
    n_ring = 2112
    cfg5 = get_config("recurrentgemma-9b", n_layers=5, compute_dtype="float32")
    model5 = T.init_params(cfg5, generator=torch.Generator(device=dev).manual_seed(seed))
    toks = tokens[:1, :n_ring]
    t0 = time.perf_counter()
    full, _, _ = T.forward_train(model5, {"tokens": toks}, cfg5, ctx)
    sync()
    fwd_s = time.perf_counter() - t0

    def ring_gaps(c):
        cache = T.init_cache(c, 1, n_ring, device=dev)
        diff = torch.zeros(n_ring, device=dev)
        for t in range(n_ring):
            lg, cache = T.decode_step(model5, cache, toks[:, t : t + 1], t, c, ctx)
            diff[t] = (lg[0, 0] - full[0, t]).abs().max()
        return diff

    scale = float(full.abs().max())
    wrap = float(full[:, W:].abs().max())
    t0 = time.perf_counter()
    diff = ring_gaps(cfg5)
    sync()
    dec_s = time.perf_counter() - t0
    all_gap, wrap_gap = float(diff.max()) / scale, float(diff[W:].max()) / wrap
    control = float(ring_gaps(dataclasses.replace(cfg5, window=2 * W))[W:].max()) / wrap
    print(f"(c) ring, f32 at depth 5: forward_train {fwd_s:.3f} s, {n_ring} decode steps {dec_s:.3f} s; logits "
          f"max|a-b|/max|b| {all_gap:.3e} over all positions, {wrap_gap:.3e} over positions >= {W} (limit 1e-4); "
          f"control, the decode at window {2 * W}: {control:.3e} over positions >= {W} (must exceed 1e-4)  [{card}]")
    if not (all_gap <= 1e-4 and wrap_gap <= 1e-4 and control > 1e-4):
        raise AssertionError(f"(c) ring decode gaps {all_gap:.3e} / {wrap_gap:.3e}, control {control:.3e}")
    del model5, full
    torch.cuda.empty_cache()

    # (d) greedy decode: RG-LRU states and rings of local K/V
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

    def cache_bytes(max_len):
        c = T.init_cache(cfg, B_s, max_len, device="meta")
        return sum(t.numel() * t.element_size() for layer in c for t in layer.values())

    print(f"(d) greedy_generate batch {B_s}, prompt {prompt_len}, gen {gen_len}: {dec_s:.3f} s, "
          f"{B_s * gen_len / dec_s:.1f} generated tokens/s ({1e3 * dec_s / steps:.2f} ms/step)  launches {counts}; "
          f"cache {cache_bytes(steps) / 2**20:.3f} MiB at max_len {steps}, "
          f"{cache_bytes(cfg.window) / 2**20:.3f} MiB once the rings are full  [{card}]")
    if sum(counts.values()) != 0:
        raise AssertionError(f"RecurrentGemma decode launched {counts}")
    if out.shape != (B_s, gen_len) or bool((out < 0).any() or (out >= cfg.vocab).any()):
        raise AssertionError(f"greedy_generate returned {tuple(out.shape)} or ids outside the vocab")
    print(f"row 0: {out[0].tolist()}")

    # (e) where the time goes
    busy = profiled(f"RecurrentGemma prefill {B_s} x {T_s}", lambda: prefill(served, {"tokens": tokens}), top=12)
    print(f"RecurrentGemma prefill device busy {busy:.3f} s of {prefill_s:.3f} s unprofiled "
          f"(idle share {1 - busy / prefill_s:.3f})  [{card}]")
    busy = profiled("RecurrentGemma greedy_generate, prompt 4, gen 4 (8 steps)",
                    lambda: D.greedy_generate(served, cfg, prompt[:, :4], steps=4), top=12)
    print(f"RecurrentGemma decode device busy {1e3 * busy / 8:.3f} ms per step of {1e3 * dec_s / steps:.3f} ms "
          f"unprofiled (idle share {1 - busy / 8 / (dec_s / steps):.3f})  [{card}]")
    print(f"recurrentgemma-9b max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{card}]")
    del served
    torch.cuda.empty_cache()


# The Markov table of the token pipeline (data/tokens.py) is vocab x vocab
# f64: 184 GB at qwen3-1.7b's vocab of 151,936 and 8.6 GB at the 100m
# scale's 32,768.  The training phases draw their streams from the
# reference's table over the first DATA_VOCAB ids (TrainerConfig.data_vocab).
DATA_VOCAB = 8192


def flash_grad_check(tag, shape, dtype, seed: int, card: str) -> dict:
    """The autograd Function of flash attention (``ops.FlashAttentionFn``:
    the kernel forward, the plain ``attention_bwd_ref`` backward) against
    ``torch.autograd.grad`` of the plain ``attention_ref`` on the same
    inputs: max|Δ| of dq, dk and dv within 2e-2 of each one's max in bf16
    (the two forwards' outputs differ by a bf16 ulp, which enters
    rowsum(dO∘O), and each gradient is rounded to bf16), 1e-4 in f32.  The
    raw wrapper must raise on inputs that require grad.  Times forward plus
    backward for the Function, the plain version and
    scaled_dot_product_attention; returns the numbers."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops

    dev = torch.device("cuda")
    B, T_len, H, KV, dh = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, T_len, n, dh), generator=g, device=dev).to(dtype) for n in (H, KV, KV))
    do = torch.randn((B, T_len, H, dh), generator=g, device=dev).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dispatch.launch_counts()["flash_attention"]
    out = fa_ops.flash_attention(*leaves)
    if dispatch.launch_counts()["flash_attention"] != before + 1 or out.grad_fn is None:
        raise AssertionError(f"flash grad {tag}: the differentiable call did not launch the kernel once")
    got = torch.autograd.grad(out, leaves, do)
    want = torch.autograd.grad(fa_ops.flash_attention(*plain, impl="torch_ref"), plain, do)
    torch.cuda.synchronize()
    band = 2e-2 if dtype == torch.bfloat16 else 1e-4
    shares = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        if a.dtype != dtype or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"flash grad {tag}: {name} is {a.dtype} or not finite")
        shares[name] = float((a.float() - b.float()).abs().max() / b.float().abs().max())
    try:
        fa_kernel.flash_attention_cuda(*leaves, causal=True, scale=dh ** -0.5)
    except RuntimeError as e:
        if "no gradient" not in str(e):
            raise
    else:
        raise AssertionError("flash_attention_cuda ran on inputs that require grad")

    def fwd_bwd(impl):
        return lambda: torch.autograd.grad(fa_ops.flash_attention(*leaves, impl=impl), leaves, do)

    qh, kh, vh = (t.detach().transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib():
        return torch.autograd.grad(sdpa(qh, kh, vh, is_causal=True, enable_gqa=True), (qh, kh, vh), doh)

    peak = 989e12 if dtype == torch.bfloat16 else 67e12
    fwd_ops = 4.0 * B * H * dh * (T_len * (T_len + 1) / 2)
    esize = 2 if dtype == torch.bfloat16 else 4
    fwd_bytes = esize * (2 * B * T_len * H * dh + 2 * B * T_len * KV * dh)
    # backward: five products of one recompute (2.5 x the forward's); reads
    # q, k, v, o, dO, writes dq, dk, dv
    bwd_bytes = esize * (3 * B * T_len * H * dh + 2 * B * T_len * KV * dh + B * T_len * H * dh
                         + 2 * B * T_len * KV * dh)
    res = {
        "shape": [B, T_len, T_len, H, KV, dh], "dtype": str(dtype)[6:], "grad_err_share": shares,
        "fwd_bwd_ms": cuda_ms(fwd_bwd("auto"), 10),
        "plain_fwd_bwd_ms": cuda_ms(fwd_bwd("torch_ref"), 3),
        "sdpa_fwd_bwd_ms": cuda_ms(lib, 10),
        "fwd_ms": cuda_ms(lambda: fa_ops.flash_attention(q, k, v), 10),
        "fwd_bound_ms": 1e3 * max(fwd_ops / peak, fwd_bytes / 3.35e12),
        "bwd_bound_ms": 1e3 * max(2.5 * fwd_ops / peak, bwd_bytes / 3.35e12),
    }
    res["bwd_ms"] = res["fwd_bwd_ms"] - res["fwd_ms"]
    print(f"flash grad {tag}: (B,T,S,H,KV,dh)={tuple(res['shape'])} {res['dtype']}  max|d-d_plain|/max|d_plain| "
          f"{ {k: f'{v:.2e}' for k, v in shares.items()} } (band {band:g}); fwd+bwd {res['fwd_bwd_ms']:.3f} ms "
          f"(fwd {res['fwd_ms']:.3f}, bwd {res['bwd_ms']:.3f}), plain {res['plain_fwd_bwd_ms']:.3f} ms, "
          f"sdpa fwd+bwd {res['sdpa_fwd_bwd_ms']:.3f} ms; bounds fwd {res['fwd_bound_ms']:.3f} ms, "
          f"bwd {res['bwd_bound_ms']:.3f} ms  [{card}]")
    if max(shares.values()) > band:
        raise AssertionError(f"flash grad {tag}: gradients differ from the plain ones beyond {band:g}: {shares}")
    return res


def dense_param_count(cfg) -> int:
    """The parameters of an attn_mlp model (with its frontend) from its
    config's widths."""
    d, H, KV, dh, f, V, K = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab,
                             max(cfg.num_codebooks, 1))
    attn = d * dh * (2 * H + 2 * KV) + (dh * (H + 2 * KV) if cfg.qkv_bias else 0) + (2 * dh if cfg.qk_norm else 0)
    mlp = (2 if cfg.mlp_act == "gelu" else 3) * d * f
    head = 0 if cfg.tie_embeddings else d * V * K
    return cfg.n_layers * (attn + mlp + 2 * d) + K * V * d + head + d


def serve_frontends(seed: int, card: str) -> dict:
    """Phase "serve frontends": musicgen-large (4 codebook streams) and
    internvl2-1b (256 prefix embeddings) at full width and depth, drawn as
    the serving launcher draws them (bf16 matmul weights); a 4 x 2048
    prefill through the kernel, profiled; greedy decode; decode against the
    teacher-forced forward_train in f32 at depth 4.  Returns each prefill's
    flash launches."""
    import dataclasses

    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.serve import decode as D

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    launches = {}
    for arch, n_text in (("musicgen-large", 2048), ("internvl2-1b", 1792)):
        cfg = get_config(arch)
        g = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.reset_peak_memory_stats()
        model = launch_serve.init_model(cfg, dev, seed)
        n_params = T.param_count(model)
        if n_params != dense_param_count(cfg):
            raise AssertionError(f"{arch}: {n_params} parameters, the widths give {dense_param_count(cfg)}")
        B, K, P = 4, cfg.num_codebooks, cfg.num_prefix_tokens
        shape = (B, K, n_text) if K else (B, n_text)
        batch = {"tokens": torch.randint(0, cfg.vocab, shape, generator=g, device=dev)}
        if P:
            batch["prefix_embeds"] = torch.randn((B, P, cfg.d_model), generator=g, device=dev).bfloat16()
        prefill = D.make_prefill_fn(cfg, T.ModelContext())
        prefill(model, {k: t[..., :64] if k == "tokens" else t for k, t in batch.items()})  # warm-up
        sync()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(model, batch)
        sync()
        secs = time.perf_counter() - t0
        counts = dispatch.launch_counts()
        launches[arch] = counts["flash_attention"]
        n_tok = B * (P + n_text)
        want = (B, 1, K, cfg.vocab) if K else (B, 1, cfg.vocab)
        print(f"{arch}: {n_params:,} parameters ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
              f"over {cfg.n_kv_heads}); prefill {B} x {P} + {n_text}: {secs:.3f} s ({n_tok / secs:.0f} tokens/s), "
              f"launches {counts}, logits {tuple(logits.shape)}  [{card}]")
        if counts["flash_attention"] != cfg.n_layers or tuple(logits.shape) != want:
            raise AssertionError(f"{arch}: prefill launched flash {counts['flash_attention']} times "
                                 f"(expected {cfg.n_layers}), logits {tuple(logits.shape)} (expected {want})")
        if not bool(torch.isfinite(logits).all()) or cache[0]["k"].shape[1] != P + n_text:
            raise AssertionError(f"{arch}: prefill logits not finite or a cache of {cache[0]['k'].shape[1]} positions")
        del cache
        busy = profiled(f"{arch} prefill", lambda: prefill(model, batch), top=6)
        print(f"{arch} prefill device busy {busy:.3f} s of {secs:.3f} s unprofiled (idle share "
              f"{1 - busy / secs:.3f})")
        prompt = batch["tokens"][..., :16].contiguous()
        dispatch.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        out = D.greedy_generate(model, cfg, prompt, steps=32)
        sync()
        dec = time.perf_counter() - t0
        print(f"{arch} greedy_generate batch {B}, prompt 16, gen 32: {1e3 * dec / 48:.2f} ms/step over 48 steps, "
              f"launches {dispatch.launch_counts()}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
        if out.shape != (B, 32) or bool((out < 0).any() or (out >= cfg.vocab).any()):
            raise AssertionError(f"{arch}: greedy_generate returned {tuple(out.shape)} or ids outside the vocab")
        del model
        # The twin of tests/test_models_smoke.py:142 at full width, depth 4, f32.
        cfg4 = dataclasses.replace(cfg, n_layers=4, compute_dtype="float32")
        m4 = T.init_params(cfg4, generator=torch.Generator(device=dev).manual_seed(seed))
        n = 64
        toks = torch.randint(0, cfg.vocab, (1, K, n) if K else (1, n), generator=g, device=dev)
        full, _, _ = T.forward_train(m4, {"tokens": toks}, cfg4, T.ModelContext())
        cache = T.init_cache(cfg4, 1, n, device=dev)
        steps = []
        for t in range(n):
            lg, cache = T.decode_step(m4, cache, toks[..., t : t + 1], t, cfg4, T.ModelContext())
            steps.append(lg[:, 0])
        stepped = torch.stack(steps, dim=1)
        gap = float((stepped - full).abs().max())
        print(f"{arch} decode vs teacher-forced forward_train, f32, depth 4, {n} tokens: max|a-b| {gap:.3e}, "
              f"of the scale {gap / float(full.abs().max()):.3e} (band: rtol 2e-2, atol 2e-2)")
        if not bool(((stepped - full).abs() <= 2e-2 + 2e-2 * full.abs()).all()):
            raise AssertionError(f"{arch}: decode parts from the teacher-forced forward beyond the 2e-2 band")
        del m4, cache
    return launches


def _train_loop(trainer, state, sync, label, card, start_step=0):
    """Run the trainer's loop on ``state``, timing each step on the host
    clock (the card synchronised) and reading its flash launches; returns
    (state, rows)."""
    from repro_torch.kernels import dispatch

    rows = []
    tokens = trainer.tcfg.num_groups * trainer.plan.shards_per_group * trainer.tcfg.microbatch * trainer.tcfg.seq_len
    sync()
    dispatch.reset_launch_counts()
    last = [time.perf_counter()]

    def on_step(step, rec):
        sync()
        now = time.perf_counter()
        flash = dispatch.launch_counts()["flash_attention"]
        row = dict(step=step, seconds=now - last[0], flash=flash, loss=rec["loss"], stragglers=rec["stragglers"],
                   host_solves=rec["host_solves"], grad_norm=rec["grad_norm"])
        rows.append(row)
        print(f"{label} step {step}: {row['seconds']:.3f} s, {tokens / row['seconds']:.0f} tokens/s, flash launches "
              f"{flash}, stragglers {rec['stragglers']}, host solves {rec['host_solves']}, loss {rec['loss']!r}, "
              f"grad_norm {rec['grad_norm']:.4f}  [{card}]")
        dispatch.reset_launch_counts()
        last[0] = time.perf_counter()

    state = trainer.run(state, start_step=start_step, on_step=on_step)
    return state, rows


def roofline_line(tag: str, cfg, cell, analysis: dict, measured_s: float, launches: int, card: str):
    """Print the roofline of one call from its op-level analysis
    (``launch.op_analysis.analyze``) against its measured seconds:
    ``model_flops``, the op count's FLOPs and bytes, the report's dominant
    term and ``roofline_fraction``, the measured call's share of the
    card's dense bf16 peak; the flash launches the analysis counted must
    equal the launch counter's."""
    from repro_torch.launch import roofline

    mf = roofline.model_flops(cfg, cell)
    rep = roofline.roofline_terms(cfg.name, cell.name, "(1,)", 1, analysis, mf)
    counted = analysis["kernel_ops"].get("flash_attention", 0)
    print(f"{tag} roofline: model_flops {mf['model_flops']:.4e} (active parameters {mf['active_params']:,}); "
          f"op count {analysis['flops']:.4e} FLOPs ({ {k: f'{v:.3e}' for k, v in analysis['flops_by_op'].items()} }), "
          f"{analysis['bytes']:.4e} bytes unfused, {analysis['dot_ops']} matmul and kernel ops; terms compute "
          f"{1e3 * rep.compute_s:.3f} ms, memory {1e3 * rep.memory_s:.3f} ms, collective "
          f"{1e3 * rep.collective_s:.3f} ms: dominant {rep.dominant}, roofline_fraction "
          f"{rep.roofline_fraction:.4f}; measured {measured_s:.4f} s, {mf['model_flops'] / measured_s / 1e12:.1f} "
          f"TF/s = {mf['model_flops'] / measured_s / roofline.HW['peak_flops']:.4f} of 989 TF/s; flash launches "
          f"counted {counted}, by the launch counter {launches}  [{card}]")
    if counted != launches:
        raise AssertionError(f"{tag}: the analysis counted {counted} flash calls, the kernel launched {launches}")
    return rep


def train_full_width(seed: int, card: str) -> dict:
    """Phase "train full width": qwen3-1.7b at full width and depth (f32
    parameters, bf16 compute) through the Trainer's host path: 4 groups, 4
    shards, redundancy 2 (cyclic), microbatch 1, seq_len 512, 8 steps under
    the deadline scenario; each step's seconds, tokens/s, flash launches
    (one a layer) and loss; two more steps profiled (busy time, idle share);
    the peak memory; every parameter's .grad after one backward; and one
    step's gradient through the kernel against the plain attention at two
    layers of that width in f32."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.launch import op_analysis
    from repro_torch.launch.specs import ShapeCell
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    sync = torch.cuda.synchronize
    cfg = get_config("qwen3-1.7b")
    tcfg = TrainerConfig(num_groups=4, num_shards=4, redundancy=2, scheme="cyclic", microbatch=1, seq_len=512,
                         steps=8, seed=seed, straggler_scenario="deadline", data_vocab=DATA_VOCAB)
    n = dense_param_count(cfg)
    print(f"qwen3-1.7b: {n:,} parameters; predicted peak: f32 parameters, m, v and gradients "
          f"{16 * n / 1e9:.1f} GB, bf16 weight copies saved for the backward {2 * n / 1e9:.1f} GB, logits "
          f"(4096, {cfg.vocab}) bf16 + f32 + log-softmax + its gradient "
          f"{4096 * cfg.vocab * (2 + 4 + 4 + 4) / 1e9:.1f} GB, activations about 10 GB: 50-60 GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, tcfg, AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=8), device="cuda")
    state, _ = trainer.init_state()
    sync()
    print(f"trainer and state on the card: {time.perf_counter() - t0:.3f} s; batch "
          f"{trainer.pipeline.batch_shape} a step")
    report = trainer.warmup(state)
    print(f"warm-up (one forward + backward, discarded): {report.seconds:.3f} s, errors {report.errors}")
    if report.errors:
        raise AssertionError("train full width: the warm-up step failed")
    state, rows = _train_loop(trainer, state, sync, "qwen3-1.7b", card)
    if len(rows) != tcfg.steps or any(r["flash"] != cfg.n_layers for r in rows):
        raise AssertionError(f"train full width: {len(rows)} steps, flash launches {[r['flash'] for r in rows]} "
                             f"(expected {cfg.n_layers} a step)")
    if not all(np.isfinite(r["loss"]) for r in rows) or sum(r["stragglers"] for r in rows) == 0:
        raise AssertionError("train full width: a loss is not finite, or no step had a straggler")
    peak = torch.cuda.max_memory_allocated() / 1e9
    mean_s = float(np.mean([r["seconds"] for r in rows[1:]]))
    print(f"qwen3-1.7b: mean step {mean_s:.3f} s over steps 1-7; peak memory {peak:.2f} GB  [{card}]")
    batch = trainer._batch(0, np.ones(4, dtype=np.float32))
    busy = [profiled(f"train step {i}", lambda: trainer._step_fn(state, batch), top=8) for i in range(2)]
    print(f"train step device busy {busy[0]:.3f} s, {busy[1]:.3f} s of {mean_s:.3f} s unprofiled (idle share "
          f"{1 - busy[1] / mean_s:.3f})")
    # One more step, untimed, under the op-level analysis: the roofline.
    dispatch.reset_launch_counts()
    analysis = op_analysis.analyze(trainer._step_fn, state, batch)
    sync()
    roofline_line("train step", cfg, ShapeCell("train_8x512", tcfg.seq_len, 8, "train"), analysis, mean_s,
                  dispatch.launch_counts()["flash_attention"], card)
    # Every parameter's .grad after one backward.
    loss, _ = T.loss_fn(state.params, batch, cfg, trainer.ctx)
    loss.backward()
    missing = [name for name, p in state.params.named_parameters() if p.grad is None or not bool(p.grad.any())]
    print(f"after one backward: {sum(1 for _ in state.params.parameters()) - len(missing)} of "
          f"{sum(1 for _ in state.params.parameters())} parameters hold a nonzero .grad")
    if missing:
        raise AssertionError(f"train full width: no gradient for {missing[:8]}")
    del state, trainer, loss
    torch.cuda.empty_cache()
    # One step's gradient: the kernel against the plain attention, 2 layers, f32.
    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    model = T.init_params(cfg2, generator=torch.Generator(device="cuda").manual_seed(seed))
    grads = {}
    for impl in ("auto", "torch_ref"):
        loss, _ = T.loss_fn(model, batch, cfg2, T.ModelContext(attn_impl=impl))
        names, params = zip(*model.named_parameters())
        grads[impl] = dict(zip(names, torch.autograd.grad(loss, params)))
    top = max(float(g.abs().max()) for g in grads["torch_ref"].values())
    worst = max((float((grads["auto"][k] - g).abs().max()) / max(float(g.abs().max()), 1e-5 * top), k)
                for k, g in grads["torch_ref"].items())
    print(f"one step's gradient at 2 layers of qwen3-1.7b's width, f32, kernel vs plain attention: worst "
          f"max|a-b| / max|b| {worst[0]:.3e} ({worst[1]}); band 1e-4")
    if worst[0] > 1e-4:
        raise AssertionError(f"train full width: gradients through the kernel differ by {worst[0]:.3e}")
    return {"flash_per_step": rows[0]["flash"], "mean_step_s": mean_s, "peak_gb": peak}


def train_100m(seed: int, card: str) -> dict:
    """Phase "train 100m": the launcher's 100m scale (qwen3-4b's family at
    d_model 768, 12 layers): 30 steps under the deadline scenario with a
    checkpoint every 10, the loss must fall (the twin of
    tests/test_training.py:298); then 15 steps, an interrupt, and a resume
    from the checkpoint to step 30 (its straggler stream advanced past the
    15 steps taken): its losses against the uninterrupted run's."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.launch.serve import scaled_config
    from repro_torch.train.checkpoint import list_checkpoints
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    sync = torch.cuda.synchronize
    cfg = scaled_config("qwen3-4b", "100m")
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=4, total_steps=30)
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(steps, every, sub):
            return Trainer(cfg, TrainerConfig(num_groups=4, num_shards=4, redundancy=2, microbatch=2, seq_len=128,
                                              steps=steps, ckpt_every=every, ckpt_dir=f"{tmp}/{sub}", seed=seed,
                                              straggler_deadline=1.6, data_vocab=DATA_VOCAB), ocfg, device="cuda")

        whole = trainer(30, 10, "a")
        state, _ = whole.init_state()
        whole.warmup(state)
        print(f"100m ({cfg.d_model} wide, {cfg.n_layers} layers, vocab {cfg.vocab}): "
              f"{sum(p.numel() for p in state.params.parameters()):,} parameters")
        t0 = time.perf_counter()
        _, rows = _train_loop(whole, state, sync, "100m", card)
        secs = time.perf_counter() - t0
        losses = [r["loss"] for r in rows]
        first, last = float(np.mean(losses[:8])), float(np.mean(losses[-8:]))
        print(f"100m: 30 steps in {secs:.3f} s (checkpoints {list_checkpoints(f'{tmp}/a')}); mean loss of the "
              f"first 8 steps {first:.4f}, of the last 8 {last:.4f}  [{card}]")
        if not last < first - 0.01 or sum(r["stragglers"] for r in rows) == 0:
            raise AssertionError("train 100m: the loss did not fall, or no step had a straggler")
        trainer(15, 15, "b").run()
        resumed = trainer(30, 15, "b")
        for _ in range(15):
            next(resumed.scenario)
        state, start = resumed.init_state()
        resumed.warmup(state)
        if start != 15:
            raise AssertionError(f"train 100m: resumed at step {start}, not 15")
        _, rows_r = _train_loop(resumed, state, sync, "100m resumed", card, start_step=start)
        a, b = losses[15:], [r["loss"] for r in rows_r]
        worst = max(abs(x - y) / abs(x) for x, y in zip(a, b))
        print(f"100m interrupt at 15 and resume: {len(b)} steps; losses equal to the bit {a == b}; worst "
              f"relative gap {worst:.3e}")
        if len(b) != 15 or worst > 1e-3:
            raise AssertionError(f"train 100m: the resumed run's losses part from the uninterrupted run's ({worst:.3e})")
    return {"flash_per_step": rows[0]["flash"], "bitwise_resume": a == b}


def _grad_gap(got: dict, want: dict) -> tuple:
    """The worst max|a-b| / max|b| over the gradients (each floored at 1e-5
    of the largest max|b|), its parameter, and whether all are equal."""
    import torch

    top = max(float(w.abs().max()) for w in want.values())
    worst = max((float((got[n] - w).abs().max()) / max(float(w.abs().max()), 1e-5 * top), n)
                for n, w in want.items())
    return worst[0], worst[1], all(torch.equal(got[n], w) for n, w in want.items())


def train_device_recovery(seed: int, card: str, host_step_s: float) -> dict:
    """Phase "train device recovery": the trainer's mesh-native path
    (``device_recovery=True``: the groups' gradients combined by the
    executor with the recovery solved on the card, the token pools
    resident) at qwen3-1.7b's full width and depth, f32 master weights,
    bf16 compute: FR over 4 groups and 4 shards, redundancy 2, microbatch
    1, seq_len 512, two resident step batches and one headroom slot a
    group.  A trace of 6 distinct coverage-preserving patterns and then one
    that loses a shard; the δ = 0 claim (one straggler against all alive
    from one state) at full width and at 2 layers in f32; the same step
    through the mesh executor over a world of one over NCCL; an elastic
    patch at the launcher's 100m scale."""
    import dataclasses
    import itertools
    import json as _json
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import device_recovery_masked
    from repro_torch.kernels import dispatch
    from repro_torch.launch import distributed as mesh_dist
    from repro_torch.launch.serve import scaled_config
    from repro_torch.models.registry import get_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    cfg = get_config("qwen3-1.7b")
    G = 4
    tmp = tempfile.TemporaryDirectory()

    def trace(name, rows):
        path = f"{tmp.name}/{name}.jsonl"
        with open(path, "w") as f:
            f.writelines(_json.dumps({"alive": [int(x) for x in r]}) + "\n" for r in rows)
        return path

    def tcfg(steps, path, **over):
        kw = dict(num_groups=G, num_shards=4, redundancy=2, scheme="fr", microbatch=1, seq_len=512, steps=steps,
                  seed=seed, straggler_scenario="trace", scenario_kwargs={"path": path}, device_recovery=True,
                  resident_steps=2, patch_headroom=1, data_vocab=DATA_VOCAB)
        kw.update(over)
        return TrainerConfig(**kw)

    def grads32(stats):
        return {n: g.float() for n, g in stats["grads"].items()}

    # The trace: 6 distinct patterns that keep every shard, then one that does not.
    from repro_torch.train.resilient import make_plan

    A = make_plan(G, 4, redundancy=2, scheme="fr", session_kwargs={"device": "cpu"}).assignment.matrix
    covering = [np.array(p, dtype=bool) for p in itertools.product([1, 0], repeat=G)
                if any(p) and (A[np.array(p, dtype=bool)].sum(axis=0) > 0).all()]
    losing = next(np.array(p, dtype=bool) for p in itertools.product([1, 0], repeat=G)
                  if any(p) and not (A[np.array(p, dtype=bool)].sum(axis=0) > 0).all())
    rows = covering[:6] + [losing]
    print(f"FR assignment (groups x shards) {A.tolist()}; trace: {[r.astype(int).tolist() for r in rows]}")

    # The device solve alone: its launches (one profile) and its time per pattern.
    A32 = torch.from_numpy(A.astype(np.float32)).to(dev)
    device_recovery_masked(A32, torch.from_numpy(rows[0]).to(dev), iters=300, device=dev)
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        device_recovery_masked(A32, torch.from_numpy(rows[1]).to(dev), iters=300, device=dev)
        sync()
    solve_launches = sum(n for _, _, n in device_activity(prof))
    solve_ms = [cuda_ms(lambda r=r: device_recovery_masked(A32, torch.from_numpy(r).to(dev), iters=300,
                                                           device=dev), 5) for r in rows]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, tcfg(len(rows), trace("main", rows)), AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=8),
                      device="cuda")
    state, _ = trainer.init_state()
    sync()
    C = trainer._capacity
    print(f"trainer and state on the card: {time.perf_counter() - t0:.3f} s; resident pool "
          f"{tuple(trainer._res_tokens.shape)} {trainer._res_tokens.dtype} ({C} slots a group, "
          f"{int(trainer._res_valid.sum())} valid), validity {trainer._res_valid.tolist()}")
    report = trainer.warmup(state)
    print(f"warm-up (step 0's recovered statistics, discarded): {report.seconds:.3f} s, errors {report.errors}")
    if report.errors:
        raise AssertionError("train device recovery: the warm-up failed")
    tokens = 8 * 512  # valid tokens a step: 4 groups x 2 shards x 1 x 512
    out_rows = []
    sync()
    dispatch.reset_launch_counts()
    last = [time.perf_counter()]

    def on_step(step, rec):
        sync()
        now = time.perf_counter()
        flash = dispatch.launch_counts()["flash_attention"]
        row = dict(step=step, seconds=now - last[0], flash=flash, **{k: rec[k] for k in (
            "loss", "stragglers", "fallback", "b_sum", "host_solves", "device_solves")})
        out_rows.append(row)
        print(f"device recovery step {step}: alive {rows[step].astype(int).tolist()}, {row['seconds']:.3f} s, "
              f"{tokens / row['seconds']:.0f} tokens/s, flash launches {flash}, device solve "
              f"{solve_ms[step]:.3f} ms in {solve_launches} launches (alone), device_solves "
              f"{rec['device_solves']}, host_solves {rec['host_solves']}, fallback {rec['fallback']}, b_sum "
              f"{rec['b_sum']!r}, loss {rec['loss']!r}  [{card}]")
        dispatch.reset_launch_counts()
        last[0] = time.perf_counter()

    state = trainer.run(state, on_step=on_step)
    peak = torch.cuda.max_memory_allocated() / 1e9
    covered_rows = out_rows[:-1]
    mean_s = float(np.mean([r["seconds"] for r in covered_rows[1:]]))
    print(f"device path: mean step {mean_s:.3f} s over steps 1-5 ({tokens / mean_s:.0f} tokens/s), the host path "
          f"(phase \"train full width\") {host_step_s:.3f} s; peak memory {peak:.2f} GB  [{card}]")
    want_flash = G * cfg.n_layers
    if len(out_rows) != len(rows) or any(r["flash"] != want_flash for r in out_rows):
        raise AssertionError(f"train device recovery: flash launches {[r['flash'] for r in out_rows]}, "
                             f"expected {want_flash} a step (a forward a group)")
    if any(r["host_solves"] != 0 or r["fallback"] for r in covered_rows) or \
            [r["device_solves"] for r in covered_rows] != list(range(1, 7)):
        raise AssertionError(f"train device recovery: the covered steps host-solved or missed the device solve: "
                             f"{covered_rows}")
    if out_rows[-1]["host_solves"] != 1 or not out_rows[-1]["fallback"] or out_rows[-1]["device_solves"] != 6:
        raise AssertionError(f"train device recovery: the uncovered step: {out_rows[-1]}")
    if not all(np.isfinite(r["loss"]) for r in out_rows):
        raise AssertionError("train device recovery: a loss is not finite")

    # δ = 0 at full width: from one state, one straggler against all alive.
    alive_all, alive_one = rows[0], next(r for r in covering if (~r).sum() == 1)
    stats, _ = trainer._recovered_stats(state, 0, alive_all)
    g_all = grads32(stats)
    del stats
    stats, b_one = trainer._recovered_stats(state, 0, alive_one)
    gap, where, equal = _grad_gap(grads32(stats), g_all)
    del stats
    print(f"δ = 0 at full width (bf16 compute): alive {alive_one.astype(int).tolist()} (b {b_one.tolist()}) "
          f"against all alive: worst max|a-b|/max|b| {gap:.3e} ({where}), equal to the bit {equal}; band 2e-2")
    if gap > 2e-2:
        raise AssertionError(f"train device recovery: the δ = 0 gradients part by {gap:.3e}")

    # The same step through the mesh executor, a world of one over NCCL.
    ex = mesh_dist.MeshExecutor(mesh_dist.node_mesh(backend="nccl", device=dev))
    try:
        blocks = (ex.place_node_stacked(trainer._res_tokens, dev), ex.place_node_stacked(trainer._res_valid, dev))
        stats, _ = ex.resilient_reduce_masked(trainer._group_fn, blocks, (state.params, 0), A.astype(np.float32),
                                              alive_all, iters=trainer.plan.session.device_iters)
        gap_m, where_m, equal_m = _grad_gap(grads32(stats), g_all)
        del stats, blocks
        print(f"{ex.describe()} against the local executor at full width: worst {gap_m:.3e} ({where_m}), equal "
              f"to the bit {equal_m}")
        if gap_m > 2e-2:
            raise AssertionError(f"train device recovery: the mesh's gradients part by {gap_m:.3e}")
        del g_all
        # One step profiled: device busy against the unprofiled step.
        busy = profiled("device recovery step", lambda: trainer._device_recovery_step(state, 7, alive_one), top=10)
        print(f"device recovery step busy {busy:.3f} s of {mean_s:.3f} s unprofiled (idle share "
              f"{1 - busy / mean_s:.3f})  [{card}]")
        del state, trainer
        torch.cuda.empty_cache()

        # 2 layers of that width in f32: δ = 0 within 1e-5, the mesh within 1e-6 (or to the bit).
        cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
        ocfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=2)
        path2 = trace("two", [alive_one, alive_all])
        small = {name: Trainer(cfg2, tcfg(2, path2, executor=name), ocfg, device="cuda")
                 for name in ("local", "mesh")}
        states = {name: t.init_state()[0] for name, t in small.items()}
        stats, _ = small["local"]._recovered_stats(states["local"], 0, alive_all)
        g_all = grads32(stats)
        stats, _ = small["local"]._recovered_stats(states["local"], 0, alive_one)
        gap2, where2, equal2 = _grad_gap(grads32(stats), g_all)
        stats, _ = small["mesh"]._recovered_stats(states["mesh"], 0, alive_one)
        g_mesh = grads32(stats)
        stats, _ = small["local"]._recovered_stats(states["local"], 0, alive_one)
        gap_m2, where_m2, equal_m2 = _grad_gap(g_mesh, grads32(stats))
        del stats
        for name, t in small.items():
            states[name] = t.run(states[name])
        with torch.no_grad():
            p_gap = max(float((a - b).abs().max()) for a, b in zip(states["local"].params.parameters(),
                                                                     states["mesh"].params.parameters()))
        print(f"2 layers of that width, f32: δ = 0 worst {gap2:.3e} ({where2}), equal to the bit {equal2} "
              f"(band 1e-5); {small['mesh'].plan.session.executor.describe()} against the local executor "
              f"worst {gap_m2:.3e} ({where_m2}), equal to the bit {equal_m2} (band 1e-6); after 2 steps the "
              f"parameters part by {p_gap:.3e}")
        if gap2 > 1e-5 or gap_m2 > 1e-6:
            raise AssertionError(f"train device recovery: at 2 layers in f32 δ = 0 parts by {gap2:.3e}, the mesh "
                                 f"by {gap_m2:.3e}")
        del small, states, g_all, g_mesh
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # The elastic patch at the launcher's 100m scale: cyclic over 6 groups,
    # groups 4 and 5 straggling for good.
    cfg_e = scaled_config("qwen3-4b", "100m")
    te = Trainer(cfg_e, tcfg(6, trace("elastic", [[1, 1, 1, 1, 0, 0]] * 8), num_groups=6, num_shards=6,
                             scheme="cyclic", seq_len=128, elastic_patience=2, patch_headroom=2),
                 AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=6), device="cuda")
    t0 = time.perf_counter()
    te.run()
    sync()
    s = te.plan.session.stats
    print(f"elastic 100m ({cfg_e.d_model} wide, {cfg_e.n_layers} layers): 6 steps in "
          f"{time.perf_counter() - t0:.3f} s; fallback by step {[h['fallback'] for h in te.history]}; "
          f"elastic_patches {s.elastic_patches}, moved_node_blocks {s.moved_node_blocks}, full_repacks "
          f"{s.full_repacks}, host_solves {s.host_solves}, device_solves {s.device_solves}; losses "
          f"{[round(h['loss'], 4) for h in te.history]}  [{card}]")
    if not (s.elastic_patches >= 1 and s.moved_node_blocks >= 1 and s.full_repacks == 0
            and te.history[-1]["fallback"] is False):
        raise AssertionError(f"train device recovery: the elastic run {s.as_dict()}")
    del te
    tmp.cleanup()
    torch.cuda.empty_cache()
    return {"flash_per_step": out_rows[0]["flash"], "mean_step_s": mean_s, "peak_gb": peak,
            "solve_ms": float(np.mean(solve_ms)), "solve_launches": solve_launches}


def state_fingerprint(state) -> str:
    """A hash of every parameter's and moment's bits, summed on the card:
    for each tensor the int64 sums of its 32-bit words and of every other
    word (no copy of the state leaves the card)."""
    import torch

    from repro_torch.launch.distributed import digest

    sums = []
    for name, p in state.params.named_parameters():
        for t in (p.detach(), state.opt.m[name], state.opt.v[name]):
            words = t.reshape(-1).view(torch.int32)
            sums += [words.sum(dtype=torch.int64), words[::2].sum(dtype=torch.int64)]
    return digest(torch.stack(sums).cpu())


TRAIN_MESH_BAND = 2e-2  # the bf16 band of phase "train device recovery"'s delta = 0 check at full width


def train_mesh(seed: int, card: str) -> dict:
    """Phase "train mesh": qwen3-1.7b at full width, depth cut to
    ``TRAIN_MESH_LAYERS`` (f32 parameters, bf16 compute, 8 x 512 tokens
    over 4 groups), trained on LM meshes.  The meshless oracle first: the first batch's gradient (written
    to a temporary directory with its loss and norm), then 2 meshless steps
    with a hash of every parameter and moment after each.  (a) A world of
    one over NCCL, mesh (1, 1), remat none: the same 2 steps through the
    mesh step, bit for bit (loss and hash), a flash launch a layer a step, no
    collective that moves data.  The card is then freed and (b) two gloo
    ranks on it, mesh (1, 2), and (c) four, mesh (2, 2) with FSDP over
    ``data``, each run one step under remat full
    (``launch.mesh_runs.train_mesh_rank``): two flash launches a layer,
    every gradient block within ``TRAIN_MESH_BAND`` of its parameter's
    meshless scale, the loss within 1e-5 and the grad norm within 1e-3
    relative, the moments on ``state_shardings``' blocks.  (d) In the same
    runs the state carries error-feedback buffers: each rank first
    compresses the oracle's gradient, narrowed to its blocks, through the
    mesh path, bit for bit the meshless compression of the whole tensors
    narrowed alike (``lm_head``'s straddling block and its scale printed),
    and its step compresses (``CompressionConfig()``), the buffers on
    ``state_shardings``' blocks.  (e) :func:`train_mesh_ckpt_prepare`
    before the ranks start, (c)'s ranks run ``ckpt_mesh_rank`` after their
    step, and :func:`train_mesh_ckpt_check` holds them.  Returns the
    flash launches a rank a step of each run and their shapes."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import dispatch
    from repro_torch.launch import collectives as coll
    from repro_torch.launch import distributed as mesh_dist
    from repro_torch.launch import mesh_runs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.sharding import make_context
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.train.optimizer import AdamWConfig, global_norm
    from repro_torch.train.train_step import init_train_state, make_grad_fn, make_train_step

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    cut = {"n_layers": TRAIN_MESH_LAYERS}
    cfg = get_config("qwen3-1.7b", **cut)
    n = dense_param_count(cfg)
    batches = mesh_runs.train_mesh_batches(cfg, seed, dev, 2, data_vocab=DATA_VOCAB)
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=8)
    gen = lambda: torch.Generator(device=dev).manual_seed(seed)  # noqa: E731
    plain = T.ModelContext()
    counts, shapes = {}, {}

    # The meshless oracle and 2 meshless steps.
    torch.cuda.empty_cache()
    state = init_train_state(cfg, generator=gen())
    t0 = time.perf_counter()
    loss0, _, grads = make_grad_fn(cfg, plain)(state.params, batches[0])
    norm0 = float(global_norm(grads))
    sync()
    oracle_s = time.perf_counter() - t0
    tmp = tempfile.TemporaryDirectory(prefix="repro-train-mesh-")
    oracle_path = os.path.join(tmp.name, "oracle.pt")
    t0 = time.perf_counter()
    torch.save({"grads": {k: g.cpu() for k, g in grads.items()}, "loss": float(loss0), "grad_norm": norm0,
                "top": max(float(g.abs().max()) for g in grads.values())}, oracle_path)
    print(f"meshless oracle: the first batch's gradient in {oracle_s:.3f} s, loss {float(loss0)!r}, grad norm "
          f"{norm0!r}; written in {time.perf_counter() - t0:.3f} s ({os.path.getsize(oracle_path) / 1e9:.2f} GB)"
          f"  [{card}]")
    del grads
    step = make_train_step(cfg, plain, ocfg)
    want = []
    for b in batches:
        state, m = step(state, b)
        want.append((float(m["loss"]), state_fingerprint(state)))
    del state, step, m
    torch.cuda.empty_cache()

    # (a) a world of one over NCCL
    mesh_dist.node_mesh(backend="nccl", device=dev)
    try:
        mesh = make_test_mesh((1, 1))
        state = init_train_state(cfg, generator=gen(), mesh=mesh)
        step = make_train_step(cfg, make_context(mesh), ocfg)
        coll.STATS.reset()
        got = []
        for b in batches:
            dispatch.reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            state, m = step(state, b)
            sync()
            got.append((float(m["loss"]), state_fingerprint(state), time.perf_counter() - t0,
                        dispatch.launch_counts()["flash_attention"]))
        counts["(1, 1) nccl"] = got[0][3]
        shapes["(1, 1) nccl"] = (8, 512, 512, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        same = [g[:2] == w for g, w in zip(got, want)]
        print(f"(a) mesh (1, 1), a world of one over NCCL, remat none: 2 steps {[round(g[2], 3) for g in got]} s, "
              f"flash launches {[g[3] for g in got]}, losses {[g[0] for g in got]}; loss and the hash of every "
              f"parameter and moment bit for bit the meshless steps' {same}; collectives that moved data "
              f"{coll.STATS.bytes}  [{card}]")
        if not (all(same) and all(g[3] == cfg.n_layers for g in got) and not coll.STATS.bytes):
            raise AssertionError("train mesh (a): mesh (1, 1) is not the meshless step bit for bit")
    finally:
        dist.destroy_process_group()
    del state, step, m
    torch.cuda.empty_cache()
    print(f"the card freed: {torch.cuda.memory_allocated() / 2**30:.3f} GiB held by this process")

    # (e)'s meshless checkpoint, then (b), (c): gloo ranks sharing the card,
    # remat full; (c)'s ranks then run (e).
    ckpt_tmp = tempfile.TemporaryDirectory(prefix="repro-train-mesh-ckpt-")
    prep = train_mesh_ckpt_prepare(seed, card, ckpt_tmp.name)
    for label, shape in (("(b)", (1, 2)), ("(c)", CKPT_SHAPE)):
        world = shape[0] * shape[1]
        jobs = [("card", shape, dict(seed=seed, oracle_path=oracle_path, remat="full", cfg_overrides=cut,
                                     seq_len=512, compress=True))]
        if shape == CKPT_SHAPE:
            jobs.append(("ckpt", shape, prep["job"]))
        t0 = time.perf_counter()
        out = mesh_dist.run_ranks(mesh_runs.train_lm_rank, world, backend="gloo", device="cuda", timeout=1200,
                                  args=(jobs,))
        wall = time.perf_counter() - t0
        rep = out[0]
        print(f"{label} mesh {shape}, {world} gloo ranks on the card, remat full: {wall:.3f} s from spawn to exit"
              + (", (e) on the same ranks after the step" if len(jobs) > 1 else "") + f"  [{card}]")
        MESH_RANKS[("train", shape)] = rep["ranks"]
        for r in rep["ranks"]:
            sums = r["sums"]
            print(f"{label} rank {r['coords']}: {r['params_held'] / 1e9:.3f} B parameters held (of {n / 1e9:.3f} B), "
                  f"drawn in {r['draw_s']:.3f} s; peak {r['peak_gib']:.3f} GiB; step {r['step_s']:.3f} s "
                  f"(forward + backward {r['grad_s']:.3f}, AdamW {r['update_s']:.3f}); flash launches "
                  f"{r['launches']['flash_attention']} at (B, T, S, H, KV, dh) = {r['flash_shape']}; "
                  f"collectives {sums['calls']}, "
                  f"{ {k: round(v / 2**20, 1) for k, v in sums['bytes'].items()} } MiB, "
                  f"{ {k: round(v, 3) for k, v in sums['seconds'].items()} } s; loss {r['loss']!r} (meshless "
                  f"{rep['oracle_loss']!r}), grad norm {r['grad_norm']!r} (meshless {rep['oracle_grad_norm']!r}); "
                  f"worst gradient block max|a-b|/max|b| {r['grad_gap']:.3e} ({r['grad_gap_at']}), band "
                  f"{TRAIN_MESH_BAND}; moments on state_shardings' blocks {r['moments_ok']}  [{card}]")
            bad = []
            if r["launches"]["flash_attention"] != 2 * cfg.n_layers or sum(r["launches"].values()) != 2 * cfg.n_layers:
                bad.append(f"launches {r['launches']}")
            if r["flash_shape"] != (8 // shape[0], 512, 512, cfg.n_heads // shape[1], cfg.n_kv_heads // shape[1],
                                    cfg.head_dim):
                bad.append(f"flash shape {r['flash_shape']}")
            if r["grad_gap"] > TRAIN_MESH_BAND:
                bad.append(f"gradient gap {r['grad_gap']:.3e} at {r['grad_gap_at']}")
            if abs(r["loss"] - rep["oracle_loss"]) > 1e-5 * abs(rep["oracle_loss"]):
                bad.append(f"loss {r['loss']!r}")
            if abs(r["grad_norm"] - rep["oracle_grad_norm"]) > 1e-3 * rep["oracle_grad_norm"]:
                bad.append(f"grad norm {r['grad_norm']!r}")
            if not r["moments_ok"]:
                bad.append("moments off state_shardings' blocks")
            comp, head = r["compression"], r["compression"].get("lm_head")
            print(f"(d) {shape} rank {r['coords']}: the oracle gradient's {comp['tensors']} tensors compressed "
                  f"through the mesh path in {comp['mesh_s']:.3f} s, pmax {comp['pmax']['calls']} calls "
                  f"{comp['pmax']['bytes'] / 2**20:.3f} MiB; dequantized gradient and buffer bit for bit the "
                  f"meshless compression of the whole tensors narrowed {comp['bitwise']} {comp['differ']}; "
                  + (f"lm_head's block {head['block']}, straddling: columns {head['columns']} here, scale at row "
                     f"{head['row']} {head['scale']!r} (the whole tensor's {head['whole_scale']!r}), its padded "
                     f"block {head['padded_block']}; " if head else "lm_head's blocks whole on this rank; ")
                  + f"peak {comp['peak_gib']:.3f} GiB for the check; the step compressed (CompressionConfig(), "
                  f"block 256): peak {r['peak_gib']:.3f} GiB, error-feedback buffers on state_shardings' blocks "
                  f"{r['ef_ok']}  [{card}]")
            if not comp["bitwise"]:
                bad.append(f"mesh compression differs at {comp['differ']}")
            if head is not None and head["scale"] != head["whole_scale"]:
                bad.append(f"lm_head's straddling block {head['block']}: scale {head['scale']!r}")
            if not r["ef_ok"]:
                bad.append("error-feedback buffers off state_shardings' blocks")
            if bad:
                raise AssertionError(f"train mesh {label} rank {r['coords']}: " + "; ".join(bad))
        counts[f"{shape} gloo, a rank"] = rep["ranks"][0]["launches"]["flash_attention"]
        shapes[f"{shape} gloo, a rank"] = rep["ranks"][0]["flash_shape"]
    tmp.cleanup()
    train_mesh_ckpt_check(seed, card, ckpt_tmp.name, prep, out[1])
    ckpt_tmp.cleanup()
    return {"counts": counts, "shapes": shapes}


TRAIN_MESH_LAYERS = 8  # phase "train mesh" (a)-(d): qwen3-1.7b's 28 layers cut for the script's time
CKPT_LAYERS = 2  # phase "train mesh" (e): qwen3-1.7b's depth cut for the disk and the phase's time
CKPT_STEPS = 2  # phase "train mesh" (e): the uninterrupted run's steps, the checkpoint a step before its end
CKPT_SHAPE = (2, 2)  # phase "train mesh" (e) runs on (c)'s ranks


def train_mesh_ckpt_prepare(seed: int, card: str, tmp: str) -> dict:
    """Phase "train mesh" (e), before its ranks start: qwen3-1.7b at full
    width, depth cut to ``CKPT_LAYERS``, a state with random moments and
    buffers written meshless to ``tmp``/meshless (its bytes, seconds and
    the free disk printed; the phase fails if the disk cannot hold two
    such files).  Returns the keywords of the ranks'
    ``launch.mesh_runs.ckpt_mesh_rank`` and what
    :func:`train_mesh_ckpt_check` holds them to."""
    import os
    import shutil

    import torch

    from repro_torch.launch import mesh_runs
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.models.registry import get_config
    from repro_torch.train.checkpoint import checkpoint_bytes, save_checkpoint
    from repro_torch.train.compression import CompressionConfig
    from repro_torch.train.train_step import init_train_state

    dev = torch.device("cuda")
    cut = {"n_layers": CKPT_LAYERS}
    cfg = get_config("qwen3-1.7b", **cut)
    state = init_train_state(cfg, generator=torch.Generator(device=dev).manual_seed(seed + 2),
                             compression=CompressionConfig())
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    with torch.no_grad():
        for t in list(state.opt.m.values()) + list(state.opt.v.values()) + list(state.ef.values()):
            t.copy_(torch.rand(t.shape, generator=g, device=dev))
    state = state._replace(opt=state.opt._replace(step=7))
    nbytes, free = checkpoint_bytes(state), shutil.disk_usage(tmp).free
    n = sum(p.numel() for p in state.params.parameters())
    print(f"(e) qwen3-1.7b at {CKPT_LAYERS} layers: {n:,} parameters; a checkpoint of params, m, v and ef "
          f"{nbytes / 1e9:.3f} GB; free disk under the temporary directory {free / 1e9:.3f} GB  [{card}]")
    if free < 2.05 * nbytes:
        raise AssertionError(f"train mesh (e): {free / 1e9:.3f} GB free, the two checkpoints need "
                             f"{2 * nbytes / 1e9:.3f} GB")
    specs = param_shardings(dict(state.params.named_parameters()), MeshShape(("data", "model"), CKPT_SHAPE))
    wrote = mesh_runs.narrowed_digests(state, specs, CKPT_SHAPE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(os.path.join(tmp, "meshless"), 7, state)
    print(f"(e) a meshless checkpoint written: {os.path.getsize(os.path.join(tmp, 'meshless', 'step_7.npz')):,} "
          f"bytes in {time.perf_counter() - t0:.3f} s  [{card}]")
    del state
    torch.cuda.empty_cache()
    job = dict(seed=seed, ckpt_dir=os.path.join(tmp, "mesh"), restore_dirs={"meshless": os.path.join(tmp, "meshless")},
               cfg_overrides=cut, seq_len=512, data_vocab=DATA_VOCAB, steps=CKPT_STEPS)
    return {"job": job, "cfg": cfg, "specs": specs, "wrote": wrote}


def train_mesh_ckpt_check(seed: int, card: str, tmp: str, prep: dict, rep: dict) -> None:
    """Phase "train mesh" (e), after its ranks: qwen3-1.7b at
    ``CKPT_LAYERS`` layers on (2, 2) gloo ranks with FSDP, TP and
    compression through ``Trainer(ctx=..., ckpt_dir=...)``
    (``launch.mesh_runs.ckpt_mesh_rank``, run by (c)'s ranks after their
    step): ``CKPT_STEPS`` steps uninterrupted; one fewer with a
    checkpoint, then a new trainer resumed from it runs the last: its
    losses and the digest of every block of params, m, v and ef bit for bit
    the uninterrupted run's.  The checkpoint restored meshless here,
    narrowed to each rank's blocks, must be the state the ranks saved; the
    meshless checkpoint of :func:`train_mesh_ckpt_prepare`, restored by the
    ranks, must give its narrowed blocks.  Prints the file's bytes and the
    write and read seconds."""
    import os

    import torch

    from repro_torch.launch import mesh_runs
    from repro_torch.train.checkpoint import restore_checkpoint
    from repro_torch.train.compression import CompressionConfig
    from repro_torch.train.train_step import init_train_state

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    specs, wrote = prep["specs"], prep["wrote"]
    first = CKPT_STEPS - 1
    size = os.path.getsize(os.path.join(tmp, "mesh", f"step_{first}.npz"))
    template = init_train_state(prep["cfg"], generator=torch.Generator(device=dev).manual_seed(seed + 4),
                                compression=CompressionConfig())
    sync()
    t0 = time.perf_counter()
    restored, step = restore_checkpoint(os.path.join(tmp, "mesh"), template)
    sync()
    read_s = time.perf_counter() - t0
    read = mesh_runs.narrowed_digests(restored, specs, CKPT_SHAPE)
    del restored, template
    torch.cuda.empty_cache()
    bad = []
    for r in rep["ranks"]:
        runs, c = r["runs"], tuple(r["coords"])
        whole, part, resumed = runs["whole"], runs["first"], runs["resumed"]
        losses = {k: [h["loss"] for h in run["history"]] for k, run in runs.items()}
        resume_ok = resumed["start"] == first and losses["resumed"] == losses["whole"][first:] and (
            losses["first"] == losses["whole"][:first] and resumed["digests"] == whole["digests"])
        saved_ok = part["digests"] == read[c]
        meshless = r["restored"]["meshless"]
        meshless_ok = meshless["digests"] == wrote[c] and meshless["step"] == 7
        print(f"(e) rank {c}: losses {losses['whole']} in {whole['seconds']:.3f} s; {first} steps and a checkpoint "
              f"in {part['seconds']:.3f} s, resumed at step {resumed['start']}: loss {losses['resumed']}, losses "
              f"and every block of params, m, v and ef bit for bit the uninterrupted run's {resume_ok}; "
              f"step_{first}.npz ({size:,} bytes) written in {part['history'][-1]['ckpt_write_s']:.3f} s, read "
              f"back in {resumed['read_s']:.3f} s; restored meshless here in {read_s:.3f} s: the blocks the rank "
              f"saved {saved_ok}; the meshless checkpoint read onto the mesh in {meshless['read_s']:.3f} s: its "
              f"narrowed blocks {meshless_ok}; peak {r['peak_gib']:.3f} GiB  [{card}]")
        if r["specs"] != {k: tuple(v) for k, v in specs.items()}:
            bad.append(f"rank {c}: specs differ from the parent's")
        if not (resume_ok and saved_ok and meshless_ok and step == first):
            bad.append(f"rank {c}: resume {resume_ok}, saved {saved_ok}, meshless {meshless_ok}, step {step}")
    if bad:
        raise AssertionError("train mesh (e): " + "; ".join(bad))


MESH_BAND = 2e-2  # the bf16 band of phase "serve moe"'s kernel-against-plain prefills
SEQ_DECODE_STEPS = 48  # phase "serve mesh" (b) under cache layout seq: the full oracle's decode, 24 slots a rank
# Phase "serve mesh" (b)'s feature decode: its teacher-forced steps and the
# greedy decode's generated steps (of the oracle's 32), cut for the
# script's time limit.
MESH_DECODE_STEPS = 8
GREEDY_MESH_STEPS = 4


def serve_mesh(seed: int, card: str, holder: dict, kept: dict) -> dict:
    """Phase "serve mesh": deepseek-moe-16b at full width and depth in bf16
    on LM meshes.  (a) A world of one over NCCL, mesh (1, 1), in this
    process with phase "serve moe"'s model: prefill and 8 decode steps bit
    for bit the meshless ones.  Then the meshless oracles
    (``launch.mesh_runs.moe_mesh_oracle``; its prefill must be phase "serve
    moe"'s bit for bit), and the model is freed.  (b) Two gloo ranks on the
    card, mesh (1, 2): head-parallel attention, the shared experts' d_ff
    split, 32 experts a rank.  (c) Four gloo ranks, mesh (2, 2), with FSDP:
    each data shard's MoE is the meshless MoE of its 2 rows.  Each rank draws
    only its blocks (``launch.sharding.init_sharded``), prefills its rows of
    4 x 2048 (exactly 28 flash launches), is held by the flip rule and with
    the oracle's routing replayed (``MESH_BAND`` of the logits' scale), and
    decodes teacher-forced with the routing replayed (``MESH_DECODE_STEPS``
    on (1, 2), 1
    on (2, 2), whose every step gathers each layer's experts over ``data``)
    in a cache of the oracle's slots: bit for bit the oracle's logits, or
    the first op that differs is printed and the phase fails; (b) also
    decodes greedily 4 x (16 + ``GREEDY_MESH_STEPS``), and then, under ``cache_layout="seq"``,
    the full oracle's 48 teacher-forced steps in its 48 slots, 24 a rank
    (all 16 KV heads of the rank's slots, the softmax's statistics summed
    over ``model``; steps 24-47 write rank 1's slots), each step within
    ``MESH_BAND`` of the oracle's logits, else the first op over the band
    is printed and the phase fails; (a) also holds 8 seq-layout steps on
    (1, 1) bit for bit.  Returns the flash launches a rank of each run."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import dispatch
    from repro_torch.launch import collectives as coll
    from repro_torch.launch import distributed as mesh_dist
    from repro_torch.launch import mesh_runs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.sharding import make_context, shard_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    served, cfg, tokens = holder.pop("model"), holder.pop("cfg"), holder.pop("tokens")
    counts = {}

    # (a) a world of one over NCCL
    mesh_dist.node_mesh(backend="nccl", device=dev)
    try:
        mesh = make_test_mesh((1, 1))
        ctx = make_context(mesh)
        shard_model(served, mesh)  # tags every parameter replicated: nothing is copied
        plain = T.ModelContext()
        with moe_mod.recorded_routing() as log0:
            want, cache0 = T.prefill(served, {"tokens": tokens}, cfg, plain)
        dispatch.reset_launch_counts()
        coll.STATS.reset()
        sync()
        t0 = time.perf_counter()
        with moe_mod.recorded_routing() as log1:
            got, cache1 = T.prefill(served, {"tokens": tokens}, cfg, ctx)
            sync()
        one_s = time.perf_counter() - t0
        counts["(1, 1) nccl"] = dispatch.launch_counts()["flash_attention"]
        same = (torch.equal(got, want) and all(torch.equal(a, b) for a, b in zip(log0, log1))
                and all(torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"]) for a, b in zip(cache0, cache1)))
        del cache0, cache1
        seq = kept["prompt"][:, :8].to(dev)
        steps = []
        for c in (plain, ctx, make_context(mesh, cache_layout="seq")):
            cache, out = T.init_cache(cfg, 4, 8, device=dev, model=served, ctx=c), []
            for t in range(8):
                lg, cache = T.decode_step(served, cache, seq[:, t:t + 1], t, cfg, c)
                out.append(lg)
            steps.append(torch.stack(out))
        dec_same = torch.equal(steps[0], steps[1])
        seq_same = torch.equal(steps[0], steps[2])
        print(f"(a) mesh (1, 1), a world of one over NCCL: prefill 4 x 2048 {one_s:.3f} s, launches "
              f"{counts['(1, 1) nccl']} flash, collectives that moved data {coll.STATS.calls}; logits, routing "
              f"and K/V caches bit for bit the meshless prefill's {same}; 8 decode steps' logits bit for bit "
              f"{dec_same}, under cache layout seq {seq_same}  [{card}]")
        if not (same and dec_same and seq_same and counts["(1, 1) nccl"] == cfg.n_layers and not coll.STATS.calls):
            raise AssertionError("serve mesh (a): mesh (1, 1) is not the meshless model bit for bit")
    finally:
        dist.destroy_process_group()
    del got, want, log0, log1, steps

    with tempfile.TemporaryDirectory(prefix="repro-moe-oracle-") as tmp:
        t0 = time.perf_counter()
        mesh_runs.moe_mesh_oracle(served, cfg, tokens, kept, tmp, half_decode_steps=2)
        print(f"oracles written in {time.perf_counter() - t0:.3f} s (the meshless prefill again bit for bit "
              f"phase \"serve moe\"'s; the teacher-forced decode of its prompt and greedy ids recorded)  [{card}]")
        del served
        torch.cuda.empty_cache()
        print(f"the meshless model freed: {torch.cuda.memory_allocated() / 2**30:.3f} GiB held by this process")
        for label, shape, decode_steps, greedy, warm_up, seq_steps in (
                ("(b)", (1, 2), MESH_DECODE_STEPS, True, True, SEQ_DECODE_STEPS),
                ("(c)", (2, 2), 1, False, False, 0)):
            world = shape[0] * shape[1]
            t0 = time.perf_counter()
            rep = mesh_dist.run_ranks(mesh_runs.moe_serve_rank, world, backend="gloo", device="cuda",
                                      timeout=600, args=(seed, shape, tmp, decode_steps, greedy, warm_up, None,
                                                         2048, None, seq_steps, MESH_BAND, GREEDY_MESH_STEPS))
            wall = time.perf_counter() - t0
            ranks = rep["ranks"]
            print(f"{label} mesh {shape}, {world} gloo ranks on the card: {wall:.3f} s from spawn to exit; "
                  f"ranks agree within each data shard {rep['lockstep']}  [{card}]")
            for r in ranks:
                b_loc, T_s, kv, dh = r["k_cache_shape"]
                flip = r["flip"]
                print(f"{label} rank {r['coords']}: heads {r['heads']} over KV heads {r['kv_heads']} (tensor-"
                      f"parallel {r['tensor_parallel']}); {r['params_held'] / 1e9:.3f} B parameters held, "
                      f"{r['weights_gib']:.3f} GiB, drawn in {r['draw_s']:.3f} s; peak {r['peak_gib']:.3f} GiB; "
                      f"prefill {b_loc} x {T_s} {r['prefill_s']:.3f} s, flash launches "
                      f"{r['launches']['flash_attention']} at (B, T, S, H, KV, dh) = "
                      f"{(b_loc, T_s, T_s, r['heads'][1] - r['heads'][0], kv, dh)}; sums {r['sums']['calls']}, "
                      f"{ {k: round(v / 2**20, 1) for k, v in r['sums']['bytes'].items()} } MiB, "
                      f"{ {k: round(v, 3) for k, v in r['sums']['seconds'].items()} } s  [{card}]")
                print(f"{label} rank {r['coords']}: routing decisions that differ from the oracle's by layer "
                      f"{flip['differ']}, first {flip['first']}; "
                      + (f"last-position logits max|a-b|/max|b| {flip['logits_gap']:.3e}" if flip["first"] is None
                         else f"K cache gaps up to it {[round(g, 6) for g in flip['k_gaps']]}")
                      + f"; with the oracle's routing replayed {r['replay_gap']:.3e}"
                      + (" (no decision differs: the free run is its own replay)" if flip["first"] is None else "")
                      + f"; teacher-forced decode steps {r['decode_steps']} in the oracle's {r['decode_slots']} "
                      f"cache slots, routing replayed: worst max|a-b|/max|b| {r['decode_gap']:.3e} ("
                      + ("bit for bit" if r["decode_first_difference"] is None else
                         "the first op that differs: {} by {:.3e}".format(*r["decode_first_difference"]))
                      + f"), {r['decode_ms_per_step']:.2f} ms/step"
                      + (f"; greedy 4 x (16 + {r['greedy_steps']}) {r['greedy_ms_per_step']:.2f} ms/step, ids "
                         f"agree with the oracle's first {r['greedy_steps']} {r['greedy_agree']:.4f}"
                         if "greedy_agree" in r else "")
                      + f"  [{card}]")
                bad = []
                if r["launches"]["flash_attention"] != cfg.n_layers or sum(r["launches"].values()) != cfg.n_layers:
                    bad.append(f"launches {r['launches']}")
                if (b_loc, T_s, kv) != (4 // shape[0], 2048, cfg.n_kv_heads // shape[1]):
                    bad.append(f"K cache {r['k_cache_shape']}")
                if flip["first"] is None and flip["logits_gap"] > MESH_BAND:
                    bad.append(f"logits gap {flip['logits_gap']:.3e} with no routing difference")
                if flip["first"] is not None and max(flip["k_gaps"]) > MESH_BAND:
                    bad.append(f"K caches up to the first routing difference {flip['k_gaps']}")
                if r["replay_gap"] > MESH_BAND:
                    bad.append(f"replayed prefill gap {r['replay_gap']:.3e}")
                if r["decode_first_difference"] is not None or r["decode_gap"] != 0.0:
                    bad.append(f"the replayed decode is not the meshless one bit for bit: {r['decode_gap']:.3e}, "
                               f"first at {r['decode_first_difference']}")
                if seq_steps:
                    print(f"{label} rank {r['coords']}: cache layout seq, the oracle's {r['seq_steps']} "
                          f"teacher-forced steps in its {r['decode_slots']} slots, K cache a layer "
                          f"{r['seq_k_cache_shape']} (feature {(b_loc, r['decode_slots'], kv, dh)}), "
                          f"cache {r['seq_cache_bytes']:,} bytes a rank (feature {r['feature_cache_bytes']:,}); "
                          f"{r['seq_exact']} steps bit for bit (the first that parts: "
                          f"{next((t for t, g in enumerate(r['seq_gaps']) if g), None)}), median max|a-b|/max|b| "
                          f"{sorted(r['seq_gaps'])[len(r['seq_gaps']) // 2]:.3e}, worst {r['seq_gap']:.3e} at step "
                          f"{r['seq_gaps'].index(r['seq_gap'])}, "
                          f"over steps >= {r['seq_k_cache_shape'][1]} "
                          f"(rank 1's slots) {r['seq_gap_late']:.3e}"
                          + ("" if r["seq_first_difference"] is None else
                             "; the first op over the band: {} by {:.3e}".format(*r["seq_first_difference"]))
                          + f"; {r['seq_ms_per_step']:.2f} ms/step, {r['seq_ms_per_step'] * r['seq_steps'] / 1e3:.3f} s "
                          f"(feature {r['decode_ms_per_step']:.2f} ms/step on these "
                          f"ranks); one step's collectives {r['seq_step']['calls']} calls, {r['seq_step']['bytes']} "
                          f"bytes (feature {r['feature_step']['calls']}, {r['feature_step']['bytes']})  [{card}]")
                    want_k = (4, r["decode_slots"] // shape[1], cfg.n_kv_heads, cfg.head_dim)
                    if (r["seq_steps"] != seq_steps or r["seq_gap"] > MESH_BAND or r["seq_first_difference"] is not None
                            or r["seq_k_cache_shape"] != want_k):
                        bad.append(f"cache layout seq: {r['seq_steps']} steps, worst gap {r['seq_gap']:.3e}, first "
                                   f"over the band {r['seq_first_difference']}, K cache {r['seq_k_cache_shape']}")
                if bad:
                    raise AssertionError(f"serve mesh {label} rank {r['coords']}: " + "; ".join(bad))
            if not rep["lockstep"]:
                raise AssertionError(f"serve mesh {label}: the ranks of a data shard part")
            counts[f"{shape} gloo, a rank"] = ranks[0]["launches"]["flash_attention"]
            MESH_RANKS[("serve", shape)] = ranks
    return counts


# The gloo ranks' figures of phases "serve mesh" and "train mesh", by
# (phase, mesh shape): phase "dry run" holds its predictions against them.
MESH_RANKS: dict = {}


def analysis_phase(card: str) -> dict:
    """Phase "analysis": the port's host-sync analysis on the card.  Layer 1
    (``repro_torch.analysis.ast_lint``) over ``src/repro_torch``, clean
    modulo the port's baseline; layer 2 (``analysis.sync_audit``) of the
    four registered hot paths on CUDA tensors: each bucket's two calls
    (different values) dispatch the same ops on the same shapes, no op
    moves a value to the host, and each call runs under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    implicit synchronisation; the kernels' launches by path, from
    ``kernels.dispatch``'s counters.  Returns the launches by path."""
    from repro_torch.analysis import baseline as bl
    from repro_torch.analysis.ast_lint import lint_paths
    from repro_torch.analysis.sync_audit import audit_hot_paths

    t0 = time.perf_counter()
    findings = lint_paths([str(ROOT / "src" / "repro_torch")])
    new, old = bl.split_findings(findings, bl.load_baseline(str(ROOT / bl.DEFAULT_RELPATH)))
    failing = [f for f in new if f.fatal]
    print(f"layer 1: {len(findings)} findings over src/repro_torch ({len(old)} baselined, {len(failing)} failing, "
          f"{sum(not f.fatal for f in new)} info) in {time.perf_counter() - t0:.3f} s")
    for f in failing:
        print(f"  {f.format()}")
    if failing:
        raise AssertionError(f"analysis: {len(failing)} new layer-1 findings")
    t0 = time.perf_counter()
    audits = audit_hot_paths(device="cuda")
    print(f"layer 2 on the card: {len(audits)} hot paths in {time.perf_counter() - t0:.3f} s  [{card}]")
    launches = {}
    for a in audits:
        print(f"  {a.registry_name} ({a.kind}): host syncs by bucket {a.syncs} under set_sync_debug_mode="
              f"{a.debug_mode!r}; one program a bucket {a.same_program} ({a.ops} aten ops a call); kernel "
              f"launches {a.launches}, dispatched calls {a.calls}" + (f"; ERROR {a.error}" if a.error else ""))
        launches[a.registry_name] = a.launches
        if not a.ok or a.debug_mode != "error" or any(a.syncs.values()):
            raise AssertionError(f"analysis: hot path {a.registry_name} fails its audit: {a.as_dict()}")
    total = {}
    for got in launches.values():
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    if launches["train.train_step"].get("flash_attention", 0) < 1 or total.get("assign_min", 0) < 1:
        raise AssertionError(f"analysis: the hot paths launched {launches}")
    print(f"analysis launches by kernel {total}  [{card}]")
    return launches


DRY_RUN_MESH_CELLS = (
    # (label, phase the card ran it in, arguments of launch.dryrun)
    ("serve (1, 2)", ("serve", (1, 2)), ["--arch", "deepseek-moe-16b", "--shape", "prefill_32k", "--batch", "4",
                                         "--seq-len", "2048", "--mesh-shape", "1x2", "--remat", "none",
                                         "--override", "param_dtype=bfloat16"]),
    ("serve (2, 2)", ("serve", (2, 2)), ["--arch", "deepseek-moe-16b", "--shape", "prefill_32k", "--batch", "4",
                                         "--seq-len", "2048", "--mesh-shape", "2x2", "--remat", "none",
                                         "--override", "param_dtype=bfloat16"]),
    ("train (1, 2)", ("train", (1, 2)), ["--arch", "qwen3-1.7b", "--shape", "train_4k", "--batch", "8",
                                         "--seq-len", "512", "--num-groups", "4", "--compress", "--mesh-shape",
                                         "1x2", "--remat", "full", "--override", f"n_layers={TRAIN_MESH_LAYERS}"]),
    ("train (2, 2)", ("train", (2, 2)), ["--arch", "qwen3-1.7b", "--shape", "train_4k", "--batch", "8",
                                         "--seq-len", "512", "--num-groups", "4", "--compress", "--mesh-shape",
                                         "2x2", "--remat", "full", "--override", f"n_layers={TRAIN_MESH_LAYERS}"]),
)
# deepseek-moe-16b's prefill_32k cell is cut to 32 x 8192: on meta tensors
# its 32768-token chunked attention takes about 100 s of host time.
DRY_RUN_POD_CELLS = (
    ("qwen3-1.7b train_4k (16, 16)", ["--arch", "qwen3-1.7b", "--shape", "train_4k"]),
    ("deepseek-moe-16b prefill 32 x 8192 (16, 16)", ["--arch", "deepseek-moe-16b", "--shape", "prefill_32k",
                                                     "--seq-len", "8192"]),
    ("qwen3-4b decode_32k (2, 16, 16)", ["--arch", "qwen3-4b", "--shape", "decode_32k", "--multi-pod"]),
)
# The same decode cell under cache layout seq, rendered apart: make_tables
# keys a cell by (arch, shape, mesh), so one file holds one layout's cell.
DRY_RUN_SEQ_POD_CELLS = (
    ("qwen3-4b decode_32k (2, 16, 16), cache layout seq", ["--arch", "qwen3-4b", "--shape", "decode_32k",
                                                           "--multi-pod", "--cache-layout", "seq"]),
)
# Phase "serve mesh" (b)'s decode twin, one step under each cache layout at
# batch 4 in its 48 slots: the predicted seq-minus-feature collectives are
# held to what rank (0, 0) counted in one step of each.
DRY_RUN_DECODE_CELLS = tuple(
    (f"decode (1, 2), cache layout {layout}", ["--arch", "deepseek-moe-16b", "--shape", "decode_32k", "--batch", "4",
                                               "--seq-len", "48", "--mesh-shape", "1x2", "--override",
                                               "param_dtype=bfloat16", "--cache-layout", layout])
    for layout in ("feature", "seq"))


# Phase "mesh full width" (c): the session rounds its ranks replay, the
# first of phase "session full width" (b)'s 8.
MESH_SESSION_ROUNDS = 4


# Phase "dry run"'s cells, started in the background before phase "serve
# xlstm" (:func:`dry_run_start`) and read by :func:`dry_run_phase`.
DRY_RUN: dict = {}


def _dry_run_cells() -> list:
    return ([(label, args) for label, _, args in DRY_RUN_MESH_CELLS] + list(DRY_RUN_DECODE_CELLS)
            + list(DRY_RUN_POD_CELLS) + list(DRY_RUN_SEQ_POD_CELLS))


def dry_run_start() -> None:
    """Spawn ``python -m repro_torch.launch.dryrun`` once a cell of phase
    "dry run", all at once and at the lowest priority (``nice`` 19), so
    they run on the host's idle cores beside the phases that use the card
    (each is one process: rank 0 of a fake process group on meta tensors,
    nothing on the card).  :func:`dry_run_stop` ends any still running when
    the script exits."""
    import atexit
    import os
    import tempfile

    tmp = tempfile.TemporaryDirectory(prefix="repro-dryrun-")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = []
    DRY_RUN.update(tmp=tmp, procs=procs, t0=time.perf_counter(), wall0=time.time())
    atexit.register(dry_run_stop)
    for i, (label, args) in enumerate(_dry_run_cells()):
        out = os.path.join(tmp.name, f"cell{i}.jsonl")
        log = open(os.path.join(tmp.name, f"cell{i}.log"), "w")
        procs.append((label, out, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out", out],
            cwd=str(ROOT), env=env, stdout=log, stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(19))))


def dry_run_stop() -> None:
    """Kill the dry-run cells still running and remove their directory."""
    for _, _, log, proc in DRY_RUN.pop("procs", []):
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    if "tmp" in DRY_RUN:
        DRY_RUN.pop("tmp").cleanup()


def dry_run_phase(card: str) -> None:
    """Phase "dry run": the cells :func:`dry_run_start` spawned in the
    background.
    (a) The meshes and shapes phases "serve mesh" and "train mesh" ran on
    the card's gloo ranks: the predicted parameter bytes and collectives
    (calls and bytes by kind) of rank (0, 0) equal to what that rank
    measured, the predicted peak (arguments + temporaries) beside its
    ``torch.cuda.max_memory_allocated``, their ratio printed, no limit.
    The decode twin of "serve mesh" (b) under each cache layout: the
    predicted seq-minus-feature collectives (calls and bytes by kind) equal
    to rank (0, 0)'s measured seq step minus its feature step.
    (b) Three production cells, ``launch.make_tables``' rendering printed,
    and qwen3-4b decode_32k on (2, 16, 16) under cache layout seq, rendered
    apart.  Any ``error`` record fails the phase."""
    import os

    from repro_torch.launch import make_tables

    tmp, procs = DRY_RUN["tmp"], DRY_RUN["procs"]
    t0 = time.perf_counter()
    records = {}
    try:
        for label, out, log, proc in procs:
            rc = proc.wait(timeout=600)
            log.close()
            text = Path(log.name).read_text()
            rec = json.loads(Path(out).read_text().splitlines()[-1]) if os.path.exists(out) else {}
            print(f"dry run {label}: exit {rc}, {rec.get('lower_s', float('nan')):.3f} s of analysis; "
                  + (text.strip().splitlines()[-1] if text.strip() else ""))
            if rc != 0 or "error" in rec or not rec:
                raise AssertionError(f"dry run {label}: {rec.get('error')}\n{text[-3000:]}")
            records[label] = rec
    except BaseException:
        dry_run_stop()
        raise
    done = max(os.path.getmtime(out) for _, out, _, _ in procs) - DRY_RUN["wall0"]
    print(f"dry run: {len(procs)} cells on the host at nice 19, beside the phases from \"serve xlstm\" on: the "
          f"last written {done:.3f} s after their start, read {time.perf_counter() - DRY_RUN['t0']:.3f} s after it, "
          f"{time.perf_counter() - t0:.3f} s of it waited for here  [{card}]")

    bad = []
    for label, key, _ in DRY_RUN_MESH_CELLS:
        rec, ranks = records[label], MESH_RANKS[key]
        r0 = next(r for r in ranks if all(c == 0 for c in r["coords"]))
        mem, coll = rec["memory"], rec["collectives"]
        want_bytes = {k: float(v) for k, v in r0["sums"]["bytes"].items()}
        predicted_peak = mem["argument_bytes"] + mem["temp_bytes"]
        measured_peak = r0["peak_gib"] * 2**30
        print(f"(a) {label}: parameter bytes a rank predicted {mem['param_bytes']:,}, measured "
              f"{[r['params_bytes'] for r in ranks]} (rank (0, 0) {r0['params_bytes']:,}); collectives "
              f"predicted {coll['calls_by_kind']} calls, { {k: int(v) for k, v in coll['by_kind'].items()} } bytes; "
              f"measured {r0['sums']['calls']} calls, {r0['sums']['bytes']} bytes; peak predicted "
              f"{predicted_peak / 2**30:.3f} GiB (arguments {mem['argument_bytes'] / 2**30:.3f} + temporaries "
              f"{mem['temp_bytes'] / 2**30:.3f}), measured {r0['peak_gib']:.3f} GiB, predicted / measured "
              f"{predicted_peak / measured_peak:.3f}  [{card}]")
        if mem["param_bytes"] != r0["params_bytes"]:
            bad.append(f"{label}: parameter bytes {mem['param_bytes']} != {r0['params_bytes']}")
        if coll["calls_by_kind"] != r0["sums"]["calls"] or coll["by_kind"] != want_bytes:
            bad.append(f"{label}: collectives {coll['calls_by_kind']} {coll['by_kind']} != "
                       f"{r0['sums']['calls']} {want_bytes}")
    r0 = next(r for r in MESH_RANKS[("serve", (1, 2))] if all(c == 0 for c in r["coords"]))
    (feature_label, _), (seq_label, _) = DRY_RUN_DECODE_CELLS

    def minus(a: dict, b: dict) -> dict:
        return {k: a.get(k, 0) - b.get(k, 0) for k in set(a) | set(b) if a.get(k, 0) != b.get(k, 0)}

    predicted = [records[lab]["collectives"] for lab in (seq_label, feature_label)]
    want_calls = minus(r0["seq_step"]["calls"], r0["feature_step"]["calls"])
    want_bytes = {k: float(v) for k, v in minus(r0["seq_step"]["bytes"], r0["feature_step"]["bytes"]).items()}
    got_calls = minus(predicted[0]["calls_by_kind"], predicted[1]["calls_by_kind"])
    got_bytes = minus(predicted[0]["by_kind"], predicted[1]["by_kind"])
    mem = [records[lab]["memory"] for lab in (seq_label, feature_label)]
    print(f"(a) decode (1, 2), one step, seq minus feature: predicted {got_calls} calls, {got_bytes} bytes; "
          f"measured on rank (0, 0) {want_calls} calls, {want_bytes} bytes; predicted arguments a rank "
          f"{mem[0]['argument_bytes']:,} (seq) and {mem[1]['argument_bytes']:,} (feature) bytes  [{card}]")
    if got_calls != want_calls or got_bytes != want_bytes:
        bad.append(f"decode (1, 2): seq minus feature predicted {got_calls} {got_bytes}, measured {want_calls} "
                   f"{want_bytes}")
    if bad:
        raise AssertionError("dry run (a): " + "; ".join(bad))

    jsonl = os.path.join(tmp.name, "pod.jsonl")
    with open(jsonl, "w") as f:
        for label, _ in DRY_RUN_POD_CELLS:
            f.write(json.dumps(records[label]) + "\n")
    seq_jsonl = os.path.join(tmp.name, "pod_seq.jsonl")
    with open(seq_jsonl, "w") as f:
        for label, _ in DRY_RUN_SEQ_POD_CELLS:
            f.write(json.dumps(records[label]) + "\n")
    for label, _ in DRY_RUN_POD_CELLS + DRY_RUN_SEQ_POD_CELLS:
        rec = records[label]
        mem = rec["memory"]
        print(f"(b) {label}: {rec['flops_per_device']:.4e} FLOPs, {rec['bytes_per_device']:.4e} bytes, "
              f"{rec['collectives']['total_bytes']:.4e} collective bytes a device; arguments "
              f"{mem['argument_bytes'] / 2**30:.3f} GiB + temporaries {mem['temp_bytes'] / 2**30:.3f} GiB a rank; "
              f"roofline {rec['roofline']}; kernel ops {rec['kernel_ops']}")
    cells_ = make_tables.load(jsonl)
    print(make_tables.roofline_table(cells_, "16x16"))
    print(make_tables.roofline_table(cells_, "2x16x16"))
    print(make_tables.dryrun_table(cells_))
    seq_cells = make_tables.load(seq_jsonl)
    print("cache layout seq:")
    print(make_tables.roofline_table(seq_cells, "2x16x16"))
    print(make_tables.dryrun_table(seq_cells))
    dry_run_stop()


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
    from repro_torch.configs.paper_kmedian import paper_fig1, production_scale
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
    from repro_torch.launch import op_analysis
    from repro_torch.launch.specs import ShapeCell

    # The plain side runs in full fp32: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    FIG1, PRODUCTION = paper_fig1(), production_scale()  # the paper's Figure-1 sizes, the coreset size
    errs: dict[str, float] = {
        "assign_min": 0.0, "weighted_segsum": 0.0, "flash_attention": 0.0, "pairwise_sqdist": 0.0,
        "min_dist_update": 0.0}

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

    def check_min_dist(tag, x, w, steps=3, median=True, g=gen):
        """``steps`` steps of the seeding through the kernel and through the
        plain version, each side carrying its own running d2 from PAD_DIST
        and the centers rows of x (a column of a (B, k, d) set, as the
        seeding passes them), so each center's own row reads 0: d2 within
        1e-6 relative, the logits within 1e-6 (1 + |logit|), the -inf rows
        exactly those of weight 0 on both sides, one launch a step."""
        B, n, d = x.shape
        pick = torch.randint(0, n, (B, steps), generator=g, device=dev)
        centers = torch.gather(x, 1, pick.unsqueeze(-1).expand(-1, -1, d)).contiguous()
        d2_k = torch.full((B, n), pd_ref.PAD_DIST, device=dev)
        d2_r = d2_k.clone()
        worst, worst_rel, worst_logit = 0.0, 0.0, 0.0
        for i in range(steps):
            before = dispatch.launch_counts()["min_dist_update"]
            got = pd_ops.min_dist_update(x, centers[:, i], d2_k, w, median=median)
            launched = dispatch.launch_counts()["min_dist_update"] - before
            want = pd_ops.min_dist_update(x, centers[:, i], d2_r, w, median=median, impl="torch_ref")
            sync()
            if launched != 1:
                raise AssertionError(f"min_dist_update {tag}: {launched} launches for one step")
            err = (d2_k - d2_r).abs()
            bad = int((err > 1e-6 * d2_r).sum())
            if bad:
                raise AssertionError(f"min_dist_update {tag} step {i}: {bad} distances outside rtol 1e-6, "
                                     f"max err {float(err.max()):.3e}")
            inf_k, inf_r = torch.isneginf(got), torch.isneginf(want)
            if not (torch.equal(inf_k, inf_r) and torch.equal(inf_r, w == 0)):
                raise AssertionError(f"min_dist_update {tag} step {i}: the -inf rows differ from those of "
                                     "weight 0")
            real = ~inf_r
            lerr = (got[real] - want[real]).abs()
            bad = int((lerr > 1e-6 * (1.0 + want[real].abs())).sum()) + int((~torch.isfinite(got[real])).sum())
            if bad:
                raise AssertionError(f"min_dist_update {tag} step {i}: {bad} logits outside 1e-6 (1 + |logit|) "
                                     f"or not finite, max err {float(lerr.max()):.3e}")
            on_center = d2_k[torch.arange(B, device=dev), pick[:, i]]
            if bool((on_center != 0).any()):
                raise AssertionError(f"min_dist_update {tag} step {i}: a center's own row reads "
                                     f"{float(on_center.abs().max()):.3e}, not 0")
            worst, worst_logit = max(worst, float(err.max())), max(worst_logit, float(lerr.max()))
            worst_rel = max(worst_rel, float((err / d2_r.clamp_min(1e-30)).max()))
        errs["min_dist_update"] = max(errs["min_dist_update"], worst)
        print(f"min_dist_update {tag}: x {tuple(x.shape)} steps={steps} median={median} "
              f"max_abs_err={worst:.3e} max_rel_err={worst_rel:.2e} logits max_abs_err={worst_logit:.3e} "
              f"weight-0 rows {int((w == 0).sum())}")

    def rows_of(x, k):
        """k random rows of each batch of x, as centers (B, k, d)."""
        pick = torch.randint(0, x.shape[1], (x.shape[0], k), generator=gen, device=dev)
        return torch.gather(x, 1, pick.unsqueeze(-1).expand(-1, -1, x.shape[2])).contiguous()

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    # -------------------------------------------------------------- prelude

    # SIFT1M's shape under the paper's workers, stragglers and assignment rate
    n_full, d_full, k_full, s, t = 1_000_000, 128, 256, FIG1.s, FIG1.t
    with phase("prelude"):
        t0 = time.perf_counter()
        pts, _, _ = gaussian_mixture(n_full, k_full, d_full, rng=np.random.default_rng(args.seed))
        a = bernoulli_assignment(n_full, s, ell=FIG1.p_a * s, rng=np.random.default_rng(args.seed + 1))
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
        p_pts, _, _ = franti_s1_like(FIG1.n)
        p_a = bernoulli_assignment(FIG1.n, s, ell=FIG1.p_a * FIG1.s, rng=np.random.default_rng(1))
        _, _, _, _, p_xs, p_ws = ResilienceSession(p_a).prepare(p_pts, alive)
        px = torch.from_numpy(p_xs).to(dev)
        idx = check_assign("paper local", px, rows_of(px, FIG1.k))
        check_segsum("paper local", px, torch.from_numpy(p_ws).to(dev) * rand(*p_ws.shape), idx, FIG1.k)
        py = rand(1, s * FIG1.k, FIG1.d)
        idx = check_assign("paper coordinator", py, rows_of(py, FIG1.k))
        check_segsum("paper coordinator", py, rand(1, s * FIG1.k), idx, FIG1.k)
        pp = torch.from_numpy(p_pts).to(dev)[None]
        check_assign("paper full cost", pp, rows_of(pp, FIG1.k))

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
        # ... and a model rank's heads of it on the meshes of phase "serve
        # mesh": (1, 2) and (2, 2), eight heads a rank, over 4 and 2 rows.
        check_flash("prefill moe, a rank of (1, 2): H=KV=8", 4, 2048, 2048, 8, 8, 128,
                    g=torch.Generator(device=dev).manual_seed(args.seed + 3))
        check_flash("prefill moe, a rank of (2, 2): H=KV=8", 2, 2048, 2048, 8, 8, 128,
                    g=torch.Generator(device=dev).manual_seed(args.seed + 4))
        # ... and a rank's heads of phase "train mesh": qwen3-1.7b's 8 of 16 query
        # heads over 4 of 8 KV heads, 8 x 512 tokens on (1, 2) and 4 x 512 on (2, 2).
        check_flash("train mesh, a rank of (1, 2): H=8 KV=4", 8, 512, 512, 8, 4, 128,
                    g=torch.Generator(device=dev).manual_seed(args.seed + 5))
        check_flash("train mesh, a rank of (2, 2): H=8 KV=4", 4, 512, 512, 8, 4, 128,
                    g=torch.Generator(device=dev).manual_seed(args.seed + 6))
        # The frontends' prefill shapes, never launched before: internvl2-1b
        # (group size 7, dh 64) and musicgen-large (H = KV = 32, dh 64).
        check_flash("prefill internvl2-1b H=14 KV=2", 4, 2048, 2048, 14, 2, 64,
                    g=torch.Generator(device=dev).manual_seed(args.seed + 1))
        check_flash("prefill musicgen-large H=KV=32", 4, 2048, 2048, 32, 32, 64,
                    g=torch.Generator(device=dev).manual_seed(args.seed + 2))
        # The autograd Function: qwen3-1.7b's training shape in bf16, a ragged f32 one,
        # one group's rows, and a rank's heads of phase "train mesh" on (1, 2) and (2, 2).
        flash_grads = [flash_grad_check("train qwen3-1.7b", (8, 512, 16, 8, 128), torch.bfloat16, args.seed, card),
                       flash_grad_check("ragged f32", (2, 300, 8, 2, 64), torch.float32, args.seed, card),
                       flash_grad_check("train qwen3-1.7b one group", (3, 512, 16, 8, 128), torch.bfloat16,
                                        args.seed, card),
                       flash_grad_check("train mesh, a rank of (1, 2)", (8, 512, 8, 4, 128), torch.bfloat16,
                                        args.seed, card),
                       flash_grad_check("train mesh, a rank of (2, 2)", (4, 512, 8, 4, 128), torch.bfloat16,
                                        args.seed, card)]

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

        # min_dist_update: the scalar path (d = 3, 130; ragged n; B = 1), then
        # the seeding's shapes: the local solves' (s, m, 128), the benchmark
        # solve's (s, 400000, 128) and its coordinator's (1, s * 1024, 128) at
        # k = 1024.
        # Inputs from a generator of their own, so later draws stay as they were.
        g_md = torch.Generator(device=dev).manual_seed(args.seed + 7)

        def md_rand(*shape):
            return torch.rand(shape, generator=g_md, device=dev)

        x = md_rand(3, 777, 3) - 0.5
        check_min_dist("edge d=3 n=777", x, md_rand(3, 777) * (md_rand(3, 777) > 0.2), g=g_md)
        check_min_dist("edge d=3 means", x, md_rand(3, 777), median=False, g=g_md)
        x = md_rand(1, 1001, 130)
        check_min_dist("edge B=1 d=130", x, md_rand(1, 1001) * (md_rand(1, 1001) > 0.2), g=g_md)
        check_min_dist("full local", xs_d, ws_d * md_rand(*ws_d.shape), g=g_md)
        bx = pts_d[torch.randint(0, pts_d.shape[0], (s, 400_000), generator=g_md, device=dev)]
        check_min_dist("benchmark local (s, 400000, 128)", bx, md_rand(s, 400_000) * (md_rand(s, 400_000) > 0.1),
                       g=g_md)
        del bx
        pick = torch.randint(0, xs_d.shape[1], (s, 1024), generator=g_md, device=dev)
        fy = torch.gather(xs_d, 1, pick.unsqueeze(-1).expand(-1, -1, d_full)).reshape(1, s * 1024, d_full)
        check_min_dist("full coordinator k=1024", fy, md_rand(1, s * 1024) * (md_rand(1, s * 1024) > 0.3),
                       g=g_md)
        del x, fy, pick

    with phase("paper size"):
        dispatch.reset_launch_counts()
        ratios = quickstart.run(dev)
        print(f"paper-size ratios: {json.dumps(ratios)}  launches {dispatch.launch_counts()}")
        if not all(np.isfinite(r) and r > 0 for r in ratios.values()):
            raise AssertionError(f"paper-size ratios not finite: {ratios}")
        # The same run through the kernels and through the plain versions.
        kw = dict(local_iters=15, coord_iters=30, device=dev)
        out_k = resilient_kmedian(p_pts, FIG1.k, p_a, alive, **kw)
        out_r = resilient_kmedian(p_pts, FIG1.k, p_a, alive, impl="torch_ref", **kw)
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
        with (launches_by_shape("weighted_segsum", {}) as seg_shapes,
              launches_by_shape("min_dist_update", {}) as md_shapes):
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
        print(f"Algorithm 1 min_dist_update launches by x shape: {md_shapes}")
        for tag, got in (("centralized", central_counts), ("Algorithm 1", counts)):
            if not all(got.get(name, 0) > 0 for name in ("assign_min", "weighted_segsum", "min_dist_update")):
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
                                  args=(args.seed, session_rounds["centers"], MESH_SESSION_ROUNDS, n_batch))
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
        want = session_rounds["estimates"][:MESH_SESSION_ROUNDS]
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
                X2, r2, k2, a2, alive, coreset_size=PRODUCTION.coreset_size, seed=args.seed, device=dev)
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
        # One more prefill, untimed, under the op-level analysis: the roofline.
        del cache
        dispatch.reset_launch_counts()
        analysis = op_analysis.analyze(prefill, served, {"tokens": tokens})
        sync()
        roofline_line("(a) prefill", cfg, ShapeCell("prefill_4x2048", T_s, B_s, "prefill"), analysis, prefill_s,
                      dispatch.launch_counts()["flash_attention"], card)

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
        # phase "serve mesh"'s oracle, kept on the host
        moe_kept = {"logits": logits.cpu(), "routing": [t.cpu() for t in log_a]}
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
        moe_kept.update(prompt=prompt.cpu(), ids=out.cpu())

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
        # The model stays for phase "serve mesh", which frees it.
        moe_holder = {"model": served, "cfg": cfg, "tokens": tokens}
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

    # The parameters are trainable: the serving phases record no gradient.
    with phase("serve mesh"), torch.no_grad():
        mesh_counts = serve_mesh(args.seed, card, moe_holder, moe_kept)

    dry_run_start()
    with phase("serve xlstm"), torch.no_grad():
        serve_xlstm(args.seed, card)

    with phase("serve rglru"), torch.no_grad():
        serve_rglru(args.seed, card)

    with phase("serve frontends"), torch.no_grad():
        frontend_counts = serve_frontends(args.seed, card)

    with phase("train full width"):
        train_full = train_full_width(args.seed, card)

    with phase("train 100m"):
        train_small = train_100m(args.seed, card)

    with phase("train device recovery"):
        train_device = train_device_recovery(args.seed, card, train_full["mean_step_s"])

    with phase("train mesh"):
        train_meshes = train_mesh(args.seed, card)

    with phase("analysis"):
        analysis_phase(card)

    with phase("dry run"):
        dry_run_phase(card)

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
                                 "serve moe moonshot-v1-16b-a3b prefill (4 layers)": m_counts["flash_attention"],
                                 **{f"serve mesh deepseek-moe-16b prefill, mesh {k}": n
                                    for k, n in mesh_counts.items()},
                                 "serve musicgen-large prefill": frontend_counts["musicgen-large"],
                                 "serve internvl2-1b prefill": frontend_counts["internvl2-1b"],
                                 "train qwen3-1.7b step (forward)": train_full["flash_per_step"],
                                 "train 100m step (forward)": train_small["flash_per_step"],
                                 "train device recovery qwen3-1.7b step (forward, a launch a group and "
                                 "layer)": train_device["flash_per_step"],
                                 **{f"train mesh qwen3-1.7b step at {TRAIN_MESH_LAYERS} layers, mesh {k} at "
                                    f"(B, T, S, H, KV, dh) = "
                                    f"{train_meshes['shapes'][k]} (forward"
                                    + (")" if k.startswith("(1, 1)") else " and its recompute, remat full)"): v
                                    for k, v in train_meshes["counts"].items()}},
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
            "autograd": flash_grads,
        })
        # ... and at a model rank's heads of it on phase "serve mesh"'s (1, 2) mesh
        rq, rk, rv = (t[:, :, :8].contiguous() for t in (mq, mk, mv))
        rqh, rkh, rvh = (t.transpose(1, 2).contiguous() for t in (rq, rk, rv))
        beside["flash_attention"].update({
            "mesh_rank_shape": [fB, fT, fT, 8, 8, fdh],
            "mesh_rank_ms": cuda_ms(lambda: fa_ops.flash_attention(rq, rk, rv), 20),
            "mesh_rank_plain_ms": cuda_ms(lambda: fa_ops.flash_attention(rq, rk, rv, impl="torch_ref"), 3),
            "mesh_rank_library_ms": cuda_ms(lambda: sdpa(rqh, rkh, rvh, is_causal=True), 20),
            "mesh_rank_bound_ms": 1e3 * max(m_flops / 2 / PEAK_BF16_FLOPS, m_bytes / 2 / PEAK_BYTES),
        })
        # ... and at a rank's heads of phase "train mesh"'s (1, 2) mesh: qwen3-1.7b's
        # 8 of 16 query heads over 4 of 8 KV heads, 8 x 512 tokens
        tB, tT, tH, tKV = 8, 512, 8, 4
        tq = torch.randn((tB, tT, tH, fdh), generator=gen, device=dev).bfloat16()
        tk = torch.randn((tB, tT, tKV, fdh), generator=gen, device=dev).bfloat16()
        tv = torch.randn((tB, tT, tKV, fdh), generator=gen, device=dev).bfloat16()
        t_flops = 4.0 * tB * tH * fdh * (tT * (tT + 1) / 2)
        t_bytes = 2.0 * (2 * tB * tT * tH * fdh + 2 * tB * tT * tKV * fdh)
        tqh, tkh, tvh = (t.transpose(1, 2).contiguous() for t in (tq, tk, tv))
        beside["flash_attention"].update({
            "train_mesh_rank_shape": [tB, tT, tT, tH, tKV, fdh],
            "train_mesh_rank_ms": cuda_ms(lambda: fa_ops.flash_attention(tq, tk, tv), 20),
            "train_mesh_rank_plain_ms": cuda_ms(lambda: fa_ops.flash_attention(tq, tk, tv, impl="torch_ref"), 5),
            "train_mesh_rank_library_ms": cuda_ms(lambda: sdpa(tqh, tkh, tvh, is_causal=True, enable_gqa=True), 20),
            "train_mesh_rank_bound_ms": 1e3 * max(t_flops / PEAK_BF16_FLOPS, t_bytes / PEAK_BYTES),
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
        # min_dist_update at the local solves' shape, one step of the seeding:
        # x read once, the center once, d2 read and written, w read, the
        # logits written; a difference and an FMA an element, in fp32.
        g_md = torch.Generator(device=dev).manual_seed(args.seed + 8)

        def md_step(x, n_centers):
            """Inputs of one step at x's shape: a center column of a
            (B, n_centers, d) set, a running d2 and weights."""
            pick = torch.randint(0, x.shape[1], (x.shape[0], n_centers), generator=g_md, device=dev)
            cs = torch.gather(x, 1, pick.unsqueeze(-1).expand(-1, -1, x.shape[2])).contiguous()
            return (cs[:, 1], torch.full(x.shape[:2], pd_ref.PAD_DIST, device=dev),
                    torch.rand(x.shape[:2], generator=g_md, device=dev))

        def md_bound(B, n, d):
            return bound(3.0 * B * n * d, 4.0 * (B * n * d + B * d + 4 * B * n))

        mc, md2, mw = md_step(xs_d, 2)
        m_bound, m_by = md_bound(B, m, d)
        rows.append({
            "name": "min_dist_update", "route": "cuda",
            "source": "src/repro_torch/csrc/min_dist_update.cu",
            "replaces": "none (the ++ seeding's one-center step; the reference's loop runs the "
                        "nearest-center kernel over all k slots each step)",
            "launches": counts["min_dist_update"], "max_abs_err": errs["min_dist_update"],
            "ms": cuda_ms(lambda: pd_ops.min_dist_update(xs_d, mc, md2, mw, median=True), 20),
            "plain_ms": cuda_ms(
                lambda: pd_ops.min_dist_update(xs_d, mc, md2, mw, median=True, impl="torch_ref"), 5),
            "bound_ms": m_bound, "bound_by": m_by,
            "library_ms": cuda_ms(lambda: torch.cdist(xs_d, mc[:, None]), 5),
            "library_call": "torch.cdist(x, c[:, None]) (the distances alone)",
            "design": "fp32-stream-ldcs",
        })
        # ... and at the coordinator's shape of the benchmark's solve, k = 1024
        cx = torch.gather(xs_d, 1, torch.randint(0, m, (B, 1024), generator=g_md, device=dev)
                          .unsqueeze(-1).expand(-1, -1, d)).reshape(1, B * 1024, d)
        cc, cd2, cw = md_step(cx, 2)
        beside["min_dist_update"] = {
            "shape": [B, m, d],
            "launches_by_x_shape": {str(list(shape)): n for shape, n in md_shapes.items()},
            "coordinator_shape": [1, B * 1024, d],
            "coordinator_ms": cuda_ms(lambda: pd_ops.min_dist_update(cx, cc, cd2, cw, median=True), 50),
            "coordinator_plain_ms": cuda_ms(
                lambda: pd_ops.min_dist_update(cx, cc, cd2, cw, median=True, impl="torch_ref"), 20),
            "coordinator_library_ms": cuda_ms(lambda: torch.cdist(cx, cc[:, None]), 50),
            "coordinator_bound_ms": md_bound(1, B * 1024, d)[0],
        }
        # ... and at the benchmark solve's local shape, (B, 400000, d)
        bx = pts_d[torch.randint(0, pts_d.shape[0], (B, 400_000), generator=g_md, device=dev)]
        bc, bd2, bw = md_step(bx, 2)
        beside["min_dist_update"].update({
            "benchmark_shape": [B, 400_000, d],
            "benchmark_ms": cuda_ms(lambda: pd_ops.min_dist_update(bx, bc, bd2, bw, median=True), 20),
            "benchmark_plain_ms": cuda_ms(
                lambda: pd_ops.min_dist_update(bx, bc, bd2, bw, median=True, impl="torch_ref"), 5),
            "benchmark_library_ms": cuda_ms(lambda: torch.cdist(bx, bc[:, None]), 5),
            "benchmark_bound_ms": md_bound(B, 400_000, d)[0],
        })
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

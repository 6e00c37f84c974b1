"""Multi-pod dry run (the twin of the reference's ``launch/dryrun.py``).

For every (architecture × input shape × mesh) cell, the reference lowers
and compiles the jitted step for 256 or 512 placeholder host devices and
reads XLA's cost and memory analyses: whether the cell fits on a (16, 16)
or (2, 16, 16) mesh, and which roofline term binds.  The port has no
compiler to ask, so it runs the step itself, as one rank of the mesh:

* **The mesh.**  This process is rank 0 of a ``fake`` process group of
  256 or 512 ranks (``torch.testing._internal.distributed.fake_pg``): a
  collective completes at once and moves nothing, and
  ``launch.collectives`` counts it by its kind and bytes as on a real mesh.
* **The tensors.**  Every tensor lies on the ``meta`` device: a shape and
  a dtype, no storage.  The real initialisers run on ``meta`` with
  ``generator=None`` and keep only the rank's blocks
  (``launch.sharding.init_sharded``); the step is the real one:
  ``make_train_step``, ``prefill`` or ``decode_step`` under
  ``make_context(mesh, attn_impl="torch_chunked", remat=…)``.  So by
  nature the dry run allocates nothing on any device, as the reference's
  forced host devices allocate nothing on a TPU; a step that reads a value
  (``.item()``, ``nonzero``) fails on ``meta`` and the cell is an error.
* **The counts.**  ``launch.op_analysis.analyze`` counts the step's FLOPs,
  bytes and collectives (a dispatched kernel op by its shapes) and
  ``launch.roofline.roofline_terms`` turns them into the roofline on H100
  terms.

One JSON line a cell, with the reference's keys.  ``memory``:

* ``argument_bytes``: the rank's parameters, optimizer state (moments,
  error-feedback buffers) or decode cache, and its rows of the batch,
  exact; ``param_bytes`` the parameters alone;
* ``output_bytes``: the distinct storages the step's result holds (a train
  step updates the state in place, so its result is the state);
* ``temp_bytes``: the peak of the live bytes the step allocated above its
  arguments, tallied over the storages of the tensors the dispatched ops
  produce, each counted from its first appearance until it is freed.  A
  kernel op counted whole by ``op_analysis`` runs its plain version with
  the tally off: its output is counted, its working set is not (the
  hand-written kernel keeps it on chip).

``lower_s`` is the seconds of the analysis (the model's blocks drawn on
``meta`` and the step run).  Keys with no twin are ``null``: ``compile_s``
(nothing is compiled), ``xla_cost_flops_loop_once`` (XLA's cost analysis)
and ``memory.generated_code_bytes``; ``--keep-hlo`` has no twin either.

``--cache-layout seq`` runs a decode cell's step under
``make_context(mesh, cache_layout="seq")``: each attention layer's cache
holds all KV heads of the rank's block of the slots, and ``collectives``
counts the softmax statistics' three all-reduces a layer and the gathers
of q, k and v.  ``--batch``, ``--seq-len``, ``--num-groups``,
``--compress`` and ``--override key=value`` (a config field) run a cell
at other sizes, as a mesh run on the card runs it, so that a prediction
can be held against what the card measured.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..configs import ARCHS
from ..models import transformer as T
from ..models.registry import get_config
from ..train.compression import CompressionConfig
from ..train.optimizer import AdamWConfig
from ..train.train_step import init_train_state, make_train_step
from . import op_analysis
from .mesh import make_production_mesh
from .roofline import model_flops, roofline_terms
from .sharding import init_sharded, local_rows, make_context
from .specs import SHAPES, cell_is_applicable, input_specs

__all__ = ["lower_cell", "main"]

META = torch.device("meta")


def _num_groups(mesh) -> int:
    sizes = mesh.shape
    return sizes.get("pod", 1) * sizes.get("data", 1)


def _fake_world(world: int) -> None:
    """Make this process rank 0 of a ``fake`` process group of ``world``
    ranks (a new one when the current group has another size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _storage_bytes(tree) -> int:
    """The bytes of the distinct storages the tensors of ``tree`` hold."""
    seen = {}
    for t in op_analysis.tensors_of(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


class _LiveBytes(TorchDispatchMode):
    """The peak of the live bytes of the storages the dispatched ops
    produce, the arguments' storages left out (module docstring)."""

    def __init__(self, args):
        super().__init__()
        self.args = weakref.WeakSet(t.untyped_storage() for t in op_analysis.tensors_of(args))
        self.seen = weakref.WeakSet()
        self.live = 0
        self.peak = 0

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten((args, kwargs, out))[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self.args or st in self.seen:
                continue
            self.seen.add(st)
            n = st.nbytes()
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def _parse_overrides(items) -> dict:
    out = {}
    for item in items or ():
        key, _, value = item.partition("=")
        for cast in (int, float):
            try:
                value = cast(value)
                break
            except ValueError:
                continue
        out[key] = value
    return out


def lower_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    layout: str = "fsdp_tp",
    remat: str = "full",
    moe_routing: str = "pjit",
    cache_layout: str = "feature",
    accum_steps: int = 1,
    mesh_shape=None,
    batch: Optional[int] = None,
    seq_len: Optional[int] = None,
    num_groups: Optional[int] = None,
    compress: bool = False,
    cfg_overrides: Optional[dict] = None,
) -> dict:
    """One cell's record (module docstring): the step of ``arch`` at
    ``shape_name`` (its batch and length replaced by ``batch`` and
    ``seq_len`` when given) run as rank 0 of the mesh on ``meta``."""
    cfg = get_config(arch, **(cfg_overrides or {}))
    shape = SHAPES[shape_name]
    if batch is not None or seq_len is not None:
        shape = dataclasses.replace(shape, global_batch=batch or shape.global_batch,
                                    seq_len=seq_len or shape.seq_len)
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    sizes = tuple(mesh_shape) if mesh_shape else ((2, 16, 16) if multi_pod else (16, 16))
    mesh_name = "x".join(map(str, sizes))
    chips = 1
    for s in sizes:
        chips *= s
    _fake_world(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, shape=mesh_shape)
    ctx = make_context(mesh, attn_impl="torch_chunked", remat=remat, moe_routing=moe_routing,
                       cache_layout=cache_layout)
    groups = num_groups or _num_groups(mesh)

    t0 = time.perf_counter()
    model = init_sharded(cfg, generator=None, mesh=mesh, layout=layout, device=META)
    param_bytes = _storage_bytes(model)
    specs = input_specs(cfg, shape, num_groups=groups)
    # A batch that the data shards do not divide (long_500k's one row) stays
    # whole on every rank, as the reference's batch_shardings replicates it.
    nb = _num_groups(mesh)
    rows = {k: local_rows(v, mesh) if v.dim() and k != "group_weights" and v.shape[0] % nb == 0 else v
            for k, v in specs.items()}
    if shape.kind == "train":
        ccfg = CompressionConfig() if compress else None
        state = init_train_state(cfg, generator=None, model=model, mesh=mesh, compression=ccfg)
        step = make_train_step(cfg, ctx, AdamWConfig(), compression=ccfg, accum_steps=accum_steps,
                               num_groups=groups)
        args = (state, rows)
    elif shape.kind == "prefill":
        step = lambda m, b: T.prefill(m, b, cfg, ctx)  # noqa: E731
        args = (model, rows)
    else:  # decode: one new token against a seq_len-deep cache, written at its last slot
        B = rows["tokens_t"].shape[0]
        cache = T.init_cache(cfg, B, shape.seq_len, device=META, model=model, ctx=ctx)
        step = lambda m, c, tok: T.decode_step(m, c, tok, shape.seq_len - 1, cfg, ctx)  # noqa: E731
        args = (model, cache, rows["tokens_t"])
    argument_bytes = _storage_bytes(args)
    live = _LiveBytes(args)
    result = []
    with live:
        ha = op_analysis.analyze(lambda *a: result.append(step(*a)), *args)
    t_lower = time.perf_counter() - t0
    mf = model_flops(cfg, shape)
    rep = roofline_terms(arch, shape_name, mesh_name, chips, ha, mf)
    out = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": chips,
        "layout": layout,
        "remat": remat,
        "moe_routing": moe_routing,
        "cache_layout": cache_layout,
        "accum_steps": accum_steps,
        "kind": shape.kind,
        "lower_s": t_lower,
        "compile_s": None,
        "flops_per_device": float(ha["flops"]),
        "bytes_per_device": float(ha["bytes"]),
        "xla_cost_flops_loop_once": None,
        "collectives": {
            "total_bytes": ha["collective_bytes"],
            "by_kind": ha["collectives_by_kind"],
            "ops": ha["collective_ops"],
            "calls_by_kind": ha["collective_calls_by_kind"],
        },
        "model_flops": mf["model_flops"],
        "active_params": mf["active_params"],
        "total_params": mf["total_params"],
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": _storage_bytes(result),
            "temp_bytes": live.peak,
            "generated_code_bytes": None,
            "param_bytes": param_bytes,
        },
        "roofline": rep.row(),
        "kernel_ops": ha["kernel_ops"],
    }
    if shape != SHAPES[shape_name]:
        out.update(batch=shape.global_batch, seq_len=shape.seq_len)
    if num_groups is not None or compress or cfg_overrides:
        out.update(num_groups=groups, compress=compress, overrides=dict(cfg_overrides or {}))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Dry run of the port's steps on a fake process group, on meta tensors")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--layout", default="fsdp_tp")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--moe-routing", default="pjit", choices=("pjit", "local"))
    ap.add_argument("--cache-layout", default="feature", choices=("feature", "seq"))
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--mesh-shape", default=None, help="e.g. 64x4 (same chip count), or 2x2")
    ap.add_argument("--out", default=None)
    ap.add_argument("--batch", type=int, default=None, help="the cell's global batch instead of the shape's")
    ap.add_argument("--seq-len", type=int, default=None, help="the cell's length instead of the shape's")
    ap.add_argument("--num-groups", type=int, default=None, help="a train cell's groups (default pod x data)")
    ap.add_argument("--compress", action="store_true", help="a train cell's step compresses its gradients")
    ap.add_argument("--override", action="append", default=[], metavar="KEY=VALUE",
                    help="a config field, e.g. param_dtype=bfloat16")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    mesh_shape = tuple(int(x) for x in args.mesh_shape.split("x")) if args.mesh_shape else None
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    sink = open(args.out, "a") if args.out else None
    failures = 0
    for arch, shape, mp in cells:
        mesh_name = args.mesh_shape or ("2x16x16" if mp else "16x16")
        tag = f"{arch} × {shape} × {mesh_name}"
        try:
            res = lower_cell(
                arch, shape, multi_pod=mp, layout=args.layout, remat=args.remat,
                moe_routing=args.moe_routing, cache_layout=args.cache_layout, accum_steps=args.accum,
                mesh_shape=mesh_shape, batch=args.batch, seq_len=args.seq_len, num_groups=args.num_groups,
                compress=args.compress, cfg_overrides=_parse_overrides(args.override),
            )
        except Exception as e:  # a failing cell is a bug in the system
            failures += 1
            res = {"arch": arch, "shape": shape, "mesh": mesh_name, "error": f"{type(e).__name__}: {e}"}
            traceback.print_exc()
        line = json.dumps(res)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        if "skipped" in res:
            print(f"[skip] {tag}: {res['skipped'][:80]}")
        elif "error" in res:
            print(f"[FAIL] {tag}: {res['error'][:200]}")
        else:
            r = res["roofline"]
            print(
                f"[ok] {tag}: lower={res['lower_s']:.1f}s "
                f"compute={r['compute_s']*1e3:.2f}ms memory={r['memory_s']*1e3:.2f}ms "
                f"coll={r['collective_s']*1e3:.2f}ms dom={r['dominant']} "
                f"useful={r['useful_ratio']:.2f} roofline={r['roofline_fraction']:.2f}",
                flush=True,
            )
    if sink:
        sink.close()
    if dist.is_initialized():
        dist.destroy_process_group()
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()

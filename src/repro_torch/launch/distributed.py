"""Node-parallel execution over ``torch.distributed``: the port's mesh.

The reference's ``MeshExecutor`` is single-controller: one process places
node-stacked arrays on a 1-D ``("nodes",)`` jax mesh and runs the per-node
function under ``shard_map``.  The port is multi-controller (SPMD): the
node axis is the ranks of a process group, and every rank runs the same
program (the same assignment, straggler draw, host LP, packing and seeds).
Every call of :class:`MeshExecutor` returns the same result on every rank,
so the ranks' control flow stays in lockstep, as one program.

* **Placement.**  Rank ``r`` of ``world`` owns one contiguous block of the
  node axis, padded with zero rows to ``world · ⌈s / world⌉`` (zero data,
  zero weights, zero recovery weight: inert in every weighted statistic).
* **Node-stacked arguments** arrive in one of two forms.  *Whole*: a host
  array or a tensor holding all ``s`` nodes, of which the rank takes its
  rows.  *Placed*: a :class:`~repro_torch.core.nodes.NodeBlock` (from
  :meth:`MeshExecutor.place_node_stacked`), holding only this rank's rows
  on its device, with its offset and the global node count.  Only a
  rank's own block ever reaches its device.
* **Local solve.**  Each rank runs the per-node function on its block.
  Draws batched over the node axis cover every node and keep the block's
  rows (:func:`~repro_torch.core.nodes.node_rand`), so a node draws the
  same uniforms whichever rank holds it, and as :class:`LocalExecutor`
  gives it.
* **Gather.**  :meth:`MeshExecutor.map_nodes` returns the whole
  node-stacked output on every rank, as the reference's global array is:
  each rank writes its block into a zeroed ``(world · rows, …)`` buffer and
  one ``all_reduce`` sums the buffers (``x + 0`` is exact).  Gloo carries
  ``all_reduce`` and ``broadcast`` on CUDA tensors but not ``all_gather``,
  so the executor uses ``all_reduce`` alone.
* **Combine.**  :meth:`MeshExecutor.resilient_reduce` is Lemma 3: a local
  ``resilient_sum`` over this rank's slice of ``b``, then
  :func:`~repro_torch.core.aggregation.resilient_psum` across the ranks.
  :meth:`MeshExecutor.resilient_reduce_masked` solves the recovery weights
  on every rank's device (the same solve, as every device of the
  reference's mesh solves redundantly) and slices this rank's block.  A
  node function that forms its block's combine itself
  (:func:`~repro_torch.core.executor.takes_weights`, a training step's
  Σ_i b_i·∇L_i) is handed the block's weights, and its output is summed
  over the ranks in place, one ``all_reduce`` per leaf in the tree's
  order.

**Steps.**  A rank's step is made by a factory, as the reference's jitted
program is: ``MeshExecutor._block_step`` carries the reference's
``@compiled_path`` name ``mesh.map_reduce`` (its ``_compiled``), and
``MeshExecutor._masked_step_raw`` ``mesh.masked_reduce``.

**Backends.**  NCCL needs one card per rank and carries only CUDA tensors;
gloo carries CPU tensors, and CUDA tensors for ``all_reduce`` and
``broadcast``.  On one card the mesh runs as a world of one over NCCL or as
several ranks over gloo, all on the card.  The backend is an argument
(:func:`run_ranks`, :func:`node_mesh`) or follows from the layout
(:func:`layout_backend`); a backend that cannot carry the tensors' device
raises.

**Launch.**  :func:`run_ranks` starts the ranks with the ``spawn`` start
method over a ``FileStore`` in a temporary directory (no TCP port), and
returns rank 0's result; any rank's failure or the deadline fails it.

Run the Figure-1 workload (``n=600, s=10, t=3, k=8``) through
:class:`~repro_torch.core.executor.LocalExecutor` and the mesh:

    PYTHONPATH=src python -m repro_torch.launch.distributed --world 4 --backend gloo --device cpu

(the card and the backend of the layout by default).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import hashlib
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..analysis import compiled_path
from ..core.aggregation import _tree_map, resilient_psum, resilient_sum
from ..core.executor import Executor, override_flag, takes_weights
from ..core.nodes import NodeBlock, block_bounds, drawing_block
from ..core.recovery import device_recovery_masked
from ..device import resolve_device
from ..obs import trace_span

__all__ = [
    "MeshExecutor",
    "NodeMesh",
    "digest",
    "layout_backend",
    "node_mesh",
    "rank_threads",
    "run_ranks",
]

INIT_TIMEOUT_S = 60.0  # a rank that dies before a collective frees the others after this

# The device the launcher gave this process's rank (None outside a rank).
_RANK_DEVICE: list[Optional[torch.device]] = [None]


@dataclasses.dataclass(frozen=True)
class NodeMesh:
    """A 1-D node mesh: the process group, this process's rank in it, the
    world size, the backend and this rank's device (``None``: the caller's)."""

    group: Any
    rank: int
    world: int
    backend: str
    device: Optional[torch.device]


def node_mesh(group=None, *, backend: Optional[str] = None, device=None) -> NodeMesh:
    """The node mesh over ``group`` (default: the default process group).

    With no default group, sets up a world of one in this process over a
    ``HashStore`` with ``backend`` (gloo unless given): the reference's
    one-device mesh in the main process.  A ``backend`` that differs from
    the group's, or NCCL without a CUDA device, raises."""
    if group is None:
        if not dist.is_initialized():
            dist.init_process_group(
                backend or "gloo", store=dist.HashStore(), rank=0, world_size=1,
                timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S),
            )
        group = dist.group.WORLD
    got = dist.get_backend(group)
    if backend is not None and backend != got:
        raise ValueError(f"node_mesh: asked for backend {backend!r}, the group runs {got!r}")
    if device is None:
        device = _RANK_DEVICE[0]
    if device is None and got == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    device = None if device is None else torch.device(device)
    if got == "nccl" and (device is None or device.type != "cuda"):
        raise ValueError("node_mesh: the nccl backend carries only CUDA tensors; give a cuda device")
    return NodeMesh(group, dist.get_rank(group), dist.get_world_size(group), got, device)


def layout_backend(world: int, device) -> str:
    """The backend of a layout: NCCL when every rank has a card of its own,
    gloo otherwise (CPU ranks, or several ranks sharing one card)."""
    device = torch.device(device)
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def digest(*values) -> str:
    """A hash of tensors, arrays, numbers and (nested) sequences of them:
    what ranks compare to show they hold the same bits."""
    h = hashlib.blake2b(digest_size=16)

    def feed(v):
        if isinstance(v, NodeBlock):
            v = v.local
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().contiguous()
            v = (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).numpy()  # numpy has no bf16
        if isinstance(v, np.ndarray):
            h.update(str((v.shape, v.dtype.str)).encode())
            h.update(np.ascontiguousarray(v).tobytes())
        elif isinstance(v, dict):
            for key in sorted(v):
                h.update(repr(key).encode())
                feed(v[key])
        elif isinstance(v, (list, tuple)):
            h.update(b"[")
            for x in v:
                feed(x)
            h.update(b"]")
        else:
            h.update(repr(v).encode())

    feed(values)
    return h.hexdigest()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class MeshExecutor(Executor):
    """Run per-node computations node-parallel over the ranks of a process
    group; see the module docstring.

    ``rows_written`` counts the node rows this rank wrote through
    :meth:`update_node_rows`, only rows of its own block, each array apart
    (a session's patch writes a moved node's row of the shards and of
    their weights: two).  Set ``timing`` to a dict to accumulate the
    seconds of the local per-node calls (``"local"``) and of the
    collectives (``"collectives"``), the device synchronised around each;
    ``None`` (the default) adds no synchronisation."""

    name = "mesh"

    def __init__(self, mesh: Optional[NodeMesh] = None):
        self.mesh = mesh if mesh is not None else node_mesh()
        self.rows_written = 0
        self.timing: Optional[dict] = None

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def num_devices(self) -> int:
        return self.mesh.world

    def describe(self) -> str:
        dev = self.mesh.device
        kind = torch.cuda.get_device_name(dev) if dev is not None and dev.type == "cuda" else "cpu"
        return f"mesh[{self.mesh.world}x{kind}/{self.mesh.backend}]"

    # ------------------------------------------------------------ internals

    def _bounds(self, s: int) -> tuple[int, int]:
        return block_bounds(s, self.mesh.world, self.mesh.rank)

    @contextlib.contextmanager
    def _timed(self, key: str, device: torch.device):
        if self.timing is None:
            yield
            return
        _sync(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(device)
            self.timing[key] = self.timing.get(key, 0.0) + time.perf_counter() - t0

    def _carried(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh.backend == "nccl" and t.device.type != "cuda":
            raise ValueError(f"the nccl backend cannot carry a tensor on {t.device}")
        return t

    def _pad_nodes(self, node_args):
        """This rank's block of each node-stacked argument, the node axis
        zero-padded to a multiple of the world size; returns ``(blocks, s)``.
        A whole argument is sliced where it lies (only the block is copied,
        and only to pad it); a placed one must be this rank's block of ``s``
        nodes."""
        first = node_args[0]
        s = first.num_nodes if isinstance(first, NodeBlock) else int(torch.as_tensor(first).shape[0])
        off, rows = self._bounds(s)
        blocks = []
        for a in node_args:
            if isinstance(a, NodeBlock):
                if a.num_nodes != s or a.offset != off or a.local.shape[0] != rows:
                    raise ValueError(
                        f"a placed block of {a.num_nodes} nodes at {a.offset} is not rank "
                        f"{self.rank}'s block of {s} nodes at {off}")
                blocks.append(a.local)
                continue
            t = torch.as_tensor(a)
            if t.shape[0] != s:
                raise ValueError(f"node-stacked arguments disagree on the node count: {t.shape[0]} vs {s}")
            blk = t[off: off + rows]
            if blk.shape[0] < rows:
                pad = torch.zeros((rows - blk.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
                blk = torch.cat([blk, pad])
            blocks.append(blk)
        return tuple(blocks), s

    def _run_block(self, fn, blocks, broadcast_args, s: int):
        off, rows = self._bounds(s)
        with drawing_block(off, rows, s), self._timed("local", blocks[0].device):
            return fn(*blocks, *broadcast_args)

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks in place (bool summed as uint8)."""
        self._carried(t)
        work = t.to(torch.uint8) if t.dtype == torch.bool else t
        with self._timed("collectives", t.device):
            dist.all_reduce(work, group=self.mesh.group)
        return work.bool() if t.dtype == torch.bool else work

    def _gather(self, tree, s: int):
        off, rows = self._bounds(s)

        def gather(leaf):
            leaf = torch.as_tensor(leaf)
            if leaf.shape[0] != rows:
                raise ValueError(
                    f"a per-node output of {leaf.shape[0]} rows for a block of {rows} nodes: "
                    "per-node functions keep the node axis first")
            buf = torch.zeros((self.mesh.world * rows, *leaf.shape[1:]), dtype=leaf.dtype, device=leaf.device)
            buf[off: off + rows] = leaf
            return self._all_reduce(buf)[:s]

        return _tree_map(gather, tree)

    def _combine(self, fn, blocks, broadcast_args, s: int, b_blk):
        """Lemma 3: this block's b-weighted sum, then the sum over ranks.  A
        ``fn`` that takes its weights forms the block's sum itself; that
        sum is the step's own buffers, so it is reduced in place."""
        if takes_weights(fn):
            off, rows = self._bounds(s)
            with drawing_block(off, rows, s), self._timed("local", b_blk.device):
                local = fn(*blocks, *broadcast_args, b=b_blk)
            return _tree_map(self._all_reduce, local)
        local = _tree_map(self._carried, resilient_sum(self._run_block(fn, blocks, broadcast_args, s), b_blk))
        with self._timed("collectives", b_blk.device):
            return resilient_psum(local, 1.0, self.mesh.group)

    @compiled_path("mesh.map_reduce", kind="factory")
    def _block_step(self, fn: Callable, n_node: int, s: int, reduce_: bool):
        """This rank's step over its ``n_node`` node blocks of ``s`` nodes:
        ``step(b_blk, *blocks, *broadcast_args)``, the Lemma-3 combine
        summed over the ranks, when ``reduce_``; else ``step(*blocks,
        *broadcast_args)``, the gathered node-stacked output (the
        reference's ``_compiled``)."""

        def reduce_step(b_blk, *args):
            return self._combine(fn, args[:n_node], args[n_node:], s, b_blk)

        def map_step(*args):
            return self._gather(self._run_block(fn, args[:n_node], args[n_node:], s), s)

        return reduce_step if reduce_ else map_step

    @compiled_path("mesh.masked_reduce", kind="factory")
    def _masked_step_raw(self, fn: Callable, n_node: int, s: int, iters: int):
        """The fused step on this rank, ``step(A, alive, use_override,
        b_override, *blocks, *broadcast_args) -> (combined, b_full)``: every
        rank solves the same (s, n) problem on its device and keeps the
        weights of its own block (the reference's ``_masked_step_raw``)."""

        def step(A, alive, use_override, b_override, *args):
            with trace_span("recovery.device_solve", nodes=A.shape[0], iters=iters):
                solved = device_recovery_masked(A, alive, iters=iters, device=A.device)
            b_full = torch.where(use_override, b_override, solved)
            (b_blk,), _ = self._pad_nodes((b_full,))
            return self._combine(fn, args[:n_node], args[n_node:], s, b_blk), b_full

        return step

    # -------------------------------------------------------------- seam API

    def map_nodes(self, fn, node_args, broadcast_args=()):
        blocks, s = self._pad_nodes(tuple(node_args))
        return self._block_step(fn, len(blocks), s, False)(*blocks, *broadcast_args)

    def resilient_reduce(self, fn, node_args, broadcast_args, b_full):
        blocks, s = self._pad_nodes(tuple(node_args))
        b = torch.as_tensor(b_full, dtype=torch.float32)
        (b_blk,), _ = self._pad_nodes((b.to(blocks[0].device),))
        return self._block_step(fn, len(blocks), s, True)(b_blk, *blocks, *broadcast_args)

    def resilient_reduce_masked(
        self, fn, node_args, broadcast_args, A, alive, *, iters: int = 300,
        b_override=None,
    ):
        blocks, s = self._pad_nodes(tuple(node_args))
        device = blocks[0].device
        A = torch.as_tensor(A, dtype=torch.float32, device=device)
        alive = torch.as_tensor(alive, device=device)
        use_ov, b_ov = override_flag(b_override, s, device)
        with trace_span(
            "executor.masked_reduce", executor=self.name, nodes=int(s),
            devices=self.num_devices, override=b_override is not None,
        ):
            step = self._masked_step_raw(fn, len(blocks), s, iters)
            return step(A, alive, use_ov, b_ov, *blocks, *broadcast_args)

    def replicated_compute(self, fn, args):
        """Every rank computes ``fn(*args)`` on its own inputs, which the
        lockstep program makes the same on every rank: every rank holds the
        result (the streaming tree's compactions survive any rank)."""
        return fn(*args)

    # --------------------------------------------------- placement helpers

    def _placement_device(self, device) -> torch.device:
        return resolve_device(device if device is not None else self.mesh.device)

    def place_node_stacked(self, arr, device=None) -> NodeBlock:
        """This rank's block of ``arr`` (padded) on ``device``: only the
        block crosses to the device, so the memory per rank falls with the
        world size."""
        device = self._placement_device(device)
        if isinstance(arr, NodeBlock):
            return NodeBlock(arr.local.to(device, copy=True), arr.offset, arr.num_nodes)
        (blk,), s = self._pad_nodes((arr,))
        return NodeBlock(blk.to(device, copy=True), self._bounds(s)[0], s)

    def place_broadcast(self, arr, device=None) -> torch.Tensor:
        return torch.as_tensor(arr).to(self._placement_device(device), copy=True)

    def gather_node_stacked(self, arr) -> torch.Tensor:
        """The whole node-stacked tensor of a placed one, on every rank."""
        return self.map_nodes(lambda x: x, (arr,))

    def update_node_rows(self, arr, rows: Sequence[int], new_rows) -> NodeBlock:
        """Write ``arr[rows[i]] = new_rows[i]`` for the rows of this rank's
        block, in place: rows of other blocks never cross to this rank's
        device.  A whole ``arr`` is placed first."""
        if not isinstance(arr, NodeBlock):
            arr = self.place_node_stacked(arr, getattr(arr, "device", None))
        lo, hi = arr.offset, min(arr.offset + arr.local.shape[0], arr.num_nodes)
        rows = [int(r) for r in rows]
        mine = [j for j, r in enumerate(rows) if lo <= r < hi]
        if mine:
            src = new_rows[torch.as_tensor(mine)] if isinstance(new_rows, torch.Tensor) else np.asarray(new_rows)[mine]
            idx = torch.as_tensor([rows[j] - lo for j in mine], dtype=torch.int64, device=arr.device)
            arr.local.index_copy_(0, idx, torch.as_tensor(src, dtype=arr.dtype).to(arr.device))
        self.rows_written += len(mine)
        return arr

    # ------------------------------------------------------ lockstep checks

    def gather_object(self, obj) -> list:
        """Every rank's ``obj`` (picklable), in rank order, on every rank."""
        out: list = [None] * self.num_devices
        dist.all_gather_object(out, obj, group=self.mesh.group)
        return out

    def same_on_all_ranks(self, *values) -> bool:
        """True iff every rank holds the same bits in ``values``."""
        return len(set(self.gather_object(digest(*values)))) == 1


_DEFAULT: dict = {}


def default_mesh_executor() -> MeshExecutor:
    """The executor on the default process group (a world of one in this
    process when none exists), one per group."""
    mesh = node_mesh()
    ex = _DEFAULT.get("mesh")
    if ex is None or ex.mesh.group is not mesh.group:
        ex = _DEFAULT["mesh"] = MeshExecutor(mesh)
    return ex


# ------------------------------------------------------------------ launch


def rank_threads(world: int, device) -> int:
    """The intra-op threads of one rank: one on the CPU, where every rank
    computes and several worlds may run at once (a share of the cores per
    rank oversubscribes them as soon as two worlds overlap, and gloo's
    lockstep then waits on the slowest rank), and the host's cores shared
    out among the ranks when a card computes."""
    if torch.device(device).type == "cpu":
        return 1
    return max(1, (os.cpu_count() or 1) // world)


def _rank_main(fn, args, rank, world, backend, device, store_path, results):
    try:
        torch.set_num_threads(rank_threads(world, device))
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        _RANK_DEVICE[0] = device
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S),
        )
        out = fn(*args)
        dist.barrier()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rank_device(device, rank: int, backend: str) -> str:
    device = torch.device(device)
    if device.type == "cuda" and backend == "nccl":
        return f"cuda:{rank}"  # one card per rank
    if device.type == "cuda" and device.index is None:
        return "cuda:0"
    return str(device)


def run_ranks(
    fn: Callable,
    world: int,
    *,
    backend: str,
    device,
    timeout: float,
    args: tuple = (),
) -> Any:
    """Run ``fn(*args)`` on ``world`` ranks and return rank 0's result.

    Each rank is a process started with ``spawn`` (safe after the parent
    touched CUDA) that joins a group over a ``FileStore`` in a temporary
    directory.  ``fn`` must be importable (a function of a module, not of
    ``__main__``).  ``device`` is where the ranks run: ``"cpu"``, or
    ``"cuda"`` (rank ``r`` on card ``r`` over NCCL, every rank on card 0
    over gloo).  Raises if any rank fails, with its traceback,
    or if ``timeout`` seconds pass; every rank is stopped before it returns.
    """
    import multiprocessing as mp

    if backend == "nccl" and torch.device(device).type != "cuda":
        raise ValueError("run_ranks: the nccl backend carries only CUDA tensors")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got: dict[int, Any] = {}
    with tempfile.TemporaryDirectory(prefix="repro-mesh-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            ctx.Process(
                target=_rank_main, daemon=True,
                args=(fn, args, r, world, backend, _rank_device(device, r, backend), store, results),
            )
            for r in range(world)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"run_ranks: {world - len(got)} of {world} ranks still running "
                                       f"after {timeout:.0f} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"run_ranks: rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} before reporting")
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} of {world} failed:\n{payload}")
                got[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=10 if len(got) == world else 0)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return got[0]


# --------------------------------------------------------------------- CLI


def main(argv=None) -> None:
    from . import mesh_runs

    ap = argparse.ArgumentParser(description="Figure 1 (n=600, s=10, t=3, k=8) through the local "
                                 "executor and through the mesh.")
    ap.add_argument("--world", type=int, default=2, help="ranks of the mesh (default 2)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl when each rank has a card, else gloo")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the card; raises without one)")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    backend = args.backend or layout_backend(args.world, device)
    if device.type == "cuda":
        from ..kernels import _build

        _build.build(("assign_min", "weighted_segsum", "min_dist_update"))  # once, before the ranks load them
    t0 = time.perf_counter()
    local = mesh_runs.fig1("local", str(device))
    t1 = time.perf_counter()
    mesh = run_ranks(mesh_runs.fig1_rank, args.world, backend=backend, device=device.type,
                     timeout=args.timeout)
    t2 = time.perf_counter()
    print(f"executor local: {t1 - t0:.3f} s; {mesh['describe']}, ranks on {mesh['device']}: "
          f"{t2 - t1:.3f} s (with the ranks' start)")
    for name in ("resilient_kmedian", "ignore_stragglers_kmedian"):
        print(f"{name}: local {local[name]:.6f}  mesh {mesh[name]:.6f}  "
              f"ratio {mesh[name] / local[name]:.9f}")
    print(f"ranks identical (b, shards, centers, costs): {mesh['lockstep']}")


if __name__ == "__main__":
    # Run main() of the importable module, not of __main__: the spawned ranks
    # unpickle run_ranks' rank function by its module's name.
    from repro_torch.launch.distributed import main as _main

    _main()

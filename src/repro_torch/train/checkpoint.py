"""Checkpoint/restore of a :class:`~repro_torch.train.train_step.TrainState`
as ``step_<n>.npz`` (the twin of the reference's ``train/checkpoint.py``).

Atomic rename (no torn checkpoints on a crash), keep-k rotation, a
``metadata.json`` naming the latest step, and restore into a template
state (a freshly initialised one), with its key and shape checks.  The
arrays are named ``params/<name>``, ``opt/step``, ``opt/m/<name>``,
``opt/v/<name>`` and ``ef/<name>`` after the model's parameter names; a
bf16 tensor is stored in f32 and restored into its template's dtype.  The
file is the one ``np.savez`` writes, its arrays streamed into it one at a
time.

Under an LM mesh (``mesh``) a rank holds its blocks of each tensor.  Each
tensor is gathered whole over the axes its spec splits, one tensor at a
time, and rank 0 writes it, so the file is the meshless one (the
reference's ``np.asarray`` of each global array) and no rank holds a
second copy of the state; a barrier then keeps every rank from reading the
directory before the file is in place.  Every rank restores by reading
each array's block (``launch.sharding.block_slices``, the narrowing
``shard_model`` applies) from the file memory-mapped, so a rank reads
the pages of its blocks only, and a meshless, a mesh and a reference
checkpoint all restore onto any mesh.

:func:`restore_checkpoint` also reads a checkpoint written by the
reference (its keys are pytree paths, ``.params/unit/slot0/attn/wq`` …):
the params, m, v, the error-feedback buffers and the step go through
``convert.train_state_from_jax``, which unstacks the reference's
per-slot layers into the port's names.
"""

from __future__ import annotations

import json
import os
import re
import struct
import tempfile
import zipfile
from typing import Iterable, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "list_checkpoints", "checkpoint_bytes"]

_STEP_RE = re.compile(r"^step_(\d+)\.npz$")


def _named_tensors(state) -> dict[str, tuple]:
    """The state's tensors by checkpoint name (the step aside), each with
    its parameter's spec (None when it has none)."""
    specs = {n: getattr(p, "mesh_spec", None) for n, p in state.params.named_parameters()}
    out = {f"params/{n}": (p, specs[n]) for n, p in state.params.named_parameters()}
    out.update({f"opt/m/{n}": (t, specs[n]) for n, t in state.opt.m.items()})
    out.update({f"opt/v/{n}": (t, specs[n]) for n, t in state.opt.v.items()})
    if state.ef is not None:
        out.update({f"ef/{n}": (t, specs[n]) for n, t in state.ef.items()})
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _split(spec, mesh) -> bool:
    return mesh is not None and spec is not None and any(a is not None and mesh.shape[a] > 1 for a in spec)


def _whole(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor of the rank's block t, gathered over each axis its
    spec splits (every rank of the mesh joins, in the same order)."""
    from ..launch import collectives as C

    for i, ax in enumerate(spec):
        if ax is not None:
            t = C.gather(t, mesh, ax, i)
    return t


def _write_npz(path: str, arrays: Iterable[tuple[str, np.ndarray]]) -> None:
    """The zip ``np.savez`` writes (stored, zip64), one array at a time."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, arr in arrays:
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr), allow_pickle=False)


class _Members:
    """The arrays of an ``np.savez`` file by name, each memory-mapped where
    its member is stored (every file this module and the reference's
    write), read whole where it is compressed."""

    def __init__(self, path: str):
        self.path = path
        self._zip = zipfile.ZipFile(path)
        self.files = [n[:-4] for n in self._zip.namelist() if n.endswith(".npy")]

    def __getitem__(self, key: str) -> np.ndarray:
        info = self._zip.getinfo(key + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            with self._zip.open(info) as f:
                return np.lib.format.read_array(f, allow_pickle=False)
        with open(self.path, "rb") as f:
            f.seek(info.header_offset)
            name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])  # the local file header
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read_header = np.lib.format.read_array_header_1_0 if version == (1, 0) else \
                np.lib.format.read_array_header_2_0
            shape, fortran, dtype = read_header(f)
            offset = f.tell()
        if not shape:
            return np.fromfile(self.path, dtype=dtype, count=1, offset=offset).reshape(())
        return np.memmap(self.path, dtype=dtype, mode="r", offset=offset, shape=shape, order="F" if fortran else "C")

    def close(self) -> None:
        self._zip.close()


def checkpoint_bytes(state) -> int:
    """The bytes of the arrays :func:`save_checkpoint` writes for a
    meshless ``state`` (f32 for a bf16 tensor): the file's size, less its
    zip and array headers."""
    total = 4
    for t, _ in _named_tensors(state).values():
        total += t.numel() * (4 if t.dtype == torch.bfloat16 else t.element_size())
    return total


@torch.no_grad()
def save_checkpoint(ckpt_dir: str, step: int, state, *, keep: int = 3, mesh=None) -> str:
    """Atomically write ``step_<n>.npz`` (+ metadata) and rotate old ones.
    Under ``mesh`` every rank calls it: the tensors are gathered whole one
    at a time, rank 0 writes them, and every rank returns after a barrier
    (module docstring)."""
    import torch.distributed as dist

    spread = mesh is not None and mesh.size > 1
    writer = not spread or dist.get_rank() == 0
    final = os.path.join(ckpt_dir, f"step_{step}.npz")

    def arrays():
        for key, (t, spec) in _named_tensors(state).items():
            whole = _whole(t, spec, mesh) if _split(spec, mesh) else t
            if writer:
                yield key, _to_numpy(whole)
            del whole
        if writer:
            yield "opt/step", np.asarray(state.opt.step, dtype=np.int32)

    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
        os.close(fd)
        try:
            _write_npz(tmp, arrays())
            os.replace(tmp, final)  # atomic on POSIX
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        meta_tmp = os.path.join(ckpt_dir, "metadata.json.tmp")
        with open(meta_tmp, "w") as f:
            json.dump({"latest_step": step}, f)
        os.replace(meta_tmp, os.path.join(ckpt_dir, "metadata.json"))
        for old in list_checkpoints(ckpt_dir)[:-keep]:
            os.unlink(os.path.join(ckpt_dir, f"step_{old}.npz"))
    else:
        for _ in arrays():  # the gathers, which rank 0 needs every rank to join
            pass
    if spread:
        dist.barrier()
    return final


def list_checkpoints(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_RE.match, os.listdir(ckpt_dir)) if m)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_checkpoints(ckpt_dir)
    return steps[-1] if steps else None


def _from_reference(data) -> dict[str, np.ndarray]:
    """A reference checkpoint's arrays under the port's names."""
    from ..convert import train_state_from_jax

    ts = train_state_from_jax({k: data[k] for k in data.files})
    flat = {"opt/step": np.asarray(ts["step"], dtype=np.int32)}
    for part, prefix in (("params", "params/"), ("m", "opt/m/"), ("v", "opt/v/"), ("ef", "ef/")):
        for n, t in (ts[part] or {}).items():
            flat[prefix + n] = t
    return flat


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, template, *, step: Optional[int] = None, mesh=None):
    """Restore into a congruent template state, written over its tensors
    in place (their devices and dtypes kept).  Under ``mesh`` the template
    holds the rank's blocks, and each whole array of the file is narrowed
    to them.  Returns (state, step)."""
    from ..launch.sharding import block_slices, full_shape

    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    names = _named_tensors(template)
    data = _Members(os.path.join(ckpt_dir, f"step_{step}.npz"))
    try:
        flat = _from_reference(data) if any(k.startswith(".params/") for k in data.files) else data
        keys = set(flat.files if flat is data else flat)
        if set(names) | {"opt/step"} != keys:
            missing = set(names) ^ (keys - {"opt/step"})
            raise ValueError(f"checkpoint/template mismatch on keys: {sorted(missing)[:5]}…")
        for key, (t, spec) in names.items():
            arr = flat[key]  # memory-mapped: only the block's pages are read
            split = _split(spec, mesh)
            want = full_shape(tuple(t.shape), spec, mesh) if split else tuple(t.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch at {key}: {arr.shape} vs {want}")
            block = arr[block_slices(arr.shape, spec, mesh)] if split else arr
            block = np.array(block, dtype=np.float32 if t.is_floating_point() else block.dtype, order="C")
            t.copy_(torch.from_numpy(block))  # the pages read, into a copy of the rank's own
            del arr, block
        opt_step = int(flat["opt/step"])
    finally:
        data.close()
    return template._replace(opt=template.opt._replace(step=opt_step)), step

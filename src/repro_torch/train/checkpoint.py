"""Checkpoint/restore of a :class:`~repro_torch.train.train_step.TrainState`
as ``step_<n>.npz`` (the twin of the reference's ``train/checkpoint.py``).

Atomic rename (no torn checkpoints on a crash), keep-k rotation, a
``metadata.json`` naming the latest step, and restore into a template
state (a freshly initialised one), with its key and shape checks.  The
arrays are named ``params/<name>``, ``opt/step``, ``opt/m/<name>``,
``opt/v/<name>`` and ``ef/<name>`` after the model's parameter names; a
bf16 tensor is stored in f32 and restored into its template's dtype.

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
import tempfile
from typing import Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "list_checkpoints"]

_STEP_RE = re.compile(r"^step_(\d+)\.npz$")


def _named_tensors(state) -> dict[str, torch.Tensor]:
    """The state's tensors by checkpoint name (the step aside)."""
    out = {f"params/{n}": p for n, p in state.params.named_parameters()}
    out.update({f"opt/m/{n}": t for n, t in state.opt.m.items()})
    out.update({f"opt/v/{n}": t for n, t in state.opt.v.items()})
    if state.ef is not None:
        out.update({f"ef/{n}": t for n, t in state.ef.items()})
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def save_checkpoint(ckpt_dir: str, step: int, state, *, keep: int = 3) -> str:
    """Atomically write ``step_<n>.npz`` (+ metadata) and rotate old ones."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {k: _to_numpy(t) for k, t in _named_tensors(state).items()}
    flat["opt/step"] = np.asarray(state.opt.step, dtype=np.int32)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        final = os.path.join(ckpt_dir, f"step_{step}.npz")
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
def restore_checkpoint(ckpt_dir: str, template, *, step: Optional[int] = None):
    """Restore into a congruent template state, written over its tensors
    in place (their devices and dtypes kept).  Returns (state, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}.npz")
    with np.load(path) as data:
        if any(k.startswith(".params/") for k in data.files):
            flat = _from_reference(data)
        else:
            flat = {k: data[k] for k in data.files}
    names = _named_tensors(template)
    if set(names) | {"opt/step"} != set(flat):
        missing = set(names) ^ (set(flat) - {"opt/step"})
        raise ValueError(f"checkpoint/template mismatch on keys: {sorted(missing)[:5]}…")
    for key, t in names.items():
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch at {key}: {arr.shape} vs {tuple(t.shape)}")
        t.copy_(torch.as_tensor(np.asarray(arr, dtype=np.float32) if t.is_floating_point() else arr))
    opt = template.opt._replace(step=int(flat["opt/step"]))
    return template._replace(opt=opt), step

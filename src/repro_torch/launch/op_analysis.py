"""Op-level cost analysis of a torch call (the port's twin of the
reference's ``launch/hlo_analysis.analyze_hlo``, which reads the compiled
HLO text of a jitted call).

:func:`analyze` runs ``fn(*args)`` once, eagerly, and returns the keys of
``analyze_hlo``:

* ``flops``: the matmul FLOPs, from ``torch.utils.flop_counter.FlopCounterMode``
  (matmuls, convolutions, fused attention), as the reference counts its
  ``dot`` ops; elementwise FLOPs are left out, as there.
* ``bytes``: the bytes of every aten op's tensor inputs and outputs, seen
  by a ``TorchDispatchMode`` (views and allocations touch none): XLA's
  "bytes accessed" model without fusion, so an upper bound on the HBM
  traffic of the call, which fused kernels would cut.
* ``collective_bytes``, ``collectives_by_kind``, ``collective_ops``,
  ``collective_calls_by_kind``: the change in ``launch.collectives.STATS``
  over the call.
* ``dot_ops``: the matmul calls and the kernel ops below.

A call through ``kernels/dispatch.py`` (seen by its ``observed`` hook) is
counted as one op by its shapes
(:data:`KERNEL_FLOPS`: flash attention 4·B·H·T·S·dh, the two dots of the
reference's ``attention_ref``; the distance kernels 2·n·k·d; the seeding's
one-center step 3·B·n·d, a difference and an FMA an element; the segment
sum none), its inputs read once and its output written once, and nothing
inside it is counted: the count is the same whether the hand-written
kernel (launched through ``ctypes``, which no aten hook sees) or its plain
version runs.  An autograd backward of the op is counted as what runs: on
the card the Function's plain backward, on the CPU autograd of the plain
forward.  ``kernel_ops`` gives the dispatched calls by op, ``flops_by_op``
the FLOPs by aten op and kernel op.

What has no twin: XLA's compile-time memory analysis (peak buffer sizes;
the port reads ``torch.cuda.max_memory_allocated`` instead) and fusion
(each eager op is its own kernel, so ``bytes`` counts what fusion would
keep on chip).
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["KERNEL_FLOPS", "analyze", "tensors_of"]


def _flash_flops(q, k, v, *_, **__) -> float:
    B, T, H, dh = q.shape
    return 4.0 * B * H * T * k.shape[1] * dh


def _distance_flops(x, c, *_, **__) -> float:
    return 2.0 * math.prod(x.shape[:-1]) * c.shape[-2] * x.shape[-1]


KERNEL_FLOPS = {
    "flash_attention": _flash_flops,
    "assign_min": _distance_flops,
    "pairwise_sqdist": _distance_flops,
    "min_dist_update": lambda x, *_, **__: 3.0 * x.numel(),
    "weighted_segsum": lambda *_, **__: 0.0,
}

_MATMULS = {"mm", "addmm", "bmm", "baddbmm", "convolution", "_scaled_dot_product_efficient_attention",
            "_scaled_dot_product_flash_attention", "_scaled_dot_product_cudnn_attention"}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense"}


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


def tensors_of(tree) -> list:
    """The tensors of an argument tree, a module's parameters and buffers
    and a NamedTuple's fields among them (a train state holds the model)."""
    out = []
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif isinstance(leaf, torch.nn.Module):
            out += list(leaf.parameters()) + list(leaf.buffers())
        elif isinstance(leaf, tuple) and hasattr(leaf, "_fields"):  # a NamedTuple pytree does not open
            out += tensors_of(list(leaf))
    return out


class _Traffic(TorchDispatchMode):
    """Adds the bytes of each aten op's tensor inputs and outputs, and
    counts the matmul calls."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.dots = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        if name in _MATMULS:
            self.dots += 1
        return out


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return its op-level costs
    (module docstring): ``flops``, ``bytes``, ``collective_bytes``,
    ``collectives_by_kind``, ``collective_ops``, ``collective_calls_by_kind``, ``dot_ops``, and
    ``kernel_ops`` and ``flops_by_op``."""
    from ..kernels import dispatch
    from . import collectives as C

    kernel_ops: dict = {}
    kernel_flops: dict = {}
    kernel_bytes = [0]

    def count(op, fn_op, *a, **kw):
        with _disable_current_modes():  # nothing inside the kernel or its plain version
            out = fn_op(*a, **kw)
        kernel_ops[op] = kernel_ops.get(op, 0) + 1
        kernel_flops[op] = kernel_flops.get(op, 0.0) + KERNEL_FLOPS[op](*a, **kw)
        kernel_bytes[0] += _nbytes((a, kw)) + _nbytes(out)
        return out

    calls0, bytes0 = dict(C.STATS.calls), dict(C.STATS.bytes)
    traffic = _Traffic()
    flop_mode = FlopCounterMode(display=False)
    with dispatch.observed(count), flop_mode, traffic:
        fn(*args, **kwargs)
    by_kind = {k: float(v - bytes0.get(k, 0)) for k, v in C.STATS.bytes.items() if v != bytes0.get(k, 0)}
    calls_by_kind = {k: v - calls0.get(k, 0) for k, v in C.STATS.calls.items() if v != calls0.get(k, 0)}
    flops_by_op = {str(op): float(n) for op, n in flop_mode.get_flop_counts().get("Global", {}).items()}
    flops_by_op.update({f"kernel:{op}": f for op, f in kernel_flops.items()})
    return {
        "flops": float(flop_mode.get_total_flops()) + sum(kernel_flops.values()),
        "bytes": float(traffic.bytes + kernel_bytes[0]),
        "collective_bytes": float(sum(by_kind.values())),
        "collectives_by_kind": by_kind,
        "collective_ops": sum(C.STATS.calls.values()) - sum(calls0.values()),
        "collective_calls_by_kind": calls_by_kind,
        "dot_ops": traffic.dots + sum(kernel_ops.values()),
        "kernel_ops": kernel_ops,
        "flops_by_op": flops_by_op,
    }

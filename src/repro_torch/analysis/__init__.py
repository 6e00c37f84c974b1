"""repro_torch.analysis: host-sync analysis of the port's hot paths (the
twin of the reference's ``repro.analysis``).

The paper's guarantees only hold if recovery genuinely stays on the device:
every hidden host round trip reintroduces the straggler-shaped latency tail
the redundant assignment scheme exists to remove.  The port runs eagerly,
so its contract is that a hot path's step is a fixed sequence of device
launches from which no value comes back to the host.  Two layers enforce it:

* **Layer 1, AST lint** (:mod:`repro_torch.analysis.ast_lint`): the
  reference's rules on torch code over ``src/repro_torch``: implicit host
  syncs on tensor values (``float()``, ``.item()``, ``.cpu()``, a Python
  branch on a tensor) and host solvers reachable from step code, found via
  the :func:`~repro_torch.analysis.registry.compiled_path` markers and a
  project-wide call graph.  Findings are fingerprinted against the port's
  baseline (:mod:`repro_torch.analysis.baseline`).
* **Layer 2, sync audit** (:mod:`repro_torch.analysis.sync_audit`, the
  twin of ``jaxpr_audit``): runs the registered hot paths
  (:mod:`repro_torch.analysis.hotpaths`) under a ``TorchDispatchMode`` and
  counts the aten ops that move a value to the host (zero on ``step`` and
  ``factory`` paths), and holds a bucket's two calls to the same sequence
  of ops and shapes (nothing value-dependent changes the program).

Entry point: ``python -m repro_torch.analysis`` (the twin of
``tools/lint.py``).

This module and :mod:`~repro_torch.analysis.registry`, which production
code imports for the decorator, import nothing; the audit imports torch.
"""

from .registry import compiled_path, registered_paths

__all__ = ["compiled_path", "registered_paths"]

"""Layer 1: repo-specific AST lint for host-sync hazards in torch code (the
twin of the reference's ``analysis/ast_lint.py``).

What counts as *compiled context* (code that must hold no host work):

* functions marked ``@compiled_path`` / ``@compiled_path(kind="step")``;
* every nested ``def`` of a ``@compiled_path(kind="factory")`` function;
* anything reachable from the above through the project call graph
  (:mod:`repro_torch.analysis.callgraph`).

The port builds no ``torch.compile`` and no CUDA graph, so nothing else
marks code as compiled: the reference's roots by ``@jax.jit`` and by a
function passed to ``jax.jit`` / ``vmap`` / ``lax.scan`` / … have no twin.

Inside compiled context the linter runs the reference's two-tier taint
pass: parameters are *param*-tainted, results of ``torch.*`` and
``F.*`` calls and of tensor methods on tainted values (and any expression
touching tainted values) are *derived*-tainted; ``.shape`` / ``.ndim`` /
``.dtype`` / ``.device`` / ``len()`` projections untaint (they are host
metadata of a tensor).  It flags:

====== ======== ==========================================================
rule   severity finding
====== ======== ==========================================================
JS101  error    ``float()``/``int()``/``bool()``/``complex()`` on a tensor
                value: an implicit blocking device→host read.  The method
                ``.float()`` is a dtype cast, not this builtin.
JS102  error    ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
                ``np.asarray()`` / ``np.array()`` on a tensor value: the
                value copied to the host.
JS103  error    ``if``/``while``/``assert``/ternary on a *derived* tensor
                value: Python control flow on device data reads it back
                (``is None`` structure checks are exempt).
JS104  error    Python ``for`` over a derived tensor value.
JS105  warn     [``kind="host"`` hot paths only] a per-value device read
                (``float()``/``.item()``/``.cpu()``/``np.asarray()``/… on
                a value a device call produced) beyond the one sanctioned
                read a step: one ``.cpu()`` or ``.tolist()`` of a
                ``torch.stack``/``torch.cat`` of the step's values (the
                twin of one ``jax.device_get``), or a ``HostFetch``.
JS203  info     branching on ``.shape``/``.size()``/``.numel()``/``len()``
                of tensor values inside compiled code: per-shape
                specialisation (non-fatal).
JS301  error    host solver (``solve_recovery``/``lp_recovery``/
                ``nnls_recovery``/``uniform_recovery``/``scipy.*``)
                reachable from compiled-step code.
====== ======== ==========================================================

Rules with no twin: ``JS201`` (a ``jax.jit`` built in a function body
without a cache) and ``JS202`` (non-hashable or array-valued static
arguments of ``jax.jit``) concern the staging of a jitted program; the
port stages none.

Inline suppression: append ``# repro-lint: disable=JS102`` (comma-separate
several rules) to the flagged line, the reference's syntax.  Cross-run
suppression: the baseline file (:mod:`repro_torch.analysis.baseline`).
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import re
from typing import Iterable, Optional

from .callgraph import FunctionInfo, Project, dotted_name, load_project

__all__ = ["Finding", "RULES", "lint_project", "lint_paths", "lint_source"]

RULES: dict[str, tuple[str, str]] = {
    "JS101": ("error", "host-sync cast on a tensor value inside compiled code"),
    "JS102": ("error", "host materialization of a tensor value inside compiled code"),
    "JS103": ("error", "Python branch on a tensor value inside compiled code"),
    "JS104": ("error", "Python iteration over a tensor value inside compiled code"),
    "JS105": ("warn", "per-value device sync on a hot host path"),
    "JS203": ("info", "shape-dependent Python control flow in compiled code"),
    "JS301": ("error", "host solver reachable from compiled-step code"),
}

_CAST_BUILTINS = {"float", "int", "bool", "complex"}
_NP_MATERIALIZE = {
    "np.asarray", "np.array", "np.ascontiguousarray", "np.asanyarray",
    "numpy.asarray", "numpy.array", "numpy.ascontiguousarray",
}
_MATERIALIZE_METHODS = {"item", "tolist", "cpu", "numpy", "__array__"}
# The reads a host path may make once a step: of a stacked tensor.
_SANCTIONED_READS = {"cpu", "tolist"}
_STACKERS = {"torch.stack", "torch.cat", "torch.concat"}
# Attribute projections of a tensor that are host metadata.
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "requires_grad", "itemsize", "layout"}
# Methods of a tensor that return host metadata.
_STATIC_METHODS = {"size", "dim", "numel", "element_size", "stride", "is_contiguous", "is_floating_point",
                   "data_ptr", "get_device"}
# torch calls that return host values.
_UNTAINTED_TORCH = {
    "torch.device", "torch.Generator", "torch.is_grad_enabled", "torch.get_default_dtype",
    "torch.cuda.is_available", "torch.cuda.current_device", "torch.is_tensor", "torch.finfo", "torch.iinfo",
    "torch.Size", "torch.no_grad", "torch.enable_grad", "torch.inference_mode",
}
# Builtins whose results are host data regardless of argument taint.
_UNTAINTED_BUILTINS = {
    "isinstance", "issubclass", "hasattr", "callable", "type", "id", "repr",
    "str", "format", "len", "getattr",
}
# Parameters that by repo convention hold static host config, never tensors.
_STATIC_PARAM_NAMES = {
    "self", "cls", "cfg", "config", "mcfg", "mesh", "ctx", "impl", "name",
    "kind", "axis", "axis_name", "model_axis", "fsdp_axis", "batch_axes",
    "window", "causal", "eps", "theta", "iters", "lr", "ell", "seed",
    "dtype", "compute_dtype", "method", "backend", "mode", "plan", "rng",
    "device", "generator", "group", "layout", "remat", "median", "opt_cfg",
    "compression", "num_shards", "scale",
}
# Methods that stay on the device when called on a tensor; any other
# method call degrades to its receiver's tier at most.
_ARRAY_METHODS = {
    "sum", "mean", "any", "all", "max", "min", "amax", "amin", "prod", "reshape", "view", "view_as",
    "transpose", "permute", "ravel", "flatten", "squeeze", "unsqueeze", "cumsum", "cumprod",
    "argmax", "argmin", "argsort", "sort", "clone", "copy_", "clamp", "clamp_min", "clamp_max",
    "round", "var", "std", "T", "mT", "float", "double", "half", "bfloat16", "int", "long", "bool",
    "to", "type_as", "contiguous", "expand", "expand_as", "repeat", "gather", "scatter", "index_select",
    "masked_fill", "where", "abs", "sqrt", "exp", "log", "add", "sub", "mul", "div", "matmul", "mm",
    "add_", "mul_", "sub_", "div_", "addcmul_", "index_add_", "index_copy_", "fill_", "zero_",
    "narrow", "split", "chunk", "detach", "norm", "pow", "neg", "sign", "eq", "ne", "lt", "le",
    "gt", "ge", "isfinite", "isnan", "nonzero", "topk", "softmax", "log_softmax",
}
# Host-side solver entry points that must never be reachable from a
# compiled step (module-qualified call-graph keys, plus raw-text patterns).
_HOST_SOLVER_KEYS = {
    "repro_torch.core.recovery:solve_recovery",
    "repro_torch.core.recovery:lp_recovery",
    "repro_torch.core.recovery:nnls_recovery",
    "repro_torch.core.recovery:uniform_recovery",
}
_HOST_SOLVER_NAMES = {"solve_recovery", "lp_recovery", "nnls_recovery", "uniform_recovery"}
_HOST_SOLVER_PATTERNS = re.compile(
    r"^(scipy\.|sp\.optimize|linprog$|nnls$|np\.linalg\.lstsq|numpy\.linalg\.lstsq)"
)
# Method names whose call results live on the device (host hot-path taint
# sources): the executor seam plus the `*_fn` step-callable idiom.
_DEVICE_PRODUCERS = {
    "resilient_reduce", "resilient_reduce_masked", "map_nodes",
    "replicated_compute", "place_node_stacked", "place_broadcast",
    "update_node_rows",
}
_DEVICE_HEADS = ("torch", "F")

_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=([A-Z0-9,\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    severity: str
    path: str          # as given to the linter (display form)
    module: str
    qualname: str
    line: int
    col: int
    message: str
    snippet: str       # stripped source line (fingerprint input)

    @property
    def fingerprint(self) -> str:
        # Line-number independent: survives unrelated edits above the finding.
        h = hashlib.sha1(f"{self.rule}|{self.module}|{self.qualname}|{self.snippet}".encode())
        return h.hexdigest()[:16]

    @property
    def fatal(self) -> bool:
        return self.severity in ("error", "warn")

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} [{self.severity}] "
            f"{self.qualname}: {self.message}"
        )


def _taint_max(*tiers: Optional[str]) -> Optional[str]:
    if "derived" in tiers:
        return "derived"
    if "param" in tiers:
        return "param"
    return None


def _is_none_check(test: ast.AST) -> bool:
    """``x is None`` / ``x is not None``: static structure checks."""
    return (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.ops[0], (ast.Is, ast.IsNot))
    )


def _compiled_path_marker(fn: FunctionInfo) -> Optional[str]:
    """Return the compiled_path kind if fn carries the decorator, else None."""
    for dec, name in zip(getattr(fn.node, "decorator_list", []), fn.decorators):
        if not name or name.split(".")[-1] != "compiled_path":
            continue
        if isinstance(dec, ast.Call):
            for kw in dec.keywords:
                if kw.arg == "kind" and isinstance(kw.value, ast.Constant):
                    return str(kw.value.value)
        return "step"
    return None


class _CompiledContext:
    """Discovery of compiled-context functions across a Project."""

    def __init__(self, proj: Project):
        self.proj = proj
        self.kinds: dict[str, str] = {}       # key -> marker kind (explicit)
        self.roots: set[str] = set()
        for key, fn in proj.functions.items():
            kind = _compiled_path_marker(fn)
            if not kind:
                continue
            self.kinds[key] = kind
            if kind == "step":
                self.roots.add(key)
            elif kind == "factory":
                prefix = f"{fn.qualname}.<locals>."
                self.roots |= {k2 for k2, fn2 in proj.functions.items()
                               if fn2.module == fn.module and fn2.qualname.startswith(prefix)}
        self.compiled: set[str] = proj.reachable(self.roots)
        # Host hot paths are linted under their own rules, never propagated.
        self.compiled -= {k for k, kind in self.kinds.items() if kind in ("host", "factory")}


class _FunctionLinter:
    """Taint pass + rule checks over ONE function body (nested defs skipped)."""

    def __init__(self, fn: FunctionInfo, *, mode: str, findings: list[Finding], source_lines: list[str],
                 display_path: str):
        self.fn = fn
        self.mode = mode  # "compiled" | "host"
        self.findings = findings
        self.lines = source_lines
        self.display_path = display_path
        self.taint: dict[str, str] = {}
        self.reads = 0  # sanctioned host reads seen (host mode)
        if mode == "compiled":
            args = fn.node.args
            for a in (
                list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
                + ([args.vararg] if args.vararg else [])
                + ([args.kwarg] if args.kwarg else [])
            ):
                if a.arg not in _STATIC_PARAM_NAMES:
                    self.taint[a.arg] = "param"

    # ------------------------------------------------------------ taint pass

    def _call_taint(self, node: ast.Call) -> Optional[str]:
        name = dotted_name(node.func) or ""
        arg_taint = _taint_max(
            *[self._expr(a) for a in node.args],
            *[self._expr(kw.value) for kw in node.keywords],
        )
        if name in _UNTAINTED_TORCH or name in _UNTAINTED_BUILTINS:
            return None
        head = name.split(".")[0]
        last = name.split(".")[-1]
        if head in _DEVICE_HEADS:
            return "derived"
        if self.mode == "host":
            if last in _DEVICE_PRODUCERS or last.endswith("_fn"):
                return "derived"
            if isinstance(node.func, ast.Call):  # curried step callable
                return "derived"
        if isinstance(node.func, ast.Attribute):
            base = self._expr(node.func.value)
            if base:
                if node.func.attr in _STATIC_METHODS or node.func.attr in _MATERIALIZE_METHODS:
                    return None  # host metadata, or a host copy (flagged by the rule pass)
                if node.func.attr in _ARRAY_METHODS:
                    return "derived"
                return _taint_max(base, arg_taint) and "param"
        if name in _CAST_BUILTINS:
            return None  # result is host data by construction
        # Generic call: taint flows through but never *escalates*: only
        # torch calls (and tensor methods) mint derived values.
        return "param" if arg_taint else None

    def _expr(self, node: Optional[ast.AST]) -> Optional[str]:
        if node is None or isinstance(node, ast.Constant):
            return None
        if isinstance(node, ast.Name):
            return self.taint.get(node.id)
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return None
            return self._expr(node.value)
        if isinstance(node, ast.Subscript):
            return _taint_max(self._expr(node.value))
        if isinstance(node, ast.Call):
            return self._call_taint(node)
        if isinstance(node, ast.BinOp):
            return _taint_max(self._expr(node.left), self._expr(node.right))
        if isinstance(node, ast.UnaryOp):
            return self._expr(node.operand)
        if isinstance(node, ast.BoolOp):
            return _taint_max(*[self._expr(v) for v in node.values])
        if isinstance(node, ast.Compare):
            return _taint_max(self._expr(node.left), *[self._expr(c) for c in node.comparators])
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return _taint_max(*[self._expr(e) for e in node.elts])
        if isinstance(node, ast.Starred):
            return self._expr(node.value)
        if isinstance(node, ast.IfExp):
            return _taint_max(self._expr(node.body), self._expr(node.orelse))
        if isinstance(node, ast.Dict):
            return _taint_max(*[self._expr(v) for v in node.values])
        return None

    def _assign_targets(self, target: ast.AST, tier: Optional[str]) -> None:
        if isinstance(target, ast.Name):
            if tier:
                self.taint[target.id] = _taint_max(self.taint.get(target.id), tier)
            else:
                self.taint.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._assign_targets(el, tier)
        elif isinstance(target, ast.Starred):
            self._assign_targets(target.value, tier)
        # attribute/subscript targets: no local name to track

    def _taint_pass(self, body: Iterable[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                self.taint.pop(stmt.name, None)  # nested defs are host callables
                continue
            if isinstance(stmt, ast.Assign):
                tier = self._expr(stmt.value)
                for t in stmt.targets:
                    self._assign_targets(t, tier)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                self._assign_targets(stmt.target, self._expr(stmt.value))
            elif isinstance(stmt, ast.AugAssign):
                tier = _taint_max(self._expr(stmt.value), self._expr(stmt.target))
                self._assign_targets(stmt.target, tier)
            elif isinstance(stmt, ast.For):
                self._assign_targets(stmt.target, self._expr(stmt.iter))
                self._taint_pass(stmt.body)
                self._taint_pass(stmt.orelse)
            elif isinstance(stmt, (ast.If, ast.While)):
                self._taint_pass(stmt.body)
                self._taint_pass(stmt.orelse)
            elif isinstance(stmt, ast.With):
                for item in stmt.items:
                    if item.optional_vars is not None:
                        self._assign_targets(item.optional_vars, self._expr(item.context_expr))
                self._taint_pass(stmt.body)
            elif isinstance(stmt, ast.Try):
                self._taint_pass(stmt.body)
                for h in stmt.handlers:
                    self._taint_pass(h.body)
                self._taint_pass(stmt.orelse)
                self._taint_pass(stmt.finalbody)

    # ------------------------------------------------------------ rule pass

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", self.fn.node.lineno)
        idx = line - 1
        snippet = self.lines[idx].strip() if 0 <= idx < len(self.lines) else ""
        self.findings.append(
            Finding(
                rule=rule, severity=RULES[rule][0], path=self.display_path,
                module=self.fn.module, qualname=self.fn.qualname,
                line=line, col=getattr(node, "col_offset", 0),
                message=message, snippet=snippet,
            )
        )

    def _sanctioned(self, call: ast.Call, last: str) -> bool:
        """The host path's one read a step: ``.cpu()``/``.tolist()`` of a
        ``torch.stack``/``torch.cat``, the first such call in the body."""
        if self.mode != "host" or last not in _SANCTIONED_READS or not isinstance(call.func, ast.Attribute):
            return False
        recv = call.func.value
        if isinstance(recv, ast.Call) and isinstance(recv.func, ast.Attribute) and recv.func.attr == "cpu":
            recv = recv.func.value  # x.cpu().tolist() is one read
        if not (isinstance(recv, ast.Call) and dotted_name(recv.func) in _STACKERS):
            return False
        self.reads += 1
        return self.reads == 1

    def _check_expr_rules(self, node: ast.AST) -> None:
        inner_reads: set[int] = set()  # x.cpu() inside x.cpu().tolist(): one read
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            name = dotted_name(sub.func) or ""
            if id(sub) in inner_reads:
                continue
            if name in _CAST_BUILTINS and sub.args:
                tier = self._expr(sub.args[0])
                if tier and self.mode == "compiled":
                    self._emit(
                        "JS101", sub,
                        f"{name}() on a tensor value forces a blocking device→host sync; keep the value "
                        "on the device (torch ops) or read it once, stacked, on the host path",
                    )
                elif tier == "derived" and self.mode == "host":
                    self._emit(
                        "JS105", sub,
                        f"{name}() on a device value: a separate blocking transfer per value; stack every "
                        "per-step value and read them with ONE .cpu()/.tolist()",
                    )
            elif name in _NP_MATERIALIZE or (isinstance(sub.func, ast.Attribute)
                                             and sub.func.attr in _MATERIALIZE_METHODS):
                method = isinstance(sub.func, ast.Attribute) and sub.func.attr in _MATERIALIZE_METHODS
                if method:
                    recv = sub.func.value
                    tier = self._expr(recv)
                    if isinstance(recv, ast.Call) and isinstance(recv.func, ast.Attribute) \
                            and recv.func.attr in _MATERIALIZE_METHODS:
                        inner_reads.add(id(recv))
                        tier = self._expr(recv.func.value)
                else:
                    tier = self._expr(sub.args[0]) if sub.args else None
                label = sub.func.attr if method else name
                if tier and self.mode == "compiled":
                    self._emit(
                        "JS102", sub,
                        f"{label}() copies a tensor value to the host inside compiled code; keep the "
                        "computation on the device",
                    )
                elif tier == "derived" and self.mode == "host" and not self._sanctioned(sub, label):
                    self._emit(
                        "JS105", sub,
                        f"{label}() on a device value: a separate blocking transfer per value; stack every "
                        "per-step value and read them with ONE .cpu()/.tolist()",
                    )

    def _shape_dependent(self, test: ast.AST) -> bool:
        for sub in ast.walk(test):
            if isinstance(sub, ast.Attribute) and sub.attr in ("shape", "ndim"):
                if isinstance(sub.value, ast.Name) and sub.value.id in self.taint:
                    return True
            if isinstance(sub, ast.Call):
                if isinstance(sub.func, ast.Attribute) and sub.func.attr in ("size", "numel", "dim") \
                        and isinstance(sub.func.value, ast.Name) and sub.func.value.id in self.taint:
                    return True
                if dotted_name(sub.func) == "len" and sub.args and isinstance(sub.args[0], ast.Name) \
                        and sub.args[0].id in self.taint:
                    return True
        return False

    def _check_stmt_rules(self, body: Iterable[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            tests: list[ast.AST] = []
            if isinstance(stmt, (ast.If, ast.While, ast.Assert)):
                tests.append(stmt.test)
            if self.mode == "compiled":
                for test in tests:
                    if _is_none_check(test):
                        continue
                    if self._shape_dependent(test):
                        self._emit(
                            "JS203", stmt,
                            "branch on .shape/.size()/.numel()/len() of a tensor value: per-shape "
                            "specialisation; every distinct shape takes its own path",
                        )
                    elif self._expr(test) == "derived":
                        self._emit(
                            "JS103", stmt,
                            "Python control flow on a tensor value reads it back to the host; use "
                            "torch.where",
                        )
                if isinstance(stmt, ast.For) and self._expr(stmt.iter) == "derived":
                    self._emit(
                        "JS104", stmt,
                        "Python iteration over a tensor value reads it element by element; index with "
                        "tensor ops",
                    )
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.IfExp) and not _is_none_check(sub.test):
                        if self._expr(sub.test) == "derived":
                            self._emit("JS103", sub, "ternary on a tensor value: use torch.where")
            self._check_expr_rules(stmt)
            if isinstance(stmt, (ast.If, ast.While, ast.For)):
                self._check_stmt_rules(stmt.body)
                self._check_stmt_rules(stmt.orelse)
            elif isinstance(stmt, ast.With):
                self._check_stmt_rules(stmt.body)
            elif isinstance(stmt, ast.Try):
                self._check_stmt_rules(stmt.body)
                for h in stmt.handlers:
                    self._check_stmt_rules(h.body)
                self._check_stmt_rules(stmt.orelse)
                self._check_stmt_rules(stmt.finalbody)

    def run(self) -> None:
        body = self.fn.node.body
        self._taint_pass(body)
        self._taint_pass(body)  # second pass: fixpoint for use-before-def
        self._check_stmt_rules(body)


def _emit_free(findings, proj, fn, node, rule, display, lines, message):
    path = proj.modules[fn.module].path if fn.module in proj.modules else "<unknown>"
    src = lines.get(fn.module, [])
    line = getattr(node, "lineno", 1)
    snippet = src[line - 1].strip() if 0 < line <= len(src) else ""
    findings.append(
        Finding(
            rule=rule, severity=RULES[rule][0], path=display.get(fn.module, path),
            module=fn.module, qualname=fn.qualname,
            line=line, col=getattr(node, "col_offset", 0),
            message=message, snippet=snippet,
        )
    )


def _lint_host_solver_reachability(ctx: _CompiledContext, findings: list[Finding], display, lines) -> None:
    proj = ctx.proj
    for key in sorted(ctx.compiled):
        fn = proj.functions[key]
        for callee in sorted(fn.resolved):
            last = callee.split(":")[-1].split(".")[-1]
            if callee in _HOST_SOLVER_KEYS or last in _HOST_SOLVER_NAMES:
                node = _call_node(fn, last) or fn.node
                _emit_free(
                    findings, proj, fn, node, "JS301", display, lines,
                    f"host solver {callee.split(':')[-1]!r} is reachable from compiled-step code: LP/NNLS "
                    "solves belong on the host prelude (ResilienceSession.recovery), the step must use "
                    "device_recovery_masked",
                )
        solver_callees = {c.split(":")[-1].split(".")[-1] for c in fn.resolved}
        for raw in sorted(fn.calls):
            last = raw.split(".")[-1]
            if last in _HOST_SOLVER_NAMES and last not in solver_callees:
                _emit_free(
                    findings, proj, fn, _call_node(fn, last) or fn.node, "JS301", display, lines,
                    f"host solver {last!r} called from compiled-step code: LP/NNLS solves belong on the "
                    "host prelude (ResilienceSession.recovery), the step must use device_recovery_masked",
                )
                continue
            if _HOST_SOLVER_PATTERNS.match(raw):
                _emit_free(
                    findings, proj, fn, _call_node(fn, last) or fn.node, "JS301", display, lines,
                    f"host solver call {raw!r} inside compiled-step code",
                )


def _call_node(fn: FunctionInfo, last_component: str) -> Optional[ast.AST]:
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name and name.split(".")[-1] == last_component:
                return node
    return None


def _suppressions(source: str) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), 1):
        m = _SUPPRESS_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def lint_project(proj: Project, *, display_paths: Optional[dict[str, str]] = None) -> list[Finding]:
    """Run every Layer-1 rule over a loaded Project; returns unsuppressed
    findings sorted by (path, line)."""
    display = display_paths or {m.name: m.path for m in proj.modules.values()}
    lines = {m.name: m.source.splitlines() for m in proj.modules.values()}
    ctx = _CompiledContext(proj)
    findings: list[Finding] = []

    for key in sorted(ctx.compiled):
        fn = proj.functions[key]
        _FunctionLinter(fn, mode="compiled", findings=findings, source_lines=lines[fn.module],
                        display_path=display[fn.module]).run()
    for key, kind in sorted(ctx.kinds.items()):
        if kind == "host" and key in proj.functions:
            fn = proj.functions[key]
            _FunctionLinter(fn, mode="host", findings=findings, source_lines=lines[fn.module],
                            display_path=display[fn.module]).run()
    _lint_host_solver_reachability(ctx, findings, display, lines)

    sup = {m.name: _suppressions(m.source) for m in proj.modules.values()}
    kept = [f for f in findings if f.rule not in sup.get(f.module, {}).get(f.line, set())]
    # dedupe (a call can be reachable through several rule walks)
    seen: set[tuple] = set()
    uniq = []
    for f in sorted(kept, key=lambda f: (f.path, f.line, f.rule, f.col)):
        k = (f.rule, f.module, f.line, f.col, f.message)
        if k not in seen:
            seen.add(k)
            uniq.append(f)
    return uniq


def lint_paths(paths: Iterable[str]) -> list[Finding]:
    return lint_project(load_project(paths))


def lint_source(source: str, *, module: str = "fixture", path: str = "<fixture>") -> list[Finding]:
    """Lint a source string (test fixtures)."""
    proj = Project()
    proj.add_module(module, path, source)
    proj.resolve_all()
    return lint_project(proj, display_paths={module: path})

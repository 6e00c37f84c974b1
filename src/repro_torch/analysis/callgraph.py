"""Project-wide symbol table and call graph for the AST linter (a copy of
the reference's ``analysis/callgraph.py``, which is pure syntax).

Pure-syntax (no imports of the analyzed code): every ``*.py`` under the
scanned roots is parsed once, every function/method def (at any nesting
depth) becomes a node, and calls are resolved *heuristically* — by local
name, ``from X import y`` alias, ``import X as m`` attribute, or
``self.method`` within a class.  Unresolvable calls keep their dotted text
so pattern rules (``scipy.optimize.*``) still see them.

The resolution is deliberately name-based, not type-based: it can miss
dynamically-passed callables (an ``fn`` argument threaded through an
executor) — that is exactly the hole the ``@compiled_path`` markers close
from the producer side.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterable, Optional

__all__ = ["FunctionInfo", "ModuleInfo", "Project", "load_project", "dotted_name"]


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass
class FunctionInfo:
    module: str                   # dotted module, e.g. "repro_torch.core.recovery"
    qualname: str                 # e.g. "LocalExecutor._compiled_masked"
    node: ast.AST                 # FunctionDef | AsyncFunctionDef | Lambda
    path: str                     # source file
    decorators: list[str]         # dotted decorator names (call or bare)
    parent: Optional[str]         # qualname of the enclosing function, if any
    calls: set[str] = dataclasses.field(default_factory=set)      # raw dotted call texts
    resolved: set[str] = dataclasses.field(default_factory=set)   # "module:qualname" keys

    @property
    def key(self) -> str:
        return f"{self.module}:{self.qualname}"

    @property
    def class_prefix(self) -> Optional[str]:
        """``Cls`` for methods ``Cls.meth`` (one level only)."""
        if "." in self.qualname:
            head = self.qualname.rsplit(".", 1)[0]
            # strip "<locals>" chains: only plain Cls.meth counts as a method
            if "<locals>" not in head and "." not in head:
                return head
        return None


@dataclasses.dataclass
class ModuleInfo:
    name: str
    path: str
    tree: ast.Module
    source: str
    # local alias -> dotted target ("numpy", "repro_torch.core.recovery.solve_recovery", …)
    imports: dict[str, str] = dataclasses.field(default_factory=dict)
    functions: dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    toplevel: set[str] = dataclasses.field(default_factory=set)  # module-level def names


class Project:
    """All parsed modules plus the cross-module call graph."""

    def __init__(self):
        self.modules: dict[str, ModuleInfo] = {}
        self.functions: dict[str, FunctionInfo] = {}  # key -> info

    # -------------------------------------------------------------- loading

    def add_module(self, name: str, path: str, source: str) -> ModuleInfo:
        tree = ast.parse(source, filename=path)
        mod = ModuleInfo(name=name, path=path, tree=tree, source=source)
        self.modules[name] = mod
        self._collect_imports(mod)
        self._collect_functions(mod)
        return mod

    @staticmethod
    def _collect_imports(mod: ModuleInfo) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mod.imports[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module is not None:
                base = node.module
                if node.level:  # relative import: resolve against this module
                    pkg = mod.name.split(".")
                    pkg = pkg[: len(pkg) - node.level]
                    base = ".".join(pkg + ([node.module] if node.module else []))
                for a in node.names:
                    if a.name == "*":
                        continue
                    mod.imports[a.asname or a.name] = f"{base}.{a.name}"
            elif isinstance(node, ast.ImportFrom) and node.module is None and node.level:
                pkg = mod.name.split(".")
                base = ".".join(pkg[: len(pkg) - node.level])
                for a in node.names:
                    mod.imports[a.asname or a.name] = f"{base}.{a.name}"

    def _collect_functions(self, mod: ModuleInfo) -> None:
        proj = self

        class Collector(ast.NodeVisitor):
            def __init__(self):
                self.stack: list[str] = []  # qualname parts
                self.fn_stack: list[FunctionInfo] = []

            def _qual(self, name: str) -> str:
                return ".".join(self.stack + [name])

            def visit_ClassDef(self, node: ast.ClassDef):
                self.stack.append(node.name)
                self.generic_visit(node)
                self.stack.pop()

            def _visit_fn(self, node, name: str):
                qual = self._qual(name)
                info = FunctionInfo(
                    module=mod.name, qualname=qual, node=node, path=mod.path,
                    decorators=[
                        dotted_name(d.func if isinstance(d, ast.Call) else d) or ""
                        for d in getattr(node, "decorator_list", [])
                    ],
                    parent=self.fn_stack[-1].qualname if self.fn_stack else None,
                )
                mod.functions[qual] = info
                proj.functions[info.key] = info
                if not self.stack:
                    mod.toplevel.add(name)
                self.stack.append(name)
                self.stack.append("<locals>")
                self.fn_stack.append(info)
                self.generic_visit(node)
                self.fn_stack.pop()
                self.stack.pop()
                self.stack.pop()

            def visit_FunctionDef(self, node):
                self._visit_fn(node, node.name)

            def visit_AsyncFunctionDef(self, node):
                self._visit_fn(node, node.name)

            def visit_Call(self, node: ast.Call):
                if self.fn_stack:
                    name = dotted_name(node.func)
                    if name:
                        self.fn_stack[-1].calls.add(name)
                self.generic_visit(node)

        Collector().visit(mod.tree)

    # ------------------------------------------------------------ resolution

    def resolve_call(self, caller: FunctionInfo, call: str) -> Optional[str]:
        """Best-effort resolution of a dotted call text to a function key."""
        mod = self.modules.get(caller.module)
        if mod is None:
            return None
        head, _, rest = call.partition(".")
        # self.method / cls.method → method on the caller's class
        if head in ("self", "cls") and rest and "." not in rest:
            prefix = caller.class_prefix
            if prefix:
                key = f"{caller.module}:{prefix}.{rest}"
                if key in self.functions:
                    return key
            return None
        # sibling nested def: foo defined in the same enclosing function
        if not rest and caller.parent is not None:
            key = f"{caller.module}:{caller.parent}.<locals>.{call}"
            if key in self.functions:
                return key
        # module-local top-level def
        if not rest and call in mod.toplevel:
            return f"{caller.module}:{call}"
        # from X import y  (possibly y itself dotted further: y.z → method)
        if head in mod.imports:
            target = mod.imports[head]
            if not rest:  # direct imported function
                tmod, _, tname = target.rpartition(".")
                key = f"{tmod}:{tname}"
                if key in self.functions:
                    return key
                return None
            # imported module (import X as m) → m.f, or imported class → C.meth
            key = self._lookup_dotted(f"{target}.{rest}")
            if key:
                return key
        return None

    def _lookup_dotted(self, dotted: str) -> Optional[str]:
        """Split ``pkg.mod.func`` / ``pkg.mod.Cls.meth`` into module:qualname."""
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:cut])
            if mod in self.modules:
                qual = ".".join(parts[cut:])
                key = f"{mod}:{qual}"
                if key in self.functions:
                    return key
        return None

    def resolve_all(self) -> None:
        for fn in self.functions.values():
            for call in fn.calls:
                key = self.resolve_call(fn, call)
                if key:
                    fn.resolved.add(key)

    # ------------------------------------------------------------- traversal

    def reachable(self, roots: Iterable[str]) -> set[str]:
        """Transitive closure over resolved call edges."""
        seen: set[str] = set()
        stack = [r for r in roots if r in self.functions]
        while stack:
            key = stack.pop()
            if key in seen:
                continue
            seen.add(key)
            for nxt in self.functions[key].resolved:
                if nxt not in seen:
                    stack.append(nxt)
        return seen


def module_name_for(path: str, root: str, root_package: str) -> str:
    rel = os.path.relpath(path, root)
    parts = rel[:-3].split(os.sep)  # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([root_package] + parts) if parts else root_package


def load_project(paths: Iterable[str]) -> Project:
    """Parse files/directories into a Project.

    Directory entries are walked for ``*.py``; the dotted module name is
    derived from the path relative to the entry (an entry ending in
    ``src/repro_torch`` maps to package ``repro_torch``).  Single files get their stem
    as module name.
    """
    proj = Project()
    for entry in paths:
        entry = os.path.abspath(entry)
        if os.path.isdir(entry):
            pkg = os.path.basename(entry.rstrip(os.sep))
            for dirpath, dirnames, filenames in os.walk(entry):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for f in sorted(filenames):
                    if not f.endswith(".py"):
                        continue
                    p = os.path.join(dirpath, f)
                    name = module_name_for(p, entry, pkg)
                    with open(p, encoding="utf-8") as fh:
                        proj.add_module(name, p, fh.read())
        elif entry.endswith(".py"):
            name = os.path.basename(entry)[:-3]
            with open(entry, encoding="utf-8") as fh:
                proj.add_module(name, entry, fh.read())
    proj.resolve_all()
    return proj

"""repro_torch.analysis: the reference's conformance tests
(``tests/test_analysis.py``) on torch code: per-rule lint fixtures
(positive and negative), the registry, the baseline round trip and
fingerprint stability, the self-scan of ``src/repro_torch``, the parity of
the port's ``@compiled_path`` markers with the reference's, and the sync
audit (Layer 2) on the CPU."""

import os
import textwrap

import pytest
import torch

from repro_torch.analysis import baseline as bl
from repro_torch.analysis import compiled_path, registered_paths
from repro_torch.analysis.ast_lint import RULES, lint_paths, lint_source
from repro_torch.analysis.registry import KINDS

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO_ROOT, "src", "repro_torch")


def _rules(src: str) -> set:
    return {f.rule for f in lint_source(textwrap.dedent(src))}


# ------------------------------------------------------------ rule fixtures


def test_js101_cast_on_tensor_value():
    assert "JS101" in _rules("""
        import torch
        from repro_torch.analysis import compiled_path

        @compiled_path("t.js101", kind="step")
        def step(x):
            s = torch.sum(x)
            return float(s)
    """)


def test_js101_int_and_bool_on_parameters():
    assert _rules("""
        from repro_torch.analysis import compiled_path

        @compiled_path(kind="step")
        def step(x, flag):
            return int(x) + bool(flag)
    """) == {"JS101"}


@pytest.mark.parametrize("body", [
    "return float(x.shape[0])",         # shape projection: static
    "return int(x.shape[0])",
    "return x.float() * 2.0",           # .float() is a dtype cast, not the builtin
    "return x * float(n)",              # n: a python int
    "return x * float(np.sqrt(x.shape[1]))",
    "return x.int() + x.size(0)",
])
def test_js101_static_and_cast_forms_are_not_flagged(body):
    assert "JS101" not in _rules(f"""
        import numpy as np
        from repro_torch.analysis import compiled_path

        @compiled_path(kind="step")
        def step(x, n=3):
            n = 4
            {body}
    """)


@pytest.mark.parametrize("expr", ["x.item()", "x.tolist()", "x.cpu()", "x.numpy()", "np.asarray(x)",
                                  "np.array(x)", "x.sum().cpu().numpy()"])
def test_js102_host_materialization(expr):
    assert "JS102" in _rules(f"""
        import numpy as np
        from repro_torch.analysis import compiled_path

        @compiled_path(kind="step")
        def step(x):
            return {expr}
    """)


def test_js102_unmarked_host_code_is_not_compiled_context():
    assert _rules("""
        import numpy as np

        def host_fn(x):
            return x.cpu().numpy()
    """) == set()


def test_js103_branch_on_tensor_value():
    assert "JS103" in _rules("""
        import torch
        from repro_torch.analysis import compiled_path

        @compiled_path(kind="step")
        def step(x):
            y = torch.sum(x)
            if y > 0:
                return y
            return -y
    """)


def test_js103_ternary_and_assert_on_tensor_value():
    assert _rules("""
        import torch
        from repro_torch.analysis import compiled_path

        @compiled_path(kind="step")
        def step(x):
            y = x.max()
            assert y < 10
            return x if y > 0 else -x
    """) == {"JS103"}


def test_js103_is_none_check_exempt():
    assert "JS103" not in _rules("""
        from repro_torch.analysis import compiled_path

        @compiled_path(kind="step")
        def step(x, y=None):
            if y is None:
                return x
            return x + y
    """)


def test_js104_iteration_over_tensor_value():
    assert "JS104" in _rules("""
        import torch
        from repro_torch.analysis import compiled_path

        @compiled_path(kind="step")
        def step(x):
            t = 0.0
            for v in torch.cumsum(x, 0):
                t = t + v
            return t
    """)


def test_js104_range_loop_allowed():
    assert "JS104" not in _rules("""
        from repro_torch.analysis import compiled_path

        @compiled_path(kind="step")
        def step(x, n=3):
            t = x
            for i in range(n):
                t = t + i
            return t
    """)


def test_js105_per_value_sync_on_host_hot_path():
    assert "JS105" in _rules("""
        from repro_torch.analysis import compiled_path

        @compiled_path(kind="host")
        def drive(executor, node_args, b):
            out = executor.resilient_reduce(None, node_args, (), b)
            return float(out)
    """)


def test_js105_one_stacked_read_is_the_sanctioned_sync():
    assert "JS105" not in _rules("""
        import torch
        from repro_torch.analysis import compiled_path

        @compiled_path(kind="host")
        def drive(executor, node_args, b):
            out, w = executor.resilient_reduce(None, node_args, (), b)
            host = torch.stack([out, w.sum()]).cpu().tolist()
            return float(host[0])
    """)


def test_js105_a_second_stacked_read_is_flagged():
    assert "JS105" in _rules("""
        import torch
        from repro_torch.analysis import compiled_path

        @compiled_path(kind="host")
        def drive(executor, node_args, b):
            out, w = executor.resilient_reduce(None, node_args, (), b)
            first = torch.stack([out]).tolist()
            second = torch.stack([w]).tolist()
            return first, second
    """)


def test_js203_shape_branch_is_info_not_error():
    findings = lint_source(textwrap.dedent("""
        from repro_torch.analysis import compiled_path

        @compiled_path(kind="step")
        def step(x):
            if x.shape[0] > 4 or x.size(1) > 2 or x.numel() > 9:
                return x * 2.0
            return x
    """))
    assert {f.rule for f in findings} == {"JS203"}
    (f,) = findings
    assert f.severity == "info" and not f.fatal


@pytest.mark.parametrize("call", ["solve_recovery(A, alive)", "scipy.optimize.linprog(A)"])
def test_js301_host_solver_in_compiled_step(call):
    assert "JS301" in _rules(f"""
        import scipy.optimize
        from repro_torch.core.recovery import solve_recovery
        from repro_torch.analysis import compiled_path

        @compiled_path(kind="step")
        def step(A, alive):
            return {call}
    """)


def test_js301_reachability_through_call_graph():
    assert "JS301" in _rules("""
        from repro_torch.core.recovery import solve_recovery
        from repro_torch.analysis import compiled_path

        def helper(A, alive):
            return solve_recovery(A, alive)

        @compiled_path(kind="step")
        def step(A, alive):
            return helper(A, alive)
    """)


def test_factory_kind_lints_nested_defs_not_own_body():
    findings = lint_source(textwrap.dedent("""
        import numpy as np
        from repro_torch.analysis import compiled_path

        @compiled_path(kind="factory")
        def make(cfg, table):
            host = table.tolist()  # host setup: allowed

            def step(x):
                return x.item()  # step body: flagged

            return step
    """))
    assert [f.rule for f in findings] == ["JS102"]
    assert findings[0].qualname.endswith("step")


def test_inline_suppression():
    assert _rules("""
        from repro_torch.analysis import compiled_path

        @compiled_path(kind="step")
        def step(x):
            return x.item()  # repro-lint: disable=JS102
    """) == set()


def test_rules_table_names_the_twins():
    assert set(RULES) == {"JS101", "JS102", "JS103", "JS104", "JS105", "JS203", "JS301"}
    for sev, _title in RULES.values():
        assert sev in ("error", "warn", "info")


# ------------------------------------------------------------------ registry


def test_registry_kinds_and_metadata():
    @compiled_path("t.torch.reg.a", kind="host")
    def fn_a():
        pass

    info = fn_a.__compiled_path__
    assert (info.name, info.kind) == ("t.torch.reg.a", "host")
    assert "t.torch.reg.a" in registered_paths()
    assert "t.torch.reg.a" in registered_paths(kind="host")
    assert "t.torch.reg.a" not in registered_paths(kind="step")


def test_registry_rejects_duplicate_name_and_bad_kind():
    @compiled_path("t.torch.reg.dup")
    def fn_b():
        pass

    with pytest.raises(ValueError, match="already registered"):
        @compiled_path("t.torch.reg.dup")
        def fn_c():
            pass

    with pytest.raises(ValueError, match="kind"):
        compiled_path("t.torch.reg.k", kind="bogus")
    assert set(KINDS) == {"step", "factory", "host"}


# --------------------------------------------------------- baseline contract


_BASELINE_SRC = """
    from repro_torch.analysis import compiled_path

    @compiled_path(kind="step")
    def step(x):
        return x.item()
"""


def test_fingerprints_survive_line_shifts():
    a = lint_source(textwrap.dedent(_BASELINE_SRC))
    b = lint_source("# leading comment\n\n" + textwrap.dedent(_BASELINE_SRC))
    assert a and [f.fingerprint for f in a] == [f.fingerprint for f in b]
    assert [f.line for f in a] != [f.line for f in b]


def test_baseline_round_trip_filters_known_findings(tmp_path):
    findings = lint_source(textwrap.dedent(_BASELINE_SRC))
    assert findings
    path = str(tmp_path / "baseline.json")
    bl.save_baseline(path, findings)
    new, old = bl.split_findings(findings, bl.load_baseline(path))
    assert new == [] and len(old) == len(findings)
    new2, old2 = bl.split_findings(findings, bl.load_baseline(None))
    assert len(new2) == len(findings) and old2 == []


def test_baseline_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(bl.ENV_VAR, raising=False)
    assert bl.ENV_VAR == "REPRO_TORCH_LINT_BASELINE"
    assert bl.baseline_path(REPO_ROOT) == os.path.join(PORT, "analysis", "lint_baseline.json")
    monkeypatch.setenv(bl.ENV_VAR, "")
    assert bl.baseline_path(REPO_ROOT) is None


# ------------------------------------------------------------ repo self-scan


def test_port_self_scan_clean_modulo_baseline():
    findings = lint_paths([PORT])
    baseline = bl.load_baseline(os.path.join(REPO_ROOT, bl.DEFAULT_RELPATH))
    new = [f for f in findings if f.fatal and f.fingerprint not in baseline]
    assert not new, "new lint findings:\n" + "\n".join(f.format() for f in new)


def test_port_baseline_entries_still_bind():
    baseline = bl.load_baseline(os.path.join(REPO_ROOT, bl.DEFAULT_RELPATH))
    live = {f.fingerprint for f in lint_paths([PORT])}
    assert baseline and not baseline - live, f"stale baseline fingerprints: {sorted(baseline - live)}"


def _markers(root: str, package: str, callgraph, ast_lint) -> dict:
    proj = callgraph.load_project([root])
    out = {}
    for fn in proj.functions.values():
        kind = ast_lint._compiled_path_marker(fn)
        if kind is None:
            continue
        for dec in fn.node.decorator_list:
            if getattr(dec, "args", None):
                out[dec.args[0].value] = kind
    assert all(m.startswith(package) for m in proj.modules)
    return out


def test_marker_names_and_kinds_equal_the_references():
    """Found syntactically on both sides (``repro.analysis`` imports no jax)."""
    from repro.analysis import ast_lint as ref_lint
    from repro.analysis import callgraph as ref_callgraph

    from repro_torch.analysis import ast_lint, callgraph

    ref = _markers(os.path.join(REPO_ROOT, "src", "repro"), "repro", ref_callgraph, ref_lint)
    ref = {k: v for k, v in ref.items() if not k.startswith("t.")}
    port = _markers(PORT, "repro_torch", callgraph, ast_lint)
    assert len(ref) == 26
    assert port == ref


def test_every_marker_registers_on_import():
    import importlib

    from repro_torch.analysis import callgraph

    proj = callgraph.load_project([PORT])
    for name in {fn.module for fn in proj.functions.values() if any(
            d.endswith("compiled_path") for d in fn.decorators)}:
        importlib.import_module(name)
    names = {k for k in registered_paths() if not k.startswith("t.")}
    assert len(names) == 26 and {"train.train_step", "local.masked_reduce", "query.assign_min",
                                 "serve.batch_assign", "mesh.masked_reduce"} <= names


# ------------------------------------------------------------- sync audit


def test_sync_audit_flags_an_injected_item():
    """The twin of the reference's injected-callback test: a host read
    inside a registered path is counted, and the path fails."""
    import repro_torch.core.executor  # noqa: F401  registers local.masked_reduce

    from repro_torch.analysis.hotpaths import HotPathSpec
    from repro_torch.analysis.sync_audit import audit_path

    def dirty(x):
        s = torch.sum(x * 2.0)
        return x / s.item()

    x = torch.ones((4,))
    spec = HotPathSpec(name="dirty", registry_name="local.masked_reduce", description="fixture",
                       build=lambda device: (dirty, [("b4", [(x,), (x + 1,)])]))
    audit = audit_path(spec, "cpu")
    assert audit.registered and audit.syncs == {"b4": 2} and not audit.ok
    assert audit.sync_ops == ["b4:_local_scalar_dense", "b4:_local_scalar_dense"]


def test_sync_audit_flags_a_value_dependent_program():
    import repro_torch.core.recovery  # noqa: F401  registers recovery.jax

    from repro_torch.analysis.hotpaths import HotPathSpec
    from repro_torch.analysis.sync_audit import audit_path

    def ragged(x):
        return x[x > 0].sum()  # the kept count is data: the shapes follow it

    spec = HotPathSpec(name="ragged", registry_name="recovery.jax", description="fixture",
                       build=lambda device: (ragged, [("n4", [(torch.tensor([1.0, -1, 1, 1]),),
                                                              (torch.tensor([1.0, -1, -1, 1]),)])]))
    audit = audit_path(spec, "cpu")
    assert audit.same_program == {"n4": False} and not audit.ok


def test_sync_audit_clean_path_counts_no_sync_and_one_program():
    import repro_torch.core.recovery  # noqa: F401

    from repro_torch.analysis.hotpaths import HotPathSpec
    from repro_torch.analysis.sync_audit import audit_path

    def clean(x):
        return torch.sum(x * 2.0)

    spec = HotPathSpec(name="clean", registry_name="recovery.jax", description="fixture",
                       build=lambda device: (clean, [("n4", [(torch.ones(4),), (torch.zeros(4),)]),
                                                     ("n8", [(torch.ones(8),), (torch.full((8,), 3.0),)])]))
    audit = audit_path(spec, "cpu")
    assert audit.ok, audit.as_dict()
    assert audit.syncs == {"n4": 0, "n8": 0} and audit.same_program == {"n4": True, "n8": True}


def test_sync_audit_unregistered_path_fails():
    from repro_torch.analysis.hotpaths import HotPathSpec
    from repro_torch.analysis.sync_audit import audit_path

    spec = HotPathSpec(name="ghost", registry_name="no.such.path", description="fixture",
                       build=lambda device: (lambda x: x, [("n1", [(torch.ones(2),), (torch.ones(2),)])]))
    audit = audit_path(spec, "cpu")
    assert not audit.registered and not audit.ok


def test_hot_path_specs_cover_the_four_tiers():
    from repro_torch.analysis.hotpaths import hot_path_specs

    assert {s.registry_name for s in hot_path_specs()} == {
        "train.train_step", "local.masked_reduce", "query.assign_min", "serve.batch_assign"}


@pytest.mark.parametrize("name", ["train_step", "masked_reduce", "query_assign", "serve_batch_assign"])
def test_hot_paths_audit_clean_on_the_cpu(name):
    from repro_torch.analysis.hotpaths import hot_path_specs
    from repro_torch.analysis.sync_audit import audit_path

    (spec,) = [s for s in hot_path_specs() if s.name == name]
    audit = audit_path(spec, "cpu")
    assert audit.ok, audit.as_dict()
    assert audit.kind == "factory" and set(audit.syncs.values()) == {0}
    assert len(audit.buckets) == 2 and all(audit.same_program.values())
    op = "flash_attention" if name == "train_step" else "assign_min"
    assert audit.calls.get(op, 0) >= 4 and not audit.launches


def test_cli_both_layers_on_the_cpu(tmp_path):
    import json
    import subprocess
    import sys

    out = tmp_path / "report.json"
    got = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--layer", "all", "--device", "cpu",
                          "--emit", str(out)], capture_output=True, text=True, timeout=240, cwd=REPO_ROOT,
                         env={**os.environ, "PYTHONPATH": os.path.join(REPO_ROOT, "src")})
    assert got.returncode == 0, got.stdout + got.stderr
    report = json.loads(out.read_text())
    assert report["ok"] and report["layers"]["ast_lint"]["failures"] == []
    assert [p["ok"] for p in report["layers"]["sync_audit"]["paths"]] == [True] * 4

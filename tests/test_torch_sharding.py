"""The port's sharding rules, shape specs and mesh shapes
(``repro_torch.launch.{sharding,specs,mesh}``) against the reference's, in
this process, with no ranks.

The reference's spec functions read only a mesh's ``axis_names`` and
``devices.shape``, so a stand-in with an ``np.empty(shape)`` serves as its
mesh at any size, (16, 16) and (64, 4) included; its ``NamedSharding`` is
swapped for the bare ``PartitionSpec`` (the test's monkeypatch, the module
itself unchanged).  A reference spec is compared as a tuple with one entry
per dimension (``P()`` padded with ``None``), and the reference's stacked
``unit/slot<i>`` parameters with their leading ``reps`` entry dropped; the
parameters are paired through ``convert.transformer_params_from_jax``'s
name map.  Every comparison is exact.
"""

import dataclasses
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import sharding as JS
from repro.launch import specs as JSP
from repro.models import transformer as JT
from repro.models.registry import get_config as j_get_config
from repro.models.registry import list_archs as j_list_archs
from repro.train.train_step import init_train_state
from repro_torch import convert
from repro_torch.launch import distributed as D
from repro_torch.launch import mesh as PM
from repro_torch.launch import sharding as S
from repro_torch.launch import specs as SP
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config

ARCHS = {"qwen3-4b": "qwen3_4b", "deepseek-moe-16b": "deepseek_moe_16b", "xlstm-1.3b": "xlstm_1_3b",
         "recurrentgemma-9b": "recurrentgemma_9b"}
LAYOUTS = ["fsdp_tp", "tp_only", "fsdp_only", "ssm_fsdp"]
MESHES = [(2, 4), (2, 2, 2), (16, 16), (64, 4)]


def _axes(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _ref_mesh(shape):
    return types.SimpleNamespace(axis_names=_axes(shape), devices=np.empty(shape),
                                 shape=dict(zip(_axes(shape), shape)))


def _port_mesh(shape):
    return PM.MeshShape(_axes(shape), tuple(shape))


def _spec(p, ndim) -> tuple:
    """A reference PartitionSpec as one entry per dimension."""
    p = tuple(p)
    return p + (None,) * (ndim - len(p))


@pytest.fixture
def bare_specs(monkeypatch):
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)


def _ref_params(arch):
    """The reference's smoke params as zero arrays of their shapes."""
    cfg = importlib.import_module(f"repro.configs.{ARCHS[arch]}").smoke_config().validate()
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _pairs(tree):
    """(reference path, its shape, port name, port shape, whether the
    reference stacks it over reps) for every parameter."""
    out = []
    n_slots = len(tree["unit"])
    reps = None
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(p.key) for p in path]
        rest = ".".join(keys[2:])
        if keys[0] == "unit":
            reps = leaf.shape[0]
            si = int(keys[1][4:])
            for r in range(reps):
                out.append(("/".join(keys), leaf.shape, f"blocks.{r * n_slots + si}.{rest}", leaf.shape[1:], True))
        elif keys[0] != "tail":
            out.append(("/".join(keys), leaf.shape, ".".join(keys), leaf.shape, False))
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree.get("tail", {}))[0]:
        keys = [str(p.key) for p in path]
        ti = int(keys[0][4:])
        out.append(("tail/" + "/".join(keys), leaf.shape, f"blocks.{reps * n_slots + ti}.{'.'.join(keys[1:])}",
                    leaf.shape, False))
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_spec_matches_the_reference_for_every_smoke_parameter(arch, layout):
    _, tree = _ref_params(arch)
    pairs = _pairs(tree)
    sd = convert.transformer_params_from_jax(tree)
    assert {p[2] for p in pairs} == set(sd) and all(tuple(sd[p[2]].shape) == tuple(p[3]) for p in pairs)
    for shape in MESHES:
        for ref_path, ref_shape, name, port_shape, stacked in pairs:
            want = _spec(JS.param_spec(ref_path, ref_shape, _ref_mesh(shape), layout=layout), len(ref_shape))
            got = S.param_spec(name.replace(".", "/"), tuple(port_shape), _port_mesh(shape), layout=layout)
            assert got == (want[1:] if stacked else want), (shape, ref_path, name)
        assert S.param_shardings(sd, _port_mesh(shape), layout=layout) == {
            name: S.param_spec(name.replace(".", "/"), tuple(t.shape), _port_mesh(shape), layout=layout)
            for name, t in sd.items()}


def test_the_rule_tables_are_the_references():
    assert list(S._LAYOUTS) == list(JS._LAYOUTS)
    for name in S._LAYOUTS:
        assert S._LAYOUTS[name] == JS._LAYOUTS[name]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_batch_cache_and_state_shardings_match_the_reference(shape, bare_specs):
    ref_mesh, port_mesh = _ref_mesh(shape), _port_mesh(shape)
    for arch in ARCHS:
        cfg = importlib.import_module(f"repro.configs.{ARCHS[arch]}").smoke_config().validate()
        pcfg = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").smoke_config().validate()
        for cell in ("train_4k", "decode_32k"):
            batch = JSP.input_specs(cfg, JSP.SHAPES[cell], num_groups=4)
            want = JS.batch_shardings(batch, ref_mesh)
            for tree in (batch, SP.input_specs(pcfg, SP.SHAPES[cell], num_groups=4)):
                got = S.batch_shardings(tree, port_mesh)
                assert got == {k: _spec(want[k], len(batch[k].shape)) for k in batch}, (arch, cell)
        for B in (32, 6):
            cache = jax.eval_shape(lambda: JT.init_cache(cfg, B, 64))
            for layout in ("feature", "seq"):
                want = JS.cache_shardings(cache, ref_mesh, B, layout=layout)
                got = S.cache_shardings(cache, port_mesh, B, layout=layout)
                flat_w = jax.tree_util.tree_flatten_with_path(want, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]
                for path, spec in flat_w:
                    node, leaf = got, cache
                    for p in path:
                        node, leaf = node[p.key], leaf[p.key]
                    assert node == _spec(spec, len(leaf.shape)), (arch, B, layout, path)
    for arch in ARCHS:
        cfg = importlib.import_module(f"repro.configs.{ARCHS[arch]}").smoke_config().validate()
        state = jax.eval_shape(lambda: init_train_state(jax.random.PRNGKey(0), cfg))
        flat_state = {JS._path_str(p): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}
        for layout in LAYOUTS:
            want = JS.state_shardings(state, ref_mesh, layout=layout)
            flat_want = {JS._path_str(p): spec for p, spec in jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
            got = S.state_shardings(flat_state, port_mesh, layout=layout)
            assert set(got) == set(flat_want) and len(got) > 10
            for path, spec in flat_want.items():
                assert got[path] == _spec(spec, len(flat_state[path].shape)), (arch, layout, path)


@pytest.mark.parametrize("arch", sorted(j_list_archs()))
def test_input_specs_and_cells_match_the_reference(arch):
    cfg, pcfg = j_get_config(arch), get_config(arch)
    assert list(SP.SHAPES) == list(JSP.SHAPES)
    assert [c.name for c in SP.all_cells(pcfg)] == [c.name for c in JSP.all_cells(cfg)]
    for name, cell in JSP.SHAPES.items():
        assert dataclasses.astuple(SP.SHAPES[name]) == dataclasses.astuple(cell)
        assert SP.cell_is_applicable(pcfg, SP.SHAPES[name]) == JSP.cell_is_applicable(cfg, cell)
        want = JSP.input_specs(cfg, cell)
        got = SP.input_specs(pcfg, SP.SHAPES[name])
        assert list(got) == list(want)
        for key, s in want.items():
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == tuple(s.shape), (name, key)
            assert str(got[key].dtype).removeprefix("torch.") == str(jnp.dtype(s.dtype)), (name, key)


def test_divisibility_fallback_as_the_reference_rule_cases():
    """Twins of ``tests/test_launch.py::test_sharding_rules_divisibility_fallback``,
    and internvl2's 14 heads on a 16-way model axis: ``wq``'s 896 columns
    divide, so the rule splits them mid-head, and the attention then runs
    every head on each rank with the weights gathered."""
    m24 = _port_mesh((2, 4))
    assert S.param_spec("unit/slot0/attn/wq", (128, 896), m24) == ("data", "model")
    assert S.param_spec("unit/slot0/attn/wq", (128, 14), m24) == ("data", None)
    cfg = get_config("internvl2-1b")
    grid = _port_mesh((16, 16))
    spec = S.param_spec("blocks/0/attn/wq", (cfg.d_model, cfg.n_heads * cfg.head_dim), grid)
    assert spec == ("data", "model") and cfg.n_heads % 16
    assert S.param_spec("blocks/0/attn/bq", (cfg.n_heads,), grid) == (None,)
    wq = torch.empty((cfg.d_model // 16, cfg.n_heads * cfg.head_dim // 16), device="meta")
    wq.mesh_spec = spec
    mesh = PM.Mesh(grid.axis_names, grid.sizes, coords=(0, 3))
    ctx = T.ModelContext(mesh=mesh, batch_axes=("data",), model_axis="model", fsdp_axis="data")
    assert A.local_heads({"wq": wq}, cfg, ctx) == ((0, cfg.n_heads), (0, cfg.n_kv_heads), None, False)


def test_local_heads_keep_the_kv_heads_their_query_heads_read():
    """GQA whose KV heads do not divide the model axis (qwen3-4b smoke: 4
    query heads over 2 KV heads on a 4-way axis): each rank's one query head
    reads KV head r // 2."""
    cfg = importlib.import_module("repro_torch.configs.qwen3_4b").smoke_config()
    grid = _port_mesh((1, 4))
    wq = torch.empty((cfg.d_model, cfg.n_heads * cfg.head_dim // 4), device="meta")
    wq.mesh_spec = S.param_spec("blocks/0/attn/wq", (cfg.d_model, cfg.n_heads * cfg.head_dim), grid)
    for r in range(4):
        ctx = T.ModelContext(mesh=PM.Mesh(grid.axis_names, grid.sizes, coords=(0, r)), batch_axes=("data",),
                             model_axis="model", fsdp_axis="data")
        assert A.local_heads({"wq": wq}, cfg, ctx) == ((r, r + 1), (r // 2, r // 2 + 1), None, True)


def test_mesh_shapes_are_the_references():
    assert PM.production_mesh_shape().shape == {"data": 16, "model": 16}
    assert PM.production_mesh_shape(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    assert PM.production_mesh_shape(shape=(64, 4)).shape == {"data": 64, "model": 4}
    assert PM.production_mesh_shape(multi_pod=True, shape=(2, 8, 16)).axis_names == ("pod", "data", "model")
    grid = PM.MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert PM.rank_grid(grid)[1, 0, 1] == 5 and PM.axis_sizes(grid) == {"pod": 2, "data": 2, "model": 2}
    D.node_mesh()  # a world of one over gloo in this process
    with pytest.raises(ValueError, match="needs 4 ranks"):
        PM.make_test_mesh((2, 2))
    one = PM.make_test_mesh((1, 1))
    assert one.coords == (0, 0) and one.shape == {"data": 1, "model": 1}
    assert one.device_mesh.mesh_dim_names == ("data", "model")
    ctx = S.make_context(one)
    assert (ctx.batch_axes, ctx.model_axis, ctx.fsdp_axis, ctx.batch_spec) == (("data",), "model", "data", "data")
    pod = S.make_context(PM.Mesh(grid.axis_names, grid.sizes, coords=(0, 0, 0)))
    assert pod.batch_spec == ("pod", "data")
    with pytest.raises(TypeError):
        T.ModelContext(mesh=grid)  # a grid alone, no ranks


def test_init_sharded_draws_the_meshless_values():
    """A rank drawing its own blocks gets the blocks of the meshless draw."""
    cfg = importlib.import_module("repro_torch.configs.deepseek_moe_16b").smoke_config()
    full = T.init_params(cfg, generator=torch.Generator().manual_seed(5))
    grid = _port_mesh((2, 4))
    for coords in ((0, 0), (1, 3)):
        mesh = PM.Mesh(grid.axis_names, grid.sizes, coords=coords)
        part = S.init_sharded(cfg, generator=torch.Generator().manual_seed(5), mesh=mesh)
        want = S.shard_model(T.model_from_state_dict(cfg, full.state_dict()), mesh)
        got, ref = dict(part.named_parameters()), dict(want.named_parameters())
        assert set(got) == set(ref)
        for name, t in got.items():
            assert torch.equal(t, ref[name]) and t.mesh_spec == ref[name].mesh_spec, name
        assert got["blocks.0.moe.w_gate"].shape == (cfg.moe.num_experts // 4, cfg.d_model // 2, cfg.moe.d_expert)

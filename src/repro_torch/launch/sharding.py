"""Sharding rules: logical parameter / activation layouts → specs (the twin
of the reference's ``launch/sharding.py``).

Default production layout (MaxText-style FSDP + TP):
  * ``model`` (TP): attention heads / d_ff / experts / vocab,
  * ``data``  (FSDP): the other weight dim; optimizer state inherits the
    param layout,
  * ``pod``   (DP): pure replication across pods,
  * batch dims: (pod, data).

A spec is a tuple with one entry per dimension: the mesh axis that splits
that dimension, a tuple of axes (a batch dim over ``("pod", "data")``),
or ``None``; the reference's ``PartitionSpec`` entries, one for one.  Every
rule passes through a divisibility check: a dim that does not divide by
its mesh axis falls back to replication on that dim (internvl2's 14 heads
on a 16-way model axis).  ``layout`` selects between the reference's four
rule sets, copied here in their order: the order matters, since the first
match wins (``attn/w[qkv]$`` before the mLSTM's ``w[qkv]$``).

A port parameter name ``blocks.3.attn.wq`` is matched as
``blocks/3/attn/wq``; the reference's stacked ``unit/slot0/attn/wq`` carries
a leading ``reps`` dim that the port's per-layer tensors do not.

:func:`shard_model` keeps this rank's block of every parameter, by its
coordinate on each axis its spec names, and tags the tensor with its spec
(``mesh_spec``), which the model code reads (``models.layers.weight``).
:func:`init_sharded` draws a model as :func:`~repro_torch.models.transformer.init_params`
does, the same values from the same generator, keeping the rank's blocks
of each layer before it draws the next, so no rank holds the whole tree.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
from torch import nn

from ..models import transformer as T
from ..models.registry import ModelConfig
from . import collectives as C
from .mesh import axis_sizes

__all__ = [
    "batch_shardings",
    "block_shape",
    "block_slices",
    "full_shape",
    "cache_shardings",
    "gather_rows",
    "init_sharded",
    "local_rows",
    "make_context",
    "param_spec",
    "param_shardings",
    "shard_model",
    "split_axes",
    "state_shardings",
]


# Rules: (path regex, spec template per trailing dim).  Logical names:
#   "tp" → model axis, "fsdp" → data axis, None → replicated.
# Templates apply to the LAST len(template) dims; leading dims are None.
_RULES_FSDP_TP = [
    (r"embed$", ("tp", "fsdp")),
    (r"lm_head$", ("fsdp", "tp")),
    (r"attn/w[qkv]$", ("fsdp", "tp")),
    (r"attn/b[qkv]$", ("tp",)),
    (r"attn/wo$", ("tp", "fsdp")),
    (r"(mlp|ffn)/(gate|up)$", ("fsdp", "tp")),
    (r"(mlp|ffn)/down$", ("tp", "fsdp")),
    (r"moe/router$", (None, None)),
    (r"moe/w_(gate|up)$", ("tp", "fsdp", None)),
    (r"moe/w_down$", ("tp", None, "fsdp")),
    (r"moe/shared/(gate|up)$", ("fsdp", "tp")),
    (r"moe/shared/down$", ("tp", "fsdp")),
    # mLSTM
    (r"w_up$", ("fsdp", "tp")),
    (r"w[qkv]$", ("fsdp", "tp")),
    (r"w_[if]$", ("fsdp", None)),
    (r"w_down$", ("tp", "fsdp")),
    # sLSTM (d×d gate weights + per-head recurrent)
    (r"w_[zifo]$", ("fsdp", "tp")),
    (r"r_[zifo]$", (None, None, None)),
    (r"w_out$", ("tp", "fsdp")),
    # RG-LRU
    (r"w_x$", ("fsdp", "tp")),
    (r"w_gate$", ("fsdp", "tp")),
    (r"w_[ir]$", ("fsdp", "tp")),
    (r"lam$", ("tp",)),
    (r"conv/w$", (None, "tp")),
    (r"conv/b$", ("tp",)),
]

# Pure TP (no FSDP): params replicated over data.
_RULES_TP_ONLY = [
    (pat, tuple("tp" if a == "tp" else None for a in spec))
    for pat, spec in _RULES_FSDP_TP
]

# FSDP-only (no TP): every weight sharded on dim 0 over data.
_RULES_FSDP_ONLY = [
    (pat, tuple("fsdp" if i == 0 else None for i, _ in enumerate(spec)))
    for pat, spec in _RULES_FSDP_TP
]

# xLSTM: the mLSTM's weights FSDP-only (its head-structured cell does not
# shard over a 16-way model axis).
_RULES_SSM_FSDP = []
for _pat, _spec in _RULES_FSDP_TP:
    if _pat in (r"w_up$", r"w[qkv]$", r"w_down$", r"w_[if]$"):
        _RULES_SSM_FSDP.append((_pat, tuple("fsdp" if a == "fsdp" else None for a in _spec)))
    else:
        _RULES_SSM_FSDP.append((_pat, _spec))

_LAYOUTS = {
    "fsdp_tp": _RULES_FSDP_TP,
    "tp_only": _RULES_TP_ONLY,
    "fsdp_only": _RULES_FSDP_ONLY,
    "ssm_fsdp": _RULES_SSM_FSDP,
}


def _axes_of(mesh):
    names = set(mesh.axis_names)
    batch = tuple(a for a in ("pod", "data") if a in names)
    model = "model" if "model" in names else None
    fsdp = "data" if "data" in names else None
    return batch, model, fsdp


def make_context(mesh, *, attn_impl: str = "auto", moe_routing: str = "pjit", remat: str = "none",
                 cache_layout: str = "feature") -> T.ModelContext:
    """The model's context on ``mesh`` (or meshless): its axes named, and
    the decode cache's ``cache_layout``, ``feature`` or ``seq`` (the
    layouts of :func:`cache_shardings`; ``models.transformer.ModelContext``)."""
    if mesh is None:
        return T.ModelContext(attn_impl=attn_impl, moe_routing=moe_routing, remat=remat, cache_layout=cache_layout)
    batch, model, fsdp = _axes_of(mesh)
    return T.ModelContext(mesh=mesh, batch_axes=batch, model_axis=model, fsdp_axis=fsdp,
                          attn_impl=attn_impl, moe_routing=moe_routing, remat=remat, cache_layout=cache_layout)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def param_spec(path_str: str, shape, mesh, *, layout: str = "fsdp_tp") -> tuple:
    """Spec for one parameter, with the divisibility fallback."""
    _, model, fsdp = _axes_of(mesh)
    logical = {"tp": model, "fsdp": fsdp}
    sizes = axis_sizes(mesh)
    for pat, template in _LAYOUTS[layout]:
        if re.search(pat, path_str):
            nlead = len(shape) - len(template)
            if nlead < 0:
                continue
            spec = [None] * nlead
            for dim, name in zip(shape[nlead:], template):
                ax = logical.get(name)
                if ax is not None and dim % sizes.get(ax, 1) == 0 and sizes.get(ax, 1) > 1:
                    spec.append(ax)
                else:
                    spec.append(None)
            return tuple(spec)
    return (None,) * len(shape)  # norms, biases, anything unmatched: replicated


def _tree_map_with_path(fn, tree, path=()):
    """fn(path, leaf) over nested dicts, lists and tuples; a leaf is
    anything with a ``shape``."""
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _module_path(name: str) -> str:
    return name.replace(".", "/")


def param_shardings(params, mesh, *, layout: str = "fsdp_tp"):
    """The spec of every leaf of a params tree (a port state dict, whose
    dotted names are read as paths, or nested dicts)."""
    return _tree_map_with_path(
        lambda path, leaf: param_spec(_module_path(_path_str(path)), tuple(leaf.shape), mesh, layout=layout),
        params)


def state_shardings(state, mesh, *, layout: str = "fsdp_tp"):
    """Train-state specs: params and their moments share the param layout;
    the step and every scalar are replicated."""

    def one(path, leaf):
        ps = _path_str(path)
        if ps.endswith("step") or len(leaf.shape) == 0:
            return ()
        # Strip the state-level prefixes (params/, opt/m/, opt/v/, ef/).
        core = re.sub(r"^(params|opt/m|opt/v|ef|0|1/1|1/2|2)/", "", ps)
        core = re.sub(r"^(m|v)/", "", core)
        return param_spec(_module_path(core), tuple(leaf.shape), mesh, layout=layout)

    return _tree_map_with_path(one, state)


def _nbatch(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in ("pod", "data"):
        n *= sizes.get(a, 1)
    return max(n, 1)


def _batch_entry(mesh):
    bspec, _, _ = _axes_of(mesh)
    return bspec if len(bspec) > 1 else (bspec[0] if bspec else None)


def batch_shardings(batch, mesh):
    """Tokens / prefix embeddings split over the (pod, data) batch axes;
    scalars and group weights replicated."""
    bs = _batch_entry(mesh)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if "group_weights" not in _path_str(path) and len(shape) and shape[0] % _nbatch(mesh) == 0:
            return (bs,) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    return _tree_map_with_path(one, batch)


def cache_shardings(cache, mesh, batch_size: int, *, layout: str = "feature"):
    """Decode caches: the batch dim over (pod, data) when it divides.

    ``layout="feature"`` also splits the largest trailing feature dim over
    ``model``; ``layout="seq"`` splits the K/V sequence dim instead, the
    cache of the sequence-parallel decode (``make_context(mesh,
    cache_layout="seq")``: the softmax's partial statistics summed over
    ``model``).  As in the reference, the seq split needs the batch dim
    split over a data axis of size > 1; without one (a (1, m) mesh) the
    spec is the feature one, where the port's seq decode still splits the
    slots (``models.transformer.init_cache``)."""
    bs = _batch_entry(mesh)
    _, model, _ = _axes_of(mesh)
    sizes = axis_sizes(mesh)
    nb = _nbatch(mesh)
    msize = sizes.get(model, 1) if model else 1

    def one(path, leaf):
        shape = tuple(leaf.shape)
        name = _path_str(path)
        spec = [None] * len(shape)
        bdim = None
        for i, d in enumerate(shape[:2]):  # stacked caches are (R, B, ...), per-layer ones (B, ...)
            if d == batch_size and batch_size % nb == 0 and nb > 1:
                spec[i] = bs
                bdim = i
                break
        if model and msize > 1:
            if layout == "seq" and name.endswith(("k", "v")) and bdim is not None:
                sdim = bdim + 1  # (…, B, S, KV, dh): the sequence dim
                if sdim < len(shape) and shape[sdim] % msize == 0 and shape[sdim] >= msize:
                    spec[sdim] = model
                    return tuple(spec)
            for i in range(len(shape) - 1, 1, -1):
                if spec[i] is None and shape[i] % msize == 0 and shape[i] >= msize:
                    spec[i] = model
                    break
        return tuple(spec)

    return _tree_map_with_path(one, cache)


# ------------------------------------------------------------------ blocks


def split_axes(spec) -> tuple:
    """The mesh axes a spec splits its tensor over, in the order of its dims."""
    out = []
    for ax in spec or ():
        out += [a for a in ((ax,) if isinstance(ax, str) else (ax or ())) if a not in out]
    return tuple(out)


def block_shape(shape, spec, mesh) -> tuple:
    """The shape of a rank's block of a tensor of ``shape`` under ``spec``."""
    return tuple(d // mesh.shape[ax] if isinstance(ax, str) else d for d, ax in zip(shape, spec))


def full_shape(block, spec, mesh) -> tuple:
    """The shape of the whole tensor whose blocks under ``spec`` have the
    shape ``block``."""
    return tuple(d * mesh.shape[ax] if isinstance(ax, str) else d for d, ax in zip(block, spec))


def block_slices(shape, spec, mesh) -> tuple:
    """This rank's block of a tensor of ``shape`` under ``spec``, one
    slice per dim (an index of a tensor or of an array)."""
    out = []
    for d, ax in zip(shape, spec):
        if ax is None:
            out.append(slice(None))
        else:
            blk = d // mesh.shape[ax]
            out.append(slice(mesh.coord(ax) * blk, (mesh.coord(ax) + 1) * blk))
    return tuple(out)


def _block_of(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the full tensor t under ``spec``, a copy."""
    return t[block_slices(t.shape, spec, mesh)].clone(memory_format=torch.contiguous_format)


def _narrow_module(prefix: str, module: nn.Module, *, mesh, layout: str) -> None:
    """Replace every parameter of ``module`` not yet narrowed by this
    rank's block, tagged with its spec (``mesh_spec``)."""
    for name, p in list(module.named_parameters()):
        if hasattr(p, "mesh_spec"):
            continue
        spec = param_spec(_module_path(prefix + name), tuple(p.shape), mesh, layout=layout)
        if all(a is None for a in spec):  # replicated: the tensor stays as it is, no copy
            p.mesh_spec = spec
            continue
        local = nn.Parameter(_block_of(p.detach(), spec, mesh), requires_grad=p.requires_grad)
        local.mesh_spec = spec
        *parents, leaf = name.split(".")
        owner = module
        for part in parents:
            owner = getattr(owner, part)
        setattr(owner, leaf, local)


def shard_model(model: nn.Module, mesh, *, layout: str = "fsdp_tp") -> nn.Module:
    """Keep this rank's block of every parameter of ``model`` (in place;
    the full tensors are freed unless the caller holds them; a replicated
    parameter is kept as it is, tagged).  Returns the model."""
    if layout not in _LAYOUTS:
        raise ValueError(f"shard_model: unknown layout {layout!r}; one of {sorted(_LAYOUTS)}")
    _narrow_module("", model, mesh=mesh, layout=layout)
    return model


def init_sharded(cfg: ModelConfig, *, generator: Optional[torch.Generator], mesh, layout: str = "fsdp_tp",
                 matmul_dtype=None, device=None) -> T.Transformer:
    """:func:`~repro_torch.models.transformer.init_params` narrowed to this
    rank's blocks as it draws: every rank draws every tensor from
    ``generator`` (seeded alike on every rank, so the values are the
    meshless model's), and keeps its blocks of the embedding and of each
    layer before it draws the next layer.  ``generator=None`` draws on
    ``device`` without one: on ``meta``, the blocks' shapes alone (the dry
    run, ``launch.dryrun``)."""
    if layout not in _LAYOUTS:
        raise ValueError(f"init_sharded: unknown layout {layout!r}; one of {sorted(_LAYOUTS)}")

    def keep(prefix, module):
        _narrow_module(prefix, module, mesh=mesh, layout=layout)

    return T.Transformer(cfg, device=generator.device if generator is not None else torch.device(device),
                         generator=generator, matmul_dtype=matmul_dtype, keep=keep)


# ------------------------------------------------------------------ rows


def local_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a global batch x (its data shard, row-major over
    the batch axes)."""
    if mesh is None:
        return x
    batch, _, _ = _axes_of(mesh)
    n, shard = 1, 0
    for a in batch:
        n, shard = n * mesh.shape[a], shard * mesh.shape[a] + mesh.coord(a)
    if x.shape[0] % n:
        raise ValueError(f"local_rows: a batch of {x.shape[0]} rows over {n} data shards")
    blk = x.shape[0] // n
    return x[shard * blk:(shard + 1) * blk]


def gather_rows(x: torch.Tensor, mesh: Optional[object]) -> torch.Tensor:
    """The global batch from each data shard's rows x (every rank receives
    it): the inverse of :func:`local_rows`."""
    if mesh is None:
        return x
    batch, _, _ = _axes_of(mesh)
    return C.gather_axes(x, mesh, batch, 0)

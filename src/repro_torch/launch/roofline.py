"""Roofline terms on H100 constants (the twin of the reference's
``launch/roofline.py``, whose constants are the TPU v5e's).

Three terms per (arch × shape × mesh):

    compute    = FLOPs_per_device / peak_FLOP/s          (989 TF/s dense bf16)
    memory     = bytes_per_device / HBM_bw               (3.35 TB/s)
    collective = collective_bytes_per_device / link_bw   (450 GB/s, NVLink 4 a direction)

The FLOPs, bytes and collective bytes come from ``launch.op_analysis``
(the port's twin of the reference's ``hlo_analysis``: matmul FLOPs from
``torch.utils.flop_counter``, an unfused bytes-accessed upper bound, the
collectives ``launch.collectives.STATS`` counted); :func:`model_flops` is
the reference's analytic count of the useful FLOPs, and
``roofline_fraction`` the reference's score, useful-FLOPs time over the
largest term.  :func:`parse_collectives` reads XLA's HLO text and has no
torch twin.
"""

from __future__ import annotations

import dataclasses
import re

__all__ = ["HW", "parse_collectives", "roofline_terms", "model_flops", "RooflineReport"]

HW = {
    "peak_flops": 989e12,  # dense bf16 tensor-core FLOP/s, H100 SXM (NVIDIA H100 data sheet)
    "hbm_bw": 3.35e12,  # HBM3 bytes/s, H100 SXM (NVIDIA H100 data sheet)
    "link_bw": 450e9,  # NVLink 4 bytes/s a direction: 900 GB/s both ways, H100 SXM (NVIDIA H100 data sheet)
}

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
# e.g.  %all-gather.7 = bf16[64,2048]{1,0} all-gather(%param.3), ...
_COLL_RE = re.compile(
    r"=\s*(?:\()?([a-z0-9]+)\[([0-9,]*)\][^\s]*\s+(" + "|".join(_COLL_KINDS) + r")(?:-start)?\("
)
_TUPLE_COLL_RE = re.compile(
    r"=\s*\(([^)]*)\)\s+(" + "|".join(_COLL_KINDS) + r")(?:-start)?\("
)
_COMP_START_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*(?:\([^)]*\))?\s*->.*\{\s*$")
_WHILE_RE = re.compile(r"while\(.*?body=%?([\w\.\-]+).*?condition=%?([\w\.\-]+)", re.DOTALL)
_CONST_RE = re.compile(r"constant\((\d+)\)")
_SHAPE_IN_TUPLE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _split_computations(hlo: str) -> dict[str, str]:
    comps: dict[str, list[str]] = {}
    cur = None
    for line in hlo.splitlines():
        m = _COMP_START_RE.match(line.strip())
        if m and line.rstrip().endswith("{"):
            cur = m.group(1)
            comps[cur] = []
        elif cur is not None:
            comps[cur].append(line)
            if line.strip() == "}":
                cur = None
    return {k: "\n".join(v) for k, v in comps.items()}


def parse_collectives(hlo: str, *, default_trip: int = 1) -> dict:
    """Sum per-device collective result bytes, honouring while-loop nesting.

    Returns {"total_bytes", "by_kind": {kind: bytes}, "ops": count}.

    It reads XLA's HLO text, which no torch program has: it has no torch
    twin and is kept for reading the reference's dry-run artifacts.  The
    port's collective bytes come from ``launch.collectives.STATS``
    (``launch.op_analysis``).
    """
    comps = _split_computations(hlo)

    # while-op locations: computation → [(body, cond)]
    trip: dict[str, int] = {}
    parents: dict[str, list[str]] = {}
    for name, body in comps.items():
        for m in _WHILE_RE.finditer(body):
            wbody, wcond = m.group(1), m.group(2)
            parents.setdefault(wbody, []).append(name)
            t = default_trip
            cond_text = comps.get(wcond, "")
            consts = [int(c) for c in _CONST_RE.findall(cond_text)]
            if consts:
                t = max(consts)
            trip[wbody] = max(trip.get(wbody, 0), t)

    def multiplier(comp: str, seen=()) -> int:
        if comp in seen:
            return 1
        mult = trip.get(comp, 1) if comp in trip else 1
        best_parent = 1
        for par in parents.get(comp, []):
            best_parent = max(best_parent, multiplier(par, seen + (comp,)))
        return (trip.get(comp, 1)) * best_parent if comp in trip else best_parent

    by_kind: dict[str, float] = {k: 0.0 for k in _COLL_KINDS}
    ops = 0
    for name, body in comps.items():
        mult = multiplier(name)
        for m in _COLL_RE.finditer(body):
            dtype, dims, kind = m.group(1), m.group(2), m.group(3)
            by_kind[kind] += _shape_bytes(dtype, dims) * mult
            ops += 1
        for m in _TUPLE_COLL_RE.finditer(body):
            shapes, kind = m.group(1), m.group(2)
            for sm in _SHAPE_IN_TUPLE_RE.finditer(shapes):
                by_kind[kind] += _shape_bytes(sm.group(1), sm.group(2)) * mult
            ops += 1
    return {
        "total_bytes": float(sum(by_kind.values())),
        "by_kind": {k: float(v) for k, v in by_kind.items() if v},
        "ops": ops,
    }


# ------------------------------------------------------------ analytic flops


def _active_params(cfg) -> tuple[int, int]:
    """(total_params, active_params_per_token), analytic from the config."""
    d, V = cfg.d_model, cfg.vocab
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    embed = V * d * max(cfg.num_codebooks, 1)
    head = 0 if cfg.tie_embeddings else d * V * max(cfg.num_codebooks, 1)
    per_type = {}
    attn = d * (H + 2 * KV) * dh + H * dh * d
    gated = 3 * d * cfg.d_ff if cfg.mlp_act != "gelu" else 2 * d * cfg.d_ff
    per_type["attn_mlp"] = attn + gated
    per_type["lattn_mlp"] = attn + 3 * d * cfg.d_ff
    if cfg.moe:
        m = cfg.moe
        routed_total = m.num_experts * 3 * d * m.d_expert
        routed_active = m.top_k * 3 * d * m.d_expert
        shared = 3 * d * (m.d_expert * m.num_shared)
        per_type["attn_moe"] = attn + routed_total + shared + d * m.num_experts
        per_type["attn_moe_active"] = attn + routed_active + shared + d * m.num_experts
    di = int(cfg.mlstm_proj_factor * d)
    per_type["mlstm"] = d * 2 * di + 3 * di * di + di * d + 2 * di * cfg.conv_width
    dff_s = int(cfg.slstm_proj_factor * d)
    per_type["slstm"] = 4 * (d * d + (d // cfg.n_heads) * d) + d * d + 3 * d * dff_s
    dr = cfg.d_rnn or d
    per_type["rglru_mlp"] = 2 * d * dr + 2 * dr * dr + dr * d + 3 * d * cfg.d_ff
    total = embed + head
    active = head  # lm head is a matmul per token; embedding lookups are gathers
    for bt in cfg.block_types:
        total += per_type[bt]
        active += per_type[
            "attn_moe_active" if (bt == "attn_moe" and cfg.moe) else bt
        ]
    return int(total), int(active)


def model_flops(cfg, shape) -> dict:
    """Useful model FLOPs: 6·N_active·tokens (train) / 2·N_active·tokens
    (fwd-only), plus the causal-attention and recurrent-state terms.
    ``cfg``: a ``models.registry.ModelConfig``; ``shape``: a
    ``launch.specs.ShapeCell`` (or anything with its ``global_batch``,
    ``seq_len`` and ``kind``)."""
    B, T = shape.global_batch, shape.seq_len
    total, active = _active_params(cfg)
    H, dh = cfg.n_heads, cfg.head_dim
    n_attn = sum(1 for b in cfg.block_types if b in ("attn_mlp", "attn_moe"))
    n_lattn = sum(1 for b in cfg.block_types if b == "lattn_mlp")
    n_mlstm = sum(1 for b in cfg.block_types if b == "mlstm")
    W = cfg.window or T
    if shape.kind == "train":
        tokens = B * T
        base = 6 * active * tokens
        # causal pairs = T²/2; two matmuls (QKᵀ, PV) of 2 FLOPs each → fwd
        # 4·pairs·H·dh, ×3 for fwd+bwd = 12·pairs·H·dh.
        attn = n_attn * 12 * B * (T * T // 2) * H * dh
        lattn = n_lattn * 12 * B * (min(W, T) * T) * H * dh
        di = int(cfg.mlstm_proj_factor * cfg.d_model)
        dhi = di // cfg.n_heads
        mlstm = n_mlstm * 3 * (4 * B * T * cfg.n_heads * dhi * dhi)
        return {"model_flops": float(base + attn + lattn + mlstm),
                "active_params": active, "total_params": total, "tokens": tokens}
    if shape.kind == "prefill":
        tokens = B * T
        base = 2 * active * tokens
        attn = n_attn * 4 * B * (T * T // 2) * H * dh
        lattn = n_lattn * 4 * B * (min(W, T) * T) * H * dh
        di = int(cfg.mlstm_proj_factor * cfg.d_model)
        dhi = di // cfg.n_heads
        mlstm = n_mlstm * (4 * B * T * cfg.n_heads * dhi * dhi)
        return {"model_flops": float(base + attn + lattn + mlstm),
                "active_params": active, "total_params": total, "tokens": tokens}
    # decode: one token over a cache of depth T
    base = 2 * active * B
    attn = n_attn * 4 * B * T * H * dh
    lattn = n_lattn * 4 * B * min(W, T) * H * dh
    di = int(cfg.mlstm_proj_factor * cfg.d_model)
    dhi = di // cfg.n_heads
    mlstm = n_mlstm * 4 * B * cfg.n_heads * dhi * dhi
    return {"model_flops": float(base + attn + lattn + mlstm),
            "active_params": active, "total_params": total, "tokens": B}


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    model_flops: float

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / HW["peak_flops"]

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HW["hbm_bw"]

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / HW["link_bw"]

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-FLOPs time / achievable step time (the score we report):
        (model_flops / chips / peak) / max(term)."""
        ideal = self.model_flops / self.chips / HW["peak_flops"]
        bound = max(self.compute_s, self.memory_s, self.collective_s)
        return ideal / bound if bound else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo_flops_per_dev": self.flops_per_device,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_terms(arch, shape, mesh_name, chips, analysis, mf) -> RooflineReport:
    """Build the report from an analysis dict (``launch.op_analysis.analyze``'s,
    or the reference's ``hlo_analysis``, whose keys it shares) and
    :func:`model_flops`'s dict."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=float(analysis["flops"]),
        bytes_per_device=float(analysis["bytes"]),
        collective_bytes=float(analysis["collective_bytes"]),
        model_flops=float(mf["model_flops"]),
    )

"""Model configuration schema + architecture registry (a copy of the
reference's ``models/registry.py``, which is pure Python but pulls in the
reference's model stack when its configs are imported).

The layer stack is ``scan_unit × scan_repeats + tail``.  The port runs the
dense ``attn_mlp``, the MoE ``attn_moe`` and the xLSTM ``mlstm``/``slstm``
families; the other
architectures of the reference are listed in :data:`UNPORTED` and
:func:`get_config` raises for them with the ROADMAP item that will port
them.

Block types:
  attn_mlp   — GQA attention + gated/plain MLP        (dense transformers)
  attn_moe   — GQA attention + routed MoE (+ shared)  (MoE transformers)
  mlstm      — xLSTM matrix-memory block
  slstm      — xLSTM scalar-memory block
  rglru_mlp  — RG-LRU recurrent block + MLP           (Griffin/RecurrentGemma)
  lattn_mlp  — local sliding-window attention + MLP   (RecurrentGemma)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

__all__ = ["MoEConfig", "ModelConfig", "UNPORTED", "register", "get_config", "list_archs"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 64
    top_k: int = 6
    d_expert: int = 1408
    num_shared: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    router_score: str = "softmax"  # or "sigmoid" (DeepSeek-V3/Moonlight style)
    renorm_topk: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | vlm | hybrid | audio
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: int = 128
    scan_unit: tuple = ("attn_mlp",)
    tail: tuple = ()
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    mlp_act: str = "silu_glu"  # silu_glu | gelu_glu | gelu
    moe: Optional[MoEConfig] = None
    window: Optional[int] = None  # sliding-window size for lattn blocks
    # xLSTM specifics
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    conv_width: int = 4
    # RG-LRU specifics
    d_rnn: Optional[int] = None
    rglru_c: float = 8.0
    # modality frontends (precomputed embeddings / codebook tokens)
    num_codebooks: int = 0
    num_prefix_tokens: int = 0
    tie_embeddings: bool = False
    # Numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    subquadratic: bool = False

    @property
    def scan_repeats(self) -> int:
        body = self.n_layers - len(self.tail)
        assert body % len(self.scan_unit) == 0, (
            f"{self.name}: {body} body layers not divisible by unit {self.scan_unit}"
        )
        return body // len(self.scan_unit)

    @property
    def block_types(self) -> tuple:
        return self.scan_unit * self.scan_repeats + self.tail

    def validate(self) -> "ModelConfig":
        assert self.n_layers == len(self.block_types)
        assert self.n_heads % self.n_kv_heads == 0
        return self


# Architectures of the reference that the port does not run yet, with the
# ROADMAP item (queue 1) that ports them.
UNPORTED = {
    "recurrentgemma-9b": "item 13.3 (RG-LRU and local attention, rglru_mlp/lattn_mlp)",
    "musicgen-large": "item 13.4 (modality frontends: codebook streams)",
    "internvl2-1b": "item 13.4 (modality frontends: prefix embeddings)",
}

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str, **overrides) -> ModelConfig:
    """Instantiate a registered architecture (importing repro_torch.configs lazily)."""
    if name in UNPORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet: ROADMAP queue 1, {UNPORTED[name]}"
        )
    if name not in _REGISTRY:
        import importlib

        importlib.import_module("repro_torch.configs")
        if name not in _REGISTRY:
            raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg.validate()


def list_archs() -> list[str]:
    import importlib

    importlib.import_module("repro_torch.configs")
    return sorted(_REGISTRY)

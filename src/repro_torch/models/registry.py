"""Model configuration schema + architecture registry (a copy of the
reference's ``models/registry.py``, which is pure Python but pulls in the
reference's model stack when its configs are imported).

The layer stack is ``lead + scan_unit × scan_repeats + tail``.  The port
runs every architecture of the reference: the dense ``attn_mlp``, the MoE
``attn_moe``, the xLSTM ``mlstm``/``slstm`` and the RecurrentGemma
``rglru_mlp``/``lattn_mlp`` families, and the codebook and prefix
frontends; and, beyond the reference, DeepSeek-V2's latent attention
(``mla_mlp``/``mla_moe``, :class:`MLAConfig`), whose first layer is dense
(``lead``).

Block types:
  attn_mlp   — GQA attention + gated/plain MLP        (dense transformers)
  attn_moe   — GQA attention + routed MoE (+ shared)  (MoE transformers)
  mlstm      — xLSTM matrix-memory block
  slstm      — xLSTM scalar-memory block
  rglru_mlp  — RG-LRU recurrent block + MLP           (Griffin/RecurrentGemma)
  lattn_mlp  — local sliding-window attention + MLP   (RecurrentGemma)
  mla_mlp    — latent attention (MLA) + gated MLP      (DeepSeek-V2's dense layers)
  mla_moe    — latent attention (MLA) + routed MoE     (DeepSeek-V2)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

__all__ = ["MLAConfig", "MoEConfig", "ModelConfig", "register", "get_config", "list_archs"]


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
    # Expert parallelism's share: the experts [lo, hi) of num_experts that this
    # chip holds (None: all).  The router still scores all num_experts; the
    # layer computes only its own experts' part (models.moe).
    experts_held: Optional[tuple] = None
    # The balance loss: "switch" (over the batch's tokens, its weight spread
    # over the layers) or "seq" (DeepSeek-V2's expert-level loss taken per
    # sequence, router_aux_weight a layer, summed over the layers).
    balance: str = "switch"
    # The rows of a batch's padding slots (``rows_valid`` 0): True, they route,
    # take capacity and count in the balance loss like any row (the
    # reference's vmap); False, they take no part (models.moe).
    padding_routes: bool = True


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2's multi-head latent attention (arXiv:2405.04434 §2.1),
    without the query's low-rank path: q/k heads of qk_nope + qk_rope, v
    heads of v_head_dim, keys and values made from a kv_lora_rank latent,
    one qk_rope-wide rotary key shared by every head; rotary frequencies
    by YaRN (factor, original context, beta_fast, beta_slow) and the
    softmax scale times yarn_mscale(factor, mscale_all_dim)²
    (``models.layers``)."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_factor: float = 40.0
    rope_original_max: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707


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
    lead: tuple = ()  # block types before the scanned unit (DeepSeek-V2's dense first layer)
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    mlp_act: str = "silu_glu"  # silu_glu | gelu_glu | gelu
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
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
        body = self.n_layers - len(self.lead) - len(self.tail)
        assert body % len(self.scan_unit) == 0, (
            f"{self.name}: {body} body layers not divisible by unit {self.scan_unit}"
        )
        return body // len(self.scan_unit)

    @property
    def block_types(self) -> tuple:
        return self.lead + self.scan_unit * self.scan_repeats + self.tail

    def validate(self) -> "ModelConfig":
        assert self.n_layers == len(self.block_types)
        assert self.n_heads % self.n_kv_heads == 0
        return self


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str, **overrides) -> ModelConfig:
    """Instantiate a registered architecture (importing repro_torch.configs lazily)."""
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

"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + InternLM2(Qwen2-0.5B-class) backbone.
[arXiv:2404.16821; hf]

The vision frontend (InternViT) is a STUB per the assignment: ``input_specs``
provides 256 precomputed patch embeddings per sample which are prepended to
the text embeddings; labels cover only the text positions.
"""

import dataclasses

from ..models.registry import ModelConfig, register


@register("internvl2-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        vocab=151655,
        d_model=896,
        n_layers=24,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        head_dim=64,
        scan_unit=("attn_mlp",),
        qk_norm=False,
        qkv_bias=True,
        rope_theta=1e6,
        mlp_act="silu_glu",
        num_prefix_tokens=256,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), vocab=256, d_model=56, n_layers=4, n_heads=7, n_kv_heads=1,
        d_ff=112, head_dim=8, num_prefix_tokens=8,
    )

"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""

import dataclasses

from ..models.registry import ModelConfig, register


@register("qwen3-1.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b",
        family="dense",
        vocab=151936,
        d_model=2048,
        n_layers=28,
        n_heads=16,
        n_kv_heads=8,
        d_ff=6144,
        head_dim=128,
        scan_unit=("attn_mlp",),
        qk_norm=True,
        qkv_bias=False,
        rope_theta=1e6,
        mlp_act="silu_glu",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), vocab=256, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2,
        d_ff=128, head_dim=16,
    )

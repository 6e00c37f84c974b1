"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""

import dataclasses

from ..models.registry import ModelConfig, register


@register("qwen2.5-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b",
        family="dense",
        vocab=151936,
        d_model=2048,
        n_layers=36,
        n_heads=16,
        n_kv_heads=2,
        d_ff=11008,
        head_dim=128,
        scan_unit=("attn_mlp",),
        qk_norm=False,
        qkv_bias=True,
        rope_theta=1e6,
        mlp_act="silu_glu",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), vocab=256, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2,
        d_ff=128, head_dim=16,
    )

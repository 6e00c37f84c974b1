"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6 — 2 shared + 64 routed top-6, fine-grained.
[arXiv:2401.06066; hf]

DeepSeekMoE-16B uses softmax router scores without top-k renormalization.
Deviation noted in DESIGN.md §8: layer 0 of the real checkpoint is dense; we
keep all layers MoE for a homogeneous scan unit.
"""

import dataclasses

from ..models.registry import ModelConfig, MoEConfig, register


@register("deepseek-moe-16b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        vocab=102400,
        d_model=2048,
        n_layers=28,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        head_dim=128,
        scan_unit=("attn_moe",),
        qk_norm=False,
        qkv_bias=False,
        rope_theta=1e4,
        mlp_act="silu_glu",
        moe=MoEConfig(
            num_experts=64, top_k=6, d_expert=1408, num_shared=2,
            capacity_factor=1.25, router_score="softmax", renorm_topk=False,
        ),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), vocab=256, d_model=64, n_layers=4, n_heads=4, n_kv_heads=4,
        d_ff=32, head_dim=16,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, num_shared=2),
    )

"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64e top-6 — kimi/moonlight.  [hf:moonshotai/Moonlight-16B-A3B]

Moonlight follows the DeepSeek-V3 recipe: 2 shared experts, sigmoid router
scores with top-k renormalization.  Deviation noted in DESIGN.md §8: the real
checkpoint keeps layer 0 dense; we keep all layers MoE so the stack scans as
one homogeneous unit.
"""

import dataclasses

from ..models.registry import ModelConfig, MoEConfig, register


@register("moonshot-v1-16b-a3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        vocab=163840,
        d_model=2048,
        n_layers=48,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        head_dim=128,
        scan_unit=("attn_moe",),
        qk_norm=False,
        qkv_bias=False,
        rope_theta=1e6,
        mlp_act="silu_glu",
        moe=MoEConfig(
            num_experts=64, top_k=6, d_expert=1408, num_shared=2,
            capacity_factor=1.25, router_score="sigmoid", renorm_topk=True,
        ),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), vocab=256, d_model=64, n_layers=4, n_heads=4, n_kv_heads=4,
        d_ff=32, head_dim=16,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, num_shared=1,
                      router_score="sigmoid", renorm_topk=True),
    )

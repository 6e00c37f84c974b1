"""deepseek-v2-lite [moe]: 27L d_model=2048 16H, MLA (no q-LoRA, kv_lora_rank
512, q/k heads 128 + 64 rope, v heads 128, YaRN rope x40 over 4096), layer 0
dense (d_ff 10944), 26 MoE layers of 64 routed experts (width 1408) top-6
with softmax scores and no renormalisation, 2 shared, the per-sequence
balance loss; vocab 102400, untied.
[arXiv:2405.04434; https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite]

The port's own: the reference package has no latent attention and no twin
of this config.  ``router_aux_weight`` is DeepSeek-V2's α = 0.001 a layer
(``aux_loss_alpha`` of the published code; the catalog's copy of the
config omits it).  ``head_dim`` is the q/k width, 128 + 64.  A padding
slot's rows take no part in the MoE (``padding_routes=False``): the
deployment holds no such rows.
"""

import dataclasses

from ..models.registry import MLAConfig, ModelConfig, MoEConfig, register


@register("deepseek-v2-lite")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite",
        family="moe",
        vocab=102400,
        d_model=2048,
        n_layers=27,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,
        head_dim=192,
        lead=("mla_mlp",),
        scan_unit=("mla_moe",),
        rope_theta=1e4,
        mlp_act="silu_glu",
        moe=MoEConfig(
            num_experts=64, top_k=6, d_expert=1408, num_shared=2, capacity_factor=1.25,
            router_aux_weight=0.001, router_score="softmax", renorm_topk=False, balance="seq",
            padding_routes=False,
        ),
        mla=MLAConfig(
            kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
            rope_factor=40.0, rope_original_max=4096, rope_beta_fast=32.0, rope_beta_slow=1.0,
            rope_mscale=0.707, rope_mscale_all_dim=0.707,
        ),
    )


def smoke_config() -> ModelConfig:
    """One dense and two MoE layers at d_model 64: 4 heads of 16 + 8 (q/k)
    and 16 (v), a latent of 32, 8 experts of 32 top-2, the YaRN rope of
    the full config over an original context of 16."""
    return dataclasses.replace(
        config(), vocab=256, d_model=64, n_layers=3, n_heads=4, n_kv_heads=4, d_ff=96, head_dim=24,
        moe=dataclasses.replace(config().moe, num_experts=8, top_k=2, d_expert=32),
        mla=dataclasses.replace(config().mla, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                                v_head_dim=16, rope_original_max=16),
    )

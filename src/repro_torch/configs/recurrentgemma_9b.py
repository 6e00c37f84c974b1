"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attn, 1:2.  [arXiv:2402.19427]

Griffin layout: repeating (recurrent, recurrent, local-attention) with MQA
(kv=1) window-2048 attention; 38 = 12×3 + 2 trailing recurrent blocks.
RG-LRU decode carries an O(d_rnn) vector state and the local-attention cache
is bounded by the window → sub-quadratic.  10,444,984,320 parameters
(``jax.eval_shape`` of the reference's ``init_params``).
"""

import dataclasses

from ..models.registry import ModelConfig, register


@register("recurrentgemma-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        vocab=256000,
        d_model=4096,
        n_layers=38,
        n_heads=16,
        n_kv_heads=1,
        d_ff=12288,
        head_dim=256,
        scan_unit=("rglru_mlp", "rglru_mlp", "lattn_mlp"),
        tail=("rglru_mlp", "rglru_mlp"),
        rope_theta=1e4,
        mlp_act="gelu_glu",
        window=2048,
        d_rnn=4096,
        conv_width=4,
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), vocab=256, d_model=64, n_layers=8, n_heads=4, n_kv_heads=1,
        d_ff=128, head_dim=16, window=32, d_rnn=64,
        scan_unit=("rglru_mlp", "rglru_mlp", "lattn_mlp"), tail=("rglru_mlp", "rglru_mlp"),
    )

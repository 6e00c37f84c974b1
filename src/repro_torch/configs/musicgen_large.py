"""musicgen-large [audio]: 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

The EnCodec frontend is a STUB per the assignment: inputs are 4 parallel
codebook token streams (the delay-pattern interleaving is a data-layer
concern); embeddings are summed, and the LM head predicts all 4 codebooks
per position.  MLP is the model's plain (non-gated) GELU FFN.
"""

import dataclasses

from ..models.registry import ModelConfig, register


@register("musicgen-large")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        vocab=2048,
        d_model=2048,
        n_layers=48,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        head_dim=64,
        scan_unit=("attn_mlp",),
        qk_norm=False,
        qkv_bias=False,
        rope_theta=1e4,
        mlp_act="gelu",
        num_codebooks=4,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), vocab=64, d_model=64, n_layers=4, n_heads=4, n_kv_heads=4,
        d_ff=128, head_dim=16, num_codebooks=2,
    )

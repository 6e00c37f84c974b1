"""Configs of the architectures the port runs (the dense ``attn_mlp``, the
MoE ``attn_moe``, the xLSTM ``mlstm``/``slstm`` and the RecurrentGemma
``rglru_mlp``/``lattn_mlp`` families).  Importing
this package registers them with repro_torch.models.registry; the other
architectures of the reference are in ``registry.UNPORTED``."""

from . import (  # noqa: F401
    deepseek_moe_16b,
    moonshot_v1_16b_a3b,
    qwen2_5_3b,
    qwen3_1_7b,
    qwen3_4b,
    qwen3_8b,
    recurrentgemma_9b,
    xlstm_1_3b,
)

ARCHS = ["qwen3-4b", "qwen3-8b", "qwen2.5-3b", "qwen3-1.7b", "moonshot-v1-16b-a3b", "deepseek-moe-16b",
         "xlstm-1.3b", "recurrentgemma-9b"]

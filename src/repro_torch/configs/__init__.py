"""Configs of the architectures the port runs: all ten of the reference
(the dense ``attn_mlp``, the MoE ``attn_moe``, the xLSTM
``mlstm``/``slstm``, the RecurrentGemma ``rglru_mlp``/``lattn_mlp``
families, and the two modality frontends, musicgen-large's codebook
streams and internvl2-1b's prefix embeddings), ``REFERENCE_ARCHS``, and
one of its own, deepseek-v2-lite (latent attention, ``mla_mlp``/
``mla_moe``; it trains meshless and does not serve yet).  ``ARCHS`` is
all eleven.  Importing this package registers them with
repro_torch.models.registry."""

from . import (  # noqa: F401
    deepseek_moe_16b,
    deepseek_v2_lite,
    internvl2_1b,
    moonshot_v1_16b_a3b,
    musicgen_large,
    qwen2_5_3b,
    qwen3_1_7b,
    qwen3_4b,
    qwen3_8b,
    recurrentgemma_9b,
    xlstm_1_3b,
)

REFERENCE_ARCHS = ["qwen3-4b", "qwen3-8b", "qwen2.5-3b", "qwen3-1.7b", "moonshot-v1-16b-a3b", "deepseek-moe-16b",
                   "xlstm-1.3b", "recurrentgemma-9b", "musicgen-large", "internvl2-1b"]
ARCHS = REFERENCE_ARCHS + ["deepseek-v2-lite"]

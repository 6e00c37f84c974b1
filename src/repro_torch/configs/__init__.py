"""Configs of the architectures the port runs (the dense ``attn_mlp`` family).
Importing this package registers them with repro_torch.models.registry;
the other architectures of the reference are in ``registry.UNPORTED``."""

from . import qwen2_5_3b, qwen3_1_7b, qwen3_4b, qwen3_8b  # noqa: F401

ARCHS = ["qwen3-4b", "qwen3-8b", "qwen2.5-3b", "qwen3-1.7b"]

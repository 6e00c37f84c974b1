"""xlstm-1.3b [ssm]: 48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks.  [arXiv:2405.04517]

xLSTM[7:1] layout: every 8th block is sLSTM, the rest mLSTM (matrix memory,
chunkwise-parallel forward, O(1)-state recurrent decode).  d_ff=0: mLSTM
blocks carry their own pre-up-projection (factor 2) instead of a separate
FFN; sLSTM blocks use the paper's post-FFN with factor 4/3.  ``head_dim``
is the sLSTM's d / H = 512; the mLSTM's heads are di / H = 4096 / 4 = 1024
wide.  The dense q, k, v projections of the mLSTM blocks make the model
3,631,155,536 parameters, as the reference's, not the paper's 1.3 B.
"""

import dataclasses

from ..models.registry import ModelConfig, register


@register("xlstm-1.3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        vocab=50304,
        d_model=2048,
        n_layers=48,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        head_dim=512,
        scan_unit=("mlstm",) * 7 + ("slstm",),
        mlstm_proj_factor=2.0,
        slstm_proj_factor=4.0 / 3.0,
        conv_width=4,
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), vocab=256, d_model=64, n_layers=8, n_heads=4, head_dim=16,
        scan_unit=("mlstm", "mlstm", "mlstm", "slstm"),
    )

"""xlstm-125m [ssm]: 12 blocks, d_model=768, 4 heads, vocab=50304.

sLSTM + mLSTM blocks at a 3:1 mLSTM:sLSTM interleave (the xLSTM paper's
[m:s] block-ratio notation); xLSTM blocks carry their own up/down
projections, so d_ff=0 and mlp="none". Linear-time recurrence -> runs the
long_500k cell with O(1) decode state. [arXiv:2405.04517; unverified]
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, XLSTMConfig, register

XLSTM_125M = register(
    ModelConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        head_dim=192,  # d_model / heads
        d_ff=0,
        vocab_size=50_304,
        period=(
            LayerSpec("mlstm", "none"),
            LayerSpec("mlstm", "none"),
            LayerSpec("mlstm", "none"),
            LayerSpec("slstm", "none"),
        ),
        xlstm=XLSTMConfig(
            mlstm_proj_factor=2.0,
            slstm_proj_factor=4.0 / 3.0,
            conv_kernel=4,
        ),
        norm_type="layernorm",
        pos_type="none",
        supports_long_context=True,
        dtype="bfloat16",
    )
)

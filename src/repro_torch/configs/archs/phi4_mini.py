"""phi4-mini-3.8b [dense]: 32L, d_model=3072, 24H GQA(kv=8), d_ff=8192,
vocab=200064. RoPE + SwiGLU + RMSNorm, tied embeddings.
[arXiv:2412.08905; hf]
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, register

PHI4_MINI = register(
    ModelConfig(
        name="phi4-mini-3.8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=200_064,
        period=(LayerSpec("attn", "mlp"),),
        mlp_type="swiglu",
        norm_type="rmsnorm",
        pos_type="rope",
        rope_theta=10_000.0,
        tie_embeddings=True,
        supports_long_context=False,
        dtype="bfloat16",
    )
)

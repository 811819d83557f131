"""gemma-7b [dense]: 28L, d_model=3072, 16H MHA (kv=16), head_dim=256
(q/k/v project to 4096 != d_model), d_ff=24576, GeGLU, vocab=256000.
Embeddings scaled by sqrt(d_model); tied LM head. (MQA is the 2b variant.)
[arXiv:2403.08295; hf]
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, register

GEMMA_7B = register(
    ModelConfig(
        name="gemma-7b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        d_ff=24_576,
        vocab_size=256_000,
        period=(LayerSpec("attn", "mlp"),),
        mlp_type="geglu",
        norm_type="rmsnorm",
        pos_type="rope",
        rope_theta=10_000.0,
        tie_embeddings=True,
        embed_scale=True,
        supports_long_context=False,
        dtype="bfloat16",
    )
)

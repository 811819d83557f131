"""command-r-plus-104b [dense]: 64L, d_model=12288, 96H GQA(kv=8),
d_ff=33792, vocab=256000. No biases anywhere; Cohere's parallel residual
block (attn and MLP both read the same pre-norm); LayerNorm (no bias);
tied embeddings. [hf:CohereForAI/c4ai-command-r-v01; unverified]
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, register

COMMAND_R_PLUS = register(
    ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        num_layers=64,
        d_model=12_288,
        num_heads=96,
        num_kv_heads=8,
        head_dim=128,
        d_ff=33_792,
        vocab_size=256_000,
        period=(LayerSpec("attn", "mlp"),),
        mlp_type="swiglu",
        norm_type="layernorm",
        pos_type="rope",
        rope_theta=10_000.0,
        attn_bias=False,
        tie_embeddings=True,
        parallel_block=True,
        supports_long_context=False,
        dtype="bfloat16",
    )
)

"""whisper-base [audio]: enc-dec transformer, conv frontend stubbed.

6L encoder + 6L decoder, d_model=512, 8H (kv=8 -> MHA), d_ff=2048,
vocab=51865. LayerNorm, GELU MLP, biases on attention (Whisper uses them),
sinusoidal positions on the encoder / learned on the decoder.
[arXiv:2212.04356; unverified]

The audio frontend (two conv1d + GELU downsampling of log-mel frames) is a
STUB: input_specs() provides precomputed frame embeddings (B, S, d_model),
per the assignment. The decoder is a full causal LM over the token vocab, so
prefill/decode shapes lower the decoder with cross-attention to the stubbed
encoder output.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, register

WHISPER_BASE = register(
    ModelConfig(
        name="whisper-base",
        family="audio",
        num_layers=6,  # decoder layers; encoder_layers adds the encoder
        encoder_layers=6,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab_size=51_865,
        period=(LayerSpec("attn", "mlp"),),
        mlp_type="gelu",
        norm_type="layernorm",
        pos_type="sinusoidal",
        attn_bias=True,
        tie_embeddings=True,  # whisper ties decoder embed/proj
        input_mode="embeddings",  # conv frontend stubbed
        supports_long_context=False,  # full attention
        dtype="bfloat16",
    )
)

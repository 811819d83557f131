"""llava-next-mistral-7b [vlm]: Mistral-7B backbone — 32L, d_model=4096,
32H GQA(kv=8), d_ff=14336, vocab=32000, rope_theta=1e6.

The anyres vision tower + projector is a STUB: input_specs() provides the
fused sequence of precomputed patch+text embeddings (B, S, d_model), per the
assignment ("modality frontend is a STUB").
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, register

LLAVA_NEXT_MISTRAL = register(
    ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14_336,
        vocab_size=32_000,
        period=(LayerSpec("attn", "mlp"),),
        mlp_type="swiglu",
        norm_type="rmsnorm",
        pos_type="rope",
        rope_theta=1_000_000.0,
        input_mode="embeddings",  # vision frontend stubbed
        supports_long_context=False,
        dtype="bfloat16",
    )
)

"""qwen2-moe-a2.7b (Qwen1.5-MoE-A2.7B) [moe]: 24L, d_model=2048, 16H MHA
(kv=16) with qkv bias, vocab=151936. Every layer MoE: 60 routed experts
(top-4) + 4 shared expert units of d_ff=1408 (the HF config's single
5632-wide shared expert == 4 x 1408 in parameters).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""

from repro_torch.configs.base import LayerSpec, MoEConfig, ModelConfig, register

QWEN2_MOE = register(
    ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,  # expert width (all layers are MoE)
        vocab_size=151_936,
        period=(LayerSpec("attn", "moe"),),
        moe=MoEConfig(
            num_experts=60,
            top_k=4,
            d_ff_expert=1408,
            num_shared=4,
            router_chunk=512,
        ),
        mlp_type="swiglu",
        norm_type="rmsnorm",
        pos_type="rope",
        rope_theta=1_000_000.0,
        qkv_bias=True,
        supports_long_context=False,
        dtype="bfloat16",
    )
)

"""deepseek-v2-lite-16b [moe]: 27L, d_model=2048, 16H with MLA
(kv_lora_rank=512, qk_nope=128, qk_rope=64, v=128), vocab=102400.
Layer 0 is dense (d_ff=10944); layers 1..26 are MoE with 64 routed experts
(top-6) + 2 shared experts, expert d_ff=1408. [arXiv:2405.04434; hf]

Note: the assignment header lists "2 shared+160 routed"; 160 routed is the
full V2 — V2-**Lite** has 64 routed (matching the header's "MoE 64e top-6"),
which is what we implement.
"""

from repro_torch.configs.base import (
    LayerSpec,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    register,
)

DEEPSEEK_V2_LITE = register(
    ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,  # MLA: all heads share the latent kv
        head_dim=128,  # nominal; MLA dims below are authoritative
        d_ff=10_944,  # dense layer-0 MLP
        vocab_size=102_400,
        prefix=(LayerSpec("mla", "mlp"),),
        period=(LayerSpec("mla", "moe"),),
        mla=MLAConfig(
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=64,
            top_k=6,
            d_ff_expert=1408,
            num_shared=2,
            router_chunk=512,
        ),
        mlp_type="swiglu",
        norm_type="rmsnorm",
        pos_type="rope",  # applied to the decoupled rope dims only
        rope_theta=10_000.0,
        supports_long_context=False,  # MLA is still full attention
        dtype="bfloat16",
    )
)

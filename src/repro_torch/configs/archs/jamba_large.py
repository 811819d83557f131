"""jamba-1.5-large-398b [hybrid]: 72L, d_model=8192, 64H GQA(kv=8),
d_ff=24576, vocab=65536. Mamba:attention 7:1 interleave (one attention layer
per period of 8), MoE (16 experts, top-2) on every second layer.
Mamba state is O(1) in sequence -> runs long_500k. [arXiv:2403.19887; hf]
"""

from repro_torch.configs.base import (
    LayerSpec,
    MambaConfig,
    MoEConfig,
    ModelConfig,
    register,
)


def _period():
    # period of 8: attention at index 3, the rest Mamba; MoE every 2nd layer
    specs = []
    for i in range(8):
        mixer = "attn" if i == 3 else "mamba"
        mlp = "moe" if i % 2 == 1 else "mlp"
        specs.append(LayerSpec(mixer, mlp))
    return tuple(specs)


JAMBA_LARGE = register(
    ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24_576,
        vocab_size=65_536,
        period=_period(),
        moe=MoEConfig(
            num_experts=16,
            top_k=2,
            d_ff_expert=24_576,
            num_shared=0,
            router_chunk=512,
        ),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=64),
        mlp_type="swiglu",
        norm_type="rmsnorm",
        pos_type="none",  # jamba uses no positional encoding (Mamba provides order)
        supports_long_context=True,
        dtype="bfloat16",
    )
)

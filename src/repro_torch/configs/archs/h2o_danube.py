"""h2o-danube-1.8b [dense]: 24L, d_model=2560, 32H GQA(kv=8), head_dim=80,
d_ff=6912, vocab=32000. Llama+Mistral mix with sliding-window attention
(window 4096) -> sub-quadratic, so it RUNS the long_500k cell.
[arXiv:2401.16818; hf]
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, register

H2O_DANUBE = register(
    ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        num_layers=24,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=80,
        d_ff=6912,
        vocab_size=32_000,
        period=(LayerSpec("swa", "mlp"),),
        mlp_type="swiglu",
        norm_type="rmsnorm",
        pos_type="rope",
        rope_theta=10_000.0,
        sliding_window=4096,
        supports_long_context=True,  # SWA: O(S * window) attention
        dtype="bfloat16",
    )
)

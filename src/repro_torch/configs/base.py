"""Config system: one dataclass tree per architecture + a registry.

The port's own copy of the reference's configs/base.py (same fields, same
names, same registry contents), so the port never imports the reference.
Every architecture is a `ModelConfig` selectable via --arch. Layer
heterogeneity (hybrid interleave, MoE periods, first-dense layers) is
expressed as `prefix` + repeating `period` of LayerSpecs; period parameters
and caches carry a leading num_periods axis, as in the reference.
`remat` and `scan_unroll` are the reference's training knobs and are carried
as data only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int  # routed experts
    top_k: int
    d_ff_expert: int
    num_shared: int = 0  # shared (always-on) experts, each d_ff_expert wide
    capacity_factor: float = 1.25
    router_chunk: int = 512  # token-chunked dispatch (memory bound)
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    chunk: int = 64  # chunked associative scan length


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    conv_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer = a sequence mixer + a channel mixer."""

    mixer: str  # attn | swa | mla | mamba | mlstm | slstm
    mlp: str  # mlp | moe | none   (xlstm blocks carry their own projections)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # layer plan
    prefix: Tuple[LayerSpec, ...] = ()
    period: Tuple[LayerSpec, ...] = (LayerSpec("attn", "mlp"),)

    # flavor knobs
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    pos_type: str = "rope"  # rope | learned | sinusoidal | none
    rope_theta: float = 10_000.0
    attn_bias: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    sliding_window: int = 0  # >0 enables SWA for "swa" mixers
    attn_logit_softcap: float = 0.0
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)
    parallel_block: bool = False  # cohere: x + attn(n(x)) + mlp(n(x))

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # enc-dec (whisper): encoder depth; 0 = decoder-only
    encoder_layers: int = 0

    # modality frontend: "tokens" | "embeddings" (stubbed audio/vision)
    input_mode: str = "tokens"

    vocab_pad_multiple: int = 256
    max_position_embeddings: int = 32_768  # learned-position table size
    dtype: str = "bfloat16"
    # training memory knobs (used by train/dryrun)
    remat: bool = True
    scan_unroll: int = 1

    # which serve shapes are valid (sub-quadratic archs run long_500k)
    supports_long_context: bool = False

    def __post_init__(self):
        n_periodic = self.num_layers - len(self.prefix)
        assert n_periodic >= 0
        if self.period:
            assert n_periodic % len(self.period) == 0, (
                f"{self.name}: {n_periodic} periodic layers not divisible by "
                f"period {len(self.period)}"
            )

    @property
    def num_periods(self) -> int:
        return (self.num_layers - len(self.prefix)) // max(len(self.period), 1)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    def layer_kinds(self):
        """Flat per-layer specs (prefix + repeated period)."""
        return list(self.prefix) + list(self.period) * self.num_periods

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks); used by rooflines."""
        from repro_torch.models.counting import count_params

        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.counting import count_params

        return count_params(self, active_only=True)


# ---------------------------------------------------------------------------
# Shape cells (assigned input shapes; applies to every LM arch)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: Dict[str, "ModelConfig"] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    assert cfg.name not in _REGISTRY, cfg.name
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def cells_for(cfg: ModelConfig):
    """The (shape -> applicable?) map for one arch; long_500k only for
    sub-quadratic archs (DESIGN.md §Arch-applicability)."""
    out = {}
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.supports_long_context:
            out[s.name] = False
        else:
            out[s.name] = True
    return out


def _ensure_loaded():
    # importing the arch modules populates the registry
    import repro_torch.configs.archs  # noqa: F401

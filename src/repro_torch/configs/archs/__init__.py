"""Importing this package registers every assigned architecture."""

from repro_torch.configs.archs.whisper_base import WHISPER_BASE
from repro_torch.configs.archs.phi4_mini import PHI4_MINI
from repro_torch.configs.archs.gemma_7b import GEMMA_7B
from repro_torch.configs.archs.command_r_plus import COMMAND_R_PLUS
from repro_torch.configs.archs.h2o_danube import H2O_DANUBE
from repro_torch.configs.archs.xlstm_125m import XLSTM_125M
from repro_torch.configs.archs.jamba_large import JAMBA_LARGE
from repro_torch.configs.archs.deepseek_v2_lite import DEEPSEEK_V2_LITE
from repro_torch.configs.archs.qwen2_moe import QWEN2_MOE
from repro_torch.configs.archs.llava_next_mistral import LLAVA_NEXT_MISTRAL

ALL_ARCHS = [
    WHISPER_BASE,
    PHI4_MINI,
    GEMMA_7B,
    COMMAND_R_PLUS,
    H2O_DANUBE,
    XLSTM_125M,
    JAMBA_LARGE,
    DEEPSEEK_V2_LITE,
    QWEN2_MOE,
    LLAVA_NEXT_MISTRAL,
]

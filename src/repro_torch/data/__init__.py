"""The synthetic token pipeline (the reference's repro.data)."""

from repro_torch.data.pipeline import DataConfig, SyntheticTokens, to_device

__all__ = ["DataConfig", "SyntheticTokens", "to_device"]

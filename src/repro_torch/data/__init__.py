"""Training data of the port: the counterpart of ``repro.data``."""
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline

__all__ = ["DataConfig", "SyntheticPipeline"]

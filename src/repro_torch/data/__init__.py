"""The synthetic token pipeline (``repro.data``)."""
from .pipeline import PipelineConfig, SyntheticPipeline, for_arch

__all__ = ["PipelineConfig", "SyntheticPipeline", "for_arch"]

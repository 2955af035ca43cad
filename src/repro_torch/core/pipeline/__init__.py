from .async_pipeline import AsyncPipeline, Stage, StageStats
from .minibatch import NodeMinibatchPipeline

__all__ = ["AsyncPipeline", "Stage", "StageStats", "NodeMinibatchPipeline"]

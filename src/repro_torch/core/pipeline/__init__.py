from .async_pipeline import AsyncPipeline, Stage, StageStats
from .minibatch import LinkMinibatchPipeline, NodeMinibatchPipeline

__all__ = ["AsyncPipeline", "Stage", "StageStats", "LinkMinibatchPipeline",
           "NodeMinibatchPipeline"]

from . import pipelines  # noqa: F401  (registers pipeline transforms)
from . import coco       # noqa: F401  (registers datasets)
from .batcher import (GroupedBatchSampler, SequentialBatchSampler,
                      StaticBatcher)
from .loader import EvalLoader, TrainLoader
from .pipelines import Compose

__all__ = ['GroupedBatchSampler', 'SequentialBatchSampler', 'StaticBatcher',
           'EvalLoader', 'TrainLoader', 'Compose']

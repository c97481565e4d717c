"""boxinstseg_tpu_torch: the PyTorch / CUDA port of the box-supervised
instance segmentation toolbox, beside the JAX package ``boxinstseg_tpu``
(which stays the reference). Imports torch and numpy, never JAX."""

__version__ = '0.1.0'

from .config import Config, ConfigDict
from .registry import (BACKBONES, DATASETS, DETECTORS, HEADS, LOSSES, NECKS,
                       PIPELINES, build_backbone, build_dataset,
                       build_detector, build_head, build_loss, build_neck)


def _register_all():
    """Import submodules for their registration side effects."""
    from . import models  # noqa: F401
    from . import data    # noqa: F401


_register_all()

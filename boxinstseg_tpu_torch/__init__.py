"""boxinstseg_tpu_torch: the PyTorch / CUDA port of the box-supervised
instance segmentation toolbox, beside the JAX package ``boxinstseg_tpu``
(which stays the reference). Imports torch and numpy, never JAX."""

__version__ = '0.1.0'

import torch

# The first torch.exp of a process on the CPU, when it is split over
# several threads, can give one thread's share about 1.5e-4 off; after one
# call on one thread, it does not (torch 2.13 on the CPU: 8 and 0 of 40
# fresh processes, tools/check_cpu_exp_first_call.py). The plain versions,
# the CPU path and the kernels' oracle, use torch.exp, so the package
# makes that one-thread call before any of its code runs.
torch.exp(torch.zeros(8))

from .config import Config, ConfigDict
from .registry import (BACKBONES, DATASETS, DETECTORS, HEADS, LOSSES, NECKS,
                       PIPELINES, build_backbone, build_dataset,
                       build_detector, build_head, build_loss, build_neck)


def _register_all():
    """Import submodules for their registration side effects."""
    from . import models  # noqa: F401
    from . import data    # noqa: F401


_register_all()

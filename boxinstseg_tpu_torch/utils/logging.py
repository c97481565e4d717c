"""Logging, counterpart of ``boxinstseg_tpu/utils/logging.py`` (reference:
mmdet/utils/logger.py get_root_logger). The port's one logger is
``apis.train.get_logger``; ``get_root_logger`` is its reference name."""
from ..apis.train import get_logger as get_root_logger

__all__ = ['get_root_logger']

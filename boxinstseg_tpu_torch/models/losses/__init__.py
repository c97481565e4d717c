from .cross_entropy_loss import (CrossEntropyLoss,
                                 binary_cross_entropy_with_logits)
from .focal_loss import FocalLoss, sigmoid_focal_loss
from .iou_loss import GIoULoss
from .levelset_loss import LevelsetLoss
from .projection import BoxProjectionLoss, compute_project_term

__all__ = ['CrossEntropyLoss', 'binary_cross_entropy_with_logits',
           'FocalLoss', 'sigmoid_focal_loss', 'GIoULoss',
           'LevelsetLoss', 'BoxProjectionLoss', 'compute_project_term']

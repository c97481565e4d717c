from .ae_loss import AssociativeEmbeddingLoss, ae_loss_per_image
from .cross_entropy_loss import (CrossEntropyLoss,
                                 binary_cross_entropy_with_logits)
from .dice_loss import DiceLoss, dice_coefficient
from .focal_loss import FocalLoss, sigmoid_focal_loss
from .iou_loss import (BoundedIoULoss, CIoULoss, DIoULoss, GIoULoss,
                       IoULoss)
from .levelset_loss import LevelsetLoss
from .misc_losses import (GHMC, GHMR, Accuracy, BalancedL1Loss,
                          DistributionFocalLoss, GaussianFocalLoss,
                          KnowledgeDistillationKLDivLoss, L1Loss, MSELoss,
                          QualityFocalLoss, SmoothL1Loss, VarifocalLoss,
                          accuracy)
from .pisa_loss import carl_loss, isr_p
from .projection import BoxProjectionLoss, compute_project_term
from .seesaw_loss import SeesawLoss, seesaw_ce_loss

__all__ = ['CrossEntropyLoss', 'binary_cross_entropy_with_logits',
           'DiceLoss', 'dice_coefficient',
           'FocalLoss', 'sigmoid_focal_loss', 'IoULoss', 'GIoULoss',
           'DIoULoss', 'CIoULoss', 'BoundedIoULoss',
           'LevelsetLoss', 'BoxProjectionLoss', 'compute_project_term',
           'L1Loss', 'SmoothL1Loss', 'MSELoss', 'GaussianFocalLoss',
           'VarifocalLoss', 'BalancedL1Loss', 'QualityFocalLoss',
           'DistributionFocalLoss', 'KnowledgeDistillationKLDivLoss', 'GHMC',
           'GHMR', 'accuracy', 'Accuracy', 'SeesawLoss', 'seesaw_ce_loss',
           'AssociativeEmbeddingLoss', 'ae_loss_per_image', 'isr_p',
           'carl_loss']

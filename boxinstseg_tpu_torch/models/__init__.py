from . import losses  # noqa: F401  (registers loss modules)
from .backbones import resnet, swin  # noqa: F401
from .necks import fpn  # noqa: F401
from .dense_heads import (box2mask_head, condinst_head,  # noqa: F401
                          discobox_head)
from .detectors import condinst, maskformer, single_stage_ts  # noqa: F401

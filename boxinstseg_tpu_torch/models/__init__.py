from . import losses  # noqa: F401  (registers loss modules)
from .backbones import resnet, swin  # noqa: F401
from .necks import fpn  # noqa: F401
from .dense_heads import (box2mask_head, box_solov2_head,  # noqa: F401
                          condinst_head, discobox_head)
from .detectors import (condinst, maskformer,  # noqa: F401
                        single_stage_boxseg, single_stage_ts)

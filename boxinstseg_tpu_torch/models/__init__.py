from . import losses  # noqa: F401  (registers loss modules)
from .backbones import resnet  # noqa: F401
from .necks import fpn  # noqa: F401
from .dense_heads import condinst_head  # noqa: F401
from .detectors import condinst  # noqa: F401

"""Single-image inference, counterpart of ``boxinstseg_tpu/apis/inference.py``
(reference: mmdet/apis/inference.py:18-156 init_detector /
inference_detector).

Checkpoints are ``.pth`` files holding a ``state_dict`` with the mmdet
reference's key names: the port's own (``apis.train.train_detector``
writes one) and the reference's, which load with no converter. The JAX
package's orbax directories and ``.msgpack`` files need JAX or flax to
read; its weights come across through ``utils.weights.params_from_jax``.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..config import Config
from ..core.structures import InstanceData
from ..data.pipelines import Compose
from ..registry import build_detector
from ..utils.env import set_tf32, tf32_from_cfg
from .test import eval_batcher, format_detection, predict_batch
from .train import apply_precision_policy, get_logger


def load_config(path: str, cfg_options=()) -> Config:
    """The config file at ``path`` as the entry points read it: ``${key}``
    values replaced, legacy keys migrated, then the ``key=value`` strings
    of ``cfg_options`` merged."""
    from ..config import compat_cfg, replace_cfg_vals
    cfg = compat_cfg(replace_cfg_vals(Config.fromfile(path)))
    cfg.merge_from_dict(dict(kv.split('=', 1) for kv in cfg_options))
    return cfg


def select_device(name: str) -> torch.device:
    """The device a script's ``--device`` names: ``cuda`` (the scripts'
    default) needs a card and raises without one; ``cpu`` runs only when
    asked for."""
    if name == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('--device cuda: no CUDA device is available')
    return torch.device(name)


def class_names(cfg):
    """The class names to draw: ``cfg.classes`` or the test dataset's
    ``classes`` when set, else those of the test dataset's type (COCO when
    the config names none)."""
    from ..data.coco import COCO_CLASSES
    from ..registry import DATASETS
    test = (cfg.get('data') or {}).get('test') or {}
    if cfg.get('classes') or test.get('classes'):
        return tuple(cfg.get('classes') or test['classes'])
    dataset = DATASETS.get(test.get('type', 'CocoDataset'))
    return getattr(dataset, 'CLASSES', COCO_CLASSES)


def init_detector(config: Union[str, Config],
                  checkpoint: Optional[str] = None, device='cuda'):
    """Build the detector of ``config`` on ``device``, in ``eval()``, with
    the weights of ``checkpoint`` when given. Returns (model, cfg).

    Every tensor of the model must be in the checkpoint; tensors the model
    lacks (such as the reference BN's ``num_batches_tracked`` beside the
    port's frozen BN) are logged and skipped."""
    cfg = Config.fromfile(config) if isinstance(config, str) else config
    get_logger()
    set_tf32(tf32_from_cfg(cfg))
    model = build_detector(cfg.model.copy())
    if checkpoint is not None:
        if not checkpoint.endswith('.pth'):
            raise ValueError(f'{checkpoint}: the port reads .pth checkpoints '
                             f'(the JAX package\'s orbax and .msgpack '
                             f'formats need JAX to read)')
        ckpt = torch.load(checkpoint, map_location='cpu', weights_only=False)
        state = ckpt.get('state_dict', ckpt)
        missing, unexpected = model.load_state_dict(state, strict=False)
        if missing:
            raise KeyError(f'{checkpoint} lacks {len(missing)} tensors of '
                           f'the model, such as {missing[:5]}')
        if unexpected:
            get_logger().warning(
                f'{checkpoint}: {len(unexpected)} tensors not in the model '
                f'skipped, such as {unexpected[:5]}')
    return model.to(device).eval(), cfg


def inference_detector(model: torch.nn.Module, cfg,
                       img: Union[str, np.ndarray]) -> InstanceData:
    """The test pipeline and ``predict`` on one image (a path or an HWC
    BGR array). Returns ``format_detection``'s bboxes (n, 5), labels (n,)
    and masks, a list of (oh, ow) uint8."""
    test_pipeline = cfg.get('test_pipeline') or cfg.data['test']['pipeline']
    results = {'bbox_fields': [], 'mask_fields': [],
               'filename': img if isinstance(img, str) else None}
    if not isinstance(img, str):
        results['img'] = img
    results = Compose(list(test_pipeline))(results)
    batch = eval_batcher(cfg)([results])
    model.eval()
    out = predict_batch(model, batch, apply_precision_policy(cfg))
    return format_detection(out, 0, batch['img_shape'][0],
                            batch['ori_shape'][0],
                            cfg.model.get('test_cfg', {}) or {})

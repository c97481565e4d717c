"""The reference's predict: the frozen detector's ``predict`` and a copy
of the port's ``format_detection`` for the MaskFormer family (the mask
logits resized to the original image, binarised at 0, each score scaled
by the mean sigmoid inside its mask, empty masks dropped, each box the
extents of its mask)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import model as M
from .frozen.ops.upsample import interpolate_bilinear


def upsample_masks(masks, img_shape, ori_shape, out_stride: int = 4):
    m = torch.as_tensor(masks).float()
    ih, iw = int(img_shape[0]), int(img_shape[1])
    full = interpolate_bilinear(m, (m.shape[-2] * out_stride,
                                    m.shape[-1] * out_stride))
    return interpolate_bilinear(full[..., :ih, :iw],
                                (int(ori_shape[0]), int(ori_shape[1])))


def mask_extents(binary: torch.Tensor) -> np.ndarray:
    """(n, H, W) bool -> (n, 4) float64 xyxy boxes, x2 and y2 one past the
    last pixel (the published ``format_results``), 0 for an empty mask."""
    out = np.zeros((binary.shape[0], 4))
    for k, m in enumerate(binary):
        ys = torch.nonzero(m.any(1)).flatten()
        xs = torch.nonzero(m.any(0)).flatten()
        if len(ys):
            out[k] = (int(xs[0]), int(ys[0]), int(xs[-1]) + 1,
                      int(ys[-1]) + 1)
    return out


def format_maskformer(out: Dict, i: int, img_shape, ori_shape) -> Dict:
    """(scores (n,), labels (n,), boxes (n, 4) float64, binary masks (n,
    oh, ow) bool on the masks' device) of image ``i`` of a MaskFormer
    ``predict`` output."""
    valid = out['valid'][i]
    labels = out['labels'][i][valid].cpu().numpy()
    scores = out['scores'][i][valid].cpu().numpy()
    full = upsample_masks(out['masks_logit'][i][valid], img_shape,
                          ori_shape)
    binary = full > 0
    pos = binary.sum(dim=(1, 2)).double()
    rescore = (torch.sigmoid(full) * binary).sum(dim=(1, 2)).double() \
        / (pos + 1e-6)
    scores = scores * rescore.cpu().numpy().astype(scores.dtype)
    nonempty = (pos > 0).cpu().numpy()
    masks = binary[torch.from_numpy(nonempty).to(binary.device)]
    return dict(scores=scores[nonempty], labels=labels[nonempty],
                boxes=mask_extents(masks), masks=masks)


def predict_one(model, batch: dict, device) -> Dict:
    with torch.no_grad():
        return model.predict(M.to_device(batch, device))

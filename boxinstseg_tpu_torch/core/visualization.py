"""Result visualization, a copy of ``boxinstseg_tpu/core/visualization.py``
(reference: mmdet/core/visualization/image.py imshow_det_bboxes): cv2
drawing of boxes, class labels, scores and blended instance masks, on the
host. cv2 is imported where it draws, so the port's other modules stay
free of it."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _palette(n: int, seed: int = 42) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.randint(60, 255, (max(n, 1), 3)).astype(np.uint8)


def imshow_det_bboxes(img: np.ndarray,
                      bboxes: np.ndarray,
                      labels: np.ndarray,
                      segms: Optional[List[np.ndarray]] = None,
                      class_names: Optional[Sequence[str]] = None,
                      score_thr: float = 0.3,
                      thickness: int = 2,
                      font_scale: float = 0.5,
                      mask_alpha: float = 0.45,
                      out_file: Optional[str] = None) -> np.ndarray:
    """Draw detections on a BGR image.

    bboxes: (n, 4) or (n, 5 incl. score) xyxy; labels: (n,);
    segms: optional list of (h, w) binary masks.
    """
    import cv2
    img = img.copy()
    if bboxes is None or len(bboxes) == 0:
        if out_file:
            cv2.imwrite(out_file, img)
        return img
    bboxes = np.asarray(bboxes)
    labels = np.asarray(labels)
    scores = bboxes[:, 4] if bboxes.shape[1] == 5 else None
    keep = np.ones(len(bboxes), bool)
    if scores is not None and score_thr > 0:
        keep = scores >= score_thr
    colors = _palette(int(labels.max()) + 1 if len(labels) else 1)

    for i in np.nonzero(keep)[0]:
        color = tuple(int(c) for c in colors[labels[i]])
        x1, y1, x2, y2 = (int(v) for v in bboxes[i, :4])
        if segms is not None and i < len(segms) and segms[i] is not None:
            m = segms[i].astype(bool)
            img[m] = (img[m] * (1 - mask_alpha)
                      + np.array(color) * mask_alpha).astype(np.uint8)
        cv2.rectangle(img, (x1, y1), (x2, y2), color, thickness)
        name = (class_names[labels[i]] if class_names is not None
                and labels[i] < len(class_names) else f'cls {labels[i]}')
        text = name if scores is None else f'{name} {scores[i]:.2f}'
        cv2.putText(img, text, (x1, max(y1 - 4, 12)),
                    cv2.FONT_HERSHEY_SIMPLEX, font_scale, color, 1,
                    cv2.LINE_AA)
    if out_file:
        cv2.imwrite(out_file, img)
    return img


def open_video_writer(path: str, fps: float, frame_shape):
    """A ``cv2.VideoWriter`` for frames of ``frame_shape`` (h, w, 3): MJPG
    for an ``.avi`` path, mp4v (the JAX demos' codec) for any other."""
    import cv2
    codec = 'MJPG' if path.lower().endswith('.avi') else 'mp4v'
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), fps,
                             (frame_shape[1], frame_shape[0]))
    if not writer.isOpened():
        raise RuntimeError(f'cannot write {codec} video to {path}')
    return writer

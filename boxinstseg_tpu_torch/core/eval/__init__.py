from .coco_eval import COCOEvaluator, evaluate_coco
from .mean_ap import average_precision, bbox_overlaps_np, eval_map, \
    tpfp_default

__all__ = ['COCOEvaluator', 'evaluate_coco', 'eval_map',
           'average_precision', 'tpfp_default', 'bbox_overlaps_np']

"""K2, ``boxinstseg::pairwise_backward(mask_logits, color_sim, bitmasks,
valid, scale, live, color_thresh, kernel_size, dilation) -> grad``, at its
live bound (``pairwise_live.py``), led by K1's live map as on the main
path.

Operations: 8 a weighted (instance, pixel) and 14 more an offset (K1's
terms, the pair probability and the two gradient terms). Bytes: the live
map, the colour gates, the valid flags and the scale read once, the
logits and the bitmasks near a weight read once, the logits' gradient
written whole (zeros where no weight is near)."""
from harness.kernels import load_file, numel, tensor_bytes

OPS_BASE, OPS_PER_OFFSET = 8, 14
_live = load_file('pairwise_live')
RECORD = _live.RECORD
inputs = _live.inputs


def cost(shapes, dtypes, live):
    logits, sim = shapes[0], shapes[1]
    if [int(v) for v in logits] != live['shape']:
        return None
    ops = live['weighted'] * (OPS_BASE + OPS_PER_OFFSET * int(sim[1]))
    read = sum(tensor_bytes(shapes[i], dtypes[i]) for i in (1, 3, 4, 5))
    return ops, read + 8 * live['near'] + 4 * numel(logits)

"""K1, ``boxinstseg::pairwise_forward(mask_logits, color_sim, bitmasks,
valid, color_thresh, kernel_size, dilation) -> (num_den, live)``, at its
live bound (``pairwise_live.py``): the work that the batch's box weights
ask for, not the dense (B, K, H, W).

Operations: 10 a weighted (instance, pixel) and 10 more an offset (the
two log-sigmoids, then per offset a pair log-prob, a logaddexp and the
weighted sum; a transcendental counts as one). Bytes: the bitmasks read
whole (the kernel must read them to find its work), the colour gates and
the valid flags read once, the logits near a weight read once; the (2,)
fp32 sums and the live map, a byte an (instance, 8x32 tile), written
once."""
from harness.kernels import load_file, tensor_bytes

OPS_BASE, OPS_PER_OFFSET = 10, 10
TILE_H, TILE_W = 8, 32
_live = load_file('pairwise_live')
RECORD = _live.RECORD
inputs = _live.inputs


def cost(shapes, dtypes, live):
    """(operations, bytes) of one call; ``live`` the counts of the
    reference's call at the same batch. None when they do not belong to
    this call's shapes."""
    logits, sim = shapes[0], shapes[1]
    if [int(v) for v in logits] != live['shape']:
        return None
    b, k, h, w = (int(v) for v in logits)
    ops = live['weighted'] * (OPS_BASE + OPS_PER_OFFSET * int(sim[1]))
    read = sum(tensor_bytes(s, d) for s, d in zip(shapes[1:4], dtypes[1:4]))
    tiles = b * k * -(-h // TILE_H) * -(-w // TILE_W)
    return ops, read + 4 * live['near'] + 2 * 4 + tiles

"""K4 / K4r, ``boxinstseg::msda_backward(value, spatial_shapes,
reference_points, offsets, attn, grad_out) -> (d_value, d_offsets,
d_attn)``.

Operations: 16 a channel a sample (the corner row-dots for the weights
and locations, and the four scattered value gradients). Bytes: each input
read once, the three gradients written once."""
from harness.kernels import numel, tensor_bytes

OPS_PER_CHANNEL_SAMPLE = 16


def cost(shapes, dtypes):
    value, offsets, attn = shapes[0], shapes[3], shapes[4]
    d = int(value[3])
    samples = numel(attn)
    ops = OPS_PER_CHANNEL_SAMPLE * samples * d
    read = sum(tensor_bytes(s, t) for s, t in
               zip(shapes[:6], dtypes[:6]) if t != 'GenericList'
               and t != 'ScalarList')
    written = 4 * (numel(value) + numel(offsets) + numel(attn))
    return ops, read + written

"""K4f, ``boxinstseg::msda_forward(value, spatial_shapes,
reference_points, offsets, attn) -> out``: value (B, S, heads, D),
offsets (B, L, heads, levels, P, 2), attn (B, L, heads, levels, P), out
(B, L, heads * D).

Operations: 8 a channel a sample (a sample is a (query, head, level,
point)): four corner weights times the channel, added. Bytes: each input
read once, out written once."""
from harness.kernels import numel, tensor_bytes

OPS_PER_CHANNEL_SAMPLE = 8


def cost(shapes, dtypes):
    value, attn = shapes[0], shapes[4]
    d = int(value[3])
    samples = numel(attn)
    ops = OPS_PER_CHANNEL_SAMPLE * samples * d
    read = sum(tensor_bytes(s, t) for s, t in
               zip(shapes[:5], dtypes[:5]) if t != 'GenericList'
               and t != 'ScalarList')
    b, l = int(attn[0]), int(attn[1])
    out = b * l * int(value[2]) * d * 4
    return ops, read + out

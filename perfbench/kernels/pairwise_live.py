"""What K1 and K2 must touch at their inputs: the live bound's counts.

The kernels skip every (instance, tile) with no box weight near it, so
their bound is not the dense one over the padded (B, K, H, W) inputs but
the work that a box weight asks for (the live bound of the repo's kernel
table):

- ``weighted``: the (instance, pixel) items that carry a box weight, a
  non-zero bitmask pixel of a valid instance: each needs its pair terms;
- ``near``: the items whose logits the formula reads, the weighted ones
  and every neighbour of one at the stencil's dilated offsets, clipped to
  the map (the gradient is non-zero only there, too).

Counted from the bitmasks and valid flags that the frozen reference
passes to its pairwise loss at the same batch (``RECORD`` of the two
kernel files): which GT boxes the sampled instances carry follows from
the FCOS targets alone, not from the weights, so the reference's call
carries the program's bitmasks up to the order of the instances."""
from __future__ import annotations

RECORD = ('reference.frozen.models.dense_heads.condinst_head',
          'boxinst_pairwise_loss')


def stencil(kernel_size: int, dilation: int):
    """The (dy, dx) offsets of the dilated stencil without its centre."""
    half = kernel_size // 2
    return [(dy * dilation, dx * dilation)
            for dy in range(-half, half + 1)
            for dx in range(-half, half + 1) if (dy, dx) != (0, 0)]


def counts(bitmasks, valid, kernel_size: int, dilation: int) -> dict:
    """``weighted`` and ``near`` (see the module docstring) of
    (B, K, H, W) bitmasks and (B, K) valid flags, and the logits'
    shape."""
    import torch
    weight = (bitmasks != 0) & valid.bool()[..., None, None]
    h, w = weight.shape[-2:]
    near = weight.clone()
    for dy, dx in stencil(kernel_size, dilation):
        # near[p] |= weight[p - o]: p is the neighbour at offset o of a
        # weighted pixel
        ys, yd = (slice(0, h - dy), slice(dy, h)) if dy >= 0 else \
            (slice(-dy, h), slice(0, h + dy))
        xs, xd = (slice(0, w - dx), slice(dx, w)) if dx >= 0 else \
            (slice(-dx, w), slice(0, w + dx))
        near[..., yd, xd] |= weight[..., ys, xs]
    return dict(shape=list(weight.shape), weighted=int(weight.sum()),
                near=int(near.sum()))


def inputs(mask_logits, color_sim, bitmasks, valid, color_thresh=0.3,
           kernel_size=3, dilation=2):
    """The counts of one call of the reference's ``boxinst_pairwise_loss``
    (its arguments as the head passes them)."""
    return counts(bitmasks, valid, int(kernel_size), int(dilation))

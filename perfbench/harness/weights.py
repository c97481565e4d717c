"""Seeded weights made on the device in a few large calls.

One ``torch.Generator`` on the device draws a single normal vector for
every parameter of a model at once; each leaf takes its slice, scaled by a
rule of its name and shape, which the configuration file states under
``init``:

- a leaf of two or more dimensions: normal x ``gain`` / sqrt(fan in), fan
  in the leaf's size over its first dimension (``gain`` 1/sqrt(3) is
  PyTorch's default convolution and linear init, kaiming uniform with
  a = sqrt(5), in its variance);
- a one-dimensional leaf whose name ends in ``weight`` or ``scale`` (a
  norm's scale, a ``Scale`` module): 1; any other (a bias): 0;
- ``overrides``: ``[regex, "const", v]`` sets the leaf to v, ``[regex,
  "std", s]`` to normal x s, the first match winning.

The same seed, names and shapes give the same tensors on the same device,
so the program and the reference are handed equal weights.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import torch


def leaf_rule(name: str, shape: Sequence[int], init: dict
              ) -> Tuple[str, float]:
    """("std", s) or ("const", v) for one leaf."""
    for pattern, kind, value in init.get('overrides', []):
        if re.search(pattern, name):
            return kind, float(value)
    if len(shape) >= 2:
        numel = 1
        for n in shape:
            numel *= int(n)
        fan_in = numel // int(shape[0])
        return 'std', float(init.get('gain', 3 ** -0.5)) / fan_in ** 0.5
    if name.endswith('weight') or name.endswith('scale'):
        return 'const', 1.0
    return 'const', 0.0


def seeded_weights(named_shapes: List[Tuple[str, Sequence[int]]], seed: int,
                   device, init: dict, dtype=torch.float32
                   ) -> Dict[str, torch.Tensor]:
    """name -> tensor on ``device`` for every (name, shape) of
    ``named_shapes``, drawn from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    sizes = []
    for _, shape in named_shapes:
        n = 1
        for d in shape:
            n *= int(d)
        sizes.append(n)
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=dtype)
    out = {}
    stds, leaves = [], []
    for (name, shape), part in zip(named_shapes, flat.split(sizes)):
        kind, value = leaf_rule(name, shape, init)
        leaf = part.view(tuple(int(d) for d in shape))
        if kind == 'const':
            leaf.fill_(value)
        else:
            leaves.append(leaf)
            stds.append(value)
        out[name] = leaf
    if leaves:
        torch._foreach_mul_(leaves, stds)
    return out


def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]
                 ) -> None:
    """Copy ``weights`` into the parameters of ``model`` of the same names;
    raise unless the two name sets are equal."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        missing = sorted(set(weights) - set(params))[:5]
        extra = sorted(set(params) - set(weights))[:5]
        raise ValueError(f'parameter names differ: missing {missing}, '
                         f'extra {extra}')
    with torch.no_grad():
        dst = [params[k] for k in weights]
        src = [weights[k] for k in weights]
        for d, s in zip(dst, src):
            if d.shape != s.shape:
                raise ValueError(f'shape of a parameter differs: '
                                 f'{tuple(d.shape)} vs {tuple(s.shape)}')
        torch._foreach_copy_(dst, src)

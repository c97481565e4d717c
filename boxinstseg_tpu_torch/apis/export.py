"""``torch.export`` of a detector's ``predict``, counterpart of the JAX
package's ``jax.export`` in ``tools/deployment/export_model.py``.

``export_predict`` traces ``predict`` at one static (batch, h, w) canvas,
with the weights baked in, into an ``ExportedProgram`` whose inputs are
(image (B, 3, H, W), img_shape (B, 2) int32, scale_factor (B, 4)) and
whose output is ``predict``'s dict. The hand-written kernels on the path
are the registered torch ops ``boxinstseg::msda_forward`` and
``boxinstseg::window_attention`` (``ops/msda.py``, ``ops/swin_attention.py``):
they stay single nodes of the graph, traced through their fake
implementations, and at run time the dispatcher picks the kernel or the
plain version by the device of the inputs. A program exported on the card
holds CUDA weights and runs there; one exported on the CPU runs there.

A config with a precision key (``fp16`` or ``bf16``) predicts under bf16
autocast in ``predict_batch``; its export raises naming the key (autocast
regions do not export as the eager policy runs them).

``ExportedDetector`` wraps a loaded program with ``predict(batch)``, so
that ``apis.test.run_evaluation`` drives it as it drives the model.
"""
from __future__ import annotations

import collections
from typing import Dict, Tuple

import torch

from ..ops import msda, swin_attention  # noqa: F401  (register the ops)
from .train import apply_precision_policy

OP_NAMESPACE = 'boxinstseg'


class PredictModule(torch.nn.Module):
    """``model.predict`` over positional tensors, the exported signature."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, image, img_shape, scale_factor):
        return self.model.predict(dict(image=image, img_shape=img_shape,
                                       scale_factor=scale_factor))


def example_inputs(batch: int, shape: Tuple[int, int], device
                   ) -> Tuple[torch.Tensor, ...]:
    """Zero image, full-canvas img_shape and unit scale factors."""
    h, w = shape
    return (torch.zeros((batch, 3, h, w), device=device),
            torch.tensor([[h, w]] * batch, dtype=torch.int32, device=device),
            torch.ones((batch, 4), device=device))


def export_predict(model: torch.nn.Module, cfg, shape: Tuple[int, int],
                   batch: int = 1) -> torch.export.ExportedProgram:
    """``torch.export.export`` of ``model.predict`` (in ``eval()``, on its
    own device) at the static canvas ``shape`` (h, w) and ``batch``, under
    ``torch.no_grad()``."""
    if apply_precision_policy(cfg):
        key = 'fp16' if cfg.get('fp16') is not None else 'bf16'
        raise NotImplementedError(
            f'the config\'s precision key {key!r} runs predict under bf16 '
            f'autocast, which the export does not trace; export with the '
            f'key removed (fp32)')
    device = next(model.parameters()).device
    model.eval()
    with torch.no_grad():
        return torch.export.export(PredictModule(model),
                                   example_inputs(batch, shape, device))


def count_ops(program: torch.export.ExportedProgram,
              namespace: str = OP_NAMESPACE) -> Dict[str, int]:
    """How many calls of each ``namespace::`` op the program's graph
    holds, by op name."""
    counts = collections.Counter()
    for node in program.graph.nodes:
        if node.op == 'call_function' and \
                getattr(node.target, 'namespace', None) == namespace:
            counts[node.target.__name__.split('.')[0]] += 1
    return dict(counts)


class ExportedDetector(torch.nn.Module):
    """A loaded program behind the detector's ``predict(batch)``; its
    parameters are the program's (baked) weights, on the device it was
    exported on. ``train``/``eval`` only set the flag: the graph is fixed
    in eval mode."""

    def __init__(self, program: torch.export.ExportedProgram):
        super().__init__()
        self.program = program.module()

    def train(self, mode: bool = True):
        self.training = mode
        return self

    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        return self.program(batch['image'], batch['img_shape'],
                            batch['scale_factor'])

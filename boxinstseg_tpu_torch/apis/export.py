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
autocast in ``predict_batch`` (``run_evaluation``, ``inference_detector``),
but its export is of predict in fp32, as the JAX package's
``tools/deployment/export_model.py`` exports it (that tool never applies
the precision policy); the log says so once an export.

``ExportedDetector`` wraps a loaded program with ``predict(batch)``, so
that ``apis.test.run_evaluation`` drives it as it drives the model.

``export_loss`` traces a detector's forward and loss (``model.loss(batch,
iteration)``, in ``train()``) at one batch into a program that takes the
batch dict and returns the loss dict. The loss path's kernels stay single
nodes there too: ``boxinstseg::pairwise_forward`` / ``pairwise_backward``
(BoxInst), ``lcm_forward``, ``solve_lsa`` and ``msda_forward`` (Box2Mask),
``crf_mean_field`` (DiscoBox), and the host MST solve ``grid_mst``.
"""
from __future__ import annotations

import collections
from typing import Dict, Tuple

import torch

from ..ops import (crf, lcm, lsa, msda, mst, pairwise,  # noqa: F401
                   swin_attention)                      # (register the ops)
from .train import apply_precision_policy, get_logger

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
    ``torch.no_grad()``, in fp32 whatever the config's precision key."""
    if apply_precision_policy(cfg):
        key = 'fp16' if cfg.get('fp16') is not None else 'bf16'
        get_logger().warning(
            f'the config\'s precision key {key!r} is not applied to the '
            f'export: predict is exported in fp32, as the JAX package '
            f'exports it (evaluation predicts under bf16 autocast)')
    device = next(model.parameters()).device
    model.eval()
    with torch.no_grad():
        return torch.export.export(PredictModule(model),
                                   example_inputs(batch, shape, device))


class LossModule(torch.nn.Module):
    """``model.loss(batch, iteration)`` over a batch dict, the exported
    signature of ``export_loss``; ``loss_kwargs`` are passed on (such as
    DiscoBox's ``gates``)."""

    def __init__(self, model: torch.nn.Module, iteration=None,
                 **loss_kwargs):
        super().__init__()
        self.model = model
        self.iteration = iteration
        self.loss_kwargs = loss_kwargs

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        return self.model.loss(batch, self.iteration, **self.loss_kwargs)


def export_loss(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
                iteration=None, **loss_kwargs) -> torch.export.ExportedProgram:
    """``torch.export.export`` (non-strict) of ``model.loss(batch,
    iteration)`` in ``train()`` at this batch's shapes (``iteration`` and
    ``loss_kwargs`` baked in). The program takes the batch dict and returns
    the loss dict; ``program.module()`` is differentiable in its
    parameters (``loss_grad_graph``) and updates BN running statistics as
    the eager step does."""
    model.train()
    return torch.export.export(LossModule(model, iteration, **loss_kwargs),
                               (batch,), strict=False)


def loss_grad_graph(program: torch.export.ExportedProgram,
                    batch: Dict[str, torch.Tensor]) -> torch.fx.GraphModule:
    """The train step's graph of an ``export_loss`` program: its forward
    and loss, then the gradients of the summed losses (every key with
    'loss') in its trainable parameters, traced at aten level
    (``make_fx``) through autograd, so the backward ops of the kernels
    (``pairwise_backward``, ``lcm_adjoint``, ``msda_backward``) are nodes.
    The graph takes the batch's tensors in its key order and returns
    [total loss, the gradients that are not None]."""
    from torch.fx.experimental.proxy_tensor import make_fx
    module = program.module()
    params = [p for p in module.parameters() if p.requires_grad]
    keys = list(batch)

    def step(*tensors):
        losses = module(dict(zip(keys, tensors)))
        total = sum(v for k, v in losses.items() if 'loss' in k)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        return [total] + [g for g in grads if g is not None]
    return make_fx(step)(*batch.values())


def count_ops(program, namespace: str = OP_NAMESPACE) -> Dict[str, int]:
    """How many calls of each ``namespace::`` op the graph of ``program``
    (an ``ExportedProgram`` or a ``GraphModule``) holds, by op name,
    including the graphs nested in it (an autocast region, as the loss's
    fp32 region, is a submodule of the exported graph)."""
    root = program.graph_module if hasattr(program, 'graph_module') \
        else program
    counts = collections.Counter()
    for module in root.modules():
        if not isinstance(module, torch.fx.GraphModule):
            continue
        for node in module.graph.nodes:
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

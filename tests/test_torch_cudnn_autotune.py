"""``utils.env.cudnn_autotune`` around the port's entry points that run
convolutions, on the CPU, with a probe model that reads the cuDNN flags
where the convolutions would run:

- inside the train steps (``make_train_step``, ``TSTrainStep``):
  benchmark mode reads on, with ``AUTOTUNE_CANDIDATES`` as its limit, in
  the forward (the teacher's too) and in a custom autograd backward, so
  the gradient convolutions are tuned as well; every other flag reads as
  before, TF32 off included (the trap of ``torch.backends.cudnn.flags()``,
  whose defaults are ``enabled=False, allow_tf32=True``);
- inside ``predict_batch``: every flag as before, so prediction keeps
  cuDNN's instant heuristic and ranks that share a card pick one
  process's engines;
- after: every flag is as before, after a call and after one that raises;
- ``cudnn.autotune_shapes`` counts a new image shape of a train step once,
  a repeat never, and a prediction never.

That the tuned engines give the heuristic's results on the card is
``tests/test_torch_cuda.py``'s ``test_cudnn_autotune_keeps_mask_branch_results``.
"""
import itertools

import numpy as np
import pytest
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu_torch.apis.test import predict_batch
from boxinstseg_tpu_torch.apis.train import batch_to_device
from boxinstseg_tpu_torch.engine.train_state import (TSTrainStep,
                                                     make_train_step)
from boxinstseg_tpu_torch.utils.env import AUTOTUNE_CANDIDATES, set_tf32
from boxinstseg_tpu_torch.utils.profiling import COUNTS

CUDNN = torch.backends.cudnn
FLAGS = ('enabled', 'benchmark', 'benchmark_limit', 'deterministic',
         'allow_tf32', 'fp32_precision')
# a fresh image width for each call that must meet a new shape
_WIDTHS = itertools.count(101)


def flags():
    """The cuDNN flags that the scope must leave alone or restore, with the
    matmul TF32 flag; ``fp32_precision`` where this PyTorch has it."""
    out = {name: getattr(CUDNN, name) for name in FLAGS
           if hasattr(CUDNN, name)}
    out['matmul.allow_tf32'] = torch.backends.cuda.matmul.allow_tf32
    return out


class _Probe(torch.autograd.Function):
    """Identity whose backward notes the flags it runs under."""

    @staticmethod
    def forward(ctx, x, seen):
        ctx.seen = seen
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.seen.append(('backward', flags()))
        return g, None


class ProbeDetector(torch.nn.Module):
    """Stands in for a detector: ``loss``, ``teacher_outputs`` and
    ``predict`` note the flags they run under in ``seen``, which the EMA
    teacher (a deep copy) shares; ``fail`` makes each raise."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))
        self.register_buffer('b', torch.zeros(()))    # for the EMA
        self.seen = []
        self.note = self.seen.append      # a deep copy keeps the same one
        self.fail = False

    def _note(self, where):
        self.note((where, flags()))
        if self.fail:
            raise RuntimeError('probe fails')

    def loss(self, batch, step, *ts_args):
        self._note('forward')
        x = _Probe.apply(self.w * batch['image'].mean(), self.seen)
        return {'loss_ins': x, 'loss': x}

    def teacher_outputs(self, image):
        self._note('teacher')

    def predict(self, inputs):
        self._note('predict')
        return {'scores': inputs['image'].mean()}


def _entry(kind):
    """(model, call(width)): one call of the entry point at an image of
    that width."""
    model = ProbeDetector()
    opt = torch.optim.SGD([dict(params=[model.w], lr_mult=1.0)], lr=0.01)
    if kind == 'predict_batch':
        def call(width):
            batch = dict(image=np.ones((1, 8, width, 3), np.float32),
                         img_shape=np.array([[8, width]], np.int32),
                         scale_factor=np.ones((1, 4), np.float32))
            return predict_batch(model, batch, False)
        return model, call
    if kind == 'make_train_step':
        step = make_train_step(model, opt, lambda i: 0.01)
    else:
        step = TSTrainStep(model, opt, lambda i: 0.01, start_iter=0)
    return model, lambda width: step(batch_to_device(
        dict(image=np.ones((2, 8, width, 3), np.float32)), 'cpu'), 1)


WHERE = {'make_train_step': ['forward', 'backward'],
         'TSTrainStep': ['teacher', 'forward', 'backward'],
         'predict_batch': ['predict']}
TUNED = {'make_train_step': True, 'TSTrainStep': True, 'predict_batch': False}


@pytest.mark.parametrize('benchmark_before', [False, True])
@pytest.mark.parametrize('kind', list(WHERE))
def test_cudnn_autotune_scope(kind, benchmark_before):
    saved = flags()
    try:
        set_tf32(False)
        CUDNN.benchmark = benchmark_before
        CUDNN.benchmark_limit = 7
        before = flags()
        model, call = _entry(kind)
        width = next(_WIDTHS)
        n0 = COUNTS['cudnn.autotune_shapes']
        tuned = int(TUNED[kind])
        call(width)
        assert flags() == before
        assert [where for where, _ in model.seen] == WHERE[kind]
        inside = dict(before, benchmark=True,
                      benchmark_limit=AUTOTUNE_CANDIDATES) if tuned else before
        for where, seen in model.seen:
            assert seen == inside, where
            assert seen['allow_tf32'] is False and \
                seen['matmul.allow_tf32'] is False
        assert COUNTS['cudnn.autotune_shapes'] == n0 + tuned
        call(width)
        assert COUNTS['cudnn.autotune_shapes'] == n0 + tuned
        model.fail = True
        with pytest.raises(RuntimeError, match='probe fails'):
            call(next(_WIDTHS))
        assert flags() == before
        assert COUNTS['cudnn.autotune_shapes'] == n0 + 2 * tuned
    finally:
        for name, value in saved.items():
            if name == 'matmul.allow_tf32':
                torch.backends.cuda.matmul.allow_tf32 = value
            else:
                setattr(CUDNN, name, value)

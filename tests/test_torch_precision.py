"""The port's precision policy against the JAX package's.

A config's ``fp16`` dict (the reference's DiscoBox recipe) or ``bf16 =
True`` turns mixed precision on in both packages: the JAX package runs its
convolutions and products in bf16 (``set_compute_dtype(jnp.bfloat16)``),
the port runs the forward under bf16 autocast; parameters, optimizer state
and the losses stay fp32 in both, the heads' outputs cast to fp32 where
the loss math begins.

- the policy turns on from ``fp16`` and from ``bf16`` and stays off
  without either, as the JAX package's ``apply_precision_policy`` decides;
- one train step of the tiny BoxInst and the tiny DiscoBox with the policy
  on gives loss dicts within 0.05 x max(|ref|, 0.2) of the JAX package's
  bf16 losses from the same weights and batch (the bound of
  ``tests/test_bf16.py``, which holds JAX's bf16 losses to its fp32 ones);
  the losses are fp32 and finite, the backbone's first convolution ran in
  bf16, and every parameter is fp32 after the step.

The parity tests of the other ``test_torch_*.py`` files run with the
policy off (fp32).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from boxinstseg_tpu.apis.train import \
    apply_precision_policy as j_apply_precision_policy
from boxinstseg_tpu.engine import init_variables
from boxinstseg_tpu.models.layers import set_compute_dtype
from boxinstseg_tpu.registry import build_detector as j_build

from boxinstseg_tpu_torch.apis.train import apply_precision_policy
from boxinstseg_tpu_torch.config import Config
from boxinstseg_tpu_torch.engine.optimizers import build_optimizer
from boxinstseg_tpu_torch.engine.train_state import (TSTrainStep,
                                                     make_train_step)
from boxinstseg_tpu_torch.registry import build_detector
from boxinstseg_tpu_torch.utils.weights import params_from_jax

OPT = dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=1e-4)


@pytest.fixture(autouse=True)
def _fp32_after():
    yield
    set_compute_dtype(None)


@pytest.mark.parametrize('keys, on', [
    ({}, False),
    ({'fp16': dict(loss_scale=512.)}, True),
    ({'bf16': True}, True),
    ({'bf16': False}, False)], ids=['none', 'fp16', 'bf16', 'bf16-false'])
def test_policy_turns_on_from_fp16_or_bf16(keys, on):
    cfg = Config.fromdict(dict(model=dict(type='CondInst'), **keys))
    assert apply_precision_policy(cfg) is on
    assert j_apply_precision_policy(cfg) is on


def boxinst_case():
    """(config, JAX variables, the JAX bf16 losses as a function, one port
    train step as a function of the port model) for the tiny BoxInst of
    ``test_torch_slice``."""
    from test_torch_slice import (make_batch, randomize_stats, tiny_cfg,
                                  torch_batch)
    cfg = tiny_cfg(pairwise_warmup=1)
    jm = j_build(cfg)
    batch = make_batch(1)
    v = init_variables(jm, {'params': jax.random.PRNGKey(0)},
                       {k: jnp.asarray(x) for k, x in batch.items()},
                       jnp.zeros((), jnp.int32), method=jm.loss)
    v = jax.tree_util.tree_map(np.asarray, v)
    v = {'params': v['params'], 'batch_stats': dict(v['batch_stats'])}
    v['batch_stats']['backbone_m'] = randomize_stats(
        v['batch_stats']['backbone_m'], np.random.RandomState(1))

    def jax_losses():
        it = jnp.asarray(50, jnp.int32)
        jb = {k: jnp.asarray(x) for k, x in batch.items()}
        return jax.jit(lambda v, b: jm.apply(
            v, b, it, method=jm.loss, mutable=['batch_stats'])[0])(v, jb)

    def port_step(tm):
        opt = build_optimizer(OPT, tm.named_parameters())
        step = make_train_step(tm, opt, lambda i: OPT['lr'], bf16=True)
        return step(torch_batch(batch), 50)
    return cfg, v, jax_losses, port_step


def discobox_case():
    """The same for the tiny DiscoBox of ``test_discobox_model`` with its
    gates shut (avg_loss_ins at its initial 2.0) and no teacher."""
    from test_discobox_model import synth_batch, tiny_cfg
    from test_torch_discobox import torch_batch
    cfg = tiny_cfg()
    jm = j_build(cfg)
    batch = synth_batch(np.random.RandomState(0))
    v = init_variables(jm, {'params': jax.random.PRNGKey(0)}, batch,
                       jnp.zeros((), jnp.int32), None, None, None,
                       method=jm.loss)
    v = jax.tree_util.tree_map(np.asarray, v)
    gates = dict(teacher=jnp.float32(0.0), ts=jnp.float32(0.0),
                 corr=jnp.float32(0.0))

    def jax_losses():
        losses = jax.jit(lambda v, b: jm.apply(
            v, b, jnp.zeros((), jnp.int32), None, gates, None,
            method=jm.loss))(v, batch)
        losses.pop('_corr_append', None)
        return losses

    def port_step(tm):
        opt = build_optimizer(OPT, tm.named_parameters())
        step = TSTrainStep(tm, opt, lambda i: OPT['lr'], start_iter=100,
                           bf16=True)
        return step(torch_batch(batch), 0)
    return cfg, v, jax_losses, port_step


@pytest.mark.parametrize('case', [boxinst_case, discobox_case],
                         ids=['boxinst', 'discobox'])
def test_bf16_train_step_losses_match_jax_bf16(case):
    cfg, v, jax_losses, port_step = case()
    set_compute_dtype(jnp.bfloat16)
    want = jax_losses()
    set_compute_dtype(None)

    tm = build_detector(cfg)
    tm.load_state_dict(params_from_jax(v['params'], v['batch_stats']),
                       strict=True)
    seen = []
    hook = tm.backbone.conv1.register_forward_hook(
        lambda mod, args, out: seen.append(out.dtype))
    logs = port_step(tm)
    hook.remove()
    assert seen and all(d == torch.bfloat16 for d in seen), seen
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    for k, ref in want.items():
        got = logs[k]
        assert got.dtype == torch.float32, k
        assert np.isfinite(got.item()), k
        ref = float(ref)
        assert abs(got.item() - ref) <= 0.05 * max(abs(ref), 0.2), \
            (k, got.item(), ref)

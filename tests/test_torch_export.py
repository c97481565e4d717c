"""``torch.export`` of the port's predict, on the CPU.

- The tiny BoxInst of ``tests/test_torch_predict.py`` and the tiny Box2Mask
  of ``tests/test_box2mask_model.py``, with the JAX package's weights
  (``params_from_jax``), are exported by ``apis.export.export_predict``,
  saved with ``torch.export.save`` and loaded with ``torch.export.load``.
  The loaded program's outputs equal the eager port's within atol 1e-6
  (the same graph of the same ops), and the JAX package's ``predict``
  within the port's per-module tolerance: BoxInst on valid slots as
  ``tests/test_torch_predict.py`` compares (labels and validity exactly,
  boxes and scores atol 1e-5 / rtol 1e-4, masks atol 1e-5); Box2Mask
  scores and labels likewise, its mask logits atol 1e-5 x max(1, max
  |ref|) + rtol 1e-4.
- The Box2Mask graph holds one ``boxinstseg::msda_forward`` a pixel-decoder
  encoder layer; a tiny Swin Box2Mask's also one
  ``boxinstseg::window_attention`` a Swin block, and its program equals
  eager within atol 1e-6.
- A precision key is not applied to the export, and the log names it
  once. A tiny DiscoBox exported under the shipped configs' ``fp16`` key
  gives the program exported with the key removed (fp32, atol 1e-6) and
  the JAX package's fp32 predict (valid slots as above), as the JAX
  ``tools/deployment/export_model.py`` exports such a config.
- The forward and loss of a tiny BoxInst, Box2Mask and DiscoBox (CRF gate
  open), with the JAX package's weights, are exported by
  ``apis.export.export_loss``: the graph holds the loss path's kernels as
  ``boxinstseg`` ops (BoxInst one ``pairwise_forward``; Box2Mask one
  ``lcm_forward``, one ``solve_lsa`` and one ``msda_forward`` an encoder
  layer, with the host ``grid_mst``; DiscoBox one ``crf_mean_field``), and
  the train step's graph of the program (``loss_grad_graph``) holds their
  backward ops too (one ``pairwise_backward``, one ``lcm_adjoint``, one
  ``msda_backward`` a layer). The program's loss dict equals eager within
  rtol 1e-5 and the JAX package's within atol 1e-5 / rtol 1e-4.
- ``tools/deployment/export_model_torch.py`` exports the evaluation set's
  checkpoint (``tests/test_torch_eval.py``), and
  ``tools/deployment/test_torch.py`` gives on 2 of its images exactly the
  metrics of ``run_evaluation`` with the eager model.
"""
import logging
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.engine import init_variables
from boxinstseg_tpu.registry import build_detector as j_build
from test_box2mask_model import synth_batch as b2m_batch
from test_box2mask_model import tiny_cfg as tiny_b2m_cfg
from test_discobox_model import synth_batch as disco_batch
from test_discobox_model import tiny_cfg as tiny_disco_cfg
from test_torch_eval import CANVASES, eval_set  # noqa: F401  (fixture)
from test_torch_predict import compare_valid, tiny_discobox
from test_torch_slice import make_batch, randomize_stats, tiny_cfg
from test_torch_slice import pair as boxinst_pair  # noqa: F401  (fixture)
from test_torch_slice import torch_batch
from test_torch_swin import swin_box2mask_cfg
from test_torch_tools import load_tool

from boxinstseg_tpu_torch.apis import export as tex
from boxinstseg_tpu_torch.apis.test import run_evaluation
from boxinstseg_tpu_torch.config import Config
from boxinstseg_tpu_torch.registry import build_dataset, build_detector
from boxinstseg_tpu_torch.utils.weights import params_from_jax

EAGER_ATOL = 1e-6
RTOL, ATOL = 1e-4, 1e-5


def round_trip(model, cfg, shape, batch, tmp_path, name):
    """Export, save, load: (the loaded program as a detector, op counts)."""
    program = tex.export_predict(model, Config(dict(model=cfg)), shape,
                                 batch)
    path = str(tmp_path / f'{name}.pt2')
    torch.export.save(program, path)
    loaded = torch.export.load(path)
    assert tex.count_ops(loaded) == tex.count_ops(program)
    return tex.ExportedDetector(loaded), tex.count_ops(program)


def assert_equal_eager(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], atol=EAGER_ATOL, rtol=0,
                                   msg=k)


def test_boxinst_program_matches_eager_and_jax(tmp_path):
    cfg = tiny_cfg(1)
    cfg['test_cfg'] = dict(nms_pre=200, score_thr=0.003,
                           nms=dict(type='nms', iou_threshold=0.5),
                           max_per_img=20, pre_nms_limit=300)
    jm = j_build(cfg)
    batch = make_batch(0)
    v = init_variables(jm, {'params': jax.random.PRNGKey(0)},
                       {k: jnp.asarray(x) for k, x in batch.items()},
                       jnp.zeros((), jnp.int32), method=jm.loss)
    v = jax.tree_util.tree_map(np.asarray, v)
    reg = v['params']['bbox_head_m']['conv_reg']
    reg['kernel'] = reg['kernel'] * 30
    reg['bias'] = reg['bias'] + 1.5
    v = {'params': v['params'], 'batch_stats': randomize_stats(
        dict(v['batch_stats']), np.random.RandomState(1))}
    tm = build_detector(cfg)
    tm.load_state_dict(params_from_jax(v['params'], v['batch_stats']),
                       strict=True)
    tm.eval()
    b, h, w, _ = batch['image'].shape
    program, ops = round_trip(tm, cfg, (h, w), b, tmp_path, 'boxinst')
    assert ops == {}
    pb = dict(image=batch['image'],
              img_shape=np.array([[120, 150], [100, 160]], np.int32),
              scale_factor=np.array([[2.0] * 4, [1.5] * 4], np.float32))
    tb = {k: torch.from_numpy(x) for k, x in pb.items()}
    tb['image'] = tb['image'].permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        got = program.predict(tb)
        eager = tm.predict(tb)
    assert_equal_eager(got, eager)
    want = jax.device_get(jax.jit(lambda v, b: jm.apply(
        v, b, method=jm.predict))(v, pb))
    compare_valid({k: x.numpy() for k, x in got.items()}, want,
                  ('bboxes', 'scores', 'masks'))


@pytest.fixture(scope='module')
def box2mask_pair():
    jm = j_build(tiny_b2m_cfg())
    batch = {k: np.asarray(x) for k, x in b2m_batch(
        np.random.RandomState(0)).items()}
    v = init_variables(jm, {'params': jax.random.PRNGKey(0)},
                       {k: jnp.asarray(x) for k, x in batch.items()},
                       jnp.zeros((), jnp.int32), method=jm.loss)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    tm = build_detector(tiny_b2m_cfg())
    tm.load_state_dict(params_from_jax(v['params'], v.get('batch_stats')),
                       strict=True)
    return jm, v, tm.eval(), batch['image']


def test_box2mask_program_matches_eager_and_jax(box2mask_pair, tmp_path):
    jm, v, tm, image = box2mask_pair
    b, h, w, _ = image.shape
    program, ops = round_trip(tm, tiny_b2m_cfg(), (h, w), b, tmp_path,
                              'box2mask')
    encoder_layers = tiny_b2m_cfg()['panoptic_head']['pixel_decoder'][
        'num_encoder_layers']
    assert ops == {'msda_forward': encoder_layers}
    x = torch.from_numpy(np.array(image)).permute(0, 3, 1, 2).contiguous()
    tb = dict(image=x, img_shape=torch.tensor([[h, w]] * b,
                                              dtype=torch.int32),
              scale_factor=torch.ones((b, 4)))
    with torch.inference_mode():
        got = program.predict(tb)
        eager = tm.predict(tb)
    assert_equal_eager(got, eager)
    want = jax.device_get(jax.jit(lambda vv, im: jm.apply(
        vv, {'image': im}, method=jm.predict))(v, jnp.asarray(image)))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got['labels'].numpy(), want['labels'])
    np.testing.assert_array_equal(got['valid'].numpy(), want['valid'])
    np.testing.assert_allclose(got['scores'].numpy(), want['scores'],
                               atol=ATOL, rtol=RTOL)
    ref = np.asarray(want['masks_logit'])
    np.testing.assert_allclose(got['masks_logit'].numpy(), ref,
                               atol=ATOL * max(1.0, np.abs(ref).max()),
                               rtol=RTOL)


def test_swin_program_holds_the_window_attention_ops(tmp_path):
    torch.manual_seed(0)
    cfg = swin_box2mask_cfg()
    tm = build_detector(cfg).eval()
    program, ops = round_trip(tm, cfg, (128, 128), 1, tmp_path, 'swin')
    blocks = sum(cfg['backbone']['depths'])
    assert ops == {'window_attention': blocks, 'msda_forward': cfg[
        'panoptic_head']['pixel_decoder']['num_encoder_layers']}
    x = torch.from_numpy(np.random.RandomState(2).randn(
        1, 3, 128, 128).astype(np.float32))
    tb = dict(image=x, img_shape=torch.tensor([[128, 128]],
                                              dtype=torch.int32),
              scale_factor=torch.ones((1, 4)))
    with torch.inference_mode():
        got = program.predict(tb)
        eager = tm.predict(tb)
    assert_equal_eager(got, eager)
    # the export left the eager model's cached shift regions real tensors
    assert type(eager['masks_logit']) is torch.Tensor


def test_precision_key_raises_naming_it(caplog):
    """The key no longer stops the export: it is exported in fp32, and one
    warning names the key."""
    torch.manual_seed(0)
    tm = build_detector(tiny_cfg(1))
    with caplog.at_level(logging.INFO, logger='boxinstseg_tpu_torch'):
        program = tex.export_predict(tm, Config(dict(
            model=tiny_cfg(1), fp16=dict(loss_scale=512.0))), (128, 160), 1)
    said = [r.getMessage() for r in caplog.records
            if r.levelno >= logging.WARNING]
    assert len(said) == 1 and "'fp16'" in said[0] and 'fp32' in said[0]
    assert isinstance(program, torch.export.ExportedProgram)


def test_discobox_exports_under_its_precision_key_in_fp32(tmp_path):
    jm, v, tm, image = tiny_discobox()
    b, h, w, _ = image.shape
    programs = {}
    for name, keys in (('fp16', dict(fp16=dict(loss_scale=512.0))),
                       ('fp32', {})):
        program = tex.export_predict(tm, Config(keys), (h, w), b)
        path = str(tmp_path / f'discobox_{name}.pt2')
        torch.export.save(program, path)
        programs[name] = tex.ExportedDetector(torch.export.load(path))
    x = torch.from_numpy(np.array(image)).permute(0, 3, 1, 2).contiguous()
    tb = dict(image=x, img_shape=torch.tensor([[h, w]] * b,
                                              dtype=torch.int32),
              scale_factor=torch.ones((b, 4)))
    with torch.inference_mode():
        got = programs['fp16'].predict(tb)
        assert_equal_eager(got, programs['fp32'].predict(tb))
        assert_equal_eager(got, tm.predict(tb))
    assert got['masks'].dtype == torch.float32
    want = jax.device_get(jax.jit(lambda vv, im: jm.apply(
        vv, {'image': im}, method=jm.predict))(v, image))
    compare_valid({k: t.numpy() for k, t in got.items()}, want,
                  ('scores', 'masks'))


def test_deployment_test_tool_gives_run_evaluations_metrics(
        eval_set, tmp_path):  # noqa: F811
    tm, _, _, cd = eval_set
    ckpt = str(tmp_path / 'model.pth')
    torch.save({'state_dict': tm.state_dict()}, ckpt)
    cfg_file = tmp_path / 'cfg.py'
    cfg_file.write_text('\n'.join(f'{k} = {v!r}' for k, v in cd.items()))
    pt2 = str(tmp_path / 'model.pt2')
    h, w = CANVASES[0]
    batch = cd['data']['samples_per_gpu']
    exported = load_tool('tools/deployment/export_model_torch.py').main([
        str(cfg_file), ckpt, '--output-file', pt2, '--shape', str(h),
        str(w), '--batch', str(batch), '--device', 'cpu'])
    assert os.path.getsize(pt2) == exported['bytes'] > 0
    got = load_tool('tools/deployment/test_torch.py').main([
        str(cfg_file), pt2, '--shape', str(h), str(w), '--batch',
        str(batch), '--eval', 'bbox', 'segm', '--max-images', '2',
        '--device', 'cpu'])
    cfg = Config.fromdict(cd)
    want = run_evaluation(tm, build_dataset({**cfg.data['test'],
                                             'test_mode': True}), cfg,
                          metrics=['bbox', 'segm'], max_images=2)
    assert got == want
    assert want['bbox_mAP'] > 0.3


LOSS_RTOL = 1e-5


def disco_gates():
    """The JAX and the port's gates with the CRF and correspondence terms
    open and no teacher (the detached student stands for it)."""
    return (dict(teacher=jnp.float32(0.0), ts=jnp.float32(1.0),
                 corr=jnp.float32(1.0)),
            dict(ts=torch.tensor(1.0), corr=torch.tensor(1.0)))


def loss_case(name, boxinst_pair, box2mask_pair):  # noqa: F811
    """(port model, its batch, iteration, loss kwargs, the JAX loss dict,
    the ops expected in the program and in its train step's graph)."""
    if name == 'boxinst':
        jm, v, tm = boxinst_pair
        batch = make_batch(1)
        want, _ = jax.jit(lambda vv, b: jm.apply(
            vv, b, jnp.asarray(50, jnp.int32), method=jm.loss,
            mutable=['batch_stats']))(v, {k: jnp.asarray(x)
                                          for k, x in batch.items()})
        ops = {'pairwise_forward': 1}
        return (tm, torch_batch(batch), 50, {}, want, ops,
                dict(ops, pairwise_backward=1))
    if name == 'box2mask':
        jm, v, tm, _ = box2mask_pair
        batch = {k: np.asarray(x) for k, x in b2m_batch(
            np.random.RandomState(1)).items()}
        want = jax.jit(lambda vv, b: jm.apply(
            vv, b, jnp.zeros((), jnp.int32), method=jm.loss))(
            v, {k: jnp.asarray(x) for k, x in batch.items()})
        layers = tiny_b2m_cfg()['panoptic_head']['pixel_decoder'][
            'num_encoder_layers']
        ops = {'msda_forward': layers, 'lcm_forward': 1, 'solve_lsa': 1,
               'grid_mst': 1}
        return (tm, torch_batch(batch), 0, {}, want, ops,
                dict(ops, msda_backward=layers, lcm_adjoint=1))
    cfg = tiny_disco_cfg()
    jm = j_build(cfg)
    batch = disco_batch(np.random.RandomState(0))
    jg, tg = disco_gates()
    v = init_variables(jm, {'params': jax.random.PRNGKey(0)}, batch,
                       jnp.zeros((), jnp.int32), None, None, None,
                       method=jm.loss)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    want = jax.jit(lambda vv, b: jm.apply(
        vv, b, jnp.zeros((), jnp.int32), None, jg, None, method=jm.loss,
        mutable=['batch_stats'])[0])(v, batch)
    tm = build_detector(cfg)
    tm.load_state_dict(params_from_jax(v['params'], v.get('batch_stats')),
                       strict=True)
    ops = {'crf_mean_field': 1}
    tb = {k: torch.from_numpy(np.array(x)) for k, x in batch.items()}
    tb['image'] = tb['image'].permute(0, 3, 1, 2).contiguous()
    return tm.train(), tb, 0, dict(gates=tg), want, ops, ops


@pytest.mark.parametrize('name', ['boxinst', 'box2mask', 'discobox'])
def test_loss_program_holds_the_kernels_and_matches_eager_and_jax(
        name, boxinst_pair, box2mask_pair):  # noqa: F811
    tm, tb, iteration, kwargs, want, ops, step_ops = loss_case(
        name, boxinst_pair, box2mask_pair)
    state = {k: x.clone() for k, x in tm.state_dict().items()}
    mode = tm.training
    program = tex.export_loss(tm, tb, iteration, **kwargs)
    assert tex.count_ops(program) == ops
    assert tex.count_ops(tex.loss_grad_graph(program, tb)) == step_ops
    tm.load_state_dict(state)
    with torch.no_grad():
        got = program.module()(tb)
        tm.load_state_dict(state)
        eager = tm.loss(tb, iteration, **kwargs)
    tm.load_state_dict(state)
    tm.train(mode)
    assert set(got) == set(eager) == set(want)
    for k in want:
        assert got[k].item() == pytest.approx(eager[k].item(),
                                              rel=LOSS_RTOL), k
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    if name == 'discobox':
        assert float(want['loss_ts']) > 0
    else:
        assert all(float(want[k]) > 0 for k in want)

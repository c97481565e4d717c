"""The port's launchers and the TF32 switch of its entry points, on the CPU.

- ``tools/dist_train_torch.sh`` (torchrun) with 2 gloo ranks at batch 1
  (``--device cpu``) trains the tiny BoxInst of ``tests/test_torch_ddp.py``
  2 steps on 4 JPEGs as one process at batch 2 does: every step's logs
  (rank 0's, the mean over ranks, read at full precision through a
  stand-in ``wandb`` module that the ``WandbLoggerHook`` writes to) within
  rtol 1e-5, every tensor of the two checkpoints within atol 1e-5 / rtol
  1e-4;
- ``tools/dist_test_torch.sh`` with 2 gloo ranks gives the metrics of one
  process (``tools/test_torch.py``) on that checkpoint;
- ``--launcher slurm`` maps ``SLURM_PROCID``, ``SLURM_NTASKS`` and
  ``SLURM_LOCALID`` onto ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` and
  joins the group from them; a missing one, or ``MASTER_ADDR``, raises
  naming it (this host has no ``srun``: the environment is faked);
- ``tools/slurm_{train,test}_torch.sh`` under stand-in ``srun``,
  ``scontrol`` and ``python`` commands: the tasks a card, the cards a node,
  ``MASTER_ADDR`` from the job's first node, ``MASTER_PORT`` from
  ``PORT``, ``--launcher slurm`` and the arguments passed on;
- ``bash -n`` passes on the four scripts;
- ``train_detector``, ``run_evaluation`` and ``init_detector`` leave both
  TF32 flags as the config's ``tf32`` key says, off without it.

The multi-process runs have a time limit of their own (``RUN_LIMIT``).
"""
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu_torch.apis.inference import init_detector
from boxinstseg_tpu_torch.apis.test import run_evaluation
from boxinstseg_tpu_torch.apis.train import train_detector
from boxinstseg_tpu_torch.config import Config
from boxinstseg_tpu_torch.registry import build_dataset, build_detector
from test_torch_ddp_eval import cfg_dict, load_tool, write_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ('dist_train_torch.sh', 'dist_test_torch.sh',
           'slurm_train_torch.sh', 'slurm_test_torch.sh')
RUN_LIMIT = 240          # seconds a launcher run may take
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4

# a stand-in for wandb: each ``log`` call a JSON line in init's ``dir``
FAKE_WANDB = '''
import json, os
_path = None
def init(dir, **kwargs):
    global _path
    _path = os.path.join(dir, 'wandb.jsonl')
def log(values, step=None):
    with open(_path, 'a') as f:
        f.write(json.dumps(dict(values, step=step)) + '\\n')
'''


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def bin_dir(root, **commands):
    """A directory of executable stand-ins (name -> bash body), with
    ``python`` this interpreter unless given."""
    path = os.path.join(root, 'bin')
    os.makedirs(path, exist_ok=True)
    commands.setdefault('python', f'exec {sys.executable} "$@"')
    for name, body in commands.items():
        with open(os.path.join(path, name), 'w') as f:
            f.write(f'#!/bin/bash\n{body}\n')
        os.chmod(os.path.join(path, name), 0o755)
    return path


def script_env(root, **extra):
    env = dict(test_torch_threads.TEST_ENV, **extra)
    env['PATH'] = bin_dir(root) + os.pathsep + env['PATH']
    env['PYTHONPATH'] = os.pathsep.join([os.path.join(root, 'fake')] + [
        p for p in [env.get('PYTHONPATH')] if p])
    env['PORT'] = str(free_port())
    return env


def run_script(name, args, env):
    out = subprocess.run(['bash', os.path.join(ROOT, 'tools', name), *args],
                         capture_output=True, text=True, env=env,
                         timeout=RUN_LIMIT, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return out


def write_cfg(path, cfg):
    with open(path, 'w') as f:
        f.write('\n'.join(f'{k} = {v!r}' for k, v in cfg.items()))
    return str(path)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The tiny BoxInst trained 2 steps on 4 JPEGs of one size, without
    flips, by one process at batch 2 (in this process) and by
    ``dist_train_torch.sh`` in 2 gloo ranks at batch 1."""
    root = tmp_path_factory.mktemp('launchers')
    os.makedirs(root / 'fake')
    (root / 'fake' / 'wandb.py').write_text(FAKE_WANDB)
    ann_file, img_dir = write_dataset(str(root), 4, sizes=((64, 96),))
    cfg = cfg_dict(ann_file, img_dir)
    cfg['data']['train']['pipeline'] = [
        dict(step, flip_ratio=0.0) if step['type'] == 'RandomFlip'
        else dict(step, img_scale=[(96, 64)]) if step['type'] == 'Resize'
        else step for step in cfg['data']['train']['pipeline']]
    cfg['log_config']['hooks'].append(dict(
        type='WandbLoggerHook', interval=1,
        init_kwargs=dict(dir=str(root / 'ranks'))))
    one = dict(cfg, data=dict(cfg['data'], samples_per_gpu=2))
    one['log_config'] = dict(interval=1, hooks=[dict(type='TextLoggerHook')])
    tool = load_tool('train_torch')
    result = tool.main([write_cfg(root / 'one.py', one), '--work-dir',
                        str(root / 'one'), '--device', 'cpu',
                        '--no-validate'])
    env = script_env(str(root))
    run_script('dist_train_torch.sh', [
        write_cfg(root / 'ranks.py', cfg), '2', '--work-dir',
        str(root / 'ranks'), '--device', 'cpu', '--no-validate'], env)
    with open(root / 'ranks' / 'wandb.jsonl') as f:
        logged = [json.loads(line) for line in f]
    return dict(root=root, one=result, logged=logged, env=env,
                cfg=str(root / 'one.py'))


def test_dist_train_two_gloo_ranks_equal_one_process(runs):
    root, one = runs['root'], runs['one']
    assert sorted(os.listdir(root / 'ranks')) == [
        'iter_2.pth', 'train.log', 'wandb.jsonl']
    assert 'rank 0 of 2, global batch 2' in (
        root / 'ranks' / 'train.log').read_text()
    assert [r['step'] for r in runs['logged']] == [1, 2]
    assert len(one.history) == 2
    for got, want in zip(runs['logged'], one.history):
        for k, v in want.items():
            if k.startswith('loss') or k in ('grad_norm', 'lr'):
                assert got[k] == pytest.approx(v, rel=LOSS_RTOL), k
    assert one.history[-1]['loss_pairwise'] > 0      # past its warmup
    load = lambda p: torch.load(p, map_location='cpu',  # noqa: E731
                                weights_only=False)['state_dict']
    got, want = load(root / 'ranks' / 'iter_2.pth'), load(one.checkpoint)
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, msg=k)
    # the seed's weights, which both runs start from: the steps moved them
    initial = load_tool('train_torch').build_model(
        Config.fromfile(runs['cfg']), 0).state_dict()
    moved = sum(not torch.equal(v, initial[k])
                for k, v in want.items() if v.is_floating_point())
    assert moved > 10


def test_dist_test_two_gloo_ranks_give_the_one_process_metrics(runs):
    root = runs['root']
    ckpt = runs['one'].checkpoint
    out = str(root / 'metrics_ranks.json')
    run_script('dist_test_torch.sh', [
        runs['cfg'], ckpt, '2', '--device', 'cpu', '--out', out,
        '--cfg-options', 'data.samples_per_gpu=1'], runs['env'])
    with open(out) as f:
        got = json.load(f)
    want = load_tool('test_torch').main([
        runs['cfg'], ckpt, '--device', 'cpu', '--cfg-options',
        'data.samples_per_gpu=1'])
    assert got == want
    assert set(want) >= {'bbox_mAP', 'segm_mAP'}


@pytest.mark.parametrize('script', SCRIPTS)
def test_bash_parses_the_launcher(script):
    out = subprocess.run(['bash', '-n', os.path.join(ROOT, 'tools', script)],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


SLURM = dict(SLURM_PROCID='5', SLURM_NTASKS='16', SLURM_LOCALID='1',
             MASTER_ADDR='node-3', MASTER_PORT='29511')


def test_slurm_environment_maps_onto_the_torchrun_names():
    tool = load_tool('train_torch')
    env = dict(SLURM)
    assert tool.slurm_environment(env) is env
    assert (env['RANK'], env['WORLD_SIZE'], env['LOCAL_RANK']) == (
        '5', '16', '1')
    assert env['MASTER_PORT'] == '29511'


@pytest.mark.parametrize('missing', ['SLURM_PROCID', 'SLURM_NTASKS',
                                     'SLURM_LOCALID', 'MASTER_ADDR'])
def test_slurm_launch_without_a_variable_raises_naming_it(missing,
                                                          monkeypatch):
    tool = load_tool('train_torch')
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', *SLURM):
        monkeypatch.delenv(k, raising=False)
    for k, v in SLURM.items():
        if k != missing:
            monkeypatch.setenv(k, v)
    args = tool.parse_args(['cfg.py', '--launcher', 'slurm', '--device',
                            'cpu'])
    with pytest.raises(SystemExit, match=missing):
        tool.launch(args)


def test_slurm_launch_joins_the_group_from_the_slurm_environment(
        monkeypatch):
    from boxinstseg_tpu_torch.parallel import dist as pdist
    tool = load_tool('train_torch')
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK'):
        monkeypatch.delenv(k, raising=False)
    for k, v in SLURM.items():
        monkeypatch.setenv(k, v)
    joined = []

    def init_distributed(backend=None, **kwargs):
        joined.append((backend, os.environ['RANK'],
                       os.environ['WORLD_SIZE'], os.environ['LOCAL_RANK'],
                       os.environ['MASTER_ADDR'], os.environ['MASTER_PORT']))
        return True
    monkeypatch.setattr(pdist, 'init_distributed', init_distributed)
    args = tool.parse_args(['cfg.py', '--launcher', 'slurm', '--device',
                            'cpu'])
    assert tool.launch(args) == torch.device('cpu')
    assert joined == [('gloo', '5', '16', '1', 'node-3', '29511')]


@pytest.mark.parametrize('script', ['slurm_train_torch.sh',
                                    'slurm_test_torch.sh'])
def test_slurm_script_starts_a_task_a_card(script, tmp_path):
    """Stand-ins: ``srun`` records its options and runs the task's command
    as task 0 of a two-node job, ``scontrol`` expands the node list, and
    ``python`` records its arguments and environment."""
    record = tmp_path / 'record'
    path = bin_dir(
        str(tmp_path),
        srun=f'''printf '%s\\n' "$@" > {record}.srun
while [[ $1 == -* ]]; do [[ $1 == -p ]] && shift; shift; done
SLURM_PROCID=0 SLURM_NTASKS=16 SLURM_LOCALID=0 \\
SLURM_JOB_NODELIST='gpu-[3-4]' exec "$@"''',
        scontrol='[[ "$1 $2" == "show hostnames" ]] && printf '
                 '"gpu-3\\ngpu-4\\n"',
        python=f'''printf '%s\\n' "$@" > {record}.python
echo "$MASTER_ADDR $MASTER_PORT $SLURM_PROCID" >> {record}.python''')
    env = dict(os.environ, PATH=path + os.pathsep + os.environ['PATH'],
               GPUS='16', GPUS_PER_NODE='8', PORT='29611')
    args = ['part', 'job', 'cfg.py'] + (
        ['ckpt.pth'] if 'test' in script else []) + ['--seed', '3']
    out = subprocess.run(['bash', os.path.join(ROOT, 'tools', script),
                          *args], capture_output=True, text=True, env=env,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    srun = (tmp_path / 'record.srun').read_text().split('\n')
    assert srun[:7] == ['-p', 'part', '--job-name=job', '--ntasks=16',
                        '--ntasks-per-node=8', '--gres=gpu:8',
                        '--kill-on-bad-exit=1']
    python = (tmp_path / 'record.python').read_text().split('\n')
    tool = 'train_torch.py' if 'train' in script else 'test_torch.py'
    assert python[0] == os.path.join(ROOT, 'tools', tool)
    assert python[1:-2] == args[2:-2] + ['--launcher', 'slurm', '--seed',
                                         '3']
    assert python[-2] == 'gpu-3 29611 0'


def restore_tf32(fn):
    """Run ``fn`` with both flags set True first; return the flags after,
    and put back the ones found."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        fn()
        return (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize('tf32', [None, False, True],
                         ids=['no-key', 'False', 'True'])
@pytest.mark.parametrize('entry', ['train_detector', 'run_evaluation',
                                   'init_detector'])
def test_entry_points_set_both_tf32_flags_from_the_config(entry, tf32,
                                                          runs, tmp_path):
    cfg = Config.fromfile(runs['cfg'])
    if tf32 is not None:
        cfg.merge_from_dict({'tf32': str(tf32)})
    cfg.work_dir = str(tmp_path)
    if entry == 'train_detector':
        cfg.runner['max_iters'] = 1
        fn = lambda: train_detector(  # noqa: E731
            build_detector(cfg.model), build_dataset(cfg.data['train']),
            cfg, device='cpu')
    elif entry == 'run_evaluation':
        model, _ = init_detector(Config.fromfile(runs['cfg']),
                                 runs['one'].checkpoint, device='cpu')
        fn = lambda: run_evaluation(  # noqa: E731
            model, build_dataset({**cfg.data['test'], 'test_mode': True}),
            cfg, metrics=['bbox'], max_images=1)
    else:
        fn = lambda: init_detector(cfg, device='cpu')  # noqa: E731
    assert restore_tf32(fn) == (bool(tf32),) * 2


def test_tf32_key_refuses_what_is_not_a_bool():
    from boxinstseg_tpu_torch.utils.env import tf32_from_cfg
    assert tf32_from_cfg(Config.fromdict({})) is False
    with pytest.raises(ValueError, match='tf32'):
        tf32_from_cfg(Config.fromdict(dict(tf32='yes')))
    assert tf32_from_cfg(Config.fromdict(dict(tf32=True))) is True

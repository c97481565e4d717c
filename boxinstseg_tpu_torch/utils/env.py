"""Environment collection, counterpart of ``boxinstseg_tpu/utils/env.py``
(reference: mmdet/utils/collect_env.py): the Python, torch, CUDA, cuDNN
and ``nvcc`` versions and the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them. Without a card the card's entries say so; nothing raises.

``set_tf32`` is the one place that sets the TF32 flags: every entry point
calls it with the config's ``tf32`` key (``tf32_from_cfg``, off by
default, as every parity test and every timed step ran).

``cudnn_autotune`` is the one place that picks how cuDNN chooses its
convolution algorithms: the train steps run inside it. Prediction keeps
cuDNN's instant heuristic, whose pick depends on the shape and the free
memory alone, so that ranks sharing a card pick the engines of one process
and evaluation across ranks gives one process's results bit for bit.
"""
from __future__ import annotations

import contextlib
import logging
import os
import platform
import shutil
import subprocess
import sys
from typing import Dict

import torch

from .profiling import count

NO_CARD = 'no card'

_TF32_LOGGED = False
# the (image shape, bf16) pairs that cudnn_autotune has met in this process
_AUTOTUNED = set()
# cudnn_autotune times at most this many candidate engines a convolution
# key, in the heuristic's order (PyTorch's default, 10, times slow FFT
# candidates of the large maps for seconds). BoxInst R-50 train on an H100
# (700 W), a process each: its two canvases' first steps took 10.8 s under
# the heuristic alone, 26.1 s timing up to 10 candidates, 11.6 s up to 4,
# 12.1 s up to 2; a step then 525, 137, 144 and 150 ms (455 ms up to 1:
# the heuristic's own pick). Box2Mask R-50 train: set-up 23.8-24.1 s and
# 6.08-6.32 images/s up to 4, 30.8-32.9 s and 6.57-6.68 up to 10.
AUTOTUNE_CANDIDATES = 4


def set_tf32(enabled: bool) -> None:
    """Set both TF32 flags, ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``, to ``enabled``, and log both flags
    on the package's logger the first time a process calls this with that
    logger at INFO (``apis.train.get_logger`` sets it so)."""
    global _TF32_LOGGED
    torch.backends.cuda.matmul.allow_tf32 = bool(enabled)
    torch.backends.cudnn.allow_tf32 = bool(enabled)
    logger = logging.getLogger('boxinstseg_tpu_torch')
    if not _TF32_LOGGED and logger.isEnabledFor(logging.INFO):
        _TF32_LOGGED = True
        logger.info(
            f'TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn '
            f'{torch.backends.cudnn.allow_tf32}')


@contextlib.contextmanager
def cudnn_autotune(image: torch.Tensor, bf16: bool):
    """Run the block's cuDNN convolutions, forward and backward, under
    cuDNN's benchmark mode: the first call of each convolution key times
    the candidate engines and keeps the fastest, where the instant
    heuristic's first pick ran the fp32 3x3 convolutions of the CondInst
    mask branch as FFT tiles at several times the cost. The candidates are
    the heuristic's first ``AUTOTUNE_CANDIDATES``. Only
    ``torch.backends.cudnn.benchmark`` and ``benchmark_limit`` change, and
    they come back on exit, also on an exception: ``enabled``,
    ``deterministic``, ``allow_tf32`` and ``fp32_precision`` are left as
    they are (TF32 stays as ``set_tf32`` set it, since cuDNN's candidates
    are filtered by those flags), and code outside keeps the heuristic for
    a key it meets first.
    PyTorch caches a plan by the convolution's key but not by this flag,
    so an unscoped call of a key tuned here reuses the tuned plan.

    ``image`` is the step's image batch and ``bf16`` whether autocast is
    on: the first block of such a pair in the process counts
    ``cudnn.autotune_shapes``. That counts the blocks where tuning can run
    (the port's canvases fix each convolution's shape), not cuDNN's own
    timing. Off a CUDA device the flag changes nothing."""
    signature = tuple(image.shape), bool(bf16)
    if signature not in _AUTOTUNED:
        _AUTOTUNED.add(signature)
        count('cudnn.autotune_shapes')
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.benchmark_limit
    cudnn.benchmark, cudnn.benchmark_limit = True, AUTOTUNE_CANDIDATES
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.benchmark_limit = saved


def tf32_from_cfg(cfg) -> bool:
    """The config's ``tf32`` key (``--cfg-options tf32=True``); False when
    the config has none. Anything but a bool raises."""
    value = cfg.get('tf32', False)
    if not isinstance(value, bool):
        raise ValueError(f'tf32={value!r}: the key takes True or False')
    return value


def _run(cmd) -> str:
    """The command's standard output, stripped, or why there is none."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f'unavailable ({e})'
    if out.returncode != 0:
        return f'unavailable (exit {out.returncode})'
    return out.stdout.strip()


def _nvcc_version() -> str:
    nvcc = shutil.which('nvcc') or ('/usr/local/cuda/bin/nvcc' if
                                    os.path.exists('/usr/local/cuda/bin/nvcc')
                                    else None)
    if nvcc is None:
        return 'not found'
    lines = _run([nvcc, '--version']).splitlines()
    return lines[-1] if lines else 'unavailable'


def collect_env() -> Dict[str, str]:
    """Name -> version or description, for logs and bug reports."""
    import boxinstseg_tpu_torch
    info = {
        'sys.platform': sys.platform,
        'Python': sys.version.replace('\n', ''),
        'platform': platform.platform(),
        'PyTorch': torch.__version__,
        'CUDA (torch build)': str(torch.version.cuda),
        'cuDNN': str(torch.backends.cudnn.version()
                     if torch.backends.cudnn.is_available() else None),
        'nvcc': _nvcc_version(),
    }
    if torch.cuda.is_available():
        info['GPU count'] = str(torch.cuda.device_count())
        info['GPU 0'] = torch.cuda.get_device_name(0)
        info['nvidia-smi name, power.limit'] = _run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader']).splitlines()[0]
    else:
        info['GPU count'] = '0'
        info['GPU 0'] = NO_CARD
        info['nvidia-smi name, power.limit'] = NO_CARD
    info['boxinstseg_tpu_torch'] = boxinstseg_tpu_torch.__version__
    return info

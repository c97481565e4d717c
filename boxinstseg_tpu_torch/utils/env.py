"""Environment collection, counterpart of ``boxinstseg_tpu/utils/env.py``
(reference: mmdet/utils/collect_env.py): the Python, torch, CUDA, cuDNN
and ``nvcc`` versions and the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them. Without a card the card's entries say so; nothing raises.

``set_tf32`` is the one place that sets the TF32 flags: every entry point
calls it with the config's ``tf32`` key (``tf32_from_cfg``, off by
default, as every parity test and every timed step ran).
"""
from __future__ import annotations

import logging
import os
import platform
import shutil
import subprocess
import sys
from typing import Dict

import torch

NO_CARD = 'no card'

_TF32_LOGGED = False


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

"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``_build/lib<name>-<hash>.so`` at first use, then loaded
with ``ctypes``. The hash covers the source and the compiler flags, so an
edited source builds anew; deleting ``_build/`` forces a rebuild. Nothing
here runs at import time: the CPU tests import every module on machines
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_SECONDS: dict = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                       'toolkit (set PATH to include its bin directory)')


def _library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f'{name}.cu')
    with open(src, 'rb') as f:
        digest = hashlib.sha256(
            f.read() + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f'lib{name}-{digest}.so')


def build_all(names) -> None:
    """Compile every ``csrc/<name>.cu`` of ``names`` that is not built yet,
    one ``nvcc`` process per source, all started together; then load
    them."""
    with _LOCK:
        procs = {}
        for name in names:
            out = _library_path(name)
            if name in _LIBS or os.path.exists(out):
                BUILD_SECONDS.setdefault(name, 0.0)
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f'{out}.{os.getpid()}.tmp'
            src = os.path.join(CSRC_DIR, f'{name}.cu')
            procs[name] = (out, tmp, src, time.perf_counter(),
                           subprocess.Popen(
                               [_nvcc(), *NVCC_FLAGS, '-o', tmp, src],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True))
        errors = []
        for name, (out, tmp, src, t0, proc) in procs.items():
            _, stderr = proc.communicate()
            if proc.returncode != 0:
                errors.append(f'nvcc failed on {src}:\n{stderr}')
                continue
            os.replace(tmp, out)
            BUILD_SECONDS[name] = time.perf_counter() - t0
        if errors:
            raise RuntimeError('\n'.join(errors))
        for name in names:
            if name not in _LIBS:
                _LIBS[name] = ctypes.CDLL(_library_path(name))


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    build_all([name])
    return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err} at launch')

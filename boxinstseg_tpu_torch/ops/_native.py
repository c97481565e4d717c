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


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(CSRC_DIR, f'{name}.cu')
        with open(src, 'rb') as f:
            digest = hashlib.sha256(
                f.read() + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = os.path.join(BUILD_DIR, f'lib{name}-{digest}.so')
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f'{out}.{os.getpid()}.tmp'
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed on {src}:\n{proc.stderr}')
            os.replace(tmp, out)
            BUILD_SECONDS[name] = time.perf_counter() - t0
        else:
            BUILD_SECONDS.setdefault(name, 0.0)
        lib = ctypes.CDLL(out)
        _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err} at launch')

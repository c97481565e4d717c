"""Native (C++) host-side components, compiled on first use; a copy of
``boxinstseg_tpu/native`` (the port imports nothing of the JAX package).

Currently: the COCO RLE codec (rle.cpp, pycocotools' maskApi counterpart)
that the evaluation loop runs on every predicted mask.

Build: ``g++ -O3 -shared`` at first use into
``boxinstseg_tpu_torch/_build/native/``, keyed by a source hash; loaded
with ctypes. ``rle_lib()`` returns None when the build fails, and the data
layer's codec then falls back to numpy; ``BUILD_ERROR`` keeps the
compiler's message, so a caller that must have the native codec (the
evaluation on a GPU) can raise with it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), '_build', 'native')
_LIB = None
_TRIED = False
BUILD_ERROR: Optional[str] = None


def _compile(src: str, out: str) -> bool:
    global BUILD_ERROR
    try:
        subprocess.run(
            ['g++', '-O3', '-shared', '-fPIC', '-std=c++17', src, '-o', out],
            check=True, capture_output=True, text=True, timeout=120)
        return True
    except subprocess.CalledProcessError as exc:
        BUILD_ERROR = f'g++ exited {exc.returncode}: {exc.stderr[-2000:]}'
    except (OSError, subprocess.TimeoutExpired) as exc:
        BUILD_ERROR = f'g++ did not run: {exc!r}'
    return False


def rle_lib() -> Optional[ctypes.CDLL]:
    """The compiled RLE library, or None if unavailable (see
    ``BUILD_ERROR``)."""
    global _LIB, _TRIED, BUILD_ERROR
    if _TRIED:
        return _LIB
    _TRIED = True
    src = os.path.join(_DIR, 'rle.cpp')
    with open(src, 'rb') as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f'librle_{tag}.so')
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = out + f'.tmp{os.getpid()}'
        if not _compile(src, tmp):
            return None
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(out)
    except OSError as exc:
        BUILD_ERROR = f'cannot load {out}: {exc}'
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.rle_encode_mask.restype = ctypes.c_int
    lib.rle_encode_mask.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                    u32p, ctypes.c_int]
    lib.rle_decode_counts.restype = None
    lib.rle_decode_counts.argtypes = [u32p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, u8p]
    lib.rle_string_encode.restype = ctypes.c_int
    lib.rle_string_encode.argtypes = [u32p, ctypes.c_int,
                                      ctypes.c_char_p, ctypes.c_int]
    lib.rle_string_decode.restype = ctypes.c_int
    lib.rle_string_decode.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      u32p, ctypes.c_int]
    _LIB = lib
    return _LIB

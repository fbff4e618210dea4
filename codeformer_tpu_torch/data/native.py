"""ctypes bindings for the native (C++) degradation kernel.

native/degrade.cpp is built with g++ at first use into
build/native/<hash of source and flags>/ under the repository, without
OpenMP: the source's OpenMP loop runs over the images of one call, and
the datasets call it one image at a time, so OpenMP would add nothing
and a compiler without it (no libgomp) builds the same library. One
build a process, under a lock: the loader's worker threads wait for it
rather than take the other path meanwhile. Where no build loads, the
datasets take the numpy/cv2 path, whose dense blur is several times
slower at the configs' large kernels, and a warning says why, once.
The native path fuses blur -> downsample -> noise -> upsample into one
call (see native/degrade.cpp).
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), '..', '..'))
_SOURCE = os.path.join(_ROOT, 'native', 'degrade.cpp')
_FLAGS = ('-O3', '-march=native', '-fPIC', '-shared', '-std=c++17')


def _lib_path() -> str:
    """build/native/<hash>/libcodeformer_native.so: the hash covers the
    source and the flags, so a changed source builds anew."""
    h = hashlib.sha1(' '.join(_FLAGS).encode())
    if os.path.exists(_SOURCE):
        with open(_SOURCE, 'rb') as f:
            h.update(f.read())
    return os.path.join(_ROOT, 'build', 'native', h.hexdigest()[:16],
                        'libcodeformer_native.so')


_LIB_PATH = _lib_path()
_lock = threading.Lock()
_lib = None
_tried = False


def _build(path: str) -> Optional[str]:
    """Compile the source into `path`. Returns None, or the compiler's
    last words when it fails."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    cmd = [os.environ.get('CXX', 'g++'), *_FLAGS, _SOURCE, '-o', tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return str(e)
    if r.returncode != 0:
        return (r.stderr.strip().splitlines() or [f'exit {r.returncode}'])[-1]
    os.replace(tmp, path)      # another process never loads half a file
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        said = _build(_LIB_PATH) if not os.path.exists(_LIB_PATH) else None
        if said is None:
            try:
                lib = ctypes.CDLL(_LIB_PATH)
            except OSError as e:
                said = str(e)
        if said is not None:
            logging.getLogger('codeformer_tpu_torch').warning(
                f'native degradation kernel unavailable ({said}): the '
                f'datasets blur, downsample and add noise with numpy/cv2, '
                f'several times slower at large blur kernels')
            return None
        f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
        i32p = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
        lib.degrade_batch.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, ctypes.c_int, i32p, i32p, f32p, ctypes.c_uint64,
            ctypes.c_int, f32p]
        lib.degrade_batch.restype = None
        lib.degrade_num_threads.restype = ctypes.c_int
        _lib = lib
        return _lib


def degrade_batch_native(imgs: np.ndarray, kernels: np.ndarray,
                         down_hw: np.ndarray, noise_sigma: np.ndarray,
                         in_size: int, seed: int = 0
                         ) -> Optional[np.ndarray]:
    """imgs (B,H,W,3) float32 [0,1]; kernels (B,k,k); down_hw (B,2) int32;
    noise_sigma (B,) float32. Returns (B, in_size, in_size, 3) or None if
    the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    imgs = np.ascontiguousarray(imgs, np.float32)
    kernels = np.ascontiguousarray(kernels, np.float32)
    down_hw = np.ascontiguousarray(down_hw, np.int32)
    noise_sigma = np.ascontiguousarray(noise_sigma, np.float32)
    b, h, w, _ = imgs.shape
    out = np.empty((b, in_size, in_size, 3), np.float32)
    lib.degrade_batch(imgs, b, h, w, kernels, kernels.shape[-1],
                      down_hw[:, 0].copy(), down_hw[:, 1].copy(),
                      noise_sigma, ctypes.c_uint64(seed), in_size, out)
    return out

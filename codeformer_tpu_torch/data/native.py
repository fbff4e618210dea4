"""ctypes bindings for the native (C++/OpenMP) degradation kernel.

Builds native/libcodeformer_native.so on first use if the toolchain is
available; falls back to the numpy/cv2 path transparently when not. The
native path fuses blur -> downsample -> noise -> upsample into one threaded
call per batch (see native/degrade.cpp).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), '..', '..', 'native'))
_LIB_PATH = os.path.join(_NATIVE_DIR, 'libcodeformer_native.so')
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(['make', '-C', _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
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

"""Build, load and launch the hand-written Hopper kernels (csrc/*.cu).

Each source compiles with its own nvcc process, all started together,
and the objects link into one shared library with a plain C interface,
loaded with ctypes. The library is built at first use into
`build/kernels/<hash>/` at the repository root, keyed by a hash of the
sources and flags, so an edited kernel rebuilds and an unchanged one is
reused. Nothing here runs at import time.

Every kernel launch goes through `launch`, which appends the device and
its current stream, maps the return code to an error and counts the
launch; `launch_counts()` reads the one counter of the process.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
LIB_NAME = 'libcodeformer_kernels.so'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# C signatures of the entry points (csrc/*.cu, extern "C")
SIGNATURES = {
    'cf_conv3x3_dots': [_P] * 10 + [_I] * 16 + [_P],
    'cf_conv3x3_bias': [_P] * 5 + [_I] * 13 + [_P],
    'cf_conv3x3_dense': [_P] * 7 + [_I] * 18 + [_P],
    'cf_downsample_dots': [_P] * 5 + [_I] * 12 + [_P],
    'cf_nearest_code': [_P, _I, _P, _P, _P] + [_I] * 7 + [_P],
    'cf_nearest_code_resident': [_I] * 4,
    'cf_fused_lrelu_fwd': [_P] * 3 + [_I, _L, _I, _D, _D, _I, _P],
    'cf_fused_lrelu_bwd': [_P] * 4 + [_I, _L, _I, _I, _D, _D, _I, _P],
    'cf_fused_lrelu_bwd_rows': [_I, _L, _I, _I],
}
# entry points that answer a query and launch nothing
QUERIES = ('cf_nearest_code_resident', 'cf_fused_lrelu_bwd_rows')

_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}
# launches since the last reset: every launch entry by its name without
# `cf_`, and `int_mm`, the one launch the program makes through torch
# (nn/quant.py)
_launches = dict.fromkeys([name[3:] for name in SIGNATURES
                           if name not in QUERIES] + ['int_mm'], 0)


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in ('.cu', '.cuh'))


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cand = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda')) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                       'toolkit (set CUDA_HOME or put nvcc on PATH)')


def _digest() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.
    Returns its path; `build_info` records seconds and the compiler log."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True,
                          log='')
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        objs, procs = [], []
        try:
            for src in (p for p in _sources() if p.suffix == '.cu'):
                obj = str(Path(tmp_dir) / f'{src.stem}.o')
                cmd = [nvcc, *NVCC_FLAGS, '-I', str(CSRC), '-c', '-o', obj,
                       str(src)]
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
                objs.append(obj)
            logs = [(cmd, proc.communicate(timeout=900)[0], proc.returncode)
                    for cmd, proc in procs]
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for cmd, out, rc in logs:
            if rc != 0:
                raise RuntimeError(f'nvcc failed ({rc}):\n{" ".join(cmd)}\n'
                                   f'{out}')
        tmp_lib = str(Path(tmp_dir) / LIB_NAME)
        # -lcuda: the conv core encodes its TMA tensor maps with
        # cuTensorMapEncodeTiled from libcuda; nvcc links the toolkit's
        # stub, and at load time it binds the libcuda.so.1 torch has open.
        # Linked by name, the symbol needs no runtime entry-point query,
        # whose API differs between CUDA releases.
        cmd = [nvcc, *NVCC_FLAGS[:2], '-shared', '-o', tmp_lib, *objs,
               '-lcuda']
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({proc.returncode}):\n'
                               f'{" ".join(cmd)}\n{proc.stdout}\n'
                               f'{proc.stderr}')
        # atomic: a reader never sees a partial file
        os.replace(tmp_lib, lib_path)
    build_info.update(path=str(lib_path), seconds=time.perf_counter() - t0,
                      cached=False,
                      log=''.join(out for _, out, _ in logs))
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _device_and_stream(t) -> tuple:
    """The device index of tensor `t` and the handle of its device's
    current stream, read at every call: inside `torch.cuda.graph` that
    is the capture stream."""
    import torch
    if t.device.type != 'cuda':
        raise RuntimeError(f'no kernel for device {t.device}')
    return t.device.index or 0, torch.cuda.current_stream(t.device).cuda_stream


def launch(entry: str, *args, on) -> None:
    """Launch `cf_<entry>` with `args`, then the device index and current
    stream of the tensor `on`, and count it under `entry`. A negative
    return is a CUresult from encoding a tensor map, a positive one a
    cudaError; either raises, and the launch is not counted. A tensor
    off the card is refused before the library is touched."""
    dev, stream = _device_and_stream(on)
    rc = getattr(library(), 'cf_' + entry)(*args, dev, stream)
    if rc < 0:
        raise RuntimeError(f'{entry}: a tensor map could not be encoded: '
                           f'CUresult {-rc}')
    if rc:
        raise RuntimeError(f'{entry} kernel launch failed: cudaError {rc}')
    _launches[entry] += 1


def count(name: str, n: int = 1) -> None:
    """Count `n` launches the program makes through torch (`int_mm`)."""
    _launches[name] += n


def launch_counts() -> dict:
    """Launches since the last reset, by kernel: every key, 0 until
    counted."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def add_launch_counts(counts: dict) -> None:
    """Add `counts` (by kernel, negative allowed) to the counter: a CUDA
    graph's capture records launches that do not run, and its replay
    runs them (pipeline/restorer.py)."""
    for k, v in counts.items():
        _launches[k] += v

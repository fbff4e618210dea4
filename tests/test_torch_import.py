"""The port imports torch and numpy only: never jax or flax (the card's
machine has neither), nothing of the JAX package, and neither cv2, yaml
nor triton at import time (the training entry point imports yaml and the
JAX package's data modules inside its functions)."""
import os
import subprocess
import sys

import pytest

pytest.importorskip('torch')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r'''
import importlib, pkgutil, sys
import codeformer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
print(len(names))
print(sorted(m for m in ('jax', 'flax', 'cv2', 'triton', 'PIL', 'yaml',
                         'optax', 'codeformer_tpu') if m in sys.modules))
'''


def test_port_imports_no_jax_flax_cv2_triton():
    """Every module of the port, the training package included."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONSTARTUP'}
    out = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, loaded = out.stdout.strip().splitlines()[-2:]
    assert int(n_modules) >= 25
    assert loaded == '[]', f'port imported {loaded}'


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Without a CUDA toolkit the build fails loudly (the CUDA branch of
    the wrappers then raises); it leaves nothing behind."""
    from codeformer_tpu_torch.kernels import build
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setattr(build, 'BUILD_ROOT', tmp_path / 'kernels')
    with pytest.raises(RuntimeError, match='nvcc not found'):
        build.build()
    assert not (tmp_path / 'kernels').exists()


def test_kernel_sources_and_signatures():
    """The ctypes argtypes match the C entry points' parameter lists:
    a pointer where the C side takes a pointer, an int where an int."""
    import ctypes
    import re

    from codeformer_tpu_torch.kernels import build
    names = {p.name for p in build._sources()}
    assert {'conv3x3_dots.cu', 'downsample_dots.cu', 'nearest_code.cu',
            'conv_tile.cuh'} <= names
    src = '\n'.join(p.read_text() for p in build._sources())
    for entry, argtypes in build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + entry + r'\(([^)]*)\)', src)
        assert m, entry
        params = [' '.join(p.split()) for p in m.group(1).split(',')]
        kinds = [ctypes.c_void_p if '*' in p else ctypes.c_int
                 for p in params]
        assert all('*' in p or p.startswith('int ') for p in params), params
        assert kinds == argtypes, entry


def test_model_registry_holds_the_ported_trainers():
    from codeformer_tpu_torch.train.trainers import (CodeFormerIdxModel,
                                                     build_model)
    from codeformer_tpu_torch.utils.registry import MODEL_REGISTRY
    assert MODEL_REGISTRY.get('CodeFormerIdxModel') is CodeFormerIdxModel
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        build_model({'model_type': 'CodeFormerJointModel'})


def test_registry_holds_the_port_archs():
    from codeformer_tpu_torch.models import CodeFormer, VQAutoEncoder
    from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY, Registry
    assert ARCH_REGISTRY.get('CodeFormer') is CodeFormer
    assert 'VQAutoEncoder' in ARCH_REGISTRY
    assert ARCH_REGISTRY.get('VQAutoEncoder') is VQAutoEncoder
    reg = Registry('tmp')
    reg.register()(CodeFormer)
    with pytest.raises(KeyError, match='already registered'):
        reg.register()(CodeFormer)
    with pytest.raises(KeyError, match='No object named'):
        reg.get('Missing')

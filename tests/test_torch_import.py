"""The port imports torch and numpy only: never jax or flax (the card's
machine has neither), nothing of the JAX package, and neither cv2, yaml
nor triton at import time. Its host-side data and option modules
(codeformer_tpu_torch.data, utils/options.py) are its own copies and
import cv2, yaml and PIL as the JAX copies do; only the training entry
point imports them, inside its functions."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip('torch')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SIDE = ('codeformer_tpu_torch.data', 'codeformer_tpu_torch.utils.options')

_PROBE = r'''
import importlib, pathlib, sys
host_side = {host_side!r}
# module names from the files: pkgutil.walk_packages would import every
# package on its way, the host-side ones included
names = sorted('.'.join(p.with_suffix('').parts[:-1] if p.stem == '__init__'
                        else p.with_suffix('').parts)
               for p in pathlib.Path('codeformer_tpu_torch').rglob('*.py'))
for name in names:
    if {with_host} or not name.startswith(host_side):
        importlib.import_module(name)
print(len(names))
print(sorted(m for m in {forbidden!r} if m in sys.modules))
'''
# the JAX package (codeformer_tpu) or any JAX module, at any depth
_JAX_IMPORT = re.compile(
    r'^\s*(?:from|import)\s+(?:codeformer_tpu|jax|jaxlib|flax|optax)\b'
    r'(?!_torch)'
    r'|import_module\(\s*[\'"](?:codeformer_tpu|jax|flax)\b(?!_torch)',
    re.M)


def _probe(with_host: bool, forbidden) -> tuple:
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONSTARTUP'}
    code = _PROBE.format(host_side=HOST_SIDE, with_host=with_host,
                         forbidden=tuple(forbidden))
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, loaded = out.stdout.strip().splitlines()[-2:]
    return int(n_modules), loaded


def test_port_imports_no_jax_flax_cv2_triton():
    """Every module of the port but the host-side data and option
    modules: no jax, flax, cv2, PIL, yaml, triton or JAX package."""
    n_modules, loaded = _probe(False, (
        'jax', 'flax', 'cv2', 'triton', 'PIL', 'yaml', 'optax',
        'codeformer_tpu'))
    assert n_modules >= 35
    assert loaded == '[]', f'port imported {loaded}'


def test_host_side_modules_import_no_jax():
    """With the data and option modules too: still no jax, flax, triton
    or JAX package."""
    pytest.importorskip('cv2')
    pytest.importorskip('yaml')
    _, loaded = _probe(True, ('jax', 'flax', 'triton', 'optax',
                              'codeformer_tpu'))
    assert loaded == '[]', f'port imported {loaded}'


def test_no_source_file_imports_the_jax_package():
    """A source scan of every codeformer_tpu_torch/**/*.py and of
    chip_smoke.py: no import of codeformer_tpu (or of jax, flax, optax),
    at module level or inside a function."""
    files = sorted(Path(ROOT, 'codeformer_tpu_torch').rglob('*.py'))
    files.append(Path(ROOT, 'chip_smoke.py'))
    assert len(files) >= 36
    hits = [f'{f.relative_to(ROOT)}:{src[:m.start()].count(chr(10)) + 1}'
            for f in files for src in [f.read_text()]
            for m in _JAX_IMPORT.finditer(src)]
    assert hits == [], hits
    # the pattern does catch such lines
    for line in ('from codeformer_tpu.data import build_dataset',
                 '    import codeformer_tpu.utils.options as o',
                 "    importlib.import_module('codeformer_tpu.data')",
                 'import jax.numpy as jnp'):
        assert _JAX_IMPORT.search(line), line
    assert not _JAX_IMPORT.search('from codeformer_tpu_torch.data import x')


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
    a pointer where the C side takes a pointer, an int where an int, a
    long long where a long long, a double where a double."""
    import ctypes

    from codeformer_tpu_torch.kernels import build
    names = {p.name for p in build._sources()}
    assert names == {'conv3x3_dots.cu', 'downsample_dots.cu',
                     'nearest_code.cu', 'fused_act.cu', 'conv_sm90.cuh',
                     'conv3x3_bias.cu', 'conv3x3_dense.cu',
                     'channel_stats.cu'}
    assert {'cf_conv3x3_bias', 'cf_downsample_dots', 'cf_fused_lrelu_fwd',
            'cf_fused_lrelu_bwd', 'cf_conv3x3_dense',
            'cf_channel_stats'} <= set(build.SIGNATURES)
    src = '\n'.join(p.read_text() for p in build._sources())
    scalars = {'int': ctypes.c_int, 'long long': ctypes.c_longlong,
               'double': ctypes.c_double}
    for entry, argtypes in build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + entry + r'\(([^)]*)\)', src)
        assert m, entry
        params = [' '.join(p.split()) for p in m.group(1).split(',')]
        kinds = [ctypes.c_void_p if '*' in p
                 else scalars.get(p.rsplit(' ', 1)[0]) for p in params]
        assert None not in kinds, params
        assert kinds == argtypes, entry


def test_model_registry_holds_the_ported_trainers():
    """The five trainers are registered (stage I and III since they were
    ported, SRModel since it was: it raised before); an unknown model
    type still raises, naming the registered ones."""
    from codeformer_tpu_torch.train import trainers
    from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY, MODEL_REGISTRY
    for name in ('VQGANModel', 'CodeFormerIdxModel', 'CodeFormerJointModel',
                 'CodeFormerModel', 'SRModel'):
        assert MODEL_REGISTRY.get(name) is getattr(trainers, name)
    assert issubclass(trainers.CodeFormerModel,
                      trainers.CodeFormerJointModel)
    for name in ('VQGANDiscriminator', 'VGGFeatureExtractor',
                 'ResNetArcFace'):
        assert name in ARCH_REGISTRY
    with pytest.raises(KeyError, match='No object named.*SRModel'):
        trainers.build_model({'model_type': 'NoSuchModel'})


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


def test_whole_image_modules_are_scanned():
    """The import probe and the source scan cover the whole-image path's
    modules (they are found by the scan, not listed): the probe imported
    them without cv2 or jax, and the registry holds their archs."""
    names = {str(p.relative_to(ROOT)) for p in
             Path(ROOT, 'codeformer_tpu_torch').rglob('*.py')}
    assert {f'codeformer_tpu_torch/{m}.py' for m in (
        'ops/anchors', 'ops/nms', 'ops/geometry', 'ops/filters',
        'models/retinaface', 'models/parsenet', 'pipeline/detector',
        'pipeline/compositor', 'pipeline/face_helper',
        'pipeline/device_pipeline', 'cli/whole_image',
        'utils/img_util')} <= names
    from codeformer_tpu_torch.models import ParseNet, RetinaFace
    from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY
    assert ARCH_REGISTRY.get('RetinaFace') is RetinaFace
    assert ARCH_REGISTRY.get('ParseNet') is ParseNet

"""What the benchmark loads, and that it refuses to run without a card.

Each check runs in a fresh interpreter, since pytest's own plugins may
import JAX into this one. Top-level module names are compared whole:
`codeformer_tpu_torch` is not `codeformer_tpu`."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / 'benchmark'


def modules(pkg_dir: Path, prefix: str):
    out = []
    for p in sorted(pkg_dir.rglob('*.py')):
        rel = p.relative_to(ROOT).with_suffix('')
        if 'tests' in rel.parts or '.' in p.stem:
            continue
        name = '.'.join(rel.parts)
        if name.endswith('__init__'):
            name = name[:-len('.__init__')]
        if name.startswith(prefix):
            out.append(name)
    return out


def loaded_after(imports, cwd=ROOT):
    code = ('import importlib, json, sys\n'
            f'for m in {imports!r}: importlib.import_module(m)\n'
            'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))')
    env = dict(os.environ, PYTHONPATH=str(cwd))
    out = subprocess.run([sys.executable, '-c', code], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = modules(BENCH, 'benchmark')
    assert 'benchmark.run' in mods and 'benchmark.metrics.mfu' in mods
    tops = loaded_after(mods + ['codeformer_tpu_torch.pipeline.restorer',
                                'codeformer_tpu_torch.pipeline.'
                                'device_pipeline'])
    assert not tops & {'jax', 'jaxlib', 'flax', 'codeformer_tpu'}, tops
    assert 'codeformer_tpu_torch' in tops


def test_reference_loads_no_program():
    mods = modules(BENCH / 'reference', 'benchmark.reference')
    mods += ['benchmark.weights', 'benchmark.roofline', 'benchmark.compare',
             'benchmark.generator']
    tops = loaded_after(mods)
    assert not tops & {'jax', 'jaxlib', 'flax', 'codeformer_tpu',
                       'codeformer_tpu_torch'}, tops


def run_cell_cli(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', PYTHONPATH='')
    return subprocess.run(
        [sys.executable, '-m', 'benchmark.run', '--workload',
         'codeformer.aligned_b16', '--seed', str(2 ** 31 + 5), '--seconds',
         '1', '--trace', '0'], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def test_no_card_no_result():
    out = run_cell_cli(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
    assert 'CUDA' in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(BENCH, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = run_cell_cli(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ''

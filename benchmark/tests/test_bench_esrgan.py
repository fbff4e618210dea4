"""The background-upsampler cell (benchmark/systems/photos_realesrgan.py)
on the CPU at a small topology: a sound run is correct; a seam one pixel
off and a dense block without its 0.2 residual scale (chip_smoke.py's
`seam_fault` and `rdb_fault`, planted in the program's upsampler) are
not. Also the walk's FLOP count at the configuration's widths, and that
the new references load nothing of the program."""
import contextlib
import json
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from benchmark import run
from benchmark.reference import rrdbnet as rr
from benchmark.systems import photos_realesrgan
from benchmark.tests.conftest import ROOT, TINY_ARCH, tiny_photos
from benchmark.tests.test_bench_imports import loaded_after

CELL = 'codeformer_photos_realesrgan.stream_4faces'
# body.11 exists: 12 RRDBs at narrow widths, windows of 256 + 2 * 8 over
# tiny_photos' 512 x 560 frames (2 x 3 a frame)
TINY_RRDB = dict(num_in_ch=3, num_out_ch=3, num_feat=8, num_block=12,
                 num_grow_ch=4, scale=2)


def load_config(name):
    with open(ROOT / 'benchmark' / 'configs' / f'{name}.json') as f:
        return json.load(f)


def tiny_esrgan():
    """tiny_photos' configuration and stream traffic with the new
    configuration's system and a narrow fp32 upsampler."""
    cfg, traffic = tiny_photos('restore_frames_stream')
    esr = load_config('codeformer_photos_realesrgan')
    up = dict(esr['bg_upsampler'], arch=TINY_RRDB, tile=256, tile_pad=8,
              dtype='float32')
    return dict(cfg, system=esr['system'], bg_upsampler=up), traffic


def run_tiny(bench):
    cfg, traffic = tiny_esrgan()
    return run.run_cell(CELL, 2 ** 31 + 13, 0.5, False, device='cpu',
                        bench=bench, cfg=cfg, traffic=traffic)


@contextlib.contextmanager
def seam_fault():
    """Each upscaled window moved one pixel right before its core is
    cut: the cores land one pixel off."""
    from codeformer_tpu_torch.pipeline.realesrgan import RealESRGANer
    fwd = RealESRGANer._fwd
    with mock.patch.object(RealESRGANer, '_fwd', lambda self, t: torch.roll(
            fwd(self, t), 1, dims=3)):
        yield


@contextlib.contextmanager
def rdb_fault():
    """body.11.rdb2 of the program's RRDBNet without its 0.2 residual
    scale."""
    real = photos_realesrgan.program_upsampler

    def build(*args, **kw):
        up = real(*args, **kw)
        rdb = up.model.body[11].rdb2

        def forward(x):
            feats = [x]
            for conv in (rdb.conv1, rdb.conv2, rdb.conv3, rdb.conv4):
                feats.append(F.leaky_relu(conv(torch.cat(feats, 1)), 0.2))
            return rdb.conv5(torch.cat(feats, 1)) + x
        rdb.forward = forward
        return up
    with mock.patch.object(photos_realesrgan, 'program_upsampler', build):
        yield


def test_sound_run_is_correct(bench):
    r = run_tiny(bench)
    assert r['correct'], r['checks']
    assert r['attempted'] >= 1 and r['failed'] == 0
    with open(run.BENCH / 'limits' / f'{CELL}.json') as f:
        assert set(r['checks']) == set(json.load(f))
    assert 'background_off' not in r['info']['readings']
    assert r['info']['readings']['bg_max_off'] <= 1


@pytest.mark.parametrize('fault', [seam_fault, rdb_fault])
def test_planted_faults_are_caught(bench, fault):
    with fault():
        r = run_tiny(bench)
    assert not r['correct'], r['checks']
    assert r['checks']['bg_max_off']['value'] > \
        r['checks']['bg_max_off']['limit']


def test_configuration_is_codeformer_photos_with_the_upsampler():
    photos = load_config('codeformer_photos')
    esr = load_config('codeformer_photos_realesrgan')
    differ = {k for k in set(photos) | set(esr)
              if photos.get(k) != esr.get(k)}
    assert differ == {'name', 'source', 'source_files', 'system',
                      'bg_upsampler', 'assumed'}
    assert photos['assumed'].items() <= esr['assumed'].items()
    assert esr['bg_upsampler']['arch'] == dict(
        num_in_ch=3, num_out_ch=3, num_feat=64, num_block=23,
        num_grow_ch=32, scale=2)


def test_walk_flops_of_the_configuration():
    up = load_config('codeformer_photos_realesrgan')['bg_upsampler']
    cost = rr.walk_cost(up['arch'], 512, 683, up['tile'], up['tile_pad'])
    assert (cost['windows'], cost['window']) == (4, 480)
    # 2.066 TFLOP a 480^2 window: 1.905 in the 69 dense blocks, 0.085 in
    # the two up convs at 2x and 4x, 0.068 in conv_hr, the rest small
    assert cost['flops'] / 4 == pytest.approx(2.066e12, rel=5e-4)
    with torch.device('meta'):
        model = rr.RRDBNet(**up['arch'])
    assert sum(p.numel() for p in model.parameters()) == 16_703_171


def test_new_references_load_nothing_of_the_program():
    tops = loaded_after(['benchmark.reference.rrdbnet',
                         'benchmark.reference.paste_canvas'])
    assert not tops & {'jax', 'jaxlib', 'flax', 'codeformer_tpu',
                       'codeformer_tpu_torch'}, tops

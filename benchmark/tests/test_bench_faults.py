"""A run of the harness on the CPU at a small topology, past the look for
a card, with the timed path broken underneath: `correct` has to come out
false for each fault a serving cell can have, and true unbroken. The
aligned cell and the photo stream (its frames pasted back) both."""
import contextlib
import json
from unittest import mock

import pytest
import torch

from benchmark import run
from benchmark.systems import aligned
from benchmark.tests.conftest import tiny_photos

CELLS = ('codeformer.aligned_b16', 'codeformer_photos.stream_4faces')


@pytest.fixture(params=CELLS)
def tiny(request, tiny_cfg, tiny_traffic):
    if request.param == CELLS[0]:
        return request.param, tiny_cfg, tiny_traffic
    return (request.param, *tiny_photos('restore_frames_stream'))


def run_tiny(bench, tiny):
    cell, cfg, traffic = tiny
    return run.run_cell(cell, 2 ** 31 + 11, 0.5, False, device='cpu',
                        bench=bench, cfg=cfg, traffic=traffic)


@contextlib.contextmanager
def broken_restore(fault):
    """Patch the restorer's restore_device with `fault(x, out)` applied
    to what it returns."""
    from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer
    real = CodeFormerRestorer.restore_device

    def restore(self, x, *args, **kw):
        x = torch.as_tensor(x)
        return fault(x.to(self.device), real(self, x, *args, **kw))
    with mock.patch.object(CodeFormerRestorer, 'restore_device', restore):
        yield


def returns_input(x, out):
    return x.clone()


def half_batch_left_out(x, out):
    """The batch's second half passed through unrestored (a batch of
    one is all second half)."""
    out = out.clone()
    half = len(out) // 2
    out[half:] = x[half:]
    return out


def answers_swapped(x, out):
    return out.roll(1, dims=0) if len(out) > 1 else out.flip(1)


def answer_altered(x, out):
    """A 16 x 16 patch at the face's centre inverted (the paste-back
    blends a face's corners away)."""
    out = out.clone()
    c = out.shape[1] // 2
    out[:, c - 8:c + 8, c - 8:c + 8] = 255 - out[:, c - 8:c + 8, c - 8:c + 8]
    return out


@contextlib.contextmanager
def tokens_altered():
    """The transformer's logits rolled by one code: every pick is its
    neighbour's."""
    real = aligned.program_restorer

    def build(*args, **kw):
        r = real(*args, **kw)
        r.model.idx_pred_layer.register_forward_hook(
            lambda mod, inp, out: out.roll(1, dims=-1))
        return r
    with mock.patch.object(aligned, 'program_restorer', build):
        yield


def test_sound_run_is_correct(bench, tiny):
    r = run_tiny(bench, tiny)
    assert r['correct'], r['checks']
    assert r['attempted'] >= 1 and r['failed'] == 0
    with open(run.BENCH / 'limits' / f'{tiny[0]}.json') as f:
        assert set(r['checks']) == set(json.load(f))


@pytest.mark.parametrize('fault', [returns_input, half_batch_left_out,
                                   answers_swapped, answer_altered])
def test_broken_answers_are_caught(bench, tiny, fault):
    with broken_restore(fault):
        r = run_tiny(bench, tiny)
    assert not r['correct'], r['checks']


def test_altered_tokens_are_caught(bench, tiny):
    with tokens_altered():
        r = run_tiny(bench, tiny)
    assert not r['correct'], r['checks']
    assert r['checks']['code_gap']['value'] > \
        r['checks']['code_gap']['limit']
    # the wide tokens, decoded with the reference's own picks, read as
    # pixels off too
    assert r['info']['readings']['code_wide_miss'] > 0.5
    off = 'image_tile_off' if 'image_tile_off' in r['checks'] \
        else 'paste_tile_off'
    assert r['checks'][off]['value'] > r['checks'][off]['limit']


@pytest.mark.parametrize('extra', [{'clients': 4}, {'loop': 'open'},
                                   {'entry': 'restore_batches'}])
def test_unimplemented_traffic_is_refused(bench, tiny_cfg, tiny_traffic,
                                          extra):
    with pytest.raises(SystemExit, match='traffic keys|entry'):
        run.run_cell('codeformer.aligned_b16', 2 ** 31 + 11, 0.5, False,
                     device='cpu', bench=bench, cfg=tiny_cfg,
                     traffic={**tiny_traffic, **extra})

"""The program's spans (utils/profiler.py `span`): nothing while no
profiler runs; under torch.profiler a `cf.<name>` range for the
restorer, the three parts of the forward, the detector and each stage of
the fused pipeline, nested as they are called, none left open while a
stream's consumer runs, and the restored bytes the same with the
profiler on and off. The CLIs' `stage()` both times its block and opens
its range.

The pipeline runs the program's own RetinaFace graph (mobile0.25, random
weights, a threshold no score passes, so the keep bucket never
escalates) and then hands on tests/test_torch_device_pipeline.py's
injected detections, so every stage runs on the CPU at a tiny size.
"""
import numpy as np
import pytest
import torch

from codeformer_tpu_torch.models import CodeFormer
from codeformer_tpu_torch.models.parsenet import ParseNet
from codeformer_tpu_torch.pipeline import detector as pdet
from codeformer_tpu_torch.pipeline import device_pipeline as pdp
from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer
from codeformer_tpu_torch.utils import profiler as pprof
from codeformer_tpu_torch.utils.checkpoint import init_params_fast
from test_torch_device_pipeline import (FACE, TINY, _frames, _Helper, _lms,
                                        _rows)

torch.set_num_threads(2)
MODEL_SPANS = ['cf.model.encode', 'cf.model.transformer', 'cf.model.generate']
PIPELINE_SPANS = {'cf.pipeline.upload', 'cf.detect', 'cf.detect.net',
                  'cf.detect.select', 'cf.detect.finish', 'cf.pipeline.chunk',
                  'cf.pipeline.plan', 'cf.pipeline.warp', 'cf.restore',
                  'cf.parse', 'cf.composite', 'cf.pipeline.fetch',
                  *MODEL_SPANS}
LANDMARKS = _lms(0.1, [(22.0, 10.0)])


@pytest.fixture(scope='module')
def restorer():
    return CodeFormerRestorer(device='cpu', dtype=torch.float32,
                              model=init_params_fast(CodeFormer(**TINY), 3),
                              face_size=FACE, batch_buckets=(1, 2))


class _Detected(pdet.FaceDetector):
    """The program's RetinaFace graph runs and is waited for; then the
    injected detections are handed on."""

    def batched_detect_device_finish(self, frames_dev, det_hw, pending,
                                     **kw):
        super().batched_detect_device_finish(frames_dev, det_hw, pending,
                                             **kw)
        b, h = frames_dev.shape[:2]
        dets, valid = _rows(LANDMARKS, det_hw[0] / h, self.max_faces)
        return np.tile(dets, (b, 1, 1)), np.tile(valid, (b, 1))


@pytest.fixture(scope='module')
def pipe(restorer):
    det = _Detected('retinaface_mobile0.25', allow_random=True, max_faces=8,
                    pre_nms_topk=64, device='cpu')
    parse = init_params_fast(ParseNet(), 5).eval().requires_grad_(False)
    return pdp.DeviceRestorePipeline(
        restorer, _Helper(det, True, parse), upscale=2, w=0.5,
        parse_res=FACE, frame_chunk=2, detect_resize=128,
        conf_threshold=1.1)


def _faces(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, FACE, FACE, 3),
                                                dtype=np.uint8)


def _spans(prof):
    return [e for e in prof.events() if e.name.startswith('cf.')]


def _ancestors(evt):
    out, p = [], evt.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def test_span_is_one_null_object_without_a_profiler(restorer, monkeypatch):
    """No profiler: every span is the same reusable null context, and a
    whole restore records no range."""
    assert not torch.autograd._profiler_enabled()
    null = pprof.span('restore')
    assert pprof.span('model.encode') is null
    with null, null:
        pass

    def refuse(*a, **kw):
        raise AssertionError('a range was opened without a profiler')
    monkeypatch.setattr(pprof, '_RecordFunctionFast', refuse)
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    out = restorer.restore_device(_faces(1), w=0.5)
    assert out.shape == (1, FACE, FACE, 3) and out.dtype == torch.uint8


def test_restore_opens_the_forwards_three_spans_in_order(restorer):
    """cf.restore holds cf.model.encode, cf.model.transformer and
    cf.model.generate, one each, in that order; the spans are host
    ranges, not user annotations (those the profiler copies onto the
    device's timeline)."""
    with torch.profiler.profile() as prof:
        restorer.restore_device(_faces(2, seed=1), w=0.5)
    spans = _spans(prof)
    restore = [e for e in spans if e.name == 'cf.restore']
    assert len(restore) == 1
    kids = [c.name for c in restore[0].cpu_children
            if c.name.startswith('cf.')]
    assert kids == MODEL_SPANS
    assert sorted(e.name for e in spans) == sorted(['cf.restore',
                                                    *MODEL_SPANS])
    assert not any(e.is_user_annotation for e in spans)


def test_stream_opens_every_pipeline_span(pipe):
    """One short stream (3 frames, chunks of 2) opens every span of the
    pipeline, each nested where it is called, and none is open while the
    consumer holds a frame."""
    frames = list(_frames(3, seed=11, hw=(512, 544)))
    with torch.profiler.profile() as prof:
        for _ in pipe.restore_frames_stream(iter(frames)):
            with torch.profiler.record_function('consumer'):
                pass
    spans = _spans(prof)
    assert {e.name for e in spans} == PIPELINE_SPANS
    count = {n: sum(e.name == n for e in spans) for n in PIPELINE_SPANS}
    for name in ('cf.pipeline.upload', 'cf.detect', 'cf.pipeline.chunk',
                 'cf.detect.finish', 'cf.pipeline.plan', 'cf.pipeline.warp',
                 'cf.composite', 'cf.pipeline.fetch'):
        assert count[name] == 2, (name, count[name])
    within = {'cf.detect.net': 'cf.detect', 'cf.detect.select': 'cf.detect',
              'cf.detect.finish': 'cf.pipeline.chunk',
              'cf.pipeline.plan': 'cf.pipeline.chunk',
              'cf.pipeline.warp': 'cf.pipeline.chunk',
              'cf.restore': 'cf.pipeline.chunk',
              'cf.parse': 'cf.pipeline.chunk',
              'cf.composite': 'cf.pipeline.chunk',
              'cf.model.encode': 'cf.restore'}
    for e in spans:
        up = _ancestors(e)
        if e.name in within:
            assert within[e.name] in up, (e.name, up)
        if e.name in ('cf.pipeline.upload', 'cf.pipeline.fetch',
                      'cf.pipeline.chunk', 'cf.detect'):
            assert not any(a.startswith('cf.') for a in up), (e.name, up)
    consumers = [e for e in prof.events() if e.name == 'consumer']
    assert len(consumers) == 3
    assert all(e.cpu_parent is None for e in consumers)


def test_bytes_equal_with_the_profiler_on_and_off(pipe, restorer):
    frames = list(_frames(3, seed=12, hw=(512, 544)))
    faces = _faces(2, seed=2)
    off = list(pipe.restore_frames_stream(iter(frames)))
    off_faces = restorer.restore_device(faces, w=0.5).numpy()
    with torch.profiler.profile():
        on = list(pipe.restore_frames_stream(iter(frames)))
        on_faces = restorer.restore_device(faces, w=0.5).numpy()
    assert len(on) == len(off) == 3
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(on_faces, off_faces)


def test_stage_times_and_opens_its_range():
    """A CLI stage adds to TIMER as before and is a cf. range too."""
    name = 'spans_test_stage'
    try:
        with torch.profiler.profile() as prof:
            with pprof.stage(name):
                torch.ones(2).sum()
        assert pprof.TIMER.counts[name] == 1
        assert pprof.TIMER.totals[name] > 0
        assert [e.name for e in _spans(prof)] == [f'cf.{name}']
        with pprof.stage(name):
            pass
        assert pprof.TIMER.counts[name] == 2
    finally:
        pprof.TIMER.totals.pop(name, None)
        pprof.TIMER.counts.pop(name, None)

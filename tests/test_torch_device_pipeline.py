"""The port's DeviceRestorePipeline against the JAX package's on the same
tiny CodeFormer, the same ParseNet weights and the same injected
detections (port-side and JAX-side twins of tests/test_device_pipeline.py
`_InjectedDetector`): one face, overlapping faces, no faces, a face over
the canvas corner, the whole-canvas fallback, parse_res half and full,
and the stream against the batch.

The host bookkeeping (affines, face slots, m, fpf, w_edge, the windows)
is the same numpy code on the same detections: held equal. The crops
differ only by the warp's fp32 coordinate rounding: within 1 level. The
final frames go through two restorers whose fp32 outputs differ by ~1e-5
before rounding, so a face pixel may move by a level; they are held to
the bounds below, set from the readings (each case's mean and max are
printed with -s). Outside every face window the frame is the upscaled
canvas: bit-identical to the port's own plain upscale, and within 1 level
of JAX's (the two resizes round a .5 differently at most).
"""
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeformer_tpu.models import CodeFormer as JCodeFormer
from codeformer_tpu.models import ParseNet as JParseNet
from codeformer_tpu.pipeline import device_pipeline as jdp
from codeformer_tpu.pipeline.detector import FaceDetector as JFaceDetector
from codeformer_tpu.pipeline.restorer import CodeFormerRestorer as JRestorer
from codeformer_tpu.utils.checkpoint import init_params_fast
from codeformer_tpu_torch.models import CodeFormer
from codeformer_tpu_torch.models.parsenet import ParseNet
from codeformer_tpu_torch.ops.geometry import resize_linear
from codeformer_tpu_torch.pipeline import detector as pdet
from codeformer_tpu_torch.pipeline import device_pipeline as pdp
from codeformer_tpu_torch.pipeline.face_helper import FaceRestoreHelper
from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer
from codeformer_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(2)
FACE = 64
TINY = dict(img_size=FACE, nf=32, ch_mult=(1, 2, 4), codebook_size=64,
            emb_dim=16, dim_embd=64, n_head=4, n_layers=2, latent_size=256,
            connect_list=('32',))
TEMPLATE = np.array(
    [[192.98138, 239.94708], [318.90277, 240.1936], [256.63416, 314.01935],
     [201.26117, 371.41043], [313.08905, 371.15118]], np.float32)
FRAME_HW = (96, 128)

# final frames, port vs JAX, |diff| in levels over the whole frame: the
# mean and the largest single difference. Read: mean <= 0.0003 and max 1
# in every case; bounds a few times that (a misplaced window or a wrong
# blend order reads tens of levels)
FRAME_MEAN_BOUND = 2e-3
FRAME_MAX_BOUND = 2


def _lms(scale, offsets):
    """Frame landmarks of faces `scale` times the 512 template, shifted."""
    return [TEMPLATE * scale + np.asarray(o, np.float32) for o in offsets]


CASES = {   # name: (landmarks of each frame's faces, frames, use_parse)
    'one_face': (_lms(0.1, [(22.0, 10.0)]), 2, False),
    'overlap': (_lms(0.09, [(8.0, 4.0), (30.0, 16.0)]), 2, False),
    'no_faces': ([], 1, False),
    'border': (_lms(0.1, [(-30.0, -28.0)]), 1, False),
    'full_canvas': (_lms(0.22, [(-8.0, -24.0)]), 1, False),
    'parse_half': (_lms(0.1, [(22.0, 10.0)]), 1, True),
    'parse_full': (_lms(0.1, [(22.0, 10.0)]), 1, True),
}


def _rows(landmarks, det_scale, max_faces):
    dets = np.zeros((max_faces, 15), np.float32)
    for k, lm_f in enumerate(landmarks):
        lm = lm_f * det_scale
        dets[k, 0:4] = [lm[:, 0].min() - 5, lm[:, 1].min() - 8,
                        lm[:, 0].max() + 5, lm[:, 1].max() + 6]
        dets[k, 4] = 0.99
        dets[k, 5:15] = lm.reshape(-1)
    valid = np.zeros(max_faces, bool)
    valid[:len(landmarks)] = True
    return dets, valid


def _injected_finish(self, frames_dev, det_hw, pending, **kw):
    b, h = frames_dev.shape[:2]
    dets, valid = _rows(self.landmarks, det_hw[0] / h, self.max_faces)
    return np.tile(dets, (b, 1, 1)), np.tile(valid, (b, 1))


class _JInjected(JFaceDetector):
    """The same detections for every frame, in detector coordinates."""

    def __init__(self, landmarks):
        self.max_faces, self.pre_nms_topk = 8, 64
        self.variables, self._jitted = None, {}
        self.landmarks = landmarks

    def batched_detect_device_start(self, frames_dev, det_hw, **kw):
        return None

    batched_detect_device_finish = _injected_finish


class _PInjected(pdet.FaceDetector):
    """The port's twin of _JInjected."""

    def __init__(self, landmarks):
        self.max_faces, self.pre_nms_topk = 8, 64
        self.device, self._graphs = torch.device('cpu'), {}
        self.landmarks = landmarks

    def batched_detect_device_start(self, frames_dev, det_hw, **kw):
        return None

    batched_detect_device_finish = _injected_finish


class _Helper:
    """The attributes DeviceRestorePipeline reads of a FaceRestoreHelper."""
    _parse = FaceRestoreHelper._parse

    def __init__(self, detector, use_parse, parse_model=None,
                 parse_vars=None):
        self.face_detector = detector
        self.face_template = TEMPLATE * (FACE / 512.0)
        self.face_size = (FACE, FACE)
        self.use_parse = use_parse
        self._parse_model = parse_model
        self._parse_vars = parse_vars
        self.parse_dtype = torch.float32


@pytest.fixture(scope='module')
def models():
    """JAX and port restorers and parsers on the same weights."""
    env = {k: v for k, v in os.environ.items() if k != 'CODEFORMER_COLPACK'}
    with mock.patch.dict(os.environ, env, clear=True):
        jr = JRestorer(model=JCodeFormer(**TINY), dtype=jnp.float32,
                       face_size=FACE, batch_buckets=(1, 2, 4))
    pm = CodeFormer(**TINY)
    pm.load_state_dict(flax_to_state_dict(jr.variables))
    pr = CodeFormerRestorer(device='cpu', dtype=torch.float32, model=pm,
                            face_size=FACE)
    jparse = JParseNet()
    jvars = jax.tree_util.tree_map(np.asarray, init_params_fast(
        jparse, jnp.zeros((1, 64, 64, 3)), seed=5))
    pparse = ParseNet().eval().requires_grad_(False)
    pparse.load_state_dict(flax_to_state_dict(
        jvars, like=pparse.state_dict()), strict=True)
    return jr, pr, (jparse, jvars), pparse


class _JRecord(jdp.DeviceRestorePipeline):
    """Records the bookkeeping each chunk hands the merged graph."""

    def _merged_graph(self, in_hw, c, m, fpf, face, w_edge, use_parse, roi):
        fn = super()._merged_graph(in_hw, c, m, fpf, face, w_edge,
                                   use_parse, roi)

        def run(frames, idx, a, rvars, w, pvars, fmap, ia, roi_pos):
            self.plans.append(dict(
                frame_idx=np.asarray(idx), affines=np.asarray(a),
                face_map=np.asarray(fmap), inv_affines=np.asarray(ia),
                roi_pos=np.asarray(roi_pos), m=m, fpf=fpf, w_edge=w_edge,
                roi=roi))
            return fn(frames, idx, a, rvars, w, pvars, fmap, ia, roi_pos)
        return run


def _pipes(models, case, **kw):
    jr, pr, (jparse, jvars), pparse = models
    landmarks, _, use_parse = CASES[case]
    parse_res = {'parse_half': FACE // 2}.get(case, FACE)
    jp = _JRecord(jr, _Helper(_JInjected(landmarks), use_parse, jparse,
                              jax.device_put(jvars)),
                  upscale=2, w=0.5, parse_res=parse_res, **kw)
    jp.plans = []
    pp = pdp.DeviceRestorePipeline(
        pr, _Helper(_PInjected(landmarks), use_parse, pparse),
        upscale=2, w=0.5, parse_res=parse_res, **kw)
    return jp, pp


def _frames(n, seed=0, hw=FRAME_HW):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(30, 220, (n, hw[0] // 8, hw[1] // 8, 3))
    img = np.repeat(np.repeat(lo, 8, axis=1), 8, axis=2)
    img = img + rng.normal(0, 10, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _plain_canvas(frames, up=2):
    """The upscaled frames, as the composite's canvas rounds them."""
    x = resize_linear(torch.from_numpy(frames).permute(0, 3, 1, 2).float(),
                      (frames.shape[1] * up, frames.shape[2] * up))
    return torch.round(x).clamp(0, 255).to(torch.uint8) \
        .permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize('case', sorted(CASES))
def test_pipeline_matches_jax(models, case):
    landmarks, n_frames, _ = CASES[case]
    jp, pp = _pipes(models, case, frame_chunk=n_frames)
    frames = _frames(n_frames, seed=len(case))
    jfaces, pfaces = [], []
    want = np.asarray(jp.restore_frames_device(frames,
                                               collect_faces=jfaces))
    got = pp.restore_frames_device(frames, collect_faces=pfaces).numpy()
    assert got.shape == want.shape == (n_frames, 192, 256, 3)

    # bookkeeping: equal
    plan, jplan = pp.last_plan, jp.plans[-1]
    for key in ('frame_idx', 'affines', 'face_map', 'inv_affines',
                'roi_pos'):
        np.testing.assert_array_equal(getattr(plan, key), jplan[key], key)
    for key in ('m', 'fpf', 'w_edge', 'roi'):
        assert getattr(plan, key) == jplan[key], key
    assert plan.counts == jfaces[0][2] == [len(landmarks)] * n_frames
    assert (plan.roi == 0) == (case == 'full_canvas')

    # crops within 1 level; restored faces from nearly the same crops
    crops, jcrops = pfaces[0][0].numpy(), np.asarray(jfaces[0][0])
    assert crops.shape == jcrops.shape == (plan.m, FACE, FACE, 3)
    assert np.abs(crops.astype(int) - jcrops.astype(int)).max() <= 1

    diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
    print(f'{case}: frame |diff| mean {diff.mean():.4f} max {diff.max():.0f}')
    assert diff.mean() <= FRAME_MEAN_BOUND, diff.mean()
    assert diff.max() <= FRAME_MAX_BOUND, diff.max()
    outside = ~plan.windows_mask(got.shape)
    np.testing.assert_array_equal(got[outside],
                                  _plain_canvas(frames)[outside])
    assert diff[outside].max(initial=0) <= 1
    if landmarks:   # the faces did change the frame
        assert np.abs(got.astype(int) - _plain_canvas(frames)).max() > 10


def test_roi_equals_full_canvas(models):
    """The window path and the whole-canvas path give the same frame: the
    soft edge never reaches past a window (device_pipeline.py's margin
    argument), so only the warp's fp32 coordinate rounding differs."""
    _, pp = _pipes(models, 'overlap', frame_chunk=2)

    class Full(pdp.DeviceRestorePipeline):
        def _plan(self, per_frame, frame_hw):
            plan = super()._plan(per_frame, frame_hw)
            for slot, (_, y0, x0) in enumerate(plan.roi_pos):
                if slot % plan.fpf < plan.counts[slot // plan.fpf]:
                    plan.inv_affines[slot][:, 2] += (x0, y0)
            plan.roi = 0
            return plan

    full = Full(pp.restorer, pp.helper, upscale=2, w=0.5, frame_chunk=2)
    frames = _frames(2, seed=3)
    a = pp.restore_frames_device(frames).numpy()
    assert pp.last_plan.roi > 0
    b = full.restore_frames_device(frames).numpy()
    assert full.last_plan.roi == 0
    diff = np.abs(a.astype(int) - b.astype(int))
    assert diff.max() <= 2 and (diff > 0).mean() < 1e-3, \
        (diff.max(), (diff > 0).mean())


def test_stream_equals_batch(models):
    """restore_frames_stream gives restore_frames' frames bit for bit:
    two full chunks, a repeat-padded tail (5 = 2 + 2 + 1), a stream
    shorter than a chunk, an empty stream; and restore_frames' per-face
    pairs are the collected crops, BGR."""
    _, pp = _pipes(models, 'one_face', frame_chunk=2)
    frames = list(_frames(5, seed=11, hw=(512, 544)))
    batch, faces = pp.restore_frames(frames, return_faces=True)
    streamed = list(pp.restore_frames_stream(iter(frames)))
    assert len(streamed) == len(batch) == 5
    for s, b in zip(streamed, batch):
        assert s.dtype == np.uint8 and s.shape == (1024, 1088, 3)
        np.testing.assert_array_equal(s, b)
    assert [len(f) for f in faces] == [1] * 5
    for cropped, restored in (p for fr in faces for p in fr):
        assert cropped.shape == restored.shape == (FACE, FACE, 3)
    short = list(pp.restore_frames_stream(iter(frames[:1])))
    np.testing.assert_array_equal(short[0], pp.restore_frames(frames[:1])[0])
    assert list(pp.restore_frames_stream(iter([]))) == []


# a chunk of 3 frames with 2 faces each: 6 real faces, m = 8 slots
SPLIT_FRAMES = 3
SPLIT_RUNS = {(1, 2): [2, 2, 2], (1, 4): [4, 4]}   # buckets: batch sizes


def _counting_pipe(models, buckets, use_parse=True):
    """The port's pipeline on the 'overlap' faces, its restorer (the
    fixture's weights) on `buckets`; records the batch of every restore
    and parse call."""
    _, pr, _, pparse = models
    r = CodeFormerRestorer(device='cpu', dtype=torch.float32,
                           model=pr.model, face_size=FACE,
                           batch_buckets=buckets)
    pipe = pdp.DeviceRestorePipeline(
        r, _Helper(_PInjected(CASES['overlap'][0]), use_parse, pparse),
        upscale=2, w=0.5, parse_res=FACE, frame_chunk=SPLIT_FRAMES)
    pipe.calls = {'restore': [], 'parse': []}
    restore, parse = r.restore_device, pipe._parse_ids

    def counted_restore(x, *a, **kw):
        pipe.calls['restore'].append(x.shape[0])
        return restore(x, *a, **kw)

    def counted_parse(x):
        pipe.calls['parse'].append(x.shape[0])
        return parse(x)

    r.restore_device, pipe._parse_ids = counted_restore, counted_parse
    return pipe


@pytest.mark.parametrize('buckets', sorted(SPLIT_RUNS))
def test_split_restore_equals_one_call_and_jax(models, buckets):
    """A chunk with more faces than the restorer's top bucket restores
    and parses its real faces in runs of that bucket (the last padded to
    its bucket), never the plan's padding slots: the frames, the
    collected faces and the plan equal those of the same pipeline whose
    top bucket holds the chunk (one call, 6 faces padded to 8) bit for
    bit; and, without ParseNet, the frames are JAX's one-call pipeline's
    within test_pipeline_matches_jax's bounds. (With ParseNet the two
    restorers' faces, a level apart at 0.015% of values, flip 0.008% of
    the parse ids' argmax, and such a pixel of the blend mask moves the
    frame by up to 6 levels: read mean 0.0013, max 6, with the one-call
    port pipeline as with the split one.)"""
    jr, _, _, _ = models
    frames = _frames(SPLIT_FRAMES, seed=21)
    split = _counting_pipe(models, buckets)
    one = _counting_pipe(models, (1, 2, 4, 8))
    got, want = [], []
    out = split.restore_frames_device(frames, collect_faces=got).numpy()
    ref = one.restore_frames_device(frames, collect_faces=want).numpy()
    assert split.calls == {'restore': SPLIT_RUNS[buckets],
                           'parse': SPLIT_RUNS[buckets]}
    assert one.calls == {'restore': [8], 'parse': [8]}
    plan = split.last_plan
    assert plan.m == 8 and plan.counts == [2] * SPLIT_FRAMES
    for key in ('frame_idx', 'affines', 'face_map', 'inv_affines',
                'roi_pos'):
        np.testing.assert_array_equal(getattr(plan, key),
                                      getattr(one.last_plan, key), key)
    assert plan.face_map.max() < sum(plan.counts)   # real faces only
    np.testing.assert_array_equal(out, ref)
    (crops, restored, counts), = got
    (crops1, restored1, counts1), = want
    assert counts == counts1 == plan.counts
    np.testing.assert_array_equal(crops.numpy(), crops1.numpy())
    assert restored.shape == (6, FACE, FACE, 3)
    np.testing.assert_array_equal(restored.numpy(), restored1.numpy())
    assert np.abs(out.astype(int) - _plain_canvas(frames)).max() > 10

    bare = _counting_pipe(models, buckets, use_parse=False)
    out = bare.restore_frames_device(frames).numpy()
    assert bare.calls == {'restore': SPLIT_RUNS[buckets], 'parse': []}
    jp = _JRecord(jr, _Helper(_JInjected(CASES['overlap'][0]), False),
                  upscale=2, w=0.5, frame_chunk=SPLIT_FRAMES)
    jp.plans = []
    jout = np.asarray(jp.restore_frames_device(frames))
    assert jp.plans[-1]['m'] == plan.m
    diff = np.abs(out.astype(np.float32) - jout.astype(np.float32))
    print(f'split {buckets}, no ParseNet: frame |diff| vs JAX mean '
          f'{diff.mean():.4f} max {diff.max():.0f}')
    assert diff.mean() <= FRAME_MEAN_BOUND, diff.mean()
    assert diff.max() <= FRAME_MAX_BOUND, diff.max()


def test_whole_canvas_composite_pastes_a_round_at_a_time(models):
    """Two faces a frame, each about the canvas's size (the whole-canvas
    path, roi 0): every soft_paste call of the composite warps one face
    of each frame (c slots), never all c * fpf slots at once, whose
    canvases ran the card out of memory at 16 frames of 16 faces; the
    frames are JAX's within test_pipeline_matches_jax's bounds."""
    from codeformer_tpu_torch.pipeline import compositor
    jr, pr, _, _ = models
    landmarks = _lms(0.22, [(-8.0, -24.0), (4.0, -16.0)])
    jp = _JRecord(jr, _Helper(_JInjected(landmarks), False), upscale=2,
                  w=0.5, frame_chunk=2)
    jp.plans = []
    pp = pdp.DeviceRestorePipeline(pr, _Helper(_PInjected(landmarks), False),
                                   upscale=2, w=0.5, frame_chunk=2)
    frames = _frames(2, seed=31)
    slots = []

    def counted(src, inv_affines, *a, **kw):
        slots.append(len(inv_affines))
        return compositor.soft_paste(src, inv_affines, *a, **kw)

    with mock.patch.object(pdp, 'soft_paste', counted):
        got = pp.restore_frames_device(frames).numpy()
    plan = pp.last_plan
    assert plan.roi == 0 and plan.fpf == 2 and plan.counts == [2, 2]
    assert slots == [2, 2]
    want = np.asarray(jp.restore_frames_device(frames))
    assert jp.plans[-1]['roi'] == 0
    diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
    print(f'whole canvas, 2 faces a frame: frame |diff| vs JAX mean '
          f'{diff.mean():.4f} max {diff.max():.0f}')
    assert diff.mean() <= FRAME_MEAN_BOUND, diff.mean()
    assert diff.max() <= FRAME_MAX_BOUND, diff.max()
    assert np.abs(got.astype(int) - _plain_canvas(frames)).max() > 10

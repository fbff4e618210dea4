"""The background upsampler on the fused pipeline
(`DeviceRestorePipeline(..., bg_upsampler=)`, `_upsample_bg`,
`RealESRGANer.upscale_frames_device`), on the CPU in fp32:

- the port's RRDBNet and its tile walk against the benchmark's plain
  reference (benchmark/reference/rrdbnet.py: `torch.cat` dense blocks,
  nearest x2 then a 3x3 conv) on the benchmark's seeded, tamed weights;
- `_upsample_bg` on a chunk against `upscale_device` frame by frame, and
  `tile_counts()` after it;
- the fused pipeline with the upsampler against the classic route's
  paste onto `enhance`'s frame (`paste_faces_to_input_image(
  upsample_img=)`), within the fused-against-classic bounds of
  tests/test_device_pipeline.py;
- without an upsampler the composite blends onto the linear resize as
  before, bit for bit;
- an upscale other than the upsampler's scale is refused.
"""
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip('cv2')

from benchmark.reference import rrdbnet as rr  # noqa: E402
from benchmark.systems.photos_realesrgan import rrdb_weights  # noqa: E402
from codeformer_tpu_torch.models.rrdbnet import RRDBNet  # noqa: E402
from codeformer_tpu_torch.pipeline import device_pipeline as pdp  # noqa: E402
from codeformer_tpu_torch.pipeline.face_helper import FaceRestoreHelper  # noqa: E402
from codeformer_tpu_torch.pipeline.realesrgan import RealESRGANer  # noqa: E402
from test_torch_device_pipeline import (CASES, FACE, _frames, _Helper,  # noqa: E402,F401
                                        _PInjected, _plain_canvas, models)

torch.set_num_threads(2)
# the released widths at two RRDBs
ARCH = dict(num_in_ch=3, num_out_ch=3, num_feat=64, num_block=2,
            num_grow_ch=32, scale=2)
TILE, PAD = 32, 8
# fp32, the same products summed in another order (the port's up convs
# are four phase-collapsed 2x2 convs): outputs of magnitude ~1
MODEL_ATOL = 1e-4
# fused against classic (tests/test_device_pipeline.py): mean and median
# |diff| in levels; the fused composite rounds, the classic one truncates
FUSED_MEAN_BOUND = 3.0
FUSED_MEDIAN_BOUND = 1.0


def _weights(seed=3):
    return rrdb_weights({'bg_upsampler': {'arch': ARCH}}, seed, 'cpu')


def _upsampler():
    model = RRDBNet(**ARCH)
    model.load_state_dict(_weights())
    return RealESRGANer(scale=2, model=model, tile=TILE, tile_pad=PAD,
                        tile_batch=4, dtype=torch.float32, device='cpu')


def _smooth(n, hw, seed):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 255, (n, 3, hw[0] // 8, hw[1] // 8))
    x = torch.nn.functional.interpolate(torch.from_numpy(lo).float(),
                                        size=hw, mode='bilinear')
    x = x + torch.from_numpy(rng.normal(0, 6, x.shape)).float()
    return x.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1) \
        .contiguous()


def test_rrdbnet_and_walk_match_the_reference():
    ref = rr.RRDBNet(**ARCH).eval()
    ref.load_state_dict(_weights())
    up = _upsampler()
    x = torch.rand((2, 3, 48, 48), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, got = ref(x), up.model(x)
    torch.testing.assert_close(got, want, rtol=0, atol=MODEL_ATOL)

    frames = _smooth(3, (64, 96), seed=2)
    want = rr.upscale(ref, frames, TILE, PAD)
    got = up.upscale_frames_device(frames)
    assert got.shape == want.shape == (3, 128, 192, 3)
    assert got.dtype == want.dtype == torch.uint8
    diff = (got.int() - want.int()).abs()
    # a window pixel rounded on either side of a .5 moves by one level
    assert diff.max() <= 1 and (diff > 0).float().mean() < 1e-3
    sat = ((want == 0) | (want == 255)).float().mean()
    assert sat <= 0.05 and want.float().std() > 10   # not saturated
    # a seam one pixel off is caught
    assert (got.roll(1, dims=2).int() - want.int()).abs().max() > 5


def _pipeline(models, case='one_face', upsampler=None, upscale=2):
    _, pr, _, pparse = models
    landmarks, n_frames, use_parse = CASES[case]
    return pdp.DeviceRestorePipeline(
        pr, _Helper(_PInjected(landmarks), use_parse, pparse),
        upscale=upscale, w=0.5, frame_chunk=n_frames,
        bg_upsampler=upsampler)


def test_upsample_bg_equals_upscale_device_and_counts_tiles(models):
    up = _upsampler()
    pipe = _pipeline(models, upsampler=up)
    frames = _smooth(3, (64, 96), seed=4)
    got = pipe._upsample_bg(frames)
    assert got.shape == (3, 128, 192, 3) and got.dtype == torch.uint8
    # 3 frames x 2 x 3 windows, BG_TILE_BATCH (16) a forward: 2
    # forwards, 14 zero windows
    assert pipe.BG_TILE_BATCH == 16
    assert up.tile_counts() == {'calls': 2, 'tiles': 18, 'pad_tiles': 14}
    for f in range(3):
        rgb = frames[f].flip(-1).permute(2, 0, 1).float() / 255.0
        want = up.upscale_device(rgb).permute(1, 2, 0).flip(-1)
        assert (got[f].int() - want.int()).abs().max() <= 1
    up.reset_tile_counts()
    assert up.tile_counts() == {'calls': 0, 'tiles': 0, 'pad_tiles': 0}


def test_fused_with_upsampler_matches_the_classic_paste(models):
    """The pipeline's frames against FaceRestoreHelper's paste of the
    pipeline's own restored faces onto enhance's upscale of each frame
    (the classic route's --bg_upsampler realesrgan at --upscale 2)."""
    up = _upsampler()
    pipe = _pipeline(models, upsampler=up)
    frames = _frames(2, seed=7)
    faces = []
    got = pipe.restore_frames_device(frames, collect_faces=faces).numpy()
    plan = pipe.last_plan
    restored = faces[0][1].numpy()
    outside = ~plan.windows_mask(got.shape)
    helper = FaceRestoreHelper(2, face_size=FACE, use_parse=False,
                               device='cpu', detector=object(),
                               allow_random_weights=True)
    for f in range(len(frames)):
        bg, mode = up.enhance(frames[f], outscale=2)
        assert mode == 'RGB'
        # outside the faces' windows the frame is the upsampler's, exactly
        np.testing.assert_array_equal(got[f][outside[f]], bg[outside[f]])
        helper.clean_all()
        helper.input_img = frames[f]
        helper.affine_matrices = [plan.affines[f]]
        helper.get_inverse_affine(None)
        helper.restored_faces = [restored[f][..., ::-1]]
        want = helper.paste_faces_to_input_image(upsample_img=bg)
        diff = np.abs(got[f].astype(np.float32) - want.astype(np.float32))
        assert diff.mean() < FUSED_MEAN_BOUND, diff.mean()
        assert np.median(diff) <= FUSED_MEDIAN_BOUND
        # the faces were pasted onto the upsampled background
        assert np.abs(got[f].astype(int) - bg).max() > 10
        assert np.abs(got[f].astype(int)
                      - _plain_canvas(frames[f:f + 1])[0]).max() > 10


def test_without_upsampler_the_composite_is_unchanged(models, monkeypatch):
    """No upsampler: `_upsample_bg` never runs, and the composite's
    canvas is the linear resize of the frames, unrounded, as before: its
    output equals the composite handed that canvas, bit for bit, and
    outside the windows the plain upscale."""
    pipe = _pipeline(models, case='overlap')
    monkeypatch.setattr(pipe, '_upsample_bg', None)   # not called
    frames = _frames(2, seed=5)
    got = pipe.restore_frames_device(frames).numpy()
    calls = []
    composite = pipe._composite

    def record(*a, **kw):
        calls.append(a)
        return composite(*a, **kw)
    pipe._composite = record
    again = pipe.restore_frames_device(frames).numpy()
    np.testing.assert_array_equal(again, got)
    frames_dev, restored, pids, plan, canvas = calls[0]
    assert canvas is None
    h_up, w_up = 2 * frames.shape[1], 2 * frames.shape[2]
    linear = pdp.resize_linear(frames_dev.permute(0, 3, 1, 2).float(),
                               (h_up, w_up)).permute(0, 2, 3, 1)
    given = composite(frames_dev, restored, pids, plan, linear)
    np.testing.assert_array_equal(given.numpy(), got)
    outside = ~plan.windows_mask(got.shape)
    np.testing.assert_array_equal(got[outside],
                                  _plain_canvas(frames)[outside])


def test_upscale_other_than_the_upsamplers_scale_is_refused(models):
    with pytest.raises(NotImplementedError, match='scales by 2'):
        _pipeline(models, upsampler=_upsampler(), upscale=1)

"""The port's video path against the JAX package's: the video_util copy,
`restore_video_frames` (the classic batched video path) on a 4-frame
clip with the same tiny restorer weights and the same injected
detections, and the CLI's video routes: a video streams lazily into
run_whole_images, the fused branch writes a PNG a frame and the video as
the frames come, and `--fused_pipeline off` takes the classic batched
path. No ffmpeg here: clips are written with cv2 (MJPG) and the output
video by the cv2 writer; the ffmpeg round trip is skipped where ffmpeg
is absent, as tests/test_video_audio.py's is.
"""
import os
import shutil
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

cv2 = pytest.importorskip('cv2')

from codeformer_tpu.models import CodeFormer as JCodeFormer  # noqa: E402
from codeformer_tpu.pipeline import face_helper as jfh  # noqa: E402
from codeformer_tpu.pipeline import video as jvideo  # noqa: E402
from codeformer_tpu.pipeline.restorer import \
    CodeFormerRestorer as JRestorer  # noqa: E402
from codeformer_tpu.utils import video_util as jvu  # noqa: E402
import codeformer_tpu_torch.cli.whole_image as wi  # noqa: E402
from codeformer_tpu_torch.cli import inference_codeformer as cli  # noqa: E402
from codeformer_tpu_torch.models import CodeFormer  # noqa: E402
from codeformer_tpu_torch.pipeline import detector as pdet  # noqa: E402
from codeformer_tpu_torch.pipeline import device_pipeline as pdp  # noqa: E402
from codeformer_tpu_torch.pipeline import face_helper as pfh  # noqa: E402
from codeformer_tpu_torch.pipeline import video as pvideo  # noqa: E402
from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer  # noqa: E402
from codeformer_tpu_torch.utils import video_util as pvu  # noqa: E402
from codeformer_tpu_torch.utils.convert import flax_to_state_dict  # noqa: E402

torch.set_num_threads(2)
FACE = 64
TINY = dict(img_size=FACE, nf=32, ch_mult=(1, 2, 4), codebook_size=64,
            emb_dim=16, dim_embd=64, n_head=4, n_layers=2, latent_size=256,
            connect_list=('32',))
TEMPLATE = np.array(
    [[192.98138, 239.94708], [318.90277, 240.1936], [256.63416, 314.01935],
     [201.26117, 371.41043], [313.08905, 371.15118]], np.float32)
# final frames, port vs JAX: two fp32 restorers (outputs ~1e-5 apart
# before rounding, so a face pixel may move a level) and two device
# compositors (within 1 level): |diff| over the whole frame. Read: mean
# <= 0.00034 and max 1 with the device compositor, <= 0.00004 and max 1
# with cv2's; a face pasted in the wrong place or order reads tens of
# levels
FRAME_MEAN_BOUND = 2e-3
FRAME_MAX_BOUND = 2


def _clip(path, n=4, hw=(96, 128), fps=12.0, seed=3):
    """A seeded MJPG clip (cv2 writes it; no ffmpeg here)."""
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*'MJPG'), fps,
                         (hw[1], hw[0]))
    assert vw.isOpened()
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n):
        lo = rng.uniform(30, 220, (hw[0] // 8, hw[1] // 8, 3))
        f = np.repeat(np.repeat(lo, 8, 0), 8, 1).astype(np.uint8)
        vw.write(f)
        frames.append(f)
    vw.release()
    return frames


# ---------------------------------------------------------------------------
# video_util
# ---------------------------------------------------------------------------
def test_video_util_matches_jax(tmp_path, recwarn):
    assert pvu.have_ffmpeg() == jvu.have_ffmpeg()
    frames = [np.full((64, 80, 3), v, np.uint8) for v in (10, 120, 240)]
    for mod in (pvu, jvu):
        path = str(tmp_path / f'{mod.__name__.split(".")[0]}.mp4')
        w = mod.make_video_writer(path, 64, 80, 24.0, audio=None)
        assert isinstance(w, mod.VideoWriter if mod.have_ffmpeg()
                          else mod.Cv2VideoWriter)
        for f in frames:
            w.write_frame(f)
        w.close()
    decoded = []
    for mod in (pvu, jvu):
        cap = cv2.VideoCapture(str(tmp_path / f'{mod.__name__.split(".")[0]}'
                                              '.mp4'))
        got = []
        ok, f = cap.read()
        while ok:
            got.append(f)
            ok, f = cap.read()
        cap.release()
        decoded.append(got)
    assert len(decoded[0]) == len(decoded[1]) == 3
    for a, b in zip(*decoded):
        np.testing.assert_array_equal(a, b)
    assert not [x for x in recwarn.list
                if issubclass(x.category, UserWarning)]


def test_cv2_writer_warns_when_audio_dropped(tmp_path):
    path = str(tmp_path / 'out.mp4')
    with pytest.warns(UserWarning, match='WITHOUT audio'):
        w = pvu.Cv2VideoWriter(path, 64, 64, 24.0, audio='/some/src.mp4')
    w.write_frame(np.zeros((64, 64, 3), np.uint8))
    w.close()
    assert os.path.getsize(path) > 0


@pytest.mark.skipif(shutil.which('ffmpeg') is None
                    or shutil.which('ffprobe') is None,
                    reason='ffmpeg not on PATH')
def test_audio_stream_survives_roundtrip(tmp_path):
    """A source clip with a sine track, read and written back through the
    port's VideoReader / VideoWriter: the audio stream survives."""
    import json
    import subprocess
    src = str(tmp_path / 'src.mp4')
    subprocess.check_call(
        ['ffmpeg', '-v', 'error', '-y',
         '-f', 'lavfi', '-i', 'testsrc=size=64x64:rate=24:duration=1',
         '-f', 'lavfi', '-i', 'sine=frequency=440:duration=1',
         '-c:v', 'libx264', '-c:a', 'aac', '-shortest', src])
    reader = pvu.VideoReader(src)
    frames = [b for batch in reader.frames(batch=4) for b in batch]
    audio, fps = reader.get_audio(), reader.get_fps()
    reader.close()
    assert audio == src and frames
    out = str(tmp_path / 'out.mp4')
    writer = pvu.make_video_writer(out, 64, 64, fps, audio)
    assert isinstance(writer, pvu.VideoWriter)
    for f in frames:
        writer.write_frame(f)
    writer.close()
    streams = json.loads(subprocess.check_output(
        ['ffprobe', '-v', 'error', '-show_streams', '-of', 'json', out]))
    assert any(s['codec_type'] == 'audio' for s in streams['streams'])


# ---------------------------------------------------------------------------
# restore_video_frames, port vs JAX
# ---------------------------------------------------------------------------
class _Det:
    """Faces as landmarks in fractions of the frame, for both packages'
    helpers: detect_faces and batched_detect_faces scale them to the
    frames they are handed (the detector-sized copies)."""

    def __init__(self, faces):
        self.faces = faces

    def detect_faces(self, img, conf_threshold=0.8):
        h, w = img.shape[:2]
        rows = []
        for lm in self.faces:
            p = (lm * [w, h]).astype(np.float32)
            rows.append([p[:, 0].min() - 0.02 * w, p[:, 1].min() - 0.05 * h,
                         p[:, 0].max() + 0.02 * w, p[:, 1].max() + 0.03 * h,
                         0.99, *p.reshape(-1)])
        return np.asarray(rows, np.float32).reshape(-1, 15)

    def batched_detect_faces(self, frames, conf_threshold=0.8):
        return [self.detect_faces(f) for f in frames]


# two faces a frame in a 512 x 683 frame (the clip's 96 x 128 upscaled)
VIDEO_FACES = [(TEMPLATE * s + [x, y]) / [683, 512]
               for s, x, y in ((0.3, 120, 90), (0.4, 380, 200))]


def _parse_stub(faces):
    """The same parse ids for both helpers (ParseNet itself is held
    against JAX in test_torch_classic.py): skin in a box, a hole the
    colormap zeroes, varying with the face so faces differ."""
    ids = np.zeros((len(faces), 512, 512), np.int64)
    for i, f in enumerate(faces):
        ids[i, 80:440, 90:420] = 1 + int(f.mean()) % 13
        ids[i, 300:340, 200:300] = 14
    return ids


@pytest.fixture(scope='module')
def restorers():
    env = {k: v for k, v in os.environ.items() if k != 'CODEFORMER_COLPACK'}
    with mock.patch.dict(os.environ, env, clear=True):
        jr = JRestorer(model=JCodeFormer(**TINY), dtype=jnp.float32,
                       face_size=FACE, batch_buckets=(1, 2, 4, 8))
    pm = CodeFormer(**TINY)
    pm.load_state_dict(flax_to_state_dict(jr.variables))
    pr = CodeFormerRestorer(device='cpu', dtype=torch.float32, model=pm,
                            face_size=FACE, batch_buckets=(1, 2, 4, 8))
    return jr, pr


def _helper(mod, compositor, **kw):
    h = mod.FaceRestoreHelper(2, face_size=FACE, use_parse=True,
                              allow_random_weights=True,
                              detector=_Det(VIDEO_FACES),
                              compositor=compositor, **kw)
    h._parse_masks = _parse_stub
    return h


@pytest.mark.parametrize('compositor', ['xla', 'cv2'])
def test_restore_video_frames_matches_jax(tmp_path, restorers, compositor):
    jr, pr = restorers
    frames = _clip(tmp_path / 'clip.avi')
    want = jvideo.restore_video_frames(
        list(frames), jr, _helper(jfh, compositor), w=0.5, upscale=2,
        detect_chunk=3)
    got = pvideo.restore_video_frames(
        list(frames), pr, _helper(pfh, compositor, device='cpu'), w=0.5,
        upscale=2, detect_chunk=3)
    assert len(got) == len(want) == 4
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape == (1024, 1366, 3) and g.dtype == np.uint8
        diff = np.abs(g.astype(np.float32) - w_.astype(np.float32))
        print(f'{compositor}: frame |diff| mean {diff.mean():.5f} max '
              f'{diff.max():.0f}')
        assert diff.mean() <= FRAME_MEAN_BOUND, diff.mean()
        assert diff.max() <= FRAME_MAX_BOUND, diff.max()
    # the faces changed the frames: not the plain upscale
    plain = cv2.resize(cv2.resize(frames[0], (683, 512)), (1366, 1024))
    assert np.abs(got[0].astype(int) - plain.astype(int)).max() > 30


def test_restore_video_frames_only_center_and_empty(restorers):
    _, pr = restorers
    h = _helper(pfh, 'xla', device='cpu')
    assert pvideo.restore_video_frames([], pr, h) == []
    calls = []
    real = pr.restore_batch

    def spy(faces, **kw):
        calls.append(len(faces))
        return real(faces, **kw)

    frames = [np.full((512, 640, 3), 90, np.uint8)] * 3
    with mock.patch.object(pr, 'restore_batch', spy):
        out = pvideo.restore_video_frames(frames, pr, h,
                                          only_center_face=True)
    assert calls == [3]          # ONE restoration batch, a face a frame
    # pasted at the helper's upscale factor, as in the JAX package
    assert [o.shape for o in out] == [(1024, 1280, 3)] * 3


# ---------------------------------------------------------------------------
# the CLI's video routes
# ---------------------------------------------------------------------------
def test_cli_main_streams_video_lazily(tmp_path, monkeypatch):
    """main() on a video hands run_whole_images a lazy frame stream
    (bounded memory) and the video's frame rate."""
    _clip(tmp_path / 'clip.avi', n=5)
    seen = {}

    def spy_run(args, input_img_list, result_root, restorer, input_video,
                video_meta=None):
        seen['lazy'] = not isinstance(input_img_list, list)
        seen['n'] = len(list(input_img_list))
        seen['video'] = input_video
        seen['meta'] = video_meta
        seen['root'] = result_root

    class _NoopRestorer:
        def __init__(self, **kw):
            pass

    import codeformer_tpu_torch.pipeline as pipeline
    monkeypatch.setattr(pipeline, 'CodeFormerRestorer', _NoopRestorer)
    monkeypatch.setattr(wi, 'run_whole_images', spy_run)
    monkeypatch.chdir(tmp_path)
    cli.main(['-i', str(tmp_path / 'clip.avi'), '-w', '0.5',
              '--random-init', '--device', 'cpu'])
    assert seen == {'lazy': True, 'n': 5, 'video': True,
                    'meta': {'fps': 12.0, 'audio': str(tmp_path / 'clip.avi')},
                    'root': 'results/clip_0.5'}


def test_cli_rejects_unreadable_video(tmp_path):
    (tmp_path / 'bad.mp4').write_bytes(b'not a video')
    with pytest.raises((RuntimeError, FileNotFoundError)):
        cli._open_video_stream(str(tmp_path / 'bad.mp4'))


def _args(path, **kw):
    a = dict(bg_upsampler='None', face_upsample=False, upscale=2,
             detection_model='retinaface_resnet50', fidelity_weight=0.5,
             input_path=str(path), draw_box=False, suffix=None,
             only_center_face=False, random_init=True, save_video_fps=None,
             fused_pipeline='auto', parse_res=256, compositor='xla')
    a.update(kw)
    return SimpleNamespace(**a)


class _StubPipeline:
    """The fused pipeline's streaming surface: 2x nearest upscale."""
    calls = []

    def __init__(self, restorer, helper, **kw):
        pass

    def restore_frames_stream(self, frames_iter):
        n = 0
        for f in frames_iter:
            n += 1
            yield np.repeat(np.repeat(f, 2, 0), 2, 1)
        _StubPipeline.calls.append(n)


class _StubRestorer:
    device = torch.device('cpu')
    face_size = 512


def test_fused_video_streams_through_pipeline(tmp_path, monkeypatch):
    """The fused video branch consumes a generator end to end: a PNG a
    frame, the video written as the frames come (--save_video_fps wins
    over the source's rate)."""
    monkeypatch.setattr(pfh, 'FaceRestoreHelper',
                        lambda *a, **kw: SimpleNamespace(**kw))
    monkeypatch.setattr(pdp, 'DeviceRestorePipeline', _StubPipeline)
    _StubPipeline.calls = []
    rng = np.random.default_rng(0)
    pulled = []

    def frame_gen():
        for i in range(4):
            pulled.append(i)
            yield rng.integers(0, 255, (96, 128, 3)).astype(np.uint8)

    out = tmp_path / 'out'
    wi.run_whole_images(_args(tmp_path / 'clip.mp4', save_video_fps=6.0),
                        frame_gen(), str(out), _StubRestorer(),
                        input_video=True,
                        video_meta={'fps': 24.0, 'audio': None})
    assert _StubPipeline.calls == [4] and pulled == [0, 1, 2, 3]
    assert sorted(os.listdir(out / 'final_results')) == \
        [f'{i:06d}.png' for i in range(4)]
    cap = cv2.VideoCapture(str(out / 'clip.mp4'))
    assert cap.get(cv2.CAP_PROP_FPS) == 6.0
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 4
    assert (cap.get(cv2.CAP_PROP_FRAME_WIDTH),
            cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == (256, 192)
    cap.release()


class _InjectedDetector(_Det):
    """The classic path's detector (host detect_faces and
    batched_detect_faces), built by the helper through
    init_detection_model."""

    def __init__(self, *a, **kw):
        super().__init__(VIDEO_FACES)


class _InvertRestorer:
    """Records restore_batch calls; inverts the faces."""
    device = torch.device('cpu')
    face_size = 512
    calls = []

    def restore_batch(self, faces, w=0.5, adain=True, enable_fuse=None):
        _InvertRestorer.calls.append(len(faces))
        return [255 - f for f in faces]


@pytest.mark.parametrize('draw_box', [False, True])
def test_classic_video_path(tmp_path, monkeypatch, draw_box):
    """--fused_pipeline off on a video: the classic batched video path
    (one restoration batch over every frame's faces), or with --draw_box
    the classic per-image passes; final_results/ and the video either
    way, the green box only with --draw_box."""
    monkeypatch.setattr(pdet, 'init_detection_model',
                        lambda *a, **kw: _InjectedDetector())
    monkeypatch.setattr(pfh.FaceRestoreHelper, '_parse_masks',
                        lambda self, faces: _parse_stub(faces))
    _InvertRestorer.calls = []
    frames = _clip(tmp_path / 'clip.avi', n=3)
    out = tmp_path / 'out'
    wi.run_whole_images(_args(tmp_path / 'clip.avi', fused_pipeline='off',
                              draw_box=draw_box),
                        iter(frames), str(out), _InvertRestorer(),
                        input_video=True,
                        video_meta={'fps': 12.0, 'audio': None})
    assert _InvertRestorer.calls == [6]
    assert sorted(os.listdir(out / 'final_results')) == \
        [f'{i:06d}.png' for i in range(3)]
    assert (out / 'clip.mp4').exists()
    final = cv2.imread(str(out / 'final_results' / '000000.png'))
    assert final.shape == (1024, 1366, 3)
    green = ((final[..., 1] == 255) & (final[..., 0] == 0)
             & (final[..., 2] == 0)).sum()
    assert (green > 100) == draw_box
    if draw_box:   # the per-image passes also save the faces
        assert len(os.listdir(out / 'cropped_faces')) == 6

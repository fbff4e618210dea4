"""Routing of the port's whole-image CLI (codeformer_tpu_torch/cli/
whole_image.py), after tests/test_whole_image_batched.py: a uniform
folder and a video take the fused device pipeline; gray images, mixed
sizes, --draw_box and --fused_pipeline off take the classic per-stage
path (auto says why, on raises); the other detectors and the upsamplers
raise "not ported yet"; and runs of the CLI end to end on the CPU, fused
and classic, write cropped_faces/, restored_faces/ and final_results/
with the JAX CLI's names."""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip('cv2')

import codeformer_tpu_torch.cli.whole_image as wi  # noqa: E402
from codeformer_tpu_torch.cli import inference_codeformer as cli  # noqa: E402
from codeformer_tpu_torch.pipeline import detector as pdet  # noqa: E402
from codeformer_tpu_torch.pipeline import device_pipeline as pdp  # noqa: E402
from codeformer_tpu_torch.pipeline import face_helper as pfh  # noqa: E402

TEMPLATE = np.array(
    [[192.98138, 239.94708], [318.90277, 240.1936], [256.63416, 314.01935],
     [201.26117, 371.41043], [313.08905, 371.15118]], np.float32)


class _StubHelper:
    """The classic surface of FaceRestoreHelper: one face a image (its
    top-left 64 x 64 corner, resized to 512), pasted back by a plain 2x
    upscale; records each paste's draw_box and the gray flags."""
    pastes = []

    def __init__(self, upscale_factor, **kw):
        self.kw = kw
        self.upscale_factor = upscale_factor
        self.use_parse = True
        self.is_gray = False
        self._precomputed_parse_ids = None
        self.clean_all()

    def clean_all(self):
        self.cropped_faces = []
        self.restored_faces = []
        self.inverse_affine_matrices = []

    def read_image(self, img):
        self.input_img = img
        self.is_gray = bool((img[..., 0] == img[..., 1]).all())

    def get_face_landmarks_5(self, **kw):
        return 1

    def align_warp_face(self, *a, **kw):
        self.cropped_faces = [cv2.resize(self.input_img[:64, :64],
                                         (512, 512))]

    def get_inverse_affine(self, _):
        self.inverse_affine_matrices = [np.eye(2, 3, dtype=np.float32)]

    def add_restored_face(self, face, input_face=None):
        self.restored_faces.append(face)

    def _parse_masks(self, faces):
        return np.ones((len(faces), 512, 512), np.int64)

    def paste_faces_to_input_image(self, upsample_img=None, draw_box=False,
                                   face_upsampler=None):
        _StubHelper.pastes.append((draw_box, self.is_gray,
                                   self._precomputed_parse_ids.shape))
        return np.repeat(np.repeat(self.input_img, 2, 0), 2, 1)


class _StubPipeline:
    """Records restore_frames calls; 2x nearest upscale, one face a
    frame."""
    calls = []

    def __init__(self, restorer, helper, **kw):
        self.kw = kw

    def restore_frames(self, frames, return_faces=False):
        _StubPipeline.calls.append(len(frames))
        up = [np.repeat(np.repeat(f, 2, 0), 2, 1) for f in frames]
        faces = [[(f[:64, :64].copy(), 255 - f[:64, :64])] for f in frames]
        return (up, faces) if return_faces else up

    def restore_frames_stream(self, frames_iter):
        frames = list(frames_iter)
        _StubPipeline.calls.append(len(frames))
        for f in frames:
            yield np.repeat(np.repeat(f, 2, 0), 2, 1)


class _StubRestorer:
    """The restorer's device surface: inverts the crops."""
    device = torch.device('cpu')
    face_size = 512
    calls = []

    def __init__(self, **kw):
        pass

    def restore_device(self, x, w=0.5, adain=True, enable_fuse=None):
        return 255 - torch.as_tensor(x)

    def restore_batch(self, faces, w=0.5, adain=True, enable_fuse=None):
        _StubRestorer.calls.append(len(faces))
        return [255 - f for f in faces]


def _args(in_dir, fused='auto', detection='retinaface_resnet50', **kw):
    a = dict(bg_upsampler='None', face_upsample=False, upscale=2,
             detection_model=detection, fidelity_weight=0.5,
             input_path=str(in_dir), draw_box=False, suffix=None,
             only_center_face=False, random_init=True,
             save_video_fps=None, fused_pipeline=fused, parse_res=256)
    a.update(kw)
    return SimpleNamespace(**a)


def _folder(tmp_path, shapes, gray=False):
    in_dir = tmp_path / 'in'
    in_dir.mkdir()
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(shapes):
        img = rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)
        if gray:
            img = np.repeat(img[..., :1], 3, axis=-1)
        cv2.imwrite(str(in_dir / f'{i:02d}.png'), img)
    return in_dir, sorted(str(p) for p in in_dir.iterdir())


@pytest.fixture
def stubs(monkeypatch):
    monkeypatch.setattr(pfh, 'FaceRestoreHelper', _StubHelper)
    monkeypatch.setattr(pdp, 'DeviceRestorePipeline', _StubPipeline)
    _StubPipeline.calls = []
    _StubHelper.pastes = []
    _StubRestorer.calls = []


def test_fused_auto_routes_uniform_folder(tmp_path, stubs):
    in_dir, paths = _folder(tmp_path, [(80, 96)] * 3)
    out = tmp_path / 'out'
    wi.run_whole_images(_args(in_dir), paths, str(out), _StubRestorer(),
                        input_video=False)
    assert _StubPipeline.calls == [3]
    assert sorted(os.listdir(out / 'final_results')) == \
        [f'{i:02d}.png' for i in range(3)]
    assert sorted(os.listdir(out / 'restored_faces')) == \
        [f'{i:02d}_00.png' for i in range(3)]
    assert sorted(os.listdir(out / 'cropped_faces')) == \
        [f'{i:02d}_00.png' for i in range(3)]


def test_suffix_names(tmp_path, stubs):
    in_dir, paths = _folder(tmp_path, [(80, 96)])
    out = tmp_path / 'out'
    wi.run_whole_images(_args(in_dir, suffix='x'), paths, str(out),
                        _StubRestorer(), input_video=False)
    assert os.listdir(out / 'final_results') == ['00_x.png']
    assert os.listdir(out / 'restored_faces') == ['00_00_x.png']
    assert os.listdir(out / 'cropped_faces') == ['00_00.png']


@pytest.mark.parametrize('case', ['yolo_on', 'yolo_auto', 'realesrgan',
                                  'face_upsample'])
def test_unported_inputs_raise(tmp_path, stubs, case):
    """Nothing falls back silently: each raises and names the ROADMAP
    item; neither path runs."""
    in_dir, paths = _folder(tmp_path, [(80, 96)])
    kw = {'yolo_on': dict(fused='on', detection='YOLOv5n'),
          'yolo_auto': dict(detection='YOLOv5l'),
          'realesrgan': dict(bg_upsampler='realesrgan'),
          'face_upsample': dict(face_upsample=True)}[case]
    with pytest.raises(NotImplementedError, match='not ported yet') as e:
        wi.run_whole_images(_args(in_dir, **kw), paths,
                            str(tmp_path / 'out'), _StubRestorer(),
                            input_video=False)
    assert 'ROADMAP.md Queue 1 item 3' in str(e.value)
    assert _StubPipeline.calls == [] and _StubRestorer.calls == []


@pytest.mark.parametrize('case', ['mixed_sizes', 'gray', 'off', 'draw_box'])
def test_classic_path_serves(tmp_path, stubs, capsys, case):
    """What the fused pipeline cannot take goes the classic per-stage
    way: ONE restoration stream over every image's faces, one parse
    stream, a paste a image (with draw_box when asked, the gray flag
    carried), the JAX CLI's names; auto prints why it fell back."""
    shapes = [(80, 96), (96, 80), (80, 96)] if case == 'mixed_sizes' \
        else [(80, 96)] * 3
    in_dir, paths = _folder(tmp_path, shapes, gray=case == 'gray')
    kw = {'off': dict(fused='off'),
          'draw_box': dict(draw_box=True)}.get(case, {})
    out = tmp_path / 'out'
    wi.run_whole_images(_args(in_dir, **kw), paths, str(out),
                        _StubRestorer(), input_video=False)
    assert _StubPipeline.calls == []
    assert _StubRestorer.calls == [3]
    assert _StubHelper.pastes == [(case == 'draw_box', case == 'gray',
                                   (1, 512, 512))] * 3
    reason = {'mixed_sizes': 'differ in size', 'gray': 'grayscale',
              'draw_box': 'draw_box'}.get(case)
    said = capsys.readouterr().out
    assert ('using the classic per-stage path' in said) == (reason is not None)
    if reason:
        assert reason in said
    for sub, names in (('final_results', ['{i:02d}.png']),
                       ('cropped_faces', ['{i:02d}_00.png']),
                       ('restored_faces', ['{i:02d}_00.png'])):
        assert sorted(os.listdir(out / sub)) == \
            [n.format(i=i) for i in range(3) for n in names]
    img0 = cv2.imread(paths[0])
    np.testing.assert_array_equal(
        cv2.imread(str(out / 'final_results' / '00.png')),
        np.repeat(np.repeat(img0, 2, 0), 2, 1))


def test_fused_on_raises_for_what_it_cannot_serve(tmp_path, stubs):
    in_dir, paths = _folder(tmp_path, [(80, 96), (96, 80)])
    with pytest.raises(RuntimeError, match='differ in size'):
        wi.run_whole_images(_args(in_dir, fused='on'), paths,
                            str(tmp_path / 'out'), _StubRestorer(),
                            input_video=False)
    assert _StubPipeline.calls == [] and _StubRestorer.calls == []


def test_video_takes_the_fused_stream(tmp_path, stubs):
    """A video with auto takes the fused pipeline's stream, a PNG a frame
    and the video."""
    rng = np.random.default_rng(0)
    frames = (rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
              for _ in range(3))
    out = tmp_path / 'out'
    wi.run_whole_images(_args(tmp_path / 'clip.mp4'), frames, str(out),
                        _StubRestorer(), input_video=True,
                        video_meta={'fps': 10.0, 'audio': None})
    assert _StubPipeline.calls == [3]
    assert sorted(os.listdir(out / 'final_results')) == \
        [f'{i:06d}.png' for i in range(3)]
    assert (out / 'clip.mp4').exists()


def test_fused_mode_and_list_inputs():
    from codeformer_tpu_torch.cli.common import list_inputs
    parse = cli.build_parser().parse_args
    assert parse(['--fused_pipeline']).fused_pipeline == 'on'
    assert parse([]).fused_pipeline == 'auto'
    with pytest.raises(SystemExit):
        parse(['--fused_pipeline', 'yes'])
    assert list_inputs('a/clip.mp4', 0.5) == (['a/clip.mp4'],
                                              'results/clip_0.5', True)
    assert list_inputs('a/b.png', 0.7) == (['a/b.png'],
                                           'results/test_img_0.7', False)


class _Injected(pdet.FaceDetector):
    """One face a frame, centred, in detector coordinates."""

    def __init__(self, *a, **kw):
        self.max_faces, self.pre_nms_topk = 8, 64
        self.device, self._graphs = torch.device('cpu'), {}

    def batched_detect_device_start(self, frames_dev, det_hw, **kw):
        return None

    def batched_detect_device_finish(self, frames_dev, det_hw, pending,
                                     **kw):
        b, h, w = frames_dev.shape[:3]
        lm = (TEMPLATE * 0.45 + np.array([w / 2 - 115, h / 2 - 140],
                                         np.float32)) * (det_hw[0] / h)
        dets = np.zeros((b, self.max_faces, 15), np.float32)
        dets[:, 0, :4] = [lm[:, 0].min() - 20, lm[:, 1].min() - 40,
                          lm[:, 0].max() + 20, lm[:, 1].max() + 30]
        dets[:, 0, 4] = 0.99
        dets[:, 0, 5:] = lm.reshape(-1)
        valid = np.zeros((b, self.max_faces), bool)
        valid[:, 0] = True
        return dets, valid


def test_cli_end_to_end_on_cpu(tmp_path, monkeypatch):
    """python -m codeformer_tpu_torch.cli.inference_codeformer -i <folder>
    --random-init --device cpu, without --has_aligned: two 96x128 images
    (upscaled to 512x683 first, as the reference does under 512), the
    real ParseNet (random weights) and device pipeline, a stub restorer
    and injected detections."""
    import codeformer_tpu_torch.pipeline as pipeline
    monkeypatch.setattr(pipeline, 'CodeFormerRestorer', _StubRestorer)
    monkeypatch.setattr(pdet, 'init_detection_model',
                        lambda *a, **kw: _Injected())
    in_dir, _ = _folder(tmp_path, [(96, 128)] * 2)
    out = tmp_path / 'out'
    cli.main(['-i', str(in_dir), '-o', str(out), '--random-init',
              '--device', 'cpu'])
    assert sorted(os.listdir(out)) == ['cropped_faces', 'final_results',
                                       'restored_faces']
    assert sorted(os.listdir(out / 'cropped_faces')) == \
        ['00_00.png', '01_00.png']
    assert sorted(os.listdir(out / 'restored_faces')) == \
        ['00_00.png', '01_00.png']
    assert sorted(os.listdir(out / 'final_results')) == \
        ['00.png', '01.png']
    final = cv2.imread(str(out / 'final_results' / '00.png'))
    crop = cv2.imread(str(out / 'cropped_faces' / '00_00.png'))
    restored = cv2.imread(str(out / 'restored_faces' / '00_00.png'))
    assert final.shape == (1024, 1366, 3)
    assert crop.shape == restored.shape == (512, 512, 3)
    np.testing.assert_array_equal(restored, 255 - crop)


class _HostInjected:
    """The classic path's detector: one face a image, centred, in the
    coordinates of the image it is handed."""

    def __init__(self, *a, **kw):
        pass

    def detect_faces(self, img, conf_threshold=0.8):
        h, w = img.shape[:2]
        s = min(h, w) / 512.0
        lm = TEMPLATE * 0.45 * s + np.array([w / 2 - 115 * s,
                                             h / 2 - 140 * s], np.float32)
        return np.concatenate([[lm[:, 0].min() - 20 * s,
                                lm[:, 1].min() - 40 * s,
                                lm[:, 0].max() + 20 * s,
                                lm[:, 1].max() + 30 * s, 0.99],
                               lm.reshape(-1)]).astype(np.float32)[None]


@pytest.mark.parametrize('compositor', ['xla', 'cv2'])
def test_cli_classic_end_to_end_on_cpu(tmp_path, monkeypatch, capsys,
                                       compositor):
    """python -m codeformer_tpu_torch.cli.inference_codeformer -i <folder
    of mixed sizes, one gray> --draw_box --compositor <c> --device cpu:
    the classic path with the real helper and ParseNet (random weights),
    a stub restorer and injected detections. The gray image's restored
    face comes back gray; the box is drawn; --profile reports the
    stages."""
    import codeformer_tpu_torch.pipeline as pipeline
    monkeypatch.setattr(pipeline, 'CodeFormerRestorer', _StubRestorer)
    monkeypatch.setattr(pdet, 'init_detection_model',
                        lambda *a, **kw: _HostInjected())
    in_dir = tmp_path / 'in'
    in_dir.mkdir()
    rng = np.random.default_rng(1)
    for name, (h, w) in (('a', (96, 128)), ('b', (128, 112))):
        lo = rng.uniform(30, 220, (h // 8, w // 8, 3))
        img = np.repeat(np.repeat(lo, 8, 0), 8, 1).astype(np.uint8)
        if name == 'b':
            img = np.repeat(img[..., :1], 3, axis=-1)
        cv2.imwrite(str(in_dir / f'{name}.png'), img)
    out = tmp_path / 'out'
    _StubRestorer.calls = []
    cli.main(['-i', str(in_dir), '-o', str(out), '--random-init',
              '--device', 'cpu', '--draw_box', '--compositor', compositor,
              '--profile'])
    assert _StubRestorer.calls == [2]
    said = capsys.readouterr().out
    assert 'draw_box requested' in said and 'Grayscale input: True' in said
    assert 'folder_restore' in said and 'folder_paste' in said
    assert sorted(os.listdir(out / 'final_results')) == ['a.png', 'b.png']
    assert sorted(os.listdir(out / 'restored_faces')) == \
        ['a_00.png', 'b_00.png']
    a = cv2.imread(str(out / 'final_results' / 'a.png'))
    b = cv2.imread(str(out / 'final_results' / 'b.png'))
    assert a.shape == (1024, 1366, 3) and b.shape == (1170, 1024, 3)
    for img in (a, b):   # the green box
        assert ((img[..., 1] == 255) & (img[..., 0] == 0)
                & (img[..., 2] == 0)).sum() > 100
    face_b = cv2.imread(str(out / 'restored_faces' / 'b_00.png'))
    assert (face_b[..., 0] == face_b[..., 1]).all()
    face_a = cv2.imread(str(out / 'restored_faces' / 'a_00.png'))
    crop_a = cv2.imread(str(out / 'cropped_faces' / 'a_00.png'))
    np.testing.assert_array_equal(face_a, 255 - crop_a)

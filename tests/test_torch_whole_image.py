"""Routing of the port's whole-image CLI (codeformer_tpu_torch/cli/
whole_image.py), after tests/test_whole_image_batched.py: a uniform
folder and a video take the fused device pipeline; gray images, mixed
sizes, --draw_box, a YOLOv5 detector, the Real-ESRGAN upsamplers and
--fused_pipeline off take the classic per-stage path (auto says why, on
raises), the upsamplers' routes against the JAX CLI's; and runs of the
CLI end to end on the CPU, fused and classic, write cropped_faces/,
restored_faces/ and final_results/ with the JAX CLI's names."""
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
from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer  # noqa: E402

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
    """The restorer's device surface: inverts the crops, in the batches
    of the restorer's default buckets."""
    device = torch.device('cpu')
    face_size = 512
    batch_buckets = (1, 2, 4, 8, 16)
    _bucket = CodeFormerRestorer._bucket
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


class _UpsamplingStubHelper(_StubHelper):
    """_StubHelper's surface for both CLIs, whose paste takes the
    background upsampler's image as its canvas (else a plain 2x), and
    with a face upsampler writes each upsampled face, subsampled to 64
    x 64, into the canvas's corner. Records the detector it was built
    for and what each paste was handed."""
    built = []

    def __init__(self, upscale_factor, **kw):
        super().__init__(upscale_factor, **kw)
        _UpsamplingStubHelper.built.append(kw.get('det_model'))

    def paste_faces_to_input_image(self, upsample_img=None, draw_box=False,
                                   face_upsampler=None):
        _StubHelper.pastes.append((upsample_img is not None,
                                   face_upsampler is not None,
                                   self._precomputed_parse_ids is None))
        canvas = np.repeat(np.repeat(self.input_img, 2, 0), 2, 1) \
            if upsample_img is None else upsample_img.copy()
        if face_upsampler is not None:
            for face in self.restored_faces:
                up, _ = face_upsampler.enhance(face,
                                               outscale=self.upscale_factor)
                assert up.shape == (1024, 1024, 3)
                canvas[:64, :64] = up[::16, ::16]
        return canvas


ROUTES = {  # case: (CLI arguments, what the JAX CLI does)
    'yolo_on': (dict(fused='on', detection='YOLOv5n'), 'raises'),
    'yolo_auto': (dict(detection='YOLOv5l'), 'classic'),
    'realesrgan': (dict(bg_upsampler='realesrgan', bg_tile=64), 'classic'),
    'face_upsample': (dict(face_upsample=True, bg_tile=256), 'classic'),
}


@pytest.mark.parametrize('case', sorted(ROUTES))
def test_detectors_and_upsamplers_route_as_jax(tmp_path, stubs, monkeypatch,
                                               capsys, case):
    """A YOLOv5 detector or an upsampler keeps the fused pipeline out:
    with --fused_pipeline on both CLIs raise RuntimeError, with auto both
    say why and take the classic path; the upsamplers (a narrow RRDBNet
    with the same weights in both CLIs' set_realesrgan, tiles of
    --bg_tile) are called there, and the port writes the JAX CLI's files, the final
    images within 1 level."""
    import codeformer_tpu.cli.whole_image as jwi
    from codeformer_tpu.pipeline import realesrgan as jesr
    from codeformer_tpu_torch.pipeline import realesrgan as pesr
    from test_torch_realesrgan import _pair
    kw, route = ROUTES[case]
    ju, pu = _pair(tile=kw.get('bg_tile', 64), tile_pad=8)
    made = []
    monkeypatch.setattr(jesr, 'set_realesrgan',
                        lambda **a: made.append('jax') or ju)
    monkeypatch.setattr(pesr, 'set_realesrgan',
                        lambda **a: made.append('port') or pu)
    monkeypatch.setattr(jwi, 'FaceRestoreHelper', _UpsamplingStubHelper)
    monkeypatch.setattr(pfh, 'FaceRestoreHelper', _UpsamplingStubHelper)
    _UpsamplingStubHelper.built = []
    in_dir, paths = _folder(tmp_path, [(80, 96)] * 2)
    outs = {}
    for name, run in (('jax', jwi.run_whole_images),
                      ('port', wi.run_whole_images)):
        out = tmp_path / name
        args = _args(in_dir, **kw)
        if route == 'raises':
            with pytest.raises(RuntimeError,
                               match='YOLOv5n keeps host preprocessing'):
                run(args, paths, str(out), _StubRestorer(),
                    input_video=False)
            continue
        run(args, paths, str(out), _StubRestorer(), input_video=False)
        said = capsys.readouterr().out
        reason = 'keeps host preprocessing' if case == 'yolo_auto' \
            else 'bg/face upsampler requested'
        assert reason in said and 'using the classic per-stage path' in said
        outs[name] = out
    assert _StubPipeline.calls == []
    if route == 'raises':
        assert _StubRestorer.calls == [] and _StubHelper.pastes == []
        return
    assert _StubRestorer.calls == [2, 2]       # one stream a CLI
    assert _UpsamplingStubHelper.built == [kw.get('detection',
                                                  'retinaface_resnet50')] * 2
    bg, face = case == 'realesrgan', case == 'face_upsample'
    # with a face upsampler the faces are parsed at their paste
    assert _StubHelper.pastes == [(bg, face, face)] * 4
    assert made == (['jax', 'port'] if bg or face else [])
    for sub in ('final_results', 'restored_faces', 'cropped_faces'):
        names = sorted(os.listdir(outs['jax'] / sub))
        assert sorted(os.listdir(outs['port'] / sub)) == names and names
        for n in names:
            want = cv2.imread(str(outs['jax'] / sub / n)).astype(int)
            got = cv2.imread(str(outs['port'] / sub / n)).astype(int)
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= (1 if sub == 'final_results'
                                                 else 0), (sub, n)
    final = cv2.imread(str(outs['port'] / 'final_results' / '00.png'))
    plain = np.repeat(np.repeat(cv2.imread(paths[0]), 2, 0), 2, 1)
    assert (np.abs(final.astype(int) - plain).max() > 30) == (bg or face)


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


def test_cli_yolo_and_upsamplers_end_to_end_matches_jax(tmp_path,
                                                        monkeypatch):
    """run_whole_images with --detection_model YOLOv5n --bg_upsampler
    realesrgan --face_upsample in both CLIs: the real helpers and YOLOv5n
    (the JAX detector's seeded weights in both; they find no face in a
    noise image at the 0.8 threshold), the narrow RRDBNet in both
    set_realesrgan (tiles of 400), a stub restorer. The port writes the
    JAX CLI's final image within 1 level: the background upsampled
    from 512 x 683 to 1024 x 1366."""
    import codeformer_tpu.cli.whole_image as jwi
    from codeformer_tpu.pipeline import detector as jdet
    from codeformer_tpu.pipeline import realesrgan as jesr
    from codeformer_tpu_torch.pipeline import realesrgan as pesr
    from codeformer_tpu_torch.utils.convert import flax_to_state_dict
    from test_torch_realesrgan import _pair
    jd = jdet.YoloFaceDetector('YOLOv5n', allow_random=True)
    pd = pdet.YoloFaceDetector('YOLOv5n', allow_random=True, device='cpu')
    pd.model.load_state_dict(flax_to_state_dict(
        jd.variables, like=pd.model.state_dict()))
    monkeypatch.setattr(jdet, 'init_detection_model', lambda *a, **k: jd)
    monkeypatch.setattr(pdet, 'init_detection_model', lambda *a, **k: pd)
    ju, pu = _pair(tile=400, tile_pad=40)
    monkeypatch.setattr(jesr, 'set_realesrgan', lambda **a: ju)
    monkeypatch.setattr(pesr, 'set_realesrgan', lambda **a: pu)
    in_dir, paths = _folder(tmp_path, [(96, 128)])
    finals = []
    for name, run in (('jax', jwi.run_whole_images),
                      ('port', wi.run_whole_images)):
        out = tmp_path / name
        run(_args(in_dir, detection='YOLOv5n', bg_upsampler='realesrgan',
                  face_upsample=True, bg_tile=400, compositor='xla'),
            paths, str(out), _StubRestorer(), input_video=False)
        finals.append(cv2.imread(str(out / 'final_results' / '00.png')))
        assert sorted(os.listdir(out)) == ['final_results']   # no face
    want, got = finals
    assert got.shape == want.shape == (1024, 1366, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert want.std() > 10

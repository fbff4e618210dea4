"""Routing of the port's whole-image CLI (codeformer_tpu_torch/cli/
whole_image.py), after tests/test_whole_image_batched.py: a uniform
folder takes the fused device pipeline; what only the classic per-stage
or the video path could serve raises "not ported yet" instead of being
routed elsewhere; and one run of the CLI end to end on the CPU writes
cropped_faces/, restored_faces/ and final_results/ with the JAX CLI's
names."""
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
    def __init__(self, upscale_factor, **kw):
        self.kw = kw


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


class _StubRestorer:
    """The restorer's device surface: inverts the crops."""
    device = torch.device('cpu')
    face_size = 512

    def __init__(self, **kw):
        pass

    def restore_device(self, x, w=0.5, adain=True, enable_fuse=None):
        return 255 - torch.as_tensor(x)


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


@pytest.mark.parametrize('case', ['mixed_sizes', 'gray', 'video', 'off',
                                  'draw_box', 'yolo_on', 'realesrgan'])
def test_unported_inputs_raise(tmp_path, stubs, case):
    """Nothing falls back silently: each raises and names the ROADMAP
    item; the fused pipeline never runs."""
    shapes = [(80, 96), (96, 80)] if case == 'mixed_sizes' else [(80, 96)]
    in_dir, paths = _folder(tmp_path, shapes, gray=case == 'gray')
    kw = {'off': dict(fused='off'), 'draw_box': dict(draw_box=True),
          'yolo_on': dict(fused='on', detection='YOLOv5n'),
          'realesrgan': dict(bg_upsampler='realesrgan')}.get(case, {})
    video = case == 'video'
    if video:
        paths = [str(tmp_path / 'clip.mp4')]
    with pytest.raises(NotImplementedError, match='not ported yet') as e:
        wi.run_whole_images(_args(in_dir, **kw), paths,
                            str(tmp_path / 'out'), _StubRestorer(),
                            input_video=video)
    assert 'ROADMAP.md Queue 1 item' in str(e.value)
    assert _StubPipeline.calls == []


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

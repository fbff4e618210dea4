"""The port's crop_align_face (codeformer_tpu_torch/cli/crop_align_face.py)
against the JAX script (scripts/crop_align_face.py), run in process on
the same seeded images. Random detector weights find no faces, so both
detectors are replaced by one stub that hands each image seeded
detections (several faces, landmarks jittered about a face template),
as tests/test_torch_whole_image.py injects them.

Tolerance: the largest-face pick equals JAX's on every detection set
(ties, one face, none), and the written crops EQUAL the JAX script's
byte for byte (the same landmarks, the same float64 quad and similarity
solve, the same cv2 warp).
"""
import importlib.util
import os
import sys
from unittest import mock

import numpy as np
import pytest

pytest.importorskip('torch')
cv2 = pytest.importorskip('cv2')

from codeformer_tpu_torch.cli import crop_align_face as cal  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def jax_script():
    spec = importlib.util.spec_from_file_location(
        'jax_crop_align_face', os.path.join(ROOT, 'scripts',
                                            'crop_align_face.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _detections(rng, n_faces, h, w):
    """(n, 15) rows: box, score, 5 landmarks about a face template."""
    rows = []
    for _ in range(n_faces):
        s = rng.uniform(40, 90)
        x0, y0 = rng.uniform(0, w - s), rng.uniform(0, h - 1.2 * s)
        tmpl = np.array([[0.3, 0.4], [0.7, 0.4], [0.5, 0.6], [0.35, 0.8],
                         [0.65, 0.8]]) * [s, 1.2 * s] + [x0, y0]
        lm = tmpl + rng.normal(0, 0.02 * s, tmpl.shape)
        rows.append(np.concatenate([[x0, y0, x0 + s, y0 + 1.2 * s, 0.99],
                                    lm.reshape(-1)]))
    return np.asarray(rows, np.float32).reshape(-1, 15)


class StubDetector:
    """detect_faces(img) hands out the detections of the image, keyed by
    its bytes."""

    def __init__(self, by_image):
        self.by_image = by_image

    def detect_faces(self, img, conf_threshold=0.8):
        assert conf_threshold == 0.8
        return self.by_image[img.tobytes()]


def test_largest_face_pick_equals_jax(jax_script):
    rng = np.random.default_rng(0)
    img = np.zeros((8, 8, 3), np.uint8)
    sets = [_detections(rng, n, 300, 400) for n in (0, 1, 2, 5, 9)]
    tie = _detections(rng, 3, 300, 400)
    tie[2, :4] = tie[0, :4] + 5.0         # the same area as face 0
    sets.append(tie)
    for rows in sets:
        det = StubDetector({img.tobytes(): rows})
        want = jax_script.get_landmarks_retinaface(det, img)
        got = cal.get_landmarks_retinaface(det, img)
        if want is None:
            assert got is None and rows.shape[0] == 0
        else:
            np.testing.assert_array_equal(got, want)
            assert got.shape == (5, 2)


def test_crops_equal_the_jax_scripts(jax_script, tmp_path):
    rng = np.random.default_rng(1)
    src = tmp_path / 'imgs'
    src.mkdir()
    by_image = {}
    for i, (h, w, n) in enumerate([(300, 400, 3), (256, 256, 1),
                                   (320, 240, 0), (300, 420, 4)]):
        lo = rng.uniform(0, 255, (h // 20 + 1, w // 20 + 1, 3))
        img = cv2.resize(lo, (w, h), interpolation=cv2.INTER_CUBIC)
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255) \
            .astype(np.uint8)
        name = f'{i:02d}.png' if i != 3 else f'{i:02d}.jpg'
        cv2.imwrite(str(src / name), img)
        by_image[cv2.imread(str(src / name)).tobytes()] = \
            _detections(rng, n, h, w)
    stub = StubDetector(by_image)
    out_port, out_jax = tmp_path / 'port', tmp_path / 'jax'
    with mock.patch.object(cal, 'init_detection_model',
                           return_value=stub) as init:
        cal.main(['-i', str(src), '-o', str(out_port), '--output_size',
                  '128', '--device', 'cpu'])
    assert init.call_args.kwargs['device'] == 'cpu'
    import codeformer_tpu.pipeline.detector as jdet
    with mock.patch.object(jdet, 'init_detection_model',
                           return_value=stub), \
            mock.patch.object(sys, 'argv', [
                'crop_align_face.py', '-i', str(src), '-o', str(out_jax),
                '--output_size', '128']):
        jax_script.main()
    names = sorted(os.listdir(out_jax))
    assert names == ['00.png', '01.png', '03.png']     # 02 has no face
    assert sorted(os.listdir(out_port)) == names
    for n in names:
        got = cv2.imread(str(out_port / n))
        assert got.shape == (128, 128, 3)
        np.testing.assert_array_equal(got, cv2.imread(str(out_jax / n)))


def test_defaults_and_dlib_refusal(monkeypatch):
    """--device defaults to cuda, the landmark source to retinaface; the
    dlib source exits naming what is missing."""
    args = cal.build_parser().parse_args([])
    assert (args.device, args.landmark_source, args.output_size) == \
        ('cuda', 'retinaface', 512)
    monkeypatch.setitem(sys.modules, 'dlib', None)
    with pytest.raises(SystemExit, match='dlib'):
        cal.make_dlib_landmarker()

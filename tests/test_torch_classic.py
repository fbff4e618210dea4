"""The port's classic per-stage whole-image path against the JAX
package's: the host copies (align_trans, face_utils,
normalize_img_dtype, the profiler), FaceRestoreHelper's per-image methods on the
same images and injected detections, the device compositor `paste_faces`
against `paste_faces_xla`, and the port's own device compositor against
its cv2 oracle within the JAX package's bounds (tests/test_compositor.py).

Where both sides go through cv2 and numpy (landmarks, affines, crops,
inverse affines, the gray adaptation, the cv2 compositor) the results
are held equal bit for bit. The device compositors sum fp32 blurs and
warps in another order, and the result is truncated to uint8 as JAX's
astype does, so a pixel may land one level apart: held within 1 level.
"""
import sys
import types

import numpy as np
import pytest
import torch

import jax

cv2 = pytest.importorskip('cv2')

from codeformer_tpu.pipeline import align_trans as jat  # noqa: E402
from codeformer_tpu.pipeline import face_helper as jfh  # noqa: E402
from codeformer_tpu.pipeline import face_utils as jfu  # noqa: E402
from codeformer_tpu.utils import img_util as jimg  # noqa: E402
from codeformer_tpu.utils import profiler as jprof  # noqa: E402
from codeformer_tpu_torch.pipeline import align_trans as pat  # noqa: E402
from codeformer_tpu_torch.pipeline import face_helper as pfh  # noqa: E402
from codeformer_tpu_torch.pipeline import face_utils as pfu  # noqa: E402
from codeformer_tpu_torch.utils import img_util as pimg  # noqa: E402
from codeformer_tpu_torch.utils import profiler as pprof  # noqa: E402
from codeformer_tpu_torch.utils.convert import flax_to_state_dict  # noqa: E402

torch.set_num_threads(2)
TEMPLATE = np.array(
    [[192.98138, 239.94708], [318.90277, 240.1936], [256.63416, 314.01935],
     [201.26117, 371.41043], [313.08905, 371.15118]], np.float32)
# the paste of a Real-ESRGAN-upsampled face, port vs JAX: faces a level
# apart where a rounding flips, then the device compositors' own level
REALESRGAN_PASTE_MAX = 2


# ---------------------------------------------------------------------------
# the host copies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('args', [
    (None, 0.0, (0, 0), False), (None, 0.0, (0, 0), True),
    ((112, 112), 0.0, (0, 0), True), ((128, 128), 0.0, (8, 8), True),
    ((112, 112), 0.25, (0, 0), True)])
def test_reference_facial_points_match_jax(args):
    np.testing.assert_array_equal(pat.get_reference_facial_points(*args),
                                  jat.get_reference_facial_points(*args))


def test_reference_facial_points_raise_as_jax():
    for mod in (pat, jat):
        with pytest.raises(ValueError):
            mod.get_reference_facial_points((100, 120), 0.0, (0, 0), False)
        with pytest.raises(ValueError):
            mod.get_reference_facial_points((112, 112), 1.5, (0, 0), True)


@pytest.mark.parametrize('align_type', ['smilarity', 'affine'])
def test_warp_and_crop_face_matches_jax(align_type):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (160, 200, 3), dtype=np.uint8)
    lm = TEMPLATE * 0.25 + rng.normal(0, 1.5, (5, 2)) + [30.0, -20.0]
    src = lm.astype(np.float32)
    dst = jat.get_reference_facial_points((112, 112), default_square=True)
    np.testing.assert_array_equal(pat.get_affine_transform_matrix(src, dst),
                                  jat.get_affine_transform_matrix(src, dst))
    for crop in ((96, 112), (112, 112)):
        np.testing.assert_array_equal(
            pat.warp_and_crop_face(img, lm, crop_size=crop,
                                   align_type=align_type),
            jat.warp_and_crop_face(img, lm, crop_size=crop,
                                   align_type=align_type))


def _landmarks(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(100, 300, (n, 2))


@pytest.mark.parametrize('n,lm_type', [(5, 'retinaface_5'), (5, 'dlib_5'),
                                       (68, 'retinaface_5'),
                                       (98, 'retinaface_5')])
def test_ffhq_quad_matches_jax(n, lm_type):
    lm = _landmarks(n, n)
    for ratio in ((1, 1), (1.5, 1.2)):
        q_p, s_p = pfu.ffhq_quad(lm, ratio, lm_type)
        q_j, s_j = jfu.ffhq_quad(lm, ratio, lm_type)
        np.testing.assert_array_equal(q_p, q_j)
        assert s_p == s_j


def test_face_utils_match_jax():
    bbox = (40, 30, 120, 150)
    for keep in (True, False):
        assert pfu.compute_increased_bbox(bbox, 0.2, keep) == \
            jfu.compute_increased_bbox(bbox, 0.2, keep)
    assert pfu.get_valid_bboxes((-5, 3, 300, 90), 100, 200) == \
        jfu.get_valid_bboxes((-5, 3, 300, 90), 100, 200)
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (240, 260, 3), dtype=np.uint8)
    lm = TEMPLATE * 0.3 + [50.0, 40.0]
    for padding in (True, False):
        face_p, inv_p = pfu.align_crop_face_landmarks(
            img, lm, 128, enable_padding=padding,
            return_inverse_affine=True, shrink_ratio=1.2)
        face_j, inv_j = jfu.align_crop_face_landmarks(
            img, lm, 128, enable_padding=padding,
            return_inverse_affine=True, shrink_ratio=1.2)
        np.testing.assert_array_equal(face_p, face_j)
        np.testing.assert_array_equal(inv_p, inv_j)
    np.testing.assert_array_equal(
        pfu.paste_face_back(img.astype(np.float32), face_p, inv_p),
        jfu.paste_face_back(img.astype(np.float32), face_j, inv_j))


def test_normalize_img_dtype_matches_jax():
    rng = np.random.default_rng(3)
    cases = [rng.integers(0, 65536, (20, 24, 3), dtype=np.uint16),
             rng.integers(0, 256, (20, 24), dtype=np.uint8),
             rng.integers(0, 256, (20, 24, 4), dtype=np.uint8),
             rng.uniform(-20, 300, (20, 24, 3)).astype(np.float32),
             rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)]
    for img in cases:
        got = pimg.normalize_img_dtype(img.copy())
        np.testing.assert_array_equal(got, jimg.normalize_img_dtype(img))
        assert got.dtype == np.uint8 and got.shape == (20, 24, 3)


def test_profiler_matches_jax(monkeypatch):
    """The same clock readings give the same totals, counts and report;
    span names a torch.profiler region."""
    timers = (pprof.StageTimer(), jprof.StageTimer())
    for mod, timer in zip((pprof, jprof), timers):
        ticks = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.125])
        monkeypatch.setattr(mod.time, 'perf_counter', lambda: next(ticks))
        for name in ('detect', 'paste', 'detect'):
            with timer.stage(name):
                pass
        monkeypatch.undo()
    assert dict(timers[0].totals) == dict(timers[1].totals) == \
        {'detect': 0.375, 'paste': 0.5}
    assert dict(timers[0].counts) == dict(timers[1].counts)
    assert timers[0].report() == timers[1].report()
    timers[0].reset()
    assert timers[0].report() == jprof.StageTimer().report()
    assert pprof.stage == pprof.TIMER.stage
    with torch.profiler.profile() as prof:
        with pprof.span('classic_paste'):
            torch.ones(2).sum()
    assert 'cf.classic_paste' in {e.key for e in prof.key_averages()}


def test_largest_and_center_face_match_jax():
    rng = np.random.default_rng(4)
    dets = [np.concatenate([rng.uniform(-20, 300, 2),
                            rng.uniform(20, 400, 2), [0.9]])
            for _ in range(6)]
    for d in dets:
        d[2:4] += d[0:2]
    for args in ((dets, 200, 320),):
        f_p, i_p = pfh.get_largest_face(*args)
        f_j, i_j = jfh.get_largest_face(*args)
        assert i_p == i_j
        np.testing.assert_array_equal(f_p[0], f_j[0])
    for kw in ({'h': 200, 'w': 320}, {'center': (10, 30)}):
        assert pfh.get_center_face(dets, **kw)[1] == \
            jfh.get_center_face(dets, **kw)[1]


# ---------------------------------------------------------------------------
# FaceRestoreHelper's per-image methods, port vs JAX
# ---------------------------------------------------------------------------
class _Det:
    """The same detections for both helpers: faces as landmarks in
    fractions of the image, scaled to whatever image the helper hands
    over (its resized copy); boxes around them, score 0.99."""

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


IMG_HW = (320, 400)     # read_image takes it to 512 x 640
UP_HW = (512, 640)


def _faces(*specs):
    """(scale, x, y) of template-shaped faces in 512 x 640 pixels ->
    landmark fractions."""
    return [(TEMPLATE * s + [x, y]) / [UP_HW[1], UP_HW[0]]
            for s, x, y in specs]


FACES = _faces((0.35, 60, 80), (0.5, 280, 120))
# a face near the top left corner, so pad_blur pads; a tiny one that
# eye_dist_threshold drops
BORDER_FACES = _faces((0.5, -70, -100), (0.35, 300, 150))
TINY_FACE = _faces((0.35, 60, 80), (0.02, 500, 400))


def _image(seed, gray=False):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(30, 220, (IMG_HW[0] // 16, IMG_HW[1] // 16, 3))
    img = np.repeat(np.repeat(lo, 16, axis=0), 16, axis=1)
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255)
    img = img.astype(np.uint8)
    if gray:
        img = np.repeat(img[..., 1:2], 3, axis=-1)
    return img


_HELPERS = {}


def _helpers(template_3points=False, pad_blur=False):
    """(JAX helper, port helper) with the same ParseNet weights, built
    once a configuration; the detector is set by each test."""
    key = (template_3points, pad_blur)
    if key not in _HELPERS:
        kw = dict(face_size=512, use_parse=True, allow_random_weights=True,
                  detector=_Det([]), template_3points=template_3points,
                  pad_blur=pad_blur)
        jh = jfh.FaceRestoreHelper(2, **kw)
        ph = pfh.FaceRestoreHelper(2, device='cpu', **kw)
        v = jax.tree_util.tree_map(np.asarray, jh._parse_vars)
        ph._parse_model.load_state_dict(flax_to_state_dict(
            v, like=ph._parse_model.state_dict()), strict=True)
        _HELPERS[key] = (jh, ph)
    return _HELPERS[key]


CASES = {  # name: (image kw, faces, ctor kw, landmark kw, align kw)
    'color': ({}, FACES, {}, {}, {}),
    'gray': ({'gray': True}, FACES, {}, {}, {}),
    'uint16': ({'uint16': True}, FACES, {}, {}, {}),
    'center': ({}, FACES, {}, {'only_center_face': True}, {}),
    'largest': ({}, FACES, {}, {'only_keep_largest': True}, {}),
    'eye_dist': ({}, TINY_FACE, {}, {'eye_dist_threshold': 5}, {}),
    'pad_blur': ({}, BORDER_FACES, {'pad_blur': True}, {}, {}),
    'three_points': ({}, FACES, {'template_3points': True}, {}, {}),
    'reflect101': ({}, BORDER_FACES, {}, {},
                   {'border_mode': 'reflect101'}),
    'reflect': ({}, BORDER_FACES, {}, {}, {'border_mode': 'reflect'}),
}


def _run_helper(h, img, faces, lm_kw, align_kw):
    h.clean_all()
    h.face_detector = _Det(faces)
    h.read_image(img.copy())
    n = h.get_face_landmarks_5(resize=640, **lm_kw)
    h.align_warp_face(**align_kw)
    h.get_inverse_affine(None)
    for crop in h.cropped_faces:
        h.add_restored_face(255 - crop, crop)
    return n


@pytest.mark.parametrize('case', sorted(CASES))
def test_helper_per_image_matches_jax(case):
    img_kw, faces, ctor, lm_kw, align_kw = CASES[case]
    jh, ph = _helpers(**ctor)
    img = _image(len(case), gray=img_kw.get('gray', False))
    if img_kw.get('uint16'):
        img = img.astype(np.uint16) * 257
    n_j = _run_helper(jh, img, faces, lm_kw, align_kw)
    n_p = _run_helper(ph, img, faces, lm_kw, align_kw)
    assert n_p == n_j == len(ph.cropped_faces) > 0
    assert ph.is_gray == jh.is_gray == img_kw.get('gray', False)
    np.testing.assert_array_equal(ph.input_img, jh.input_img)
    assert ph.input_img.shape[:2] == UP_HW
    for key in ('all_landmarks_5', 'det_faces', 'affine_matrices',
                'cropped_faces', 'inverse_affine_matrices', 'restored_faces',
                'pad_input_imgs'):
        got, want = getattr(ph, key), getattr(jh, key)
        assert len(got) == len(want), key
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, key)
    if ctor.get('pad_blur'):
        assert len(ph.pad_input_imgs) == n_p
        assert ph.pad_input_imgs[0].shape != ph.input_img.shape
    if case == 'eye_dist':
        assert n_p == 1
    if case in ('center', 'largest'):
        assert n_p == 1

    # the cv2 compositor, fed the same parse ids: equal bit for bit
    rng = np.random.default_rng(7)
    ids = np.zeros((n_p, 512, 512), np.int32)
    ids[:, 96:416, 112:400] = rng.integers(1, 14, (n_p, 1, 1))
    for h in (jh, ph):
        h.compositor = 'cv2'
        h._precomputed_parse_ids = ids
    for draw_box in (False, True):
        want = jh.paste_faces_to_input_image(draw_box=draw_box)
        got = ph.paste_faces_to_input_image(draw_box=draw_box)
        np.testing.assert_array_equal(got, want)
    if case == 'color':
        # the device compositors through the helpers (offsets, parse ids)
        for h in (jh, ph):
            h.compositor = 'xla'
        want = jh.paste_faces_to_input_image(draw_box=True)
        got = ph.paste_faces_to_input_image(draw_box=True)
        assert got.shape == want.shape == (1024, 1280, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    for h in (jh, ph):
        h._precomputed_parse_ids = None
        h.compositor = 'xla'


def test_parse_masks_match_jax():
    """_parse_masks, port vs JAX, on the same ParseNet weights: the same
    class ids but where two classes' fp32 logits nearly tie (read: 1 of
    524,288 pixels flips); a face not of 512^2 (an upsampled face) is
    resized to it first."""
    jh, ph = _helpers()
    rng = np.random.default_rng(8)
    lo = rng.uniform(0, 255, (1, 16, 16, 3))
    face = np.repeat(np.repeat(lo, 32, 1), 32, 2)[0].astype(np.uint8)
    faces = [face, cv2.resize(face, (640, 640))]
    got, want = ph._parse_masks(faces), jh._parse_masks(faces)
    assert got.shape == want.shape == (2, 512, 512)
    assert (got != want).mean() <= 1e-4, (got != want).sum()


def test_save_cropped_and_read_path(tmp_path):
    """read_image takes a path; align_warp_face saves each crop as
    <path>_<idx>.<save_ext>."""
    _, ph = _helpers()
    cv2.imwrite(str(tmp_path / 'in.png'), _image(3))
    ph.clean_all()
    ph.face_detector = _Det(FACES)
    ph.read_image(str(tmp_path / 'in.png'))
    ph.get_face_landmarks_5(resize=640)
    ph.align_warp_face(save_cropped_path=str(tmp_path / 'crop.png'))
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ['crop_00.png', 'crop_01.png', 'in.png']
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / 'crop_01.png')),
                                  ph.cropped_faces[1])
    ph.get_inverse_affine(None)
    ph.restored_faces = list(ph.cropped_faces)
    ph._precomputed_parse_ids = np.ones((2, 512, 512), np.int64)
    out = ph.paste_faces_to_input_image(save_path=str(tmp_path / 'o.jpg'))
    ph._precomputed_parse_ids = None
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / 'o.png')), out)


def test_helper_refuses_what_is_not_ported(monkeypatch):
    """det_model='dlib' without the dlib package raises ImportError with
    JAX's message; an unknown compositor raises ValueError."""
    monkeypatch.setitem(sys.modules, 'dlib', None)
    said = []
    for mod, kw in ((jfh, {}), (pfh, {'device': 'cpu'})):
        with pytest.raises(ImportError, match='needs the dlib package') as e:
            mod.FaceRestoreHelper(2, det_model='dlib',
                                  allow_random_weights=True, **kw)
        said.append(str(e.value))
    assert said[0] == said[1]
    with pytest.raises(ValueError):
        pfh.FaceRestoreHelper(2, compositor='numpy', device='cpu')


# ---------------------------------------------------------------------------
# the dlib path, with one stub `dlib` module for both packages
# ---------------------------------------------------------------------------
# the FFHQ 1024-scale 5-point template (eye corners + nose bottom)
TEMPLATE_1024 = np.array(
    [[686.77227723, 488.62376238], [586.77227723, 493.59405941],
     [337.91089109, 488.38613861], [437.95049505, 493.51485149],
     [513.58415842, 678.5049505]], np.float32)
# two faces: (scale of the template, offset); the first is the larger
DLIB_FACES = [(0.30, (60.0, 90.0)), (0.22, (420.0, 340.0))]


def _dlib_stub():
    """A `dlib` module: the CNN detector returns a box around each face
    of DLIB_FACES, the shape predictor that face's template landmarks
    (fractional, as dlib's parts are integers only after rounding)."""
    class Rect:
        def __init__(self, box):
            self.box = box

        def left(self):
            return self.box[0]

        def top(self):
            return self.box[1]

        def right(self):
            return self.box[2]

        def bottom(self):
            return self.box[3]

    def landmarks(k):
        scale, off = DLIB_FACES[k]
        return TEMPLATE_1024 * scale + np.asarray(off, np.float32)

    def box(k):
        lm = landmarks(k)
        return (lm[:, 0].min() - 20, lm[:, 1].min() - 40,
                lm[:, 0].max() + 20, lm[:, 1].max() + 30)

    def cnn_face_detection_model_v1(path):
        def detect(img, upsample):
            assert upsample == 1
            return [types.SimpleNamespace(rect=Rect(box(k)))
                    for k in range(len(DLIB_FACES))]
        return detect

    def shape_predictor(path):
        def predict(img, rect):
            k = [box(j) for j in range(len(DLIB_FACES))].index(rect.box)
            parts = [types.SimpleNamespace(x=float(x), y=float(y))
                     for x, y in landmarks(k)]
            return types.SimpleNamespace(parts=lambda: parts)
        return predict

    mod = types.ModuleType('dlib')
    mod.cnn_face_detection_model_v1 = cnn_face_detection_model_v1
    mod.shape_predictor = shape_predictor
    return mod


@pytest.fixture
def stub_dlib(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, 'dlib', _dlib_stub())
    for name in ('DLIB_DETECTOR_WEIGHTS', 'DLIB_SHAPE5_WEIGHTS'):
        path = tmp_path / f'{name}.dat'
        path.write_bytes(b'stub')
        for mod in (jfh, pfh):
            monkeypatch.setattr(mod.FaceRestoreHelper, name, str(path))


@pytest.mark.parametrize('only_keep_largest', [False, True])
def test_dlib_path_matches_jax(stub_dlib, only_keep_largest):
    """The 1024-scale template at 512, the landmarks (all faces, or the
    largest box's), the affines and crops: equal to JAX's."""
    img = np.random.default_rng(9).integers(0, 255, (820, 900, 3),
                                            np.uint8)
    helpers = []
    for mod, kw in ((jfh, {}), (pfh, {'device': 'cpu'})):
        h = mod.FaceRestoreHelper(1, face_size=512, det_model='dlib',
                                  use_parse=False, allow_random_weights=True,
                                  **kw)
        h.read_image(img)
        n = h.get_face_landmarks_5(only_keep_largest=only_keep_largest)
        assert n == (1 if only_keep_largest else 2)
        h.align_warp_face()
        helpers.append(h)
    jh, ph = helpers
    np.testing.assert_allclose(ph.face_template, TEMPLATE_1024 / 2.0,
                               rtol=1e-6)
    np.testing.assert_array_equal(ph.face_template, jh.face_template)
    for name in ('all_landmarks_5', 'affine_matrices', 'cropped_faces'):
        for g, w in zip(getattr(ph, name), getattr(jh, name)):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(
        ph.all_landmarks_5[0], TEMPLATE_1024 * DLIB_FACES[0][0]
        + np.asarray(DLIB_FACES[0][1]), atol=1e-3)
    # each crop puts its face's landmarks on the template
    for lm, aff in zip(ph.all_landmarks_5, ph.affine_matrices):
        mapped = np.concatenate([lm, np.ones((5, 1))], 1) @ aff.T
        np.testing.assert_allclose(mapped, ph.face_template, atol=0.5)


def test_dlib_missing_weights_raise_as_jax(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, 'dlib', _dlib_stub())
    for mod, kw in ((jfh, {}), (pfh, {'device': 'cpu'})):
        monkeypatch.setattr(mod.FaceRestoreHelper, 'DLIB_DETECTOR_WEIGHTS',
                            str(tmp_path / 'absent.dat'))
        with pytest.raises(FileNotFoundError, match='absent.dat'):
            mod.FaceRestoreHelper(1, det_model='dlib',
                                  allow_random_weights=True, **kw)


# ---------------------------------------------------------------------------
# paste_faces: against paste_faces_xla, and against the cv2 oracle
# ---------------------------------------------------------------------------
def _synthetic(n_faces):
    """An image, n faces and their inverse affines (faces of 512 onto
    128 px squares, overlapping), and parse ids: tests/
    test_compositor.py's case with more faces."""
    rng = np.random.default_rng(0)
    img = rng.uniform(40, 200, (200, 260, 3)).astype(np.uint8)
    faces, inv = [], []
    for k in range(n_faces):
        faces.append(rng.uniform(0, 255, (512, 512, 3)).astype(np.uint8))
        inv.append(cv2.invertAffineTransform(np.array(
            [[4.0, 0.0, -160.0 + 200 * k], [0.0, 4.0, -200.0 + 60 * k]],
            np.float32)))
    parse = np.zeros((n_faces, 512, 512), np.int32)
    parse[:, 100:400, 100:400] = 1  # 'skin' -> mask 255
    parse[:, 200:260, 150:350] = 14  # a class the colormap zeroes
    return img, faces, inv, parse


class _Stub:
    """Bypass model loading: compositor-only harness over either
    package's helper class (test_compositor.py's `_Stub`)."""

    def __init__(self, cls, upscale, use_parse, compositor, parse):
        self.h = cls.__new__(cls)
        h = self.h
        h.compositor = compositor
        h.upscale_factor = upscale
        h.use_parse = use_parse
        h.face_size = (512, 512)
        h.save_ext = 'png'
        h.device = torch.device('cpu')
        h._precomputed_parse_ids = None
        h._parse_masks = lambda faces: parse[:len(faces)]

    def paste(self, img, faces, inv, **kw):
        self.h.input_img = img
        self.h.restored_faces = [f.copy() for f in faces]
        self.h.inverse_affine_matrices = [a.copy() * self.h.upscale_factor
                                          for a in inv]
        return self.h.paste_faces_to_input_image(**kw)


class _FakeUpsampler:
    """Stands in for RealESRGANer.enhance: plain resize by outscale."""

    def enhance(self, img, outscale=2):
        h, w = img.shape[:2]
        out = cv2.resize(img, (int(w * outscale), int(h * outscale)),
                         interpolation=cv2.INTER_LINEAR)
        return out, 'RGB'


PASTE_CASES = {  # name: (faces, use_parse, draw_box, upsampler, upscale)
    'plain': (1, False, False, False, 1),
    'parse': (1, True, False, False, 1),
    'draw_box': (1, False, True, False, 1),
    'parse_box_3faces': (3, True, True, False, 2),
    'upsampler': (1, False, False, True, 2),
    'upsampler_parse': (1, True, False, True, 2),
}


@pytest.mark.parametrize('case', sorted(PASTE_CASES))
def test_paste_faces_matches_jax(case):
    """The device compositors: port vs paste_faces_xla through the two
    helpers, within 1 level on uint8."""
    n, use_parse, draw_box, ups, up = PASTE_CASES[case]
    img, faces, inv, parse = _synthetic(n)
    kw = dict(draw_box=draw_box)
    if ups:
        kw['face_upsampler'] = _FakeUpsampler()
    want = _Stub(jfh.FaceRestoreHelper, up, use_parse, 'xla', parse).paste(
        img, faces, inv, **kw)
    got = _Stub(pfh.FaceRestoreHelper, up, use_parse, 'xla', parse).paste(
        img, faces, inv, **kw)
    assert got.shape == want.shape == (200 * up, 260 * up, 3)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, (diff.max(), (diff > 0).mean())
    if draw_box:
        assert (got[:, :, 1] == 255).sum() > 100


def test_paste_faces_without_faces():
    img = _synthetic(1)[0]
    from codeformer_tpu_torch.pipeline.compositor import paste_faces
    np.testing.assert_array_equal(
        paste_faces(img, [], [], None, 1, device='cpu'), img)


def _oracle_pair(use_parse, upscale, **kw):
    img, faces, inv, parse = _synthetic(1)
    outs = {c: _Stub(pfh.FaceRestoreHelper, upscale, use_parse, c,
                     parse).paste(img, faces, inv, **kw).astype(np.float32)
            for c in ('cv2', 'xla')}
    return outs, np.abs(outs['cv2'] - outs['xla'])


def test_device_compositor_draw_box_close_to_cv2():
    outs, diff = _oracle_pair(False, 1, draw_box=True)
    for out in outs.values():
        assert (out[:, :, 1] == 255).sum() > 100
    # the border width comes from the affine determinant on the device
    # (the eroded-mask sum in cv2): the border may shift by about 1 px
    assert diff.mean() < 3.0, diff.mean()
    assert np.median(diff) == 0.0


@pytest.mark.parametrize('use_parse', [False, True])
def test_device_compositor_face_upsampler_close_to_cv2(use_parse):
    outs, diff = _oracle_pair(use_parse, 2, face_upsampler=_FakeUpsampler())
    assert outs['cv2'].shape == outs['xla'].shape == (400, 520, 3)
    assert diff.mean() < 2.0, diff.mean()
    assert np.median(diff) == 0.0


@pytest.mark.parametrize('use_parse', [False, True])
def test_paste_with_realesrgan_face_upsampler_matches_jax(use_parse):
    """--face_upsample on the classic path: each package's helper with
    its own RealESRGANer (narrow RRDBNet, the same weights, fp32, the
    face whole; the tile walk is held in test_torch_realesrgan.py)
    upsamples the restored face to 1024 and pastes it at upscale 2:
    within REALESRGAN_PASTE_MAX levels."""
    from test_torch_realesrgan import _pair
    ju, pu = _pair(tile=0)
    img, faces, inv, parse = _synthetic(1)
    outs = [_Stub(mod.FaceRestoreHelper, 2, use_parse, 'xla', parse).paste(
        img, faces, inv, face_upsampler=up).astype(np.float32)
        for mod, up in ((jfh, ju), (pfh, pu))]
    assert outs[0].shape == outs[1].shape == (400, 520, 3)
    diff = np.abs(outs[0] - outs[1])
    assert diff.max() <= REALESRGAN_PASTE_MAX, diff.max()
    # the face went in: the image is not the plain upscale
    plain = cv2.resize(img, (520, 400), interpolation=cv2.INTER_LINEAR)
    assert np.abs(outs[1] - plain).max() > 30


@pytest.mark.parametrize('use_parse', [False, True])
def test_device_compositor_close_to_cv2(use_parse):
    outs, diff = _oracle_pair(use_parse, 1)
    # identical away from the quantized soft edge; small mean deviation
    assert diff.mean() < 2.0, diff.mean()
    assert np.median(diff) == 0.0
    # untouched background must be identical
    np.testing.assert_array_equal(outs['cv2'][0:20], outs['xla'][0:20])


def test_cv2_fallback_for_what_the_device_compositor_skips():
    """A 4-channel canvas takes the cv2 path even with compositor xla,
    as in the JAX helper: the alpha channel is kept."""
    img, faces, inv, parse = _synthetic(1)
    rgba = np.concatenate([img, np.full(img.shape[:2] + (1,), 77,
                                        np.uint8)], axis=-1)
    outs = []
    for cls in (pfh.FaceRestoreHelper, jfh.FaceRestoreHelper):
        stub = _Stub(cls, 1, False, 'xla', parse)
        stub.h.input_img = img
        stub.h.restored_faces = list(faces)
        stub.h.inverse_affine_matrices = list(inv)
        outs.append(stub.h.paste_faces_to_input_image(upsample_img=rgba))
    assert outs[0].shape == (200, 260, 4)
    assert (outs[0][..., 3] == 77).all()
    np.testing.assert_array_equal(outs[0], outs[1])


def test_align_multi_matches_jax():
    """FaceDetector.align_multi: the same detections (detect_faces
    stubbed on both, the networks are held against JAX in
    test_torch_detect.py) give the same 112x112 crops and boxes."""
    from codeformer_tpu.pipeline.detector import FaceDetector as JDet
    from codeformer_tpu_torch.pipeline.detector import FaceDetector as PDet
    img = _image(5)
    rows = _Det(FACES).detect_faces(img)
    outs = []
    for cls in (PDet, JDet):
        det = cls.__new__(cls)
        det.detect_faces = lambda im, conf_threshold=0.8: rows
        outs.append([det.align_multi(img), det.align_multi(img, limit=1)])
    for (boxes_p, crops_p), (boxes_j, crops_j) in zip(*outs):
        np.testing.assert_array_equal(boxes_p, boxes_j)
        assert len(crops_p) == len(crops_j) == len(boxes_p)
        for a, b in zip(crops_p, crops_j):
            assert a.shape == (112, 112, 3)
            np.testing.assert_array_equal(a, b)
    assert len(outs[0][1][1]) == 1

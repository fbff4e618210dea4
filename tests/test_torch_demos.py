"""The port's web demos (codeformer_tpu_torch/demos/) against the JAX
demo (web-demos/hugging_face/app.py, loaded from its file), in process
on the same image.

Both demos build their restorer from weights/CodeFormer/codeformer.pth
(one `.pth` written from seeded weights under a temporary working
directory), at a narrow 512^2 topology (nf 32, six stages to the 16^2
latent, 2 transformer layers) in fp32: the demos' restorer class is
wrapped to pass that model and dtype. Random detector weights find no
faces, so both helpers get the same injected detections and the same
parse ids (tests/test_torch_classic.py's way), and a resize stands in
for Real-ESRGAN where the upsamplers are asked for.

Tolerance: the restored images within 2 levels, at most 1% of the
values apart (read: 1 level, 0.14% and 0.15%). The restored faces differ
by at most one level (fp32 rounding boundaries, as
tests/test_torch_restorer.py), and the device compositors by at most one
more (tests/test_torch_classic.py test_paste_faces_matches_jax). The
clamps and the routing (which upscale, whether the upsampler is built)
are equal.
"""
import functools
import importlib.util
import os
import sys
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip('torch')
cv2 = pytest.importorskip('cv2')
import jax.numpy as jnp  # noqa: E402

import codeformer_tpu.pipeline.face_helper as jfh  # noqa: E402
import codeformer_tpu.pipeline.realesrgan as jesr  # noqa: E402
from codeformer_tpu.models import CodeFormer as JaxCodeFormer  # noqa: E402
from codeformer_tpu.pipeline.restorer import (  # noqa: E402
    CodeFormerRestorer as JaxRestorer)
import codeformer_tpu_torch.pipeline.face_helper as pfh  # noqa: E402
import codeformer_tpu_torch.pipeline.realesrgan as pesr  # noqa: E402
from codeformer_tpu_torch.demos import hugging_face as hf  # noqa: E402
from codeformer_tpu_torch.demos import replicate  # noqa: E402
from codeformer_tpu_torch.models import CodeFormer  # noqa: E402
from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer  # noqa: E402
from codeformer_tpu_torch.utils.checkpoint import init_params_fast  # noqa: E402

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(img_size=512, nf=32, ch_mult=(1, 1, 1, 1, 1, 1),
             codebook_size=64, emb_dim=16, dim_embd=64, n_head=4,
             n_layers=2, latent_size=256, connect_list=('32',))
# the FFHQ 5-point template of a 512 face (face_restoration_helper.py)
TEMPLATE = np.array([[192.98138, 239.94708], [318.90277, 240.1936],
                     [256.63416, 314.01935], [201.26117, 371.41043],
                     [313.08905, 371.15118]])


@pytest.fixture(scope='module')
def jax_app():
    spec = importlib.util.spec_from_file_location(
        'jax_hugging_face_app',
        os.path.join(ROOT, 'web-demos', 'hugging_face', 'app.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Det:
    """Landmarks given as fractions of the image, scaled to the image the
    helper hands over; boxes around them, score 0.99."""

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


class _FakeUpsampler:
    """A resize by outscale in place of RealESRGANer.enhance."""

    def enhance(self, img, outscale=2):
        h, w = img.shape[:2]
        return cv2.resize(img, (int(w * outscale), int(h * outscale)),
                          interpolation=cv2.INTER_LINEAR), 'RGB'


def _image(seed, hw):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(30, 220, (hw[0] // 16 + 1, hw[1] // 16 + 1, 3))
    img = cv2.resize(lo, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255) \
        .astype(np.uint8)


@pytest.fixture
def both(jax_app, tmp_path, monkeypatch):
    """The two demos with the same weights file, detections, parse ids
    and upsampler stand-in; records how each built its helper."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('CODEFORMER_RANDOM_INIT', '1')
    os.makedirs('weights/CodeFormer')
    model = init_params_fast(CodeFormer(**SMALL), 3)
    with torch.no_grad():      # keep the SFT branch's output in range
        for blk in model.fuse_convs_dict.values():
            blk.scale[2].weight.mul_(0.01)
            blk.shift[2].weight.mul_(0.01)
    torch.save({'params_ema': model.state_dict()},
               'weights/CodeFormer/codeformer.pth')
    faces = [(TEMPLATE * 0.4 + [40, 30]) / [400, 320]]
    ids = np.zeros((1, 512, 512), np.int32)
    ids[:, 96:416, 112:400] = 1
    built = {'jax': [], 'port': []}

    def helper(cls, key, upscale, **kw):
        built[key].append(upscale)
        h = cls(upscale, detector=_Det(faces), **kw)
        h._precomputed_parse_ids = ids
        return h

    monkeypatch.setattr(jax_app, '_restorer', None)
    monkeypatch.setattr(jax_app, 'CodeFormerRestorer', functools.partial(
        JaxRestorer, model=JaxCodeFormer(**SMALL), dtype=jnp.float32))
    monkeypatch.setattr(jax_app, 'FaceRestoreHelper', functools.partial(
        helper, jfh.FaceRestoreHelper, 'jax'))
    monkeypatch.setattr(hf, '_restorers', {})
    monkeypatch.setattr(hf, 'CodeFormerRestorer', functools.partial(
        CodeFormerRestorer, model=CodeFormer(**SMALL), dtype=torch.float32))
    monkeypatch.setattr(hf, 'FaceRestoreHelper', functools.partial(
        helper, pfh.FaceRestoreHelper, 'port'))
    ups = mock.Mock(side_effect=lambda **kw: _FakeUpsampler())
    monkeypatch.setattr(jesr, 'set_realesrgan', ups)
    monkeypatch.setattr(pesr, 'set_realesrgan', ups)
    return jax_app, built, ups


@pytest.mark.parametrize('enhance', [False, True])
def test_inference_matches_the_jax_demo(both, enhance, capsys):
    jax_app, built, ups = both
    img = _image(0, (320, 400))
    want = jax_app.inference(img.copy(), enhance, enhance, 2, 0.5)
    got = hf.inference(img.copy(), enhance, enhance, 2, 0.5, device='cpu')
    assert 'Failed inference' not in capsys.readouterr().out
    assert built['port'] == built['jax'] == [2]
    assert ups.call_count == (2 if enhance else 0)
    # read_image takes the short side to 512, then x2
    assert got.shape == want.shape == (1024, 1280, 3)
    assert got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 2 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())
    # the restorer was built once, from the weights file, on the device
    r = hf._restorers['cpu']
    assert r.device == torch.device('cpu') and r.dtype == torch.float32
    torch.testing.assert_close(
        r.model.state_dict()['position_emb'],
        torch.load('weights/CodeFormer/codeformer.pth')['params_ema']
        ['position_emb'])


@pytest.mark.parametrize('hw,upscale,want', [
    ((200, 300), 7, (4, True)), ((1100, 300), 3, (2, True)),
    ((1600, 300), 2, (1, False)), ((1000, 900), 3, (3, True))])
def test_upscale_clamps_match_the_jax_demo(both, hw, upscale, want):
    """app.py:45-52: at most 4, at most 2 past 1000 px, 1 and no
    upsampler past 1500; the same in both demos (here without faces)."""
    jax_app, built, ups = both
    img = np.full(hw + (3,), 128, np.uint8)
    with mock.patch.object(_Det, 'detect_faces',
                           lambda self, img, conf_threshold=0.8:
                           np.zeros((0, 15), np.float32)):
        out_j = jax_app.inference(img, True, True, upscale, 0.5)
        out_p = hf.inference(img, True, True, upscale, 0.5, device='cpu')
    assert built['port'] == built['jax'] == [want[0]]
    assert ups.call_count == (2 if want[1] else 0)
    assert hf.upscale_clamps(*hw, upscale, True, True) == (
        want[0], want[1], want[1])
    assert out_p.shape == out_j.shape


def test_predict_writes_what_inference_returns(both, tmp_path):
    """The replicate predictor reads the file, runs `inference` and
    writes its result; `Predictor` exists only where cog imports."""
    img = _image(1, (320, 400))
    cv2.imwrite(str(tmp_path / 'in.png'), img)
    out = replicate.predict(str(tmp_path / 'in.png'), 0.5, False, False, 2,
                            str(tmp_path / 'out.png'), device='cpu')
    np.testing.assert_array_equal(
        cv2.imread(out), hf.inference(img, False, False, 2, 0.5, 'cpu'))
    try:
        import cog  # noqa: F401
    except ImportError:
        assert not hasattr(replicate, 'Predictor')


def test_build_ui_without_gradio_exits_as_jax(jax_app, monkeypatch):
    monkeypatch.setitem(sys.modules, 'gradio', None)
    with pytest.raises(SystemExit) as want:
        jax_app.build_ui()
    with pytest.raises(SystemExit) as got:
        hf.build_ui()
    assert str(got.value) == str(want.value)
    assert 'gradio is not installed' in str(got.value)


def test_defaults_serve_on_cuda():
    """Without a device the demos serve on the card (no CPU fallback)."""
    import inspect
    for fn in (hf.inference, hf.get_restorer, hf.build_ui,
               replicate.predict):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'

"""The port's detection stack against the JAX package's on the same
seeded inputs and weights: anchors, box/landmark decoding, the batched
static-shape NMS, RetinaFace (resnet50 and mobile0.25 at full width) and
the FaceDetector service (detect_faces, batched_detect_faces, the device
front end, and the keep-bucket escalation of tests/test_detector_cap.py).

Weights cross from JAX through flax_to_state_dict(like=...) and load
strictly. Random heads give saturated scores (softmax of logits in the
1e5s) and overflowing boxes, so the service tests scale the three heads
of the shared JAX weights until their outputs are O(1): then scores are
distinct and the comparison is not decided by ties (top-k and NMS
ordering of exactly equal scores is arbitrary in both)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeformer_tpu.models import RetinaFace as JRetinaFace
from codeformer_tpu.ops import anchors as janchors
from codeformer_tpu.ops.nms import decode_boxes as j_decode_boxes
from codeformer_tpu.ops.nms import decode_landmarks as j_decode_landmarks
from codeformer_tpu.ops.nms import nms as j_nms
from codeformer_tpu.pipeline.detector import FaceDetector as JFaceDetector
from codeformer_tpu.utils.checkpoint import init_params_fast
from codeformer_tpu_torch.models.retinaface import RetinaFace
from codeformer_tpu_torch.ops import anchors as panchors
from codeformer_tpu_torch.ops.nms import decode_boxes, decode_landmarks, nms
from codeformer_tpu_torch.pipeline import detector as pdet
from codeformer_tpu_torch.utils.convert import flax_to_state_dict

# RetinaFace fp32, port vs JAX: the same convs summed in another order;
# the outputs of random weights reach 1e5, and differ by < 1e-5 of the
# largest (measured 3e-6)
MODEL_RTOL = 1e-5
# conf is a softmax of logits of |50| and more that carry that relative
# error, so its absolute error is up to a quarter of 1e-5 * |logit|
# (measured 4.6e-5 at mobile0.25)
CONF_ATOL = 1e-3
DECODE_ATOL = 1e-5
BOX_ATOL = 1e-3           # pixels, detections of the same weights


def _jax_vars(network, seed, tame=False):
    """Seeded JAX RetinaFace variables with perturbed BatchNorm affine
    and running statistics (so a mean/var or scale/bias mix-up shows);
    `tame` scales the heads so their outputs are O(1)."""
    model = JRetinaFace(network_name=network)
    v = init_params_fast(model, jnp.zeros((1, 64, 64, 3)), seed=seed)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed)

    def perturb(tree, key):
        for k, sub in tree.items():
            if isinstance(sub, dict):
                perturb(sub, k)
            elif k in ('mean', 'bias'):
                tree[k] = rng.normal(0, 0.1, sub.shape).astype(np.float32)
            elif k in ('var', 'scale') and key.endswith(('_1', '_4', 'bn1',
                                                         'bn2', 'bn3')):
                tree[k] = rng.uniform(0.5, 1.5, sub.shape).astype(np.float32)

    perturb(v['params'], '')
    perturb(v['batch_stats'], '')
    if tame:
        x = rng.uniform(-120, 130, (1, 128, 160, 3)).astype(np.float32)
        outs = model.apply(v, jnp.asarray(x))
        logits_scale = 3.0   # softmax over O(1) logits: spread scores
        for head, out, gain in (('BboxHead', outs[0], 1.0),
                                ('LandmarkHead', outs[2], 1.0)):
            s = gain / float(np.abs(np.asarray(out)).max())
            for i in range(3):
                p = v['params'][f'{head}_{i}']['conv1x1']
                p['kernel'] = p['kernel'] * s
                p['bias'] = p['bias'] * s
        for i in range(3):   # class logits: a few units apart
            p = v['params'][f'ClassHead_{i}']['conv1x1']
            k = p['kernel']
            p['kernel'] = k / np.abs(k).sum(axis=2, keepdims=True).max() \
                / 1e3 * logits_scale
    return model, v


def _port_model(network, variables):
    m = RetinaFace(network).eval()
    m.load_state_dict(flax_to_state_dict(variables, like=m.state_dict()),
                      strict=True)
    return m


def test_prior_boxes_equal_jax():
    for hw in ((64, 96), (640, 896), (704, 1152)):
        np.testing.assert_array_equal(panchors.prior_boxes(*hw),
                                      janchors.prior_boxes(*hw))


def test_decode_matches_jax():
    rng = np.random.default_rng(0)
    priors = panchors.prior_boxes(128, 160)
    loc = rng.normal(0, 1, (2, len(priors), 4)).astype(np.float32)
    pre = rng.normal(0, 1, (2, len(priors), 10)).astype(np.float32)
    tp = torch.from_numpy(priors)
    np.testing.assert_allclose(
        decode_boxes(torch.from_numpy(loc), tp).numpy(),
        np.asarray(j_decode_boxes(jnp.asarray(loc), jnp.asarray(priors))),
        rtol=0, atol=DECODE_ATOL)
    np.testing.assert_allclose(
        decode_landmarks(torch.from_numpy(pre), tp).numpy(),
        np.asarray(j_decode_landmarks(jnp.asarray(pre),
                                         jnp.asarray(priors))),
        rtol=0, atol=DECODE_ATOL)


def _boxes(rng, n):
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(10, 60, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize('case', ['random', 'saturating', 'invalid'])
def test_nms_equals_jax(case):
    """keep/valid equal to JAX's per frame, the port batched over 3
    frames; scores distinct (no ties)."""
    rng = np.random.default_rng({'random': 1, 'saturating': 2,
                                 'invalid': 3}[case])
    n, max_out = (64, 32) if case != 'saturating' else (64, 4)
    boxes = np.stack([_boxes(rng, n) for _ in range(3)])
    scores = np.stack([rng.permutation(n) / n + 0.01 for _ in range(3)]) \
        .astype(np.float32)
    if case == 'invalid':
        scores[:, ::3] = -np.inf
        scores[2] = -np.inf        # a frame with nothing
    keep, valid = nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                           0.4, max_out)
    for b in range(3):
        jk, jv = j_nms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), 0.4,
                          max_out)
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(jk))
    if case == 'saturating':
        assert valid.all()
    if case == 'invalid':
        assert not valid[2].any() and (keep[2] == 0).all()


@pytest.mark.parametrize('network', ['resnet50', 'mobile0.25'])
def test_retinaface_matches_jax(network):
    """Full width on a 64x96 image: loc, conf and landmarks."""
    model, v = _jax_vars(network, seed=4)
    x = np.random.default_rng(5).uniform(-120, 130, (1, 64, 96, 3)) \
        .astype(np.float32)
    want = model.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = _port_model(network, v)(torch.from_numpy(x).permute(0, 3, 1, 2))
    for name, g, w in zip(('loc', 'conf', 'landm'), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        err = float(np.abs(g.numpy() - w).max())
        bound = CONF_ATOL if name == 'conf' else \
            MODEL_RTOL * float(np.abs(w).max())
        assert err <= bound, (name, err)


@pytest.fixture(scope='module')
def detectors():
    """A JAX and a port FaceDetector (mobile0.25, fp32, CPU) on the same
    tamed weights."""
    _, v = _jax_vars('mobile0.25', seed=6, tame=True)
    jd = JFaceDetector('retinaface_mobile0.25', allow_random=True)
    jd.variables = jax.device_put(v)
    pd = pdet.FaceDetector('retinaface_mobile0.25', allow_random=True,
                           device='cpu')
    pd.model.load_state_dict(flax_to_state_dict(
        v, like=pd.model.state_dict()), strict=True)
    return jd, pd


def _frames(n, h=120, w=150, seed=8):
    return np.random.default_rng(seed).uniform(0, 255, (n, h, w, 3)) \
        .astype(np.uint8)


def _same_rows(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=BOX_ATOL)


def test_detect_faces_equals_jax(detectors):
    jd, pd = detectors
    img = _frames(1)[0]
    want = jd.detect_faces(img, conf_threshold=0.5)
    got = pd.detect_faces(img, conf_threshold=0.5)
    assert len(want) >= 5   # the tamed heads give detections to compare
    _same_rows(got, want)


def test_batched_detect_faces_equals_jax(detectors):
    jd, pd = detectors
    frames = _frames(3, seed=9)
    want = jd.batched_detect_faces(frames, conf_threshold=0.5)
    got = pd.batched_detect_faces(frames, conf_threshold=0.5)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_rows(g, w)


def test_batched_detect_device_matches_jax(detectors):
    """The device front end (linear resize, pad, detect): same valid mask;
    the rows of the two resizes within BOX_ATOL."""
    jd, pd = detectors
    frames = _frames(2, 96, 128, seed=10)
    det_hw = (120, 160)
    wo, wv = jd.batched_detect_device(jnp.asarray(frames), det_hw,
                                      conf_threshold=0.5)
    go, gv = pd.batched_detect_device(torch.from_numpy(frames), det_hw,
                                      conf_threshold=0.5)
    np.testing.assert_array_equal(gv, wv)
    assert gv.any()
    np.testing.assert_allclose(go[gv], wo[wv], rtol=0, atol=BOX_ATOL)


N_TRUE_FACES = 40


def _scene(max_faces, n_true=N_TRUE_FACES, off_image=False):
    """A synthetic detector output: n distinct boxes, saturating keep
    buckets below n; `off_image` adds one box centred in the padding."""
    n = min(n_true, max_faces)
    out = np.zeros((max_faces, 15), np.float32)
    for i in range(n):
        x0, y0 = 10 + (i % 8) * 60, 10 + (i // 8) * 60
        out[i] = [x0, y0, x0 + 40, y0 + 40, 0.9, x0 + 10, y0 + 15,
                  x0 + 30, y0 + 15, x0 + 20, y0 + 22, x0 + 12, y0 + 32,
                  x0 + 28, y0 + 32]
    if off_image and n < max_faces:
        out[n] = out[0] + np.float32(600)
        out[n, 4] = 0.9
        n += 1
    valid = np.zeros(max_faces, bool)
    valid[:n] = True
    return out, valid


class _JStub(JFaceDetector):
    def __init__(self, n_true, off_image=False):
        self.max_faces, self.pre_nms_topk = 32, 1024
        self.variables, self._jitted, self.calls = None, {}, []
        self.n_true, self.off_image = n_true, off_image

    def _graph(self, hw, max_faces):
        self.calls.append(max_faces)
        return lambda *a: _scene(max_faces, self.n_true, self.off_image)


class _PStub(pdet.FaceDetector):
    """The port's twin: the body replaced by the same synthetic scene."""

    def __init__(self, n_true, off_image=False):
        self.max_faces, self.pre_nms_topk = 32, 1024
        self.device, self.dtype = torch.device('cpu'), torch.float32
        self._graphs, self.calls = {}, []
        self.n_true, self.off_image = n_true, off_image

    def _graph(self, hw, max_faces):
        self.calls.append(max_faces)

        def run(x, conf_threshold, nms_threshold):
            out, valid = _scene(max_faces, self.n_true, self.off_image)
            b = x.shape[0]
            return (torch.from_numpy(out)[None].expand(b, -1, -1),
                    torch.from_numpy(valid)[None].expand(b, -1))
        return run


@pytest.mark.parametrize('n_true,calls', [(40, [32, 128]), (3, [32])])
def test_keep_bucket_escalation_equals_jax(n_true, calls):
    """A crowd beyond max_faces escalates 32 -> 128 instead of truncating;
    a small scene does not escalate; a row centred in the padding is
    dropped; the port's rows equal JAX's."""
    img = np.zeros((600, 640, 3), np.uint8)
    j, p = _JStub(n_true, off_image=True), _PStub(n_true, off_image=True)
    want, got = j.detect_faces(img), p.detect_faces(img)
    assert p.calls == j.calls == calls
    assert len(got) == n_true
    np.testing.assert_array_equal(got, want)
    p.calls = []
    rows = p.batched_detect_faces(np.zeros((2, 600, 640, 3), np.uint8))
    assert p.calls == calls and [len(r) for r in rows] == [n_true] * 2
    p.calls = []
    outs, valids = p.batched_detect_device(torch.zeros(2, 600, 640, 3,
                                                       dtype=torch.uint8),
                                           (600, 640))
    assert p.calls == calls and valids.sum(1).tolist() == [n_true + 1] * 2

"""The port's YOLOv5-face detectors against the JAX package's: YoloFace n
and l at 64x96 on the same weights (flax_to_state_dict with like=,
BatchNorm statistics perturbed so that the 1e-3 / 1e-5 epsilons show),
YoloFaceDetector.detect_faces equal as sets at low thresholds, and
DeviceRestorePipeline refusing a YOLO detector (the classic video path's
frame-by-frame detection is held in test_torch_video.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeformer_tpu.models.yolov5face import YoloFace as JYoloFace
from codeformer_tpu.pipeline import detector as jdet
from codeformer_tpu.utils.checkpoint import init_params_fast
from codeformer_tpu_torch.models import yolov5face
from codeformer_tpu_torch.pipeline import detector as pdet
from codeformer_tpu_torch.pipeline import device_pipeline as pdp
from codeformer_tpu_torch.utils.convert import flax_to_state_dict
from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY

torch.set_num_threads(2)
# fp32 convs summed in another order through the graph, relative to the
# largest value of each of the 16 columns: measured 3e-7
PRED_RTOL = 1e-4
# detections (boxes, scores and landmarks, input pixels; scores in
# [0, 1]): the same fp32 predictions picked by the same NMS
DET_ATOL = 1e-3


def _perturbed(variables, seed):
    """BatchNorm statistics and biases off their init: running variances
    down to 0.05, where eps 1e-3 against 1e-5 moves the output."""
    v = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.default_rng(seed)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            v['batch_stats'])[0]:
        name = path[-1].key
        leaf[:] = (rng.normal(0, 0.1, leaf.shape) if name == 'mean'
                   else rng.uniform(0.05, 1.0, leaf.shape))
    for path, leaf in jax.tree_util.tree_flatten_with_path(v['params'])[0]:
        if path[-1].key == 'bias':
            leaf[:] = rng.normal(0, 0.05, leaf.shape)
    return v


def _load(model, v):
    model.load_state_dict(flax_to_state_dict(v, like=model.state_dict()),
                          strict=True)
    return model


@pytest.mark.parametrize('variant', ['yolov5n', 'yolov5l'])
def test_yoloface_matches_jax(variant):
    jmodel = JYoloFace(variant=variant)
    v = _perturbed(init_params_fast(jmodel, jnp.zeros((1, 64, 64, 3)),
                                    seed=0), seed=1)
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 96, 3)) \
        .astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(v, jnp.asarray(x)))
    model = _load(yolov5face.YoloFace(variant).eval(), v)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    # 3 anchors at strides 8, 16, 32 of a 64 x 96 input
    assert got.shape == want.shape == (2, 3 * (96 + 24 + 6), 16)
    scale = np.abs(want).max(axis=(0, 1))
    err = (np.abs(got - want).max(axis=(0, 1)) / scale).max()
    assert err <= PRED_RTOL, err
    # the BatchNorm epsilon shows at this tolerance
    bn = [m for m in model.modules()
          if isinstance(m, torch.nn.BatchNorm2d) and m.eps == 1e-3]
    for m in bn:
        m.eps = 1e-5
    with torch.no_grad():
        wrong = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert (np.abs(wrong - want).max(axis=(0, 1)) / scale).max() \
        > 10 * PRED_RTOL


def test_yoloface_reference_names():
    assert ARCH_REGISTRY.get('YoloFace') is yolov5face.YoloFace
    n = yolov5face.YoloFace('yolov5n').state_dict()
    for k in ('model.0.stem_1.conv.weight', 'model.0.stem_3.bn.running_var',
              'model.1.branch1.0.weight', 'model.1.branch2.6.weight',
              'model.2.0.branch2.3.weight',
              'model.4.6.branch2.5.weight', 'model.10.cv1.conv.weight',
              'model.10.m.0.cv2.bn.weight', 'model.21.m.2.bias'):
        assert k in n, k
    assert n['model.2.0.branch2.3.weight'].shape == (64, 1, 3, 3)
    big = yolov5face.YoloFace('yolov5l').state_dict()
    for k in ('model.7.cv2.conv.weight', 'model.3.m.8.cv1.bn.weight',
              'model.23.m.0.weight'):
        assert k in big, k


def test_shuffle_block_order():
    """ShuffleV2 at stride 1: the first half passes, the second takes
    branch2, then channels interleave (0, C/2, 1, C/2 + 1, ...)."""
    blk = yolov5face.ShuffleV2Block(8, 8, 1).eval()
    with torch.no_grad():
        for p in blk.branch2.parameters():
            p.zero_()
    x = torch.arange(8.0).view(1, 8, 1, 1).expand(1, 8, 2, 2)
    with torch.no_grad():
        out = blk(x)[0, :, 0, 0]
    torch.testing.assert_close(out[0::2], torch.arange(4.0))
    torch.testing.assert_close(out[1::2], torch.zeros(4))


def _detector_pair(name):
    """The JAX detector's seeded weights in both (at init: the perturbed
    statistics above saturate every score at this depth)."""
    jd = jdet.YoloFaceDetector(name, allow_random=True)
    pd = pdet.YoloFaceDetector(name, allow_random=True, device='cpu')
    _load(pd.model, jax.tree_util.tree_map(np.asarray, jd.variables))
    return jd, pd


def _sorted_rows(rows):
    return rows[np.lexsort(rows[:, ::-1].T)] if len(rows) else rows


@pytest.mark.parametrize('name', ['YOLOv5n', 'YOLOv5l'])
def test_detector_matches_jax(name):
    """detect_faces on a 90 x 150 image (padded to 96 x 160) at three
    thresholds that let dozens (past the first keep bucket of 32), some
    and no rows through: the same rows, compared as sets (sorted by
    score then box)."""
    jd, pd = _detector_pair(name)
    img = np.random.default_rng(4).integers(0, 256, (90, 150, 3),
                                            dtype=np.uint8)
    with torch.no_grad():
        pred = pd.model(pd._host_batch(img[None])[0])[0].numpy()
    scores = np.sort(pred[:, 4] * pred[:, 15])[::-1]

    def between(lo, hi):
        """A threshold mid-way in the widest gap between the lo-th and
        hi-th scores, away from any row's score."""
        k = lo + int(np.argmax(scores[lo:hi] - scores[lo + 1:hi + 1]))
        return float(scores[k] + scores[k + 1]) / 2

    counts = []
    for thr in (between(100, 140), between(8, 16), 1.0):
        want = jd.detect_faces(img, conf_threshold=thr)
        got = pd.detect_faces(img, conf_threshold=thr)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(_sorted_rows(got), _sorted_rows(want),
                                   rtol=0, atol=DET_ATOL)
        counts.append(len(got))
    assert counts[0] > 32 and counts[0] > counts[1] > 0 and counts[2] == 0
    assert pd.model.model[0].stem_1.conv.weight.device.type == 'cpu'


def test_factory_and_device():
    """init_detection_model builds the YOLO detector; weights are read
    from weights/facelib or refused; CUDA without a card raises rather
    than running on the CPU."""
    det = pdet.init_detection_model('YOLOv5l', allow_random=True,
                                    device='cpu')
    assert isinstance(det, pdet.YoloFaceDetector)
    assert isinstance(det.model.model[7], yolov5face.SPP)
    assert not hasattr(det, 'batched_detect_faces')
    with pytest.raises(FileNotFoundError, match='yolov5n-face.pth'):
        pdet.YoloFaceDetector('YOLOv5n', device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            pdet.YoloFaceDetector('YOLOv5n', allow_random=True)


def test_device_pipeline_refuses_yolo():
    class _Helper:
        face_detector = pdet.YoloFaceDetector('YOLOv5n', allow_random=True,
                                              device='cpu')
        use_parse = True

    class _Restorer:
        device = torch.device('cpu')

    with pytest.raises(NotImplementedError,
                       match='YOLO keeps its own host preprocessing'):
        pdp.DeviceRestorePipeline(_Restorer(), _Helper())

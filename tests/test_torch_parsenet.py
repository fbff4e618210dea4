"""The port's parser and parse-mask shaping against the JAX package's:
ParseNet at full width on a 64x64 input (the same weights through
flax_to_state_dict, BatchNorm statistics perturbed), and
_shape_parse_masks (colormap, double Gaussian, border zeroing, resize to
the face) at res 64 and 128, a CPU-sized stand-in for the pipeline's 256
and 512 (the kernel, sigma and border scale with res/512 the same way)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeformer_tpu.models import ParseNet as JParseNet
from codeformer_tpu.pipeline import compositor_xla as jcomp
from codeformer_tpu.utils.checkpoint import init_params_fast
from codeformer_tpu_torch.models.parsenet import ParseNet
from codeformer_tpu_torch.pipeline import compositor as pcomp
from codeformer_tpu_torch.utils.convert import flax_to_state_dict

# fp32 convs summed in another order over 27 layers: < 1e-5 of the
# largest output (random weights reach 1e5; measured 4e-6)
MODEL_RTOL = 1e-5
# soft masks in [0, 1]: blurs of the same fp32 taps in another order,
# then the same resize
MASK_ATOL = 1e-5


def _jax_parsenet(seed):
    model = JParseNet()
    v = jax.tree_util.tree_map(
        np.asarray, init_params_fast(model, jnp.zeros((1, 64, 64, 3)),
                                     seed=seed))
    rng = np.random.default_rng(seed)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            v['batch_stats'])[0]:
        node = v['batch_stats']
        for k in path[:-1]:
            node = node[k.key]
        name = path[-1].key
        node[name] = (rng.normal(0, 0.1, leaf.shape) if name == 'mean'
                      else rng.uniform(0.5, 1.5, leaf.shape)) \
            .astype(np.float32)
    return model, v


def test_parsenet_matches_jax():
    model, v = _jax_parsenet(seed=3)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 3)) \
        .astype(np.float32)
    want = model.apply(v, jnp.asarray(x))
    port = ParseNet().eval()
    port.load_state_dict(flax_to_state_dict(v, like=port.state_dict()),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for name, g, w in zip(('mask', 'img'), got, want):
        g = g.permute(0, 2, 3, 1).numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, name
        err = float(np.abs(g - w).max())
        assert err <= MODEL_RTOL * float(np.abs(w).max()), (name, err)
    # the parse ids the pipeline takes
    np.testing.assert_array_equal(
        got[0].argmax(1).numpy(), np.asarray(jnp.argmax(want[0], -1)))


@pytest.mark.parametrize('res,face', [(64, 64), (64, 128), (128, 128)])
def test_shape_parse_masks_matches_jax(res, face):
    """A disc of skin (class 1, mask 255), some hair (class 17, mask 0)
    and random classes: the soft masks agree."""
    rng = np.random.default_rng(res + face)
    yy, xx = np.mgrid[0:res, 0:res]
    d = np.hypot(yy - res / 2, xx - res / 2)
    ids = np.where(d < res * 0.35, 1, 0)
    ids[: res // 4] = 17
    ids[rng.uniform(size=ids.shape) < 0.1] = rng.integers(0, 19)
    ids = np.stack([ids, np.roll(ids, 5, axis=1)]).astype(np.int32)
    want = np.asarray(jcomp._shape_parse_masks(jnp.asarray(ids), face, 2))
    got = pcomp._shape_parse_masks(torch.from_numpy(ids), face)
    assert got.shape == (2, 1, face, face)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=MASK_ATOL)
    assert 0.0 <= got.min() and got.max() <= 1.0 + 1e-6


def test_colormap_matches_jax():
    ids = torch.arange(19).reshape(1, 19)
    np.testing.assert_array_equal(
        pcomp.colormap_lookup(ids).numpy(),
        np.asarray(jcomp._colormap_lookup(jnp.arange(19).reshape(1, 19))))


def test_face_helper_matches_jax():
    """FaceRestoreHelper: the same template (with crop_ratio) and face
    size, and _parse_masks (resize to 512, ParseNet, argmax) on the same
    weights gives the same class ids, up to argmax flips of fp32 near-ties
    (read: none)."""
    pytest.importorskip('cv2')
    from codeformer_tpu.pipeline.face_helper import \
        FaceRestoreHelper as JHelper
    from codeformer_tpu_torch.pipeline.face_helper import FaceRestoreHelper
    for ratio in ((1, 1), (1.2, 1.1)):
        jh = JHelper(2, crop_ratio=ratio, det_model='retinaface_mobile0.25',
                     use_parse=True, allow_random_weights=True)
        ph = FaceRestoreHelper(2, crop_ratio=ratio,
                               det_model='retinaface_mobile0.25',
                               use_parse=True, device='cpu',
                               allow_random_weights=True)
        np.testing.assert_array_equal(ph.face_template, jh.face_template)
        assert ph.face_size == jh.face_size
    ph._parse_model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jh._parse_vars),
        like=ph._parse_model.state_dict()), strict=True)
    faces = [np.random.default_rng(1).integers(0, 256, (96, 96, 3))
             .astype(np.uint8)]
    got, want = ph._parse_masks(faces), jh._parse_masks(faces)
    assert got.shape == want.shape == (1, 512, 512)
    assert (got == want).mean() >= 0.999

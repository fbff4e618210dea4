"""The port's geometry ops (codeformer_tpu_torch/ops/geometry.py) and its
numpy copies against the JAX package's on the same seeded inputs:
warp_affine (uint8 and fp32 sources, constant and gray borders, the
coverage mask, img_idx), resize_linear against jax.image.resize shrinking
and growing, and estimate_similarity / invert_affine / img_util equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import jax

from codeformer_tpu.ops import geometry as jgeo
from codeformer_tpu.utils import img_util as jimg
from codeformer_tpu_torch.ops import geometry as pgeo
from codeformer_tpu_torch.utils import img_util as pimg

FACE_TEMPLATE_512 = np.array([
    [192.98138, 239.94708], [318.90277, 240.1936], [256.63416, 314.01935],
    [201.26117, 371.41043], [313.08905, 371.15118]], np.float32)

# The two invert the 2x3 matrix differently (JAX: a 3x3 LU in fp32; the
# port: the closed form), so sample coordinates differ by ~1e-6 relative;
# at a 0..255 image's steepest gradient that moves a value by < 1e-2.
# Coverage is the same sum of the same weights.
VALUE_ATOL = 2e-2
COVERAGE_ATOL = 1e-4


def _matrices(n, seed=0):
    rng = np.random.default_rng(seed)
    ms = []
    for k in range(n):
        th = rng.uniform(-0.6, 0.6)
        s = rng.uniform(0.6, 1.4)
        ms.append([[np.cos(th) * s, -np.sin(th) * s, rng.uniform(-20, 20)],
                   [np.sin(th) * s, np.cos(th) * s, rng.uniform(-20, 20)]])
    return np.asarray(ms, np.float32)


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
@pytest.mark.parametrize('border', [0.0, 135.0, (135.0, 133.0, 132.0)])
def test_warp_affine_matches_jax(dtype, border):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (3, 60, 72, 3)).astype(dtype)
    ms = _matrices(3)
    want, want_cov = jgeo.warp_affine(
        jnp.asarray(img), jnp.asarray(ms), (48, 40),
        border_value=jnp.asarray(border, jnp.float32),
        return_coverage=True)
    got, cov = pgeo.warp_affine(torch.from_numpy(img), ms, (48, 40),
                                border_value=border, return_coverage=True)
    assert got.shape == (3, 48, 40, 3) and cov.shape == (3, 48, 40, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=VALUE_ATOL)
    np.testing.assert_allclose(cov.numpy(), np.asarray(want_cov), rtol=0,
                               atol=COVERAGE_ATOL)
    # the border shows where nothing of the image lands
    outside = cov.numpy()[..., 0] == 0
    assert outside.any()
    np.testing.assert_allclose(got.numpy()[outside],
                               np.broadcast_to(border, (outside.sum(), 3)),
                               atol=1e-4)


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_warp_affine_img_idx(dtype):
    """img_idx equals warping img[img_idx] exactly (repeated and
    out-of-order indices), and matches JAX's img_idx warp."""
    rng = np.random.default_rng(5)
    idx = np.array([2, 0, 2, 1, 1, 2], np.int32)
    ms = _matrices(len(idx), seed=3)
    img = rng.uniform(0, 255, (3, 60, 72, 3)).astype(dtype)
    ref, ref_cov = pgeo.warp_affine(torch.from_numpy(img[idx]), ms, (48, 40),
                                    border_value=135.0, return_coverage=True)
    out, cov = pgeo.warp_affine(torch.from_numpy(img), ms, (48, 40),
                                border_value=135.0, return_coverage=True,
                                img_idx=torch.from_numpy(idx))
    assert torch.equal(out, ref) and torch.equal(cov, ref_cov)
    want = jgeo.warp_affine(jnp.asarray(img), jnp.asarray(ms), (48, 40),
                            border_value=135.0, img_idx=jnp.asarray(idx))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=VALUE_ATOL)


# (in, out): the detector's 720p -> 640 shrink, the parser's 512 -> 256,
# a 2x canvas upscale and the 256 -> 512 mask upsample. jax.image.resize
# antialiases when it shrinks, and so does resize_linear; the two build
# their filter weights in fp32 by different formulas, so values on 0..255
# differ by up to 2.7e-3 (1e-5 of the range) at 720 -> 640, 3e-5 growing.
RESIZE_ATOL = 5e-3


@pytest.mark.parametrize('shapes', [((720, 1280), (640, 1137)),
                                    ((512, 512), (256, 256)),
                                    ((96, 128), (192, 256)),
                                    ((256, 256), (512, 512))],
                         ids=['720to640', '512to256', 'x2', '256to512'])
def test_resize_linear_matches_jax(shapes):
    (h, w), (oh, ow) = shapes
    x = np.random.default_rng(2).uniform(0, 255, (2, h, w, 3)) \
        .astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, oh, ow, 3),
                                       'linear'))
    got = pgeo.resize_linear(torch.from_numpy(x).permute(0, 3, 1, 2),
                             (oh, ow)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def test_numpy_copies_equal_jax():
    """estimate_similarity, invert_affine and the img_util helpers are
    copies: equal outputs on the same inputs."""
    rng = np.random.default_rng(7)
    for k in range(4):
        src = FACE_TEMPLATE_512 * rng.uniform(0.3, 2.0) + \
            rng.normal(0, 15, (5, 2)).astype(np.float32)
        a = pgeo.estimate_similarity(src, FACE_TEMPLATE_512)
        np.testing.assert_array_equal(
            a, jgeo.estimate_similarity(src, FACE_TEMPLATE_512))
        for up in (1.0, 2.0):
            np.testing.assert_array_equal(pgeo.invert_affine(a, up),
                                          jgeo.invert_affine(a, up))
    cv2 = pytest.importorskip('cv2')
    img = rng.uniform(0, 255, (40, 50, 3)).astype(np.uint8)
    gray = np.repeat(img[..., :1], 3, axis=-1)
    for im in (img, gray):
        assert pimg.is_gray(im) == jimg.is_gray(im)
        np.testing.assert_array_equal(pimg.bgr2gray3(im), jimg.bgr2gray3(im))
        np.testing.assert_array_equal(pimg.adain_color_transfer(img, im),
                                      jimg.adain_color_transfer(img, im))
    assert pimg.is_gray(gray) and not pimg.is_gray(img)
    del cv2

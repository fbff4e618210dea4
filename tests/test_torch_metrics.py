"""PSNR/SSIM in the port (codeformer_tpu_torch/metrics, float64 torch, no
cv2) against the JAX package's (codeformer_tpu/metrics: numpy and
cv2.filter2D), and the image batch helpers against JAX's.

Tolerance: both compute in float64 and differ only in summation order
(a conv2d over the valid region against cv2.filter2D's), so 1e-10
absolute on PSNR (dB) and on SSIM.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from codeformer_tpu import metrics as jm  # noqa: E402
from codeformer_tpu.utils import img_util as jiu  # noqa: E402
from codeformer_tpu_torch import metrics as pm  # noqa: E402
from codeformer_tpu_torch.utils import img_util as piu  # noqa: E402

TOL = 1e-10


def _pair(seed, h=48, w=40):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    noise = rng.normal(0, 12, img.shape)
    img2 = np.clip(img + noise, 0, 255).astype(np.uint8)
    return img, img2


@pytest.mark.parametrize('name', ['calculate_psnr', 'calculate_ssim'])
@pytest.mark.parametrize('crop_border,test_y_channel', [
    (0, False), (4, False), (0, True), (4, True)])
def test_metrics_match_jax(name, crop_border, test_y_channel):
    for seed in (0, 1):
        img, img2 = _pair(seed)
        want = getattr(jm, name)(img, img2, crop_border=crop_border,
                                 test_y_channel=test_y_channel)
        got = getattr(pm, name)(img, img2, crop_border=crop_border,
                                test_y_channel=test_y_channel)
        assert isinstance(got, float)
        assert abs(got - want) <= TOL, (seed, got, want)
        # a tensor input computes on its device (here the host) alike
        got_t = getattr(pm, name)(torch.from_numpy(img),
                                  torch.from_numpy(img2),
                                  crop_border=crop_border,
                                  test_y_channel=test_y_channel)
        assert got_t == got


def test_calculate_metric_registry_and_edge_cases():
    img, img2 = _pair(2)
    for opt in ({'type': 'calculate_psnr', 'crop_border': 4,
                 'test_y_channel': False},
                {'type': 'calculate_ssim', 'crop_border': 0,
                 'test_y_channel': True}):
        want = jm.calculate_metric({'img': img, 'img2': img2}, opt)
        got = pm.calculate_metric({'img': img, 'img2': img2}, opt)
        assert abs(got - want) <= TOL
    assert pm.calculate_psnr(img, img) == float('inf')
    assert abs(pm.calculate_ssim(img, img) - 1.0) <= TOL
    with pytest.raises(ValueError, match='shapes differ'):
        pm.calculate_psnr(img, img2[:-1])
    with pytest.raises(KeyError, match='No object named'):
        pm.calculate_metric({'img': img, 'img2': img2}, {'type': 'lpips'})


def test_gaussian_window_is_cv2s():
    """The kernel is cv2's, and the separable valid-region filter equals
    cv2.filter2D with outer(k, k) cropped by 5 on each side."""
    import cv2
    k = cv2.getGaussianKernel(11, 1.5)
    np.testing.assert_allclose(pm.psnr_ssim.gaussian_kernel(), k[:, 0],
                               rtol=0, atol=1e-15)
    x = np.random.default_rng(4).uniform(0, 255, (40, 33))
    want = cv2.filter2D(x, -1, np.outer(k, k.T))[5:-5, 5:-5]
    got = pm.psnr_ssim._filter_valid(torch.from_numpy(x),
                                     pm.psnr_ssim.gaussian_kernel())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


def test_batch_helpers_match_jax():
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (16, 12, 3), dtype=np.uint8)
            for _ in range(3)]
    batch = jiu.imgs_to_batch(imgs)
    np.testing.assert_array_equal(piu.imgs_to_batch(imgs), batch)
    # values past [-1, 1] and on the rounding midpoints
    out = (batch * 1.3 + rng.normal(0, 0.01, batch.shape)).astype(np.float32)
    want = jiu.batch_to_imgs(out)
    for got in (piu.batch_to_imgs(out),
                list(piu.tensor_to_imgs(torch.from_numpy(out)).numpy())):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)

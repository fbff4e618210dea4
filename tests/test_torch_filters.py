"""The port's mask filters (codeformer_tpu_torch/ops/filters.py) against
the JAX package's on the same seeded inputs: the Gaussian blur with
REFLECT_101 borders at the paste-back's kernel sizes (101 and 51 taps of
the parse mask, small odd ones of the soft edge, and kernels wider than
the map), and erosion / dilation exactly, at even and odd sizes below
and above the JAX package's van Herk switch (16)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codeformer_tpu.ops import filters as jf
from codeformer_tpu_torch.ops import filters as pf

# both sum the same taps of the same fp32 kernel in fp32; JAX as a banded
# matmul, the port as a depthwise conv, so the order differs: relative to
# the 0..255 range the error stays at a few fp32 ulps of the sums
BLUR_ATOL = 2e-4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_gaussian_kernel1d_equal():
    for k, s in ((101, 11.0), (51, 5.5), (9, 0.0), (21, 0.0)):
        np.testing.assert_array_equal(pf.gaussian_kernel1d(k, s),
                                      jf.gaussian_kernel1d(k, s))


@pytest.mark.parametrize('case', [(64, 80, 101, 11.0), (64, 64, 51, 5.5),
                                  (40, 56, 9, 0.0), (24, 30, 33, 0.0),
                                  (96, 72, 17, 0.0)],
                         ids=['101-wider', '51-wider', '9', '33-wider',
                              '17'])
def test_gaussian_blur_matches_jax(case):
    h, w, k, sigma = case
    x = np.random.default_rng(k).uniform(0, 255, (2, h, w, 3)) \
        .astype(np.float32)
    want = np.asarray(jf.gaussian_blur(jnp.asarray(x), k, sigma))
    got = _nhwc(pf.gaussian_blur(_nchw(x), k, sigma))
    np.testing.assert_allclose(got, want, rtol=0, atol=BLUR_ATOL)


@pytest.mark.parametrize('ksize', [3, 4, 7, 8, 16, 17, 32, 64])
def test_erode_dilate_equal_jax(ksize):
    """Exact: min/max of the same values, cv2's anchor for even sizes."""
    rng = np.random.default_rng(ksize)
    cov = (rng.uniform(0, 1, (2, 70, 90, 1)) > 0.1).astype(np.float32)
    cov *= rng.uniform(0.5, 1.0, cov.shape).astype(np.float32)
    for jfn, pfn in ((jf.erode, pf.erode), (jf.dilate, pf.dilate)):
        want = np.asarray(jfn(jnp.asarray(cov), ksize))
        got = _nhwc(pfn(_nchw(cov), ksize))
        np.testing.assert_array_equal(got, want)


def test_erode_anchor_is_cv2s():
    """An even window reaches k//2 pixels back and k-1-k//2 forward: at
    k = 4 output i sees [i-2, i+1], so a zero at column 10 erodes
    columns 9..12."""
    m = torch.ones(1, 1, 1, 20)
    m[..., 10] = 0
    out = pf.erode(m, 4)[0, 0, 0]
    assert torch.nonzero(out == 0).flatten().tolist() == [9, 10, 11, 12]

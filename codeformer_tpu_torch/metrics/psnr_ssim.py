"""PSNR / SSIM, MATLAB-equivalent (the port's copy of
codeformer_tpu/metrics/psnr_ssim.py; reference basicsr/metrics/
psnr_ssim.py): crop_border, optional Y-channel evaluation, an 11x11
Gaussian-window SSIM with sigma 1.5 and C1/C2 for k1 = 0.01, k2 = 0.03,
L = 255.

Inputs are HWC images in [0, 255] (uint8 or float; BGR or RGB, the same
for both), numpy arrays or torch tensors. The arithmetic is float64 torch
on the input's device, so validation on the card computes its metrics
there; numpy inputs run on the host. No cv2: the window is
cv2.getGaussianKernel(11, 1.5) in its closed form, and the SSIM filter
is that separable window applied over the valid region, which is what
the JAX copy keeps of cv2.filter2D after its [5:-5, 5:-5] crop (the
border mode never reaches the result). The filter is 22 scaled shifted
adds in a fixed order, not a library convolution (whose algorithm, an
FFT one among them, cuDNN picks), so the card and the host compute the
same sums.
"""
from __future__ import annotations

import math

import torch

from codeformer_tpu_torch.utils.registry import METRIC_REGISTRY

# ITU-R BT.601 luma of RGB in [0, 1] (matlab rgb2ycbcr)
_Y_WEIGHTS = (65.481, 128.553, 24.966)


def _f64(img) -> torch.Tensor:
    return torch.as_tensor(img).to(torch.float64)


def _crop(img: torch.Tensor, crop_border: int) -> torch.Tensor:
    if crop_border == 0:
        return img
    return img[crop_border:-crop_border, crop_border:-crop_border, ...]


def _to_y_channel(img: torch.Tensor) -> torch.Tensor:
    """BGR [0, 255] -> Y [0, 255], (H, W, 1): the channels scaled to
    [0, 1] in float32, the weighted sum in float64, as the JAX copy's
    numpy dot. The divisor is a tensor: by a Python scalar, CUDA
    multiplies by its reciprocal, one float32 ulp off the quotient."""
    x = img.to(torch.float32)
    x = (x / torch.full_like(x, 255.0)).to(torch.float64).flip(-1)
    w = torch.tensor(_Y_WEIGHTS, dtype=torch.float64, device=img.device)
    return (x @ w + 16.0)[..., None]


def _prepare(img, img2, crop_border: int, test_y_channel: bool):
    img, img2 = _f64(img), _f64(img2)
    if img.shape != img2.shape:
        raise ValueError(f'image shapes differ: {tuple(img.shape)} and '
                         f'{tuple(img2.shape)}')
    img, img2 = _crop(img, crop_border), _crop(img2, crop_border)
    if test_y_channel:
        img, img2 = _to_y_channel(img), _to_y_channel(img2)
    return img, img2


@METRIC_REGISTRY.register()
def calculate_psnr(img, img2, crop_border: int = 0,
                   test_y_channel: bool = False, **kwargs) -> float:
    """psnr_ssim.py:8-46."""
    img, img2 = _prepare(img, img2, crop_border, test_y_channel)
    mse = float(((img - img2) ** 2).mean())
    if mse == 0:
        return float('inf')
    return 20.0 * math.log10(255.0 / math.sqrt(mse))


def gaussian_kernel(size: int = 11, sigma: float = 1.5) -> list:
    """cv2.getGaussianKernel(size, sigma) as floats: k_i =
    exp(-(i - (size-1)/2)^2 / (2 sigma^2)), normalised to sum 1."""
    k = [math.exp(-((i - (size - 1) / 2) ** 2) / (2 * sigma * sigma))
         for i in range(size)]
    total = sum(k)
    return [v / total for v in k]


def _filter_valid(x: torch.Tensor, k: list) -> torch.Tensor:
    """The window outer(k, k) over the valid region of (H, W) x: the
    rows, then the columns, each as len(k) scaled shifted adds."""
    n = len(k)
    h, w = x.shape
    rows = sum(k[i] * x[i:i + h - n + 1] for i in range(n))
    return sum(k[j] * rows[:, j:j + w - n + 1] for j in range(n))


def _ssim_single(img: torch.Tensor, img2: torch.Tensor) -> float:
    """11x11 Gaussian-window SSIM on one (H, W) channel
    (psnr_ssim.py:49-80), over the valid region of the filter."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    k = gaussian_kernel()

    def filt(x):
        return _filter_valid(x, k)
    mu1, mu2 = filt(img), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = filt(img ** 2) - mu1_sq
    sigma2_sq = filt(img2 ** 2) - mu2_sq
    sigma12 = filt(img * img2) - mu1_mu2
    ssim_map = (((2 * mu1_mu2 + c1) * (2 * sigma12 + c2))
                / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)))
    return float(ssim_map.mean())


@METRIC_REGISTRY.register()
def calculate_ssim(img, img2, crop_border: int = 0,
                   test_y_channel: bool = False, **kwargs) -> float:
    """psnr_ssim.py:83-128: the mean over channels of _ssim_single."""
    img, img2 = _prepare(img, img2, crop_border, test_y_channel)
    ssims = [_ssim_single(img[..., i].contiguous(), img2[..., i].contiguous())
             for i in range(img.shape[2])]
    return float(sum(ssims) / len(ssims))

"""Mask filters of the paste-back, counterpart of
codeformer_tpu/ops/filters.py: an OpenCV-style Gaussian kernel, a
separable Gaussian blur with REFLECT_101 borders (cv2.GaussianBlur's
default) and exact erosion and dilation with a square structuring
element and cv2's anchor. NCHW float tensors; every channel is filtered
on its own.

The blur gathers its border with the JAX package's index folding
(`_reflect_blur_matrix`: one reflection, then clamped), which also
serves kernels wider than the map, where `F.pad(mode='reflect')`
refuses; then a depthwise conv per axis with TF32 off. The min/max
filters pad with the neutral value on cv2's asymmetric anchor for even
sizes (k//2 before, k-1-k//2 after) and run as two 1-D pools.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """OpenCV getGaussianKernel semantics: if sigma <= 0,
    sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _reflect_index(n: int, ksize: int) -> np.ndarray:
    """Source index of each of the n + ksize - 1 padded positions under
    BORDER_REFLECT_101 (...cba|abcd|cba...), folded as the JAX package
    folds it: one reflection at each end, then clamped to the map."""
    src = np.arange(n + ksize - 1) - ksize // 2
    src = np.abs(src)
    src = np.where(src >= n, 2 * (n - 1) - src, src)
    return np.clip(src, 0, n - 1)


def _blur_axis(x: torch.Tensor, k: torch.Tensor, dim: int) -> torch.Tensor:
    n, c = x.shape[dim], x.shape[1]
    idx = torch.as_tensor(_reflect_index(n, k.numel()), device=x.device)
    xp = x.index_select(dim, idx)
    shape = (c, 1, k.numel(), 1) if dim == 2 else (c, 1, 1, k.numel())
    return F.conv2d(xp, k.reshape(1, 1, *shape[2:]).expand(shape),
                    groups=c)


def gaussian_blur(img: torch.Tensor, ksize: int,
                  sigma: float = 0.0) -> torch.Tensor:
    """Separable Gaussian blur of an NCHW batch with REFLECT_101 borders
    (cv2.GaussianBlur's default border), in fp32; returns img's dtype."""
    k = torch.as_tensor(gaussian_kernel1d(ksize, sigma), device=img.device)
    x = img.float()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = _blur_axis(_blur_axis(x, k, 2), k, 3)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return x.to(img.dtype)


def _max_filter(m: torch.Tensor, ksize: int) -> torch.Tensor:
    """Separable ksize x ksize sliding maximum with cv2's anchor; outside
    the map counts as -inf (the neutral value)."""
    p0, p1 = ksize // 2, ksize - 1 - ksize // 2
    m = F.pad(m, (0, 0, p0, p1), value=-torch.inf)
    m = F.max_pool2d(m, (ksize, 1), stride=1)
    m = F.pad(m, (p0, p1, 0, 0), value=-torch.inf)
    return F.max_pool2d(m, (1, ksize), stride=1)


def erode(mask: torch.Tensor, ksize: int) -> torch.Tensor:
    """Morphological erosion with a ksize x ksize all-ones structuring
    element (cv2.erode semantics): a sliding minimum. NCHW float."""
    return (-_max_filter(-mask.float(), ksize)).to(mask.dtype)


def dilate(mask: torch.Tensor, ksize: int) -> torch.Tensor:
    """Morphological dilation: a sliding maximum. NCHW float."""
    return _max_filter(mask.float(), ksize).to(mask.dtype)

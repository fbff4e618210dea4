"""Blur-kernel zoo and degradation primitives for blind-restoration
training.

Equivalents of the reference kernel generators
(basicsr/data/gaussian_kernels.py): isotropic/anisotropic bivariate
Gaussian, generalized Gaussian, plateau kernels, and the
`random_mixed_kernels` dispatcher, plus Gaussian noise and cv2 JPEG
round-trips. All host-side numpy (the degradations feed the loader; the
device never sees them).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import cv2
import numpy as np


def _mesh_grid(kernel_size: int):
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    return np.stack([xx, yy], axis=-1)  # (k, k, 2)


def _sigma_matrix(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    d = np.array([[sig_x ** 2, 0], [0, sig_y ** 2]])
    u = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def bivariate_gaussian(kernel_size: int, sig_x: float,
                       sig_y: Optional[float] = None,
                       theta: float = 0.0,
                       isotropic: bool = True) -> np.ndarray:
    """Normalized bivariate Gaussian kernel."""
    xy = _mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
    else:
        sigma = _sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    k = np.exp(-0.5 * np.einsum('hwi,ij,hwj->hw', xy, inv, xy))
    return (k / k.sum()).astype(np.float32)


def bivariate_generalized_gaussian(kernel_size: int, sig_x: float,
                                   sig_y: Optional[float] = None,
                                   theta: float = 0.0, beta: float = 1.0,
                                   isotropic: bool = True) -> np.ndarray:
    """exp(-0.5 * (x^T S^-1 x)^beta) — heavier/lighter tails than Gaussian."""
    xy = _mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
    else:
        sigma = _sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    q = np.einsum('hwi,ij,hwj->hw', xy, inv, xy)
    k = np.exp(-0.5 * np.power(q, beta))
    return (k / k.sum()).astype(np.float32)


def bivariate_plateau(kernel_size: int, sig_x: float,
                      sig_y: Optional[float] = None, theta: float = 0.0,
                      beta: float = 1.0, isotropic: bool = True
                      ) -> np.ndarray:
    """1 / (1 + (x^T S^-1 x)^beta) plateau-shaped kernel."""
    xy = _mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
    else:
        sigma = _sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    q = np.einsum('hwi,ij,hwj->hw', xy, inv, xy)
    k = 1.0 / (np.power(q, beta) + 1.0)
    return (k / k.sum()).astype(np.float32)


def bivariate_skew_gaussian_center(kernel_size: int, sig_x: float,
                                   sig_y: float, theta: float,
                                   d_skew: np.ndarray) -> np.ndarray:
    """Skew-normal kernel (pdf * skewed standard-normal cdf), re-centered
    on its mass center with nearest-padding shift
    (gaussian_kernels.py:70-136, Shi et al. 2004)."""
    from scipy.ndimage import shift as nd_shift
    from scipy.stats import multivariate_normal
    xy = _mesh_grid(kernel_size)
    sigma = _sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    pdf = np.exp(-0.5 * np.einsum('hwi,ij,hwj->hw', xy, inv, xy))
    rv = multivariate_normal([0, 0], [[1, 0], [0, 1]])
    cdf = rv.cdf(xy @ np.asarray(d_skew, np.float64))
    k = pdf * cdf
    k = k / k.sum()
    # mass-center shift (gaussian_kernels.py:98-110)
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    col_sum, row_sum = k.sum(axis=0), k.sum(axis=1)
    delta_h = row_sum @ ax
    delta_w = col_sum @ ax
    k = nd_shift(k, [-delta_h, -delta_w], mode='nearest')
    return (k / k.sum()).astype(np.float32)


def random_bivariate_skew_gaussian_center(
        kernel_size, sigma_x_range, sigma_y_range, rotation_range,
        rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random skew kernel: skew matrix D ~ U(-3/sigma_max, 3/sigma_max)
    (gaussian_kernels.py:259-305)."""
    rng = rng or np.random.default_rng()
    sig_x = rng.uniform(*sigma_x_range)
    sig_y = rng.uniform(*sigma_y_range)
    theta = rng.uniform(*rotation_range)
    thres = 3.0 / max(sig_x, sig_y)
    d_skew = rng.uniform(-thres, thres, (2, 2))
    return bivariate_skew_gaussian_center(kernel_size, sig_x, sig_y,
                                          theta, d_skew)


def random_bivariate_gaussian(kernel_size, sigma_x_range, sigma_y_range,
                              rotation_range, isotropic=True,
                              rng: Optional[np.random.Generator] = None):
    rng = rng or np.random.default_rng()
    sig_x = rng.uniform(*sigma_x_range)
    if isotropic:
        return bivariate_gaussian(kernel_size, sig_x, isotropic=True)
    # sigma_y draws over its own full range, like the reference
    # (gaussian_kernels.py:330-332)
    sig_y = rng.uniform(*sigma_y_range)
    theta = rng.uniform(*rotation_range)
    return bivariate_gaussian(kernel_size, sig_x, sig_y, theta,
                              isotropic=False)


def random_mixed_kernels(kernel_list: Sequence[str],
                         kernel_prob: Sequence[float],
                         kernel_size: int,
                         sigma_x_range: Tuple[float, float],
                         sigma_y_range: Tuple[float, float],
                         rotation_range: Tuple[float, float] = (-math.pi,
                                                                math.pi),
                         betag_range: Tuple[float, float] = (0.5, 8),
                         betap_range: Tuple[float, float] = (0.5, 8),
                         noise_range=None,
                         rng: Optional[np.random.Generator] = None
                         ) -> np.ndarray:
    """Dispatcher over the kernel zoo (gaussian_kernels.py:519+)."""
    rng = rng or np.random.default_rng()
    kind = rng.choice(list(kernel_list), p=list(kernel_prob))
    if kind == 'iso':
        k = random_bivariate_gaussian(kernel_size, sigma_x_range,
                                      sigma_y_range, rotation_range,
                                      isotropic=True, rng=rng)
    elif kind == 'aniso':
        k = random_bivariate_gaussian(kernel_size, sigma_x_range,
                                      sigma_y_range, rotation_range,
                                      isotropic=False, rng=rng)
    elif kind == 'skew':
        k = random_bivariate_skew_gaussian_center(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            rng=rng)
    elif kind in ('generalized', 'generalized_aniso'):
        k = bivariate_generalized_gaussian(
            kernel_size, rng.uniform(*sigma_x_range),
            rng.uniform(*sigma_y_range), rng.uniform(*rotation_range),
            rng.uniform(*betag_range), isotropic=False)
    elif kind == 'generalized_iso':
        k = bivariate_generalized_gaussian(
            kernel_size, rng.uniform(*sigma_x_range),
            beta=rng.uniform(*betag_range), isotropic=True)
    elif kind == 'plateau_iso':
        k = bivariate_plateau(kernel_size, rng.uniform(*sigma_x_range),
                              beta=rng.uniform(*betap_range),
                              isotropic=True)
    elif kind == 'plateau_aniso':
        k = bivariate_plateau(kernel_size, rng.uniform(*sigma_x_range),
                              rng.uniform(*sigma_y_range),
                              rng.uniform(*rotation_range),
                              rng.uniform(*betap_range), isotropic=False)
    else:
        raise ValueError(f'unknown kernel type {kind}')
    if noise_range is not None:
        noise = rng.uniform(noise_range[0], noise_range[1], k.shape)
        k = k * noise
        k = k / k.sum()
    return k.astype(np.float32)


def add_gaussian_noise(img01: np.ndarray, sigma: float,
                       rng: Optional[np.random.Generator] = None
                       ) -> np.ndarray:
    """img in [0,1]; sigma in [0,1] units (ffhq_blind_dataset.py:226-230)."""
    rng = rng or np.random.default_rng()
    noise = rng.standard_normal(img01.shape).astype(np.float32) * sigma
    return np.clip(img01 + noise, 0, 1)


def jpeg_compress(img01: np.ndarray, quality: int) -> np.ndarray:
    """cv2 JPEG round-trip (ffhq_blind_dataset.py:233-237)."""
    encode_param = [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)]
    _, enc = cv2.imencode('.jpg', img01 * 255.0, encode_param)
    return np.float32(cv2.imdecode(enc, 1)) / 255.0

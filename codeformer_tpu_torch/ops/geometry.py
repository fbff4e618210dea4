"""Batched affine warps, the linear resize and the similarity solve of the
whole-image path, counterpart of codeformer_tpu/ops/geometry.py.

`warp_affine` follows cv2.warpAffine (bilinear, constant border; the
matrix maps source -> destination and is inverted here) with its own
index arithmetic rather than `F.grid_sample`'s coordinate conventions.
`resize_linear` is `jax.image.resize(..., 'linear')`: half-pixel centres,
and a triangle filter widened by the scale where an axis shrinks
(antialiasing). `estimate_similarity` and `invert_affine` are numpy
copies of the JAX package's (the host solves per face).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def _invert_2x3(m: torch.Tensor) -> torch.Tensor:
    """(B, 2, 3) affine -> its inverse (B, 2, 3), closed form, no device
    synchronisation (torch.linalg.inv checks singularity on the host)."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    det = a * e - b * d
    inv = torch.stack([torch.stack([e, -b, b * f - c * e], -1),
                       torch.stack([-d, a, c * d - a * f], -1)], 1)
    return inv / det[:, None, None]


def warp_affine(img: torch.Tensor, matrix, out_hw: Tuple[int, int],
                border_value: Union[float, Sequence[float]] = 0.0,
                return_coverage: bool = False,
                img_idx: Optional[torch.Tensor] = None):
    """Bilinear affine warp of an NHWC batch with per-item 2x3 matrices.

    img: (B, H, W, C), uint8 or float; a uint8 source is gathered as
    bytes and interpolated in fp32. matrix: (M, 2, 3) source -> dest.
    Returns (M, out_h, out_w, C) fp32, and with return_coverage also the
    warp of an all-ones image with a zero border, (M, out_h, out_w, 1),
    from the same weights. img_idx (M,): the m-th output samples
    img[img_idx[m]] (else M = B and output m samples img[m]), without
    building img[img_idx].
    """
    bsz, h, w, c = img.shape
    dev = img.device
    matrix = torch.as_tensor(matrix, dtype=torch.float32, device=dev)
    m = matrix.shape[0]
    out_h, out_w = out_hw
    inv = _invert_2x3(matrix)
    ys, xs = torch.meshgrid(torch.arange(out_h, dtype=torch.float32,
                                         device=dev),
                            torch.arange(out_w, dtype=torch.float32,
                                         device=dev), indexing='ij')
    xs, ys = xs.reshape(1, -1), ys.reshape(1, -1)
    sx = inv[:, 0, 0:1] * xs + inv[:, 0, 1:2] * ys + inv[:, 0, 2:3]
    sy = inv[:, 1, 0:1] * xs + inv[:, 1, 1:2] * ys + inv[:, 1, 2:3]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    if img_idx is None:
        base = torch.arange(m, device=dev) * (h * w)
    else:
        base = torch.as_tensor(img_idx, device=dev).long() * (h * w)
    flat = img.reshape(bsz * h * w, c)

    def corner(yv, xv):
        inside = (xv >= 0) & (xv < w) & (yv >= 0) & (yv < h)
        lin = base[:, None] + yv.clamp(0, h - 1) * w + xv.clamp(0, w - 1)
        g = flat[lin.reshape(-1)].reshape(m, -1, c).float()
        return g, inside[..., None].float()

    g00, m00 = corner(y0i, x0i)
    g01, m01 = corner(y0i, x0i + 1)
    g10, m10 = corner(y0i + 1, x0i)
    g11, m11 = corner(y0i + 1, x0i + 1)
    w00 = (1 - wx) * (1 - wy)
    w01 = wx * (1 - wy)
    w10 = (1 - wx) * wy
    w11 = wx * wy
    out = (g00 * (w00 * m00) + g01 * (w01 * m01) + g10 * (w10 * m10)
           + g11 * (w11 * m11))
    cov = w00 * m00 + w01 * m01 + w10 * m10 + w11 * m11
    border = torch.as_tensor(border_value, dtype=torch.float32, device=dev)
    out = out + (1.0 - cov) * border
    out = out.reshape(m, out_h, out_w, c)
    if return_coverage:
        return out, cov.reshape(m, out_h, out_w, 1)
    return out


def resize_linear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(x, ..., 'linear')` over the last two axes of an
    NCHW float tensor: bilinear with half-pixel centres when an axis
    grows, PIL-style antialiasing (the triangle widened by the scale,
    weights renormalised at the border) where an axis shrinks, as JAX
    does; held against JAX both ways in tests/test_torch_geometry.py."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(size):
        return x
    shrink = size[0] < h or size[1] < w
    return F.interpolate(x, size=tuple(size), mode='bilinear',
                         align_corners=False, antialias=shrink)


def estimate_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform (scale+rotation+translation)
    mapping src points to dst points, the cv2.estimateAffinePartial2D
    analog used for 5-landmark alignment
    (face_restoration_helper.py:335-337). With 5 clean landmark pairs the
    LMEDS robustification of cv2 degenerates to this least-squares solve.

    src, dst: (N, 2) float. Returns a 2x3 matrix (numpy, host-side).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = src.shape[0]
    # Umeyama closed form with uniform scale
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / n
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u @ vt))
    diag = np.diag([1.0, d])
    r = u @ diag @ vt
    var_s = (sc ** 2).sum() / n
    scale = np.trace(np.diag(s) @ diag) / var_s
    t = mu_d - scale * r @ mu_s
    m = np.zeros((2, 3))
    m[:, :2] = scale * r
    m[:, 2] = t
    return m


def invert_affine(matrix: np.ndarray, upscale: float = 1.0) -> np.ndarray:
    """Invert a 2x3 affine and scale it for upsampled output
    (cv2.invertAffineTransform + the x upscale of
    face_restoration_helper.py:351-361)."""
    m33 = np.vstack([matrix, [0.0, 0.0, 1.0]])
    inv = np.linalg.inv(m33)[:2, :]
    # the whole 2x3 scales: output coords grow by `upscale`
    return inv * upscale

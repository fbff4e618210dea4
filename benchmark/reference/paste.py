"""Plain alignment and paste-back in PyTorch and NumPy, float32: the
benchmark's reference for the whole-image pipeline around the restorer.

After sczhou/CodeFormer facelib/utils/face_restoration_helper.py
(`align_warp_face`, `paste_faces_to_input_image`) with the fused
pipeline's documented choices where they differ from it:
- the 5-point similarity is the least-squares (Umeyama) solve, which is
  what cv2.estimateAffinePartial2D's LMEDS gives on five clean points;
- ParseNet runs at `parse_res` (256 in the configuration): kernel, sigma
  and border of the mask's blurs scale by parse_res / 512 and the soft
  mask is resized to the face;
- the soft edge's width is one value a call, from the largest warped
  face's area, quantized to a multiple of 8 in [4, 64].
Warps are cv2.warpAffine's: bilinear, constant border, the matrix mapping
source to destination (here through `F.grid_sample` on the inverse).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# cv2 constant-border grey of align_warp_face, BGR
BORDER_BGR = (135.0, 133.0, 132.0)
# 19 parse classes -> face (255) or not (0) (face_restoration_helper.py:468)
MASK_COLORMAP = (0, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
                 255, 255, 0, 255, 0, 0, 0)


def similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity (uniform scale, rotation, translation)
    taking src points (N, 2) to dst points: 2 x 3, float64."""
    src, dst = np.asarray(src, np.float64), np.asarray(dst, np.float64)
    ms, md = src.mean(0), dst.mean(0)
    s, d = src - ms, dst - md
    u, sv, vt = np.linalg.svd(d.T @ s / len(src))
    e = np.diag([1.0, np.sign(np.linalg.det(u @ vt))])
    r = u @ e @ vt
    scale = np.trace(np.diag(sv) @ e) / ((s ** 2).sum() / len(src))
    m = np.zeros((2, 3))
    m[:, :2] = scale * r
    m[:, 2] = md - scale * r @ ms
    return m


def inverse_for_paste(m: np.ndarray, up: int) -> np.ndarray:
    """The face -> upscaled-frame affine of the paste-back: the inverse,
    times the upscale, shifted by half an upscaled pixel when up > 1
    (face_restoration_helper.py:393-398)."""
    inv = np.linalg.inv(np.vstack([m, [0.0, 0.0, 1.0]]))[:2] * up
    if up > 1:
        inv[:, 2] += 0.5 * up
    return inv


def warp(img: torch.Tensor, m: np.ndarray, out_hw, border=0.0):
    """cv2.warpAffine of one (H, W, C) float image by the source ->
    destination affine `m`: bilinear, constant `border`. Returns the
    (oh, ow, C) warp and its coverage (oh, ow, 1): the warp of ones with
    a zero border."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    inv = np.linalg.inv(np.vstack([m, [0.0, 0.0, 1.0]]))[:2]
    inv = torch.as_tensor(inv, dtype=torch.float64, device=img.device)
    ys, xs = torch.meshgrid(
        torch.arange(oh, dtype=torch.float64, device=img.device),
        torch.arange(ow, dtype=torch.float64, device=img.device),
        indexing='ij')
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    grid = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], -1)
    grid = grid[None].float()
    border = torch.as_tensor(border, dtype=torch.float32, device=img.device)
    src = torch.cat([img - border, torch.ones_like(img[..., :1])], -1)
    out = F.grid_sample(src.permute(2, 0, 1)[None], grid, mode='bilinear',
                        padding_mode='zeros', align_corners=True)[0]
    out = out.permute(1, 2, 0)
    return out[..., :-1] + border, out[..., -1:]


def gaussian_kernel(ksize: int, sigma: float) -> torch.Tensor:
    """cv2.getGaussianKernel."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-x ** 2 / (2 * sigma ** 2))
    return torch.as_tensor(k / k.sum(), dtype=torch.float32)


def blur(x: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """cv2.GaussianBlur of (N, 1, H, W), BORDER_REFLECT_101."""
    k = gaussian_kernel(ksize, sigma).to(x.device)
    p = ksize // 2
    x = F.conv2d(F.pad(x, (0, 0, p, p), mode='reflect'),
                 k.reshape(1, 1, -1, 1))
    return F.conv2d(F.pad(x, (p, p, 0, 0), mode='reflect'),
                    k.reshape(1, 1, 1, -1))


def erode(x: torch.Tensor, k: int) -> torch.Tensor:
    """cv2.erode of (N, 1, H, W) with a k x k square (anchor k // 2; the
    border never erodes)."""
    a, b = k // 2, k - 1 - k // 2
    x = F.pad(-x, (a, b, a, b), value=-float('inf'))
    return -F.max_pool2d(x, k, stride=1)


def parse_logits(parsenet, faces_rgb_u8: torch.Tensor,
                 res: int) -> torch.Tensor:
    """(n, face, face, 3) uint8 RGB -> (n, 19, res, res) class logits:
    [-1, 1], a linear resize to `res` (antialiased when it shrinks),
    ParseNet. The ids are their argmax."""
    x = faces_rgb_u8.permute(0, 3, 1, 2).float() / 127.5 - 1.0
    if res != x.shape[2]:
        x = F.interpolate(x, size=(res, res), mode='bilinear',
                          align_corners=False, antialias=res < x.shape[2])
    return parsenet(x)[0]


def soft_parse_masks(ids: torch.Tensor, face: int) -> torch.Tensor:
    """(n, res, res) ids -> (n, 1, face, face) soft masks in [0, 1]: the
    colormap, two Gaussian blurs (101 taps, sigma 11 at 512), a 10 px
    border zeroed, / 255, a linear resize to the face."""
    res = ids.shape[1]
    s = res / 512.0
    ksize, sigma = max(int(round(101 * s)) | 1, 3), 11.0 * s
    thres = max(int(round(10 * s)), 1)
    table = torch.tensor(MASK_COLORMAP, dtype=torch.float32,
                         device=ids.device)
    pm = table[ids][:, None]
    pm = blur(blur(pm, ksize, sigma), ksize, sigma)
    pm[:, :, :thres] = 0
    pm[:, :, -thres:] = 0
    pm[:, :, :, :thres] = 0
    pm[:, :, :, -thres:] = 0
    pm = pm / 255.0
    if face != res:
        pm = F.interpolate(pm, size=(face, face), mode='bilinear',
                           align_corners=False)
    return pm


def edge_width(max_area: float) -> int:
    w_edge = int(max_area ** 0.5) // 20
    return min(max((w_edge + 4) // 8 * 8, 4), 64)


def paste(frame_bgr_u8: torch.Tensor, faces_rgb_u8: Sequence[torch.Tensor],
          masks: Sequence[torch.Tensor], inv_affines: List[np.ndarray],
          up: int, w_edge: int) -> torch.Tensor:
    """One frame: the frame upscaled (linear), then each restored face,
    in order, warped by its inverse affine and blended with the soft
    edge capped by its parse mask. Returns the uint8 BGR frame (H*up,
    W*up, 3), the faces' share of each pixel (H*up, W*up: 1 - the
    product of (1 - blend weight)) and where any face's warp reaches
    (H*up, W*up bool)."""
    h, w = frame_bgr_u8.shape[:2]
    out_hw = (h * up, w * up)
    canvas = F.interpolate(frame_bgr_u8.permute(2, 0, 1)[None].float(),
                           size=out_hw, mode='bilinear',
                           align_corners=False)[0].permute(1, 2, 0)
    keep = torch.ones(out_hw, device=canvas.device)
    reach = torch.zeros(out_hw, dtype=torch.bool, device=canvas.device)
    for face, mask, ia in zip(faces_rgb_u8, masks, inv_affines):
        src = torch.cat([face.float().flip(-1), mask[0][..., None]], -1)
        warped, cov = warp(src, ia, out_hw)
        cov = cov.permute(2, 0, 1)[None]
        erosion = erode(cov, max(2 * up, 1))
        pasted = erosion[0].permute(1, 2, 0) * warped[..., :3]
        soft = blur(erode(erosion, max(2 * w_edge, 1)), 2 * w_edge + 1)
        soft = torch.minimum(soft, warped[..., 3:].permute(2, 0, 1)[None])
        soft = soft[0].permute(1, 2, 0)
        canvas = soft * pasted + (1 - soft) * canvas
        keep = keep * (1 - soft[..., 0])
        reach |= cov[0, 0] > 0
    return torch.round(canvas).clamp(0, 255).to(torch.uint8), 1 - keep, \
        reach


def align(frames_bgr_u8: torch.Tensor, frame_idx: Sequence[int],
          affines: Sequence[np.ndarray], face: int) -> torch.Tensor:
    """The face crops of align_warp_face: each frame warped by its
    affine to face x face with the grey border, rounded, as uint8 RGB
    (n, face, face, 3)."""
    crops = [warp(frames_bgr_u8[i].float(), a, (face, face), BORDER_BGR)[0]
             for i, a in zip(frame_idx, affines)]
    out = torch.stack(crops).round().clamp(0, 255).flip(-1)
    return out.to(torch.uint8)

"""Data augmentation transforms (reference: basicsr/data/transforms.py)."""
from __future__ import annotations

import random

import cv2
import numpy as np


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop so H, W are multiples of scale (transforms.py:5-22)."""
    img = img.copy()
    if img.ndim in (2, 3):
        h, w = img.shape[0], img.shape[1]
        h_r, w_r = h % scale, w % scale
        img = img[:h - h_r, :w - w_r, ...]
    else:
        raise ValueError(f'Wrong img ndim: {img.ndim}.')
    return img


def paired_random_crop(img_gts, img_lqs, gt_patch_size: int, scale: int,
                       gt_path: str = ''):
    """Random paired crop of GT/LQ lists (transforms.py:25-77)."""
    if not isinstance(img_gts, list):
        img_gts = [img_gts]
    if not isinstance(img_lqs, list):
        img_lqs = [img_lqs]
    h_lq, w_lq = img_lqs[0].shape[0:2]
    h_gt, w_gt = img_gts[0].shape[0:2]
    lq_patch_size = gt_patch_size // scale
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(f'Scale mismatches. GT ({h_gt}, {w_gt}) is not '
                         f'{scale}x of LQ ({h_lq}, {w_lq}). {gt_path}')
    if h_lq < lq_patch_size or w_lq < lq_patch_size:
        raise ValueError(f'LQ ({h_lq}, {w_lq}) smaller than patch '
                         f'{lq_patch_size}. {gt_path}')
    top = random.randint(0, h_lq - lq_patch_size)
    left = random.randint(0, w_lq - lq_patch_size)
    img_lqs = [v[top:top + lq_patch_size, left:left + lq_patch_size, ...]
               for v in img_lqs]
    top_gt, left_gt = int(top * scale), int(left * scale)
    img_gts = [v[top_gt:top_gt + gt_patch_size,
                 left_gt:left_gt + gt_patch_size, ...] for v in img_gts]
    if len(img_gts) == 1:
        img_gts = img_gts[0]
    if len(img_lqs) == 1:
        img_lqs = img_lqs[0]
    return img_gts, img_lqs


def augment(imgs, hflip: bool = True, rotation: bool = True, flows=None,
            return_status: bool = False):
    """hflip / vflip+rot90 augmentation with optional flow handling and
    status return (transforms.py:80-144)."""
    hflip = hflip and random.random() < 0.5
    vflip = rotation and random.random() < 0.5
    rot90 = rotation and random.random() < 0.5

    def _augment(img):
        if hflip:
            img = cv2.flip(img, 1)
        if vflip:
            img = cv2.flip(img, 0)
        if rot90:
            img = img.transpose(1, 0, 2)
        return img

    def _augment_flow(flow):
        if hflip:
            flow = cv2.flip(flow, 1)
            flow[:, :, 0] *= -1
        if vflip:
            flow = cv2.flip(flow, 0)
            flow[:, :, 1] *= -1
        if rot90:
            flow = flow.transpose(1, 0, 2)
            flow = flow[:, :, [1, 0]]
        return flow

    if not isinstance(imgs, list):
        imgs = [imgs]
    imgs = [_augment(img) for img in imgs]
    if len(imgs) == 1:
        imgs = imgs[0]
    if flows is not None:
        if not isinstance(flows, list):
            flows = [flows]
        flows = [_augment_flow(f) for f in flows]
        if len(flows) == 1:
            flows = flows[0]
        return imgs, flows
    if return_status:
        return imgs, (hflip, vflip, rot90)
    return imgs


# ---- torchvision-style photometric jitter (numpy, float RGB [0,1]) ----
# Reference: FFHQBlindDataset.color_jitter_pt
# (basicsr/data/ffhq_blind_dataset.py:124-143), which applies torchvision's
# adjust_{brightness,contrast,saturation,hue} in a random order.

def _rgb_to_gray(img: np.ndarray) -> np.ndarray:
    return (0.2989 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(img * factor, 0.0, 1.0)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    mean = _rgb_to_gray(img).mean()
    return np.clip(factor * img + (1.0 - factor) * mean, 0.0, 1.0)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = _rgb_to_gray(img)[..., None]
    return np.clip(factor * img + (1.0 - factor) * gray, 0.0, 1.0)


def adjust_hue(img: np.ndarray, factor: float) -> np.ndarray:
    """Shift hue by `factor` (in [-0.5, 0.5] turns), matching
    torchvision.transforms.functional.adjust_hue's float path."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.max(axis=-1)
    minc = img.min(axis=-1)
    v = maxc
    cr = maxc - minc
    s = np.where(maxc > 0, cr / np.maximum(maxc, 1e-12), 0.0)
    crd = np.where(cr > 0, cr, 1.0)
    rc = (maxc - r) / crd
    gc = (maxc - g) / crd
    bc = (maxc - b) / crd
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(cr > 0, h, 0.0)
    h = (h / 6.0) % 1.0

    h = (h + factor) % 1.0

    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.astype(np.int32) % 6
    p = np.clip(v * (1.0 - s), 0.0, 1.0)
    q = np.clip(v * (1.0 - s * f), 0.0, 1.0)
    t = np.clip(v * (1.0 - s * (1.0 - f)), 0.0, 1.0)
    mask = (i[..., None] == np.arange(6))  # (..., 6)
    r_out = np.select([mask[..., k] for k in range(6)],
                      [v, q, p, p, t, v])
    g_out = np.select([mask[..., k] for k in range(6)],
                      [t, v, v, q, p, p])
    b_out = np.select([mask[..., k] for k in range(6)],
                      [p, p, t, v, v, q])
    out = np.stack([r_out, g_out, b_out], axis=-1)
    return out.astype(img.dtype)


def color_jitter_pt(img: np.ndarray, brightness, contrast, saturation,
                    hue, rng: np.random.Generator) -> np.ndarray:
    """Random-order brightness/contrast/saturation/hue jitter on a float
    RGB [0,1] HWC image (ffhq_blind_dataset.py:124-143)."""
    for fn_id in rng.permutation(4):
        if fn_id == 0 and brightness is not None:
            img = adjust_brightness(img, rng.uniform(*brightness))
        elif fn_id == 1 and contrast is not None:
            img = adjust_contrast(img, rng.uniform(*contrast))
        elif fn_id == 2 and saturation is not None:
            img = adjust_saturation(img, rng.uniform(*saturation))
        elif fn_id == 3 and hue is not None:
            img = adjust_hue(img, rng.uniform(*hue))
    return img

"""Host-side image helpers of the whole-image paths and of validation,
copied from codeformer_tpu/utils/img_util.py (`normalize_img_dtype`,
`imwrite`, `imgs_to_batch`, `batch_to_imgs`, `is_gray`, `bgr2gray3`,
`adain_color_transfer`; the reference's basicsr/utils/img_util.py and
facelib/utils/misc.py:146-202), plus `tensor_to_imgs`, batch_to_imgs on
a device tensor. numpy and torch; cv2 is imported inside the functions that
need it, so the card's path, which never reads or writes files, does not
need it."""
from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np
import torch


def normalize_img_dtype(img: np.ndarray) -> np.ndarray:
    """uint16->uint8, gray->BGR, BGRA->BGR."""
    import cv2
    if img.dtype == np.uint16:
        img = (img / 65535.0 * 255.0).round().astype(np.uint8)
    elif img.dtype != np.uint8:
        img = np.clip(img.astype(np.float32), 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    elif img.shape[2] == 4:
        img = cv2.cvtColor(img, cv2.COLOR_BGRA2BGR)
    return img


def imwrite(img: np.ndarray, file_path: str, auto_mkdir: bool = True):
    """Write an image, creating parent dirs (img_util.py:135-151)."""
    import cv2
    if auto_mkdir:
        os.makedirs(os.path.dirname(os.path.abspath(file_path)),
                    exist_ok=True)
    ok = cv2.imwrite(file_path, img)
    if not ok:
        raise IOError(f'failed to write image: {file_path}')


def imgs_to_batch(imgs: Sequence[np.ndarray],
                  mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    """uint8 BGR images (same size) -> normalized float32 NHWC RGB batch
    (img2tensor + normalize(mean=.5, std=.5) of the reference CLI,
    inference_codeformer.py:199-201, batched)."""
    stack = np.stack([im[..., ::-1] for im in imgs]).astype(np.float32)
    stack /= 255.0
    return (stack - mean) / std


def batch_to_imgs(batch: np.ndarray, min_max: Tuple[float, float] = (-1, 1)
                  ) -> List[np.ndarray]:
    """float NHWC RGB batch -> list of uint8 BGR images, clamped to min_max
    then rescaled (tensor2img semantics, img_util.py:38-94)."""
    arr = np.asarray(batch, dtype=np.float32)
    arr = np.clip(arr, *min_max)
    arr = (arr - min_max[0]) / (min_max[1] - min_max[0])
    arr = (arr * 255.0).round().astype(np.uint8)
    return [im[..., ::-1] for im in arr]


def tensor_to_imgs(batch: torch.Tensor,
                   min_max: Tuple[float, float] = (-1, 1)) -> torch.Tensor:
    """batch_to_imgs on a float NHWC RGB tensor, on its device, in the
    same float32 arithmetic: a uint8 NHWC BGR tensor."""
    arr = batch.float().clamp(*min_max)
    arr = (arr - min_max[0]) / (min_max[1] - min_max[0])
    return (arr * 255.0).round().to(torch.uint8).flip(-1)


def is_gray(img: np.ndarray, threshold: int = 10) -> bool:
    """Channel-variance grayscale detector (facelib/utils/misc.py:146-160)."""
    import cv2
    img = cv2.resize(img, (256, 256))
    if img.ndim == 2:
        return True
    img = img.astype(np.float32)
    diff1 = np.abs(img[..., 0] - img[..., 1]).mean()
    diff2 = np.abs(img[..., 1] - img[..., 2]).mean()
    return (diff1 + diff2) / 2.0 <= threshold


def bgr2gray3(img: np.ndarray) -> np.ndarray:
    """BGR -> gray, replicated back to 3 channels
    (facelib/utils/misc.py:162-167)."""
    import cv2
    g = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    return np.stack([g, g, g], axis=-1)


def adain_color_transfer(restored: np.ndarray,
                         source_gray: np.ndarray) -> np.ndarray:
    """Per-channel mean/std transfer so restored gray faces keep the input's
    tone (numpy AdaIN, facelib/utils/misc.py:177-202). uint8 in/out."""
    x = restored.astype(np.float32)
    y = source_gray.astype(np.float32)
    x_mean = x.reshape(-1, 3).mean(0)
    x_std = x.reshape(-1, 3).std(0) + 1e-5
    y_mean = y.reshape(-1, 3).mean(0)
    y_std = y.reshape(-1, 3).std(0) + 1e-5
    out = (x - x_mean) / x_std * y_std + y_mean
    return np.clip(out, 0, 255).astype(np.uint8)

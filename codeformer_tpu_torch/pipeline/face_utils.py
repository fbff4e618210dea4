"""Standalone face alignment/paste utilities, copied from
codeformer_tpu/pipeline/face_utils.py.

Equivalents of facelib/utils/face_utils.py: FFHQ-style oriented-quad
alignment from 5/68/98 landmarks (the NVlabs ffhq-dataset recipe) and a
simple soft-mask paste-back. Host-side numpy/cv2 — these are one-off
dataset-preparation tools, not the hot path; cv2 is imported inside the
functions that warp.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def compute_increased_bbox(bbox, increase_area, preserve_aspect=True):
    """Enlarge a bbox by a relative margin (face_utils.py:6-20)."""
    left, top, right, bot = bbox
    width = right - left
    height = bot - top
    if preserve_aspect:
        width_increase = max(increase_area,
                             ((1 + 2 * increase_area) * height - width)
                             / (2 * width))
        height_increase = max(increase_area,
                              ((1 + 2 * increase_area) * width - height)
                              / (2 * height))
    else:
        width_increase = height_increase = increase_area
    left = int(left - width_increase * width)
    top = int(top - height_increase * height)
    right = int(right + width_increase * width)
    bot = int(bot + height_increase * height)
    return (left, top, right, bot)


def get_valid_bboxes(bboxes, h, w):
    """Clip bboxes to the image (face_utils.py:23-28)."""
    left = max(bboxes[0], 0)
    top = max(bboxes[1], 0)
    right = min(bboxes[2], w)
    bottom = min(bboxes[3], h)
    return (left, top, right, bottom)


def _landmark_anchors(lm: np.ndarray, lm_type: str = 'retinaface_5'):
    """eye_left, eye_right, mouth_avg from 5/68/98 landmarks
    (face_utils.py:66-90)."""
    if lm.shape[0] == 5 and lm_type == 'retinaface_5':
        return lm[0], lm[1], (lm[3] + lm[4]) * 0.5
    if lm.shape[0] == 5 and lm_type == 'dlib_5':
        return (np.mean(lm[2:4], axis=0), np.mean(lm[0:2], axis=0), lm[4])
    if lm.shape[0] == 68:
        return (np.mean(lm[36:42], axis=0), np.mean(lm[42:48], axis=0),
                (lm[48] + lm[54]) * 0.5)
    if lm.shape[0] == 98:
        return (np.mean(lm[60:68], axis=0), np.mean(lm[68:76], axis=0),
                (lm[76] + lm[82]) * 0.5)
    raise ValueError(f'unsupported landmark count {lm.shape[0]}')


def ffhq_quad(landmarks: np.ndarray, shrink_ratio=(1, 1),
              lm_type: str = 'retinaface_5'):
    """Oriented crop quad + size from landmarks (the FFHQ recipe,
    face_utils.py:92-116 / crop_align_face.py:99-116)."""
    eye_left, eye_right, mouth_avg = _landmark_anchors(
        np.asarray(landmarks, np.float64), lm_type)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    x = x * shrink_ratio[1]
    y = y * shrink_ratio[0]
    c = eye_avg + eye_to_mouth * 0.1
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    qsize = np.hypot(*x) * 2
    return quad, qsize


def align_crop_face_landmarks(img: np.ndarray, landmarks: np.ndarray,
                              output_size: int,
                              transform_size: Optional[int] = None,
                              enable_padding: bool = True,
                              return_inverse_affine: bool = False,
                              shrink_ratio=(1, 1)):
    """FFHQ-style align+crop (face_utils.py:31-187): oriented quad ->
    perspective-free similarity warp to a square of `output_size`.

    Returns cropped_face (and the 2x3 inverse affine when requested)."""
    if isinstance(shrink_ratio, (int, float)):
        shrink_ratio = (shrink_ratio, shrink_ratio)
    if transform_size is None:
        transform_size = output_size * 4
    quad, qsize = ffhq_quad(landmarks, shrink_ratio)
    quad_ori = quad.copy()

    # the quad maps to the output square: solve the similarity transform
    dst = np.array([[0, 0], [0, output_size - 1],
                    [output_size - 1, output_size - 1],
                    [output_size - 1, 0]], np.float32)
    import cv2

    from codeformer_tpu_torch.ops.geometry import estimate_similarity
    affine = estimate_similarity(quad_ori.astype(np.float32), dst)
    border_mode = cv2.BORDER_REFLECT if enable_padding else \
        cv2.BORDER_CONSTANT
    cropped_face = cv2.warpAffine(img, affine,
                                  (output_size, output_size),
                                  borderMode=border_mode)
    if return_inverse_affine:
        inverse_affine = cv2.invertAffineTransform(
            affine.astype(np.float32))
        return cropped_face, inverse_affine
    return cropped_face, None


def paste_face_back(img: np.ndarray, face: np.ndarray,
                    inverse_affine: np.ndarray) -> np.ndarray:
    """Soft-mask inverse-warp composite (face_utils.py:190-212)."""
    import cv2
    h, w = img.shape[0:2]
    face_h, face_w = face.shape[0:2]
    inv_restored = cv2.warpAffine(face, inverse_affine, (w, h))
    mask = np.ones((face_h, face_w, 3), dtype=np.float32)
    inv_mask = cv2.warpAffine(mask, inverse_affine, (w, h))
    inv_mask_erosion = cv2.erode(inv_mask, np.ones((2, 2), np.uint8))
    inv_restored_remove_border = inv_mask_erosion * inv_restored
    total_face_area = np.sum(inv_mask_erosion) // 3
    w_edge = int(total_face_area ** 0.5) // 20
    erosion_radius = w_edge * 2
    inv_mask_center = cv2.erode(
        inv_mask_erosion, np.ones((erosion_radius, erosion_radius),
                                  np.uint8))
    blur_size = w_edge * 2
    inv_soft_mask = cv2.GaussianBlur(inv_mask_center,
                                     (blur_size + 1, blur_size + 1), 0)
    img = inv_soft_mask * inv_restored_remove_border \
        + (1 - inv_soft_mask) * img
    return img

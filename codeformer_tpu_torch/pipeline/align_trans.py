"""112x112 reference-point face alignment, copied from
codeformer_tpu/pipeline/align_trans.py (the reference's
facelib/detection/align_trans.py + matlab_cp2tform.py).

Used by FaceDetector.align_multi (retinaface.py:241-264); the MATLAB
cp2tform least-squares similarity solve is the closed-form Umeyama
estimator of ops/geometry.py (equivalent for the non-reflective case).
cv2 is imported inside `warp_and_crop_face`, the one function that
warps."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from codeformer_tpu_torch.ops.geometry import estimate_similarity

# canonical 5 facial points for a 96x112 crop (align_trans.py REFERENCE_
# FACIAL_POINTS, from the original MTCNN alignment)
REFERENCE_FACIAL_POINTS = np.array([
    [30.29459953, 51.69630051],
    [65.53179932, 51.50139999],
    [48.02519989, 71.73660278],
    [33.54930115, 92.3655014],
    [62.72990036, 92.20410156]], np.float32)

DEFAULT_CROP_SIZE = (96, 112)


def get_reference_facial_points(output_size: Optional[Tuple[int, int]]
                                = None,
                                inner_padding_factor: float = 0.0,
                                outer_padding: Tuple[int, int] = (0, 0),
                                default_square: bool = False) -> np.ndarray:
    """(align_trans.py:19-109): optionally squarify the 96x112 template and
    rescale/pad it to output_size."""
    tmp_5pts = REFERENCE_FACIAL_POINTS.copy()
    tmp_crop_size = np.array(DEFAULT_CROP_SIZE, np.float32)

    if default_square:
        size_diff = max(tmp_crop_size) - tmp_crop_size
        tmp_5pts += size_diff / 2
        tmp_crop_size += size_diff

    if output_size is None or (
            output_size[0] == tmp_crop_size[0]
            and output_size[1] == tmp_crop_size[1]
            and inner_padding_factor == 0 and outer_padding == (0, 0)):
        return tmp_5pts

    if not (0 <= inner_padding_factor <= 1.0):
        raise ValueError('inner_padding_factor must be in [0, 1]')
    output_size = np.array(output_size, np.float32)

    if inner_padding_factor > 0:
        size_diff = tmp_crop_size * inner_padding_factor * 2
        tmp_5pts += size_diff / 2
        tmp_crop_size += np.round(size_diff).astype(np.int32)

    size_bf_outer_pad = output_size - np.array(outer_padding) * 2
    if size_bf_outer_pad[0] * tmp_crop_size[1] != \
            size_bf_outer_pad[1] * tmp_crop_size[0]:
        raise ValueError('must have output_size - outer_padding = '
                         'some_scale * crop_size * (1 + padding_factor)')
    scale = size_bf_outer_pad[0] / tmp_crop_size[0]
    tmp_5pts = tmp_5pts * scale
    tmp_5pts += np.array(outer_padding)
    return tmp_5pts.astype(np.float32)


def get_affine_transform_matrix(src_pts: np.ndarray,
                                dst_pts: np.ndarray) -> np.ndarray:
    """Full (non-similarity) least-squares affine
    (align_trans.py:112-142)."""
    n = src_pts.shape[0]
    ones = np.ones((n, 1))
    a = np.hstack([src_pts, ones])
    sol, _, rank, _ = np.linalg.lstsq(a, dst_pts, rcond=None)
    if rank == 3:
        return sol.T.astype(np.float32)
    return np.array([[1, 0, 0], [0, 1, 0]], np.float32)


def warp_and_crop_face(src_img: np.ndarray, facial_pts,
                       reference_pts=None, crop_size=(96, 112),
                       align_type: str = 'smilarity') -> np.ndarray:
    """(align_trans.py:145-219): warp a face to the canonical crop."""
    import cv2
    if reference_pts is None:
        if crop_size == (96, 112):
            reference_pts = REFERENCE_FACIAL_POINTS
        else:
            default_square = crop_size[0] == crop_size[1]
            reference_pts = get_reference_facial_points(
                output_size=crop_size, default_square=default_square)
    src = np.asarray(facial_pts, np.float32).reshape(5, 2)
    dst = np.asarray(reference_pts, np.float32).reshape(5, 2)
    if align_type == 'affine':
        tfm = get_affine_transform_matrix(src, dst)
    else:
        tfm = estimate_similarity(src, dst).astype(np.float32)
    return cv2.warpAffine(src_img, tfm, (crop_size[0], crop_size[1]))

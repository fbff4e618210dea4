"""Tensor ops with hand-written CUDA kernels and their plain versions,
and the plain-PyTorch ops of the whole-image path, counterpart of
codeformer_tpu/ops (the reference's native-op package basicsr/ops):
anchors, box decoding and NMS of the detector, the affine warp and the
linear resize, and the mask filters of the paste-back."""
from .anchors import prior_boxes
from .conv3x3 import conv3x3_bias
from .deform_conv import deform_conv2d, modulated_deform_conv2d
from .filters import dilate, erode, gaussian_blur, gaussian_kernel1d
from .fused_act import fused_leaky_relu
from .geometry import (estimate_similarity, invert_affine, resize_linear,
                       warp_affine)
from .nms import decode_boxes, decode_landmarks, iou_matrix, nms
from .upfirdn2d import upfirdn2d
from .vq import codebook_lookup, nearest_code_indices

__all__ = [
    'nearest_code_indices', 'codebook_lookup', 'upfirdn2d',
    'fused_leaky_relu', 'deform_conv2d', 'modulated_deform_conv2d',
    'conv3x3_bias', 'prior_boxes', 'decode_boxes', 'decode_landmarks',
    'iou_matrix', 'nms', 'warp_affine', 'resize_linear',
    'estimate_similarity', 'invert_affine', 'gaussian_kernel1d',
    'gaussian_blur', 'erode', 'dilate',
]

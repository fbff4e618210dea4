"""Tensor ops with hand-written CUDA kernels and their plain versions,
counterpart of codeformer_tpu/ops (the reference's native-op package
basicsr/ops). Not yet here: the geometry, filters, NMS and anchor ops of
the detection path (ROADMAP.md)."""
from .conv3x3 import conv3x3_bias
from .deform_conv import deform_conv2d, modulated_deform_conv2d
from .fused_act import fused_leaky_relu
from .upfirdn2d import upfirdn2d
from .vq import codebook_lookup, nearest_code_indices

__all__ = [
    'nearest_code_indices', 'codebook_lookup', 'upfirdn2d',
    'fused_leaky_relu', 'deform_conv2d', 'modulated_deform_conv2d',
    'conv3x3_bias',
]

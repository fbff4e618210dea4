"""Parse-mask shaping of the on-device paste-back, counterpart of
codeformer_tpu/pipeline/compositor_xla.py:38-96: the 19-class parse ->
binary face mask colormap of the reference
(face_restoration_helper.py:458-476), its double Gaussian soft edge,
border zeroing and the upsample to the face size. The classic per-image
compositor (`paste_faces_xla`) is not ported yet (ROADMAP.md Queue 1
item 1).
"""
from __future__ import annotations

import torch

from codeformer_tpu_torch.ops.filters import gaussian_blur
from codeformer_tpu_torch.ops.geometry import resize_linear

# 19-class parse mask -> binary face mask (face_restoration_helper.py:468)
MASK_COLORMAP = (0, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
                 255, 255, 0, 255, 0, 0, 0)


def colormap_lookup(parse_ids: torch.Tensor) -> torch.Tensor:
    """MASK_COLORMAP[parse_ids] as fp32."""
    table = torch.tensor(MASK_COLORMAP, dtype=torch.float32,
                         device=parse_ids.device)
    return table[parse_ids.long()]


def _shape_parse_masks(parse_ids: torch.Tensor,
                       face_size: int) -> torch.Tensor:
    """Parse ids (N, res, res) -> soft parse masks (N, 1, face, face) in
    [0, 1]: the colormap, two Gaussian blurs (101 taps, sigma 11),
    `thres` border pixels zeroed, /255, then a linear resize to the face.

    res == 512 is the reference exactly (kernel 101, sigma 11, 10 px
    border). Other resolutions (the pipeline's parse_res) scale kernel,
    sigma and border by res/512 and resize the soft mask, as the JAX
    package does."""
    res = parse_ids.shape[1]
    s = res / 512.0
    ksize = max(int(round(101 * s)) | 1, 3)
    sigma = 11.0 * s
    thres = max(int(round(10 * s)), 1)
    pm = colormap_lookup(parse_ids)[:, None]          # (N, 1, res, res)
    pm = gaussian_blur(gaussian_blur(pm, ksize, sigma), ksize, sigma)
    pm[:, :, :thres] = 0
    pm[:, :, -thres:] = 0
    pm[:, :, :, :thres] = 0
    pm[:, :, :, -thres:] = 0
    pm = pm / 255.0
    if face_size != res:
        pm = resize_linear(pm, (face_size, face_size))
    return pm

"""The paste-back of benchmark/reference/paste.py onto a canvas given
by the caller: the background upsampler's frame in place of paste.py's
linear upscale. The warp, erosions and blur are paste.py's own."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from benchmark.reference.paste import blur, erode, warp


def paste_on(canvas_bgr_u8: torch.Tensor,
             faces_rgb_u8: Sequence[torch.Tensor],
             masks: Sequence[torch.Tensor], inv_affines: List[np.ndarray],
             up: int, w_edge: int):
    """paste.paste with the upscaled frame given: each restored face, in
    order, warped by its inverse affine onto `canvas_bgr_u8` ((H*up,
    W*up, 3) uint8 BGR) and blended with the soft edge capped by its
    parse mask. Returns the uint8 BGR frame, the faces' share of each
    pixel and where any face's warp reaches, as paste.paste does."""
    canvas = canvas_bgr_u8.float()
    out_hw = tuple(canvas.shape[:2])
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

"""Box and landmark decoding and a static-shape greedy NMS, counterpart
of codeformer_tpu/ops/nms.py (the reference's
retinaface_utils.py:253-421). Batched over frames: every function takes
leading batch dimensions, and the NMS is `max_out` vectorized steps over
all frames at once, not a loop over boxes. Plain torch (torchvision is
not a dependency)."""
from __future__ import annotations

from typing import Tuple

import torch


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor,
                 variances=(0.1, 0.2)) -> torch.Tensor:
    """SSD-style box decoding (retinaface_utils.py:253-278).
    loc, priors: (..., N, 4) [cx, cy, w, h] -> (..., N, 4) [x1, y1, x2, y2].
    """
    centers = priors[..., :2] + loc[..., :2] * variances[0] * priors[..., 2:]
    sizes = priors[..., 2:] * torch.exp(loc[..., 2:] * variances[1])
    return torch.cat([centers - sizes / 2, centers + sizes / 2], dim=-1)


def decode_landmarks(pre: torch.Tensor, priors: torch.Tensor,
                     variances=(0.1, 0.2)) -> torch.Tensor:
    """Decode 5-point landmarks (retinaface_utils.py:281-297).
    pre: (..., N, 10) -> (..., N, 10) absolute (normalized) coords."""
    p = pre.reshape(*pre.shape[:-1], 5, 2)
    out = priors[..., None, :2] + p * variances[0] * priors[..., None, 2:]
    return out.reshape(pre.shape)


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of [x1,y1,x2,y2] boxes: (..., A, 4) x (..., B, 4) ->
    (..., A, B)."""
    tl = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    br = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = (br - tl).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((boxes_a[..., 2] - boxes_a[..., 0])
              * (boxes_a[..., 3] - boxes_a[..., 1]))[..., :, None]
    area_b = ((boxes_b[..., 2] - boxes_b[..., 0])
              * (boxes_b[..., 3] - boxes_b[..., 1]))[..., None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over a fixed number of candidates, batched.

    boxes: (B, N, 4), scores: (B, N); invalid candidates carry -inf.
    Returns (keep (B, max_out) int64, valid (B, max_out) bool). A dropped
    slot has index 0 and valid False. Step i takes each frame's highest
    live score (the first on ties, as jnp.argmax) and suppresses it and
    every box whose IoU with it exceeds the threshold.
    """
    b, n = scores.shape
    live = scores.float().clone()
    rows = torch.arange(b, device=boxes.device)
    cols = torch.arange(n, device=boxes.device)
    keep = torch.zeros((b, max_out), dtype=torch.int64, device=boxes.device)
    valid = torch.zeros((b, max_out), dtype=torch.bool, device=boxes.device)
    for i in range(max_out):
        best = torch.argmax(live, dim=1)                       # (B,)
        ok = live[rows, best] > -torch.inf
        keep[:, i] = torch.where(ok, best, torch.zeros_like(best))
        valid[:, i] = ok
        ious = iou_matrix(boxes[rows, best][:, None], boxes)[:, 0]
        suppress = (ious > iou_threshold) | (cols[None] == best[:, None])
        live = torch.where(ok[:, None] & suppress,
                           torch.full_like(live, -torch.inf), live)
    return keep, valid

"""RetinaFace anchors (prior boxes), a numpy copy of
codeformer_tpu/ops/anchors.py: the same MIN_SIZES, STEPS and anchor order
as the reference PriorBox (retinaface_utils.py:8-36), cached by image
size."""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

MIN_SIZES = ((16, 32), (64, 128), (256, 512))
STEPS = (8, 16, 32)


@functools.lru_cache(maxsize=32)
def prior_boxes(image_h: int, image_w: int,
                min_sizes: Tuple[Tuple[int, ...], ...] = MIN_SIZES,
                steps: Tuple[int, ...] = STEPS) -> np.ndarray:
    """(N, 4) anchors as normalized [cx, cy, w, h], ordered exactly like the
    reference PriorBox (per level, row-major cell, per min_size)."""
    out = []
    for k, step in enumerate(steps):
        fh = int(math.ceil(image_h / step))
        fw = int(math.ceil(image_w / step))
        sizes = min_sizes[k]
        jj, ii = np.meshgrid(np.arange(fw), np.arange(fh))  # (fh, fw)
        cx = (jj + 0.5) * step / image_w
        cy = (ii + 0.5) * step / image_h
        for_cells = []
        for ms in sizes:
            s_kx = ms / image_w
            s_ky = ms / image_h
            a = np.stack([cx, cy,
                          np.full_like(cx, s_kx, dtype=np.float64),
                          np.full_like(cy, s_ky, dtype=np.float64)],
                         axis=-1)  # (fh, fw, 4)
            for_cells.append(a)
        # interleave min_sizes per cell: (fh, fw, n_sizes, 4)
        level = np.stack(for_cells, axis=2).reshape(-1, 4)
        out.append(level)
    return np.concatenate(out, axis=0).astype(np.float32)

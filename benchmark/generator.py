"""The one traffic generator: inputs and their order from a traffic
file's parameters and the seed.

Every seed gets the same sizes and the same amount of work; the seed
changes the pixels and the order in which the pool is cycled. Pixels are
made on the device with a seeded `torch.Generator` (a few large calls)
and handed to the program as host arrays, as a folder or a decoder would
hand them over.

Faces are smooth random images: a 16 x 16 grid of random colours,
upsampled, plus noise (the pattern chip_smoke.py's `_faces` uses).
Frames are such images at the frame's size, with no face drawn in
them: the landmarks handed to the pipeline put the template's five
points at the traffic's face offsets, and the pipeline crops, restores
and pastes back whatever lies there (benchmark/systems/photos.py).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

# salt of the pixel stream, apart from the weights' stream of one seed
PIXEL_SALT = 0x5EED


def pixel_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed ^ PIXEL_SALT) & (2 ** 63 - 1))


def smooth_images(g: torch.Generator, n: int, h: int, w: int, device,
                  grid: int = 16, noise: float = 12.0) -> torch.Tensor:
    """(n, h, w, 3) uint8: random colours on a grid x grid lattice,
    nearest-upsampled, plus Gaussian noise."""
    lo = torch.rand((n, 3, grid, grid), generator=g, device=device) * 255.0
    img = F.interpolate(lo, size=(h, w), mode='nearest')
    img = img + noise * torch.randn(img.shape, generator=g, device=device)
    return img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)


def face_pool(seed: int, n: int, size: int, device) -> np.ndarray:
    """(n, size, size, 3) uint8 RGB faces on the host."""
    g = pixel_generator(seed, device)
    return smooth_images(g, n, size, size, device).cpu().numpy()


def cycle_order(seed: int, n_items: int, length: int) -> np.ndarray:
    """Indices into a pool of `n_items`, `length` long: seeded
    permutations of the pool, one after another, so every item comes
    equally often."""
    rng = np.random.default_rng(seed)
    reps = -(-length // n_items)
    return np.concatenate([rng.permutation(n_items)
                           for _ in range(reps)])[:length]


def batches(pool: np.ndarray, batch: int, seed: int) -> List[np.ndarray]:
    """The pool in a seeded order, cut into contiguous host batches of
    `batch` faces (each its own array, as a loader would stack them)."""
    order = np.random.default_rng(seed).permutation(len(pool))
    return [np.ascontiguousarray(pool[order[i:i + batch]])
            for i in range(0, len(pool) - batch + 1, batch)]

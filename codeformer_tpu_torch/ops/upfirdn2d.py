"""upfirdn2d: upsample, FIR filter, downsample (StyleGAN2 op), NHWC;
counterpart of codeformer_tpu/ops/upfirdn2d.py.

Zero-stuff by `up` (each sample followed by up-1 zeros, the trailing ones
included), pad (a negative pad crops), correlate with the flipped 2D
kernel (a true convolution), keep every `down`-th sample. Plain PyTorch:
one depthwise F.conv2d on the zero-stuffed, padded map. The JAX copy has
no Pallas kernel here, so neither has the port.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1,
              down: int = 1,
              pad: Union[Tuple[int, int], Tuple[int, int, int, int]]
              = (0, 0)) -> torch.Tensor:
    """x: (B, H, W, C); kernel: (kh, kw). pad: (pad0, pad1) on both axes,
    or (px0, px1, py0, py1). Computes in fp32, returns x.dtype."""
    if len(pad) == 2:
        px0, px1, py0, py1 = pad[0], pad[1], pad[0], pad[1]
    else:
        px0, px1, py0, py1 = pad
    b, h, w, c = x.shape
    t = x.float().permute(0, 3, 1, 2)
    if up > 1:
        z = t.new_zeros(b, c, h * up, w * up)
        z[:, :, ::up, ::up] = t
        t = z
    t = F.pad(t, (px0, px1, py0, py1))
    k = torch.flip(kernel.float(), (0, 1)).to(t.device)
    weight = k[None, None].expand(c, 1, *k.shape)
    out = F.conv2d(t, weight, stride=down, groups=c)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def upsample2d(x: torch.Tensor, kernel: torch.Tensor, factor: int = 2,
               gain: float = 1.0) -> torch.Tensor:
    """StyleGAN2 upsample (upfirdn2d wrapper semantics)."""
    kh = kernel.shape[0]
    k = kernel * (gain * factor ** 2)
    p = kh - factor
    return upfirdn2d(x, k, up=factor, down=1,
                     pad=((p + 1) // 2 + factor - 1, p // 2,
                          (p + 1) // 2 + factor - 1, p // 2))


def downsample2d(x: torch.Tensor, kernel: torch.Tensor, factor: int = 2,
                 gain: float = 1.0) -> torch.Tensor:
    kh = kernel.shape[0]
    k = kernel * gain
    p = kh - factor
    return upfirdn2d(x, k, up=1, down=factor,
                     pad=((p + 1) // 2, p // 2, (p + 1) // 2, p // 2))


def make_resample_kernel(k: Sequence[int]) -> torch.Tensor:
    """1D taps -> the normalized 2D separable kernel (fp32)."""
    k1 = torch.as_tensor(k, dtype=torch.float32)
    k2 = torch.outer(k1, k1)
    return k2 / k2.sum()

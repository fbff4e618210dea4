"""Operations and bytes of the work the benchmark times, from shapes.

The peaks are those of one H100 SXM at its full 700 W (NVIDIA's data
sheet, dense rates). A kernel's least time is the larger of its bytes
over HBM bandwidth and its operations over the peak of their type; each
input byte is counted read once and each output byte written once,
whatever the kernel reads again. The counts come from the benchmark's
own plain reference, walked on the meta device, so they count the same
work whatever implements it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn

HBM_BYTES_S = 3.35e12
BF16_TC_FLOPS = 989e12    # tensor cores, bf16, dense


def bound(flops: float, nbytes: float, peak: float = BF16_TC_FLOPS) -> float:
    """Least seconds for `flops` operations and `nbytes` bytes."""
    return max(nbytes / HBM_BYTES_S, flops / peak)


def k1_cost(b, h, cin, cout, skip, cs) -> Tuple[float, float]:
    """(FLOPs, bytes) of one K1 call at B x h^2 (ops/conv3x3.py
    conv3x3_dots): the GroupNorm affine (a, b per sample and channel)
    applied to x, the activation, a 3x3 conv, the identity or projected
    (1x1 over `cs` channels) skip, and the output's per-channel sums for
    the next GroupNorm. x, skip and y once in bf16, the bf16 weights, the
    fp32 affine and bias once, the fp32 sums once a sample."""
    pix = b * h * h
    flops = 2 * pix * 9 * cin * cout
    nbytes = 2 * pix * (cin + cout) + 2 * 9 * cin * cout + 8 * b * cin \
        + 4 * cout + 8 * b * cout
    if skip == 'identity':
        nbytes += 2 * pix * cout
    elif skip == 'proj':
        nbytes += 2 * pix * cs + 2 * cs * cout
        flops += 2 * pix * cs * cout
    return flops, nbytes


def k2_cost(b, h, c) -> Tuple[float, float]:
    """(FLOPs, bytes) of one K2 call (ops/conv3x3.py downsample_dots): a
    stride-2 3x3 conv of a B x h^2 x C map with (0, 1, 0, 1) padding, x
    read and the (h/2)^2 output written once in bf16, bf16 weights, fp32
    bias."""
    ho = h // 2
    flops = 2 * b * ho * ho * 9 * c * c
    nbytes = 2 * b * h * h * c + 2 * b * ho * ho * c + 2 * 9 * c * c + 4 * c
    return flops, nbytes


def _block_inputs(model: nn.Module, x: torch.Tensor, w: float,
                  types) -> List[Tuple[nn.Module, torch.Size]]:
    """(module, input shape) of every call of a module of `types` in one
    forward of the reference, run on the meta device."""
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0].shape)))
        for m in model.modules() if isinstance(m, types)]
    try:
        with torch.no_grad():
            model(x, w)
    finally:
        for h in hooks:
            h.remove()
    return seen


def kernel_calls(model: nn.Module, batch: int, img: int, w: float) -> Dict:
    """The K1 and K2 calls one forward of `batch` faces makes, as
    (B, h, cin, cout, skip, cs) and (B, h, C) tuples: two K1 calls a
    ResBlock (conv1 without skip; conv2 with the identity or the
    projected skip of the block's input) and one for the generator's
    GroupNorm -> conv_out tail; one K2 call a Downsample. `model` is the
    reference CodeFormer on the meta device."""
    from benchmark.reference.codeformer import Downsample, ResBlock
    x = torch.empty(batch, 3, img, img, device='meta')
    k1, k2 = [], []
    for mod, shape in _block_inputs(model, x, w, (ResBlock, Downsample)):
        b, c, h = shape[0], shape[1], shape[2]
        if isinstance(mod, Downsample):
            k2.append((b, h, c))
            continue
        proj = mod.cin != mod.cout
        k1.append((b, h, mod.cin, mod.cout, 'none', 0))
        k1.append((b, h, mod.cout, mod.cout,
                   'proj' if proj else 'identity', mod.cin if proj else 0))
    tail = model.generator.blocks[-1]
    k1.append((batch, img, tail.in_channels, tail.out_channels, 'none', 0))
    return {'k1': k1, 'k2': k2}


def flops(fn) -> int:
    """Multiply-adds x 2 of `fn()` (convolutions and matmuls, as
    torch.utils.flop_counter counts them); run it on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:   # its module tracker needs autograd on
        fn()
    return counter.get_total_flops()


def forward_flops(model: nn.Module, batch: int, img: int, w: float) -> int:
    """FLOPs of one CodeFormer forward of `batch` faces (the reference on
    the meta device)."""
    return flops(lambda: model(torch.empty(batch, 3, img, img,
                                           device='meta'), w))


def forward_bounds(model: nn.Module, batch: int, img: int, w: float) -> Dict:
    """Least seconds of one forward's K1 calls and K2 calls, summed, with
    their counts."""
    calls = kernel_calls(model, batch, img, w)
    return {'k1_s': sum(bound(*k1_cost(*c)) for c in calls['k1']),
            'k2_s': sum(bound(*k2_cost(*c)) for c in calls['k2']),
            'k1_calls': len(calls['k1']), 'k2_calls': len(calls['k2'])}

"""The reference computed in float8: the control of a bf16 module that
has no lower-precision path of its own in the program.

Inside `float8_convs(model)` every Conv2d and Linear of `model` rounds
its input and its weight to float8 e4m3 (each tensor scaled so its
largest magnitude is e4m3's largest, 448, then rounded and scaled back)
and computes in float32 from those values: a float8 product with float32
accumulation, as a float8 matmul unit computes it.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

E4M3_MAX = 448.0


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, as float32."""
    scale = x.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


@contextlib.contextmanager
def float8_convs(model: nn.Module):
    saved = []
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            def conv(x, mod=mod):
                return mod._conv_forward(to_e4m3(x), to_e4m3(mod.weight),
                                         mod.bias)
            saved.append(mod)
            mod.forward = conv
        elif isinstance(mod, nn.Linear):
            def linear(x, mod=mod):
                return F.linear(to_e4m3(x), to_e4m3(mod.weight), mod.bias)
            saved.append(mod)
            mod.forward = linear
    try:
        yield model
    finally:
        for mod in saved:
            del mod.forward

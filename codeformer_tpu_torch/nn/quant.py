"""Opt-in int8 serving quantization of the VQGAN/CodeFormer conv stack
(counterpart of codeformer_tpu/nn/quant.py).

The arithmetic is the JAX package's, step for step:

- activations: one symmetric scale a tensor, s = max(max|x|, 1e-8) / 127,
  taken of x in fp32 (dynamic, every call);
- weights: one symmetric scale an output channel, over (kh, kw, cin),
  taken of the weight AFTER its cast to the compute dtype (the JAX blocks
  cast the fp32 parameter first);
- q = clip(round_half_even(v / s), -127, 127) as int8;
- the product accumulates exactly in int32; the result is
  (y.float() * (sx * sw)).to(dtype), and the caller adds the bias in
  dtype.

JAX runs the int8 product through XLA's s8 conv; PyTorch has no int8
conv, so here it is `torch._int_mm` (s8 x s8 -> s32: cuBLASLt on the
card, a plain loop on the CPU) over an im2col patch matrix built from the
kh*kw shifted slices of the padded NHWC int8 map. On CUDA `_int_mm`
needs more than 16 rows and K, N multiples of 8: K and N are padded with
zeros (conv_in's K = 27 to 32, conv_out's N = 3 to 8) and cut back, and
a map of at most 16 pixels gets zero rows. The rows go in chunks of
whole images, each patch matrix near 1 GiB.

Serving only: the round has no gradient, so a quantized module refuses
to run where autograd records (nn/blocks.py `QConv2d`), as the JAX
training entry point forces the mode off. The mode is per model
(nn/blocks.py `set_quant`), not per process.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

EPS = 1e-8
MODES = ('int8', 'off')
CHUNK_BYTES = 1 << 30      # patch-matrix bytes a _int_mm call, about

_launches = {'int_mm': 0}


def launch_counts() -> dict:
    """`torch._int_mm` calls since the last reset."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def add_launch_counts(counts: dict) -> None:
    """Add `counts` (by kernel) to the counters: a CUDA graph's replay
    runs the launches its capture recorded (pipeline/restorer.py)."""
    for k, v in counts.items():
        _launches[k] += v


def _amax_scale(amax: torch.Tensor) -> torch.Tensor:
    # a device tensor divisor: CUDA divides by a Python scalar as a
    # multiply by its reciprocal, one ulp off the IEEE quotient
    return torch.clamp_min(amax, EPS) / torch.full(
        (), 127.0, dtype=torch.float32, device=amax.device)


def _round_clip(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor dynamic int8: (x_q int8 of x's shape, scale
    fp32 0-d)."""
    xf = x.float()
    s = _amax_scale(xf.abs().amax())
    return _round_clip(xf / s), s


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an OIHW (or OI) weight: (w_q
    int8, scale fp32 (O,)), the scale over every axis but the first."""
    wf = w.float()
    s = _amax_scale(wf.abs().amax(dim=tuple(range(1, w.ndim))))
    return _round_clip(wf / s.reshape(-1, *[1] * (w.ndim - 1))), s


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


class Int8Weight(NamedTuple):
    """A quantized conv weight in the patch-matrix layout: `mat` (Np, Kp)
    int8, rows the output channels (zero rows past N), columns (kh, kw,
    cin) (zero columns past K); `scale` (N,) fp32; the kernel's shape."""
    mat: torch.Tensor
    scale: torch.Tensor
    n: int
    kh: int
    kw: int


def weight_matrix(wq: torch.Tensor) -> torch.Tensor:
    """An OIHW int8 weight as the (Np, Kp) patch-matrix operand, zero
    padded to multiples of 8."""
    n, c, kh, kw = wq.shape
    k = kh * kw * c
    mat = wq.new_zeros(_round_up(n, 8), _round_up(k, 8))
    mat[:n, :k] = wq.permute(0, 2, 3, 1).reshape(n, k)
    return mat


def prepare_weight(w: torch.Tensor) -> Int8Weight:
    """quantize_weight of an OIHW weight (already cast to the compute
    dtype), laid out for `int8_conv`."""
    wq, s = quantize_weight(w)
    n, _, kh, kw = w.shape
    return Int8Weight(weight_matrix(wq), s, n, kh, kw)


def int8_conv(xq: torch.Tensor, wt: Int8Weight, stride: int = 1,
              pads: Sequence[int] = (1, 1, 1, 1)) -> torch.Tensor:
    """The exact int32 conv of an NHWC int8 map (B, H, W, C) with a
    prepared weight: zero pads (top, bottom, left, right), stride
    `stride`. Returns (B, Ho, Wo, N) int32."""
    b, h, w, c = xq.shape
    pt, pb, pl, pr = pads
    xp = torch.nn.functional.pad(xq, (0, 0, pl, pr, pt, pb))
    ho = (h + pt + pb - wt.kh) // stride + 1
    wo = (w + pl + pr - wt.kw) // stride + 1
    k = wt.kh * wt.kw * c
    kp = wt.mat.shape[1]
    if _round_up(k, 8) != kp:
        raise ValueError(f'the weight takes K={kp}, the map gives {k}')
    per = max(1, CHUNK_BYTES // max(1, ho * wo * kp))
    outs = []
    for i in range(0, b, per):
        xs = xp[i:i + per]
        cols = [xs[:, u:u + stride * (ho - 1) + 1:stride,
                   v:v + stride * (wo - 1) + 1:stride]
                for u in range(wt.kh) for v in range(wt.kw)]
        if kp > k:
            cols.append(xs.new_zeros(*cols[0].shape[:3], kp - k))
        a = torch.cat(cols, dim=-1).reshape(-1, kp)
        m = a.shape[0]
        if m <= 16:
            a = torch.cat([a, a.new_zeros(17 - m, kp)])
        y = torch._int_mm(a, wt.mat.t())
        _launches['int_mm'] += 1
        outs.append(y[:m, :wt.n].reshape(-1, ho, wo, wt.n))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def dequantize(y: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """(y.float() * (sx * sw)).to(dtype), the scales on the last axis."""
    return (y.float() * (sx * sw)).to(dtype)


def _pads(kernel_hw, stride, padding):
    if padding == 'SAME':
        if stride != 1:
            raise ValueError("padding 'SAME' is for stride 1 here")
        kh, kw = kernel_hw
        return ((kh - 1) // 2, kh // 2, (kw - 1) // 2, kw // 2)
    (pt, pb), (pl, pr) = padding
    return (pt, pb, pl, pr)


def conv_int8(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
              padding='SAME') -> torch.Tensor:
    """Counterpart of JAX's conv_int8 for an NHWC map x and an OIHW
    weight in x's dtype: quantize both, the int32 conv, dequantize to
    x.dtype. `padding`: 'SAME' or ((top, bottom), (left, right)). No
    bias (add it outside, in x.dtype). Returns NHWC."""
    xq, sx = quantize_act(x)
    wt = prepare_weight(weight)
    y = int8_conv(xq, wt, stride, _pads(weight.shape[2:], stride, padding))
    return dequantize(y, sx, wt.scale, x.dtype)


def conv_int8_prequant(xq: torch.Tensor, sx: torch.Tensor,
                       weight: torch.Tensor, stride: int = 1,
                       padding='SAME',
                       out_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    """conv_int8 on an activation quantized already (one quantize feeding
    several convs: the phase-collapsed Upsample)."""
    wt = prepare_weight(weight)
    y = int8_conv(xq, wt, stride, _pads(weight.shape[2:], stride, padding))
    return dequantize(y, sx, wt.scale, out_dtype)

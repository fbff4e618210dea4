"""Fused bias + leaky ReLU + scale (StyleGAN2 fused_act), counterpart of
codeformer_tpu/ops/fused_act.py.

  fused_leaky_relu  out = where(y >= 0, y, y*slope) * scale, y = x + bias,
                    x (..., C) channel-last, bias (C,); differentiable
                    twice and more (the TPU kernel K4 `_fused_pallas` and
                    its VJP `_fused_bwd`)

The result has x's dtype: the sums run in fp32 from x and from the bias
rounded to x's dtype, as the Pallas kernel's `bias.astype(x.dtype)` and
the reference's CUDA kernel. (The JAX plain path adds an fp32 bias to a
bf16 x and so returns fp32.) The kernels take bf16 and fp32; the plain
versions also take fp64 and then sum in fp64, which gradcheck uses.

Gradient: dx = where(out >= 0, g, g*slope) * scale, dbias = dx summed
over all but the last dim. The backward is an autograd.Function too,
whose own backward applies the same masked scale to its incoming
gradients (the reference's FusedLeakyReLUFunctionBackward), so gradients
of gradients exist.

Dispatch: a tensor on the CPU goes to the plain PyTorch versions
(`fused_leaky_relu_ref`, `fused_leaky_relu_bwd_ref`); a CUDA tensor
launches the hand-written kernels (csrc/fused_act.cu) or raises. There is
no fallback from a kernel to its plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from codeformer_tpu_torch.kernels.build import launch, library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS = 12288     # the forward kernel keeps the bias in shared memory


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype the plain versions sum in."""
    return torch.float64 if dtype == torch.float64 else torch.float32


# ------------------------------------------------------ plain versions
def fused_leaky_relu_ref(x: torch.Tensor, bias: torch.Tensor,
                         negative_slope: float = 0.2,
                         scale: float = 2 ** 0.5) -> torch.Tensor:
    """Plain forward with the kernel's rounding points: x and the bias
    rounded to x.dtype, the arithmetic in fp32 (fp64), one rounding of
    the result to x.dtype."""
    acc = _acc(x.dtype)
    y = x.to(acc) + bias.to(x.dtype).to(acc)
    return (torch.where(y >= 0, y, y * negative_slope) * scale).to(x.dtype)


def fused_leaky_relu_bwd_ref(g: torch.Tensor, out: torch.Tensor,
                             negative_slope: float = 0.2,
                             scale: float = 2 ** 0.5
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain backward: dx (out.dtype) = where(out >= 0, g, g*slope) *
    scale in fp32 (fp64) rounded once; dbias (C,) = the fp32 (fp64) sum
    of the rounded dx over all but the last dim."""
    acc = _acc(out.dtype)
    gf = g.to(acc)
    dx = (torch.where(out >= 0, gf, gf * negative_slope) * scale) \
        .to(out.dtype)
    return dx, dx.to(acc).reshape(-1, dx.shape[-1]).sum(0)


# ------------------------------------------------------------- kernels
def _kernel_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                    device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f'{name} on {t.device}, x on {device}')
    t = t.to(dtype).contiguous()
    return t.clone() if t.data_ptr() % 16 else t   # 16-byte vector access


def _check(x: torch.Tensor, channels: int) -> None:
    if x.device.type != 'cuda':
        raise RuntimeError(f'no kernel for device {x.device}')
    if x.dtype not in _DTYPES:
        raise TypeError(f'the kernel takes {sorted(map(str, _DTYPES))}, '
                        f'got {x.dtype}')
    if x.dim() < 1 or not 0 < channels <= MAX_CHANNELS:
        raise ValueError(f'need x (..., C) with 0 < C <= {MAX_CHANNELS}, '
                         f'got shape {tuple(x.shape)}')


def fused_lrelu_fwd(x: torch.Tensor, bias: torch.Tensor,
                    negative_slope: float, scale: float) -> torch.Tensor:
    """K4 forward: as fused_leaky_relu_ref, on the kernel for CUDA."""
    if x.device.type == 'cpu':
        return fused_leaky_relu_ref(x, bias, negative_slope, scale)
    c = x.shape[-1] if x.dim() else 0
    _check(x, c)
    if bias.shape != (c,):
        raise ValueError(f'bias {tuple(bias.shape)} does not match C={c}')
    xk = _kernel_operand('x', x, x.dtype, x.device)
    bk = _kernel_operand('bias', bias.to(x.dtype), torch.float32, x.device)
    out = torch.empty_like(xk)
    if xk.numel():
        launch('fused_lrelu_fwd', xk.data_ptr(), bk.data_ptr(),
               out.data_ptr(), _DTYPES[x.dtype], xk.numel(), c,
               float(negative_slope), float(scale), on=x)
    return out


def fused_lrelu_bwd(g: torch.Tensor, out: torch.Tensor,
                    negative_slope: float, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 backward: (dx, dbias) as fused_leaky_relu_bwd_ref, on the kernel
    for CUDA; dbias is the kernel's per-block partials summed in a fixed
    order (no float atomics)."""
    if out.device.type == 'cpu':
        return fused_leaky_relu_bwd_ref(g, out, negative_slope, scale)
    c = out.shape[-1] if out.dim() else 0
    _check(out, c)
    if g.shape != out.shape:
        raise ValueError(f'gradient {tuple(g.shape)} does not match the '
                         f'output {tuple(out.shape)}')
    ok = _kernel_operand('out', out, out.dtype, out.device)
    gk = _kernel_operand('gradient', g, out.dtype, out.device)
    dx = torch.empty_like(ok)
    if not ok.numel():
        return dx, torch.zeros(c, dtype=torch.float32, device=out.device)
    dtype, dev = _DTYPES[out.dtype], out.device.index or 0
    rows = library().cf_fused_lrelu_bwd_rows(dtype, ok.numel(), c, dev)
    if rows < 1:
        raise RuntimeError(f'fused_lrelu_bwd: no grid for C={c} on {dev}')
    partial = torch.empty((rows, c), dtype=torch.float32, device=out.device)
    launch('fused_lrelu_bwd', gk.data_ptr(), ok.data_ptr(), dx.data_ptr(),
           partial.data_ptr(), dtype, ok.numel(), c, rows,
           float(negative_slope), float(scale), on=out)
    return dx, partial.sum(0)


# ------------------------------------------------------------ autograd
class _FusedLeakyReLUBackward(torch.autograd.Function):
    """(g, out) -> (dx, dbias). Its backward applies the masked scale of
    `out` to gg = ggx + ggbias (broadcast): d<gg_x, dx> / dg and
    d<gg_b, dbias> / dg; the mask is piecewise constant, so `out` gets no
    gradient."""

    @staticmethod
    def forward(ctx, g, out, negative_slope, scale):
        ctx.save_for_backward(out)
        ctx.consts = (negative_slope, scale)
        return fused_lrelu_bwd(g, out, negative_slope, scale)

    @staticmethod
    def backward(ctx, gg_x, gg_bias):
        (out,) = ctx.saved_tensors
        gg = gg_x
        if gg_bias is not None:
            gb = gg_bias.to(out.dtype)
            gg = gb.expand_as(out) if gg is None else gg + gb
        if gg is None:
            return None, None, None, None
        dg, _ = _FusedLeakyReLUBackward.apply(gg, out, *ctx.consts)
        return dg, None, None, None


class _FusedLeakyReLU(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        out = fused_lrelu_fwd(x, bias, negative_slope, scale)
        ctx.save_for_backward(out)
        ctx.consts = (negative_slope, scale)
        ctx.bias_dtype = bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        dx, dbias = _FusedLeakyReLUBackward.apply(g, out, *ctx.consts)
        return dx, dbias.to(ctx.bias_dtype), None, None


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor,
                     negative_slope: float = 0.2,
                     scale: float = 2 ** 0.5) -> torch.Tensor:
    """x: (..., C) channel-last; bias: (C,). Returns x's dtype."""
    return _FusedLeakyReLU.apply(x, bias, negative_slope, scale)

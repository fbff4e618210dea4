"""The ResBlock conv (K1), the stride-2 Downsample (K2) and the bare 3x3
conv, NHWC.

Counterpart of codeformer_tpu/ops/colpack_conv.py without the column
packing (which only fills the TPU's 128-lane matrix unit):

  conv3x3_dots    y = conv3x3_SAME(act(a*x + b)) + bias [+ skip | + skip@W1]
                  plus per-tile [sum, sumsq] of the rounded y
  downsample_dots pad (0,1,0,1), 3x3 stride-2 conv + bias, C -> C
  conv3x3_bias    y = conv3x3_SAME(x) + bias: the one function that the
                  TPU kernels conv3x3_colpack (K1'), conv3x3_pallas (K5)
                  and conv3x3_imgpair / conv3x3_pair (K6) compute in
                  three packings
  channel_stats   the stats of a stage entry (colpack_stats)
  gn_affine       GroupNorm(32, eps 1e-6) folded into a per-channel a, b

Dispatch: a tensor on the CPU goes to the plain PyTorch version
(`*_ref`); a CUDA tensor launches the hand-written kernel
(csrc/conv3x3_dots.cu, csrc/downsample_dots.cu; conv3x3_bias is
conv3x3_dots.cu compiled with no prologue, skip or statistics) or
raises. There is no fallback from the kernel to the plain version. The
kernels are forward-only, as the TPU kernels were (no VJP): their
outputs carry no autograd history, so the CUDA branch refuses to run
where autograd would record through it. Training runs the blocks'
textbook form (nn/blocks.py `set_kernels`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

ACTS = ('silu', 'none')
TILE_H, TILE_W = 8, 16     # output pixels per kernel block (conv_tile.cuh)
CHUNK = 32                 # input channels per staged chunk (conv_tile.cuh)

_launches = {'conv3x3_dots': 0, 'downsample_dots': 0, 'conv3x3_bias': 0}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


# ------------------------------------------------------- GroupNorm fold
def channel_stats(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 1, 2, C) fp32 [sum, sumsq] over H, W, in the
    layout conv3x3_dots emits its partials in."""
    x32 = x.float()
    return torch.stack([x32.sum((1, 2)), x32.square().sum((1, 2))],
                       dim=1)[:, None]


def gn_affine(stats: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              n_pixels: int, num_groups: int = 32,
              eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold GroupNorm into gn(x) = a*x + b per (sample, channel).

    stats: (B, n_tiles, 2, C) partial [sum, sumsq]; n_pixels: H*W.
    var = E[x^2] - mean^2 in fp32, as colpack_conv.gn_affine. Returns
    (a, b), each (B, C) fp32 contiguous.
    """
    s = stats.float().sum(1)                         # (B, 2, C)
    bsz, _, c = s.shape
    per = c // num_groups
    g = s.reshape(bsz, 2, num_groups, per).sum(-1)   # (B, 2, G)
    cnt = n_pixels * per
    mean = g[:, 0] / cnt
    var = g[:, 1] / cnt - mean * mean
    rstd = torch.rsqrt(var + eps)
    a = rstd.repeat_interleave(per, 1) * gamma.float()[None]
    b = beta.float()[None] - mean.repeat_interleave(per, 1) * a
    return a.contiguous(), b.contiguous()


# ------------------------------------------------------ plain versions
def conv3x3_dots_ref(x, a, b, act, weight, bias, skip=None, w1x1=None,
                     compute_dtype=torch.float32):
    """Plain PyTorch K1 with the kernel's rounding points: the activated
    map and the weights are rounded to x.dtype, the conv runs in
    compute_dtype (fp32: the reference; x.dtype: the plain path at
    PyTorch's own speed), y is rounded to x.dtype and the stats are taken
    of the rounded y.

    x: (B, H, W, Cin); a, b: (B, Cin) fp32; weight: (Cout, Cin, 3, 3);
    bias: (Cout,); skip: (B, H, W, Cout) identity, or (B, H, W, Cs) with
    w1x1 (Cout, Cs[, 1, 1]). Returns (y (B, H, W, Cout), stats
    (B, 1, 2, Cout) fp32).
    """
    if act not in ACTS:
        raise ValueError(f'act must be one of {ACTS}, got {act!r}')
    dt, ct = x.dtype, compute_dtype
    h = x.float() * a[:, None, None] + b[:, None, None]
    if act == 'silu':
        h = F.silu(h)
    h = h.to(dt).to(ct).permute(0, 3, 1, 2)
    y = F.conv2d(h, weight.to(dt).to(ct), bias.to(ct), padding=1)
    y = y.permute(0, 2, 3, 1).float()
    if skip is not None:
        s = skip.to(ct)
        if w1x1 is not None:
            s = s @ w1x1.reshape(w1x1.shape[0], -1).to(dt).to(ct).t()
        y = y + s.float()
    y = y.to(dt)
    return y, channel_stats(y)


def downsample_dots_ref(x, weight, bias, compute_dtype=torch.float32):
    """Plain PyTorch K2: pad (0,1,0,1) (right and bottom only, not
    symmetric), then a 3x3 stride-2 conv in compute_dtype with the
    weights rounded to x.dtype. x: (B, H, W, C) -> (B, H/2, W/2, C)."""
    ct = compute_dtype
    h = F.pad(x.to(ct).permute(0, 3, 1, 2), (0, 1, 0, 1))
    y = F.conv2d(h, weight.to(x.dtype).to(ct), bias.to(ct), stride=2)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def conv3x3_bias_ref(x, weight, bias, compute_dtype=torch.float32):
    """Plain bare conv: a SAME 3x3 stride-1 conv of x (B, H, W, Cin) with
    weight (Cout, Cin, 3, 3) rounded to x.dtype, in compute_dtype (fp32:
    the reference; x.dtype: the plain path at PyTorch's speed), plus the
    bias, rounded once to x.dtype: (B, H, W, Cout)."""
    ct = compute_dtype
    y = F.conv2d(x.to(ct).permute(0, 3, 1, 2), weight.to(x.dtype).to(ct),
                 bias.to(ct), padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


# ----------------------------------------------------- kernel operands
def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def n_frags(cout: int) -> int:
    """16-wide output-channel fragments per kernel block."""
    return 4 if cout >= 64 else 1


def kernel_weight(weight: torch.Tensor, cout_p: int,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (9, Cin, cout_p) [tap][in][out], zero-padded
    output channels, tap = 3*dy + dx."""
    cout, cin = weight.shape[:2]
    w = weight.permute(2, 3, 1, 0).reshape(9, cin, cout)
    return F.pad(w, (0, cout_p - cout)).to(dtype).contiguous()


def kernel_w1x1(w1x1: torch.Tensor, cout_p: int,
                dtype=torch.bfloat16) -> torch.Tensor:
    """(Cout, Cs[, 1, 1]) -> (Cs, cout_p)."""
    w = w1x1.reshape(w1x1.shape[0], -1).t()
    return F.pad(w, (0, cout_p - w.shape[1])).to(dtype).contiguous()


def kernel_bias(bias: torch.Tensor, cout_p: int) -> torch.Tensor:
    return F.pad(bias.float(), (0, cout_p - bias.shape[0])).contiguous()


def stats_tiles(h: int, w: int) -> int:
    """Stats slots per image that conv3x3_dots writes (one per block)."""
    return -(-h // TILE_H) * -(-w // TILE_W)


def _check_act_map(name: str, t: torch.Tensor, channels: int) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f'{name}: the kernel takes bfloat16, got {t.dtype}')
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f'{name}: need a contiguous NHWC (B, H, W, C) '
                         f'tensor, got shape {tuple(t.shape)} strides '
                         f'{t.stride()}')
    if t.shape[-1] != channels or channels % CHUNK:
        raise ValueError(f'{name}: channels {t.shape[-1]} must equal '
                         f'{channels} and be a multiple of {CHUNK}')
    if t.data_ptr() % 16:
        raise ValueError(f'{name}: data must be 16-byte aligned')


def _check_params(x: torch.Tensor, *params) -> None:
    for p in params:
        if p is not None and p.device != x.device:
            raise ValueError(f'parameter on {p.device}, activations on '
                             f'{x.device}')


def _refuse_autograd(name: str, *tensors) -> None:
    """Raise where autograd would record through a kernel: its output has
    no history, so every parameter upstream would silently get no
    gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f'{name}: the kernel is forward-only and an input or weight '
            f'requires grad; run under torch.no_grad() or switch the '
            f'module to its textbook form (nn.blocks.set_kernels(model, '
            f'False))')


def _device_and_stream(x: torch.Tensor):
    if x.device.type != 'cuda':
        raise RuntimeError(f'no kernel for device {x.device}')
    return x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream


# ------------------------------------------------------------- kernels
def conv3x3_dots(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 act: str, weight: torch.Tensor, bias: torch.Tensor,
                 skip: Optional[torch.Tensor] = None,
                 w1x1: Optional[torch.Tensor] = None):
    """K1. Arguments and results as conv3x3_dots_ref; on CUDA the stats
    are per kernel block: (B, stats_tiles(H, W), 2, Cout)."""
    if x.device.type == 'cpu':
        return conv3x3_dots_ref(x, a, b, act, weight, bias, skip, w1x1)
    _refuse_autograd('conv3x3_dots', x, a, b, weight, bias, skip, w1x1)
    from codeformer_tpu_torch.kernels.build import library
    if act not in ACTS:
        raise ValueError(f'act must be one of {ACTS}, got {act!r}')
    bsz, h, w, cin = x.shape
    cout = weight.shape[0]
    if weight.shape != (cout, cin, 3, 3):
        raise ValueError(f'weight {tuple(weight.shape)} does not match '
                         f'Cin={cin}')
    if cout % CHUNK and cout != 3:
        raise ValueError(f'Cout={cout} must be a multiple of {CHUNK} or 3')
    _check_act_map('x', x, cin)
    _check_params(x, weight, bias, w1x1)
    for name, t in (('a', a), ('b', b)):
        if t.dtype != torch.float32 or t.shape != (bsz, cin) \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f'{name}: need contiguous fp32 ({bsz}, {cin}) '
                             f'on {x.device}')
    skip_mode, cs = 0, 0
    w1 = None
    if skip is not None:
        if w1x1 is None:
            skip_mode = 1
            _check_act_map('skip', skip, cout)
        else:
            skip_mode = 2
            cs = skip.shape[-1]
            _check_act_map('skip', skip, cs)
            if w1x1.reshape(w1x1.shape[0], -1).shape != (cout, cs):
                raise ValueError(f'w1x1 {tuple(w1x1.shape)} does not map '
                                 f'{cs} -> {cout} channels')
        if skip.shape[:3] != x.shape[:3]:
            raise ValueError('skip and x differ in (B, H, W)')
    elif w1x1 is not None:
        raise ValueError('w1x1 given without skip')

    nf = n_frags(cout)
    cout_p = _round_up(cout, 16 * nf)
    wk = kernel_weight(weight, cout_p)
    bk = kernel_bias(bias, cout_p)
    if skip_mode == 2:
        w1 = kernel_w1x1(w1x1, cout_p)
    y = torch.empty((bsz, h, w, cout), dtype=x.dtype, device=x.device)
    stats = torch.empty((bsz, stats_tiles(h, w), 2, cout),
                        dtype=torch.float32, device=x.device)
    dev, stream = _device_and_stream(x)
    rc = library().cf_conv3x3_dots(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), wk.data_ptr(),
        bk.data_ptr(), skip.data_ptr() if skip is not None else None,
        w1.data_ptr() if w1 is not None else None, y.data_ptr(),
        stats.data_ptr(), bsz, h, w, cin, cout, cout_p, cs,
        1 if act == 'silu' else 0, skip_mode, nf, dev, stream)
    if rc != 0:
        raise RuntimeError(f'conv3x3_dots kernel launch failed: cudaError {rc}')
    _launches['conv3x3_dots'] += 1
    return y, stats


def downsample_dots(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """K2: (B, H, W, C) -> (B, H/2, W/2, C), as downsample_dots_ref."""
    if x.device.type == 'cpu':
        return downsample_dots_ref(x, weight, bias)
    _refuse_autograd('downsample_dots', x, weight, bias)
    from codeformer_tpu_torch.kernels.build import library
    bsz, h, w, c = x.shape
    if weight.shape != (c, c, 3, 3):
        raise ValueError(f'weight {tuple(weight.shape)} is not ({c}, {c}, '
                         f'3, 3)')
    _check_act_map('x', x, c)
    _check_params(x, weight, bias)
    cout_p = _round_up(c, 64)
    wk = kernel_weight(weight, cout_p)
    bk = kernel_bias(bias, cout_p)
    y = torch.empty((bsz, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    dev, stream = _device_and_stream(x)
    rc = library().cf_downsample_dots(
        x.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(),
        bsz, h, w, c, cout_p, dev, stream)
    if rc != 0:
        raise RuntimeError(f'downsample_dots kernel launch failed: '
                           f'cudaError {rc}')
    _launches['downsample_dots'] += 1
    return y


def conv3x3_bias(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """The bare conv: (B, H, W, Cin) -> (B, H, W, Cout), as
    conv3x3_bias_ref. On CUDA: bf16 x, Cin a multiple of 32, Cout a
    multiple of 32 or 3 (K1's limits); the sums are fp32 and the bias is
    added in the fp32 epilogue."""
    if x.device.type == 'cpu':
        return conv3x3_bias_ref(x, weight, bias)
    _refuse_autograd('conv3x3_bias', x, weight, bias)
    from codeformer_tpu_torch.kernels.build import library
    bsz, h, w, cin = x.shape
    cout = weight.shape[0]
    if weight.shape != (cout, cin, 3, 3) or bias.shape != (cout,):
        raise ValueError(f'weight {tuple(weight.shape)} / bias '
                         f'{tuple(bias.shape)} do not match Cin={cin}')
    if cout % CHUNK and cout != 3:
        raise ValueError(f'Cout={cout} must be a multiple of {CHUNK} or 3')
    _check_act_map('x', x, cin)
    _check_params(x, weight, bias)
    nf = n_frags(cout)
    cout_p = _round_up(cout, 16 * nf)
    wk = kernel_weight(weight, cout_p)
    bk = kernel_bias(bias, cout_p)
    y = torch.empty((bsz, h, w, cout), dtype=x.dtype, device=x.device)
    dev, stream = _device_and_stream(x)
    rc = library().cf_conv3x3_bias(
        x.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(), bsz, h, w,
        cin, cout, cout_p, nf, dev, stream)
    if rc != 0:
        raise RuntimeError(f'conv3x3_bias kernel launch failed: cudaError '
                           f'{rc}')
    _launches['conv3x3_bias'] += 1
    return y

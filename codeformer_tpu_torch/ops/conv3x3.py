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
  conv3x3_dense   out = epi(conv3x3_SAME(x) + bias [, s1, s2]) with x a
                  channel prefix and out a channel slice of wider NHWC
                  buffers: RRDBNet's dense blocks without concatenation
                  (no TPU kernel: the JAX package runs XLA's convs)
  channel_stats   the stats of a stage entry (colpack_stats)
  gn_affine       GroupNorm(32, eps 1e-6) folded into a per-channel a, b

Dispatch: a tensor on the CPU goes to the plain PyTorch version
(`*_ref`); a CUDA tensor launches the hand-written kernel or raises:
K1 csrc/conv3x3_dots.cu, conv3x3_bias csrc/conv3x3_bias.cu, K2
csrc/downsample_dots.cu and the dense conv csrc/conv3x3_dense.cu, all
on the Hopper conv core
csrc/conv_sm90.cuh (TMA, wgmma, persistent blocks), whose tiling
`conv_plan` chooses here. There is no fallback from the kernel to
the plain version. The kernels are forward-only, as the TPU kernels were
(no VJP): their outputs carry no autograd history, so the CUDA branch
refuses to run where autograd would record through it. Training runs
the blocks' textbook form (nn/blocks.py `set_kernels`).

Each CUDA call is two steps, so a caller can keep the first and time
the second alone: preparing the operands (kernel-layout weight and bias,
the plan, the output) -- `dots_operands` + `prepare_dots`,
`conv_operands` + `prepare_conv` -- and the launch on them --
`launch_dots`, `launch_conv`. The blocks keep their operands between
calls in eval mode (nn/blocks.py `kept_operands`), RRDBNet its trunk's
(models/rrdbnet.py).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from codeformer_tpu_torch.kernels.build import launch

ACTS = ('silu', 'none')
CHUNK = 32                 # the channel multiple every conv kernel takes

# the dense conv's epilogues (csrc/conv_sm90.cuh EPI_*), on v = acc + bias
EPIS = ('lrelu', 'res', 'rrdb', 'add')


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

    stats: (B, slots, 2, C) partial [sum, sumsq] (channel_stats, or
    K1's one slot a tile: stats_slots); n_pixels: H*W.
    var = E[x^2] - mean^2 in fp32, as colpack_conv.gn_affine, clamped at
    0 as flax's GroupNorm clamps it: on a near-constant bf16 map rounding
    takes it below -eps, where rsqrt would give NaN. Returns (a, b), each
    (B, C) fp32 contiguous.
    """
    s = stats.float().sum(1)                         # (B, 2, C)
    bsz, _, c = s.shape
    per = c // num_groups
    g = s.reshape(bsz, 2, num_groups, per).sum(-1)   # (B, 2, G)
    cnt = n_pixels * per
    mean = g[:, 0] / cnt
    var = (g[:, 1] / cnt - mean * mean).clamp_min(0)
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


def dense_epilogue(v: torch.Tensor, epi: str, s1=None,
                   s2=None) -> torch.Tensor:
    """The dense conv's epilogue on v = conv + bias, in v's dtype:
    'lrelu' leaky_relu(v, 0.2) (conv1-4 of a dense block), 'res' 0.2 v +
    s1 (its conv5), 'rrdb' 0.2 (0.2 v + s1) + s2 (conv5 of an RRDB's third
    block: the block's residual and the RRDB's), 'add' v + s1
    (conv_body)."""
    if epi == 'lrelu':
        return F.leaky_relu(v, 0.2)
    if epi == 'res':
        return 0.2 * v + s1.to(v.dtype)
    if epi == 'rrdb':
        return 0.2 * (0.2 * v + s1.to(v.dtype)) + s2.to(v.dtype)
    if epi == 'add':
        return v + s1.to(v.dtype)
    raise ValueError(f'epi must be one of {EPIS}, got {epi!r}')


def conv3x3_dense_ref(x, weight, bias, out, epi, s1=None, s2=None,
                      compute_dtype=torch.float32):
    """Plain dense conv: out = epi(conv3x3_SAME(x) + bias, s1, s2), the
    conv in compute_dtype with the weights rounded to x.dtype, the
    epilogue in fp32 (dense_epilogue), rounded once to out.dtype and
    written into `out` in place. x, out, s1, s2: (B, H, W, C) views, e.g.
    a channel prefix and a channel slice of one wider buffer. Returns
    out."""
    ct = compute_dtype
    v = F.conv2d(x.to(ct).permute(0, 3, 1, 2), weight.to(x.dtype).to(ct),
                 bias.to(ct), padding=1)
    v = dense_epilogue(v.permute(0, 2, 3, 1).float(), epi, s1, s2)
    out.copy_(v.to(out.dtype))
    return out


# ----------------------------------------------------- kernel operands
def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def operand_key(t: torch.Tensor) -> tuple:
    """What operands made from `t` and kept between calls depend on: an
    in-place update (`_version`), new storage, another device or dtype
    makes them stale (nn/blocks.py `kept_operands`, ops/vq.py
    `codebook_key`)."""
    return (t._version, t.data_ptr(), t.device, t.dtype)


def kernel_bias(bias: torch.Tensor, cout_p: int) -> torch.Tensor:
    return F.pad(bias.float(), (0, cout_p - bias.shape[0])).contiguous()


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


def _need_cuda(x: torch.Tensor) -> None:
    if x.device.type != 'cuda':
        raise RuntimeError(f'no kernel for device {x.device}')


# ------------------------------------------ the Hopper conv core's plan
# Mirrors of csrc/conv_sm90.cuh's constants: the plan is chosen here and
# only checked there.
SM90_TW = 16               # output columns per tile
SM90_KC = 64               # input channels per staged chunk (128 B)
SMEM_LIMIT = 232448        # shared memory a block may opt in to (H100)
ALIGN_SLACK = 1024         # the 1024-B alignment of the base
BARRIER_BYTES = 128
MAX_STAGES = 4
# (MB, BN) the kernels are built for, by stride, best first: BN output
# channels a block (shared-memory reads per FLOP fall with BN: A is read
# once per k16 step for all BN columns), then MB m64 blocks a consumer
# warpgroup (a tile of 8 * MB output rows; a larger tile re-reads fewer
# halo rows)
VARIANTS = {1: ((1, 128), (2, 64), (1, 64), (1, 32), (1, 16), (2, 8)),
            2: ((1, 128), (1, 64), (1, 32), (1, 16))}
# the dense conv's (csrc/conv3x3_dense.cu dense_variant), best first:
# BN >= 32, as its slice is stored 16 bytes a lane; at BN = 32 a tile of
# 16 rows re-stages fewer halo rows than one of 8
DENSE_VARIANTS = ((1, 64), (2, 32), (1, 32))


def tile_h(mb: int) -> int:
    """Output rows of a tile (csrc/conv_sm90.cuh tile_h)."""
    return 8 * mb


def win_hw(stride: int, th: int) -> Tuple[int, int]:
    """(rows, columns) of the input window of a tile of th rows: the TMA
    box."""
    if stride == 1:
        return th + 2, SM90_TW + 2
    return 2 * th + 1, 2 * SM90_TW + 1


def slot_bytes(stride: int, th: int) -> int:
    """Bytes of one ring slot: the window, 128 B a pixel, 1024-aligned."""
    bh, bw = win_hw(stride, th)
    return _round_up(bh * bw * 2 * SM90_KC, 1024)


def stats_bytes(bn: int) -> int:
    """K1's per-warp statistics partials: [sum, sumsq] x BN fp32 for each
    of the 8 consumer warps (csrc/conv_sm90.cuh stats_bytes)."""
    return 8 * 2 * bn * 4


class ConvPlan(NamedTuple):
    stride: int
    ho: int
    wo: int
    th: int                # output rows a tile (TW = SM90_TW columns)
    mb: int                # m64 blocks per consumer warpgroup
    bn: int                # output channels a block
    split: int             # blocks that share the input chunks of a pixel
    chunks: int            # 64-channel input chunks
    coutp: int             # Cout padded to a multiple of 8
    stages: int            # windows in flight
    smem: int              # dynamic shared memory a block
    tiles_x: int
    tiles_y: int
    n_tiles: int           # B * tiles_y * tiles_x
    n_slices: int          # coutp // bn
    grid_x: int            # persistent blocks per (slice, split)
    fused: bool = False    # K1: prologue, skip and statistics
    s_chunks: int = 0      # K1's 64-channel chunks of a projected skip


@functools.lru_cache(maxsize=None)
def conv_plan(bsz: int, h: int, w: int, cin: int, cout: int, stride: int,
              num_sms: int = 132, fused: bool = False,
              cs: int = 0, dense: bool = False) -> ConvPlan:
    """The tiling of one conv on the Hopper core. Every (MB, BN, split)
    whose resident weights (its chunks x 9 taps x BN rows x 128 B) and at
    least two ring slots fit the shared memory is a candidate; the plan
    takes the one that comes closest to one block per SM, then the
    smallest split (a split adds an fp32 pass), then the best variant.

    `fused` plans K1 (stride 1). Its shared memory adds the resident 1x1
    weights of a projected skip of `cs` channels (its ceil(cs / 64)
    chunks dealt round the splits, BN rows x 128 B a chunk) and the
    statistics partials; the skip's TH x 16-pixel box fits the ring slot
    of the window it follows, and the ready barriers the 128 bytes of
    barriers. The blocks of every BN slice rewrite the same windows with
    the prologue, so a narrow BN repeats the prologue over many slices
    and runs small products: K1 takes the smallest split that lets it
    reach BN = min(64, Cout) (the split's second pass,
    dots_finish_kernel, then adds the bias and the skip, rounds and
    takes the statistics), and a narrow BN only where no split does.

    `dense` plans the dense conv (stride 1) over DENSE_VARIANTS: its
    shared memory is the bare conv's."""
    if (fused or dense) and stride != 1:
        raise ValueError('K1 and the dense conv are stride-1 convs')
    ho, wo = (h, w) if stride == 1 else (h // 2, w // 2)
    chunks = -(-cin // SM90_KC)
    s_chunks = -(-cs // SM90_KC) if fused else 0
    coutp = _round_up(cout, 8)
    cands = []
    for split in (s for s in range(1, chunks + 1) if chunks % s == 0):
        for pref, (mb, bn) in enumerate(DENSE_VARIANTS if dense
                                        else VARIANTS[stride]):
            if coutp % bn:
                continue
            th = tile_h(mb)
            w_bytes = chunks // split * 9 * bn * 2 * SM90_KC
            if fused:   # W1: the skip's chunks dealt round the splits
                w_bytes += (-(-s_chunks // split) * bn * 2 * SM90_KC
                            + stats_bytes(bn))
            slot = slot_bytes(stride, th)
            stages = min(MAX_STAGES, (SMEM_LIMIT - ALIGN_SLACK
                                      - BARRIER_BYTES - w_bytes) // slot)
            if stages < 2:
                continue
            tiles_x, tiles_y = -(-wo // SM90_TW), -(-ho // th)
            n_tiles = bsz * tiles_x * tiles_y
            groups = coutp // bn * split
            key = (max(0, num_sms - n_tiles * groups), split, pref)
            cands.append((key, ConvPlan(
                stride, ho, wo, th, mb, bn, split, chunks, coutp, stages,
                ALIGN_SLACK + w_bytes + stages * slot + BARRIER_BYTES,
                tiles_x, tiles_y, n_tiles, coutp // bn,
                max(1, min(n_tiles, num_sms // groups)), fused, s_chunks)))
    if fused:
        cands = [c for c in cands if c[1].bn >= min(64, coutp)] or cands
    if not cands:
        raise ValueError(f'no conv plan fits {cin} -> {cout} channels')
    return min(cands, key=lambda c: c[0])[1]


def stats_slots(plan: ConvPlan) -> int:
    """K1's statistics slots an image: one a tile (tiles_y x tiles_x),
    each written by the block that walks the tile, for its BN channels."""
    return plan.tiles_x * plan.tiles_y


@functools.lru_cache(maxsize=None)
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def swizzle_rows(w: torch.Tensor) -> torch.Tensor:
    """(..., rows, 64) -> the same with the 128-byte swizzle of a K-major
    wgmma operand: 16-byte group g of row n stored at g ^ (n % 8). Its own
    inverse."""
    rows = w.shape[-2]
    n = torch.arange(rows, device=w.device)
    idx = torch.arange(8, device=w.device)[None, :] ^ (n[:, None] % 8)
    w8 = w.reshape(*w.shape[:-1], 8, 8)
    return w8.gather(-2, idx[..., None].expand(w8.shape)).reshape(w.shape)


class ConvOperands(NamedTuple):
    """One conv's parameters in the Hopper core's layout."""
    weight: torch.Tensor   # (chunks, 9, coutp, 64), rows swizzled
    bias: torch.Tensor     # (coutp,) fp32
    cin: int
    cout: int


def conv_operands(weight: torch.Tensor, bias: torch.Tensor,
                  dtype=torch.bfloat16) -> ConvOperands:
    """(Cout, Cin, 3, 3) weight and (Cout,) bias -> ConvOperands:
    [chunk][tap][out][in % 64], tap = 3*dy + dx, input channels past Cin
    and output channels past Cout zero. The layout does not depend on the
    plan: a block's slab is 9 x its chunks runs of BN rows."""
    with torch.no_grad():
        cout, cin = weight.shape[:2]
        chunks, coutp = -(-cin // SM90_KC), _round_up(cout, 8)
        w = weight.detach().permute(2, 3, 0, 1).reshape(9, cout, cin)
        w = F.pad(w, (0, chunks * SM90_KC - cin, 0, coutp - cout)).to(dtype)
        w = w.reshape(9, coutp, chunks, SM90_KC).permute(2, 0, 1, 3)
        return ConvOperands(swizzle_rows(w).contiguous(),
                            kernel_bias(bias.detach(), coutp), cin, cout)


def operands_weight(ops: ConvOperands) -> torch.Tensor:
    """The inverse of conv_operands' weight layout: (Cout, Cin, 3, 3)."""
    w = swizzle_rows(ops.weight).permute(1, 2, 0, 3)
    w = w.reshape(9, w.shape[1], -1)[:, :ops.cout, :ops.cin]
    return w.reshape(3, 3, ops.cout, ops.cin).permute(2, 3, 0, 1)


class ConvLaunch(NamedTuple):
    """Everything one launch of the Hopper core needs."""
    x: torch.Tensor
    ops: ConvOperands
    plan: ConvPlan
    y: torch.Tensor
    ws: Optional[torch.Tensor]   # fp32 partials of a split


def prepare_conv(x: torch.Tensor, ops: ConvOperands,
                 stride: int) -> ConvLaunch:
    """Check x against the operands, plan the launch and allocate its
    output (and a split's fp32 partials)."""
    bsz, h, w, cin = x.shape
    _check_act_map('x', x, cin)
    if cin != ops.cin:
        raise ValueError(f'x has {cin} channels, the weight {ops.cin}')
    _check_params(x, ops.weight, ops.bias)
    plan = conv_plan(bsz, h, w, cin, ops.cout, stride,
                     _num_sms(x.device.index or 0))
    y = torch.empty((bsz, plan.ho, plan.wo, ops.cout), dtype=x.dtype,
                    device=x.device)
    ws = None
    if plan.split > 1:
        ws = torch.empty((plan.split, bsz * plan.ho * plan.wo, plan.coutp),
                         dtype=torch.float32, device=x.device)
    return ConvLaunch(x, ops, plan, y, ws)


def launch_conv(c: ConvLaunch) -> torch.Tensor:
    """Launch conv3x3_bias (stride 1) or K2 (stride 2) on prepared
    operands; returns the prepared output."""
    if c.y.numel() == 0:
        return c.y
    p, (bsz, h, w, cin) = c.plan, c.x.shape
    ptrs = (c.x.data_ptr(), c.ops.weight.data_ptr(), c.ops.bias.data_ptr(),
            c.y.data_ptr(), c.ws.data_ptr() if c.ws is not None else None)
    tail = (p.coutp, p.bn, p.mb, p.split, p.stages, p.smem, p.grid_x)
    if p.stride == 1:
        launch('conv3x3_bias', *ptrs, bsz, h, w, cin, c.ops.cout, *tail,
               on=c.x)
    else:
        launch('downsample_dots', *ptrs, bsz, h, w, cin, *tail, on=c.x)
    return c.y


# ------------------------------------------------------------------ K1
def w1_operand(w1x1: torch.Tensor, coutp: int,
               dtype=torch.bfloat16) -> torch.Tensor:
    """(Cout, Cs[, 1, 1]) -> (ceil(Cs/64), coutp, 64) [chunk][out][in %
    64], rows swizzled like conv_operands' taps, input channels past Cs
    and output channels past Cout zero."""
    with torch.no_grad():
        w = w1x1.detach().reshape(w1x1.shape[0], -1)
        cout, cs = w.shape
        chunks = -(-cs // SM90_KC)
        w = F.pad(w, (0, chunks * SM90_KC - cs, 0, coutp - cout)).to(dtype)
        w = w.reshape(coutp, chunks, SM90_KC).permute(1, 0, 2)
        return swizzle_rows(w).contiguous()


class DotsOperands(NamedTuple):
    """K1's parameters in the Hopper core's layout."""
    conv: ConvOperands             # the 3x3 weight and the (folded) bias
    w1: Optional[torch.Tensor]     # w1_operand of a projected skip, or None
    cs: int                        # the projected skip's channels, or 0


def dots_operands(weight: torch.Tensor, bias: torch.Tensor,
                  w1x1: Optional[torch.Tensor] = None,
                  dtype=torch.bfloat16) -> DotsOperands:
    """K1's weight (Cout, Cin, 3, 3), bias (Cout,) and, for a projected
    skip, 1x1 weight (Cout, Cs[, 1, 1]) -> DotsOperands. The bias is the
    conv's, plus the projection's own where there is one (the caller
    folds it in, as the ResBlock does)."""
    conv = conv_operands(weight, bias, dtype)
    if w1x1 is None:
        return DotsOperands(conv, None, 0)
    if w1x1.shape[0] != conv.cout or w1x1[0].numel() != w1x1.shape[1]:
        raise ValueError(f'w1x1 {tuple(w1x1.shape)} is no (Cout={conv.cout}'
                         f', Cs[, 1, 1]) projection')
    return DotsOperands(conv, w1_operand(w1x1, conv.bias.shape[0], dtype),
                        w1x1.shape[1])


class DotsLaunch(NamedTuple):
    """Everything one launch of K1 needs."""
    x: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    ops: DotsOperands
    skip: Optional[torch.Tensor]
    plan: ConvPlan
    y: torch.Tensor
    stats: torch.Tensor            # (B, stats_slots(plan), 2, Cout) fp32
    ws: Optional[torch.Tensor]     # fp32 partials of a split
    act: int                       # 0 none, 1 SiLU
    skip_mode: int                 # 0 none, 1 identity, 2 projected


def prepare_dots(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 act: str, ops: DotsOperands,
                 skip: Optional[torch.Tensor] = None) -> DotsLaunch:
    """K1's checks against the operands, its plan and its outputs."""
    if act not in ACTS:
        raise ValueError(f'act must be one of {ACTS}, got {act!r}')
    bsz, h, w, cin = x.shape
    cout = ops.conv.cout
    if cin != ops.conv.cin:
        raise ValueError(f'x has {cin} channels, the weight {ops.conv.cin}')
    if cout % CHUNK and cout != 3:
        raise ValueError(f'Cout={cout} must be a multiple of {CHUNK} or 3')
    _check_act_map('x', x, cin)
    _check_params(x, ops.conv.weight, ops.conv.bias, ops.w1)
    for name, t in (('a', a), ('b', b)):
        if t.dtype != torch.float32 or t.shape != (bsz, cin) \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f'{name}: need contiguous fp32 ({bsz}, {cin}) '
                             f'on {x.device}')
    skip_mode = 0
    if skip is not None:
        skip_mode = 2 if ops.w1 is not None else 1
        _check_act_map('skip', skip, ops.cs if ops.w1 is not None else cout)
        if skip.shape[:3] != x.shape[:3]:
            raise ValueError('skip and x differ in (B, H, W)')
    elif ops.w1 is not None:
        raise ValueError('a 1x1 projection given without skip')
    plan = conv_plan(bsz, h, w, cin, cout, 1, _num_sms(x.device.index or 0),
                     fused=True, cs=ops.cs)
    ws = None
    if plan.split > 1:
        ws = torch.empty((plan.split, bsz * h * w, plan.coutp),
                         dtype=torch.float32, device=x.device)
    return DotsLaunch(
        x, a, b, ops, skip, plan,
        torch.empty((bsz, h, w, cout), dtype=x.dtype, device=x.device),
        torch.empty((bsz, stats_slots(plan), 2, cout), dtype=torch.float32,
                    device=x.device), ws,
        1 if act == 'silu' else 0, skip_mode)


def launch_dots(c: DotsLaunch):
    """Launch K1 on prepared operands; returns the prepared (y, stats)."""
    if c.y.numel() == 0:
        return c.y, c.stats
    p, (bsz, h, w, cin) = c.plan, c.x.shape
    launch('conv3x3_dots',
           c.x.data_ptr(), c.a.data_ptr(), c.b.data_ptr(),
           c.ops.conv.weight.data_ptr(), c.ops.conv.bias.data_ptr(),
           c.skip.data_ptr() if c.skip is not None else None,
           c.ops.w1.data_ptr() if c.skip_mode == 2 else None, c.y.data_ptr(),
           c.stats.data_ptr(), c.ws.data_ptr() if c.ws is not None else None,
           bsz, h, w, cin, c.ops.conv.cout, p.coutp, c.ops.cs, c.act,
           c.skip_mode, p.bn, p.mb, p.split, p.stages, p.smem, p.grid_x,
           on=c.x)
    return c.y, c.stats


def conv3x3_dots(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 act: str, weight: torch.Tensor, bias: torch.Tensor,
                 skip: Optional[torch.Tensor] = None,
                 w1x1: Optional[torch.Tensor] = None,
                 prepared: Optional[DotsOperands] = None):
    """K1. Arguments and results as conv3x3_dots_ref; on CUDA the stats
    are one slot a tile: (B, stats_slots(plan), 2, Cout). `prepared`:
    dots_operands(weight, bias, w1x1) kept by the caller (the ResBlock and
    the Generator's tail keep them between calls), else made here."""
    if x.device.type == 'cpu':
        return conv3x3_dots_ref(x, a, b, act, weight, bias, skip, w1x1)
    _refuse_autograd('conv3x3_dots', x, a, b, weight, bias, skip, w1x1)
    _need_cuda(x)
    cout, cin = weight.shape[:2]
    if weight.shape != (cout, x.shape[-1], 3, 3) or bias.shape != (cout,):
        raise ValueError(f'weight {tuple(weight.shape)} / bias '
                         f'{tuple(bias.shape)} do not match '
                         f'Cin={x.shape[-1]}')
    ops = prepared if prepared is not None \
        else dots_operands(weight, bias, w1x1)
    if (ops.conv.cin, ops.conv.cout) != (cin, cout) \
            or (ops.w1 is None) != (w1x1 is None):
        raise ValueError('the prepared operands do not match the weights')
    return launch_dots(prepare_dots(x, a, b, act, ops, skip))


def downsample_dots(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor,
                    prepared: Optional[ConvOperands] = None) -> torch.Tensor:
    """K2: (B, H, W, C) -> (B, H/2, W/2, C), as downsample_dots_ref.
    `prepared`: conv_operands(weight, bias) kept by the caller (the
    Downsample module keeps them between calls), else made here."""
    if x.device.type == 'cpu':
        return downsample_dots_ref(x, weight, bias)
    _refuse_autograd('downsample_dots', x, weight, bias)
    _need_cuda(x)
    c = x.shape[-1]
    if weight.shape != (c, c, 3, 3):
        raise ValueError(f'weight {tuple(weight.shape)} is not ({c}, {c}, '
                         f'3, 3)')
    ops = prepared if prepared is not None else conv_operands(weight, bias)
    if (ops.cin, ops.cout) != (c, c):
        raise ValueError(f'prepared operands map {ops.cin} -> {ops.cout} '
                         f'channels, x has {c}')
    return launch_conv(prepare_conv(x, ops, 2))


def conv3x3_bias(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """The bare conv: (B, H, W, Cin) -> (B, H, W, Cout), as
    conv3x3_bias_ref. On CUDA: bf16 x, Cin a multiple of 32, Cout a
    multiple of 32 or 3; the sums are fp32 and the bias is added in fp32
    before the one rounding to bf16."""
    if x.device.type == 'cpu':
        return conv3x3_bias_ref(x, weight, bias)
    _refuse_autograd('conv3x3_bias', x, weight, bias)
    _need_cuda(x)
    cin = x.shape[-1]
    cout = weight.shape[0]
    if weight.shape != (cout, cin, 3, 3) or bias.shape != (cout,):
        raise ValueError(f'weight {tuple(weight.shape)} / bias '
                         f'{tuple(bias.shape)} do not match Cin={cin}')
    if cout % CHUNK and cout != 3:
        raise ValueError(f'Cout={cout} must be a multiple of {CHUNK} or 3')
    return launch_conv(prepare_conv(x, conv_operands(weight, bias), 1))


# ------------------------------------------------------ the dense conv
def _strided_ld(name: str, t: torch.Tensor) -> int:
    """The pixel stride, in channels, of a (B, H, W, C) bf16 view whose
    channels are consecutive and whose pixels lie ld apart in one buffer
    (a channel prefix or slice of a wider NHWC tensor); raises on any
    other layout."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f'{name}: the kernel takes bfloat16, got {t.dtype}')
    if t.dim() != 4:
        raise ValueError(f'{name}: need a (B, H, W, C) view, got shape '
                         f'{tuple(t.shape)}')
    bsz, h, w, c = t.shape
    ld = t.stride(2)
    if t.stride(3) != 1 or ld < c or ld % 8 or c % CHUNK \
            or (h > 1 and t.stride(1) != w * ld) \
            or (bsz > 1 and t.stride(0) != h * w * ld) or t.data_ptr() % 16:
        raise ValueError(f'{name}: need {CHUNK}k consecutive channels of '
                         f'16-byte aligned pixels ld (a multiple of 8) '
                         f'apart, got shape {tuple(t.shape)} strides '
                         f'{t.stride()}')
    return ld


class DenseLaunch(NamedTuple):
    """Everything one launch of the dense conv needs."""
    x: torch.Tensor                # the channel prefix read
    ops: ConvOperands
    plan: ConvPlan
    out: torch.Tensor              # the channel slice written
    s1: Optional[torch.Tensor]
    s2: Optional[torch.Tensor]
    ws: Optional[torch.Tensor]     # fp32 partials of a split
    lds: Tuple[int, int, int, int]     # pixel strides of x, out, s1, s2
    epi: int                       # index into EPIS


def prepare_dense(x: torch.Tensor, ops: ConvOperands, out: torch.Tensor,
                  epi: str, s1: Optional[torch.Tensor] = None,
                  s2: Optional[torch.Tensor] = None) -> DenseLaunch:
    """The dense conv's checks against the operands, its plan and a
    split's partials."""
    if epi not in EPIS:
        raise ValueError(f'epi must be one of {EPIS}, got {epi!r}')
    bsz, h, w, cin = x.shape
    if cin != ops.cin:
        raise ValueError(f'x has {cin} channels, the weight {ops.cin}')
    if out.shape != (bsz, h, w, ops.cout):
        raise ValueError(f'out {tuple(out.shape)} is not '
                         f'{(bsz, h, w, ops.cout)}')
    if (s1 is None) != (epi == 'lrelu') or (s2 is None) != (epi != 'rrdb'):
        raise ValueError(f'epi {epi!r} takes '
                         f'{ {"lrelu": 0, "rrdb": 2}.get(epi, 1)} skip(s)')
    lds = [_strided_ld('x', x), _strided_ld('out', out), 0, 0]
    for i, (name, t) in enumerate((('s1', s1), ('s2', s2))):
        if t is not None:
            if t.shape != out.shape:
                raise ValueError(f'{name} {tuple(t.shape)} is not '
                                 f'{tuple(out.shape)}')
            lds[2 + i] = _strided_ld(name, t)
    _check_params(x, ops.weight, ops.bias, out, s1, s2)
    plan = conv_plan(bsz, h, w, cin, ops.cout, 1,
                     _num_sms(x.device.index or 0), dense=True)
    ws = None
    if plan.split > 1:
        ws = torch.empty((plan.split, bsz * h * w, plan.coutp),
                         dtype=torch.float32, device=x.device)
    return DenseLaunch(x, ops, plan, out, s1, s2, ws, tuple(lds),
                       EPIS.index(epi))


def launch_dense(c: DenseLaunch) -> torch.Tensor:
    """Launch the dense conv on prepared operands; returns c.out."""
    if c.out.numel() == 0:
        return c.out
    p, (bsz, h, w, cin) = c.plan, c.x.shape
    launch('conv3x3_dense',
           c.x.data_ptr(), c.ops.weight.data_ptr(), c.ops.bias.data_ptr(),
           c.out.data_ptr(), c.s1.data_ptr() if c.s1 is not None else None,
           c.s2.data_ptr() if c.s2 is not None else None,
           c.ws.data_ptr() if c.ws is not None else None,
           bsz, h, w, cin, c.lds[0], c.ops.cout, p.coutp, c.lds[1], c.lds[2],
           c.lds[3], c.epi, p.bn, p.mb, p.split, p.stages, p.smem, p.grid_x,
           on=c.x)
    return c.out


def conv3x3_dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  out: torch.Tensor, epi: str,
                  s1: Optional[torch.Tensor] = None,
                  s2: Optional[torch.Tensor] = None,
                  prepared: Optional[ConvOperands] = None) -> torch.Tensor:
    """The dense conv, as conv3x3_dense_ref: writes out = epi(conv3x3(x) +
    bias, s1, s2) in place and returns it. On CUDA: bf16 views whose
    channels are consecutive, x a prefix of 32k channels, out a slice of
    32k, s1 and s2 of out's shape; the sums and the epilogue in fp32, one
    rounding. `prepared`: conv_operands(weight, bias) kept by the caller
    (RRDBNet keeps its trunk's), else made here."""
    if x.device.type == 'cpu':
        return conv3x3_dense_ref(x, weight, bias, out, epi, s1, s2)
    _refuse_autograd('conv3x3_dense', x, weight, bias, s1, s2)
    _need_cuda(x)
    ops = prepared if prepared is not None else conv_operands(weight, bias)
    if (ops.cout, ops.cin) != tuple(weight.shape[:2]):
        raise ValueError('the prepared operands do not match the weights')
    return launch_dense(prepare_dense(x, ops, out, epi, s1, s2))

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (codeformer_tpu_torch).

    python3 chip_smoke.py            # one GPU; a few minutes on an H100
    python3 chip_smoke.py --profile  # plus torch.profiler breakdowns of a
                                     # serving forward, the whole-image
                                     # path and a training step

Phases, in order; any failure raises and the script exits non-zero:
  1. card and versions (needs a CUDA card of compute capability 9.0);
  2. build the hand-written kernels from codeformer_tpu_torch/csrc/;
  3. K1/K2 against their plain PyTorch versions at the serving path's
     shapes (B=2, bf16 inputs; reference in fp32 with TF32 off; K1 also
     at B=1 and B=8 on its largest and its widest map, K2 at a ragged
     map and the serving batch), K1's GroupNorm partials slot by slot
     against the exact sums of its rounded output, planted faults that
     the bounds must reject, each shape's plan and bound, and kernel
     (the launch on prepared operands), whole-call, plain and library
     times (for K1 the library call is a cuDNN conv of the same shape,
     the conv alone);
  4. K3 (nearest code) against its plain version at the token counts of
     stage II and latent-GT generation, on four codebooks (K = 1024 and
     512; exact lowest index on duplicated rows), z in fp32 and bf16, a
     call after an in-place change of the codebook, planted faults that
     must fail at every T, one device activity a call on a kept codebook
     (torch.profiler), kernel, whole-call, plain and fp32-product times;
  4b. the ops layer: K4 (fused_leaky_relu forward and backward) and the
     bare conv conv3x3_bias (the counterpart of K1', K5, K6) against
     their plain versions, planted faults that must fail, gradients and
     gradients of gradients through the K4 kernels against the plain
     path, kernel, plain and library-call times; then the ops path (conv3x3_bias ->
     fused_leaky_relu forward and backward at 16 x 512^2 x 64 bf16) with
     exact launch counts;
  5. serving: the full-width CodeFormerRestorer on the card with seeded
     random weights: a few requests, exact kernel launch counts, a
     reference forward with both ops patched to their plain versions
     (and with planted faults, which must fall outside the bounds), and
     faces/s of the kernel path and of the plain path over multi-second
     windows;
  5b. the whole-image path (DeviceRestorePipeline: RetinaFace resnet50
     and ParseNet in bf16, the serving restorer) on 32 seeded frames of
     512x683 in chunks of 16, upscale 2, as bench.py's end-to-end
     workload: the bf16 detector against fp32 on one chunk (and a shifted
     anchor level, which must fail); the pipeline with K1/K2 on their
     kernels against their plain versions (frames inside the face windows
     within a bound, bit-identical outside, the restored crops equal to
     restore_device on the same crops, every K1/K2 call on the crops'
     own activations within the per-call bound, a planted K1 halo fault
     failing it); exact launch counts a chunk at 1 and 4 faces a frame
     (the detections handed on are injected at bench.py's offsets while
     the detector's device graph runs on every chunk); frames/s at 1 and
     4 faces a frame and in folder mode, kernel and plain paths in
     alternating windows; peak memory; with --profile the device time of
     each stage and the busy share;
  5c. the classic per-stage path's device stages (a 512x683 frame, canvas
     1024x1366, 1 and 4 faces at bench.py's offsets): the crops through
     restore_batch with exact launch counts, `_parse_masks` in fp32
     against a CPU copy, `paste_faces` with use_parse and draw_box on and
     off against the same call on CPU copies (inside the face windows
     within a bound, outside bit-identical to the canvas; an inverse
     affine shifted by one pixel must fail), ms a frame and peak memory;
  5d. the colorization and inpainting models (codebook 1024 / 512,
     connect 32/64/128, w=0 with AdaIN / w=1 without) at full width:
     exact launch counts through restore_batch, inpainting's white-mask
     composite keeping every other pixel, the whole forward against the
     plain path with the codes held, every K1/K2 call of one forward on
     its own activations, a planted K1 halo fault failing both checks,
     faces/s at B=1 and 8;
  5e. VQAutoEncoder.forward at full width, B=2: exact launches (K1, K2,
     one K3), the reconstruction against the plain path with the codes
     held, one device activity for its K3 call (checked at the end);
  6. training: stage II (CodeFormerIdxModel) at the full width of
     options/CodeFormer_stage2.yml, bf16, B=4: 8 steps with exact launch
     counts (K1/K2/K3 in the frozen HQ encode only), a falling loss,
     gradients at the encoder, frozen modules unchanged; idx_gt against
     the plain-op encode (and a planted fault); training faces/s of the
     kernel and plain paths; peak memory.
Every time is per launch: runs of back-to-back launches between two
CUDA events (`time_ms`), the median run. The last line is the JSON
result; the line before it lists the kernels, each with its launches on
the main paths, its time (the launch on prepared operands; the whole
call's time, `call_ms`, is printed on an earlier line), its plain version's,
the least time the card could take for the same work (bound_ms) and,
where one PyTorch call computes the same function, that call's time.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Bounds, each a few times the largest sound reading on an H100 (PERF.md,
# Findings PR 1), each checked against planted faults that must FAIL it.
# Kernel vs plain version: both round act(a*x+b), the weights and y to
# bf16 and sum in fp32, so they differ only where summation order or
# __expf flips a rounding: rel RMS up to 1.92e-4 over 34 shapes. A bf16
# prologue reads >= 3.0e-3 and a halo of act(b) >= 5.7e-3. The same
# bound holds every kernel call of one forward on its own inputs.
REL_RMS_BOUND = 1e-3
# K1's statistics slot by slot against the exact sums of its own rounded
# y over the slot's tile (128 or 256 pixels), relative to sum |y| and sum
# y^2: fp32 sums of at most 256 terms stay near 1e-7, while the
# statistics of the y before its rounding (half a bf16 ulp a term, random
# signs) are off by several times the bound in the worst slot of every
# call (PERF.md, Findings)
STATS_BOUND = 1e-4
# whole model, kernel path vs plain-op reference forward: lq_feat and
# logits rel RMS read 0.0089 and 0.011 (rounding flips compound over 60
# convs), code-index agreement 0.9746 (random weights give 1024 close
# logits a token, so a few argmax picks flip; trained weights are peaked),
# mean image difference 1.24 levels. A halo of act(b) reads 3.14 levels.
SLICE_REL_BOUND = 2e-2
INDEX_AGREEMENT_FLOOR = 0.95
IMAGE_DIFF_BOUND = 2.5    # uint8 levels, mean |diff| of the restored images
# random-weight SFT branches are scaled down so activations stay finite
# (see tame_sft); the restored image must then be far from constant
SFT_SCALE = 1e-2
MIN_IMAGE_STD = 5.0       # uint8 levels
# throughput windows: each at least this long, repeated per path
RATE_WINDOW_S = 3.0
RATE_REPEATS = 3

# every (resolution, Cin, Cout, act, skip) a full-width forward gives K1:
# a ResBlock(cin, cout) runs conv1 cin->cout without skip and conv2
# cout->cout with the identity or the projected (Cs = cin) skip; the
# decoder tail is 64->3 without activation
K1_SHAPES = [  # (H=W, Cin, Cout, act, skip, Cs)
    (512, 64, 64, 'silu', 'identity', 0),
    (512, 64, 64, 'silu', 'none', 0),
    (512, 64, 64, 'silu', 'proj', 128),
    (512, 128, 64, 'silu', 'none', 0),
    (512, 64, 3, 'none', 'none', 0),
    (256, 64, 128, 'silu', 'none', 0),
    (256, 128, 128, 'silu', 'identity', 0),
    (256, 128, 128, 'silu', 'none', 0),
    (256, 128, 128, 'silu', 'proj', 64),
    (256, 128, 128, 'silu', 'proj', 256),
    (256, 256, 128, 'silu', 'none', 0),
    (128, 128, 128, 'silu', 'identity', 0),
    (128, 128, 128, 'silu', 'none', 0),
    (128, 128, 128, 'silu', 'proj', 256),
    (128, 256, 128, 'silu', 'none', 0),
    (64, 128, 256, 'silu', 'none', 0),
    (64, 256, 256, 'silu', 'identity', 0),
    (64, 256, 256, 'silu', 'none', 0),
    (64, 256, 256, 'silu', 'proj', 128),
    (64, 256, 256, 'silu', 'proj', 512),
    (64, 512, 256, 'silu', 'none', 0),
    (32, 256, 256, 'silu', 'identity', 0),
    (32, 256, 256, 'silu', 'none', 0),
    (32, 256, 256, 'silu', 'proj', 512),
    (32, 512, 256, 'silu', 'none', 0),
    (16, 256, 512, 'silu', 'none', 0),
    (16, 512, 512, 'silu', 'identity', 0),
    (16, 512, 512, 'silu', 'none', 0),
    (16, 512, 512, 'silu', 'proj', 256),
]
BATCH = 2
# (B, H=W, Cin, Cout, act, skip, Cs): every shape at the forward's B=2,
# then the largest and the widest map at B = 1 and the serving batch 8
K1_CASES = [(BATCH, *c) for c in K1_SHAPES] + [
    (bsz, *c) for bsz in (1, 8) for c in (K1_SHAPES[0], K1_SHAPES[-1])]
K2_CASES = [  # (B, H=W, C): the forward's five at B=2, a map ragged
    # against the tile, and the serving batch
    (BATCH, 512, 64), (BATCH, 256, 128), (BATCH, 128, 128), (BATCH, 64, 256),
    (BATCH, 32, 256), (BATCH, 72, 128), (8, 512, 64)]


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class Timing(float):
    """A per-launch time in ms (the median run), with the runs' spread."""

    def __new__(cls, runs):
        t = super().__new__(cls, statistics.median(runs))
        t.lo, t.hi = min(runs), max(runs)
        return t

    def spread(self) -> str:
        return f'[{self.lo:.4f}, {self.hi:.4f}]'


def time_ms(fn, iters: int = 20, runs: int = 5, warmup: int = 3) -> Timing:
    """Per-launch CUDA-event time of fn() in ms: `runs` runs of `iters`
    back-to-back calls, one event pair around each run, the elapsed time
    over `iters`; the median run, with the spread. One pair around a
    single small call times the host's launch work, not the card.
    Back-to-back calls at the small shapes find their inputs in L2, as
    on the main path, where the previous layer has just written them."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return Timing(times)


def rel_rms(got: torch.Tensor, ref: torch.Tensor) -> float:
    d = (got.float() - ref.float()).pow(2).mean().sqrt()
    return float(d / ref.float().pow(2).mean().sqrt().clamp_min(1e-12))


def k1_fault(kind: str):
    """A deliberately wrong plain K1 with conv3x3_dots_ref's signature, as
    a control the bounds must catch. It returns (y, stats), the stats in
    the kernel's slot layout for a tile of `th` rows (`th=None`: one slot
    an image, as the plain version):
      'bf16 prologue'       a*x+b and the activation in bf16 arithmetic;
      'halo act(b)'         the activated map padded with act(b), not 0
                            (TMA's zero fill, activated without masking);
      'chunk unrewritten'   the last 64-channel chunk's windows read as
                            staged: raw x, the prologue skipped;
      'prologue on skip'    the projected skip's raw chunks rewritten as
                            if they were x's: bf16(act(a*s+b)), with the
                            a, b of channel (k mod Cin);
      'skip dropped'        no skip added;
      'stats of unrounded y' the right y, the statistics of the fp32 sum
                            before its rounding.
    None where the fault has nothing to act on (no skip, no projection)."""
    import torch.nn.functional as F
    from codeformer_tpu_torch.ops import conv3x3 as cv

    def run(x, a, b, act, weight, bias, skip=None, w1x1=None, th=None):
        if (kind == 'skip dropped' and skip is None) or \
                (kind == 'prologue on skip' and w1x1 is None):
            return None

        def f(t):
            return F.silu(t) if act == 'silu' else t
        a4, b4 = a[:, None, None], b[:, None, None]
        dt = x.dtype
        if kind == 'bf16 prologue':
            h = f(x * a4.to(dt) + b4.to(dt)).float()
        else:
            h = f(x.float() * a4 + b4).to(dt).float()
        if kind == 'chunk unrewritten':
            lo = (x.shape[-1] - 1) // cv.SM90_KC * cv.SM90_KC
            h[..., lo:] = x[..., lo:].float()
        h = F.pad(h.permute(0, 3, 1, 2), (1, 1, 1, 1))
        if kind == 'halo act(b)':
            inner = h[:, :, 1:-1, 1:-1].clone()
            h = f(b).to(dt).float()[:, :, None, None].expand_as(h).clone()
            h[:, :, 1:-1, 1:-1] = inner
        y = F.conv2d(h, weight.to(dt).float(), bias.float())
        y = y.permute(0, 2, 3, 1)
        if skip is not None and kind != 'skip dropped':
            s = skip.float()
            if w1x1 is not None:
                if kind == 'prologue on skip':
                    k = torch.arange(s.shape[-1], device=s.device) % a.shape[1]
                    s = f(s * a[:, None, None, k] + b[:, None, None, k]) \
                        .to(dt).float()
                s = s @ w1x1.reshape(w1x1.shape[0], -1).to(dt).float().t()
            y = y + s
        yr = y.to(dt)
        st = k1_slot_sums(y if kind == 'stats of unrounded y' else yr, th)[0]
        return yr, st.float()
    return run


def k1_slot_sums(y: torch.Tensor, th=None):
    """([sum y, sum y^2], [sum |y|, sum y^2]) in fp64 over each tile of th
    x 16 pixels (the kernel's statistics slots, ops/conv3x3.py
    stats_slots), or over each image (th None): (B, slots, 2, C) each."""
    import torch.nn.functional as F
    bsz, h, w, c = y.shape
    th, tw = (th, 16) if th else (h, w)
    ty, tx = -(-h // th), -(-w // tw)
    v = F.pad(y.double(), (0, 0, 0, tx * tw - w, 0, ty * th - h)) \
        .reshape(bsz, ty, th, tx, tw, c)
    s1, s2, s_abs = (t.sum((2, 4)).reshape(bsz, ty * tx, c)
                     for t in (v, v.square(), v.abs()))
    return torch.stack([s1, s2], 2), torch.stack([s_abs, s2], 2)


def k1_stats_err(st: torch.Tensor, y: torch.Tensor, th: int) -> float:
    """The worst statistics slot and channel: |stats - the exact (fp64)
    sums of the rounded y over the slot's tile| relative to sum |y| (for
    the sum) or sum y^2 (for the sum of squares)."""
    exact, scale = k1_slot_sums(y, th)
    return float(((st.double() - exact).abs()
                  / scale.clamp_min(1e-30)).max())


def k2_fault(x, weight, bias):
    """A deliberately wrong plain K2: PyTorch's symmetric padding=1 in
    place of the reference's (0,1,0,1)."""
    import torch.nn.functional as F
    y = F.conv2d(x.float().permute(0, 3, 1, 2), weight.to(x.dtype).float(),
                 bias.float(), stride=2, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def k2_planted(kind: str):
    """Planted faults of K2, each with downsample_dots_ref's signature:
    'symmetric pad' (k2_fault); 'pad top-left', the zero row and column
    on the top and left instead of the bottom and right; 'tap off by one',
    the centre tap reads (2y+1, 2x+2) instead of (2y+1, 2x+1);
    'split partial dropped', the fp32 partial of the plan's last split
    left out of the sum (None where the plan does not split)."""
    import torch.nn.functional as F
    from codeformer_tpu_torch.ops import conv3x3 as cv

    def run(x, weight, bias):
        xn = x.float().permute(0, 3, 1, 2)
        wf, bf = weight.to(x.dtype).float(), bias.float()
        if kind == 'symmetric pad':
            return k2_fault(x, weight, bias)
        if kind == 'pad top-left':
            y = F.conv2d(F.pad(xn, (1, 0, 1, 0)), wf, bf, stride=2)
        elif kind == 'tap off by one':
            centre = torch.zeros_like(wf)
            centre[:, :, 1, 1] = wf[:, :, 1, 1]
            shifted = F.pad(xn[..., 1:], (0, 2, 0, 1))
            y = F.conv2d(F.pad(xn, (0, 1, 0, 1)), wf - centre, bf, stride=2) \
                + F.conv2d(shifted, centre, stride=2)
        elif kind == 'split partial dropped':
            p = cv.conv_plan(*x.shape, x.shape[-1], 2)
            if p.split == 1:
                return None
            lo = (p.split - 1) * (p.chunks // p.split) * cv.SM90_KC
            xd = x.clone()
            xd[..., lo:] = 0
            return cv.downsample_dots_ref(xd, weight, bias)
        else:
            raise ValueError(kind)
        return y.permute(0, 2, 3, 1).to(x.dtype)
    return run


def takes_prepared(fn):
    """fn as a stand-in for cv.conv3x3_dots or cv.downsample_dots, whose
    callers may hand them kept operands (`prepared`): fn ignores them."""
    def run(*args, prepared=None, **kw):
        return fn(*args, **kw)
    return run


K1_FAULTS = ('bf16 prologue', 'halo act(b)', 'chunk unrewritten',
             'prologue on skip', 'skip dropped', 'stats of unrounded y')
# the faults the per-call check of a whole forward runs
K1_MODEL_FAULTS = ('bf16 prologue', 'halo act(b)')
K2_FAULTS = ('symmetric pad', 'pad top-left', 'tap off by one',
             'split partial dropped')

# K3 (nearest code): tokens at the stage-II shape (B*256 for B = 1, 4,
# 16), generate_latent_gt at its default batch of 8 (2048) and a large
# run; D of every shipped config; K = 1024 (restoration, colorization,
# stage II) and 512 (the inpainting codebook)
K3_TOKENS = (256, 1024, 2048, 4096, 16384)
K3_DIM, K3_CODES = 256, 1024
K3_PATH_TOKENS = 1024     # stage II at batch_size_per_gpu 4
# Kernel and plain version sum the same fp32 products in other orders, so
# they may pick different codes only where two distances are within fp32
# rounding. Every disagreement must pick a code whose exact (fp64)
# squared distance is within this relative margin of the exact minimum.
K3_MARGIN = 1e-5
K3_FAULTS = ('ties to the highest index', 'e_sq dropped',
             'a cluster rank dropped', 'stale cache')


def k3_fault(kind: str):
    """A deliberately wrong plain K3 with nearest_code_indices' signature,
    as a control the K3 checks must catch."""
    from codeformer_tpu_torch.ops import vq

    def run(z, e):
        z = z.float()
        with vq._fp32_matmul():
            dot = z @ e.t()
        d = e.square().sum(1)[None] - 2.0 * dot
        if kind == 'ties to the highest index':
            return e.shape[0] - 1 - d.flip(1).argmin(1)
        if kind == 'e_sq dropped':
            return (-2.0 * dot).argmin(1)
        if kind == 'a cluster rank dropped':
            # the codes of the last rank of the kernel's cluster never
            # reach rank 0 (with a cluster of 1, those of a second rank)
            cs = max(2, vq.prepare_nearest_code(z, e).plan.cluster)
            tile = torch.arange(e.shape[0], device=e.device) \
                // vq.K3_CODES_PER_TILE
            lost = tile % cs == cs - 1
            return d.masked_fill(lost[None], float('inf')).argmin(1)
        raise ValueError(kind)
    return run


def k3_after_change(z, e, stale: bool):
    """K3 on a copy of e, then again after the copy is negated in place
    (as an optimizer step would update it): (second result, the changed
    codebook). With `stale` the operand cache's key leaves out the
    tensor's version, so the second call reads the kept operands of the
    old codebook: a fault the check on the new one must catch."""
    from codeformer_tpu_torch.ops import vq
    e = e.clone()
    key = (lambda c: (c.data_ptr(), c.device, c.dtype, tuple(c.shape))) \
        if stale else vq.codebook_key
    with mock.patch.object(vq, 'codebook_key', key):
        vq.nearest_code_indices(z, e)
        e.mul_(-1.0)
        return vq.nearest_code_indices(z, e), e


def k3_codebooks(g):
    """{name: (K, D) fp32}: the init scale (uniform +-1/K, the random-init
    codebook of the training path), a unit-scale one, one whose 1024 rows
    are 256 distinct rows each repeated 4 times at scattered places (exact
    ties), and the inpainting config's K = 512 at unit scale."""
    k, d = K3_CODES, K3_DIM
    base = torch.randn(k // 4, d, generator=g, device='cuda')
    dup_of = torch.randperm(k, generator=g, device='cuda') % (k // 4)
    return {'init scale': (torch.rand(k, d, generator=g, device='cuda')
                           * 2 - 1) / k,
            'unit scale': torch.randn(k, d, generator=g, device='cuda'),
            'duplicated rows': base[dup_of].contiguous(),
            'K=512': torch.randn(512, d, generator=g, device='cuda')}, dup_of


def k3_verdict(got, ref, z, e, dup_of=None) -> dict:
    """Hold indices `got` against the plain version's `ref`: agreement,
    the worst relative fp64 gap of a disagreement (must be <= K3_MARGIN),
    the largest absolute fp64 distance gap, and, on a codebook with
    duplicated rows, whether every pick is the lowest index of its row."""
    z64, e64 = z.double(), e.double()
    dist = (z64.square().sum(1, keepdim=True) + e64.square().sum(1)[None]
            - 2.0 * z64 @ e64.t())
    dmin = dist.min(1).values
    d_got = dist.gather(1, got[:, None])[:, 0]
    d_ref = dist.gather(1, ref[:, None])[:, 0]
    off = got != ref
    gap = (d_got - dmin) / dmin.abs().clamp_min(1e-30)
    r = dict(agree=float((~off).float().mean()),
             worst_gap=float(gap[off].max()) if bool(off.any()) else 0.0,
             max_abs=float((d_got - d_ref).abs().max()), lowest=True)
    if dup_of is not None:
        first = torch.full((int(dup_of.max()) + 1,), e.shape[0],
                           device=e.device, dtype=torch.int64)
        first.scatter_reduce_(0, dup_of, torch.arange(
            e.shape[0], device=e.device), reduce='amin')
        r['lowest'] = bool((got == first[dup_of[got]]).all())
    r['ok'] = r['worst_gap'] <= K3_MARGIN and r['lowest']
    return r


def device_launches(fn, name: str = 'nearest_code', iters: int = 20):
    """(device activities a launch of the kernel whose name holds `name`,
    ms a launch of it) of fn() from torch.profiler over `iters` calls
    after a warm-up: kernels, copies and sets, each counted, over the
    kernel's own launches. A profiler session after an earlier one in the
    same process may miss the first few calls, so the count is taken per
    launch seen, not per call made."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type != torch.autograd.DeviceType.CPU]
    seen = sum(e.count for e in rows if name in e.key)
    if not seen:
        raise SystemExit(f'chip_smoke: the profiler saw no {name} launch')
    return (sum(e.count for e in rows) / seen,
            sum(e.device_time_total for e in rows if name in e.key)
            / seen / 1e3)


def phase_k3():
    """K3 against its plain version (fp32, TF32 off) at the token counts
    of K3_TOKENS on four codebooks, with z in fp32 and in bf16; the
    operand cache after an in-place change; planted faults that must fail
    at every T; the launch on a prepared call, the whole call, the plain
    version and the fp32 product alone (TF32 off) timed with CUDA events.
    Returns the rows of the init-scale codebook and the timed calls, whose
    device activities `phase_k3_activities` counts after the main paths
    (a profiler session leaves the host's launches slower for the rest
    of the process, and the serving and training rates are host-bound)."""
    from codeformer_tpu_torch.ops import vq
    g = torch.Generator(device='cuda').manual_seed(3)
    books, dup_of = k3_codebooks(g)
    print(f'K3 checks ({card_line()}): D={K3_DIM}, K={K3_CODES} and 512, z ~ '
          f'N(0, 1) in fp32 and bf16; ref = plain version (fp32, TF32 off) '
          f'on the same z; a disagreement must be within {K3_MARGIN} of the '
          f'exact (fp64) minimum distance; on duplicated rows every pick '
          f'must be the lowest index; after an in-place change the next '
          f'call must match the plain version on the new codebook',
          flush=True)
    rows, calls = [], []
    caught = {k: set() for k in K3_FAULTS}
    for n_tok in K3_TOKENS:
        z = torch.randn(n_tok, K3_DIM, generator=g, device='cuda')
        for name, e in books.items():
            dup = dup_of if name == 'duplicated rows' else None
            max_abs = 0.0
            for zname, zz in (('fp32', z), ('bf16', z.bfloat16())):
                got = vq.nearest_code_indices(zz, e)
                torch.cuda.synchronize()
                ref = vq._nearest_code_ref(zz, e)
                r = k3_verdict(got, ref, zz.float(), e, dup)
                max_abs = max(max_abs, r['max_abs'])
                print(f'  K3 T={n_tok:5d} K={e.shape[0]:4d} {name:15s} z '
                      f'{zname}: agreement {r["agree"]:.6f}, worst '
                      f'disagreement gap {r["worst_gap"]:.3g} (<= '
                      f'{K3_MARGIN}), max abs distance gap '
                      f'{r["max_abs"]:.3g}, lowest index on ties '
                      f'{r["lowest"]}: {"ok" if r["ok"] else "FAIL"}',
                      flush=True)
                if not r['ok']:
                    raise SystemExit(f'chip_smoke: K3 T={n_tok} {name} z '
                                     f'{zname} disagrees with its plain '
                                     f'version')
            ref = vq._nearest_code_ref(z, e)
            faults = {k: k3_verdict(k3_fault(k)(z, e), ref, z, e, dup)['ok']
                      for k in K3_FAULTS if k != 'stale cache'}
            new = {}
            for stale in (False, True):
                got, e2 = k3_after_change(z, e, stale)
                new[stale] = k3_verdict(got, vq._nearest_code_ref(z, e2), z,
                                        e2, dup)['ok']
            faults['stale cache'] = new[True]
            print(f'    after an in-place change: '
                  f'{"ok" if new[False] else "FAIL"}; planted faults: '
                  + ', '.join(f'{k} {"passes" if v else "fails"}'
                              for k, v in faults.items()), flush=True)
            if not new[False]:
                raise SystemExit(f'chip_smoke: K3 T={n_tok} {name}: a call '
                                 f'after an in-place change of the codebook '
                                 f'disagrees with the plain version on it')
            for k, v in faults.items():
                if not v:
                    caught[k].add(n_tok)
            if name not in ('init scale', 'K=512'):
                continue
            n_codes = e.shape[0]
            prep = vq.prepare_nearest_code(z, e)
            prep_bf16 = vq.prepare_nearest_code(z.bfloat16(), e)
            ms = time_ms(lambda: vq.launch_nearest_code(prep))
            bf16_ms = time_ms(lambda: vq.launch_nearest_code(prep_bf16))
            cms = time_ms(lambda: vq.nearest_code_indices(z, e))
            pms = time_ms(lambda: vq._nearest_code_ref(z, e))
            with vq._fp32_matmul():
                gms = time_ms(lambda: torch.mm(z, e.t()))
            lim = bound(2 * n_tok * n_codes * K3_DIM,
                        4 * (n_tok + n_codes) * K3_DIM + 8 * n_tok,
                        FP32_FLOPS)
            p = prep.plan
            print(f'    kernel {ms:.4f} ms {ms.spread()} '
                  f'({100 * lim["bound_ms"] / ms:.1f}% of the '
                  f'{lim["bound_ms"]:.4f} ms fp32 bound; {p.tok_tiles} x '
                  f'{p.cluster} blocks in clusters of {p.cluster}), z bf16 '
                  f'{bf16_ms:.4f}, whole call {cms:.4f}, plain {pms:.4f}, '
                  f'fp32 product alone (gemm_library_ms, not the same '
                  f'function) {gms:.4f}', flush=True)
            row = dict(tokens=n_tok, codes=n_codes, max_abs_err=max_abs,
                       ms=ms, call_ms=cms, plain_ms=pms, library_ms=None,
                       gemm_library_ms=gms, bf16_ms=bf16_ms, **lim)
            calls.append((row, z, e))
            if name == 'init scale':
                rows.append(row)
    for k in K3_FAULTS:
        if caught[k] != set(K3_TOKENS):
            raise SystemExit(f'chip_smoke: the K3 checks let the planted '
                             f'fault "{k}" pass at T = '
                             f'{sorted(set(K3_TOKENS) - caught[k])}')
    print('  K3 planted faults fail the checks at every T, as they must',
          flush=True)
    return rows, calls


def phase_k3_activities(calls) -> None:
    """Device activities a K3 call on a kept codebook takes (torch.profiler,
    per launch of the kernel; must be 1: the kernel, no memset, copy or
    second pass) and the kernel's device time, for each timed call of
    phase_k3; both go into its row."""
    from codeformer_tpu_torch.ops import vq
    for row, z, e in calls:
        acts, dev_ms = device_launches(lambda: vq.nearest_code_indices(z, e))
        row.update(launches_per_call=acts, device_ms=dev_ms)
        print(f'  K3 T={row["tokens"]:5d} K={row["codes"]:4d}: device '
              f'activities a call on a kept codebook {acts:g}, kernel '
              f'device time (profiler) {dev_ms:.4f} ms', flush=True)
        if acts != 1:
            raise SystemExit(f'chip_smoke: a K3 call on a kept codebook ran '
                             f'{acts:g} device activities, not 1')


# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet,
# dense): the least time for a kernel's work is the larger of its bytes
# (each input read once, each output written once) over HBM bandwidth and
# its operations over the peak rate of their type.
HBM_BYTES_S = 3.35e12
BF16_TC_FLOPS = 989e12    # tensor cores, bf16
FP32_FLOPS = 67e12        # fp32 outside the tensor cores


def bound(flops: float, nbytes: float, peak: float) -> dict:
    """{'bound_ms', 'bound_by'}: max(bytes / HBM, flops / peak) in ms."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return {'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}


def k1_bound(b, h, cin, cout, skip, cs, slots) -> dict:
    """K1 at B x h^2: x, skip and y once in bf16, the weights, a, b and
    the statistics (`slots` an image, ops/conv3x3.py stats_slots) once;
    the 3x3 (and 1x1) products on the tensor cores."""
    pix = b * h * h
    flops = 2 * pix * 9 * cin * cout
    nbytes = 2 * pix * (cin + cout) + 2 * 9 * cin * cout + 8 * b * cin \
        + 4 * cout + 8 * b * cout * slots
    if skip == 'identity':
        nbytes += 2 * pix * cout
    elif skip == 'proj':
        nbytes += 2 * pix * cs + 2 * cs * cout
        flops += 2 * pix * cs * cout
    return bound(flops, nbytes, BF16_TC_FLOPS)


# the ops layer (the counterpart of the reference's basicsr/ops): K4 and
# the bare 3x3 conv that stands for K1', K5 and K6. The path drives one
# StyleGAN2-style layer at K6's bench shape (scripts/bench_imgpair.py):
# conv3x3_bias, then fused_leaky_relu forward and backward on its output.
OPS_PATH_SHAPE = (16, 512, 512, 64)
# K4: the path's shape, a memory-bound size a quarter of it, a numel
# that is no multiple of the vector width with C = 3, and C = 513 (more
# vector classes than a block has threads); each in bf16 and fp32
K4_SHAPES = (OPS_PATH_SHAPE, (16, 256, 256, 64), (3, 37, 41, 3),
             (2, 33, 35, 513))
# dbias against the exact (fp64) sum of the rounded dx, relative to the
# sum of |dx| of the channel: the kernel's and torch's fp32 sums both read
# 1e-8 or less on an H100 (PERF.md, Findings)
DBIAS_BOUND = 1e-5
CONV_BIAS_CASES = [  # (B, H=W, Cin, Cout)
    (16, 512, 64, 64),    # K6's bench shape (the path's)
    (2, 512, 64, 64),     # K5's thin layers
    (2, 256, 64, 64),
    (2, 256, 128, 128),   # K1'
    (3, 128, 64, 64),     # an odd batch
    (2, 512, 64, 3),      # Cout = 3
    (2, 100, 96, 64),     # a ragged map, Cin % 64 == 32
]
OPS_ITERS = 10            # timing iterations of the ops phase


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |v| (8 significant bits), as fp32."""
    e = torch.floor(torch.log2(v.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def fwd_agrees(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """fp32: bitwise equal; bf16: within one bf16 ulp."""
    if got.dtype != torch.bfloat16:
        return bool(torch.equal(got, ref))
    return bool(((got.float() - ref.float()).abs()
                 <= bf16_ulp(ref)).all())


def dbias_err(db: torch.Tensor, dx: torch.Tensor) -> float:
    """max over channels of |db - exact| / sum |dx|, exact = the fp64 sum
    of the rounded dx."""
    d64 = dx.double().reshape(-1, dx.shape[-1])
    exact = d64.sum(0)
    return float(((db.double() - exact).abs()
                  / d64.abs().sum(0).clamp_min(1e-30)).max())


def k4_fault_fwd(x, bias, slope=0.2, scale=2 ** 0.5):
    """Planted fault: the branch taken from x, not from x + bias."""
    y = x.float() + bias.to(x.dtype).float()
    return (torch.where(x >= 0, y, y * slope) * scale).to(x.dtype)


def k4_fault_dbias(dx: torch.Tensor) -> torch.Tensor:
    """Planted fault: dbias without the elements after the last whole
    chunk of C vectors (the kernel's scalar tail)."""
    c = dx.shape[-1]
    chunk = c * (16 // dx.element_size())
    flat = dx.reshape(-1)
    keep = flat.numel() // chunk * chunk
    return flat[:keep].float().reshape(-1, c).sum(0)


def k4_double_backward(fa, x, b, go, ggx, ggb):
    """(out, dx, dbias, d<ggx, dx> + <ggb, dbias> / d go) of
    fused_leaky_relu at (x, b) for the output gradient go."""
    x, b, go = (t.clone().requires_grad_() for t in (x, b, go))
    out = fa.fused_leaky_relu(x, b)
    dx, db = torch.autograd.grad(out, (x, b), go, create_graph=True)
    (dgo,) = torch.autograd.grad((dx * ggx).sum() + (db * ggb).sum(), go)
    return out.detach(), dx.detach(), db.detach(), dgo


def phase_k4():
    """K4 forward and backward against their plain versions at K4_SHAPES,
    bf16 and fp32; planted faults; gradients and gradients of gradients
    through the kernels against the plain path; kernel vs plain times (CUDA events, median of
    OPS_ITERS)."""
    from codeformer_tpu_torch.ops import fused_act as fa
    g = torch.Generator(device='cuda').manual_seed(4)
    print(f'K4 checks ({card_line()}): forward bitwise (fp32) / within 1 '
          f'bf16 ulp (bf16) '
          f'of the plain version, dx exact, dbias within {DBIAS_BOUND} of '
          f'the fp64 sum (relative to sum |dx|)', flush=True)
    rows = []
    for shape in K4_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=g, device='cuda').to(dt)
            bias = torch.randn(shape[-1], generator=g, device='cuda')
            gr = torch.randn(shape, generator=g, device='cuda').to(dt)
            out = fa.fused_lrelu_fwd(x, bias, 0.2, 2 ** 0.5)
            dx, db = fa.fused_lrelu_bwd(gr, out, 0.2, 2 ** 0.5)
            torch.cuda.synchronize()
            ref = fa.fused_leaky_relu_ref(x, bias)
            dx_r, db_r = fa.fused_leaky_relu_bwd_ref(gr, out)
            fwd_ok = fwd_agrees(out, ref)
            dx_ok = bool(torch.equal(dx, dx_r))
            db_e, db_re = dbias_err(db, dx_r), dbias_err(db_r, dx_r)
            err = float((out.float() - ref.float()).abs().max())
            ok = fwd_ok and dx_ok and db_e <= DBIAS_BOUND
            numel = x.numel()
            tail = numel % (shape[-1] * 16 // x.element_size())
            faults = {'mask from x': fwd_agrees(out, k4_fault_fwd(x, bias))}
            if tail:
                faults['dbias without the tail'] = dbias_err(
                    k4_fault_dbias(dx_r), dx_r) <= DBIAS_BOUND
            ms = time_ms(lambda: fa.fused_lrelu_fwd(x, bias, 0.2, 2 ** 0.5),
                         iters=OPS_ITERS)
            pms = time_ms(lambda: fa.fused_leaky_relu_ref(x, bias),
                          iters=OPS_ITERS)
            bms = time_ms(lambda: fa.fused_lrelu_bwd(gr, out, 0.2, 2 ** 0.5),
                          iters=OPS_ITERS)
            bpms = time_ms(lambda: fa.fused_leaky_relu_bwd_ref(gr, out),
                           iters=OPS_ITERS)
            es = x.element_size()
            fwd_lim = bound(4 * numel, 2 * numel * es + 4 * shape[-1],
                            FP32_FLOPS)
            bwd_lim = bound(3 * numel, 3 * numel * es + 4 * shape[-1],
                            FP32_FLOPS)
            name = f'K4 {tuple(shape)} {str(dt)[6:]}'
            print(f'  {name:34s} fwd max_abs {err:.3g} '
                  f'{"ok" if fwd_ok else "FAIL"}, dx '
                  f'{"exact" if dx_ok else "DIFFERS"}, dbias rel '
                  f'{db_e:.3g} (plain {db_re:.3g}; <= {DBIAS_BOUND}); tail '
                  f'{tail}; fwd kernel {ms:.4f} ms plain {pms:.4f} ms '
                  f'bound {fwd_lim["bound_ms"]:.4f} ms, bwd kernel '
                  f'{bms:.4f} ms plain {bpms:.4f} ms bound '
                  f'{bwd_lim["bound_ms"]:.4f} ms  '
                  f'{"ok" if ok else "FAIL"}; planted faults: '
                  + ', '.join(f'{k} {"passes" if v else "fails"}'
                              for k, v in faults.items()), flush=True)
            if not ok:
                raise SystemExit(f'chip_smoke: {name} disagrees with its '
                                 f'plain version')
            if any(faults.values()):
                raise SystemExit(f'chip_smoke: {name}: a planted fault '
                                 f'passes the checks')
            rows.append(dict(
                shape=name, max_abs_err=err, ms=ms, plain_ms=pms,
                bwd_max_abs_err=float((db - db_r).abs().max()), bwd_ms=bms,
                bwd_plain_ms=bpms, fwd_bound=fwd_lim, bwd_bound=bwd_lim))
            del x, gr, out, dx, ref, dx_r
    # gradients and gradients of gradients through the autograd Functions
    # on the kernels, fp32, against the same Functions on CPU copies (the
    # plain versions, whose fp64 gradcheck and gradgradcheck run in
    # tests/test_torch_fused_act.py): forward, dx and d(grad) bitwise,
    # dbias within DBIAS_BOUND
    for shape in ((2, 5, 7, 3), (2, 513)):
        x = torch.randn(shape, generator=g, device='cuda')
        b = torch.randn(shape[-1], generator=g, device='cuda')
        go, ggx = (torch.randn(shape, generator=g, device='cuda')
                   for _ in range(2))
        ggb = torch.randn(shape[-1], generator=g, device='cuda')
        before = fa.launch_counts()
        got = k4_double_backward(fa, x, b, go, ggx, ggb)
        n = {k: v - before[k] for k, v in fa.launch_counts().items()}
        want = [t.to('cuda') for t in k4_double_backward(
            fa, *(t.cpu() for t in (x, b, go, ggx, ggb)))]
        same = [bool(torch.equal(got[i], want[i])) for i in (0, 1, 3)]
        db_e = dbias_err(got[2], got[1])
        ok = all(same) and db_e <= DBIAS_BOUND and all(n.values())
        print(f'  K4 fp32 {shape} autograd vs plain: out, dx, d(grad) '
              f'{"bitwise" if all(same) else "DIFFER " + str(same)}, dbias '
              f'rel {db_e:.3g}; through the kernels '
              f'({n["fused_lrelu_fwd"]} forward, {n["fused_lrelu_bwd"]} '
              f'backward launches)', flush=True)
        if not ok:
            raise SystemExit('chip_smoke: K4 autograd disagrees with the '
                             'plain path')
    torch.cuda.empty_cache()
    return rows


def conv_bias_fault(kind: str, x, weight, bias):
    """Planted faults of the bare conv: 'halo row shifted', every tile of
    the plan's TH output rows reads its top halo row one row too low (the
    tile's own first row); 'bias dropped'; 'channel tail read' (Cin % 64
    == 32), the channels past Cin of the last 64-channel chunk read from
    memory (the next pixel's first channels) against weight rows that are
    not zero (those of the chunk's first channels)."""
    import torch.nn.functional as F
    from codeformer_tpu_torch.ops import conv3x3 as cv
    wf, bf = weight.to(x.dtype).float(), bias.float()
    if kind == 'bias dropped':
        return cv.conv3x3_bias_ref(x, weight, torch.zeros_like(bias))
    if kind == 'channel tail read':
        bsz, h, w, cin = x.shape
        tail = 64 - cin % 64
        flat = F.pad(x.reshape(bsz, h * w * cin), (0, tail))
        nxt = flat.unfold(1, cin + tail, cin)[:, :h * w, cin:]
        xt = torch.cat([x, nxt.reshape(bsz, h, w, tail)], -1)
        wt = torch.cat([wf, wf[:, cin - 64 + tail:cin - 64 + 2 * tail]], 1)
        return F.conv2d(xt.float().permute(0, 3, 1, 2), wt, bf, padding=1) \
            .permute(0, 2, 3, 1).to(x.dtype)
    if kind != 'halo row shifted':
        raise ValueError(kind)
    th = cv.conv_plan(x.shape[0], x.shape[1], x.shape[2], x.shape[3],
                      weight.shape[0], 1).th
    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1))
    tiles = []
    for y0 in range(0, x.shape[1], th):
        win = xp[:, :, y0:y0 + th + 2].clone()
        if y0 > 0:
            win[:, :, 0] = win[:, :, 1]
        tiles.append(F.conv2d(win, wf, bf))
    return torch.cat(tiles, 2).permute(0, 2, 3, 1).to(x.dtype)


CONV_BIAS_FAULTS = ('halo row shifted', 'bias dropped', 'channel tail read')


def phase_conv_bias():
    """conv3x3_bias against its plain version (fp32 sums, TF32 off) at
    CONV_BIAS_CASES; planted faults; kernel (the launch on prepared
    operands), whole call, plain (bf16, cuDNN) and library-call (one
    F.conv2d, bf16, channels_last) times."""
    import torch.nn.functional as F
    from codeformer_tpu_torch.ops import conv3x3 as cv
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device='cuda').manual_seed(6)
    print(f'conv3x3_bias checks ({card_line()}): bf16 in/out; ref = plain '
          f'version in fp32, TF32 off; rel RMS <= {REL_RMS_BOUND}; kernel = '
          f'the launch on prepared operands, call = the whole '
          f'conv3x3_bias call; library = F.conv2d(NCHW channels_last view, '
          f'padding=1) in bf16; ms per launch, median of 5 runs of '
          f'{OPS_ITERS} [min, max]', flush=True)
    rows = []
    for bsz, h, cin, cout in CONV_BIAS_CASES:
        x = torch.randn(bsz, h, h, cin, generator=g, device='cuda') \
            .to(torch.bfloat16)
        wt = torch.randn(cout, cin, 3, 3, generator=g, device='cuda') \
            * (9 * cin) ** -0.5
        bias = torch.randn(cout, generator=g, device='cuda') * 0.1
        y = cv.conv3x3_bias(x, wt, bias)
        torch.cuda.synchronize()
        yr = cv.conv3x3_bias_ref(x, wt, bias)
        err = float((y.float() - yr.float()).abs().max())
        rr = rel_rms(y, yr)
        faults = {k: rel_rms(y, conv_bias_fault(k, x, wt, bias))
                  for k in CONV_BIAS_FAULTS
                  if k != 'channel tail read' or cin % 64}
        xc = x.permute(0, 3, 1, 2)            # NCHW view, channels_last
        wb, bb = wt.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last), bias.to(torch.bfloat16)
        launch = cv.prepare_conv(x, cv.conv_operands(wt, bias), 1)
        ms = time_ms(lambda: cv.launch_conv(launch), iters=OPS_ITERS)
        cms = time_ms(lambda: cv.conv3x3_bias(x, wt, bias), iters=OPS_ITERS)
        pms = time_ms(lambda: cv.conv3x3_bias_ref(
            x, wt, bias, compute_dtype=torch.bfloat16), iters=OPS_ITERS)
        lms = time_ms(lambda: F.conv2d(xc, wb, bb, padding=1),
                      iters=OPS_ITERS)
        pix = bsz * h * h
        lim = bound(2 * pix * 9 * cin * cout,
                    2 * pix * (cin + cout) + 18 * cin * cout + 4 * cout,
                    BF16_TC_FLOPS)
        name = f'conv3x3_bias B={bsz} {h}^2 {cin}->{cout}'
        ok = rr <= REL_RMS_BOUND and y.shape == (bsz, h, h, cout)
        caught = all(v > REL_RMS_BOUND for v in faults.values())
        pl = launch.plan
        print(f'  {name:36s} max_abs {err:.4g} rel_rms {rr:.3g} (<= '
              f'{REL_RMS_BOUND})  kernel {ms:.4f} {ms.spread()} ms  call '
              f'{cms:.4f} ms  plain {pms:.4f} ms  library {lms:.4f} '
              f'{lms.spread()} ms  bound {lim["bound_ms"]:.4f} ms '
              f'({lim["bound_by"]}, {lim["bound_ms"] / ms:.1%} of it)  plan '
              f'TH={pl.th} BN={pl.bn} split={pl.split} stages={pl.stages} '
              f'grid={pl.grid_x}x{pl.n_slices * pl.split}  '
              f'{"ok" if ok else "FAIL"}; planted faults: ' + ', '.join(
                  f'{k} {v:.3g}' for k, v in faults.items())
              + f' {"FAIL as they must" if caught else "PASS (bound too loose)"}',
              flush=True)
        if not ok:
            raise SystemExit(f'chip_smoke: {name} disagrees with its plain '
                             f'version')
        if not caught:
            raise SystemExit(f'chip_smoke: {name}: a planted fault passes '
                             f'the bound')
        rows.append(dict(shape=name, max_abs_err=err, rel_rms=rr, ms=ms,
                         call_ms=cms, plain_ms=pms, library_ms=lms, **lim))
        del x, y, yr, xc, launch
    torch.cuda.empty_cache()
    return rows


def phase_ops_path() -> dict:
    """The ops layer's main path, with every count set to 0 just before
    it and read just after: conv3x3_bias at OPS_PATH_SHAPE, then
    fused_leaky_relu forward and backward on its output through autograd.
    Then each result against its plain version on the same inputs."""
    from codeformer_tpu_torch.ops import conv3x3 as cv
    from codeformer_tpu_torch.ops import fused_act as fa
    from codeformer_tpu_torch.ops import conv3x3_bias, fused_leaky_relu
    g = torch.Generator(device='cuda').manual_seed(7)
    bsz, h, w, c = OPS_PATH_SHAPE
    x = torch.randn(bsz, h, w, c, generator=g, device='cuda') \
        .to(torch.bfloat16)
    wt = torch.randn(c, c, 3, 3, generator=g, device='cuda') * (9 * c) ** -0.5
    b_conv = torch.randn(c, generator=g, device='cuda') * 0.1
    b_act = (torch.randn(c, generator=g, device='cuda') * 0.1) \
        .requires_grad_()
    up = torch.randn(OPS_PATH_SHAPE, generator=g, device='cuda') \
        .to(torch.bfloat16)
    reset_all_counts()
    y = conv3x3_bias(x, wt, b_conv).requires_grad_()
    out = fused_leaky_relu(y, b_act)
    out.backward(up)
    torch.cuda.synchronize()
    counts = all_counts()
    # the plain versions on the same inputs
    yr = cv.conv3x3_bias_ref(x, wt, b_conv)
    out_r = fa.fused_leaky_relu_ref(y.detach(), b_act.detach())
    dx_r, db_r = fa.fused_leaky_relu_bwd_ref(up, out.detach())
    r = dict(conv=rel_rms(y.detach(), yr),
             fwd=fwd_agrees(out.detach(), out_r),
             dx=bool(torch.equal(y.grad, dx_r)),
             db=dbias_err(b_act.grad, dx_r))
    print(f'ops path: conv3x3_bias -> fused_leaky_relu fwd + bwd at '
          f'{OPS_PATH_SHAPE} bf16: launches {counts}; conv rel_rms '
          f'{r["conv"]:.3g}, forward {"ok" if r["fwd"] else "FAIL"}, dx '
          f'{"exact" if r["dx"] else "DIFFERS"}, dbias rel {r["db"]:.3g}',
          flush=True)
    if not (r['conv'] <= REL_RMS_BOUND and r['fwd'] and r['dx']
            and r['db'] <= DBIAS_BOUND):
        raise SystemExit('chip_smoke: the ops path disagrees with its plain '
                         'versions')
    if not all(torch.isfinite(t).all() for t in (out, y.grad, b_act.grad)):
        raise SystemExit('chip_smoke: non-finite values on the ops path')
    del x, y, out, up, yr, out_r, dx_r
    torch.cuda.empty_cache()
    return counts


def phase_card():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device visible')
    print(card_line(), flush=True)
    nvcc = subprocess.run(['bash', '-lc', 'nvcc --version || '
                           '/usr/local/cuda/bin/nvcc --version'],
                          capture_output=True, text=True).stdout
    print(f'python {sys.version.split()[0]}  torch {torch.__version__}  '
          f'cuda {torch.version.cuda}  nvcc: '
          f'{nvcc.strip().splitlines()[-1] if nvcc.strip() else "?"}')
    cap = torch.cuda.get_device_capability(0)
    print(f'device: {torch.cuda.get_device_name(0)} capability {cap} '
          f'count {torch.cuda.device_count()}', flush=True)
    if cap != (9, 0):
        raise SystemExit(f'chip_smoke: needs compute capability 9.0, '
                         f'got {cap}')


def phase_build():
    from codeformer_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    info = build.build_info
    print(f'build: {info["path"]} in {info["seconds"]:.1f} s '
          f'(cached={info["cached"]}), load total '
          f'{time.perf_counter() - t0:.1f} s')
    for line in info['log'].splitlines():
        if 'Function properties for' in line:     # names the lines below
            print('  ptxas:', line.strip()[:110])
        elif any(k in line for k in ('registers', 'spill', 'error',
                                     'warning', 'Performance')):
            print('  ptxas:', line.strip())
    sys.stdout.flush()


def _k1_inputs(g, bsz, h, cin, cout, skip, cs):
    dev = 'cuda'

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    x = rnd(bsz, h, h, cin).to(torch.bfloat16)
    a = (1.0 + rnd(bsz, cin, scale=0.1)).contiguous()
    b = rnd(bsz, cin, scale=0.3).contiguous()       # non-zero: halo trap
    weight = rnd(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    bias = rnd(cout, scale=0.1)
    sk, w1 = None, None
    if skip == 'identity':
        sk = rnd(bsz, h, h, cout).to(torch.bfloat16)
    elif skip == 'proj':
        sk = rnd(bsz, h, h, cs).to(torch.bfloat16)
        w1 = rnd(cout, cs, 1, 1, scale=cs ** -0.5)
    return x, a, b, weight, bias, sk, w1


def phase_k1():
    """K1 against its plain version (fp32 sums, TF32 off) at K1_CASES: y
    within REL_RMS_BOUND, every statistics slot within STATS_BOUND of the
    exact sums of the kernel's own rounded y; planted faults that must
    fail; kernel (the launch on prepared operands), whole-call, plain
    (bf16, cuDNN) and conv-alone library (one F.conv2d) times; the plan
    and the bound of every shape."""
    import torch.nn.functional as F
    from codeformer_tpu_torch.ops import conv3x3 as cv
    torch.backends.cudnn.allow_tf32 = False          # the fp32 reference
    torch.backends.cuda.matmul.allow_tf32 = False    # must be true fp32
    g = torch.Generator(device='cuda').manual_seed(0)
    rows = []
    print(f'K1 checks ({card_line()}): bf16 in/out; ref = plain version in '
          f'fp32, TF32 off; y rel RMS <= {REL_RMS_BOUND}, every statistics '
          f'slot within {STATS_BOUND} of the fp64 sums of the rounded y; '
          f'kernel = the launch on prepared operands, call = the whole '
          f'conv3x3_dots call, plain = plain version in bf16 (cuDNN), conv '
          f'library = one F.conv2d of the same shape (bf16, channels_last; '
          f'the conv alone, not the same function); ms per launch, median '
          f'of 5 runs of 20 [min, max]', flush=True)
    for bsz, h, cin, cout, act, skip, cs in K1_CASES:
        x, a, b, wt, bias, sk, w1 = _k1_inputs(g, bsz, h, cin, cout, skip,
                                               cs)
        y, st = cv.conv3x3_dots(x, a, b, act, wt, bias, sk, w1)
        torch.cuda.synchronize()
        launch = cv.prepare_dots(x, a, b, act,
                                 cv.dots_operands(wt, bias, w1), sk)
        pl = launch.plan
        yr, _ = cv.conv3x3_dots_ref(x, a, b, act, wt, bias, sk, w1)
        err = float((y.float() - yr.float()).abs().max())
        rr = rel_rms(y, yr)
        st_err = k1_stats_err(st, y, pl.th)
        ok = rr <= REL_RMS_BOUND and st_err <= STATS_BOUND \
            and y.shape == (bsz, h, h, cout) \
            and st.shape == (bsz, cv.stats_slots(pl), 2, cout)
        faults = {}
        for kind in K1_FAULTS:
            got = k1_fault(kind)(x, a, b, act, wt, bias, sk, w1, th=pl.th)
            if got is None:
                continue
            fy, fst = got
            faults[kind] = k1_stats_err(fst, fy, pl.th) \
                if kind == 'stats of unrounded y' else rel_rms(y, fy)
        caught = all(v > (STATS_BOUND if k == 'stats of unrounded y'
                          else REL_RMS_BOUND) for k, v in faults.items())
        ms = time_ms(lambda: cv.launch_dots(launch))
        cms = time_ms(lambda: cv.conv3x3_dots(x, a, b, act, wt, bias, sk,
                                              w1))
        pms = time_ms(lambda: cv.conv3x3_dots_ref(
            x, a, b, act, wt, bias, sk, w1, compute_dtype=torch.bfloat16))
        xc = x.permute(0, 3, 1, 2)            # NCHW view, channels_last
        wb = wt.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bb = bias.to(torch.bfloat16)
        lms = time_ms(lambda: F.conv2d(xc, wb, bb, padding=1))
        lim = k1_bound(bsz, h, cin, cout, skip, cs, cv.stats_slots(pl))
        name = f'K1 B={bsz} {h}^2 {cin}->{cout} {act} skip={skip}' + \
            (f'({cs})' if cs else '')
        print(f'  {name:44s} max_abs {err:.4g} rel_rms {rr:.3g} (<= '
              f'{REL_RMS_BOUND}) stats {st_err:.3g} (<= {STATS_BOUND})  '
              f'kernel {ms:.4f} {ms.spread()} ms  call {cms:.4f} ms  plain '
              f'{pms:.4f} ms  conv library {lms:.4f} {lms.spread()} ms  '
              f'bound {lim["bound_ms"]:.4f} ms ({lim["bound_by"]}, '
              f'{lim["bound_ms"] / ms:.1%} of it)  plan TH={pl.th} '
              f'BN={pl.bn} split={pl.split} stages={pl.stages} '
              f'grid={pl.grid_x}x{pl.n_slices * pl.split} smem={pl.smem}  '
              f'{"ok" if ok else "FAIL"}; planted faults: ' + ', '.join(
                  f'{k} {v:.3g}' for k, v in faults.items())
              + f' {"FAIL as they must" if caught else "PASS (bound too loose)"}',
              flush=True)
        if not ok:
            raise SystemExit(f'chip_smoke: {name} disagrees with its plain '
                             f'version')
        if not caught:
            raise SystemExit(f'chip_smoke: {name}: a planted fault passes '
                             f'the bounds')
        rows.append(dict(shape=name, max_abs_err=err, rel_rms=rr,
                         stats_err=st_err, ms=ms, call_ms=cms, plain_ms=pms,
                         library_ms=None, conv_library_ms=lms, **lim))
        del x, y, yr, st, launch, xc
    torch.cuda.empty_cache()
    return rows


def phase_kernels():
    """K1 (phase_k1), then K2 against its plain version at K2_CASES, with
    planted faults and kernel, whole-call, plain and library times."""
    import torch.nn.functional as F
    from codeformer_tpu_torch.ops import conv3x3 as cv
    results = {'conv3x3_dots': phase_k1()}
    g = torch.Generator(device='cuda').manual_seed(1)
    split_faults = []
    print(f'K2 checks ({card_line()}): bf16 in/out; ref = plain version '
          f'in fp32, TF32 off; kernel = the launch on prepared operands, '
          f'call = the whole public call, plain = plain version in bf16 '
          f'(cuDNN); ms per launch, median of 5 runs of 20 [min, max]')
    for bsz, h, c in K2_CASES:
        x = (torch.randn(bsz, h, h, c, generator=g, device='cuda')
             .to(torch.bfloat16))
        wt = torch.randn(c, c, 3, 3, generator=g, device='cuda') \
            * (9 * c) ** -0.5
        bias = torch.randn(c, generator=g, device='cuda') * 0.1
        y = cv.downsample_dots(x, wt, bias)
        torch.cuda.synchronize()
        yr = cv.downsample_dots_ref(x, wt, bias)
        err = float((y.float() - yr.float()).abs().max())
        rr = rel_rms(y, yr)
        launch = cv.prepare_conv(x, cv.conv_operands(wt, bias), 2)
        ms = time_ms(lambda: cv.launch_conv(launch))
        cms = time_ms(lambda: cv.downsample_dots(x, wt, bias))
        pms = time_ms(lambda: cv.downsample_dots_ref(
            x, wt, bias, compute_dtype=torch.bfloat16))
        # the library yardstick: F.pad + one F.conv2d, bf16, channels_last
        xc = x.permute(0, 3, 1, 2)
        wb = wt.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bb = bias.to(torch.bfloat16)
        lms = time_ms(lambda: F.conv2d(F.pad(xc, (0, 1, 0, 1)), wb, bb,
                                       stride=2))
        name = f'K2 B={bsz} {h}^2 -> {h // 2}^2 C={c}'
        ok = rr <= REL_RMS_BOUND and y.shape == (bsz, h // 2, h // 2, c)
        faults = {}
        for kind in K2_FAULTS:
            wrong = k2_planted(kind)(x, wt, bias)
            if wrong is not None:
                faults[kind] = rel_rms(y, wrong)
                if kind == 'split partial dropped':
                    split_faults.append(name)
        pix = bsz * (h // 2) ** 2
        lim = bound(2 * pix * 9 * c * c,
                    2 * bsz * h * h * c + 2 * pix * c + 18 * c * c + 4 * c,
                    BF16_TC_FLOPS)
        pl = launch.plan
        caught = all(v > REL_RMS_BOUND for v in faults.values())
        print(f'  {name:38s} max_abs {err:.4g} rel_rms {rr:.3g} '
              f'(<= {REL_RMS_BOUND})  kernel {ms:.4f} {ms.spread()} ms  call '
              f'{cms:.4f} ms  plain {pms:.4f} ms  library {lms:.4f} '
              f'{lms.spread()} ms  bound {lim["bound_ms"]:.4f} ms '
              f'({lim["bound_by"]}, {lim["bound_ms"] / ms:.1%} of it)  plan '
              f'TH={pl.th} BN={pl.bn} split={pl.split} stages={pl.stages} '
              f'grid={pl.grid_x}x{pl.n_slices * pl.split}  '
              f'{"ok" if ok else "FAIL"}; planted faults: ' + ', '.join(
                  f'{k} {v:.3g}' for k, v in faults.items())
              + f' {"FAIL as they must" if caught else "PASS (bound too loose)"}',
              flush=True)
        if not ok:
            raise SystemExit(f'chip_smoke: {name} disagrees with its plain '
                             f'version')
        if not caught:
            raise SystemExit(f'chip_smoke: {name}: a planted fault passes '
                             f'the bound')
        results.setdefault('downsample_dots', []).append(
            dict(shape=name, max_abs_err=err, rel_rms=rr, ms=ms,
                 call_ms=cms, plain_ms=pms, library_ms=lms, **lim))
        del x, y, yr, xc, launch
    if not split_faults:
        raise SystemExit('chip_smoke: no K2 shape splits its input chunks, '
                         'so the split is never checked')
    return results


def _faces(rng, n, size=512):
    """Seeded smooth uint8 BGR images (low-frequency noise, upsampled)."""
    lo = rng.uniform(0, 255, (n, 16, 16, 3))
    img = np.repeat(np.repeat(lo, size // 16, axis=1), size // 16, axis=2)
    img = img + rng.normal(0, 12, img.shape)
    return [np.clip(im, 0, 255).astype(np.uint8) for im in img]


def count_resblocks(model, enable_fuse: bool) -> int:
    """ResBlocks one forward runs: the encoder's and generator's, plus the
    one inside each SFT block when fusion is on."""
    from codeformer_tpu_torch.nn.blocks import ResBlock
    n = sum(isinstance(m, ResBlock) for m in model.modules())
    if not enable_fuse:
        n -= sum(isinstance(m, ResBlock)
                 for m in model.fuse_convs_dict.modules())
    return n


@torch.no_grad()
def tame_sft(model, factor: float = SFT_SCALE):
    """Scale the SFT branches' last convs (scale.2, shift.2) by `factor`.

    With random weights the SFT term dec * scale(enc') grows with the
    square of the feature magnitude: four fusions take the generator's
    activations past 1e18, the tail GroupNorm's fp32 sum of squares
    overflows and the image comes out constant, so the end-to-end check
    would compare nothing. Trained weights keep activations in range.
    """
    for blk in model.fuse_convs_dict.values():
        blk.scale[2].weight.mul_(factor)
        blk.shift[2].weight.mul_(factor)


def phase_slice():
    from codeformer_tpu_torch.nn.blocks import Downsample
    from codeformer_tpu_torch.ops import conv3x3 as cv
    from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer
    t0 = time.perf_counter()
    restorer = CodeFormerRestorer(device='cuda', seed=0)
    tame_sft(restorer.model)
    model, size = restorer.model, restorer.face_size
    n_res_fused = count_resblocks(model, enable_fuse=True)
    n_res_plain = count_resblocks(model, enable_fuse=False)
    n_down = sum(isinstance(m, Downsample) for m in model.modules())
    print(f'restorer: full width (dim_embd 512, 9 layers, 1024 codes, '
          f'connect 32/64/128/256), bf16, seeded random init in '
          f'{time.perf_counter() - t0:.1f} s; ResBlocks per forward: '
          f'{n_res_fused} fused / {n_res_plain} at w=0, Downsamples: '
          f'{n_down}', flush=True)
    rng = np.random.default_rng(0)
    requests = [(3, 0.5, n_res_fused), (1, 0.0, n_res_plain),
                (1, 1.0, n_res_fused)]
    main_counts = {'conv3x3_dots': 0, 'downsample_dots': 0}
    for n, w, n_res in requests:
        faces = _faces(rng, n, size)
        cv.reset_launch_counts()
        out = restorer.restore_batch(faces, w=w)
        torch.cuda.synchronize()
        counts = cv.launch_counts()
        want = {'conv3x3_dots': 2 * n_res + 1, 'downsample_dots': n_down,
                'conv3x3_bias': 0}
        print(f'  request: {n} face(s) w={w}: launches {counts} '
              f'(expected {want})', flush=True)
        if counts != want:
            raise SystemExit('chip_smoke: kernel launch counts differ from '
                             'the main path (a failed chunk passes through)')
        for k in main_counts:
            main_counts[k] += counts[k]
        for face, o in zip(faces, out):
            if o.shape != (size, size, 3) or o.dtype != np.uint8:
                raise SystemExit(f'chip_smoke: bad output {o.shape} '
                                 f'{o.dtype}')
            if np.array_equal(o, face):
                raise SystemExit('chip_smoke: output equals input (the '
                                 'passthrough fired)')
    # reference forward: the same model with both ops on their plain
    # versions (fp32 sums, TF32 off); then planted faults that must fail
    x = torch.from_numpy(np.stack(_faces(rng, 2, size))[..., ::-1].copy())
    xn = restorer.normalize(x.to(restorer.device))
    with torch.inference_mode():
        out_k, logits_k, lq_k = model(xn, 0.5, adain=True)
    for name, t in (('out', out_k), ('logits', logits_k), ('lq_feat', lq_k)):
        if not torch.isfinite(t.float()).all():
            raise SystemExit(f'chip_smoke: non-finite {name}')
    img_k = restorer.denormalize(out_k).float()
    img_std = float(img_k.std())

    def against(label, k1, k2):
        with torch.inference_mode(), mock.patch.multiple(
                cv, conv3x3_dots=takes_prepared(k1),
                downsample_dots=takes_prepared(k2)):
            out_r, logits_r, lq_r = model(xn, 0.5, adain=True)
        diff = (img_k - restorer.denormalize(out_r).float()).abs()
        r = dict(lq=rel_rms(lq_k, lq_r), logits=rel_rms(logits_k, logits_r),
                 agree=float((logits_k.argmax(-1) == logits_r.argmax(-1))
                             .float().mean()),
                 diff=float(diff.mean()))
        inside = (max(r['lq'], r['logits']) <= SLICE_REL_BOUND
                  and r['agree'] >= INDEX_AGREEMENT_FLOOR
                  and r['diff'] <= IMAGE_DIFF_BOUND)
        print(f'  vs {label}: lq_feat rel_rms {r["lq"]:.3g}, logits rel_rms '
              f'{r["logits"]:.3g} (<= {SLICE_REL_BOUND}); code index '
              f'agreement {r["agree"]:.4f} (>= {INDEX_AGREEMENT_FLOOR}); '
              f'image diff mean {r["diff"]:.4f} (<= {IMAGE_DIFF_BOUND}) max '
              f'{float(diff.max()):.0f} levels, '
              f'{float((diff > 2).float().mean()):.4f} of values off by > 2: '
              f'{"within bounds" if inside else "OUT of bounds"}', flush=True)
        return inside

    print(f'  kernel-path forward, B=2, w=0.5: image std {img_std:.2f} '
          f'levels (>= {MIN_IMAGE_STD})', flush=True)
    if img_std < MIN_IMAGE_STD:
        raise SystemExit('chip_smoke: the restored image is (nearly) '
                         'constant')
    if not against('reference forward (plain ops)', cv.conv3x3_dots_ref,
                   cv.downsample_dots_ref):
        raise SystemExit('chip_smoke: kernel path disagrees with the plain '
                         'reference forward')
    # a bf16 prologue (~5e-3 a conv) hides in the whole forward's rounding
    # noise (PERF.md); the per-call check on the path's own activations
    # below resolves it
    if against('planted fault: K1 halo act(b)', k1_fault('halo act(b)'),
               cv.downsample_dots_ref):
        raise SystemExit('chip_smoke: the model bounds let the planted '
                         'fault K1 halo act(b) pass')
    if against('planted fault: K2 symmetric pad', cv.conv3x3_dots_ref,
               k2_fault):
        raise SystemExit('chip_smoke: the model bounds let the planted '
                         'fault K2 symmetric pad pass')
    worst = per_call(model, xn, 'kernels', cv.conv3x3_dots,
                     cv.downsample_dots)
    if max(worst.values()) > REL_RMS_BOUND:
        raise SystemExit('chip_smoke: a kernel call of the forward '
                         'disagrees with its plain version')
    for fault in K1_MODEL_FAULTS:
        worst = per_call(model, xn, f'planted fault: K1 {fault}',
                         k1_fault(fault), cv.downsample_dots_ref)
        if worst['conv3x3_dots'] <= REL_RMS_BOUND:
            raise SystemExit(f'chip_smoke: the per-call bound lets the '
                             f'planted fault K1 {fault} pass')
    phase_rates(restorer, [
        torch.from_numpy(np.stack(_faces(rng, bsz, size))).cuda()
        for bsz in (1, 8, 16)])
    return main_counts, restorer


def per_call(model, xn, label, k1, k2, w=0.5, adain=True,
             enable_fuse=True) -> dict:
    """Run one forward (w, adain, enable_fuse) with K1/K2 served by (k1,
    k2) and hold every call against the plain version on that call's own
    inputs: the main path's real activations, where the whole-forward
    comparison sees only compounded rounding noise. Returns the worst rel
    RMS by op."""
    from codeformer_tpu_torch.ops import conv3x3 as cv
    errs = {'conv3x3_dots': [], 'downsample_dots': []}
    # the kernels take the modules' kept operands; a plain stand-in
    # ignores them
    k1 = k1 if k1 is cv.conv3x3_dots else takes_prepared(k1)
    k2 = k2 if k2 is cv.downsample_dots else takes_prepared(k2)

    def shadow1(*args, prepared=None, **kw):
        y, st = k1(*args, prepared=prepared, **kw)
        errs['conv3x3_dots'].append(
            rel_rms(y, cv.conv3x3_dots_ref(*args, **kw)[0]))
        return y, st

    def shadow2(x, weight, bias, prepared=None):
        y = k2(x, weight, bias, prepared=prepared)
        errs['downsample_dots'].append(
            rel_rms(y, cv.downsample_dots_ref(x, weight, bias)))
        return y

    with torch.inference_mode(), mock.patch.multiple(
            cv, conv3x3_dots=shadow1, downsample_dots=shadow2):
        model(xn, w, adain=adain, enable_fuse=enable_fuse)
    worst = {k: max(v) for k, v in errs.items()}
    print(f'  per call, {label} vs plain on the same inputs: ' + '; '.join(
        f'{k} {len(v)} calls, rel_rms {min(v):.3g}..{max(v):.3g}, '
        f'{sum(e > REL_RMS_BOUND for e in v)} above {REL_RMS_BOUND}'
        for k, v in errs.items()), flush=True)
    return worst


def _rate(restorer, xb, w=0.5, adain=True) -> float:
    """Faces/s through restore_device over one window of at least
    RATE_WINDOW_S seconds (host clock, ends in a synchronize)."""
    for _ in range(2):
        restorer.restore_device(xb, w=w, adain=adain)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restorer.restore_device(xb, w=w, adain=adain)
    torch.cuda.synchronize()
    iters = max(2, int(RATE_WINDOW_S / (time.perf_counter() - t0)) + 1)
    t0 = time.perf_counter()
    for _ in range(iters):
        restorer.restore_device(xb, w=w, adain=adain)
    torch.cuda.synchronize()
    return len(xb) * iters / (time.perf_counter() - t0)


def plain_ops():
    """Patch K1/K2 to their plain versions in bf16 (cuDNN conv): the
    port's forward as plain PyTorch, for timing."""
    from codeformer_tpu_torch.ops import conv3x3 as cv
    return mock.patch.multiple(
        cv, conv3x3_dots=takes_prepared(functools.partial(
            cv.conv3x3_dots_ref, compute_dtype=torch.bfloat16)),
        downsample_dots=takes_prepared(functools.partial(
            cv.downsample_dots_ref, compute_dtype=torch.bfloat16)))


def phase_rates(restorer, batches, w=0.5, adain=True, label='aligned'):
    """Faces/s of each uint8 RGB batch on the card, kernel path and plain
    path in alternating windows (kernel, plain, plain, kernel, ...);
    median and range of each."""
    print(f'  faces/s through restore_device, w={w}, adain={adain}, TF32 '
          f'off: {RATE_REPEATS} windows of >= {RATE_WINDOW_S} s per path, '
          f'alternating; median [min, max]', flush=True)
    for xb in batches:
        got = {'kernel': [], 'plain': []}
        for rep in range(RATE_REPEATS):
            for path in (('kernel', 'plain') if rep % 2 == 0
                         else ('plain', 'kernel')):
                with (plain_ops() if path == 'plain'
                      else contextlib.nullcontext()):
                    got[path].append(_rate(restorer, xb, w, adain))
        med = {k: statistics.median(v) for k, v in got.items()}
        print(f'  {label} faces/s at B={len(xb)}: kernel '
              f'{med["kernel"]:.2f} [{min(got["kernel"]):.2f}, '
              f'{max(got["kernel"]):.2f}]  plain {med["plain"]:.2f} '
              f'[{min(got["plain"]):.2f}, {max(got["plain"]):.2f}]  ratio '
              f'{med["kernel"] / med["plain"]:.3f}', flush=True)


def print_profile(label: str, prof, iters: int, wall_ms: float) -> None:
    """Device time by kernel from a torch.profiler run over `iters`
    repetitions: busy share against the host wall time and the top 20."""
    # device-side events only (kernels, copies, sets): a CPU op's or an
    # autograd node's device time is the sum of its children's kernels
    rows = [(e.key, e.device_time_total / iters / 1e3, e.count // iters)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type != torch.autograd.DeviceType.CPU]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f'profile, {label}: wall {wall_ms:.2f} ms (profiler on), device '
          f'kernels {busy:.2f} ms, busy share {busy / wall_ms:.3f}, '
          f'{sum(r[2] for r in rows)} device events a repetition')
    # the top 20, then the port's own kernels that rank lower
    for i, (key, ms, n) in enumerate(rows):
        if i < 20 or 'cf::' in key:
            print(f'  {ms:8.3f} ms {100 * ms / busy:5.1f}% x{n:4d}  '
                  f'{key[:100]}')
    sys.stdout.flush()


def phase_profile(restorer, bsz: int = 8, iters: int = 3):
    """Device time of one forward by kernel (torch.profiler), kernel path
    and plain path."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(1)
    xb = torch.from_numpy(np.stack(_faces(rng, bsz, restorer.face_size))) \
        .to(restorer.device)
    for label, ctx in (('kernel', contextlib.nullcontext()),
                       ('plain', plain_ops())):
        with ctx:
            restorer.restore_device(xb)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(iters):
                    restorer.restore_device(xb)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / iters * 1e3
        print_profile(f'{label} path, B={bsz} forward', prof, iters, wall)


def phase_train_profile(trainer, iters: int = 3):
    """Device time of one stage-II training step by kernel
    (torch.profiler), kernel path and plain path."""
    from torch.profiler import ProfilerActivity, profile
    step = 1000
    for label, ctx in (('kernel', contextlib.nullcontext()),
                       ('plain', plain_train_ops())):
        with ctx:
            step += 1
            trainer.optimize_parameters(step)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(iters):
                    step += 1
                    trainer.optimize_parameters(step)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / iters * 1e3
        print_profile(f'{label} path, stage-II step B={TRAIN_BATCH}', prof,
                      iters, wall)


# stage-II training at full width (options/CodeFormer_stage2.yml)
TRAIN_BATCH = 4           # batch_size_per_gpu of the config
TRAIN_STEPS = 8
ENCODE_LAUNCHES = {'conv3x3_dots': 28, 'downsample_dots': 5,
                   'nearest_code': 1,   # one frozen HQ encode, per microbatch
                   'conv3x3_bias': 0, 'fused_lrelu_fwd': 0,
                   'fused_lrelu_bwd': 0}
# idx_gt of the kernel path against the same encode with K1/K2/K3 on
# their plain versions (fp32 sums, TF32 off): random-init codebooks give
# near-flat code scores, so bf16 rounding flips a share of the picks.
# Read 0.9873 on an H100 (PERF.md, Findings): the floor leaves about
# four times that margin. A K2 with symmetric padding reads 0.0039; a
# halo of act(b) in K1 (0.9795) hides in the rounding noise here, and the
# per-call checks of the serving phase catch it.
IDX_AGREEMENT_FLOOR = 0.95


def stage2_options() -> dict:
    """The networks and train block of options/CodeFormer_stage2.yml as a
    dict (the card's machine has no yaml), bf16, one card, seeded random
    weights (no vqgan_path or pretrained file). Left out: the yml's
    val/logger blocks and its net_d_* keys, which stage II does not read."""
    return {
        'name': 'chip_smoke_stage2', 'model_type': 'CodeFormerIdxModel',
        'manual_seed': 0, 'mixed_precision': 'bf16', 'device': 'cuda',
        'network_g': {'type': 'CodeFormer', 'dim_embd': 512, 'n_head': 8,
                      'n_layers': 9, 'codebook_size': 1024,
                      'connect_list': ['32', '64', '128', '256'],
                      'fix_modules': ['quantize', 'generator']},
        'network_vqgan': {'type': 'VQAutoEncoder', 'img_size': 512,
                          'nf': 64, 'ch_mult': [1, 2, 2, 4, 4, 8],
                          'quantizer': 'nearest', 'codebook_size': 1024},
        'path': {},
        'train': {'use_hq_feat_loss': True, 'feat_loss_weight': 1.0,
                  'cross_entropy_loss': True, 'entropy_loss_weight': 0.5,
                  'fidelity_weight': 0,
                  'optim_g': {'type': 'Adam', 'lr': 1e-4, 'weight_decay': 0,
                              'betas': [0.9, 0.99]},
                  'scheduler': {'type': 'MultiStepLR',
                                'milestones': [400000, 450000],
                                'gamma': 0.5},
                  'total_iter': 500000, 'warmup_iter': -1,
                  'ema_decay': 0.995}}


def stage2_batch(rng, n: int, size: int = 512) -> dict:
    """A loader-shaped batch made on the card: gt = seeded faces in
    [-1, 1], in = gt downsampled x8, upsampled back and given seeded
    noise; both NHWC fp32, as the FFHQ loader gives them."""
    import torch.nn.functional as F
    faces = np.stack(_faces(rng, n, size))[..., ::-1].copy()
    gt = torch.from_numpy(faces).cuda().float().div(127.5).sub(1.0)
    x = gt.permute(0, 3, 1, 2)
    lq = F.interpolate(F.interpolate(x, scale_factor=1 / 8, mode='bilinear',
                                     antialias=True),
                       size=(size, size), mode='bilinear')
    g = torch.Generator(device='cuda').manual_seed(int(rng.integers(1 << 30)))
    lq = lq + 0.05 * torch.randn(lq.shape, generator=g, device='cuda')
    return {'in': lq.clamp(-1, 1).permute(0, 2, 3, 1).contiguous(),
            'gt': gt.contiguous()}


def _op_modules():
    from codeformer_tpu_torch.ops import conv3x3 as cv
    from codeformer_tpu_torch.ops import fused_act as fa
    from codeformer_tpu_torch.ops import vq
    return cv, vq, fa


def all_counts() -> dict:
    return {k: v for m in _op_modules() for k, v in m.launch_counts().items()}


def reset_all_counts() -> None:
    for m in _op_modules():
        m.reset_launch_counts()


@contextlib.contextmanager
def plain_train_ops():
    """K1/K2 on their plain versions in bf16 (cuDNN) and K3 on its plain
    version: the training step as plain PyTorch, for timing."""
    from codeformer_tpu_torch.ops import vq
    with plain_ops(), mock.patch.object(vq, 'nearest_code_indices',
                                        vq._nearest_code_ref):
        yield


def phase_train():
    """Stage-II training at full width: TRAIN_STEPS steps on one fixed
    batch through CodeFormerIdxModel.optimize_parameters, with exact
    launch counts per step, the checks of PERF.md, idx_gt against the
    plain-op encode (and a planted fault), faces/s of the kernel and the
    plain path, peak memory. Returns the launch counts of the steps and
    the trainer."""
    from codeformer_tpu_torch.nn.blocks import ResBlock
    from codeformer_tpu_torch.ops import conv3x3 as cv
    from codeformer_tpu_torch.ops import vq
    from codeformer_tpu_torch.train.trainers import build_model
    t0 = time.perf_counter()
    trainer = build_model(stage2_options())
    net = trainer.net_g
    n_hq = sum(isinstance(m, ResBlock) and m.use_kernels
               for m in trainer.hq_vqgan.encoder.modules())
    n_g = sum(isinstance(m, ResBlock) and m.use_kernels
              for m in net.modules())
    print(f'stage II trainer: CodeFormer dim_embd 512, 9 layers, 1024 codes, '
          f'connect 32/64/128/256, nf 64, ch_mult 1,2,2,4,4,8; frozen HQ '
          f'VQGAN; bf16 activations, fp32 params; AdamW 1e-4 (0.9, 0.99), '
          f'MultiStepLR, EMA 0.995; B={TRAIN_BATCH}; built in '
          f'{time.perf_counter() - t0:.1f} s. ResBlocks on K1: HQ encoder '
          f'{n_hq}, net_g {n_g} (textbook, autograd)', flush=True)
    rng = np.random.default_rng(5)
    batch = stage2_batch(rng, TRAIN_BATCH)
    trainer.feed_data(batch)
    frozen = {k: v.clone() for k, v in net.state_dict().items()
              if k.split('.')[0] in ('quantize', 'generator')}
    encode_counts = []
    idx_gt = trainer._idx_gt

    def counted_idx_gt(mb):
        before = all_counts()
        out = idx_gt(mb)
        after = all_counts()
        encode_counts.append({k: after[k] - before[k] for k in after})
        return out
    trainer._idx_gt = counted_idx_gt
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    totals, losses = {}, []
    for step in range(1, TRAIN_STEPS + 1):
        before = all_counts()
        trainer.optimize_parameters(step)
        torch.cuda.synchronize()
        after = all_counts()
        step_counts = {k: after[k] - before[k] for k in after}
        log = trainer.log_dict
        losses.append(log)
        print(f'  step {step}: ' + ', '.join(f'{k} {v:.5f}'
                                            for k, v in log.items())
              + f'; launches {step_counts}', flush=True)
        if step_counts != ENCODE_LAUNCHES or encode_counts[-1] != \
                ENCODE_LAUNCHES:
            raise SystemExit(f'chip_smoke: step {step} launched '
                             f'{step_counts} ({encode_counts[-1]} in the '
                             f'frozen encode), expected {ENCODE_LAUNCHES} '
                             f'all in the encode and none in net_g')
        if not all(np.isfinite(v) for v in log.values()):
            raise SystemExit(f'chip_smoke: non-finite loss at step {step}')
    counts = all_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer._idx_gt = idx_gt
    grad = net.encoder.blocks[1].conv1.weight.grad
    first, last = losses[0]['l_g_total'], losses[-1]['l_g_total']
    moved = [k for k, v in frozen.items()
             if not torch.equal(v, net.state_dict()[k])]
    print(f'  l_g_total {first:.5f} -> {last:.5f}; first encoder ResBlock '
          f'conv1 grad '
          + ('None' if grad is None
             else f'RMS {float(grad.pow(2).mean().sqrt()):.3g}')
          + f'; frozen tensors moved: {len(moved)} of {len(frozen)}; peak '
          f'memory {peak:.2f} GiB; launches over {TRAIN_STEPS} steps '
          f'{counts}', flush=True)
    if not last < first:
        raise SystemExit('chip_smoke: the training loss did not fall')
    if grad is None or float(grad.abs().max()) == 0.0:
        raise SystemExit('chip_smoke: no gradient reaches the encoder')
    if moved:
        raise SystemExit(f'chip_smoke: frozen modules moved: {moved[:3]}')

    # idx_gt of the kernel path against the plain-op encode (fp32 sums,
    # TF32 off), and planted faults
    mb = trainer.batch

    def idx_with(k1, k2, k3):
        with torch.no_grad(), mock.patch.multiple(
                cv, conv3x3_dots=takes_prepared(k1),
                downsample_dots=takes_prepared(k2)), \
                mock.patch.object(vq, 'nearest_code_indices', k3):
            return trainer._idx_gt(mb)
    with torch.no_grad():
        idx_k = trainer._idx_gt(mb)
    idx_r = idx_with(cv.conv3x3_dots_ref, cv.downsample_dots_ref,
                     vq._nearest_code_ref)
    agree = float((idx_k == idx_r).float().mean())
    faults = {
        'K2 symmetric pad': idx_with(cv.conv3x3_dots_ref, k2_fault,
                                     vq._nearest_code_ref),
        'K1 halo act(b)': idx_with(k1_fault('halo act(b)'),
                                   cv.downsample_dots_ref,
                                   vq._nearest_code_ref)}
    fault_agree = {k: float((v == idx_r).float().mean())
                   for k, v in faults.items()}
    print(f'  idx_gt vs the plain-op encode: agreement {agree:.4f} (>= '
          f'{IDX_AGREEMENT_FLOOR}); planted faults: ' + ', '.join(
              f'{k} {v:.4f}' for k, v in fault_agree.items()), flush=True)
    if agree < IDX_AGREEMENT_FLOOR:
        raise SystemExit('chip_smoke: idx_gt of the kernel path disagrees '
                         'with the plain-op encode')
    if fault_agree['K2 symmetric pad'] >= IDX_AGREEMENT_FLOOR:
        raise SystemExit('chip_smoke: the idx_gt bound lets the planted '
                         'fault K2 symmetric pad pass')
    phase_train_rates(trainer)
    return counts, trainer


def _train_rate(trainer, step0: int) -> tuple:
    """(faces/s over one window of at least RATE_WINDOW_S, share of the
    step in the frozen encode, steps taken); host clock ending in a
    synchronize, encode share from CUDA events."""
    idx_gt = trainer._idx_gt
    spans = []

    def timed(mb):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = idx_gt(mb)
        b.record()
        spans.append((a, b))
        return out
    step = step0
    for _ in range(2):
        step += 1
        trainer.optimize_parameters(step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step += 1
    trainer.optimize_parameters(step)
    torch.cuda.synchronize()
    iters = max(2, int(RATE_WINDOW_S / (time.perf_counter() - t0)) + 1)
    trainer._idx_gt = timed
    try:
        t0 = time.perf_counter()
        for _ in range(iters):
            step += 1
            trainer.optimize_parameters(step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        trainer._idx_gt = idx_gt
    enc_ms = sum(a.elapsed_time(b) for a, b in spans)
    return TRAIN_BATCH * iters / wall, enc_ms / (wall * 1e3), step


def phase_train_rates(trainer):
    """Training faces/s, kernel path and plain path in alternating
    windows; median [min, max]; the frozen encode's share of the step."""
    print(f'  training faces/s (B={TRAIN_BATCH}, full step: HQ encode + '
          f'net_g forward/backward + AdamW + EMA), TF32 off: '
          f'{RATE_REPEATS} windows of >= {RATE_WINDOW_S} s per path, '
          f'alternating; median [min, max]', flush=True)
    got = {'kernel': [], 'plain': []}
    share = {'kernel': [], 'plain': []}
    step = 100
    for rep in range(RATE_REPEATS):
        for path in (('kernel', 'plain') if rep % 2 == 0
                     else ('plain', 'kernel')):
            if path == 'plain':
                with plain_train_ops():
                    rate, sh, step = _train_rate(trainer, step)
            else:
                rate, sh, step = _train_rate(trainer, step)
            got[path].append(rate)
            share[path].append(sh)
    med = {k: statistics.median(v) for k, v in got.items()}
    print(f'  training faces/s at B={TRAIN_BATCH}: kernel {med["kernel"]:.2f} '
          f'[{min(got["kernel"]):.2f}, {max(got["kernel"]):.2f}]  plain '
          f'{med["plain"]:.2f} [{min(got["plain"]):.2f}, '
          f'{max(got["plain"]):.2f}]  ratio '
          f'{med["kernel"] / med["plain"]:.3f}; frozen-encode share of the '
          f'step: kernel {statistics.median(share["kernel"]):.3f}, plain '
          f'{statistics.median(share["plain"]):.3f}', flush=True)


def phase_ops():
    """The ops layer: K4 and the bare conv against their plain versions,
    then its main path with exact launch counts."""
    k4_rows = phase_k4()
    conv_rows = phase_conv_bias()
    return k4_rows, conv_rows, phase_ops_path()


# the whole-image path (bench.py:111-216's end-to-end workload): frames of
# 512x683, chunks of 16, upscale 2, w = 0.5, RetinaFace resnet50 and
# ParseNet in bf16, the serving phase's restorer
WI_FRAMES = 32
WI_HW = (512, 683)
WI_CHUNK = 16
WI_OFFSETS = ((-140.0, -170.0), (60.0, -170.0), (-140.0, 30.0),
              (60.0, 30.0))   # bench.py:132-135: 1..4 faces a frame
# detector check, bf16 backbone vs fp32 (TF32 off) on one chunk: each
# fp32 detection is matched to the bf16 detection of largest IoU. Read on
# an H100 (PERF.md): 33 of 34 matched (a score crossing the 0.8 threshold
# in bf16), median box error 0.015 px, landmarks 0.008 px; with the
# stride-8 anchors one cell off, 0.24 matched and medians 0.25 / 0.18 px
DET_MATCH_FLOOR = 0.75     # share of fp32 rows with an IoU >= 0.5 match
DET_ERR_BOUND = 0.1        # px, median box and landmark error of matches
# pipeline check, kernel path vs plain path (fp32 sums), mean |diff| of
# the final frames inside the face windows, uint8 levels, with the plain
# path held to the kernel path's codes (codes_held). Left to pick its own,
# it flips 2-3% of them (random weights give 1024 close logits a token),
# and the flips swamp the convs' rounding: a sound run read 2.89 and a K1
# halo fault 5.30. With the codes held, read on an H100 (PERF.md): sound
# 1.10 / 1.37 and the halo fault 4.15 / 5.01 at 1 / 4 faces a frame.
WI_FRAME_DIFF_BOUND = 2.5


def wi_landmarks(template, n_faces: int, h: int, w: int):
    return [template * 0.45 + np.array([w / 2 + ox, h / 2 + oy], np.float32)
            for ox, oy in WI_OFFSETS[:n_faces]]


def wi_detector_class():
    """A FaceDetector whose device graph runs and is waited for on every
    chunk, while the landmarks handed on are `n_faces` synthetic faces a
    frame at bench.py's offsets on `template` (random weights find no
    real faces); with n_faces None it is the real detector."""
    from codeformer_tpu_torch.pipeline.detector import FaceDetector

    class BenchDetector(FaceDetector):
        n_faces = None
        template = None

        def batched_detect_device_finish(self, frames_dev, det_hw, pending,
                                         *args, **kw):
            if self.n_faces is None:
                return super().batched_detect_device_finish(
                    frames_dev, det_hw, pending, *args, **kw)
            outs, valids, done = pending
            if done is not None:
                done.synchronize()          # the detection's work is timed
            b, h, w = frames_dev.shape[:3]
            det_scale = det_hw[0] / h
            dets = np.zeros((b, self.max_faces, 15), np.float32)
            vmask = np.zeros((b, self.max_faces), bool)
            for k, lm_f in enumerate(wi_landmarks(self.template,
                                                  self.n_faces, h, w)):
                lm = lm_f * det_scale
                dets[:, k, 0:4] = [lm[:, 0].min() - 30, lm[:, 1].min() - 60,
                                   lm[:, 0].max() + 30, lm[:, 1].max() + 40]
                dets[:, k, 4] = 0.99
                dets[:, k, 5:15] = lm.reshape(-1)
                vmask[:, k] = True
            return dets, vmask

    return BenchDetector


@torch.no_grad()
def tame_heads(model, x, targets=(('BboxHead', 1.0), ('LandmarkHead', 1.0),
                                  ('ClassHead', 2.0))):
    """Scale RetinaFace's three heads so their largest output on `x` is
    `target`: random weights give outputs in the 1e5s, so every score
    saturates at 0 or 1 and every box overflows, and a detector check
    would compare nothing. Trained weights keep heads in range."""
    feats = model.fpn(model.body(x))
    feats = [model.ssh1(feats[0]), model.ssh2(feats[1]),
             model.ssh3(feats[2])]
    for name, target in targets:
        heads = getattr(model, name)
        peak = max(float(h.conv1x1(f).float().abs().max())
                   for h, f in zip(heads, feats))
        for h in heads:
            h.conv1x1.weight.mul_(target / peak)
            h.conv1x1.bias.mul_(target / peak)


def det_check(det, det32, frames, det_hw, label) -> bool:
    """`det` (bf16) against `det32` (fp32, TF32 off) on one chunk: counts,
    matched share, box and landmark error of the matched rows, keep-bucket
    steps taken. Returns whether it is within the bounds."""
    from codeformer_tpu_torch.ops.nms import iou_matrix
    steps = []
    graph = det._graph

    def spy(hw, max_faces):
        steps.append(max_faces)
        return graph(hw, max_faces)

    with mock.patch.object(det, '_graph', spy):
        outs, valids = det.batched_detect_device(frames, det_hw)
    outs32, valids32 = det32.batched_detect_device(frames, det_hw)
    n, n32, matched, box_err, lm_err = 0, 0, 0, [], []
    for o, v, o32, v32 in zip(outs, valids, outs32, valids32):
        rows, rows32 = o[v], o32[v32]
        n, n32 = n + len(rows), n32 + len(rows32)
        if not len(rows) or not len(rows32):
            continue
        iou = iou_matrix(torch.from_numpy(rows32[:, :4]),
                         torch.from_numpy(rows[:, :4])).numpy()
        best = iou.argmax(1)
        ok = iou[np.arange(len(rows32)), best] >= 0.5
        matched += int(ok.sum())
        box_err.extend(np.abs(rows32[ok, :4] - rows[best[ok], :4]).max(1))
        lm_err.extend(np.abs(rows32[ok, 5:] - rows[best[ok], 5:]).max(1))
    share = matched / max(n32, 1)
    med_box = float(np.median(box_err)) if box_err else float('inf')
    med_lm = float(np.median(lm_err)) if lm_err else float('inf')
    inside = (n32 > 0 and share >= DET_MATCH_FLOOR
              and max(med_box, med_lm) <= DET_ERR_BOUND)
    print(f'  detector {label}: {n} detections (fp32 {n32}) in '
          f'{len(outs)} frames, keep buckets {steps}; matched '
          f'{share:.4f} (>= {DET_MATCH_FLOOR}); matched box error median '
          f'{med_box:.4f} max {max(box_err, default=float("nan")):.3f} px, '
          f'landmarks median {med_lm:.4f} max '
          f'{max(lm_err, default=float("nan")):.3f} px (medians <= '
          f'{DET_ERR_BOUND}): '
          f'{"within bounds" if inside else "OUT of bounds"}', flush=True)
    return inside


def shifted_level_priors(h, w):
    """Planted fault: the stride-8 level's anchors one cell to the right."""
    from codeformer_tpu_torch.ops.anchors import prior_boxes
    p = prior_boxes(h, w).copy()
    n0 = 2 * math.ceil(h / 8) * math.ceil(w / 8)
    p[:n0, 0] += 8.0 / w
    return p


def wi_rate(pipe, frames, collect: bool) -> float:
    """Frames/s of restore_frames_device over one window of at least
    RATE_WINDOW_S seconds (host clock, ending in a synchronize); in folder
    mode (`collect`) the per-face crops are collected and a tiny piece
    of each restored chunk is fetched, as bench.py does."""
    def run():
        faces = [] if collect else None
        out = pipe.restore_frames_device(frames, collect_faces=faces)
        for _, restored, _ in faces or ():
            restored[:1, ::64, ::64, 0].cpu()
        return out

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    iters = max(2, int(RATE_WINDOW_S / (time.perf_counter() - t0)) + 1)
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    torch.cuda.synchronize()
    return len(frames) * iters / (time.perf_counter() - t0)


@contextlib.contextmanager
def codes_held(model, codes: list, replay: bool):
    """Record the code indices of each forward of `model` into `codes`,
    or (`replay`) look up the recorded ones in their place, printing the
    share of the forward's own picks that agree."""
    get = model.quantize.get_codebook_feat
    calls = iter(codes) if replay else None

    def feat(indices, *args, **kw):
        if not replay:
            codes.append(indices)
            return get(indices, *args, **kw)
        held = next(calls)
        print(f"    codes held: the forward's own picks agree on "
              f'{float((indices == held).float().mean()):.4f}', flush=True)
        return get(held, *args, **kw)

    with mock.patch.object(model.quantize, 'get_codebook_feat', feat):
        yield


def wi_pipeline_check(pipe, chunk, n_faces: int):
    """One chunk, `n_faces` a frame, through the pipeline with K1/K2 on
    their kernels and on their plain versions (fp32 sums), the same
    frames and detections: the final frames within WI_FRAME_DIFF_BOUND
    inside the face windows and bit-identical outside, the restored
    crops equal to restore_device on the same crops, and every K1/K2
    call of the restorer on those crops within REL_RMS_BOUND of its plain
    version. A planted K1 halo fault must fail both the frames and the
    per-call check. Raises SystemExit on a failure."""
    from codeformer_tpu_torch.ops import conv3x3 as cv
    restorer = pipe.restorer
    pipe.detector.n_faces = n_faces

    codes = []

    def run(k1, k2):
        with mock.patch.multiple(cv, conv3x3_dots=takes_prepared(k1),
                                 downsample_dots=takes_prepared(k2)), \
                codes_held(restorer.model, codes, replay=True):
            return pipe.restore_frames_device(chunk)

    faces_k = []
    with codes_held(restorer.model, codes, replay=False):
        out_k = pipe.restore_frames_device(chunk, collect_faces=faces_k)
    plan = pipe.last_plan
    inside = torch.from_numpy(plan.windows_mask(out_k.shape)).cuda()
    crops, restored_k, counts = faces_k[0]
    same_restore = bool(torch.equal(
        restorer.restore_device(crops, w=0.5), restored_k))
    print(f'  pipeline, {n_faces} face(s) a frame: {len(chunk)} frames, '
          f'{sum(counts)} faces, m={plan.m}, w_edge {plan.w_edge}, windows '
          f'{plan.roi}^2; restored crops == restore_device on the same '
          f'crops: {same_restore}', flush=True)
    out_p = run(cv.conv3x3_dots_ref, cv.downsample_dots_ref)
    xn = restorer.normalize(crops)

    def check(label, out, k1, k2):
        """(frames within bounds, every call within bounds)"""
        win = (out.float() - out_p.float()).abs()[inside]
        same_out = bool(torch.equal(out[~inside], out_p[~inside]))
        print(f'  pipeline, {n_faces} face(s) a frame, {label} vs plain path '
              f'(fp32 sums): inside the windows mean |diff| '
              f'{float(win.mean()):.4f} (<= {WI_FRAME_DIFF_BOUND}) max '
              f'{float(win.max()):.0f} levels; outside bit-identical: '
              f'{same_out}', flush=True)
        worst = per_call(restorer.model, xn,
                         f'whole-image crops (m={plan.m}), {label}', k1, k2)
        return (same_out and float(win.mean()) <= WI_FRAME_DIFF_BOUND,
                max(worst.values()) <= REL_RMS_BOUND)

    if not (same_restore and all(check('kernels', out_k, cv.conv3x3_dots,
                                       cv.downsample_dots))):
        raise SystemExit(f'chip_smoke: the whole-image pipeline at '
                         f'{n_faces} face(s) a frame disagrees with its '
                         f'plain path')
    halo = k1_fault('halo act(b)')
    frames_ok, calls_ok = check('planted fault: K1 halo act(b)',
                                run(halo, cv.downsample_dots_ref), halo,
                                cv.downsample_dots_ref)
    if frames_ok or calls_ok:
        raise SystemExit(f'chip_smoke: the pipeline check at {n_faces} '
                         f'face(s) a frame lets the planted fault K1 halo '
                         f'act(b) pass ({"frames" if frames_ok else ""}'
                         f'{" per call" if calls_ok else ""})')


def phase_whole_image(restorer, profile: bool = False) -> dict:
    """The fused whole-image path (DeviceRestorePipeline) at full width:
    the detector check, the pipeline check at 1 and 4 faces a frame
    (kernel vs plain path, per-call K1/K2 on the restorer's own
    activations, planted faults), exact launch counts a chunk, frames/s
    (video 1 and 4 faces a frame, folder) of the kernel and plain paths,
    peak memory; with `profile` the device time a stage. Returns the
    launch counts of the main-path run."""
    from codeformer_tpu_torch.pipeline import detector as pdet
    from codeformer_tpu_torch.pipeline.device_pipeline import \
        DeviceRestorePipeline
    from codeformer_tpu_torch.pipeline.face_helper import FaceRestoreHelper
    t0 = time.perf_counter()
    h, w = WI_HW
    g = torch.Generator(device='cuda').manual_seed(0)
    frames = torch.randint(0, 256, (WI_FRAMES, h, w, 3), generator=g,
                           device='cuda', dtype=torch.uint8)
    det = wi_detector_class()('retinaface_resnet50', allow_random=True,
                              dtype=torch.bfloat16, device='cuda')
    helper = FaceRestoreHelper(
        2, face_size=512, det_model='retinaface_resnet50', use_parse=True,
        device='cuda', allow_random_weights=True, detector=det,
        det_dtype=torch.bfloat16, parse_dtype=torch.bfloat16)
    det.template = helper.face_template
    pipe = DeviceRestorePipeline(restorer, helper, upscale=2,
                                 frame_chunk=WI_CHUNK, w=0.5)
    _, det_hw = pipe._det_hw(h, w)
    det32 = pdet.FaceDetector('retinaface_resnet50', allow_random=True,
                              dtype=torch.float32, device='cuda')
    x = torch.nn.functional.pad(
        pdet.resize_linear(frames[:2].permute(0, 3, 1, 2).float(), det_hw),
        (0, det32._bucket(det_hw[1]) - det_hw[1],
         0, det32._bucket(det_hw[0]) - det_hw[0]))
    tame_heads(det32.model, x - torch.tensor(
        pdet._MEANS, device='cuda').reshape(1, 3, 1, 1))
    det.model.load_state_dict(det32.model.state_dict())
    print(f'whole-image path: {WI_FRAMES} frames of {h}x{w} (seeded, on the '
          f'card), chunks of {WI_CHUNK}, upscale 2, w=0.5, RetinaFace '
          f'resnet50 (heads tamed) and ParseNet bf16 at parse_res '
          f'{pipe.parse_res}, the serving restorer; set up in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)

    # 1. the detector: bf16 against fp32 on one chunk, and a planted fault
    chunk = frames[:WI_CHUNK]
    if not det_check(det, det32, chunk, det_hw, 'bf16 vs fp32'):
        raise SystemExit('chip_smoke: the bf16 detector disagrees with fp32')
    det._graphs.clear()
    with mock.patch.object(pdet, 'prior_boxes', shifted_level_priors):
        caught = not det_check(det, det32, chunk, det_hw,
                               'planted fault: stride-8 anchors one cell off')
    det._graphs.clear()
    if not caught:
        raise SystemExit('chip_smoke: the detector bounds let the planted '
                         'fault (shifted anchors) pass')
    del det32

    # 2. the pipeline, kernel path vs plain path, one chunk at 1 and at 4
    # faces a frame (m = 16 and 64)
    for n_faces in (1, 4):
        wi_pipeline_check(pipe, chunk, n_faces)

    # 3. the main path: exact launch counts, 1 then 4 faces a frame
    n_chunks = WI_FRAMES // WI_CHUNK
    n_res = count_resblocks(restorer.model, enable_fuse=True)
    counts = {}
    for n_faces in (1, 4):
        det.n_faces = n_faces
        reset_all_counts()
        out = pipe.restore_frames_device(frames)
        torch.cuda.synchronize()
        got = all_counts()
        want = {'conv3x3_dots': n_chunks * (2 * n_res + 1),
                'downsample_dots': n_chunks * 5}
        print(f'  main path, {n_faces} face(s) a frame: m={pipe.last_plan.m} '
              f'faces a chunk, one restorer forward a chunk; launches '
              f'{got} (expected K1/K2 {want})', flush=True)
        if {k: got[k] for k in want} != want or any(
                v for k, v in got.items() if k not in want):
            raise SystemExit('chip_smoke: whole-image launch counts differ')
        if out.shape != (WI_FRAMES, 2 * h, 2 * w, 3) or \
                out.dtype != torch.uint8:
            raise SystemExit(f'chip_smoke: bad whole-image output '
                             f'{tuple(out.shape)} {out.dtype}')
        for k in want:
            counts[k] = counts.get(k, 0) + got[k]
    del out

    # 4. frames/s, kernel and plain paths in alternating windows
    print(f'  frames/s of restore_frames_device ({WI_FRAMES} frames, '
          f'{n_chunks} chunks), TF32 off: {RATE_REPEATS} windows of >= '
          f'{RATE_WINDOW_S} s per path, alternating; median [min, max]',
          flush=True)
    for key, n_faces, collect in (('video_frames_per_sec', 1, False),
                                  ('video_frames_per_sec_4face', 4, False),
                                  ('whole_image_images_per_sec', 1, True)):
        det.n_faces = n_faces
        torch.cuda.reset_peak_memory_stats()
        got = {'kernel': [], 'plain': []}
        for rep in range(RATE_REPEATS):
            for path in (('kernel', 'plain') if rep % 2 == 0
                         else ('plain', 'kernel')):
                with (plain_ops() if path == 'plain'
                      else contextlib.nullcontext()):
                    got[path].append(wi_rate(pipe, frames, collect))
        med = {k: statistics.median(v) for k, v in got.items()}
        print(f'  {key} ({n_faces} face(s) a frame'
              f'{", folder mode" if collect else ""}): kernel '
              f'{med["kernel"]:.2f} [{min(got["kernel"]):.2f}, '
              f'{max(got["kernel"]):.2f}]  plain {med["plain"]:.2f} '
              f'[{min(got["plain"]):.2f}, {max(got["plain"]):.2f}]  ratio '
              f'{med["kernel"] / med["plain"]:.3f}; peak memory '
              f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB',
              flush=True)
    if profile:
        phase_whole_image_profile(pipe, frames)
    return counts


class StageClock:
    """CUDA events around each stage of a chunk (the pipeline's methods
    wrapped), with a synchronize before each, so an event pair spans that
    stage's device work alone."""
    STAGES = {'_detect_start': 'detect', '_warp': 'warp',
              '_parse_ids': 'parse', '_composite': 'composite'}

    def __init__(self, pipe):
        self.ms = {}
        self.pipe = pipe

    def wrap(self, name, fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            end.synchronize()
            self.ms.setdefault(name, []).append(start.elapsed_time(end))
            return out
        return timed

    @contextlib.contextmanager
    def on(self):
        restorer = self.pipe.restorer
        with contextlib.ExitStack() as stack:
            for attr, name in self.STAGES.items():
                stack.enter_context(mock.patch.object(
                    self.pipe, attr, self.wrap(name, getattr(self.pipe,
                                                             attr))))
            stack.enter_context(mock.patch.object(
                restorer, 'restore_device',
                self.wrap('restore', restorer.restore_device)))
            yield


def phase_whole_image_profile(pipe, frames, iters: int = 2):
    """Device time a stage (CUDA events, stages serialized) and the busy
    share of the unserialized run (torch.profiler), 1 and 4 faces a
    frame, kernel path."""
    from torch.profiler import ProfilerActivity, profile
    det = pipe.detector
    for n_faces in (1, 4):
        det.n_faces = n_faces
        clock = StageClock(pipe)
        with clock.on():
            for _ in range(iters):
                pipe.restore_frames_device(frames)
        chunks = iters * (WI_FRAMES // WI_CHUNK)
        per = {k: sum(v) / chunks for k, v in clock.ms.items()}
        total = sum(per.values())
        print(f'profile, whole-image path, {n_faces} face(s) a frame, per '
              f'chunk of {WI_CHUNK} (stages serialized, CUDA events): ' +
              ', '.join(f'{k} {v:.2f} ms ({100 * v / total:.1f}%)'
                        for k, v in per.items()) + f'; sum {total:.2f} ms',
              flush=True)
        pipe.restore_frames_device(frames)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                pipe.restore_frames_device(frames)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / iters * 1e3
        print_profile(f'whole-image path, {n_faces} face(s) a frame, '
                      f'{WI_FRAMES} frames', prof, iters, wall)


# the colorization and inpainting models at full width: the released
# configurations (codebook 1024 / 512, connect 32/64/128) as their CLIs
# call them (cli/inference_colorization.py, cli/inference_inpainting.py)
TASKS = {  # task: (codebook size, w, adain)
    'colorization': (1024, 0.0, True),
    'inpainting': (512, 1.0, False),
}
TASK_FACES = 8
# whole forward, kernel path vs plain path (fp32 sums) with the plain path
# held to the kernel path's codes (codes_held): mean |diff| of the
# restored images, uint8 levels. The serving bound. Read on an H100
# (PERF.md): sound 1.52 / 1.24 (colorization / inpainting), the K1 halo
# fault 11.70 / 4.49.
TASK_IMAGE_DIFF_BOUND = IMAGE_DIFF_BOUND


def task_faces(g, task: str, n: int) -> torch.Tensor:
    """Seeded uint8 RGB faces made on the card, (n, 512, 512, 3): smooth
    noise; gray (three equal channels) for colorization, with two pure
    white rectangles a face (the masked regions) for inpainting."""
    lo = torch.rand((n, 3, 16, 16), generator=g, device='cuda') * 255.0
    img = torch.nn.functional.interpolate(lo, scale_factor=32.0)
    img = img + 12.0 * torch.randn(img.shape, generator=g, device='cuda')
    img = img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    if task == 'colorization':
        return img[..., 1:2].expand(-1, -1, -1, 3).contiguous()
    img = img.contiguous()
    corners = torch.randint(64, 384, (n, 2, 2), generator=g, device='cuda')
    for i, rects in enumerate(corners.tolist()):
        for y, x in rects:
            img[i, y:y + 64, x:x + 96] = 255
    return img


def held_forward(model, xn, fwd: dict, k1, k2, codes: list, replay: bool):
    """One forward (fwd: w, adain, enable_fuse) with K1/K2 served by (k1,
    k2), its code picks recorded into `codes` or (`replay`) replaced by
    the recorded ones. Returns (out, logits, lq_feat)."""
    from codeformer_tpu_torch.ops import conv3x3 as cv
    k1 = k1 if k1 is cv.conv3x3_dots else takes_prepared(k1)
    k2 = k2 if k2 is cv.downsample_dots else takes_prepared(k2)
    with torch.inference_mode(), mock.patch.multiple(
            cv, conv3x3_dots=k1, downsample_dots=k2), \
            codes_held(model, codes, replay):
        return model(xn, **fwd)


def task_forward_check(restorer, label, got, ref) -> bool:
    """`got` (out, logits, lq_feat) against the plain path's `ref`, both
    on the same codes: lq_feat and logits rel RMS, the restored images'
    mean |diff|. Returns whether all are within bounds."""
    img = restorer.denormalize(got[0]).float()
    diff = (img - restorer.denormalize(ref[0]).float()).abs()
    r = dict(lq=rel_rms(got[2], ref[2]), logits=rel_rms(got[1], ref[1]),
             diff=float(diff.mean()))
    inside = (max(r['lq'], r['logits']) <= SLICE_REL_BOUND
              and r['diff'] <= TASK_IMAGE_DIFF_BOUND)
    print(f'  whole forward, {label} vs plain (fp32 sums, codes held): '
          f'lq_feat rel_rms {r["lq"]:.3g}, logits rel_rms {r["logits"]:.3g} '
          f'(<= {SLICE_REL_BOUND}); image diff mean {r["diff"]:.4f} (<= '
          f'{TASK_IMAGE_DIFF_BOUND}) max {float(diff.max()):.0f} levels, '
          f'{float((diff > 2).float().mean()):.4f} of values off by > 2: '
          f'{"within bounds" if inside else "OUT of bounds"}', flush=True)
    return inside


def phase_tasks() -> dict:
    """The colorization and inpainting restorers at full width (dim_embd
    512, 9 layers, 8 heads, nf 64), seeded random weights, SFT tamed,
    bf16: exact launch counts through restore_batch (and, for
    inpainting, the white-mask composite keeping every other pixel of
    the input), the whole forward kernel vs plain with the codes held,
    every K1/K2 call of one forward on its own activations, the planted
    K1 halo fault failing both checks, and faces/s at B=1 and 8. Returns
    the launch counts of the restore_batch runs."""
    from codeformer_tpu_torch.cli.inference_inpainting import \
        white_mask_composite
    from codeformer_tpu_torch.ops import conv3x3 as cv
    from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer
    g = torch.Generator(device='cuda').manual_seed(2)
    counts = {}
    for task, (codebook, w, adain) in TASKS.items():
        t0 = time.perf_counter()
        restorer = CodeFormerRestorer(device='cuda', codebook_size=codebook,
                                      connect_list=('32', '64', '128'),
                                      seed=1)
        tame_sft(restorer.model)
        model = restorer.model
        fwd = dict(w=w, adain=adain, enable_fuse=w > 0)
        n_res = count_resblocks(model, enable_fuse=w > 0)
        faces = task_faces(g, task, TASK_FACES)
        print(f'{task}: full width (dim_embd 512, 9 layers, 8 heads, nf 64, '
              f'{codebook} codes, connect 32/64/128), bf16, seeded random '
              f'init, SFT tamed, in {time.perf_counter() - t0:.1f} s; w={w}, '
              f'adain={adain}: {n_res} ResBlocks a forward', flush=True)

        # 1. the CLI's call: restore_batch, exact launches
        bgr = [f[..., ::-1].copy() for f in faces[:3].cpu().numpy()]
        reset_all_counts()
        out = restorer.restore_batch(bgr, w=w, adain=adain)
        torch.cuda.synchronize()
        got = all_counts()
        want = {'conv3x3_dots': 2 * n_res + 1, 'downsample_dots': 5}
        print(f'  restore_batch, 3 faces: launches {got} (expected K1/K2 '
              f'{want})', flush=True)
        if {k: got[k] for k in want} != want or any(
                v for k, v in got.items() if k not in want):
            raise SystemExit(f'chip_smoke: {task} launch counts differ (a '
                             f'failed chunk passes through)')
        for k in want:
            counts[k] = counts.get(k, 0) + got[k]
        for face, o in zip(bgr, out):
            if o.shape != face.shape or o.dtype != np.uint8 or \
                    np.array_equal(o, face):
                raise SystemExit(f'chip_smoke: bad {task} output')
        if task == 'inpainting':
            kept, white_px = True, 0
            for face, o in zip(bgr, out):
                white = (face == 255).all(axis=-1)
                comp = white_mask_composite(face, o)
                white_px += int(white.sum())
                kept &= bool(np.array_equal(comp[~white], face[~white])
                             and np.array_equal(comp[white], o[white]))
            print(f'  white-mask composite: {white_px} masked pixels take '
                  f'the output, every other pixel equals the input bit for '
                  f'bit: {kept}', flush=True)
            if not kept or not white_px:
                raise SystemExit('chip_smoke: the inpainting composite '
                                 'changed an unmasked pixel')

        # 2. the whole forward and every call of it, kernels vs plain
        xn = restorer.normalize(faces[:2])
        codes = []
        kern = held_forward(model, xn, fwd, cv.conv3x3_dots,
                            cv.downsample_dots, codes, replay=False)
        img_std = float(restorer.denormalize(kern[0]).float().std())
        print(f'  kernel-path forward, B=2: image std {img_std:.2f} levels '
              f'(>= {MIN_IMAGE_STD})', flush=True)
        if img_std < MIN_IMAGE_STD or not all(
                torch.isfinite(t.float()).all() for t in kern):
            raise SystemExit(f'chip_smoke: the {task} forward is constant '
                             f'or not finite')
        plain = held_forward(model, xn, fwd, cv.conv3x3_dots_ref,
                             cv.downsample_dots_ref, codes, replay=True)
        worst = per_call(model, xn, f'{task} B=2, kernels', cv.conv3x3_dots,
                         cv.downsample_dots, **fwd)
        if not task_forward_check(restorer, 'kernels', kern, plain) \
                or max(worst.values()) > REL_RMS_BOUND:
            raise SystemExit(f'chip_smoke: the {task} forward disagrees with '
                             f'its plain version')
        halo = k1_fault('halo act(b)')
        faulty = held_forward(model, xn, fwd, halo, cv.downsample_dots_ref,
                              codes, replay=True)
        whole_ok = task_forward_check(restorer,
                                      'planted fault: K1 halo act(b)',
                                      faulty, plain)
        worst = per_call(model, xn, f'{task} B=2, planted fault: K1 halo '
                         f'act(b)', halo, cv.downsample_dots_ref, **fwd)
        if whole_ok or worst['conv3x3_dots'] <= REL_RMS_BOUND:
            raise SystemExit(f'chip_smoke: the {task} checks let the planted '
                             f'fault K1 halo act(b) pass')
        del kern, plain, faulty

        # 3. faces/s
        phase_rates(restorer, [faces[:1], faces], w=w, adain=adain,
                    label=task)
        del restorer, model
        torch.cuda.empty_cache()
    return counts


# the classic per-stage path's device stages (cli/whole_image.py
# _run_classic): the whole-image phase's frame size, upscale 2, 1 and 4
# faces at bench.py's offsets; parse in fp32 (the classic path's dtype)
CLASSIC_UP = 2
# share of class ids equal to the CPU copy's; read 0.999996 on an H100
PARSE_AGREE_FLOOR = 0.999
# paste_faces on the card against the same call on CPU copies (both fp32):
# mean |diff| inside the face windows, uint8 levels (the results are
# truncated, so a sum in another order can move a pixel by one level).
# Read on an H100 (PERF.md): under 5e-5 (max 1 level) in all eight
# configurations; an inverse affine 1 px off reads 1.72 to 3.25.
PASTE_DIFF_BOUND = 0.05
PASTE_MARGIN = 8           # px around each face's box: its window


def paste_windows(inv_affines, face: int, hw) -> np.ndarray:
    """(h, w) bool: inside some face's bounding box on the canvas, plus
    PASTE_MARGIN. Outside it paste_faces returns the canvas (the soft
    edge stays inside the warped face, device_pipeline.py's argument)."""
    inside = np.zeros(hw, bool)
    corners = np.array([[0, 0, 1], [face, 0, 1], [0, face, 1],
                        [face, face, 1]], np.float64)
    for ia in inv_affines:
        c = corners @ np.asarray(ia, np.float64).T
        y0, x0 = (np.floor(c.min(0)) - PASTE_MARGIN).astype(int)[::-1]
        y1, x1 = (np.ceil(c.max(0)) + PASTE_MARGIN).astype(int)[::-1]
        inside[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = True
    return inside


def phase_classic(restorer) -> dict:
    """The classic path's device stages on the card: the crops through
    restore_batch (exact launches), `_parse_masks` in fp32 against a CPU
    copy, `paste_faces` with use_parse and draw_box on and off against
    the same call on CPU copies (inside the face windows within
    PASTE_DIFF_BOUND, outside bit-identical to the upscaled canvas; an
    inverse affine shifted by one pixel must fail), ms a frame and peak
    memory. Returns the launch counts of the restore_batch runs."""
    from codeformer_tpu_torch.ops.geometry import (estimate_similarity,
                                                   invert_affine,
                                                   resize_linear, warp_affine)
    from codeformer_tpu_torch.pipeline.compositor import paste_faces
    from codeformer_tpu_torch.pipeline.face_helper import FaceRestoreHelper
    t0 = time.perf_counter()
    h, w = WI_HW
    up = CLASSIC_UP
    g = torch.Generator(device='cuda').manual_seed(3)
    lo = torch.rand((1, 3, h // 16, w // 16), generator=g, device='cuda')
    frame = torch.nn.functional.interpolate(lo * 255.0, size=(h, w),
                                            mode='bilinear')
    frame = frame + 8.0 * torch.randn(frame.shape, generator=g,
                                      device='cuda')
    frame = frame.clamp(0, 255).round()
    # the classic path upscales with cv2 on the host; the card's machine
    # has no cv2, so the canvas here is the same linear upscale on the card
    canvas = resize_linear(frame, (h * up, w * up)).round().clamp(0, 255) \
        .to(torch.uint8)[0].permute(1, 2, 0).contiguous()
    frame = frame.to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    canvas_np = canvas.cpu().numpy()
    kw = dict(use_parse=True, allow_random_weights=True, detector=object(),
              parse_dtype=torch.float32)
    helper = FaceRestoreHelper(up, device='cuda', **kw)
    helper_cpu = FaceRestoreHelper(up, device='cpu', **kw)
    helper_cpu._parse_model.load_state_dict(helper._parse_model.state_dict())
    template = helper.face_template
    n_res = count_resblocks(restorer.model, enable_fuse=True)
    print(f'classic path: a {h}x{w} frame (seeded, on the card), canvas '
          f'{h * up}x{w * up}, 1 and 4 faces at bench.py\'s offsets, the '
          f'serving restorer, ParseNet fp32; set up in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    counts = {}
    for n_faces in (1, 4):
        lms = wi_landmarks(template, n_faces, h, w)
        affines = [estimate_similarity(lm, template) for lm in lms]
        crops = warp_affine(frame, np.stack(affines), (512, 512),
                            border_value=(135.0, 133.0, 132.0),
                            img_idx=torch.zeros(n_faces, dtype=torch.long,
                                                device='cuda'))
        crops = list(torch.round(crops).clamp(0, 255).to(torch.uint8)
                     .cpu().numpy())
        reset_all_counts()
        restored = restorer.restore_batch(crops, w=0.5, adain=True)
        torch.cuda.synchronize()
        got = all_counts()
        want = {'conv3x3_dots': 2 * n_res + 1, 'downsample_dots': 5}
        print(f'  {n_faces} face(s): restore_batch launches {got} (expected '
              f'K1/K2 {want})', flush=True)
        if {k: got[k] for k in want} != want or any(
                v for k, v in got.items() if k not in want) or any(
                np.array_equal(r, c) for r, c in zip(restored, crops)):
            raise SystemExit('chip_smoke: classic-path launch counts differ '
                             '(a failed chunk passes through)')
        for k in want:
            counts[k] = counts.get(k, 0) + got[k]

        pids = helper._parse_masks(restored)
        if n_faces == 4:
            pids_cpu = helper_cpu._parse_masks(restored)
            agree = float((pids == pids_cpu).mean())
            print(f'  _parse_masks fp32, card vs CPU copy, {n_faces} faces: '
                  f'class ids agree on {agree:.6f} (>= {PARSE_AGREE_FLOOR})',
                  flush=True)
            if agree < PARSE_AGREE_FLOOR:
                raise SystemExit('chip_smoke: _parse_masks on the card '
                                 'disagrees with its CPU copy')
        ias = []
        for a in affines:
            ia = invert_affine(a, up)
            ia[:, 2] += 0.5 * up       # the helper's extra offset
            ias.append(ia.astype(np.float32))
        inside = paste_windows(ias, 512, canvas_np.shape[:2])
        for use_parse in (False, True):
            for draw_box in (False, True):
                args = (restored, ias, pids if use_parse else None, up,
                        draw_box)
                out_c = paste_faces(canvas_np, *args, device='cpu')
                label = (f'{n_faces} face(s), use_parse {use_parse}, '
                         f'draw_box {draw_box}')
                for fault in (False, True):
                    shifted = [ia + np.float32([[0, 0, 1], [0, 0, 0]])
                               for ia in ias] if fault else ias
                    out_g = paste_faces(canvas_np, restored, shifted,
                                        *args[2:], device='cuda')
                    d = np.abs(out_g.astype(np.float32)
                               - out_c.astype(np.float32))
                    same = bool(np.array_equal(out_g[~inside],
                                               canvas_np[~inside])
                                and np.array_equal(out_c[~inside],
                                                   canvas_np[~inside]))
                    ok = same and float(d[inside].mean()) <= PASTE_DIFF_BOUND
                    print(f'  paste_faces, {label}'
                          f'{", planted fault: inverse affine 1 px off" if fault else ""}'
                          f': card vs CPU copy inside the windows mean |diff| '
                          f'{float(d[inside].mean()):.6f} (<= '
                          f'{PASTE_DIFF_BOUND}) max {d.max():.0f} levels; '
                          f'outside == the canvas: {same}', flush=True)
                    if ok == fault:
                        raise SystemExit(
                            f'chip_smoke: paste_faces ({label}) '
                            f'{"lets the planted fault pass" if fault else "disagrees with its CPU copy"}')
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: paste_faces(canvas_np, restored, ias, pids, up,
                                         device='cuda'), iters=5, runs=5)
        print(f'  paste_faces on the card, {n_faces} face(s), use_parse, '
              f'canvas {h * up}x{w * up}: {ms:.3f} ms a frame '
              f'{ms.spread()} (the whole call: faces and parse ids up, the '
              f'frame back); peak memory '
              f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB',
              flush=True)
    return counts


def phase_vqgan():
    """VQAutoEncoder.forward (encode -> quantize -> decode) at full width
    (nf 64, ch_mult 1,2,2,4,4,8, 1024 codes of 256), bf16, B=2, seeded:
    exact launches (K1, K2, one K3), the reconstruction against the plain
    path's (K1/K2 plain with fp32 sums, K3 plain, the codes held to the
    kernel path's). Returns
    (launch counts, the quantizer's input and codebook, for the one
    device activity of its K3 call taken at the end)."""
    from codeformer_tpu_torch.models.vqgan import VQAutoEncoder
    from codeformer_tpu_torch.nn.blocks import ResBlock
    from codeformer_tpu_torch.ops import conv3x3 as cv
    from codeformer_tpu_torch.ops import vq
    from codeformer_tpu_torch.utils.checkpoint import init_params_fast
    model = init_params_fast(VQAutoEncoder(), 4).cuda().eval() \
        .requires_grad_(False)
    n_res = sum(isinstance(m, ResBlock) for m in model.modules())
    x = torch.from_numpy(np.stack(_faces(np.random.default_rng(4), 2))) \
        .cuda()
    xn = (x.float() / 127.5 - 1.0).to(torch.bfloat16).permute(0, 3, 1, 2)
    reset_all_counts()
    with torch.inference_mode():
        out_k, loss_k, stats_k = model(xn)
    torch.cuda.synchronize()
    got = all_counts()
    want = {'conv3x3_dots': 2 * n_res + 1, 'downsample_dots': 5,
            'nearest_code': 1}
    print(f'VQAutoEncoder.forward, full width, bf16, B=2: launches {got} '
          f'(expected {want}); codebook loss {float(loss_k):.5g}, '
          f'perplexity {float(stats_k["perplexity"]):.4g}', flush=True)
    if {k: got[k] for k in want} != want or any(
            v for k, v in got.items() if k not in want):
        raise SystemExit('chip_smoke: VQAutoEncoder launch counts differ')
    idx_k = stats_k['min_encoding_indices']
    agree = []

    def held(z, e):
        agree.append(float((vq._nearest_code_ref(z, e) == idx_k)
                           .float().mean()))
        return idx_k

    with torch.inference_mode(), mock.patch.multiple(
            cv, conv3x3_dots=takes_prepared(cv.conv3x3_dots_ref),
            downsample_dots=takes_prepared(cv.downsample_dots_ref)), \
            mock.patch.object(vq, 'nearest_code_indices', held):
        out_r, loss_r, _ = model(xn)
    img_k = (out_k.float().clamp(-1, 1) + 1) * 127.5
    diff = (img_k - (out_r.float().clamp(-1, 1) + 1) * 127.5).abs()
    std = float(img_k.std())
    inside = (float(diff.mean()) <= IMAGE_DIFF_BOUND and std >= MIN_IMAGE_STD
              and agree[0] >= INDEX_AGREEMENT_FLOOR
              and bool(torch.isfinite(out_k.float()).all()))
    print(f'  reconstruction vs plain (K1/K2 fp32 sums, K3 plain; codes '
          f'held): mean |diff| {float(diff.mean()):.4f} (<= '
          f'{IMAGE_DIFF_BOUND}) max {float(diff.max()):.0f} levels, image std '
          f'{std:.2f} (>= {MIN_IMAGE_STD}); the plain path\'s own picks agree '
          f'on {agree[0]:.4f} (>= {INDEX_AGREEMENT_FLOOR}); codebook loss '
          f'{float(loss_k):.5g} vs {float(loss_r):.5g}: '
          f'{"within bounds" if inside else "OUT of bounds"}', flush=True)
    if not inside:
        raise SystemExit('chip_smoke: VQAutoEncoder disagrees with its plain '
                         'version')
    with torch.inference_mode():
        z, _ = model.encoder(xn)
    z_flat = z.float().permute(0, 2, 3, 1).reshape(-1, z.shape[1]) \
        .contiguous()
    return got, (z_flat, model.quantize.embedding.weight)


def vqgan_activities(probe) -> None:
    """One device activity a K3 call of VQAutoEncoder.forward's quantizer
    (its input and kept codebook), by torch.profiler."""
    from codeformer_tpu_torch.ops import vq
    z_flat, codebook = probe
    acts, ms = device_launches(
        lambda: vq.nearest_code_indices(z_flat, codebook))
    print(f'VQAutoEncoder quantizer, T={len(z_flat)}: {acts:.2f} device '
          f'activities a K3 call (expected 1), {ms:.4f} ms a launch '
          f'(profiler)', flush=True)
    if acts != 1.0:
        raise SystemExit('chip_smoke: the VQAutoEncoder K3 call is more than '
                         'one device activity')


KERNEL_SOURCES = {  # name: (source, the TPU kernel it replaces)
    'conv3x3_dots': ('codeformer_tpu_torch/csrc/conv3x3_dots.cu',
                     'codeformer_tpu/ops/colpack_conv.py:376'),
    'downsample_dots': ('codeformer_tpu_torch/csrc/downsample_dots.cu',
                        'codeformer_tpu/ops/colpack_conv.py:586'),
    'nearest_code': ('codeformer_tpu_torch/csrc/nearest_code.cu',
                     'codeformer_tpu/ops/vq.py:40'),
    'fused_lrelu_fwd': ('codeformer_tpu_torch/csrc/fused_act.cu',
                        'codeformer_tpu/ops/fused_act.py:37'),
    'fused_lrelu_bwd': ('codeformer_tpu_torch/csrc/fused_act.cu',
                        'codeformer_tpu/ops/fused_act.py:66'),
    'conv3x3_bias': ('codeformer_tpu_torch/csrc/conv3x3_bias.cu',
                     'codeformer_tpu/ops/colpack_conv.py:137; '
                     'codeformer_tpu/ops/pallas_conv.py:101; '
                     'codeformer_tpu/ops/imgpair_conv.py:117 (:158)'),
}


def main():
    phase_card()
    sys.path.insert(0, ROOT)
    phase_build()
    results = phase_kernels()
    k3_rows, k3_calls = phase_k3()
    k4_rows, conv_rows, ops_counts = phase_ops()
    serve_counts, restorer = phase_slice()
    if '--profile' in sys.argv[1:]:
        phase_profile(restorer)
    whole_counts = phase_whole_image(restorer,
                                     profile='--profile' in sys.argv[1:])
    classic_counts = phase_classic(restorer)
    del restorer
    torch.cuda.empty_cache()
    task_counts = phase_tasks()
    vq_counts, vq_probe = phase_vqgan()
    train_counts, trainer = phase_train()
    if '--profile' in sys.argv[1:]:
        phase_train_profile(trainer)
    print(f'main-path launches: serving {serve_counts}; whole-image path '
          f'{whole_counts}; classic path {classic_counts}; colorization and '
          f'inpainting {task_counts}; VQAutoEncoder {vq_counts}; stage-II '
          f'training {train_counts}; ops path {ops_counts}')
    phase_k3_activities(k3_calls)
    vqgan_activities(vq_probe)
    del k3_calls, vq_probe
    # head row of each kernel: K1/K2 the 512^2 shape, K3 the path's T,
    # K4 and the bare conv the ops path's shape
    results['nearest_code'] = [r for r in k3_rows
                               if r['tokens'] == K3_PATH_TOKENS] + k3_rows
    results['fused_lrelu_fwd'] = [
        dict(r, library_ms=None, **r['fwd_bound']) for r in k4_rows]
    results['fused_lrelu_bwd'] = [
        dict(r, max_abs_err=r['bwd_max_abs_err'], ms=r['bwd_ms'],
             plain_ms=r['bwd_plain_ms'], library_ms=None, **r['bwd_bound'])
        for r in k4_rows]
    results['conv3x3_bias'] = conv_rows
    kernels = []
    for name, rows in results.items():
        head = rows[0]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': KERNEL_SOURCES[name][0],
            'replaces': KERNEL_SOURCES[name][1],
            'launches': sum(c.get(name, 0) for c in
                            (serve_counts, whole_counts, classic_counts,
                             task_counts, vq_counts, train_counts,
                             ops_counts)),
            'max_abs_err': max(r['max_abs_err'] for r in rows),
            'ms': head['ms'], 'plain_ms': head['plain_ms'],
            'bound_ms': head['bound_ms'], 'bound_by': head['bound_by'],
            'library_ms': head['library_ms']})
    print('call_ms (the whole public call; ms above is the launch on '
          'prepared operands): ' + '; '.join(
              f'{name} {rows[0]["call_ms"]:.4f} (launch {rows[0]["ms"]:.4f})'
              for name, rows in results.items() if 'call_ms' in rows[0]))
    if not all(k['launches'] > 0 for k in kernels):
        raise SystemExit('chip_smoke: a kernel of the path never launched')
    if train_counts['nearest_code'] == 0 or vq_counts['nearest_code'] == 0 \
            or not all(c[k] > 0 for c in (serve_counts, whole_counts,
                                          classic_counts, task_counts,
                                          vq_counts)
                       for k in ('conv3x3_dots', 'downsample_dots')) \
            or not all(ops_counts[k] > 0 for k in (
                'conv3x3_bias', 'fused_lrelu_fwd', 'fused_lrelu_bwd')):
        raise SystemExit('chip_smoke: a kernel never launched on its path')
    print(card_line())
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()

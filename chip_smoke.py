#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (codeformer_tpu_torch).

    python3 chip_smoke.py            # one GPU; a few minutes on an H100
    python3 chip_smoke.py --profile  # plus torch.profiler breakdowns of a
                                     # serving forward and a training step

Phases, in order; any failure raises and the script exits non-zero:
  1. card and versions (needs a CUDA card of compute capability 9.0);
  2. build the hand-written kernels from codeformer_tpu_torch/csrc/;
  3. K1/K2 against their plain PyTorch versions at the serving path's
     shapes (B=2, bf16 inputs; reference in fp32 with TF32 off), their
     GroupNorm partials against torch.sum, planted faults that the
     bounds must reject, and kernel vs plain times;
  4. K3 (nearest code) against its plain version at the training path's
     token counts on three codebooks (exact lowest index on duplicated
     rows), planted faults that must fail, kernel vs plain times;
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
  6. training: stage II (CodeFormerIdxModel) at the full width of
     options/CodeFormer_stage2.yml, bf16, B=4: 8 steps with exact launch
     counts (K1/K2/K3 in the frozen HQ encode only), a falling loss,
     gradients at the encoder, frozen modules unchanged; idx_gt against
     the plain-op encode (and a planted fault); training faces/s of the
     kernel and plain paths; peak memory.
The last line is the JSON result; the line before it lists the kernels,
each with its launches on the main paths, its time, its plain version's,
the least time the card could take for the same work (bound_ms) and,
where one PyTorch call computes the same function, that call's time.
"""
from __future__ import annotations

import contextlib
import functools
import json
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
# the stats partials are fp32 sums of the same rounded y in another order
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
K1_CASES = [  # (H=W, Cin, Cout, act, skip, Cs)
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
K2_CASES = [(512, 64), (256, 128), (128, 128), (64, 256), (32, 256)]
BATCH = 2


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_rms(got: torch.Tensor, ref: torch.Tensor) -> float:
    d = (got.float() - ref.float()).pow(2).mean().sqrt()
    return float(d / ref.float().pow(2).mean().sqrt().clamp_min(1e-12))


def k1_fault(kind: str):
    """A deliberately wrong plain K1 with conv3x3_dots' signature, as a
    control the bounds must catch: 'bf16 prologue' evaluates a*x+b and
    the activation in bf16 arithmetic; 'halo act(b)' pads the activated
    map with act(b) instead of 0 (the fault of folding the prologue into
    the load without masking the halo)."""
    import torch.nn.functional as F
    from codeformer_tpu_torch.ops import conv3x3 as cv

    def run(x, a, b, act, weight, bias, skip=None, w1x1=None):
        def f(t):
            return F.silu(t) if act == 'silu' else t
        a4, b4 = a[:, None, None], b[:, None, None]
        if kind == 'bf16 prologue':
            h = f(x * a4.to(x.dtype) + b4.to(x.dtype)).float()
            h = F.pad(h.permute(0, 3, 1, 2), (1, 1, 1, 1))
        elif kind == 'halo act(b)':
            inner = f(x.float() * a4 + b4).to(x.dtype).float()
            bsz, hh, ww, c = x.shape
            h = f(b).to(x.dtype).float()[:, :, None, None] \
                .expand(bsz, c, hh + 2, ww + 2).clone()
            h[:, :, 1:-1, 1:-1] = inner.permute(0, 3, 1, 2)
        else:
            raise ValueError(kind)
        y = F.conv2d(h, weight.to(x.dtype).float(), bias.float())
        y = y.permute(0, 2, 3, 1)
        if skip is not None:
            s = skip.float()
            if w1x1 is not None:
                s = s @ w1x1.reshape(w1x1.shape[0], -1).to(x.dtype) \
                    .float().t()
            y = y + s
        y = y.to(x.dtype)
        return y, cv.channel_stats(y)
    return run


def k2_fault(x, weight, bias):
    """A deliberately wrong plain K2: PyTorch's symmetric padding=1 in
    place of the reference's (0,1,0,1)."""
    import torch.nn.functional as F
    y = F.conv2d(x.float().permute(0, 3, 1, 2), weight.to(x.dtype).float(),
                 bias.float(), stride=2, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


K1_FAULTS = ('bf16 prologue', 'halo act(b)')

# K3 (nearest code): tokens at the stage-II shape (B*256 for B = 1, 4,
# 16) and a generate_latent_gt-sized run; D and K of every shipped config
K3_TOKENS = (256, 1024, 4096, 16384)
K3_DIM, K3_CODES = 256, 1024
K3_PATH_TOKENS = 1024     # stage II at batch_size_per_gpu 4
# Kernel and plain version sum the same fp32 products in other orders, so
# they may pick different codes only where two distances are within fp32
# rounding. Every disagreement must pick a code whose exact (fp64)
# squared distance is within this relative margin of the exact minimum.
K3_MARGIN = 1e-5
K3_FAULTS = ('ties to the highest index', 'e_sq dropped')


def k3_fault(kind: str):
    """A deliberately wrong plain K3 with nearest_code_indices' signature,
    as a control the K3 checks must catch."""
    from codeformer_tpu_torch.ops import vq

    def run(z, e):
        with vq._fp32_matmul():
            dot = z @ e.t()
        if kind == 'ties to the highest index':
            d = e.square().sum(1)[None] - 2.0 * dot
            return e.shape[0] - 1 - d.flip(1).argmin(1)
        if kind == 'e_sq dropped':
            return (-2.0 * dot).argmin(1)
        raise ValueError(kind)
    return run


def k3_codebooks(g):
    """{name: (K, D) fp32}: the init scale (uniform +-1/K, the random-init
    codebook of the training path), a unit-scale one, and one whose 1024
    rows are 256 distinct rows each repeated 4 times at scattered places
    (exact ties)."""
    k, d = K3_CODES, K3_DIM
    base = torch.randn(k // 4, d, generator=g, device='cuda')
    dup_of = torch.randperm(k, generator=g, device='cuda') % (k // 4)
    return {'init scale': (torch.rand(k, d, generator=g, device='cuda')
                           * 2 - 1) / k,
            'unit scale': torch.randn(k, d, generator=g, device='cuda'),
            'duplicated rows': base[dup_of].contiguous()}, dup_of


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


def phase_k3():
    """K3 against its plain version (fp32, TF32 off) at the path's token
    counts on three codebooks; planted faults that must fail; kernel vs
    plain times (CUDA events, median of 20 after 3 warm-ups)."""
    from codeformer_tpu_torch.ops import vq
    g = torch.Generator(device='cuda').manual_seed(3)
    books, dup_of = k3_codebooks(g)
    print(f'K3 checks: D={K3_DIM}, K={K3_CODES}, z ~ N(0, 1) fp32; ref = '
          f'plain version (fp32, TF32 off); a disagreement must be within '
          f'{K3_MARGIN} of the exact (fp64) minimum distance; on duplicated '
          f'rows every pick must be the lowest index', flush=True)
    rows = []
    caught = {k: set() for k in K3_FAULTS}
    for n_tok in K3_TOKENS:
        z = torch.randn(n_tok, K3_DIM, generator=g, device='cuda')
        for name, e in books.items():
            dup = dup_of if name == 'duplicated rows' else None
            got = vq.nearest_code_indices(z, e)
            torch.cuda.synchronize()
            ref = vq._nearest_code_ref(z, e)
            r = k3_verdict(got, ref, z, e, dup)
            faults = {k: k3_verdict(k3_fault(k)(z, e), ref, z, e, dup)['ok']
                      for k in K3_FAULTS}
            line = (f'  K3 T={n_tok:5d} {name:15s} agreement '
                    f'{r["agree"]:.6f}, worst disagreement gap '
                    f'{r["worst_gap"]:.3g} (<= {K3_MARGIN}), max abs '
                    f'distance gap {r["max_abs"]:.3g}, lowest index on ties '
                    f'{r["lowest"]}: {"ok" if r["ok"] else "FAIL"}')
            if name == 'init scale':
                ms = time_ms(lambda: vq.nearest_code_indices(z, e))
                pms = time_ms(lambda: vq._nearest_code_ref(z, e))
                line += f'  kernel {ms:.4f} ms  plain {pms:.4f} ms'
                rows.append(dict(tokens=n_tok, max_abs_err=r['max_abs'],
                                 ms=ms, plain_ms=pms, library_ms=None,
                                 **bound(2 * n_tok * K3_CODES * K3_DIM,
                                         4 * (n_tok + K3_CODES) * K3_DIM
                                         + 4 * n_tok, FP32_FLOPS)))
            print(line + '; planted faults: ' + ', '.join(
                f'{k} {"passes" if v else "fails"}'
                for k, v in faults.items()), flush=True)
            if not r['ok']:
                raise SystemExit(f'chip_smoke: K3 T={n_tok} {name} disagrees '
                                 f'with its plain version')
            for k, v in faults.items():
                if not v:
                    caught[k].add(n_tok)
    for k in K3_FAULTS:
        if caught[k] != set(K3_TOKENS):
            raise SystemExit(f'chip_smoke: the K3 checks let the planted '
                             f'fault "{k}" pass at T = '
                             f'{sorted(set(K3_TOKENS) - caught[k])}')
    print('  K3 planted faults fail the checks at every T, as they must',
          flush=True)
    return rows


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


def k1_bound(b, h, cin, cout, skip, cs) -> dict:
    """K1 at B x h^2: x, skip and y once in bf16, the weights, a, b and
    the stats partials once; the 3x3 (and 1x1) products on the tensor
    cores."""
    pix = b * h * h
    flops = 2 * pix * 9 * cin * cout
    nbytes = 2 * pix * (cin + cout) + 2 * 9 * cin * cout + 8 * b * cin \
        + 4 * cout + 8 * b * cout * (-(-h // 8)) * (-(-h // 16))
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
    print(f'K4 checks: forward bitwise (fp32) / within 1 bf16 ulp (bf16) '
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
    """Planted faults of the bare conv: 'halo row shifted', every kernel
    tile of TILE_H output rows reads its top halo row one row too low
    (the tile's own first row); 'bias dropped'."""
    import torch.nn.functional as F
    from codeformer_tpu_torch.ops import conv3x3 as cv
    if kind == 'bias dropped':
        return cv.conv3x3_bias_ref(x, weight, torch.zeros_like(bias))
    if kind != 'halo row shifted':
        raise ValueError(kind)
    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1))
    wf, bf = weight.to(x.dtype).float(), bias.float()
    tiles = []
    for y0 in range(0, x.shape[1], cv.TILE_H):
        win = xp[:, :, y0:y0 + cv.TILE_H + 2].clone()
        if y0 > 0:
            win[:, :, 0] = win[:, :, 1]
        tiles.append(F.conv2d(win, wf, bf))
    return torch.cat(tiles, 2).permute(0, 2, 3, 1).to(x.dtype)


CONV_BIAS_FAULTS = ('halo row shifted', 'bias dropped')


def phase_conv_bias():
    """conv3x3_bias against its plain version (fp32 sums, TF32 off) at
    CONV_BIAS_CASES; planted faults; kernel, plain (bf16, cuDNN) and
    library-call (one F.conv2d, bf16, channels_last) times."""
    import torch.nn.functional as F
    from codeformer_tpu_torch.ops import conv3x3 as cv
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device='cuda').manual_seed(6)
    print(f'conv3x3_bias checks: bf16 in/out; ref = plain version in fp32, '
          f'TF32 off; rel RMS <= {REL_RMS_BOUND}; library = '
          f'F.conv2d(NCHW channels_last view, padding=1) in bf16', flush=True)
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
                  for k in CONV_BIAS_FAULTS}
        xc = x.permute(0, 3, 1, 2)            # NCHW view, channels_last
        wb, bb = wt.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last), bias.to(torch.bfloat16)
        ms = time_ms(lambda: cv.conv3x3_bias(x, wt, bias), iters=OPS_ITERS)
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
        print(f'  {name:36s} max_abs {err:.4g} rel_rms {rr:.3g} (<= '
              f'{REL_RMS_BOUND})  kernel {ms:.4f} ms  plain {pms:.4f} ms  '
              f'library {lms:.4f} ms  bound {lim["bound_ms"]:.4f} ms '
              f'({lim["bound_by"]})  {"ok" if ok else "FAIL"}; planted '
              f'faults: ' + ', '.join(f'{k} {v:.3g}' for k, v in
                                      faults.items())
              + f' {"FAIL as they must" if caught else "PASS (bound too loose)"}',
              flush=True)
        if not ok:
            raise SystemExit(f'chip_smoke: {name} disagrees with its plain '
                             f'version')
        if not caught:
            raise SystemExit(f'chip_smoke: {name}: a planted fault passes '
                             f'the bound')
        rows.append(dict(shape=name, max_abs_err=err, rel_rms=rr, ms=ms,
                         plain_ms=pms, library_ms=lms, **lim))
        del x, y, yr, xc
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
        if 'registers' in line or 'spill' in line or 'error' in line:
            print('  ptxas:', line.strip())
    sys.stdout.flush()


def _k1_inputs(g, h, cin, cout, skip, cs):
    dev = 'cuda'

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    x = rnd(BATCH, h, h, cin).to(torch.bfloat16)
    a = (1.0 + rnd(BATCH, cin, scale=0.1)).contiguous()
    b = rnd(BATCH, cin, scale=0.3).contiguous()     # non-zero: halo trap
    weight = rnd(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    bias = rnd(cout, scale=0.1)
    sk, w1 = None, None
    if skip == 'identity':
        sk = rnd(BATCH, h, h, cout).to(torch.bfloat16)
    elif skip == 'proj':
        sk = rnd(BATCH, h, h, cs).to(torch.bfloat16)
        w1 = rnd(cout, cs, 1, 1, scale=cs ** -0.5)
    return x, a, b, weight, bias, sk, w1


def phase_kernels():
    import torch.nn.functional as F
    from codeformer_tpu_torch.ops import conv3x3 as cv
    torch.backends.cudnn.allow_tf32 = False          # the fp32 reference
    torch.backends.cuda.matmul.allow_tf32 = False    # must be true fp32
    g = torch.Generator(device='cuda').manual_seed(0)
    results = {}
    print('kernel checks: B=2, bf16 in/out; ref = plain version in fp32, '
          'TF32 off; plain time = plain version in bf16 (cuDNN)')
    for h, cin, cout, act, skip, cs in K1_CASES:
        x, a, b, wt, bias, sk, w1 = _k1_inputs(g, h, cin, cout, skip, cs)
        y, st = cv.conv3x3_dots(x, a, b, act, wt, bias, sk, w1)
        torch.cuda.synchronize()
        yr, _ = cv.conv3x3_dots_ref(x, a, b, act, wt, bias, sk, w1)
        err = float((y.float() - yr.float()).abs().max())
        rr = rel_rms(y, yr)
        s = st.sum(1)
        yf = y.float()
        s1_err = float(((s[:, 0] - yf.sum((1, 2))).abs()
                        / yf.abs().sum((1, 2)).clamp_min(1e-6)).max())
        s2_err = float(((s[:, 1] - yf.square().sum((1, 2))).abs()
                        / yf.square().sum((1, 2)).clamp_min(1e-6)).max())
        ms = time_ms(lambda: cv.conv3x3_dots(x, a, b, act, wt, bias, sk, w1))
        pms = time_ms(lambda: cv.conv3x3_dots_ref(
            x, a, b, act, wt, bias, sk, w1, compute_dtype=torch.bfloat16))
        name = f'K1 {h}^2 {cin}->{cout} {act} skip={skip}' + \
            (f'({cs})' if cs else '')
        ok = rr <= REL_RMS_BOUND and max(s1_err, s2_err) <= STATS_BOUND
        faults = {k: rel_rms(y, k1_fault(k)(x, a, b, act, wt, bias, sk, w1)[0])
                  for k in K1_FAULTS}
        caught = all(v > REL_RMS_BOUND for v in faults.values())
        print(f'  {name:38s} max_abs {err:.4g} rel_rms {rr:.3g} '
              f'(<= {REL_RMS_BOUND}) stats_rel {max(s1_err, s2_err):.3g} '
              f'(<= {STATS_BOUND})  kernel {ms:.4f} ms  plain {pms:.4f} ms'
              f'  {"ok" if ok else "FAIL"}; planted faults: '
              + ', '.join(f'{k} {v:.3g}' for k, v in faults.items())
              + f' {"FAIL as they must" if caught else "PASS (bound too loose)"}',
              flush=True)
        if not ok:
            raise SystemExit(f'chip_smoke: {name} disagrees with its plain '
                             f'version')
        if not caught:
            raise SystemExit(f'chip_smoke: {name}: a planted fault passes '
                             f'the bound')
        results.setdefault('conv3x3_dots', []).append(
            dict(shape=name, max_abs_err=err, rel_rms=rr, ms=ms,
                 plain_ms=pms, library_ms=None,
                 **k1_bound(BATCH, h, cin, cout, skip, cs)))
    for h, c in K2_CASES:
        x = (torch.randn(BATCH, h, h, c, generator=g, device='cuda')
             .to(torch.bfloat16))
        wt = torch.randn(c, c, 3, 3, generator=g, device='cuda') \
            * (9 * c) ** -0.5
        bias = torch.randn(c, generator=g, device='cuda') * 0.1
        y = cv.downsample_dots(x, wt, bias)
        torch.cuda.synchronize()
        yr = cv.downsample_dots_ref(x, wt, bias)
        err = float((y.float() - yr.float()).abs().max())
        rr = rel_rms(y, yr)
        ms = time_ms(lambda: cv.downsample_dots(x, wt, bias))
        pms = time_ms(lambda: cv.downsample_dots_ref(
            x, wt, bias, compute_dtype=torch.bfloat16))
        # the library yardstick: F.pad + one F.conv2d, bf16, channels_last
        xc = x.permute(0, 3, 1, 2)
        wb = wt.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bb = bias.to(torch.bfloat16)
        lms = time_ms(lambda: F.conv2d(F.pad(xc, (0, 1, 0, 1)), wb, bb,
                                       stride=2))
        name = f'K2 {h}^2 -> {h // 2}^2 C={c}'
        ok = rr <= REL_RMS_BOUND and y.shape == (BATCH, h // 2, h // 2, c)
        fault = rel_rms(y, k2_fault(x, wt, bias))
        print(f'  {name:38s} max_abs {err:.4g} rel_rms {rr:.3g} '
              f'(<= {REL_RMS_BOUND})  kernel {ms:.4f} ms  plain '
              f'{pms:.4f} ms  library {lms:.4f} ms  '
              f'{"ok" if ok else "FAIL"}; planted fault: '
              f'symmetric pad {fault:.3g} '
              f'{"FAIL as it must" if fault > REL_RMS_BOUND else "PASS"}',
              flush=True)
        if not ok:
            raise SystemExit(f'chip_smoke: {name} disagrees with its plain '
                             f'version')
        if fault <= REL_RMS_BOUND:
            raise SystemExit(f'chip_smoke: {name}: a planted fault passes '
                             f'the bound')
        pix = BATCH * (h // 2) ** 2
        results.setdefault('downsample_dots', []).append(
            dict(shape=name, max_abs_err=err, rel_rms=rr, ms=ms,
                 plain_ms=pms, library_ms=lms, **bound(
                     2 * pix * 9 * c * c,
                     2 * BATCH * h * h * c + 2 * pix * c + 18 * c * c
                     + 4 * c, BF16_TC_FLOPS)))
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
        with torch.inference_mode(), \
                mock.patch.multiple(cv, conv3x3_dots=k1, downsample_dots=k2):
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
    for fault in K1_FAULTS:
        worst = per_call(model, xn, f'planted fault: K1 {fault}',
                         k1_fault(fault), cv.downsample_dots_ref)
        if worst['conv3x3_dots'] <= REL_RMS_BOUND:
            raise SystemExit(f'chip_smoke: the per-call bound lets the '
                             f'planted fault K1 {fault} pass')
    phase_rates(restorer, rng)
    return main_counts, restorer


def per_call(model, xn, label, k1, k2) -> dict:
    """Run one forward with K1/K2 served by (k1, k2) and hold every call
    against the plain version on that call's own inputs: the main path's
    real activations, where the whole-forward comparison sees only
    compounded rounding noise. Returns the worst rel RMS by op."""
    from codeformer_tpu_torch.ops import conv3x3 as cv
    errs = {'conv3x3_dots': [], 'downsample_dots': []}

    def shadow1(*args, **kw):
        y, st = k1(*args, **kw)
        errs['conv3x3_dots'].append(
            rel_rms(y, cv.conv3x3_dots_ref(*args, **kw)[0]))
        return y, st

    def shadow2(*args, **kw):
        y = k2(*args, **kw)
        errs['downsample_dots'].append(
            rel_rms(y, cv.downsample_dots_ref(*args, **kw)))
        return y

    with torch.inference_mode(), mock.patch.multiple(
            cv, conv3x3_dots=shadow1, downsample_dots=shadow2):
        model(xn, 0.5, adain=True)
    worst = {k: max(v) for k, v in errs.items()}
    print(f'  per call, {label} vs plain on the same inputs: ' + '; '.join(
        f'{k} {len(v)} calls, rel_rms {min(v):.3g}..{max(v):.3g}, '
        f'{sum(e > REL_RMS_BOUND for e in v)} above {REL_RMS_BOUND}'
        for k, v in errs.items()), flush=True)
    return worst


def _rate(restorer, xb) -> float:
    """Faces/s through restore_device over one window of at least
    RATE_WINDOW_S seconds (host clock, ends in a synchronize)."""
    for _ in range(2):
        restorer.restore_device(xb, w=0.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restorer.restore_device(xb, w=0.5)
    torch.cuda.synchronize()
    iters = max(2, int(RATE_WINDOW_S / (time.perf_counter() - t0)) + 1)
    t0 = time.perf_counter()
    for _ in range(iters):
        restorer.restore_device(xb, w=0.5)
    torch.cuda.synchronize()
    return len(xb) * iters / (time.perf_counter() - t0)


def plain_ops():
    """Patch K1/K2 to their plain versions in bf16 (cuDNN conv): the
    port's forward as plain PyTorch, for timing."""
    from codeformer_tpu_torch.ops import conv3x3 as cv
    return mock.patch.multiple(
        cv, conv3x3_dots=functools.partial(cv.conv3x3_dots_ref,
                                           compute_dtype=torch.bfloat16),
        downsample_dots=functools.partial(cv.downsample_dots_ref,
                                          compute_dtype=torch.bfloat16))


def phase_rates(restorer, rng):
    """Aligned faces/s, kernel path and plain path in alternating windows
    (kernel, plain, plain, kernel, ...); median and range of each."""
    size = restorer.face_size
    print(f'  faces/s through restore_device, w=0.5, TF32 off: '
          f'{RATE_REPEATS} windows of >= {RATE_WINDOW_S} s per path, '
          f'alternating; median [min, max]', flush=True)
    for bsz in (1, 8, 16):
        xb = torch.from_numpy(np.stack(_faces(rng, bsz, size))) \
            .to(restorer.device)
        got = {'kernel': [], 'plain': []}
        for rep in range(RATE_REPEATS):
            for path in (('kernel', 'plain') if rep % 2 == 0
                         else ('plain', 'kernel')):
                if path == 'plain':
                    with plain_ops():
                        got[path].append(_rate(restorer, xb))
                else:
                    got[path].append(_rate(restorer, xb))
        med = {k: statistics.median(v) for k, v in got.items()}
        print(f'  aligned faces/s at B={bsz}: kernel {med["kernel"]:.2f} '
              f'[{min(got["kernel"]):.2f}, {max(got["kernel"]):.2f}]  plain '
              f'{med["plain"]:.2f} [{min(got["plain"]):.2f}, '
              f'{max(got["plain"]):.2f}]  ratio '
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
    for key, ms, n in rows[:20]:
        print(f'  {ms:8.3f} ms {100 * ms / busy:5.1f}% x{n:4d}  {key[:100]}')
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
                cv, conv3x3_dots=k1, downsample_dots=k2), \
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
    'conv3x3_bias': ('codeformer_tpu_torch/csrc/conv3x3_dots.cu',
                     'codeformer_tpu/ops/colpack_conv.py:137; '
                     'codeformer_tpu/ops/pallas_conv.py:101; '
                     'codeformer_tpu/ops/imgpair_conv.py:117 (:158)'),
}


def main():
    phase_card()
    sys.path.insert(0, ROOT)
    phase_build()
    results = phase_kernels()
    k3_rows = phase_k3()
    k4_rows, conv_rows, ops_counts = phase_ops()
    serve_counts, restorer = phase_slice()
    if '--profile' in sys.argv[1:]:
        phase_profile(restorer)
    del restorer
    torch.cuda.empty_cache()
    train_counts, trainer = phase_train()
    if '--profile' in sys.argv[1:]:
        phase_train_profile(trainer)
    print(f'main-path launches: serving {serve_counts}; stage-II training '
          f'{train_counts}; ops path {ops_counts}')
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
                            (serve_counts, train_counts, ops_counts)),
            'max_abs_err': max(r['max_abs_err'] for r in rows),
            'ms': head['ms'], 'plain_ms': head['plain_ms'],
            'bound_ms': head['bound_ms'], 'bound_by': head['bound_by'],
            'library_ms': head['library_ms']})
    if not all(k['launches'] > 0 for k in kernels):
        raise SystemExit('chip_smoke: a kernel of the path never launched')
    if train_counts['nearest_code'] == 0 or not all(
            serve_counts[k] > 0 for k in ('conv3x3_dots', 'downsample_dots')) \
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

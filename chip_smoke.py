#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (codeformer_tpu_torch).

    python3 chip_smoke.py            # one GPU; a few minutes on an H100
    python3 chip_smoke.py --profile  # plus a torch.profiler breakdown

Phases, in order; any failure raises and the script exits non-zero:
  1. card and versions (needs a CUDA card of compute capability 9.0);
  2. build the hand-written kernels from codeformer_tpu_torch/csrc/;
  3. each kernel against its plain PyTorch version at the main path's
     shapes (B=2, bf16 inputs; reference in fp32 with TF32 off), its
     GroupNorm partials against torch.sum, planted faults that the
     bounds must reject, and kernel vs plain times;
  4. the full-width CodeFormerRestorer on the card with seeded random
     weights: a few requests, exact kernel launch counts, a reference
     forward with both ops patched to their plain versions (and with
     planted faults, which must fall outside the bounds), and faces/s of
     the kernel path and of the plain path over multi-second windows.
The last line is the JSON result; the line before it lists the kernels.
"""
from __future__ import annotations

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
                 plain_ms=pms))
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
        name = f'K2 {h}^2 -> {h // 2}^2 C={c}'
        ok = rr <= REL_RMS_BOUND and y.shape == (BATCH, h // 2, h // 2, c)
        fault = rel_rms(y, k2_fault(x, wt, bias))
        print(f'  {name:38s} max_abs {err:.4g} rel_rms {rr:.3g} '
              f'(<= {REL_RMS_BOUND})  kernel {ms:.4f} ms  plain '
              f'{pms:.4f} ms  {"ok" if ok else "FAIL"}; planted fault: '
              f'symmetric pad {fault:.3g} '
              f'{"FAIL as it must" if fault > REL_RMS_BOUND else "PASS"}',
              flush=True)
        if not ok:
            raise SystemExit(f'chip_smoke: {name} disagrees with its plain '
                             f'version')
        if fault <= REL_RMS_BOUND:
            raise SystemExit(f'chip_smoke: {name}: a planted fault passes '
                             f'the bound')
        results.setdefault('downsample_dots', []).append(
            dict(shape=name, max_abs_err=err, rel_rms=rr, ms=ms,
                 plain_ms=pms))
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
        want = {'conv3x3_dots': 2 * n_res + 1, 'downsample_dots': n_down}
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


def phase_profile(restorer, bsz: int = 8, iters: int = 3):
    """Device time of one forward by kernel (torch.profiler), kernel path
    and plain path."""
    import contextlib
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
        rows = [(e.key, e.device_time_total / iters / 1e3, e.count // iters)
                for e in prof.key_averages() if e.device_time_total > 0
                and not e.key.startswith(('aten::', 'cuda'))]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        print(f'profile, {label} path, B={bsz}: wall {wall:.2f} ms a forward '
              f'(profiler on), device kernels {busy:.2f} ms, busy share '
              f'{busy / wall:.3f}')
        for key, ms, n in rows[:20]:
            print(f'  {ms:8.3f} ms {100 * ms / busy:5.1f}% x{n:4d}  '
                  f'{key[:100]}')
        sys.stdout.flush()


def main():
    phase_card()
    sys.path.insert(0, ROOT)
    phase_build()
    results = phase_kernels()
    counts, restorer = phase_slice()
    if '--profile' in sys.argv[1:]:
        phase_profile(restorer)
    src = {'conv3x3_dots': ('codeformer_tpu_torch/csrc/conv3x3_dots.cu',
                            'codeformer_tpu/ops/colpack_conv.py:376'),
           'downsample_dots': ('codeformer_tpu_torch/csrc/downsample_dots.cu',
                               'codeformer_tpu/ops/colpack_conv.py:586')}
    kernels = []
    for name, rows in results.items():
        head = rows[0]        # the 512^2 shape, the path's largest
        kernels.append({'name': name, 'route': 'cuda',
                        'source': src[name][0], 'replaces': src[name][1],
                        'launches': counts[name],
                        'max_abs_err': max(r['max_abs_err'] for r in rows),
                        'ms': head['ms'], 'plain_ms': head['plain_ms']})
    if not all(k['launches'] > 0 for k in kernels):
        raise SystemExit('chip_smoke: a kernel of the path never launched')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()

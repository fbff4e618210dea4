"""Where the Hopper conv core's time goes, on the card.

    python -m codeformer_tpu_torch.kernels.conv_sm90_probe

Builds csrc/conv3x3_bias.cu five times, each with one part of the kernel
taken out by a text edit of csrc/conv_sm90.cuh into a scratch copy under
build/probe/ (the library the port uses is not touched), and times each
at the shapes of PERF.md's table: the full kernel; without the output
stores; without the products (ldmatrix and TMA left); the products
alone (no TMA, no ldmatrix, no stores); the products alone with A from
shared memory (an SS wgmma in place of the RS one). Only the full build
computes the conv; the others time a part. Then it samples the SM clock
and power (nvidia-smi) while the full kernel, one cuDNN call for the same
conv and a large bf16 matmul run back to back for a few seconds each.
Then K1 (csrc/conv3x3_dots.cu) at its main shapes: the kernel with SiLU,
the same launch with act 'none' (no SFU work in the prologue), builds
with one part taken out (wrong results, the time without that part):
the prologue stage's rewrite (its warps only pass each window on), the
statistics, the identity skip's loads, and all three; and the bare conv
conv3x3_bias of the same shape (no prologue, skip or statistics).
Prints one line a shape and one a clock sample; needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from codeformer_tpu_torch.kernels import build
from codeformer_tpu_torch.ops import conv3x3 as cv

SHAPES = ((16, 512, 64, 64), (2, 512, 64, 64), (2, 256, 128, 128),
          (16, 512, 64, 128))
_MMA = 'Wgmma<BN>::mma(acc[mb], af[p][kk][mb], desc, keep);'
_STORE = ('if (ok && nb < a.Cout)\n'
          '            *reinterpret_cast<uint4*>(a.y + pix * a.Cout + nb) = o;')
_TMA = ('mbar_expect_tx(full, BOX);\n'
        '          tma_load_4d(win_s + stage * SLOT, &xmap, full,\n'
        '                      (split * a.cps + cl) * KC, wx, wy, b);')
_LDSM = 'ldsm_x4(af[p][kk][mb], row + (((2 * kk + hi) ^ (r & 7)) << 4));'
_KERNEL = '// ------------------------------------------------------------- the kernel'
# stand-ins that keep the data dependencies, so nothing is optimised away
_NO_STORE = _STORE.replace('nb < a.Cout', 'nb < a.Cout && o.x == 0x7f7f7f7fu')
_NO_MMA = 'acc[mb][kk] += __uint_as_float(af[p][kk][mb][0] & 0x3fffffffu);'
_NO_TMA = 'mbar_arrive(full);'
_NO_LDSM = ('af[p][kk][mb][0] = af[p][kk][mb][1] = af[p][kk][mb][2] = '
            'af[p][kk][mb][3] = 0x3c003c00u + (r & 1);')
_SS64 = r'''
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
'''
_SS_MMA = ('if constexpr (BN == 64) wgmma_ss64(acc[mb], '
           'desc_sw128(wts + kk * 32), desc); else ' + _MMA)


def variants(hdr: str) -> dict:
    """{name: conv_sm90.cuh text}, each with one part taken out."""
    for part in (_MMA, _STORE, _TMA, _LDSM, _KERNEL):
        if part not in hdr:
            raise RuntimeError(f'conv_sm90.cuh changed: {part[:40]!r}')
    mma_only = (hdr.replace(_STORE, _NO_STORE).replace(_LDSM, _NO_LDSM)
                .replace(_TMA, _NO_TMA))
    return {'full': hdr,
            'no stores': hdr.replace(_STORE, _NO_STORE),
            'no products': hdr.replace(_MMA, _NO_MMA),
            'products only': mma_only,
            'products only, SS': mma_only.replace(_KERNEL, _SS64 + _KERNEL)
            .replace(_MMA, _SS_MMA)}


# K1's prologue loop over the window's rows, and a stand-in that runs it
# over none of them; its statistics (from the butterfly to the last
# barrier) and its identity skip's loads
_PROLOGUE = 'for (int r = pt >> 3; r < ROWS; r += kPrologueThreads / 8) {'
_NO_PROLOGUE = 'for (int r = ROWS + (pt >> 3); r < ROWS; r += 12) {'
_STATS_FROM = '    // the 8 lanes of a column (lane >> 2) into one sum'
_STATS_TO = '  consumer_sync();   // the partials may be overwritten by the next tile'
_SKIP_LOAD = 'const bool ok = a.skip_id != nullptr && oy < a.Ho && ox < a.Wo;'
_NO_SKIP_LOAD = 'const bool ok = a.skip_id != nullptr && oy < 0;'


def k1_variants(hdr: str) -> dict:
    """{name: conv_sm90.cuh text} of K1 with one part taken out."""
    for part in (_PROLOGUE, _STATS_FROM, _STATS_TO, _SKIP_LOAD):
        if part not in hdr:
            raise RuntimeError(f'conv_sm90.cuh changed: {part[:40]!r}')
    i, j = hdr.index(_STATS_FROM), hdr.index(_STATS_TO) + len(_STATS_TO)
    no_stats = hdr[:i] + '    (void)s1; (void)s2;\n  }\n' + hdr[j:]
    none = no_stats.replace(_PROLOGUE, _NO_PROLOGUE) \
        .replace(_SKIP_LOAD, _NO_SKIP_LOAD)
    return {'K1 no prologue': hdr.replace(_PROLOGUE, _NO_PROLOGUE),
            'K1 no stats': no_stats,
            'K1 no skip loads': hdr.replace(_SKIP_LOAD, _NO_SKIP_LOAD),
            'K1 none of the three': none}
K1_SHAPES = ((2, 512, 64, 64, 0), (8, 512, 64, 64, 0), (2, 256, 128, 128, 0),
             (8, 16, 512, 512, 256))   # (B, H=W, Cin, Cout, projected Cs)


def build_variants(root: Path) -> dict:
    """Compile each variant of conv3x3_bias.cu, and K1 without its
    prologue, in parallel; {name: fn}."""
    hdr = (build.CSRC / 'conv_sm90.cuh').read_text()
    jobs = []
    sources = [(name, text, 'conv3x3_bias')
               for name, text in variants(hdr).items()]
    sources += [(name, text, 'conv3x3_dots')
                for name, text in k1_variants(hdr).items()]
    for i, (name, text, src) in enumerate(sources):
        d = root / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / 'conv_sm90.cuh').write_text(text)
        (d / f'{src}.cu').write_text((build.CSRC / f'{src}.cu').read_text())
        lib = d / 'probe.so'
        cmd = [build._nvcc(), *build.NVCC_FLAGS, '-shared', '-o', str(lib),
               str(d / f'{src}.cu'), '-lcuda']
        jobs.append((name, lib, f'cf_{src}', subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns = {}
    for name, lib, entry, proc in jobs:
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise RuntimeError(f'{name}: nvcc failed\n{log[-3000:]}')
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def dots_args(c, act: int) -> tuple:
    """cf_conv3x3_dots' arguments for a prepared K1 launch `c`."""
    p, (bsz, h, w, cin) = c.plan, c.x.shape
    return (c.x.data_ptr(), c.a.data_ptr(), c.b.data_ptr(),
            c.ops.conv.weight.data_ptr(), c.ops.conv.bias.data_ptr(),
            c.skip.data_ptr(),
            c.ops.w1.data_ptr() if c.ops.w1 is not None else None,
            c.y.data_ptr(), c.stats.data_ptr(),
            c.ws.data_ptr() if c.ws is not None else None, bsz, h, w, cin,
            c.ops.conv.cout, p.coutp, c.ops.cs, act, c.skip_mode, p.bn, p.mb,
            p.split, p.stages, p.smem, p.grid_x, c.x.device.index or 0,
            torch.cuda.current_stream().cuda_stream)


def probe_k1(fns: dict, g) -> None:
    """K1 with SiLU, with act 'none', without its prologue stage, and the
    bare conv of the same shape; ms, median of runs."""
    lib = build.library()
    for bsz, h, cin, cout, cs in K1_SHAPES:
        def rnd(*shape):
            return torch.randn(*shape, generator=g, device='cuda')
        x = rnd(bsz, h, h, cin).to(torch.bfloat16)
        a, b = (1 + 0.1 * rnd(bsz, cin)), 0.3 * rnd(bsz, cin)
        wt = rnd(cout, cin, 3, 3) * (9 * cin) ** -0.5
        bias = 0.1 * rnd(cout)
        skip = rnd(bsz, h, h, cs or cout).to(torch.bfloat16)
        w1 = rnd(cout, cs, 1, 1) * cs ** -0.5 if cs else None
        c = cv.prepare_dots(x, a, b, 'silu', cv.dots_operands(wt, bias, w1),
                            skip)
        bare = cv.prepare_conv(x, cv.conv_operands(wt, bias), 1)
        ms = {}
        runs = [('silu', lib.cf_conv3x3_dots, 1),
                ('none', lib.cf_conv3x3_dots, 0)]
        runs += [(k[3:], fn, 1) for k, fn in fns.items() if k[:3] == 'K1 ']
        for name, fn, act in runs:
            args = dots_args(c, act)

            def run(fn=fn, args=args):
                if fn(*args):
                    raise RuntimeError(f'K1 {name}: launch failed')
            ms[name] = time_ms(run)
        ms['bare conv'] = time_ms(lambda: cv.launch_conv(bare))
        p = c.plan
        print(f'K1 B={bsz} {h}^2 {cin}->{cout} skip '
              f'{"proj " + str(cs) if cs else "identity"} (TH={p.th} '
              f'BN={p.bn} stages={p.stages}), ms: ' + '  '.join(
                  f'{k} {v:.4f}' for k, v in ms.items()), flush=True)


def time_ms(fn, iters: int = 20, runs: int = 5) -> float:
    """Median per-call ms of runs of back-to-back calls (CUDA events)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return sorted(times)[len(times) // 2]


def clocks_under(label: str, fn, seconds: float = 4.0) -> None:
    """Run fn back to back for `seconds` while nvidia-smi samples."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ['nvidia-smi', '--query-gpu=clocks.sm,clocks.max.sm,power.draw',
         '--format=csv,noheader', '-lms', '250'], stdout=subprocess.PIPE,
        text=True)
    try:
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            n += 20
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        samples = smi.communicate()[0].strip().splitlines()
    print(f'  clocks under {label} ({n} calls): sm clock, max, power: '
          f'{samples[2:-1]}', flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit('conv_sm90_probe: no CUDA device')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    fns = build_variants(build.BUILD_ROOT.parent / 'probe')
    g = torch.Generator(device='cuda').manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    probe_k1(fns, g)
    for bsz, h, cin, cout in SHAPES:
        x = torch.randn(bsz, h, h, cin, generator=g, device='cuda') \
            .to(torch.bfloat16)
        wt = torch.randn(cout, cin, 3, 3, generator=g, device='cuda') \
            * (9 * cin) ** -0.5
        bias = torch.randn(cout, generator=g, device='cuda') * 0.1
        c = cv.prepare_conv(x, cv.conv_operands(wt, bias), 1)
        p = c.plan
        args = (c.x.data_ptr(), c.ops.weight.data_ptr(),
                c.ops.bias.data_ptr(), c.y.data_ptr(), None, bsz, h, h, cin,
                cout, p.coutp, p.bn, p.mb, p.split, p.stages, p.smem,
                p.grid_x, x.device.index or 0, stream)
        line = (f'B={bsz} {h}^2 {cin}->{cout} (TH={p.th} BN={p.bn} '
                f'stages={p.stages}), ms:')
        for name, fn in fns.items():
            if name.startswith('K1'):
                continue
            def run(fn=fn):
                rc = fn(*args)
                if rc:
                    raise RuntimeError(f'{name}: launch failed ({rc})')
            ms = time_ms(run)
            line += f'  {name} {ms:.4f}'
            if name == 'full':
                ref = cv.conv3x3_bias_ref(x, wt, bias)
                err = float((c.y.float() - ref.float()).pow(2).mean().sqrt()
                            / ref.float().pow(2).mean().sqrt())
                tflops = 2 * bsz * h * h * 9 * cin * cout / ms / 1e9
                line += f' ({tflops:.0f} TFLOP/s, rel RMS {err:.2g})'
        xc = x.permute(0, 3, 1, 2)
        wb = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        bb = bias.to(torch.bfloat16)
        lms = time_ms(lambda: F.conv2d(xc, wb, bb, padding=1))
        print(line + f'  cuDNN {lms:.4f}', flush=True)
        if (bsz, h, cin, cout) == SHAPES[0]:
            clocks_under('the full kernel', lambda: cv.launch_conv(c))
            clocks_under('cuDNN', lambda: F.conv2d(xc, wb, bb, padding=1))
    a = torch.randn(8192, 8192, generator=g, device='cuda') \
        .to(torch.bfloat16)
    ms = time_ms(lambda: a @ a)
    print(f'bf16 matmul 8192^3: {ms:.4f} ms, '
          f'{2 * 8192 ** 3 / ms / 1e9:.0f} TFLOP/s', flush=True)
    clocks_under('the matmul', lambda: a @ a)


if __name__ == '__main__':
    sys.exit(main())

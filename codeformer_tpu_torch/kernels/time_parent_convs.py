"""Time an earlier checkout's convs the way chip_smoke.py times kernels
now: runs of back-to-back launches between two CUDA events, the median
run.

    git archive <commit> codeformer_tpu_torch | tar -x -C build/parent
    python3 codeformer_tpu_torch/kernels/time_parent_convs.py build/parent
    python3 codeformer_tpu_torch/kernels/time_parent_convs.py build/parent k1

Run it as a file, not with -m: it imports `codeformer_tpu_torch` from the
directory given, so the checkout's own wrappers and kernels are timed.
Without `k1` it times conv3x3_bias and K2 of commits before the Hopper
conv core (their C entries: cf_conv3x3_bias with n_frags,
cf_downsample_dots without a plan), each beside the one-event-pair-a-call
reading chip_smoke.py took before and one cuDNN call for the same
function. With `k1` it times the checkout's K1 at every shape of this
checkout's chip_smoke.K1_CASES through the checkout's own
`prepare_dots(x, a, b, act, weight, bias, skip, w1x1)` and `launch_dots`
(the API of commits before K1 moved onto the Hopper core): the launch
on prepared operands and the whole conv3x3_dots call.
"""
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

SHAPES = (('conv3x3_bias', 16, 512, 64), ('conv3x3_bias', 2, 512, 64),
          ('conv3x3_bias', 2, 256, 128), ('downsample_dots', 2, 512, 64),
          ('downsample_dots', 2, 256, 128), ('downsample_dots', 2, 64, 256),
          ('downsample_dots', 2, 32, 256))


def runs_ms(fn, iters: int = 20, runs: int = 5) -> float:
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
    return sorted(times)[runs // 2]


def pair_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[iters // 2]


def time_k1(cv) -> None:
    """The checkout's K1 at every chip_smoke.K1_CASES shape."""
    sys.path.append(str(Path(__file__).resolve().parents[2]))
    import chip_smoke
    g = torch.Generator(device='cuda').manual_seed(0)
    for bsz, h, cin, cout, act, skip, cs in chip_smoke.K1_CASES:
        x, a, b, wt, bias, sk, w1 = chip_smoke._k1_inputs(
            g, bsz, h, cin, cout, skip, cs)
        launch = cv.prepare_dots(x, a, b, act, wt, bias, sk, w1)
        ms = runs_ms(lambda: cv.launch_dots(launch))
        cms = runs_ms(lambda: cv.conv3x3_dots(x, a, b, act, wt, bias, sk,
                                              w1))
        print(f'K1 B={bsz} {h}^2 {cin}->{cout} {act} skip={skip}'
              + (f'({cs})' if cs else '') + f': launch {ms:.4f} ms, call '
              f'{cms:.4f} ms', flush=True)


def main(root: str, k1: bool = False) -> None:
    if not torch.cuda.is_available():
        raise SystemExit('time_parent_convs: no CUDA device')
    sys.path.insert(0, os.path.abspath(root))
    import codeformer_tpu_torch
    from codeformer_tpu_torch.kernels.build import library
    from codeformer_tpu_torch.ops import conv3x3 as cv
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f'timing the package at {codeformer_tpu_torch.__file__}',
          flush=True)
    if k1:
        return time_k1(cv)
    lib = library()
    g = torch.Generator(device='cuda').manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for name, bsz, h, c in SHAPES:
        x = torch.randn(bsz, h, h, c, generator=g, device='cuda') \
            .to(torch.bfloat16)
        wt = torch.randn(c, c, 3, 3, generator=g, device='cuda') \
            * (9 * c) ** -0.5
        bias = torch.randn(c, generator=g, device='cuda') * 0.1
        xc = x.permute(0, 3, 1, 2)
        wb = wt.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bb = bias.to(torch.bfloat16)
        if name == 'conv3x3_bias':
            nf = cv.n_frags(c)
            cp = -(-c // (16 * nf)) * 16 * nf
            wk, bk = cv.kernel_weight(wt, cp), cv.kernel_bias(bias, cp)
            y = torch.empty_like(x)

            def launch():
                return lib.cf_conv3x3_bias(
                    x.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(),
                    bsz, h, h, c, c, cp, nf, 0, stream)

            def call():
                return cv.conv3x3_bias(x, wt, bias)

            def library_call():
                return F.conv2d(xc, wb, bb, padding=1)
        else:
            cp = -(-c // 64) * 64
            wk, bk = cv.kernel_weight(wt, cp), cv.kernel_bias(bias, cp)
            y = torch.empty(bsz, h // 2, h // 2, c, dtype=x.dtype,
                            device='cuda')

            def launch():
                return lib.cf_downsample_dots(
                    x.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(),
                    bsz, h, h, c, cp, 0, stream)

            def call():
                return cv.downsample_dots(x, wt, bias)

            def library_call():
                return F.conv2d(F.pad(xc, (0, 1, 0, 1)), wb, bb, stride=2)
        if launch() != 0:
            raise SystemExit(f'{name}: launch failed')
        print(f'{name} B={bsz} {h}^2 C={c}: launch {runs_ms(launch):.4f} '
              f'ms, call {runs_ms(call):.4f} ms, call with one event pair a '
              f'call {pair_ms(call):.4f} ms, cuDNN '
              f'{runs_ms(library_call):.4f} ms', flush=True)


if __name__ == '__main__':
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([], ['k1']):
        raise SystemExit(__doc__)
    main(sys.argv[1], sys.argv[2:] == ['k1'])

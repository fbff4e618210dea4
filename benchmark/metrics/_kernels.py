"""Which device kernels of the trace are K1 and K2: the Hopper conv
core's instances (csrc/conv_sm90.cuh `conv_sm90_kernel<STRIDE, BN, MB,
FUSED>`), K1 the fused stride-1 one with its split second pass
`dots_finish_kernel`, K2 the stride-2 one with `split_sum_kernel` (on the
serving path no other caller of `run_conv` runs)."""
import re

PATTERNS = {
    'k1': re.compile(r'conv_sm90_kernel<1,[^>]*true>|dots_finish_kernel'),
    'k2': re.compile(r'conv_sm90_kernel<2,|split_sum_kernel'),
}


def device_seconds(ctx, kernel):
    """(seconds, launches) of `kernel`'s device events in the window."""
    pat = PATTERNS[kernel]
    s = n = 0
    for name, (sec, count) in ctx['kernels'].items():
        if pat.search(name):
            s, n = s + sec, n + count
    return s, n


def roofline(ctx, kernel):
    """100 * the least time of the window's calls (shapes from the
    reference, roofline.py) / their device time; None without calls."""
    sec, _ = device_seconds(ctx, kernel)
    if sec <= 0:
        return None
    least = ctx[f'{kernel}_s'] * ctx['forwards']
    return 100.0 * least / sec

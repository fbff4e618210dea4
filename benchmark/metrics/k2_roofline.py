"""K2 (ops/conv3x3.py downsample_dots, csrc/downsample_dots.cu): the
least time of the window's K2 calls over their device time, in
percent."""
from benchmark.metrics._kernels import roofline


def read(name, ctx):
    return roofline(ctx, 'k2')

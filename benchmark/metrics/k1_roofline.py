"""K1 (ops/conv3x3.py conv3x3_dots, csrc/conv3x3_dots.cu): the least
time of the window's K1 calls over their device time, in percent."""
from benchmark.metrics._kernels import roofline


def read(name, ctx):
    return roofline(ctx, 'k1')

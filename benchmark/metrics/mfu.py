"""The whole step's share of the chip's bf16 peak, in percent: the
reference's FLOPs a unit (face or frame; roofline.forward_flops) times
the units completed in the traced window, over the window, over
989 TFLOP/s."""
from benchmark.roofline import BF16_TC_FLOPS


def read(name, ctx):
    if ctx['window_s'] <= 0 or not ctx['units']:
        return None
    return 100.0 * ctx['flops_per_unit'] * ctx['units'] / ctx['window_s'] \
        / BF16_TC_FLOPS

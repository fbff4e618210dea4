"""The background upsample's share of its roofline, in percent: the
least seconds of the window's walks (RRDBNet's FLOPs over every window
of a frame, benchmark/reference/rrdbnet.py `walk_cost`, at the bf16
peak) over the device time launched inside the benchmark's range around
the pipeline's `_upsample_bg` (`stage.upsample`). RRDBNet's convs are
cuDNN's: this is the stage's share, not a kernel's. None where the
program has no such stage."""


def read(name, ctx):
    sec = ctx.get('stages', {}).get('upsample')
    if not sec or not ctx['units'] or 'upsample_s' not in ctx:
        return None
    return 100.0 * ctx['upsample_s'] * ctx['units'] / sec

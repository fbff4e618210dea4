"""The program's peak device memory over the measured window, GiB
(torch.cuda.max_memory_allocated, its statistics reset when the window
opens, read before the reference runs): what serving holds, without
the set-up's weights in float32 and the warm-up."""


def read(name, ctx):
    peak = ctx.get('window_peak_bytes')
    return peak / 2 ** 30 if peak else None

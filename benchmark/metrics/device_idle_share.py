"""Share of the traced window in which no operation ran on the device,
in percent: 100 * (1 - union of device intervals / window)."""


def read(name, ctx):
    if ctx['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - ctx['busy_s'] / ctx['window_s'])

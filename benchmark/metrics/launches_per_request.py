"""Device kernels launched a request in the traced window (a count from
the profiler's kernel events; copies and memsets left out)."""


def read(name, ctx):
    if not ctx['requests']:
        return None
    return ctx['launches'] / ctx['requests']

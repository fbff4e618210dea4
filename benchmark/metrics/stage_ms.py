"""Device milliseconds a frame that one pipeline stage launched, from
the trace: the device time of the kernels issued inside the benchmark's
host range around the stage (`stage_ms.<stage>.<cell kind>`; the stages
are `detect`, `warp`, `restore`, `parse`, `composite`, see
benchmark/systems/photos.py `instrument`)."""


def read(name, ctx):
    stage = name.split('.')[1]
    sec = ctx.get('stages', {}).get(stage)
    if not sec or not ctx['units']:
        return None
    return 1e3 * sec / ctx['units']

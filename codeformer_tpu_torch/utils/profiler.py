"""Host-side stage timers, counterpart of codeformer_tpu/utils/profiler.py,
and the program's spans.

`stage(name)` times a block on the host clock and `TIMER.report()` sums
each stage's count, total and mean (the CLIs' `--profile`); a stage is
also a span. `span(name)` names a region `cf.<name>` in a torch.profiler
trace, on the clock of the device's kernels, and does nothing while no
profiler runs.

A stage's time is the host's: work a stage enqueues on the card and does
not wait for is counted in whichever later stage waits for it.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch
from torch._C._profiler import _RecordFunctionFast

_NULL = contextlib.nullcontext()


def span(name: str):
    """A `cf.<name>` range while a torch.profiler runs, else one shared
    null context (one `_profiler_enabled()` call, nothing recorded).

    The range is a function-scope record, not a user annotation
    (`torch.profiler.record_function`): the profiler copies user
    annotations onto the device's timeline, where a reduction that takes
    device events for kernels would count them as device work, and links
    no kernel to them. A function-scope range links the kernels launched
    directly inside it (the port's own, launched with no aten op open),
    so its `device_time_total` holds every kernel launched under it."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _RecordFunctionFast('cf.' + name)


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = ['stage                          count    total      mean']
        for name in sorted(self.totals, key=self.totals.get,
                           reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f'{name:<30} {c:>5d} {t:>8.3f}s '
                         f'{t / c * 1e3:>8.1f}ms')
        return '\n'.join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


# process-wide default timer
TIMER = StageTimer()
stage = TIMER.stage

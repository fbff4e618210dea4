"""Host-side stage timers, counterpart of codeformer_tpu/utils/profiler.py:
`stage(name)` times a block on the host clock and `TIMER.report()` sums
each stage's count, total and mean (the CLIs' `--profile`). `annotate`
names a region in a torch.profiler trace.

A stage's time is the host's: work a stage enqueues on the card and does
not wait for is counted in whichever later stage waits for it.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region that shows up inside torch.profiler traces."""
    import torch
    with torch.profiler.record_function(name):
        yield

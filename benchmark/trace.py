"""The traced run's reduction: torch.profiler's events over the measured
window to device busy time, kernel time by name and idle gaps by what
the host was doing.

The benchmark marks its own host phases with `record_function` ranges
named `bench.<phase>` (the window itself is `bench.window`); an idle gap
on the device is charged to the innermost such range open on the host
when the gap began.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

WINDOW = 'bench.window'


def span(name: str):
    """A host range the idle gaps can be charged to."""
    return torch.profiler.record_function(f'bench.{name}')


class Tracer:
    """torch.profiler (host and device activity) over the first
    `seconds` of the window, ended at the first request that completes
    after them; counts the requests and units it covered."""

    def __init__(self, seconds: float):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.seconds = seconds
        self.prof = profile(activities=acts)
        self.window = span('window')
        self.requests = self.units = None

    def start(self, t0: float) -> None:
        self.t_stop = t0 + self.seconds
        self.prof.start()
        self.window.__enter__()

    def tick(self, now: float, requests: int, units: int) -> None:
        if self.requests is None and now >= self.t_stop:
            self.stop(requests, units)

    def stop(self, requests: int, units: int) -> None:
        if self.requests is None:
            self.window.__exit__(None, None, None)
            self.prof.stop()
            self.requests, self.units = requests, units


def _is_device(evt) -> bool:
    return evt.device_type != torch.autograd.DeviceType.CPU


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged [start, end) intervals of the given ones."""
    if not len(starts):
        return np.zeros(0), np.zeros(0)
    order = np.argsort(starts, kind='stable')
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], run_end[np.r_[idx[1:] - 1, len(s) - 1]]


def _host_label_at(spans: List[Tuple[float, float, str]], times):
    """The innermost bench range open at each time (ranges nest)."""
    marks = sorted([(s, 1, -e, name) for s, e, name in spans]
                   + [(e, 0, 0.0, name) for s, e, name in spans])
    bounds, labels, stack = [], [], []
    for t, opening, _, name in marks:   # closes before opens at a tie
        if opening:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        bounds.append(t)
        labels.append(stack[-1] if stack else 'host')
    pos = np.searchsorted(np.asarray(bounds), times, side='right') - 1
    return [labels[p] if p >= 0 else 'host' for p in pos]


def reduce(prof) -> Dict:
    """Device facts of the traced window: busy_s, window_s, kernel
    launches, seconds and counts by kernel name, idle seconds by host
    phase."""
    events = prof.events()
    win = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if not win:
        raise RuntimeError('the trace holds no window range')
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    names, starts, ends = [], [], []
    spans = []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if _is_device(e):
            # the benchmark's own ranges also appear on the device's
            # timeline (user annotations): they are no device work
            if t > w0 and s < w1 and not e.name.startswith('bench.'):
                names.append(e.name)
                starts.append(max(s, w0))
                ends.append(min(t, w1))
        elif e.name.startswith('bench.') and e.name != WINDOW:
            spans.append((s, t, e.name[len('bench.'):]))
    starts, ends = np.asarray(starts, float), np.asarray(ends, float)
    us, ue = _union(starts, ends)
    busy = float((ue - us).sum()) * 1e-6
    by_name = defaultdict(lambda: [0.0, 0])
    launches = 0
    for n, s, t in zip(names, starts, ends):
        by_name[n][0] += (t - s) * 1e-6
        by_name[n][1] += 1
        launches += not n.startswith(('Memcpy', 'Memset'))
    gap_s = np.r_[w0, ue]
    gap_e = np.r_[us, w1]
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    spans.sort()
    stages = defaultdict(float)   # device seconds launched under a stage
    for e in events:
        if not _is_device(e) and e.name.startswith('bench.stage.') and \
                w0 <= e.time_range.start < w1:
            stages[e.name[len('bench.stage.'):]] += \
                e.device_time_total * 1e-6
    idle = defaultdict(float)
    for label, a, b in zip(_host_label_at(spans, gap_s), gap_s, gap_e):
        idle[label] += (b - a) * 1e-6
    return {'busy_s': busy, 'window_s': (w1 - w0) * 1e-6,
            'launches': launches,
            'kernels': {k: tuple(v) for k, v in by_name.items()},
            'idle': dict(idle), 'stages': dict(stages)}


def breakdown(facts: Dict) -> Dict:
    ops = sorted(((k, v[0]) for k, v in facts['kernels'].items()),
                 key=lambda r: -r[1])[:10]
    gaps = sorted(facts['idle'].items(), key=lambda r: -r[1])[:10]
    return {'device_ops': [[k[:200], v] for k, v in ops],
            'idle_gaps': [[k, v] for k, v in gaps]}

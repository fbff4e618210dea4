"""The program's own spans joined to a traced run's device timeline.

The program names its regions `cf.<name>` (codeformer_tpu_torch/utils/
profiler.py `span`): host ranges on the profiler's clock, kept off the
device's timeline. `span_facts` reduces a profile over the benchmark's
window (benchmark/trace.py `WINDOW`) to

- `span_s`: device seconds launched under each program span, its child
  spans included (the `device_time_total` that trace.py's `stages` reads);
- `span_idle_s`: idle seconds of the device gaps that began while each
  program span was open on the host, at any depth;
- `idle`: idle seconds by the innermost range open on the host when the
  gap began, program (`cf.<name>`) or benchmark (`request`, `stage.*`),
  `host` where none was.

trace.py's `reduce`, which the per-layer metrics read, leaves these out;
this module is what it would call to give them. Until then

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

runs the cell once traced (benchmark/run.py `run_cell`) and prints its
result line with a `spans` key: these facts in milliseconds a unit of
the traced window (a face, a request's face or a frame), the device's
busy milliseconds a unit, and the share of the window's idle time
charged to a program span.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Dict

import numpy as np

from benchmark import trace as tr

PREFIX = 'cf.'


def _annotation(evt) -> bool:
    """A host range mirrored onto the device's timeline: no device
    work."""
    return evt.name.startswith(('bench.', PREFIX)) or \
        getattr(evt, 'is_user_annotation', False)


def span_facts(prof) -> Dict:
    """See the module docstring; also `busy_s` and `window_s`, as
    trace.py's `reduce` computes them."""
    events = prof.events()
    win = [e for e in events if e.name == tr.WINDOW and not tr._is_device(e)]
    if not win:
        raise RuntimeError('the trace holds no window range')
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    starts, ends, host, span_s = [], [], [], defaultdict(float)
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if tr._is_device(e):
            if t > w0 and s < w1 and not _annotation(e):
                starts.append(max(s, w0))
                ends.append(min(t, w1))
        elif e.name.startswith(PREFIX):
            host.append((s, t, e.name))
            if w0 <= s < w1:
                span_s[e.name[len(PREFIX):]] += e.device_time_total * 1e-6
        elif e.name.startswith('bench.') and e.name != tr.WINDOW:
            host.append((s, t, e.name[len('bench.'):]))
    us, ue = tr._union(np.asarray(starts, float), np.asarray(ends, float))
    gap_s, gap_e = np.r_[w0, ue], np.r_[us, w1]
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    idle = defaultdict(float)
    host.sort()
    for label, a, b in zip(tr._host_label_at(host, gap_s), gap_s, gap_e):
        idle[label] += (b - a) * 1e-6
    by_name = defaultdict(list)
    for s, t, name in host:
        if name.startswith(PREFIX):
            by_name[name[len(PREFIX):]].append((s, t))
    span_idle_s = {}
    for name, ranges in by_name.items():
        rs, re_ = tr._union(*(np.asarray(v, float) for v in zip(*ranges)))
        at = np.searchsorted(rs, gap_s, side='right') - 1
        inside = (at >= 0) & (gap_s < re_[np.maximum(at, 0)])
        span_idle_s[name] = float((gap_e - gap_s)[inside].sum()) * 1e-6
    return {'busy_s': float((ue - us).sum()) * 1e-6,
            'window_s': (w1 - w0) * 1e-6, 'span_s': dict(span_s),
            'span_idle_s': span_idle_s, 'idle': dict(idle)}


def per_unit(facts: Dict, units: int) -> Dict:
    """The facts in milliseconds a unit of the traced window."""
    if not units:
        return {}
    idle_s = facts['window_s'] - facts['busy_s']
    on_spans = sum(v for k, v in facts['idle'].items()
                   if k.startswith(PREFIX))
    return {'units': units,
            'busy_ms': 1e3 * facts['busy_s'] / units,
            'span_ms': {k: 1e3 * v / units
                        for k, v in sorted(facts['span_s'].items())},
            'idle_ms': {k: 1e3 * v / units
                        for k, v in sorted(facts['span_idle_s'].items())},
            'idle_gaps': sorted(([k, v] for k, v in facts['idle'].items()),
                                key=lambda r: -r[1]),
            'idle_share_on_spans': on_spans / idle_s if idle_s > 0
            else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    args = p.parse_args(argv)
    import torch
    from benchmark import run
    if not torch.cuda.is_available():
        print('benchmark.spans: needs a CUDA device', file=sys.stderr)
        return 2
    tracers = []

    class Kept(tr.Tracer):
        def __init__(self, seconds):
            super().__init__(seconds)
            tracers.append(self)

    tr.Tracer = Kept
    result = run.run_cell(args.workload, args.seed, args.seconds, True)
    tracer = tracers[0]
    result['spans'] = per_unit(span_facts(tracer.prof), tracer.units)
    result['spans']['requests'] = tracer.requests
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

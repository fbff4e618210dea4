"""Readings that the limits of `correct` are set from: one cell's sound
runs over many seeds and its control over a few, in one process.

    python3 -m benchmark.calibrate --workload <cell> --seconds <s> \
        --seeds 11,12,... --control-seeds 21,22,23

Each seed builds the cell afresh, serves its traffic for a short window
and compares a sample of the window's requests with the reference, as a
run of benchmark.run does; the control serves the same traffic with the
program's int8 path (`CodeFormerRestorer(quant='int8')`), the precision
below the configuration's bf16. One JSON line a seed on standard
output, then the largest sound and the smallest control reading of each
number. Not run by the benchmark's own runs.
"""
from __future__ import annotations

import argparse
import json
import sys


def readings(workload, seeds, seconds, system_kwargs=None, **kw):
    from benchmark.run import run_cell
    out = []
    for seed in seeds:
        r = run_cell(workload, seed, seconds, False,
                     system_kwargs=system_kwargs, **kw)
        row = {'seed': seed, 'correct': r['correct'],
               'attempted': r['attempted'], 'failed': r['failed'],
               **r['info']['readings']}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seconds', type=float, default=3.0)
    p.add_argument('--seeds', default='')
    p.add_argument('--control-seeds', default='')
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(',') if s]
    cseeds = [int(s) for s in args.control_seeds.split(',') if s]
    sound = readings(args.workload, seeds, args.seconds)
    control = readings(args.workload, cseeds, args.seconds,
                       {'quant': 'int8'})
    keys = [k for k in (sound or control or [{}])[0]
            if k not in ('seed', 'correct', 'attempted', 'failed')]
    summary = {'sound_max': {k: max(r[k] for r in sound) for k in keys}
               if sound else {},
               'control_min': {k: min(r[k] for r in control) for k in keys}
               if control else {}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

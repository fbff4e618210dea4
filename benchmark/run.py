"""Run one benchmark cell once on the card and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root. The cell names a configuration
(benchmark/configs/<config>.json), a traffic mix
(benchmark/traffic/<traffic>.json), the limits of its comparison
(benchmark/limits/<cell>.json) and, through BENCHMARK.json, its metrics
(benchmark/metrics/<metric>.py). The configuration's `system`
names the module under benchmark/systems/ that builds the program and
serves a request; the traffic file's parameters drive it.

A run: weights and inputs from the seed on the card, the cell's shapes
warmed up (set-up), then a closed loop with one client for `--seconds`:
each request hands host arrays to the program and waits for host
arrays back. After the window the program is released and a sample of
the window's requests, drawn from the seed, is compared with the plain
reference (benchmark/compare.py). `--trace 1` runs the same window under
torch.profiler and reports the per-layer metrics instead of the
end-to-end ones.

The last line of standard output is the result's JSON; the numbers
compared, each with its limit, are the last lines of standard error and
the result's last key. Without a card the run prints no result and
exits with 2; with jax, flax or the JAX package loaded after the window,
with 3.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'codeformer_tpu')
# seconds of the window a traced run profiles: the reduction of a
# profile of every launch takes about ten times the profiled time on the
# card's host
TRACE_SECONDS = 5.0


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open('/proc/self/stat') as f:
        fields = f.read().rsplit(')', 1)[1].split()
    with open('/proc/uptime') as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf('SC_CLK_TCK')


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is that of JAX, flax or the
    JAX package, compared whole."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(workload: str, bench: dict) -> tuple:
    """(workload entry, configuration, traffic, per-layer metrics and
    end-to-end metrics of this cell) from BENCHMARK.json and the files
    it names."""
    wl = next((w for w in bench['workloads'] if w['name'] == workload),
              None)
    if wl is None:
        raise SystemExit(f'benchmark: no workload {workload!r} in '
                         f'BENCHMARK.json')
    conf = next(c for c in bench['configs'] if c['name'] == wl['config'])
    cfg = load_json(ROOT / conf['file'])
    traffic = load_json(BENCH / 'traffic' / f'{wl["traffic"]}.json')

    def mine(metrics):
        return [m for m in metrics if workload in m.get('workloads',
                                                        [workload])]
    return wl, cfg, traffic, mine(bench['end_to_end']), \
        mine(bench['per_layer'])


def check_traffic(system_mod, traffic: dict) -> None:
    """Refuse a traffic file whose entry or keys its system does not
    implement (`TRAFFIC` of benchmark/systems/<system>.py: the keys of
    each entry), so that no parameter is silently ignored."""
    keys = system_mod.TRAFFIC.get(traffic.get('entry'))
    if keys is None:
        raise SystemExit(f'benchmark: entry {traffic.get("entry")!r} is not '
                         f'served by {system_mod.__name__}')
    unknown = set(traffic) - set(keys) - {'entry'}
    missing = set(keys) - set(traffic)
    if unknown or missing:
        raise SystemExit(f'benchmark: traffic keys not implemented: '
                         f'{sorted(unknown)}; missing: {sorted(missing)}')


def reader(name: str):
    """The metric's reader module: metrics/<name>.py, else the file of
    its family, metrics/<name up to the first dot>.py."""
    for stem in (name, name.split('.')[0]):
        path = BENCH / 'metrics' / f'{stem}.py'
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f'benchmark.metrics.{stem.replace(".", "_")}', path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module
    raise SystemExit(f'benchmark: no reader for metric {name!r}')


def percentile(values, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, float), q))


class RequestFailed(Exception):
    def __init__(self, text: str):
        super().__init__(text)
        self.text = text


def served(system, deadline: float):
    """The window's closed loop with one client: (request index, host
    output, units, time the request was handed over) as each completes,
    until the deadline. A stream system runs as one stream whose chunks
    are the requests; a failed request ends the window."""
    from benchmark import trace as tr
    if getattr(system, 'streams', False):
        t_req = time.perf_counter()
        try:
            for i, out, n in system.stream(deadline):
                yield i, out, n, t_req
                t_req = time.perf_counter()
        except Exception:
            raise RequestFailed(traceback.format_exc())
        return
    i = 0
    while i < len(system.order):
        t_req = time.perf_counter()
        if t_req >= deadline:
            return
        try:
            with tr.span('request'):
                out, n = system.request(i)
        except Exception:
            raise RequestFailed(traceback.format_exc())
        yield i, out, n, t_req
        i += 1


class Reservoir:
    """A uniform sample of `k` of the window's requests, drawn from the
    seed as they complete (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        import numpy as np
        self.k, self.rng = k, np.random.default_rng(seed)
        self.kept, self.seen = [], 0

    def offer(self, i: int, out):
        """Keep request i or not; returns the request let go (i itself,
        one it replaced, or None)."""
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((i, out))
            return None
        j = int(self.rng.integers(0, self.seen))
        if j >= self.k:
            return i
        dropped = self.kept[j][0]
        self.kept[j] = (i, out)
        return dropped


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = 'cuda', bench: dict = None,
             system_kwargs: dict = None, cfg: dict = None,
             traffic: dict = None) -> dict:
    """One run of one cell; returns the result's dict (printed by
    `main`). `bench` defaults to BENCHMARK.json; `cfg` and `traffic`, if
    given, stand in for the cell's files (the CPU tests' small
    topology), `system_kwargs` go to the system (the control's int8)."""
    import torch
    from benchmark import compare
    from benchmark import trace as tr
    bench = bench or load_json(ROOT / 'BENCHMARK.json')
    wl, cfg_file, traffic_file, e2e, per_layer = cell(workload, bench)
    cfg, traffic = cfg or cfg_file, traffic or traffic_file
    seed = int(seed) & (2 ** 63 - 1)
    system_mod = importlib.import_module(f'benchmark.systems.{cfg["system"]}')
    check_traffic(system_mod, traffic)
    on_card = torch.device(device).type == 'cuda'

    parts = {'imports': process_age_s()}
    system = system_mod.System(cfg, traffic, seed, device,
                               **(system_kwargs or {}))
    if on_card:
        torch.cuda.synchronize()
    parts['built'] = process_age_s()
    system.warmup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = parts['warm'] = process_age_s()

    if trace and hasattr(system, 'instrument'):
        system.instrument()
    setup_peak = 0
    if on_card:   # the window's own peak from here on
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    latencies, units, attempted, failed = [], 0, 0, 0
    reservoir = Reservoir(traffic['check_requests'], seed)
    tracer = tr.Tracer(TRACE_SECONDS) if trace else None
    t0 = time.perf_counter()
    t_end = t0
    if tracer:
        tracer.start(t0)
    try:
        for i, out, n, t_req in served(system, t0 + seconds):
            t_end = time.perf_counter()
            attempted += 1
            latencies.append(t_end - t_req)
            units += n
            dropped = reservoir.offer(i, out)
            if dropped is not None and hasattr(system, 'drop'):
                system.drop(dropped)
            if tracer:
                tracer.tick(t_end, attempted, units)
    except RequestFailed as err:   # counts as missing
        attempted, failed = attempted + 1, failed + 1
        latencies.append(float('inf'))
        print(err.text, file=sys.stderr)
        t_end = time.perf_counter()
    if tracer:
        tracer.stop(attempted, units)
    window_s = t_end - t0

    metrics = {}
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    peak = max(setup_peak, window_peak)
    extra = {}
    if trace:
        facts = tr.reduce(tracer.prof)
        ctx = {**facts, **system.trace_facts(),
               'requests': tracer.requests, 'units': tracer.units,
               'window_peak_bytes': window_peak}
        ctx['forwards'] = tracer.requests * ctx['forwards_per_request']
        for m in per_layer:
            v = reader(m['name']).read(m['name'], ctx)
            if v is not None:
                metrics[m['name']] = {'value': float(v), 'unit': m['unit']}
        extra = {'busy_s': facts['busy_s'], 'window_s': facts['window_s']}
        brk = tr.breakdown(facts)
    else:
        for m in e2e:
            name = m['name']
            if name == 'setup_s':
                v = setup_s
            elif name == 'latency_p95_ms':
                v = percentile(latencies, 95) * 1e3
            else:   # a rate: units over the window
                v = units / window_s
            metrics[name] = {'value': float(v), 'unit': m['unit']}

    parts['window'] = process_age_s()
    system.release()
    del tracer
    if reservoir.kept:
        numbers = system.check(reservoir.kept)
        limits = load_json(BENCH / 'limits' / f'{workload}.json')
        correct, checks = compare.verdict(numbers, limits)
    else:
        numbers, correct, checks = {}, False, {}
    result = {'correct': bool(correct and not failed),
              'attempted': attempted, 'failed': failed,
              'metrics': metrics,
              'device': {'platform': 'gpu' if on_card else 'cpu',
                         'kind': (torch.cuda.get_device_name(device)
                                  if on_card else 'cpu'),
                         'count': 1, 'memory_peak_bytes': int(peak),
                         **extra}}
    if trace:
        result['breakdown'] = brk
    result['info'] = {'window_s': window_s, 'units': units,
                      'latency_p50_ms': percentile(latencies, 50) * 1e3
                      if latencies else None,
                      'sampled': len(reservoir.kept),
                      'readings': numbers,
                      'process_s': {**parts, 'checked': process_age_s()},
                      'setup_parts_s': getattr(system, 'setup_parts', {})}
    result['checks'] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch
    bench = load_json(ROOT / 'BENCHMARK.json')
    chips = cell(args.workload, bench)[0]['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'benchmark: the cell needs {chips} CUDA device(s); '
              f'torch.cuda.is_available()={torch.cuda.is_available()}, '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
              f' found', file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), bench=bench)
    found = forbidden_modules()
    if found:
        print(f'benchmark: loaded after the window: {", ".join(found)}',
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    for name, c in result['checks'].items():
        print(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    print(f'correct: {result["correct"]}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

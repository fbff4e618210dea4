"""The traced run's reductions on a synthetic profile whose numbers are
worked out by hand: benchmark/trace.py `reduce` (what the per-layer
metrics read), unchanged by the program's `cf.` ranges, and
benchmark/spans.py `span_facts`, which joins those ranges to the device
timeline.

The timeline, in microseconds: the window [0, 1000]; request A
[10, 500] holds cf.restore [20, 480] with cf.model.encode [20, 100],
cf.model.transformer [100, 300] and cf.model.generate [300, 480]; a
detect stage [520, 590]; request B [600, 990] with no program span.
Device: kernel kA [50, 150] and [350, 400], kB [140, 200], a copy
[700, 720], and request A's range mirrored onto the device [50, 400].
Busy: [50, 200] + [350, 400] + [700, 720] = 220. Gaps begin at 0 (no
range open), 200 (transformer), 400 (generate) and 720 (request B).
"""
from types import SimpleNamespace

import pytest
import torch

from benchmark import spans, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _evt(name, start, end, device=CPU, device_us=0.0, annotation=False):
    return SimpleNamespace(
        name=name, device_type=device,
        time_range=SimpleNamespace(start=float(start), end=float(end)),
        device_time_total=float(device_us), is_user_annotation=annotation,
        cpu_children=[])


def _profile(program_spans=True, mirrored_program=False):
    events = [
        _evt('bench.window', 0, 1000, annotation=True),
        _evt('bench.request', 10, 500, device_us=210, annotation=True),
        _evt('bench.stage.detect', 520, 590, device_us=40, annotation=True),
        _evt('bench.request', 600, 990, device_us=20, annotation=True),
        _evt('kA', 50, 150, CUDA), _evt('kB', 140, 200, CUDA),
        _evt('kA', 350, 400, CUDA),
        _evt('Memcpy DtoH (Device -> Pageable)', 700, 720, CUDA),
        _evt('bench.request', 50, 400, CUDA, annotation=True),
    ]
    if program_spans:
        events += [_evt('cf.restore', 20, 480, device_us=210),
                   _evt('cf.model.encode', 20, 100, device_us=100),
                   _evt('cf.model.transformer', 100, 300, device_us=60),
                   _evt('cf.model.generate', 300, 480, device_us=50)]
    if mirrored_program:
        events.append(_evt('cf.restore', 50, 400, CUDA, annotation=True))
    return SimpleNamespace(events=lambda: events)


BY_HAND = {'busy_s': 220e-6, 'window_s': 1000e-6, 'launches': 3,
           'kernels': {'kA': (150e-6, 2), 'kB': (60e-6, 1),
                       'Memcpy DtoH (Device -> Pageable)': (20e-6, 1)},
           'idle': {'host': 50e-6, 'request': 730e-6},
           'stages': {'detect': 40e-6}}


def _approx(facts):
    return {k: (pytest.approx(v) if isinstance(v, float) else
                {kk: pytest.approx(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else v)
            for k, v in facts.items()}


@pytest.mark.parametrize('program_spans', [False, True])
def test_reduce_reads_by_hand_with_or_without_program_spans(program_spans):
    """The accepted reduction reads the same with the program's host
    ranges in the trace: they are neither device work nor gap labels."""
    assert trace.reduce(_profile(program_spans)) == _approx(BY_HAND)


def test_span_facts_charge_gaps_to_the_innermost_span():
    facts = spans.span_facts(_profile())
    assert facts['busy_s'] == pytest.approx(BY_HAND['busy_s'])
    assert facts['window_s'] == pytest.approx(BY_HAND['window_s'])
    assert facts['idle'] == _approx({
        'host': 50e-6, 'cf.model.transformer': 150e-6,
        'cf.model.generate': 300e-6, 'request': 280e-6})
    assert facts['span_idle_s'] == _approx({
        'restore': 450e-6, 'model.encode': 0.0,
        'model.transformer': 150e-6, 'model.generate': 300e-6})
    assert facts['span_s'] == _approx({
        'restore': 210e-6, 'model.encode': 100e-6,
        'model.transformer': 60e-6, 'model.generate': 50e-6})


def test_span_facts_leave_mirrored_program_ranges_out_of_device_work():
    """A program range copied onto the device's timeline (a user
    annotation) is no device work."""
    facts = spans.span_facts(_profile(mirrored_program=True))
    assert facts['busy_s'] == pytest.approx(220e-6)
    assert sum(facts['idle'].values()) == pytest.approx(780e-6)


def test_per_unit_divides_by_the_windows_units():
    out = spans.per_unit(spans.span_facts(_profile()), units=2)
    assert out['busy_ms'] == pytest.approx(0.11)
    assert out['span_ms']['restore'] == pytest.approx(0.105)
    assert out['idle_ms']['model.generate'] == pytest.approx(0.15)
    assert 'detect' not in out['span_ms'] and 'detect' not in out['idle_ms']
    assert out['idle_share_on_spans'] == pytest.approx(450 / 780)
    assert out['idle_gaps'][0] == ['cf.model.generate', pytest.approx(3e-4)]
    assert spans.per_unit(spans.span_facts(_profile()), units=0) == {}

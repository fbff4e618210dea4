"""The control of `correct`, on the card at each cell's own size: the
configuration computed a precision lower (the program's int8 restorer;
for the photo cells also the detector's heads from the reference in
float8) has to come out not correct on every seed, and sound runs
correct. A short window at the cell's own load; one process a cell.

    python3 -m pytest benchmark/tests/test_bench_control.py -q

(about 2 minutes a cell on one H100)."""
import pytest

from benchmark.calibrate import readings

pytestmark = pytest.mark.card

CELLS = ('codeformer.aligned_b16', 'codeformer_photos.stream_4faces',
         'codeformer.aligned_b1')
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(card, cell):
    rows = readings(cell, SEEDS, 3.0, {'quant': 'int8'})
    assert not any(r['correct'] for r in rows), rows


@pytest.mark.parametrize('cell', CELLS)
def test_sound_runs_are_correct(card, cell):
    rows = readings(cell, SEEDS[:1], 3.0)
    assert all(r['correct'] for r in rows), rows

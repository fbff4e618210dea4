"""The one seam between Python and the kernel library
(codeformer_tpu_torch/kernels/build.py `launch`): each launch gets the
device index and current stream of its tensor appended, a return code
mapped to an error, and a count under its entry only if it succeeded;
the counter has one fixed key set. The loaded library and the device
lookup are stand-ins here: this host has no card.
"""
import pytest

torch = pytest.importorskip('torch')

from codeformer_tpu_torch.kernels import build  # noqa: E402

LAUNCHES = [name[3:] for name in build.SIGNATURES
            if name not in build.QUERIES]
DEVICE, STREAM = 3, 0x5eed


class _Library:
    """Answers every `cf_*` entry with `rc` and records its arguments."""

    def __init__(self, rc):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.rc
        return entry


@pytest.fixture
def stub(monkeypatch):
    def install(rc):
        lib = _Library(rc)
        monkeypatch.setattr(build, '_lib', lib)
        monkeypatch.setattr(build, '_device_and_stream',
                            lambda t: (DEVICE, STREAM))
        return lib
    build.reset_launch_counts()
    yield install
    build.reset_launch_counts()


def _zeros():
    return dict.fromkeys(LAUNCHES + ['int_mm'], 0)


def test_the_key_set_is_every_launch_entry_and_int_mm():
    assert set(build.launch_counts()) == set(_zeros())
    assert not set(build.launch_counts()) & {q[3:] for q in build.QUERIES}


@pytest.mark.parametrize('entry', LAUNCHES)
def test_a_zero_return_is_counted_under_its_entry(stub, entry):
    lib = stub(0)
    build.launch(entry, 11, None, 7, on=torch.empty(1))
    assert lib.calls == [(f'cf_{entry}', (11, None, 7, DEVICE, STREAM))]
    assert build.launch_counts() == dict(_zeros(), **{entry: 1})


def test_a_negative_return_raises_the_tensor_map_error(stub):
    stub(-701)
    with pytest.raises(RuntimeError, match=r'conv3x3_dots: a tensor map '
                       r'could not be encoded: CUresult 701'):
        build.launch('conv3x3_dots', on=torch.empty(1))
    assert build.launch_counts() == _zeros()


def test_a_positive_return_raises_the_launch_error(stub):
    stub(700)
    with pytest.raises(RuntimeError, match=r'nearest_code kernel launch '
                       r'failed: cudaError 700'):
        build.launch('nearest_code', on=torch.empty(1))
    assert build.launch_counts() == _zeros()


def test_a_tensor_off_the_card_is_refused_before_the_library(monkeypatch):
    monkeypatch.setattr(build, 'library', lambda: pytest.fail('loaded'))
    build.reset_launch_counts()
    with pytest.raises(RuntimeError, match='no kernel for device cpu'):
        build.launch('conv3x3_dense', on=torch.empty(1))
    assert build.launch_counts() == _zeros()


def test_negative_adds_then_a_reset_give_the_key_set_at_zero(stub):
    build.add_launch_counts({'conv3x3_dense': -346, 'int_mm': -2})
    got = build.launch_counts()
    assert got['conv3x3_dense'] == -346 and got['int_mm'] == -2
    build.reset_launch_counts()
    assert build.launch_counts() == _zeros()


def test_torch_launches_are_counted_beside_the_kernels(stub):
    build.count('int_mm')
    build.count('int_mm', 2)
    assert build.launch_counts() == dict(_zeros(), int_mm=3)
    with pytest.raises(KeyError):
        build.count('an_uncounted_kernel')

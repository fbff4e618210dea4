"""The restorer's CUDA-graph forward on the card: every replay equals
the eager forward of the same restorer bit for bit, at B=1 and B=16, in
bf16 (the kernels) and fp32 (the plain path), each forward hands the
codebook lookup one index tensor of its own, and the launch counter
reads the same after a capture or a replay as after an eager forward.

Marked `card`: skipped without a CUDA device. This file imports no JAX,
so the card's machine runs it without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_restorer_cuda.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from codeformer_tpu_torch.kernels.build import launch_counts, reset_launch_counts  # noqa: E402
from codeformer_tpu_torch.models import CodeFormer  # noqa: E402
from codeformer_tpu_torch.pipeline import restorer as restorer_mod  # noqa: E402
from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer  # noqa: E402

TINY = dict(img_size=64, nf=32, ch_mult=(1, 2, 4), codebook_size=64,
            emb_dim=16, dim_embd=64, n_head=4, n_layers=2, latent_size=256,
            connect_list=('32',))

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: CUDA graphs capture only there')


def _restorer(dtype, quant=None):
    torch.manual_seed(0)
    return CodeFormerRestorer(device='cuda', dtype=dtype,
                              model=CodeFormer(**TINY), face_size=64,
                              batch_buckets=(1, 16), quant=quant)


def _batches(bsz, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, (bsz, 64, 64, 3), generator=g,
                          dtype=torch.uint8).cuda() for _ in range(n)]


def _recorded(restorer):
    """Index tensors handed to the lookup, kept by reference (as the
    benchmark's CodeRecorder keeps them)."""
    seen = []
    lookup = restorer.model.quantize.get_codebook_feat

    def recorded(indices, *a, **kw):
        seen.append(indices)
        return lookup(indices, *a, **kw)
    restorer.model.quantize.get_codebook_feat = recorded
    return seen


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('bsz', [1, 16])
def test_replay_equals_eager(card, dtype, bsz):
    """n same-key calls: one capture (its output is the eager forward's),
    n - 1 replays, every output and every recorded code equal to the
    eager forward's on the same batch, outputs and codes distinct
    tensors."""
    r = _restorer(dtype)
    xs = _batches(bsz, 3)
    seen = _recorded(r)
    with restorer_mod.eager_forwards():
        eager = [r.restore_device(x) for x in xs]
    eager_codes = [c.clone() for c in seen]
    seen.clear()
    assert r.graph_counts() == {'captures': 0, 'replays': 0, 'eager': 3}
    r.reset_graph_counts()
    order = [0, 1, 2, 2, 0, 1]
    outs = [r.restore_device(xs[i]) for i in order]
    torch.cuda.synchronize()
    assert r.graph_counts() == {'captures': 1, 'replays': 5, 'eager': 0}
    for i, out, code in zip(order, outs, seen):
        assert out.dtype == torch.uint8 and torch.equal(out, eager[i])
        assert torch.equal(code, eager_codes[i])
    assert len(seen) == len(order)
    assert len({o.data_ptr() for o in outs}) == len(outs)
    assert len({c.data_ptr() for c in seen}) == len(seen)


def test_successive_outputs_do_not_alias(card):
    """A replay's output is a fresh tensor: a caller may keep one batch's
    output while the next runs (the fused pipeline keeps out[:r])."""
    r = _restorer(torch.bfloat16)
    a, b = _batches(16, 2, seed=1)
    r.restore_device(a)                 # the capture
    ya = r.restore_device(a)
    keep = ya.clone()
    yb = r.restore_device(b)
    torch.cuda.synchronize()
    assert ya.data_ptr() != yb.data_ptr()
    assert torch.equal(ya, keep) and not torch.equal(ya, yb)


def test_new_w_captures_a_new_key(card):
    """w is part of the key: a new w captures, its replays follow it,
    and the first w's graphs still replay."""
    r = _restorer(torch.bfloat16)
    (x,) = _batches(1, 1, seed=2)
    with restorer_mod.eager_forwards():
        want = {w: r.restore_device(x, w=w) for w in (0.5, 0.8)}
    r.reset_graph_counts()
    got = [(w, r.restore_device(x, w=w)) for w in (0.5, 0.8, 0.8, 0.5)]
    assert r.graph_counts() == {'captures': 2, 'replays': 2, 'eager': 0}
    assert len(r._graphs) == 2
    for w, y in got:
        assert torch.equal(y, want[w])


def test_keys_interleave_in_one_pool(card):
    """Two keys (B=1 and B=16) captured into the restorer's one pool and
    replayed in turns on new inputs: each replay equals the eager
    forward on its batch."""
    r = _restorer(torch.bfloat16)
    xs = {1: _batches(1, 2, seed=3), 16: _batches(16, 2, seed=4)}
    with restorer_mod.eager_forwards():
        want = {(b, i): r.restore_device(xs[b][i]) for b in xs
                for i in range(2)}
    r.reset_graph_counts()
    order = [(1, 0), (16, 0), (1, 1), (16, 1), (16, 0), (1, 0), (1, 1)]
    got = [(k, r.restore_device(xs[k[0]][k[1]])) for k in order]
    torch.cuda.synchronize()
    assert r.graph_counts() == {'captures': 2, 'replays': 5, 'eager': 0}
    assert len({g.a.pool() for g in r._graphs.values()}) == 1
    for k, y in got:
        assert torch.equal(y, want[k]), k


@pytest.mark.parametrize('quant', [None, 'int8'])
def test_replays_count_what_they_launch(card, quant):
    """A capture records launches without running them and a replay runs
    them: after the capture and after each replay the counter reads
    what the eager forward launched (K1/K2, or the int8 path's
    _int_mm calls)."""
    r = _restorer(torch.bfloat16, quant)
    (x,) = _batches(16, 1, seed=5)
    reset_launch_counts()
    with restorer_mod.eager_forwards():
        r.restore_device(x)
    eager = launch_counts()
    assert eager['int_mm' if quant else 'conv3x3_dots'] > 0
    for _ in range(3):                  # the capture, then two replays
        reset_launch_counts()
        r.restore_device(x)
        assert launch_counts() == eager
    assert r.graph_counts() == {'captures': 1, 'replays': 2, 'eager': 1}

"""The stage-entry statistics kernel (csrc/channel_stats.cu, ops/conv3x3.py
`entry_stats`) on the card: every slot against the exact (fp64) sums of
its pixels at every entry map of a serving forward at B = 1, 16 and 64
and on maps ragged against the slots; on near-constant maps the fold
that gn_affine makes of its sums no farther from the exact one than the
fold of torch's channel_stats (or the best fp32 sums can give); what it
refuses on the card; and a full-width serving forward's launches, eager
and replayed: 33 statistics, K1 65, K2 5.

Marked `card`: skipped without a CUDA device. This file imports no JAX,
so the card's machine runs it without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_channel_stats_cuda.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import chip_smoke  # noqa: E402
from codeformer_tpu_torch.kernels.build import launch_counts, reset_launch_counts  # noqa: E402
from codeformer_tpu_torch.ops import conv3x3 as cv  # noqa: E402

pytestmark = pytest.mark.card

MAPS = [(b, h, h, c) for b in (1, 16, 64)
        for h, c, _ in chip_smoke.STATS_ENTRY_SHAPES] + [
    (3, 37, 53, 96), (1, 37, 53, 96), (2, 7, 300, 32), (5, 13, 11, 2048)]
# near-constant maps (seed, B, H=W, C, level): tests/test_torch_conv3x3.py's
# levels, and the forward's largest maps at its batches; randn * 0.01 on
# the even channels, in bf16
NEAR_CONSTANT = [(43, 1, 128, 64, 85.28), (97, 1, 128, 64, 89.21),
                 (104, 1, 128, 64, 57.16), (106, 1, 64, 64, 252.53),
                 (1, 16, 512, 64, 89.21), (2, 1, 512, 128, 57.16),
                 (3, 16, 256, 256, 252.53), (4, 64, 64, 512, 3.0)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the statistics kernel runs only '
                    'there')


@pytest.mark.parametrize('shape', MAPS, ids=lambda s: 'x'.join(map(str, s)))
def test_every_slot_matches_the_exact_sums(card, shape):
    """Each slot's [sum, sumsq] within STATS_BOUND of the fp64 sums of its
    pixels, relative to sum |x| and sum x^2; the slots summed no farther
    from the exact totals than torch's channel_stats."""
    bsz, h, w, c = shape
    g = torch.Generator(device='cuda').manual_seed(bsz * 1000 + h + c)
    x = (torch.randn(bsz, h, w, c, generator=g, device='cuda') * 2 + 0.5) \
        .to(torch.bfloat16)
    st = cv.entry_stats(x)
    slots, _ = cv.stats_slot_plan(bsz, h * w, c,
                                  torch.cuda.get_device_properties(0)
                                  .multi_processor_count)
    assert st.shape == (bsz, slots, 2, c) and st.dtype == torch.float32
    assert chip_smoke.stats_errors(st, x)[0] <= chip_smoke.STATS_BOUND
    exact, scale = chip_smoke.stats_slot_sums(x, h * w)
    total = (st.double().sum(1, keepdim=True) - exact).abs() / scale
    ref = (cv.channel_stats(x).double() - exact).abs() / scale
    assert float(total.max()) <= max(float(ref.max()), 1e-7)
    assert torch.equal(st, cv.entry_stats(x))        # deterministic


def _fold_error(stats, xd, c, hw):
    """max over samples and groups of |a - a_exact| / a_exact, a =
    rsqrt(var + eps) as gn_affine folds it (gamma 1, beta 0), a_exact from
    the fp64 variance of the bf16 map."""
    ones = torch.ones(c, device=xd.device)
    a, _ = cv.gn_affine(stats, ones, torch.zeros_like(ones), hw)
    bsz = xd.shape[0]
    var = xd.reshape(bsz, hw, 32, c // 32).var((1, 3), unbiased=False)
    a_exact = (var + 1e-6).rsqrt().repeat_interleave(c // 32, 1)
    return float(((a.double() - a_exact).abs() / a_exact).max())


@pytest.mark.parametrize('seed,bsz,hw,c,level', NEAR_CONSTANT, ids=str)
def test_near_constant_fold_is_no_worse(card, seed, bsz, hw, c, level):
    """Queue 1's case: where |mean| >> std, E[x^2] - mean^2 in fp32 loses
    the variance. The fold of the kernel's sums is no farther from the
    exact fold than that of torch's channel_stats or, where that reads
    better by chance of rounding, than that of the exact sums rounded once
    to fp32: the best any fp32 statistics give through gn_affine."""
    rng = np.random.default_rng(seed)
    x = np.full((bsz, hw, hw, c), level, np.float32)
    x[..., ::2] += rng.standard_normal((bsz, hw, hw, c // 2)).astype(
        np.float32) * 0.01
    x = torch.from_numpy(x).cuda().to(torch.bfloat16)
    xd = x.double()
    best = torch.stack([xd.sum((1, 2)), xd.square().sum((1, 2))],
                       1)[:, None].float()
    errs = {name: _fold_error(st, xd, c, hw * hw) for name, st in (
        ('kernel', cv.entry_stats(x)), ('torch', cv.channel_stats(x)),
        ('best fp32', best))}
    assert errs['kernel'] <= max(errs['torch'], errs['best fp32'])


def test_the_card_refuses_what_the_kernel_cannot_take(card):
    x = torch.zeros(1, 8, 8, 64, device='cuda')
    with pytest.raises(TypeError, match='bfloat16'):
        cv.entry_stats(x)
    with pytest.raises(ValueError, match='contiguous'):
        cv.entry_stats(x.to(torch.bfloat16)[:, :, ::2])
    with pytest.raises(RuntimeError, match='forward-only'):
        cv.entry_stats(x.to(torch.bfloat16).requires_grad_())


def test_a_serving_forward_counts_33_entries(card):
    """A full-width serving forward launches the statistics kernel at each
    of its 33 stage entries, K1 65 times and K2 5 times, eager and as a
    CUDA graph's capture and replay, at B = 1 and 16."""
    from codeformer_tpu_torch.pipeline.restorer import (CodeFormerRestorer,
                                                        eager_forwards)
    r = CodeFormerRestorer(device='cuda', seed=0)
    chip_smoke.tame_sft(r.model)
    faces = torch.from_numpy(np.stack(chip_smoke._faces(
        np.random.default_rng(0), 16))).cuda()
    want = dict(dict.fromkeys(launch_counts(), 0),
                **chip_smoke.forward_launches(32))
    assert want['channel_stats'] == 33 and want['conv3x3_dots'] == 65
    for bsz in (1, 16):
        reset_launch_counts()
        with eager_forwards():
            r.restore_device(faces[:bsz])
        torch.cuda.synchronize()
        assert launch_counts() == want, ('eager', bsz)
        for step in ('capture', 'replay'):
            reset_launch_counts()
            r.restore_device(faces[:bsz])
            torch.cuda.synchronize()
            assert launch_counts() == want, (step, bsz)

"""The stage-entry statistics (ops/conv3x3.py `entry_stats`,
csrc/channel_stats.cu) on the host: the slots that `stats_slot_plan`
lays out, an emulation of the kernel's walk over a slot built from the
CUDA source's loops, the wrapper's plain path and what it refuses, the
arguments it hands the library, and Encoder and Generator forwards on
the CPU unchanged by the kernel's wrapper.
"""
import pytest

torch = pytest.importorskip('torch')

import chip_smoke  # noqa: E402
from codeformer_tpu_torch.kernels import build  # noqa: E402
from codeformer_tpu_torch.nn import blocks as pb  # noqa: E402
from codeformer_tpu_torch.ops import conv3x3 as cv  # noqa: E402

H100_SMS = 132
# (B, H*W, C): every entry map of a serving forward at B = 1, 16 and 64,
# maps ragged against the slots, one pixel, the widest C the kernel takes
PLAN_CASES = sorted(
    {(b, h * h, c) for b in (1, 16, 64)
     for h, c, _ in chip_smoke.STATS_ENTRY_SHAPES}
    | {(3, 37 * 53, 96), (1, 37 * 53, 96), (2, 7 * 300, 32), (1, 1, 64),
       (5, 13 * 11, 2048), (600, 16 * 16, 512), (7, 4099, 64)})


def _ranges(bsz, hw, c, sms=H100_SMS):
    slots, n = cv.stats_slot_plan(bsz, hw, c, sms)
    return slots, n, [(s * n, min(hw, (s + 1) * n)) for s in range(slots)]


@pytest.mark.parametrize('case', PLAN_CASES, ids=str)
def test_slots_cover_every_pixel_once(case):
    """Slot s holds [s n, min(hw, (s + 1) n)): consecutive, none empty,
    together every pixel once; within the grid's limits and the kernel's
    checks (csrc/channel_stats.cu cf_channel_stats); a slot reads at
    least STATS_MIN_SLOT_BYTES unless the map has only one."""
    bsz, hw, c = case
    slots, n, ranges = _ranges(bsz, hw, c)
    assert 1 <= slots <= 65535 and n >= 1
    assert slots * n >= hw > (slots - 1) * n
    assert ranges[0][0] == 0 and ranges[-1][1] == hw
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if slots > 1:
        assert n * c * 2 >= cv.STATS_MIN_SLOT_BYTES


@pytest.mark.parametrize('sms', [132, 114, 78])
@pytest.mark.parametrize('bsz', [1, 2, 16, 64])
def test_slots_fill_the_card_in_one_wave(bsz, sms):
    """Every entry map large enough for it gives the grid (slots, B) at
    least two blocks an SM, at B = 1 too, and never more than one wave
    of STATS_BLOCKS_PER_SM blocks an SM; the plan depends on the shape
    and the SM count alone."""
    for h, c, _ in chip_smoke.STATS_ENTRY_SHAPES:
        hw = h * h
        slots, _ = cv.stats_slot_plan(bsz, hw, c, sms)
        assert bsz * slots <= max(bsz, cv.STATS_BLOCKS_PER_SM * sms)
        if bsz * hw * c * 2 >= 2 * sms * bsz * cv.STATS_MIN_SLOT_BYTES:
            assert bsz * slots >= 2 * sms, (h, c)
        assert cv.stats_slot_plan(bsz, hw, c, sms) == (slots, _)


def _walk(hw, c, n, s):
    """The pixels of slot s that the kernel's threads read, as the loops of
    csrc/channel_stats.cu walk them: {pixel: (thread row, 'group' or
    'tail')}."""
    rows = cv.STATS_THREADS // (c // 8)
    p0, p1 = s * n, min(hw, (s + 1) * n)
    seen = {}
    for r in range(rows):
        p = p0 + r
        while p + 3 * rows < p1:
            g = 0
            while g < 16 and p + 3 * rows < p1:
                for u in range(4):
                    assert p + u * rows not in seen
                    seen[p + u * rows] = (r, 'group')
                p += 4 * rows
                g += 1
        while p < p1:
            assert p not in seen
            seen[p] = (r, 'tail')
            p += rows
    return seen


@pytest.mark.parametrize('bsz,hw,c', [(3, 37 * 53, 96), (1, 64 * 64, 512),
                                      (2, 7 * 300, 32), (16, 32 * 32, 256),
                                      (5, 13 * 11, 2048), (1, 1, 64)])
def test_kernel_walk_reads_each_pixel_once(bsz, hw, c):
    """Each slot's threads read every pixel of the slot exactly once, in
    groups of four and a tail of fewer than four a thread; the planted
    'ragged tail dropped' fault of chip_smoke drops exactly those tail
    pixels."""
    slots, n, ranges = _ranges(bsz, hw, c)
    rows = cv.STATS_THREADS // (c // 8)
    tails = set()
    for s, (lo, hi) in enumerate(ranges):
        seen = _walk(hw, c, n, s)
        assert sorted(seen) == list(range(lo, hi))
        for r in range(rows):
            mine = [p for p, (rr, _) in seen.items() if rr == r]
            tail = [p for p in mine if seen[p][1] == 'tail']
            assert len(tail) < 4 and len(tail) == len(mine) % 4
        tails |= {p for p, (_, kind) in seen.items() if kind == 'tail'}
    # the fault's mask, as chip_smoke.stats_planted computes it
    p = torch.arange(hw)
    i = p % n
    length = (hw - (p - i)).clamp(max=n)
    r = i % rows
    mine = (length - r + rows - 1) // rows
    keep = i // rows < mine // 4 * 4
    assert set(torch.nonzero(~keep).flatten().tolist()) == tails


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_the_cpu_takes_the_plain_version(dtype):
    """On the CPU entry_stats is channel_stats, bit for bit (one slot),
    and launches nothing."""
    x = (torch.randn(2, 5, 7, 64) * 3 + 1).to(dtype)
    build.reset_launch_counts()
    got = cv.entry_stats(x)
    assert not any(build.launch_counts().values())
    assert got.shape == (2, 1, 2, 64) and got.dtype == torch.float32
    assert torch.equal(got, cv.channel_stats(x))


@pytest.mark.parametrize('kind', ['fp32', 'strided', 'channels 48',
                                  'channels 4096'])
def test_the_kernel_refuses_what_it_cannot_take(kind):
    x = {'fp32': torch.zeros(1, 4, 4, 64),
         'strided': torch.zeros(1, 4, 8, 64, dtype=torch.bfloat16)[:, :, ::2],
         'channels 48': torch.zeros(1, 4, 4, 48, dtype=torch.bfloat16),
         'channels 4096': torch.zeros(1, 2, 2, 4096, dtype=torch.bfloat16),
         }[kind]
    with pytest.raises((TypeError, ValueError)):
        cv.prepare_stats(x)


def test_off_the_cpu_there_is_no_fallback():
    """A tensor on another device than the CPU goes to the kernel or
    raises: never the plain version; under autograd it is refused."""
    x = torch.empty(1, 4, 4, 64, dtype=torch.bfloat16, device='meta')
    with pytest.raises(RuntimeError, match='no kernel for device meta'):
        cv.entry_stats(x)
    with pytest.raises(RuntimeError, match='forward-only'):
        cv.entry_stats(x.requires_grad_())


class _Library:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize('shape', [(16, 64, 64, 64), (1, 37, 53, 96)],
                         ids=str)
def test_the_launch_hands_the_library_its_slots(monkeypatch, shape):
    """prepare_stats + launch_stats on a (host) tensor with a stand-in
    library: one cf_channel_stats call with the map, the (B, slots, 2, C)
    fp32 output and stats_slot_plan's slots, the arguments SIGNATURES
    declares, counted as channel_stats."""
    lib = _Library()
    monkeypatch.setattr(build, '_lib', lib)
    monkeypatch.setattr(build, '_device_and_stream', lambda t: (0, 7))
    monkeypatch.setattr(cv, '_num_sms', lambda i: H100_SMS)
    bsz, h, w, c = shape
    x = torch.zeros(bsz, h, w, c, dtype=torch.bfloat16)
    build.reset_launch_counts()
    la = cv.prepare_stats(x)
    out = cv.launch_stats(la)
    slots, n = cv.stats_slot_plan(bsz, h * w, c, H100_SMS)
    assert out.shape == (bsz, slots, 2, c) and out.dtype == torch.float32
    assert lib.calls == [('cf_channel_stats', (
        x.data_ptr(), out.data_ptr(), bsz, h * w, c, slots, n, 0, 7))]
    assert len(build.SIGNATURES['cf_channel_stats']) == 9
    assert build.launch_counts()['channel_stats'] == 1
    build.reset_launch_counts()


def _parent_gn_affine(stats, gamma, beta, n_pixels, num_groups=32,
                      eps=1e-6):
    """gn_affine before the slots were summed in fp64: the fp32 sum."""
    s = stats.float().sum(1)
    bsz, _, c = s.shape
    per = c // num_groups
    g = s.reshape(bsz, 2, num_groups, per).sum(-1)
    cnt = n_pixels * per
    mean = g[:, 0] / cnt
    var = (g[:, 1] / cnt - mean * mean).clamp_min(0)
    rstd = torch.rsqrt(var + eps)
    a = rstd.repeat_interleave(per, 1) * gamma.float()[None]
    b = beta.float()[None] - mean.repeat_interleave(per, 1) * a
    return a.contiguous(), b.contiguous()


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('net', ['encoder', 'generator'])
def test_cpu_forwards_are_bit_equal_to_the_parents(monkeypatch, net,
                                                   dtype):
    """An Encoder and a Generator on the CPU's kernel path (eval mode,
    kept operands as on the card) give the same bits as with the
    statistics taken as before this kernel (channel_stats and the fp32
    slot sum), and every stage entry goes through entry_stats: one a
    ResBlock, one for the Generator's tail."""
    from codeformer_tpu_torch.models.vqgan import Encoder, Generator
    torch.manual_seed(5)
    cfg = dict(nf=32, emb_dim=32, ch_mult=(1, 2, 4), num_res_blocks=2,
               resolution=32, attn_resolutions=(8,))
    # fp32 parameters, maps in `dtype`, as the restorer serves
    m = (Encoder(**cfg) if net == 'encoder' else Generator(**cfg)).eval()
    x = torch.randn(2, 3, 32, 32) if net == 'encoder' \
        else torch.randn(2, 32, 8, 8)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    n_res = sum(isinstance(b, pb.ResBlock) for b in m.modules())
    calls = []
    real = cv.entry_stats

    def counted(t):
        calls.append(tuple(t.shape))
        return real(t)
    monkeypatch.setattr(pb, 'on_card', lambda t: True)
    with torch.no_grad():
        monkeypatch.setattr(cv, 'entry_stats', counted)
        got = m(x)
        got = got[0] if net == 'encoder' else got
        monkeypatch.setattr(cv, 'entry_stats', cv.channel_stats)
        monkeypatch.setattr(cv, 'gn_affine', _parent_gn_affine)
        want = m(x)
        want = want[0] if net == 'encoder' else want
    assert len(calls) == n_res + (net == 'generator')
    assert got.dtype == dtype and torch.equal(got, want)

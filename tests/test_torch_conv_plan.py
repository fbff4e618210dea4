"""The geometry around the Hopper conv core (csrc/conv_sm90.cuh), which
runs only on the card: the plan that ops/conv3x3.py `conv_plan` chooses
(K1's included), a tile-walk emulation of the kernels' addressing built
from that plan, the kernel-layout weights, and the modules' operand
caches.

The emulation reads each tile's input window at the TMA box's
coordinates with zero fill outside the tensor, stores it in the 128-byte
swizzled layout, reads each tap's A rows at the ldmatrix addresses and
the weights at the wgmma descriptor's addresses, and sums a split's
partials in the second pass's order. For K1 it also runs the prologue
stage on the swizzled window (the halo zeroed after the activation),
the projected skip's box and resident 1x1 weights, the identity skip
and the statistics slots. It runs in fp32 against the plain versions:
both differ only in summation order, so rtol/atol 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from codeformer_tpu_torch.nn import blocks as pb  # noqa: E402
from codeformer_tpu_torch.ops import conv3x3 as cv  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
SMEM_PER_BLOCK = 232448   # the H100's opt-in maximum

# (stride, B, H, W, Cin, Cout): every shape chip_smoke.py runs a conv of
# (K1's as a bare conv too) and maps ragged against the tile, with
# Cin % 64 == 32 and Cout = 3
PLAN_CASES = sorted(
    {(1, chip_smoke.BATCH, h, h, cin, cout)
     for h, cin, cout, *_ in chip_smoke.K1_SHAPES}
    | {(2, b, h, h, c, c) for b, h, c in chip_smoke.K2_CASES}
    | {(1, b, h, h, cin, cout)
       for b, h, cin, cout in chip_smoke.CONV_BIAS_CASES}
    | {(1, 3, 100, 100, 96, 3), (2, 3, 100, 100, 96, 96),
       (1, 3, 100, 100, 96, 64), (2, 3, 101, 99, 64, 64),
       (1, 1, 7, 300, 32, 32), (2, 1, 3, 3, 32, 32)})


def _m_rows(mb):
    """(oy, ox) in the tile of each A row, in the kernel's order: warpgroup,
    m64 block, warp, then the warp's 16 ldmatrix rows."""
    return [((wg * mb + m) * 4 + wl, lane) for wg in range(2)
            for m in range(mb) for wl in range(4) for lane in range(16)]


@pytest.mark.parametrize('case', PLAN_CASES, ids=str)
def test_plan_fits_and_covers_once(case):
    stride, bsz, h, w, cin, cout = case
    p = cv.conv_plan(bsz, h, w, cin, cout, stride)
    assert (p.mb, p.bn) in cv.VARIANTS[stride]
    assert p.th == cv.tile_h(p.mb)
    assert p.smem <= SMEM_PER_BLOCK and p.stages >= 2
    # the bytes the C side requires: slack, weights, ring, barriers
    w_bytes = p.chunks // p.split * 9 * p.bn * 128
    assert p.smem == 1024 + w_bytes + p.stages * cv.slot_bytes(stride, p.th) \
        + 128
    assert w_bytes % 1024 == 0 and cv.slot_bytes(stride, p.th) % 1024 == 0
    bh, bw = cv.win_hw(stride, p.th)
    assert max(bh, bw) <= 256                       # a TMA box dimension
    # every (split, slice, tile) is walked by exactly one block
    seen = np.zeros((p.split, p.n_slices, p.n_tiles), np.int64)
    for gy in range(p.n_slices * p.split):
        for bx in range(p.grid_x):
            seen[gy // p.n_slices, gy % p.n_slices,
                 np.arange(bx, p.n_tiles, p.grid_x)] += 1
    assert (seen == 1).all()
    # tiles cover every output pixel once; slices every channel once
    assert p.n_tiles == bsz * p.tiles_x * p.tiles_y
    assert (p.tiles_y - 1) * p.th < p.ho <= p.tiles_y * p.th
    assert (p.tiles_x - 1) * cv.SM90_TW < p.wo <= p.tiles_x * cv.SM90_TW
    assert p.n_slices * p.bn == p.coutp and 0 <= p.coutp - cout < 8
    rows = _m_rows(p.mb)
    assert sorted(rows) == [(y, x) for y in range(p.th)
                            for x in range(cv.SM90_TW)]
    # the epilogue: rows lane/4 + 8i, columns 8j + 2q + e of each n8 block
    assert sorted(lane // 4 + 8 * i for lane in range(32)
                  for i in range(2) if lane % 4 == 0) == list(range(16))
    assert sorted(8 * j + 2 * q + e for j in range(p.bn // 8)
                  for q in range(4) for e in range(2)) == list(range(p.bn))
    # a split walks every (tap, chunk) once
    cps = p.chunks // p.split
    walked = sorted((t, s * cps + c) for s in range(p.split)
                    for c in range(cps) for t in range(9))
    assert walked == [(t, c) for t in range(9) for c in range(p.chunks)]


def test_plan_splits_small_maps_and_not_large_ones():
    """A split only where the tiles alone leave the card idle."""
    assert cv.conv_plan(16, 512, 512, 64, 64, 1).split == 1
    assert cv.conv_plan(2, 256, 256, 128, 128, 2).split == 1
    small = cv.conv_plan(2, 32, 32, 256, 256, 2)
    assert small.split > 1
    assert small.n_tiles * small.n_slices * small.split >= 132


def _tma_box(x, b, wy, wx, c0, bh, bw):
    """The TMA box (64 channels, bw, bh, 1) at (c0, wx, wy, b): rows of 64
    channels, zero where a coordinate falls outside x."""
    _, h, w, cin = x.shape
    ys, xs = torch.arange(wy, wy + bh), torch.arange(wx, wx + bw)
    cs = torch.arange(c0, c0 + cv.SM90_KC)
    ok = (((ys >= 0) & (ys < h))[:, None, None]
          & ((xs >= 0) & (xs < w))[None, :, None] & (cs < cin)[None, None])
    v = x[b][ys.clamp(0, h - 1)][:, xs.clamp(0, w - 1)][:, :, cs.clamp(
        max=cin - 1)]
    return torch.where(ok, v, torch.zeros(())).reshape(bh * bw, cv.SM90_KC)


def _emulate(x, ops, p):
    """The kernel, block by block, on fp32 operands."""
    bsz, h, w, _ = x.shape
    s1 = p.stride == 1
    bh, bw = cv.win_hw(p.stride, p.th)
    cps = p.chunks // p.split
    rows = _m_rows(p.mb)
    oyt = torch.tensor([r[0] for r in rows])
    oxt = torch.tensor([r[1] for r in rows])
    row0 = oyt * p.stride * bw + oxt * p.stride       # window row of tap 0
    ws = torch.zeros(p.split, bsz, p.ho, p.wo, p.coutp)
    grp = torch.arange(8)
    for gy in range(p.n_slices * p.split):
        sl, s = gy % p.n_slices, gy // p.n_slices
        n0 = sl * p.bn
        slab = ops.weight[s * cps:(s + 1) * cps, :, n0:n0 + p.bn]
        n = torch.arange(p.bn)
        for bx in range(p.grid_x):
            for tile in range(bx, p.n_tiles, p.grid_x):
                tx = tile % p.tiles_x
                ty = tile // p.tiles_x % p.tiles_y
                b = tile // (p.tiles_x * p.tiles_y)
                wx = tx * 16 - 1 if s1 else 2 * tx * 16
                wy = ty * p.th - 1 if s1 else 2 * ty * p.th
                acc = torch.zeros(len(rows), p.bn)
                for cl in range(cps):
                    win = _tma_box(x, b, wy, wx, (s * cps + cl) * 64, bh, bw)
                    # the 128B swizzle: 16-byte group g of row r at g ^ (r % 8)
                    smem = cv.swizzle_rows(win).reshape(-1, 8, 8)
                    for t in range(9):
                        r = row0 + (t // 3) * bw + t % 3
                        a = torch.zeros(len(rows), 64)
                        for kk in range(4):
                            for hi in range(2):
                                c = 2 * kk + hi     # ldmatrix lane group
                                a[:, 8 * c:8 * c + 8] = smem[r, c ^ (r % 8)]
                        # wgmma descriptor reads: row n, group g ^ (n % 8)
                        bt = slab[cl, t].reshape(p.bn, 8, 8)[
                            n[:, None], grp[None, :] ^ (n[:, None] % 8)]
                        acc += a @ bt.reshape(p.bn, 64).t()
                oy, ox = ty * p.th + oyt, tx * 16 + oxt
                ok = (oy < p.ho) & (ox < p.wo)
                ws[s, b, oy[ok], ox[ok], n0:n0 + p.bn] = acc[ok]
    y = ws[0]
    for s in range(1, p.split):      # the second pass's order
        y = y + ws[s]
    return (y + ops.bias)[..., :ops.cout]


# num_sms 1 makes every plan fill the "card", so the plan takes the best
# variant with no split (the main path's at full size); 132 makes these
# small maps narrow BN and split the input chunks to fill it
@pytest.mark.parametrize('stride,b,h,w,cin,cout,num_sms', [
    (1, 2, 20, 36, 64, 64, 1),       # MB=2 BN=64, ragged against 16 x 16
    (1, 1, 9, 40, 128, 128, 1),      # MB=1 BN=64, two chunks
    (1, 1, 12, 20, 64, 128, 1),      # BN=128
    (1, 2, 17, 17, 96, 3, 132),      # Cin % 64 == 32, Cout = 3, a split
    (1, 1, 9, 40, 64, 96, 132),      # N slices of 16
    (2, 2, 18, 36, 64, 64, 1),       # stride 2, ragged output
    (2, 1, 19, 21, 96, 96, 132),     # odd H and W, Cin % 64 == 32
    (2, 2, 32, 32, 256, 256, 132),   # K2's 32^2 C256 split
])
def test_tile_walk_emulation_matches_plain(stride, b, h, w, cin, cout,
                                           num_sms):
    g = torch.Generator().manual_seed(stride * 1000 + h + cin)
    x = torch.randn(b, h, w, cin, generator=g)
    wt = torch.randn(cout, cin, 3, 3, generator=g) * (9 * cin) ** -0.5
    bias = torch.randn(cout, generator=g) * 0.1
    p = cv.conv_plan(b, h, w, cin, cout, stride, num_sms)
    if num_sms == 1:
        assert p.split == 1 and p.bn == min(cout, 128 if cin == 64 else 64)
    got = _emulate(x, cv.conv_operands(wt, bias, torch.float32), p)
    ref = cv.conv3x3_bias_ref(x, wt, bias) if stride == 1 \
        else cv.downsample_dots_ref(x, wt, bias)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


# ------------------------------------------------------------------ K1
K1_PLAN_CASES = sorted(set(chip_smoke.K1_CASES)
                       | {(3, 100, 96, 64, 'silu', 'proj', 96),
                          (1, 7, 32, 3, 'none', 'none', 0),
                          (1, 16, 512, 512, 'silu', 'proj', 512)})


@pytest.mark.parametrize('case', K1_PLAN_CASES, ids=str)
def test_k1_plan_fits_with_w1_skip_box_and_stats(case):
    """K1's shared memory holds its split's resident 3x3 weights, the
    resident 1x1 weights, the ring, the statistics partials and the
    barriers (full, empty and ready a slot, and the weights'); its BN is
    min(64, Cout) at every shape the forward runs, split where the
    resident weights need it."""
    bsz, h, cin, cout, act, skip, cs = case
    p = cv.conv_plan(bsz, h, h, cin, cout, 1, fused=True, cs=cs)
    assert p.fused and (p.mb, p.bn) in cv.VARIANTS[1]
    assert p.chunks % p.split == 0 and p.bn >= min(64, p.coutp)
    assert p.s_chunks == -(-cs // 64)
    w_bytes = p.chunks // p.split * 9 * p.bn * 128
    w1_bytes = -(-p.s_chunks // p.split) * p.bn * 128
    slot = cv.slot_bytes(1, p.th)
    assert cv.stats_bytes(p.bn) == 8 * 2 * p.bn * 4
    assert p.smem == 1024 + w_bytes + w1_bytes + p.stages * slot \
        + cv.stats_bytes(p.bn) + 128
    assert p.smem <= SMEM_PER_BLOCK and 2 <= p.stages <= cv.MAX_STAGES
    assert (w_bytes + w1_bytes) % 1024 == 0       # the ring stays aligned
    assert p.th * cv.SM90_TW * 128 <= slot         # the skip box's slot
    assert 24 * p.stages + 8 <= cv.BARRIER_BYTES
    assert cv.stats_slots(p) == p.tiles_x * p.tiles_y
    assert p.n_tiles == bsz * cv.stats_slots(p)
    # the bare conv's plan of the same shape may split; K1's may not
    bare = cv.conv_plan(bsz, h, h, cin, cout, 1)
    assert bare.fused is False and bare.s_chunks == 0


def test_k1_plan_splits_wide_inputs_before_narrowing_bn():
    """At 256 and 512 input channels the resident weights of BN = 64 need
    a split; a large map with few channels does not split; a Cout under
    64 takes its own width."""
    p = cv.conv_plan(2, 16, 16, 512, 512, 1, num_sms=1, fused=True)
    assert p.split == 4 and p.bn == 64          # two chunks a split
    p = cv.conv_plan(2, 16, 16, 512, 512, 1, num_sms=1, fused=True, cs=256)
    assert p.split == 4 and p.bn == 64          # and one W1 chunk a split
    p = cv.conv_plan(2, 256, 256, 256, 128, 1, num_sms=1, fused=True)
    assert p.split == 2 and p.bn == 64
    p = cv.conv_plan(8, 512, 512, 64, 64, 1, fused=True)
    assert p.split == 1 and p.bn == 64
    assert cv.conv_plan(2, 512, 512, 64, 3, 1, fused=True).bn == 8
    with pytest.raises(ValueError, match='stride-1'):
        cv.conv_plan(2, 16, 16, 64, 64, 2, fused=True)


def _prologue(smem, a, b, act, dtype, iy, ix, h, w):
    """K1's prologue stage on one swizzled window (rows, 8 groups, 8): the
    physical group pg of row r holds channel group pg ^ (r % 8), so it
    takes the a, b of those channels (`a`, `b`: the chunk's 64, zero past
    Cin); then act(a * v + b), rounded to `dtype`, and 0 at every row
    whose pixel (iy, ix) lies outside the h x w map."""
    r = torch.arange(smem.shape[0])
    logical = torch.arange(8)[None, :] ^ (r[:, None] % 8)      # (rows, 8)
    ch = (8 * logical[..., None] + torch.arange(8)).long()      # (rows, 8, 8)
    v = a[ch] * smem + b[ch]
    v = F.silu(v) if act == 'silu' else v
    inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    return torch.where(inside[:, None, None], v.to(dtype).float(),
                       torch.zeros(()))


def _a_rows(smem, r):
    """The 64 channels of window rows r as ldmatrix reads them: group c
    of row r at physical group c ^ (r % 8)."""
    a = torch.zeros(len(r), 64)
    for c in range(8):
        a[:, 8 * c:8 * c + 8] = smem[r, c ^ (r % 8)]
    return a


def _b_tile(slab):
    """(BN, 64) plain rows of a swizzled weight tile, as the wgmma
    descriptor reads them: row n, group g at g ^ (n % 8)."""
    n = torch.arange(slab.shape[0])
    g = torch.arange(8)
    return slab.reshape(-1, 8, 8)[n[:, None], g[None, :] ^ (n[:, None] % 8)] \
        .reshape(-1, 64)


def _emulate_k1(x, a, b, act, ops, p, skip=None):
    """K1 block by block on fp32 operands: the prologue stage on each
    staged window of the block's split, the nine taps, the projected
    skip's boxes against the resident W1 (its chunks dealt round the
    splits), a split's
    partials summed in split order, then the epilogue (bias, identity
    skip, one rounding) and the statistics slots (one a tile and channel,
    of the rounded y)."""
    bsz, h, w, cin = x.shape
    cout = ops.conv.cout
    bh, bw = cv.win_hw(1, p.th)
    rows = _m_rows(p.mb)
    oyt = torch.tensor([r[0] for r in rows])
    oxt = torch.tensor([r[1] for r in rows])
    row0 = oyt * bw + oxt
    wr = torch.arange(bh * bw)
    a_pad = F.pad(a, (0, p.chunks * 64 - cin))
    b_pad = F.pad(b, (0, p.chunks * 64 - cin))
    y = torch.zeros(bsz, h, w, cout)
    stats = torch.full((bsz, cv.stats_slots(p), 2, cout), float('nan'))
    cps = p.chunks // p.split
    partials = {}
    for gy in range(p.n_slices * p.split):
        sl, s = gy % p.n_slices, gy // p.n_slices
        n0 = sl * p.bn
        for bx in range(p.grid_x):
            for tile in range(bx, p.n_tiles, p.grid_x):
                tx = tile % p.tiles_x
                ty = tile // p.tiles_x % p.tiles_y
                bi = tile // (p.tiles_x * p.tiles_y)
                wy, wx = ty * p.th - 1, tx * 16 - 1
                acc = torch.zeros(len(rows), p.bn)
                for cl in range(s * cps, (s + 1) * cps):
                    win = _tma_box(x, bi, wy, wx, cl * 64, bh, bw)
                    smem = _prologue(
                        cv.swizzle_rows(win).reshape(-1, 8, 8),
                        a_pad[bi, cl * 64:cl * 64 + 64],
                        b_pad[bi, cl * 64:cl * 64 + 64], act, x.dtype,
                        wy + wr // bw, wx + wr % bw, h, w)
                    for t in range(9):
                        r = row0 + (t // 3) * bw + t % 3
                        acc += _a_rows(smem, r) @ _b_tile(
                            ops.conv.weight[cl, t, n0:n0 + p.bn]).t()
                # the projected skip's chunks, dealt round the splits
                for sc in range(s, p.s_chunks, p.split):
                    box = _tma_box(skip, bi, ty * p.th, tx * 16, sc * 64,
                                   p.th, 16)
                    smem = cv.swizzle_rows(box).reshape(-1, 8, 8)
                    acc += _a_rows(smem, oyt * 16 + oxt) @ _b_tile(
                        ops.w1[sc, n0:n0 + p.bn]).t()
                partials[tile, sl, s] = acc
    # the epilogue, or a split's second pass
    for (tile, sl, _), _acc in partials.items():
        if _ > 0:
            continue
        acc = partials[tile, sl, 0]
        for s in range(1, p.split):
            acc = acc + partials[tile, sl, s]
        n0 = sl * p.bn
        cols = slice(n0, min(n0 + p.bn, cout))
        tx = tile % p.tiles_x
        ty = tile // p.tiles_x % p.tiles_y
        bi = tile // (p.tiles_x * p.tiles_y)
        oy, ox = ty * p.th + oyt, tx * 16 + oxt
        ok = (oy < h) & (ox < w)
        v = acc[ok] + ops.conv.bias[n0:n0 + p.bn]
        if skip is not None and ops.w1 is None:
            v[:, :cols.stop - n0] += skip[bi, oy[ok], ox[ok], cols]
        v = v.to(x.dtype).float()[:, :cols.stop - n0]
        y[bi, oy[ok], ox[ok], cols] = v
        slot = ty * p.tiles_x + tx
        stats[bi, slot, 0, cols] = v.sum(0)
        stats[bi, slot, 1, cols] = v.square().sum(0)
    return y, stats


# (B, H, W, Cin, Cout, act, skip, Cs, num_sms, split): num_sms 1 plans
# as for a large map, 132 as for a small one (splits to fill the card)
@pytest.mark.parametrize('bsz,h,w,cin,cout,act,skip,cs,num_sms,split', [
    (2, 20, 36, 64, 64, 'silu', 'identity', 0, 1, 1),   # ragged, MB=2
    (2, 17, 17, 64, 3, 'none', 'none', 0, 132, 1),      # the tail: Cout=3
    (1, 9, 40, 64, 128, 'silu', 'proj', 96, 1, 1),      # projection
    (1, 9, 40, 128, 128, 'silu', 'none', 0, 1, 1),      # two chunks
    (1, 16, 16, 512, 512, 'silu', 'proj', 256, 132, 8),  # 16^2 512
    (2, 12, 20, 96, 64, 'silu', 'identity', 0, 132, 2),  # split, Cin tail
    (1, 8, 24, 256, 128, 'silu', 'proj', 128, 1, 2),    # wide: split
])
def test_k1_tile_walk_emulation_matches_plain(bsz, h, w, cin, cout, act,
                                              skip, cs, num_sms, split):
    g = torch.Generator().manual_seed(h * w + cin + cs)
    x = torch.randn(bsz, h, w, cin, generator=g)
    a = torch.rand(bsz, cin, generator=g) + 0.5
    b = torch.randn(bsz, cin, generator=g) * 0.3 + 0.5   # act(b) != 0
    wt = torch.randn(cout, cin, 3, 3, generator=g) * (9 * cin) ** -0.5
    bias = torch.randn(cout, generator=g) * 0.1
    sk = w1 = None
    if skip != 'none':
        sk = torch.randn(bsz, h, w, cs or cout, generator=g)
    if skip == 'proj':
        w1 = torch.randn(cout, cs, 1, 1, generator=g) * cs ** -0.5
    p = cv.conv_plan(bsz, h, w, cin, cout, 1, num_sms, fused=True, cs=cs)
    assert p.split == split
    ops = cv.dots_operands(wt, bias, w1, torch.float32)
    got, st = _emulate_k1(x, a, b, act, ops, p, sk)
    ref, _ = cv.conv3x3_dots_ref(x, a, b, act, wt, bias, sk, w1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    # every slot written once; slot sums fold to the plain statistics
    assert not st.isnan().any()
    np.testing.assert_allclose(st.sum(1).numpy(),
                               cv.channel_stats(ref)[:, 0].numpy(),
                               rtol=1e-4, atol=1e-3)
    v = F.pad(ref, (0, 0, 0, p.tiles_x * 16 - w, 0, p.tiles_y * p.th - h))
    v = v.reshape(bsz, p.tiles_y, p.th, p.tiles_x, 16, cout)
    np.testing.assert_allclose(st[:, :, 0].numpy(),
                               v.sum((2, 4)).reshape(bsz, -1, cout).numpy(),
                               **TOL)


@pytest.mark.parametrize('cout,cs', [(64, 128), (128, 96), (3, 64)])
def test_w1_operand_round_trips(cout, cs):
    """w1_operand's layout, (ceil(Cs/64), CoutP, 64) with swizzled rows
    and zero padding, holds the 1x1 weight."""
    g = torch.Generator().manual_seed(cout + cs)
    w1 = torch.randn(cout, cs, 1, 1, generator=g)
    coutp = -(-cout // 8) * 8
    k = cv.w1_operand(w1, coutp, torch.float32)
    chunks = -(-cs // 64)
    assert k.shape == (chunks, coutp, 64) and k.is_contiguous()
    plain = cv.swizzle_rows(k).permute(1, 0, 2).reshape(coutp, -1)
    assert torch.equal(plain[:cout, :cs], w1[:, :, 0, 0])
    assert not plain[cout:].any() and not plain[:, cs:].any()
    ops = cv.dots_operands(torch.randn(cout, 32, 3, 3), torch.randn(cout),
                           w1)
    assert ops.cs == cs and ops.w1.dtype == torch.bfloat16
    with pytest.raises(ValueError, match='projection'):
        cv.dots_operands(torch.randn(cout, 32, 3, 3), torch.randn(cout),
                         torch.randn(cout + 8, cs))


@pytest.mark.parametrize('cout,cin', [(64, 64), (3, 96), (96, 32),
                                      (128, 256)])
def test_kernel_weight_round_trips(cout, cin):
    """conv_operands' layout, (chunks, 9, CoutP, 64) with swizzled rows
    and zero padding, inverts to the OIHW weight."""
    g = torch.Generator().manual_seed(cout + cin)
    wt = torch.randn(cout, cin, 3, 3, generator=g)
    bias = torch.randn(cout, generator=g)
    ops = cv.conv_operands(wt, bias, torch.float32)
    chunks, coutp = -(-cin // 64), -(-cout // 8) * 8
    assert ops.weight.shape == (chunks, 9, coutp, 64)
    assert ops.weight.is_contiguous() and ops.bias.shape == (coutp,)
    assert torch.equal(cv.operands_weight(ops), wt)
    assert torch.equal(ops.bias[:cout], bias)
    assert not ops.bias[cout:].any()
    plain = cv.swizzle_rows(ops.weight)
    assert torch.equal(cv.swizzle_rows(plain), ops.weight)   # involution
    assert not plain[:, :, cout:].any()
    assert not plain[-1, :, :, cin - 64 * (chunks - 1):].any()
    # tap 3*dy + dx, output row n, input channel k
    assert plain[0, 5, 1, 2] == wt[1, 2, 1, 2]
    assert torch.equal(cv.conv_operands(wt, bias).weight,
                       ops.weight.to(torch.bfloat16))


def test_downsample_keeps_kernel_operands():
    """Kept while the parameters are untouched; made again after an
    in-place update, a new tensor, a cast; never in training mode."""
    torch.manual_seed(0)
    m = pb.Downsample(64).eval()

    def fresh():
        return cv.conv_operands(m.conv.weight, m.conv.bias)

    ops = m.kernel_operands()
    assert m.kernel_operands() is ops
    assert torch.equal(ops.weight, fresh().weight)
    with torch.no_grad():
        m.conv.weight.mul_(2.0)
    ops2 = m.kernel_operands()
    assert ops2 is not ops and torch.equal(ops2.weight, fresh().weight)
    with torch.no_grad():
        m.conv.bias.add_(1.0)
    ops3 = m.kernel_operands()
    assert ops3 is not ops2 and torch.equal(ops3.bias, fresh().bias)
    m.load_state_dict({k: v * 0.5 for k, v in m.state_dict().items()})
    ops4 = m.kernel_operands()
    assert ops4 is not ops3 and torch.equal(ops4.weight, fresh().weight)
    m.to(torch.float64)
    ops5 = m.kernel_operands()
    assert ops5 is not ops4 and torch.equal(ops5.weight, fresh().weight)
    assert m.kernel_operands() is ops5
    m.train()
    assert m.kernel_operands() is None and m._operands is None
    m.eval()
    assert m.kernel_operands() is not None


def test_downsample_forward_unchanged_by_the_cache():
    """On the CPU the module keeps nothing and runs the plain version."""
    torch.manual_seed(1)
    m = pb.Downsample(64).eval()
    x = torch.randn(2, 64, 16, 16).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y = m(x)
        want = m.conv(F.pad(x, (0, 1, 0, 1)))
    assert m._operands is None
    torch.testing.assert_close(y, want, **TOL)


def _via_operands(x, a, b, act, weight, bias, skip=None, w1x1=None,
                  prepared=None):
    """A stand-in for cv.conv3x3_dots that computes from the kept
    kernel-layout operands where it is handed them (their weights read
    back out of the layout), else from the module's own parameters."""
    if prepared is not None:
        weight = cv.operands_weight(prepared.conv)
        bias = prepared.conv.bias[:prepared.conv.cout]
        if prepared.w1 is not None:
            plain = cv.swizzle_rows(prepared.w1).permute(1, 0, 2)
            w1x1 = plain.reshape(plain.shape[0], -1)[:prepared.conv.cout,
                                                     :prepared.cs]
    return cv.conv3x3_dots_ref(x, a, b, act, weight, bias, skip, w1x1)


def _check_cache(m, params, monkeypatch):
    """kernel_operands() is kept in eval mode, made again after an
    in-place update of each parameter, None in training mode; a forward
    with the kept operands equals one without, bit for bit."""
    m.eval()
    ops = m.kernel_operands()
    assert ops is not None and m.kernel_operands() is ops
    for t in params:
        with torch.no_grad():
            t.mul_(1.5)
        new = m.kernel_operands()
        assert new is not ops and m.kernel_operands() is new
        ops = new
    m.train()
    assert m.kernel_operands() is None and m._operands is None
    m.eval()
    assert m.kernel_operands() is not None

    # the forward: the modules hand the op their kept operands as on the
    # card (on_card), in eval mode; in training mode they keep nothing
    monkeypatch.setattr(pb, 'on_card', lambda x: True)
    monkeypatch.setattr(cv, 'conv3x3_dots', _via_operands)
    return m


def test_resblock_keeps_kernel_operands(monkeypatch):
    torch.manual_seed(2)
    for cin, cout in ((64, 64), (64, 32)):
        m = pb.ResBlock(cin, cout)      # fp32 parameters, bf16 maps
        params = [m.conv1.weight, m.conv1.bias, m.conv2.weight,
                  m.conv2.bias]
        if cin != cout:
            params += [m.conv_out.weight, m.conv_out.bias]
        _check_cache(m, params, monkeypatch)
        ops1, ops2, bias2 = m.kernel_operands()
        assert (ops2.w1 is not None) == (cin != cout)
        torch.testing.assert_close(bias2, m._conv2_bias(), rtol=0, atol=0)
        fresh = cv.dots_operands(m.conv2.weight, m._conv2_bias(),
                                 m.conv_out.weight if cin != cout else None)
        assert torch.equal(ops2.conv.weight, fresh.conv.weight)
        assert torch.equal(ops2.conv.bias, fresh.conv.bias)
        x = torch.randn(2, cin, 8, 16).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        with torch.no_grad():
            kept = m(x)
            assert m._operands is not None
            m.train()
            plain = m(x)
            assert m._operands is None
        assert torch.equal(kept, plain)
        monkeypatch.undo()


def test_generator_tail_keeps_kernel_operands(monkeypatch):
    from codeformer_tpu_torch.models.vqgan import Generator
    torch.manual_seed(3)
    gen = Generator(nf=32, emb_dim=16, ch_mult=(1, 2), num_res_blocks=1,
                    resolution=16, attn_resolutions=())
    tail = gen.blocks[-1]
    _check_cache(gen, [tail.weight, tail.bias], monkeypatch)
    assert torch.equal(gen.kernel_operands().conv.weight,
                       cv.dots_operands(tail.weight, tail.bias).conv.weight)
    z = torch.randn(1, 16, 8, 8).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        kept = gen(z)
        assert gen._operands is not None
        assert all(r._operands is not None for r in gen.modules()
                   if isinstance(r, pb.ResBlock))
        gen.train()
        plain = gen(z)
        assert gen._operands is None
    assert kept.shape == (1, 3, 16, 16)
    assert torch.equal(kept, plain)

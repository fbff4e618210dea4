"""The geometry around the Hopper conv core (csrc/conv_sm90.cuh), which
runs only on the card: the plan that ops/conv3x3.py `conv_plan` chooses,
a tile-walk emulation of the kernel's addressing built from that plan,
the kernel-layout weight, and the Downsample module's operand cache.

The emulation reads each tile's input window at the TMA box's
coordinates with zero fill outside the tensor, stores it in the 128-byte
swizzled layout, reads each tap's A rows at the ldmatrix addresses and
the weights at the wgmma descriptor's addresses, and sums a split's
partials in the second pass's order. It runs in fp32 against the plain
versions: both differ only in summation order, so rtol/atol 1e-4.
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
# (K1's too, which moves onto the core next) and maps ragged against the
# tile, with Cin % 64 == 32 and Cout = 3
PLAN_CASES = sorted(
    {(1, chip_smoke.BATCH, h, h, cin, cout)
     for h, cin, cout, *_ in chip_smoke.K1_CASES}
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

"""The port's K1/K2 (codeformer_tpu_torch/ops/conv3x3.py) against the
JAX Pallas kernels colpack_conv.conv3x3_dots / downsample_dots, run
through the Pallas interpreter on the CPU.

On the CPU the wrappers take their plain PyTorch versions (the CUDA
kernels run only on the card; chip_smoke.py holds them against the same
plain versions there). Tolerances: both sides compute in fp32 from the
same numpy inputs and differ only in summation order, so 1e-4 abs/rel;
stats sums of 2*32*32 values get 1e-3 abs.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from codeformer_tpu.ops import colpack_conv as cc  # noqa: E402
from codeformer_tpu_torch.ops import conv3x3 as cv  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _case(rng, b, h, w, cin, cout, cs):
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(cin)).astype(np.float32)
    # beta well away from 0: silu(b) != 0, so a halo that is not zeroed
    # AFTER the activation shows up at the image border
    beta = (0.5 + 0.1 * rng.standard_normal(cin)).astype(np.float32)
    skip = rng.standard_normal((b, h, w, cs or cout)).astype(np.float32)
    k1 = (rng.standard_normal((cs, cout)) * 0.1).astype(np.float32) \
        if cs else None
    return x, k, bias, gamma, beta, skip, k1


@pytest.mark.parametrize('act,skip_mode,cin,cout,cs', [
    ('silu', 'identity', 64, 64, 0),
    ('silu', 'proj', 64, 64, 128),
    ('silu', 'none', 128, 64, 0),
    ('none', 'none', 64, 3, 0),
])
def test_conv3x3_dots_matches_pallas(act, skip_mode, cin, cout, cs):
    rng = np.random.default_rng(11)
    b, h, w = 2, 2 * cc.TY, 32
    x, k, bias, gamma, beta, skip, k1 = _case(rng, b, h, w, cin, cout, cs)

    # JAX: gn_affine + silu_affine/apply_affine + the Pallas kernel
    xc = cc.to_colpack(jnp.asarray(x))
    a2, b2 = cc.gn_affine(cc.colpack_stats(xc), jnp.asarray(gamma),
                          jnp.asarray(beta), h * w)
    pro = cc.silu_affine if act == 'silu' else cc.apply_affine
    hf = pro(xc, a2, b2)
    wc, wo = cc.pack_weights(jnp.asarray(k))
    kw = {}
    if skip_mode != 'none':
        kw['skip'] = cc.to_colpack(jnp.asarray(skip))
    if skip_mode == 'proj':
        kw['w1x1'] = cc.pack_1x1(jnp.asarray(k1))
    yj, stj = cc.conv3x3_dots(hf, wc, wo, jnp.tile(jnp.asarray(bias), 2),
                              interpret=True, **kw)
    yj = np.asarray(cc.from_colpack(yj, cout))

    # port: same inputs, torch layouts (OIHW weights, (Cout, Cs) 1x1)
    xt = _t(x)
    a, bb = cv.gn_affine(cv.channel_stats(xt), _t(gamma), _t(beta), h * w)
    np.testing.assert_allclose(a.numpy(), np.asarray(a2)[:, :cin], **TOL)
    np.testing.assert_allclose(bb.numpy(), np.asarray(b2)[:, :cin], **TOL)
    weight = _t(k).permute(3, 2, 0, 1)
    sk = _t(skip) if skip_mode != 'none' else None
    w1 = _t(k1).t() if skip_mode == 'proj' else None
    cv.reset_launch_counts()
    y, st = cv.conv3x3_dots(xt, a, bb, act, weight, _t(bias), sk, w1)
    assert cv.launch_counts() == {'conv3x3_dots': 0, 'downsample_dots': 0,
                                  'conv3x3_bias': 0}
    assert y.shape == (b, h, w, cout) and st.shape == (b, 1, 2, cout)
    np.testing.assert_allclose(y.numpy(), yj, **TOL)

    # stats partials: the true sums of y, and the Pallas partials folded
    true = torch.stack([y.sum((1, 2)), y.square().sum((1, 2))], 1)
    np.testing.assert_allclose(st.sum(1).numpy(), true.numpy(),
                               rtol=1e-4, atol=1e-3)
    folded = np.asarray(stj).sum(1).reshape(b, 2, 2, cout).sum(2)
    np.testing.assert_allclose(st.sum(1).numpy(), folded,
                               rtol=1e-4, atol=1e-3)


def test_halo_is_zero_after_activation():
    """Trap: SAME pads silu(a*x+b) with zeros. A single centre tap of a
    constant map must see silu(b) inside and exactly 0 outside."""
    b, h, w, c = 1, 4, 4, 32
    x = torch.zeros(b, h, w, c)
    a = torch.ones(b, c)
    bb = torch.full((b, c), 2.0)
    weight = torch.zeros(32, c, 3, 3)
    weight[0, 0, 0, 0] = 1.0                       # tap (dy, dx) = (0, 0)
    y, _ = cv.conv3x3_dots(x, a, bb, 'silu', weight, torch.zeros(32))
    s = F.silu(torch.tensor(2.0))
    assert float(y[0, 0, 0, 0]) == 0.0             # top-left reads the halo
    assert float(y[0, 1, 1, 0]) == pytest.approx(float(s))


@pytest.mark.parametrize('h,w,c', [(4 * 2 * cc.TY, 64, 64), (32, 32, 128)])
def test_downsample_dots_matches_pallas(h, w, c):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    yj = cc.from_colpack(cc.downsample_dots(
        cc.to_colpack(jnp.asarray(x)), jnp.asarray(k), jnp.asarray(bias),
        interpret=True), c)
    cv.reset_launch_counts()
    y = cv.downsample_dots(_t(x), _t(k).permute(3, 2, 0, 1), _t(bias))
    assert cv.launch_counts()['downsample_dots'] == 0
    assert y.shape == (2, h // 2, w // 2, c)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)


def test_downsample_pads_bottom_right_only():
    """Trap: the pad is (0,1,0,1), not PyTorch's symmetric padding=1."""
    x = torch.randn(1, 8, 8, 32)
    wt = torch.randn(32, 32, 3, 3)
    y = cv.downsample_dots(x, wt, torch.zeros(32)).permute(0, 3, 1, 2)
    want = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1)), wt,
                    stride=2)
    sym = F.conv2d(x.permute(0, 3, 1, 2), wt, stride=2, padding=1)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert not torch.allclose(y, sym, atol=1e-3)


def _emulate_k1(x, a, b, act, wk, bk, cout, w1=None, skip=None):
    """The CUDA kernel's GEMM on its prepared operands, in torch: tap
    t = 3*dy + dx reads input pixel (y + dy - 1, x + dx - 1)."""
    hf = x * a[:, None, None] + b[:, None, None]
    hf = F.silu(hf) if act == 'silu' else hf
    hp = F.pad(hf, (0, 0, 1, 1, 1, 1))
    bsz, h, w, _ = x.shape
    acc = torch.zeros(bsz, h, w, wk.shape[-1])
    for t in range(9):
        dy, dx = divmod(t, 3)
        acc += hp[:, dy:dy + h, dx:dx + w] @ wk[t].float()
    if w1 is not None:
        acc += skip @ w1.float()
    elif skip is not None:
        acc[..., :cout] += skip
    return (acc + bk)[..., :cout]


@pytest.mark.parametrize('cout,proj', [(64, False), (3, False), (64, True)])
def test_kernel_operands_emulate_conv(cout, proj):
    """The layouts conv3x3_dots hands the CUDA kernel (padded
    [tap][in][out] weights, (Cs, CoutP) 1x1, padded fp32 bias) compute
    the plain version's function."""
    g = torch.Generator().manual_seed(3)
    b, h, w, cin, cs = 2, 8, 16, 32, 64
    x = torch.randn(b, h, w, cin, generator=g)
    a = torch.rand(b, cin, generator=g) + 0.5
    bb = torch.randn(b, cin, generator=g)
    weight = torch.randn(cout, cin, 3, 3, generator=g) * 0.1
    bias = torch.randn(cout, generator=g)
    skip = torch.randn(b, h, w, cs if proj else cout, generator=g)
    w1 = torch.randn(cout, cs, 1, 1, generator=g) * 0.1 if proj else None
    cout_p = -(-cout // (16 * cv.n_frags(cout))) * 16 * cv.n_frags(cout)
    wk = cv.kernel_weight(weight, cout_p, torch.float32)
    assert wk.shape == (9, cin, cout_p)
    w1k = cv.kernel_w1x1(w1, cout_p, torch.float32) if proj else None
    got = _emulate_k1(x, a, bb, 'silu', wk, cv.kernel_bias(bias, cout_p),
                      cout, w1k, skip)
    want, _ = cv.conv3x3_dots_ref(x, a, bb, 'silu', weight, bias, skip, w1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_downsample_operands_emulate_conv():
    """K2 reads input pixel (2*oy + dy, 2*ox + dx), zero past the last row
    and column."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 16, 32, 64, generator=g)
    weight = torch.randn(64, 64, 3, 3, generator=g) * 0.1
    bias = torch.randn(64, generator=g)
    wk = cv.kernel_weight(weight, 64, torch.float32)
    xp = F.pad(x, (0, 0, 0, 1, 0, 1))
    acc = cv.kernel_bias(bias, 64).expand(2, 8, 16, 64).clone()
    for t in range(9):
        dy, dx = divmod(t, 3)
        acc += xp[:, dy:dy + 16:2, dx:dx + 32:2] @ wk[t]
    want = cv.downsample_dots_ref(x, weight, bias)
    np.testing.assert_allclose(acc.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_stats_tiles_and_frags():
    assert cv.stats_tiles(512, 512) == 64 * 32
    assert cv.stats_tiles(16, 16) == 2
    assert cv.n_frags(3) == 1 and cv.n_frags(64) == 4


def test_bad_act_raises():
    x = torch.zeros(1, 4, 4, 32)
    with pytest.raises(ValueError, match='act'):
        cv.conv3x3_dots(x, torch.ones(1, 32), torch.zeros(1, 32), 'relu',
                        torch.zeros(32, 32, 3, 3), torch.zeros(32))

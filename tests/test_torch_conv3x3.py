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
                                  'conv3x3_bias': 0, 'conv3x3_dense': 0}
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


def test_downsample_operands_emulate_conv():
    """K2 reads input pixel (2*oy + dy, 2*ox + dx), zero past the last row
    and column, against tap t = 3*dy + dx of conv_operands' layout, the
    one csrc/downsample_dots.cu reads: its rows unswizzled, the input
    channels of each 64-channel chunk, zero past Cin (here 96: a tail)."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 16, 32, 96, generator=g)
    weight = torch.randn(96, 96, 3, 3, generator=g) * 0.1
    bias = torch.randn(96, generator=g)
    ops = cv.conv_operands(weight, bias, torch.float32)
    assert torch.equal(cv.operands_weight(ops), weight)
    taps = cv.swizzle_rows(ops.weight)      # (chunks, 9, CoutP, 64)
    assert taps.shape == (2, 9, 96, 64) and not taps[1, :, :, 32:].any()
    xp = F.pad(x, (0, 32, 0, 1, 0, 1))      # the chunk tail, then the pad
    acc = ops.bias.expand(2, 8, 16, 96).clone()
    for t in range(9):
        dy, dx = divmod(t, 3)
        for c in range(2):
            acc += xp[:, dy:dy + 16:2, dx:dx + 32:2, 64 * c:64 * c + 64] \
                @ taps[c, t].t()
    want = cv.downsample_dots_ref(x, weight, bias)
    np.testing.assert_allclose(acc.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_bad_act_raises():
    x = torch.zeros(1, 4, 4, 32)
    with pytest.raises(ValueError, match='act'):
        cv.conv3x3_dots(x, torch.ones(1, 32), torch.zeros(1, 32), 'relu',
                        torch.zeros(32, 32, 3, 3), torch.zeros(32))


# near-constant bf16 maps: a level with randn * 0.01 added to the even
# channels, cast to bf16 (seed, level, H = W). With the variance taken as
# E[x^2] - mean^2 in fp32 and not clamped, rounding takes it below -eps
# in some groups of each map, and rsqrt made `a` NaN there
GN_NEAR_CONSTANT_BOUND = 0.5
NEAR_CONSTANT = [(43, 85.28, 128), (97, 89.21, 128), (104, 57.16, 128),
                 (106, 252.53, 64)]


def _near_constant(seed, level, hw):
    rng = np.random.default_rng(seed)
    x = np.full((1, hw, hw, 64), level, np.float32)
    x[..., ::2] += rng.standard_normal((1, hw, hw, 32)).astype(
        np.float32) * 0.01
    return torch.from_numpy(x).to(torch.bfloat16)


def _median_abs(a, b):
    return float((a - b).abs().flatten().median())


@pytest.mark.parametrize('seed,level,hw', NEAR_CONSTANT)
def test_gn_affine_clamps_the_variance_on_near_constant_maps(seed, level,
                                                             hw):
    """gn_affine's fold, a*x + b, and a ResBlock(64).eval() forward on the
    fold are finite on near-constant bf16 maps, and held against
    F.group_norm and flax's GroupNorm (JAX's default serving path, which
    clamps var at 0 too).

    Tolerance: one-pass fp32 statistics cannot resolve a variance below
    about ulp(mean^2) (1e-3 - 8e-3 at these levels), and the true one is
    1e-6 - 1e-4 here, so no fold from [sum, sumsq] matches F.group_norm's
    centred statistics element by element, and which groups clamp at 0
    depends on the summation order. flax computes the same one-pass
    statistics and its fold and its ResBlock sit up to 0.36 and 0.47 from
    F.group_norm's (median |difference| over a map). So each of the
    port's fold and ResBlock forward is held, by the median |difference|
    over the map, within GN_NEAR_CONSTANT_BOUND = 0.5 of F.group_norm's
    and of flax's, and must be finite everywhere (it was NaN in some
    groups of each map before the clamp)."""
    import jax
    from flax import linen as fnn

    from codeformer_tpu_torch.nn.blocks import ResBlock
    x = _near_constant(seed, level, hw)
    rng = np.random.default_rng(seed + 1)
    gamma = _t(1 + 0.1 * rng.standard_normal(64))
    beta = _t(0.1 * rng.standard_normal(64))
    a, b = cv.gn_affine(cv.channel_stats(x), gamma, beta, hw * hw)
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    got = x.float() * a[:, None, None] + b[:, None, None]
    ref = F.group_norm(x.float().permute(0, 3, 1, 2), 32, gamma, beta,
                       1e-6).permute(0, 2, 3, 1)
    flax_gn = fnn.GroupNorm(num_groups=32, epsilon=1e-6).apply(
        {'params': {'scale': jnp.asarray(gamma.numpy()),
                    'bias': jnp.asarray(beta.numpy())}},
        jnp.asarray(x.float().numpy()))
    flax_gn = torch.from_numpy(np.array(flax_gn))
    assert torch.isfinite(flax_gn).all()
    assert _median_abs(got, ref) <= GN_NEAR_CONSTANT_BOUND
    assert _median_abs(got, flax_gn) <= GN_NEAR_CONSTANT_BOUND

    # the block on the map's values in fp32 (one bf16 step is 0.5 at
    # these levels), against its textbook form (F.group_norm) and the JAX
    # ResBlock (flax GroupNorm) on the same weights
    from codeformer_tpu.nn.blocks import ResBlock as JaxResBlock
    from codeformer_tpu_torch.utils.convert import flax_to_state_dict
    xn = jnp.asarray(x.float().numpy())
    variables = JaxResBlock(64).init(jax.random.PRNGKey(seed), xn)
    y_jax = torch.from_numpy(np.array(JaxResBlock(64).apply(variables, xn)))
    blk = ResBlock(64).eval()
    blk.load_state_dict(flax_to_state_dict(variables))
    xf = x.float().permute(0, 3, 1, 2)
    with torch.no_grad():
        y = blk(xf).permute(0, 2, 3, 1)
        blk.use_kernels = False
        y_ref = blk(xf).permute(0, 2, 3, 1)
    assert torch.isfinite(y).all() and torch.isfinite(y_jax).all()
    assert _median_abs(y, y_ref) <= GN_NEAR_CONSTANT_BOUND
    assert _median_abs(y, y_jax) <= GN_NEAR_CONSTANT_BOUND

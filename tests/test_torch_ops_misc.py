"""The port's plain ops and architecture utilities against their JAX
twins, fp32, same numpy inputs, 1e-4: upfirdn2d and its up/down
wrappers, modulated (and plain) deformable conv, flow_warp, resize_flow,
and DCNv2Pack with flax weights carried through flax_to_state_dict.

The JAX modulated_deform_conv2d reads a grouped weight by reshaping its
(taps, Cin/groups, Cout) matrix to (taps, groups, Cin/groups,
Cout/groups), which is not the grouped layout of the reference's
(Cout, Cin/groups, kh, kw) weight. The port keeps the reference's
semantics; for groups > 1 the test hands JAX the weight arranged so that
its reshape yields the reference's grouping, and compares the outputs.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from codeformer_tpu.nn import arch_util as jau  # noqa: E402
from codeformer_tpu.ops import deform_conv as jdc  # noqa: E402
from codeformer_tpu.utils.convert import torch_state_dict_to_flax  # noqa: E402
from codeformer_tpu_torch.nn import arch_util as pau  # noqa: E402
from codeformer_tpu_torch.ops import deform_conv as pdc  # noqa: E402
from codeformer_tpu_torch.utils.convert import flax_to_state_dict  # noqa: E402

# the modules: each package's `upfirdn2d` attribute is the function
jup = importlib.import_module('codeformer_tpu.ops.upfirdn2d')
pup = importlib.import_module('codeformer_tpu_torch.ops.upfirdn2d')
torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize('op,up,down,pad', [
    ('upfirdn2d', 1, 1, (1, 1, 1, 1)),
    ('upfirdn2d', 2, 1, (2, 1, 2, 1)),
    ('upfirdn2d', 1, 2, (1, 1, 1, 1)),
    ('upfirdn2d', 2, 1, (1, 2)),
    ('upsample2d', 2, 1, None),
    ('downsample2d', 1, 2, None),
])
def test_upfirdn2d_matches_jax(op, up, down, pad):
    """The (up, down, pad) cases of tests/test_native_ops.py, a two-value
    pad, and the StyleGAN2 wrappers on a [1, 3, 3, 1] kernel."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 10, 3)).astype(np.float32)
    if op == 'upfirdn2d':
        k = rng.normal(size=(4, 4)).astype(np.float32)
        want = jup.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up, down, pad)
        got = pup.upfirdn2d(_t(x), _t(k), up, down, pad)
    else:
        kj = jup.make_resample_kernel([1, 3, 3, 1])
        kp = pup.make_resample_kernel([1, 3, 3, 1])
        np.testing.assert_allclose(kp.numpy(), np.asarray(kj), rtol=1e-7)
        want = getattr(jup, op)(jnp.asarray(x), kj)
        got = getattr(pup, op)(_t(x), kp)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_weight(w_oihw: np.ndarray, groups: int) -> np.ndarray:
    """(Cout, Cin_g, kh, kw) -> the (kh, kw, Cin_g, Cout) array whose
    reshape inside the JAX function gives each group its own block."""
    cout, cin_g, kh, kw = w_oihw.shape
    std = w_oihw.reshape(groups, cout // groups, cin_g, kh * kw) \
        .transpose(3, 0, 2, 1)                     # (taps, g, cin_g, cout_g)
    return std.reshape(kh, kw, cin_g, cout)


@pytest.mark.parametrize('groups,stride,dilation', [(1, 1, 1), (2, 1, 1),
                                                    (4, 2, 1), (1, 1, 2)])
def test_modulated_deform_conv_matches_jax(groups, stride, dilation):
    rng = np.random.default_rng(groups + 10 * stride + 100 * dilation)
    b, h, w, cin, cout, k = 2, 9, 8, 8, 12, 3
    pad = dilation
    ho = (h + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    offset = rng.uniform(-2.5, 2.5, (b, ho, wo, 2 * k * k)).astype(
        np.float32)
    mask = rng.uniform(0, 1, (b, ho, wo, k * k)).astype(np.float32)
    weight = rng.normal(size=(cout, cin // groups, k, k)).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32)
    want = jdc.modulated_deform_conv2d(
        jnp.asarray(x), jnp.asarray(offset), jnp.asarray(mask),
        jnp.asarray(_jax_weight(weight, groups)), jnp.asarray(bias), stride,
        pad, dilation, groups)
    got = pdc.modulated_deform_conv2d(_t(x), _t(offset), _t(mask),
                                      _t(weight), _t(bias), stride, pad,
                                      dilation, groups)
    assert got.shape == want.shape == (b, ho, wo, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if groups == 1:     # DCNv1: a mask of ones
        want1 = jdc.deform_conv2d(jnp.asarray(x), jnp.asarray(offset),
                                  jnp.asarray(_jax_weight(weight, 1)),
                                  None, stride, pad, dilation)
        got1 = pdc.deform_conv2d(_t(x), _t(offset), _t(weight), None,
                                 stride, pad, dilation)
        np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **TOL)


@pytest.mark.parametrize('padding_mode', ['zeros', 'border'])
def test_flow_warp_matches_jax(padding_mode):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 9, 3)).astype(np.float32)
    flow = rng.uniform(-3, 3, (2, 7, 9, 2)).astype(np.float32)
    want = jau.flow_warp(jnp.asarray(x), jnp.asarray(flow),
                         padding_mode=padding_mode)
    got = pau.flow_warp(_t(x), _t(flow), padding_mode=padding_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('size_type,sizes', [('ratio', (2, 2)),
                                             ('shape', (12, 10)),
                                             ('ratio', (0.5, 0.5))])
def test_resize_flow_matches_jax(size_type, sizes):
    flow = np.random.default_rng(2).normal(size=(1, 8, 8, 2)) \
        .astype(np.float32)
    want = jau.resize_flow(jnp.asarray(flow), size_type, sizes)
    got = pau.resize_flow(_t(flow), size_type, sizes)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pixel_unshuffle_matches_jax():
    from codeformer_tpu.models.rrdbnet import pixel_unshuffle
    x = np.random.default_rng(3).normal(size=(2, 8, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(pau.pixel_unshuffle(_t(x), 2).numpy(),
                                  np.asarray(pixel_unshuffle(jnp.asarray(x),
                                                             2)))


def test_dcnv2pack_matches_jax_through_flax_to_state_dict():
    """Random flax params (a non-zero offset conv, so the sampling is
    fractional) -> flax_to_state_dict -> the port's module, strictly;
    the JAX converter maps the weight back."""
    rng = np.random.default_rng(4)
    b, h, w, cin, cout = 2, 8, 8, 4, 5
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    feat = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    jm = jau.DCNv2Pack(out_channels=cout)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(feat))
    v = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32) * 0.5), v)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(feat))

    pm = pau.DCNv2Pack(cin, cout)
    sd = flax_to_state_dict(v)
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd)
    with torch.no_grad():
        got = pm(_t(x), _t(feat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the JAX converter's generic rule names the OIHW weight `kernel`
    back = torch_state_dict_to_flax(sd)['params']
    np.testing.assert_array_equal(back['kernel'],
                                  np.asarray(v['params']['weight']))
    np.testing.assert_array_equal(back['conv_offset']['kernel'],
                                  np.asarray(v['params']['conv_offset']
                                             ['kernel']))


def test_make_layer_and_init():
    layers = pau.make_layer(torch.nn.Conv2d, 3, in_channels=4,
                            out_channels=4, kernel_size=3)
    assert len(layers) == 3
    pau.default_init_weights(layers, scale=0.1, bias_fill=0.5)
    assert all(float(m.bias.detach().min()) == 0.5 for m in layers)
    t = pau.trunc_normal_(torch.empty(1000), std=0.02, a=-0.04, b=0.04)
    assert float(t.abs().max()) <= 0.04

"""The bare 3x3 conv (ops/conv3x3.py conv3x3_bias) against the three TPU
kernels that compute it in their packings: conv3x3_colpack (column
pairs, K1'), conv3x3_pallas (phase pairs, K5) and conv3x3_pair (image
pairs, K6), each through the Pallas interpreter on the CPU. The port's
wrapper takes its plain version here; the CUDA kernel (conv3x3_dots.cu
with no prologue) is held against the same plain version on the card by
chip_smoke.py.

fp32 on both sides: 1e-4 (fp32 sums in other orders). In bf16 the JAX
K5 adds its bias after the kernel in x.dtype, so it rounds twice; the
port adds the bias in the fp32 epilogue and rounds once.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from codeformer_tpu.ops import colpack_conv as cc  # noqa: E402
from codeformer_tpu.ops import imgpair_conv as ic  # noqa: E402
from codeformer_tpu.ops import pallas_conv as pc  # noqa: E402
from codeformer_tpu_torch.ops import conv3x3 as cv  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _colpack(x, k, bias):
    wc, wo = cc.pack_weights(k)
    return cc.from_colpack(cc.conv3x3_colpack(
        cc.to_colpack(x), wc, wo, jnp.concatenate([bias, bias]),
        interpret=True), k.shape[-1])


def _pair(x, k, bias):
    return ic.conv3x3_pair(x, k, bias, interpret=True)


# (JAX kernel, B, H, W, Cin, Cout): K1' as tests/test_colpack.py:33, K5 as
# tests/test_fast_conv.py:75-76, K6 with an even and an odd batch
CASES = {
    'colpack': (_colpack, 2, 2 * cc.TY, 32, 8, 8),
    'pallas-a': (pc.conv3x3_pallas, 2, pc.TY * 2, 16, 8, 8),
    'pallas-b': (pc.conv3x3_pallas, 1, pc.TY * 3, 10, 8, 16),
    'pair-even': (_pair, 2, 2 * ic.TY, ic.TX, 32, 32),
    'pair-odd': (_pair, 3, 2 * ic.TY, ic.TX, 32, 32),
}


def _case(b, h, w, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout))
         * (9 * cin) ** -0.5).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return x, k, bias


def _port_args(x, k, bias):
    return (torch.from_numpy(x), torch.from_numpy(k).permute(3, 2, 0, 1),
            torch.from_numpy(bias))


@pytest.mark.parametrize('name', sorted(CASES))
def test_conv3x3_bias_matches_the_tpu_kernel(name):
    fn, *shape = CASES[name]
    x, k, bias = _case(*shape)
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias)))
    xt, wt, bt = _port_args(x, k, bias)
    cv.reset_launch_counts()
    got = cv.conv3x3_bias(xt, wt, bt)
    assert cv.launch_counts()['conv3x3_bias'] == 0
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got.numpy(),
                                  cv.conv3x3_bias_ref(xt, wt, bt).numpy())
    # a halo row shifted by one (top pad 0, bottom 2) falls outside TOL
    shifted = torch.nn.functional.conv2d(
        torch.nn.functional.pad(xt.permute(0, 3, 1, 2), (1, 1, 0, 2)), wt,
        bt).permute(0, 2, 3, 1)
    assert not np.allclose(shifted.numpy(), want, **TOL)


def test_bf16_rounds_once():
    """bf16, the K5 shape: the port (fp32 sum + bias, one rounding) and
    JAX's conv3x3_pallas (conv rounded to bf16, then + bias in bf16) both
    sit within one bf16 ulp of the exact result, and the port is at least
    as close to it."""
    x, k, bias = _case(2, pc.TY * 2, 16, 8, 8, seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    kb = jnp.asarray(k).astype(jnp.bfloat16)
    want = np.asarray(pc.conv3x3_pallas(xb, kb, jnp.asarray(bias)
                                        .astype(jnp.bfloat16))
                      .astype(jnp.float32))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))) \
        .to(torch.bfloat16)
    wt = torch.from_numpy(np.array(kb.astype(jnp.float32))) \
        .permute(3, 2, 0, 1)
    bt = torch.from_numpy(np.array(jnp.asarray(bias).astype(jnp.bfloat16)
                                     .astype(jnp.float32)))
    got = cv.conv3x3_bias(xt, wt, bt)
    assert got.dtype == torch.bfloat16
    exact = cv.conv3x3_bias_ref(xt.double(), wt.double(), bt.double())
    exact = exact.numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(exact), 1e-30))) - 7)
    conv_only = np.abs(exact - bt.numpy()).max()
    err_port = np.abs(got.float().numpy() - exact)
    err_jax = np.abs(want - exact)
    assert (err_port <= ulp).all()
    # JAX's first rounding is at the conv's own magnitude
    assert (err_jax <= ulp + 2.0 ** -8 * conv_only).all()
    assert err_port.mean() <= err_jax.mean()


def test_conv3x3_bias_output_channels_3():
    """The decoder-tail width the kernel also takes (Cout = 3)."""
    x, k, bias = _case(1, 8, 16, 32, 3, seed=2)
    xt, wt, bt = _port_args(x, k, bias)
    dn = lax.conv_dimension_numbers(x.shape, k.shape,
                                    ('NHWC', 'HWIO', 'NHWC'))
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), 'SAME',
        dimension_numbers=dn) + bias)
    np.testing.assert_allclose(cv.conv3x3_bias(xt, wt, bt).numpy(), want,
                               **TOL)

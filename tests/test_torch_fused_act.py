"""fused_leaky_relu (K4) in the port against the JAX package's, on the CPU:
the port's wrapper takes its plain versions there (the CUDA kernels
csrc/fused_act.cu are held against the same plain versions on the card by
chip_smoke.py).

Tolerances: fp32 forward 1e-6 (the same arithmetic), gradients 1e-5
(other summation orders for dbias); bf16 within one bf16 ulp of the fp32
result on the same rounded operands (the port rounds once; the JAX plain
path adds an fp32 bias to a bf16 x and returns fp32, so JAX is fed the
bias rounded to bf16 and compared in fp32).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from codeformer_tpu.ops.fused_act import fused_leaky_relu as jax_flrelu  # noqa: E402
from codeformer_tpu_torch.ops import fused_act as fa  # noqa: E402
from codeformer_tpu_torch.ops import fused_leaky_relu  # noqa: E402

torch.set_num_threads(2)
SHAPES = [(4, 6, 6, 8), (5, 7, 3), (2, 3, 513), (7, 64)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=shape[-1:]).astype(np.float32)
    w = rng.normal(size=shape).astype(np.float32)
    return x, b, w


@pytest.mark.parametrize('shape', SHAPES)
def test_forward_and_grads_match_jax(shape):
    x, b, w = _inputs(shape, 1)
    want = np.asarray(jax_flrelu(jnp.asarray(x), jnp.asarray(b)))

    def loss(xx, bb):
        return jnp.sum(jax_flrelu(xx, bb) * jnp.asarray(w))
    gx_j, gb_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(b))

    xt = torch.from_numpy(x).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    fa.reset_launch_counts()
    out = fused_leaky_relu(xt, bt)
    (out * torch.from_numpy(w)).sum().backward()
    assert fa.launch_counts() == {'fused_lrelu_fwd': 0, 'fused_lrelu_bwd': 0}
    assert out.dtype == torch.float32 and out.shape == shape
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb_j), rtol=1e-5,
                               atol=1e-5)


def test_second_order_grads_match_jax():
    """d/dw of <dL/dx, v> + <dL/dbias, u> for L = <f(x, b), w>: the
    masked scale of v + u (JAX differentiates its jnp VJP; the port's
    backward Function applies the same masked scale)."""
    x, b, w = _inputs((3, 5, 6), 2)
    rng = np.random.default_rng(3)
    v = rng.normal(size=x.shape).astype(np.float32)
    u = rng.normal(size=b.shape).astype(np.float32)

    def outer(ww):
        gx, gb = jax.grad(lambda xx, bb: jnp.sum(jax_flrelu(xx, bb) * ww),
                          argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
        return jnp.sum(gx * v) + jnp.sum(gb * u)
    want = np.asarray(jax.grad(outer)(jnp.asarray(w)))

    xt = torch.from_numpy(x).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    gx, gb = torch.autograd.grad((fused_leaky_relu(xt, bt) * wt).sum(),
                                 (xt, bt), create_graph=True)
    (gw,) = torch.autograd.grad((gx * torch.from_numpy(v)).sum()
                                + (gb * torch.from_numpy(u)).sum(), wt)
    np.testing.assert_allclose(gw.numpy(), want, rtol=1e-5, atol=1e-5)


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize('shape', SHAPES)
def test_bf16_within_one_ulp(shape):
    x, b, w = _inputs(shape, 4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    bb = torch.from_numpy(b).to(torch.bfloat16)
    out = fused_leaky_relu(xb, torch.from_numpy(b))
    assert out.dtype == torch.bfloat16
    want = np.asarray(jax_flrelu(jnp.asarray(xb.float().numpy()),
                                 jnp.asarray(bb.float().numpy())))
    got = out.float().numpy()
    assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    # the backward in bf16: dx rounded once, dbias the fp32 sum of dx
    g = torch.from_numpy(w).to(torch.bfloat16)
    dx, db = fa.fused_leaky_relu_bwd_ref(g, out)
    assert dx.dtype == torch.bfloat16 and db.dtype == torch.float32
    gj = jax.grad(lambda xx: jnp.sum(jax_flrelu(
        xx, jnp.asarray(bb.float().numpy())) * jnp.asarray(
            g.float().numpy())))(jnp.asarray(xb.float().numpy()))
    assert (np.abs(dx.float().numpy() - np.asarray(gj))
            <= _bf16_ulp(np.asarray(gj))).all()
    np.testing.assert_allclose(db.numpy(), dx.float().reshape(
        -1, shape[-1]).sum(0).numpy(), rtol=1e-6)


def test_gradcheck_and_gradgradcheck_fp64():
    """The plain path through the autograd Functions, in fp64."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 3, 5))).requires_grad_()
    b = torch.from_numpy(rng.normal(size=(5,))).requires_grad_()
    assert torch.autograd.gradcheck(fused_leaky_relu, (x, b))
    assert torch.autograd.gradgradcheck(fused_leaky_relu, (x, b))


def test_the_mask_is_that_of_x_plus_bias():
    """Trap: the branch follows y = x + bias, not x: a negative x with a
    larger positive bias takes the identity branch."""
    x = torch.full((2, 3), -1.0)
    b = torch.tensor([2.0, 0.5, 1.0])
    out = fused_leaky_relu(x, b, 0.2, 1.0)
    np.testing.assert_allclose(out[0].numpy(), [1.0, -0.1, 0.0], atol=1e-7)

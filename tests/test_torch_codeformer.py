"""The slice as a whole: the port's CodeFormer against the JAX CodeFormer
on the tiny topology of tests/test_int8.py, fp32, same weights (through
flax_to_state_dict) and same numpy input.

The JAX model runs with colpack off (plain XLA GroupNorm, two-pass
statistics); the port folds GroupNorm from fp32 sums (E[x^2] - mean^2)
and runs its ResBlock convs through the plain versions of K1/K2. The
two differ by fp32 rounding only (measured: about 1e-5 absolute on
values up to 7), so logits, lq_feat and the image are held to 1e-4
abs + 1e-4 rel, and the code indices must be EQUAL: the smallest top-2
logit gap at this seed is 3e-4, far above the noise, so a flipped index
would mean a bug.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from codeformer_tpu.models import CodeFormer as JaxCodeFormer  # noqa: E402
from codeformer_tpu.nn.blocks import colpack_mode, set_colpack_mode  # noqa: E402
from codeformer_tpu.utils.checkpoint import init_params_fast  # noqa: E402
from codeformer_tpu_torch.models import CodeFormer  # noqa: E402
from codeformer_tpu_torch.utils.convert import flax_to_state_dict  # noqa: E402

torch.set_num_threads(2)
TINY = dict(img_size=64, nf=32, ch_mult=(1, 2, 4), codebook_size=64,
            emb_dim=16, dim_embd=64, n_head=4, n_layers=2, latent_size=256,
            connect_list=('32',))
FEAT_TOL = dict(rtol=1e-4, atol=1e-4)
IMG_TOL = dict(rtol=1e-4, atol=1e-4)


def perturbed_params(model, seed):
    """init_params_fast, then non-trivial norm affines, biases and
    position embedding so every parameter kind matters."""
    v = init_params_fast(model, jnp.zeros((1, 64, 64, 3)), 0.5, seed=seed)
    rng = np.random.default_rng(seed + 100)

    def bump(path, leaf):
        name = str(getattr(path[-1], 'key', ''))
        if name in ('scale', 'bias', 'in_proj_bias', 'position_emb'):
            return leaf + 0.1 * rng.standard_normal(leaf.shape).astype(
                leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(bump, v)


@pytest.fixture(scope='module')
def models():
    # the plain XLA GroupNorm path; another test file of the same process
    # may have left the global mode elsewhere
    prev = colpack_mode()
    set_colpack_mode('off')
    jm = JaxCodeFormer(**TINY)
    v = perturbed_params(jm, seed=5)
    pm = CodeFormer(**TINY)
    pm.load_state_dict(flax_to_state_dict(v))
    x = np.random.default_rng(6).normal(0, 0.3, (2, 64, 64, 3)).astype(
        np.float32)
    yield jm, v, pm.eval(), x
    set_colpack_mode(prev)


def _port(pm, x, *args, **kw):
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        return pm(xt, *args, **kw)


@pytest.mark.parametrize('w,adain,enable_fuse', [
    (0.5, True, True), (0.5, False, True), (1.0, True, True),
    (0.0, True, False)])
def test_codeformer_matches_jax(models, w, adain, enable_fuse):
    jm, v, pm, x = models
    fwd = jax.jit(lambda v, x, w: jm.apply(v, x, w, adain=adain,
                                           enable_fuse=enable_fuse))
    out_j, logits_j, lq_j = map(np.asarray,
                                fwd(v, jnp.asarray(x), jnp.float32(w)))
    out, logits, lq = _port(pm, x, w, adain=adain, enable_fuse=enable_fuse)
    np.testing.assert_allclose(logits.numpy(), logits_j, **FEAT_TOL)
    np.testing.assert_allclose(lq.permute(0, 2, 3, 1).numpy(), lq_j,
                               **FEAT_TOL)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  logits_j.argmax(-1))
    assert out.shape == (2, 3, 64, 64)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), out_j,
                               **IMG_TOL)


def test_code_only_matches_jax(models):
    jm, v, pm, x = models
    logits_j, lq_j = jm.apply(v, jnp.asarray(x), 0.5, code_only=True)
    logits, lq = _port(pm, x, 0.5, code_only=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               **FEAT_TOL)
    np.testing.assert_allclose(lq.permute(0, 2, 3, 1).numpy(),
                               np.asarray(lq_j), **FEAT_TOL)


def test_w_zero_with_fuse_equals_no_fuse(models):
    """w enters as a tensor: at w=0 the fused residual is exactly 0."""
    _, _, pm, x = models
    a, _, _ = _port(pm, x, 0.0, enable_fuse=True)
    b, _, _ = _port(pm, x, 0.0, enable_fuse=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_bf16_forward_is_finite(models):
    """The serving dtype runs end to end (parameters stay fp32)."""
    _, _, pm, x = models
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    with torch.no_grad():
        out, logits, lq = pm(xt, 0.5, adain=True)
    assert out.dtype == logits.dtype == lq.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    assert next(pm.parameters()).dtype == torch.float32


# Parameter gradients of loss = sum(out * r) against jax.grad of the same
# loss on the same weights, fp32: both sides sum the same products in other
# orders, so each tensor is held within GRAD_TOL of its largest JAX
# gradient, plus GRAD_FLOOR of the model's largest. The floor is for the
# tensors whose true gradient cancels to about zero (a conv bias feeding a
# GroupNorm, an attention key bias): both sides return rounding noise
# there, up to 8e-5 against a largest gradient of 321 (2.5e-7 of it). A
# tensor JAX gives no gradient (exactly zero) must get none in the port.
GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-6


def _jax_grads(jm, v, x, r, w, detach_16, adain):
    def loss(p):
        out, _, _ = jm.apply({**v, 'params': p}, jnp.asarray(x), w,
                             detach_16=detach_16, adain=adain)
        return jnp.sum(out * jnp.asarray(r))
    g = jax.jit(jax.grad(loss))(v['params'])
    return flax_to_state_dict({'params': g})


def _port_grads(pm, x, r, w, detach_16, adain):
    import copy

    from codeformer_tpu_torch.nn.blocks import set_kernels
    net = set_kernels(copy.deepcopy(pm).train(), False)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    out, _, _ = net(xt, w, detach_16=detach_16, adain=adain)
    (out * torch.from_numpy(r).permute(0, 3, 1, 2)).sum().backward()
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            for k, p in net.named_parameters()}


@pytest.mark.parametrize('detach_16', [True, False])
@pytest.mark.parametrize('adain', [True, False])
def test_codeformer_gradient_cuts_match_jax(models, detach_16, adain):
    """detach_16 stops the gradient at the codebook features, so the
    codebook gets none; the encoder taps handed to the fuse blocks pass
    none back, so without AdaIN (the only other way from the encoder to
    the image) the encoder's gradient is exactly zero in both."""
    jm, v, pm, x = models
    r = np.random.default_rng(7).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = _jax_grads(jm, v, x, r, 0.5, detach_16, adain)
    got = _port_grads(pm, x, r, 0.5, detach_16, adain)
    assert set(got) == set(want)
    enc = [k for k in want if k.startswith('encoder.')]
    assert all(not want[k].any() for k in enc) == (not adain)
    assert (not want['quantize.embedding.weight'].any()) == detach_16
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in want.values())
    for k, g in got.items():
        ref = want[k]
        if not ref.any():
            assert not g.any(), f'{k}: JAX gives no gradient, the port does'
            continue
        np.testing.assert_allclose(
            g.numpy(), ref.numpy(), rtol=0,
            atol=GRAD_TOL * float(ref.abs().max()) + floor, err_msg=k)

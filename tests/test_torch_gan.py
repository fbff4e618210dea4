"""The GAN modules of the port against the JAX package, fp32, the same
params and the same numpy inputs: the GAN losses and regularisers
(train/losses.py), the PatchGAN discriminator with its BatchNorm
statistics, the Gumbel quantizer and VQAutoEncoder(quantizer='gumbel')
(models/vqgan.py).

Tolerances (fp32 on both sides; the two sum in other orders): losses,
module outputs, input gradients and running statistics within 1e-5
relative (vector norm); parameter gradients within 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from codeformer_tpu.train import losses as jl  # noqa: E402
from codeformer_tpu_torch.models import vqgan as pvq  # noqa: E402
from codeformer_tpu_torch.train import losses as pl  # noqa: E402
from codeformer_tpu_torch.utils.convert import flax_to_state_dict  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-5
TINY_VQGAN = {'type': 'VQAutoEncoder', 'img_size': 64, 'nf': 32,
              'ch_mult': [1, 2, 4], 'quantizer': 'nearest',
              'codebook_size': 32, 'emb_dim': 16}


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _rel(a, b):
    """|a - b| / |b| over the whole vector (torch or numpy)."""
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    return float((a - b).pow(2).sum().sqrt()
                 / b.pow(2).sum().sqrt().clamp_min(1e-30))


# ----------------------------------------------------------------- losses
GAN_TYPES = ['vanilla', 'lsgan', 'wgan', 'wgan_softplus', 'hinge']


@pytest.mark.parametrize('gan_type', GAN_TYPES)
def test_gan_loss_matches_jax_both_sides(gan_type):
    pred = np.random.default_rng(1).normal(0, 2, (2, 1, 6, 6)) \
        .astype(np.float32)
    for real in (True, False):
        for disc in (True, False):
            want = jl.gan_loss(jnp.asarray(pred).astype(jnp.bfloat16), real,
                               gan_type, is_disc=disc, loss_weight=0.7)
            got = pl.gan_loss(torch.from_numpy(pred).to(torch.bfloat16),
                              real, gan_type, is_disc=disc, loss_weight=0.7)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                       err_msg=f'{real} {disc}')
    with pytest.raises(NotImplementedError):
        pl.gan_loss(torch.zeros(1), True, 'relativistic')


def test_hinge_weight_applies_to_the_generator_side_only():
    pred = torch.tensor([0.5, -2.0])
    assert float(pl.gan_loss(pred, True, is_disc=True, loss_weight=3.0)) \
        == float(pl.gan_loss(pred, True, is_disc=True))
    np.testing.assert_allclose(
        float(pl.gan_loss(pred, True, is_disc=False, loss_weight=3.0)),
        3.0 * 0.75)


@pytest.mark.parametrize('weighted', [False, True])
def test_weighted_tv_loss_matches_jax(weighted):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 7, 3)).astype(np.float32)
    w = rng.uniform(size=x.shape).astype(np.float32) if weighted else None
    want = jl.weighted_tv_loss(jnp.asarray(x),
                               None if w is None else jnp.asarray(w), 0.5)
    got = pl.weighted_tv_loss(_nchw(x), None if w is None else _nchw(w),
                              0.5)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def _critic(w):
    """A smooth per-image critic of NHWC (jax) / NCHW (torch) images."""
    def jax_fn(x):
        return jnp.sum(jnp.tanh(x * jnp.asarray(w)) ** 2, axis=(1, 2, 3))

    def torch_fn(x):
        return (torch.tanh(x * torch.from_numpy(w).view(1, 3, 1, 1)) ** 2
                ).sum((1, 2, 3))
    return jax_fn, torch_fn


def test_r1_penalty_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    jf, tf = _critic(np.array([0.3, -1.1, 0.7], np.float32))
    want = jl.r1_penalty(jax.grad(lambda a: jnp.sum(jf(a)))(jnp.asarray(x)))
    real = _nchw(x).requires_grad_(True)
    got = pl.r1_penalty(tf(real), real)
    assert got.requires_grad             # create_graph: it can be minimised
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)


def test_g_path_regularize_matches_jax():
    rng = np.random.default_rng(4)
    lat = rng.normal(size=(2, 3, 5)).astype(np.float32)
    wmat = rng.normal(size=(15, 4 * 4 * 3)).astype(np.float32)

    def jax_img(z):
        return jnp.tanh(z.reshape(2, 15) @ jnp.asarray(wmat)).reshape(
            2, 4, 4, 3)
    key = jax.random.PRNGKey(5)
    want = jl.g_path_regularize(jax_img, jnp.asarray(lat), 0.3, key)
    noise = np.asarray(jax.random.normal(key, (2, 4, 4, 3)))
    z = torch.from_numpy(lat).requires_grad_(True)
    img = torch.tanh(z.reshape(2, 15) @ torch.from_numpy(wmat)).reshape(
        2, 4, 4, 3).permute(0, 3, 1, 2)
    got = pl.g_path_regularize(img, z, 0.3, noise=_nchw(noise))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL)


@pytest.mark.parametrize('weighted', [False, True])
def test_gradient_penalty_matches_jax(weighted):
    rng = np.random.default_rng(6)
    real, fake = (rng.normal(size=(3, 6, 6, 3)).astype(np.float32)
                  for _ in range(2))
    w = rng.uniform(0.5, 1.5, real.shape).astype(np.float32) \
        if weighted else None
    jf, tf = _critic(np.array([0.4, 0.9, -0.6], np.float32))
    key = jax.random.PRNGKey(7)
    want = jl.gradient_penalty_loss(jf, jnp.asarray(real), jnp.asarray(fake),
                                    key, None if w is None else jnp.asarray(w))
    alpha = np.array(jax.random.uniform(key, (3, 1, 1, 1)))
    got = pl.gradient_penalty_loss(
        tf, _nchw(real), _nchw(fake), None if w is None else _nchw(w),
        alpha=torch.from_numpy(alpha))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)


# ---------------------------------------------------------- discriminator
def _disc_pair(ndf=8, n_layers=2, seed=0):
    from codeformer_tpu.models.vqgan import VQGANDiscriminator as JD
    x = np.zeros((1, 64, 64, 3), np.float32)
    jd = JD(ndf=ndf, n_layers=n_layers)
    v = jax.tree.map(np.asarray, jd.init(jax.random.PRNGKey(seed),
                                         jnp.asarray(x), train=False))
    # running statistics away from (0, 1), so eval mode reads them
    v['batch_stats'] = jax.tree.map(
        lambda a: a + np.random.default_rng(seed).uniform(0.1, 0.5, a.shape)
        .astype(np.float32), v['batch_stats'])
    pd = pvq.VQGANDiscriminator(ndf=ndf, n_layers=n_layers)
    pd.load_state_dict(flax_to_state_dict(v, like=pd.state_dict()))
    return jd, v, pd


def test_discriminator_names_are_the_reference_sequential():
    pd = pvq.VQGANDiscriminator()          # ndf 64, 4 layers
    keys = set(pd.state_dict())
    assert {'main.0.weight', 'main.0.bias', 'main.2.weight',
            'main.3.running_mean', 'main.3.num_batches_tracked',
            'main.11.weight', 'main.12.running_var', 'main.14.weight',
            'main.14.bias'} <= keys
    assert 'main.2.bias' not in keys
    from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY
    assert ARCH_REGISTRY.get('VQGANDiscriminator') is pvq.VQGANDiscriminator
    assert pd.main[3].momentum == 0.1 and pd.main[3].eps == 1e-5


def test_discriminator_eval_and_chained_train_match_jax():
    """Eval mode on the running statistics; two chained train-mode calls
    (real, then fake, as the d step) with their outputs, input gradients
    and the batch_stats they leave behind."""
    jd, v, pd = _disc_pair()
    rng = np.random.default_rng(8)
    real, fake = (rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
                  for _ in range(2))
    want = jd.apply(v, jnp.asarray(real), train=False)
    with torch.no_grad():
        got = pd.eval()(_nchw(real))
    assert _rel(_nhwc(got), want) <= RTOL

    def chained(params, stats, a, b):
        pa, mut = jd.apply({'params': params, 'batch_stats': stats}, a,
                           train=True, mutable=['batch_stats'])
        pb, mut = jd.apply({'params': params,
                            'batch_stats': mut['batch_stats']}, b,
                           train=True, mutable=['batch_stats'])
        return jnp.sum(pa ** 2) + jnp.sum(jnp.tanh(pb)), (pa, pb,
                                                          mut['batch_stats'])
    (_, (pa, pb, stats)), grads = jax.jit(jax.value_and_grad(
        chained, argnums=(2, 3), has_aux=True))(
            v['params'], v['batch_stats'], jnp.asarray(real),
            jnp.asarray(fake))
    pd.train()
    a, b = _nchw(real).requires_grad_(True), _nchw(fake).requires_grad_(True)
    qa, qb = pd(a), pd(b)
    ((qa ** 2).sum() + torch.tanh(qb).sum()).backward()
    assert _rel(_nhwc(qa), pa) <= RTOL and _rel(_nhwc(qb), pb) <= RTOL
    assert _rel(_nhwc(a.grad), grads[0]) <= RTOL
    assert _rel(_nhwc(b.grad), grads[1]) <= RTOL
    want_sd = flax_to_state_dict({'params': v['params'],
                                  'batch_stats': jax.tree.map(np.asarray,
                                                              stats)})
    got_sd = pd.state_dict()
    running = [k for k in want_sd if 'running' in k]
    assert len(running) == 4
    for k in running:
        assert _rel(got_sd[k], want_sd[k]) <= RTOL, k
        assert _rel(got_sd[k], flax_to_state_dict(v)[k]) > 1e-3, k
    assert int(got_sd['main.3.num_batches_tracked']) == 2


# ---------------------------------------------------------------- Gumbel
def _uniform_patch(monkeypatch, u):
    """jax.random.uniform returns the numpy draw `u` where its shape is
    asked for, so the JAX quantizer samples the noise handed in."""
    orig = jax.random.uniform

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if tuple(shape) == u.shape:
            return jnp.asarray(u, dtype)
        return orig(key, shape, dtype, minval, maxval)
    monkeypatch.setattr(jax.random, 'uniform', uniform)


def _port_noise(monkeypatch, u_nhwc):
    """The port's gumbel_noise gives -log(-log(u + 1e-20)) of the same
    draw, in its (B, K, h, w) layout."""
    g = torch.from_numpy(-np.log(-np.log(u_nhwc + np.float32(1e-20))))

    def noise(shape, generator, device):
        assert tuple(shape) == (g.shape[0], g.shape[3], g.shape[1],
                                g.shape[2])
        return g.permute(0, 3, 1, 2).to(device)
    monkeypatch.setattr(pvq, 'gumbel_noise', noise)


@pytest.mark.parametrize('train,straight_through', [
    (True, True), (True, False), (False, False)])
def test_gumbel_quantizer_matches_jax(monkeypatch, train, straight_through):
    from codeformer_tpu.models.vqgan import GumbelQuantizer as JG
    rng = np.random.default_rng(9)
    z = rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
    u = rng.uniform(1e-20, 1.0, (2, 4, 4, 16)).astype(np.float32)
    jg = JG(codebook_size=16, emb_dim=6, num_hiddens=8,
            straight_through=straight_through, kl_weight=5e-4)
    v = jax.tree.map(np.asarray, jg.init(jax.random.PRNGKey(1),
                                         jnp.asarray(z)))
    _uniform_patch(monkeypatch, u)
    _port_noise(monkeypatch, u)
    probe = rng.normal(size=(2, 4, 4, 6)).astype(np.float32)

    def f(params, zz):
        zq, diff, stats = jg.apply({'params': params}, zz, temperature=0.7,
                                   train=train,
                                   rngs={'gumbel': jax.random.PRNGKey(2)})
        return jnp.sum(zq * probe) + diff, (zq, diff, stats)
    (_, (zq, diff, stats)), (gp, gz) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v['params'], jnp.asarray(z))
    pg = pvq.GumbelQuantizer(16, 6, 8, straight_through, 5e-4)
    pg.load_state_dict(flax_to_state_dict(v))
    pg.train(train)
    zt = _nchw(z).requires_grad_(True)
    qz, qdiff, qstats = pg(zt, temperature=0.7)
    ((qz * _nchw(probe)).sum() + qdiff).backward()
    assert _rel(_nhwc(qz), zq) <= RTOL
    np.testing.assert_allclose(float(qdiff.detach()), float(diff), rtol=RTOL)
    np.testing.assert_array_equal(qstats['min_encoding_indices'].numpy(),
                                  np.asarray(stats['min_encoding_indices']))
    assert _rel(_nhwc(zt.grad), gz) <= 1e-4
    want = flax_to_state_dict({'params': jax.tree.map(np.asarray, gp)})
    for k, p in pg.named_parameters():
        assert _rel(p.grad, want[k]) <= 1e-4, k


@pytest.mark.parametrize('train', [True, False])
def test_vq_autoencoder_gumbel_forward_matches_jax(monkeypatch, train):
    from codeformer_tpu.models import VQAutoEncoder as JVQ
    from codeformer_tpu.utils.checkpoint import init_params_fast
    cfg = {k: v for k, v in TINY_VQGAN.items() if k != 'type'}
    cfg.update(quantizer='gumbel', gumbel_straight_through=True,
               gumbel_kl_weight=1e-3)
    rng = np.random.default_rng(10)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    u = rng.uniform(1e-20, 1.0, (2, 16, 16, 32)).astype(np.float32)
    jm = JVQ(**cfg)
    v = jax.tree.map(np.asarray, init_params_fast(jm, jnp.asarray(x[:1])))
    _uniform_patch(monkeypatch, u)
    _port_noise(monkeypatch, u)
    out_j, loss_j, stats_j = jax.jit(lambda v_, x_: jm.apply(
        v_, x_, temperature=0.5, train=train,
        rngs={'gumbel': jax.random.PRNGKey(3)}))(v, jnp.asarray(x))
    pm = pvq.VQAutoEncoder(**cfg).train(train)
    assert isinstance(pm.quantize, pvq.GumbelQuantizer)
    pm.load_state_dict(flax_to_state_dict(v))
    with torch.no_grad():
        out, loss, stats = pm(_nchw(x), temperature=0.5)
    assert _rel(_nhwc(out), out_j) <= 1e-4
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=RTOL)
    np.testing.assert_array_equal(stats['min_encoding_indices'].numpy(),
                                  np.asarray(stats_j['min_encoding_indices']))
    with pytest.raises(ValueError, match='quantizer'):
        pvq.VQAutoEncoder(**dict(cfg, quantizer='lookup'))

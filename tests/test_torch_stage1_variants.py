"""Stage I, VQGANModel, in the port against the JAX package's: the
Gumbel quantizer (the same noise handed to both sides) and gradient
accumulation, each over two iterations either side of net_d_start_iter,
with the side-by-side helpers and tolerances of test_torch_stage1.py."""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from codeformer_tpu_torch.models import vqgan as pvq  # noqa: E402
from test_torch_stage1 import (LOSS_RTOL, TINY_VQGAN, _capturing_jax,  # noqa: E402
                               _gt_batch, _port, _port_like, _stage1_opt,
                               check_grads, check_logs, check_state,
                               port_snapshot, run_side_by_side, sync_from_jax)

torch.set_num_threads(2)


def _uniform_patch(mp, u):
    """jax.random.uniform returns the numpy draw `u` where its shape is
    asked for, so the JAX quantizer samples the noise handed in."""
    orig = jax.random.uniform

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if tuple(shape) == u.shape:
            return jnp.asarray(u, dtype)
        return orig(key, shape, dtype, minval, maxval)
    mp.setattr(jax.random, 'uniform', uniform)
    g = torch.from_numpy(-np.log(-np.log(u + np.float32(1e-20))))
    mp.setattr(pvq, 'gumbel_noise',
               lambda shape, generator, device: g.permute(0, 3, 1, 2)
               .to(device))


def test_stage1_gumbel_steps_match_jax(tmp_path):
    """Two VQGANModel iterations with the Gumbel quantizer (straight
    through), the same noise handed to both sides, either side of
    net_d_start_iter."""
    opt = _stage1_opt(tmp_path, perceptual=False)
    opt['network_g'] = dict(TINY_VQGAN, quantizer='gumbel',
                            gumbel_straight_through=True,
                            gumbel_kl_weight=1e-3)
    u = np.random.default_rng(30).uniform(1e-20, 1.0, (2, 16, 16, 32)) \
        .astype(np.float32)

    def fake_of(jm, st, batch):
        it = 1 if st.step == 0 else 2
        return jm.net_g.apply(
            {'params': st.params_g}, jnp.asarray(batch['gt']),
            temperature=max(1 / 16, 1 - it / 160000), train=True,
            rngs={'gumbel': jax.random.PRNGKey(0)})[0]
    with pytest.MonkeyPatch.context() as mp:
        _uniform_patch(mp, u)
        jm = _capturing_jax(opt)
        pm = _port_like(jm, opt)
        assert pm.gumbel
        r = run_side_by_side(jm, pm, [_gt_batch(31), _gt_batch(32)],
                             (1, 2), fake_of)
    check_logs(r)
    assert r['logs_p'][0]['perplexity'] == 0.0
    for step, (sp, sj) in enumerate(zip(r['snap_p'], r['snap_j']), 1):
        check_grads(sp['grads_g'], sj['grads_g'], min_tensors=50)
        if step == 2:
            check_grads(sp['grads_d'], sj['grads_d'], min_tensors=5)
        check_state(sp, sj)


def test_stage1_accumulation_matches_jax_and_the_full_batch(tmp_path):
    """accum_steps 2 against JAX's accum_steps 2 (d_weight from the
    accumulated anchor gradients, the discriminator's statistics chained
    over the microbatches), and its generator update against
    accum_steps 1 on the same batch."""
    opt = _stage1_opt(tmp_path, perceptual=False, accum_steps=2)
    jm = _capturing_jax(opt)
    pm = _port_like(jm, opt)
    batches = [_gt_batch(40, n=4), _gt_batch(41, n=4)]
    r = run_side_by_side(jm, pm, batches, (1, 2))
    check_logs(r)
    for step, (sp, sj) in enumerate(zip(r['snap_p'], r['snap_j']), 1):
        check_grads(sp['grads_g'], sj['grads_g'], min_tensors=50)
        if step == 2:
            check_grads(sp['grads_d'], sj['grads_d'], min_tensors=5)
        check_state(sp, sj)
    full = _port(_stage1_opt(tmp_path, perceptual=False))
    sync_from_jax(full, jm)
    sync_from_jax(pm, jm)
    for m in (pm, full):
        m.feed_data(_gt_batch(42, n=4))
        m.optimize_parameters(3)
    for k in ('l_g_total', 'l_g_pix', 'l_codebook', 'd_weight', 'l_g_gan'):
        np.testing.assert_allclose(pm.log_dict[k], full.log_dict[k],
                                   rtol=LOSS_RTOL, err_msg=k)
    check_grads(port_snapshot(pm)['grads_g'], port_snapshot(full)['grads_g'],
                min_tensors=50)

"""Stage I, VQGANModel, in the port against the JAX package's, fp32, the
same params and the same numpy batches: three iterations with LPIPS on
seeded VGG16/lin files across net_d_start_iter, the net_d_iters gate,
the Gumbel quantizer, gradient accumulation, save/resume with the
discriminator, and the training entry point. The helpers here also
serve tests/test_torch_stage3.py.

Tolerances (fp32 on both sides; the two sum in other orders), those of
the stage-II tests of tests/test_torch_train.py: losses and d_weight
within 1e-5 relative (a mean of discriminator outputs, whose mean sits
near 0, within 1e-5 of the outputs' scale: PRED_MEANS); gradients within 1e-4 relative RMS, as one vector
and per tensor with an absolute floor of 1e-4 of the RMS of all the
gradients; params_g, params_d, d_stats and the EMA after each step within
1e-4 relative (vector norm).
"""
import os
import os.path as osp

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from codeformer_tpu_torch.utils.convert import (flax_to_state_dict,  # noqa: E402
                                                load_flax_trainer)

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_RTOL = 1e-4
TINY_VQGAN = {'type': 'VQAutoEncoder', 'img_size': 64, 'nf': 32,
              'ch_mult': [1, 2, 4], 'quantizer': 'nearest',
              'codebook_size': 32, 'emb_dim': 16}
TINY_D = {'type': 'VQGANDiscriminator', 'nc': 3, 'ndf': 8, 'n_layers': 2}


def _rel(a, b):
    """|a - b| / |b| over the whole vector (torch or numpy)."""
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    return float((a - b).pow(2).sum().sqrt()
                 / b.pow(2).sum().sqrt().clamp_min(1e-30))


# ------------------------------------------------------------- VQGANModel
def _stage1_opt(tmp_path, perceptual=True, **train):
    opt = {
        'name': 'port_stage1', 'model_type': 'VQGANModel', 'manual_seed': 0,
        'num_devices': 1, 'is_train': True, 'device': 'cpu',
        'network_g': dict(TINY_VQGAN), 'network_d': dict(TINY_D),
        'path': {'models': str(tmp_path / 'models'),
                 'training_states': str(tmp_path / 'states')},
        'train': {
            'total_iter': 10, 'warmup_iter': -1, 'ema_decay': 0.9,
            'optim_g': {'type': 'Adam', 'lr': 1e-4, 'weight_decay': 0.01,
                        'betas': [0.9, 0.99]},
            'optim_d': {'type': 'Adam', 'lr': 1e-4, 'weight_decay': 0,
                        'betas': [0.5, 0.99]},
            'scheduler': {'type': 'CosineAnnealingRestartLR',
                          'periods': [100], 'restart_weights': [1],
                          'eta_min': 1e-5},
            'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0},
            # a generator-side weight that keeps d_weight inside (0, 1),
            # where its ratio is not clipped away
            'gan_opt': {'type': 'GANLoss', 'gan_type': 'hinge',
                        'loss_weight': 50.0},
            'codebook_loss_weight': 1.0, 'disc_weight': 0.8,
            'net_g_start_iter': 0, 'net_d_iters': 1, 'net_d_start_iter': 1}}
    if perceptual:
        # weight 0.1: LPIPS's input gradient agrees with JAX's to 7e-6, but
        # at random init it is mostly high-frequency and its pull-back
        # through the generator cancels about 500-fold, leaving that part
        # of the parameter gradient 3.5e-3 apart in relative terms; at 0.1
        # its share of the whole gradient keeps that rounding under 5e-5
        opt['train']['perceptual_opt'] = {
            'type': 'LPIPSLoss', 'loss_weight': 0.1, 'use_input_norm': True,
            'range_norm': True}
    opt['train'].update(train)
    return opt


def _write_vgg(root):
    """Seeded weights/vgg/vgg16.pth and lpips_vgg.pth under `root`."""
    from test_torch_perceptual import lin_state_dict, vgg_state_dict
    rng = np.random.default_rng(0)
    os.makedirs(root / 'weights' / 'vgg', exist_ok=True)
    torch.save(vgg_state_dict(rng, 'vgg16'),
               root / 'weights' / 'vgg' / 'vgg16.pth')
    torch.save(lin_state_dict(rng), root / 'weights' / 'vgg' / 'lpips_vgg.pth')


def _gt_batch(seed, n=2):
    rng = np.random.default_rng(seed)
    return {'gt': rng.uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32),
            'gt_path': [f'{i}.png' for i in range(n)]}


def _grad_capture(tx):
    """tx, with the raw gradient of the last update kept beside its
    state: state = (grads, tx state)."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)
    return optax.GradientTransformation(init, update)


def _capturing_jax(opt, split=None):
    """The JAX trainer for `opt`, its optax chains wrapped so each
    update's raw gradients stay in opt_g[0] / opt_d[0]."""
    from codeformer_tpu.train.trainers import build_model as jax_build
    jm = jax_build(opt)
    jm.opt_g_tx = _grad_capture(jm.opt_g_tx)
    jm.opt_d_tx = _grad_capture(jm.opt_d_tx)
    params_g = jm.state.params_g if split is None else split(jm)
    jm.state = jm.state._replace(opt_g=jm.opt_g_tx.init(params_g),
                                 opt_d=jm.opt_d_tx.init(jm.state.params_d))
    return jm


def _port_like(jm, opt):
    from codeformer_tpu_torch.train.trainers import build_model
    pm = build_model(opt)
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    load_flax_trainer(pm, host(jm.state.params_g),
                      host(jm.vqgan_params) if getattr(
                          jm, 'generate_idx_gt', False) else None,
                      host(jm.state.params_d), host(jm.state.d_stats))
    return pm


def jax_snapshot(jm, like_d):
    st = jax.tree.map(np.asarray, jm.state)
    d = flax_to_state_dict({'params': st.params_d,
                            'batch_stats': st.d_stats}, like=like_d)
    return {'g': flax_to_state_dict({'params': st.params_g}),
            'ema': flax_to_state_dict({'params': st.params_g_ema}),
            'd': d, 'grads_g': flax_to_state_dict({'params': st.opt_g[0]}),
            'grads_d': flax_to_state_dict({'params': st.opt_d[0]},
                                          like=like_d)}


def port_snapshot(pm):
    def grads(net):
        return {n: (p.grad.clone() if p.grad is not None else None)
                for n, p in net.named_parameters() if p.requires_grad}
    return {'g': {k: v.clone() for k, v in pm.net_g.state_dict().items()},
            'ema': {k: v.clone() for k, v in pm.params_ema.items()},
            'd': {k: v.clone() for k, v in pm.net_d.state_dict().items()},
            'grads_g': grads(pm.net_g), 'grads_d': grads(pm.net_d),
            'step_d': pm.step_d,
            'opt_d': {k: {n: v.clone() for n, v in s.items()}
                      for k, s in pm.optimizer_d.state.items()}}


def _adam_from_optax(optimizer, named, adam_state, like=None):
    """optax's ScaleByAdamState (count, mu, nu) -> the torch AdamW state
    of the tensors in `named` (name -> parameter)."""
    count = int(np.asarray(adam_state.count))
    optimizer.state.clear()
    if count == 0:
        return
    mu = flax_to_state_dict({'params': adam_state.mu}, like=like)
    nu = flax_to_state_dict({'params': adam_state.nu}, like=like)
    for name, p in named.items():
        if name in mu:
            optimizer.state[p] = {
                'step': torch.tensor(float(count)),
                'exp_avg': mu[name].clone(), 'exp_avg_sq': nu[name].clone()}


def sync_from_jax(pm, jm):
    """The JAX trainer's whole state -> the port trainer: params, EMA,
    discriminator and its BatchNorm statistics, both Adam states and
    their schedule steps."""
    st = jax.tree.map(np.asarray, jm.state)
    load_flax_trainer(pm, st.params_g, None, st.params_d, st.d_stats)
    ema = flax_to_state_dict({'params': st.params_g_ema})
    for k, v in pm.params_ema.items():
        v.copy_(ema[k])
    adam_g, adam_d = st.opt_g[1][0], st.opt_d[1][0]
    _adam_from_optax(pm.optimizer, dict(pm.net_g.named_parameters()), adam_g)
    _adam_from_optax(pm.optimizer_d, dict(pm.net_d.named_parameters()),
                     adam_d, like=pm.net_d.state_dict())
    pm.step = int(np.asarray(adam_g.count))
    pm.step_d = int(np.asarray(adam_d.count))


def jax_d_grads(jm, st, real, fake, n=1):
    """JAX's d step on its own: per interleaved microbatch (i::n), the
    hinge losses of the discriminator in train mode on the real images,
    then on the fakes, its statistics chained through both and across
    the microbatches; the mean gradient w.r.t. params_d at `st`."""
    real, fake = jnp.asarray(real), jnp.asarray(fake)

    def d_loss(params):
        stats, total = st.d_stats, 0.0
        for i in range(n):
            for x, is_real in ((real[i::n], True), (fake[i::n], False)):
                pred, mut = jm.net_d.apply(
                    {'params': params, 'batch_stats': stats}, x,
                    train=True, mutable=['batch_stats'])
                stats = mut['batch_stats']
                total = total + jm._gan_loss(pred, is_real, is_disc=True) / n
        return total
    return jax.tree.map(np.asarray, jax.jit(jax.grad(d_loss))(st.params_d))


def vqgan_fake(jm, st, batch):
    return jm.net_g.apply({'params': st.params_g},
                          jnp.asarray(batch['gt']))[0]


def run_side_by_side(jm, pm, batches, iters, fake_of=vqgan_fake):
    """Each iteration on both trainers, the port starting every one from
    the JAX trainer's state (sync_from_jax): a step's result is held
    against JAX's from the same state. Run freely, the two trajectories
    part after a step, for reasons of the training dynamics and not of
    the port: Adam's first update turns the rounding noise of a gradient
    near zero into a step of about lr, and the nearest-code picks of the
    VQ round trip then flip for tokens near a tie. The discriminator's
    gradients are held against JAX's d loss on the step's own inputs
    (`jax_d_grads`), not against the gradients the jitted JAX step hands
    its optimizer: right after a step before net_d_start_iter, those read
    1.4% away from the same step run eagerly and from the d loss alone,
    which agree with each other and with the port to 1e-5.
    `fake_of(jm, state, batch)` is the JAX generator's image for the d
    step. Per-iteration logs and snapshots."""
    like_d = pm.net_d.state_dict()
    out = {'logs_j': [], 'logs_p': [], 'snap_j': [], 'snap_p': [],
           'p0': port_snapshot(pm)}
    for it, batch in zip(iters, batches):
        sync_from_jax(pm, jm)
        st0 = jax.tree.map(np.asarray, jm.state)
        jm.feed_data(batch)
        jm.optimize_parameters(it)
        pm.feed_data(batch)
        pm.optimize_parameters(it)
        out['logs_j'].append(dict(jm.log_dict))
        out['logs_p'].append(dict(pm.log_dict))
        snap = jax_snapshot(jm, like_d)
        snap['grads_d'] = flax_to_state_dict(
            {'params': jax_d_grads(jm, st0, batch['gt'],
                                   fake_of(jm, st0, batch),
                                   pm.accum_steps)}, like=like_d)
        out['snap_j'].append(snap)
        out['snap_p'].append(port_snapshot(pm))
    return out


# means of discriminator outputs: the outputs are O(0.1-1) with a mean
# near 0, so these are held to LOSS_RTOL of the outputs' scale (for
# l_g_gan times the weight it carries) rather than of the mean itself
PRED_MEANS = ('out_d_real', 'out_d_fake', 'l_g_gan')


def check_logs(r, gan_weight=50.0):
    for step, (lj, lp) in enumerate(zip(r['logs_j'], r['logs_p']), 1):
        assert set(lp) == set(lj), (step, set(lp) ^ set(lj))
        for k in lp:
            atol = 0.0
            if k in PRED_MEANS:
                atol = LOSS_RTOL * (gan_weight * lj['d_weight']
                                    if k == 'l_g_gan' else 1.0)
            np.testing.assert_allclose(lp[k], lj[k], rtol=LOSS_RTOL,
                                       atol=atol, err_msg=f'step {step} {k}')


def check_grads(gp, gj, min_tensors=1):
    names = [n for n in gp if gp[n] is not None]
    assert len(names) >= min_tensors
    flat_j = torch.cat([gj[n].reshape(-1) for n in names])
    flat_p = torch.cat([gp[n].reshape(-1) for n in names])
    assert _rel(flat_p, flat_j) <= GRAD_RTOL
    floor = 1e-4 * float(flat_j.pow(2).mean().sqrt())
    for n in names:
        g, j = gp[n], gj[n]
        rms_d = float((g - j).pow(2).mean().sqrt())
        assert rms_d <= GRAD_RTOL * float(j.pow(2).mean().sqrt()) + floor, n
    for n, g in gp.items():          # no gradient: none in JAX either
        if g is None:
            assert float(gj[n].abs().max()) == 0.0, n


def check_state(sp, sj, keys_of=('g', 'ema', 'd')):
    for part in keys_of:
        p, j = sp[part], sj[part]
        names = sorted(k for k in p if not k.endswith('num_batches_tracked'))
        assert _rel(torch.cat([p[k].reshape(-1).float() for k in names]),
                    torch.cat([j[k].reshape(-1) for k in names])) \
            <= PARAM_RTOL, part
    run = [k for k in sj['d'] if 'running' in k]
    assert run and _rel(torch.cat([sp['d'][k] for k in run]),
                        torch.cat([sj['d'][k] for k in run])) <= PARAM_RTOL


@pytest.fixture(scope='module')
def stage1_runs(tmp_path_factory):
    """Three VQGANModel iterations of the JAX trainer and of the port
    from the same params on the same batches, with LPIPS on seeded VGG16
    and lin files; net_d_start_iter 1, so iteration 1 runs before the
    discriminator's gate and 2-3 after it."""
    tmp = tmp_path_factory.mktemp('stage1')
    _write_vgg(tmp)
    opt = _stage1_opt(tmp)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        jm = _capturing_jax(opt)
        pm = _port_like(jm, opt)
    assert pm.cri_perceptual is not None and not pm.cri_perceptual.degraded
    return run_side_by_side(jm, pm, [_gt_batch(i) for i in (1, 2, 3)],
                            (1, 2, 3))


def test_stage1_losses_and_d_weight_match_jax(stage1_runs):
    r = stage1_runs
    check_logs(r)
    lp = r['logs_p']
    assert {'l_g_total', 'l_g_gan', 'd_weight', 'l_g_pix', 'l_g_percep',
            'l_codebook', 'perplexity', 'l_d_real', 'l_d_fake', 'out_d_real',
            'out_d_fake'} == set(lp[0])
    assert lp[0]['l_g_gan'] == 0.0 and lp[1]['l_g_gan'] != 0.0
    assert all(0.0 < log['d_weight'] < 0.8 for log in lp)   # not clipped


def test_stage1_grads_match_jax(stage1_runs):
    r = stage1_runs
    for step, (sp, sj) in enumerate(zip(r['snap_p'], r['snap_j']), 1):
        check_grads(sp['grads_g'], sj['grads_g'], min_tensors=50)
        if step == 1:            # before the gate: no d backward at all
            assert all(g is None for g in sp['grads_d'].values())
        else:
            check_grads(sp['grads_d'], sj['grads_d'], min_tensors=5)


def test_stage1_params_and_d_stats_match_jax_after_each_step(stage1_runs):
    r = stage1_runs
    for sp, sj in zip(r['snap_p'], r['snap_j']):
        check_state(sp, sj)
    p0, p3 = r['p0'], r['snap_p'][-1]
    moved = _rel(torch.cat([p3['g'][k].reshape(-1) for k in sorted(p0['g'])]),
                 torch.cat([p0['g'][k].reshape(-1) for k in sorted(p0['g'])]))
    assert moved > 10 * PARAM_RTOL


def test_stage1_discriminator_waits_for_net_d_start_iter(stage1_runs):
    """Before net_d_start_iter: net_d's parameters and BatchNorm
    statistics bit-equal, no Adam state, no step; past it, all move."""
    r = stage1_runs
    p0, p1, p2 = r['p0'], r['snap_p'][0], r['snap_p'][1]
    for k, v in p0['d'].items():
        assert torch.equal(p1['d'][k], v), k
    assert p1['step_d'] == 0 and p1['opt_d'] == {}
    assert p2['step_d'] == 1 and len(p2['opt_d']) == len(p0['grads_d'])
    assert all(int(s['step']) == 1 for s in p2['opt_d'].values())
    assert not torch.equal(p2['d']['main.3.running_mean'],
                           p0['d']['main.3.running_mean'])
    assert not torch.equal(p2['d']['main.0.weight'], p0['d']['main.0.weight'])


def _port(opt):
    from codeformer_tpu_torch.train.trainers import build_model
    return build_model(opt)


def test_net_d_iters_gates_the_whole_g_step(tmp_path):
    """net_d_iters 2, net_g_start_iter 1: the generator updates at
    iterations 2 and 4 only. A gated iteration leaves net_g and its Adam
    state bit-equal and logs the d losses alone; the d step and the EMA
    run every iteration (vqgan_model.py:135)."""
    pm = _port(_stage1_opt(tmp_path, perceptual=False, net_d_iters=2,
                           net_g_start_iter=1, net_d_start_iter=0))
    d_keys = {'l_d_real', 'l_d_fake', 'out_d_real', 'out_d_fake'}
    for it in range(1, 5):
        before = port_snapshot(pm)
        adam = {id(p): {k: v.clone() for k, v in s.items()}
                for p, s in pm.optimizer.state.items()}
        pm.feed_data(_gt_batch(20 + it))
        pm.optimize_parameters(it)
        after = port_snapshot(pm)
        g_moved = any(not torch.equal(after['g'][k], v)
                      for k, v in before['g'].items())
        assert g_moved == (it % 2 == 0), it
        assert pm.step == it // 2
        if it % 2:
            assert set(pm.log_dict) == d_keys
            assert {id(p): s for p, s in pm.optimizer.state.items()}.keys() \
                == adam.keys()
            for p, s in pm.optimizer.state.items():
                for k, v in s.items():
                    assert torch.equal(v, adam[id(p)][k]), k
        else:
            assert d_keys < set(pm.log_dict)
        assert pm.step_d == it
        assert not torch.equal(after['d']['main.0.weight'],
                               before['d']['main.0.weight'])
        if it >= 2:    # the EMA equals the params until g first moves
            assert any(not torch.equal(after['ema'][k], v)
                       for k, v in before['ema'].items()), it


def test_stage1_save_resume_round_trip(tmp_path):
    """save() writes net_g, net_d (with its BatchNorm statistics) and the
    two optimizer states; a fresh trainer resumed from them continues
    bit for bit."""
    opt = _stage1_opt(tmp_path, perceptual=False)
    pm = _port(opt)
    for it in (1, 2, 3):
        pm.feed_data(_gt_batch(50 + it))
        pm.optimize_parameters(it)
    pm.save(epoch=0, current_iter=3)
    state_file = osp.join(opt['path']['training_states'], '3.state')
    assert osp.exists(osp.join(opt['path']['models'], 'net_d_3.pth'))
    pm2 = _port(opt)
    assert pm2.resume_training(state_file) == (0, 3)
    assert (pm2.step, pm2.step_d) == (pm.step, pm.step_d) == (3, 2)
    for a, b in ((pm.net_d, pm2.net_d), (pm.net_g, pm2.net_g)):
        for k, v in a.state_dict().items():
            assert torch.equal(b.state_dict()[k], v), k
    for m in (pm, pm2):
        m.feed_data(_gt_batch(54))
        m.optimize_parameters(4)
    for a, b in ((pm.net_d, pm2.net_d), (pm.net_g, pm2.net_g)):
        for k, v in a.state_dict().items():
            assert torch.equal(b.state_dict()[k], v), k
    assert pm.log_dict == pm2.log_dict


def test_stage1_gumbel_noise_is_seeded_per_iteration(tmp_path):
    """Without noise handed in, the quantizer's draws come from a
    generator seeded with (manual_seed, current_iter): the same iteration
    gives the same step, another iteration other noise."""
    opt = _stage1_opt(tmp_path, perceptual=False)
    opt['network_g'] = dict(TINY_VQGAN, quantizer='gumbel')
    outs = []
    for it in (5, 5, 6):
        pm = _port(opt)
        pm.feed_data(_gt_batch(33))
        with torch.no_grad():
            outs.append(pm._g_forward(pm.batch['gt'], it)[0])
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])

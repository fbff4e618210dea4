"""Stage III, CodeFormerJointModel, in the port against the JAX package's,
fp32, the same params and the same numpy batches: three iterations past
120000, where the joint schedule gives w 1.3 and one small-degradation
iteration in 15, at net_d_iters 2, so that the code step (iteration
120002: large degradation, generator on), the d-only step (120015: small,
generator gated) and the full step (120030: small, generator on) each
run. The frozen HQ VQGAN encodes the ground truth for idx_gt through K3's
plain version; quantize and generator are frozen, so the adaptive
weight's anchor is the largest fuse block's last shift conv; the SFT
branches are tamed as chip_smoke.tame_sft does (`tamed_jax`). Helpers and
tolerances are those of test_torch_stage1.py (the port starts each
iteration from the JAX trainer's state).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_stage1 import (TINY_D, TINY_VQGAN, _capturing_jax,  # noqa: E402
                               _port, _port_like, check_grads, check_logs,
                               check_state, port_snapshot, run_side_by_side)

torch.set_num_threads(2)

TINY_CF = {'type': 'CodeFormer', 'dim_embd': 32, 'n_head': 4,
           'n_layers': 2, 'codebook_size': 32, 'latent_size': 256,
           'connect_list': ['32', '64'],
           'fix_modules': ['quantize', 'generator'],
           'img_size': 64, 'nf': 32, 'ch_mult': [1, 2, 4], 'emb_dim': 16}
ITERS = (120002, 120015, 120030)     # code, d-only, full
GAN_WEIGHT = 50.0


def stage3_opt(tmp_path, model_type='CodeFormerJointModel', **train):
    opt = {
        'name': 'port_stage3', 'model_type': model_type, 'manual_seed': 0,
        'num_devices': 1, 'is_train': True, 'device': 'cpu',
        'network_g': dict(TINY_CF), 'network_vqgan': dict(TINY_VQGAN),
        'network_d': dict(TINY_D),
        'datasets': {'train': {'in_size': 64}},   # JAX's init sample size
        'path': {'models': str(tmp_path / 'models'),
                 'training_states': str(tmp_path / 'states')},
        'train': {
            'total_iter': 200000, 'warmup_iter': -1, 'ema_decay': 0.9,
            'use_hq_feat_loss': True, 'feat_loss_weight': 1.0,
            'cross_entropy_loss': True, 'entropy_loss_weight': 0.5,
            'scale_adaptive_gan_weight': 0.8,
            'optim_g': {'type': 'Adam', 'lr': 1e-4, 'weight_decay': 0.01,
                        'betas': [0.9, 0.99]},
            'optim_d': {'type': 'Adam', 'lr': 1e-4, 'weight_decay': 0,
                        'betas': [0.5, 0.99]},
            'scheduler': {'type': 'CosineAnnealingRestartLR',
                          'periods': [100], 'restart_weights': [1],
                          'eta_min': 1e-5},
            'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0},
            # keeps d_weight inside (0, 1), where its ratio is not clipped
            'gan_opt': {'type': 'GANLoss', 'gan_type': 'hinge',
                        'loss_weight': GAN_WEIGHT},
            'net_g_start_iter': 0, 'net_d_iters': 2, 'net_d_start_iter': 0}}
    opt['train'].update(train)
    return opt


def joint_batch(seed, n=2):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32)
            for k in ('in', 'in_large_de', 'gt')}


def cf_fake(w):
    def fake_of(jm, st, batch):
        return jm.net_g.apply({'params': st.params_g},
                              jnp.asarray(batch['in']), w,
                              detach_16=True)[0]
    return fake_of


def tamed_jax(opt, factor=1e-2):
    """The capturing JAX trainer for `opt` with its SFT branches' last
    convs (scale_2, shift_2) scaled by `factor`, as chip_smoke.tame_sft
    and tests/test_torch_tasks.py do: with random weights each fusion
    multiplies the generator's activations by their own size, and the
    parameter gradients of a step then come out of cancellations so deep
    that both packages' own rounding moves them by 1e-3 (the port's
    channels_last and NCHW layouts disagree by 7e-5 there). Trained
    weights keep activations in range."""
    jm = _capturing_jax(opt, split=_split)

    def tame(path, leaf):
        keys = [getattr(k, 'key', str(k)) for k in path]
        if keys[0].startswith('fuse_convs_dict') and keys[1] in (
                'scale_2', 'shift_2') and keys[-1] == 'kernel':
            return leaf * factor
        return leaf
    params = jax.tree_util.tree_map_with_path(
        tame, jax.tree.map(np.asarray, jm.state.params_g))
    jm.state = jm.state._replace(params_g=params,
                                 params_g_ema=jax.tree.map(np.copy, params))
    return jm


def _split(jm):
    from codeformer_tpu.train.trainers import _split_params
    return _split_params(jm.state.params_g, jm._fix_keys)[0]


@pytest.fixture(scope='module')
def stage3_runs(tmp_path_factory):
    opt = stage3_opt(tmp_path_factory.mktemp('stage3'))
    jm = tamed_jax(opt)
    pm = _port_like(jm, opt)
    assert pm.anchor is pm.net_g.fuse_convs_dict['64'].shift[2].weight
    assert [jm._phase(i) for i in ITERS] == [(1.3, 15)] * 3
    r = run_side_by_side(jm, pm, [joint_batch(60 + i) for i in range(3)],
                         ITERS, cf_fake(1.3))
    r['port'] = pm
    return r


def test_stage3_losses_match_jax_at_each_step(stage3_runs):
    r = stage3_runs
    check_logs(r, GAN_WEIGHT)
    code, d_only, full = r['logs_p']
    assert set(code) == {'l_feat_encoder', 'cross_entropy_loss', 'l_g_total'}
    assert set(d_only) == {'l_d_real', 'l_d_fake', 'out_d_real',
                           'out_d_fake'}
    assert set(full) == set(code) | set(d_only) | {'l_g_pix', 'd_weight',
                                                   'l_g_gan'}
    assert 0.0 < full['d_weight'] < 0.8          # not clipped


def test_stage3_grads_match_jax(stage3_runs):
    r = stage3_runs
    for i, (sp, sj) in enumerate(zip(r['snap_p'], r['snap_j'])):
        if i != 1:       # the d-only step takes no generator gradient
            check_grads(sp['grads_g'], sj['grads_g'], min_tensors=20)
        if i != 0:       # the code step runs no d step
            check_grads(sp['grads_d'], sj['grads_d'], min_tensors=5)
    # the code step reaches no SFT block; its optimizer step still moves
    # them (Adam's moments from earlier steps, weight decay), as optax
    fuse = [n for n in r['snap_p'][0]['grads_g'] if n.startswith('fuse')]
    assert fuse and all(float(r['snap_p'][0]['grads_g'][n].abs().max())
                        == 0.0 for n in fuse)


def test_stage3_params_match_jax_and_frozen_modules_stay(stage3_runs):
    r = stage3_runs
    for sp, sj in zip(r['snap_p'], r['snap_j']):
        check_state(sp, sj)
    p0, p3 = r['p0'], r['snap_p'][-1]
    frozen = [k for k in p0['g'] if k.split('.')[0] in ('quantize',
                                                         'generator')]
    assert frozen and set(frozen) == set(r['port'].frozen)
    for k in frozen:
        assert torch.equal(p3['g'][k], p0['g'][k]), k
    trained = [k for k in p0['g'] if k not in frozen]
    assert any(not torch.equal(p3['g'][k], p0['g'][k]) for k in trained)


def test_stage3_gated_large_degradation_moves_only_the_ema(tmp_path):
    """Iteration 120003 (large degradation, generator gated by
    net_d_iters): no generator or discriminator update, no losses; the
    EMA moves toward the params."""
    pm = _port(stage3_opt(tmp_path, ema_decay=0.5))
    pm.feed_data(joint_batch(70))
    pm.optimize_parameters(120002)                 # a code step first
    before = port_snapshot(pm)
    pm.feed_data(joint_batch(71))
    pm.optimize_parameters(120003)
    after = port_snapshot(pm)
    assert pm.log_dict == {}
    for part in ('g', 'd'):
        for k, v in before[part].items():
            assert torch.equal(after[part][k], v), k
    assert (pm.step, pm.step_d) == (1, 0)
    assert any(not torch.equal(after['ema'][k], v)
               for k, v in before['ema'].items())


def test_transformer_in_fix_modules_turns_the_code_losses_off(tmp_path):
    """fix_modules with 'transformer' freezes the token path and gates
    the code losses off (codeformer_joint_model.py:181): the code step
    takes a zero-gradient update."""
    opt = stage3_opt(tmp_path)
    opt['network_g']['fix_modules'] = ['quantize', 'generator',
                                       'transformer']
    pm = _port(opt)
    assert not pm.code_losses_on
    frozen_tops = {k.split('.')[0] for k in pm.frozen}
    assert frozen_tops == {'quantize', 'generator', 'ft_layers', 'feat_emb',
                           'position_emb', 'idx_pred_layer'}
    pm.feed_data(joint_batch(72))
    pm.optimize_parameters(120002)
    assert pm.log_dict == {'l_g_total': 0.0} and pm.step == 1

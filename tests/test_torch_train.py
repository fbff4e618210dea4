"""Stage-II training in the port (codeformer_tpu_torch/train) against the
JAX package's CodeFormerIdxModel on the tiny config of
tests/test_training.py, fp32, the same params and the same numpy batches.

Tolerances (fp32 on both sides; the two sum in other orders):
  - idx_gt equal (the nearest codes are far apart at this seed);
  - l_feat_encoder, cross_entropy_loss, l_g_total within 1e-5 relative;
  - trainable grads within 1e-4 relative RMS, as one vector and per
    tensor; a tensor whose exact gradient is zero (a conv bias right
    before a one-channel-per-group GroupNorm, the attention key bias)
    holds only rounding noise, so each tensor also gets an absolute
    floor of 1e-4 of the RMS of all the gradients;
  - parameters after 3 AdamW steps within 1e-4 relative (vector norm);
  - frozen modules bit-identical, EMA by its formula to 1e-6.
Losses, schedules and the optimizer are also held against their JAX/optax
twins one by one.
"""
import logging
import os.path as osp

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from codeformer_tpu.train import losses as jl  # noqa: E402
from codeformer_tpu.train import schedulers as js  # noqa: E402
from codeformer_tpu_torch.train import losses as pl  # noqa: E402
from codeformer_tpu_torch.train import schedulers as ps  # noqa: E402
from codeformer_tpu_torch.utils.convert import (flax_to_state_dict,  # noqa: E402
                                                load_flax_trainer)

torch.set_num_threads(2)

TINY_VQGAN = {'type': 'VQAutoEncoder', 'img_size': 64, 'nf': 32,
              'ch_mult': [1, 2, 4], 'quantizer': 'nearest',
              'codebook_size': 32, 'emb_dim': 16}
TINY_CF = {'type': 'CodeFormer', 'dim_embd': 32, 'n_head': 4,
           'n_layers': 2, 'codebook_size': 32, 'latent_size': 256,
           'connect_list': ['32', '64'],
           'fix_modules': ['quantize', 'generator'],
           'img_size': 64, 'nf': 32, 'ch_mult': [1, 2, 4], 'emb_dim': 16}
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_RTOL = 1e-4


def _opt(tmp_path, **train):
    opt = {
        'name': 'port_stage2', 'model_type': 'CodeFormerIdxModel',
        'manual_seed': 0, 'num_devices': 1, 'is_train': True,
        'device': 'cpu',
        'network_g': dict(TINY_CF), 'network_vqgan': dict(TINY_VQGAN),
        'path': {'models': str(tmp_path / 'models'),
                 'training_states': str(tmp_path / 'states')},
        'train': {
            'total_iter': 4, 'warmup_iter': -1, 'ema_decay': 0.9,
            'use_hq_feat_loss': True, 'cross_entropy_loss': True,
            'optim_g': {'type': 'Adam', 'lr': 1e-4, 'weight_decay': 0.01,
                        'betas': [0.9, 0.99]},
            'scheduler': {'type': 'CosineAnnealingRestartLR',
                          'periods': [100], 'restart_weights': [1],
                          'eta_min': 1e-5}}}
    opt['train'].update(train)
    return opt


def _batch(seed, n=2):
    rng = np.random.default_rng(seed)
    return {'in': rng.uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32),
            'gt': rng.uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32),
            'gt_path': [f'{i}.png' for i in range(n)]}


def _port(opt):
    from codeformer_tpu_torch.train.trainers import build_model
    return build_model(opt)


def _rel(a, b):
    return float((a - b).pow(2).sum().sqrt()
                 / b.pow(2).sum().sqrt().clamp_min(1e-30))


def _grad_capture(tx):
    """tx, with the raw gradient of the last update kept beside its
    state: state = (grads, tx state)."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)
    return optax.GradientTransformation(init, update)


@pytest.fixture(scope='module')
def stage2_runs(tmp_path_factory):
    """Three steps of the JAX trainer and of the port from the same
    params on the same batches; snapshots for the tests below."""
    from codeformer_tpu.train.trainers import _split_params
    from codeformer_tpu.train.trainers import build_model as jax_build
    opt = _opt(tmp_path_factory.mktemp('stage2'))
    jm = jax_build(opt)
    jm.opt_g_tx = _grad_capture(jm.opt_g_tx)
    jm.state = jm.state._replace(opt_g=jm.opt_g_tx.init(
        _split_params(jm.state.params_g, jm._fix_keys)[0]))
    jm._step = jm._jit_step(jm._make_step())
    pm = _port(opt)
    load_flax_trainer(pm, jax.tree.map(np.asarray, jm.state.params_g),
                      jax.tree.map(np.asarray, jm.vqgan_params))

    out = {'port': pm, 'logs_j': [], 'logs_p': []}
    def clone():
        return {k: v.clone() for k, v in pm.net_g.state_dict().items()}
    out['p0'] = clone()
    for it in (1, 2, 3):
        batch = _batch(it)
        if it == 1:
            out['idx_j'] = np.asarray(jm._idx_gt(
                jm.vqgan_params, jnp.asarray(batch['gt']), {}))
            pm.feed_data(batch)
            out['idx_p'] = pm._idx_gt(pm.batch).numpy()
        jm.feed_data(batch)
        jm.optimize_parameters(it)
        pm.feed_data(batch)
        pm.optimize_parameters(it)
        out['logs_j'].append(dict(jm.log_dict))
        out['logs_p'].append(dict(pm.log_dict))
        if it == 1:
            out['grads_j'] = flax_to_state_dict(
                {'params': jax.tree.map(np.asarray, jm.state.opt_g[0])})
            out['grads_p'] = {n: p.grad.clone() if p.grad is not None
                              else None
                              for n, p in pm.net_g.named_parameters()
                              if p.requires_grad}
            out['p1'] = clone()
            out['ema1'] = {k: v.clone() for k, v in pm.params_ema.items()}
    out['params_j'] = flax_to_state_dict(
        {'params': jax.tree.map(np.asarray, jm.state.params_g)})
    out['ema_j'] = flax_to_state_dict(
        {'params': jax.tree.map(np.asarray, jm.state.params_g_ema)})
    out['p3'] = clone()
    return out


def test_stage2_idx_gt_and_losses_match_jax(stage2_runs):
    r = stage2_runs
    np.testing.assert_array_equal(r['idx_p'], r['idx_j'])
    assert len(np.unique(r['idx_p'])) > 4
    for step, (lj, lp) in enumerate(zip(r['logs_j'], r['logs_p']), 1):
        assert set(lp) == {'l_feat_encoder', 'cross_entropy_loss',
                           'l_g_total'}
        for k in lp:
            np.testing.assert_allclose(lp[k], lj[k], rtol=LOSS_RTOL,
                                       err_msg=f'step {step} {k}')


def test_stage2_grads_match_jax(stage2_runs):
    gj, gp = stage2_runs['grads_j'], stage2_runs['grads_p']
    assert set(gp) <= set(gj)
    flat_j = torch.cat([gj[n].reshape(-1) for n in gp])
    flat_p = torch.cat([(g if g is not None else torch.zeros_like(gj[n]))
                        .reshape(-1) for n, g in gp.items()])
    assert _rel(flat_p, flat_j) <= GRAD_RTOL
    floor = 1e-4 * float(flat_j.pow(2).mean().sqrt())
    n_checked = 0
    for n, g in gp.items():
        j = gj[n]
        if g is None:   # not on the code_only path (the SFT blocks)
            assert float(j.abs().max()) == 0.0, n
            continue
        n_checked += 1
        rms_d = float((g - j).pow(2).mean().sqrt())
        assert rms_d <= GRAD_RTOL * float(j.pow(2).mean().sqrt()) + floor, n
    assert n_checked > 50


def test_stage2_three_steps_match_jax(stage2_runs):
    r = stage2_runs
    pj, pp = r['params_j'], r['p3']
    def flat(sd):
        return torch.cat([sd[k].reshape(-1) for k in sorted(pp)])
    assert _rel(flat(pp), flat(pj)) <= PARAM_RTOL
    assert _rel(flat(r['port'].params_ema), flat(r['ema_j'])) <= PARAM_RTOL
    # the three steps moved the params 20x the tolerance (2e-3 relative)
    assert _rel(flat(pp), flat(r['p0'])) > 10 * PARAM_RTOL


def test_stage2_unreached_trainables_step_as_optax(stage2_runs):
    """The SFT blocks are trainable but the code_only path never reaches
    them. optax still updates the whole trainable tree, so their weight
    decay moves them (1e-4 x 0.01 a step); the port gives them a zero
    gradient rather than skipping them, and they track JAX's."""
    r = stage2_runs
    fuse = sorted(k for k in r['p3'] if k.startswith('fuse_convs_dict')
                  and k.endswith('weight'))
    assert fuse

    def flat(sd):
        return torch.cat([sd[k].reshape(-1) for k in fuse])
    assert _rel(flat(r['p3']), flat(r['params_j'])) <= 5e-7
    assert _rel(flat(r['p3']), flat(r['p0'])) > 2e-6


def test_stage2_frozen_modules_do_not_move(stage2_runs):
    r = stage2_runs
    pm = r['port']
    frozen = [k for k in r['p0'] if k.split('.')[0] in ('quantize',
                                                        'generator')]
    assert frozen and set(frozen) == set(pm.frozen)
    for k in frozen:
        assert torch.equal(r['p3'][k], r['p0'][k]), k
    in_opt = {id(p) for g in pm.optimizer.param_groups for p in g['params']}
    named = dict(pm.net_g.named_parameters())
    assert not any(id(named[k]) in in_opt for k in frozen)
    assert named['encoder.blocks.0.weight'].requires_grad


def test_stage2_ema_follows_its_formula(stage2_runs):
    """ema_1 = p_0 * d + p_1 * (1 - d) over every parameter, frozen ones
    included (the EMA starts at p_0)."""
    r = stage2_runs
    d = 0.9
    for k, e in r['ema1'].items():
        want = r['p0'][k] * d + r['p1'][k] * (1 - d)
        torch.testing.assert_close(e, want, rtol=1e-6, atol=1e-9)


def test_accum_steps_2_equals_accum_1(tmp_path):
    """Two interleaved microbatches of one reproduce the full-batch
    update (as test_grad_accum_stage2_equivalence for JAX)."""
    batch = _batch(7)
    runs = []
    for accum in (1, 2):
        pm = _port(_opt(tmp_path, accum_steps=accum))
        pm.feed_data(batch)
        pm.optimize_parameters(1)
        runs.append(pm)
    for k, v in runs[0].log_dict.items():
        np.testing.assert_allclose(runs[1].log_dict[k], v, rtol=2e-5,
                                   atol=1e-6, err_msg=k)
    a = dict(runs[0].net_g.named_parameters())
    b = dict(runs[1].net_g.named_parameters())
    ok = tot = 0
    for k in a:
        x, y = a[k].detach(), b[k].detach()
        ok += int(((x - y).abs() <= 1e-6 + 1e-4 * y.abs()).sum())
        tot += x.numel()
    assert ok / tot > 0.9


def test_accum_steps_must_divide_the_batch(tmp_path):
    with pytest.raises(ValueError, match='accum_steps'):
        _port(_opt(tmp_path, accum_steps=0))
    pm = _port(_opt(tmp_path, accum_steps=3))
    pm.feed_data(_batch(8))
    with pytest.raises(ValueError, match='accum_steps'):
        pm.optimize_parameters(1)


def test_save_resume_round_trip(tmp_path):
    opt = _opt(tmp_path)
    pm = _port(opt)
    for it in (1, 2):
        pm.feed_data(_batch(10 + it))
        pm.optimize_parameters(it)
    pm.save(epoch=0, current_iter=2)
    state_file = osp.join(opt['path']['training_states'], '2.state')
    assert osp.exists(state_file)
    pm2 = _port(opt)
    assert pm2.resume_training(state_file) == (0, 2)
    assert pm2.step == pm.step == 2
    for k, v in pm.net_g.state_dict().items():
        assert torch.equal(pm2.net_g.state_dict()[k], v), k
        assert torch.equal(pm2.params_ema[k], pm.params_ema[k]), k
    # the next step continues identically (optimizer moments restored)
    for m in (pm, pm2):
        m.feed_data(_batch(13))
        m.optimize_parameters(3)
    for k, v in pm.net_g.state_dict().items():
        assert torch.equal(pm2.net_g.state_dict()[k], v), k
    # the network file is a .pth the port's loader reads (params_ema)
    from codeformer_tpu_torch.utils.convert import load_pth
    sd = load_pth(osp.join(opt['path']['models'], 'net_g_2.pth'))
    assert set(sd) == set(pm.net_g.state_dict())


def test_bf16_step_takes_kernels_in_the_frozen_encode_only(tmp_path):
    """mixed_precision bf16: the frozen HQ VQGAN's blocks use the K1/K2
    form (its plain versions here, on the CPU), net_g the textbook form;
    losses finite, parameters, EMA and optimizer state fp32."""
    from codeformer_tpu_torch.nn.blocks import Downsample, ResBlock
    pm = _port(dict(_opt(tmp_path), mixed_precision='bf16'))
    assert pm.compute_dtype == torch.bfloat16
    switched = (ResBlock, Downsample)
    assert all(m.use_kernels for m in pm.hq_vqgan.modules()
               if isinstance(m, switched))
    assert not any(m.use_kernels for m in pm.net_g.modules()
                   if isinstance(m, switched))
    pm.feed_data(_batch(20))
    pm.optimize_parameters(1)
    assert all(np.isfinite(v) for v in pm.log_dict.values()), pm.log_dict
    assert all(p.dtype == torch.float32 for p in pm.net_g.parameters())
    assert all(v.dtype == torch.float32 for v in pm.params_ema.values())
    for state in pm.optimizer.state.values():
        assert state['exp_avg'].dtype == torch.float32


TINY_D = {'type': 'VQGANDiscriminator', 'nc': 3, 'ndf': 8, 'n_layers': 2}
STAGE1 = {'model_type': 'VQGANModel', 'network_g': dict(TINY_VQGAN),
          'network_d': TINY_D}


@pytest.mark.parametrize('change,kind', [
    pytest.param({'train': {'remat': True}}, 'remat', id='change0-remat'),
    pytest.param({'datasets': {'val': {'name': 'v'}}}, 'validation',
                 id='change1-validation'),
    pytest.param(STAGE1, 'stage1', id='change2-VQGANModel'),
    pytest.param(dict(STAGE1, network_g=dict(TINY_VQGAN, quantizer='gumbel')),
                 'stage1', id='change3-gumbel'),
])
def test_unported_options_raise(tmp_path, change, kind):
    """Options that raised NotImplementedError until they were ported
    now build and take a step: remat (every ResBlock of net_g and of the
    frozen HQ VQGAN rematerializes), a validation dataset, stage I
    (VQGANModel) and the Gumbel quantizer."""
    from codeformer_tpu_torch.nn.blocks import ResBlock
    opt = _opt(tmp_path)
    for k, v in change.items():
        if k == 'train':
            opt['train'].update(v)
        else:
            opt[k] = v
    if kind != 'stage1':
        pm = _port(opt)
        assert type(pm).__name__ == 'CodeFormerIdxModel'
        blocks = [m for net in (pm.net_g, pm.hq_vqgan)
                  for m in net.modules() if isinstance(m, ResBlock)]
        assert blocks and all(m.remat == (kind == 'remat') for m in blocks)
        pm.feed_data(_batch(9))
        pm.optimize_parameters(1)
        assert np.isfinite(pm.log_dict['l_g_total']) and pm.step == 1
        return
    opt['train']['optim_d'] = dict(opt['train']['optim_g'])
    pm = _port(opt)
    assert type(pm).__name__ == 'VQGANModel'
    assert pm.gumbel == (change['network_g']['quantizer'] == 'gumbel')
    pm.feed_data({'gt': _batch(9)['gt']})
    pm.optimize_parameters(1)
    assert np.isfinite(pm.log_dict['l_g_total']) and pm.step == 1


def test_mixed_precision_rejects_unknown_value(tmp_path):
    with pytest.raises(ValueError, match='mixed_precision'):
        _port(dict(_opt(tmp_path), mixed_precision='fp16'))


def test_unknown_train_key_warns(tmp_path):
    records = []

    class _Catch(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger('codeformer_tpu_torch')
    handler = _Catch(level=logging.WARNING)
    logger.addHandler(handler)
    try:
        _port(_opt(tmp_path, definitely_not_a_knob=1))
    finally:
        logger.removeHandler(handler)
    assert any('definitely_not_a_knob' in m for m in records)


@pytest.mark.parametrize('device', [None, 'cuda', 'cuda:0'])
def test_trainer_never_falls_back_to_the_cpu(tmp_path, monkeypatch, device):
    """The device comes from the options ('cuda' when unset); asking for
    CUDA where there is none raises instead of training on the host."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    opt = _opt(tmp_path)
    if device is None:
        del opt['device']
    else:
        opt['device'] = device
    with pytest.raises(RuntimeError, match='no CUDA device'):
        _port(opt)


def _tiny_yml(tmp_path, device='cpu'):
    """Four seeded 64x64 images on disk and a tiny stage-II yml that
    trains on them for 2 iterations; returns the yml's path."""
    import cv2
    import yaml
    root = tmp_path / 'ffhq64'
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        cv2.imwrite(str(root / f'{i:05d}.png'),
                    rng.uniform(0, 255, (64, 64, 3)).astype(np.uint8))
    opt = {
        'name': 'port_stage2_tiny', 'model_type': 'CodeFormerIdxModel',
        'manual_seed': 0,
        'datasets': {'train': {
            'name': 'tiny', 'type': 'FFHQBlindDataset',
            'dataroot_gt': str(root), 'io_backend': {'type': 'disk'},
            'in_size': 64, 'gt_size': 64, 'use_hflip': True,
            'use_corrupt': True, 'blur_kernel_size': 7,
            'kernel_list': ['iso', 'aniso'], 'kernel_prob': [0.5, 0.5],
            'blur_sigma': [1, 5], 'downsample_range': [2, 8],
            'noise_range': [0, 10], 'jpeg_range': [60, 90],
            'batch_size_per_gpu': 2, 'num_worker_per_gpu': 1,
            'dataset_enlarge_ratio': 1}},
        'network_g': dict(TINY_CF), 'network_vqgan': dict(TINY_VQGAN),
        'path': {'resume_state': None},
        'train': {'total_iter': 2, 'warmup_iter': -1, 'ema_decay': 0.995,
                  'optim_g': {'type': 'Adam', 'lr': 1e-4, 'weight_decay': 0,
                              'betas': [0.9, 0.99]},
                  'scheduler': {'type': 'MultiStepLR',
                                'milestones': [400000, 450000],
                                'gamma': 0.5}},
        'logger': {'print_freq': 1, 'save_checkpoint_freq': 2}}
    if device:
        opt['device'] = device
    yml = tmp_path / 'tiny.yml'
    yml.write_text(yaml.safe_dump(opt))
    return yml


def _stage_yml(tmp_path, stage):
    """The tiny yml of _tiny_yml turned into a stage-I (VQGANModel, clean
    images, LPIPS on seeded VGG16/lin files under tmp_path) or stage-III
    (CodeFormerJointModel, the joint dataset) config."""
    import yaml
    from test_torch_stage1 import _write_vgg
    yml = _tiny_yml(tmp_path)
    opt = yaml.safe_load(yml.read_text())
    ds = opt['datasets']['train']
    t = opt['train']
    t['optim_d'] = dict(t['optim_g'])
    t.update(pixel_opt={'type': 'L1Loss', 'loss_weight': 1.0},
             gan_opt={'type': 'GANLoss', 'gan_type': 'hinge',
                      'loss_weight': 1.0},
             net_g_start_iter=0, net_d_iters=1, net_d_start_iter=1)
    opt['network_d'] = dict(TINY_D)
    if stage == 1:
        opt.update(name='port_stage1_tiny', model_type='VQGANModel',
                   network_g=dict(TINY_VQGAN))
        del opt['network_vqgan']
        ds['use_corrupt'] = False
        _write_vgg(tmp_path)
        t['perceptual_opt'] = {'type': 'LPIPSLoss', 'loss_weight': 1.0,
                               'use_input_norm': True, 'range_norm': True}
    else:
        opt.update(name='port_stage3_tiny',
                   model_type='CodeFormerJointModel')
        ds.update(type='FFHQBlindJointDataset', blur_sigma_large=[1, 15],
                  downsample_range_large=[4, 16], noise_range_large=[0, 20],
                  jpeg_range_large=[30, 80])
        t.update(use_hq_feat_loss=True, cross_entropy_loss=True,
                 entropy_loss_weight=0.5, scale_adaptive_gan_weight=0.1)
    yml.write_text(yaml.safe_dump(opt))
    return yml


@pytest.mark.parametrize('stage', [1, 3])
def test_train_pipeline_gan_stages_two_iterations(tmp_path, monkeypatch,
                                                  stage):
    """python -m codeformer_tpu_torch.train.train -opt <tiny stage-I or
    stage-III yml>, in process: the port's datasets feed VQGANModel or
    CodeFormerJointModel for 2 iterations (the first before
    net_d_start_iter); net_g, net_d and the states are written."""
    from codeformer_tpu_torch.train.train import train_pipeline
    monkeypatch.chdir(tmp_path)          # LPIPS reads weights/vgg/ here
    yml = _stage_yml(tmp_path, stage)
    model = train_pipeline(str(tmp_path), ['-opt', str(yml)])
    assert type(model).__name__ == ('VQGANModel' if stage == 1
                                    else 'CodeFormerJointModel')
    assert (model.step, model.step_d) == (2, 1)
    assert 'd_weight' in model.log_dict
    assert all(np.isfinite(v) for v in model.log_dict.values())
    exp = tmp_path / 'experiments' / f'port_stage{stage}_tiny'
    for f in ('models/net_g_2.pth', 'models/net_d_2.pth',
              'models/net_d_latest.pth', 'training_states/2.state'):
        assert (exp / f).exists(), f


@pytest.mark.parametrize('yml,model_type', [
    ('VQGAN_512_ds32_nearest_stage1.yml', 'VQGANModel'),
    ('CodeFormer_stage3.yml', 'CodeFormerJointModel'),
    ('CodeFormer_inpainting.yml', 'CodeFormerModel'),
])
def test_build_model_takes_the_shipped_gan_ymls(tmp_path, monkeypatch, yml,
                                                model_type):
    """The shipped stage-I, stage-III and inpainting ymls, parsed by the
    port's options parser, build their trainers with every train: key
    read (none IGNORED). Widths are cut to the tiny configs here, the
    pretrained paths (files not in the repository) cleared, and LPIPS
    reads seeded VGG16/lin files."""
    from test_torch_stage1 import _write_vgg

    from codeformer_tpu_torch.utils.options import parse
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    opt = parse(osp.join(root, 'options', yml), str(tmp_path),
                is_train=True)
    assert opt['model_type'] == model_type
    _write_vgg(tmp_path)
    monkeypatch.chdir(tmp_path)
    opt['device'] = 'cpu'
    opt['path'] = {k: None for k in opt['path']} | {
        'models': str(tmp_path / 'models'),
        'training_states': str(tmp_path / 'states')}
    if model_type == 'VQGANModel':
        opt['network_g'] = dict(opt['network_g'], img_size=64, nf=32,
                                ch_mult=[1, 2, 4], codebook_size=32,
                                emb_dim=16)
    else:
        opt['network_g'] = dict(TINY_CF, codebook_size=opt['network_g'][
            'codebook_size'], connect_list=['32', '64'])
        opt['network_vqgan'] = dict(TINY_VQGAN, codebook_size=opt[
            'network_vqgan']['codebook_size'])
        opt['datasets']['train']['in_size'] = 64
    opt['network_d'] = dict(opt['network_d'], ndf=8, n_layers=2)
    records = []

    class _Catch(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    handler = _Catch(level=logging.WARNING)
    logging.getLogger('codeformer_tpu_torch').addHandler(handler)
    try:
        pm = _port(opt)
    finally:
        logging.getLogger('codeformer_tpu_torch').removeHandler(handler)
    assert type(pm).__name__ == model_type
    assert not any('IGNORED' in m for m in records), records
    assert pm.cri_perceptual is not None and not pm.cri_perceptual.degraded
    assert pm.compute_dtype == torch.float32 and pm.device.type == 'cpu'


@pytest.mark.parametrize('yml', [
    'CodeFormer_stage2.yml', 'CodeFormer_colorization.yml',
    'VQGAN_512_ds32_nearest_stage1.yml', 'CodeFormer_stage3.yml',
    'CodeFormer_inpainting.yml'])
def test_shipped_ymls_build_with_remat_and_a_val_set(tmp_path, monkeypatch,
                                                     yml):
    """Each shipped yml with its commented `remat: true` set and a `val_1`
    PairedImageDataset block builds its trainer (both raised
    NotImplementedError before they were ported): every ResBlock of
    net_g rematerializes, the discriminator has no such option, and a
    validation pass over one seeded pair reports the yml's metrics.
    Widths cut to the tiny configs, pretrained paths cleared, LPIPS on
    seeded VGG16/lin files."""
    import cv2
    from test_torch_stage1 import _write_vgg

    from codeformer_tpu_torch.nn.blocks import ResBlock
    from codeformer_tpu_torch.utils.options import parse
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    opt = parse(osp.join(root, 'options', yml), str(tmp_path), is_train=True)
    _write_vgg(tmp_path)
    monkeypatch.chdir(tmp_path)
    opt['device'] = 'cpu'
    opt['train']['remat'] = True
    opt['path'] = {k: None for k in opt['path']} | {
        'models': str(tmp_path / 'models'),
        'training_states': str(tmp_path / 'states'),
        'visualization': str(tmp_path / 'vis')}
    for sub in ('lq', 'gt'):
        (tmp_path / sub).mkdir()
        cv2.imwrite(str(tmp_path / sub / 'p.png'), np.random.default_rng(
            len(sub)).uniform(0, 255, (64, 64, 3)).astype(np.uint8))
    opt['datasets']['val_1'] = {
        'name': 'pairs', 'type': 'PairedImageDataset',
        'dataroot_lq': str(tmp_path / 'lq'),
        'dataroot_gt': str(tmp_path / 'gt')}
    if opt['model_type'] == 'VQGANModel':
        opt['network_g'] = dict(opt['network_g'], img_size=64, nf=32,
                                ch_mult=[1, 2, 4], codebook_size=32,
                                emb_dim=16)
    else:
        opt['network_g'] = dict(TINY_CF, codebook_size=opt['network_g'][
            'codebook_size'], connect_list=['32', '64'],
            fix_modules=opt['network_g'].get('fix_modules',
                                             ['quantize', 'generator']))
        opt['network_vqgan'] = dict(TINY_VQGAN, codebook_size=opt[
            'network_vqgan']['codebook_size'])
    if 'network_d' in opt:
        opt['network_d'] = dict(opt['network_d'], ndf=8, n_layers=2)
    pm = _port(opt)
    assert pm.remat
    blocks = [m for m in pm.net_g.modules() if isinstance(m, ResBlock)]
    assert blocks and all(m.remat for m in blocks)
    from codeformer_tpu_torch.data import build_dataset
    from codeformer_tpu_torch.data.loader import build_dataloader
    val_loader = build_dataloader(build_dataset(opt['datasets']['val_1']),
                                  opt['datasets']['val_1'], is_train=False)
    res = pm.validation(val_loader, current_iter=1)
    assert set(res) == set(opt['val']['metrics'])
    assert all(np.isfinite(v) for v in res.values())


def _with_val_and_tb(tmp_path, yml):
    """The tiny yml with a paired val set of two seeded 64x64 pairs under
    tmp_path, validation every iteration (PSNR and SSIM, images saved)
    and the TensorBoard logger on."""
    import cv2
    import yaml
    rng = np.random.default_rng(1)
    for sub in ('val_lq', 'val_gt'):
        (tmp_path / sub).mkdir()
        for i in range(2):
            cv2.imwrite(str(tmp_path / sub / f'v{i}.png'),
                        rng.uniform(0, 255, (64, 64, 3)).astype(np.uint8))
    opt = yaml.safe_load(yml.read_text())
    opt['datasets']['val'] = {
        'name': 'tiny_val', 'type': 'PairedImageDataset',
        'dataroot_lq': str(tmp_path / 'val_lq'),
        'dataroot_gt': str(tmp_path / 'val_gt'),
        'io_backend': {'type': 'disk'}}
    opt['val'] = {'val_freq': 1, 'save_img': True, 'metrics': {
        'psnr': {'type': 'calculate_psnr', 'crop_border': 4,
                 'test_y_channel': False},
        'ssim': {'type': 'calculate_ssim', 'crop_border': 4,
                 'test_y_channel': True}}}
    opt['logger']['use_tb_logger'] = True
    yml.write_text(yaml.safe_dump(opt))
    return yml


def test_train_pipeline_two_iterations(tmp_path):
    """python -m codeformer_tpu_torch.train.train -opt <tiny yml>, in
    process: the port's own FFHQ dataset and loader feed the trainer for
    2 iterations on the yml's `device: cpu`; checkpoints written; the
    paired val set validated after every iteration (PSNR/SSIM, images
    saved); the iteration message in the reference format; TensorBoard
    scalars under losses/ and metrics/; then a resume from iteration 2
    to 3 that validates again."""
    import re

    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    from codeformer_tpu_torch.train.train import train_pipeline
    yml = _with_val_and_tb(tmp_path, _tiny_yml(tmp_path))
    records = []

    class _Catch(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    handler = _Catch(level=logging.INFO)
    logging.getLogger('codeformer_tpu_torch').addHandler(handler)
    try:
        model = train_pipeline(str(tmp_path), ['-opt', str(yml)])
        assert model.device == torch.device('cpu')
        assert model.step == 2
        assert all(np.isfinite(v) for v in model.log_dict.values())
        exp = tmp_path / 'experiments' / 'port_stage2_tiny'
        for f in ('models/net_g_2.pth', 'models/net_g_latest.pth',
                  'training_states/2.state', 'training_states/latest.state',
                  'visualization/v0/v0_1.png', 'visualization/v1/v1_2.png'):
            assert (exp / f).exists(), f
        model = train_pipeline(str(tmp_path), [
            '-opt', str(yml), '--force_yml',
            f'path:resume_state={exp / "training_states" / "2.state"}',
            'train:total_iter=3'])
        assert model.step == 3
        assert (exp / 'visualization' / 'v0' / 'v0_3.png').exists()
    finally:
        logging.getLogger('codeformer_tpu_torch').removeHandler(handler)
    msg = re.compile(
        r'^\[port_\.\.\]\[epoch:  0, iter: {7}(\d), lr:\(1\.000e-04\)\] '
        r'\[eta: \d+:\d\d:\d\d, time \(data\): \d+\.\d{3} \(\d+\.\d{3}\)\] '
        r'l_feat_encoder: \S+e[-+]\d\d cross_entropy_loss: \S+ '
        r'l_g_total: \S+ $')
    iters = [int(m.group(1)) for m in map(msg.match, records) if m]
    assert iters == [1, 2, 3], records
    vals = [r for r in records if r.startswith('Validation ')]
    assert len(vals) == 6 and vals[0].startswith('Validation psnr: ')
    acc = EventAccumulator(str(exp / 'tb_logger'))
    acc.Reload()
    tags = set(acc.Tags()['scalars'])
    assert {'losses/l_feat_encoder', 'losses/l_g_total',
            'cross_entropy_loss', 'metrics/psnr', 'metrics/ssim'} <= tags
    assert [e.step for e in acc.Scalars('metrics/psnr')] == [1, 2, 3]
    assert [e.step for e in acc.Scalars('losses/l_g_total')] == [1, 2, 3]


# ----------------------------------------------- losses, schedules, optim
def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize('name', ['l1_loss', 'mse_loss', 'charbonnier_loss'])
@pytest.mark.parametrize('reduction,weighted', [('mean', False),
                                                ('sum', True),
                                                ('mean', True)])
def test_pixel_losses_match_jax(name, reduction, weighted):
    a, b = _pair(1, (2, 8, 8, 3))
    w = np.random.default_rng(2).uniform(size=a.shape).astype(np.float32) \
        if weighted else None
    # a bf16 prediction: both sides cast it to fp32 at entry
    want = getattr(jl, name)(jnp.asarray(a).astype(jnp.bfloat16),
                             jnp.asarray(b),
                             None if w is None else jnp.asarray(w),
                             reduction, loss_weight=0.7)
    got = getattr(pl, name)(torch.from_numpy(a).to(torch.bfloat16),
                            torch.from_numpy(b),
                            None if w is None else torch.from_numpy(w),
                            reduction, loss_weight=0.7)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 3, (2, 16, 32)).astype(np.float32)
    labels = rng.integers(0, 32, (2, 16))
    want = jl.cross_entropy_loss(jnp.asarray(logits).astype(jnp.bfloat16),
                                 jnp.asarray(labels), loss_weight=0.5)
    got = pl.cross_entropy_loss(torch.from_numpy(logits).to(torch.bfloat16),
                                torch.from_numpy(labels), loss_weight=0.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


SCHEDULES = {
    'constant': {},
    'multistep': {'scheduler': {'type': 'MultiStepLR',
                                'milestones': [3, 7], 'gamma': 0.5}},
    'multistep_restart': {'scheduler': {
        'type': 'MultiStepRestartLR', 'milestones': [2, 9], 'gamma': 0.5,
        'restarts': [5, 10], 'restart_weights': [0.5, 0.25]}},
    'cosine_restart': {'scheduler': {
        'type': 'CosineAnnealingRestartLR', 'periods': [4, 6],
        'restart_weights': [1, 0.5], 'eta_min': 1e-5}},
}


@pytest.mark.parametrize('warmup', [-1, 4])
@pytest.mark.parametrize('kind', sorted(SCHEDULES))
def test_schedules_match_jax(kind, warmup):
    train_opt = dict(SCHEDULES[kind], warmup_iter=warmup)
    jf = js.build_schedule(train_opt, 2e-4)
    pf = ps.build_schedule(train_opt, 2e-4)
    for step in range(16):
        np.testing.assert_allclose(pf(step), float(jf(jnp.int32(step))),
                                   rtol=1e-6, err_msg=f'step {step}')


def test_optimizer_is_the_optax_adamw_chain():
    """Three steps of build_optimizer (torch AdamW) against the JAX
    package's optax chain with weight decay and a schedule, the lr set
    from schedule(step) before each step with the 0-based step optax's
    scale_by_learning_rate sees. torch.optim.Adam(weight_decay=...) is
    L2, not decoupled decay: it must NOT match."""
    from codeformer_tpu.train.optimizers import build_optimizer as jax_opt
    from codeformer_tpu_torch.train.optimizers import build_optimizer
    cfg = {'type': 'Adam', 'lr': 1e-2, 'weight_decay': 0.1,
           'betas': [0.9, 0.99]}
    train_opt = {'scheduler': {'type': 'MultiStepLR', 'milestones': [1],
                               'gamma': 0.5}, 'warmup_iter': -1}
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) for _ in range(3)]

    jsched = js.build_schedule(train_opt, cfg['lr'])
    tx = jax_opt(cfg, jsched)
    pj = jnp.asarray(p0)
    state = tx.init(pj)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)

    def run(make):
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = make([p])
        sched = ps.build_schedule(train_opt, cfg['lr'])
        for step, g in enumerate(grads):
            p.grad = torch.from_numpy(g)
            for group in opt.param_groups:
                group['lr'] = sched(step)
            opt.step()
        return p.detach().numpy()

    got = run(lambda ps_: build_optimizer(cfg, ps_))
    np.testing.assert_allclose(got, np.asarray(pj), rtol=1e-5, atol=1e-7)
    l2 = run(lambda ps_: torch.optim.Adam(ps_, lr=cfg['lr'],
                                          betas=(0.9, 0.99), eps=1e-8,
                                          weight_decay=0.1))
    assert np.abs(l2 - np.asarray(pj)).max() > 1e-4
    with pytest.raises(NotImplementedError, match='Adam only'):
        build_optimizer({'type': 'SGD', 'lr': 1.0}, [])


_ENTRY = r'''
import sys
from codeformer_tpu_torch.train.train import train_pipeline
model = train_pipeline(sys.argv[1], ['-opt', sys.argv[2],
                                     '--force_yml', 'device=cpu'])
print(model.step, model.device)
print(sorted({m.split('.')[0] for m in sys.modules}
             & {'jax', 'flax', 'optax', 'codeformer_tpu'}))
'''


def test_train_entry_point_uses_only_the_port(tmp_path):
    """The entry point in a fresh process on a yml without `device:`
    (--force_yml device=cpu): the port's own options parser, dataset and loader,
    and nothing of the JAX package or of JAX is imported."""
    import os
    import subprocess
    import sys
    yml = _tiny_yml(tmp_path, device=None)
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONSTARTUP'}
    out = subprocess.run([sys.executable, '-c', _ENTRY, str(tmp_path),
                          str(yml)], cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    step_line, loaded = out.stdout.strip().splitlines()[-2:]
    assert step_line == '2 cpu'
    assert loaded == '[]', loaded
    assert (tmp_path / 'experiments' / 'port_stage2_tiny' / 'models'
            / 'net_g_latest.pth').exists()


def test_train_pipeline_resume_starts_the_loader_at_its_epoch(tmp_path):
    """A resumed train_pipeline hands the saved epoch to the loader, so
    its first batch is the first of that epoch's shuffle (the reference's
    loop, basicsr/train.py:171-210), not epoch 0's again."""
    from unittest import mock

    from codeformer_tpu_torch.data import loader as ploader
    from codeformer_tpu_torch.train import trainers
    from codeformer_tpu_torch.train.train import train_pipeline
    yml = _tiny_yml(tmp_path)
    train_pipeline(str(tmp_path), ['-opt', str(yml)])
    state = tmp_path / 'experiments' / 'port_stage2_tiny' / \
        'training_states' / '2.state'
    blob = torch.load(state, weights_only=True)
    blob['epoch'] = 3                       # as if saved in epoch 3
    torch.save(blob, state)
    starts, fed = [], []
    build = ploader.build_dataloader
    feed = trainers.CodeFormerIdxModel.feed_data

    def spy_build(*args, **kw):
        starts.append(kw.get('start_epoch', 0))
        return build(*args, **kw)

    def spy_feed(self, data):
        fed.append(list(data['gt_path']))
        return feed(self, data)
    with mock.patch.object(ploader, 'build_dataloader', spy_build), \
            mock.patch.object(trainers.CodeFormerIdxModel, 'feed_data',
                              spy_feed):
        model = train_pipeline(str(tmp_path), [
            '-opt', str(yml), '--force_yml', f'path:resume_state={state}',
            'train:total_iter=3'])
    assert starts == [3] and model.step == 3
    sampler = ploader.EnlargedSampler(4)
    sampler.set_epoch(3)
    root = tmp_path / 'ffhq64'
    want = [str(root / f'{i:05d}.png') for i in list(sampler)[:2]]
    assert fed == [want]

"""SRModel in the port against the JAX package's on JAX's sr_smoke
options (tests/test_arch_util.py: RRDBNet x1, Adam, MultiStepLR, L1),
fp32, two steps side by side from the same params on the same batches;
the port re-synced to JAX's state (params, EMA, Adam) before each step,
as the stage tests do.

Tolerances, those of the stage tests: losses 1e-5 relative; gradients
1e-4 relative RMS (one vector and per tensor, floor 1e-4 of the RMS of
all); params and the EMA after each step 1e-4 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402

from test_torch_stage1 import (_adam_from_optax, _grad_capture,  # noqa: E402
                               _rel, check_grads)
from codeformer_tpu_torch.utils.convert import flax_to_state_dict  # noqa: E402

torch.set_num_threads(2)
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4


def sr_opt(tmp_path):
    return {
        'name': 'sr_smoke', 'model_type': 'SRModel', 'is_train': True,
        'num_devices': 1, 'device': 'cpu', 'manual_seed': 0,
        'datasets': {'train': {'gt_size': 32}},
        'network_g': {'type': 'RRDBNet', 'num_in_ch': 3, 'num_out_ch': 3,
                      'scale': 1, 'num_feat': 16, 'num_block': 1,
                      'num_grow_ch': 8},
        'path': {'models': str(tmp_path / 'm'),
                 'training_states': str(tmp_path / 's')},
        'train': {
            'total_iter': 2, 'ema_decay': 0.99,
            'optim_g': {'type': 'Adam', 'lr': 1e-4, 'betas': [0.9, 0.99]},
            'scheduler': {'type': 'MultiStepLR', 'milestones': [100],
                          'gamma': 0.5},
            'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0}}}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {'lq': rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
            'gt': rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
            'lq_path': ['a.png', 'b.png']}


def _sync(pm, jm):
    st = jax.tree.map(np.asarray, jm.state)
    pm.net_g.load_state_dict(flax_to_state_dict({'params': st.params_g}))
    ema = flax_to_state_dict({'params': st.params_g_ema})
    for k, v in pm.params_ema.items():
        v.copy_(ema[k])
    adam = st.opt_g[1][0]
    _adam_from_optax(pm.optimizer, dict(pm.net_g.named_parameters()), adam)
    pm.step = int(np.asarray(adam.count))


@pytest.fixture(scope='module')
def sr_runs(tmp_path_factory):
    from codeformer_tpu.train.trainers import SRModel as JaxSRModel
    from codeformer_tpu.train.trainers import build_model as jax_build
    from codeformer_tpu_torch.train.trainers import SRModel, build_model
    opt = sr_opt(tmp_path_factory.mktemp('sr'))
    jm = jax_build(opt)
    assert isinstance(jm, JaxSRModel)
    jm.opt_g_tx = _grad_capture(jm.opt_g_tx)
    jm.state = jm.state._replace(opt_g=jm.opt_g_tx.init(jm.state.params_g))
    jm._step = jm._jit_step(jm._make_step())
    pm = build_model(opt)
    assert isinstance(pm, SRModel)
    out = {'port': pm, 'steps': []}
    for it in (1, 2):
        _sync(pm, jm)
        batch = _batch(it)
        jm.feed_data(batch)
        jm.optimize_parameters(it)
        pm.feed_data(batch)
        pm.optimize_parameters(it)
        st = jax.tree.map(np.asarray, jm.state)
        out['steps'].append({
            'log_j': dict(jm.log_dict), 'log_p': dict(pm.log_dict),
            'grads_j': flax_to_state_dict({'params': st.opt_g[0]}),
            'grads_p': {n: p.grad.clone()
                        for n, p in pm.net_g.named_parameters()},
            'params_j': flax_to_state_dict({'params': st.params_g}),
            'ema_j': flax_to_state_dict({'params': st.params_g_ema}),
            'params_p': {k: v.clone()
                         for k, v in pm.net_g.state_dict().items()},
            'ema_p': {k: v.clone() for k, v in pm.params_ema.items()}})
    return out


def test_srmodel_losses_match_jax(sr_runs):
    for s in sr_runs['steps']:
        assert set(s['log_p']) == set(s['log_j']) == {'l_pix', 'l_total'}
        for k, v in s['log_p'].items():
            np.testing.assert_allclose(v, s['log_j'][k], rtol=LOSS_RTOL)


def test_srmodel_grads_params_and_ema_match_jax(sr_runs):
    for s in sr_runs['steps']:
        check_grads(s['grads_p'], s['grads_j'], min_tensors=10)
        for kp, kj in (('params_p', 'params_j'), ('ema_p', 'ema_j')):
            names = sorted(s[kj])
            assert _rel(torch.cat([s[kp][n].reshape(-1) for n in names]),
                        torch.cat([s[kj][n].reshape(-1) for n in names])) \
                <= PARAM_RTOL, kp
    pm = sr_runs['port']
    assert pm.step == 2


def test_srmodel_validation_and_test_use_the_ema(tmp_path, sr_runs):
    """test() runs the EMA weights (ema_decay 0.99 > 0) without copying
    them into net_g; validation reports PSNR/SSIM of every image and
    saves them under visualization/ when asked."""
    pm = sr_runs['port']
    pm.opt['val'] = {'metrics': {
        'psnr': {'type': 'calculate_psnr', 'crop_border': 2},
        'ssim': {'type': 'calculate_ssim', 'crop_border': 0}}}
    pm.opt['path']['visualization'] = str(tmp_path / 'vis')
    batch = _batch(3)
    lq = torch.from_numpy(batch['lq']).permute(0, 3, 1, 2)
    before = {k: v.clone() for k, v in pm.net_g.state_dict().items()}
    got = pm.test(lq)
    net = type(pm.net_g)(**{k: v for k, v in pm.opt['network_g'].items()
                            if k != 'type'})
    net.load_state_dict(pm.params_ema)
    with torch.no_grad():
        want = net(lq)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert pm.net_g.training
    for k, v in pm.net_g.state_dict().items():
        assert torch.equal(v, before[k]), k
    res = pm.validation([batch], current_iter=7, save_img=True)
    assert set(res) == {'psnr', 'ssim'} and all(np.isfinite(list(
        res.values())))
    assert (tmp_path / 'vis' / 'a' / 'a_7.png').exists()
    assert (tmp_path / 'vis' / 'b' / 'b_7.png').exists()

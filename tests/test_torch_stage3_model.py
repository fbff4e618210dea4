"""Stage III's single-degradation trainer, CodeFormerModel (the
inpainting config's), in the port against the JAX package's, fp32, with
the helpers and tolerances of test_torch_stage1.py: fidelity_weight 1
takes the full step on 'in' at that fixed w, fidelity_weight 0 the code
step on 'in' (no image losses, no d step), the code losses on either way.
The SFT branches are tamed as in test_torch_stage3.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
from test_torch_stage1 import (_port_like, check_grads, check_logs,  # noqa: E402
                               check_state, run_side_by_side)
from test_torch_stage3 import (GAN_WEIGHT, cf_fake, stage3_opt,  # noqa: E402
                               tamed_jax)

torch.set_num_threads(2)


def single_batch(seed, n=2):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32)
            for k in ('in', 'gt')}


@pytest.mark.parametrize('fidelity', [1.0, 0.0])
def test_codeformer_model_step_matches_jax(tmp_path, fidelity):
    opt = stage3_opt(tmp_path, model_type='CodeFormerModel',
                     fidelity_weight=fidelity, net_d_iters=1)
    opt['network_g']['fix_modules'] = ['quantize', 'generator',
                                       'transformer']   # still on: always
    jm = tamed_jax(opt)
    pm = _port_like(jm, opt)
    assert pm.code_losses_on and pm.fidelity_weight == fidelity
    r = run_side_by_side(jm, pm, [single_batch(80), single_batch(81)],
                         (1, 2), cf_fake(fidelity))
    check_logs(r, GAN_WEIGHT)
    code_keys = {'l_feat_encoder', 'cross_entropy_loss', 'l_g_total'}
    for log, (sp, sj) in zip(r['logs_p'], zip(r['snap_p'], r['snap_j'])):
        if fidelity > 0:
            assert code_keys | {'l_g_pix', 'd_weight', 'l_g_gan',
                                'l_d_real'} <= set(log)
            assert 0.0 < log['d_weight'] < 0.8
            check_grads(sp['grads_d'], sj['grads_d'], min_tensors=5)
        else:
            assert set(log) == code_keys
        check_grads(sp['grads_g'], sj['grads_g'], min_tensors=10)
        check_state(sp, sj)
    if fidelity == 0:     # no d step ran: net_d as it was built
        for k, v in r['p0']['d'].items():
            assert torch.equal(r['snap_p'][-1]['d'][k], v), k
        assert pm.step_d == 0

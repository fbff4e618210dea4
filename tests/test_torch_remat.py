"""`train: remat: true` in the port (torch.utils.checkpoint on every
ResBlock of the networks and on the perceptual loss as a whole) against
the same step without remat and against the JAX package's remat step
(nn.remat ResBlocks, jax.checkpoint of the perceptual loss), fp32, on the
tiny stage-I and stage-III configs of tests/test_torch_stage1.py and
tests/test_torch_stage3.py.

Tolerances: with and without remat the port computes the same ops on the
same inputs (the recompute repeats the forward), so the gradients agree
to 1e-6 relative RMS, as one vector and per tensor; against JAX those of
the stage tests: losses 1e-5 relative, gradients 1e-4 relative RMS.
"""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from test_torch_stage1 import (_capturing_jax, _gt_batch, _port_like,  # noqa: E402
                               _stage1_opt, _write_vgg, check_grads,
                               check_logs, run_side_by_side,
                               sync_from_jax)
from test_torch_stage3 import (GAN_WEIGHT, cf_fake, joint_batch,  # noqa: E402
                               stage3_opt, tamed_jax)

REMAT_RTOL = 1e-6
STAGE1_ITER = 2                # past net_d_start_iter 1: the d step runs
STAGE3_ITER = 120030           # a full stage-III step


def _grads(pm):
    return {f'{tag}.{n}': p.grad.detach().clone()
            for tag, net in (('g', pm.net_g), ('d', pm.net_d))
            for n, p in net.named_parameters() if p.grad is not None}


def _checkpoints_counted():
    """A context counting torch.utils.checkpoint calls by the blocks and
    by the trainers' perceptual loss."""
    from codeformer_tpu_torch.nn import blocks
    from codeformer_tpu_torch.train import trainers
    counts = {'blocks': 0, 'perceptual': 0}

    def counting(key, fn):
        def wrapper(*args, **kw):
            counts[key] += 1
            return fn(*args, **kw)
        return wrapper
    ctx = mock.patch.multiple(
        blocks, checkpoint=counting('blocks', blocks.checkpoint))
    ctx2 = mock.patch.multiple(
        trainers, checkpoint=counting('perceptual', trainers.checkpoint))
    return counts, ctx, ctx2


@pytest.fixture(scope='module')
def stage1_remat(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('remat1')
    _write_vgg(tmp)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        jm = _capturing_jax(_stage1_opt(tmp, remat=True))
        pm = _port_like(jm, _stage1_opt(tmp, remat=True))
        plain = _port_like(jm, _stage1_opt(tmp))
        return _run(jm, pm, plain, _gt_batch(5), STAGE1_ITER)


@pytest.fixture(scope='module')
def stage3_remat(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('remat3')
    jm = tamed_jax(stage3_opt(tmp, remat=True))
    pm = _port_like(jm, stage3_opt(tmp, remat=True))
    plain = _port_like(jm, stage3_opt(tmp))
    return _run(jm, pm, plain, joint_batch(70), STAGE3_ITER, cf_fake(1.3))


def _run(jm, pm, plain, batch, it, fake_of=None):
    """The JAX remat step and the port's from the same state, side by
    side (held as in the stage tests); then the port without remat from
    that same state on the same batch."""
    from codeformer_tpu_torch.nn.blocks import ResBlock
    assert jm.remat and pm.remat and not plain.remat
    blocks = [m for m in pm.net_g.modules() if isinstance(m, ResBlock)]
    assert blocks and all(m.remat for m in blocks)
    assert not any(m.remat for m in plain.net_g.modules()
                   if isinstance(m, ResBlock))
    sync_from_jax(plain, jm)
    counts, c1, c2 = _checkpoints_counted()
    kw = {} if fake_of is None else {'fake_of': fake_of}
    with c1, c2:
        r = run_side_by_side(jm, pm, [batch], (it,), **kw)
    plain.feed_data(batch)
    plain.optimize_parameters(it)
    r.update(remat=_grads(pm), plain=_grads(plain), counts=counts,
             n_blocks=len(blocks), port=pm)
    return r


def _rel_rms(a, b):
    return float((a - b).pow(2).sum().sqrt()
                 / b.pow(2).sum().sqrt().clamp_min(1e-30))


def _check_against_plain(r):
    assert set(r['remat']) == set(r['plain'])
    names = sorted(r['remat'])
    flat = [torch.cat([r[k][n].reshape(-1) for n in names])
            for k in ('remat', 'plain')]
    assert _rel_rms(*flat) <= REMAT_RTOL
    for n in names:
        scale = float(r['plain'][n].pow(2).mean().sqrt())
        diff = float((r['remat'][n] - r['plain'][n]).pow(2).mean().sqrt())
        assert diff <= REMAT_RTOL * scale + 1e-12, n


def test_stage1_remat_equals_the_step_without(stage1_remat):
    r = stage1_remat
    _check_against_plain(r)
    # every ResBlock of net_g checkpointed in the g forward (the d step
    # and the EMA record nothing), and the LPIPS loss once
    assert r['counts']['blocks'] >= r['n_blocks']
    assert r['counts']['perceptual'] == 1


def test_stage1_remat_matches_jax_remat(stage1_remat):
    r = stage1_remat
    check_logs(r)
    sp, sj = r['snap_p'][0], r['snap_j'][0]
    check_grads(sp['grads_g'], sj['grads_g'], min_tensors=20)
    check_grads(sp['grads_d'], sj['grads_d'], min_tensors=5)


def test_stage3_remat_equals_the_step_without(stage3_remat):
    r = stage3_remat
    _check_against_plain(r)
    # the trainable ResBlocks (encoder, fuse blocks) and the frozen
    # generator's, whose activations the SFT branches' gradients need
    assert r['counts']['blocks'] >= r['n_blocks'] // 2
    assert r['counts']['perceptual'] == 0        # no perceptual_opt


def test_stage3_remat_matches_jax_remat(stage3_remat):
    r = stage3_remat
    check_logs(r, GAN_WEIGHT)
    sp, sj = r['snap_p'][0], r['snap_j'][0]
    check_grads(sp['grads_g'], sj['grads_g'], min_tensors=20)
    check_grads(sp['grads_d'], sj['grads_d'], min_tensors=5)
    assert 0.0 < r['logs_p'][0]['d_weight'] < 0.8


def test_remat_is_a_no_op_where_autograd_does_not_record():
    """No checkpoint under no_grad, on a frozen block, or on the kernels'
    path (the frozen HQ encode): the forward is the textbook one."""
    from codeformer_tpu_torch.nn.blocks import ResBlock
    torch.manual_seed(0)
    blk = ResBlock(32, 64, remat=True)
    blk.use_kernels = False
    x = torch.randn(2, 32, 8, 8)
    counts, c1, c2 = _checkpoints_counted()
    with c1, c2:
        with torch.no_grad():
            y0 = blk(x)
        blk.requires_grad_(False)
        y1 = blk(x)
        assert counts['blocks'] == 0
        blk.requires_grad_(True)
        y2 = blk(x)
        assert counts['blocks'] == 1
    assert torch.equal(y0, y1) and torch.equal(y0, y2.detach())

"""Data parallelism in the port (codeformer_tpu_torch/parallel and the
trainers' reductions) on the CPU: two gloo processes started as torchrun
would (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT; `init_dist`), each
on its half of a batch of 2, against one process on the whole batch --
the semantics of JAX's mesh step (a world-size-n step at per-rank batch B
equals one process at n*B). One stage-II step, and one stage-I step past
net_d_start_iter (the adaptive weight's two anchor probes, the
discriminator's BatchNorm over the global batch).

Tolerance: the two sum in other orders (halves, then the all-reduce), so
d_weight, the losses and the BatchNorm statistics within 1e-5 relative
(vector norm), and the gradients within 2e-5: at random init the
generator's gradients come out of deep cancellations, and its convs
round differently at batch 1 and 2 (a one-process batch-2 step and the
mean of two one-process batch-1 steps with the same d_weight sit 1.0e-5
apart in stage I, measured).

A hang cannot eat the suite's clock: the process group's timeout is 60 s
and the parent joins each child for at most 100 s, then kills it and
fails.
"""
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import torch.multiprocessing as tmp_mp  # noqa: E402

DP_RTOL = 1e-5
GRAD_RTOL = 2e-5
JOIN_S = 100
TINY_VQGAN = {'type': 'VQAutoEncoder', 'img_size': 64, 'nf': 32,
              'ch_mult': [1, 2, 4], 'quantizer': 'nearest',
              'codebook_size': 32, 'emb_dim': 16}
TINY_CF = {'type': 'CodeFormer', 'dim_embd': 32, 'n_head': 4,
           'n_layers': 2, 'codebook_size': 32, 'latent_size': 256,
           'connect_list': ['32', '64'],
           'fix_modules': ['quantize', 'generator'],
           'img_size': 64, 'nf': 32, 'ch_mult': [1, 2, 4], 'emb_dim': 16}
TINY_D = {'type': 'VQGANDiscriminator', 'nc': 3, 'ndf': 8, 'n_layers': 2}
ADAM = {'type': 'Adam', 'lr': 1e-4, 'weight_decay': 0.01,
        'betas': [0.9, 0.99]}


def _options(stage: str, root: str) -> dict:
    opt = {'name': f'dp_{stage}', 'manual_seed': 0, 'is_train': True,
           'device': 'cpu',
           'path': {'models': os.path.join(root, 'models'),
                    'training_states': os.path.join(root, 'states')},
           'train': {'total_iter': 4, 'warmup_iter': -1, 'ema_decay': 0.9,
                     'optim_g': dict(ADAM)}}
    if stage == 'stage2':
        opt.update(model_type='CodeFormerIdxModel',
                   network_g=dict(TINY_CF), network_vqgan=dict(TINY_VQGAN))
        opt['train'].update(use_hq_feat_loss=True, cross_entropy_loss=True)
    else:
        opt.update(model_type='VQGANModel', network_g=dict(TINY_VQGAN),
                   network_d=dict(TINY_D))
        opt['train'].update(
            optim_d=dict(ADAM, betas=[0.5, 0.99]),
            # MSE, not the configs' L1: at random init the L1 gradient
            # sign(out - gt) cancels so deeply that one element whose
            # sign flips between the batch-1 and batch-2 convs' rounding
            # (|out - gt| ~ 4e-6, measured) moves the generator's and
            # encoder's gradients by 2e-3 in either layout
            pixel_opt={'type': 'MSELoss', 'loss_weight': 1.0},
            gan_opt={'type': 'GANLoss', 'gan_type': 'hinge',
                     'loss_weight': 50.0},
            net_g_start_iter=0, net_d_iters=1, net_d_start_iter=0)
    return opt


def _batch(stage: str) -> dict:
    rng = np.random.default_rng(11)
    keys = ('in', 'gt') if stage == 'stage2' else ('gt',)
    return {k: rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
            for k in keys}


def _step(stage: str, rank: int, world: int, root: str) -> dict:
    """One step (iteration 1) of the tiny trainer on this rank's share of
    the batch of 2; the averaged gradients, the log and the
    discriminator's BatchNorm statistics."""
    from codeformer_tpu_torch.train.trainers import build_model
    pm = build_model(_options(stage, root))
    assert pm.data_parallel == (world > 1)
    per = 2 // world
    pm.feed_data({k: v[rank * per:(rank + 1) * per]
                  for k, v in _batch(stage).items()})
    pm.optimize_parameters(1)
    out = {'log': dict(pm.log_dict),
           'g': {n: p.grad.clone() for n, p in pm.net_g.named_parameters()
                 if p.grad is not None}}
    if pm.net_d is not None:
        out['d'] = {n: p.grad.clone()
                    for n, p in pm.net_d.named_parameters()}
        out['bn'] = {k: v.clone() for k, v in pm.net_d.state_dict().items()
                     if 'running' in k}
        out['step_d'] = pm.step_d
    return out


def _child(rank: int, world: int, port: int, root: str) -> None:
    import torch.distributed as dist

    from codeformer_tpu_torch import parallel
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                      MASTER_PORT=str(port))
    assert parallel.init_dist('pytorch', 'cpu', timeout_s=60) == (
        rank, world, rank)
    try:
        assert parallel.backend() == 'gloo'
        for stage in ('stage2', 'stage1'):
            torch.save(_step(stage, rank, world, root),
                       os.path.join(root, f'{stage}_{rank}.pt'))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def dp_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('dp'))
    ctx = tmp_mp.get_context('spawn')
    port = _free_port()
    procs = [ctx.Process(target=_child, args=(r, 2, port, root))
             for r in range(2)]
    for p in procs:
        p.start()
    stalled = []
    for p in procs:
        p.join(JOIN_S)
        if p.is_alive():
            stalled.append(p)
    for p in stalled:
        p.kill()
        p.join(10)
    assert not stalled, f'{len(stalled)} rank(s) stalled past {JOIN_S} s'
    assert [p.exitcode for p in procs] == [0, 0]
    torch.set_num_threads(1)           # as the children
    return {stage: {'ranks': [torch.load(os.path.join(root, f'{stage}_{r}'
                                                      f'.pt'),
                                         weights_only=False)
                              for r in range(2)],
                    'single': _step(stage, 0, 1, root)}
            for stage in ('stage2', 'stage1')}


def _rel(a, b):
    return float((a - b).pow(2).sum().sqrt()
                 / b.pow(2).sum().sqrt().clamp_min(1e-30))


def _check(tensors_a: dict, tensors_b: dict, rtol: float):
    assert set(tensors_a) == set(tensors_b) and tensors_a
    names = sorted(tensors_a)
    flat = [torch.cat([t[n].reshape(-1).float() for n in names])
            for t in (tensors_a, tensors_b)]
    assert _rel(*flat) <= rtol


@pytest.mark.parametrize('stage', ['stage2', 'stage1'])
def test_two_gloo_processes_equal_one_at_twice_the_batch(dp_runs, stage):
    r = dp_runs[stage]
    r0, r1 = r['ranks']
    single = r['single']
    # every rank holds the same averaged gradients and log
    for part in [k for k in ('g', 'd', 'bn') if k in single]:
        for n in r0[part]:
            assert torch.equal(r0[part][n], r1[part][n]), (part, n)
        _check(r0[part], single[part],
               DP_RTOL if part == 'bn' else GRAD_RTOL)
    assert r0['log'] == r1['log']
    assert set(r0['log']) == set(single['log'])
    for k, v in single['log'].items():
        if k == 'perplexity':       # of a rank's codes, not averaged
            continue
        np.testing.assert_allclose(r0['log'][k], v, rtol=DP_RTOL, atol=1e-7,
                                   err_msg=k)
    if stage == 'stage1':
        assert r0['step_d'] == single['step_d'] == 1
        assert 0.0 < single['log']['d_weight'] < 0.8


def test_helpers_are_the_identity_without_a_process_group():
    from codeformer_tpu_torch import parallel
    assert not parallel.initialized()
    assert parallel.get_dist_info() == (0, 1)
    t = torch.arange(4.0)
    parallel.all_reduce_mean([t])
    assert torch.equal(t, torch.arange(4.0))
    assert parallel.all_reduce_sum_autograd(t) is t
    with pytest.raises(ValueError, match='torchrun'):
        parallel.init_dist('slurm', 'cpu')


def test_init_dist_needs_torchrun_environment(monkeypatch):
    from codeformer_tpu_torch import parallel
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
              'MASTER_PORT'):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match='torchrun'):
        parallel.init_dist('pytorch', 'cpu')

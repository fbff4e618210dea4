"""The benchmark's operation and byte counts (benchmark/roofline.py)
against shapes worked out by hand."""
import pytest
import torch

from benchmark import roofline
from benchmark.reference.codeformer import CodeFormer as Ref

RELEASED = dict(dim_embd=512, n_head=8, n_layers=9, codebook_size=1024,
                connect_list=('32', '64', '128', '256'))


def test_k1_cost_by_hand():
    # B=2, 512^2, 64 -> 64 with the identity skip
    pix = 2 * 512 * 512
    flops, nbytes = roofline.k1_cost(2, 512, 64, 64, 'identity', 0)
    assert flops == 2 * pix * 9 * 64 * 64
    assert nbytes == (2 * pix * 64 + 2 * pix * 64 + 2 * 9 * 64 * 64
                      + 8 * 2 * 64 + 4 * 64 + 8 * 2 * 64 + 2 * pix * 64)
    # projected skip 128 -> 64 at 256^2, B=1: the 1x1 product too
    pix = 256 * 256
    flops, nbytes = roofline.k1_cost(1, 256, 64, 64, 'proj', 128)
    assert flops == 2 * pix * 9 * 64 * 64 + 2 * pix * 128 * 64
    assert nbytes == (2 * pix * 128 + 8 * 64 + 4 * 64 + 8 * 64
                      + 2 * 9 * 64 * 64 + 2 * pix * 128 + 2 * 128 * 64)


def test_k2_cost_by_hand():
    flops, nbytes = roofline.k2_cost(16, 512, 64)
    assert flops == 2 * 16 * 256 * 256 * 9 * 64 * 64
    assert nbytes == (2 * 16 * 512 * 512 * 64 + 2 * 16 * 256 * 256 * 64
                      + 2 * 9 * 64 * 64 + 4 * 64)


def test_bound_takes_the_larger():
    assert roofline.bound(989e12, 0) == pytest.approx(1.0)
    assert roofline.bound(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound(989e9, 3.35e12) == pytest.approx(1.0)


def released():
    with torch.device('meta'):
        return Ref(**RELEASED)


def test_released_forward_calls():
    calls = roofline.kernel_calls(released(), 16, 512, 0.5)
    # 32 ResBlocks (14 encoder, 14 generator, 4 fusion) x 2 + the tail
    assert len(calls['k1']) == 65
    assert calls['k1'][0] == (16, 512, 64, 64, 'none', 0)
    assert calls['k1'][1] == (16, 512, 64, 64, 'identity', 0)
    assert calls['k1'][-1] == (16, 512, 64, 3, 'none', 0)
    assert calls['k2'] == [(16, 512, 64), (16, 256, 128), (16, 128, 128),
                           (16, 64, 256), (16, 32, 256)]
    # without fusion the four SFT ResBlocks do not run
    assert len(roofline.kernel_calls(released(), 1, 512, 0.0)['k1']) == 57


def test_released_forward_flops():
    model = released()
    flops = roofline.forward_flops(model, 1, 512, 0.5)
    # 810 GFLOP a face: 784 in convolutions, 26 in matmuls
    assert 809e9 < flops < 811e9
    k = roofline.kernel_calls(model, 1, 512, 0.5)
    conv = sum(roofline.k1_cost(*c)[0] for c in k['k1']) + \
        sum(roofline.k2_cost(*c)[0] for c in k['k2'])
    assert conv < flops
    assert roofline.forward_flops(model, 2, 512, 0.5) == 2 * flops
    assert sum(p.numel() for p in model.parameters()) == 94_112_707

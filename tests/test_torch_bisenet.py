"""The port's BiSeNet face parser against the JAX package's at 128x128 on
the same weights (flax_to_state_dict with like=, BatchNorm statistics
perturbed), with and without return_feat, and the resizes it is built
on: `_up_nearest` against jax.image.resize 'nearest' and
`_up_bilinear_ac` against JAX's align-corners bilinear."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeformer_tpu.models import bisenet as jbisenet
from codeformer_tpu.utils.checkpoint import init_params_fast
from codeformer_tpu_torch.models import bisenet
from codeformer_tpu_torch.utils.convert import flax_to_state_dict
from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY

torch.set_num_threads(2)
# fp32 convs summed in another order through ResNet18 and the heads,
# relative to the largest output of each head: measured 2.4e-6
MODEL_RTOL = 1e-4
# the align-corners bilinear: JAX's linspace weights against torch's
# scale, fp32
RESIZE_ATOL = 1e-5


@pytest.fixture(scope='module')
def pair():
    jmodel = jbisenet.BiSeNet()
    v = jax.tree_util.tree_map(
        np.array, init_params_fast(jmodel, jnp.zeros((1, 64, 64, 3)),
                                   seed=5))
    rng = np.random.default_rng(6)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            v['batch_stats'])[0]:
        leaf[:] = (rng.normal(0, 0.1, leaf.shape) if path[-1].key == 'mean'
                   else rng.uniform(0.5, 1.5, leaf.shape))
    model = bisenet.BiSeNet().eval()
    model.load_state_dict(flax_to_state_dict(v, like=model.state_dict()),
                          strict=True)
    return jmodel, v, model


@pytest.mark.parametrize('return_feat', [False, True])
def test_bisenet_matches_jax(pair, return_feat):
    jmodel, v, model = pair
    x = np.random.default_rng(7).uniform(-1, 1, (2, 128, 128, 3)) \
        .astype(np.float32)
    want = jax.jit(jmodel.apply, static_argnames='return_feat')(
        v, jnp.asarray(x), return_feat=return_feat)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2),
                    return_feat=return_feat)
    assert len(got) == len(want) == (6 if return_feat else 3)
    chans = [19, 19, 19, 256, 64, 64]
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.permute(0, 2, 3, 1).numpy(), np.asarray(w)
        assert g.shape == w.shape == (2, 128, 128, chans[i])
        err = float(np.abs(g - w).max()) / float(np.abs(w).max())
        assert err <= MODEL_RTOL, (i, err)
    # the parse ids a caller takes
    np.testing.assert_array_equal(got[0].argmax(1).numpy(),
                                  np.asarray(jnp.argmax(want[0], -1)))


@pytest.mark.parametrize('src,dst', [((4, 4), (8, 8)), ((5, 3), (8, 8)),
                                     ((8, 8), (5, 7))])
def test_resizes_match_jax(src, dst):
    x = np.random.default_rng(8).normal(size=(2, *src, 3)) \
        .astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    near = bisenet._up_nearest(xt, dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(
        near, np.asarray(jbisenet._up_nearest(jnp.asarray(x), dst)))
    lin = bisenet._up_bilinear_ac(xt, dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(
        lin, np.asarray(jbisenet._up_bilinear_ac(jnp.asarray(x), dst)),
        rtol=0, atol=RESIZE_ATOL)


def test_bisenet_registered_with_the_reference_names():
    assert ARCH_REGISTRY.get('BiSeNet') is bisenet.BiSeNet
    keys = set(bisenet.BiSeNet().state_dict())
    for k in ('cp.resnet.conv1.weight', 'cp.resnet.layer2.0.downsample.0.'
              'weight', 'cp.resnet.layer4.1.bn2.running_var',
              'cp.arm16.conv_atten.weight', 'cp.arm32.bn_atten.bias',
              'cp.conv_avg.conv.weight', 'ffm.convblk.bn.weight',
              'ffm.conv2.weight', 'conv_out16.conv_out.weight'):
        assert k in keys, k

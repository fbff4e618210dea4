"""ResNetArcFace in the port (codeformer_tpu_torch/models/arcface.py)
against the JAX package's, eval mode, fp32, the same weights through
flax_to_state_dict(like=...) and the same seeded numpy faces.

Tolerance: fp32 on both sides, summed in other orders through 17 convs,
the SE gates and a 32768-wide dense layer: the embedding within 1e-4
relative RMS and 1e-3 absolute per element.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from codeformer_tpu.models.arcface import \
    ResNetArcFace as JaxArcFace  # noqa: E402
from codeformer_tpu_torch.models.arcface import ResNetArcFace  # noqa: E402
from codeformer_tpu_torch.utils.convert import flax_to_state_dict  # noqa: E402
from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY  # noqa: E402

torch.set_num_threads(2)


def _jax_variables(seed):
    """Seeded JAX params; BatchNorm statistics and PReLU slopes moved off
    their init values so the test sees them cross."""
    model = JaxArcFace()
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 128, 128, 1)))
    rng = np.random.default_rng(seed)

    def perturb(tree, kind):
        def f(path, leaf):
            name = str(path[-1].key)
            a = np.asarray(leaf)
            if kind == 'stats':
                return (rng.uniform(0.5, 1.5, a.shape) if name == 'var'
                        else rng.normal(0, 0.1, a.shape)).astype(np.float32)
            if name == 'scale' and a.shape == (1,):      # PReLU slopes
                return np.float32(rng.uniform(0.1, 0.4, (1,)))
            if name in ('scale', 'bias') and a.ndim == 1:
                return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
            return a
        return jax.tree_util.tree_map_with_path(f, tree)
    return {'params': perturb(v['params'], 'params'),
            'batch_stats': perturb(v['batch_stats'], 'stats')}


@pytest.mark.parametrize('batch', [1, 3])
def test_arcface_forward_matches_jax(batch):
    variables = _jax_variables(0)
    x = np.random.default_rng(batch).uniform(
        -1, 1, (batch, 128, 128, 1)).astype(np.float32)
    want = np.asarray(JaxArcFace().apply(variables, jnp.asarray(x)))
    model = ResNetArcFace().eval()
    sd = flax_to_state_dict(jax.tree.map(np.asarray, variables),
                            like=model.state_dict())
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (batch, 512)
    rel = np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean())
    assert rel <= 1e-4, rel
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_arcface_names_and_registry():
    """The reference .pth names (layerN.i, se.fc.k, downsample.k, fc5,
    bn5), PReLU slopes as `weight`, registered under its reference name."""
    model = ARCH_REGISTRY.get('ResNetArcFace')()
    assert isinstance(model, ResNetArcFace)
    keys = set(model.state_dict())
    for k in ('conv1.weight', 'bn1.running_var', 'prelu.weight',
              'layer1.0.bn0.weight', 'layer1.0.se.fc.0.weight',
              'layer1.0.se.fc.1.weight', 'layer2.0.downsample.0.weight',
              'layer2.0.downsample.1.running_mean', 'layer4.1.prelu.weight',
              'fc5.weight', 'bn5.num_batches_tracked'):
        assert k in keys, k
    assert 'layer1.0.downsample.0.weight' not in keys
    assert model.fc5.weight.shape == (512, 512 * 8 * 8)
    with pytest.raises(ValueError, match='IRBlock'):
        ResNetArcFace(block='BasicBlock')

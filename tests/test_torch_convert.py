"""The port's parameter names against the JAX package's, both ways.

The port's modules carry the reference `.pth` names, so
torch_state_dict_to_flax(port.state_dict()) must give exactly the JAX
model's parameter tree, and flax_to_state_dict must invert it exactly
(pure transposes and renames: equality, no tolerance).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from codeformer_tpu.models import CodeFormer as JaxCodeFormer  # noqa: E402
from codeformer_tpu.utils.convert import torch_state_dict_to_flax  # noqa: E402
from codeformer_tpu_torch.models import CodeFormer  # noqa: E402
from codeformer_tpu_torch.utils.checkpoint import init_params_fast  # noqa: E402
from codeformer_tpu_torch.utils.convert import (flax_to_state_dict,  # noqa: E402
                                                load_pth)

torch.set_num_threads(2)
TINY = dict(img_size=64, nf=32, ch_mult=(1, 2, 4), codebook_size=64,
            emb_dim=16, dim_embd=64, n_head=4, n_layers=2, latent_size=256,
            connect_list=('32',))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.shape(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope='module')
def port_model():
    return init_params_fast(CodeFormer(**TINY), seed=1)


def test_state_dict_has_jax_param_tree(port_model):
    shapes = jax.eval_shape(lambda: JaxCodeFormer(**TINY).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), 0.5))
    want = _flat(shapes['params'])
    got = _flat(torch_state_dict_to_flax(port_model.state_dict())['params'])
    assert set(got) == set(want)
    assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize('key,shape', [
    ('encoder.blocks.4.norm1.weight', (32,)),
    ('ft_layers.0.self_attn.in_proj_weight', (192, 64)),
    ('ft_layers.1.self_attn.out_proj.weight', (64, 64)),
    ('idx_pred_layer.0.weight', (64,)),
    ('idx_pred_layer.1.weight', (64, 64)),
    ('fuse_convs_dict.32.scale.0.weight', (64, 64, 3, 3)),
    ('fuse_convs_dict.32.encode_enc.conv_out.weight', (64, 128, 1, 1)),
    ('quantize.embedding.weight', (64, 16)),
    ('position_emb', (256, 64)),
])
def test_reference_names(port_model, key, shape):
    sd = port_model.state_dict()
    assert tuple(sd[key].shape) == shape
    assert 'idx_pred_layer.1.bias' not in sd      # biasless logits head


def test_flax_to_state_dict_inverts_exactly(port_model):
    sd = port_model.state_dict()
    back = flax_to_state_dict(torch_state_dict_to_flax(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.float32
        assert torch.equal(back[k], v), k
    port2 = CodeFormer(**TINY)
    port2.load_state_dict(back)


def test_flax_to_state_dict_from_jax_params():
    """A JAX-initialised tree -> port state dict -> JAX tree, exactly."""
    v = JaxCodeFormer(**TINY).init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 64, 64, 3)), 0.5)
    sd = flax_to_state_dict(v)
    CodeFormer(**TINY).load_state_dict(sd)
    back = torch_state_dict_to_flax(sd)['params']
    for (p, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(v['params'])[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(p))


def test_batch_stats_round_trip():
    sd = {'main.3.weight': torch.ones(4), 'main.3.bias': torch.zeros(4),
          'main.3.running_mean': torch.arange(4.0),
          'main.3.running_var': torch.full((4,), 2.0)}
    back = flax_to_state_dict(torch_state_dict_to_flax(sd))
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k])


@pytest.mark.parametrize('wrap', ['params_ema', 'params', None])
def test_load_pth_prefers_ema_and_strips_module(tmp_path, wrap):
    ema = {'module.position_emb': torch.ones(2, 3)}
    raw = {'module.position_emb': torch.zeros(2, 3)}
    if wrap == 'params_ema':
        obj = {'params': raw, 'params_ema': ema}
        want = torch.ones(2, 3)
    elif wrap == 'params':
        obj = {'params': raw}
        want = torch.zeros(2, 3)
    else:
        obj = raw
        want = torch.zeros(2, 3)
    path = tmp_path / 'w.pth'
    torch.save(obj, path)
    sd = load_pth(str(path))
    assert list(sd) == ['position_emb']
    assert torch.equal(sd['position_emb'], want)

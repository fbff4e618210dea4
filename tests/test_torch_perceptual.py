"""The port's VGG feature extractor and perceptual losses
(codeformer_tpu_torch/models/vgg.py, train/perceptual.py) against the JAX
package's, on seeded torchvision-format VGG state dicts and lpips heads
written under a temporary working directory (no weights ship with the
repository), fp32.

Tolerances: taps within 1e-5 relative (max |diff| over max |ref|, the
two sum the 3x3 products in other orders); the loss values within 1e-5
relative; the input gradients within 1e-5 relative RMS (LPIPS) and
1e-4 (PerceptualLoss, whose Gram products widen the rounding); the L1
criterion's gradient, sign(a - b), flips where rounding crosses 0, so
only its value is held.
"""
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from codeformer_tpu.models.vgg import VGGFeatureExtractor as JVGG  # noqa: E402
from codeformer_tpu.utils.convert import torch_state_dict_to_flax  # noqa: E402
from codeformer_tpu_torch.models.vgg import (VGGFeatureExtractor,  # noqa: E402
                                             vgg_layer_names)

torch.set_num_threads(2)

RTOL = 1e-5
PLANS = {'vgg16': [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)],
         'vgg19': [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]}


def vgg_state_dict(rng, vgg_type):
    """A seeded torchvision-format VGG state dict (features.N.* plus a
    classifier entry the extractor must leave out), He-scaled so the
    activations keep their size through the 16 convs."""
    sd, idx, in_ch = {}, 0, 3
    for ch, n_convs in PLANS[vgg_type]:
        for _ in range(n_convs):
            std = np.sqrt(2.0 / (9 * in_ch))
            sd[f'features.{idx}.weight'] = torch.tensor(
                rng.normal(0, std, (ch, in_ch, 3, 3)).astype(np.float32))
            sd[f'features.{idx}.bias'] = torch.tensor(
                rng.normal(0, 0.02, (ch,)).astype(np.float32))
            idx += 2
            in_ch = ch
        idx += 1
    sd['classifier.0.weight'] = torch.zeros(4, 4)
    return sd


def lin_state_dict(rng):
    return {f'lin{i}.model.1.weight': torch.tensor(
        rng.uniform(0, 0.2, (1, c, 1, 1)).astype(np.float32))
        for i, c in enumerate([64, 128, 256, 512, 512])}


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _images(seed, n=2, size=32):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
            for _ in range(2)]


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize('vgg_type,layers,input_norm,range_norm', [
    ('vgg19', ('conv1_1', 'relu2_2', 'pool3', 'conv5_4'), True, False),
    ('vgg16', ('relu1_2', 'relu3_3', 'relu5_3'), True, True),
    ('vgg16', ('pool1', 'relu4_3'), False, False),
])
def test_vgg_taps_match_jax(vgg_type, layers, input_norm, range_norm):
    sd = vgg_state_dict(np.random.default_rng(0), vgg_type)
    x, _ = _images(1)
    port = VGGFeatureExtractor(layers, vgg_type, input_norm, range_norm)
    port.load_torchvision(sd)
    assert all(k.startswith('features.') for k in port.state_dict())
    deepest = max(vgg_layer_names(vgg_type).index(n) for n in layers)
    assert len(port.features) == deepest + 1
    jm = JVGG(layer_name_list=layers, vgg_type=vgg_type,
              use_input_norm=input_norm, range_norm=range_norm)
    params = torch_state_dict_to_flax(
        {k: v for k, v in sd.items() if k.startswith('features.')})
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = port(_nchw(x))
    assert set(got) == set(layers)
    for name in layers:
        g = got[name].permute(0, 2, 3, 1).numpy()
        assert g.shape == np.asarray(want[name]).shape
        assert _rel(g, np.asarray(want[name])) <= RTOL, name


def test_vgg_rejects_unknown_layers_and_short_state_dicts():
    with pytest.raises(ValueError, match='no layers'):
        VGGFeatureExtractor(('relu3_4',), 'vgg16')
    port = VGGFeatureExtractor(('relu2_1',), 'vgg16')
    with pytest.raises(KeyError, match='lacks'):
        port.load_torchvision({'features.0.weight': torch.zeros(64, 3, 3, 3)})


@pytest.fixture()
def vgg_dir(tmp_path, monkeypatch):
    """weights/vgg/{vgg16,vgg19,lpips_vgg}.pth, seeded, under a temporary
    working directory (the losses read them relative to it)."""
    rng = np.random.default_rng(0)
    monkeypatch.chdir(tmp_path)
    os.makedirs('weights/vgg')
    torch.save(vgg_state_dict(rng, 'vgg16'), 'weights/vgg/vgg16.pth')
    torch.save(vgg_state_dict(rng, 'vgg19'), 'weights/vgg/vgg19.pth')
    torch.save(lin_state_dict(rng), 'weights/vgg/lpips_vgg.pth')
    return tmp_path


def _lpips_pair(**kw):
    from codeformer_tpu.train.perceptual import LPIPSLoss as JLPIPS
    from codeformer_tpu_torch.train.perceptual import LPIPSLoss
    return JLPIPS(**kw), LPIPSLoss(**kw)


@pytest.mark.parametrize('input_norm,range_norm', [(True, True),
                                                   (False, False)])
def test_lpips_value_and_input_gradient_match_jax(vgg_dir, input_norm,
                                                  range_norm):
    jl, pl = _lpips_pair(loss_weight=0.7, use_input_norm=input_norm,
                         range_norm=range_norm)
    assert not pl.degraded and not jl.degraded
    x, gt = _images(2)
    want, want_g = jax.value_and_grad(lambda a: jl(a, jnp.asarray(gt)))(
        jnp.asarray(x))
    xp = _nchw(x).requires_grad_(True)
    gtp = _nchw(gt).requires_grad_(True)
    got = pl(xp, gtp)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    g = xp.grad.permute(0, 2, 3, 1).numpy()
    want_g = np.asarray(want_g)
    assert np.sqrt(np.mean((g - want_g) ** 2) / np.mean(want_g ** 2)) \
        <= RTOL
    assert gtp.grad is None              # the target gets no gradient
    assert float(pl(_nchw(x), _nchw(x))) < 1e-6


def _grab(level=logging.WARNING):
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    handler = Grab(level=level)
    logging.getLogger('codeformer_tpu_torch').addHandler(handler)
    return records, handler


@pytest.mark.parametrize('drop,layers_vgg19,heads', [
    ('weights/vgg/vgg16.pth', True, True),
    ('weights/vgg/lpips_vgg.pth', False, False),
])
def test_lpips_degraded_fallbacks_warn_and_match_jax(vgg_dir, drop,
                                                     layers_vgg19, heads):
    """Without vgg16.pth: VGG19 taps; without the heads: uniform heads.
    Each warns, sets `degraded`, and still equals the JAX fallback."""
    from codeformer_tpu_torch.train import perceptual
    os.remove(drop)
    records, handler = _grab()
    try:
        jl, pl = _lpips_pair(range_norm=True)
    finally:
        logging.getLogger('codeformer_tpu_torch').removeHandler(handler)
    assert pl.degraded and jl.degraded
    assert pl.layers == (perceptual.LPIPS_LAYERS_VGG19 if layers_vgg19
                         else perceptual.LPIPS_LAYERS_VGG16)
    assert (pl.lins is not None) == heads
    assert any(('VGG19' if layers_vgg19 else 'uniform heads') in m
               for m in records), records
    assert all('DEGRADED' in m for m in records) and len(records) == 1
    x, gt = _images(3)
    np.testing.assert_allclose(float(pl(_nchw(x), _nchw(gt))),
                               float(jl(jnp.asarray(x), jnp.asarray(gt))),
                               rtol=RTOL)


def test_lpips_without_vgg_weights_raises(tmp_path, monkeypatch):
    from codeformer_tpu_torch.train.perceptual import (LPIPSLoss,
                                                       build_perceptual_loss)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match='weights/vgg/vgg16.pth'):
        LPIPSLoss()
    with pytest.raises(FileNotFoundError, match='weights/vgg/vgg19.pth'):
        build_perceptual_loss({'type': 'PerceptualLoss',
                               'layer_weights': {'conv5_4': 1.0}})
    with pytest.raises(NotImplementedError, match='SSIM'):
        build_perceptual_loss({'type': 'SSIM'})


@pytest.mark.parametrize('criterion', ['l1', 'l2', 'fro'])
def test_perceptual_loss_with_style_matches_jax(vgg_dir, criterion):
    from codeformer_tpu.train.perceptual import \
        build_perceptual_loss as jbuild
    from codeformer_tpu_torch.train.perceptual import build_perceptual_loss
    opt = {'type': 'PerceptualLoss',
           'layer_weights': {'conv1_2': 0.1, 'relu3_4': 1.0, 'conv5_4': 0.5},
           'vgg_type': 'vgg19', 'use_input_norm': True, 'range_norm': True,
           'perceptual_weight': 0.9, 'style_weight': 0.3,
           'criterion': criterion}
    jl, pl = jbuild(opt), build_perceptual_loss(opt)
    x, gt = _images(4)
    want = jax.value_and_grad(lambda a: jl(a, jnp.asarray(gt)))(
        jnp.asarray(x))
    xp = _nchw(x).requires_grad_(True)
    got = pl(xp, _nchw(gt))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want[0]),
                               rtol=RTOL)
    if criterion == 'l1':    # sign(a - b): rounding flips terms near 0
        return
    g, wg = xp.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want[1])
    assert np.sqrt(np.mean((g - wg) ** 2) / np.mean(wg ** 2)) <= 1e-4

"""The port's Real-ESRGAN upsampler against the JAX package's: RRDBNet at
scale 1, 2 and 4 (narrow: num_feat 32, num_block 2, num_grow_ch 16) on
the same weights through flax_to_state_dict, pixel_unshuffle's channel
order, the phase-collapsed up conv against nearest x2 + conv, and
RealESRGANer.enhance in every mode (RGB whole and tiled with a partial
last tile batch, L, RGBA, 16-bit, an outscale other than the scale)
against JAX's RealESRGANer with the same weights on its `.variables`,
both in fp32."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

cv2 = pytest.importorskip('cv2')

from codeformer_tpu.models import RRDBNet as JRRDBNet  # noqa: E402
from codeformer_tpu.models.rrdbnet import \
    pixel_unshuffle as jpixel_unshuffle  # noqa: E402
from codeformer_tpu.pipeline import realesrgan as jesr  # noqa: E402
from codeformer_tpu.utils.checkpoint import init_params_fast  # noqa: E402
from codeformer_tpu_torch.models import rrdbnet  # noqa: E402
from codeformer_tpu_torch.pipeline import realesrgan as pesr  # noqa: E402
from codeformer_tpu_torch.utils.convert import flax_to_state_dict  # noqa: E402
from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY  # noqa: E402

torch.set_num_threads(2)
NARROW = dict(num_feat=32, num_block=2, num_grow_ch=16)
# fp32 convs summed in another order through 2 RRDBs (30 convs) and the
# up convs (JAX's four 2x2 convs, the port's the same four): measured
# 1e-5 of outputs of magnitude 5-9
MODEL_ATOL = 1e-4
# the up conv against its plain version: the same products, the taps on
# one source pixel summed first (fp32)
UPCONV_ATOL = 1e-5
# enhance, uint8 (and 16-bit, one uint8 level = 257): a pixel rounded on
# either side of a .5 moves by one level
LEVEL = 1


def _jax_variables(scale, seed, tame=False):
    """Seeded JAX RRDBNet variables, with non-zero biases; `tame` scales
    conv_last to 0.1 and sets its bias to 0.5 so that the output spans
    levels instead of saturating at 0 and 255 (random weights)."""
    model = JRRDBNet(scale=scale, **NARROW)
    v = jax.tree_util.tree_map(
        np.array, init_params_fast(model, jnp.zeros((1, 32, 32, 3)),
                                   seed=seed))
    rng = np.random.default_rng(seed)
    for leaf in jax.tree_util.tree_leaves(v['params']):
        if leaf.ndim == 1:
            leaf[:] = rng.normal(0, 0.05, leaf.shape)
    if tame:
        last = v['params']['conv_last']
        last['kernel'] = last['kernel'] * 0.1
        last['bias'] = np.full(last['bias'].shape, 0.5, np.float32)
    return model, v


def _port_model(scale, v):
    model = rrdbnet.RRDBNet(scale=scale, **NARROW).eval()
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    return model


@pytest.mark.parametrize('scale', [1, 2, 4])
def test_rrdbnet_matches_jax(scale):
    jmodel, v = _jax_variables(scale, seed=scale)
    x = np.random.default_rng(0).uniform(0, 1, (2, 32, 40, 3)) \
        .astype(np.float32)
    want = np.asarray(jmodel.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_model(scale, v)(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 32 * scale, 40 * scale, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=MODEL_ATOL)


def test_rrdbnet_registered_with_the_reference_names():
    assert ARCH_REGISTRY.get('RRDBNet') is rrdbnet.RRDBNet
    keys = set(rrdbnet.RRDBNet(scale=2, **NARROW).state_dict())
    for k in ('conv_first.weight', 'body.1.rdb3.conv5.bias',
              'conv_body.weight', 'conv_up1.weight', 'conv_up2.bias',
              'conv_hr.weight', 'conv_last.bias'):
        assert k in keys, k


@pytest.mark.parametrize('scale', [2, 4])
def test_pixel_unshuffle_matches_jax(scale):
    """Output channel c*s*s + sh*s + sw, as JAX's (and the reference's)."""
    x = np.random.default_rng(1).normal(size=(2, 8, 12, 3)) \
        .astype(np.float32)
    want = np.asarray(jpixel_unshuffle(jnp.asarray(x), scale))
    got = rrdbnet.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2),
                                  scale).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('hw', [(8, 8), (7, 10)])
def test_phase_collapsed_up_conv_matches_nearest_conv(hw):
    """The four 2x2 phase convs (pads ((1-p, p), (1-q, q)), interleaved
    in (p, q) order) against nearest x2 then the 3x3 conv."""
    torch.manual_seed(0)
    conv = rrdbnet.PhaseCollapsedUpConv(5, 6)
    x = torch.randn(2, 5, *hw)
    with torch.no_grad():
        got = conv(x)
        want = rrdbnet.up_conv_ref(x, conv.weight, conv.bias)
    assert got.shape == want.shape == (2, 6, 2 * hw[0], 2 * hw[1])
    torch.testing.assert_close(got, want, rtol=0, atol=UPCONV_ATOL)
    # a swapped phase pad is caught
    k2 = rrdbnet.phase_kernels(conv.weight)[0]
    wrong = F.conv2d(F.pad(x, (0, 1, 0, 1)), k2) + conv.bias.view(1, -1, 1,
                                                                  1)
    assert (wrong - want[:, :, ::2, ::2]).abs().max() > 100 * UPCONV_ATOL


def _pair(tile, tile_batch=4, tile_pad=6):
    jmodel, v = _jax_variables(2, seed=7, tame=True)
    ju = jesr.RealESRGANer(scale=2, model=jmodel, tile=tile,
                           tile_pad=tile_pad, tile_batch=tile_batch,
                           allow_random=True, dtype=jnp.float32)
    ju.variables = v
    pu = pesr.RealESRGANer(scale=2, model=_port_model(2, v), tile=tile,
                           tile_pad=tile_pad, tile_batch=tile_batch,
                           dtype=torch.float32, device='cpu')
    return ju, pu


def _image(kind, rng):
    """A smooth seeded image (a noise field upscaled, noise on top) of
    the kind's channels and depth."""
    shape = {'L': (50, 70), 'RGBA': (50, 70, 4), 'odd': (51, 69, 3)} \
        .get(kind, (50, 70, 3))
    lo = rng.uniform(0, 1, (7, 9) + shape[2:]).astype(np.float32)
    img = cv2.resize(lo, (shape[1], shape[0]),
                     interpolation=cv2.INTER_LINEAR).reshape(shape)
    img = np.clip(img + rng.normal(0, 0.05, shape), 0, 1)
    if kind == '16bit':
        return (img * 65535).astype(np.uint16)
    return (img * 255).astype(np.uint8)


ENHANCE_CASES = {  # name: (image kind, tile, outscale, mode)
    'rgb_whole': ('RGB', 0, None, 'RGB'),
    'rgb_whole_odd': ('odd', 0, None, 'RGB'),
    # 50 x 70 in tiles of 24: 3 x 3 tiles, batches of 4 + 4 + 1
    'rgb_tiled_partial_batch': ('RGB', 24, None, 'RGB'),
    'gray': ('L', 24, None, 'L'),
    'rgba': ('RGBA', 0, None, 'RGBA'),
    '16bit': ('16bit', 24, None, '16bit'),
    'outscale': ('odd', 24, 3.5, 'RGB'),
}


@pytest.mark.parametrize('case', sorted(ENHANCE_CASES))
def test_enhance_matches_jax(case):
    kind, tile, outscale, mode = ENHANCE_CASES[case]
    img = _image(kind, np.random.default_rng(len(case)))
    ju, pu = _pair(tile)
    want, want_mode = ju.enhance(img, outscale=outscale)
    got, got_mode = pu.enhance(img, outscale=outscale)
    assert got_mode == want_mode == mode
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    level = 257 if mode == '16bit' else 1
    assert diff.max() <= LEVEL * level, (diff.max(), (diff > 0).mean())
    # the output spans levels: not a saturated comparison
    assert np.std(want.astype(np.float64) / level) > 10.0


# receptive-field radius of the narrow scale-2 model in input pixels:
# 32 convs at half resolution (conv_first, 2 RRDBs of 15, conv_body) and
# conv_up1 there, then one conv at full and two at double resolution
NARROW_RADIUS = 68


def test_tiled_equals_whole_inside_the_receptive_field_margin():
    """Tiles of 64 with a pad of 72 (> the receptive-field radius): the
    tiled output equals the whole-image output wherever a pixel's
    receptive field lies inside the image (at the image's border the
    tiles see edge-replicated pixels and the whole image zeros), each
    tile rounded to uint8 on its own, the last tile batch padded."""
    _, tiled = _pair(tile=64, tile_pad=72, tile_batch=4)
    _, whole = _pair(tile=0)
    img = cv2.resize(_image('RGB', np.random.default_rng(3)), (200, 192),
                     interpolation=cv2.INTER_LINEAR)
    x = torch.from_numpy(img.astype(np.float32) / 255.0).permute(2, 0, 1)
    got = tiled.upscale_device(x)
    ref = whole.upscale_device(x)
    assert got.shape == ref.shape == (3, 384, 400) and got.dtype == \
        torch.uint8
    m = 2 * NARROW_RADIUS
    d = (got.int() - ref.int()).abs()[:, m:-m, m:-m]
    assert d.numel() and d.max() <= LEVEL, d.max()
    # a seam shifted by one pixel is caught
    shifted = torch.roll(got, 1, dims=2)
    assert (shifted.int() - ref.int()).abs()[:, m:-m, m:-m].max() > 5


def test_weights_and_device(tmp_path, monkeypatch):
    """Weights from params_ema (then params); a missing file raises
    unless random weights are asked for; CUDA without a card raises
    rather than running on the CPU."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match='RealESRGAN weights'):
        pesr.RealESRGANer(device='cpu')
    model = rrdbnet.RRDBNet(scale=2, **NARROW)
    sd = {k: torch.randn_like(v) for k, v in model.state_dict().items()}
    path = tmp_path / 'x2.pth'
    torch.save({'params_ema': sd, 'params': {}}, path)
    up = pesr.RealESRGANer(model=rrdbnet.RRDBNet(scale=2, **NARROW),
                           model_path=str(path), dtype=torch.float32,
                           device='cpu')
    for k, v in up.model.state_dict().items():
        torch.testing.assert_close(v, sd[k])
    seeded = pesr.set_realesrgan(tile=400, allow_random=True, device='cpu')
    assert (seeded.scale, seeded.tile_size, seeded.tile_pad) == (2, 400, 40)
    assert seeded.dtype == torch.bfloat16
    assert seeded.model.conv_first.weight.dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            pesr.RealESRGANer(model=rrdbnet.RRDBNet(scale=2, **NARROW))

"""The port's inference_vqgan (codeformer_tpu_torch/cli/inference_vqgan.py)
against the JAX script's round trip (scripts/inference_vqgan.py `rec`:
VQAutoEncoder.apply, clip, round half to even, uint8) on the same
seeded weights (flax_to_state_dict) and seeded uint8 faces, fp32 on the
CPU, the tiny VQGAN topology of tests/test_int8.py.

Tolerance: both sides pick the SAME codes (the test checks it), and the
uint8 images are within one level, at most 0.1% of the values one level
apart: the fp32 decodes differ by about 1e-6, which puts a value on the
other side of a rounding boundary now and then (7 of 36,864 and 3 of
12,288 at these seeds). `main` on a folder of seeded PNGs writes the
same images to that tolerance.
"""
import os
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from codeformer_tpu.nn.blocks import colpack_mode, set_colpack_mode  # noqa: E402
from codeformer_tpu_torch.cli import generate_latent_gt as glg  # noqa: E402
from codeformer_tpu_torch.cli import inference_vqgan as ivq  # noqa: E402
from codeformer_tpu_torch.models.vqgan import VQAutoEncoder  # noqa: E402
from codeformer_tpu_torch.utils.convert import flax_to_state_dict  # noqa: E402

torch.set_num_threads(2)
TINY = dict(img_size=64, nf=32, ch_mult=(1, 2, 4), codebook_size=32,
            emb_dim=16)


@pytest.fixture(scope='module')
def pair():
    from codeformer_tpu.models import VQAutoEncoder as JaxVQ
    prev = colpack_mode()
    set_colpack_mode('off')
    jm = JaxVQ(**TINY)
    v = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3)))
    v = jax.tree.map(np.asarray, v)
    yield jm, v
    set_colpack_mode(prev)


def _jax_rec(jm, v, x_uint8):
    """scripts/inference_vqgan.py:45-55 on RGB uint8 (B, H, W, 3)."""
    x = jnp.asarray(x_uint8.astype(np.float32) / 127.5 - 1)
    out, _, stats = jm.apply(v, x)
    out = jnp.clip(out, -1, 1)
    return (np.asarray(jnp.round((out + 1) * 127.5).astype(jnp.uint8)),
            np.asarray(stats['min_encoding_indices']))


def _faces(seed, n, size=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    out = []
    for i in range(n):
        base = (yy * (i + 2) + xx * 3) % 256
        img = np.stack([base, base[::-1], base.T], -1) \
            + rng.normal(0, 20, (size, size, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


def _within_one_level(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def _port(v, **kw):
    model = glg.build_vqgan(TINY, device='cpu', **kw)
    model.load_state_dict(flax_to_state_dict(v))
    return model


def test_reconstruct_equals_the_jax_script(pair):
    jm, v = pair
    x = _faces(0, 3)
    want, codes = _jax_rec(jm, v, x)
    model = _port(v)
    got = ivq.reconstruct(model, torch.from_numpy(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == x.shape
    with torch.no_grad():
        z, _ = model.encoder(torch.from_numpy(x).permute(0, 3, 1, 2)
                             .float() / 127.5 - 1)
        _, _, stats = model.quantize(z)
    np.testing.assert_array_equal(stats['min_encoding_indices'].numpy(),
                                  codes.reshape(-1))
    _within_one_level(got.numpy(), want)
    assert want.std() > 1.0          # not a constant image


def test_reconstruct_bf16_runs_the_kernel_path_plainly(pair):
    """--dtype bf16: K1/K2 on (their plain versions on the CPU), uint8 out
    of the same shape, within a mean of 10% of the range (25.5 levels)
    of fp32: random weights carry bf16 rounding through every block
    (read 13.9)."""
    _, v = pair
    x = torch.from_numpy(_faces(1, 2))
    m16 = _port(v, dtype=torch.bfloat16)
    assert all(m.use_kernels for m in m16.modules()
               if hasattr(m, 'use_kernels'))
    got = ivq.reconstruct(m16, x, torch.bfloat16)
    ref = ivq.reconstruct(_port(v), x)
    assert got.shape == ref.shape and got.dtype == torch.uint8
    assert float((got.float() - ref.float()).abs().mean()) < 25.5


def test_main_writes_the_round_trips(pair, tmp_path, monkeypatch):
    """`main` on a folder of seeded PNGs (cv2 reads BGR, the model sees
    RGB) with a .pth of the JAX weights: every file written under its
    name, equal to the JAX script's round trip of the file."""
    cv2 = pytest.importorskip('cv2')
    jm, v = pair
    src = tmp_path / 'faces'
    src.mkdir()
    faces = _faces(2, 3)
    for i, f in enumerate(faces):
        cv2.imwrite(str(src / f'{i:03d}.png'), f)
    ckpt = tmp_path / 'vqgan.pth'
    torch.save(flax_to_state_dict(v), ckpt)
    monkeypatch.setattr(glg, 'VQAutoEncoder',
                        lambda **kw: VQAutoEncoder(**dict(TINY, **kw)))
    out = tmp_path / 'rec'
    ivq.main(['-i', str(src), '-o', str(out), '--ckpt_path', str(ckpt),
              '--codebook_size', '32', '--batch', '2', '--device', 'cpu'])
    names = sorted(os.listdir(out))
    assert names == ['000.png', '001.png', '002.png']
    rgb = np.stack([cv2.imread(str(src / n))[..., ::-1] for n in names])
    want, _ = _jax_rec(jm, v, rgb)
    got = np.stack([cv2.imread(str(out / n))[..., ::-1] for n in names])
    _within_one_level(got, want)


def test_main_refuses_a_missing_checkpoint_and_an_absent_card(tmp_path):
    with pytest.raises(SystemExit, match='checkpoint not found'):
        ivq.main(['-i', str(tmp_path), '--ckpt_path',
                  str(tmp_path / 'none.pth'), '--device', 'cpu'])
    with mock.patch.object(torch.cuda, 'is_available', return_value=False):
        with pytest.raises(SystemExit, match='no CUDA device'):
            ivq.main(['-i', str(tmp_path), '--random-init'])

"""generate_latent_gt in the port (codeformer_tpu_torch/cli/
generate_latent_gt.py) against the JAX script's encode logic
(scripts/generate_latent_gt.py: the VQAutoEncoder's encoder, then
codeformer_tpu.ops.vq.nearest_code_indices against its codebook), run in
process on the same seeded weights (flax_to_state_dict) and the same
seeded PNGs, fp32; and its .pth through the port's FFHQBlindDataset
(`latent_gt_path`) into a CodeFormerIdxModel step.

Tolerance: the maps equal code for code (fp32 both sides; the nearest
codes are far apart at this seed, as in tests/test_torch_train.py).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from codeformer_tpu_torch.cli import generate_latent_gt as glg  # noqa: E402
from codeformer_tpu_torch.utils.convert import flax_to_state_dict  # noqa: E402

torch.set_num_threads(2)
TINY = {'img_size': 64, 'nf': 32, 'ch_mult': [1, 2, 4],
        'quantizer': 'nearest', 'codebook_size': 32, 'emb_dim': 16}


def _write_faces(root, n=5, size=64):
    import cv2
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        # smooth-ish seeded images: a gradient plus noise
        yy, xx = np.mgrid[:size, :size]
        base = (yy * (i + 1) + xx * 3) % 256
        img = np.stack([base, base[::-1], base.T], -1) \
            + rng.normal(0, 20, (size, size, 3))
        cv2.imwrite(str(root / f'{i:05d}.png'),
                    np.clip(img, 0, 255).astype(np.uint8))
    return sorted(str(p) for p in root.iterdir())


def _jax_encode(params, x):
    """The JAX script's `encode` (scripts/generate_latent_gt.py:50-56)."""
    from codeformer_tpu.models import VQAutoEncoder
    from codeformer_tpu.ops.vq import nearest_code_indices
    model = VQAutoEncoder(**TINY)
    z, _ = model.apply({'params': params}, x,
                       method=lambda m, v: m.encoder(v))
    emb = params['quantize']['embedding']
    idx = nearest_code_indices(z.reshape(-1, emb.shape[1]), emb)
    return np.asarray(idx.reshape(x.shape[0], z.shape[1],
                                  z.shape[2])).astype(np.int32)


@pytest.fixture(scope='module')
def latent_run(tmp_path_factory):
    from codeformer_tpu.models import VQAutoEncoder
    tmp = tmp_path_factory.mktemp('latent')
    paths = _write_faces(tmp / 'faces')
    params = VQAutoEncoder(**TINY).init(jax.random.PRNGKey(3),
                                        jnp.zeros((1, 64, 64, 3)))['params']
    params = jax.tree.map(np.asarray, params)
    model = glg.build_vqgan(TINY, device='cpu')
    model.load_state_dict(flax_to_state_dict({'params': params}))
    latent = glg.generate(model, paths, batch=2)
    want = {}
    for key in ('orig', 'hflip'):
        x = glg.read_images(paths, key == 'hflip')
        want[key] = dict(zip([os.path.basename(p)[:-4] for p in paths],
                             _jax_encode(params, jnp.asarray(x))))
    path = tmp / 'latent_gt_code32.pth'
    torch.save(latent, path)
    return {'latent': latent, 'want': want, 'paths': paths, 'tmp': tmp,
            'pth': path}


def test_maps_equal_the_jax_scripts(latent_run):
    latent, want = latent_run['latent'], latent_run['want']
    assert set(latent) == {'orig', 'hflip'}
    for key in ('orig', 'hflip'):
        assert set(latent[key]) == set(want[key]) and len(want[key]) == 5
        for name, m in latent[key].items():
            assert m.dtype == torch.int32 and m.shape == (16, 16)
            np.testing.assert_array_equal(m.numpy(), want[key][name],
                                          err_msg=f'{key} {name}')
    codes = np.concatenate([m.numpy().ravel()
                            for m in latent['orig'].values()])
    assert len(np.unique(codes)) > 4
    # the flip changes the maps (the images are not symmetric)
    assert any(not torch.equal(latent['orig'][n], latent['hflip'][n])
               for n in latent['orig'])


def test_pth_feeds_the_dataset_and_a_stage2_step(latent_run, tmp_path):
    """The .pth through FFHQBlindDataset(latent_gt_path) into a
    CodeFormerIdxModel step: _idx_gt takes batch['latent_gt'] (the HQ
    encoder does not run) and the code losses see those codes."""
    from unittest import mock

    from test_torch_train import _opt

    from codeformer_tpu_torch.data import build_dataset
    from codeformer_tpu_torch.data.loader import _stack
    from codeformer_tpu_torch.train.trainers import build_model
    ds = build_dataset({
        'name': 'tiny', 'type': 'FFHQBlindDataset',
        'dataroot_gt': str(latent_run['tmp'] / 'faces'),
        'io_backend': {'type': 'disk'}, 'in_size': 64, 'gt_size': 64,
        'use_hflip': True, 'use_corrupt': False,
        'latent_gt_path': str(latent_run['pth'])})
    items = [ds[i] for i in range(2)]
    latent = latent_run['latent']
    for it in items:
        name = os.path.basename(it['gt_path'])[:-4]
        got = it['latent_gt']
        assert got.shape == (256,) and got.dtype == np.int32
        assert any(np.array_equal(got, latent[k][name].numpy().ravel())
                   for k in ('orig', 'hflip'))
    batch = _stack(items)
    pm = build_model(_opt(tmp_path))
    seen = []
    code_losses = pm._code_losses

    def spy(logits, lq_feat, idx_gt):
        seen.append(idx_gt.clone())
        return code_losses(logits, lq_feat, idx_gt)
    pm._code_losses = spy
    with mock.patch.object(pm.hq_vqgan.encoder, 'forward',
                           side_effect=AssertionError('encoder ran')):
        pm.feed_data(batch)
        pm.optimize_parameters(1)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0].numpy(), batch['latent_gt'])
    assert np.isfinite(pm.log_dict['l_g_total'])


def test_cli_writes_the_pth(latent_run, tmp_path, capsys):
    """The command line on the host (--device cpu, --random-init: the
    full-width encoder, seeded) writes latent_gt_code<K>.pth with both
    keys and one map an image; a missing checkpoint without
    --random-init and cuda without a card exit with a message."""
    faces = latent_run['tmp'] / 'faces'
    out = glg.main(['-i', str(faces), '-o', str(tmp_path / 'out'),
                    '--codebook_size', '64', '--batch', '3',
                    '--device', 'cpu', '--random-init',
                    '--ckpt_path', str(tmp_path / 'missing.pth')])
    assert out.endswith('latent_gt_code64.pth')
    blob = torch.load(out, weights_only=True)
    assert set(blob) == {'orig', 'hflip'}
    assert set(blob['orig']) == {f'{i:05d}' for i in range(5)}
    m = blob['hflip']['00000']
    assert m.dtype == torch.int32 and m.shape == (2, 2)
    assert int(m.max()) < 64
    with pytest.raises(SystemExit, match='checkpoint not found'):
        glg.main(['-i', str(faces), '--device', 'cpu',
                  '--ckpt_path', str(tmp_path / 'missing.pth')])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match='no CUDA device'):
            glg.main(['-i', str(faces), '--random-init'])

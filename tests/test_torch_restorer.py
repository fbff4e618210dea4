"""The port's CodeFormerRestorer (device='cpu', fp32) against the JAX
CodeFormerRestorer on the tiny topology with the same parameters.

Outputs are uint8 after clip and round-half-to-even on both sides; the
fp32 model outputs differ by ~1e-5, so a pixel may land on the other
side of a rounding boundary: held to within 1 level.
"""
import os
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from codeformer_tpu.models import CodeFormer as JaxCodeFormer  # noqa: E402
from codeformer_tpu.pipeline.restorer import (  # noqa: E402
    CodeFormerRestorer as JaxRestorer)
from codeformer_tpu_torch.models import CodeFormer  # noqa: E402
from codeformer_tpu_torch.nn.blocks import FuseSftBlock  # noqa: E402
from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer  # noqa: E402
from codeformer_tpu_torch.utils.convert import flax_to_state_dict  # noqa: E402

torch.set_num_threads(2)
TINY = dict(img_size=64, nf=32, ch_mult=(1, 2, 4), codebook_size=64,
            emb_dim=16, dim_embd=64, n_head=4, n_layers=2, latent_size=256,
            connect_list=('32',))
BUCKETS = (1, 2, 4)


@pytest.fixture(scope='module')
def restorers():
    env = {k: v for k, v in os.environ.items() if k != 'CODEFORMER_COLPACK'}
    with mock.patch.dict(os.environ, env, clear=True):
        jr = JaxRestorer(model=JaxCodeFormer(**TINY), dtype=jnp.float32,
                         face_size=64, batch_buckets=BUCKETS)
    pm = CodeFormer(**TINY)
    pm.load_state_dict(flax_to_state_dict(jr.variables))
    pr = CodeFormerRestorer(device='cpu', dtype=torch.float32, model=pm,
                            face_size=64, batch_buckets=BUCKETS)
    return jr, pr


def _faces(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
            for _ in range(n)]


def _within_one_level(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (64, 64, 3) and g.dtype == np.uint8
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


def test_restore_batch_matches_jax_with_bucket_padding(restorers):
    """3 faces run in the 4-bucket and come back trimmed to 3."""
    jr, pr = restorers
    faces = _faces(0, 3)
    assert pr._bucket(3) == 4 and pr._bucket(9) == 12
    _within_one_level(pr.restore_batch(faces, w=0.5),
                      jr.restore_batch(faces, w=0.5))


def test_restore_batch_w_zero_matches_jax(restorers):
    jr, pr = restorers
    faces = _faces(1, 1)
    _within_one_level(pr.restore_batch(faces, w=0.0),
                      jr.restore_batch(faces, w=0.0))


def test_bgr_order(restorers):
    """restore_batch takes and returns BGR; the model sees RGB."""
    _, pr = restorers
    faces = _faces(2, 2)
    out = pr.restore_batch(faces, w=0.5)
    rgb = np.stack([f[..., ::-1] for f in faces])
    dev = pr.restore_device(rgb, w=0.5).numpy()
    for o, d in zip(out, dev):
        np.testing.assert_array_equal(o, d[..., ::-1])


@pytest.mark.parametrize('w,calls', [(0.0, 0), (0.5, 1)])
def test_fuse_gate_follows_w(restorers, w, calls):
    """enable_fuse defaults to w > 0: no SFT block runs at w = 0."""
    _, pr = restorers
    with mock.patch.object(FuseSftBlock, 'forward', autospec=True,
                           side_effect=lambda self, e, d, w: d) as fwd:
        pr.restore_batch(_faces(3, 1), w=w)
    assert fwd.call_count == calls


def test_uint8_boundary():
    """x/127.5 - 1 in; clip to [-1, 1], round half to even out."""
    pr = CodeFormerRestorer.__new__(CodeFormerRestorer)
    pr.dtype = torch.float32
    x = torch.tensor([0, 1, 127, 128, 255], dtype=torch.uint8)
    xn = pr.normalize(x.reshape(1, 1, 5, 1).expand(1, 1, 5, 3))
    np.testing.assert_allclose(xn[0, 0, 0].numpy(),
                               x.numpy() / 127.5 - 1.0, rtol=0, atol=1e-7)
    y = np.concatenate([[-2.0, -1.0, 0.0, 1.0, 2.0],
                        np.random.default_rng(9).uniform(-1.1, 1.1, 64)])
    y = y.astype(np.float32)
    out = CodeFormerRestorer.denormalize(
        torch.from_numpy(y).reshape(1, 1, 1, -1))
    # numpy rounds half to even too; 0.0 -> 127.5 -> 128
    want = np.round((np.clip(y, -1, 1) + np.float32(1))
                    * np.float32(127.5)).astype(np.uint8)
    assert out.reshape(-1).tolist() == want.tolist()
    assert want[:5].tolist() == [0, 0, 128, 255, 255]
    assert out.dtype == torch.uint8


@pytest.mark.parametrize('dtype', [torch.float32, torch.float16])
def test_cuda_restorer_refuses_non_bf16(dtype):
    """The CUDA kernels take bf16 only: another dtype is refused when the
    restorer is built, before any model or device is touched, instead of
    every request failing into the passthrough."""
    with pytest.raises(ValueError, match='bfloat16'):
        CodeFormerRestorer(device='cuda', dtype=dtype)


def test_failing_chunk_passes_through(restorers, capsys):
    """A chunk that raises comes back unchanged; other chunks restore."""
    _, pr = restorers
    good = _faces(4, 4)
    bad = [np.zeros((32, 32, 3), np.uint8)]
    out = pr.restore_batch(good + bad, w=0.5)
    assert len(out) == 5
    assert out[4] is bad[0]
    assert not any(np.array_equal(o, g) for o, g in zip(out[:4], good))
    assert 'Failed inference' in capsys.readouterr().out


def test_cli_run_aligned_writes_restored_faces(restorers, tmp_path):
    """The port's --has_aligned CLI path on the tiny restorer: reads a
    folder, restores, writes restored_faces/<name>_<suffix>.png."""
    cv2 = pytest.importorskip('cv2')
    from codeformer_tpu_torch.cli import inference_codeformer as cli
    from codeformer_tpu_torch.cli.common import list_inputs
    _, pr = restorers
    src = tmp_path / 'faces'
    src.mkdir()
    faces = _faces(5, 2)
    faces[1] = np.repeat(faces[1][..., :1], 3, axis=-1)     # a gray face
    for i, f in enumerate(faces):
        cv2.imwrite(str(src / f'{i:04d}.png'), f)
    paths, root, is_video = list_inputs(str(src), 0.5)
    assert root == 'results/faces_0.5' and len(paths) == 2
    assert not is_video
    args = cli.build_parser().parse_args(
        ['--has_aligned', '-i', str(src), '--suffix', 'x'])
    cli.run_aligned(args, paths, str(tmp_path / 'out'), pr)
    outs = sorted((tmp_path / 'out' / 'restored_faces').iterdir())
    assert [p.name for p in outs] == ['0000_x.png', '0001_x.png']
    gray = cv2.imread(str(outs[1]))
    assert gray.shape == (64, 64, 3)
    assert np.array_equal(gray[..., 0], gray[..., 1])

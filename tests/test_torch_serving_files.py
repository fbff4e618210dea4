"""The port's serving entry points on the repo's own files, against the
JAX CLIs (both read and write with cv2):

- tests/torch_inputs_digests.json holds the sha256 of cv2's decode of
  each inputs/ file (chip_smoke.py checks the card machine's cv2 against
  it, so the CLI runs there restore the pixels held here); the test
  recomputes it, so it cannot go stale;
- the aligned CLI on two repo faces (one of them gray), with a stub
  restorer: the same files as the JAX CLI's, bit for bit; --profile
  reports its read, restore and write stages;
- the fused whole-image CLI on a folder holding inputs/whole_imgs/00.jpg
  (a progressive JPEG, upscaled to 512 on its short side) with the tiny
  CodeFormer and ParseNet and the injected detections of
  tests/test_torch_device_pipeline.py in both CLIs, with the face at the
  crop's own scale at whole-pixel offsets and at another scale off the
  pixel grid (see `test_fused_whole_image_cli_on_a_jpeg`);
- colorization and inpainting on two repo files each, with the stub
  restorer: the JAX CLIs' files, bit for bit;
- inference_vqgan and generate_latent_gt (full width, seeded) on two
  files, a PNG and a JPEG: the same outputs as their cores give on cv2's
  decode, each result under its input's name and format.
"""
import hashlib
import importlib
import json
import os
import subprocess
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

cv2 = pytest.importorskip('cv2')

from codeformer_tpu.models import CodeFormer as JCodeFormer  # noqa: E402
from codeformer_tpu.models import ParseNet as JParseNet  # noqa: E402
from codeformer_tpu.pipeline.restorer import CodeFormerRestorer as JRestorer  # noqa: E402
from codeformer_tpu.utils.checkpoint import init_params_fast  # noqa: E402
from codeformer_tpu_torch.cli import inference_codeformer as pcli  # noqa: E402
from codeformer_tpu_torch.models import CodeFormer  # noqa: E402
from codeformer_tpu_torch.models.parsenet import ParseNet  # noqa: E402
from codeformer_tpu_torch.pipeline import face_helper as pfh  # noqa: E402
from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer  # noqa: E402
from codeformer_tpu_torch.utils.convert import flax_to_state_dict  # noqa: E402
from codeformer_tpu_torch.utils.profiler import TIMER  # noqa: E402
from test_torch_device_pipeline import (FACE, FRAME_MAX_BOUND,  # noqa: E402
                                        FRAME_MEAN_BOUND, TEMPLATE, TINY,
                                        _Helper, _JInjected, _PInjected)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(ROOT, 'inputs')
DIGESTS = os.path.join(ROOT, 'tests', 'torch_inputs_digests.json')
DIGESTED = sorted(json.load(open(DIGESTS))['files'])


def test_digest_file_lists_every_tracked_input():
    tracked = subprocess.run(['git', 'ls-files', 'inputs'], cwd=ROOT,
                             capture_output=True, text=True).stdout.split()
    if tracked:   # a checkout without git metadata lists none
        assert sorted(tracked) == DIGESTED
    assert len(DIGESTED) == 45


@pytest.mark.parametrize('rel', DIGESTED)
def test_inputs_decode_to_the_recorded_digest(rel):
    img = cv2.imread(os.path.join(ROOT, rel), cv2.IMREAD_COLOR)
    rec = json.load(open(DIGESTS))['files'][rel]
    assert img.dtype == np.uint8 and list(img.shape) == rec['shape']
    assert hashlib.sha256(np.ascontiguousarray(img).tobytes()) \
        .hexdigest() == rec['sha256']


class _StubRestorer:
    """Inverts the faces; records each restore_batch call."""
    device = torch.device('cpu')
    face_size = 512
    calls = []

    def __init__(self, **kw):
        pass

    def restore_batch(self, faces, w=0.5, adain=True, enable_fuse=None):
        _StubRestorer.calls.append(len(faces))
        return [(255 - np.asarray(f)).astype(np.uint8) for f in faces]


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names and sorted(os.listdir(b)) == names
    for n in names:
        want = cv2.imread(os.path.join(b, n), cv2.IMREAD_UNCHANGED)
        got = cv2.imread(os.path.join(a, n), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, want, n)
    return names


def _link(tmp_path, name, rels):
    d = tmp_path / name
    d.mkdir()
    for rel in rels:
        os.symlink(os.path.join(INPUTS, rel), d / os.path.basename(rel))
    return d


def test_aligned_cli_on_repo_faces(tmp_path, monkeypatch, capsys):
    import codeformer_tpu.cli.inference_codeformer as jcli
    import codeformer_tpu_torch.pipeline as pipeline
    faces = _link(tmp_path, 'faces', ['cropped_faces/0143.png',
                                      'gray_faces/Einstein01.png'])
    monkeypatch.setattr(pipeline, 'CodeFormerRestorer', _StubRestorer)
    _StubRestorer.calls = []
    TIMER.reset()
    pcli.main(['--has_aligned', '-i', str(faces), '-o',
               str(tmp_path / 'port'), '--random-init', '--device', 'cpu',
               '--profile'])
    said = capsys.readouterr().out
    for name in ('read', 'restore', 'write'):
        assert f'\n{name} ' in said
    args = jcli.build_parser().parse_args(['--has_aligned', '-i',
                                           str(faces)])
    jcli.run_aligned(args, sorted(str(p) for p in faces.iterdir()),
                     str(tmp_path / 'jax'), _StubRestorer())
    assert _StubRestorer.calls == [2, 2]
    names = _same_files(tmp_path / 'port' / 'restored_faces',
                        tmp_path / 'jax' / 'restored_faces')
    assert names == ['0143.png', 'Einstein01.png']
    gray = cv2.imread(str(tmp_path / 'port' / 'restored_faces' /
                          'Einstein01.png'))
    assert (gray[..., 0] == gray[..., 1]).all()


@pytest.fixture(scope='module')
def tiny_models():
    """JAX and port restorers and parsers on the same weights (as
    tests/test_torch_device_pipeline.py builds them)."""
    env = {k: v for k, v in os.environ.items() if k != 'CODEFORMER_COLPACK'}
    with mock.patch.dict(os.environ, env, clear=True):
        jr = JRestorer(model=JCodeFormer(**TINY), dtype=jnp.float32,
                       face_size=FACE, batch_buckets=(1, 2, 4))
    pm = CodeFormer(**TINY)
    pm.load_state_dict(flax_to_state_dict(jr.variables))
    pr = CodeFormerRestorer(device='cpu', dtype=torch.float32, model=pm,
                            face_size=FACE)
    jparse = JParseNet()
    jvars = jax.tree_util.tree_map(np.asarray, init_params_fast(
        jparse, jnp.zeros((1, 64, 64, 3)), seed=5))
    pparse = ParseNet().eval().requires_grad_(False)
    pparse.load_state_dict(flax_to_state_dict(
        jvars, like=pparse.state_dict()), strict=True)
    return jr, pr, (jparse, jvars), pparse


# whole_imgs/00.jpg (310 x 491) after the min-side-512 upscale
FRAME_H, FRAME_W = 512, round(491 * 512 / 310)
# where the face lies in that frame: (template scale, offset)
PLACEMENTS = {
    # the crop's own scale at whole-pixel offsets: both warps sample the
    # frame at the same whole pixels
    'whole_pixel': (FACE / 512, (FRAME_W // 2 - 32, 200)),
    # another scale, off the pixel grid: the warps interpolate
    'off_pixel': (0.15, (FRAME_W // 2 - 40.37, 190.61)),
}


@pytest.mark.parametrize('placement', sorted(PLACEMENTS))
def test_fused_whole_image_cli_on_a_jpeg(tmp_path, monkeypatch, tiny_models,
                                         placement):
    """The whole-pixel case holds the final frame to the bounds of
    tests/test_torch_device_pipeline.py. Off the pixel grid, the two
    warps' fp32 coordinates round a crop pixel to neighbouring levels
    here and there, and the tiny model's random codes amplify that into
    a visible difference of the restored face, so its frame is not held
    to those bounds; what is held instead: the crops within 1 level;
    each restored face equal to what the port's restorer makes of that
    CLI's own crop, the JAX crop included (the gap comes in with the
    crop, and neither the restorers nor the paste differ); and the frame
    outside the face's window within 1 level. The frame gap is printed
    (-s) and recorded in PERF.md's open questions."""
    import codeformer_tpu.cli.whole_image as jwi
    import codeformer_tpu_torch.cli.whole_image as pwi
    jr, pr, (jparse, jvars), pparse = tiny_models
    folder = _link(tmp_path, 'imgs', ['whole_imgs/00.jpg'])
    h, w = FRAME_H, FRAME_W
    scale, offset = PLACEMENTS[placement]
    landmarks = [TEMPLATE * scale + np.array(offset, np.float32)]
    monkeypatch.setattr(jwi, 'FaceRestoreHelper', lambda *a, **kw: _Helper(
        _JInjected(landmarks), True, jparse, jax.device_put(jvars)))
    monkeypatch.setattr(pfh, 'FaceRestoreHelper', lambda *a, **kw: _Helper(
        _PInjected(landmarks), True, pparse))
    args = SimpleNamespace(
        bg_upsampler='None', face_upsample=False, upscale=1,
        detection_model='retinaface_resnet50', fidelity_weight=0.5,
        input_path=str(folder), draw_box=False, suffix=None,
        only_center_face=False, random_init=True, save_video_fps=None,
        fused_pipeline='on', parse_res=FACE, bg_tile=400)
    paths = [str(folder / '00.jpg')]
    pwi.run_whole_images(args, paths, str(tmp_path / 'port'), pr,
                         input_video=False)
    jwi.run_whole_images(args, paths, str(tmp_path / 'jax'), jr,
                         input_video=False)

    def read(k, sub, name):
        return cv2.imread(str(tmp_path / k / sub / name)).astype(np.float32)

    for sub, names in (('final_results', ['00.png']),
                       ('cropped_faces', ['00_00.png']),
                       ('restored_faces', ['00_00.png'])):
        assert sorted(os.listdir(tmp_path / 'port' / sub)) == names
        assert sorted(os.listdir(tmp_path / 'jax' / sub)) == names
    final = [read(k, 'final_results', '00.png') for k in ('port', 'jax')]
    assert final[0].shape == final[1].shape == (h, w, 3)
    diff = np.abs(final[0] - final[1])
    crops = [read(k, 'cropped_faces', '00_00.png') for k in ('port', 'jax')]
    assert crops[0].shape == (FACE, FACE, 3)
    crop_diff = np.abs(crops[0] - crops[1])
    print(f'{placement}: crops |diff| max {crop_diff.max():.0f} at '
          f'{(crop_diff > 0).mean():.4%} of values; frame |diff| mean '
          f'{diff.mean():.4f} max {diff.max():.0f}')
    assert crop_diff.max() <= 1
    # the face changed the frame: the pipeline ran, not a passthrough
    plain = cv2.resize(cv2.imread(paths[0]), (w, h))
    assert np.abs(final[0] - plain).max() > 10
    if placement == 'whole_pixel':
        assert diff.mean() <= FRAME_MEAN_BOUND
        assert diff.max() <= FRAME_MAX_BOUND
        return
    assert crop_diff.max() == 1      # the off-pixel case does differ
    # each value where the crops differ is a rounding tie within fp32's
    # reach: the same bilinear sample in float64 lies within 0.01 of a
    # .5 (by chance, one value in fifty would), and the two crops
    # round it to its two neighbouring levels
    src = cv2.imread(paths[0])
    up = 512 / min(src.shape[:2])
    src = cv2.resize(src, (0, 0), fx=up, fy=up,
                     interpolation=cv2.INTER_LINEAR).astype(np.float64)
    k = scale * 512 / FACE               # crop pixel -> frame pixel
    cy, cx, ch = np.nonzero(crop_diff)
    sx, sy = cx * k + offset[0], cy * k + offset[1]
    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    fx, fy = sx - x0, sy - y0
    exact = ((1 - fy) * ((1 - fx) * src[y0, x0, ch]
                         + fx * src[y0, x0 + 1, ch])
             + fy * ((1 - fx) * src[y0 + 1, x0, ch]
                     + fx * src[y0 + 1, x0 + 1, ch]))
    tie = np.abs(exact - np.floor(exact) - 0.5)
    print(f'  {len(cy)} differing crop values, each at most {tie.max():.4f} '
          f'from a .5 in float64')
    assert (tie < 0.01).all()
    lo_hi = np.sort(np.stack([c[cy, cx, ch] for c in crops]), 0)
    np.testing.assert_array_equal(lo_hi[0], np.floor(exact))
    np.testing.assert_array_equal(lo_hi[1], np.floor(exact) + 1)
    for k, crop in zip(('port', 'jax'), crops):
        again = pr.restore_batch([crop.astype(np.uint8)], w=0.5,
                                 adain=True)[0].astype(np.float32)
        assert np.abs(again - read(k, 'restored_faces', '00_00.png')) \
            .max() <= 1, k
    # the gap stays inside the square the crop covers in the frame
    # (landmarks and template agree exactly: the crop's 512 x 512
    # template square, scaled and shifted), give or take the paste's
    # bilinear pixel
    ys, xs = np.nonzero((diff > 1).any(-1))
    lo, hi = np.array(offset) - 2, np.array(offset) + 512 * scale + 2
    print(f'  frame pixels more than 1 level apart: x {xs.min()}-'
          f'{xs.max()}, y {ys.min()}-{ys.max()}; the crop square '
          f'x {lo[0]:.1f}-{hi[0]:.1f}, y {lo[1]:.1f}-{hi[1]:.1f}')
    assert len(xs) and (xs >= lo[0]).all() and (xs <= hi[0]).all()
    assert (ys >= lo[1]).all() and (ys <= hi[1]).all()


@pytest.mark.parametrize('task,files', [
    ('colorization', ['gray_faces/Einstein01.png',
                      'gray_faces/067_David_Beckham_00.png']),
    ('inpainting', ['masked_faces/00105.png', 'masked_faces/00108.png'])])
def test_task_clis_on_repo_files(tmp_path, monkeypatch, task, files):
    import codeformer_tpu_torch.pipeline as pipeline
    jcli = importlib.import_module(f'codeformer_tpu.cli.inference_{task}')
    tcli = importlib.import_module(
        f'codeformer_tpu_torch.cli.inference_{task}')
    folder = _link(tmp_path, 'in', files)
    monkeypatch.setattr(pipeline, 'CodeFormerRestorer', _StubRestorer)
    monkeypatch.setattr(jcli, 'CodeFormerRestorer', _StubRestorer)
    tcli.main(['-i', str(folder), '-o', str(tmp_path / 'port'),
               '--random-init', '--device', 'cpu'])
    jcli.main(['-i', str(folder), '-o', str(tmp_path / 'jax'),
               '--random-init'])
    assert len(_same_files(tmp_path / 'port', tmp_path / 'jax')) == 2


def _two_files(tmp_path):
    """A PNG and a JPEG of 64 x 64 made from repo faces."""
    d = tmp_path / 'small'
    d.mkdir()
    for i, rel in enumerate(['cropped_faces/0240.png',
                             'cropped_faces/0342.png']):
        img = cv2.resize(cv2.imread(os.path.join(INPUTS, rel)), (64, 64),
                         interpolation=cv2.INTER_AREA)
        ext = '.png' if i == 0 else '.jpg'
        assert cv2.imwrite(str(d / f'{i:05d}{ext}'), img)
    return d, sorted(str(p) for p in d.iterdir())


def test_vqgan_and_latent_gt_clis_on_a_png_and_a_jpeg(tmp_path):
    """Each reconstruction keeps its input's name and format, as the JAX
    script writes it (cv2.imwrite to the input's name): the JPEG's is
    cv2's JPEG encoding of the core's output."""
    from codeformer_tpu_torch.cli import generate_latent_gt as glg
    from codeformer_tpu_torch.cli import inference_vqgan as ivq
    d, paths = _two_files(tmp_path)
    missing = str(tmp_path / 'missing.pth')
    ivq.main(['-i', str(d), '-o', str(tmp_path / 'rec'), '--device', 'cpu',
              '--random-init', '--ckpt_path', missing])
    pth = glg.main(['-i', str(d), '-o', str(tmp_path / 'latent'),
                    '--device', 'cpu', '--random-init', '--ckpt_path',
                    missing, '--batch', '2'])
    model = glg.build_vqgan({'codebook_size': 1024}, None, device='cpu')
    bgr = [cv2.imread(p) for p in paths]
    x = torch.from_numpy(np.stack([im[..., ::-1] for im in bgr]).copy())
    want = ivq.reconstruct(model, x).numpy()
    names = sorted(os.listdir(tmp_path / 'rec'))
    assert names == ['00000.png', '00001.jpg']
    for i, name in enumerate(names):
        out = np.ascontiguousarray(want[i][..., ::-1])
        if name.endswith('.jpg'):
            out = cv2.imdecode(cv2.imencode('.jpg', out)[1], cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / 'rec' / name)), out)
    blob = torch.load(pth, weights_only=True)
    for key, flip in (('orig', False), ('hflip', True)):
        imgs = [cv2.flip(im, 1) if flip else im for im in bgr]
        xn = np.stack([im[..., ::-1].astype(np.float32) / 127.5 - 1
                       for im in imgs])
        codes = glg.encode(model, torch.from_numpy(xn).permute(0, 3, 1, 2))
        for p, c in zip(paths, codes):
            np.testing.assert_array_equal(
                blob[key][os.path.basename(p)[:-4]].numpy(), c.numpy())

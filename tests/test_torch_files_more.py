"""The port's file entry points that chip_smoke.py's files phase runs on
the card, here at tiny widths on the CPU, each against the JAX package on
the same files and seeds:

- the whole-image CLI's classic route (`--fused_pipeline off`) on
  inputs/whole_imgs/04.jpg and a gray image written from it, the real
  helpers of both packages with the same injected detections and parse
  ids (tests/test_torch_video.py's `_Det`, `_parse_stub`) and the same
  tiny restorer weights: the JAX CLI's crops bit for bit, its restored
  faces within a level, its final images within the video tests' frame
  bounds;
- the CLI's `main` on a short clip that cv2 writes (mp4v), on both
  routes: the frames handed to the video writer are the in-process
  `restore_frames` (fused) or `restore_video_frames` (classic) on the
  same decoded frames, bit for bit, and JAX's pipeline's within the
  frame bounds; the written video reopens with every frame;
- stage II from PNGs on disk: generate_latent_gt's `main` writes the
  latent_gt_path, the port's dataset gives the JAX dataset's items on
  those files, and `train_pipeline` trains on them with the codes of
  that file as its targets.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip('cv2')
yaml = pytest.importorskip('yaml')

import codeformer_tpu.cli.whole_image as jwi  # noqa: E402
from codeformer_tpu import data as jdata  # noqa: E402
from codeformer_tpu.pipeline import device_pipeline as jdp  # noqa: E402
from codeformer_tpu.pipeline import face_helper as jfh  # noqa: E402
from codeformer_tpu.pipeline import video as jvideo  # noqa: E402
import codeformer_tpu_torch.cli.whole_image as pwi  # noqa: E402
import codeformer_tpu_torch.pipeline as pipeline  # noqa: E402
from codeformer_tpu_torch import data as pdata  # noqa: E402
from codeformer_tpu_torch.cli import generate_latent_gt as glg  # noqa: E402
from codeformer_tpu_torch.cli import inference_codeformer as pcli  # noqa: E402
from codeformer_tpu_torch.pipeline import device_pipeline as pdp  # noqa: E402
from codeformer_tpu_torch.pipeline import face_helper as pfh  # noqa: E402
from codeformer_tpu_torch.pipeline import video as pvideo  # noqa: E402
from codeformer_tpu_torch.train import trainers  # noqa: E402
from codeformer_tpu_torch.utils import video_util as pvu  # noqa: E402
from test_torch_device_pipeline import _Helper, _JInjected, _PInjected  # noqa: E402
from test_torch_train import TINY_VQGAN, _tiny_yml  # noqa: E402
from test_torch_video import (FACE, FRAME_MAX_BOUND,  # noqa: E402,F401
                              FRAME_MEAN_BOUND, TEMPLATE, _Det, _parse_stub,
                              restorers)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WHOLE = os.path.join(ROOT, 'inputs', 'whole_imgs')


def _args(path, **kw):
    a = dict(bg_upsampler='None', face_upsample=False, upscale=2,
             detection_model='retinaface_resnet50', fidelity_weight=0.5,
             input_path=str(path), draw_box=False, suffix=None,
             only_center_face=False, random_init=True, save_video_fps=None,
             fused_pipeline='off', parse_res=256, bg_tile=400,
             compositor='xla')
    a.update(kw)
    return SimpleNamespace(**a)


HELPERS = {jfh: jfh.FaceRestoreHelper, pfh: pfh.FaceRestoreHelper}


def _helper(mod, faces, **kw):
    """A package's real FaceRestoreHelper (as imported, before a test
    patches it) at the tiny face size, with the injected detections and
    parse ids."""
    h = HELPERS[mod](2, face_size=FACE, use_parse=True,
                     allow_random_weights=True, detector=_Det(faces),
                     compositor='xla', **kw)
    h._parse_masks = _parse_stub
    return h


def _diff(a, b):
    return np.abs(a.astype(np.float32) - b.astype(np.float32))


# whole_imgs/04.jpg (225 x 225) is read at 512 x 512: one face, in
# fractions of the frame
IMAGE_FACES = [(TEMPLATE * 0.5 + [120.0, 90.0]) / 512.0]


def test_classic_route_on_a_jpeg_and_a_gray_image(tmp_path, monkeypatch,
                                                  restorers):
    jr, pr = restorers
    folder = tmp_path / 'in'
    folder.mkdir()
    os.symlink(os.path.join(WHOLE, '04.jpg'), folder / '04.jpg')
    src = cv2.imread(os.path.join(WHOLE, '04.jpg'))
    assert cv2.imwrite(str(folder / 'gray.png'),
                       cv2.cvtColor(src, cv2.COLOR_BGR2GRAY))
    paths = sorted(str(p) for p in folder.iterdir())
    monkeypatch.setattr(jwi, 'FaceRestoreHelper',
                        lambda *a, **kw: _helper(jfh, IMAGE_FACES))
    monkeypatch.setattr(pfh, 'FaceRestoreHelper',
                        lambda *a, **kw: _helper(pfh, IMAGE_FACES,
                                                 device='cpu'))
    pwi.run_whole_images(_args(folder), paths, str(tmp_path / 'port'), pr,
                         input_video=False)
    jwi.run_whole_images(_args(folder), paths, str(tmp_path / 'jax'), jr,
                         input_video=False)

    def read(k, sub, name):
        return cv2.imread(str(tmp_path / k / sub / name))

    for sub, names in (('final_results', ['04.png', 'gray.png']),
                       ('cropped_faces', ['04_00.png', 'gray_00.png']),
                       ('restored_faces', ['04_00.png', 'gray_00.png'])):
        assert sorted(os.listdir(tmp_path / 'port' / sub)) == names
        assert sorted(os.listdir(tmp_path / 'jax' / sub)) == names
    for name in ('04_00.png', 'gray_00.png'):
        np.testing.assert_array_equal(read('port', 'cropped_faces', name),
                                      read('jax', 'cropped_faces', name))
        assert _diff(read('port', 'restored_faces', name),
                     read('jax', 'restored_faces', name)).max() <= 1
    gray = read('port', 'restored_faces', 'gray_00.png')
    assert (gray[..., 0] == gray[..., 1]).all()
    for name in ('04.png', 'gray.png'):
        got, want = (read(k, 'final_results', name) for k in ('port', 'jax'))
        assert got.shape == want.shape == (1024, 1024, 3)
        diff = _diff(got, want)
        print(f'{name}: final |diff| mean {diff.mean():.5f} max '
              f'{diff.max():.0f}')
        assert diff.mean() <= FRAME_MEAN_BOUND
        assert diff.max() <= FRAME_MAX_BOUND
        plain = cv2.resize(cv2.imread(paths[name == 'gray.png']),
                           (1024, 1024), interpolation=cv2.INTER_LINEAR)
        assert _diff(got, plain).max() > 30       # the face was pasted


# the clip: 6 frames of 96 x 128, read at 512 x 683; one face a frame
# in frame coordinates, as the fused pipeline's injected detector gives
# it, and in fractions of the frame, as the classic helper's
CLIP_FRAMES = 6
CLIP_LANDMARKS = [TEMPLATE * 0.4 + np.array([230.0, 120.0], np.float32)]
CLIP_FACES = [lm / [683.0, 512.0] for lm in CLIP_LANDMARKS]


def _write_clip(path):
    """A seeded mp4v clip whose blocks move 4 px a frame."""
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*'mp4v'), 24.0,
                         (128, 96))
    assert vw.isOpened()
    rng = np.random.default_rng(5)
    lo = rng.uniform(30, 220, (12, 20, 3))
    big = np.repeat(np.repeat(lo, 8, 0), 8, 1).astype(np.uint8)
    for i in range(CLIP_FRAMES):
        vw.write(np.ascontiguousarray(big[:, 4 * i:4 * i + 128]))
    vw.release()


def _read_clip(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    ok, f = cap.read()
    while ok:
        frames.append(f)
        ok, f = cap.read()
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return frames, fps


@pytest.mark.parametrize('route', ['fused', 'classic'])
def test_cli_on_a_clip(tmp_path, monkeypatch, restorers, route):
    jr, pr = restorers
    clip = tmp_path / 'clip.mp4'
    _write_clip(clip)
    decoded, fps = _read_clip(clip)
    assert len(decoded) == CLIP_FRAMES and fps == 24.0
    written = []
    real_writer = pvu.make_video_writer

    def recording_writer(*a, **kw):
        writer = real_writer(*a, **kw)
        write = writer.write_frame

        def record(frame):
            written.append(np.array(frame))
            write(frame)
        writer.write_frame = record
        return writer

    monkeypatch.setattr(pvu, 'make_video_writer', recording_writer)
    monkeypatch.setattr(pipeline, 'CodeFormerRestorer', lambda **kw: pr)
    if route == 'fused':
        monkeypatch.setattr(pfh, 'FaceRestoreHelper', lambda *a, **kw:
                            _Helper(_PInjected(CLIP_LANDMARKS), False))
        flags = []
    else:
        monkeypatch.setattr(pfh, 'FaceRestoreHelper', lambda *a, **kw:
                            _helper(pfh, CLIP_FACES, device='cpu'))
        flags = ['--fused_pipeline', 'off']
    out = tmp_path / 'out'
    pcli.main(['-i', str(clip), '-o', str(out), '--random-init',
               '--device', 'cpu', *flags])
    if route == 'fused':
        ref = pdp.DeviceRestorePipeline(
            pr, _Helper(_PInjected(CLIP_LANDMARKS), False), upscale=2,
            w=0.5).restore_frames(decoded)
        jref = jdp.DeviceRestorePipeline(
            jr, _Helper(_JInjected(CLIP_LANDMARKS), False), upscale=2,
            w=0.5).restore_frames(decoded)
    else:
        ref = pvideo.restore_video_frames(
            list(decoded), pr, _helper(pfh, CLIP_FACES, device='cpu'),
            w=0.5, upscale=2)
        jref = jvideo.restore_video_frames(
            list(decoded), jr, _helper(jfh, CLIP_FACES), w=0.5, upscale=2)
    assert len(written) == len(ref) == len(jref) == CLIP_FRAMES
    for got, want, jwant in zip(written, ref, jref):
        assert got.shape == (1024, 1366, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        diff = _diff(got, np.asarray(jwant))
        assert diff.mean() <= FRAME_MEAN_BOUND, diff.mean()
        assert diff.max() <= FRAME_MAX_BOUND, diff.max()
    plain = cv2.resize(decoded[0], (1366, 1024),
                       interpolation=cv2.INTER_LINEAR)
    assert _diff(written[0], plain).max() > 30    # the face was pasted
    again, fps = _read_clip(out / 'clip.mp4')
    assert len(again) == CLIP_FRAMES and fps == 24.0
    assert again[0].shape == (1024, 1366, 3)


def test_stage2_from_pngs_with_generated_latent_gt(tmp_path, monkeypatch):
    """generate_latent_gt's main (the tiny VQGAN of the yml, seeded) on
    the yml's PNGs writes the latent_gt_path; the port's FFHQBlindDataset
    on those files gives the JAX dataset's items (degradations and codes);
    train_pipeline takes 2 iterations on them whose code targets are the
    file's maps, with finite losses."""
    from codeformer_tpu_torch.train.train import train_pipeline
    yml = _tiny_yml(tmp_path)
    opt = yaml.safe_load(yml.read_text())
    root = opt['datasets']['train']['dataroot_gt']
    tiny = {k: v for k, v in TINY_VQGAN.items() if k != 'type'}
    build = glg.build_vqgan
    monkeypatch.setattr(glg, 'build_vqgan', lambda net_opt, ckpt, **kw:
                        build(dict(tiny, **net_opt), ckpt, **kw))
    pth = glg.main(['-i', root, '-o', str(tmp_path / 'latent'),
                    '--codebook_size', '32', '--batch', '2', '--device',
                    'cpu', '--random-init', '--ckpt_path',
                    str(tmp_path / 'missing.pth')])
    blob = torch.load(pth, weights_only=True)
    assert sorted(blob['orig']) == [f'{i:05d}' for i in range(4)]
    opt['datasets']['train']['latent_gt_path'] = pth
    yml.write_text(yaml.safe_dump(opt))

    ds_opt = dict(opt['datasets']['train'], phase='train', seed=7)
    jds, pds = jdata.build_dataset(ds_opt), pdata.build_dataset(ds_opt)
    for n, idx in enumerate((0, 3)):
        np.random.seed(n)
        a = jds[idx]
        np.random.seed(n)
        b = pds[idx]
        for k in ('gt', 'in', 'latent_gt'):
            np.testing.assert_array_equal(b[k], np.asarray(a[k]), err_msg=k)
        name = os.path.basename(b['gt_path'])[:-4]
        assert any(np.array_equal(b['latent_gt'], blob[key][name].numpy()
                                  .ravel()) for key in ('orig', 'hflip'))

    seen = []
    idx_gt = trainers.CodeFormerIdxModel._idx_gt

    def spy(self, mb):
        assert 'latent_gt' in mb          # the HQ encoder does not run
        seen.append(idx_gt(self, mb))
        return seen[-1]

    monkeypatch.setattr(trainers.CodeFormerIdxModel, '_idx_gt', spy)
    model = train_pipeline(str(tmp_path), ['-opt', str(yml)])
    assert len(seen) == 2
    maps = {m.numpy().ravel().tobytes() for key in ('orig', 'hflip')
            for m in blob[key].values()}
    for codes in seen:
        assert all(row.numpy().astype(np.int32).tobytes() in maps
                   for row in codes)
    assert np.isfinite(model.log_dict['l_g_total'])

"""The three training stages from PNGs on disk, each from the files the
stage before it wrote, as a user trains them, at tiny widths on the CPU:

- stage I (options/VQGAN_512_ds32_nearest_stage1.yml) through
  `train_pipeline` -> generate_latent_gt's `main` with stage I's net_g
  -> stage II (CodeFormer_stage2.yml) with that VQGAN and those codes ->
  stage III (CodeFormer_stage3.yml) from stage II's net_g, stage I's
  net_d and stage I's VQGAN. `--force_yml` narrows the ymls' widths
  (nf, ch_mult, the codebook, the transformer) and sets 64^2 images,
  fp32 and the CPU; the batches, losses and schedules stay the ymls';
- the saved networks read by the JAX package: stage I's net_g through
  `codeformer_tpu/utils/convert.py torch_state_dict_to_flax` into JAX's
  VQAutoEncoder (the codes exactly, the reconstruction within 1e-4) and
  stage III's net_g into JAX's CodeFormer (within 1e-4);
- a resumed run (`resume_training` from a `.state` file) of
  CodeFormerJointModel and CodeFormerModel: its state bit-equal to the
  trainer that saved it, and one step after the resume equal to the
  uninterrupted run's step, bit for bit;
- the ymls' own dataset blocks (stage III's joint dataset with its large
  degradation, colorization's jitter and gray augments, inpainting's
  brush masks) on the same files against the JAX package's datasets;
- the native degradation kernel the datasets use: built without
  OpenMP, so also where the compiler has none, equal to the JAX
  package's, and built once while the loader's workers wait for it.

LPIPS reads seeded VGG16 and lin stand-ins written under weights/vgg of
the run's working directory (tests/test_torch_perceptual.py).
"""
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip('cv2')
yaml = pytest.importorskip('yaml')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from codeformer_tpu import data as jdata  # noqa: E402
from codeformer_tpu.data import native as jnative  # noqa: E402
from codeformer_tpu.models import CodeFormer as JCodeFormer  # noqa: E402
from codeformer_tpu.models import VQAutoEncoder as JVQAutoEncoder  # noqa: E402
from codeformer_tpu.utils.convert import torch_state_dict_to_flax  # noqa: E402
from codeformer_tpu_torch import data as pdata  # noqa: E402
from codeformer_tpu_torch.cli import generate_latent_gt as glg  # noqa: E402
from codeformer_tpu_torch.data import native as pnative  # noqa: E402
from codeformer_tpu_torch.models import CodeFormer, VQAutoEncoder  # noqa: E402
from codeformer_tpu_torch.train import train as tt  # noqa: E402
from codeformer_tpu_torch.train.trainers import build_model  # noqa: E402
from codeformer_tpu_torch.utils.convert import load_pth  # noqa: E402
from test_torch_perceptual import lin_state_dict, vgg_state_dict  # noqa: E402

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
VQ = dict(img_size=SIZE, nf=32, ch_mult=[1, 2, 4], codebook_size=32,
          emb_dim=16)
CF = dict(dim_embd=32, n_head=4, n_layers=2, codebook_size=32,
          latent_size=256, connect_list=['32', '64'], img_size=SIZE, nf=32,
          ch_mult=[1, 2, 4], emb_dim=16)
D = dict(ndf=8, n_layers=2)
NARROW = {  # yml: the blocks --force_yml narrows
    'VQGAN_512_ds32_nearest_stage1.yml': {'network_g': VQ, 'network_d': D},
    'CodeFormer_stage2.yml': {'network_g': CF, 'network_vqgan': VQ},
    'CodeFormer_stage3.yml': {'network_g': CF, 'network_vqgan': VQ,
                              'network_d': D},
    'CodeFormer_colorization.yml': {'network_g': CF, 'network_vqgan': VQ},
    'CodeFormer_inpainting.yml': {'network_g': CF, 'network_vqgan': VQ,
                                  'network_d': D},
}
ITERS = 2
# the saved networks in the JAX package against the port, fp32
JAX_TOL = dict(rtol=1e-4, atol=1e-4)


def argv(yml, root, iters, *force):
    """The training entry point's argv for options/`yml` on the PNGs under
    `root`, narrowed, fp32 on the CPU, a log line an iteration."""
    narrow = [f'{block}:{k}={v}' for block, keys in NARROW[yml].items()
              for k, v in keys.items()]
    return ['-opt', os.path.join(ROOT, 'options', yml), '--force_yml',
            f'datasets:train:dataroot_gt={root}/ffhq', 'device=cpu',
            f'datasets:train:gt_size={SIZE}', f'datasets:train:in_size={SIZE}',
            f'train:total_iter={iters}', 'logger:print_freq=1',
            'logger:use_tb_logger=false', *narrow, *force]


def _pngs(folder, n=4, seed=0):
    folder.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        lo = rng.uniform(0, 255, (8, 8, 3))
        img = cv2.resize(lo, (SIZE, SIZE), interpolation=cv2.INTER_CUBIC)
        img = img + rng.normal(0, 8, img.shape)
        cv2.imwrite(str(folder / f'{i:05d}.png'),
                    np.clip(img, 0, 255).astype(np.uint8))


def _workdir(root):
    """PNGs and the LPIPS stand-ins under `root`."""
    _pngs(root / 'ffhq')
    vgg = root / 'weights' / 'vgg'
    vgg.mkdir(parents=True)
    rng = np.random.default_rng(3)
    torch.save(vgg_state_dict(rng, 'vgg16'), vgg / 'vgg16.pth')
    torch.save(lin_state_dict(rng), vgg / 'lpips_vgg.pth')


def _models(root, name):
    return root / 'experiments' / name / 'models'


@pytest.fixture(scope='module')
def chain(tmp_path_factory):
    """Stage I -> generate_latent_gt -> stage II -> stage III, each from
    the last one's files. Returns the root and the trainers."""
    root = tmp_path_factory.mktemp('chain')
    _workdir(root)
    old = os.getcwd()
    build = glg.build_vqgan
    os.chdir(root)
    try:
        s1 = tt.train_pipeline(str(root), argv(
            'VQGAN_512_ds32_nearest_stage1.yml', root, ITERS,
            'train:net_d_start_iter=1', 'logger:save_checkpoint_freq=1'))
        g1 = str(_models(root, s1.opt['name']) / 'net_g_latest.pth')
        glg.build_vqgan = lambda net_opt, ckpt, **kw: build(
            dict(VQ, **net_opt), ckpt, **kw)
        latent = glg.main(['-i', str(root / 'ffhq'), '-o',
                           str(root / 'latent'), '--codebook_size', '32',
                           '--batch', '2', '--device', 'cpu', '--ckpt_path',
                           g1])
        s2 = tt.train_pipeline(str(root), argv(
            'CodeFormer_stage2.yml', root, ITERS,
            f'datasets:train:latent_gt_path={latent}',
            f'network_g:vqgan_path={g1}', f'path:pretrain_network_vqgan={g1}'))
        g2 = str(_models(root, s2.opt['name']) / 'net_g_latest.pth')
        d1 = str(_models(root, s1.opt['name']) / 'net_d_latest.pth')
        s3 = tt.train_pipeline(str(root), argv(
            'CodeFormer_stage3.yml', root, ITERS,
            f'path:pretrain_network_g={g2}', f'path:pretrain_network_d={d1}',
            f'path:pretrain_network_vqgan={g1}'))
    finally:
        glg.build_vqgan = build
        os.chdir(old)
    return {'root': root, 's1': s1, 's2': s2, 's3': s3, 'g1': g1, 'g2': g2,
            'd1': d1, 'latent': latent,
            'g3': str(_models(root, s3.opt['name']) / 'net_g_latest.pth')}


def _faces(n=2, seed=4):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


def test_chain_stage1_to_stage3_from_pngs(chain):
    """Every stage wrote its files and logged finite losses; stage II's
    frozen HQ VQGAN is stage I's net_g; stage III's quantize and generator
    are bit-equal to stage II's, which it loaded, and its other trainable
    tensors moved; the latent file holds every PNG's codes."""
    root = chain['root']
    for key in ('s1', 's2', 's3'):
        t = chain[key]
        models = _models(root, t.opt['name'])
        states = models.parent / 'training_states'
        assert (models / 'net_g_latest.pth').exists()
        assert (states / 'latest.state').exists()
        assert t.step == ITERS
        assert all(np.isfinite(v) for v in t.log_dict.values()), key
    assert (_models(root, chain['s1'].opt['name']) / 'net_g_1.pth').exists()
    assert chain['s1'].step_d == ITERS - 1
    g1 = load_pth(chain['g1'])
    for k, v in chain['s2'].hq_vqgan.state_dict().items():
        assert torch.equal(v, g1[k]), k
    blob = torch.load(chain['latent'], weights_only=True)
    assert sorted(blob['orig']) == [f'{i:05d}' for i in range(4)]
    loaded = load_pth(chain['g2'])
    saved = torch.load(chain['g3'], weights_only=True)['params']
    s3 = chain['s3']
    frozen = [k for k in saved if k.split('.')[0] in s3.fix_modules]
    assert frozen and all(torch.equal(saved[k], loaded[k]) for k in frozen)
    moved = [n for n, p in s3.net_g.named_parameters() if p.requires_grad
             and not torch.equal(saved[n], loaded[n])]
    assert len(moved) == sum(p.requires_grad
                             for p in s3.net_g.parameters())


def test_stage1_net_g_in_jax(chain):
    """Stage I's saved net_g, converted, gives JAX's VQAutoEncoder the
    port's codes exactly and its reconstruction within JAX_TOL."""
    sd = load_pth(chain['g1'])
    pm = VQAutoEncoder(**VQ).eval()
    pm.load_state_dict(sd)
    x = _faces()
    with torch.no_grad():
        out, _, stats = pm(torch.from_numpy(x).permute(0, 3, 1, 2))
    jm = JVQAutoEncoder(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in VQ.items()})
    out_j, _, stats_j = jax.jit(jm.apply)(torch_state_dict_to_flax(sd),
                                          jnp.asarray(x))
    np.testing.assert_array_equal(
        stats['min_encoding_indices'].numpy(),
        np.asarray(stats_j['min_encoding_indices']))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(out_j), **JAX_TOL)


def test_stage3_net_g_in_jax(chain):
    """Stage III's saved net_g, converted, gives JAX's CodeFormer the
    port's logits, codes and restored faces within JAX_TOL (w = 0.5)."""
    sd = load_pth(chain['g3'])
    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in CF.items()}
    pm = CodeFormer(**cfg).eval()
    pm.load_state_dict(sd)
    x = _faces(seed=5)
    with torch.no_grad():
        out, logits, _ = pm(torch.from_numpy(x).permute(0, 3, 1, 2), 0.5)
    jm = JCodeFormer(**cfg)
    out_j, logits_j, _ = jax.jit(lambda v, x: jm.apply(v, x, 0.5))(
        torch_state_dict_to_flax(sd), jnp.asarray(x))
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(logits_j).argmax(-1))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               **JAX_TOL)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(out_j), **JAX_TOL)


def _state(t):
    """net_g, the EMA, net_d, both optimizers' states, step and step_d."""
    out = {f'g.{k}': v for k, v in t.net_g.state_dict().items()}
    out.update({f'ema.{k}': v for k, v in t.params_ema.items()})
    out.update({f'd.{k}': v for k, v in t.net_d.state_dict().items()})
    for name, o in (('opt_g', t.optimizer), ('opt_d', t.optimizer_d)):
        for i, st in o.state_dict()['state'].items():
            out.update({f'{name}.{i}.{k}': v for k, v in st.items()})
    out['step'], out['step_d'] = torch.tensor(t.step), torch.tensor(t.step_d)
    return out


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
            for k in ('in', 'gt', 'in_large_de')}


@pytest.mark.parametrize('yml,model_type', [
    ('CodeFormer_stage3.yml', 'CodeFormerJointModel'),
    ('CodeFormer_inpainting.yml', 'CodeFormerModel')])
def test_resume_equals_an_uninterrupted_run(tmp_path, monkeypatch, yml,
                                            model_type):
    """A trainer of the yml takes two steps and saves; a fresh trainer
    resumes from the .state file with every tensor and counter bit-equal;
    its next step equals the next step of the trainer that saved, bit for
    bit (net_g, the EMA, net_d and both optimizers)."""
    _workdir(tmp_path)
    monkeypatch.chdir(tmp_path)
    args = argv(yml, tmp_path, 4, 'train:net_d_start_iter=1',
                *(f'path:{k}=~' for k in ('pretrain_network_g',
                                          'pretrain_network_d',
                                          'pretrain_network_vqgan')))
    opt = tt.parse_options(str(tmp_path), args)
    a = build_model(opt)
    assert type(a).__name__ == model_type
    for it in (1, 2):
        a.feed_data(_batch(it))
        a.optimize_parameters(it)
    a.save(0, 2)
    b = build_model(tt.parse_options(str(tmp_path), args))
    assert b.resume_training(os.path.join(
        opt['path']['training_states'], '2.state')) == (0, 2)
    sa, sb = _state(a), _state(b)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for t in (a, b):
        t.feed_data(_batch(3))
        t.optimize_parameters(3)
    sa, sb = _state(a), _state(b)
    assert not torch.equal(sa['step'], torch.tensor(2))
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize('yml', ['CodeFormer_stage3.yml',
                                 'CodeFormer_colorization.yml',
                                 'CodeFormer_inpainting.yml'])
def test_yml_datasets_on_files_equal_jax(tmp_path, yml):
    """The yml's own dataset block (its degradations, stage III's large
    branch, colorization's jitter and gray augments, inpainting's brush
    masks) on the same PNGs: the port's items equal the JAX package's,
    seeded, on two visits of an index."""
    _pngs(tmp_path / 'ffhq')
    opt = tt.parse_options(str(tmp_path), argv(yml, tmp_path, 1))
    ds_opt = dict(opt['datasets']['train'], phase='train', seed=9)
    jds, pds = jdata.build_dataset(ds_opt), pdata.build_dataset(ds_opt)
    assert type(pds).__name__ == type(jds).__name__
    for n, idx in enumerate((1, 3, 1)):
        np.random.seed(n)       # the brush masks draw from numpy's global
        a = jds[idx]
        np.random.seed(n)
        b = pds[idx]
        assert set(a) == set(b)
        for k, v in a.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(b[k], v, err_msg=k)
            else:
                assert b[k] == v, k


def _fresh_native(monkeypatch, path):
    """The port's native module as a new process finds it, building into
    `path`."""
    monkeypatch.setattr(pnative, '_LIB_PATH', str(path))
    monkeypatch.setattr(pnative, '_lib', None)
    monkeypatch.setattr(pnative, '_tried', False)


def _degrade_inputs(seed=2):
    rng = np.random.default_rng(seed)
    k = rng.uniform(0, 1, (1, 9, 9)).astype(np.float32)
    return (rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32),
            k / k.sum(), np.array([[7, 7]], np.int32),
            np.array([0.05], np.float32))


def test_native_kernel_builds_where_the_compiler_has_no_openmp(
        tmp_path, monkeypatch):
    """A g++ without OpenMP (its -fopenmp fails, as on a machine whose
    compiler lacks libgomp) builds the degradation kernel, since the
    port's build asks for no OpenMP, and it gives the JAX package's
    native output: the datasets keep the native path instead of falling
    back to the cv2 one."""
    gxx = shutil.which('g++')
    fake = tmp_path / 'g++'
    fake.write_text('#!/bin/sh\nfor a in "$@"; do\n  if [ "$a" = -fopenmp ]; '
                    'then\n    echo "g++: fatal error: cannot read spec file '
                    '\'libgomp.spec\'" >&2\n    exit 1\n  fi\ndone\n'
                    f'exec {gxx} "$@"\n')
    fake.chmod(0o755)
    monkeypatch.setenv('CXX', str(fake))
    _fresh_native(monkeypatch, tmp_path / 'lib' / 'libcodeformer_native.so')
    lib = pnative.get_lib()
    assert lib is not None and lib.degrade_num_threads() == 1
    args = _degrade_inputs()
    got = pnative.degrade_batch_native(*args, in_size=64, seed=5)
    want = jnative.degrade_batch_native(*args, in_size=64, seed=5)
    np.testing.assert_array_equal(got, want)


def test_native_kernel_build_holds_the_other_workers(tmp_path, monkeypatch):
    """Loader workers that ask for the kernel while it builds wait for the
    build and get it, rather than take the cv2 path for their samples."""
    _fresh_native(monkeypatch, tmp_path / 'lib' / 'libcodeformer_native.so')
    build = pnative._build

    def slow(*a, **kw):
        time.sleep(0.5)
        return build(*a, **kw)
    monkeypatch.setattr(pnative, '_build', slow)
    got = []
    workers = [threading.Thread(target=lambda: got.append(pnative.get_lib()))
               for _ in range(3)]
    for t in workers:
        t.start()
    for t in workers:
        t.join(60)
    assert len(got) == 3 and all(lib is not None for lib in got)

"""The port's own host-side data and option modules (codeformer_tpu_torch
.data, utils/options.py) against the JAX package's, which they copy:
the same seed and the same images on disk give equal arrays, the loaders
give the same batches, and the option parser the same dict."""
import os.path as osp

import numpy as np
import pytest

cv2 = pytest.importorskip('cv2')
pytest.importorskip('yaml')

from codeformer_tpu import data as jdata  # noqa: E402
from codeformer_tpu.data import loader as jloader  # noqa: E402
from codeformer_tpu.utils.options import parse as jparse  # noqa: E402
from codeformer_tpu_torch import data as pdata  # noqa: E402
from codeformer_tpu_torch.data import loader as ploader  # noqa: E402
from codeformer_tpu_torch.utils.options import parse as pparse  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _images(folder, n, seed, size=64):
    folder.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        lo = rng.uniform(0, 255, (8, 8, 3))
        img = cv2.resize(lo, (size, size), interpolation=cv2.INTER_CUBIC)
        img = img + rng.normal(0, 8, img.shape)
        cv2.imwrite(str(folder / f'{i:05d}.png'),
                    np.clip(img, 0, 255).astype(np.uint8))
    return str(folder)


FFHQ_CASES = {
    'stage2': {},
    'jitter+gray': {'color_jitter_prob': 1.0, 'color_jitter_pt_prob': 1.0,
                    'gray_prob': 0.5},
    'inpaint': {'gen_inpaint_mask': True, 'use_corrupt': False},
}


@pytest.mark.parametrize('case', sorted(FFHQ_CASES))
def test_ffhq_blind_dataset_equals_jax(tmp_path, case):
    root = _images(tmp_path / 'gt', 3, seed=1)
    opt = {'type': 'FFHQBlindDataset', 'dataroot_gt': root,
           'io_backend': {'type': 'disk'}, 'in_size': 64, 'gt_size': 64,
           'use_hflip': True, 'use_corrupt': True, 'blur_kernel_size': 7,
           'kernel_list': ['iso', 'aniso'], 'kernel_prob': [0.5, 0.5],
           'blur_sigma': [1, 5], 'downsample_range': [2, 6],
           'noise_range': [0, 10], 'jpeg_range': [60, 90], 'seed': 7,
           **FFHQ_CASES[case]}
    jds = jdata.build_dataset(opt)
    pds = pdata.build_dataset(opt)
    assert type(pds).__module__.startswith('codeformer_tpu_torch.')
    assert len(pds) == len(jds) == 3
    for n, idx in enumerate((0, 2, 0)):     # a second visit draws anew
        # the brush-stroke masks draw from numpy's global generator
        np.random.seed(n)
        a = jds[idx]
        np.random.seed(n)
        b = pds[idx]
        assert set(a) == set(b)
        for k, v in a.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(b[k], v, err_msg=k)
            else:
                assert b[k] == v, k


def test_paired_image_dataset_and_loader_equal_jax(tmp_path):
    opt = {'type': 'PairedImageDataset',
           'dataroot_gt': _images(tmp_path / 'gt', 4, seed=2),
           'dataroot_lq': _images(tmp_path / 'lq', 4, seed=3),
           'batch_size_per_gpu': 2, 'num_worker_per_gpu': 2,
           'dataset_enlarge_ratio': 2}
    jds, pds = jdata.build_dataset(opt), pdata.build_dataset(opt)
    item_j, item_p = jds[1], pds[1]
    for k in ('lq', 'gt'):
        np.testing.assert_array_equal(item_p[k], item_j[k])
    assert list(ploader.EnlargedSampler(4, 2, 1, 3)) == \
        list(jloader.EnlargedSampler(4, 2, 1, 3))
    batches = []
    for ds, ld in ((jds, jloader), (pds, ploader)):
        it = iter(ld.build_dataloader(ds, opt, sampler=ld.EnlargedSampler(
            len(ds), 1, 0, 2)))
        batches.append([next(it) for _ in range(5)])
    for bj, bp in zip(*batches):
        assert bp['gt_path'] == bj['gt_path']
        np.testing.assert_array_equal(bp['lq'], bj['lq'])


def test_options_parse_equals_jax(tmp_path):
    yml = osp.join(ROOT, 'options', 'CodeFormer_stage2.yml')
    got = pparse(yml, str(tmp_path), is_train=True)
    assert got == jparse(yml, str(tmp_path), is_train=True)
    assert got['model_type'] == 'CodeFormerIdxModel'
    assert got['datasets']['train']['phase'] == 'train'
    assert got['path']['models'] == osp.join(str(tmp_path), 'experiments',
                                             got['name'], 'models')


class _Numbered:
    """A dataset whose item is its own index."""

    def __len__(self):
        return 6

    def __getitem__(self, i):
        return {'i': np.array([i])}


def _first_batches(ld, n):
    it = iter(ld)
    try:
        return [next(it)['i'][:, 0].tolist() for _ in range(n)]
    finally:
        it.close()


@pytest.mark.parametrize('start_epoch', [0, 1, 3])
def test_loader_start_epoch_resumes_the_epoch_order(start_epoch):
    """A loader built with start_epoch=e yields, from its first batch on,
    what an uninterrupted loader yields after e epochs; with the default
    it is the JAX copy's loader, batch for batch."""
    opt = {'batch_size_per_gpu': 2, 'num_worker_per_gpu': 2,
           'dataset_enlarge_ratio': 2}
    per_epoch = 6 * 2 // 2

    def loader(ld, **kw):
        return ld.build_dataloader(
            _Numbered(), opt, sampler=ld.EnlargedSampler(6, 1, 0, 2), **kw)
    whole = _first_batches(loader(ploader), per_epoch * (start_epoch + 2))
    assert whole == _first_batches(loader(jloader), len(whole))
    resumed = _first_batches(loader(ploader, start_epoch=start_epoch),
                             2 * per_epoch)
    assert resumed == whole[per_epoch * start_epoch:]


def test_device_prefetcher_is_an_identity_stage_on_the_cpu():
    """DevicePrefetcher on a CPU device hands the loader's batches on in
    order with their values unchanged (on the card it stages them a step
    ahead on a side stream); its length is the loader's. The loader
    module imports without cv2, so the card's machine can import it."""
    import subprocess
    import sys
    opt = {'batch_size_per_gpu': 2, 'num_worker_per_gpu': 2}

    def batches(stage):
        ld = ploader.build_dataloader(_Numbered(), opt,
                                      sampler=ploader.EnlargedSampler(6))
        ld.loop = False
        src = ploader.DevicePrefetcher(ld, 'cpu') if stage else ld
        assert len(src) == 3
        return list(src)
    want, got = batches(False), batches(True)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        np.testing.assert_array_equal(g['i'], w['i'])
    out = subprocess.run(
        [sys.executable, '-c', 'import sys; import codeformer_tpu_torch.'
         'data.loader as l; print(l.DevicePrefetcher.__name__, '
         '"cv2" in sys.modules)'],
        cwd=osp.dirname(osp.dirname(osp.abspath(__file__))),
        capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ['DevicePrefetcher', 'False'], out.stderr

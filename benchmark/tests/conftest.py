"""Fixtures of the benchmark's CPU tests: a small CodeFormer topology
(the released block structure at narrow widths, 64^2 faces) and a
BENCHMARK.json-shaped dict naming its cell. Tests that need the card
carry the `card` marker and skip without one (decided in a fixture, not
at import)."""
import copy
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

TINY_ARCH = dict(dim_embd=64, n_head=4, n_layers=2, codebook_size=64,
                 latent_size=64, connect_list=['16', '32'], img_size=64,
                 nf=32, ch_mult=[1, 2, 2, 4], res_blocks=1,
                 attn_resolutions=[16], emb_dim=32)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs a CUDA card (skipped without one)')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels run only there')


@pytest.fixture
def bench():
    with open(ROOT / 'BENCHMARK.json') as f:
        return json.load(f)


@pytest.fixture
def tiny_cfg():
    with open(ROOT / 'benchmark' / 'configs' / 'codeformer.json') as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg['arch'] = dict(TINY_ARCH)
    return cfg


@pytest.fixture
def tiny_traffic():
    return dict(entry='restore_device', batch=4,
                pool=8, max_requests=6, warmup_requests=1, check_requests=3)


def tiny_photos(entry: str):
    """The photo configuration at the small topology (64^2 faces, parsed
    at their own size) with small traffic: frames of 512 x 560 (the pipeline's least short side),
    chunks of 2, one face a frame scaled up so its eyes lie past the
    pipeline's 5 px threshold."""
    with open(ROOT / 'benchmark' / 'configs' / 'codeformer_photos.json') as f:
        cfg = json.load(f)
    cfg['arch'] = dict(TINY_ARCH)
    cfg['parse_res'] = TINY_ARCH['img_size']
    name = 'stream_4faces' if entry == 'restore_frames_stream' \
        else 'single_1face'
    with open(ROOT / 'benchmark' / 'traffic' / f'{name}.json') as f:
        traffic = json.load(f)
    traffic.update(frame_hw=[512, 560], faces_per_frame=1,
                   face_offsets=[[-60.0, -60.0]], face_scale=3.0, chunk=2,
                   clip_frames=4, max_requests=3, warmup_requests=1,
                   check_requests=1)
    return cfg, traffic

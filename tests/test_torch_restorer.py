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
from codeformer_tpu_torch.pipeline import restorer as restorer_mod  # noqa: E402
from codeformer_tpu_torch.pipeline.restorer import (  # noqa: E402
    CodeFormerRestorer, check_serving_dtype)
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


class _Built(Exception):
    """Raised in place of building the model: the dtype gate passed."""


@pytest.mark.parametrize('dtype', [torch.float32, torch.float16])
def test_cuda_restorer_refuses_non_bf16(dtype):
    """On a CUDA device the restorer serves bf16 (the kernels) and fp32
    (the plain path). fp16 is refused when the restorer is built, before
    any model or device is touched, instead of every request failing
    into the passthrough. fp32 passes the gate (`check_serving_dtype`,
    the constructor's first step) and reaches the model's construction,
    stubbed here: this host has no card to build it on."""
    with mock.patch.object(restorer_mod, 'CodeFormer',
                           side_effect=_Built) as build:
        if dtype == torch.float16:
            with pytest.raises(ValueError, match='bfloat16'):
                check_serving_dtype('cuda', dtype)
            with pytest.raises(ValueError, match='bfloat16'):
                CodeFormerRestorer(device='cuda', dtype=dtype)
            assert build.call_count == 0
        else:
            check_serving_dtype('cuda', dtype)
            check_serving_dtype('cuda:0', torch.bfloat16)
            with pytest.raises(_Built):
                CodeFormerRestorer(device='cuda', dtype=dtype)
            assert build.call_count == 1


def _tiny_codeformer(**arch):
    """The tiny topology in place of the restorer's full-width one."""
    return CodeFormer(**TINY)


@pytest.mark.parametrize('flags,dtype,quant', [
    (['--dtype', 'fp32'], torch.float32, None),
    ([], torch.bfloat16, None)])
def test_cli_dtype_flag_builds_the_restorer(tmp_path, flags, dtype, quant):
    """`--dtype fp32` parses (the JAX CLI's flag) and the restorer that
    `main` builds at --device cpu computes in float32 on the plain path
    (kernels off) and restores; the default stays bf16. The model is the
    tiny topology (`CodeFormer` stubbed), run_aligned replaced by a
    capture."""
    from codeformer_tpu_torch.cli import inference_codeformer as cli
    argv = ['--has_aligned', '-i', str(tmp_path / 'x.png'), '--device',
            'cpu', '--random-init', '-o', str(tmp_path / 'out')] + flags
    args = cli.build_parser().parse_args(argv)
    assert args.dtype == ('fp32' if flags else 'bf16')
    got = {}
    with mock.patch.object(restorer_mod, 'CodeFormer', _tiny_codeformer), \
            mock.patch.object(cli, 'run_aligned',
                              lambda a, paths, root, r: got.update(r=r)):
        cli.main(argv)
    r = got['r']
    assert r.dtype == dtype and r.quant == quant
    assert r.device == torch.device('cpu')
    kernels = {m.use_kernels for m in r.model.modules()
               if hasattr(m, 'use_kernels')}
    assert kernels == {dtype == torch.bfloat16}
    out = r.restore_device(np.stack(_faces(7, 2)), w=0.5)
    assert out.shape == (2, 64, 64, 3) and out.dtype == torch.uint8


@pytest.mark.parametrize('n,buckets', [(2, (1, 2, 4, 8, 16)), (2, (8,)),
                                       (3, (1, 2, 4, 8, 16))])
def test_multi_device_buckets_round_as_jax(n, buckets):
    """Buckets are rounded to multiples of the device count exactly as
    JAX's mesh restorer rounds them over its 'data' axis."""
    from codeformer_tpu.parallel import create_mesh
    jr = JaxRestorer(model=JaxCodeFormer(**TINY), dtype=jnp.float32,
                     face_size=64, batch_buckets=buckets,
                     mesh=create_mesh(n, model_parallel=1))
    pr = CodeFormerRestorer(devices=['cpu'] * n, dtype=torch.float32,
                            model=CodeFormer(**TINY), face_size=64,
                            batch_buckets=buckets)
    assert pr.batch_buckets == list(jr.batch_buckets)
    assert all(pr._bucket(k) == jr._bucket(k) for k in range(1, 40))


def test_multi_device_restorer_equals_one_device(restorers):
    """devices=['cpu', 'cpu'] against one device (the counterpart of
    tests/test_pipeline.py:67-108): 5 faces in a bucket of 8, fp32, each
    replica takes 4; the outputs are bit-equal, and restore_device
    gathers on devices[0]. Each replica keeps its own model."""
    _, pr = restorers
    state = pr.model.state_dict()
    one = CodeFormerRestorer(device='cpu', dtype=torch.float32,
                             model=CodeFormer(**TINY), face_size=64,
                             batch_buckets=(8,))
    one.model.load_state_dict(state)
    two = CodeFormerRestorer(devices=['cpu', 'cpu'], dtype=torch.float32,
                             model=CodeFormer(**TINY), face_size=64,
                             batch_buckets=(8,))
    two.model.load_state_dict(state)
    two.models[1].load_state_dict(state)
    assert two.models[0] is not two.models[1]
    assert two._bucket(5) == one._bucket(5) == 8
    faces = _faces(8, 5)
    for a, b in zip(two.restore_batch(faces, w=0.5),
                    one.restore_batch(faces, w=0.5)):
        np.testing.assert_array_equal(a, b)
    x = np.stack(_faces(9, 8))
    got = two.restore_device(x, w=0.7)
    assert got.device == torch.device('cpu')
    np.testing.assert_array_equal(got.numpy(),
                                  one.restore_device(x, w=0.7).numpy())
    with pytest.raises(ValueError, match='equal shards'):
        two.restore_device(x[:3])


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


def test_lookup_sees_one_fresh_index_tensor_a_forward(restorers):
    """A wrapper on quantize.get_codebook_feat built as the benchmark's
    CodeRecorder (benchmark/compare.py) sees exactly one index tensor a
    restore_device call, a distinct tensor each time; on the CPU every
    forward runs eagerly (graph_counts)."""
    _, pr = restorers
    pr.reset_graph_counts()
    seen = []
    lookup = pr.model.quantize.get_codebook_feat

    def recorded(indices, *a, **kw):
        seen.append(indices)
        return lookup(indices, *a, **kw)
    x = np.stack(_faces(10, 2))
    with mock.patch.object(pr.model.quantize, 'get_codebook_feat',
                           recorded):
        outs = [pr.restore_device(x, w=0.5) for _ in range(3)]
    assert len(seen) == 3
    assert len({t.data_ptr() for t in seen}) == 3
    assert all(torch.equal(t, seen[0]) for t in seen)
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert pr.graph_counts() == {'captures': 0, 'replays': 0, 'eager': 3}


def test_graphs_engage_on_one_cuda_device_only():
    """The rule: one CUDA device, outside eager_forwards(); the CPU and
    several devices stay eager. Decided from the restorer's devices (a
    stub: this host has no card to build a model on)."""
    r = CodeFormerRestorer.__new__(CodeFormerRestorer)
    r.devices = [torch.device('cuda:0')]
    r.device = r.devices[0]
    assert r.graphs_engage()
    with restorer_mod.eager_forwards():
        assert not r.graphs_engage()
    assert r.graphs_engage()
    r.devices = [torch.device('cuda:0'), torch.device('cuda:1')]
    assert not r.graphs_engage()
    r.devices = r.device = [torch.device('cpu')]
    r.device = r.devices[0]
    assert not r.graphs_engage()


class _FakeGraphs:
    """Stands in for ForwardGraphs on the CPU: records its key's w and
    the pool it was given (its own `pool()` is 'pool'), and its replays
    return a marker."""

    def __init__(self, restorer, x, quant_feat, w, adain, enable_fuse,
                 pool):
        self.w, self.given_pool, self.a = w, pool, self

    def pool(self):
        return 'pool'

    def run(self, model, x):
        return ('replayed', self.w)


def test_graph_keys_lru_and_model_state():
    """The first forward of a key runs eagerly (the output of the eager
    forward, bit for bit) and captures; later ones replay. At most
    GRAPH_KEYS keys stay, the least recently used dropped first, all in
    the pool of the first capture; an in-place update of a parameter, or
    a kernel switch, drops them all and the pool."""
    from codeformer_tpu_torch.nn.blocks import set_kernels
    pm = CodeFormer(**TINY).eval()
    r = CodeFormerRestorer(device='cpu', dtype=torch.float32, model=pm,
                           face_size=64, batch_buckets=BUCKETS)
    x = torch.from_numpy(np.stack(_faces(11, 1)))
    ws = [round(0.1 * i, 1) for i in range(restorer_mod.GRAPH_KEYS + 2)]
    with mock.patch.object(restorer_mod, 'ForwardGraphs', _FakeGraphs), \
            torch.inference_mode():
        first = r._graphed(x, ws[0], True, True)
        assert torch.equal(first, r._fwd(x, ws[0], True, True))
        for w in ws[1:]:
            r._graphed(x, w, True, True)
        assert r.graph_counts()['captures'] == len(ws)
        assert [k[1] for k in r._graphs] == ws[2:]
        assert {g.given_pool for g in r._graphs.values()} == {'pool'}
        assert r._graphed(x, ws[2], True, True) == ('replayed', ws[2])
        assert [k[1] for k in r._graphs][-1] == ws[2]
        assert r.graph_counts()['replays'] == 1
        assert r._graphed(x, ws[2], False, True) is not None   # a new key
        assert r.graph_counts()['captures'] == len(ws) + 1
        with torch.no_grad():
            pm.fuse_convs_dict['32'].shift[2].weight.mul_(1.0)
        assert isinstance(r._graphed(x, ws[2], True, True), torch.Tensor)
        assert len(r._graphs) == 1
        assert next(iter(r._graphs.values())).given_pool is None
        set_kernels(pm, True)       # fp32 serves with them off
        assert isinstance(r._graphed(x, ws[2], True, True), torch.Tensor)
        assert len(r._graphs) == 1
        assert r._graphed(x, ws[2], True, True) == ('replayed', ws[2])
        r.release_graphs()
        assert not r._graphs and r._graph_pool is None
        assert isinstance(r._graphed(x, ws[2], True, True), torch.Tensor)


@pytest.mark.parametrize('w', [0.0, 0.3, 0.5, 0.7, 1.0])
def test_fuse_weight_scalar_rounds_as_a_tensor(w):
    """FuseSftBlock multiplies by w rounded to the map's dtype as a Python
    scalar (nothing copied to the device, so a CUDA graph captures it):
    bf16 outputs equal those of w as a bf16 tensor."""
    torch.manual_seed(0)
    blk = FuseSftBlock(32, 32).eval()
    enc, dec = (torch.randn(2, 32, 8, 8).to(torch.bfloat16)
                .contiguous(memory_format=torch.channels_last)
                for _ in range(2))
    with torch.no_grad():
        got = blk(enc, dec, w)
        e = blk.encode_enc(torch.cat([enc, dec], dim=1))
        want = dec + torch.as_tensor(w, dtype=dec.dtype) * (
            dec * blk.scale(e) + blk.shift(e))
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)

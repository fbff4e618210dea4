"""The colorization and inpainting models and CLIs of the port, and the
repaired VQAutoEncoder.forward, against the JAX package.

The forwards run on a small topology with the released configurations'
distinguishing parts kept: the connect list 32/64/128 (no 256 fuse,
img_size 128 so all three sizes exist), codebook 1024 for colorization
and 512 for inpainting, each at its CLI's w and adain (colorization
w=0, AdaIN, no fuse block run; inpainting w=1, no AdaIN, every fuse
block run). fp32, the same weights through flax_to_state_dict, JAX with
colpack off; held as tests/test_torch_codeformer.py holds the
restoration model: 1e-4 abs + 1e-4 rel, the code indices equal.

Each CLI runs on its default input set with a stub restorer (as
tests/test_cli_fixtures.py runs the JAX CLIs) next to the JAX CLI with
the same stub: the same files with the same bytes.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

cv2 = pytest.importorskip('cv2')

from codeformer_tpu.models import CodeFormer as JCodeFormer  # noqa: E402
from codeformer_tpu.models import VQAutoEncoder as JVQAutoEncoder  # noqa: E402
from codeformer_tpu.nn.blocks import colpack_mode, set_colpack_mode  # noqa: E402
from codeformer_tpu.utils.checkpoint import init_params_fast  # noqa: E402
from codeformer_tpu_torch.cli import common  # noqa: E402
from codeformer_tpu_torch.models import CodeFormer  # noqa: E402
from codeformer_tpu_torch.models.vqgan import VQAutoEncoder  # noqa: E402
from codeformer_tpu_torch.utils.convert import flax_to_state_dict  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(img_size=128, nf=32, ch_mult=(1, 2, 2, 4), emb_dim=16,
             dim_embd=64, n_head=4, n_layers=2, latent_size=256,
             connect_list=('32', '64', '128'))
TASKS = {  # task: (codebook size, w, adain, enable_fuse), the CLIs' calls
    'colorization': (1024, 0.0, True, False),
    'inpainting': (512, 1.0, False, True),
}


@pytest.fixture(autouse=True, scope='module')
def _plain_groupnorm():
    """The JAX side on its plain XLA GroupNorm (another test file of the
    same process may have left the global mode elsewhere)."""
    prev = colpack_mode()
    set_colpack_mode('off')
    yield
    set_colpack_mode(prev)


def _perturbed(model, x, seed, *args):
    """init_params_fast, then non-trivial norm affines, biases and
    position embedding, so every parameter kind matters."""
    v = init_params_fast(model, jnp.asarray(x), *args, seed=seed)
    rng = np.random.default_rng(seed + 100)

    def bump(path, leaf):
        name = str(getattr(path[-1], 'key', ''))
        if name in ('scale', 'bias', 'in_proj_bias', 'position_emb'):
            return leaf + 0.1 * rng.standard_normal(leaf.shape).astype(
                leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(bump, v)


def _tame_sft(v, factor=1e-2):
    """Scale the SFT branches' last convs (scale_2, shift_2) by `factor`,
    as chip_smoke.tame_sft does: with random weights each fusion
    multiplies the activations by their own size, three fusions take
    them to about 6e10 at this topology, and the tail GroupNorm then
    keeps only the rounding noise of both sides. Trained weights keep
    activations in range."""
    def tame(path, leaf):
        keys = [str(getattr(k, 'key', '')) for k in path]
        if keys[-1] == 'kernel' and keys[-2] in ('scale_2', 'shift_2'):
            return leaf * factor
        return leaf
    return jax.tree_util.tree_map_with_path(tame, v)


@pytest.mark.parametrize('task', sorted(TASKS))
def test_task_forward_matches_jax(task):
    codebook, w, adain, enable_fuse = TASKS[task]
    cfg = dict(SMALL, codebook_size=codebook)
    x = np.random.default_rng(6).normal(0, 0.3, (1, 128, 128, 3)) \
        .astype(np.float32)
    jm = JCodeFormer(**cfg)
    v = _tame_sft(_perturbed(jm, x, 5, 0.5))
    out_j, logits_j, lq_j = map(np.asarray, jax.jit(
        lambda v, x: jm.apply(v, x, w, adain=adain,
                              enable_fuse=enable_fuse))(v, jnp.asarray(x)))
    pm = CodeFormer(**cfg).eval()
    pm.load_state_dict(flax_to_state_dict(v))
    assert sorted(pm.fuse_convs_dict) == ['128', '32', '64']
    assert pm.quantize.embedding.weight.shape == (codebook, 16)
    with torch.no_grad():
        out, logits, lq = pm(torch.from_numpy(x).permute(0, 3, 1, 2), w,
                             adain=adain, enable_fuse=enable_fuse)
    assert logits.shape == logits_j.shape == (1, 256, codebook)
    np.testing.assert_allclose(logits.numpy(), logits_j, **TOL)
    np.testing.assert_allclose(lq.permute(0, 2, 3, 1).numpy(), lq_j, **TOL)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  logits_j.argmax(-1))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), out_j,
                               **TOL)


def test_vq_autoencoder_forward_matches_jax():
    """encode -> quantize -> decode: the reconstruction, the codebook
    loss and the quantizer statistics (same keys as JAX), fp32."""
    cfg = dict(img_size=64, nf=32, ch_mult=(1, 2, 4), codebook_size=64,
               emb_dim=16)
    x = np.random.default_rng(2).normal(0, 0.3, (2, 64, 64, 3)) \
        .astype(np.float32)
    jm = JVQAutoEncoder(**cfg)
    v = _perturbed(jm, x, 7)
    out_j, loss_j, stats_j = jax.jit(jm.apply)(v, jnp.asarray(x))
    pm = VQAutoEncoder(**cfg).eval()
    pm.load_state_dict(flax_to_state_dict(v))
    with torch.no_grad():
        out, loss, stats = pm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.shape == (2, 3, 64, 64)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(out_j), **TOL)
    np.testing.assert_allclose(float(loss), float(loss_j), **TOL)
    assert sorted(stats) == sorted(stats_j)
    np.testing.assert_array_equal(stats['min_encoding_indices'].numpy(),
                                  np.asarray(stats_j['min_encoding_indices']))
    for key in ('perplexity', 'mean_distance'):
        np.testing.assert_allclose(float(stats[key]), float(stats_j[key]),
                                   **TOL)


def test_vq_autoencoder_refuses_gumbel():
    """The Gumbel quantizer, refused until stage I was ported, now builds
    with the reference's names (quantize.proj, quantize.embed) and runs
    the eval forward (tests/test_torch_gan.py holds it against JAX)."""
    from codeformer_tpu_torch.models.vqgan import GumbelQuantizer
    m = VQAutoEncoder(img_size=64, nf=32, ch_mult=(1, 2, 4),
                      codebook_size=32, emb_dim=16,
                      quantizer='gumbel').eval()
    assert isinstance(m.quantize, GumbelQuantizer)
    assert {'quantize.proj.weight', 'quantize.proj.bias',
            'quantize.embed.weight'} <= set(m.state_dict())
    with torch.no_grad():
        out, loss, stats = m(torch.zeros(1, 3, 64, 64))
    assert out.shape == (1, 3, 64, 64) and torch.isfinite(loss)
    assert stats['min_encoding_indices'].shape == (1, 16, 16)


# ---------------------------------------------------------------------------
# the two CLIs
# ---------------------------------------------------------------------------
class _StubRestorer:
    """CodeFormerRestorer stand-in: inverts the faces; records the
    construction kwargs and each restore_batch call."""
    last_kwargs = None
    calls = []

    def __init__(self, **kw):
        _StubRestorer.last_kwargs = kw

    def restore_batch(self, faces, w=0.5, adain=True, enable_fuse=None):
        _StubRestorer.calls.append((len(faces), w, adain))
        return [(255 - np.asarray(f)).astype(np.uint8) for f in faces]


@pytest.fixture
def fresh_checkout(tmp_path, monkeypatch):
    """cwd with the repo's inputs/ visible at ./inputs (default paths)."""
    os.symlink(os.path.join(REPO, 'inputs'), str(tmp_path / 'inputs'))
    monkeypatch.chdir(tmp_path)
    _StubRestorer.calls = []
    return tmp_path


def _run_both(task, monkeypatch, tmp_path):
    """The port's CLI into results/, the JAX CLI into jax_results/, both
    on the default input set with the stub restorer."""
    import importlib

    import codeformer_tpu_torch.pipeline as pipeline
    jcli = importlib.import_module(f'codeformer_tpu.cli.inference_{task}')
    pcli = importlib.import_module(
        f'codeformer_tpu_torch.cli.inference_{task}')
    monkeypatch.setattr(pipeline, 'CodeFormerRestorer', _StubRestorer)
    pcli.main(['--random-init'])
    port_kwargs = _StubRestorer.last_kwargs
    monkeypatch.setattr(jcli, 'CodeFormerRestorer', _StubRestorer)
    jcli.main(['--random-init', '-o', str(tmp_path / 'jax_results')])
    return port_kwargs


@pytest.mark.parametrize('task,src,codebook,w,adain', [
    ('colorization', 'gray_faces', 1024, 0.0, True),
    ('inpainting', 'masked_faces', 512, 1.0, False)])
def test_task_cli_default_layout(fresh_checkout, monkeypatch, task, src,
                                 codebook, w, adain):
    kw = _run_both(task, monkeypatch, fresh_checkout)
    out = fresh_checkout / 'results' / src
    names = sorted(os.listdir(os.path.join(REPO, 'inputs', src)))
    assert sorted(os.listdir(out)) == \
        [os.path.splitext(n)[0] + '.png' for n in names]
    assert sorted(os.listdir(fresh_checkout / 'jax_results')) == \
        sorted(os.listdir(out))
    for name in os.listdir(out):
        np.testing.assert_array_equal(
            cv2.imread(str(out / name)),
            cv2.imread(str(fresh_checkout / 'jax_results' / name)))
    assert kw['codebook_size'] == codebook
    assert kw['connect_list'] == ('32', '64', '128')
    assert kw['dim_embd'] == 512 and kw['n_layers'] == 9
    assert kw['device'] == 'cuda' and kw['dtype'] == torch.bfloat16
    assert _StubRestorer.calls[0] == (len(names), w, adain)
    if task == 'inpainting':
        # masked (pure-white) pixels take the model output, the others
        # keep the input (reference inference_inpainting.py:75-77)
        name = sorted(os.listdir(out))[0]
        comp = cv2.imread(str(out / name))
        orig = cv2.imread(os.path.join(REPO, 'inputs', src, names[0]))
        white = (orig == 255).all(axis=-1)
        assert white.any()
        np.testing.assert_array_equal(comp[~white], orig[~white])
        assert (comp[white] == 0).all()  # the stub turns white to 0


@pytest.mark.parametrize('task', sorted(TASKS))
def test_task_cli_suffix_dtype_and_size_check(tmp_path, monkeypatch, task):
    import importlib

    import codeformer_tpu_torch.pipeline as pipeline
    pcli = importlib.import_module(
        f'codeformer_tpu_torch.cli.inference_{task}')
    monkeypatch.setattr(pipeline, 'CodeFormerRestorer', _StubRestorer)
    img = np.random.default_rng(0).integers(0, 256, (512, 512, 3),
                                            dtype=np.uint8)
    cv2.imwrite(str(tmp_path / 'a.png'), img)
    pcli.main(['-i', str(tmp_path / 'a.png'), '-o', str(tmp_path / 'o'),
               '--suffix', 'x', '--dtype', 'fp32', '--device', 'cpu',
               '--random-init'])
    assert os.listdir(tmp_path / 'o') == ['a_x.png']
    assert _StubRestorer.last_kwargs['dtype'] == torch.float32
    assert _StubRestorer.last_kwargs['device'] == 'cpu'
    cv2.imwrite(str(tmp_path / 'a.png'), img[:256])
    with pytest.raises(ValueError, match=f'512x512 for {task}'):
        pcli.main(['-i', str(tmp_path / 'a.png'), '--random-init'])


def test_common_lists_and_resolves(tmp_path, monkeypatch, capsys):
    assert common.list_inputs('a/b.png', None, 'test_colorization_img') == \
        (['a/b.png'], 'results/test_colorization_img', False)
    assert common.list_inputs('a/b.png', 0.7) == \
        (['a/b.png'], 'results/test_img_0.7', False)
    monkeypatch.chdir(tmp_path)
    for task, path in common.WEIGHT_FILES.items():
        assert common.resolve_checkpoint(None, task, True) is None
        with pytest.raises(SystemExit):
            common.resolve_checkpoint(None, task, False)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, 'wb').close()
        assert common.resolve_checkpoint(None, task, False) == path
    assert 'RANDOM weights' in capsys.readouterr().out
    assert common.resolve_dtype('fp32') == torch.float32
    assert common.resolve_dtype('bf16') == torch.bfloat16

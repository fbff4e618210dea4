"""The port's blocks (codeformer_tpu_torch/nn) against their JAX modules on
the same weights (through flax_to_state_dict) and the same numpy inputs.

ResBlock, Downsample and the decoder tail are held against the JAX
colpack enclaves (run_resblocks / run_edge_block / run_decoder_tail)
under set_colpack_mode('interpret') -- the Pallas kernels through the
interpreter -- and against the plain JAX blocks. Tolerances: fp32 on both
sides; against the enclaves, which fold GroupNorm the same way, 1e-4;
against the plain two-pass GroupNorm 2e-3 (test_colpack.py's bound for
E[x^2] - mean^2 statistics); other blocks 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

from codeformer_tpu.nn import blocks as jb  # noqa: E402
from codeformer_tpu.nn import transformer as jt  # noqa: E402
from codeformer_tpu.ops import colpack_conv as cc  # noqa: E402
from codeformer_tpu_torch.nn import blocks as pb  # noqa: E402
from codeformer_tpu_torch.nn import transformer as pt  # noqa: E402
from codeformer_tpu_torch.utils.convert import flax_to_state_dict  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
GN_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture()
def interpret_mode():
    prev = jb.colpack_mode()
    jb.set_colpack_mode('interpret')
    yield
    jb.set_colpack_mode(prev)


def _nchw(x):
    """numpy NHWC -> torch NCHW in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _load(module, variables, prefix=''):
    sd = flax_to_state_dict(variables)
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    module.load_state_dict(sd)
    return module


class _Seq(fnn.Module):
    """JAX blocks in sequence; `mode` 'plain' | 'resblocks' | 'edge' |
    'tail' selects the colpack enclave to run them through."""
    make: callable
    mode: str = 'plain'

    def setup(self):
        self.blocks = self.make()

    def __call__(self, x):
        if self.mode == 'resblocks':
            y, j = jb.run_resblocks(self.blocks, 0, x)
            assert j == len(self.blocks)
            return y
        if self.mode == 'edge':
            y, handled = jb.run_edge_block(self.blocks[0], x)
            assert handled
            return y
        if self.mode == 'tail':
            y, handled = jb.run_decoder_tail(self.blocks, 0, x)
            assert handled
            return y
        for blk in self.blocks:
            x = blk(x)
        return x


def _run_jax(make, x, mode):
    m = _Seq(make, 'plain')
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # non-trivial norm affines so GroupNorm gamma/beta are exercised
    v = jax.tree_util.tree_map_with_path(
        lambda p, l: l + 0.1 * jnp.cos(jnp.arange(l.size).reshape(l.shape))
        if str(getattr(p[-1], 'key', '')) in ('scale', 'bias') else l, v)
    ref = np.asarray(m.apply(v, jnp.asarray(x)))
    got = np.asarray(_Seq(make, mode).apply(v, jnp.asarray(x)))
    return v, ref, got


@pytest.mark.parametrize('cin,cout', [(64, 64), (128, 64)])
def test_resblock_matches_run_resblocks(interpret_mode, cin, cout):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 2 * cc.TY, 32, cin)).astype(np.float32)
    v, ref, enclave = _run_jax(lambda: [jb.ResBlock(cin, cout)], x,
                               'resblocks')
    port = _load(pb.ResBlock(cin, cout), v, 'blocks.0.')
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    np.testing.assert_allclose(got, enclave, **TOL)
    np.testing.assert_allclose(got, ref, **GN_TOL)


def test_downsample_matches_run_edge_block(interpret_mode):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 4 * cc.TY, 32, 64)).astype(np.float32)
    v, ref, enclave = _run_jax(lambda: [jb.Downsample(64)], x, 'edge')
    port = _load(pb.Downsample(64), v, 'blocks.0.')
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    assert got.shape == (1, 2 * cc.TY, 16, 64)
    np.testing.assert_allclose(got, enclave, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


def test_decoder_tail_matches_run_decoder_tail(interpret_mode):
    """[Upsample, RB, RB, GroupNorm, conv_out]: no SiLU before conv_out,
    Cout = 3."""
    rng = np.random.default_rng(3)
    x = (0.5 * rng.standard_normal((1, cc.TY, 16, 128))).astype(np.float32)

    def make():
        return [jb.Upsample(128), jb.ResBlock(128, 64), jb.ResBlock(64, 64),
                jb.GroupNorm32(), jb.FastConv3x3(3)]

    v, ref, enclave = _run_jax(make, x, 'tail')
    mods = [pb.Upsample(128), pb.ResBlock(128, 64), pb.ResBlock(64, 64),
            pb.GroupNorm32(64), pb.Conv2d(64, 3, 3, padding=1)]
    _load(torch.nn.ModuleDict({'blocks': torch.nn.ModuleList(mods)}), v)
    with torch.no_grad():
        h = _nchw(x)
        for m in mods[:3]:
            h = m(h)
        got = _nhwc(pb.decoder_tail(mods[3], mods[4], h))
    assert got.shape == (1, 2 * cc.TY, 32, 3)
    np.testing.assert_allclose(got, enclave, **TOL)
    np.testing.assert_allclose(got, ref, **GN_TOL)


def _jax_module(mod, *inputs, rng_seed=0):
    v = mod.init(jax.random.PRNGKey(rng_seed), *map(jnp.asarray, inputs))
    return v, np.asarray(mod.apply(v, *map(jnp.asarray, inputs)))


def test_attn_block_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    v, ref = _jax_module(jb.AttnBlock(64), x)
    port = _load(pb.AttnBlock(64), v)
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(port(_nchw(x))), ref, **TOL)


def test_upsample_matches_phase_collapsed_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 8, 8, 64)).astype(np.float32)
    v, ref = _jax_module(jb.Upsample(64), x)
    port = _load(pb.Upsample(64), v)
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    assert got.shape == (1, 16, 16, 64)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize('w', [0.0, 0.5, 1.0])
def test_fuse_sft_block_matches_jax(w):
    rng = np.random.default_rng(6)
    enc = rng.standard_normal((1, 16, 16, 64)).astype(np.float32)
    dec = rng.standard_normal((1, 16, 16, 64)).astype(np.float32)
    mod = jb.FuseSftBlock(64, 64)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(enc), jnp.asarray(dec))
    ref = np.asarray(mod.apply(v, jnp.asarray(enc), jnp.asarray(dec),
                               jnp.float32(w)))
    port = _load(pb.FuseSftBlock(64, 64), v)
    with torch.no_grad():
        got = _nhwc(port(_nchw(enc), _nchw(dec), w))
    np.testing.assert_allclose(got, ref, **GN_TOL)


def test_calc_mean_std_and_adain_match_jax():
    """Unbiased variance, eps 1e-5."""
    rng = np.random.default_rng(7)
    c = (rng.standard_normal((2, 4, 4, 16)) * 2 + 1).astype(np.float32)
    s = (rng.standard_normal((2, 4, 4, 16)) * 0.5 - 1).astype(np.float32)
    jm, js = jb.calc_mean_std(jnp.asarray(s))
    pm, ps = pb.calc_mean_std(_nchw(s))
    np.testing.assert_allclose(_nhwc(pm), np.asarray(jm), **TOL)
    np.testing.assert_allclose(_nhwc(ps), np.asarray(js), **TOL)
    ref = jb.adaptive_instance_normalization(jnp.asarray(c), jnp.asarray(s))
    got = pb.adaptive_instance_normalization(_nchw(c), _nchw(s))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize('with_pos', [True, False])
def test_transformer_layer_matches_jax(with_pos):
    """Packed (E, 3E) JAX in_proj vs torch's (3E, E); q scaled by
    d^-0.5; position embedding on q and k only; exact GELU."""
    rng = np.random.default_rng(8)
    tgt = rng.standard_normal((2, 16, 64)).astype(np.float32)
    pos = rng.standard_normal((1, 16, 64)).astype(np.float32) \
        if with_pos else None
    mod = jt.TransformerSALayer(embed_dim=64, nhead=4, dim_mlp=128)
    args = (jnp.asarray(tgt),) + ((jnp.asarray(pos),) if with_pos else ())
    v = mod.init(jax.random.PRNGKey(0), *args)
    v = jax.tree_util.tree_map(
        lambda l: l + 0.05 * jnp.sin(jnp.arange(l.size).reshape(l.shape)), v)
    ref = np.asarray(mod.apply(v, *args))
    port = _load(pt.TransformerSALayer(64, 4, 128), v)
    assert port.self_attn.in_proj_weight.shape == (192, 64)
    with torch.no_grad():
        got = port(torch.from_numpy(tgt),
                   torch.from_numpy(pos) if with_pos else None)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_tap_tables_match_jax():
    """Encoder taps and generator fuse points equal those of the JAX
    block-list functions (and so the reference's codeformer_arch.py:204-206
    tables)."""
    from codeformer_tpu.models.vqgan import (_build_encoder_blocks,
                                             _build_generator_blocks)
    from codeformer_tpu_torch.models import vqgan as pv
    cfg = (64, 256, (1, 2, 2, 4, 4, 8), 2, 512, (16,))
    _, jenc = _build_encoder_blocks(*cfg, jnp.float32)
    _, jgen = _build_generator_blocks(*cfg, 3, jnp.float32)
    penc_blocks, penc = pv._build_encoder_blocks(*cfg)
    pgen_blocks, pgen = pv._build_generator_blocks(*cfg, 3)
    assert penc == jenc == {'512': 2, '256': 5, '128': 8, '64': 11,
                            '32': 14, '16': 18}
    assert pgen == jgen
    assert len(penc_blocks) == len(pgen_blocks) == 25


# ------------------------------------------ kernel switch and autograd
@pytest.mark.parametrize('op', ['conv3x3_dots', 'downsample_dots'])
def test_kernel_refuses_autograd_before_building(monkeypatch, op):
    """The K1/K2 outputs carry no autograd history: where autograd would
    record (grad enabled, an input or weight requiring grad) the CUDA
    branch raises before anything is built; under no_grad it passes the
    guard and stops at the device check (meta tensors), still without
    building."""
    from codeformer_tpu_torch.kernels import build
    from codeformer_tpu_torch.ops import conv3x3 as cv

    class Built(Exception):
        pass

    def no_build():
        raise Built
    monkeypatch.setattr(build, 'library', no_build)
    m = dict(device='meta')
    x = torch.empty(1, 8, 16, 64, dtype=torch.bfloat16, **m)
    w = torch.empty(64, 64, 3, 3, **m).requires_grad_(True)
    bias = torch.empty(64, **m)
    if op == 'conv3x3_dots':
        ab = torch.empty(1, 64, **m)
        call = lambda: cv.conv3x3_dots(x, ab, ab, 'silu', w, bias)  # noqa: E731
    else:
        call = lambda: cv.downsample_dots(x, w, bias)  # noqa: E731
    with pytest.raises(RuntimeError, match='forward-only'):
        call()
    with torch.no_grad(), pytest.raises(RuntimeError,
                                        match='no kernel for device meta'):
        call()


def _blocks_pair(make):
    torch.manual_seed(0)
    mod = make()
    with torch.no_grad():
        for n, p in mod.named_parameters():
            if 'norm' in n:
                p.add_(0.1 * torch.randn_like(p))
    return mod


@pytest.mark.parametrize('kind', ['res64', 'res128_64', 'down', 'tail'])
def test_textbook_form_matches_fused_form(kind):
    """use_kernels False (plain GroupNorm, SiLU, convs) against the fused
    K1/K2 form (here their plain versions) at fp32: rel RMS <= 1e-5."""
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 64 if kind != 'res128_64' else 128, 16, 16)).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last)
    if kind == 'tail':
        norm, conv = pb.GroupNorm32(64), pb.Conv2d(64, 3, 3, padding=1)
        _blocks_pair(lambda: torch.nn.ModuleList([norm, conv]))

        def run(on):
            return pb.decoder_tail(norm, conv, x, use_kernels=on)
    else:
        mod = _blocks_pair({'res64': lambda: pb.ResBlock(64, 64),
                            'res128_64': lambda: pb.ResBlock(128, 64),
                            'down': lambda: pb.Downsample(64)}[kind])

        def run(on):
            pb.set_kernels(mod, on)
            return mod(x)
    with torch.no_grad():
        fused, plain = run(True), run(False)
    assert fused.shape == plain.shape
    rel = float((fused - plain).pow(2).mean().sqrt()
                / plain.pow(2).mean().sqrt())
    assert rel <= 1e-5, rel


def test_set_kernels_reaches_every_switch():
    from codeformer_tpu_torch.models import CodeFormer
    m = CodeFormer(img_size=64, nf=32, ch_mult=(1, 2, 4), codebook_size=32,
                   emb_dim=16, dim_embd=32, n_head=4, n_layers=1,
                   connect_list=('32',))
    switches = [mod for mod in m.modules() if hasattr(mod, 'use_kernels')]
    kinds = {type(mod).__name__ for mod in switches}
    assert kinds == {'ResBlock', 'Downsample', 'Generator'}
    assert all(mod.use_kernels for mod in switches)
    assert pb.set_kernels(m, False) is m
    assert not any(mod.use_kernels for mod in switches)


def test_textbook_encoder_grads_match_jax():
    """With use_kernels False a backward through a tiny encoder gives
    every conv weight a non-None, nonzero grad, equal to jax.grad of the
    same loss through the JAX encoder on the same params (rel RMS
    <= 1e-4; fp32, colpack off)."""
    from codeformer_tpu.models.vqgan import Encoder as JEncoder
    from codeformer_tpu_torch.models.vqgan import Encoder
    cfg = dict(nf=32, emb_dim=16, ch_mult=(1, 2, 4), num_res_blocks=2,
               resolution=64, attn_resolutions=(16,))
    rng = np.random.default_rng(10)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    r = rng.standard_normal((2, 16, 16, 16)).astype(np.float32)
    jm = JEncoder(**cfg)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map_with_path(
        lambda p, l: l + 0.1 * jnp.cos(jnp.arange(l.size).reshape(l.shape))
        if str(getattr(p[-1], 'key', '')) in ('scale', 'bias') else l, v)

    def loss(params):
        y, _ = jm.apply({'params': params}, jnp.asarray(x))
        return jnp.sum(y * jnp.asarray(r))
    gj = flax_to_state_dict({'params': jax.grad(loss)(v['params'])})

    pm = _load(Encoder(**cfg), v)
    pb.set_kernels(pm, False)
    y, _ = pm(_nchw(x))
    (y * _nchw(r)).sum().backward()
    n_conv = 0
    for name, p in pm.named_parameters():
        if p.dim() != 4:
            continue
        n_conv += 1
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        want = gj[name]
        rel = float((p.grad - want).pow(2).mean().sqrt()
                    / want.pow(2).mean().sqrt())
        assert rel <= 1e-4, (name, rel)
    assert n_conv >= 20

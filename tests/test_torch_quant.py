"""The port's int8 serving path (codeformer_tpu_torch/nn/quant.py and the
`set_quant` wiring of nn/blocks.py) against the JAX package's
(codeformer_tpu/nn/quant.py, its process-wide mode set per test and
reset after), on the same seeded numpy inputs and, for modules, the same
parameters (flax_to_state_dict).

Tolerances:
- the int8 tensors, the scales and the int32 products are EQUAL (the
  same fp32 divisions, half-to-even rounds and exact integer sums);
- the dequantized outputs are equal or one ulp of their dtype apart
  (they read equal at these seeds);
- the int32 product equals F.conv2d in float64 on the same integer
  operands (every partial sum is an integer below 2^53: exact);
- JAX's own int8 budgets (tests/test_int8.py) hold on the port: argmax
  agreement >= 0.85 with the float path on the tiny CodeFormer, encoder
  latent relative error < 0.10 and generator PSNR > 35 dB on the tiny
  VQGAN;
- the port's int8 tiny CodeFormer against JAX's int8 one at fp32, block
  by block, each block of the encoder, the generator and the SFT block
  fed JAX's input: a quantized block within BLOCK_REL (2e-3) relative
  RMS, a float one within FLOAT_REL (1e-5). The GroupNorm ahead of each
  quantized conv differs by fp32 rounding (about 1e-7), which now and
  then moves a value across a boundary of the int8 grid: one step, 1/127
  of the map's max. The readings were 0 (conv_in, Downsample, Upsample,
  conv_out) and 7e-8..7e-4 (ResBlocks), against int8-versus-float
  8e-3..2.5e-2 on the same blocks. Run free, those flips compound
  through a random-weight model (lq_feat 0.037 apart, 95% of codes
  equal), so the whole forward is not the comparison.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from codeformer_tpu.nn import quant as jq  # noqa: E402
from codeformer_tpu.nn.blocks import colpack_mode, set_colpack_mode  # noqa: E402
from codeformer_tpu_torch.kernels.build import launch_counts, reset_launch_counts  # noqa: E402
from codeformer_tpu_torch.models import CodeFormer  # noqa: E402
from codeformer_tpu_torch.models.vqgan import VQAutoEncoder  # noqa: E402
from codeformer_tpu_torch.nn import blocks as nb  # noqa: E402
from codeformer_tpu_torch.nn import quant as pq  # noqa: E402
from codeformer_tpu_torch.utils.convert import flax_to_state_dict  # noqa: E402

torch.set_num_threads(2)
TINY = dict(img_size=64, nf=32, ch_mult=(1, 2, 4), codebook_size=64,
            emb_dim=16, dim_embd=64, n_head=4, n_layers=2, latent_size=256,
            connect_list=('32',))
TINY_VQ = dict(img_size=64, nf=32, ch_mult=(1, 2, 4), codebook_size=64,
               emb_dim=16)
DTYPES = {'fp32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}
BLOCK_REL = 2e-3
FLOAT_REL = 1e-5


@pytest.fixture(autouse=True)
def _jax_modes():
    """JAX's quant mode is process-wide: off after every test; colpack off
    (the plain XLA path) for the JAX modules here."""
    prev = colpack_mode()
    set_colpack_mode('off')
    yield
    jq.set_quant_mode('off')
    set_colpack_mode(prev)


def _jax_int8(fn):
    jq.set_quant_mode('int8')
    try:
        return fn()
    finally:
        jq.set_quant_mode('off')


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else t.astype(jnp.float32))


def _equal_or_one_ulp(got, want, tdt):
    got = got.float()
    want = torch.from_numpy(np.array(want, np.float32))
    ulp = torch.finfo(tdt).eps * want.abs().clamp_min(
        torch.finfo(tdt).tiny)
    assert ((got - want).abs() <= ulp).all(), \
        float((got - want).abs().max())


def _nchw(x_nhwc: np.ndarray, tdt) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).to(tdt) \
        .contiguous(memory_format=torch.channels_last)


def _oihw(k_hwio: np.ndarray, tdt) -> torch.Tensor:
    return torch.from_numpy(k_hwio.transpose(3, 2, 0, 1).copy()).to(tdt)


def _jax_int32(xq, kq, strides, padding):
    dn = lax.conv_dimension_numbers(xq.shape, kq.shape,
                                    ('NHWC', 'HWIO', 'NHWC'))
    return np.asarray(lax.conv_general_dilated(
        xq, kq, strides, padding, dimension_numbers=dn,
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize('dt', sorted(DTYPES))
def test_quantizers_equal_jax(dt):
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1.5, (2, 12, 12, 16)).astype(np.float32)
    k = rng.normal(0, 0.1, (3, 3, 16, 24)).astype(np.float32)
    k[..., 0] *= 50.0                      # channels of different ranges
    k[..., 1] *= 0.02
    aq, as_ = jq.quantize_act(jnp.asarray(x).astype(jdt))
    bq, bs = pq.quantize_act(torch.from_numpy(x).to(tdt))
    assert bq.dtype == torch.int8 and bs.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(aq), bq.numpy())
    assert float(as_) == float(bs)
    assert int(bq.abs().max()) == 127
    wq, ws = jq.quantize_weight(jnp.asarray(k).astype(jdt))
    vq, vs = pq.quantize_weight(_oihw(k, tdt))
    np.testing.assert_array_equal(np.asarray(wq).transpose(3, 2, 0, 1),
                                  vq.numpy())
    np.testing.assert_array_equal(np.asarray(ws), vs.numpy())
    # zeros take the 1e-8 floor and quantize to 0
    zq, zs = pq.quantize_act(torch.zeros(3))
    assert float(zs) == np.float32(1e-8) / np.float32(127)
    assert zq.tolist() == [0, 0, 0]


# (kernel HW, stride, JAX padding): the 3x3 convs, the Downsample, a 2x2
# phase of the Upsample
GEOMETRIES = {'3x3 same': (3, 1, 'SAME'),
              'downsample': (3, 2, ((0, 1), (0, 1))),
              'phase (1, 0)': (2, 1, ((0, 1), (1, 0)))}


@pytest.mark.parametrize('geom', sorted(GEOMETRIES))
@pytest.mark.parametrize('dt', sorted(DTYPES))
def test_conv_int8_equals_jax(dt, geom):
    """conv_int8: the int32 product equal to JAX's s8 conv on the same
    quantized operands, the dequantized output equal (or 1 ulp)."""
    jdt, tdt = DTYPES[dt]
    ks, stride, pad = GEOMETRIES[geom]
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1.0, (2, 12, 12, 16)).astype(np.float32)
    k = rng.normal(0, 0.1, (ks, ks, 16, 24)).astype(np.float32)
    xj, kj = jnp.asarray(x).astype(jdt), jnp.asarray(k).astype(jdt)
    xt, kt = torch.from_numpy(x).to(tdt), _oihw(k, tdt)
    want = jq.conv_int8(xj, kj, (stride, stride), pad)
    got = pq.conv_int8(xt, kt, stride, pad)
    assert got.dtype == tdt and got.shape == want.shape
    _equal_or_one_ulp(got, _np(want), tdt)
    xq, _ = pq.quantize_act(xt)
    wt = pq.prepare_weight(kt)
    i32 = pq.int8_conv(xq, wt, stride, pq._pads((ks, ks), stride, pad))
    assert i32.dtype == torch.int32
    np.testing.assert_array_equal(
        i32.numpy(), _jax_int32(jq.quantize_act(xj)[0],
                                jq.quantize_weight(kj)[0],
                                (stride, stride), pad))


@pytest.mark.parametrize('dt', sorted(DTYPES))
def test_conv_int8_prequant_equals_jax(dt):
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1.0, (1, 8, 8, 8)).astype(np.float32)
    k = rng.normal(0, 0.1, (2, 2, 8, 8)).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    xq, sx = jq.quantize_act(xj)
    want = jq.conv_int8_prequant(xq, sx, jnp.asarray(k).astype(jdt),
                                 (1, 1), ((1, 0), (0, 1)), out_dtype=jdt)
    bq, bs = pq.quantize_act(torch.from_numpy(x).to(tdt))
    got = pq.conv_int8_prequant(bq, bs, _oihw(k, tdt), 1,
                                ((1, 0), (0, 1)), out_dtype=tdt)
    _equal_or_one_ulp(got, _np(want), tdt)


@pytest.mark.parametrize('kind', ['Upsample', 'Downsample'])
@pytest.mark.parametrize('dt', sorted(DTYPES))
def test_int8_modules_equal_jax(dt, kind):
    """The phase-collapsed Upsample (four 2x2 kernels summed tap by tap
    in the dtype, one quantized input) and the stride-2 (0,1,0,1)
    Downsample, int8, against JAX's modules with the same parameters."""
    from codeformer_tpu.nn import blocks as jb
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1.5, (2, 8, 8, 32)).astype(np.float32)
    jm = getattr(jb, kind)(32, dtype=jdt)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    pm = getattr(nb, kind)(32)
    pm.load_state_dict(flax_to_state_dict(v))
    nb.set_quant(pm.eval(), 'int8')
    want = _jax_int8(lambda: jm.apply(v, jnp.asarray(x).astype(jdt)))
    with torch.no_grad():
        got = pm(_nchw(x, tdt)).permute(0, 2, 3, 1)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    _equal_or_one_ulp(got, _np(want), tdt)


def test_phase_kernels_collapse_the_3x3():
    """Nearest x2 then the 3x3 conv equals the four phase-collapsed 2x2
    convs with pads ((1-p, p), (1-q, q)), interleaved: float64, to
    rounding. (The sums in bf16 are held to JAX's in
    test_int8_modules_equal_jax.)"""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.normal(0, 0.1, (6, 5, 3, 3)))
    x = torch.from_numpy(rng.normal(0, 1, (1, 5, 7, 7)))
    ks = nb.phase_kernels(w)
    ref = torch.nn.functional.conv2d(
        torch.nn.functional.interpolate(x, scale_factor=2.0), w, padding=1)
    for p in (0, 1):
        for q in (0, 1):
            y = torch.nn.functional.conv2d(
                torch.nn.functional.pad(x, (1 - q, q, 1 - p, p)),
                ks[2 * p + q])
            torch.testing.assert_close(y, ref[..., p::2, q::2], rtol=0,
                                       atol=1e-12)


@pytest.mark.parametrize('case', [
    (3, 1, (1, 1, 1, 1), 16, 24),       # a ResBlock conv
    (3, 2, (0, 1, 0, 1), 16, 16),       # the Downsample
    (2, 1, (0, 1, 1, 0), 16, 16),       # an Upsample phase
    (3, 1, (1, 1, 1, 1), 3, 32),        # conv_in: K 27 padded to 32
    (3, 1, (1, 1, 1, 1), 32, 3)])       # conv_out: N 3 padded to 8
def test_int32_product_is_exact(case):
    """int8_conv against F.conv2d in float64 on the same int8 operands,
    full-range values: equal."""
    ks, stride, pads, cin, cout = case
    g = torch.Generator().manual_seed(5)
    xq = torch.randint(-127, 128, (2, 9, 9, cin), generator=g,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, cin, ks, ks), generator=g,
                       dtype=torch.int8)
    wt = pq.Int8Weight(pq.weight_matrix(wq), None, cout, ks, ks)
    got = pq.int8_conv(xq, wt, stride, pads)
    pt, pb, pl, pr = pads
    ref = torch.nn.functional.conv2d(
        torch.nn.functional.pad(xq.double().permute(0, 3, 1, 2),
                                (pl, pr, pt, pb)),
        wq.double(), stride=stride).permute(0, 2, 3, 1)
    assert got.dtype == torch.int32
    assert torch.equal(got.double(), ref)


def test_padded_conv_in_and_conv_out_operands():
    """conv_in (3 -> nf) takes K = 27 padded to 32 and conv_out
    (nf -> 3) N = 3 padded to 8, zeros past the real ones; the results
    keep the real shapes."""
    g = torch.Generator().manual_seed(6)
    w_in = torch.randn(64, 3, 3, 3, generator=g)
    w_out = torch.randn(3, 64, 3, 3, generator=g)
    t_in, t_out = pq.prepare_weight(w_in), pq.prepare_weight(w_out)
    assert tuple(t_in.mat.shape) == (64, 32) and t_in.n == 64
    assert tuple(t_out.mat.shape) == (8, 576) and t_out.n == 3
    assert not t_in.mat[:, 27:].any() and not t_out.mat[3:].any()
    x = torch.randn(2, 16, 16, 3, generator=g)
    assert pq.conv_int8(x, w_in).shape == (2, 16, 16, 64)
    assert pq.conv_int8(torch.randn(2, 16, 16, 64, generator=g),
                        w_out).shape == (2, 16, 16, 3)


def test_rows_go_in_chunks_of_whole_images(monkeypatch):
    """A batch whose patch matrix passes CHUNK_BYTES takes several
    _int_mm calls of whole images; the result is the same."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(5, 8, 8, 16, generator=g)
    w = torch.randn(8, 16, 3, 3, generator=g)
    reset_launch_counts()
    whole = pq.conv_int8(x, w)
    assert launch_counts()['int_mm'] == 1
    monkeypatch.setattr(pq, 'CHUNK_BYTES', 2 * 64 * 144)
    reset_launch_counts()
    chunked = pq.conv_int8(x, w)
    assert launch_counts()['int_mm'] == 3
    assert torch.equal(whole, chunked)


def _tiny_pair(seed=0):
    from codeformer_tpu.models import CodeFormer as JaxCodeFormer
    jm = JaxCodeFormer(**TINY)
    rng = np.random.default_rng(6 + seed)
    x = rng.normal(0, 0.3, (2, 64, 64, 3)).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), 0.5)
    pm = CodeFormer(**TINY)
    pm.load_state_dict(flax_to_state_dict(v))
    return jm, v, pm.eval(), x


def test_quantized_convs_are_jaxs():
    """set_quant switches exactly the convs JAX quantizes: the same
    weights, in the same order, reach the weight quantizer (conv_in, the
    ResBlock convs, the SFT block's ResBlock, Downsamples, the four
    Upsample phases, conv_out); attention, 1x1 convs, the encoder's last
    and the generator's first conv and the SFT scale/shift stay float."""
    jm, v, pm, x = _tiny_pair()
    seen = {'jax': [], 'port': []}
    qw, pw = jq.quantize_weight, pq.prepare_weight

    def jax_spy(k):
        seen['jax'].append(tuple(k.shape[3:2:-1] + k.shape[2:3]
                                 + k.shape[:2]))
        return qw(k)

    def port_spy(w):
        seen['port'].append(tuple(w.shape))
        return pw(w)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jq, 'quantize_weight', jax_spy)
        mp.setattr(pq, 'prepare_weight', port_spy)
        _jax_int8(lambda: jm.apply(v, jnp.asarray(x), 0.5, adain=True))
        nb.set_quant(pm, 'int8')
        with torch.no_grad():
            pm(_nchw(x, torch.float32), 0.5, adain=True)
    # conv_in, 2 x 16 ResBlock convs, the SFT ResBlock's 2, 2 Downsamples,
    # 2 Upsamples x 4 phases, conv_out
    assert seen['port'] == seen['jax'] and len(seen['port']) == 46
    quantized = sorted(n for n, m in pm.named_modules()
                       if getattr(m, 'quant', None) == 'int8')
    assert 'encoder.blocks.0' in quantized
    assert not any(('scale' in n or 'shift' in n or '.q' in n
                    or 'conv_out' in n.split('.')[-1:]) for n in quantized)
    assert not any(m.use_kernels for m in pm.modules()
                   if hasattr(m, 'use_kernels'))
    nb.set_quant(pm, 'off')
    assert not any(getattr(m, 'quant', 'off') == 'int8'
                   for m in pm.modules())
    with pytest.raises(ValueError, match='int8'):
        nb.set_quant(pm, 'fp8')


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    got = got.permute(0, 2, 3, 1).numpy() if got.ndim == 4 else got.numpy()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_int8_tiny_codeformer_blocks_match_jax_int8():
    """The port's int8 tiny CodeFormer against JAX's at fp32, each block
    of the encoder and the generator and the SFT block on JAX's own input
    to it (module docstring: BLOCK_REL, FLOAT_REL)."""
    jm, v, pm, x = _tiny_pair(seed=1)
    nb.set_quant(pm, 'int8')
    rng = np.random.default_rng(9)
    errs = []
    for part, h in (('encoder', x), ('generator', rng.normal(
            0, 0.5, (2, 16, 16, 16)).astype(np.float32))):
        for i, blk in enumerate(getattr(pm, part).blocks):
            want = np.asarray(_jax_int8(lambda: jm.apply(
                v, jnp.asarray(h),
                method=lambda m, t: getattr(m, part).blocks[i](t))))
            with torch.no_grad():
                got = blk(_nchw(h, torch.float32))
            quantized = any(getattr(m, 'quant', None) == 'int8'
                            for m in blk.modules())
            errs.append((part, i, quantized, _rel(got, want)))
            h = want
    enc, dec = (rng.normal(0, 1, (2, 32, 32, 64)).astype(np.float32)
                for _ in range(2))
    want = _jax_int8(lambda: jm.apply(
        v, jnp.asarray(enc), jnp.asarray(dec),
        method=lambda m, e, d: m.fuse_convs_dict['32'](e, d, 0.5)))
    with torch.no_grad():
        got = pm.fuse_convs_dict['32'](_nchw(enc, torch.float32),
                                       _nchw(dec, torch.float32), 0.5)
    errs.append(('fuse', 32, True, _rel(got, want)))
    # conv_in, 8 ResBlocks, 2 Downsamples; 8 ResBlocks, 2 Upsamples,
    # conv_out; the SFT block
    assert sum(q for *_, q, _ in errs) == 11 + 11 + 1
    bad = [e for e in errs if e[3] > (BLOCK_REL if e[2] else FLOAT_REL)]
    assert not bad, bad


def test_tiny_codeformer_int8_argmax_budget():
    """JAX's budget (tests/test_int8.py:140-168) on the port: int8 code
    picks agree with the float path's on >= 85% of tokens."""
    _, _, pm, _ = _tiny_pair()
    x = _nchw(np.random.default_rng(6).normal(0, 0.3, (2, 64, 64, 3))
              .astype(np.float32), torch.float32)
    with torch.no_grad():
        out_f, logits_f, _ = pm(x, 0.5, adain=True)
        nb.set_quant(pm, 'int8')
        out_q, logits_q, _ = pm(x, 0.5, adain=True)
    assert out_q.shape == out_f.shape and torch.isfinite(out_q).all()
    agree = float((logits_q.argmax(-1) == logits_f.argmax(-1))
                  .float().mean())
    assert agree >= 0.85, agree


def test_tiny_vqgan_int8_budgets():
    """JAX's continuous budgets (tests/test_int8.py:171-210) on the
    port: the int8 encoder's latent within 10% relative error of the
    float one, the int8 generator on the same codes above 35 dB PSNR."""
    from codeformer_tpu.models import VQAutoEncoder as JaxVQ
    rng = np.random.default_rng(7)
    x = rng.normal(0, 0.3, (2, 64, 64, 3)).astype(np.float32)
    v = JaxVQ(**TINY_VQ).init(jax.random.PRNGKey(0), jnp.asarray(x))
    pm = VQAutoEncoder(**TINY_VQ)
    pm.load_state_dict(flax_to_state_dict(v))
    pm.eval()
    xt = _nchw(x, torch.float32)
    q = _nchw(rng.normal(0, 0.5, (2, 16, 16, 16)).astype(np.float32),
              torch.float32)
    with torch.no_grad():
        z_f, y_f = pm.encoder(xt)[0], pm.generator(q)
        nb.set_quant(pm, 'int8')
        z_q, y_q = pm.encoder(xt)[0], pm.generator(q)
    rel = float((z_q - z_f).norm() / z_f.norm())
    assert 0 < rel < 0.10, rel
    peak = float(y_f.abs().max())
    mse = float(((y_q - y_f) ** 2).mean())
    psnr = 10.0 * np.log10(peak ** 2 / max(mse, 1e-12))
    assert psnr > 35.0, psnr


@pytest.mark.parametrize('kind', ['QConv2d', 'Upsample'])
def test_int8_refuses_autograd(kind):
    """The int8 round has no gradient: a quantized module raises where
    autograd records (a parameter or the input requires grad), and runs
    under no_grad."""
    m = nb.QConv2d(8, 8, 3, padding=1) if kind == 'QConv2d' \
        else nb.Upsample(8)
    nb.set_quant(m, 'int8')
    x = torch.randn(1, 8, 4, 4)
    with pytest.raises(RuntimeError, match='no gradient'):
        m(x)
    m.requires_grad_(False)
    with pytest.raises(RuntimeError, match='no gradient'):
        m(x.requires_grad_())
    with torch.no_grad():
        assert m(x).shape[1] == 8


def test_int8_weights_are_kept_between_calls(monkeypatch):
    """In eval mode the int8 weight and scales are made once per weight
    version and dtype; an in-place update makes them again."""
    m = nb.QConv2d(8, 8, 3, padding=1).eval().requires_grad_(False)
    nb.set_quant(m, 'int8')
    made = []
    pw = pq.prepare_weight
    monkeypatch.setattr(pq, 'prepare_weight',
                        lambda w: made.append(w.dtype) or pw(w))
    x = torch.randn(1, 8, 4, 4)
    y0 = m(x)
    assert torch.equal(m(x), y0) and made == [torch.float32]
    m(x.to(torch.bfloat16))
    assert made == [torch.float32, torch.bfloat16]
    with torch.no_grad():
        m.weight.mul_(2.0)
    m(x)
    assert made == [torch.float32, torch.bfloat16, torch.float32]


def test_cli_quant_int8_builds_an_int8_restorer(tmp_path):
    """`--quant int8` parses (the JAX CLI's choices) and the restorer
    that `main` builds has the switch set on its quantizable modules,
    the kernels off, and restores at --device cpu (tiny topology)."""
    from unittest import mock

    from codeformer_tpu_torch.cli import inference_codeformer as cli
    from codeformer_tpu_torch.pipeline import restorer as restorer_mod
    argv = ['--has_aligned', '-i', str(tmp_path / 'x.png'), '--device',
            'cpu', '--random-init', '--quant', 'int8']
    assert cli.build_parser().parse_args(argv).quant == 'int8'
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(argv[:-1] + ['int4'])
    got = {}
    with mock.patch.object(restorer_mod, 'CodeFormer',
                           lambda **arch: CodeFormer(**TINY)), \
            mock.patch.object(cli, 'run_aligned',
                              lambda a, paths, root, r: got.update(r=r)):
        cli.main(argv)
    r = got['r']
    assert r.quant == 'int8' and r.dtype == torch.bfloat16
    mods = [m for m in r.model.modules() if hasattr(m, 'quant')]
    assert mods and all(m.quant == 'int8' for m in mods)
    reset_launch_counts()
    out = r.restore_device(np.random.default_rng(8).integers(
        0, 256, (1, 64, 64, 3), dtype=np.uint8))
    assert out.shape == (1, 64, 64, 3)
    assert launch_counts()['int_mm'] == 46          # one a weight

"""The dense conv (csrc/conv3x3_dense.cu) and RRDBNet's trunk on it, on
the card: the kernel against `conv3x3_dense_ref` at each of the five
shapes of a dense block (and conv_body's) at 240^2 B = 16 and on a
ragged map, every byte outside the written slice untouched; a whole bf16
RRDBNet over 480^2 windows on the dense trunk and on the modules, both
against the fp32 modules; 346 launches a forward, each forward counted
in `fused_calls`.

Marked `card`: skipped without a CUDA device. This file imports no JAX,
so the card's machine runs it without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_rrdb_dense_cuda.py -q
"""
import pytest

torch = pytest.importorskip('torch')

from codeformer_tpu_torch.kernels.build import launch_counts, reset_launch_counts  # noqa: E402
from codeformer_tpu_torch.models.rrdbnet import RRDBNet  # noqa: E402
from codeformer_tpu_torch.ops import conv3x3 as cv  # noqa: E402
from codeformer_tpu_torch.pipeline.realesrgan import RealESRGANer  # noqa: E402

pytestmark = pytest.mark.card

NF, G, WIDTH = 64, 32, 192
# (Cin, Cout, off, epi): conv1-4, conv5 (both residuals), conv_body
SHAPES = ((64, 32, 64, 'lrelu'), (96, 32, 96, 'lrelu'),
          (128, 32, 128, 'lrelu'), (160, 32, 160, 'lrelu'),
          (192, 64, 0, 'res'), (192, 64, 0, 'rrdb'), (64, 64, 0, 'add'))
MAPS = ((16, 240, 240), (3, 37, 53))
DENSE_PER_FORWARD = 23 * 3 * 5 + 1
# tame_rrdb (chip_smoke.py): random RRDBs grow the features about 1.2-fold
# each; conv_body and conv_last keep the output mid-range
RRDB_GAIN, LAST_SCALE = 1.2, 0.04


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the dense conv runs only there')
    # the plain version and the fp32 model: full fp32 convs, not TF32
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)


def _bf16_ulps(got, want):
    """|got - want| in units of want's bf16 spacing (at least 2^-13)."""
    spacing = torch.clamp(want.abs(), min=2.0 ** -6) * 2.0 ** -7
    return ((got.float() - want.float()).abs() / spacing).max().item()


@pytest.mark.parametrize('shape', MAPS, ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('cin,cout,off,epi', SHAPES,
                         ids=[f'{c}-{o}-{e}' for c, o, _, e in SHAPES])
def test_kernel_matches_the_plain_version(card, cin, cout, off, epi, shape):
    """Where the trunk writes: conv1-4 a slice of the workspace they read,
    conv5 the first 64 channels of the next workspace (an RRDB's third
    block reading its s2 from the slice it writes), conv_body a packed map
    of its own. Every other byte of both stays as it was."""
    bsz, h, w = shape
    g = torch.Generator(device='cuda').manual_seed(cin * 7 + cout + h)

    def rnd(*size):
        return torch.randn(size, generator=g, device='cuda') \
            .to(torch.bfloat16)
    buf, nxt, other = (rnd(bsz, h, w, WIDTH) for _ in range(3))
    weight = torch.randn((cout, cin, 3, 3), generator=g, device='cuda') \
        * (2.0 / (9 * cin)) ** 0.5
    bias = 0.1 * torch.randn((cout,), generator=g, device='cuda')
    s1 = other[..., 64:64 + cout] if epi != 'lrelu' else None
    if epi == 'add':
        nxt = rnd(bsz, h, w, cout)

    def out_of(src, dst):
        return src[..., off:off + cout] if epi == 'lrelu' \
            else dst[..., off:off + cout]

    before, nxt0 = buf.clone(), nxt.clone()
    want = cv.conv3x3_dense_ref(
        before[..., :cin], weight, bias, out_of(before, nxt0).clone(), epi,
        s1, out_of(before, nxt0) if epi == 'rrdb' else None)
    out = out_of(buf, nxt)
    reset_launch_counts()
    got = cv.conv3x3_dense(buf[..., :cin], weight, bias, out, epi, s1,
                           out if epi == 'rrdb' else None)
    torch.cuda.synchronize()
    assert launch_counts()['conv3x3_dense'] == 1
    assert got.data_ptr() == out.data_ptr()
    # the same bf16 products summed in fp32 in another order, one rounding
    assert _bf16_ulps(out, want) <= 2.0
    written = torch.zeros(WIDTH, dtype=torch.bool, device='cuda')
    written[off:off + cout] = True
    if epi == 'lrelu':
        assert torch.equal(buf[..., ~written], before[..., ~written])
    else:
        assert torch.equal(buf, before)
        assert torch.equal(nxt[..., ~written[:nxt.shape[-1]]],
                           nxt0[..., ~written[:nxt.shape[-1]]])


def _tamed_model(seed=0):
    torch.manual_seed(seed)
    model = RRDBNet(num_in_ch=3, num_out_ch=3, scale=2, num_feat=NF,
                    num_block=23, num_grow_ch=G)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.normal_(0.0, 0.02)
        damp = RRDB_GAIN ** -len(model.body)
        model.conv_body.weight.mul_(damp)
        model.conv_body.bias.mul_(damp)
        model.conv_last.weight.mul_(LAST_SCALE)
        model.conv_last.bias.fill_(0.5)
    return model.eval()


def test_whole_rrdbnet_fused_against_eager_and_fp32(card, monkeypatch):
    """bf16 over 480^2 windows: the dense trunk comes as close to the
    fp32 modules as the bf16 modules do (mean |error| at most 1.1 times
    theirs), and a forward launches the dense conv 346 times."""
    model32 = _tamed_model().cuda()
    up = RealESRGANer(scale=2, model=_tamed_model(), tile=400, tile_pad=40,
                      dtype=torch.bfloat16, device='cuda')
    g = torch.Generator(device='cuda').manual_seed(5)
    tiles = torch.rand((4, 3, 480, 480), generator=g, device='cuda')
    with torch.inference_mode():
        ref = model32(tiles).clamp(0, 1)
    reset_launch_counts()
    up.reset_tile_counts()
    fused = up._fwd(tiles)
    torch.cuda.synchronize()
    assert launch_counts()['conv3x3_dense'] == DENSE_PER_FORWARD
    assert up.tile_counts()['fused_calls'] == 1
    monkeypatch.setattr(up.model, 'uses_dense_trunk', lambda feat: False)
    eager = up._fwd(tiles)
    assert launch_counts()['conv3x3_dense'] == DENSE_PER_FORWARD
    assert up.tile_counts()['fused_calls'] == 1
    ref255 = torch.round(ref.float() * 255.0)
    err_fused = (fused.float() - ref255).abs().mean().item()
    err_eager = (eager.float() - ref255).abs().mean().item()
    print(f'mean |error| in levels against fp32: dense trunk {err_fused:.4f}'
          f', modules {err_eager:.4f}')
    assert err_fused <= 1.1 * err_eager


def test_every_forward_of_the_walk_counted(card):
    """upscale_frames_device over 2 frames of 512 x 683 (2 x 2 windows a
    frame, 4 a forward): 2 forwards, both on the dense trunk, 346
    launches each."""
    up = RealESRGANer(scale=2, model=_tamed_model(1), tile=400,
                      tile_pad=40, dtype=torch.bfloat16, device='cuda')
    frames = torch.randint(0, 256, (2, 512, 683, 3), dtype=torch.uint8,
                           device='cuda')
    reset_launch_counts()
    out = up.upscale_frames_device(frames)
    torch.cuda.synchronize()
    counts = up.tile_counts()
    assert out.shape == (2, 1024, 1366, 3)
    assert counts['calls'] == 2 and counts['fused_calls'] == counts['calls']
    assert launch_counts()['conv3x3_dense'] == \
        DENSE_PER_FORWARD * counts['fused_calls']

"""RRDBNet's trunk on the dense conv, on the CPU: `conv3x3_dense_ref`
(ops/conv3x3.py), composed as `RRDBNet._dense_trunk` composes the kernel
over its three workspaces, equals the modules (`ResidualDenseBlock`,
`RRDB`, the trunk) in fp32; each conv writes its slice alone; the model
keeps its state-dict names and takes the module path wherever the
kernel does not run (the CPU, fp32, autograd).
"""
import types

import pytest
import torch
import torch.nn.functional as F

from codeformer_tpu_torch.models import rrdbnet
from codeformer_tpu_torch.ops import conv3x3 as cv

NF, G = 64, 32
WIDTH = NF + 4 * G
TOL = dict(rtol=1e-5, atol=1e-5)
# (B, H, W): a square map and a ragged one
MAPS = ((2, 16, 16), (3, 37, 53))
# the five (Cin, Cout, off) positions of a dense block's convs
POSITIONS = ((64, 32, 64), (96, 32, 96), (128, 32, 128), (160, 32, 160),
             (192, 64, 0))
# (position, epilogue): conv1-4 lrelu, conv5 res or rrdb, conv_body add
CASES = [(p, 'lrelu') for p in POSITIONS[:4]] + [
    (POSITIONS[4], 'res'), (POSITIONS[4], 'rrdb'), ((64, 64, 0), 'add')]


def _conv(cin, cout, seed):
    torch.manual_seed(seed)
    conv = torch.nn.Conv2d(cin, cout, 3, padding=1)
    with torch.no_grad():
        conv.bias.normal_(0, 0.1)
    return conv


def _nchw(t):
    return t.permute(0, 3, 1, 2)


@pytest.mark.parametrize('shape', MAPS, ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('pos,epi', CASES,
                         ids=[f'{p[0]}-{p[1]}@{p[2]}-{e}' for p, e in CASES])
def test_dense_ref_writes_its_slice_alone(pos, epi, shape):
    """One conv of the walk, where the trunk writes: conv1-4 a slice of
    the workspace they read, conv5 the first 64 channels of the next one
    (in place over its s2 for an RRDB's third block), conv_body a packed
    map. The slice equals the module's conv and epilogue over the
    concatenated prefix; every other byte is as it was."""
    cin, cout, off = pos
    bsz, h, w = shape
    g = torch.Generator().manual_seed(cin + cout + off + h)
    buf = torch.randn((bsz, h, w, WIDTH), generator=g)
    nxt = torch.randn((bsz, h, w, WIDTH if epi != 'add' else cout),
                      generator=g)
    s1 = torch.randn((bsz, h, w, WIDTH), generator=g)[..., :cout] \
        if epi != 'lrelu' else None
    conv = _conv(cin, cout, cin)
    before, nxt0 = buf.clone(), nxt.clone()
    out = buf[..., off:off + cout] if epi == 'lrelu' \
        else nxt[..., off:off + cout]
    s2 = out if epi == 'rrdb' else None
    want_s2 = _nchw(nxt0[..., off:off + cout]) if epi == 'rrdb' else None
    got = cv.conv3x3_dense(buf[..., :cin], conv.weight, conv.bias, out, epi,
                           s1, s2)
    assert got.data_ptr() == out.data_ptr()
    with torch.no_grad():
        y = conv(_nchw(before[..., :cin]))
        want = {'lrelu': lambda: F.leaky_relu(y, 0.2),
                'res': lambda: y * 0.2 + _nchw(s1),
                'rrdb': lambda: (y * 0.2 + _nchw(s1)) * 0.2 + want_s2,
                'add': lambda: y + _nchw(s1)}[epi]()
    torch.testing.assert_close(_nchw(out), want, **TOL)
    written = torch.zeros(WIDTH, dtype=torch.bool)
    written[off:off + cout] = True
    if epi == 'lrelu':
        assert torch.equal(buf[..., ~written], before[..., ~written])
    else:
        kept = ~written[:nxt.shape[-1]]
        assert torch.equal(buf, before)
        assert torch.equal(nxt[..., kept], nxt0[..., kept])


def _rdb_walk(rdb, src, dst, s2=None):
    """One dense block as _dense_trunk runs it: conv1-4 into src's
    slices, conv5 into dst[..., :NF] (with the RRDB's residual s2)."""
    for k in range(4):
        cin = NF + k * G
        conv = getattr(rdb, f'conv{k + 1}')
        cv.conv3x3_dense_ref(src[..., :cin], conv.weight, conv.bias,
                             src[..., cin:cin + G], 'lrelu')
    cv.conv3x3_dense_ref(src, rdb.conv5.weight, rdb.conv5.bias,
                         dst[..., :NF], 'rrdb' if s2 is not None else 'res',
                         src[..., :NF], s2)


@pytest.mark.parametrize('shape', MAPS, ids=lambda s: 'x'.join(map(str, s)))
def test_dense_block_walk_equals_residual_dense_block(shape):
    bsz, h, w = shape
    torch.manual_seed(1)
    rdb = rrdbnet.ResidualDenseBlock(NF, G).eval()
    x = torch.randn((bsz, h, w, NF))
    a, b = torch.zeros((bsz, h, w, WIDTH)), torch.zeros((bsz, h, w, WIDTH))
    a[..., :NF] = x
    with torch.no_grad():
        _rdb_walk(rdb, a, b)
        want = rdb(_nchw(x))
    torch.testing.assert_close(_nchw(b[..., :NF]), want, **TOL)
    assert torch.equal(a[..., :NF], x)       # the block's input kept


@pytest.mark.parametrize('shape', MAPS, ids=lambda s: 'x'.join(map(str, s)))
def test_rrdb_walk_equals_rrdb_in_place(shape):
    """The three buffers of one RRDB: rdb1 a -> b, rdb2 b -> c, rdb3 c ->
    a[..., :NF], over the RRDB's input, which its epilogue reads as s2."""
    bsz, h, w = shape
    torch.manual_seed(2)
    rrdb = rrdbnet.RRDB(NF, G).eval()
    x = torch.randn((bsz, h, w, NF))
    a, b, c = (torch.zeros((bsz, h, w, WIDTH)) for _ in range(3))
    a[..., :NF] = x
    with torch.no_grad():
        _rdb_walk(rrdb.rdb1, a, b)
        _rdb_walk(rrdb.rdb2, b, c)
        _rdb_walk(rrdb.rdb3, c, a, s2=a[..., :NF])
        want = rrdb(_nchw(x))
    torch.testing.assert_close(_nchw(a[..., :NF]), want, **TOL)


def _model(num_block=2):
    torch.manual_seed(3)
    return rrdbnet.RRDBNet(num_in_ch=3, num_out_ch=3, scale=2, num_feat=NF,
                           num_block=num_block, num_grow_ch=G).eval()


@pytest.mark.parametrize('shape', MAPS, ids=lambda s: 'x'.join(map(str, s)))
def test_dense_trunk_equals_the_module_trunk(shape):
    model = _model()
    bsz, h, w = shape
    feat = torch.randn((bsz, NF, h, w))
    with torch.no_grad():
        want = feat + model.conv_body(model.body(feat))
        got = model._dense_trunk(feat)
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, want, **TOL)
    assert model.dense_calls == 1


def test_dense_operands_kept_until_a_weight_changes():
    model = _model(1)
    ops = model.dense_operands()
    assert len(ops) == 3 * 5 + 1
    assert [(o.cin, o.cout) for o in ops[:5]] == [
        (64, 32), (96, 32), (128, 32), (160, 32), (192, 64)]
    assert model.dense_operands() is ops
    with torch.no_grad():
        model.body[0].rdb2.conv5.weight.mul_(5.0)
    again = model.dense_operands()
    assert again is not ops
    torch.testing.assert_close(cv.operands_weight(again[9]).float(),
                               model.body[0].rdb2.conv5.weight.to(
                                   torch.bfloat16).float())


def test_state_dict_names_unchanged():
    model = _model()
    names = {'conv_first', 'conv_body', 'conv_up1', 'conv_up2', 'conv_hr',
             'conv_last'} | {f'body.{i}.rdb{r}.conv{k}' for i in range(2)
                             for r in (1, 2, 3) for k in range(1, 6)}
    assert set(model.state_dict()) == {f'{n}.{p}' for n in names
                                       for p in ('weight', 'bias')}
    model.dense_operands()      # kept operands are no state
    fresh = _model()
    fresh.load_state_dict(model.state_dict(), strict=True)


def _like(device, dtype):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype)


@pytest.mark.parametrize('device,dtype,mode,fused', [
    ('cuda', torch.bfloat16, 'inference', True),
    ('cuda', torch.bfloat16, 'no_grad', True),
    ('cuda', torch.bfloat16, 'grad', False),
    ('cuda', torch.float32, 'inference', False),
    ('cpu', torch.bfloat16, 'inference', False),
    ('cpu', torch.float32, 'grad', False)])
def test_uses_dense_trunk_by_what_it_observes(device, dtype, mode, fused):
    model = _model(1)
    ctx = {'inference': torch.inference_mode, 'no_grad': torch.no_grad,
           'grad': torch.enable_grad}[mode]
    with ctx():
        assert model.uses_dense_trunk(_like(device, dtype)) is fused
    narrow = rrdbnet.RRDBNet(scale=2, num_feat=48, num_block=1,
                             num_grow_ch=16)
    with torch.inference_mode():
        assert not narrow.uses_dense_trunk(_like('cuda', torch.bfloat16))


@pytest.mark.parametrize('mode', ['inference', 'grad'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cpu_forward_takes_the_module_path(dtype, mode):
    """On the CPU, in fp32 and bf16, with autograd on or off, the forward
    runs the modules: the dense walk never runs, and a gradient reaches
    the trunk's weights."""
    model = _model(1).to(dtype)
    x = torch.rand((1, 3, 16, 20), dtype=dtype)
    if mode == 'inference':
        with torch.inference_mode():
            model(x)
    else:
        model(x).float().sum().backward()
        assert model.body[0].rdb3.conv5.weight.grad is not None
    assert model.dense_calls == 0


def test_strided_views_the_kernel_takes():
    buf = torch.zeros((2, 5, 7, WIDTH), dtype=torch.bfloat16)
    assert cv._strided_ld('x', buf[..., :96]) == WIDTH
    assert cv._strided_ld('out', buf[..., 160:192]) == WIDTH
    assert cv._strided_ld('out', torch.zeros((2, 5, 7, 64),
                                             dtype=torch.bfloat16)) == 64
    bad = [buf[..., 4:36],                          # 8-byte aligned
           buf[..., :48],                           # not 32k channels
           buf.float()[..., :64],                   # fp32
           buf[:, :, ::2, :64],                     # pixels not ld apart
           buf.permute(0, 3, 1, 2)[:, :64].permute(0, 2, 3, 1)[..., :32]
           .transpose(1, 2)]
    for t in bad:
        with pytest.raises((TypeError, ValueError)):
            cv._strided_ld('x', t)


@pytest.mark.parametrize('pos', POSITIONS + ((64, 64, 0),),
                         ids=lambda p: f'{p[0]}-{p[1]}')
def test_dense_plan_at_the_trunk_shapes(pos):
    """At 240^2 and B = 16 (a forward of 16 480^2 windows) every conv
    runs unsplit; the 32-channel convs and conv5's 192 -> 64 take BN = 32
    in tiles of 16 rows (conv5's weights at BN = 64, 221 KB, leave no room
    for a ring), conv_body BN = 64 in tiles of 8."""
    cin, cout, _ = pos
    p = cv.conv_plan(16, 240, 240, cin, cout, 1, 132, dense=True)
    assert p.split == 1 and p.stages >= 2
    body = (cin, cout) == (64, 64)
    assert (p.mb, p.bn) == ((1, 64) if body else (2, 32))
    assert p.smem <= cv.SMEM_LIMIT
    small = cv.conv_plan(3, 37, 53, cin, cout, 1, 132, dense=True)
    assert (small.bn, small.mb) in {(bn, mb) for mb, bn in cv.DENSE_VARIANTS}
    assert small.chunks % small.split == 0

"""The plain reference (benchmark/reference/codeformer.py) against the
program's CodeFormer on the same seeded weights, float32 on the CPU, at
a small width of the released block structure."""
import pytest
import torch

from benchmark.reference.codeformer import CodeFormer as Ref, to_u8, to_unit
from benchmark.weights import make_state_dict


def models(arch, seed=3):
    from codeformer_tpu_torch.models import CodeFormer
    ref = Ref(**arch).eval()
    sd = make_state_dict(ref, seed, 'cpu', {r'fuse_convs_dict\.[0-9]+\.'
                                            r'(scale|shift)\.2\.weight': 0.01})
    ref.load_state_dict(sd)
    port = CodeFormer(**arch).eval()
    port.load_state_dict(sd)
    return ref, port


@pytest.mark.parametrize('w,adain', [(0.5, True), (0.0, True), (1.0, False)])
def test_reference_matches_program(tiny_cfg, w, adain):
    arch = tiny_cfg['arch']
    ref, port = models(arch)
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (2, arch['img_size'], arch['img_size'], 3),
                      generator=g, dtype=torch.uint8)
    with torch.no_grad():
        out, logits, lq = ref(to_unit(x), w, adain)
        pout, plogits, plq = port(to_unit(x), w, adain=adain,
                                  enable_fuse=w > 0)
    assert torch.allclose(lq, plq, rtol=1e-4, atol=1e-5)
    assert torch.allclose(logits, plogits, rtol=1e-4, atol=1e-5)
    assert torch.allclose(out, pout, rtol=1e-4, atol=1e-4)
    assert (to_u8(out).int() - to_u8(pout).int()).abs().max() <= 1


def test_reference_follows_given_codes(tiny_cfg):
    arch = tiny_cfg['arch']
    ref, _ = models(arch)
    x = to_unit(torch.full((1, arch['img_size'], arch['img_size'], 3), 100,
                           dtype=torch.uint8))
    with torch.no_grad():
        own, logits, _ = ref(x, 0.5, True)
        same, _, _ = ref(x, 0.5, True, codes=logits.argmax(-1))
        other, _, _ = ref(x, 0.5, True,
                          codes=(logits.argmax(-1) + 1) % logits.shape[-1])
    assert torch.equal(own, same)
    assert not torch.allclose(own, other)


def test_weights_seeded_and_distinct(tiny_cfg):
    ref = Ref(**tiny_cfg['arch'])
    a = make_state_dict(ref, 5, 'cpu')
    b = make_state_dict(ref, 5, 'cpu')
    c = make_state_dict(ref, 6, 'cpu')
    assert a.keys() == set(ref.state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    assert all(float(v.abs().max()) > 0 for v in a.values())

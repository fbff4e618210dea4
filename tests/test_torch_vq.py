"""The port's nearest-code search (ops/vq.py, plain version of K3) and
VectorQuantizer.forward against the JAX package on the same numpy
inputs.

K3's plain version must pick the SAME codes as `_nearest_code_xla` and
the Pallas kernel run by the interpreter where the nearest code is well
separated, the LOWEST index on exact ties (duplicated codebook rows), and
on plain random inputs, where fp32 near-ties may flip, only codes whose
exact (fp64) squared distance is within 1e-5 relative of the exact
minimum. VectorQuantizer.forward is fp32 on both sides: 1e-5 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from codeformer_tpu.ops import vq as jvq  # noqa: E402
from codeformer_tpu_torch.ops import vq as pvq  # noqa: E402

torch.set_num_threads(2)
MARGIN = 1e-5


def _three_ways(z, e):
    """(plain port, XLA, Pallas interpreted) indices as numpy int64."""
    port = pvq.nearest_code_indices(torch.from_numpy(z), torch.from_numpy(e))
    assert port.dtype == torch.int64
    xla = jvq._nearest_code_xla(jnp.asarray(z), jnp.asarray(e))
    pal = jvq._nearest_code_pallas(jnp.asarray(z), jnp.asarray(e),
                                   interpret=True)
    return port.numpy(), np.asarray(xla, np.int64), np.asarray(pal, np.int64)


def _exact_gap(z, e, idx):
    """Relative excess of the fp64 squared distance at idx over the fp64
    minimum, per token."""
    z64, e64 = z.astype(np.float64), e.astype(np.float64)
    d = ((z64 * z64).sum(1)[:, None] + (e64 * e64).sum(1)[None]
         - 2 * z64 @ e64.T)
    dmin = d.min(1)
    return (d[np.arange(len(z)), idx] - dmin) / np.abs(dmin)


@pytest.mark.parametrize('dim,codes', [(16, 32), (256, 1024)])
def test_nearest_code_matches_xla_and_pallas_on_separated_codes(dim, codes):
    """Tokens near a random code (noise 0.05 of the code spacing): a
    unique nearest code, the same in all three."""
    rng = np.random.default_rng(11)
    e = rng.normal(size=(codes, dim)).astype(np.float32)
    pick = rng.integers(0, codes, 300)
    z = (e[pick] + 0.05 * rng.normal(size=(300, dim))).astype(np.float32)
    port, xla, pal = _three_ways(z, e)
    np.testing.assert_array_equal(port, pick)
    np.testing.assert_array_equal(xla, pick)
    np.testing.assert_array_equal(pal, pick)


def test_nearest_code_duplicated_rows_take_the_lowest_index():
    """Every code appears 4 times at scattered rows: all three return the
    first row of the winning code."""
    rng = np.random.default_rng(12)
    base = rng.normal(size=(64, 32)).astype(np.float32)
    row_code = rng.permutation(256) % 64
    e = base[row_code]
    first = np.array([np.flatnonzero(row_code == c)[0] for c in range(64)])
    z = rng.normal(size=(500, 32)).astype(np.float32)
    port, xla, pal = _three_ways(z, e)
    for got in (port, xla, pal):
        np.testing.assert_array_equal(got, first[row_code[got]])
    np.testing.assert_array_equal(port, xla)
    np.testing.assert_array_equal(port, pal)


@pytest.mark.parametrize('scale', ['init', 'unit'])
def test_nearest_code_random_inputs_within_margin(scale):
    """Plain random tokens against the init-scale (uniform +-1/K, many
    near-ties) and a unit-scale codebook: any disagreement with JAX picks
    a code within 1e-5 relative of the exact minimum, and so does every
    pick of the port."""
    rng = np.random.default_rng(13)
    k = 1024
    e = (rng.uniform(-1.0 / k, 1.0 / k, (k, 256)) if scale == 'init'
         else rng.normal(size=(k, 256))).astype(np.float32)
    z = rng.normal(size=(512, 256)).astype(np.float32)
    port, xla, pal = _three_ways(z, e)
    assert (port == xla).mean() > 0.9
    for got in (port, xla, pal):
        assert _exact_gap(z, e, got).max() <= MARGIN


def test_nearest_code_refuses_other_devices_before_building():
    """A tensor on neither the CPU nor a CUDA card raises at once, before
    any kernel build is attempted."""
    z = torch.empty(4, 8, device='meta')
    with pytest.raises(RuntimeError, match='no kernel for device meta'):
        pvq.nearest_code_indices(z, torch.empty(16, 8, device='meta'))


@pytest.fixture(scope='module')
def quantizer_pair():
    from codeformer_tpu.models.vqgan import VectorQuantizer as JVQ
    from codeformer_tpu_torch.models.vqgan import VectorQuantizer as PVQ
    from codeformer_tpu_torch.utils.convert import flax_to_state_dict
    rng = np.random.default_rng(14)
    z = rng.normal(0, 0.02, (2, 8, 8, 16)).astype(np.float32)
    jm = JVQ(codebook_size=64, emb_dim=16)
    v = {'params': {'embedding': jnp.asarray(
        rng.normal(0, 0.02, (64, 16)).astype(np.float32))}}
    pm = PVQ(64, 16)
    pm.load_state_dict(flax_to_state_dict(v))
    return jm, v, pm, z


def test_vector_quantizer_forward_matches_jax(quantizer_pair):
    jm, v, pm, z = quantizer_pair
    zq_j, loss_j, st_j = jm.apply(v, jnp.asarray(z))
    with torch.no_grad():
        zq, loss, st = pm(torch.from_numpy(z).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(st['min_encoding_indices'].numpy(),
                                  np.asarray(st_j['min_encoding_indices']))
    assert len(np.unique(st['min_encoding_indices'].numpy())) > 10
    np.testing.assert_allclose(zq.permute(0, 2, 3, 1).numpy(),
                               np.asarray(zq_j), rtol=1e-5, atol=1e-7)
    for name, got, want in (
            ('loss', loss, loss_j),
            ('perplexity', st['perplexity'], st_j['perplexity']),
            ('mean_distance', st['mean_distance'], st_j['mean_distance'])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   err_msg=name)


def test_vector_quantizer_straight_through_gradient(quantizer_pair):
    """d z_q / d z is the identity, and only the codebook term
    mse(sg[z_q], z) of the loss reaches z: 2 (z - z_q) / N."""
    _, _, pm, z = quantizer_pair
    zt = torch.from_numpy(z).permute(0, 3, 1, 2).requires_grad_(True)
    zq, loss, _ = pm(zt)
    g = torch.from_numpy(np.random.default_rng(15).normal(
        size=zq.shape).astype(np.float32))
    (gz,) = torch.autograd.grad(zq, zt, g)
    np.testing.assert_array_equal(gz.numpy(), g.numpy())
    (gl,) = torch.autograd.grad(loss, zt)
    want = 2 * (zt - zq).detach() / zt.numel()
    np.testing.assert_allclose(gl.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-9)


"""The port's nearest-code search (ops/vq.py, plain version of K3) and
VectorQuantizer.forward against the JAX package on the same numpy
inputs.

K3's plain version must pick the SAME codes as `_nearest_code_xla` and
the Pallas kernel run by the interpreter where the nearest code is well
separated, the LOWEST index on exact ties (duplicated codebook rows), and
on plain random inputs, where fp32 near-ties may flip, only codes whose
exact (fp64) squared distance is within 1e-5 relative of the exact
minimum. VectorQuantizer.forward is fp32 on both sides: 1e-5 relative.

The CUDA kernel (csrc/nearest_code.cu) runs only on the card; its walk is
emulated here in numpy from `k3_plan`: the selection (per-thread code
order with a strict <, the 64-bit keys, the half-warp butterfly, the
cluster minimum) on the plain version's own distance matrix must give
EXACTLY its argmin, and the whole walk (the two groups' fp32 FMA sums
over D, added at the end of a code tile, then fmaf(-2, dot, e_sq)) picks
within 1e-5 of the exact minimum and the lowest index on exact ties.
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


# ---------------------------------------------------------------- the K3 walk
def _keys(dist, idx):
    """The kernel's pack_key: the distance's order-preserving bits (+0 and
    -0 alike) above the code index, as uint64."""
    d = np.where(dist == 0, np.float32(0), dist).astype(np.float32)
    u = d.view(np.uint32)
    u = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return (u.astype(np.uint64) << np.uint64(32)) | idx.astype(np.uint64)


def _thread_codes(tc, j):
    """Code j of thread column tc in a tile: 4tc..4tc+3, then
    64+4tc..64+4tc+3, ascending in j."""
    return np.where(j < 4, 4 * tc + j, 64 + 4 * tc + j - 4)


def emulate_select(dist, cluster=None):
    """The kernel's selection over a (T, K) fp32 distance matrix with
    clusters of `cluster` blocks (default: k3_plan's on an H100): per
    cluster rank its code tiles, per thread (token, tc) the codes in
    ascending order replacing only on a strict <, the 16 lanes of a token
    folded by an xor butterfly of keys, then the minimum over the ranks;
    tokens past T dropped."""
    n_tok, n_codes = dist.shape
    plan = pvq.k3_plan(n_tok, n_codes, 8)
    if cluster is not None:
        plan = plan._replace(cluster=cluster)
    rows = plan.tok_tiles * pvq.K3_TOKENS_PER_BLOCK
    padded = np.zeros((rows, plan.kp), np.float32)
    padded[:n_tok, :n_codes] = dist
    tc = np.arange(16)
    cluster_key = None
    for rank in range(plan.cluster):
        best_d = np.zeros((rows, 16), np.float32)
        best_j = np.full((rows, 16), -1)
        for tile in range(rank, plan.code_tiles, plan.cluster):
            for j in range(8):
                code = tile * pvq.K3_CODES_PER_TILE + _thread_codes(tc, j)
                d = padded[:, code]
                take = (code < n_codes)[None] & ((best_j < 0) | (d < best_d))
                best_d = np.where(take, d, best_d)
                best_j = np.where(take, code[None], best_j)
        key = np.where(best_j < 0, np.uint64(2 ** 64 - 1),
                       _keys(best_d, np.maximum(best_j, 0)))
        for off in (8, 4, 2, 1):
            key = np.minimum(key, key[:, tc ^ off])
        key = key[:, 0]
        cluster_key = key if cluster_key is None else np.minimum(cluster_key,
                                                                 key)
    return (cluster_key[:n_tok] & np.uint64(0xffffffff)).astype(np.int64)


def _fma(a, b, c):
    """fp32 fmaf: the exact product plus c, rounded once (through fp64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate_dots(z, e):
    """z . e_j in the kernel's order: D in chunks of 32, the first 16 of
    each chunk summed by one group and the last 16 by the other, each an
    fp32 FMA chain in ascending d over zero-padded D; then group 0's sum
    plus group 1's."""
    plan = pvq.k3_plan(len(z), len(e), z.shape[1])
    zp = np.zeros((len(z), plan.dp), np.float32)
    zp[:, :z.shape[1]] = z
    ep = np.zeros((len(e), plan.dp), np.float32)
    ep[:, :e.shape[1]] = e
    acc = [np.zeros((len(z), len(e)), np.float32) for _ in range(2)]
    for d in range(plan.dp):
        g = (d % pvq.K3_D_CHUNK) // (pvq.K3_D_CHUNK // 2)
        acc[g] = _fma(zp[:, d, None], ep[None, :, d], acc[g])
    return acc[0] + acc[1]


def emulate_kernel(z, e):
    """The whole walk: emulated dots, fmaf(-2, dot, e_sq) with e_sq as the
    kept operand, then the kernel's selection."""
    e_sq = pvq.codebook_operands(torch.from_numpy(e))[1].numpy()[:len(e)]
    dot = emulate_dots(z, e)
    dist = (e_sq.astype(np.float64)[None] - 2.0 * dot.astype(np.float64))
    return emulate_select(dist.astype(np.float32))


def _codebook(rng, k, dim, kind):
    if kind == 'duplicated':   # k/4 rows, each 4 times at scattered places
        return rng.normal(size=(k // 4, dim)).astype(np.float32)[
            rng.permutation(k) % (k // 4)]
    return rng.normal(size=(k, dim)).astype(np.float32)


def _ref_dist(z, e):
    """The plain version's own fp32 distance matrix (as _nearest_code_ref
    forms it)."""
    zt, et = torch.from_numpy(z), torch.from_numpy(e)
    return (et.square().sum(1)[None] - 2.0 * (zt @ et.t())).numpy()


K3_WALK_TOKENS = (1, 63, 64, 1000, 1024, 4097)


@pytest.mark.parametrize('n_tok', K3_WALK_TOKENS)
@pytest.mark.parametrize('n_codes', [512, 1024])
@pytest.mark.parametrize('kind', ['random', 'duplicated', 'signed zeros'])
def test_k3_selection_equals_the_plain_argmin(n_tok, n_codes, kind):
    """The kernel's tiling, candidate order, key packing and cluster
    reduction on the plain version's distances give exactly its argmin,
    for every cluster size: the lowest index of equal distances, +0 and
    -0 being equal."""
    rng = np.random.default_rng(n_tok * 7 + n_codes)
    if kind == 'signed zeros':
        # minima of 0 at several codes a token, half of them -0
        dist = rng.integers(0, 3, (n_tok, n_codes)).astype(np.float32)
        dist[(dist == 0) & (rng.uniform(size=dist.shape) < 0.5)] = -0.0
        want = torch.from_numpy(dist).argmin(1).numpy()
    else:
        e = _codebook(rng, n_codes, 32, kind)
        z = rng.normal(size=(n_tok, 32)).astype(np.float32)
        dist = _ref_dist(z, e)
        want = pvq._nearest_code_ref(torch.from_numpy(z),
                                     torch.from_numpy(e)).numpy()
        np.testing.assert_array_equal(want, dist.argmin(1))
    for cluster in pvq.CLUSTER_SIZES:
        np.testing.assert_array_equal(emulate_select(dist, cluster), want,
                                      err_msg=f'clusters of {cluster}')


@pytest.mark.parametrize('n_codes,kind', [(1024, 'random'),
                                          (1024, 'duplicated'),
                                          (512, 'random'),
                                          (512, 'duplicated')])
def test_k3_walk_picks_the_plain_codes(n_codes, kind):
    """The emulated kernel (its fp32 sums included) at D = 256: every pick
    within 1e-5 of the exact minimum, the lowest index on exact ties
    (duplicated rows), and the plain version's pick but for fp32
    near-ties. With zero rows in the codebook every token, zero tokens
    included, finds them at a distance of +0 or -0 (sums of z_d * 0) and
    takes the lowest of them."""
    rng = np.random.default_rng(n_codes + len(kind))
    e = _codebook(rng, n_codes, 256, kind)
    z = rng.normal(size=(150, 256)).astype(np.float32)
    got = emulate_kernel(z, e)
    want = pvq._nearest_code_ref(torch.from_numpy(z),
                                 torch.from_numpy(e)).numpy()
    assert _exact_gap(z, e, got).max() <= MARGIN
    first = {tuple(row): i for i, row in reversed(list(enumerate(e)))}
    np.testing.assert_array_equal(got, [first[tuple(e[j])] for j in got])
    assert (got == want).mean() >= 0.99
    zero_rows = rng.choice(n_codes, 3, replace=False)
    e[zero_rows] = 0
    z[::37] = 0
    np.testing.assert_array_equal(emulate_kernel(z, e), zero_rows.min())


@pytest.mark.parametrize('n_tok,n_codes,cluster', [
    (256, 1024, 8), (1024, 1024, 4), (2048, 1024, 8), (4096, 1024, 2),
    (16384, 1024, 1), (1024, 512, 4), (16384, 512, 1), (1, 100, 1)])
def test_k3_plan_weighs_waves_against_tiles_a_block(n_tok, n_codes, cluster):
    """On an H100 (132, 66, 30 and 15 resident clusters of 1, 2, 4, 8
    blocks): the cluster with the fewest tile-times, ties to the smaller;
    operands padded to whole tiles and chunks."""
    p = pvq.k3_plan(n_tok, n_codes, 256)
    assert p.cluster == cluster
    assert p.tok_tiles == -(-n_tok // 64)
    assert p.kp == p.code_tiles * 128 >= n_codes > p.kp - 128
    assert p.dp == 256


def test_k3_plan_keeps_to_the_clusters_that_fit():
    p = pvq.k3_plan(64, 1024, 40, resident=(132, 66, 30, 0))
    assert p.cluster == 4 and p.dp == 64
    with pytest.raises(RuntimeError, match='no cluster size fits'):
        pvq.k3_plan(64, 1024, 256, resident=(0, 0, 0, 0))


def test_k3_operands_are_kept_until_the_codebook_changes():
    """The kept (et, e_sq) are found again for the same tensor, made anew
    after an in-place update (an optimizer step), new storage or a cast,
    and dropped with the tensor; a fresh view is another tensor."""
    import gc
    e = torch.nn.Parameter(torch.randn(100, 24))
    et, e_sq = pvq.codebook_operands(e)
    assert et.shape == (64, 128) and e_sq.shape == (128,)
    assert torch.equal(et[:24, :100], e.detach().t())
    assert not et[24:].any() and not et[:, 100:].any()
    assert torch.equal(e_sq[:100], e.detach().square().sum(1))
    assert not e_sq[100:].any()
    assert pvq.codebook_operands(e)[0] is et
    with torch.no_grad():
        e.mul_(2.0)                          # in place: _version moves
    et2, e_sq2 = pvq.codebook_operands(e)
    assert et2 is not et and torch.equal(et2[:24, :100], e.detach().t())
    assert torch.equal(e_sq2[:100], e.detach().square().sum(1))
    assert pvq.codebook_operands(e)[0] is et2
    e.data = torch.randn(100, 24)            # new storage
    et3 = pvq.codebook_operands(e)[0]
    assert et3 is not et2 and torch.equal(et3[:24, :100], e.detach().t())
    view = e.detach()
    assert pvq.codebook_operands(view)[0] is not et3
    assert torch.equal(pvq.codebook_operands(view)[0], et3)
    half = e.detach().to(torch.bfloat16)
    assert torch.equal(pvq.codebook_operands(half)[0][:24, :100],
                       half.float().t())
    key = id(e)
    del e, view
    gc.collect()
    assert key not in pvq._operands


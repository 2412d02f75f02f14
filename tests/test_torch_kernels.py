"""Each kernel module of the port (ops/scan.py, ops/expand.py,
ops/composite.py) against its JAX counterpart on the same numpy inputs.

On the CPU every wrapper runs its plain PyTorch version; the JAX side runs
its CPU fallback, and once per kernel the real Pallas body in interpret
mode. Integer results and pure data movement are exact. The compositor
holds accum and final T at atol 2e-5 (the oracle tolerance of
tests/test_pallas_composite.py): the JAX kernel forms the transmittance as
exp(cumsum(log1p(-alpha))) while the port keeps a running product, so the
two round differently; n_contrib must match except on pixels where that
rounding puts T on the other side of T_EPS (at most 0.1%).

tests/test_torch_cuda.py holds each CUDA kernel against its plain
version on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.ops import composite_pallas as jcomp
from street_gaussians_ns_tpu.ops import expand_pallas as jexp
from street_gaussians_ns_tpu.ops import scan_pallas as jscan
from street_gaussians_ns_tpu.ops.tiles import bin_and_pack as jbin_and_pack
from street_gaussians_ns_tpu_torch.ops import composite as tcomp
from street_gaussians_ns_tpu_torch.ops import expand as texp
from street_gaussians_ns_tpu_torch.ops import scan as tscan

from test_expand_pallas import _expand_oracle, _ragged
from test_fused_binning import _project
from test_torch_binning import STATIC
from test_pallas_composite import make_scene


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Kernel A: flat scan.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 1000, 70001])
def test_scan_matches_jax(m):
    rng = np.random.default_rng(m)
    xi = rng.integers(-50, 60, size=m).astype(np.int32)
    xf = rng.standard_normal(m).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(tscan.cumsum_flat(t(xi)).numpy(),
                                  np.asarray(jscan.cumsum_flat(xi)))
    np.testing.assert_array_equal(tscan.cummax_flat(t(xi)).numpy(),
                                  np.asarray(jax.lax.cummax(xi, axis=0)))
    np.testing.assert_array_equal(tscan.cummax_flat(t(xf)).numpy(),
                                  np.asarray(jax.lax.cummax(xf, axis=0)))
    # float sums: another summation order, so only to rounding.
    np.testing.assert_allclose(tscan.cumsum_flat(t(xf)).numpy(),
                               np.asarray(jnp.cumsum(xf)), rtol=1e-4,
                               atol=1e-3)
    assert tscan.cumsum_flat(t(xi)).dtype == torch.int32


def test_scan_matches_pallas_interpret():
    x = np.random.default_rng(3).integers(0, 9, size=70001).astype(np.int32)
    want = np.asarray(jscan.cumsum_flat(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(
        tscan.cumsum_flat(torch.from_numpy(x)).numpy(), want)


def test_scan_rejects_bad_input():
    with pytest.raises(TypeError):
        tscan.cumsum_flat(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        tscan.cummax_flat(torch.zeros((2, 2), dtype=torch.int32))


# ---------------------------------------------------------------------------
# Kernel B: ragged expansion.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_src,c,out_len,p_zero", [
    (300, 5, 1200, 0.1), (50, 16, 4000, 0.3), (200, 14, 300, 0.5)])
def test_expand_matches_jax(n_src, c, out_len, p_zero):
    rng = np.random.default_rng(n_src)
    # Zero-count runs interleaved (clipped tile rows); out_len past the
    # total leaves uncovered slots, below it cuts runs (capacity overflow).
    src, starts, ends, _ = _ragged(rng, n_src, c, p_zero=p_zero)
    got = texp.expand_ragged(torch.from_numpy(src), torch.from_numpy(starts),
                             torch.from_numpy(ends), out_len).numpy()
    want = np.asarray(jexp.expand_ragged(jnp.asarray(src),
                                         jnp.asarray(starts),
                                         jnp.asarray(ends), out_len))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _expand_oracle(src, starts, ends,
                                                      out_len))


def test_expand_matches_pallas_interpret():
    rng = np.random.default_rng(7)
    src, starts, ends, _ = _ragged(rng, 300, 5)
    out_len = 1200
    want = np.asarray(jexp.expand_ragged(
        jnp.asarray(src), jnp.asarray(starts), jnp.asarray(ends), out_len,
        interpret=True))
    got = texp.expand_ragged(torch.from_numpy(src), torch.from_numpy(starts),
                             torch.from_numpy(ends), out_len,
                             n_exact=3).numpy()
    np.testing.assert_array_equal(got, want)


def test_expand_rejects_bad_input():
    src = torch.zeros((2, 3))
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        texp.expand_ragged(src.double(), idx, idx, 4)
    with pytest.raises(ValueError):
        texp.expand_ragged(src, idx.long(), idx, 4)


# ---------------------------------------------------------------------------
# Kernels C and D on a JAX-binned 48x32 scene.
# ---------------------------------------------------------------------------

MAX_PAIRS = 8192   # 64 stream rows: a whole Pallas pack block


def _jax_binned(seed=0, n=120, w=48, h=32):
    means, scales, quats, colors, opac, cam = make_scene(n, seed, w=w, h=h)
    p = _project(means, scales, quats, cam)
    depth_key = jnp.where(p.num_tiles_hit > 0, p.depths, jnp.inf)
    bins, feats = jax.jit(jbin_and_pack, static_argnames=STATIC)(
        p.xys, p.conics, p.tile_box, depth_key, colors, opac, width=w,
        height=h, tile_size=16, max_pairs=MAX_PAIRS, with_gauss_idx=False)
    return bins, feats, (w + 15) // 16, (h + 15) // 16


@pytest.fixture(scope="module")
def binned():
    return _jax_binned()


def test_pack_matches_jax(binned):
    _, feats, _, _ = binned
    got = tcomp.pack_feat_cols([torch.from_numpy(np.array(f))
                                for f in feats], MAX_PAIRS).numpy()
    want = np.asarray(jcomp._pack_feat_cols(feats, MAX_PAIRS))
    assert got.shape == (MAX_PAIRS // 128 + 1, 16, 128)
    np.testing.assert_array_equal(got, want)
    # The Pallas body pads the stream to whole 64-row blocks of zeros.
    want_i = np.asarray(jcomp._pack_feat_cols(feats, MAX_PAIRS,
                                              interpret=True))
    np.testing.assert_array_equal(got, want_i[:got.shape[0]])
    np.testing.assert_array_equal(want_i[got.shape[0]:], 0.0)


def test_pack_rejects_bad_input():
    with pytest.raises(ValueError):
        tcomp.pack_feat_cols([torch.zeros(100)], 100)
    with pytest.raises(ValueError):
        tcomp.pack_feat_cols([torch.zeros(128, dtype=torch.float64)], 128)


def test_composite_fwd_matches_pallas_interpret(binned):
    bins, feats, ntx, nty = binned
    feat = jcomp._pack_feat_cols(feats, MAX_PAIRS)
    nc = 4
    acc_j, t_j, n_j = jcomp._fwd_call(feat, bins.tile_start,
                                      bins.tile_count, ntx, ntx * nty, nc,
                                      interpret=True)
    acc_t, t_t, n_t = tcomp.composite_fwd(
        torch.from_numpy(np.array(feat)),
        torch.from_numpy(np.array(bins.tile_start)),
        torch.from_numpy(np.array(bins.tile_count)), ntx, nc)
    n_j, n_t = np.asarray(n_j), n_t.numpy()
    same = n_j == n_t
    assert (~same).sum() <= 1e-3 * same.size
    np.testing.assert_allclose(acc_t.numpy()[same], np.asarray(acc_j)[same],
                               atol=2e-5)
    np.testing.assert_allclose(t_t.numpy()[same], np.asarray(t_j)[same],
                               atol=2e-5)
    assert float(1.0 - t_t.min()) > 0.5


def test_composite_fwd_rejects_bad_input():
    feat = torch.zeros((2, 16, 128))
    idx = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError):
        tcomp.composite_fwd(torch.zeros((2, 8, 128)), idx, idx, 3, 4)
    with pytest.raises(ValueError):
        tcomp.composite_fwd(feat, idx.long(), idx, 3, 4)
    with pytest.raises(ValueError):
        tcomp.composite_fwd(feat, idx, idx, 3, 5)

"""The port's fused-rasterizer backward (ops/segreduce.py kernel F,
ops/composite.py kernel E and the autograd Function around bin + pack +
composite) against the JAX package on the same numpy inputs, on the CPU,
where every wrapper runs its plain PyTorch version.

Tolerances:
- `rank_rowsum_plain` vs the JAX fallback (segment_sum) and vs
  `_ranksum_kernel` under interpret=True: rtol 1e-6 with atol 1e-6 (sums
  of a few O(1) float32 values taken in another order; the atol covers
  sums that cancel).
- `composite_bwd_plain` vs `torch.autograd.grad` of `composite_fwd_plain`
  with respect to the stream (an oracle that shares no formula with it):
  atol 1e-6 at cotangents of size 1/(H W C), rtol 1e-4. The replay forms
  the suffix sum by subtraction, autograd by a reverse accumulation.
- fused image and gradients vs the JAX package's routes: impl="chunked"
  and "scan" (autodiff of the portable compositors, their per-tile budget
  asserted to truncate nothing) and, once in the default run, impl="pallas"
  with interpret=True (the real bodies of the TPU kernels E and F): image
  and loss atol 2e-5 / 1e-6, gradients atol 1e-6 on a mean-type loss, the
  tolerance of tests/test_fused_binning.py. Against the JAX shared-bins
  route (`rasterize_tiles_pallas`, interpret=True) the gradients are held
  at 1e-4 of the largest |g|, and against its depth_slices=3 route
  (interpret=True), whose windows add in another order, at atol 5e-5 +
  rtol 2e-4 with the loss at 1e-5 and the image at atol 3e-5 + rtol 5e-5:
  the tolerances the port's own shared-bins and sliced routes were held
  to."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.ops import segreduce_pallas as jseg
from street_gaussians_ns_tpu.ops.composite_chunked import (
    rasterize_tiles_chunked)
from street_gaussians_ns_tpu.ops.composite_jnp import rasterize_tiles_jnp
from street_gaussians_ns_tpu.ops.composite_pallas import (
    rasterize_tiles_pallas, rasterize_tiles_pallas_fused)
from street_gaussians_ns_tpu.ops.tiles import bin_gaussians
from street_gaussians_ns_tpu_torch.core.projection import Projected
from street_gaussians_ns_tpu_torch.ops import composite as tcomp
from street_gaussians_ns_tpu_torch.ops import segreduce as tseg
from street_gaussians_ns_tpu_torch.ops.tiles import TileBins, bin_and_pack

from test_fused_binning import _project
from test_pallas_composite import MAX_PAIRS, make_scene


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Kernel F: rank-keyed row sum.
# ---------------------------------------------------------------------------

def _ranked_rows(seed, n_out, total, ng=10):
    rng = np.random.default_rng(seed)
    ranks = np.sort(rng.integers(0, n_out + 1, size=total)).astype(np.int32)
    vals = rng.standard_normal((ng, total)).astype(np.float32)
    return np.concatenate([vals, ranks[None].astype(np.float32)]), ranks


@pytest.mark.parametrize("seed,n_out,total", [(0, 700, 3000),
                                              (1, 2100, 12000),
                                              (2, 50, 0)])
def test_rank_rowsum_matches_jax_fallback(seed, n_out, total):
    rows, ranks = _ranked_rows(seed, n_out, total)
    got = tseg.rank_rowsum(T(rows), T(ranks), n_out)
    want = jseg.rank_rowsum(jnp.asarray(rows), jnp.asarray(ranks), n_out)
    assert tuple(got.shape) == (10, n_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_rank_rowsum_matches_pallas_interpret():
    rows, ranks = _ranked_rows(0, 700, 3000)
    got = tseg.rank_rowsum(T(rows), T(ranks), 700)
    want = jseg.rank_rowsum(jnp.asarray(rows), jnp.asarray(ranks), 700,
                            interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_rank_rowsum_all_discard():
    ranks = np.full((50,), 7, np.int32)
    rows = np.concatenate([np.ones((3, 50), np.float32),
                           ranks[None].astype(np.float32)])
    got = tseg.rank_rowsum(T(rows), T(ranks), 7)
    want = jseg.rank_rowsum(jnp.asarray(rows), jnp.asarray(ranks), 7,
                            interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.zeros((3, 7), np.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rank_rowsum_rejects_bad_input():
    rows, ranks = _ranked_rows(0, 10, 40)
    with pytest.raises(ValueError):
        tseg.rank_rowsum(T(rows), T(ranks).to(torch.int64), 10)
    with pytest.raises(ValueError):
        tseg.rank_rowsum(T(rows)[:, :30], T(ranks), 10)
    with pytest.raises(ValueError):
        tseg.rank_rowsum(T(rows)[0], T(ranks), 10)


# ---------------------------------------------------------------------------
# Kernel E: backward compositor.
# ---------------------------------------------------------------------------

def _torch_proj(p) -> Projected:
    return Projected(**{f.name: T(getattr(p, f.name))
                        for f in dataclasses.fields(Projected)})


def _stream(seed, n, w, h, opaque, nc=4):
    means, scales, quats, colors, opac, cam = make_scene(
        n, seed, w=w, h=h, opaque=opaque)
    jp = _project(means, scales, quats, cam)
    p = _torch_proj(jp)
    depth_key = torch.where(p.num_tiles_hit > 0, p.depths,
                            torch.full_like(p.depths, float("inf")))
    bins, feats = bin_and_pack(p.xys, p.conics, p.tile_box, depth_key,
                               T(colors)[:, :nc], T(opac), w, h, 16,
                               MAX_PAIRS)
    assert 0 < int(bins.num_pairs) <= MAX_PAIRS
    return tcomp.pack_feat_cols(feats, MAX_PAIRS), bins


@pytest.mark.parametrize("seed,n,w,h,opaque,nc", [
    (0, 60, 48, 32, False, 4), (2, 200, 48, 32, True, 4),
    (3, 120, 50, 37, False, 3)])
def test_composite_bwd_plain_matches_autograd_of_forward(seed, n, w, h,
                                                         opaque, nc):
    feat, bins = _stream(seed, n, w, h, opaque, nc)
    ntx = bins.num_tiles_x
    num_tiles = bins.tile_start.shape[0]
    rng = np.random.default_rng(seed)
    scale = 1.0 / (w * h * nc)
    g_accum = T(rng.standard_normal((num_tiles, 256, nc)).astype(np.float32)
                * scale)
    g_t = T(rng.standard_normal((num_tiles, 256)).astype(np.float32) * scale)

    leaf = feat.clone().requires_grad_(True)
    accum, tfin, ncon = tcomp.composite_fwd_plain(
        leaf, bins.tile_start, bins.tile_count, ntx, nc)
    (want,) = torch.autograd.grad(
        (accum * g_accum).sum() + (tfin * g_t).sum(), leaf)

    got = tcomp.composite_bwd(feat, bins.tile_start, bins.tile_count, ntx,
                              nc, g_accum, g_t, tfin.detach(), ncon,
                              accum.detach())
    assert got.shape == feat.shape
    ng = 6 + nc
    np.testing.assert_allclose(got[:, :ng].numpy(), want[:, :ng].numpy(),
                               atol=1e-6, rtol=1e-4)
    assert float(want[:, :ng].abs().max()) > 10 * scale
    assert not got[:, ng:10].any() and not got[:, 11:].any()
    # Row 10 mirrors the stream's rank on every visited pair.
    nvis = torch.minimum(ncon.amax(dim=1), bins.tile_count)
    pair = tcomp._visited_pairs(bins.tile_start, nvis)
    assert int(nvis.sum()) == pair.shape[0] > 0
    np.testing.assert_array_equal(got[pair // 128, 10, pair % 128].numpy(),
                                  feat[pair // 128, 10, pair % 128].numpy())
    untouched = torch.ones(feat.shape[0] * 128, dtype=torch.bool)
    untouched[pair] = False
    assert not got.permute(0, 2, 1).reshape(-1, 16)[untouched].any()


def test_reduce_pair_grads_ranked_matches_scatter_oracle():
    feat, bins = _stream(0, 60, 48, 32, False)
    ntx = bins.num_tiles_x
    accum, tfin, ncon = tcomp.composite_fwd(feat, bins.tile_start,
                                            bins.tile_count, ntx, 4)
    rng = np.random.default_rng(1)
    g_accum = T(rng.standard_normal(accum.shape).astype(np.float32))
    g_t = T(rng.standard_normal(tfin.shape).astype(np.float32))
    gpair = tcomp.composite_bwd(feat, bins.tile_start, bins.tile_count, ntx,
                                4, g_accum, g_t, tfin, ncon, accum)
    nvis = torch.minimum(ncon.amax(dim=1), bins.tile_count)
    n = bins.depth_order.shape[0]
    got = tcomp._reduce_pair_grads_ranked(gpair, bins.tile_start, nvis,
                                          bins.depth_order, n)
    assert tuple(got.shape) == (n, 10)
    # Oracle: scatter-add every pair of the stream (dead ones carry rank
    # 0 and zeros) by its rank, then un-sort through depth_order.
    flat = gpair.numpy().transpose(0, 2, 1).reshape(-1, 16)
    by_rank = np.zeros((n + 1, 10), np.float64)
    np.add.at(by_rank, flat[:, 10].astype(np.int64), flat[:, :10])
    want = np.zeros((n, 10))
    want[bins.depth_order.numpy()] = by_rank[:n]
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_img_to_tiles_inverts_tiles_to_image():
    rng = np.random.default_rng(0)
    img = T(rng.random((37, 50, 3), dtype=np.float32))
    tiles = tcomp._img_to_tiles(img, 3, 4, 3, 50, 37)
    assert tuple(tiles.shape) == (12, 256, 3)
    np.testing.assert_array_equal(
        tcomp._tiles_to_image(tiles, 4, 3, 50, 37).numpy(), img.numpy())
    assert float(tiles.sum()) == pytest.approx(float(img.sum()), rel=1e-6)


# ---------------------------------------------------------------------------
# The autograd Function against the JAX package.
# ---------------------------------------------------------------------------

BG = np.array([0.2, 0.1, 0.0, 0.0], np.float32)


def _fused_loss_and_grads(seed, n, opaque, jax_impl):
    means, scales, quats, colors, opac, cam = make_scene(
        n, seed, w=48, h=32, opaque=opaque)
    jp = _project(means, scales, quats, cam)
    target = np.asarray(jax.random.uniform(jax.random.PRNGKey(7),
                                           (32, 48, 4)))

    def jloss(args):
        xys, conics, cols, op = args
        bg = jnp.asarray(BG)
        if jax_impl in ("pallas", "sliced"):
            pr = dataclasses.replace(jp, xys=xys, conics=conics)
            img, alpha, _ = rasterize_tiles_pallas_fused(
                pr, cols, op, 48, 32, 16, bg, MAX_PAIRS, interpret=True,
                depth_slices=3 if jax_impl == "sliced" else 1)
        elif jax_impl == "shared_bins":
            img, alpha = rasterize_tiles_pallas(
                xys, conics, cols, op, jbins, 48, 32, 16, bg, interpret=True)
        elif jax_impl == "scan":
            img, alpha = rasterize_tiles_jnp(
                xys, conics, cols, op, jbins, 48, 32, 16, bg, 1024)
        else:
            img, alpha = rasterize_tiles_chunked(
                xys, conics, cols, op, jbins, 48, 32, 16, bg, 1024, 32)
        return (jnp.mean(jnp.abs(img - target))
                + 0.3 * jnp.mean(alpha ** 2)), img

    jbins = bin_gaussians(jp, 48, 32, 16, MAX_PAIRS, opacities=opac)
    assert int(jbins.max_tile_count) <= 1024
    (jl, jimg), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        (jp.xys, jp.conics, colors, opac))

    p = _torch_proj(jp)
    leaves = [T(a).requires_grad_(True)
              for a in (jp.xys, jp.conics, colors, opac)]
    pr = dataclasses.replace(p, xys=leaves[0], conics=leaves[1])
    img, alpha, bins = tcomp.rasterize_tiles_fused(
        pr, leaves[2], leaves[3], 48, 32, 16, T(BG), MAX_PAIRS)
    tl = (img - T(target)).abs().mean() + 0.3 * (alpha ** 2).mean()
    tg = torch.autograd.grad(tl, leaves)
    assert isinstance(bins, TileBins)
    assert int(bins.num_pairs) == int(jbins.num_pairs)
    return (float(jl), np.asarray(jimg), jg), (float(tl.detach()), img.detach(), tg)


def _assert_fused_close(j, t, jax_impl):
    (jl, jimg, jg), (tl, timg, tg) = j, t
    sliced = jax_impl == "sliced"
    assert tl == pytest.approx(jl, abs=1e-5 if sliced else 1e-6)
    np.testing.assert_allclose(timg.numpy(), jimg, atol=3e-5 if sliced
                               else 2e-5, rtol=5e-5 if sliced else 0)
    for name, a, b in zip(["xys", "conics", "colors", "opac"], tg, jg):
        b = np.asarray(b)
        top = float(np.abs(b).max())
        assert top > 1e-5, name
        tol = {"shared_bins": dict(atol=1e-4 * top, rtol=0),
               "sliced": dict(atol=5e-5, rtol=2e-4)}.get(
                   jax_impl, dict(atol=1e-6))
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **tol)


@pytest.mark.parametrize("jax_impl", ["chunked", "scan"])
@pytest.mark.parametrize("seed,n,opaque", [(0, 60, False), (2, 200, True),
                                           (0, 200, False), (2, 60, True)])
def test_fused_image_and_grads_match_jax_chunked(seed, n, opaque, jax_impl):
    _assert_fused_close(*_fused_loss_and_grads(seed, n, opaque, jax_impl),
                        jax_impl)


@pytest.mark.parametrize("seed,n,opaque,jax_impl", [
    (0, 60, False, "pallas"),
    pytest.param(2, 200, True, "pallas", marks=pytest.mark.slow),
    (0, 60, False, "shared_bins"),
    (0, 60, False, "sliced")])
def test_fused_image_and_grads_match_jax_pallas_interpret(seed, n, opaque,
                                                          jax_impl):
    _assert_fused_close(*_fused_loss_and_grads(seed, n, opaque, jax_impl),
                        jax_impl)


def test_fused_backward_with_unused_heads_and_no_pairs():
    """Only alpha feeds the loss (the subset renders of the entropy
    loss): the image cotangent is absent; and a render that bins no pair
    gives zero gradients of the right shapes."""
    means, scales, quats, colors, opac, cam = make_scene(60, 0, w=48, h=32)
    p = _torch_proj(_project(means, scales, quats, cam))
    xys = p.xys.clone().requires_grad_(True)
    op = T(opac).requires_grad_(True)
    _, alpha, _ = tcomp.rasterize_tiles_fused(
        dataclasses.replace(p, xys=xys), T(colors), op, 48, 32, 16,
        torch.zeros(4), MAX_PAIRS)
    g_xys, g_op = torch.autograd.grad(alpha.mean(), (xys, op))
    assert float(g_op.abs().max()) > 0 and bool(torch.isfinite(g_xys).all())

    hidden = dataclasses.replace(
        p, xys=xys, num_tiles_hit=torch.zeros_like(p.num_tiles_hit))
    img, alpha, bins = tcomp.rasterize_tiles_fused(
        hidden, T(colors), op, 48, 32, 16, torch.zeros(4), MAX_PAIRS)
    assert int(bins.num_pairs) == 0
    g_xys, g_op = torch.autograd.grad(img.sum() + alpha.sum(), (xys, op))
    assert not g_xys.any() and not g_op.any()

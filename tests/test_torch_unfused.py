"""The port's bins-shared route (ops/tiles.bin_gaussians,
ops/composite._build_feat, _reduce_pair_grads through kernel G, and
rasterize_tiles_pallas as an autograd Function) against the JAX package
on the same numpy inputs, on the CPU, where every kernel wrapper runs its
plain PyTorch version.

- bin_gaussians: every int field of TileBins bit for bit (the same
  integer arithmetic in the same order).
- _build_feat: the stream exactly (a gather of the same float32 values).
- the unfused image and gradients against
  rasterize_tiles_pallas(interpret=True), the real bodies of the TPU
  kernels: image atol 2e-5, gradients atol 1e-4 of the largest |g| of the
  group.
- fused against unfused within the port: loss and gradients at atol 1e-6
  on a mean-type loss, the tolerance of tests/test_fused_binning.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.ops import composite_pallas as jcomp
from street_gaussians_ns_tpu.ops import tiles as jtiles
from street_gaussians_ns_tpu_torch.core.projection import Projected
from street_gaussians_ns_tpu_torch.ops import composite as tcomp
from street_gaussians_ns_tpu_torch.ops import tiles as ttiles

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


INT_FIELDS = ("gauss_idx", "pair_valid", "tile_start", "tile_count",
              "num_pairs", "num_rowruns", "exp_slot", "depth_order",
              "exp_starts", "exp_counts")
BG = np.array([0.2, 0.1, 0.0, 0.0], np.float32)


def T(x):
    return torch.from_numpy(np.array(x))


def _torch_proj(p) -> Projected:
    return Projected(**{f.name: T(getattr(p, f.name))
                        for f in dataclasses.fields(Projected)})


def _bins_arrays(jb) -> dict:
    return {f.name: np.asarray(getattr(jb, f.name))
            for f in dataclasses.fields(jb)}


def _scene(seed, n, w, h, n_hidden=0, opaque=False):
    means, scales, quats, colors, opac, cam = make_scene(n, seed, w=w, h=h,
                                                         opaque=opaque)
    if n_hidden:
        means = means.at[:n_hidden, 2].set(5.0)     # behind the camera
    return _project(means, scales, quats, cam), colors, opac


def _assert_bins_equal(tb, jb):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert (tb.num_tiles_x, tb.num_tiles_y) == (jb.num_tiles_x,
                                                jb.num_tiles_y)
    assert int(tb.max_tile_count) == int(jb.max_tile_count)


@pytest.mark.parametrize("seed,n,w,h,n_hidden,with_opac", [
    (0, 150, 48, 32, 0, True),
    (1, 150, 48, 32, 30, False),
    (2, 200, 50, 37, 0, False),
    (3, 200, 50, 37, 40, True)])
def test_bin_gaussians_matches_jax(seed, n, w, h, n_hidden, with_opac):
    p, _, opac = _scene(seed, n, w, h, n_hidden)
    jb = jtiles.bin_gaussians(p, w, h, 16, 8192,
                              opacities=opac if with_opac else None)
    tb = ttiles.bin_gaussians(_torch_proj(p), w, h, 16, 8192,
                              opacities=T(opac) if with_opac else None)
    assert 0 < int(tb.num_pairs) <= 8192
    _assert_bins_equal(tb, jb)


def test_bin_gaussians_overflow_matches_jax():
    """Both capacities overflow: the same truncated enumeration, and the
    run count still the true one."""
    p, _, opac = _scene(4, 300, 48, 32)
    full = ttiles.bin_gaussians(_torch_proj(p), 48, 32, 16, 16384,
                                opacities=T(opac))
    assert int(full.num_pairs) > 256 and int(full.num_rowruns) > 128
    jb = jtiles.bin_gaussians(p, 48, 32, 16, 256, opacities=opac)
    tb = ttiles.bin_gaussians(_torch_proj(p), 48, 32, 16, 256,
                              opacities=T(opac))
    _assert_bins_equal(tb, jb)
    assert int(tb.num_rowruns) == int(full.num_rowruns)


def test_untrimmed_rows_count_more_runs_than_the_fused_binning():
    p, colors, opac = _scene(0, 150, 48, 32)
    tp = _torch_proj(p)
    shared = ttiles.bin_gaussians(tp, 48, 32, 16, 8192, opacities=T(opac))
    fused, _ = ttiles.bin_and_pack(
        tp.xys, tp.conics, tp.tile_box, tcomp._depth_key(tp), T(colors),
        T(opac), 48, 32, 16, 8192)
    assert int(shared.num_pairs) == int(fused.num_pairs)
    assert int(shared.num_rowruns) >= int(fused.num_rowruns)
    for name in ("tile_start", "tile_count", "pair_valid", "depth_order",
                 "exp_starts", "exp_counts"):
        assert torch.equal(getattr(shared, name), getattr(fused, name)), name
    assert fused.gauss_idx is None and fused.exp_slot is None


def test_bin_and_pack_with_gauss_idx_matches_shared_bins():
    p, colors, opac = _scene(3, 200, 50, 37, n_hidden=40)
    tp = _torch_proj(p)
    shared = ttiles.bin_gaussians(tp, 50, 37, 16, 8192, opacities=T(opac))
    fused, feats = ttiles.bin_and_pack(
        tp.xys, tp.conics, tp.tile_box, tcomp._depth_key(tp), T(colors),
        T(opac), 50, 37, 16, 8192, with_gauss_idx=True)
    assert len(feats) == 10
    valid = shared.pair_valid
    assert torch.equal(fused.exp_slot, shared.exp_slot)
    assert torch.equal(fused.gauss_idx[valid], shared.gauss_idx[valid])
    assert bool((fused.gauss_idx[~valid] == 200).all())
    np.testing.assert_array_equal(
        feats[0][valid].numpy(),
        tp.xys[shared.gauss_idx[valid].long(), 0].numpy())


def test_owner_by_scatter():
    # Runs 0, 3, 4 start at slots 0, 3, 5; runs 1, 2, 5 are empty and
    # carry the sentinel (the capacity, 9).
    live = torch.tensor([0, 9, 9, 3, 5, 9], dtype=torch.int32)
    owner = ttiles._owner_by_scatter(live, 9)
    np.testing.assert_array_equal(owner.numpy(), [0, 0, 0, 3, 3, 4, 4, 4, 4])
    late = ttiles._owner_by_scatter(torch.tensor([2, 4], dtype=torch.int32),
                                    6)
    np.testing.assert_array_equal(late.numpy(), [-1, -1, 0, 0, 1, 1])


def test_bins_from_numpy_round_trip():
    p, _, opac = _scene(0, 150, 48, 32)
    jb = jtiles.bin_gaussians(p, 48, 32, 16, 8192, opacities=opac)
    tb = ttiles.bins_from_numpy(_bins_arrays(jb), device="cpu")
    _assert_bins_equal(tb, jb)
    assert tb.num_pairs.dtype == torch.int64
    assert tb.gauss_idx.dtype == torch.int32


@pytest.mark.parametrize("seed,n,nc", [(0, 60, 4), (2, 200, 3)])
def test_build_feat_matches_jax(seed, n, nc):
    p, colors, opac = _scene(seed, n, 48, 32)
    jb = jtiles.bin_gaussians(p, 48, 32, 16, MAX_PAIRS, opacities=opac)
    want = np.asarray(jcomp._build_feat(p.xys, p.conics, colors[:, :nc],
                                        opac, jb))
    tb = ttiles.bins_from_numpy(_bins_arrays(jb), device="cpu")
    got = tcomp._build_feat(T(p.xys), T(p.conics), T(colors)[:, :nc],
                            T(opac), tb)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[-1].any() and not got[:, 6 + nc:].any()


def test_reduce_pair_grads_matches_scatter_oracle():
    p, colors, opac = _scene(0, 60, 48, 32)
    tp = _torch_proj(p)
    bins = ttiles.bin_gaussians(tp, 48, 32, 16, MAX_PAIRS, opacities=T(opac))
    feat = tcomp._build_feat(tp.xys, tp.conics, T(colors), T(opac), bins)
    ntx = bins.num_tiles_x
    accum, tfin, ncon = tcomp.composite_fwd(feat, bins.tile_start,
                                            bins.tile_count, ntx, 4)
    rng = np.random.default_rng(1)
    g_accum = T(rng.standard_normal(accum.shape).astype(np.float32))
    g_t = T(rng.standard_normal(tfin.shape).astype(np.float32))
    gpair = tcomp.composite_bwd(feat, bins.tile_start, bins.tile_count, ntx,
                                4, g_accum, g_t, tfin, ncon, accum)
    assert not gpair[:, 10].any()          # this stream carries no rank
    got = tcomp._reduce_pair_grads(gpair, bins, 4)
    assert tuple(got.shape) == (60, 10)
    flat = gpair.numpy().transpose(0, 2, 1).reshape(-1, 16)[:MAX_PAIRS]
    valid = bins.pair_valid.numpy()
    want = np.zeros((60, 10))
    np.add.at(want, bins.gauss_idx.numpy()[valid], flat[valid, :10])
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _torch_loss_and_grads(jp, colors, opac, target, route):
    p = _torch_proj(jp)
    leaves = [T(a).requires_grad_(True)
              for a in (jp.xys, jp.conics, colors, opac)]
    if route == "fused":
        pr = dataclasses.replace(p, xys=leaves[0], conics=leaves[1])
        img, alpha, _ = tcomp.rasterize_tiles_fused(
            pr, leaves[2], leaves[3], 48, 32, 16, T(BG), MAX_PAIRS)
    else:
        bins = ttiles.bin_gaussians(p, 48, 32, 16, MAX_PAIRS)
        img, alpha = tcomp.rasterize_tiles_pallas(
            *leaves, bins, 48, 32, 16, T(BG))
    loss = (img - T(target)).abs().mean() + 0.3 * (alpha ** 2).mean()
    return float(loss.detach()), img.detach(), \
        torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("seed,n,opaque", [
    (0, 60, False),
    pytest.param(2, 200, True, marks=pytest.mark.slow)])
def test_unfused_image_and_grads_match_jax_pallas_interpret(seed, n, opaque):
    jp, colors, opac = _scene(seed, n, 48, 32, opaque=opaque)
    target = np.asarray(jax.random.uniform(jax.random.PRNGKey(7),
                                           (32, 48, 4)))
    jbins = jtiles.bin_gaussians(jp, 48, 32, 16, MAX_PAIRS)

    def jloss(args):
        img, alpha = jcomp.rasterize_tiles_pallas(
            *args, jbins, 48, 32, 16, jnp.asarray(BG), interpret=True)
        return (jnp.mean(jnp.abs(img - target))
                + 0.3 * jnp.mean(alpha ** 2)), img

    (jl, jimg), jg = jax.value_and_grad(jloss, has_aux=True)(
        (jp.xys, jp.conics, colors, opac))
    tl, timg, tg = _torch_loss_and_grads(jp, colors, opac, target, "unfused")
    assert tl == pytest.approx(float(jl), abs=1e-6)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=2e-5)
    for name, a, b in zip(["xys", "conics", "colors", "opac"], tg, jg):
        b = np.asarray(b)
        top = float(np.abs(b).max())
        assert top > 1e-5, name
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * top, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("seed,n,opaque", [(0, 60, False), (2, 200, True)])
def test_fused_matches_unfused(seed, n, opaque):
    jp, colors, opac = _scene(seed, n, 48, 32, opaque=opaque)
    target = np.asarray(jax.random.uniform(jax.random.PRNGKey(7),
                                           (32, 48, 4)))
    lf, img_f, gf = _torch_loss_and_grads(jp, colors, opac, target, "fused")
    lu, img_u, gu = _torch_loss_and_grads(jp, colors, opac, target,
                                          "unfused")
    assert lf == pytest.approx(lu, abs=1e-6)
    np.testing.assert_allclose(img_f.numpy(), img_u.numpy(), atol=1e-6)
    for name, a, b in zip(["xys", "conics", "colors", "opac"], gf, gu):
        assert float(b.abs().max()) > 1e-5, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   err_msg=name)


def test_unfused_rejects_fused_bins():
    p, colors, opac = _scene(0, 60, 48, 32)
    tp = _torch_proj(p)
    fused, _ = ttiles.bin_and_pack(
        tp.xys, tp.conics, tp.tile_box, tcomp._depth_key(tp), T(colors),
        T(opac), 48, 32, 16, MAX_PAIRS)
    with pytest.raises(ValueError, match="bin_gaussians"):
        tcomp.rasterize_tiles_pallas(tp.xys, tp.conics, T(colors), T(opac),
                                     fused, 48, 32, 16, T(BG))

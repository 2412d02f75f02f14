"""The port's depth-sliced fused rasterizer (ops/composite._SlicedRasterize
behind rasterize_tiles_fused(depth_slices=k)), the t_in / tile0 modes of
kernels D and E, and the strip compositor (composite_tiles_fused), on the
CPU, where every kernel wrapper runs its plain PyTorch version.

- sliced against the port's own unsliced path for k = 2, 3: image and
  alpha atol 3e-5, gradients atol 5e-5 + rtol 2e-4, the tolerances of
  tests/test_depth_slices.py (the windows' accums add in another order);
  once against the JAX package with depth_slices=3 in interpret mode at
  the same tolerances (the image with rtol 5e-5 added for its depth
  channel).
- the plain D / E with t_in against the JAX `_fwd_call(t_in=)` /
  `_bwd_call(with_tin=True)` in interpret mode: accum and T atol 2e-5,
  n_contrib exact, per-pair gradients atol 1e-4 of the largest.
- strips reproduce the full image at atol 1e-5 and the full gradients at
  2e-4, as tests/test_fused_binning.py holds the JAX strips."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.core.cameras import viewmat_from_c2w as jviewmat
from street_gaussians_ns_tpu.core.projection import project as jproject
from street_gaussians_ns_tpu.ops import composite_pallas as jcomp
from street_gaussians_ns_tpu_torch.core.cameras import Camera as TCamera
from street_gaussians_ns_tpu_torch.core.cameras import viewmat_from_c2w
from street_gaussians_ns_tpu_torch.core.projection import Projected, project
from street_gaussians_ns_tpu_torch.ops import composite as tcomp
from street_gaussians_ns_tpu_torch.ops import tiles as ttiles

from test_fused_binning import _project
from test_pallas_composite import make_scene


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MAX_PAIRS = 16384


def T(x):
    return torch.from_numpy(np.array(x))


def _torch_proj(p) -> Projected:
    return Projected(**{f.name: T(getattr(p, f.name))
                        for f in dataclasses.fields(Projected)})


def _run(n_slices, n=220, seed=3, opaque=False, with_active_pad=False,
         precision="f32"):
    """tests/test_depth_slices.py:_run through the port: loss, image,
    alpha, bins and the gradients of (means, scales, quats, colors,
    opacities)."""
    means, scales, quats, colors, opac, cam = make_scene(n, seed,
                                                         opaque=opaque)
    if with_active_pad:
        opac = opac.at[-40:].set(0.0)
    leaves = [T(a).requires_grad_(True)
              for a in (means, scales, quats, colors, opac)]
    tcam = TCamera.make(cam.fx, cam.fy, cam.cx, cam.cy, np.array(cam.c2w),
                        cam.width, cam.height, device="cpu")
    p = project(leaves[0], leaves[1], leaves[2], viewmat_from_c2w(tcam.c2w),
                tcam.fx, tcam.fy, tcam.cx, tcam.cy, cam.width, cam.height,
                tile_size=16, opacities=leaves[4].detach())
    if with_active_pad:
        live = leaves[4] > 0
        p = dataclasses.replace(
            p, radii=torch.where(live, p.radii, 0),
            num_tiles_hit=torch.where(live, p.num_tiles_hit, 0))
    img, alpha, bins = tcomp.rasterize_tiles_fused(
        p, leaves[3], leaves[4], cam.width, cam.height, 16, torch.zeros(4),
        MAX_PAIRS, None, last_color_is_depth=True, depth_slices=n_slices,
        precision=precision)
    val = ((img * torch.cos(img + 0.3)).mean()
           + 0.5 * (alpha * torch.sin(alpha * 2.0)).mean())
    grads = torch.autograd.grad(val, leaves)
    return float(val.detach()), img.detach(), alpha.detach(), bins, grads


@pytest.fixture(scope="module")
def unsliced():
    return _run(1)


def _assert_same_render(got, want):
    _, img_k, a_k, _, g_k = got
    _, img_1, a_1, _, g_1 = want
    np.testing.assert_allclose(img_k.numpy(), img_1.numpy(), atol=3e-5)
    np.testing.assert_allclose(a_k.numpy(), a_1.numpy(), atol=3e-5)
    for name, a, b in zip(["means", "scales", "quats", "colors", "opac"],
                          g_k, g_1):
        assert float(b.abs().max()) > 0, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5,
                                   rtol=2e-4, err_msg=name)


@pytest.mark.parametrize("k", [2, 3])
def test_sliced_matches_unsliced(k, unsliced):
    got = _run(k)
    _assert_same_render(got, unsliced)
    assert float(unsliced[2].max()) > 0.5


def test_sliced_demand_counts_and_public_bins(unsliced):
    b1 = unsliced[3]
    b3 = _run(3)[3]
    # The capacity demand: k times the fullest window's true count.
    assert int(b1.num_pairs) <= int(b3.num_pairs) <= 3 * int(b1.num_pairs)
    assert int(b3.num_rowruns) >= int(b1.num_rowruns)
    # The windows are balanced by pair count: the demand stays near the
    # true total.
    assert int(b3.num_pairs) <= 1.25 * int(b1.num_pairs)
    # The aggregate tile counts are the unsliced ones, whatever tiles the
    # later windows dropped.
    assert torch.equal(b3.tile_count, b1.tile_count)
    assert int(b3.max_tile_count) == int(b1.max_tile_count)
    assert torch.equal(b3.depth_order, b1.depth_order)
    for name in ("pair_valid", "tile_start", "exp_starts", "exp_counts",
                 "gauss_idx", "exp_slot"):
        assert getattr(b3, name) is None, name


def test_sliced_with_inactive_trailing_slots():
    _assert_same_render(_run(3, with_active_pad=True),
                        _run(1, with_active_pad=True))


def test_sliced_opaque_scene_drops_saturated_tiles():
    """Opaque splats saturate pixels in the first window; the later ones
    must add nothing there and the result must not move."""
    _assert_same_render(_run(2, n=300, seed=2, opaque=True),
                        _run(1, n=300, seed=2, opaque=True))


def test_sliced_matches_jax_sliced_interpret(unsliced):
    means, scales, quats, colors, opac, cam = make_scene(220, 3)

    def loss(means, scales, quats, colors, opac):
        p = jproject(means, scales, quats, jviewmat(cam.c2w), cam.fx, cam.fy,
                     cam.cx, cam.cy, cam.width, cam.height, tile_size=16,
                     opacities=jax.lax.stop_gradient(opac))
        img, alpha, bins = jcomp.rasterize_tiles_pallas_fused(
            p, colors, opac, cam.width, cam.height, 16,
            jnp.zeros((4,), jnp.float32), MAX_PAIRS, None, interpret=True,
            last_color_is_depth=True, depth_slices=3)
        return (jnp.mean(img * jnp.cos(img + 0.3))
                + 0.5 * jnp.mean(alpha * jnp.sin(alpha * 2.0)),
                (img, alpha, bins))

    (jval, (jimg, jalpha, jbins)), jgrads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        means, scales, quats, colors, opac)
    val, img, alpha, bins, grads = _run(3)
    assert val == pytest.approx(float(jval), abs=1e-5)
    # The fourth channel is depth (values up to 10): the TPU kernel forms
    # the transmittance in log space, the port as a running product, so
    # that channel is held relatively.
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=3e-5,
                               rtol=5e-5)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), atol=3e-5)
    for name, a, b in zip(["means", "scales", "quats", "colors", "opac"],
                          grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5,
                                   rtol=2e-4, err_msg=name)
    assert int(bins.num_pairs) == int(jbins.num_pairs)
    assert int(bins.num_rowruns) == int(jbins.num_rowruns)
    np.testing.assert_array_equal(bins.tile_count.numpy(),
                                  np.asarray(jbins.tile_count))


def test_slice_caps():
    assert tcomp._slice_caps(16384, None, 3) == (8192, 8192)
    assert tcomp._slice_caps(4_341_760, 2_105_344, 2) == (2_170_880,
                                                          1_056_768)
    assert tcomp._slice_caps(4_341_760, 2_105_344, 2) == \
        jcomp._slice_caps(4_341_760, 2_105_344, 2)


# ---------------------------------------------------------------------------
# Kernels D and E: t_in and tile0.
# ---------------------------------------------------------------------------

def _two_windows(seed=3, n=220, opaque=False):
    """The scene binned in two depth windows of equal gaussian count:
    per window (feat, bins), and the projected scene."""
    means, scales, quats, colors, opac, cam = make_scene(n, seed, w=48, h=32,
                                                         opaque=opaque)
    p = _torch_proj(_project(means, scales, quats, cam))
    cols = ttiles._depth_sort_cols(p.xys, p.conics, p.tile_box,
                                   tcomp._depth_key(p), T(colors), T(opac),
                                   False)
    out = []
    for s in range(2):
        bins, feats = ttiles._bin_sorted(cols, (s * (n // 2), n // 2), 48, 32,
                                         16, 8192, 4096)
        out.append((tcomp.pack_feat_cols(feats, 8192), bins))
    return out, p, T(colors), T(opac)


@pytest.mark.parametrize("opaque", [False, True])
def test_plain_fwd_and_bwd_with_t_in_match_jax_interpret(opaque):
    (w0, w1), _, _, _ = _two_windows(opaque=opaque, seed=2 if opaque else 3,
                                     n=300 if opaque else 220)
    ntx, num_tiles = 3, 6
    _, t_in, _ = tcomp.composite_fwd(w0[0], w0[1].tile_start,
                                     w0[1].tile_count, ntx, 4)
    if opaque:
        # A terminated pixel keeps the transmittance it had before the
        # pair that ended it, which is above 1e-4, so no pixel of a real
        # chain arrives done: mark some by hand.
        assert float(t_in.min()) > 1e-4
        t_in[:, ::7] = 5e-5
    feat, bins = w1
    accum, tfin, ncon = tcomp.composite_fwd(feat, bins.tile_start,
                                            bins.tile_count, ntx, 4,
                                            t_in=t_in)
    jfeat = jnp.asarray(feat.numpy())
    jst, jct = (jnp.asarray(bins.tile_start.numpy()),
                jnp.asarray(bins.tile_count.numpy()))
    jacc, jtf, jnc = jcomp._fwd_call(jfeat, jst, jct, ntx, num_tiles, 4,
                                     interpret=True,
                                     t_in=jnp.asarray(t_in.numpy()))
    np.testing.assert_allclose(accum.numpy(), np.asarray(jacc), atol=2e-5)
    np.testing.assert_allclose(tfin.numpy(), np.asarray(jtf), atol=2e-5)
    np.testing.assert_array_equal(ncon.numpy(), np.asarray(jnc))
    # A pixel that arrives done keeps its T and adds nothing.
    arrived = t_in <= 1e-4
    assert torch.equal(tfin[arrived], t_in[arrived])
    # The same pixels marked by a minus sign instead of a tiny value.
    signed = torch.where(arrived, -torch.rand_like(t_in) - 0.01, t_in)
    acc_s, t_s, n_s = tcomp.composite_fwd(feat, bins.tile_start,
                                          bins.tile_count, ntx, 4,
                                          t_in=signed, mark_done=True)
    assert torch.equal(acc_s, accum) and torch.equal(n_s, ncon)
    assert torch.equal(t_s[arrived], signed[arrived])
    assert torch.equal(t_s[~arrived].abs(), tfin[~arrived])
    assert not accum[arrived].any() and not ncon[arrived].any()

    rng = np.random.default_rng(0)
    g_accum = T(rng.standard_normal(accum.shape).astype(np.float32))
    g_t = T(rng.standard_normal(tfin.shape).astype(np.float32))
    gpair = tcomp.composite_bwd(feat, bins.tile_start, bins.tile_count, ntx,
                                4, g_accum, g_t, tfin, ncon, accum,
                                t_in=t_in)
    gdotacc = (g_accum * accum).sum(-1)
    gaux = jnp.asarray(torch.cat([
        g_accum.permute(0, 2, 1),
        torch.stack([g_t, tfin, ncon.to(torch.float32), gdotacc], dim=1),
        t_in[:, None, :]], dim=1).numpy())
    nchunks = jnp.minimum((jct + 127) // 128,
                          (jnp.asarray(ncon.numpy()).max(axis=1) + 127)
                          // 128).astype(jnp.int32)
    jgpair = jcomp._bwd_call(jfeat, jst, jct, nchunks, feat.shape[0], ntx,
                             num_tiles, 4, gaux, interpret=True,
                             with_rank=True, with_tin=True)
    want = np.asarray(jgpair)[:, :10]
    top = float(np.abs(want).max())
    assert top > 0.1
    np.testing.assert_allclose(gpair[:, :10].numpy(), want, atol=1e-4 * top,
                               rtol=0)


def test_t_in_chain_equals_one_pass():
    """Two windows composited one after the other, the second continuing
    the first's transmittance, against the whole scene in one pass."""
    (w0, w1), p, colors, opac = _two_windows()
    ntx = 3
    whole_bins, feats = ttiles.bin_and_pack(
        p.xys, p.conics, p.tile_box, tcomp._depth_key(p), colors, opac, 48,
        32, 16, 16384)
    acc, tfin, _ = tcomp.composite_fwd(
        tcomp.pack_feat_cols(feats, 16384), whole_bins.tile_start,
        whole_bins.tile_count, ntx, 4)
    a0, t0, _ = tcomp.composite_fwd(w0[0], w0[1].tile_start,
                                    w0[1].tile_count, ntx, 4)
    a1, t1, _ = tcomp.composite_fwd(w1[0], w1[1].tile_start,
                                    w1[1].tile_count, ntx, 4, t_in=t0)
    np.testing.assert_allclose((a0 + a1).numpy(), acc.numpy(), atol=3e-5)
    np.testing.assert_allclose(t1.numpy(), tfin.numpy(), atol=3e-5)
    # Global ranks: the second window's pairs carry ranks from n // 2 on.
    live = w1[1].pair_valid
    ranks = w1[0][:-1, 10].reshape(-1)[live]
    assert int(ranks.min()) >= 110 and int(ranks.max()) < 220
    assert torch.equal(w1[1].depth_order, whole_bins.depth_order)


def test_window_forms_of_bin_sorted_agree():
    """One depth window three ways: cut out of the columns (depth_slice),
    masked over all of them (rank_window), and as the live part of a
    larger cut (depth_slice + local_window): the same pairs, tile ranges
    and global ranks."""
    means, scales, quats, colors, opac, cam = make_scene(220, 3, w=48, h=32)
    p = _torch_proj(_project(means, scales, quats, cam))
    cols = ttiles._depth_sort_cols(p.xys, p.conics, p.tile_box,
                                   tcomp._depth_key(p), T(colors), T(opac),
                                   False)
    args = (48, 32, 16, 8192, 4096)
    lo, hi = 60, 150
    cut, f_cut = ttiles._bin_sorted(cols, (lo, hi - lo), *args)
    masked, f_masked = ttiles._bin_sorted(
        cols, None, *args, rank_window=(torch.tensor(lo), torch.tensor(hi)),
        trim=ttiles._trim_full(cols, 16, 2))
    local, f_local = ttiles._bin_sorted(
        cols, (40, 140), *args,
        local_window=(torch.tensor(lo - 40), torch.tensor(hi - 40)))
    assert int(cut.num_pairs) > 100
    for other, feats in ((masked, f_masked), (local, f_local)):
        for name in ("tile_start", "tile_count", "pair_valid", "num_pairs",
                     "num_rowruns", "depth_order"):
            assert torch.equal(getattr(other, name), getattr(cut, name)), name
        for a, b in zip(feats, f_cut):
            assert torch.equal(a, b)
    assert int(cut.exp_counts.sum()) == int(masked.exp_counts.sum())
    assert torch.equal(masked.exp_counts[lo:hi], cut.exp_counts)
    assert not masked.exp_counts[:lo].any()
    with pytest.raises(ValueError):
        ttiles._bin_sorted(cols, (0, 10), *args, rank_window=(0, 10))


def test_done_state_crosses_windows_in_the_sign():
    """A pixel ended by an opaque splat of window 1 keeps a transmittance
    far above 1e-4. Handed on by magnitude alone it would take pairs of
    window 2; with mark_done the chain ends it where one pass does."""
    (w0, w1), p, colors, opac = _two_windows(seed=2, n=300, opaque=True)
    ntx = 3
    whole_bins, feats = ttiles.bin_and_pack(
        p.xys, p.conics, p.tile_box, tcomp._depth_key(p), colors, opac, 48,
        32, 16, 16384)
    acc, tfin, _ = tcomp.composite_fwd(
        tcomp.pack_feat_cols(feats, 16384), whole_bins.tile_start,
        whole_bins.tile_count, ntx, 4)

    def chain(mark_done):
        a0, t0, _ = tcomp.composite_fwd(w0[0], w0[1].tile_start,
                                        w0[1].tile_count, ntx, 4,
                                        mark_done=mark_done)
        a1, t1, n1 = tcomp.composite_fwd(w1[0], w1[1].tile_start,
                                         w1[1].tile_count, ntx, 4, t_in=t0,
                                         mark_done=mark_done)
        return a0 + a1, t1.abs(), t0, n1

    a_m, t_m, t0_m, n1_m = chain(True)
    assert bool((t0_m < 0).any()) and float(t0_m.abs().min()) > 1e-4
    np.testing.assert_allclose(a_m.numpy(), acc.numpy(), atol=3e-5)
    np.testing.assert_allclose(t_m.numpy(), tfin.numpy(), atol=3e-5)
    assert not n1_m[t0_m < 0].any()
    a_u, t_u, _, n1_u = chain(False)
    assert bool(n1_u[t0_m < 0].any())
    assert float((t_u - tfin).abs().max()) > 1e-4


def test_tile0_strip_equals_the_full_launch_bit_for_bit():
    (w0, _), _, _, _ = _two_windows()
    feat, bins = w0
    ntx = 3
    full = tcomp.composite_fwd(feat, bins.tile_start, bins.tile_count, ntx, 4)
    rng = np.random.default_rng(0)
    g_accum = T(rng.standard_normal(full[0].shape).astype(np.float32))
    g_t = T(rng.standard_normal(full[1].shape).astype(np.float32))
    gfull = tcomp.composite_bwd(feat, bins.tile_start, bins.tile_count, ntx,
                                4, g_accum, g_t, full[1], full[2], full[0])
    gsum = torch.zeros_like(gfull)
    for tile0 in (0, 2, 4):
        sl = slice(tile0, tile0 + 2)
        st = bins.tile_start[sl].contiguous()
        ct = bins.tile_count[sl].contiguous()
        part = tcomp.composite_fwd(feat, st, ct, ntx, 4, tile0=tile0)
        for a, b in zip(part, full):
            assert torch.equal(a, b[sl])
        gsum += tcomp.composite_bwd(
            feat, st, ct, ntx, 4, g_accum[sl].contiguous(),
            g_t[sl].contiguous(), part[1], part[2], part[0], tile0=tile0)
    # Every pair belongs to one tile: the strips' gradient streams are
    # disjoint and add up to the full launch's (the rank row thrice).
    assert torch.equal(gsum[:, :10], gfull[:, :10])
    shifted = tcomp.composite_fwd(feat, bins.tile_start[2:4].contiguous(),
                                  bins.tile_count[2:4].contiguous(), ntx, 4)
    assert not torch.equal(shifted[0], full[0][2:4])


def test_kernel_mode_arguments_are_checked():
    (w0, _), _, _, _ = _two_windows()
    feat, bins = w0
    with pytest.raises(ValueError):
        tcomp.composite_fwd(feat, bins.tile_start, bins.tile_count, 3, 4,
                            t_in=torch.ones((5, 256)))
    with pytest.raises(TypeError):
        tcomp.composite_fwd(feat, bins.tile_start, bins.tile_count, 3, 4,
                            t_in=torch.ones((6, 256), dtype=torch.float64))


# ---------------------------------------------------------------------------
# Strips.
# ---------------------------------------------------------------------------

def _strip_scene():
    means, scales, quats, colors, opac, cam = make_scene(150, 1, w=80, h=32)
    return _torch_proj(_project(means, scales, quats, cam)), T(colors), \
        T(opac)


def _leaves(p, colors, opac):
    leaves = [t.clone().requires_grad_(True)
              for t in (p.xys, p.conics, colors, opac)]
    return leaves, dataclasses.replace(p, xys=leaves[0], conics=leaves[1])


def test_strips_reproduce_full_image_and_grads():
    """4 strips of 3 tiles over a 5 x 2 grid: the last strip is tile 9 and
    two pad tiles."""
    p, colors, opac = _strip_scene()
    W2, H2 = 80, 32
    leaves, pr = _leaves(p, colors, opac)
    img_f, a_f, _ = tcomp.rasterize_tiles_fused(
        pr, leaves[2], leaves[3], W2, H2, 16, torch.zeros(4), MAX_PAIRS)
    g_f = torch.autograd.grad((img_f ** 2).sum() + a_f.sum(), leaves)

    leaves, pr = _leaves(p, colors, opac)
    accs, alphas = [], []
    for s in range(4):
        accum, alpha, bins = tcomp.composite_tiles_fused(
            pr, leaves[2], leaves[3], s * 3, 3, W2, H2, MAX_PAIRS)
        assert tuple(accum.shape) == (3, 256, 4)
        accs.append(accum)
        alphas.append(alpha)
    assert not accs[3][1:].any() and not alphas[3][1:].any()   # pad tiles
    img_s = tcomp._tiles_to_image(torch.cat(accs)[:10], 5, 2, W2, H2)
    a_s = tcomp._tiles_to_image(torch.cat(alphas)[:10], 5, 2, W2, H2)
    g_s = torch.autograd.grad((img_s ** 2).sum() + a_s.sum(), leaves)
    np.testing.assert_allclose(img_s.detach().numpy(), img_f.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(a_s.detach().numpy(), a_f.detach().numpy(),
                               atol=1e-5)
    for name, a, b in zip(["xys", "conics", "colors", "opac"], g_s, g_f):
        assert float(b.abs().max()) > 0, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4,
                                   err_msg=name)
    assert int(bins.num_pairs) > 0 and bins.gauss_idx is None


def test_strip_depth_windows_merge_to_the_full_image():
    """Two depth windows of every tile, merged front to back by the over
    operator, give the unsliced image; their gradients add."""
    p, colors, opac = _strip_scene()
    W2, H2 = 80, 32
    leaves, pr = _leaves(p, colors, opac)
    img_f, a_f, _ = tcomp.rasterize_tiles_fused(
        pr, leaves[2], leaves[3], W2, H2, 16, torch.zeros(4), MAX_PAIRS)
    g_f = torch.autograd.grad((img_f ** 2).sum() + a_f.sum(), leaves)

    leaves, pr = _leaves(p, colors, opac)
    c0, al0, _ = tcomp.composite_tiles_fused(
        pr, leaves[2], leaves[3], 0, 10, W2, H2, MAX_PAIRS, slice0=0,
        slice_size=75)
    c1, al1, _ = tcomp.composite_tiles_fused(
        pr, leaves[2], leaves[3], 0, 10, W2, H2, MAX_PAIRS,
        slice0=torch.tensor(75), slice_size=75)
    t0 = 1.0 - al0
    accum = c0 + t0[..., None] * c1
    alpha = 1.0 - t0 * (1.0 - al1)
    img_s = tcomp._tiles_to_image(accum, 5, 2, W2, H2)
    a_s = tcomp._tiles_to_image(alpha, 5, 2, W2, H2)
    np.testing.assert_allclose(img_s.detach().numpy(), img_f.detach().numpy(),
                               atol=3e-5)
    np.testing.assert_allclose(a_s.detach().numpy(), a_f.detach().numpy(),
                               atol=3e-5)
    g_s = torch.autograd.grad((img_s ** 2).sum() + a_s.sum(), leaves)
    for name, a, b in zip(["xys", "conics", "colors", "opac"], g_s, g_f):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4,
                                   rtol=2e-4, err_msg=name)


# ---------------------------------------------------------------------------
# Through the scene graph and the training step.
# ---------------------------------------------------------------------------

def test_scene_train_step_sliced_and_chunked_match_fused():
    """forward_scene and one scene_train_step with
    RenderConfig(depth_slices=2) and with impl="chunked" against the fused
    route, from the same state and jitter: heads at atol 3e-5, the loss at
    1e-6, every gradient at 2e-4 of its group's largest |g|, the metrics'
    max_tile_count the scene's densest tile in every mode."""
    import chip_smoke as cs
    from street_gaussians_ns_tpu_torch.engine import scene_train_step as sts
    from street_gaussians_ns_tpu_torch.engine.checkpoints import (
        tracks_from_numpy, train_state_from_numpy)
    from street_gaussians_ns_tpu_torch.models.scene_graph import forward_scene
    from street_gaussians_ns_tpu_torch.ops.render import RenderConfig

    store_np, tracks_np = cs.make_scene(1, 600, 2, 80, 16, sh_degree=1)
    cfg = cs.scene_config(1, 16, 5)
    late = cfg.background.stop_split_at + 1
    tracks = tracks_from_numpy(tracks_np, device="cpu")
    cam = TCamera.make(60.0, 60.0, 32.0, 24.0, np.eye(3, 4, dtype=np.float32),
                       64, 48, time=0.6, device="cpu")
    batch = cs.make_batch(0, 64, 48, "cpu")
    jitter = T(np.random.default_rng(3).random((2, 48, 64),
                                               dtype=np.float32))
    state = train_state_from_numpy(cs.train_arrays(store_np, late), cfg,
                                   device="cpu", seed=0)
    res = {}
    for name, kw in (("fused", {}), ("sliced", dict(depth_slices=2)),
                     ("chunked", dict(impl="chunked", max_per_tile=1024))):
        rc = RenderConfig(max_pairs=1 << 14, **kw)
        heads = forward_scene(state.store, tracks, cam, 0, cfg, rc,
                              eval_extras=True)[0]
        total, _, _, _, grads = sts.scene_loss_and_grads(
            state, tracks, cam, batch, cfg, rc, subset_accs=True,
            jitter=jitter)
        new, metrics = sts.scene_train_step(state, tracks, cam, batch, cfg,
                                            rc, subset_accs=True,
                                            jitter=jitter)
        res[name] = (heads, float(total), dict(cs._all_grads(grads)), new,
                     metrics)
    heads_f, loss_f, grads_f, new_f, metrics_f = res["fused"]
    assert float(heads_f["accumulation"].max()) > 0.3
    for name in ("sliced", "chunked"):
        heads, loss, grads, new, metrics = res[name]
        for k in ("rgb", "accumulation", "object_acc", "background_acc"):
            np.testing.assert_allclose(heads[k].detach().numpy(),
                                       heads_f[k].detach().numpy(),
                                       atol=3e-5, err_msg=f"{name} {k}")
        assert loss == pytest.approx(loss_f, abs=1e-6)
        assert float(metrics["loss"]) == pytest.approx(
            float(metrics_f["loss"]), abs=1e-6)
        for k, g in grads_f.items():
            top = float(g.abs().max())
            np.testing.assert_allclose(grads[k].numpy(), g.numpy(),
                                       atol=2e-4 * top, rtol=0,
                                       err_msg=f"{name} {k}")
        assert int(metrics["max_tile_count"]) == int(
            metrics_f["max_tile_count"])
        assert new.step == new_f.step == late + 1
    # The sliced demand is at least the true counts.
    assert int(res["sliced"][4]["num_pairs"]) >= int(metrics_f["num_pairs"])

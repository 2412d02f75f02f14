"""The port's portable compositors (ops/composite_chunked.py,
ops/composite_scan.py: plain PyTorch under ordinary autograd) against the
JAX package's (composite_chunked.py, composite_jnp.py) on the same numpy
inputs and the same bins, on the CPU, and against the frozen golden image.

Tolerances: image and alpha atol 2e-5 (the oracle tolerance of
tests/test_rasterize.py and tests/test_golden.py); gradients of a
mean-type loss atol 1e-6 (both sides differentiate the same masked
recurrence); the golden's gradient fingerprints at its own rtol 1e-4 /
atol 1e-5. The per-tile budget `max_per_tile` truncates exactly as in the
JAX package: the golden was rendered with 512 on a scene whose densest
tile holds 1126 pairs, and the whole image must match."""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.core.cameras import Camera as JCamera
from street_gaussians_ns_tpu.ops import composite_chunked as jchunk
from street_gaussians_ns_tpu.ops import composite_jnp as jscan
from street_gaussians_ns_tpu.ops import render as jrender
from street_gaussians_ns_tpu.ops import tiles as jtiles
from street_gaussians_ns_tpu_torch.core.cameras import Camera as TCamera
from street_gaussians_ns_tpu_torch.core.cameras import viewmat_from_c2w
from street_gaussians_ns_tpu_torch.core.projection import Projected, project
from street_gaussians_ns_tpu_torch.ops import composite_chunked as tchunk
from street_gaussians_ns_tpu_torch.ops import composite_scan as tscan
from street_gaussians_ns_tpu_torch.ops import render as trender
from street_gaussians_ns_tpu_torch.ops import tiles as ttiles

from test_fused_binning import _project
from test_pallas_composite import MAX_PAIRS
from test_pallas_composite import make_scene as small_scene
from test_rasterize import make_scene as golden_make_scene


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN = Path(__file__).parent / "golden" / "render_2k_200.npz"
BG = np.array([0.2, 0.1, 0.0, 0.0], np.float32)


def T(x):
    return torch.from_numpy(np.array(x))


def _torch_proj(p) -> Projected:
    return Projected(**{f.name: T(getattr(p, f.name))
                        for f in dataclasses.fields(Projected)})


def _bins_arrays(jb) -> dict:
    return {f.name: np.asarray(getattr(jb, f.name))
            for f in dataclasses.fields(jb)}


def _both(impl, seed, n, opaque, max_per_tile):
    """Loss, image and gradients of (xys, conics, colors, opacities) from
    both packages over the JAX package's bins."""
    means, scales, quats, colors, opac, cam = small_scene(
        n, seed, w=48, h=32, opaque=opaque)
    jp = _project(means, scales, quats, cam)
    jbins = jtiles.bin_gaussians(jp, 48, 32, 16, MAX_PAIRS, opacities=opac)
    target = np.asarray(jax.random.uniform(jax.random.PRNGKey(7),
                                           (32, 48, 4)))

    def jloss(args):
        if impl == "chunked":
            img, alpha = jchunk.rasterize_tiles_chunked(
                *args, jbins, 48, 32, 16, jnp.asarray(BG), max_per_tile, 32)
        else:
            img, alpha = jscan.rasterize_tiles_jnp(
                *args, jbins, 48, 32, 16, jnp.asarray(BG), max_per_tile)
        return (jnp.mean(jnp.abs(img - target))
                + 0.3 * jnp.mean(alpha ** 2)), (img, alpha)

    (jl, (jimg, jalpha)), jg = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(
        (jp.xys, jp.conics, colors, opac))

    tbins = ttiles.bins_from_numpy(_bins_arrays(jbins), device="cpu")
    leaves = [T(a).requires_grad_(True)
              for a in (jp.xys, jp.conics, colors, opac)]
    if impl == "chunked":
        img, alpha = tchunk.rasterize_tiles_chunked(
            *leaves, tbins, 48, 32, 16, T(BG), max_per_tile, 32)
    else:
        img, alpha = tscan.rasterize_tiles_scan(
            *leaves, tbins, 48, 32, 16, T(BG), max_per_tile)
    tl = (img - T(target)).abs().mean() + 0.3 * (alpha ** 2).mean()
    tg = torch.autograd.grad(tl, leaves)
    return ((float(jl), np.asarray(jimg), np.asarray(jalpha), jg),
            (float(tl.detach()), img.detach().numpy(),
             alpha.detach().numpy(), tg), int(jbins.max_tile_count))


@pytest.mark.parametrize("impl", ["chunked", "scan"])
@pytest.mark.parametrize("seed,n,opaque", [(0, 60, False), (2, 200, True)])
def test_portable_image_and_grads_match_jax(impl, seed, n, opaque):
    (jl, jimg, jalpha, jg), (tl, timg, talpha, tg), densest = _both(
        impl, seed, n, opaque, 1024)
    assert densest <= 1024
    assert tl == pytest.approx(jl, abs=1e-6)
    np.testing.assert_allclose(timg, jimg, atol=2e-5)
    np.testing.assert_allclose(talpha, jalpha, atol=2e-5)
    assert float(talpha.max()) > 0.5
    for name, a, b in zip(["xys", "conics", "colors", "opac"], tg, jg):
        assert float(np.abs(np.asarray(b)).max()) > 1e-5, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("impl,budget", [("chunked", 40), ("scan", 37)])
def test_portable_truncation_matches_jax(impl, budget):
    """A budget below the densest tile: both packages drop the same pairs
    (the chunked one after rounding the budget up to whole chunks)."""
    (_, jimg, jalpha, _), (_, timg, talpha, _), densest = _both(
        impl, 2, 200, False, budget)
    assert densest > 64
    np.testing.assert_allclose(timg, jimg, atol=2e-5)
    np.testing.assert_allclose(talpha, jalpha, atol=2e-5)
    (_, full_img, _, _), _, _ = _both(impl, 2, 200, False, 1024)
    assert float(np.abs(full_img - jimg).max()) > 1e-3


def test_composite_chunk_matches_jax():
    rng = np.random.default_rng(0)
    shape = (5, 16, 64)                                   # (tiles, K, P)
    alpha = rng.random(shape, dtype=np.float32) * 1.2     # some above 0.999
    alpha[rng.random(shape) < 0.3] *= 0.001               # some below 1/255
    skip = rng.random(shape) < 0.2
    colors = rng.random((5, 16, 3), dtype=np.float32)
    t_in = rng.random((5, 64), dtype=np.float32)
    done = rng.random((5, 64)) < 0.1
    want = jchunk.composite_chunk(*map(jnp.asarray, (t_in, done, alpha, skip,
                                                     colors)))
    got = tchunk.composite_chunk(*map(T, (t_in, done, alpha, skip, colors)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=2e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=2e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert bool(got[2].any()) and not bool(got[2].all())


def test_tiles_to_image_crops():
    rng = np.random.default_rng(0)
    tiles = T(rng.random((12, 256, 3), dtype=np.float32))
    got = tchunk.tiles_to_image(tiles, 4, 3, 16, 50, 37)
    want = jchunk.tiles_to_image(jnp.asarray(tiles.numpy()), 4, 3, 16, 50, 37)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tuple(tchunk.tiles_to_image(tiles[..., 0], 4, 3, 16, 50,
                                       37).shape) == (37, 50)


def test_portable_needs_gauss_idx():
    means, scales, quats, colors, opac, cam = small_scene(60, 0, w=48, h=32)
    p = _torch_proj(_project(means, scales, quats, cam))
    bins = dataclasses.replace(
        ttiles.bin_gaussians(p, 48, 32, 16, MAX_PAIRS), gauss_idx=None)
    for fn, extra in ((tchunk.rasterize_tiles_chunked, (64, 32)),
                      (tscan.rasterize_tiles_scan, (64,))):
        with pytest.raises(ValueError, match="bin_gaussians"):
            fn(p.xys, p.conics, T(colors), T(opac), bins, 48, 32, 16, T(BG),
               *extra)


# ---------------------------------------------------------------------------
# The golden image, whole.
# ---------------------------------------------------------------------------

def test_scan_reproduces_the_whole_golden_image_and_its_gradients():
    """tests/test_golden.py's computation through the port: project, the
    shared bins (no opacities, as full_pipeline bins), rasterize with
    impl="scan" and the golden's max_per_tile=512, which truncates the
    densest tiles (1126 pairs) exactly as the JAX package did."""
    means, scales, quats, colors, opac, cam = golden_make_scene(
        n=2000, seed=7, w=200, h=200)
    leaves = [T(a).requires_grad_(True)
              for a in (means, scales, quats, colors, opac)]
    tcam = TCamera.make(cam.fx, cam.fy, cam.cx, cam.cy, np.array(cam.c2w),
                        200, 200, device="cpu")
    proj = project(leaves[0], leaves[1], leaves[2],
                   viewmat_from_c2w(tcam.c2w), tcam.fx, tcam.fy, tcam.cx,
                   tcam.cy, 200, 200, tile_size=16)
    bins = ttiles.bin_gaussians(proj, 200, 200, 16, 1 << 16)
    assert int(bins.max_tile_count) > 512
    cfg = trender.RenderConfig(impl="scan", max_per_tile=512,
                               max_pairs=1 << 16)
    with pytest.warns(RuntimeWarning, match="truncation"):
        img, alpha, _ = trender.rasterize(proj, leaves[3], leaves[4], tcam,
                                          torch.zeros(3), cfg, bins=bins)
    want = np.load(GOLDEN)
    assert float(alpha.detach().max()) > 0.5
    np.testing.assert_allclose(img.detach().numpy(), want["rgb"], atol=2e-5)
    np.testing.assert_allclose(alpha.detach().numpy(), want["alpha"],
                               atol=2e-5)
    grads = torch.autograd.grad((img - 0.5).abs().mean(), leaves)
    for name, g in zip(("means", "scales", "quats", "colors", "opac"),
                       grads):
        np.testing.assert_allclose(float(torch.linalg.norm(g)),
                                   float(want[f"grad_{name}_norm"]),
                                   rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(g.reshape(-1)[:64].numpy(),
                                   want[f"grad_{name}_head"], atol=1e-5,
                                   rtol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# Through render.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["chunked", "scan"])
def test_render_portable_impls_match_jax(impl):
    from test_rasterize import make_scene
    means, scales, quats, colors, opac, _ = make_scene(300, 0, w=64, h=48)
    args = [np.asarray(a) for a in (means, scales, quats, opac, colors)]
    c2w = np.eye(3, 4, dtype=np.float32)
    c2w[:, 3] = [0.2, -0.1, 0.5]
    jcam = JCamera.make(60.0, 58.0, 32.3, 23.8, c2w, 64, 48)
    tcam = TCamera.make(60.0, 58.0, 32.3, 23.8, c2w, 64, 48, device="cpu")
    kw = dict(max_pairs=8192, max_per_tile=512, chunk=32, impl=impl)
    jout = jax.jit(jrender.render, static_argnames=("config", "training"))(
        *args, jcam, config=jrender.RenderConfig(**kw), training=False)
    tout = trender.render(*map(T, args), tcam, trender.RenderConfig(**kw),
                          training=False)
    assert int(tout.bins.max_tile_count) <= 512
    np.testing.assert_allclose(tout.rgb.numpy(), np.asarray(jout.rgb),
                               atol=2e-5)
    np.testing.assert_allclose(tout.accumulation.numpy(),
                               np.asarray(jout.accumulation), atol=2e-5)
    m = np.asarray(jout.accumulation) > 1e-3
    np.testing.assert_allclose(tout.depth.numpy()[m],
                               np.asarray(jout.depth)[m], rtol=1e-4)
    for name in ("tile_start", "tile_count", "gauss_idx", "exp_slot"):
        np.testing.assert_array_equal(getattr(tout.bins, name).numpy(),
                                      np.asarray(getattr(jout.bins, name)),
                                      err_msg=name)

"""The port's render op (ops/render.py on the fused rasterizer) against the
JAX package's on the same numpy inputs, on the CPU, and against the frozen
golden image.

Tolerances: rgb and accumulation at atol 2e-5 (the oracle tolerance of
tests/test_pallas_composite.py and tests/test_golden.py); depth is
accum / alpha, which amplifies rounding where alpha is small, so it is
held at rtol 1e-4 where alpha > 1e-3 (elsewhere both give the far fill).
The JAX side renders with impl="chunked", whose per-tile budget is
asserted to truncate nothing."""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.core.cameras import Camera as JCamera
from street_gaussians_ns_tpu.ops import render as jrender
from street_gaussians_ns_tpu_torch.core.cameras import Camera as TCamera
from street_gaussians_ns_tpu_torch.core.cameras import viewmat_from_c2w
from street_gaussians_ns_tpu_torch.core.projection import project
from street_gaussians_ns_tpu_torch.ops import render as trender
from street_gaussians_ns_tpu_torch.ops.composite import rasterize_tiles_fused

from test_rasterize import full_pipeline, make_scene


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN = Path(__file__).parent / "golden" / "render_2k_200.npz"
MAX_PER_TILE = 512


def T(x):
    return torch.from_numpy(np.array(x))


def _cameras(w, h, time=0.0):
    c2w = np.eye(3, 4, dtype=np.float32)
    c2w[:, 3] = [0.2, -0.1, 0.5]
    return (JCamera.make(60.0, 58.0, w / 2 + 0.3, h / 2 - 0.2, c2w, w, h,
                         time=time),
            TCamera.make(60.0, 58.0, w / 2 + 0.3, h / 2 - 0.2, c2w, w, h,
                         time=time, device="cpu"))


def assert_heads_close(got: dict, want: dict, acc_of: dict):
    for key, w in want.items():
        g = got[key].numpy() if isinstance(got[key], torch.Tensor) else got[key]
        w = np.asarray(w)
        assert g.shape == w.shape, key
        if key in acc_of:
            m = np.asarray(want[acc_of[key]]) > 1e-3
            np.testing.assert_allclose(g[m], w[m], rtol=1e-4, atol=0,
                                       err_msg=key)
            np.testing.assert_array_equal(g[~m], w[~m], err_msg=key)
        else:
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=0, err_msg=key)


def _render_both(seed, n, w, h, with_sky, with_active, jax_impl="chunked"):
    means, scales, quats, colors, opac, _ = make_scene(n, seed, w=w, h=h)
    args = [np.asarray(a) for a in (means, scales, quats, opac, colors)]
    jcam, tcam = _cameras(w, h)
    rng = np.random.default_rng(seed)
    sky = rng.random((h, w, 3), dtype=np.float32) if with_sky else None
    active = rng.random(n) > 0.2 if with_active else None
    jcfg = jrender.RenderConfig(max_pairs=8192, max_per_tile=MAX_PER_TILE,
                                chunk=32, impl=jax_impl,
                                interpret=jax_impl == "pallas")
    jout = jax.jit(jrender.render, static_argnames=("config", "training"))(
        *args, jcam, config=jcfg, sky_rgb=sky, training=False, active=active)
    tout = trender.render(*map(T, args), tcam,
                          trender.RenderConfig(max_pairs=8192),
                          sky_rgb=None if sky is None else T(sky),
                          training=False,
                          active=None if active is None else T(active))
    if jax_impl == "chunked":
        assert int(jout.bins.max_tile_count) <= MAX_PER_TILE
    return jout, tout


@pytest.mark.parametrize("seed,n,w,h,with_sky,with_active", [
    (0, 300, 64, 48, False, False),
    (1, 400, 50, 37, True, True)])
def test_render_matches_jax_chunked(seed, n, w, h, with_sky, with_active):
    jout, tout = _render_both(seed, n, w, h, with_sky, with_active)
    heads = ("rgb", "accumulation", "depth")
    assert_heads_close({k: getattr(tout, k) for k in heads},
                       {k: getattr(jout, k) for k in heads},
                       {"depth": "accumulation"})
    assert float(tout.accumulation.max()) > 0.5
    assert int(tout.bins.num_pairs) <= 8192


@pytest.mark.slow
def test_render_matches_jax_pallas_interpret():
    jout, tout = _render_both(2, 200, 48, 32, True, False, jax_impl="pallas")
    heads = ("rgb", "accumulation", "depth")
    assert_heads_close({k: getattr(tout, k) for k in heads},
                       {k: getattr(jout, k) for k in heads},
                       {"depth": "accumulation"})


@pytest.fixture(scope="module")
def golden_scene():
    """test_rasterize.full_pipeline's scene and arguments (2000 gaussians,
    200x200, no opacity-aware tile box, zero background) through the
    port's fused rasterizer."""
    means, scales, quats, colors, opac, cam = make_scene(
        n=2000, seed=7, w=200, h=200)
    tcam = TCamera.make(cam.fx, cam.fy, cam.cx, cam.cy, np.array(cam.c2w),
                        200, 200, device="cpu")
    proj = project(T(means), T(scales), T(quats), viewmat_from_c2w(tcam.c2w),
                   tcam.fx, tcam.fy, tcam.cx, tcam.cy, 200, 200,
                   tile_size=16)
    img, alpha, bins = rasterize_tiles_fused(
        proj, T(colors), T(opac), 200, 200, 16, torch.zeros(3), 1 << 16)
    assert int(bins.num_pairs) <= 1 << 16
    return (means, scales, quats, colors, opac, cam), img.numpy(), \
        alpha.numpy(), bins


def test_fused_rasterizer_reproduces_golden(golden_scene):
    """The golden was rendered by the portable scan compositor with
    full_pipeline's max_per_tile=512, which drops every pair past a
    tile's 512th; this scene's densest tiles hold more (1126), and the
    fused rasterizer never truncates. Pixels of the tiles within that
    budget must reproduce the golden at its own tolerance (atol 2e-5);
    in the truncated tiles the port composites the dropped pairs too, so
    there it may only gain opacity."""
    _, img, alpha, bins = golden_scene
    want = np.load(GOLDEN)
    counts = bins.tile_count.numpy().reshape(bins.num_tiles_y,
                                             bins.num_tiles_x)
    in_budget = np.repeat(np.repeat(counts <= 512, 16, 0), 16, 1)[:200, :200]
    assert in_budget.mean() > 0.9 and not in_budget.all()
    assert float(alpha.max()) > 0.5
    np.testing.assert_allclose(img[in_budget], want["rgb"][in_budget],
                               atol=2e-5)
    np.testing.assert_allclose(alpha[in_budget], want["alpha"][in_budget],
                               atol=2e-5)
    assert (alpha[~in_budget] >= want["alpha"][~in_budget] - 2e-5).all()


def test_golden_scene_matches_untruncated_jax(golden_scene):
    """The whole golden scene against the JAX chunked compositor with a
    per-tile budget above the densest tile (nothing dropped)."""
    scene, img, alpha, bins = golden_scene
    assert int(bins.max_tile_count) <= 2048
    j_img, j_alpha = jax.jit(full_pipeline, static_argnames=(
        "impl", "max_pairs", "max_per_tile"))(
        *scene, impl="chunked", max_pairs=1 << 16, max_per_tile=2048)
    np.testing.assert_allclose(img, np.asarray(j_img), atol=2e-5)
    np.testing.assert_allclose(alpha, np.asarray(j_alpha), atol=2e-5)


def test_capacity_overflow_warns():
    means, scales, quats, colors, opac, _ = make_scene(300, 0, w=64, h=48)
    _, tcam = _cameras(64, 48)
    args = [T(a) for a in (means, scales, quats, opac, colors)]
    with pytest.warns(RuntimeWarning, match="capacity overflow"):
        out = trender.render(*args, tcam, trender.RenderConfig(max_pairs=256))
    assert int(out.bins.num_pairs) > 256
    assert bool(torch.isfinite(out.rgb).all())


def test_unported_options_raise():
    """precision="bf16" is still to port; an impl the package does not
    know is refused; the options ported since (depth slices, the portable
    compositors) build and render."""
    with pytest.raises(ValueError, match="ROADMAP"):
        trender.RenderConfig(precision="bf16")
    with pytest.raises(ValueError, match="impl"):
        trender.RenderConfig(impl="tiles")
    with pytest.raises(ValueError):
        trender.RenderConfig(depth_slices=0)
    means, scales, quats, colors, opac, _ = make_scene(300, 0, w=64, h=48)
    _, tcam = _cameras(64, 48)
    args = [T(a) for a in (means, scales, quats, opac, colors)]
    want = trender.render(*args, tcam, trender.RenderConfig(max_pairs=8192),
                          training=False)
    for kw in (dict(depth_slices=2), dict(impl="chunked"), dict(impl="scan"),
               dict(impl="pallas")):
        out = trender.render(*args, tcam,
                             trender.RenderConfig(max_pairs=8192, **kw),
                             training=False)
        np.testing.assert_allclose(out.rgb.numpy(), want.rgb.numpy(),
                                   atol=3e-5, err_msg=str(kw))
        np.testing.assert_allclose(out.accumulation.numpy(),
                                   want.accumulation.numpy(), atol=3e-5,
                                   err_msg=str(kw))
        assert int(out.bins.max_tile_count) == int(want.bins.max_tile_count)


def test_rasterize_routes_by_impl_and_bins():
    """rasterize with shared bins goes through the compositor the impl
    names; the kernel impl with bins is the unfused route, whose bins come
    back as they were passed."""
    from street_gaussians_ns_tpu_torch.ops.tiles import bin_gaussians

    means, scales, quats, colors, opac, _ = make_scene(300, 0, w=64, h=48)
    _, tcam = _cameras(64, 48)
    proj = project(T(means), T(scales), T(quats), viewmat_from_c2w(tcam.c2w),
                   tcam.fx, tcam.fy, tcam.cx, tcam.cy, 64, 48,
                   opacities=T(opac))
    bins = bin_gaussians(proj, 64, 48, 16, 8192, opacities=T(opac))
    bg = torch.tensor([0.1, 0.2, 0.3])
    fused = trender.rasterize(proj, T(colors), T(opac), tcam, bg,
                              trender.RenderConfig(max_pairs=8192))
    assert fused[2].gauss_idx is None
    for impl in ("fused", "chunked", "scan"):
        img, alpha, out_bins = trender.rasterize(
            proj, T(colors), T(opac), tcam, bg,
            trender.RenderConfig(max_pairs=8192, impl=impl), bins=bins)
        assert out_bins is bins
        np.testing.assert_allclose(img.numpy(), fused[0].numpy(), atol=2e-5)
        np.testing.assert_allclose(alpha.numpy(), fused[1].numpy(),
                                   atol=2e-5)
    with pytest.warns(RuntimeWarning, match="truncation"):
        trender.rasterize(proj, T(colors), T(opac), tcam, bg,
                          trender.RenderConfig(max_pairs=8192, impl="scan",
                                               max_per_tile=8))
    with pytest.warns(RuntimeWarning, match="capacity overflow"):
        trender.rasterize(proj, T(colors), T(opac), tcam, bg,
                          trender.RenderConfig(max_pairs=512,
                                               depth_slices=2))

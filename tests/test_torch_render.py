"""The port's render op (ops/render.py on the fused rasterizer) against the
JAX package's on the same numpy inputs, on the CPU, and against the frozen
golden image.

Tolerances: rgb and accumulation at atol 2e-5 (the oracle tolerance of
tests/test_pallas_composite.py and tests/test_golden.py); depth is
accum / alpha, which amplifies rounding where alpha is small, so it is
held at rtol 1e-4 where alpha > 1e-3 (elsewhere both give the far fill).
The JAX side renders with impl="chunked" or "scan", whose per-tile budget
is asserted to truncate nothing. The fused rasterizer is also held
against the port's per-pixel oracle (ops.rasterize_ref) at the oracle
tolerance of tests/test_rasterize.py, atol 1e-5."""
import dataclasses
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
from street_gaussians_ns_tpu_torch.ops.rasterize_ref import rasterize_reference

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
    if jax_impl != "pallas":
        assert int(jout.bins.max_tile_count) <= MAX_PER_TILE
    return jout, tout


@pytest.mark.parametrize("jax_impl", ["chunked", "scan"])
@pytest.mark.parametrize("seed,n,w,h,with_sky,with_active", [
    (0, 300, 64, 48, False, False),
    (1, 400, 50, 37, True, True)])
def test_render_matches_jax_chunked(seed, n, w, h, with_sky, with_active,
                                    jax_impl):
    jout, tout = _render_both(seed, n, w, h, with_sky, with_active,
                              jax_impl=jax_impl)
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
    """RenderConfig has five fields; a precision the package does not
    know, an option of the JAX package's other routes, and a tile size
    the compositor is not built for are refused."""
    assert [f.name for f in dataclasses.fields(trender.RenderConfig)] == [
        "tile_size", "max_pairs", "max_rowruns", "depth_far_fill",
        "precision"]
    with pytest.raises(ValueError, match="precision"):
        trender.RenderConfig(precision="fp8")
    for kw in (dict(impl="chunked"), dict(depth_slices=2),
               dict(max_per_tile=512), dict(chunk=16)):
        with pytest.raises(TypeError):
            trender.RenderConfig(**kw)
    means, scales, quats, colors, opac, _ = make_scene(300, 0, w=64, h=48)
    _, tcam = _cameras(64, 48)
    args = [T(a) for a in (means, scales, quats, opac, colors)]
    with pytest.raises(ValueError, match="16x16"):
        trender.render(*args, tcam, trender.RenderConfig(tile_size=8))


# ---------------------------------------------------------------------------
# The fused rasterizer against the per-pixel oracle.
# ---------------------------------------------------------------------------

ORACLE_CASES = {
    "seed0": dict(seed=0),
    "seed1": dict(seed=1),
    "seed2": dict(seed=2),
    "seed3": dict(seed=3),
    "opaque": dict(seed=4, opaque=True),
    "opaque_dense": dict(seed=5, n=500, opaque=True),
    "inactive_tail": dict(seed=6, inactive=60),
    "inactive_tail_opaque": dict(seed=7, inactive=60, opaque=True),
    "size_50x37": dict(seed=8, w=50, h=37),
    "size_33x17": dict(seed=9, w=33, h=17),
    "size_81x47": dict(seed=10, w=81, h=47),
    "one_gaussian": dict(seed=11, n=1, opaque=True),
    "none_visible": dict(seed=12, offscreen=True),
    "all_behind_the_camera": dict(seed=13, behind=200),
    "half_behind_the_camera": dict(seed=14, behind=100),
    "3_channels_last_is_depth": dict(seed=15, nc=3, depth=True),
    "4_channels_last_is_depth": dict(seed=16, nc=4, depth=True),
    "1_channel": dict(seed=17, nc=1),
    "background": dict(seed=18, background=True),
    "saturating_stack": dict(seed=19, stack=True),
    "saturating_stack_depth_background": dict(seed=20, stack=True, nc=4,
                                              depth=True, background=True),
    "box_without_opacity": dict(seed=21, aware=False),
}


def _oracle_scene(seed, n=200, w=64, h=48, opaque=False, inactive=0,
                  offscreen=False, behind=0, nc=4, depth=False,
                  background=False, stack=False, aware=True):
    """A seeded scene projected by the port: (proj, colors, opacities,
    background); the last colour is the view depth when `depth`."""
    rng = np.random.default_rng(seed)
    if stack:
        # Opaque splats piled in front of the image centre: most pixels
        # there saturate long before the last one.
        means = np.concatenate([0.05 * rng.standard_normal((n, 2)),
                                -rng.random((n, 1)) - 3.0], 1)
        scales = np.exp(rng.standard_normal((n, 3)) * 0.2 - 1.0)
        opac = np.full((n,), 0.95)
    else:
        means = np.concatenate([rng.standard_normal((n, 2)),
                                -rng.random((n, 1)) * 8.0 - 2.0], 1)
        scales = np.exp(rng.standard_normal((n, 3)) * 0.5 - 2.0)
        opac = (np.full((n,), 0.95) if opaque
                else rng.random(n) * 0.9 + 0.05)
    if offscreen:
        means[:, 0] += 50.0
    means[:behind, 2] = 5.0
    q = rng.standard_normal((n, 4))
    quats = q / np.linalg.norm(q, axis=1, keepdims=True)
    colors = rng.random((n, nc))
    means, scales, quats, colors, opac = (
        torch.tensor(a, dtype=torch.float32)
        for a in (means, scales, quats, colors, opac))
    if inactive:
        opac[-inactive:] = 0.0
    _, tcam = _cameras(w, h)
    proj = project(means, scales, quats, viewmat_from_c2w(tcam.c2w),
                   tcam.fx, tcam.fy, tcam.cx, tcam.cy, w, h,
                   opacities=opac if aware else None)
    if inactive:
        live = torch.arange(n) < n - inactive
        proj = dataclasses.replace(
            proj, radii=torch.where(live, proj.radii, 0),
            num_tiles_hit=torch.where(live, proj.num_tiles_hit, 0))
    if depth:
        colors[:, -1] = proj.depths
    bg = (torch.tensor(rng.random(nc), dtype=torch.float32) if background
          else torch.zeros(nc))
    return proj, colors, opac, bg


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_fused_rasterizer_matches_oracle(case):
    kw = ORACLE_CASES[case]
    w, h = kw.get("w", 64), kw.get("h", 48)
    proj, colors, opac, bg = _oracle_scene(**kw)
    img, alpha, bins = rasterize_tiles_fused(
        proj, colors, opac, w, h, 16, bg, 1 << 16,
        last_color_is_depth=kw.get("depth", False))
    assert int(bins.num_pairs) <= 1 << 16
    want_img, want_alpha = rasterize_reference(
        proj.xys, proj.depths, proj.radii, proj.conics, colors, opac,
        proj.tile_box, w, h, background=bg)
    assert tuple(img.shape) == (h, w, colors.shape[-1])
    np.testing.assert_allclose(img.numpy(), want_img.numpy(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(alpha.numpy(), want_alpha.numpy(),
                               atol=1e-5, rtol=0)
    drawn = float(want_alpha.max())
    if case in ("none_visible", "all_behind_the_camera"):
        assert drawn == 0.0 and int(bins.num_pairs) == 0
    else:
        assert drawn > 0.1
    if kw.get("stack"):
        assert float(want_alpha.max()) > 0.999

"""The port's losses and the differentiable pieces under them (ops/ssim.py,
ops/cubemap.py, core/cameras.pixel_directions, models/splatfacto.loss_dict,
models/scene_graph.forward_scene(training=True) and scene_loss_dict)
against the JAX package on the same numpy inputs, on the CPU.

Tolerances:
- ssim, psnr and the loss values: rtol 1e-5 / atol 1e-6 (the same
  shift-and-add blur in another float32 summation order).
- gradients of ssim, of the cubemap lookup and of the jittered rays vs
  jax.grad: atol 1e-6 at a mean-type loss, rtol 1e-4.
- forward_scene(training=True) heads with the same jitter: rgb,
  accumulations and sky at atol 2e-5, depth at rtol 1e-4 where the
  accumulation > 1e-3 (tests/test_torch_render.py's tolerances);
  scene_loss_dict values at atol 2e-5 / rtol 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.core import cameras as jcam
from street_gaussians_ns_tpu.core.cameras import Camera as JCamera
from street_gaussians_ns_tpu.models import scene_graph as jsg
from street_gaussians_ns_tpu.models import splatfacto as jsplat
from street_gaussians_ns_tpu.ops import cubemap as jcube
from street_gaussians_ns_tpu.ops import ssim as jssim
from street_gaussians_ns_tpu.ops.render import RenderConfig as JRenderConfig
from street_gaussians_ns_tpu_torch.core import cameras as tcam
from street_gaussians_ns_tpu_torch.core.cameras import Camera as TCamera
from street_gaussians_ns_tpu_torch.engine import checkpoints as tckpt
from street_gaussians_ns_tpu_torch.models import scene_graph as tsg
from street_gaussians_ns_tpu_torch.models import splatfacto as tsplat
from street_gaussians_ns_tpu_torch.ops import cubemap as tcube
from street_gaussians_ns_tpu_torch.ops import render as trender
from street_gaussians_ns_tpu_torch.ops import ssim as tssim

from test_rasterize import make_scene
from test_torch_render import assert_heads_close
from test_torch_scene_graph import (DEPTH_OF, MAX_PAIRS, port_config, scene,
                                    store_arrays)  # noqa: F401 (fixture)


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
# ssim, psnr, loss_dict.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(40, 56), (23, 31)])
def test_ssim_and_psnr_match_jax(h, w):
    rng = np.random.default_rng(h)
    a = rng.random((h, w, 3), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal((h, w, 3)), 0, 1).astype(
        np.float32)
    jv, jg = jax.value_and_grad(jssim.ssim, argnums=1)(jnp.asarray(a),
                                                       jnp.asarray(b))
    tb = T(b).requires_grad_(True)
    tv = tssim.ssim(T(a), tb)
    (tg,) = torch.autograd.grad(tv, tb)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)
    assert float(np.abs(np.asarray(jg)).max()) > 1e-5
    np.testing.assert_allclose(float(tssim.psnr(T(a), T(b))),
                               float(jssim.psnr(a, b)), rtol=1e-5)
    assert float(tssim.ssim(T(a), T(a))) == pytest.approx(1.0, abs=1e-6)
    assert float(tssim.psnr(T(a), T(a))) == pytest.approx(120.0, abs=1e-3)


@pytest.mark.parametrize("with_mask,with_semantic", [(False, True),
                                                     (True, False)])
def test_loss_dict_matches_jax(with_mask, with_semantic):
    rng = np.random.default_rng(3)
    h, w = 32, 40
    outputs = {"rgb": rng.random((h, w, 3), dtype=np.float32) * 1.1,
               "accumulation": rng.random((h, w, 1), dtype=np.float32)}
    batch = {"image": rng.random((h, w, 3), dtype=np.float32)}
    if with_mask:
        batch["mask"] = rng.random((h, w, 1)) > 0.3
    if with_semantic:
        batch["semantic"] = rng.integers(0, 4, (h, w, 1)).astype(np.int32)
    want = jsplat.loss_dict(outputs, batch, jsplat.SplatfactoConfig())
    got = tsplat.loss_dict({k: T(v) for k, v in outputs.items()},
                           {k: T(v) for k, v in batch.items()},
                           tsplat.SplatfactoConfig())
    assert set(got) == set(want) == (
        {"Ll1", "simloss"} | ({"sky_accumulation"} if with_semantic
                              else set()))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert tsplat.SKY_SEMANTIC == jsplat.SKY_SEMANTIC


# ---------------------------------------------------------------------------
# The sky: jittered rays and the cubemap's gradient.
# ---------------------------------------------------------------------------

def _cams(w=40, h=28):
    c2w = np.array([[0.96, 0.0, 0.28, 0.2], [0.0, 1.0, 0.0, -0.1],
                    [-0.28, 0.0, 0.96, 0.5]], np.float32)
    return (JCamera.make(50.0, 48.0, w / 2 + 0.3, h / 2 - 0.2, c2w, w, h),
            TCamera.make(50.0, 48.0, w / 2 + 0.3, h / 2 - 0.2, c2w, w, h,
                         device="cpu"))


def test_pixel_directions_with_jitter_match_jax():
    jc, tc = _cams()
    key = jax.random.PRNGKey(5)
    jitter = np.asarray(jax.random.uniform(key, (2, 28, 40), jnp.float32))
    np.testing.assert_allclose(
        tcam.pixel_directions(tc, T(jitter)).numpy(),
        np.asarray(jcam.pixel_directions(jc, key)), atol=1e-6)
    np.testing.assert_allclose(tcam.pixel_directions(tc).numpy(),
                               np.asarray(jcam.pixel_directions(jc)),
                               atol=1e-6)
    g = torch.Generator().manual_seed(0)
    drawn = tcam.draw_pixel_jitter(tc, g)
    assert tuple(drawn.shape) == (2, 28, 40)
    assert 0.0 <= float(drawn.min()) and float(drawn.max()) < 1.0
    assert not torch.equal(drawn, tcam.draw_pixel_jitter(tc, g))
    with pytest.raises(ValueError):
        tcam.pixel_directions(tc, T(jitter)[:, :5])


def test_cubemap_gradient_matches_jax():
    """d(loss)/d(cubemap) and, with dirs_grad=True, d(loss)/d(dirs) against
    jax.grad of the JAX gather path; with dirs_grad=False the sampling
    geometry is detached."""
    rng = np.random.default_rng(0)
    cube = rng.random((6, 8, 8, 3), dtype=np.float32)
    dirs = rng.standard_normal((300, 3)).astype(np.float32)
    wgt = rng.standard_normal((300, 3)).astype(np.float32) / 900.0

    def jloss(c, d):
        return jnp.sum(jcube.sample_cubemap(c, d, method="gather",
                                            dirs_grad=True) * wgt)

    jv, (jgc, jgd) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(cube), jnp.asarray(dirs))
    tc, td = T(cube).requires_grad_(True), T(dirs).requires_grad_(True)
    tv = (tcube.sample_cubemap(tc, td, dirs_grad=True) * T(wgt)).sum()
    tgc, tgd = torch.autograd.grad(tv, (tc, td))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tgc.numpy(), np.asarray(jgc), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tgd.numpy(), np.asarray(jgd), rtol=1e-4,
                               atol=1e-6)
    assert float(np.abs(np.asarray(jgd)).max()) > 1e-5

    tv = (tcube.sample_cubemap(tc, td) * T(wgt)).sum()
    tgc2, tgd2 = torch.autograd.grad(tv, (tc, td), allow_unused=True)
    assert tgd2 is None
    np.testing.assert_array_equal(tgc2.numpy(), tgc.numpy())


def test_sky_color_with_jitter_matches_jax():
    jc, tc = _cams()
    rng = np.random.default_rng(1)
    env = rng.random((6, 16, 16, 3), dtype=np.float32)
    key = jax.random.PRNGKey(2)
    jitter = np.asarray(jax.random.uniform(key, (2, 28, 40), jnp.float32))
    np.testing.assert_allclose(
        tsplat.sky_color(T(env), tc, T(jitter)).numpy(),
        np.asarray(jsplat.sky_color(jnp.asarray(env), jc, key)), atol=2e-5)


# ---------------------------------------------------------------------------
# The four gradient faults of the eval slice.
# ---------------------------------------------------------------------------

def test_sh_colors_sends_no_gradient_into_means():
    rng = np.random.default_rng(0)
    n = 50
    _, tc = _cams()
    means = T(rng.standard_normal((n, 3)).astype(np.float32)
              ).requires_grad_(True)
    dc = T(rng.standard_normal((n, 3)).astype(np.float32)
           ).requires_grad_(True)
    rest = T(rng.standard_normal((n, 3, 3)).astype(np.float32))
    cfg = tsplat.SplatfactoConfig(sh_degree=1)
    rgb = tsplat.sh_colors(means, dc, rest, tc, 5000, cfg, training=True)
    g_means, g_dc = torch.autograd.grad(rgb.sum(), (means, dc),
                                        allow_unused=True)
    assert g_means is None or not g_means.any()
    assert float(g_dc.abs().max()) > 0


def _render_args(n=300, seed=0, w=64, h=48):
    means, scales, quats, colors, opac, _ = make_scene(n, seed, w=w, h=h)
    return [T(a) for a in (means, scales, quats, opac, colors)]


def test_project_gets_detached_opacities(monkeypatch):
    """The tile boxes are topology: render hands `project` opacities with
    no gradient function, while the compositor still differentiates
    them."""
    seen = {}
    real = trender.project

    def spy(*args, **kw):
        seen["requires_grad"] = kw["opacities"].requires_grad
        return real(*args, **kw)

    monkeypatch.setattr(trender, "project", spy)
    args = _render_args()
    args[3].requires_grad_(True)
    _, tc = _cams(64, 48)
    out = trender.render(*args, tc, trender.RenderConfig(max_pairs=8192))
    assert seen == {"requires_grad": False}
    (g,) = torch.autograd.grad(out.rgb.sum(), args[3])
    assert float(g.abs().max()) > 0 and bool(torch.isfinite(g).all())


def test_xys_offset_gradient_is_the_xys_gradient():
    """The gradient with respect to the zero-valued offset equals the
    gradient with respect to the projected centers (taken here through
    the rasterizer on the same projection)."""
    from street_gaussians_ns_tpu_torch.core.cameras import viewmat_from_c2w
    from street_gaussians_ns_tpu_torch.core.projection import project
    from street_gaussians_ns_tpu_torch.ops.composite import (
        rasterize_tiles_fused)

    means, scales, quats, opac, colors = _render_args()
    _, tc = _cams(64, 48)
    cfg = trender.RenderConfig(max_pairs=8192)
    rng = np.random.default_rng(4)
    wgt = T(rng.standard_normal((48, 64, 3)).astype(np.float32))
    offset = torch.zeros((means.shape[0], 2), requires_grad=True)
    out = trender.render(means, scales, quats, opac, colors, tc, cfg,
                         xys_offset=offset)
    (g_off,) = torch.autograd.grad((out.rgb * wgt).sum(), offset)

    proj = project(means, scales, quats, viewmat_from_c2w(tc.c2w), tc.fx,
                   tc.fy, tc.cx, tc.cy, 64, 48, opacities=opac)
    xys = proj.xys.clone().requires_grad_(True)
    colors4 = torch.cat([colors, proj.depths[:, None]], dim=-1)
    img, _, _ = rasterize_tiles_fused(
        dataclasses.replace(proj, xys=xys), colors4, opac, 64, 48, 16,
        torch.zeros(4), 8192, last_color_is_depth=True)
    (g_xys,) = torch.autograd.grad(
        (torch.clamp(img[..., :3], max=1.0) * wgt).sum(), xys)
    assert float(g_xys.abs().max()) > 1e-3
    np.testing.assert_allclose(g_off.numpy(), g_xys.numpy(), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_array_equal(out.projected.xys.detach().numpy(),
                                  proj.xys.numpy())


# ---------------------------------------------------------------------------
# forward_scene(training=True) and scene_loss_dict.
# ---------------------------------------------------------------------------

def _train_forward_both(scene, time, step):
    jcfg, jstore, jtracks = scene
    jc = JCamera.make(60.0, 60.0, 32.0, 24.0, jnp.eye(3, 4), 64, 48,
                      time=time)
    key = jax.random.PRNGKey(11)
    jr = JRenderConfig(max_pairs=MAX_PAIRS, max_per_tile=1024, chunk=32,
                       impl="chunked")
    jout, jfull, _ = jax.jit(
        jsg.forward_scene,
        static_argnames=("config", "render_config", "training",
                         "subset_accs"))(
        jstore, jtracks, jc, jnp.int32(step), config=jcfg, render_config=jr,
        rng=key, training=True, subset_accs=True)
    assert int(jfull.bins.max_tile_count) <= 1024
    cfg = port_config(jcfg)
    store = tckpt.store_from_numpy(store_arrays(jstore), cfg, device="cpu")
    tracks = tckpt.tracks_from_numpy(store_arrays(jtracks), device="cpu")
    tc = TCamera.make(60.0, 60.0, 32.0, 24.0, np.eye(3, 4), 64, 48,
                      time=time, device="cpu")
    jitter = np.asarray(jax.random.uniform(key, (2, 48, 64), jnp.float32))
    tout, _, _ = tsg.forward_scene(
        store, tracks, tc, step, cfg, trender.RenderConfig(
            max_pairs=MAX_PAIRS), training=True, subset_accs=True,
        jitter=T(jitter))
    return jcfg, cfg, jout, tout


@pytest.mark.parametrize("time,step", [(1.0, 0), (0.4, 1500)])
def test_forward_scene_training_matches_jax(scene, time, step):
    jcfg, cfg, jout, tout = _train_forward_both(scene, time, step)
    assert set(tout) == set(jout) == {"rgb", "accumulation", "depth", "sky",
                                      "object_acc", "background_acc"}
    assert_heads_close(tout, jout, DEPTH_OF)

    rng = np.random.default_rng(0)
    batch = {"image": rng.random((48, 64, 3), dtype=np.float32),
             "semantic": rng.integers(0, 4, (48, 64, 1)).astype(np.int32)}
    for loss_step in (0, jcfg.background.stop_split_at + 1):
        want = jsg.scene_loss_dict(jout, batch, jcfg, jnp.int32(loss_step))
        got = tsg.scene_loss_dict(tout, {k: T(v) for k, v in batch.items()},
                                  cfg, loss_step)
        assert set(got) == set(want) == {
            "Ll1", "simloss", "sky_accumulation", "object_acc_entropy_loss"}
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5, atol=2e-5, err_msg=k)
    assert float(got["object_acc_entropy_loss"]) > 0


def test_bbox_deltas_differentiable_matches_jax(scene):
    """bbox_differentiable=True lets the gradient reach the bbox deltas
    (at an annotated frame); by default they are detached, as the
    reference applies them."""
    jcfg, jstore, jtracks = scene
    tracks = tckpt.tracks_from_numpy(store_arrays(jtracks), device="cpu")
    rng = np.random.default_rng(2)
    wc = rng.standard_normal((2, 3)).astype(np.float32)
    wq = rng.standard_normal((2, 4)).astype(np.float32)
    dc0, dy0 = np.asarray(jstore.delta_center), np.asarray(jstore.delta_yaw)

    def jloss(dc, dy):
        b = jsg.interpolate_boxes(jtracks, jnp.float32(1.0), dc, dy,
                                  differentiable=True)
        return jnp.sum(b.centers * wc) + jnp.sum(b.quats * wq)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(dc0), jnp.asarray(dy0))
    for diff in (True, False):
        dc, dy = T(dc0).requires_grad_(True), T(dy0).requires_grad_(True)
        b = tsg.interpolate_boxes(tracks, torch.tensor(1.0), dc, dy,
                                  differentiable=diff)
        loss = (b.centers * T(wc)).sum() + (b.quats * T(wq)).sum()
        if not diff:
            assert not loss.requires_grad
            continue
        tg = torch.autograd.grad(loss, (dc, dy))
        for t, j in zip(tg, jg):
            assert float(np.abs(np.asarray(j)).max()) > 0.1
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                       atol=1e-6)


def test_forward_scene_subset_accs_off_and_camera_opt_raises(scene):
    jcfg, jstore, jtracks = scene
    cfg = port_config(jcfg)
    store = tckpt.store_from_numpy(store_arrays(jstore), cfg, device="cpu")
    tracks = tckpt.tracks_from_numpy(store_arrays(jtracks), device="cpu")
    tc = TCamera.make(60.0, 60.0, 32.0, 24.0, np.eye(3, 4), 64, 48,
                      time=1.0, device="cpu")
    rcfg = trender.RenderConfig(max_pairs=MAX_PAIRS)
    out, _, _ = tsg.forward_scene(store, tracks, tc, 0, cfg, rcfg,
                                  training=True, subset_accs=False)
    assert set(out) == {"rgb", "accumulation", "depth", "sky"}
    losses = tsg.scene_loss_dict(
        out, {"image": torch.zeros((48, 64, 3))}, cfg, 10 ** 6)
    assert set(losses) == {"Ll1", "simloss"}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsg.forward_scene(store, tracks, tc, 0, dataclasses.replace(
            cfg, camera_opt_mode="SO3xR3"), rcfg, training=True)

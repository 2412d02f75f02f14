"""precision="bf16" through the training step and the sliced route: one
scene_train_step and rasterize_tiles_fused(depth_slices=3) of the port
against the JAX package's bf16 route on the CPU (its Pallas kernels in
interpret mode), at the tolerances tests/test_torch_bf16.py states (the
step as tests/test_torch_train_step.py holds it, the sliced route as
tests/test_torch_slices.py holds it against the JAX sliced route)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.core.projection import project as jproject
from street_gaussians_ns_tpu.core.cameras import (
    viewmat_from_c2w as jviewmat)
from street_gaussians_ns_tpu.engine import scene_train_step as jsts
from street_gaussians_ns_tpu.ops import composite_pallas as jcomp
from street_gaussians_ns_tpu.ops import render as jrender
from street_gaussians_ns_tpu_torch.engine import checkpoints as tckpt
from street_gaussians_ns_tpu_torch.engine import optimizers as topt
from street_gaussians_ns_tpu_torch.engine import scene_train_step as tsts
from street_gaussians_ns_tpu_torch.engine.train_step import GAUSSIAN_GROUPS
from street_gaussians_ns_tpu_torch.ops import render as trender

from test_pallas_composite import make_scene
from test_torch_render import _cameras
from test_torch_scene_graph import MAX_PAIRS, port_config, store_arrays
from test_torch_scene_graph import scene as eval_scene  # noqa: F401 (its
#                                          fixture feeds train_scene)
from test_torch_train_step import scene as train_scene  # noqa: F401
from test_torch_slices import _run as sliced_run

GRAD_TOL = 2e-5       # of the group's largest |g|, as test_torch_train_step


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


def test_bf16_train_step_matches_jax(train_scene):  # noqa: F811
    """One scene_train_step at precision="bf16" from the same state and
    sky jitter, on test_torch_train_step's scene (anisotropic scales, a
    textured sky): loss and metrics, parameters, first moments (0.1 g of
    the JAX step's gradient) and statistics as test_torch_train_step holds
    the f32 step."""
    jcfg, jstore, jtracks = train_scene
    w, h, step = 64, 48, 700
    rng = np.random.default_rng(0)
    batch = {"image": rng.random((h, w, 3), dtype=np.float32),
             "semantic": rng.integers(0, 4, (h, w, 1)).astype(np.int32)}
    jstate = dataclasses.replace(
        jsts.init_scene_train_state(jstore, jax.random.PRNGKey(5)),
        step=jnp.int32(step))
    jc, tc = _cameras(w, h, time=1.0)
    jr = jrender.RenderConfig(max_pairs=MAX_PAIRS, impl="pallas",
                              interpret=True, precision="bf16")
    jnew, jm = jax.jit(jsts.scene_train_step, static_argnames=(
        "config", "render_config", "subset_accs"))(
        jstate, jtracks, jc, batch, config=jcfg, render_config=jr,
        subset_accs=False)
    k_sky = jax.random.split(jstate.rng)[1]
    jitter = T(jax.random.uniform(k_sky, (2, h, w), jnp.float32))
    cfg = port_config(jcfg)
    tstate = tckpt.train_state_from_numpy(store_arrays(jstate), cfg,
                                          device="cpu")
    tracks = tckpt.tracks_from_numpy(store_arrays(jtracks), device="cpu")
    tnew, tm = tsts.scene_train_step(
        tstate, tracks, tc, {k: T(v) for k, v in batch.items()}, cfg,
        trender.RenderConfig(max_pairs=MAX_PAIRS, precision="bf16"),
        subset_accs=False, jitter=jitter)
    for k in set(jm) - {"num_rowruns"}:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=2e-5, err_msg=k)
    for name in GAUSSIAN_GROUPS:
        for k, part in (("bg", "background"), ("obj", "objects")):
            jmu = np.asarray(jnew.opt[name].mu[k])
            jg = jmu / 0.1                   # first step from zero moments
            lr = topt.schedule(topt.DEFAULT_GROUPS[name], step)
            floor = GRAD_TOL * float(np.abs(jg).max())
            sure = np.abs(jg) > floor
            tp = getattr(getattr(tnew.store, part).params, name).numpy()
            jp = np.asarray(getattr(getattr(jnew.store, part).params, name))
            p0 = getattr(getattr(tstate.store, part).params, name).numpy()
            assert float(np.abs(tp - p0).max()) <= 2 * lr * 1.001, name
            if not sure.any():
                continue
            np.testing.assert_allclose(tp[sure], jp[sure], rtol=1e-6,
                                       atol=1e-3 * lr, err_msg=name)
            np.testing.assert_allclose(tnew.opt[name].mu[k].numpy(), jmu,
                                       rtol=1e-5, atol=0.1 * floor,
                                       err_msg=f"{name}/{k}")
    np.testing.assert_allclose(tnew.store.env_map.numpy(),
                               np.asarray(jnew.store.env_map), atol=1e-6)
    for part in ("background", "objects"):
        for k in ("vis_counts", "max_2dsize"):
            np.testing.assert_array_equal(
                getattr(getattr(tnew.store, part), k).numpy(),
                np.asarray(getattr(getattr(jnew.store, part), k)))
        top = float(np.abs(np.asarray(getattr(getattr(
            jnew.store, part), "xys_grad_norm"))).max())
        np.testing.assert_allclose(
            getattr(getattr(tnew.store, part), "xys_grad_norm").numpy(),
            np.asarray(getattr(getattr(jnew.store, part), "xys_grad_norm")),
            rtol=0, atol=2 * GRAD_TOL * top)


def test_bf16_sliced_route_matches_jax_sliced():
    """rasterize_tiles_fused(depth_slices=3, precision="bf16") against the
    JAX sliced bf16 route, as test_torch_slices holds the f32 one."""
    means, scales, quats, colors, opac, cam = make_scene(220, 3)

    def loss(means, scales, quats, colors, opac):
        p = jproject(means, scales, quats, jviewmat(cam.c2w), cam.fx, cam.fy,
                     cam.cx, cam.cy, cam.width, cam.height, tile_size=16,
                     opacities=jax.lax.stop_gradient(opac))
        img, alpha, bins = jcomp.rasterize_tiles_pallas_fused(
            p, colors, opac, cam.width, cam.height, 16,
            jnp.zeros((4,), jnp.float32), MAX_PAIRS, None, interpret=True,
            last_color_is_depth=True, depth_slices=3, precision="bf16")
        return (jnp.mean(img * jnp.cos(img + 0.3))
                + 0.5 * jnp.mean(alpha * jnp.sin(alpha * 2.0)),
                (img, alpha, bins))

    (jval, (jimg, jalpha, jbins)), jgrads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        means, scales, quats, colors, opac)
    val, img, alpha, bins, grads = sliced_run(3, precision="bf16")
    assert val == pytest.approx(float(jval), abs=1e-5)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=3e-5,
                               rtol=5e-5)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), atol=3e-5)
    for name, a, b in zip(["means", "scales", "quats", "colors", "opac"],
                          grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5,
                                   rtol=2e-4, err_msg=name)
    assert int(bins.num_pairs) == int(jbins.num_pairs)
    np.testing.assert_array_equal(bins.tile_count.numpy(),
                                  np.asarray(jbins.tile_count))
    f32_img = sliced_run(3)[1]
    assert float((img - f32_img).abs().max()) > 0

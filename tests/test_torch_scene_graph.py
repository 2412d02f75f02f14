"""The port's scene-graph eval render (models/scene_graph.forward_scene with
training=False, eval_extras=True) against the JAX package's on
__graft_entry__._tiny_scene (background + 2 tracked vehicles + sky, 64x48),
the JAX checkpoint carried across by engine/checkpoints, and the port's
import hygiene.

Tolerances as tests/test_torch_render.py: every rgb/accumulation/sky head
at atol 2e-5, every depth head at rtol 1e-4 where its accumulation
> 1e-3; the interpolated boxes at 1e-6."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_scene
from street_gaussians_ns_tpu.core.cameras import Camera as JCamera
from street_gaussians_ns_tpu.engine import checkpoints as jckpt
from street_gaussians_ns_tpu.models import fourier as jfourier
from street_gaussians_ns_tpu.models import gaussians as jgauss
from street_gaussians_ns_tpu.models import scene_graph as jsg
from street_gaussians_ns_tpu.models import splatfacto as jsplat
from street_gaussians_ns_tpu.ops.render import RenderConfig as JRenderConfig
from street_gaussians_ns_tpu_torch.core.cameras import Camera as TCamera
from street_gaussians_ns_tpu_torch.engine import checkpoints as tckpt
from street_gaussians_ns_tpu_torch.models import fourier as tfourier
from street_gaussians_ns_tpu_torch.models import gaussians as tgauss
from street_gaussians_ns_tpu_torch.models import scene_graph as tsg
from street_gaussians_ns_tpu_torch.models import splatfacto as tsplat
from street_gaussians_ns_tpu_torch.models.splatfacto import SplatfactoConfig
from street_gaussians_ns_tpu_torch.ops.render import RenderConfig

from test_torch_render import assert_heads_close


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = Path(__file__).resolve().parents[1]
MAX_PAIRS = 16384
DEPTH_OF = {"depth": "accumulation", "object_depth": "object_acc",
            "background_depth": "background_acc"}


def port_config(jcfg) -> tsg.SceneGraphConfig:
    """The JAX SceneGraphConfig's fields, field by field."""
    sub = {name: SplatfactoConfig(**dataclasses.asdict(getattr(jcfg, name)))
           for name in ("base", "background", "object_template")}
    rest = {f.name: getattr(jcfg, f.name)
            for f in dataclasses.fields(jcfg) if f.name not in sub}
    return tsg.SceneGraphConfig(**sub, **rest)


def store_arrays(store) -> dict:
    """A JAX pytree's leaves keyed by their checkpoint tree paths."""
    flat = jax.tree_util.tree_flatten_with_path(store)[0]
    return {jckpt._path_str(p): np.array(leaf) for p, leaf in flat}


@pytest.fixture(scope="module")
def scene():
    jcfg, store, tracks = _tiny_scene()
    # Nonzero bbox-optimizer deltas, so "simple" mode moves the boxes at
    # annotated frames.
    rng = np.random.default_rng(0)
    store = dataclasses.replace(
        store,
        delta_center=jnp.asarray(0.05 * rng.standard_normal(
            store.delta_center.shape), jnp.float32),
        delta_yaw=jnp.asarray(0.1 * rng.standard_normal(
            store.delta_yaw.shape), jnp.float32))
    return jcfg, store, tracks


def _forward_both(scene, time, jax_impl="chunked"):
    jcfg, jstore, jtracks = scene
    jcam = JCamera.make(60.0, 60.0, 32.0, 24.0, jnp.eye(3, 4), 64, 48,
                        time=time)
    jr = JRenderConfig(max_pairs=MAX_PAIRS, max_per_tile=1024, chunk=32,
                       impl=jax_impl, interpret=jax_impl == "pallas")
    # jitted, as scripts/render.py calls it
    jout, jfull, jboxes = jax.jit(
        jsg.forward_scene,
        static_argnames=("config", "render_config", "training",
                         "eval_extras"))(
        jstore, jtracks, jcam, jnp.int32(0), config=jcfg, render_config=jr,
        training=False, eval_extras=True)
    if jax_impl == "chunked":
        assert int(jfull.bins.max_tile_count) <= 1024
    cfg = port_config(jcfg)
    store = tckpt.store_from_numpy(store_arrays(jstore), cfg, device="cpu")
    tracks = tckpt.tracks_from_numpy(store_arrays(jtracks), device="cpu")
    tcam = TCamera.make(60.0, 60.0, 32.0, 24.0, np.eye(3, 4), 64, 48,
                        time=time, device="cpu")
    tout, tfull, tboxes = tsg.forward_scene(
        store, tracks, tcam, 0, cfg, RenderConfig(max_pairs=MAX_PAIRS),
        eval_extras=True)
    return (jout, jboxes), (tout, tfull, tboxes)


@pytest.mark.parametrize("time", [1.0, 0.4])
def test_forward_scene_matches_jax_chunked(scene, time):
    (jout, jboxes), (tout, tfull, tboxes) = _forward_both(scene, time)
    assert set(tout) == set(jout) == {
        "rgb", "accumulation", "depth", "sky", "object_acc",
        "background_acc", "background_rgb", "object_rgb",
        "background_depth", "object_depth"}
    assert_heads_close(tout, jout, DEPTH_OF)
    for f in ("centers", "quats", "t_norm"):
        np.testing.assert_allclose(getattr(tboxes, f).numpy(),
                                   np.asarray(getattr(jboxes, f)), atol=1e-6,
                                   err_msg=f)
    np.testing.assert_array_equal(tboxes.visible.numpy(),
                                  np.asarray(jboxes.visible))
    assert float(tout["object_acc"].max()) > 0.3
    assert float(tout["accumulation"].max()) > 0.5


@pytest.mark.slow
def test_forward_scene_matches_jax_pallas_interpret(scene):
    (jout, _), (tout, _, _) = _forward_both(scene, 1.0, jax_impl="pallas")
    assert_heads_close(tout, jout, DEPTH_OF)


def test_jax_checkpoint_renders_the_same(scene, tmp_path):
    jcfg, jstore, jtracks = scene
    path = jckpt.save_checkpoint(tmp_path, 7, {"store": jstore,
                                               "step": jnp.int32(7)})
    cfg = port_config(jcfg)
    loaded = tckpt.load_checkpoint(path, "store/", cfg, device="cpu")
    direct = tckpt.store_from_numpy(store_arrays(jstore), cfg, device="cpu")
    tracks = tckpt.tracks_from_numpy(store_arrays(jtracks), device="cpu")
    cam = TCamera.make(60.0, 60.0, 32.0, 24.0, np.eye(3, 4), 64, 48,
                       time=1.0, device="cpu")
    rcfg = RenderConfig(max_pairs=MAX_PAIRS)
    got, _, _ = tsg.forward_scene(loaded, tracks, cam, 0, cfg, rcfg)
    want, _, _ = tsg.forward_scene(direct, tracks, cam, 0, cfg, rcfg)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    with pytest.raises(KeyError):
        tckpt.load_checkpoint(path, "nothing/", cfg, device="cpu")
    with pytest.raises(ValueError):
        tckpt.store_from_numpy(store_arrays(jstore), tsg.SceneGraphConfig(),
                               device="cpu")


@pytest.mark.parametrize("mode", ["SO3xR3", "SE3"])
def test_exp_bbox_modes_render_like_jax(scene, mode):
    """The bbox optimizer's exp-map modes with nonzero rotation deltas:
    the boxes and the eval render equal the JAX package's."""
    jcfg, jstore, jtracks = scene
    rng = np.random.default_rng(4)
    jstore = dataclasses.replace(jstore, delta_rot=jnp.asarray(
        0.2 * rng.standard_normal(jstore.delta_rot.shape), jnp.float32))
    jcfg = dataclasses.replace(jcfg, bbox_mode=mode)
    (jout, jboxes), (tout, _, tboxes) = _forward_both(
        (jcfg, jstore, jtracks), 1.0)
    assert_heads_close(tout, jout, DEPTH_OF)
    for f in ("centers", "quats", "t_norm"):
        np.testing.assert_allclose(getattr(tboxes, f).numpy(),
                                   np.asarray(getattr(jboxes, f)), atol=1e-6,
                                   err_msg=f)
    tracks = tckpt.tracks_from_numpy(store_arrays(jtracks), device="cpu")
    simple = tsg.interpolate_boxes(
        tracks, torch.tensor(1.0), T(jstore.delta_center),
        T(jstore.delta_yaw))
    assert float((tboxes.quats - simple.quats).abs().max()) > 1e-2
    off = tsg.interpolate_boxes(tracks, torch.tensor(1.0), mode="off")
    want = jsg.interpolate_boxes(jtracks, jnp.float32(1.0), mode="off")
    np.testing.assert_allclose(off.centers.numpy(), np.asarray(want.centers),
                               atol=1e-6)


def test_store_helpers_match_jax(scene):
    jcfg, jstore, _ = scene
    store = tckpt.store_from_numpy(store_arrays(jstore), port_config(jcfg),
                                   device="cpu")
    for obj_j, obj_t in ((jstore.background, store.background),
                         (jstore.objects, store.objects)):
        np.testing.assert_allclose(
            tgauss.activated_opacities(obj_t.params, obj_t.active).numpy(),
            np.asarray(jgauss.activated_opacities(obj_j.params,
                                                  obj_j.active)), atol=1e-6)
        np.testing.assert_allclose(
            tgauss.activated_scales(obj_t.params).numpy(),
            np.asarray(jgauss.activated_scales(obj_j.params)), rtol=1e-6)
    # Per-object Fourier DC at per-object times (the JAX side vmaps).
    t = np.array([0.0, 0.37], np.float32)
    np.testing.assert_allclose(
        tfourier.fourier_dc(store.objects.params.features_dc,
                            torch.from_numpy(t)).numpy(),
        np.asarray(jax.vmap(jfourier.fourier_dc)(
            jstore.objects.params.features_dc, t)), atol=1e-5)
    np.testing.assert_allclose(tfourier.idft_basis(torch.tensor(0.3), 5),
                               jfourier.idft_basis(0.3, 5), atol=1e-6)
    env = tsplat.init_env_map(tsplat.SplatfactoConfig(env_map_res=8),
                              device="cpu")
    np.testing.assert_array_equal(env.numpy(), np.asarray(
        jsplat.init_env_map(jsplat.SplatfactoConfig(env_map_res=8))))
    je, te = jsg.empty_tracks(3, 2), tsg.empty_tracks(3, 2, device="cpu")
    for f in dataclasses.fields(je):
        np.testing.assert_array_equal(getattr(te, f.name).numpy(),
                                      np.asarray(getattr(je, f.name)),
                                      err_msg=f.name)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, in a fresh process:
    neither jax nor the JAX package may be imported, nor TensorFlow (the
    Waymo extractor imports it only when it runs)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import street_gaussians_ns_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [n for n in sys.modules if n in ('jax', "
        "'street_gaussians_ns_tpu') or n.startswith(('jax.', "
        "'street_gaussians_ns_tpu.'))]\n"
        "assert not bad, bad\n"
        "assert 'tensorflow' not in sys.modules\n"
        "print(' '.join(n for n in sys.modules "
        "if n.startswith(p.__name__)))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    walked = set(res.stdout.split())
    assert len(walked) >= 20
    pkg = "street_gaussians_ns_tpu_torch."
    assert {pkg + m for m in ("models.camera_opt", "engine.train_step",
                              "utils.viewer", "utils.profiling",
                              "scripts.viewer", "ops.packing",
                              "parallel.mesh", "parallel.collectives",
                              "parallel.sharded",
                              "parallel.trainer",
                              "preprocess.segs_generate",
                              "preprocess.masks_generate",
                              "preprocess.pcd2colmap_points3d",
                              "preprocess.extract_object_pts",
                              "preprocess.transform2colmap",
                              "preprocess.extract_waymo")} <= walked


@pytest.mark.parametrize("objects", [2, 0])
def test_tracks_without_frames_render_like_jax_objects_invisible(scene,
                                                                 objects):
    """Tracks with no annotated frame (a clip without tracked objects, the
    trainer's empty_tracks()): the JAX interpolate_boxes raises
    IndexError there, and the port did too. The port now sees no box, and
    its render (background and sky alone) equals the JAX render of the
    same store on tracks of one frame with every object invalid. With
    objects=2 the stores of two vehicles are present and invisible; with
    0 the scene graph has no object axis, as the trainer builds it."""
    jcfg, jstore, _ = scene
    if objects == 0:
        jstore = dataclasses.replace(
            jstore, objects=jax.tree.map(lambda x: x[:0], jstore.objects))
    jtracks = jsg.empty_tracks(objects, 1)
    jstore = dataclasses.replace(
        jstore, delta_center=jnp.zeros((1, objects, 3), jnp.float32),
        delta_yaw=jnp.zeros((1, objects), jnp.float32),
        delta_rot=jnp.zeros((1, objects, 3), jnp.float32))
    with pytest.raises(IndexError):
        jsg.interpolate_boxes(jsg.empty_tracks(objects, 0), jnp.float32(0.5))
    jcam = JCamera.make(60.0, 60.0, 32.0, 24.0, jnp.eye(3, 4), 64, 48,
                        time=0.5)
    jr = JRenderConfig(max_pairs=MAX_PAIRS, max_per_tile=1024, chunk=32,
                       impl="chunked")
    jout, _, _ = jax.jit(
        jsg.forward_scene,
        static_argnames=("config", "render_config", "training",
                         "eval_extras"))(
        jstore, jtracks, jcam, jnp.int32(0), config=jcfg, render_config=jr,
        training=False, eval_extras=True)

    cfg = port_config(jcfg)
    store = tckpt.store_from_numpy(store_arrays(jstore), cfg, device="cpu")
    store = dataclasses.replace(store, delta_center=store.delta_center[:0],
                                delta_yaw=store.delta_yaw[:0],
                                delta_rot=store.delta_rot[:0])
    tracks = tsg.empty_tracks(objects, 0, device="cpu")
    assert tracks.num_frames == 0
    boxes = tsg.interpolate_boxes(tracks, torch.tensor(0.5))
    assert boxes.visible.shape == (objects,) and not boxes.visible.any()
    tcam = TCamera.make(60.0, 60.0, 32.0, 24.0, np.eye(3, 4), 64, 48,
                        time=0.5, device="cpu")
    tout, _, _ = tsg.forward_scene(store, tracks, tcam, 0, cfg,
                                   RenderConfig(max_pairs=MAX_PAIRS),
                                   eval_extras=True)
    assert_heads_close(tout, jout, DEPTH_OF)
    assert float(tout["object_acc"].max()) == 0.0
    assert float(tout["accumulation"].max()) > 0.5

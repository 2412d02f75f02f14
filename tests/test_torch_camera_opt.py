"""The port's camera pose optimizer (models/camera_opt.py), the bbox
optimizer's exp-map modes (models/scene_graph.interpolate_boxes) and the
camera-optimizer step (engine/scene_train_step) against the JAX package's,
on the CPU, from the same numpy inputs.

Tolerances:
- the exp maps, apply_camera_opt and the boxes: values at atol 1e-6, their
  gradients (jax.grad against autograd of one weighted sum) at atol 1e-5,
  on random tangents, the zero tangent and |omega| = 1e-7, where every
  gradient must be finite.
- from_rotmat on the exp maps' rotations, near 180 degrees too: atol 1e-6
  up to the quaternion's sign.
- one camera-optimizer step: loss and metrics at atol 2e-5 / rtol 1e-5;
  every Gaussian and bbox group's first moment (0.1 g) at the gradient
  tolerance of tests/test_torch_train_step.py (2e-5 of the group's
  largest |g|) and its parameters at 1e-3 of lr where |g| is above that
  floor; the camera accumulator within 1e-3 of its largest entry (the
  pose gradient is a sum over every gaussian and every sky ray, so its
  rounding differs); `calls` exactly.
- 100 calls of the camera group's accumulating Adam: the accumulator at
  rtol 1e-6, the parameters unchanged through call 99 and at rtol 1e-6
  after call 100.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.core import quaternions as jquat
from street_gaussians_ns_tpu.core.cameras import Camera as JCamera
from street_gaussians_ns_tpu.engine import optimizers as jopt
from street_gaussians_ns_tpu.engine import scene_train_step as jsts
from street_gaussians_ns_tpu.models import camera_opt as jco
from street_gaussians_ns_tpu.models import scene_graph as jsg
from street_gaussians_ns_tpu.ops.render import RenderConfig as JRenderConfig
from street_gaussians_ns_tpu_torch.core import quaternions as tquat
from street_gaussians_ns_tpu_torch.core.cameras import Camera as TCamera
from street_gaussians_ns_tpu_torch.engine import checkpoints as tckpt
from street_gaussians_ns_tpu_torch.engine import optimizers as topt
from street_gaussians_ns_tpu_torch.engine import scene_train_step as tsts
from street_gaussians_ns_tpu_torch.engine.train_step import GAUSSIAN_GROUPS
from street_gaussians_ns_tpu_torch.models import camera_opt as tco
from street_gaussians_ns_tpu_torch.models import scene_graph as tsg
from street_gaussians_ns_tpu_torch.ops.render import RenderConfig

from test_scene_graph import make_tracks
from test_torch_scene_graph import MAX_PAIRS, port_config, store_arrays
from test_torch_train_step import GRAD_TOL, H, W
from test_torch_train_step import eval_scene  # noqa: F401 (fixture)
from test_torch_train_step import scene  # noqa: F401 (fixture)


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


def _tangents(kind: str, rng) -> np.ndarray:
    f32 = np.float32
    if kind == "random":
        return rng.standard_normal((5, 6)).astype(f32)
    x = np.zeros((3, 6), f32)
    x[:, :3] = rng.standard_normal((3, 3))
    if kind == "tiny":
        x[:, 3:] = 1e-7 * np.array([[1, 0, 0], [0, 1, 0], [0.6, 0, 0.8]])
    elif kind == "near_pi":
        axes = rng.standard_normal((3, 3))
        axes /= np.linalg.norm(axes, axis=1, keepdims=True)
        x[:, 3:] = axes * (np.pi - np.array([1e-2, 1e-3, 1e-4]))[:, None]
    return x


@pytest.mark.parametrize("kind", ["random", "zero", "tiny", "near_pi"])
@pytest.mark.parametrize("name", ["exp_map_SO3xR3", "exp_map_SE3"])
def test_exp_maps_and_gradients_match_jax(name, kind):
    rng = np.random.default_rng(len(kind))
    x = _tangents(kind, rng)
    wgt = rng.standard_normal((x.shape[0], 3, 4)).astype(np.float32)
    jfn, tfn = getattr(jco, name), getattr(tco, name)
    want = np.asarray(jfn(jnp.asarray(x)))
    jg = np.asarray(jax.grad(lambda a: jnp.sum(jfn(a) * wgt))(jnp.asarray(x)))
    tx = T(x).requires_grad_(True)
    got = tfn(tx)
    (tg,) = torch.autograd.grad((got * T(wgt)).sum(), tx)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    assert np.isfinite(jg).all() and bool(torch.isfinite(tg).all())
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-5)
    # Rotations: orthonormal with determinant 1.
    R = got.detach()[..., :3]
    np.testing.assert_allclose((R @ R.transpose(-1, -2)).numpy(),
                               np.broadcast_to(np.eye(3), R.shape),
                               atol=2e-6)
    if kind == "zero":
        np.testing.assert_array_equal(R.numpy(),
                                      np.broadcast_to(np.eye(3), R.shape))


@pytest.mark.parametrize("kind", ["random", "tiny", "near_pi"])
def test_from_rotmat_on_exp_map_rotations_matches_jax(kind):
    x = _tangents(kind, np.random.default_rng(7))
    R = tco.exp_map_SO3xR3(T(x))[..., :3]
    got = tquat.from_rotmat(R).numpy()
    want = np.asarray(jquat.from_rotmat(jnp.asarray(R.numpy())))
    sign = np.sign(np.sum(got * want, axis=-1, keepdims=True))
    np.testing.assert_allclose(got * sign, want, atol=1e-6)
    np.testing.assert_allclose(tquat.to_rotmat(T(got)).numpy(), R.numpy(),
                               atol=2e-5)


@pytest.mark.parametrize("mode", ["off", "SO3xR3", "SE3"])
def test_apply_camera_opt_matches_jax(mode):
    rng = np.random.default_rng(3)
    adj = (0.1 * rng.standard_normal((4, 6))).astype(np.float32)
    adj[0] = 0.0
    c2w = rng.standard_normal((3, 4)).astype(np.float32)
    wgt = rng.standard_normal((3, 4)).astype(np.float32)
    jcfg = jco.CameraOptConfig(mode=mode, num_cameras=4)
    tcfg = tco.CameraOptConfig(mode=mode, num_cameras=4)
    for idx in (0, 2):
        def jloss(a, c):
            return jnp.sum(jco.apply_camera_opt(jcfg, a, jnp.int32(idx), c)
                           * wgt)

        want = np.asarray(jco.apply_camera_opt(
            jcfg, jnp.asarray(adj), jnp.int32(idx), jnp.asarray(c2w)))
        ta = T(adj).requires_grad_(True)
        tc = T(c2w).requires_grad_(True)
        got = tco.apply_camera_opt(tcfg, ta, idx, tc)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
        if mode == "off":
            assert got is tc
            continue
        jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(adj),
                                            jnp.asarray(c2w))
        tg = torch.autograd.grad((got * T(wgt)).sum(), (ta, tc))
        for t, j in zip(tg, jg):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
        assert not tg[0][[r for r in range(4) if r != idx]].any()
    zeros = tco.init_camera_opt(tcfg, "cpu")
    if mode == "off":
        assert zeros is None and jco.init_camera_opt(jcfg) is None
    else:
        np.testing.assert_array_equal(zeros.numpy(),
                                      np.asarray(jco.init_camera_opt(jcfg)))
        assert zeros.dtype == torch.float32


# ---------------------------------------------------------------------------
# interpolate_boxes in the exp-map modes (tests/test_round2_features.py).
# ---------------------------------------------------------------------------

def _tracks():
    jtracks = make_tracks()
    return jtracks, tckpt.tracks_from_numpy(store_arrays(jtracks),
                                            device="cpu")


@pytest.mark.parametrize("mode", ["SO3xR3", "SE3"])
def test_bbox_expmap_applies_translation_and_rotation(mode):
    jtracks, tracks = _tracks()
    F, O = jtracks.num_frames, jtracks.num_objects
    dc = np.zeros((F, O, 3), np.float32)
    dr = np.zeros((F, O, 3), np.float32)
    dc[1, 0] = [0.5, 0.0, 0.0]
    dr[1, 0] = [0.0, 0.0, 0.3]
    for t in (1.0, 1.5, 0.0):
        want = jsg.interpolate_boxes(
            jtracks, jnp.float32(t), delta_center=jnp.asarray(dc),
            delta_rot=jnp.asarray(dr), mode=mode, differentiable=True)
        got = tsg.interpolate_boxes(tracks, torch.tensor(t), T(dc),
                                    mode=mode, delta_rot=T(dr),
                                    differentiable=True)
        for f in ("centers", "quats", "t_norm"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       atol=1e-6, err_msg=f"{t} {f}")
        np.testing.assert_array_equal(got.visible.numpy(),
                                      np.asarray(want.visible))
    base = tsg.interpolate_boxes(tracks, torch.tensor(1.0), mode="off")
    got = tsg.interpolate_boxes(tracks, torch.tensor(1.0), T(dc), mode=mode,
                                delta_rot=T(dr), differentiable=True)
    moved = (got.centers[0] - base.centers[0]).numpy()
    if mode == "SO3xR3":      # the tangent's translation, un-rotated
        np.testing.assert_allclose(moved, [0.5, 0.0, 0.0], atol=1e-6)
    else:                     # V rho
        assert abs(moved[0] - 0.5) < 0.05 and abs(moved[2]) < 1e-5
    assert float((got.quats[0] - base.quats[0]).abs().max()) > 1e-3
    np.testing.assert_allclose(got.quats[1].numpy(), base.quats[1].numpy(),
                               atol=1e-6)
    with pytest.raises(ValueError, match="bbox_mode"):
        tsg.interpolate_boxes(tracks, torch.tensor(1.0), mode="SO3")


@pytest.mark.parametrize("mode", ["simple", "SO3xR3", "SE3"])
@pytest.mark.parametrize("differentiable", [False, True])
def test_bbox_grads_match_jax(mode, differentiable):
    """The reference detaches the correction in every mode, so no
    gradient reaches the deltas by default; bbox_differentiable=True
    lets it through. Deltas of 0.01 sit in the exp maps' large-angle
    branch, zero ones in the small-angle branch."""
    jtracks, tracks = _tracks()
    F, O = jtracks.num_frames, jtracks.num_objects
    rng = np.random.default_rng(5)
    wc = rng.standard_normal((O, 3)).astype(np.float32)
    wq = rng.standard_normal((O, 4)).astype(np.float32)
    for fill in (0.01, 0.0):
        dc = np.full((F, O, 3), fill, np.float32)
        dr = np.full((F, O, 3), fill, np.float32)
        dy = np.full((F, O), fill, np.float32)

        def jloss(c, r, y):
            b = jsg.interpolate_boxes(jtracks, jnp.float32(1.0), c, y,
                                      differentiable=differentiable,
                                      mode=mode, delta_rot=r)
            return jnp.sum(b.centers * wc) + jnp.sum(b.quats * wq)

        jv = jloss(jnp.asarray(dc), jnp.asarray(dr), jnp.asarray(dy))
        jg = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(dc), jnp.asarray(dr), jnp.asarray(dy))
        args = [T(a).requires_grad_(True) for a in (dc, dr, dy)]
        b = tsg.interpolate_boxes(tracks, torch.tensor(1.0), args[0],
                                  args[2], mode=mode, delta_rot=args[1],
                                  differentiable=differentiable)
        loss = (b.centers * T(wc)).sum() + (b.quats * T(wq)).sum()
        np.testing.assert_allclose(float(loss.detach()), float(jv),
                                   atol=1e-5)
        if not differentiable:
            assert not loss.requires_grad
            assert all(float(jnp.abs(g).max()) == 0.0 for g in jg)
            continue
        tg = torch.autograd.grad(loss, args, allow_unused=True)
        for t, j, a, name in zip(tg, jg, args, ("center", "rot", "yaw")):
            t = torch.zeros_like(a) if t is None else t
            assert bool(torch.isfinite(t).all()), name
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                       err_msg=f"{name} {fill}")
        assert float(jnp.abs(jg[0]).max()) > 0
        assert float(jnp.abs(jg[1 if mode != "simple" else 2]).max()) > 0


# ---------------------------------------------------------------------------
# One scene-graph step with the camera optimizer.
# ---------------------------------------------------------------------------

STEP = 1500
# (camera mode, bbox mode, bbox_differentiable, the camera's row): row 0
# holds a zero tangent, as every row of a fresh run (the small-angle
# branch), row 1 a nonzero one.
MODES = [("SO3xR3", "simple", False, 0), ("SE3", "SE3", True, 1)]


@pytest.fixture(scope="module", params=MODES, ids=[m[0] for m in MODES])
def camopt(request, scene):  # noqa: F811
    mode, bbox_mode, bbox_diff, row = request.param
    jcfg0, jstore, jtracks = scene
    jcfg = dataclasses.replace(jcfg0, camera_opt_mode=mode,
                               bbox_mode=bbox_mode,
                               bbox_differentiable=bbox_diff)
    rng = np.random.default_rng(11)
    jstore = dataclasses.replace(jstore, delta_rot=jnp.asarray(
        0.05 * rng.standard_normal(jstore.delta_rot.shape), jnp.float32))
    cam0 = (0.02 * rng.standard_normal((3, 6))).astype(np.float32)
    cam0[0] = 0.0
    batch = {"image": rng.random((H, W, 3), dtype=np.float32),
             "semantic": rng.integers(0, 4, (H, W, 1)).astype(np.int32)}
    jstate = dataclasses.replace(
        jsts.init_scene_train_state(jstore, jax.random.PRNGKey(5),
                                    camera_opt=jnp.asarray(cam0)),
        step=jnp.int32(STEP))
    c2w = np.eye(3, 4, dtype=np.float32)
    c2w[:, 3] = [0.1, -0.2, 0.3]
    jc = JCamera.make(60.0, 60.0, 32.0, 24.0, jnp.asarray(c2w), W, H,
                      time=1.0)
    jr = JRenderConfig(max_pairs=MAX_PAIRS, max_per_tile=1024, chunk=32,
                       impl="chunked")
    jnew, jm = jax.jit(
        jsts.scene_train_step,
        static_argnames=("config", "render_config", "subset_accs"))(
        jstate, jtracks, jc, batch, config=jcfg, render_config=jr,
        subset_accs=False, camera_index=jnp.int32(row))
    assert int(jm["max_tile_count"]) <= 1024
    k_sky = jax.random.split(jstate.rng)[1]

    cfg = port_config(jcfg)
    tstate = tckpt.train_state_from_numpy(store_arrays(jstate), cfg,
                                          device="cpu")
    tracks = tckpt.tracks_from_numpy(store_arrays(jtracks), device="cpu")
    tc = TCamera.make(60.0, 60.0, 32.0, 24.0, c2w, W, H, time=1.0,
                      device="cpu")
    jitter = T(np.asarray(jax.random.uniform(k_sky, (2, H, W), jnp.float32)))
    tnew, tm = tsts.scene_train_step(
        tstate, tracks, tc, {k: T(v) for k, v in batch.items()}, cfg,
        RenderConfig(max_pairs=MAX_PAIRS), subset_accs=False,
        jitter=jitter, camera_index=row)
    return dict(mode=mode, bbox_diff=bbox_diff, row=row, cam0=cam0,
                jstate=jstate,
                jnew=jnew, jm=jm, tstate=tstate, tnew=tnew, tm=tm)


def test_camera_opt_step_loss_and_metrics_match_jax(camopt):
    jm, tm = camopt["jm"], camopt["tm"]
    assert set(tm) == set(jm)
    for k in set(jm) - {"num_rowruns"}:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=2e-5, err_msg=k)
    assert camopt["tnew"].step == STEP + 1


def _groups(camopt):
    """(name, port new params, JAX new params, start params, port mu,
    JAX mu, lr) of every Gaussian and bbox leaf."""
    tnew, jnew, j0 = camopt["tnew"], camopt["jnew"], camopt["jstate"]
    for n in GAUSSIAN_GROUPS:
        for k, part in (("bg", "background"), ("obj", "objects")):
            yield (f"{n}/{k}",
                   getattr(getattr(tnew.store, part).params, n),
                   getattr(getattr(jnew.store, part).params, n),
                   getattr(getattr(j0.store, part).params, n),
                   tnew.opt[n].mu[k], jnew.opt[n].mu[k],
                   topt.schedule(topt.DEFAULT_GROUPS[n], STEP))
    for n in tsts.BBOX_PARAMS:
        yield (f"bbox/{n}", getattr(tnew.store, n), getattr(jnew.store, n),
               getattr(j0.store, n), tnew.opt["bbox_opt"].mu[n],
               jnew.opt["bbox_opt"].mu[n],
               topt.schedule(topt.DEFAULT_GROUPS["bbox_opt"], STEP))


def test_camera_opt_step_groups_match_jax(camopt):
    """Every group from the first Adam step (mu = 0.1 g): the moments at
    the gradient tolerance, the parameters where the gradient is clear of
    rounding; the bbox deltas get a gradient only when differentiable."""
    for name, tp, jp, p0, tmu, jmu, lr in _groups(camopt):
        jmu = np.asarray(jmu)
        top = float(np.abs(jmu).max())
        if name.startswith("bbox/"):
            if not camopt["bbox_diff"]:
                assert top == 0.0 and not tmu.any(), name
                np.testing.assert_array_equal(tp.numpy(), np.asarray(p0))
                continue
            if name == "bbox/delta_yaw":     # the SE3 mode reads no yaw
                assert top == 0.0 and not tmu.any(), name
                continue
        assert top > 0, name
        np.testing.assert_allclose(tmu.numpy(), jmu, rtol=0,
                                   atol=GRAD_TOL * top, err_msg=name)
        sure = np.abs(jmu) > GRAD_TOL * top
        np.testing.assert_allclose(tp.numpy()[sure], np.asarray(jp)[sure],
                                   rtol=1e-6, atol=1e-3 * lr, err_msg=name)
        assert float(np.abs(tp.numpy() - np.asarray(p0)).max()) \
            <= 2 * lr * 1.001, name


def test_camera_opt_accumulator_matches_jax(camopt):
    """One call of the 100-call accumulation: the deltas stand still, the
    accumulator holds this step's gradient on the stepped row only."""
    tnew, jnew = camopt["tnew"], camopt["jnew"]
    tst, jst = tnew.opt["camera_opt"], jnew.opt["camera_opt"]
    assert tst.calls == int(jst.calls) == 1
    assert tst.count == int(jst.count) == 0
    jacc = np.asarray(jst.acc)
    top = float(np.abs(jacc).max())
    assert top > 0 and bool(torch.isfinite(tst.acc).all())
    np.testing.assert_allclose(tst.acc.numpy(), jacc, rtol=0,
                               atol=1e-3 * top)
    row = camopt["row"]
    others = [r for r in range(3) if r != row]
    assert not tst.acc[others].any() and np.abs(jacc[row]).min() > 0
    np.testing.assert_array_equal(tnew.camera_opt.numpy(), camopt["cam0"])
    np.testing.assert_array_equal(np.asarray(jnew.camera_opt),
                                  camopt["cam0"])
    assert torch.equal(camopt["tstate"].opt["camera_opt"].acc,
                       torch.zeros((3, 6)))          # input untouched


def test_camera_opt_state_round_trips_jax_checkpoint_arrays(camopt):
    """The step's state under the JAX keys, camera_opt and its Adam
    group's acc and calls included, equal to the JAX state's arrays."""
    back = tckpt.state_to_numpy(camopt["tnew"])
    want = store_arrays(camopt["jnew"])
    assert set(back) == set(want) - {"rng"}
    assert {"camera_opt", "opt/camera_opt/acc",
            "opt/camera_opt/calls"} <= set(back)
    for k in ("camera_opt", "opt/camera_opt/calls", "opt/camera_opt/count",
              "step"):
        assert back[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_camera_group_accumulates_100_calls_like_jax():
    """DEFAULT_GROUPS["camera_opt"] (accum_steps 100) through adam_update
    in both packages from the same gradients: nothing moves through call
    99, call 100 steps Adam with the sum and clears the accumulator."""
    cfg_t = topt.DEFAULT_GROUPS["camera_opt"]
    cfg_j = jopt.DEFAULT_GROUPS["camera_opt"]
    assert cfg_t.accum_steps == cfg_j.accum_steps == 100
    rng = np.random.default_rng(9)
    p0 = (0.01 * rng.standard_normal((4, 6))).astype(np.float32)
    grads = (1e-3 * rng.standard_normal((100, 4, 6))).astype(np.float32)
    tp, tst = T(p0), topt.init_adam(T(p0), accum_steps=100)
    jp, jst = jnp.asarray(p0), jopt.init_adam(jnp.asarray(p0),
                                              accum_steps=100)
    step = jax.jit(jopt.adam_update, static_argnames=("config",))
    for i in range(100):
        lr = topt.schedule(cfg_t, 3000 + i)
        np.testing.assert_allclose(
            lr, float(jopt.schedule(cfg_j, jnp.int32(3000 + i))), rtol=1e-6)
        tp, tst = topt.adam_update(T(grads[i]), tst, tp, lr, cfg_t)
        jp, jst = step(jnp.asarray(grads[i]), jst, jp, jnp.float32(lr),
                       config=cfg_j)
        assert tst.calls == int(jst.calls) == i + 1
        if i < 99:
            np.testing.assert_array_equal(tp.numpy(), p0)
            np.testing.assert_array_equal(np.asarray(jp), p0)
            np.testing.assert_allclose(tst.acc.numpy(), np.asarray(jst.acc),
                                       rtol=1e-6, atol=1e-9)
    assert tst.count == int(jst.count) == 1
    assert not tst.acc.any() and not np.asarray(jst.acc).any()
    assert float((tp - T(p0)).abs().min()) > 0
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-9)
    for a, b in ((tst.mu, jst.mu), (tst.nu, jst.nu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)

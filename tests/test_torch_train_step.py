"""One scene-graph training step of the port (engine/scene_train_step.py)
against the JAX package's from the same carried state, batch and sky
jitter, on the CPU, and the train-state checkpoint carry
(engine/checkpoints.train_state_from_numpy / state_to_numpy).

The step runs with subset_accs=True at a step past the background's
stop_split_at, so the entropy loss is live and all three renders
differentiate. The JAX side renders with impl="chunked" (its per-tile
budget asserted to truncate nothing); its gradients come from jax.grad
over forward_scene + scene_loss_dict with the jitter key the step uses.

Tolerances:
- loss and metrics: atol 2e-5 / rtol 1e-5 (the render tolerance).
- every gradient: 2e-5 of the group's largest |g| (the rasterizer's
  gradients agree to atol 1e-6 on a mean-type loss, tests/
  test_torch_backward.py; projection and SH chain them onward), which is
  also the floor below.
- with eps 1e-15 the first Adam step is lr sign(g), so a gradient within
  rounding of zero may step either way: parameters are compared (atol 1e-3
  of lr) where the reference's |g| is above the floor, and bounded by
  2 lr elsewhere; first and second moments at what the gradient tolerance
  makes of 0.1 g and 0.001 g^2.
- densification stats: visibility counts and screen sizes exact, the
  accumulated screen-space gradient norm at the gradient tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.core.cameras import Camera as JCamera
from street_gaussians_ns_tpu.engine import checkpoints as jckpt
from street_gaussians_ns_tpu.engine import scene_train_step as jsts
from street_gaussians_ns_tpu.engine.train_step import (
    GAUSSIAN_GROUPS as J_GROUPS)
from street_gaussians_ns_tpu.models import scene_graph as jsg
from street_gaussians_ns_tpu.ops.render import RenderConfig as JRenderConfig
from street_gaussians_ns_tpu_torch.core.cameras import Camera as TCamera
from street_gaussians_ns_tpu_torch.engine import checkpoints as tckpt
from street_gaussians_ns_tpu_torch.engine import optimizers as topt
from street_gaussians_ns_tpu_torch.engine import scene_train_step as tsts
from street_gaussians_ns_tpu_torch.engine.train_step import GAUSSIAN_GROUPS
from street_gaussians_ns_tpu_torch.ops.render import RenderConfig

from test_torch_scene_graph import MAX_PAIRS, port_config, store_arrays
from test_torch_scene_graph import scene as eval_scene  # noqa: F401 (fixture)


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


STEP = 15001          # past background.stop_split_at: the entropy loss is on
GRAD_TOL = 2e-5       # of the group's largest |g|
W, H = 64, 48


@pytest.fixture(scope="module")
def scene(eval_scene):  # noqa: F811
    """The eval tests' scene with anisotropic scales and a textured sky:
    its own scales are isotropic and its sky constant, which makes the
    quaternion and sky-ray gradients pure rounding."""
    jcfg, store, tracks = eval_scene
    rng = np.random.default_rng(1)

    def aniso(part):
        s = part.params.scales
        return dataclasses.replace(part, params=dataclasses.replace(
            part.params, scales=s + jnp.asarray(
                0.4 * rng.standard_normal(s.shape), jnp.float32)))

    return jcfg, dataclasses.replace(
        store, background=aniso(store.background),
        objects=aniso(store.objects),
        env_map=jnp.asarray(rng.random(store.env_map.shape), jnp.float32)
    ), tracks


@pytest.fixture(scope="module")
def both(scene):
    jcfg, jstore, jtracks = scene
    assert STEP > jcfg.background.stop_split_at
    rng = np.random.default_rng(0)
    batch = {"image": rng.random((H, W, 3), dtype=np.float32),
             "semantic": rng.integers(0, 4, (H, W, 1)).astype(np.int32)}
    jstate = dataclasses.replace(
        jsts.init_scene_train_state(jstore, jax.random.PRNGKey(5)),
        step=jnp.int32(STEP))
    jc = JCamera.make(60.0, 60.0, 32.0, 24.0, jnp.eye(3, 4), W, H, time=1.0)
    jr = JRenderConfig(max_pairs=MAX_PAIRS, max_per_tile=1024, chunk=32,
                       impl="chunked")
    jnew, jmetrics = jax.jit(
        jsts.scene_train_step,
        static_argnames=("config", "render_config", "subset_accs"))(
        jstate, jtracks, jc, batch, config=jcfg, render_config=jr,
        subset_accs=True)
    assert int(jmetrics["max_tile_count"]) <= 1024
    k_sky = jax.random.split(jstate.rng)[1]

    def loss_fn(gauss, env_map, xys_offset):
        s = dataclasses.replace(
            jstore,
            background=dataclasses.replace(
                jstore.background, params=dataclasses.replace(
                    jstore.background.params,
                    **{k: v["bg"] for k, v in gauss.items()})),
            objects=dataclasses.replace(
                jstore.objects, params=dataclasses.replace(
                    jstore.objects.params,
                    **{k: v["obj"] for k, v in gauss.items()})),
            env_map=env_map)
        out, _, _ = jsg.forward_scene(
            s, jtracks, jc, jnp.int32(STEP), jcfg, jr, rng=k_sky,
            training=True, xys_offset=xys_offset, subset_accs=True)
        return sum(jsg.scene_loss_dict(out, batch, jcfg,
                                       jnp.int32(STEP)).values())

    gauss = {n: {"bg": getattr(jstore.background.params, n),
                 "obj": getattr(jstore.objects.params, n)} for n in J_GROUPS}
    n_flat = jstore.background.active.size + jstore.objects.active.size
    jgrads = jax.jit(jax.grad(loss_fn, argnums=(0, 1, 2)))(
        gauss, jstore.env_map, jnp.zeros((n_flat, 2), jnp.float32))

    cfg = port_config(jcfg)
    tstate = tckpt.train_state_from_numpy(store_arrays(jstate), cfg,
                                          device="cpu")
    tracks = tckpt.tracks_from_numpy(store_arrays(jtracks), device="cpu")
    tc = TCamera.make(60.0, 60.0, 32.0, 24.0, np.eye(3, 4), W, H, time=1.0,
                      device="cpu")
    jitter = T(np.asarray(jax.random.uniform(k_sky, (2, H, W),
                                             jnp.float32)))
    tbatch = {k: T(v) for k, v in batch.items()}
    rcfg = RenderConfig(max_pairs=MAX_PAIRS)
    tnew, tmetrics = tsts.scene_train_step(
        tstate, tracks, tc, tbatch, cfg, rcfg, subset_accs=True,
        jitter=jitter)
    tgrads = tsts.scene_loss_and_grads(
        tstate, tracks, tc, tbatch, cfg, rcfg, subset_accs=True,
        jitter=jitter)[4]
    return dict(jstate=jstate, jnew=jnew, jmetrics=jmetrics, jgrads=jgrads,
                tstate=tstate, tnew=tnew, tmetrics=tmetrics, tgrads=tgrads,
                cfg=cfg, tracks=tracks, cam=tc, batch=tbatch, rcfg=rcfg)


def test_step_loss_and_metrics_match_jax(both):
    jm, tm = both["jmetrics"], both["tmetrics"]
    assert set(tm) == set(jm)
    assert {"Ll1", "simloss", "sky_accumulation",
            "object_acc_entropy_loss", "loss", "psnr"} <= set(tm)
    for k in set(jm) - {"num_rowruns"}:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=2e-5, err_msg=k)
    # The reference's portable binning counts a gaussian's untrimmed tile
    # rows, the fused binning only the rows its ellipse reaches.
    assert 0 < int(tm["num_rowruns"]) <= int(jm["num_rowruns"])
    assert float(tm["object_acc_entropy_loss"]) > 0
    assert both["tnew"].step == STEP + 1 == int(both["jnew"].step)
    assert both["tstate"].step == STEP                 # input untouched


def _grad_pairs(both):
    jg_gauss, jg_env, jg_xys = both["jgrads"]
    tg = both["tgrads"]
    for name in GAUSSIAN_GROUPS:
        for k in ("bg", "obj"):
            yield f"{name}/{k}", tg["gauss"][name][k], jg_gauss[name][k]
    yield "env_map", tg["env_map"], jg_env
    yield "xys", tg["xys"], jg_xys


def test_step_gradients_match_jax(both):
    for name, t, j in _grad_pairs(both):
        j = np.asarray(j)
        top = float(np.abs(j).max())
        assert top > 0, name
        assert bool(torch.isfinite(t).all()), name
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=GRAD_TOL * top,
                                   err_msg=name)
    for name, g in both["tgrads"]["bbox"].items():
        assert not g.any(), name        # detached, as the reference


def test_step_parameters_and_moments_match_jax(both):
    jnew, tnew, jstate = both["jnew"], both["tnew"], both["jstate"]
    jg_gauss, jg_env, _ = both["jgrads"]
    groups = [(n, k, getattr(getattr(tnew.store, part).params, n),
               getattr(getattr(jnew.store, part).params, n),
               getattr(getattr(jstate.store, part).params, n),
               tnew.opt[n].mu[k], jnew.opt[n].mu[k], tnew.opt[n].nu[k],
               jnew.opt[n].nu[k], jg_gauss[n][k],
               getattr(jstate.store, part).active)
              for n in GAUSSIAN_GROUPS
              for k, part in (("bg", "background"), ("obj", "objects"))]
    groups.append(("sky_sphere", "", tnew.store.env_map, jnew.store.env_map,
                   jstate.store.env_map, tnew.opt["sky_sphere"].mu,
                   jnew.opt["sky_sphere"].mu, tnew.opt["sky_sphere"].nu,
                   jnew.opt["sky_sphere"].nu, jg_env, None))
    for (name, k, tp, jp, p0, tmu, jmu, tnu, jnu, jg, active) in groups:
        msg = f"{name}/{k}"
        jg, jp, p0 = np.asarray(jg), np.asarray(jp), np.asarray(p0)
        if active is not None:     # the step masks inactive slots' gradients
            a = np.asarray(active)
            jg = np.where(a.reshape(a.shape + (1,) * (jg.ndim - a.ndim)),
                          jg, 0.0)
        lr = topt.schedule(topt.DEFAULT_GROUPS[name], STEP)
        floor = GRAD_TOL * float(np.abs(jg).max())
        sure = np.abs(jg) > floor
        assert sure.any(), msg
        np.testing.assert_allclose(tp.numpy()[sure], jp[sure], rtol=1e-6,
                                   atol=1e-3 * lr, err_msg=msg)
        assert float(np.abs(tp.numpy() - p0).max()) <= 2 * lr * 1.001, msg
        assert float(np.abs(tp.numpy() - jp)[~sure].max(initial=0)) \
            <= 2 * lr * 1.001, msg
        moved = np.abs(tp.numpy() - p0)[sure]
        np.testing.assert_allclose(moved, lr, rtol=1e-2, err_msg=msg)
        np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=1e-5,
                                   atol=0.1 * floor, err_msg=msg)
        nu_err = np.abs(tnu.numpy() - np.asarray(jnu))
        nu_tol = (1e-5 * np.asarray(jnu)
                  + 1e-3 * (2 * np.abs(jg) * floor + floor ** 2))
        assert (nu_err <= nu_tol).all(), (msg, float(
            (nu_err / np.maximum(nu_tol, 1e-38)).max()))
        assert tnew.opt[name].count == int(jnew.opt[name].count) == 1
    # bbox deltas: zero gradients, so Adam leaves them where they were.
    for n in tsts.BBOX_PARAMS:
        np.testing.assert_array_equal(getattr(tnew.store, n).numpy(),
                                      np.asarray(getattr(jnew.store, n)))
    assert tnew.opt["bbox_opt"].count == 1


def test_step_densification_stats_match_jax(both):
    # STEP is past stop_split_at, where the stats stand still; the same
    # step below it accumulates them.
    for part in ("background", "objects"):
        for k in ("xys_grad_norm", "vis_counts", "max_2dsize"):
            np.testing.assert_array_equal(
                getattr(getattr(both["tnew"].store, part), k).numpy(),
                np.asarray(getattr(getattr(both["jnew"].store, part), k)))
    early = dataclasses.replace(both["tstate"], step=700)
    tnew, _ = tsts.scene_train_step(
        early, both["tracks"], both["cam"], both["batch"], both["cfg"],
        both["rcfg"], subset_accs=False)
    st = tnew.store
    n_vis = 0
    for part in (st.background, st.objects):
        assert bool(((part.vis_counts == 1) == (part.max_2dsize > 0)).all())
        assert not part.vis_counts[~part.active].any()
        assert bool((part.xys_grad_norm[part.vis_counts == 0] == 0).all())
        n_vis += int(part.vis_counts.sum())
    assert n_vis > 50
    assert float(st.background.xys_grad_norm.max()) > 0


def test_stats_match_jax_update_from_the_same_gradients(both):
    """update_stats on the step's own screen-space gradients against the
    JAX package's on the reference's: counts exact, norms at the gradient
    tolerance."""
    from street_gaussians_ns_tpu.models import refinement as jref
    from street_gaussians_ns_tpu_torch.models import refinement as tref

    cap = both["tstate"].store.background.capacity
    _, _, jg_xys = both["jgrads"]
    rout = tsts.scene_loss_and_grads(
        both["tstate"], both["tracks"], both["cam"], both["batch"],
        both["cfg"], both["rcfg"], subset_accs=False,
        jitter=torch.zeros((2, H, W)))[3]
    radii = rout.projected.radii[:cap]
    want = jref.update_stats(
        both["jstate"].store.background, jg_xys[:cap],
        jnp.asarray(radii.numpy()), 64, jnp.int32(700),
        both["jstate"].store.background and jsg.SceneGraphConfig().background)
    got = tref.update_stats(both["tstate"].store.background,
                            both["tgrads"]["xys"][:cap], radii, 64, 700,
                            both["cfg"].background)
    np.testing.assert_array_equal(got.vis_counts.numpy(),
                                  np.asarray(want.vis_counts))
    np.testing.assert_array_equal(got.max_2dsize.numpy(),
                                  np.asarray(want.max_2dsize))
    top = float(np.abs(np.asarray(jg_xys)).max())
    np.testing.assert_allclose(got.xys_grad_norm.numpy(),
                               np.asarray(want.xys_grad_norm), rtol=0,
                               atol=2 * GRAD_TOL * top)
    assert float(got.xys_grad_norm.max()) > 0


def test_camera_optimizer_raises(both):
    cfg = dataclasses.replace(both["cfg"], camera_opt_mode="SE3")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsts.scene_train_step(both["tstate"], both["tracks"], both["cam"],
                              both["batch"], cfg, both["rcfg"])


def test_step_draws_its_own_jitter(both):
    """Without a jitter argument the step draws one from the state's
    generator: two steps from one state differ only through the sky."""
    args = (both["tracks"], both["cam"], both["batch"], both["cfg"],
            both["rcfg"])
    _, m1 = tsts.scene_train_step(both["tstate"], *args, subset_accs=False)
    _, m2 = tsts.scene_train_step(both["tstate"], *args, subset_accs=False)
    assert float(m1["loss"]) != float(m2["loss"])
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-2)
    assert float(m1["sky_accumulation"]) == float(m2["sky_accumulation"])
    assert "object_acc_entropy_loss" not in m1


# ---------------------------------------------------------------------------
# The train-state checkpoint carry.
# ---------------------------------------------------------------------------

def test_train_state_round_trips_a_jax_checkpoint(both, tmp_path):
    jnew = both["jnew"]
    path = jckpt.save_checkpoint(tmp_path, STEP + 1, jnew)
    loaded = tckpt.load_train_checkpoint(path, both["cfg"], device="cpu",
                                         seed=3)
    assert loaded.step == STEP + 1 and loaded.camera_opt is None
    assert loaded.generator.initial_seed() == 3
    back = tckpt.state_to_numpy(loaded)
    want = store_arrays(jnew)
    assert set(back) == set(want) - {"rng"}
    for k, v in back.items():
        assert v.shape == want[k].shape and v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert set(loaded.opt) == set(GAUSSIAN_GROUPS) | {"sky_sphere",
                                                      "bbox_opt"}
    assert loaded.opt["means"].count == 1
    # A state without optimizer arrays starts from zero moments.
    fresh = tckpt.train_state_from_numpy(
        {k: v for k, v in want.items() if k.startswith("store/")},
        both["cfg"], device="cpu")
    assert fresh.step == 0 and fresh.opt["scales"].count == 0
    assert not fresh.opt["scales"].mu["bg"].any()
    bad = dict(want)
    bad["opt/means/mu/bg"] = want["opt/means/mu/bg"][:10]
    with pytest.raises(ValueError, match="opt/means/mu/bg"):
        tckpt.train_state_from_numpy(bad, both["cfg"], device="cpu")

"""The port's adaptive density control (models/refinement.py and
engine/scene_train_step.scene_refine_step) against the JAX package's from
the same store, statistics and split noise, on the CPU.

The noise is drawn with the JAX package's keys and handed to the port.
Held exactly: the active mask, the surgery's keep mask and reset flag,
every info count and the slots the children land in. Parameters at rtol
1e-6, with atol 1e-6 on the children's means (a 3-term rotation sum that
may cancel) and scales (log(exp(s) / 1.6), whose exp and log round
separately); Adam moments after the surgery exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_scene
from street_gaussians_ns_tpu.engine import scene_train_step as jsts
from street_gaussians_ns_tpu.models import gaussians as jgauss
from street_gaussians_ns_tpu.models import refinement as jref
from street_gaussians_ns_tpu.models.splatfacto import (
    SplatfactoConfig as JConfig)
from street_gaussians_ns_tpu_torch.engine import checkpoints as tckpt
from street_gaussians_ns_tpu_torch.engine import scene_train_step as tsts
from street_gaussians_ns_tpu_torch.models import gaussians as tgauss
from street_gaussians_ns_tpu_torch.models import refinement as tref
from street_gaussians_ns_tpu_torch.models.splatfacto import SplatfactoConfig

from test_torch_scene_graph import port_config, store_arrays


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


PARAMS = ("means", "scales", "quats", "features_dc", "features_rest",
          "opacities")
STATS = ("xys_grad_norm", "vis_counts", "max_2dsize")


def _store_np(seed, cap, n_active):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    q = rng.standard_normal((cap, 4)).astype(f32)
    active = np.zeros(cap, bool)
    active[rng.permutation(cap)[:n_active]] = True
    vis = rng.integers(0, 6, cap).astype(f32)
    return {
        "params/means": rng.standard_normal((cap, 3)).astype(f32),
        # log scales around the 0.01 split and the 0.5 cull thresholds
        "params/scales": (rng.standard_normal((cap, 3)) * 1.5 - 3.5
                          ).astype(f32),
        "params/quats": q / np.linalg.norm(q, axis=1, keepdims=True),
        "params/features_dc": rng.standard_normal((cap, 1, 3)).astype(f32),
        "params/features_rest": rng.standard_normal((cap, 3, 3)).astype(f32),
        "params/opacities": (rng.standard_normal((cap, 1)) * 2.0
                             ).astype(f32),
        "active": active,
        "xys_grad_norm": (vis * 10.0 ** rng.uniform(-6, -3, cap)
                          ).astype(f32),
        "vis_counts": vis,
        "max_2dsize": (rng.random(cap) * 0.2).astype(f32),
    }


def _jax_store(a):
    return jgauss.GaussianStore(
        params=jgauss.GaussianParams(**{
            k: jnp.asarray(a[f"params/{k}"]) for k in PARAMS}),
        active=jnp.asarray(a["active"]),
        **{k: jnp.asarray(a[k]) for k in STATS})


def _torch_store(a):
    return tgauss.GaussianStore(
        params=tgauss.GaussianParams(**{
            k: T(a[f"params/{k}"]) for k in PARAMS}),
        active=T(a["active"]), **{k: T(a[k]) for k in STATS})


def _assert_store_close(got, want, msg=""):
    np.testing.assert_array_equal(got.active.numpy(),
                                  np.asarray(want.active), err_msg=msg)
    for k in PARAMS:
        np.testing.assert_allclose(
            getattr(got.params, k).numpy(),
            np.asarray(getattr(want.params, k)), rtol=1e-6,
            atol=1e-6 if k in ("means", "scales") else 0, err_msg=f"{msg} {k}")
    for k in STATS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=f"{msg} {k}")


# step -> what the schedule does there (refine_every 100, reset interval
# 3000, 3 train images, warmup 500, stop_split_at 15000).
CASES = [
    (100, 600, 400, "warmup"),
    (600, 600, 400, "densify"),
    (3600, 600, 400, "densify+bigcull"),
    (3600, 300, 290, "densify, slots run out"),
    (3100, 600, 400, "opacity reset"),
    (15000, 600, 400, "final cull"),
    (15100, 600, 400, "idle"),
    (4000, 600, 400, "past stop_screen_size_at"),
]


@pytest.mark.parametrize("step,cap,n_active,what", CASES)
def test_refine_matches_jax(step, cap, n_active, what):
    a = _store_np(step + cap, cap, n_active)
    jcfg, tcfg = JConfig(), SplatfactoConfig()
    key = jax.random.PRNGKey(step)
    capp = tref.parent_budget(tcfg, cap)
    assert capp == min(cap, max(256, cap // 16))
    noise = np.asarray(jax.random.normal(jax.random.split(key, 1)[0],
                                         (2, capp, 3), jnp.float32))
    want, jsur, jinfo = jax.jit(
        jref.refine, static_argnames=("config", "num_train_data"))(
        _jax_store(a), jnp.int32(step), config=jcfg, num_train_data=3,
        max_hw=jnp.int32(64), rng=key)
    before = _torch_store(a)
    got, tsur, tinfo = tref.refine(before, step, tcfg, 3, 64, T(noise))

    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        assert int(tinfo[k]) == int(jinfo[k]), f"{what}: {k}"
    np.testing.assert_array_equal(tsur["keep"].numpy(),
                                  np.asarray(jsur["keep"]))
    assert tsur["reset_opacities"] == bool(jsur["reset_opacities"])
    _assert_store_close(got, want, what)
    # The store handed in is untouched.
    _assert_store_close(before, _jax_store(a), "input")

    if what.startswith("densify"):
        assert int(tinfo["refine_splits_count"]) > 0
        assert int(tinfo["refine_dups_count"]) > 0
        assert int((got.active & ~before.active).sum()) > 0
    if what == "densify, slots run out":
        assert int(tinfo["children_dropped"]) > 0
    if what in ("warmup", "idle", "opacity reset"):
        assert torch.equal(got.active, before.active)
    if what == "opacity reset":
        assert tsur["reset_opacities"]
        assert float(got.params.opacities.max()) <= np.log(0.2 / 0.8) + 1e-6
    if what == "final cull":
        assert int(tinfo["refine_culls_count"]) > 0
        assert int(tinfo["refine_splits_count"]) == 0
    if what == "warmup":
        assert float(got.vis_counts.sum()) > 0      # stats keep accumulating


def test_refine_rejects_wrong_noise_shape():
    a = _store_np(0, 300, 100)
    with pytest.raises(ValueError, match="noise"):
        tref.refine(_torch_store(a), 600, SplatfactoConfig(), 3, 64,
                    torch.zeros((2, 10, 3)))
    g = torch.Generator().manual_seed(0)
    noise = tref.draw_split_noise(SplatfactoConfig(), 300, g, "cpu")
    assert tuple(noise.shape) == (2, 256, 3)
    assert abs(float(noise.mean())) < 0.2 and 0.8 < float(noise.std()) < 1.2


@pytest.mark.parametrize("step", [600, 15000])
def test_update_stats_matches_jax(step):
    a = _store_np(1, 200, 150)
    rng = np.random.default_rng(step)
    g = (rng.standard_normal((200, 2)) * 1e-3).astype(np.float32)
    radii = rng.integers(0, 30, 200).astype(np.int32)
    want = jref.update_stats(_jax_store(a), jnp.asarray(g),
                             jnp.asarray(radii), 64, jnp.int32(step),
                             JConfig())
    got = tref.update_stats(_torch_store(a), T(g), T(radii), 64, step,
                            SplatfactoConfig())
    for k in STATS:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-6,
                                   err_msg=k)
    changed = not np.array_equal(got.vis_counts.numpy(), a["vis_counts"])
    assert changed == (step < 15000)
    z = tgauss.zeros_stats(5, device="cpu")
    assert len(z) == 3 and all(not t.any() and t.shape == (5,) for t in z)


# ---------------------------------------------------------------------------
# scene_refine_step: background + objects + Adam moment surgery.
# ---------------------------------------------------------------------------

def _jax_train_state(step, seed=0):
    jcfg, store, tracks = _tiny_scene()
    rng = np.random.default_rng(seed)

    def with_stats(part):
        shape = part.active.shape
        vis = rng.integers(0, 6, shape).astype(np.float32)
        return dataclasses.replace(
            part,
            xys_grad_norm=jnp.asarray(
                vis * 10.0 ** rng.uniform(-6, -3, shape), jnp.float32),
            vis_counts=jnp.asarray(vis),
            max_2dsize=jnp.asarray(rng.random(shape) * 0.2, jnp.float32),
            params=dataclasses.replace(
                part.params,
                scales=jnp.asarray(rng.standard_normal(
                    part.params.scales.shape) * 1.5 - 3.5, jnp.float32),
                opacities=jnp.asarray(rng.standard_normal(
                    part.params.opacities.shape) * 2.0, jnp.float32)))

    store = dataclasses.replace(store,
                                background=with_stats(store.background),
                                objects=with_stats(store.objects))
    state = jsts.init_scene_train_state(store, jax.random.PRNGKey(3))
    opt = jax.tree.map(
        lambda x: (jnp.asarray(rng.random(x.shape), jnp.float32)
                   if x.ndim else jnp.int32(4)), state.opt)
    return jcfg, dataclasses.replace(state, opt=opt,
                                     step=jnp.int32(step + 1))


@pytest.mark.parametrize("step", [600, 3100])
def test_scene_refine_step_matches_jax(step):
    jcfg, jstate = _jax_train_state(step)
    cfg = port_config(jcfg)
    want, jinfo = jax.jit(
        jsts.scene_refine_step,
        static_argnames=("config", "num_train_data"))(
        jstate, config=jcfg, num_train_data=3, max_hw=jnp.int32(64))
    _, k_bg, k_obj = jax.random.split(jstate.rng, 3)

    def noise_of(key, cap, sub):
        return np.asarray(jax.random.normal(
            jax.random.split(key, 1)[0],
            (2, tref.parent_budget(sub, cap), 3), jnp.float32))

    n_obj = jstate.store.num_objects
    noise = {"bg": T(noise_of(k_bg, 512, cfg.background)),
             "obj": T(np.stack([noise_of(k, 64, cfg.object_template)
                                for k in jax.random.split(k_obj, n_obj)]))}
    tstate = tckpt.train_state_from_numpy(store_arrays(jstate), cfg,
                                          device="cpu")
    assert tstate.step == step + 1
    got, tinfo = tsts.scene_refine_step(tstate, cfg, 3, 64, noise=noise)

    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        assert int(tinfo[k]) == int(jinfo[k]), k
    _assert_store_close(got.store.background, want.store.background, "bg")
    _assert_store_close(got.store.objects, want.store.objects, "obj")
    assert got.step == step + 1
    for name in want.opt:
        for kind in ("mu", "nu"):
            w, g = getattr(want.opt[name], kind), getattr(got.opt[name], kind)
            for k in (w if isinstance(w, dict) else [None]):
                np.testing.assert_array_equal(
                    (g[k] if k else g).numpy(),
                    np.asarray(w[k] if k else w), err_msg=f"{name}/{kind}")
        assert got.opt[name].count == int(want.opt[name].count) == 4
    if step == 600:
        assert int(tinfo["bg_refine_splits_count"]) > 0
        assert int(tinfo["obj_refine_splits_count"]) > 0
        assert not got.opt["means"].mu["bg"][
            got.store.background.active
            & ~tstate.store.background.active].any()
    else:
        assert not got.opt["opacities"].mu["obj"].any()
        assert got.opt["means"].mu["obj"].any()

    # Drawing the noise from the state's generator: same counts of work,
    # other children.
    drawn = tsts.draw_refine_noise(tstate, cfg)
    assert drawn["bg"].shape == noise["bg"].shape
    assert drawn["obj"].shape == noise["obj"].shape
    again, info2 = tsts.scene_refine_step(tstate, cfg, 3, 64)
    assert int(info2["bg_refine_splits_count"]) == \
        int(tinfo["bg_refine_splits_count"])

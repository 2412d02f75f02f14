"""The port's per-group Adam (engine/optimizers.py) against the JAX
package's on identical gradients, on the CPU.

Tolerances: the schedule at rtol 1e-6; the step of one Adam update from
zero moments at 1e-6 of lr (with eps 1e-15 the first step is lr sign(g) in
both); the steps after it at 2e-5 of lr, because the bias corrections 1 - b^count are
differences of nearly equal float32 numbers and the two packages' float32
pow may differ in the last bit (one ulp of 0.999^3 is 2e-5 of 1 - 0.999^3).
Moments are held at rtol 1e-6 throughout."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.engine import optimizers as jopt
from street_gaussians_ns_tpu_torch.engine import optimizers as topt
from street_gaussians_ns_tpu_torch.engine.train_step import GAUSSIAN_GROUPS


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


def test_default_groups_and_schedule_match_jax():
    assert set(topt.DEFAULT_GROUPS) == set(jopt.DEFAULT_GROUPS)
    assert len(topt.DEFAULT_GROUPS) == 9
    assert set(GAUSSIAN_GROUPS) <= set(topt.DEFAULT_GROUPS)
    for name, jc in jopt.DEFAULT_GROUPS.items():
        tc = topt.DEFAULT_GROUPS[name]
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
        for step in (0, 1, 999, 35000, 70000, 90000):
            np.testing.assert_allclose(
                topt.schedule(tc, step),
                float(jopt.schedule(jc, jnp.int32(step))), rtol=1e-6,
                err_msg=f"{name} at {step}")
    assert topt.schedule(topt.DEFAULT_GROUPS["means"], 70000) == \
        pytest.approx(1.6e-6, rel=1e-5)


def _trees(seed, n=40):
    rng = np.random.default_rng(seed)
    shapes = {"bg": (n, 3), "obj": (2, n // 2, 3)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    gs = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1, s)
               ).astype(np.float32) for k, s in shapes.items()}
          for _ in range(4)]
    return p, gs


def _assert_tree_close(got, want, rtol, msg):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=rtol, atol=0, err_msg=f"{msg}/{k}")


@pytest.mark.parametrize("name", ["means", "opacities"])
def test_adam_update_matches_jax(name):
    cfg_j, cfg_t = jopt.DEFAULT_GROUPS[name], topt.DEFAULT_GROUPS[name]
    p0, gs = _trees(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: T(v) for k, v in p0.items()}
    js, ts = jopt.init_adam(jp), topt.init_adam(tp)
    for i, g in enumerate(gs):
        step = 100 * i
        jp, js = jopt.adam_update({k: jnp.asarray(v) for k, v in g.items()},
                                  js, jp, jopt.schedule(cfg_j,
                                                        jnp.int32(step)),
                                  cfg_j)
        tp_old = tp
        tp, ts = topt.adam_update({k: T(v) for k, v in g.items()}, ts, tp,
                                  topt.schedule(cfg_t, step), cfg_t)
        assert ts.count == int(js.count) == i + 1
        _assert_tree_close(ts.mu, js.mu, 1e-6, f"mu step {i}")
        _assert_tree_close(ts.nu, js.nu, 1e-6, f"nu step {i}")
        # The parameter is old - step: hold it at its own rounding (rtol
        # 1e-6) plus the step's tolerance (1e-6 of lr at the first step,
        # 2e-5 of lr later, see the module docstring).
        lr = topt.schedule(cfg_t, step)
        for k in tp:
            np.testing.assert_allclose(
                tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                atol=(1e-6 if i == 0 else 2e-5) * lr)
            if i == 0:
                d = (tp[k] - tp_old[k]).numpy()
                np.testing.assert_allclose(np.abs(d), lr, rtol=1e-3)
        assert tp_old["bg"] is not tp["bg"]          # functional


def test_adam_update_is_sign_step_first():
    cfg = topt.AdamConfig(lr=0.5)
    p = torch.zeros(4)
    g = torch.tensor([1e-12, -1e-12, 3.0, 0.0])
    new_p, s = topt.adam_update(g, topt.init_adam(p), p, 0.5, cfg)
    np.testing.assert_allclose(new_p.numpy(), [-0.5, 0.5, -0.5, 0.0],
                               rtol=2e-3)      # eps is 1e-3 of 1e-12
    assert s.count == 1 and s.acc is None and s.calls is None


def test_adam_update_with_accumulation_matches_jax():
    cfg_j = jopt.AdamConfig(lr=1e-3, accum_steps=3)
    cfg_t = topt.AdamConfig(lr=1e-3, accum_steps=3)
    p0, gs = _trees(1)
    p0, gs = p0["bg"], [g["bg"] for g in gs] * 2
    jp, tp = jnp.asarray(p0), T(p0)
    js = jopt.init_adam(jp, accum_steps=3)
    ts = topt.init_adam(tp, accum_steps=3)
    assert ts.calls == 0 and not ts.acc.any()
    for i, g in enumerate(gs[:7]):
        jp, js = jopt.adam_update(jnp.asarray(g), js, jp, jnp.float32(1e-3),
                                  cfg_j)
        tp, ts = topt.adam_update(T(g), ts, tp, 1e-3, cfg_t)
        assert ts.calls == int(js.calls) == i + 1
        assert ts.count == int(js.count) == (i + 1) // 3
        np.testing.assert_allclose(ts.acc.numpy(), np.asarray(js.acc),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(ts.mu.numpy(), np.asarray(js.mu),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(ts.nu.numpy(), np.asarray(js.nu),
                                   rtol=1e-6, atol=1e-20)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=2e-5 * 1e-3)
    assert not np.array_equal(tp.numpy(), p0)


def test_mask_moments_matches_jax():
    rng = np.random.default_rng(2)
    mu = {"bg": rng.standard_normal((30, 4, 3)).astype(np.float32)}
    nu = {"bg": rng.random((30, 4, 3)).astype(np.float32)}
    keep = rng.random(30) > 0.4
    js = jopt.mask_moments(jopt.AdamState(
        mu={"bg": jnp.asarray(mu["bg"])}, nu={"bg": jnp.asarray(nu["bg"])},
        count=jnp.int32(5)), jnp.asarray(keep))
    ts = topt.mask_moments(topt.AdamState(
        mu={"bg": T(mu["bg"])}, nu={"bg": T(nu["bg"])}, count=5), T(keep))
    np.testing.assert_array_equal(ts.mu["bg"].numpy(), np.asarray(js.mu["bg"]))
    np.testing.assert_array_equal(ts.nu["bg"].numpy(), np.asarray(js.nu["bg"]))
    assert ts.count == 5 and not ts.mu["bg"][~T(keep)].any()
    # A leading object axis: keep (O, CAP) over moments (O, CAP, ...).
    keep2 = rng.random((2, 15)) > 0.5
    m = topt.mask_moments(topt.AdamState(
        mu=T(mu["bg"]).reshape(2, 15, 4, 3), nu=T(nu["bg"]).reshape(
            2, 15, 4, 3), count=1), T(keep2))
    assert not m.mu[~T(keep2)].any() and m.mu[T(keep2)].all()


# ---------------------------------------------------------------------------
# One pass over every group (adam_step, scene_adam) against the per-group
# adam_update loop after mask_inactive_grads that it replaced.
# ---------------------------------------------------------------------------

def _rand_like(rng, t, scale=1.0, positive=False):
    x = rng.standard_normal(tuple(t.shape)).astype(np.float32) * scale
    return torch.from_numpy(np.abs(x) if positive else x)


def _poison(rng, g, active):
    """g with NaN, +inf and -inf in some inactive rows: what a degenerate
    slot's gradient may hold, which the mask must stop."""
    g = g.clone()
    rows = (~active).nonzero()
    for i, r in enumerate(rows[: 3 * (len(rows) // 3)]):
        g[tuple(r)] = (float("nan"), float("inf"), -float("inf"))[i % 3]
    return g


def _scene_case(seed, count, bbox=True, sky=True, camera_calls=None,
                n_obj=2):
    """A small scene-graph store with inactive rows, random moments at
    step `count`, and gradients (poisoned in inactive rows) for every
    group the state holds."""
    import chip_smoke as cs
    from street_gaussians_ns_tpu_torch.engine import scene_train_step as sts
    from street_gaussians_ns_tpu_torch.engine.checkpoints import \
        store_from_numpy
    rng = np.random.default_rng(seed)
    store_np, _ = cs.make_scene(seed, 96, n_obj, 40, 8)
    store = store_from_numpy(store_np, cs.scene_config(3, 8, 5),
                             device="cpu")
    bg = dataclasses.replace(store.background, active=torch.from_numpy(
        rng.random(store.background.active.shape) > 0.25))
    obj = dataclasses.replace(store.objects, active=torch.from_numpy(
        rng.random(store.objects.active.shape) > 0.25))
    store = dataclasses.replace(store, background=bg, objects=obj)
    if not sky:
        store = dataclasses.replace(store, env_map=None)
    cam = (_rand_like(rng, torch.zeros(3, 6), 0.01)
           if camera_calls is not None else None)
    state = sts.init_scene_train_state(store, torch.Generator(), cam)
    opt = {}
    for name, s in state.opt.items():
        if name == "bbox_opt" and not bbox:
            continue
        mu = topt.tree_map(lambda x: _rand_like(rng, x, 1e-3), s.mu)
        nu = topt.tree_map(lambda x: _rand_like(rng, x, 1e-5, True), s.nu)
        extra = {}
        if s.acc is not None:
            extra = dict(acc=topt.tree_map(lambda x: _rand_like(rng, x),
                                           s.acc), calls=camera_calls)
        opt[name] = topt.AdamState(mu=mu, nu=nu, count=count, **extra)
    g_gauss = {}
    for name in GAUSSIAN_GROUPS:
        p = sts._gaussian_group_params(store, name)
        g_gauss[name] = {
            "bg": _poison(rng, _rand_like(rng, p["bg"], 0.1), bg.active),
            "obj": _poison(rng, _rand_like(rng, p["obj"], 0.1), obj.active)}
    g_env = _rand_like(rng, store.env_map) if sky else None
    g_bbox = topt.tree_map(lambda x: _rand_like(rng, x, 0.1),
                           sts._bbox_params(store))
    g_cam = _rand_like(rng, cam) if cam is not None else None
    return store, opt, g_gauss, g_env, g_bbox, (g_cam, cam)


def _loop_before(store, opt, g_gauss, g_env, g_bbox, step, camera):
    """The scene step's Adam as it was written before the one pass: the
    masked gradient copy, then adam_update group by group."""
    from street_gaussians_ns_tpu_torch.engine import scene_train_step as sts
    g = sts.mask_inactive_grads(g_gauss, store)
    new_opt, params = dict(opt), {}
    for name in GAUSSIAN_GROUPS:
        cfg = topt.DEFAULT_GROUPS[name]
        params[name], new_opt[name] = topt.adam_update(
            g[name], opt[name], sts._gaussian_group_params(store, name),
            topt.schedule(cfg, step), cfg)
    extra = [("sky_sphere", g_env, store.env_map),
             ("bbox_opt", g_bbox, sts._bbox_params(store)),
             ("camera_opt",) + camera]
    for name, grads, p in extra:
        if name in opt and grads is not None:
            cfg = topt.DEFAULT_GROUPS[name]
            params[name], new_opt[name] = topt.adam_update(
                grads, opt[name], p, topt.schedule(cfg, step), cfg)
    return params, new_opt


def _assert_same_tree(got, want, where):
    a_leaves, b_leaves = topt._leaves(got), topt._leaves(want)
    assert len(a_leaves) == len(b_leaves), where
    for a, b in zip(a_leaves, b_leaves):
        assert torch.equal(a, b), where


def _assert_same_state(got, want, where):
    assert got.count == want.count and got.calls == want.calls, where
    for field in ("mu", "nu", "acc"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), (where, field)
        if a is not None:
            _assert_same_tree(a, b, (where, field))


@pytest.mark.parametrize("case", [
    "scene", "scene_count_3601", "camera_steps", "camera_accumulates",
    "sharded_shard", "no_bbox_no_sky", "no_objects"])
def test_scene_adam_equals_the_group_loop(case):
    """`scene_adam` (the scene-graph and sharded steps' one pass) gives the
    bits of the loop it replaced on the CPU: every group's parameters,
    moments, counts and the camera group's accumulation; inactive rows'
    NaN and inf gradients reach nothing."""
    from street_gaussians_ns_tpu_torch.engine import scene_train_step as sts
    from street_gaussians_ns_tpu_torch.utils import profiling
    kw = {"scene": {}, "scene_count_3601": dict(count=3600),
          "camera_steps": dict(camera_calls=99),
          "camera_accumulates": dict(camera_calls=41),
          "sharded_shard": dict(seed=5, count=7),
          "no_bbox_no_sky": dict(bbox=False, sky=False),
          "no_objects": dict(n_obj=0)}[case]
    seed, count = kw.pop("seed", 3), kw.pop("count", 0)
    store, opt, g_gauss, g_env, g_bbox, camera = _scene_case(seed, count,
                                                             **kw)
    step = 3600 + count
    profiling.reset()
    profiling.enable(True)
    try:
        new_store, new_opt, new_cam = sts.scene_adam(
            store, opt, g_gauss, g_env, g_bbox, step,
            camera if case != "sharded_shard" else (None, None))
    finally:
        profiling.enable(False)
    leaves = profiling.snapshot()["step.adam_leaves"]["total"]
    profiling.reset()
    if case == "sharded_shard":
        camera = (None, None)
    params, want_opt = _loop_before(store, opt, g_gauss, g_env, g_bbox,
                                    step, camera)
    assert set(new_opt) == set(want_opt) == set(opt)
    for name in GAUSSIAN_GROUPS:
        new = sts._gaussian_group_params(new_store, name)
        _assert_same_tree(new, params[name], name)
        old = sts._gaussian_group_params(store, name)
        assert new["bg"] is not old["bg"] and new["obj"] is not old["obj"]
    if "sky_sphere" in opt:
        _assert_same_tree(new_store.env_map, params["sky_sphere"], "sky")
    if "bbox_opt" in opt:
        _assert_same_tree(sts._bbox_params(new_store), params["bbox_opt"],
                          "bbox")
    if camera[0] is not None:
        assert torch.equal(new_cam, params["camera_opt"])
    else:
        assert new_cam is camera[1]
    for name in opt:
        _assert_same_state(new_opt[name], want_opt[name], name)
    for t in topt._leaves(new_store.background.params.as_dict()) + \
            topt._leaves(new_store.objects.params.as_dict()):
        assert bool(torch.isfinite(t).all())
    stepping = 12 + ("sky_sphere" in opt) + 3 * ("bbox_opt" in opt) + (
        case == "camera_steps")
    assert leaves == stepping
    if case == "camera_accumulates":
        assert new_opt["camera_opt"].calls == 42
        assert new_cam is camera[1]


def test_adam_step_equals_the_splatfacto_loop():
    """Splatfacto's group set (6 single-tensor groups and the sky, no
    mask) through one adam_step, against adam_update group by group."""
    rng = np.random.default_rng(11)
    shapes = {"means": (50, 3), "scales": (50, 3), "quats": (50, 4),
              "features_dc": (50, 1, 3), "features_rest": (50, 15, 3),
              "opacities": (50, 1), "sky_sphere": (6, 4, 4, 3)}
    groups, want = {}, {}
    for name, shape in shapes.items():
        cfg = topt.DEFAULT_GROUPS[name]
        p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        g = _rand_like(rng, p, 0.1)
        s = topt.AdamState(mu=_rand_like(rng, p, 1e-3),
                           nu=_rand_like(rng, p, 1e-5, True), count=5)
        lr = topt.schedule(cfg, 3605)
        groups[name] = topt.AdamGroup(g, s, p, lr, cfg)
        want[name] = topt.adam_update(g, s, p, lr, cfg)
    got = topt.adam_step(groups)
    assert list(got) == list(shapes)
    for name in shapes:
        _assert_same_tree(got[name][0], want[name][0], name)
        _assert_same_state(got[name][1], want[name][1], name)


def test_mask_rows_is_the_where_it_replaced():
    """mask_rows gives +0.0 (not -0.0, not NaN) in inactive rows of a leaf
    whose mask leads one or two of its axes, and g itself without a
    mask."""
    g = torch.tensor([[-0.0, float("nan")], [1.5, -2.0], [float("inf"),
                                                         3.0]])
    act = torch.tensor([False, True, False])
    out = topt.mask_rows(g, act)
    assert torch.equal(out[1], g[1])
    assert not out[[0, 2]].any() and not torch.signbit(out[[0, 2]]).any()
    assert topt.mask_rows(g, None) is g
    g3 = torch.full((2, 3, 4), float("nan"))
    a2 = torch.tensor([[True, False, True], [False, False, True]])
    out = topt.mask_rows(g3, a2)
    assert bool(out[a2].isnan().all()) and not out[~a2].any()

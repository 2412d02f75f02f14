"""The port's training loop (engine/trainer.Trainer.train) through the
whole compressed schedule against the JAX trainer's, on the CPU.

Setup: tests/test_data.write_clip's clip at tests/test_integration.
small_configs' schedule (warmup 5, a refine every 10 steps, an opacity
reset every 3 refines, stop_split_at 50), with sh_degree_interval 15 and
stop_screen_size_at 35 on base, background and object template, 56 steps.
The background store holds 128 slots for 50 seeds, so the first densify
runs out of slots and leaves split parents without children; the object
store holds 4,096 of the vehicle's 12,000 LiDAR points, full from the
start. max_pairs starts at 12,288 without the pre-size probe (max_rowruns
16,384), so the capacity check at step 10 doubles it before any render
overflows. The JAX trainer renders with impl="chunked" at max_per_tile
2048 (the densest tile holds 1,812 pairs: nothing is truncated), the port
with its fused route (the kernels' plain versions). Both start from the
JAX trainer's first state; the port gets the JAX key chain's sky jitter at
every step and split noise at every refine (`JaxDraws`) and draws the
same frames.

The refine cadence. The JAX loop refines after step s when (s + 1) %
refine_every == 0, at step s, so s % reset_interval never equals
refine_every and its opacity reset never fires (a defect of the reference,
held by `test_jax_loop_never_resets_opacities`). The port refines after
step s when s % refine_every == 0, at step s, as the reference's callback
does. The JAX run here is `Trainer.train` itself with its refine moved to
that cadence (`ReferenceCadence`): the refine it asks for after step s
runs after step s + 1, and one runs after step 0.

Held, with these tolerances:
1. The event trace, exactly: per step the frame, the renders (3 past
   stop_split_at, else 1), whether features_rest has a moment (the SH
   ramp), whether a refine ran, whether it densified (found split or dup
   candidates), culled, reset the opacities (that group's moments all zero) or ran the
   final cull; each capacity growth with its step and its capacities. The
   trace is also held to the steps the config gives.
2. Forced steps (every event step): the JAX run's state before the step
   loaded into the port, one loop iteration (`Trainer._iteration`) from
   the same frame, draws, capacities and running maximum. The step: loss
   and metrics at atol 2e-5 / rtol 1e-5; Adam moments as tests/
   test_torch_train_step.py holds them (the gradient tolerance 2e-5 of the
   group's largest |g|, g read back from the JAX moments); parameters at
   rtol 1e-6 / atol 1e-3 lr beyond what the Adam ratio makes of the two
   packages' moments (at a first step, the tolerances of
   test_run_step_matches_jax); visibility counts and screen sizes exactly.
   The refine, run by the port on the JAX run's stepped state: counts,
   masks, the slots children land in, statistics and moments exactly,
   parameters at rtol 1e-6 / atol 1e-6 (tests/test_torch_refinement.py).
   The capacities after the check exactly.
3. Free-running: the gaussian counts after every refine and the loss of
   every step, at the tolerances FREE_COUNT_RTOL and FREE_LOSS_RTOL below
   (measured: the counts differ by at most one gaussian, 6.7e-4 relative,
   and the losses by at most 1.4e-4 relative, once one borderline
   gaussian's cull at step 20 went the other way); every group and every moment finite at every refine and at
   the end in both runs.

And the port's counterpart of tests/test_train.py::
test_inactive_zero_rows_never_poison_state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.engine import trainer as jtrainer
from street_gaussians_ns_tpu.models import refinement as jref
from street_gaussians_ns_tpu_torch.core.cameras import Camera as TCamera
from street_gaussians_ns_tpu_torch.engine import checkpoints as tckpt
from street_gaussians_ns_tpu_torch.engine import optimizers as topt
from street_gaussians_ns_tpu_torch.engine import scene_train_step as tsts
from street_gaussians_ns_tpu_torch.engine import setup as tsetup
from street_gaussians_ns_tpu_torch.engine import trainer as ttrainer
from street_gaussians_ns_tpu_torch.models import refinement as tref
from street_gaussians_ns_tpu_torch.ops.render import RenderConfig

from test_data import write_clip
from test_integration import small_configs
from test_torch_scene_graph import port_config, store_arrays

STEPS = 56
SCHEDULE = dict(sh_degree_interval=15, stop_screen_size_at=35)
MAX_PAIRS = 13312          # the vehicle's views: 12,993-13,060 pairs
MAX_ROWRUNS = 16384
MAX_PER_TILE = 2048        # the JAX chunked compositor's tile budget
# Event steps of the schedule above (3 train frames): refine after every
# 10th step; opacity reset at 10 and 40 (s % 30 == 10); densify at 20
# (s % 30 > 13); the final cull at 50; the SH degree steps up at 15; three
# renders a step past 50; the capacity check at 10 sees the vehicle.
REFINES = (0, 10, 20, 30, 40, 50)
RESETS = (10, 40)
DENSIFY = (20,)
FINAL_CULL = (50,)
FORCED = (10, 15, 20, 40, 50, 51)
GRAD_TOL = 2e-5            # of the group's largest |g|
FREE_COUNT_RTOL = 2e-3     # gaussian counts after each refine
FREE_LOSS_RTOL = 5e-4      # every step's loss


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


class JaxDraws:
    """The JAX trainer's draws for the port: scene_train_step takes the
    sky jitter from `rng, k_sky = split(rng)`, scene_refine_step the split
    noise from `rng, k_bg, k_obj = split(rng, 3)`. Stands in for
    engine/scene_train_step's draw_pixel_jitter and draw_refine_noise."""

    def __init__(self, key):
        self.key = jnp.asarray(key)

    def jitter(self, camera, generator):
        self.key, k_sky = jax.random.split(self.key)
        return T(jax.random.uniform(k_sky, (2, camera.height, camera.width)))

    def refine_noise(self, state, config):
        self.key, k_bg, k_obj = jax.random.split(self.key, 3)
        store = state.store

        def normal(key, sub, cap):
            return np.asarray(jax.random.normal(
                jax.random.split(key, 1)[0],
                (sub.n_split_samples, tref.parent_budget(sub, cap), 3),
                jnp.float32))

        obj = [normal(k, config.object_template, store.objects.capacity)
               for k in jax.random.split(k_obj, store.num_objects)]
        return {"bg": T(normal(k_bg, config.background,
                               store.background.capacity)),
                "obj": T(np.stack(obj)) if obj else None}

    def patch(self, mp):
        mp.setattr(tsts, "draw_pixel_jitter", self.jitter)
        mp.setattr(tsts, "draw_refine_noise", self.refine_noise)


def schedule_configs(clip, out):
    data, model, trainer, dm = small_configs(clip, out)
    model = dataclasses.replace(model, **{
        name: dataclasses.replace(getattr(model, name), **SCHEDULE)
        for name in ("base", "background", "object_template")})
    trainer = dataclasses.replace(
        trainer, max_num_iterations=STEPS, steps_per_eval_image=10 ** 6,
        steps_per_save=10 ** 6, background_capacity=128,
        object_capacity=4096, presize_pairs=False, max_pairs=MAX_PAIRS)
    return data, model, trainer, dm


def _opacity_moments_zero(arrays: dict) -> bool:
    """Whether the opacities group's moments are all zero (a reset)."""
    return not any(arrays[f"opt/opacities/{m}/{k}"].any()
                   for m in ("mu", "nu") for k in ("bg", "obj"))


def _all_finite(arrays: dict) -> bool:
    return all(np.isfinite(v).all() for k, v in arrays.items()
               if np.issubdtype(v.dtype, np.floating))


class Trace:
    """One run's per-step record (the event trace), its refines' counts,
    losses, growths and finiteness."""

    def __init__(self):
        self.rows, self.growth, self.losses, self.pairs = [], [], [], []
        self.counts, self.finite = {}, {}
        self.frame = self.subset = None

    def step_row(self, step, metrics, sh_live):
        self.rows.append({"step": step, "frame": self.frame,
                          "renders": 3 if self.subset else 1,
                          "sh_live": bool(sh_live), "refine": None})
        self.losses.append(float(metrics["loss"]))
        self.pairs.append(int(metrics["num_pairs"]))

    def refine_row(self, step, info, arrays):
        info = {k: int(v) for k, v in info.items()}
        candidates = sum(info[f"{p}_refine_splits_count"]
                         + info[f"{p}_refine_dups_count"]
                         for p in ("bg", "obj"))
        culls = info["bg_refine_culls_count"] + info["obj_refine_culls_count"]
        self.rows[-1]["refine"] = {
            "densify": candidates > 0, "cull": culls > 0,
            "reset": _opacity_moments_zero(arrays),
            "final_cull": culls > 0 and candidates == 0}
        self.counts[step] = info
        self.finite[step] = _all_finite(arrays)


class ReferenceCadence:
    """Instruments a JAX Trainer: its refine runs after step s when
    s % refine_every == 0 (the port's cadence, the reference's), the steps
    the JAX loop asked at are kept in `asks`, and the state around each
    step in `forced` is kept for the forced-step tests."""

    def __init__(self, jt, forced):
        self.jt, self.forced = jt, forced
        self.trace, self.asks, self.snaps = Trace(), [], {}
        self.due = True
        self.orig = {k: getattr(jt, k) for k in (
            "_run_step", "_refine_fn", "_maybe_grow_pairs", "_step_fn")}
        self.next_train = jt.dm.next_train
        jt._run_step, jt._refine_fn = self.run_step, self.ask
        jt._maybe_grow_pairs, jt._step_fn = self.grow, self.step_fn
        jt.dm.next_train = self.frame

    def ask(self, state, max_hw):
        self.asks.append(int(state.step) - 1)
        self.due = True
        return state, {}

    def frame(self, step):
        camera, batch = self.next_train(step)
        self.trace.frame = batch["frame_idx"]
        return camera, batch

    def step_fn(self, height, width, step):
        fn = self.orig["_step_fn"](height, width, step)
        self.trace.subset = next(k[2] for k, v in self.jt._step_fns.items()
                                 if v is fn)
        return fn

    def caps(self):
        rc = self.jt.render_config
        return rc.max_pairs, rc.max_rowruns

    def run_step(self, step):
        jt = self.jt
        self.step = step
        snap = None
        if step in self.forced:
            snap = self.snaps[step] = dict(
                before=store_arrays(jt.state), dm=(jt.dm.rng.get_state(),
                                                   list(jt.dm._train_order)),
                running_max=tuple(None if v is None else int(v) for v in (
                    jt._pair_max, jt._rowrun_max)), caps=self.caps())
        metrics = self.orig["_run_step"](step)
        self.trace.step_row(step, metrics, np.asarray(
            jt.state.opt["features_rest"].mu["bg"]).any() or np.asarray(
            jt.state.opt["features_rest"].mu["obj"]).any())
        if self.due:
            self.due = False
            if snap is not None:
                snap["stepped"] = store_arrays(jt.state)
            jt.state, info = self.orig["_refine_fn"](
                jt.state, max_hw=jnp.float32(max(*jt._last_hw)))
            metrics.update(info)
            self.trace.refine_row(step, info, store_arrays(jt.state))
        if snap is not None:
            snap.update(after=store_arrays(jt.state),
                        metrics={k: float(v) for k, v in metrics.items()
                                 if np.ndim(v) == 0},
                        caps_after=self.caps())
        return metrics

    def grow(self, metrics):
        old = self.caps()
        grew = self.orig["_maybe_grow_pairs"](metrics)
        if grew:
            self.trace.growth.append((self.step, old, self.caps()))
        if self.step in self.snaps:
            self.snaps[self.step]["caps_after"] = self.caps()
        return grew


class PortRecorder:
    """The same record of a port Trainer's run."""

    def __init__(self, tt):
        self.tt, self.trace = tt, Trace()
        self.orig = {k: getattr(tt, k) for k in (
            "_run_step", "_refine", "_maybe_grow_pairs", "_step_fn")}
        self.next_train = tt.dm.next_train
        tt._run_step, tt._refine = self.run_step, self.refine
        tt._maybe_grow_pairs, tt._step_fn = self.grow, self.step_fn
        tt.dm.next_train = self.frame

    def frame(self, step):
        camera, batch = self.next_train(step)
        self.trace.frame = batch["frame_idx"]
        return camera, batch

    def step_fn(self, step):
        fn = self.orig["_step_fn"](step)
        self.trace.subset = fn.keywords["subset_accs"]
        return fn

    def run_step(self, step):
        self.step = step
        metrics = self.orig["_run_step"](step)
        mu = self.tt.state.opt["features_rest"].mu
        self.trace.step_row(step, metrics,
                            bool(mu["bg"].any() or mu["obj"].any()))
        return metrics

    def refine(self, max_hw):
        state, info = self.orig["_refine"](max_hw)
        self.trace.refine_row(self.step, info, tckpt.state_to_numpy(state))
        return state, info

    def caps(self):
        rc = self.tt.render_config
        return rc.max_pairs, rc.max_rowruns

    def grow(self, metrics):
        old = self.caps()
        grew = self.orig["_maybe_grow_pairs"](metrics)
        if grew:
            self.trace.growth.append((self.step, old, self.caps()))
        return grew


def port_trainer(jax_run, out):
    data, model, trainer, dm = tsetup.load_run_config(jax_run)
    tt = ttrainer.Trainer(data, model, dataclasses.replace(
        trainer, output_dir=out), dm, device="cpu")
    tt.render_config = dataclasses.replace(tt.render_config,
                                           max_rowruns=MAX_ROWRUNS)
    return tt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    clip = tmp_path_factory.mktemp("clip")
    write_clip(clip)
    out = tmp_path_factory.mktemp("runs")
    jt = jtrainer.Trainer(*schedule_configs(clip, out / "jax"))
    jt.render_config = dataclasses.replace(
        jt.render_config, max_per_tile=MAX_PER_TILE, max_rowruns=MAX_ROWRUNS)
    # Anisotropic scales, as tests/test_torch_trainer.py: with the initial
    # isotropic ones the quaternions' gradient is pure rounding.
    rng = np.random.default_rng(1)

    def aniso(part):
        s = part.params.scales
        return dataclasses.replace(part, params=dataclasses.replace(
            part.params, scales=s + jnp.asarray(
                0.4 * rng.standard_normal(s.shape), jnp.float32)))

    store = jt.state.store
    state0 = jt.state = dataclasses.replace(jt.state, store=dataclasses.replace(
        store, background=aniso(store.background),
        objects=aniso(store.objects)))
    jrec = ReferenceCadence(jt, FORCED)
    jt.train()
    jfinal = store_arrays(jt.state)

    tt = port_trainer(out / "jax", out / "port")
    tt.state = tckpt.train_state_from_numpy(store_arrays(state0), tt.config,
                                            device="cpu")
    trec = PortRecorder(tt)
    with pytest.MonkeyPatch.context() as mp:
        JaxDraws(state0.rng).patch(mp)
        tt.train()
    return dict(jax=jrec, port=trec, jfinal=jfinal,
                tfinal=tckpt.state_to_numpy(tt.state), out=out)


def test_schedule_trace_matches_jax(runs):
    jtr, ttr = runs["jax"].trace, runs["port"].trace
    assert ttr.rows == jtr.rows
    assert ttr.growth == jtr.growth
    rows = jtr.rows
    assert len(rows) == STEPS
    refines = {r["step"]: r["refine"] for r in rows if r["refine"]}
    assert tuple(refines) == REFINES
    assert tuple(s for s, r in refines.items() if r["reset"]) == RESETS
    assert tuple(s for s, r in refines.items() if r["densify"]) == DENSIFY
    assert tuple(s for s, r in refines.items()
                 if r["final_cull"]) == FINAL_CULL
    assert refines[20]["cull"]
    assert [r["step"] for r in rows if r["sh_live"]] == list(range(15, STEPS))
    assert [r["step"] for r in rows if r["renders"] == 3] \
        == list(range(51, STEPS))
    assert jtr.growth == [(10, (MAX_PAIRS, MAX_ROWRUNS),
                           (2 * MAX_PAIRS, MAX_ROWRUNS))]
    # The first densify ran out of background slots.
    assert runs["jax"].trace.counts[20]["bg_children_dropped"] > 0


def _param_key(mu_key: str) -> str:
    """opt/<group>/mu[/<k>] -> the parameter's checkpoint key."""
    group, sub = mu_key.split("/")[1], mu_key.split("/")[3:]
    if group == "sky_sphere":
        return "store/env_map"
    if group == "bbox_opt":
        return f"store/{sub[0]}"
    part = {"bg": "background", "obj": "objects"}[sub[0]]
    return f"store/{part}/params/{group}"


def _adam_ratio(m, v, count):
    b1, b2 = np.float64(0.9), np.float64(0.999)
    m, v = np.asarray(m, np.float64), np.asarray(v, np.float64)
    return (m / (1 - b1 ** count)) / (np.sqrt(v / (1 - b2 ** count)) + 1e-15)


def _assert_step_close(got: dict, before: dict, want: dict, step: int):
    """A train step's state against the JAX one from the same state."""
    for mu_key in [k for k in want if "/mu" in k and k.startswith("opt/")]:
        group = mu_key.split("/")[1]
        nu_key = mu_key.replace("/mu", "/nu", 1)
        pk = _param_key(mu_key)
        jmu, jnu = want[mu_key], want[nu_key]
        jg = (jmu.astype(np.float64) - 0.9 * before[mu_key]) / 0.1
        floor = GRAD_TOL * float(np.abs(jg).max())
        np.testing.assert_allclose(got[mu_key], jmu, rtol=1e-5,
                                   atol=0.1 * floor, err_msg=mu_key)
        nu_err = np.abs(got[nu_key] - jnu)
        nu_tol = 1e-5 * jnu + 1e-3 * (2 * np.abs(jg) * floor + floor ** 2)
        assert (nu_err <= nu_tol).all(), nu_key
        count = int(want[f"opt/{group}/count"])
        lr = topt.schedule(topt.DEFAULT_GROUPS[group], step)
        explained = lr * np.abs(_adam_ratio(got[mu_key], got[nu_key], count)
                                - _adam_ratio(jmu, jnu, count))
        err = np.abs(got[pk].astype(np.float64) - want[pk])
        tol = 1e-6 * np.abs(want[pk]) + 1e-3 * lr + explained
        assert (err <= tol).all(), (pk, float((err / tol).max()))
    for k, v in want.items():
        if k == "rng" or "/params/" in k or k.startswith("opt/") \
                or k == "store/env_map":
            continue
        if k.endswith("xys_grad_norm"):   # sums of |dL/dxys|
            added = v - before[k]
            np.testing.assert_allclose(
                got[k] - before[k], added, rtol=0,
                atol=GRAD_TOL * float(np.abs(added).max()), err_msg=k)
            continue
        if k in ("store/delta_center", "store/delta_yaw", "store/delta_rot"):
            continue                      # held above as bbox_opt's
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _assert_refine_close(got: dict, want: dict):
    """A refine's state against the JAX one from the same input."""
    assert set(got) == set(want) - {"rng"}
    for k, v in got.items():
        if "/params/" in k:
            np.testing.assert_allclose(v, want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.fixture(scope="module")
def forced_trainer(runs):
    return port_trainer(runs["out"] / "jax", runs["out"] / "forced")


@pytest.mark.parametrize("step", FORCED)
def test_forced_event_step_matches_jax(runs, forced_trainer, monkeypatch,
                                       step):
    snap = runs["jax"].snaps[step]
    tt = forced_trainer

    def load(arrays):
        return tckpt.train_state_from_numpy(arrays, tt.config, device="cpu")

    tt.state = load(snap["before"])
    tt.dm.rng.set_state(snap["dm"][0])
    tt.dm._train_order = list(snap["dm"][1])
    tt.render_config = dataclasses.replace(
        tt.render_config, max_pairs=snap["caps"][0],
        max_rowruns=snap["caps"][1])
    tt._pair_max, tt._rowrun_max = (None if v is None else torch.tensor(v)
                                    for v in snap["running_max"])
    JaxDraws(snap["before"]["rng"]).patch(monkeypatch)
    stepped = {}

    def refine(max_hw):
        stepped["state"] = tt.state
        tt.state = load(snap["stepped"])
        return ttrainer.Trainer._refine(tt, max_hw)

    monkeypatch.setattr(tt, "_refine", refine)
    metrics = tt._iteration(step)

    jm = snap["metrics"]
    for k in ("loss", "psnr", "Ll1", "simloss", "sky_accumulation",
              "gaussian_count", "num_pairs"):
        np.testing.assert_allclose(float(metrics[k]), jm[k], rtol=1e-5,
                                   atol=2e-5, err_msg=k)
    assert ("stepped" in snap) == (step in REFINES)
    step_state = stepped.get("state", tt.state)
    _assert_step_close(tckpt.state_to_numpy(step_state), snap["before"],
                       snap.get("stepped", snap["after"]), step)
    if "stepped" in snap:
        for k, v in runs["jax"].trace.counts[step].items():
            assert int(metrics[k]) == v, k
        _assert_refine_close(tckpt.state_to_numpy(tt.state), snap["after"])
    assert (tt.render_config.max_pairs, tt.render_config.max_rowruns) \
        == snap["caps_after"]


def test_free_running_counts_and_losses_match_jax(runs):
    jtr, ttr = runs["jax"].trace, runs["port"].trace
    print("step  jax gaussians  port gaussians")
    for s in REFINES:
        print(s, jtr.counts[s]["bg_gaussian_count"]
              + jtr.counts[s]["obj_gaussian_count"],
              ttr.counts[s]["bg_gaussian_count"]
              + ttr.counts[s]["obj_gaussian_count"])
    print("pairs jax", jtr.pairs)
    print("pairs port", ttr.pairs)
    print("loss jax", jtr.losses)
    print("loss port", ttr.losses)
    assert set(ttr.counts) == set(jtr.counts) == set(REFINES)
    for s in REFINES:
        for k, v in jtr.counts[s].items():
            np.testing.assert_allclose(ttr.counts[s][k], v,
                                       rtol=FREE_COUNT_RTOL, err_msg=(s, k))
    rel = np.abs(np.subtract(ttr.losses, jtr.losses)) / np.abs(jtr.losses)
    print("largest relative loss difference", float(rel.max()))
    np.testing.assert_allclose(ttr.losses, jtr.losses, rtol=FREE_LOSS_RTOL)
    assert ttr.losses[-1] < ttr.losses[0]
    assert all(jtr.finite.values()) and all(ttr.finite.values())
    assert _all_finite(runs["jfinal"]) and _all_finite(runs["tfinal"])


def test_jax_loop_never_resets_opacities(runs):
    """The JAX loop asks for its refines after steps 9, 19, ..., at those
    steps; at none of them does its refine reset the opacities, while at
    the port's steps 10 and 40 the same JAX function does."""
    jt = runs["jax"].jt
    assert runs["jax"].asks == [9, 19, 29, 39, 49]
    store = jt.state.store.background

    def resets(step):
        _, surgery, _ = jref.refine(store, jnp.int32(step),
                                    jt.config.background, jt.dm.num_train,
                                    jnp.float32(64.0), jax.random.PRNGKey(0))
        return bool(surgery["reset_opacities"])

    assert not any(resets(s) for s in runs["jax"].asks)
    assert all(resets(s) for s in RESETS)


def test_inactive_zero_rows_never_poison_state():
    """tests/test_train.py::test_inactive_zero_rows_never_poison_state on
    the port: a store whose inactive background rows are all zero, quats
    included, has finite gradients in every row (the projection's
    covariance, core/projection._cov3d_components, leaves a zero
    quaternion as it is, as core/quaternions.normalize does) and trains 3
    steps (the
    fused route's plain versions) with a finite loss and finite parameters
    and moments; the zero rows stay zero and get no moment."""
    from test_scene_graph import CFG, H, W, make_store, make_tracks

    cfg = port_config(CFG)
    arrays = store_arrays(make_store())
    act = arrays["background/active"]
    for f in ("means", "scales", "quats", "features_dc", "features_rest",
              "opacities"):
        key = f"background/params/{f}"
        a = act.reshape((-1,) + (1,) * (arrays[key].ndim - 1))
        arrays[key] = np.where(a, arrays[key], 0.0).astype(np.float32)
    store = tckpt.store_from_numpy(arrays, cfg, device="cpu")
    tracks = tckpt.tracks_from_numpy(store_arrays(make_tracks()),
                                     device="cpu")
    state = tsts.init_scene_train_state(store,
                                        torch.Generator().manual_seed(0))
    cam = TCamera.make(40.0, 40.0, W / 2, H / 2,
                       np.eye(3, 4, dtype=np.float32), W, H, time=1.0,
                       device="cpu")
    batch = {"image": torch.full((H, W, 3), 0.4)}
    rcfg = RenderConfig(max_pairs=16384)
    # The gradients themselves, before the step masks inactive rows: the
    # zero quaternions' normalization must not make them NaN.
    grads = tsts.scene_loss_and_grads(state, tracks, cam, batch, cfg,
                                      rcfg)[-1]
    for name, g in grads["gauss"].items():
        for k, v in g.items():
            assert bool(torch.isfinite(v).all()), (name, k)
    for _ in range(3):
        state, m = tsts.scene_train_step(state, tracks, cam, batch, cfg, rcfg)
    assert np.isfinite(float(m["loss"]))
    got = tckpt.state_to_numpy(state)
    assert _all_finite(got)
    off = ~act
    for f in ("means", "scales", "quats", "features_dc", "features_rest",
              "opacities"):
        assert not got[f"store/background/params/{f}"][off].any(), f
        assert not got[f"opt/{f}/mu/bg"][off].any(), f
        assert not got[f"opt/{f}/nu/bg"][off].any(), f

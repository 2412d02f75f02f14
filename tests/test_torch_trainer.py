"""The port's trainer (street_gaussians_ns_tpu_torch.engine.trainer,
.engine.setup, .engine.checkpoints) against the JAX package's, on the CPU,
on tests/test_data.write_clip's clip at tests/test_integration.py's small
configs.

The JAX side is one module fixture: a JAX Trainer (it writes config.json,
pre-sizes its pair capacity and takes one step) and a checkpoint of that
step. Tolerances: configs, pair counts, capacities and every integer leaf
exactly; stores built from the same draws at rtol 1e-6 / atol 1e-6 (as
tests/test_torch_init.py); one step's loss and metrics at atol 2e-5 /
rtol 1e-5 and its parameters and moments as in
tests/test_torch_train_step.py; a checkpoint read by the other package
bit for bit; a resumed port run bit for bit equal to an uninterrupted one.
"""
import dataclasses
import json
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.engine import checkpoints as jckpt
from street_gaussians_ns_tpu.engine import setup as jsetup
from street_gaussians_ns_tpu.engine import trainer as jtrainer
from street_gaussians_ns_tpu_torch.engine import checkpoints as tckpt
from street_gaussians_ns_tpu_torch.engine import optimizers as topt
from street_gaussians_ns_tpu_torch.engine import scene_train_step as tsts
from street_gaussians_ns_tpu_torch.engine import setup as tsetup
from street_gaussians_ns_tpu_torch.engine import trainer as ttrainer
from street_gaussians_ns_tpu_torch.engine.train_step import GAUSSIAN_GROUPS
from street_gaussians_ns_tpu_torch.models.scene_graph import (
    forward_scene as tforward_scene)

from test_data import write_clip
from test_integration import small_configs
from test_torch_init import _jax_noise
from test_torch_scene_graph import store_arrays

GRAD_TOL = 2e-5       # of the group's largest |g|, as test_torch_train_step


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    clip = tmp_path_factory.mktemp("clip")
    write_clip(clip)
    run = tmp_path_factory.mktemp("jax_run")
    cfgs = small_configs(clip, run)
    jt = jtrainer.Trainer(*cfgs)
    config_json = (run / "config.json").read_text()
    # Anisotropic scales: with the initial isotropic ones the quaternions'
    # gradient is pure rounding (tests/test_torch_train_step.py).
    rng = np.random.default_rng(1)

    def aniso(part):
        s = part.params.scales
        return dataclasses.replace(part, params=dataclasses.replace(
            part.params, scales=s + jnp.asarray(
                0.4 * rng.standard_normal(s.shape), jnp.float32)))

    store = jt.state.store
    jt.state = dataclasses.replace(jt.state, store=dataclasses.replace(
        store, background=aniso(store.background),
        objects=aniso(store.objects)))
    state0 = jt.state
    capacities = (jt.render_config.max_pairs, jt.render_config.max_rowruns)
    metrics = jt._run_step(0)
    ckpt = jckpt.save_checkpoint(run / "checkpoints", 1, jt.state)
    return dict(clip=clip, run=run, cfgs=cfgs, trainer=jt,
                config_json=config_json, state0=state0, state1=jt.state,
                metrics=metrics, capacities=capacities, ckpt=ckpt)


def port_configs(jax_side, output_dir, **trainer_kw):
    """The JAX run's configs as the port reads them from its config.json,
    with another output directory."""
    data, model, trainer, dm = tsetup.load_run_config(jax_side["run"])
    return data, model, dataclasses.replace(
        trainer, output_dir=output_dir, **trainer_kw), dm


@pytest.fixture(scope="module")
def port_trainer(jax_side, tmp_path_factory):
    """A port Trainer on the fused route whose state is the JAX trainer's
    first state."""
    cfgs = port_configs(jax_side, tmp_path_factory.mktemp("port_run"))
    tt = ttrainer.Trainer(*cfgs, device="cpu")
    tt.state = tckpt.train_state_from_numpy(
        store_arrays(jax_side["state0"]), tt.config, device="cpu")
    return tt


def test_run_config_crosses_both_ways(jax_side, tmp_path):
    """Every field but the JAX package's render route crosses both ways:
    the port has one route, so it reads no such field and writes none,
    and the JAX package reads its default back."""
    want = json.loads(jax_side["config_json"])
    assert want["trainer"].pop("render_impl") == "chunked"
    cfgs = tsetup.load_run_config(jax_side["run"])
    got = {k: tsetup._to_jsonable(c)
           for k, c in zip(("data", "model", "trainer", "dm"), cfgs)}
    assert got == want
    tsetup.save_run_config(tmp_path, *cfgs)
    back = jsetup.load_run_config(tmp_path)
    j_cfgs = list(jax_side["cfgs"])
    j_cfgs[2] = dataclasses.replace(j_cfgs[2], render_impl="pallas")
    for j_cfg, j_back in zip(j_cfgs, back):
        assert j_back == j_cfg
    assert json.loads((tmp_path / "config.json").read_text()) == want


def test_build_stores_from_jax_draws_matches_jax(jax_side, port_trainer):
    jt = jax_side["trainer"]
    key = jax.random.PRNGKey(jt.tc.seed)
    k_init, _ = jax.random.split(key)
    jbg, jobj, jtracks = jtrainer.build_stores(jt.scene, jt.config, jt.tc,
                                               k_init)
    k_bg, k_obj = jax.random.split(k_init)
    tt = port_trainer
    shapes = ttrainer.draw_store_noise(tt.scene, tt.config, tt.tc,
                                       torch.Generator().manual_seed(0),
                                       "cpu")
    n_bg = shapes["bg"]["means"].shape[0]
    n_obj = [d["means"].shape[0] for d in shapes["obj"]]
    assert (n_bg, n_obj) == (50, [12000])
    noise = {"bg": _jax_noise(k_bg, n_bg),
             "obj": [_jax_noise(jax.random.fold_in(k_obj, i), n)
                     for i, n in enumerate(n_obj)]}
    tbg, tobj, ttracks = ttrainer.build_stores(tt.scene, tt.config, tt.tc,
                                               noise, "cpu")
    for got, want in ((tbg, jbg), (tobj, jobj)):
        np.testing.assert_array_equal(got.active.numpy(),
                                      np.asarray(want.active))
        for f in dataclasses.fields(want.params):
            g = getattr(got.params, f.name).numpy()
            w = np.asarray(getattr(want.params, f.name))
            assert g.shape == w.shape, f.name
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=f.name)
    for f in dataclasses.fields(jtracks):
        np.testing.assert_array_equal(getattr(ttracks, f.name).numpy(),
                                      np.asarray(getattr(jtracks, f.name)))


def test_pair_counts_and_capacity_rules_match_jax(jax_side, port_trainer):
    jt, tt = jax_side["trainer"], port_trainer
    jstore = jax_side["state0"].store
    # The JAX function op by op: under jit, XLA's fused float rounding
    # moves a coverage test on a borderline gaussian (26,187 pairs of
    # camera 0 jitted, 26,188 op by op and in the port).
    for i in range(tt.dm.num_train):
        got = ttrainer.scene_pair_counts(tt.state.store, tt.tracks,
                                         tt.dm.train_camera(i), tt.config)
        with jax.disable_jit():
            want = jtrainer.scene_pair_counts(jstore, jt.tracks,
                                              jt.dm.train_camera(i),
                                              jt.config)
        assert [int(v) for v in got] == [int(v) for v in want], i
    saved = tt.render_config
    try:
        tt._presize_pairs()
        assert (tt.render_config.max_pairs, tt.render_config.max_rowruns) \
            == jax_side["capacities"]
        jsaved = jt.render_config
        # The growth rule, from the running max of the counts since the
        # last check: the port keeps that max on the device.
        checks = [[(1000, 900), (70000, 900), (1200, 800)],
                  [(5000, 200000)], [(300000, 10)], [(10, 10)]]
        for seen in checks:
            for p, r in seen:
                tt._track_max({"num_pairs": torch.tensor(p),
                               "num_rowruns": torch.tensor(r)})
            top = {"num_pairs": max(p for p, _ in seen),
                   "num_rowruns": max(r for _, r in seen)}
            grew = tt._maybe_grow_pairs({})
            assert grew == jt._maybe_grow_pairs(top)
            assert (tt.render_config.max_pairs, tt.render_config.max_rowruns
                    ) == (jt.render_config.max_pairs,
                          jt.render_config.max_rowruns)
        assert tt.render_config.max_pairs > saved.max_pairs
    finally:
        tt.render_config = saved
        jt.render_config = jsaved


def test_run_step_matches_jax(jax_side, port_trainer, monkeypatch):
    """Trainer._run_step from the JAX trainer's first state and data
    order, with the JAX step's sky jitter handed to the port."""
    jt, tt = jax_side["trainer"], port_trainer
    j0, j1 = jax_side["state0"], jax_side["state1"]
    camera = tt.dm.train_camera(0)
    k_sky = jax.random.split(j0.rng)[1]
    jitter = torch.from_numpy(np.array(jax.random.uniform(
        k_sky, (2, camera.height, camera.width))))
    monkeypatch.setattr(tsts, "draw_pixel_jitter", lambda cam, gen: jitter)
    tt.dm.rng = np.random.RandomState(tt.dm.config.seed)   # replay frame 0
    tt.dm._train_order = []
    start = tt.state
    metrics = tt._run_step(0)
    jm = jax_side["metrics"]
    for k in ("loss", "psnr", "Ll1", "simloss", "sky_accumulation",
              "gaussian_count", "num_pairs"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, atol=2e-5, err_msg=k)
    tnew = tt.state
    assert tnew.step == int(j1.step) == 1
    for name in GAUSSIAN_GROUPS:
        for k, part in (("bg", "background"), ("obj", "objects")):
            jmu = np.asarray(j1.opt[name].mu[k])
            jg = jmu / 0.1                   # first step from zero moments
            lr = topt.schedule(topt.DEFAULT_GROUPS[name], 0)
            floor = GRAD_TOL * float(np.abs(jg).max())
            sure = np.abs(jg) > floor
            tp = getattr(getattr(tnew.store, part).params, name).numpy()
            jp = np.asarray(getattr(getattr(j1.store, part).params, name))
            p0 = getattr(getattr(start.store, part).params, name).numpy()
            if not sure.any():
                np.testing.assert_array_equal(tp, jp)
                continue
            np.testing.assert_allclose(tp[sure], jp[sure], rtol=1e-6,
                                       atol=1e-3 * lr, err_msg=name)
            assert float(np.abs(tp - p0).max()) <= 2 * lr * 1.001, name
            np.testing.assert_allclose(tnew.opt[name].mu[k].numpy(), jmu,
                                       rtol=1e-5, atol=0.1 * floor,
                                       err_msg=name)
    for part in ("background", "objects"):
        for k in ("vis_counts", "max_2dsize"):
            np.testing.assert_array_equal(
                getattr(getattr(tnew.store, part), k).numpy(),
                np.asarray(getattr(getattr(j1.store, part), k)))
    tt.state = start


def test_resume_continues_bit_for_bit(jax_side, tmp_path):
    """12 steps, checkpoints at 6 and 12; a run resumed from step 6
    reaches step 12 with the uninterrupted run's state, bit for bit."""
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    a = ttrainer.Trainer(*port_configs(jax_side, a_dir),
                         device="cpu")
    a.train()
    ckpts = sorted(p.name for p in (a_dir / "checkpoints").glob("*.npz"))
    assert ckpts == ["step-000000006.ckpt.npz", "step-000000012.ckpt.npz"]
    (b_dir / "checkpoints").mkdir(parents=True)
    shutil.copy(a_dir / "checkpoints" / ckpts[0], b_dir / "checkpoints")
    b = ttrainer.Trainer(*port_configs(jax_side, b_dir),
                         device="cpu")
    assert b.start_step == 6
    b.train()
    got, want = tckpt.state_to_numpy(b.state), tckpt.state_to_numpy(a.state)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert torch.equal(b.state.generator.get_state(),
                       a.state.generator.get_state())
    c = ttrainer.Trainer(*port_configs(jax_side, a_dir),
                         device="cpu")
    assert c.start_step == 12 and c.state.step == 12
    rows = [json.loads(r) for r in (a_dir / "metrics.jsonl").read_text()
            .splitlines()]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert any("eval/all_psnr" in r for r in rows)

    # The JAX package reads the port's checkpoint into its own train
    # state, every leaf equal; "rng" is the JAX key of the port's seed.
    jt = jax_side["trainer"]
    restored = jckpt.restore_checkpoint(a_dir / "checkpoints" / ckpts[1],
                                        jt.state)
    jarrays = store_arrays(restored)
    assert set(jarrays) == set(want) | {"rng"}
    for k, v in want.items():
        assert jarrays[k].dtype == v.dtype, k
        np.testing.assert_array_equal(jarrays[k], v, err_msg=k)
    np.testing.assert_array_equal(jarrays["rng"],
                                  np.asarray(jax.random.PRNGKey(a.tc.seed)))
    # A shape that differs is refused, as the JAX restore refuses it.
    bad = tmp_path / "bad.ckpt.npz"
    arrays = dict(np.load(a_dir / "checkpoints" / ckpts[1]))
    key = "store/background/params/means"
    np.savez(bad, **{**arrays, key: arrays[key][:5]})
    with pytest.raises(ValueError, match=key):
        tckpt.restore_checkpoint(bad, a.state)
    del arrays["opt/means/mu/bg"]
    np.savez(bad, **arrays)
    with pytest.raises(KeyError, match="opt/means/mu/bg"):
        tckpt.restore_checkpoint(bad, a.state)


def test_port_eval_setup_restores_a_jax_run(jax_side):
    """A JAX run whose config.json names the chunked route restores, and
    renders through the port's one route: a frame of the restored state
    is drawn, finite and in [0, 1]."""
    assert json.loads(jax_side["config_json"])["trainer"][
        "render_impl"] == "chunked"
    tt = tsetup.eval_setup(jax_side["run"], device="cpu")
    got = tckpt.state_to_numpy(tt.state)
    want = store_arrays(jax_side["state1"])
    assert set(got) == set(want) - {"rng"}
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert tt.state.step == 1
    camera = tt.dm.train_camera(0)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        heads = tforward_scene(tt.state.store, tt.tracks, camera,
                               tt.state.step, tt.config, tt.render_config,
                               training=False)[0]
    rgb, acc = heads["rgb"], heads["accumulation"]
    assert tuple(rgb.shape) == (camera.height, camera.width, 3)
    assert bool(torch.isfinite(rgb).all())
    assert 0.0 <= float(rgb.min()) and float(rgb.max()) <= 1.0
    assert float(acc.max()) > 0.1


def test_bf16_trainer_step_matches_jax(jax_side, tmp_path, monkeypatch):
    """render_precision="bf16" (it replaced the raise of this option):
    the port Trainer renders in bf16, and its _run_step from the JAX
    trainer's first state, data order and sky jitter equals a JAX
    Trainer's with render_impl="pallas", render_precision="bf16" (its
    Pallas kernels in interpret mode), held as test_run_step_matches_jax
    holds the f32 step."""
    data, model, trainer, dm = jax_side["cfgs"]
    jt = jtrainer.Trainer(data, model, dataclasses.replace(
        trainer, output_dir=tmp_path / "jax", render_impl="pallas",
        render_precision="bf16"), dm)
    assert jt.render_config.precision == "bf16"
    j0 = jt.state = jax_side["state0"]
    jm = jt._run_step(0)
    j1 = jt.state
    tt = ttrainer.Trainer(*port_configs(jax_side, tmp_path / "port",
                                        render_precision="bf16"),
                          device="cpu")
    assert tt.render_config.precision == "bf16"
    assert (tt.render_config.max_pairs, tt.render_config.max_rowruns) == (
        jt.render_config.max_pairs, jt.render_config.max_rowruns)
    tt.state = start = tckpt.train_state_from_numpy(store_arrays(j0),
                                                    tt.config, device="cpu")
    camera = tt.dm.train_camera(0)
    jitter = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.split(j0.rng)[1], (2, camera.height, camera.width))))
    monkeypatch.setattr(tsts, "draw_pixel_jitter", lambda cam, gen: jitter)
    metrics = tt._run_step(0)
    for k in ("loss", "psnr", "Ll1", "simloss", "sky_accumulation",
              "gaussian_count", "num_pairs"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, atol=2e-5, err_msg=k)
    tnew = tt.state
    moved = 0
    for name in GAUSSIAN_GROUPS:
        for k, part in (("bg", "background"), ("obj", "objects")):
            jmu = np.asarray(j1.opt[name].mu[k])
            jg = jmu / 0.1                   # first step from zero moments
            lr = topt.schedule(topt.DEFAULT_GROUPS[name], 0)
            floor = GRAD_TOL * float(np.abs(jg).max())
            sure = np.abs(jg) > floor
            tp = getattr(getattr(tnew.store, part).params, name).numpy()
            jp = np.asarray(getattr(getattr(j1.store, part).params, name))
            p0 = getattr(getattr(start.store, part).params, name).numpy()
            if not sure.any():
                np.testing.assert_array_equal(tp, jp)
                continue
            moved += 1
            np.testing.assert_allclose(tp[sure], jp[sure], rtol=1e-6,
                                       atol=1e-3 * lr, err_msg=name)
            assert float(np.abs(tp - p0).max()) <= 2 * lr * 1.001, name
            np.testing.assert_allclose(tnew.opt[name].mu[k].numpy(), jmu,
                                       rtol=1e-5, atol=0.1 * floor,
                                       err_msg=name)
    assert moved >= 4


def test_trainer_viewer_matches_jax(jax_side, tmp_path):
    """TrainerConfig.viewer_port starts the viewer: its initial camera is
    the JAX viewer's, and a viewer frame (train camera 0's intrinsics
    scaled to the frame, forward_scene(training=False), clamped, uint8)
    of the JAX trainer's state is the JAX trainer's frame, to one level
    where the float images round across a level. The JAX trainer's
    chunked compositor gets a per-tile budget that truncates nothing (the
    vehicle puts ~2,000 pairs in a tile of these small frames)."""
    jt = jax_side["trainer"]
    jt.state = jax_side["state1"]
    tt = ttrainer.Trainer(*port_configs(jax_side, tmp_path, viewer_port=0),
                          device="cpu")
    jserver = jtrainer.attach_viewer(jt, 0)
    saved = jt.render_config
    jt.render_config = dataclasses.replace(saved, max_per_tile=16384)
    try:
        assert tt.viewer is not None and tt.viewer.port > 0
        assert tt.viewer._init == jserver._init
        tt.state = tckpt.train_state_from_numpy(
            store_arrays(jax_side["state1"]), tt.config, device="cpu")
        c2w = np.asarray(jt.scene.c2w[int(jt.scene.train_indices[1])])
        t = float(jt.scene.times[1])
        for w, h in ((64, 48), (80, 45)):
            with warnings.catch_warnings():
                warnings.simplefilter("error", RuntimeWarning)
                got = tt._viewer_render(c2w, t, w, h)
            want = jt._viewer_render(c2w, t, w, h)
            assert got.dtype == np.uint8 and got.shape == want.shape \
                == (h, w, 3)
            diff = np.abs(got.astype(int) - want.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (
                w, h, (diff > 0).mean())
            assert want.std() > 5
    finally:
        jt.render_config = saved
        for key in [k for k in jt._step_fns if k[0] == "viewer"]:
            del jt._step_fns[key]
        tt.viewer.close()
        jserver.close()


@pytest.mark.parametrize("mode", ["SO3xR3", "SE3"])
def test_trainer_camera_opt_matches_jax(jax_side, tmp_path, mode):
    """4 steps with the camera optimizer (tests/test_round2_features.py)
    in both packages: one (6,) delta per train camera, the accumulator
    filled on the rows the data order stepped, calls == 4; then the
    checkpoints with camera_opt and its Adam state cross both ways leaf by
    leaf, and the port steps on from the JAX one."""
    data, model, trainer, dm = jax_side["cfgs"]
    model = dataclasses.replace(model, camera_opt_mode=mode)
    short = dict(max_num_iterations=4, steps_per_eval_image=100,
                 steps_per_save=100)
    jt = jtrainer.Trainer(data, model, dataclasses.replace(
        trainer, output_dir=tmp_path / "jax", **short), dm)
    pdata, pmodel, ptrainer, pdm = port_configs(
        jax_side, tmp_path / "port", **short)
    pmodel = dataclasses.replace(pmodel, camera_opt_mode=mode)
    tt = ttrainer.Trainer(pdata, pmodel, ptrainer, pdm, device="cpu")
    assert tt.state.camera_opt.shape == jt.state.camera_opt.shape \
        == (tt.dm.num_train, 6)
    assert tt._cam_row == jt._cam_row
    jt.train()
    tt.train()
    tacc = tt.state.opt["camera_opt"].acc.numpy()
    jacc = np.asarray(jt.state.opt["camera_opt"].acc)
    assert tt.state.opt["camera_opt"].calls == int(
        jt.state.opt["camera_opt"].calls) == 4
    assert np.abs(tacc).max() > 0 and np.isfinite(tacc).all()
    np.testing.assert_array_equal(np.abs(tacc).max(1) > 0,
                                  np.abs(jacc).max(1) > 0)
    assert not tt.state.camera_opt.any()            # 4 of 100 calls

    jpath = tmp_path / "jax" / "checkpoints" / "step-000000004.ckpt.npz"
    ppath = tmp_path / "port" / "checkpoints" / "step-000000004.ckpt.npz"
    restored = tckpt.restore_checkpoint(jpath, tt.state)
    got, want = tckpt.state_to_numpy(restored), dict(np.load(jpath))
    assert set(got) == set(want) - {"rng"}
    assert {"camera_opt", "opt/camera_opt/acc", "opt/camera_opt/calls"} \
        <= set(got)
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    tt.state = restored
    tt._run_step(4)
    assert tt.state.opt["camera_opt"].calls == 5
    back = store_arrays(jckpt.restore_checkpoint(ppath, jt.state))
    mine = dict(np.load(ppath))
    assert set(back) <= set(mine) and "camera_opt" in back
    for k, v in back.items():
        assert v.dtype == mine[k].dtype, k
        np.testing.assert_array_equal(v, mine[k], err_msg=k)


def test_cuda_without_a_card_raises(jax_side, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrainer.Trainer(*port_configs(jax_side, tmp_path))
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrainer.Trainer(*port_configs(jax_side, tmp_path, viewer_port=0))
    with pytest.raises(RuntimeError, match="--device cpu"):
        tsetup.eval_setup(jax_side["run"])
    assert not (tmp_path / "config.json").exists()

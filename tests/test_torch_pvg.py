"""The Periodic Vibration Gaussian model (models/pvg.py, the benchmark's
pvg_waymo3) on the CPU at a tiny size, against the plain PyTorch
reference (benchmark/reference/pvg.py): the temporal transform's
closed-form backward against autograd (float64 and float32), a whole
train step (loss, every leaf's gradient, one Adam step over the ten
leaves), the refine carrying tau, s_beta and velocity to the children
with the position-aware gamma, checkpoints with the temporal leaves, a
JAX checkpoint still loading into the scene graph, the Adam leaves a
step, the spans and the faded counter, and the train / eval / render
CLIs with `--method pvg`.
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_tracing as tt
from benchmark import pvg3, scene, waymo3
from benchmark.reference import gs
from benchmark.reference import pvg as pvg_ref
from street_gaussians_ns_tpu_torch.core.cameras import Camera
from street_gaussians_ns_tpu_torch.engine import checkpoints as tckpt
from street_gaussians_ns_tpu_torch.engine import train_step as ts
from street_gaussians_ns_tpu_torch.models import pvg, refinement
from street_gaussians_ns_tpu_torch.models.gaussians import (
    GaussianParams, GaussianStore, draw_init_noise, init_gaussians,
    zeros_stats)
from street_gaussians_ns_tpu_torch.models.scene_graph import SceneGraphConfig
from street_gaussians_ns_tpu_torch.models.splatfacto import SplatfactoConfig
from street_gaussians_ns_tpu_torch.ops.render import RenderConfig
from street_gaussians_ns_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 33 + 29                 # the benchmark's seeds exceed 32 bits
STEP = 3601
W, H, FOCAL = 64, 48, 48.0
GROUPS = ts.GAUSSIAN_GROUPS + pvg.TEMPORAL_GROUPS


def _config():
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      "pvg_waymo3.json").read_text())
    cfg.update(background_capacity=2048, env_map_res=16, track_frames=6)
    return cfg


CFG = _config()
PVG = pvg.PVGConfig(cycle=CFG["cycle_s"])
SPLAT = SplatfactoConfig(use_sky_sphere=True, sh_degree=3, env_map_res=16)
RCFG = RenderConfig(max_pairs=2 ** 16)
TIMES = waymo3.make_tracks(pvg3.clip_config(CFG), "cpu")[0]["times"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    profiling.enable(False)
    profiling.reset()


def _state(sc, step=STEP):
    dev = sc["bg/means"].device
    params = GaussianParams(**{k: sc[f"bg/{k}"].clone() for k in GROUPS})
    store = GaussianStore(params, sc["bg/active"].clone(),
                          *zeros_stats(params.capacity, dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    return dataclasses.replace(ts.init_train_state(
        store, sc["env_map"].clone(), gen), step=step)


def _cameras(g, device="cpu"):
    """Image g's camera for the port and for the reference."""
    c2w = waymo3.c2w(CFG, g)
    t = float(TIMES[g % waymo3.frames(CFG)])
    return (Camera.make(FOCAL, FOCAL, W / 2, H / 2, c2w, W, H, time=t,
                        device=device),
            scene.camera(c2w, W, H, FOCAL, t, device))


def _batch(g, device="cpu"):
    img = waymo3.target_image(SEED, g, W, H, 8, "cpu")
    return {"image": img.to(device),
            "semantic": scene.semantic_map(W, H, device)}


def _jitter(seed=0):
    return torch.rand((2, H, W), generator=torch.Generator().manual_seed(
        seed))


def _temporal_inputs(n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*s):
        return torch.randn(s, generator=g, dtype=dtype)
    means, logits, velocity = r(n, 3), r(n, 1), 5.0 * r(n, 3)
    tau = 8.4 * torch.rand((n, 1), generator=g, dtype=dtype)
    s_beta = math.log(0.2) + 6.0 * torch.rand((n, 1), generator=g,
                                              dtype=dtype)
    return means, logits, tau, s_beta, velocity


@pytest.mark.parametrize("t", [0.0, 3.3, 8.4])
def test_temporal_backward_matches_autograd_in_float64(t):
    """The closed-form backward against finite differences and against
    the reference's autograd, in float64 (the Function takes any float
    dtype)."""
    inputs = [x.requires_grad_(True)
              for x in _temporal_inputs(24, torch.float64)]
    tt64 = torch.tensor(t, dtype=torch.float64)
    a = 2.0 * math.pi / PVG.cycle
    assert torch.autograd.gradcheck(
        lambda *x: pvg._Temporal.apply(*x, tt64, a), inputs)
    g_mu = torch.randn(24, 3, dtype=torch.float64)
    g_o = torch.randn(24, dtype=torch.float64)
    got = torch.autograd.grad(pvg._Temporal.apply(*inputs, tt64, a),
                              inputs, (g_mu, g_o))
    want = torch.autograd.grad(
        pvg_ref.temporal(*inputs, tt64, PVG.cycle), inputs, (g_mu, g_o))
    for name, x, y in zip(("means", "logits", "tau", "s_beta", "velocity"),
                          got, want):
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12, msg=name)


def test_temporal_in_float32_matches_the_reference():
    """float32: mu(t) and o(t) equal the reference's bit for bit (the same
    operations in the same order); the gradients agree to rounding."""
    inputs = [x.requires_grad_(True)
              for x in _temporal_inputs(5000, torch.float32, seed=3)]
    t = torch.tensor(4.2, dtype=torch.float32)
    params = GaussianParams(
        means=inputs[0], scales=None, quats=None, features_dc=None,
        features_rest=None, opacities=inputs[1], tau=inputs[2],
        s_beta=inputs[3], velocity=inputs[4])
    got = pvg.temporal(params, t, PVG.cycle)
    want = pvg_ref.temporal(*inputs, t, PVG.cycle)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    g = (torch.randn(5000, 3), torch.randn(5000))
    for name, x, y in zip(
            ("means", "logits", "tau", "s_beta", "velocity"),
            torch.autograd.grad(got, inputs, g),
            torch.autograd.grad(want, inputs, g)):
        torch.testing.assert_close(x, y, rtol=2e-5,
                                   atol=2e-6 * float(y.abs().max()),
                                   msg=name)


def test_pvg_step_loss_and_gradients_match_the_reference():
    """One PVG step's loss and every leaf's gradient (the three temporal
    ones non-zero) against the reference's autograd through the same
    cloud, camera time, target and sky jitter."""
    sc = pvg3.make_scene(SEED, CFG, "cpu")
    state = _state(sc)
    g = 2 * waymo3.frames(CFG) + 3          # camera 3, frame 3
    cam, rcam = _cameras(g)
    batch, jitter = _batch(g), _jitter()
    total, _, _, _, grads = ts.loss_and_grads(state, cam, batch, SPLAT, RCFG,
                                              jitter=jitter, pvg=PVG)
    names = pvg_ref.leaf_names(sc)
    leaves = {k: sc[k].clone().requires_grad_(True) for k in names}
    fixed = {k: sc[k] for k in sc if k not in names}
    out = pvg_ref.forward({**leaves, **fixed}, rcam, 3, PVG.cycle, True,
                          jitter)
    loss = gs.loss(out, batch["image"], batch["semantic"])
    want = torch.autograd.grad(loss, [leaves[k] for k in names])
    assert abs(float(total) - float(loss.detach())) <= 2e-6 * float(
        loss.detach())
    for k, w in zip(names, want):
        got = (grads["env_map"] if k == "env_map"
               else grads["params"][k.split("/")[1]])
        top = float(w.abs().max())
        assert top > 0, k
        torch.testing.assert_close(got, w, rtol=1e-4, atol=2e-5 * top,
                                   msg=k)


def test_pvg_train_step_matches_the_reference_adam_step():
    """A whole train step: ten Adam leaves, each leaf's change equal to
    the reference's first Adam step (reference_steps) to rounding."""
    sc = pvg3.make_scene(SEED + 1, CFG, "cpu")
    state = _state(sc)
    g = waymo3.frames(CFG) + 2
    cam, rcam = _cameras(g)
    batch, jitter = _batch(g), _jitter(1)
    profiling.enable(True)
    new, metrics = ts.train_step(state, cam, batch, SPLAT, RCFG,
                                 jitter=jitter, pvg=PVG)
    snap = profiling.snapshot()
    profiling.enable(False)
    assert snap["step.adam_leaves"]["total"] == 10
    assert new.step == STEP + 1 and sorted(new.opt) == sorted(
        GROUPS + ("sky_sphere",))
    lr = {k: tuple(v) for k, v in CFG["temporal_lr"].items()}
    ref = pvg_ref.reference_steps(
        sc, [(STEP, rcam, batch["image"], batch["semantic"], jitter)], 3,
        PVG.cycle, lr)
    assert abs(float(metrics["loss"]) - ref["losses"][0]) <= 2e-6 * abs(
        ref["losses"][0])
    for k in pvg_ref.leaf_names(sc):
        if k == "env_map":
            got = new.env_map - sc["env_map"]
        else:
            leaf = k.split("/")[1]
            got = getattr(new.store.params, leaf) - sc[k]
        n = float(torch.linalg.vector_norm(got))
        assert ref["change"][k] > 0, k
        assert abs(n - ref["change"][k]) <= 5e-3 * ref["change"][k], k


@pytest.mark.parametrize("which,leaves", [("scene", 16), ("splat", 7),
                                          ("pvg", 10)])
def test_adam_leaves_a_step(which, leaves):
    """The counter step.adam_leaves: 16 a scene-graph step (6 groups x 2
    submodels, the sky, 3 bbox deltas), 7 a Splatfacto step, 10 a PVG
    step (6 gaussian leaves, 3 temporal, the sky)."""
    if which == "pvg":
        sc = pvg3.make_scene(SEED, CFG, "cpu")
        cam, _ = _cameras(1)
        run = (lambda: ts.train_step(_state(sc), cam, _batch(1), SPLAT, RCFG,
                                     jitter=_jitter(), pvg=PVG))
    elif which == "scene":
        scene_, batch = tt._scene("cpu"), tt._batch("cpu")
        run = (lambda: tt._scene_step(scene_, batch))
    else:
        splat, batch = tt._splat("cpu"), tt._batch("cpu")
        run = (lambda: tt._splat_step(splat, batch))
    profiling.reset()
    profiling.enable(True)
    run()
    snap = profiling.snapshot()
    profiling.enable(False)
    assert snap["step.adam_leaves"] == {"count": 1, "total": leaves,
                                        "parent": "step.adam"}


def _refine_store(seed):
    """A temporal store whose tau, s_beta and velocity name their slot
    (slot i: i, -i, (i, 2i, 3i)), with densify statistics that split
    and duplicate a part of it."""
    sc = pvg3.make_scene(seed, CFG, "cpu")
    n = CFG["background_capacity"]
    idx = torch.arange(n, dtype=torch.float32)[:, None]
    small = (torch.arange(n) % 2 == 0)[:, None]       # these duplicate
    sc["bg/scales"] = torch.where(small, sc["bg/scales"] - 3.0,
                                  sc["bg/scales"])
    params = GaussianParams(**{k: sc[f"bg/{k}"] for k in ts.GAUSSIAN_GROUPS},
                            tau=idx.clone(), s_beta=-idx,
                            velocity=idx * torch.tensor([1.0, 2.0, 3.0]))
    g = torch.Generator().manual_seed(seed % 2 ** 31)
    grad = torch.rand(n, generator=g) * 4e-4
    return GaussianStore(params, sc["bg/active"].clone(), grad,
                         torch.ones(n), torch.rand(n, generator=g) * 0.1)


REFINE_CFG = dataclasses.replace(SceneGraphConfig().background,
                                 refine_parent_cap_div=4)


def test_refine_carries_the_temporal_leaves_to_children():
    """The temporal store refines its six leaves as the same store
    without temporal leaves does (bit for bit), and every child's tau,
    s_beta and velocity are its parent's."""
    store = _refine_store(SEED)
    noise = torch.randn((2, refinement.parent_budget(REFINE_CFG, 2048), 3),
                        generator=torch.Generator().manual_seed(1))
    step, n_train = 600, 10
    new, surgery, info = refinement.refine(store, step, REFINE_CFG, n_train,
                                           W, noise)
    plain = dataclasses.replace(store, params=GaussianParams(**{
        k: getattr(store.params, k) for k in ts.GAUSSIAN_GROUPS}))
    want, want_s, want_i = refinement.refine(plain, step, REFINE_CFG,
                                             n_train, W, noise)
    assert int(info["refine_splits_count"]) > 0
    assert int(info["refine_dups_count"]) > 0
    for k in ts.GAUSSIAN_GROUPS:
        assert torch.equal(getattr(new.params, k), getattr(want.params, k))
    assert torch.equal(new.active, want.active)
    assert torch.equal(surgery["keep"], want_s["keep"])
    tau = new.params.tau[:, 0]
    parent = tau.long()
    placed = ~surgery["keep"] & new.active
    assert int(placed.sum()) > 0
    parents = store.xys_grad_norm * 0.5 * W > REFINE_CFG.densify_grad_thresh
    assert bool(parents[parent[placed]].all())
    assert bool((parent[placed] != torch.nonzero(placed)[:, 0]).all())
    assert torch.equal(new.params.s_beta[:, 0], -tau)
    assert torch.equal(new.params.velocity,
                       tau[:, None] * torch.tensor([1.0, 2.0, 3.0]))
    kept = new.active & surgery["keep"]
    assert torch.equal(parent[kept], torch.nonzero(kept)[:, 0])


def test_position_aware_gamma_matches_the_reference_and_densifies():
    """gamma(mu) from the train cameras' extent against the reference's
    plain form, and its effect: a refine with it densifies exactly the
    gaussians whose gamma-scaled average gradient passes the threshold."""
    store = _refine_store(SEED + 2)
    centres = np.stack([waymo3.c2w(CFG, g)[:, 3] for g in
                        range(waymo3.image_count(CFG))])
    c, r = pvg.scene_extent(centres)
    got = pvg.densify_scale(store.params.means, c, r)
    want = pvg_ref.position_scale(store.params.means.double(),
                                  torch.from_numpy(centres).double())
    near = (want - 2.0).abs() < 1e-4
    torch.testing.assert_close(got[~near].double(), want[~near], rtol=1e-5,
                               atol=0.0)
    assert float(got.max()) > 2.0 and float(got.min()) == 1.0
    noise = torch.zeros((2, refinement.parent_budget(REFINE_CFG, 2048), 3))
    _, _, info = refinement.refine(store, 600, REFINE_CFG, 10, W, noise,
                                   densify_scale=got)
    avg = store.xys_grad_norm * 0.5 * W
    expect = store.active & (avg * got > REFINE_CFG.densify_grad_thresh)
    assert int(info["high_grads_count"]) == int(expect.sum())
    _, _, plain = refinement.refine(store, 600, REFINE_CFG, 10, W, noise)
    assert int(info["high_grads_count"]) > int(plain["high_grads_count"])


def test_init_gaussians_draws_the_temporal_leaves():
    """A temporal store's life peaks come from the draw after the
    others (the scene graph's draws are unchanged), its lifespans and
    velocities from the arguments."""
    pts = np.random.default_rng(0).standard_normal((300, 3)).astype(
        np.float32)
    rgb = np.full((300, 3), 128, np.uint8)
    plain = draw_init_noise(300, torch.Generator().manual_seed(5), "cpu")
    temporal = draw_init_noise(300, torch.Generator().manual_seed(5), "cpu",
                               temporal=True)
    for k in plain:
        assert torch.equal(plain[k], temporal[k])
    store = init_gaussians(512, pts, rgb, noise=temporal,
                           temporal=(2.0, 6.0, 3.0), device="cpu")
    base = init_gaussians(512, pts, rgb, noise=plain, device="cpu")
    assert base.params.tau is None and len(base.params.as_dict()) == 6
    assert list(store.params.as_dict()) == list(GROUPS)
    for k in ts.GAUSSIAN_GROUPS:
        assert torch.equal(getattr(store.params, k), getattr(base.params, k))
    tau = store.params.tau[:300, 0]
    torch.testing.assert_close(tau, 2.0 + 4.0 * temporal["tau"])
    assert float(tau.min()) >= 2.0 and float(tau.max()) <= 6.0
    torch.testing.assert_close(store.params.s_beta,
                               torch.full((512, 1), math.log(3.0)))
    assert not store.params.velocity.any()


def test_checkpoint_round_trip_with_the_temporal_leaves(tmp_path):
    """A PVG train state written and read back: every leaf, moment, count
    and the step, the temporal ones among them, and the generator."""
    state = _state(pvg3.make_scene(SEED, CFG, "cpu"))
    state = dataclasses.replace(state, opt={
        k: dataclasses.replace(s, mu=s.mu + 1.0, nu=s.nu + 2.0, count=7)
        for k, s in state.opt.items()})
    path = tckpt.save_checkpoint(tmp_path, 9, state)
    keys = set(np.load(path).files)
    assert {"store/background/params/tau", "store/background/params/s_beta",
            "store/background/params/velocity", "opt/tau/mu",
            "opt/velocity/nu", "opt/s_beta/count"} <= keys
    target = _state(pvg3.make_scene(SEED + 5, CFG, "cpu"), step=0)
    got = tckpt.restore_checkpoint(path, target)
    assert got.step == STEP
    for k in GROUPS:
        assert torch.equal(getattr(got.store.params, k),
                           getattr(state.store.params, k)), k
        assert torch.equal(got.opt[k].mu, state.opt[k].mu)
        assert torch.equal(got.opt[k].nu, state.opt[k].nu)
        assert got.opt[k].count == 7
    assert torch.equal(got.env_map, state.env_map)
    assert torch.equal(got.store.active, state.store.active)
    assert torch.equal(got.generator.get_state(),
                       state.generator.get_state())


def test_a_jax_checkpoint_still_loads_into_the_scene_graph(tmp_path):
    """A checkpoint the JAX package writes has no temporal leaf: the
    scene graph's stores load from it with their six leaves."""
    import jax.numpy as jnp

    from street_gaussians_ns_tpu.engine import checkpoints as jckpt
    from street_gaussians_ns_tpu.models import gaussians as jgauss
    rng = np.random.default_rng(2)

    def jstore(lead, cap, f):
        def a(*s):
            return jnp.asarray(rng.standard_normal(lead + (cap,) + s),
                               jnp.float32)
        return jgauss.GaussianStore(
            params=jgauss.GaussianParams(
                means=a(3), scales=a(3), quats=a(4), features_dc=a(f, 3),
                features_rest=a(15, 3), opacities=a(1)),
            active=jnp.ones(lead + (cap,), bool),
            xys_grad_norm=a(), vis_counts=a(), max_2dsize=a())
    tree = {"store": {"background": jstore((), 64, 1),
                      "objects": jstore((2,), 16, 5),
                      "env_map": jnp.zeros((6, 4, 4, 3), jnp.float32),
                      "delta_center": jnp.zeros((3, 2, 3), jnp.float32),
                      "delta_yaw": jnp.zeros((3, 2), jnp.float32),
                      "delta_rot": jnp.zeros((3, 2, 3), jnp.float32)}}
    path = jckpt.save_checkpoint(tmp_path, 3, tree)
    store = tckpt.load_checkpoint(path, "store/", SceneGraphConfig(),
                                  device="cpu")
    for part in (store.background, store.objects):
        assert not part.params.temporal
        assert list(part.params.as_dict()) == list(ts.GAUSSIAN_GROUPS)
    np.testing.assert_array_equal(
        store.objects.params.features_dc.numpy(),
        np.asarray(tree["store"]["objects"].params.features_dc))


def test_spans_and_the_faded_counter_record_only_while_tracing(monkeypatch):
    """Off: no span, no counter and no faded reduction (the faded count
    is never formed). On: pvg.temporal in the forward, pvg.temporal_bwd in the
    backward, and pvg.faded = the active slots with o(t) < 1/255."""
    sc = pvg3.make_scene(SEED, CFG, "cpu")
    sc["bg/s_beta"] = sc["bg/s_beta"] - 2.0       # shorter lives: some fade
    cam, _ = _cameras(3)

    def step():
        return ts.train_step(_state(sc), cam, _batch(3), SPLAT, RCFG,
                             jitter=_jitter(), pvg=PVG)

    count = profiling.count

    def no_faded(name, value):
        assert name != "pvg.faded", "counted while off"
        count(name, value)
    with monkeypatch.context() as m:
        m.setattr(profiling, "count", no_faded)
        step()
    assert profiling.snapshot() == {}
    profiling.enable(True)
    step()
    snap = profiling.snapshot()
    profiling.enable(False)
    assert snap["pvg.temporal"]["parent"] == "step.forward"
    assert snap["pvg.temporal_bwd"]["parent"] == "step.backward"
    assert snap["pvg.faded_read"]["syncs"] == 1
    t = torch.tensor(float(TIMES[3]))
    _, op = pvg_ref.temporal(sc["bg/means"], sc["bg/opacities"],
                             sc["bg/tau"], sc["bg/s_beta"], sc["bg/velocity"],
                             t, PVG.cycle)
    faded = int(((op < 1.0 / 255.0) & sc["bg/active"]).sum())
    assert faded > 0
    assert snap["pvg.faded"] == {"count": 1, "total": faded,
                                 "parent": "pvg.faded_read"}


def test_cli_trains_evaluates_renders_and_exports_pvg(tmp_path, monkeypatch):
    """sgnt-torch-train --method pvg on a clip, then eval, render and
    export on its run directory: a temporal cloud in the checkpoint and
    the "pvg" section in config.json."""
    from test_data import write_clip

    from street_gaussians_ns_tpu_torch.scripts import eval as ev
    from street_gaussians_ns_tpu_torch.scripts import export, render, train
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    clip, run = tmp_path / "clip", tmp_path / "run"
    clip.mkdir()
    write_clip(clip)
    trainer = train.main([
        "--data", str(clip), "--device", "cpu", "--method", "pvg",
        "--pvg.cycle", "0.5", "--train-split-fraction", "0.5",
        "--trainer.output-dir", str(run),
        "--trainer.max-num-iterations", "6", "--trainer.steps-per-save", "3",
        "--trainer.background-capacity", "256",
        "--trainer.max-pairs", "16384", "--model.base.sh-degree", "1",
        "--model.base.env-map-res", "16", "--model.background.sh-degree",
        "1", "--model.background.warmup-length", "2",
        "--model.background.refine-every", "2",
        "--no-dm.undistort", "--dm.cache-workers", "2"])
    assert isinstance(trainer.state, ts.TrainState)
    assert trainer.state.store.params.temporal and trainer.state.step == 6
    assert json.loads((run / "config.json").read_text())["pvg"][
        "cycle"] == 0.5
    ckpt = np.load(run / "checkpoints" / "step-000000006.ckpt.npz")
    assert "store/background/params/velocity" in ckpt.files
    out = ev.main(["--load-dir", str(run), "--device", "cpu", "--no-lpips"])
    assert np.isfinite(out["results"]["psnr"])
    render.main(["--load-dir", str(run), "--device", "cpu", "--output-path",
                 str(run / "renders"), "--rendered-output-names", "rgb",
                 "depth"])
    assert len(list((run / "renders" / "rgb").glob("*.png"))) == 3
    assert export.main(["--load-dir", str(run), "--device", "cpu",
                        "--output-dir", str(run / "exports")])[
        "background"] > 0

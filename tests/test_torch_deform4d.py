"""4D Gaussian Splatting (models/deform4d.py, the benchmark's
deform4d_waymo3) on the CPU at a tiny size, against the plain PyTorch
reference (benchmark/reference/deform4d.py, which samples the planes by
explicit corner gathers): the encoder, decoder and heads forward, every
leaf's gradient (the planes, the decoder and the centres through the
sample coordinates), a hand check on grid nodes, the regularisers, one
step and three train steps (loss, gradients, Adam), the static warm-up,
checkpoints with the field, a refine that leaves the field alone, the
one Adam launch over every leaf, the spans and the samples counter, and
the train / eval / render / export CLIs with `--method deform4d`.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import deform4d3, pvg3, scene, waymo3
from benchmark.reference import deform4d as ref
from benchmark.reference import gs
from street_gaussians_ns_tpu_torch.core.cameras import Camera
from street_gaussians_ns_tpu_torch.engine import checkpoints as tckpt
from street_gaussians_ns_tpu_torch.engine import optimizers
from street_gaussians_ns_tpu_torch.engine import train_step as ts
from street_gaussians_ns_tpu_torch.models import deform4d as d4
from street_gaussians_ns_tpu_torch.models import refinement
from street_gaussians_ns_tpu_torch.models.gaussians import (
    GaussianParams, GaussianStore, zeros_stats)
from street_gaussians_ns_tpu_torch.models.scene_graph import SceneGraphConfig
from street_gaussians_ns_tpu_torch.models.splatfacto import SplatfactoConfig
from street_gaussians_ns_tpu_torch.ops import adam as adam_ops
from street_gaussians_ns_tpu_torch.ops.render import RenderConfig
from street_gaussians_ns_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 33 + 31                 # the benchmark's seeds exceed 32 bits
STEP = 3601
W, H, FOCAL = 64, 48, 48.0


def _config():
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      "deform4d_waymo3.json").read_text())
    cfg.update(background_capacity=2048, env_map_res=16, track_frames=6,
               plane_channels=4, plane_base_resolution=8, time_cells=5,
               net_width=16)
    return cfg


CFG = _config()
D4 = d4.Deform4DConfig(
    channels=CFG["plane_channels"], scales=list(CFG["plane_scales"]),
    base_resolution=CFG["plane_base_resolution"],
    time_cells=CFG["time_cells"], net_width=CFG["net_width"],
    static_steps=CFG["static_steps"],
    plane_tv_weight=CFG["plane_tv_weight"],
    time_smoothness_weight=CFG["time_smoothness_weight"],
    l1_time_planes_weight=CFG["l1_time_planes_weight"])
SPLAT = SplatfactoConfig(use_sky_sphere=True, sh_degree=3, env_map_res=16)
RCFG = RenderConfig(max_pairs=2 ** 16)
TIMES = waymo3.make_tracks(pvg3.clip_config(CFG), "cpu")[0]["times"]
FIELD_KEYS = ("planes", "decoder", "aabb", "time_span")


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
    params = GaussianParams(**{k: sc[f"bg/{k}"].clone()
                               for k in ts.GAUSSIAN_GROUPS})
    store = GaussianStore(params, sc["bg/active"].clone(),
                          *zeros_stats(params.capacity, dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    field = {k: sc[f"field/{k}"].clone() for k in FIELD_KEYS}
    return dataclasses.replace(ts.init_train_state(
        store, sc["env_map"].clone(), gen, field=field), step=step)


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


def _field_inputs(n, dtype, seed=0):
    """A field of CFG's sizes with rough planes, and n centres spread over
    its box and a little beyond (border-clamped samples among them)."""
    sc = deform4d3.make_scene(seed, CFG, "cpu")
    g = torch.Generator().manual_seed(seed)
    planes = sc["field/planes"] + 0.2 * torch.randn(
        sc["field/planes"].shape, generator=g)
    lo, hi = sc["field/aabb"]
    u = torch.rand((n, 3), generator=g) * 1.2 - 0.1
    means = lo + u * (hi - lo)
    return (means.to(dtype), planes.to(dtype), sc["field/decoder"].to(dtype),
            sc["field/aabb"].to(dtype), sc["field/time_span"].to(dtype))


def _port_field(means, planes, decoder, aabb, span, t):
    xh, th = d4.normalise(means, t, {"aabb": aabb, "time_span": span})
    return d4.decode(decoder, d4.encode(planes, xh, th, D4), D4)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-6)])
@pytest.mark.parametrize("t", [0.0, 3.3, 8.4])
def test_field_forward_matches_the_reference(dtype, tol, t):
    """dX, ds and dr of the encoder, decoder and heads against the
    reference's corner gathers, at the clip's ends and inside it."""
    means, planes, dec, aabb, span = _field_inputs(400, dtype)
    tt = torch.tensor(t, dtype=dtype)
    got = _port_field(means, planes, dec, aabb, span, tt)
    want = ref.field(means, planes, dec, aabb, span, tt, CFG, block=128)
    for name, x, y in zip(("dX", "ds", "dr"), got, want):
        assert x.shape == y.shape == (400, 3 if name != "dr" else 4)
        torch.testing.assert_close(x, y, rtol=0.0,
                                   atol=tol * float(y.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float64, 1e-10, 1e-12),
                                             (torch.float32, 1e-4, 2e-6)])
def test_field_gradients_match_the_reference(dtype, rtol, atol):
    """Every leaf's gradient of the field: the planes (the scattered
    samples), the decoder and the centres through the sample coordinates
    (border-clamped centres get none), against the reference's
    autograd."""
    means, planes, dec, aabb, span = _field_inputs(400, dtype, seed=1)
    leaves = [x.requires_grad_(True) for x in (means, planes, dec)]
    tt = torch.tensor(5.1, dtype=dtype)
    got = _port_field(*leaves, aabb, span, tt)
    want = ref.field(*leaves, aabb, span, tt, CFG, block=128)
    cot = [torch.randn(x.shape, dtype=dtype,
                       generator=torch.Generator().manual_seed(i))
           for i, x in enumerate(got)]
    for name, x, y in zip(("means", "planes", "decoder"),
                          torch.autograd.grad(got, leaves, cot),
                          torch.autograd.grad(want, leaves, cot)):
        top = float(y.abs().max())
        assert top > 0, name
        torch.testing.assert_close(x, y, rtol=rtol, atol=atol * top,
                                   msg=name)
    lo, hi = aabb
    out = ((means < lo) | (means > hi)).any(-1)
    g = torch.autograd.grad(_port_field(means, planes, dec, aabb, span,
                                        tt)[0].sum(), means)[0]
    assert bool(out.any())
    # Outside the box the coordinates clamp: the centre's gradient there
    # comes from the planes it does not leave, never from the clamped axis.
    axis = (means < lo) | (means > hi)
    assert not bool(g[axis].any())


def test_a_grid_node_reads_that_node():
    """A hand check: centres and a time on grid nodes read each plane's
    node exactly; with every time plane ones, a scale's feature is the
    product of its three spatial planes' nodes."""
    cfg = dataclasses.replace(D4, scales=[1], base_resolution=5,
                              time_cells=3, channels=2)
    g = torch.Generator().manual_seed(4)
    field = d4.init_field(cfg, torch.tensor([[0.0] * 3, [4.0] * 3]),
                          torch.tensor([0.0, 2.0]), g, "cpu")
    (space, time), = d4.plane_views(field["planes"], cfg)
    space.copy_(torch.rand(space.shape, generator=g))
    idx = torch.tensor([[0, 0, 0], [1, 2, 3], [4, 4, 4], [3, 0, 2]])
    xh, th = d4.normalise(idx.float(), torch.tensor(1.0), field)
    f = d4.encode(field["planes"], xh, th, cfg)
    x, y, z = idx.T
    want = space[0][:, y, x] * space[1][:, z, x] * space[2][:, z, y]
    torch.testing.assert_close(f, want, rtol=1e-6, atol=0.0)
    time.copy_(torch.rand(time.shape, generator=g))
    f = d4.encode(field["planes"], xh, th, cfg)     # t = 1: time cell 1
    want = want * time[0][:, 1, x] * time[1][:, 1, y] * time[2][:, 1, z]
    torch.testing.assert_close(f, want, rtol=1e-6, atol=0.0)


def test_regularizers_match_the_reference_and_vanish_on_flat_planes():
    _, planes, _, _, _ = _field_inputs(4, torch.float64, seed=2)
    got = d4.regularizers(planes, D4)
    assert set(got) == {"plane_tv", "time_smoothness", "l1_time_planes"}
    assert all(float(v) > 0 for v in got.values())
    want = ref.regularizers(planes, CFG)
    torch.testing.assert_close(sum(got.values()), want, rtol=1e-12, atol=0.0)
    flat = torch.ones_like(planes)
    assert all(float(v) == 0.0 for v in
               d4.regularizers(flat, D4).values())
    # A linear ramp in time: no second difference, a first one.
    views = d4.plane_views(flat, D4)
    for _, time in views:
        time.copy_(torch.linspace(0.5, 1.5, time.shape[2])[:, None]
                   .expand(time.shape[1:]).clone())
    r = d4.regularizers(flat, D4)
    assert float(r["time_smoothness"]) < 1e-12
    assert float(r["l1_time_planes"]) > 0


def test_step_loss_and_gradients_match_the_reference():
    """One 4DGS step's loss (the image's and the regularisers) and every
    leaf's gradient, the planes and the decoder among them, against the
    reference's autograd through the same cloud, field, camera time,
    target and sky jitter."""
    sc = deform4d3.make_scene(SEED, CFG, "cpu")
    state = _state(sc)
    g = 2 * waymo3.frames(CFG) + 3          # camera 3, frame 3
    cam, rcam = _cameras(g)
    batch, jitter = _batch(g), _jitter()
    total, losses, _, _, grads = ts.loss_and_grads(
        state, cam, batch, SPLAT, RCFG, jitter=jitter, deform4d=D4)
    assert {"plane_tv", "time_smoothness", "l1_time_planes"} <= set(losses)
    names = ref.leaf_names(sc)
    leaves = {k: sc[k].clone().requires_grad_(True) for k in names}
    fixed = {k: sc[k] for k in sc if k not in names}
    out = ref.forward({**leaves, **fixed}, rcam, 3, CFG, True, jitter)
    loss = gs.loss(out, batch["image"], batch["semantic"]) + \
        ref.regularizers(leaves["field/planes"], CFG)
    want = torch.autograd.grad(loss, [leaves[k] for k in names])
    assert abs(float(total) - float(loss.detach())) <= 2e-6 * float(
        loss.detach())
    for k, w in zip(names, want):
        part, leaf = k.split("/") if "/" in k else (k, k)
        got = (grads["env_map"] if k == "env_map" else
               grads["field"][leaf] if part == "field" else
               grads["params"][leaf])
        top = float(w.abs().max())
        assert top > 0, k
        torch.testing.assert_close(got, w, rtol=1e-4, atol=2e-5 * top,
                                   msg=k)


def test_three_train_steps_match_the_reference():
    """Three whole train steps, one image of each camera at its time:
    each step's loss, every leaf's first gradient as Adam got it and each
    leaf's change after the three Adam steps, against reference_steps."""
    sc = deform4d3.make_scene(SEED + 1, CFG, "cpu")
    state = _state(sc)
    frames = [4, waymo3.frames(CFG) + 1, 2 * waymo3.frames(CFG) + 5]
    steps, losses = [], []
    for i, g in enumerate(frames):
        cam, rcam = _cameras(g)
        batch, jitter = _batch(g), _jitter(i)
        steps.append((STEP + i, rcam, batch["image"], batch["semantic"],
                      jitter))
        state, m = ts.train_step(state, cam, batch, SPLAT, RCFG,
                                 jitter=jitter, deform4d=D4)
        losses.append(float(m["loss"]))
        if i == 0:
            first = {k: float(torch.linalg.vector_norm(v.mu / 0.1))
                     for k, v in state.opt.items()}
    want = ref.reference_steps(sc, steps, 3, CFG, block=512)
    for a, b in zip(losses, want["losses"]):
        assert abs(a - b) <= 2e-6 * abs(b)
    group = {f"bg/{k}": k for k in ts.GAUSSIAN_GROUPS}
    group.update({"env_map": "sky_sphere", "field/planes": "field_planes",
                  "field/decoder": "field_decoder"})
    for k, name in group.items():
        assert want["first_grad"][k] > 0, k
        assert abs(first[name] - want["first_grad"][k]) <= 1e-4 * \
            want["first_grad"][k], k
        if k == "env_map":
            now = state.env_map
        elif k.startswith("field/"):
            now = state.field[k.split("/")[1]]
        else:
            now = getattr(state.store.params, k.split("/")[1])
        n = float(torch.linalg.vector_norm(now - sc[k]))
        assert abs(n - want["change"][k]) <= 5e-3 * want["change"][k], k
    assert state.step == STEP + 3
    assert torch.equal(state.field["aabb"], sc["field/aabb"])


def test_before_the_warm_up_ends_the_cloud_renders_as_it_is():
    """Before static_steps the field is not run: no spans, zero gradients
    for its leaves, no regulariser, the render of the canonical cloud."""
    sc = deform4d3.make_scene(SEED, CFG, "cpu")
    early = _state(sc, step=D4.static_steps - 1)
    cam, _ = _cameras(3)
    profiling.enable(True)
    total, losses, out, _, grads = ts.loss_and_grads(
        early, cam, _batch(3), SPLAT, RCFG, jitter=_jitter(), deform4d=D4)
    snap = profiling.snapshot()
    profiling.enable(False)
    assert "deform4d.field" not in snap
    assert not any(k in losses for k in ("plane_tv", "l1_time_planes"))
    assert not grads["field"]["planes"].any()
    assert not grads["field"]["decoder"].any()
    plain = dataclasses.replace(early, field=None)
    t2, _, out2, _, _ = ts.loss_and_grads(plain, cam, _batch(3), SPLAT, RCFG,
                                          jitter=_jitter())
    assert torch.equal(out["rgb"], out2["rgb"]) and float(total) == float(t2)


def test_checkpoint_round_trip_with_the_field(tmp_path):
    """A 4DGS train state written and read back: the cloud, the field's
    four tensors, its two Adam groups and every other group, the step and
    the generator."""
    state = _state(deform4d3.make_scene(SEED, CFG, "cpu"))
    state = dataclasses.replace(state, opt={
        k: dataclasses.replace(s, mu=s.mu + 1.0, nu=s.nu + 2.0, count=7)
        for k, s in state.opt.items()})
    path = tckpt.save_checkpoint(tmp_path, 9, state)
    keys = set(np.load(path).files)
    assert {"store/field/planes", "store/field/decoder", "store/field/aabb",
            "store/field/time_span", "opt/field_planes/mu",
            "opt/field_decoder/nu", "opt/field_planes/count"} <= keys
    target = _state(deform4d3.make_scene(SEED + 5, CFG, "cpu"), step=0)
    got = tckpt.restore_checkpoint(path, target)
    assert got.step == STEP
    for k in FIELD_KEYS:
        assert torch.equal(got.field[k], state.field[k]), k
    for k, s in state.opt.items():
        assert torch.equal(got.opt[k].mu, s.mu) and got.opt[k].count == 7, k
        assert torch.equal(got.opt[k].nu, s.nu), k
    for k in ts.GAUSSIAN_GROUPS:
        assert torch.equal(getattr(got.store.params, k),
                           getattr(state.store.params, k)), k
    assert torch.equal(got.generator.get_state(),
                       state.generator.get_state())
    small = dataclasses.replace(D4, time_cells=D4.time_cells + 1)
    bigger = dict(target.field, planes=torch.zeros(sum(
        int(np.prod(s)) for pair in d4.plane_shapes(small) for s in pair)))
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore_checkpoint(path, dataclasses.replace(target,
                                                           field=bigger))


def test_refine_carries_the_six_leaves_and_leaves_the_field():
    """A refine of a 4DGS state: its store refines as the same store
    without a field does (bit for bit), the field and its two Adam groups
    come back as the very tensors they were."""
    sc = deform4d3.make_scene(SEED + 2, CFG, "cpu")
    state = _state(sc, step=601)
    n = CFG["background_capacity"]
    g = torch.Generator().manual_seed(3)
    small = (torch.arange(n) % 2 == 0)[:, None]
    params = dataclasses.replace(state.store.params, scales=torch.where(
        small, state.store.params.scales - 3.0, state.store.params.scales))
    store = GaussianStore(params, state.store.active,
                          torch.rand(n, generator=g) * 4e-4, torch.ones(n),
                          torch.rand(n, generator=g) * 0.1)
    state = dataclasses.replace(state, store=store)
    cfg = dataclasses.replace(SceneGraphConfig().background,
                              refine_parent_cap_div=4)
    noise = torch.randn((2, refinement.parent_budget(cfg, n), 3),
                        generator=torch.Generator().manual_seed(1))
    new, info = ts.refine_step(state, cfg, 10, W, noise=noise)
    plain = dataclasses.replace(state, field=None, opt={
        k: v for k, v in state.opt.items() if not k.startswith("field_")})
    want, _ = ts.refine_step(plain, cfg, 10, W, noise=noise)
    assert int(info["refine_splits_count"]) > 0
    assert int(info["refine_dups_count"]) > 0
    assert list(new.store.params.as_dict()) == list(ts.GAUSSIAN_GROUPS)
    for k in ts.GAUSSIAN_GROUPS:
        assert torch.equal(getattr(new.store.params, k),
                           getattr(want.store.params, k)), k
        assert torch.equal(new.opt[k].mu, want.opt[k].mu), k
    assert torch.equal(new.store.active, want.store.active)
    for k in FIELD_KEYS:
        assert new.field[k] is state.field[k], k
    for k in ("field_planes", "field_decoder"):
        assert new.opt[k] is state.opt[k], k


def test_one_adam_launch_steps_every_leaf(monkeypatch):
    """The card's path (`_step_kernel`) run on the CPU with kernel K
    replaced by a counting stand-in: a 4DGS step makes one launch whose
    table holds all 9 leaves (6 gaussian, the sky, the planes, the
    decoder; within ops.adam.MAX_LEAVES), the field's flat leaves whole
    and unmasked, and the step's result equals the CPU's plain Adam."""
    sc = deform4d3.make_scene(SEED + 3, CFG, "cpu")
    cam, _ = _cameras(2)
    want, _ = ts.train_step(_state(sc), cam, _batch(2), SPLAT, RCFG,
                            jitter=_jitter(), deform4d=D4)
    tables = []

    def launch(table):
        tables.append(table)
        out = []
        for p, g, m, v, act, h in table:
            lr, b1, ob1, b2, ob2, eps, ic1, ic2 = (float(x) for x in h)
            if act is not None:
                g = optimizers.mask_rows(g, act)
            m2 = b1 * m + ob1 * g
            v2 = b2 * v + ob2 * (g * g)
            out.append((p - lr * (m2 * ic1) / (torch.sqrt(v2 * ic2) + eps),
                        m2, v2))
        return out
    monkeypatch.setattr(optimizers, "adam_leaves", launch)
    monkeypatch.setattr(optimizers, "_step_plain", optimizers._step_kernel)
    got, _ = ts.train_step(_state(sc), cam, _batch(2), SPLAT, RCFG,
                           jitter=_jitter(), deform4d=D4)
    assert len(tables) == 1
    table = tables[0]
    assert len(table) == 9 <= adam_ops.MAX_LEAVES
    field_rows = [r for r in table if r[0].numel() in (
        sc["field/planes"].numel(), sc["field/decoder"].numel())]
    assert len(field_rows) == 2 and all(r[4] is None for r in field_rows)
    for k in d4.FIELD_GROUPS:
        torch.testing.assert_close(got.field[k], want.field[k], rtol=1e-6,
                                   atol=1e-7)
    for k in ts.GAUSSIAN_GROUPS:
        torch.testing.assert_close(getattr(got.store.params, k),
                                   getattr(want.store.params, k), rtol=1e-6,
                                   atol=1e-7)


def test_spans_and_the_samples_counter_record_only_while_tracing():
    """Off: no span, no counter, no mark in the graph. On: deform4d.field
    and deform4d.decode in the forward, deform4d.field_bwd once in the
    backward, and deform4d.samples = slots x 6 x scales a step."""
    sc = deform4d3.make_scene(SEED, CFG, "cpu")
    cam, _ = _cameras(3)

    def step():
        return ts.train_step(_state(sc), cam, _batch(3), SPLAT, RCFG,
                             jitter=_jitter(), deform4d=D4)
    step()
    assert profiling.snapshot() == {}
    profiling.enable(True)
    step()
    snap = profiling.snapshot()
    profiling.enable(False)
    assert snap["deform4d.field"]["parent"] == "step.forward"
    assert snap["deform4d.decode"]["parent"] == "step.forward"
    assert snap["deform4d.field_bwd"]["parent"] == "step.backward"
    for k in ("deform4d.field", "deform4d.decode", "deform4d.field_bwd"):
        assert snap[k]["count"] == 1, k
    n = CFG["background_capacity"] * 6 * len(CFG["plane_scales"])
    assert snap["deform4d.samples"] == {"count": 1, "total": n,
                                        "parent": "step.forward"}


def test_the_trainer_builds_a_field_over_the_seeds_and_the_clip(tmp_path):
    """Trainer(deform4d=...): the field's box is the seed cloud's bounds,
    its time span the clip's, its planes K-Planes' fresh ones; a step
    before the warm-up's end moves no field leaf."""
    from test_data import write_clip

    from street_gaussians_ns_tpu_torch.data.datamanager import \
        DataManagerConfig
    from street_gaussians_ns_tpu_torch.data.dataparser import \
        DataParserConfig
    from street_gaussians_ns_tpu_torch.engine import trainer as tm
    clip = tmp_path / "clip"
    clip.mkdir()
    write_clip(clip)
    t = tm.Trainer(
        DataParserConfig(data=clip, train_split_fraction=0.5),
        SceneGraphConfig(base=SplatfactoConfig(env_map_res=16,
                                               sh_degree=1)),
        tm.TrainerConfig(output_dir=tmp_path / "run",
                         background_capacity=256, max_pairs=16384),
        DataManagerConfig(undistort=False, cache_workers=2), device="cpu",
        deform4d=D4)
    f, store = t.state.field, t.state.store
    live = store.params.means[store.active]
    assert torch.equal(f["aabb"], torch.stack([live.amin(0), live.amax(0)]))
    times = np.asarray(t.scene.times, np.float32)
    assert f["time_span"].tolist() == [float(times.min()),
                                       float(times.max())]
    for space, time in d4.plane_views(f["planes"], D4):
        assert 0.1 <= float(space.min()) and float(space.max()) <= 0.5
        assert bool((time == 1.0).all())
    assert sorted(t.state.opt) == sorted(
        ts.GAUSSIAN_GROUPS + ("sky_sphere", "field_planes", "field_decoder"))
    planes = f["planes"].clone()
    t._iteration(0)
    assert torch.equal(t.state.field["planes"], planes)


def test_cli_trains_evaluates_renders_and_exports_deform4d(tmp_path,
                                                           monkeypatch):
    """sgnt-torch-train --method deform4d on a clip (the field live from
    step 2), then eval, render and export on its run directory: the field
    in the checkpoint, the "deform4d" section in config.json, the
    canonical cloud and the field exported; a mesh is refused."""
    from test_data import write_clip

    from street_gaussians_ns_tpu_torch.scripts import eval as ev
    from street_gaussians_ns_tpu_torch.scripts import export, render, train
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    clip, run = tmp_path / "clip", tmp_path / "run"
    clip.mkdir()
    write_clip(clip)
    flags = [
        "--data", str(clip), "--device", "cpu", "--method", "deform4d",
        "--deform4d.static-steps", "2", "--deform4d.channels", "4",
        "--deform4d.scales", "1", "2", "--deform4d.base-resolution", "8",
        "--deform4d.time-cells", "3", "--train-split-fraction", "0.5",
        "--trainer.output-dir", str(run),
        "--trainer.max-num-iterations", "6", "--trainer.steps-per-save", "3",
        "--trainer.background-capacity", "256",
        "--trainer.max-pairs", "16384", "--model.base.sh-degree", "1",
        "--model.base.env-map-res", "16", "--model.background.sh-degree",
        "1", "--model.background.warmup-length", "2",
        "--model.background.refine-every", "2",
        "--no-dm.undistort", "--dm.cache-workers", "2"]
    with pytest.raises(SystemExit, match="deform4d trains on one device"):
        train.main(flags + ["--mesh-data", "1"])
    trainer = train.main(flags)
    assert isinstance(trainer.state, ts.TrainState)
    assert trainer.state.field is not None and trainer.state.step == 6
    cfg = json.loads((run / "config.json").read_text())["deform4d"]
    assert cfg["scales"] == [1, 2] and cfg["static_steps"] == 2
    ckpt = np.load(run / "checkpoints" / "step-000000006.ckpt.npz")
    assert "store/field/planes" in ckpt.files
    saved = torch.from_numpy(ckpt["store/field/planes"])
    out = ev.main(["--load-dir", str(run), "--device", "cpu", "--no-lpips"])
    assert np.isfinite(out["results"]["psnr"])
    render.main(["--load-dir", str(run), "--device", "cpu", "--output-path",
                 str(run / "renders"), "--rendered-output-names", "rgb",
                 "depth"])
    assert len(list((run / "renders" / "rgb").glob("*.png"))) == 3
    counts = export.main(["--load-dir", str(run), "--device", "cpu",
                          "--output-dir", str(run / "exports")])
    assert counts["background"] > 0
    with np.load(run / "exports" / "deformation_field.npz") as z:
        assert np.array_equal(z["planes"], saved.numpy())
        assert counts["field"] == z["planes"].size + z["decoder"].size
        assert json.loads(str(z["config"]))["time_cells"] == 3

"""The three-camera Waymo-segment configuration (the benchmark's
scene_graph_waymo3) on the CPU at a tiny size, with seeded random
weights: a clip of three front cameras written by the benchmark's own
writer and parsed through `DataParserConfig(filter_camera_id=...,
frame_select=...)`, and the port's scene-graph step with the tracked
boxes' deltas trained (`SceneGraphConfig.bbox_differentiable`) against
the plain PyTorch reference of tracked-pose optimisation
(benchmark/reference/gs_posed.py): the loss, every leaf's gradient (the
(F, O) deltas' among them, non-zero) and one Adam step. Also the split
and the camera order the benchmark's `train_waymo3` module expects. No
JAX here.
"""
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import waymo3
from benchmark.drivers import train_waymo3
from benchmark.reference import gs, gs_posed
from street_gaussians_ns_tpu_torch.core.cameras import Camera
from street_gaussians_ns_tpu_torch.data.datamanager import (
    DataManagerConfig, FullImageDatamanager)
from street_gaussians_ns_tpu_torch.data.dataparser import parse_scene
from street_gaussians_ns_tpu_torch.engine.optimizers import (DEFAULT_GROUPS,
                                                             schedule)
from street_gaussians_ns_tpu_torch.engine.scene_train_step import (
    BBOX_PARAMS, init_scene_train_state, scene_loss_and_grads,
    scene_train_step)
from street_gaussians_ns_tpu_torch.models.gaussians import (GaussianParams,
                                                            GaussianStore)
from street_gaussians_ns_tpu_torch.models.scene_graph import (
    SceneGraphConfig, SceneGraphStore)
from street_gaussians_ns_tpu_torch.models.splatfacto import SplatfactoConfig
from street_gaussians_ns_tpu_torch.ops.render import RenderConfig

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 33 + 17                 # the benchmark's seeds exceed 32 bits
STEP = 3601
GROUPS = ("means", "scales", "quats", "features_dc", "features_rest",
          "opacities")


def _config():
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      "scene_graph_waymo3.json").read_text())
    cfg.update(background_capacity=1536, object_capacity=192, objects=3,
               env_map_res=16, track_frames=5, seed_points=1200,
               lidar_points_per_object=10001,
               vehicle_stretches=[[0, 4], [1, 4], [2, 3]])
    return cfg


CFG = _config()
TRAFFIC = {"width": 64, "height": 48, "focal": 48.0, "image_block": 8,
           "start_step": STEP, "check_steps": 3, "check_vehicles": 1}
F = CFG["track_frames"]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """The cell's inputs as `train_waymo3` writes them (the clip and the
    resume checkpoint), and the clip parsed as its trainer parses it."""
    drv = train_waymo3.Driver(CFG, TRAFFIC, SEED, "cpu",
                              tmp_path_factory.mktemp("waymo3"))
    drv._write_inputs()
    parsed = parse_scene(drv.data_config(), device="cpu")
    return drv, parsed


def test_split_and_camera_order(clip):
    drv, parsed = clip
    n = 3 * F
    assert parsed.num_frames == n
    # Sorted by (camera id, time): image g is camera g // F at frame g % F.
    assert list(parsed.camera_ids) == [1] * F + [2] * F + [3] * F
    for g in range(n):
        assert parsed.image_paths[g].parent.name == f"cam{g // F + 1}"
        np.testing.assert_allclose(parsed.c2w[g], waymo3.c2w(CFG, g),
                                   atol=1e-6)
        assert parsed.times[g] == drv.tracks["times"][g % F].item()
    k = math.ceil(0.9 * n)
    assert list(parsed.train_indices) == list(drv.train_frames)
    assert len(parsed.train_indices) == k
    assert sorted(set(parsed.train_indices) | set(parsed.eval_indices)) == \
        list(range(n))
    # The checkpoint's sampler pops the check frames first, one a camera.
    assert sorted(g // F for g in drv.check_frames) == [0, 1, 2]
    assert all(waymo3.vehicles_in_view(CFG, TRAFFIC, drv.tracks, g) >= 1
               for g in drv.check_frames)
    ckpt = np.load(next((drv.workdir / "run" / "checkpoints").iterdir()))
    order = list(ckpt["dm/train_order"])
    assert order[::-1][:3] == drv.check_frames
    assert sorted(order) == list(parsed.train_indices)


def test_parsed_tracks_are_the_benchmarks(clip):
    drv, parsed = clip
    tr, ref = parsed.tracks, drv.tracks
    assert parsed.annotations.track_ids == [f"veh{o}" for o in range(3)]
    assert torch.equal(tr.valid, ref["valid"])
    assert torch.equal(tr.times, ref["times"])
    assert torch.equal(tr.obj_first, ref["obj_first"])
    assert torch.equal(tr.obj_last, ref["obj_last"])
    torch.testing.assert_close(tr.centers, ref["centers"], rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(tr.quats, ref["quats"], rtol=0, atol=1e-6)


def _store(sc: dict) -> SceneGraphStore:
    def part(p):
        act = sc[f"{p}/active"]
        z = torch.zeros(act.shape)
        return GaussianStore(
            params=GaussianParams(**{g: sc[f"{p}/{g}"] for g in GROUPS}),
            active=act, xys_grad_norm=z, vis_counts=z.clone(),
            max_2dsize=z.clone())
    return SceneGraphStore(background=part("bg"), objects=part("obj"),
                           env_map=sc["env_map"],
                           delta_center=sc["delta_center"],
                           delta_yaw=sc["delta_yaw"],
                           delta_rot=sc["delta_rot"])


def _port_grads(grads: dict) -> dict:
    out = {f"{p}/{g}": grads["gauss"][g][p] for g in GROUPS
           for p in ("bg", "obj")}
    out["env_map"] = grads["env_map"]
    out.update({k: grads["bbox"][k] for k in gs_posed.DELTAS})
    return out


def _masked(sc, k, g):
    if "/" not in k:
        return g
    act = sc[k.split("/")[0] + "/active"]
    return torch.where(act.reshape(act.shape + (1,) * (g.dim() - act.dim())),
                       g, torch.zeros_like(g))


@pytest.mark.parametrize("g", [1, 7, 13])
def test_step_with_tracked_pose_matches_the_reference(clip, g):
    """One step on image g (cameras FRONT, FRONT_LEFT, FRONT_RIGHT): the
    loss, each leaf's gradient and the Adam step of the port equal the
    plain reference's."""
    drv, parsed = clip
    sc = waymo3.make_scene(SEED, CFG, "cpu")
    dm = FullImageDatamanager(parsed, DataManagerConfig(cache_workers=1),
                              device="cpu")
    frame = dm._cache[g]
    cam = Camera.make(frame.fx, frame.fy, frame.cx, frame.cy, frame.c2w,
                      frame.width, frame.height, time=frame.time,
                      device="cpu")
    batch = {"image": torch.as_tensor(frame.image),
             "semantic": torch.as_tensor(frame.semantic)}
    jitter = torch.rand((2, 48, 64), generator=torch.Generator().manual_seed(
        g))
    config = SceneGraphConfig(
        base=SplatfactoConfig(use_sky_sphere=True, sh_degree=3,
                              env_map_res=16),
        bbox_mode="simple", bbox_differentiable=True)
    rcfg = RenderConfig(max_pairs=2 ** 16)
    state = dataclasses.replace(
        init_scene_train_state(_store(sc), torch.Generator()), step=STEP)
    loss, _, _, _, grads = scene_loss_and_grads(
        state, parsed.tracks, cam, batch, config, rcfg, subset_accs=False,
        jitter=jitter)
    got = _port_grads(grads)

    names = gs_posed.leaf_names(sc)
    leaves = {k: sc[k].clone().requires_grad_(True) for k in names}
    out = gs_posed.forward({**sc, **leaves}, drv.tracks,
                           waymo3.camera(CFG, TRAFFIC, drv.tracks, g, "cpu"),
                           3, training=True, jitter=jitter)
    ref_loss = gs.loss(out, batch["image"], batch["semantic"])
    ref = dict(zip(names, torch.autograd.grad(ref_loss, list(
        leaves.values()))))
    assert float(loss) == pytest.approx(float(ref_loss.detach()), rel=2e-6)
    for k in names:
        a, b = _masked(sc, k, got[k]), _masked(sc, k, ref[k])
        top = float(b.abs().max())
        assert top > 0, k
        assert float((a - b).abs().max()) <= 2e-4 * top, k
    f = g % F
    d = ref["delta_center"]
    assert float(d[f].abs().sum()) > 0 and float(ref["delta_yaw"][f]
                                                 .abs().sum()) > 0
    assert float(d[[i for i in range(F) if i != f]].abs().sum()) == 0

    # One Adam step: the port's update is gs.adam of its own gradient at
    # each group's rate, and moves each leaf as far as the reference's.
    new, _ = scene_train_step(state, parsed.tracks, cam, batch, config,
                              rcfg, subset_accs=False, jitter=jitter)
    p1 = {f"{p}/{gr}": getattr(getattr(new.store, part).params, gr)
          for gr in GROUPS for p, part in (("bg", "background"),
                                           ("obj", "objects"))}
    p1["env_map"] = new.store.env_map
    p1.update({k: getattr(new.store, k) for k in gs_posed.DELTAS})
    assert torch.equal(new.store.delta_rot, sc["delta_rot"])
    for k in names:
        group = k.split("/")[-1]
        lr = gs.lr_at(group, STEP)
        cfg_name = ("sky_sphere" if k == "env_map" else "bbox_opt"
                    if k in BBOX_PARAMS else group)
        assert lr == schedule(DEFAULT_GROUPS[cfg_name], STEP)
        zero = torch.zeros_like(sc[k])
        want, _, _ = gs.adam(sc[k], _masked(sc, k, got[k]), zero, zero, 1,
                             lr)
        torch.testing.assert_close(p1[k], want, rtol=0, atol=1e-6)
        ref_p, _, _ = gs.adam(sc[k], _masked(sc, k, ref[k]), zero, zero, 1,
                              lr)
        moved = float(torch.linalg.vector_norm(p1[k] - sc[k]))
        ref_moved = float(torch.linalg.vector_norm(ref_p - sc[k]))
        assert moved == pytest.approx(ref_moved, rel=1e-3), k

"""The three-camera Waymo cell (sgw3_train_s3600) on the CPU at tiny
sizes: it runs as files, its traced run reports the pose span's and the
pair counter's readers (no device time off the card), its sampler starts
on three cameras, and its reference (reference/gs_posed.py) agrees with
reference/gs.py where the deltas' gradient plays no part."""
from __future__ import annotations

import json
import shutil

import pytest
import torch

from benchmark import run as R
from benchmark import scene, waymo3
from benchmark.reference import gs, gs_posed
from benchmark.tests import tiny

CELL = "sgw3_train_s3600"


def shrink(cfg: dict, traffic: dict) -> None:
    """Three cameras of 64x48 over 6 frames, two vehicles, 2,048
    background slots."""
    cfg.update(background_capacity=2048, object_capacity=256, objects=2,
               env_map_res=16, track_frames=6, seed_points=1500,
               lidar_points_per_object=10001,
               vehicle_stretches=[[0, 5], [2, 5]])
    traffic.update(width=64, height=48, focal=48.0, image_block=8,
                   check_vehicles=1)


def found(root=R.ROOT):
    spec = R.load_spec(root)
    f = R.find_cell(spec, CELL, root)
    shrink(f["config"], f["traffic"])
    return spec, f


def test_the_cell_runs_as_files_and_reports_its_metrics(tmp_path,
                                                       monkeypatch):
    """The cell's files copied beside the program run it: correct, the
    end-to-end metrics untraced, the span and counter readers traced. The
    reference, run in set-up, leaves the program's TF32 settings as it
    found them; the live background is reported at the window's ends."""
    shutil.copytree(R.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(R.ROOT / "BENCHMARK.json", tmp_path)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    spec, f = found(tmp_path)
    r0 = R.run(CELL, tiny.SEED, 0.5, False, device="cpu", spec=spec,
               found=f, root=tmp_path, log=lambda *a: None)
    assert r0["correct"], r0["checks"]
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    assert set(r0["metrics"]) == {"train_steps_per_s", "peak_mem_gib",
                                  "setup_s"}
    detail = r0["detail"]
    assert "delta_center" not in detail["left_out"]
    assert "delta_yaw" not in detail["left_out"]
    assert len({g // 6 for g in detail["frames"]}) == 3
    start, end = detail["bg_live"]
    assert start == 2048 * 3 // 4 and 0 < end <= start
    spec, f = found(tmp_path)
    r1 = R.run(CELL, tiny.SEED + 1, 0.5, True, device="cpu", spec=spec,
               found=f, root=tmp_path, trace_units=2, log=lambda *a: None)
    assert r1["correct"], r1["checks"]
    m = r1["metrics"]
    assert m["render.pairs_m.train"]["value"] > 0
    assert m["program.host_syncs.train"]["value"] > 0
    assert "scene.pose_ms.train" not in m        # no card, no device time


def test_the_unchanged_step_fails_the_check():
    spec, f = found()
    r = R.run(CELL, 5, 0.3, False, device="cpu", spec=spec, found=f,
              log=lambda *a: None, fault="unchanged")
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] > 0.5


def _scene():
    spec, f = found()
    cfg, traffic = f["config"], f["traffic"]
    sc = waymo3.make_scene(3, cfg, "cpu")
    tracks, _ = waymo3.make_tracks(cfg, "cpu")
    return cfg, traffic, sc, tracks


@pytest.mark.parametrize("g", [0, 8, 15])
def test_posed_reference_agrees_with_gs_where_deltas_play_no_part(g):
    """Forward values equal gs.forward's; the gradients of every leaf but
    the deltas equal gs's (which detaches them); the deltas get a
    gradient wherever a vehicle is in view at an annotated frame."""
    cfg, traffic, sc, tracks = _scene()
    cam = waymo3.camera(cfg, traffic, tracks, g, "cpu")
    img = waymo3.target_image(3, g, traffic["width"], traffic["height"], 8,
                              "cpu")
    sem = scene.semantic_map(traffic["width"], traffic["height"], "cpu")
    jitter = torch.rand((2, traffic["height"], traffic["width"]),
                        generator=scene.generator(7, "cpu"))
    names = gs_posed.leaf_names(sc)
    grads, losses = [], []
    for fwd in (gs.forward, gs_posed.forward):
        leaves = {k: sc[k].clone().requires_grad_(True) for k in names}
        p = {**sc, **leaves}
        out = fwd(p, tracks, cam, 3, training=True, jitter=jitter)
        loss = gs.loss(out, img, sem)
        gr = torch.autograd.grad(loss, [leaves[k] for k in names],
                                 allow_unused=True)
        grads.append(dict(zip(names, gr)))
        losses.append(float(loss.detach()))
    assert losses[0] == pytest.approx(losses[1], rel=1e-6, abs=0)
    for k in names:
        if k in gs_posed.DELTAS:
            assert grads[0][k] is None
            continue
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-5,
                                   atol=1e-9)
    f = g % cfg["track_frames"]
    assert float(grads[1]["delta_center"][f].abs().sum()) > 0
    others = [i for i in range(cfg["track_frames"]) if i != f]
    assert float(grads[1]["delta_center"][others].abs().sum()) == 0


def test_blocked_compositor_equals_the_whole():
    """Blocks of whole tiles under checkpointing give gs.composite's image,
    transmittance and counts, and the same gradients."""
    cfg, traffic, sc, tracks = _scene()
    cam = waymo3.camera(cfg, traffic, tracks, 4, "cpu")
    means, scales, quats, dc, rest, opl, active, _ = gs.flat_scene(
        sc, tracks, cam["time"])
    op = torch.where(active, torch.sigmoid(opl[:, 0]), torch.zeros(()))
    xys, depth, conics, visible, box, q = gs.project(
        means, torch.exp(scales), quats, op, cam)
    W, H = cam["width"], cam["height"]
    gp, starts = gs.tile_pairs(xys, depth, conics, visible & active, box, q,
                               -(-W // 16), -(-H // 16))
    assert len(gs_posed.tile_blocks(starts, 64)) > 2
    colors = torch.rand((means.shape[0], 4), generator=scene.generator(
        1, "cpu"))
    outs = []
    for fn in (lambda *a: gs.composite(*a, W, H),
               lambda *a: gs_posed.composite(*a, W, H, block_pairs=64)):
        x = [t.detach().clone().requires_grad_(True)
             for t in (xys, conics, op, colors)]
        img, T, ev, co = fn(*x, gp, starts)
        g = torch.autograd.grad((img * img).sum() + T.sum(), x)
        outs.append((img, T, int(ev), int(co), g))
    (i0, t0, e0, c0, g0), (i1, t1, e1, c1, g1) = outs
    assert (e0, c0) == (e1, c1)
    torch.testing.assert_close(i1, i0, rtol=0, atol=1e-6)
    torch.testing.assert_close(t1, t0, rtol=0, atol=1e-7)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_tracks_and_cameras():
    """Vehicles are valid over their stretches only; the three cameras
    share the ego's position at each frame and differ by their yaw."""
    cfg = json.loads((R.HERE / "configs" / "scene_graph_waymo3.json")
                     .read_text())
    tracks, stamps = waymo3.make_tracks(cfg, "cpu")
    valid = tracks["valid"]
    for o, (f0, f1) in enumerate(cfg["vehicle_stretches"]):
        assert 30 <= f1 - f0 + 1 <= 85
        assert valid[f0:f1 + 1, o].all() and valid[:, o].sum() == f1 - f0 + 1
    assert (valid.sum(1) < cfg["objects"]).any()
    F = cfg["track_frames"]
    for f in (0, 40, 84):
        poses = [waymo3.c2w(cfg, c * F + f) for c in range(3)]
        for p in poses:
            assert p[2, 3] == -float(f)
        # FRONT looks down -z, FRONT_LEFT towards -x, FRONT_RIGHT +x.
        look = [-p[:, 2] for p in poses]
        assert look[0][2] == -1.0 and look[1][0] < 0 < look[2][0]
    assert waymo3.image_count(cfg) == 255


def test_new_readers_find_nothing_without_the_recorder(monkeypatch):
    """On a program without the recorder's snapshot (the parent of the
    pose span and the pair counter) the two new readers give nothing."""
    from street_gaussians_ns_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "snapshot")
    for name in ("scene.pose_ms.train", "render.pairs_m.train"):
        assert R.load_reader(name)({"kind": "train", "units": 2}) is None


def test_new_readers_without_the_span_or_counter():
    """A snapshot without the pose span or the pair counter (a program
    that has the recorder but not these) gives nothing either."""
    from street_gaussians_ns_tpu_torch.utils import profiling
    profiling.reset()
    for name in ("scene.pose_ms.train", "render.pairs_m.train"):
        assert R.load_reader(name)({"kind": "train", "units": 2}) is None

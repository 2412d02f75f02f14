"""The port's data layer (street_gaussians_ns_tpu_torch.data, .native,
.utils.optional) against the JAX package's on the clips of
tests/test_data.write_clip, on the CPU.

Tolerances: the readers, the annotation database, the split, the frames
and the datamanager's order are the same numpy code on the same bytes, so
they are compared exactly; the parsed poses and intrinsics at rtol 1e-6
(the same float64 numpy arithmetic, rounded to float32); the object
tracks, built by numpy in both packages and handed to a tensor library,
exactly."""
import dataclasses
import json
import struct
import sys

import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.data import annotations as jann
from street_gaussians_ns_tpu.data import colmap_io as jcol
from street_gaussians_ns_tpu.data import datamanager as jdm
from street_gaussians_ns_tpu.data import dataparser as jdp
from street_gaussians_ns_tpu.data import dataset as jds
from street_gaussians_ns_tpu.data import fisheye624 as jfe
from street_gaussians_ns_tpu.data import pcd_io as jpcd
from street_gaussians_ns_tpu.data import ply_io as jply
from street_gaussians_ns_tpu_torch import native as tnative
from street_gaussians_ns_tpu_torch.data import annotations as tann
from street_gaussians_ns_tpu_torch.data import colmap_io as tcol
from street_gaussians_ns_tpu_torch.data import datamanager as tdm
from street_gaussians_ns_tpu_torch.data import dataparser as tdp
from street_gaussians_ns_tpu_torch.data import dataset as tds
from street_gaussians_ns_tpu_torch.data import fisheye624 as tfe
from street_gaussians_ns_tpu_torch.data import pcd_io as tpcd
from street_gaussians_ns_tpu_torch.data import ply_io as tply
from street_gaussians_ns_tpu_torch.utils import optional

import chip_smoke
from test_data import TestFisheye624, write_clip, write_colmap_binary
from test_torch_preprocess import TINY_RAW


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clip")
    write_clip(tmp)
    return tmp


def _assert_same(got, want, msg=""):
    """Equal values of the same type, through dataclasses, dicts, lists,
    arrays and tensors (a JAX array or a torch tensor compares as its
    numpy array)."""
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            _assert_same(getattr(got, f.name), getattr(want, f.name),
                         f"{msg}.{f.name}")
    elif isinstance(want, dict):
        assert list(got) == list(want), msg
        for k in want:
            _assert_same(got[k], want[k], f"{msg}[{k}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{msg}[{i}]")
    elif hasattr(want, "shape"):
        g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        w = np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (msg, g.dtype,
                                                          w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=msg)
    else:
        assert got == want, (msg, got, want)


# ---------------------------------------------------------------- readers

def _write_colmap_text(src, dst):
    """The text form of a binary COLMAP model read by the JAX package."""
    dst.mkdir(parents=True, exist_ok=True)
    cams = jcol.read_cameras_binary(src / "cameras.bin")
    with open(dst / "cameras.txt", "w") as f:
        f.write("# CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        for c in cams.values():
            f.write(f"{c.camera_id} {c.model} {c.width} {c.height} "
                    + " ".join(repr(float(p)) for p in c.params) + "\n")
    ims = jcol.read_images_binary(src / "images.bin")
    with open(dst / "images.txt", "w") as f:
        for im in ims.values():
            f.write(" ".join([str(im.image_id)]
                             + [repr(float(v)) for v in (*im.qvec, *im.tvec)]
                             + [str(im.camera_id), im.name]) + "\n")
            f.write(" ".join(f"{x!r} {y!r} {int(p)}" for (x, y), p in
                             zip(im.xys.tolist(), im.point3d_ids)) + "\n")
    xyz, rgb, err, ids = jcol.read_points3d_binary(src / "points3D.bin")
    with open(dst / "points3D.txt", "w") as f:
        for i in range(len(ids)):
            x, y, z = (repr(float(v)) for v in xyz[i])
            f.write(f"{ids[i]} {x} {y} {z} {rgb[i, 0]} {rgb[i, 1]} "
                    f"{rgb[i, 2]} {float(err[i])!r} 1 0\n")


def test_colmap_binary_and_text_readers_match_jax(tmp_path):
    write_colmap_binary(tmp_path / "bin")
    _write_colmap_text(tmp_path / "bin", tmp_path / "txt")
    for d in ("bin", "txt"):
        recon = tmp_path / d
        _assert_same(tcol.read_cameras(recon), jcol.read_cameras(recon), d)
        _assert_same(tcol.read_images(recon), jcol.read_images(recon), d)
        name = "points3D.bin" if d == "bin" else "points3D.txt"
        _assert_same(tcol.read_points3d(recon / name),
                     jcol.read_points3d(recon / name), d)
    got = tcol.read_images(tmp_path / "txt")
    assert got[1].point3d_ids.tolist() == [0, 1]
    rng = np.random.RandomState(2)
    for _ in range(5):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        np.testing.assert_array_equal(tcol.qvec2rotmat(q), jcol.qvec2rotmat(q))
        R = jcol.qvec2rotmat(q)
        np.testing.assert_array_equal(tcol.rotmat2qvec(R), jcol.rotmat2qvec(R))


@pytest.fixture(scope="module")
def raw_origin(tmp_path_factory):
    """transform2colmap's origin model of the tiny raw clip (8 images,
    each followed by an empty POINTS2D line)."""
    from street_gaussians_ns_tpu_torch.preprocess import transform2colmap

    root = tmp_path_factory.mktemp("raw") / "clip"
    chip_smoke.write_raw_clip(root, 7, TINY_RAW)
    transform2colmap.convert(root, root / "colmap" / "origin")
    meta = json.loads((root / "transform.json").read_text())
    names = [f["file_path"][len("images/"):] for f in meta["frames"]]
    return root, names


def test_read_images_text_pairs_transform2colmap_output(raw_origin):
    """The port reads every image of transform2colmap's images.txt, whose
    POINTS2D lines are empty; the JAX reader, which drops blank lines
    and so pairs an image line with the next image line, raises on it (a
    defect of the reference the port does not copy)."""
    root, names = raw_origin
    path = root / "colmap" / "origin" / "images.txt"
    got = tcol.read_images_text(path)
    assert [im.name for im in got.values()] == names
    assert list(got) == list(range(1, len(names) + 1))
    assert all(im.xys.shape == (0, 2) and im.point3d_ids.size == 0
               for im in got.values())
    assert {im.camera_id for im in got.values()} == {1, 2}
    with pytest.raises(ValueError, match="could not convert"):
        jcol.read_images_text(path)


_IMG = "{} 1.0 0.0 0.0 0.0 0.5 -0.25 2.0 1 cam1/{}.png"


@pytest.mark.parametrize("text,points", [
    ("# header\n" + _IMG.format(1, 1) + "\n\n" + _IMG.format(2, 2) + "\n\n",
     [0, 0]),
    (_IMG.format(1, 1) + "\n\n# between\n" + _IMG.format(2, 2) + "\n",
     [0, 0]),
    (_IMG.format(1, 1) + "\n\n" + _IMG.format(2, 2), [0, 0]),
    (_IMG.format(1, 1) + "\n3.5 4.5 7\n" + _IMG.format(2, 2)
     + "\n1.0 2.0 -1 3.0 4.0 9", [1, 2]),
    (_IMG.format(1, 1) + "\n\n" + _IMG.format(2, 2) + "\n5 6 1\n\n\n",
     [0, 1]),
], ids=["empty-points2d", "comment-between", "no-last-newline",
        "last-points2d-no-newline", "trailing-blank-lines"])
def test_read_images_text_pairs_lines_by_position(tmp_path, text, points):
    path = tmp_path / "images.txt"
    path.write_text(text)
    got = tcol.read_images_text(path)
    assert list(got) == [1, 2]
    assert [im.name for im in got.values()] == ["cam1/1.png", "cam1/2.png"]
    assert [len(im.point3d_ids) for im in got.values()] == points
    np.testing.assert_array_equal(got[2].tvec, [0.5, -0.25, 2.0])
    if all(points):
        # Without an empty POINTS2D line the two readers agree.
        _assert_same(got, jcol.read_images_text(path))
        assert got[2].point3d_ids.tolist() == [-1, 9]


@pytest.mark.parametrize("model,params", [
    ("PINHOLE", [60.0, 61.0, 32.0, 24.0]),
    ("OPENCV", [60.0, 61.0, 32.0, 24.0, 0.1, -0.05, 1e-3, 2e-3]),
    ("OPENCV_FISHEYE", [60.0, 61.0, 32.0, 24.0, 0.1, -0.05, 0.01, 0.002]),
    ("THIN_PRISM_FISHEYE", [300.0, 301.0, 255.0, 257.0, 0.1, 0.2, 0.01,
                            0.02, 0.3, 0.4, 0.05, 0.06]),
])
def test_camera_intrinsics_match_jax(model, params):
    cam = dict(camera_id=1, model=model, width=64, height=48,
               params=np.array(params))
    assert (tcol.camera_intrinsics(tcol.ColmapCamera(**cam))
            == jcol.camera_intrinsics(jcol.ColmapCamera(**cam)))


def _points3d_file(path, n=137, seed=11):
    rng = np.random.RandomState(seed)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<QdddBBBd", i * 7, *rng.randn(3), i % 256,
                                (3 * i) % 256, (7 * i) % 256, rng.rand()))
            tl = int(rng.randint(0, 5))
            f.write(struct.pack("<Q", tl))
            for p in range(tl):
                f.write(struct.pack("<ii", p, p + 1))


def test_native_reader_matches_python_and_jax(tmp_path, monkeypatch):
    """The port's C++ points3D parser, its Python loop and the JAX
    package's reader agree; the reader count says which one ran."""
    path = tmp_path / "points3D.bin"
    _points3d_file(path)
    tcol.POINTS3D_READERS.clear()
    native = tcol.read_points3d_binary(path)
    assert tnative.load_error() is None
    assert tcol.POINTS3D_READERS == {"native": 1}
    assert tnative._library_path().parent == tnative.BUILD_DIR
    monkeypatch.setattr(tnative, "read_points3d_binary", lambda p: None)
    python = tcol.read_points3d_binary(path)
    assert tcol.POINTS3D_READERS == {"native": 1, "python": 1}
    want = jcol.read_points3d_binary(path)
    for a, b, c in zip(native, python, want):
        _assert_same(a, c)
        _assert_same(b, c)


def test_native_build_failure_is_recorded(tmp_path, monkeypatch):
    """A native reader that does not build leaves the Python reader in
    charge, says why, and counts the fallback."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SRC", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_error", None)
    path = tmp_path / "points3D.bin"
    _points3d_file(path, n=9)
    tcol.POINTS3D_READERS.clear()
    got = tcol.read_points3d_binary(path)
    assert "CalledProcessError" in tnative.load_error()
    assert tcol.POINTS3D_READERS == {"python": 1}
    _assert_same(got, jcol.read_points3d_binary(path))


def test_ply_and_pcd_round_trips_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    pts = rng.randn(100, 3).astype(np.float32)
    cols = {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
            "red": rng.randint(0, 256, 100).astype(np.uint8),
            "green": rng.randint(0, 256, 100).astype(np.uint8),
            "blue": rng.randint(0, 256, 100).astype(np.uint8)}
    tply.write_ply(tmp_path / "t.ply", cols)
    jply.write_ply(tmp_path / "j.ply", cols)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    _assert_same(tply.read_ply(tmp_path / "j.ply"),
                 jply.read_ply(tmp_path / "t.ply"))
    _assert_same(tply.read_ply_points(tmp_path / "t.ply"),
                 jply.read_ply_points(tmp_path / "t.ply"))
    n, k = 20, 16
    args = (rng.randn(n, 3).astype(np.float32), rng.randn(n, 3),
            rng.randn(n, k - 1, 3), rng.randn(n), rng.randn(n, 3),
            rng.randn(n, 4))
    args[0][3, 0] = np.nan
    assert tply.write_gaussian_ply(tmp_path / "tg.ply", *args) == n - 1
    jply.write_gaussian_ply(tmp_path / "jg.ply", *args)
    assert (tmp_path / "tg.ply").read_bytes() == \
        (tmp_path / "jg.ply").read_bytes()
    rgb = rng.randint(0, 256, (100, 3)).astype(np.float32)
    tpcd.write_pcd(tmp_path / "t.pcd", pts, rgb)
    jpcd.write_pcd(tmp_path / "j.pcd", pts, rgb)
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
    _assert_same(tpcd.read_pcd(tmp_path / "t.pcd"),
                 jpcd.read_pcd(tmp_path / "t.pcd"))
    with open(tmp_path / "a.pcd", "w") as f:
        f.write("VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                "COUNT 1 1 1\nWIDTH 2\nHEIGHT 1\nPOINTS 2\nDATA ascii\n"
                "1 2 3\n4 5 6\n")
    _assert_same(tpcd.read_pcd(tmp_path / "a.pcd"),
                 jpcd.read_pcd(tmp_path / "a.pcd"))


# ----------------------------------------------------------- annotations

def test_load_annotations_match_jax(clip):
    kw = dict(lidar_path=clip / "aggregate_lidar/dynamic_objects",
              transform_matrix=np.diag([1.0, -1.0, -1.0, 1.0])[:3] * 0.5,
              scale_factor=2.0, time_offset=999999999999999)
    tdb, ttracks = tann.load_annotations(clip / "annotation.json",
                                         device="cpu", **kw)
    jdb, jtracks = jann.load_annotations(clip / "annotation.json", **kw)
    _assert_same(tdb, jdb)
    _assert_same(ttracks, jtracks)
    assert ttracks.num_objects == 1 and ttracks.num_frames == 3
    # No annotation file: an empty database and empty tracks.
    tdb0, t0 = tann.load_annotations(None, device="cpu")
    jdb0, j0 = jann.load_annotations(None)
    _assert_same(tdb0, jdb0)
    _assert_same(t0, j0)
    for ts in ("1000000000000003", 1557000000.25, 1557000000):
        assert tann.parse_timestamp(ts) == jann.parse_timestamp(ts)


# ------------------------------------------------------------ the parser

def _assert_scenes_equal(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name in ("c2w", "fx", "fy", "cx", "cy", "times", "distortion",
                      "transform_matrix", "points_xyz",
                      "applied_translation_in_colmap"):
            assert g.dtype == w.dtype and g.shape == w.shape, f.name
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=f.name)
        else:
            _assert_same(g, w, f.name)


@pytest.mark.parametrize("kw", [
    dict(load_dynamic_annotations=True),
    dict(load_dynamic_annotations=False, filter_camera_id=[1],
         train_split_fraction=0.5, max_seed_points=20),
    dict(frame_select=[0, 2], filter_camera_id=[1, 2], auto_scale_poses=False,
         scale_factor=0.5),
])
def test_parse_scene_matches_jax(clip, kw):
    want = jdp.parse_scene(jdp.DataParserConfig(data=clip, **kw))
    got = tdp.parse_scene(tdp.DataParserConfig(data=clip, **kw), device="cpu")
    _assert_scenes_equal(got, want)
    all_ = tdp.parse_scene(tdp.DataParserConfig(data=clip, **kw),
                           split_all=True, device="cpu")
    _assert_scenes_equal(all_, jdp.parse_scene(
        jdp.DataParserConfig(data=clip, **kw), split_all=True))


def test_raw_clip_through_the_port_preprocess_parses_and_trains(
        raw_origin, tmp_path, monkeypatch):
    """The whole chain on the tiny raw clip: the port's tools as
    scripts/data_process.sh chains them (the origin model as sparse/0,
    there being no colmap), then parse_scene reads it: one track, and as
    seed points every LiDAR point outside the moving box (each sweep is
    under the 10,000 subsample), counted with the JAX package's
    points_in_box; then scripts.train.main --device cpu trains 2 steps."""
    import shutil

    from street_gaussians_ns_tpu.preprocess.pcd2colmap_points3d import (
        points_in_box)
    from street_gaussians_ns_tpu_torch.preprocess import (
        colmap_pts_combine, extract_object_pts, masks_generate,
        pcd2colmap_points3d, segs_generate)
    from street_gaussians_ns_tpu_torch.scripts import train as ttrain

    data = tmp_path / "clip"
    shutil.copytree(raw_origin[0], data)
    sparse = data / "colmap" / "sparse" / "0"
    shutil.copytree(data / "colmap" / "origin", sparse)
    segs_generate.main(["--data", str(data), "--device", "cpu"])
    masks_generate.main(["--data", str(data), "--dilate", "25",
                         "--device", "cpu"])
    pcd2colmap_points3d.main(["--data", str(data), "--output",
                              str(sparse / "points3D_lidar.txt"),
                              "--device", "cpu"])
    colmap_pts_combine.main(["--colmap-dir", str(sparse), "--lidar-points",
                             "points3D_lidar.txt"])
    extract_object_pts.main(["--data", str(data), "--device", "cpu"])

    meta = json.loads((data / "transform.json").read_text())
    anno = json.loads((data / "annotation.json").read_text())["frames"]
    outside = 0
    for lf, frame in zip(meta["lidar_frames"], anno):
        xyz, _ = jpcd.read_pcd(data / lf["file_path"])
        pose = np.asarray(lf["transform_matrix"])
        world = xyz @ pose[:3, :3].T + pose[:3, 3]
        inside = np.zeros(len(world), bool)
        for o in frame["objects"]:
            if o["is_moving"]:
                inside |= points_in_box(world, o["translation"], o["size"],
                                        o["rotation"])
        assert (~inside).sum() < 10_000
        outside += int((~inside).sum())

    scene = tdp.parse_scene(tdp.DataParserConfig(
        data=data, init_points_filename="points3D_withlidar.txt",
        filter_camera_id=[1]), device="cpu")
    assert scene.tracks.num_objects == 1
    assert scene.annotations.track_ids == ["moving0"]
    assert len(scene.points_xyz) == outside
    assert scene.num_frames == 8 and len(scene.train_indices) == 4
    assert scene.applied_translation_in_colmap is not None

    # The metrics writer's TensorBoard mirror is optional; without it the
    # test does not pay TensorFlow's import where that is installed.
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    run = tmp_path / "run"
    trainer = ttrain.main([
        "--data", str(data), "--device", "cpu", "--filter-camera-id", "1",
        "--init-points-filename", "points3D_withlidar.txt",
        "--train-split-fraction", "0.5", "--trainer.output-dir", str(run),
        "--trainer.max-num-iterations", "2",
        "--trainer.background-capacity", "2048",
        "--trainer.object-capacity", "2048",
        "--trainer.max-pairs", "16384",
        "--trainer.steps-per-eval-all-images", "1000",
        "--model.base.sh-degree", "1", "--model.base.env-map-res", "16",
        "--model.background.sh-degree", "1",
        "--model.object-template.sh-degree", "1", "--no-dm.undistort",
        "--no-trainer.presize-pairs"])
    assert trainer.state.step == 2 and trainer.tracks.num_objects == 1
    rows = [json.loads(r) for r in
            (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert losses and np.isfinite(losses).all()
    assert (run / "checkpoints" / "step-000000002.ckpt.npz").exists()


def test_parse_scene_reuses_cached_transforms(clip, tmp_path):
    import shutil

    data = tmp_path / "clip"
    shutil.copytree(clip, data)
    json.dump({"transform": np.eye(4)[:3].tolist(), "scale": 0.25},
              open(data / "dataparser_transforms.json", "w"))
    _assert_scenes_equal(
        tdp.parse_scene(tdp.DataParserConfig(data=data), device="cpu"),
        jdp.parse_scene(jdp.DataParserConfig(data=data)))


def test_orientation_helpers_match_jax():
    rng = np.random.RandomState(1)
    for _ in range(4):
        a, b = rng.randn(3), rng.randn(3)
        np.testing.assert_array_equal(tdp.rotation_matrix_between(a, b),
                                      jdp.rotation_matrix_between(a, b))
    np.testing.assert_array_equal(
        tdp.rotation_matrix_between(np.array([0, 0, 1.0]),
                                    np.array([0, 0, -1.0])),
        jdp.rotation_matrix_between(np.array([0, 0, 1.0]),
                                    np.array([0, 0, -1.0])))
    poses = np.tile(np.eye(4), (6, 1, 1))
    poses[:, :3, 3] = rng.randn(6, 3)
    for method, center in (("up", "poses"), ("none", "none"),
                           ("up", "none")):
        _assert_same(tdp.auto_orient_and_center_poses(poses, method, center),
                     jdp.auto_orient_and_center_poses(poses, method, center))
    v = np.array([1.0, 2.0, 3.0, 1.0])
    np.testing.assert_array_equal(tdp.gl2cv(v), jdp.gl2cv(v))


# ---------------------------------------------------------------- frames

@pytest.mark.parametrize("downscale,disk_cache", [(1, False), (2, True)])
def test_load_frame_matches_jax(clip, tmp_path, downscale, disk_cache):
    """Each package in its own copy of the clip: the first load decodes
    (and writes the cache), the second reads the cache."""
    import shutil

    scenes = []
    for name, dp in (("t", tdp), ("j", jdp)):
        data = tmp_path / name
        shutil.copytree(clip, data)
        cfg = dp.DataParserConfig(data=data, load_dynamic_annotations=False,
                                  masks_path=tdp.Path("segs"))
        scenes.append(dp.parse_scene(cfg, device="cpu") if name == "t"
                      else dp.parse_scene(cfg))
    tscene, jscene = scenes
    for idx in range(tscene.num_frames):
        for _ in range(2 if disk_cache else 1):
            want = jds.load_frame(jscene, idx, undistort=True,
                                  downscale=downscale, disk_cache=disk_cache)
            got = tds.load_frame(tscene, idx, undistort=True,
                                 downscale=downscale, disk_cache=disk_cache)
            _assert_same(got, want, str(idx))
    assert got.image.shape == (48 // downscale, 64 // downscale, 3)
    assert got.semantic is not None and got.mask is not None
    assert set(np.unique(got.semantic)) <= {0, 1, 2}
    assert (tmp_path / "t" / "images_ud_2").is_dir() == disk_cache


@pytest.mark.parametrize("fisheye", [False, True])
def test_undistort_frame_matches_jax(fisheye):
    rng = np.random.RandomState(3)
    image = rng.rand(48, 64, 3).astype(np.float32)
    mask = rng.rand(48, 64, 1) > 0.3
    sem = rng.randint(0, 3, (48, 64, 1)).astype(np.int32)
    dist = np.array([0.05, -0.02, 0.01, 0.003, 1e-3, -2e-3], np.float32)
    args = (image, 60.0, 61.0, 32.0, 24.0, dist, fisheye, mask, sem)
    _assert_same(tds.undistort_frame(*args), jds.undistort_frame(*args))
    # Zero distortion returns the inputs without touching OpenCV.
    zero = (image, 60.0, 61.0, 32.0, 24.0, np.zeros(6), fisheye, mask, sem)
    _assert_same(tds.undistort_frame(*zero), jds.undistort_frame(*zero))


def test_image_loaders_and_downscale_factor_match_jax(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(4)
    rgba = (rng.rand(9, 7, 4) * 255).astype(np.uint8)
    Image.fromarray(rgba).save(tmp_path / "a.png")
    Image.fromarray(rgba[..., 0]).save(tmp_path / "g.png")
    Image.fromarray((rng.rand(9, 7) * 60000).astype(np.uint16)).save(
        tmp_path / "d.png")
    np.save(tmp_path / "d.npy", rng.rand(9, 7).astype(np.float32))
    for name in ("a.png", "g.png"):
        _assert_same(tds.load_image(tmp_path / name),
                     jds.load_image(tmp_path / name))
        _assert_same(tds.load_mask(tmp_path / name),
                     jds.load_mask(tmp_path / name))
        _assert_same(tds.load_semantics(tmp_path / name),
                     jds.load_semantics(tmp_path / name))
    for name in ("d.png", "d.npy", "a.png"):
        _assert_same(tds.load_depth(tmp_path / name, 2.0),
                     jds.load_depth(tmp_path / name, 2.0))
    for w, h in ((1600, 1056), (1920, 1280), (3840, 2160), (64, 48)):
        assert (tds.auto_downscale_factor(w, h)
                == jds.auto_downscale_factor(w, h))


def test_fisheye624_matches_jax():
    params = TestFisheye624.PARAMS
    rng = np.random.RandomState(5)
    rays = rng.randn(64, 3)
    rays[:, 2] = np.abs(rays[:, 2]) + 0.3
    np.testing.assert_array_equal(tfe.project(rays, params),
                                  jfe.project(rays, params))
    uv = rng.rand(64, 2) * 512
    np.testing.assert_array_equal(tfe.unproject_radial(uv, params),
                                  jfe.unproject_radial(uv, params))
    img = rng.rand(96, 96, 3).astype(np.float32)
    sem = rng.randint(0, 3, (96, 96, 1)).astype(np.int32)
    p = params.copy()
    p[:4] = [60.0, 60.0, 48.0, 48.0]
    _assert_same(tfe.undistort_frame_fisheye624(img, p, 40.0, sem),
                 jfe.undistort_frame_fisheye624(img, p, 40.0, sem))


# ------------------------------------------------------------ datamanager

def test_datamanager_matches_jax(clip):
    cfg = dict(data=clip, load_dynamic_annotations=False,
               train_split_fraction=0.7)
    tscene = tdp.parse_scene(tdp.DataParserConfig(**cfg), device="cpu")
    jscene = jdp.parse_scene(jdp.DataParserConfig(**cfg))
    dmc = dict(undistort=False, cache_workers=2, seed=7)
    t = tdm.FullImageDatamanager(tscene, tdm.DataManagerConfig(**dmc),
                                 device="cpu")
    j = jdm.FullImageDatamanager(jscene, jdm.DataManagerConfig(**dmc))
    assert (t.num_train, t.num_eval) == (j.num_train, j.num_eval) == (5, 1)

    def same(tsample, jsample):
        (tc, tb), (jc, jb) = tsample, jsample
        for f in ("fx", "fy", "cx", "cy", "c2w", "time"):
            _assert_same(getattr(tc, f), getattr(jc, f), f)
            assert getattr(tc, f).device.type == "cpu"
        assert (tc.width, tc.height) == (jc.width, jc.height)
        _assert_same(tb, jb)

    # Two epochs and a half, with eval draws from the same RandomState.
    for step in range(13):
        same(t.next_train(step), j.next_train(step))
        if step % 4 == 3:
            same(t.next_eval(step), j.next_eval(step))
    for a, b in zip(t.fixed_indices_eval(), j.fixed_indices_eval()):
        same(a, b)
    for a, b in zip(t.fixed_indices_train(), j.fixed_indices_train()):
        same(a, b)
    for i in range(t.num_train):
        _assert_same(t.train_camera(i).c2w, j.train_camera(i).c2w)
    # The sampler's state carries a run on exactly.
    state = t.sampler_state()
    u = tdm.FullImageDatamanager(tscene, tdm.DataManagerConfig(**dmc),
                                 device="cpu")
    u.set_sampler_state(state)
    for step in range(7):
        a, b = t.next_train(step), u.next_train(step)
        _assert_same(a[1], b[1])
        if step == 4:
            _assert_same(t.next_eval()[1], u.next_eval()[1])


# ------------------------------------------------------ optional libraries

@pytest.mark.parametrize("module,helper,name", [
    ("cv2", "opencv", "OpenCV"), ("PIL", "pillow_image", "Pillow")])
def test_missing_image_library_raises_naming_it(monkeypatch, module, helper,
                                                name):
    monkeypatch.setitem(sys.modules, module, None)
    if module == "PIL":
        monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match=name):
        getattr(optional, helper)()
    if module == "cv2":
        with pytest.raises(ImportError, match=name):
            tds.undistort_frame(np.zeros((4, 4, 3), np.float32), 1.0, 1.0,
                                2.0, 2.0, np.full(6, 0.1), False)
    else:
        with pytest.raises(ImportError, match=name):
            tds.load_image("any.png")


def test_frame_cache_writes_of_two_ranks_do_not_collide(tmp_path,
                                                        monkeypatch):
    """Two ranks of a multi-process run (parallel/trainer.py) on one
    machine build the same clip's frame cache at once. Interleaved as: A
    writes its temporary file, B writes and publishes its own, A
    publishes. Each process's temporary file is its own, so both succeed
    and the cache holds one whole frame (with one name shared by the
    processes, A's rename found no file)."""
    frame = tds.FrameData(
        image=np.full((4, 6, 3), 0.5, np.float32), mask=None, semantic=None,
        fx=10.0, fy=10.0, cx=3.0, cy=2.0, c2w=np.eye(3, 4), time=0.0,
        width=6, height=4)
    path = tmp_path / "images_ud" / "cam" / "0.npz"
    savez = np.savez
    pid = [1001]
    monkeypatch.setattr(tds.os, "getpid", lambda: pid[0])
    calls = []

    def interleaved(file, **data):
        savez(file, **data)
        calls.append(str(file))
        if len(calls) == 1:             # B runs whole between A's steps
            pid[0] = 1002
            tds._save_cache(path, frame)
            pid[0] = 1001

    monkeypatch.setattr(tds.np, "savez", interleaved)
    tds._save_cache(path, frame)
    assert len(calls) == 2 and calls[0] != calls[1]
    with np.load(path) as z:
        np.testing.assert_array_equal(z["image"], np.full((4, 6, 3), 127,
                                                          np.uint8))
    assert sorted(p.name for p in path.parent.iterdir()) == ["0.npz"]

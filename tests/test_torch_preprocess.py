"""The port's offline preprocess (street_gaussians_ns_tpu_torch.preprocess)
against the JAX package's, on the CPU, on a tiny raw clip in
extract_waymo's layout (chip_smoke.write_raw_clip at TINY_RAW: 4 frames,
2 cameras of 64x48 as PNG, 5,000-point sweeps, one moving car of
2,500-2,600 returns a sweep over a dark road, one parked car).

Tolerances: transform2colmap, colmap_pts_combine, segs and masks are
byte-equal (the same host numpy, or integer and exact float64 work on the
device). pcd2colmap's rows have equal ids and colours and xyz within 1e-9
of each point's norm, and the object plys equal gids, rows and colours
and xyz within one float32 ulp: the float64 matrix products of the port
(torch) and of the JAX package (numpy's BLAS) may round differently."""
import json
import shutil
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from street_gaussians_ns_tpu.preprocess import colmap_pts_combine as jcomb
from street_gaussians_ns_tpu.preprocess import extract_object_pts as jobj
from street_gaussians_ns_tpu.preprocess import extract_waymo as jwaymo
from street_gaussians_ns_tpu.preprocess import masks_generate as jmasks
from street_gaussians_ns_tpu.preprocess import pcd2colmap_points3d as jpcd
from street_gaussians_ns_tpu.preprocess import run_colmap as jcolmap
from street_gaussians_ns_tpu.preprocess import segs_generate as jsegs
from street_gaussians_ns_tpu.preprocess import transform2colmap as jt2c
from street_gaussians_ns_tpu_torch.data.ply_io import read_ply
from street_gaussians_ns_tpu_torch.preprocess import (
    colmap_pts_combine as tcomb)
from street_gaussians_ns_tpu_torch.preprocess import extract_object_pts as tobj
from street_gaussians_ns_tpu_torch.preprocess import extract_waymo as twaymo
from street_gaussians_ns_tpu_torch.preprocess import masks_generate as tmasks
from street_gaussians_ns_tpu_torch.preprocess import (
    pcd2colmap_points3d as tpcd)
from street_gaussians_ns_tpu_torch.preprocess import run_colmap as tcolmap
from street_gaussians_ns_tpu_torch.preprocess import segs_generate as tsegs
from street_gaussians_ns_tpu_torch.preprocess import transform2colmap as tt2c

TINY_RAW = chip_smoke.RawClip(
    frames=4, cameras=(("FRONT", 64, 48), ("FRONT_LEFT", 64, 48)),
    sweep_points=5000, moving=1, parked=1, returns=(2500, 2600),
    parked_returns=300, image_ext="png")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw") / "clip"
    made = chip_smoke.write_raw_clip(root, 7, TINY_RAW)
    return root, made


def _copy(raw, tmp_path, name):
    dst = tmp_path / name
    shutil.copytree(raw[0], dst)
    return dst


def _files(root, sub):
    return {p.relative_to(root / sub): p.read_bytes()
            for p in sorted((root / sub).rglob("*")) if p.is_file()}


def test_tiny_clip_has_what_the_tools_need(raw):
    """The fixture's clip: FRONT first (COLMAP camera id 1), 4 sweeps of
    5,000 points, the moving car's returns in its box, dark road under
    it in the images."""
    root, made = raw
    meta = json.loads((root / "transform.json").read_text())
    assert [f["camera"] for f in meta["frames"][:2]] == ["FRONT",
                                                        "FRONT_LEFT"]
    assert len(meta["frames"]) == 8 and len(meta["lidar_frames"]) == 4
    assert made["returns"].shape == (4, 1)
    assert (made["returns"] >= 2500).all() and (made["returns"] <= 2600).all()
    anno = json.loads((root / "annotation.json").read_text())["frames"]
    for f, lf in zip(anno, meta["lidar_frames"]):
        xyz, _ = jpcd.read_pcd(root / lf["file_path"])
        pose = np.asarray(lf["transform_matrix"])
        world = xyz @ pose[:3, :3].T + pose[:3, 3]
        assert len(world) == 5000
        car = f["objects"][0]
        assert car["is_moving"] and not f["objects"][1]["is_moving"]
        n = jpcd.points_in_box(world, car["translation"], car["size"],
                               car["rotation"]).sum()
        assert n == made["returns"][anno.index(f), 0]


def test_transform2colmap_is_byte_equal(raw, tmp_path):
    root = raw[0]
    jt2c.convert(root, tmp_path / "jax")
    tt2c.main(["--data", str(root), "--output-dir", str(tmp_path / "port")])
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    lines = (tmp_path / "port" / "images.txt").read_text().split("\n")
    assert len(lines) == 2 * 8 + 1 and lines[1] == "" and lines[-1] == ""


def test_segs_are_byte_equal(raw, tmp_path):
    a, b = _copy(raw, tmp_path, "jax"), _copy(raw, tmp_path, "port")
    assert jsegs.generate(a) == 8
    assert tsegs.main(["--data", str(b), "--device", "cpu"]) == 8
    got, want = _files(b, "segs"), _files(a, "segs")
    assert got == want and len(want) == 8
    labels = np.unique(np.asarray(chip_smoke.pillow_image().open(
        b / "segs" / next(iter(got)))))
    assert {7, 27} <= set(labels.tolist())


def test_segs_mask2former_mode_raises_as_jax(raw):
    with pytest.raises(RuntimeError, match="mask2former") as want:
        jsegs.generate(raw[0], "mask2former")
    with pytest.raises(RuntimeError) as got:
        tsegs.generate(raw[0], "mask2former", device="cpu")
    assert str(got.value) == str(want.value)


def _sum_image(sums: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 whose channel sums are `sums` (H, W)."""
    base = sums // 3
    img = np.stack([base, base, base + sums % 3], -1)
    return np.minimum(img, 255).astype(np.uint8)


def test_naive_segment_probes_match_jax():
    """The exact-18 edge: columns whose rows' channel sums step by +18 or
    -18 from every sum (grad = |s2 / 3 - s1 / 3| is within an ulp of 6,
    and float64 rounds it as numpy does); the column wrap: sky that
    reaches row 1's column 0 only through column W-1 of row 0; and rows
    of candidates below a row without sky (the reference's break)."""
    s = np.arange(0, 766 - 18)
    h = 8
    up = np.stack([s + 18 * (r % 2) for r in range(h)])
    down = np.stack([s + 18 * ((r + 1) % 2) for r in range(h)])
    for sums in (up, down):
        img = _sum_image(sums)
        np.testing.assert_array_equal(
            tsegs.naive_segment(torch.from_numpy(img)).numpy(),
            jsegs.naive_segment(img))

    img = np.full((6, 10, 3), 40, np.uint8)      # dark: no candidate
    img[0, 9] = 200                              # sky at row 0, column 9
    img[0, 0] = img[1, 1] = 138                    # not bright, not sky
    img[1, 0] = img[2, 0] = img[2, 1] = 142      # reached through the wrap
    img[3, :] = 138                              # a row without sky
    img[4:, :] = 142                             # candidates under it
    got = tsegs.naive_segment(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, jsegs.naive_segment(img))
    assert got[1, 0] == tsegs.SKY_ID and got[2, 1] == tsegs.SKY_ID
    assert got[4].tolist() == [tsegs.GROUND_ID] * 10


@pytest.mark.parametrize("dilate", [0, 4, 25])
def test_masks_are_byte_equal(raw, tmp_path, dilate):
    """--dilate 0 (no erosion), 4 (cv2's uneven window) and 25 (the
    pipeline's)."""
    a, b = _copy(raw, tmp_path, "jax"), _copy(raw, tmp_path, "port")
    assert jmasks.generate_masks(a, dilate) == 8
    assert tmasks.main(["--data", str(b), "--dilate", str(dilate),
                        "--device", "cpu"]) == 8
    got, want = _files(b, "masks"), _files(a, "masks")
    assert got == want and len(want) == 8
    front = np.asarray(chip_smoke.pillow_image().open(
        b / "masks" / "FRONT" / f"{chip_smoke.CLIP_TS0}.png"))
    if dilate == 0:
        assert {0, 1, 255} <= set(np.unique(front).tolist())


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 25])
def test_erode_is_cv2_erode(k):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(k)
    mask = np.where(rng.rand(37, 53) < 0.97, 255, 0).astype(np.uint8)
    mask[rng.rand(37, 53) < 0.02] = 1
    np.testing.assert_array_equal(
        tmasks.erode(torch.from_numpy(mask), k).numpy(),
        cv2.erode(mask, np.ones((k, k), np.uint8)))


def test_jpeg_frame_masks_match(tmp_path):
    """One JPEG frame: the JAX package decodes it with OpenCV, the port
    with Pillow."""
    clip = chip_smoke.RawClip(
        frames=1, cameras=(("FRONT", 64, 48),), sweep_points=5000,
        moving=1, parked=1, returns=(2500, 2600), image_ext="jpg")
    a, b = tmp_path / "jax", tmp_path / "port"
    chip_smoke.write_raw_clip(a, 7, clip)
    shutil.copytree(a, b)
    assert jmasks.generate_masks(a, 0) == 1
    assert tmasks.generate_masks(b, 0, device="cpu") == 1
    got, want = _files(b, "masks"), _files(a, "masks")
    assert got == want


def _tag_orientation(path, orientation=3):
    """Re-save a JPEG with an EXIF orientation tag (3: rotated 180
    degrees). OpenCV's decode applies the tag; Pillow's does not."""
    Image = chip_smoke.pillow_image()
    img = Image.open(path)
    exif = img.getexif()
    exif[0x0112] = orientation
    img.save(path, quality=90, exif=exif)


def test_jpeg_masks_use_the_opencv_decode(tmp_path):
    """Several JPEG frames (two cameras over three frames, one tagged with
    an EXIF orientation): the masks tool's pixels equal cv2.imread's (BGR
    to RGB) byte for byte on every frame, and its masks equal the JAX
    package's, which decodes with OpenCV. On the tagged frame Pillow's
    decode (load_rgb, which the tool used before) differs, and so do the
    masks made from it: the fault the OpenCV decode repairs."""
    import cv2

    clip = chip_smoke.RawClip(
        frames=3, cameras=(("FRONT", 64, 48), ("FRONT_LEFT", 64, 48)),
        sweep_points=5000, moving=1, parked=1, returns=(2500, 2600),
        image_ext="jpg")
    a, b = tmp_path / "jax", tmp_path / "port"
    chip_smoke.write_raw_clip(a, 7, clip)
    tagged = a / "images" / "FRONT" / f"{chip_smoke.CLIP_TS0}.jpg"
    _tag_orientation(tagged)
    shutil.copytree(a, b)
    frames = sorted((b / "images").rglob("*.jpg"))
    assert len(frames) == 6
    for path in frames:
        want = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
        got = tmasks.decode_rgb(path, "cpu").numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    assert jmasks.generate_masks(a, 0) == 6
    assert tmasks.generate_masks(b, 0, device="cpu") == 6
    assert _files(b, "masks") == _files(a, "masks")

    meta = json.load(open(b / "transform.json"))
    fr = next(f for f in meta["frames"]
              if f.get("file_path") == tagged.relative_to(a).as_posix())
    objs = json.load(open(b / "annotation.json"))["frames"][0]["objects"]
    boxes = tmasks.image_boxes(fr, objs)
    assert boxes
    path = b / fr["file_path"]
    pillow = tpcd.load_rgb(path, "cpu")
    assert not torch.equal(pillow, tmasks.decode_rgb(path, "cpu"))
    assert not torch.equal(tmasks.frame_mask(pillow, boxes, 0),
                           tmasks.frame_mask(tmasks.decode_rgb(path, "cpu"),
                                             boxes, 0))


def _lidar_rows(path):
    rows = np.loadtxt(path, ndmin=2)
    return rows[:, 0].astype(np.int64), rows[:, 1:4], rows[:, 4:7]


@pytest.mark.parametrize("per_frame", [10000, 1000])
def test_pcd2colmap_matches_jax(raw, tmp_path, per_frame):
    """10,000 a sweep keeps every point outside the moving box; 1,000
    draws the subsample from numpy's RandomState(0) in both."""
    root = raw[0]
    jpcd.convert(root, tmp_path / "jax.txt", per_frame)
    n = tpcd.main(["--data", str(root), "--output", str(tmp_path / "port.txt"),
                   "--points-per-frame", str(per_frame), "--device", "cpu"])
    ia, xa, ca = _lidar_rows(tmp_path / "port.txt")
    ib, xb, cb = _lidar_rows(tmp_path / "jax.txt")
    want = (5000 - raw[1]["returns"][:, 0]).sum() if per_frame == 10000 \
        else 4 * per_frame
    assert n == len(ia) == len(ib) == want
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(ca, cb)
    assert (np.abs(xa - xb).max(1)
            <= 1e-9 * np.linalg.norm(xb, axis=1)).all()
    assert (ca != 128).any(1).mean() > 0.1          # projected colours


def _sparse_model(root, tmp_path, sfm_points: bool):
    sparse = tmp_path / "sparse"
    jt2c.convert(root, sparse)
    jpcd.convert(root, sparse / "points3D_lidar.txt")
    if sfm_points:
        (sparse / "points3D.txt").write_text(
            "# 3D point list\n3 1.5 -2.25 0.125 10 20 30 0.5 1 0\n"
            "7 0.1 0.2 0.3 40 50 60 1.25 2 1\n")
    return sparse


@pytest.mark.parametrize("sfm_points", [False, True])
def test_colmap_pts_combine_is_byte_equal(raw, tmp_path, sfm_points):
    """An SfM model with no points (offset 0) and one with ids up to 7."""
    sparse = _sparse_model(raw[0], tmp_path, sfm_points)
    jcomb.combine(sparse, sparse / "points3D_lidar.txt", "jax.txt")
    n = tcomb.main(["--colmap-dir", str(sparse), "--lidar-points",
                    "points3D_lidar.txt", "--output-name", "port.txt"])
    assert (sparse / "port.txt").read_bytes() == \
        (sparse / "jax.txt").read_bytes()
    lidar = len((sparse / "points3D_lidar.txt").read_text().splitlines())
    assert n == lidar + 2 * sfm_points
    first_lidar = (sparse / "port.txt").read_text().splitlines()[
        2 * sfm_points]
    assert first_lidar.split()[0] == str(1 + 8 * sfm_points)


def test_extract_object_pts_matches_jax(raw, tmp_path):
    a, b = _copy(raw, tmp_path, "jax"), _copy(raw, tmp_path, "port")
    assert jobj.extract(a) == 1
    assert tobj.main(["--data", str(b), "--device", "cpu"]) == 1
    objs = "aggregate_lidar/dynamic_objects"
    assert sorted(p.name for p in (b / objs).glob("*.ply")) == \
        sorted(p.name for p in (a / objs).glob("*.ply")) == ["moving0.ply"]
    got, want = read_ply(b / objs / "moving0.ply"), \
        read_ply(a / objs / "moving0.ply")
    assert list(got) == list(want)
    assert len(want["x"]) == raw[1]["returns"].sum()
    for c in ("red", "green", "blue"):
        np.testing.assert_array_equal(got[c], want[c])
    for c in "xyz":
        ulp = np.spacing(np.maximum(np.abs(got[c]), np.abs(want[c])))
        assert (np.abs(got[c].astype(np.float64) - want[c]) <= ulp).all()


def test_run_colmap_runs_the_same_commands(raw, tmp_path, monkeypatch):
    """A fake `colmap` on PATH logs its argv: the port's commands equal
    the JAX package's (masks and the origin model present, so every
    step runs); without a colmap both raise the same RuntimeError."""
    data = _copy(raw, tmp_path, "clip")
    (data / "masks").mkdir()
    jt2c.convert(data, data / "colmap" / "origin")
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "colmap"
    fake.write_text('#!/bin/sh\necho "$@" >> "$COLMAP_LOG"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:/usr/bin:/bin")
    logs = {}
    for name, run in (("jax", jcolmap.run_colmap),
                      ("port", lambda d: tcolmap.main(["--data", str(d)]))):
        monkeypatch.setenv("COLMAP_LOG", str(tmp_path / f"{name}.log"))
        run(data)
        logs[name] = (tmp_path / f"{name}.log").read_text().splitlines()
    assert logs["port"] == logs["jax"]
    assert [ln.split()[0] for ln in logs["port"]] == [
        "feature_extractor", "exhaustive_matcher", "mapper",
        "model_aligner", "point_triangulator"]
    assert "--ImageReader.mask_path" in logs["port"][0]

    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="not found") as want:
        jcolmap.run_colmap(data)
    with pytest.raises(RuntimeError) as got:
        tcolmap.main(["--data", str(data)])
    assert str(got.value) == str(want.value)


def test_blender_pose_matches_jax():
    rng = np.random.RandomState(3)
    for _ in range(5):
        ego, ext = np.eye(4), np.eye(4)
        for m in (ego, ext):
            q, _ = np.linalg.qr(rng.randn(3, 3))
            m[:3, :3], m[:3, 3] = q, rng.randn(3) * 50
        np.testing.assert_array_equal(twaymo.blender_pose(ego, ext),
                                      jwaymo.blender_pose(ego, ext))
    np.testing.assert_array_equal(twaymo.OPENCV2WAYMO, jwaymo.OPENCV2WAYMO)


def test_require_waymo_raises_in_both(monkeypatch):
    """Neither package depends on TensorFlow or waymo_open_dataset; the
    gate raises where they cannot be imported (both are hidden here, so
    the test does not pay TensorFlow's import where it is installed)."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    monkeypatch.setitem(sys.modules, "waymo_open_dataset", None)
    with pytest.raises(RuntimeError, match="waymo_open_dataset"):
        jwaymo._require_waymo()
    with pytest.raises(RuntimeError, match="waymo_open_dataset"):
        twaymo._require_waymo()
    with pytest.raises(RuntimeError, match="waymo_open_dataset"):
        twaymo.main(["--tfrecords", "a.tfrecord", "--out", "out"])


@pytest.mark.parametrize("tool", ["segs_generate", "masks_generate",
                                  "pcd2colmap_points3d",
                                  "extract_object_pts"])
def test_device_tools_raise_without_a_card(raw, tmp_path, monkeypatch, tool):
    """The device tools default to cuda and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _copy(raw, tmp_path, "clip")
    argv = {"segs_generate": [], "masks_generate": [],
            "pcd2colmap_points3d": ["--output", str(tmp_path / "o.txt")],
            "extract_object_pts": []}[tool]
    main = {"segs_generate": tsegs.main, "masks_generate": tmasks.main,
            "pcd2colmap_points3d": tpcd.main,
            "extract_object_pts": tobj.main}[tool]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--data", str(data), *argv])

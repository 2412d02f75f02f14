"""The inputs of the three-camera Waymo-segment configuration
(configs/scene_graph_waymo3.json), made from `--seed`: the scene graph's
weights on a street (road and facades) stretched along the ego's whole
drive, a dozen tracked vehicles each annotated over a stretch of the
clip, the three front cameras on one ego trajectory, one target image a
frame and camera, and the clip on disk in the layout the data parser reads (three
PINHOLE cameras in one COLMAP model, transform.json, annotation.json,
per-vehicle LiDAR .ply, PNG images and segmentations).

Image g of the clip is camera g // F (in the configuration's order,
sorted by COLMAP camera id) at frame g % F: the data parser sorts frames
by (camera id, time), so its indices are these. Frozen with the
benchmark: a later change to the program does not change what is
measured.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import os
import struct
from pathlib import Path

import numpy as np
import torch

from . import scene

IMAGE_SEED = 0x5EED
OBJECT_SD = (0.6, 1.2, 0.4)      # a vehicle's cloud: across, along, up
VEHICLE_SIZE = (2.4, 4.8, 1.6)
# Box frame (x across, y along, z up) to world (x across, -z ahead, y up):
# a quarter turn about x, so the bbox optimiser's yaw (about the box's z)
# turns the vehicle about the vertical.
BOX_TO_WORLD = (math.cos(-math.pi / 4), math.sin(-math.pi / 4), 0.0, 0.0)


def frames(cfg: dict) -> int:
    return cfg["track_frames"]


def cameras(cfg: dict) -> list:
    """[(COLMAP camera id, name, yaw in radians)] sorted by id."""
    return sorted((c["id"], c["name"], math.radians(c["yaw_deg"]))
                  for c in cfg["cameras"])


def drive_length(cfg: dict) -> float:
    return cfg["ego_step_m"] * (frames(cfg) - 1)


def _street(length: float):
    """The background of a street, stretched over the ego's drive and the
    view ahead of its last frame (z uniform over it): 40% on the road,
    x uniform over 20 m, 2 m below the cameras (y = -2, 5 cm thick), and
    60% on the facades either side, 10 m out and beyond (|x| = 10 + 1.5
    |N(0, 1)|), 2 m below to 8 m above the cameras. The road between is
    free, so the vehicles on it are in plain view."""
    def fn(nrm, uni, sd):
        z = -2.0 - uni[..., 0:1] * length
        road = uni[..., 1:2] < 0.4
        x = torch.where(road, (2.0 * uni[..., 2:3] - 1.0) * 10.0,
                        torch.sign(nrm[..., 0:1])
                        * (10.0 + 1.5 * nrm[..., 0:1].abs()))
        y = torch.where(road, -2.0 + 0.05 * nrm[..., 1:2],
                        -2.0 + 10.0 * uni[..., 2:3])
        return torch.cat([x, y, z], -1)
    return fn


def _street_np(rng, n: int, length: float) -> np.ndarray:
    """_street's distribution in numpy, for the clip's seed points."""
    z = -2.0 - rng.random(n) * length
    road = rng.random(n) < 0.4
    u, g = rng.random(n), rng.standard_normal(n)
    x = np.where(road, (2.0 * u - 1.0) * 10.0,
                 np.sign(g) * (10.0 + 1.5 * np.abs(g)))
    y = np.where(road, -2.0 + 0.05 * rng.standard_normal(n),
                 -2.0 + 10.0 * u)
    return np.stack([x, y, z], 1)


def make_scene(seed: int, cfg: dict, device) -> dict:
    """The store's leaves as scene.make_scene gives them (the same keys,
    draws and inactive slots, one in cfg["inactive_every"]), with the
    background on a street (_street) and each vehicle's cloud in its box
    frame (x across, y along, z up)."""
    g = scene.generator(seed, device)
    sh = cfg["sh_degree"]
    span = drive_length(cfg) + cfg["view_ahead_m"]
    bg = scene._cloud(g, cfg["background_capacity"], (),
                      cfg["background_fourier"], sh, -3.3, None,
                      _street(span), device)
    out = {f"bg/{k}": v for k, v in bg.items()}
    n_obj = cfg["objects"]
    ob = scene._cloud(g, cfg["object_capacity"], (n_obj,),
                      cfg["object_fourier"], sh, -3.8, OBJECT_SD,
                      scene._box, device)
    out.update({f"obj/{k}": v for k, v in ob.items()})
    every = cfg["inactive_every"]
    for part in ("bg", "obj"):
        active = torch.ones(out[f"{part}/means"].shape[:-1], dtype=torch.bool,
                            device=device)
        active[..., every - 1::every] = False
        out[f"{part}/active"] = active
        free = ~active
        for k in scene.PARAMS:
            x = out[f"{part}/{k}"]
            m = free.reshape(free.shape + (1,) * (x.dim() - free.dim()))
            out[f"{part}/{k}"] = torch.where(m, torch.zeros_like(x), x)
    r = cfg["env_map_res"]
    out["env_map"] = torch.rand((6, r, r, 3), generator=g, device=device)
    F = frames(cfg)
    d = torch.randn((F, n_obj, 4), generator=g, device=device)
    out["delta_center"] = 0.05 * d[..., :3].contiguous()
    out["delta_yaw"] = 0.02 * d[..., 3].contiguous()
    out["delta_rot"] = torch.zeros((F, n_obj, 3), device=device)
    return out


def vehicle_stretches(cfg: dict) -> list:
    """[(first, last)] annotated frame of each vehicle, first frames in
    order (the data parser numbers tracks by first appearance)."""
    out = [tuple(s) for s in cfg["vehicle_stretches"]]
    if len(out) != cfg["objects"] or out != sorted(out, key=lambda s: s[0]):
        raise ValueError("one stretch a vehicle, first frames in order")
    return out


def make_tracks(cfg: dict, device) -> tuple:
    """F frames 0.1 s apart; vehicle o in lane cfg["lanes_m"][o % 4] on
    the road (its box centre 1.2 m below the cameras), annotated over its
    stretch, starting 8 + 2 o m ahead of the ego and pulling away at
    0.1 (o mod 4) m a frame, heading down the street with a slow turn
    about the vertical. Boxes outside a stretch are the data parser's:
    zero centre, identity rotation, not valid.
    Returns (tracks dict on `device`, the frames' stamps)."""
    F, O = frames(cfg), cfg["objects"]
    lanes = cfg["lanes_m"]
    centers = np.zeros((F, O, 3), np.float32)
    quats = np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (F, O, 1))
    valid = np.zeros((F, O), bool)
    st = vehicle_stretches(cfg)
    for o, (f0, f1) in enumerate(st):
        for f in range(f0, f1 + 1):
            ahead = 8.0 + 2.0 * o + 0.1 * (o % 4) * (f - f0)
            centers[f, o] = (lanes[o % len(lanes)], -1.2,
                             -cfg["ego_step_m"] * f - ahead)
            yaw = 0.05 * (o - 5.5) + 0.01 * (f - f0)
            quats[f, o] = _qmul((math.cos(yaw / 2), 0.0, math.sin(yaw / 2),
                                 0.0), BOX_TO_WORLD)
            valid[f, o] = True
    stamps = scene.CLIP_TS0 + scene.CLIP_DT_US * np.arange(F, dtype=np.int64)
    times = ((stamps - stamps[0]).astype(np.float64) * 1e-6).astype(np.float32)
    arr = {"times": times, "centers": centers, "quats": quats, "valid": valid,
           "sizes": np.tile(np.array([VEHICLE_SIZE], np.float32), (O, 1)),
           "obj_first": np.array([s[0] for s in st], np.float32),
           "obj_last": np.array([s[1] for s in st], np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in arr.items()}, stamps


def _qmul(a, b) -> tuple:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw)


def c2w(cfg: dict, g: int) -> np.ndarray:
    """OpenGL camera-to-world (3, 4) of image g: the ego 1 m a frame
    (cfg["ego_step_m"]) down the street (-z), the camera yawed about the
    vertical (+y; positive turns the view to -x, the left)."""
    F = frames(cfg)
    _, _, yaw = cameras(cfg)[g // F]
    c, s = math.cos(yaw), math.sin(yaw)
    out = np.array([[c, 0.0, s, 0.0], [0.0, 1.0, 0.0, 0.0],
                    [-s, 0.0, c, -cfg["ego_step_m"] * (g % F)]], np.float32)
    return out


def camera(cfg: dict, traffic: dict, tracks: dict, g: int, device) -> dict:
    return scene.camera(c2w(cfg, g), traffic["width"], traffic["height"],
                        traffic["focal"],
                        tracks["times"][g % frames(cfg)].item(), device)


def vehicles_in_view(cfg: dict, traffic: dict, tracks: dict, g: int,
                     margin: float = 0.1, near: float = 2.0) -> int:
    """The vehicles annotated at image g's frame whose box centre lies at
    least `near` m in front of the camera and projects inside the image,
    `margin` of its width and height from each edge."""
    c2w_g = c2w(cfg, g).astype(np.float64)
    f = g % frames(cfg)
    centers = tracks["centers"][f].cpu().numpy().astype(np.float64)
    valid = tracks["valid"][f].cpu().numpy()
    p = (centers - c2w_g[:, 3]) @ c2w_g[:, :3]       # camera frame, -z ahead
    depth = -p[:, 2]
    w, h, focal = traffic["width"], traffic["height"], traffic["focal"]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = focal * p[:, 0] / depth + w / 2
        v = -focal * p[:, 1] / depth + h / 2
    inside = ((depth > near) & (u >= margin * w) & (u <= (1 - margin) * w)
              & (v >= margin * h) & (v <= (1 - margin) * h))
    return int((inside & valid).sum())


def image_count(cfg: dict) -> int:
    return frames(cfg) * len(cfg["cameras"])


def target_image(seed: int, g: int, width: int, height: int, block: int,
                 device) -> torch.Tensor:
    """Image g's target (H, W, 3) in [0, 1], uint8 steps: a blocky pattern
    with fine noise over it, from a generator of its own."""
    gen = scene.generator(seed ^ IMAGE_SEED ^ (g << 20), device)
    hb, wb = -(-height // block), -(-width // block)
    coarse = torch.rand((hb, wb, 3), generator=gen, device=device)
    img = coarse.repeat_interleave(block, 0).repeat_interleave(block, 1)
    img = img[:height, :width] * 0.8 + 0.2 * torch.rand(
        (height, width, 3), generator=gen, device=device)
    return torch.floor(img * 255.0) / 255.0


def image_name(cfg: dict, g: int, stamps) -> str:
    cam_id = cameras(cfg)[g // frames(cfg)][0]
    return f"cam{cam_id}/{int(stamps[g % frames(cfg)])}.png"


def _write_png(path: Path, arr: np.ndarray) -> None:
    """Stored, not deflated: the quickest to write and to decode."""
    from PIL import Image
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path, compress_level=0)


def write_clip(root: Path, seed: int, cfg: dict, traffic: dict,
               stamps: np.ndarray, tracks: dict, device,
               pool: concurrent.futures.Executor) -> list:
    """The clip: three PINHOLE cameras of one size, every image's pose,
    points3D.bin with the seed cloud on the street, transform.json,
    annotation.json with each vehicle over its stretch, each vehicle's
    LiDAR as a .ply, PNG images (target_image, made on `device` one at a
    time, encoded on `pool`) and one segmentation with the top third sky,
    linked to every image's name. Returns the images' futures: the clip
    is whole once they are done."""
    rng = np.random.default_rng(seed)
    w, h, focal = traffic["width"], traffic["height"], traffic["focal"]
    cams = cameras(cfg)
    n_img = image_count(cfg)
    names = [image_name(cfg, g, stamps) for g in range(n_img)]
    recon = root / "colmap" / "sparse" / "0"
    recon.mkdir(parents=True)
    with open(recon / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam_id, _, _ in cams:
            f.write(struct.pack("<iiQQ", cam_id, 1, w, h))
            f.write(struct.pack("<4d", focal, focal, w / 2, h / 2))
    with open(recon / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", n_img))
        for g, name in enumerate(names):
            cv = np.eye(4)
            cv[:3] = c2w(cfg, g)
            cv[:3, 1:3] *= -1                      # OpenGL -> OpenCV
            w2c = np.linalg.inv(cv)
            f.write(struct.pack("<idddddddi", g + 1,
                                *scene._rotmat2qvec(w2c[:3, :3]),
                                *w2c[:3, 3], cams[g // frames(cfg)][0]))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    n = cfg["seed_points"]
    xyz = _street_np(rng, n, drive_length(cfg) + cfg["view_ahead_m"])
    rec = np.zeros(n, np.dtype([("id", "<u8"), ("xyz", "<f8", 3),
                                ("rgb", "u1", 3), ("err", "<f8"),
                                ("track", "<u8")]))
    rec["id"] = np.arange(n)
    rec["xyz"] = xyz
    rec["rgb"] = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    rec["err"] = 0.5
    with open(recon / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", n))
        f.write(rec.tobytes())
    F = frames(cfg)
    with open(root / "transform.json", "w") as f:
        json.dump({"frames": [
            {"file_path": f"images/{nm}", "timestamp": int(stamps[g % F]),
             "transform_matrix": np.eye(4).tolist()}
            for g, nm in enumerate(names)]}, f)
    centers = tracks["centers"].cpu().numpy()
    quats = tracks["quats"].cpu().numpy()
    valid = tracks["valid"].cpu().numpy()
    sizes = tracks["sizes"].cpu().numpy()
    O = centers.shape[1]
    with open(root / "annotation.json", "w") as f:
        json.dump({"frames": [
            {"timestamp": int(s), "objects": [
                {"gid": f"veh{o}", "type": "car", "is_moving": True,
                 "translation": centers[fi, o].tolist(),
                 "rotation": quats[fi, o].tolist(),
                 "size": sizes[o].tolist()}
                for o in range(O) if valid[fi, o]]}
            for fi, s in enumerate(stamps)]}, f)
    lidar = root / "aggregate_lidar" / "dynamic_objects"
    lidar.mkdir(parents=True)
    m = cfg["lidar_points_per_object"]
    for o in range(O):
        xyz = (rng.standard_normal((m, 3)) * np.array(OBJECT_SD)
               ).astype(np.float32)
        scene._write_ply(lidar / f"veh{o}.ply", xyz,
                         rng.integers(0, 256, (m, 3), dtype=np.uint8))
    seg = np.zeros((h, w), np.uint8)
    seg[: h // 3] = scene.SKY_ID
    first = root / "segs" / names[0]
    _write_png(first, seg)
    for name in names[1:]:
        p = root / "segs" / name
        p.parent.mkdir(parents=True, exist_ok=True)
        os.link(first, p)
    futures = []
    for g, name in enumerate(names):
        img = target_image(seed, g, w, h, traffic["image_block"], device)
        arr = (img * 255.0).round().to(torch.uint8).cpu().numpy()
        futures.append(pool.submit(_write_png, root / "images" / name, arr))
    return futures

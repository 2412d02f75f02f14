"""The benchmark's own inputs, made from `--seed`: the scene graph's weights
(on the device, with one torch.Generator in a few large calls), the tracks,
the cameras of a clip and of a drive, target images, and the clip on disk
that the trainer reads (COLMAP binary model, transform.json,
annotation.json, per-vehicle LiDAR .ply, PNG images and segmentations).

The street corridor follows the JAX package's bench.py (xy ~ N(0, [8, 2]),
z = -(U^1.5) 60 - 2); vehicles are box-shaped clouds on tracks driving
down it. These are frozen copies: a later change to the program does not
change what is measured.
"""
from __future__ import annotations

import json
import math
import struct
from pathlib import Path

import numpy as np
import torch

SH_C0 = 0.28209479177387814
SKY_ID = 27                  # Mapillary sky; the data layer maps it to 2
SKY_SEMANTIC = 2
CLIP_TS0 = 1_557_000_000_000_000
CLIP_DT_US = 100_000         # 0.1 s between frames
LANES = (-3.0, 3.0, -1.5, 1.5)
PARAMS = ("means", "scales", "quats", "features_dc", "features_rest",
          "opacities")


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & ((1 << 63) - 1))
    return g


def _cloud(g, n: int, lead: tuple, fourier: int, sh_degree: int,
           log_scale: float, mean_sd, mean_fn, device) -> dict:
    """One cloud of gaussians: a normal and a uniform draw, sliced."""
    k = (sh_degree + 1) ** 2 - 1
    shape = lead + (n,)
    nrm = torch.randn(shape + (3 + 3 + 4 + 3 * (fourier - 1) + 3 * k,),
                      generator=g, device=device)
    uni = torch.rand(shape + (3 + 3 + 1,), generator=g, device=device)
    means = mean_fn(nrm[..., 0:3], uni[..., 0:3], mean_sd)
    scales = nrm[..., 3:6] * 0.5 + log_scale
    q = nrm[..., 6:10]
    quats = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    dc = torch.zeros(shape + (fourier, 3), device=device)
    dc[..., 0, :] = (uni[..., 3:6] - 0.5) / SH_C0
    o = 10
    if fourier > 1:
        dc[..., 1:, :] = 0.2 * nrm[..., o:o + 3 * (fourier - 1)].reshape(
            shape + (fourier - 1, 3))
        o += 3 * (fourier - 1)
    rest = 0.05 * nrm[..., o:o + 3 * k].reshape(shape + (k, 3))
    op = uni[..., 6:7] * 0.8 + 0.1
    return {"means": means, "scales": scales, "quats": quats,
            "features_dc": dc, "features_rest": rest,
            "opacities": torch.log(op / (1.0 - op))}


def _corridor(nrm, uni, sd):
    xy = nrm[..., 0:2] * torch.tensor(sd, device=nrm.device)
    z = -(uni[..., 0:1] ** 1.5) * 60.0 - 2.0
    return torch.cat([xy, z], -1)


def _box(nrm, uni, sd):
    return nrm * torch.tensor(sd, device=nrm.device)


def make_scene(seed: int, cfg: dict, device) -> dict:
    """The store's leaves as a flat dict ("bg/<param>", "bg/active",
    "obj/<param>", "obj/active", "env_map", "delta_center", "delta_yaw",
    "delta_rot"), made on `device` from the seed. One slot in
    cfg["inactive_every"] is inactive and holds zeros: a trainer's
    headroom for the children of a refinement pass."""
    g = generator(seed, device)
    sh = cfg["sh_degree"]
    out = {}
    bg = _cloud(g, cfg["background_capacity"], (), cfg["background_fourier"],
                sh, -3.3, (8.0, 2.0), _corridor, device)
    out.update({f"bg/{k}": v for k, v in bg.items()})
    n_obj = cfg["objects"]
    if n_obj:
        ob = _cloud(g, cfg["object_capacity"], (n_obj,),
                    cfg["object_fourier"], sh, -3.8, (0.6, 0.4, 1.2), _box,
                    device)
        out.update({f"obj/{k}": v for k, v in ob.items()})
    every = cfg["inactive_every"]
    for part in ("bg", "obj") if n_obj else ("bg",):
        active = torch.ones(out[f"{part}/means"].shape[:-1], dtype=torch.bool,
                            device=device)
        active[..., every - 1::every] = False
        out[f"{part}/active"] = active
        free = ~active
        for k in PARAMS:
            x = out[f"{part}/{k}"]
            m = free.reshape(free.shape + (1,) * (x.dim() - free.dim()))
            out[f"{part}/{k}"] = torch.where(m, torch.zeros_like(x), x)
    r = cfg["env_map_res"]
    out["env_map"] = torch.rand((6, r, r, 3), generator=g, device=device)
    F = cfg["track_frames"]
    d = torch.randn((F, max(n_obj, 0), 4), generator=g, device=device)
    out["delta_center"] = 0.05 * d[..., :3].contiguous()
    out["delta_yaw"] = 0.02 * d[..., 3].contiguous()
    out["delta_rot"] = torch.zeros((F, n_obj, 3), device=device)
    return out


def make_tracks(cfg: dict, device) -> dict:
    """F annotated frames 0.1 s apart; vehicle o in lane LANES[o % 4],
    10 + 9 o metres ahead, moving 1.2 m a frame down the corridor."""
    F, O = cfg["track_frames"], cfg["objects"]
    centers = np.zeros((F, O, 3), np.float32)
    quats = np.zeros((F, O, 4), np.float32)
    for f in range(F):
        for o in range(O):
            centers[f, o] = (LANES[o % 4], -1.2, -(10.0 + 9.0 * o) - 1.2 * f)
            yaw = 0.1 * (o - 1.5) + 0.03 * f
            quats[f, o] = (math.cos(yaw / 2), 0.0, math.sin(yaw / 2), 0.0)
    stamps = CLIP_TS0 + CLIP_DT_US * np.arange(F, dtype=np.int64)
    times = ((stamps - stamps[0]).astype(np.float64) * 1e-6).astype(np.float32)
    arr = {"times": times, "centers": centers, "quats": quats,
           "valid": np.ones((F, O), bool),
           "sizes": np.tile(np.array([[2.4, 1.6, 4.8]], np.float32), (O, 1)),
           "obj_first": np.zeros((O,), np.float32),
           "obj_last": np.full((O,), F - 1, np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in arr.items()}, stamps


def camera(c2w: np.ndarray, width: int, height: int, focal: float,
           time: float, device) -> dict:
    """A pinhole camera as the reference takes it (OpenGL c2w (3, 4))."""
    return {"c2w": torch.as_tensor(np.asarray(c2w, np.float32)[:3, :4],
                                   device=device),
            "fx": float(focal), "fy": float(focal), "cx": width / 2.0,
            "cy": height / 2.0, "width": int(width), "height": int(height),
            "time": float(np.float32(time))}


def clip_poses(frames: int) -> list:
    """The clip's cameras: 1.5 m apart down the corridor (-z)."""
    out = []
    for i in range(frames):
        c2w = np.eye(4, dtype=np.float32)
        c2w[2, 3] = -1.5 * i
        out.append(c2w[:3])
    return out


def drive_poses(n: int, length: float, frames: int) -> list:
    """A drive of n poses down the corridor with a slow sway and yaw, its
    times spread over the tracks' span so the vehicles move. Returns
    [(c2w (3, 4), time)]."""
    out = []
    span = (frames - 1) * CLIP_DT_US * 1e-6
    for i in range(n):
        s = i / max(n - 1, 1)
        yaw = 0.05 * math.sin(2 * math.pi * s)
        c, si = math.cos(yaw), math.sin(yaw)
        c2w = np.array([[c, 0.0, si, 0.8 * math.sin(2 * math.pi * s)],
                        [0.0, 1.0, 0.0, 0.1 * math.sin(4 * math.pi * s)],
                        [-si, 0.0, c, -length * s]], np.float32)
        out.append((c2w, float(np.float32(span * s))))
    return out


def target_images(seed: int, n: int, width: int, height: int, block: int,
                  device) -> torch.Tensor:
    """n target images (n, H, W, 3) in [0, 1], uint8 steps: a blocky
    pattern (block x block pixels) with fine noise over it."""
    g = generator(seed ^ 0x5EED, device)
    hb, wb = -(-height // block), -(-width // block)
    coarse = torch.rand((n, hb, wb, 3), generator=g, device=device)
    img = coarse.repeat_interleave(block, 1).repeat_interleave(block, 2)
    img = img[:, :height, :width] * 0.8 + 0.2 * torch.rand(
        (n, height, width, 3), generator=g, device=device)
    return torch.floor(img * 255.0) / 255.0


def semantic_map(width: int, height: int, device) -> torch.Tensor:
    """(H, W, 1) int32: the top third sky."""
    s = torch.zeros((height, width, 1), dtype=torch.int32, device=device)
    s[: height // 3] = SKY_SEMANTIC
    return s


def _rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """COLMAP's rotmat2qvec (wxyz)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([[Rxx - Ryy - Rzz, 0, 0, 0],
                  [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                  [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                  [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def _rgb8(dc0: np.ndarray) -> np.ndarray:
    return (np.clip(dc0 * SH_C0 + 0.5, 0.0, 1.0) * 255).astype(np.uint8)


def _write_ply(path: Path, xyz: np.ndarray, rgb: np.ndarray) -> None:
    n = len(xyz)
    rec = np.zeros(n, np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                ("red", "u1"), ("green", "u1"),
                                ("blue", "u1")]))
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {n}\nproperty float x\nproperty float y\n"
            "property float z\nproperty uchar red\nproperty uchar green\n"
            "property uchar blue\nend_header\n")
    with open(path, "wb") as f:
        f.write(head.encode())
        f.write(rec.tobytes())


def write_clip(root: Path, seed: int, cfg: dict, traffic: dict,
               images: np.ndarray, stamps: np.ndarray, tracks: dict) -> None:
    """A clip in the layout the data parser reads: one PINHOLE camera,
    the frames' poses (clip_poses), points3D.bin with the seed cloud,
    transform.json, annotation.json with the vehicles' boxes, each
    vehicle's LiDAR as a .ply, PNG images (`images`, (F, H, W, 3) uint8)
    and segmentations with the top third sky."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    w, h, focal = traffic["width"], traffic["height"], traffic["focal"]
    F = len(stamps)
    names = [f"cam1/{s}.png" for s in stamps]
    recon = root / "colmap" / "sparse" / "0"
    recon.mkdir(parents=True)
    with open(recon / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, w, h))
        f.write(struct.pack("<4d", focal, focal, w / 2, h / 2))
    with open(recon / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", F))
        for i, (name, c2w) in enumerate(zip(names, clip_poses(F))):
            cv = np.eye(4)
            cv[:3] = c2w
            cv[:3, 1:3] *= -1                      # OpenGL -> OpenCV
            w2c = np.linalg.inv(cv)
            f.write(struct.pack("<idddddddi", i + 1,
                                *_rotmat2qvec(w2c[:3, :3]), *w2c[:3, 3], 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    n = cfg["seed_points"]
    xy = rng.standard_normal((n, 2)) * np.array([8.0, 2.0])
    z = -(rng.random(n) ** 1.5) * 60.0 - 2.0
    rec = np.zeros(n, np.dtype([("id", "<u8"), ("xyz", "<f8", 3),
                                ("rgb", "u1", 3), ("err", "<f8"),
                                ("track", "<u8")]))
    rec["id"] = np.arange(n)
    rec["xyz"] = np.concatenate([xy, z[:, None]], 1)
    rec["rgb"] = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    rec["err"] = 0.5
    with open(recon / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", n))
        f.write(rec.tobytes())
    with open(root / "transform.json", "w") as f:
        json.dump({"frames": [
            {"file_path": f"images/{nm}", "timestamp": int(s),
             "transform_matrix": np.eye(4).tolist()}
            for nm, s in zip(names, stamps)]}, f)
    centers = tracks["centers"].cpu().numpy()
    quats = tracks["quats"].cpu().numpy()
    sizes = tracks["sizes"].cpu().numpy()
    O = centers.shape[1]
    with open(root / "annotation.json", "w") as f:
        json.dump({"frames": [
            {"timestamp": int(s), "objects": [
                {"gid": f"veh{o}", "type": "car", "is_moving": True,
                 "translation": centers[fi, o].tolist(),
                 "rotation": quats[fi, o].tolist(),
                 "size": sizes[o].tolist()} for o in range(O)]}
            for fi, s in enumerate(stamps)]}, f)
    lidar = root / "aggregate_lidar" / "dynamic_objects"
    lidar.mkdir(parents=True)
    m = cfg["lidar_points_per_object"]
    for o in range(O):
        xyz = (rng.standard_normal((m, 3)) * np.array([0.6, 0.4, 1.2])
               ).astype(np.float32)
        _write_ply(lidar / f"veh{o}.ply", xyz,
                   rng.integers(0, 256, (m, 3), dtype=np.uint8))
    seg = np.zeros((h, w), np.uint8)
    seg[: h // 3] = SKY_ID
    for name, img in zip(names, images):
        for sub, arr in (("images", img), ("segs", seg)):
            p = root / sub / name
            p.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(arr).save(p, compress_level=1)

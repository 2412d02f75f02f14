"""Dynamic-object masks for COLMAP feature masking (counterpart of
street_gaussians_ns_tpu/preprocess/masks_generate.py; the per-pixel work
on the caller's device).

Native equivalent of scripts/pythons/masks_generate.py: per image, project
every moving object's 3D box corners, inflate the 2D bbox by 1/10 per
side, zero the mask inside it, then restore near-black pixels (all RGB <
96) in the LOWER HALF of the box to value 1 (the reference's dark-pixel
heuristic for road under the car, :222-248). Untouched pixels stay 255.

The corners and their projection stay host numpy in float64, as in the
JAX package; the rectangles, the dark test and the erosion run on
`--device`. Images are decoded by OpenCV, as the reference decodes them
(`cv2.imread`, then BGR to RGB): the dark test thresholds the decoded
pixels, and Pillow's decode can differ (OpenCV applies a JPEG's EXIF
orientation, Pillow does not). A missing OpenCV raises the ImportError
that names it; masks are written by Pillow.

Usage:
    python -m street_gaussians_ns_tpu_torch.preprocess.masks_generate \
        --data /clip [--dilate 25] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..data.annotations import quat_to_rotmat_np
from ..engine.trainer import resolve_device
from ..utils.optional import opencv, pillow_image


def get_box_corners(translation, lwh, rotation_wxyz):
    l, w, h = lwh
    corners = np.array([
        [sx * l / 2, sy * w / 2, sz * h / 2]
        for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    R = quat_to_rotmat_np(np.asarray(rotation_wxyz, np.float64))
    return corners @ R.T + np.asarray(translation)


def erode(mask: torch.Tensor, k: int) -> torch.Tensor:
    """cv2.erode(mask, np.ones((k, k))) of an (H, W) uint8 mask: the
    minimum over the window of offsets -(k // 2) .. k - 1 - k // 2 in each
    axis (cv2's default anchor, so uneven for even k); pixels outside the
    image do not erode (cv2 pads erosion with the type's maximum). The
    window is separable: rows, then columns."""
    lo, hi = k // 2, k - 1 - k // 2
    x = F.pad(mask[None], (lo, hi, lo, hi), value=255)[0]
    x = x.unfold(1, k, 1).amin(-1)
    return x.unfold(0, k, 1).amin(-1)


def decode_rgb(path: Path, device) -> torch.Tensor:
    """(H, W, 3) uint8 on `device`: cv2.imread, then BGR to RGB."""
    cv2 = opencv()
    img = cv2.imread(str(path))
    if img is None:
        raise OSError(f"OpenCV cannot read {path}")
    return torch.from_numpy(cv2.cvtColor(img, cv2.COLOR_BGR2RGB)).to(device)


def image_boxes(fr: dict, objects: list) -> list:
    """The inflated 2D boxes [x0, y0, x1, y1] of the moving objects in
    frame fr, from their projected corners (host, float64; astype(int)
    truncates toward zero)."""
    w, h = int(fr["w"]), int(fr["h"])
    K = np.array([[fr["fl_x"], 0, fr["cx"]],
                  [0, fr["fl_y"], fr["cy"]], [0, 0, 1.0]])
    c2w = np.asarray(fr["transform_matrix"], np.float64)
    # OpenGL/blender pose -> OpenCV for projection.
    c2w = c2w[np.array([1, 0, 2, 3]), :]
    c2w[2, :] *= -1
    c2w[0:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w)
    boxes = []
    for obj in objects:
        if not obj.get("is_moving"):
            continue
        corners = get_box_corners(obj["translation"], obj["size"],
                                  obj["rotation"])
        uvs = []
        for m in corners:
            p = w2c @ np.append(m, 1.0)
            if p[2] > 0:
                uv = K @ p[:3]
                uvs.append((uv[:2] / uv[2]).astype(int))
        if not uvs:
            continue
        us = [u for u, _ in uvs]
        vs = [v for _, v in uvs]
        umin, umax = max(min(us), 0), min(max(us), w - 1)
        vmin, vmax = max(min(vs), 0), min(max(vs), h - 1)
        if umin >= umax or vmin >= vmax:
            continue
        boxes.append([
            max(umin - (umax - umin) // 10, 0),
            max(vmin - (vmax - vmin) // 10, 0),
            min(umax + (umax - umin) // 10, w - 1),
            min(vmax + (vmax - vmin) // 10, h - 1)])
    return boxes


def frame_mask(img: torch.Tensor, boxes: list, dilate: int) -> torch.Tensor:
    """(H, W) uint8 mask of an (H, W, 3) image and its boxes: 0 inside a
    box, 1 on its lower half's dark pixels (every channel < 96), 255
    elsewhere; eroded by a dilate x dilate window when dilate > 0. Boxes
    apply in order, so a later box overwrites an earlier one."""
    mask = torch.full(img.shape[:2], 255, dtype=torch.uint8,
                      device=img.device)
    for x0, y0, x1, y1 in boxes:
        mask[y0:y1, x0:x1] = 0
        y0h = y0 + (y1 - y0) // 2
        dark = (img[y0h:y1, x0:x1] < 96).all(2)
        mask[y0h:y1, x0:x1].masked_fill_(dark, 1)
    return erode(mask, dilate) if dilate > 0 else mask


def generate_masks(data: Path, dilate: int = 0, device="cuda") -> int:
    """Returns the number of masks written."""
    Image = pillow_image()
    device = resolve_device(device)
    meta = json.load(open(data / "transform.json"))
    annos = json.load(open(data / "annotation.json"))["frames"]
    anno_by_ts = {round(float(a["timestamp"]), 6): a["objects"]
                  for a in annos}

    written = 0
    for fr in meta["frames"]:
        if fr.get("type") == "lidar" or "fl_x" not in fr:
            continue
        image_path = data / fr["file_path"]
        if not image_path.exists():
            continue
        mask_path = data / "masks" / Path(fr["file_path"]).relative_to(
            "images")
        mask_path = mask_path.with_suffix(".png")
        mask_path.parent.mkdir(parents=True, exist_ok=True)
        boxes = image_boxes(
            fr, anno_by_ts.get(round(float(fr["timestamp"]), 6), []))
        if boxes:
            mask = frame_mask(decode_rgb(image_path, device), boxes,
                              dilate).cpu().numpy()
        else:
            mask = np.full((int(fr["h"]), int(fr["w"])), 255, np.uint8)
        Image.fromarray(mask).save(mask_path)
        written += 1
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--dilate", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the per-pixel work (default cuda; "
                        "cpu runs it on the host)")
    args = p.parse_args(argv)
    n = generate_masks(args.data, args.dilate, args.device)
    print(f"wrote {n} masks")
    return n


if __name__ == "__main__":
    main()

"""Per-frame data loading: images, masks, semantics (+ undistortion)
(counterpart of street_gaussians_ns_tpu/data/dataset.py; Pillow and OpenCV
come through utils.optional, so a missing one raises an ImportError that
names it).

Native equivalent of InputDataset (sgn_dataset.py:27-159) and the semantic
loaders (data/utils/data_utils.py): PIL image decode with alpha blending,
bool masks, Mapillary-Vistas label remap {7,8,13,14,23,24}->GROUND, 27->SKY
(:65-66), and OpenCV undistortion at cache time like the reference's
threadpool undistortion (sgn_datamanager.py:174-185, 326-497).
"""
from __future__ import annotations

import dataclasses
import os
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np

from . import fisheye624
from ..core import cameras
from ..utils.optional import opencv, pillow_image

# SemanticType (data_utils.py:26-29)
SEM_DEFAULT, SEM_GROUND, SEM_SKY = 0, 1, 2
_GROUND_IDS = (7, 8, 13, 14, 23, 24)
_SKY_ID = 27


def load_image(path: Path) -> np.ndarray:
    """(H, W, 3) float32 in [0,1]; RGBA alpha-blended over white
    (sgn_dataset.py:51-100 composite behavior)."""
    Image = pillow_image()
    img = np.asarray(Image.open(path))
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    img = img.astype(np.float32) / 255.0
    if img.shape[-1] == 4:
        a = img[..., 3:4]
        img = img[..., :3] * a + (1.0 - a)
    return img[..., :3]


def load_mask(path: Path) -> np.ndarray:
    """(H, W, 1) bool; nonzero = keep."""
    Image = pillow_image()
    m = np.asarray(Image.open(path))
    if m.ndim == 3:
        m = m[..., 0]
    return (m > 0)[..., None]


def load_semantics(path: Path) -> np.ndarray:
    """(H, W, 1) int32 in {DEFAULT, GROUND, SKY} via the Mapillary remap."""
    Image = pillow_image()
    s = np.asarray(Image.open(path))
    if s.ndim == 3:
        s = s[..., 0]
    out = np.zeros_like(s, dtype=np.int32)
    for gid in _GROUND_IDS:
        out[s == gid] = SEM_GROUND
    out[s == _SKY_ID] = SEM_SKY
    return out[..., None]


def load_depth(path: Path, scale_factor: float = 1.0) -> np.ndarray:
    """(H, W, 1) float32 depth. Supports .npy/.npz, 16-bit png (mm), and
    the 2x8bit-channel png packing — the loader set of
    data/utils/data_utils.py:73-110."""
    Image = pillow_image()
    p = Path(path)
    if p.suffix == ".npy":
        d = np.load(p)
    elif p.suffix == ".npz":
        z = np.load(p)
        d = z[list(z.keys())[0]]
    else:
        img = np.asarray(Image.open(p))
        if img.dtype == np.uint16:
            d = img.astype(np.float32) / 1000.0     # mm -> m
        elif img.ndim == 3 and img.shape[-1] >= 2:
            # two 8-bit channels: high*256 + low, in mm
            d = (img[..., 0].astype(np.float32) * 256.0
                 + img[..., 1].astype(np.float32)) / 1000.0
        else:
            d = img.astype(np.float32)
    d = np.asarray(d, np.float32) * scale_factor
    if d.ndim == 2:
        d = d[..., None]
    return d


def undistort_frame(
    image: np.ndarray,
    fx: float, fy: float, cx: float, cy: float,
    dist: np.ndarray,        # [k1 k2 k3 k4 p1 p2]
    fisheye: bool,
    mask: Optional[np.ndarray] = None,
    semantic: Optional[np.ndarray] = None,
):
    """OpenCV undistortion (PERSPECTIVE / FISHEYE paths of
    sgn_datamanager._undistort_image:326-497). Returns (image, new
    intrinsics (fx,fy,cx,cy), mask, semantic)."""
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    h, w = image.shape[:2]
    if not np.any(dist):
        return image, (fx, fy, cx, cy), mask, semantic
    cv2 = opencv()
    if fisheye:
        D = np.array(dist[:4], np.float64)
        newK = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
            K, D, (w, h), np.eye(3), balance=0.0)
        m1, m2 = cv2.fisheye.initUndistortRectifyMap(
            K, D, np.eye(3), newK, (w, h), cv2.CV_32FC1)
        remap = lambda x, interp: cv2.remap(x, m1, m2, interpolation=interp)  # noqa: E731
        image = remap(image, cv2.INTER_LINEAR)
        mask = None if mask is None else remap(
            mask.astype(np.uint8), cv2.INTER_NEAREST).astype(bool)
        semantic = None if semantic is None else remap(
            semantic.astype(np.int32)[..., 0], cv2.INTER_NEAREST
        ).astype(np.int32)[..., None]
    else:
        D = np.array([dist[0], dist[1], dist[4], dist[5], dist[2]],
                     np.float64)  # k1 k2 p1 p2 k3
        newK, _ = cv2.getOptimalNewCameraMatrix(K, D, (w, h), 0, (w, h))
        image = cv2.undistort(image, K, D, None, newK)
        if mask is not None:
            mask = cv2.undistort(mask.astype(np.uint8), K, D, None,
                                 newK).astype(bool)
        if semantic is not None:
            semantic = cv2.undistort(
                semantic.astype(np.float32)[..., 0], K, D, None, newK
            ).astype(np.int32)[..., None]
    if mask is not None and mask.ndim == 2:
        mask = mask[..., None]
    return (image, (float(newK[0, 0]), float(newK[1, 1]),
                    float(newK[0, 2]), float(newK[1, 2])), mask, semantic)


@dataclasses.dataclass
class FrameData:
    """One cached training frame (host numpy, pinned to device by the
    datamanager)."""

    image: np.ndarray                # (H, W, 3) f32
    mask: Optional[np.ndarray]       # (H, W, 1) bool
    semantic: Optional[np.ndarray]   # (H, W, 1) int32
    fx: float
    fy: float
    cx: float
    cy: float
    c2w: np.ndarray                  # (3, 4)
    time: float
    width: int
    height: int


def auto_downscale_factor(width: int, height: int,
                          max_dim: int = 1600) -> int:
    """Power-of-two factor bringing max(width, height) under max_dim —
    the reference's auto-downscale rule (sgn_dataparser.py:39,697-711:
    frames over ~1600 px are halved until they fit)."""
    d = 1
    while max(width, height) // d > max_dim:
        d *= 2
    return d


def _cache_path(scene, idx: int, undistort: bool, downscale: int):
    """On-disk cache location mirroring the reference's `_ud` / `_2`
    sibling-dir convention (sgn_dataparser.py:745-753): for source
    <root>/images/cam/ts.jpg the processed frame lives at
    <root>/images_ud_2/cam/ts.npz (suffixes only for the applied steps)."""
    src = Path(scene.image_paths[idx])
    parts = list(src.parts)
    # The images dir is the path component directly under the clip root;
    # fall back to the immediate parent when the layout is flat.
    anchor = len(parts) - 2 if len(parts) >= 2 else 0
    suffix = ("_ud" if undistort else "") + (
        f"_{downscale}" if downscale > 1 else "")
    if not suffix:
        return None
    for i in range(len(parts) - 2, -1, -1):
        if parts[i] == "images":
            anchor = i
            break
    parts[anchor] = parts[anchor] + suffix
    return Path(*parts).with_suffix(".npz")


def _save_cache(path: Path, frame: "FrameData") -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    data = {
        "image": (np.clip(frame.image, 0, 1) * 255).astype(np.uint8),
        "intr": np.array([frame.fx, frame.fy, frame.cx, frame.cy],
                         np.float64),
    }
    if frame.mask is not None:
        data["mask"] = frame.mask
    if frame.semantic is not None:
        data["semantic"] = frame.semantic
    # The ranks of a multi-process run on one machine may cache the same
    # frame at once: each writes a file of its own, and the rename that
    # publishes it is atomic.
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
    np.savez(tmp, **data)
    tmp.replace(path)


def _load_cache(path: Path, scene, idx: int) -> Optional["FrameData"]:
    try:
        if path.stat().st_mtime < Path(scene.image_paths[idx]).stat().st_mtime:
            return None          # stale: source re-extracted
        z = np.load(path)
        fx, fy, cx, cy = z["intr"]
        image = z["image"].astype(np.float32) / 255.0
        mask = z["mask"] if "mask" in z else None
        semantic = z["semantic"] if "semantic" in z else None
    except (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile):
        return None              # unreadable cache: decode the source again
    h, w = image.shape[:2]
    return FrameData(image=image, mask=mask, semantic=semantic,
                     fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
                     c2w=np.asarray(scene.c2w[idx]),
                     time=float(scene.times[idx]), width=w, height=h)


def load_frame(scene, idx: int, undistort: bool = True,
               downscale: int = 1, disk_cache: bool = False) -> FrameData:
    """Load + undistort (+ downscale) frame `idx` of a ParsedScene.

    disk_cache persists the processed frame next to the source images
    (`images_ud_2/` convention) so later runs skip the OpenCV remap +
    resize entirely — the reference's offline undistort-and-save pipeline
    (sgn_dataparser.py:544-743)."""
    cache = (_cache_path(scene, idx, undistort, downscale)
             if disk_cache else None)
    if cache is not None and cache.exists():
        hit = _load_cache(cache, scene, idx)
        if hit is not None:
            return hit
    image = load_image(scene.image_paths[idx])
    mask = None
    if scene.mask_paths is not None and scene.mask_paths[idx].exists():
        mask = load_mask(scene.mask_paths[idx])
    semantic = None
    if (scene.segment_paths is not None
            and scene.segment_paths[idx].exists()):
        semantic = load_semantics(scene.segment_paths[idx])

    fx, fy, cx, cy = (float(scene.fx[idx]), float(scene.fy[idx]),
                      float(scene.cx[idx]), float(scene.cy[idx]))
    if undistort:
        model = int(scene.camera_model[idx])
        if model == cameras.FISHEYE624:
            d = scene.distortion[idx]
            # (N, 12) row [k1 k2 k3 k4 p1 p2 k5 k6 s1 s2 s3 s4] -> the
            # 16-parameter fisheye624 vector (fisheye624.py docstring).
            params16 = np.array(
                [fx, fy, cx, cy, d[0], d[1], d[2], d[3], d[6], d[7],
                 d[4], d[5], d[8], d[9], d[10], d[11]], np.float64)
            crop = scene.fisheye_crop_radius
            if crop is None:
                h, w = image.shape[:2]
                crop = min(cx, cy, w - cx, h - cy)
            image, (fx, fy, cx, cy), mask, semantic = (
                fisheye624.undistort_frame_fisheye624(
                    image, params16, crop, semantic))
        else:
            image, (fx, fy, cx, cy), mask, semantic = undistort_frame(
                image, fx, fy, cx, cy, scene.distortion[idx],
                model == cameras.FISHEYE, mask, semantic)

    if downscale > 1:
        cv2 = opencv()
        h, w = image.shape[:2]
        nw, nh = w // downscale, h // downscale
        image = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_AREA)
        if mask is not None:
            mask = cv2.resize(mask.astype(np.uint8), (nw, nh),
                              interpolation=cv2.INTER_NEAREST
                              ).astype(bool)[..., None]
        if semantic is not None:
            semantic = cv2.resize(semantic[..., 0], (nw, nh),
                                  interpolation=cv2.INTER_NEAREST
                                  )[..., None]
        fx, fy, cx, cy = (fx / downscale, fy / downscale,
                          cx / downscale, cy / downscale)

    h, w = image.shape[:2]
    frame = FrameData(image=image, mask=mask, semantic=semantic,
                      fx=fx, fy=fy, cx=cx, cy=cy,
                      c2w=np.asarray(scene.c2w[idx]),
                      time=float(scene.times[idx]), width=w, height=h)
    if cache is not None:
        _save_cache(cache, frame)
    return frame

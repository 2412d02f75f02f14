"""Semantic segmentation PNGs (segs/) for the sky/ground losses
(counterpart of street_gaussians_ns_tpu/preprocess/segs_generate.py; the
naive labels computed on the caller's device).

The reference runs Mask2Former (Swin-L, Mapillary Vistas) offline
(scripts/pythons/segs_generate.py, C16/C-N5) — a GPU model zoo dependency
that is out of scope to retrain (SURVEY.md C-N5); only the argmax label
PNGs matter at train time (data.dataset.load_semantics remaps
{7,8,13,14,23,24}->GROUND, 27->SKY).

This tool either:
  * --mode mask2former: shells out to a user-provided Mask2Former demo
    script (run inside their checkout, as the reference README instructs);
  * --mode naive: a geometry-only fallback that labels sky by a
    brightness+gradient flood fill from the top rows and ground by the
    bottom band — crude but enough to exercise the sky-loss path on clips
    without a segmentation environment.

Images are decoded and the PNGs written by Pillow; the labels of an image
equal the JAX package's byte for byte.

Usage:
    python -m street_gaussians_ns_tpu_torch.preprocess.segs_generate \
        --data /clip [--mode naive] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ..engine.trainer import resolve_device
from ..utils.optional import pillow_image
from .pcd2colmap_points3d import load_rgb

SKY_ID = 27
GROUND_ID = 7


def naive_segment(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 -> (H, W) uint8 Mapillary-id label map via
    brightness flood, on img's device.

    The grey level is the channel sum over 3 in float64, as numpy's mean
    gives it: `grad < 6` sits on a rounding edge where two rows' sums
    differ by exactly 18, so float32 would change labels. A sky row
    reaches the columns beside the row above with wrap-around (np.roll).
    The reference's loop stops at the first row without sky; every later
    row is then empty anyway, so this loop runs every row and never reads
    the device's values back."""
    h = img.shape[0]
    gray = img.to(torch.float64).sum(2) / 3
    bright = gray > 140
    grad = (gray - torch.cat([gray[:1], gray[:-1]])).abs()
    candidate = bright & (grad < 6)
    rows = [candidate[0]]
    for r in range(1, h):
        prev = rows[-1]
        rows.append(candidate[r] & (prev | prev.roll(1) | prev.roll(-1)))
    sky = torch.stack(rows)
    out = torch.zeros(sky.shape, dtype=torch.uint8, device=img.device)
    out.masked_fill_(sky, SKY_ID)
    # Ground: bottom quarter, not sky.
    g0 = int(h * 0.75)
    out[g0:].masked_fill_(~sky[g0:], GROUND_ID)
    return out


def generate(data: Path, mode: str = "naive", device="cuda") -> int:
    Image = pillow_image()
    images = sorted((data / "images").rglob("*.jpg")) + \
        sorted((data / "images").rglob("*.png"))
    if mode != "naive":
        raise RuntimeError(
            "mask2former mode requires the external Mask2Former checkout "
            "(reference README.md:183); run their demo.py to fill segs/ "
            "and skip this tool")
    device = resolve_device(device)
    n = 0
    for img_path in images:
        seg_path = (data / "segs" / img_path.relative_to(data / "images")
                    ).with_suffix(".png")
        seg_path.parent.mkdir(parents=True, exist_ok=True)
        seg = naive_segment(load_rgb(img_path, device))
        Image.fromarray(seg.cpu().numpy()).save(seg_path)
        n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--mode", choices=["naive", "mask2former"],
                   default="naive")
    p.add_argument("--device", default="cuda",
                   help="torch device of the labels (default cuda; cpu "
                        "runs them on the host)")
    args = p.parse_args(argv)
    n = generate(args.data, args.mode, args.device)
    print(f"wrote {n} segmentations")
    return n


if __name__ == "__main__":
    main()

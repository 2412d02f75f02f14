"""The plain reference against the port at a tiny size on the CPU, the
faults the check has to catch, and the counts behind the bounds and mfu
against hand counts."""
from __future__ import annotations

import pytest
import torch

from benchmark import peaks
from benchmark.reference import gs
from benchmark.tests import tiny


@pytest.mark.parametrize("cell", ["sg_train_s3600", "splat_train_s3600",
                                  "sg_render_480"])
def test_reference_agrees_with_the_port(cell):
    r = tiny.run(cell)
    assert r["correct"], r["checks"]
    for name, v in r["checks"].items():
        assert v["value"] <= 1e-5, (name, v)


@pytest.mark.parametrize("cell,fault", [
    ("sg_train_s3600", "unchanged"), ("sg_train_s3600", "half_batch"),
    ("splat_train_s3600", "unchanged"), ("splat_train_s3600", "half_batch"),
    ("sg_render_480", "altered")])
def test_a_planted_fault_fails(cell, fault):
    r = tiny.run(cell, fault=fault)
    assert not r["correct"], r["checks"]
    assert r["failed"] >= 1


def _one_tile_scene(n: int, opacity: float):
    """n identical wide gaussians 5 m in front of a 16x16 camera."""
    means = torch.tensor([[0.0, 0.0, -5.0]]).repeat(n, 1)
    scales = torch.full((n, 3), 50.0)
    quats = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(n, 1)
    op = torch.full((n,), opacity)
    rgbs = torch.full((n, 3), 0.5)
    cam = {"c2w": torch.eye(4)[:3], "fx": 16.0, "fy": 16.0, "cx": 8.0,
           "cy": 8.0, "width": 16, "height": 16, "time": 0.0}
    return means, scales, quats, op, rgbs, cam


def test_the_walk_counts_evaluations_by_hand():
    # Opacity 0.995 everywhere in the tile: T = 0.005 after the first
    # pair, 2.5e-5 after the second, which saturates every pixel (next
    # T <= 1e-4 ends the pixel before it accumulates): 2 evaluations and 1
    # contributing a pixel; the third pair is never reached.
    counts = {}
    gs.render(*_one_tile_scene(3, 0.995), counts=counts)
    assert counts["pairs"] == 3
    assert counts["evals"] == 2 * 256
    assert counts["contrib"] == 256
    # Opacity 0.5: T halves each pair and never reaches 1e-4 in 3 pairs.
    counts = {}
    gs.render(*_one_tile_scene(3, 0.5), counts=counts)
    assert counts["evals"] == 3 * 256 and counts["contrib"] == 3 * 256


def test_operation_counts_by_hand():
    assert peaks.sh_ops(3) == 31 + 2 * 3 * 16
    assert peaks.fourier_ops(5) == 40
    work = {"active": 10, "active_objects": 4, "renders": 3, "evals": 1000,
            "pixels": 100}
    cfg = {"sh_degree": 3, "background_fourier": 1, "object_fourier": 5}
    per_g = 10 * 127 + 6 * 8 + 4 * (40 + 43)
    assert peaks.gaussian_ops(work, cfg) == per_g
    assert peaks.render_frame_ops(work, cfg) == (
        per_g + 10 * 3 * 153 + 16 * 1000 + 100 * 60)
    work.update(renders=1, contrib=400, params=590)
    fwd = per_g + 10 * 153 + 100 * (60 + peaks.OPS_LOSS_PER_PIXEL)
    assert peaks.train_step_ops(work, cfg) == (
        3 * fwd + 16 * 1000 * 2 + 51 * 400 + 12 * 590)
    d = {"ops_per": {"evals": 16}, "bytes_per": {"pairs": 48}}
    assert peaks.bound_seconds(d, {"evals": 67e12 / 16}) == pytest.approx(1)
    assert peaks.bound_seconds(d, {"evals": 1, "pairs": 3.35e12 / 48}
                               ) == pytest.approx(1)

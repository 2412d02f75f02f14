"""Inputs of the projection (core.projection.project, kernel L) that reach
each of its branches: slots in view, behind the near clip, beyond the
1.3x tan-FOV clamp and exactly on it, with a determinant <= 0 after the
blur, under the 1/255 opacity, with a zero or tiny quaternion, and with
centres on tile edges. Made with numpy from a seed, in any float dtype,
on any device; shared by the CPU tests (the closed-form backward against
autograd in float64) and the card tests (kernel L against the plain
version)."""
from __future__ import annotations

import numpy as np
import torch

CASES = ("in_view", "behind_near_clip", "frustum_clamp", "frustum_tie",
         "det_nonpositive", "faint_opacity", "zero_quaternion",
         "tile_edges")
WIDTH, HEIGHT = 320, 240


def _rot_y(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def camera(kind: str, dtype=torch.float32, device="cpu"):
    """(viewmat (4, 4), fx, fy, cx, cy) as tensors: "turned" a camera
    yawed by 0.3 rad and moved; "identity" the world frame itself, so
    that a centre's camera x over z is the centre's own."""
    vm = np.eye(4)
    if kind == "turned":
        vm[:3, :3] = _rot_y(0.3)
        vm[:3, 3] = (0.2, -0.1, 0.3)
        f = (300.0, 310.0, 160.0, 120.0)
    else:
        f = (128.0, 128.0, 0.0, 0.0)
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    return (t(vm),) + tuple(t(v) for v in f)


def inputs(case: str, n: int = 512, seed: int = 0, dtype=torch.float32,
           device="cpu"):
    """(means, scales, quats, opacities, viewmat, fx, fy, cx, cy) of one
    case, n slots (the tie and edge cases set only some of them)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)) * (2.0, 1.5, 3.0) + (0.0, 0.0, 9.0)
    scales = np.exp(rng.normal(-1.5, 0.6, size=(n, 3)))
    quats = rng.normal(size=(n, 4))
    opac = rng.uniform(0.05, 1.0, size=n)
    kind = "turned"
    if case == "behind_near_clip":
        kind = "identity"                  # view depth = the centre's z
        means[:, 2] = rng.uniform(-3.0, 0.011, size=n)
        means[: n // 8, 2] = 0.01          # on the clip: not in front
    elif case == "frustum_clamp":
        means[:, 0] = rng.choice([-1.0, 1.0], size=n) * rng.uniform(
            1.5, 6.0, size=n) * means[:, 2]
    elif case == "det_nonpositive":
        # Needles: one axis 1e6x (float32) or 1e10x (float64) the others,
        # so that (a + 0.3)(c + 0.3) - b^2 loses the blur to the rounding
        # of a' c' and lands on either side of 0.
        long = 1e3 if dtype == torch.float32 else 1e7
        scales[:, 0] = long * np.exp(rng.normal(0.0, 0.5, size=n))
        scales[:, 1:] = 1e-3
    elif case == "faint_opacity":
        opac = rng.uniform(0.0, 2.0 / 255, size=n)
        opac[:4] = (0.0, 1.0 / 255, np.nextafter(1.0 / 255, 1.0), 1e-13)
    elif case == "zero_quaternion":
        quats[: n // 2] = 0.0
        quats[n // 2: n // 2 + 8] = 1e-13
    elif case in ("frustum_tie", "tile_edges"):
        kind = "identity"
    vm, fx, fy, cx, cy = camera(kind, dtype, device)
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    means, scales, quats, opac = t(means), t(scales), t(quats), t(opac)
    if case == "frustum_tie":
        # camera x / z exactly +-1.3 tan_fovx (z = 1): minimum and maximum
        # tie, and autograd halves the gradient.
        lim_x = 1.3 * (0.5 * WIDTH / fx)
        lim_y = 1.3 * (0.5 * HEIGHT / fy)
        means[:, 2] = 1.0
        means[0::4, 0] = lim_x
        means[1::4, 0] = -lim_x
        means[2::4, 1] = lim_y
        means[3::4, 1] = -lim_y
    elif case == "tile_edges":
        # z = 1 and fx = 128: the centre is 128 x, a multiple of 16 pixels
        # at x = k / 8; radii from a few pixels to a few tiles.
        k = torch.arange(n, device=device)
        means[:, 0] = ((k % 21).to(dtype) - 1) / 8
        means[:, 1] = ((k // 21 % 16).to(dtype) - 1) / 8
        means[:, 2] = 1.0
        scales = scales * 0.3
    return means, scales, quats, opac, vm, fx, fy, cx, cy


def compared(case: str, p) -> torch.Tensor:
    """(N,) bool: the slots whose gradients a test compares, all but in
    det_nonpositive, where it compares the needles with det <= 0 (in front
    of the clip, radius 0). A needle whose determinant stays positive is
    ill-conditioned: its conic's gradient cancels terms of a' c' ~ b^2, so
    two orders of the same sums differ in every digit there."""
    if case != "det_nonpositive":
        return torch.ones_like(p.depths, dtype=torch.bool)
    return (p.radii == 0) & (p.depths > 0.01)

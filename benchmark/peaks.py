"""The card's peaks and the operation counts behind `mfu` and the
kernels' bounds (NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM, 67
TFLOP/s of float32 outside the tensor cores; the work here is scalar
float32).

Operations are counted from the work these inputs need, whatever runs it:
per active gaussian (projection, SH at the configuration's degree, the
Fourier DC, the object pose), per (pixel, pair) evaluation up to
saturation, per contributing evaluation in the backward, per pixel (the
sky lookup, the losses) and per Adam parameter. A backward costs twice
its forward where it is not counted apart.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Per (pixel, pair) evaluation: 2 subtractions, 7 for sigma, the exp, 4 for
# alpha (max, negate, multiply, clamp), 2 skip compares.
OPS_PER_EVAL = 16
# Per contributing evaluation in the backward, past the replayed 16: next_T
# and w (3), the colours' gradient and g . colour (12 at 4 channels), the
# prefix and suffix (3), 1 - alpha and dL/dalpha (6), the opacity and
# sigma gradients (3), the five geometry terms (14), one add per gradient
# row of the pixel sum (10).
OPS_PER_CONTRIB = 51
# Per gaussian: the EWA projection (view transform 18, covariance from
# quaternion and scales 60, Jacobian and J W Sigma W^T J^T 45, blur, det,
# conic, radius, centre 30): 153.
OPS_PROJECT = 153
# The composite's per-pixel colour sum (4 channels x 2) is inside the 16.
OPS_COMPOSE_OBJECT = 43          # 3x3 rotation of the mean 15 + quat mul 28
OPS_SKY_PER_PIXEL = 60           # ray 15, face and uv 20, 4 taps x 3 x 2
# L1 6 + SSIM: 5 separable 11-tap blurs x 2 passes x 2 ops x 3 channels
# + the map's 30 per pixel and channel.
OPS_LOSS_PER_PIXEL = 6 + 5 * 2 * 11 * 2 * 3 + 30 * 3
OPS_ADAM_PER_PARAM = 12          # two moments 7, the update 5


def sh_ops(degree: int) -> int:
    """Basis (31 at degree 3) plus a multiply-add per basis and channel."""
    k = (degree + 1) ** 2
    return 31 + 2 * 3 * k


def fourier_ops(dim: int) -> int:
    return 2 * dim + 6 * dim


def gaussian_ops(work: dict, cfg: dict) -> float:
    """One pass over the active gaussians: SH, Fourier DC, object pose."""
    bg = cfg.get("background_fourier", 1)
    obj = cfg.get("object_fourier", 1)
    n = work["active"]
    n_obj = work.get("active_objects", 0)
    return (n * sh_ops(cfg["sh_degree"]) + (n - n_obj) * fourier_ops(bg)
            + n_obj * (fourier_ops(obj) + OPS_COMPOSE_OBJECT))


def train_step_ops(work: dict, cfg: dict) -> float:
    """One training step with one render: forward, backward, Adam."""
    fwd = (gaussian_ops(work, cfg) + work["active"] * OPS_PROJECT
           + work["pixels"] * (OPS_SKY_PER_PIXEL + OPS_LOSS_PER_PIXEL))
    raster = (OPS_PER_EVAL * work["evals"] * 2
              + OPS_PER_CONTRIB * work["contrib"])
    return 3 * fwd + raster + OPS_ADAM_PER_PARAM * work["params"]


def render_frame_ops(work: dict, cfg: dict) -> float:
    """One eval frame: the per-gaussian work once, a projection and a
    composite per render, the sky."""
    return (gaussian_ops(work, cfg)
            + work["active"] * work["renders"] * OPS_PROJECT
            + OPS_PER_EVAL * work["evals"]
            + work["pixels"] * OPS_SKY_PER_PIXEL)


def bound_seconds(spec: dict, work: dict) -> float:
    """A kernel's least time for one unit: operations at the float32 peak
    or bytes (each read once, written once) at the HBM rate, the larger."""
    ops = sum(v * work.get(k, 0) for k, v in spec.get("ops_per", {}).items())
    nbytes = sum(v * work.get(k, 0)
                 for k, v in spec.get("bytes_per", {}).items())
    return max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)

"""4D Gaussian Splatting (4DGS; Wu, Yi, Fang, Xie, Zhang, Wei, Liu, Tian,
Wang, "4D Gaussian Splatting for Real-Time Dynamic Scene Rendering",
CVPR 2024, arXiv:2310.08528): one canonical cloud and the sky cubemap,
moved to each camera's time by a learned deformation field.

The field F = D o H maps a canonical centre X and the time t to deltas of
the centre, the log scales and the rotation:

- the inputs are normalised: x^ = 2 (X - a_min) / (a_max - a_min) - 1
  with the box [a_min, a_max] of the seed cloud, and t^ = the clip's time
  mapped onto [-1, 1] (`time_span`);
- the HexPlane encoder H samples six planes R_l(i, j) (C x N_j x N_i, one
  for each pair xy, xz, yz, xt, yt, zt) at each scale l of `scales`
  (a spatial axis has base_resolution * l cells, the time axis
  time_cells at every scale), bilinearly with K-Planes' grid_sample
  settings (align_corners, border padding), and takes the element-wise
  product of the six samples per scale: f_h = concat_l prod R_l(x^, t^),
  (len(scales) C) channels;
- the decoder D: f_d = W0 f_h + b0, one Linear (4DGS's defor_depth 1,
  the only depth the port builds), and three heads Linear -> ReLU ->
  Linear on ReLU(f_d): dX (3), ds (3, log scale) and dr (4).

X' = X + dX, s' = s + ds, r' = r + dr (the projection normalises r');
opacity and SH colours are static. Before `static_steps` the cloud renders
as it is (4DGS's static warm-up). The loss adds K-Planes' regularisers
(`regularizers`): plane TV on the spatial planes, second-difference
smoothness along time on the time planes and L1 of (1 - R) on the time
planes.

The field's trained state is two flat tensors, the planes and the
decoder, each one Adam leaf (`FIELD_GROUPS`), with views for each plane
and each layer (`plane_views`, `decoder_views`); `init_field` makes them.
The encoder and decoder run over every slot of the store, inactive ones
included. Spans: `deform4d.field` (the sampling and products),
`deform4d.decode` (decoder and heads) and `deform4d.field_bwd` (the
backward of both, on autograd's thread, held between a mark on the
deltas' gradient and one on the inputs'); the counter `deform4d.samples`
adds the plane samples of each deformation (slots x 6 x scales).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from ..core.cameras import Camera, viewmat_from_c2w
from ..core.projection import project
from ..ops.render import RenderConfig, render
from ..ops.tiles import count_pairs
from ..utils import profiling
from ..utils.profiling import span
from .fourier import fourier_dc
from .gaussians import GaussianParams, GaussianStore, activated_opacities
from .splatfacto import SplatfactoConfig, sh_colors, sky_color

SPACE_PAIRS = ((0, 1), (0, 2), (1, 2))       # xy, xz, yz
TIME_PAIRS = ((0, 3), (1, 3), (2, 3))        # xt, yt, zt
HEADS = (("means", 3), ("scales", 3), ("quats", 4))
FIELD_GROUPS = ("planes", "decoder")         # the field's trained leaves


@dataclasses.dataclass(frozen=True)
class Deform4DConfig:
    """The field's sizes (4DGS's ModelHiddenParams), its regularisers'
    weights and the static warm-up."""

    channels: int = 32              # h, a plane's feature channels
    scales: List[int] = dataclasses.field(
        default_factory=lambda: [1, 2, 4])
    base_resolution: int = 64       # spatial cells of a plane at scale 1
    time_cells: int = 43            # N_t, at every scale
    net_width: int = 64             # f_d's width (the decoder is one layer)
    static_steps: int = 3000        # the field is live from this step on
    plane_tv_weight: float = 1e-4
    time_smoothness_weight: float = 1e-2
    l1_time_planes_weight: float = 1e-4


def plane_shapes(config: Deform4DConfig) -> list:
    """Per scale, the shapes of its spatial block (3, C, R, R) and its
    time block (3, C, N_t, R), in the flat planes' order."""
    c, t = config.channels, config.time_cells
    out = []
    for l in config.scales:
        r = config.base_resolution * l
        out.append(((3, c, r, r), (3, c, t, r)))
    return out


def decoder_shapes(config: Deform4DConfig) -> list:
    """(name, shape) of the decoder's tensors, in the flat decoder's order:
    W0, b0, then each head's W1, b1, W2, b2."""
    w = config.net_width
    out = [("w0", (w, len(config.scales) * config.channels)), ("b0", (w,))]
    for name, k in HEADS:
        out += [(f"{name}.w1", (w, w)), (f"{name}.b1", (w,)),
                (f"{name}.w2", (k, w)), (f"{name}.b2", (k,))]
    return out


def _split(flat: torch.Tensor, shapes) -> list:
    out, off = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(flat[off:off + n].view(shape))
        off += n
    if off != flat.numel():
        raise ValueError(f"a flat tensor of {flat.numel()} floats, the "
                         f"shapes take {off}")
    return out


def plane_views(planes: torch.Tensor, config: Deform4DConfig) -> list:
    """[(spatial (3, C, R, R), time (3, C, N_t, R)) per scale], views of
    the flat planes."""
    views = _split(planes, [s for pair in plane_shapes(config) for s in pair])
    return list(zip(views[0::2], views[1::2]))


def decoder_views(decoder: torch.Tensor, config: Deform4DConfig) -> dict:
    """{name: view} of the flat decoder (decoder_shapes' names)."""
    shapes = decoder_shapes(config)
    return dict(zip([n for n, _ in shapes],
                    _split(decoder, [s for _, s in shapes])))


def init_field(config: Deform4DConfig, aabb: torch.Tensor,
               time_span: torch.Tensor, generator: torch.Generator,
               device="cuda") -> dict:
    """A fresh field: K-Planes' plane initialisation (spatial planes
    uniform over [0.1, 0.5], time planes ones) and 4DGS's decoder's
    (weights Xavier-uniform, biases nn.Linear's uniform over +-1 /
    sqrt(fan_in)), drawn from `generator`; `aabb` (2, 3) and `time_span`
    (2,) as given. Returns {"planes", "decoder", "aabb", "time_span"}."""
    f32 = dict(dtype=torch.float32, device=device)
    blocks = []
    for space, time in plane_shapes(config):
        blocks.append(0.1 + 0.4 * torch.rand(math.prod(space), generator=
                                             generator, **f32))
        blocks.append(torch.ones(math.prod(time), **f32))
    dec = []
    for name, shape in decoder_shapes(config):
        u = 2.0 * torch.rand(math.prod(shape), generator=generator, **f32) \
            - 1.0
        if len(shape) == 2:
            dec.append(u * math.sqrt(6.0 / (shape[0] + shape[1])))
        else:
            fan_in = config.net_width if name != "b0" else \
                len(config.scales) * config.channels
            dec.append(u / math.sqrt(fan_in))
    return {"planes": torch.cat(blocks), "decoder": torch.cat(dec),
            "aabb": torch.as_tensor(aabb, **f32).reshape(2, 3),
            "time_span": torch.as_tensor(time_span, **f32).reshape(2)}


class _Mark(torch.autograd.Function):
    """Identity on its tensors; its backward opens (`opening`) or closes
    the span `deform4d.field_bwd` held in `box`."""

    @staticmethod
    def forward(ctx, box, opening, *xs):
        ctx.box, ctx.opening = box, opening
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.opening:
            ctx.box.append(profiling.span("deform4d.field_bwd"))
            ctx.box[-1].__enter__()
        elif ctx.box:
            ctx.box.pop().__exit__(None, None, None)
        return (None, None) + grads


def _grids(xh: torch.Tensor, th: torch.Tensor):
    """The sample coordinates (width axis first) of the three spatial and
    the three time planes: two (3, 1, N, 2) grids."""
    t = th.expand(xh.shape[0])
    space = torch.stack([torch.stack((xh[:, i], xh[:, j]), -1)
                         for i, j in SPACE_PAIRS])
    time = torch.stack([torch.stack((xh[:, i], t), -1) for i, _ in TIME_PAIRS])
    return space[:, None], time[:, None]


def encode(planes: torch.Tensor, xh: torch.Tensor, th: torch.Tensor,
           config: Deform4DConfig) -> torch.Tensor:
    """H: the six planes of every scale sampled at (x^ (N, 3), t^ (0-d)),
    multiplied per scale in the order xy, xz, yz, xt, yt, zt, the scales
    concatenated: (len(scales) C, N)."""
    gs, gt = _grids(xh, th)
    feats = []
    for space, time in plane_views(planes, config):
        s = F.grid_sample(space, gs, mode="bilinear", padding_mode="border",
                          align_corners=True)
        t = F.grid_sample(time, gt, mode="bilinear", padding_mode="border",
                          align_corners=True)
        feats.append((s[0] * s[1] * s[2] * t[0] * t[1] * t[2])[:, 0])
    return torch.cat(feats, 0)


def decode(decoder: torch.Tensor, f: torch.Tensor,
           config: Deform4DConfig) -> list:
    """D on the encoder's (channels, N) features: [dX (N, 3), ds (N, 3),
    dr (N, 4)]."""
    v = decoder_views(decoder, config)
    h = F.relu(F.linear(f.t(), v["w0"], v["b0"]))
    return [F.linear(F.relu(F.linear(h, v[f"{n}.w1"], v[f"{n}.b1"])),
                     v[f"{n}.w2"], v[f"{n}.b2"]) for n, _ in HEADS]


def normalise(means: torch.Tensor, t, field: dict):
    """(x^ (N, 3), t^ (1,)): the centres in the field's box and the time in
    its span, each mapped onto [-1, 1]."""
    lo, hi = field["aabb"][0], field["aabb"][1]
    xh = 2.0 * (means - lo) / (hi - lo) - 1.0
    t0, t1 = field["time_span"][0], field["time_span"][1]
    t = torch.as_tensor(t, dtype=means.dtype, device=means.device)
    return xh, (2.0 * (t - t0) / (t1 - t0) - 1.0).reshape(1)


def deform(params: GaussianParams, field: dict, t,
           config: Deform4DConfig):
    """(X', log s', r') of every slot at time t (a 0-d tensor or a host
    number): the canonical leaves plus the field's deltas."""
    box = [] if profiling.recording() else None
    means, planes, decoder = params.means, field["planes"], field["decoder"]
    if box is not None:
        means, planes, decoder = _Mark.apply(box, False, means, planes,
                                             decoder)
    xh, th = normalise(means, t, field)
    with span("deform4d.field"):
        f = encode(planes, xh, th, config)
    profiling.count("deform4d.samples",
                    params.means.shape[0] * 6 * len(config.scales))
    with span("deform4d.decode"):
        d = decode(decoder, f, config)
    if box is not None:
        d = _Mark.apply(box, True, *d)
    return (params.means + d[0], params.scales + d[1], params.quats + d[2])


def live(config: Deform4DConfig, step: int) -> bool:
    """Whether the field deforms the cloud at `step` (past the warm-up)."""
    return step >= config.static_steps


def _deformed(params, field, camera, step, config):
    if field is not None and live(config, step):
        return deform(params, field, camera.time, config)
    return params.means, params.scales, params.quats


def plane_tv(p: torch.Tensor) -> torch.Tensor:
    """K-Planes' total variation of one (C, H, W) plane."""
    c, h, w = p.shape
    tv_h = torch.square(p[:, 1:, :] - p[:, :-1, :]).sum()
    tv_w = torch.square(p[:, :, 1:] - p[:, :, :-1]).sum()
    return 2.0 * (tv_h / (c * (h - 1) * w) + tv_w / (c * h * (w - 1)))


def time_smoothness(p: torch.Tensor) -> torch.Tensor:
    """K-Planes' smoothness of one (C, N_t, W) time plane: the mean square
    of its second difference along time."""
    d1 = p[:, 1:, :] - p[:, :-1, :]
    return torch.square(d1[:, 1:, :] - d1[:, :-1, :]).mean()


def regularizers(planes: torch.Tensor, config: Deform4DConfig) -> dict:
    """The weighted plane regularisers, summed over planes and scales:
    {"plane_tv", "time_smoothness", "l1_time_planes"}."""
    tv = smooth = l1 = 0.0
    for space, time in plane_views(planes, config):
        for p in space:
            tv = tv + plane_tv(p)
        for p in time:
            smooth = smooth + time_smoothness(p)
            l1 = l1 + torch.abs(1.0 - p).mean()
    return {"plane_tv": config.plane_tv_weight * tv,
            "time_smoothness": config.time_smoothness_weight * smooth,
            "l1_time_planes": config.l1_time_planes_weight * l1}


def forward(params: GaussianParams, active: torch.Tensor,
            field: Optional[dict], camera: Camera, step: int,
            config: SplatfactoConfig, deform4d: Deform4DConfig,
            render_config: RenderConfig,
            env_map: Optional[torch.Tensor] = None,
            jitter: Optional[torch.Tensor] = None, training: bool = True,
            xys_offset: Optional[torch.Tensor] = None):
    """One-camera render of the cloud deformed to the camera's time: as
    models.splatfacto.forward, with X', s' and r' in place of X, s and r
    once the field is live. Returns (outputs dict, RenderOutputs)."""
    means, log_scales, quats = _deformed(params, field, camera, step,
                                         deform4d)
    opac = activated_opacities(params, active)
    dc = fourier_dc(params.features_dc,
                    torch.zeros((), device=params.means.device))
    rgbs = sh_colors(means, dc, params.features_rest, camera, step, config,
                     training)
    sky = None
    if env_map is not None:
        sky = sky_color(env_map, camera, jitter if training else None)
    out = render(means, torch.exp(log_scales), quats, opac, rgbs, camera,
                 render_config, sky_rgb=sky, training=training,
                 active=active, xys_offset=xys_offset)
    outputs = {"rgb": out.rgb, "accumulation": out.accumulation,
               "depth": out.depth}
    if sky is not None:
        outputs["sky"] = sky
    return outputs, out


@torch.no_grad()
def pair_counts(store: GaussianStore, field: Optional[dict], camera: Camera,
                step: int, deform4d: Deform4DConfig, tile_size: int = 16):
    """Exact, capacity-free (num_pairs, num_rowruns) of one view of the
    cloud deformed to the camera's time (the trainer's pair presize)."""
    means, log_scales, quats = _deformed(store.params, field, camera, step,
                                         deform4d)
    opac = activated_opacities(store.params, store.active)
    proj = project(means, torch.exp(log_scales), quats,
                   viewmat_from_c2w(camera.c2w), camera.fx, camera.fy,
                   camera.cx, camera.cy, camera.width, camera.height,
                   tile_size=tile_size, opacities=opac, active=store.active)
    return count_pairs(proj, camera.width, camera.height, tile_size,
                       opacities=opac)

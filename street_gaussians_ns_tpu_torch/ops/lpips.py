"""LPIPS (VGG16 variant), an eval-only metric (counterpart of
street_gaussians_ns_tpu/ops/lpips.py).

The standard LPIPS(VGG) pipeline: inputs scaled to [-1, 1] and normalized
by the ImageNet shift/scale, VGG16's conv features, each tapped layer
unit-normalized over channels, weighted by the learned 1x1 linear heads,
averaged over space and summed over the layers.

`load_lpips(path)` reads the JAX package's .npz layout: VGG16 conv kernels
`features.{idx}.weight/bias` (OIHW) and the heads `lin{0..4}.model.1.weight`.
Nothing is downloaded. `random_lpips(seed)` draws a VGG16 from
np.random.RandomState(seed) exactly as the JAX package does, so both
packages compute the same metric. The convolutions are
torch.nn.functional.conv2d in float32 (TF32 off on the card) and the
pooling max_pool2d; neither is a kernel of the JAX package.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# VGG16 conv layer indices in torchvision's features module and the block
# boundaries LPIPS taps (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3).
_VGG_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
_TAP_AFTER = {3, 8, 15, 22, 29}   # feature-module index whose relu is a tap
_MAXPOOL_BEFORE = {5, 10, 17, 24}
# VGG16 conv output channels, aligned with _VGG_CONV_IDX.
_VGG_CHANNELS = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512,
                 512, 512, 512]


def load_lpips(path: Path, device="cuda"):
    """Returns lpips(img1, img2) -> 0-d tensor; images (H, W, 3) in
    [0, 1] on `device`."""
    with np.load(path) as data:
        convs = [(data[f"features.{idx}.weight"], data[f"features.{idx}.bias"],
                  idx) for idx in _VGG_CONV_IDX]
        lins = [data[f"lin{i}.model.1.weight"] for i in range(5)]
    return _build_lpips(convs, lins, device)


def random_lpips(seed: int = 0, device="cuda"):
    """LPIPS over a seeded random-weight VGG16 with uniform linear heads,
    the JAX package's draws (He-normal conv kernels from
    RandomState(seed), zero biases, heads 1/C). Deterministic given the
    seed; not comparable to pretrained LPIPS (eval writes `lpips_net`)."""
    rng = np.random.RandomState(seed)
    convs = []
    in_ch = 3
    for idx, out_ch in zip(_VGG_CONV_IDX, _VGG_CHANNELS):
        fan_in = in_ch * 9
        w = rng.normal(0.0, np.sqrt(2.0 / fan_in),
                       (out_ch, in_ch, 3, 3)).astype(np.float32)
        convs.append((w, np.zeros((out_ch,), np.float32), idx))
        in_ch = out_ch
    lins = [np.full((1, c, 1, 1), 1.0 / c, np.float32)
            for c in (64, 128, 256, 512, 512)]
    return _build_lpips(convs, lins, device)


def _build_lpips(convs, lins, device):
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    convs = [(t(w), t(b), idx) for w, b, idx in convs]
    lins = [t(w).reshape(1, -1, 1, 1) for w in lins]
    shift = t(_SHIFT).reshape(1, 3, 1, 1)
    scale = t(_SCALE).reshape(1, 3, 1, 1)

    def features(x):
        """x: (1, 3, H, W) normalized -> the 5 tapped feature maps."""
        taps = []
        for w, b, idx in convs:
            if idx in _MAXPOOL_BEFORE:
                x = F.max_pool2d(x, 2, 2)
            x = F.relu(F.conv2d(x, w, b, padding=1))
            if idx + 1 in _TAP_AFTER:
                taps.append(x)
        return taps

    def prep(im):
        x = im.to(torch.float32).permute(2, 0, 1)[None] * 2.0 - 1.0
        return (x - shift) / scale

    @torch.no_grad()
    def lpips(img1, img2):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            t1, t2 = features(prep(img1)), features(prep(img2))
        total = torch.zeros((), dtype=torch.float32, device=img1.device)
        for f1, f2, w in zip(t1, t2, lins):
            n1 = f1 / torch.sqrt(torch.sum(f1 ** 2, 1, keepdim=True) + 1e-10)
            n2 = f2 / torch.sqrt(torch.sum(f2 ** 2, 1, keepdim=True) + 1e-10)
            total = total + torch.mean(torch.sum((n1 - n2) ** 2 * w, dim=1))
        return total

    return lpips

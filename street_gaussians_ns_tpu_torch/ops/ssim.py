"""SSIM and PSNR (counterpart of street_gaussians_ns_tpu/ops/ssim.py:
`ssim`, `ssim_band_mean`, `psnr`).

pytorch_msssim's SSIM(data_range=1, channel=3) defaults: 11x11 gaussian
window, sigma 1.5, K1 = 0.01, K2 = 0.03, valid padding, the mean over
pixels and channels. The separable blur is a sum of 11 weighted slices
per axis, the JAX package's formulation, so the two agree to float32
summation order; it is plain tensor code, no library convolution (cuDNN
would run a float32 convolution in TF32 by default).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

K1 = 0.01
K2 = 0.03


@functools.lru_cache(maxsize=8)
def _gaussian_window_np(win_size: int, sigma: float) -> np.ndarray:
    coords = np.arange(win_size, dtype=np.float32) - (win_size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _blur(x: torch.Tensor, win) -> torch.Tensor:
    """Separable gaussian blur of (C, H, W), valid padding."""
    k = len(win)
    h, w = x.shape[1], x.shape[2]
    out = None
    for i in range(k):
        term = float(win[i]) * x[:, i:i + h - k + 1, :]
        out = term if out is None else out + term
    x = out
    out = None
    for i in range(k):
        term = float(win[i]) * x[:, :, i:i + w - k + 1]
        out = term if out is None else out + term
    return out


def _ssim_map(x, y, data_range, win_size, sigma):
    """(C, h-K+1, w-K+1) SSIM map of two (C, h, w) images."""
    win = _gaussian_window_np(win_size, sigma)
    c1 = (K1 * data_range) ** 2
    c2 = (K2 * data_range) ** 2
    mu1 = _blur(x, win)
    mu2 = _blur(y, win)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _blur(x * x, win) - mu1_sq
    sigma2_sq = _blur(y * y, win) - mu2_sq
    sigma12 = _blur(x * y, win) - mu1_mu2
    cs = (2.0 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    return ((2.0 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
         win_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over pixels and channels of two (H, W, C) images in
    [0, data_range] (0-d tensor). Differentiable."""
    x = img1.permute(2, 0, 1).to(torch.float32)
    y = img2.permute(2, 0, 1).to(torch.float32)
    return torch.mean(_ssim_map(x, y, data_range, win_size, sigma))


def ssim_band_mean(img1: torch.Tensor, img2: torch.Tensor, row0: int,
                   rows: int, data_range: float = 1.0, win_size: int = 11,
                   sigma: float = 1.5) -> torch.Tensor:
    """The band of SSIM-map rows [row0, row0 + rows) of two (H, W, C)
    images: sum(band of the map) / (size of the full map). Map row r reads
    image rows [r, r + win_size) only, so a device computes its band from
    the image band plus a win_size - 1 halo, every map value as the full
    map has it, and the bands' results summed over a model group are the
    full-frame mean SSIM. Rows past the map (the last band's padding)
    count zero."""
    h, w, c = img1.shape
    map_h = h - win_size + 1

    def band(img):
        p = torch.nn.functional.pad(img.to(torch.float32),
                                    (0, 0, 0, 0, 0, rows))
        return p[row0:row0 + rows + win_size - 1].permute(2, 0, 1)

    m = _ssim_map(band(img1), band(img2), data_range, win_size, sigma)
    valid = (torch.arange(rows, device=m.device) + row0 < map_h)[
        None, :, None]
    total = torch.sum(torch.where(valid, m, torch.zeros_like(m)))
    return total / (map_h * (w - win_size + 1) * c)


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio (data_range 1)."""
    mse = torch.mean((img1.to(torch.float32) - img2.to(torch.float32)) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))

"""bf16 pairs in one int32 (counterpart of
street_gaussians_ns_tpu/ops/packing.py: `pack2`, `unpack2`).

The JAX package rides two bf16-rounded feature columns in one int32 sort
payload to halve the operand count of a TPU sort. The port sorts a key
and gathers its payloads, so it keeps the rounding (`round_bf16`, what a
value comes out of a pack / unpack as) and needs the packing itself only
to hold the bits against the JAX package's.

Rounding is round-to-nearest-even, as XLA's convert. A NaN becomes the
quiet NaN 0x7FC0 with the input's sign, as XLA's convert gives it (torch's
own conversion drops the sign and, on the CPU, the quiet bit pattern).
"""
from __future__ import annotations

import torch


def _bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its bf16 bits as int64 in [0, 2^16)."""
    x = x.to(torch.float32)
    bits = x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    sign = (x.view(torch.int32).to(torch.int64) >> 31) & 1
    return torch.where(torch.isnan(x), 0x7FC0 | (sign << 15), bits)


def _from_bits(half: torch.Tensor) -> torch.Tensor:
    """bf16 bits (int64 in [0, 2^16)) -> float32, exactly."""
    word = half << 16
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(
        torch.int32).view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bf16 and back, bit for bit the JAX package's
    `x.astype(bfloat16).astype(float32)`."""
    return _from_bits(_bf16_bits(x))


def pack2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two float32 tensors -> one int32 tensor of bf16 halves, `a` in the
    high 16 bits."""
    word = (_bf16_bits(a) << 16) | _bf16_bits(b)
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def unpack2(p: torch.Tensor):
    """Inverse of pack2: int32 -> (a, b) as float32 (bf16-rounded)."""
    u = p.to(torch.int64) & 0xFFFFFFFF
    return _from_bits(u >> 16), _from_bits(u & 0xFFFF)

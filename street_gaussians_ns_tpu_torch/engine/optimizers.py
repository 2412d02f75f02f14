"""Per-group Adam + exponential-decay schedules (counterpart of
street_gaussians_ns_tpu/engine/optimizers.py: `AdamConfig`, `schedule`,
`AdamState`, `init_adam`, `adam_update`, `mask_moments`,
`DEFAULT_GROUPS`).

Adam is written out on tensors, not torch.optim.Adam, because
densification performs state surgery: culled slots and freshly scattered
children get zeroed first and second moments (`mask_moments`), which with
moments held as plain (CAP, ...) tensors is one masked select. Semantics
are torch.optim.Adam's: bias-corrected moments, eps added outside the
square root, one step count per group.

Parameters and moments are single tensors or (nested) dicts of tensors.
`adam_update` is functional: it returns new tensors and leaves its
arguments untouched. The step count and the learning rate are host
numbers (computed in float32, as the JAX package computes them).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float
    eps: float = 1e-15
    b1: float = 0.9
    b2: float = 0.999
    # Exponential decay to lr_final over max_steps; None = constant lr.
    lr_final: Optional[float] = None
    max_steps: int = 70000
    # Per-group gradient accumulation: gradients sum across accum_steps
    # calls and the Adam step applies on every accum_steps-th call.
    accum_steps: int = 1


def schedule(config: AdamConfig, step: int) -> float:
    """lr(step) = lr * (lr_final / lr)^(step / max_steps), clamped at
    lr_final; evaluated in float32."""
    if config.lr_final is None:
        return float(np.float32(config.lr))
    t = np.clip(np.float32(step) / np.float32(config.max_steps),
                np.float32(0.0), np.float32(1.0))
    ratio = np.float32(config.lr_final / config.lr)
    return float(np.float32(config.lr) * np.power(ratio, t,
                                                  dtype=np.float32))


def tree_map(fn, *trees):
    """Apply fn leaf by leaf over (nested) dicts of tensors with the same
    keys; a bare tensor is a tree of one leaf."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


@dataclasses.dataclass(frozen=True)
class AdamState:
    mu: Any            # tree matching params
    nu: Any            # tree matching params
    count: int         # Adam steps taken
    # Gradient-accumulation buffer and calls since the last step; None
    # unless the group's accum_steps > 1.
    acc: Any = None
    calls: Optional[int] = None


def init_adam(params, accum_steps: int = 1) -> AdamState:
    return AdamState(
        mu=tree_map(torch.zeros_like, params),
        nu=tree_map(torch.zeros_like, params), count=0,
        acc=tree_map(torch.zeros_like, params) if accum_steps > 1 else None,
        calls=0 if accum_steps > 1 else None)


def adam_update(grads, state: AdamState, params, lr: float,
                config: AdamConfig):
    """One Adam step. Returns (new_params, new_state).

    With config.accum_steps > 1 the gradients accumulate (sum) across
    calls and the parameters and moments move only on every
    accum_steps-th call, with the accumulated gradient."""
    if config.accum_steps > 1:
        acc = tree_map(torch.add, state.acc, grads)
        calls = state.calls + 1
        if calls % config.accum_steps != 0:
            return params, dataclasses.replace(state, acc=acc, calls=calls)
        new_p, stepped = adam_update(
            acc, dataclasses.replace(state, acc=None, calls=None), params,
            lr, dataclasses.replace(config, accum_steps=1))
        return new_p, dataclasses.replace(
            stepped, acc=tree_map(torch.zeros_like, acc), calls=calls)
    count = state.count + 1
    b1, b2 = config.b1, config.b2
    one = np.float32(1.0)
    c1 = float(one - np.power(np.float32(b1), np.float32(count)))
    c2 = float(one - np.power(np.float32(b2), np.float32(count)))

    def moment1(g, m):
        return b1 * m + (1.0 - b1) * g

    def moment2(g, v):
        return b2 * v + (1.0 - b2) * (g * g)

    def step(p, m, v):
        return p - lr * (m / c1) / (torch.sqrt(v / c2) + config.eps)

    with torch.no_grad():
        mu = tree_map(moment1, grads, state.mu)
        nu = tree_map(moment2, grads, state.nu)
        new_p = tree_map(step, params, mu, nu)
    return new_p, AdamState(mu=mu, nu=nu, count=count)


def mask_moments(state: AdamState, keep: torch.Tensor) -> AdamState:
    """Zero the first and second moments where ~keep (keep's axes lead
    every leaf's): what removing a gaussian from, or adding one to, the
    optimizer amounts to in a fixed-capacity store."""
    def m(x):
        k = keep.reshape(keep.shape + (1,) * (x.dim() - keep.dim()))
        return torch.where(k, x, torch.zeros_like(x))
    return AdamState(mu=tree_map(m, state.mu), nu=tree_map(m, state.nu),
                     count=state.count)


# The reference's optimizer registry: 9 groups.
DEFAULT_GROUPS: Dict[str, AdamConfig] = {
    "sky_sphere": AdamConfig(lr=5e-3),
    "camera_opt": AdamConfig(lr=1e-3, lr_final=5e-5, max_steps=70000,
                             accum_steps=100),
    "bbox_opt": AdamConfig(lr=1e-3, lr_final=5e-5, max_steps=70000),
    "means": AdamConfig(lr=1.6e-4, lr_final=1.6e-6, max_steps=70000),
    "features_dc": AdamConfig(lr=2.5e-3),
    "features_rest": AdamConfig(lr=2.5e-3 / 20),
    "opacities": AdamConfig(lr=5e-2),
    "scales": AdamConfig(lr=5e-3),
    "quats": AdamConfig(lr=1e-3),
}

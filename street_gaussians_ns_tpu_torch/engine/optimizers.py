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

`adam_step` steps every group of a train step at once: on CUDA tensors
one launch of kernel K (`ops/adam.py`, `csrc/adam.cu`) over every leaf of
every group, each leaf's inactive rows (a group's `active` masks) read as
zero gradients inside it; on CPU tensors the plain version, `_adam_plain`
after `mask_rows`, which K equals bit for bit on the card. `adam_update`
is its one-group form.

Parameters and moments are single tensors or (nested) dicts of tensors.
Both are functional: they return new tensors and leave their arguments
untouched. The step count and the learning rate are host numbers
(computed in float32, as the JAX package computes them).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.adam import adam_leaves
from ..utils import profiling


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


@dataclasses.dataclass(frozen=True)
class AdamGroup:
    """One group of an `adam_step`: its gradients, state and parameters
    (trees of one structure), learning rate and config. `active`, where
    given, is a tree of the same structure of bool row masks, each leading
    its leaf's axes (a leaf of None: no mask): the gradient of an inactive
    row reads +0.0, whatever it holds."""
    grads: Any
    state: AdamState
    params: Any
    lr: float
    config: AdamConfig
    active: Any = None


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def _rebuild(tree, it):
    """`tree`'s structure with its leaves taken from the iterator `it`."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in tree}
    return next(it)


def _bias_corrections(config: AdamConfig, count: int):
    """1 - b1^count and 1 - b2^count in float32, as Python floats."""
    one = np.float32(1.0)
    return (float(one - np.power(np.float32(config.b1), np.float32(count))),
            float(one - np.power(np.float32(config.b2), np.float32(count))))


def mask_rows(g: torch.Tensor, active: Optional[torch.Tensor]):
    """g with the rows where ~active (active's axes lead g's) set to +0.0;
    g itself when active is None."""
    if active is None:
        return g
    a = active.reshape(active.shape + (1,) * (g.dim() - active.dim()))
    return torch.where(a, g, torch.zeros_like(g))


def _adam_plain(grads, state: AdamState, params, lr: float,
                config: AdamConfig):
    """One Adam step of one group on tensors (kernel K's specification):
    returns (new_params, AdamState(mu, nu, count + 1))."""
    count = state.count + 1
    b1, b2 = config.b1, config.b2
    c1, c2 = _bias_corrections(config, count)

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


def _hyper(group: AdamGroup, count: int) -> tuple:
    """Kernel K's eight float32 numbers of a group: lr, b1, 1 - b1, b2,
    1 - b2, eps, 1 / c1, 1 / c2 (the reciprocals formed in float32, as
    PyTorch's CUDA division by a host scalar forms them)."""
    cfg = group.config
    c1, c2 = _bias_corrections(cfg, count)
    f = np.float32
    return (f(group.lr), f(cfg.b1), f(1.0 - cfg.b1), f(cfg.b2),
            f(1.0 - cfg.b2), f(cfg.eps), f(1.0) / f(c1), f(1.0) / f(c2))


def _step_plain(stepping) -> list:
    """`_adam_plain` after `mask_rows`, group by group."""
    out = []
    for group, grads in stepping:
        if group.active is not None:
            grads = tree_map(mask_rows, grads, group.active)
        out.append(_adam_plain(grads, group.state, group.params, group.lr,
                               group.config))
    return out


def _step_kernel(stepping) -> list:
    """One launch of kernel K over every leaf of every group."""
    table, sizes = [], []
    for group, grads in stepping:
        ps = _leaves(group.params)
        acts = (_leaves(group.active) if group.active is not None
                else [None] * len(ps))
        hyper = _hyper(group, group.state.count + 1)
        # Autograd may hand a strided gradient (the CPU's features_rest
        # gets one); K takes contiguous leaves.
        table += [(p, g if g.is_contiguous() else g.contiguous(), m, v, a,
                   hyper) for p, g, m, v, a in
                  zip(ps, _leaves(grads), _leaves(group.state.mu),
                      _leaves(group.state.nu), acts)]
        sizes.append(len(ps))
    new = iter(adam_leaves(table))
    out = []
    for (group, _), n in zip(stepping, sizes):
        rows = [next(new) for _ in range(n)]
        mu, nu = (_rebuild(group.params, (r[k] for r in rows))
                  for k in (1, 2))
        out.append((_rebuild(group.params, (r[0] for r in rows)),
                    AdamState(mu=mu, nu=nu, count=group.state.count + 1)))
    return out


def adam_step(groups: Dict[str, AdamGroup]
              ) -> Dict[str, Tuple[Any, AdamState]]:
    """One Adam step of every group: {name: (new_params, new_state)}.

    A group with config.accum_steps > 1 sums its gradients across calls
    and steps only on every accum_steps-th call, with the sum. The groups
    that step go through one pass: on CUDA tensors one launch of kernel K
    over all their leaves (at most ops.adam.MAX_LEAVES; K checks that every
    tensor lies on one card), on CPU tensors `_adam_plain` per group after
    `mask_rows`. The counter `step.adam_leaves` adds the leaves stepped."""
    out, stepping = {}, {}
    with torch.no_grad():
        for name, group in groups.items():
            grads, state, cfg = group.grads, group.state, group.config
            if cfg.accum_steps > 1:
                acc = tree_map(torch.add, state.acc, grads)
                calls = state.calls + 1
                if calls % cfg.accum_steps != 0:
                    out[name] = (group.params, dataclasses.replace(
                        state, acc=acc, calls=calls))
                    continue
                grads = acc
            stepping[name] = (group, grads)
        if stepping:
            todo = list(stepping.values())
            first = _leaves(todo[0][0].params)[0]
            run = _step_plain if first.device.type == "cpu" else _step_kernel
            n_leaves = 0
            for (name, (group, grads)), (new_p, new_s) in zip(
                    stepping.items(), run(todo)):
                if group.config.accum_steps > 1:
                    new_s = dataclasses.replace(
                        new_s, acc=tree_map(torch.zeros_like, grads),
                        calls=group.state.calls + 1)
                out[name] = (new_p, new_s)
                n_leaves += len(_leaves(group.params))
            profiling.count("step.adam_leaves", n_leaves)
    return {name: out[name] for name in groups}


def adam_update(grads, state: AdamState, params, lr: float,
                config: AdamConfig):
    """One Adam step of one group (`adam_step`'s one-group form). Returns
    (new_params, new_state).

    With config.accum_steps > 1 the gradients accumulate (sum) across
    calls and the parameters and moments move only on every
    accum_steps-th call, with the accumulated gradient."""
    return adam_step({"": AdamGroup(grads, state, params, lr, config)})[""]


def mask_moments(state: AdamState, keep: torch.Tensor) -> AdamState:
    """Zero the first and second moments where ~keep (keep's axes lead
    every leaf's): what removing a gaussian from, or adding one to, the
    optimizer amounts to in a fixed-capacity store."""
    def m(x):
        return mask_rows(x, keep)
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

# The three temporal groups of PVG (models.pvg). PVG's official learning
# rates are not in the repository; these are assumed: the life peak
# (seconds) decays by 100x as the means' rate does, the log lifespan and
# the velocity (m/s) are constant.
PVG_GROUPS: Dict[str, AdamConfig] = {
    "tau": AdamConfig(lr=8e-4, lr_final=8e-6, max_steps=70000),
    "s_beta": AdamConfig(lr=2e-3),
    "velocity": AdamConfig(lr=1e-3),
}

# The two groups of the 4D Gaussian Splatting field (models.deform4d), one
# flat Adam leaf each: 4DGS's grid and deformation learning rates (arXiv:
# 2310.08528 sec. 4.1), each decaying tenfold over the port's 30,000
# steps.
DEFORM4D_GROUPS: Dict[str, AdamConfig] = {
    "field_planes": AdamConfig(lr=1.6e-3, lr_final=1.6e-4, max_steps=30000),
    "field_decoder": AdamConfig(lr=1.6e-4, lr_final=1.6e-5, max_steps=30000),
}

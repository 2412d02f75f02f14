"""What the drivers share: the readings the set-up keeps for the check,
and the store's leaves the check compares."""
from __future__ import annotations

import dataclasses

import torch

from .. import scene

LEAF_PARTS = ("bg", "obj")
ADAM_B1 = 0.9                  # engine/optimizers' b1, every group


def first_grad_norms(first_moments: dict) -> dict:
    """Each leaf's first gradient as Adam got it, from its first moment
    after one step (the moments start at zero: m1 = (1 - b1) g)."""
    return {k: torch.linalg.vector_norm(m / (1 - ADAM_B1))
            for k, m in first_moments.items()}


def flat_leaves(store: dict) -> list:
    """The trained leaves of a flat store dict, in a fixed order."""
    out = [f"{p}/{g}" for p in LEAF_PARTS for g in scene.PARAMS
           if f"{p}/{g}" in store]
    return out + (["env_map"] if store.get("env_map") is not None else [])


@dataclasses.dataclass
class Snapshot:
    """The program's readings over the steps the reference follows: each
    step's loss, the first gradient's norm per leaf (from Adam's first
    moment after one step, the moments starting at zero) and the norm of
    each leaf's change after the last of them."""

    losses: list = dataclasses.field(default_factory=list)
    first_grad: dict = dataclasses.field(default_factory=dict)
    change: dict = dataclasses.field(default_factory=dict)

    def to_host(self) -> "Snapshot":
        def f(x):
            return float(x.item() if isinstance(x, torch.Tensor) else x)
        return Snapshot(losses=[f(x) for x in self.losses],
                        first_grad={k: f(v) for k, v in self.first_grad.items()},
                        change={k: f(v) for k, v in self.change.items()})

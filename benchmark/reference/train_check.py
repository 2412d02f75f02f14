"""The reference's first training steps and the comparison with the
program's readings (drivers.common.Snapshot).

Numbers compared, each by the worst case:
  loss_gap    max over the steps of |loss - reference| / |reference|;
  grad_gap    over the leaves, | |g1| - |g1_ref| | / max(|g1_ref|, median
              leaf's |g1_ref|), g1 the first step's gradient as Adam got it;
  change_gap  the same for the norm of each leaf's change after the steps.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out (a rule on the
reference's gradient, not on names).
"""
from __future__ import annotations

import numpy as np
import torch

from . import gs

NEGLIGIBLE = 1e-3


def _group(leaf: str) -> str:
    return leaf.split("/")[-1]


def reference_steps(sc: dict, tracks, steps: list, degree: int) -> dict:
    """steps: [(step number, camera, target (H, W, 3), semantic (H, W, 1),
    jitter (2, H, W))]. `sc` holds the store's leaves (scene.make_scene);
    tracks None is the single-model pipeline. Returns {"losses",
    "first_grad", "change"} as host floats."""
    gs.no_tf32()
    names = [k for k in sc if k.split("/")[-1] in (
        "means", "scales", "quats", "features_dc", "features_rest",
        "opacities")] + ["env_map"]
    fixed = {k: sc[k] for k in sc if k not in names}
    p = {k: sc[k].detach().clone() for k in names}
    p0 = {k: v.clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], {}
    for i, (step, cam, img, sem, jitter) in enumerate(steps):
        leaves = {k: p[k].requires_grad_(True) for k in names}
        out = gs.forward({**leaves, **fixed}, tracks, cam, degree,
                         training=True, jitter=jitter)
        loss = gs.loss(out, img, sem)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in zip(names, grads):
                if k != "env_map":
                    act = fixed[k.split("/")[0] + "/active"]
                    a = act.reshape(act.shape + (1,) * (g.dim() - act.dim()))
                    g = torch.where(a, g, torch.zeros_like(g))
                if i == 0:
                    first[k] = float(torch.linalg.vector_norm(g))
                p[k], m[k], v2[k] = gs.adam(p[k].detach(), g, m[k], v2[k],
                                            i + 1, gs.lr_at(_group(k), step))
        del out, loss, grads, leaves
    change = {k: float(torch.linalg.vector_norm(p[k] - p0[k])) for k in names}
    return {"losses": losses, "first_grad": first, "change": change}


def compare(snap, ref: dict) -> dict:
    """The numbers compared, and the leaves that set them."""
    lg = max(abs(a - b) / max(abs(b), 1e-30)
             for a, b in zip(snap.losses, ref["losses"]))
    med = float(np.median(list(ref["first_grad"].values())))
    kept = [k for k, g in ref["first_grad"].items() if g >= NEGLIGIBLE * med]

    def worst(prog: dict, refd: dict):
        base = float(np.median([refd[k] for k in kept]))
        gaps = {k: abs(prog[k] - refd[k]) / max(refd[k], base) for k in kept}
        k = max(gaps, key=gaps.get)
        return gaps[k], k
    gg, gk = worst(snap.first_grad, ref["first_grad"])
    cg, ck = worst(snap.change, ref["change"])
    return {"numbers": {"loss_gap": lg, "grad_gap": gg, "change_gap": cg},
            "detail": {"grad_leaf": gk, "change_leaf": ck,
                       "left_out": sorted(set(ref["first_grad"]) - set(kept)),
                       "losses": snap.losses, "ref_losses": ref["losses"]}}

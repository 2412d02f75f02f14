"""The reference's first training steps when each step trains on several
images at once, as a data-parallel step over a mesh's data rows does: the
step's loss is the mean of its images' losses and its gradient the mean
of theirs. Each image is rendered, and its loss differentiated, in turn,
so the reference holds one image's autograd state at a time. Otherwise
this is train_check.reference_steps (the same leaves, the inactive rows'
gradients zeroed, the learning rates and Adam of `gs`), and its readings
are compared by train_check.compare.
"""
from __future__ import annotations

import torch

from . import gs, train_check


def reference_steps(sc: dict, tracks, steps: list, degree: int) -> dict:
    """steps: [(step number, [(camera, target (H, W, 3), semantic
    (H, W, 1), jitter (2, H, W)), one a data row])]. `sc` holds the
    store's leaves (scene.make_scene). Returns {"losses", "first_grad",
    "change"} as host floats, each loss the mean over the step's rows."""
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
    for i, (step, rows) in enumerate(steps):
        total = {k: torch.zeros_like(v) for k, v in p.items()}
        loss_sum = 0.0
        for cam, img, sem, jitter in rows:
            leaves = {k: p[k].detach().requires_grad_(True) for k in names}
            out = gs.forward({**leaves, **fixed}, tracks, cam, degree,
                             training=True, jitter=jitter)
            loss = gs.loss(out, img, sem)
            grads = torch.autograd.grad(loss / len(rows),
                                        [leaves[k] for k in names])
            loss_sum = loss_sum + loss.detach()
            with torch.no_grad():
                for k, g in zip(names, grads):
                    total[k] += g
            del out, loss, grads, leaves
        losses.append(float(loss_sum / len(rows)))
        with torch.no_grad():
            for k in names:
                g = total[k]
                if k != "env_map":
                    act = fixed[k.split("/")[0] + "/active"]
                    a = act.reshape(act.shape + (1,) * (g.dim() - act.dim()))
                    g = torch.where(a, g, torch.zeros_like(g))
                if i == 0:
                    first[k] = float(torch.linalg.vector_norm(g))
                p[k], m[k], v2[k] = gs.adam(p[k], g, m[k], v2[k], i + 1,
                                            gs.lr_at(k.split("/")[-1], step))
        del total
    change = {k: float(torch.linalg.vector_norm(p[k] - p0[k])) for k in names}
    return {"losses": losses, "first_grad": first, "change": change}


compare = train_check.compare

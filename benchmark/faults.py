"""Faults planted under the timed path, for the check's own tests and for
reading each fault's numbers on the card (run.py --fault <name>); no run
of the benchmark plants one by itself.

  unchanged   a training step returns the state it was given (its step
              counter advanced);
  half_batch  the loss takes the mean over the top half of the image's
              rows and leaves the rest out;
  altered     an answer altered where it is produced: the first 64x64
              tile of each eval frame's rgb turned over (1 - value).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

FAULTS = ("unchanged", "half_batch", "altered")


def _unchanged(orig):
    def step(state, *a, **kw):
        _, metrics = orig(state, *a, **kw)
        return dataclasses.replace(state, step=state.step + 1), metrics
    return step


def _half_rows(orig):
    def loss(outputs, batch, *a, **kw):
        h = batch["image"].shape[0] // 2
        return orig({k: v[:h] for k, v in outputs.items()},
                    {k: (v[:h] if torch.is_tensor(v) and v.dim() >= 2
                         else v) for k, v in batch.items()}, *a, **kw)
    return loss


def _altered(orig):
    def forward(*a, **kw):
        out, rout, boxes = orig(*a, **kw)
        rgb = out["rgb"].clone()
        rgb[:64, :64] = 1.0 - rgb[:64, :64]
        return {**out, "rgb": rgb}, rout, boxes
    return forward


@contextlib.contextmanager
def planted(name: str | None):
    """Plant fault `name` in the program for the block (None: nothing)."""
    if name is None:
        yield
        return
    from street_gaussians_ns_tpu_torch.engine import scene_train_step as sts
    from street_gaussians_ns_tpu_torch.engine import train_step as ts
    from street_gaussians_ns_tpu_torch.engine import trainer as tm
    from street_gaussians_ns_tpu_torch.models import scene_graph as sgm
    targets = {"unchanged": [(tm, "scene_train_step", _unchanged),
                             (ts, "train_step", _unchanged)],
               "half_batch": [(sts, "scene_loss_dict", _half_rows),
                              (ts, "loss_dict", _half_rows)],
               "altered": [(sgm, "forward_scene", _altered)]}[name]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    try:
        for mod, attr, wrap in targets:
            setattr(mod, attr, wrap(getattr(mod, attr)))
        yield
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)

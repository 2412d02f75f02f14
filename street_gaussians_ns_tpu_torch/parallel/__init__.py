"""The multi-device (data, model) trainer on torch.distributed: the
layout of the ranks (mesh), the collectives as autograd Functions
(collectives), the sharded step (sharded) and its trainer (trainer)."""

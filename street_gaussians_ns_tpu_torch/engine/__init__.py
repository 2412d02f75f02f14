"""Runtime around the models: the training step, the optimizer, the
trainer loop, run directories and checkpoints."""

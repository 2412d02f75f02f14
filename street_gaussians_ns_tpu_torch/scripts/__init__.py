"""Entry points: train, eval, render, export, viewer (counterpart of
street_gaussians_ns_tpu/scripts/). Each runs as
`python -m street_gaussians_ns_tpu_torch.scripts.<name>` with `--device`
(default cuda)."""

"""The standalone checkpoint viewer (counterpart of
street_gaussians_ns_tpu/scripts/viewer.py, the `ns-viewer` analog).

Usage:
    python -m street_gaussians_ns_tpu_torch.scripts.viewer \
        --load-dir outputs/run [--port 7007] [--device cpu]

Loads the run's config and latest checkpoint (engine.setup.eval_setup) on
the device (default "cuda"; it raises without a card unless --device cpu
is given) and serves the fly-camera viewer (utils.viewer), this process
dedicated to servicing render requests. Viewing while training is built
into the Trainer instead (TrainerConfig.viewer_port).
"""
from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--load-dir", type=Path, required=True)
    p.add_argument("--port", type=int, default=7007)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    args = p.parse_args(argv)

    from ..engine.setup import eval_setup
    from ..engine.trainer import attach_viewer

    trainer = eval_setup(args.load_dir, device=args.device)
    server = attach_viewer(trainer, args.port)
    server.update_stats(step=int(trainer.state.step), mode="checkpoint")
    print(f"viewer: http://localhost:{server.port}/  (ctrl-c to stop)",
          flush=True)
    try:
        server.serve_forever(trainer._viewer_render)
    finally:
        server.close()


if __name__ == "__main__":
    main()

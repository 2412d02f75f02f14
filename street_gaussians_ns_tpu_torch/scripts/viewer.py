"""The standalone checkpoint viewer (counterpart of
street_gaussians_ns_tpu/scripts/viewer.py) is not ported yet: running it
raises NotImplementedError (ROADMAP.md queue 1 item 6, with
utils/viewer and TrainerConfig.viewer_port)."""
from __future__ import annotations


def main(argv=None):
    raise NotImplementedError(
        "the live viewer (scripts/viewer, utils/viewer) is not ported yet "
        "(ROADMAP.md queue 1 item 6)")


if __name__ == "__main__":
    main()

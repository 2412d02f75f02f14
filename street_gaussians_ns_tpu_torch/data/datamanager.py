"""Full-image datamanager: cached whole-frame batches, epoch-random
sampling, fixed eval iteration (counterpart of
street_gaussians_ns_tpu/data/datamanager.py).

Whole undistorted images are decoded once into a host cache (a thread
pool), train batches are drawn at random WITHOUT replacement per epoch,
eval iterates fixed indices. The epoch order comes from
np.random.RandomState(seed), as in the JAX package, so both packages draw
the same frames in the same order. Cameras are built on the datamanager's
device; batches stay numpy (the trainer moves them). `sampler_state` /
`set_sampler_state` carry the sampler through a checkpoint, so a resumed
run draws what an uninterrupted one would.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core.cameras import Camera
from .dataparser import ParsedScene
from .dataset import FrameData, auto_downscale_factor, load_frame


@dataclasses.dataclass
class DataManagerConfig:
    undistort: bool = True
    downscale: int = 1
    # downscale == 1 + auto_downscale: frames larger than max_image_dim
    # are halved until they fit (the reference's rule,
    # sgn_dataparser.py:39,697-711).
    auto_downscale: bool = True
    max_image_dim: int = 1600
    # Persist undistorted/downscaled frames next to the source images
    # (`images_ud_2/` sibling-dir convention, sgn_dataparser.py:745-753);
    # later runs load the processed frames directly.
    disk_cache: bool = True
    cache_workers: int = 8
    seed: int = 42


class FullImageDatamanager:
    def __init__(self, scene: ParsedScene, config: DataManagerConfig,
                 device="cuda"):
        self.scene = scene
        self.config = config
        self.device = device
        self.rng = np.random.RandomState(config.seed)
        self._cache: Dict[int, FrameData] = {}
        self._train_order: List[int] = []

        with concurrent.futures.ThreadPoolExecutor(config.cache_workers) as ex:
            all_idx = list(dict.fromkeys(
                list(scene.train_indices) + list(scene.eval_indices)))
            for idx, frame in zip(all_idx, ex.map(self._load, all_idx)):
                self._cache[int(idx)] = frame

    def _load(self, idx: int) -> FrameData:
        downscale = self.config.downscale
        if downscale == 1 and self.config.auto_downscale:
            downscale = auto_downscale_factor(
                int(self.scene.width[int(idx)]),
                int(self.scene.height[int(idx)]),
                self.config.max_image_dim)
        return load_frame(self.scene, int(idx),
                          undistort=self.config.undistort,
                          downscale=downscale,
                          disk_cache=self.config.disk_cache)

    @property
    def num_train(self) -> int:
        return len(self.scene.train_indices)

    @property
    def num_eval(self) -> int:
        return len(self.scene.eval_indices)

    def _camera(self, frame: FrameData) -> Camera:
        return Camera.make(frame.fx, frame.fy, frame.cx, frame.cy,
                           frame.c2w, frame.width, frame.height,
                           time=frame.time, device=self.device)

    def _frame_to_sample(self, frame: FrameData, idx: Optional[int] = None):
        batch = {"image": frame.image, "time": np.float32(frame.time)}
        if idx is not None:
            # Global frame index (the camera optimizer's row key).
            batch["frame_idx"] = int(idx)
        if frame.mask is not None:
            batch["mask"] = frame.mask
        if frame.semantic is not None:
            batch["semantic"] = frame.semantic
        return self._camera(frame), batch

    def next_train(self, step: int = 0):
        """Random-without-replacement per epoch (sgn_datamanager:277-293)."""
        if not self._train_order:
            self._train_order = list(self.scene.train_indices)
            self.rng.shuffle(self._train_order)
        idx = int(self._train_order.pop())
        return self._frame_to_sample(self._cache[idx], idx)

    def next_eval(self, step: int = 0):
        if self.num_eval == 0:
            return None, None
        idx = int(self.rng.choice(self.scene.eval_indices))
        return self._frame_to_sample(self._cache[idx], idx)

    def fixed_indices_eval(self):
        """Deterministic (camera, batch) iteration over the eval split."""
        for idx in self.scene.eval_indices:
            yield self._frame_to_sample(self._cache[int(idx)], int(idx))

    def fixed_indices_train(self):
        for idx in self.scene.train_indices:
            yield self._frame_to_sample(self._cache[int(idx)], int(idx))

    def train_camera(self, i: int) -> Camera:
        """Camera of the i-th train frame WITHOUT touching the epoch
        sampler or loading a batch (the trainer's pre-sizing probe must
        not consume training samples)."""
        return self._camera(self._cache[int(self.scene.train_indices[i])])

    def sampler_state(self) -> Dict[str, np.ndarray]:
        """The sampler (RandomState and the rest of the epoch's order) as
        arrays, for a checkpoint."""
        _, keys, pos, has_gauss, gauss = self.rng.get_state()
        return {"rng_keys": np.asarray(keys, np.uint32),
                "rng_pos": np.asarray(pos, np.int64),
                "rng_has_gauss": np.asarray(has_gauss, np.int64),
                "rng_gauss": np.asarray(gauss, np.float64),
                "train_order": np.asarray(self._train_order, np.int64)}

    def set_sampler_state(self, arrays: Dict[str, np.ndarray]) -> None:
        """Continue from a sampler_state()."""
        self.rng.set_state(("MT19937", np.asarray(arrays["rng_keys"]),
                            int(arrays["rng_pos"]),
                            int(arrays["rng_has_gauss"]),
                            float(arrays["rng_gauss"])))
        self._train_order = [int(i) for i in arrays["train_order"]]

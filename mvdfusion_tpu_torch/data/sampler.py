"""Resume-aware deterministic scene sampler (a copy of
mvdfusion_tpu/data/sampler.py).

Counterpart of the reference's StatefulDistributedSampler
(utils/data_sampler_utils.py:10-143): deterministic per-epoch shuffle seeded
seed+epoch, and resume that skips already-consumed batches within the epoch
(start_iter semantics, :95-97,124-126). Where the reference strides indices
across NCCL ranks (:121), here one SPMD process consumes whole batches of
`batch_size` scenes — the rank dimension collapses into the batch
dimension.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


class StatefulShardedSampler:
    def __init__(self, num_scenes: int, batch_size: int, seed: int = 0, start_step: int = 0):
        self.num_scenes = num_scenes
        self.batch_size = batch_size
        self.seed = seed
        # Pad the epoch tail instead of dropping it, like the reference's
        # StatefulDistributedSampler (utils/data_sampler_utils.py:107-119):
        # every scene is visited at least once per epoch; the final batch
        # wraps around to the start of the shuffled order.
        self.steps_per_epoch = max(-(-num_scenes // batch_size), 1)
        # resume offset within the current epoch (consumed batches)
        self._offset = start_step % self.steps_per_epoch

    def epoch(self, epoch: int) -> Iterator[List[int]]:
        """Yield batches of scene indices for `epoch`, skipping any batches
        already consumed before a resume."""
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(self.num_scenes)
        # wrap-pad to a whole number of batches (no-op when evenly divisible)
        order = np.resize(order, self.batch_size * self.steps_per_epoch)
        for i in range(self._offset, self.steps_per_epoch):
            yield order[i * self.batch_size : (i + 1) * self.batch_size].tolist()

    def reset_offset(self) -> None:
        """Called at epoch end so subsequent epochs start from batch 0."""
        self._offset = 0

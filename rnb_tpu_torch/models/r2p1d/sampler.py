"""Clip sampling: which 8-frame windows of a video get inferred.

A copy of ``rnb_tpu/models/r2p1d/sampler.py`` (the port keeps its own
copies of the JAX package's jax-free modules): the same seeds give the
same clip starts, so both packages infer the same windows.

A video becomes 1..15 clips of ``consecutive_frames`` frames. The clip
count is drawn from a skewed two-point distribution (~91% small 1-clip
videos, ~9% large 15-clip videos) — the workload skew that motivates
content-aware Large/Small routing. Clips are spread evenly across the
video with a random global offset, recursively falling back to fewer
clips when the video is too short.

Capability parity with the reference sampler
(models/r2p1d/sampler.py:21-62), re-implemented standalone: no NVVL
``Sampler`` base class exists here — decoders consume the start-index
list directly. Sampling is deterministic per video id (seeded by a
CRC32 of the id) so runs are reproducible; pass an explicit ``rng`` to
restore global randomness.
"""

from __future__ import annotations

import zlib
from typing import List, Optional, Sequence

import numpy as np

DEFAULT_NUM_CLIPS_POPULATION = (1, 15)
DEFAULT_NUM_CLIPS_WEIGHTS = (10, 1)


class ClipSampler:
    """Contract: map a video's frame count to clip start indices."""

    consecutive_frames: int = 8

    def sample(self, num_frames: int, video_id: Optional[str] = None
               ) -> List[int]:
        raise NotImplementedError


class R2P1DSampler(ClipSampler):
    def __init__(self,
                 consecutive_frames: int = 8,
                 num_clips_population: Sequence[int] =
                 DEFAULT_NUM_CLIPS_POPULATION,
                 weights: Sequence[float] = DEFAULT_NUM_CLIPS_WEIGHTS,
                 rng: Optional[np.random.Generator] = None):
        if len(num_clips_population) != len(weights):
            raise ValueError("population and weights length mismatch")
        self.consecutive_frames = int(consecutive_frames)
        self.num_clips_population = list(num_clips_population)
        w = np.asarray(weights, dtype=np.float64)
        self.probabilities = w / w.sum()
        self._rng = rng

    @property
    def max_clips(self) -> int:
        return max(self.num_clips_population)

    def _rng_for(self, video_id: Optional[str]) -> np.random.Generator:
        if self._rng is not None:
            return self._rng
        seed = zlib.crc32(str(video_id).encode()) if video_id is not None \
            else None
        return np.random.default_rng(seed)

    def choose_num_clips(self, video_id: Optional[str] = None) -> int:
        rng = self._rng_for(video_id)
        return int(rng.choice(self.num_clips_population,
                              p=self.probabilities))

    def sample(self, num_frames: int, video_id: Optional[str] = None,
               num_clips: Optional[int] = None) -> List[int]:
        """Evenly-spread clip start indices with a random global offset.

        With stride ``num_frames // num_clips``, clip i starts at
        ``i * stride + offset`` where the offset is drawn from the slack
        within one stride. When the video cannot hold ``num_clips``
        non-overlapping windows, retry with fewer clips (reference
        recursion, models/r2p1d/sampler.py:37-53).
        """
        f = self.consecutive_frames
        if num_frames < f:
            raise ValueError(
                "video of %d frames is shorter than one clip (%d frames)"
                % (num_frames, f))
        rng = self._rng_for(video_id)
        if num_clips is None:
            num_clips = int(rng.choice(self.num_clips_population,
                                       p=self.probabilities))
        while num_clips > 1 and num_clips * f > num_frames:
            num_clips -= 1
        stride = num_frames // num_clips
        slack = stride - f
        offset = int(rng.integers(0, slack + 1)) if slack > 0 else 0
        return [i * stride + offset for i in range(num_clips)]

"""Request-stream sources: iterables of video paths for the client.

Counterpart of ``rnb_tpu/video_path_provider.py``. A concrete iterator
is named by string in the JSON config (``video_path_iterator``) and
built inside the client thread; it cycles forever so any requested
video count can be served. :class:`ZipfPathIterator` wraps one with
seeded Zipf popularity (root config key ``popularity``).
"""

from __future__ import annotations

import os

VIDEO_EXTENSIONS = (".y4m", ".mjpg", ".mjpeg")


def scan_video_tree(root: str, extensions=VIDEO_EXTENSIONS) -> list:
    """Sorted video paths from a root/label/video dataset tree."""
    videos = []
    for label in sorted(os.listdir(root)):
        label_dir = os.path.join(root, label)
        if os.path.isdir(label_dir):
            videos.extend(
                os.path.join(label_dir, v)
                for v in sorted(os.listdir(label_dir))
                if v.endswith(extensions))
    return videos


class VideoPathIterator:
    """Base contract: iterate video paths forever."""

    def __iter__(self):
        raise NotImplementedError

    def dataset(self):
        """The finite video universe behind this iterator, or None when
        unknown (the Zipf wrapper then draws distinct items from the
        cycle)."""
        return None


#: fallback universe size when a base iterator exposes no dataset():
#: bounded so materializing distinct items from an endless cycle halts
DEFAULT_UNIVERSE = 1024


def zipf_probabilities(universe: int, s: float):
    """Rank-frequency Zipf pmf over ranks 1..universe: p(r) ~ r^-s
    (``s=0`` is uniform)."""
    import numpy as np
    if universe < 1:
        raise ValueError("universe must be >= 1, got %r" % (universe,))
    if s < 0:
        raise ValueError("zipf skew s must be >= 0, got %r" % (s,))
    weights = np.arange(1, universe + 1, dtype=np.float64) ** -float(s)
    return weights / weights.sum()


class ZipfPathIterator(VideoPathIterator):
    """Draw paths from a base iterator's universe with Zipf(s) rank
    frequencies: rank r is the r-th video of the base's dataset, and the
    draws are seeded, so the same (dataset, s, universe, seed) gives
    the same request sequence as the reference's iterator. ``universe``
    keeps the first N videos, clamped to the dataset size."""

    def __init__(self, base, s: float = 1.0, universe=None, seed=None):
        import numpy as np
        videos = base.dataset() if hasattr(base, "dataset") else None
        if videos is None:
            want = int(universe) if universe else DEFAULT_UNIVERSE
            seen, ordered = set(), []
            for video in base:
                if video in seen:
                    break
                seen.add(video)
                ordered.append(video)
                if len(ordered) >= want:
                    break
            videos = ordered
        if not videos:
            raise ValueError("ZipfPathIterator needs a non-empty video "
                             "universe")
        videos = list(videos)
        if universe is not None:
            universe = min(int(universe), len(videos))
            if universe < 1:
                raise ValueError("popularity universe must be >= 1")
            videos = videos[:universe]
        self._videos = videos
        self.s = float(s)
        self.seed = seed
        self._probabilities = zipf_probabilities(len(videos), self.s)
        self._cumulative = np.cumsum(self._probabilities)
        self._cumulative[-1] = 1.0  # guard float drift at the tail

    def dataset(self):
        return list(self._videos)

    def __iter__(self):
        import numpy as np
        rng = np.random.default_rng(self.seed)
        videos, cumulative = self._videos, self._cumulative
        while True:
            # inverse-CDF draw, as the reference draws
            yield videos[int(np.searchsorted(cumulative, rng.random(),
                                             side="right"))]

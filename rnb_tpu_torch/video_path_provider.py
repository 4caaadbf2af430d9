"""Request-stream sources: iterables of video paths for the client.

Counterpart of ``rnb_tpu/video_path_provider.py``. A concrete iterator
is named by string in the JSON config (``video_path_iterator``) and
built inside the client thread; it cycles forever so any requested
video count can be served.
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

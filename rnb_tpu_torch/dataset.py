"""Generate a y4m dataset for the serving path, from a seed.

Writes ``root/labelNN/vNNN.y4m``: 112x112 4:2:0 clips of smooth moving
gradients plus noise, the layout ``R2P1DVideoPathIterator`` scans. The
benchmark reads it through ``RNB_TPU_DATA_ROOT``::

    python -m rnb_tpu_torch.dataset /tmp/rnb-data --videos 32
    RNB_TPU_DATA_ROOT=/tmp/rnb-data python -m rnb_tpu_torch.benchmark \\
        -c configs/rnb-fused-yuv-big.json -mi 0 -v 2000
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from rnb_tpu_torch.decode import write_y4m


def make_dataset(root: str, videos: int = 32, frames: int = 128,
                 size: int = 112, labels: int = 4, seed: int = 7) -> str:
    """Write ``videos`` clips of ``frames`` frames; returns ``root``.
    128 frames hold the sampler's largest draw (15 clips of 8)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    t = np.arange(frames, dtype=np.float32)[:, None, None]
    for i in range(videos):
        label = os.path.join(root, "label%02d" % (i % labels))
        os.makedirs(label, exist_ok=True)
        phase = rng.uniform(0, 2 * np.pi, 3)
        base = np.stack([
            128 + 100 * np.sin(0.05 * (xx + 3 * t) + phase[c]
                               + 0.03 * (i + 1) * yy) for c in range(3)],
            axis=-1)
        clip = np.clip(base + rng.normal(0, 12, base.shape), 0, 255)
        write_y4m(os.path.join(label, "v%03d.y4m" % i),
                  clip.astype(np.uint8), colorspace="420")
    return root


def clip_mix(root: str) -> dict:
    """``{video path: clips}`` a request for each video under ``root``
    draws: the sampler seeds its draw with a CRC of the path, so the mix
    follows the path string (a fixed relative root serves the same mix
    in every run and checkout)."""
    from rnb_tpu_torch.decode import get_decoder
    from rnb_tpu_torch.models.r2p1d.sampler import R2P1DSampler
    from rnb_tpu_torch.video_path_provider import scan_video_tree
    sampler = R2P1DSampler()
    return {video: len(sampler.sample(get_decoder(video).num_frames(video),
                                      video_id=video))
            for video in scan_video_tree(root)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("root")
    parser.add_argument("--videos", type=int, default=32)
    parser.add_argument("--frames", type=int, default=128)
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args(argv)
    make_dataset(args.root, args.videos, args.frames, seed=args.seed)
    print("wrote %d videos under %s" % (args.videos, args.root))
    return 0


if __name__ == "__main__":
    sys.exit(main())

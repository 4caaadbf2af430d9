"""Generate a video dataset for the serving path, from a seed.

Writes ``root/labelNN/vNNN.y4m`` (the default): 112x112 4:2:0 clips of
smooth moving gradients plus noise, the layout
``R2P1DVideoPathIterator`` scans. ``--format mjpeg`` writes
``root/labelNN/vNNN.mjpg`` instead: baseline-JPEG frames written by the
port's own encoder (``rnb_tpu_torch.decode.write_mjpeg``, no PIL) at
``--quality``, holding the frames the JAX package's
``scripts/make_dataset.py`` generates (its ``synth_frames``, seeded
``[seed, label, video]``). ``--dct-budget`` refuses to write a frame
whose nonzero coefficients exceed the dct path's default budget: such a
frame could never be served on that path. The dct trees are written at
quality 70 (``DCT_QUALITY``), where the generator's frames fit the
budget with about 10% to spare; at 75 an occasional frame does not. The
benchmark reads a tree through ``RNB_TPU_DATA_ROOT``::

    python -m rnb_tpu_torch.dataset /tmp/rnb-data --videos 32
    python -m rnb_tpu_torch.dataset /tmp/rnb-dct --format mjpeg \\
        --quality 70 --dct-budget
    RNB_TPU_DATA_ROOT=/tmp/rnb-data python -m rnb_tpu_torch.benchmark \\
        -c configs/rnb-fused-yuv-big.json -mi 0 -v 2000
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import numpy as np

from rnb_tpu_torch.decode import write_y4m
from rnb_tpu_torch.decode.mjpeg_encode import encode_frames

#: JPEG quality of the pixel paths' MJPEG trees (``bench.py``'s default)
PIXEL_QUALITY = 90
#: JPEG quality of the dct path's MJPEG trees: the highest at which every
#: generated frame fits the default coefficient budget
DCT_QUALITY = 70
FORMATS = ("y4m", "mjpeg")


def synth_frames(num_frames: int, height: int, width: int,
                 seed) -> np.ndarray:
    """The JAX package's generator (``scripts/make_dataset.py``): moving
    diagonal gradients plus a per-video noise floor of 0..15. ``seed``
    is anything ``np.random.default_rng`` accepts."""
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    speed = rng.uniform(0.5, 2.0, size=3)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    base = (yy / height + xx / width)
    t = np.arange(num_frames, dtype=np.float32)[:, None, None]
    frames = np.empty((num_frames, height, width, 3), np.uint8)
    for c in range(3):
        wave = 127.5 * (1.0 + np.sin(
            2 * np.pi * base[None] + phase[c] + 0.2 * speed[c] * t))
        frames[..., c] = wave.astype(np.uint8)
    noise = rng.integers(0, 16, frames.shape, dtype=np.uint8)
    return np.clip(frames.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def write_mjpeg_checked(path: str, frames: np.ndarray, quality: int,
                        dct_budget: Optional[int] = None) -> None:
    """Encode ``frames`` and write them as an MJPEG file; with
    ``dct_budget``, refuse (ValueError, nothing written) when a frame
    holds more nonzero coefficients than the budget."""
    jpegs, zz = encode_frames(frames, quality)
    if dct_budget is not None:
        counts = np.count_nonzero(zz.reshape(len(jpegs), -1), axis=1)
        over = np.nonzero(counts > dct_budget)[0]
        if over.size:
            raise ValueError(
                "%s frame %d holds %d nonzero DCT coefficients at quality "
                "%d, over the dct budget of %d (%d frame(s) over): lower "
                "the quality" % (path, over[0], counts[over[0]], quality,
                                 dct_budget, over.size))
    with open(path, "wb") as f:
        for jpeg in jpegs:
            f.write(jpeg)


def make_dataset(root: str, videos: int = 32, frames: int = 128,
                 size: int = 112, labels: int = 4, seed: int = 7,
                 fmt: str = "y4m", quality: int = PIXEL_QUALITY,
                 dct_budget: Optional[int] = None) -> str:
    """Write ``videos`` clips of ``frames`` frames; returns ``root``.
    128 frames hold the sampler's largest draw (15 clips of 8). Video
    ``i`` goes under label ``i % labels``."""
    if fmt not in FORMATS:
        raise ValueError("format must be one of %s, got %r"
                         % (FORMATS, fmt))
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    t = np.arange(frames, dtype=np.float32)[:, None, None]
    for i in range(videos):
        label = os.path.join(root, "label%02d" % (i % labels))
        os.makedirs(label, exist_ok=True)
        if fmt == "mjpeg":
            write_mjpeg_checked(
                os.path.join(label, "v%03d.mjpg" % i),
                synth_frames(frames, size, size,
                             seed=[seed, i % labels, i // labels]),
                quality, dct_budget)
            continue
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
    parser.add_argument("--format", default="y4m", choices=FORMATS)
    parser.add_argument("--quality", type=int, default=PIXEL_QUALITY,
                        help="JPEG quality of --format mjpeg (%d for the "
                        "dct path)" % DCT_QUALITY)
    parser.add_argument("--dct-budget", action="store_true",
                        help="refuse a frame over the dct path's default "
                        "coefficient budget (--format mjpeg)")
    args = parser.parse_args(argv)
    budget = None
    if args.dct_budget:
        from rnb_tpu_torch.ops.dct import default_dct_coeffs
        budget = default_dct_coeffs(112, 112)
    t0 = time.perf_counter()
    make_dataset(args.root, args.videos, args.frames, seed=args.seed,
                 fmt=args.format, quality=args.quality, dct_budget=budget)
    print("wrote %d videos under %s in %.3f s" % (
        args.videos, args.root, time.perf_counter() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Decode service per request on the host, by container and pixel path.

Run from the root of a checkout, on the machine to measure::

    python3 -m rnb_tpu_torch.tools.decode_probe ROOT [ROOT ...] \\
        [--paths rgb yuv420 dct] [--reps 3]

For every video under each dataset ROOT (``rnb_tpu_torch.dataset``'s
layout; ``synth:N`` stands for the N synthetic ids the iterator serves
without a dataset, ``synth://kinetics/video-0000`` on), draws the clip
starts a request for it draws (the sampler, seeded by the path) and
decodes them ``--reps`` times on one thread through the decoder
``get_decoder`` picks (the native pool's library where it is built), on
each pixel path the files hold (dct needs MJPEG or synthetic ids, and a
frame over the dct budget gives the line an ``error`` instead).
Prints one JSON object a line per (root, path): the backend, the
requests, clips and frames decoded, and the median over the reps of the
milliseconds per request and per frame (one thread, so the decode's CPU
time, not a pool's throughput), plus the host's CPU count.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from rnb_tpu_torch.decode import CorruptVideoError, get_decoder
from rnb_tpu_torch.models.r2p1d.sampler import R2P1DSampler
from rnb_tpu_torch.video_path_provider import scan_video_tree

FRAMES = 8
HW = 112
MAX_CLIPS = 15
#: the iterator's ids without a dataset (R2P1DVideoPathIterator)
SYNTH_ID = "synth://kinetics/video-%04d"


def _videos(root: str) -> list:
    if root.startswith("synth:"):
        return [SYNTH_ID % i for i in range(int(root[len("synth:"):]))]
    return scan_video_tree(root)


def probe(root: str, path: str, reps: int) -> dict:
    """One root on one pixel path: -> the JSON line's fields."""
    sampler = R2P1DSampler(consecutive_frames=FRAMES)
    videos = _videos(root)
    jobs = []
    for video in videos:
        decoder = get_decoder(video)
        starts = [int(s) for s in sampler.sample(
            decoder.num_frames(video), video_id=video)][:MAX_CLIPS]
        jobs.append((decoder, video, starts))
    decode = {"rgb": "decode_clips", "yuv420": "decode_clips_yuv",
              "dct": "decode_clips_dct"}[path]
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for decoder, video, starts in jobs:
            getattr(decoder, decode)(video, starts, FRAMES, HW, HW)
        times.append(time.perf_counter() - t0)
    seconds = sorted(times)[len(times) // 2]
    clips = sum(len(starts) for _, _, starts in jobs)
    return {"root": root, "pixel_path": path,
            "backend": sorted({d.BACKEND for d, _, _ in jobs}),
            "requests": len(jobs), "clips": clips,
            "frames": clips * FRAMES,
            "ms_per_request": 1e3 * seconds / len(jobs),
            "ms_per_frame": 1e3 * seconds / (clips * FRAMES),
            "cpus": os.cpu_count()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("roots", nargs="+")
    parser.add_argument("--paths", nargs="+",
                        default=["rgb", "yuv420", "dct"])
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    for root in args.roots:
        coefficients = root.startswith("synth:") or any(
            v.endswith((".mjpg", ".mjpeg")) for v in _videos(root))
        for path in args.paths:
            if path == "dct" and not coefficients:
                continue  # a y4m file holds no coefficients
            try:
                line = probe(root, path, args.reps)
            except CorruptVideoError as e:
                # a tree written for the pixel paths may hold frames
                # over the dct budget
                line = {"root": root, "pixel_path": path, "error": str(e)}
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The chaos copy of ``configs/rnb-fused-yuv-staged.json``: the full-width
fused yuv420 cell with fault containment and deadlines switched on.

It adds ``overload_policy: "shed"``, a retry budget on both steps
(``max_retries`` 2, ``retry_backoff_ms`` 5), a ``deadline`` and a seeded
``fault_plan``: a permanent fault at step 0 on :data:`PERMANENT_IDS`
(their decode step fails, they are dead-lettered, their batchmates are
served), a transient one at step 1 on :data:`TRANSIENT_IDS` (retried and
served), and two stalls longer than the budget — at step 1 on
:data:`STEP1_STALL_ID`, so the emissions step 0 publishes meanwhile
expire at step 1's queue take, and at step 0 on :data:`STEP0_STALL_ID`,
late enough that step 0 is still publishing while step 1 stalls, so the
requests behind it expire before their decode. Every faulted id comes
early enough in a bulk run that only the stalls make anything expire.

:func:`write_chaos_dataset` links a dataset into a second root and adds
one video whose header probes and whose decode fails
(:data:`BROKEN_NAME`), so the request that draws it fails inside the
fused loader's take, after it was planned into its rows, and the take's
other requests are emitted without it.

``--burst`` writes the copy a 1 ms Poisson burst into short queues
serves: the same faults, but both stalls on :data:`BURST_STALL_ID`, the
client's first request, which always finds the filename queue empty, so
both always fire, at the burst's start. Step 0 stalls
:data:`BURST_STEP0_STALL_MS` first: the filename queue fills and the
client sheds. Then step 1 stalls :data:`STALL_MS`: what step 0
publishes meanwhile waits past the budget in step 1's queue and expires
at its take. Sheds count toward the run's target, so the burst's target
must exceed what is shed during both stalls (:data:`BURST_MIN_TARGET`);
the bulk copy's stalls on later ids could fall on a request the burst's
client shed, or after the target was shed whole.

``--empty-plan`` writes the copy with no fault in its plan and a budget
no request comes near: every containment check runs and nothing fails,
the cell that measures what the checks cost. Written beside a dataset,
never into ``configs/``::

    python3 -m rnb_tpu_torch.tools.chaos OUT.json [--empty-plan | --burst]
"""

from __future__ import annotations

import json
import os
import struct
import sys

STAGED = "configs/rnb-fused-yuv-staged.json"
PERMANENT_IDS = (2, 5)
TRANSIENT_IDS = (1, 13)
STEP1_STALL_ID = 20
STEP0_STALL_ID = 60
#: the burst copy's stalls: the client's first request
BURST_STALL_ID = 0
BUDGET_MS = 1000
STALL_MS = 1500
#: the burst's step-0 stall: long enough to fill a 4-deep filename queue
#: at a 1 ms mean, short beside the budget
BURST_STEP0_STALL_MS = 100
#: the smallest target of a burst at a 1 ms mean that is not shed whole
#: during its stalls: 1,600 arrivals are expected in them
BURST_MIN_TARGET = 2 * STALL_MS
#: the budget of the empty-plan copy: ten minutes, never reached
EMPTY_PLAN_BUDGET_MS = 600000
#: the undecodable video of the chaos dataset, in its first label
#: directory: the name sorts it after that directory's y4m files
BROKEN_NAME = "v999-broken.mjpg"
HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def chaos_config(empty_plan: bool = False, burst: bool = False) -> dict:
    """The staged config with the containment keys added (``burst``:
    the burst's plan, both stalls on the first request)."""
    with open(os.path.join(HERE, STAGED)) as f:
        raw = json.load(f)
    stalls = ([{"step": 1, "kind": "stall", "ms": STALL_MS,
                "request_ids": [BURST_STALL_ID]},
               {"step": 0, "kind": "stall", "ms": BURST_STEP0_STALL_MS,
                "request_ids": [BURST_STALL_ID]}] if burst else [
        {"step": 1, "kind": "stall", "ms": STALL_MS,
         "request_ids": [STEP1_STALL_ID]},
        {"step": 0, "kind": "stall", "ms": STALL_MS,
         "request_ids": [STEP0_STALL_ID]}])
    faults = [] if empty_plan else [
        {"step": 0, "kind": "permanent", "request_ids": list(PERMANENT_IDS)},
        {"step": 1, "kind": "transient", "request_ids": list(TRANSIENT_IDS)},
    ] + stalls
    raw.update(overload_policy="shed",
               deadline={"budget_ms": EMPTY_PLAN_BUDGET_MS if empty_plan
                         else BUDGET_MS},
               fault_plan={"seed": 0, "faults": faults})
    for step in raw["pipeline"]:
        step.update(max_retries=2, retry_backoff_ms=5)
    return raw


def write_chaos_copy(path: str, empty_plan: bool = False,
                     burst: bool = False) -> str:
    with open(path, "w") as f:
        json.dump(chaos_config(empty_plan, burst), f)
    return path


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def flat_jpeg(size: int = 16) -> bytes:
    """One baseline JPEG of a flat grey ``size`` x ``size`` 4:2:0 frame
    (``size`` a multiple of 16), written by hand: unit quantizers, one
    DC and one AC Huffman table of a single one-bit code each (DC
    difference 0, end of block), so every block is the two bits 00."""
    one_code = bytes([1] + [0] * 15) + bytes([0])
    blocks = 6 * (size // 16) ** 2  # 4 luma + 2 chroma blocks an MCU
    bits = "00" * blocks
    bits += "1" * (-len(bits) % 8)  # pad the last byte with ones
    scan = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    return (b"\xff\xd8"
            + _segment(0xDB, bytes([0]) + bytes([1] * 64))
            + _segment(0xC0, bytes([8]) + struct.pack(">HH", size, size)
                       + bytes([3, 1, 0x22, 0, 2, 0x11, 0, 3, 0x11, 0]))
            + _segment(0xC4, bytes([0x00]) + one_code)
            + _segment(0xC4, bytes([0x10]) + one_code)
            + _segment(0xDA, bytes([3, 1, 0, 2, 0, 3, 0, 0, 63, 0]))
            + scan + b"\xff\xd9")


def broken_mjpeg(frames: int = 128) -> bytes:
    """An MJPEG stream that probes as ``frames`` frames: the first a
    valid JPEG (:func:`flat_jpeg`, which fixes the geometry), every
    later one an SOI straight followed by an EOI. A clip reads a frame
    past the first, so every decode of it fails with a malformed stream
    (``CorruptVideoError``, permanent) when its tickets are waited."""
    return flat_jpeg() + b"\xff\xd8\xff\xd9" * (frames - 1)


def write_chaos_dataset(data_root: str, out_root: str) -> str:
    """``out_root``: every video of ``data_root`` linked under its label
    directory, plus :data:`BROKEN_NAME` (:func:`broken_mjpeg`) in the
    first one. Returns the broken video's path."""
    from rnb_tpu_torch.video_path_provider import scan_video_tree
    videos = scan_video_tree(data_root)
    for video in videos:
        label = os.path.join(out_root, os.path.basename(
            os.path.dirname(video)))
        os.makedirs(label, exist_ok=True)
        link = os.path.join(label, os.path.basename(video))
        if not os.path.lexists(link):
            os.symlink(os.path.abspath(video), link)
    broken = os.path.join(out_root, os.path.basename(
        os.path.dirname(videos[0])), BROKEN_NAME)
    with open(broken, "wb") as f:
        f.write(broken_mjpeg())
    return broken


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    empty_plan = "--empty-plan" in args
    burst = "--burst" in args
    paths = [a for a in args if a not in ("--empty-plan", "--burst")]
    if len(paths) != 1 or (empty_plan and burst):
        print(__doc__, file=sys.stderr)
        return 2
    write_chaos_copy(paths[0], empty_plan, burst)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What a ``torch.profiler`` capture costs on the card, and where CUPTI is.

Run on a machine with a CUDA card, from the root of a checkout::

    python3 -m rnb_tpu_torch.tools.profiler_probe [--sessions N] [--teardown]

Prints, one JSON object a line: the torch and CUDA versions, the card's
name and power limit, which of ``$CUDA_HOME/extras/CUPTI/include/cupti.h``
and ``$CUDA_HOME/include/cupti.h`` exist; then, while one thread replays
a captured CUDA graph (a bf16 3x3x3 convolution at layer 3's width) and
a plain kernel back to back, ``N`` capture windows of 250 ms (4 by
default), each opened from a new thread through
:mod:`rnb_tpu_torch.profiler` as a devobs worker opens them: each one's
``initialize`` / ``flush`` / ``report`` seconds, its event count and
planes, how many of the graph's kernels it holds, and the longest gap
between the ticks of a Python thread that ticks every millisecond
while ``flush`` runs (how long stopping the session holds the
interpreter: every serving thread waits that long); last, the replay
rate with no session, during one and after it. ``--teardown`` lets
kineto tear CUPTI down after each session (``TEARDOWN_CUPTI=1``, kineto's
default; the bridge keeps it set up). A session that has not ended
after ``WATCHDOG_S`` dumps every thread's stack and exits 1.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import subprocess
import sys
import threading
import time

import torch

from rnb_tpu_torch import profiler

WINDOW_S = 0.25
WATCHDOG_S = 60


def _emit(**record) -> None:
    print(json.dumps(record), flush=True)


def _replay_rate(graph, seconds: float = 1.0) -> float:
    n, t0 = 0, time.time()
    while time.time() - t0 < seconds:
        graph.replay()
        torch.cuda.synchronize()
        n += 1
    return n / seconds


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sessions", type=int, default=4)
    parser.add_argument("--teardown", action="store_true")
    args = parser.parse_args(argv)
    if args.teardown:
        os.environ["TEARDOWN_CUPTI"] = "1"
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device is available", file=sys.stderr)
        return 1
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    _emit(torch=torch.__version__, cuda=torch.version.cuda, card=smi,
          cupti_h={path: os.path.exists(path) for path in (
              os.path.join(cuda_home, "extras/CUPTI/include/cupti.h"),
              os.path.join(cuda_home, "include/cupti.h"))})
    device = torch.device("cuda", 0)
    conv = torch.nn.Conv3d(128, 128, 3, padding=1, bias=False).to(
        device, torch.bfloat16).eval()
    x = torch.randn(6, 128, 4, 28, 28, device=device, dtype=torch.bfloat16)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.inference_mode():
        with torch.cuda.stream(stream):
            for _ in range(3):
                conv(x)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            conv(x)
    torch.cuda.synchronize()
    stop = threading.Event()

    def serve():
        with torch.inference_mode():
            while not stop.is_set():
                graph.replay()
                x.mul(2)
                torch.cuda.synchronize()
    ticks = []

    def tick():
        while not stop.is_set():
            ticks.append(time.time())
            time.sleep(0.001)
    server = threading.Thread(target=serve, name="serve")
    ticker = threading.Thread(target=tick, name="tick")
    server.start()
    ticker.start()
    try:
        for session in range(args.sessions):
            record = {}

            def capture():
                t0 = time.time()
                profiler.initialize()
                t1 = time.time()
                time.sleep(WINDOW_S)
                t2 = time.time()
                profiler.flush()
                t3 = time.time()
                ops = profiler.report(include_plane=True)
                t4 = time.time()
                near = [t for t in list(ticks) if t2 - 0.05 <= t <= t3 + 0.05]
                record.update(
                    initialize_s=t1 - t0, flush_s=t3 - t2, report_s=t4 - t3,
                    flush_max_tick_gap_s=max(
                        (b - a for a, b in zip(near, near[1:])), default=None),
                    events=len(ops), planes=sorted({op[3] for op in ops}),
                    graph_kernels=sum("fprop" in op[0] for op in ops))
            worker = threading.Thread(target=capture, name="capture")
            faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
            worker.start()
            worker.join()
            faulthandler.cancel_dump_traceback_later()
            _emit(session=session, window_s=WINDOW_S,
                  teardown_cupti=os.environ.get("TEARDOWN_CUPTI"), **record)
    finally:
        stop.set()
        server.join()
        ticker.join()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    with torch.inference_mode():
        off = _replay_rate(graph)
        profiler.initialize()
        during = _replay_rate(graph)
        profiler.flush()
        profiler.report()
        after = _replay_rate(graph)
    faulthandler.cancel_dump_traceback_later()
    _emit(replays_per_s={"off": off, "during": during, "after": after})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Load generators: the request streams that drive a pipeline.

Counterpart of ``rnb_tpu/client.py``. ``poisson_client`` emits one
video request per draw of an exponential inter-arrival time (mean
``mean_interval_ms``): the open-loop streaming workload.
``bulk_client`` enqueues ``num_videos`` requests at once: the
max-throughput mode (``-mi 0``). Both stamp a fresh TimeCard
(``enqueue_filename``) per request. With the root ``popularity`` key
the configured iterator is wrapped in the seeded Zipf sampler. A full
filename queue aborts the run (``FILENAME_QUEUE_FULL``), as in the
reference.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Optional

import numpy as np

from rnb_tpu_torch.control import (NUM_EXIT_MARKERS, TerminationFlag,
                                   TerminationState, send_exit_markers)
from rnb_tpu_torch.telemetry import TimeCard
from rnb_tpu_torch.utils.class_utils import load_class
from rnb_tpu_torch.video_path_provider import ZipfPathIterator


def _client(video_path_iterator_path: str, filename_queue: "queue.Queue",
            termination: TerminationState, sta_bar: threading.Barrier,
            fin_bar: threading.Barrier, *, mean_interval_ms: int,
            num_videos: Optional[int], seed: Optional[int],
            num_markers: int = NUM_EXIT_MARKERS,
            popularity: Optional[dict] = None) -> None:
    try:
        source = load_class(video_path_iterator_path)()
        if popularity is not None:
            # a child seed for the popularity draws: seeding them and the
            # Poisson gaps below with one value would couple video rank
            # with the next gap (the reference's rule, so the draws are
            # the reference's draws)
            zipf_seed = (None if seed is None
                         else np.random.SeedSequence([seed, 1]))
            source = ZipfPathIterator(source, s=popularity.get("s", 1.0),
                                      universe=popularity.get("universe"),
                                      seed=zipf_seed)
        iterator = iter(source)
        rng = np.random.default_rng(seed)
    except Exception:
        traceback.print_exc()
        termination.raise_flag(TerminationFlag.INTERNAL_ERROR)
        iterator = None

    try:
        sta_bar.wait()
    except threading.BrokenBarrierError:
        pass

    try:
        if iterator is not None:
            video_count = 0
            while not termination.terminated:
                if num_videos is not None and video_count >= num_videos:
                    break
                video_path = next(iterator)
                time_card = TimeCard(video_count)
                time_card.record("enqueue_filename")
                try:
                    filename_queue.put_nowait((None, video_path, time_card,
                                             None))
                except queue.Full:
                    termination.raise_flag(
                        TerminationFlag.FILENAME_QUEUE_FULL)
                    break
                video_count += 1
                if mean_interval_ms > 0:
                    time.sleep(rng.exponential(mean_interval_ms / 1000.0))
    except Exception:
        traceback.print_exc()
        termination.raise_flag(TerminationFlag.INTERNAL_ERROR)
    finally:
        send_exit_markers(filename_queue, num_markers, termination)
        try:
            fin_bar.wait()
        except threading.BrokenBarrierError:
            pass


def poisson_client(video_path_iterator_path, filename_queue,
                   mean_interval_ms, termination, sta_bar, fin_bar,
                   seed: Optional[int] = None,
                   num_markers: int = NUM_EXIT_MARKERS,
                   popularity: Optional[dict] = None) -> None:
    """Open-loop Poisson stream until the job terminates."""
    _client(video_path_iterator_path, filename_queue, termination, sta_bar,
            fin_bar, mean_interval_ms=mean_interval_ms, num_videos=None,
            seed=seed, num_markers=num_markers, popularity=popularity)


def bulk_client(video_path_iterator_path, filename_queue, num_videos,
                termination, sta_bar, fin_bar,
                seed: Optional[int] = None,
                num_markers: int = NUM_EXIT_MARKERS,
                popularity: Optional[dict] = None) -> None:
    """Enqueue ``num_videos`` requests immediately."""
    _client(video_path_iterator_path, filename_queue, termination, sta_bar,
            fin_bar, mean_interval_ms=0, num_videos=num_videos, seed=seed,
            num_markers=num_markers, popularity=popularity)

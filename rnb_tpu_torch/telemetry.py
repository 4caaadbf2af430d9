"""Request-scoped tracing: per-request event timelines and their tables.

Counterpart of ``rnb_tpu/telemetry.py``. Every request carries a
:class:`TimeCard`; each stage stamps named events on it
(``runner{i}_start``, ``inference{i}_start``, ``inference{i}_finish``)
and appends its device label to the card's trail. A fused dispatch
stamps all of its requests at once through :class:`TimeCardList`. The
final step's :class:`TimeCardSummary` writes the per-instance timing
table in the JAX package's text format: one header line of event keys
and ``device{step}`` columns, one row per request, then trailers.

Besides the event stamps, the loader stamps a card's content: its clip
rows (``num_clips``), the first row of its request's rows in the
emission (``row0``; a coalesced follower shares its leader's rows), and
the cache outcome: ``cache_hit`` (True/False on a cache-enabled loader,
None otherwise), ``cache_coalesced`` (the request shared another's
in-flight decode) and ``feature_hit`` (answered from feature pages; the
forward never ran for it). Two transient carriers take live pager state
from the loader to the consuming stage, which pops them:
``feature_plan`` (a feature hit's pinned gather plan) and
``feature_insert`` (the (content key, row0, rows) insert the runner
performs after its forward returned).
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import IO, List, Optional, Sequence


def logroot(job_id: str, base: str = "logs") -> str:
    """Directory holding every artifact of one benchmark job."""
    path = os.path.join(base, str(job_id))
    os.makedirs(path, exist_ok=True)
    return path


def logmeta(job_id: str, base: str = "logs") -> str:
    """Path of the job metadata file (args, wall time, termination)."""
    return os.path.join(logroot(job_id, base), "log-meta.txt")


def logname(job_id: str, device_label: str, group_idx: int,
            instance_idx: int, base: str = "logs") -> str:
    """Path of one final-step instance's timing table."""
    safe = str(device_label).replace(":", "").replace("/", "-")
    return os.path.join(
        logroot(job_id, base),
        "%s-group%d-%d.txt" % (safe, group_idx, instance_idx))


def latency_percentiles(latencies_ms: Sequence[float],
                        percentiles=(50.0, 99.0)):
    """{percentile: value_ms} over a latency sample; {} when empty."""
    import numpy as np
    if not latencies_ms:
        return {}
    return {p: float(np.percentile(latencies_ms, p)) for p in percentiles}


class TimeCard:
    """An ordered event -> timestamp record riding along with one
    request, plus the trail of devices it visited."""

    def __init__(self, id: int):
        self.timings: "OrderedDict[str, float]" = OrderedDict()
        self.id = id
        #: one entry per pipeline step traversed (a tuple of labels)
        self.devices: List[tuple] = []
        #: clip rows the loader sampled for this request
        self.num_clips = 0
        #: the request's video path, stamped by the loader
        self.video: Optional[str] = None
        #: first row of this request's rows in its emission
        self.row0 = 0
        #: the cache outcome: None without a clip cache
        self.cache_hit: Optional[bool] = None
        self.cache_coalesced = False
        self.feature_hit = False
        self.feature_plan = None
        self.feature_insert = None

    def record(self, key: str, at: Optional[float] = None) -> None:
        """Stamp ``key`` with the wall clock (or a given instant)."""
        self.timings[key] = time.time() if at is None else at

    def add_device(self, device_label: str) -> None:
        self.devices.append((device_label,))


class TimeCardList:
    """The cards of one fused dispatch: one event, one instant, stamped
    on every constituent request."""

    def __init__(self, time_cards: List[TimeCard]):
        self.time_cards = time_cards

    def record(self, key: str, at: Optional[float] = None) -> None:
        at = time.time() if at is None else at
        for tc in self.time_cards:
            tc.record(key, at=at)

    def add_device(self, device_label: str) -> None:
        for tc in self.time_cards:
            tc.add_device(device_label)

    def __len__(self) -> int:
        return len(self.time_cards)


def cards_of(time_card) -> List[TimeCard]:
    """The individual cards behind one item (a fused list or a card)."""
    if isinstance(time_card, TimeCardList):
        return list(time_card.time_cards)
    return [time_card]


class TimeCardSummary:
    """Columnar accumulator over one final-step instance's completed
    requests; every card must carry the same event-key sequence."""

    def __init__(self):
        self.summary: "OrderedDict[str, List[float]]" = OrderedDict()
        self.keys: List[str] = []
        self.devices_per_inference: List[List[tuple]] = []
        self.clip_counts: List[int] = []
        self.num_pad_rows = 0
        self.num_pad_tracked = 0
        #: registered cards with a cache_hit stamp, the hits among
        #: them, and the coalesced followers (the `# cache` trailer)
        self.num_cache_hits = 0
        self.num_cache_coalesced = 0
        self.num_cache_tracked = 0

    def register(self, time_card: TimeCard) -> None:
        if not self.summary:
            self.keys = list(time_card.timings.keys())
            for key in self.keys:
                self.summary[key] = []
        if self.keys != list(time_card.timings.keys()):
            raise AssertionError(
                "TimeCard key sequence changed mid-run: %s != %s"
                % (self.keys, list(time_card.timings.keys())))
        for key, ts in time_card.timings.items():
            self.summary[key].append(ts)
        self.devices_per_inference.append(time_card.devices)
        # clips count device work: a coalesced follower's rows were
        # computed once, on its leader's card, so it adds none
        coalesced = getattr(time_card, "cache_coalesced", False)
        self.clip_counts.append(0 if coalesced
                                else int(time_card.num_clips))
        hit = getattr(time_card, "cache_hit", None)
        if hit is not None:
            self.num_cache_tracked += 1
            self.num_cache_hits += int(bool(hit))
        self.num_cache_coalesced += int(bool(coalesced))
        pad = getattr(time_card, "pad_rows", None)
        if pad is not None:
            self.num_pad_tracked += 1
            self.num_pad_rows += int(pad)

    def total_clips(self) -> int:
        return sum(self.clip_counts)

    def num_records(self) -> int:
        return len(self.summary[self.keys[0]]) if self.keys else 0

    def mean_gaps_ms(self, num_skips: int = 0):
        """[(prev_key, next_key, mean_ms)] over records after
        ``num_skips``."""
        import numpy as np
        out = []
        for prv, nxt in zip(self.keys[:-1], self.keys[1:]):
            if len(self.summary[prv]) <= num_skips:
                return out
            gap = np.mean(
                (np.asarray(self.summary[nxt][num_skips:])
                 - np.asarray(self.summary[prv][num_skips:])) * 1000.0)
            out.append((prv, nxt, float(gap)))
        return out

    def latencies_ms(self, num_skips: int = 0) -> List[float]:
        """Per-record end-to-end latency (first event -> last) in ms."""
        import numpy as np
        if len(self.keys) < 2:
            return []
        first = np.asarray(self.summary[self.keys[0]][num_skips:])
        last = np.asarray(self.summary[self.keys[-1]][num_skips:])
        return ((last - first) * 1000.0).tolist()

    def print_summary(self, num_skips: int) -> None:
        gaps = self.mean_gaps_ms(num_skips)
        if not gaps and self.keys:
            print("Not enough log entries (%d records) to print summary!"
                  % self.num_records())
        for prv, nxt, ms in gaps:
            print("Average time between %s and %s: %f ms" % (prv, nxt, ms))

    def padding_line(self) -> Optional[str]:
        if not self.num_pad_tracked:
            return None
        return ("# padding pad_rows=%d num_tracked=%d"
                % (self.num_pad_rows, self.num_pad_tracked))

    def cache_line(self) -> Optional[str]:
        """The ``# cache`` trailer, or None on a cacheless run; written
        even at zero hits (a zero hit rate is a result)."""
        if not self.num_cache_tracked:
            return None
        return ("# cache num_hits=%d num_coalesced=%d num_tracked=%d"
                % (self.num_cache_hits, self.num_cache_coalesced,
                   self.num_cache_tracked))

    def save_full_report(self, fp: IO[str]) -> None:
        num_steps = max((len(d) for d in self.devices_per_inference),
                        default=0)
        fp.write(" ".join(self.keys))
        for step_idx in range(num_steps):
            fp.write(" device%d" % step_idx)
        fp.write("\n")
        for row, devices_per_step in zip(zip(*self.summary.values()),
                                         self.devices_per_inference):
            fp.write(" ".join(map(str, row)))
            for step_idx in range(num_steps):
                step_devices = (devices_per_step[step_idx]
                                if step_idx < len(devices_per_step)
                                else ("-",))
                fp.write(" %s" % step_devices[0])
            fp.write("\n")
        for trailer in (self.cache_line(), self.padding_line()):
            if trailer is not None:
                fp.write(trailer + "\n")

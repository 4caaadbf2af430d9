"""Read a benchmark job's logs back into the numbers ``PERF.md`` keeps.

The port's counterpart of ``scripts/parse_utils.py``, for the files the
port's ``benchmark.py`` writes into ``logs/<job>/``: ``log-meta.txt``,
one timing table per final-step instance and, for a ``--profile`` run
on the card, ``profile.json``::

    python -m rnb_tpu_torch.parse_utils logs/<job> [logs/<job> ...]

prints one JSON object per job: requests, videos/s and clips/s over
the measured window, emissions (fused batches) and the mean runner
service per emission and wait before it, from the timing tables; the
clip cache's hit rate and the page allocator's feature hits and
gathers, from ``Cache:`` and ``Pages:``; and from the profile, device
kernel time and launches, the card's busy share and each kernel
family's share of the kernel time.

It also checks the reference's footings of the ``Pages:`` line
(``scripts/parse_utils.py --check``): pages allocated == freed + live
at teardown, feature hits <= feature lookups, and gathered rows <= the
ragged cache-hit rows they serve. A violation is printed and the exit
code is 1.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List

#: kernel families of a profile, by a substring of the kernel's name;
#: the first family that matches takes the kernel
KERNEL_FAMILIES = (
    ("ingest", ("normalize_u8_kernel", "ragged_normalize_u8_kernel",
                "yuv420_kernel", "dct_unpack_kernel",
                "dct_convert_kernel")),
    ("gather", ("gather_rows_kernel",)),
    ("conv_f32", ("f32f32",)),
    ("conv", ("fprop", "conv")),
    ("elementwise", ("elementwise_kernel",)),
    ("layout", ("nhwcToNchw", "nchwToNhwc", "AddPadding")),
    ("copy", ("Memcpy", "Memset")),
)


def read_meta(path: str) -> dict:
    """``log-meta.txt`` -> args, the window's two wall-clock stamps, the
    in-window kernel launches, the pixel path and decode backend, and
    the ``Key: k=v ...`` lines."""
    meta: dict = {"lines": {}}
    with open(path) as f:
        for line in f.read().splitlines():
            head, _, rest = line.partition(": ")
            if head == "Args":
                meta["args"] = json.loads(rest)
            elif head == "Kernels":
                meta["launches"] = json.loads(rest)
            elif head == "Pages arenas":
                meta["arenas"] = json.loads(rest)
            elif head in ("Pixel path", "Decode backend"):
                meta[head.lower().replace(" ", "_")] = rest
            elif rest and "=" in rest:
                meta["lines"][head] = {
                    k: float(v) for k, v in
                    (kv.split("=", 1) for kv in rest.split())}
            elif not rest and len(line.split()) == 2:
                meta["window"] = tuple(float(t) for t in line.split())
    return meta


def read_table(path: str):
    """One timing table -> (event keys, rows of stamps per request)."""
    with open(path) as f:
        lines = [ln.split() for ln in f.read().splitlines()
                 if ln and not ln.startswith("#")]
    keys = [k for k in lines[0] if not k.startswith("device")]
    rows = [[float(v) for v in ln[:len(keys)]] for ln in lines[1:]]
    return keys, rows


def kernel_families(kernels: Dict[str, dict]) -> Dict[str, float]:
    """Share of device kernel time per family of :data:`KERNEL_FAMILIES`
    (``other`` for the rest)."""
    total = sum(k["device_us"] for k in kernels.values()) or 1.0
    shares: Dict[str, float] = {}
    for name, k in kernels.items():
        family = next((fam for fam, marks in KERNEL_FAMILIES
                       if any(m in name for m in marks)), "other")
        shares[family] = shares.get(family, 0.0) + k["device_us"] / total
    return shares


def footing_problems(meta: dict) -> List[str]:
    """The ``Pages:`` line's footings that do not hold (empty when the
    run had no pager)."""
    pages = meta["lines"].get("Pages")
    if pages is None:
        return []
    problems = []
    if pages["allocs"] != pages["frees"] + pages["live"]:
        problems.append("Pages: allocs=%d != frees=%d + live=%d (a page "
                        "leaked or was freed twice)"
                        % (pages["allocs"], pages["frees"], pages["live"]))
    if pages["feature_hits"] > pages["feature_lookups"]:
        problems.append("Pages: feature_hits=%d > feature_lookups=%d"
                        % (pages["feature_hits"], pages["feature_lookups"]))
    hit_rows = meta["lines"].get("Ragged", {}).get("cache_hit_rows", 0)
    if pages["gather_rows"] > hit_rows:
        problems.append("Pages: gather_rows=%d > Ragged cache_hit_rows=%d "
                        "(gathered rows are cache-hit rows)"
                        % (pages["gather_rows"], hit_rows))
    return problems


def summarize(log_dir: str) -> dict:
    meta = read_meta(os.path.join(log_dir, "log-meta.txt"))
    start, end = meta["window"]
    out = dict(log_dir=log_dir, config=meta["args"]["config"],
               mean_interval_ms=meta["args"]["mean_interval_ms"],
               window_s=end - start, launches=meta.get("launches", {}),
               pixel_path=meta.get("pixel_path"),
               decode_backend=meta.get("decode_backend"))
    requests, service_ms, wait_ms = 0, [], []
    for name in sorted(os.listdir(log_dir)):
        if not name.endswith(".txt") or name in ("log-meta.txt",
                                                 "profile.txt"):
            continue
        keys, rows = read_table(os.path.join(log_dir, name))
        step = max(int(k[len("inference"):-len("_start")]) for k in keys
                   if k.startswith("inference") and k.endswith("_start"))
        col = {k: i for i, k in enumerate(keys)}
        begin = col["inference%d_start" % step]
        finish = col["inference%d_finish" % step]
        emissions = {}
        for row in rows:
            emissions[row[begin]] = row[finish]
            if step > 0:
                wait_ms.append(1e3 * (row[col["runner%d_start" % step]]
                                      - row[col["inference%d_finish"
                                                % (step - 1)]]))
        service_ms.extend(1e3 * (f - s) for s, f in emissions.items())
        requests += len(rows)
    lines = meta["lines"]
    # clip rows served: the final step's own count; in logs written
    # before that line existed, the pools' valid rows or the buckets'
    # shipped rows less their padding
    if "Completed" in lines:
        clips = lines["Completed"]["clips"]
    elif "Ragged" in lines:
        clips = lines["Ragged"]["rows"]
    else:
        clips = (lines["Padding"]["total_rows"]
                 - lines["Padding"]["pad_rows"])
    out.update(requests=requests, videos_per_s=requests / out["window_s"],
               clips_per_s=clips / out["window_s"],
               emissions=len(service_ms),
               runner_service_ms=_mean(service_ms),
               runner_wait_ms=_mean(wait_ms))
    if "Cache" in lines:
        cache = lines["Cache"]
        lookups = cache["hits"] + cache["misses"]
        out.update(cache_hits=int(cache["hits"]),
                   cache_coalesced=int(cache["coalesced"]),
                   cache_hit_rate=cache["hits"] / lookups if lookups
                   else None)
    if "Pages" in lines:
        pages = lines["Pages"]
        out.update({"pages_" + k: int(pages[k]) for k in (
            "gathers", "gather_rows", "feature_lookups", "feature_hits",
            "feature_gathers", "bypassed_batches")})
        out["arenas"] = meta.get("arenas")
    out["footing_problems"] = footing_problems(meta)
    profile = os.path.join(log_dir, "profile.json")
    if os.path.exists(profile):
        with open(profile) as f:
            kernels = json.load(f)["kernels"]
        kernel_ms = sum(k["device_us"] for k in kernels.values()) / 1e3
        # each forward launches its ingest kernels once; a gather serves
        # a hit and runs no forward
        forwards = max((n for k, n in out["launches"].items()
                        if k != "gather_rows"), default=0)
        out.update(kernel_ms=kernel_ms,
                   device_launches=sum(k["count"] for k in kernels.values()),
                   busy_share=kernel_ms / (1e3 * out["window_s"]),
                   kernel_ms_per_emission=(kernel_ms / forwards
                                           if forwards else None),
                   kernel_families=kernel_families(kernels))
    return out


def _mean(values: List[float]):
    return sum(values) / len(values) if values else None


def main(argv=None) -> int:
    log_dirs = sys.argv[1:] if argv is None else argv
    if not log_dirs:
        print(__doc__)
        return 2
    failed = False
    for log_dir in log_dirs:
        stats = summarize(log_dir)
        print(json.dumps(stats))
        for problem in stats["footing_problems"]:
            print("%s: %s" % (log_dir, problem), file=sys.stderr)
            failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

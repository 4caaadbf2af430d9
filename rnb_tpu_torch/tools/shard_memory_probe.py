"""What the shard pair's network stage holds on the card: the one-card
copies of ``configs/rnb-shard-d1.json`` and ``-d2.json`` (every device
index made 0), each stage built as the executor builds it (weights,
eager warm-ups, one CUDA graph captured per signature), and for each:

- ``graph_pool_mib``: what the caching allocator holds in the stage's
  graph pool (a pool keeps its segments while its graphs live, so this
  is the captures' peak);
- ``peak_mib``: the most memory allocated while the stage was built,
  over what was allocated before;
- ``params_mib``: the network's parameters and buffers.

Run on the machine with the card, from the root of a checkout:

    python3 rnb_tpu_torch/tools/shard_memory_probe.py

It measures the ``rnb_tpu_torch`` package of the directory it is run
from, so another checkout (the parent commit unpacked with ``git
archive``) is measured by running this file from that checkout's root.
Prints one JSON line a copy and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile


def one_card_copy(config: str, out_dir: str) -> str:
    """``config`` with every device index >= 0 made 0, written into
    ``out_dir``."""
    with open(config) as f:
        raw = json.load(f)
    for step in raw["pipeline"]:
        for group in step["queue_groups"]:
            group["devices"] = [0 if d >= 0 else d for d in group["devices"]]
    path = os.path.join(out_dir, os.path.basename(config))
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch
    from rnb_tpu_torch.config import load_config
    from rnb_tpu_torch.utils.class_utils import load_class
    if not torch.cuda.is_available():
        print("shard_memory_probe: no CUDA device is available",
              file=sys.stderr)
        return 1
    mib = float(1 << 20)
    with tempfile.TemporaryDirectory() as out_dir:
        for name in ("rnb-shard-d1", "rnb-shard-d2"):
            config = load_config(one_card_copy(
                os.path.join("configs", name + ".json"), out_dir))
            step = config.steps[1]
            kwargs = dict(step.kwargs_for_group(0), ragged=True,
                          ragged_pool_rows=config.ragged["pool_rows"])
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            runner = load_class(step.model)(step.groups[0].devices[0],
                                            **kwargs)
            torch.cuda.synchronize()
            pool = tuple(runner._graph_pool)
            held = sum(seg["total_size"]
                       for seg in torch.cuda.memory_snapshot()
                       if tuple(seg.get("segment_pool_id", ())) == pool)
            tensors = list(runner.network.parameters()) + list(
                runner.network.buffers())
            print(json.dumps({
                "config": name, "package": os.getcwd(),
                "degree": runner.shard_degree,
                "graphs": runner.graph_stats["graphs"],
                "graph_pool_mib": held / mib,
                "peak_mib": (torch.cuda.max_memory_allocated() - before)
                / mib,
                "params_mib": sum(t.numel() * t.element_size()
                                  for t in tensors) / mib}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

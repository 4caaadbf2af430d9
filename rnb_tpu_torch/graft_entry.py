"""Entry points of the port's multi-device paths, on one H100.

Counterpart of ``__graft_entry__.py`` at the repo root (the JAX
package's check of its flagship forward and its multi-chip paths):

* :func:`entry` -- the flagship forward step: R(2+1)D-18 over layers
  [1..5] and the 400-class head in bf16, over a max-shape batch of 15
  clips of 8 x 112 x 112 (NDHWC, the port's layout), what the
  benchmark's network stage runs;
* :func:`dryrun_multichip` -- the reference's three multi-device parts
  at its tiny widths: a :class:`ShardedInference` over an ``n``-member
  dp x sp mesh; for ``n >= 2`` layers [1..4] and [5..5] on two
  consecutive sub-meshes, the activations handed from one to the other
  by ``reshard``; for ``n >= 4`` a ``run_benchmark`` of the tiny loader
  -> ``R2P1DMeshRunner`` yuv420 pipeline.

One departure: the reference forces ``n`` virtual CPU devices, while
the port puts its ``n`` members on one device (a mesh's members may
repeat one; a mesh over distinct cards is not yet ported). On a card
they all share it. Both run on the card unless the caller passes
``device="cpu"``; without a card they raise.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from rnb_tpu_torch.models.r2p1d import checkpoint as ckpt
from rnb_tpu_torch.models.r2p1d.network import (KINETICS_CLASSES,
                                                NUM_LAYERS, R18_LAYER_SIZES)
from rnb_tpu_torch.ops.handoff_dma import reshard
from rnb_tpu_torch.parallel.mesh import (NamedSharding, Ring, build_mesh,
                                         submeshes)
from rnb_tpu_torch.parallel.sharded import ShardedInference
from rnb_tpu_torch.parallel.shardplan import make_sharded_apply

TINY = dict(frames=4, hw=32, classes=16, layer_sizes=(1, 1, 1, 1))
#: the flagship batch: max_clips clips of 8 frames, NDHWC
FLAGSHIP_SHAPE = (15, 8, 112, 112, 3)


def _device(device) -> torch.device:
    """``device``, or the first card; raises without one."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


def _network(start: int, end: int, device: torch.device,
             num_classes: int, layer_sizes) -> torch.nn.Module:
    """The [start..end] range on the seeded weights, bf16, on
    ``device``."""
    return make_sharded_apply(start, end, num_classes, tuple(layer_sizes),
                              Ring([device]))(ckpt.load_or_init(
                                  start, end, num_classes, layer_sizes))


def entry(device=None) -> Tuple[Callable[[torch.Tensor], torch.Tensor],
                                Tuple[torch.Tensor]]:
    """-> ``(forward, example_args)`` for the flagship forward step:
    ``forward(*example_args)`` gives the (15, 400) float32 logits."""
    device = _device(device)
    network = _network(1, NUM_LAYERS, device, KINETICS_CLASSES,
                       R18_LAYER_SIZES)

    @torch.inference_mode()
    def forward(x: torch.Tensor) -> torch.Tensor:
        return network(x)

    x = torch.zeros(FLAGSHIP_SHAPE, dtype=torch.bfloat16, device=device)
    return forward, (x,)


def _pipeline_config(device: torch.device, mesh_n: int) -> dict:
    """The reference's tiny loader -> dp x sp mesh-stage job, with the
    port's class paths and every device index ``device``'s."""
    index = device.index or 0
    return {
        "video_path_iterator":
            "rnb_tpu_torch.models.r2p1d.model.R2P1DVideoPathIterator",
        "pipeline": [
            {"model": "rnb_tpu_torch.models.r2p1d.model.R2P1DLoader",
             "queue_groups": [{"devices": [index], "out_queues": [0]}],
             "num_shared_tensors": 8, "raw_output": True,
             # the flagship pixel path: packed 4:2:0 planes on the wire,
             # fused ingest inside the sharded step
             "pixel_path": "yuv420",
             "max_clips": 2,
             "consecutive_frames": TINY["frames"],
             "num_clips_population": [1, 2], "weights": [3, 1],
             "num_warmups": 1},
            {"model": "rnb_tpu_torch.models.r2p1d.model.R2P1DMeshRunner",
             "queue_groups": [{"devices": [index], "in_queue": 0}],
             "mesh_devices": [index] * mesh_n, "dp": 2,
             "sync_preds": False,
             "pixel_path": "yuv420",
             "max_clips": 2,
             "consecutive_frames": TINY["frames"],
             "num_classes": TINY["classes"],
             "layer_sizes": list(TINY["layer_sizes"]),
             "num_warmups": 1},
        ],
    }


def _pipeline_run(device: torch.device, mesh_n: int, log_base: str):
    """Serve 7 requests of the tiny mesh pipeline in bulk; raise unless
    the run reached its target."""
    from rnb_tpu_torch.benchmark import run_benchmark
    from rnb_tpu_torch.control import TerminationFlag
    cfg_path = os.path.join(log_base, "mesh-tiny.json")
    os.makedirs(log_base, exist_ok=True)
    with open(cfg_path, "w") as f:
        json.dump(_pipeline_config(device, mesh_n), f)
    res = run_benchmark(cfg_path, mean_interval_ms=0, num_videos=7,
                        log_base=os.path.join(log_base, "logs"),
                        print_progress=False,
                        platform="cpu" if device.type == "cpu" else None)
    if res.termination_flag != TerminationFlag.TARGET_NUM_VIDEOS_REACHED:
        raise RuntimeError("dryrun pipeline run ended with termination "
                           "flag %d" % res.termination_flag)
    return res


def dryrun_multichip(n_devices: int, device=None,
                     log_base: Optional[str] = None) -> dict:
    """Run the sharded and pipelined paths over ``n_devices`` mesh
    members on ``device`` at tiny widths, print the reference's ``ok``
    lines, and return ``{"dp", "sp", "pp", "pipeline_vps"}`` (the
    pipeline run's videos/s, ``None`` below 4 members). The pipeline
    run's config and job directory go under ``log_base`` (a temporary
    directory, removed after, by default)."""
    device = _device(device)
    devices = [device] * int(n_devices)

    # --- 1. dp x sp sharded step: split, compute, the members' sums added
    mesh = build_mesh(devices, axis_names=("dp", "sp"))
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    si = ShardedInference(mesh, max_clips=sp,
                          consecutive_frames=TINY["frames"],
                          frame_hw=TINY["hw"], num_classes=TINY["classes"],
                          layer_sizes=TINY["layer_sizes"])
    rng = np.random.default_rng(0)
    videos = rng.integers(0, 256, si.batch_shape(dp), dtype=np.uint8)
    preds = si.predict(videos, [sp] * dp)
    if preds.shape != (dp,):
        raise RuntimeError("dryrun sharded step: predictions of shape %s "
                           "for %d videos" % (preds.shape, dp))

    # --- 2. pipeline parallel: layer ranges [1..4] and [5..5] on
    # consecutive sub-meshes, the activations resharded between them
    if n_devices >= 2:
        size_a = (n_devices + 1) // 2
        size_b = n_devices - size_a
        mesh_a, mesh_b = submeshes(devices, [size_a, size_b],
                                   [{"dp": size_a}, {"dp": size_b}])
        rows = size_a * size_b
        stage_a = _network(1, 4, mesh_a.device, TINY["classes"],
                           TINY["layer_sizes"])
        stage_b = _network(5, 5, mesh_b.device, TINY["classes"],
                           TINY["layer_sizes"])
        x = torch.zeros((rows, TINY["frames"], TINY["hw"], TINY["hw"], 3),
                        dtype=torch.bfloat16, device=mesh_a.device)
        with torch.inference_mode():
            acts = stage_a(x)
            acts_b = reshard(acts, NamedSharding.of(mesh_b, ("dp",)),
                             source=NamedSharding.of(mesh_a, ("dp",)))
            logits = stage_b(acts_b)
        if logits.shape != (rows, TINY["classes"]) \
                or not bool(torch.isfinite(logits).all()):
            raise RuntimeError("dryrun pipeline parallel: logits of shape "
                               "%s" % (tuple(logits.shape),))

    # --- 3. the pipelined runtime itself: client -> loader(raw) -> dp x sp
    # R2P1DMeshRunner through run_benchmark
    pipeline_vps = None
    if n_devices >= 4:
        mesh_n = 4 * (n_devices // 4)
        if log_base is None:
            with tempfile.TemporaryDirectory(prefix="rnb_dryrun_") as tmp:
                res = _pipeline_run(device, mesh_n, tmp)
        else:
            res = _pipeline_run(device, mesh_n, log_base)
        pipeline_vps = res.throughput_vps
        print("dryrun pipeline-run: ok (videos=%d over dp=2 x sp=%d mesh, "
              "%.2f videos/s on %s)"
              % (res.num_videos, mesh_n // 2, pipeline_vps, device))

    print("dryrun_multichip(%d): ok (dp=%d, sp=%d, pp=%s, pipeline=%s)"
          % (n_devices, dp, sp, n_devices >= 2, pipeline_vps is not None))
    return {"dp": dp, "sp": sp, "pp": n_devices >= 2,
            "pipeline_vps": pipeline_vps}

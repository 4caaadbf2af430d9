"""Intra-stage sharding: one R(2+1)D stage over a ring of members.

Counterpart of ``rnb_tpu/parallel/shardplan.py``, over the port's
``state_dict`` names. What is sharded, and why the result is bitwise
the unsharded stage's, is the reference's design:

* every **temporal** conv kernel (``...temporal.weight``) and the head's
  weight and bias (``linear.weight``, ``linear.bias``) live sharded at
  rest on the torch out-channel axis, dim 0 — each member holds
  ``1/degree`` of their rows — and are ring-all-gathered to full width
  right before their op (:mod:`rnb_tpu_torch.ops.handoff_dma`). The op
  then runs at full width, so the activation path is op for op the
  unsharded one: a gather is pure data movement.
* the spatial convs, BatchNorms, shortcuts and pooling stay replicated.
  Compute is not divided: sharding here buys per-member memory.

A head stage keeps each member's column block of the logits, and the
one merge gather (:func:`make_merge`) is a separate call the stage
times on the host as ``exec{i}.collective``.

The port's members share one device (:class:`rnb_tpu_torch.parallel.
mesh.Ring`), so one forward a card serves them all: every member's
gathered weight is bitwise the same, and the whole ring collective
still runs, every hop moving every member's buffer.

The HBM projection counts the bytes the port keeps at rest (bfloat16
conv and head weights, float32 BatchNorm); the formula functions are
the reference's.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from rnb_tpu_torch.models.r2p1d.network import (LAYER_FEATURES, NUM_LAYERS,
                                                R2Plus1DClassifier,
                                                cast_compute_weights)
from rnb_tpu_torch.ops.handoff_dma import ring_all_gather
from rnb_tpu_torch.parallel.mesh import Ring

#: the per-member name of a sharded leaf: ``<leaf>_shards.<member>``
SHARD_SUFFIX = "_shards"


def _leaf_name(name: str) -> str:
    """A member shard's name (``linear.weight_shards.1``) as its
    unsharded leaf's (``linear.weight``); other names as they are."""
    head, _, member = name.rpartition(".")
    if member.isdigit() and head.endswith(SHARD_SUFFIX):
        return head[:-len(SHARD_SUFFIX)]
    return name


def is_sharded_param(name: str) -> bool:
    """Is the ``state_dict`` entry ``name`` partitioned on its
    out-channel axis? Exactly the temporal conv kernels and the head's
    weight and bias (or one member's shard of them)."""
    parts = _leaf_name(str(name)).split(".")
    if len(parts) < 2:
        return False
    return (parts[-2] == "temporal" and parts[-1] == "weight") or (
        parts[-2] == "linear" and parts[-1] in ("weight", "bias"))


def split_param_bytes(state_dict: Dict[str, torch.Tensor]
                      ) -> Tuple[int, int]:
    """(replicated_bytes, sharded_bytes) of one stage's ``state_dict``:
    replicated bytes land whole on every member, sharded bytes divide by
    the degree. ``meta`` tensors count too: the projection never needs
    materialized weights."""
    replicated = sharded = 0
    for name, value in state_dict.items():
        nbytes = value.numel() * value.element_size()
        if is_sharded_param(name):
            sharded += nbytes
        else:
            replicated += nbytes
    return replicated, sharded


def projected_device_mb(replicated_bytes: int, sharded_bytes: int,
                        pool_bytes: int, degree: int) -> float:
    """Per-member HBM projection (MiB) at ``degree``: the number the
    launch gate uses."""
    degree = max(1, int(degree))
    return (float(replicated_bytes) + float(sharded_bytes) / degree
            + float(pool_bytes)) / (1 << 20)


def min_feasible_degree(replicated_bytes: int, sharded_bytes: int,
                        pool_bytes: int, budget_mb: float,
                        candidates: Sequence[int] = (1, 2, 4, 8)
                        ) -> Optional[int]:
    """The smallest candidate degree whose projection fits the budget,
    or None when even the largest does not (the replicated half alone
    can exceed a small budget)."""
    for degree in sorted(int(d) for d in candidates):
        if projected_device_mb(replicated_bytes, sharded_bytes,
                               pool_bytes, degree) <= float(budget_mb):
            return degree
    return None


def shardable_widths(start: int, end: int, num_classes: int) -> List[int]:
    """The out-channel widths sharding slices for a [start..end] stage:
    every temporal conv's feature count, plus the head when the range
    ends the network. The degree must divide all of them."""
    widths: List[int] = []
    for layer in range(int(start), int(end) + 1):
        widths.append(64 if layer == 1 else LAYER_FEATURES[layer])
    if int(end) == NUM_LAYERS:
        widths.append(int(num_classes))
    return widths


def validate_degree(degree: int, start: int, end: int,
                    num_classes: int) -> None:
    """Raise ValueError unless ``degree`` divides every width
    :func:`shardable_widths` declares for the range."""
    degree = int(degree)
    if degree < 1:
        raise ValueError("shard degree must be >= 1, got %d" % degree)
    for width in shardable_widths(start, end, num_classes):
        if width % degree:
            raise ValueError(
                "shard degree %d does not divide the declared channel "
                "width %d of layers [%d..%d] (num_classes=%d)"
                % (degree, width, start, end, num_classes))


def build_shard_ring(devices: Sequence, degree: int,
                     axis_name: str = "tp") -> Ring:
    """One lane's shard ring: exactly ``degree`` resolved devices."""
    devices = list(devices)
    if len(devices) != int(degree):
        raise ValueError(
            "shard mesh wants exactly degree=%d devices, got %d"
            % (degree, len(devices)))
    return Ring(devices, axis_name)


def shard_variables(state_dict: Dict[str, torch.Tensor],
                    degree: int) -> Dict[str, torch.Tensor]:
    """The sharded network's ``state_dict``: every sharded leaf split
    into ``degree`` member shards on dim 0, ``<leaf>_shards.<member>``;
    the other leaves as they are (replicated)."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in state_dict.items():
        if not is_sharded_param(name) or degree == 1:
            out[name] = value
            continue
        if value.shape[0] % degree:
            raise ValueError("shard degree %d does not divide %s's %d "
                             "rows" % (degree, name, value.shape[0]))
        for member, shard in enumerate(torch.chunk(value, degree, dim=0)):
            out["%s%s.%d" % (name, SHARD_SUFFIX, member)] = shard
    return out


def make_sharded_apply(start: int, end: int, num_classes: int,
                       layer_sizes: tuple, ring: Ring,
                       factored_shortcut: bool = False,
                       dtype: torch.dtype = torch.bfloat16
                       ) -> Callable[[Dict[str, torch.Tensor]],
                                     torch.nn.Module]:
    """The sharded twin of the unsharded network: returns
    ``applier_for(state_dict)``, which builds the [start..end] network
    with its sharded leaves split over the ring from the unsharded
    float32 ``state_dict``, cast to ``dtype`` and placed on the ring's
    device. Called on the ingest's output, a head range returns its
    logits as ``degree`` float32 column blocks (merge them with
    :func:`make_merge`); a mid-pipeline range returns the full feature
    map (its last temporal gather reassembled it)."""
    degree = ring.degree
    validate_degree(degree, start, end, num_classes)

    def applier_for(state_dict: Dict[str, torch.Tensor]) -> torch.nn.Module:
        net = R2Plus1DClassifier(start, end, num_classes, layer_sizes,
                                 factored_shortcut, dtype=dtype,
                                 shards=degree)
        net.load_state_dict(shard_variables(state_dict, degree))
        return cast_compute_weights(net).to(ring.device).eval()

    return applier_for


def make_merge(ring: Ring) -> Callable[[List[torch.Tensor]],
                                       torch.Tensor]:
    """The head stage's one merge collective: the members' column
    blocks of the logits -> the full-width logits, by the ring
    all-gather along the class axis. A call of its own, apart from the
    forward, so the stage times it as ``exec{i}.collective``."""
    def merge(blocks: List[torch.Tensor]) -> torch.Tensor:
        return ring_all_gather(blocks, ring, axis=-1)[0]
    return merge

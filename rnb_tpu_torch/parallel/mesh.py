"""Meshes and rings: the member devices one parallel stage runs over.

Counterpart of the part of ``rnb_tpu/parallel/mesh.py`` the port's
stages use. Parallel stages name *axes* (``dp`` -- data/video
replication, ``sp`` -- clip sharding, ``tp`` -- a shard ring): a
:class:`Mesh` is a grid of ``torch.device`` s with named axes (the
port's ``jax.sharding.Mesh``, built by the mesh stage), a :class:`Ring`
a shard ring's one axis of members, in ring order, and
:func:`carve_replicas` the replica expansion's placement rule
(``rnb_tpu_torch.config``).

Members may repeat a device, which a ``jax.sharding.Mesh`` cannot: on
the CPU every config device maps to the CPU, and a one-card copy of a
multi-device config puts every member on the card. A mesh or a ring
whose members sit on two or more distinct devices raises: a ring hop
between cards (peer access, NVLink stores) and a mesh's reduce over
cards (NCCL) are not yet ported (ROADMAP.md, queue 1 item 4).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

#: the most members a ring carries (the reference's largest degree
#: candidate, rnb_tpu/parallel/shardplan.py min_feasible_degree)
MAX_MEMBERS = 8


def _one_device(devices: Sequence[torch.device], what: str,
                across: str) -> None:
    """Raise unless every member of ``devices`` is one device."""
    distinct = sorted({str(d) for d in devices})
    if len(distinct) > 1:
        raise NotImplementedError(
            "%s over %d distinct devices (%s) is not yet ported to "
            "rnb_tpu_torch: its members must share one device; %s "
            "(ROADMAP.md, queue 1 item 4)"
            % (what, len(distinct), ", ".join(distinct), across))


class Mesh:
    """A grid of member devices with named axes: ``devices`` is an
    object array of ``torch.device`` s shaped by the axes, ``shape``
    maps each axis name to its size. Every member lies on one device."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.array(devices, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(grid[idx])
        self.axis_names = tuple(str(a) for a in axis_names)
        if grid.ndim != len(self.axis_names) or grid.size < 1:
            raise ValueError("a mesh of shape %r cannot carry axes %r"
                             % (grid.shape, self.axis_names))
        self.devices = grid
        self.shape = dict(zip(self.axis_names, grid.shape))
        _one_device(list(grid.flat), "a mesh",
                    "a mesh across cards waits for the NCCL reduce")

    @property
    def device(self) -> torch.device:
        """The one device every member lives on."""
        return self.devices.flat[0]

    def __repr__(self):
        return "Mesh(%r, axis_names=%r)" % (self.shape, self.axis_names)


def carve_replicas(devices: Sequence, replicas: int) -> list:
    """Carve a step's device list into ``replicas`` disjoint equal
    slices, in order (the reference's rule): replica i owns
    ``devices[i*k:(i+1)*k]`` with ``k = len(devices) // replicas``. Works
    on raw config indices or resolved devices alike, repeated indices
    included (a one-card copy lists device 0 four times)."""
    devices = list(devices)
    replicas = int(replicas)
    if replicas < 1:
        raise ValueError("need at least one replica, got %d" % replicas)
    if not devices or len(devices) % replicas:
        raise ValueError(
            "%d device(s) cannot split into %d equal replica sub-meshes"
            % (len(devices), replicas))
    chunk = len(devices) // replicas
    return [devices[i * chunk:(i + 1) * chunk] for i in range(replicas)]


class Ring:
    """``degree`` member devices in ring order (member ``i`` hands its
    buffer to member ``i + 1``), all one device."""

    def __init__(self, devices: Sequence, axis_name: str = "tp"):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_name = str(axis_name)
        if not 1 <= len(self.devices) <= MAX_MEMBERS:
            raise ValueError("a shard ring has 1 to %d members, got %d"
                             % (MAX_MEMBERS, len(self.devices)))
        _one_device(self.devices, "a shard ring",
                    "rings across cards wait for peer access")

    @property
    def degree(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every member lives on."""
        return self.devices[0]

    def check(self, members: Sequence[torch.Tensor], what: str) -> None:
        """Raise unless ``members`` holds one tensor per member, each on
        its member's device."""
        if len(members) != self.degree:
            raise ValueError("%s: %d tensors for a ring of %d members"
                             % (what, len(members), self.degree))
        for i, t in enumerate(members):
            if t.device != self.devices[i]:
                raise ValueError("%s: member %d's tensor lies on %s, the "
                                 "ring's member on %s"
                                 % (what, i, t.device, self.devices[i]))

    def __repr__(self):
        return "Ring(%r, axis_name=%r)" % ([str(d) for d in self.devices],
                                           self.axis_name)


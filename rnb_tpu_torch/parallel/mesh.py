"""The shard ring: the member devices one sharded stage runs over.

Counterpart of the part of ``rnb_tpu/parallel/mesh.py`` a shard ring
needs. The reference builds a one-axis ``jax.sharding.Mesh`` of
``degree`` distinct devices; the port's sharded value is a list of
``degree`` per-member tensors, and a :class:`Ring` says which device
each member lives on, in ring order.

Members may repeat a device, which a ``Mesh`` cannot: on the CPU every
config device maps to the CPU, and a one-card copy of a multi-device
config puts every member on the card. A ring whose members sit on two
or more distinct devices raises: a hop between cards (peer access,
NVLink stores) is not yet ported (ROADMAP.md, queue 1 item 5).

:func:`carve_replicas` is the replica expansion's placement rule
(``rnb_tpu_torch.config``). ``MeshSpec``, ``factor_devices`` and
``submeshes`` wait for the mesh runner.
"""

from __future__ import annotations

from typing import Sequence

import torch

#: the most members a ring carries (the reference's largest degree
#: candidate, rnb_tpu/parallel/shardplan.py min_feasible_degree)
MAX_MEMBERS = 8


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
        distinct = sorted({str(d) for d in self.devices})
        if len(distinct) > 1:
            raise NotImplementedError(
                "a shard ring over %d distinct devices (%s) is not yet "
                "ported to rnb_tpu_torch: its members must share one "
                "device; rings across cards wait for peer access "
                "(ROADMAP.md, queue 1 item 5)"
                % (len(distinct), ", ".join(distinct)))

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


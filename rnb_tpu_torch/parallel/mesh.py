"""Meshes and rings: the member devices one parallel stage runs over.

Counterpart of ``rnb_tpu/parallel/mesh.py``. Parallel stages name
*axes* (``dp`` -- data/video replication, ``sp`` -- clip sharding,
``tp`` -- a shard ring): a :class:`Mesh` is a grid of ``torch.device`` s
with named axes (the port's ``jax.sharding.Mesh``), a :class:`Ring` a
shard ring's one axis of members, in ring order, and a
:class:`NamedSharding` a mesh's members plus a spec (where a value's
pieces lie). The reference's helpers build them: :class:`MeshSpec` (an
axis request, ``-1`` once for "the rest"), :func:`factor_devices` (a
device count split over axis names), :func:`build_mesh` and
:func:`submeshes` (consecutive members carved into stage meshes), and
:func:`carve_replicas` is the replica expansion's placement rule
(``rnb_tpu_torch.config``).

Members may repeat a device, which a ``jax.sharding.Mesh`` cannot: on
the CPU every config device maps to the CPU, and one card hosts a mesh
of any size when its member list names the card that many times
(``[torch.device("cuda", 0)] * 8``). A mesh or a ring whose members sit
on two or more distinct devices raises: a ring hop between cards (peer
access, NVLink stores) and a mesh's reduce over cards (NCCL) are not
yet ported (ROADMAP.md, queue 1 item 5). A :class:`NamedSharding` may
name distinct cards: it only describes a placement.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

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
            "(ROADMAP.md, queue 1 item 5)"
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


class MeshSpec:
    """A declarative mesh request: ordered {axis_name: size}.

    Size ``-1`` on at most one axis means "whatever is left" after the
    explicit axes divide the device count (mirrors reshape's -1).
    """

    def __init__(self, axes: Dict[str, int]):
        if not axes:
            raise ValueError("MeshSpec needs at least one axis")
        wildcards = [a for a, s in axes.items() if s == -1]
        if len(wildcards) > 1:
            raise ValueError("at most one mesh axis may be -1, got %r"
                             % (axes,))
        for a, s in axes.items():
            if s != -1 and s < 1:
                raise ValueError("mesh axis %r has invalid size %d" % (a, s))
        self.axes = dict(axes)

    def resolve(self, num_devices: int) -> Dict[str, int]:
        """Concrete axis sizes for ``num_devices`` devices."""
        sizes = dict(self.axes)
        explicit = 1
        wildcard = None
        for a, s in sizes.items():
            if s == -1:
                wildcard = a
            else:
                explicit *= s
        if wildcard is not None:
            if num_devices % explicit != 0:
                raise ValueError(
                    "cannot fill axis %r: %d devices not divisible by %d"
                    % (wildcard, num_devices, explicit))
            sizes[wildcard] = num_devices // explicit
        elif explicit != num_devices:
            raise ValueError(
                "mesh %r wants %d devices but group has %d"
                % (self.axes, explicit, num_devices))
        return sizes

    def __repr__(self):
        return "MeshSpec(%r)" % (self.axes,)


def factor_devices(num_devices: int,
                   axis_names: Sequence[str]) -> Dict[str, int]:
    """Factor ``num_devices`` across ``axis_names`` as evenly as
    possible, larger factors on the *earlier* axes: 8 over ("dp", "sp")
    -> {dp: 4, sp: 2}; over ("pp", "dp", "sp") -> {pp: 2, dp: 2, sp: 2};
    a prime count puts everything on the first axis."""
    if num_devices < 1:
        raise ValueError("need at least one device")
    names = list(axis_names)
    sizes = {a: 1 for a in names}
    factors: List[int] = []
    n = int(num_devices)
    p = 2
    while p * p <= n:
        while n % p == 0:
            factors.append(p)
            n //= p
        p += 1
    if n > 1:
        factors.append(n)
    # LPT greedy: each prime factor, largest first, onto the currently
    # smallest axis keeps the split as even as the factorization allows
    for f in sorted(factors, reverse=True):
        smallest = min(range(len(names)), key=lambda i: sizes[names[i]])
        sizes[names[smallest]] *= f
    ordered = sorted((sizes[a] for a in names), reverse=True)
    return dict(zip(names, ordered))


def visible_devices() -> List[torch.device]:
    """Every CUDA card this process sees, in index order (none on a
    machine without one)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(devices: Optional[Sequence] = None,
               axes: Optional[Dict[str, int]] = None,
               axis_names: Sequence[str] = ("dp", "sp")) -> Mesh:
    """A :class:`Mesh` over ``devices`` (default: every visible card).
    ``axes`` gives explicit {name: size} (``-1`` allowed once); without
    it the member count is factored over ``axis_names``. Members may
    repeat a device: ``[torch.device("cuda", 0)] * 8`` is a mesh of
    eight members on one card."""
    devices = visible_devices() if devices is None else list(devices)
    if axes is not None:
        sizes = MeshSpec(axes).resolve(len(devices))
    else:
        sizes = factor_devices(len(devices), axis_names)
    names = tuple(sizes.keys())
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid.reshape(tuple(sizes[a] for a in names)), names)


def submeshes(devices: Sequence, stage_sizes: Sequence[int],
              axes_per_stage: Optional[Sequence[Optional[Dict[str, int]]]]
              = None) -> List[Mesh]:
    """Carve ``devices`` into consecutive sub-meshes: ``stage_sizes[i]``
    members go to stage i (the pipeline-parallel split, each stage on
    its own members), each built by :func:`build_mesh` with its entry of
    ``axes_per_stage``."""
    devices = list(devices)
    if sum(stage_sizes) > len(devices):
        raise ValueError("stage sizes %r exceed %d devices"
                         % (list(stage_sizes), len(devices)))
    if axes_per_stage is None:
        axes_per_stage = [None] * len(stage_sizes)
    out = []
    cursor = 0
    for size, axes in zip(stage_sizes, axes_per_stage):
        out.append(build_mesh(devices[cursor:cursor + size], axes=axes))
        cursor += size
    return out


class NamedSharding(NamedTuple):
    """Where a value's pieces lie (the port's ``NamedSharding``): a
    mesh's members in row-major order, its axis names and sizes, and a
    ``spec`` naming the mesh axis each leading dim of the value is split
    over (``()`` for a replicated value). It describes a placement, so,
    unlike :class:`Mesh`, it may name distinct cards."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    spec: Tuple[Optional[str], ...] = ()

    @classmethod
    def of(cls, mesh: Mesh, spec: Sequence[Optional[str]] = ()
           ) -> "NamedSharding":
        """The sharding ``spec`` over ``mesh``'s members."""
        return cls(tuple(mesh.devices.flat), mesh.axis_names,
                   tuple(mesh.devices.shape), tuple(spec))

    @property
    def device(self) -> torch.device:
        """The one device every member lives on; raises for members on
        distinct devices, as :class:`Mesh` does."""
        _one_device(self.devices, "a sharding",
                    "a value across cards waits for the NCCL reduce")
        return self.devices[0]


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


"""Meshes and rings: the member devices one parallel stage runs over.

Counterpart of ``rnb_tpu/parallel/mesh.py``. Parallel stages name
*axes* (``dp`` -- data/video replication, ``sp`` -- clip sharding,
``tp`` -- a shard ring): a :class:`Mesh` is a grid of members with named
axes (the port's ``jax.sharding.Mesh``), a :class:`Ring` a shard ring's
one axis of members, in ring order, and a :class:`NamedSharding` a
mesh's members plus a spec (where a value's pieces lie). The reference's
helpers build them: :class:`MeshSpec` (an axis request, ``-1`` once for
"the rest"), :func:`factor_devices` (a device count split over axis
names), :func:`build_mesh` and :func:`submeshes` (consecutive members
carved into stage meshes), and :func:`carve_replicas` is the replica
expansion's placement rule (``rnb_tpu_torch.config``).

A member is a (process, device) pair, a :class:`Member`; a bare device
names a member of the process that builds the mesh or ring. So a mesh,
a ring and a sharding may span the processes of a launch
(``rnb_tpu_torch.parallel.distributed``), as a multi-controller JAX
program's mesh spans hosts, each process acting on its own members
(``local``, ``device``). A mesh or a ring finds this process's members
once, when it is built: one built in a launch is built after joining
it (``distributed.maybe_initialize``). Members may repeat a device, which a
``jax.sharding.Mesh`` cannot: on the CPU every config device maps to the
CPU, and one card hosts a mesh of any size when its member list names
the card that many times (``[torch.device("cuda", 0)] * 8``). Within one
process every member lies on one device: a mesh or a ring whose members
in one process sit on two or more distinct cards raises, since a ring
hop between cards of one process (peer access) and a mesh's reduce over
cards (NCCL) are not yet ported (ROADMAP.md, queue 1 item 5). A ring
that spans processes holds one member a process; its hop goes through
the peers' memory (``rnb_tpu_torch/parallel/peers.py``). A
:class:`NamedSharding` may name distinct cards: it only describes a
placement.
"""

from __future__ import annotations

from typing import (Dict, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

#: the most members a ring carries (the reference's largest degree
#: candidate, rnb_tpu/parallel/shardplan.py min_feasible_degree)
MAX_MEMBERS = 8


class Member(NamedTuple):
    """One member of a mesh or a ring: the process that acts on it and
    the device it lies on."""
    process: int
    device: torch.device


def this_process() -> int:
    """The index of this process in its launch (0 in one process)."""
    from rnb_tpu_torch.parallel import distributed
    return distributed.process_index()


def _members(items, me: int) -> Tuple[list, List[int]]:
    """(devices, processes) of ``items``, each a :class:`Member` or a
    device of process ``me``."""
    devices, owners = [], []
    for item in items:
        if isinstance(item, Member):
            devices.append(torch.device(item.device))
            owners.append(int(item.process))
        else:
            devices.append(torch.device(item))
            owners.append(me)
    return devices, owners


def _one_device(devices: Sequence[torch.device], what: str,
                across: str, processes: Optional[Sequence[int]] = None
                ) -> None:
    """Raise unless the members of each process lie on one device."""
    if processes is None:
        processes = [0] * len(devices)
    for process in sorted(set(processes)):
        distinct = sorted({str(d) for d, p in zip(devices, processes)
                           if p == process})
        if len(distinct) > 1:
            raise NotImplementedError(
                "%s over %d distinct devices (%s) is not yet ported to "
                "rnb_tpu_torch: the members of one process must share one "
                "device; %s (ROADMAP.md, queue 1 item 5)"
                % (what, len(distinct), ", ".join(distinct), across))


def _local_device(devices: Sequence[torch.device],
                  processes: Sequence[int], me: int, what: str
                  ) -> Union[torch.device, str]:
    """The device of process ``me``'s members (one, as checked), or
    why there is none."""
    for d, p in zip(devices, processes):
        if p == me:
            return d
    return ("%s has no member in process %d (its members lie in processes "
            "%s)" % (what, me, sorted(set(processes))))


def _device_or_raise(found: Union[torch.device, str]) -> torch.device:
    """What :func:`_local_device` found, or raise why there is none."""
    if isinstance(found, str):
        raise ValueError(found)
    return found


class Mesh:
    """A grid of members with named axes: ``devices`` is an object array
    of ``torch.device`` s shaped by the axes, ``processes`` an int array
    of the same shape (the process of each member), ``shape`` maps each
    axis name to its size. ``devices`` may hold :class:`Member` s in
    place of devices (an object array, as :func:`build_mesh` makes); a
    bare device is a member of this process. The members of each process
    lie on one device."""

    def __init__(self, devices, axis_names: Sequence[str]):
        if isinstance(devices, np.ndarray):
            grid = devices.copy()
        else:
            grid = np.array(devices, dtype=object)
        me = this_process()
        flat, owners = _members(grid.flat, me)
        grid = np.empty(grid.shape, dtype=object)
        for i, d in enumerate(flat):
            grid.flat[i] = d
        self.axis_names = tuple(str(a) for a in axis_names)
        if grid.ndim != len(self.axis_names) or grid.size < 1:
            raise ValueError("a mesh of shape %r cannot carry axes %r"
                             % (grid.shape, self.axis_names))
        self.devices = grid
        self.processes = np.array(owners, dtype=np.int64).reshape(
            grid.shape)
        self.shape = dict(zip(self.axis_names, grid.shape))
        _one_device(flat, "a mesh",
                    "a mesh across cards waits for the NCCL reduce", owners)
        self._device = _local_device(flat, owners, me, "the mesh")

    @property
    def spans_processes(self) -> bool:
        """Do the members lie in more than one process?"""
        return len(set(self.processes.flat)) > 1

    @property
    def device(self) -> torch.device:
        """The one device this process's members live on."""
        return _device_or_raise(self._device)

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
    """A :class:`Mesh` over ``devices`` (default: every visible card),
    each a device of this process or a :class:`Member`, in the order
    given (the reference's: process-major, as ``jax.devices()`` lists
    them). ``axes`` gives explicit {name: size} (``-1`` allowed once);
    without it the member count is factored over ``axis_names``. Members
    may repeat a device: ``[torch.device("cuda", 0)] * 8`` is a mesh of
    eight members on one card."""
    devices = visible_devices() if devices is None else list(devices)
    if axes is not None:
        sizes = MeshSpec(axes).resolve(len(devices))
    else:
        sizes = factor_devices(len(devices), axis_names)
    names = tuple(sizes.keys())
    grid = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        grid[i] = d if isinstance(d, Member) else torch.device(d)
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
    mesh's members in row-major order, its axis names and sizes, a
    ``spec`` naming the mesh axis each leading dim of the value is split
    over (``()`` for a replicated value), and the process of each member
    (``()``: all of this process). It describes a placement, so, unlike
    :class:`Mesh`, it may name distinct cards."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    spec: Tuple[Optional[str], ...] = ()
    processes: Tuple[int, ...] = ()

    @classmethod
    def of(cls, mesh: Mesh, spec: Sequence[Optional[str]] = ()
           ) -> "NamedSharding":
        """The sharding ``spec`` over ``mesh``'s members."""
        return cls(tuple(mesh.devices.flat), mesh.axis_names,
                   tuple(mesh.devices.shape), tuple(spec),
                   tuple(int(p) for p in mesh.processes.flat))

    @property
    def members(self) -> Tuple[Member, ...]:
        """Every member, a (process, device) pair."""
        if not self.processes:
            me = this_process()
            return tuple(Member(me, d) for d in self.devices)
        return tuple(Member(p, d) for p, d in zip(self.processes,
                                                  self.devices))

    @property
    def device(self) -> torch.device:
        """The one device this process's members live on; raises for
        members of one process on distinct devices, as :class:`Mesh`
        does."""
        members = self.members
        devices = [m.device for m in members]
        processes = [m.process for m in members]
        _one_device(devices, "a sharding",
                    "a value across cards waits for the NCCL reduce",
                    processes)
        return _device_or_raise(_local_device(devices, processes,
                                              this_process(),
                                              "the sharding"))


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
    """``degree`` members in ring order (member ``i`` hands its buffer to
    member ``i + 1``), each a device of this process or a
    :class:`Member`. The members of one process lie on one device; a
    ring that spans processes holds one member a process."""

    def __init__(self, devices: Sequence, axis_name: str = "tp"):
        me = this_process()
        devices, owners = _members(devices, me)
        self.devices = tuple(devices)
        self.processes = tuple(owners)
        self.axis_name = str(axis_name)
        if not 1 <= len(self.devices) <= MAX_MEMBERS:
            raise ValueError("a shard ring has 1 to %d members, got %d"
                             % (MAX_MEMBERS, len(self.devices)))
        _one_device(self.devices, "a shard ring",
                    "rings across cards of one process wait for peer "
                    "access", owners)
        if self.spans_processes and len(set(owners)) != len(owners):
            raise ValueError(
                "a shard ring that spans processes holds one member a "
                "process, got processes %s" % (list(owners),))
        #: the positions of this process's members in ring order
        self.local = tuple(i for i, p in enumerate(owners) if p == me)
        self._device = _local_device(self.devices, owners, me, "the ring")

    @property
    def degree(self) -> int:
        return len(self.devices)

    @property
    def spans_processes(self) -> bool:
        """Do the members lie in more than one process?"""
        return len(set(self.processes)) > 1

    @property
    def device(self) -> torch.device:
        """The one device this process's members live on."""
        return _device_or_raise(self._device)

    def check(self, members: Sequence[torch.Tensor], what: str) -> None:
        """Raise unless ``members`` holds one tensor for each member of
        this process (every member, in a ring of one process), each on
        its member's device."""
        local = self.local
        if len(members) != len(local):
            raise ValueError("%s: %d tensors for a ring of %d members, %d "
                             "of them in this process"
                             % (what, len(members), self.degree, len(local)))
        for i, t in zip(local, members):
            if t.device != self.devices[i]:
                raise ValueError("%s: member %d's tensor lies on %s, the "
                                 "ring's member on %s"
                                 % (what, i, t.device, self.devices[i]))

    def __repr__(self):
        if self.spans_processes:
            return "Ring(%r, axis_name=%r)" % (
                ["%d:%s" % m for m in zip(self.processes, self.devices)],
                self.axis_name)
        return "Ring(%r, axis_name=%r)" % ([str(d) for d in self.devices],
                                           self.axis_name)


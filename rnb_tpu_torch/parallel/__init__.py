"""Parallel execution over member devices (rnb_tpu.parallel's
counterpart): :mod:`mesh` holds meshes, rings, shardings and the
reference's mesh helpers, :mod:`sharded` the dp x sp sharded inference
step, :mod:`shardplan` what a sharded stage keeps at rest and how it
gathers it, :mod:`distributed` the reference's multi-process launch,
and :mod:`peers` the peers' memory of a ring across its processes.

The reference's six names are exported here. ``sharded`` imports the
network, whose ring collectives import :mod:`mesh` through this
package, so its two names load on first use.
"""

from rnb_tpu_torch.parallel.mesh import (MeshSpec, build_mesh,
                                         factor_devices, submeshes)

__all__ = [
    "MeshSpec", "build_mesh", "factor_devices", "submeshes",
    "ShardedInference", "make_sharded_inference",
]


def __getattr__(name):
    if name in ("ShardedInference", "make_sharded_inference"):
        from rnb_tpu_torch.parallel import sharded
        return getattr(sharded, name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))

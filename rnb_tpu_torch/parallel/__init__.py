"""Parallel execution over member devices (rnb_tpu.parallel's
counterpart): :mod:`mesh` holds meshes and rings, :mod:`sharded` the
dp x sp sharded inference step, :mod:`shardplan` what a sharded stage
keeps at rest and how it gathers it, :mod:`distributed` the refusal of
a multi-process run."""

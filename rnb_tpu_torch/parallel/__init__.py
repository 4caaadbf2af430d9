"""Intra-stage sharding over a ring of members (rnb_tpu.parallel's
counterpart): :mod:`mesh` holds the ring, :mod:`shardplan` what a
sharded stage keeps at rest and how it gathers it."""

"""Placement helpers: for now only the ring-hop factor.

Counterpart of ``rnb_tpu/placement.py``, cut to
:func:`ring_hop_factor`, which :mod:`rnb_tpu_torch.whatif` reads to
rescale a sharded step's measured collective slice. The rest of the
reference module (the occupancy planner, ``service_at_degree`` and the
replica-count search behind the root ``placement`` key) waits for the
replica lanes (ROADMAP queue 1, item 4): no path of the port builds a
replicated step yet, so nothing would read it.
"""

from __future__ import annotations


def ring_hop_factor(degree: int) -> float:
    """``g(k) = (k-1)/k`` — the fraction of the gathered bytes a
    degree-k ring moves (k-1 one-step hops of 1/k-sized chunks).
    The collective slice of a sharded step's service scales with this
    factor; g(1) = 0 (no ring, no tax)."""
    degree = int(degree)
    return 0.0 if degree <= 1 else (degree - 1) / degree

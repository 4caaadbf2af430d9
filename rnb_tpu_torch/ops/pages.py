"""Gather-from-pages and page writes: the device side of the pager.

PyTorch counterpart of ``rnb_tpu/ops/pages.py``. The page allocator
(:mod:`rnb_tpu_torch.pager`) keeps cached rows in one device slab,
``(num_pages * page_rows,) + row_shape``; a cache hit is a list of slab
rows, not bytes. Two primitives make those rows usable:

* :func:`gather_rows` — overlay slab rows onto a row pool on the card:
  ``out[i] = slab[src_rows[i]]`` where ``src_rows[i] >= 0``, else
  ``pool[i]``. Out of place, byte-exact for any dtype and any row size:
  it moves bytes and never computes. A CUDA tensor launches the
  hand-written kernel (``csrc/pages.cu``, ``rnb_gather_rows``), which
  reads the source table from device memory; a CPU tensor runs the
  plain version :func:`gather_rows_reference`. There is no fallback
  from one to the other.
* :func:`write_rows_page` — publish one page of rows into the slab. A
  donated jit in the reference (no Pallas kernel); here an in-place
  ``index_select`` copy into the slab. The index vector is always
  ``page_rows`` long, clamp-padded by repeating the last valid row: the
  padded rows land in the page's dead tail, which no gather reads.

The reference's slab is a functional value: a gather captures it and a
later donated write makes a new one. Here the slab is written in place,
so the caller (:class:`rnb_tpu_torch.pager.Arena`) keeps every gather
and write of one slab on one CUDA stream, in issue order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rnb_tpu_torch.ops import _kernels

#: the launch grid's row axis (CUDA's gridDim.y limit)
MAX_GATHER_ROWS = 65535


def _as_tensor(table, device: torch.device) -> torch.Tensor:
    """An index table (numpy array, list or tensor) as a tensor on
    ``device``."""
    if not isinstance(table, torch.Tensor):
        table = torch.from_numpy(np.asarray(table))
    return table.to(device)


def gather_rows_reference(pool: torch.Tensor, slab: torch.Tensor,
                          src_rows) -> torch.Tensor:
    """The plain version: a clamped ``index_select`` and a ``where``
    (the reference's masked-jnp twin, pages.py:67-81). Sentinel entries
    are clamped before the take, so no row outside the slab is ever
    addressed; the mask discards what they fetched."""
    src = _as_tensor(src_rows, pool.device).to(torch.int32)
    mask = (src >= 0).reshape((pool.shape[0],) + (1,) * (pool.dim() - 1))
    safe = src.clamp(0, int(slab.shape[0]) - 1).long()
    return torch.where(mask, slab.index_select(0, safe).to(pool.dtype),
                       pool)


def _check_gather_inputs(pool: torch.Tensor, slab: torch.Tensor,
                         src: torch.Tensor) -> None:
    if pool.device.type != "cuda":
        raise ValueError("gather_rows runs its kernel on cuda tensors, "
                         "got %s" % pool.device)
    if slab.device != pool.device or src.device != pool.device:
        raise ValueError("gather_rows needs pool, slab and source table on "
                         "one device, got %s, %s, %s"
                         % (pool.device, slab.device, src.device))
    if slab.dtype != pool.dtype:
        raise TypeError("gather_rows moves bytes between rows of one "
                        "dtype: pool %s, slab %s" % (pool.dtype, slab.dtype))
    if pool.dim() < 1 or tuple(slab.shape[1:]) != tuple(pool.shape[1:]):
        raise ValueError("gather_rows needs matching row shapes: pool %s, "
                         "slab %s" % (tuple(pool.shape), tuple(slab.shape)))
    if slab.shape[0] < 1:
        raise ValueError("gather_rows needs a non-empty slab")
    if src.dtype != torch.int32 or tuple(src.shape) != (pool.shape[0],):
        raise ValueError("gather_rows takes an int32 (%d,) source table, "
                         "got %s %s" % (pool.shape[0], src.dtype,
                                        tuple(src.shape)))
    if pool.shape[0] > MAX_GATHER_ROWS:
        raise ValueError("gather_rows takes at most %d pool rows, got %d"
                         % (MAX_GATHER_ROWS, pool.shape[0]))
    for what, t in (("pool", pool), ("slab", slab), ("source table", src)):
        if not t.is_contiguous():
            raise ValueError("gather_rows needs a contiguous %s" % what)


def gather_rows(pool: torch.Tensor, slab: torch.Tensor,
                src_rows) -> torch.Tensor:
    """Row pool with slab rows overlaid: ``out[i] = slab[src_rows[i]]``
    where ``src_rows[i] >= 0``, else ``pool[i]``.

    ``pool`` is ``(pool_rows,) + row_shape`` and ``slab`` ``(slab_rows,)
    + row_shape`` of the same dtype; ``src_rows`` is an int32
    ``(pool_rows,)`` table (a numpy array, or a tensor on the pool's
    device) with ``-1`` sentinels. On a CUDA pool this launches
    ``rnb_gather_rows`` on the current stream: each block reads its
    row's entry from the device table, so a sentinel row never reads
    the slab. On a CPU pool it runs the plain version."""
    if pool.device.type == "cpu":
        return gather_rows_reference(pool, slab, src_rows)
    src = _as_tensor(src_rows if isinstance(src_rows, torch.Tensor)
                     else np.asarray(src_rows, np.int32), pool.device)
    _check_gather_inputs(pool, slab, src)
    out = torch.empty_like(pool)
    row_bytes = math.prod(pool.shape[1:]) * pool.element_size()
    if out.numel():
        _kernels.GATHER_ROWS.launch(pool, slab, src, out,
                                    int(pool.shape[0]), int(slab.shape[0]),
                                    row_bytes)
    return out


def write_rows_page(slab: torch.Tensor, src_pool: torch.Tensor, src_idx,
                    dst_row: int) -> torch.Tensor:
    """Write ``src_pool[src_idx]`` into ``slab`` rows ``[dst_row, dst_row
    + len(src_idx))``, in place, and return the slab (the reference
    returns the new slab value). ``src_idx`` is always ``page_rows``
    long, clamp-padded; indices are clamped to the pool as the
    reference's ``mode="clip"`` take does, and the start row is clamped
    so the page fits, as ``dynamic_update_slice`` does."""
    idx = _as_tensor(src_idx, src_pool.device).long().clamp(
        0, int(src_pool.shape[0]) - 1)
    n = int(idx.shape[0])
    start = max(0, min(int(dst_row), int(slab.shape[0]) - n))
    slab[start:start + n] = src_pool.index_select(0, idx).to(slab.dtype)
    return slab

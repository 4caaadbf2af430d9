"""The processes of ``tests/test_torch_processes.py``'s launches.

Each runs as one process of a launch (``rnb_tpu_torch.tools.launch``:
the three ``RNB_TPU_*`` variables set), joins it, runs one case on the
CPU over the launch's gloo group, saves its own member's results with
``torch.save`` and leaves the launch (``distributed.shutdown``):

    python -m torch_process_children CASE OUT_DIR [ARGS_JSON]

Inputs come from numpy seeds, the same in every process and in the
test that holds the results to the JAX package. This module imports
no jax.
"""

import json
import os
import sys
import time

import numpy as np
import torch

CPU = torch.device("cpu")
#: a small R(2+1)D: 2 frames of 112 x 112, layer sizes (1, 1, 1, 1)
TINY_SI = dict(consecutive_frames=2, num_classes=8, layer_sizes=(1, 1, 1, 1))
GATHER_SHAPES = ((8, 3, 8), (16, 8), (8, 2, 2, 8))


def values(dtype, shape, seed):
    """Seeded values of ``dtype`` ("uint8", "bfloat16" or "float32") as a
    torch tensor (bf16 rounded from float32)."""
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16) if dtype == "bfloat16" else x


def integers(shape, seed):
    """Integer-valued float32: sums in any order are exact."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-8, 9, shape).astype(np.float32))


def conv_leaf(n, seed):
    """A channels-last conv kernel of ``n * 2`` out-channels (the shard
    ring's layout of a temporal conv weight)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n * 2, 5, 3, 1, 1),
                                         dtype=np.uint8)).contiguous(
        memory_format=torch.channels_last_3d)


def shard(x, n, axis, member):
    """Member ``member``'s shard of ``x`` along ``axis``, its own copy."""
    return torch.chunk(x, n, dim=axis)[member].clone()


def _ring(n):
    from rnb_tpu_torch.parallel.mesh import Member, Ring
    return Ring([Member(p, CPU) for p in range(n)], "tp")


def collectives(rank, n, args):
    """This member's ring_shift at every shift, all-gathers, the grouped
    gather of mixed leaves, reduce-scatters and a mixed table."""
    from rnb_tpu_torch.ops import handoff_dma as dma
    ring = _ring(n)
    out = {"local": ring.local, "device": str(ring.device)}
    for dtype in ("uint8", "bfloat16", "float32"):
        full = values(dtype, (n * 3, 5), seed=n * 10 + len(dtype))
        mine = [shard(full, n, 0, rank)]
        for shift in range(n):
            got = dma.ring_shift(mine, shift, ring)
            out["shift", dtype, shift] = got[0]
            out["same", dtype, shift] = got[0] is mine[0]
    for axis in (0, -1):
        full = values("float32", (8, 3, 8), seed=n + 31 * (axis + 2))
        out["gather", axis] = dma.ring_all_gather(
            [shard(full, n, axis, rank)], ring, axis)[0]
        leaves = [[shard(values("float32", s, seed=n * 3 + k + 11 * (axis
                                                                     + 2)),
                         n, axis, rank)]
                  for k, s in enumerate(GATHER_SHAPES)]
        if axis == 0:
            leaves.append([shard(conv_leaf(n, seed=n), n, 0, rank).contiguous(
                memory_format=torch.channels_last_3d)])
        got = dma.ring_all_gather_many(leaves, axis, ring)
        out["gather_many", axis] = [m[0] for m in got]
    for axis, shape in ((-1, (n, 2, 8)), (0, (n, 4, 3))):
        stack = integers(shape, seed=11 * n + axis)
        out["psum_scatter", axis] = dma.ring_psum_scatter(
            [stack[rank].clone()], ring, axis)[0]
    # a table mixing shifts: each entry's destination a slot of a canary
    src = values("float32", (n, 4, 6), seed=5 * n)
    canary = torch.full((n, 2 * n, 12), -1.0)
    table = [dma.RingEntry([src[rank]], [canary[rank, :4, :6]], 0)]
    for shift in range(1, n):
        table.append(dma.RingEntry([src[rank, :2]],
                                   [canary[rank, 2 * shift - 2:2 * shift,
                                           6:]], shift))
    dma.ring_shift_group(table, ring)
    out["group"] = canary[rank]
    return out


def contract(rank, n, args):
    """The launch's contract as this process sees it."""
    from rnb_tpu_torch.parallel import distributed
    from rnb_tpu_torch.parallel.mesh import NamedSharding
    out = {"again": distributed.maybe_initialize(),
           "count": distributed.process_count(),
           "index": distributed.process_index(),
           "primary": distributed.is_primary()}
    meshes = {}
    for name, kwargs in (("default", {}),
                         ("dp-1", dict(axes={"dp": -1, "sp": 1})),
                         ("pp", dict(axis_names=("pp", "dp", "sp")))):
        mesh = distributed.global_mesh(device=CPU, **kwargs)
        meshes[name] = (dict(mesh.shape), mesh.processes.tolist(),
                        [str(d) for d in mesh.devices.flat],
                        str(mesh.device), mesh.spans_processes)
    out["meshes"] = meshes
    sharding = NamedSharding.of(distributed.global_mesh(device=CPU), ("dp",))
    out["sharding"] = (sharding.processes, str(sharding.device))
    try:
        distributed.local_device()
        out["local_device"] = "ok"
    except RuntimeError as e:
        out["local_device"] = str(e)
    return out


def _same_rows(si, videos, valid):
    """This process's videos summed as its run sums them, each process's
    block of the sp row forwarded on its own as that process forwards
    it, with no ring: what the run must equal bit for bit."""
    v = len(valid) // si.dp_size
    first = si.local_dp[0] * v
    last = (si.local_dp[-1] + 1) * v
    padded = np.zeros((last - first, si.padded_clips) + videos.shape[2:],
                      np.uint8)
    padded[:, :si.max_clips] = videos[first:last]
    mask = torch.zeros((last - first, si.padded_clips))
    mask[:, :si.max_clips] = si.place_mask(valid[first:last])
    shard = si.padded_clips // si.sp_size
    block = len(si.local_sp) * shard
    parts = []
    for lo in range(0, si.padded_clips, block):
        rows = torch.from_numpy(padded[:, lo:lo + block].copy())
        parts.append(si.step_partials(rows, mask[:, lo:lo + block]))
    partials = torch.cat(parts, dim=1)
    total = partials[:, 0]
    for member in range(1, si.sp_size):
        total = total + partials[:, member]
    return total


def sharded(rank, n, args):
    """``ShardedInference`` over a mesh of ``args["members"]`` (process
    of each member, process-major) at ``args["axes"]``: this process's
    eager step and run, the host waits in each, predict, and its
    same-rows sum."""
    from rnb_tpu_torch.parallel import ShardedInference, peers
    from rnb_tpu_torch.parallel.mesh import Member, build_mesh
    variables = torch.load(args["weights"])
    mesh = build_mesh([Member(p, CPU) for p in args["members"]],
                      axes=args["axes"])
    dtype = getattr(torch, args["dtype"])
    si = ShardedInference(mesh, max_clips=args["max_clips"],
                          pixel_path=args["pixel_path"], dtype=dtype,
                          variables=variables, **TINY_SI)
    rng = np.random.default_rng(args["seed"])
    videos = rng.integers(0, 256, si.batch_shape(args["videos"]),
                          dtype=np.uint8)
    valid = [int(x) for x in rng.integers(1, si.max_clips + 1,
                                          args["videos"])]
    vids, mask = si.place(videos, valid)
    before = peers.host_waits
    with torch.inference_mode():
        eager = si.step_across(vids, mask)
    step_waits = peers.host_waits - before
    si.finish()
    before = peers.host_waits
    got = si.run(vids, mask)
    run_waits = peers.host_waits - before
    with torch.inference_mode():
        same_rows = _same_rows(si, videos, valid)
    return {"logits": got, "eager": eager,
            "host_waits": (step_waits, run_waits),
            "preds": si.predict(videos, valid),
            "same_rows": same_rows,
            "local_dp": si.local_dp, "local_sp": si.local_sp,
            "ring": None if si.sp_ring is None else si.sp_ring.processes,
            "place": (tuple(vids.shape), tuple(mask.shape))}


def killed(rank, n, args):
    """Process 1 leaves without a word; process 0's collective over the
    ring must raise within the cap."""
    if rank == 1:
        os._exit(0)
    from rnb_tpu_torch.ops import handoff_dma as dma
    from rnb_tpu_torch.parallel import peers
    peers.set_wait_cap(args["cap_s"])
    t0 = time.monotonic()
    try:
        dma.ring_shift([torch.ones(4)], 1, _ring(n))
        message = None
    except RuntimeError as e:
        message = str(e)
    return {"message": message, "seconds": time.monotonic() - t0}


def mismatched(rank, n, args):
    """Every process shifts a buffer of another shape: each must raise
    on the byte count its predecessor sends, before any payload moves."""
    from rnb_tpu_torch.ops import handoff_dma as dma
    try:
        dma.ring_shift([torch.ones(4 + 4 * rank)], 1, _ring(n))
        message = None
    except ValueError as e:
        message = str(e)
    return {"message": message}


CASES = {"collectives": collectives, "contract": contract,
         "sharded": sharded, "killed": killed, "mismatched": mismatched}


def main(argv):
    case, out_dir = argv[0], argv[1]
    args = json.loads(argv[2]) if len(argv) > 2 else {}
    torch.set_num_threads(1)
    from rnb_tpu_torch.parallel import distributed
    assert distributed.maybe_initialize() is True
    rank, n = distributed.process_index(), distributed.process_count()
    result = CASES[case](rank, n, args)
    torch.save(result, os.path.join(out_dir, "result-%d.pt" % rank))
    if case == "killed":
        # the peer is gone: leave without the group's goodbye
        os._exit(0)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Where the time of the cross-process hop (``rnb_ring_hop``,
``csrc/ring.cu``) goes: variants of its source, each timed on the card
beside the kernel as it is, and the parent checkout's hop.

Run on the machine with the card, from the root of a checkout:

    python3 -m rnb_tpu_torch.tools.hop_probe [--parent DIR] [--out FILE]

It launches two processes on the card (``rnb_tpu_torch.tools.launch``),
one ring of two members; process 0 times while process 1 waits at a
barrier (two contexts time-slice one card). The work is the conv5
temporal leaf's shard of a degree-2 forward (1,769,472 B, channels-last
bf16), from process 0 into a range of process 1's arena, with every
wait satisfied (``chip_smoke.hop_calls``): ``hop``, the whole launch,
L2 warm and flushed; and its parts ``copy`` (a local launch: the copy
alone), ``copy_sync`` (the copy with the post, the waits and the
publication) and ``sync`` (those alone, one block). Variants:

- ``kernel``: the source as it is;
- ``count_fence``: the publication of the first version: a GPU-scope
  fence before each block's count, a system-scope fence before the
  signal;
- ``no_post``, ``no_waits``, ``no_signal``: the post (after the first
  epoch's, which the calls' set-up needs), the two waits' loads, or the
  signal cut out (the timed calls' waits are satisfied either way): what
  each costs;
- ``no_early``: each chunk loaded only once the post is checked;
- ``gpu_scope``: the release and the acquires at GPU scope, not system
  scope (right on one card only): what the system scope costs;
- ``vectors_2``, ``vectors_8``: 2 or 8 16-byte vectors a thread (8 KB or
  32 KB a block; the kernel holds 4, 16 KB);
- ``bulk``: each block's 16 KB through shared memory by the 1-D bulk
  copy (``cp.async.bulk`` global to shared behind an ``mbarrier``, then
  shared to global), one thread issuing both, where the chunk is dense
  and 16-byte aligned (loaded once the post is checked).

With ``--parent DIR`` (another checkout, e.g. the parent commit unpacked
with ``git archive``), that tree's hop as ``parent``: its send launch
into the same peer range and its place launch out of a local window,
neither waiting, the two launches of its hop. Also ``Tensor.copy_`` of
the shard into the peer's range (``library``). Times are
``chip_smoke.py``'s (profiler device time), in two turns in opposite
orders; each variant's landed bytes are checked against the shard, and
the pinned error word is printed (``no_signal``'s set-up, whose own
``recv`` nothing signals, times out and sets it; every call has
counters of its own, so the others are not touched).
Prints one JSON object per (turn, variant, call), then the card's name
and power limit; writes them to ``--out`` (``hop_probe.json``) too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.tools.kernel_probe import build, patched

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

_COUNT = "  const unsigned long long seen = add_acq_rel_gpu(done, mark) + mark;"
_SIGNAL = ("    add_release_sys(word<unsigned long long>(\n"
           "        const_cast<uint8_t*>(sync.succ), kRecv));\n")
_EARLY = "    early = tile.rows == 1 &&"
_WAIT = "  while (load_acquire_sys(word) < target) {"
_BULK_AT = "// The chunk'th chunk of a tile."
_BULK = r"""// probe: a dense, aligned chunk through shared memory by the bulk copy
__device__ __forceinline__ void bulk_chunk(const uint8_t* from, uint8_t* to,
                                           long long bytes) {
  __shared__ alignas(128) uint8_t stage[kChunk];
  __shared__ alignas(8) unsigned long long bar;
  if (threadIdx.x == 0) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(stage));
    const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(&bar));
    const unsigned n = static_cast<unsigned>(bytes);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b)
                 : "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
        "r"(n)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(s),
        "l"(from), "r"(n), "r"(b)
        : "memory");
    unsigned ready = 0;
    // bounded: a copy that never completes ends the spin, not the card
    for (unsigned spins = 0; !ready && spins < (1u << 24); ++spins) {
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, "
          "[%1], 0; selp.u32 %0, 1, 0, p; }"
          : "=r"(ready)
          : "r"(b)
          : "memory");
    }
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], "
                 "%2;" ::"l"(to),
                 "r"(s), "r"(n)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

"""
_DISPATCH = "  if (rows) {\n    move_chunk<Pitched>(tile, begin, end, vectors);"
_BULK_DISPATCH = ("  if (!rows && vectors && (end - begin) % 16 == 0) {\n"
                  "    bulk_chunk(tile.from + begin, tile.to + begin, "
                  "end - begin);\n"
                  "    return;\n"
                  "  }\n" + _DISPATCH)

#: variant -> [(text in csrc/ring.cu, its replacement)], applied in order
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    # the publication of the first version
    "count_fence": [
        (_COUNT, "  __threadfence();\n"
                 "  const unsigned long long seen = atomicAdd(done, mark) + "
                 "mark;"),
        (_SIGNAL, "    __threadfence_system();\n" + _SIGNAL)],
    # parts cut out (the timed calls' waits are satisfied either way)
    "no_post": [("    if (control) poster.run();",
                 "    if (control && sync.epoch == 1) poster.run();")],
    "no_waits": [(_WAIT, "  while (false && load_acquire_sys(word) < "
                         "target) {")],
    "no_signal": [(_SIGNAL, "")],
    # the chunk loaded only once the post is checked
    "no_early": [(_EARLY, "    early = false &&")],
    # the system-scope release and acquires at GPU scope
    "gpu_scope": [("ld.acquire.sys.global", "ld.acquire.gpu.global"),
                  ("red.release.sys.global", "red.release.gpu.global"),
                  ("st.release.sys.global", "st.release.gpu.global")],
    "vectors_2": [("constexpr int kVectors = 4;",
                   "constexpr int kVectors = 2;")],
    "vectors_8": [("constexpr int kVectors = 4;",
                   "constexpr int kVectors = 8;")],
    "bulk": [(_BULK_AT, _BULK + _BULK_AT), (_DISPATCH, _BULK_DISPATCH),
             (_EARLY, "    early = false &&")],
}
#: the parent's rnb_ring_hop: the table, then the counter waited on and
#: its target, the counter signalled, the word of finished blocks, the
#: error word, the pinned word, the cap, and the layout with its words
_PARENT_HOP = _kernels._RING_TABLE + [
    ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
    ctypes.c_void_p, ctypes.c_void_p]
TIMEOUT_S = 900


def sources(parent: str) -> Dict[str, str]:
    with open(os.path.join(_kernels.CSRC_DIR, "ring.cu")) as f:
        text = f.read()
    out = {"hop_" + name: patched(text, patches)
           for name, patches in VARIANTS.items()}
    if parent:
        with open(os.path.join(parent, "rnb_tpu_torch", "csrc",
                               "ring.cu")) as f:
            out["hop_parent"] = f.read()
    return out


def child(out: str, parent: str) -> int:
    """One process of the probe's launch."""
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke
    from rnb_tpu_torch.ops import handoff_dma as dma
    from rnb_tpu_torch.parallel import distributed, peers
    from rnb_tpu_torch.parallel.mesh import Member, Ring
    assert distributed.maybe_initialize()
    rank, n = distributed.process_index(), distributed.process_count()
    device = distributed.local_device()
    torch.cuda.set_device(device)
    ring = Ring([Member(p, distributed.local_device(p)) for p in range(n)],
                "tp")
    gen = torch.Generator().manual_seed(2024)
    leaves = chip_smoke.ring_leaves(n)
    shape, fmt, dtype = leaves["net.conv5.block1.conv2.temporal.weight"]
    members = chip_smoke.ring_members(shape, fmt, dtype, n, gen, device)
    # one hop makes the endpoint and proves the path
    got = dma.ring_shift([members[rank]], 1, ring)[0]
    assert torch.equal(got, members[(rank - 1) % n])
    ep = peers.endpoint(ring)
    nbytes = got.untyped_storage().nbytes()
    (target,) = ep.empty([((nbytes,), (1,), torch.uint8)])
    ep.store.set("hop-probe/%d" % rank, str(ep.arena.place(
        target.data_ptr(), nbytes)))
    succ = (rank + 1) % n
    place = int(ep.store.get("hop-probe/%d" % succ))
    segment, offset = divmod(place, 1 << peers.SEGMENT_SHIFT)
    target_ptr = ep.peer_segments[succ][segment][0] + offset
    source = torch.empty(0, dtype=torch.uint8, device=device).set_(
        members[rank].untyped_storage())
    window = chip_smoke.peer_tensor(target_ptr, nbytes, device)
    rows = []
    torch.cuda.synchronize()
    ep.barrier("probe")
    if rank == 0:
        code = sources(parent)
        build_dir = os.path.join(_kernels.BUILD_DIR, "hop_probe")
        os.makedirs(build_dir, exist_ok=True)

        def built(item):
            try:
                return build(item[0], item[1], build_dir)
            except RuntimeError as e:  # reported, the others still timed
                return str(e)
        with ThreadPoolExecutor(len(code)) as pool:
            libs = dict(zip(code, pool.map(built, code.items())))
        stream = torch.cuda.current_stream(device).cuda_stream
        calls = {}
        for name, lib in libs.items():
            variant = name[4:]
            if isinstance(lib, str):
                rows.append({"variant": variant, "build_error": lib[-3000:]})
                continue
            if variant == "parent":
                fn = lib.rnb_ring_hop
                fn.restype = ctypes.c_int
                fn.argtypes = _PARENT_HOP + [ctypes.c_int, ctypes.c_void_p]
                calls[(variant, "hop")] = parent_hop(fn, source, target_ptr,
                                                     nbytes, device, stream)
                continue
            fn = lib.rnb_ring_hop
            fn.restype = ctypes.c_int
            fn.argtypes = _kernels.RING_SHIFT.entries[
                _kernels.RING_HOP_ENTRY] + [ctypes.c_int, ctypes.c_void_p]

            def launch(args, fn=fn):
                code = fn(*args, 0, stream)
                assert code == 0, code
            for part, call in chip_smoke.hop_calls(
                    ep, source, target_ptr, place, device, launch).items():
                if not part.startswith("_"):
                    calls[(variant, part)] = call
        calls[("library", "copy_")] = lambda: window.copy_(source)
        order = list(calls)
        for turn, names in enumerate((order, order[::-1])):
            for variant, part in names:
                fn = calls[variant, part]
                window.fill_(0)
                row = {"turn": turn, "variant": variant, "call": part,
                       "ms": chip_smoke.device_ms(fn)}
                if part in ("hop", "copy_"):
                    row["ms_l2_flushed"] = chip_smoke.flushed_ms(fn)
                torch.cuda.synchronize()
                row["landed"] = bool(torch.equal(window, source))
                row["error_word"] = ep.reported()
                rows.append(row)
                print(json.dumps(row), flush=True)
        rows.append({"card": chip_smoke.nvidia_smi_line(),
                     "bytes": nbytes,
                     "bound_ms": 2 * nbytes / chip_smoke.PEAK_BYTES_PER_S
                     * 1e3})
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)
    torch.cuda.synchronize()
    ep.barrier("probed")
    del target, got
    distributed.shutdown()
    return 0


def parent_hop(fn, source, target_ptr, nbytes, device, stream):
    """The parent's hop alone: its send launch (the shard into the
    peer's range) and its place launch (a local window into a local
    destination), neither waiting nor signalling."""
    import torch
    window = torch.empty(nbytes, dtype=torch.uint8, device=device)
    out = torch.empty(nbytes, dtype=torch.uint8, device=device)
    done = torch.zeros(64, dtype=torch.int32, device=device)
    error = torch.zeros(64, dtype=torch.int32, device=device)
    tables = []
    for src, dst in ((source.data_ptr(), target_ptr),
                     (window.data_ptr(), out.data_ptr())):
        (table,) = _kernels.ring_table([_kernels.RingTableEntry(
            (src,), (dst,), (nbytes,), (nbytes,), 0, 1, nbytes)], 1)
        tables.append(table)

    def call():
        for table in tables:
            code = fn(*table, None, 0, None, done.data_ptr(),
                      error.data_ptr(), None, 10 ** 9, 0, None, None, 0,
                      stream)
            assert code == 0, code
    call.keep = (window, out, done, error)
    return call


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", default="",
                        help="another checkout's root")
    parser.add_argument("--out", default="hop_probe.json",
                        help="where the rows go as JSON")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        return child(args.child, args.parent)
    import torch
    from rnb_tpu_torch.tools.launch import launch
    if not torch.cuda.is_available():
        print("hop_probe: no CUDA device is available", file=sys.stderr)
        return 1
    command = [sys.executable, "-m", "rnb_tpu_torch.tools.hop_probe",
               "--child", os.path.abspath(args.out)]
    if args.parent:
        command += ["--parent", os.path.abspath(args.parent)]
    failed = 0
    for ended in launch(2, command, TIMEOUT_S, cwd=HERE):
        print(ended.stdout, end="")
        if ended.returncode != 0:
            failed = 1
            print("process %d: %s\n%s" % (ended.index, ended.returncode,
                                          ended.stderr[-6000:]),
                  file=sys.stderr)
    return failed


if __name__ == "__main__":
    sys.exit(main())

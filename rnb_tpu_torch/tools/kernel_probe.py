"""Where the time of two hand-written kernels goes: variants of their
sources with a section cut out or extra instructions put in, each timed
on the card beside the kernel as it is.

Run on the machine with the card, from the root of a checkout:

    python3 -m rnb_tpu_torch.tools.kernel_probe [--parent DIR]

``rnb_dct_ingest`` (``csrc/dct.cu``, bf16 out, the dct cell's synthetic
spectra), at 2 rows (one CTA on each of 112 SMs: what one CTA's chain
of dependent steps takes), 15 and 48 rows:

- ``kernel``: the source as it is;
- ``no_epilogue``: BT.601, the quantize, the pack and the stores cut;
- ``no_epilogue_idct``: the IDCT passes cut as well;
- ``no_epilogue_idct_rounds``: and the unpack rounds (the entries are
  never read): what is left is the count prefix, the slab's zeros and
  the launch;
- ``five_ctas``: the kernel with 12.8 KB more shared memory a CTA, so
  an SM holds five CTAs (35 warps), not seven (49);
- ``plus_200_ffma``, ``plus_200_lds``: the kernel with 200 more FFMAs,
  or 200 more shared-memory loads, per MCU warp. Where the added work
  costs its issue slots (or shared-memory cycles) in full, the kernel
  is bound by that resource.

``rnb_gather_rows`` (``csrc/pages.cu``) at the 15-row clip pool with 8
hits: ``kernel``, and ``no_table``, every row from the pool with the
source table unread (what the table's dependent read costs).

``rnb_ring_shift`` (``csrc/ring.cu``) on three of the degree-2 shard
ring's tables: the conv5 temporal leaf's hop (one entry), a forward's
first gather table (own slots and the hop of all 19 leaves, 76 tiles)
and the merge's (rows at a pitch): ``kernel``, and the same source with
8 or 16 vectors a thread in flight (``vectors_8``, ``vectors_16``; the
kernel holds 4), 128 threads a block (``threads_128``), or a table of
at most 8 tiles in 392 bytes of parameters (``tiles_8``; the hop and
the merge only).

With ``--parent DIR`` (another checkout, e.g. the parent commit
unpacked with ``git archive``), that tree's dct and gather kernels as
``parent``. ``--only`` picks some of ``dct``, ``gather`` and ``ring``.
A cut variant writes no usable output: its time says what the cut
section costs, not that anything is right. Times are ``chip_smoke.py``'s
(the profiler's device time, L2 warm and L2 flushed), two turns in
opposite orders. Prints one JSON object per variant and shape, and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

from rnb_tpu_torch.ops import _kernels

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
HW, FRAMES = 112, 8

_EPILOGUE = """    // sass: epilogue
    epilogue<Out>(region, mcu_out(out, frame, s, c, height, width),
                  line_vectors, lane);
  }
}"""
_IDCT = """    // sass: idct
    idct_passes(region, lane);
    // sass: epilogue"""
_ROUNDS = """    for (int round = 0; round < items; round += 32) {"""
_FFMA = """    {
      float a[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) a[k] = region[lane + k];
#pragma unroll 1
      for (int r = 0; r < 25; ++r) {
#pragma unroll
        for (int k = 0; k < 8; ++k) a[k] = fmaf(a[k], 1.0001f, 0.5f);
      }
      if (a[0] + a[1] + a[2] + a[3] + a[4] + a[5] + a[6] + a[7] == 1e9f)
        region[lane] = 1.f;
      __syncwarp();
    }
"""
_LDS = """    {
      float acc = 0.f;
#pragma unroll 1
      for (int r = 0; r < 25; ++r) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc += region[kPlanes + ((lane + 32 * k + r) & 511)];
      }
      if (acc == 1e9f) region[lane] = 1.f;
      __syncwarp();
    }
"""
_NO_OUTPUT = """    if (region[lane] == 1e9f) out[lane] = Out();
  }
}"""

#: variant -> [(text in csrc/dct.cu, its replacement)], applied in order
DCT_VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    "no_epilogue": [(_EPILOGUE, _NO_OUTPUT)],
    "no_epilogue_idct": [(_EPILOGUE, _NO_OUTPUT),
                         (_IDCT.rsplit("\n", 1)[0] + "\n", "")],
    "no_epilogue_idct_rounds": [
        (_EPILOGUE, _NO_OUTPUT), (_IDCT.rsplit("\n", 1)[0] + "\n", ""),
        (_ROUNDS, _ROUNDS.replace("round < items;",
                                  "round < items && coeffs < 0;"))],
    # 12.8 KB more shared memory a CTA: five CTAs an SM, not seven
    "five_ctas": [("  __shared__ int partial[kStripeWarps][4];\n",
                        "  __shared__ int partial[kStripeWarps][4];\n"
                        "  __shared__ float pad[3200];\n"
                        "  if (coeffs < 0) pad[threadIdx.x] = 0.f;\n")],
    "plus_200_ffma": [(_EPILOGUE, _FFMA + _EPILOGUE)],
    "plus_200_lds": [(_EPILOGUE, _LDS + _EPILOGUE)],
}
GATHER_VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    "no_table": [("  const long long s = src[row];",
                  "  const long long s = -1;")],
}


RING_VARIANTS = {
    "kernel": [],
    "vectors_8": [("constexpr int kVectors = 4;",
                   "constexpr int kVectors = 8;")],
    "vectors_16": [("constexpr int kVectors = 4;",
                    "constexpr int kVectors = 16;")],
    "threads_128": [("constexpr int kThreads = 256;",
                     "constexpr int kThreads = 128;")],
    "tiles_8": [("constexpr int kMaxTiles = 80;",
                 "constexpr int kMaxTiles = 8;")],
}


def ring_tables(device):
    """The degree-2 ring's tables the probe times, as ``rnb_ring_shift``
    arguments (before device and stream): one launch each."""
    import torch
    import chip_smoke
    from rnb_tpu_torch.ops.handoff_dma import (RingEntry, ring_gather_tables,
                                               ring_launches)
    gen = torch.Generator().manual_seed(7)
    leaves = chip_smoke.ring_leaves(2)
    forward = [chip_smoke.ring_members(shape, fmt, dtype, 2, gen, device)
               for _, (shape, fmt, dtype) in sorted(leaves.items())]
    conv5 = forward[sorted(leaves).index(
        "net.conv5.block1.conv2.temporal.weight")]
    merge = chip_smoke.ring_members(chip_smoke.MERGE_BLOCK,
                                    torch.contiguous_format, torch.float32,
                                    2, gen, device)
    keep, tables = [], {}
    for name, table in (
            ("conv5_hop", [RingEntry(conv5, [torch.empty_like(m)
                                             for m in conv5], 1)]),
            ("forward_gather", ring_gather_tables(forward, 0)[1][0]),
            ("merge", ring_gather_tables([merge], -1)[1][0])):
        (tables[name],) = ring_launches(table)
        keep.append(table)
    return tables, keep


def patched(source: str, patches: List[Tuple[str, str]]) -> str:
    """The source with each patch applied once; raises where a patch's
    text is not in it."""
    for old, new in patches:
        if source.count(old) != 1:
            raise ValueError("probe patch does not apply: %r" % old[:60])
        source = source.replace(old, new)
    return source


def build(name: str, code: str, out_dir: str) -> ctypes.CDLL:
    cu = os.path.join(out_dir, name + ".cu")
    lib = os.path.join(out_dir, "lib%s.so" % name)
    with open(cu, "w") as f:
        f.write(code)
    done = subprocess.run([_kernels.nvcc(), *_kernels.NVCC_FLAGS, "-o", lib,
                           cu], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError("nvcc failed for %s:\n%s%s"
                           % (name, done.stdout, done.stderr))
    return ctypes.CDLL(lib)


def idct_terms(ycoef, ucoef, vcoef) -> Dict[str, float]:
    """The IDCT multiplies and adds a lane issues per MCU at these
    coefficient planes (``unpack_dct_rows_reference``'s, numpy), as the
    kernel's three pass steps run them: each step sums the warp's
    largest count of leading terms up to a last non-zero input, rounded
    up to 1, 2, 4 or 8 (``idct_terms`` in ``csrc/dct.cu``). A row-pass
    line's terms end at its last non-zero coefficient, a column's at its
    block's last non-zero line. Returns the mean operations per MCU
    warp: ``separate`` (a multiply and an add per term, as now) and
    ``fused`` (one FMA per term)."""
    import numpy as np

    def blocks(plane):  # (n, H, W) -> (n, H/8, W/8, 8, 8)
        n, h, w = plane.shape
        return plane.reshape(n, h // 8, 8, w // 8, 8).transpose(0, 1, 3, 2, 4)

    def last(nonzero, axis):  # 1 + index of the last True, 0 if none
        size = nonzero.shape[axis]
        flipped = np.flip(nonzero, axis)
        return np.where(nonzero.any(axis), size - flipped.argmax(axis), 0)

    frames = ycoef.reshape(-1, *ycoef.shape[-2:]).numpy()
    y = blocks(frames)                               # (n, by, bx, 8, 8)
    n, by, bx = y.shape[:3]
    # the MCU's four luma blocks in the kernel's order, then U and V
    y = y.reshape(n, by // 2, 2, bx // 2, 2, 8, 8).transpose(0, 1, 3, 2, 4,
                                                             5, 6)
    y = y.reshape(n, by // 2, bx // 2, 4, 8, 8)
    chroma = [blocks(c.reshape(-1, *c.shape[-2:]).numpy())[..., None, :, :]
              for c in (ucoef, vcoef)]
    mcu = np.concatenate([y] + chroma, axis=3) != 0  # (..., 6, 8, 8)
    rows = last(mcu, 5)                   # per block line
    cols = np.repeat(last(mcu.any(5), 4)[..., None], 8, -1)  # per column
    rounded = np.array([0, 1, 2, 4, 4, 8, 8, 8, 8])

    def step(*terms):
        k = rounded[np.max(np.stack([np.max(t, axis=(-2, -1))
                                     for t in terms]), axis=0)]
        return np.maximum(k, 1)
    k1 = step(rows[..., :4, :])
    k2 = step(rows[..., 4:, :], cols[..., :2, :])
    k3 = step(cols[..., 2:, :])
    ks = np.stack([k1, k2, k3])
    return {"separate": float((8 * (2 * ks - 1)).sum(0).mean()),
            "fused": float((8 * ks).sum(0).mean()),
            "mean_terms_by_step": [float(k.mean()) for k in ks]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="another checkout's root")
    parser.add_argument("--only", nargs="+", choices=("dct", "gather",
                                                      "ring"),
                        default=("dct", "gather", "ring"))
    args = parser.parse_args(argv)
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke
    from rnb_tpu_torch.decode import SyntheticDecoder
    from rnb_tpu_torch.ops import dct
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device is available", file=sys.stderr)
        return 1
    out_dir = os.path.join(_kernels.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    sources = {}
    for stem, variants, kind in (("dct", DCT_VARIANTS, "dct"),
                                 ("pages", GATHER_VARIANTS, "gather"),
                                 ("ring", RING_VARIANTS, "ring")):
        if kind not in args.only:
            continue
        with open(os.path.join(_kernels.CSRC_DIR, stem + ".cu")) as f:
            text = f.read()
        for name, patches in variants.items():
            sources["%s_%s" % (stem, name)] = patched(text, patches)
        if args.parent and kind != "ring":
            with open(os.path.join(args.parent, "rnb_tpu_torch", "csrc",
                                   stem + ".cu")) as f:
                sources["%s_parent" % stem] = f.read()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(
            lambda item: build(item[0], item[1], out_dir),
            sources.items())))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, lib in libs.items():
        if name.startswith("dct_"):
            lib.rnb_dct_ingest.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        elif name.startswith("pages_"):
            lib.rnb_gather_rows.argtypes = [p, p, p, p, ll, ll, ll, i, p]
        else:
            lib.rnb_ring_shift.argtypes = _kernels.RING_SHIFT.argtypes + [
                i, p]

    device = torch.device("cuda", 0)
    wires = {rows: torch.from_numpy(SyntheticDecoder().decode_clips_dct(
        "synth://smoke-timing" + ("-48" if rows == 48 else ""),
        list(range(rows)), FRAMES, HW, HW)).to(device) for rows in (2, 15,
                                                                    48)}
    out = torch.empty((48, FRAMES, HW, HW, 3), dtype=torch.bfloat16,
                      device=device)

    def ingest(lib, rows):
        wire = wires[rows]
        coeffs = dct.coeffs_from_elems(HW, HW, wire.shape[-1])
        return lambda: lib.rnb_dct_ingest(
            wire.data_ptr(), out.data_ptr(), None, rows, FRAMES, HW, HW,
            coeffs, 1, 0, torch.cuda.current_stream().cuda_stream)

    gen = torch.Generator().manual_seed(99)
    clip_pool = torch.randint(0, 256, (15, FRAMES, 18816), generator=gen,
                              dtype=torch.uint8).to(device)
    slab = torch.randint(0, 256, (445 * 4, FRAMES, 18816), generator=gen,
                         dtype=torch.uint8).to(device)
    src = np.full(15, -1, np.int32)
    src[:8] = np.arange(0, 8 * 97, 97)
    table = torch.from_numpy(src).to(device)
    gathered = torch.empty_like(clip_pool)

    def gather(lib):
        return lambda: lib.rnb_gather_rows(
            clip_pool.data_ptr(), slab.data_ptr(), table.data_ptr(),
            gathered.data_ptr(), 15, slab.shape[0], FRAMES * 18816, 0,
            torch.cuda.current_stream().cuda_stream)

    tables, _keep = ring_tables(device)

    def ring(lib, name):
        table = tables[name]
        return lambda: lib.rnb_ring_shift(
            *table, 0, torch.cuda.current_stream().cuda_stream)

    if "dct" in args.only:
        for rows in (15, 48):
            print(json.dumps({"idct_ops_per_mcu_warp": idct_terms(
                *dct.unpack_dct_rows_reference(wires[rows].cpu(), HW, HW)),
                "rows": rows}))
    calls = {}
    for name, lib in libs.items():
        if name.startswith("dct_"):
            for rows in (2, 15, 48):
                calls[("dct_ingest", name[4:], rows)] = ingest(lib, rows)
        elif name.startswith("pages_"):
            calls[("gather_rows", name[6:], 15)] = gather(lib)
        else:
            for table in tables:
                fn = ring(lib, table)
                if fn() == 0:  # a table over the variant's cap is refused
                    calls[("ring_shift", name[5:], table)] = fn
    times: Dict[tuple, list] = {}
    for turn in range(2):
        order = list(calls.items())
        for key, fn in (order if turn == 0 else order[::-1]):
            times.setdefault(key, []).append(
                (chip_smoke.device_ms(fn), chip_smoke.flushed_ms(fn)))
    for (kernel, variant, rows), turns in times.items():
        print(json.dumps({"kernel": kernel, "variant": variant, "rows": rows,
                          "ms": [t[0] for t in turns],
                          "ms_l2_flushed": [t[1] for t in turns]}))
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())

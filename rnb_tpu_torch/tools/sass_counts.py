"""SASS instruction counts of a csrc kernel, split into the sections its
source marks.

A line ``// sass: NAME`` in a ``csrc/*.cu`` file starts section NAME,
which runs to the next such line; ``// sass: -`` marks helpers whose
instructions count in the section of the line that called them (the
inlining chain that ``nvdisasm -gi`` prints for every instruction is
walked from the innermost line out to the first one in a named
section). ``--section NAME=FIRST-LAST`` gives a section by line range
instead, for a source without marks. Run on the machine with the card
(it needs ``nvcc``, ``nvdisasm`` and ``cuobjdump``):

    python3 -m rnb_tpu_torch.tools.sass_counts --source rnb_tpu_torch/csrc/dct.cu \\
        --kernel dct_ingest_kernel --kernel dct_convert_kernel

The source is compiled to a cubin with the flags of ``ops/_kernels.py``
and ``-lineinfo``; its instruction sequence is compared with the one
``cuobjdump -sass`` reads from the library built with the same flags but
no line table, and the counts are printed only if the two are the same
instructions. Counts are static: every instruction of the kernel once.
A section's instructions inside a loop (a span closed by a backward
branch) are counted apart, with each loop's source line and length, so
that the instructions a warp executes can be worked out from the trip
counts. Prints one JSON object per kernel and template instance.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

from rnb_tpu_torch.ops import _kernels

_MARK = re.compile(r"//\s*sass:\s*(\S+)")
_LOC = re.compile(r'//## File "([^"]+)", line (\d+)')
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?[ ;]")
_LABEL = re.compile(r"^(\.L_x_\d+):")
#: a conditional branch: a loop's back edge where its target lies
#: behind it (the unconditional ones go back from the out-of-line
#: fallbacks of the warp collectives)
_BRANCH = re.compile(r"@!?P\w+\s+BRA(?:\.\w+)*\s+`\((\.L_x_\d+)\)")
_FUNC = re.compile(r"^\.text\.(\S+):")
_FLAGS_DROPPED = ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: opcode classes for the summary
_CLASSES = (
    ("fp32", re.compile(r"^(FADD|FMUL|FFMA|FMNMX|FRND|FSET|FSETP|FSEL|"
                        r"FCHK|MUFU)$")),
    ("convert", re.compile(r"^(F2F|F2I|I2F|F2FP|I2FP|FRND)$")),
    ("memory", re.compile(r"^(LD|ST|LDG|STG|LDS|STS|LDC|ULDC|LDSM|ATOM|"
                          r"ATOMS|RED|LDGSTS)$")),
    ("warp", re.compile(r"^(SHFL|VOTE|VOTEU|MATCH|REDUX|WARPSYNC|BAR|"
                        r"BSSY|BSYNC|NANOSLEEP)$")),
    ("control", re.compile(r"^(BRA|EXIT|RET|CALL|BRX|JMP|YIELD)$")),
)


def _opclass(op: str) -> str:
    for name, pattern in _CLASSES:
        if pattern.match(op):
            return name
    return "int/other"


def line_sections(source: str, ranges: List[str]) -> Dict[int, str]:
    """line number -> section name, from ``--section`` ranges if given,
    else from the source's ``// sass:`` marks."""
    sections: Dict[int, str] = {}
    if ranges:
        for spec in ranges:
            name, span = spec.split("=", 1)
            first, last = (int(x) for x in span.split("-", 1))
            for line in range(first, last + 1):
                sections[line] = name
        return sections
    current: Optional[str] = None
    with open(source) as f:
        for number, text in enumerate(f, 1):
            mark = _MARK.search(text)
            if mark:
                current = mark.group(1)
            if current is not None:
                sections[number] = current
    return sections


def parse_disassembly(text: str, source: str) -> Dict[str, Tuple[
        List[Tuple[int, str, List[int], Optional[str]]], Dict[str, int]]]:
    """``nvdisasm -gi`` output -> {function: ([(address, opcode, line
    chain innermost first, conditional branch target or None)], {label:
    address})}; the chain keeps the lines of ``source`` only (a header's
    inlined lines are skipped over to their caller)."""
    base = os.path.basename(source)
    functions: Dict = {}
    labels: Dict[str, Dict[str, int]] = {}
    name = None
    chain: List[int] = []
    pending_chain: List[int] = []
    pending_labels: List[str] = []
    for raw in text.splitlines():
        line = raw.strip()
        func = _FUNC.match(line)
        if func:
            name = func.group(1)
            functions[name] = []
            labels[name] = {}
            chain, pending_chain, pending_labels = [], [], []
            continue
        if name is None:
            continue
        if line.startswith("//--------"):
            name = None
            continue
        loc = _LOC.match(line)
        if loc:
            if os.path.basename(loc.group(1)) == base:
                pending_chain.append(int(loc.group(2)))
            continue
        label = _LABEL.match(line)
        if label:
            pending_labels.append(label.group(1))
            continue
        insn = _INSN.search(line)
        if not insn:
            continue
        if pending_chain:
            chain, pending_chain = pending_chain, []
        address = int(insn.group(1), 16)
        for pending in pending_labels:
            labels[name][pending] = address
        pending_labels = []
        branch = _BRANCH.search(line)
        functions[name].append((address, insn.group(2), list(chain),
                                branch.group(1) if branch else None))
    return {k: (v, labels[k]) for k, v in functions.items()}


def count(insns, labels, sections: Dict[int, str]) -> Dict:
    """Per section: static instructions, opcode classes, and those inside
    loops (spans closed by a conditional backward branch), with each
    loop's first source line and length."""
    loops = []
    for address, _op, chain, target in insns:
        if target is not None and labels.get(target, address + 1) <= address:
            loops.append((labels[target], address))
    out: Dict[str, Dict] = defaultdict(lambda: {
        "instructions": 0, "in_loops": 0, "classes": Counter()})
    loop_report = []
    for first, last in loops:
        body = [i for i in insns if first <= i[0] <= last]
        where = next((c[0] for _a, _o, c, _t in body if c), None)
        loop_report.append({"first_line": where, "instructions": len(body),
                            "section": _section(body[0][2], sections)})
    for address, op, chain, _target in insns:
        name = _section(chain, sections)
        entry = out[name]
        entry["instructions"] += 1
        entry["classes"][_opclass(op)] += 1
        if any(first <= address <= last for first, last in loops):
            entry["in_loops"] += 1
    result = {name: {"instructions": e["instructions"],
                     "in_loops": e["in_loops"],
                     "classes": dict(sorted(e["classes"].items()))}
              for name, e in out.items()}
    return {"total": len(insns), "sections": result, "loops": loop_report}


def _section(chain: List[int], sections: Dict[int, str]) -> str:
    for line in chain:
        name = sections.get(line)
        if name is not None and name != "-":
            return name
    return "other"


def _run(cmd: List[str]) -> str:
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError("%s failed:\n%s%s" % (cmd[0], done.stdout,
                                                 done.stderr))
    return done.stdout


def opcodes_of(text: str) -> Dict[str, List[str]]:
    """function -> opcode sequence, from ``cuobjdump -sass`` output."""
    out: Dict[str, List[str]] = {}
    name = None
    for line in text.splitlines():
        func = re.match(r"\s*Function : (\S+)", line)
        if func:
            name = func.group(1)
            out[name] = []
            continue
        insn = _INSN.search(line)
        if name is not None and insn:
            out[name].append(insn.group(2))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", default=os.path.join(_kernels.CSRC_DIR,
                                                         "dct.cu"))
    parser.add_argument("--kernel", action="append", required=True,
                        help="a substring of the kernel's mangled name")
    parser.add_argument("--section", action="append", default=[],
                        help="NAME=FIRST-LAST source lines (overrides the "
                        "source's marks)")
    parser.add_argument("--out-dir", default=os.path.join(
        _kernels.BUILD_DIR, "sass"))
    args = parser.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    bindir = os.path.dirname(_kernels.nvcc())
    stem = os.path.splitext(os.path.basename(args.source))[0]
    flags = [f for f in _kernels.NVCC_FLAGS if f not in _FLAGS_DROPPED]
    cubin = os.path.join(args.out_dir, stem + ".cubin")
    lib = os.path.join(args.out_dir, "lib%s.so" % stem)
    _run([_kernels.nvcc(), *flags, "-cubin", "-lineinfo", "-o", cubin,
          args.source])
    _run([_kernels.nvcc(), *_kernels.NVCC_FLAGS, "-o", lib, args.source])
    disassembly = _run([os.path.join(bindir, "nvdisasm"), "-gi", cubin])
    library = opcodes_of(_run([os.path.join(bindir, "cuobjdump"), "-sass",
                               lib]))
    sections = line_sections(args.source, args.section)
    functions = parse_disassembly(disassembly, args.source)
    status = 0
    for pattern in args.kernel:
        names = sorted(n for n in functions if pattern in n)
        if not names:
            print("no kernel matches %r" % pattern, file=sys.stderr)
            status = 1
        for name in names:
            insns, labels = functions[name]
            same = library.get(name) == [op for _a, op, _c, _t in insns]
            if not same:
                print("%s: the -lineinfo cubin's instructions differ from "
                      "the library's" % name, file=sys.stderr)
                status = 1
                continue
            report = count(insns, labels, sections)
            report.update(kernel=name, source=os.path.relpath(args.source),
                          same_as_library=same)
            print(json.dumps(report, sort_keys=True))
    return status


if __name__ == "__main__":
    sys.exit(main())

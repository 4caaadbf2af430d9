"""Finding records and the checked-in baseline of intentional keeps.

Counterpart of ``rnb_tpu/analysis/findings.py``, the port's own copy.

A finding is keyed for baselining by ``(rule, file, anchor)`` — never
by line number, which drifts with every unrelated edit. The anchor is
the enclosing function/class qualname for AST findings, the config's
step/group coordinate for graph findings, or the stamp/line name for
schema findings.

Baseline format (``rnb_tpu_torch/analysis/baseline.txt``): one
entry per line, ``RULE <file> <anchor>  # one-line justification``.
Blank lines and ``#``-first lines are comments. A baseline entry that
matches no current finding is *stale* and fails the lint run — the
baseline documents live exceptions, not history.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import os
from typing import Dict, List, Optional, Tuple

#: default baseline location, relative to the repo root
BASELINE_FILENAME = os.path.join("rnb_tpu_torch", "analysis",
                                 "baseline.txt")


def package_py_files(package_dir: str) -> List[str]:
    """The one sorted walk both source-reading analyzer families
    (hotpath, schema) share — a future exclusion added here applies to
    every family at once instead of drifting per walker."""
    paths = []
    for dirpath, dirnames, filenames in sorted(os.walk(package_dir)):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        paths.extend(os.path.join(dirpath, fn)
                     for fn in sorted(filenames) if fn.endswith(".py"))
    return paths


@functools.lru_cache(maxsize=None)
def parse_py(path: str):
    """Cached AST parse: several analyzer families walk the same
    package file list in one short-lived lint run — parse each file
    once per process."""
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


@dataclasses.dataclass
class Finding:
    """One static-analysis problem at a specific site."""

    rule: str       # e.g. "RNB-H002"
    file: str       # repo-relative path ("" for repo-level findings)
    line: int       # 1-based, 0 when no specific line applies
    anchor: str     # stable site key (qualname / step coord / name)
    message: str

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.file, self.anchor)

    def render(self) -> str:
        where = "%s:%d" % (self.file, self.line) if self.file else "<repo>"
        return "%s %s [%s] %s" % (where, self.rule, self.anchor,
                                  self.message)


def format_findings(findings: List[Finding]) -> str:
    return "\n".join(f.render() for f in findings)


class Baseline:
    """The parsed intentional-exception list."""

    def __init__(self, entries: Dict[Tuple[str, str, str], str],
                 path: Optional[str] = None):
        self.entries = entries  # key -> justification
        self.path = path

    @classmethod
    def load(cls, path: str) -> "Baseline":
        entries: Dict[Tuple[str, str, str], str] = {}
        if not os.path.isfile(path):
            return cls(entries, path)
        with open(path) as f:
            for lineno, raw in enumerate(f, 1):
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                body, _, justification = line.partition("#")
                tokens = body.split()
                if len(tokens) != 3:
                    raise ValueError(
                        "%s:%d: baseline entries are 'RULE file anchor  "
                        "# justification', got %r" % (path, lineno, line))
                entries[tuple(tokens)] = justification.strip()
        return cls(entries, path)

    def empty(self) -> bool:
        return not self.entries


def apply_baseline(findings: List[Finding], baseline: Baseline
                   ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """-> (active, suppressed, stale_entry_lines).

    ``active`` are findings the baseline does not cover; ``suppressed``
    are intentional keeps; ``stale_entry_lines`` render baseline
    entries that matched nothing (they must be pruned — each one is a
    fixed finding still advertised as a live exception).
    """
    active: List[Finding] = []
    suppressed: List[Finding] = []
    seen = set()
    for f in findings:
        if f.key() in baseline.entries:
            suppressed.append(f)
            seen.add(f.key())
        else:
            active.append(f)
    stale = ["%s %s %s  # %s" % (rule, file, anchor,
                                 baseline.entries[(rule, file, anchor)])
             for (rule, file, anchor) in sorted(baseline.entries)
             if (rule, file, anchor) not in seen]
    return active, suppressed, stale

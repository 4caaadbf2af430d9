"""rnb-lint for the port: run the static analyzer families over the tree.

Usage::

    python -m rnb_tpu_torch.tools.lint                     # everything
    python -m rnb_tpu_torch.tools.lint --family graph      # one family
    python -m rnb_tpu_torch.tools.lint --config my.json    # one config
    python -m rnb_tpu_torch.tools.lint --verbose           # show baselined

Runs on the CPU with no device and no dataset: the graph family imports
the stage modules (torch imports, nothing is built), the other families
read source only. Exit status: 0 clean, 1 any active finding or stale
baseline entry, 2 internal error.

Intentional exceptions live in ``rnb_tpu_torch/analysis/baseline.txt``,
one ``RULE file anchor  # justification`` line each; an entry matching
no current finding is *stale* and fails the run. Before the verdict line
it prints, per family, the findings, the baselined and the stale counts.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PACKAGE = os.path.join(REPO, "rnb_tpu_torch")
BASELINE = os.path.join(PACKAGE, "analysis", "baseline.txt")

FAMILIES = ("graph", "hotpath", "schema", "concurrency")

#: rule-id prefix each family owns — single-family runs only consider
#: the baseline entries of the families that ran, so a clean
#: ``--family graph`` run is not failed by hotpath entries reading as
#: stale
FAMILY_RULE_PREFIX = {"graph": "RNB-G", "hotpath": "RNB-H",
                      "schema": "RNB-T", "concurrency": "RNB-C"}


def _findings(family, config_paths):
    if family == "graph":
        from rnb_tpu_torch.analysis import graph
        return graph.check_configs(config_paths, root=REPO)
    if family == "hotpath":
        from rnb_tpu_torch.analysis import hotpath
        return hotpath.check_package(PACKAGE, root=REPO)
    if family == "schema":
        from rnb_tpu_torch.analysis import schema
        return schema.check_repo(REPO)
    from rnb_tpu_torch.analysis import concurrency
    return concurrency.check_package(PACKAGE, root=REPO)


def run(family_names, config_paths, baseline_path, verbose=False,
        out=sys.stdout) -> int:
    from rnb_tpu_torch.analysis.findings import Baseline, apply_baseline

    baseline = Baseline.load(baseline_path)
    totals = ([], [], [])
    for family in family_names:
        prefix = FAMILY_RULE_PREFIX[family]
        scoped = Baseline({key: why for key, why in baseline.entries.items()
                           if key[0].startswith(prefix)}, baseline_path)
        active, suppressed, stale = apply_baseline(
            _findings(family, config_paths), scoped)
        print("rnb-lint %s: %d finding(s), %d baselined, %d stale"
              % (family, len(active), len(suppressed), len(stale)),
              file=out)
        for total, part in zip(totals, (active, suppressed, stale)):
            total.extend(part)
    active, suppressed, stale = totals
    for f in active:
        print(f.render(), file=out)
    if verbose:
        for f in suppressed:
            print("baselined: %s" % f.render(), file=out)
    for line in stale:
        print("stale baseline entry (finding fixed? prune it): %s" % line,
              file=out)
    print("rnb-lint: %d finding(s), %d baselined, %d stale baseline "
          "entr%s — %s"
          % (len(active), len(suppressed), len(stale),
             "y" if len(stale) == 1 else "ies",
             "FAIL" if (active or stale) else "OK"), file=out)
    return 1 if (active or stale) else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Static pipeline/config/telemetry analyzer of the "
                    "port")
    parser.add_argument("--family", choices=FAMILIES, action="append",
                        help="run only this analyzer family "
                             "(repeatable; default: all)")
    parser.add_argument("--config", action="append", default=None,
                        help="check this pipeline config instead of "
                             "the shipped configs/*.json (repeatable)")
    parser.add_argument("--baseline", default=BASELINE,
                        help="intentional-exception list")
    parser.add_argument("--verbose", action="store_true",
                        help="also print baseline-suppressed findings")
    args = parser.parse_args(argv)
    families = tuple(args.family) if args.family else FAMILIES
    configs = (args.config if args.config
               else sorted(glob.glob(os.path.join(REPO, "configs",
                                                  "*.json"))))
    try:
        return run(families, configs, args.baseline, verbose=args.verbose)
    except Exception:
        # exit 2 = the analyzer itself failed, distinct from exit 1 =
        # findings
        import traceback
        traceback.print_exc()
        return 2


if __name__ == "__main__":
    sys.exit(main())

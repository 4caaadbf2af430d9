"""rnb-lint for the port: static pipeline/config/telemetry analysis.

Counterpart of ``rnb_tpu/analysis``, over ``rnb_tpu_torch/``. Four
analyzer families, all runnable on the CPU with no device and no
dataset (``python -m rnb_tpu_torch.tools.lint`` is the CLI):

* :mod:`rnb_tpu_torch.analysis.graph` — pipeline graph checker: reads a
  config with the port's reader, resolves every stage class it names and
  propagates the stages' declared shapes, dtypes and row buckets step to
  step, rejecting wiring that would fail or capture a new graph at run
  time, before any device is touched.
* :mod:`rnb_tpu_torch.analysis.hotpath` — AST lint over the package:
  syncs with the card and host reads in a CUDA graph's captured body and
  on per-request paths, imports and per-item transfers there,
  nondeterminism in fault injection, unbounded waits.
* :mod:`rnb_tpu_torch.analysis.schema` — telemetry schema checker: every
  stamp, log-meta line, table trailer and result counter written in the
  package, against the registries of :mod:`rnb_tpu_torch.telemetry` and
  what :mod:`rnb_tpu_torch.parse_utils` reads.
* :mod:`rnb_tpu_torch.analysis.concurrency` — declared lock contracts
  and lock discipline, and the static lock-order graph the runtime
  witness's observed edges are held to.

Findings carry ``file:line``, a rule id and a stable anchor; intentional
exceptions live in ``rnb_tpu_torch/analysis/baseline.txt`` with a
one-line justification (:mod:`rnb_tpu_torch.analysis.findings`).
"""

from rnb_tpu_torch.analysis.findings import (Baseline, Finding,  # noqa: F401
                                             apply_baseline,
                                             format_findings)

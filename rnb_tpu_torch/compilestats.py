"""Compile/warmup accounting: count the input signatures a stage runs.

Counterpart of ``rnb_tpu/compilestats.py``. The reference promises
*bounded compilation*: every stage is warmed on its full shape
vocabulary before the measured window opens, and no new signature may
appear mid-run. On the card the port's counterpart of one compiled XLA
executable per signature is one captured CUDA graph per signature
(``R2P1DRunner``), and this module counts the signatures the same way:
one tracker per stage instance, frozen by the executor when the
measured window opens (``rnb_tpu_torch.runner``), so a signature first
seen after the freeze is surfaced as ``steady_new`` in the
``Compiles:`` log-meta line (``rnb_tpu_torch.parse_utils`` fails the
run on a nonzero count, as ``scripts/parse_utils.py --check`` does).

Signatures name dtypes as the reference does (``uint8``, ``bfloat16``,
``int16``, ``float32``), so the port's ``Compiles:`` line reads the
same as the reference's. The executor also times each stage's
construction (weights, warm-ups and, on the card, graph captures) for
the ``Warmup:`` line.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

_TORCH_PREFIX = "torch."


def dtype_name(dtype) -> str:
    """A dtype's name as the reference writes it: ``torch.uint8`` and
    numpy's ``uint8`` both read ``uint8``."""
    name = str(dtype)
    return name[len(_TORCH_PREFIX):] if name.startswith(_TORCH_PREFIX) \
        else name


def signature_of(*arrays) -> tuple:
    """The entry signature of a positional argument list: per argument
    (shape, dtype name) for a tensor or array, the type name for
    anything else (a scalar never forks an executable)."""
    sig = []
    for a in arrays:
        shape = getattr(a, "shape", None)
        dtype = getattr(a, "dtype", None)
        if shape is None:
            sig.append((type(a).__name__,))
        else:
            sig.append((tuple(int(d) for d in shape), dtype_name(dtype)))
    return tuple(sig)


class SignatureTracker:
    """Distinct entry signatures of one stage, split at the
    measured-window freeze. Locked: the fusing loader's device step may
    run on its transfer-worker thread while cache hits run on the
    executor thread."""

    __slots__ = ("_warmup", "_steady_new", "_steady_calls", "_frozen",
                 "_lock")

    GUARDED_BY = {
        "_warmup": "_lock",
        "_steady_new": "_lock",
        "_steady_calls": "_lock",
        "_frozen": "_lock",
    }

    def __init__(self):
        self._warmup: set = set()
        self._steady_new: set = set()
        self._steady_calls = 0
        self._frozen = False
        self._lock = threading.Lock()

    def observe(self, *arrays) -> None:
        """Note one dispatch's entry signature."""
        sig = signature_of(*arrays)
        with self._lock:
            if not self._frozen:
                self._warmup.add(sig)
                return
            self._steady_calls += 1
            if sig not in self._warmup:
                # a signature warm-up never saw: a mid-run capture
                self._steady_new.add(sig)

    def freeze(self) -> None:
        """The measured window opened: signatures from here on must
        already be warmed."""
        with self._lock:
            self._frozen = True

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "warmup": len(self._warmup),
                "steady_new": len(self._steady_new),
                "steady_calls": self._steady_calls,
            }


def aggregate_compile_records(records: List[Tuple[int, float, dict]]
                              ) -> Tuple[Dict[str, dict],
                                         Dict[str, float]]:
    """Per-instance ``(step_idx, warmup_s, sigs-or-None)`` records ->
    (``{step: {warmup, steady_new, steady_calls}}`` summed over the
    step's instances for tracker-owning stages,
    ``{step: warmup_seconds}`` summed over every instance)."""
    compiles: Dict[str, dict] = {}
    warmup: Dict[str, float] = {}
    for step_idx, warmup_s, sigs in records:
        key = "step%d" % int(step_idx)
        warmup[key] = round(warmup.get(key, 0.0) + float(warmup_s), 3)
        if sigs is None:
            continue
        agg = compiles.setdefault(
            key, {"warmup": 0, "steady_new": 0, "steady_calls": 0})
        for field in agg:
            agg[field] += int(sigs.get(field, 0))
    return compiles, warmup

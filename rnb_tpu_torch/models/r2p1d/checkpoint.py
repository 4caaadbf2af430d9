"""Seeded weights, per-layer-range filtering, and the bridge from the
JAX package's variable trees.

Counterpart of ``rnb_tpu/models/r2p1d/checkpoint.py``. No pretrained
weights exist for this model here, and the JAX package's shipped
checkpoint is itself a seeded init materialized at first use. The port
therefore makes its weights from a seed with an explicit
``torch.Generator`` on the CPU — so the card and the CPU get identical
values — and every stage of a partitioned pipeline filters one
full-model ``state_dict`` down to its own layers.

:func:`from_jax_variables` carries a flax ``{"params", "batch_stats"}``
tree (as numpy arrays) across to the port's ``state_dict``; the tests
use it to hold the port against the JAX package on the same weights.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from rnb_tpu_torch.models.r2p1d.network import (KINETICS_CLASSES,
                                                NUM_LAYERS, R18_LAYER_SIZES,
                                                R2Plus1DClassifier)


def _lecun_normal_(tensor: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (2 sigma) with
    variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    values = torch.empty(tensor.shape).normal_(generator=generator)
    while True:
        bad = values.abs() > 2.0
        if not bad.any():
            break
        values[bad] = torch.empty(int(bad.sum())).normal_(
            generator=generator)
    tensor.copy_(values * std)


def init_variables(seed: int = 0, start: int = 1, end: int = NUM_LAYERS,
                   num_classes: int = KINETICS_CLASSES,
                   layer_sizes: Optional[Sequence[int]] = None,
                   factored_shortcut: bool = False
                   ) -> Dict[str, torch.Tensor]:
    """Seeded float32 ``state_dict`` (on the CPU) of the [start..end]
    classifier. The full model is drawn first and then filtered, so
    every layer split of one seed shares the same weights. BatchNorm
    starts at flax's defaults (scale 1, bias 0, mean 0, var 1)."""
    layer_sizes = tuple(layer_sizes or R18_LAYER_SIZES)
    model = R2Plus1DClassifier(1, NUM_LAYERS, num_classes, layer_sizes,
                               factored_shortcut, dtype=torch.float32)
    generator = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, param in model.named_parameters():
            if name.endswith("weight") and param.dim() > 1:
                _lecun_normal_(param, param[0].numel(), generator)
            elif name == "linear.bias":
                param.zero_()  # flax Dense bias init; torch's is random
    return filter_layer_range(model.state_dict(), start, end)


def _range_module_prefixes(start: int, end: int) -> tuple:
    prefixes = ["net.conv%d." % layer for layer in range(start, end + 1)]
    if start == 1:
        prefixes.append("net.stem_bn.")
    if end == NUM_LAYERS:
        prefixes.append("linear.")
    return tuple(prefixes)


def filter_layer_range(state_dict: Dict[str, Any], start: int,
                       end: int) -> Dict[str, Any]:
    """Restrict a full-model ``state_dict`` to a layer range: the
    ``net.conv{i}`` modules for i in [start..end], the stem BN with
    layer 1, and the ``linear`` head only when the range reaches the
    final layer."""
    if not (1 <= start <= end <= NUM_LAYERS):
        raise ValueError("invalid layer range [%s..%s]" % (start, end))
    keep = _range_module_prefixes(start, end)
    return {k: v for k, v in state_dict.items() if k.startswith(keep)}


#: flax leaf name -> port suffix, per collection
_PARAM_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def from_jax_variables(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``{"params", "batch_stats"}`` tree (numpy leaves) -> the
    port's ``state_dict``. Conv kernels ``(T, H, W, in, out)`` become
    ``(out, in, T, H, W)``; the Dense kernel ``(in, out)`` is
    transposed; BatchNorm ``scale/bias/mean/var`` map to
    ``weight/bias/running_mean/running_var``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path, names):
        for key, value in tree.items():
            if hasattr(value, "items"):
                walk(value, path + (key,), names)
                continue
            array = np.array(value, dtype=np.float32)  # owned, writable
            if key == "kernel" and array.ndim == 5:
                array = array.transpose(4, 3, 0, 1, 2)
            elif key == "kernel" and array.ndim == 2:
                array = array.T
            name = ".".join(path + (names[key],))
            out[name] = torch.from_numpy(np.ascontiguousarray(array))

    walk(variables.get("params", {}), (), _PARAM_NAMES)
    walk(variables.get("batch_stats", {}), (), _STAT_NAMES)
    return out

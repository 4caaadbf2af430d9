"""Reference torch checkpoint -> the port's ``state_dict``, for R(2+1)D-18.

Counterpart of ``rnb_tpu/models/r2p1d/convert.py``. The system this
repo models served a pretrained Kinetics-400 torch checkpoint
(``model_data.pth.tar`` with a ``state_dict`` payload) whose module
tree comes from the R2Plus1D-PyTorch submodule (``res2plus1d.conv{1..5}``
and ``linear``). This module carries that state dict straight into the
port's ``state_dict``, with no flax tree in between:

* module paths remap as the reference's do: ``convL.block1`` ->
  ``net.convL.block0``, ``convL.blocks.{i}`` -> ``net.convL.block{i+1}``,
  ``downsampleconv``/``downsamplebn`` -> ``shortcut``/``shortcut_bn``,
  ``spatial_conv``/``temporal_conv`` -> ``spatial``/``temporal``;
* the port's convs are torch's ``(out, in, T, H, W)`` and its head is
  ``(out, in)``, so no tensor is transposed; BatchNorm keeps torch's
  ``weight``/``bias``/``running_mean``/``running_var`` names;
* the stem BN the network adds after conv1 (the torch stem conv is bare)
  has no torch source and gets the identity, a no-op at inference;
* the torch downsampling shortcut is a *factored* 1x1x1 (2+1)D pair, so
  a converted ``state_dict`` targets ``factored_shortcut=True`` networks.

Every converted ``state_dict`` is checked key by key and shape by shape
against the target architecture's own ``state_dict()``, so a truncated
or mismatched file fails loudly instead of serving a wrong model. Keys
the architecture does not read (BatchNorm's ``num_batches_tracked``)
are ignored.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from rnb_tpu_torch.models.r2p1d.network import (KINETICS_CLASSES,
                                                NUM_LAYERS, R18_LAYER_SIZES,
                                                R2Plus1DClassifier)

#: torch BatchNorm leaves, read and written under the same names
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


class ConversionError(ValueError):
    """State dict does not match the expected reference format."""


def _np(sd: Mapping[str, Any], key: str, ndim: Optional[int] = None
        ) -> np.ndarray:
    if key not in sd:
        raise ConversionError("state dict is missing %r" % key)
    value = sd[key]
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    arr = np.asarray(value, dtype=np.float32)
    if ndim is not None and arr.ndim != ndim:
        raise ConversionError("%r has %d dims, expected %d"
                              % (key, arr.ndim, ndim))
    return arr


def _set(out: Dict[str, torch.Tensor], name: str, arr: np.ndarray) -> None:
    if name in out:
        raise ConversionError("duplicate assignment at %s" % name)
    out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))


def _conv(out, name: str, sd, key: str) -> None:
    w = _np(sd, key)
    if w.ndim != 5:
        raise ConversionError("conv weight must be 5-D, got %r"
                              % (w.shape,))
    _set(out, name, w)


def _bn(out, name: str, sd, key: str) -> None:
    for leaf in _BN_LEAVES:
        _set(out, "%s.%s" % (name, leaf), _np(sd, "%s.%s" % (key, leaf), 1))


def _st_conv(out, name: str, sd, prefix: str) -> None:
    """One SpatioTemporalConv: spatial conv, mid BN, temporal conv."""
    _conv(out, name + ".spatial.weight", sd, prefix + "spatial_conv.weight")
    _bn(out, name + ".bn", sd, prefix + "bn")
    _conv(out, name + ".temporal.weight", sd,
          prefix + "temporal_conv.weight")


def convert_state_dict(state_dict: Mapping[str, Any],
                       num_classes: int = KINETICS_CLASSES,
                       layer_sizes: Sequence[int] = R18_LAYER_SIZES,
                       validate: bool = True) -> Dict[str, torch.Tensor]:
    """Reference torch state dict (tensors or numpy arrays) -> the
    full-model float32 ``state_dict`` of
    ``R2Plus1DClassifier(factored_shortcut=True)``; every partial stage
    takes its range of it (``checkpoint.filter_layer_range``). With
    ``validate`` the result is checked against the architecture."""
    sd = state_dict
    out: Dict[str, torch.Tensor] = {}
    _st_conv(out, "net.conv1", sd, "res2plus1d.conv1.")
    _set(out, "net.stem_bn.weight", np.ones(64, np.float32))
    _set(out, "net.stem_bn.bias", np.zeros(64, np.float32))
    _set(out, "net.stem_bn.running_mean", np.zeros(64, np.float32))
    _set(out, "net.stem_bn.running_var", np.ones(64, np.float32))
    for layer in range(2, NUM_LAYERS + 1):
        lname = "conv%d" % layer
        for block in range(int(layer_sizes[layer - 2])):
            # torch names the first block `block1` and the rest
            # `blocks.{i}`; the port names them block0..block{n-1}
            tprefix = ("res2plus1d.%s.block1." % lname if block == 0
                       else "res2plus1d.%s.blocks.%d." % (lname, block - 1))
            name = "net.%s.block%d" % (lname, block)
            _st_conv(out, name + ".conv1", sd, tprefix + "conv1.")
            _bn(out, name + ".bn1", sd, tprefix + "bn1")
            _st_conv(out, name + ".conv2", sd, tprefix + "conv2.")
            _bn(out, name + ".bn2", sd, tprefix + "bn2")
            if block == 0 and layer >= 3:
                _st_conv(out, name + ".shortcut", sd,
                         tprefix + "downsampleconv.")
                _bn(out, name + ".shortcut_bn", sd, tprefix + "downsamplebn")
    _set(out, "linear.weight", _np(sd, "linear.weight", 2))
    _set(out, "linear.bias", _np(sd, "linear.bias", 1))
    if validate:
        validate_state_dict(out, num_classes=num_classes,
                            layer_sizes=layer_sizes)
    return out


def validate_state_dict(state_dict: Mapping[str, Any],
                        num_classes: int = KINETICS_CLASSES,
                        layer_sizes: Sequence[int] = R18_LAYER_SIZES
                        ) -> None:
    """Check a converted ``state_dict`` against the target architecture
    (``factored_shortcut=True``): the same keys, the same shapes. The
    architecture is built on the meta device, so nothing is
    allocated."""
    with torch.device("meta"):
        model = R2Plus1DClassifier(1, NUM_LAYERS, int(num_classes),
                                   tuple(layer_sizes),
                                   factored_shortcut=True,
                                   dtype=torch.float32)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(np.shape(v)) for k, v in state_dict.items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ConversionError(
            "converted tree structure mismatch: missing %s, unexpected %s"
            % (missing[:5], extra[:5]))
    for key, want_shape in want.items():
        if got[key] != want_shape:
            raise ConversionError(
                "converted %s has shape %r, architecture wants %r"
                % (key, got[key], want_shape))


def convert_file(pth_path: str, out_path: str,
                 num_classes: int = KINETICS_CLASSES,
                 layer_sizes: Sequence[int] = R18_LAYER_SIZES) -> str:
    """Read a reference ``.pth.tar`` (its ``state_dict`` payload, or the
    payload itself), convert it and save it in the port's format
    (``checkpoint.save_checkpoint``). Returns ``out_path``. The file is
    read with ``weights_only=True``: a checkpoint is data, and loading
    it runs no code (the reference unpickles it whole)."""
    from rnb_tpu_torch.models.r2p1d import checkpoint as ckpt

    payload = torch.load(pth_path, map_location="cpu", weights_only=True)
    state_dict = payload.get("state_dict", payload)
    ckpt.save_checkpoint(out_path, convert_state_dict(
        state_dict, num_classes=num_classes, layer_sizes=layer_sizes))
    return out_path


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(
        description="Convert a reference R(2+1)D torch checkpoint to "
                    "the rnb_tpu_torch checkpoint format")
    parser.add_argument("pth_path")
    parser.add_argument("out_path")
    args = parser.parse_args()
    print(convert_file(args.pth_path, args.out_path))

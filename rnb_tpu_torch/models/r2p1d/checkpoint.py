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

The checkpoint store (``save_checkpoint``/``load_checkpoint``) keeps the
port's own format, a ``torch.save`` d ``state_dict`` of float32 tensors,
read back with ``weights_only=True``. ``load_checkpoint`` also reads the
JAX package's flax msgpack files as they are, through a small msgpack
reader of the port's own, so a config whose ``ckpt_path`` names such a
file serves the same weights on both packages. :func:`load_or_init` is
the one policy every stage shares: an explicit path must exist, and
without one the weights are drawn from ``WEIGHT_SEED``.
"""

from __future__ import annotations

import math
import os
import struct
import threading
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from rnb_tpu_torch.models.r2p1d.network import (KINETICS_CLASSES,
                                                NUM_LAYERS, R18_LAYER_SIZES,
                                                R2Plus1DClassifier)

#: the seed every stage's weights are drawn from when no file is named
WEIGHT_SEED = 0
DEFAULT_CKPT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))), "checkpoints")
#: the port's own seeded init (the JAX package's default file beside it
#: is a flax init drawn from another generator)
DEFAULT_CKPT_PATH = os.path.join(DEFAULT_CKPT_DIR,
                                 "r2p1d18_kinetics400_torch.pt")
#: the first bytes of a ``torch.save`` file (a zip archive)
_TORCH_MAGIC = b"PK\x03\x04"

_ensure_lock = threading.Lock()


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


# -- the JAX package's flax msgpack files -------------------------------

#: flax's msgpack ext code of an ndarray: ``(shape, dtype name, bytes)``
_FLAX_NDARRAY_EXT = 1
#: the marker of a leaf flax split into chunks (leaves over 2**30 bytes)
_FLAX_CHUNKED = "__msgpack_chunked_array__"
#: msgpack's sized types: the struct format of the length, and the kind
_SIZED = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
          0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext"),
          0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
          0xdc: (">H", "array"), 0xdd: (">I", "array"),
          0xde: (">H", "map"), 0xdf: (">I", "map")}
#: msgpack's fixed-width numbers: floats, unsigned and signed ints
_NUMBERS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}


class _MsgpackReader:
    """The msgpack subset a flax checkpoint holds: maps, strings,
    binaries, arrays, ints, floats, nil and booleans, and ext type 1
    (flax's ndarray). Any other ext type is refused."""

    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends %d bytes early"
                             % (self.pos + n - len(self.data)))
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b <= 0xbf:  # fixmap, fixarray, fixstr
            kind, mask = (("map", 0x0f) if b <= 0x8f else
                          ("array", 0x0f) if b <= 0x9f else ("str", 0x1f))
            return self._sized(kind, b & mask)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SIZED:
            fmt, kind = _SIZED[b]
            return self._sized(kind, self._unpack(fmt))
        if b in _NUMBERS:
            return self._unpack(_NUMBERS[b])
        if 0xd4 <= b <= 0xd8:  # fixext 1, 2, 4, 8, 16
            return self._ext(1 << (b - 0xd4))
        raise ValueError("msgpack type byte 0x%02x at %d is not valid"
                         % (b, self.pos - 1))

    def _sized(self, kind: str, n: int):
        if kind == "bin":
            return self._take(n)
        if kind == "str":
            return str(self._take(n), "utf-8")
        if kind == "array":
            return self._array(n)
        if kind == "map":
            return self._map(n)
        return self._ext(n)

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        if _FLAX_CHUNKED in out:
            raise ValueError(
                "the checkpoint holds a chunked array (flax splits leaves "
                "over 2**30 bytes); the port's reader does not join them")
        return out

    def _ext(self, n: int) -> np.ndarray:
        code = struct.unpack(">b", self._take(1))[0]
        data = self._take(n)
        if code != _FLAX_NDARRAY_EXT:
            raise ValueError("msgpack ext type %d is not flax's ndarray "
                             "(type %d)" % (code, _FLAX_NDARRAY_EXT))
        shape, dtype_name, buffer = _MsgpackReader(data).read()
        return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(
            shape)


def read_flax_msgpack(data) -> Dict[str, Any]:
    """A flax ``msgpack_serialize`` d tree (bytes) -> nested dicts of
    numpy arrays, as flax's ``msgpack_restore`` gives it."""
    reader = _MsgpackReader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("%d bytes follow the msgpack object"
                         % (len(reader.data) - reader.pos))
    return tree


# -- the checkpoint store ------------------------------------------------

def save_checkpoint(path: str, state_dict: Dict[str, Any]) -> None:
    """Write a ``state_dict`` as float32 CPU tensors in the port's
    format, through a temporary file renamed into place."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    torch.save({k: v.detach().to("cpu", torch.float32).contiguous()
                for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The full-model float32 ``state_dict`` of a checkpoint file: the
    port's own format, or a flax msgpack file of the JAX package (its
    tree carried across by :func:`from_jax_variables`)."""
    with open(path, "rb") as f:
        head = f.read(len(_TORCH_MAGIC))
    if head == _TORCH_MAGIC:
        state = torch.load(path, map_location="cpu", weights_only=True)
        if any(k.startswith("res2plus1d.") for k in state) \
                or "state_dict" in state:
            raise ValueError(
                "%r holds the reference's torch format; convert it first "
                "(python -m rnb_tpu_torch.models.r2p1d.convert)" % (path,))
        return {k: v.to(torch.float32) for k, v in state.items()}
    with open(path, "rb") as f:
        return from_jax_variables(read_flax_msgpack(f.read()))


def ensure_checkpoint(path: Optional[str] = None,
                      seed: int = WEIGHT_SEED) -> str:
    """Write the default architecture's seeded init at ``path`` (the
    port's default path) if nothing is there; return the path."""
    path = path or DEFAULT_CKPT_PATH
    with _ensure_lock:
        if not os.path.exists(path):
            save_checkpoint(path, init_variables(seed=seed))
    return path


def load_for_range(start: int, end: int,
                   path: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The shared checkpoint filtered to [start..end]."""
    return filter_layer_range(load_checkpoint(ensure_checkpoint(path)),
                              start, end)


def load_or_init(start: int, end: int,
                 num_classes: int = KINETICS_CLASSES,
                 layer_sizes: Sequence[int] = R18_LAYER_SIZES,
                 path: Optional[str] = None,
                 factored_shortcut: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """The one checkpoint policy every stage shares, the reference's:

    * an explicit ``path`` wins for any architecture and must exist —
      that is how converted checkpoints (``convert.py``) and the JAX
      package's files are served, each stage taking its range;
    * without one, the default architecture gets the shared seeded init
      and any other architecture (a factored shortcut included) a fresh
      matching one. The port draws both from ``WEIGHT_SEED`` with one
      generator, so they are one call here: :func:`ensure_checkpoint`
      writes exactly the default architecture's draw, and no file is
      read or written for it.
    """
    if path is not None:
        # an explicit path must exist: silently materializing a fresh
        # seeded init at a mistyped path would run the benchmark on
        # random weights while the user believes they loaded pretrained
        # ones
        if not os.path.exists(path):
            raise FileNotFoundError(
                "explicit ckpt_path %r does not exist; convert or save "
                "a checkpoint there first (models/r2p1d/convert.py)"
                % (path,))
        return filter_layer_range(load_checkpoint(path), start, end)
    return init_variables(WEIGHT_SEED, start, end, num_classes,
                          tuple(layer_sizes), factored_shortcut)

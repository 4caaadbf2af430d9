"""The port's checkpoint path against the JAX package's, on the CPU.

* ``convert_state_dict`` equals the reference's conversion followed by
  ``from_jax_variables``, key for key and bitwise, at a tiny depth and
  at R(2+1)D-18's; every ``ConversionError`` case of
  ``tests/test_convert.py`` fails the same way in the port.
* ``load_checkpoint`` reads the reference's msgpack files (a seeded
  tree, a converted tree) into ``from_jax_variables`` of the tree,
  bitwise, and refuses other ext types and chunked leaves; its msgpack
  reader decodes what the ``msgpack`` package encodes.
* The port's own format round-trips bitwise; ``ensure_checkpoint``'s
  file is the seeded init; ``load_for_range`` keeps the reference's
  ``filter_layer_range`` keys over all 15 ranges; ``load_or_init``
  follows the reference's three branches, its message included.
* ``ckpt_path`` on ``R2P1DRunner``, ``R2P1DSingleStep`` and
  ``R2P1DMeshRunner``: given the same file (the reference's msgpack, or
  the port's converted file), the port's stages agree with the
  reference's within ``tests/test_torch_network.py``'s bounds (float32
  within 5e-4 of flax; bf16 the slice tests' bound and equal argmax).
* ``parse_config`` accepts ``ckpt_path`` on the three classes in every
  shipped config.

The reference-format state dict is ``tests/test_convert.py``'s
``synth_state_dict``, with a ``sane`` option whose BatchNorm statistics
keep activations finite.
"""

import functools
import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d import convert as jax_convert
from rnb_tpu.models.r2p1d import model as jax_model
from rnb_tpu.models.r2p1d import network as jax_net
from rnb_tpu.stage import PaddedBatch as JaxPadded
from rnb_tpu.telemetry import TimeCard as JaxTimeCard
from rnb_tpu_torch.config import parse_config
from rnb_tpu_torch.decode import write_y4m
from rnb_tpu_torch.devices import DeviceSpec
from rnb_tpu_torch.models.r2p1d import checkpoint as ckpt
from rnb_tpu_torch.models.r2p1d import model as port_model
from rnb_tpu_torch.models.r2p1d.convert import (ConversionError,
                                                convert_file,
                                                convert_state_dict)
from rnb_tpu_torch.models.r2p1d.network import (NUM_LAYERS,
                                                R2Plus1DClassifier,
                                                factored_channels)
from rnb_tpu_torch.stage import PaddedBatch
from rnb_tpu_torch.telemetry import TimeCard

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYER_CHANNELS = {2: (64, 64), 3: (64, 128), 4: (128, 256), 5: (256, 512)}
LS = (1, 1, 1, 1)
CLASSES = 8
CPU = DeviceSpec(0, "cpu")
RANGES = [(s, e) for s in range(1, NUM_LAYERS + 1)
          for e in range(s, NUM_LAYERS + 1)]
#: tests/test_torch_network.py's float32 bound against flax
F32_TOL = 5e-4
#: the stages' frames: two of 112 x 112 a clip
FRAMES = 2


def synth_state_dict(num_classes=8, layer_sizes=(1, 1, 1, 1), seed=0,
                     sane=False):
    """A torch-format state dict with the reference's exact key names
    and tensor shapes (torch conv layout (out, in, T, H, W)). ``sane``
    draws conv kernels with variance 1/fan_in, BatchNorm scales near 1,
    small biases and means and variances in [0.5, 1.5], and adds torch's
    ``num_batches_tracked`` leaves, as a trained file holds them."""
    rng = np.random.default_rng(seed)
    sd = {}

    def arr(shape):
        if sane:
            fan_in = int(np.prod(shape[1:]))
            return rng.normal(0.0, fan_in ** -0.5, shape).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    def bn(prefix, c):
        if not sane:
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                sd[prefix + "." + leaf] = arr((c,))
            return
        sd[prefix + ".weight"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
        for leaf in ("bias", "running_mean"):
            sd[prefix + "." + leaf] = rng.normal(0, 0.1, c).astype(
                np.float32)
        sd[prefix + ".running_var"] = rng.uniform(0.5, 1.5, c).astype(
            np.float32)
        sd[prefix + ".num_batches_tracked"] = np.array(1000, np.int64)

    def st_conv(prefix, cin, cout, t, d):
        mid = factored_channels(cin, cout, t, d)
        sd[prefix + "spatial_conv.weight"] = arr((mid, cin, 1, d, d))
        bn(prefix + "bn", mid)
        sd[prefix + "temporal_conv.weight"] = arr((cout, mid, t, 1, 1))

    st_conv("res2plus1d.conv1.", 3, 64, 3, 7)
    for layer in range(2, 6):
        cin, cout = LAYER_CHANNELS[layer]
        for block in range(layer_sizes[layer - 2]):
            prefix = ("res2plus1d.conv%d.block1." % layer if block == 0
                      else "res2plus1d.conv%d.blocks.%d." % (layer,
                                                             block - 1))
            st_conv(prefix + "conv1.", cin if block == 0 else cout,
                    cout, 3, 3)
            bn(prefix + "bn1", cout)
            st_conv(prefix + "conv2.", cout, cout, 3, 3)
            bn(prefix + "bn2", cout)
            if block == 0 and layer >= 3:
                st_conv(prefix + "downsampleconv.", cin, cout, 1, 1)
                bn(prefix + "downsamplebn", cout)
    sd["linear.weight"] = arr((num_classes, 512))
    sd["linear.bias"] = (rng.normal(0, 0.01, num_classes) if sane
                         else arr((num_classes,))).astype(np.float32)
    return sd


def _assert_same(ours, want):
    assert set(ours) == set(want)
    for key, value in want.items():
        assert ours[key].dtype == torch.float32, key
        assert torch.equal(ours[key], value), key


# -- conversion ---------------------------------------------------------

@pytest.mark.parametrize("classes,layer_sizes", [(8, (1, 1, 1, 1)),
                                                 (400, (2, 2, 2, 2))])
def test_conversion_is_bitwise_the_references(classes, layer_sizes):
    sd = synth_state_dict(classes, layer_sizes)
    want = ckpt.from_jax_variables(jax_convert.convert_state_dict(
        sd, num_classes=classes, layer_sizes=layer_sizes))
    ours = convert_state_dict(sd, num_classes=classes,
                              layer_sizes=layer_sizes)
    _assert_same(ours, want)
    # torch tensors in, as a real file gives them: the same values
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    _assert_same(convert_state_dict(tensors, num_classes=classes,
                                    layer_sizes=layer_sizes), want)
    net = R2Plus1DClassifier(1, NUM_LAYERS, classes, layer_sizes, True)
    assert set(ours) == set(net.state_dict())
    stem = ours["net.stem_bn.running_var"]
    assert torch.equal(stem, torch.ones(64))


def _cut_linear(sd):
    sd["linear.weight"] = sd["linear.weight"][:, :100]


def _drop_conv(sd):
    del sd["res2plus1d.conv2.block1.conv1.spatial_conv.weight"]


def _flat_conv(sd):
    key = "res2plus1d.conv4.block1.conv2.temporal_conv.weight"
    sd[key] = sd[key].reshape(sd[key].shape[0], -1)


def _flat_bias(sd):
    sd["linear.bias"] = sd["linear.bias"][None]


def _drop_bn_stat(sd):
    del sd["res2plus1d.conv5.block1.downsamplebn.running_var"]


#: (case, how the state dict is broken, classes the caller asks for, the
#: port's message): tests/test_convert.py's cases first
ERROR_CASES = [
    ("missing-key", _drop_conv, 8,
     r"state dict is missing 'res2plus1d\.conv2\.block1\.conv1\."
     r"spatial_conv\.weight'"),
    ("wrong-shape", _cut_linear, 8,
     r"converted linear\.weight has shape \(8, 100\), architecture "
     r"wants \(8, 512\)"),
    ("wrong-class-count", None, 400,
     r"converted linear\.weight has shape \(8, 512\), architecture "
     r"wants \(400, 512\)"),
    ("conv-not-5d", _flat_conv, 8, r"conv weight must be 5-D"),
    ("bias-not-1d", _flat_bias, 8,
     r"'linear\.bias' has 2 dims, expected 1"),
    ("missing-bn-stat", _drop_bn_stat, 8,
     r"state dict is missing 'res2plus1d\.conv5\.block1\.downsamplebn\."
     r"running_var'"),
]


@pytest.mark.parametrize("case,breaks,classes,message", ERROR_CASES,
                         ids=[c[0] for c in ERROR_CASES])
def test_conversion_errors_are_the_references(case, breaks, classes,
                                              message):
    sd = synth_state_dict()
    if breaks is not None:
        breaks(sd)
    with pytest.raises(jax_convert.ConversionError) as theirs:
        jax_convert.convert_state_dict(sd, num_classes=classes,
                                       layer_sizes=LS)
    with pytest.raises(ConversionError, match=message) as ours:
        convert_state_dict(sd, num_classes=classes, layer_sizes=LS)
    assert isinstance(ours.value, ValueError)
    if case not in ("wrong-shape", "wrong-class-count"):
        # the same text wherever the message names a torch key (the
        # shape checks name each package's own key and layout)
        assert str(ours.value) == str(theirs.value)


def test_convert_file_reads_a_payload_and_the_cli_runs(tmp_path):
    sd = synth_state_dict(sane=True)
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    pth = str(tmp_path / "model_data.pth.tar")
    torch.save({"state_dict": tensors, "epoch": 45}, pth)
    out = str(tmp_path / "converted.pt")
    assert convert_file(pth, out, num_classes=CLASSES,
                        layer_sizes=LS) == out
    _assert_same(ckpt.load_checkpoint(out),
                 convert_state_dict(sd, num_classes=CLASSES, layer_sizes=LS))
    # a bare state dict is its own payload
    bare = str(tmp_path / "bare.pth")
    torch.save(tensors, bare)
    assert torch.equal(ckpt.load_checkpoint(convert_file(
        bare, str(tmp_path / "bare.pt"), CLASSES, LS))["linear.weight"],
        tensors["linear.weight"])
    # the file is data: a payload holding code is refused
    evil = str(tmp_path / "evil.pth")
    torch.save({"state_dict": tensors, "hook": functools.partial(print)},
               evil)
    with pytest.raises(Exception, match="[Ww]eights only"):
        convert_file(evil, str(tmp_path / "evil.pt"), CLASSES, LS)
    # the reference's CLI (the default architecture): R(2+1)D-18 keys
    sd18 = {k: torch.from_numpy(v) for k, v in synth_state_dict(
        400, (2, 2, 2, 2), sane=True).items()}
    torch.save({"state_dict": sd18}, str(tmp_path / "r18.pth.tar"))
    proc = subprocess.run(
        [sys.executable, "-m", "rnb_tpu_torch.models.r2p1d.convert",
         str(tmp_path / "r18.pth.tar"), str(tmp_path / "r18.pt")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(tmp_path / "r18.pt")
    assert len(ckpt.load_checkpoint(str(tmp_path / "r18.pt"))) == 202


def test_a_reference_torch_file_named_as_a_checkpoint_is_refused(tmp_path):
    path = str(tmp_path / "model_data.pth.tar")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               synth_state_dict().items()}}, path)
    with pytest.raises(ValueError, match="convert it first"):
        ckpt.load_checkpoint(path)


# -- the reference's msgpack files ----------------------------------------

@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    """A seeded factored tree of the JAX package and its msgpack file."""
    variables = jax_ckpt.init_variables(seed=1, num_classes=CLASSES,
                                        layer_sizes=LS,
                                        factored_shortcut=True)
    path = str(tmp_path_factory.mktemp("tree") / "tree.msgpack")
    jax_ckpt.save_checkpoint(path, variables)
    return variables, path


def _norm(x):
    if isinstance(x, memoryview):
        return bytes(x)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_norm(v) for v in x]
    return x


@pytest.mark.parametrize("single_float", [False, True])
def test_the_msgpack_reader_decodes_what_msgpack_encodes(single_float):
    obj = {"nil": None, "yes": True, "no": False, "fix": 5, "neg": -5,
           "u8": 200, "u16": 60000, "u32": 2 ** 31, "u64": 2 ** 63,
           "i8": -100, "i16": -30000, "i32": -2 ** 31, "i64": -2 ** 40,
           "float": 1.5, "str": "s" * 40, "str16": "x" * 70000,
           "bin": b"b" * 300, "bin32": b"y" * 70000, "arr": list(range(20)),
           "nest": [[], {}, {"a": [None]}],
           "map16": {str(i): i for i in range(20)}}
    data = msgpack.packb(obj, use_bin_type=True,
                         use_single_float=single_float)
    assert _norm(ckpt.read_flax_msgpack(data)) == obj
    with pytest.raises(ValueError, match="ends 1 bytes early"):
        ckpt.read_flax_msgpack(data[:-1])
    with pytest.raises(ValueError, match="follow the msgpack object"):
        ckpt.read_flax_msgpack(data + b"\x00")


@pytest.mark.parametrize("tree", ["seeded", "converted"])
def test_the_references_files_read_bitwise(tmp_path, jax_tree, tree):
    if tree == "seeded":
        variables = jax_tree[0]
    else:
        variables = jax_convert.convert_state_dict(
            synth_state_dict(sane=True), num_classes=CLASSES,
            layer_sizes=LS)
    path = str(tmp_path / "ref.msgpack")
    jax_ckpt.save_checkpoint(path, variables)
    _assert_same(ckpt.load_checkpoint(path),
                 ckpt.from_jax_variables(variables))


def test_flax_ndarray_leaves_of_another_dtype():
    """A float16 leaf, widened to the port's float32."""
    from flax import serialization
    tree = {"params": {"linear": {
        "kernel": np.linspace(-2, 2, 24).reshape(3, 8).astype(np.float16),
        "bias": np.linspace(-1, 1, 8).astype(np.float16)}}}
    got = ckpt.from_jax_variables(ckpt.read_flax_msgpack(
        serialization.msgpack_serialize(tree)))
    linear = tree["params"]["linear"]
    assert np.array_equal(got["linear.weight"].numpy(),
                          linear["kernel"].astype(np.float32).T)
    assert np.array_equal(got["linear.bias"].numpy(),
                          linear["bias"].astype(np.float32))


def test_other_ext_types_and_chunked_leaves_are_refused(tmp_path, jax_tree,
                                                        monkeypatch):
    from flax import serialization
    scalar = serialization.msgpack_serialize({"a": np.float32(1.0)})
    with pytest.raises(ValueError, match="ext type 3 is not flax's ndarray"):
        ckpt.read_flax_msgpack(scalar)
    other = msgpack.packb({"a": msgpack.ExtType(7, b"xy")})
    with pytest.raises(ValueError, match="ext type 7"):
        ckpt.read_flax_msgpack(other)
    # flax chunks leaves over MAX_CHUNK_SIZE bytes: made small, the
    # reference's own file holds chunks, which flax reads and the port
    # refuses
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    variables, _ = jax_tree
    path = str(tmp_path / "chunked.msgpack")
    jax_ckpt.save_checkpoint(path, variables)
    restored = jax_ckpt.load_checkpoint(path)
    assert np.array_equal(restored["params"]["linear"]["kernel"],
                          variables["params"]["linear"]["kernel"])
    with pytest.raises(ValueError, match="chunked array"):
        ckpt.load_checkpoint(path)


# -- the port's own format ----------------------------------------------

def test_save_and_load_round_trip_bitwise(tmp_path):
    state = ckpt.init_variables(5, 1, NUM_LAYERS, CLASSES, LS, True)
    state["net.conv1.bn.running_var"] = torch.rand(83) + 0.5
    path = str(tmp_path / "sub" / "own.pt")
    ckpt.save_checkpoint(path, state)
    assert os.listdir(str(tmp_path / "sub")) == ["own.pt"]
    with open(path, "rb") as f:
        assert f.read(4) == b"PK\x03\x04"
    _assert_same(ckpt.load_checkpoint(path), state)
    # the store writes float32 on the CPU whatever it is handed
    half = {k: v.to(torch.bfloat16) for k, v in state.items()}
    ckpt.save_checkpoint(path, half)
    _assert_same(ckpt.load_checkpoint(path),
                 {k: v.float() for k, v in half.items()})


@pytest.fixture(scope="module")
def seeded_file(tmp_path_factory):
    """The default architecture's seeded init written by
    ``ensure_checkpoint`` (full R(2+1)D-18, 400 classes)."""
    path = str(tmp_path_factory.mktemp("ensure") / "seeded.pt")
    assert ckpt.ensure_checkpoint(path) == path
    return path


def test_ensure_checkpoint_writes_the_seeded_init_once(seeded_file):
    want = ckpt.init_variables(ckpt.WEIGHT_SEED)
    _assert_same(ckpt.load_checkpoint(seeded_file), want)
    stamp = os.stat(seeded_file).st_mtime_ns
    assert ckpt.ensure_checkpoint(seeded_file, seed=9) == seeded_file
    assert os.stat(seeded_file).st_mtime_ns == stamp
    assert ckpt.DEFAULT_CKPT_PATH.startswith(os.path.join(REPO,
                                                          "checkpoints"))
    assert ckpt.DEFAULT_CKPT_PATH != jax_ckpt.DEFAULT_CKPT_PATH


@pytest.mark.parametrize("start,end", RANGES)
def test_load_for_range_keeps_the_references_keys(jax_tree, start, end):
    variables, path = jax_tree
    want = ckpt.from_jax_variables(jax_ckpt.filter_layer_range(
        variables, start, end))
    _assert_same(ckpt.load_for_range(start, end, path), want)
    net = R2Plus1DClassifier(start, end, CLASSES, LS, True)
    assert set(want) == set(net.state_dict())


# -- load_or_init: the reference's three branches -------------------------

def test_an_explicit_path_must_exist_and_wins(tmp_path):
    missing = str(tmp_path / "nowhere.msgpack")
    with pytest.raises(FileNotFoundError) as theirs:
        jax_ckpt.load_or_init(1, NUM_LAYERS, CLASSES, LS, missing)
    with pytest.raises(FileNotFoundError) as ours:
        ckpt.load_or_init(1, NUM_LAYERS, CLASSES, LS, missing)
    assert str(ours.value) == str(theirs.value)
    assert "explicit ckpt_path %r does not exist" % missing in str(
        ours.value)
    # an existing file wins for any architecture, range-filtered
    state = convert_state_dict(synth_state_dict(sane=True), CLASSES, LS)
    path = str(tmp_path / "converted.pt")
    ckpt.save_checkpoint(path, state)
    _assert_same(ckpt.load_or_init(4, 5, CLASSES, LS, path,
                                   factored_shortcut=True),
                 ckpt.filter_layer_range(state, 4, 5))


@pytest.mark.parametrize("start,end", [(1, 5), (1, 4), (5, 5)])
def test_without_a_path_the_default_architecture_is_the_shared_init(
        seeded_file, start, end):
    ours = ckpt.load_or_init(start, end)
    _assert_same(ours, ckpt.load_for_range(start, end, seeded_file))


@pytest.mark.parametrize("classes,layer_sizes,factored", [
    (CLASSES, LS, False), (CLASSES, LS, True), (400, (2, 2, 2, 2), True)])
def test_any_other_architecture_gets_a_fresh_matching_init(
        classes, layer_sizes, factored):
    ours = ckpt.load_or_init(2, 5, classes, layer_sizes,
                             factored_shortcut=factored)
    net = R2Plus1DClassifier(2, 5, classes, layer_sizes, factored)
    assert set(ours) == set(net.state_dict())
    _assert_same(ours, ckpt.init_variables(ckpt.WEIGHT_SEED, 2, 5, classes,
                                           layer_sizes, factored))


# -- the stages, served from a file ---------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One synthetic reference checkpoint in both packages' formats: the
    reference's msgpack (its converter) and the port's file (the port's
    converter from the ``.pth.tar``)."""
    root = tmp_path_factory.mktemp("files")
    sd = synth_state_dict(sane=True, seed=7)
    pth = str(root / "model_data.pth.tar")
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in sd.items()}}, pth)
    ref = str(root / "ref.msgpack")
    jax_ckpt.save_checkpoint(ref, jax_convert.convert_state_dict(
        sd, num_classes=CLASSES, layer_sizes=LS))
    port = convert_file(pth, str(root / "port.pt"), CLASSES, LS)
    return {"msgpack": ref, "port": port}


def _assert_logits_close(got, want):
    # the slice tests' bf16 bound (tests/test_torch_slice.py): 2% of the
    # logit scale, the argmax equal past twice that margin
    bound = 0.02 * float(np.abs(want).max())
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= bound
    for g, w in zip(got, want):
        top2 = np.sort(w)[-2:]
        if top2[1] - top2[0] > 2 * bound:
            assert g.argmax() == w.argmax()


def _clips(rows, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (rows, FRAMES, 112, 112, 3)).astype(np.float32)


@pytest.mark.parametrize("which", ["msgpack", "port"])
def test_runner_from_a_file_matches_the_references(files, which):
    theirs = jax_model.R2P1DRunner(
        jax.devices()[0], num_classes=CLASSES, layer_sizes=LS, max_rows=3,
        consecutive_frames=FRAMES, num_warmups=1,
        ckpt_path=files["msgpack"], factored_shortcut=True)
    ours = port_model.R2P1DRunner(
        CPU, num_classes=CLASSES, layer_sizes=LS, max_rows=3,
        consecutive_frames=FRAMES, num_warmups=1,
        ckpt_path=files[which], factored_shortcut=True)
    assert ours.ckpt_path == files[which]
    x = _clips(3, 11)
    (want,), _, _ = theirs((JaxPadded(jnp.asarray(x, jnp.bfloat16), 3),),
                           None, JaxTimeCard(0))
    (got,), _, _ = ours((PaddedBatch(torch.from_numpy(x).to(
        torch.bfloat16), 3),), None, TimeCard(0))
    _assert_logits_close(got.data.numpy(), np.asarray(want.data))
    # float32: the file's network against flax on the reference's tree
    module = jax_net.R2Plus1DClassifier(
        num_classes=CLASSES, layer_sizes=LS, factored_shortcut=True,
        dtype=jnp.float32)
    variables = jax_ckpt.load_or_init(1, NUM_LAYERS, CLASSES, LS,
                                      files["msgpack"])
    flax_out = np.asarray(jax.jit(functools.partial(
        module.apply, train=False))(variables, x))
    net = port_model.shared_network(1, NUM_LAYERS, CLASSES, LS,
                                    torch.device("cpu"), torch.float32,
                                    factored_shortcut=True,
                                    ckpt_path=files[which])
    with torch.inference_mode():
        f32 = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(f32, flax_out, rtol=F32_TOL, atol=F32_TOL)


def test_both_formats_of_one_file_share_nothing_but_their_values(files):
    a = port_model.shared_network(1, NUM_LAYERS, CLASSES, LS,
                                  torch.device("cpu"),
                                  factored_shortcut=True,
                                  ckpt_path=files["msgpack"])
    b = port_model.shared_network(1, NUM_LAYERS, CLASSES, LS,
                                  torch.device("cpu"),
                                  factored_shortcut=True,
                                  ckpt_path=files["port"])
    assert a is not b
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    # a relative and an absolute name of one file share one network
    rel = os.path.relpath(files["port"])
    assert port_model.shared_network(
        1, NUM_LAYERS, CLASSES, LS, torch.device("cpu"),
        factored_shortcut=True, ckpt_path=rel) is b


def test_split_stages_hold_only_their_range(files):
    x = _clips(2, 12)
    whole = port_model.R2P1DRunner(
        CPU, num_classes=CLASSES, layer_sizes=LS, max_rows=2,
        consecutive_frames=FRAMES, num_warmups=0,
        ckpt_path=files["port"], factored_shortcut=True)
    front = port_model.R2P1DRunner(
        CPU, start_index=1, end_index=4, num_classes=CLASSES,
        layer_sizes=LS, max_rows=2, consecutive_frames=FRAMES,
        num_warmups=0, ckpt_path=files["port"], factored_shortcut=True)
    back = port_model.R2P1DRunner(
        CPU, start_index=5, end_index=5, num_classes=CLASSES,
        layer_sizes=LS, max_rows=2, consecutive_frames=FRAMES,
        num_warmups=0, ckpt_path=files["port"], factored_shortcut=True)
    full = ckpt.load_checkpoint(files["port"])
    for stage, (start, end) in ((front, (1, 4)), (back, (5, 5))):
        held = stage.network.state_dict()
        assert set(held) == set(ckpt.filter_layer_range(full, start, end))
        for key, value in held.items():
            assert torch.equal(value, full[key].to(value.dtype)), key
    pb = PaddedBatch(torch.from_numpy(x).to(torch.bfloat16), 2)
    (feat,), _, _ = front((pb,), None, TimeCard(0))
    (split,), _, _ = back((feat,), None, TimeCard(0))
    (logits,), _, _ = whole((pb,), None, TimeCard(0))
    assert torch.equal(split.data, logits.data)


def test_a_sharded_stage_splits_the_loaded_tree(files):
    kwargs = dict(num_classes=CLASSES, layer_sizes=LS, max_rows=2,
                  consecutive_frames=FRAMES, num_warmups=0,
                  ckpt_path=files["port"], factored_shortcut=True)
    plain = port_model.R2P1DRunner(CPU, **kwargs)
    sharded = port_model.R2P1DRunner(CPU, shard_degree=2, **kwargs)
    full = ckpt.load_checkpoint(files["port"])
    shards = sharded.network.linear.weight_shards
    assert torch.equal(torch.cat([s.float() for s in shards]),
                       full["linear.weight"].to(shards[0].dtype).float())
    pb = PaddedBatch(torch.from_numpy(_clips(2, 13)).to(torch.bfloat16), 2)
    (a,), _, _ = plain((pb,), None, TimeCard(0))
    (b,), _, _ = sharded((pb,), None, TimeCard(0))
    assert torch.equal(a.data, b.data)


def test_a_converted_file_needs_the_factored_shortcut(files):
    with pytest.raises(RuntimeError, match="Missing key"):
        port_model.R2P1DRunner(CPU, num_classes=CLASSES, layer_sizes=LS,
                               max_rows=1, consecutive_frames=FRAMES,
                               num_warmups=0, ckpt_path=files["port"])


def test_a_missing_path_fails_the_stage_as_the_reference(tmp_path):
    missing = str(tmp_path / "typo.pt")
    with pytest.raises(FileNotFoundError) as theirs:
        jax_model.R2P1DRunner(jax.devices()[0], num_classes=CLASSES,
                              layer_sizes=LS, max_rows=1,
                              consecutive_frames=FRAMES, num_warmups=0,
                              ckpt_path=missing)
    with pytest.raises(FileNotFoundError) as ours:
        port_model.R2P1DRunner(CPU, num_classes=CLASSES, layer_sizes=LS,
                               max_rows=1, consecutive_frames=FRAMES,
                               num_warmups=0, ckpt_path=missing)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("pixel_path", ["rgb", "yuv420"])
def test_single_step_from_a_file_matches_the_references(tmp_path, files,
                                                        pixel_path):
    frames = np.random.default_rng(3).integers(0, 256, (20, 112, 112, 3),
                                               dtype=np.uint8)
    video = str(tmp_path / "v.y4m")
    write_y4m(video, frames, colorspace="420")
    kwargs = dict(num_classes=CLASSES, layer_sizes=LS, max_clips=2,
                  consecutive_frames=FRAMES, num_warmups=0,
                  factored_shortcut=True, num_clips_population=[2],
                  weights=[1], pixel_path=pixel_path)
    theirs = jax_model.R2P1DSingleStep(jax.devices()[0],
                                       ckpt_path=files["msgpack"], **kwargs)
    want = int(theirs(None, video, JaxTimeCard(0))[1])
    full = ckpt.load_checkpoint(files["port"])
    for which in ("msgpack", "port"):
        ours = port_model.R2P1DSingleStep(CPU, ckpt_path=files[which],
                                          **kwargs)
        assert ours.net.factored_shortcut
        for key, value in ours.net.network.state_dict().items():
            assert torch.equal(value, full[key].to(value.dtype)), key
        tensors, pred, _ = ours(None, video, TimeCard(0))
        assert tensors is None and pred == want


@pytest.mark.parametrize("n", [2, 3], ids=["divisible", "padded"])
def test_mesh_runner_from_a_file_matches_the_references(files, n):
    tiny = dict(max_clips=2, consecutive_frames=FRAMES,
                num_classes=CLASSES, layer_sizes=list(LS), num_warmups=1,
                factored_shortcut=True)
    theirs = jax_model.R2P1DMeshRunner(device=jax.devices()[0],
                                       mesh_devices=list(range(n)),
                                       ckpt_path=files["msgpack"], **tiny)
    ours = port_model.R2P1DMeshRunner(
        CPU, [DeviceSpec(i, "cpu") for i in range(n)],
        ckpt_path=files["port"], **tiny)
    net = port_model.shared_network(1, NUM_LAYERS, CLASSES, LS,
                                    torch.device("cpu"),
                                    factored_shortcut=True,
                                    ckpt_path=files["port"])
    rng = np.random.default_rng(20 + n)
    clips = rng.integers(0, 256, (2, FRAMES, 112, 112, 3), dtype=np.uint8)
    for valid in (1, 2):
        _, pred, _ = ours((PaddedBatch(torch.from_numpy(clips), valid),),
                          None, TimeCard(valid))
        with torch.inference_mode():
            plain = net(port_model.normalize_u8(
                torch.from_numpy(clips[:valid]))).sum(dim=0)
        _, their_pred, _ = theirs((JaxPadded(jnp.asarray(clips), valid),),
                                  None, JaxTimeCard(valid))
        assert int(pred[0]) == int(plain.argmax()) == int(
            np.asarray(their_pred)[0])


# -- config ---------------------------------------------------------------

NETWORK_STEPS = (".R2P1DRunner", ".R2P1DSingleStep", ".R2P1DMeshRunner")
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))


def test_every_shipped_config_is_counted():
    assert len(CONFIGS) == 41


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_every_shipped_config_reads_with_a_ckpt_path(path):
    with open(path) as f:
        raw = json.load(f)
    named = 0
    for step in raw["pipeline"]:
        if step["model"].endswith(NETWORK_STEPS):
            step["ckpt_path"] = "checkpoints/converted.pt"
            named += 1
    config = parse_config(raw, platform="cpu")
    kwargs = [s.kwargs for s in config.steps
              if s.model.endswith(NETWORK_STEPS)]
    assert len(kwargs) == named
    assert all(k["ckpt_path"] == "checkpoints/converted.pt" for k in kwargs)

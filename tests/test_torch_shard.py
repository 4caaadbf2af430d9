"""Intra-stage sharding in the port (``rnb_tpu_torch.ops.handoff_dma``,
``rnb_tpu_torch.parallel``) held to the JAX package's, on the CPU.

JAX runs its rings on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's ring members all lie on the CPU, where the ring wrapper runs
its plain version. Inputs come from numpy seeds. What is held:

* the collectives: ``ring_shift`` bitwise the reference's ppermute twin
  at degrees 1, 2, 4 and 8, every shift, in uint8, bfloat16 and float32;
  ``ring_all_gather`` bitwise at degrees 1, 2 and 4 on axis 0 and -1;
  ``ring_psum_scatter`` bitwise on random float32 (the same ring order);
* the plan: ``is_sharded_param`` picks the reference's 19 leaves name
  for name; ``split_param_bytes``, ``projected_device_mb`` and
  ``min_feasible_degree`` equal the reference's on the same float32
  tree; ``shardable_widths`` and ``validate_degree`` with its messages;
  the port's own bytes at rest (bfloat16 kernels) beside the
  reference's float32 ones;
* the sharded stage: degree 2 and 4 logits bitwise the port's degree 1
  on the rgb, yuv420 and dct paths and ragged whole-pool (valid 1 and
  2); the sharded network within rtol = atol = 5e-4 of the reference's
  sharded forward in float32 on shared parameters (the bound of
  ``tests/test_torch_network.py``) and the served bf16 logits within 2%
  of the logit scale of the reference's sharded runner; a [1..4] stage
  has no merge; every member's gathered weight is bitwise the same and
  laid out as the unsharded one;
* the config: ``shard`` and its messages equal the reference's, both
  shipped shard configs read, the launch rejection and its message, and
  a ring over two distinct cards raises;
* end to end: a reduced shard-d2 copy and its d1 twin served by the
  port's ``run_benchmark``, logits equal, the job directories read by
  the reference's ``Shard:`` readers and ``_check_shard`` with no
  problem, and the port's check finding what the reference's finds in
  tampered copies.
"""

import copy
import json
import os
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from rnb_tpu import config as jax_config
from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d import network as jax_net
from rnb_tpu.models.r2p1d.model import R2P1DRunner as JaxRunner
from rnb_tpu.ops import handoff_dma as jax_dma
from rnb_tpu.parallel import shardplan as jax_plan
from rnb_tpu.stage import PaddedBatch as JaxPadded
from rnb_tpu.telemetry import TimeCard as JaxCard
from rnb_tpu_torch.config import ConfigError, load_config, parse_config
from rnb_tpu_torch.decode import SyntheticDecoder, write_y4m
from rnb_tpu_torch.models.r2p1d import model as port_model
from rnb_tpu_torch.models.r2p1d import network as network_mod
from rnb_tpu_torch.models.r2p1d.checkpoint import from_jax_variables
from rnb_tpu_torch.models.r2p1d.model import R2P1DRunner
from rnb_tpu_torch.models.r2p1d.network import (LAYER_INPUT_SHAPES, Conv3d,
                                                R2Plus1DClassifier,
                                                cast_compute_weights)
from rnb_tpu_torch.ops import handoff_dma
from rnb_tpu_torch.ops.yuv import packed_frame_bytes
from rnb_tpu_torch.parallel import mesh, shardplan
from rnb_tpu_torch.parse_utils import read_meta, shard_problems, summarize
from rnb_tpu_torch.stage import PaddedBatch, RaggedBatch
from rnb_tpu_torch.telemetry import TimeCard
from torch_job_checks import assert_both_checks_pass

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D1 = os.path.join(REPO, "configs", "rnb-shard-d1.json")
D2 = os.path.join(REPO, "configs", "rnb-shard-d2.json")
LS = (1, 1, 1, 1)
CLASSES = 8
CPU = torch.device("cpu")
MIB = 1 << 20


def _ring(degree):
    return shardplan.build_shard_ring([CPU] * degree, degree)


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("tp",))


def _torch(array):
    """A numpy array (ml_dtypes bfloat16 included) as a torch tensor."""
    array = np.ascontiguousarray(array)
    if array.dtype == jnp.bfloat16:
        return torch.from_numpy(array.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(array)


def _bytes(t):
    return t.contiguous().view(torch.uint8).numpy()


def _shard_along(x, n, axis, ring=None):
    """``x`` cut into ``n`` member shards along ``axis``, each its own
    dense copy (what the reference's shard_map in_spec does)."""
    shards = [c.clone() for c in torch.chunk(x, n, dim=axis)]
    if ring is not None:
        shards = [s.to(d) for s, d in zip(shards, ring.devices)]
    return shards


# -- the collectives -----------------------------------------------------

_DTYPES = {"uint8": np.uint8, "bfloat16": jnp.bfloat16, "float32": np.float32}


def _values(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.standard_normal(shape).astype(_DTYPES[dtype])


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("degree,shift", [(n, s) for n in (1, 2, 4, 8)
                                          for s in range(n)])
def test_ring_shift_is_bitwise_the_reference_twin(degree, shift, dtype):
    # tolerance: none (the hop moves bytes)
    full = _values(dtype, (degree * 3, 5), seed=degree * 10 + shift)
    mesh_ = Mesh(np.array(jax.devices()[:degree]), ("x",))
    x = jax.device_put(jnp.asarray(full),
                       NamedSharding(mesh_, PartitionSpec("x")))
    want = np.asarray(jax_dma.ring_shift(x, mesh_, "x", shift=shift,
                                         use_pallas=False))
    shards = _shard_along(_torch(full), degree, axis=0)
    got = handoff_dma.ring_shift(shards, shift)
    assert len(got) == degree
    assert np.array_equal(_bytes(torch.cat(got)), _bytes(_torch(want)))
    if shift == 0:
        # the identity, as the reference's: no buffer moves
        assert all(a is b for a, b in zip(got, shards))
    else:
        assert not any(a is b for a, b in zip(got, shards))


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("degree", [1, 2, 4, 8])
def test_ring_all_gather_is_bitwise_the_reference(degree, axis):
    full = _values("float32", (8, 3, 8), seed=degree + 31 * (axis + 2))
    spec = [None] * 3
    spec[axis] = "tp"
    x = jax.device_put(jnp.asarray(full),
                       NamedSharding(_mesh(degree), PartitionSpec(*spec)))
    want = np.asarray(jax_dma.ring_all_gather(x, _mesh(degree), axis=axis,
                                              use_pallas=False))
    assert np.array_equal(want, full)
    ring = _ring(degree)
    got = handoff_dma.ring_all_gather(
        _shard_along(_torch(full), degree, axis, ring), ring,
        axis)
    assert len(got) == degree
    for member in got:
        assert np.array_equal(member.numpy(), want)


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("degree", [1, 2, 4, 8])
def test_ring_all_gather_many_is_bitwise_the_reference(degree, axis):
    # several leaves of other shapes in the same n - 1 tables, each held
    # to the reference's gather of it
    leaves, wants = [], []
    for k, shape in enumerate(((8, 3, 8), (16, 8), (8, 2, 2, 8))):
        full = _values("float32", shape, seed=degree * 3 + k + 11 * (axis + 2))
        spec = [None] * len(shape)
        spec[axis] = "tp"
        x = jax.device_put(jnp.asarray(full), NamedSharding(
            _mesh(degree), PartitionSpec(*spec)))
        wants.append(np.asarray(jax_dma.ring_all_gather(
            x, _mesh(degree), axis=axis, use_pallas=False)))
        leaves.append(_shard_along(_torch(full), degree, axis))
    got = handoff_dma.ring_all_gather_many(leaves, axis)
    assert len(got) == len(leaves)
    for members, want in zip(got, wants):
        assert len(members) == degree
        for member in members:
            assert np.array_equal(member.numpy(), want)
            assert member.is_contiguous()


@pytest.mark.parametrize("degree", [2, 4])
def test_the_grouped_gather_takes_degree_minus_one_tables(degree,
                                                          monkeypatch):
    # at degree 2 one table (one launch on the card) whatever the number
    # of leaves: own slots and the first hop ride together
    tables = []
    plain = handoff_dma.ring_shift_group

    def counted(table):
        tables.append(len(list(table)))
        return plain(table)
    monkeypatch.setattr(handoff_dma, "ring_shift_group", counted)
    leaves = [_shard_along(torch.arange(degree * k * 3.0).view(-1, 3),
                           degree, 0) for k in (1, 2, 5)]
    handoff_dma.ring_all_gather_many(leaves, 0)
    # the first table: own slot and first hop of each leaf; then a hop
    # entry a leaf
    assert tables == [2 * len(leaves)] + [len(leaves)] * (degree - 2)


def _group(n, shift=1, shapes=None):
    shapes = shapes or [(4,)] * (2 * n)
    tensors = [torch.zeros(s) for s in shapes]
    return handoff_dma.RingEntry(tensors[:n], tensors[n:], shift)


@pytest.mark.parametrize("entry,message", [
    (_group(2, shift=2), "shift 2 outside 0..1"),
    (_group(2, shift=-1), "shift -1 outside 0..1"),
    (_group(2, shapes=[(4,), (4,), (4,), (5,)]), "one dtype and shape"),
    (handoff_dma.RingEntry([torch.zeros(4)] * 2, [torch.zeros(4)] * 3, 1),
     "2 sources and 3 destinations"),
    (_group(9), "1 to 8 members")])
def test_the_grouped_hop_refuses_a_malformed_table(entry, message):
    # the same refusals on the plain path as on the card's
    for fn in (handoff_dma.ring_shift_group,
               handoff_dma.ring_shift_group_reference):
        with pytest.raises(ValueError, match=message):
            fn([entry])


def test_the_grouped_hop_writes_rows_at_a_pitch_on_the_plain_path():
    # the merge's entry: (15, 200) float32 blocks into column blocks of
    # (15, 400) results, each member's own (shift 0) and its neighbour's
    # (shift 1) in one table
    blocks = [torch.from_numpy(_values("float32", (15, 200), seed=m))
              for m in range(2)]
    full = [torch.full((15, 400), float("nan")) for _ in range(2)]
    slots = [[f[:, :200], f[:, 200:]] for f in full]
    handoff_dma.ring_shift_group([
        handoff_dma.RingEntry(blocks, [slots[0][0], slots[1][1]], 0),
        handoff_dma.RingEntry(blocks, [slots[0][1], slots[1][0]], 1)])
    for f in full:
        assert torch.equal(f, torch.cat(blocks, dim=-1))


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("degree", [1, 2, 4, 8])
def test_ring_psum_scatter_is_bitwise_the_reference(degree, axis):
    # random float32 (not exactly representable sums): the port adds in
    # the reference's ring order, so the chunks are bitwise equal
    stack = _values("float32", (degree, 8, 16), seed=degree + 7 * (axis + 2))
    want = np.asarray(jax_dma.ring_psum_scatter(
        jnp.asarray(stack), _mesh(degree), axis=axis, use_pallas=False))
    chunks = handoff_dma.ring_psum_scatter(
        [_torch(s) for s in stack], _ring(degree), axis)
    got = torch.cat(chunks, dim=axis).numpy()
    assert np.array_equal(got, want)
    assert np.abs(got - stack.sum(axis=0)).max() < 1e-5


def test_the_collectives_refuse_what_the_reference_refuses():
    with pytest.raises(ValueError, match="not divisible"):
        handoff_dma.ring_psum_scatter([torch.zeros(2, 7)] * 2)
    with pytest.raises(ValueError, match="2 tensors for a ring of 4"):
        handoff_dma.ring_all_gather([torch.zeros(2)] * 2, _ring(4))
    with pytest.raises(ValueError, match="1 to 8 members"):
        handoff_dma.ring_shift([torch.zeros(2)] * 9)


def test_a_cuda_or_meta_member_never_takes_the_plain_version():
    # a ring wrapper given a tensor off the CPU launches or raises
    meta = [torch.empty(4, device="meta")] * 2
    with pytest.raises(ValueError, match="cuda tensors"):
        handoff_dma.ring_shift(meta)
    mixed = [torch.zeros(4), torch.empty(4, device="meta")]
    with pytest.raises(ValueError, match="cuda tensors"):
        handoff_dma.ring_shift(mixed)
    with pytest.raises(ValueError, match="cuda tensors"):
        handoff_dma.ring_all_gather_many([meta], 0)


# -- the ring ------------------------------------------------------------

def test_a_ring_over_two_distinct_cards_raises_not_yet_ported():
    with pytest.raises(NotImplementedError,
                       match=r"2 distinct devices \(cuda:0, cuda:1\) is "
                             r"not yet ported.*ROADMAP"):
        shardplan.build_shard_ring([torch.device("cuda", 0),
                                    torch.device("cuda", 1)], 2)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        mesh.Ring(["cpu", "cuda:0"])
    # members may repeat one device, which a jax Mesh cannot
    ring = mesh.Ring([torch.device("cuda", 0)] * 4)
    assert ring.degree == 4 and ring.device == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="exactly degree=2 devices, got 3"):
        shardplan.build_shard_ring([CPU] * 3, 2)


# -- the plan --------------------------------------------------------------

def _port_name(path):
    """A flax variable path (collection first) as the port's name."""
    collection, *keys, leaf = path
    leaf = {"params": {"kernel": "weight", "scale": "weight",
                       "bias": "bias"},
            "batch_stats": {"mean": "running_mean",
                            "var": "running_var"}}[collection][leaf]
    return ".".join(keys + [leaf])


def _abstract_pair(start, end, num_classes, layer_sizes, factored):
    """The reference's abstract float32 tree (``jax.eval_shape``) and
    the port's float32 state dict on the meta device."""
    module = jax_net.R2Plus1DClassifier(
        start=start, end=end, num_classes=num_classes,
        layer_sizes=layer_sizes, factored_shortcut=factored)
    shape = LAYER_INPUT_SHAPES[start]
    tree = jax.eval_shape(
        lambda k, x: module.init(k, x, train=False), jax.random.key(0),
        jax.ShapeDtypeStruct((1, 2, 14, 14, shape[-1]), np.float32))
    with torch.device("meta"):
        port = R2Plus1DClassifier(start, end, num_classes, layer_sizes,
                                  factored, dtype=torch.float32)
    return tree, port


def _flat(tree, prefix=()):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(_flat(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out


@pytest.mark.parametrize("start,end,classes,factored,sharded_leaves", [
    (1, 5, 400, False, 19), (1, 5, 400, True, 22), (1, 4, 400, False, 13),
    (3, 5, 8, False, 14), (5, 5, 8, False, 6)])
def test_the_plan_equals_the_reference_on_one_float32_tree(
        start, end, classes, factored, sharded_leaves):
    layer_sizes = (2, 2, 2, 2)
    tree, port = _abstract_pair(start, end, classes, layer_sizes, factored)
    ref_names = {_port_name(path) for path in _flat(tree)
                 if jax_plan.is_sharded_param(path[1:])}
    state = port.state_dict()
    assert set(map(_port_name, _flat(tree))) == set(state)
    ours = {name for name in state if shardplan.is_sharded_param(name)}
    assert ours == ref_names and len(ours) == sharded_leaves
    assert shardplan.split_param_bytes(state) == \
        jax_plan.split_param_bytes(tree)
    rep, sh = shardplan.split_param_bytes(state)
    for degree in (1, 2, 4, 8):
        for pool in (0, 2257920):
            assert shardplan.projected_device_mb(rep, sh, pool, degree) == \
                jax_plan.projected_device_mb(rep, sh, pool, degree)
    for budget in (1.0, 10.0, 60.0, 100.0, 130.0, 1000.0):
        assert shardplan.min_feasible_degree(rep, sh, 0, budget) == \
            jax_plan.min_feasible_degree(rep, sh, 0, budget)
    assert shardplan.shardable_widths(start, end, classes) == \
        jax_plan.shardable_widths(start, end, classes)


def _raised(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 — the message is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("degree,start,end,classes", [
    (3, 1, 5, 8), (16, 1, 5, 8), (0, 1, 5, 8), (4, 1, 5, 8),
    (8, 2, 4, 400), (3, 2, 4, 400), (2, 5, 5, 7)])
def test_validate_degree_raises_as_the_reference(degree, start, end, classes):
    assert _raised(shardplan.validate_degree, degree, start, end, classes) \
        == _raised(jax_plan.validate_degree, degree, start, end, classes)


def _port_bytes_at_rest():
    """The shipped network's (replicated, sharded) bytes as the port
    keeps them: bfloat16 kernels, float32 BatchNorm."""
    with torch.device("meta"):
        net = cast_compute_weights(R2Plus1DClassifier(1, 5, 400))
    return shardplan.split_param_bytes(net.state_dict())


def test_the_projection_counts_the_port_s_own_bytes_at_rest():
    # the reference's float32 tree: 92.5 MiB replicated, 34.9 sharded,
    # so 129.6 MiB at degree 1 and 112.1 at degree 2 with the 15-row
    # yuv420 pool, around its 120 MiB budget; the port keeps bfloat16
    # kernels, about half of those, so the budget launches both arms
    tree, _ = _abstract_pair(1, 5, 400, (2, 2, 2, 2), False)
    ref_rep, ref_sh = jax_plan.split_param_bytes(tree)
    pool = 15 * 8 * packed_frame_bytes(112, 112)
    assert round(ref_rep / MIB, 1) == 92.5 and round(ref_sh / MIB, 1) == 34.9
    assert round(jax_plan.projected_device_mb(ref_rep, ref_sh, pool, 1),
                 1) == 129.6
    assert round(jax_plan.projected_device_mb(ref_rep, ref_sh, pool, 2),
                 1) == 112.1
    rep, sh = _port_bytes_at_rest()
    assert sh * 2 == ref_sh
    # every kernel halves; BatchNorm stays float32
    with torch.device("meta"):
        batchnorm = sum(
            v.numel() * 4 for v in cast_compute_weights(R2Plus1DClassifier(
                1, 5, 400)).state_dict().values()
            if v.dtype == torch.float32)
    assert rep == (ref_rep - batchnorm) // 2 + batchnorm
    d1 = shardplan.projected_device_mb(rep, sh, pool, 1)
    d2 = shardplan.projected_device_mb(rep, sh, pool, 2)
    assert (round(rep / MIB, 1), round(sh / MIB, 1)) == (46.4, 17.5)
    assert (round(d1, 1), round(d2, 1)) == (66.0, 57.2)
    assert d2 < d1 < 120.0
    assert shardplan.min_feasible_degree(rep, sh, pool, (d1 + d2) / 2) == 2


# -- the sharded stage ---------------------------------------------------------

def _wire(pixel_path, rows=2, seed=13):
    rng = np.random.RandomState(seed)
    if pixel_path == "yuv420":
        return torch.from_numpy(rng.randint(
            0, 256, (rows, 2, packed_frame_bytes(112, 112)), np.uint8))
    if pixel_path == "dct":
        return torch.from_numpy(SyntheticDecoder().decode_clips_dct(
            "synth://shard-parity-%d" % seed, list(range(0, 8 * rows, 8)),
            2, 112, 112))
    return torch.from_numpy(rng.uniform(-1, 1, (rows, 2, 112, 112, 3))
                            .astype(np.float32)).to(torch.bfloat16)


def _runner(pixel_path, **extra):
    kw = dict(start_index=1, end_index=5, num_classes=CLASSES,
              layer_sizes=LS, max_rows=2, consecutive_frames=2,
              num_warmups=1, pixel_path=pixel_path)
    kw.update(extra)
    return R2P1DRunner(CPU, **kw)


def _serve(runner, x, valid, ragged=False):
    batch = (RaggedBatch(x, valid, (0, valid)) if ragged
             else PaddedBatch(x, valid))
    (out,), _, _ = runner((batch,), None, TimeCard(0))
    assert isinstance(out, RaggedBatch) == ragged
    return out.data


@pytest.fixture(scope="module")
def unsharded():
    return {path: _runner(path) for path in ("rgb", "yuv420", "dct")}


@pytest.mark.parametrize("degree", [2, 4])
@pytest.mark.parametrize("pixel_path", ["rgb", "yuv420", "dct"])
def test_sharded_logits_are_bitwise_degree_1(unsharded, pixel_path, degree):
    x = _wire(pixel_path)
    want = _serve(unsharded[pixel_path], x, 2)
    sharded = _runner(pixel_path, shard_degree=degree)
    sharded.bind_shard_step(1)
    assert sharded.ring.degree == degree and sharded._merge is not None
    got = _serve(sharded, x, 2)
    assert torch.equal(got, want)
    stats = sharded.shard_stats
    assert (stats["gathers"], stats["rows"], stats["degree"]) == (1, 2,
                                                                   degree)
    assert stats["collective_ms"] > 0.0
    # one signature per arm, as the reference's
    sharded.compiles.freeze()
    _serve(sharded, x, 2)
    snap = sharded.compiles.snapshot()
    assert snap["warmup"] == 1 and snap["steady_new"] == 0


@pytest.mark.parametrize("valid", [1, 2])
@pytest.mark.parametrize("degree", [2, 4])
def test_sharded_ragged_whole_pool_is_bitwise_degree_1(degree, valid):
    x = _wire("yuv420", seed=17)
    base = _runner("yuv420", ragged=True, ragged_pool_rows=2,
                   ragged_chunk_rows=0)
    sharded = _runner("yuv420", ragged=True, ragged_pool_rows=2,
                      shard_degree=degree)
    assert sharded.ragged_chunk_rows == 0  # the auto chunk collapsed
    want = _serve(base, x, valid, ragged=True)
    got = _serve(sharded, x, valid, ragged=True)
    assert torch.equal(got[:valid], want[:valid])


def test_an_explicit_chunk_is_refused_with_a_degree_as_the_reference():
    message = ("ragged_chunk_rows=1 cannot be combined with shard_degree=2: "
               "the sharded applier is ONE whole-pool program")
    with pytest.raises(ValueError, match=re.escape(message)):
        _runner("yuv420", ragged=True, ragged_pool_rows=2,
                ragged_chunk_rows=1, shard_degree=2)
    with pytest.raises(ValueError, match=re.escape(message)):
        JaxRunner(jax.devices()[0], start_index=1, end_index=5,
                  num_classes=CLASSES, layer_sizes=LS, max_rows=2,
                  consecutive_frames=2, num_warmups=0, pixel_path="yuv420",
                  ragged=True, ragged_pool_rows=2, ragged_chunk_rows=1,
                  shard_degree=2)


def test_a_mid_pipeline_stage_has_no_merge_and_matches():
    x = _wire("yuv420", seed=19)
    base = _runner("yuv420", end_index=4)
    sharded = _runner("yuv420", end_index=4, shard_degree=2)
    assert sharded._merge is None
    sharded.bind_shard_step(1)  # a no-op without a merge
    assert sharded._sec_collective is None
    assert torch.equal(_serve(sharded, x, 2), _serve(base, x, 2))
    assert sharded.shard_stats["gathers"] == 0
    assert sharded.shard_stats["rows"] == 2


@pytest.mark.parametrize("degree", [2, 4])
def test_every_member_gathers_the_same_weight_laid_out_as_unsharded(degree):
    plain = port_model.shared_network(1, 5, CLASSES, LS, CPU)
    sharded = port_model.shared_network(1, 5, CLASSES, LS, CPU,
                                        shards=degree)
    plain_state = plain.state_dict()
    gathered = 0
    for name, module in sharded.named_modules():
        leaves = ([("weight", module.weight_shards)]
                  if isinstance(module, Conv3d) and module.shards > 1 else
                  [("weight", module.weight_shards),
                   ("bias", module.bias_shards)]
                  if name == "linear" else [])
        for leaf, shards in leaves:
            members = handoff_dma.ring_all_gather(list(shards), _ring(degree),
                                                  axis=0)
            want = plain_state["%s.%s" % (name, leaf)]
            for member in members:
                assert torch.equal(member, want)
                assert member.stride() == want.stride()
                assert member.dtype == want.dtype
            gathered += 1
    # the nine temporal kernels of layer sizes (1, 1, 1, 1) and the head's
    # weight and bias (R(2+1)D-18 has 17 and 2)
    assert gathered == 11
    # each member holds 1/degree of the sharded rows at rest
    assert sum(p.numel() for n, p in sharded.named_parameters()
               if "_shards." in n) == sum(
        p.numel() for n, p in plain.named_parameters()
        if shardplan.is_sharded_param(n))


@pytest.mark.parametrize("start,end", [(1, 5), (1, 4), (3, 5)])
@pytest.mark.parametrize("degree", [2, 4])
def test_the_grouped_gather_hands_each_op_the_per_leaf_gather(
        degree, start, end, monkeypatch):
    # tolerance: none. gather_leaves gathers every sharded leaf of the
    # network together: bitwise, and laid out, as each leaf's own
    # gather_shards, in degree - 1 tables; the forward takes it once
    net = cast_compute_weights(port_model.shared_network(
        start, end, CLASSES, LS, CPU, shards=degree))
    leaves = network_mod.sharded_leaves(net)
    # the temporal kernels of the range (one in the stem, two a layer of
    # layer sizes (1, 1, 1, 1)) and the head's weight and bias
    assert len(leaves) == {(1, 5): 11, (1, 4): 7, (3, 5): 8}[start, end]
    gathered = network_mod.gather_leaves(net)
    assert list(gathered) == leaves
    for shards in leaves:
        want = network_mod.gather_shards(shards)
        got = gathered[shards]
        assert torch.equal(got, want)
        assert got.stride() == want.stride() and got.dtype == want.dtype
    tables = []
    plain = handoff_dma.ring_shift_group

    def counted(table):
        tables.append(len(list(table)))
        return plain(table)
    monkeypatch.setattr(handoff_dma, "ring_shift_group", counted)
    rows = LAYER_INPUT_SHAPES[start]
    x = torch.zeros((1, 2) + rows[1:] if start == 1 else (1,) + rows,
                    dtype=torch.bfloat16)
    with torch.inference_mode():
        net(x)
    assert tables == [2 * len(leaves)] + [len(leaves)] * (degree - 2)


def _random_tree(tree, rng):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out[key] = _random_tree(value, rng)
        elif key == "kernel":
            fan_in = int(np.prod(value.shape[:-1]))
            out[key] = rng.normal(0.0, fan_in ** -0.5, value.shape)
        elif key in ("var", "scale"):
            out[key] = rng.uniform(0.5, 1.5, value.shape)
        else:
            out[key] = rng.normal(0.0, 0.3, value.shape)
        if not hasattr(value, "items"):
            out[key] = out[key].astype(np.float32)
    return out


@pytest.mark.parametrize("degree", [2, 4])
def test_the_sharded_network_matches_the_reference_s_in_float32(degree):
    # the reference's sharded applier in float32 (its shard_map over the
    # virtual devices) against the port's sharded network, both on one
    # random tree; bound: rtol = atol = 5e-4 (tests/test_torch_network.py)
    try:
        from jax.experimental.shard_map import shard_map
    except ImportError:  # newer jax spells it jax.shard_map
        shard_map = jax.shard_map
    module = jax_net.R2Plus1DClassifier(
        start=1, end=5, num_classes=CLASSES, layer_sizes=LS,
        dtype=jnp.float32, shards=degree, shard_axis="tp")
    x = np.random.default_rng(degree).normal(
        size=(2, 2, 16, 16, 3)).astype(np.float32)
    shapes = jax.eval_shape(
        lambda k: jax_net.R2Plus1DClassifier(
            start=1, end=5, num_classes=CLASSES, layer_sizes=LS,
            dtype=jnp.float32).init(k, x, train=False), jax.random.key(0))
    tree = {k: _random_tree(dict(v), np.random.default_rng(degree + 1))
            for k, v in shapes.items()}
    mesh_ = _mesh(degree)
    placed = jax_plan.shard_variables(tree, mesh_)
    body = shard_map(lambda v, xin: module.apply(v, xin, train=False),
                     mesh=mesh_, in_specs=(jax_plan.shard_param_specs(
                         placed), PartitionSpec()),
                     out_specs=PartitionSpec(None, "tp"), check_rep=False)
    want = np.asarray(jax.jit(body)(placed, x))
    ring = _ring(degree)
    net = shardplan.make_sharded_apply(1, 5, CLASSES, LS, ring,
                                       dtype=torch.float32)(
        from_jax_variables(tree))
    with torch.inference_mode():
        blocks = net(torch.from_numpy(x))
        got = shardplan.make_merge(ring)(blocks).numpy()
    assert len(blocks) == degree
    assert all(b.shape == (2, CLASSES // degree) for b in blocks)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("pixel_path,degree", [("yuv420", 2), ("dct", 4)])
def test_the_served_logits_match_the_reference_s_sharded_runner(
        pixel_path, degree):
    # both runners on the reference's seeded weights, bfloat16 as
    # served; bound: 2% of the logit scale (tests/test_torch_metrics.py)
    weights = jax_ckpt.load_or_init(1, 5, CLASSES, LS, None)
    ring = _ring(degree)
    net = shardplan.make_sharded_apply(1, 5, CLASSES, LS, ring)(
        from_jax_variables(weights))
    ours = _runner(pixel_path, shard_degree=degree, network=net)
    ref = JaxRunner(jax.devices()[0], start_index=1, end_index=5,
                    num_classes=CLASSES, layer_sizes=LS, max_rows=2,
                    consecutive_frames=2, num_warmups=1,
                    pixel_path=pixel_path, shard_degree=degree)
    x = _wire(pixel_path, seed=23)
    (want,), _, _ = ref((JaxPadded(jnp.asarray(x.numpy()), 2),), None,
                        JaxCard(0))
    want = np.asarray(want.data)
    got = _serve(ours, x, 2).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 0.02 * float(np.abs(want).max())
    assert ours.shard_stats["gathers"] == ref.shard_stats["gathers"] == 1


# -- the config ---------------------------------------------------------------

def _d2_raw():
    with open(D2) as f:
        return json.load(f)


def _mutate(case):
    raw = _d2_raw()
    runner = raw["pipeline"][1]
    group = runner["queue_groups"][0]
    if case == "degree-zero":
        runner["shard"]["degree"] = 0
    elif case == "degree-bool":
        runner["shard"]["degree"] = True
    elif case == "degree-str":
        runner["shard"]["degree"] = "2"
    elif case == "unknown-key":
        runner["shard"]["replicas"] = 2
    elif case == "not-an-object":
        runner["shard"] = 2
    elif case == "axis":
        runner["shard"]["axis"] = ""
    elif case == "budget":
        runner["shard"]["hbm_budget_mb"] = -1
    elif case == "devices-per-lane":
        group["devices"] = [1, 2, 3]
    elif case == "host":
        group["devices"] = [1, -1]
    elif case == "num-segments":
        runner["num_segments"] = 2
    return raw


@pytest.mark.parametrize("case", [
    "degree-zero", "degree-bool", "degree-str", "unknown-key",
    "not-an-object", "axis", "budget", "devices-per-lane", "host",
    "num-segments"])
def test_the_shard_key_is_refused_as_the_reference_refuses_it(case):
    raw = _mutate(case)
    with pytest.raises(jax_config.ConfigError) as ref:
        jax_config.parse_config(copy.deepcopy(raw))
    with pytest.raises(ConfigError) as ours:
        parse_config(raw, platform="cpu")
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("path", [D1, D2])
def test_both_shipped_shard_configs_read_as_the_reference_expands_them(path):
    cfg = load_config(path, platform="cpu")
    with open(path) as f:
        raw = json.load(f)
    ref = jax_config.parse_config(raw)
    ours = cfg.steps[1].kwargs_for_group(0)
    theirs = ref.steps[1].kwargs_for_group(0)
    for key in ("shard_degree", "shard_axis", "shard_hbm_budget_mb",
                "ragged_chunk_rows"):
        assert ours.get(key) == theirs.get(key), key
    assert [d.spec for d in ours["shard_devices"]] == theirs["shard_devices"]
    assert [d.resolve() for d in ours["shard_devices"]] == \
        [CPU] * ours["shard_degree"]
    assert [d.spec for d in cfg.steps[1].groups[0].devices] == [1]
    assert cfg.raw == raw  # the as-written form is kept


def test_shard_on_a_stage_without_a_partition_is_refused():
    raw = _d2_raw()
    raw["pipeline"][0]["shard"] = {"degree": 1}
    with pytest.raises(ConfigError, match="needs a stage that declares a "
                                          "partition"):
        parse_config(raw, platform="cpu")


def test_the_launch_is_rejected_over_budget_with_the_reference_s_message():
    # a budget between the port's degree-2 and degree-1 projections of
    # the shipped network: degree 1 is refused at construction, naming
    # degree 2 as the smallest feasible
    rep, sh = _port_bytes_at_rest()
    pool = 15 * 8 * packed_frame_bytes(112, 112)
    budget = round((shardplan.projected_device_mb(rep, sh, pool, 1)
                    + shardplan.projected_device_mb(rep, sh, pool, 2)) / 2,
                   1)
    with pytest.raises(ValueError) as raised:
        R2P1DRunner(CPU, pixel_path="yuv420", ragged=True,
                    ragged_pool_rows=15, ragged_chunk_rows=0,
                    row_buckets=[6, 15], num_warmups=0, shard_degree=1,
                    shard_hbm_budget_mb=budget)
    message = str(raised.value)
    # the reference's format, its numbers the port's
    assert re.fullmatch(
        r"shard launch rejected: projected per-device HBM [\d.]+ MiB at "
        r"shard degree 1 exceeds hbm_budget_mb=%s for layers \[1\.\.5\] "
        r"\(replicated 46\.4 MiB \+ sharded 17\.5 MiB / degree \+ pool "
        r"2\.2 MiB\); smallest feasible degree of \(1, 2, 4, 8\): 2"
        % re.escape("%.1f" % budget), message), message


# -- end to end ---------------------------------------------------------------

def _dataset(root, videos=4, frames=40):
    rng = np.random.default_rng(0)
    for i in range(videos):
        label = os.path.join(root, "label%d" % (i % 2))
        os.makedirs(label, exist_ok=True)
        write_y4m(os.path.join(label, "v%02d.y4m" % i),
                  rng.integers(0, 256, (frames, 112, 112, 3),
                               dtype=np.uint8), colorspace="420")
    return root


def _reduced(tmp, path, name):
    with open(path) as f:
        raw = json.load(f)
    raw["ragged"]["pool_rows"] = 3
    loader, runner = raw["pipeline"]
    loader.update(max_clips=3, row_buckets=[1, 3], fuse=3)
    runner.update(max_rows=3, row_buckets=[1, 3], layer_sizes=list(LS),
                  num_classes=CLASSES)
    out = os.path.join(tmp, name + ".json")
    with open(out, "w") as f:
        json.dump(raw, f)
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Reduced copies of both shipped shard configs, served by the port's
    run_benchmark on the CPU (each in a log base of its own)."""
    from rnb_tpu_torch.benchmark import run_benchmark
    tmp = str(tmp_path_factory.mktemp("shard"))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RNB_TPU_DATA_ROOT", _dataset(os.path.join(tmp, "data")))
        for name, path in (("d1", D1), ("d2", D2)):
            sink = {}
            result = run_benchmark(
                _reduced(tmp, path, name), mean_interval_ms=0, num_videos=6,
                log_base=os.path.join(tmp, "logs-" + name),
                print_progress=False, seed=0, platform="cpu",
                outputs_sink=sink)
            assert result.termination_flag == 0
            runs[name] = (result, sink)
    return tmp, runs


def test_the_d2_copy_serves_the_d1_copy_s_logits_bitwise(served):
    _, runs = served
    (d1, sink1), (d2, sink2) = runs["d1"], runs["d2"]
    assert d1.num_completed == d2.num_completed == len(sink1) == 6
    assert sorted(sink1) == sorted(sink2)
    for rid, (video, logits, _stamps) in sink1.items():
        assert sink2[rid][0] == video
        assert np.array_equal(sink2[rid][1], logits)
    assert (d1.shard_max_degree, d1.shard_gathers) == (1, 0)
    assert d2.shard_max_degree == 2 and d2.shard_collective_us > 0
    # one merge a forward of the head stage
    assert d2.shard_gathers == d2.compiles["step1"]["steady_calls"]
    assert d1.shard_rows == d2.shard_rows == d2.clips_completed
    assert d2.shard_step_detail["1"]["budget_mb"] == 120.0


def _reference_parse_utils():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import parse_utils
    finally:
        sys.path.pop(0)
    return parse_utils


def _reference_view(result, config, dest):
    """The job directory as the reference's reader takes it: the window
    line and the Shard: and Trace: lines of log-meta, the trace and the
    config as written (the reference's benchmark copies it in)."""
    os.makedirs(dest)
    shutil.copy(os.path.join(result.log_dir, "trace.json"), dest)
    shutil.copy(config, dest)
    with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
        lines = [line for line in f.read().splitlines()
                 if line.startswith(("Shard", "Trace"))
                 or (len(line.split()) == 2
                     and line.replace(".", "").replace(" ", "").isdigit())]
    with open(os.path.join(dest, "log-meta.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return dest


@pytest.mark.parametrize("name", ["d1", "d2"])
def test_the_reference_reads_the_shard_lines_and_finds_no_problem(
        served, name):
    tmp, runs = served
    result, _ = runs[name]
    reference = _reference_parse_utils()
    view = _reference_view(result, os.path.join(tmp, name + ".json"),
                           os.path.join(tmp, "view-" + name))
    meta = reference.parse_meta(view)
    assert meta["shard_steps"] == 1
    assert meta["shard_gathers"] == result.shard_gathers
    assert meta["shard_collective_us"] == result.shard_collective_us
    assert meta["shard_step_detail"] == result.shard_step_detail
    assert reference._check_shard(view, meta) == []
    assert summarize(result.log_dir)["footing_problems"] == []
    # the merge spans ride the trace, nested in the model_call spans
    with open(os.path.join(result.log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e["name"] == "exec1.collective"]
    assert len(spans) == result.shard_gathers
    if name == "d2":
        final = [json.loads(line) for line in open(
            os.path.join(result.log_dir, "metrics.jsonl"))][-1]
        assert final["histograms"]["exec1.collective"]["count"] == \
            result.shard_gathers


def _tamper(meta_path, head, edit):
    with open(meta_path) as f:
        lines = f.read().splitlines()
    with open(meta_path, "w") as f:
        f.write("\n".join(head + ": " + edit(line[len(head) + 2:])
                          if line.startswith(head + ": ") else line
                          for line in lines) + "\n")


def _detail(fn):
    def edit(rest):
        detail = json.loads(rest)
        fn(detail["1"])
        return json.dumps(detail, sort_keys=True)
    return edit


@pytest.mark.parametrize("case", ["gathers-total", "over-budget",
                                  "degree-zero", "degree-differs",
                                  "collective-outgrows-the-call"])
def test_the_port_s_check_finds_what_the_reference_s_finds(served, tmp_path,
                                                           case):
    tmp, runs = served
    result, _ = runs["d2"]
    reference = _reference_parse_utils()
    view = _reference_view(result, os.path.join(tmp, "d2.json"),
                           str(tmp_path / "view"))
    meta_path = os.path.join(view, "log-meta.txt")
    if case == "gathers-total":
        _tamper(meta_path, "Shard", lambda rest: rest.replace(
            "gathers=%d" % result.shard_gathers,
            "gathers=%d" % (result.shard_gathers + 1)))
    elif case == "over-budget":
        _tamper(meta_path, "Shard steps", _detail(
            lambda d: d.update(projected_mb=130.0)))
    elif case == "degree-zero":
        _tamper(meta_path, "Shard steps", _detail(
            lambda d: d.update(degree=0)))
    elif case == "degree-differs":
        _tamper(meta_path, "Shard steps", _detail(
            lambda d: d.update(degree=4)))
    else:
        with open(os.path.join(view, "trace.json")) as f:
            doc = json.load(f)
        for event in doc["traceEvents"]:
            if event["name"] == "exec1.collective":
                event["dur"] = 1e9
        with open(os.path.join(view, "trace.json"), "w") as f:
            json.dump(doc, f)
    want = reference._check_shard(view, reference.parse_meta(view))
    meta = read_meta(meta_path)
    meta["args"] = {"config": os.path.join(view, "d2.json")}
    got = shard_problems(view, meta)
    assert want and got == want


def test_the_guard_covers_the_new_modules():
    # tests/test_torch_ops.py walks every module of the port and the
    # smoke; the shard modules are among them and import no jax
    walked = []
    for dirpath, _dirs, names in os.walk(os.path.join(REPO,
                                                      "rnb_tpu_torch")):
        walked.extend(os.path.relpath(os.path.join(dirpath, n), REPO)
                      for n in names if n.endswith(".py"))
    for path in ("rnb_tpu_torch/ops/handoff_dma.py",
                 "rnb_tpu_torch/parallel/__init__.py",
                 "rnb_tpu_torch/parallel/mesh.py",
                 "rnb_tpu_torch/parallel/shardplan.py"):
        assert path in walked
        with open(os.path.join(REPO, path)) as f:
            assert not re.search(r"^\s*(import|from)\s+(jax|flax|rnb_tpu)\b",
                                 f.read(), re.M), path


@pytest.mark.parametrize("name", ["d1", "d2"])
def test_both_check_jobs_pass_the_shard_job_dirs(served, name):
    assert_both_checks_pass(served[1][name][0].log_dir)

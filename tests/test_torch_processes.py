"""The port's multi-process launch, held to the JAX package on the CPU.

Launches of 2 and 4 processes (``rnb_tpu_torch.tools.launch``: each its
own interpreter, the three ``RNB_TPU_*`` variables set, a free port of
the loopback) run the cases of ``tests/torch_process_children.py`` over
a gloo group and save each member's results; the test holds them to
the JAX package's twins on the 8 virtual devices of
``tests/conftest.py``:

* the ``distributed`` contract: the launch joins (``True``), count,
  index and ``is_primary``, idempotent, the process-major global mesh,
  ``run_benchmark`` refused; the partial environment's error unchanged;
* ``ring_shift`` at every shift and the all-gathers bitwise the
  reference's ppermute twins (``use_pallas=False``); the reduce-scatter
  exact on integer-valued float32 (any order of their sums is exact);
* ``ShardedInference`` across processes at a small width (2 frames of
  112 x 112, layer sizes (1, 1, 1, 1), 8 classes) on the JAX package's
  seeded weights (``from_jax_variables``): within the bound of
  ``tests/test_torch_parallel.py`` (bf16 rtol = atol = 2e-2, float32
  5e-4) of the reference's ``ShardedInference`` and of the one-process
  port run, and bitwise the same rows summed in one process;
* a killed peer makes the gloo ring raise within its cap.

Every launch has a timeout that kills its processes and fails the test.
The cross-process form of the ring kernel (``rnb_ring_hop``) runs here
in the host emulation (``tests/host_cuda/``): the protocol's counters,
its bounded wait, and each process's tiles of the collectives through
it, bitwise the plain version.
"""

import ctypes
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec

import torch_process_children as children
from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.ops import handoff_dma as jax_dma
from rnb_tpu.parallel import distributed as jax_distributed
from rnb_tpu.parallel import mesh as jax_mesh
from rnb_tpu.parallel import sharded as jax_sharded
from rnb_tpu_torch import parallel
from rnb_tpu_torch.models.r2p1d.checkpoint import from_jax_variables
from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.ops import handoff_dma as dma
from rnb_tpu_torch.parallel import distributed, mesh, peers
from rnb_tpu_torch.tools.launch import launch

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
BF16_TOL = 2e-2
F32_TOL = 5e-4
#: seconds a launch may take before its processes are killed
LAUNCH_TIMEOUT_S = 240.0
KILL_CAP_S = 3.0
MESH_CONFIG = os.path.join(os.path.dirname(HERE), "configs",
                           "r2p1d-mesh.json")


def _launch(tmp_path, count, case, saved=None, **args):
    """Run ``case`` as a launch of ``count`` processes; every process
    must exit 0 in time. Returns the saved results of the processes
    ``saved`` (all by default)."""
    out = tmp_path / ("%s-%d" % (case, count))
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=HERE)
    for key in distributed.ENV:
        env.pop(key, None)
    ended = launch(count, [sys.executable, "-m", "torch_process_children",
                           case, str(out), json.dumps(args)],
                   LAUNCH_TIMEOUT_S, env=env, cwd=HERE)
    for e in ended:
        assert e.returncode == 0, "process %d of %s: %s\n%s" % (
            e.index, case, "killed at the timeout" if e.returncode is None
            else "exit %d" % e.returncode, e.stderr[-4000:])
    return [torch.load(str(out / ("result-%d.pt" % i)), weights_only=False)
            for i in (range(count) if saved is None else saved)]


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    """``get(n)``: the results of the collectives' launch of ``n``
    processes, run once a module."""
    launched = {}

    def get(n):
        if n not in launched:
            launched[n] = _launch(tmp_path_factory.mktemp("collectives"), n,
                                  "collectives")
        return launched[n]
    return get


def _numpy(t):
    """A torch tensor as numpy, bf16 as JAX's bfloat16."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _bytes(x):
    if isinstance(x, torch.Tensor):
        x = _numpy(x.contiguous())
    return np.ascontiguousarray(x).view(np.uint8)


def _jax_mesh(n, name="x"):
    return JaxMesh(np.array(jax.devices()[:n]), (name,))


def _jax_sharded(full, n, axis, name="x"):
    spec = [None] * full.ndim
    spec[axis] = name
    return jax.device_put(jnp.asarray(full), JaxNamedSharding(
        _jax_mesh(n, name), PartitionSpec(*spec)))


# -- the launch ------------------------------------------------------------

@pytest.fixture(scope="module", params=[2, 4], ids=["2proc", "4proc"])
def contract(request, tmp_path_factory):
    n = request.param
    tmp = tmp_path_factory.mktemp("contract")
    return n, tmp, _launch(tmp, n, "contract", config=MESH_CONFIG,
                           out=str(tmp))


def test_the_launch_joins_with_the_reference_s_contract(contract):
    n, _, results = contract
    for rank, got in enumerate(results):
        assert got["again"] is True  # idempotent, as the reference's
        assert (got["count"], got["index"]) == (n, rank)
        assert got["primary"] is (rank == 0)
        assert "no CUDA card is visible" in got["local_device"]


def test_the_global_mesh_is_process_major_as_the_reference_s(contract):
    n, _, results = contract
    for name, kwargs in (("default", {}),
                         ("dp-1", dict(axes={"dp": -1, "sp": 1})),
                         ("pp", dict(axis_names=("pp", "dp", "sp")))):
        theirs = jax_mesh.build_mesh(jax.devices()[:n], **kwargs)
        for rank, got in enumerate(results):
            shape, processes, devices, device, spans = got["meshes"][name]
            assert shape == dict(theirs.shape)
            # one member a process, in process order, as jax.devices()
            assert np.array(processes).reshape(-1).tolist() == list(
                range(n))
            assert devices == ["cpu"] * n and device == "cpu" and spans
        assert results[0]["sharding"] == (tuple(range(n)), "cpu")


def test_run_benchmark_refuses_a_launch_of_several_processes(contract):
    n, tmp, results = contract
    for rank, got in enumerate(results):
        assert got["run_benchmark"].startswith(
            "a served run in a launch of %d processes" % n)
        assert "not yet ported" in got["run_benchmark"]
        assert got["logs"] is False


@pytest.mark.parametrize("kwargs", [dict(num_processes=2),
                                    dict(process_id=0),
                                    dict(num_processes=4, process_id=3)])
def test_a_partial_launch_keeps_the_reference_s_error(kwargs, monkeypatch):
    for key in distributed.ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError) as theirs:
        jax_distributed.maybe_initialize(**kwargs)
    with pytest.raises(RuntimeError) as ours:
        distributed.maybe_initialize(**kwargs)
    assert str(ours.value) == str(theirs.value)
    assert distributed.launch() is None


@pytest.mark.parametrize("args,error,message", [
    (("127.0.0.1:9", None, None), NotImplementedError,
     "without RNB_TPU_NUM_PROCESSES and RNB_TPU_PROCESS_ID"),
    (("127.0.0.1:9", 2, 2), ValueError, "must lie in"),
    (("127.0.0.1:9", 2, -1), ValueError, "must lie in"),
    (("localhost", 2, 0), ValueError, "host:port")])
def test_a_malformed_launch_is_refused_before_it_joins(args, error, message,
                                                       monkeypatch):
    for key in distributed.ENV:
        monkeypatch.delenv(key, raising=False)
    joined = []
    monkeypatch.setattr(distributed, "_join",
                        lambda *a: joined.append(a))
    with pytest.raises(error, match=message):
        distributed.maybe_initialize(*args)
    assert joined == [] and distributed.launch() is None


# -- the collectives -------------------------------------------------------

def _collective_cases():
    return [(n, dtype, shift) for n in (2, 4)
            for dtype in ("uint8", "bfloat16", "float32")
            for shift in range(n)]


@pytest.mark.parametrize("n,dtype,shift", _collective_cases(), ids=[
    "%dproc-%s-shift%d" % c for c in _collective_cases()])
def test_ring_shift_across_processes_is_bitwise_the_reference_twin(
        collectives, n, dtype, shift):
    # tolerance: none (the hop moves bytes)
    results = collectives(n)
    full = children.values(dtype, (n * 3, 5), seed=n * 10 + len(dtype))
    want = np.asarray(jax_dma.ring_shift(_jax_sharded(_numpy(full), n, 0),
                                         _jax_mesh(n), "x", shift=shift,
                                         use_pallas=False))
    for rank, got in enumerate(results):
        assert got["local"] == (rank,) and got["device"] == "cpu"
        mine = got["shift", dtype, shift]
        assert mine.dtype == full.dtype and mine.shape == (3, 5)
        assert np.array_equal(_bytes(mine), _bytes(want[rank * 3:
                                                         rank * 3 + 3]))
        # shift 0 hands back the member's own buffer, as the reference
        assert got["same", dtype, shift] is (shift == 0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("axis", [0, -1])
def test_ring_all_gather_across_processes_is_bitwise_the_reference(
        collectives, n, axis):
    results = collectives(n)
    full = children.values("float32", (8, 3, 8), seed=n + 31 * (axis + 2))
    want = np.asarray(jax_dma.ring_all_gather(
        _jax_sharded(full.numpy(), n, axis, "tp"), _jax_mesh(n, "tp"),
        axis=axis, use_pallas=False))
    assert np.array_equal(want, full.numpy())
    for got in results:
        assert np.array_equal(got["gather", axis].numpy(), want)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("axis", [0, -1])
def test_ring_all_gather_many_across_processes_is_bitwise_the_reference(
        collectives, n, axis):
    # several leaves in the same n - 1 tables, a channels-last conv
    # kernel among them on axis 0, each held to the reference's gather
    # and laid out as the unsharded leaf
    results = collectives(n)
    fulls = [children.values("float32", s, seed=n * 3 + k + 11 * (axis + 2))
             for k, s in enumerate(children.GATHER_SHAPES)]
    if axis == 0:
        fulls.append(children.conv_leaf(n, seed=n))
    for k, full in enumerate(fulls):
        want = np.asarray(jax_dma.ring_all_gather(
            _jax_sharded(full.numpy(), n, axis, "tp"), _jax_mesh(n, "tp"),
            axis=axis, use_pallas=False))
        for got in results:
            member = got["gather_many", axis][k]
            assert np.array_equal(member.numpy(), want)
            assert member.stride() == full.stride()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("axis,shape", [(-1, (2, 8)), (0, (4, 3))])
def test_ring_psum_scatter_across_processes_is_exact(collectives, n, axis,
                                                     shape):
    # integer-valued float32: every order of the sums is exact, so the
    # chunks equal the reference's twin's
    results = collectives(n)
    stack = children.integers((n,) + shape, seed=11 * n + axis)
    want = np.asarray(jax_dma.ring_psum_scatter(
        jax.device_put(jnp.asarray(stack.numpy()), JaxNamedSharding(
            _jax_mesh(n, "tp"), PartitionSpec("tp"))),
        _jax_mesh(n, "tp"), axis=axis, use_pallas=False))
    assert np.array_equal(want, stack.sum(0).numpy())
    chunk = shape[axis] // n
    for rank, got in enumerate(results):
        assert np.array_equal(got["psum_scatter", axis].numpy(),
                              np.take(want, range(rank * chunk,
                                                  (rank + 1) * chunk),
                                      axis=axis))


@pytest.mark.parametrize("n", [2, 4])
def test_a_mixed_table_across_processes_is_the_one_process_table(
        collectives, n):
    # shift 0 and every other shift in one table, the destinations slots
    # of canary tensors: each process's canary as one process's plain
    # version writes it
    results = collectives(n)
    src = children.values("float32", (n, 4, 6), seed=5 * n)
    canary = torch.full((n, 2 * n, 12), -1.0)
    table = [dma.RingEntry(list(src), [canary[j, :4, :6] for j in range(n)],
                           0)]
    for shift in range(1, n):
        table.append(dma.RingEntry(
            [src[i, :2] for i in range(n)],
            [canary[j, 2 * shift - 2:2 * shift, 6:] for j in range(n)],
            shift))
    dma.ring_shift_group_reference(table)
    for rank, got in enumerate(results):
        assert torch.equal(got["group"], canary[rank])


def test_a_killed_peer_makes_the_gloo_ring_raise_within_its_cap(tmp_path):
    # process 1 leaves right after joining and saves nothing
    (got,) = _launch(tmp_path, 2, "killed", saved=[0], cap_s=KILL_CAP_S)
    assert got["message"] is not None and "gave up within the %.1f s cap" \
        % KILL_CAP_S in got["message"]
    assert got["seconds"] < KILL_CAP_S + 20.0


@pytest.mark.parametrize("n", [2, 4])
def test_processes_whose_shapes_disagree_raise_before_any_payload(
        tmp_path, n):
    # process p shifts 4 + 4 p float32: each receives another byte count
    # than its destination holds, and raises naming both
    results = _launch(tmp_path, n, "mismatched")
    for rank, got in enumerate(results):
        pred = (rank - 1) % n
        assert got["message"] is not None and (
            "receives %d bytes from process %d, where its destination "
            "holds %d" % (16 + 16 * pred, pred, 16 + 16 * rank)
            in got["message"]) and "tables disagree" in got["message"]


# -- ShardedInference across processes -------------------------------------

#: (pixel path, dtype, processes, members' processes, axes, max clips)
SHARDED = {
    "rgb-bf16-dp1xsp2": ("rgb", "bfloat16", 2, [0, 1],
                         {"dp": 1, "sp": 2}, 3),
    "yuv420-f32-dp1xsp2": ("yuv420", "float32", 2, [0, 1],
                           {"dp": 1, "sp": 2}, 3),
    "rgb-f32-dp2xsp1": ("rgb", "float32", 2, [0, 1], {"dp": 2, "sp": 1}, 3),
    "rgb-bf16-dp1xsp4-2proc": ("rgb", "bfloat16", 2, [0, 0, 1, 1],
                               {"dp": 1, "sp": 4}, 3),
    "rgb-f32-dp2xsp2-4proc": ("rgb", "float32", 4, [0, 1, 2, 3],
                              {"dp": 2, "sp": 2}, 2),
}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    variables = jax_ckpt.load_or_init(1, 5, children.TINY_SI["num_classes"],
                                      children.TINY_SI["layer_sizes"], None)
    path = tmp_path_factory.mktemp("weights") / "tiny.pt"
    torch.save(from_jax_variables(variables), str(path))
    return variables, str(path)


@pytest.mark.parametrize("case", sorted(SHARDED))
def test_sharded_inference_across_processes_matches_the_reference(
        weights, tmp_path, case):
    pixel_path, dtype, count, members, axes, max_clips = SHARDED[case]
    variables, path = weights
    dp, sp = axes["dp"], axes["sp"]
    videos_n = 2 * dp
    results = _launch(tmp_path, count, "sharded", weights=path,
                      members=members, axes=axes, dtype=dtype,
                      pixel_path=pixel_path, max_clips=max_clips, seed=7,
                      videos=videos_n)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    theirs = jax_sharded.make_sharded_inference(
        mesh=JaxMesh(np.array(jax.devices()[:dp * sp]).reshape(dp, sp),
                     ("dp", "sp")),
        variables=variables, pixel_path=pixel_path, max_clips=max_clips,
        dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32,
        **children.TINY_SI)
    one = parallel.make_sharded_inference(
        mesh=mesh.build_mesh([CPU] * (dp * sp), axes=axes),
        variables=torch.load(path), pixel_path=pixel_path,
        max_clips=max_clips, dtype=getattr(torch, dtype), **children.TINY_SI)
    rng = np.random.default_rng(7)
    videos = rng.integers(0, 256, one.batch_shape(videos_n), dtype=np.uint8)
    valid = [int(x) for x in rng.integers(1, max_clips + 1, videos_n)]
    want = np.asarray(theirs.run(*theirs.place(videos, valid)))
    single = one.run(*one.place(videos, valid)).numpy()
    per_row = videos_n // dp
    shard = one.padded_clips // sp
    for rank, got in enumerate(results):
        rows, cols = got["local_dp"], got["local_sp"]
        first, last = rows[0] * per_row, (rows[-1] + 1) * per_row
        assert got["place"] == ((last - first, len(cols) * shard)
                                + one.batch_shape(1)[2:],
                                (last - first, len(cols) * shard))
        logits = got["logits"].numpy()
        assert logits.shape == (last - first, children.TINY_SI[
            "num_classes"]) and logits.dtype == np.float32
        # the reference's sharded step, and the one-process port run
        np.testing.assert_allclose(logits, want[first:last], rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(logits, single[first:last], rtol=tol,
                                   atol=tol)
        # where both forwards see the same rows: bitwise
        assert torch.equal(got["logits"], got["same_rows"])
        assert np.array_equal(got["preds"], logits.argmax(-1))
        if sp > len(cols):
            assert got["ring"] is not None and rank in got["ring"]
        else:
            assert got["ring"] is None


# -- meshes, rings and shardings that span processes (one process) --------

def test_a_ring_across_processes_holds_one_member_a_process():
    ring = mesh.Ring([mesh.Member(0, CPU), mesh.Member(1, CPU)], "sp")
    assert ring.spans_processes and ring.local == (0,)
    assert ring.processes == (0, 1) and ring.device == CPU
    assert repr(ring) == "Ring(['0:cpu', '1:cpu'], axis_name='sp')"
    ring.check([torch.zeros(2)], "t")
    with pytest.raises(ValueError, match="2 tensors for a ring of 2 "
                                         "members, 1 of them"):
        ring.check([torch.zeros(2)] * 2, "t")
    with pytest.raises(ValueError, match="one member a process"):
        mesh.Ring([CPU, CPU, mesh.Member(1, CPU)])
    with pytest.raises(ValueError, match="no member in process 0"):
        _ = mesh.Ring([mesh.Member(1, CPU), mesh.Member(2, CPU)]).device
    assert mesh.Ring([CPU, CPU]).processes == (0, 0)


def test_a_mesh_across_processes_acts_on_this_process_s_members():
    m = mesh.build_mesh([mesh.Member(p, CPU) for p in (0, 0, 1, 1)],
                        axes={"dp": 2, "sp": 2})
    assert m.spans_processes and m.processes.tolist() == [[0, 0], [1, 1]]
    assert m.device == CPU
    sharding = mesh.NamedSharding.of(m, ("dp",))
    assert sharding.processes == (0, 0, 1, 1) and sharding.device == CPU
    # the members of one process still share one device
    with pytest.raises(NotImplementedError, match="not yet ported"):
        mesh.build_mesh([mesh.Member(0, torch.device("cuda", 0)),
                         mesh.Member(0, torch.device("cuda", 1))])
    # across processes they may differ, one device a process
    two = mesh.build_mesh([mesh.Member(0, CPU),
                           mesh.Member(1, torch.device("cuda", 1))])
    assert two.device == CPU


def test_sharded_inference_refuses_a_block_it_cannot_split(weights):
    _, path = weights
    variables = torch.load(path)
    interleaved = mesh.build_mesh([mesh.Member(p, CPU)
                                   for p in (0, 1, 0, 1)],
                                  axes={"dp": 1, "sp": 4})
    with pytest.raises(ValueError, match="block of dp rows by sp"):
        parallel.ShardedInference(interleaved, max_clips=3,
                                  variables=variables, **children.TINY_SI)


# -- the peers' module and the hop kernel (host emulation) -----------------

def test_the_wait_cap_is_positive_and_restored():
    previous = peers.set_wait_cap(5.0)
    try:
        assert peers.wait_cap_s == 5.0
        with pytest.raises(ValueError, match="positive"):
            peers.set_wait_cap(0)
    finally:
        peers.set_wait_cap(previous)


def test_a_ring_across_processes_needs_a_launch():
    ring = mesh.Ring([mesh.Member(0, CPU), mesh.Member(1, CPU)])
    with pytest.raises(RuntimeError, match="joined no launch"):
        peers.endpoint(ring)
    assert peers.ring_key(ring) == "tp:cpu,cpu:0,1"


@pytest.mark.parametrize("tiles,launches", [(0, 1), (1, 1), (80, 1),
                                            (81, 2), (200, 3)])
def test_the_hop_takes_as_few_launches_as_hold_its_tiles(tiles, launches):
    args = peers.launch_args([peers.Tile(16 * i, 16 * i, 1, 16, 16, 16)
                              for i in range(tiles)])
    assert len(args) == launches
    assert sum(a[-1] for a in args) == tiles
    assert all(a[-2] == 1 and a[-1] <= _kernels.RING_MAX_TILES
               for a in args)


@pytest.fixture(scope="module")
def hop(tmp_path_factory):
    from test_torch_host_cuda import _build
    lib = _build("ring.cu", str(tmp_path_factory.mktemp("hop")))
    fn = lib.rnb_ring_hop
    fn.restype = ctypes.c_int
    fn.argtypes = _kernels.RING_SHIFT.entries[_kernels.RING_HOP_ENTRY] + [
        ctypes.c_int, ctypes.c_void_p]
    return fn


def _counters(*values):
    return torch.tensor(values, dtype=torch.int64)


def _run_hop(hop, tiles, wait=None, wait_for=0, signal=None, cap_s=5.0,
             done=None, error=None, layout=0, layout_out=None,
             layout_in=None):
    """``tiles`` through the emulated ``rnb_ring_hop``: the error word
    (``error[0]``) and the word it is reported into (``error[8]``) in one
    tensor."""
    done = torch.zeros(1, dtype=torch.int32) if done is None else done
    error = torch.zeros(16, dtype=torch.int32) if error is None else error
    codes = []
    for i, args in enumerate(peers.launch_args(tiles)):
        codes.append(hop(*args, wait if i == 0 else None,
                         wait_for if i == 0 else 0, signal, done.data_ptr(),
                         error.data_ptr(), error.data_ptr() + 32,
                         int(cap_s * 1e9), layout, layout_out,
                         layout_in if i == 0 else None, 0, None))
    return codes, done, error


def _tile(src, dst):
    return peers.Tile(src.data_ptr(), dst.data_ptr(), 1,
                      src.numel() * src.element_size(),
                      src.numel() * src.element_size(),
                      dst.numel() * dst.element_size())


def test_the_hop_moves_and_signals_once_its_counter_is_reached(hop):
    src = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, 40007, dtype=np.uint8))
    dst = torch.full((40007,), 0xA5, dtype=torch.uint8)
    counters = _counters(5, 0)
    codes, done, error = _run_hop(hop, [_tile(src, dst)],
                                  wait=counters.data_ptr(), wait_for=5,
                                  signal=counters.data_ptr() + 8)
    assert codes == [0] and torch.equal(dst, src)
    assert counters.tolist() == [5, 1] and done.item() == 0
    assert error[0].item() == 0


def test_a_wait_past_its_cap_writes_the_error_and_moves_nothing(hop):
    src = torch.arange(64, dtype=torch.uint8)
    dst = torch.zeros(64, dtype=torch.uint8)
    counters = _counters(0, 0)
    t0 = time.monotonic()
    codes, done, error = _run_hop(hop, [_tile(src, dst)],
                                  wait=counters.data_ptr(), wait_for=1,
                                  signal=counters.data_ptr() + 8, cap_s=0.05)
    assert codes == [0] and time.monotonic() - t0 < 10.0
    assert error[0].item() == 1  # timed out, and reported
    assert error[8].item() == 1
    assert not dst.any() and counters.tolist() == [0, 0]
    assert done.item() == 0
    # a member whose error word is set gives up at once: nothing moves
    codes, _, error = _run_hop(hop, [_tile(src, dst)], error=error,
                               signal=counters.data_ptr() + 8)
    assert not dst.any() and counters.tolist() == [0, 0]


def test_a_hop_with_no_tiles_still_waits_and_signals(hop):
    counters = _counters(2, 7)
    codes, done, error = _run_hop(hop, [], wait=counters.data_ptr(),
                                  wait_for=2,
                                  signal=counters.data_ptr() + 8)
    assert codes == [0] and counters.tolist() == [2, 8]


def test_the_hop_refuses_a_launch_without_its_words(hop):
    src = torch.arange(16, dtype=torch.uint8)
    args = peers.launch_args([_tile(src, src.clone())])[0]
    error = torch.zeros(16, dtype=torch.int32)
    word = torch.zeros(1, dtype=torch.int64)
    assert hop(*args, None, 0, None, None, error.data_ptr(), None, 10, 0,
               None, None, 0, None) != 0
    assert hop(*args, None, 0, None, error.data_ptr(), None, None, 10, 0,
               None, None, 0, None) != 0
    assert hop(*args, None, 0, None, error.data_ptr(), error.data_ptr(),
               None, -1, 0, None, None, 0, None) != 0
    # a layout word needs a layout (0 is what a fresh word holds)
    assert hop(*args, None, 0, None, error.data_ptr(), error.data_ptr(),
               None, 10, 0, word.data_ptr(), None, 0, None) != 0
    assert hop(*args, None, 0, None, error.data_ptr(), error.data_ptr(),
               None, 10, 0, None, word.data_ptr(), 0, None) != 0


def test_the_send_writes_its_layout_before_it_signals_and_the_place_checks(
        hop):
    src = torch.arange(256, dtype=torch.uint8)
    window = torch.zeros(256, dtype=torch.uint8)
    dst = torch.zeros(256, dtype=torch.uint8)
    counters = _counters(0, 0, 0)  # recv, its layout word, ack
    send = [_tile(src, window)]
    digest = peers.layout([t._replace(dst=0) for t in send], "dst")
    codes, _, error = _run_hop(hop, send, signal=counters.data_ptr(),
                               layout=digest,
                               layout_out=counters.data_ptr() + 8)
    assert codes == [0] and error[0].item() == 0
    assert counters.tolist() == [1, digest, 0]
    # a place that reads another layout moves nothing and says why
    codes, _, error = _run_hop(hop, [_tile(window, dst)],
                               wait=counters.data_ptr(), wait_for=1,
                               signal=counters.data_ptr() + 16,
                               layout=digest + 1,
                               layout_in=counters.data_ptr() + 8)
    assert codes == [0] and error[0].item() == peers.LAYOUT_DIFFERS
    assert error[8].item() == peers.LAYOUT_DIFFERS
    assert not dst.any() and counters.tolist() == [1, digest, 0]
    codes, _, error = _run_hop(hop, [_tile(window, dst)],
                               wait=counters.data_ptr(), wait_for=1,
                               signal=counters.data_ptr() + 16,
                               layout=digest,
                               layout_in=counters.data_ptr() + 8)
    assert error[0].item() == 0 and torch.equal(dst, src)
    assert counters.tolist() == [1, digest, 1]


def test_the_layout_is_the_window_s_bytes_on_both_ends_of_a_hop():
    send = [peers.Tile(1000, 0, 4, 64, 128, 64),
            peers.Tile(2000, 256, 1, 100, 100, 100)]
    place = [peers.Tile(0, 3000, 1, 256, 256, 256),
             peers.Tile(256, 4000, 10, 10, 10, 16)]
    # the same bytes at the same window offsets, rows or not: one layout
    assert peers.layout(send, "dst") == peers.layout(place, "src") != 0
    assert peers.layout(send[:1], "dst") != peers.layout(place, "src")
    assert peers.layout([], "dst") != 0


class _Windowless(peers.Endpoint):
    """An endpoint with its peers' windows set by hand: no card, no
    store; launching raises."""

    def __init__(self, window_bytes, peer_window_bytes):
        self.key, self.member, self.degree, self.epoch = "t", 0, 2, 0
        self.broken = None
        self.window, self.window_bytes = 1 << 20, window_bytes
        self.peer_windows = {1: 1 << 30}
        self.peer_window_bytes = {1: peer_window_bytes}
        self.peer_counters = {1: 1 << 31}
        self.counters = 1 << 32

    def _launch(self, *args, **kwargs):
        raise AssertionError("launched")


def test_a_hop_past_the_successor_s_window_raises_before_it_launches():
    # this member's window fits the send; its successor's, of another
    # size, does not: the hop must not write past it
    ep = _Windowless(4 << 20, 1 << 20)
    send = [peers.Tile(0, 0, 1, 1 << 20, 1 << 20, 1 << 20),
            peers.Tile(0, 1 << 20, 1, 16, 16, 16)]
    with pytest.raises(ValueError, match=r"sends 1048592 bytes into member "
                                         r"1's window of 1048576: the "
                                         r"processes' tables disagree"):
        ep.hop(1, [], send, [], (1 << 20) + 16)
    assert ep.epoch == 0
    with pytest.raises(RuntimeError, match="tables disagree"):
        ep.hop(1, [], send[:1], [], 1 << 20)


class _Recorder:
    """A member's endpoint that records its hops instead of launching."""

    def __init__(self):
        self.hops = []

    def hop(self, shift, local, send, place, window_bytes):
        self.hops.append((shift, list(local), list(send), list(place),
                          window_bytes))


def _record(monkeypatch, n, member, run):
    """The hops ``run()`` makes as member ``member`` of a ring of ``n``
    processes on the card's path (its tensors stay on the CPU)."""
    recorder = _Recorder()
    monkeypatch.setattr(mesh, "this_process", lambda: member)
    monkeypatch.setattr(dma, "_check_across", lambda table, ring: False)
    monkeypatch.setattr(dma, "_finish_across", lambda ep: None)
    monkeypatch.setattr(peers, "endpoint", lambda ring: recorder)
    out = run(mesh.Ring([mesh.Member(p, CPU) for p in range(n)], "tp"))
    monkeypatch.undo()
    return out, recorder.hops


def _replay(hop, n, recorded):
    """Every member's recorded hops through the emulated ``rnb_ring_hop``
    as the card runs them: at each hop every member's send launch (into
    its successor's window), then every member's place launch, each
    gated on and signalling the ring's counters."""
    hops = len(recorded[0])
    windows = [torch.zeros(max(r[4] for r in recorded[m]) + 16,
                           dtype=torch.uint8) for m in range(n)]
    recv, ack = _counters(*[0] * n), _counters(*[0] * n)
    layouts = _counters(*[0] * n)
    for e in range(hops):
        for m in range(n):
            shift, local, send, _, _ = recorded[m][e]
            succ = (m + shift) % n
            tiles = local + [t._replace(dst=windows[succ].data_ptr() + t.dst)
                             for t in send]
            codes, _, error = _run_hop(
                hop, tiles, wait=ack.data_ptr() + 8 * succ, wait_for=e,
                signal=recv.data_ptr() + 8 * succ,
                layout=peers.layout(send, "dst"),
                layout_out=layouts.data_ptr() + 8 * succ)
            assert set(codes) == {0} and error[0].item() == 0
        for m in range(n):
            place = recorded[m][e][3]
            tiles = [t._replace(src=windows[m].data_ptr() + t.src)
                     for t in place]
            codes, _, error = _run_hop(hop, tiles,
                                       wait=recv.data_ptr() + 8 * m,
                                       wait_for=e + 1,
                                       signal=ack.data_ptr() + 8 * m,
                                       layout=peers.layout(place, "src"),
                                       layout_in=layouts.data_ptr() + 8 * m)
            assert set(codes) == {0} and error[0].item() == 0
    assert recv.tolist() == ack.tolist() == [hops] * n


@pytest.mark.parametrize("n", [2, 4])
def test_each_process_s_gather_through_the_hop_kernel_is_the_unsharded(
        hop, monkeypatch, n):
    # tolerance: none. Each member's tiles of a gather of mixed leaves
    # (float32 rows at a pitch on axis -1; a channels-last u8 conv kernel
    # and odd bytes on axis 0), recorded on the card's path, replayed
    # through the emulated kernel with the ring's counters: every
    # member's result is the unsharded leaf, laid out as it
    for axis in (0, -1):
        fulls = [children.values("float32", (8, 4, 8), seed=n + axis)]
        if axis == 0:
            fulls += [children.conv_leaf(n, seed=2 * n),
                      children.values("uint8", (n * 7, 3), seed=n)]
        results, recorded = [], []
        for m in range(n):
            leaves = [[children.shard(f, n, axis, m).contiguous(
                memory_format=torch.channels_last_3d) if f.dim() == 5
                else children.shard(f, n, axis, m)] for f in fulls]
            out, hops = _record(monkeypatch, n, m, lambda ring: (
                dma.ring_all_gather_many(leaves, axis, ring), leaves))
            results.append(out)
            recorded.append(hops)
        assert all(len(h) == n - 1 for h in recorded)
        _replay(hop, n, recorded)
        for gathered, _ in results:
            for (member,), full in zip(gathered, fulls):
                assert torch.equal(member, full)
                assert member.stride() == full.stride()


@pytest.mark.parametrize("n,shift", [(2, 1), (4, 1), (4, 3)])
def test_each_process_s_shift_through_the_hop_kernel_is_the_roll(
        hop, monkeypatch, n, shift):
    full = children.values("bfloat16", (n * 3, 5), seed=n + shift)
    # the sources stay alive until the replay reads them
    sources = [[children.shard(full, n, 0, m)] for m in range(n)]
    outs, recorded = [], []
    for m in range(n):
        out, hops = _record(monkeypatch, n, m, lambda ring: dma.ring_shift(
            sources[m], shift, ring))
        outs.append(out[0])
        recorded.append(hops)
    _replay(hop, n, recorded)
    assert torch.equal(torch.cat(outs), torch.roll(full, 3 * shift, 0))

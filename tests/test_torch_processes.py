"""The port's multi-process launch, held to the JAX package on the CPU.

Launches of 2 and 4 processes (``rnb_tpu_torch.tools.launch``: each its
own interpreter, the three ``RNB_TPU_*`` variables set, a free port of
the loopback) run the cases of ``tests/torch_process_children.py`` over
a gloo group and save each member's results; the test holds them to
the JAX package's twins on the 8 virtual devices of
``tests/conftest.py``:

* the ``distributed`` contract: the launch joins (``True``), count,
  index and ``is_primary``, idempotent, the process-major global mesh;
  the partial environment's error unchanged (a served launch is
  ``tests/test_torch_launch.py``'s);
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
in the host emulation (``tests/host_cuda/``), one library a member so
that the members' launches run at once: the post, the bounded waits,
the check that fails a disagreeing post before any byte moves, the
result arena (its leases, its stream rule, its growth), and every
member's gather, shift and reduce-scatter through it, bitwise the
unsharded or rolled tensor, each hop one launch into the successor's
arena. A child process frees arena leases from garbage collections that
the arena's own allocations start under its lock, within a wall limit.
"""

import ctypes
import json
import os
import subprocess
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
    return n, tmp, _launch(tmp, n, "contract")


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


@pytest.fixture(scope="module")
def sharded_runs(weights, tmp_path_factory):
    """``get(case)``: the results of the ``sharded`` launch of a case of
    SHARDED, run once a module."""
    launched = {}

    def get(case):
        if case not in launched:
            pixel_path, dtype, count, members, axes, max_clips = \
                SHARDED[case]
            launched[case] = _launch(
                tmp_path_factory.mktemp("sharded"), count, "sharded",
                weights=weights[1], members=members, axes=axes,
                dtype=dtype, pixel_path=pixel_path, max_clips=max_clips,
                seed=7, videos=2 * axes["dp"])
        return launched[case]
    return get


@pytest.mark.parametrize("case", sorted(SHARDED))
def test_sharded_inference_across_processes_matches_the_reference(
        weights, sharded_runs, case):
    pixel_path, dtype, count, members, axes, max_clips = SHARDED[case]
    variables, path = weights
    dp, sp = axes["dp"], axes["sp"]
    videos_n = 2 * dp
    results = sharded_runs(case)
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


@pytest.mark.parametrize("case", sorted(SHARDED))
def test_the_run_across_processes_waits_once_where_it_ends(sharded_runs,
                                                           case):
    # tolerance: none. The eager step issues its gather over the sp ring
    # with no host wait (the route the card's graph captures); the run,
    # the same step, waits once where it ends, only where it gathered
    # across processes, and gives the eager step's logits bitwise
    for got in sharded_runs(case):
        across = got["ring"] is not None
        assert got["host_waits"] == (0, 1 if across else 0)
        assert torch.equal(got["eager"], got["logits"])


@pytest.mark.parametrize("pixel_path", ["rgb", "yuv420"])
def test_a_one_process_run_is_its_step_and_waits_for_nothing(weights,
                                                             pixel_path):
    # tolerance: none. On the CPU the run is the eager step, captures
    # nothing and, with no collective across processes, waits for nothing
    si = parallel.make_sharded_inference(
        mesh=mesh.build_mesh([CPU] * 2, axes={"dp": 1, "sp": 2}),
        variables=torch.load(weights[1]), pixel_path=pixel_path,
        max_clips=3, dtype=torch.float32, **children.TINY_SI)
    rng = np.random.default_rng(3)
    videos = rng.integers(0, 256, si.batch_shape(2), dtype=np.uint8)
    vids, mask = si.place(videos, [3, 1])
    before = peers.host_waits
    got = si.run(vids, mask)
    assert peers.host_waits == before
    with torch.inference_mode():
        assert torch.equal(got, si.step(vids, mask))
    assert si.graph_stats == {"graphs": 0, "capture_s": 0.0, "replays": 0}


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


@pytest.fixture(scope="module")
def hops(tmp_path_factory):
    """The emulated ``rnb_ring_hop`` of each of four ring members: one
    library each (built side by side), so that the members' launches run
    at once, each waiting on the others' counters as on the card."""
    from concurrent.futures import ThreadPoolExecutor
    from test_torch_host_cuda import _build
    out = tmp_path_factory.mktemp("hops")
    dirs = [out / str(m) for m in range(4)]
    for d in dirs:
        d.mkdir()
    with ThreadPoolExecutor(4) as pool:
        libs = list(pool.map(lambda d: _build("ring.cu", str(d)), dirs))
    fns = []
    for lib in libs:
        fn = lib.rnb_ring_hop
        fn.restype = ctypes.c_int
        fn.argtypes = _kernels.RING_SHIFT.entries[
            _kernels.RING_HOP_ENTRY] + [ctypes.c_int, ctypes.c_void_p]
        fns.append(fn)
    return fns


def _words(counters):
    """A member's counter allocation as 64-bit words."""
    return counters.view(torch.int64)


def _post(counters, tiles, epoch):
    """Write a post by hand: ``tiles`` (place, rows, row_bytes, pitch)
    as hop ``epoch``."""
    w = _words(counters)
    for t, fields in enumerate(tiles):
        for k, v in enumerate(fields):
            w[(peers.POST + peers.POST_TILE_BYTES * t) // 8 + k] = v
    w[peers.POST_COUNT // 8] = len(tiles)
    w[peers.POSTED // 8] = epoch


class _Pair:
    """Member A's hop into member B by hand: both members' counters, B's
    arena of one segment (its bytes filled with 0xA5), A's pinned word."""

    def __init__(self, arena_bytes=4096):
        self.a = torch.zeros(peers.COUNTER_BYTES, dtype=torch.uint8)
        self.b = torch.zeros(peers.COUNTER_BYTES, dtype=torch.uint8)
        self.arena = torch.full((arena_bytes,), 0xA5, dtype=torch.uint8)
        self.report = torch.zeros(16, dtype=torch.int32)

    def error(self):
        return self.a.view(torch.int32)[peers.ERROR // 4].item()

    def launch(self, fn, tiles, remote, epoch=1, cap_s=5.0, segments=None):
        """A's hop ``epoch``: A's count of hops launched, on the card,
        set to ``epoch - 1`` (the launch takes one more)."""
        _words(self.a)[peers.HOPS // 8] = epoch - 1
        segments = [(self.arena.data_ptr(), self.arena.numel())] \
            if segments is None else segments
        return fn(*self.args(tiles, remote, cap_s, segments), 0, None)

    def args(self, tiles, remote, cap_s=5.0, segments=None):
        segments = [(self.arena.data_ptr(), self.arena.numel())] \
            if segments is None else segments
        return peers.hop_args(tiles, remote, self.b.data_ptr(), segments,
                              self.a.data_ptr(), self.report.data_ptr(),
                              int(cap_s * 1e9))

    def hops(self):
        """A's count of hops launched, as the card keeps it."""
        return int(_words(self.a)[peers.HOPS // 8])

    def reported_hop(self):
        return int(self.report.view(torch.int64)[peers.REPORT_HOP // 8])


def _remote(src, place, pitch=None):
    nbytes = src.numel() * src.element_size()
    return peers.Tile(src.data_ptr(), place, 1, nbytes, nbytes,
                      nbytes if pitch is None else pitch)


def test_the_hop_moves_and_signals_once_its_counter_is_reached(hops):
    # A posts where its own hop 1 lands, waits for B's post, writes its
    # bytes where B posted them, signals B's recv and waits for its own
    src = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, 40007, dtype=np.uint8))
    pair = _Pair(1 << 16)
    _post(pair.b, [(256, 1, 40007, 40007)], 1)
    _words(pair.a)[peers.RECV // 8] = 1
    own = 3 << peers.SEGMENT_SHIFT | 512
    assert pair.launch(hops[0], [_remote(src, own)], 1) == 0
    assert torch.equal(pair.arena[256:256 + 40007], src)
    assert (pair.arena[:256] == 0xA5).all()
    assert (pair.arena[256 + 40007:] == 0xA5).all()
    a, b = _words(pair.a), _words(pair.b)
    assert b[peers.RECV // 8] == 1 and a[peers.POSTED // 8] == 1
    assert a[peers.POST_COUNT // 8] == 1
    assert a[peers.POST // 8:peers.POST // 8 + 4].tolist() == [
        own, 1, 40007, 40007]
    assert _words(pair.a)[peers.DONE // 8] == 0
    assert pair.a.view(torch.int32)[peers.CLAIM // 4] == 0
    assert pair.error() == 0 and pair.report[0] == 0
    assert pair.hops() == 1 and pair.reported_hop() == 0


def test_a_wait_past_its_cap_writes_the_error_and_moves_nothing(hops):
    src = torch.arange(64, dtype=torch.uint8)
    pair = _Pair()
    t0 = time.monotonic()
    # B never posts
    assert pair.launch(hops[0], [_remote(src, 0)], 1, cap_s=0.05) == 0
    assert time.monotonic() - t0 < 10.0
    assert pair.error() == peers.TIMED_OUT  # timed out, and reported
    assert pair.report[0] == peers.TIMED_OUT
    assert pair.reported_hop() == 1 and pair.hops() == 1
    assert (pair.arena == 0xA5).all()
    assert _words(pair.b)[peers.RECV // 8] == 0  # signals nothing
    assert _words(pair.a)[peers.DONE // 8] == 0
    assert pair.a.view(torch.int32)[peers.CLAIM // 4] == 0
    # a member whose error word is set gives up at once, even where its
    # peer did post: nothing moves, nothing is signalled
    _post(pair.b, [(0, 1, 64, 64)], 2)
    t0 = time.monotonic()
    assert pair.launch(hops[0], [_remote(src, 0)], 1, epoch=2) == 0
    assert time.monotonic() - t0 < 4.0
    assert (pair.arena == 0xA5).all()
    assert _words(pair.b)[peers.RECV // 8] == 0
    # the first failing hop stays the one reported
    assert pair.reported_hop() == 1 and pair.hops() == 2
    # and a local launch moves nothing either
    dst = torch.zeros(64, dtype=torch.uint8)
    assert hops[0](*peers.hop_args([_tile(src, dst)], 0, None, [],
                                   pair.a.data_ptr(), None, 10), 0,
                   None) == 0
    assert not dst.any()


def test_a_hop_with_no_tiles_still_waits_and_signals(hops):
    # it posts an empty hop, waits for B's, signals B and waits for its own
    pair = _Pair()
    _post(pair.b, [], 1)
    _words(pair.a)[peers.RECV // 8] = 1
    assert pair.launch(hops[0], [], 0) == 0
    assert _words(pair.b)[peers.RECV // 8] == 1
    assert _words(pair.a)[peers.POSTED // 8] == 1
    assert _words(pair.a)[peers.POST_COUNT // 8] == 0
    assert pair.error() == 0


def test_the_hop_refuses_a_launch_without_its_words(hops):
    src = torch.arange(16, dtype=torch.uint8)
    pair = _Pair()
    fn = hops[0]
    segment = [(pair.arena.data_ptr(), pair.arena.numel())]

    def call(tiles, remote, succ, segments, own, cap, count=None):
        args = list(peers.hop_args(tiles, remote, succ, segments, own,
                                   None, cap))
        if count is not None:
            args[13] = count
        return fn(*args, 0, None)
    tile = _remote(src, 0)
    a, b = pair.a.data_ptr(), pair.b.data_ptr()
    dst = torch.zeros(16, dtype=torch.uint8)
    assert call([_tile(src, dst)], 0, None, [], a, 10) == 0
    assert torch.equal(dst, src)  # a local launch moves
    assert pair.hops() == 0  # and is no hop
    assert call([tile], 1, b, segment, None, 10) != 0  # no counters
    assert call([tile], 1, b, segment, a, -1) != 0  # a negative cap
    assert call([tile], 2, b, segment, a, 10) != 0  # remote > entries
    assert call([tile], 1, None, [], a, 10) != 0  # remote, no successor
    assert call([tile], 1, b, segment, a, 10, count=17) != 0
    assert call([tile], 1, b, [(0, 1 << 40)], a, 10) != 0
    empty = peers.Tile(src.data_ptr(), 0, 0, 16, 16, 16)
    assert call([empty], 1, b, segment, a, 10) != 0  # an empty remote
    assert pair.hops() == 0  # a refused launch runs nothing
    with pytest.raises(ValueError, match="at most 64 tiles"):
        peers.hop_args([tile] * 65, 0, b, segment, a, None, 10)


def _tile(src, dst):
    return peers.Tile(src.data_ptr(), dst.data_ptr(), 1,
                      src.numel() * src.element_size(),
                      src.numel() * src.element_size(),
                      dst.numel() * dst.element_size())


@pytest.mark.parametrize("post", ["bytes", "rows", "count", "past_segment",
                                  "no_segment", "pitch_past_segment"])
def test_a_post_that_disagrees_writes_the_error_and_moves_nothing(hops,
                                                                   post):
    # tolerance: none. B's post disagrees with A's table (another byte
    # count, another row split, another tile count, a place past B's
    # segment, rows whose pitch runs past it, or a segment A has not
    # opened): A writes the error word, and no byte moves, neither into
    # B's arena nor A's own local tile
    src = torch.arange(64, dtype=torch.uint8)
    pair = _Pair(4096)
    tiles = {"bytes": [(0, 1, 32, 32)], "rows": [(0, 2, 32, 64)],
             "count": [(0, 1, 64, 64), (128, 1, 64, 64)],
             "past_segment": [(4096 - 32, 1, 64, 64)],
             "no_segment": [(1 << peers.SEGMENT_SHIFT, 1, 64, 64)],
             "pitch_past_segment": [(0, 2, 32, 4096)]}[post]
    # two rows of 32 bytes, received at a pitch of 64, where rows are
    # posted
    mine = peers.Tile(src.data_ptr(), 0, 2, 32, 32, 64) \
        if post == "pitch_past_segment" else _remote(src, 0)
    _post(pair.b, tiles, 1)
    _words(pair.a)[peers.RECV // 8] = 1
    local_src = torch.arange(100, dtype=torch.uint8)
    local_dst = torch.zeros(100, dtype=torch.uint8)
    assert pair.launch(hops[0], [mine, _tile(local_src, local_dst)], 1) == 0
    assert pair.error() == peers.TABLES_DIFFER
    assert pair.report[0] == peers.TABLES_DIFFER
    assert pair.reported_hop() == 1 and pair.hops() == 1
    assert (pair.arena == 0xA5).all() and not local_dst.any()
    assert _words(pair.b)[peers.RECV // 8] == 0


def _by_hand(kind, src, local_src, local_dst):
    """A hop of ``kind`` by hand: A's tiles, how many land in B, and B's
    post of them (place, rows, row_bytes, pitch)."""
    if kind == "dense":
        return [_remote(src, 256)], 1, [(256, 1, 64, 64)]
    if kind == "pitched":
        # four rows of 16 bytes, landing in B at a pitch of 32
        return [peers.Tile(src.data_ptr(), 0, 4, 16, 16, 32)], 1, [
            (128, 4, 16, 32)]
    if kind == "with_local":
        return [_remote(src, 256), _tile(local_src, local_dst)], 1, [
            (256, 1, 64, 64)]
    return [], 0, []


@pytest.mark.parametrize("kind", ["dense", "pitched", "with_local", "empty"])
def test_the_same_launch_arguments_launched_twice_are_two_hops(hops, kind):
    # tolerance: none. One set of C arguments, launched twice (what a
    # replayed graph does): the card numbers the launches 1 and 2 (A's
    # count of hops, which each stores back), each posts its own number,
    # takes only B's post of that number, moves the source's bytes as they
    # are at its launch and signals B once
    src = torch.arange(64, dtype=torch.uint8)
    local_src = torch.arange(100, dtype=torch.uint8)
    local_dst = torch.zeros(100, dtype=torch.uint8)
    pair = _Pair()
    tiles, remote, post = _by_hand(kind, src, local_src, local_dst)
    args = pair.args(tiles, remote)
    for hop in (1, 2):
        src.add_(hop)
        local_src.add_(hop)
        _post(pair.b, post, hop)
        _words(pair.a)[peers.RECV // 8] = hop
        assert hops[0](*args, 0, None) == 0
        assert pair.error() == 0 and pair.report[0] == 0
        assert pair.hops() == hop
        assert _words(pair.a)[peers.POSTED // 8] == hop
        assert _words(pair.b)[peers.RECV // 8] == hop
        if kind == "pitched":
            for r in range(4):
                assert torch.equal(pair.arena[128 + 32 * r:144 + 32 * r],
                                   src[16 * r:16 * r + 16])
                assert (pair.arena[144 + 32 * r:160 + 32 * r] == 0xA5).all()
        elif kind != "empty":
            assert torch.equal(pair.arena[256:320], src)
        if kind == "with_local":
            assert torch.equal(local_dst, local_src)
        if kind == "empty":
            assert (pair.arena == 0xA5).all()


@pytest.mark.parametrize("launched", [1, 2, 7])
def test_a_stale_post_of_the_last_hop_is_not_taken(hops, launched):
    # A has launched `launched` hops and B's post is still that of the
    # last one: A's next launch is hop launched + 1, which waits for B's
    # post of that number, gives up at the cap, writes and reports
    # TIMED_OUT with its number, and moves nothing (a replay never reads
    # the previous replay's post)
    src = torch.arange(64, dtype=torch.uint8)
    pair = _Pair()
    _post(pair.b, [(0, 1, 64, 64)], launched)
    _words(pair.a)[peers.RECV // 8] = launched + 1
    assert pair.launch(hops[0], [_remote(src, 0)], 1, epoch=launched + 1,
                       cap_s=0.05) == 0
    assert pair.error() == peers.TIMED_OUT == pair.report[0]
    assert pair.reported_hop() == launched + 1 == pair.hops()
    assert _words(pair.a)[peers.POSTED // 8] == launched + 1
    assert (pair.arena == 0xA5).all()
    assert _words(pair.b)[peers.RECV // 8] == 0


@pytest.mark.parametrize("later", ["hop", "local"])
@pytest.mark.parametrize("cause", ["timed_out", "tables_differ", "set"])
def test_a_set_error_word_sticks_and_later_launches_move_nothing(
        hops, cause, later):
    # tolerance: none. Once A's error word is set (a wait past its cap, a
    # post that disagreed, or set before any launch), two later launches
    # move nothing even where B posted rightly: no byte lands, B is not
    # signalled, the word keeps its value and the report its first
    # failing hop. A hop still counts (the members' counts stay in step);
    # a local launch is no hop
    src = torch.arange(64, dtype=torch.uint8)
    pair = _Pair()
    code = peers.TABLES_DIFFER if cause == "tables_differ" \
        else peers.TIMED_OUT
    if cause == "set":
        pair.a.view(torch.int32)[peers.ERROR // 4] = code
    else:
        if cause == "tables_differ":
            _post(pair.b, [(0, 1, 32, 32)], 1)
        _words(pair.a)[peers.RECV // 8] = 1
        assert pair.launch(hops[0], [_remote(src, 0)], 1, cap_s=0.05) == 0
    assert pair.error() == code
    first = pair.hops()
    for k in range(2):
        epoch = first + 1 + k
        _post(pair.b, [(0, 1, 64, 64)], epoch)
        _words(pair.a)[peers.RECV // 8] = epoch
        if later == "hop":
            assert hops[0](*pair.args([_remote(src, 0)], 1, cap_s=0.05), 0,
                           None) == 0
            assert pair.hops() == epoch
        else:
            dst = torch.zeros(64, dtype=torch.uint8)
            assert hops[0](*peers.hop_args(
                [_tile(src, dst)], 0, None, [], pair.a.data_ptr(),
                pair.report.data_ptr(), 10), 0, None) == 0
            assert not dst.any() and pair.hops() == first
        assert pair.error() == code
        assert (pair.arena == 0xA5).all()
        assert _words(pair.b)[peers.RECV // 8] == 0
    reported = cause != "set" or later == "hop"
    assert pair.report[0] == (code if reported else 0)
    assert pair.reported_hop() == (1 if reported else 0)


class _HostEndpoint(peers.Endpoint):
    """A ring member's endpoint in this process, on the host: its counters
    and arena in host memory (an arena segment filled with 0xA5), its
    peers the other members of ``group``, their handles exchanged at a
    barrier. Each launch runs the member's own emulated ``rnb_ring_hop``
    at once (``fns``) or, with none, is only recorded."""

    def __init__(self, group, n, member, fns, barrier):
        self._setup(mesh.Ring([mesh.Member(p, CPU) for p in range(n)],
                              "tp"), "host", None)
        self.member = member
        self.peer_segments = {m: [] for m in range(self.degree)
                              if m != member}
        self.group, self.fn, self.meet = group, fns and fns[member], barrier
        self.memory = []
        self.counter_bytes = torch.zeros(peers.COUNTER_BYTES,
                                         dtype=torch.uint8)
        self.counters = self.counter_bytes.data_ptr()
        self.report_word = torch.zeros(16, dtype=torch.int32)
        self.report_host = self.report_dev = self.report_word.data_ptr()
        self.arena = peers.Arena(CPU, self._allocate, lambda ptr: None)
        self.launches = []
        self.captured = []

    def link(self):
        self.peer_counters = {ep.member: ep.counters for ep in self.group
                              if ep is not self}

    def _allocate(self, nbytes):
        self.memory.append(torch.full((nbytes,), 0xA5, dtype=torch.uint8))
        return self.memory[-1].data_ptr()

    def _exchange(self, ptr, nbytes):
        self.shared = (ptr, nbytes)
        self.meet.wait()
        opened = {ep.member: ep.shared for ep in self.group
                  if ep is not self}
        self.meet.wait()
        return opened

    def _launch(self, args):
        self.launches.append(args)
        if peers.capturing() is not None:
            # a captured launch runs only when the graph is replayed
            self.captured.append(args)
        elif self.fn:
            assert self.fn(*args, 0, None) == 0

    def replay(self):
        """Run the captured launches again, as a graph's replay does."""
        for args in self.captured:
            assert self.fn(*args, 0, None) == 0


_member = __import__("threading").local()


def _members(monkeypatch, hops, n, run, live=True):
    """``run(ring, member)`` as every member of a ring of ``n`` processes
    at once, one thread each, on the card's path with host memory: each
    member's hops through its own emulated kernel. Returns each member's
    result and its endpoint."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    group = []
    barrier = threading.Barrier(n)
    for m in range(n):
        group.append(_HostEndpoint(group, n, m, hops if live else None,
                                   barrier))
    for ep in group:
        ep.link()
    monkeypatch.setattr(mesh, "this_process", lambda: _member.value)
    monkeypatch.setattr(dma, "_card_path", lambda ring: True)
    monkeypatch.setattr(peers, "endpoint", lambda ring: group[_member.value])
    previous = peers.set_wait_cap(20.0)

    def one(m):
        _member.value = m
        return run(mesh.Ring([mesh.Member(p, CPU) for p in range(n)],
                             "tp"), m)
    try:
        with ThreadPoolExecutor(n) as pool:
            results = [f.result(timeout=120) for f in
                       [pool.submit(one, m) for m in range(n)]]
    finally:
        peers.set_wait_cap(previous)
        monkeypatch.undo()
    for ep in group:
        assert ep.reported() == 0
        # the card's count of hops launched is the host's
        assert not live or _words(ep.counter_bytes)[
            peers.RECV // 8] == ep.epoch == _words(ep.counter_bytes)[
                peers.HOPS // 8]
    return results, group


def _in_arena(ep, t):
    return ep.arena.place(t.data_ptr(), t.untyped_storage().nbytes()) \
        is not None


@pytest.mark.parametrize("tiles,launches", [(1, 1), (64, 1), (65, 2),
                                            (128, 2), (200, 4)])
def test_the_hop_takes_as_few_launches_as_hold_its_tiles(
        hops, monkeypatch, tiles, launches):
    # a table of `tiles` entries at one shift: as few hops as hold them,
    # each one launch of at most 64 tiles
    shards = [torch.full((16,), i, dtype=torch.uint8) for i in range(tiles)]

    def run(ring, m):
        outs = dma._empty_across([peers.spec_like(s) for s in shards], ring)
        dma._group_across([dma.RingEntry([s], [o], 1)
                           for s, o in zip(shards, outs)], ring)
        return outs
    _, group = _members(monkeypatch, hops, 2, run, live=False)
    for ep in group:
        assert len(ep.launches) == launches == ep.epoch
        assert sum(args[8] for args in ep.launches) == tiles
        assert all(args[9] == args[8] <= peers.HOP_MAX_TILES
                   for args in ep.launches)


def test_each_post_is_the_receiver_s_destination_and_the_sender_s_bytes(
        hops, monkeypatch):
    # a gather on the last axis at degree 2: each member posts the place
    # of its own slot for the predecessor's shard (rows at the full row's
    # pitch), and the rows its successor sends it are the rows it posted
    full = children.values("float32", (8, 4, 8), seed=5)

    def run(ring, m):
        out = dma.ring_all_gather_many([[children.shard(full, 2, -1, m)]],
                                       -1, ring)
        return out[0][0]
    results, group = _members(monkeypatch, hops, 2, run)
    for m, ep in enumerate(group):
        (args,) = ep.launches
        srcs, dsts, src_pitch, dst_pitch, _, rows, row_bytes, n, entries, \
            remote = args[:10]
        assert (n, entries, remote) == (1, 2, 1)
        # tile 0 lands in the successor: its dst is this member's post
        slot = results[m][..., 4 * ((m - 1) % 2):][..., :4]
        assert (dsts[0] or 0) == ep.arena.place(slot.data_ptr(), 4)
        assert (rows[0], row_bytes[0], dst_pitch[0]) == (32, 16, 32)
        succ = group[(m + 1) % 2].launches[0]
        assert (succ[5][0], succ[6][0]) == (rows[0], row_bytes[0])
        assert torch.equal(results[m], full)


def test_ring_shift_group_into_a_caller_s_destination_lands_through_one_copy(
        hops, monkeypatch):
    # tolerance: none. A destination of the caller's own, outside the
    # arena, rows at a pitch: the hop lands in an arena slot, one local
    # launch (counted) places it, and nothing else of the caller's tensor
    # is written
    full = children.values("bfloat16", (6, 10), seed=11)

    def run(ring, m):
        dst = torch.full((6, 10), -1.0, dtype=torch.bfloat16)
        src = children.shard(full, 2, -1, m)
        dma.ring_shift_group([dma.RingEntry([src], [dst[:, :5]], 1)], ring)
        return dst
    results, group = _members(monkeypatch, hops, 2, run)
    for m, (dst, ep) in enumerate(zip(results, group)):
        assert torch.equal(dst[:, :5], children.shard(full, 2, -1,
                                                      (m - 1) % 2))
        assert (dst[:, 5:] == -1).all()
        # the hop, then the placement: two launches of the kernel (each
        # counted on the card, Endpoint._launch)
        assert len(ep.launches) == 2
        hop, place = ep.launches
        assert (hop[9], hop[10]) == (1, ep.peer_counters[(m + 1) % 2])
        assert (place[9], place[10]) == (0, None)


def test_an_arena_range_is_not_handed_out_while_its_tensor_lives():
    arena = peers.Arena(CPU, lambda n: 0, lambda p: None)
    base = torch.zeros(1 << 20, dtype=torch.uint8)
    arena.add(base.data_ptr(), base.numel())
    (lease,) = arena.take([1024])
    first = lease.offset
    t = arena.tensor(lease, (256,), (1,), torch.float32)
    del lease
    view = t[10:20]
    del t
    # the view holds the range
    (other,) = arena.take([1024])
    assert other.offset != first and arena.leased == [2048]
    del other, view
    assert arena.leased == [0]
    (again,) = arena.take([1 << 20])  # coalesced whole again
    assert again.offset == 0


def test_a_freed_range_waits_for_its_stream_before_another_takes_it():
    class Stream:
        def __init__(self):
            self.waited = []

        def wait_stream(self, other):
            self.waited.append(other)
    one, two = Stream(), Stream()
    current = [one]
    arena = peers.Arena(CPU, lambda n: 0, lambda p: None,
                        stream=lambda: current[0])
    base = torch.zeros(1 << 16, dtype=torch.uint8)
    arena.add(base.data_ptr(), base.numel())
    (lease,) = arena.take([4096])
    del lease
    # on the stream it was taken on, stream order keeps the work queued
    # before the free ahead of the next writer: no wait
    (lease,) = arena.take([4096])
    assert lease.offset == 0 and one.waited == []
    del lease
    # on another stream, that stream waits for the first
    current[0] = two
    (lease,) = arena.take([4096])
    assert lease.offset == 0 and two.waited == [one]


def test_the_arena_grows_by_doubling_and_never_frees_a_viewed_segment():
    freed = []
    memory = []

    def allocate(nbytes):
        memory.append(torch.zeros(nbytes, dtype=torch.uint8))
        return memory[-1].data_ptr()
    arena = peers.Arena(CPU, allocate, freed.append)
    assert arena.shortfall([100, 300]) == 256 + 512
    assert arena.grown_size(768) == peers.ARENA_QUANTUM
    arena.add(allocate(peers.ARENA_QUANTUM), peers.ARENA_QUANTUM)
    (held,) = arena.take([4096])
    assert arena.shortfall([peers.ARENA_QUANTUM]) == peers.ARENA_QUANTUM
    assert arena.grown_size(peers.ARENA_QUANTUM) == peers.ARENA_QUANTUM
    arena.add(allocate(2 << 20), 2 << 20)
    assert arena.grown_size(1) == 3 << 20
    arena.close()
    # the segment a lease still views is freed with its last lease
    assert freed == [memory[1].data_ptr()]
    del held
    assert freed == [memory[1].data_ptr(), memory[0].data_ptr()]


#: a child that frees leases inside garbage collections started by the
#: arena's own allocations: over host memory from malloc, a collection at
#: every allocation, each round a leased tensor left in a reference cycle
#: and then a take, whose allocations under the arena's lock collect the
#: cycle on the same thread. With more threads than cores and a short
#: switch interval, the threads' releases and takes interleave, and every
#: range must come back: a lost release leaves bytes leased at the end
GC_RELEASE_CHILD = r"""
import ctypes, gc, sys, threading
import torch
from rnb_tpu_torch.parallel import peers
rounds, threads = int(sys.argv[1]), int(sys.argv[2])
libc = ctypes.CDLL(None)
libc.malloc.restype = ctypes.c_void_p
libc.malloc.argtypes = [ctypes.c_size_t]
libc.free.argtypes = [ctypes.c_void_p]
freed = []
def free(ptr):
    freed.append(ptr)
    libc.free(ptr)
arena = peers.Arena(torch.device("cpu"), libc.malloc, free)
size = 16 << 20
base = libc.malloc(size)
arena.add(base, size)
def work():
    for _ in range(rounds):
        (lease,) = arena.take([1024])
        t = arena.tensor(lease, (256,), (1,), torch.float32)
        cycle = [t]
        cycle.append(cycle)
        del lease, t, cycle
        arena.take([256, 512])
gc.set_threshold(1, 1000, 1000)
sys.setswitchinterval(1e-6)
workers = [threading.Thread(target=work) for _ in range(threads)]
for w in workers:
    w.start()
for w in workers:
    w.join()
gc.collect()
assert arena.leased == [0], arena.leased
(whole,) = arena.take([size])  # every range came back, coalesced
assert whole.offset == 0
del whole
arena.close()
assert freed == [base], freed
print("rounds done")
"""
#: rounds a thread; threads (more than the suite's cores where many)
GC_RELEASE_RUNS = {"one-thread": (2000, 1), "threads": (200, 16)}
#: the child's wall limit: its rounds take a few seconds at most
GC_RELEASE_WALL_S = 60


@pytest.mark.parametrize("run", sorted(GC_RELEASE_RUNS))
def test_a_lease_freed_by_a_collection_under_the_arena_lock_returns(run):
    # a lease's __del__ that a garbage collection runs while its own
    # thread holds the arena's lock must not wait on that lock: the child
    # hangs there where it does, and the wall limit fails the test
    rounds, threads = GC_RELEASE_RUNS[run]
    try:
        done = subprocess.run(
            [sys.executable, "-c", GC_RELEASE_CHILD, str(rounds),
             str(threads)], cwd=os.path.dirname(HERE),
            capture_output=True, text=True, timeout=GC_RELEASE_WALL_S)
    except subprocess.TimeoutExpired:
        pytest.fail("the arena deadlocked: %d rounds on %d thread(s) of a "
                    "lease freed by a collection under its lock did not "
                    "end in %d s" % (rounds, threads, GC_RELEASE_WALL_S))
    assert done.returncode == 0, done.stderr[-4000:]
    assert done.stdout.strip() == "rounds done"


@pytest.mark.parametrize("n", [2, 4])
def test_each_process_s_gather_through_the_hop_kernel_is_the_unsharded(
        hops, monkeypatch, n):
    # tolerance: none. Each member's gather of mixed leaves (float32 rows
    # at a pitch on axis -1; a channels-last u8 conv kernel and odd bytes
    # on axis 0), all members at once through the emulated kernel: every
    # member's result is the unsharded leaf, laid out as it, in the
    # member's arena, in one launch a hop
    for axis in (0, -1):
        fulls = [children.values("float32", (8, 4, 8), seed=n + axis)]
        if axis == 0:
            fulls += [children.conv_leaf(n, seed=2 * n),
                      children.values("uint8", (n * 7, 3), seed=n)]

        def run(ring, m):
            leaves = [[children.shard(f, n, axis, m).contiguous(
                memory_format=torch.channels_last_3d) if f.dim() == 5
                else children.shard(f, n, axis, m)] for f in fulls]
            return dma.ring_all_gather_many(leaves, axis, ring)
        results, group = _members(monkeypatch, hops, n, run)
        for gathered, ep in zip(results, group):
            assert len(ep.launches) == ep.epoch == n - 1
            for (member,), full in zip(gathered, fulls):
                assert torch.equal(member, full)
                assert member.stride() == full.stride()
                assert _in_arena(ep, member)


@pytest.mark.parametrize("n,shift", [(2, 1), (4, 1), (4, 3)])
def test_each_process_s_shift_through_the_hop_kernel_is_the_roll(
        hops, monkeypatch, n, shift):
    full = children.values("bfloat16", (n * 3, 5), seed=n + shift)

    def run(ring, m):
        return dma.ring_shift([children.shard(full, n, 0, m)], shift,
                              ring)[0]
    outs, group = _members(monkeypatch, hops, n, run)
    assert torch.equal(torch.cat(outs), torch.roll(full, 3 * shift, 0))
    assert all(len(ep.launches) == 1 and _in_arena(ep, out)
               for ep, out in zip(group, outs))


@pytest.mark.parametrize("n", [2, 4])
def test_each_process_s_reduce_scatter_through_the_hop_kernel_is_exact(
        hops, monkeypatch, n):
    # tolerance: none (integer-valued float32: any order of the sums is
    # exact); each hop's moved chunk lands in the arena
    operands = [children.integers((3, 2 * n), seed=40 + i)
                for i in range(n)]
    total = sum(operands)

    def run(ring, m):
        return dma.ring_psum_scatter([operands[m]], ring, -1)[0]
    chunks, group = _members(monkeypatch, hops, n, run)
    assert torch.equal(torch.cat(chunks, -1), total)
    assert all(len(ep.launches) == n - 1 for ep in group)


#: replays of a captured gather
REPLAYS = 3


@pytest.mark.parametrize("n", [2, 4])
def test_a_captured_gather_replays_as_each_member_s_next_hops(
        hops, monkeypatch, n):
    # tolerance: none. Every member warms a gather up (eager), makes its
    # arena hold the warm-up's leases, captures the same gather (its
    # launches recorded, not run; its leases held by the capture), then
    # replays the recorded launches, all members at once, with new shards
    # in the captured input: each replay is every member's next n - 1
    # hops on the card and gathers that replay's shards bitwise, no host
    # wait is made, and the capture's leases stay leased until it dies
    fulls = [children.values("float32", (8, 4, 8), seed=100 * n + r)
             for r in range(REPLAYS + 1)]
    before = peers.host_waits

    def run(ring, m):
        ep = peers.endpoint(ring)
        static = children.shard(fulls[0], n, -1, m).clone()
        capture = peers.Capture()
        with capture.warm():
            ((warm,),) = dma.ring_all_gather_issued([[static]], -1, ring)
        warmed = torch.equal(warm, fulls[0])
        del warm
        with capture.capture():
            ((out,),) = dma.ring_all_gather_issued([[static]], -1, ring)
        recorded = len(ep.captured)
        replays = []
        for r in range(1, REPLAYS + 1):
            static.copy_(children.shard(fulls[r], n, -1, m))
            ep.replay()
            capture.replayed()
            replays.append(out.clone())
        held = _in_arena(ep, out)
        del out
        leased = sum(ep.arena.leased)
        hops_tallied = dict(capture.hops)
        del capture
        return (warmed, recorded, replays, held, leased,
                sum(ep.arena.leased), hops_tallied)
    results, group = _members(monkeypatch, hops, n, run)
    assert peers.host_waits == before
    for m, (ep, got) in enumerate(zip(group, results)):
        warmed, recorded, replays, held, leased, after, tallied = got
        assert warmed and recorded == n - 1 and held
        assert tallied == {ep: n - 1}
        for r, out in enumerate(replays, 1):
            assert torch.equal(out, fulls[r])
        # the capture held its lease after its tensor died; then let go
        assert leased > 0 and after == 0
        assert ep.epoch == (n - 1) * (REPLAYS + 1)


#: arena requests of a warm-up, as (kind, what)
WARM_UP = [("empty", [((4, 6), (6, 1), torch.float32),
                      ((0, 3), (3, 1), torch.uint8)]),
           ("reserve", [100, 3000]), ("reserve", [])]


@pytest.mark.parametrize("n", [2, 4])
def test_a_capture_gets_again_what_its_warm_up_took(hops, monkeypatch, n):
    # a capture takes nothing from an arena, grows none (cudaMalloc and an
    # exchange of handles cannot be captured) and makes no tensor over one:
    # each endpoint hands it, in order, the tensors and leases its warm-up
    # took, which the capture holds until it dies
    def ask(ep, kind, what):
        return ep.empty(what) if kind == "empty" else ep.reserve(what)

    def run(ring, m):
        ep = peers.endpoint(ring)
        capture = peers.Capture()
        with capture.warm():
            warm = [ask(ep, kind, what) for kind, what in WARM_UP]
        segments, leased = len(ep.arena.sizes), sum(ep.arena.leased)
        with capture.capture():
            again = [ask(ep, kind, what) for kind, what in WARM_UP]
        same = all(a is b for w, g in zip(warm, again) for a, b in zip(w, g))
        grown = len(ep.arena.sizes) - segments
        more = sum(ep.arena.leased) - leased
        del warm, again
        held = sum(ep.arena.leased)
        del capture
        return same, grown, more, held, sum(ep.arena.leased)
    results, _ = _members(monkeypatch, hops, n, run, live=False)
    for same, grown, more, held, after in results:
        assert same and grown == 0 and more == 0
        assert held == _aligned(96) + _aligned(100) + _aligned(3000)
        assert after == 0


def _aligned(nbytes):
    return -(-nbytes // peers.ARENA_ALIGN) * peers.ARENA_ALIGN


@pytest.mark.parametrize("asked", ["another_shape", "more", "unwarmed"])
def test_a_capture_asking_what_its_warm_up_did_not_raises(
        hops, monkeypatch, asked):
    def run(ring, m):
        ep = peers.endpoint(ring)
        capture = peers.Capture()
        if asked != "unwarmed":
            with capture.warm():
                ep.empty([((4, 6), (6, 1), torch.float32)])
        segments = len(ep.arena.sizes)
        with capture.capture():
            if asked == "more":
                ep.empty([((4, 6), (6, 1), torch.float32)])
            with pytest.raises(RuntimeError,
                               match="takes only what its warm-up took"):
                ep.empty([((4, 7), (7, 1), torch.float32)])
        return len(ep.arena.sizes) - segments
    results, _ = _members(monkeypatch, hops, 2, run, live=False)
    assert results == [0, 0]


def test_the_issued_gather_takes_a_ring_across_processes():
    with pytest.raises(ValueError, match="spans processes"):
        dma.ring_all_gather_issued([[torch.zeros(2), torch.zeros(2)]], 0,
                                   mesh.Ring([CPU, CPU]))


def test_host_waits_count_outside_a_capture_and_are_tallied_inside():
    before = peers.host_waits
    peers.wait_for_card(CPU)
    assert peers.host_waits == before + 1
    capture = peers.Capture()
    with capture.capture():
        assert peers.capturing() is capture
        peers.wait_for_card(CPU)
    assert peers.capturing() is None
    assert peers.host_waits == before + 1 and capture.host_waits == 1
    with capture.warm():
        # the warm-up runs eagerly: its waits are real
        assert peers.capturing() is None
        peers.wait_for_card(CPU)
    assert peers.host_waits == before + 2 and capture.host_waits == 1


def test_the_hop_probe_s_variants_apply_to_the_kernel_source(tmp_path):
    # every variant the probe times is a patch of csrc/ring.cu as it is;
    # the parent's hop is read from another checkout's tree
    from rnb_tpu_torch.tools import hop_probe
    parent = tmp_path / "rnb_tpu_torch" / "csrc"
    parent.mkdir(parents=True)
    (parent / "ring.cu").write_text("// the parent's ring.cu\n")
    code = hop_probe.sources(str(tmp_path))
    assert set(code) == {"hop_" + name for name in hop_probe.VARIANTS} | {
        "hop_parent"}
    assert code["hop_parent"] == "// the parent's ring.cu\n"
    kernel = code["hop_kernel"]
    assert all(text != kernel for name, text in code.items()
               if name not in ("hop_kernel", "hop_parent"))

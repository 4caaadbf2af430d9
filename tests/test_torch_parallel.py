"""The reference's parallel API in the port (``rnb_tpu_torch.parallel``:
the mesh helpers, ``ShardedInference``'s own constructor with ``place``,
``run`` and ``predict``, ``make_sharded_inference``, ``distributed``'s
single-process API; ``ops/handoff_dma``'s ``ring_shift_amount``,
``dma_available`` and ``reshard``) held to the JAX package's, on the
CPU.

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py``; the
port's mesh members all lie on the CPU (a port mesh over distinct
devices is not yet ported), where its ingest wrappers run their plain
versions. Inputs come from numpy seeds, and the JAX package's seeded
init is carried into the port with ``from_jax_variables`` (or read from
the reference's own checkpoint file). Size: 2 frames of 112 x 112,
layer sizes (1, 1, 1, 1), 8 classes, at most 3 clips a video. Bounds:
the JAX package's sharded bound in bf16 (rtol = atol = 2e-2,
``tests/test_parallel.py``) and the network's in float32 (5e-4), as
``tests/test_torch_mesh.py``.
"""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec

from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.ops import handoff_dma as jax_dma
from rnb_tpu.parallel import distributed as jax_distributed
from rnb_tpu.parallel import mesh as jax_mesh
from rnb_tpu.parallel import sharded as jax_sharded
from rnb_tpu_torch import parallel
from rnb_tpu_torch.config import ConfigError
from rnb_tpu_torch.models.r2p1d.checkpoint import from_jax_variables
from rnb_tpu_torch.ops import handoff_dma
from rnb_tpu_torch.parallel import distributed, mesh

torch.set_num_threads(2)

CPU = torch.device("cpu")
LS = (1, 1, 1, 1)
CLASSES = 8
TINY_SI = dict(consecutive_frames=2, num_classes=CLASSES, layer_sizes=LS)
BF16_TOL = 2e-2
F32_TOL = 5e-4


def _outcome(fn, *args, **kwargs):
    """``("ok", result)`` or ``(exception type, message)``."""
    try:
        return "ok", fn(*args, **kwargs)
    except Exception as e:  # the refusals are compared, type and text
        return type(e), str(e)


# -- MeshSpec, factor_devices, build_mesh, submeshes --------------------------

MESH_SPECS = [{"dp": 2, "sp": 4}, {"dp": -1, "sp": 2}, {"dp": 3, "sp": 2},
              {"dp": -1, "sp": 3}, {"dp": -1}, {"sp": 8}, {"dp": -1, "sp": 1},
              {"pp": 2, "dp": -1, "sp": 2}, {"dp": -1, "sp": -1}, {},
              {"dp": 0, "sp": 2}, {"dp": -2}]
AXIS_NAMES = [("dp",), ("dp", "sp"), ("pp", "dp", "sp")]


@pytest.mark.parametrize("num_devices", range(1, 17))
def test_mesh_spec_resolve_as_the_reference(num_devices):
    for axes in MESH_SPECS:
        ours = _outcome(lambda: mesh.MeshSpec(axes).resolve(num_devices))
        theirs = _outcome(
            lambda: jax_mesh.MeshSpec(axes).resolve(num_devices))
        assert ours == theirs, (axes, num_devices)
        if ours[0] == "ok":
            assert list(ours[1]) == list(theirs[1])  # axis order too
    assert repr(mesh.MeshSpec({"dp": -1})) == repr(
        jax_mesh.MeshSpec({"dp": -1}))


@pytest.mark.parametrize("num_devices", range(0, 17))
def test_factor_devices_as_the_reference(num_devices):
    for names in AXIS_NAMES:
        ours = _outcome(mesh.factor_devices, num_devices, names)
        theirs = _outcome(jax_mesh.factor_devices, num_devices, names)
        assert ours == theirs, (num_devices, names)
        if ours[0] == "ok":
            assert list(ours[1]) == list(names)


def _indices(grid):
    """A port mesh's members (torch devices) or a jax mesh's (jax
    devices) as their integer ids, in the grid's shape."""
    return np.vectorize(
        lambda d: d.index if isinstance(d, torch.device) else d.id,
        otypes=[int])(grid)


@pytest.fixture
def distinct_members(monkeypatch):
    """Meshes over distinct cards are refused (not yet ported); to see
    the member order the helpers produce, this lifts the refusal, and the
    members are ``torch.device("cuda", i)`` objects, which need no
    card."""
    monkeypatch.setattr(mesh, "_one_device", lambda *args: None)
    return [torch.device("cuda", i) for i in range(8)]


BUILDS = [dict(axes={"dp": 2, "sp": 4}), dict(axes={"dp": -1, "sp": 2}),
          dict(axis_names=("dp", "sp")), dict(axis_names=("pp", "dp", "sp")),
          dict(axes={"x": 8})]


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_build_mesh_matches_the_reference(n, distinct_members):
    for kwargs in BUILDS:
        theirs = _outcome(jax_mesh.build_mesh, jax.devices()[:n], **kwargs)
        ours = _outcome(mesh.build_mesh, distinct_members[:n], **kwargs)
        if theirs[0] != "ok":
            assert ours == theirs, (n, kwargs)
            continue
        assert ours[0] == "ok", (n, kwargs, ours)
        assert ours[1].shape == dict(theirs[1].shape)
        assert list(ours[1].shape) == list(theirs[1].axis_names)
        assert np.array_equal(_indices(ours[1].devices),
                              _indices(theirs[1].devices))


@pytest.mark.parametrize("stages", [
    ([4, 4], [{"dp": 2, "sp": 2}, {"dp": -1, "sp": 1}]),
    ([3, 5], None), ([1, 2, 3], None), ([4, 3], [{"dp": 4}, {"dp": 3}]),
    ([6, 4], None), ([2, 2], [{"dp": 3}, None])])
def test_submeshes_carve_consecutive_members_as_the_reference(
        stages, distinct_members):
    sizes, axes = stages
    theirs = _outcome(jax_mesh.submeshes, jax.devices(), sizes, axes)
    ours = _outcome(mesh.submeshes, distinct_members, sizes, axes)
    if theirs[0] != "ok":
        assert ours == theirs
        return
    assert len(ours[1]) == len(theirs[1])
    for a, b in zip(ours[1], theirs[1]):
        assert a.shape == dict(b.shape)
        assert np.array_equal(_indices(a.devices), _indices(b.devices))


def test_one_card_hosts_a_mesh_and_distinct_cards_stay_refused():
    one = mesh.build_mesh([CPU] * 8, axes={"dp": 2, "sp": 4})
    assert one.shape == {"dp": 2, "sp": 4} and one.device == CPU
    a, b = mesh.submeshes([CPU] * 8, [5, 3])
    assert (a.shape, b.shape) == ({"dp": 5, "sp": 1}, {"dp": 3, "sp": 1})
    with pytest.raises(NotImplementedError, match="not yet ported"):
        mesh.build_mesh([torch.device("cuda", i) for i in range(2)])
    # the default members are the visible cards: none here, so 8 of 0
    # is refused as the reference refuses 8 of 1
    with pytest.raises(ValueError) as ours:
        mesh.build_mesh(axes={"dp": 2, "sp": 4})
    with pytest.raises(ValueError) as theirs:
        jax_mesh.build_mesh(jax.devices()[:0], axes={"dp": 2, "sp": 4})
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="need at least one device"):
        mesh.build_mesh()


def test_the_package_exports_the_reference_s_names():
    from rnb_tpu import parallel as jax_parallel
    assert sorted(parallel.__all__) == sorted(jax_parallel.__all__)
    for name in parallel.__all__:
        assert callable(getattr(parallel, name))
    assert parallel.ShardedInference is parallel.sharded.ShardedInference
    with pytest.raises(AttributeError):
        parallel.no_such_name


# -- ShardedInference: place, run, predict ------------------------------------

@pytest.fixture(scope="module")
def weights():
    """The JAX package's seeded init of the tiny network."""
    return jax_ckpt.load_or_init(1, 5, CLASSES, LS, None)


def _pair(weights, dp, sp, max_clips, pixel_path, dtype, **ours_kwargs):
    theirs = jax_sharded.make_sharded_inference(
        mesh=JaxMesh(np.array(jax.devices()[:dp * sp]).reshape(dp, sp),
                     ("dp", "sp")),
        variables=weights, pixel_path=pixel_path, max_clips=max_clips,
        dtype=jnp.float32 if dtype == torch.float32 else jnp.bfloat16,
        **TINY_SI)
    if "ckpt_path" not in ours_kwargs:
        ours_kwargs["variables"] = from_jax_variables(weights)
    ours = parallel.make_sharded_inference(
        mesh=mesh.build_mesh([CPU] * (dp * sp), axes={"dp": dp, "sp": sp}),
        pixel_path=pixel_path, max_clips=max_clips, dtype=dtype,
        **TINY_SI, **ours_kwargs)
    return theirs, ours


def _videos(si, n, seed):
    rng = np.random.default_rng(seed)
    videos = rng.integers(0, 256, si.batch_shape(n), dtype=np.uint8)
    valid = [int(v) for v in rng.integers(1, si.max_clips + 1, n)]
    return videos, valid


CASES = [(pixel_path, dtype, dp, sp, max_clips)
         for pixel_path, dtype in itertools.product(
             ["rgb", "yuv420"], [torch.bfloat16, torch.float32])
         for dp, sp, max_clips in [(2, 2, 3), (1, 2, 2)]]


@pytest.mark.parametrize("pixel_path,dtype,dp,sp,max_clips", CASES, ids=[
    "%s-%s-dp%d-sp%d-clips%d" % (p, str(d).split(".")[-1], dp, sp, c)
    for p, d, dp, sp, c in CASES])
def test_run_and_predict_match_the_reference(weights, pixel_path, dtype,
                                             dp, sp, max_clips):
    theirs, ours = _pair(weights, dp, sp, max_clips, pixel_path, dtype)
    assert ours.padded_clips == theirs.padded_clips
    assert ours.batch_shape(2 * dp) == theirs.batch_shape(2 * dp)
    assert ours.dtype == dtype and ours.network.dtype == dtype
    videos, valid = _videos(ours, 2 * dp, seed=31 * dp + sp + max_clips)
    vids, mask = ours.place(videos, valid)
    assert vids.device == CPU and vids.dtype == torch.uint8
    assert torch.equal(mask, ours.place_mask(valid))
    got = ours.run(vids, mask).numpy()
    want = np.asarray(theirs.run(*theirs.place(videos, valid)))
    assert got.shape == want.shape == (2 * dp, CLASSES)
    assert got.dtype == np.float32
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    preds = ours.predict(videos, valid)
    assert isinstance(preds, np.ndarray) and preds.shape == (2 * dp,)
    assert np.array_equal(preds, theirs.predict(videos, valid))
    assert np.array_equal(preds, got.argmax(-1))


@pytest.mark.parametrize("pixel_path", ["rgb", "yuv420"])
def test_scribbled_masked_clips_change_nothing_as_in_the_reference(
        weights, pixel_path):
    theirs, ours = _pair(weights, 2, 2, 3, pixel_path, torch.bfloat16)
    videos, _ = _videos(ours, 2, seed=5)
    valid = [1, 2]
    scribbled = videos.copy()
    scribbled[0, 1:] = 255
    scribbled[1, 2:] = 7
    got = ours.run(*ours.place(videos, valid))
    assert torch.equal(got, ours.run(*ours.place(scribbled, valid)))
    want = np.asarray(theirs.run(*theirs.place(scribbled, valid)))
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_the_reference_s_checkpoint_file_serves_both(weights, tmp_path):
    path = str(tmp_path / "tiny.msgpack")
    jax_ckpt.save_checkpoint(path, weights)
    theirs, ours = _pair(weights, 2, 2, 3, "rgb", torch.float32,
                         ckpt_path=path)
    videos, valid = _videos(ours, 2, seed=9)
    want = np.asarray(theirs.run(*theirs.place(videos, valid)))
    got = ours.run(*ours.place(videos, valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    with pytest.raises(FileNotFoundError):
        _pair(weights, 2, 2, 3, "rgb", torch.float32,
              ckpt_path=str(tmp_path / "missing.msgpack"))


def test_a_finished_network_is_taken_as_it_is(weights):
    _, built = _pair(weights, 2, 2, 3, "rgb", torch.bfloat16)
    si = parallel.ShardedInference(
        mesh.build_mesh([CPU] * 4, axes={"dp": 2, "sp": 2}), max_clips=3,
        network=built.network, **TINY_SI)
    assert si.network is built.network and si.dtype == torch.bfloat16
    videos, valid = _videos(si, 2, seed=2)
    assert torch.equal(si.run(*si.place(videos, valid)),
                       built.run(*built.place(videos, valid)))
    with pytest.raises(ValueError, match="carries its weights"):
        parallel.ShardedInference(built.mesh, network=built.network,
                                  variables=from_jax_variables(weights),
                                  **TINY_SI)


def test_make_sharded_inference_needs_cards_or_a_mesh():
    with pytest.raises(ValueError) as ours:
        parallel.make_sharded_inference(num_devices=2)
    with pytest.raises(ValueError) as theirs:
        jax_sharded.make_sharded_inference(num_devices=9)
    pattern = "asked for %d devices but only %d are visible"
    assert str(ours.value) == pattern % (2, 0)
    assert str(theirs.value) == pattern % (9, 8)
    with pytest.raises(ValueError, match="need at least one device"):
        parallel.make_sharded_inference()


# -- distributed ---------------------------------------------------------

def _environment(monkeypatch, env):
    for key in distributed.ENV:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)


def test_single_process_mode_is_the_reference_s(monkeypatch):
    _environment(monkeypatch, {})
    assert distributed.maybe_initialize() is False
    assert jax_distributed.maybe_initialize() is False
    assert distributed.process_count() == jax_distributed.process_count() \
        == 1
    assert distributed.process_index() == jax_distributed.process_index() \
        == 0
    assert distributed.is_primary() is jax_distributed.is_primary() is True


@pytest.mark.parametrize("kwargs", [dict(num_processes=2),
                                    dict(process_id=0),
                                    dict(num_processes=4, process_id=3)])
def test_a_partial_launch_by_arguments_is_refused_as_the_reference(
        kwargs, monkeypatch):
    _environment(monkeypatch, {})
    with pytest.raises(RuntimeError) as theirs:
        jax_distributed.maybe_initialize(**kwargs)
    with pytest.raises(RuntimeError) as ours:
        distributed.maybe_initialize(**kwargs)
    assert str(ours.value) == str(theirs.value)


def test_a_coordinator_launch_by_arguments_is_refused(monkeypatch,
                                                      tmp_path):
    # a launch by arguments joins its group (here its arguments recorded
    # in place of a store and a gloo group; tests/test_torch_processes.py
    # joins real ones), idempotently, and a served run of the shipped mesh
    # config is refused in it: its mesh names 8 members, and a launch of
    # 2 processes has 2 (tests/test_torch_launch.py serves launches)
    from rnb_tpu_torch.benchmark import run_benchmark
    _environment(monkeypatch, {})
    joined = []
    monkeypatch.setattr(distributed, "_launch", None)
    monkeypatch.setattr(distributed, "_join",
                        lambda *args: joined.append(args))
    assert distributed.maybe_initialize("127.0.0.1:2", 2, 0) is True
    assert distributed.maybe_initialize("127.0.0.1:3", 4, 1) is True
    assert joined == [("127.0.0.1", 2, 2, 0)]
    assert (distributed.process_count(), distributed.process_index(),
            distributed.is_primary()) == (2, 0, True)
    with pytest.raises(ConfigError,
                       match=r"pipeline step 1, queue group 0: pipeline "
                             r"configuration names device 2 but a launch of "
                             r"2 processes has 2 members, one a process"):
        run_benchmark(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "configs", "r2p1d-mesh.json"),
            mean_interval_ms=0, num_videos=1,
            log_base=str(tmp_path / "logs"), print_progress=False,
            platform="cpu")
    assert not (tmp_path / "logs").exists()


def test_global_mesh_factors_the_visible_cards(monkeypatch):
    with pytest.raises(ValueError, match="need at least one device"):
        distributed.global_mesh()
    monkeypatch.setattr(distributed, "visible_devices", lambda: [CPU] * 8)
    for kwargs in (dict(), dict(axis_names=("pp", "dp", "sp")),
                   dict(axes={"dp": -1, "sp": 4})):
        ours = distributed.global_mesh(**kwargs)
        theirs = jax_distributed.global_mesh(**kwargs)
        assert ours.shape == dict(theirs.shape)


# -- ring_shift_amount, dma_available, reshard ---------------------------

def _theirs_sharding(ids, axes=("x",), spec=("x",)):
    devices = np.array([jax.devices()[i] for i in ids]).reshape(
        (len(ids),) if len(axes) == 1 else (len(ids) // 2, 2))
    return JaxNamedSharding(JaxMesh(devices, axes), PartitionSpec(*spec))


def _ours_sharding(ids, axes=("x",), spec=("x",)):
    shape = (len(ids),) if len(axes) == 1 else (len(ids) // 2, 2)
    return mesh.NamedSharding(tuple(torch.device("cuda", i) for i in ids),
                              tuple(axes), shape, tuple(spec))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_shift_amount_finds_every_rotation_as_the_reference(n):
    ids = list(range(n))
    for k in range(n):
        rolled = ids[k:] + ids[:k]
        theirs = jax_dma.ring_shift_amount(_theirs_sharding(ids),
                                           _theirs_sharding(rolled))
        ours = handoff_dma.ring_shift_amount(_ours_sharding(ids),
                                             _ours_sharding(rolled))
        assert ours == theirs == (k or None)


NOT_A_SHIFT = {
    "identity": (range(4), range(4), {}, {}),
    "reversed": (range(4), [3, 2, 1, 0], {}, {}),
    "swap": (range(8), [1, 0] + list(range(2, 8)), {}, {}),
    "one member": ([0], [0], {}, {}),
    "sizes differ": (range(4), [1, 2, 3], {}, {}),
    "specs differ": (range(4), [1, 2, 3, 0], {}, dict(spec=(None, "x"))),
    "replicated vs sharded": (range(4), [1, 2, 3, 0], {}, dict(spec=())),
    "axis names differ": (range(4), [1, 2, 3, 0], {}, dict(axes=("y",),
                                                           spec=("y",))),
    "two axes": (range(4), [2, 3, 0, 1], dict(axes=("x", "y")),
                 dict(axes=("x", "y"))),
    "other members": (range(4), [4, 5, 6, 7], {}, {}),
}


@pytest.mark.parametrize("case", sorted(NOT_A_SHIFT))
def test_ring_shift_amount_refuses_what_the_reference_refuses(case):
    src, dst, src_kw, dst_kw = NOT_A_SHIFT[case]
    theirs = jax_dma.ring_shift_amount(_theirs_sharding(list(src), **src_kw),
                                       _theirs_sharding(list(dst), **dst_kw))
    ours = handoff_dma.ring_shift_amount(_ours_sharding(list(src), **src_kw),
                                         _ours_sharding(list(dst), **dst_kw))
    assert ours is theirs is None


def test_ring_shift_amount_needs_two_shardings():
    theirs = _theirs_sharding([0, 1])
    ours = _ours_sharding([0, 1])
    assert handoff_dma.ring_shift_amount(None, ours) is \
        jax_dma.ring_shift_amount(None, theirs) is None
    assert handoff_dma.ring_shift_amount(ours, torch.device("cuda", 1)) \
        is jax_dma.ring_shift_amount(theirs, jax.devices()[1]) is None


def test_dma_is_not_available_on_the_cpu():
    assert handoff_dma.dma_available() is False
    assert handoff_dma.dma_available(torch.zeros(4)) is False
    assert jax_dma.dma_available() is False


def test_reshard_adopts_resident_tensors_by_reference():
    t = torch.arange(6.0)
    assert handoff_dma.reshard(t, CPU) is t
    assert handoff_dma.reshard(t, "cpu") is t
    one = mesh.build_mesh([CPU] * 4, axes={"dp": 4})
    sharding = mesh.NamedSharding.of(one, ("dp",))
    assert sharding.device == CPU and sharding.shape == (4,)
    assert handoff_dma.reshard(t, sharding) is t
    assert handoff_dma.reshard(t, sharding, source=sharding) is t


def test_reshard_onto_distinct_cards_is_not_yet_ported(monkeypatch):
    t = torch.arange(6.0)
    src, dst = _ours_sharding([0, 1, 2, 3]), _ours_sharding([1, 2, 3, 0])
    with pytest.raises(NotImplementedError, match="a sharding over 4 "
                                                  "distinct devices"):
        handoff_dma.reshard(t, dst, source=src)
    # where the ring kernel is built and the tensor on a card, the
    # reference's ring route is the one taken, and it raises too
    monkeypatch.setattr(handoff_dma, "dma_available", lambda *t: True)
    with pytest.raises(NotImplementedError, match="ring route of reshard "
                                                  "across 4 distinct"):
        handoff_dma.reshard(t, dst, source=src)

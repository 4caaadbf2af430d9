"""The port's analytic FLOP walk (``rnb_tpu_torch.models.r2p1d.flops``) and
its config walks (``rnb_tpu_torch.devobs``) held to the JAX package's.

``range_flops_per_clip`` equals ``rnb_tpu``'s exactly over every layer
range 1..5, the factored and plain shortcut, two frame counts and two
block schedules; ``flops_per_clip_for_config`` and ``devices_used`` equal
the reference's over every shipped config; ``peak_tflops_for`` keeps the
reference's exact-match rule over its own (CUDA) table; and a stage's
``compute_profile()`` declares the walk's count for its own network.
"""

import glob
import json
import os

import pytest

from rnb_tpu import devobs as jax_devobs
from rnb_tpu.models.r2p1d import flops as jax_flops
from rnb_tpu_torch import devobs
from rnb_tpu_torch.models.r2p1d import flops
from rnb_tpu_torch.models.r2p1d.model import R2P1DRunner, R2P1DSingleStep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANGES = [(start, end) for start in range(1, 6) for end in range(start, 6)]
CONFIGS = sorted(os.path.basename(p) for p in
                 glob.glob(os.path.join(REPO, "configs", "*.json")))


@pytest.mark.parametrize("frames", [8, 16])
@pytest.mark.parametrize("factored_shortcut", [False, True])
@pytest.mark.parametrize("start,end", RANGES)
def test_range_flops_equal_the_reference(start, end, factored_shortcut,
                                         frames):
    kwargs = dict(consecutive_frames=frames,
                  factored_shortcut=factored_shortcut)
    got = flops.range_flops_per_clip(start, end, **kwargs)
    assert isinstance(got, int) and got > 0
    assert got == jax_flops.range_flops_per_clip(start, end, **kwargs)


@pytest.mark.parametrize("layer_sizes,classes,frame_hw", [
    ((1, 1, 1, 1), 10, None), ((2, 1, 2, 1), 400, 96),
    ((3, 4, 6, 3), 400, 112)])
def test_other_schedules_equal_the_reference(layer_sizes, classes,
                                             frame_hw):
    for start, end in RANGES:
        kwargs = dict(layer_sizes=layer_sizes, num_classes=classes,
                      frame_hw=frame_hw)
        assert flops.range_flops_per_clip(start, end, **kwargs) \
            == jax_flops.range_flops_per_clip(start, end, **kwargs)


def test_the_full_network_costs_42_gflop_a_clip():
    assert flops.range_flops_per_clip() == 42_142_880_768


@pytest.mark.parametrize("start,end", [(0, 5), (3, 2), (1, 6)])
def test_an_invalid_range_is_refused_as_the_reference(start, end):
    with pytest.raises(ValueError) as ours:
        flops.range_flops_per_clip(start, end)
    with pytest.raises(ValueError) as theirs:
        jax_flops.range_flops_per_clip(start, end)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.4),
    ("  NVIDIA H100 80GB HBM3\n", 989.4),
    ("NVIDIA H100 PCIe", None),
    ("NVIDIA H100", None),
    ("NVIDIA H100 80GB HBM3 MIG 1g.10gb", None),
    ("TPU v4", None),
    ("cpu", None)])
def test_peak_is_an_exact_match(name, peak):
    assert flops.peak_tflops_for(name) == peak


@pytest.mark.parametrize("config", CONFIGS)
def test_config_walks_equal_the_reference(config):
    with open(os.path.join(REPO, "configs", config)) as f:
        raw = json.load(f)
    assert devobs.flops_per_clip_for_config(raw) \
        == jax_devobs.flops_per_clip_for_config(raw)
    assert devobs.devices_used(raw) == jax_devobs.devices_used(raw)
    assert [(step, views) for step, views in
            devobs.config_stage_views(raw)] == [
        (step, views) for step, views in
        jax_devobs.config_stage_views(raw)]


def test_the_devobs_cell_costs_the_full_network_a_clip():
    with open(os.path.join(REPO, "configs",
                           "rnb-fused-yuv-devobs.json")) as f:
        raw = json.load(f)
    assert devobs.flops_per_clip_for_config(raw) \
        == float(flops.range_flops_per_clip())
    assert devobs.devices_used(raw) == 1


@pytest.mark.parametrize("start,end,factored_shortcut", [
    (1, 5, False), (1, 5, True), (1, 3, False), (4, 5, True)])
def test_a_runner_declares_the_walk_of_its_network(start, end,
                                                   factored_shortcut):
    runner = R2P1DRunner("cpu", start_index=start, end_index=end,
                         num_classes=10, layer_sizes=(1, 1, 1, 1),
                         max_rows=2, row_buckets=[2], num_warmups=0,
                         factored_shortcut=factored_shortcut)
    profile = runner.compute_profile()
    assert profile["flops_per_row"] == jax_flops.range_flops_per_clip(
        start, end, num_classes=10, layer_sizes=(1, 1, 1, 1),
        factored_shortcut=factored_shortcut)
    tensors = list(runner.network.parameters()) + list(
        runner.network.buffers())
    assert profile["params_bytes"] == sum(
        t.numel() * t.element_size() for t in tensors) > 0
    assert profile["params_key"] == ("params", id(runner.network))
    # PyTorch has no cost model: no bytes per row, so no intensity
    assert profile["bytes_per_row"] is None
    assert profile["pool_bytes"] == 0 and profile["devices"] == 1


def test_a_ragged_runner_declares_its_pool_and_the_single_step_its_net():
    runner = R2P1DRunner("cpu", num_classes=10, layer_sizes=(1, 1, 1, 1),
                         max_rows=4, num_warmups=0, pixel_path="yuv420",
                         ragged=True, ragged_pool_rows=4)
    # four packed 4:2:0 rows of 8 frames of 112 x 112
    assert runner.compute_profile()["pool_bytes"] == 4 * 8 * 112 * 168
    single = R2P1DSingleStep("cpu", num_classes=10,
                             layer_sizes=(1, 1, 1, 1), max_clips=2,
                             row_buckets=[2], num_warmups=0)
    assert single.compute_profile() == single.net.compute_profile()
    assert single.compute_profile()["flops_per_row"] \
        == flops.range_flops_per_clip(num_classes=10,
                                      layer_sizes=(1, 1, 1, 1))

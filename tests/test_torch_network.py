"""The port's R(2+1)D network against the flax network, on the CPU.

Both packages run the same parameter arrays: a flax variable tree is
filled from a seed with numpy, kernels and BatchNorm alike (init's
identity BN would let a BN wiring bug pass), and carried into the port
with ``from_jax_variables``. Inputs are made from a seed with
numpy. The float32 bound is the one tests/test_network_oracle.py holds
the flax network to against its numpy oracle: rtol = atol = 5e-4
(accumulation order over up to ~20 layers).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnb_tpu.models.r2p1d import checkpoint as jax_ckpt
from rnb_tpu.models.r2p1d import network as jax_net
from rnb_tpu_torch.models.r2p1d.checkpoint import (filter_layer_range,
                                                   from_jax_variables,
                                                   init_variables)
from rnb_tpu_torch.models.r2p1d.network import (LAYER_INPUT_SHAPES,
                                                NUM_LAYERS,
                                                R2Plus1DClassifier,
                                                cast_compute_weights,
                                                factored_channels,
                                                range_output_shape)

torch.set_num_threads(2)

RANGES = [(s, e) for s in range(1, NUM_LAYERS + 1)
          for e in range(s, NUM_LAYERS + 1)]
CLASSES = 10


def _randomize(tree, rng):
    """Fill a variable tree of shapes from ``rng``: kernels with variance
    1/fan_in, BatchNorm statistics and every affine term random (init's
    identity BN would let a BN wiring bug pass)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _randomize(v, rng)
        elif k == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            out[k] = rng.normal(0.0, fan_in ** -0.5, v.shape)
        elif k == "mean":
            out[k] = rng.normal(0.0, 0.3, v.shape)
        elif k in ("var", "scale"):
            out[k] = rng.uniform(0.5, 1.5, v.shape)
        elif k == "bias":
            out[k] = rng.normal(0.0, 0.3, v.shape)
        else:
            raise KeyError("unexpected flax leaf %r" % k)
        if not hasattr(v, "items"):
            out[k] = out[k].astype(np.float32)
    return out


def _input(start, rows, seed):
    t, h, w, c = LAYER_INPUT_SHAPES[start]
    hw = 16 if start == 1 else 8
    t = min(t, 4)  # T still halves through layers 3..5
    rng = np.random.default_rng(seed)
    return rng.normal(size=(rows, t, hw, hw, c)).astype(np.float32)


def _pair(start, end, factored, seed, layer_sizes=(1, 1, 1, 1)):
    """(flax module, randomized numpy variables, port module), float32.
    The flax tree's shapes come from ``eval_shape`` (no init compile);
    its values from numpy."""
    module = jax_net.R2Plus1DClassifier(
        start=start, end=end, num_classes=CLASSES, layer_sizes=layer_sizes,
        factored_shortcut=factored, dtype=jnp.float32)
    shapes = jax.eval_shape(functools.partial(module.init, train=False),
                            jax.random.PRNGKey(0), _input(start, 1, seed))
    variables = {k: _randomize(dict(v), np.random.default_rng(seed + 1))
                 for k, v in shapes.items()}
    port = R2Plus1DClassifier(start, end, CLASSES, layer_sizes, factored,
                              dtype=torch.float32)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return module, variables, port.eval()


def _assert_port_matches_flax(module, variables, port, x):
    want = np.asarray(jax.jit(functools.partial(module.apply, train=False))(
        variables, x))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)
    return got


@pytest.mark.parametrize("start,end", RANGES)
def test_every_range_matches_flax_float32(start, end):
    seed = 10 * start + end
    module, variables, port = _pair(start, end, True, seed)
    got = _assert_port_matches_flax(module, variables, port,
                                    _input(start, 2, seed + 7))
    if end == NUM_LAYERS:
        assert got.shape == (2, CLASSES)


@pytest.mark.parametrize("start,end,factored", [(1, 5, False), (3, 4, False),
                                                 (1, 5, True)])
def test_r18_depth_matches_flax_float32(start, end, factored):
    # R(2+1)D-18's two blocks per layer, both shortcut forms; the sweep
    # above runs one block per layer to stay fast
    module, variables, port = _pair(start, end, factored, 3,
                                    layer_sizes=(2, 2, 2, 2))
    _assert_port_matches_flax(module, variables, port, _input(start, 2, 4))


def test_cast_compute_weights_keeps_outputs():
    port = R2Plus1DClassifier(1, 2, CLASSES, (1, 1, 1, 1),
                              dtype=torch.bfloat16)
    port.load_state_dict(init_variables(0, 1, 2, CLASSES, (1, 1, 1, 1)))
    x = torch.from_numpy(_input(1, 1, 0)).to(torch.bfloat16)
    with torch.inference_mode():
        before = port(x)
        after = cast_compute_weights(port)(x)
    assert torch.equal(before, after)
    assert port.net.conv1.spatial.weight.dtype == torch.bfloat16
    assert port.net.stem_bn.weight.dtype == torch.float32


def test_factored_channels_and_shapes_match_jax():
    assert factored_channels(3, 64, 3, 7) == 83
    for args in [(3, 64, 3, 7), (64, 128, 3, 3), (256, 512, 1, 1)]:
        assert factored_channels(*args) == jax_net.factored_channels(*args)
    for start, end in RANGES:
        for frames in (8, 5):
            assert range_output_shape(start, end, frames, 7) == \
                jax_net.range_output_shape(start, end, frames, 7)
    with pytest.raises(ValueError):
        range_output_shape(3, 2)


def test_from_jax_variables_layouts():
    _module, variables, port = _pair(4, 5, True, 1)
    state = from_jax_variables(variables)
    kernel = variables["params"]["net"]["conv4"]["block0"]["conv1"][
        "spatial"]["kernel"]
    ours = state["net.conv4.block0.conv1.spatial.weight"].numpy()
    np.testing.assert_array_equal(ours, kernel.transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(state["linear.weight"].numpy(),
                                  variables["params"]["linear"]["kernel"].T)
    mean = variables["batch_stats"]["net"]["conv4"]["block0"]["bn1"]["mean"]
    np.testing.assert_array_equal(
        state["net.conv4.block0.bn1.running_mean"].numpy(), mean)
    assert set(state) == set(port.state_dict())


@pytest.mark.parametrize("start,end", [(1, 1), (1, 5), (2, 4), (5, 5)])
def test_filter_layer_range_matches_jax(start, end):
    _module, full, _port = _pair(1, NUM_LAYERS, False, 0)
    ours = filter_layer_range(from_jax_variables(full), start, end)
    ref = from_jax_variables(jax_ckpt.filter_layer_range(full, start, end))
    assert set(ours) == set(ref)
    port = R2Plus1DClassifier(start, end, CLASSES, (1, 1, 1, 1))
    assert set(ours) == set(port.state_dict())


def test_seeded_init_is_deterministic_and_shared_across_splits():
    a = init_variables(3, 1, 5, CLASSES, (1, 1, 1, 1))
    b = init_variables(3, 1, 5, CLASSES, (1, 1, 1, 1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(init_variables(4, 1, 5, CLASSES, (1, 1, 1, 1))[
        "net.conv1.spatial.weight"], a["net.conv1.spatial.weight"])
    split = init_variables(3, 3, 5, CLASSES, (1, 1, 1, 1))
    assert all(torch.equal(split[k], a[k]) for k in split)
    assert not a["linear.bias"].any()
    w = a["net.conv2.block0.conv1.temporal.weight"]
    fan_in = w[0].numel()
    assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.1

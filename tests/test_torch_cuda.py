"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card (marker ``cuda``) and skip without one.
The file imports no jax, so it also runs on a machine that has PyTorch
for CUDA and no JAX; there, skip the repo's jax-configuring conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rnb_tpu_torch.ops import _kernels
from rnb_tpu_torch.ops.preprocess import normalize_u8, normalize_u8_rows
from rnb_tpu_torch.ops.yuv import packed_frame_bytes, yuv420_to_rgb_u8

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _packed(rows, seed, h=112, w=112):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (rows, 8, packed_frame_bytes(h, w)), dtype=np.uint8))


def test_kernels_match_plain_versions_on_card(device):
    # tolerance: the colourspace kernel within one u8 step of its plain
    # version (the reference's own bound; exact in practice), pad rows
    # exactly the conversion of zero bytes; the normalize bitwise
    for rows in (15, 4):
        packed = _packed(rows, seed=rows)
        for valid in (rows, 2, 0):
            rgb = yuv420_to_rgb_u8(packed.to(device), 112, 112, valid)
            plain = yuv420_to_rgb_u8(packed, 112, 112, valid)
            assert (rgb.cpu().int() - plain.int()).abs().max() <= 1
            assert torch.equal(rgb.cpu()[valid:], plain[valid:])
            out = normalize_u8_rows(rgb, valid)
            assert torch.equal(out.cpu().view(torch.int16),
                               normalize_u8_rows(rgb.cpu(), valid)
                               .view(torch.int16))


def test_wrappers_count_launches_and_refuse_what_kernels_cannot_take(
        device):
    _kernels.reset_launches()
    packed = _packed(2, seed=0, h=16, w=16).to(device)
    rgb = yuv420_to_rgb_u8(packed, 16, 16)
    normalize_u8(rgb)
    torch.cuda.synchronize(device)
    assert _kernels.launch_counts() == {"normalize_u8": 1,
                                        "yuv420_to_rgb_u8": 1}
    with pytest.raises(TypeError):
        normalize_u8(rgb.float())                     # not uint8
    with pytest.raises(ValueError):
        normalize_u8(rgb.transpose(2, 3))             # not contiguous
    with pytest.raises(ValueError):
        normalize_u8(rgb.view(-1)[1:33].view(2, 16))  # not 16-byte aligned
    with pytest.raises(ValueError):
        yuv420_to_rgb_u8(packed[:, :, :-2], 16, 16)   # wrong plane size
    assert _kernels.launch_counts() == {"normalize_u8": 1,
                                        "yuv420_to_rgb_u8": 1}

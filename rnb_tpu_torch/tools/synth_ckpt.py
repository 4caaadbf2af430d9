"""A synthetic pretrained checkpoint in the reference's torch format, and
the config copies that serve it.

No trained R(2+1)D-18 file is in the repository. To drive the serving
path of a converted checkpoint (``models/r2p1d/convert.py``, the
``ckpt_path`` key) at full width, :func:`reference_state_dict` draws a
state dict with the reference's exact keys, shapes and
``num_batches_tracked`` leaves from a ``torch.Generator``: conv and head
kernels N(0, 1/fan_in), BatchNorm scales near 1, small biases and
means, running variances in [0.5, 1.5], so the activations stay finite.

Those values leave a common part in every video's pooled features far
larger than their spread between videos, so a random head would serve
one class id for every request. :func:`centre_head` sets the head's bias
so that its logits are centred on a dataset, as a trained head's are.

Run on the card, beside a y4m dataset (``rnb_tpu_torch.dataset``)::

    python3 -m rnb_tpu_torch.tools.synth_ckpt OUT_DIR --data DATA

writes ``OUT_DIR/model_data.pth.tar`` (``{"state_dict", "epoch"}``),
converts it with ``convert_file`` into ``OUT_DIR/r2p1d18.pt``, and
writes :data:`COPIES` beside it (never into ``configs/``): every
``R2P1DRunner`` step serving the file with the factored shortcut, every
device index made 0. It prints one JSON line of what it made and how
long each part took.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict, Tuple

import torch

from rnb_tpu_torch.models.r2p1d.network import (KINETICS_CLASSES,
                                                LAYER_FEATURES,
                                                R18_LAYER_SIZES,
                                                factored_channels)

SEED = 20
#: the copies' names and the shipped configs they are made from
COPIES = {"rnb-fused-yuv-big-torchckpt-file":
          "configs/rnb-fused-yuv-big-torchckpt.json",
          "r2p1d-split-1chip-file": "configs/r2p1d-split-1chip.json"}
#: the file names under OUT_DIR
PTH_NAME = "model_data.pth.tar"
CONVERTED_NAME = "r2p1d18.pt"
#: the centring clips: the first 8 frames of each video, at 112 x 112
FRAMES = 8
HW = 112


def reference_state_dict(seed: int = SEED) -> Dict[str, torch.Tensor]:
    """A full-width R(2+1)D-18 state dict (400 classes, two blocks a
    layer) in the reference's torch format, drawn from ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    sd: Dict[str, torch.Tensor] = {}

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    def conv(key, shape):
        sd[key] = normal(shape, math.prod(shape[1:]) ** -0.5)

    def bn(prefix, c):
        sd[prefix + ".weight"] = 1.0 + normal((c,), 0.1)
        sd[prefix + ".bias"] = normal((c,), 0.1)
        sd[prefix + ".running_mean"] = normal((c,), 0.1)
        sd[prefix + ".running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[prefix + ".num_batches_tracked"] = torch.tensor(1000)

    def st_conv(prefix, cin, cout, t, d):
        mid = factored_channels(cin, cout, t, d)
        conv(prefix + "spatial_conv.weight", (mid, cin, 1, d, d))
        bn(prefix + "bn", mid)
        conv(prefix + "temporal_conv.weight", (cout, mid, t, 1, 1))

    st_conv("res2plus1d.conv1.", 3, 64, 3, 7)
    channels = 64
    for layer in range(2, 6):
        cout = LAYER_FEATURES[layer]
        for block in range(R18_LAYER_SIZES[layer - 2]):
            prefix = ("res2plus1d.conv%d.block1." % layer if block == 0
                      else "res2plus1d.conv%d.blocks.%d." % (layer,
                                                             block - 1))
            st_conv(prefix + "conv1.", channels if block == 0 else cout,
                    cout, 3, 3)
            bn(prefix + "bn1", cout)
            st_conv(prefix + "conv2.", cout, cout, 3, 3)
            bn(prefix + "bn2", cout)
            if block == 0 and layer >= 3:
                st_conv(prefix + "downsampleconv.", channels, cout, 1, 1)
                bn(prefix + "downsamplebn", cout)
        channels = cout
    conv("linear.weight", (KINETICS_CLASSES, channels))
    sd["linear.bias"] = normal((KINETICS_CLASSES,), 0.01)
    return sd


def centre_head(sd: Dict[str, torch.Tensor], data_root: str,
                device) -> Tuple[int, float, float]:
    """Set ``sd["linear.bias"]`` to minus the head's logits of the mean
    float32 pooled features of one clip of every video under
    ``data_root``. Returns the clips' count, the norm of their mean
    features and the norm of the features' standard deviation over the
    clips."""
    from rnb_tpu_torch.decode import get_decoder
    from rnb_tpu_torch.models.r2p1d.convert import convert_state_dict
    from rnb_tpu_torch.models.r2p1d.network import R2Plus1DClassifier
    from rnb_tpu_torch.ops.yuv import normalize_yuv420
    from rnb_tpu_torch.video_path_provider import scan_video_tree
    net = R2Plus1DClassifier(factored_shortcut=True, dtype=torch.float32)
    net.load_state_dict(convert_state_dict(sd))
    net = net.to(device).eval()
    videos = scan_video_tree(data_root)
    clips = torch.cat([torch.from_numpy(get_decoder(v).decode_clips_yuv(
        v, [0], FRAMES, HW, HW)) for v in videos])
    with torch.inference_mode():
        # the plain ingest on the host: no kernel launch is counted here
        features = net.net(normalize_yuv420(clips, HW, HW).to(device))
        features = features.double().cpu()
    mean = features.mean(dim=0)
    sd["linear.bias"] = -(sd["linear.weight"].double() @ mean).float()
    return (len(videos), float(mean.norm()),
            float(features.std(dim=0).norm()))


def ckpt_copy(config: str, out_path: str, ckpt_path: str) -> str:
    """Write a copy of ``config`` whose ``R2P1DRunner`` steps serve
    ``ckpt_path`` with the factored shortcut (the converted file's block
    structure), every device index >= 0 made 0. Returns ``out_path``."""
    with open(config) as f:
        raw = json.load(f)
    for step in raw["pipeline"]:
        for group in step["queue_groups"]:
            group["devices"] = [0 if d >= 0 else d
                                for d in group["devices"]]
        if step["model"].endswith(".R2P1DRunner"):
            step["ckpt_path"] = ckpt_path
            step["factored_shortcut"] = True
    with open(out_path, "w") as f:
        json.dump(raw, f)
    return out_path


def make(out_dir: str, data_root: str, device, seed: int = SEED,
         repo: str = ".") -> dict:
    """Draw, centre, save and convert the checkpoint under ``out_dir``
    and write :data:`COPIES` beside it. Returns what was made, with the
    seconds each part took."""
    from rnb_tpu_torch.models.r2p1d.convert import convert_file
    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    sd = reference_state_dict(seed)
    drawn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    clips, common, spread = centre_head(sd, data_root, device)
    centre_s = time.perf_counter() - t0
    pth = os.path.join(out_dir, PTH_NAME)
    t0 = time.perf_counter()
    torch.save({"state_dict": sd, "epoch": 0}, pth)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    converted = convert_file(pth, os.path.join(out_dir, CONVERTED_NAME))
    convert_s = time.perf_counter() - t0
    copies = {name: ckpt_copy(os.path.join(repo, config),
                              os.path.join(out_dir, name + ".json"),
                              converted)
              for name, config in COPIES.items()}
    return {"pth": pth, "converted": converted, "copies": copies,
            "keys": len(sd),
            "values": sum(v.numel() for v in sd.values()
                          if v.is_floating_point()),
            "pth_bytes": os.path.getsize(pth),
            "converted_bytes": os.path.getsize(converted),
            "centring_clips": clips, "mean_features_norm": common,
            "features_spread_norm": spread, "draw_s": drawn_s,
            "centre_s": centre_s, "save_s": save_s, "convert_s": convert_s}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("out_dir")
    parser.add_argument("--data", required=True,
                        help="a y4m dataset root to centre the head on")
    parser.add_argument("--seed", type=int, default=SEED)
    parser.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    args = parser.parse_args(argv)
    if args.platform == "gpu" and not torch.cuda.is_available():
        print("synth_ckpt: no CUDA device (use --platform cpu)",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0) if args.platform == "gpu" \
        else torch.device("cpu")
    print(json.dumps(make(args.out_dir, args.data, device, args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

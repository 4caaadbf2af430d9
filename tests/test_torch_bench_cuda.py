"""``bench_cuda.py``, the port's headline entry point, on the CPU.

Without a card (and without ``RNB_BENCH_PLATFORM=cpu``) it prints the
structured error line and exits 1: it never falls back to the CPU. With
``RNB_BENCH_PLATFORM=cpu`` it serves a reduced copy of a config over a
y4m dataset from ``rnb_tpu_torch.dataset`` and prints ``bench.py``'s one
line, its keys all there, ``gflops_per_clip`` the config walk's and no
``vs_baseline`` or ``mfu`` (the CPU is not the baseline's hardware). The
analytic FLOPs of the flagship config equal the JAX package's
(``bench.py``'s ``gflops_per_clip``).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from rnb_tpu.devobs import flops_per_clip_for_config as jax_flops_per_clip
from rnb_tpu_torch.dataset import make_dataset
from rnb_tpu_torch.devobs import flops_per_clip_for_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench_cuda.py")
#: the keys of bench.py's line (bench.py:37-44, measure)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "platform",
              "device_kind", "num_devices", "devices_used", "num_videos",
              "mean_interval_ms", "config", "decode_backend", "dataset",
              "measured_window_s", "p50_ms", "p99_ms", "latency_semantics",
              "host_cpu_frac", "clips_per_sec", "gflops_per_clip", "tflops",
              "peak_tflops_per_device", "mfu"}


def _run(env_extra, tmp):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RNB_")}
    env.update(env_extra, RNB_BENCH_LOG_BASE=os.path.join(tmp, "logs"))
    proc = subprocess.run([sys.executable, BENCH], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, (proc.stdout, proc.stderr[-3000:])
    return proc.returncode, json.loads(lines[0])


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a CUDA card")
def test_without_a_card_it_prints_the_error_line(tmp_path):
    code, line = _run({}, str(tmp_path))
    assert code == 1
    assert line["value"] is None and line["vs_baseline"] is None
    assert line["metric"] == "videos_per_sec"
    assert "no CUDA device" in line["error"]


def test_a_bad_platform_is_an_error_line(tmp_path):
    code, line = _run({"RNB_BENCH_PLATFORM": "tpu"}, str(tmp_path))
    assert code == 1 and line["value"] is None
    assert "RNB_BENCH_PLATFORM" in line["error"]


def _reduced_config(tmp):
    """The scale-out r1 pipeline without its planes: the rgb fusing
    loader and a narrow runner (2-frame clips, 8 classes)."""
    with open(os.path.join(REPO, "configs/rnb-scaleout-r1.json")) as f:
        raw = json.load(f)
    for key in ("handoff", "placement", "fault_plan", "trace"):
        raw.pop(key)
    raw["pipeline"][1]["queue_groups"][0]["devices"] = [0]
    path = os.path.join(tmp, "reduced.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path, raw


def test_on_the_cpu_it_prints_bench_py_s_line(tmp_path):
    tmp = str(tmp_path)
    config, raw = _reduced_config(tmp)
    root = make_dataset(os.path.join(tmp, "data"), videos=4, frames=16)
    code, line = _run({"RNB_BENCH_PLATFORM": "cpu",
                       "RNB_BENCH_VIDEOS": "6",
                       "RNB_BENCH_CONFIG": config,
                       "RNB_TPU_DATA_ROOT": root}, tmp)
    assert code == 0, line
    assert BENCH_KEYS <= set(line)
    assert line["metric"] == "videos_per_sec" and line["unit"] == "videos/s"
    assert line["value"] > 0 and line["num_videos"] == 6
    assert line["platform"] == "cpu" and line["device_kind"] == "cpu"
    assert line["vs_baseline"] is None and line["mfu"] is None
    assert "vs_baseline omitted" in line["note"]
    assert line["decode_backend"].endswith("-y4m")
    assert line["gflops_per_clip"] == round(
        flops_per_clip_for_config(raw) / 1e9, 3)
    assert line["kernel_launches"]["ragged_normalize_u8"] == 0


def test_the_flagship_flops_are_bench_py_s():
    with open(os.path.join(REPO, "configs/rnb-fused-yuv-big.json")) as f:
        raw = json.load(f)
    assert flops_per_clip_for_config(raw) == jax_flops_per_clip(raw)


def test_the_mjpeg_mode_serves_compressed_files_on_the_native_pool(
        tmp_path):
    tmp = str(tmp_path)
    config, _ = _reduced_config(tmp)
    root = make_dataset(os.path.join(tmp, "data"), videos=4, frames=16,
                        fmt="mjpeg")
    code, line = _run({"RNB_BENCH_PLATFORM": "cpu",
                       "RNB_BENCH_DATASET": "mjpeg",
                       "RNB_BENCH_VIDEOS": "6",
                       "RNB_BENCH_CONFIG": config,
                       "RNB_TPU_DATA_ROOT": root}, tmp)
    assert code == 0, line
    assert BENCH_KEYS <= set(line)
    assert line["decode_backend"] == "native-mjpeg"
    assert line["value"] > 0 and line["num_videos"] == 6
    assert line["dataset"] == os.path.relpath(root, REPO)


def test_a_root_holding_both_formats_is_refused(tmp_path):
    tmp = str(tmp_path)
    config, _ = _reduced_config(tmp)
    root = make_dataset(os.path.join(tmp, "data"), videos=2, frames=16,
                        fmt="mjpeg")
    make_dataset(root, videos=1, frames=16)  # a y4m video beside them
    for mode in ("mjpeg", "y4m"):
        code, line = _run({"RNB_BENCH_PLATFORM": "cpu",
                           "RNB_BENCH_DATASET": mode,
                           "RNB_BENCH_CONFIG": config,
                           "RNB_TPU_DATA_ROOT": root}, tmp)
        assert code == 1 and line["value"] is None
        assert "of another format beside the %s dataset" % mode \
            in line["error"]
    code, line = _run({"RNB_BENCH_PLATFORM": "cpu",
                       "RNB_BENCH_DATASET": "avi"}, tmp)
    assert code == 1 and "must be y4m, mjpeg or synth" in line["error"]


@pytest.mark.parametrize("mode,backends,name", [
    ("mjpeg", "native", "native-mjpeg"), ("mjpeg", "mjpeg", "pil-mjpeg"),
    ("y4m", "native", "native-y4m"), ("y4m", "y4m", "y4m-y4m"),
    ("synth", "synth", "synthetic")])
def test_decode_backend_names_what_decoded(mode, backends, name, tmp_path):
    sys.path.insert(0, REPO)
    import bench_cuda
    with open(tmp_path / "log-meta.txt", "w") as f:
        f.write("Pixel path: yuv420\nDecode backend: %s\n" % backends)
    assert bench_cuda._decode_backend(str(tmp_path), mode) == name

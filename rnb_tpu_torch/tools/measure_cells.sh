#!/usr/bin/env bash
# Measure the port's serving cells on one card, in turns, in one call:
# the dct cell (configs/rnb-fused-dct-ragged.json over synth:// ids) and
# the ragged yuv420 cell (configs/rnb-fused-yuv-ragged.json over a
# generated y4m dataset) — bulk, bulk with --profile, Poisson at a 20 ms
# mean interval, and bulk again — then one summary line per run from
# rnb_tpu_torch/parse_utils.py. Run from the root of a checkout:
#
#     bash rnb_tpu_torch/tools/measure_cells.sh [out_dir]
#
# The card's name and power limit are printed before and after.
out=${1:-logs/measure}
mkdir -p $out
data=$(mktemp -d)
trap 'rm -rf "$data"' EXIT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -m rnb_tpu_torch.dataset "$data" --videos 64
run() {  # run <config> <args...>
  cfg=$1; shift
  if [ "$cfg" = dct ]; then
    env -u RNB_TPU_DATA_ROOT python3 -m rnb_tpu_torch.benchmark -c configs/rnb-fused-dct-ragged.json --seed 0 --log-base $out "$@" 2>&1 | grep -E "^(Result|Logs|Throughput)"
  else
    RNB_TPU_DATA_ROOT="$data" python3 -m rnb_tpu_torch.benchmark -c configs/rnb-fused-yuv-ragged.json --seed 0 --log-base $out "$@" 2>&1 | grep -E "^(Result|Logs|Throughput)"
  fi
}
for c in dct yuv; do echo "== $c bulk"; run $c -mi 0 -v 2000; done
for c in dct yuv; do echo "== $c bulk profile"; run $c -mi 0 -v 2000 --profile; done
for c in dct yuv; do echo "== $c poisson 20"; run $c -mi 20 -v 1000; done
for c in yuv dct; do echo "== $c bulk (2nd)"; run $c -mi 0 -v 2000; done
python3 -m rnb_tpu_torch.parse_utils $out/*/ > $out/summary.jsonl
cat $out/summary.jsonl | python3 -c "
import sys, json
for line in sys.stdin:
    d = json.loads(line); fam = d.get('kernel_families') or {}
    print(d['log_dir'].split('/')[-2], d['config'].split('/')[-1], d['mean_interval_ms'], d['pixel_path'], d['decode_backend'], 'vps=%.3f' % d['videos_per_s'], 'em=%d' % d['emissions'], 'svc=%.2f' % d['runner_service_ms'], 'wait=%.2f' % d['runner_wait_ms'], 'kms/em=%s' % d.get('kernel_ms_per_emission'), 'busy=%s' % d.get('busy_share'), 'ingest=%s' % fam.get('ingest'))
"
grep -h "Staging\|Profile" $out/*/log-meta.txt
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

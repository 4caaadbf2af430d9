#!/usr/bin/env bash
# Measure the port's serving cells on one card, in turns, in one call.
# Cells: dct (configs/rnb-fused-dct-ragged.json over synth:// ids), yuv
# (configs/rnb-fused-yuv-ragged.json), paged (configs/rnb-fused-yuv-
# paged-zipf.json) and blob (its blob-cache twin, configs/rnb-fused-yuv-
# zipf-cache.json), the last three over a generated y4m dataset. Each
# phase runs every chosen cell before the next phase starts: bulk, bulk
# with --profile, Poisson at a 20 ms mean interval, and bulk again; then
# one summary line per run from rnb_tpu_torch/parse_utils.py. Run from
# the root of a checkout:
#
#     bash rnb_tpu_torch/tools/measure_cells.sh [out_dir] [cell ...]
#
# (all four cells when none is named). The card's name and power limit
# are printed before and after.
out=${1:-logs/measure}
shift
cells=${*:-dct yuv paged blob}
mkdir -p $out
data=$(mktemp -d)
trap 'rm -rf "$data"' EXIT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -m rnb_tpu_torch.dataset "$data" --videos 64
run() {  # run <cell> <args...>
  cell=$1; shift
  case $cell in
    dct) cfg=configs/rnb-fused-dct-ragged.json ;;
    yuv) cfg=configs/rnb-fused-yuv-ragged.json ;;
    paged) cfg=configs/rnb-fused-yuv-paged-zipf.json ;;
    blob) cfg=configs/rnb-fused-yuv-zipf-cache.json ;;
  esac
  if [ "$cell" = dct ]; then
    env -u RNB_TPU_DATA_ROOT python3 -m rnb_tpu_torch.benchmark -c $cfg --seed 0 --log-base $out "$@" 2>&1 | grep -E "^(Result|Logs|Throughput|Cache|Pages)"
  else
    RNB_TPU_DATA_ROOT="$data" python3 -m rnb_tpu_torch.benchmark -c $cfg --seed 0 --log-base $out "$@" 2>&1 | grep -E "^(Result|Logs|Throughput|Cache|Pages)"
  fi
}
for c in $cells; do echo "== $c bulk"; run $c -mi 0 -v 2000; done
for c in $cells; do echo "== $c bulk profile"; run $c -mi 0 -v 2000 --profile; done
for c in $cells; do echo "== $c poisson 20"; run $c -mi 20 -v 1000; done
for c in $(echo $cells | tr ' ' '\n' | tac); do echo "== $c bulk (2nd)"; run $c -mi 0 -v 2000; done
python3 -m rnb_tpu_torch.parse_utils $out/*/ > $out/summary.jsonl
cat $out/summary.jsonl | python3 -c "
import sys, json
for line in sys.stdin:
    d = json.loads(line); fam = d.get('kernel_families') or {}
    print(d['log_dir'].split('/')[-2], d['config'].split('/')[-1], d['mean_interval_ms'], d['pixel_path'], d['decode_backend'], 'vps=%.3f' % d['videos_per_s'], 'cps=%.1f' % d['clips_per_s'], 'em=%d' % d['emissions'], 'svc=%.2f' % d['runner_service_ms'], 'wait=%.2f' % d['runner_wait_ms'], 'kms/em=%s' % d.get('kernel_ms_per_emission'), 'busy=%s' % d.get('busy_share'), 'ingest=%s' % fam.get('ingest'), 'gather=%s' % fam.get('gather'), 'hit_rate=%s' % d.get('cache_hit_rate'), 'feature_hits=%s' % d.get('pages_feature_hits'), 'gathers=%s' % d.get('pages_gathers'), 'footing=%s' % d['footing_problems'])
"
grep -h "Staging\|Profile\|Pages\|Cache" $out/*/log-meta.txt
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

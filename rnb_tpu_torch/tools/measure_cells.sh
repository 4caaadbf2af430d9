#!/usr/bin/env bash
# Measure the port's serving cells on one card, in turns, in one call.
# Cells: dct (configs/rnb-fused-dct-ragged.json over synth:// ids), yuv
# (configs/rnb-fused-yuv-ragged.json), paged (configs/rnb-fused-yuv-
# paged-zipf.json), blob (its blob-cache twin, configs/rnb-fused-yuv-
# zipf-cache.json), big (configs/rnb-fused-yuv-big.json) and the unfused
# multi-step topologies on the rgb path: whole (configs/r2p1d-whole.json),
# whole-ragged (a copy of it with the root "ragged" key, written beside
# the dataset), whole-yuv (configs/r2p1d-whole-yuv.json), split
# (configs/r2p1d-split-1chip.json), rnb (configs/rnb-1chip.json) and
# nopipeline (configs/r2p1d-nopipeline-1chip.json); all but dct over a
# generated y4m dataset. RNB_MEASURE_VIDEOS sets the bulk request count
# (2000; the Poisson runs take half). Each
# phase runs every chosen cell before the next phase starts: bulk, bulk
# with --profile, Poisson at a 20 ms mean interval, and bulk again; then
# one summary line per run from rnb_tpu_torch/parse_utils.py. Run from
# the root of a checkout:
#
#     bash rnb_tpu_torch/tools/measure_cells.sh [out_dir] [cell ...]
#
# (dct, yuv, paged and blob when none is named). The card's name and power limit
# are printed before and after.
out=${1:-logs/measure}
shift
cells=${*:-dct yuv paged blob}
mkdir -p $out
data=$(mktemp -d)
trap 'rm -rf "$data"' EXIT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -m rnb_tpu_torch.dataset "$data" --videos 64
videos=${RNB_MEASURE_VIDEOS:-2000}
python3 - "$data/r2p1d-whole-ragged.json" <<'PY'
import json, sys
raw = json.load(open("configs/r2p1d-whole.json"))
raw["ragged"] = {"enabled": True}
json.dump(raw, open(sys.argv[1], "w"))
PY
run() {  # run <cell> <args...>
  cell=$1; shift
  case $cell in
    dct) cfg=configs/rnb-fused-dct-ragged.json ;;
    yuv) cfg=configs/rnb-fused-yuv-ragged.json ;;
    paged) cfg=configs/rnb-fused-yuv-paged-zipf.json ;;
    blob) cfg=configs/rnb-fused-yuv-zipf-cache.json ;;
    big) cfg=configs/rnb-fused-yuv-big.json ;;
    whole) cfg=configs/r2p1d-whole.json ;;
    whole-ragged) cfg=$data/r2p1d-whole-ragged.json ;;
    whole-yuv) cfg=configs/r2p1d-whole-yuv.json ;;
    split) cfg=configs/r2p1d-split-1chip.json ;;
    rnb) cfg=configs/rnb-1chip.json ;;
    nopipeline) cfg=configs/r2p1d-nopipeline-1chip.json ;;
    *) echo "unknown cell $cell" >&2; exit 2 ;;
  esac
  if [ "$cell" = dct ]; then
    env -u RNB_TPU_DATA_ROOT python3 -m rnb_tpu_torch.benchmark -c $cfg --seed 0 --log-base $out "$@" 2>&1 | grep -E "^(Result|Logs|Throughput|Cache|Pages)"
  else
    RNB_TPU_DATA_ROOT="$data" python3 -m rnb_tpu_torch.benchmark -c $cfg --seed 0 --log-base $out "$@" 2>&1 | grep -E "^(Result|Logs|Throughput|Cache|Pages)"
  fi
}
for c in $cells; do echo "== $c bulk"; run $c -mi 0 -v $videos; done
for c in $cells; do echo "== $c bulk profile"; run $c -mi 0 -v $videos --profile; done
for c in $cells; do echo "== $c poisson 20"; run $c -mi 20 -v $((videos / 2)); done
for c in $(echo $cells | tr ' ' '\n' | tac); do echo "== $c bulk (2nd)"; run $c -mi 0 -v $videos; done
python3 -m rnb_tpu_torch.parse_utils $out/*/ > $out/summary.jsonl
cat $out/summary.jsonl | python3 -c "
import sys, json
for line in sys.stdin:
    d = json.loads(line); fam = d.get('kernel_families') or {}
    print(d['log_dir'].split('/')[-2], d['config'].split('/')[-1], d['mean_interval_ms'], d['pixel_path'], d['decode_backend'], 'vps=%.3f' % d['videos_per_s'], 'cps=%.1f' % d['clips_per_s'], 'em=%d' % d['emissions'], 'svc=%.2f' % d['runner_service_ms'], 'wait=%s' % d['runner_wait_ms'], 'kms/em=%s' % d.get('kernel_ms_per_emission'), 'busy=%s' % d.get('busy_share'), 'ingest=%s' % fam.get('ingest'), 'gather=%s' % fam.get('gather'), 'hit_rate=%s' % d.get('cache_hit_rate'), 'feature_hits=%s' % d.get('pages_feature_hits'), 'gathers=%s' % d.get('pages_gathers'), 'footing=%s' % d['footing_problems'])
"
grep -h "Staging\|Profile\|Pages\|Cache" $out/*/log-meta.txt
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

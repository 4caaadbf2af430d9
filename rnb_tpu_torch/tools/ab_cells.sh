#!/usr/bin/env bash
# Compare two checkouts of the port on one card, in turns, in one call:
# bulk runs of the chosen cells from checkout A (the first argument, for
# example the parent commit unpacked with `git archive`), then from this
# checkout (B), B again, and A again, over one generated y4m dataset;
# then one summary line per run from rnb_tpu_torch/parse_utils.py,
# labelled with its arm and turn. Run from the root of a checkout:
#
#     bash rnb_tpu_torch/tools/ab_cells.sh <checkout_a> [out_dir] [cell ...]
#
# Cells: yuv (configs/rnb-fused-yuv-ragged.json), dct
# (configs/rnb-fused-dct-ragged.json over synth:// ids) and big
# (configs/rnb-fused-yuv-big.json), all three when none is named.
# RNB_MEASURE_VIDEOS sets the request count per run (2000). The card's
# name and power limit are printed before and after.

other=$(cd "$1" && pwd)
here=$(pwd)
out=${2:-logs/ab}
shift $(( $# < 2 ? $# : 2 ))
cells=${*:-yuv dct big}
mkdir -p "$out"
out=$(cd "$out" && pwd)
data=$(mktemp -d)
trap 'rm -rf "$data"' EXIT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -m rnb_tpu_torch.dataset "$data" --videos 64
videos=${RNB_MEASURE_VIDEOS:-2000}
run() {  # run <turn dir> <checkout> <cell>
  case $3 in
    yuv) cfg=configs/rnb-fused-yuv-ragged.json ;;
    dct) cfg=configs/rnb-fused-dct-ragged.json ;;
    big) cfg=configs/rnb-fused-yuv-big.json ;;
    *) echo "unknown cell $3" >&2; exit 2 ;;
  esac
  echo "== $1 $3"
  if [ "$3" = dct ]; then
    (cd "$2" && env -u RNB_TPU_DATA_ROOT python3 -m rnb_tpu_torch.benchmark \
      -c $cfg --seed 0 -mi 0 -v $videos --log-base "$out/$1" 2>&1 \
      | grep -E "^(Result|Throughput)")
  else
    (cd "$2" && RNB_TPU_DATA_ROOT="$data" python3 -m rnb_tpu_torch.benchmark \
      -c $cfg --seed 0 -mi 0 -v $videos --log-base "$out/$1" 2>&1 \
      | grep -E "^(Result|Throughput)")
  fi
}
for turn in A1:$other B1:$here B2:$here A2:$other; do
  for c in $cells; do run ${turn%%:*} ${turn#*:} $c; done
done
python3 -m rnb_tpu_torch.parse_utils "$out"/*/*/ > "$out/summary.jsonl"
python3 - "$out/summary.jsonl" <<'PY'
import json, sys
for line in open(sys.argv[1]):
    d = json.loads(line)
    turn = d["log_dir"].rstrip("/").split("/")[-2]
    print(turn, d["config"].split("/")[-1], "vps=%.3f" % d["videos_per_s"],
          "cps=%.1f" % d["clips_per_s"], "em=%d" % d["emissions"],
          "svc=%.2f" % d["runner_service_ms"], "launches=%s"
          % json.dumps(d["launches"], sort_keys=True))
PY
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

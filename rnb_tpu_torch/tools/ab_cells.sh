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
# (configs/rnb-fused-dct-ragged.json over synth:// ids), big
# (configs/rnb-fused-yuv-big.json), rnb (configs/rnb-1chip.json),
# torchckpt (configs/rnb-fused-yuv-big-torchckpt.json), mid
# (configs/rnb-fused-yuv-mid.json), staged (configs/rnb-fused-yuv-
# staged.json), traced (configs/rnb-fused-yuv-traced.json), and shard-d1
# and shard-d2 (the one-card copies of configs/rnb-shard-d1.json and
# -d2.json, every device index made 0, written beside the dataset); yuv,
# dct and big when none is named.
# RNB_MEASURE_VIDEOS sets the request count per run (2000).
# RNB_AB_TURNS sets the turns (default "A1 B1 B2 A2"): a turn is an arm
# letter and a number, A for checkout A, B for this checkout, N for this
# checkout with RNB_DISABLE_NATIVE=1 (numpy decode threads), and a
# trailing "p" traces the run with --profile (kernel time, busy share).
# The card's name and power limit are printed before and after.

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
python3 - "$data" <<'PY'
import json, os, sys
for name in ("rnb-shard-d1", "rnb-shard-d2"):
    raw = json.load(open("configs/%s.json" % name))
    for step in raw["pipeline"]:
        for group in step["queue_groups"]:
            group["devices"] = [0 if d >= 0 else d for d in group["devices"]]
    json.dump(raw, open(os.path.join(sys.argv[1], name + "-1card.json"), "w"))
PY
videos=${RNB_MEASURE_VIDEOS:-2000}
run() {  # run <turn> <cell>
  case $2 in
    yuv) cfg=configs/rnb-fused-yuv-ragged.json ;;
    dct) cfg=configs/rnb-fused-dct-ragged.json ;;
    big) cfg=configs/rnb-fused-yuv-big.json ;;
    rnb) cfg=configs/rnb-1chip.json ;;
    torchckpt) cfg=configs/rnb-fused-yuv-big-torchckpt.json ;;
    mid) cfg=configs/rnb-fused-yuv-mid.json ;;
    staged) cfg=configs/rnb-fused-yuv-staged.json ;;
    traced) cfg=configs/rnb-fused-yuv-traced.json ;;
    shard-d1) cfg=$data/rnb-shard-d1-1card.json ;;
    shard-d2) cfg=$data/rnb-shard-d2-1card.json ;;
    *) echo "unknown cell $2" >&2; exit 2 ;;
  esac
  case $1 in
    A*) dir=$other; env=() ;;
    B*) dir=$here; env=() ;;
    N*) dir=$here; env=(RNB_DISABLE_NATIVE=1) ;;
    *) echo "unknown turn $1" >&2; exit 2 ;;
  esac
  flags=()
  case $1 in *p) flags=(--profile) ;; esac
  if [ "$2" = dct ]; then
    env=(-u RNB_TPU_DATA_ROOT "${env[@]}")  # env's options come first
  else
    env+=(RNB_TPU_DATA_ROOT="$data")
  fi
  echo "== $1 $2"
  (cd "$dir" && env "${env[@]}" python3 -m rnb_tpu_torch.benchmark \
    -c $cfg --seed 0 -mi 0 -v $videos --log-base "$out/$1" "${flags[@]}" \
    2>&1 | grep -E "^(Result|Throughput)")
}
for turn in ${RNB_AB_TURNS:-A1 B1 B2 A2}; do
  for c in $cells; do run "$turn" "$c"; done
done
python3 -m rnb_tpu_torch.parse_utils "$out"/*/*/ > "$out/summary.jsonl"
python3 - "$out/summary.jsonl" <<'PY'
import json, sys
for line in open(sys.argv[1]):
    d = json.loads(line)
    turn = d["log_dir"].rstrip("/").split("/")[-2]
    print(turn, d["config"].split("/")[-1], "vps=%.3f" % d["videos_per_s"],
          "cps=%.1f" % d["clips_per_s"], "em=%d" % d["emissions"],
          "svc=%.2f" % d["runner_service_ms"],
          "kms/em=%s" % d.get("kernel_ms_per_emission"),
          "busy=%s" % d.get("busy_share"),
          "backend=%s" % d["decode_backend"],
          "graphs=%s" % json.dumps(d.get("graphs"), sort_keys=True),
          "compiles=%s" % json.dumps(d.get("compile_signatures"),
                                     sort_keys=True),
          "launches=%s" % json.dumps(d["launches"], sort_keys=True),
          "shard=%s" % json.dumps(d.get("shard"), sort_keys=True))
PY
grep -h "^Staging" "$out"/*/*/log-meta.txt | sort | uniq -c | sort -rn \
  | head -20
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

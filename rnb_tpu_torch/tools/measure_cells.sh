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
# nopipeline (configs/r2p1d-nopipeline-1chip.json); segment (the one-card
# copy of configs/r2p1d-segment.json, every device index >= 0 made 0,
# written beside the dataset), traced (configs/rnb-fused-yuv-traced.json)
# and staged (configs/rnb-fused-yuv-staged.json, the traced cell without
# its trace key); metrics (configs/rnb-fused-yuv-metrics.json, the staged
# cell with the live-metrics plane), autotune (configs/rnb-fused-yuv-
# autotune.json, the staged cell with the batch controller) and critpath
# (the traced cell with the root "critpath" key, written beside the
# dataset), devobs (configs/rnb-fused-yuv-devobs.json, the metrics cell
# with trace and the device observability plane), traced-metrics (the
# devobs cell without its devobs key) and devobs-quiet (the devobs cell
# with "capture_on_trigger": false: no capture opens), both written
# beside the dataset, and staged-chaos (the
# staged cell's chaos copy with an empty
# fault plan, rnb_tpu_torch/tools/chaos.py --empty-plan: overload_policy
# shed, retry budgets and a deadline no request reaches, so every
# containment check runs and nothing fails); shard-d1 and shard-d2 (the
# one-card copies of configs/rnb-shard-d1.json and -d2.json, every device
# index made 0, written beside the dataset: the degree-2 ring's members
# share the card); operator (configs/rnb-fused-yuv-operator.json, the
# metrics cell with the operator plane's HTTP server and 25 Hz stack
# sampler; nothing scrapes it); netedge-off and netedge-loopback
# (configs/rnb-netedge-off.json and -loopback.json as shipped: the plain
# dct loader in process, and the same loader in a spawned peer process on
# the card behind the TCP edge; the peer prints its memory at exit); mesh
# and mesh-yuv (the one-card copies of configs/r2p1d-mesh.json and
# -mesh-yuv.json, every device index and mesh_devices made 0, written
# beside the dataset: dp 2 over 8 members sharing the card); torchckpt
# (configs/rnb-fused-yuv-big-torchckpt.json, seeded weights) and
# torchckpt-file (its copy serving a converted checkpoint: the synthetic
# reference file of rnb_tpu_torch/tools/synth_ckpt.py, centred on the
# dataset and converted beside it, its time printed); all
# but dct and the netedge cells over a generated y4m dataset. With
# RNB_HOST_PROFILE=1 in the environment every run also writes
# hostprof.txt, and its sections are printed at the end.
# RNB_MEASURE_VIDEOS sets the bulk request count
# (2000; the Poisson runs take half). Each
# phase runs every chosen cell before the next phase starts: bulk, bulk
# with --profile (skipped with RNB_MEASURE_PROFILE=0), Poisson at each
# mean interval of RNB_MEASURE_INTERVALS in turn ("20" when unset), and
# bulk again; then one summary line per run from
# rnb_tpu_torch/parse_utils.py (with the Autotune:, Metrics:, Critpath:,
# Compute: and Memory: counters where the run has them). Run from
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
python3 - "$data/rnb-fused-yuv-traced-critpath.json" <<'PY'
import json, sys
raw = json.load(open("configs/rnb-fused-yuv-traced.json"))
raw["critpath"] = {"enabled": True}
json.dump(raw, open(sys.argv[1], "w"))
PY
python3 -m rnb_tpu_torch.tools.chaos "$data/rnb-fused-yuv-staged-chaos.json" --empty-plan
python3 - "$data" <<'PY'
import json, os, sys
raw = json.load(open("configs/rnb-fused-yuv-devobs.json"))
quiet = dict(raw, devobs=dict(raw["devobs"], capture_on_trigger=False))
json.dump(quiet, open(os.path.join(sys.argv[1], "rnb-fused-yuv-devobs-quiet.json"), "w"))
del raw["devobs"]
json.dump(raw, open(os.path.join(sys.argv[1], "rnb-fused-yuv-traced-metrics.json"), "w"))
PY
python3 - "$data" <<'PY'
import json, os, sys
for name in ("r2p1d-segment", "rnb-shard-d1", "rnb-shard-d2", "r2p1d-mesh",
             "r2p1d-mesh-yuv"):
    raw = json.load(open("configs/%s.json" % name))
    for step in raw["pipeline"]:
        for group in step["queue_groups"]:
            group["devices"] = [0 if d >= 0 else d for d in group["devices"]]
        if "mesh_devices" in step:
            step["mesh_devices"] = [0] * len(step["mesh_devices"])
    json.dump(raw, open(os.path.join(sys.argv[1], name + "-1card.json"), "w"))
PY
case " $cells " in
  *" torchckpt-file "*) python3 -m rnb_tpu_torch.tools.synth_ckpt "$data/ckpt" --data "$data" ;;
esac
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
    segment) cfg=$data/r2p1d-segment-1card.json ;;
    traced) cfg=configs/rnb-fused-yuv-traced.json ;;
    staged) cfg=configs/rnb-fused-yuv-staged.json ;;
    metrics) cfg=configs/rnb-fused-yuv-metrics.json ;;
    devobs) cfg=configs/rnb-fused-yuv-devobs.json ;;
    devobs-quiet) cfg=$data/rnb-fused-yuv-devobs-quiet.json ;;
    traced-metrics) cfg=$data/rnb-fused-yuv-traced-metrics.json ;;
    autotune) cfg=configs/rnb-fused-yuv-autotune.json ;;
    critpath) cfg=$data/rnb-fused-yuv-traced-critpath.json ;;
    staged-chaos) cfg=$data/rnb-fused-yuv-staged-chaos.json ;;
    shard-d1) cfg=$data/rnb-shard-d1-1card.json ;;
    shard-d2) cfg=$data/rnb-shard-d2-1card.json ;;
    operator) cfg=configs/rnb-fused-yuv-operator.json ;;
    netedge-off) cfg=configs/rnb-netedge-off.json ;;
    netedge-loopback) cfg=configs/rnb-netedge-loopback.json ;;
    mesh) cfg=$data/r2p1d-mesh-1card.json ;;
    mesh-yuv) cfg=$data/r2p1d-mesh-yuv-1card.json ;;
    torchckpt) cfg=configs/rnb-fused-yuv-big-torchckpt.json ;;
    torchckpt-file) cfg=$data/ckpt/rnb-fused-yuv-big-torchckpt-file.json ;;
    *) echo "unknown cell $cell" >&2; exit 2 ;;
  esac
  if [ "$cell" = dct ] || [ "${cell#netedge}" != "$cell" ]; then
    env -u RNB_TPU_DATA_ROOT python3 -m rnb_tpu_torch.benchmark -c $cfg --seed 0 --log-base $out "$@" 2>&1 | grep -E "^(Result|Logs|Throughput|Cache|Pages|Autotune|Metrics|Critpath|Faults|Deadline|Compute|Memory|Net|Health|\[rnb-tpu-torch\] (operator|netedge))"
  else
    RNB_TPU_DATA_ROOT="$data" python3 -m rnb_tpu_torch.benchmark -c $cfg --seed 0 --log-base $out "$@" 2>&1 | grep -E "^(Result|Logs|Throughput|Cache|Pages|Autotune|Metrics|Critpath|Faults|Deadline|Compute|Memory|Net|Health|\[rnb-tpu-torch\] (operator|netedge))"
  fi
}
for c in $cells; do echo "== $c bulk"; run $c -mi 0 -v $videos; done
if [ "${RNB_MEASURE_PROFILE:-1}" != 0 ]; then
  for c in $cells; do echo "== $c bulk profile"; run $c -mi 0 -v $videos --profile; done
fi
for mi in ${RNB_MEASURE_INTERVALS:-20}; do
  for c in $cells; do echo "== $c poisson $mi"; run $c -mi $mi -v $((videos / 2)); done
done
for c in $(echo $cells | tr ' ' '\n' | tac); do echo "== $c bulk (2nd)"; run $c -mi 0 -v $videos; done
python3 -m rnb_tpu_torch.parse_utils $out/*/ > $out/summary.jsonl
cat $out/summary.jsonl | python3 -c "
import sys, json
for line in sys.stdin:
    d = json.loads(line); fam = d.get('kernel_families') or {}
    print(d['log_dir'].split('/')[-2], d['config'].split('/')[-1], d['mean_interval_ms'], d['pixel_path'], d['decode_backend'], 'vps=%.3f' % d['videos_per_s'], 'cps=%.1f' % d['clips_per_s'], 'em=%d' % d['emissions'], 'svc=%.2f' % d['runner_service_ms'], 'wait=%s' % d['runner_wait_ms'], 'svc_by_step=%s' % json.dumps(d.get('service_ms_by_step')), 'em_by_step=%s' % json.dumps(d.get('emissions_by_step')), 'trace_events=%s' % d.get('trace_events'), 'kms/em=%s' % d.get('kernel_ms_per_emission'), 'busy=%s' % d.get('busy_share'), 'ingest=%s' % fam.get('ingest'), 'gather=%s' % fam.get('gather'), 'hit_rate=%s' % d.get('cache_hit_rate'), 'feature_hits=%s' % d.get('pages_feature_hits'), 'gathers=%s' % d.get('pages_gathers'), 'autotune=%s' % json.dumps(d.get('autotune')), 'autotune_buckets=%s' % json.dumps(d.get('autotune_buckets')), 'metrics=%s' % json.dumps(d.get('metrics')), 'slo=%s' % json.dumps(d.get('slo')), 'critpath=%s' % json.dumps(d.get('critpath')), 'faults=%s' % json.dumps(d.get('faults')), 'deadline=%s' % json.dumps(d.get('deadline')), 'compute=%s' % json.dumps(d.get('compute')), 'memory=%s' % json.dumps(d.get('memory')), 'shard=%s' % json.dumps(d.get('shard')), 'operator=%s' % json.dumps(d.get('operator')), 'stacks=%s' % json.dumps(d.get('stacks')), 'net=%s' % json.dumps(d.get('net')), 'net_errors=%s' % json.dumps(d.get('net_errors')), 'health=%s' % json.dumps(d.get('health')), 'footing=%s' % d['footing_problems'])
"
for f in $out/*/hostprof.txt; do
  [ -f "$f" ] && { echo "== $f"; head -n 40 "$f"; }
done
grep -H "Staging\|Profile\|Pages\|Cache\|Graphs\|Warmup\|Trace\|Autotune\|Metrics\|Slo\|Critpath\|Faults\|Deadline\|Compute\|Memory\|Shard\|Operator\|Stacks\|Net\|Health" $out/*/log-meta.txt
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

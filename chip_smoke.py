#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rnb_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compile the port's CUDA kernels from ``rnb_tpu_torch/csrc``
   and, at the same time, the native C++ decoder from
   ``native/decode.cpp`` (``rnb_tpu_torch/ops/_native.py``), each
   build's seconds printed, and beside them count the dct kernels' SASS
   instructions by source section (``rnb_tpu_torch/tools/sass_counts.py``),
   printed on ``sass`` lines before the result;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the serving paths' shapes (rows 48 and 15, rows_valid = rows, 5,
   0, read by the yuv420 kernel and the dct convert from one device
   scalar that is rewritten between launches whose arguments stay the
   same) — the normalize kernel and the dct unpack bitwise, the
   colourspace kernel's u8 entry within one u8 step and its fused
   normalize entry bitwise the normalize kernel of the u8 entry's
   output (bf16; f32 bitwise the plain normalize), both also at a width
   that is not a multiple of 16 (the scalar path), the dct convert
   within two u8 steps (one per quantized plane, carried through
   BT.601), also at a second geometry, pad rows exact; the fused dct
   ingest (the serving path's one dct launch) bitwise the unpack
   followed by the convert at 48 and 15 rows and at the second geometry
   (a garbage wire row among its pad rows), bf16 and f32, and within two
   u8 steps of its plain version — and each one's time on the card (the
   profiler's device time per call; CUDA events around each call, queued
   behind a spin on the card, where no profiler session comes back whole)
   with L2 warm (back-to-back calls on one input) and with L2 flushed
   (256 MB written between calls; only the calls' own events summed)
   beside its bound and its plain version's, plus its time per
   back-to-back call by CUDA events; the
   fused entries' beside the two launches each replaces (the dct ingest
   also at 48 rows);
   The gather kernel is held bitwise to its plain version at the clip
   arena's rows (15 x 8 x 18,816 u8 over a 1,780-row slab) and the
   feature arena's (15 x 400 float32), on five source tables, timed at
   the 15-row clip pool with 8 hits, and on an all-hit table beside
   ``torch.index_select`` of the same table (both with L2 warm and
   flushed), and the clip arena's stream order is checked: a gather
   issued before a write of its page returns the old rows;
   The ragged normalize kernel is held bitwise to its plain version at
   the unfused loader's full-width pool (15 x 8 x 112 x 112 x 3 u8) for
   ``rows_valid`` in {0, 1, 7, 14, 15} read from one device scalar that
   is rewritten between launches whose arguments stay the same, over a
   pool whose tail holds random bytes (pad rows come out zero, so the
   tail was not read into the result), at one odd row size through the
   byte loop, at the scale-out loaders' pool (3 x 2 x 112 x 112 x 3 u8,
   ``rows_valid`` 0 to 3), and against the bucketed normalize kernel on
   the valid rows; timed at 15 and at 7 valid rows beside its bounds, its plain
   version and the bucketed kernel at 15 rows;
   The ring-shift kernel (the grouped hop under the shard ring
   collectives: a table of entries, each with its own shift, written
   into slots of the gathered tensors) is held bitwise to its plain
   version, every destination a slot of a canary-filled tensor whose
   other bytes must stay as they were: the 19 sharded leaves of
   R(2+1)D-18 at degree 2 in bf16 as one table (own slots and the hop)
   and their all-gather, in one launch, against the concatenation; the
   conv5 temporal leaf at degree 4 (one-buffer hops at shifts 1 to 3,
   a table of shifts 0 to 3, its gather in 3 launches); the (15, 200)
   float32 merge blocks as rows at a pitch; 1001 bytes and 13-byte rows
   at degree 3; views 1 and 3 bytes off 16-byte alignment; and the
   kernel's stack frame (``ptxas -v``) is 0 bytes. Timed with L2 warm
   and flushed beside the bound and the plain version: the conv5 hop
   alone (``torch.roll`` of the members' stacked bytes), the conv5
   leaf's gather and the merge (``torch.cat``), and a whole forward's
   gather at degree 2, beside its 19 gathers one leaf at a time;
   then rnb-lint of the port (``phase_lint``): ``python -m
   rnb_tpu_torch.tools.lint`` over the checkout exits 0, its per-family
   finding, baselined and stale counts and its seconds printed;
4. path: serve ``configs/rnb-fused-yuv-big.json`` and
   ``configs/rnb-fused-yuv-ragged.json`` over a generated y4m dataset,
   and ``configs/rnb-fused-dct-ragged.json`` over ``synth://`` ids, at
   full R(2+1)D-18 width on cuda:0, in bulk; then the Zipf cache cells
   under Poisson arrivals: ``configs/rnb-fused-yuv-paged-zipf.json``, a
   copy of it with ``pager.feature_cache`` off (repeats become clip-page
   hits) and ``configs/rnb-fused-yuv-zipf-cache.json``. Check that every
   request completed with finite logits, that each config launched
   exactly its own kernels in the measured window, that a few
   requests' logits (on the features-off copy, a clip-page hit among
   them) agree with a CPU recompute through the plain versions on the
   same seeded weights, that each bulk yuv420 or dct run launched its
   ingest kernel once per emission, that the ``Pages:`` footings hold, that the
   cache answered (feature hits, gathers, blob hits), and that every
   feature hit's logits are bitwise those of its video's first
   serving. Then the unfused multi-step topologies on the rgb path:
   ``configs/r2p1d-whole.json`` (loader -> runner; the bucketed
   normalize in the loader step), a copy of it with the root ``ragged``
   key (the ragged normalize kernel once per emission, the bucketed one
   never), ``configs/r2p1d-whole-yuv.json``,
   ``configs/r2p1d-split-1chip.json`` (a feature map between 1..4 and
   5..5; logits held to the unsplit run's), ``configs/rnb-1chip.json``
   (Large/Small routing into two batchers; at least one six-request
   fused batch) and ``configs/r2p1d-nopipeline-1chip.json`` (class ids
   held to the argmax of the two-step run's logits), each with a CPU
   recompute of two requests where it emits logits (of its smallest
   request where its logits are held to the two-step run's). Then
   ``configs/rnb-fused-yuv-big-torchckpt.json`` (the factored shortcut)
   and ``configs/rnb-fused-yuv-mid.json`` (``depth``), at fewer
   requests, with the same checks as big.
   Right after ``r2p1d-whole``: the one-card copy of
   ``configs/r2p1d-segment.json`` (every device index >= 0 made 0: the
   rgb loader with ``num_segments`` 3, seven runner instances of 5 rows
   on cuda:0, the ``R2P1DAggregator`` on the host), on the whole run's
   requests — every class id in [0, 400), the argmax of its segment
   sums recomputed on the card, those sums held element by element to
   the whole run's summed logits, and the class id equal to the argmax
   of the whole run's sums outside a top-2 margin of twice the
   request's largest difference between the two sums (near ties
   counted and printed, and more than one in ten of the requests
   serving another class id than the whole run fails), two requests'
   segment sums held element by element to the CPU's float32 sums,
   ``normalize_u8`` once per request and no other kernel, three
   graph replays per request, ``-0/-1/-2`` stamps in the merged cards —
   and ``configs/rnb-fused-yuv-traced.json`` as shipped: its
   ``trace.json`` passes ``validate_trace``, its ``Trace:`` line matches
   the file, every request's phases sum to its end-to-end latency, and
   ``yuv420_normalize`` runs once per emission.
   Last, the planes of the live metrics, the batch controller and
   critical-path extraction: ``configs/rnb-fused-yuv-metrics.json`` as
   shipped at a Poisson mean interval of 20 ms with ``RNB_FLIGHT_FORCE``
   set for this run only — two or more ``Metrics:`` snapshots and a
   flight dump, every counter monotone and each histogram's buckets
   summing to its count, the final snapshot's ``client.requests`` equal
   to the requests the client created and its ``staging.*`` counters to
   the ``Staging:`` line, ``Slo:`` tracking every completion, all within
   (no budget is configured) and burning nothing, ``metrics.prom``
   written and every ``flight-<n>.json`` valid per ``validate_trace``,
   and no ``Compute:``/``Memory:`` line or capture file (devobs off);
   ``configs/rnb-fused-yuv-autotune.json`` as shipped, in bulk and at a
   Poisson mean interval of 25 ms — decisions made, the controller's
   emissions equal to the loader's, only the warmed buckets 6 and 15
   chosen (the immediate/held split and the bucket counts printed, not
   asserted); and a copy of the traced config with the root
   ``critpath`` key (12 requests in bulk) — every request's blocking
   chain summing to its end-to-end latency within 1 us, ``Critpath:``
   requests equal to the completions less the summary's skips, its bound
   step a step of the pipeline and the ``# critpath`` trailer written.
   Each of them launches ``yuv420_normalize`` once per emission and has
   one request's logits held to the CPU recompute.
   Then fault containment and deadlines: the staged cell's chaos copy
   (``rnb_tpu_torch/tools/chaos.py``: ``overload_policy`` shed, two
   retries 5 ms apart on both steps, a 1000 ms deadline, a seeded plan
   with permanent faults at step 0 on requests 2 and 5, transients at
   step 1 on 1 and 13, and 1500 ms stalls at step 1 on request 20 and at
   step 0 on 60), over a copy of the dataset that adds one video whose
   header probes and whose decode fails (request 8 draws it first), in
   bulk (64 requests) and as a burst (a Poisson mean of 1 ms into queues
   4 deep, 3000 requests, the burst's own copy: the same faults but both
   stalls on request 0, the client's first, always admitted — 100 ms at
   step 0, so the client sheds, then 1500 ms at step 1, so what step 0
   published meanwhile expires at step 1's take; the target outlasts
   what is shed during the stalls): completed + failed + shed equal to the
   requests in bulk (at least the target in the burst), the dead
   letters the plan's permanent ids (all of them in bulk) and the broken
   video's requests (request 8 in bulk), the broken decode failing
   inside a fused take whose other requests are served (in bulk), the
   retries the transient firings, each retry's staged input bitwise the
   first attempt's, each retried request's logits bitwise those of a
   fault-free replay of that input on the same captured graph and held
   to the CPU recompute, at least one deadline shed (``Deadline sites:`` cross-footed
   with ``Shed sites:``; in bulk one at step 1's queue take), client
   sheds in the burst, no graph captured
   after the warm-ups, and the port's ``parse_utils`` checks passing on
   each job directory; last, ``configs/r2p1d-tiny-shed.json`` with its
   devices 0 and 1 made 0 (32 requests in bulk: the rgb loader and
   ``normalize_u8`` once per request, a narrow 8-class runner), its
   logs through ``parse_utils`` and two requests recomputed on the CPU.
   Then the intra-stage sharding pair: one-card copies of
   ``configs/rnb-shard-d1.json`` and ``configs/rnb-shard-d2.json``
   (every device index made 0, so the degree-2 ring's members share the
   card), 64 requests each in bulk: every request's d2 logits bitwise
   d1's, ``rnb_ring_shift`` launched once a forward (the grouped gather
   of all 19 leaves; warm-ups, capture warm-ups and graph replays) and
   once a merge in d2 and never in d1, each copy's graph pool printed,
   one merge a forward with collective time spent, the ``Shard:``
   lines footed by the port's ``parse_utils`` and ``exec1.collective``
   in ``metrics.jsonl``; then the d1 copy under a budget between the
   port's two projections, whose stage raises the reference's rejection
   naming degree 2.
   Last, the device observability plane (served after the others, so
   their timing stays as it was): ``configs/rnb-fused-yuv-devobs.json``
   as shipped (64 requests in bulk, ``RNB_DEVOBS_FORCE`` set for this run
   only) — the port's ``parse_utils`` checks green, step 1's
   ``flops_per_row`` the config walk's, ``Compute:`` rows the completed
   clips and ``tflops_milli``/``mfu_e4`` what the clips, the window and
   the card's peak give to the digit, ``Memory:`` reconciled against
   ``torch.cuda.memory_allocated`` with no watermark hit, a capture
   holding the yuv420 kernel on ``/device:GPU:0``, ``trace.json`` with a
   ``device:`` track that a flow event binds, ``yuv420_normalize`` once
   per emission and one request's logits held to the CPU recompute; then
   a copy with a 1 MiB watermark (32 requests) — a watermark hit, a
   capture it triggered and a flight dump; each prints the job and busy
   MFU, the owners' bytes, the captures' kernels by share of their spans
   and the card's name and power limit.
   Then the operator plane: ``configs/rnb-fused-yuv-operator.json`` as
   shipped (400 requests in bulk, so that the window outlasts a few
   250 ms metrics ticks), scraped while it serves by a thread that reads
   the bound address from ``operator.json``: ``GET /healthz``,
   ``/metrics``, ``/statusz``, ``/stacks`` and ``/whatif?replicas_step1=2``
   all 200 inside the measured window, ``POST /flight`` 403, ``Operator:
   scrapes >= 5 denied == 1 errors == 0``, ``stacks.folded`` holding a
   ``runner-s1-g0-i0`` stack; then a copy with ``allow_actions``, the
   devobs cell's ``devobs`` key and ``whatif`` (32 requests at a 20 ms
   Poisson mean): ``POST /flight`` writing a valid ``flight-<n>.json``,
   ``POST /capture`` a ``devobs-capture-<n>.txt`` holding the yuv420
   kernel on ``/device:GPU:0``, ``Whatif: calibrated=1``; both through
   the port's ``parse_utils`` (the ledger against ``operator.json``, the
   folded stacks against ``Stacks:``, ``Whatif:`` recomputed), each with
   one request's logits held to the CPU recompute.
   Last, the network ingest edge, over ``synth://`` ids:
   ``configs/rnb-netedge-off.json`` as shipped (300 requests in bulk; no
   ``Net:`` or ``Health:`` line, no frame read), then
   ``configs/rnb-netedge-loopback.json`` as shipped (300 requests in bulk,
   step 0 in a spawned peer process on the card): every request remote,
   none local, no net error, no reconnect, every REQ acked once, the DATA
   rows whole 9,408-byte dct frames (the completed clips' frames), step 0
   on ``cuda:0`` for every request, the rows of every 50th request's DATA
   frame bitwise the in-process loader's emission of its video, the
   ``Net:``/``Health:`` footings green; both launch ``rnb_dct_ingest``
   once per emission inside the captured forward and have requests'
   logits held to the CPU recompute. Then a copy of
   ``configs/rnb-netedge-chaos.json`` with its device 1 made 0, 30
   requests at a 200 ms Poisson mean into 64-deep queues, seed 17, held
   to ``scripts/netchaos_demo.py``'s contract: every request terminated
   once, no strand, the dedup ledger balanced, the reset classified and
   survived by a reconnect, the wedge's timeout classified after the
   circuit opened, refused dials after the peer's kill, exactly one
   eviction by a legal path, requests served both remotely and locally,
   no route to the open lane, the wire ledger footed; the main process's
   loader normalized the local requests only; one remote and one local
   request recomputed on the CPU.
   Then the shipped configs no run above serves (``phase_configs``),
   16 requests each in bulk over the y4m dataset:
   ``configs/rnb-fused-yuv.json``, ``configs/rnb-1chip-yuv.json`` and
   ``configs/rnb-fused-yuv-xl.json`` as shipped, and one-card copies
   (every device index >= 0 made 0) of ``r2p1d-tiny`` (its own reduced
   geometry), ``r2p1d-split``, ``baseline``, ``r2p1d-aggressive-global``,
   ``r2p1d-aggressive``, ``r2p1d-aggressive-four-groups``,
   ``r2p1d-nopipeline`` (eight single steps) and ``rnb`` (eight loaders
   into two Batchers on the card, then eight runners): every request
   served, the config's ingest kernel (``rnb_normalize_u8`` on rgb,
   ``rnb_yuv420_normalize`` on yuv420) launched in the window and no
   other, once an emission where no Batcher fuses again, every runner
   or single-step instance the config declares built on cuda:0 and
   its graphs captured there, every graph bitwise its eager forward,
   native decode, two requests recomputed on the CPU; each run's
   videos/s, peak device memory (allocated and reserved) and the
   requests of each last-step instance printed beside the card's name
   and power limit. With the runs before and after it, every shipped
   config serves (``SERVED_CONFIGS``).
   Then the replica lanes (``phase_lanes``), over the y4m dataset:
   one-card copies of ``configs/rnb-scaleout-r1.json``, ``-r4.json`` and
   ``-r4-chaos.json`` (every device index made 0: four lanes, each on a
   stream of its own, share the card), at ``scripts/multichip_demo.py``'s
   workload (bulk, 12 requests, seed 17, 64-deep queues, the shipped 2000
   ms emulated step-1 service). r1 and r4 end cleanly, the port's
   ``check_job`` green, r4 at least 2.5x r1's videos/s on four lanes,
   every edge take d2d with 0 host bytes, and r1's measured costs,
   recomputed at the shipped r4 config's five devices, recommend at least
   four step-1 lanes (the run's own ``Placement:`` plans over the one
   card). The chaos copy at ``scripts/chaos_demo.py``'s 12 requests and
   again at 48, which outlast lane 3's 2.5 s wedge: every request ends
   once, every dead letter ``chaos-lane-kill``, lane 3 evicted by a
   legal path and no sibling, no route to an open lane, hedges won + lost
   == fired, and at 48 the circuit opened and lane 3's queued work was
   redispatched. Each run launches only ``rnb_ragged_normalize_u8``, once
   per loader emission, prints each lane's graph pool and capture
   seconds, and has two requests recomputed on the CPU. Then the
   explanation plane (``phase_explain``, the three legs of
   ``rnb_tpu_torch/tools/explain.py``): ``parse_utils --explain`` on the
   critpath run above exits 0 with every chain within 1 ms of its
   request's latency and ``check_job`` green; the one-card r1 copy with
   the ``metrics`` and ``whatif`` keys served at the lanes' workload, a
   queueing model calibrated from its job directory alone and asked for
   three more step-1 lanes, its r4/r1 ratio within 25% of the r4 copy's
   videos/s above over this r1's; and two same-seed runs of
   ``configs/rnb-fused-yuv.json``'s one-card copy at Poisson 20 ms (100
   requests), arm B with a 5 ms ``latency`` fault at its runner step:
   ``rnb_diff`` ranks ``inference1`` as the top significant work phase,
   2.5-10 ms a request, and a self-diff of arm A finds no phase
   significant. Each of these runs launches its path's ingest kernel and
   no other. Then the
   lock-order witness (``phase_witness``): the big config, the r4 lane
   copy and the paged cell served again with ``lint: {"lock_witness":
   true}`` at their unarmed workloads, each with zero witness
   violations and ``check_job`` green (every observed edge in rnb-lint's
   static lock-order graph), the paged cell's hits observing
   ``ClipCache._lock -> Pager.lock``, the big and r4 copies serving the
   unarmed runs' class ids past the bf16 margin; each run's ``Locks:``
   ledger and videos/s printed beside the unarmed run's. Then the
   clip-sharded mesh stage (``phase_mesh``): one-card copies of
   ``configs/r2p1d-mesh.json`` (33 requests in bulk, so the last
   dispatch's dp axis is padded with a zero video) and
   ``configs/r2p1d-mesh-yuv.json`` (32) at their shipped geometry (the
   loader's ``raw_output``, dp 2 over 8 members sharing the card, 15
   clips padded to 16, ``sync_preds`` false): every request's class id
   held to a full-width recompute of its valid clips on the CPU through
   the plain versions, ``rnb_normalize_u8`` (rgb; the loader launches
   none) or ``rnb_yuv420_normalize`` (yuv420) held to its plain version
   at the dispatch's 32 rows and launched once a dispatch inside the
   stage's captured graph and no other kernel, one replay a
   dispatch, the graph bitwise its eager forward on seeded dispatches
   (a zero video among them) and its replay timed. Then converted
   checkpoints (``phase_ckpt``): a full-width R(2+1)D-18 state dict in
   the reference's torch format drawn from a seed, its head centred on
   the dataset, saved as a ``.pth.tar`` and converted by
   ``convert_file`` (``rnb_tpu_torch/tools/synth_ckpt.py``); copies of
   ``configs/rnb-fused-yuv-big-torchckpt.json`` (64 requests in bulk)
   and ``configs/r2p1d-split-1chip.json`` (16) with ``ckpt_path`` at the
   file and the factored shortcut on every runner step: every parameter
   and buffer on the card the file's range bitwise after the cast (each
   split stage exactly its range's keys), every conv kernel and the head
   unlike the seeded init's, finite logits of more than one class id,
   three requests recomputed on the CPU from the same file,
   ``check_job`` green, ``rnb_yuv420_normalize`` once an emission (big)
   or ``rnb_normalize_u8`` (split) and no other kernel; then the CLI on
   a copy whose ``ckpt_path`` names no file: exit 1 with the reference's
   ``FileNotFoundError`` and nothing served. Then
   ``bench_cuda.py`` in a process of its own (300 requests): its one JSON
   line, on the card (``platform`` gpu), decoded on the native pool, the
   yuv420 ingest launched, a positive value and a numeric MFU. Then the
   port's measurement tools through their CLIs over that dataset
   (``phase_tools``): ``tools/bench_matrix.py --only`` on three cells of
   200 requests (``rnb-fused-yuv-big`` in bulk and in Poisson at 6 ms,
   ``r2p1d-whole`` in bulk) and ``tools/latency_frontier.py`` on
   ``rnb-fused-yuv-mid`` at 4 and 9 ms, each cell a fresh
   ``bench_cuda.py`` process: every row on the card at the asked mean
   interval with a positive value, its path's ingest kernel launched and
   its job directory (``evidence_logs``) clean under
   ``check_job_detail``; ``tools/latency_summary.py`` over both outputs,
   one row a job; ``parse_utils --stamps``. Last,
   MJPEG files (``phase_mjpeg``): two 16-video trees written at once by
   the port's own encoder on this host (``rnb_tpu_torch/dataset.py
   --format mjpeg``; quality 90 for the pixel paths, 70 for dct, every
   frame of that one within the dct budget), each write timed;
   ``configs/rnb-fused-yuv-big.json`` (yuv420) and
   ``configs/r2p1d-whole.json`` (rgb) over the first and
   ``configs/rnb-fused-dct-ragged.json`` (dct) over the second, 32
   requests each in bulk: every request served and none dead-lettered,
   every decode on the native pool, each config's own kernels launched
   (``rnb_yuv420_normalize`` and ``rnb_dct_ingest`` once an emission)
   and no other, two requests recomputed on the CPU; the native
   coefficient rows of sampled clips bitwise the pure-Python
   ``jpeg_dct``'s and the encoder's own; and the busy-card probe: a
   child process that holds 64 MiB on the card adds exactly one process
   to what ``nvidia-smi`` lists there beside this one (what was there
   before it is printed, not required to be empty), and the probe warns
   about ``cuda:0`` while it does.
   Then the reference's parallel API and its entry points
   (``phase_parallel``): ``rnb_tpu_torch.graft_entry.entry()``'s
   flagship forward (R(2+1)D-18 and the 400-class head in bf16 over 15
   clips of 8 x 112 x 112), its logits (15, 400) and finite, and on a
   seeded batch within the bf16 bound of the CPU's float32 recompute
   (argmax equal past twice the bound), timed; ``make_sharded_inference``
   at full width over ``build_mesh([cuda:0] * 8, axes={"dp": 2, "sp":
   4})`` (15 clips padded to 16), in rgb and in yuv420, on four seeded
   videos of 15, 7, 1 and 12 valid clips: two ``run`` s and a
   ``predict``, the first run capturing ``run`` as one CUDA graph (its
   warm-up one ingest launch), each a replay of one ingest launch and no
   other kernel, the second run bitwise the first and the captured run
   bitwise the eager ``step``, every video within rtol = atol = 2e-2 of
   the
   same network's unsharded masked sum, ``predict``'s class ids the
   unsharded ones past the margin, the ingest kernel held to its plain
   version at the run's 64 rows, ``run`` timed at dp 2 x 16 rows, and
   the median of 12 captured runs against 12 eager steps;
   ``dryrun_multichip(8)`` and ``(2)`` with every member on the card,
   each printing its ``ok`` line (the 8-member one serves its tiny
   yuv420 mesh pipeline through ``run_benchmark``); and
   ``global_mesh().shape`` and ``process_count()`` printed.
   Then two processes of one launch on the card (``phase_processes``;
   ``rnb_tpu_torch.tools.launch`` sets the three ``RNB_TPU_*``
   variables, each process joins the launch's gloo group and acts on
   card ``index % device_count()``, here both on cuda:0): with the
   counts set to 0 before it and read after, the conv5 temporal hop, a
   d2 forward's 19-leaf gather and a reduce-scatter across the two
   processes (the ring kernel's cross-process form, ``rnb_ring_hop``,
   one launch a hop writing straight into the successor's arena opened
   by CUDA IPC), each bitwise its plain version on the same inputs, and
   ``ShardedInference``'s ``run`` and ``predict`` at full width over the
   launch's dp 1 x sp 2 mesh (2 videos of 15 clips padded to 16, 16 rows
   a process; the first run captures it as one CUDA graph), within rtol
   = atol = 2e-2 of the one-process run, class ids compared past the
   margin; exactly 6 ring launches (five collectives of one hop, one
   launch each, and the capture's warm-up) and 3 ingest launches a
   process. Then 8 replays of the captured run on new videos, each
   bitwise the eager ``step_across`` on the same inputs, each one ring
   and one ingest launch as recorded at capture, with no host wait in
   the graph and one at the run's end (``peers.host_waits``); the
   one-process captured run bitwise its eager step. Timed (the card's
   name and power limit beside): the hop's
   launch alone, L2 warm and flushed, and its parts (the copy alone, the
   copy with the post, waits and publication, those alone: profiler
   device time, the other process idle), ``Tensor.copy_`` into the
   peer's arena warm and flushed, the hop with its semaphores and a
   16-byte hop (CUDA events), the captured run across the processes
   against the eager step and the one-process captured run against its
   eager step (medians of 12). Then a second launch: after one hop and
   two replays of a small captured run across the processes, process 1
   leaves, and process 0's next replay must raise at its 2 s cap, then
   its next hop over the other ring too. A process that fails or
   outlives the launch's timeout fails the smoke.
   Then every job directory the smoke wrote (``phase_check_jobs``)
   through the port's whole ``check_job`` (the reference's
   ``check_job_detail`` for the files the port writes), its count
   printed; a ``seconds`` line gives the lint, witness and check phases'
   seconds.
   Every run: each ``R2P1DRunner`` forward in the window is one replay
   of a captured CUDA graph (``Graphs:`` replays == ``Compiles:``
   steady calls, or requests for the single step), no signature is new
   in the window (``steady_new`` 0), each captured graph of every
   runner replays bitwise its eager forward on a seeded input (the
   graphs' capture seconds printed), and every y4m request was decoded
   by the native pool (``Decode backend: native``).

The dataset lives under ``data/smoke`` in the checkout (cleared before
the run, removed after it): its relative paths seed the sampler, so
every smoke serves the same clip mix. The line before the last is
``nvidia-smi``'s name and power limit; the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PAGED = "configs/rnb-fused-yuv-paged-zipf.json"
BLOB = "configs/rnb-fused-yuv-zipf-cache.json"
WHOLE = "configs/r2p1d-whole.json"
WHOLE_YUV = "configs/r2p1d-whole-yuv.json"
SPLIT = "configs/r2p1d-split-1chip.json"
RNB = "configs/rnb-1chip.json"
NOPIPELINE = "configs/r2p1d-nopipeline-1chip.json"
TORCHCKPT = "configs/rnb-fused-yuv-big-torchckpt.json"
MID = "configs/rnb-fused-yuv-mid.json"
SEGMENT = "configs/r2p1d-segment.json"
TRACED = "configs/rnb-fused-yuv-traced.json"
METRICS = "configs/rnb-fused-yuv-metrics.json"
AUTOTUNE = "configs/rnb-fused-yuv-autotune.json"
#: the autotune config again, under Poisson arrivals
AUTOTUNE_POISSON = "rnb-fused-yuv-autotune-poisson"
#: the traced config with the root ``critpath`` key, written next to the
#: dataset
CRITPATH = "rnb-fused-yuv-traced-critpath"
#: the runs of the metrics, autotune and critpath planes
PLANES = (METRICS, AUTOTUNE, AUTOTUNE_POISSON, CRITPATH)
DEVOBS = "configs/rnb-fused-yuv-devobs.json"
#: the devobs config with a 1 MiB watermark, written next to the dataset:
#: the ledger crosses it at its first sample
DEVOBS_WATERMARK = "rnb-fused-yuv-devobs-watermark"
DEVOBS_RUNS = (DEVOBS, DEVOBS_WATERMARK)
#: the yuv420 kernel's symbol, as the profiler names the kernel
YUV420_SYMBOL = "yuv420_kernel"
STAGED = "configs/rnb-fused-yuv-staged.json"
#: the staged cell's chaos copy (rnb_tpu_torch/tools/chaos.py), written
#: next to the dataset: in bulk, then as a burst (a Poisson mean of 1 ms
#: into queues 4 deep, so the client sheds); served after the planes
CHAOS = "rnb-fused-yuv-staged-chaos"
#: the burst's own copy: the same faults, both stalls on the client's
#: first request (chaos.BURST_STALL_ID), which is always admitted
CHAOS_BURST = "rnb-fused-yuv-staged-chaos-burst"
CHAOS_RUNS = (CHAOS, CHAOS_BURST)
BURST_QUEUE = 4
OPERATOR = "configs/rnb-fused-yuv-operator.json"
#: the operator config with actions allowed, a devobs key and the root
#: whatif key, written next to the dataset
OPERATOR_ACTIONS = "rnb-fused-yuv-operator-actions"
OPERATOR_RUNS = (OPERATOR, OPERATOR_ACTIONS)
#: the devobs key of the actions copy: the shipped devobs cell's
OPERATOR_DEVOBS = {"enabled": True, "watermark_mb": 256}
#: seconds the operator scraper waits for the run's address and window
SCRAPER_WAIT_S = 900
#: the dataset's root, relative to the checkout and cleared before each
#: run: the sampler draws a video's clip count from a CRC of its path,
#: so a fixed relative path serves the same clip mix in every run and
#: checkout
SMOKE_ROOT = os.path.join("data", "smoke")
TINY_SHED = "configs/r2p1d-tiny-shed.json"
#: the shipped tiny-shed config with its devices 0 and 1 made 0, served
#: last
TINY_SHED_COPY = "r2p1d-tiny-shed-1card"
SHARD_D1 = "configs/rnb-shard-d1.json"
SHARD_D2 = "configs/rnb-shard-d2.json"
#: the intra-stage sharding pair with every device index made 0: the
#: degree-2 ring's two members share the card; served before devobs
SHARD_D1_COPY = "rnb-shard-d1-1card"
SHARD_D2_COPY = "rnb-shard-d2-1card"
SHARD_RUNS = (SHARD_D1_COPY, SHARD_D2_COPY)
#: the d1 copy with an HBM budget between the port's degree-2 and
#: degree-1 projections: its launch is refused
SHARD_BUDGET_COPY = "rnb-shard-d1-1card-budget"
#: the sharded leaves of R(2+1)D-18: 17 temporal conv kernels and the
#: head's weight and bias, gathered together at the start of a forward
SHARD_LEAVES = 19
#: launches of that gather at degree 2: own slots and the one hop of all
#: 19 leaves ride one table (degree - 1 in general)
GATHER_LAUNCHES = 1
#: the ring shift's timed shapes: the conv5 temporal kernel's shard at
#: degree 2 (the largest leaf) and a merge block at 15 rows
RING_TIMED_DEGREE = 2
MERGE_BLOCK = (15, 200)
#: the network ingest edge's cells: the in-process twin and the loopback
#: cell as shipped (the peer a second process on the card), and the chaos
#: config with its device 1 made 0; all over synth:// ids (the dct wire;
#: the chaos config's rgb loader too), served last
NETEDGE_OFF = "configs/rnb-netedge-off.json"
NETEDGE_LOOPBACK = "configs/rnb-netedge-loopback.json"
NETEDGE_CHAOS_CONFIG = "configs/rnb-netedge-chaos.json"
NETEDGE_CHAOS = "rnb-netedge-chaos-1card"
NETEDGE_RUNS = (NETEDGE_OFF, NETEDGE_LOOPBACK, NETEDGE_CHAOS)
#: requests of the two shipped cells, each in bulk
NETEDGE_VIDEOS = 300
#: the chaos copy as scripts/netchaos_demo.py drives it: 30 requests at a
#: 200 ms Poisson mean (its acts need paced arrivals) into 64-deep queues,
#: seed 17
NETCHAOS_VIDEOS = 30
NETCHAOS_QUEUE = 64
NETCHAOS_SEED = 17
#: one packed dct frame at the default budget: a DATA frame of the
#: loopback cell carries whole ones
DCT_FRAME_BYTES = 9408
#: the loopback requests whose DATA rows are held to the in-process
#: loader's emission: every 50th
WIRE_SAMPLE_EVERY = 50
#: mean Poisson gap of the open-loop runs that are not Zipf cells
PLANE_INTERVAL_MS = {METRICS: 20, AUTOTUNE_POISSON: 25, CHAOS_BURST: 1,
                     OPERATOR_ACTIONS: 20, NETEDGE_CHAOS: 200}
#: the buckets the autotune config warms: the only ones it may choose
AUTOTUNE_BUCKETS = {"6", "15"}
CONFIGS = ("configs/rnb-fused-yuv-big.json",
           "configs/rnb-fused-yuv-ragged.json",
           "configs/rnb-fused-dct-ragged.json", PAGED, BLOB,
           WHOLE, WHOLE_YUV, SPLIT, RNB, NOPIPELINE, TORCHCKPT, MID)
#: the paged cell with feature pages off, written next to the dataset
FEATURES_OFF = "paged-zipf-features-off"
#: the unfused whole pipeline under the root ``ragged`` key, likewise
WHOLE_RAGGED = "r2p1d-whole-ragged"
#: the segment topology with every device on cuda:0, likewise
SEGMENT_COPY = "r2p1d-segment-1card"
#: segments a request of the segment copy is split into
SEGMENTS = 3
#: the share of the segment copy's requests that may be near ties (a
#: top-2 gap of the whole run's summed logits inside the margin, down to
#: exact ties of its bf16 sums) serving another class id than the whole
#: run; every request's sums are held element by element all the same
NEAR_TIE_SHARE = 0.1
#: a yuv420 emission launches the fused ingest once, and no other ingest
YUV_KERNELS = {"yuv420_normalize"}
#: the ingest kernel each bulk run launches once per emission
ONE_PER_EMISSION = {"configs/rnb-fused-yuv-big.json": "yuv420_normalize",
                    "configs/rnb-fused-yuv-ragged.json": "yuv420_normalize",
                    "configs/rnb-fused-dct-ragged.json": "dct_ingest",
                    WHOLE_YUV: "yuv420_normalize",
                    TORCHCKPT: "yuv420_normalize",
                    MID: "yuv420_normalize",
                    TRACED: "yuv420_normalize",
                    TINY_SHED_COPY: "normalize_u8",
                    NETEDGE_OFF: "dct_ingest", NETEDGE_LOOPBACK: "dct_ingest",
                    **{label: "yuv420_normalize"
                       for label in PLANES + CHAOS_RUNS + DEVOBS_RUNS
                       + SHARD_RUNS + OPERATOR_RUNS}}
#: the kernels each run launches, and no others
PATH_KERNELS = {CONFIGS[0]: YUV_KERNELS, CONFIGS[1]: YUV_KERNELS,
                CONFIGS[2]: {"dct_ingest"},
                PAGED: YUV_KERNELS | {"gather_rows"},
                FEATURES_OFF: YUV_KERNELS | {"gather_rows"},
                BLOB: YUV_KERNELS,
                WHOLE: {"normalize_u8"},
                WHOLE_RAGGED: {"ragged_normalize_u8"},
                WHOLE_YUV: YUV_KERNELS, SPLIT: {"normalize_u8"},
                RNB: {"normalize_u8"}, NOPIPELINE: {"normalize_u8"},
                TORCHCKPT: YUV_KERNELS, MID: YUV_KERNELS,
                SEGMENT_COPY: {"normalize_u8"}, TRACED: YUV_KERNELS,
                TINY_SHED_COPY: {"normalize_u8"},
                SHARD_D1_COPY: YUV_KERNELS,
                SHARD_D2_COPY: YUV_KERNELS | {"ring_shift"},
                NETEDGE_OFF: {"dct_ingest"}, NETEDGE_LOOPBACK: {"dct_ingest"},
                NETEDGE_CHAOS: {"normalize_u8"},
                **{label: YUV_KERNELS
                   for label in PLANES + CHAOS_RUNS + DEVOBS_RUNS
                   + OPERATOR_RUNS}}
#: the runs of the unfused multi-step pipeline, in serving order
UNFUSED = (WHOLE, WHOLE_RAGGED, WHOLE_YUV, SPLIT, RNB, NOPIPELINE)
#: the runs whose logits check_unfused_run holds to the two-step run's
TWO_STEP_HELD = (WHOLE_RAGGED, SPLIT, RNB)
#: the fused loader of rnb-1chip's small lane fuses this many requests
RNB_BATCH = 6
#: mean Poisson gap of the Zipf runs: repeats then arrive after their
#: video's first forward stored its logits (in bulk the loader admits
#: every request before the first forward ends)
ZIPF_INTERVAL_MS = 25
#: the witness-armed copies (``phase_witness``), written beside the
#: dataset: the big config, the r4 lane copy, and the paged cell, whose
#: hits pin pages under the cache's lock (the one nesting of witnessed
#: locks the port has)
ARMED_BIG = "rnb-fused-yuv-big-armed"
ARMED_R4 = "rnb-scaleout-r4-1card-armed"
ARMED_PAGED = "paged-zipf-armed"
#: the unarmed runs' outputs the armed ones are held to, by label
UNARMED_SINKS = {}
#: the unarmed runs' videos/s, by label
UNARMED_VPS = {}
HW = 112
FRAMES = 8
#: a geometry whose width is not a multiple of 16: the yuv420 kernel's
#: scalar path
ODD_GEOMETRY = (66, 90)
#: a second dct geometry: wider than 128, so the convert's load phase
#: takes two rounds
DCT_GEOMETRY = (64, 176)
#: requests served per config on the path phase
VIDEOS_PER_RUN = 32
#: the replica lanes: one-card copies of the three scale-out configs,
#: at scripts/multichip_demo.py's and scripts/chaos_demo.py's workload
#: (bulk, 12 requests, seed 17, 64-deep queues)
SCALEOUT_R1 = "configs/rnb-scaleout-r1.json"
SCALEOUT_R4 = "configs/rnb-scaleout-r4.json"
SCALEOUT_CHAOS = "configs/rnb-scaleout-r4-chaos.json"
LANES_R1 = "rnb-scaleout-r1-1card"
LANES_R4 = "rnb-scaleout-r4-1card"
LANES_CHAOS = "rnb-scaleout-r4-chaos-1card"
#: the chaos copy again, at as many requests as outlast lane 3's 2.5 s
#: wedge: at 12 the hedges on the three live lanes finish the run
#: before the wedge ends, so the dead lane's drain never runs (the
#: reference's own scripts/chaos_demo.py does the same on a fast host)
LANES_CHAOS_DRAIN = "rnb-scaleout-r4-chaos-1card-drain"
#: the r4 copy again with ``async_dispatch`` on its loader step: the
#: lanes' streams are ordered behind the loader's unwaited work, and
#: every request's logits are bitwise the r4 copy's
LANES_R4_ASYNC = "rnb-scaleout-r4-1card-async"
LANES_VIDEOS = 12
LANES_DRAIN_VIDEOS = 48
LANES_QUEUE = 64
LANES_SEED = 17
#: scripts/multichip_demo.py's floor on r4's videos/s over r1's
LANES_MIN_SPEEDUP = 2.5
#: the lane the chaos plan wedges and kills (its queue index)
LANES_DEAD_LANE = "3"
#: bench_cuda.py as a phase: its requests (RNB_BENCH_VIDEOS)
BENCH_CUDA_VIDEOS = 300
#: the measurement tools as a phase (phase_tools): the matrix's and the
#: frontier's cells, each a fresh bench_cuda.py process over
#: bench_cuda.py's dataset, at 200 requests (checks, not cells)
TOOLS_VIDEOS = 200
TOOLS_MI = 6
MATRIX_CELLS = {"rnb-fused-yuv-big@0": "yuv420_normalize",
                "rnb-fused-yuv-big@%d" % TOOLS_MI: "yuv420_normalize",
                "r2p1d-whole@0": "normalize_u8"}
FRONTIER_CELLS = ("rnb-fused-yuv-mid@4", "rnb-fused-yuv-mid@9")
TOOLS_TIMEOUT_S = 600
#: the explanation plane's legs (phase_explain): job directories other
#: phases served, by label
EXPLAIN_JOBS = {}
#: the MJPEG phase: videos a tree, and each run's (label, config, tree);
#: the trees' qualities are rnb_tpu_torch.dataset's. The last run is a
#: copy of the first with ``async_dispatch`` on its loader step
MJPEG_TREE_VIDEOS = 16
MJPEG_BIG_ASYNC = "rnb-fused-yuv-big-mjpeg-async"
MJPEG_RUNS = (("rnb-fused-yuv-big-mjpeg", "configs/rnb-fused-yuv-big.json",
               "mjpeg"),
              ("rnb-fused-dct-ragged-mjpeg",
               "configs/rnb-fused-dct-ragged.json", "mjpeg-dct"),
              ("r2p1d-whole-mjpeg", WHOLE, "mjpeg"),
              (MJPEG_BIG_ASYNC, "configs/rnb-fused-yuv-big.json", "mjpeg"))
#: videos of the dct tree whose native coefficient rows are held to the
#: pure-Python decoder's and the encoder's
MJPEG_DCT_SAMPLES = 2
#: MiB the busy-card probe's child process holds on the card
BUSY_CHILD_MIB = 64
#: the clip-sharded mesh configs (``phase_mesh``), served as one-card
#: copies (``mesh_devices`` made 0 too): 33 requests, so ``flush`` pads
#: the dp axis of the last dispatch with a zero video, and 32
MESH = "configs/r2p1d-mesh.json"
MESH_YUV = "configs/r2p1d-mesh-yuv.json"
MESH_RUNS = (("r2p1d-mesh-1card", MESH, 33),
             ("r2p1d-mesh-yuv-1card", MESH_YUV, 32))
#: their shipped geometry: dp 2 over 8 members, so sp 4 pads 15 clips
#: to 16 inside the step
MESH_DP = 2
MESH_MAX_CLIPS = 15
MESH_PADDED_CLIPS = 16
#: the ingest kernel of each pixel path (the mesh stage's inside its
#: captured step)
INGEST_KERNELS = {"rgb": "normalize_u8", "yuv420": "yuv420_normalize"}
#: the shipped configs served in a phase of their own (``phase_configs``):
#: (label, config). The three single-card configs serve as shipped (their
#: label is the config); the others name more cards, and serve as
#: one-card copies (every device index >= 0 made 0, written beside the
#: dataset under their label)
CONFIG_RUNS = (
    ("configs/rnb-fused-yuv.json", "configs/rnb-fused-yuv.json"),
    ("configs/rnb-1chip-yuv.json", "configs/rnb-1chip-yuv.json"),
    ("configs/rnb-fused-yuv-xl.json", "configs/rnb-fused-yuv-xl.json"),
    ("r2p1d-tiny-1card", "configs/r2p1d-tiny.json"),
    ("r2p1d-split-1card", "configs/r2p1d-split.json"),
    ("baseline-1card", "configs/baseline.json"),
    ("r2p1d-aggressive-global-1card", "configs/r2p1d-aggressive-global.json"),
    ("r2p1d-aggressive-1card", "configs/r2p1d-aggressive.json"),
    ("r2p1d-aggressive-four-groups-1card",
     "configs/r2p1d-aggressive-four-groups.json"),
    ("r2p1d-nopipeline-1card", "configs/r2p1d-nopipeline.json"),
    ("rnb-1card", "configs/rnb.json"))
#: requests of each of them, in bulk
CONFIG_VIDEOS = 16
#: the runs whose ingest launches once an emission (each fused loader
#: emission, or each loader emission a runner takes whole); the Batcher
#: configs normalize in the loader and emit again in the Batcher
CONFIG_ONE_PER_EMISSION = tuple(
    label for label, config in CONFIG_RUNS
    if config not in ("configs/rnb-1chip-yuv.json", "configs/rnb.json"))
#: phase_parallel: the full-width ShardedInference's mesh, its videos'
#: valid clips, and its bound against the unsharded forward (the JAX
#: package's sharded bound, tests/test_parallel.py)
PARALLEL_AXES = {"dp": 2, "sp": 4}
PARALLEL_VALID = [15, 7, 1, 12]
PARALLEL_TOL = 2e-2
#: the dry runs' member counts, and the kernels their paths launch (the
#: rgb sharded step; the yuv420 pipeline run from 4 members)
#: the launch of two processes on the card (phase_processes): its
#: processes, the seconds a launch may take, its videos' valid clips, the
#: wait cap of the killed-peer launch, the timed reps
PROCESSES = 2
PROCESS_TIMEOUT_S = 300
PROCESS_VALID = [15, 9]
PROCESS_KILL_CAP_S = 2.0
PROCESS_REPS = 20
#: ring_shift launches of the launch's main path, each process: the conv5
#: hop, the 19-leaf gather, the reduce-scatter, then the gathers of the
#: partials in run's capture warm-up, its replay and predict's replay,
#: each at degree 2 one hop, and a hop one launch of rnb_ring_hop (its
#: results in the arena: no placement launch); and its ingest launches,
#: the same three of run and predict
PROCESS_RING_LAUNCHES = 6
PROCESS_INGEST_LAUNCHES = 3
#: replays of the captured run across processes, each held to the eager
#: step_across; the runs a median of run times takes
PROCESS_REPLAYS = 8
RUN_REPS = 12
DRYRUN_MEMBERS = (8, 2)
DRYRUN_KERNELS = {"normalize_u8", "yuv420_normalize"}
#: the checkpoint phase (``phase_ckpt``): the copies of
#: ``rnb_tpu_torch/tools/synth_ckpt.py`` served from the file it
#: converts, each with its requests, the kernel its path launches and
#: its runner steps; and a copy naming a file that is not there
CKPT_RUNS = (("rnb-fused-yuv-big-torchckpt-file", 64, "yuv420_normalize",
              1),
             ("r2p1d-split-1chip-file", 16, "normalize_u8", 2))
CKPT_MISSING = "rnb-fused-yuv-big-torchckpt-missing"
CKPT_MISSING_VIDEOS = 8
#: the floating-point values of a full-width R(2+1)D-18 state dict in
#: the reference's format (400 classes)
CKPT_VALUES = 33410197
#: requests of the configs added last (the segment copy serves the
#: whole run's requests, which it is held to)
#: the burst's target outlasts what is shed during its stalls
#: (chaos.BURST_MIN_TARGET); the operator config as shipped
#: serves long enough in bulk for the scraper's requests and a few
#: flusher ticks to fall inside the window (64 requests take about a
#: third of a second, near the 250 ms metrics interval)
FEW_VIDEOS = {TORCHCKPT: 12, MID: 12, TRACED: 12, CRITPATH: 12,
              CHAOS: 64, CHAOS_BURST: 3000, DEVOBS: 64,
              DEVOBS_WATERMARK: 32, SHARD_D1_COPY: 64, SHARD_D2_COPY: 64,
              OPERATOR: 400, OPERATOR_ACTIONS: 32,
              NETEDGE_OFF: NETEDGE_VIDEOS, NETEDGE_LOOPBACK: NETEDGE_VIDEOS,
              NETEDGE_CHAOS: NETCHAOS_VIDEOS}
#: every shipped config a run of the smoke serves, as shipped or as the
#: source of a copy (a one-card copy, the chaos copies of the staged
#: cell, the checkpoint copies of torchckpt and split-1chip)
SERVED_CONFIGS = tuple(dict.fromkeys(
    CONFIGS + (SEGMENT, TRACED, METRICS, AUTOTUNE, STAGED, TINY_SHED,
               SHARD_D1, SHARD_D2, DEVOBS, OPERATOR, NETEDGE_OFF,
               NETEDGE_LOOPBACK, NETEDGE_CHAOS_CONFIG, SCALEOUT_R1,
               SCALEOUT_R4, SCALEOUT_CHAOS, MESH, MESH_YUV)
    + tuple(config for _, config in CONFIG_RUNS)))
#: a captured graph against its eager forward where the two are not
#: bitwise (a capture that changed the library's kernel choice): the
#: float32 network's bound of tests/test_torch_network.py, relative to
#: the output's scale, and equal argmax of the logits
GRAPH_RTOL = 5e-4
#: another topology's logits against the two-step run's for the same
#: request: the same bf16 network at other batch shapes (row tiles, fused
#: batches) or cut at a float32 feature map, so equal up to the
#: convolution algorithm the library picks per shape; each run is held
#: to float32 within about BF16_ATOL by its recompute, two runs to twice
#: that
TWO_STEP_ATOL = 2e-2
#: the single step's class id against the two-step run's logits: it may
#: differ only where the top-2 margin of the summed clip logits is within
#: this much per clip, twice over (twice the largest difference between
#: two topologies' logits that the smoke has shown, 0.002)
CLASS_ID_ATOL = 4e-3
#: bytes written between calls for the L2-flushed times: five times the
#: H100's 50 MB L2
FLUSH_BYTES = 256 << 20
#: profiler sessions tried before CUDA events time a call instead
PROFILER_TRIES = 3
#: the spin that holds the card while the host queues timed calls counts
#: SM cycles; the H100's highest clock is 1.98 GHz, so a lower clock only
#: makes it longer. Each retry doubles it.
SPIN_CYCLES_PER_S = 2e9
SPIN_TRIES = 4
#: published H100 SXM peaks (NVIDIA data sheet) for the bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: the dct convert vs its plain version, in u8 steps: one per quantized
#: plane where two float32 IDCT summation orders flip floor(p + 128.5),
#: which BT.601 carries into R or B as up to two; and the least share
#: of outputs that must be exact
DCT_STEPS = 2
DCT_EXACT_SHARE = 0.99
#: card vs CPU float32 network on the same input: accumulation order
#: only (TF32 off)
F32_ATOL = 1e-3
#: served bf16 logits vs the CPU float32 truth: at most BF16_FACTOR x
#: the CPU's own bf16 error, plus BF16_ATOL (see cpu_recompute)
BF16_FACTOR = 2.0
BF16_ATOL = 1e-2


#: timing keys a kernel's row carries into the ``kernels`` line where
#: its phase measured them
EXTRA_ROW_KEYS = ("all_hit_ms", "all_hit_ms_l2_flushed",
                  "library_ms_l2_flushed", "tiny_rows_ms",
                  "tiny_rows_ms_l2_flushed", "ms_48", "ms_48_l2_flushed",
                  "bound_ms_48", "merge_ms", "merge_ms_l2_flushed",
                  "merge_plain_ms", "merge_bound_ms", "merge_library_ms",
                  "gather_ms", "gather_ms_l2_flushed", "gather_plain_ms",
                  "gather_bound_ms", "gather_library_ms",
                  "forward_gather_ms", "forward_gather_ms_l2_flushed",
                  "forward_gather_plain_ms", "forward_gather_bound_ms",
                  "forward_per_leaf_ms", "merge_host_us", "xproc_ms",
                  "xproc_ms_l2_flushed", "xproc_copy_ms", "xproc_sync_ms",
                  "xproc_copy_sync_ms", "xproc_round_trip_ms",
                  "xproc_tiny_round_trip_ms", "xproc_library_ms",
                  "xproc_library_ms_l2_flushed", "xproc_bound_ms",
                  "xproc_run_ms", "xproc_eager_run_ms", "xproc_launches",
                  "xproc_kill_s")


class SmokeFailure(RuntimeError):
    pass


def check(condition, message):
    if not condition:
        raise SmokeFailure(message)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, "nvidia-smi failed: %s" % out.stderr)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, reps: int = 50, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after a warm-up. A call that is shorter on
    the card than its launch on the host measures the launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    samples.sort()
    return samples[len(samples) // 2]


def median_ms(fn, reps: int):
    """(median, min, max) ms of ``reps`` calls, each between two CUDA
    events and waited for (the host's wait ends each sample), after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    samples.sort()
    return samples[len(samples) // 2], samples[0], samples[-1]


def profiled(calls, reps: int):
    """``{event name: device us}`` of the device events the profiler
    records while ``calls()`` runs ``reps`` calls and the card is
    synchronized, or None where no session of PROFILER_TRIES came back
    whole: with events, each a multiple of ``reps`` times (a session may
    come back with none, one or two seconds after one that had them)."""
    import torch
    for _ in range(PROFILER_TRIES):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            calls()
            torch.cuda.synchronize()
        # device-side events only: an operator's own event repeats the
        # time of the kernels it launched
        events = [e for e in prof.key_averages()
                  if e.device_type != torch.autograd.DeviceType.CPU]
        if events and all(e.count % reps == 0 for e in events):
            return {e.key: e.self_device_time_total for e in events}
    return None


def device_ms(fn, reps: int = 50) -> float:
    """Time on the card per call, L2 warm: the device time of every
    kernel the profiler records over ``reps`` back-to-back calls, after a
    warm-up, over ``reps``. An input under 50 MB stays in L2. Where the
    profiler records no whole session, CUDA events time the calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = profiled(lambda: [fn() for _ in range(reps)], reps)
    if times is not None:
        return sum(times.values()) / reps / 1e3
    print("note: no profiler session timed the calls whole; CUDA events "
          "time the next row's warm call")
    return events_ms(fn, reps)


def flushed_ms(fn, reps: int = 50) -> float:
    """Time on the card per call with L2 flushed before each call, as a
    serving pool finds it after its copy from the host: FLUSH_BYTES are
    written between calls, and only the device events named as those of
    the calls alone are summed, so the flush's own kernel is not. Where
    the profiler records no whole session, CUDA events time the calls."""
    import torch
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    own = profiled(lambda: [fn() for _ in range(reps)], reps)
    theirs = profiled(lambda: [flush.zero_() for _ in range(reps)], reps)

    def calls():
        for _ in range(reps):
            flush.zero_()
            fn()
    if own is not None and theirs is not None and not own.keys() & theirs:
        both = profiled(calls, reps)
        if both is not None and own.keys() <= both.keys():
            return sum(both[name] for name in own) / reps / 1e3
    print("note: no profiler session timed the calls whole; CUDA events "
          "time the next row's L2-flushed call")
    return events_ms(fn, reps, flush=flush)


def events_ms(fn, reps: int, flush=None) -> float:
    """Time on the card per call: the mean of CUDA event pairs around each
    of ``reps`` calls, after a warm-up, the calls queued behind a spin on
    the card that outlasts the host's queueing of them, so a pair times
    the card's work and not the host's launches; it also holds the gaps
    between the pair and the call's launches (2-4 us more than the
    profiler's time of a 2-17 us kernel on the H100). ``flush``, a
    tensor, is written before each call and outside its pair."""
    import time
    import torch
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]

    def queue():
        for start, end in pairs:
            if flush is not None:
                flush.zero_()
            start.record()
            fn()
            end.record()
    fn()
    torch.cuda.synchronize()
    begin = time.perf_counter()
    queue()
    host_s = time.perf_counter() - begin
    torch.cuda.synchronize()
    for _ in range(SPIN_TRIES):
        torch.cuda._sleep(int(2 * host_s * SPIN_CYCLES_PER_S))
        spun = torch.cuda.Event()
        spun.record()
        queue()
        # the spin still runs: every call was queued before the card
        # reached it
        ahead = not spun.query()
        torch.cuda.synchronize()
        if ahead:
            break
        host_s *= 2
    else:
        print("note: the host fell behind the card while it queued the "
              "calls (a call that waits for the card); their time "
              "includes the host's")
    return sum(start.elapsed_time(end) for start, end in pairs) / reps


def phase_kernels(device):
    """The yuv420 kernel's two entries and the bucketed normalize against
    their plain versions; returns the timing rows at the 48-row serving
    shape and the worst errors."""
    import torch
    from rnb_tpu_torch.ops import _kernels, preprocess, yuv
    packed_bytes = yuv.packed_frame_bytes(HW, HW)
    gen = torch.Generator().manual_seed(1234)
    worst = {"yuv420_to_rgb_u8": 0, "yuv420_normalize": 0.0,
             "normalize_u8": 0}
    # one device scalar, rewritten between launches whose arguments stay
    # the same
    scalar = torch.zeros((1,), dtype=torch.int32, device=device)
    for rows in (48, 15):
        packed = torch.randint(0, 256, (rows, FRAMES, packed_bytes),
                               generator=gen, dtype=torch.uint8)
        packed = packed.to(device)
        zero_rgb = yuv.yuv420_to_rgb_reference(
            torch.zeros((1, FRAMES, packed_bytes), dtype=torch.uint8,
                        device=device), HW, HW)
        before = (_kernels.YUV420_TO_RGB_U8.launches,
                  _kernels.YUV420_NORMALIZE.launches)
        for valid in (rows, 5, 0):
            scalar.fill_(valid)
            masked = packed.clone()
            masked[valid:] = 0
            rgb = yuv.yuv420_to_rgb_u8(packed, HW, HW, scalar)
            plain_rgb = yuv.yuv420_to_rgb_reference(masked, HW, HW)
            diff = (rgb.int() - plain_rgb.int()).abs()
            err = int(diff.max())
            exact = float((diff == 0).double().mean())
            worst["yuv420_to_rgb_u8"] = max(worst["yuv420_to_rgb_u8"], err)
            check(err <= 1, "yuv420_to_rgb_u8 rows=%d valid=%d differs "
                  "from its plain version by %d u8 steps" % (rows, valid,
                                                            err))
            pads_exact = bool((rgb[valid:] == zero_rgb).all())
            check(pads_exact, "yuv420_to_rgb_u8 rows=%d valid=%d: pad rows "
                  "are not the conversion of zero bytes" % (rows, valid))
            check(torch.equal(yuv.yuv420_to_rgb_u8(packed, HW, HW, valid),
                              rgb),
                  "yuv420_to_rgb_u8 rows=%d valid=%d: the int form differs "
                  "from the device scalar's" % (rows, valid))
            # the fused entry, bitwise the normalize kernel of the u8
            # entry's output (every row: pads are converted zero bytes)
            fused = yuv.yuv420_normalize(packed, HW, HW, scalar)
            two = preprocess.normalize_u8(rgb)
            fused_bitwise = torch.equal(fused.view(torch.int16),
                                        two.view(torch.int16))
            check(fused_bitwise, "yuv420_normalize rows=%d valid=%d is not "
                  "bitwise normalize_u8 of yuv420_to_rgb_u8" % (rows, valid))
            fused32 = yuv.yuv420_normalize(packed, HW, HW, scalar,
                                           torch.float32)
            check(torch.equal(fused32, preprocess.normalize_u8_reference(
                rgb, torch.float32)), "yuv420_normalize rows=%d valid=%d: "
                  "float32 out is not the normalize of the u8 entry's"
                  % (rows, valid))
            worst["yuv420_normalize"] = max(
                worst["yuv420_normalize"],
                float((fused.float() - preprocess.normalize_u8_reference(
                    plain_rgb).float()).abs().max()))
            out = preprocess.normalize_u8_rows(rgb, valid)
            plain = preprocess.normalize_u8_reference(rgb)
            plain[valid:] = 0
            bitwise = torch.equal(out.view(torch.int16),
                                  plain.view(torch.int16))
            worst["normalize_u8"] = max(
                worst["normalize_u8"],
                float((out.float() - plain.float()).abs().max()))
            check(bitwise, "normalize_u8 rows=%d valid=%d is not bitwise "
                  "equal to its plain version" % (rows, valid))
            print("kernels rows=%d rows_valid=%d (device scalar): "
                  "yuv420_to_rgb_u8 max err %d (exact share %.6f, pad rows "
                  "exact %s); yuv420_normalize bitwise normalize_u8 of it "
                  "%s (bf16 and f32); normalize_u8 bitwise %s"
                  % (rows, valid, err, exact, pads_exact, fused_bitwise,
                     bitwise))
        check((_kernels.YUV420_TO_RGB_U8.launches - before[0],
               _kernels.YUV420_NORMALIZE.launches - before[1]) == (6, 6),
              "the yuv420 entries did not count one launch per call")
    # a width that is not a multiple of 16: the scalar path
    height, width = ODD_GEOMETRY
    packed = torch.randint(0, 256, (15, FRAMES, yuv.packed_frame_bytes(
        height, width)), generator=gen, dtype=torch.uint8).to(device)
    for valid in (15, 5):
        scalar.fill_(valid)
        masked = packed.clone()
        masked[valid:] = 0
        rgb = yuv.yuv420_to_rgb_u8(packed, height, width, scalar)
        plain_rgb = yuv.yuv420_to_rgb_reference(masked, height, width)
        err = int((rgb.int() - plain_rgb.int()).abs().max())
        check(err <= 1 and torch.equal(rgb[valid:], plain_rgb[valid:]),
              "yuv420_to_rgb_u8 at %dx%d valid=%d: %d u8 steps from its "
              "plain version or pad rows not exact" % (height, width, valid,
                                                       err))
        fused = yuv.yuv420_normalize(packed, height, width, scalar)
        check(torch.equal(fused.view(torch.int16),
                          preprocess.normalize_u8_reference(rgb)
                          .view(torch.int16)),
              "yuv420_normalize at %dx%d valid=%d is not bitwise the "
              "normalize of the u8 entry's output" % (height, width, valid))
        print("kernels %dx%d (scalar path) rows_valid=%d: yuv420_to_rgb_u8 "
              "max err %d, pad rows exact; yuv420_normalize bitwise the "
              "normalize of it" % (height, width, valid, err))
    torch.cuda.synchronize()

    rows = 48
    packed = torch.randint(0, 256, (rows, FRAMES, packed_bytes),
                           generator=gen, dtype=torch.uint8).to(device)
    rgb = yuv.yuv420_to_rgb_u8(packed, HW, HW)
    in_k2, out_k2 = packed.numel(), rgb.numel()
    calls = {
        "yuv420_to_rgb_u8": (
            lambda: yuv.yuv420_to_rgb_u8(packed, HW, HW),
            lambda: yuv.yuv420_to_rgb_reference(packed, HW, HW)),
        "yuv420_normalize": (
            lambda: yuv.yuv420_normalize(packed, HW, HW),
            lambda: preprocess.normalize_u8_reference(
                yuv.yuv420_to_rgb_reference(packed, HW, HW))),
        "normalize_u8": (
            lambda: preprocess.normalize_u8(rgb),
            lambda: preprocess.normalize_u8_reference(rgb)),
    }
    # per pixel: 4 adds/subs; per 2x2 quad: 2 subs + 4 muls
    yuv_ops = 4 * out_k2 // 3 + 6 * out_k2 // 12
    timings = {
        "yuv420_to_rgb_u8": dict(bound_bytes=in_k2 + out_k2,
                                 bound_ops=yuv_ops),
        # packed planes in, bf16 out; the conversion plus mul, sub, mul
        # per element
        "yuv420_normalize": dict(bound_bytes=in_k2 + 2 * out_k2,
                                 bound_ops=yuv_ops + 3 * out_k2),
        "normalize_u8": dict(
            bound_bytes=rgb.numel() * 3,  # 1 byte in, 2 bytes out
            bound_ops=3 * rgb.numel()),   # mul, sub, mul per element
    }
    for name, row in timings.items():
        time_kernel(name, row, rows, *calls[name])
    row = timings["yuv420_normalize"]
    def two():
        return preprocess.normalize_u8(yuv.yuv420_to_rgb_u8(packed, HW, HW))
    row["two_launch_ms"] = device_ms(two)
    row["two_launch_ms_l2_flushed"] = flushed_ms(two)
    print("timing yuv420_normalize at %d rows: %.5f ms (L2 flushed %.5f ms) "
          "for the work of yuv420_to_rgb_u8 + normalize_u8, which take "
          "%.5f ms (L2 flushed %.5f ms) as two launches (bound %.5f ms)"
          % (rows, row["ms"], row["ms_l2_flushed"], row["two_launch_ms"],
             row["two_launch_ms_l2_flushed"], row["bound_ms"]))
    return timings, worst


def stack_frame_bytes(log, kernel):
    """The stack frame ``ptxas -v`` reports in ``log`` for the kernel
    whose mangled name holds ``kernel``, or None."""
    import re
    match = re.search(r"Function properties for \S*%s\S*\s+(\d+) bytes "
                      r"stack frame" % kernel, log)
    return None if match is None else int(match.group(1))


def bound(bound_bytes, bound_ops):
    """(ms, "bytes" or "operations"): the least time the card could
    take, from the bytes moved and the operations done."""
    by_bytes = bound_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = bound_ops / PEAK_F32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def time_kernel(name, row, rows, kernel, plain):
    """Fill a timing row: device time per call of the kernel with L2
    warm and with L2 flushed, and of its plain version, time per
    back-to-back call, and the bound from the row's bytes and
    operations."""
    row["ms"] = device_ms(kernel)
    row["ms_l2_flushed"] = flushed_ms(kernel)
    row["plain_ms"] = device_ms(plain, reps=10)
    row["call_ms"] = call_ms(kernel)
    row["bound_ms"], row["bound_by"] = bound(row["bound_bytes"],
                                             row["bound_ops"])
    print("timing %s at %d rows: %.5f ms on the card, L2 warm (share "
          "%.3f), %.5f ms with L2 flushed (share %.3f); plain %.5f ms, "
          "bound %.5f ms by %s; %.5f ms per back-to-back call"
          % (name, rows, row["ms"], row["bound_ms"] / row["ms"],
             row["ms_l2_flushed"], row["bound_ms"] / row["ms_l2_flushed"],
             row["plain_ms"], row["bound_ms"], row["bound_by"],
             row["call_ms"]))


def dct_pool(rows, seed):
    """A wire pool of ``rows`` clip rows: synthetic spectra (what the
    serving path's dataset-free arm ships), random well-formed rows over
    all 64 positions, and a random-int16 garbage tail, a third each."""
    import numpy as np
    import torch
    from rnb_tpu_torch.decode import SyntheticDecoder
    from rnb_tpu_torch.ops import dct
    rng = np.random.default_rng(seed)
    nb = dct.num_dct_blocks(HW, HW)
    third = rows // 3
    pool = np.empty((rows, FRAMES, dct.dct_frame_elems(HW, HW)), np.int16)
    pool[:rows - 2 * third] = SyntheticDecoder().decode_clips_dct(
        "synth://smoke-%d" % seed, list(range(rows - 2 * third)), FRAMES,
        HW, HW)
    for r in range(rows - 2 * third, rows - third):
        for f in range(FRAMES):
            zz = np.where(rng.random((nb, 64)) < 0.1,
                          rng.integers(-900, 900, (nb, 64)), 0)
            pool[r, f] = dct.pack_frame_dct(zz, HW, HW)
    pool[rows - third:] = rng.integers(-32768, 32768,
                                       pool[rows - third:].shape)
    return torch.from_numpy(pool)


def to_u8(x):
    """Normalized frames back to u8 steps: (x*255 + 255) / 2."""
    import torch
    return torch.round((x.float() * 255.0 + 255.0) / 2.0)


def check_dct_ingest(wire, scalar, valid, two, height, width, dtype):
    """The fused ingest on ``wire`` with ``rows_valid`` from the device
    ``scalar`` (holding ``valid``): bitwise ``two`` (the unpack and the
    convert kernels' output), within DCT_STEPS of its plain version with
    at least DCT_EXACT_SHARE exact, pad rows zero. Returns (max abs
    error against the plain version, max steps, exact share)."""
    import torch
    from rnb_tpu_torch.ops import dct
    one = dct.ragged_normalize_dct(wire, scalar, height, width, dtype)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    check(torch.equal(one.view(bits), two.view(bits)),
          "dct_ingest rows=%d %dx%d valid=%d %s is not bitwise dct_unpack "
          "followed by dct_convert" % (wire.shape[0], height, width, valid,
                                       dtype))
    plain = dct.dct_ingest_reference(wire, valid, height, width, dtype)
    max_steps = int((to_u8(one) - to_u8(plain)).abs().max())
    exact = float((one == plain).double().mean())
    check(max_steps <= DCT_STEPS and exact >= DCT_EXACT_SHARE
          and not one[valid:].float().any(),
          "dct_ingest rows=%d %dx%d valid=%d %s: %d u8 steps from its plain "
          "version, exact share %.6f, or pad rows not zero"
          % (wire.shape[0], height, width, valid, dtype, max_steps, exact))
    return (float((one.float() - plain.float()).abs().max()), max_steps,
            exact)


def dct_ingest_row(wire, out):
    """The fused ingest's bound at a wire pool: the counts and the kept
    (value, position) pairs in, ``out`` out; the unpack's operations
    (per count: clamp and add; per kept entry: clamp, map, store) and
    the convert's (two 8-term passes per plane sample, 8 mul + 7 add
    each, the quantize -- add, floor, clip -- per plane sample, and per
    pixel BT.601 (10) plus clip, floor, normalize per channel)."""
    from rnb_tpu_torch.ops import dct
    nb = dct.num_dct_blocks(HW, HW)
    coeffs = dct.coeffs_from_elems(HW, HW, wire.shape[-1])
    counts = wire[..., :nb].long().clamp(0, 64)
    kept = int(counts.sum(-1).clamp(max=coeffs).sum())
    frames = wire.shape[0] * wire.shape[1]
    pixels = frames * HW * HW
    return dict(
        bound_bytes=frames * nb * 2 + kept * 4
        + out.numel() * out.element_size(),
        bound_ops=2 * frames * nb + 3 * kept
        + pixels * 3 // 2 * (2 * 15 + 4) + pixels * (10 + 18)), kept


def phase_kernels_dct(device):
    """The dct kernels against their plain versions, and the fused ingest
    bitwise the unpack followed by the convert; returns the timing rows
    at the dct serving path's 15-row pool (the ingest also at 48 rows,
    each beside the two launches it replaces) and the worst errors (the
    unpack's in coefficient units, the others' in output units)."""
    import numpy as np
    import torch
    from rnb_tpu_torch.decode import SyntheticDecoder
    from rnb_tpu_torch.ops import dct
    worst = {"dct_unpack": 0, "dct_convert": 0.0, "dct_ingest": 0.0}
    # one device scalar, rewritten between launches whose arguments stay
    # the same
    scalar = torch.zeros((1,), dtype=torch.int32, device=device)
    for rows in (48, 15):
        pool = dct_pool(rows, seed=rows)
        card = pool.to(device)
        plain_planes = [p.to(device)
                        for p in dct.unpack_dct_rows(pool, HW, HW)]
        for valid in (rows, 5, 0):
            planes = dct.unpack_dct_rows(card, HW, HW, valid)
            err = max(int((got[:valid].long() - want[:valid].long()).abs()
                          .max()) if valid else 0
                      for got, want in zip(planes, plain_planes))
            worst["dct_unpack"] = max(worst["dct_unpack"], err)
            check(err == 0, "dct_unpack rows=%d valid=%d differs from its "
                  "plain version by %d" % (rows, valid, err))
            scalar.fill_(valid)
            out = dct.dct_convert(*planes, scalar, HW, HW)
            check(torch.equal(dct.dct_convert(*planes, valid, HW, HW), out),
                  "dct_convert rows=%d valid=%d: the int form differs from "
                  "the device scalar's" % (rows, valid))
            plain = dct.dct_convert_reference(*plain_planes, valid, HW, HW)
            steps = (to_u8(out) - to_u8(plain)).abs()
            max_steps = int(steps.max())
            exact = float((out == plain).double().mean())
            worst["dct_convert"] = max(
                worst["dct_convert"],
                float((out.float() - plain.float()).abs().max()))
            check(max_steps <= DCT_STEPS and exact >= DCT_EXACT_SHARE,
                  "dct_convert rows=%d valid=%d: %d u8 steps from its "
                  "plain version, exact share %.6f" % (rows, valid,
                                                       max_steps, exact))
            pads_zero = not bool(out[valid:].float().any())
            check(pads_zero, "dct_convert rows=%d valid=%d: pad rows are "
                  "not zero" % (rows, valid))
            fused = []
            for dtype in (torch.bfloat16, torch.float32):
                two = out if dtype == torch.bfloat16 else dct.dct_convert(
                    *planes, scalar, HW, HW, dtype)
                fused.append(check_dct_ingest(card, scalar, valid, two, HW,
                                              HW, dtype))
                worst["dct_ingest"] = max(worst["dct_ingest"], fused[-1][0])
            print("kernels rows=%d rows_valid=%d: dct_unpack bitwise %s; "
                  "dct_convert (device scalar) max %d u8 steps (%d outputs "
                  "over one, exact share %.6f, pad rows zero %s); "
                  "dct_ingest (device scalar) bitwise dct_unpack + "
                  "dct_convert in bf16 and f32, max %d u8 steps from its "
                  "plain version (exact share %.6f), pad rows zero"
                  % (rows, valid, err == 0, max_steps,
                     int((steps > 1).sum()), exact, pads_zero,
                     max(f[1] for f in fused), min(f[2] for f in fused)))
    # a second geometry, both output dtypes
    height, width = DCT_GEOMETRY
    rng = np.random.default_rng(5)
    nb = dct.num_dct_blocks(height, width)
    wire = np.empty((15, FRAMES, dct.dct_frame_elems(height, width)),
                    np.int16)
    for r in range(15):
        for f in range(FRAMES):
            zz = np.where(rng.random((nb, 64)) < 0.1,
                          rng.integers(-900, 900, (nb, 64)), 0)
            wire[r, f] = dct.pack_frame_dct(zz, height, width)
    wire[14] = rng.integers(-32768, 32768, wire[14].shape)  # garbage row
    wire = torch.from_numpy(wire).to(device)
    for valid in (14, 5):
        scalar.fill_(valid)
        planes = dct.unpack_dct_rows(wire, height, width, valid)
        for dtype in (torch.bfloat16, torch.float32):
            out = dct.dct_convert(*planes, scalar, height, width, dtype)
            plain = dct.dct_convert_reference(*planes, valid, height, width,
                                              dtype)
            max_steps = int((to_u8(out) - to_u8(plain)).abs().max())
            exact = float((out == plain).double().mean())
            check(max_steps <= DCT_STEPS and exact >= DCT_EXACT_SHARE
                  and not out[valid:].float().any(),
                  "dct_convert %dx%d valid=%d %s: %d u8 steps from its "
                  "plain version, exact share %.6f, or pad rows not zero"
                  % (height, width, valid, dtype, max_steps, exact))
            _, fused_steps, fused_exact = check_dct_ingest(
                wire, scalar, valid, out, height, width, dtype)
            print("kernels %dx%d rows_valid=%d (device scalar) %s: "
                  "dct_convert max %d u8 steps, exact share %.6f, pad rows "
                  "zero; dct_ingest bitwise dct_unpack + dct_convert, max "
                  "%d u8 steps from its plain version (exact share %.6f), "
                  "pad rows zero (the garbage row among them)"
                  % (height, width, valid, dtype, max_steps, exact,
                     fused_steps, fused_exact))
    torch.cuda.synchronize()

    # timing at the serving shape: a full 15-row pool of synthetic spectra
    rows = 15
    wire = torch.from_numpy(SyntheticDecoder().decode_clips_dct(
        "synth://smoke-timing", list(range(rows)), FRAMES, HW, HW))
    card = wire.to(device)
    planes = dct.unpack_dct_rows(card, HW, HW)
    out = dct.dct_convert(*planes, rows, HW, HW)
    nb = dct.num_dct_blocks(HW, HW)
    ingest, kept = dct_ingest_row(wire, out)
    frames = rows * FRAMES
    plane_bytes = sum(p.numel() * p.element_size() for p in planes)
    pixels = frames * HW * HW
    timings = {
        "dct_unpack": dict(
            # the counts and the kept (value, position) pairs in, every
            # plane slot out
            bound_bytes=frames * nb * 2 + kept * 4 + plane_bytes,
            # per count: clamp and add; per kept entry: clamp, map, store
            bound_ops=2 * frames * nb + 3 * kept),
        "dct_convert": dict(
            bound_bytes=plane_bytes + out.numel() * out.element_size(),
            # two 8-term passes per plane sample (8 mul + 7 add each),
            # the quantize (add, floor, clip) per plane sample, and per
            # pixel BT.601 (10) plus clip, floor, normalize per channel
            bound_ops=pixels * 3 // 2 * (2 * 15 + 4) + pixels * (10 + 18)),
        "dct_ingest": ingest,
    }
    calls = {
        "dct_unpack": (lambda: dct.unpack_dct_rows(card, HW, HW),
                       lambda: dct.unpack_dct_rows_reference(card, HW, HW)),
        "dct_convert": (
            lambda: dct.dct_convert(*planes, rows, HW, HW),
            lambda: dct.dct_convert_reference(*planes, rows, HW, HW)),
        "dct_ingest": (
            lambda: dct.normalize_dct(card, HW, HW),
            lambda: dct.dct_ingest_reference(card, rows, HW, HW)),
    }
    for name, row in timings.items():
        time_kernel(name, row, rows, *calls[name])
    print("dct wire: %d kept coefficients in %d frames (%.1f per block)"
          % (kept, frames, kept / (frames * nb)))

    # the fused ingest beside the two launches it replaces, at 15 rows
    # and at the yuv420 kernel's 48
    row = timings["dct_ingest"]
    big = torch.from_numpy(SyntheticDecoder().decode_clips_dct(
        "synth://smoke-timing-48", list(range(48)), FRAMES, HW, HW))
    big_card = big.to(device)
    big_row, _ = dct_ingest_row(big, dct.normalize_dct(big_card, HW, HW))
    for suffix, pool in (("", card), ("_48", big_card)):
        def two(pool=pool):
            return dct.dct_convert(*dct.unpack_dct_rows(pool, HW, HW),
                                   int(pool.shape[0]), HW, HW)

        def one(pool=pool):
            return dct.normalize_dct(pool, HW, HW)
        if suffix:
            row["ms_48"] = device_ms(one)
            row["ms_48_l2_flushed"] = flushed_ms(one)
            row["bound_ms_48"], _ = bound(big_row["bound_bytes"],
                                          big_row["bound_ops"])
        row["two_kernel_ms" + suffix] = device_ms(two)
        row["two_kernel_ms_l2_flushed" + suffix] = flushed_ms(two)
        print("timing dct_ingest at %d rows: %.5f ms (L2 flushed %.5f ms) "
              "for the work of dct_unpack + dct_convert, which take %.5f ms "
              "(L2 flushed %.5f ms) as two launches (bound %.5f ms)"
              % (int(pool.shape[0]), row["ms" + suffix],
                 row["ms%s_l2_flushed" % suffix],
                 row["two_kernel_ms" + suffix],
                 row["two_kernel_ms_l2_flushed" + suffix],
                 row["bound_ms" + suffix]))
    return timings, worst


def gather_tables(pool_rows, slab_rows, seed):
    """The source tables the gather is held on: all sentinels, all hits,
    mixed, duplicate sources, and the slab's last row."""
    import numpy as np
    rng = np.random.default_rng(seed)
    mixed = rng.integers(-1, slab_rows, pool_rows).astype(np.int32)
    return {"all_miss": np.full(pool_rows, -1, np.int32),
            "all_hit": rng.integers(0, slab_rows, pool_rows).astype(np.int32),
            "mixed": mixed,
            "duplicates": np.where(mixed >= 0, 3, -1).astype(np.int32),
            "last_row": np.where(np.arange(pool_rows) % 2, slab_rows - 1,
                                 -1).astype(np.int32)}


def check_arena_order(device):
    """A gather issued, its plan released, its page evicted and
    rewritten by an insert, with no host sync between: the gather must
    return the old rows (the arena runs gathers and writes on one
    stream, in order)."""
    import numpy as np
    import torch
    from rnb_tpu_torch.cache import ClipCache
    from rnb_tpu_torch.pager import Pager, PagerSettings
    row = (FRAMES, 18816)
    pager = Pager(PagerSettings(page_rows=1))
    arena = pager.create_arena("clips", row, torch.uint8,
                               budget_bytes=FRAMES * 18816, device=device)
    cache = ClipCache(1.0, device=device)
    cache.attach_arena(arena)
    rng = np.random.default_rng(3)
    for trial in range(10):
        old, new = (torch.from_numpy(rng.integers(
            0, 256, (1,) + row, dtype=np.uint8)).to(device)
            for _ in range(2))
        check(cache.insert_pages(("old", trial), old, 0, 1),
              "order check: insert refused")
        plan = cache.acquire(("old", trial))
        out = arena.gather(torch.zeros((15,) + row, dtype=torch.uint8,
                                       device=device),
                           np.full(15, plan.src_rows[0], np.int32))
        plan.release()
        check(cache.insert_pages(("new", trial), new, 0, 1),
              "order check: the page was not reused")
        torch.cuda.synchronize()
        check(torch.equal(out, old.expand((15,) + row)),
              "order check: a write overtook an earlier gather of its page")
        check(torch.equal(arena._slab[0], new[0]),
              "order check: the write did not land")
        cache.acquire(("new", trial)).release()
        with pager.lock:
            cache._entries.clear()
            arena.free_locked((0,))
    print("kernels gather_rows: stream order held in 10 trials (gather, "
          "release, evict, rewrite, no host sync)")


def phase_kernels_gather(device):
    """The gather against its plain version, bitwise, at the clip and
    feature arenas' rows; returns its timing row at the 15-row clip pool
    with 8 hits and the worst error."""
    import numpy as np
    import torch
    from rnb_tpu_torch.ops.pages import gather_rows, gather_rows_reference
    gen = torch.Generator().manual_seed(99)
    worst = 0.0
    clip_slab_rows = 445  # the clip arena of cache_mb 256: 445 rows/page 4
    cases = (
        ("clip u8", torch.randint(0, 256, (15, FRAMES, 18816),
                                  generator=gen, dtype=torch.uint8),
         torch.randint(0, 256, (clip_slab_rows * 4, FRAMES, 18816),
                       generator=gen, dtype=torch.uint8)),
        ("feature f32", torch.randn((15, 400), generator=gen),
         torch.randn((4096, 400), generator=gen)))
    for what, pool, slab in cases:
        pool, slab = pool.to(device), slab.to(device)
        for name, src in gather_tables(15, int(slab.shape[0]), 5).items():
            out = gather_rows(pool, slab, src)
            plain = gather_rows_reference(pool, slab, src)
            bitwise = bool(torch.equal(
                out.view(torch.uint8) if out.dtype != torch.uint8 else out,
                plain.view(torch.uint8) if plain.dtype != torch.uint8
                else plain))
            worst = max(worst, float((out.float() - plain.float()).abs()
                                     .max()))
            check(bitwise, "gather_rows %s table %s is not bitwise equal "
                  "to its plain version" % (what, name))
            print("kernels gather_rows %s %s, table %s, over %d slab rows: "
                  "bitwise %s" % (what, tuple(pool.shape), name,
                                  int(slab.shape[0]), bitwise))
    torch.cuda.synchronize()
    check_arena_order(device)

    # timing at the serving shape: a 15-row clip pool, 8 rows hit
    pool, slab = cases[0][1].to(device), cases[0][2].to(device)
    src = np.full(15, -1, np.int32)
    src[:8] = np.arange(0, 8 * 97, 97)
    table = torch.from_numpy(src).to(device)
    all_hit = torch.from_numpy(np.arange(0, 15 * 97, 97)).to(device)
    all_hit32 = all_hit.int()
    row_bytes = FRAMES * 18816
    row = dict(bound_bytes=15 * row_bytes * 2 + src.nbytes, bound_ops=0)
    time_kernel("gather_rows", row, 15,
                lambda: gather_rows(pool, slab, table),
                lambda: gather_rows_reference(pool, slab, table))
    # the library yardstick like for like: one torch.index_select of the
    # all-hit table beside the kernel on the same table, both with L2
    # warm and flushed
    def library():
        return torch.index_select(slab, 0, all_hit)

    def kernel_all_hit():
        return gather_rows(pool, slab, all_hit32)
    # the fixed cost: the same launch and table at 16-byte rows (the
    # table's read, the launch and one dependent row load)
    tiny_pool = pool.reshape(15, -1)[:, :16].contiguous()
    tiny_slab = slab.reshape(slab.shape[0], -1)[:, :16].contiguous()

    def kernel_tiny():
        return gather_rows(tiny_pool, tiny_slab, table)
    row["tiny_rows_ms"] = device_ms(kernel_tiny)
    row["tiny_rows_ms_l2_flushed"] = flushed_ms(kernel_tiny)
    print("timing gather_rows at 16-byte rows, the same table: %.5f ms "
          "(L2 flushed %.5f ms)" % (row["tiny_rows_ms"],
                                    row["tiny_rows_ms_l2_flushed"]))
    row["library_ms"] = device_ms(library)
    row["library_ms_l2_flushed"] = flushed_ms(library)
    row["all_hit_ms"] = device_ms(kernel_all_hit)
    row["all_hit_ms_l2_flushed"] = flushed_ms(kernel_all_hit)
    print("timing gather_rows on an all-hit table: %.5f ms (L2 flushed "
          "%.5f ms); torch.index_select (library) on it %.5f ms (L2 "
          "flushed %.5f ms)"
          % (row["all_hit_ms"], row["all_hit_ms_l2_flushed"],
             row["library_ms"], row["library_ms_l2_flushed"]))
    return {"gather_rows": row}, {"gather_rows": worst}


def scaleout_pool_shape():
    """The row pool the shipped scale-out loaders emit: the root
    ``ragged`` key's ``pool_rows`` rows of ``consecutive_frames`` RGB
    frames."""
    with open(os.path.join(HERE, SCALEOUT_R4)) as f:
        raw = json.load(f)
    return (raw["ragged"]["pool_rows"],
            raw["pipeline"][0]["consecutive_frames"], HW, HW, 3)


def phase_kernels_ragged(device):
    """The ragged normalize against its plain version, bitwise, at the
    unfused loader's 15-row pool, at odd rows and at the scale-out
    loaders' pool (every valid count); returns its timing row at 15
    valid rows (7 beside it) and the worst error."""
    import torch
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.ops.preprocess import normalize_u8
    from rnb_tpu_torch.ops.ragged import (ragged_normalize_u8,
                                          ragged_normalize_u8_reference)
    gen = torch.Generator().manual_seed(77)
    rows = 15
    # every row random, so the tail past rows_valid is garbage
    pool = torch.randint(0, 256, (rows, FRAMES, HW, HW, 3), generator=gen,
                         dtype=torch.uint8).to(device)
    odd = torch.randint(0, 256, (rows, 1001), generator=gen,
                        dtype=torch.uint8).to(device)
    scaleout = torch.randint(0, 256, scaleout_pool_shape(), generator=gen,
                             dtype=torch.uint8).to(device)
    bucketed = normalize_u8(pool)
    scalar = torch.zeros((1,), dtype=torch.int32, device=device)
    worst = 0.0
    for what, x, valids in (
            ("clip pool", pool, (0, 1, 7, 14, 15)),
            ("odd rows", odd, (0, 1, 7, 14, 15)),
            ("scale-out pool", scaleout, range(scaleout.shape[0] + 1))):
        before = _kernels.RAGGED_NORMALIZE_U8.launches
        for valid in valids:
            # the same launch arguments every time: only the scalar on
            # the card changes
            scalar.fill_(valid)
            out = ragged_normalize_u8(x, scalar)
            plain = ragged_normalize_u8_reference(x, valid)
            bitwise = torch.equal(out.view(torch.int16),
                                  plain.view(torch.int16))
            worst = max(worst, float((out.float() - plain.float()).abs()
                                     .max()))
            check(bitwise, "ragged_normalize_u8 %s rows_valid=%d is not "
                  "bitwise equal to its plain version" % (what, valid))
            pads_zero = not bool(out[valid:].float().any())
            check(pads_zero, "ragged_normalize_u8 %s rows_valid=%d: pad "
                  "rows are not zero" % (what, valid))
            same_as_k1 = x is not pool or torch.equal(
                out[:valid].view(torch.int16),
                bucketed[:valid].view(torch.int16))
            check(same_as_k1, "ragged_normalize_u8 rows_valid=%d: valid "
                  "rows differ from normalize_u8's" % valid)
            print("kernels ragged_normalize_u8 %s %s rows_valid=%d (device "
                  "scalar): bitwise %s, pad rows zero %s, valid rows equal "
                  "normalize_u8 %s" % (what, tuple(x.shape), valid, bitwise,
                                       pads_zero, same_as_k1))
        check(_kernels.RAGGED_NORMALIZE_U8.launches
              == before + len(valids),
              "ragged_normalize_u8 did not count one launch per call")
    torch.cuda.synchronize()

    per_row = pool[0].numel()
    row = dict(bound_bytes=rows * per_row * 3, bound_ops=3 * rows * per_row)
    scalar.fill_(rows)
    time_kernel("ragged_normalize_u8", row, rows,
                lambda: ragged_normalize_u8(pool, scalar),
                lambda: ragged_normalize_u8_reference(pool, scalar))
    # 7 valid rows: 7 rows read, 15 written
    scalar.fill_(7)
    row["ms_valid7"] = device_ms(lambda: ragged_normalize_u8(pool, scalar))
    row["bound_ms_valid7"] = ((7 * per_row + rows * per_row * 2)
                              / PEAK_BYTES_PER_S * 1e3)
    row["k1_ms_15_rows"] = device_ms(lambda: normalize_u8(pool))
    print("timing ragged_normalize_u8 at 7 valid rows of 15: %.5f ms "
          "(bound %.5f ms); normalize_u8 at the same 15 rows: %.5f ms"
          % (row["ms_valid7"], row["bound_ms_valid7"],
             row["k1_ms_15_rows"]))
    return {"ragged_normalize_u8": row}, {"ragged_normalize_u8": worst}


def ring_leaves(degree):
    """The sharded leaves of the served full-width network at ``degree``:
    leaf name -> (member shard shape, memory format, dtype), read off a
    copy of the sharded network on the meta device."""
    import torch
    from rnb_tpu_torch.models.r2p1d.network import (R2Plus1DClassifier,
                                                    cast_compute_weights)
    with torch.device("meta"):
        net = cast_compute_weights(R2Plus1DClassifier(1, 5, 400,
                                                      shards=degree))
    leaves = {}
    for name, param in net.named_parameters():
        leaf, _, member = name.rpartition(".")
        if leaf.endswith("_shards") and member == "0":
            fmt = (torch.channels_last_3d if param.dim() == 5
                   else torch.contiguous_format)
            leaves[leaf[:-len("_shards")]] = (tuple(param.shape), fmt,
                                              param.dtype)
    return leaves


def ring_members(shape, fmt, dtype, degree, gen, device):
    """``degree`` seeded member buffers of one shape and layout on the
    card."""
    import torch
    return [torch.randn(shape, generator=gen).to(dtype).contiguous(
        memory_format=fmt).to(device) for _ in range(degree)]


def check_ring(what, members, shift):
    """``ring_shift`` of ``members`` bitwise its plain version on the
    same card buffers, one launch, the destinations laid out as the
    sources; returns the largest difference (0)."""
    import torch
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.ops.handoff_dma import (ring_shift,
                                               ring_shift_reference)
    before = _kernels.RING_SHIFT.launches
    got = ring_shift(members, shift)
    check(_kernels.RING_SHIFT.launches == before + 1,
          "ring_shift %s did not count one launch" % what)
    want = ring_shift_reference(members, shift)
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        check(g.stride() == w.stride(), "ring_shift %s: destination "
              "strides %s, source's %s" % (what, g.stride(), w.stride()))
        bitwise = torch.equal(g, w)
        if not bitwise:
            err = max(err, float((g.float() - w.float()).abs().max()))
        check(bitwise, "ring_shift %s shift %d is not bitwise its plain "
              "version" % (what, shift))
    return err


def check_group(what, table, launches):
    """The grouped hop of ``table``, whose destinations are slots of
    canary-filled tensors, bitwise its plain version into clones of
    those tensors (the canary bytes outside the slots included), in
    ``launches`` launches; returns the largest difference (0)."""
    import torch
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.ops.handoff_dma import (RingEntry, ring_shift_group,
                                               ring_shift_group_reference)
    bases = {}
    for entry in table:
        for d in entry.dsts:
            bases.setdefault(d.untyped_storage().data_ptr(),
                             d if d._base is None else d._base)
    twins = {key: base.clone() for key, base in bases.items()}

    def twin(d):
        return torch.as_strided(twins[d.untyped_storage().data_ptr()],
                                d.shape, d.stride(), d.storage_offset())
    ring_shift_group_reference([RingEntry(e.srcs, [twin(d) for d in e.dsts],
                                          e.shift) for e in table])
    before = _kernels.RING_SHIFT.launches
    ring_shift_group(table)
    check(_kernels.RING_SHIFT.launches == before + launches,
          "the grouped hop of %s counted %d launches, not %d" % (
              what, _kernels.RING_SHIFT.launches - before, launches))
    torch.cuda.synchronize()
    err = 0.0
    for key, base in bases.items():
        if not torch.equal(base, twins[key]):
            err = max(err, float((base.float() - twins[key].float()).abs()
                                 .max()))
    check(err == 0.0, "the grouped hop of %s is not bitwise its plain "
          "version (canary bytes included): %g" % (what, err))
    return err


def canary_table(leaves, axis, shifts, fill):
    """A grouped table of ``leaves`` (member lists) along ``axis``: for
    each leaf and shift in ``shifts``, member ``i``'s shard into chunk
    ``i``'s slot of member ``i + shift``'s full-width tensor, every
    full-width tensor filled with ``fill`` first."""
    from rnb_tpu_torch.ops.handoff_dma import RingEntry, _full_width
    table = []
    for members in leaves:
        n = len(members)
        ax = axis % members[0].dim()
        chunk = members[0].shape[ax]
        full = [_full_width(m, n, ax).fill_(fill) for m in members]
        for shift in shifts:
            table.append(RingEntry(members, [
                full[j].narrow(ax, ((j - shift) % n) * chunk, chunk)
                for j in range(n)], shift))
    return table


def plain_gather(leaves, axis):
    """The all-gather's tables through the plain version of the grouped
    hop: the byte moves the kernel makes, one ``copy_`` each."""
    from rnb_tpu_torch.ops.handoff_dma import (ring_gather_tables,
                                               ring_shift_group_reference)
    gathered, tables = ring_gather_tables(leaves, axis)
    for table in tables:
        ring_shift_group_reference(table)
    return gathered


def gather_bytes(leaves):
    """The bytes an all-gather must move: every shard read once, every
    member's full-width result written once."""
    return sum(len(m) * (1 + len(m)) * m[0].numel() * m[0].element_size()
               for m in leaves)


def phase_kernels_ring(device):
    """The grouped ring hop against its plain version, bitwise: the 19
    sharded leaves at degree 2 as one table (own slots and the hop) and
    their all-gather against the concatenation in one launch, the conv5
    temporal leaf at degree 4 (one-buffer hops at shifts 1 to 3, its
    gather in 3 launches), the merge block as an entry of rows at a
    pitch, odd bytes and a misaligned view, every destination a slot of
    a canary-filled tensor. Timed with L2 warm and flushed beside the
    bound and the plain version: the conv5 hop (``torch.roll``), the
    conv5 leaf's gather and the merge (``torch.cat``), and a whole
    forward's gather at degree 2, beside its 19 gathers one leaf at a
    time. Returns its timing row and worst error."""
    import torch
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.ops.handoff_dma import (ring_all_gather,
                                               ring_all_gather_many,
                                               ring_shift,
                                               ring_shift_reference)
    from rnb_tpu_torch.parallel.shardplan import build_shard_ring, make_merge
    gen = torch.Generator().manual_seed(314)
    worst = 0.0
    leaves = ring_leaves(RING_TIMED_DEGREE)
    check(len(leaves) == SHARD_LEAVES, "the sharded network has %d "
          "sharded leaves, not %d" % (len(leaves), SHARD_LEAVES))
    forward = []
    for name, (shape, fmt, dtype) in sorted(leaves.items()):
        forward.append(ring_members(shape, fmt, dtype, RING_TIMED_DEGREE,
                                    gen, device))
    # the forward's first table: every leaf's own slots and its hop
    worst = max(worst, check_group("the %d leaves at degree %d" % (
        len(forward), RING_TIMED_DEGREE), canary_table(
            forward, 0, (0, 1), 7), 1))
    before = _kernels.RING_SHIFT.launches
    gathered = ring_all_gather_many(forward, axis=0)
    check(_kernels.RING_SHIFT.launches == before + GATHER_LAUNCHES,
          "the forward's gather took %d launches, not %d" % (
              _kernels.RING_SHIFT.launches - before, GATHER_LAUNCHES))
    for name, members, full in zip(sorted(leaves), forward, gathered):
        fmt = leaves[name][1]
        want = torch.cat(members).contiguous(memory_format=fmt)
        for member in full:
            check(torch.equal(member, want) and member.stride()
                  == want.stride(), "ring_all_gather_many of %s is not the "
                  "concatenation, laid out as it" % name)
    print("kernels ring_shift: the %d sharded leaves at degree %d (bf16, "
          "%d to %d bytes a member) as one table bitwise its plain version "
          "(canary bytes included); their gather in %d launch, bitwise the "
          "concatenation" % (
              len(leaves), RING_TIMED_DEGREE,
              min(math.prod(s) * 2 for s, _, _ in leaves.values()),
              max(math.prod(s) * 2 for s, _, _ in leaves.values()),
              GATHER_LAUNCHES))
    conv5 = "net.conv5.block1.conv2.temporal.weight"
    shape, fmt, dtype = ring_leaves(4)[conv5]
    members4 = ring_members(shape, fmt, dtype, 4, gen, device)
    for shift in (1, 2, 3):
        worst = max(worst, check_ring("%s degree 4" % conv5, members4,
                                      shift))
    worst = max(worst, check_group("%s degree 4, shifts 0-3" % conv5,
                                   canary_table([members4], 0, range(4), 7),
                                   1))
    before = _kernels.RING_SHIFT.launches
    full4 = ring_all_gather(members4, axis=0)
    want4 = torch.cat(members4).contiguous(memory_format=fmt)
    check(_kernels.RING_SHIFT.launches == before + 3 and all(
        torch.equal(m, want4) for m in full4), "the degree-4 gather of %s "
          "is not the concatenation in 3 launches" % conv5)
    merge = ring_members(MERGE_BLOCK, torch.contiguous_format,
                         torch.float32, RING_TIMED_DEGREE, gen, device)
    worst = max(worst, check_ring("merge block", merge, 1))
    # the merge's own table: rows of 800 bytes at a pitch of 1600
    worst = max(worst, check_group("the merge blocks %s" % (MERGE_BLOCK,),
                                   canary_table([merge], -1, (0, 1), 7),
                                   1))
    odd = [torch.randint(0, 256, (1001,), generator=gen,
                         dtype=torch.uint8).to(device) for _ in range(3)]
    for shift in (1, 2):
        worst = max(worst, check_ring("odd u8", odd, shift))
    odd_rows = [torch.randint(0, 256, (3, 13), generator=gen,
                              dtype=torch.uint8).to(device)
                for _ in range(3)]
    worst = max(worst, check_group("odd bytes and odd rows", canary_table(
        [odd, odd_rows], -1, (0, 1, 2), 0xA5), 1))
    base = torch.randint(0, 256, (2, 40007), generator=gen,
                         dtype=torch.uint8).to(device)
    # 1 and 3 bytes off 16-byte alignment: the byte loop
    worst = max(worst, check_ring("misaligned view",
                                  [base[0, 1:40001], base[1, 3:40003]], 1))
    print("kernels ring_shift: %s at degree 4, shifts 0-3 (one-buffer hops "
          "and one table) and its gather; the merge blocks %s f32 as rows "
          "at a pitch; 1001 bytes and 3 x 13-byte rows at degree 3; a "
          "misaligned view: bitwise" % (conv5, MERGE_BLOCK))

    def timed(prefix, kernel, plain, library, bound_bytes, label):
        row[prefix + "ms"] = device_ms(kernel)
        row[prefix + "ms_l2_flushed"] = flushed_ms(kernel)
        row[prefix + "plain_ms"] = device_ms(plain, reps=10)
        row[prefix + "library_ms"] = (None if library is None
                                      else device_ms(library))
        row[prefix + "bound_ms"], by = bound(bound_bytes, 0)
        print("timing ring_shift %s: %.5f ms on the card, L2 warm (share "
              "%.3f), %.5f ms with L2 flushed (share %.3f); plain %.5f ms, "
              "library %s ms, bound %.5f ms by %s"
              % (label, row[prefix + "ms"],
                 row[prefix + "bound_ms"] / row[prefix + "ms"],
                 row[prefix + "ms_l2_flushed"],
                 row[prefix + "bound_ms"] / row[prefix + "ms_l2_flushed"],
                 row[prefix + "plain_ms"], row[prefix + "library_ms"],
                 row[prefix + "bound_ms"], by))
        return by

    # the merge as the stage times it, on an idle host: its host time
    # from the forward's end (synchronized) to the merged logits' (the
    # served runs' exec1.collective spans add whatever else holds the
    # interpreter then)
    merge_fn = make_merge(build_shard_ring([device] * RING_TIMED_DEGREE,
                                           RING_TIMED_DEGREE))
    merge_fn(merge)
    host_us = []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merge_fn(merge)
        torch.cuda.synchronize()
        host_us.append((time.perf_counter() - t0) * 1e6)
    host_us.sort()
    print("timing the merge collective at degree %d, host clock on an idle "
          "host: median %.1f us, min %.1f us, max %.1f us of 50"
          % (RING_TIMED_DEGREE, host_us[25], host_us[0], host_us[-1]))
    row = {"merge_host_us": host_us[25]}
    n = RING_TIMED_DEGREE
    conv5_members = forward[sorted(leaves).index(conv5)]
    nbytes = conv5_members[0].numel() * conv5_members[0].element_size()
    # the library yardstick's input: the members' bytes stacked
    stacked = torch.randint(0, 256, (n, nbytes), generator=gen,
                            dtype=torch.uint8).to(device)
    # the hop alone: every member's buffer read once and written once
    row["bound_by"] = timed(
        "", lambda: ring_shift(conv5_members, 1),
        lambda: ring_shift_reference(conv5_members, 1),
        lambda: torch.roll(stacked, 1, dims=0), 2 * n * nbytes,
        "conv5 temporal hop at degree %d (%d bytes a member)" % (n, nbytes))
    row["call_ms"] = call_ms(lambda: ring_shift(conv5_members, 1))
    timed("gather_", lambda: ring_all_gather(conv5_members, axis=0),
          lambda: plain_gather([conv5_members], 0),
          lambda: torch.cat(conv5_members),
          gather_bytes([conv5_members]),
          "conv5 temporal gather at degree %d" % n)
    timed("merge_", lambda: merge_fn(merge),
          lambda: plain_gather([merge], -1)[0][0],
          lambda: torch.cat(merge, dim=-1),
          gather_bytes([merge]),
          "merge of %s blocks at degree %d" % (MERGE_BLOCK, n))
    timed("forward_gather_", lambda: ring_all_gather_many(forward, axis=0),
          lambda: plain_gather(forward, 0), None,
          gather_bytes(forward),
          "one forward's %d leaves gathered at degree %d" % (len(forward),
                                                              n))
    row["forward_per_leaf_ms"] = device_ms(
        lambda: [ring_all_gather(m, axis=0) for m in forward])
    print("timing ring_shift: one forward's %d gathers one leaf at a time "
          "(%d launches), %.5f ms on the card against %.5f ms as one; %.5f "
          "ms per back-to-back conv5 hop" % (
              len(forward), len(forward), row["forward_per_leaf_ms"],
              row["forward_gather_ms"], row["call_ms"]))
    return {"ring_shift": row}, {"ring_shift": worst}


def cpu_recompute(config_path, sink, picks, sums=None):
    """Recompute ``picks`` requests on the CPU through the plain
    versions with the same weights (seeded, or the last network step's
    ``ckpt_path``), in bfloat16 (as served) and
    in float32; also run the card's network in float32 on the same
    input. Returns a dict of the worst errors and the bounds held.
    Where a request served a class id and ``sums`` holds its summed
    logits from the card (the segment copy's), those are held element
    by element to the float32 sums within the bound times the clips.

    bf16 rounds at other places on the card (cuDNN) than on the CPU
    (oneDNN), so the served logits are held to the float32 truth with a
    bound measured on the CPU's own bf16 run of the same input: the
    card may be at most BF16_FACTOR times as far from float32 as the
    CPU's bf16 is, plus BF16_ATOL. The network itself is held tightly
    in float32: card vs CPU within F32_ATOL (no TF32, accumulation
    order only)."""
    import numpy as np
    import torch
    from rnb_tpu_torch.config import load_config
    from rnb_tpu_torch.decode import get_decoder
    from rnb_tpu_torch.models.r2p1d.model import shared_network
    from rnb_tpu_torch.models.r2p1d.sampler import R2P1DSampler
    from rnb_tpu_torch.ops.dct import normalize_dct
    from rnb_tpu_torch.ops.preprocess import normalize_u8
    from rnb_tpu_torch.ops.yuv import normalize_yuv420
    config = load_config(config_path, "cpu")
    loader_kwargs = config.steps[0].kwargs
    max_clips = loader_kwargs.get("max_clips", 15)
    pixel_path = loader_kwargs.get("pixel_path", "rgb")
    # the loader's sampler (the tiny-shed config draws 1 or 2 clips of
    # 2 frames)
    frames = loader_kwargs.get("consecutive_frames", FRAMES)
    population = {k: loader_kwargs[k] for k in ("num_clips_population",
                                                "weights")
                  if k in loader_kwargs}
    # the last network step (an aggregator may follow it)
    runner_kwargs = next(
        s.kwargs for s in reversed(config.steps)
        if s.model.endswith((".R2P1DRunner", ".R2P1DSingleStep")))
    arch = (1, runner_kwargs.get("end_index", 5),
            runner_kwargs.get("num_classes", 400),
            tuple(runner_kwargs.get("layer_sizes", (2, 2, 2, 2))))
    weights = dict(factored_shortcut=runner_kwargs.get("factored_shortcut",
                                                       False),
                   ckpt_path=runner_kwargs.get("ckpt_path"))
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    nets = {
        "cpu_bf16": shared_network(*arch, cpu, **weights),
        "cpu_f32": shared_network(*arch, cpu, dtype=torch.float32,
                                  **weights),
        "card_f32": shared_network(*arch, card, dtype=torch.float32,
                                   **weights)}
    sampler = R2P1DSampler(consecutive_frames=frames, **population)
    report = dict(f32_err=0.0, served_err=0.0, cpu_bf16_err=0.0,
                  bound=0.0, argmax_agreed=0, rows=0, past_margin=0)
    for rid in picks:
        video, served, _stamps = sink[rid]
        decoder = get_decoder(video)
        starts = sampler.sample(decoder.num_frames(video),
                                video_id=video)[:max_clips]
        if pixel_path == "dct":
            wire = torch.from_numpy(decoder.decode_clips_dct(
                video, starts, frames, HW, HW,
                loader_kwargs.get("dct_coeffs_per_frame")))
            ingest = normalize_dct
        elif pixel_path == "yuv420":
            wire = torch.from_numpy(decoder.decode_clips_yuv(
                video, starts, frames, HW, HW))
            ingest = normalize_yuv420
        else:
            wire = torch.from_numpy(decoder.decode_clips(
                video, starts, frames, HW, HW))

            def ingest(frames, _height, _width):
                return normalize_u8(frames)
        with torch.inference_mode():
            x_cpu = ingest(wire, HW, HW)
            x_card = ingest(wire.to(card), HW, HW).cpu()
            if pixel_path == "dct":
                steps = int((to_u8(x_card) - to_u8(x_cpu)).abs().max())
                exact = float((x_card == x_cpu).double().mean())
                report["ingest_exact_share"] = min(
                    report.get("ingest_exact_share", 1.0), exact)
                check(steps <= DCT_STEPS and exact >= DCT_EXACT_SHARE,
                      "request %d: card ingest is %d u8 steps from the "
                      "plain one (exact share %.6f)" % (rid, steps, exact))
            else:
                check(torch.equal(x_card.view(torch.int16),
                                  x_cpu.view(torch.int16)),
                      "request %d: card ingest differs from the plain one"
                      % rid)
            # the float32 networks see the same input, so they differ by
            # accumulation order only
            out = {"cpu_bf16": nets["cpu_bf16"](x_cpu).numpy(),
                   "cpu_f32": nets["cpu_f32"](x_cpu).numpy(),
                   "card_f32": nets["card_f32"](x_cpu.to(card))
                   .cpu().numpy()}
        truth = out["cpu_f32"]
        f32_err = float(np.abs(out["card_f32"] - truth).max())
        if isinstance(served, int):
            # a class id: the argmax of the summed float32 truth, held
            # where its top-2 margin exceeds twice the bf16 bound summed
            # over the clips
            check(f32_err <= F32_ATOL, "request %d (%s): card float32 "
                  "network differs from the CPU's by %g > %g"
                  % (rid, video, f32_err, F32_ATOL))
            cpu_bf16_err = float(np.abs(out["cpu_bf16"] - truth).max())
            bound = BF16_FACTOR * cpu_bf16_err + BF16_ATOL
            total = truth.sum(axis=0)
            top2 = np.sort(total)[-2:]
            held = top2[1] - top2[0] > 2 * bound * truth.shape[0]
            check(not held or served == int(total.argmax()),
                  "request %d: class id %d, the CPU float32 logits say %d"
                  % (rid, served, int(total.argmax())))
            if sums is not None:
                # a clip's served logits lie within the bound of float32
                sums_err = float(np.abs(sums[rid] - total).max()
                                 / truth.shape[0])
                check(sums_err <= bound, "request %d: card sums are %g a "
                      "clip from the float32 sums, more than the bound %g"
                      % (rid, sums_err, bound))
                report["sums_err"] = max(report.get("sums_err", 0.0),
                                         sums_err)
            for key, value in (("f32_err", f32_err),
                               ("cpu_bf16_err", cpu_bf16_err),
                               ("bound", bound)):
                report[key] = max(report[key], value)
            report["rows"] += int(truth.shape[0])
            report["past_margin"] += int(held)
            report["argmax_agreed"] += int(served == int(total.argmax()))
            continue
        check(truth.shape == served.shape, "request %d: cpu logits %s vs "
              "card %s" % (rid, truth.shape, served.shape))
        check(f32_err <= F32_ATOL, "request %d (%s): card float32 network "
              "differs from the CPU's by %g > %g"
              % (rid, video, f32_err, F32_ATOL))
        cpu_bf16_err = float(np.abs(out["cpu_bf16"] - truth).max())
        bound = BF16_FACTOR * cpu_bf16_err + BF16_ATOL
        served_err = float(np.abs(served - truth).max())
        check(served_err <= bound, "request %d (%s): served logits are %g "
              "from float32, more than the bf16 bound %g"
              % (rid, video, served_err, bound))
        for key, value in (("f32_err", f32_err), ("served_err", served_err),
                           ("cpu_bf16_err", cpu_bf16_err),
                           ("bound", bound)):
            report[key] = max(report[key], value)
        for row_truth, row_served in zip(truth, served):
            same = row_truth.argmax() == row_served.argmax()
            report["argmax_agreed"] += int(same)
            report["rows"] += 1
            top2 = np.sort(row_truth)[-2:]
            if top2[1] - top2[0] > 2 * bound:
                # every served logit is within the bound, so past a
                # 2*bound margin the argmax cannot move
                report["past_margin"] += 1
                check(same, "request %d: argmax differs past the margin"
                      % rid)
    return report


def features_off_copy(data_root) -> str:
    """The paged Zipf cell with ``pager.feature_cache`` off, so repeats
    become clip-page hits: a temporary copy beside the dataset."""
    with open(os.path.join(HERE, PAGED)) as f:
        raw = json.load(f)
    raw["pager"]["feature_cache"] = False
    path = os.path.join(data_root, FEATURES_OFF + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def whole_ragged_copy(data_root) -> str:
    """The unfused whole pipeline under the root ``ragged`` key, so the
    loader's step runs the ragged normalize kernel: a temporary copy
    beside the dataset."""
    with open(os.path.join(HERE, WHOLE)) as f:
        raw = json.load(f)
    raw["ragged"] = {"enabled": True}
    path = os.path.join(data_root, WHOLE_RAGGED + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def one_card_copy(data_root, config, name) -> str:
    """A topology on one card: every device index >= 0 of ``config``
    made 0 (the host stays the host; a mesh step's members too), a
    temporary copy beside the dataset."""
    with open(os.path.join(HERE, config)) as f:
        raw = json.load(f)
    for step in raw["pipeline"]:
        for group in step["queue_groups"]:
            group["devices"] = [0 if d >= 0 else d
                                for d in group["devices"]]
        if "mesh_devices" in step:
            step["mesh_devices"] = [0] * len(step["mesh_devices"])
    path = os.path.join(data_root, name + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def async_producer_copy(data_root, config, name) -> str:
    """:func:`one_card_copy` with ``async_dispatch`` on the first step:
    the loader no longer waits for its device work, and the next step's
    stream is ordered behind it on the card."""
    path = one_card_copy(data_root, config, name)
    with open(path) as f:
        raw = json.load(f)
    raw["pipeline"][0]["async_dispatch"] = True
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def segment_sums(stages, sink):
    """Each request's segment logits summed as the aggregator sums them,
    recomputed on the card: the run's own loader on the request's video,
    ``split_segments``, and a runner's eager forward on each segment
    (which ``check_graphs`` held bitwise to its graph's replay)."""
    import torch
    from rnb_tpu_torch.runner import split_segments
    from rnb_tpu_torch.telemetry import TimeCard
    loader = next(stage for step, stage in stages if step == 0)
    runner = next(stage for step, stage in stages if step == 1)
    sums = {}
    for rid, (video, _pred, _stamps) in sorted(sink.items()):
        (pb,), _nt, _tc = loader(None, video, TimeCard(rid))
        total = None
        for (seg,) in split_segments((pb,), SEGMENTS):
            out = runner.eager_forward(seg.data, seg.valid)[:seg.valid]
            part = out.to(torch.float32).cpu().numpy().sum(axis=0)
            total = part if total is None else total + part
        sums[rid] = total
    return sums


def check_segment_run(result, sink, whole_sink, sums):
    """The segment copy's own checks: every class id the argmax of its
    recomputed segment sums; those sums held element by element to the
    whole run's summed logits of the same request, within TWO_STEP_ATOL
    times the clips; and the class id equal to the argmax of the whole
    run's sums outside a top-2 margin of twice the largest difference
    between the request's two sums (past it the argmax cannot move).
    A request inside the margin is a near tie: every one is counted and
    printed, and more than NEAR_TIE_SHARE of the requests serving
    another class id than the whole run there fails (the whole run's
    bf16 sums tie exactly in some requests, where no margin holds the
    class id; the sums are held all the same). Also
    one ``normalize_u8`` launch a request, three replays a request, and
    the merged cards' suffixed stamps."""
    import numpy as np
    from rnb_tpu_torch.parse_utils import read_table
    label = SEGMENT_COPY
    per_clip, near_ties, held = 0.0, [], 0
    for rid, (video, pred, _stamps) in sorted(sink.items()):
        check(isinstance(pred, int) and 0 <= pred < 400,
              "%s request %d: class id %r" % (label, rid, pred))
        check(video == whole_sink[rid][0], "%s request %d served %s, the "
              "whole run %s" % (label, rid, video, whole_sink[rid][0]))
        check(pred == int(sums[rid].argmax()), "%s request %d: class id "
              "%d, its recomputed segment sums say %d"
              % (label, rid, pred, int(sums[rid].argmax())))
        whole = whole_sink[rid][1]
        total = whole.sum(axis=0)
        diff = float(np.abs(sums[rid] - total).max())
        check(diff <= TWO_STEP_ATOL * whole.shape[0], "%s request %d: "
              "segment sums differ from the whole run's by %g > %g x %d "
              "clips" % (label, rid, diff, TWO_STEP_ATOL, whole.shape[0]))
        per_clip = max(per_clip, diff / whole.shape[0])
        top2 = np.sort(total)[-2:]
        if top2[1] - top2[0] > 2 * diff:
            check(pred == int(total.argmax()), "%s request %d: class id "
                  "%d, the whole run's summed logits say %d"
                  % (label, rid, pred, int(total.argmax())))
            held += 1
        else:
            near_ties.append((rid, float(top2[1] - top2[0]), 2 * diff,
                              pred == int(total.argmax())))
    differ = [tie for tie in near_ties if not tie[3]]
    launched = result.window_launches["normalize_u8"]
    replays = result.graphs["step1"]["replays"]
    (table,) = [n for n in os.listdir(result.log_dir)
                if n.endswith("-0.txt")]
    keys, rows = read_table(os.path.join(result.log_dir, table))
    print("path %s: segment sums within %g a clip of the whole run's "
          "summed logits (bound %g); %d class ids equal the argmax of the "
          "whole run's sums past a top-2 margin of twice the request's "
          "largest difference between the two sums; %d near ties [rid, "
          "gap, margin, equal] %s, %d of them another class id (at most "
          "%g of %d requests); normalize_u8 %d launches, %d replays for "
          "%d requests; Warmup: %s; Graphs: %s"
          % (label, per_clip, TWO_STEP_ATOL, held, len(near_ties),
             json.dumps(near_ties), len(differ), NEAR_TIE_SHARE, len(sink),
             launched, replays, result.num_completed,
             json.dumps(result.warmup_s, sort_keys=True),
             json.dumps(result.graphs, sort_keys=True)))
    check(len(differ) <= NEAR_TIE_SHARE * len(sink),
          "%s: %d near ties of %d requests served another class id than "
          "the whole run (more than %g of them)"
          % (label, len(differ), len(sink), NEAR_TIE_SHARE))
    check(launched == result.num_completed, "%s: %d normalize_u8 launches "
          "for %d requests" % (label, launched, result.num_completed))
    check(replays == SEGMENTS * result.num_completed,
          "%s: %d graph replays for %d requests" % (
              label, replays, result.num_completed))
    for sub_id in range(SEGMENTS):
        check("inference1_finish-%d" % sub_id in keys, "%s: no merged "
              "stamp inference1_finish-%d (keys %s)" % (label, sub_id, keys))
    check(keys[-1] == "inference2_finish" and len(rows) == len(sink),
          "%s: merged table keys %s, %d rows" % (label, keys, len(rows)))


def check_traced_run(result):
    """The traced run's own checks: ``trace.json`` valid, the ``Trace:``
    line matching it, and every request's phases summing to its
    end-to-end latency (within 1 us)."""
    from rnb_tpu_torch.parse_utils import attribute, read_meta, trace_problems
    from rnb_tpu_torch.trace import track_names, validate_trace
    label = TRACED
    path = os.path.join(result.log_dir, "trace.json")
    check(os.path.isfile(path), "%s: no trace.json" % label)
    problems = validate_trace(path)
    check(not problems, "%s: trace.json: %s" % (label, problems[:5]))
    meta = read_meta(os.path.join(result.log_dir, "log-meta.txt"))
    problems = trace_problems(result.log_dir, meta)
    check(not problems, "%s: %s" % (label, "; ".join(problems)))
    report = attribute(result.log_dir, num_skips=0)
    check(report["requests"] == result.num_completed
          and report["max_residual_ms"] <= 1e-3,
          "%s: phases of %d requests, worst residual %g ms"
          % (label, report["requests"], report["max_residual_ms"]))
    print("path %s: Trace: events=%d dropped=%d; tracks %s; phases of %d "
          "requests sum to their latency within %.3g ms: %s"
          % (label, result.trace_events, result.trace_dropped,
             json.dumps(track_names(path)), report["requests"],
             report["max_residual_ms"],
             json.dumps({k: round(v["mean_ms"], 3)
                         for k, v in report["phases"].items()})))


def critpath_copy(data_root) -> str:
    """The traced cell with the root ``critpath`` key: a temporary copy
    beside the dataset."""
    with open(os.path.join(HERE, TRACED)) as f:
        raw = json.load(f)
    raw["critpath"] = {"enabled": True}
    path = os.path.join(data_root, CRITPATH + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def check_metrics_run(result):
    """The metrics run: its logs pass the port's footings of the plane
    (snapshots, counters monotone, histogram sums, the final snapshot
    against ``Staging:`` and ``Slo:``, ``metrics.prom``, every flight
    dump valid and named), and the counts this run must show."""
    from rnb_tpu_torch.parse_utils import (load_metrics, metrics_problems,
                                           read_meta)
    label = METRICS
    meta = read_meta(os.path.join(result.log_dir, "log-meta.txt"))
    problems = metrics_problems(result.log_dir, meta)
    check(not problems, "%s: %s" % (label, "; ".join(problems[:5])))
    snapshots = load_metrics(result.log_dir)
    # devobs off: no Compute:/Memory: line, no capture file
    check(not {"Compute", "Memory"} & set(meta["lines"])
          and result.compute_stages == result.memory_owners == 0
          and not [name for name in os.listdir(result.log_dir)
                   if name.startswith("devobs-capture-")],
          "%s: devobs output without the devobs key" % label)
    check(result.metrics_snapshots >= 2 and result.metrics_dumps >= 1,
          "%s: %d snapshots, %d dumps" % (label, result.metrics_snapshots,
                                          result.metrics_dumps))
    final = snapshots[-1]["counters"]
    check(final.get("client.requests") == result.num_requests,
          "%s: final client.requests %s, the client created %d"
          % (label, final.get("client.requests"), result.num_requests))
    check(result.slo_tracked == result.num_completed
          and result.slo_within == result.slo_tracked
          and result.slo_missed == 0 and result.slo_burn_max_milli == 0,
          "%s: Slo tracked=%d within=%d missed=%d burn_max_milli=%d for %d "
          "completions" % (label, result.slo_tracked, result.slo_within,
                           result.slo_missed, result.slo_burn_max_milli,
                           result.num_completed))
    hists = snapshots[-1]["histograms"]
    print("path %s: Metrics: snapshots=%d series=%d dumps=%d triggers=%d; "
          "Slo: tracked=%d within=%d; client.requests=%d; files %s; "
          "exec1.model_call n=%d mean %.3f ms; exec1.device_sync n=%d"
          % (label, result.metrics_snapshots, result.metrics_series,
             result.metrics_dumps, result.metrics_triggers,
             result.slo_tracked, result.slo_within,
             final["client.requests"], sorted(os.listdir(result.log_dir)),
             hists["exec1.model_call"]["count"],
             hists["exec1.model_call"]["sum_ms"]
             / max(1, hists["exec1.model_call"]["count"]),
             hists.get("exec1.device_sync", {}).get("count", 0)))


def devobs_watermark_copy(data_root) -> str:
    """The devobs cell with a 1 MiB watermark: a temporary copy beside
    the dataset."""
    with open(os.path.join(HERE, DEVOBS)) as f:
        raw = json.load(f)
    raw["devobs"]["watermark_mb"] = 1
    path = os.path.join(data_root, DEVOBS_WATERMARK + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def read_capture(path):
    """``(trigger, [(t0_ns, t1_ns, plane, op name)])`` of one
    ``devobs-capture-<n>.txt``."""
    trigger, ops = None, []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                parts = line.split()
                if "trigger" in parts:
                    trigger = parts[parts.index("trigger") + 1]
                continue
            t0, t1, plane, name = line.rstrip("\n").split(" ", 3)
            ops.append((int(t0), int(t1), plane, name))
    return trigger, ops


def device_flows(path):
    """``(device tracks, flow events bound to them)`` of a trace.json."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tids = {e["tid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "thread_name"
            and e["args"]["name"].startswith("device:")}
    flows = sum(1 for e in events
                if e.get("ph") in ("s", "t", "f") and e.get("tid") in tids)
    return sorted(tids.values()), flows


def check_devobs_run(label, result, config_path):
    """A devobs run: its logs pass the port's checks (the Compute: and
    Memory: footings among them); each stage's flops_per_row is the
    config walk's; tflops_milli and mfu_e4 are what the completed clips,
    the window and the card's peak give, to the digit; the ledger
    reconciles against the allocator. Run A (the config as shipped, one
    forced capture): a capture holds device ops on /device:GPU:0, the
    yuv420 kernel among them, and trace.json a device track with a flow
    bound to it. Run B (the 1 MiB watermark): a watermark hit, a capture
    it triggered and a flight dump. Prints the figures PERF.md keeps."""
    import torch
    from rnb_tpu_torch.devobs import flops_per_clip_for_config
    from rnb_tpu_torch.models.r2p1d.flops import peak_tflops_for
    from rnb_tpu_torch.parse_utils import kernel_families, summarize
    problems = summarize(result.log_dir)["footing_problems"]
    check(not problems, "%s: %s" % (label, "; ".join(problems[:5])))
    with open(config_path) as f:
        per_clip = flops_per_clip_for_config(json.load(f))
    detail = result.compute_stage_detail
    check(list(detail) == ["step1"]
          and detail["step1"]["flops_per_row"] == per_clip
          and result.compute_rows == detail["step1"]["rows"]
          == result.clips_completed,
          "%s: Compute stages %s against %s FLOPs a clip and %d clips"
          % (label, detail, per_clip, result.clips_completed))
    peak = peak_tflops_for(torch.cuda.get_device_name(0))
    check(peak is not None, "%s: no peak for %s"
          % (label, torch.cuda.get_device_name(0)))
    tflops = result.clips_completed / result.total_time_s * per_clip / 1e12
    want = (int(round(round(tflops, 3) * 1000)),
            int(round(round(tflops / peak, 4) * 10000)))
    check((result.compute_tflops_milli, result.compute_mfu_e4) == want,
          "%s: tflops_milli=%d mfu_e4=%d, the clips, window and peak give "
          "%s" % (label, result.compute_tflops_milli, result.compute_mfu_e4,
                  want))
    check(result.memory_reconciled == 1 and result.memory_live_bytes > 0,
          "%s: Memory: live_bytes=%d reconciled=%d"
          % (label, result.memory_live_bytes, result.memory_reconciled))
    files = sorted(name for name in os.listdir(result.log_dir)
                   if name.startswith("devobs-capture-"))
    check(len(files) == result.compute_captures,
          "%s: %d capture files, Compute: captures=%d"
          % (label, len(files), result.compute_captures))
    captures = [read_capture(os.path.join(result.log_dir, name))
                for name in files]
    tracks, flows = device_flows(os.path.join(result.log_dir, "trace.json"))
    if label == DEVOBS:
        check(result.memory_watermark_hits == 0,
              "%s: %d watermark hits under 256 MiB"
              % (label, result.memory_watermark_hits))
        check(any(plane == "/device:GPU:0" and YUV420_SYMBOL in name
                  for _trigger, ops in captures
                  for _t0, _t1, plane, name in ops),
              "%s: no capture holds %s on /device:GPU:0 (captures %s)"
              % (label, YUV420_SYMBOL, files))
        check(tracks and flows >= 1, "%s: trace.json device tracks %s, "
              "%d flow events on them" % (label, tracks, flows))
    else:
        check(result.memory_watermark_hits >= 1
              and "memory_watermark" in [t for t, _ops in captures]
              and any(name.startswith("flight-")
                      for name in os.listdir(result.log_dir)),
              "%s: watermark_hits=%d, capture triggers %s, files %s"
              % (label, result.memory_watermark_hits,
                 [t for t, _ops in captures],
                 sorted(os.listdir(result.log_dir))))
    # the captures' device time by kernel, as shares of their spans
    kernels, span_ns = {}, 0
    for _trigger, ops in captures:
        ops = [op for op in ops if op[2].startswith("/device:")]
        if ops:
            span_ns += max(t1 for _t0, t1, _p, _n in ops) - min(
                t0 for t0, _t1, _p, _n in ops)
        for t0, t1, _plane, name in ops:
            entry = kernels.setdefault(name, {"device_us": 0.0, "count": 0})
            entry["device_us"] += (t1 - t0) / 1e3
            entry["count"] += 1
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["device_us"])[:10]
    # one yuv420 launch a forward: the forwards the captures hold
    forwards = sum(entry["count"] for name, entry in kernels.items()
                   if YUV420_SYMBOL in name)
    step1 = detail["step1"]
    print("devobs %s: %d requests, %d clips in %.4f s; Compute: tflops_milli"
          "=%d mfu_e4=%d (job MFU %.4f), step1 tflops_busy %s mfu_busy %s "
          "(busy %d us, %d dispatches); Memory: total_bytes=%d peak_bytes=%d "
          "owners %s live_bytes=%d reconciled=%d watermark_hits=%d; "
          "captures %d (skipped %d; triggers %s; ops %s); trace device "
          "tracks %s with %d flow events; card: %s"
          % (label, result.num_completed, result.clips_completed,
             result.total_time_s, result.compute_tflops_milli,
             result.compute_mfu_e4, result.compute_mfu_e4 / 1e4,
             step1["tflops_busy"], step1["mfu_busy"], step1["busy_us"],
             step1["dispatches"], result.memory_total_bytes,
             result.memory_peak_bytes,
             json.dumps({k: v["bytes"] for k, v in
                         result.memory_owner_detail.items()},
                        sort_keys=True),
             result.memory_live_bytes, result.memory_reconciled,
             result.memory_watermark_hits, result.compute_captures,
             result.compute_captures_skipped,
             [t for t, _ops in captures], [len(ops) for _t, ops in captures],
             tracks, flows, nvidia_smi_line()))
    print("devobs %s: device ops over %.3f ms of capture spans, %d "
          "forwards; kernel families %s; top kernels [name, launches, "
          "launches a forward, share of the spans] %s"
          % (label, span_ns / 1e6, forwards,
             json.dumps(kernel_families(kernels)),
             json.dumps([(name[:100], entry["count"],
                          round(entry["count"] / forwards, 2)
                          if forwards else None,
                          round(entry["device_us"] * 1e3 / span_ns, 4)
                          if span_ns else None)
                         for name, entry in top])))


def check_autotune_run(label, result):
    """An autotune run: the controller decided, its emissions are the
    loader's, it chose only warmed buckets, and its line's invariants
    hold. The immediate/held split is printed, not asserted."""
    from rnb_tpu_torch.parse_utils import autotune_problems, read_meta
    meta = read_meta(os.path.join(result.log_dir, "log-meta.txt"))
    problems = autotune_problems(meta)
    check(not problems, "%s: %s" % (label, "; ".join(problems)))
    staging = meta["staging"][0]
    loader = staging["staged_batches"] + staging["copied_batches"]
    check(result.autotune_decisions > 0
          and result.autotune_emissions == loader,
          "%s: %d decisions, %d controller emissions, %d loader emissions"
          % (label, result.autotune_decisions, result.autotune_emissions,
             loader))
    check(set(result.autotune_bucket_counts) <= AUTOTUNE_BUCKETS,
          "%s: buckets %s chosen, only %s are warmed"
          % (label, result.autotune_bucket_counts, AUTOTUNE_BUCKETS))
    print("path %s: Autotune: decisions=%d immediate=%d held=%d "
          "emissions=%d buckets %s; p50 %s ms, p99 %s ms"
          % (label, result.autotune_decisions, result.autotune_immediate,
             result.autotune_held, result.autotune_emissions,
             json.dumps(result.autotune_bucket_counts, sort_keys=True),
             result.p50_latency_ms, result.p99_latency_ms))


def check_critpath_run(result):
    """The critpath run: every request's blocking chain sums to its
    end-to-end latency within 1 us, ``Critpath:`` covers the completions
    past the summary's skips and names a step of the pipeline, and the
    line and the ``# critpath`` trailer re-derive from the table."""
    from rnb_tpu_torch import critpath
    from rnb_tpu_torch.parse_utils import (critpath_problems, read_meta,
                                           read_table, read_trailers)
    from rnb_tpu_torch.runner import NUM_SUMMARY_SKIPS
    label = CRITPATH
    meta = read_meta(os.path.join(result.log_dir, "log-meta.txt"))
    problems = critpath_problems(result.log_dir, meta)
    check(not problems, "%s: %s" % (label, "; ".join(problems)))
    worst, trailer = 0.0, None
    for name in os.listdir(result.log_dir):
        if not name.endswith("-0.txt"):
            continue
        path = os.path.join(result.log_dir, name)
        keys, rows = read_table(path)
        for row in rows:
            chain = critpath.blocking_chain(dict(zip(keys, row)))
            worst = max(worst, abs(sum(ms for _c, _s, ms in chain)
                                   - 1e3 * (max(row) - min(row))))
        trailer = read_trailers(path).get("critpath")
    check(worst <= 1e-3, "%s: a blocking chain misses its request's "
          "latency by %g ms" % (label, worst))
    check(trailer is not None, "%s: no '# critpath' trailer" % label)
    check(result.critpath_requests
          == result.num_completed - NUM_SUMMARY_SKIPS,
          "%s: Critpath requests=%d for %d completions" % (
              label, result.critpath_requests, result.num_completed))
    check(result.critpath_bound_step in (0, 1),
          "%s: bound_step %d" % (label, result.critpath_bound_step))
    print("path %s: Critpath: requests=%d segments=%d bound_step=%d "
          "bound_vps_milli=%d; chains sum to latency within %.3g ms; "
          "stages %s; trailer %s"
          % (label, result.critpath_requests, result.critpath_segments,
             result.critpath_bound_step, result.critpath_bound_vps_milli,
             worst, json.dumps(result.critpath_stage_detail,
                               sort_keys=True), json.dumps(trailer)))


def check_unfused_run(label, result, sink, whole_sink):
    """The unfused runs' own checks against the two-step run of the same
    requests (``whole_sink``): one ragged-normalize launch per emission,
    the split pipeline's logits, the batcher's fused batches, the single
    step's class ids."""
    import numpy as np
    from rnb_tpu_torch.parse_utils import read_table
    if label == WHOLE_RAGGED:
        launched = result.window_launches["ragged_normalize_u8"]
        check(launched == result.num_completed,
              "%s: %d ragged_normalize_u8 launches for %d emissions"
              % (label, launched, result.num_completed))
    if label in (WHOLE_RAGGED, SPLIT, RNB):
        worst = 0.0
        for rid, (video, logits, _stamps) in sorted(sink.items()):
            check(video == whole_sink[rid][0], "%s request %d served %s, "
                  "the two-step run %s" % (label, rid, video,
                                           whole_sink[rid][0]))
            worst = max(worst, float(np.abs(
                logits - whole_sink[rid][1]).max()))
        check(worst <= TWO_STEP_ATOL, "%s: logits differ from the two-step "
              "run's by %g > %g" % (label, worst, TWO_STEP_ATOL))
        print("path %s: logits within %g of the two-step run's (bound %g)"
              % (label, worst, TWO_STEP_ATOL))
    if label == RNB:
        tables = [n for n in os.listdir(result.log_dir)
                  if n.endswith("-0.txt")]
        fused = {}
        for name in tables:
            keys, rows = read_table(os.path.join(result.log_dir, name))
            col = keys.index("inference2_start")
            for row in rows:
                fused[row[col]] = fused.get(row[col], 0) + 1
        check(max(fused.values()) == RNB_BATCH,
              "%s: no emission fused %d requests (sizes %s)"
              % (label, RNB_BATCH, sorted(fused.values())))
        print("path %s: %d emissions for %d requests, %d of them fused %d"
              % (label, len(fused), result.num_completed,
                 sum(n == RNB_BATCH for n in fused.values()), RNB_BATCH))
    if label == NOPIPELINE:
        held = 0
        for rid, (video, pred, _stamps) in sorted(sink.items()):
            check(video == whole_sink[rid][0], "%s request %d served "
                  "another video than the two-step run" % (label, rid))
            total = whole_sink[rid][1].sum(axis=0)
            top2 = np.sort(total)[-2:]
            # the batch shapes differ (max shape here, row buckets
            # there): hold the class id past the bf16 margin
            clips = whole_sink[rid][1].shape[0]
            if top2[1] - top2[0] > 2 * CLASS_ID_ATOL * clips:
                check(pred == int(total.argmax()), "%s request %d: class "
                      "id %d, the two-step run's logits say %d"
                      % (label, rid, pred, int(total.argmax())))
                held += 1
        check(held >= len(sink) // 4, "%s: only %d of %d class ids could "
              "be held to the two-step run" % (label, held, len(sink)))
        print("path %s: %d of %d class ids equal the argmax of the "
              "two-step run's summed logits (the rest have a top-2 "
              "margin inside the bound)" % (label, held, len(sink)))


def check_cache_run(label, result, sink):
    """The Zipf runs' own checks: the ``Pages:`` footings, that the
    cache answered, and that every feature hit's logits are bitwise
    its video's first serving's. Returns the rid of a clip-page hit
    (None when the run had none)."""
    from rnb_tpu_torch.parse_utils import footing_problems, read_meta
    meta = read_meta(os.path.join(result.log_dir, "log-meta.txt"))
    problems = footing_problems(meta)
    check(not problems, "%s: %s" % (label, "; ".join(problems)))
    pages = result.pages
    if label == PAGED:
        check(pages["feature_hits"] > 0, "%s: no feature hit" % label)
    elif label == FEATURES_OFF:
        check(pages["gathers"] > 0 and pages["gather_rows"] > 0,
              "%s: no clip-page gather" % label)
    else:
        check(result.cache_hits > 0, "%s: no cache hit" % label)
    first = {}
    for rid in sorted(sink):
        video, logits, stamps = sink[rid]
        if not stamps["feature_hit"]:
            first.setdefault(video, rid)
    feature_hits = 0
    for rid, (video, logits, stamps) in sorted(sink.items()):
        if stamps["feature_hit"]:
            feature_hits += 1
            check(video in first and logits.tobytes()
                  == sink[first[video]][1].tobytes(),
                  "%s request %d: feature-hit logits are not bitwise those "
                  "of request %s, its video's first serving"
                  % (label, rid, first.get(video)))
    page_hits = [rid for rid, (_v, _l, st) in sorted(sink.items())
                 if st["cache_hit"] and label != BLOB]
    print("path %s: Cache: %s; Pages: %s; %d feature hits bitwise equal "
          "to their first serving; %d clip-page hits"
          % (label, json.dumps({k: getattr(result, "cache_" + k) for k in (
              "hits", "misses", "inserts", "evictions", "coalesced")}),
             json.dumps(pages, sort_keys=True), feature_hits,
             len(page_hits)))
    return page_hits[0] if page_hits else None


class RetryRecorder:
    """While a chaos run serves, keep two copies of each step-1 input
    that carries a planned transient request: one as the executor hands
    it to the stage call, before the plan's fault fires on the first
    attempt, and one as the retry calls the runner (the fault fires
    before the call, so the runner sees only the retry). ``firings``
    counts the retries; :meth:`check` holds each retry's input bitwise
    to its first attempt's, replays that input on the run's captured
    graph afterwards, fault-free, and holds the retried requests' served
    logits to the replay bitwise."""

    def __init__(self, transient_ids):
        import torch
        from rnb_tpu_torch import runner as executor
        from rnb_tpu_torch.models.r2p1d.model import R2P1DRunner
        from rnb_tpu_torch.telemetry import cards_of
        self.cls, self.executor = R2P1DRunner, executor
        self.transient = set(transient_ids)
        self.calls = []
        self.first = {}
        self._original = R2P1DRunner.__call__
        self._call_stage = executor._call_stage
        recorder = self

        def planned(time_card):
            return [tc for tc in cards_of(time_card)
                    if tc.id in recorder.transient]

        def call_stage(ctx, model, payload, non_tensors, time_card, *rest):
            if isinstance(model, R2P1DRunner) and planned(time_card):
                # the transfer's copies may still be landing on another
                # stream: the copy is of what the stage is handed
                torch.cuda.synchronize()
                recorder.first[id(time_card)] = payload[0].data.clone()
            return recorder._call_stage(ctx, model, payload, non_tensors,
                                        time_card, *rest)

        def recording(runner, tensors, non_tensors, time_card):
            cards = planned(time_card)
            kept = tensors[0].data.clone() if cards else None
            out = recorder._original(runner, tensors, non_tensors,
                                     time_card)
            if cards:
                recorder.calls.append((
                    runner, recorder.first.pop(id(time_card), None), kept,
                    int(tensors[0].valid),
                    [(tc.id, tc.row0, int(tc.num_clips)) for tc in cards]))
            return out

        R2P1DRunner.__call__ = recording
        executor._call_stage = call_stage

    def close(self) -> None:
        self.cls.__call__ = self._original
        self.executor._call_stage = self._call_stage

    @property
    def firings(self) -> int:
        return len(self.calls)

    @property
    def retried(self) -> list:
        return sorted(rid for *_rest, cards in self.calls
                      for rid, _row0, _n in cards)

    def check(self, label, sink) -> int:
        """Each retry read its first attempt's input and each retried
        request's served logits are bitwise the replay's; returns the
        requests held."""
        import numpy as np
        import torch
        held = 0
        for runner, first, x, valid, cards in self.calls:
            check(first is not None and torch.equal(first, x),
                  "%s: the retry of requests %s read another input than "
                  "their first attempt" % (label, [c[0] for c in cards]))
            out = runner.forward(first, valid).to(torch.float32).cpu()
            out = out.numpy()
            for rid, row0, n in cards:
                check(rid in sink, "%s: retried request %d was not served"
                      % (label, rid))
                check(np.array_equal(sink[rid][1], out[row0:row0 + n]),
                      "%s: retried request %d's logits differ from the "
                      "fault-free replay of its emission" % (label, rid))
                held += 1
        return held


class TakeRecorder:
    """While a chaos run serves, note each fused take that lost a
    request to a failed decode: ``R2P1DFusingLoader._wait_contained``
    returning False inside ``_emit_take``. ``shrunk`` holds, per such
    take, the failed requests' ids and the survivors'."""

    def __init__(self):
        from rnb_tpu_torch.models.r2p1d.model import R2P1DFusingLoader
        self.cls = R2P1DFusingLoader
        self._emit_take = R2P1DFusingLoader._emit_take
        self._wait = R2P1DFusingLoader._wait_contained
        self.shrunk = []
        self._take = None
        recorder = self

        def emit_take(loader):
            recorder._take = []
            try:
                return recorder._emit_take(loader)
            finally:
                take, recorder._take = recorder._take, None
                failed = [rid for ids, ok in take if not ok for rid in ids]
                if failed:
                    recorder.shrunk.append((failed, [
                        rid for ids, ok in take if ok for rid in ids]))

        def wait_contained(loader, rec):
            ok = recorder._wait(loader, rec)
            if recorder._take is not None:
                recorder._take.append(([tc.id for tc in rec.cards], ok))
            return ok

        R2P1DFusingLoader._emit_take = emit_take
        R2P1DFusingLoader._wait_contained = wait_contained

    def close(self) -> None:
        self.cls._emit_take = self._emit_take
        self.cls._wait_contained = self._wait


def check_chaos_run(label, result, sink, recorder, takes, broken_ids,
                    stages):
    """A chaos run: its logs pass the port's parse_utils (the fault
    ledger's footings and cross-feet included); the dead letters are the
    plan's permanent ids (in bulk all of them) and requests that drew the
    broken video (in bulk the first of them), which nothing serves; each
    request that left a fused take on a failed decode is such a dead
    letter and the take's survivors are not; the retries are the plan's
    transient firings, each retry read its first attempt's input and its
    logits are bitwise the fault-free replay's; a deadline shed at
    least, the burst's client sheds; no capture and no new signature
    after the warm-ups. Returns the takes that lost a broken decode and
    emitted survivors that were all served."""
    from rnb_tpu_torch.parse_utils import read_dead_letters, summarize
    from rnb_tpu_torch.tools import chaos
    problems = summarize(result.log_dir)["footing_problems"]
    check(not problems, "%s: %s" % (label, "; ".join(problems[:5])))
    letters = read_dead_letters(result.log_dir)
    planned = sorted(rid for rid, _step, reason in letters
                     if reason == "injected-permanent")
    corrupt = sorted(rid for rid, _step, reason in letters
                     if reason == "corrupt-video")
    check(all(step == 0 for _rid, step, _reason in letters)
          and len(planned) + len(corrupt) == len(letters)
          and set(planned) <= set(chaos.PERMANENT_IDS)
          and (label != CHAOS or planned == sorted(chaos.PERMANENT_IDS)),
          "%s: dead letters %s, the plan's permanent ids %s"
          % (label, letters, chaos.PERMANENT_IDS))
    check(set(corrupt) <= set(broken_ids)
          and not set(broken_ids) & set(sink)
          and (label != CHAOS or broken_ids[0] in corrupt),
          "%s: of the broken video's requests %s, %s were dead-lettered "
          "as corrupt-video and %s served"
          % (label, broken_ids, corrupt, sorted(set(broken_ids) & set(sink))))
    served_takes = 0
    for failed, kept in takes.shrunk:
        check(set(failed) <= set(corrupt)
              and not set(kept) & {rid for rid, _s, _r in letters},
              "%s: a take lost requests %s (dead letters %s) and kept %s"
              % (label, failed, letters, kept))
        served_takes += bool(kept) and set(kept) <= set(sink)
    for step, sigs in result.compiles.items():
        check(sigs["steady_new"] == 0, "%s: %s saw %d new signature(s) "
              "after the warm-ups (takes that lost a decode: %s)"
              % (label, step, sigs["steady_new"], takes.shrunk))
    check(result.num_retries == recorder.firings,
          "%s: %d retries for %d transient firings"
          % (label, result.num_retries, recorder.firings))
    check(label != CHAOS or recorder.firings >= 1,
          "%s: no planned transient fired" % label)
    check(result.deadline_expired >= 1 and result.deadline_sites,
          "%s: no request expired (Deadline: expired=%d)"
          % (label, result.deadline_expired))
    check(label != CHAOS or result.deadline_sites.get(
        "step1_take:deadline_expired", 0) >= 1, "%s: nothing expired in "
          "step 1's queue behind its stall (%s)"
          % (label, result.deadline_sites))
    check(label != CHAOS_BURST or result.shed_sites.get(
        "filename_queue", 0) >= 1, "%s: the client shed nothing (%s)"
          % (label, result.shed_sites))
    from rnb_tpu_torch.models.r2p1d.model import R2P1DRunner
    for step_idx, stage in stages:
        if isinstance(stage, R2P1DRunner):
            # the retries replayed; a capture after the warm-ups would
            # have grown the set
            check(len(stage._graphs) == len(stage.graph_keys())
                  == stage.graph_stats["graphs"],
                  "%s: step %d holds %d graphs for %d warmed keys"
                  % (label, step_idx, len(stage._graphs),
                     len(stage.graph_keys())))
    held = recorder.check(label, sink)
    print("path %s: completed %d + failed %d + shed %d of %d requests the "
          "client created; Faults: num_failed=%d num_shed=%d "
          "num_retries=%d; Failure reasons: %s; Shed sites: %s; Deadline: "
          "budget_ms=%d expired=%d; %d retried request(s) read their first "
          "attempt's input and are bitwise the fault-free replay; the "
          "broken video's requests %s, dead-lettered %s; takes that lost a "
          "decode [failed, kept] %s, %d with every survivor served"
          % (label, result.num_completed, result.num_failed,
             result.num_shed, result.num_requests, result.num_failed,
             result.num_shed, result.num_retries,
             json.dumps(result.failure_reasons, sort_keys=True),
             json.dumps(result.shed_sites, sort_keys=True),
             result.deadline_budget_ms, result.deadline_expired, held,
             broken_ids, corrupt, json.dumps(takes.shrunk), served_takes))
    return served_takes


def operator_actions_copy(data_root) -> str:
    """The operator config with actions allowed, the shipped devobs
    cell's devobs key and the root whatif key: a copy beside the
    dataset."""
    with open(os.path.join(HERE, OPERATOR)) as f:
        raw = json.load(f)
    raw["operator"]["allow_actions"] = True
    raw["devobs"] = dict(OPERATOR_DEVOBS)
    raw["whatif"] = {"enabled": True}
    path = os.path.join(data_root, OPERATOR_ACTIONS + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


class OperatorScraper(threading.Thread):
    """A client of the operator plane while one run serves. It finds the
    run's ``operator.json`` (one not there before the run started), reads
    the bound address from it, polls ``/healthz`` until the measured
    window opens, then makes its requests: for the config as shipped,
    ``GET /healthz``, ``/metrics``, ``/statusz`` and ``/stacks``, a
    ``POST /flight`` (refused: actions are off), ``/statusz`` until a
    metrics snapshot exists and ``GET /whatif?replicas_step1=2`` until
    the model is calibrated; for the actions copy, ``POST /flight`` and
    ``POST /capture``. Each request's route, status, epoch second and
    body are kept."""

    def __init__(self, log_base, label):
        super().__init__(name="operator-scraper", daemon=True)
        self.log_base, self.label = log_base, label
        self.before = set(self._addresses())
        self.calls, self.error, self.address = [], None, None

    def _addresses(self):
        if not os.path.isdir(self.log_base):
            return []
        return [os.path.join(self.log_base, job, "operator.json")
                for job in os.listdir(self.log_base)
                if os.path.isfile(os.path.join(self.log_base, job,
                                               "operator.json"))]

    def _call(self, route, method="GET"):
        import urllib.error
        import urllib.request
        request = urllib.request.Request(
            self.address["url"] + route, method=method,
            data=b"" if method == "POST" else None)
        try:
            with urllib.request.urlopen(request, timeout=30) as r:
                status, body = r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            status, body = e.code, e.read().decode()
        self.calls.append((method + " " + route, status, time.time(), body))
        return status, body

    def run(self):
        try:
            deadline = time.time() + SCRAPER_WAIT_S
            while self.address is None:
                check(time.time() < deadline, "%s: no operator.json"
                      % self.label)
                new = sorted(set(self._addresses()) - self.before)
                if new:
                    with open(new[0]) as f:
                        self.address = json.load(f)
                else:
                    time.sleep(0.05)
            while True:
                check(time.time() < deadline, "%s: the window never "
                      "opened" % self.label)
                _status, body = self._call("/healthz")
                if json.loads(body)["window_s"] > 0:
                    break
                time.sleep(0.1)
            if self.label == OPERATOR:
                for route in ("/metrics", "/statusz", "/stacks"):
                    self._call(route)
                self._call("/flight", "POST")
                while "snapshot seq" not in self._call("/statusz")[1]:
                    time.sleep(0.05)
                # calibrated once a snapshot holds a completed dispatch
                # of each step
                while not json.loads(self._call(
                        "/whatif?replicas_step1=2")[1])["calibrated"]:
                    time.sleep(0.05)
            else:
                self._call("/flight", "POST")
                self._call("/capture", "POST")
        except Exception as e:  # read by check_operator_run
            self.error = e


def check_operator_run(label, result, scraper):
    """An operator run: its logs pass the port's parse_utils (the
    ``Operator:`` ledger against ``operator.json``, ``stacks.folded``
    against ``Stacks:``, ``Whatif:`` recomputed from ``metrics.jsonl``
    and the config copy); the server bound 127.0.0.1 on an ephemeral
    port. As shipped: every GET answered 200 inside the measured window,
    the POST 403, ``Operator: scrapes >= 5 denied == 1 errors == 0``,
    ``/metrics`` the Prometheus exposition, ``/whatif`` a calibrated
    answer and ``stacks.folded`` a stack of the runner thread. The
    actions copy: both POSTs accepted, a valid ``flight-<n>.json``, a
    ``devobs-capture-<n>.txt`` from the operator's trigger holding the
    yuv420 kernel on ``/device:GPU:0``, and ``Whatif: calibrated=1``.
    Prints the requests and the ledgers."""
    from rnb_tpu_torch.parse_utils import read_folded, read_meta, summarize
    from rnb_tpu_torch.trace import validate_trace
    scraper.join(timeout=60)
    check(not scraper.is_alive() and scraper.error is None,
          "%s: the scraper failed: %r" % (label, scraper.error))
    problems = summarize(result.log_dir)["footing_problems"]
    check(not problems, "%s: %s" % (label, "; ".join(problems[:5])))
    with open(os.path.join(result.log_dir, "operator.json")) as f:
        record = json.load(f)
    check(record["host"] == "127.0.0.1" and record["port"] > 0
          and record["port"] == scraper.address["port"],
          "%s: operator.json %s" % (label, record))
    start, end = read_meta(os.path.join(result.log_dir,
                                        "log-meta.txt"))["window"]
    codes = {route: status for route, status, _t, _body in scraper.calls}
    ledger = (result.operator_scrapes, result.operator_actions,
              result.operator_denied, result.operator_errors)
    if label == OPERATOR:
        gets = [c for c in scraper.calls if c[0].startswith("GET")]
        check(all(status == 200 for _r, status, _t, _b in gets)
              and codes["POST /flight"] == 403,
              "%s: %s" % (label, codes))
        # every request came back before the window closed
        late = [(r, round(t - end, 3)) for r, _s, t, _b in scraper.calls
                if t > end]
        check(not late, "%s: requests after the window closed (seconds "
              "past it): %s" % (label, late))
        check(result.operator_scrapes >= 5 and result.operator_denied == 1
              and result.operator_errors == 0
              and result.operator_actions == 0,
              "%s: Operator: scrapes=%d actions=%d denied=%d errors=%d"
              % ((label,) + ledger))
        body = dict((r, b) for r, _s, _t, b in scraper.calls)
        check("# TYPE rnb_client_requests counter" in body["GET /metrics"],
              "%s: /metrics is no exposition" % label)
        whatif = json.loads(body["GET /whatif?replicas_step1=2"])
        check(whatif["calibrated"] is True and whatif["base_vps"] > 0
              and whatif["spec"] == {"replicas": {"step1": 2}},
              "%s: /whatif %s" % (label, whatif))
        stacks, total, roles, _bad = read_folded(
            os.path.join(result.log_dir, "stacks.folded"))
        check("runner-s1-g0-i0" in roles and total == result.stacks_total,
              "%s: stacks.folded roles %s" % (label, sorted(roles)))
    else:
        check(codes["POST /flight"] == 200 and codes["POST /capture"] == 200
              and result.operator_actions == 2
              and result.operator_errors == 0
              and result.operator_denied == 0,
              "%s: %s, Operator: scrapes=%d actions=%d denied=%d errors=%d"
              % ((label, codes) + ledger))
        flights = sorted(name for name in os.listdir(result.log_dir)
                         if name.startswith("flight-"))
        check(flights and not any(validate_trace(os.path.join(
            result.log_dir, name)) for name in flights),
              "%s: flight dumps %s" % (label, flights))
        captures = {}
        for name in os.listdir(result.log_dir):
            if name.startswith("devobs-capture-"):
                captures[name] = read_capture(os.path.join(result.log_dir,
                                                           name))
        check(any(trigger == "operator" and any(
            plane == "/device:GPU:0" and YUV420_SYMBOL in op
            for _t0, _t1, plane, op in ops)
            for trigger, ops in captures.values()),
              "%s: no operator capture holds %s on /device:GPU:0 (%s)"
              % (label, YUV420_SYMBOL, {k: (t, len(o)) for k, (t, o)
                                        in captures.items()}))
        check(result.whatif_calibrated == 1 and result.whatif_stages == 2,
              "%s: Whatif: stages=%d calibrated=%d" % (
                  label, result.whatif_stages, result.whatif_calibrated))
    print("operator %s: requests %s; Operator: scrapes=%d actions=%d "
          "denied=%d errors=%d; Stacks: samples=%d threads=%d folded=%d "
          "total=%d; Whatif: stages=%d calibrated=%d pred_vps_milli=%d "
          "bottleneck_step=%d; window %.3f s"
          % ((label, [(r, st, round(t - start, 3))
                      for r, st, t, _b in scraper.calls[-8:]])
             + ledger + (result.stacks_samples, result.stacks_threads,
                         result.stacks_folded, result.stacks_total,
                         result.whatif_stages, result.whatif_calibrated,
                         result.whatif_pred_vps_milli,
                         result.whatif_bottleneck_step,
                         result.total_time_s)))


def first_devices(log_dir):
    """The device each request's step 0 ran on, from the timing tables
    (a remote request's is the peer's)."""
    devices = []
    for name in sorted(os.listdir(log_dir)):
        if "-group" not in name:
            continue
        with open(os.path.join(log_dir, name)) as f:
            lines = [ln.split() for ln in f.read().splitlines()
                     if ln.strip() and not ln.startswith("#")]
        if lines:
            col = lines[0].index("device0")
            devices += [ln[col] for ln in lines[1:]]
    return devices


def check_netedge_run(label, result, sink, rows, config_path):
    """N1 (the in-process twin) and N2 (the loopback cell as shipped):
    the port's parse_utils checks green. N1 carries no edge at all: no
    ``Net:`` or ``Health:`` line, no frame read. N2 served every request
    through the peer: remote == requests, nothing local, no net error,
    no reconnect, every REQ acked once, the DATA rows whole packed dct
    frames (the completed clips' frames x 9,408 B), step 0 on cuda:0
    for every request (the peer did not fall back to the CPU), and the
    rows each sampled DATA frame carried bitwise the in-process loader's
    emission for the same video and clip starts. Returns N2's figures."""
    import torch
    from rnb_tpu_torch.config import load_config
    from rnb_tpu_torch.devices import DeviceSpec
    from rnb_tpu_torch.parse_utils import summarize
    from rnb_tpu_torch.telemetry import TimeCard
    from rnb_tpu_torch.utils.class_utils import load_class
    problems = summarize(result.log_dir)["footing_problems"]
    check(not problems, "%s: %s" % (label, "; ".join(problems[:5])))
    with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
        heads = {line.split(":")[0] for line in f.read().splitlines()}
    videos = result.num_videos
    if label == NETEDGE_OFF:
        check(not heads & {"Net", "Net errors", "Health", "Health lanes"}
              and result.net_frames_sent == 0 and result.health_lanes == 0
              and all(v is None for v in rows.values()),
              "%s: the disabled edge left a trace: %s" % (label, sorted(
                  heads & {"Net", "Net errors", "Health", "Health lanes"})))
        return None
    check(result.net_remote == videos and result.net_local == 0,
          "%s: %d remote and %d local routes for %d requests" % (
              label, result.net_remote, result.net_local, videos))
    check(result.net_err_total == 0 and result.net_reconnects == 0
          and result.net_resends == 0,
          "%s: %d net error(s), %d reconnect(s), %d resend(s)" % (
              label, result.net_err_total, result.net_reconnects,
              result.net_resends))
    check(result.net_frames_sent == result.net_frames_acked == videos
          and result.net_dedup_drops == result.net_dup_arrivals == 0
          and result.net_window_stranded == 0,
          "%s: sent %d, acked %d, dedup %d/%d, stranded %d" % (
              label, result.net_frames_sent, result.net_frames_acked,
              result.net_dedup_drops, result.net_dup_arrivals,
              result.net_window_stranded))
    check(result.net_frame_bytes % DCT_FRAME_BYTES == 0
          and result.net_frame_bytes
          == result.clips_completed * FRAMES * DCT_FRAME_BYTES,
          "%s: %d DATA row bytes for %d clips of %d frames of %d B" % (
              label, result.net_frame_bytes, result.clips_completed,
              FRAMES, DCT_FRAME_BYTES))
    devices = first_devices(result.log_dir)
    check(len(devices) == videos and set(devices) == {"cuda:0"},
          "%s: step 0 ran on %s" % (label, sorted(set(devices))))
    config = load_config(config_path, "cuda")
    step = config.steps[0]
    loader = load_class(step.model)(DeviceSpec(0, "cuda"),
                                    **step.kwargs_for_group(0))
    sampled = sorted(rid for rid, got in rows.items() if got is not None)
    check(sampled == sorted(rows), "%s: no DATA rows for requests %s"
          % (label, sorted(set(rows) - set(sampled))))
    for rid in sampled:
        (batch,), _, _ = loader(None, sink[rid][0], TimeCard(rid))
        want = batch.data[:batch.valid].cpu()
        check(torch.equal(rows[rid], want),
              "%s request %d: the DATA frame's rows differ from the "
              "in-process loader's emission of %s" % (label, rid,
                                                      sink[rid][0]))
    return {"sampled_rows_bitwise": sampled,
            "net_frame_bytes": result.net_frame_bytes,
            "wire_bytes": result.net_wire_bytes,
            "beats": result.net_beats,
            "main_memory": {"allocated": torch.cuda.memory_allocated(0),
                            "peak": torch.cuda.max_memory_allocated(0),
                            "reserved": torch.cuda.memory_reserved(0)}}


def check_netchaos_run(label, result, sink, rows):
    """N3, the chaos copy: ``scripts/netchaos_demo.py``'s contract, word
    for word: the run reached its target and ``--check`` is green; every
    request terminated exactly once (completed + failed + shed == the
    requests); nothing stranded in the window; the dedup ledger balances;
    act 1, the reset was classified and a reconnect survived it; act 2,
    the timeout was classified and the circuit opened before it
    (open_before_timeout == 1); act 3, refused dials were classified and
    exactly one eviction left the lane evicted, by a legal path; the
    fallback served (local >= 1) and so did the wire (remote >= 1); no
    route landed on the open or evicted lane; the wire ledger foots. The
    main process's loader normalized every request it served and none
    the peer served: no fewer launches than local completions, no more
    than local routes."""
    from rnb_tpu_torch.health import legal_path
    from rnb_tpu_torch.parse_utils import summarize
    problems = summarize(result.log_dir)["footing_problems"]
    check(not problems, "%s: --check: %s" % (label, "; ".join(problems[:5])))
    terminated = result.num_completed + result.num_failed + result.num_shed
    lane = result.health_lane_detail.get("0", {})
    for ok, what in (
            (terminated == NETCHAOS_VIDEOS,
             "%d of %d requests terminated (completed+failed+shed)"
             % (terminated, NETCHAOS_VIDEOS)),
            (result.net_window_stranded == 0,
             "%d request(s) stranded in the resend window"
             % result.net_window_stranded),
            (result.net_dedup_drops == result.net_dup_arrivals,
             "dedup ledger out of balance: %d drops vs %d duplicate "
             "arrivals" % (result.net_dedup_drops, result.net_dup_arrivals)),
            (result.net_err_reset >= 1,
             "the injected net_reset was never classified (err_reset=0)"),
            (result.net_reconnects >= 1,
             "the sender never reconnected after the mid-stream reset "
             "(reconnects=0)"),
            (result.net_err_timeout >= 1,
             "the injected net_timeout stall was never classified "
             "(err_timeout=0)"),
            (result.net_open_before_timeout == 1,
             "the circuit did not open before the io timeout detected the "
             "stall (open_before_timeout=%d)"
             % result.net_open_before_timeout),
            (result.net_err_refused >= 1,
             "no refused dials were classified after the fatal peer kill "
             "(err_refused=0)"),
            (result.health_evictions == 1,
             "expected exactly 1 lane eviction, got %d"
             % result.health_evictions),
            (lane.get("state") == "evicted" and legal_path(lane.get("path")),
             "net lane 0 should be evicted by a legal path, detail says %r"
             % (lane,)),
            (result.net_local >= 1,
             "no request ever drained to the in-process fallback (local=0)"),
            (result.net_remote >= 1,
             "no request was ever served remotely (remote=0)"),
            (result.health_routes_after_open == 0,
             "dispatcher routed %d request(s) to the open/evicted net lane"
             % result.health_routes_after_open),
            (result.net_frames_sent == result.net_frames_acked
             + result.net_resent_pending,
             "wire ledger does not foot: %d sent != %d acked + %d pending"
             % (result.net_frames_sent, result.net_frames_acked,
                result.net_resent_pending))):
        check(ok, "%s: %s" % (label, what))
    remote = sorted(rid for rid in sink if rows.get(rid) is not None)
    local = sorted(set(sink) - set(remote))
    launches = result.window_launches["normalize_u8"]
    check(len(local) <= launches <= result.net_local,
          "%s: the main process's loader normalized %d requests; %d "
          "completed locally of %d local routes" % (
              label, launches, len(local), result.net_local))
    return remote, local


def graph_input(runner, rows, seed):
    """A seeded input of one runner's input signature: wire rows on the
    yuv420 and dct paths, normalized frames or a feature map else."""
    import numpy as np
    import torch
    device = torch.device("cuda", 0)
    if runner.pixel_path == "dct":
        return dct_pool(rows, seed).to(device)
    shape = (rows,) + tuple(runner._steady_shape[1:])
    rng = np.random.default_rng(seed)
    if runner.pixel_path == "yuv420":
        return torch.from_numpy(rng.integers(0, 256, shape,
                                             dtype=np.uint8)).to(device)
    dtype = torch.bfloat16 if runner.start_index == 1 else torch.float32
    return torch.from_numpy(rng.uniform(-1, 1, shape).astype(
        np.float32)).to(device=device, dtype=dtype)


def check_graphs(label, result, stages):
    """Every captured graph of every runner of the run replays bitwise
    its eager forward on a seeded input (or, where not bitwise, within
    GRAPH_RTOL with equal argmax: reported); every forward of the window
    was one replay; no signature was new in the window. Returns the
    signatures that were not bitwise."""
    import torch
    from rnb_tpu_torch.models.r2p1d.model import R2P1DRunner
    for step, sigs in result.compiles.items():
        check(sigs["steady_new"] == 0, "%s: %s saw %d new signature(s) in "
              "the window" % (label, step, sigs["steady_new"]))
    check(result.graphs, "%s: no stage captured a graph" % label)
    for step, stats in result.graphs.items():
        calls = (result.compiles[step]["steady_calls"]
                 if step in result.compiles else result.num_completed)
        check(stats["replays"] == calls, "%s: %s replayed %d graphs for %d "
              "forwards" % (label, step, stats["replays"], calls))
    loose = []
    for step_idx, stage in stages:
        runner = getattr(stage, "net", stage)
        if not isinstance(runner, R2P1DRunner):
            continue
        for i, key in enumerate(sorted(runner._graphs, key=repr)):
            ((shape, _dtype), ), tiles = key
            rows = shape[0]
            x = graph_input(runner, rows, seed=1000 * step_idx + i)
            valid = rows if tiles is None else min(
                rows, tiles * runner.ragged_chunk_rows)
            check(runner.graph_key(x, valid) == key, "%s: key %s" % (
                label, key))
            replayed = runner.forward(x, valid)
            eager = runner.eager_forward(x, valid)
            if isinstance(replayed, list):
                # a sharded head's column blocks, in member order
                replayed = torch.cat(replayed, dim=-1)
                eager = torch.cat(eager, dim=-1)
            torch.cuda.synchronize()
            if torch.equal(replayed, eager):
                continue
            err = float((replayed - eager).abs().max())
            scale = float(eager.abs().max())
            same = bool((replayed.argmax(-1) == eager.argmax(-1)).all()) \
                if eager.dim() == 2 else True
            check(err <= GRAPH_RTOL * max(1.0, scale) and same,
                  "%s: step %d graph %s replays %g from its eager forward "
                  "(scale %g, argmax equal %s)" % (label, step_idx, key,
                                                   err, scale, same))
            loose.append((step_idx, key, err))
        runner._graphs.clear()  # free the graphs' memory
    print("path %s graphs: %s; %d not bitwise their eager forward%s"
          % (label, json.dumps(result.graphs, sort_keys=True), len(loose),
             "" if not loose else " " + json.dumps(
                 [[s, repr(k), e] for s, k, e in loose])))
    return loose


def check_shard_run(label, result, sink, stages, counts, shard_runs):
    """A run of the sharding pair: the Shard: lines footed by the port's
    parse_utils, one merge a forward, collective time spent; at degree 2
    the ring kernel launched once a forward (the grouped gather of all
    19 leaves; warm-ups, capture warm-ups and replays) and once a merge,
    and every request's logits bitwise the d1 copy's; at degree 1 no hop
    at all. Returns a summary for the print, with the bytes the stage's
    graph pool holds."""
    from rnb_tpu_torch.models.r2p1d.model import NUM_WARMUPS, R2P1DRunner
    from rnb_tpu_torch.parse_utils import load_metrics, summarize
    (runner,) = [s for _, s in stages if isinstance(s, R2P1DRunner)]
    degree = 2 if label == SHARD_D2_COPY else 1
    check(runner.shard_degree == result.shard_max_degree == degree,
          "%s: degree %d, Shard: max_degree %d" % (
              label, runner.shard_degree, result.shard_max_degree))
    problems = summarize(result.log_dir)["footing_problems"]
    check(not problems, "%s: %s" % (label, "; ".join(problems[:5])))
    check(result.shard_rows == result.clips_completed,
          "%s: Shard: rows=%d for %d clips" % (label, result.shard_rows,
                                               result.clips_completed))
    replays = runner.graph_stats["replays"]
    pool = graph_pool_mib(runner)
    if degree == 1:
        check(result.shard_gathers == 0 and counts["ring_shift"] == 0,
              "%s: %d merges, %d ring hops at degree 1" % (
                  label, result.shard_gathers, counts["ring_shift"]))
        return dict(replays=replays, graph_pool_mib=pool)
    check(result.shard_gathers == replays
          == result.compiles["step1"]["steady_calls"],
          "%s: %d merges for %d replays" % (label, result.shard_gathers,
                                            replays))
    check(result.shard_collective_us > 0, "%s: no collective time" % label)
    for key, graph in runner._graphs.items():
        check(graph.launches.get("ring_shift") == GATHER_LAUNCHES,
              "%s: graph %s records %s ring launches, not %d" % (
                  label, key, graph.launches.get("ring_shift"),
                  GATHER_LAUNCHES))
    # warm-ups and each graph's capture warm-up run the forward eagerly;
    # a warm-up also merges
    warm = NUM_WARMUPS * len(runner._warm_rows)
    eager = warm + len(runner._graphs)
    want = GATHER_LAUNCHES * (eager + replays) + warm + result.shard_gathers
    check(counts["ring_shift"] == want,
          "%s: %d ring launches, %d expected (%d a forward x (%d eager + "
          "%d replayed forwards) + %d warm-up and %d served merges)" % (
              label, counts["ring_shift"], want, GATHER_LAUNCHES, eager,
              replays, warm, result.shard_gathers))
    check(result.window_launches["ring_shift"]
          == (GATHER_LAUNCHES + 1) * replays,
          "%s: %d ring launches in the window for %d forwards" % (
              label, result.window_launches["ring_shift"], replays))
    d1_result, d1_sink = shard_runs[SHARD_D1_COPY]
    check_bitwise(label, sink, d1_sink, SHARD_D1_COPY)
    final = load_metrics(result.log_dir)[-1]
    collective = final["histograms"].get("exec1.collective", {})
    check(collective.get("count") == result.shard_gathers,
          "%s: metrics.jsonl holds %s exec1.collective samples for %d "
          "merges" % (label, collective.get("count"), result.shard_gathers))
    return dict(replays=replays, graph_pool_mib=pool,
                ring_launches=counts["ring_shift"],
                collective_us_per_request=(result.shard_collective_us
                                           / result.num_completed),
                collective_us_per_merge=(result.shard_collective_us
                                         / result.shard_gathers),
                videos_per_s_d1=d1_result.throughput_vps,
                videos_per_s_d2=result.throughput_vps)


def scaleout_budget() -> int:
    """Distinct devices the shipped r4 config lists: the device count
    its placement plan was made for (the one-card copies see one)."""
    with open(os.path.join(HERE, SCALEOUT_R4)) as f:
        raw = json.load(f)
    return len({d for step in raw["pipeline"] for group in step["queue_groups"]
                for d in group["devices"] if d >= 0})


def check_bitwise(label, sink, other_sink, other):
    """Every request of ``sink`` served the same video with logits
    bitwise those of ``other_sink`` (the run ``other``)."""
    import numpy as np
    check(sorted(sink) == sorted(other_sink), "%s: other requests than %s's"
          % (label, other))
    for rid, (video, logits, _stamps) in sink.items():
        check(other_sink[rid][0] == video
              and np.array_equal(logits, other_sink[rid][1]),
              "%s request %d: logits are not bitwise %s's" % (label, rid,
                                                               other))


def check_lanes_run(label, result, stages, videos):
    """What every replica-lane run holds: the port's ``check_job`` green,
    every request terminated once (completed + dead-lettered + shed),
    every edge take device-resident (d2d, 0 host bytes), and each lane's
    graph pool and capture seconds printed. Returns the lanes' runners."""
    from rnb_tpu_torch.models.r2p1d.model import R2P1DRunner
    from rnb_tpu_torch.parse_utils import check_job
    problems = check_job(result.log_dir)
    check(not problems, "%s: check_job: %s" % (label, "; ".join(problems[:5])))
    terminated = result.num_completed + result.num_failed + result.num_shed
    check(terminated == videos, "%s: %d of %d requests terminated "
          "(completed+failed+shed)" % (label, terminated, videos))
    check(result.handoff_edges > 0
          and result.handoff_edges == result.handoff_d2d_edges
          and result.handoff_host_edges == 0
          and result.handoff_host_bytes == 0,
          "%s: handoff %d edge take(s), %d d2d, %d host, %d host bytes: "
          "every edge must be device-resident" % (
              label, result.handoff_edges, result.handoff_d2d_edges,
              result.handoff_host_edges, result.handoff_host_bytes))
    runners = [stage for _step, stage in stages
               if isinstance(stage, R2P1DRunner)]
    print("path %s lanes: %d runner(s); graph pools %s MiB; capture s %s"
          % (label, len(runners), json.dumps(
              [graph_pool_mib(r) for r in runners]), json.dumps(
              [round(r.graph_stats["capture_s"], 3) for r in runners])))
    return runners


def check_lanes_chaos(label, result, drain):
    """``scripts/chaos_demo.py``'s contract on the chaos copy: every
    dead letter under the plan's reason, lane 3 evicted by a legal path
    and no sibling evicted, no route to an open or evicted lane, every
    fired hedge resolved once; with ``drain`` (a run that outlasts the
    wedge) the circuit opened and lane 3's queued work was
    redispatched."""
    from rnb_tpu_torch.health import legal_path
    dead = result.health_lane_detail.get(LANES_DEAD_LANE, {})
    for ok, what in (
            (set(result.failure_reasons) <= {"chaos-lane-kill"},
             "dead letters %s, not all 'chaos-lane-kill'"
             % json.dumps(result.failure_reasons, sort_keys=True)),
            (result.health_evictions == 1,
             "expected exactly 1 lane eviction, got %d"
             % result.health_evictions),
            (dead.get("state") == "evicted" and legal_path(dead.get("path")),
             "lane %s should be evicted by a legal path, detail says %r"
             % (LANES_DEAD_LANE, dead)),
            (all(e.get("state") != "evicted" for lane, e
                 in result.health_lane_detail.items()
                 if lane != LANES_DEAD_LANE),
             "a healthy sibling lane was evicted: %s" % json.dumps(
                 result.health_lane_detail, sort_keys=True)),
            (result.health_routes_after_open == 0,
             "selector routed %d dispatch(es) to an open/evicted lane"
             % result.health_routes_after_open),
            (result.hedges_won + result.hedges_lost == result.hedges_fired,
             "hedge resolution leak: %d won + %d lost != %d fired"
             % (result.hedges_won, result.hedges_lost, result.hedges_fired)),
            (not drain or result.health_opens >= 1,
             "the circuit never opened during the 2.5 s wedge"),
            (not drain or result.health_redispatches >= 1,
             "no queued work was redispatched off the dead lane")):
        check(ok, "%s: %s" % (label, what))
    print("path %s chaos: %d completed / %d dead-lettered / %d shed; %d "
          "eviction(s), %d open(s), %d redispatch(es), %d probe(s); hedges "
          "%d fired = %d won + %d lost (%d ms wasted); lanes %s" % (
              label, result.num_completed, result.num_failed,
              result.num_shed, result.health_evictions, result.health_opens,
              result.health_redispatches, result.health_probes,
              result.hedges_fired, result.hedges_won, result.hedges_lost,
              result.hedges_wasted_ms,
              json.dumps(result.health_lane_detail, sort_keys=True)))


def phase_lanes(data_root, launches):
    """Serve the one-card copies of the three scale-out configs over the
    y4m dataset (every device index made 0, so four lanes share the
    card): r1 and r4 held to ``scripts/multichip_demo.py``'s contract
    (clean ends, ``check_job`` green, r4 >= 2.5x r1's videos/s, every
    edge take d2d with 0 host bytes, four lanes in r4, and r1's own
    cost records recommending at least four step-1 replicas over the
    shipped config's devices), the chaos copy at 12 requests and again
    at 48 held to ``scripts/chaos_demo.py``'s. Each run launches only the
    ragged normalize, once per emission, replays a captured graph a
    forward (every graph bitwise its eager forward) and decodes on the
    native pool; two requests are recomputed on the CPU. Adds the runs'
    launches to ``launches``."""
    import numpy as np
    from rnb_tpu_torch.benchmark import run_benchmark
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.parse_utils import read_meta
    from rnb_tpu_torch.placement import recommend
    os.environ["RNB_TPU_DATA_ROOT"] = data_root
    runs = [(LANES_R1, SCALEOUT_R1, LANES_VIDEOS),
            (LANES_R4, SCALEOUT_R4, LANES_VIDEOS),
            (LANES_CHAOS, SCALEOUT_CHAOS, LANES_VIDEOS),
            (LANES_CHAOS_DRAIN, SCALEOUT_CHAOS, LANES_DRAIN_VIDEOS),
            (LANES_R4_ASYNC, SCALEOUT_R4, LANES_VIDEOS)]
    results, sinks = {}, {}
    for label, config, videos in runs:
        config_path = (async_producer_copy if label == LANES_R4_ASYNC
                       else one_card_copy)(data_root, config, label)
        sink, stages = {}, []
        _kernels.reset_launches()
        t0 = time.time()
        result = run_benchmark(
            config_path, mean_interval_ms=0, num_videos=videos,
            queue_size=LANES_QUEUE, print_progress=False,
            log_base=os.path.join(data_root, "logs"), seed=LANES_SEED,
            outputs_sink=sink, stages_sink=stages)
        counts = _kernels.launch_counts()
        wall = time.time() - t0
        results[label], sinks[label] = result, sink
        if label == LANES_R4:
            UNARMED_SINKS[label] = sink
            UNARMED_VPS[label] = round(result.throughput_vps, 3)
        check(result.termination_flag == 0, "%s terminated with flag %d"
              % (label, result.termination_flag))
        runners = check_lanes_run(label, result, stages, videos)
        check(len(runners) == (1 if label == LANES_R1 else 4),
              "%s ran %d step-1 lane(s)" % (label, len(runners)))
        if label in (LANES_CHAOS, LANES_CHAOS_DRAIN):
            check_lanes_chaos(label, result, label == LANES_CHAOS_DRAIN)
        else:
            check(result.num_failed + result.num_shed == 0
                  and len(sink) == videos, "%s: %d served, %d failed, %d "
                  "shed" % (label, len(sink), result.num_failed,
                            result.num_shed))
        # the loader's emissions, a dead-lettered request's among them
        emissions = int(read_meta(os.path.join(
            result.log_dir, "log-meta.txt"))["lines"]["Ragged"]["emissions"])
        for name, count in counts.items():
            if name == "ragged_normalize_u8":
                check(result.window_launches[name] == emissions,
                      "%s: %d %s launches for %d emissions" % (
                          label, result.window_launches[name], name,
                          emissions))
            else:
                check(count == 0, "%s: kernel %s, not of this config, was "
                      "launched" % (label, name))
            launches[name] += count
        with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
            backends = [line.split(": ", 1)[1] for line in
                        f.read().splitlines()
                        if line.startswith("Decode backend: ")]
        check(backends and all(b == "native" for b in backends),
              "%s: y4m requests decoded by %s, not the native pool"
              % (label, backends))
        check_graphs(label, result, stages)
        del stages, runners
        for rid, (_video, logits, _stamps) in sink.items():
            check(logits.ndim == 2 and logits.shape[1] == 8
                  and np.isfinite(logits).all(),
                  "%s request %d: logits %s" % (label, rid, logits.shape))
        if label == LANES_R4_ASYNC:
            # held bitwise to the r4 copy, which was recomputed
            check_bitwise(label, sink, sinks[LANES_R4], LANES_R4)
            picks, report = [], "bitwise %s's" % LANES_R4
        else:
            by_clips = sorted(sink, key=lambda r: (sink[r][1].shape[0], r))
            picks = by_clips[:1] + by_clips[-1:]
            report = cpu_recompute(config_path, sink, picks)
        print("path %s: %d requests, %d clips, %.3f videos/s, p50 %s ms, "
              "wall %.1f s, launches %s (window %s); Handoff: %d d2d / %d "
              "host, %d host bytes; Placement: %s; recompute of requests "
              "%s: %s" % (
                  label, result.num_completed, result.clips_completed,
                  result.throughput_vps, result.p50_latency_ms, wall,
                  counts, result.window_launches, result.handoff_d2d_edges,
                  result.handoff_host_edges, result.handoff_host_bytes,
                  json.dumps(result.placement, sort_keys=True), picks,
                  json.dumps(report)))
    r1, r4 = results[LANES_R1], results[LANES_R4]
    speedup = r4.throughput_vps / r1.throughput_vps
    check(speedup >= LANES_MIN_SPEEDUP, "r4 is %.2fx r1's videos/s (>= %.1fx"
          " required)" % (speedup, LANES_MIN_SPEEDUP))
    check(r4.placement["steps"]["step1"]["instances"] == 4,
          "r4 ran %s step-1 instance(s), not the 4 its plan applies"
          % r4.placement["steps"]["step1"]["instances"])
    # the run's own plan names the card count; recomputed from r1's
    # measured costs at the shipped config's device count it must name
    # at least the four lanes r4 runs
    budget = scaleout_budget()
    loads = {int(key[4:]): row["rate_hz"] * row["service_ms"] / 1e3
             for key, row in r1.placement["steps"].items()}
    plan = recommend(loads, budget)
    check(plan.get(1, 0) >= 4, "r1's costs recommend %s at %d devices: "
          "step1 needs >= 4" % (plan, budget))
    print("lanes: r4/r1 %.3fx videos/s (%.3f / %.3f); r1's plan at %d "
          "device(s) %s, recomputed at %d %s" % (
              speedup, r4.throughput_vps, r1.throughput_vps,
              r1.placement["device_budget"],
              json.dumps(r1.placement["plan"], sort_keys=True), budget,
              json.dumps(plan, sort_keys=True)))


def armed_copy(data_root, config_path, name) -> str:
    """``config_path`` with the lock-order witness armed (the root
    ``lint`` key), a temporary copy beside the dataset."""
    with open(config_path) as f:
        raw = json.load(f)
    raw["lint"] = {"lock_witness": True}
    path = os.path.join(data_root, name + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def held_class_ids(label, sink, unarmed):
    """Each request's class id (the argmax of its clips' summed logits)
    against the unarmed run's: the ids must agree on every request whose
    unarmed top-2 margin exceeds twice the 2% bf16 bound of the logit
    scale (the repo's rule: a fused emission's batch may differ between
    two runs, and with it the bf16 rounding), and on at least half.
    -> (equal, requests, held)."""
    import numpy as np
    check(sorted(sink) == sorted(unarmed), "%s served requests %s, the "
          "unarmed run %s" % (label, sorted(sink), sorted(unarmed)))
    equal = held = 0
    for rid in sorted(sink):
        total = unarmed[rid][1].sum(axis=0)
        got = int(np.argmax(sink[rid][1].sum(axis=0)))
        equal += got == int(np.argmax(total))
        top2 = np.sort(total)[-2:]
        if top2[1] - top2[0] > 0.04 * float(np.abs(total).max()):
            check(got == int(np.argmax(total)), "%s request %d: class id "
                  "%d, the unarmed run's %d" % (label, rid, got,
                                               int(np.argmax(total))))
            held += 1
    check(2 * held >= len(sink), "%s: %d of %d requests past the margin"
          % (label, held, len(sink)))
    return equal, len(sink), held


def phase_witness(data_root, launches):
    """Serve the big config, the r4 lane copy and the paged cell again
    with the lock-order witness armed (``lint: {"lock_witness": true}``),
    at the unarmed runs' workloads: each ends cleanly with zero witness
    violations, ``check_job`` green (every observed lock-order edge in
    rnb-lint's static graph), the paged cell's hits observe the
    ``ClipCache._lock -> Pager.lock`` edge, and the big and r4 copies
    serve the unarmed runs' class ids (:func:`held_class_ids`). Prints each run's ``Locks:``
    ledger and its videos/s beside the unarmed run's. Adds the runs'
    launches to ``launches``."""
    from rnb_tpu_torch.analysis.concurrency import static_lock_order_edges
    from rnb_tpu_torch.benchmark import run_benchmark
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.parse_utils import check_job_detail, read_meta
    os.environ["RNB_TPU_DATA_ROOT"] = data_root
    declared = static_lock_order_edges()
    runs = [(ARMED_BIG, CONFIGS[0], os.path.join(HERE, CONFIGS[0]),
             dict(mean_interval_ms=0, num_videos=VIDEOS_PER_RUN, seed=0,
                  queue_size=50000)),
            (ARMED_R4, LANES_R4, one_card_copy(data_root, SCALEOUT_R4,
                                               LANES_R4),
             dict(mean_interval_ms=0, num_videos=LANES_VIDEOS,
                  seed=LANES_SEED, queue_size=LANES_QUEUE)),
            (ARMED_PAGED, PAGED, os.path.join(HERE, PAGED),
             dict(mean_interval_ms=ZIPF_INTERVAL_MS,
                  num_videos=VIDEOS_PER_RUN, seed=0, queue_size=50000))]
    for label, unarmed, config_path, workload in runs:
        sink = {}
        _kernels.reset_launches()
        t0 = time.time()
        result = run_benchmark(armed_copy(data_root, config_path, label),
                               print_progress=False,
                               log_base=os.path.join(data_root, "logs"),
                               outputs_sink=sink, **workload)
        wall = time.time() - t0
        for name, count in _kernels.launch_counts().items():
            launches[name] += count
        check(result.termination_flag == 0, "%s terminated with flag %d"
              % (label, result.termination_flag))
        problems, parse_failed = check_job_detail(result.log_dir)
        check(not problems and not parse_failed, "%s: check_job: %s"
              % (label, "; ".join(problems[:5])))
        detail = read_meta(os.path.join(result.log_dir, "log-meta.txt"))[
            "lock_edge_detail"]
        edges = sorted(tuple(edge) for edge in detail["edges"])
        check(result.locks_violations == 0 and not detail["violations"],
              "%s: witness violations %s" % (label, detail["violations"]))
        check(set(edges) <= declared, "%s: edges %s outside the static "
              "graph" % (label, sorted(set(edges) - declared)))
        check(result.locks_tracked >= 1 and result.locks_acquires >= 1,
              "%s: the witness saw no lock (tracked %d, acquires %d)"
              % (label, result.locks_tracked, result.locks_acquires))
        if label == ARMED_PAGED:
            check(("ClipCache._lock", "Pager.lock") in edges,
                  "%s: the paged hits' cache -> pager edge was not "
                  "observed: %s" % (label, edges))
            same = "not compared (Poisson arrivals)"
        else:
            same = ("%d of %d equal, %d held past the bf16 margin"
                    % held_class_ids(label, sink, UNARMED_SINKS[unarmed]))
        print("witness %s: %d requests, %.3f videos/s (unarmed %s), wall "
              "%.1f s; Locks: tracked=%d acquires=%d edges=%d violations=%d;"
              " edges %s; class ids %s" % (
                  label, result.num_completed, result.throughput_vps,
                  UNARMED_VPS.get(unarmed), wall, result.locks_tracked,
                  result.locks_acquires, result.locks_edges,
                  result.locks_violations, json.dumps(edges), same))


def phase_lint():
    """rnb-lint of the port over the checkout, on this machine: the CLI
    exits 0 (no finding beyond the baseline, no stale entry); its
    per-family counts and its seconds are printed."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "rnb_tpu_torch.tools.lint"], cwd=HERE,
        capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        print("lint: %s" % line)
    check(proc.returncode == 0, "rnb-lint exited %d:\n%s%s" % (
        proc.returncode, proc.stdout[-4000:], proc.stderr[-4000:]))
    print("lint: %.1f s" % (time.time() - t0))


def phase_check_jobs(data_root):
    """Every job directory the smoke wrote, on every path, through the
    port's whole ``check_job``: no problem and nothing unreadable."""
    from rnb_tpu_torch.parse_utils import check_job_detail
    t0 = time.time()
    jobs = sorted(dirpath for dirpath, _dirs, names
                  in os.walk(os.path.join(data_root, "logs"))
                  if "log-meta.txt" in names)
    for job in jobs:
        problems, parse_failed = check_job_detail(job)
        check(not problems and not parse_failed, "%s: check_job%s: %s" % (
            os.path.relpath(job, data_root),
            " (unreadable)" if parse_failed else "",
            "; ".join(problems[:5])))
    check(jobs, "no job directory under %s" % data_root)
    print("check_job: %d job directories, every one green (%.1f s)"
          % (len(jobs), time.time() - t0))


def mesh_recompute(config_path, sink, runner):
    """Every request of a mesh run against a full-width recompute of its
    valid clips, through the stage that served it (before it is freed)
    and through the port's plain versions. The wire rows are decoded
    again and the run's dispatches rebuilt: ``dp`` requests in order, the
    last padded with a zero video as ``flush`` pads it.

    * The stage again, as a burst through its entry (``__call__`` and
      ``flush``, every input staged on the card first, no host read in
      between): the ``max_inflight`` bound reached and held, ``finalize``
      waiting for the dispatches still unretired; every prediction, read
      after the drain, the argmax of its dispatch's replay (no later
      replay overwrote it).
    * The run's graph (``forward``) on each dispatch: every request's
      served class id the argmax of its sums.
    * The truth, the plain ingest and the float32 network on the CPU: the
      served bf16 network on the card over the same input sets the bound
      (its error against the truth, as the CPU's bf16 does in
      ``cpu_recompute``); each request's sums are held element by element
      within the bound times its clips, and its class id to the truth's
      argmax wherever the top-2 margin exceeds twice that. The near ties
      are counted (those serving another class id listed with their gap
      and margin), and more than NEAR_TIE_SHARE of the requests serving
      another class id than the truth fails.

    Videos repeat across requests: each is recomputed once."""
    import numpy as np
    import torch
    from rnb_tpu_torch.config import load_config
    from rnb_tpu_torch.decode import get_decoder
    from rnb_tpu_torch.models.r2p1d.model import shared_network
    from rnb_tpu_torch.models.r2p1d.sampler import R2P1DSampler
    from rnb_tpu_torch.ops.preprocess import normalize_u8
    from rnb_tpu_torch.ops.yuv import normalize_yuv420
    from rnb_tpu_torch.stage import PaddedBatch
    from rnb_tpu_torch.telemetry import TimeCard
    stage_kwargs = load_config(config_path, "cpu").steps[1].kwargs
    si = runner._si
    cpu_f32 = shared_network(
        1, 5, si.num_classes, tuple(stage_kwargs.get("layer_sizes",
                                                     (2, 2, 2, 2))),
        torch.device("cpu"), dtype=torch.float32)
    sampler = R2P1DSampler(consecutive_frames=FRAMES)
    staged, truths = {}, {}
    for rid in sorted(sink):
        video, served, _stamps = sink[rid]
        check(isinstance(served, int) and 0 <= served < si.num_classes,
              "%s request %d: class id %r" % (config_path, rid, served))
        if video in staged:
            continue
        decoder = get_decoder(video)
        starts = sampler.sample(decoder.num_frames(video),
                                video_id=video)[:si.max_clips]
        with torch.inference_mode():
            if si.pixel_path == "yuv420":
                wire = torch.from_numpy(decoder.decode_clips_yuv(
                    video, starts, FRAMES, HW, HW))
                x = normalize_yuv420(wire, HW, HW)
            else:
                wire = torch.from_numpy(decoder.decode_clips(
                    video, starts, FRAMES, HW, HW))
                x = normalize_u8(wire)
            truth = cpu_f32(x).numpy()
            err = float(np.abs(si.network(x.to(si.device)).cpu().numpy()
                               - truth).max())
        rows = torch.zeros(si.batch_shape(1)[1:], dtype=torch.uint8)
        rows[:wire.shape[0]] = wire
        staged[video] = (rows.to(si.device), int(wire.shape[0]))
        truths[video] = (truth.sum(axis=0), err)
    rids = sorted(sink)
    zero = (torch.zeros_like(next(iter(staged.values()))[0]), 0)
    dispatches = []
    for i in range(0, len(rids), runner.dp):
        chunk = [staged[sink[rid][0]] for rid in rids[i:i + runner.dp]]
        chunk += [zero] * (runner.dp - len(chunk))
        dispatches.append((torch.stack([rows for rows, _ in chunk]),
                           si.place_mask([clips for _, clips in chunk])))
    torch.cuda.synchronize()
    runner.inflight_peak = 0
    preds = []
    for rid in rids:
        rows, clips = staged[sink[rid][0]]
        _, pred, _ = runner((PaddedBatch(rows, clips),), None, TimeCard(rid))
        if pred is not None:
            preds.append(pred)
    flushed = runner.flush()
    if flushed is not None:
        preds.append(flushed[1])
    runner.finalize()
    check(len(preds) == len(dispatches)
          and runner.inflight_peak == runner.max_inflight
          and runner.drained >= 1, "%s burst: %d predictions for %d "
          "dispatches, at most %d unretired (bound %d), %d drained"
          % (config_path, len(preds), len(dispatches), runner.inflight_peak,
             runner.max_inflight, runner.drained))
    report = dict(requests=0, clips=0, held=0, agreed=0, near_ties=0,
                  bf16_err=0.0, bound=0.0, sums_err=0.0, differ=[],
                  burst_peak=runner.inflight_peak,
                  burst_drained=runner.drained)
    for i, ((vids, mask), pred) in enumerate(zip(dispatches, preds)):
        sums = runner.forward(vids, mask)
        check(torch.equal(pred, sums.argmax(dim=-1)), "%s dispatch %d: the "
              "burst predicted %s, its replay %s" % (
                  config_path, i, pred.tolist(),
                  sums.argmax(dim=-1).tolist()))
        sums = sums.cpu().numpy()
        for j, rid in enumerate(rids[i * runner.dp:(i + 1) * runner.dp]):
            video, served, _stamps = sink[rid]
            total, err = truths[video]
            bound = BF16_FACTOR * err + BF16_ATOL
            clips = staged[video][1]
            check(served == int(sums[j].argmax()), "%s request %d: class "
                  "id %d, the replay of its dispatch says %d" % (
                      config_path, rid, served, int(sums[j].argmax())))
            sums_err = float(np.abs(sums[j] - total).max()) / clips
            check(sums_err <= bound, "%s request %d (%s): card sums are %g "
                  "a clip from the float32 sums, more than the bound %g"
                  % (config_path, rid, video, sums_err, bound))
            top2 = np.sort(total)[-2:]
            gap, margin = float(top2[1] - top2[0]), 2 * bound * clips
            held = gap > margin
            agreed = served == int(total.argmax())
            check(not held or agreed, "%s request %d (%s): class id %d, the "
                  "CPU float32 sums say %d past the margin" % (
                      config_path, rid, video, served, int(total.argmax())))
            if not agreed:
                report["differ"].append([rid, gap, margin])
            report["requests"] += 1
            report["clips"] += clips
            report["held"] += int(held)
            report["agreed"] += int(agreed)
            report["near_ties"] += int(not held)
            report["sums_err"] = max(report["sums_err"], sums_err)
            report["bound"] = max(report["bound"], bound)
            report["bf16_err"] = max(report["bf16_err"], err)
    check(report["requests"] == len(rids), "%s: %d of %d requests held"
          % (config_path, report["requests"], len(rids)))
    check(len(report["differ"]) <= NEAR_TIE_SHARE * report["requests"],
          "%s: %d of %d requests serve another class id than the CPU"
          % (config_path, len(report["differ"]), report["requests"]))
    report["videos"] = len(staged)
    return report


def check_mesh_ingest(label, si, rows, rng):
    """A sharded step's ingest kernel against its plain version on
    ``rows`` seeded wire rows of its pixel path: ``rnb_normalize_u8``
    bitwise; ``rnb_yuv420_normalize`` bitwise the normalize of the u8
    entry's output, which is within one u8 step of the plain conversion.
    Returns the worst error against the plain version."""
    import numpy as np
    import torch
    from rnb_tpu_torch.ops import preprocess, yuv
    wire = torch.from_numpy(rng.integers(0, 256, (rows,) + tuple(
        si.batch_shape(1)[2:]), dtype=np.uint8)).cuda()
    hw = si.frame_hw
    if si.pixel_path == "yuv420":
        rgb = yuv.yuv420_to_rgb_u8(wire, hw, hw)
        plain_rgb = yuv.yuv420_to_rgb_reference(wire, hw, hw)
        steps = int((rgb.int() - plain_rgb.int()).abs().max())
        out = yuv.normalize_yuv420(wire, hw, hw)
        ok = steps <= 1 and torch.equal(
            out.view(torch.int16),
            preprocess.normalize_u8_reference(rgb).view(torch.int16))
        plain = preprocess.normalize_u8_reference(plain_rgb)
    else:
        out = preprocess.normalize_u8(wire)
        plain = preprocess.normalize_u8_reference(wire)
        ok = torch.equal(out.view(torch.int16), plain.view(torch.int16))
    err = float((out.float() - plain.float()).abs().max())
    check(ok, "%s: %s at %d rows differs from its plain version (max %g)"
          % (label, INGEST_KERNELS[si.pixel_path], rows, err))
    return err


def check_mesh_graphs(label, runner, reps=20):
    """The mesh stage's ingest kernel against its plain version at the
    dispatch's rows, dp x the padded clips (:func:`check_mesh_ingest`).
    Its captured graph holds that kernel (one launch a replay) and
    replays bitwise its eager forward on seeded dispatches (every clip
    count, a zero video among them). Returns the worst ingest error
    against the plain version, the replay's time by CUDA events and the
    graph pool's MiB."""
    import numpy as np
    import torch
    kernel = INGEST_KERNELS[runner.pixel_path]
    si = runner._si
    rng = np.random.default_rng(19)
    err = check_mesh_ingest(label, si, runner.dp * si.padded_clips, rng)
    check(len(runner._graphs) == 1, "%s: %d mesh graphs" % (
        label, len(runner._graphs)))
    (graph,) = runner._graphs.values()
    check(graph.launches == {kernel: 1}, "%s: the mesh graph records %s, "
          "not one %s launch" % (label, graph.launches, kernel))
    for valid in ([1, si.max_clips], [si.max_clips, 0],
                  [int(v) for v in rng.integers(1, si.max_clips + 1,
                                                runner.dp)]):
        vids = torch.from_numpy(rng.integers(
            0, 256, si.batch_shape(runner.dp), dtype=np.uint8)).cuda()
        mask = si.place_mask(valid)
        replayed = runner.forward(vids, mask)
        eager = runner.eager_forward(vids, mask)
        torch.cuda.synchronize()
        check(torch.equal(replayed, eager), "%s: the mesh graph replays %g "
              "from its eager forward (valid %s)" % (
                  label, float((replayed - eager).abs().max()), valid))
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        runner.forward(vids, mask)
    end.record()
    end.synchronize()
    return err, start.elapsed_time(end) / reps, graph_pool_mib(runner)


def check_mesh_unread(label, config_path, videos, data_root):
    """The copy served again with no outputs sink, so nothing on the host
    reads a prediction while the run lasts: the run completes, one replay
    a dispatch, and ``finalize`` (called as the run reaches its target)
    found the last dispatches unretired and waited for them."""
    import torch
    from rnb_tpu_torch.benchmark import run_benchmark
    from rnb_tpu_torch.models.r2p1d.model import R2P1DMeshRunner
    stages = []
    result = run_benchmark(
        config_path, mean_interval_ms=0, num_videos=videos,
        print_progress=False, log_base=os.path.join(data_root, "logs"),
        seed=0, stages_sink=stages)
    (runner,) = [s for _, s in stages if isinstance(s, R2P1DMeshRunner)]
    dispatches = -(-videos // MESH_DP)
    check(result.termination_flag == 0 and result.num_completed == videos
          and runner.graph_stats["replays"] == dispatches
          and runner.drained >= 1, "%s unread: flag %d, %d completed, %d "
          "replays for %d dispatches, %d drained at the end" % (
              label, result.termination_flag, result.num_completed,
              runner.graph_stats["replays"], dispatches, runner.drained))
    print("path %s unread: %d requests, %.3f videos/s, at most %d "
          "dispatches unretired, %d drained by finalize" % (
              label, result.num_completed, result.throughput_vps,
              runner.inflight_peak, runner.drained))
    runner._graphs.clear()
    del stages, runner
    torch.cuda.empty_cache()


def phase_mesh(data_root, launches):
    """Serve the one-card copies of ``configs/r2p1d-mesh.json`` (33
    requests, so ``flush`` pads the dp axis) and ``-mesh-yuv.json`` (32)
    in bulk over the y4m dataset, at their shipped geometry: every
    request completed, the rgb loader shipping raw u8 (no normalize of
    its own), the mesh stage's ingest kernel launched once a dispatch
    inside its captured graph (plus the warm-ups and the capture's
    warm-up) and no other kernel, one replay a dispatch, the graph
    bitwise its eager forward, every decode on the native pool; then the
    served stage driven again and every request recomputed
    (``mesh_recompute``), and the copy served once more with no outputs
    sink (``check_mesh_unread``). Adds the first runs' launches to
    ``launches``."""
    import torch
    from rnb_tpu_torch.benchmark import run_benchmark
    from rnb_tpu_torch.models.r2p1d.model import (NUM_WARMUPS,
                                                  R2P1DMeshRunner)
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.parse_utils import summarize
    os.environ["RNB_TPU_DATA_ROOT"] = data_root
    for label, config, videos in MESH_RUNS:
        config_path = one_card_copy(data_root, config, label)
        sink, stages = {}, []
        _kernels.reset_launches()
        t0 = time.time()
        result = run_benchmark(
            config_path, mean_interval_ms=0, num_videos=videos,
            print_progress=False, log_base=os.path.join(data_root, "logs"),
            seed=0, outputs_sink=sink, stages_sink=stages)
        counts = _kernels.launch_counts()
        wall = time.time() - t0
        check(result.termination_flag == 0, "%s terminated with flag %d"
              % (label, result.termination_flag))
        check(result.num_completed == videos and sorted(sink) == list(
            range(videos)), "%s: %d completed, outputs of %s" % (
                label, result.num_completed, sorted(sink)))
        (runner,) = [s for _, s in stages if isinstance(s, R2P1DMeshRunner)]
        check(runner._si.padded_clips == MESH_PADDED_CLIPS
              and runner.dp == MESH_DP and not runner.sync_preds,
              "%s: padded clips %d, dp %d, sync_preds %s" % (
                  label, runner._si.padded_clips, runner.dp,
                  runner.sync_preds))
        dispatches = -(-videos // MESH_DP)
        replays = runner.graph_stats["replays"]
        check(replays == dispatches == result.compiles["step1"][
            "steady_calls"], "%s: %d replays, %d dispatches" % (
                label, replays, dispatches))
        kernel = INGEST_KERNELS[runner.pixel_path]
        for name, count in counts.items():
            if name == kernel:
                want = NUM_WARMUPS + len(runner._graphs) + replays
                check(count == want and result.window_launches[name]
                      == replays, "%s: %d %s launches (%d in the window) "
                      "for %d warm-ups, %d captures and %d replays" % (
                          label, count, name, result.window_launches[name],
                          NUM_WARMUPS, len(runner._graphs), replays))
            else:
                check(count == 0, "%s: kernel %s, not of this config, was "
                      "launched" % (label, name))
            launches[name] += count
        with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
            backends = [line.split(": ", 1)[1] for line in
                        f.read().splitlines()
                        if line.startswith("Decode backend: ")]
        check(backends and all(b == "native" for b in backends),
              "%s: y4m requests decoded by %s, not the native pool"
              % (label, backends))
        check_graphs(label, result, stages)
        ingest_err, replay_ms, pool = check_mesh_graphs(label, runner)
        served_peak = runner.inflight_peak
        t1 = time.time()
        report = mesh_recompute(config_path, sink, runner)
        runner._graphs.clear()  # free the graph's memory
        del stages, runner
        stats = summarize(result.log_dir)
        print("path %s: %d requests, %d clips, %.3f videos/s, %.3f clips/s, "
              "wall %.1f s, %d dispatches (at most %d unretired, the sink "
              "reading each), replay %.3f ms a dispatch, graph pool %s MiB, "
              "capture %.3f s, launches %s (window %s), ingest at %d rows %g "
              "from its plain version; recompute of every request (%.1f s): "
              "%s" % (
                  label, result.num_completed, result.clips_completed,
                  result.throughput_vps, stats["clips_per_s"], wall,
                  dispatches, served_peak, replay_ms,
                  "%.1f" % pool if pool is not None else "not measured",
                  result.graphs["step1"]["capture_s"], counts,
                  result.window_launches, MESH_DP * MESH_PADDED_CLIPS,
                  ingest_err, time.time() - t1, json.dumps(report)))
        torch.cuda.empty_cache()
        check_mesh_unread(label, config_path, videos, data_root)


def check_entry(device):
    """``graft_entry.entry()`` on the card: the flagship forward's
    logits over the example batch are (15, 400) float32 and finite; over
    a seeded batch of the same shape they lie within the bf16 bound of
    the CPU's float32 recompute with the same weights (the bound from
    the CPU's own bf16 run, as ``cpu_recompute``), with equal argmax on
    every row past twice the bound. Returns the forward's ms (CUDA
    events) and the report."""
    import numpy as np
    import torch
    from rnb_tpu_torch.graft_entry import FLAGSHIP_SHAPE, entry
    from rnb_tpu_torch.models.r2p1d.model import shared_network
    from rnb_tpu_torch.ops.preprocess import normalize_u8_reference
    t0 = time.time()
    forward, args = entry()
    (x,) = args
    check(tuple(x.shape) == FLAGSHIP_SHAPE and x.dtype == torch.bfloat16
          and x.device == device, "entry: example batch %s %s on %s" % (
              tuple(x.shape), x.dtype, x.device))
    logits = forward(*args)
    torch.cuda.synchronize()
    check(tuple(logits.shape) == (FLAGSHIP_SHAPE[0], 400)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), "entry: logits %s %s, "
          "finite %s" % (tuple(logits.shape), logits.dtype,
                         bool(torch.isfinite(logits).all())))
    built_s = time.time() - t0
    ms = call_ms(lambda: forward(*args), reps=5, rounds=3)
    rng = np.random.default_rng(29)
    seeded = normalize_u8_reference(torch.from_numpy(rng.integers(
        0, 256, FLAGSHIP_SHAPE, dtype=np.uint8)))
    served = forward(seeded.to(device)).cpu().numpy()
    del forward, args, x, logits
    torch.cuda.empty_cache()
    t1 = time.time()
    cpu = torch.device("cpu")
    with torch.inference_mode():
        truth = shared_network(1, 5, 400, (2, 2, 2, 2), cpu,
                               dtype=torch.float32)(seeded).numpy()
        cpu_bf16 = shared_network(1, 5, 400, (2, 2, 2, 2), cpu)(
            seeded).numpy()
    bound = BF16_FACTOR * float(np.abs(cpu_bf16 - truth).max()) + BF16_ATOL
    served_err = float(np.abs(served - truth).max())
    check(served_err <= bound, "entry: the card's logits are %g from the "
          "CPU's float32, more than the bf16 bound %g" % (served_err, bound))
    report = dict(rows=int(truth.shape[0]), past_margin=0, agreed=0,
                  served_err=served_err, bound=bound,
                  recompute_s=time.time() - t1, build_s=built_s)
    for row_truth, row_served in zip(truth, served):
        same = int(row_truth.argmax() == row_served.argmax())
        top2 = np.sort(row_truth)[-2:]
        if top2[1] - top2[0] > 2 * bound:
            report["past_margin"] += 1
            check(same, "entry: a row's argmax differs past the margin")
        report["agreed"] += same
    return ms, report


def check_sharded(device, pixel_path, launches):
    """``make_sharded_inference`` at full width on one card: R18, 400
    classes, bf16, over ``build_mesh([cuda:0] * 8, axes={"dp": 2, "sp":
    4})`` (15 clips padded to 16), on four seeded videos of
    PARALLEL_VALID clips. Two ``run`` s and a ``predict`` with the
    counts set to 0 before them and read after: the first captures the
    step as one CUDA graph (its warm-up one ingest launch), then three
    replays of one ingest launch each and no other kernel; the second run
    bitwise the first, the captured run bitwise the eager ``step``, one
    graph replayed three times, no host wait; each video's
    logits within PARALLEL_TOL (rtol = atol) of the same network's
    unsharded masked sum on the card (one forward over every video's
    max_clips rows); ``predict`` 's class ids those of the unsharded
    sums wherever their top-2 gap exceeds the two logits' bounds; the
    ingest kernel held to its plain version at the run's rows. Returns
    ``run`` 's ms at dp 2 x 16 rows (CUDA events) and a report with the
    medians of RUN_REPS captured runs and eager steps there."""
    import numpy as np
    import torch
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.ops.preprocess import normalize_u8
    from rnb_tpu_torch.ops.yuv import normalize_yuv420
    from rnb_tpu_torch.parallel import (build_mesh, make_sharded_inference,
                                        peers)
    mesh = build_mesh([device] * 8, axes=PARALLEL_AXES)
    t0 = time.time()
    si = make_sharded_inference(mesh=mesh, max_clips=MESH_MAX_CLIPS,
                                num_classes=400, pixel_path=pixel_path)
    build_s = time.time() - t0
    kernel = INGEST_KERNELS[pixel_path]
    check(si.padded_clips == MESH_PADDED_CLIPS and si.dtype ==
          torch.bfloat16 and si.mesh.shape == PARALLEL_AXES, "sharded %s: "
          "padded clips %d, %s, mesh %s" % (pixel_path, si.padded_clips,
                                            si.dtype, si.mesh.shape))
    rng = np.random.default_rng(31 + len(pixel_path))
    videos = rng.integers(0, 256, si.batch_shape(len(PARALLEL_VALID)),
                          dtype=np.uint8)
    vids, mask = si.place(videos, PARALLEL_VALID)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    waits = peers.host_waits
    first = si.run(vids, mask)
    again = si.run(vids, mask)
    preds = si.predict(videos, PARALLEL_VALID)
    counts = _kernels.launch_counts()
    waits = peers.host_waits - waits
    for name, count in counts.items():
        check(count == (4 if name == kernel else 0), "sharded %s: %d %s "
              "launches in two runs and a predict (a capture's warm-up "
              "and three replays)" % (pixel_path, count, name))
        launches[name] += count
    check(si.graph_stats["graphs"] == 1 and si.graph_stats["replays"] == 3
          and waits == 0, "sharded %s: graphs %s, host waits %d" % (
              pixel_path, si.graph_stats, waits))
    check(torch.equal(first, again), "sharded %s: a second run differs by "
          "%g" % (pixel_path, float((first - again).abs().max())))
    with torch.inference_mode():
        eager = si.step(vids, mask)
    check(torch.equal(first, eager), "sharded %s: the captured run is %g "
          "from the eager step" % (pixel_path,
                                   float((first - eager).abs().max())))
    check(tuple(first.shape) == (len(PARALLEL_VALID), 400)
          and bool(torch.isfinite(first).all()), "sharded %s: logits %s"
          % (pixel_path, tuple(first.shape)))
    got = first.cpu().numpy()
    check(np.array_equal(preds, got.argmax(-1)), "sharded %s: predict %s, "
          "the run's argmax %s" % (pixel_path, preds.tolist(),
                                   got.argmax(-1).tolist()))
    report = dict(videos=len(PARALLEL_VALID), held=0, agreed=0,
                  near_ties=[], err=0.0, build_s=build_s)
    # unsharded: one forward over every video's max_clips rows, each
    # video's masked logits summed over its clip axis at once
    flat = vids.reshape((-1,) + tuple(vids.shape[2:]))
    with torch.inference_mode():
        if pixel_path == "yuv420":
            x = normalize_yuv420(flat, si.frame_hw, si.frame_hw)
        else:
            x = normalize_u8(flat)
        unsharded = (si.network(x).reshape(len(PARALLEL_VALID), -1, 400)
                     * mask[..., None]).sum(dim=1).cpu().numpy()
    for j, valid in enumerate(PARALLEL_VALID):
        want = unsharded[j]
        bound = PARALLEL_TOL + PARALLEL_TOL * np.abs(want)
        err = np.abs(got[j] - want)
        check((err <= bound).all(), "sharded %s video %d (%d clips): "
              "%g from the unsharded sum, past rtol = atol = %g" % (
                  pixel_path, j, valid, float(err.max()), PARALLEL_TOL))
        report["err"] = max(report["err"], float(err.max()))
        top = np.argsort(want)[-2:]
        gap = float(want[top[1]] - want[top[0]])
        margin = float(bound[top[1]] + bound[top[0]])
        agreed = int(preds[j]) == int(top[1])
        check(gap <= margin or agreed, "sharded %s video %d: class id "
              "%d, the unsharded sums say %d past the margin" % (
                  pixel_path, j, int(preds[j]), int(top[1])))
        report["held"] += int(gap > margin)
        report["agreed"] += int(agreed)
        if gap <= margin:
            report["near_ties"].append([j, gap, margin])
    report["ingest_err"] = check_mesh_ingest(
        "sharded %s" % pixel_path, si, len(PARALLEL_VALID) * si.padded_clips,
        rng)
    two, two_mask = vids[:MESH_DP], mask[:MESH_DP]
    ms = call_ms(lambda: si.run(two, two_mask), reps=10, rounds=3)
    report["captured_run_ms"] = median_ms(lambda: si.run(two, two_mask),
                                          RUN_REPS)
    with torch.inference_mode():
        report["eager_step_ms"] = median_ms(lambda: si.step(two, two_mask),
                                            RUN_REPS)
    report["graphs"] = dict(si.graph_stats)
    del si, vids, mask, first, again, eager, two, two_mask
    torch.cuda.empty_cache()
    return ms, report


def phase_parallel(data_root, launches):
    """The reference's parallel API and its entry points on the
    card (``rnb_tpu_torch.graft_entry``, ``rnb_tpu_torch.parallel``):
    ``entry()``'s flagship forward (:func:`check_entry`); the full-width
    ``ShardedInference`` in rgb and yuv420 (:func:`check_sharded`);
    ``dryrun_multichip(8)`` and ``(2)`` with every member on the card,
    each printing its ``ok`` line (the 8-member pipeline run's job
    directory under ``data_root/logs``, for ``phase_check_jobs``); and
    ``global_mesh()`` and ``process_count()``. Each path is driven with
    the counts set to 0 before it and read after; their launches go to
    ``launches``. Prints each time beside the card's name and power
    limit."""
    import torch
    from rnb_tpu_torch.graft_entry import dryrun_multichip
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.parallel import distributed
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    t0 = time.time()
    entry_ms, entry_report = check_entry(device)
    print("parallel entry: flagship forward %.3f ms (15 clips, bf16; %s); "
          "%s" % (entry_ms, smi, json.dumps(entry_report)))
    for pixel_path in ("rgb", "yuv420"):
        run_ms, report = check_sharded(device, pixel_path, launches)
        print("parallel sharded %s: run %.3f ms at dp %d x %d rows; the "
              "captured run %.3f ms (median of %d; min %.3f, max %.3f) "
              "against the eager step %.3f (min %.3f, max %.3f) (%s); %s"
              % (pixel_path, run_ms, MESH_DP, MESH_PADDED_CLIPS,
                 report["captured_run_ms"][0], RUN_REPS,
                 *report["captured_run_ms"][1:], *report["eager_step_ms"],
                 smi, json.dumps(report)))
    for members in DRYRUN_MEMBERS:
        _kernels.reset_launches()
        t1 = time.time()
        summary = dryrun_multichip(members, log_base=os.path.join(
            data_root, "logs", "dryrun-%d" % members))
        counts = _kernels.launch_counts()
        for name, count in counts.items():
            check(count == 0 or name in DRYRUN_KERNELS, "dryrun_multichip(%d)"
                  " launched %s, not a kernel of its paths" % (members, name))
            launches[name] += count
        check(counts["normalize_u8"] >= 1 and (
            members < 4 or counts["yuv420_normalize"] >= 1),
            "dryrun_multichip(%d): launches %s" % (members, counts))
        print("parallel dryrun_multichip(%d): %.1f s, %s, launches %s (%s)"
              % (members, time.time() - t1, json.dumps(summary),
                 {k: v for k, v in counts.items() if v}, smi))
    check(distributed.process_count() == 1 and distributed.is_primary(),
          "process_count %d" % distributed.process_count())
    print("parallel global_mesh().shape %s, process_count() %d (%.1f s)"
          % (distributed.global_mesh().shape, distributed.process_count(),
             time.time() - t0))


def plain_psum_scatter(operands, axis):
    """The reduce-scatter in the reference's ring order through the plain
    version of the hop (``ring_shift_reference``) and the same adds: one
    process's view of every member."""
    from rnb_tpu_torch.ops.handoff_dma import ring_shift_reference
    n = len(operands)
    ax = axis % operands[0].dim()
    chunk = operands[0].shape[ax] // n

    def piece(member, m):
        return operands[member].narrow(ax, m * chunk, chunk)
    acc = [piece(j, (j - 1) % n).contiguous() for j in range(n)]
    for s in range(1, n):
        acc = ring_shift_reference(acc, 1)
        acc = [acc[j] + piece(j, (j - 1 - s) % n) for j in range(n)]
    return acc


def peer_tensor(ptr, nbytes, device):
    """A uint8 tensor over ``nbytes`` at ``ptr`` (a peer's arena opened
    in this process), for the library yardstick's ``copy_``."""
    import torch

    class Window:
        __cuda_array_interface__ = {"shape": (nbytes,), "typestr": "|u1",
                                    "data": (ptr, False), "version": 2}
    return torch.as_tensor(Window(), device=device)


def hop_calls(ep, source, target, place, device, launch=None):
    """The calls that time the hop's launch and its parts alone, on
    ``source`` (a dense tensor) into ``target`` (a pointer into the
    successor's arena, as mapped here, at ``place``), every wait
    satisfied: each kind of call has two scratch counter allocations of
    its own, one for this member and one in the successor's place. One
    launch on the second alone posts the call's tiles there; then its
    ``posted`` and the first's ``recv`` are set past any epoch, so each
    timed launch posts (into the first), reads the second's post, moves,
    signals (the second) and finds its own hop landed, waiting for
    nothing.

    * ``hop``: the whole launch, the source landing in the successor's
      arena where the (own) post says;
    * ``copy``: the same bytes in a local launch (no post, no wait, no
      publication): the copy alone;
    * ``copy_sync``: the copy as a tile within the member, with the post,
      the satisfied waits and the publication: all but the post's check;
    * ``sync``: a launch with no tiles, one block: the post, the waits
      and the publication alone.

    ``launch(args)`` launches the C arguments (by default through
    ``RING_SHIFT``'s hop entry)."""
    import torch
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.parallel import peers
    nbytes = source.numel() * source.element_size()
    segments = ep.peer_segments[(ep.member + 1) % ep.degree]
    if launch is None:
        def launch(args):
            _kernels.RING_SHIFT.launch(*args, device=device,
                                       entry=_kernels.RING_HOP_ENTRY)
    remote = peers.Tile(source.data_ptr(), place, 1, nbytes, nbytes, nbytes)
    local = peers.Tile(source.data_ptr(), target, 1, nbytes, nbytes, nbytes)
    scratch = []

    def looped(tiles, remote_count):
        own, succ = (torch.zeros(peers.COUNTER_BYTES, dtype=torch.uint8,
                                 device=device) for _ in range(2))
        scratch.extend((own, succ))
        launch(peers.hop_args(tiles, remote_count, succ.data_ptr(),
                              segments, succ.data_ptr(), ep.report_dev,
                              10 ** 9))
        succ.view(torch.int64)[peers.POSTED // 8] = 1 << 62
        own.view(torch.int64)[peers.RECV // 8] = 1 << 62
        # the same arguments every call: the card numbers each hop
        args = peers.hop_args(tiles, remote_count, succ.data_ptr(),
                              segments, own.data_ptr(), ep.report_dev,
                              10 ** 9)
        return lambda: launch(args)
    calls = {"hop": looped([remote], 1), "copy_sync": looped([local], 0),
             "sync": looped([], 0)}
    own = torch.zeros(peers.COUNTER_BYTES, dtype=torch.uint8, device=device)
    scratch.append(own)
    copy_args = peers.hop_args([local], 0, None, [], own.data_ptr(),
                               None, 10 ** 9)
    calls["copy"] = lambda: launch(copy_args)
    calls["_scratch"] = scratch
    return calls


def child_ring(rank, n, device, ring):
    """One process of the ring launch: the main path with the counts set
    to 0 before it and read after (the conv5 temporal hop, a d2
    forward's 19-leaf gather, a reduce-scatter, ``ShardedInference``'s
    run, which captures the step as one CUDA graph, and predict at full
    width over the launch's dp 1 x sp 2 mesh), then each result held to
    its plain version on the same inputs, PROCESS_REPLAYS replays of the
    captured run each bitwise the eager step, and the times. Every
    process makes every member's inputs from one seed and runs the same
    steps in the same order."""
    import numpy as np
    import torch
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.ops import handoff_dma as dma
    from rnb_tpu_torch.parallel import (ShardedInference, build_mesh,
                                        distributed, make_sharded_inference,
                                        peers)
    gen = torch.Generator().manual_seed(2024)
    leaves = ring_leaves(n)
    forward = [ring_members(shape, fmt, dtype, n, gen, device)
               for _, (shape, fmt, dtype) in sorted(leaves.items())]
    conv5 = forward[sorted(leaves).index(
        "net.conv5.block1.conv2.temporal.weight")]
    operands = ring_members((16, 400), torch.contiguous_format,
                            torch.float32, n, gen, device)
    rng = np.random.default_rng(43)
    t0 = time.time()
    si = make_sharded_inference(
        mesh=distributed.global_mesh(axes={"dp": 1, "sp": n}),
        max_clips=MESH_MAX_CLIPS, num_classes=400, pixel_path="rgb")
    build_s = time.time() - t0
    videos = rng.integers(0, 256, si.batch_shape(len(PROCESS_VALID)),
                          dtype=np.uint8)
    vids, mask = si.place(videos, PROCESS_VALID)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    hopped = dma.ring_shift([conv5[rank]], 1, ring)[0]
    gathered = dma.ring_all_gather_many([[m[rank]] for m in forward], 0,
                                        ring)
    scattered = dma.ring_psum_scatter([operands[rank]], ring, -1)[0]
    logits = si.run(vids, mask)
    preds = si.predict(videos, PROCESS_VALID)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    check(counts["ring_shift"] == PROCESS_RING_LAUNCHES
          and counts["normalize_u8"] == PROCESS_INGEST_LAUNCHES
          and sum(counts.values()) == PROCESS_RING_LAUNCHES
          + PROCESS_INGEST_LAUNCHES, "process %d's main path launched %s"
          % (rank, {k: v for k, v in counts.items() if v}))
    replays = check_replays(rank, si, rng)
    # each result against its plain version on the same inputs
    check(torch.equal(hopped, dma.ring_shift_reference(conv5, 1)[rank]),
          "process %d: the conv5 hop is not bitwise its plain version"
          % rank)
    for (name, (_, fmt, _)), members, (full,) in zip(
            sorted(leaves.items()), forward, gathered):
        want = torch.cat(members).contiguous(memory_format=fmt)
        check(torch.equal(full, want) and full.stride() == want.stride(),
              "process %d: the gather of %s is not the concatenation, laid "
              "out as it" % (rank, name))
    check(torch.equal(scattered, plain_psum_scatter(operands, -1)[rank]),
          "process %d: the reduce-scatter is not bitwise its plain version"
          % rank)
    one = ShardedInference(build_mesh([device] * n, axes={"dp": 1, "sp": n}),
                           max_clips=MESH_MAX_CLIPS, num_classes=400,
                           network=si.network)
    one_vids, one_mask = one.place(videos, PROCESS_VALID)
    single = one.run(one_vids, one_mask)
    with torch.inference_mode():
        one_eager = one.step(one_vids, one_mask)
    check(torch.equal(single, one_eager), "process %d: the one-process "
          "captured run is %g from its eager step"
          % (rank, float((single - one_eager).abs().max())))
    check(tuple(logits.shape) == (len(PROCESS_VALID), 400)
          and bool(torch.isfinite(logits).all()), "process %d: logits %s"
          % (rank, tuple(logits.shape)))
    got, want = logits.cpu().numpy(), single.cpu().numpy()
    bound = PARALLEL_TOL + PARALLEL_TOL * np.abs(want)
    err = np.abs(got - want)
    check((err <= bound).all(), "process %d: the run across processes is "
          "%g from the one-process run, past rtol = atol = %g"
          % (rank, float(err.max()), PARALLEL_TOL))
    ids = {"held": 0, "agreed": 0, "near_ties": 0}
    for j in range(len(PROCESS_VALID)):
        top = np.argsort(want[j])[-2:]
        gap = float(want[j, top[1]] - want[j, top[0]])
        agreed = int(preds[j]) == int(top[1])
        held = gap > float(bound[j, top[1]] + bound[j, top[0]])
        check(agreed or not held, "process %d video %d: class id %d, the "
              "one-process run's %d past the margin"
              % (rank, j, int(preds[j]), int(top[1])))
        ids["held"] += int(held)
        ids["agreed"] += int(agreed)
        ids["near_ties"] += int(not held)
    # the times: the hop's launch alone, L2 warm and flushed, and its
    # parts (profiler device time, hop_calls), and Tensor.copy_ of the
    # same bytes into the successor's arena; then the hop with its
    # semaphores and the whole run (CUDA events). The successor's target
    # is a lease of its arena, its place sent through the store
    ep = peers.endpoint(ring)
    nbytes = conv5[rank].numel() * conv5[rank].element_size()
    succ = (ep.member + 1) % n
    (target,) = ep.empty([((nbytes,), (1,), torch.uint8)])
    ep.store.set("rnb-smoke/target/%d" % rank, str(ep.arena.place(
        target.data_ptr(), nbytes)))
    place = int(ep.store.get("rnb-smoke/target/%d" % succ))
    segment, offset = divmod(place, 1 << peers.SEGMENT_SHIFT)
    target_ptr = ep.peer_segments[succ][segment][0] + offset
    # the shard's bytes (it is channels-last: no flat view of its dims)
    source = torch.empty(0, dtype=torch.uint8, device=device).set_(
        conv5[rank].untyped_storage())
    check(source.numel() == nbytes, "the conv5 shard holds %d bytes of "
          "storage, not %d" % (source.numel(), nbytes))
    calls = hop_calls(ep, source, target_ptr, place, device)
    window = peer_tensor(target_ptr, nbytes, device)
    # what one process does alone is timed while the other waits at the
    # barrier, its context idle: two contexts time-slice the card, and a
    # kernel's span would hold the other's slices
    times = {"ms": None, "library_ms": None, "one_process_run_ms": None}
    torch.cuda.synchronize()
    ep.barrier("timing")
    if rank == 0:
        window.zero_()
        times["ms"] = device_ms(calls["hop"])
        times["ms_l2_flushed"] = flushed_ms(calls["hop"])
        torch.cuda.synchronize()
        check(torch.equal(window, source) and ep.reported() == 0,
              "the timed hop did not land the shard in the successor's "
              "arena (error word %d)" % ep.reported())
        for part in ("copy", "copy_sync", "sync"):
            times[part + "_ms"] = device_ms(calls[part])
        times["library_ms"] = device_ms(lambda: window.copy_(source))
        times["library_ms_l2_flushed"] = flushed_ms(
            lambda: window.copy_(source))
    torch.cuda.synchronize()
    ep.barrier("timed")
    del target

    def eager_across():
        with torch.inference_mode():
            si.step_across(vids, mask)
        si.finish()
    tiny = torch.arange(16, dtype=torch.uint8, device=device)
    times["round_trip_ms"] = median_ms(
        lambda: dma.ring_shift([conv5[rank]], 1, ring), PROCESS_REPS)
    times["tiny_round_trip_ms"] = median_ms(
        lambda: dma.ring_shift([tiny], 1, ring), PROCESS_REPS)
    times["run_ms"] = median_ms(lambda: si.run(vids, mask), RUN_REPS)
    times["eager_run_ms"] = median_ms(eager_across, RUN_REPS)
    torch.cuda.synchronize()
    ep.barrier("run timed")
    if rank == 0:
        times["one_process_run_ms"] = median_ms(
            lambda: one.run(one_vids, one_mask), RUN_REPS)
        with torch.inference_mode():
            times["one_process_eager_ms"] = median_ms(
                lambda: one.step(one_vids, one_mask), RUN_REPS)
    torch.cuda.synchronize()
    ep.barrier("one-process run timed")
    times["bound_ms"] = 2 * nbytes / PEAK_BYTES_PER_S * 1e3
    times["bytes"] = nbytes
    return {"counts": counts, "times": times, "ids": ids,
            "run_err": float(err.max()), "build_s": build_s,
            "arena_bytes": ep.arena.nbytes, "replays": replays}


def check_replays(rank, si, rng):
    """PROCESS_REPLAYS replays of ``si`` 's captured run across the
    processes, each on new videos of PROCESS_VALID clips, with the counts
    set to 0 before it and read after: one ring and one ingest launch (as
    the graph recorded them at capture), one host wait (at the run's
    end), and the logits bitwise the eager ``step_across`` on the same
    inputs (which waits for nothing until its ``finish``). Returns the
    graph's record: its launches, its host waits (0) and the replays'."""
    import numpy as np
    import torch
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.parallel import peers
    ((graph, capture),) = si._graphs.values()
    check(graph.launches == {"ring_shift": 1, "normalize_u8": 1}
          and capture.host_waits == 0 and capture.hops
          == {peers.endpoint(si.sp_ring): 1}, "process %d: the captured "
          "run recorded launches %s, hops %d, host waits %d" % (
              rank, graph.launches, sum(capture.hops.values()),
              capture.host_waits))
    for replay in range(PROCESS_REPLAYS):
        videos = rng.integers(0, 256, si.batch_shape(len(PROCESS_VALID)),
                              dtype=np.uint8)
        vids, mask = si.place(videos, PROCESS_VALID)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        waits = peers.host_waits
        out = si.run(vids, mask)
        waits = peers.host_waits - waits
        counts = {k: v for k, v in _kernels.launch_counts().items() if v}
        check(counts == graph.launches and waits == 1, "process %d replay "
              "%d: launches %s, host waits %d" % (rank, replay, counts,
                                                  waits))
        eager_waits = peers.host_waits
        with torch.inference_mode():
            eager = si.step_across(vids, mask)
        eager_waits = peers.host_waits - eager_waits
        si.finish()
        check(eager_waits == 0 and torch.equal(out, eager), "process %d "
              "replay %d: %g from the eager step_across (host waits in it "
              "%d)" % (rank, replay, float((out - eager).abs().max()),
                       eager_waits))
    return {"replays": PROCESS_REPLAYS, "launches": graph.launches,
            "graph_host_waits": capture.host_waits,
            "end_host_waits": 1, "graphs": dict(si.graph_stats)}


def child_killed(rank, n, device, ring):
    """One process of the killed-peer launch: both make the ring's
    endpoint with one hop, and capture a small ``ShardedInference`` 's run
    over the launch's dp 1 x sp n mesh (2 frames, layer sizes (1, 1, 1,
    1), 8 classes) and replay it once more, both alive; then process 1
    leaves without a word, and process 0's next replay must raise within
    the wait cap (set before the capture: a captured hop keeps the cap it
    was captured with), and then its next hop over the launch's other
    ring within the cap too."""
    import numpy as np
    import torch
    from rnb_tpu_torch.ops import handoff_dma as dma
    from rnb_tpu_torch.parallel import distributed, make_sharded_inference
    from rnb_tpu_torch.parallel import peers
    peers.set_wait_cap(PROCESS_KILL_CAP_S)
    x = torch.arange(4096, dtype=torch.uint8, device=device)
    first = dma.ring_shift([x], 1, ring)[0]
    check(torch.equal(first, x), "the first hop of the killed-peer launch "
          "moved other bytes")
    si = make_sharded_inference(
        mesh=distributed.global_mesh(axes={"dp": 1, "sp": n}), max_clips=2,
        consecutive_frames=2, num_classes=8, layer_sizes=(1, 1, 1, 1))
    videos = np.random.default_rng(5).integers(
        0, 256, si.batch_shape(1), dtype=np.uint8)
    vids, mask = si.place(videos, [2])
    captured = si.run(vids, mask)
    again = si.run(vids, mask)
    check(torch.equal(captured, again) and si.graph_stats["graphs"] == 1,
          "the killed-peer launch's replays differ (graphs %s)"
          % si.graph_stats)
    torch.cuda.synchronize()
    peers.endpoint(si.sp_ring).barrier("replayed")
    if rank == 1:
        os._exit(0)
    report = {}
    for what, call in (("replay", lambda: si.run(vids, mask)),
                       ("hop", lambda: dma.ring_shift([x], 1, ring))):
        t0 = time.monotonic()
        try:
            call()
            message = None
        except RuntimeError as e:
            message = str(e)
        seconds = time.monotonic() - t0
        check(message is not None and "past the %.1f s cap"
              % PROCESS_KILL_CAP_S in message, "a %s after the peer died "
              "did not raise within the cap: %r" % (what, message))
        report[what] = {"message": message, "seconds": seconds}
    check(report["replay"]["seconds"] < PROCESS_KILL_CAP_S + 10, "the "
          "replay raised after %.1f s" % report["replay"]["seconds"])
    return {"message": report["replay"]["message"],
            "seconds": report["replay"]["seconds"],
            "hop_message": report["hop"]["message"],
            "hop_seconds": report["hop"]["seconds"]}


def process_child(mode, out_dir) -> int:
    """``chip_smoke.py --process-child MODE OUT_DIR``: one process of a
    launch (``rnb_tpu_torch.tools.launch`` set its variables), on the
    card ``process_index() % device_count()``; writes its report to
    OUT_DIR as JSON."""
    import traceback
    import torch
    sys.path.insert(0, HERE)
    rank = os.environ.get("RNB_TPU_PROCESS_ID", "?")
    report = {"ok": False}
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        from rnb_tpu_torch.parallel import distributed
        from rnb_tpu_torch.parallel.mesh import Member, Ring
        check(distributed.maybe_initialize(), "the launch was not joined")
        n = distributed.process_count()
        device = distributed.local_device()
        torch.cuda.set_device(device)
        ring = Ring([Member(p, distributed.local_device(p))
                     for p in range(n)], "tp")
        child = {"ring": child_ring, "killed": child_killed}[mode]
        report.update(child(distributed.process_index(), n, device, ring))
        report["ok"] = True
    except Exception:  # reported to the smoke, which fails on it
        report["error"] = traceback.format_exc()
        print(report["error"], file=sys.stderr)
    with open(os.path.join(out_dir, "child-%s-%s.json" % (mode, rank)),
              "w") as f:
        json.dump(report, f)
    if mode == "killed" or not report["ok"]:
        # a peer is gone, or this process failed: leave without the
        # group's goodbye (its barrier would wait for the cap)
        sys.stdout.flush()
        os._exit(0 if report["ok"] else 1)
    distributed.shutdown()
    return 0


def phase_processes(data_root, launches):
    """Two processes of one launch on the card (``rnb_tpu_torch.tools.
    launch``, the three ``RNB_TPU_*`` variables set): the ring
    collectives across processes and ``ShardedInference.run`` at full
    width (:func:`child_ring`), then a killed peer (:func:`child_killed`).
    A child that fails or times out fails the smoke. Their ring_shift
    and ingest launches go to ``launches``; returns the cross-process
    numbers for the ring row."""
    from rnb_tpu_torch.tools.launch import launch
    smi = nvidia_smi_line()
    out = os.path.abspath(os.path.join(data_root, "processes"))
    os.makedirs(out, exist_ok=True)
    reports = {}
    for mode in ("ring", "killed"):
        t0 = time.time()
        ended = launch(PROCESSES, [sys.executable, os.path.join(
            HERE, "chip_smoke.py"), "--process-child", mode, out],
            PROCESS_TIMEOUT_S, cwd=HERE)
        for e in ended:
            path = os.path.join(out, "child-%s-%d.json" % (mode, e.index))
            report = {"ok": False, "error": "no report"}
            if os.path.exists(path):
                with open(path) as f:
                    report = json.load(f)
            check(e.returncode == 0 and (report["ok"] or (
                mode == "killed" and e.index > 0)),
                  "process %d of the %s launch: %s\n%s\n%s" % (
                      e.index, mode, "killed at the timeout"
                      if e.returncode is None else "exit %d" % e.returncode,
                      report.get("error"), e.stderr[-6000:]))
            reports[mode, e.index] = report
        print("processes %s launch: %.1f s" % (mode, time.time() - t0))
    first = reports["ring", 0]["times"]
    print("processes ring: the conv5 hop (%d bytes) alone %.5f ms on the "
          "card, %.5f with L2 flushed (one launch into the successor's "
          "arena, its waits satisfied, the other process idle; bound "
          "%.5f ms by bytes); its parts: the copy alone %.5f ms, the copy "
          "with the post, waits and publication %.5f, the post, waits and "
          "publication alone (one block) %.5f; Tensor.copy_ into the "
          "peer's arena %.5f ms, %.5f flushed; the one-process captured "
          "run %.3f ms (median of %d), its eager step %.3f (%s)" % (
              first["bytes"], first["ms"], first["ms_l2_flushed"],
              first["bound_ms"], first["copy_ms"], first["copy_sync_ms"],
              first["sync_ms"], first["library_ms"],
              first["library_ms_l2_flushed"],
              first["one_process_run_ms"][0], RUN_REPS,
              first["one_process_eager_ms"][0], smi))
    for rank in range(PROCESSES):
        report = reports["ring", rank]
        for name, count in report["counts"].items():
            launches[name] += count
        t = report["times"]
        print("processes ring, process %d: the conv5 hop with its "
              "semaphores %.3f ms (min %.3f, max %.3f), a 16-byte hop %.3f "
              "ms (min %.3f, max %.3f); the captured run across %d "
              "processes %.3f ms (median of %d; min %.3f, max %.3f), the "
              "eager step_across with its wait %.3f ms (min %.3f, max "
              "%.3f); run %g from the one-process run; class ids %s; arena "
              "%d bytes; launches %s; %d replays bitwise the eager step, "
              "each launching %s, host waits inside the graph %d and at "
              "the run's end %d (%s)" % (
                  rank, *t["round_trip_ms"], *t["tiny_round_trip_ms"],
                  PROCESSES, t["run_ms"][0], RUN_REPS, *t["run_ms"][1:],
                  *t["eager_run_ms"], report["run_err"],
                  json.dumps(report["ids"]), report["arena_bytes"],
                  {k: v for k, v in report["counts"].items() if v},
                  report["replays"]["replays"],
                  report["replays"]["launches"],
                  report["replays"]["graph_host_waits"],
                  report["replays"]["end_host_waits"], smi))
    killed = reports["killed", 0]
    print("processes killed peer: process 0's replay of the captured run "
          "raised after %.2f s (cap %.1f s): %s; its next hop after %.2f s: "
          "%s" % (killed["seconds"], PROCESS_KILL_CAP_S, killed["message"],
                  killed["hop_seconds"], killed["hop_message"]))
    return {"xproc_ms": first["ms"],
            "xproc_ms_l2_flushed": first["ms_l2_flushed"],
            "xproc_copy_ms": first["copy_ms"],
            "xproc_sync_ms": first["sync_ms"],
            "xproc_copy_sync_ms": first["copy_sync_ms"],
            "xproc_round_trip_ms": first["round_trip_ms"][0],
            "xproc_tiny_round_trip_ms": first["tiny_round_trip_ms"][0],
            "xproc_library_ms": first["library_ms"],
            "xproc_library_ms_l2_flushed": first["library_ms_l2_flushed"],
            "xproc_bound_ms": first["bound_ms"],
            "xproc_run_ms": first["run_ms"][0],
            "xproc_eager_run_ms": first["eager_run_ms"][0],
            "xproc_launches": sum(reports["ring", r]["counts"]["ring_shift"]
                                  for r in range(PROCESSES)),
            "xproc_kill_s": killed["seconds"]}


def check_served_weights(label, runner, file_state, seeded):
    """Every parameter and buffer of ``runner``'s network on the card is
    the file's tensor of its range cast to the network's dtype, bitwise;
    every conv kernel and the head differ from the seeded network's.
    Returns the values held."""
    import torch
    from rnb_tpu_torch.models.r2p1d.checkpoint import filter_layer_range
    want = filter_layer_range(file_state, runner.start_index,
                              runner.end_index)
    held = runner.network.state_dict()
    check(set(held) == set(want), "%s: step [%d..%d] holds %d keys, its "
          "range %d (%s)" % (label, runner.start_index, runner.end_index,
                             len(held), len(want), sorted(
                                 set(held) ^ set(want))[:5]))
    drawn = seeded.state_dict()
    for key, value in held.items():
        check(value.device.type == "cuda" and torch.equal(
            value.cpu(), want[key].to(value.dtype)), "%s: %s on the card "
            "is not the file's tensor in %s" % (label, key, value.dtype))
        if key.endswith("weight") and value.dim() > 1:
            check(not torch.equal(value, drawn[key]), "%s: %s equals the "
                  "seeded init's" % (label, key))
    return sum(v.numel() for v in held.values())


def phase_ckpt(data_root, launches):
    """Serve converted checkpoints: draw a full-width state dict in the
    reference's torch format, centre its head on the dataset, save it as
    a ``.pth.tar`` and ``convert_file`` it
    (``rnb_tpu_torch/tools/synth_ckpt.py``); serve its copies of
    ``configs/rnb-fused-yuv-big-torchckpt.json`` (64 requests in bulk)
    and ``configs/r2p1d-split-1chip.json`` (16), ``ckpt_path`` at the
    converted file on every runner step: each stage's weights on the
    card the file's range bitwise, the graphs bitwise their eager
    forwards, finite logits, more than one class id, requests recomputed
    on the CPU from the same file, ``check_job`` green, the path's kernel
    launched (``rnb_yuv420_normalize`` once an emission;
    ``rnb_normalize_u8``) and no other; then the CLI on a copy whose
    ``ckpt_path`` names no file ends with the reference's
    ``FileNotFoundError`` before any request. Adds the served runs'
    launches to ``launches``."""
    import numpy as np
    import torch
    from rnb_tpu_torch.benchmark import run_benchmark
    from rnb_tpu_torch.models.r2p1d.checkpoint import load_checkpoint
    from rnb_tpu_torch.models.r2p1d.model import R2P1DRunner, shared_network
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.parse_utils import check_job, summarize
    from rnb_tpu_torch.tools import synth_ckpt
    os.environ["RNB_TPU_DATA_ROOT"] = data_root
    card = torch.device("cuda", 0)
    ckpt_dir = os.path.abspath(os.path.join(data_root, "ckpt"))
    made = synth_ckpt.make(ckpt_dir, data_root, card, repo=HERE)
    converted = made["converted"]
    file_state = load_checkpoint(converted)
    print("ckpt: %s" % json.dumps({k: v for k, v in made.items()
                                   if k != "copies"}))
    check(len(file_state) == 202 and made["values"] == CKPT_VALUES,
          "ckpt: %d keys converted from %d, %d values" % (
              len(file_state), made["keys"], made["values"]))
    for label, videos, kernel, steps in CKPT_RUNS:
        config_path = made["copies"][label]
        sink, stages = {}, []
        _kernels.reset_launches()
        t0 = time.time()
        result = run_benchmark(
            config_path, mean_interval_ms=0, num_videos=videos,
            print_progress=False, log_base=os.path.join(data_root, "logs"),
            seed=0, outputs_sink=sink, stages_sink=stages)
        counts = _kernels.launch_counts()
        wall = time.time() - t0
        check(result.termination_flag == 0, "%s terminated with flag %d"
              % (label, result.termination_flag))
        check(result.num_completed == videos and sorted(sink) == list(
            range(videos)), "%s: %d completed, outputs of %s" % (
                label, result.num_completed, sorted(sink)))
        problems = check_job(result.log_dir)
        check(not problems, "%s: check_job: %s" % (label,
                                                  "; ".join(problems[:5])))
        runners = [s for _, s in stages if isinstance(s, R2P1DRunner)]
        check(len(runners) == steps and all(
            r.ckpt_path == converted and r.factored_shortcut
            for r in runners), "%s: runners %s" % (
                label, [(r.ckpt_path, r.factored_shortcut) for r in runners]))
        held = 0
        for runner in runners:
            seeded = shared_network(runner.start_index, runner.end_index,
                                    runner.num_classes, runner.layer_sizes,
                                    card, factored_shortcut=True)
            held += check_served_weights(label, runner, file_state, seeded)
        for name, count in counts.items():
            if name == kernel:
                check(result.window_launches[name] > 0, "%s: kernel %s was "
                      "not launched in the measured window" % (label, name))
            else:
                check(count == 0, "%s: kernel %s, not of this config, was "
                      "launched" % (label, name))
            launches[name] += count
        stats = summarize(result.log_dir)
        if kernel == "yuv420_normalize":
            check(result.window_launches[kernel] == stats["emissions"],
                  "%s: %d %s launches for %d emissions" % (
                      label, result.window_launches[kernel], kernel,
                      stats["emissions"]))
        with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
            backends = [line.split(": ", 1)[1] for line in
                        f.read().splitlines()
                        if line.startswith("Decode backend: ")]
        check(backends and all(b == "native" for b in backends),
              "%s: y4m requests decoded by %s, not the native pool"
              % (label, backends))
        check_graphs(label, result, stages)
        del stages, runners
        class_ids = set()
        for rid, (_video, logits, _stamps) in sink.items():
            check(logits.ndim == 2 and logits.shape[1] == 400
                  and logits.shape[0] >= 1 and np.isfinite(logits).all(),
                  "%s request %d: logits of shape %s, finite %s" % (
                      label, rid, logits.shape, np.isfinite(logits).all()))
            class_ids.add(int(logits.sum(axis=0).argmax()))
        check(len(class_ids) > 1, "%s: every request served class id %s"
              % (label, class_ids))
        by_clips = sorted(sink, key=lambda r: (sink[r][1].shape[0], r))
        picks = by_clips[:2] + by_clips[-1:]
        t0 = time.time()
        report = cpu_recompute(config_path, sink, picks)
        print("path %s: %d requests, %d clips, %.3f videos/s, %.3f clips/s, "
              "wall %.1f s, %d values held bitwise the file's, %d class "
              "ids, launches %s (window %s), graphs %s; recompute of "
              "requests %s (%.1f s): %s" % (
                  label, result.num_completed, result.clips_completed,
                  result.throughput_vps, stats["clips_per_s"], wall, held,
                  len(class_ids), counts, result.window_launches,
                  json.dumps(result.graphs, sort_keys=True), picks,
                  time.time() - t0, json.dumps(report)))
        torch.cuda.empty_cache()
    # a mistyped path: the stage raises the reference's message before
    # the start barrier, the run serves nothing and the CLI exits 1
    missing = os.path.join(ckpt_dir, "missing.pt")
    config_path = synth_ckpt.ckpt_copy(
        os.path.join(HERE, TORCHCKPT),
        os.path.join(ckpt_dir, CKPT_MISSING + ".json"), missing)
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "rnb_tpu_torch.benchmark", "-c", config_path,
         "-mi", "0", "-v", str(CKPT_MISSING_VIDEOS), "--log-base",
         os.path.join(data_root, "logs")],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    message = ("FileNotFoundError: explicit ckpt_path %r does not exist; "
               "convert or save a checkpoint there first "
               "(models/r2p1d/convert.py)" % (missing,))
    results = [json.loads(line[len("Result: "):]) for line in
               proc.stdout.splitlines() if line.startswith("Result: ")]
    check(proc.returncode != 0 and message in proc.stderr and len(
        results) == 1 and results[0]["completed"] == 0,
          "%s: exit %d, results %s, stderr:\n%s" % (
              CKPT_MISSING, proc.returncode, results, proc.stderr[-3000:]))
    print("path %s: exit %d in %.1f s, %s" % (
        CKPT_MISSING, proc.returncode, time.time() - t0, json.dumps(
            {k: results[0][k] for k in ("completed", "termination_flag")})))


def phase_bench_cuda(data_root):
    """``bench_cuda.py`` as the port's headline entry point, in a process
    of its own (``RNB_BENCH_VIDEOS`` 300, its dataset under the smoke's
    root): its one JSON line parses, serves on the card through the
    native pool with the yuv420 ingest, and carries a positive value and
    a numeric MFU."""
    env = dict(os.environ, RNB_BENCH_VIDEOS=str(BENCH_CUDA_VIDEOS),
               RNB_TPU_DATA_ROOT=os.path.join(data_root, "bench_cuda_y4m"),
               RNB_BENCH_LOG_BASE=os.path.join(data_root, "logs"))
    env.pop("RNB_BENCH_PLATFORM", None)
    t0 = time.time()
    proc = subprocess.run([sys.executable, os.path.join(HERE, "bench_cuda.py")],
                          cwd=HERE, env=env, capture_output=True, text=True,
                          timeout=600)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and len(lines) == 1,
          "bench_cuda.py exited %d with %d line(s):\n%s\n%s" % (
              proc.returncode, len(lines), proc.stdout, proc.stderr[-4000:]))
    line = json.loads(lines[0])
    for ok, what in (
            (line.get("value") is not None and line["value"] > 0,
             "value %r" % line.get("value")),
            (line.get("platform") == "gpu", "platform %r"
             % line.get("platform")),
            (line.get("decode_backend") == "native-y4m",
             "decode_backend %r" % line.get("decode_backend")),
            (isinstance(line.get("mfu"), (int, float)),
             "mfu %r" % line.get("mfu")),
            (line.get("kernel_launches", {}).get("yuv420_normalize", 0) > 0,
             "yuv420_normalize launches %r"
             % line.get("kernel_launches"))):
        check(ok, "bench_cuda.py: %s" % what)
    print("bench_cuda (%.1f s): %s" % (time.time() - t0, lines[0]))


def tool_run(argv, env, what):
    """One of the port's tools as a user runs it, in a process of its
    own from the checkout's root: -> its standard output. Fails the
    smoke on a non-zero exit."""
    proc = subprocess.run([sys.executable, "-m"] + argv, cwd=HERE, env=env,
                          capture_output=True, text=True,
                          timeout=TOOLS_TIMEOUT_S)
    check(proc.returncode == 0, "%s exited %d:\n%s\n%s" % (
        what, proc.returncode, proc.stdout[-4000:], proc.stderr[-4000:]))
    return proc.stdout


def check_tool_row(what, row, mi, kernel, launches):
    """A matrix or frontier row: served on the card at the asked mean
    interval, a positive value, its job directory clean under
    ``check_job_detail``, and its path's ingest kernel launched (added
    to ``launches``)."""
    from rnb_tpu_torch.parse_utils import check_job_detail
    job = os.path.join(HERE, row.get("evidence_logs") or "-")
    for ok, fact in (
            ("error" not in row and row.get("bench_rc") == 0,
             "error %r (rc %r)" % (row.get("error"), row.get("bench_rc"))),
            (row.get("value") is not None and row["value"] > 0,
             "value %r" % row.get("value")),
            (row.get("platform") == "gpu", "platform %r"
             % row.get("platform")),
            (row.get("mean_interval_ms") == mi,
             "mean_interval_ms %r" % row.get("mean_interval_ms")),
            (row.get("kernel_launches", {}).get(kernel, 0) > 0,
             "%s launches %r" % (kernel, row.get("kernel_launches"))),
            (os.path.isdir(job), "evidence_logs %r"
             % row.get("evidence_logs"))):
        check(ok, "%s: %s" % (what, fact))
    problems, parse_failed = check_job_detail(job)
    check(not problems and not parse_failed, "%s: check_job: %s"
          % (what, "; ".join(problems[:5])))
    for name, count in row["kernel_launches"].items():
        launches[name] += count


def phase_tools(data_root, launches):
    """The port's measurement tools through their CLIs, over
    ``bench_cuda.py``'s dataset: ``tools/bench_matrix.py --only`` on
    three cells of 200 requests (big in bulk and in Poisson at 6 ms,
    ``r2p1d-whole`` in bulk), ``tools/latency_frontier.py`` on mid at 4
    and 9 ms, each cell a fresh ``bench_cuda.py`` process whose row
    names its job directory; ``tools/latency_summary.py`` over both
    outputs (one row a job); ``parse_utils --stamps``. Adds the cells'
    launches to ``launches``."""
    t0 = time.time()
    out = os.path.abspath(os.path.join(data_root, "tools"))
    env = dict(os.environ,
               RNB_TPU_DATA_ROOT=os.path.abspath(
                   os.path.join(data_root, "bench_cuda_y4m")),
               RNB_MATRIX_VIDEOS=str(TOOLS_VIDEOS),
               RNB_MATRIX_MI=str(TOOLS_MI),
               RNB_MATRIX_OUT=os.path.join(out, "matrix"),
               RNB_FRONTIER_VIDEOS=str(TOOLS_VIDEOS),
               RNB_FRONTIER_OUT=os.path.join(out, "frontier"))
    for key in ("RNB_BENCH_PLATFORM", "RNB_FAULT_PLAN", "RNB_BENCH_DATASET"):
        env.pop(key, None)
    only = [a for cell in MATRIX_CELLS for a in ("--only", cell)]
    tool_run(["rnb_tpu_torch.tools.bench_matrix"] + only, env,
             "bench_matrix")
    with open(os.path.join(out, "matrix", "BENCH_MATRIX.json")) as f:
        rows = json.load(f)["rows"]
    check(sorted(r.get("cell") for r in rows) == sorted(MATRIX_CELLS),
          "bench_matrix ran %s" % [r.get("cell") for r in rows])
    for row in rows:
        mi = int(row["cell"].split("@")[1])
        check_tool_row("matrix %s" % row["cell"], row, mi,
                       MATRIX_CELLS[row["cell"]], launches)
        print("tools matrix %s (%.1f s): %.3f videos/s, p50 %s ms, p99 %s "
              "ms, %s, %s launches %d, %s" % (
                  row["cell"], row["cell_wall_s"], row["value"],
                  row["p50_ms"], row["p99_ms"], row["latency_semantics"],
                  MATRIX_CELLS[row["cell"]],
                  row["kernel_launches"][MATRIX_CELLS[row["cell"]]],
                  row["evidence_logs"]))
    only = [a for cell in FRONTIER_CELLS for a in ("--only", cell)]
    tool_run(["rnb_tpu_torch.tools.latency_frontier"] + only, env,
             "latency_frontier")
    with open(os.path.join(out, "frontier", "FRONTIER.json")) as f:
        frontier = json.load(f)["rows"]
    check(sorted(r.get("cell") for r in frontier) == sorted(FRONTIER_CELLS),
          "latency_frontier ran %s" % [r.get("cell") for r in frontier])
    for row in frontier:
        check(row.get("termination_flag") == 0, "frontier %s: termination "
              "flag %r" % (row["cell"], row.get("termination_flag")))
        check_tool_row("frontier %s" % row["cell"], row,
                       int(row["cell"].split("@")[1]), "yuv420_normalize",
                       launches)
        print("tools frontier %s (%.1f s): offered %.3f req/s, %.3f "
              "videos/s, p50 %s ms, p99 %s ms" % (
                  row["cell"], row["cell_wall_s"], row["offered_rps"],
                  row["value"], row["p50_ms"], row["p99_ms"]))
    summary_json = os.path.join(out, "latency_summary.json")
    text = tool_run(["rnb_tpu_torch.tools.latency_summary", "--recursive",
                     "--log-base", os.path.join(out, "matrix"),
                     "--log-base", os.path.join(out, "frontier"),
                     "--json", summary_json], env, "latency_summary")
    with open(summary_json) as f:
        summary = json.load(f)["rows"]
    jobs = sorted(os.path.basename(r["evidence_logs"])
                  for r in rows + frontier)
    check(sorted(r["job_id"] for r in summary) == jobs,
          "latency_summary rows %s, the cells' jobs %s"
          % ([r["job_id"] for r in summary], jobs))
    for line in text.splitlines():
        if "end-to-end mean latency" in line:
            print("tools summary %s" % line)
    stamps = tool_run(["rnb_tpu_torch.parse_utils", "--stamps"], env,
                      "parse_utils --stamps")
    check("## TimeCard stamps" in stamps and "## HBM-ledger owners" in stamps,
          "parse_utils --stamps printed no registry")
    print("tools: %d matrix rows, %d frontier rows, %d summary rows, "
          "--stamps %d lines (%.1f s)" % (len(rows), len(frontier),
                                          len(summary),
                                          len(stamps.splitlines()),
                                          time.time() - t0))


def phase_explain(data_root, launches):
    """The three legs of ``rnb_tpu_torch/tools/explain.py`` on the card:
    (1) ``--explain`` on the critpath job ``phase_path`` served; (2) the
    one-card r1 copy with ``metrics`` and ``whatif`` served at
    ``phase_lanes``' workload, a model calibrated from its job directory
    alone asked for three more step-1 lanes, against the r4 copy's
    videos/s from ``phase_lanes`` over this r1's (within 25%); (3) two
    same-seed Poisson runs (20 ms) of ``configs/rnb-fused-yuv.json``'s
    one-card copy, arm B with a 5 ms latency fault at its runner step:
    ``rnb_diff`` names that step's ``inference1``, 2.5-10 ms a request,
    and a self-diff of arm A finds nothing. Each served run launches
    its own kernel and no other; the launches are added to
    ``launches``."""
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.tools import explain, rnb_diff
    t0 = time.time()
    failures, leg1 = explain.leg_critpath(EXPLAIN_JOBS[CRITPATH])
    check(not failures, "explain leg 1: %s" % "; ".join(failures))
    print("explain leg 1: worst residual %.6f ms, --explain rc %d"
          % (leg1["worst_residual_ms"], leg1["explain_rc"]))
    os.environ["RNB_TPU_DATA_ROOT"] = data_root
    logs = os.path.join(data_root, "logs")

    def serve(path, videos, mi, seed, queue, kernel):
        _kernels.reset_launches()
        result = explain.serve(path, videos, mi, seed, logs, queue)
        counts = _kernels.launch_counts()
        for name, count in counts.items():
            check((count > 0) == (name == kernel), "%s: launches %s"
                  % (os.path.basename(path), counts))
            launches[name] += count
        return result

    r1 = serve(explain.whatif_copy(data_root), LANES_VIDEOS, 0, LANES_SEED,
               LANES_QUEUE, "ragged_normalize_u8")
    r4_vps = UNARMED_VPS[LANES_R4]
    failures, leg2 = explain.leg_whatif(r1.log_dir, r1.throughput_vps,
                                        r4_vps)
    print("explain leg 2: r1 with metrics %.3f videos/s, r4 %.3f; "
          "predicted r4/r1 %.4f against %.4f measured (rel err %.2f%%)"
          % (r1.throughput_vps, r4_vps, leg2["pred_ratio"],
             leg2["measured_ratio"], 100.0 * leg2["rel_err"]))
    check(not failures, "explain leg 2: %s" % "; ".join(failures))
    path_a, path_b, step = explain.attribution_copies(data_root)
    arms = [serve(path, explain.ATTRIBUTION_VIDEOS, explain.ATTRIBUTION_MI,
                  explain.ATTRIBUTION_SEED, 50000, "yuv420_normalize")
            for path in (path_a, path_b)]
    failures, report = explain.leg_attribution(
        arms[0].log_dir, arms[1].log_dir, "inference%d" % step)
    for line in rnb_diff.report_lines(report):
        print("explain leg 3: %s" % line)
    check(not failures, "explain leg 3: %s" % "; ".join(failures))
    print("explain: arms A/B %.3f / %.3f videos/s, p50 %.3f / %.3f ms; "
          "three legs hold (%.1f s)" % (
              arms[0].throughput_vps, arms[1].throughput_vps,
              arms[0].p50_latency_ms, arms[1].p50_latency_ms,
              time.time() - t0))


def write_mjpeg_trees(data_root):
    """The phase's two trees under ``data_root``, written at the same
    time by two processes of ``rnb_tpu_torch.dataset``, each write
    timed: -> ``{tree: root}``."""
    from rnb_tpu_torch.dataset import DCT_QUALITY, PIXEL_QUALITY
    trees = (("mjpeg", PIXEL_QUALITY, ()),
             ("mjpeg-dct", DCT_QUALITY, ("--dct-budget",)))
    procs = {tree: subprocess.Popen(
        [sys.executable, "-m", "rnb_tpu_torch.dataset",
         os.path.join(data_root, tree), "--videos", str(MJPEG_TREE_VIDEOS),
         "--format", "mjpeg", "--quality", str(quality), *extra],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for tree, quality, extra in trees}
    roots = {}
    for tree, quality, _ in trees:
        out, _ = procs[tree].communicate(timeout=600)
        check(procs[tree].returncode == 0, "writing the %s tree failed:\n%s"
              % (tree, out))
        root = roots[tree] = os.path.join(data_root, tree)
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, files in os.walk(root) for f in files)
        print("mjpeg tree at quality %d, %.1f MB: %s" % (
            quality, size / 1e6, out.strip()))
    return roots


def check_mjpeg_dct_rows(root):
    """The native pool's coefficient rows of sampled clips of the dct
    tree are bitwise the pure-Python ``jpeg_dct``'s
    (``MjpegPILDecoder``'s dct entry) and the encoder's own coefficients,
    dequantized and packed. Returns the frames held."""
    import numpy as np
    from rnb_tpu_torch.dataset import DCT_QUALITY, synth_frames
    from rnb_tpu_torch.decode import MjpegPILDecoder, get_decoder
    from rnb_tpu_torch.decode.mjpeg_encode import (ZIGZAG_NATURAL,
                                                   encode_frames,
                                                   quant_tables)
    from rnb_tpu_torch.ops.dct import num_dct_blocks, pack_frame_dct
    from rnb_tpu_torch.video_path_provider import scan_video_tree
    videos = scan_video_tree(root)
    luma_q, chroma_q = quant_tables(DCT_QUALITY)
    ny = (HW // 8) ** 2
    q = np.concatenate([np.tile(luma_q[ZIGZAG_NATURAL], (ny, 1)),
                        np.tile(chroma_q[ZIGZAG_NATURAL],
                                (num_dct_blocks(HW, HW) - ny, 1))])
    held = 0
    for i in range(MJPEG_DCT_SAMPLES):
        # video i of the tree is the generator's [7, i % 4, i // 4]
        video = [v for v in videos
                 if os.path.basename(v) == "v%03d.mjpg" % i][0]
        decoder = get_decoder(video)
        check(decoder.BACKEND == "native", "%s decodes on %s" % (
            video, decoder.BACKEND))
        starts = [0, 120]  # the last clip runs past the end: repeats
        native = decoder.decode_clips_dct(video, starts, FRAMES, HW, HW)
        plain = MjpegPILDecoder().decode_clips_dct(video, starts, FRAMES,
                                                   HW, HW)
        check(np.array_equal(native, plain), "%s: native dct rows differ "
              "from jpeg_dct's in %d elements" % (
                  video, int((native != plain).sum())))
        frames = synth_frames(128, HW, HW, seed=[7, i % 4, i // 4])
        _, zz = encode_frames(frames, DCT_QUALITY)
        for ci, start in enumerate(starts):
            for fi in range(FRAMES):
                idx = min(start + fi, 127)
                want = pack_frame_dct(zz[idx] * q, HW, HW)
                check(np.array_equal(native[ci, fi], want), "%s frame %d: "
                      "native dct row is not the encoder's" % (video, idx))
                held += 1
    return held


def check_busy_probe():
    """The busy-card probe against a child process that holds
    ``BUSY_CHILD_MIB`` on the card. What cuda:0 held before the child
    (this process's own context, and any other process: a monitor,
    another checkout's run) is the baseline, printed and not required
    to be empty. With the child, the other processes that ``nvidia-smi``
    lists on cuda:0 are the baseline's plus exactly one (where it names
    processes by host pid, holding at least ``BUSY_CHILD_MIB`` more),
    and ``probe_busy_devices`` warns about cuda:0. The child is stopped
    either way. Returns the baseline ``(count, MiB, warnings)``, the
    warnings with the child, and the seconds one probe took."""
    from rnb_tpu_torch.devices import (DeviceSpec, other_processes,
                                       probe_busy_devices, read_card_memory)
    spec = [DeviceSpec(0, "cuda")]

    def others():
        return other_processes(read_card_memory()[0], os.getpid(), True)

    t0 = time.time()
    alone = probe_busy_devices(spec)
    probe_s = time.time() - t0
    base_count, base_mib = others()
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, torch\n"
         "x = torch.empty(%d << 20, dtype=torch.uint8, device='cuda')\n"
         "torch.cuda.synchronize()\n"
         "print('holding', flush=True)\n"
         "sys.stdin.read()\n" % BUSY_CHILD_MIB],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        ready = child.stdout.readline().strip()
        check(ready == "holding", "the busy-card child did not start: %r"
              % ready)
        shared = probe_busy_devices(spec)
        count, mib = others()
    finally:
        child.stdin.close()
        try:
            child.wait(timeout=60)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
    check(count == base_count + 1, "the busy-card child added %d process(es)"
          " to the %d other(s) on cuda:0, not one" % (count - base_count,
                                                       base_count))
    if mib is not None and base_mib is not None:
        check(mib - base_mib >= BUSY_CHILD_MIB, "the busy-card child added "
              "%.1f MiB on cuda:0, under the %d MiB it holds"
              % (mib - base_mib, BUSY_CHILD_MIB))
    check(len(shared) == 1 and "cuda:0" in shared[0], "the busy-card probe "
          "did not warn about cuda:0 while a child held %d MiB there: %s"
          % (BUSY_CHILD_MIB, shared))
    return (base_count, base_mib, alone), shared, probe_s


def phase_mjpeg(data_root, launches):
    """Serve MJPEG files on the yuv420, dct and rgb paths (see the
    module docstring); adds the runs' launches to ``launches``."""
    import numpy as np
    from rnb_tpu_torch.benchmark import run_benchmark
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.parse_utils import summarize
    t_phase = time.time()
    roots = write_mjpeg_trees(data_root)
    for label, config, tree in MJPEG_RUNS:
        os.environ["RNB_TPU_DATA_ROOT"] = roots[tree]
        served = (async_producer_copy(data_root, config, label)
                  if label == MJPEG_BIG_ASYNC else os.path.join(HERE, config))
        sink, stages = {}, []
        _kernels.reset_launches()
        t0 = time.time()
        result = run_benchmark(
            served, mean_interval_ms=0,
            num_videos=VIDEOS_PER_RUN, print_progress=False,
            log_base=os.path.join(data_root, "logs"), seed=0,
            outputs_sink=sink, stages_sink=stages)
        counts = _kernels.launch_counts()
        wall = time.time() - t0
        check(result.termination_flag == 0, "%s terminated with flag %d"
              % (label, result.termination_flag))
        check(result.num_completed == VIDEOS_PER_RUN
              and result.num_failed + result.num_shed
              + result.num_retries == 0
              and sorted(sink) == list(range(VIDEOS_PER_RUN)),
              "%s: %d completed, %d dead-lettered, %d shed, %d retried, "
              "outputs of %s" % (label, result.num_completed,
                                 result.num_failed, result.num_shed,
                                 result.num_retries, sorted(sink)))
        with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
            meta = f.read().splitlines()
        backends = [line.split(": ", 1)[1] for line in meta
                    if line.startswith("Decode backend: ")]
        check(backends and all(b == "native" for b in backends),
              "%s: MJPEG requests decoded by %s, not the native pool"
              % (label, backends))
        check(all(video.endswith(".mjpg") for video, _, _ in sink.values()),
              "%s served other files than the tree's" % label)
        for rid, (video, logits, _stamps) in sink.items():
            check(logits.ndim == 2 and logits.shape[1] == 400
                  and np.isfinite(logits).all(), "%s request %d: logits of "
                  "shape %s, finite %s" % (label, rid, logits.shape,
                                           np.isfinite(logits).all()))
        for name, count in counts.items():
            if name in PATH_KERNELS[config]:
                check(result.window_launches[name] > 0, "%s: kernel %s was "
                      "not launched in the measured window" % (label, name))
            else:
                check(count == 0, "%s: kernel %s, not of this config, was "
                      "launched" % (label, name))
            launches[name] += count
        emissions = summarize(result.log_dir)["emissions"]
        if config in ONE_PER_EMISSION:
            name = ONE_PER_EMISSION[config]
            check(result.window_launches[name] == emissions,
                  "%s: %d %s launches for %d emissions"
                  % (label, result.window_launches[name], name, emissions))
        check_graphs(label, result, stages)
        del stages
        by_clips = sorted(sink, key=lambda r: (sink[r][1].shape[0], r))
        picks = by_clips[:1] + by_clips[-1:]
        t1 = time.time()
        report = cpu_recompute(served, sink, picks)
        print("path %s: %d requests, %d clips, %.3f videos/s, wall %.1f s, "
              "%d emissions, launches %s (window %s); recompute of requests "
              "%s (%.1f s): %s" % (
                  label, result.num_completed, result.clips_completed,
                  result.throughput_vps, wall, emissions, counts,
                  result.window_launches, picks, time.time() - t1,
                  json.dumps(report)))
    os.environ.pop("RNB_TPU_DATA_ROOT", None)
    t1 = time.time()
    held = check_mjpeg_dct_rows(roots["mjpeg-dct"])
    print("mjpeg dct rows: %d frames of %d videos bitwise jpeg_dct's and "
          "the encoder's (%.1f s)" % (held, MJPEG_DCT_SAMPLES,
                                      time.time() - t1))
    (base_count, base_mib, alone), shared, probe_s = check_busy_probe()
    print("busy-card probe (%.2f s a reading): before the child %d other "
          "process(es) (%s MiB), warnings %s; with a child holding %d MiB: "
          "%s" % (probe_s, base_count, base_mib, alone, BUSY_CHILD_MIB,
                  shared))
    print("phase mjpeg: %.1f s" % (time.time() - t_phase))


def graph_pool_mib(runner):
    """MiB the caching allocator holds in ``runner``'s graph pool: the
    peak of its captures, since a pool keeps its segments while its
    graphs live; None where the snapshot names no pool."""
    import torch
    pool = tuple(runner._graph_pool)
    held = [seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pool]
    return sum(held) / (1 << 20) if held else None


def check_shard_budget(data_root, shard_runs):
    """The d1 copy under a budget between the port's two projections
    (read off the pair's Shard steps: lines): building its stage as the
    executor does raises the reference's rejection, naming degree 2."""
    import re
    from rnb_tpu_torch.config import load_config
    from rnb_tpu_torch.utils.class_utils import load_class
    d1_mb = shard_runs[SHARD_D1_COPY][0].shard_step_detail["1"][
        "projected_mb"]
    d2_mb = shard_runs[SHARD_D2_COPY][0].shard_step_detail["1"][
        "projected_mb"]
    check(d2_mb < d1_mb < 120.0, "projections d1 %.3f, d2 %.3f MiB: the "
          "shipped 120 MiB budget no longer launches both" % (d1_mb, d2_mb))
    budget = round((d1_mb + d2_mb) / 2, 1)
    path = one_card_copy(data_root, SHARD_D1, SHARD_BUDGET_COPY)
    with open(path) as f:
        raw = json.load(f)
    raw["pipeline"][1]["shard"]["hbm_budget_mb"] = budget
    with open(path, "w") as f:
        json.dump(raw, f)
    config = load_config(path)
    step = config.steps[1]
    kwargs = dict(step.kwargs_for_group(0), ragged=True,
                  ragged_pool_rows=config.ragged["pool_rows"])
    try:
        load_class(step.model)(step.groups[0].devices[0], **kwargs)
    except ValueError as e:
        message = str(e)
    else:
        raise SmokeFailure("%s launched over its %.1f MiB budget"
                           % (SHARD_BUDGET_COPY, budget))
    pattern = (r"shard launch rejected: projected per-device HBM [\d.]+ MiB "
               r"at shard degree 1 exceeds hbm_budget_mb=%s for layers "
               r"\[1\.\.5\] \(replicated [\d.]+ MiB \+ sharded [\d.]+ MiB "
               r"/ degree \+ pool [\d.]+ MiB\); smallest feasible degree "
               r"of \(1, 2, 4, 8\): 2" % re.escape("%.1f" % budget))
    check(re.fullmatch(pattern, message), "%s: %s" % (SHARD_BUDGET_COPY,
                                                      message))
    print("path %s: rejected at %.1f MiB (d1 projects %.3f, d2 %.3f): %s"
          % (SHARD_BUDGET_COPY, budget, d1_mb, d2_mb, message))


def phase_path(data_root, videos_per_run):
    """Serve every run on cuda:0: the yuv420 configs over the y4m
    dataset (bulk, then the Zipf cells under Poisson arrivals), the dct
    one over synth:// ids (a y4m file holds no DCT coefficients).
    Returns the launches summed over the runs."""
    import numpy as np
    from rnb_tpu_torch.benchmark import run_benchmark
    from rnb_tpu_torch.config import load_config
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.parse_utils import summarize
    launches = {k.name: 0 for k in _kernels.KERNELS}
    runs = [(c, os.path.join(HERE, c)) for c in CONFIGS]
    runs.insert(4, (FEATURES_OFF, features_off_copy(data_root)))
    runs.insert(runs.index((WHOLE, os.path.join(HERE, WHOLE))) + 1,
                (WHOLE_RAGGED, whole_ragged_copy(data_root)))
    after_whole = runs.index((WHOLE, os.path.join(HERE, WHOLE))) + 1
    runs[after_whole:after_whole] = [
        (SEGMENT_COPY, one_card_copy(data_root, SEGMENT, SEGMENT_COPY)),
        (TRACED, os.path.join(HERE, TRACED))]
    from rnb_tpu_torch.tools import chaos
    from rnb_tpu_torch.video_path_provider import scan_video_tree
    chaos_path = chaos.write_chaos_copy(os.path.join(data_root,
                                                     CHAOS + ".json"))
    burst_path = chaos.write_chaos_copy(
        os.path.join(data_root, CHAOS_BURST + ".json"), burst=True)
    check(FEW_VIDEOS[CHAOS_BURST] >= chaos.BURST_MIN_TARGET,
          "the burst's target %d is under %d: its client could shed it "
          "whole while step 1 stalls" % (FEW_VIDEOS[CHAOS_BURST],
                                        chaos.BURST_MIN_TARGET))
    # the chaos runs' dataset: the same videos and one whose decode
    # fails after its header probed; request i draws video i mod N
    chaos_root = os.path.join(data_root, "chaos-dataset")
    broken = chaos.write_chaos_dataset(data_root, chaos_root)
    chaos_videos = scan_video_tree(chaos_root)
    served_takes = 0
    runs += [(METRICS, os.path.join(HERE, METRICS)),
             (AUTOTUNE, os.path.join(HERE, AUTOTUNE)),
             (AUTOTUNE_POISSON, os.path.join(HERE, AUTOTUNE)),
             (CRITPATH, critpath_copy(data_root)),
             (CHAOS, chaos_path), (CHAOS_BURST, burst_path),
             (TINY_SHED_COPY, one_card_copy(data_root, TINY_SHED,
                                            TINY_SHED_COPY)),
             (SHARD_D1_COPY, one_card_copy(data_root, SHARD_D1,
                                           SHARD_D1_COPY)),
             (SHARD_D2_COPY, one_card_copy(data_root, SHARD_D2,
                                           SHARD_D2_COPY)),
             # last: the runs before them keep their timing
             (DEVOBS, os.path.join(HERE, DEVOBS)),
             (DEVOBS_WATERMARK, devobs_watermark_copy(data_root)),
             (OPERATOR, os.path.join(HERE, OPERATOR)),
             (OPERATOR_ACTIONS, operator_actions_copy(data_root)),
             # the network edge, two processes on the card
             (NETEDGE_OFF, os.path.join(HERE, NETEDGE_OFF)),
             (NETEDGE_LOOPBACK, os.path.join(HERE, NETEDGE_LOOPBACK)),
             (NETEDGE_CHAOS, one_card_copy(data_root, NETEDGE_CHAOS_CONFIG,
                                           NETEDGE_CHAOS))]
    whole_sink = None
    shard_runs = {}
    for label, config_path in runs:
        config = load_config(config_path, "cpu")
        pixel_path = config.steps[0].kwargs.get("pixel_path", "rgb")
        classes = config.steps[-1].kwargs.get("num_classes", 400)
        if pixel_path == "dct" or label in NETEDGE_RUNS:
            # a y4m file holds no coefficients; the chaos copy's rgb
            # loader serves synth:// ids too
            os.environ.pop("RNB_TPU_DATA_ROOT", None)
        else:
            os.environ["RNB_TPU_DATA_ROOT"] = (
                chaos_root if label in CHAOS_RUNS else data_root)
        zipf = label in (PAGED, FEATURES_OFF, BLOB)
        interval = ZIPF_INTERVAL_MS if zipf else PLANE_INTERVAL_MS.get(
            label, 0)
        videos = FEW_VIDEOS.get(label, videos_per_run)
        sink, stages = {}, []
        # one forced flight dump, for the metrics run only; one forced
        # capture, for devobs run A only
        if label == METRICS:
            os.environ["RNB_FLIGHT_FORCE"] = "1"
        if label == DEVOBS:
            os.environ["RNB_DEVOBS_FORCE"] = "1"
        recorder = takes = scraper = None
        if label in CHAOS_RUNS:
            recorder = RetryRecorder(chaos.TRANSIENT_IDS)
            takes = TakeRecorder()
        if label in OPERATOR_RUNS:
            scraper = OperatorScraper(os.path.join(data_root, "logs"), label)
            scraper.start()
        # the DATA rows of the sampled requests (of every request the
        # open-loop chaos client may make: which ones crossed the wire)
        wire_rows = None
        if label in NETEDGE_RUNS:
            wire_rows = dict.fromkeys(
                range(4 * videos) if label == NETEDGE_CHAOS
                else range(0, videos, WIRE_SAMPLE_EVERY))
        _kernels.reset_launches()
        t0 = time.time()
        try:
            result = run_benchmark(
                config_path, mean_interval_ms=interval,
                num_videos=videos,
                queue_size=(BURST_QUEUE if label == CHAOS_BURST
                            else NETCHAOS_QUEUE if label == NETEDGE_CHAOS
                            else 50000),
                print_progress=False,
                log_base=os.path.join(data_root, "logs"),
                seed=NETCHAOS_SEED if label == NETEDGE_CHAOS else 0,
                outputs_sink=sink, stages_sink=stages,
                net_rows_sink=wire_rows)
        finally:
            os.environ.pop("RNB_FLIGHT_FORCE", None)
            os.environ.pop("RNB_DEVOBS_FORCE", None)
            if recorder is not None:
                recorder.close()
                takes.close()
        counts = _kernels.launch_counts()
        wall = time.time() - t0
        check(result.termination_flag == 0, "%s terminated with flag %d"
              % (label, result.termination_flag))
        # every request the pipeline disposed of: served, dead-lettered
        # or shed (only the chaos runs fail or shed any)
        disposed = result.num_completed + result.num_failed + result.num_shed
        check(label in CHAOS_RUNS or result.num_failed + result.num_shed
              + result.num_retries == 0, "%s: Faults: num_failed=%d "
              "num_shed=%d num_retries=%d" % (
                  label, result.num_failed, result.num_shed,
                  result.num_retries))
        check(len(sink) == result.num_completed, "%s: %d outputs for %d "
              "completions" % (label, len(sink), result.num_completed))
        if interval > 0:
            # an open-loop client: the run stops once the target is met,
            # and a fused emission may complete a few more requests
            check(disposed >= videos, "%s disposed of %d of %d requests"
                  % (label, disposed, videos))
        else:
            check(disposed == videos, "%s: completed %d + failed %d + "
                  "shed %d for %d requests" % (
                      label, result.num_completed, result.num_failed,
                      result.num_shed, videos))
            check(set(sink) <= set(range(videos)) and (
                label in CHAOS_RUNS or len(sink) == videos),
                  "%s: outputs of requests %s missing" % (
                      label, sorted(set(range(videos)) - set(sink))))
        if label in CHAOS_RUNS:
            broken_ids = [rid for rid in range(result.num_requests)
                          if chaos_videos[rid % len(chaos_videos)] == broken]
            served_takes += check_chaos_run(label, result, sink, recorder,
                                            takes, broken_ids, stages)
        if label == TINY_SHED_COPY:
            problems = summarize(result.log_dir)["footing_problems"]
            check(not problems, "%s: %s" % (label, "; ".join(problems[:5])))
        shard_report = None
        if label in SHARD_RUNS:
            shard_report = check_shard_run(label, result, sink, stages,
                                           counts, shard_runs)
            shard_runs[label] = (result, sink)
        t0 = time.time()
        check_graphs(label, result, stages)
        if label == SEGMENT_COPY:
            sums = segment_sums(stages, sink)
        del stages
        print("path %s: graphs checked in %.1f s" % (label, time.time() - t0))
        if pixel_path != "dct" and label not in NETEDGE_RUNS:
            with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
                backends = [line.split(": ", 1)[1] for line in
                            f.read().splitlines()
                            if line.startswith("Decode backend: ")]
            check(backends and all(b == "native" for b in backends),
                  "%s: y4m requests decoded by %s, not the native pool"
                  % (label, backends))
        for rid, (video, logits, _stamps) in sink.items():
            if label in (NOPIPELINE, SEGMENT_COPY):
                check(isinstance(logits, int) and 0 <= logits < 400,
                      "%s request %d: class id %r" % (label, rid, logits))
                continue
            check(logits.ndim == 2 and logits.shape[1] == classes
                  and logits.shape[0] >= 1,
                  "%s request %d: logits of shape %s"
                  % (label, rid, logits.shape))
            check(np.isfinite(logits).all(),
                  "%s request %d: non-finite logits" % (label, rid))
        for name, count in counts.items():
            if name in PATH_KERNELS[label]:
                check(result.window_launches[name] > 0,
                      "%s: kernel %s was not launched in the measured "
                      "window" % (label, name))
            else:
                check(count == 0, "%s: kernel %s, not of this config, "
                      "was launched" % (label, name))
            launches[name] += count
        if label in ONE_PER_EMISSION:
            name = ONE_PER_EMISSION[label]
            emissions = summarize(result.log_dir)["emissions"]
            check(result.window_launches[name] == emissions,
                  "%s: %d %s launches for %d emissions"
                  % (label, result.window_launches[name], name, emissions))
        if label == WHOLE:
            whole_sink = sink
        if label in (CONFIGS[0], PAGED):
            UNARMED_SINKS[label] = sink
            UNARMED_VPS[label] = round(result.throughput_vps, 3)
        if label in UNFUSED:
            check_unfused_run(label, result, sink, whole_sink)
        if label == TRACED:
            check_traced_run(result)
        if label == METRICS:
            check_metrics_run(result)
        if label in DEVOBS_RUNS:
            check_devobs_run(label, result, config_path)
        if label in (AUTOTUNE, AUTOTUNE_POISSON):
            check_autotune_run(label, result)
        if label in OPERATOR_RUNS:
            check_operator_run(label, result, scraper)
        if label == CRITPATH:
            check_critpath_run(result)
            EXPLAIN_JOBS[CRITPATH] = result.log_dir
        netedge_report = None
        if label in (NETEDGE_OFF, NETEDGE_LOOPBACK):
            netedge_report = check_netedge_run(label, result, sink,
                                               wire_rows, config_path)
        if label == NETEDGE_CHAOS:
            remote, local = check_netchaos_run(label, result, sink,
                                               wire_rows)
        if label == SEGMENT_COPY:
            check_segment_run(result, sink, whole_sink, sums)
            picks = sorted(sink, key=lambda r: (len(whole_sink[r][1]), r))
            picks = picks[:1] + picks[-1:]
            t0 = time.time()
            report = cpu_recompute(config_path, sink, picks, sums)
            print("path %s: %d requests, %d clips, %.3f videos/s, wall "
                  "%.1f s, launches %s (window %s), pad_rows %d of %d; "
                  "recompute of requests %s (%.1f s): %s"
                  % (label, result.num_completed, result.clips_completed,
                     result.throughput_vps, wall, counts,
                     result.window_launches, result.pad_rows,
                     result.total_rows, picks, time.time() - t0,
                     json.dumps(report)))
            continue
        if label == NOPIPELINE:
            print("path %s: %d requests, %d clips, %.3f videos/s, wall "
                  "%.1f s, launches %s (window %s), pad_rows %d of %d"
                  % (label, result.num_completed, result.clips_completed,
                     result.throughput_vps, wall, counts,
                     result.window_launches, result.pad_rows,
                     result.total_rows))
            continue
        by_clips = sorted(sink, key=lambda r: (sink[r][1].shape[0], r))
        picks = by_clips[:2] + by_clips[-1:]
        if label in UNFUSED or label in FEW_VIDEOS:
            picks = by_clips[:1] + by_clips[-1:]
        if label in PLANES + DEVOBS_RUNS + SHARD_RUNS + OPERATOR_RUNS \
                + (NETEDGE_OFF,):
            picks = by_clips[:1]
        if label == NETEDGE_LOOPBACK:
            picks = by_clips[:1] + by_clips[-1:]
        if label == NETEDGE_CHAOS:
            # one request the peer served and one the fallback served
            picks = remote[:1] + local[:1]
        if label in CHAOS_RUNS:
            # the retried requests too: their served logits held to the
            # recompute from their video, not only to a replay
            picks = sorted(set(by_clips[:1] + recorder.retried))
        if label in TWO_STEP_HELD:
            # every request's logits are held to the two-step run's,
            # whose largest request the CPU recomputes
            picks = by_clips[:1]
        if zipf:
            page_hit = check_cache_run(label, result, sink)
            if label == FEATURES_OFF:
                check(page_hit is not None, "%s: no clip-page hit to "
                      "recompute" % label)
                picks = [page_hit] + by_clips[1:2] + by_clips[-1:]
        t0 = time.time()
        report = cpu_recompute(config_path, sink, picks)
        print("path %s: %d requests, %d clips, %.3f videos/s, p50 %s ms, "
              "p99 %s ms, wall %.1f s, launches %s (window %s), "
              "pad_rows %d of %d; recompute of requests %s (%.1f s): %s"
              % (label, result.num_completed, result.clips_completed,
                 result.throughput_vps, result.p50_latency_ms,
                 result.p99_latency_ms, wall, counts,
                 result.window_launches, result.pad_rows,
                 result.total_rows, picks, time.time() - t0,
                 json.dumps(report)))
        if label in NETEDGE_RUNS:
            print("path %s net: Net: %s; Health: %s; lane %s; %s" % (
                label, json.dumps({k[4:]: v for k, v in sorted(
                    vars(result).items()) if k.startswith("net_")}),
                json.dumps({k[7:]: v for k, v in sorted(
                    vars(result).items()) if k.startswith("health_")
                    and k != "health_lane_detail"}),
                json.dumps(result.health_lane_detail, sort_keys=True),
                json.dumps(netedge_report) if netedge_report is not None
                else ""))
        if shard_report is not None:
            print("path %s shard: %s; Shard: %s" % (
                label, json.dumps(shard_report), json.dumps(
                    result.shard_step_detail, sort_keys=True)))
        if label == SHARD_D2_COPY:
            check_shard_budget(data_root, shard_runs)
    check(served_takes >= 1, "no chaos run failed a decode inside a fused "
          "take and served the take's other requests")
    return launches


def check_config_instances(label, config_path, stages):
    """Every network instance (runner or single step) the config's steps
    declare was built on cuda:0 and captured its graphs there. Returns
    each instance's (step, graphs, capture seconds, replays, graph pool
    MiB)."""
    import torch
    from rnb_tpu_torch.config import load_config
    from rnb_tpu_torch.models.r2p1d.model import R2P1DRunner
    config = load_config(config_path, "cpu")
    declared = {i: sum(len(g.devices) for g in step.groups)
                for i, step in enumerate(config.steps)
                if step.model.endswith((".R2P1DRunner", ".R2P1DSingleStep"))}
    built = {i: 0 for i in declared}
    instances = []
    card = torch.device("cuda", 0)
    for step_idx, stage in stages:
        runner = getattr(stage, "net", stage)
        if not isinstance(runner, R2P1DRunner):
            continue
        built[step_idx] = built.get(step_idx, 0) + 1
        stats = runner.graph_stats
        check(runner.torch_device == card, "%s: a step-%d instance was "
              "built on %s, not %s" % (label, step_idx, runner.torch_device,
                                       card))
        check(stats is not None and stats["graphs"] >= 1
              and stats["capture_s"] > 0, "%s: a step-%d instance "
              "captured no graph (%s)" % (label, step_idx, stats))
        check(all(p.device == card for p in runner.network.parameters()),
              "%s: a step-%d instance's weights are not all on %s"
              % (label, step_idx, card))
        pool = graph_pool_mib(runner)
        instances.append((step_idx, stats["graphs"],
                          round(stats["capture_s"], 3), stats["replays"],
                          None if pool is None else round(pool, 1)))
    check(built == declared, "%s: network instances built per step %s, "
          "the config declares %s" % (label, built, declared))
    return instances


def requests_per_table(log_dir):
    """The requests each instance of the last step served: the rows of
    its timing table, by file."""
    from rnb_tpu_torch.parse_utils import read_table
    return {name: len(read_table(os.path.join(log_dir, name))[1])
            for name in sorted(os.listdir(log_dir))
            if "-group" in name and name.endswith(".txt")}


def phase_configs(data_root, launches):
    """Serve the shipped configs of ``CONFIG_RUNS`` on cuda:0 at full
    width (``r2p1d-tiny`` at its own reduced geometry), each in bulk over
    the y4m dataset: every request served with finite logits of the
    config's classes (a class id for the single steps), the config's own
    ingest kernel launched in the window and no other kernel (once an
    emission where a loader or fused loader feeds the runner), every
    network instance the config declares built on cuda:0 with its graphs
    captured there, each graph replaying bitwise its eager forward, every
    decode on the native pool and two requests recomputed on the CPU.
    Prints each run's videos/s, its peak device memory (allocated, and
    reserved: the graph pools keep what their captures freed) and the
    requests of each instance of its last step beside the card's name
    and power limit. The job directories go through ``phase_check_jobs``."""
    import numpy as np
    import torch
    from rnb_tpu_torch.benchmark import run_benchmark
    from rnb_tpu_torch.config import load_config
    from rnb_tpu_torch.ops import _kernels
    from rnb_tpu_torch.parse_utils import summarize
    smi = nvidia_smi_line()
    os.environ["RNB_TPU_DATA_ROOT"] = data_root
    for label, config in CONFIG_RUNS:
        config_path = (os.path.join(HERE, config) if label == config
                       else one_card_copy(data_root, config, label))
        loaded = load_config(config_path, "cpu")
        pixel_path = loaded.steps[0].kwargs.get("pixel_path", "rgb")
        classes = next(
            s.kwargs for s in reversed(loaded.steps)
            if s.model.endswith((".R2P1DRunner", ".R2P1DSingleStep"))
        ).get("num_classes", 400)
        kernel = INGEST_KERNELS[pixel_path]
        videos = CONFIG_VIDEOS
        sink, stages = {}, []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(0)
        _kernels.reset_launches()
        t0 = time.time()
        result = run_benchmark(
            config_path, mean_interval_ms=0, num_videos=videos,
            queue_size=50000, print_progress=False,
            log_base=os.path.join(data_root, "logs"), seed=0,
            outputs_sink=sink, stages_sink=stages)
        counts = _kernels.launch_counts()
        wall = time.time() - t0
        peak_mib = torch.cuda.max_memory_allocated(0) / (1 << 20)
        reserved_mib = torch.cuda.max_memory_reserved(0) / (1 << 20)
        check(result.termination_flag == 0, "%s terminated with flag %d"
              % (label, result.termination_flag))
        check(result.num_failed + result.num_shed + result.num_retries
              == 0, "%s: Faults: num_failed=%d num_shed=%d num_retries=%d"
              % (label, result.num_failed, result.num_shed,
                 result.num_retries))
        check(result.num_completed == videos and sorted(sink) == list(
            range(videos)), "%s: completed %d of %d, outputs of %s"
              % (label, result.num_completed, videos, sorted(sink)))
        single = all(isinstance(out, int) for _, out, _ in sink.values())
        for rid, (_video, out, _stamps) in sink.items():
            if single:
                check(0 <= out < classes, "%s request %d: class id %r"
                      % (label, rid, out))
                continue
            check(out.ndim == 2 and out.shape[1] == classes
                  and out.shape[0] >= 1 and np.isfinite(out).all(),
                  "%s request %d: logits of shape %s, finite %s"
                  % (label, rid, out.shape, np.isfinite(out).all()))
        for name, count in counts.items():
            if name == kernel:
                check(result.window_launches[name] > 0, "%s: kernel %s "
                      "was not launched in the measured window"
                      % (label, name))
            else:
                check(count == 0, "%s: kernel %s, not of this config, was "
                      "launched" % (label, name))
            launches[name] += count
        emissions = summarize(result.log_dir)["emissions"]
        if label in CONFIG_ONE_PER_EMISSION:
            check(result.window_launches[kernel] == emissions,
                  "%s: %d %s launches for %d emissions"
                  % (label, result.window_launches[kernel], kernel,
                     emissions))
        with open(os.path.join(result.log_dir, "log-meta.txt")) as f:
            backends = [line.split(": ", 1)[1] for line in
                        f.read().splitlines()
                        if line.startswith("Decode backend: ")]
        check(backends and all(b == "native" for b in backends),
              "%s: requests decoded by %s, not the native pool"
              % (label, backends))
        instances = check_config_instances(label, config_path, stages)
        tables = requests_per_table(result.log_dir)
        check(sum(tables.values()) == videos, "%s: the last step's tables "
              "hold %d requests of %d" % (label, sum(tables.values()),
                                           videos))
        t1 = time.time()
        check_graphs(label, result, stages)
        graphs_s = time.time() - t1
        del stages
        by_clips = sorted(sink, key=lambda r: (
            sink[r][1].shape[0] if not single else 0, r))
        picks = by_clips[:1] + by_clips[-1:]
        t1 = time.time()
        report = cpu_recompute(config_path, sink, picks)
        print("configs %s: %d requests, %d clips, %.3f videos/s, wall "
              "%.1f s, peak device memory %.1f MiB allocated, %.1f MiB "
              "reserved, launches %s (window %s), %d emissions, pad_rows "
              "%d of %d; graphs checked in %.1f s; recompute of requests "
              "%s (%.1f s): %s; %s"
              % (label, result.num_completed, result.clips_completed,
                 result.throughput_vps, wall, peak_mib, reserved_mib,
                 counts, result.window_launches, emissions,
                 result.pad_rows, result.total_rows, graphs_s, picks,
                 time.time() - t1, json.dumps(report), smi))
        print("configs %s instances: %d network instances on cuda:0 "
              "[step, graphs, capture s, replays, graph pool MiB] %s; "
              "requests by last-step table %s" % (
                  label, len(instances), json.dumps(instances),
                  json.dumps(tables)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "rnb_tpu_torch")) or not all(
            os.path.exists(os.path.join(HERE, c))
            for c in SERVED_CONFIGS + ("bench_cuda.py",)):
        print("chip_smoke: run from a checkout of the repo (rnb_tpu_torch/ "
              "and configs/ beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    t_start = time.time()
    seconds_of = {}
    # the fixed dataset root is relative to the checkout
    os.chdir(HERE)
    data_root = SMOKE_ROOT
    shutil.rmtree(data_root, ignore_errors=True)
    os.makedirs(data_root)
    sass = None
    try:
        print("torch %s, CUDA %s, python %s" % (
            torch.__version__, torch.version.cuda, sys.version.split()[0]))
        smi = nvidia_smi_line()
        print("card: %s" % smi)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

        from rnb_tpu_torch.ops import _kernels
        # the SASS counts of the dct kernels, by section, built beside the
        # kernels and read at the end
        sass = subprocess.Popen(
            [sys.executable, "-m", "rnb_tpu_torch.tools.sass_counts",
             "--kernel", "dct_ingest_kernel", "--kernel",
             "dct_convert_kernel", "--out-dir",
             os.path.join(data_root, "sass")],
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        # the native decoder builds with g++ while nvcc builds the kernels
        from rnb_tpu_torch.ops import _native
        native_build = {}

        def build_native():
            try:
                native_build["seconds"] = _native.build()
            except Exception as e:  # re-raised on this thread below
                native_build["error"] = e

        native_thread = threading.Thread(target=build_native,
                                         name="native-build")
        native_thread.start()
        try:
            seconds = _kernels.build()
        finally:
            native_thread.join()
        for source, (secs, log) in _kernels.BUILD_LOG.items():
            print("build %s: %.1f s\n%s" % (source, secs, log.strip()))
        print("build: %s" % json.dumps(seconds))
        print("nvcc: %s" % subprocess.run(
            [_kernels.nvcc(), "--version"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[-1])
        if "ring.cu" in _kernels.BUILD_LOG:
            for kernel in ("ring_shift_kernel", "ring_hop_kernel"):
                frame = stack_frame_bytes(_kernels.BUILD_LOG["ring.cu"][1],
                                          kernel)
                print("%s stack frame: %s bytes" % (kernel, frame))
                check(frame == 0, "ptxas gives %s a stack frame of %s "
                      "bytes: its table is copied off the parameters"
                      % (kernel, frame))
        if "error" in native_build:
            raise native_build["error"]
        print("build native/decode.cpp -> %s: %s\n%s" % (
            os.path.relpath(_native.library_path(), HERE),
            "already built" if native_build["seconds"] is None
            else "%.1f s" % native_build["seconds"],
            (_native.BUILD_LOG or (0.0, ""))[1].strip()))

        device = torch.device("cuda", 0)
        timings, worst = phase_kernels(device)
        for phase in (phase_kernels_dct, phase_kernels_gather,
                      phase_kernels_ragged, phase_kernels_ring):
            more_timings, more_worst = phase(device)
            timings.update(more_timings)
            worst.update(more_worst)

        from rnb_tpu_torch.dataset import clip_mix, make_dataset
        make_dataset(data_root)
        mix = clip_mix(data_root)
        print("dataset %s: %d videos, %.4f clips a request over them"
              % (data_root, len(mix), sum(mix.values()) / len(mix)))
        t_lint = time.time()
        phase_lint()
        seconds_of["lint"] = time.time() - t_lint
        launches = phase_path(data_root, VIDEOS_PER_RUN)
        t_configs = time.time()
        phase_configs(data_root, launches)
        seconds_of["configs"] = time.time() - t_configs
        phase_lanes(data_root, launches)
        t_explain = time.time()
        phase_explain(data_root, launches)
        seconds_of["explain"] = time.time() - t_explain
        t_witness = time.time()
        phase_witness(data_root, launches)
        seconds_of["witness"] = time.time() - t_witness
        phase_mesh(data_root, launches)
        phase_ckpt(data_root, launches)
        phase_bench_cuda(data_root)
        t_tools = time.time()
        phase_tools(data_root, launches)
        seconds_of["tools"] = time.time() - t_tools
        phase_mjpeg(data_root, launches)
        t_parallel = time.time()
        phase_parallel(data_root, launches)
        seconds_of["parallel"] = time.time() - t_parallel
        t_processes = time.time()
        timings["ring_shift"].update(phase_processes(data_root, launches))
        seconds_of["processes"] = time.time() - t_processes
        t_checks = time.time()
        phase_check_jobs(data_root)
        seconds_of["check_jobs"] = time.time() - t_checks

        sass_out, _ = sass.communicate()
        check(sass.returncode == 0, "sass_counts failed:\n%s" % sass_out)
        for line in sass_out.splitlines():
            report = json.loads(line)
            print("sass %s: %d instructions; by section %s" % (
                report["kernel"], report["total"], json.dumps(
                    {name: section["instructions"] for name, section
                     in sorted(report["sections"].items())})))

        rows = []
        for kernel in _kernels.KERNELS:
            t = timings[kernel.name]
            rows.append({
                "name": kernel.name, "route": "cuda",
                "source": "rnb_tpu_torch/csrc/%s" % kernel.source,
                "replaces": " + ".join(kernel.replaced),
                "launches": launches[kernel.name],
                "max_abs_err": worst[kernel.name],
                "ms": t["ms"], "ms_l2_flushed": t["ms_l2_flushed"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t.get("library_ms"),
                **{key: t[key] for key in EXTRA_ROW_KEYS if key in t}})
        print("seconds: %s" % json.dumps(
            {k: round(v, 1) for k, v in seconds_of.items()}))
        print("total %.1f s" % (time.time() - t_start))
        print(json.dumps({"kernels": rows}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except SmokeFailure as e:
        print("chip_smoke FAILED: %s" % e, file=sys.stderr)
        return 1
    finally:
        if sass is not None and sass.poll() is None:
            sass.kill()
            sass.wait()
        shutil.rmtree(data_root, ignore_errors=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--process-child"]:
        sys.exit(process_child(*sys.argv[2:4]))
    sys.exit(main())

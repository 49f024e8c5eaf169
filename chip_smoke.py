#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths on the card, from local paths and from a
loopback remote store — the fused batch run,
``PipelineBuilder('info_file=…&fe=dwt-8-fused&train_clf=logreg').execute()``
at f32 and at ``precision=bf16|int8|int4``, the host ``fe=`` batch run
(``fe=dwt-8-pallas``, ``dwt-8``, ``dwt-8-tpu``, ``dwt-8-tpu-bf16``,
``dwt-8-tpu-compact-bf16``), the online service,
``…&serve=true&load_clf=logreg&load_name=…`` at f32 and at each rung, the
multi-tenant service (``serve.MultiplexedService``, 128 tenants) on the
f32 stack and on the quantized stacks (``weights_precision=int8|int4``),
the fused kernels' generic engine (a 256-sample window through
``OfflineDataProvider.load_features_device`` and the serving engines),
and the serving of an IEEE_FLOAT_32 session (float32 requests through
the megakernel's float32-sample instantiations, one and 128 tenants,
``adapt=true``, and the host-extractor mode), mini-batch SGD
(``config_mini_batch_fraction=0.5``), the neural-network classifier
(``train_clf=nn``, ``load_clf=nn`` and ``serve=true&load_clf=nn``) and the
tree families (``train_clf=dt|rf|gbt`` and their ``-tpu`` growers, saved,
loaded and served), and the seizure workload (``task=seizure``: sliding
windows, subband features, cost-sensitive training, ``fe_sweep=`` and
serving) — and
holds every CUDA kernel of them against its plain PyTorch version.
Phases, one JSON line each (several for phases 2 to 6):

1. device: the card's name and ``nvidia-smi`` power limit;
2. build: compile every kernel from ``eeg_dataanalysispackage_tpu_torch/csrc``
   (three sources, every precision instantiation in them), one ``nvcc``
   per source, all started together, with ``ptxas`` registers and spills
   (the generic engine's instantiations by design in ``generic_build``,
   beside both designs' tile plans at the generic sizes and the one each
   launch takes);
3. each kernel against its plain version (max abs deviation <= 2e-6):
   the fused ingest kernel on int16 streams (random, DC-heavy,
   overhanging, single-window, dense, odd-count and main-path-shaped
   inputs, starts at every sample offset within a 16-byte chunk, and
   negative starts, starts straddling the recording's end into its
   zero padding and the stream's end, at it and past it, on rows that
   are not 16-byte aligned) and on float32 streams (random, DC-heavy,
   overhanging, every offset within a chunk, unaligned edges); on
   every int16 case also its bf16 instantiation (K2-bf16: within 2e-6 of
   its plain version, within BF16_GATE_TOL of the f32 rows) and its
   int8/int4 instantiations (the quantize epilogue equal bit for bit to
   the plain quantizer on the f32 kernel's rows; against the plain chain
   within 2e-6 except counted boundary flips of one step); the serve
   megakernel (random and DC-heavy windows, n = 1 and n = capacity,
   capacity 64, 128 and 2,048; margins within 2e-6 * ||w||_1; padded
   rows exactly 0; a window's margin equal solo and in a batch), and on
   every case its int8/int4 instantiations (within 2e-6 * ||w||_1 of the
   quantized ingest rows dotted with w, within the rung's tolerance of
   the plain version with the row flips counted, padded rows 0, solo
   equal to batch); the tenant-stacked megakernel K6 (random and
   DC-heavy windows, n = 1 and n = capacity at capacity 64, 128 and
   2,048, lanes cycling over all 128 lanes and all on one tenant; margins
   within 2e-6 * ||w_lane||_1 of the plain version and bit-equal to the
   megakernel launched with that lane's weights; padded rows and a freed
   lane exactly 0); the epoch-features kernel (B = 1, 5, 37, 128, 641,
   1,494 and 32,768, DC-heavy epochs, an all-zero epoch giving an exactly
   zero row, windows at every 4-byte offset within a chunk on aligned and
   misaligned tensors, bit-equal, sizes off the main path, up to 750
   samples and 745 coefficients, at 1, 3, 5 and 64 channels, 5-channel
   input reduced to 3, a window that does not fit and a coefficient count
   past the cascade's columns raising); K6-w8 and K6-w4, the quantized
   tenant stack's instantiations (DC-heavy windows, n = 1 and n =
   capacity at capacity 64 and 2,048, lanes cycling or on one tenant:
   margins bit-equal to K6 on the dequantized 128-lane stack, within
   2e-6 * ||w_lane||_1 of the plain version, padded rows and a freed lane
   0); and the generic engine at (epoch_size, feature_size, skip) =
   (256, 16, 175), (512, 64, 175), (333, 20, 100) and (700, 32, 50) on 3
   channels and (333, 20, 100) on 76: K1 at every rung (rows within
   2e-6; int8/int4 bit for bit to the plain quantizer on the kernel's f32
   rows, flips against the plain chain counted), K5 at f32/int8/int4, K6
   and K6-w8/w4 (margins within MEGA_GATE_TOL, K6 bit-equal per lane to
   K5, K6-w8/w4 bit-equal to K6 on the dequantized stack); and the
   megakernel's float32-sample instantiations (K5-f32s, K5-int8-f32s,
   K5-int4-f32s, K6-f32s, K6-w8-f32s, K6-w4-f32s and their generic
   twins) on float32 streams of the same windows scaled by their
   resolutions (at the int16 limit's DC offsets too): K5 at capacity 64,
   2,048, 4,099 (4,000 and 4,099 windows: not a multiple of the tile
   design's 4-window tiles) and 32,768 windows as
   the int16 cases are held, K6 at 64, 2,048 and 4,099 and the packed
   stacks at 64 and 2,048, every 512 / 16 float32 case of K5 (each rung)
   and K6 with each megakernel design forced, their margins bit-equal
   (``designs_bit_equal``; a ``mega_designs_phase3`` line counts the
   phase's launches of each design), the generic ones at every generic
   size and on 76 channels, and K5/K6 on 64 and 76 float channels at 512
   / 16 (77 refused, no launch counted);
4. the batch paths end to end on an 8-recording x 1,200-marker session:
   ``fe=dwt-8-fused`` with logreg (its model saved), svm and the
   ``-fused-pallas`` spelling; ``fe=dwt-8-fused&precision=bf16|int8|int4``
   with logreg (the rung used as requested, its gate record, the gate's
   f32 and rung launches plus one rung launch per recording, features
   against the CPU run's within 2e-6 except counted boundary flips), and
   an int4 run forced to trip its gate (``EEG_TPU_INT4_GATE_TOL=1e-9``
   for that run only: f32 used, statistics equal to the f32 run);
   ``fe=dwt-8-pallas`` with logreg and svm, ``fe=dwt-8`` and
   ``fe=dwt-8-tpu`` with logreg; then a 3-recording IEEE_FLOAT_32
   session through ``fe=dwt-8-fused`` and ``fe=dwt-8-pallas``; then the
   generic engine's path, ``load_features_device(epoch_size=256, …)`` on
   both sessions at every rung (one generic launch per recording, each
   launch's design and plan and the launches of each design printed, the
   features against the CPU provider's); and ``fe=dwt-8-tpu-bf16`` and
   ``-tpu-compact-bf16`` with logreg on the card and the CPU (features
   within BF16_GATE_TOL, both statistics printed). Every run
   prints the launches of each kernel, counted from 0 just before it
   (the ingest kernel once per recording, the epoch-features kernel
   twice per ``-pallas`` train run), and its statistics equal the port's
   CPU run (a test row may differ only where its margin lies within 1e-4
   of the threshold on both runs). The features each kernel made in a
   run are held at 2e-6 against the CPU run's: the fused runs' rows, and
   the ``-pallas`` logreg runs' own train and test epochs through the
   run's extractor, also against the plain version on the same float32
   tensor;
4b. serving the float32 session with models the card's fused run saved:
   ``serve=true`` with logreg and svm at f32 and with logreg at int8 and
   int4 (each run's float32-sample megakernel launches, counted from 0
   just before it; ``result_path`` equal byte for byte to the card's
   batch ``load_clf=`` run, the f32 logreg run also to the CPU's serve
   run, under phase 5's near-threshold rule); ``adapt=true&swap_gate=off``
   (statistics of the plain serve run, the feedback featurized by the
   ingest kernel's float32 instantiation); a 128-tenant
   ``MultiplexedService`` on the f32, int8 and int4 stacks (K6-f32s,
   K6-w8-f32s, K6-w4-f32s; every tenant's margins and predictions
   bit-equal to a solo engine serving its dequantized weights); engines
   of capacity 4,096 (``ServingEngine`` at f32, int8 and int4 and the
   128-tenant ``MultiplexedEngine`` on each stack) serving 4,096 of the
   session's windows in one batch through the megakernel's tile design,
   margins bit-equal to the default 64-window engines' (run_windows) on
   the same windows; and
   ``InferenceService(host_extractor=…)`` with ``dwt-8`` and
   ``dwt-8-pallas`` (the host rung, the epoch-features kernel launched
   once a batch by the latter, predictions equal to the CPU service's);
4c. threefry sampling and the neural network on the same session: the
   threefry draws (bits, uniforms, Bernoulli masks with scalar and tensor
   ``p``, the SGD mini-batch masks) on the card bit-equal to the CPU's,
   and the card's time to draw one mask of the session's rows; logreg and
   svm at ``config_mini_batch_fraction=0.5`` (statistics against the CPU
   run under phase 4's near-threshold rule); ``train_clf=nn`` with
   configuration A (the JAX package's ``test_nn_pipeline`` network) and B
   (a 64-unit denoising autoencoder with dropout, a 32-unit LSTM, adam,
   ``relu`` init, mse, 200 iterations) on ``fe=dwt-8-fused`` and A on
   ``fe=dwt-8-pallas``, each saved, the network on the card, test
   predictions within NN_TOL of the CPU run's (a row may round
   differently only within NN_TOL of 0.5 on both), the train wall and
   per-step ms printed; then ``load_clf=nn`` of the saved A model and
   ``serve=true&load_clf=nn`` (mode ``featurize+host``, the ``fused``
   rung, no megakernel launch, K1 once a batch plus the warmup's,
   statistics byte-equal to the batch load run's), and one 64-window
   batch: K1's served rows against the batch run's rows and the engine's
   featurize and predict steps (host wall, medians of 25);
4d. the tree families on the same session: ``train_clf=dt``, ``rf``,
   ``gbt``, ``dt-tpu``, ``rf-tpu`` and ``gbt-tpu`` on ``fe=dwt-8-fused``
   at the defaults, each saved (K1 once per recording, the ``-tpu``
   forests grown on the card, the train wall printed), each against the
   port's CPU run (a test row may differ only within EDGE_TOL of a split
   edge on its path, counted); the growers on the card runs' own rows:
   ``dt-tpu``'s tree equal to the host ``dt`` grower's, ``rf-tpu``'s
   forest equal to the CPU's, ``gbt-tpu``'s leaves within TREE_LEAF_TOL of
   the CPU's and its predictions equal except where ``|F| < F_NEAR``;
   ``fe=dwt-8-pallas&train_clf=rf`` (K4 twice); ``load_clf=`` of each
   saved model (the test half equal to the train run's statistics);
   ``serve=true&load_clf=rf`` and ``gbt-tpu`` (mode ``featurize+host``,
   the ``fused`` rung, no megakernel launch, K1 once a batch plus the
   warmup's, statistics byte-equal to the batch load run's);
   ``InferenceService.from_saved("gbt", …)`` predicting the session's
   windows as the batch load run's classifier does, and the CLI's
   ``load_clf=rf-tpu`` report equal to the batch run's; and a depth-13
   ``dt-tpu`` refused with no launch;
4e. the training surface beyond one model on the same session:
   ``classifiers=logreg,svm,dt,rf,nn`` on ``fe=dwt-8-fused`` (K1 once per
   recording, each leg byte-equal to its single card run, ``result_path``
   the legs' reports in request order) and ``logreg,svm,rf`` on
   ``fe=dwt-8-pallas`` (K4 once); the bench's 16-member population
   (``cv=4`` x a 2 x 2 lr/reg grid, 6,000 iterations) batched and looped,
   their ``result_path`` byte-equal and the looped train under
   LOOPED_LIMIT_S; an svm population with a live seed axis (batched equal
   to looped, the member masks equal to the CPU's); an nn population
   (``seeds=4&sweep=lr:0.1,0.05``, batched); ``elastic=true`` logreg, nn
   and rf under a ``device.step`` fault (one restart, the plain run's
   statistics, the checkpoints cleared); nn's ``lbfgs`` and
   ``line_gradient_descent`` through the builder (train wall, line-search
   steps), then each optimizer alone: LBFGS_HORIZON updates on the card
   run's own train rows, on the card and on the CPU, the same line-search
   steps at every update and predictions within NN_TOL. Every run against
   the port's CPU run under phase 4's near-threshold rules;
4f. the seizure workload (``task=seizure``) on two continuous INT_16
   recordings (SEIZURE_FILES; four until phase 4k came) of 921,600
   samples (one hour at CHB-MIT's 256 Hz) with two annotated seizures
   each, cut into 512-sample windows at a stride of 256 (7,198 windows,
   ~3% positive): ``fe=dwt-4:level=4:stats=energy,std``
   with logreg (SEIZURE_LOGREG) at ``cost_fp=1&cost_fn=8`` (saved) and
   unweighted (expected cost and recall of both printed; the costs must
   raise recall and lower the expected cost), svm at ``class_weight=balanced``,
   ``classifiers=logreg,svm,rf,nn`` (each leg byte-equal to its single
   card run, every leg's ``config_weight_pos`` the resolved 8.0), the
   ``fe_sweep=`` population (``dwt-4`` and ``dwt-8`` subbands x ``cv=2``
   x ``cost_fn:2,8``) batched and looped (``result_path`` byte-equal),
   ``elastic=true`` logreg under ``device.step:once@3`` (one restart, the
   plain run's statistics), ``fe=dwt-8-pallas`` at 768-sample windows
   (4,798 windows, K4 once, its rows within KERNEL_TOL of the plain
   version and of the CPU run's) and ``load_clf=`` of the saved model,
   each against the port's CPU run under phase 4's near-threshold rules;
   then ``task=seizure&serve=true`` on a one-recording session (3,599
   windows, host-extractor mode: statistics byte-equal to the card's batch
   ``load_clf=`` run, p50/p99, mean batch size, completed, shed, a clean
   drain), the same at ``fe=dwt-8-pallas`` (K4 once a batch and once at
   warmup; the served rows run K4's small kernel, so statistics equal the
   batch run's but for rows within MARGIN_BAND of the threshold) and with
   ``serve_threshold=`` (recall no lower). Every run prints its
   ``timers``, the phase its wall;
4g. the run record (every earlier phase runs with the feature cache off,
   ``EEG_TPU_NO_FEATURE_CACHE=1``; this one turns it on in a fresh
   directory): the main path's fused logreg twice (the miss launches K1
   once a recording, the hit launches nothing and returns the miss's
   rows on the card, byte-equal statistics) and with ``cache=false`` (K1
   again); the same pair at ``precision=int8`` (the hit's gate record
   ``source: cache``, no gate launches); the seizure ``fe=dwt-8-pallas``
   pair (K4 once, then not); ``report=`` on the int8 miss and the
   seizure miss (``run_report.json`` names the card and holds the
   backend, precision, workload and classification blocks); a
   ``faults=ingest.fused:once@1`` run (it raises; ``crash_report.json``
   records the rule fired once) and ``serve=true&faults=
   serve.request:once@4;serve.batch:once@2`` on two recordings
   (statistics byte-equal to the batch ``load_clf=`` run); a
   ``trace_path=`` run (its trace holds K1's kernel record); and the MLlib
   directories: with ``pyarrow`` (the card's host has 24.0.0) a saved
   directory loads and serves on the card, the served statistics the
   batch load run's; without it ``config_model_format=mllib`` and
   ``load_name=<dir>`` raise the JAX package's ``pyarrow`` message. The
   phase's wall is printed;
4h. the input pipeline, every run with ``cache=false``: the fused logreg
   run at ``ingest_workers=1`` and ``=4``, each serial and with
   ``overlap=true`` at ``prefetch=1``, 2 and 5 (features bit-equal on the
   card, statistics byte-equal, K1 8 a run; each run's wall and
   ``timers`` side by side in the ``input_pipeline_runs`` line); the
   overlapped run under ``trace_path=`` (``overlap_trace``: K1's records
   on a stream other than the consumer's, the host-to-device copies from
   pinned memory, whether a copy overlapped a K1 record; for the record,
   not a gate); ``faults=staging.producer:once@1`` under overlap (the run
   raises, its crash report ``fired: 1``); the host ``fe=dwt-8-pallas``
   run through the native epoch stage and with ``EEG_TPU_NATIVE=0``
   (epochs bit-equal, statistics byte-equal, K4 as often, each
   ``timers["epoch"]``); ``serve=true`` at ``ingest_workers=4`` equal to
   ``=1``; three recordings on a loopback WebHDFS namenode at
   ``ingest_workers=4`` equal to ``=1`` with no retry. Phase 2 builds the
   native host library (``csrc/eeg_host.cc``, ``g++``) beside the
   ``nvcc`` builds and prints both times (``build_native``). No earlier
   phase is pinned to ``ingest_workers=1``: the pool moves no launch;
4i. single-process meshes (``devices=``, ``mesh_axes=``): the number of
   cards is printed (``mesh_devices``); a population run with
   ``devices=1`` (and ``devices=<cards>`` where there are two or more)
   through the builder, statistics byte-equal to the unmeshed run;
   ``devices=<cards + 1>`` raising, ``processes=2`` without a coordinator
   raising ``PodBootstrapError``; then
   on a 4-shard mesh (four distinct cards where there are four, else
   ``cuda:0`` four times, printed: on one card no copy crosses cards)
   the sharded fused ingest of the 8-recording session (K1 once a shard
   and recording; the rows against the unsharded kernel's and the plain
   version's, the halo windows counted; its wall beside the unsharded
   ingest's, two of each in turns), the 4- and 16-member sharded
   populations against the unsharded engine, ``grow_forest_sharded``
   bit-equal to ``grow_forest``, data-parallel SGD against the unmeshed
   run; and the raw-stream trainers (K2's two call sites):
   ``make_raw_train_step`` (``formulation="bank"``, K1) and
   ``make_irregular_bank_train_step`` at ``bank128`` (K1) and
   ``bank128_bf16`` (K2-bf16), each 20 steps with its launches counted
   from 0, its rows against the plain version and its losses against the
   CPU run's, the ``bank128`` step also data-parallel on the 4-shard mesh;
4j. multi-process runs (``processes=``): whether torch has NCCL and gloo
   (``pod_devices``); two ranks (``parallel/pod.spawn_pod_member``, one
   process each, both on the first card, over gloo) of the population run
   ``cv=2&sweep=lr:1.0,0.5`` and of the default fused logreg run on the
   8-recording session, each rank's line (``pod_rank``) with its K1
   launches (one per owned recording, 4), its exchanged (2,135, 48)
   matrix bit-equal to the one-process kernel's rows, its statistics
   digest equal to the one-process card run's, the backend, its wall and
   the exchange's time, and a ``pod_run`` line with the walls side by
   side; the two-process worker ``tests/_torch_distributed_worker.py`` on
   the card (the time-sharded ingest and the streaming halo across the
   process boundary, the train step, SGD, the member-sharded population),
   every output bit-equal to one process over the same four shards of the
   card; the streaming extractor at BASELINE config 5's width (256
   channels, 65,536 samples, window 512 / stride 256) on the 4-shard mesh
   against the CPU port within STREAM_TOL, three walls; and on four cards
   a rank a card (``CUDA_VISIBLE_DEVICES``) over NCCL with the same checks
   and each rank's ingest and train walls beside the one-process run's,
   else one line saying why that part did not run;
4k. the plan executor (``scheduler.PlanExecutor``) on the card over the
   8-recording session, four fused logreg plans (step sizes 1.0, 0.5,
   0.25, 0.125) first run alone (``PipelineBuilder(q).execute()``):
   ``max_concurrent=1``, 2 and 4, journaled, each plan's statistics
   byte-equal to its solo run, K1 8 x 4 over each batch, the wall and
   plans/s at each (``sched_concurrency``); a ``faults=ingest.fused:once@1``
   plan failing with its ``crash_report.json`` beside a clean plan whose
   statistics and per-plan counters equal its solo run's
   (``sched_isolation``); a ``faults=scheduler.plan:once@1`` plan absorbed
   by a retry, two attempts (``sched_retry``); a child process
   (``tests/_torch_scheduler_worker.py --device=cuda``) SIGKILLed mid-plan
   after its first plan completed, then ``recover()`` here: the completed
   record byte-untouched and not re-run, each unfinished plan run once
   (K1 8 x unfinished), statistics byte-equal to solo (``sched_recovery``);
   two executors with lease directories over one journal racing
   ``claim_and_run`` for an orphaned record, run exactly once
   (``sched_takeover``); and ``faults=scheduler.journal:p=1.0``: the plan
   runs unjournaled, the failed writes counted (``sched_journal_chaos``);
   its plans carry ``dedup=false``, so each runs its own ingest;
4l. the plan service on the card over the 8-recording session: a fused
   logreg and svm plan (``config_reg_param=0.1``) through
   ``PlanExecutor(max_concurrent=2)`` share one prefix build
   (``scheduler/dedup.py``): K1 8 for the pair, the files read once, both
   statistics byte-equal to their solo ``dedup=false`` runs, one leader and
   one follower block, the follower fitting on the leader's card tensor,
   whose digest after both fits is the solo build's (``service_dedup_pair``);
   with ``EEG_TPU_DEVICE_POOL=auto`` the pool is the one card, and two
   plans take ordinal 0 in turn (``placement.grants`` 2, the waits
   counted, K1 16, statistics byte-equal to solo; ``service_placement``);
   a ``GatewayServer`` on 127.0.0.1:0 over a journal: ``POST /plans`` 201,
   its keyed replay 200, an invalid query 400, the report byte-equal to
   solo with K1 8, 16 ``POST /predict`` requests over a
   ``MultiplexedService`` of four tenants with margins equal to the
   service's engine called directly (K6's launches counted over the
   requests only), ``/metrics`` parsing, ``/healthz`` and ``/readyz`` 200
   (``service_gateway``); and two ``python -m
   eeg_dataanalysispackage_tpu_torch.gateway --fleet --device=cuda``
   replicas over one journal: the one running a host random forest over
   K1's rows is SIGKILLed, the other completes the plan under its id by
   takeover with the solo run's statistics, then exits 0 on SIGTERM
   (``service_fleet``); every wall beside the card's name and power limit;
   the replicas run with ``EEG_TPU_TRACE_DIR`` and ``--report-root`` set
   and the plan carries ``X-Trace-Id``, for phase 4m;
4m. the operator plane: before the survivor's drain, the killed and the
   surviving replica's trace segments carry the plan's trace id, the
   survivor's ``run_report.json`` names its segment (``trace.segment``
   ``gw-b``), and a fresh interpreter running the port's ``plan_admin
   trace/list/fleet`` and ``fleet_top --snapshot --journal`` over the
   survivor and the killed replica's URL prints one tree with the takeover
   seam, renders the dead URL DOWN and holds no JAX module
   (``operator_trace``, ``operator_tools``); then ``chaos_run --device
   cuda`` exits 0 on ``device.step:once@2`` under ``elastic=true`` with K1
   16 (``operator_chaos``), ``obs.save_memory_profile`` writes the
   allocator's snapshot (``operator_memory``), and the trace sink's cost a
   span is timed in this process (``operator_sink_cost``);
4n. the walkthroughs (``eeg_dataanalysispackage_tpu_torch/examples``), each
   ``run(device="cuda")`` in this process at the JAX scripts' sizes, K1's
   launches counted from 0 just before each and its wall printed:
   ``train_p300`` on the 8-recording session (K1 8), ``fused_ingest`` (K1
   within KERNEL_TOL of its plain version; the regular featurizer's rows
   bit-equal to K1 launched at the same positions; K1 2),
   ``raw_stream_training`` (the resumed parameters bit-equal to the
   uninterrupted run's; K1 18), ``sharded_long_recording`` and
   ``stream_continuous`` over eight time shards (eight cards, else the
   first card eight times): the sharded rows bit-equal to one unsharded
   K1 launch on the same plan (K1 8 + 3), the blocked rows within
   STREAM_TOL of the mesh rows before the ring wraps; ``mllib_migration``
   (the imported GLM's predictions the manual margins', the forest's
   predictions and round trip the CPU run's); then ``python -X importtime
   -m eeg_dataanalysispackage_tpu_torch.examples.train_p300 <info>`` in a
   fresh interpreter: this process's statistics, K1 8, no JAX module
   imported (``walkthrough_cli``);
5. the serving path end to end: ``serve=true`` with the saved model on
   the card (the ``mega`` rung, the megakernel's launch count over the
   run, every kept epoch completed, none shed, a clean drain, latency
   p50/p99 and mean batch size), statistics equal to the card's batch
   ``load_clf=`` run and to the CPU ``serve=true`` run under the same
   near-threshold rule; a ``fused``-rung service predicting what the
   ``mega`` service predicts; one 64-window batch split into host
   staging, host-to-device copy, kernel call, margin sync and the whole
   ``engine.execute`` (host wall, medians of 25); a 16-thread
   ``predict_window`` probe; then ``serve=true&precision=int8|int4`` on
   the ``mega`` rung (the int8/int4 megakernel's launches) and
   ``precision=bf16`` on the ``fused`` rung (K2-bf16's launches), each
   with its statistics equal to the card's batch ``load_clf=`` run at
   the same precision; then a ``MultiplexedService`` of 128 tenants
   (tenant 0 the saved model, the rest its weights with seeded
   perturbations) serving the kept windows with tenants interleaved,
   a swap, an add and a remove made while the first half is in flight
   (no library built, the program object unchanged; the removed tenant's
   requests still queued fail alone, every other request completes),
   K6's launches over
   the run, the rows of 8 tenants (lanes 0, 1, 63 and 127 among them)
   equal bit for bit to a solo ``mega`` service of that tenant, tenant
   0's statistics over every kept window equal to the card's batch
   ``load_clf=`` run, one mixed 64-window batch split into host staging,
   the stream's and the lanes' host-to-device copies, kernel call,
   margin sync and ``engine.execute``, and a per-tenant quota shed probe
   with its evidence; then the same 128 tenants at
   ``weights_precision=int8`` and ``int4`` (admin mid-run): the weights
   record and resident bytes, K6-w8/w4's launches, the largest margin
   gap against an f32 service at the weights gate's tolerance, a mixed
   batch bit-equal to K6 on the dequantized stack, and a swap that leaves
   every other lane's packed bytes, scale and margins unchanged; then
   serving at a 256-sample window (a ServingEngine at f32/int8/int4 and a
   128-tenant MultiplexedEngine at f32/int8/int4: the generic K5 and K6
   instantiations' launches, margins against the CPU engines), on the
   session's int16 windows and on them scaled into float32 windows (the
   generic float32-sample instantiations), each launch's design and plan
   printed, and a ``generic_designs`` line with the generic launches of
   each design over phases 4 and 5, by kernel;
5b. remote locations: the 8-recording session on a loopback object store
   and WebHDFS namenode (``tests/_loopback.py``, one ``http.server`` on
   127.0.0.1): ``info_file=hdfs://…&fe=dwt-8-fused`` with logreg, saving
   its model to ``hdfs://`` (K1 once per recording; statistics equal to
   phase 4's local run byte for byte), ``info_file=http://…&fe=dwt-8-pallas``
   (K4 twice; equal to the local ``-pallas`` run), ``serve=true`` with
   ``load_name=hdfs://…`` (K5; equal to the batch ``load_clf=`` run from
   the same store), four tenants from a ``load_tenants`` spec over
   ``http://`` in a ``MultiplexedService`` (K6; each tenant's margins bit
   for bit those of a solo service), ``gs://`` through
   ``GcsFileSystem(endpoint=…)`` (features bit-equal to the local run's),
   the fused run again with the store failing every third request with a
   500 and cutting one body in half (retries counted; statistics
   unchanged), and a dead endpoint (its circuit opens after ``threshold``
   exhausted budgets and the next call fails fast); parse seconds and
   MB/s over loopback beside the local parse, the retry and ``circuit.*``
   counters and each run's launches;
5c. the serving lifecycle: ``serve=true&adapt=true&swap_gate=off`` with
   the saved model at the JAX package's defaults (``adapt_batch=16``,
   ``adapt_iters=20``, ``drift_window=64``, a 1,024-row ring) and a
   ``checkpoint_path=``: statistics equal to the plain serve run's, the
   ingest kernel's launches over the adapt stage (one per featurize
   call: each feedback batch's run of equal resolutions) and the
   megakernel's over serving, the lifecycle block's counts (every kept
   epoch received, one chunk per batch, no failure) and the adapt
   stage's wall split per batch into featurize, SGD chunk and checkpoint
   (medians); then a service with a permissive gate fed the session
   twice, the first time while the session is served again (latency
   p50/p99 with the adapter busy beside phase 5's): at least one swap,
   no library built, the mega program unchanged, and the predictions
   served after the swap equal to the card's batch ``load_clf=`` run of
   ``promoted.npz`` under the near-threshold rule, and bit for bit to a
   fresh service around it; then an adapter abandoned after its 3rd
   checkpoint and resumed over the same directory, its candidate weights
   byte-equal to an uninterrupted twin's;
6. timing (CUDA events around one wrapper call, median of 25; and the
   kernel's own device time from ``torch.profiler``, mean of 10, taken
   before the plain version runs, with the SM clock read just after) beside
   the plain version's time and the card's bound: the ingest kernel at
   32,768 windows on an int16 and on a float32 stream and at the bf16,
   int8 and int4 rungs, and at the batch path's own launch size (the
   session's first recording staged and planned, 320 rows), the
   megakernel (f32, int8, int4) at capacity 64
   (one serve batch) and at 32,768 windows, K6 at the same sizes with
   lanes cycling over 128 tenants, the epoch-features kernel at 32,768
   epochs, at the ``-pallas`` run's 641 and 1,494 and at the seizure
   ``-pallas`` run's launch at four recordings, 9,596 epochs of 768
   samples, beside
   ``library_ms``, one ``torch.matmul`` of the window view with W (TF32
   off: the contraction without the normalize), and ``window_read_ms``,
   one PyTorch reduction over the same window view; and at 4,096 epochs at
   each size off the main path of phase 3; K6-w8/w4 at capacity 64 and
   32,768 beside K6; the float32-sample megakernels (K5-f32s at f32,
   int8 and int4, K6-f32s, K6-w8-f32s, K6-w4-f32s) at 64 and 32,768
   windows, their bound counting 4-byte samples, each line with the
   design its launch took (run_windows at 64, the tile design at 32,768);
   the epoch-features
   kernel at one host-extractor batch of 64; the generic instantiations
   (K1 at every rung, K5, K6, K6-w8/w4, and the megakernels on float32
   samples) at 4,096 windows at each generic size of phase 3 and at
   one serve batch of 64 at GENERIC_PATH_SIZE, each with the windows a
   tile, the design and the plan its launch took and ``library_ms``, one
   ``torch.matmul`` of the
   centred windows with W (TF32 off: the contraction alone), and that
   library call and the bound at chip_compare.py's 76-channel case (256
   windows at GENERIC_WIDE: ``generic_wide_library``); the same
   library call for the 512/16 rows at 64, 320 and 32,768 windows.

Phases 4 and 5 end in a ``mega_designs`` line: the float32-sample
megakernel launches at 512 / 16 of this process by design and capacity
(``MegaDesignLog``); at least one must have taken the tile design.

Then the ``kernels`` line, the ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero with no
``ok`` line. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import signal
import statistics as pystats
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = 2e-6  # kernel vs plain version: summation orders only
# a margin carries a feature error times at most ||w||_1
MARGIN_TOL_PER_L1 = KERNEL_TOL
MARGIN_BAND = 1e-4  # a differing test row must sit this close to the threshold

# Datasheet peaks (NVIDIA H100/H200 data sheets, dense rates): memory
# bytes/s, float32 FLOP/s outside the tensor cores and bf16 FLOP/s on the
# tensor cores, keyed by a substring of the card's name; the first match
# wins.
CARD_PEAKS = (
    ("H100 PCIE", 2.0e12, 51e12, 756e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H100", 3.35e12, 67e12, 989e12),
    ("H200", 4.8e12, 67e12, 989e12),
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_peaks(name: str):
    upper = name.upper()
    for key, bw, f32_flops, bf16_flops in CARD_PEAKS:
        if key in upper:
            return bw, f32_flops, bf16_flops
    raise RuntimeError(f"no datasheet peaks recorded for {name!r}")


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def sm_clock_mhz():
    """The card's SM clock now (``nvidia-smi``), or None where it reads none."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, timeout=60)
    try:
        return int(proc.stdout.split()[0])
    except (IndexError, ValueError):
        return None


def time_ms(fn, warmup: int = 3, runs: int = 25) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn`` after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return pystats.median(times)


def profiled_device_ms(fn, kernel: str, runs: int = 10):
    """Device time (ms) a call of ``fn`` spends in the CUDA kernels whose
    names contain ``kernel``, from ``torch.profiler`` over ``runs``
    calls: their summed device time over ``runs``, the kernels alone,
    without the wrapper's host work that a CUDA-event pair around one
    call also counts. A trace is taken only where it holds device time
    and the number of matching kernel records is a whole multiple of
    ``runs`` (the same launches in every call); any other trace is
    printed as a ``profiler_retake`` line and taken again, up to twice.
    None when no trace passes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        found = [(ev.key, ev.count, ev.device_time_total) for ev in prof.key_averages()
                 if kernel in ev.key and ev.count]
        count = sum(c for _k, c, _t in found)
        total_us = sum(t for _k, _c, t in found)
        if count and count % runs == 0 and total_us > 0:
            return total_us / runs / 1e3
        emit("profiler_retake", kernel=kernel, attempt=attempt, runs=runs,
             records=[{"key": k[:120], "count": c, "device_us": t} for k, c, t in found])
    return None


def needed_samples(starts, n_samples: int, pre: int, skip: int, epoch: int) -> int:
    """Distinct stream samples the windows read per channel: the baseline
    [s, s+pre) and analysis [s+pre+skip, s+pre+skip+epoch) segments, as
    a union clipped to the stream."""
    import numpy as np

    s = np.asarray(starts, dtype=np.int64)
    lo = np.concatenate([s, s + pre + skip])
    hi = np.concatenate([s + pre, s + pre + skip + epoch])
    lo, hi = np.clip(lo, 0, n_samples), np.clip(hi, 0, n_samples)
    order = np.argsort(lo, kind="stable")
    total, reach = 0, 0
    for a, b in zip(lo[order], hi[order]):
        a = max(a, reach)
        if b > a:
            total += int(b - a)
            reach = b
    return total


def quantizers():
    """The port's plain quantizers by rung, on CPU tensors."""
    from eeg_dataanalysispackage_tpu_torch.ops import decode_ingest, quant

    return {"int8": decode_ingest.int8_feature_path, "int4": quant.int4_feature_path}


def flip_check(np, got, want, f32_rows, precision, label, feature_size=16):
    """Quantized rows against other quantized rows of the same windows:
    equal within KERNEL_TOL except boundary flips, each exactly one
    quantization step of its group (within KERNEL_TOL). Returns (flips,
    max deviation of the other elements)."""
    import torch

    from eeg_dataanalysispackage_tpu_torch.ops import decode_ingest

    K = feature_size
    got, want = np.asarray(got), np.asarray(want)
    qmax = {"int8": 127.0, "int4": 7.0}[precision]
    scales = decode_ingest.quantize_levels(torch.as_tensor(np.asarray(f32_rows)), K,
                                           qmax)[1].numpy()
    group_of = [g for g, (lo, hi) in enumerate(decode_ingest.subband_group_bounds(K))
                for _ in range(lo, hi)]
    diff = np.abs(got - want)
    flips = np.argwhere(diff > KERNEL_TOL)
    for r, i in flips:
        step = scales[group_of[i % K], r, i // K]
        if abs(diff[r, i] - step) > KERNEL_TOL:
            raise AssertionError(f"{label}: row {r} col {i} differs by {diff[r, i]}, "
                                 f"not one step {step}")
    rest = np.where(diff > KERNEL_TOL, 0.0, diff)
    return int(len(flips)), float(rest.max()) if rest.size else 0.0


def check_rungs(torch, np, ingest_cuda, device_ingest, raw, res, starts, W, f32_rows, name,
                worst):
    """The bf16, int8 and int4 instantiations on one case: bf16 within
    KERNEL_TOL of its plain version and within the bf16 gate of the f32
    rung; int8/int4 equal bit for bit to the plain quantizer applied to
    the f32 kernel's rows, and against the plain chain within KERNEL_TOL
    except counted boundary flips; windows at the end give zero rows."""
    from eeg_dataanalysispackage_tpu_torch.ops import decode_ingest

    at_end = starts >= raw.shape[1]
    fields = {}
    bf16 = ingest_cuda.ingest_features(raw, res, starts, W, precision="bf16")
    torch.cuda.synchronize()
    bf16_plain = device_ingest.ingest_features_plain(raw, res, starts, W, precision="bf16")
    err = (bf16 - bf16_plain).abs().max().item()
    vs_f32 = (bf16 - f32_rows).abs().max().item()
    ok = (err <= KERNEL_TOL and vs_f32 <= decode_ingest.BF16_GATE_TOL
          and bool(torch.isfinite(bf16).all()) and bool((bf16[at_end] == 0).all()))
    fields["bf16"] = {"max_abs_err": err, "max_dev_vs_f32": vs_f32}
    worst["bf16"] = max(worst.get("bf16", 0.0), err)
    f32_cpu = f32_rows.cpu()
    for precision, quantize in quantizers().items():
        q = ingest_cuda.ingest_features(raw, res, starts, W, precision=precision)
        torch.cuda.synchronize()
        bit_equal = q.cpu().numpy().tobytes() == quantize(f32_cpu, 16).numpy().tobytes()
        plain = device_ingest.ingest_features_plain(raw, res, starts, W, precision=precision)
        flips, err = flip_check(np, q.cpu(), plain.cpu(), f32_cpu, precision, name)
        ok = ok and bit_equal and bool((q[at_end] == 0).all())
        fields[precision] = {"epilogue_bit_equal": bit_equal, "flips_vs_plain": flips,
                             "max_abs_err": err}
        worst[precision] = max(worst.get(precision, 0.0), err)
    emit("rungs_vs_plain", case=name, windows=int(starts.shape[0]), tol=KERNEL_TOL,
         bf16_gate=decode_ingest.BF16_GATE_TOL, **fields)
    if not ok:
        raise AssertionError(f"a precision instantiation disagrees on {name}: {fields}")


def phase_kernel_cases(torch, np, ingest_cuda, device_ingest, W, dev):
    """Kernel against its plain version on the card, per input case, at
    every precision= instantiation. Returns the worst deviation per
    rung ({"f32": …, "bf16": …, "int8": …, "int4": …})."""
    res = torch.tensor([0.1, 0.1, 0.2], dtype=torch.float32, device=dev)
    rng = np.random.RandomState(0)

    def stream(S, dc=(0, 0, 0), noise=3000):
        x = rng.randint(-noise, noise, size=(3, S)) + np.asarray(dc)[:, None]
        return torch.from_numpy(np.clip(x, -32768, 32767).astype(np.int16)).to(dev)

    S = 200_000
    main_S = 1_212_416  # a staged 1,200-marker recording (16,384-sample buckets)
    main_starts = np.concatenate([100 + 4500 * np.arange(267), np.full(53, main_S)])
    # a stream whose rows are not 16-byte aligned, the recording's last
    # 5,000 samples zeroed as the staged padding is
    odd_S = S + 1
    padded = stream(odd_S)
    padded[:, odd_S - 5000:] = 0
    n_true = odd_S - 5000
    cases = {
        "random": (stream(S), np.sort(rng.randint(0, S - 787, size=500))),
        "dc_heavy": (stream(S, (30000, -30000, 29500), 1500), 1000 * np.arange(150)),
        "overhang": (stream(S), np.array([10, S - 300, S - 686, S - 1, S])),
        "single": (stream(S), np.array([12345])),
        "dense": (stream(S), 3 + 37 * np.arange(2000)),
        "odd_count": (stream(S), rng.randint(0, S, size=1001)),
        "main_path_shape": (stream(main_S), main_starts),
        # every sample offset within a 16-byte chunk (8 int16 samples), twice
        "chunk_offsets": (stream(S, (15000, -12000, 9000), 3000),
                          np.concatenate([b + np.arange(16) for b in (0, 77777, S - 800)])),
        # negative starts, straddling the recording's end into its padding
        # and the stream's end, at the end and past it, on unaligned rows
        "edges_unaligned": (padded, np.array([
            -900, -787, -612, -101, -100, -7, -1, 0, 3, n_true - 787, n_true - 612,
            n_true - 300, n_true - 1, n_true, odd_S - 787, odd_S - 612, odd_S - 300,
            odd_S - 1, odd_S, odd_S + 9])),
    }
    worst = {"f32": 0.0}
    for name, (raw, starts_np) in cases.items():
        starts = torch.from_numpy(starts_np.astype(np.int32)).to(dev)
        got = ingest_cuda.ingest_features(raw, res, starts, W)
        torch.cuda.synchronize()
        want = device_ingest.ingest_features_plain(raw, res, starts, W)
        err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        at_end = starts_np >= raw.shape[1]
        zero_rows = bool((got[torch.from_numpy(at_end).to(dev)] == 0).all())
        emit("kernel_vs_plain", case=name, windows=int(len(starts_np)),
             samples=int(raw.shape[1]), max_abs_err=err, tol=KERNEL_TOL,
             finite=finite, end_rows_zero=zero_rows)
        if not (err <= KERNEL_TOL and finite and zero_rows
                and got.shape == (len(starts_np), 48)):
            raise AssertionError(f"kernel disagrees with its plain version on {name}")
        worst["f32"] = max(worst["f32"], err)
        check_rungs(torch, np, ingest_cuda, device_ingest, raw, res, starts, W, got, name,
                    worst)
    return worst


def write_session(directory: str, n_files: int = 8, n_markers: int = 1200) -> str:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import _synthetic

    lines = []
    for i in range(n_files):
        guessed = 1 + (i * 4) % 9
        _synthetic.write_recording(
            directory, name=f"rec_{i:02d}", n_markers=n_markers,
            guessed=guessed, seed=100 + i, marker_stride=1000,
        )
        lines.append(f"rec_{i:02d}.eeg {guessed}")
    info = os.path.join(directory, "info.txt")
    with open(info, "w") as f:
        f.write("\n".join(lines) + "\n")
    return info


def compare_runs(np, gpu, cpu, label: str) -> None:
    """Equal statistics, or differing test rows within MARGIN_BAND of the
    threshold on both runs (printed)."""
    rows = []
    if str(gpu.statistics) != str(cpu.statistics):
        m_g, m_c = margins_on_test_rows(gpu), margins_on_test_rows(cpu)
        thr = gpu.classifier.margin_threshold
        differ = np.nonzero((m_g > thr) != (m_c > thr))[0]
        for r in differ:
            rows.append({"row": int(gpu.test_index[r]), "margin_cuda": float(m_g[r]),
                         "margin_cpu": float(m_c[r])})
        near = all(abs(x["margin_cuda"] - thr) <= MARGIN_BAND
                   and abs(x["margin_cpu"] - thr) <= MARGIN_BAND for x in rows)
        if not rows or not near:
            raise AssertionError(f"{label}: statistics differ beyond near-threshold rows: {rows}")
    emit("cpu_parity", run=label, statistics_equal=not rows, near_threshold_rows=rows)


def build_kernels(cuda_build, names, host_names=("eeg_host",)):
    """Build every named kernel from the checkout's sources, one nvcc
    each, and the input pipeline's native host library (g++), all started
    together; a stale library is rebuilt."""
    for name in names:
        stale = cuda_build.library_path(name)
        if os.path.exists(stale):
            os.remove(stale)
    for name in host_names:
        stale = cuda_build.host_library_path(name)
        if os.path.exists(stale):
            os.remove(stale)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + len(host_names)) as pool:
        kernels = [pool.submit(cuda_build.build, name) for name in names]
        hosts = [pool.submit(cuda_build.build_host, name) for name in host_names]
        libs = [f.result() for f in kernels]
        host_libs = [f.result() for f in hosts]
    seconds = time.perf_counter() - t0
    for name, lib in zip(names, libs):
        ptxas = [ln.strip() for ln in cuda_build.BUILD_LOGS.get(name, "").splitlines()
                 if "registers" in ln or "spill" in ln]
        emit("build", kernel=name, seconds_all=seconds,
             library=os.path.relpath(lib, REPO), ptxas=ptxas)
    for name, lib in zip(host_names, host_libs):
        emit("build_native", source=f"{name}.cc", seconds=cuda_build.BUILD_SECONDS[f"{name}.cc"],
             nvcc_seconds={n: cuda_build.BUILD_SECONDS[f"{n}.cu"] for n in names},
             seconds_all=seconds, library=os.path.relpath(lib, REPO))


def generic_build(cuda_build, generic_plan, sms, optin):
    """The generic engine's instantiations as built: each one's registers,
    barriers and spills from ``ptxas -v`` (keyed by kernel, ``p``recision,
    tenant-stack ``w``eights, sample type and ``d``esign: 0 the
    phase-by-phase design, 1 the ring design), and both designs' tile plans
    (``ops/generic_plan.design_plans``: fields, shared memory and modelled
    clocks) with the one the launch takes, at GENERIC_SIZES and
    GENERIC_WIDE, at 4,096 windows and a serve batch of 64, on int16 and
    float32 samples."""
    kernels, current = {}, None
    for log in cuda_build.BUILD_LOGS.values():
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                name = entry.group(1)
                kernel = re.search(r"(ingest_features_any_kernel|serve_mega_any_kernel)I([sf])",
                                   name)
                current = None
                if kernel:
                    precision = re.search(r"PrecisionE(\d)E", name)
                    multi = re.search(r"Lb([01])E", name)
                    weights = re.search(r"WeightsE(\d)E", name)
                    design = re.search(r"Li(\d)E", name)
                    current = (kernel.group(1).replace("_kernel", "")
                               + ("_multi" if multi and multi.group(1) == "1" else "")
                               + f"_p{precision.group(1) if precision else 0}"
                               + (f"_w{weights.group(1)}" if weights else "")
                               + ("_f32s" if kernel.group(2) == "f" else "")
                               + f"_d{design.group(1) if design else '?'}")
                continue
            if current is None:
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill:
                kernels.setdefault(current, {}).update(spill_stores=int(spill.group(1)),
                                                       spill_loads=int(spill.group(2)))
            regs = re.search(r"Used (\d+) registers(?:, used (\d+) barriers)?", line)
            if regs:
                kernels.setdefault(current, {})["registers"] = int(regs.group(1))
                if regs.group(2):
                    kernels[current]["barriers"] = int(regs.group(2))
    plans = {}
    for (e, K, _skip), C in ([(size, 3) for size in GENERIC_SIZES] + [(GENERIC_WIDE, 76)]):
        for rows in (4096, 64):
            for sample_bytes in (2, 4):
                both = generic_plan.design_plans(C, e, K, rows, sms, optin, 100, sample_bytes)
                chosen = generic_plan.generic_tile_plan(C, e, K, rows, sms, optin, 100,
                                                        sample_bytes)
                plans[f"{C}x{e}x{K}@{rows}/{sample_bytes}B"] = {
                    "design": generic_plan.DESIGNS[chosen.design],
                    **{name: {**plan._asdict(), "clocks": clocks}
                       for name, (plan, clocks) in zip(generic_plan.DESIGNS, both)}}
    return {"kernels": kernels, "no_spills": all(not k.get("spill_stores") and
                                                 not k.get("spill_loads")
                                                 for k in kernels.values()),
            "plans": plans}


class PlanLog:
    """Records the plan of every generic launch while it is entered: the
    wrappers call ``generic_plan.generic_tile_plan`` once a launch (a
    memoized lookup), so each call is one launch's plan. ``summary()``
    gives each distinct plan (its design, fields and launch sizes) with
    how many launches took it."""

    def __init__(self):
        from eeg_dataanalysispackage_tpu_torch.ops import generic_plan

        self.module = generic_plan
        self.calls = []

    def __enter__(self):
        plan_of = self.orig = self.module.generic_tile_plan

        def logged(*args, **kwargs):
            plan = plan_of(*args, **kwargs)
            if plan is not None:
                self.calls.append((args[:4] + args[6:8], plan))
            return plan

        self.module.generic_tile_plan = logged
        return self

    def __exit__(self, *exc):
        self.module.generic_tile_plan = self.orig
        return False

    def summary(self):
        counts = {}
        for sizes, plan in self.calls:
            key = (sizes, plan)
            counts[key] = counts.get(key, 0) + 1
        return [{"design": self.module.DESIGNS[plan.design], "fields": list(plan.fields()),
                 "launch": list(sizes), "launches": n} for (sizes, plan), n in counts.items()]

    def designs(self):
        out = dict.fromkeys(self.module.DESIGNS, 0)
        for _sizes, plan in self.calls:
            out[self.module.DESIGNS[plan.design]] += 1
        return out


class MegaDesignLog:
    """Records the design of every float32-sample megakernel launch at 512
    / 16 while it is entered (the wrappers call
    ``serve_mega_cuda.mega_design`` once a launch, a memoized lookup):
    ``launches`` is {design: {capacity: launches}}. Launches in other
    processes (pod ranks, fleet replicas) are not seen."""

    def __init__(self):
        from eeg_dataanalysispackage_tpu_torch.ops import serve_mega_cuda

        self.module = serve_mega_cuda
        self.launches = {}

    def __enter__(self):
        pick = self.orig = self.module.mega_design

        def logged(capacity, *args):
            design = pick(capacity, *args)
            if (args[5] if len(args) > 5 else 4) == 4:
                by = self.launches.setdefault(self.module.MEGA_DESIGNS[design], {})
                by[capacity] = by.get(capacity, 0) + 1
            return design

        self.module.mega_design = logged
        return self

    def __exit__(self, *exc):
        self.module.mega_design = self.orig
        return False

    def totals(self):
        return {d: sum(self.launches.get(d, {}).values()) for d in self.module.MEGA_DESIGNS}


class forced_design:
    """Every float32-sample megakernel launch at 512 / 16 in the design
    named ``design`` while entered (``serve_mega_cuda.mega_design``
    replaced): the design comparisons of phases 3 and 4b. A launch outside
    that design's reach raises, as any refused launch does."""

    def __init__(self, design):
        from eeg_dataanalysispackage_tpu_torch.ops import serve_mega_cuda

        self.module = serve_mega_cuda
        self.index = serve_mega_cuda.MEGA_DESIGNS.index(design)

    def __enter__(self):
        self.orig = self.module.mega_design
        self.module.mega_design = lambda *args, index=self.index: index
        return self

    def __exit__(self, *exc):
        self.module.mega_design = self.orig
        return False


def designs_bit_equal(fn) -> bool:
    """Whether ``fn``'s output is the same bytes with each float32-sample
    megakernel design forced."""
    outs = set()
    for design in ("ring", "tiles"):
        with forced_design(design):
            outs.add(fn().cpu().numpy().tobytes())
    return len(outs) == 1


def mega_batch(torch, np, serve_mega, dev, capacity, n, dc, noise, seed, samples="int16"):
    """``n`` windows of int16 noise over ``dc`` staged at capacity
    ``capacity``, with resolutions, the cascade operator and random
    weights, on ``dev``. ``samples="float32"``: the same windows scaled by
    the resolutions into float32 with unit resolutions, as a recording in
    another binary format is staged (at the int16 limit's DC, a float
    stream of DC x resolution that stresses the baseline's cancellation)."""
    stride = serve_mega.padded_stride(100, 750)
    rng = np.random.RandomState(seed)
    windows = [
        np.clip(rng.randint(-noise, noise, size=(3, 850)) + np.asarray(dc)[:, None],
                -32768, 32767).astype(np.int16)
        for _ in range(n)
    ]
    stream = torch.from_numpy(serve_mega.stage_mega_stream(windows, 3, 850, stride,
                                                           capacity)).to(dev)
    weights = torch.from_numpy(rng.randn(48).astype(np.float32)).to(dev)
    res = torch.tensor([0.1, 0.1, 0.2], dtype=torch.float32, device=dev)
    if samples == "float32":
        stream = (stream.to(torch.float32) * res[:, None]).contiguous()
        res = torch.ones(3, dtype=torch.float32, device=dev)
    return stream, res, weights, stride


def check_mega_rungs(torch, np, serve_mega, serve_mega_cuda, stream, res, W, weights, stride,
                     n, name, worst, suffix=""):
    """The int8 and int4 megakernels on one case: margins within
    MARGIN_TOL_PER_L1 * ||w||_1 of the quantized ingest kernel's rows of
    the same windows dotted with w; within the rung's tolerance of the
    plain version, with the boundary flips between the kernel's and the
    plain version's rows counted; padded rows 0; the last window's
    margin the same solo and in the batch."""
    from eeg_dataanalysispackage_tpu_torch.ops import decode_ingest, device_ingest, ingest_cuda

    capacity = stream.shape[1] // stride
    starts = (torch.arange(capacity, dtype=torch.int32, device=stream.device) * stride)
    f32_rows = ingest_cuda.ingest_features(stream, res, starts, W).cpu()
    fields, ok = {}, True
    for precision in ("int8", "int4"):
        got = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175, stride,
                                                 precision)
        torch.cuda.synchronize()
        rows = ingest_cuda.ingest_features(stream, res, starts, W, 100, 175, precision)
        err = (got - rows @ weights).abs().max().item()
        plain = serve_mega.serve_mega_margins_plain(stream, res, W, weights, 100, 175,
                                                    stride, precision)
        plain_rows = device_ingest.ingest_features_plain(stream, res, starts, W, 100, 175,
                                                         precision)
        flips, _ = flip_check(np, rows.cpu(), plain_rows.cpu(), f32_rows, precision, name)
        dev_plain = (got - plain).abs().max().item()
        tol = MARGIN_TOL_PER_L1 * weights.abs().sum().item()
        solo = torch.zeros_like(stream)
        solo[:, :stride] = stream[:, (n - 1) * stride:n * stride]
        solo_m = serve_mega_cuda.serve_mega_margins(solo, res, W, weights, 100, 175, stride,
                                                    precision)
        solo_equal = solo_m[0].item() == got[n - 1].item()
        pad_zero = bool((got[n:] == 0).all())
        gate = decode_ingest.precision_gate_tolerance(precision)
        ok = ok and err <= tol and dev_plain <= gate and solo_equal and pad_zero
        fields[precision] = {"max_abs_err": err, "tol": tol, "max_dev_vs_plain": dev_plain,
                             "rung_tol": gate, "row_flips_vs_plain": flips,
                             "padded_rows_zero": pad_zero, "solo_equals_batch": solo_equal}
        worst[precision + suffix] = max(worst.get(precision + suffix, 0.0), err)
    emit("mega_rungs_vs_ingest", case=name, capacity=capacity, windows=n,
         samples=str(stream.dtype).replace("torch.", ""), **fields)
    if not ok:
        raise AssertionError(f"a quantized megakernel disagrees on {name}: {fields}")


def phase_mega_cases(torch, np, serve_mega, serve_mega_cuda, W, dev):
    """The megakernel against its plain version on the card, per input
    case; padded rows exactly 0; one window's margin equal solo and in
    a batch; the int8 and int4 instantiations on every case
    (:func:`check_mega_rungs`). Then the float32-sample instantiations
    (K5-f32s, K5-int8-f32s, K5-int4-f32s) on float32 streams
    (:func:`mega_batch`'s float form), at capacity 64, 2,048 and 32,768
    windows. Returns the worst deviation per rung (``_f32s`` keys: the
    float32-sample instantiations)."""
    worst = {"f32": 0.0, "f32_f32s": 0.0}
    cases = []
    for capacity in (64, 128, 2048):
        for n in (1, capacity):
            cases.append((f"random_cap{capacity}_n{n}", capacity, n, (0, 0, 0), 3000,
                          "int16"))
            cases.append((f"dc_heavy_cap{capacity}_n{n}", capacity, n,
                          (30000, -30000, 29500), 1500, "int16"))
    cases.append(("odd_count_cap128_n77", 128, 77, (15000, -12000, 9000), 3000, "int16"))
    # capacities on both sides of the tile design's crossover (1,056 windows
    # on 132 multiprocessors), 4,099 not a multiple of its 4-window tiles
    for capacity, n in ((64, 1), (64, 64), (2048, 2048), (4099, 4099), (4099, 4000),
                        (32_768, 32_768)):
        cases.append((f"float32_random_cap{capacity}_n{n}", capacity, n, (0, 0, 0), 3000,
                      "float32"))
        cases.append((f"float32_dc_heavy_cap{capacity}_n{n}", capacity, n,
                      (30000, -30000, 29500), 1500, "float32"))
    cases.append(("float32_odd_count_cap128_n77", 128, 77, (15000, -12000, 9000), 3000,
                  "float32"))
    for seed, (name, capacity, n, dc, noise, samples) in enumerate(cases):
        suffix = "_f32s" if samples == "float32" else ""
        stream, res, weights, stride = mega_batch(torch, np, serve_mega, dev, capacity,
                                                  n, dc, noise, seed, samples)
        got = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175, stride)
        torch.cuda.synchronize()
        want = serve_mega.serve_mega_margins_plain(stream, res, W, weights, 100, 175, stride)
        err = (got - want).abs().max().item()
        tol = MARGIN_TOL_PER_L1 * weights.abs().sum().item()
        finite = bool(torch.isfinite(got).all())
        pad_zero = bool((got[n:] == 0).all())
        # the last window alone in slot 0 of an otherwise empty batch
        solo = torch.zeros_like(stream)
        solo[:, :stride] = stream[:, (n - 1) * stride:n * stride]
        solo_m = serve_mega_cuda.serve_mega_margins(solo, res, W, weights, 100, 175, stride)
        solo_equal = solo_m[0].item() == got[n - 1].item()
        # float32 samples: both designs' margins bit-equal at every rung
        designs = (all(designs_bit_equal(
            lambda p=p: serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175,
                                                           stride, p))
            for p in ("f32", "int8", "int4")) if samples == "float32" else None)
        emit("mega_vs_plain", case=name, capacity=capacity, windows=n, samples=samples,
             max_abs_err=err, tol=tol, finite=finite, padded_rows_zero=pad_zero,
             solo_equals_batch=solo_equal, designs_bit_equal=designs)
        if not (err <= tol and finite and pad_zero and solo_equal and designs is not False
                and got.shape == (capacity,)):
            raise AssertionError(f"megakernel disagrees with its plain version on {name}")
        worst["f32" + suffix] = max(worst["f32" + suffix], err)
        check_mega_rungs(torch, np, serve_mega, serve_mega_cuda, stream, res, W, weights,
                         stride, n, name, worst, suffix)
        del stream
    return worst


def multi_lanes(np, capacity, n, spread):
    """Host lanes of a K6 case: cycling over all 128 lanes, or all on
    one tenant; padded rows lane 0."""
    lanes = np.zeros(capacity, np.int32)
    lanes[:n] = np.arange(n) % 128 if spread == "cycling" else 77
    return lanes


def phase_mega_multi_cases(torch, np, serve_mega, serve_mega_cuda, W, dev):
    """K6, the tenant-stacked megakernel, against its plain version on
    the card per input case: each row within MARGIN_TOL_PER_L1 *
    ||w_lane||_1, bit-equal to the solo megakernel launched with that
    lane's weights; padded rows and a freed (zero) lane exactly 0. Then
    K6-f32s, the float32-sample instantiation, on float32 streams
    (DC-heavy, capacity 64 and 2,048). Returns the worst deviation,
    ``{"": K6, "_f32s": K6-f32s}``."""
    worst = {"": 0.0, "_f32s": 0.0}
    cases = []
    for capacity in (64, 128, 2048):
        for n in (1, capacity):
            for spread in ("cycling", "one_lane"):
                cases.append((f"random_cap{capacity}_n{n}_{spread}", capacity, n, spread,
                              (0, 0, 0), 3000, "int16"))
                cases.append((f"dc_heavy_cap{capacity}_n{n}_{spread}", capacity, n, spread,
                              (30000, -30000, 29500), 1500, "int16"))
    for capacity in (64, 2048, 4099):
        for spread in ("cycling", "one_lane"):
            cases.append((f"float32_dc_heavy_cap{capacity}_n{capacity}_{spread}", capacity,
                          capacity, spread, (30000, -30000, 29500), 1500, "float32"))
    for seed, (name, capacity, n, spread, dc, noise, samples) in enumerate(cases):
        stream, res, _w, stride = mega_batch(torch, np, serve_mega, dev, capacity, n, dc,
                                             noise, 500 + seed, samples)
        rng = np.random.RandomState(seed)
        stack_np = rng.randn(serve_mega.MAX_TENANTS, 48).astype(np.float32)
        stack_np[5] = 0.0  # a freed lane
        stack = torch.from_numpy(stack_np).to(dev)
        lanes_np = multi_lanes(np, capacity, n, spread)
        lanes = torch.from_numpy(lanes_np)
        got = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, stack, lanes, 100, 175,
                                                       stride)
        torch.cuda.synchronize()
        want = serve_mega.serve_mega_multi_margins_plain(stream, res, W, stack, lanes, 100,
                                                         175, stride)
        l1 = np.abs(stack_np).sum(axis=1)[lanes_np]
        dev_rows = (got - want).abs().cpu().numpy()
        within = bool((dev_rows <= MARGIN_TOL_PER_L1 * l1).all())
        err = float(dev_rows.max())
        got_np = got.cpu().numpy()
        bit_equal = True
        for lane in np.unique(lanes_np[:n]):
            solo = serve_mega_cuda.serve_mega_margins(stream, res, W, stack[int(lane)], 100,
                                                      175, stride).cpu().numpy()
            rows = np.nonzero(lanes_np[:n] == lane)[0]
            bit_equal = bit_equal and got_np[rows].tobytes() == solo[rows].tobytes()
        pad_zero = bool((got_np[n:] == 0).all())
        freed_zero = bool((got_np[:n][lanes_np[:n] == 5] == 0).all())
        finite = bool(np.isfinite(got_np).all())
        designs = (designs_bit_equal(lambda: serve_mega_cuda.serve_mega_multi_margins(
            stream, res, W, stack, lanes, 100, 175, stride)) if samples == "float32" else None)
        emit("mega_multi_vs_plain", case=name, capacity=capacity, windows=n, samples=samples,
             lanes_used=int(len(np.unique(lanes_np[:n]))), max_abs_err=err,
             tol_per_l1=MARGIN_TOL_PER_L1, within_tol=within,
             bit_equal_solo_kernel_per_lane=bit_equal, padded_rows_zero=pad_zero,
             freed_lane_zero=freed_zero, finite=finite, designs_bit_equal=designs)
        if not (within and bit_equal and pad_zero and freed_zero and finite
                and designs is not False and got.shape == (capacity,)):
            raise AssertionError(f"K6 disagrees on {name}")
        key = "_f32s" if samples == "float32" else ""
        worst[key] = max(worst[key], err)
    return worst


def differing_rows(pred_a, m_a, pred_b, m_b, thr, label):
    """Rows whose predictions differ between two runs; each must lie
    within MARGIN_BAND of the threshold on both (raises otherwise)."""
    rows = []
    for r in range(len(pred_a)):
        if pred_a[r] != pred_b[r]:
            rows.append({"row": r, "margin_a": float(m_a[r]), "margin_b": float(m_b[r])})
    if not all(abs(x["margin_a"] - thr) <= MARGIN_BAND and abs(x["margin_b"] - thr) <= MARGIN_BAND
               for x in rows):
        raise AssertionError(f"{label}: predictions differ beyond near-threshold rows: {rows}")
    return rows


def session_windows(info):
    """A session's serving requests in request order: (windows,
    per-window resolutions, targets)."""
    from eeg_dataanalysispackage_tpu_torch.epochs.extractor import BalanceState
    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
    from eeg_dataanalysispackage_tpu_torch.serve import engine

    odp = OfflineDataProvider([info], device="cpu")
    windows, resolutions, targets = [], [], []
    balance = BalanceState()
    for _rel, guessed, rec in odp.iter_recordings():
        ws, ts, res = engine.windows_from_recording(
            rec, odp.channel_indices_for(rec), guessed, balance=balance)
        windows.extend(ws)
        resolutions.extend([res] * len(ws))
        targets.extend(float(t) for t in ts)
    return windows, resolutions, targets


def run_cli(query):
    """``python -m eeg_dataanalysispackage_tpu_torch.pipeline.cli <query>``
    from the checkout; returns (exit code, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "eeg_dataanalysispackage_tpu_torch.pipeline.cli",
                           query], cwd=REPO, capture_output=True, text=True, timeout=300)
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr)
    return proc.returncode, time.perf_counter() - t0


def phase_serve(torch, np, info, model, kept):
    """serve=true end to end on the card, held against the card's batch
    load_clf= run and the CPU serve=true run; returns the megakernel's
    launches over the serve run, the session's windows, resolutions and
    targets in request order, and the serve run's statistics and latency
    block."""
    from eeg_dataanalysispackage_tpu_torch.ops import ingest_cuda, serve_mega, serve_mega_cuda
    from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
    from eeg_dataanalysispackage_tpu_torch.serve import InferenceService

    base = f"info_file={info}&fe=dwt-8-fused&load_clf=logreg&load_name={model}"
    batch = PipelineBuilder(base)
    batch_stats = batch.execute()

    # the serving path: counts start at 0 just before the run
    ingest_cuda.LAUNCHES = 0
    serve_mega_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    served_builder = PipelineBuilder(base + "&serve=true")
    served = served_builder.execute()
    wall = time.perf_counter() - t0
    launches = serve_mega_cuda.LAUNCHES
    warmup_ingest_launches = ingest_cuda.LAUNCHES
    block = served_builder.serve_block
    req = block["requests"]
    emit("serve_e2e", rung=block["rung"], serve_mega_launches=launches,
         ingest_launches_warmup=warmup_ingest_launches, kept=kept,
         completed=req["completed"], shed=req["shed"], failed=req["failed"],
         deadline_exceeded=req["deadline_exceeded"], batches=block["batches"],
         mean_batch_size=block["mean_batch_size"], latency_ms=block["latency_ms"],
         drained_cleanly=block["drained_cleanly"], mega_gate=block["mega"]["gate"],
         wall_s=wall, stages_s=served_builder.timers, accuracy=served.calc_accuracy())
    if not (block["rung"] == "mega" and launches >= math.ceil(kept / 64)
            and req["completed"] == kept and req["shed"] == 0
            and block["drained_cleanly"] is True):
        raise AssertionError("serve=true did not serve every epoch through the megakernel")
    cpu_served = PipelineBuilder(base + "&serve=true", device="cpu").execute()

    # per row: the session's windows through mega, fused and CPU services
    windows, resolutions, targets = session_windows(info)
    runs = {}
    for label, kwargs in (("mega", {}), ("fused", {"engine_rung": "fused"}),
                          ("cpu", {"device": "cpu"})):
        with InferenceService.from_saved("logreg", model, **kwargs) as svc:
            results = svc.predict_all(windows, resolutions)
        runs[label] = (np.array([r.prediction for r in results]),
                       np.array([r.margin for r in results], dtype=np.float64))
    batch_m = batch.classifier.margin(batch.features).double().cpu().numpy()
    batch_p = (batch_m > batch.classifier.margin_threshold).astype(np.float64)
    thr = batch.classifier.margin_threshold
    vs_batch = differing_rows(runs["mega"][0], runs["mega"][1], batch_p, batch_m, thr,
                              "mega service vs batch load_clf=")
    vs_fused = differing_rows(runs["mega"][0], runs["mega"][1], *runs["fused"], thr,
                              "mega service vs fused service")
    vs_cpu = differing_rows(runs["mega"][0], runs["mega"][1], *runs["cpu"], thr,
                            "mega service on the card vs on the CPU")
    stats_equal_batch = str(served) == str(batch_stats)
    stats_equal_cpu = str(served) == str(cpu_served)
    emit("serve_parity", statistics_equal_batch=stats_equal_batch,
         statistics_equal_cpu_serve=stats_equal_cpu,
         max_margin_dev_batch=float(np.abs(runs["mega"][1] - batch_m).max()),
         max_margin_dev_fused=float(np.abs(runs["mega"][1] - runs["fused"][1]).max()),
         max_margin_dev_cpu=float(np.abs(runs["mega"][1] - runs["cpu"][1]).max()),
         near_threshold_rows_batch=vs_batch, near_threshold_rows_fused=vs_fused,
         near_threshold_rows_cpu=vs_cpu)
    if (not stats_equal_batch and not vs_batch) or (not stats_equal_cpu and not vs_cpu):
        raise AssertionError("serve=true statistics differ with no near-threshold row")

    # one full batch through the mega rung, step by step (medians of 25)
    with InferenceService.from_saved("logreg", model) as svc:
        eng = svc.engine
        batch_w, res_np = windows[:64], resolutions[0]
        res_t = torch.from_numpy(res_np).to(eng.device)

        def host_ms(fn, runs=25):
            times = []
            for _ in range(runs):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return pystats.median(times)

        stream = serve_mega.stage_mega_stream(batch_w, 3, 850, eng._mega_stride, eng.capacity)
        staged = torch.from_numpy(stream).to(eng.device)
        weights = eng._model.weights
        margins = eng._mega_program(staged, res_t, weights)
        split = {
            "host_staging_ms": host_ms(lambda: serve_mega.stage_mega_stream(
                batch_w, 3, 850, eng._mega_stride, eng.capacity)),
            "h2d_ms": host_ms(lambda: torch.from_numpy(stream).to(eng.device)),
            "kernel_call_ms": host_ms(lambda: eng._mega_program(staged, res_t, weights)),
            "margin_sync_ms": host_ms(lambda: margins.cpu()),
            "engine_execute_ms": host_ms(lambda: eng.execute(batch_w, res_np)),
        }
    emit("serve_split", batch=64, **split)

    # 16 callers at once, one blocking request each at a time
    n_probe = 480
    rows = [i % len(windows) for i in range(n_probe)]
    with InferenceService.from_saved("logreg", model) as svc:
        with ThreadPoolExecutor(16) as pool:
            probe = list(pool.map(lambda r: svc.predict_window(windows[r], resolutions[r]),
                                  rows))
    pblock = svc.stats_block()
    probe_ok = [r.prediction for r in probe] == list(runs["mega"][0][rows])
    emit("serve_probe_16_threads", requests=n_probe,
         completed=pblock["requests"]["completed"], batches=pblock["batches"],
         mean_batch_size=pblock["mean_batch_size"], latency_ms=pblock["latency_ms"],
         predictions_equal=probe_ok)
    if pblock["requests"]["completed"] != n_probe or not probe_ok:
        raise AssertionError("the 16-thread probe lost requests or changed predictions")
    return launches, windows, resolutions, targets, str(served), block["latency_ms"]


def adapt_split(rec):
    """Per-batch medians (ms) of the adapter's featurize, SGD chunk and
    checkpoint steps, from the ``serve.adapt_chunk`` events in ``rec``."""
    chunks = [e["attrs"] for e in rec.recent_events() if e["name"] == "serve.adapt_chunk"]
    split = {f"{k}_median_ms": (pystats.median(c[f"{k}_s"] for c in chunks) * 1e3
                                if chunks else None)
             for k in ("featurize", "chunk", "checkpoint")}
    return len(chunks), split


def resolution_runs(resolutions, batch):
    """Featurize calls the adapter makes over a feedback stream: one per
    run of equal resolutions within each batch of ``batch``."""
    calls = 0
    for i in range(0, len(resolutions), batch):
        part = resolutions[i:i + batch]
        calls += 1 + sum(1 for a, b in zip(part, part[1:]) if not (a == b).all())
    return calls


def phase_lifecycle(torch, np, info, model, kept, windows, resolutions, targets, work,
                    plain_stats, plain_latency):
    """Phase 5c, the serving lifecycle on the card: (1)
    ``serve=true&adapt=true&swap_gate=off`` at the JAX package's defaults,
    checkpointing every feedback batch: statistics equal to the plain
    serve run's, K1's launches over the adapt stage (one per featurize
    call) and K5's over serving, the lifecycle block's counts and the
    adapt stage's wall split per batch; (2) a permissive-gate service
    fed the session twice (the first pass while the session is served
    again, for latency with the adapter busy): at least one swap, no
    library built, the mega program unchanged, and predictions served
    after the swap equal to the card's batch ``load_clf=`` run of
    ``promoted.npz`` (a row may differ only within MARGIN_BAND of the
    threshold on both) and bit for bit to a fresh engine around it; (3)
    an adapter abandoned after its 3rd checkpoint and resumed over the
    same directory ends at candidate weights byte-equal to an
    uninterrupted twin's. Returns K1's and K5's launches over the gate-off
    run's adapt and serve stages."""
    import contextlib

    from eeg_dataanalysispackage_tpu_torch.obs import events
    from eeg_dataanalysispackage_tpu_torch.ops import cuda_build, ingest_cuda, serve_mega_cuda
    from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
    from eeg_dataanalysispackage_tpu_torch.serve import (
        InferenceService, LifecycleConfig, LifecycleManager, ServingEngine,
    )

    class StageCounted(PipelineBuilder):
        """K1's and K5's launches within each stage of the run."""

        stage_launches = {}

        @contextlib.contextmanager
        def _stage(self, name):
            before = (ingest_cuda.LAUNCHES, serve_mega_cuda.LAUNCHES)
            with super()._stage(name):
                yield
            self.stage_launches[name] = (ingest_cuda.LAUNCHES - before[0],
                                         serve_mega_cuda.LAUNCHES - before[1])

    t_phase = time.perf_counter()
    base = f"info_file={info}&fe=dwt-8-fused&load_clf=logreg&load_name={model}"
    ck_off = os.path.join(work, "lifecycle_off")
    ingest_cuda.LAUNCHES = 0
    serve_mega_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    with events.recording(events.SpanRecorder("lifecycle", ring_capacity=65536)) as rec:
        off = StageCounted(base + f"&serve=true&adapt=true&swap_gate=off&checkpoint_path={ck_off}")
        off_stats = off.execute()
    wall = time.perf_counter() - t0
    k1_adapt, _ = off.stage_launches["adapt"]
    _, k5_serve = off.stage_launches["serve"]
    block = off.serve_block["lifecycle"]
    n_chunks, split = adapt_split(rec)
    expected_k1 = resolution_runs(resolutions, 16)
    fb = block["feedback"]
    emit("lifecycle_gate_off", statistics_equal_plain_serve=str(off_stats) == plain_stats,
         k1_launches_adapt=k1_adapt, k1_launches_expected=expected_k1,
         k5_launches_serve=k5_serve, feedback=fb, swaps=block["swaps"],
         candidate=block["candidate"], checkpoint=block["checkpoint"],
         adapt_stage_s=off.timers["adapt"], serve_stage_s=off.timers["serve"],
         batches_timed=n_chunks, wall_s=wall, **split)
    if not (str(off_stats) == plain_stats and fb["received"] == kept and fb["failures"] == 0
            and fb["batches"] == fb["chunks"] == n_chunks == math.ceil(kept / 16)
            and k1_adapt == expected_k1 and k5_serve >= math.ceil(kept / 64)
            and block["swaps"] == 0 and block["checkpoint"]["steps"] <= 2):
        raise AssertionError("adapt=true&swap_gate=off did not serve, adapt and checkpoint "
                             "as the plain run")

    # 2. promotion behind a permissive gate
    ck_on = os.path.join(work, "lifecycle_on")
    svc = InferenceService.from_saved("logreg", model, lifecycle=LifecycleConfig(
        gate_ratio=100.0, checkpoint_dir=ck_on, rollback=False))
    program, loaded = svc.engine._mega_program, dict(cuda_build._LOADED)
    logs = dict(cuda_build.BUILD_LOGS)
    with svc:
        for w, r, y in zip(windows, resolutions, targets):
            svc.feedback(w, r, y)
        svc.predict_all(windows, resolutions)  # served while the adapter trains
        busy_latency = svc.stats_block()["latency_ms"]
        if not svc.lifecycle.flush(timeout_s=300.0):
            raise AssertionError("the adapter did not go idle")
        for w, r, y in zip(windows, resolutions, targets):
            svc.feedback(w, r, y)
        if not svc.lifecycle.flush(timeout_s=300.0):
            raise AssertionError("the adapter did not go idle")
        after = svc.predict_all(windows, resolutions)
        pblock = svc.lifecycle.block()
        built = dict(cuda_build._LOADED) != loaded or dict(cuda_build.BUILD_LOGS) != logs
        same_program = svc.engine._mega_program is program
    served_p = np.array([r.prediction for r in after])
    served_m = np.array([r.margin for r in after], dtype=np.float64)
    promoted = pblock["promoted_path"]
    batch = PipelineBuilder(base.replace(f"load_name={model}", f"load_name={promoted}"))
    batch.execute()
    batch_m = batch.classifier.margin(batch.features).double().cpu().numpy()
    thr = batch.classifier.margin_threshold
    batch_p = (batch_m > thr).astype(np.float64)
    near = differing_rows(served_p, served_m, batch_p, batch_m, thr,
                          "served after the swap vs the batch run of promoted.npz")
    fresh = InferenceService.from_saved("logreg", promoted)
    with fresh:
        fresh_m = np.array([r.margin for r in fresh.predict_all(windows, resolutions)],
                           dtype=np.float64)
    emit("lifecycle_promotion", swaps=pblock["swaps"], generation=pblock["generation"],
         feedback=pblock["feedback"], gate=pblock["gate"], library_built=built,
         mega_program_unchanged=same_program, rows=kept,
         near_threshold_rows_batch=near, equal_batch_promoted=not near,
         bit_equal_fresh_engine=served_m.tobytes() == fresh_m.tobytes(),
         latency_ms_adapter_busy=busy_latency, latency_ms_phase5=plain_latency)
    if not (pblock["swaps"] >= 1 and not built and same_program
            and served_m.tobytes() == fresh_m.tobytes() and pblock["feedback"]["failures"] == 0):
        raise AssertionError("the lifecycle's promotion did not hold on the card")

    # 3. resume: an adapter abandoned after its 3rd checkpoint, resumed
    # over the same directory, ends where an uninterrupted twin does
    eng = ServingEngine(svc.engine.classifier, capacity=64)
    eng.warmup()
    stream = list(zip(windows[:96], resolutions[:96], targets[:96]))

    def adapter(directory):
        return LifecycleManager(eng, LifecycleConfig(
            gate_mode="off", gate_ratio=None, checkpoint_dir=directory)).start()

    def feed(lc, start, stop):
        for b in range(start, stop):
            for w, r, y in stream[16 * b:16 * (b + 1)]:
                lc.feedback(w, r, y)
            if not lc.flush(timeout_s=120.0):
                raise AssertionError("the adapter did not go idle")

    twin = adapter(os.path.join(work, "resume_twin"))
    feed(twin, 0, 6)
    twin.close()
    victim_dir = os.path.join(work, "resume_victim")
    victim = adapter(victim_dir)
    feed(victim, 0, 3)
    victim.close(flush=False)  # abandoned after its 3rd checkpoint
    resumed = adapter(victim_dir)
    resumed_at = resumed.batches_trained
    feed(resumed, resumed_at, 6)
    resumed.close()
    equal = resumed.candidate.w.tobytes() == twin.candidate.w.tobytes()
    emit("lifecycle_resume", resumed_at_batch=resumed_at, batches=6,
         weights_byte_equal=equal, candidate_t=int(resumed.candidate.t),
         phase_seconds=time.perf_counter() - t_phase)
    if not (resumed_at == 3 and equal):
        raise AssertionError("the resumed candidate is not the uninterrupted twin's")
    return k1_adapt, k5_serve


def contraction_library_ms(torch, dwt, dev, n, smi):
    """``library_ms`` of the 512/16 kernels: one ``torch.matmul`` of
    ``n`` windows x 3 channels of centred float32 windows (n * 3, 512)
    with the (512, 16) operator, TF32 off: the contraction alone, without
    the staging, centring, normalize or quantize the kernels also do
    (event time, median of 25, and its GEMM's device time)."""
    gen = torch.Generator(device=dev).manual_seed(n + 7)
    Z = torch.randn((n * 3, 512), generator=gen, device=dev) * 40.0
    Z = Z - Z.mean(dim=1, keepdim=True)
    W = dwt.kernel_operator(8, 512, 16, dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        library_ms = time_ms(lambda: torch.matmul(Z, W))
        library_device_ms = profiled_device_ms(lambda: torch.matmul(Z, W), "gemm")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    emit("timing", kernel="library_contraction_512x16", windows=n, library_ms=library_ms,
         library_device_ms=library_device_ms,
         library="torch.matmul of the centred windows with W, TF32 off (contraction only)",
         nvidia_smi=smi)
    return library_ms


def phase_serve_precisions(np, info, model, kept, windows, resolutions):
    """serve=true&precision=int8|int4|bf16 on the card: int8 and int4 on
    the mega rung through their megakernel instantiations, bf16 on the
    fused rung through K2-bf16; every kept epoch completed; statistics
    equal to the card's batch load_clf= run at the same precision (a row
    may differ only within MARGIN_BAND of the threshold on both).
    Returns {precision: launches of the serving kernel}."""
    from eeg_dataanalysispackage_tpu_torch.ops import ingest_cuda, serve_mega_cuda
    from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
    from eeg_dataanalysispackage_tpu_torch.serve import InferenceService

    counters = {f"ingest_features_{p}": (ingest_cuda, f"LAUNCHES_{p.upper()}")
                for p in ("bf16", "int8", "int4")}
    counters.update({"ingest_features": (ingest_cuda, "LAUNCHES"),
                     "serve_mega": (serve_mega_cuda, "LAUNCHES"),
                     "serve_mega_int8": (serve_mega_cuda, "LAUNCHES_INT8"),
                     "serve_mega_int4": (serve_mega_cuda, "LAUNCHES_INT4")})
    served_launches = {}
    for precision in ("int8", "int4", "bf16"):
        base = (f"info_file={info}&fe=dwt-8-fused&load_clf=logreg&load_name={model}"
                f"&precision={precision}")
        batch = PipelineBuilder(base)
        batch_stats = batch.execute()
        for module, attr in counters.values():
            setattr(module, attr, 0)
        served_builder = PipelineBuilder(base + "&serve=true")
        served = served_builder.execute()
        counts = {k: getattr(m, a) for k, (m, a) in counters.items()}
        block = served_builder.serve_block
        req = block["requests"]
        kernel = "ingest_features_bf16" if precision == "bf16" else f"serve_mega_{precision}"
        rung = "fused" if precision == "bf16" else "mega"
        rows = []
        if str(served) != str(batch_stats):
            with InferenceService.from_saved("logreg", model, precision=precision) as svc:
                results = svc.predict_all(windows, resolutions)
            thr = batch.classifier.margin_threshold
            batch_m = batch.classifier.margin(batch.features).double().cpu().numpy()
            rows = differing_rows(np.array([r.prediction for r in results]),
                                  np.array([r.margin for r in results], dtype=np.float64),
                                  (batch_m > thr).astype(np.float64), batch_m, thr,
                                  f"serve precision={precision} vs batch")
            if not rows:
                raise AssertionError(f"serve precision={precision}: statistics differ with "
                                     "no near-threshold row")
        emit("serve_precision", precision=precision, rung=block["rung"],
             precision_record=block["precision"], mega=block["mega"], launches=counts,
             stages_s=served_builder.timers, mean_batch_size=block["mean_batch_size"],
             completed=req["completed"], shed=req["shed"], batches=block["batches"],
             latency_ms=block["latency_ms"], statistics_equal_batch=not rows,
             near_threshold_rows_batch=rows, drained_cleanly=block["drained_cleanly"])
        mega_ok = (block["mega"] is None if precision == "bf16"
                   else block["mega"]["precision"] == precision and block["mega"]["gate"]["ok"])
        if not (block["rung"] == rung and mega_ok
                and block["precision"]["used"] == precision
                and counts[kernel] >= math.ceil(kept / 64) and req["completed"] == kept
                and req["shed"] == 0 and block["drained_cleanly"] is True):
            raise AssertionError(f"serve precision={precision} did not serve through {kernel}")
        served_launches[precision] = counts[kernel]
    return served_launches


def perturbed_tenant(np, base, seed):
    """The saved model with its weights and intercept perturbed from
    ``seed`` (numpy), as a port classifier."""
    from eeg_dataanalysispackage_tpu_torch.models import registry

    rng = np.random.default_rng(seed)
    state = base.to_numpy_state()
    state["weights"] = (state["weights"] + rng.standard_normal(48).astype(np.float32)
                        * 0.05).astype(np.float32)
    state["intercept"] = float(rng.standard_normal() * 0.01)
    clf = registry.create("logreg")
    clf.from_numpy_state(state)
    return clf


def phase_multi_service(torch, np, info, model, kept, windows, resolutions):
    """The multi-tenant service on the card: 128 tenants (tenant 0 the
    saved model, the rest perturbed from it) serve the kept windows with
    tenants interleaved; while the first half is in flight a tenant is
    swapped, one removed and one added, with no library built and the
    program object unchanged; 8 tenants' rows equal a solo mega service
    bit for bit; tenant 0 over every kept window has the card's batch
    load_clf= statistics (a row may differ only within MARGIN_BAND of
    the threshold on both); a quota shed probe. Returns K6's launches
    over the run."""
    from eeg_dataanalysispackage_tpu_torch.models import registry, stats
    from eeg_dataanalysispackage_tpu_torch.ops import (
        cuda_build, ingest_cuda, serve_mega, serve_mega_cuda,
    )
    from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
    from eeg_dataanalysispackage_tpu_torch.serve import (
        InferenceService, MultiplexedService, RequestFailedError, ServeConfig, ShedError,
    )
    from eeg_dataanalysispackage_tpu_torch.utils import java_compat

    base = registry.create("logreg")
    base.load(model)
    names = [f"t{i:03d}" for i in range(128)]
    tenants = {names[0]: base}
    tenants.update({name: perturbed_tenant(np, base, i) for i, name in enumerate(names)
                    if i})
    n = len(windows)
    mix = [names[i % 128] for i in range(n)]
    half = n // 2
    counters = {"serve_mega_multi": (serve_mega_cuda, "MULTI_LAUNCHES"),
                "serve_mega": (serve_mega_cuda, "LAUNCHES"),
                "ingest_features": (ingest_cuda, "LAUNCHES")}
    for module, attr in counters.values():
        setattr(module, attr, 0)
    t0 = time.perf_counter()
    svc = MultiplexedService(tenants)
    with svc:
        program, loaded = svc.engine._mega_program, dict(cuda_build._LOADED)
        logs = dict(cuda_build.BUILD_LOGS)
        budget = svc.config.default_deadline_s
        first = [svc.submit(w, r, tenant=t, deadline_s=budget, block_s=budget)
                 for w, r, t in zip(windows[:half], resolutions[:half], mix[:half])]
        swapped = perturbed_tenant(np, base, 1005)
        svc.swap_tenant("t005", swapped)
        svc.remove_tenant("t006")
        lane_new = svc.add_tenant("newcomer", perturbed_tenant(np, base, 1006))
        second_mix = ["newcomer" if t == "t006" else t for t in mix[half:]]
        second = svc.predict_all(windows[half:], resolutions[half:], second_mix)
        results = []
        for f, tenant in zip(first, mix[:half]):
            try:
                results.append(f.result(timeout=budget + 30.0))
            except RequestFailedError as e:
                # t006's requests still queued at its removal fail alone
                if tenant != "t006" or "was removed" not in str(e):
                    raise
                results.append(None)
        removed_failed = results.count(None)
        results += second
        admin_built = dict(cuda_build._LOADED) != loaded or dict(cuda_build.BUILD_LOGS) != logs
        same_program = svc.engine._mega_program is program
        t0_results = svc.predict_all(windows, resolutions, "t000")
        block = svc.stats_block()
    wall = time.perf_counter() - t0
    launches = {k: getattr(m, a) for k, (m, a) in counters.items()}
    checked = ["t000", "t001", "t002", "t003", "t063", "t064", "t100", "t127"]
    bit_equal = {}
    for name in checked:
        rows = [i for i, t in enumerate(mix) if t == name]
        with InferenceService(tenants[name]) as solo:
            alone = solo.predict_all([windows[i] for i in rows], [resolutions[i] for i in rows])
        bit_equal[name] = (solo.engine.rung == "mega"
                           and [results[i].margin for i in rows] == [r.margin for r in alone]
                           and [results[i].prediction for i in rows]
                           == [r.prediction for r in alone])
    batch = PipelineBuilder(f"info_file={info}&fe=dwt-8-fused&load_clf=logreg"
                            f"&load_name={model}")
    batch_stats = batch.execute()
    t0_pred = np.array([r.prediction for r in t0_results], dtype=np.float64)
    perm = java_compat.java_shuffle_indices(n, seed=1)
    t0_stats = stats.ClassificationStatistics.from_arrays(
        t0_pred[perm], np.asarray(batch.targets)[perm], confusion_only=base.confusion_only_stats)
    rows = []
    if str(t0_stats) != str(batch_stats):
        thr = base.margin_threshold
        batch_m = base.margin(batch.features).double().cpu().numpy()
        rows = differing_rows(t0_pred, np.array([r.margin for r in t0_results], np.float64),
                              (batch_m > thr).astype(np.float64), batch_m, thr,
                              "tenant 0 vs batch load_clf=")
        if not rows:
            raise AssertionError("tenant 0's statistics differ with no near-threshold row")
    # one full mixed batch through the mega rung, step by step (medians
    # of 25): the lanes' copy beside the stream's
    eng = svc.engine
    batch_w, res_np = windows[:64], resolutions[0]
    batch_t = ["newcomer" if t == "t006" else t for t in mix[:64]]
    res_t = torch.from_numpy(res_np).to(eng.device)
    stack, lanes = eng._resolve(batch_t, 64)
    lanes_host = eng._capacity_lanes(lanes)
    stream = serve_mega.stage_mega_stream(batch_w, 3, 850, eng._mega_stride, eng.capacity)
    staged = torch.from_numpy(stream).to(eng.device)
    margins = eng._mega_program(staged, res_t, stack.weights, lanes_host)

    def host_ms(fn, runs=25):
        times = []
        for _ in range(runs):
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        return pystats.median(times)

    split = {
        "host_staging_ms": host_ms(lambda: serve_mega.stage_mega_stream(
            batch_w, 3, 850, eng._mega_stride, eng.capacity)),
        "h2d_stream_ms": host_ms(lambda: torch.from_numpy(stream).to(eng.device)),
        "h2d_lanes_ms": host_ms(lambda: lanes_host.to(eng.device)),
        "kernel_call_ms": host_ms(lambda: eng._mega_program(staged, res_t, stack.weights,
                                                            lanes_host)),
        "margin_sync_ms": host_ms(lambda: margins.cpu()),
        "engine_execute_ms": host_ms(lambda: eng.execute(batch_w, res_np, batch_t)),
    }
    emit("serve_split_multitenant", batch=64, tenants_in_batch=len(set(batch_t)),
         kernel_call_includes="the lanes' copy", **split)

    # a per-tenant quota shed probe: the queue only fills, nothing runs
    probe = MultiplexedService({"a": base, "b": tenants["t001"]},
                               config=ServeConfig(max_batch=16, tenant_quota=2))
    probe._accepting = True
    for _ in range(2):
        probe.submit(windows[0], resolutions[0], tenant="a")
    try:
        probe.submit(windows[0], resolutions[0], tenant="a")
        evidence = None
    except ShedError as e:
        evidence = e.evidence
    probe.submit(windows[0], resolutions[0], tenant="b")
    probe._accepting = False
    req = block["requests"]
    emit("serve_multitenant", tenants=128, rung=block["rung"], launches=launches, kept=kept,
         requests=len(results) + n, completed=req["completed"], shed=req["shed"],
         failed=req["failed"], removed_tenant_requests_failed=removed_failed,
         batches=block["batches"],
         mean_batch_size=block["mean_batch_size"], latency_ms=block["latency_ms"],
         mega_gate=block["mega"]["gate"], wall_s=wall, admin_built_nothing=not admin_built,
         program_unchanged=same_program, new_tenant_lane=lane_new,
         swapped_generation=block["tenants"]["t005"]["generation"],
         rows_equal_solo_mega=bit_equal, tenant0_statistics_equal_batch=not rows,
         tenant0_near_threshold_rows=rows, shed_probe_evidence=evidence,
         resident_weight_bytes=block["resident_weight_bytes"])
    if not (block["rung"] == "mega" and all(bit_equal.values()) and not admin_built
            and same_program and lane_new == 6
            and req["completed"] == len(results) + n - removed_failed
            and req["failed"] == removed_failed and req["shed"] == 0
            and launches["serve_mega_multi"] >= 2 * math.ceil(n / 64)
            and launches["serve_mega"] == 0
            and evidence is not None and evidence["reason"] == "tenant_quota"
            and evidence["tenant"] == "a" and evidence["tenant_depth"] == 2):
        raise AssertionError("the multi-tenant service did not serve as the solo services")
    return launches["serve_mega_multi"]


def phase_f32_stream_cases(torch, np, ingest_cuda, device_ingest, W, dev):
    """The fused ingest kernel's float32-sample instantiation against its
    plain version: random and DC-heavy float32 streams (unit
    resolutions, as a non-INT_16 recording is staged), with windows
    overhanging the end. The baseline mean is not exact in float64 for
    float samples, so the tolerance stays KERNEL_TOL, not bit equality."""
    rng = np.random.RandomState(7)
    S = 200_000
    res = torch.ones(3, dtype=torch.float32, device=dev)
    cases = {
        "f32_random": ((0.0, 0.0, 0.0), 300.0, np.sort(rng.randint(0, S - 787, size=500))),
        "f32_dc_heavy": ((3000.0, -3000.0, 2950.5), 150.0, 1000 * np.arange(150)),
        "f32_overhang": ((0.0, 0.0, 0.0), 300.0, np.array([10, S - 300, S - 686, S - 1, S])),
        # every sample offset within a 16-byte chunk (4 float32 samples)
        "f32_chunk_offsets": ((1000.0, -800.0, 20.0), 300.0,
                              np.concatenate([b + np.arange(8) for b in (0, 77777, S - 800)])),
        # negative starts and the end, on rows that are not 16-byte aligned
        "f32_edges_unaligned": ((0.0, 0.0, 0.0), 300.0, np.array(
            [-900, -787, -612, -100, -3, -1, 0, 1, S - 786, S - 611, S - 300, S - 1, S + 1,
             S + 9])),
    }
    worst = 0.0
    for name, (dc, noise, starts_np) in cases.items():
        length = S + 1 if name.endswith("unaligned") else S
        x = rng.randn(3, length) * noise + np.asarray(dc)[:, None]
        raw = torch.from_numpy(x.astype(np.float32)).to(dev)
        starts = torch.from_numpy(starts_np.astype(np.int32)).to(dev)
        got = ingest_cuda.ingest_features(raw, res, starts, W)
        torch.cuda.synchronize()
        want = device_ingest.ingest_features_plain(raw, res, starts, W)
        err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        end_zero = bool((got[torch.from_numpy(starts_np >= length).to(dev)] == 0).all())
        emit("kernel_vs_plain", kernel="ingest_features_f32", case=name,
             windows=int(len(starts_np)), samples=length, max_abs_err=err, tol=KERNEL_TOL,
             finite=finite, end_rows_zero=end_zero)
        if not (err <= KERNEL_TOL and finite and end_zero and got.shape == (len(starts_np), 48)):
            raise AssertionError(f"float32 ingest kernel disagrees with its plain version on {name}")
        worst = max(worst, err)
    return worst


def random_epochs(np, B, seed, C=3, T=750, dc=300.0, noise=40.0):
    """(B, C, T) float32 epochs: noise around a per-epoch DC offset."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, C, T) * noise + rng.randn(B, C, 1) * dc).astype(np.float32)


# (epoch_size, feature_size, skip) off the main path: sizes the reference's
# setters allow, up to the most coefficients a 750-sample window has
EPOCH_SIZES = ((256, 16, 175), (512, 64, 175), (750, 32, 0), (333, 20, 0), (16, 16, 0),
               (1, 1, 0), (750, 745, 0))


def epoch_case(torch, dwt, dwt_cuda, name, xt, sizes=(175, 512, 16), zero_row=None):
    """One epoch-features case on the card: kernel against plain version;
    returns the deviation and the kernel's rows."""
    skip, n, K = sizes
    got = dwt_cuda.epoch_features_cuda(xt, 8, skip, n, K)
    torch.cuda.synchronize()
    want = dwt.epoch_features(xt, 8, skip, n, K)
    err = (got - want).abs().max().item()
    finite = bool(torch.isfinite(got).all())
    zero = zero_row is None or bool((got[zero_row] == 0).all())
    B, C = int(xt.shape[0]), int(xt.shape[1])
    emit("kernel_vs_plain", kernel="epoch_features", case=name, epochs=B, channels=C,
         length=int(xt.shape[2]), skip=skip, epoch_size=n, feature_size=K, max_abs_err=err,
         tol=KERNEL_TOL, finite=finite, zero_row_exact=zero)
    if not (err <= KERNEL_TOL and finite and zero and got.shape == (B, C * K)):
        raise AssertionError(f"epoch-features kernel disagrees with its plain version on {name}")
    return err, got


def phase_epoch_cases(torch, np, dwt, dwt_cuda, wavelet, dev):
    """The epoch-features kernel against its plain version on the card:
    B = 1, 5, 37, 128, 641, 1,494 and 32,768; DC-heavy epochs; an all-zero
    epoch (an exactly zero row); windows at every 4-byte offset within a
    16-byte chunk (T = 750, 749, 751, 753, skip 1-8 and 175), each on an
    aligned tensor and on one whose first byte is not (rows bit-equal);
    sizes off the main path at 1, 3, 5 and 64 channels; 5-channel input
    reduced to 3 by the extractor's host gather; a window that does not
    fit and a coefficient count past the cascade's columns raising."""
    cases = {f"B{B}": random_epochs(np, B, seed=B) for B in (1, 5, 37, 128, 641, 1494, 32_768)}
    cases["dc_heavy"] = random_epochs(np, 300, seed=3, dc=3000.0, noise=15.0) + np.float32(2500.0)
    with_zero = random_epochs(np, 9, seed=4)
    with_zero[4] = 0.0
    cases["all_zero_epoch"] = with_zero
    worst = 0.0
    for name, x in cases.items():
        err, _ = epoch_case(torch, dwt, dwt_cuda, name, torch.from_numpy(x).to(dev),
                            zero_row=4 if name == "all_zero_epoch" else None)
        worst = max(worst, err)
    # every offset of a row's window within a chunk, on an aligned tensor
    # and on one that starts 4 bytes past a boundary
    for T in (750, 749, 751, 753):
        for skip in (1, 2, 3, 4, 5, 6, 7, 8, 175):
            x = random_epochs(np, 37, seed=T + skip, T=T)
            flat = torch.zeros(x.size + 1, device=dev)
            flat[1:] = torch.from_numpy(x.reshape(-1)).to(dev)
            rows = []
            for label, xt in (("aligned", torch.from_numpy(x).to(dev)),
                              ("first_byte_misaligned", flat[1:].view(x.shape))):
                err, got = epoch_case(torch, dwt, dwt_cuda, f"T{T}_skip{skip}_{label}", xt,
                                      sizes=(skip, 512, 16))
                worst = max(worst, err)
                rows.append(got)
            if not torch.equal(rows[0], rows[1]):
                raise AssertionError(f"T{T} skip {skip}: rows depend on the tensor's alignment")
    # other sizes, at 1, 3, 5 and 64 channels, each with an all-zero epoch
    for n, K, skip in EPOCH_SIZES:
        for C in (1, 3, 5, 64):
            x = random_epochs(np, 37, seed=n + K + C, C=C)
            x[11] = 0.0
            err, _ = epoch_case(torch, dwt, dwt_cuda, f"n{n}_K{K}_C{C}",
                                torch.from_numpy(x).to(dev), sizes=(skip, n, K), zero_row=11)
            worst = max(worst, err)
    # 5 channels in, the configured (1, 2, 3) out: the gather is the host's
    five = random_epochs(np, 64, seed=5, C=5).astype(np.float64)
    fe = wavelet.WaveletTransform(backend="pallas", device=dev)
    got = fe.extract_batch(five)
    torch.cuda.synchronize()
    want = dwt.epoch_features(torch.from_numpy(five[:, :3].astype(np.float32)).to(dev))
    err = (got - want).abs().max().item()
    emit("kernel_vs_plain", kernel="epoch_features", case="five_channels_select_three",
         epochs=64, max_abs_err=err, tol=KERNEL_TOL, shape=list(got.shape))
    if not (err <= KERNEL_TOL and got.shape == (64, 48)):
        raise AssertionError("epoch-features kernel disagrees on 5-channel input")
    worst = max(worst, err)
    before = dwt_cuda.LAUNCHES
    for label, call, text in (
        ("window_validation", lambda: dwt_cuda.epoch_features_cuda(
            torch.zeros((2, 3, 600), device=dev)), "exceeds epoch length"),
        ("past_the_cascade_columns", lambda: dwt_cuda.epoch_features_cuda(
            torch.zeros((2, 3, 750), device=dev), 8, 0, 128, 200), "exceeds the 128 coefficients"),
    ):
        try:
            call()
        except ValueError as e:
            if text not in str(e):
                raise
            emit("kernel_vs_plain", kernel="epoch_features", case=label, raised=str(e))
        else:
            raise AssertionError(f"{label}: the wrapper did not raise")
    if dwt_cuda.LAUNCHES != before:
        raise AssertionError("a refused epoch-features call launched the kernel")
    return worst


def test_features(builder):
    """A run's test rows on its device: the fused run's kept feature rows,
    or the host run's test epochs featurized again by its extractor."""
    import torch

    if builder.features is not None:
        idx = torch.as_tensor(builder.test_index, device=builder.features.device)
        return builder.features[idx]
    return builder.fe.extract_batch(builder.batch.epochs[builder.test_index])


def margins_on_test_rows(builder):
    """(n_test,) float64 margins of a run's classifier on its test rows."""
    return builder.classifier.margin(test_features(builder)).double().cpu().numpy()


def run_builder(label, query, device, counters):
    """One builder run with every named launch counter set to 0 just
    before it; returns (builder, statistics, {counter: launches})."""
    from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

    for module, attr in counters.values():
        setattr(module, attr, 0)
    t0 = time.perf_counter()
    builder = PipelineBuilder(query, device=device)
    stats = builder.execute()
    wall = time.perf_counter() - t0
    launches = {k: getattr(m, a) for k, (m, a) in counters.items()}
    accuracy = (stats.calc_accuracy() if hasattr(stats, "calc_accuracy")
                else {name: leg.calc_accuracy() for name, leg in stats.items()})
    emit("e2e", run=label, device=str(builder.device), launches=launches,
         rows=None if builder.targets is None else int(len(builder.targets)), accuracy=accuracy,
         wall_s=wall, stages_s=builder.timers)
    return builder, stats, launches


def host_features_vs_plain(np, gpu, cpu, label):
    """A -pallas run's own train and test epochs through its extractor
    on the card, i.e. the epoch-features kernel at the shapes the run
    gave it, held against the plain version on the same float32 tensor
    and against the CPU run's extractor on the CPU run's epochs; returns
    the larger deviation. Called after the run's counts are read."""
    import torch

    from eeg_dataanalysispackage_tpu_torch.ops import dwt
    from eeg_dataanalysispackage_tpu_torch.utils import java_compat

    if gpu.batch.epochs.tobytes() != cpu.batch.epochs.tobytes():
        raise AssertionError(f"{label}: host epochs differ between the card and CPU runs")
    train_idx, _ = java_compat.train_test_split_indices(len(gpu.targets), seed=1)
    worst = 0.0
    for part, rows in (("train", train_idx), ("test", gpu.test_index)):
        rows = np.asarray(rows, dtype=np.int64)
        ep = gpu.batch.epochs[rows]
        if ep.shape[1:] != (3, 750):
            raise AssertionError(f"{label}: host epochs of shape {ep.shape}, not (n, 3, 750)")
        got = gpu.fe.extract_batch(ep)
        torch.cuda.synchronize()
        want = dwt.epoch_features(torch.from_numpy(ep.astype(np.float32)).to(got.device))
        on_cpu = cpu.fe.extract_batch(cpu.batch.epochs[rows])
        err_plain = (got - want).abs().max().item()
        err_cpu = (got.cpu() - on_cpu).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        emit("host_features_vs_plain", run=label, part=part, epochs=list(ep.shape),
             device=str(got.device), max_abs_err_plain=err_plain, max_abs_err_cpu=err_cpu,
             tol=KERNEL_TOL, finite=finite)
        if not (got.device.type == "cuda" and got.shape == (len(rows), 48) and finite
                and err_plain <= KERNEL_TOL and err_cpu <= KERNEL_TOL):
            raise AssertionError(f"{label}: {part} features disagree with the plain version")
        worst = max(worst, err_plain, err_cpu)
    return worst


def phase_host_path(np, info, counters):
    """The host fe= path on the card and the CPU: -pallas with logreg
    and svm, the host-float64 fe=dwt-8 and the on-card contraction
    -tpu, each against the port's CPU run; the -pallas logreg run's
    features against the plain version. Returns the epoch-features
    kernel's launches over the -pallas logreg run, the features'
    largest deviation and the -pallas logreg run's builder."""
    runs = {}
    feat_err = None
    for fe in ("dwt-8-pallas", "dwt-8", "dwt-8-tpu"):
        for clf in (("logreg", "svm") if fe == "dwt-8-pallas" else ("logreg",)):
            q = f"info_file={info}&fe={fe}&train_clf={clf}"
            gpu = run_builder(f"{fe}_{clf}_cuda", q, None, counters)
            cpu = run_builder(f"{fe}_{clf}_cpu", q, "cpu", counters)
            if gpu[0].device.type != "cuda" or gpu[2]["ingest_features"] != 0:
                raise AssertionError(f"{fe} {clf}: not a host-epoch run on the card")
            if cpu[2]["epoch_features"] != 0:
                raise AssertionError(f"{fe} {clf}: the kernel launched on the CPU path")
            compare_runs(np, gpu[0], cpu[0], f"{fe}_{clf}")
            if (fe, clf) == ("dwt-8-pallas", "logreg"):
                feat_err = host_features_vs_plain(np, gpu[0], cpu[0], f"{fe}_{clf}")
            runs[(fe, clf)] = gpu
    k4 = runs[("dwt-8-pallas", "logreg")][2]["epoch_features"]
    if k4 != 2:
        raise AssertionError(f"-pallas logreg launched the epoch-features kernel {k4} times, not 2")
    for fe in ("dwt-8", "dwt-8-tpu"):
        if runs[(fe, "logreg")][2]["epoch_features"] != 0:
            raise AssertionError(f"{fe} launched the epoch-features kernel")
    return k4, feat_err, runs[("dwt-8-pallas", "logreg")][0]


def phase_precision_runs(np, info, counters, f32_gpu, n_files):
    """fe=dwt-8-fused&precision=bf16|int8|int4&train_clf=logreg on the card
    and the CPU: the rung used as requested; the gate's f32 and rung
    launches plus one rung launch per recording; features against the
    CPU run's within KERNEL_TOL (int8/int4: except counted boundary flips,
    each one step); statistics under the near-threshold rule. Then an
    int4 run forced to trip its gate (EEG_TPU_INT4_GATE_TOL=1e-9 for that
    run only): f32 used, statistics equal to the card's f32 run. Returns
    {precision: launches of its instantiation}."""
    launches = {}
    for precision in ("bf16", "int8", "int4"):
        q = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&precision={precision}"
        gpu = run_builder(f"logreg_{precision}_cuda", q, None, counters)
        cpu = run_builder(f"logreg_{precision}_cpu", q, "cpu", counters)
        counts, resolved = gpu[2], gpu[0].precision_resolved
        rung = f"ingest_features_{precision}"
        got, want = gpu[0].features.cpu(), cpu[0].features
        if precision == "bf16":
            flips, err = 0, (got - want).abs().max().item()
        else:
            flips, err = flip_check(np, got, want, f32_gpu.features.cpu(), precision,
                                    f"{precision} run")
        emit("precision_run", run=precision, precision_resolved=resolved, launches=counts,
             features_max_abs_err_vs_cpu=err, feature_flips_vs_cpu=flips, tol=KERNEL_TOL)
        others = {k: v for k, v in counts.items() if k not in (rung, "ingest_features")}
        if not (resolved["used"] == precision and counts[rung] == n_files + 1
                and counts["ingest_features"] == 1 and not any(others.values())
                and err <= KERNEL_TOL and got.shape == want.shape):
            raise AssertionError(f"precision={precision}: {resolved} {counts} err {err}")
        compare_runs(np, gpu[0], cpu[0], f"logreg_{precision}")
        launches[precision] = counts[rung]
    os.environ["EEG_TPU_INT4_GATE_TOL"] = "1e-9"
    try:
        q = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&precision=int4"
        tripped = run_builder("logreg_int4_gate_tripped_cuda", q, None, counters)
    finally:
        del os.environ["EEG_TPU_INT4_GATE_TOL"]
    resolved, counts = tripped[0].precision_resolved, tripped[2]
    equal = str(tripped[1]) == str(f32_gpu.statistics)
    emit("precision_gate_tripped", precision_resolved=resolved, launches=counts,
         statistics_equal_f32_run=equal)
    if not (resolved["used"] == "f32" and not resolved["gate"]["ok"] and equal
            and counts["ingest_features"] == n_files + 1
            and counts["ingest_features_int4"] == 1):
        raise AssertionError(f"the tripped int4 gate did not run f32: {resolved} {counts}")
    return launches


def write_float_session(directory: str, n_files: int = 3, n_markers: int = 600) -> str:
    """IEEE_FLOAT_32 recordings (4 channels, Fz/Cz/Pz among them, marker
    stride 1,000) and their info.txt; returns the info.txt path."""
    import numpy as np

    lines = []
    for i in range(n_files):
        name, guessed = f"f32_{i:02d}", 1 + (i * 4) % 9
        rng = np.random.RandomState(500 + i)
        n_samples = 200 + n_markers * 1000 + 900
        x = rng.randn(n_samples, 4) * 30.0 + rng.randn(1, 4) * 500.0
        with open(os.path.join(directory, name + ".eeg"), "wb") as f:
            f.write(x.astype("<f4").tobytes())
        vhdr = ["Brain Vision Data Exchange Header File Version 1.0", "[Common Infos]",
                f"DataFile={name}.eeg", f"MarkerFile={name}.vmrk", "DataFormat=BINARY",
                "DataOrientation=MULTIPLEXED", "NumberOfChannels=4", "SamplingInterval=1000",
                "[Binary Infos]", "BinaryFormat=IEEE_FLOAT_32", "[Channel Infos]"]
        vhdr += [f"Ch{j + 1}={ch},,{res},uV"
                 for j, (ch, res) in enumerate(zip(("Fz", "Cz", "Pz", "Oz"), (1, 0.5, 1, 1)))]
        with open(os.path.join(directory, name + ".vhdr"), "w") as f:
            f.write("\n".join(vhdr) + "\n")
        vmrk = ["Brain Vision Data Exchange Marker File, Version 1.0", "[Marker Infos]"]
        vmrk += [f"Mk{k + 1}=Stimulus,S  {k % 9 + 1},{200 + k * 1000},1,0"
                 for k in range(n_markers)]
        with open(os.path.join(directory, name + ".vmrk"), "w") as f:
            f.write("\n".join(vmrk) + "\n")
        lines.append(f"{name}.eeg {guessed}")
    info = os.path.join(directory, "info.txt")
    with open(info, "w") as f:
        f.write("\n".join(lines) + "\n")
    return info


def phase_float_session(np, info, counters, n_files):
    """A float32 session through the fused path (the ingest kernel's
    float32 instantiation) and the -pallas path on the card, each
    against the port's CPU run: statistics, and the features the run's
    kernel made against the CPU run's (the plain version on the same
    inputs). Returns the float32 ingest kernel's launches over the fused
    run and the largest feature deviation of each kernel."""
    launches = {}
    for fe in ("dwt-8-fused", "dwt-8-pallas"):
        q = f"info_file={info}&fe={fe}&train_clf=logreg"
        gpu = run_builder(f"float32_{fe}_cuda", q, None, counters)
        cpu = run_builder(f"float32_{fe}_cpu", q, "cpu", counters)
        compare_runs(np, gpu[0], cpu[0], f"float32_{fe}")
        launches[fe] = gpu[2]
        if fe == "dwt-8-fused":
            f32_err = (gpu[0].features.cpu() - cpu[0].features).abs().max().item()
            emit("features_cuda_vs_cpu", run=f"float32_{fe}", rows=int(cpu[0].features.shape[0]),
                 max_abs_err=f32_err, tol=KERNEL_TOL)
            if not (f32_err <= KERNEL_TOL and gpu[0].features.shape == cpu[0].features.shape):
                raise AssertionError("the float32 session's card features disagree with the CPU run")
        else:
            k4_err = host_features_vs_plain(np, gpu[0], cpu[0], f"float32_{fe}")
    fused, pallas = launches["dwt-8-fused"], launches["dwt-8-pallas"]
    if fused["ingest_features_f32"] != n_files or fused["ingest_features"] != 0:
        raise AssertionError(f"the float32 session's fused run launched {fused}")
    if pallas["epoch_features"] != 2:
        raise AssertionError(f"the float32 session's -pallas run launched {pallas}")
    return fused["ingest_features_f32"], f32_err, k4_err


#: the float32-sample megakernels' counters (serve_mega_cuda), by kernel name
#: phase 4b's large float32 batches: past the tile design's crossover
#: (1,056 windows on 132 multiprocessors)
LARGE_F32S_BATCH = 4096
F32S_COUNTERS = {
    "serve_mega_f32s": "LAUNCHES_F32S", "serve_mega_int8_f32s": "LAUNCHES_INT8_F32S",
    "serve_mega_int4_f32s": "LAUNCHES_INT4_F32S", "serve_mega_multi_f32s": "MULTI_LAUNCHES_F32S",
    "serve_mega_multi_int8_f32s": "MULTI_LAUNCHES_INT8_F32S",
    "serve_mega_multi_int4_f32s": "MULTI_LAUNCHES_INT4_F32S",
}


def float_windows(info):
    """The float32 session's serving requests (``windows_from_recording``
    on the CPU provider): windows, per-window resolutions, targets."""
    from eeg_dataanalysispackage_tpu_torch.epochs.extractor import BalanceState
    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
    from eeg_dataanalysispackage_tpu_torch.serve import engine

    odp = OfflineDataProvider([info], device="cpu")
    windows, resolutions, targets = [], [], []
    balance = BalanceState()
    for _rel, guessed, rec in odp.iter_recordings():
        ws, ts, res = engine.windows_from_recording(
            rec, odp.channel_indices_for(rec), guessed, balance=balance)
        windows.extend(ws)
        resolutions.extend([res] * len(ws))
        targets.extend(float(t) for t in ts)
    return windows, resolutions, targets


def phase_float_serve(torch, np, info, work):
    """Serving the float32 session (IEEE_FLOAT_32 requests, float32
    windows with unit resolutions) on the card, with models trained and
    saved by the card's fused run: (1) ``serve=true`` for logreg and svm
    at f32 and logreg at int8 and int4, each run's counters set to 0 just
    before it: its requests through K5-f32s / K5-int8-f32s / K5-int4-f32s
    (at least one launch a batch), ``result_path`` equal byte for byte to
    the card's batch ``load_clf=`` run's statistics, and the f32 logreg
    run's to the CPU's serve run (where they are not, every differing row
    must lie within MARGIN_BAND of the threshold, as in phase 5); (2) ``adapt=true&swap_gate=off``
    with the plain serve run's statistics and the adapter's feedback
    featurized by K1-f32; (3) a MultiplexedService of 128 tenants on the
    f32, int8 and int4 stacks over the session's windows (K6-f32s,
    K6-w8-f32s, K6-w4-f32s), every tenant's margins and predictions
    bit-equal to one solo engine serving that tenant's (dequantized)
    weights; (4) host-extractor services with ``dwt-8`` and
    ``dwt-8-pallas``: the host rung, K4 launched once a batch by the
    latter, predictions equal to the same services on the CPU. Returns
    {kernel name: launches}."""
    from eeg_dataanalysispackage_tpu_torch.features import registry as fe_registry
    from eeg_dataanalysispackage_tpu_torch.models import linear, registry
    from eeg_dataanalysispackage_tpu_torch.ops import dwt_cuda, ingest_cuda, serve_mega_cuda
    from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
    from eeg_dataanalysispackage_tpu_torch.serve import (
        InferenceService, MultiplexedEngine, MultiplexedService, ServingEngine,
    )

    t_phase = time.perf_counter()
    models = {}
    for clf in ("logreg", "svm"):
        models[clf] = os.path.join(work, f"float_model_{clf}")
        PipelineBuilder(f"info_file={info}&fe=dwt-8-fused&train_clf={clf}&save_clf=true"
                        f"&save_name={models[clf]}").execute()
    windows, resolutions, _targets = float_windows(info)
    kept = len(windows)
    launches = {}

    def zero():
        for attr in F32S_COUNTERS.values():
            setattr(serve_mega_cuda, attr, 0)
        ingest_cuda.LAUNCHES_F32 = 0
        dwt_cuda.LAUNCHES = 0

    def counts():
        return {k: getattr(serve_mega_cuda, a) for k, a in F32S_COUNTERS.items()}

    # 1. serve=true
    plain_stats = None
    for clf, precision in (("logreg", "f32"), ("svm", "f32"), ("logreg", "int8"),
                           ("logreg", "int4")):
        base = f"info_file={info}&fe=dwt-8-fused&load_clf={clf}&load_name={models[clf]}"
        if precision != "f32":
            base += f"&precision={precision}"
        batch = PipelineBuilder(base)
        batch_stats = str(batch.execute())
        result = os.path.join(work, f"float_serve_{clf}_{precision}.txt")
        zero()
        builder = PipelineBuilder(base + f"&serve=true&result_path={result}")
        served = str(builder.execute())
        got = counts()
        with open(result) as f:
            result_equal = f.read() == batch_stats + "\n"
        kernel = "serve_mega_f32s" if precision == "f32" else f"serve_mega_{precision}_f32s"
        block = builder.serve_block
        req = block["requests"]
        batch_rows = []
        if served != batch_stats:
            # the margins differ from the batch run's by summation order
            # (the kernel's 48-term dot against torch's matvec): a row may
            # flip only within MARGIN_BAND of the threshold
            with InferenceService.from_saved(clf, models[clf], precision=precision) as svc:
                results = svc.predict_all(windows, resolutions)
            thr = batch.classifier.margin_threshold
            batch_m = batch.classifier.margin(batch.features).double().cpu().numpy()
            batch_rows = differing_rows(
                np.array([r.prediction for r in results]),
                np.array([r.margin for r in results], np.float64),
                (batch_m > thr).astype(np.float64), batch_m, thr,
                f"float32 serve ({clf}, {precision}) vs batch")
            if not batch_rows:
                raise AssertionError(f"float32 serve ({clf}, {precision}): statistics differ "
                                     "from the batch run's with no near-threshold row")
        fields = {}
        if (clf, precision) == ("logreg", "f32"):
            plain_stats = served
            cpu = str(PipelineBuilder(base + "&serve=true", device="cpu").execute())
            rows = []
            if cpu != served:
                runs = {}
                for label, kwargs in (("cuda", {}), ("cpu", {"device": "cpu"})):
                    with InferenceService.from_saved("logreg", models[clf], **kwargs) as svc:
                        results = svc.predict_all(windows, resolutions)
                    runs[label] = (np.array([r.prediction for r in results]),
                                   np.array([r.margin for r in results], np.float64))
                thr = registry.create("logreg")
                thr.load(models[clf])
                rows = differing_rows(*runs["cuda"], *runs["cpu"], thr.margin_threshold,
                                      "float32 serve on the card vs on the CPU")
                if not rows:
                    raise AssertionError("float32 serve statistics differ from the CPU run's "
                                         "with no near-threshold row")
            fields = {"statistics_equal_cpu_serve": cpu == served,
                      "near_threshold_rows_cpu": rows}
        emit("float_serve", classifier=clf, precision=precision, rung=block["rung"],
             launches=got, kept=kept, completed=req["completed"], shed=req["shed"],
             batches=block["batches"], latency_ms=block["latency_ms"],
             statistics_equal_batch=served == batch_stats, result_path_equal_batch=result_equal,
             near_threshold_rows_batch=batch_rows, **fields)
        if not ((result_equal or batch_rows) and block["rung"] == "mega"
                and got[kernel] >= math.ceil(kept / 64) and req["completed"] == kept
                and req["shed"] == 0 and block["drained_cleanly"] is True):
            raise AssertionError(f"serve=true ({clf}, {precision}) on the float32 session did "
                                 f"not serve through {kernel} with the batch statistics")
        launches[kernel] = launches.get(kernel, 0) + got[kernel]

    # 2. adapt=true&swap_gate=off
    base = (f"info_file={info}&fe=dwt-8-fused&load_clf=logreg&load_name={models['logreg']}"
            "&serve=true&adapt=true&swap_gate=off")
    zero()
    builder = PipelineBuilder(base)
    adapted = str(builder.execute())
    fb = builder.serve_block["lifecycle"]["feedback"]
    k1_f32 = ingest_cuda.LAUNCHES_F32
    emit("float_adapt_gate_off", statistics_equal_plain_serve=adapted == plain_stats,
         feedback=fb, k1_f32_launches=k1_f32, k5_f32s_launches=counts()["serve_mega_f32s"],
         adapt_stage_s=builder.timers["adapt"])
    if not (adapted == plain_stats and fb["received"] == kept and fb["failures"] == 0
            and k1_f32 >= math.ceil(kept / 16)):
        raise AssertionError("adapt=true on the float32 session did not adapt as the plain run")

    # 3. 128 tenants on the f32, int8 and int4 stacks
    base_clf = registry.create("logreg")
    base_clf.load(models["logreg"])
    names = [f"t{i:03d}" for i in range(128)]
    tenants = {names[0]: base_clf}
    tenants.update({name: perturbed_tenant(np, base_clf, i) for i, name in enumerate(names)
                    if i})
    mix = [names[i % 128] for i in range(kept)]
    solo = ServingEngine(base_clf)
    solo.warmup()
    for wp in ("f32",) + PACKED:
        kernel = "serve_mega_multi_f32s" if wp == "f32" else f"serve_mega_multi_{wp}_f32s"
        zero()
        t0 = time.perf_counter()
        with MultiplexedService(tenants, weights_precision=wp) as svc:
            served = svc.predict_all(windows, resolutions, mix)
            eng = svc.engine
            stack = eng._f32_stack(eng._stack)
            lanes = {name: eng.tenant_info(name)["lane"] for name in tenants}
            block = svc.stats_block()
        wall = time.perf_counter() - t0
        got = counts()
        # every tenant against the solo engine serving its (dequantized) row
        equal = True
        for name, clf in tenants.items():
            twin = registry.create("logreg")
            twin.model = linear.LinearModel(stack[lanes[name]].cpu().contiguous(),
                                            float(clf.model.intercept))
            twin.margin_threshold = clf.margin_threshold
            solo.swap_model(twin)
            rows = [i for i, t in enumerate(mix) if t == name]
            for part in batches_of(rows):
                preds, margins = solo.execute([windows[i] for i in part], resolutions[part[0]])
                equal = (equal and np.asarray([served[i].margin for i in part], np.float32)
                         .tobytes() == margins.tobytes()
                         and [served[i].prediction for i in part] == list(preds))
        emit("float_serve_multitenant", weights_precision=wp, tenants=128, rung=block["rung"],
             weights=block.get("weights"), launches=got, kept=kept,
             completed=block["requests"]["completed"], batches=block["batches"],
             latency_ms=block["latency_ms"], wall_s=wall,
             every_tenant_bit_equal_solo=equal)
        if not (block["rung"] == "mega" and block["weights_precision"] == wp and equal
                and got[kernel] >= math.ceil(kept / 64)
                and block["requests"]["completed"] == kept):
            raise AssertionError(f"the 128-tenant float32 service ({wp}) did not serve as "
                                 "expected")
        launches[kernel] = got[kernel]

    # 5. large float32 batches: engines of capacity LARGE_F32S_BATCH, past
    # the tile design's crossover, serve the session's windows (cycled) in
    # one batch; their margins must equal, bit for bit, those of the
    # default 64-window engines (run_windows) on the same windows
    big = [windows[i % kept] for i in range(LARGE_F32S_BATCH)]
    if any(not np.array_equal(r, resolutions[0]) for r in resolutions):
        raise AssertionError("the float32 session's windows carry different resolutions")
    big_mix = [names[i % 128] for i in range(LARGE_F32S_BATCH)]
    for label, kernel, make in (
        [(p, "serve_mega_f32s" if p == "f32" else f"serve_mega_{p}_f32s",
          lambda cap, p=p: ServingEngine(base_clf, capacity=cap, precision=p))
         for p in ("f32", "int8", "int4")]
        + [(f"tenants_{wp}",
            "serve_mega_multi_f32s" if wp == "f32" else f"serve_mega_multi_{wp}_f32s",
            lambda cap, wp=wp: MultiplexedEngine(tenants, capacity=cap, weights_precision=wp))
           for wp in ("f32",) + PACKED]):
        engines = {cap: make(cap) for cap in (LARGE_F32S_BATCH, 64)}
        for eng in engines.values():
            eng.warmup()
        extra = (big_mix,) if label.startswith("tenants") else ()
        zero()
        serve_mega_cuda.F32S_DESIGN_RING = serve_mega_cuda.F32S_DESIGN_TILES = 0
        t0 = time.perf_counter()
        _preds, large = engines[LARGE_F32S_BATCH].execute(big, resolutions[0], *extra)
        wall = time.perf_counter() - t0
        designs = {"ring": serve_mega_cuda.F32S_DESIGN_RING,
                   "tiles": serve_mega_cuda.F32S_DESIGN_TILES}
        small = np.concatenate([
            engines[64].execute(big[i:i + 64], resolutions[0],
                                *((big_mix[i:i + 64],) if extra else ()))[1]
            for i in range(0, LARGE_F32S_BATCH, 64)])
        got = counts()
        equal = large.tobytes() == small.tobytes()
        emit("float_serve_large_batch", engine=label, windows=LARGE_F32S_BATCH,
             large_batch_designs=designs, launches=got, large_batch_wall_s=wall,
             margins_bit_equal_64_window_batches=equal, finite=bool(np.isfinite(large).all()))
        if not (equal and designs == {"ring": 0, "tiles": 1}
                and sum(got.values()) == 1 + LARGE_F32S_BATCH // 64):
            raise AssertionError(f"the {label} engine's large float32 batch did not run the "
                                 "tile design with run_windows' margins")
        launches[kernel] += got[kernel]

    # 4. the host-extractor mode
    clf = registry.create("logreg")
    clf.load(models["logreg"])
    for fe in ("dwt-8", "dwt-8-pallas"):
        zero()
        with InferenceService(clf, host_extractor=fe_registry.create(fe)) as svc:
            warm = dwt_cuda.LAUNCHES
            served = svc.predict_all(windows, resolutions)
            block = svc.stats_block()
        k4 = dwt_cuda.LAUNCHES - warm
        with InferenceService(clf, host_extractor=fe_registry.create(fe, device="cpu"),
                              device="cpu") as cpu:
            want = cpu.predict_all(windows, resolutions)
        equal = [r.prediction for r in served] == [r.prediction for r in want]
        expected_k4 = block["batches"] if fe == "dwt-8-pallas" else 0
        emit("float_host_extractor", fe=fe, mode=block["mode"], rung=block["rung"],
             k4_launches=k4, batches=block["batches"], completed=block["requests"]["completed"],
             latency_ms=block["latency_ms"], predictions_equal_cpu=equal,
             other_launches=counts())
        if not (block["mode"] == "host-extractor" and block["rung"] == "host" and equal
                and k4 == expected_k4 and block["requests"]["completed"] == kept
                and not any(counts().values())):
            raise AssertionError(f"the host-extractor service ({fe}) did not serve as expected")
        if fe == "dwt-8-pallas":
            launches["epoch_features_host_extractor"] = k4
    emit("float_serve_phase", seconds=time.perf_counter() - t_phase)
    return launches


# configuration A: the JAX package's test_nn_pipeline network; B: the
# rest of the surface (denoising AE pretraining with dropout, an LSTM,
# adam, he_normal init, mse)
NN_A = ("&config_seed=1&config_num_iterations=50&config_learning_rate=0.1&config_momentum=0.9"
        "&config_weight_init=xavier&config_updater=nesterovs"
        "&config_optimization_algo=stochastic_gradient_descent&config_pretrain=false"
        "&config_backprop=true&config_loss_function=xent"
        "&config_layer1_layer_type=dense&config_layer1_n_out=8&config_layer1_drop_out=0.0"
        "&config_layer1_activation_function=relu&config_layer2_layer_type=output"
        "&config_layer2_n_out=2&config_layer2_drop_out=0.0"
        "&config_layer2_activation_function=softmax")
NN_B = ("&config_seed=1&config_num_iterations=200&config_learning_rate=0.01&config_momentum=0.9"
        "&config_weight_init=relu&config_updater=adam"
        "&config_optimization_algo=stochastic_gradient_descent&config_pretrain=true"
        "&config_backprop=true&config_loss_function=mse"
        "&config_layer1_layer_type=auto_encoder&config_layer1_n_out=64"
        "&config_layer1_drop_out=0.2&config_layer1_activation_function=sigmoid"
        "&config_layer2_layer_type=graves_lstm&config_layer2_n_out=32&config_layer2_drop_out=0.0"
        "&config_layer2_activation_function=tanh&config_layer3_layer_type=output"
        "&config_layer3_n_out=2&config_layer3_drop_out=0.0"
        "&config_layer3_activation_function=softmax")
# the nn's steps a fit runs: backprop iterations plus those of each
# pretrained layer
NN_STEPS = {"a": 50, "b": 400}
NN_TOL = 1e-4  # card predictions against the CPU run's


def nn_predictions(builder):
    """(n_test,) float64 predictions of a run's network on its test rows."""
    return builder.classifier.predict(test_features(builder)).cpu().numpy()


def compare_nn_runs(np, gpu, cpu, label):
    """Card predictions within NN_TOL of the CPU run's; a test row may
    round differently only within NN_TOL of 0.5 on both runs, and the
    counts differ by those rows alone."""
    p_g, p_c = nn_predictions(gpu), nn_predictions(cpu)
    dev = float(np.abs(p_g - p_c).max())
    r_g, r_c = np.floor(p_g + 0.5), np.floor(p_c + 0.5)
    flips = [{"row": int(gpu.test_index[r]), "pred_cuda": float(p_g[r]), "pred_cpu": float(p_c[r])}
             for r in np.nonzero(r_g != r_c)[0]]
    a, b = gpu.statistics, cpu.statistics
    count_gap = (abs(a.true_positives - b.true_positives) + abs(a.true_negatives - b.true_negatives)
                 + abs(a.false_positives - b.false_positives)
                 + abs(a.false_negatives - b.false_negatives)) // 2
    near = all(abs(f["pred_cuda"] - 0.5) <= NN_TOL and abs(f["pred_cpu"] - 0.5) <= NN_TOL
               for f in flips)
    emit("nn_cpu_parity", run=label, max_abs_pred_dev=dev, tol=NN_TOL,
         near_threshold_rows=flips, count_gap=count_gap,
         statistics_equal=str(a) == str(b), mse_cuda=a.mse / max(a.num_patterns, 1),
         mse_cpu=b.mse / max(b.num_patterns, 1))
    if not (dev <= NN_TOL and near and count_gap == len(flips) and np.isfinite(p_g).all()):
        raise AssertionError(f"{label}: card predictions disagree with the CPU run's")


def threefry_card_checks(torch, np, dev, kept):
    """The threefry streams on the card against the CPU: bits, uniforms,
    Bernoulli masks (scalar and tensor p, the dropout shape of
    configuration B) and the SGD mini-batch masks, bit for bit; the
    card's time to draw one mini-batch mask of the session's rows."""
    from eeg_dataanalysispackage_tpu_torch.models import sgd
    from eeg_dataanalysispackage_tpu_torch.utils import threefry

    checked = 0
    for seed in (0, 1, 42, 2**31 - 1):
        key = threefry.fold_in(threefry.prng_key(seed), 2**32 - 1)
        for shape in ((), (7,), (kept,), (1494, 64)):
            pairs = [(threefry.random_bits(key, shape, dev), threefry.random_bits(key, shape)),
                     (threefry.uniform(key, shape, -1.0, 1.0, dev),
                      threefry.uniform(key, shape, -1.0, 1.0)),
                     (threefry.bernoulli(key, 0.8, shape, dev), threefry.bernoulli(key, 0.8, shape))]
            p = torch.rand(shape, generator=torch.Generator().manual_seed(seed))
            pairs.append((threefry.bernoulli(key, p.to(dev)), threefry.bernoulli(key, p)))
            config = sgd.SGDConfig(mini_batch_fraction=0.5, seed=seed)
            for t in (1, 2, 100):
                pairs.append((sgd.mini_batch_mask(config, t, kept, dev),
                              sgd.mini_batch_mask(config, t, kept, "cpu")))
            for got, want in pairs:
                if got.device.type != "cuda" or not torch.equal(got.cpu(), want):
                    raise AssertionError(f"threefry draw on the card differs (seed {seed}, {shape})")
                checked += 1
    config = sgd.SGDConfig(mini_batch_fraction=0.5)
    mask_ms = time_ms(lambda: sgd.mini_batch_mask(config, 7, kept, dev))
    emit("threefry_card_vs_cpu", draws_checked=checked, bit_equal=True,
         mini_batch_mask_ms=mask_ms, rows=kept)
    return mask_ms


def phase_nn(torch, np, info, counters, work, kept):
    """Threefry mini-batch sampling and the neural network on the card:
    logreg and svm at config_mini_batch_fraction=0.5, train_clf=nn with
    configurations A and B on fe=dwt-8-fused (K1) and A on fe=dwt-8-pallas
    (K4), each against the port's CPU run; then load_clf=nn and
    serve=true&load_clf=nn of the saved A model on the card (K1 on the
    fused rung, no megakernel), the served statistics byte-equal to the
    batch load run's. Returns (K1 launches, K4 launches) over the card
    runs."""
    from eeg_dataanalysispackage_tpu_torch.ops import ingest_cuda, serve_mega_cuda
    from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
    from eeg_dataanalysispackage_tpu_torch.serve import InferenceService, engine

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    mask_ms = threefry_card_checks(torch, np, dev, kept)
    base = f"info_file={info}"
    k1 = k4 = 0
    for clf in ("logreg", "svm"):
        q = (f"{base}&fe=dwt-8-fused&train_clf={clf}&config_num_iterations=100"
             "&config_step_size=1.0&config_reg_param=0.01&config_mini_batch_fraction=0.5")
        gpu = run_builder(f"{clf}_minibatch_cuda", q, None, counters)
        cpu = run_builder(f"{clf}_minibatch_cpu", q, "cpu", counters)
        if gpu[2]["ingest_features"] < 8 or cpu[2]["ingest_features"] != 0:
            raise AssertionError(f"{clf} mini-batch run did not featurize on the card")
        compare_runs(np, gpu[0], cpu[0], f"{clf}_minibatch")
        k1 += gpu[2]["ingest_features"]
    models = {"a": os.path.join(work, "model_a.nn"), "b": os.path.join(work, "model_b.nn")}
    train = {}
    for label, fe, cfg, name in (("a_fused", "dwt-8-fused", NN_A, "a"),
                                 ("b_fused", "dwt-8-fused", NN_B, "b"),
                                 ("a_pallas", "dwt-8-pallas", NN_A, None)):
        q = f"{base}&fe={fe}&train_clf=nn{cfg}"
        save = f"&save_clf=true&save_name={models[name]}" if name else ""
        gpu = run_builder(f"nn_{label}_cuda", q + save, None, counters)
        cpu = run_builder(f"nn_{label}_cpu", q, "cpu", counters)
        net_dev = next(gpu[0].classifier.net.parameters()).device
        if net_dev.type != "cuda":
            raise AssertionError(f"nn {label}: the network trained on {net_dev}")
        if cpu[2]["ingest_features"] or cpu[2]["epoch_features"]:
            raise AssertionError(f"nn {label}: a kernel launched on the CPU path")
        if fe == "dwt-8-fused" and gpu[2]["ingest_features"] < 8:
            raise AssertionError(f"nn {label}: the fused run did not launch K1 per recording")
        if fe == "dwt-8-pallas" and gpu[2]["epoch_features"] != 2:
            raise AssertionError(f"nn {label}: -pallas launched K4 {gpu[2]['epoch_features']} "
                                 "times, not 2")
        compare_nn_runs(np, gpu[0], cpu[0], f"nn_{label}")
        k1 += gpu[2]["ingest_features"]
        k4 += gpu[2]["epoch_features"]
        steps = NN_STEPS[label[0]]
        train_s = gpu[0].timers["train"]
        train[label] = {"train_s": train_s, "steps": steps,
                        "per_iteration_ms": train_s * 1e3 / steps,
                        "cpu_train_s": cpu[0].timers["train"], "stages_s": gpu[0].timers}
        emit("nn_train", run=f"nn_{label}", fe=fe, train_s=train_s, steps=steps,
             per_iteration_ms=train_s * 1e3 / steps, cpu_train_s=cpu[0].timers["train"],
             accuracy=gpu[1].calc_accuracy())

    # load_clf=nn and serve=true&load_clf=nn of the saved A model
    load = f"{base}&fe=dwt-8-fused&load_clf=nn&load_name={models['a']}"
    batch, batch_stats, batch_launches = run_builder("nn_a_load_cuda", load, None, counters)
    k1 += batch_launches["ingest_features"]
    ingest_cuda.LAUNCHES = 0
    ingest_cuda.LAUNCHES_F32 = 0
    serve_mega_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    served_builder = PipelineBuilder(load + "&serve=true")
    served = served_builder.execute()
    wall = time.perf_counter() - t0
    serve_k1, mega = ingest_cuda.LAUNCHES, serve_mega_cuda.LAUNCHES
    block = served_builder.serve_block
    req = block["requests"]
    equal = str(served) == str(batch_stats)
    emit("nn_serve_e2e", mode=block["mode"], rung=block["rung"], mega=block["mega"],
         ingest_launches=serve_k1, ingest_f32s_launches_warmup=ingest_cuda.LAUNCHES_F32,
         serve_mega_launches=mega, kept=kept, completed=req["completed"], shed=req["shed"],
         batches=block["batches"], mean_batch_size=block["mean_batch_size"],
         latency_ms=block["latency_ms"], drained_cleanly=block["drained_cleanly"],
         wall_s=wall, stages_s=served_builder.timers, statistics_equal_batch=equal)
    if not (block["mode"] == "featurize+host" and block["rung"] == "fused"
            and block["mega"] is None and mega == 0 and req["completed"] == kept
            and serve_k1 >= block["batches"] >= math.ceil(kept / 64) and equal):
        raise AssertionError("serve=true&load_clf=nn did not serve like the batch load run "
                             "on the fused rung")
    k1 += serve_k1

    # one 64-window batch: K1's rows against the batch run's, and the
    # engine's featurize and predict steps (host wall, medians of 25)
    from eeg_dataanalysispackage_tpu_torch.epochs.extractor import BalanceState
    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider

    odp = OfflineDataProvider([info], device="cpu")
    balance = BalanceState()
    windows, res_np = [], None
    for _rel, guessed, rec in odp.iter_recordings():
        ws, _ts, res_np = engine.windows_from_recording(
            rec, odp.channel_indices_for(rec), guessed, balance=balance)
        windows.extend(ws)
        if len(windows) >= 64:
            break
    with InferenceService(batch.classifier) as svc:
        eng = svc.engine
        batch_w = windows[:64]
        res_t = torch.from_numpy(res_np).to(dev)
        feats = eng._fused_features(eng._fused, batch_w, res_t)[:64]
        row_dev = (feats - batch.features[:64]).abs().max().item()
        clf = batch.classifier

        def host_ms(fn, runs=25):
            times = []
            for _ in range(runs):
                t1 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            return pystats.median(times)

        split = {"featurize_ms": host_ms(lambda: eng._fused_features(eng._fused, batch_w, res_t)),
                 "predict_ms": host_ms(lambda: clf.predict(feats)),
                 "engine_execute_ms": host_ms(lambda: eng.execute(batch_w, res_np))}
    emit("nn_serve_split", batch=64, fused_rows_vs_batch_rows_max_abs_dev=row_dev, **split)
    emit("nn_phase", seconds=time.perf_counter() - t_phase, k1_launches=k1, k4_launches=k4,
         mini_batch_mask_ms=mask_ms, train=train)
    return k1, k4


TREE_NAMES = ("dt", "rf", "gbt", "dt-tpu", "rf-tpu", "gbt-tpu")
EDGE_TOL = 2e-6  # a differing tree test row lies this close to an edge on its path
TREE_LEAF_TOL = 1e-6  # gbt-tpu leaf values, card against CPU (tests/test_torch_trees_device.py)
F_NEAR = 1e-5  # a gbt-tpu prediction may differ only where |F| is this small


def compare_tree_runs(np, gpu, cpu, label):
    """Equal statistics, or differing test rows each within EDGE_TOL of a
    split edge on its path in the card's or the CPU's model (counted and
    printed)."""
    from eeg_dataanalysispackage_tpu_torch.models import trees

    import torch

    rows = []
    if str(gpu.statistics) != str(cpu.statistics):
        x_g, x_c = (test_features(r).double().cpu().numpy() for r in (gpu, cpu))
        a = gpu.classifier.predict(torch.from_numpy(x_g)).numpy()
        b = cpu.classifier.predict(torch.from_numpy(x_c)).numpy()
        gap = np.minimum(trees.edge_distance(gpu.classifier.trees, gpu.classifier.edges, x_g),
                         trees.edge_distance(cpu.classifier.trees, cpu.classifier.edges, x_c))
        for r in np.nonzero(a != b)[0]:
            rows.append({"row": int(gpu.test_index[r]), "edge_distance": float(gap[r])})
        if not rows or any(x["edge_distance"] > EDGE_TOL for x in rows):
            raise AssertionError(f"{label}: statistics differ beyond near-edge rows: {rows}")
    emit("tree_cpu_parity", run=label, statistics_equal=not rows, near_edge_rows=rows,
         edge_tol=EDGE_TOL)


def same_tree(a, b, i=0, j=0) -> bool:
    """Two trees in either layout (heap or linked) split alike from the
    root and predict alike at every leaf."""
    fa, fb = int(a["feature"][i]), int(b["feature"][j])
    if fa < 0 or fb < 0:
        return fa < 0 and fb < 0 and a["prediction"][i] == b["prediction"][j]
    return (fa == fb and a["threshold_bin"][i] == b["threshold_bin"][j]
            and same_tree(a, b, a["left"][i], b["left"][j])
            and same_tree(a, b, a["right"][i], b["right"][j]))


def hold_growers(torch, np, runs):
    """The growers on the card held on the card runs' own feature rows:
    dt-tpu's tree against the host dt grower's, rf-tpu's forest against
    the port's rf-tpu grown on the CPU from the same rows, gbt-tpu's
    rounds against the CPU's (leaf values within TREE_LEAF_TOL,
    predictions equal except |F| < F_NEAR)."""
    from eeg_dataanalysispackage_tpu_torch.models import registry, trees
    from eeg_dataanalysispackage_tpu_torch.utils import java_compat

    out = {}
    for name, against in (("dt-tpu", "dt"), ("rf-tpu", "rf-tpu"), ("gbt-tpu", "gbt-tpu")):
        card = runs[name]
        train = java_compat.train_test_split_indices(len(card.targets), seed=1)[0]
        rows = card.features[torch.as_tensor(train, device=card.features.device)].cpu()
        labels = torch.as_tensor(np.asarray(card.targets)[train], dtype=torch.float32)
        ref = registry.create(against)
        t0 = time.perf_counter()
        ref.fit(rows, labels)
        cpu_fit_s = time.perf_counter() - t0
        got, want = card.classifier.trees, ref.trees
        record = {"trees": len(got), "cpu_fit_s": cpu_fit_s}
        if name == "dt-tpu":
            ok = len(got) == len(want) == 1 and same_tree(got[0], want[0])
        elif name == "rf-tpu":
            flips = sum(any(not np.array_equal(g[k], w[k]) for k in w)
                        for g, w in zip(got, want))
            record["trees_differing"] = flips
            ok = len(got) == len(want) and flips == 0
        else:
            split = [r for r, (g, w) in enumerate(zip(got, want))
                     if not (np.array_equal(g["feature"], w["feature"])
                             and np.array_equal(g["threshold_bin"], w["threshold_bin"]))]
            first = split[0] if split else len(got)
            leaf_dev = max((float(np.abs(g["prediction"] - w["prediction"]).max())
                            for g, w in zip(got[:first], want[:first])), default=0.0)
            binned = trees.bin_features(rows.double().numpy(), card.classifier.edges)
            lr = card.classifier._params["learning_rate"]
            F_g, F_c = (sum(lr * trees._predict_tree(t, binned) for t in ts) for ts in (got, want))
            pred_flips = np.nonzero((F_g >= 0) != (F_c >= 0))[0]
            record.update(rounds_with_split_flips=split, leaf_dev=leaf_dev,
                          leaf_tol=TREE_LEAF_TOL, prediction_flips=int(len(pred_flips)),
                          flip_abs_F=[float(abs(F_g[r])) for r in pred_flips])
            ok = (len(got) == len(want) and leaf_dev <= TREE_LEAF_TOL
                  and all(abs(F_g[r]) < F_NEAR for r in pred_flips))
        ok = bool(ok)
        emit("tree_grower_card_vs_cpu", run=name, against=f"{against} on the CPU", equal=ok,
             **record)
        if not ok:
            raise AssertionError(f"{name}: the card's trees disagree with {against} on the CPU")
        out[name] = record
    return out


def phase_trees(torch, np, info, counters, work, kept, n_files):
    """The tree families on the card: dt, rf, gbt, dt-tpu, rf-tpu and
    gbt-tpu on fe=dwt-8-fused at the defaults (K1 once per recording),
    each saved and held against the port's CPU run under the edge rule;
    the growers held on the card runs' own rows; rf on fe=dwt-8-pallas
    (K4 twice); load_clf= of each saved model; serve=true&load_clf=rf and
    gbt-tpu (featurize+host, no megakernel) byte-equal to the batch load
    runs; InferenceService.from_saved and the CLI against the batch load
    runs; a depth-13 dt-tpu refused with no launch. Returns (K1 launches,
    K4 launches) over the card runs of this process."""
    from eeg_dataanalysispackage_tpu_torch.models import registry, trees_device
    from eeg_dataanalysispackage_tpu_torch.ops import ingest_cuda, serve_mega_cuda
    from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
    from eeg_dataanalysispackage_tpu_torch.serve import InferenceService

    t_phase = time.perf_counter()
    base = f"info_file={info}"
    k1 = k4 = 0
    # every device growth records the device it ran on
    grown = []
    real = {f: getattr(trees_device, f) for f in ("grow_forest", "boost_gbt")}

    def spy(name):
        def grow(binned, *args, **kwargs):
            grown.append(binned.device.type)
            return real[name](binned, *args, **kwargs)
        return grow

    for name in real:
        setattr(trees_device, name, spy(name))
    try:
        runs, models, train = {}, {}, {}
        for name in TREE_NAMES:
            models[name] = os.path.join(work, f"model_{name}")
            q = f"{base}&fe=dwt-8-fused&train_clf={name}"
            del grown[:]
            gpu = run_builder(f"{name}_fused_cuda", q + f"&save_clf=true&save_name={models[name]}",
                              None, counters)
            card_growths = list(grown)
            cpu = run_builder(f"{name}_fused_cpu", q, "cpu", counters)
            if gpu[2]["ingest_features"] != n_files or cpu[2]["ingest_features"]:
                raise AssertionError(f"{name}: K1 launched {gpu[2]['ingest_features']} times on "
                                     f"the card run, not once per recording")
            if name.endswith("-tpu") and card_growths != [gpu[0].device.type]:
                raise AssertionError(f"{name}: the forest grew on {card_growths}, not on "
                                     f"{gpu[0].device}")
            compare_tree_runs(np, gpu[0], cpu[0], f"{name}_fused")
            k1 += gpu[2]["ingest_features"]
            runs[name] = gpu[0]
            train[name] = {"train_s": gpu[0].timers["train"], "stages_s": gpu[0].timers,
                           "cpu_train_s": cpu[0].timers["train"],
                           "accuracy": gpu[1].calc_accuracy()}
            emit("tree_train", run=name, fe="dwt-8-fused", train_s=gpu[0].timers["train"],
                 cpu_train_s=cpu[0].timers["train"], trees=len(gpu[0].classifier.trees),
                 statistics=str(gpu[1]))
        growers = hold_growers(torch, np, runs)

        # rf on the host fe= path through the epoch-features kernel
        q = f"{base}&fe=dwt-8-pallas&train_clf=rf"
        gpu = run_builder("rf_pallas_cuda", q, None, counters)
        cpu = run_builder("rf_pallas_cpu", q, "cpu", counters)
        if gpu[2]["epoch_features"] != 2 or cpu[2]["epoch_features"]:
            raise AssertionError(f"rf -pallas: K4 launched {gpu[2]['epoch_features']} times, "
                                 "not 2")
        compare_tree_runs(np, gpu[0], cpu[0], "rf_pallas")
        k4 += gpu[2]["epoch_features"]
        train["rf_pallas"] = {"train_s": gpu[0].timers["train"]}

        # load_clf= of each saved model: the test half equals the train run
        loads = {}
        for name in TREE_NAMES:
            load = f"{base}&fe=dwt-8-fused&load_clf={name}&load_name={models[name]}"
            batch, batch_stats, launches = run_builder(f"{name}_load_cuda", load, None, counters)
            k1 += launches["ingest_features"]
            trained = runs[name]
            idx = torch.as_tensor(trained.test_index, device=batch.features.device)
            half = batch.classifier.test_features(
                batch.features[idx], np.asarray(trained.targets)[trained.test_index])
            equal = (str(half) == str(trained.statistics)
                     and torch.equal(batch.features, trained.features))
            emit("tree_load", run=name, test_half_equal_train_run=equal,
                 statistics=str(batch_stats))
            if not equal:
                raise AssertionError(f"load_clf={name}: the test half differs from the train run")
            loads[name] = (load, batch_stats, batch)

        # serve=true of the saved rf and gbt-tpu models
        served = {}
        for name in ("rf", "gbt-tpu"):
            load, batch_stats, _batch = loads[name]
            ingest_cuda.LAUNCHES = 0
            ingest_cuda.LAUNCHES_F32 = 0
            serve_mega_cuda.LAUNCHES = 0
            t0 = time.perf_counter()
            builder = PipelineBuilder(load + "&serve=true")
            stats_ = builder.execute()
            wall = time.perf_counter() - t0
            serve_k1, mega = ingest_cuda.LAUNCHES, serve_mega_cuda.LAUNCHES
            block, req = builder.serve_block, builder.serve_block["requests"]
            equal = str(stats_) == str(batch_stats)
            served[name] = {"wall_s": wall, "latency_ms": block["latency_ms"],
                            "batches": block["batches"], "ingest_launches": serve_k1}
            emit("tree_serve_e2e", run=name, mode=block["mode"], rung=block["rung"],
                 mega=block["mega"], ingest_launches=serve_k1,
                 ingest_f32s_launches_warmup=ingest_cuda.LAUNCHES_F32, serve_mega_launches=mega,
                 kept=kept, completed=req["completed"], shed=req["shed"],
                 batches=block["batches"], mean_batch_size=block["mean_batch_size"],
                 latency_ms=block["latency_ms"], drained_cleanly=block["drained_cleanly"],
                 wall_s=wall, stages_s=builder.timers, statistics_equal_batch=equal)
            if not (block["mode"] == "featurize+host" and block["rung"] == "fused"
                    and block["mega"] is None and mega == 0 and req["completed"] == kept
                    and serve_k1 >= block["batches"] >= math.ceil(kept / 64) and equal):
                raise AssertionError(f"serve=true&load_clf={name} did not serve like the batch "
                                     "load run on the fused rung")
            k1 += serve_k1

        # the other entry points: InferenceService.from_saved and the CLI
        windows, resolutions, _ = session_windows(info)
        batch = loads["gbt"][2]
        t0 = time.perf_counter()
        with InferenceService.from_saved("gbt", models["gbt"], device=batch.device) as svc:
            got = np.array([r.prediction for r in svc.predict_all(windows, resolutions)])
        from_saved_s = time.perf_counter() - t0
        from_saved_equal = bool(np.array_equal(
            got, batch.classifier.predict(batch.features).cpu().numpy()))
        result = os.path.join(work, "cli_result.txt")
        rc, cli_s = run_cli(loads["rf-tpu"][0] + f"&result_path={result}")
        with open(result, encoding="utf-8") as f:
            cli_equal = rc == 0 and f.read() == str(loads["rf-tpu"][1]) + "\n"
        emit("tree_entry_points", from_saved="gbt", from_saved_equal_batch=from_saved_equal,
             from_saved_s=from_saved_s, cli="load_clf=rf-tpu", cli_rc=rc,
             cli_equal_batch=cli_equal, cli_wall_s=cli_s)
        if not (from_saved_equal and cli_equal):
            raise AssertionError("InferenceService.from_saved or the CLI disagrees with the "
                                 "batch load runs")

        # a depth-13 dt-tpu is refused before any launch
        del grown[:]
        before = ingest_cuda.LAUNCHES
        clf = registry.create("dt-tpu")
        clf.set_config({"config_max_bins": "32", "config_impurity": "gini",
                        "config_max_depth": "13", "config_min_instances_per_node": "1"})
        card = runs["dt-tpu"]
        try:
            clf.fit(card.features, torch.zeros(len(card.targets), device=card.features.device))
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("a depth-13 dt-tpu fit was not refused")
        emit("tree_refusal", message=refused, growths=len(grown),
             launches=ingest_cuda.LAUNCHES - before)
        if grown or ingest_cuda.LAUNCHES != before or "max_depth <= 12" not in refused:
            raise AssertionError("the depth-13 dt-tpu refusal launched work on the card")
    finally:
        for name, fn in real.items():
            setattr(trees_device, name, fn)
    emit("tree_phase", seconds=time.perf_counter() - t_phase, k1_launches=k1, k4_launches=k4,
         train=train, growers=growers, serve=served)
    return k1, k4


# the bench's fan-out configuration (tools/pipeline_bench.py _CONFIG): every
# classifier picks the keys it knows
FANOUT_CONFIG = (
    "&config_num_iterations=20&config_step_size=1.0&config_mini_batch_fraction=1.0"
    "&config_reg_param=0.01&config_max_bins=16&config_impurity=gini&config_max_depth=4"
    "&config_min_instances_per_node=1&config_num_trees=5&config_feature_subset=auto"
    "&config_seed=1&config_learning_rate=0.1&config_momentum=0.9"
    "&config_weight_init=xavier&config_updater=nesterovs"
    "&config_optimization_algo=stochastic_gradient_descent&config_pretrain=false"
    "&config_backprop=true&config_loss_function=xent&config_layer1_layer_type=dense"
    "&config_layer1_n_out=8&config_layer1_drop_out=0.0"
    "&config_layer1_activation_function=relu&config_layer2_layer_type=output"
    "&config_layer2_n_out=2&config_layer2_drop_out=0.0"
    "&config_layer2_activation_function=softmax")
# the bench's population pair: cv=4 x a 2 x 2 lr/reg grid = 16 members
POPULATION_AXES = "cv=4&sweep=lr:1.0,0.5;reg:0.0,0.01"
POPULATION_ITERS = 6000
LOOPED_LIMIT_S = 60.0  # the looped population's train stage must stay under it
LBFGS_HORIZON = 20  # updates of the optimizer-alone check on the card run's rows


def leg_view(builder, name):
    """One fan-out leg seen as a single run (classifier, statistics, the
    shared test rows), for the phase-4 comparison helpers."""
    import types

    return types.SimpleNamespace(classifier=builder.classifiers[name],
                                 statistics=builder.statistics[name],
                                 test_index=builder.test_index, features=builder.features,
                                 batch=builder.batch, fe=builder.fe, device=builder.device)


def compare_legs(np, gpu, cpu, name, label):
    """A leg against another run of it under phase 4's near-threshold rule
    for its family (margins, network predictions, tree edges)."""
    if name in ("logreg", "svm"):
        compare_runs(np, gpu, cpu, label)
    elif name == "nn":
        compare_nn_runs(np, gpu, cpu, label)
    else:
        compare_tree_runs(np, gpu, cpu, label)


def compare_members(np, torch, gpu, cpu, label, linear):
    """A population's members on the card against the CPU run's: equal
    statistics, or differing test rows within MARGIN_BAND of the threshold
    on both (linear), or predictions within NN_TOL rounding apart only
    within NN_TOL of 0.5 (nn). Returns the differing rows."""
    if list(gpu.statistics) != list(cpu.statistics):
        raise AssertionError(f"{label}: the member sets differ")
    rows = []
    for m in gpu.statistics:
        g, c = gpu.population_states[m], cpu.population_states[m]
        if linear:
            idx = torch.as_tensor(g["test_index"])
            m_g = (gpu.features[idx.to(gpu.features.device)] @ g["state"]).double().cpu().numpy()
            m_c = (cpu.features[idx] @ c["state"]).double().numpy()
            differ = np.nonzero((m_g > 0) != (m_c > 0))[0]
            rows += [{"member": m, "row": int(r), "margin_cuda": float(m_g[r]),
                      "margin_cpu": float(m_c[r])} for r in differ]
            ok = all(abs(m_g[r]) <= MARGIN_BAND and abs(m_c[r]) <= MARGIN_BAND for r in differ)
        else:
            p_g, p_c = g["predictions"], c["predictions"]
            differ = np.nonzero(np.floor(p_g + 0.5) != np.floor(p_c + 0.5))[0]
            rows += [{"member": m, "row": int(r), "pred_cuda": float(p_g[r]),
                      "pred_cpu": float(p_c[r])} for r in differ]
            ok = (float(np.abs(p_g - p_c).max()) <= NN_TOL
                  and all(abs(p_g[r] - 0.5) <= NN_TOL for r in differ))
        if not ok:
            raise AssertionError(f"{label} {m}: members disagree beyond the near-threshold rule")
    emit("population_cpu_parity", run=label, members=len(gpu.statistics),
         statistics_equal=str(gpu.statistics) == str(cpu.statistics), near_threshold_rows=rows)
    return rows


def population_pair(np, info, counters, work, iters, label):
    """The bench's population on the card, batched and looped: the two
    result_path texts byte-equal; returns (vmap run, looped run)."""
    out = {}
    for mode in ("vmap", "looped"):
        q = (f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&{POPULATION_AXES}"
             f"&population_mode={mode}&config_num_iterations={iters}&config_step_size=1.0"
             f"&config_mini_batch_fraction=1.0&result_path={work}/pop_{mode}.txt")
        out[mode] = run_builder(f"{label}_{mode}_cuda", q, None, counters)
    texts = {m: open(f"{work}/pop_{m}.txt").read() for m in out}
    vm, lo = out["vmap"][0], out["looped"][0]
    emit("population_pair", run=label, iterations=iters, members=len(vm.statistics),
         modes=[vm.population_block["mode"], lo.population_block["mode"]],
         result_path_equal=texts["vmap"] == texts["looped"],
         train_s={m: out[m][0].timers["train"] for m in out},
         members_per_s={m: len(vm.statistics) / out[m][0].timers["train"] for m in out})
    if not (texts["vmap"] == texts["looped"] and vm.population_block["mode"] == "vmap"
            and lo.population_block["mode"] == "looped"):
        raise AssertionError(f"{label}: the batched and looped populations disagree")
    return out["vmap"], out["looped"]


def optimizer_alone(torch, np, builder, updates):
    """A value-function nn run's optimizer alone: its classifier's config
    refit for ``updates`` updates on the run's own train rows, on the card
    and on the CPU (the same float32 rows copied to the host). Returns
    ({device: per-update line-search steps}, max abs prediction deviation
    on the run's test rows)."""
    from eeg_dataanalysispackage_tpu_torch.models import registry
    from eeg_dataanalysispackage_tpu_torch.utils import java_compat

    train, _ = java_compat.train_test_split_indices(len(builder.targets), seed=1)
    idx = torch.as_tensor(train, device=builder.features.device)
    x = builder.features[idx]
    y = torch.as_tensor(builder.targets, device=x.device)[idx].to(torch.float32)
    test = test_features(builder)
    steps, preds = {}, {}
    for device in ("cuda", "cpu"):
        clf = registry.create("nn")
        clf.set_config(dict(builder.classifier.config, config_num_iterations=str(updates)))
        clf.fit(x.to(device), y.to(device))
        preds[device] = clf.predict(test.to(device)).cpu().numpy()
        steps[device] = [n for n, _ in clf.linesearch_history]
    return steps, float(np.abs(preds["cuda"] - preds["cpu"]).max())


def phase_training_surface(torch, np, info, counters, work, kept, n_files):
    """The training surface beyond one model on the card: classifiers=
    fan-outs (fused: K1 once per recording, legs byte-equal to single card
    runs; -pallas: K4 once, legs equal to single runs under the
    near-threshold rule), the bench's 16-member logreg population batched
    and looped, an svm population with a live seed axis, an nn population,
    elastic runs under a device.step fault, and nn's lbfgs and
    line_gradient_descent; every run against the port's CPU run. Returns
    (K1 launches, K4 launches) over the card runs."""
    from eeg_dataanalysispackage_tpu_torch import obs
    from eeg_dataanalysispackage_tpu_torch.models import sgd
    from eeg_dataanalysispackage_tpu_torch.obs import chaos

    t_phase = time.perf_counter()
    base = f"info_file={info}"
    k1 = k4 = 0

    # 1. the five-classifier fan-out on fe=dwt-8-fused
    names = ("logreg", "svm", "dt", "rf", "nn")
    q = f"{base}&fe=dwt-8-fused&classifiers={','.join(names)}{FANOUT_CONFIG}"
    fan = run_builder("fanout5_fused_cuda", q + f"&result_path={work}/fan.txt", None, counters)
    fan_cpu = run_builder("fanout5_fused_cpu", q, "cpu", counters)
    if fan[2]["ingest_features"] != n_files or fan_cpu[2]["ingest_features"]:
        raise AssertionError(f"the fused fan-out launched K1 {fan[2]['ingest_features']} times, "
                             f"not once per recording ({n_files})")
    k1 += fan[2]["ingest_features"]
    text = open(f"{work}/fan.txt").read()
    concat = "\n".join(f"classifier: {n}\n{fan[1][n]}" for n in names) + "\n"
    singles = {}
    for name in names:
        single = run_builder(f"fanout_single_{name}_cuda",
                             f"{base}&fe=dwt-8-fused&train_clf={name}{FANOUT_CONFIG}", None,
                             counters)
        k1 += single[2]["ingest_features"]
        singles[name] = str(single[1]) == str(fan[1][name])
        compare_legs(np, leg_view(fan[0], name), leg_view(fan_cpu[0], name), name,
                     f"fanout5_fused_{name}")
    emit("fanout_fused", legs=list(names), k1_launches=fan[2]["ingest_features"],
         legs_equal_single_runs=singles, result_path_is_concatenation=text == concat,
         train_s=fan[0].timers["train"], wall_stages_s=fan[0].timers)
    if not (all(singles.values()) and text == concat):
        raise AssertionError("the fused fan-out's legs differ from the single card runs")

    # 2. logreg, svm and rf on fe=dwt-8-pallas: one K4 launch over all epochs
    names_p = ("logreg", "svm", "rf")
    q = f"{base}&fe=dwt-8-pallas&classifiers={','.join(names_p)}{FANOUT_CONFIG}"
    fan_p = run_builder("fanout3_pallas_cuda", q, None, counters)
    fan_p_cpu = run_builder("fanout3_pallas_cpu", q, "cpu", counters)
    if fan_p[2]["epoch_features"] != 1 or fan_p_cpu[2]["epoch_features"]:
        raise AssertionError(f"the -pallas fan-out launched K4 {fan_p[2]['epoch_features']} "
                             "times, not once")
    k4 += fan_p[2]["epoch_features"]
    for name in names_p:
        single = run_builder(f"fanout_single_{name}_pallas_cuda",
                             f"{base}&fe=dwt-8-pallas&train_clf={name}{FANOUT_CONFIG}", None,
                             counters)
        k4 += single[2]["epoch_features"]
        compare_legs(np, leg_view(fan_p[0], name), single[0], name,
                     f"fanout3_pallas_{name}_vs_single")
        compare_legs(np, leg_view(fan_p[0], name), leg_view(fan_p_cpu[0], name), name,
                     f"fanout3_pallas_{name}")

    # 3. the bench's 16-member logreg population, batched and looped
    vm, lo = population_pair(np, info, counters, work, POPULATION_ITERS, "population16")
    k1 += vm[2]["ingest_features"] + lo[2]["ingest_features"]
    if lo[0].timers["train"] > LOOPED_LIMIT_S:
        raise AssertionError(f"the looped population trained {lo[0].timers['train']} s, over "
                             f"{LOOPED_LIMIT_S} s")
    q = (f"{base}&fe=dwt-8-fused&train_clf=logreg&{POPULATION_AXES}"
         f"&config_num_iterations={POPULATION_ITERS}&config_step_size=1.0"
         "&config_mini_batch_fraction=1.0")
    pop_cpu = run_builder("population16_vmap_cpu", q, "cpu", counters)
    compare_members(np, torch, vm[0], pop_cpu[0], "population16", linear=True)

    # 4. svm, two Monte-Carlo folds x four seeds at a mini-batch fraction of
    # 0.5 (the full svm config: svm applies config_* only when all four are
    # given, and a live seed axis needs the fraction)
    q = (f"{base}&fe=dwt-8-fused&train_clf=svm&cv=2&cv_mode=mc&seeds=4"
         "&config_num_iterations=100&config_step_size=1.0&config_reg_param=0.01"
         "&config_mini_batch_fraction=0.5")
    svm_runs = {m: run_builder(f"svm_population_{m}_cuda", q + f"&population_mode={m}", None,
                               counters) for m in ("vmap", "looped")}
    svm_cpu = run_builder("svm_population_vmap_cpu", q, "cpu", counters)
    k1 += sum(r[2]["ingest_features"] for r in svm_runs.values())
    seeds = torch.tensor([42, 43, 44, 45])
    ts = torch.arange(1, 101)
    masks_equal = torch.equal(sgd.mini_batch_masks(seeds.cuda(), ts.cuda(), kept, 0.5).cpu(),
                              sgd.mini_batch_masks(seeds, ts, kept, 0.5))
    svm_vm, svm_lo = svm_runs["vmap"], svm_runs["looped"]
    emit("svm_population", members=len(svm_vm[1]), modes=[svm_vm[0].population_block["mode"],
                                                          svm_lo[0].population_block["mode"]],
         vmap_equals_looped=str(svm_vm[1]) == str(svm_lo[1]), member_masks_equal_cpu=masks_equal,
         train_s={m: r[0].timers["train"] for m, r in svm_runs.items()})
    if not (len(svm_vm[1]) == 8 and str(svm_vm[1]) == str(svm_lo[1]) and masks_equal):
        raise AssertionError("the svm population: vmap differs from looped, or its masks "
                             "differ from the CPU's")
    compare_members(np, torch, svm_vm[0], svm_cpu[0], "svm_population", linear=True)

    # 5. nn configuration A, four seeds x two learning rates
    q = f"{base}&fe=dwt-8-fused&train_clf=nn{NN_A}&seeds=4&sweep=lr:0.1,0.05"
    nn_pop = run_builder("nn_population_cuda", q, None, counters)
    nn_pop_cpu = run_builder("nn_population_cpu", q, "cpu", counters)
    k1 += nn_pop[2]["ingest_features"]
    block = nn_pop[0].population_block
    emit("nn_population", members=block["members"], mode=block["mode"],
         train_s=nn_pop[0].timers["train"], cpu_train_s=nn_pop_cpu[0].timers["train"])
    if block["mode"] != "vmap" or block["members"] != 8:
        raise AssertionError(f"the nn population trained {block['mode']}, not vmap")
    compare_members(np, torch, nn_pop[0], nn_pop_cpu[0], "nn_population", linear=False)

    # 6. elastic runs under a device.step fault on the 3rd chunk
    elastic = {}
    for clf, cfg, chunks in (("logreg", "", 10), ("nn", NN_A, 5), ("rf", "", 0)):
        q = f"{base}&fe=dwt-8-fused&train_clf={clf}{cfg}"
        plain = run_builder(f"{clf}_plain_cuda", q, None, counters)
        ck = os.path.join(work, f"ck_{clf}")
        before = obs.metrics.snapshot()["counters"].get("elastic.restarts", 0.0)
        with chaos.faults("device.step:once@3"):
            el = run_builder(f"{clf}_elastic_cuda",
                             q + f"&elastic=true&checkpoint_path={ck}&save_every=1", None,
                             counters)
        restarts = obs.metrics.snapshot()["counters"].get("elastic.restarts", 0.0) - before
        cleared = not os.listdir(ck)
        k1 += plain[2]["ingest_features"] + el[2]["ingest_features"]
        overhead = (el[0].timers["train"] - plain[0].timers["train"]) / chunks if chunks else None
        elastic[clf] = {"restarts": restarts, "chunks": chunks, "cleared": cleared,
                        "train_s": el[0].timers["train"], "plain_train_s": plain[0].timers["train"],
                        "overhead_per_chunk_s": overhead,
                        "statistics_equal_plain": str(el[1]) == str(plain[1])}
        emit("elastic", run=clf, **elastic[clf])
        if not (str(el[1]) == str(plain[1]) and cleared
                and restarts == (1 if chunks else 0)):
            raise AssertionError(f"elastic {clf}: not the plain run's statistics after "
                                 f"{restarts} restarts")

    # 7. nn configuration A with the value-function algorithms, through the
    # builder on the card (train wall, line-search steps), then each
    # optimizer alone on the card run's own rows. The card and CPU builder
    # runs train on rows that K1 and the plain version round apart (by
    # float32 roundoff, largest in relative terms on entries near 0), which
    # an L-BFGS fit amplifies over its updates: that run's deviation is
    # printed, the backtracking run held to the CPU's steps and NN_TOL
    lines = {}
    for algo in ("lbfgs", "line_gradient_descent"):
        q = (f"{base}&fe=dwt-8-fused&train_clf=nn"
             + NN_A.replace("stochastic_gradient_descent", algo))
        label = f"nn_{algo}"
        gpu = run_builder(f"{label}_cuda", q, None, counters)
        cpu = run_builder(f"{label}_cpu", q, "cpu", counters)
        k1 += gpu[2]["ingest_features"]
        history = {"cuda": gpu[0].classifier.linesearch_history,
                   "cpu": cpu[0].classifier.linesearch_history}
        differ = [u for u, (a, b) in enumerate(zip(history["cuda"], history["cpu"]))
                  if a[0] != b[0]]
        alone_steps, alone_dev = optimizer_alone(torch, np, gpu[0], LBFGS_HORIZON)
        rows_dev = (gpu[0].features.cpu() - cpu[0].features).abs()
        lines[label] = {"train_s": gpu[0].timers["train"],
                        "linesearch_steps": gpu[0].classifier.linesearch_steps,
                        "cpu_linesearch_steps": cpu[0].classifier.linesearch_steps,
                        "differing_branches": len(differ),
                        "first_differing_update": differ[0] if differ else None,
                        "max_abs_pred_dev": float(np.abs(nn_predictions(gpu[0])
                                                         - nn_predictions(cpu[0])).max()),
                        "rows_max_abs_dev": float(rows_dev.max()),
                        "rows_max_rel_dev": float((rows_dev / cpu[0].features.abs()
                                                   .clamp(min=1e-30)).max()),
                        "alone_updates": LBFGS_HORIZON,
                        "alone_differing_branches": sum(
                            a != b for a, b in zip(alone_steps["cuda"], alone_steps["cpu"])),
                        "alone_max_abs_pred_dev": alone_dev, "tol": NN_TOL,
                        "cpu_train_s": cpu[0].timers["train"]}
        emit("nn_linesearch", run=label, **lines[label])
        if len(history["cuda"]) != NN_STEPS["a"]:
            raise AssertionError(f"{label}: {len(history['cuda'])} updates, not {NN_STEPS['a']}")
        if not (alone_steps["cuda"] == alone_steps["cpu"]
                and len(alone_steps["cuda"]) == LBFGS_HORIZON and alone_dev <= NN_TOL):
            raise AssertionError(f"{label}: the optimizer on the card parts from the CPU's on "
                                 f"the same rows within {LBFGS_HORIZON} updates")
        if algo != "lbfgs":
            if differ:
                raise AssertionError(f"{label}: the card's line searches branch apart from the "
                                     f"CPU's at update {differ[0]}")
            compare_nn_runs(np, gpu[0], cpu[0], label)
    emit("training_phase", seconds=time.perf_counter() - t_phase, k1_launches=k1,
         k4_launches=k4, population_pair_iterations=POPULATION_ITERS,
         population16_train_s={"vmap": vm[0].timers["train"], "looped": lo[0].timers["train"]},
         elastic=elastic, linesearch=lines)
    return k1, k4


# phase 4f, the seizure workload: CHB-MIT-scale continuous recordings (one
# hour at 256 Hz each), two annotated seizures apiece; two recordings since
# phase 4k came (four before: the phase's runs are host-bound and the whole
# smoke keeps its earlier time)
SEIZURE_FILES = 2
SEIZURE_SAMPLES = 921_600
SEIZURE_INTERVALS = ((200_000, 215_000), (600_000, 616_000))
SEIZURE_MAIN = "task=seizure&window=512&stride=256&fe=dwt-4:level=4:stats=energy,std"
SEIZURE_PALLAS = "task=seizure&window=768&stride=384&fe=dwt-8-pallas"
SEIZURE_SWEEP = ("fe_sweep=dwt-4:level=4:stats=energy,std|dwt-8:level=4:stats=energy,std"
                 "&cv=2&sweep=cost_fn:2,8")
SEIZURE_THRESHOLD = -1.0  # the serve_threshold= run's margin
# the logreg runs' SGD: at the defaults (100 iterations, step 1, reg 0.01)
# the unweighted and the cost_fn=8 model both predict no seizure at this
# 3.4% prevalence; here the costs move recall
SEIZURE_LOGREG = ("&config_num_iterations=200&config_step_size=10.0"
                  "&config_mini_batch_fraction=1.0")


def write_seizure_smoke_session(directory: str, n_files: int) -> str:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import _synthetic

    os.makedirs(directory)
    return _synthetic.write_seizure_session(directory, n_files=n_files,
                                            n_samples=SEIZURE_SAMPLES,
                                            seizure_intervals=SEIZURE_INTERVALS)


def rows_apart(a, b) -> int:
    """Test rows two statistics of the same rows classify apart."""
    return (abs(a.true_positives - b.true_positives) + abs(a.true_negatives - b.true_negatives)
            + abs(a.false_positives - b.false_positives)
            + abs(a.false_negatives - b.false_negatives)) // 2


def compare_sweep_members(np, torch, gpu, cpu, label):
    """An fe_sweep= population's members on the card against the CPU
    run's: equal statistics, or differing test rows within MARGIN_BAND of
    0 on both, each member on its own feature config's rows."""
    if list(gpu.statistics) != list(cpu.statistics):
        raise AssertionError(f"{label}: the member sets differ")
    rows = []
    for m in gpu.statistics:
        fe = int(m.split(".", 1)[0][2:])  # the "fe<i>." label prefix
        g, c = gpu.population_states[m], cpu.population_states[m]
        idx = torch.as_tensor(g["test_index"])
        x_g = gpu.feature_sets[fe][1][idx.to(gpu.features.device)].to(torch.float32)
        x_c = cpu.feature_sets[fe][1][idx].to(torch.float32)
        m_g = (x_g @ g["state"]).double().cpu().numpy()
        m_c = (x_c @ c["state"]).double().numpy()
        differ = np.nonzero((m_g > 0) != (m_c > 0))[0]
        rows += [{"member": m, "row": int(r), "margin_cuda": float(m_g[r]),
                  "margin_cpu": float(m_c[r])} for r in differ]
        if not all(abs(m_g[r]) <= MARGIN_BAND and abs(m_c[r]) <= MARGIN_BAND for r in differ):
            raise AssertionError(f"{label} {m}: members disagree beyond the near-threshold rule")
    emit("population_cpu_parity", run=label, members=len(gpu.statistics),
         statistics_equal=str(gpu.statistics) == str(cpu.statistics), near_threshold_rows=rows)


class ExtractorSpy:
    """Inside ``with``: every ``WaveletTransform.extract_batch`` call
    kept as (extractor, float64 epochs, rows), in call order (a service's
    batcher calls it once a batch, after its warmup window)."""

    def __enter__(self):
        import numpy as np

        from eeg_dataanalysispackage_tpu_torch.features.wavelet import WaveletTransform

        self.cls, self.calls = WaveletTransform, []
        original = self.original = WaveletTransform.extract_batch

        def spy(fe, epochs):
            rows = original(fe, epochs)
            self.calls.append((fe, np.array(epochs, dtype=np.float64), rows.detach().clone()))
            return rows

        WaveletTransform.extract_batch = spy
        return self

    def __exit__(self, *exc):
        self.cls.extract_batch = self.original


def k4_rows_vs_plain(torch, np, calls, label, dev=None):
    """Each (extractor, epochs, rows) call's rows, the epoch-features
    kernel's at that batch shape (rows None: launched here on ``dev``),
    against the plain version on the same float32 windows; returns (the
    largest deviation, the batch sizes)."""
    from eeg_dataanalysispackage_tpu_torch.ops import dwt, dwt_cuda

    worst, sizes = 0.0, []
    for fe, epochs, rows in calls:
        x = torch.from_numpy(np.ascontiguousarray(fe._selected(epochs.astype(np.float32))))
        geometry = (fe.name, fe.skip_samples, fe.epoch_size, fe.feature_size)
        if rows is None:
            rows = dwt_cuda.epoch_features_cuda(x.to(dev), *geometry)
        want = dwt.epoch_features(x.to(rows.device), *geometry)
        if rows.device.type != "cuda" or rows.shape != want.shape:
            raise AssertionError(f"{label}: the rows are not the kernel's on the card")
        worst = max(worst, (rows - want).abs().max().item())
        sizes.append(len(epochs))
    if worst > KERNEL_TOL:
        raise AssertionError(f"{label}: K4 rows disagree with the plain version: {worst}")
    return worst, sizes


def served_margins_vs_batch(np, batch, statistics, served_rows, label):
    """The served windows' margins (``served_rows`` in request order,
    through the batch run's classifier) against the batch run's on its
    test rows, row by row: every row classified apart lies within
    MARGIN_BAND of the threshold on both runs, and the served margins
    give the served statistics' confusion counts."""
    clf, idx = batch.classifier, np.asarray(batch.test_index, dtype=np.int64)
    thr = clf.margin_threshold
    m_s = clf.margin(served_rows).double().cpu().numpy()[idx]
    m_b = margins_on_test_rows(batch)
    y = np.asarray(batch.targets, dtype=np.float64)[idx]
    p = m_s > thr
    counts = (int((p & (y == 1)).sum()), int((~p & (y == 0)).sum()),
              int((p & (y == 0)).sum()), int((~p & (y == 1)).sum()))
    if counts != (statistics.true_positives, statistics.true_negatives,
                  statistics.false_positives, statistics.false_negatives):
        raise AssertionError(f"{label}: the spied rows are not the served ones: {counts}")
    differ = np.nonzero(p != (m_b > thr))[0]
    rows = [{"row": int(idx[r]), "margin_served": float(m_s[r]),
             "margin_batch": float(m_b[r])} for r in differ]
    if not all(abs(m_s[r] - thr) <= MARGIN_BAND and abs(m_b[r] - thr) <= MARGIN_BAND
               for r in differ):
        raise AssertionError(f"{label}: served rows differ beyond the near-threshold rule: "
                             f"{rows}")
    return rows


def phase_seizure(torch, np, counters, work):
    """The seizure workload on the card (task=seizure): a cost-sensitive
    logreg (saved) and its unweighted twin, svm with balanced class
    weights, a four-classifier fan-out (legs byte-equal to single card
    runs with the resolved weights), an fe_sweep= population batched and
    looped (result_path byte-equal), elastic logreg under a device.step
    fault, fe=dwt-8-pallas at 768-sample windows (K4 once over the run's
    windows, rows within KERNEL_TOL of the plain version), load_clf= of
    the saved model; every run against the port's CPU run under phase 4's
    near-threshold rules. Then serve=true on a one-recording session in
    host-extractor mode (statistics byte-equal to the card's batch
    load_clf= run), with fe=dwt-8-pallas (K4 once a batch) and with
    serve_threshold=. Returns (K4 launches over the phase, the largest K4
    row deviation)."""
    from eeg_dataanalysispackage_tpu_torch import obs
    from eeg_dataanalysispackage_tpu_torch.obs import chaos
    from eeg_dataanalysispackage_tpu_torch.ops import dwt

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    info = write_seizure_smoke_session(os.path.join(work, "seizure"), SEIZURE_FILES)
    one = write_seizure_smoke_session(os.path.join(work, "seizure_one"), 1)
    emit("seizure_session", recordings=SEIZURE_FILES, samples_each=SEIZURE_SAMPLES,
         intervals=SEIZURE_INTERVALS, seconds=time.perf_counter() - t0)
    base = f"info_file={info}&{SEIZURE_MAIN}"
    model = os.path.join(work, "seizure_logreg")
    model_p = os.path.join(work, "seizure_logreg_pallas")
    k4 = 0

    def pair(label, query, compare=compare_runs, card_extra=""):
        gpu = run_builder(f"{label}_cuda", query + card_extra, None, counters)
        cpu = run_builder(f"{label}_cpu", query, "cpu", counters)
        if gpu[0].features.device.type != "cuda" or cpu[2]["epoch_features"]:
            raise AssertionError(f"{label}: the card run's rows are not on the card")
        compare(np, gpu[0], cpu[0], label)
        return gpu, cpu

    # 1. cost-sensitive logreg (saved) and the unweighted twin
    costed, _ = pair("seizure_logreg_cost",
                     base + f"&train_clf=logreg{SEIZURE_LOGREG}&cost_fp=1&cost_fn=8",
                     card_extra=f"&save_clf=true&save_name={model}")
    plain, _ = pair("seizure_logreg", base + f"&train_clf=logreg{SEIZURE_LOGREG}")
    workload = costed[0].workload_block
    rows = costed[0].features
    recall = {k: r[1].recall() for k, r in (("cost_fn=8", costed), ("unweighted", plain))}
    emit("seizure_cost", workload=workload, feature_rows=list(rows.shape),
         expected_cost_1_8={"cost_fn=8": costed[1].expected_cost(1, 8),
                            "unweighted": plain[1].expected_cost(1, 8)}, recall=recall)
    if not (workload["windows"] == SEIZURE_FILES * 3599 and 0.01 < workload["class_ratio"] < 0.1
            and tuple(rows.shape) == (SEIZURE_FILES * 3599, 30)
            and bool(torch.isfinite(rows).all())):
        raise AssertionError(f"seizure features or windows are off: {workload}")
    if not (costed[1].extended_report and recall["cost_fn=8"] > (
            0.0 if math.isnan(recall["unweighted"]) else recall["unweighted"])
            and costed[1].expected_cost(1, 8) < plain[1].expected_cost(1, 8)):
        raise AssertionError("cost-sensitive training did not raise recall and lower the "
                             "expected cost")

    # 2. svm with balanced class weights
    pair("seizure_svm_balanced", base + "&train_clf=svm&class_weight=balanced")

    # 3. the four-classifier fan-out, each leg against its single card run
    names = ("logreg", "svm", "rf", "nn")
    q = f"{base}&classifiers={','.join(names)}&cost_fn=8{FANOUT_CONFIG}"
    fan = run_builder("seizure_fanout_cuda", q, None, counters)
    fan_cpu = run_builder("seizure_fanout_cpu", q, "cpu", counters)
    singles = {}
    for name in names:
        single = run_builder(f"seizure_single_{name}_cuda",
                             f"{base}&train_clf={name}&cost_fn=8{FANOUT_CONFIG}", None, counters)
        singles[name] = str(single[1]) == str(fan[1][name])
        compare_legs(np, leg_view(fan[0], name), leg_view(fan_cpu[0], name), name,
                     f"seizure_fanout_{name}")
    weights = {n: fan[0].classifiers[n].config.get("config_weight_pos") for n in names}
    emit("seizure_fanout", legs=list(names), legs_equal_single_runs=singles,
         config_weight_pos=weights, stages_s=fan[0].timers)
    if not all(singles.values()) or set(weights.values()) != {repr(8.0)}:
        raise AssertionError("a seizure fan-out leg differs from its single card run")

    # 4. the fe_sweep= population, batched and looped
    q = f"{base}&train_clf=logreg&{SEIZURE_SWEEP}"
    sweep = {m: run_builder(f"seizure_sweep_{m}_cuda",
                            q + f"&population_mode={m}&result_path={work}/sweep_{m}.txt", None,
                            counters) for m in ("vmap", "looped")}
    sweep_cpu = run_builder("seizure_sweep_vmap_cpu", q, "cpu", counters)
    texts = {m: open(f"{work}/sweep_{m}.txt").read() for m in sweep}
    vm = sweep["vmap"][0]
    emit("seizure_sweep", members=len(vm.statistics), labels=list(vm.statistics),
         modes=[sweep[m][0].population_block["mode"] for m in sweep],
         result_path_equal=texts["vmap"] == texts["looped"],
         train_s={m: sweep[m][0].timers["train"] for m in sweep})
    if not (texts["vmap"] == texts["looped"] and len(vm.statistics) == 8
            and sweep["looped"][0].population_block["mode"] == "looped"):
        raise AssertionError("the fe_sweep= population: batched and looped disagree")
    compare_sweep_members(np, torch, vm, sweep_cpu[0], "seizure_sweep")

    # 5. elastic logreg under a device.step fault on the 3rd chunk
    ck = os.path.join(work, "seizure_ck")
    before = obs.metrics.snapshot()["counters"].get("elastic.restarts", 0.0)
    with chaos.faults("device.step:once@3"):
        el = run_builder("seizure_logreg_elastic_cuda",
                         base + f"&train_clf=logreg{SEIZURE_LOGREG}&elastic=true"
                         f"&checkpoint_path={ck}", None, counters)
    restarts = obs.metrics.snapshot()["counters"].get("elastic.restarts", 0.0) - before
    emit("seizure_elastic", restarts=restarts, cleared=not os.listdir(ck),
         statistics_equal_plain=str(el[1]) == str(plain[1]), train_s=el[0].timers["train"],
         plain_train_s=plain[0].timers["train"])
    if not (str(el[1]) == str(plain[1]) and restarts == 1 and not os.listdir(ck)):
        raise AssertionError("elastic seizure logreg: not the plain run's statistics")

    # 6. fe=dwt-8-pallas at 768-sample windows: K4 once over the run's windows
    q = f"info_file={info}&{SEIZURE_PALLAS}&train_clf=logreg"
    pallas, pallas_cpu = pair("seizure_pallas", q, card_extra=f"&save_clf=true&save_name={model_p}")
    g = pallas[0]
    epochs = torch.from_numpy(np.ascontiguousarray(g.batch.epochs, dtype=np.float32)).to(
        g.features.device)
    err_plain = (g.features - dwt.epoch_features(epochs)).abs().max().item()
    err_cpu = (g.features.cpu() - pallas_cpu[0].features).abs().max().item()
    del epochs
    k4 += pallas[2]["epoch_features"]
    emit("seizure_pallas", epochs=list(g.batch.epochs.shape),
         k4_launches=pallas[2]["epoch_features"], max_abs_err_plain=err_plain,
         max_abs_err_cpu=err_cpu, tol=KERNEL_TOL)
    if not (pallas[2]["epoch_features"] == 1
            and g.batch.epochs.shape == (SEIZURE_FILES * 2399, 3, 768)
            and max(err_plain, err_cpu) <= KERNEL_TOL):
        raise AssertionError("the seizure -pallas run's K4 rows disagree with the plain version")
    k4_err = max(err_plain, err_cpu)

    # 7. load_clf= of the saved model
    pair("seizure_load", base + f"&load_clf=logreg&load_name={model}&cost_fp=1&cost_fn=8")

    # 8. serve=true on a one-recording session: host-extractor mode, then
    # K4 once a batch, then a lowered margin threshold
    served = {}
    for label, fe_part, saved, k4_batch in (("dwt4", SEIZURE_MAIN, model, False),
                                            ("pallas", SEIZURE_PALLAS, model_p, True)):
        q = f"info_file={one}&{fe_part}&load_clf=logreg&load_name={saved}&cost_fp=1&cost_fn=8"
        batch = run_builder(f"seizure_serve_batch_{label}_cuda", q, None, counters)
        with ExtractorSpy() as spy:
            srv = run_builder(f"seizure_serve_{label}_cuda", q + "&serve=true", None,
                              counters)
        block = srv[0].serve_block
        launches = srv[2]["epoch_features"]
        gap = rows_apart(srv[1], batch[1])
        checks = {}
        if k4_batch:
            # every served batch's K4 rows against the plain version, then
            # the served margins against the batch run's row by row (the
            # first spied call is the warmup's window)
            err, sizes = k4_rows_vs_plain(torch, np, spy.calls, "seizure_serve_pallas")
            near = served_margins_vs_batch(
                np, batch[0], srv[1], torch.cat([r for _, _, r in spy.calls[1:]]),
                "seizure_serve_pallas")
            # K4's small kernel at the full serve batch's and the last
            # batch's shapes, on the session's own windows
            windows = batch[0].batch.epochs
            tail = len(windows) % 64 or 64
            err = max(err, k4_rows_vs_plain(
                torch, np, [(batch[0].fe, windows[:64], None), (batch[0].fe, windows[-tail:], None)],
                "seizure_serve_pallas_shapes", batch[0].features.device)[0])
            k4_err = max(k4_err, err)
            checks = {"served_rows_max_abs_err_plain": err, "served_batch_sizes": sizes,
                      "near_threshold_rows": near}
        served[label] = {"statistics_equal_batch": str(srv[1]) == str(batch[1]),
                         "rows_apart": gap, **checks,
                         "mode": block["mode"], "rung": block["rung"],
                         "completed": block["requests"]["completed"],
                         "shed": block["requests"]["shed"],
                         "drained_cleanly": block["drained_cleanly"],
                         "latency_ms": block["latency_ms"],
                         "mean_batch_size": block["mean_batch_size"],
                         "batches": block["batches"], "k4_launches": launches,
                         "stages_s": srv[0].timers}
        emit("seizure_serve", run=label, **served[label])
        n = srv[0].workload_block["windows"]
        ok = (block["mode"] == "host-extractor" and block["requests"]["completed"] == n
              and block["requests"]["shed"] == 0 and block["drained_cleanly"])
        if k4_batch:
            k4 += batch[2]["epoch_features"] + launches
            # the serve batches run K4's small kernel, the batch run its
            # ring kernel: rows may round apart, so flips only near the
            # threshold (served_margins_vs_batch)
            ok = ok and launches == block["batches"] + 1 and len(spy.calls) == launches
        else:
            ok = ok and str(srv[1]) == str(batch[1]) and launches == 0 and n == 3599
        if not ok:
            raise AssertionError(f"seizure serving ({label}) disagrees with the batch run")
    q = (f"info_file={one}&{SEIZURE_MAIN}&load_clf=logreg&load_name={model}&cost_fp=1"
         f"&cost_fn=8&serve=true")
    lowered = run_builder("seizure_serve_threshold_cuda",
                          q + f"&serve_threshold={SEIZURE_THRESHOLD}", None, counters)
    default = run_builder("seizure_serve_default_cuda", q, None, counters)
    emit("seizure_serve_threshold", threshold=SEIZURE_THRESHOLD,
         recall={"lowered": lowered[1].recall(), "default": default[1].recall()},
         positive_predictions={r: s.true_positives + s.false_positives
                               for r, s in (("lowered", lowered[1]), ("default", default[1]))})
    if not lowered[1].recall() >= default[1].recall():
        raise AssertionError("serve_threshold= lowered recall")
    emit("seizure_phase", seconds=time.perf_counter() - t_phase, k4_launches=k4,
         k4_max_abs_err=k4_err)
    return k4, k4_err


def phase_run_record(torch, np, info, model, counters, work):
    """Phase 4g: the feature cache, the run report, fault plans, a
    profiler trace and MLlib directories on the card. Returns (K1
    launches, K2-int8 launches and K4 launches over the phase)."""
    import glob

    from eeg_dataanalysispackage_tpu_torch.io import mllib_format
    from eeg_dataanalysispackage_tpu_torch.obs import chaos

    t_phase = time.perf_counter()
    k1 = k4 = 0
    saved_env = {k: os.environ.get(k) for k in ("EEG_TPU_NO_FEATURE_CACHE",
                                                "EEG_TPU_FEATURE_CACHE_DIR")}
    os.environ.pop("EEG_TPU_NO_FEATURE_CACHE", None)
    os.environ["EEG_TPU_FEATURE_CACHE_DIR"] = os.path.join(work, "feature-cache")
    base = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg"

    def read_json(path):
        with open(path) as f:
            return json.load(f)

    try:
        # 1. the fused main path: miss, hit, cache=false
        miss, miss_stats, launches = run_builder("cache_miss", base, None, counters)
        if launches["ingest_features"] < 1 or miss.backend_resolved["landed"] != "decode":
            raise AssertionError(f"cache miss did not run K1: {launches}")
        k1 += launches["ingest_features"]
        hit, hit_stats, launches = run_builder("cache_hit", base, None, counters)
        if any(launches.values()) or hit.backend_resolved["landed"] != "cache":
            raise AssertionError(f"cache hit launched a kernel: {launches}")
        if (hit.features.device.type != "cuda" or hit.features.dtype != torch.float32
                or not torch.equal(hit.features, miss.features)
                or str(hit_stats) != str(miss_stats)):
            raise AssertionError("cache hit differs from the miss")
        off, off_stats, launches = run_builder("cache_false", base + "&cache=false", None,
                                               counters)
        if launches["ingest_features"] < 1 or str(off_stats) != str(miss_stats):
            raise AssertionError(f"cache=false did not run K1 again: {launches}")
        k1 += launches["ingest_features"]
        emit("cache_fused", miss_s=miss.timers, hit_s=hit.timers,
             entries=len(os.listdir(os.environ["EEG_TPU_FEATURE_CACHE_DIR"])))

        # 2. int8 and its gate (reported), then the hit
        report = os.path.join(work, "report_int8")
        q8 = base + "&precision=int8"
        miss8, stats8, launches = run_builder("cache_miss_int8", q8 + f"&report={report}",
                                              None, counters)
        if launches["ingest_features_int8"] < 1:
            raise AssertionError(f"int8 miss did not run K2-int8: {launches}")
        k1 += launches["ingest_features"]  # the gate's f32 rows
        k1_int8 = launches["ingest_features_int8"]
        hit8, hit8_stats, launches = run_builder("cache_hit_int8", q8, None, counters)
        if (any(launches.values()) or str(hit8_stats) != str(stats8)
                or hit8.precision_resolved["gate"] != {"source": "cache"}):
            raise AssertionError(f"int8 hit: {launches}, {hit8.precision_resolved}")
        rep = read_json(os.path.join(report, "run_report.json"))
        if (rep["device"]["name"] != torch.cuda.get_device_name(0)
                or rep["device"]["platform"] != "gpu" or rep["backend"]["landed"] != "decode"
                or rep["precision"]["used"] != "int8"):
            raise AssertionError(f"int8 report: {rep['device']}, {rep['backend']}")
        emit("report_int8", device=rep["device"], backend=rep["backend"],
             precision=rep["precision"], stages=rep["stages"], caches=rep["caches"])

        # 3. the seizure -pallas pair (reported)
        seizure = write_seizure_smoke_session(os.path.join(work, "cache_seizure"), 1)
        qs = f"info_file={seizure}&{SEIZURE_PALLAS}&train_clf=logreg{SEIZURE_LOGREG}"
        report_s = os.path.join(work, "report_seizure")
        smiss, smiss_stats, launches = run_builder(
            "cache_miss_seizure", qs + f"&report={report_s}", None, counters)
        if launches["epoch_features"] != 1:
            raise AssertionError(f"seizure miss: K4 {launches}")
        k4 += 1
        shit, shit_stats, launches = run_builder("cache_hit_seizure", qs, None, counters)
        if (any(launches.values()) or str(shit_stats) != str(smiss_stats)
                or shit.features.device.type != "cuda"
                or not torch.equal(shit.features, smiss.features)):
            raise AssertionError(f"seizure hit: {launches}")
        rep = read_json(os.path.join(report_s, "run_report.json"))
        if rep["workload"] is None or rep["classification"] is None:
            raise AssertionError("seizure report lacks its workload or classification block")
        emit("report_seizure", workload=rep["workload"], classification=rep["classification"])
        os.environ["EEG_TPU_NO_FEATURE_CACHE"] = "1"  # the rest counts real launches

        # 4. faults: an ingest fault fails the run and leaves a crash report;
        # serve faults are retried
        crash_dir = os.path.join(work, "report_crash")
        try:
            run_builder("fault_ingest", base + f"&faults=ingest.fused:once@1&report={crash_dir}",
                        None, counters)
        except chaos.ChaosInjectedError:
            pass
        else:
            raise AssertionError("faults=ingest.fused:once@1 did not fail the run")
        crash = read_json(os.path.join(crash_dir, "crash_report.json"))
        if crash["chaos"]["rules"] != {"ingest.fused": {"calls": 1, "fired": 1}}:
            raise AssertionError(f"crash report: {crash['chaos']}")
        small = os.path.join(work, "fault_session")
        os.makedirs(small)
        small_info = write_session(small, n_files=2, n_markers=300)
        load = f"info_file={small_info}&fe=dwt-8-fused&load_clf=logreg&load_name={model}"
        batch, batch_stats, _ = run_builder("fault_batch", load, None, counters)
        served, served_stats, launches = run_builder(
            "fault_serve", load + "&serve=true&faults=serve.request:once@4;serve.batch:once@2"
            + f"&report={os.path.join(work, 'report_serve')}", None, counters)
        rules = read_json(os.path.join(work, "report_serve", "run_report.json"))["chaos"]["rules"]
        if (str(served_stats) != str(batch_stats)
                or any(r["fired"] != 1 for r in rules.values())):
            raise AssertionError(f"faulted serve run: {rules}")
        emit("faults", crash_rules=crash["chaos"]["rules"], serve_rules=rules,
             retries=served.serve_block["requests"]["retries"])

        # 5. MLlib model directories on the card
        mdir = os.path.join(work, "mllib_logreg")
        save = base + f"&save_clf=true&config_model_format=mllib&save_name={mdir}"
        try:
            mllib_format._pq()
            has_pyarrow = True
        except ImportError as e:
            has_pyarrow, message = False, str(e)
        if has_pyarrow:
            _b, _s, launches = run_builder("mllib_save", save, None, counters)
            k1 += launches["ingest_features"]
            mload = f"info_file={info}&fe=dwt-8-fused&load_clf=logreg&load_name={mdir}"
            lb, lstats, launches = run_builder("mllib_load", mload, None, counters)
            k1 += launches["ingest_features"]
            _sb, sstats, launches = run_builder("mllib_serve", mload + "&serve=true", None,
                                                counters)
            k1 += launches["ingest_features"]  # featurize+host: K1 a batch
            if str(sstats) != str(lstats):
                raise AssertionError("served imported model differs from its batch run")
            emit("mllib", pyarrow=True, weights_dtype=str(lb.classifier.model.weight.dtype))
        else:
            os.makedirs(os.path.join(mdir, "metadata"))
            with open(os.path.join(mdir, "metadata", "part-00000"), "w") as f:
                f.write(json.dumps({"class": mllib_format.GLM_LOGREG, "version": "1.0"}) + "\n")
            refused = []
            for label, query in (("mllib_save", save.replace(mdir, mdir + "_new")),
                                 ("mllib_load", f"info_file={info}&fe=dwt-8-fused"
                                  f"&load_clf=logreg&load_name={mdir}")):
                try:
                    run_builder(label, query, None, counters)
                except ImportError as e:
                    refused.append(str(e) == message)
                else:
                    raise AssertionError(f"{label} ran without pyarrow")
                # the save run featurized and trained before its save refused
                k1 += getattr(*counters["ingest_features"])
            if not all(refused):
                raise AssertionError("MLlib refusal is not the pyarrow message")
            emit("mllib", pyarrow=False, message=message)
        # 6. a profiler trace holds K1's record
        trace_dir = os.path.join(work, "trace")
        _b, _s, launches = run_builder("trace", base + f"&trace_path={trace_dir}", None,
                                       counters)
        k1 += launches["ingest_features"]
        (trace,) = glob.glob(os.path.join(trace_dir, "torch-trace-*.json"))
        kernels = {e["name"] for e in read_json(trace)["traceEvents"]
                   if e.get("cat") == "kernel"}
        if not any("ingest_features_kernel" in name for name in kernels):
            raise AssertionError(f"the trace holds no K1 record: {sorted(kernels)[:10]}")
        emit("trace", kernel_records=sorted(k for k in kernels if "features" in k),
             bytes=os.path.getsize(trace))

    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    emit("run_record_phase", seconds=time.perf_counter() - t_phase, k1_launches=k1,
         k1_int8_launches=k1_int8, k4_launches=k4)
    return k1, k1_int8, k4


def trace_overlap(events):
    """From a Chrome trace's events: K1's records, the consumer's streams
    (where the run's rows are concatenated), K1's records on another
    stream, the host-to-device copies and those from pinned memory, and
    whether any such copy overlapped a K1 record in time."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "ingest_features_kernel" in e["name"]]
    consumer = sorted({e["args"]["stream"] for e in kernels if "CatArray" in e["name"]})
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]
    overlapped = sum(any(c["ts"] < k["ts"] + k["dur"] and k["ts"] < c["ts"] + c["dur"]
                         for k in k1) for c in h2d)
    return {"k1_records": len(k1), "consumer_streams": consumer,
            "k1_streams": sorted({e["args"]["stream"] for e in k1}),
            "k1_off_consumer_stream": sum(e["args"]["stream"] not in consumer for e in k1),
            "h2d_copies": len(h2d), "h2d_pinned": sum("Pinned" in e["name"] for e in h2d),
            "h2d_overlapping_k1": overlapped, "any_copy_overlapped_k1": overlapped > 0}


def phase_input_pipeline(torch, np, info, model, counters, work):
    """Phase 4h: the input pipeline on the card, every run with
    ``cache=false``. The fused logreg run at ``ingest_workers=1`` and
    ``=4``, each serial and with ``overlap=true`` at ``prefetch=1``, 2 and
    5 (features bit-equal on the card, statistics byte-equal, K1 once a
    recording); the overlapped run under ``trace_path=`` (K1's streams and
    the pinned copies, printed for the record); ``faults=staging.producer``
    under overlap (the run fails, ``crash_report.json`` fired 1); the host
    ``fe=dwt-8-pallas`` run with the native epoch stage and with
    ``EEG_TPU_NATIVE=0`` (epochs bit-equal, statistics byte-equal, K4 as
    often); ``serve=true`` at ``ingest_workers=4`` against ``=1``; three
    recordings on the loopback store at ``ingest_workers=4`` against
    ``=1``; ``stage_raw`` alone, pinned against a pageable copy. Returns
    (K1, K4 and K5 launches over the phase)."""
    import glob

    from eeg_dataanalysispackage_tpu_torch import obs
    from eeg_dataanalysispackage_tpu_torch.io import circuit
    from eeg_dataanalysispackage_tpu_torch.obs import chaos, events
    from eeg_dataanalysispackage_tpu_torch.ops import ingest_cuda, serve_mega_cuda
    from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import _loopback

    t_phase = time.perf_counter()
    k1 = k4 = k5 = 0
    base = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&cache=false"

    def read_json(path):
        with open(path) as f:
            return json.load(f)

    # 1. the parse pool and overlap: 2 pool sizes x (serial, 3 depths)
    ref, table = None, {}
    for workers in (1, 4):
        for overlap, depth in (("false", None), ("true", 1), ("true", 2), ("true", 5)):
            label = f"inpipe_w{workers}_" + ("serial" if depth is None else f"overlap_p{depth}")
            q = base + f"&ingest_workers={workers}&overlap={overlap}"
            if depth is not None:
                q += f"&prefetch={depth}"
            t0 = time.perf_counter()
            b, st, launches = run_builder(label, q, None, counters)
            wall = time.perf_counter() - t0
            if launches["ingest_features"] != 8 or b.overlap_resolved is not (overlap == "true"):
                raise AssertionError(f"{label}: K1 {launches['ingest_features']} times, not 8, "
                                     f"or overlap {b.overlap_resolved}")
            k1 += launches["ingest_features"]
            if ref is None:
                ref = b
            elif not torch.equal(b.features, ref.features) or str(st) != str(ref.statistics):
                raise AssertionError(f"{label}: features or statistics differ from the "
                                     "serial pool-of-one run")
            table[label] = {"wall_s": wall, "timers": dict(b.timers)}
    emit("input_pipeline_runs", runs=table, features_bit_equal=True, statistics_equal=True)

    # 2. the overlapped run under a trace: K1's streams and the copies
    trace_dir = os.path.join(work, "inpipe_trace")
    _b, _s, launches = run_builder("inpipe_trace", base + "&ingest_workers=4&overlap=true"
                                   f"&trace_path={trace_dir}", None, counters)
    k1 += launches["ingest_features"]
    (trace,) = glob.glob(os.path.join(trace_dir, "torch-trace-*.json"))
    emit("overlap_trace", **trace_overlap(read_json(trace)["traceEvents"]))

    # 3. a staging.producer fault under overlap fails the run
    crash_dir = os.path.join(work, "inpipe_crash")
    for module, attr in counters.values():
        setattr(module, attr, 0)
    try:
        PipelineBuilder(base + "&overlap=true&faults=staging.producer:once@1"
                        f"&report={crash_dir}").execute()
    except chaos.ChaosInjectedError as e:
        raised = str(e)
    else:
        raise AssertionError("faults=staging.producer under overlap did not fail the run")
    k1 += ingest_cuda.LAUNCHES
    rules = read_json(os.path.join(crash_dir, "crash_report.json"))["chaos"]["rules"]
    if rules["staging.producer"]["fired"] != 1:
        raise AssertionError(f"staging.producer crash report: {rules}")
    emit("staging_producer_fault", raised=raised, rules=rules)

    # 4. the native epoch stage against the numpy paths on the card's host
    pallas_q = f"info_file={info}&fe=dwt-8-pallas&train_clf=logreg&cache=false"
    nat, nat_stats, nat_launches = run_builder("inpipe_pallas_native", pallas_q, None, counters)
    os.environ["EEG_TPU_NATIVE"] = "0"
    try:
        plain, plain_stats, plain_launches = run_builder("inpipe_pallas_numpy", pallas_q, None,
                                                         counters)
    finally:
        os.environ.pop("EEG_TPU_NATIVE")
    epochs_equal = bool(np.array_equal(nat.batch.epochs, plain.batch.epochs)
                        and np.array_equal(nat.batch.targets, plain.batch.targets))
    emit("native_epoch_stage", epochs_bit_equal=epochs_equal,
         statistics_equal=str(nat_stats) == str(plain_stats),
         epoch_s_native=nat.timers["epoch"], epoch_s_numpy=plain.timers["epoch"],
         parse_s_native=nat.timers["parse"], parse_s_numpy=plain.timers["parse"],
         k4_native=nat_launches["epoch_features"], k4_numpy=plain_launches["epoch_features"])
    if (not epochs_equal or str(nat_stats) != str(plain_stats)
            or nat_launches["epoch_features"] != plain_launches["epoch_features"]
            or nat_launches["epoch_features"] < 1):
        raise AssertionError("the native epoch stage differs from the numpy paths")
    k4 += nat_launches["epoch_features"] + plain_launches["epoch_features"]

    # 5. serve=true with the pool of four against the pool of one
    serve_q = (f"info_file={info}&fe=dwt-8-fused&load_clf=logreg&load_name={model}"
               "&serve=true&cache=false")
    served = {}
    for workers in (1, 4):
        for module, attr in counters.values():
            setattr(module, attr, 0)
        serve_mega_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        sb = PipelineBuilder(serve_q + f"&ingest_workers={workers}")
        served[workers] = str(sb.execute())
        k1 += ingest_cuda.LAUNCHES
        k5 += serve_mega_cuda.LAUNCHES
        emit("inpipe_serve", ingest_workers=workers, wall_s=time.perf_counter() - t0,
             rung=sb.serve_block["rung"], serve_mega_launches=serve_mega_cuda.LAUNCHES,
             stages_s=sb.timers)
        if serve_mega_cuda.LAUNCHES == 0:
            raise AssertionError("the serve run did not launch the megakernel")
    if served[1] != served[4]:
        raise AssertionError("serve=true at ingest_workers=4 differs from =1")

    # 6. three recordings on the loopback store, the pool on
    circuit.reset()
    with _loopback.Server() as srv:
        directory = os.path.dirname(info)
        with open(info) as f:
            lines = f.read().splitlines()[:3]
        srv.store.files["/data3/info.txt"] = ("\n".join(lines) + "\n").encode()
        for line in lines:
            stem = os.path.splitext(line.split()[0])[0]
            for ext in (".vhdr", ".vmrk", ".eeg"):
                with open(os.path.join(directory, stem + ext), "rb") as f:
                    srv.store.files[f"/data3/{stem}{ext}"] = f.read()
        remote_q = (f"info_file=hdfs://{srv.authority}/data3/info.txt&fe=dwt-8-fused"
                    "&train_clf=logreg&cache=false")
        remote = {}
        recorder = events.SpanRecorder("inpipe_remote")
        with events.recording(recorder), obs.metrics.scope() as m:
            for workers in (1, 4):
                b, st, launches = run_builder(f"inpipe_remote_w{workers}",
                                              remote_q + f"&ingest_workers={workers}", None,
                                              counters)
                remote[workers] = (b, str(st))
                k1 += launches["ingest_features"]
        retries = sum(e["name"] == "remote.retry" for e in recorder.recent_events())
        equal = (remote[1][1] == remote[4][1]
                 and torch.equal(remote[1][0].features, remote[4][0].features))
        emit("inpipe_remote", recordings=3, statistics_equal=equal, retries=retries,
             parallel_workers=m.snapshot()["gauges"].get("ingest.parallel_workers"),
             parse_s={w: remote[w][0].timers["parse"] for w in remote})
        if not equal or retries:
            raise AssertionError("the remote run at ingest_workers=4 differs from =1")
    circuit.reset()

    # 7. stage_raw alone over the session: pinned, non-blocking copies
    # against a pageable copy (the staging before this phase's slice), in
    # turns, each pass of 8 recordings ending in a sync; the staged
    # tensors equal
    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
    from eeg_dataanalysispackage_tpu_torch.ops import device_ingest

    odp = OfflineDataProvider([info], workers=4)
    recs = [(rec, odp.channel_indices_for(rec)) for _rel, _g, rec in odp.iter_recordings()]
    dev = odp.device

    def pageable(rec, idx):
        raw = rec.raw_int16(idx)
        staged = torch.empty((raw.shape[0], device_ingest._round_capacity(raw.shape[1], 16384)),
                             dtype=torch.int16, device=dev)
        staged[:, :raw.shape[1]].copy_(torch.from_numpy(raw))
        staged[:, raw.shape[1]:].zero_()
        return staged

    paths = {"pageable": pageable, "pinned": lambda rec, idx: device_ingest.stage_raw(
        rec, idx, dev)[0]}
    stage_s = {name: [] for name in paths}
    for name in ("pageable", "pinned", "pinned", "pageable") * 3:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged = [paths[name](rec, idx) for rec, idx in recs]
        torch.cuda.synchronize()
        stage_s[name].append(time.perf_counter() - t0)
        if not all(torch.equal(a, paths["pageable"](*r)) for a, r in zip(staged, recs)):
            raise AssertionError(f"stage_raw ({name}) staged other bytes")
    emit("stage_raw_alone", recordings=len(recs), seconds=stage_s,
         median_s={k: pystats.median(v) for k, v in stage_s.items()})
    emit("input_pipeline_phase", seconds=time.perf_counter() - t_phase, k1_launches=k1,
         k4_launches=k4, serve_mega_launches=k5)
    return k1, k4, k5


# phase 4i: the population axes of the meshed builder runs (4 members), the
# engine-level member counts, the tolerances (measured: PERF.md, PR 20)
MESH_POP_AXES = "cv=2&sweep=lr:1.0,0.5"
MESH_MEMBERS = (4, 16)
MESH_WEIGHT_TOL = 5e-6  # sharded against unsharded member weights (the JAX package's)
MESH_SGD_TOL = 2e-5  # data-parallel SGD against the unmeshed run (the JAX package's)
MESH_LOSS_TOL = 1e-5  # 20 steps' losses, card against CPU
MESH_STEPS = 20


def mesh_shards(torch):
    """The 4-shard mesh's devices: four distinct cards where there are
    four, else the first card four times."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i if count >= 4 else 0) for i in range(4)], count


def train_losses(torch, init, step, params, args, steps=MESH_STEPS):
    """``steps`` steps of a ``parallel/train.py`` step from ``params``;
    (final state, losses)."""
    state, losses = init(params), []
    for _ in range(steps):
        state, loss = step(state, *args)
        losses.append(float(loss))
    return state, losses


def phase_mesh(torch, np, info, counters):
    """Phase 4i (see the module docstring). Returns (K1 launches,
    K2-bf16 launches) over the phase's path runs; the launches made to
    compare a kernel with its plain version, or a path with the unmeshed
    one, are not counted."""
    from eeg_dataanalysispackage_tpu_torch import obs
    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
    from eeg_dataanalysispackage_tpu_torch.models import sgd, trees, trees_device as td
    from eeg_dataanalysispackage_tpu_torch.ops import device_ingest, dwt, ingest_cuda
    from eeg_dataanalysispackage_tpu_torch.parallel import (
        mesh as pmesh, population as engines, train as ptrain,
    )
    from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
    from eeg_dataanalysispackage_tpu_torch.utils import java_compat

    t_phase = time.perf_counter()
    shards, count = mesh_shards(torch)
    emit("mesh_devices", cards=count, four_shard_mesh=[str(d) for d in shards],
         distinct_cards=count >= 4)
    k1 = k1_bf16 = 0

    # 1. the builder: devices=1 (and devices=<cards>) against the unmeshed run
    base = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&{MESH_POP_AXES}&cache=false"
    _b, plain, _launches = run_builder("mesh_unmeshed", base, None, counters)
    for label, extra in [("mesh_devices1", "&devices=1")] + (
            [(f"mesh_devices{count}", f"&devices={count}")] if count >= 2 else []):
        b, st, launches = run_builder(label, base + extra, None, counters)
        k1 += launches["ingest_features"]
        if str(st) != str(plain) or b.population_block["mode"] != "sharded":
            raise AssertionError(f"{label}: statistics differ from the unmeshed run's")
        emit("mesh_run", run=label, mesh=b.mesh_resolved, statistics_equal=True)
    for extra, match in ((f"&devices={count + 1}", "present"),
                         ("&processes=2", "no coordinator address")):
        try:
            PipelineBuilder(base + extra).execute()
        except (ValueError, ConnectionError) as e:
            if match not in str(e):
                raise
        else:
            raise AssertionError(f"{extra} did not raise")
    mesh4_time = pmesh.make_mesh(devices=shards, axes=("time",))
    mesh4 = pmesh.make_mesh(devices=shards)

    # 2. the sharded fused ingest of the session, 4 shards; walls in turns
    # (unsharded, sharded, sharded, unsharded), the second pair uncounted
    def load(mesh=None):
        t0 = time.perf_counter()
        out = OfflineDataProvider([info]).load_features_device(mesh=mesh)
        return out, time.perf_counter() - t0

    (ref, ref_targets), unsharded_s = load()
    cpu_rows, _ = OfflineDataProvider([info], device="cpu").load_features_device()
    before = obs.metrics.snapshot()["counters"]
    ingest_cuda.LAUNCHES = 0
    (got, got_targets), sharded_s = load(mesh4_time)
    launches = ingest_cuda.LAUNCHES
    k1 += launches
    after = obs.metrics.snapshot()["counters"]
    grew = {k: after.get(k, 0) - before.get(k, 0) for k in (
        "ingest.sharded_recordings", "ingest.sharded_halo_windows", "ingest.sharded_fallback")}
    sharded_again_s = load(mesh4_time)[1]
    ingest_wall = {"unsharded_s": [unsharded_s, load()[1]],
                   "sharded_s": [sharded_s, sharded_again_s]}
    dev_unsharded = (got - ref).abs().max().item()
    dev_plain = (got.cpu() - cpu_rows).abs().max().item()
    rows_bit_equal = int((got == ref).all(dim=1).sum())
    emit("mesh_sharded_ingest", rows=int(got.shape[0]), launches=launches, counters=grew,
         max_abs_vs_unsharded=dev_unsharded, rows_bit_equal=rows_bit_equal,
         max_abs_vs_plain=dev_plain, tol=KERNEL_TOL, **ingest_wall)
    if (not np.array_equal(got_targets, ref_targets) or launches != 32
            or grew["ingest.sharded_recordings"] != 8 or grew["ingest.sharded_halo_windows"] < 1
            or max(dev_unsharded, dev_plain) > KERNEL_TOL):
        raise AssertionError("the sharded ingest disagrees with the unsharded kernel")

    # 3. the sharded population engine against the unsharded one
    n = len(ref_targets)
    train = java_compat.train_test_split_indices(n, seed=1)[0]
    x = ref[torch.as_tensor(train, device=ref.device)]
    y = torch.as_tensor(ref_targets[train], dtype=torch.float32, device=ref.device)
    cfg = sgd.SGDConfig(num_iterations=200, convergence_tol=0.0)
    pops = {}
    for p in MESH_MEMBERS:
        steps = [1.0 / (1 + i % 4) for i in range(p)]
        regs = [0.0, 0.01] * (p // 2)
        seeds = list(range(p))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w_sharded = engines.train_linear_population_sharded(x, y, cfg, steps, regs, seeds, None,
                                                            mesh4)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        w_single, _, _ = engines.train_linear_population(x, y, cfg, steps, regs, seeds, None)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pops[p] = {"max_abs": (w_sharded - w_single).abs().max().item(),
                   "sharded_s": t1 - t0, "unsharded_s": t2 - t1}
    emit("mesh_population", members=pops, tol=MESH_WEIGHT_TOL, iterations=200)
    if max(v["max_abs"] for v in pops.values()) > MESH_WEIGHT_TOL:
        raise AssertionError("the sharded population disagrees with the unsharded engine")

    # 4. tree-parallel growth, bit-equal
    rows = x.double().cpu().numpy()
    binned = torch.as_tensor(trees.bin_features(rows, trees.compute_bin_edges(rows, 32)),
                             device=ref.device)
    labels = y.long()
    n_trees = 22
    boot = torch.as_tensor(np.random.RandomState(3).randint(0, len(train), (n_trees, len(train))),
                           device=ref.device)
    masks = torch.as_tensor(td.draw_feature_masks(n_trees, td.n_heap_nodes(4), x.shape[1], 7),
                            device=ref.device)
    kw = dict(max_bins=32, impurity="gini", max_depth=5, min_instances=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forest = td.grow_forest_sharded(binned, labels, boot, masks, mesh=mesh4, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = td.grow_forest(binned, labels, boot, masks, **kw)
    torch.cuda.synchronize()
    forest_equal = all(torch.equal(forest[k], want[k]) for k in want)
    emit("mesh_forest", trees=n_trees, bit_equal=forest_equal, sharded_s=t1 - t0,
         unsharded_s=time.perf_counter() - t1)
    if not forest_equal:
        raise AssertionError("grow_forest_sharded differs from grow_forest")

    # 5. data-parallel SGD against the unmeshed run
    w_dp = sgd.train_linear(x, y, sgd.SGDConfig(num_iterations=100), mesh=mesh4)
    w_1 = sgd.train_linear(x, y, sgd.SGDConfig(num_iterations=100))
    sgd_dev = (w_dp.to(w_1.device) - w_1).abs().max().item()
    emit("mesh_sgd", max_abs=sgd_dev, tol=MESH_SGD_TOL)
    if sgd_dev > MESH_SGD_TOL:
        raise AssertionError("data-parallel SGD disagrees with the unmeshed run")

    # 6. the raw-stream trainers (K2's call sites), card against the CPU
    rng = np.random.RandomState(20)
    n_reg, stride, first = 2048, 800, 150
    S = first + n_reg * stride + 1024
    raw = (rng.randint(-3000, 3000, size=(3, S)) + np.array([[1500], [-900], [400]])
           ).astype(np.int16)
    res = np.array([0.1, 0.1, 0.2], np.float32)
    reg_labels = rng.randint(0, 2, size=n_reg).astype(np.float32)
    positions = np.sort(rng.choice(np.arange(200, S - 900), size=4096, replace=False))
    irr_labels = rng.randint(0, 2, size=4096).astype(np.float32)
    params = {k: v.numpy() for k, v in ptrain.init_mlp_params(0, device="cpu").items()}
    raw_card = torch.from_numpy(raw).cuda()
    trainers = {}
    for label, make, args in (
        ("raw_bank", lambda d, mesh=None: ptrain.make_raw_train_step(
            stride, n_reg, formulation="bank", device=d, mesh=mesh),
         (res, reg_labels, np.ones(n_reg, np.float32), first)),
        ("irregular_bank128", lambda d, mesh=None: ptrain.make_irregular_bank_train_step(
            positions, mode="bank128", device=d, mesh=mesh), (res, irr_labels)),
        ("irregular_bank128_bf16", lambda d, mesh=None: ptrain.make_irregular_bank_train_step(
            positions, mode="bank128_bf16", device=d, mesh=mesh), (res, irr_labels)),
    ):
        for module, attr in counters.values():
            setattr(module, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _state, card_losses = train_losses(torch, *make("cuda"), params, (raw_card, *args))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: getattr(m, a) for k, (m, a) in counters.items()}
        _state, cpu_losses = train_losses(torch, *make("cpu"), params,
                                          (torch.from_numpy(raw), *args))
        loss_dev = float(np.max(np.abs(np.array(card_losses) - np.array(cpu_losses))))
        record = {"wall_s": wall, "launches": launched, "loss_max_abs_vs_cpu": loss_dev,
                  "first_loss": card_losses[0], "last_loss": card_losses[-1]}
        precision = "bf16" if label.endswith("bf16") else "f32"
        counter = "ingest_features_bf16" if precision == "bf16" else "ingest_features"
        if label == "raw_bank":
            starts = first - 100 + stride * np.arange(n_reg)
        else:
            starts = positions - 100
        starts_t = torch.as_tensor(starts.astype(np.int32))
        W = dwt.kernel_operator(8, 512, 16, "cpu")
        plain = device_ingest.ingest_features_plain(torch.from_numpy(raw), torch.from_numpy(res),
                                                    starts_t, W, precision=precision)
        kernel = ingest_cuda.ingest_features(raw_card, torch.from_numpy(res).cuda(),
                                             starts_t.cuda(), W.cuda(), precision=precision)
        record["rows_max_abs_vs_plain"] = (kernel.cpu() - plain).abs().max().item()
        if label == "irregular_bank128":
            for module, attr in counters.values():
                setattr(module, attr, 0)
            _s, mesh_losses = train_losses(torch, *make("cuda", mesh4), params, (raw_card, *args))
            record["data_parallel_launches"] = ingest_cuda.LAUNCHES
            record["data_parallel_loss_max_abs"] = float(
                np.max(np.abs(np.array(mesh_losses) - np.array(card_losses))))
            if record["data_parallel_launches"] != MESH_STEPS:
                raise AssertionError("the data-parallel bank128 step did not launch K1 each step")
            k1 += MESH_STEPS
        trainers[label] = record
        if (launched[counter] != MESH_STEPS or loss_dev > MESH_LOSS_TOL
                or record["rows_max_abs_vs_plain"] > KERNEL_TOL
                or record.get("data_parallel_loss_max_abs", 0.0) > MESH_LOSS_TOL
                or not card_losses[-1] < card_losses[0]):
            emit("mesh_trainers", trainers=trainers, loss_tol=MESH_LOSS_TOL, tol=KERNEL_TOL)
            raise AssertionError(f"{label}: launches, rows or losses off")
        if precision == "bf16":
            k1_bf16 += launched[counter]
        else:
            k1 += launched[counter]
    emit("mesh_trainers", trainers=trainers, loss_tol=MESH_LOSS_TOL, tol=KERNEL_TOL)
    emit("mesh_phase", seconds=time.perf_counter() - t_phase, k1_launches=k1,
         k1_bf16_launches=k1_bf16)
    return k1, k1_bf16


POD_QUERY = "fe=dwt-8-fused&train_clf=logreg&cv=2&sweep=lr:1.0,0.5&cache=false"
POD_FOUR_QUERY = ("fe=dwt-8-fused&train_clf=logreg&cv=4&sweep=lr:1.0,0.5;reg:0.0,0.01"
                  "&config_num_iterations=200&cache=false")
STREAM_CHANNELS, STREAM_SAMPLES = 256, 65_536  # BASELINE config 5's width, ~64 s at 1 kHz
STREAM_TOL = 2e-5  # card against the CPU port: float32 contractions, summation order


def session_size(info) -> int:
    """The recordings an info.txt lists."""
    with open(info) as f:
        return sum(1 for line in f if line.strip())


def run_ranks(query, n, visible=None):
    """``n`` ranks of ``query`` through ``pod.spawn_pod_member`` on a
    loopback coordinator (``visible``: each rank's CUDA_VISIBLE_DEVICES);
    their JSON results in rank order and the wall from spawn to the last
    result. Every rank is bounded; stragglers are killed."""
    from eeg_dataanalysispackage_tpu_torch.parallel import distributed, pod

    port = distributed.free_port_pair()
    t0 = time.perf_counter()
    procs = [pod.spawn_pod_member(query, f"127.0.0.1:{port}", n, r, timeout_s="120",
                                  visible_devices=None if visible is None else visible[r])
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"pod rank failed ({p.returncode}):\n{err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs, time.perf_counter() - t0


def check_ranks(label, outs, stats_text, rows_sha, owned, backend, wall):
    """Each rank's K1 launches equal to its owned recordings, its
    exchanged matrix the one-process kernel's rows bit for bit, its
    statistics the one-process card run's, its backend; one line a rank."""
    import hashlib

    want_sha = hashlib.sha256(stats_text.encode()).hexdigest()
    for pid, o in enumerate(outs):
        rank = {"k1_launches": o["k1"], "owned_recordings": owned[pid],
                "rows_bit_equal": o["features_sha256"] == rows_sha,
                "statistics_sha_equal": o["sha"] == want_sha,
                "backend": o["mesh"]["backend"], "wall_s": o["wall_s"],
                "exchange_s": o["timers"].get("exchange"), "timers_s": o["timers"],
                "exchange_bytes": o["metrics"].get("pod.exchange_bytes")}
        emit("pod_rank", run=label, rank=pid, processes=len(outs), spawn_wall_s=wall, **rank)
        if (o["k1"] != owned[pid] or not rank["rows_bit_equal"]
                or not rank["statistics_sha_equal"] or rank["backend"] != backend
                or o["mesh"]["rung"] != "pod"):
            raise AssertionError(f"{label}: rank {pid} disagrees with the one-process run")
    return sum(o["k1"] for o in outs)


def first_card(torch, n):
    """``n`` shards of the first card."""
    return [torch.device("cuda", 0)] * n


def run_distributed_worker(params_path):
    """The two ranks of ``tests/_torch_distributed_worker.py`` on the card
    (loopback coordinator, env-driven bootstrap); their JSON results and
    the wall from spawn to the last result."""
    from eeg_dataanalysispackage_tpu_torch.parallel import distributed

    port = distributed.free_port_pair()
    t0 = time.perf_counter()
    procs = []
    for pid in range(2):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "_torch_distributed_worker.py"),
             params_path, "cuda"], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"distributed worker failed:\n{err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs, time.perf_counter() - t0


def phase_pod(torch, np, info, counters, work):
    """Phase 4j (see the module docstring). Returns the K1 launches of the
    phase's path runs: the one-process runs here and every rank's own."""
    import hashlib

    from eeg_dataanalysispackage_tpu_torch.models import sgd
    from eeg_dataanalysispackage_tpu_torch.parallel import (
        mesh as pmesh, pod, population, sharded_ingest, streaming, train as ptrain,
    )

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    emit("pod_devices", cards=count, nccl_available=torch.distributed.is_nccl_available(),
         gloo_available=torch.distributed.is_gloo_available())
    k1 = 0
    n_files = session_size(info)
    owned2 = [hi - lo for lo, hi in pod.partition(n_files, 2)]

    # 1. two ranks on the first card over gloo: the population query alone
    # (its walls are the ones compared), then the default run and the
    # two-process worker (tests/_torch_distributed_worker.py: the
    # cross-process time-sharded ingest, SGD, the train step, streaming and
    # the member-sharded population) side by side; each against its
    # one-process card run
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import _torch_distributed_worker as dworker

    params = {k: v.numpy() for k, v in ptrain.init_mlp_params(0, device="cpu").items()}
    params_path = os.path.join(work, "pod_params.npz")
    np.savez(params_path, **params)
    single = {}
    for label, query in (("population", POD_QUERY),
                         ("default", "fe=dwt-8-fused&train_clf=logreg")):
        q = f"info_file={info}&{query}"
        t0 = time.perf_counter()
        b, stats, launches = run_builder(f"pod_one_process_{label}", q, None, counters)
        single[label] = (q, str(stats), time.perf_counter() - t0, b.timers,
                      hashlib.sha256(b.features.cpu().numpy().tobytes()).hexdigest())
        k1 += launches["ingest_features"]
    ranks = {"population": run_ranks(single["population"][0], 2)}
    with ThreadPoolExecutor(2) as pool:
        default = pool.submit(run_ranks, single["default"][0], 2)
        twin = pool.submit(run_distributed_worker, params_path)
        ranks["default"] = default.result()
        worker_outs, worker_wall = twin.result()
    for label, (outs, wall) in ranks.items():
        _q, stats_text, one_wall, timers, rows_sha = single[label]
        k1 += check_ranks(f"pod2_{label}", outs, stats_text, rows_sha, owned2, "gloo", wall)
        emit("pod_run", run=label, processes=2, one_process_wall_s=one_wall,
             one_process_timers_s=timers, rank_walls_s=[o["wall_s"] for o in outs],
             spawn_wall_s=wall, exchange_s=[o["timers"].get("exchange") for o in outs],
             beside_the_worker=label == "default")

    # 2. the worker's outputs against one process over the same four
    # shards of the card
    outs, wall = worker_outs, worker_wall
    epochs, labels, sig, raw, markers, x, y = dworker.cases()
    four = first_card(torch, 4)
    mesh4, tmesh4 = pmesh.make_mesh(devices=four), pmesh.make_mesh(devices=four, axes=("time",))
    init, step = ptrain.make_train_step(mesh4)
    _, loss = step(init(params), epochs, labels, np.ones(4, np.float32))
    T = raw.shape[1]
    plan = sharded_ingest.plan_sharded_ingest(markers, 2, T, 4, T // 4)
    rows = sharded_ingest.make_sharded_ingest(tmesh4)(raw, np.full(3, 0.1, np.float32), plan)
    xs, ys = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    steps, regs, seeds = dworker.population_args()
    pop = population.train_linear_population_sharded(
        xs, ys, sgd.SGDConfig(num_iterations=200, convergence_tol=0.0), steps, regs, seeds,
        None, mesh4)
    one = {"loss": loss.reshape(1), "stream": streaming.make_streaming_extractor(tmesh4)(sig),
           "ingest": rows, "population": pop}
    one.update({f"sgd_{k}": sgd.train_linear(xs, ys, sgd.SGDConfig(**cfg), mesh=mesh4)
                for k, cfg in dworker.SGD_CONFIGS.items()})
    equal = {}
    for name, want in one.items():
        want = want.cpu().numpy().astype(np.float32).reshape(-1)
        got = [np.frombuffer(bytes.fromhex(o["sgd"][name[4:]] if name.startswith("sgd_")
                                           else o[name]), dtype=np.float32) for o in outs]
        equal[name] = all(np.array_equal(g, want) for g in got)
    emit("pod_distributed_worker", processes=2, backend=[o["backend"] for o in outs],
         mesh=outs[0]["mesh"], bit_equal_to_one_process=equal, wall_s=wall,
         ingest_rows=outs[0]["ingest_rows"], grad=outs[0]["grad"], total=outs[0]["total"])
    k1 += sum(o["k1"] for o in outs)  # each rank's sharded ingest: a launch a local shard
    if (not all(equal.values()) or outs[0]["grad"] != [26.0, 30.0, 34.0]
            or [o["k1"] for o in outs] != [2, 2]):
        raise AssertionError("the two-process worker disagrees with one process")

    # 3. streaming at BASELINE config 5's width: 256 channels, 65,536
    # samples, window 512 / stride 256, on a 4-shard time mesh
    shards, _count = mesh_shards(torch)
    tmesh = pmesh.make_mesh(devices=shards, axes=("time",))
    signal = (np.random.RandomState(5).randn(STREAM_CHANNELS, STREAM_SAMPLES) * 30.0).astype(
        np.float32)
    extract = streaming.make_streaming_extractor(tmesh, window=512, stride=256, fs=1000.0)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = extract(streaming.stage_recording(signal, tmesh))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    cpu_mesh = pmesh.make_mesh(4, axes=("time",), device="cpu")
    t0 = time.perf_counter()
    want = streaming.make_streaming_extractor(cpu_mesh, window=512, stride=256, fs=1000.0)(signal)
    cpu_s = time.perf_counter() - t0
    dev = (feats.cpu() - want).abs().max().item()
    emit("pod_streaming", channels=STREAM_CHANNELS, samples=STREAM_SAMPLES,
         mb=signal.nbytes / 1e6, shards=[str(d) for d in shards],
         windows=int(feats.shape[0]), width=int(feats.shape[1]), max_abs_vs_cpu=dev,
         tol=STREAM_TOL, card_walls_s=walls, cpu_wall_s=cpu_s)
    if feats.shape != (STREAM_SAMPLES // 256, STREAM_CHANNELS * 16) or dev > STREAM_TOL:
        raise AssertionError("the card's streaming features disagree with the CPU port's")

    # 4. four cards: a rank a card (CUDA_VISIBLE_DEVICES) over NCCL
    if count >= 4:
        k1 += phase_pod_four_cards(torch, np, info, counters)
    else:
        emit("pod_four_cards", ran=False,
             reason=f"{count} card(s) visible; a rank a card needs four (a --chips 4 call)")
    emit("pod_phase", seconds=time.perf_counter() - t_phase, k1_launches=k1)
    return k1


def phase_pod_four_cards(torch, np, info, counters):
    """Four ranks, one card each, over NCCL: the checks of the one-card
    ranks, and each rank's ingest and train walls beside the one-process
    card run's."""
    import hashlib

    from eeg_dataanalysispackage_tpu_torch.parallel import pod

    n_files = session_size(info)
    owned = [hi - lo for lo, hi in pod.partition(n_files, 4)]
    k1 = 0
    for label, query in (("population16", POD_FOUR_QUERY), ("population", POD_QUERY)):
        q = f"info_file={info}&{query}"
        t0 = time.perf_counter()
        b, stats, launches = run_builder(f"pod_one_process_{label}_4cards", q, None, counters)
        one_wall = time.perf_counter() - t0
        k1 += launches["ingest_features"]
        rows_sha = hashlib.sha256(b.features.cpu().numpy().tobytes()).hexdigest()
        outs, wall = run_ranks(q, 4, visible=[str(r) for r in range(4)])
        k1 += check_ranks(f"pod4_{label}", outs, str(stats), rows_sha, owned, "nccl", wall)
        ingest = [sum(o["timers"].get(k, 0.0) for k in ("parse", "featurize", "exchange"))
                  for o in outs]
        emit("pod_four_cards", ran=True, run=label, processes=4,
             one_process={"ingest_s": sum(b.timers.get(k, 0.0) for k in ("parse", "stage",
                                                                           "featurize")),
                          "train_s": b.timers.get("train"), "wall_s": one_wall},
             ranks={"ingest_s": ingest, "train_s": [o["timers"].get("train") for o in outs],
                    "wall_s": [o["wall_s"] for o in outs]}, spawn_wall_s=wall)
    return k1


# dedup=false: phase 4k's plans share one prefix, and each is to run its own
# ingest; phase 4l drives the prefix dedup
SCHED_QUERY = "fe=dwt-8-fused&train_clf=logreg&dedup=false"
SCHED_STEPS = ("1.0", "0.5", "0.25", "0.125")


def sched_results(handles, timeout=300):
    return [h.result(timeout=timeout) for h in handles]


def phase_scheduler(torch, np, info, counters, work):
    """Phase 4k (see the module docstring). Returns the K1 launches of the
    phase's plans: in this process and, before its kill, the child's."""
    from eeg_dataanalysispackage_tpu_torch import obs
    from eeg_dataanalysispackage_tpu_torch.ops import ingest_cuda
    from eeg_dataanalysispackage_tpu_torch.scheduler import (
        LeaseDir, PlanExecutor, PlanFailedError, PlanJournal,
    )

    t_phase = time.perf_counter()
    queries = [f"info_file={info}&{SCHED_QUERY}&config_step_size={s}" for s in SCHED_STEPS]
    solo, solo_counters, k1 = {}, {}, 0
    for i, q in enumerate(queries):
        b, stats, launches = run_builder(f"sched_solo_{i}", q, None, counters)
        solo[q], solo_counters[q] = str(stats), b.run_metrics.snapshot()["counters"]
        k1 += launches["ingest_features"]

    def zero():
        for module, attr in counters.values():
            setattr(module, attr, 0)

    def check(label, results, want_queries):
        got = [str(r.statistics) for r in results]
        if got != [solo[q] for q in want_queries]:
            raise AssertionError(f"{label}: a plan's statistics differ from its solo run's")

    # 1. concurrency: four plans at max_concurrent 1, 2 and 4
    walls = {}
    for mc in (1, 2, 4):
        jdir = os.path.join(work, f"sched_journal_{mc}")
        zero()
        t0 = time.perf_counter()
        with PlanExecutor(max_concurrent=mc, journal_dir=jdir) as ex:
            results = sched_results([ex.submit(q) for q in queries])
        wall = time.perf_counter() - t0
        launches = ingest_cuda.LAUNCHES
        k1 += launches
        check(f"max_concurrent={mc}", results, queries)
        states = [e["state"] for e in PlanJournal(jdir).entries()]
        walls[mc] = wall
        emit("sched_concurrency", max_concurrent=mc, plans=len(queries), wall_s=wall,
             plans_per_s=len(queries) / wall, k1_launches=launches,
             journal_states=states, attempts=[r.attempts for r in results],
             featurize_s=[r.builder.timers.get("featurize") for r in results],
             train_s=[r.builder.timers.get("train") for r in results])
        if launches != 8 * len(queries) or states != ["completed"] * len(queries):
            raise AssertionError(f"max_concurrent={mc}: K1 {launches} or journal {states}")

    # 2. fault isolation: a failing ingest.fused plan beside a clean one
    reports = os.path.join(work, "sched_reports")
    zero()
    with PlanExecutor(max_concurrent=2, max_attempts=1, report_root=reports) as ex:
        h_clean = ex.submit(queries[0])
        h_fault = ex.submit(queries[0] + "&faults=ingest.fused:once@1")
        clean = h_clean.result(timeout=300)
        try:
            h_fault.result(timeout=300)
            raise AssertionError("the ingest.fused plan did not fail")
        except PlanFailedError as e:
            fault_error = str(e)
    launches = ingest_cuda.LAUNCHES
    k1 += launches
    with open(os.path.join(reports, h_fault.plan_id, "crash_report.json")) as f:
        crash = json.load(f)
    with open(os.path.join(reports, h_clean.plan_id, "run_report.json")) as f:
        clean_report = json.load(f)
    clean_counters = clean.builder.run_metrics.snapshot()["counters"]
    emit("sched_isolation", k1_launches=launches, clean_counters=clean_counters,
         solo_counters=solo_counters[queries[0]], fault_error=fault_error[:200],
         crash_fired=crash["chaos"]["rules"]["ingest.fused"]["fired"],
         clean_report_chaos=clean_report["chaos"])
    check("isolation", [clean], queries[:1])
    if (clean_counters != solo_counters[queries[0]] or launches != 8
            or crash["chaos"]["rules"]["ingest.fused"]["fired"] != 1
            or clean_report["chaos"] is not None or "chaos.fired.ingest.fused" in clean_counters):
        raise AssertionError("a fault crossed from one plan into another")

    # 3. a scheduler.plan fault absorbed by a retry
    zero()
    with PlanExecutor(max_concurrent=1) as ex:
        retried = ex.submit(queries[1] + "&faults=scheduler.plan:once@1").result(timeout=300)
    launches = ingest_cuda.LAUNCHES
    k1 += launches
    emit("sched_retry", attempts=retried.attempts, k1_launches=launches)
    check("retry", [retried], queries[1:2])
    if retried.attempts != 2 or launches != 8:
        raise AssertionError("the scheduler.plan fault was not absorbed by one retry")

    # 4. SIGKILL mid-plan, then recovery here
    jdir = os.path.join(work, "sched_crash")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "_torch_scheduler_worker.py"),
         "--device=cuda", jdir, *queries[:3]],
        capture_output=True, text=True, timeout=240)
    child_s = time.perf_counter() - t0
    if proc.returncode != -9:
        raise AssertionError(f"the child was not SIGKILLed (rc {proc.returncode}): "
                             f"{proc.stderr[-2000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    journal = PlanJournal(jdir)
    before = {e["plan_id"]: e["state"] for e in journal.entries()}
    with open(os.path.join(jdir, "plan-p0001.json")) as f:
        completed_record = f.read()
    unfinished = [e["query"] for e in journal.unfinished()]
    zero()
    t0 = time.perf_counter()
    ex = PlanExecutor(max_concurrent=2, journal_dir=jdir)
    try:
        recovery = ex.recover()
        resumed = sched_results(recovery["resumed"])
    finally:
        ex.close()
    recover_s = time.perf_counter() - t0
    launches = ingest_cuda.LAUNCHES
    k1 += launches + child["k1_before_kill"]
    with open(os.path.join(jdir, "plan-p0001.json")) as f:
        untouched = f.read() == completed_record
    emit("sched_recovery", child_wall_s=child_s, child_k1_first=child["k1_a"],
         child_k1_at_kill=child["k1_before_kill"], states_after_kill=before,
         resumed=[h.plan_id for h in recovery["resumed"]], k1_launches=launches,
         recover_wall_s=recover_s, completed_record_untouched=untouched,
         all_recovered=all(r.recovered for r in resumed))
    check("recovery", resumed, [h.query for h in recovery["resumed"]])
    if (before != {"p0001": "completed", "p0002": "submitted", "p0003": "submitted"}
            or unfinished != queries[1:3] or launches != 8 * len(unfinished) or not untouched
            or child["a_statistics"] != solo[queries[0]] or journal.unfinished()
            or [e["plan_id"] for e in recovery["completed"]] != ["p0001"]):
        raise AssertionError("recovery re-ran a completed plan or missed an unfinished one")

    # 5. two executors over one journal race for an orphaned record
    jdir = os.path.join(work, "sched_fleet")
    journal = PlanJournal(jdir)
    journal.record_submitted("p0001", queries[3])
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    lease_path = os.path.join(jdir, "plan-p0001.lease")
    with open(lease_path, "w") as f:
        f.write(f"gw-dead\n{dead.pid}\n\n")
    os.utime(lease_path, (time.time() - 100, time.time() - 100))
    previous = os.environ.get("EEG_TPU_LEASE_TIMEOUT_S")
    os.environ["EEG_TPU_LEASE_TIMEOUT_S"] = "1"
    zero()
    executors = []
    try:
        for holder in ("gw-a", "gw-b"):
            ex = PlanExecutor(journal_dir=jdir)
            ex.leases = LeaseDir(jdir, holder=holder)
            executors.append(ex)
        (entry,) = journal.unfinished()
        with ThreadPoolExecutor(2) as pool:
            won = [h for h in pool.map(lambda e: e.claim_and_run(entry), executors) if h]
        taken = sched_results(won)
    finally:
        for ex in executors:
            ex.close()
        if previous is None:
            os.environ.pop("EEG_TPU_LEASE_TIMEOUT_S", None)
        else:
            os.environ["EEG_TPU_LEASE_TIMEOUT_S"] = previous
    launches = ingest_cuda.LAUNCHES
    k1 += launches
    record = journal.entry("p0001")
    emit("sched_takeover", claims_won=len(won), k1_launches=launches, state=record["state"],
         fleet=record["meta"].get("fleet"), lease_left=os.path.exists(lease_path))
    check("takeover", taken, queries[3:4])
    if (len(won) != 1 or launches != 8 or record["state"] != "completed"
            or not record["meta"]["fleet"]["takeover"] or os.path.exists(lease_path)):
        raise AssertionError("the orphaned plan did not run exactly once")

    # 6. every journal write fails: the plan runs unjournaled, counted
    jdir = os.path.join(work, "sched_journal_chaos")
    before = obs.metrics.snapshot()["counters"]
    zero()
    with PlanExecutor(journal_dir=jdir) as ex:
        unjournaled = ex.submit(queries[2] + "&faults=scheduler.journal:p=1.0").result(
            timeout=300)
        entries = ex.journal.entries()
    launches = ingest_cuda.LAUNCHES
    k1 += launches
    after = obs.metrics.snapshot()["counters"]
    failed = after.get("scheduler.journal_write_failed", 0) - before.get(
        "scheduler.journal_write_failed", 0)
    fired = after.get("chaos.fired.scheduler.journal", 0) - before.get(
        "chaos.fired.scheduler.journal", 0)
    emit("sched_journal_chaos", entries=len(entries), write_failures=failed, fired=fired,
         k1_launches=launches)
    check("journal chaos", [unjournaled], queries[2:3])
    if entries or failed != 2 or fired != 4 or launches != 8:
        raise AssertionError("a journal fault was not absorbed and counted")
    emit("sched_phase", seconds=time.perf_counter() - t_phase, k1_launches=k1,
         walls_s=walls)
    return k1


# phase 4l: the dedup pair's second plan, and the fleet's heavy plan (a host
# random forest over K1's rows: seconds of host work that a SIGKILL lands in)
SERVICE_SVM = "&train_clf=svm&config_reg_param=0.1"
FLEET_HEAVY = ("&train_clf=rf&config_max_bins=32&config_impurity=gini&config_max_depth=8"
               "&config_min_instances_per_node=1&config_num_trees=200&config_feature_subset=auto")


def http(url, body=None, method="GET", headers=None, timeout=120):
    """(status, JSON payload or text) of one request to a gateway."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=None if body is None else body.encode(),
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, raw, ctype = r.status, r.read().decode(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        code, raw, ctype = e.code, e.read().decode(), e.headers["Content-Type"]
    return code, json.loads(raw) if ctype == "application/json" else raw


def await_plan(url, plan_id, states=("completed", "failed", "cancelled"), timeout_s=300):
    deadline = time.monotonic() + timeout_s
    while True:
        _code, status = http(f"{url}/plans/{plan_id}")
        if status.get("state") in states:
            return status["state"]
        if time.monotonic() > deadline:
            raise AssertionError(f"plan {plan_id} stuck in {status}")
        time.sleep(0.02)


def await_segment_header(path, timeout_s=60):
    """Until a replica's trace segment holds its whole header line (a kill
    before that leaves the holder no segment)."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            with open(path) as f:
                if f.readline().endswith("\n"):
                    return
        except OSError:
            pass
        if time.monotonic() > deadline:
            raise AssertionError(f"no segment header in {path}")
        time.sleep(0.01)


def spawn_replica(replica_id, journal_dir, device, trace_dir=None, report_root=None):
    env = dict(os.environ, EEG_TPU_LEASE_TIMEOUT_S="1", EEG_TPU_FLEET_SCAN_INTERVAL_S="0.1")
    if trace_dir:
        env["EEG_TPU_TRACE_DIR"] = trace_dir
    proc = subprocess.Popen(
        [sys.executable, "-m", "eeg_dataanalysispackage_tpu_torch.gateway", "--port", "0",
         "--journal-dir", journal_dir, "--max-concurrent", "1", "--drain-timeout-s", "300",
         "--fleet", "--replica-id", replica_id, f"--device={device}"]
        + (["--report-root", report_root] if report_root else []),
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    line = proc.stdout.readline()
    if "listening on " not in line:
        proc.kill()
        raise AssertionError(f"replica {replica_id} did not start: {line!r}")
    return proc, line.split("listening on ", 1)[1].split()[0]


def phase_plan_service(torch, np, info, model, counters, work, smi, device="cuda",
                       operator=None):
    """Phase 4l (see the module docstring). Returns the K1 launches of the
    phase's plans in this process and K6's over its /predict requests.
    With ``operator`` (a dict), the fleet runs with the trace plane on and
    phase 4m's checks of the live fleet run before the survivor's drain,
    their record and seconds stored in ``operator``."""
    import hashlib

    from eeg_dataanalysispackage_tpu_torch import obs
    from eeg_dataanalysispackage_tpu_torch.gateway import GatewayServer
    from eeg_dataanalysispackage_tpu_torch.models import registry
    from eeg_dataanalysispackage_tpu_torch.obs import metrics_export
    from eeg_dataanalysispackage_tpu_torch.ops import ingest_cuda, serve_mega_cuda
    from eeg_dataanalysispackage_tpu_torch.scheduler import (
        LeaseDir, PlanExecutor, PlanJournal, dedup, placement,
    )
    from eeg_dataanalysispackage_tpu_torch.serve import MultiplexedService

    t_phase = time.perf_counter()
    run_device = None if device == "cuda" else device  # None: the builder's default card
    base = f"info_file={info}&fe=dwt-8-fused"
    q_lr, q_svm = base + "&train_clf=logreg", base + SERVICE_SVM
    solo, k1, walls = {}, 0, {}

    def reads():
        return obs.metrics.snapshot()["counters"].get("ingest.file_reads", 0)

    def zero():
        for module, attr in counters.values():
            setattr(module, attr, 0)

    before = reads()
    lr_builder, stats, launches = run_builder("service_solo_logreg", q_lr + "&dedup=false",
                                              run_device, counters)
    reads_one_build = reads() - before
    solo[q_lr], k1 = str(stats), k1 + launches["ingest_features"]
    solo_digest = hashlib.sha256(lr_builder.features.cpu().numpy().tobytes()).hexdigest()
    _b, stats, launches = run_builder("service_solo_svm", q_svm + "&dedup=false",
                                      run_device, counters)
    solo[q_svm], k1 = str(stats), k1 + launches["ingest_features"]

    # 1. the dedup pair: one prefix build, two fits on the one card tensor
    dedup.reset()
    zero()
    before, t0 = reads(), time.perf_counter()
    with PlanExecutor(max_concurrent=2, device=device) as ex:
        pair = sched_results([ex.submit(q) for q in (q_lr, q_svm)])
    walls["dedup_pair"] = time.perf_counter() - t0
    launches, pair_reads = ingest_cuda.LAUNCHES, reads() - before
    k1 += launches
    blocks = [r.builder.dedup_resolved for r in pair]
    leader = next(r for r, b in zip(pair, blocks) if b["role"] == "leader")
    follower = next(r for r in pair if r is not leader)
    after_digest = hashlib.sha256(leader.builder.features.cpu().numpy().tobytes()).hexdigest()
    emit("service_dedup_pair", k1_launches=launches, file_reads=pair_reads,
         file_reads_one_build=reads_one_build, blocks=blocks, stats=dedup.stats(),
         leader_rows_sha256_solo=solo_digest, leader_rows_sha256_after=after_digest,
         shared_tensor=follower.builder.features is leader.builder.features,
         rows_device=str(leader.builder.features.device), wall_s=walls["dedup_pair"], nvidia_smi=smi)
    check_equal = [str(r.statistics) for r in pair] == [solo[q_lr], solo[q_svm]]
    if (launches != 8 or pair_reads != reads_one_build or not check_equal
            or sorted(b["role"] for b in blocks) != ["follower", "leader"]
            or after_digest != solo_digest
            or follower.builder.features is not leader.builder.features):
        raise AssertionError("the dedup pair did not share one prefix build byte-equally")

    # 2. placement: a pool of the visible cards, two plans taking ordinal 0 in turn
    jdir = os.path.join(work, "service_placement")
    os.environ[placement.ENV_DEVICE_POOL] = "auto" if device == "cuda" else "1"
    try:
        pool = placement.DevicePool.from_env(LeaseDir(jdir, holder="gw-smoke"))
    finally:
        os.environ.pop(placement.ENV_DEVICE_POOL, None)
    before_counters = obs.metrics.snapshot()["counters"]
    zero()
    t0 = time.perf_counter()
    ex = PlanExecutor(max_concurrent=2, journal_dir=jdir, device=device)
    ex.leases, ex.placement = pool.leases, pool
    try:
        placed = sched_results([ex.submit(q + "&dedup=false") for q in (q_lr, q_svm)])
    finally:
        ex.close()
    walls["placement"] = time.perf_counter() - t0
    launches = ingest_cuda.LAUNCHES
    k1 += launches
    after_counters = obs.metrics.snapshot()["counters"]
    delta = {k: after_counters.get(k, 0) - before_counters.get(k, 0)
             for k in ("placement.grants", "placement.waits", "placement.backfills")}
    devices = [PlanJournal(jdir).entry(r.plan_id)["meta"]["fleet"]["devices"] for r in placed]
    emit("service_placement", pool_size=pool.size, counters=delta, devices=devices,
         k1_launches=launches, leases_left=placement.device_table(jdir),
         wall_s=walls["placement"], nvidia_smi=smi)
    if (pool.size != 1 or delta["placement.grants"] != 2 or devices != [[0], [0]]
            or [str(r.statistics) for r in placed] != [solo[q_lr], solo[q_svm]]
            or launches != 16 or placement.device_table(jdir)):
        raise AssertionError("the placed plans did not take the pool's ordinal in turn")

    # 3. the gateway over a journal, with /predict over four tenants
    dedup.reset()
    base_clf = registry.create("logreg")
    base_clf.load(model)
    tenants = {f"t{i}": perturbed_tenant(np, base_clf, i) if i else base_clf for i in range(4)}
    windows, resolutions, _targets = session_windows(info)
    svc = MultiplexedService(tenants, device=device)
    svc.start()
    gw = GatewayServer(journal_dir=os.path.join(work, "service_journal"),
                       report_root=os.path.join(work, "service_reports"),
                       predict_service=svc, device=device)
    try:
        gw.start()
        zero()
        serve_mega_cuda.MULTI_LAUNCHES = 0
        t0 = time.perf_counter()
        codes = {}
        codes["submit"], first = http(f"{gw.url}/plans", q_lr, "POST",
                                      {"X-Idempotency-Key": "smoke", "X-Trace-Id": "smoke-1"})
        codes["replay"], replay = http(f"{gw.url}/plans", q_lr, "POST",
                                       {"X-Idempotency-Key": "smoke"})
        codes["invalid"], _ = http(f"{gw.url}/plans", "fe=dwt-8&train_clf=logreg", "POST")
        state = await_plan(gw.url, first["plan_id"])
        codes["report"], report = http(f"{gw.url}/plans/{first['plan_id']}/report")
        walls["gateway_plan"] = time.perf_counter() - t0
        plan_k1 = ingest_cuda.LAUNCHES
        k1 += plan_k1
        mix = [f"t{i % 4}" for i in range(16)]
        t0 = time.perf_counter()
        answers = []
        for w, r, t in zip(windows[:16], resolutions[:16], mix):
            code, payload = http(f"{gw.url}/predict", json.dumps(
                {"tenant": t, "window": np.asarray(w).tolist(),
                 "resolutions": np.asarray(r).tolist()}), "POST")
            answers.append((code, payload))
        walls["predict_16"] = time.perf_counter() - t0
        k6 = serve_mega_cuda.MULTI_LAUNCHES
        # the service called directly, for the comparison (not counted)
        direct = [svc.engine.execute([w], r, [t])[1][0] for w, r, t in
                  zip(windows[:16], resolutions[:16], mix)]
        codes["metrics"], text = http(f"{gw.url}/metrics")
        codes["healthz"], _ = http(f"{gw.url}/healthz")
        codes["readyz"], _ = http(f"{gw.url}/readyz")
        codes["stats"], stats_payload = http(f"{gw.url}/stats")
    finally:
        gw.close()
        svc.stop()
    series = metrics_export.parse(text)
    margins_equal = all(code == 200 and payload["margin"] == float(m)
                        for (code, payload), m in zip(answers, direct))
    emit("service_gateway", codes=codes, state=state, k1_launches=plan_k1, k6_launches=k6,
         statistics_equal=report["statistics"] == solo[q_lr],
         replay=replay.get("idempotent_replay"), trace_id=first.get("trace_id"),
         predict_codes=sorted({code for code, _ in answers}), margins_equal=margins_equal,
         tenants_served=sorted(stats_payload["serve"]["tenants"]),
         metrics_series=len(series), walls_s=dict(walls), nvidia_smi=smi)
    if (codes != {"submit": 201, "replay": 200, "invalid": 400, "report": 200, "metrics": 200,
                  "healthz": 200, "readyz": 200, "stats": 200}
            or state != "completed" or report["statistics"] != solo[q_lr] or plan_k1 != 8
            or not margins_equal or k6 < 1 or "eeg_tpu_build_info" not in series):
        raise AssertionError("the gateway's wire contract did not hold on the card")

    # 4. the fleet: two replica processes over one journal, one SIGKILLed
    heavy = base + FLEET_HEAVY
    _b, stats, launches = run_builder("service_fleet_solo", heavy,
                                      run_device, counters)
    heavy_solo, k1 = str(stats), k1 + launches["ingest_features"]
    jdir = os.path.join(work, "service_fleet")
    trace_dir = os.path.join(work, "service_traces") if operator is not None else None
    report_root = os.path.join(work, "service_fleet_reports") if operator is not None else None
    procs = []
    t0 = time.perf_counter()
    try:
        procs = [spawn_replica(rid, jdir, device, trace_dir, report_root)
                 for rid in ("gw-a", "gw-b")]
        (proc_a, url_a), (proc_b, url_b) = procs
        walls["fleet_start"] = time.perf_counter() - t0
        code, sub = http(f"{url_a}/plans", heavy, "POST",
                         {"X-Idempotency-Key": "fleet", "X-Trace-Id": FLEET_TRACE_ID})
        running = await_plan(url_a, sub["plan_id"], ("running", "completed", "failed"))
        if operator is not None:
            await_segment_header(os.path.join(trace_dir, "trace-gw-a.jsonl"))
        proc_a.kill()
        killed_rc = proc_a.wait(timeout=60)
        t1 = time.perf_counter()
        final = await_plan(url_b, sub["plan_id"])
        walls["takeover"] = time.perf_counter() - t1
        entry = PlanJournal(jdir).entry(sub["plan_id"])
        if operator is not None and final == "completed":
            t1 = time.perf_counter()
            operator.update(check_operator_tools(jdir, trace_dir, report_root, sub["plan_id"],
                                                 url_b, url_a, smi))
            operator["seconds_live"] = time.perf_counter() - t1
        proc_b.send_signal(signal.SIGTERM)
        drain_rc = proc_b.wait(timeout=120)
    finally:
        for proc, _url in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    walls["fleet"] = time.perf_counter() - t0
    emit("service_fleet", submit_code=code, state_at_kill=running, killed_rc=killed_rc,
         final=final, fleet=entry["meta"].get("fleet"),
         statistics_equal=entry.get("statistics") == heavy_solo, drain_rc=drain_rc,
         leases_left=sorted(n for n in os.listdir(jdir) if n.endswith(".lease")),
         walls_s={k: walls[k] for k in ("fleet_start", "takeover", "fleet")}, nvidia_smi=smi)
    if (code != 201 or running != "running" or killed_rc != -9 or final != "completed"
            or entry["meta"]["fleet"] != {"replica": "gw-b", "takeover": True}
            or entry.get("statistics") != heavy_solo or drain_rc != 0):
        raise AssertionError("the fleet did not complete the killed replica's plan")
    dedup.reset()
    emit("service_phase", seconds=time.perf_counter() - t_phase, k1_launches=k1,
         k6_launches=k6, nvidia_smi=smi)
    return k1, k6


# phase 4m: the fleet plan's trace id, and the port's operator tools run
# in a fresh interpreter over the live fleet (the survivor and the killed
# replica's URL), which must hold no JAX module
FLEET_TRACE_ID = "smoke-fleet"
OPERATOR_PROBE = """
import contextlib, io, json, sys
from eeg_dataanalysispackage_tpu_torch.tools import fleet_top, plan_admin
journal, traces, plan, live, dead = sys.argv[1:6]
out = {}
for name, fn, argv in (
        ("trace", plan_admin.main, ["trace", plan, "--journal", journal, "--trace-dir", traces]),
        ("list", plan_admin.main, ["list", "--journal", journal]),
        ("fleet", plan_admin.main, ["fleet", "--journal", journal]),
        ("fleet_top", fleet_top.main, ["--snapshot", "--journal", journal, live, dead])):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    out[name] = {"rc": rc, "stdout": buf.getvalue()}
out["leaked"] = sorted(k for k in sys.modules
                       if k.split(".")[0] in ("jax", "flax", "optax", "eeg_dataanalysispackage_tpu"))
print(json.dumps(out))
"""


def check_operator_tools(jdir, trace_dir, report_root, plan_id, url_live, url_dead, smi):
    """Phase 4m over the live fleet, after the takeover and before the
    survivor's drain: the two segments, the survivor's report, and the
    operator tools in a fresh interpreter."""
    headers, spans = {}, {}
    for name in sorted(os.listdir(trace_dir)):
        with open(os.path.join(trace_dir, name)) as f:
            lines = [json.loads(line) for line in f.read().splitlines() if line.strip()]
        headers[name] = [(line["trace_id"], line["attrs"].get("takeover")) for line in lines
                         if line["kind"] == "segment"]
        spans[name] = sum(1 for line in lines if line["kind"] == "span"
                          and line["trace_id"] == FLEET_TRACE_ID)
    with open(os.path.join(report_root, plan_id, "run_report.json")) as f:
        report_trace = json.load(f)["trace"]
    emit("operator_trace", segments=sorted(headers), headers=headers, spans=spans,
         report_trace=report_trace, nvidia_smi=smi)
    if (headers != {"trace-gw-a.jsonl": [(FLEET_TRACE_ID, False)],
                    "trace-gw-b.jsonl": [(FLEET_TRACE_ID, True)]}
            or report_trace != {"trace_id": FLEET_TRACE_ID, "segment": "gw-b"}
            or not spans["trace-gw-b.jsonl"]):
        raise AssertionError("the killed and surviving segments do not carry the plan's trace")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", OPERATOR_PROBE, jdir, trace_dir, plan_id,
                           url_live, url_dead], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the operator tools failed: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.splitlines()[-1])
    trace_text = out["trace"]["stdout"]
    snap = json.loads(out["fleet_top"]["stdout"])
    rows = [(r.get("replica"), "error" in r) for r in snap["replicas"]]
    emit("operator_tools", rcs={k: v["rc"] for k, v in out.items() if k != "leaked"},
         leaked=out["leaked"], trace=trace_text.splitlines(), fleet_top_rows=rows,
         fleet_takeovers=snap["fleet"]["takeovers"], wall_s=wall, nvidia_smi=smi)
    if ({k: v["rc"] for k, v in out.items() if k != "leaked"}
            != {"trace": 0, "list": 0, "fleet": 0, "fleet_top": 1}
            or out["leaked"] or "2 segment(s)" not in trace_text
            or "segment gw-b  <-- TAKEOVER boundary: continued after gw-a died" not in trace_text
            or trace_text.index("segment gw-a") > trace_text.index("segment gw-b")
            or plan_id not in out["list"]["stdout"]
            or rows != [("gw-b", False), (None, True)] or snap["fleet"]["takeovers"] != 1):
        raise AssertionError("the operator tools did not show the fleet's takeover")
    return {"spans": spans, "tools_wall_s": wall}


def sink_cost_us(events, directory, n=500, repeats=3):
    """Microseconds a span the trace sink adds (one appended line): the
    same spans through a recorder joined to a trace and one that is not,
    median of ``repeats`` pairs."""
    costs = []
    for r in range(repeats):
        walls = []
        for traced in (False, True):
            rec = events.SpanRecorder(name="plan", max_spans=512)
            if traced:
                rec.set_trace("cost", trace_dir=directory, segment=f"cost-{r}")
            t0 = time.perf_counter()
            for i in range(n):
                with rec.span("stage.cost", i=i):
                    pass
            walls.append(time.perf_counter() - t0)
            rec.finish()
        costs.append((walls[1] - walls[0]) / n * 1e6)
    return pystats.median(costs), costs


def phase_operator_plane(info, counters, work, smi, operator, device="cuda"):
    """Phase 4m after the fleet (see the module docstring). Returns the K1
    launches of ``chaos_run``'s two runs."""
    import contextlib
    import io
    import pickle

    from eeg_dataanalysispackage_tpu_torch import obs
    from eeg_dataanalysispackage_tpu_torch.obs import events
    from eeg_dataanalysispackage_tpu_torch.tools import chaos_run

    t_phase = time.perf_counter()
    if "spans" not in operator:
        raise AssertionError("phase 4l's fleet did not run the operator checks")
    # chaos_run on a fused query the elastic path absorbs
    query = (f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&elastic=true"
             f"&checkpoint_path={os.path.join(work, 'chaos_ck')}")
    for module, attr in counters.values():
        setattr(module, attr, 0)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = chaos_run.main([query, "--faults", "device.step:once@2", "--device", device])
    chaos_wall = time.perf_counter() - t0
    k1 = counters["ingest_features"][0].LAUNCHES
    text = buf.getvalue()
    emit("operator_chaos", rc=rc, k1_launches=k1, parity="PARITY:" in text,
         events=json.loads(text.split("== resilience events ==\n", 1)[1].split("\n\n")[0]),
         wall_s=chaos_wall, nvidia_smi=smi)
    if rc != 0 or k1 != 16 or "PARITY:" not in text:
        raise AssertionError(f"chaos_run did not hold parity on the card: rc {rc}, K1 {k1}")
    # the allocator's snapshot
    path = os.path.join(work, "memory", "mem.pkl")
    ok = obs.save_memory_profile(path)
    size = os.path.getsize(path) if ok else 0
    segments = []
    if ok:
        with open(path, "rb") as f:
            segments = pickle.load(f)
    emit("operator_memory", ok=ok, bytes=size, segments=len(segments),
         reserved_bytes=sum(sg["total_size"] for sg in segments),
         allocated_bytes=sum(sg["allocated_size"] for sg in segments), nvidia_smi=smi)
    if device == "cuda" and (not ok or size == 0 or not segments):
        raise AssertionError("save_memory_profile wrote no snapshot on the card")
    # the trace sink's cost a span, and on the fleet plan's segment
    per_span, runs = sink_cost_us(events, os.path.join(work, "sink_cost"))
    spans = operator["spans"]["trace-gw-b.jsonl"]
    emit("operator_sink_cost", us_per_span=per_span, runs_us=runs, fleet_plan_spans=spans,
         fleet_plan_cost_ms=per_span * spans / 1e3, nvidia_smi=smi)
    seconds = time.perf_counter() - t_phase + operator["seconds_live"]
    emit("operator_phase", seconds=seconds, k1_launches=k1, nvidia_smi=smi)
    return k1


JAX_ROOTS = ("jax", "jaxlib", "flax", "optax", "eeg_dataanalysispackage_tpu")


def walkthrough_mesh(torch):
    """The two meshed walkthroughs' time axis: eight distinct cards where
    there are eight, else the first card eight times (the JAX scripts'
    eight devices)."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i if count >= 8 else 0) for i in range(8)]


def imported_modules(importtime_stderr):
    """The top-level names of the modules a ``python -X importtime`` run
    imported, from its stderr."""
    names = set()
    for line in importtime_stderr.splitlines():
        if line.startswith("import time:") and "|" in line:
            name = line.rsplit("|", 1)[1].strip()
            if name and name != "package":
                names.add(name.split(".")[0])
    return names


def phase_walkthroughs(torch, np, info, counters, smi, device="cuda"):
    """Phase 4n (see the module docstring). Returns K1's launches over the
    walkthroughs run in this process; the launches made to compare a row
    with another launch's are not counted."""
    from eeg_dataanalysispackage_tpu_torch.examples import (
        fused_ingest, mllib_migration, raw_stream_training, sharded_long_recording,
        stream_continuous, train_p300,
    )
    from eeg_dataanalysispackage_tpu_torch.ops import device_ingest, ingest_cuda
    from eeg_dataanalysispackage_tpu_torch.utils.device import host_to_device

    t_phase = time.perf_counter()
    k1_total, walls = 0, {}
    mesh_devices = walkthrough_mesh(torch) if device == "cuda" else [device] * 8

    def counted(name, fn, want_k1):
        nonlocal k1_total
        for module, attr in counters.values():
            setattr(module, attr, 0)
        t0 = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        k1 = counters["ingest_features"][0].LAUNCHES
        k1_total += k1
        if k1 != want_k1 or out.get("k1_launches", 0) != k1:
            raise AssertionError(f"walkthrough {name}: K1 launched {k1} time(s) "
                                 f"(its own count {out.get('k1_launches')}), want {want_k1}")
        return out, k1

    # train_p300 on the smoke's session: the query's host fe=dwt-8-tpu path,
    # then load_features_device (K1 a recording) and a logreg fit
    p300, k1 = counted("train_p300", lambda: train_p300.run(info, device=device), 8)
    emit("walkthrough_train_p300", k1_launches=k1, features=list(p300["features_shape"]),
         query_accuracy=p300["query_statistics"].calc_accuracy(),
         fused_accuracy=p300["fused_statistics"].calc_accuracy(),
         wall_s=walls["train_p300"], nvidia_smi=smi)

    # fused_ingest: K1 against the plain rows; the regular rows against K1
    # launched at the same positions (uncounted)
    fused, k1 = counted("fused_ingest", lambda: fused_ingest.run(device=device), 2)
    raw_t = host_to_device(fused["raw"], device)
    res_t = host_to_device(fused["resolutions"], device)
    regular_again = ingest_cuda.ingest_features_cuda(raw_t, res_t, fused["regular_positions"])
    regular_equal = bool(torch.equal(fused["regular"], regular_again))
    emit("walkthrough_fused_ingest", k1_launches=k1, rows=list(fused["k1"].shape),
         max_abs_vs_plain=fused["max_abs_diff"], tol=KERNEL_TOL,
         formulation=fused["formulation"], regular_bit_equal=regular_equal,
         wall_s=walls["fused_ingest"], nvidia_smi=smi)
    if fused["max_abs_diff"] > KERNEL_TOL or not regular_equal:
        raise AssertionError("walkthrough fused_ingest: K1 disagrees with its plain version "
                             "or the regular featurizer with K1")

    # raw_stream_training: 3 + 3 steps, a crash at step 4, the resume and an
    # uninterrupted run (4 + 2 + 6 steps), K1 once a step
    raw, k1 = counted("raw_stream_training", lambda: raw_stream_training.run(device=device), 18)
    losses = raw["regular_losses"] + raw["irregular_losses"]
    emit("walkthrough_raw_stream_training", k1_launches=k1,
         regular_losses=raw["regular_losses"], irregular_losses=raw["irregular_losses"],
         crashed_checkpoints=raw["crashed_checkpoints"], resumed_at=raw["resumed_at"],
         bit_identical=raw["bit_identical"], wall_s=walls["raw_stream_training"],
         nvidia_smi=smi)
    if (not raw["bit_identical"] or raw["crashed_checkpoints"] != [2, 4]
            or raw["resumed_at"] != 6 or not np.isfinite(losses).all()):
        raise AssertionError("walkthrough raw_stream_training: the resumed run is not the "
                             "uninterrupted one")

    # sharded_long_recording over eight time shards: K1 once a shard, then the
    # raw-stream step 3 times; the rows against one unsharded launch on the
    # same plan (uncounted)
    sharded, k1 = counted("sharded_long_recording", lambda: sharded_long_recording.run(
        device=device, mesh_devices=mesh_devices), 8 + 3)
    T = sharded["raw"].shape[1]
    base = device_ingest.plan_ingest(sharded["markers"], 4, T)
    first = sharded["features"].device
    unsharded = ingest_cuda.make_cuda_ingest_featurizer()(
        host_to_device(sharded["raw"], first), host_to_device(sharded["resolutions"], first),
        base.positions, base.mask)[: base.n_kept]
    feats = sharded["features"]
    rows_equal = 0
    if feats.shape == unsharded.shape:
        rows_equal = int((feats == unsharded).all(dim=1).sum())
    emit("walkthrough_sharded_long_recording", k1_launches=k1,
         mesh=[str(d) for d in mesh_devices], samples=int(T), markers=len(sharded["markers"]),
         rows=list(feats.shape), halo_windows=sharded["halo_windows"],
         rows_bit_equal=rows_equal, train_accuracy=sharded["train_accuracy"],
         losses=sharded["losses"], wall_s=walls["sharded_long_recording"], nvidia_smi=smi)
    if (rows_equal != base.n_kept or feats.shape[0] != base.n_kept
            or not np.array_equal(sharded["plan"].targets, base.targets)
            or sharded["halo_windows"] < 1 or not np.isfinite(sharded["losses"]).all()):
        raise AssertionError("walkthrough sharded_long_recording: the sharded rows are not "
                             "the unsharded kernel's")

    # stream_continuous: blocked and mesh rows, which agree before the wrap
    stream, _ = counted("stream_continuous", lambda: stream_continuous.run(
        device=device, mesh_devices=mesh_devices), 0)
    blocked, mesh_rows = stream["blocked"], stream["mesh"].cpu().numpy()
    stream_dev = float(np.abs(mesh_rows[: len(blocked)] - blocked).max())
    emit("walkthrough_stream_continuous", blocked=list(blocked.shape),
         mesh=list(mesh_rows.shape), max_abs_before_wrap=stream_dev, tol=STREAM_TOL,
         wall_s=walls["stream_continuous"], nvidia_smi=smi)
    if (stream_dev > STREAM_TOL or blocked.shape != (511, 1024)
            or mesh_rows.shape != (512, 1024)):
        raise AssertionError("walkthrough stream_continuous: the blocked and mesh rows differ")

    # mllib_migration: the imported GLM's predictions, the forest's round
    # trip, equal to the CPU run's
    mllib, _ = counted("mllib_migration", lambda: mllib_migration.run(device=device), 0)
    mllib_cpu = mllib_migration.run(device="cpu")
    same_as_cpu = all(np.array_equal(mllib[k], mllib_cpu[k]) for k in (
        "imported_predictions", "forest_predictions", "round_trip_predictions"))
    emit("walkthrough_mllib_migration", bit_equal=mllib["bit_equal"],
         forest_accuracy=mllib["forest_accuracy"],
         round_trip_agreement=mllib["round_trip_agreement"], equal_to_cpu=same_as_cpu,
         wall_s=walls["mllib_migration"], nvidia_smi=smi)
    if not mllib["bit_equal"] or not same_as_cpu:
        raise AssertionError("walkthrough mllib_migration: the predictions moved")

    # a fresh interpreter: python -m ...examples.train_p300 <info>, its
    # statistics this process's, and no JAX module imported
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "eeg_dataanalysispackage_tpu_torch.examples.train_p300", info, "--device", device],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    cli_wall = time.perf_counter() - t0
    leaked = sorted(imported_modules(proc.stderr).intersection(JAX_ROOTS))
    want = (f"query-string pipeline:\n{p300['query_statistics']}\n"
            f"fused device path: {p300['fused_statistics']}\n")
    cli_k1 = [line for line in proc.stdout.splitlines() if line.startswith("K1")]
    want_k1 = [("K1 (csrc/ingest_features.cu): 8 launch(es) on cuda" if device == "cuda"
                else f"K1's plain PyTorch version on {device} (no kernel launch)")]
    emit("walkthrough_cli", rc=proc.returncode, leaked=leaked,
         modules=len(imported_modules(proc.stderr)),
         statistics_equal=proc.stdout.startswith(want), k1_line=cli_k1, wall_s=cli_wall,
         nvidia_smi=smi)
    if (proc.returncode != 0 or leaked or not proc.stdout.startswith(want)
            or cli_k1 != want_k1):
        raise AssertionError(f"python -m ...examples.train_p300 failed or differs: "
                             f"{proc.stdout[-1000:]}{proc.stderr[-1000:]}")
    emit("walkthrough_phase", seconds=time.perf_counter() - t_phase, walls=walls,
         cli_wall_s=cli_wall, k1_launches=k1_total, nvidia_smi=smi)
    return k1_total


def timed_bound(bytes_moved, flops, bandwidth, f32_peak):
    """(bound ms, "bytes" or "operations")."""
    t_bytes, t_flops = bytes_moved / bandwidth * 1e3, flops / f32_peak * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


def epoch_timing(torch, dwt, dwt_cuda, dev, n, bandwidth, f32_peak, smi, T=750):
    """The epoch-features kernel and its plain version on ``n`` (3, T)
    float32 epochs (T = 768: the seizure run's windows); bound: the
    512-sample windows read once, the rows written once, the operator read
    once. ``library_ms``: one ``torch.matmul`` of the window view (B, 3,
    512), strides (3*T, T, 1), with the (512, 16) operator (cuBLAS SGEMM, TF32 off): the
    contraction, all of the kernel's FMAs and most of its bytes, without
    the normalize (``library_device_ms``: its GEMM kernel's device time).
    ``window_read_ms``: the device time of one PyTorch reduction over that
    view, what its strided read costs the card."""
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn((n, 3, T), generator=gen, device=dev) * 40.0
    got = dwt_cuda.epoch_features_cuda(x)
    want = dwt.epoch_features(x)
    err = (got - want).abs().max().item()
    if err > KERNEL_TOL:
        raise AssertionError(f"epoch-features kernel disagrees at the timing size {n}: {err}")
    del got, want
    kernel_ms = time_ms(lambda: dwt_cuda.epoch_features_cuda(x))
    device_ms = profiled_device_ms(lambda: dwt_cuda.epoch_features_cuda(x),
                                   "epoch_features_kernel")
    clock = sm_clock_mhz()
    plain_ms = time_ms(lambda: dwt.epoch_features(x))
    window = x[:, :, 175:175 + 512]
    W = dwt.kernel_operator(8, 512, 16, dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        contraction = torch.matmul(window, W)
        ref = torch.einsum("bct,tk->bck", window.double(), W.double())
        # float32 rounding leaves ~1e-7 of the largest value; TF32 ~1e-3
        if (contraction.double() - ref).abs().max().item() > 1e-5 * ref.abs().max().item():
            raise AssertionError("the library contraction is not a float32 one")
        del contraction, ref
        library_ms = time_ms(lambda: torch.matmul(window, W))
        library_device_ms = profiled_device_ms(lambda: torch.matmul(window, W), "gemm")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # the same window view read once by one PyTorch reduction: what this
    # strided read costs the card, whatever is computed from it
    window_read_ms = profiled_device_ms(lambda: window.sum(), "reduce_kernel")
    bytes_moved = n * 3 * 512 * 4 + n * 48 * 4 + 512 * 16 * 4
    flops = 2 * n * 3 * 512 * 16
    bound_ms, bound_by = timed_bound(bytes_moved, flops, bandwidth, f32_peak)
    emit("timing", kernel="epoch_features", epochs=n, epoch_length=T, kernel_ms=kernel_ms,
         kernel_device_ms=device_ms, sm_clock_mhz=clock, plain_ms=plain_ms, bound_ms=bound_ms,
         bound_by=bound_by, bytes=bytes_moved, flops=flops, library_ms=library_ms,
         library="torch.matmul of the window view with W, TF32 off (contraction only)",
         library_device_ms=library_device_ms, window_read_ms=window_read_ms,
         max_abs_err=err, nvidia_smi=smi)
    return kernel_ms, plain_ms, bound_ms, bound_by, err, library_ms


def epoch_size_timing(torch, dwt, dwt_cuda, dev, sizes, bandwidth, f32_peak, smi, n=4096):
    """The epoch-features kernel off the main path: ``n`` (3, 750) float32
    epochs at (epoch_size, feature_size, skip), against the plain version;
    bound: the windows read once, the rows written once, the operator read
    once, or the contraction's float32 operations, whichever is longer."""
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn((n, 3, 750), generator=gen, device=dev) * 40.0
    for size, K, skip in sizes:
        fn = lambda: dwt_cuda.epoch_features_cuda(x, 8, skip, size, K)  # noqa: E731
        err = (fn() - dwt.epoch_features(x, 8, skip, size, K)).abs().max().item()
        if err > KERNEL_TOL:
            raise AssertionError(f"epoch-features kernel disagrees at ({size}, {K}): {err}")
        kernel_ms = time_ms(fn)
        device_ms = profiled_device_ms(fn, "epoch_features_kernel")
        plain_ms = time_ms(lambda: dwt.epoch_features(x, 8, skip, size, K))
        bytes_moved = n * 3 * size * 4 + n * 3 * K * 4 + size * K * 4
        flops = 2 * n * 3 * size * K
        bound_ms, bound_by = timed_bound(bytes_moved, flops, bandwidth, f32_peak)
        emit("timing", kernel="epoch_features", epochs=n, epoch_size=size, feature_size=K,
             kernel_ms=kernel_ms, kernel_device_ms=device_ms, plain_ms=plain_ms,
             bound_ms=bound_ms, bound_by=bound_by, bytes=bytes_moved, flops=flops,
             max_abs_err=err, nvidia_smi=smi)


def recording_plan(info, dev):
    """One launch of the fused batch path as it runs: the session's first
    recording staged on the card and planned (``stage_raw``,
    ``plan_ingest``), its starts as ``make_cuda_ingest_featurizer``
    computes them (padded rows at the stream's end). Returns (raw, res,
    starts, kept rows)."""
    import numpy as np
    import torch

    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
    from eeg_dataanalysispackage_tpu_torch.ops import device_ingest

    provider = OfflineDataProvider([info], device=dev)
    _rel, guessed, rec = next(iter(provider.iter_recordings()))
    raw, res, n_samples = device_ingest.stage_raw(rec, provider.channel_indices_for(rec), dev)
    plan = device_ingest.plan_ingest(rec.markers, guessed, n_samples, pre=provider.pre,
                                     post=provider.post)
    S = raw.shape[1]
    starts = np.where(plan.mask, np.clip(plan.positions.astype(np.int64) - provider.pre, 0, S),
                      S).astype(np.int32)
    return raw, res, torch.from_numpy(starts).to(dev), plan.n_kept


def ingest_timing(torch, ingest_cuda, device_ingest, W, dev, dtype, bandwidth, f32_peak, smi,
                  precision="f32", plan=None, bf16_peak=None):
    """The fused ingest kernel at ``precision`` and its plain version at
    32,768 windows (3 channels, 1,000-sample stride) on an int16 or
    float32 stream, or on ``plan`` (:func:`recording_plan`: one
    recording's launch of the batch path); bound: the needed samples
    read once, rows, starts, operator and resolutions once (the rungs
    stream the same bytes; the bf16 rung's operations against
    ``bf16_peak``, the tensor cores' rate for its operand type, the
    others' against ``f32_peak``). The int8/int4 rows are held bit for bit
    against the plain quantizer on the f32 kernel's rows, the others
    within KERNEL_TOL of the plain version."""
    if plan is None:
        n, stride = 32_768, 1000
        S = n * stride + 1000
        gen = torch.Generator(device=dev).manual_seed(0)
        raw = torch.randint(-3000, 3000, (3, S), generator=gen, device=dev,
                            dtype=torch.int32).to(dtype)
        res = torch.tensor([0.1, 0.1, 0.2], dtype=torch.float32, device=dev)
        starts = (torch.arange(n, device=dev, dtype=torch.int32) * stride).contiguous()
    else:
        raw, res, starts, _kept = plan
        n, S, stride = int(starts.shape[0]), raw.shape[1], None
    args = (raw, res, starts, W, 100, 175, precision)
    got = ingest_cuda.ingest_features(*args)
    if precision in ("int8", "int4"):
        f32 = ingest_cuda.ingest_features(raw, res, starts, W).cpu()
        err = (got.cpu() - quantizers()[precision](f32, 16)).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"{precision} epilogue differs from the quantizer: {err}")
    else:
        err = (got - device_ingest.ingest_features_plain(*args)).abs().max().item()
        if err > KERNEL_TOL:
            raise AssertionError(f"ingest kernel ({dtype}, {precision}) disagrees at the "
                                 f"timing size: {err}")
    del got
    kernel_ms = time_ms(lambda: ingest_cuda.ingest_features(*args))
    device_ms = profiled_device_ms(lambda: ingest_cuda.ingest_features(*args),
                                   "ingest_features_kernel")
    clock = sm_clock_mhz()
    plain_ms = time_ms(lambda: device_ingest.ingest_features_plain(*args))
    samples = needed_samples(starts.cpu().numpy(), S, 100, 175, 512)
    bytes_moved = (3 * samples * raw.element_size() + n * 48 * 4 + n * 4 + W.numel() * 4
                   + 3 * 4)
    flops = 2 * n * 3 * 512 * 16
    peak = bf16_peak if precision == "bf16" else f32_peak
    bound_ms, bound_by = timed_bound(bytes_moved, flops, bandwidth, peak)
    name = "ingest_features" if dtype == torch.int16 else "ingest_features_f32"
    if precision != "f32":
        name = f"ingest_features_{precision}"
    if plan is not None:
        name += "_recording_plan"
    emit("timing", kernel=name, windows=n, stride=stride,
         stream_bytes=int(raw.numel() * raw.element_size()), kernel_ms=kernel_ms,
         kernel_device_ms=device_ms, sm_clock_mhz=clock, plain_ms=plain_ms, bound_ms=bound_ms,
         bound_by=bound_by,
         bytes=bytes_moved, flops=flops, library_ms=None, max_abs_err=err, nvidia_smi=smi)
    return kernel_ms, plain_ms, bound_ms, bound_by, err


def mega_bound(n: int, bandwidth: float, f32_peak: float, sample_bytes: int = 2):
    """Least card time for the megakernel's function on ``n`` windows:
    the 612 needed samples (int16, or float32 at ``sample_bytes`` 4) per
    channel and window read once, one float32 margin written per window,
    operator, weights and resolutions read once; against its float32
    operations."""
    bytes_moved = (3 * n * (100 + 512) * sample_bytes + n * 4 + 512 * 16 * 4 + 48 * 4
                   + 3 * 4)
    flops = 2 * n * 3 * 512 * 16 + 2 * n * 48
    return (*timed_bound(bytes_moved, flops, bandwidth, f32_peak), bytes_moved, flops)


def timing_stream(torch, dev, gen, n, stride, samples):
    """(3, n * stride) windows of int16 noise, and their resolutions; at
    ``samples="float32"`` scaled into float32 with unit resolutions."""
    stream = torch.randint(-3000, 3000, (3, n * stride), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int16)
    res = torch.tensor([0.1, 0.1, 0.2], dtype=torch.float32, device=dev)
    if samples == "float32":
        stream = (stream.to(torch.float32) * res[:, None]).contiguous()
        res = torch.ones(3, dtype=torch.float32, device=dev)
    return stream, res


def launch_design(serve_mega_cuda, fn):
    """Call ``fn`` (one megakernel launch) and return it with the design
    the launch took (``serve_mega_cuda.MEGA_DESIGNS``; int16 samples and
    generic sizes always ``ring``, whose counters do not move)."""
    before = serve_mega_cuda.F32S_DESIGN_TILES
    out = fn()
    return out, "tiles" if serve_mega_cuda.F32S_DESIGN_TILES > before else "ring"


def mega_timing(torch, serve_mega, serve_mega_cuda, W, dev, n, bandwidth, f32_peak, smi,
                precision="f32", samples="int16", launches=None):
    """Megakernel (at ``precision``, on int16 or float32 ``samples``) and
    plain times on ``n`` full windows; int8/int4 margins are held against
    the quantized ingest kernel's rows of the same windows dotted with
    the weights. ``launches``: the instantiation's launches over its
    path, printed beside its times."""
    from eeg_dataanalysispackage_tpu_torch.ops import ingest_cuda

    stride = serve_mega.padded_stride(100, 750)
    gen = torch.Generator(device=dev).manual_seed(n)
    stream, res = timing_stream(torch, dev, gen, n, stride, samples)
    weights = torch.randn(48, generator=gen, device=dev, dtype=torch.float32)
    args = (stream, res, W, weights, 100, 175, stride, precision)
    got, design = launch_design(serve_mega_cuda, lambda: serve_mega_cuda.serve_mega_margins(*args))
    if precision == "f32":
        want = serve_mega.serve_mega_margins_plain(*args)
    else:
        starts = torch.arange(n, dtype=torch.int32, device=dev) * stride
        want = ingest_cuda.ingest_features(stream, res, starts, W, 100, 175, precision) @ weights
    err = (got - want).abs().max().item()
    if err > MARGIN_TOL_PER_L1 * weights.abs().sum().item():
        raise AssertionError(f"megakernel ({precision}) disagrees at the timing size {n}: {err}")
    kernel_ms = time_ms(lambda: serve_mega_cuda.serve_mega_margins(*args))
    device_ms = profiled_device_ms(lambda: serve_mega_cuda.serve_mega_margins(*args),
                                   "serve_mega_kernel")
    clock = sm_clock_mhz()
    plain_ms = time_ms(lambda: serve_mega.serve_mega_margins_plain(*args))
    bound_ms, bound_by, bytes_moved, flops = mega_bound(n, bandwidth, f32_peak,
                                                        stream.element_size())
    name = ("serve_mega" if precision == "f32" else f"serve_mega_{precision}") + (
        "_f32s" if samples == "float32" else "")
    emit("timing", kernel=name, windows=n, stride=stride, kernel_ms=kernel_ms,
         kernel_device_ms=device_ms, sm_clock_mhz=clock, plain_ms=plain_ms, bound_ms=bound_ms,
         bound_by=bound_by,
         bytes=bytes_moved, flops=flops, library_ms=None, max_abs_err=err, launches=launches,
         design=design, nvidia_smi=smi)
    return kernel_ms, plain_ms, bound_ms, bound_by, err


def mega_multi_timing(torch, serve_mega, serve_mega_cuda, W, dev, n, bandwidth, f32_peak,
                      smi, samples="int16", launches=None):
    """K6 (on int16 or float32 ``samples``) and its plain version on ``n``
    full windows, lanes cycling over 128 tenants; held against the plain
    version and, bit for bit, against the solo megakernel per lane.
    Bound: the megakernel's bytes plus the lanes (4 B a window) and the
    128-lane stack read once."""
    stride = serve_mega.padded_stride(100, 750)
    gen = torch.Generator(device=dev).manual_seed(n + 1)
    stream, res = timing_stream(torch, dev, gen, n, stride, samples)
    stack = torch.randn((serve_mega.MAX_TENANTS, 48), generator=gen, device=dev)
    lanes = torch.arange(n, dtype=torch.int32) % serve_mega.MAX_TENANTS
    args = (stream, res, W, stack, lanes, 100, 175, stride)
    got, design = launch_design(serve_mega_cuda,
                                lambda: serve_mega_cuda.serve_mega_multi_margins(*args))
    err = (got - serve_mega.serve_mega_multi_margins_plain(*args)).abs().max().item()
    if err > MARGIN_TOL_PER_L1 * stack.abs().sum(dim=1).max().item():
        raise AssertionError(f"K6 disagrees at the timing size {n}: {err}")
    for lane in [t for t in (0, 63, 127) if t < n]:
        rows = torch.arange(lane, n, serve_mega.MAX_TENANTS, device=dev)
        solo = serve_mega_cuda.serve_mega_margins(stream, res, W, stack[lane], 100, 175, stride)
        if got[rows].cpu().numpy().tobytes() != solo[rows].cpu().numpy().tobytes():
            raise AssertionError(f"K6 lane {lane} is not the solo kernel's at size {n}")
    kernel_ms = time_ms(lambda: serve_mega_cuda.serve_mega_multi_margins(*args))
    device_ms = profiled_device_ms(lambda: serve_mega_cuda.serve_mega_multi_margins(*args),
                                   "serve_mega_kernel")
    clock = sm_clock_mhz()
    plain_ms = time_ms(lambda: serve_mega.serve_mega_multi_margins_plain(*args))
    _bound, _by, mega_bytes, flops = mega_bound(n, bandwidth, f32_peak, stream.element_size())
    bytes_moved = mega_bytes - 48 * 4 + serve_mega.MAX_TENANTS * 48 * 4 + n * 4
    bound_ms, bound_by = timed_bound(bytes_moved, flops, bandwidth, f32_peak)
    emit("timing", kernel="serve_mega_multi" + ("_f32s" if samples == "float32" else ""),
         windows=n, stride=stride, tenants=128,
         kernel_ms=kernel_ms, kernel_device_ms=device_ms, sm_clock_mhz=clock, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by, bytes=bytes_moved, flops=flops,
         library_ms=None, max_abs_err=err, launches=launches, design=design, nvidia_smi=smi)
    return kernel_ms, plain_ms, bound_ms, bound_by, err



# ---------------------------------------------------------------------------
# The generic engine (every window and coefficient count but 512 / 16) and
# the quantized tenant stack (K6-w8, K6-w4)

# (epoch_size, feature_size, skip) off the main path, on 3 channels; the
# 76-channel montage runs at GENERIC_WIDE; the generic paths of phases 4
# and 5 run at GENERIC_PATH_SIZE (the saved model's 48 weights fit it)
GENERIC_SIZES = ((256, 16, 175), (512, 64, 175), (333, 20, 100), (700, 32, 50))
GENERIC_WIDE = (333, 20, 100)
GENERIC_PATH_SIZE = (256, 16, 175)
PACKED = ("int8", "int4")


def packed_stack(np, torch, dev, rng, terms, wp):
    """A random (terms, 128) host mirror with a freed (zero) lane 5,
    quantized as the multiplexed engine publishes it (tenant-major packed
    rows and scales on ``dev``), and the stack dequantized on the card
    ((128, terms) float32)."""
    from eeg_dataanalysispackage_tpu_torch.ops import quant

    w = rng.randn(terms, 128).astype(np.float32)
    w[:, 5] = 0.0
    packed_np, scales_np = quant.quantize_weight_stack(w, wp)
    packed = torch.from_numpy(np.ascontiguousarray(packed_np.T)).to(dev)
    scales = torch.from_numpy(scales_np).to(dev)
    deq = quant.dequantize_weight_stack(packed.t(), scales, wp, terms).t().contiguous()
    return packed, scales, deq


def phase_packed_cases(torch, np, serve_mega, serve_mega_cuda, W, dev):
    """K6-w8 and K6-w4 at the main path's size: margins bit-equal to K6 on
    the dequantized 128-lane stack (dequantized on the card), within
    MARGIN_TOL_PER_L1 * ||w_lane||_1 of the plain version; padded rows
    and the freed lane exactly 0; DC-heavy windows, n = 1 and n =
    capacity at capacity 64 and 2,048, lanes cycling over all 128 or all
    on one; and K6-w8-f32s and K6-w4-f32s, the float32-sample
    instantiations, on float32 streams of the same windows, against
    K6-f32s. Returns {weights precision (with ``_f32s``: on float32
    samples): worst deviation from plain}."""
    worst = {}
    for wp, samples in [(wp, s) for s in ("int16", "float32") for wp in PACKED]:
        key = wp + ("_f32s" if samples == "float32" else "")
        worst[key] = 0.0
        for capacity, n in ((64, 1), (64, 64), (2048, 2048)):
            for spread in ("cycling", "one_lane"):
                stream, res, _w, stride = mega_batch(torch, np, serve_mega, dev, capacity, n,
                                                     (30000, -30000, 29500), 1500,
                                                     seed=capacity + n, samples=samples)
                rng = np.random.RandomState(capacity + n)
                packed, scales, deq = packed_stack(np, torch, dev, rng, 48, wp)
                lanes_np = multi_lanes(np, capacity, n, spread)
                lanes = torch.from_numpy(lanes_np)
                got = serve_mega_cuda.serve_mega_multi_packed_margins(
                    stream, res, W, packed, scales, lanes, 100, 175, stride, wp)
                torch.cuda.synchronize()
                k6 = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, deq, lanes, 100,
                                                              175, stride)
                got_np = got.cpu().numpy()
                bit_equal = got_np.tobytes() == k6.cpu().numpy().tobytes()
                plain = serve_mega.serve_mega_multi_packed_margins_plain(
                    stream, res, W, packed, scales, lanes, 100, 175, stride, wp)
                l1 = deq.abs().sum(dim=1).cpu().numpy()[lanes_np]
                dev_rows = np.abs(got_np - plain.cpu().numpy())
                within = bool((dev_rows <= MARGIN_TOL_PER_L1 * l1).all())
                pad_zero = bool((got_np[n:] == 0).all())
                freed_zero = bool((got_np[:n][lanes_np[:n] == 5] == 0).all())
                emit("mega_multi_packed_vs_k6", weights_precision=wp, samples=samples,
                     case=f"cap{capacity}_n{n}_{spread}", capacity=capacity, windows=n,
                     bit_equal_k6_dequantized=bit_equal, max_abs_err=float(dev_rows.max()),
                     tol_per_l1=MARGIN_TOL_PER_L1, within_tol=within, padded_rows_zero=pad_zero,
                     freed_lane_zero=freed_zero)
                if not (bit_equal and within and pad_zero and freed_zero):
                    raise AssertionError(f"K6-{wp} ({samples}) disagrees at capacity "
                                         f"{capacity}, n {n}")
                worst[key] = max(worst[key], float(dev_rows.max()))
    return worst


def phase_float_wide_cases(torch, np, serve_mega, serve_mega_cuda, W, dev):
    """The float32-sample megakernels on wide montages at 512 / 16 (a
    float ring slot holds half an int16 slot's samples, so the ring's
    pieces of channels differ): K5-f32s at 64 and 76 channels within
    MARGIN_TOL_PER_L1 * ||w||_1 of the plain version, K6-f32s bit-equal
    per lane to K5-f32s; 77 channels, past the one-window-per-block
    kernels' reach, raise and count no launch. Returns the worst
    deviation."""
    stride = serve_mega.padded_stride(100, 750)
    worst = 0.0
    for C in (64, 76, 77):
        rng = np.random.RandomState(C)
        windows = [int16_rows(np, rng, C, 850) for _ in range(5)]
        stream = (torch.from_numpy(serve_mega.stage_mega_stream(windows, C, 850, stride, 5))
                  .to(dev).to(torch.float32) * 0.1).contiguous()
        ones = torch.ones(C, dtype=torch.float32, device=dev)
        weights = torch.from_numpy(rng.randn(C * 16).astype(np.float32)).to(dev)
        before = serve_mega_cuda.LAUNCHES_F32S
        if C == 77:
            try:
                serve_mega_cuda.serve_mega_margins(stream, ones, W, weights, 100, 175, stride)
            except RuntimeError as e:
                refused = "launch failed" in str(e)
            else:
                refused = False
            emit("mega_float_wide", channels=C, refused=refused,
                 launches_counted=serve_mega_cuda.LAUNCHES_F32S - before)
            if not refused or serve_mega_cuda.LAUNCHES_F32S != before:
                raise AssertionError("77 float channels were not refused")
            continue
        got = serve_mega_cuda.serve_mega_margins(stream, ones, W, weights, 100, 175, stride)
        want = serve_mega.serve_mega_margins_plain(stream, ones, W, weights, 100, 175, stride)
        err = (got - want).abs().max().item()
        stack = torch.from_numpy(rng.randn(128, C * 16).astype(np.float32)).to(dev)
        lanes = torch.tensor([5, 127, 0, 64, 5], dtype=torch.int32)
        multi = serve_mega_cuda.serve_mega_multi_margins(stream, ones, W, stack, lanes, 100, 175,
                                                         stride).cpu()
        per_lane = True
        for lane in (0, 5, 64, 127):
            solo = serve_mega_cuda.serve_mega_margins(stream, ones, W, stack[lane], 100, 175,
                                                      stride).cpu()
            rows = (lanes == lane).nonzero().flatten()
            per_lane = per_lane and multi[rows].numpy().tobytes() == solo[rows].numpy().tobytes()
        tol = MARGIN_TOL_PER_L1 * weights.abs().sum().item()
        emit("mega_float_wide", channels=C, max_abs_err=err, tol=tol,
             k6_bit_equal_k5_per_lane=per_lane)
        if not (err <= tol and per_lane):
            raise AssertionError(f"the float32 megakernels disagree at {C} channels")
        worst = max(worst, err)
    return worst


def int16_rows(np, rng, C, length, dc_scale=1.0):
    """(C, length) int16 noise over per-channel DC offsets."""
    dc = np.resize(np.array([15000, -12000, 9000]), C)[:, None] * dc_scale
    x = rng.randint(-3000, 3000, size=(C, length)) + dc
    return np.clip(x, -32768, 32767).astype(np.int16)


def phase_generic_cases(torch, np, dwt, ingest_cuda, device_ingest, serve_mega,
                        serve_mega_cuda, dev):
    """The generic engine against its plain version, at every size of
    GENERIC_SIZES on 3 channels and at GENERIC_WIDE on 76: K1 at every
    rung on int16 windows (f32 and bf16 within KERNEL_TOL; int8/int4 equal
    bit for bit to the plain quantizer on the kernel's own f32 rows, and
    against the plain chain within KERNEL_TOL except counted boundary
    flips) and f32 on a float32 stream, starts over the stream's edges;
    K5 at f32/int8/int4, K6 and K6-w8/w4 on a capacity-128 batch of 77
    windows: f32 margins within MEGA_GATE_TOL of the plain version,
    int8/int4 within MARGIN_TOL_PER_L1 * ||w||_1 of the quantized generic
    rows dotted with w (and within the rung's gate of the plain version),
    K6 bit-equal per lane to K5, K6-w8/w4 bit-equal to K6 on the
    dequantized stack and within MEGA_GATE_TOL of their plain version,
    padded rows 0. Returns {kernel name: worst deviation}."""
    from eeg_dataanalysispackage_tpu_torch.ops import decode_ingest

    worst = {}

    def note(name, err):
        worst[name] = max(worst.get(name, 0.0), err)

    for (n, K, skip), C in [(size, 3) for size in GENERIC_SIZES] + [(GENERIC_WIDE, 76)]:
        label = f"n{n}_K{K}_skip{skip}_C{C}"
        rng = np.random.RandomState(n + K + C)
        W = dwt.kernel_operator(8, n, K, dev)
        S = 120_000
        raw = torch.from_numpy(int16_rows(np, rng, C, S)).to(dev)
        res = torch.full((C,), 0.1, dtype=torch.float32, device=dev)
        starts_np = np.concatenate([np.sort(rng.randint(0, S - 1000, size=300)),
                                    [-150, -1, 0, 3, S - n - skip - 100, S - 5, S, S + 7]])
        starts = torch.from_numpy(starts_np.astype(np.int32)).to(dev)
        at_end = torch.from_numpy(starts_np >= S).to(dev)
        args = (raw, res, starts, W, 100, skip)
        f32 = ingest_cuda.ingest_features(*args, "f32", n, K)
        torch.cuda.synchronize()
        err = (f32 - device_ingest.ingest_features_plain(*args)).abs().max().item()
        ok = (err <= KERNEL_TOL and bool((f32[at_end] == 0).all())
              and bool(torch.isfinite(f32).all()) and f32.shape == (len(starts_np), C * K))
        fields = {"f32": err}
        note("ingest_features_any", err)
        bf16 = ingest_cuda.ingest_features(*args, "bf16", n, K)
        err = (bf16 - device_ingest.ingest_features_plain(*args, "bf16")).abs().max().item()
        ok = ok and err <= KERNEL_TOL
        fields["bf16"] = err
        note("ingest_features_any_bf16", err)
        f32_cpu = f32.cpu()
        for precision, qmax in (("int8", 127.0), ("int4", 7.0)):
            q = ingest_cuda.ingest_features(*args, precision, n, K)
            want = decode_ingest.quantize_dequantize(f32_cpu, K, qmax)[0]
            bit_equal = q.cpu().numpy().tobytes() == want.numpy().tobytes()
            plain = device_ingest.ingest_features_plain(*args, precision)
            flips, err = flip_check(np, q.cpu(), plain.cpu(), f32_cpu, precision, label, K)
            ok = ok and bit_equal
            fields[precision] = {"epilogue_bit_equal": bit_equal, "flips_vs_plain": flips,
                                 "max_abs_err": err}
            note(f"ingest_features_any_{precision}", err)
        # float32 samples, staged already scaled with unit resolutions
        raw_f = (raw.to(torch.float32) * 0.1).contiguous()
        ones = torch.ones(C, dtype=torch.float32, device=dev)
        got = ingest_cuda.ingest_features(raw_f, ones, starts, W, 100, skip, "f32", n, K)
        err = (got - device_ingest.ingest_features_plain(raw_f, ones, starts, W, 100, skip)
               ).abs().max().item()
        ok = ok and err <= KERNEL_TOL
        fields["f32_samples"] = err
        note("ingest_features_any_f32", err)
        emit("generic_ingest_vs_plain", case=label, windows=int(len(starts_np)), tol=KERNEL_TOL,
             **fields)
        if not ok:
            raise AssertionError(f"the generic ingest engine disagrees on {label}: {fields}")

        capacity, count = 128, 77
        stride = serve_mega.padded_stride(100, 750)
        windows = [int16_rows(np, rng, C, 850) for _ in range(count)]
        stream16 = torch.from_numpy(
            serve_mega.stage_mega_stream(windows, C, 850, stride, capacity)).to(dev)
        mstarts = torch.arange(capacity, dtype=torch.int32, device=dev) * stride
        weights = torch.from_numpy(rng.randn(C * K).astype(np.float32)).to(dev)
        margin_tol = serve_mega.MEGA_GATE_TOL
        stack = torch.from_numpy(rng.randn(128, C * K).astype(np.float32)).to(dev)
        lanes_np = np.where(np.arange(capacity) < count, rng.randint(0, 128, capacity),
                            0).astype(np.int32)
        lanes = torch.from_numpy(lanes_np)
        packed_stacks = {wp: packed_stack(np, torch, dev, rng, C * K, wp) for wp in PACKED}
        # int16 samples, then the same windows scaled into float32 samples
        # with unit resolutions (the _f32s instantiations)
        for samples in ("int16", "float32"):
            suffix = "_f32s" if samples == "float32" else ""
            if samples == "int16":
                stream, sres = stream16, res
            else:
                stream = (stream16.to(torch.float32) * res[:, None]).contiguous()
                sres = torch.ones(C, dtype=torch.float32, device=dev)
            mfields, ok = {}, True
            for precision in ("f32", "int8", "int4"):
                got = serve_mega_cuda.serve_mega_margins(stream, sres, W, weights, 100, skip,
                                                         stride, precision, n, K)
                torch.cuda.synchronize()
                plain = serve_mega.serve_mega_margins_plain(stream, sres, W, weights, 100, skip,
                                                            stride, precision)
                dev_plain = (got - plain).abs().max().item()
                pad_zero = bool((got[count:] == 0).all())
                if precision == "f32":
                    good, err = dev_plain <= margin_tol, dev_plain
                    name = "serve_mega_any" + suffix
                else:
                    rows = ingest_cuda.ingest_features(stream, sres, mstarts, W, 100, skip,
                                                       precision, n, K)
                    err = (got - rows @ weights).abs().max().item()
                    gate = max(margin_tol, decode_ingest.precision_gate_tolerance(precision))
                    good = (err <= MARGIN_TOL_PER_L1 * weights.abs().sum().item()
                            and dev_plain <= gate)
                    name = f"serve_mega_any_{precision}{suffix}"
                ok = ok and good and pad_zero
                mfields[name] = {"max_abs_err": err, "max_dev_vs_plain": dev_plain,
                                 "padded_rows_zero": pad_zero}
                note(name, err)
            margs = (stream, sres, W)
            multi = serve_mega_cuda.serve_mega_multi_margins(*margs, stack, lanes, 100, skip,
                                                             stride, n, K)
            plain = serve_mega.serve_mega_multi_margins_plain(*margs, stack, lanes, 100, skip,
                                                              stride)
            err = (multi - plain).abs().max().item()
            multi_np = multi.cpu().numpy()
            per_lane = True
            for lane in np.unique(lanes_np[:count])[:6]:
                solo = serve_mega_cuda.serve_mega_margins(*margs, stack[int(lane)], 100, skip,
                                                          stride, "f32", n, K).cpu().numpy()
                rows = np.nonzero(lanes_np[:count] == lane)[0]
                per_lane = per_lane and multi_np[rows].tobytes() == solo[rows].tobytes()
            ok = (ok and err <= margin_tol and per_lane
                  and bool((multi_np[count:] == 0).all()))
            mfields["serve_mega_multi_any" + suffix] = {"max_abs_err": err,
                                                        "bit_equal_k5_per_lane": per_lane}
            note("serve_mega_multi_any" + suffix, err)
            for wp in PACKED:
                packed, scales, deq = packed_stacks[wp]
                got = serve_mega_cuda.serve_mega_multi_packed_margins(
                    *margs, packed, scales, lanes, 100, skip, stride, wp, n, K)
                k6 = serve_mega_cuda.serve_mega_multi_margins(*margs, deq, lanes, 100, skip,
                                                              stride, n, K)
                bit_equal = got.cpu().numpy().tobytes() == k6.cpu().numpy().tobytes()
                plain = serve_mega.serve_mega_multi_packed_margins_plain(
                    *margs, packed, scales, lanes, 100, skip, stride, wp)
                err = (got - plain).abs().max().item()
                ok = (ok and bit_equal and err <= margin_tol
                      and bool((got[count:] == 0).all()))
                mfields[f"serve_mega_multi_any_{wp}{suffix}"] = {
                    "max_abs_err": err, "bit_equal_k6_dequantized": bit_equal}
                note(f"serve_mega_multi_any_{wp}{suffix}", err)
            emit("generic_mega_vs_plain", case=label, samples=samples, capacity=capacity,
                 windows=count, margin_tol=margin_tol, **mfields)
            if not ok:
                raise AssertionError(f"the generic megakernel disagrees on {label} "
                                     f"({samples}): {mfields}")
    return worst


#: the wrappers' counters of generic launches by design (``ingest_cuda``,
#: ``serve_mega_cuda``), and the runs' per-design launches, by kernel, that
#: phases 4 and 5 gather for the ``generic_designs`` line
DESIGN_COUNTERS = ("ANY_DESIGN_PHASE", "ANY_DESIGN_RING")
GENERIC_DESIGNS = []


def generic_design(counter: str) -> str:
    """The design a ``DESIGN_COUNTERS`` counter counts."""
    return counter[len("ANY_DESIGN_"):].lower()


def phase_generic_paths(np, torch, info, float_info, n_files, n_float_files):
    """The fused batch path at GENERIC_PATH_SIZE, through
    ``OfflineDataProvider.load_features_device(epoch_size=…,
    feature_size=…)``: the 8-recording session at each precision= rung and
    the float32 session at f32, every ingest counter set to 0 just before
    each run and read just after (the rung's generic counter one launch
    per recording, every other counter 0); features against the CPU
    provider's (f32 and bf16 within KERNEL_TOL, int8/int4 except counted
    boundary flips). Returns {kernel name: launches}."""
    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
    from eeg_dataanalysispackage_tpu_torch.ops import ingest_cuda

    n, K, skip = GENERIC_PATH_SIZE
    counters = {name: attr for name, attr in (
        ("ingest_features", "LAUNCHES"), ("ingest_features_f32", "LAUNCHES_F32"),
        ("ingest_features_bf16", "LAUNCHES_BF16"), ("ingest_features_int8", "LAUNCHES_INT8"),
        ("ingest_features_int4", "LAUNCHES_INT4"), ("ingest_features_any", "ANY_LAUNCHES"),
        ("ingest_features_any_f32", "ANY_LAUNCHES_F32"),
        ("ingest_features_any_bf16", "ANY_LAUNCHES_BF16"),
        ("ingest_features_any_int8", "ANY_LAUNCHES_INT8"),
        ("ingest_features_any_int4", "ANY_LAUNCHES_INT4"))}
    launches, f32_rows = {}, None
    for precision, path, kernel, files in (
            ("f32", info, "ingest_features_any", n_files),
            ("bf16", info, "ingest_features_any_bf16", n_files),
            ("int8", info, "ingest_features_any_int8", n_files),
            ("int4", info, "ingest_features_any_int4", n_files),
            ("f32", float_info, "ingest_features_any_f32", n_float_files)):
        for attr in (*counters.values(), *DESIGN_COUNTERS):
            setattr(ingest_cuda, attr, 0)
        t0 = time.perf_counter()
        with PlanLog() as plans:
            feats, targets = OfflineDataProvider([path]).load_features_device(
                8, n, skip, K, precision=precision)
        wall = time.perf_counter() - t0
        counts = {name: getattr(ingest_cuda, attr) for name, attr in counters.items()}
        designs = {attr: getattr(ingest_cuda, attr) for attr in DESIGN_COUNTERS}
        cpu_feats, cpu_targets = OfflineDataProvider([path], device="cpu").load_features_device(
            8, n, skip, K, precision=precision)
        got = feats.cpu()
        if kernel == "ingest_features_any":
            f32_rows = got
        if precision in PACKED:
            flips, err = flip_check(np, got, cpu_feats, f32_rows, precision, kernel, K)
        else:
            flips, err = 0, (got - cpu_feats).abs().max().item()
        emit("generic_path", kernel=kernel, precision=precision, epoch_size=n, feature_size=K,
             skip=skip, rows=int(got.shape[0]), device=str(feats.device), launches=counts,
             designs=designs, plans=plans.summary(), wall_s=wall,
             features_max_abs_err_vs_cpu=err, feature_flips_vs_cpu=flips, tol=KERNEL_TOL)
        GENERIC_DESIGNS.append((kernel, plans.designs()))
        others = {k: v for k, v in counts.items() if k != kernel}
        if not (feats.device.type == "cuda" and counts[kernel] == files
                and sum(designs.values()) == files and plans.designs() == {
                    generic_design(a): v for a, v in designs.items()}
                and not any(others.values()) and got.shape == (len(targets), 3 * K)
                and err <= KERNEL_TOL and np.array_equal(targets, cpu_targets)):
            raise AssertionError(f"the generic fused path ({precision}) did not run as expected: "
                                 f"{counts}, err {err}")
        launches[kernel] = counts[kernel]
    return launches


def batches_of(items, size=64):
    return [items[i:i + size] for i in range(0, len(items), size)]


def phase_generic_serve(torch, np, model, windows, resolutions):
    """Serving at GENERIC_PATH_SIZE: a ServingEngine of the saved model at
    precision f32, int8 and int4 (K5's generic engine) and a
    MultiplexedEngine of 128 tenants at weights_precision f32, int8 and
    int4 (K6's), each warmed up and fed every kept window in batches of
    64 (tenants interleaved), then the same on those windows scaled into
    float32 samples with unit resolutions (the ``_f32s`` instantiations);
    the megakernel counters set to 0 just before each run and read just
    after (the instantiation's generic counter at least one launch a
    batch, its other-sample twin only the warmup's and the mega gate's
    int16 batches, every other counter none); margins against the same
    engine on the CPU within MEGA_GATE_TOL (int8/int4 features: within
    the rung's gate). Returns {kernel name: launches}."""
    from eeg_dataanalysispackage_tpu_torch.models import registry
    from eeg_dataanalysispackage_tpu_torch.ops import (
        decode_ingest, ingest_cuda, serve_mega, serve_mega_cuda,
    )
    from eeg_dataanalysispackage_tpu_torch.serve import MultiplexedEngine, ServingEngine

    n, K, skip = GENERIC_PATH_SIZE
    base = registry.create("logreg")
    base.load(model)
    names = [f"t{i:03d}" for i in range(128)]
    tenants = {names[0]: base}
    tenants.update({name: perturbed_tenant(np, base, i) for i, name in enumerate(names) if i})
    mix = [names[i % 128] for i in range(len(windows))]
    attrs = [a for a in dir(serve_mega_cuda) if a.isupper() and "LAUNCHES" in a]
    float_windows_ = [(w.astype(np.float32) * r[:, None]).astype(np.float32)
                      for w, r in zip(windows, resolutions)]
    ones = np.ones(3, np.float32)
    sizes = dict(epoch_size=n, feature_size=K, skip_samples=skip, capacity=64)
    launches = {}
    runs = []
    for samples, suffix in (("int16", ""), ("float32", "_F32S")):
        runs += [("serve_mega_any" + ("" if p == "f32" else f"_{p}") + suffix.lower(),
                  "ANY_LAUNCHES" + ("" if p == "f32" else f"_{p.upper()}"), suffix,
                  lambda device, p=p: ServingEngine(base, precision=p, device=device, **sizes),
                  p, None, samples) for p in ("f32", "int8", "int4")]
        runs += [("serve_mega_multi_any" + ("" if p == "f32" else f"_{p}") + suffix.lower(),
                  "ANY_MULTI_LAUNCHES" + ("" if p == "f32" else f"_{p.upper()}"), suffix,
                  lambda device, p=p: MultiplexedEngine(tenants, weights_precision=p,
                                                        device=device, **sizes),
                  "f32", p, samples) for p in ("f32",) + PACKED]
    for kernel, stem, suffix, make, precision, wp, samples in runs:
        attr = stem + suffix
        twin = stem + ("" if suffix else "_F32S")
        ws = windows if samples == "int16" else float_windows_
        res = resolutions[0] if samples == "int16" else ones
        for a in attrs:
            setattr(serve_mega_cuda, a, 0)
        for module in (serve_mega_cuda, ingest_cuda):  # K1 runs the warmup's gates
            for a in DESIGN_COUNTERS:
                setattr(module, a, 0)
        t0 = time.perf_counter()
        with PlanLog() as plans:
            eng = make(None)
            eng.warmup()
            margins = []
            for i, chunk in enumerate(batches_of(ws)):
                args = (chunk, res)
                if wp is not None:
                    args += (mix[i * 64:i * 64 + len(chunk)],)
                margins.append(eng.execute(*args)[1])
        wall = time.perf_counter() - t0
        counts = {a: getattr(serve_mega_cuda, a) for a in attrs}
        designs = {a: getattr(serve_mega_cuda, a) for a in DESIGN_COUNTERS}
        gate_designs = {a: getattr(ingest_cuda, a) for a in DESIGN_COUNTERS}
        cpu = make("cpu")
        cpu.warmup()
        cpu_margins = [cpu.execute(chunk, res,
                                   *(() if wp is None else (mix[i * 64:i * 64 + len(chunk)],)))[1]
                       for i, chunk in enumerate(batches_of(ws))]
        gap = float(np.max(np.abs(np.concatenate(margins) - np.concatenate(cpu_margins))))
        tol = serve_mega.MEGA_GATE_TOL
        if precision != "f32":
            tol = max(tol, decode_ingest.precision_gate_tolerance(precision))
        emit("generic_serve", kernel=kernel, epoch_size=n, feature_size=K, skip=skip,
             samples=samples, precision=precision, weights_precision=wp, rung=eng.rung,
             weights_record=getattr(eng, "weights_record", None), windows=len(ws),
             launches={a: v for a, v in counts.items() if v}, designs=designs,
             gate_k1_designs=gate_designs, plans=plans.summary(), wall_s=wall,
             max_margin_dev_vs_cpu=gap, tol=tol)
        GENERIC_DESIGNS.append((kernel, {generic_design(a): v for a, v in designs.items()}))
        others = {a: v for a, v in counts.items() if a not in (attr, twin)}
        if not (eng.rung == "mega" and counts[attr] >= math.ceil(len(ws) / 64)
                and sum(designs.values()) == counts[attr] + counts[twin]
                and plans.designs() == {generic_design(a): v + gate_designs[a]
                                        for a, v in designs.items()}
                and 1 <= counts[twin] <= 2 and not any(others.values()) and gap <= tol
                and (wp is None or eng.weights_precision == wp)):
            raise AssertionError(f"the generic serve run ({kernel}) did not run as expected: "
                                 f"{counts}, gap {gap}")
        launches[kernel] = counts[attr]
    return launches


def phase_quant_multi_service(torch, np, model, kept, windows, resolutions):
    """The quantized tenant stack at full width: a MultiplexedService of
    128 tenants at weights_precision int8, then int4 (3 channels,
    512-sample windows, 48 features, capacity 64) serving the kept windows
    with tenants interleaved, a swap, a remove and an add made while the
    first half is in flight; K6-w8/w4's launches over the run (every
    counter set to 0 just before). Then, on the final tenants: the
    largest margin gap against an f32 service at the weights gate's
    tolerance; a 64-window mixed batch through K6-w8/w4 bit-equal to K6
    on the dequantized stack; the swap left every other lane's packed
    bytes, scale and margins unchanged. Returns {weights precision:
    launches}."""
    from eeg_dataanalysispackage_tpu_torch.models import registry
    from eeg_dataanalysispackage_tpu_torch.ops import (
        cuda_build, dwt, ingest_cuda, quant, serve_mega, serve_mega_cuda,
    )
    from eeg_dataanalysispackage_tpu_torch.serve import MultiplexedService, RequestFailedError

    base = registry.create("logreg")
    base.load(model)
    names = [f"t{i:03d}" for i in range(128)]
    tenants = {names[0]: base}
    tenants.update({name: perturbed_tenant(np, base, i) for i, name in enumerate(names) if i})
    n = len(windows)
    mix = [names[i % 128] for i in range(n)]
    half = n // 2
    final_mix = ["newcomer" if t == "t006" else t for t in mix]
    counted = {"serve_mega_multi": (serve_mega_cuda, "MULTI_LAUNCHES"),
               "serve_mega_multi_int8": (serve_mega_cuda, "MULTI_LAUNCHES_INT8"),
               "serve_mega_multi_int4": (serve_mega_cuda, "MULTI_LAUNCHES_INT4"),
               "serve_mega": (serve_mega_cuda, "LAUNCHES"),
               "ingest_features": (ingest_cuda, "LAUNCHES")}
    swapped, newcomer = perturbed_tenant(np, base, 1005), perturbed_tenant(np, base, 1006)
    final = dict(tenants, t005=swapped, newcomer=newcomer)
    del final["t006"]
    out = {}
    for wp in PACKED:
        for module, attr in counted.values():
            setattr(module, attr, 0)
        t0 = time.perf_counter()
        svc = MultiplexedService(tenants, weights_precision=wp)
        with svc:
            eng = svc.engine
            loaded = dict(cuda_build._LOADED)
            budget = svc.config.default_deadline_s
            first = [svc.submit(w, r, tenant=t, deadline_s=budget, block_s=budget)
                     for w, r, t in zip(windows[:half], resolutions[:half], mix[:half])]
            before = eng._stack
            svc.swap_tenant("t005", swapped)
            after = eng._stack
            svc.remove_tenant("t006")
            lane_new = svc.add_tenant("newcomer", newcomer)
            second = svc.predict_all(windows[half:], resolutions[half:], final_mix[half:])
            removed_failed = 0
            for f, tenant in zip(first, mix[:half]):
                try:
                    f.result(timeout=budget + 30.0)
                except RequestFailedError as e:
                    if tenant != "t006" or "was removed" not in str(e):
                        raise
                    removed_failed += 1
            served = svc.predict_all(windows, resolutions, final_mix)
            block = svc.stats_block()
        wall = time.perf_counter() - t0
        launches = {k: getattr(m, a) for k, (m, a) in counted.items()}
        admin_built = dict(cuda_build._LOADED) != loaded
        with MultiplexedService(final) as ref:
            f32_served = ref.predict_all(windows, resolutions, final_mix)
        gap = max(abs(a.margin - b.margin) for a, b in zip(served, f32_served))
        tol = quant.weights_gate_tolerance(wp, eng._w_host)
        # one mixed batch: K6-w8/w4 against K6 on the stack dequantized on the card
        stack, lanes = eng._resolve(final_mix[:64], 64)
        lanes_host = eng._capacity_lanes(lanes)
        res_t = torch.from_numpy(resolutions[0]).to(eng.device)
        staged = torch.from_numpy(serve_mega.stage_mega_stream(
            windows[:64], 3, 850, eng._mega_stride, eng.capacity)).to(eng.device)
        packed_m = eng._mega_program(staged, res_t, stack.packed, stack.scales, lanes_host)
        deq = eng._f32_stack(stack)
        f32_m = serve_mega_cuda.serve_mega_multi_margins(
            staged, res_t, dwt.kernel_operator(8, 512, 16, eng.device), deq, lanes_host, 100,
            175, eng._mega_stride)
        bit_equal = packed_m.cpu().numpy().tobytes() == f32_m.cpu().numpy().tobytes()
        # the swap: every other lane's packed bytes, scale and margins unchanged
        swapped_lane = eng.tenant_info("t005")["lane"]
        others = [lane for lane in range(128) if lane != swapped_lane]
        bytes_same = (before.packed[others].cpu().numpy().tobytes()
                      == after.packed[others].cpu().numpy().tobytes()
                      and before.scales[others].cpu().numpy().tobytes()
                      == after.scales[others].cpu().numpy().tobytes())
        other_lanes = torch.from_numpy(np.asarray(
            [lane if lane != swapped_lane else 0 for lane in lanes_host.numpy()], np.int32))
        margins_same = (
            eng._mega_program(staged, res_t, before.packed, before.scales, other_lanes)
            .cpu().numpy().tobytes()
            == eng._mega_program(staged, res_t, after.packed, after.scales, other_lanes)
            .cpu().numpy().tobytes())
        req = block["requests"]
        kernel = f"serve_mega_multi_{wp}"
        emit("serve_multitenant_quantized", weights_precision=wp, tenants=128, rung=block["rung"],
             weights=block["weights"], resident_weight_bytes=block["resident_weight_bytes"],
             launches=launches, kept=kept, completed=req["completed"], failed=req["failed"],
             shed=req["shed"], removed_tenant_requests_failed=removed_failed,
             batches=block["batches"], mean_batch_size=block["mean_batch_size"],
             latency_ms=block["latency_ms"], mega_gate=block["mega"]["gate"], wall_s=wall,
             admin_built_nothing=not admin_built, new_tenant_lane=lane_new,
             max_margin_gap_vs_f32_service=gap, weights_gate_tolerance=tol,
             bit_equal_k6_dequantized=bit_equal, swap_left_other_lanes_bytes=bytes_same,
             swap_left_other_lanes_margins=margins_same)
        nbytes = {"int8": 6656, "int4": 3584}[wp]
        if not (block["rung"] == "mega" and block["weights_precision"] == wp
                and block["weights"]["used"] == wp and block["resident_weight_bytes"] == nbytes
                and block["mega"]["weights_precision"] == wp and not admin_built
                and launches[kernel] >= 2 * math.ceil(n / 64)
                and launches["serve_mega_multi"] == 0 and launches["serve_mega"] == 0
                and req["failed"] == removed_failed and req["shed"] == 0
                and gap <= tol and bit_equal and bytes_same and margins_same):
            raise AssertionError(f"the {wp} tenant stack did not serve as expected")
        out[wp] = launches[kernel]
    return out


def phase_bf16_host_runs(np, info, counters):
    """fe=dwt-8-tpu-bf16 and fe=dwt-8-tpu-compact-bf16 with logreg on the
    card and the CPU: the card run's features (its extractor on the run's
    test epochs) within BF16_GATE_TOL of the CPU run's, on the card, and
    both runs' statistics printed side by side; no kernel of the port
    launched (the contraction is a torch.matmul, as the JAX package's is
    XLA's)."""
    from eeg_dataanalysispackage_tpu_torch.ops import decode_ingest

    for fe in ("dwt-8-tpu-bf16", "dwt-8-tpu-compact-bf16"):
        q = f"info_file={info}&fe={fe}&train_clf=logreg"
        gpu = run_builder(f"{fe}_logreg_cuda", q, None, counters)
        cpu = run_builder(f"{fe}_logreg_cpu", q, "cpu", counters)
        if gpu[0].batch.epochs.tobytes() != cpu[0].batch.epochs.tobytes():
            raise AssertionError(f"{fe}: host epochs differ between the card and CPU runs")
        rows = np.asarray(gpu[0].test_index, dtype=np.int64)
        got = gpu[0].fe.extract_batch(gpu[0].batch.epochs[rows])
        want = cpu[0].fe.extract_batch(cpu[0].batch.epochs[rows])
        err = (got.cpu() - want).abs().max().item()
        emit("bf16_host_run", fe=fe, device=str(got.device), dtype=str(got.dtype),
             rows=int(len(rows)), features_max_abs_err_vs_cpu=err,
             tol=decode_ingest.BF16_GATE_TOL, launches=gpu[2],
             statistics_cuda=str(gpu[1]), statistics_cpu=str(cpu[1]),
             accuracy_cuda=gpu[1].calc_accuracy(), accuracy_cpu=cpu[1].calc_accuracy())
        if not (got.device.type == "cuda" and got.dtype.is_floating_point
                and err <= decode_ingest.BF16_GATE_TOL and not any(gpu[2].values())):
            raise AssertionError(f"{fe}: card features {err} from the CPU run's")


def packed_multi_timing(torch, serve_mega, serve_mega_cuda, W, dev, n, wp, bandwidth, f32_peak,
                        smi, launches, samples="int16"):
    """K6-w8 / K6-w4 (on int16 or float32 ``samples``) on ``n`` full
    windows, lanes cycling over 128 tenants, in the same process as K6:
    held bit for bit against K6 on the dequantized stack and against the
    plain version. Bound: K6's bytes with the packed stack and the scales
    in place of the f32 stack. ``launches``: the instantiation's launches
    over its path."""
    import numpy as np

    stride = serve_mega.padded_stride(100, 750)
    gen = torch.Generator(device=dev).manual_seed(n + 2)
    stream, res = timing_stream(torch, dev, gen, n, stride, samples)
    packed, scales, deq = packed_stack(np, torch, dev, np.random.RandomState(n), 48, wp)
    lanes = torch.arange(n, dtype=torch.int32) % serve_mega.MAX_TENANTS
    args = (stream, res, W, packed, scales, lanes, 100, 175, stride, wp)
    got, design = launch_design(
        serve_mega_cuda, lambda: serve_mega_cuda.serve_mega_multi_packed_margins(*args))
    k6 = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, deq, lanes, 100, 175, stride)
    if got.cpu().numpy().tobytes() != k6.cpu().numpy().tobytes():
        raise AssertionError(f"K6-{wp} is not K6 on the dequantized stack at size {n}")
    err = (got - serve_mega.serve_mega_multi_packed_margins_plain(*args)).abs().max().item()
    if err > MARGIN_TOL_PER_L1 * deq.abs().sum(dim=1).max().item():
        raise AssertionError(f"K6-{wp} disagrees with its plain version at size {n}: {err}")
    kernel_ms = time_ms(lambda: serve_mega_cuda.serve_mega_multi_packed_margins(*args))
    device_ms = profiled_device_ms(lambda: serve_mega_cuda.serve_mega_multi_packed_margins(*args),
                                   "serve_mega_kernel")
    clock = sm_clock_mhz()
    plain_ms = time_ms(lambda: serve_mega.serve_mega_multi_packed_margins_plain(*args))
    _bound, _by, mega_bytes, flops = mega_bound(n, bandwidth, f32_peak, stream.element_size())
    stack_bytes = packed.numel() * packed.element_size() + scales.numel() * 4
    bytes_moved = mega_bytes - 48 * 4 + stack_bytes + n * 4
    bound_ms, bound_by = timed_bound(bytes_moved, flops, bandwidth, f32_peak)
    emit("timing", kernel=f"serve_mega_multi_{wp}" + ("_f32s" if samples == "float32" else ""),
         windows=n, stride=stride, tenants=128,
         kernel_ms=kernel_ms, kernel_device_ms=device_ms, sm_clock_mhz=clock, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by, bytes=bytes_moved, flops=flops,
         library_ms=None, max_abs_err=err, bit_equal_k6_dequantized=True, launches=launches,
         design=design, nvidia_smi=smi)
    return kernel_ms, plain_ms, bound_ms, bound_by, err


def generic_timing(torch, np, dwt, ingest_cuda, device_ingest, serve_mega, serve_mega_cuda, dev,
                   sizes, bandwidth, f32_peak, bf16_peak, smi, launches, n=4096, serve_batch=64):
    """The generic instantiations at ``n`` windows, 3 channels, for each
    (epoch_size, feature_size, skip) of ``sizes``, and at one serve batch
    (``serve_batch`` windows) at GENERIC_PATH_SIZE: K1 at each rung on an
    int16 stream (1,000-sample stride) and f32 on a float32 one; K5 at
    f32/int8/int4, K6 and K6-w8/w4 at the serve stride (lanes cycling).
    Each beside its plain version's time, its bound (the needed samples
    read once, rows or margins written once, operator, weights or stack,
    lanes and resolutions once; operations against the float32 peak, the
    bf16 rung's against the bf16 tensor-core peak), the windows a tile its
    launch planned (``planned_m``, ``ops/generic_plan.py``) and
    ``library_ms``: one ``torch.matmul`` of the (windows * 3, epoch_size)
    centred windows with W, TF32 off, the contraction alone
    (``library_device_ms``: its GEMM's device time). Returns {(kernel,
    size): (ms, plain ms, bound ms, bound by, max abs err, library ms)}
    at ``n`` windows and {(kernel, size, serve_batch): ...} at the serve
    batch; the outputs are held as in phase 3 (rows within KERNEL_TOL,
    int8/int4 bit for bit to the plain quantizer on the kernel's f32 rows,
    margins within MEGA_GATE_TOL, K6-w8/w4 bit-equal to K6 on the
    dequantized stack). ``launches``: each instantiation's launches over its
    path (phases 4 and 5), printed beside its times."""
    from eeg_dataanalysispackage_tpu_torch.ops import decode_ingest, generic_plan

    out = {}
    sms, optin = ingest_cuda.device_limits(dev)
    res = torch.tensor([0.1, 0.1, 0.2], dtype=torch.float32, device=dev)
    stride = serve_mega.padded_stride(100, 750)
    cases = [(size, n) for size in sizes] + [(GENERIC_PATH_SIZE, serve_batch)]
    for size, rows in cases:
        e, K, skip = size
        key = (size,) if rows == n else (size, rows)
        gen = torch.Generator(device=dev).manual_seed(rows)
        S = rows * 1000 + 1000
        big = torch.randint(-3000, 3000, (3, S), generator=gen, device=dev, dtype=torch.int32)
        starts = torch.arange(rows, device=dev, dtype=torch.int32) * 1000
        stream = torch.randint(-3000, 3000, (3, rows * stride), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int16)
        mstarts = torch.arange(rows, dtype=torch.int32, device=dev) * stride
        lanes = torch.arange(rows, dtype=torch.int32) % serve_mega.MAX_TENANTS
        W = dwt.kernel_operator(8, e, K, dev)
        # the contraction alone by one library call, on the centred windows
        windows = (big[:, (starts.long() + 100 + skip)[:, None]
                       + torch.arange(e, device=dev)].to(torch.float32)
                   * res[:, None, None])
        windows = windows - windows.mean(dim=2, keepdim=True)
        Z = windows.permute(1, 0, 2).reshape(rows * 3, e).contiguous()
        del windows
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            library_ms = time_ms(lambda: torch.matmul(Z, W))
            library_device_ms = profiled_device_ms(lambda: torch.matmul(Z, W), "gemm")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        del Z

        def record(name, fn, plain_fn, err, bytes_moved, flops, symbol, sample_bytes=2,
                   peak=f32_peak):
            kernel_ms = time_ms(fn)
            device_ms = profiled_device_ms(fn, symbol)
            plain_ms = time_ms(plain_fn)
            bound_ms, bound_by = timed_bound(bytes_moved, flops, bandwidth, peak)
            plan = generic_plan.generic_tile_plan(3, e, K, rows, sms, optin, 100, sample_bytes)
            emit("timing", kernel=name, windows=rows, epoch_size=e, feature_size=K, skip=skip,
                 design=generic_plan.DESIGNS[plan.design],
                 kernel_ms=kernel_ms, kernel_device_ms=device_ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, bytes=bytes_moved, flops=flops,
                 library_ms=library_ms, library_device_ms=library_device_ms,
                 library="torch.matmul of the centred windows with W, TF32 off "
                         "(contraction only)",
                 planned_m=plan.m, plan=plan._asdict(), max_abs_err=err,
                 launches=launches[name], nvidia_smi=smi)
            out[(name, *key)] = (kernel_ms, plain_ms, bound_ms, bound_by, err, library_ms)

        for dtype, precision in ((torch.int16, "f32"), (torch.int16, "bf16"),
                                 (torch.int16, "int8"), (torch.int16, "int4"),
                                 (torch.float32, "f32")):
            raw = big.to(dtype) if dtype == torch.int16 else (big.to(torch.float32) * 0.1)
            rs = res if dtype == torch.int16 else torch.ones(3, device=dev)
            args = (raw, rs, starts, W, 100, skip, precision, e, K)
            got = ingest_cuda.ingest_features(*args)
            plain_args = (raw, rs, starts, W, 100, skip, precision)
            if precision in PACKED:
                f32 = ingest_cuda.ingest_features(raw, rs, starts, W, 100, skip, "f32", e, K).cpu()
                qmax = 127.0 if precision == "int8" else 7.0
                want = decode_ingest.quantize_dequantize(f32, K, qmax)[0]
                err = (got.cpu() - want).abs().max().item()
                if err != 0.0:
                    raise AssertionError(f"generic {precision} epilogue differs at {size}")
            else:
                err = (got - device_ingest.ingest_features_plain(*plain_args)).abs().max().item()
                if err > KERNEL_TOL:
                    raise AssertionError(f"generic ingest ({precision}) disagrees at {size}: "
                                         f"{err}")
            del got
            samples = needed_samples(starts.cpu().numpy(), S, 100, skip, e)
            bytes_moved = (3 * samples * raw.element_size() + rows * 3 * K * 4 + rows * 4
                           + W.numel() * 4 + 3 * 4)
            name = "ingest_features_any" + ("_f32" if dtype == torch.float32 else
                                            ("" if precision == "f32" else f"_{precision}"))
            record(name, lambda a=args: ingest_cuda.ingest_features(*a),
                   lambda a=plain_args: device_ingest.ingest_features_plain(*a), err,
                   bytes_moved, 2 * rows * 3 * e * K, "ingest_features_any_kernel",
                   raw.element_size(), bf16_peak if precision == "bf16" else f32_peak)
            del raw
        weights = torch.randn(3 * K, generator=gen, device=dev)
        stack = torch.randn((128, 3 * K), generator=gen, device=dev)
        packed_stacks = {wp: packed_stack(np, torch, dev, np.random.RandomState(K), 3 * K, wp)
                         for wp in PACKED}
        flops = 2 * rows * 3 * e * K + 2 * rows * 3 * K
        # int16 samples, then the same windows scaled into float32 samples
        # with unit resolutions (the _f32s instantiations)
        for samples in ("int16", "float32"):
            suffix = "_f32s" if samples == "float32" else ""
            if samples == "int16":
                sstream, sres = stream, res
            else:
                sstream = (stream.to(torch.float32) * res[:, None]).contiguous()
                sres = torch.ones(3, dtype=torch.float32, device=dev)
            sb = sstream.element_size()
            mega_bytes = (3 * rows * (100 + e) * sb + rows * 4 + W.numel() * 4 + 3 * K * 4
                          + 3 * 4)
            for precision in ("f32", "int8", "int4"):
                args = (sstream, sres, W, weights, 100, skip, stride, precision, e, K)
                got = serve_mega_cuda.serve_mega_margins(*args)
                if precision == "f32":
                    want = serve_mega.serve_mega_margins_plain(*args[:8])
                else:
                    want = ingest_cuda.ingest_features(sstream, sres, mstarts, W, 100, skip,
                                                       precision, e, K) @ weights
                err = (got - want).abs().max().item()
                if err > serve_mega.MEGA_GATE_TOL:
                    raise AssertionError(f"generic megakernel ({precision}, {samples}) "
                                         f"disagrees at {size}")
                name = "serve_mega_any" + ("" if precision == "f32" else f"_{precision}") + suffix
                record(name, lambda a=args: serve_mega_cuda.serve_mega_margins(*a),
                       lambda a=args: serve_mega.serve_mega_margins_plain(*a[:8]), err,
                       mega_bytes, flops, "serve_mega_any_kernel", sb)
            args = (sstream, sres, W, stack, lanes, 100, skip, stride, e, K)
            got = serve_mega_cuda.serve_mega_multi_margins(*args)
            err = (got - serve_mega.serve_mega_multi_margins_plain(*args[:8])).abs().max().item()
            if err > serve_mega.MEGA_GATE_TOL:
                raise AssertionError(f"generic K6 ({samples}) disagrees at {size}: {err}")
            k6_bytes = mega_bytes - 3 * K * 4 + 128 * 3 * K * 4 + rows * 4
            record("serve_mega_multi_any" + suffix,
                   lambda a=args: serve_mega_cuda.serve_mega_multi_margins(*a),
                   lambda a=args: serve_mega.serve_mega_multi_margins_plain(*a[:8]), err,
                   k6_bytes, flops, "serve_mega_any_kernel", sb)
            for wp in PACKED:
                packed, scales, deq = packed_stacks[wp]
                args = (sstream, sres, W, packed, scales, lanes, 100, skip, stride, wp, e, K)
                got = serve_mega_cuda.serve_mega_multi_packed_margins(*args)
                k6 = serve_mega_cuda.serve_mega_multi_margins(sstream, sres, W, deq, lanes, 100,
                                                              skip, stride, e, K)
                if got.cpu().numpy().tobytes() != k6.cpu().numpy().tobytes():
                    raise AssertionError(f"generic K6-{wp} ({samples}) is not K6 on the "
                                         "dequantized stack")
                err = (got - serve_mega.serve_mega_multi_packed_margins_plain(*args[:10])
                       ).abs().max().item()
                packed_bytes = (mega_bytes - 3 * K * 4 + packed.numel() * packed.element_size()
                                + 128 * 4 + rows * 4)
                record(f"serve_mega_multi_any_{wp}{suffix}",
                       lambda a=args: serve_mega_cuda.serve_mega_multi_packed_margins(*a),
                       lambda a=args: serve_mega.serve_mega_multi_packed_margins_plain(*a[:10]),
                       err, packed_bytes, flops, "serve_mega_any_kernel", sb)
            del sstream
        del big, stream
    return out


def generic_wide_library(torch, dwt, dev, bandwidth, f32_peak, smi, n=256, C=76):
    """The library call and the bound of chip_compare.py's 76-channel
    generic case (``n`` windows of ``C`` channels at GENERIC_WIDE, a window
    every 1,000 samples): ``library_ms`` (and its device time), one
    ``torch.matmul`` of the (windows * C, epoch_size) centred windows with
    W, TF32 off, the contraction alone; the bound of K1-any and K5-any
    there on int16 and float32 samples (each window's baseline and
    analysis segment read once, the rows written once (K5: one margin a
    window and the weights read once), against the contraction's
    operations over the float32 peak)."""
    e, K, skip = GENERIC_WIDE
    W = dwt.kernel_operator(8, e, K, dev)
    gen = torch.Generator(device=dev).manual_seed(n + e + K)
    big = torch.randint(-3000, 3000, (C, n * 1000 + 1000), generator=gen, device=dev,
                        dtype=torch.int32)
    starts = torch.arange(n, device=dev, dtype=torch.int32) * 1000
    windows = (big[:, (starts.long() + 100 + skip)[:, None] + torch.arange(e, device=dev)]
               .to(torch.float32) * 0.1)
    Z = (windows - windows.mean(dim=2, keepdim=True)).permute(1, 0, 2).reshape(n * C, e)
    Z = Z.contiguous()
    del windows, big
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        library_ms = time_ms(lambda: torch.matmul(Z, W))
        library_device_ms = profiled_device_ms(lambda: torch.matmul(Z, W), "gemm")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    flops = 2 * n * C * e * K
    bounds = {}
    for samples, sb in (("int16", 2), ("float32", 4)):
        read = C * n * (100 + e) * sb + W.numel() * 4 + C * 4
        bounds[f"k1_{samples}"] = timed_bound(read + n * C * K * 4 + n * 4, flops, bandwidth,
                                              f32_peak)
        bounds[f"k5_{samples}"] = timed_bound(read + C * K * 4 + n * 4, flops, bandwidth,
                                              f32_peak)
    emit("generic_wide_library", windows=n, channels=C, epoch_size=e, feature_size=K,
         library_ms=library_ms, library_device_ms=library_device_ms, flops=flops,
         bounds={k: {"bound_ms": ms, "bound_by": by} for k, (ms, by) in bounds.items()},
         library="torch.matmul of the centred windows with W, TF32 off (contraction only)",
         nvidia_smi=smi)


def phase_remote(torch, np, info, model, local, counters, windows, resolutions, smi):
    """The batch and serving paths with the session and the models on a
    loopback object store and WebHDFS namenode (``tests/_loopback.py``,
    one server on 127.0.0.1 with both faces): a fused run from
    ``hdfs://`` saving its model there, the ``-pallas`` run from
    ``http://``, ``serve=true`` with ``load_name=hdfs://``, four tenants
    from a ``load_tenants`` spec over ``http://``, ``gs://`` through
    ``GcsFileSystem(endpoint=…)``, the fused run again with the store
    failing every third request and cutting one body in half, and a dead
    endpoint opening its circuit breaker. ``local`` holds phase 4's
    statistics (``fused``, ``pallas``) and parse seconds. Every
    statistics string must equal its local run's byte for byte."""
    import socket

    from eeg_dataanalysispackage_tpu_torch import obs
    from eeg_dataanalysispackage_tpu_torch.io import circuit, remote
    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
    from eeg_dataanalysispackage_tpu_torch.models import registry
    from eeg_dataanalysispackage_tpu_torch.obs import events
    from eeg_dataanalysispackage_tpu_torch.ops import ingest_cuda, serve_mega_cuda
    from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
    from eeg_dataanalysispackage_tpu_torch.serve import InferenceService, MultiplexedService
    from eeg_dataanalysispackage_tpu_torch.serve import pipeline as serve_pipeline

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import _loopback

    for name in ("WEBHDFS_ENDPOINT", "WEBHDFS_USER", "HDFS_DRIVER"):
        os.environ.pop(name, None)  # the fake answers on the URI's own authority
    circuit.reset()
    obs.metrics.reset()
    launches = {}

    def check(label, got, want):
        if got != want:
            raise AssertionError(f"remote {label}: statistics differ from the local run:\n"
                                 f"{got}\n--- local ---\n{want}")

    with _loopback.Server() as srv:
        store = srv.store
        t0 = time.perf_counter()
        store.add_tree(os.path.dirname(info), "/data")
        emit("remote_store", authority=srv.authority, files=len(store.files),
             store_mb=sum(len(v) for v in store.files.values()) / 1e6,
             seconds=time.perf_counter() - t0)
        hdfs, http = f"hdfs://{srv.authority}", srv.base
        parse = {}

        def remote_run(label, query):
            store.bytes_sent = 0
            if "&serve=true" in query:
                for module, attr in counters.values():
                    setattr(module, attr, 0)
                builder = PipelineBuilder(query)
                stats = builder.execute()
                counts = {k: getattr(m, a) for k, (m, a) in counters.items()}
            else:
                builder, stats, counts = run_builder(label, query, None, counters)
            # the serving path reads the session in its ingest stage
            parse[label] = builder.timers["parse" if "parse" in builder.timers else "ingest"]
            emit("remote_parse", run=label, parse_s=parse[label], mb=store.bytes_sent / 1e6,
                 mb_per_s=store.bytes_sent / 1e6 / parse[label])
            launches[label] = counts
            return builder, str(stats), counts

        # K1: the fused run from hdfs://, its model saved to hdfs://
        fused_q = "&fe=dwt-8-fused&train_clf=logreg"
        _b, fused, counts = remote_run(
            "hdfs_fused", f"info_file={hdfs}/data/info.txt{fused_q}"
            f"&save_clf=true&save_name={hdfs}/models/model")
        check("hdfs fused", fused, local["fused"])
        if counts["ingest_features"] != 8 or "/models/model.npz" not in store.files:
            raise AssertionError("the hdfs:// fused run did not launch once per recording "
                                 "or did not save its model")
        with open(model + ".npz", "rb") as f:
            model_bytes_equal = f.read() == store.files["/models/model.npz"]

        # K4: the host -pallas run from http://
        _b, pallas, counts = remote_run(
            "http_pallas", f"info_file={http}/data/info.txt&fe=dwt-8-pallas&train_clf=logreg")
        check("http -pallas", pallas, local["pallas"])
        if counts["epoch_features"] != 2:
            raise AssertionError("the http:// -pallas run did not launch the epoch-features "
                                 "kernel twice")

        # K5: serve=true with the model from hdfs://, against the batch load_clf= run
        load_q = (f"info_file={hdfs}/data/info.txt&fe=dwt-8-fused&load_clf=logreg"
                  f"&load_name={hdfs}/models/model")
        _b, batch, _c = remote_run("hdfs_load", load_q)
        serve_mega_cuda.LAUNCHES = 0
        served_builder, served, _c = remote_run("hdfs_serve", load_q + "&serve=true")
        launches["hdfs_serve"]["serve_mega"] = serve_mega_cuda.LAUNCHES
        check("hdfs serve=true vs batch load_clf=", served, batch)
        if served_builder.serve_block["rung"] != "mega" or serve_mega_cuda.LAUNCHES == 0:
            raise AssertionError("the hdfs:// serve run did not serve through the megakernel")

        # K6: four tenants from a load_tenants spec over http://
        base = registry.create("logreg")
        base.load(model)
        names = ["a", "b", "c", "d"]
        for i, name in enumerate(names):
            (base if i == 0 else perturbed_tenant(np, base, 2000 + i)).save(
                f"{http}/models/tenant_{name}")
        tenants = serve_pipeline.load_tenants(
            ",".join(f"{n}=logreg@{http}/models/tenant_{n}" for n in names))
        mix = [names[i % 4] for i in range(len(windows))]
        serve_mega_cuda.MULTI_LAUNCHES = 0
        with MultiplexedService(tenants) as svc:
            results = svc.predict_all(windows, resolutions, mix)
        launches["http_tenants"] = {"serve_mega_multi": serve_mega_cuda.MULTI_LAUNCHES}
        bit_equal = {}
        for name in names:
            rows = [i for i, t in enumerate(mix) if t == name]
            with InferenceService(tenants[name]) as solo:
                alone = solo.predict_all([windows[i] for i in rows],
                                         [resolutions[i] for i in rows])
            bit_equal[name] = ([results[i].margin for i in rows] == [r.margin for r in alone]
                               and [results[i].prediction for i in rows]
                               == [r.prediction for r in alone])
        emit("remote_tenants", tenants=len(tenants), windows=len(windows),
             serve_mega_multi_launches=launches["http_tenants"]["serve_mega_multi"],
             margins_bit_equal_solo=bit_equal)
        if not all(bit_equal.values()) or launches["http_tenants"]["serve_mega_multi"] == 0:
            raise AssertionError("a tenant served from http:// differs from its solo service")

        # K1 through GcsFileSystem(endpoint=…)
        for module, attr in counters.values():
            setattr(module, attr, 0)
        gcs = remote.GcsFileSystem(endpoint=http)
        feats, _t = OfflineDataProvider(["gs://data/info.txt"],
                                        filesystem=gcs).load_features_device()
        launches["gs_features"] = {"ingest_features": ingest_cuda.LAUNCHES}
        want, _t = OfflineDataProvider([info]).load_features_device()
        gs_equal = torch.equal(feats, want)
        emit("remote_gs", rows=int(feats.shape[0]), device=str(feats.device),
             ingest_launches=launches["gs_features"]["ingest_features"],
             features_bit_equal_local=gs_equal)
        if not gs_equal or launches["gs_features"]["ingest_features"] != 8:
            raise AssertionError("gs:// features differ from the local run's")

        # the fused run while the store fails every third request and cuts
        # one body in half: the retries absorb it
        store.fail_every, store.truncate_next = 3, 1
        n_requests = len(store.requests)
        recorder = events.SpanRecorder("remote_faults")
        with events.recording(recorder):
            _b, faulted, _c = remote_run("hdfs_fused_faults",
                                         f"info_file={hdfs}/data/info.txt{fused_q}")
        store.fail_every = 0
        retries = sum(e["name"] == "remote.retry" for e in recorder.recent_events())
        emit("remote_faults", requests=len(store.requests) - n_requests, retries=retries,
             truncations_left=store.truncate_next, statistics_equal_local=faulted == fused)
        check("hdfs fused under faults", faulted, local["fused"])
        if retries == 0 or store.truncate_next != 0:
            raise AssertionError("the faults were not injected and retried")

    # a dead endpoint: after `threshold` exhausted budgets the circuit opens
    # and the next call fails fast
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        dead = f"http://127.0.0.1:{sock.getsockname()[1]}"
    fs = remote.HttpFileSystem(retry=remote.RetryPolicy(max_attempts=3, timeout_s=2.0,
                                                        backoff_s=0.05))
    breaker = circuit.breaker_for(dead)
    budgets = []
    for _ in range(breaker.threshold):
        t0 = time.perf_counter()
        try:
            fs.read_bytes(f"{dead}/data/info.txt")
        except remote.RemoteIOError:
            budgets.append(time.perf_counter() - t0)
        else:
            raise AssertionError("a dead endpoint answered")
    t0 = time.perf_counter()
    try:
        fs.read_bytes(f"{dead}/data/info.txt")
    except circuit.CircuitOpenError:
        fast_fail_s = time.perf_counter() - t0
    else:
        raise AssertionError("the open circuit let a call through")
    counters_now = obs.metrics.snapshot()["counters"]
    emit("remote_circuit", endpoint=dead, threshold=breaker.threshold,
         budget_s=budgets, fast_fail_s=fast_fail_s, state=breaker.state,
         counters={k: v for k, v in counters_now.items() if k.startswith("circuit.")})
    if breaker.state != circuit.OPEN or fast_fail_s > min(budgets) / 10:
        raise AssertionError("the dead endpoint's breaker did not open and fail fast")
    emit("remote", nvidia_smi=smi, parse_s_local=local["parse"], parse_s=parse,
         model_bytes_equal_local=model_bytes_equal, retries=retries,
         counters=counters_now, launches=launches)
    circuit.reset()
    return launches


def kernel_entry(name, source, replaces, launches, max_abs_err, timing, library_ms=None):
    kernel_ms, plain_ms, bound_ms, bound_by = timing[:4]
    return {"name": name, "route": "cuda",
            "source": f"eeg_dataanalysispackage_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import numpy as np

        from eeg_dataanalysispackage_tpu_torch.features import wavelet
        from eeg_dataanalysispackage_tpu_torch.ops import (
            cuda_build, device_ingest, dwt, dwt_cuda, ingest_cuda, serve_mega, serve_mega_cuda,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1

    # every phase counts real launches: the feature cache (on by default)
    # stays off but in phase 4g, which turns it on in a directory of its own
    os.environ["EEG_TPU_NO_FEATURE_CACHE"] = "1"
    dev = torch.device("cuda")
    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    bandwidth, f32_peak, bf16_peak = card_peaks(kind)
    emit("device", kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, peak_bytes_per_s=bandwidth, peak_f32_flops=f32_peak,
         peak_bf16_flops=bf16_peak, nccl=torch.distributed.is_nccl_available())

    # 2. build every kernel from the checkout's sources
    build_kernels(cuda_build, ["ingest_features", "serve_mega", "epoch_features"])
    ingest_cuda.build()
    serve_mega_cuda.build()
    dwt_cuda.build()
    from eeg_dataanalysispackage_tpu_torch.ops import generic_plan

    emit("generic_build", **generic_build(cuda_build, generic_plan,
                                          *ingest_cuda.device_limits(dev)))

    # 3. each kernel against its plain version
    serve_mega_cuda.F32S_DESIGN_RING = serve_mega_cuda.F32S_DESIGN_TILES = 0
    W = torch.from_numpy(dwt.cascade_matrix(8, 512, 16).astype(np.float32)).to(dev)
    max_err = phase_kernel_cases(torch, np, ingest_cuda, device_ingest, W, dev)
    f32_err = phase_f32_stream_cases(torch, np, ingest_cuda, device_ingest, W, dev)
    mega_err = phase_mega_cases(torch, np, serve_mega, serve_mega_cuda, W, dev)
    multi_err = phase_mega_multi_cases(torch, np, serve_mega, serve_mega_cuda, W, dev)
    epoch_err = phase_epoch_cases(torch, np, dwt, dwt_cuda, wavelet, dev)
    packed_err = phase_packed_cases(torch, np, serve_mega, serve_mega_cuda, W, dev)
    wide_f32s_err = phase_float_wide_cases(torch, np, serve_mega, serve_mega_cuda, W, dev)
    generic_err = phase_generic_cases(torch, np, dwt, ingest_cuda, device_ingest, serve_mega,
                                      serve_mega_cuda, dev)
    emit("mega_designs_phase3", launches={"ring": serve_mega_cuda.F32S_DESIGN_RING,
                                          "tiles": serve_mega_cuda.F32S_DESIGN_TILES},
         crossover_windows=serve_mega_cuda.tiles_crossover(
             ingest_cuda.device_limits(dev)[0]))
    # every float32-sample 512 / 16 launch of phases 4 and 5, by design
    mega_log = MegaDesignLog().__enter__()

    # 4. the batch paths end to end on an 8 x 1,200-marker session, and a
    # float32 session; every counter is set to 0 just before each run
    counters = {"ingest_features": (ingest_cuda, "LAUNCHES"),
                "ingest_features_f32": (ingest_cuda, "LAUNCHES_F32"),
                "ingest_features_bf16": (ingest_cuda, "LAUNCHES_BF16"),
                "ingest_features_int8": (ingest_cuda, "LAUNCHES_INT8"),
                "ingest_features_int4": (ingest_cuda, "LAUNCHES_INT4"),
                "epoch_features": (dwt_cuda, "LAUNCHES")}
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        info = write_session(work)
        emit("session", recordings=8, markers_each=1200, seconds=time.perf_counter() - t0)
        base = f"info_file={info}&result_path={work}/result.txt"
        model = os.path.join(work, "model_logreg")
        runs = {}
        for label, query, device in (
            ("logreg_cuda", base + "&fe=dwt-8-fused&train_clf=logreg"
             f"&save_clf=true&save_name={model}", None),
            ("svm_cuda", base + "&fe=dwt-8-fused&train_clf=svm", None),
            ("logreg_cuda_pallas_spelling", base + "&fe=dwt-8-fused-pallas&train_clf=logreg", None),
            ("logreg_cpu", base + "&fe=dwt-8-fused&train_clf=logreg", "cpu"),
            ("svm_cpu", base + "&fe=dwt-8-fused&train_clf=svm", "cpu"),
        ):
            builder, _stats, launches = run_builder(label, query, device, counters)
            runs[label] = (builder, launches["ingest_features"])
            if device is None:
                if builder.features.device.type != "cuda" or launches["ingest_features"] < 8:
                    raise AssertionError(f"{label} did not run the kernel on the card")
            elif launches["ingest_features"] != 0:
                raise AssertionError(f"{label} launched the kernel on the CPU path")
        gpu, cpu = runs["logreg_cuda"][0], runs["logreg_cpu"][0]
        feat_err = (gpu.features.cpu() - cpu.features).abs().max().item()
        emit("features_cuda_vs_cpu", max_abs_err=feat_err, tol=KERNEL_TOL)
        if feat_err > KERNEL_TOL:
            raise AssertionError("card features disagree with the CPU run")
        compare_runs(np, gpu, cpu, "logreg")
        compare_runs(np, runs["svm_cuda"][0], runs["svm_cpu"][0], "svm")
        if str(runs["logreg_cuda_pallas_spelling"][0].statistics) != str(gpu.statistics):
            raise AssertionError("-fused-pallas spelling changed the statistics")
        main_launches = runs["logreg_cuda"][1]
        plan = recording_plan(info, dev)
        emit("recording_plan", rows=int(plan[2].shape[0]), kept=plan[3],
             samples=int(plan[0].shape[1]))
        rung_launches = phase_precision_runs(np, info, counters, gpu, n_files=8)
        k4_launches, k4_path_err, pallas_run = phase_host_path(np, info, counters)

        float_dir = os.path.join(work, "float32")
        os.makedirs(float_dir)
        float_info = write_float_session(float_dir, n_files=3)
        f32_launches, f32_path_err, k4_f32_path_err = phase_float_session(
            np, float_info, counters, n_files=3)
        f32s_launches = phase_float_serve(torch, np, float_info, work)
        # 4c. threefry mini-batch sampling and the neural network
        nn_k1, nn_k4 = phase_nn(torch, np, info, counters, work, int(len(gpu.targets)))
        # 4d. the tree families
        tree_k1, tree_k4 = phase_trees(torch, np, info, counters, work, int(len(gpu.targets)),
                                       n_files=8)
        # 4e. fan-out, populations, elastic training and the line searches
        train_k1, train_k4 = phase_training_surface(torch, np, info, counters, work,
                                                    int(len(gpu.targets)), n_files=8)
        # 4f. the seizure workload
        seizure_k4, seizure_k4_err = phase_seizure(torch, np, counters, work)
        # 4g. the feature cache, reports, faults, a trace, MLlib directories
        record_k1, record_k1_int8, record_k4 = phase_run_record(torch, np, info, model,
                                                                counters, work)
        rung_launches["int8"] += record_k1_int8
        # 4h. the parse pool, overlapped staging, the native epoch stage
        inpipe_k1, inpipe_k4, inpipe_k5 = phase_input_pipeline(torch, np, info, model, counters,
                                                               work)
        # 4i. single-process meshes and the raw-stream trainers
        mesh_k1, mesh_k1_bf16 = phase_mesh(torch, np, info, counters)
        rung_launches["bf16"] += mesh_k1_bf16
        # 4j. multi-process runs (a rank a process) and the streaming front end
        pod_k1 = phase_pod(torch, np, info, counters, work)
        # 4k. the plan executor: concurrent, journaled, fault-isolated plans
        sched_k1 = phase_scheduler(torch, np, info, counters, work)
        # 4l. the plan service: prefix dedup, placement, the gateway, the fleet
        # (traced, with 4m's checks of the live fleet)
        operator = {}
        service_k1, service_k6 = phase_plan_service(torch, np, info, model, counters, work,
                                                    smi, operator=operator)
        # 4m. the operator plane: the trace, the tools, chaos_run, the memory profile
        operator_k1 = phase_operator_plane(info, counters, work, smi, operator)
        # 4n. the walkthroughs: the six examples' run(), and one python -m
        walk_k1 = phase_walkthroughs(torch, np, info, counters, smi)
        generic_launches = phase_generic_paths(np, torch, info, float_info, n_files=8,
                                               n_float_files=3)
        phase_bf16_host_runs(np, info, counters)

        # 5. the serving path end to end with the card's saved model
        kept = int(len(gpu.targets))
        (serve_launches, windows, resolutions, targets, plain_stats,
         plain_latency) = phase_serve(torch, np, info, model, kept)
        served_launches = phase_serve_precisions(np, info, model, kept, windows, resolutions)
        multi_launches = phase_multi_service(torch, np, info, model, kept, windows,
                                             resolutions)
        packed_launches = phase_quant_multi_service(torch, np, model, kept, windows,
                                                    resolutions)
        generic_launches.update(phase_generic_serve(torch, np, model, windows, resolutions))
        designs = {}
        for kernel, counts in GENERIC_DESIGNS:
            for design, n in counts.items():
                designs.setdefault(design, {}).setdefault(kernel, 0)
                designs[design][kernel] += n
        emit("generic_designs", launches={d: sum(k.values()) for d, k in designs.items()},
             by_kernel={d: {k: n for k, n in by.items() if n} for d, by in designs.items()})


        # 5b. the same paths with the session and the models on a loopback
        # object store and WebHDFS namenode
        phase_remote(torch, np, info, model,
                     {"fused": str(gpu.statistics), "pallas": str(pallas_run.statistics),
                      "parse": {"hdfs_fused": gpu.timers["parse"],
                                "http_pallas": pallas_run.timers["parse"]}},
                     counters, windows, resolutions, smi)

        # 5c. the serving lifecycle: adapt=true at the defaults, a
        # promotion, and a resumed adapter
        phase_lifecycle(torch, np, info, model, kept, windows, resolutions, targets, work,
                        plain_stats, plain_latency)
        mega_log.__exit__()
        emit("mega_designs", launches=mega_log.totals(), by_capacity=mega_log.launches)
        if not mega_log.totals()["tiles"]:
            raise AssertionError("no path run took the float32 megakernel's tile design")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 6. timing: the ingest kernel at 32,768 windows (int16 and float32
    # streams, and the bf16, int8 and int4 rungs on int16) and at one
    # recording's plan (the batch path's own launch size), the
    # megakernel (f32, int8, int4) at one serve batch and at 32,768
    # windows, the epoch-features kernel at 32,768 epochs and at the
    # -pallas run's 641 and 1,494
    k1 = ingest_timing(torch, ingest_cuda, device_ingest, W, dev, torch.int16,
                       bandwidth, f32_peak, smi)
    ingest_timing(torch, ingest_cuda, device_ingest, W, dev, torch.int16, bandwidth, f32_peak,
                  smi, plan=plan)
    k1_f32 = ingest_timing(torch, ingest_cuda, device_ingest, W, dev, torch.float32,
                           bandwidth, f32_peak, smi)
    k1_rungs = {p: ingest_timing(torch, ingest_cuda, device_ingest, W, dev, torch.int16,
                                 bandwidth, f32_peak, smi, precision=p, bf16_peak=bf16_peak)
                for p in ("bf16", "int8", "int4")}
    mega_64, mega_big = ({p: mega_timing(torch, serve_mega, serve_mega_cuda, W, dev, n,
                                         bandwidth, f32_peak, smi, precision=p)
                          for p in ("f32", "int8", "int4")} for n in (64, 32_768))
    multi_64, multi_big = (mega_multi_timing(torch, serve_mega, serve_mega_cuda, W, dev, n,
                                             bandwidth, f32_peak, smi) for n in (64, 32_768))
    packed_64, packed_big = ({wp: packed_multi_timing(torch, serve_mega, serve_mega_cuda, W, dev,
                                                      n, wp, bandwidth, f32_peak, smi,
                                                      packed_launches[wp])
                              for wp in PACKED} for n in (64, 32_768))
    # the float32-sample instantiations at one serve batch and at 32,768
    # windows, keyed by kernel name
    f32s_64, f32s_big = ({**{("serve_mega" if p == "f32" else f"serve_mega_{p}") + "_f32s":
                             mega_timing(torch, serve_mega, serve_mega_cuda, W, dev, n, bandwidth,
                                         f32_peak, smi, precision=p, samples="float32",
                                         launches=f32s_launches[
                                             ("serve_mega" if p == "f32" else f"serve_mega_{p}")
                                             + "_f32s"])
                             for p in ("f32", "int8", "int4")},
                          "serve_mega_multi_f32s": mega_multi_timing(
                              torch, serve_mega, serve_mega_cuda, W, dev, n, bandwidth, f32_peak,
                              smi, samples="float32",
                              launches=f32s_launches["serve_mega_multi_f32s"]),
                          **{f"serve_mega_multi_{wp}_f32s": packed_multi_timing(
                              torch, serve_mega, serve_mega_cuda, W, dev, n, wp, bandwidth,
                              f32_peak, smi, f32s_launches[f"serve_mega_multi_{wp}_f32s"],
                              samples="float32") for wp in PACKED}}
                         for n in (64, 32_768))
    generic = generic_timing(torch, np, dwt, ingest_cuda, device_ingest, serve_mega,
                             serve_mega_cuda, dev, GENERIC_SIZES, bandwidth, f32_peak, bf16_peak,
                             smi, generic_launches)
    generic_wide_library(torch, dwt, dev, bandwidth, f32_peak, smi)
    k4 = epoch_timing(torch, dwt, dwt_cuda, dev, 32_768, bandwidth, f32_peak, smi)
    k4_run = [epoch_timing(torch, dwt, dwt_cuda, dev, n, bandwidth, f32_peak, smi)
              for n in (641, 1494)]  # the -pallas logreg run's own launches
    # one host-extractor serve batch
    k4_64 = epoch_timing(torch, dwt, dwt_cuda, dev, 64, bandwidth, f32_peak, smi)
    # the seizure -pallas run's one launch at four recordings (the size
    # its earlier timings used, kept): 9,596 windows of 768 samples
    k4_seizure = epoch_timing(torch, dwt, dwt_cuda, dev, 4 * 2399, bandwidth, f32_peak, smi,
                              T=768)
    epoch_size_timing(torch, dwt, dwt_cuda, dev, EPOCH_SIZES, bandwidth, f32_peak, smi)
    # the 512/16 rows' library call at their timing sizes: 32,768
    # windows (K1 and its rungs, the tile design's launches) and one serve
    # batch of 64 (K5, K6), and at one recording's 320 windows
    lib = {n: contraction_library_ms(torch, dwt, dev, n, smi) for n in (64, 320, 32_768)}

    # the float32-sample instantiations' worst deviations over phase 3
    f32s_phase_err = {
        "serve_mega_f32s": max(mega_err["f32_f32s"], wide_f32s_err),
        "serve_mega_int8_f32s": mega_err["int8_f32s"],
        "serve_mega_int4_f32s": mega_err["int4_f32s"],
        "serve_mega_multi_f32s": multi_err["_f32s"],
        "serve_mega_multi_int8_f32s": packed_err["int8_f32s"],
        "serve_mega_multi_int4_f32s": packed_err["int4_f32s"],
    }

    # 7. the kernels line, then the card line, then the result
    ingest_pallas = "eeg_dataanalysispackage_tpu/ops/ingest_pallas.py:314"
    bank_pallas = "eeg_dataanalysispackage_tpu/ops/ingest_pallas.py:462"
    mega_pallas = "eeg_dataanalysispackage_tpu/ops/serve_mega.py:259"
    multi_pallas = "eeg_dataanalysispackage_tpu/ops/serve_mega.py:484"
    print(json.dumps({"kernels": [
        # the main path's run and the runs of phases 4c (mini-batch SGD,
        # the nn batch, load and serve runs), 4d (the tree families), 4e
        # (fan-out, populations, elastic, line searches), 4f (the seizure
        # workload's -pallas runs), 4g (cache misses, the trace, MLlib), 4h
        # (the parse pool, overlap, the remote pool), 4i (meshes, the
        # raw-stream trainers), 4j (the ranks' own launches too), 4k (the
        # executor's plans, and the killed child's before its kill), 4l (the
        # plan service's plans in this process), 4m (chaos_run's two runs) and
        # 4n (the walkthroughs run in this process)
        kernel_entry("ingest_features", "ingest_features.cu", ingest_pallas,
                     main_launches + nn_k1 + tree_k1 + train_k1 + record_k1 + inpipe_k1
                     + mesh_k1 + pod_k1 + sched_k1 + service_k1 + operator_k1 + walk_k1,
                     max(max_err["f32"], k1[4]), k1, library_ms=lib[32_768]),
        kernel_entry("serve_mega", "serve_mega.cu", mega_pallas, serve_launches + inpipe_k5,
                     max(mega_err["f32"], mega_64["f32"][4], mega_big["f32"][4]),
                     mega_64["f32"], library_ms=lib[64]),
        kernel_entry("epoch_features", "epoch_features.cu",
                     "eeg_dataanalysispackage_tpu/ops/dwt_pallas.py:44",
                     k4_launches + nn_k4 + tree_k4 + train_k4 + seizure_k4 + record_k4
                     + inpipe_k4,
                     max(epoch_err, k4_path_err, k4_f32_path_err, seizure_k4_err, k4[4],
                         k4_seizure[4], *(t[4] for t in k4_run)),
                     k4, library_ms=k4[5]),
        # the epoch-features kernel behind the host-extractor service
        # (fe=dwt-8-pallas, float32 session): one launch a batch of 64
        kernel_entry("epoch_features_host_extractor", "epoch_features.cu",
                     "eeg_dataanalysispackage_tpu/ops/dwt_pallas.py:44",
                     f32s_launches["epoch_features_host_extractor"], k4_64[4], k4_64,
                     library_ms=k4_64[5]),
        kernel_entry("ingest_features_f32", "ingest_features.cu", ingest_pallas, f32_launches,
                     max(f32_err, f32_path_err, k1_f32[4]), k1_f32, library_ms=lib[32_768]),
        *(kernel_entry(f"ingest_features_{p}", "ingest_features.cu", bank_pallas,
                       rung_launches[p], max(max_err[p], k1_rungs[p][4]), k1_rungs[p],
                       library_ms=lib[32_768])
          for p in ("bf16", "int8", "int4")),
        *(kernel_entry(f"serve_mega_{p}", "serve_mega.cu", mega_pallas, served_launches[p],
                       max(mega_err[p], mega_64[p][4], mega_big[p][4]), mega_64[p],
                       library_ms=lib[64])
          for p in ("int8", "int4")),
        kernel_entry("serve_mega_multi", "serve_mega.cu", multi_pallas,
                     multi_launches + service_k6,
                     max(multi_err[""], multi_64[4], multi_big[4]), multi_64, library_ms=lib[64]),
        *(kernel_entry(f"serve_mega_multi_{wp}", "serve_mega.cu", multi_pallas,
                       packed_launches[wp],
                       max(packed_err[wp], packed_64[wp][4], packed_big[wp][4]), packed_64[wp],
                       library_ms=lib[64])
          for wp in PACKED),
        # the float32-sample instantiations (float32 requests): launches
        # over the float32 session's serving runs (phase 4b)
        *(kernel_entry(name, "serve_mega.cu", multi_pallas if "multi" in name else mega_pallas,
                       f32s_launches[name],
                       max(f32s_phase_err[name], f32s_64[name][4], f32s_big[name][4]),
                       f32s_64[name], library_ms=lib[64])
          for name in F32S_COUNTERS),
        # the generic engine: launches over its paths (phases 4 and 5), time
        # and library time at GENERIC_PATH_SIZE, the worst deviation over
        # every size and the serve batch
        *(kernel_entry(name, source, replaces, generic_launches[name],
                       max(generic_err[name], *(generic[(name, size)][4]
                                                for size in GENERIC_SIZES),
                           generic[(name, GENERIC_PATH_SIZE, 64)][4]),
                       generic[(name, GENERIC_PATH_SIZE)],
                       library_ms=generic[(name, GENERIC_PATH_SIZE)][5])
          for name, source, replaces in (
              ("ingest_features_any", "ingest_features.cu", ingest_pallas),
              ("ingest_features_any_f32", "ingest_features.cu", ingest_pallas),
              ("ingest_features_any_bf16", "ingest_features.cu", bank_pallas),
              ("ingest_features_any_int8", "ingest_features.cu", bank_pallas),
              ("ingest_features_any_int4", "ingest_features.cu", bank_pallas),
              ("serve_mega_any", "serve_mega.cu", mega_pallas),
              ("serve_mega_any_int8", "serve_mega.cu", mega_pallas),
              ("serve_mega_any_int4", "serve_mega.cu", mega_pallas),
              ("serve_mega_multi_any", "serve_mega.cu", multi_pallas),
              ("serve_mega_multi_any_int8", "serve_mega.cu", multi_pallas),
              ("serve_mega_multi_any_int4", "serve_mega.cu", multi_pallas),
              ("serve_mega_any_f32s", "serve_mega.cu", mega_pallas),
              ("serve_mega_any_int8_f32s", "serve_mega.cu", mega_pallas),
              ("serve_mega_any_int4_f32s", "serve_mega.cu", mega_pallas),
              ("serve_mega_multi_any_f32s", "serve_mega.cu", multi_pallas),
              ("serve_mega_multi_any_int8_f32s", "serve_mega.cu", multi_pallas),
              ("serve_mega_multi_any_int4_f32s", "serve_mega.cu", multi_pallas))),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

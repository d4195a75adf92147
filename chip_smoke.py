#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``), the CUDA and
   PyTorch versions; TF32 is switched off for matrix products and
   convolutions, so every fp32 product is full fp32.
2. build: ``nvcc`` builds every kernel source of the port from ``csrc/``,
   one compiler per source, all at once.
3. kernels: each kernel against its plain PyTorch version on the same
   inputs, at the shapes the main path gives it (64 receivers, a 2 x 64
   ring, rows of 73,420 columns, the 10 CIFAR10Net leaves, K = 4 or one
   slot) and at ragged shapes (F not a multiple of 4; leaf edges inside a
   4-column word); ring rows (or int8 scales) behind empty slots are NaN
   or Inf where the kernel must not read them, and -0.0 in p. For each:
   the max abs error and the count of elements whose bits differ (both
   must be 0), the device time of one call of the kernel and of the plain
   version (CUDA graph of 20 calls, replayed between CUDA events, median
   of 50), and the least time the card could take, with what bounds it.
   Then the K1/K2 sweep (``merge_sweep``; ``[kernels] <shape> ...``
   lines, as every K1/K2 check prints): K1 and K2 at the shapes the
   paths give them (SWEEP: the scale row, the ladder rung, Giaretta,
   Ormandi, the north star, the flagship, phase 4's rows), each bit-equal
   to its plain version, timed (the median of SWEEP_ITERS replays), with
   its bound and share, a K1 and a K2
   call at the scale shape profiled as one kernel on the card (counted in
   a CUDA graph that captured it where the profiler records nothing), and at
   the routes' edges (SWEEP_EDGE_*: 1 to 132 columns, 1 to 64 slots,
   half live, empty slots whose w_self is not 1) on float32, bf16 and
   int8 rings, bit-equality only (untimed); K1's lines also give ``eager_call_ms``, one eager call on
   the host's clock. K3 and K4 (``check_flat``; float32, bf16 and int8
   rings) at phase 4's rows, at the ragged shapes and, untimed, at
   SWEEP_EDGE_F's 1 to 132 columns on SWEEP_EDGE_N rows: bit-equal, a
   call of ``gather_merge_flat`` one kernel node in a CUDA graph that
   captured it, the route ``flat_plan`` took; timed, ``ms`` (the
   wrapper's call) beside the plain version, the bound and the share, at
   phase 4's rows with the inputs out of the L2 (``time_ms_cold``, as a
   round's merge finds them) and back to back (``warm_ms``).
4. paths: a 64-node CIFAR10Net gossip run on the card (clique, PUSH,
   MERGE_UPDATE, 4-slot mailbox, SGD 0.05, batch 32, synthetic 32x32x3
   data with 64 images per node), on each deliver path: the single-pass
   fused deliver with an fp32 ring (the first slice's main path: 3 timed
   rounds, then one profiled round and the host-clock time of each
   phase), then the plain deliver with compaction (auto), the per-slot
   fused deliver with fp32, bf16 and int8 rings and the single-pass one
   with bf16 and int8 rings (a warm-up round, 2 timed rounds and the
   phase times each). Launch counts are set to 0 just before each path's
   timed rounds and read just after: the multi-slot kernels launch once
   per round with messages, the single-slot ones once per occupied slot,
   and the plain path launches none.
5. reference: the same small run of each path on the CPU (plain versions)
   and on the card (kernels), from the same seeds: equal accounting, close
   params (within one encoding step more for the bf16 and int8 rings).
6. attention: the flash-attention hop kernel K5 in its three routes,
   built in phase 2: bf16 operands run ``csrc/flash_hop_sm90.cu`` (tensor
   cores, TMA, a balanced causal work list), f32 ones with D, Dv <= 128
   ``csrc/flash_hop_tf32.cu`` (the same machinery as 3xTF32, after its
   split pre-pass), f32 ones with D or Dv in 129..256 the same source's
   wider instances (the same kernel on 64-row query tiles). The pre-pass
   bit for bit against its plain version (edge values: rounding ties,
   zeros, subnormals; up to 8 groups of 32 columns; the timed shapes)
   and its time; K5 against its plain version at the JAX bench's
   regime (S = 8192, one head, D = 128, causal, bf16 and f32), on
   mid-stream hops (a random carry; a chunk wholly in the past, one
   across the diagonal), at ragged shapes (1000 x 777 rows, D = 72), with
   wholly masked rows whose m is _NEG (f32, bf16, wide f32), on hops whose
   query tiles are cut into many pieces merged in the launch (bf16, wide
   f32), on asymmetric wide heads (D 64 with Dv 180, D 200 with Dv 40)
   and on every instance of each route; a CUDA graph of one hop (wide
   f32, bf16) replayed after 70 hops of other shapes and compared with
   an eager call, so that a work list a graph keeps is never freed; then
   the bf16 route's main run: ``flash_attention`` at the bench shape
   with its launches counted, its device time beside the plain version,
   ``scaled_dot_product_attention`` (SDPA) and the bound; the 3xTF32
   route's output at the training shape (S = 8192, D = 128, non-causal)
   against its plain version's and its time there and at the causal bench
   shape beside the plain version, SDPA in f32 (its
   kernel named) and the bounds at the TF32 and the f32 rates; the wide
   f32 route's run (3 ``flash_attention`` calls at S = 2048, D = 256,
   launches of the hop and of its pre-pass counted, the output against
   the plain version's) and its time;
   ``flash_attention``'s forward and gradient against dense attention
   through autograd (the JAX bench's ``_attention_parity`` rule); and the
   training demo (``gossipy_tpu_torch.examples.demo_ring_attention``,
   f32), at its defaults with K5's launches counted (one 3xTF32 hop and
   one pre-pass per step, none from the backward), then 3 steps at
   S = 8192, D = 128 with K5 and with the plain version, whose losses
   must agree. ``attention_diagnostics`` (not run here) breaks K5's time
   down further.
7. north star: the configuration of ``bench.py::build_sim``, built through
   the port's entry points (``Topology.random_regular(100, 20, seed=42)``,
   ``load_classification_dataset("spambase")``, the data handler and
   dispatcher, ``SGDHandler`` over ``LogisticRegression(57, 2)``, SGD 0.1,
   batch 32, MERGE_UPDATE, PUSH, a global eval every round), on its two
   legs: the default deliver (``fused_merge=False``, compaction on by
   itself at N = 100) and the single-pass one (K1). (a) 10 rounds on the
   card and on the CPU from the same seeds: equal accounting (sent,
   failures by cause, mailbox high-water mark, compact/wide slots, both
   boxes), params within REF_TOL. K1, K2 and K3 against their plain
   versions, timed, at the shapes the north star gives them (100 rows of
   LogReg's 116-column stride, the derived 6 slots or one, a two-cell
   ring; K1's numbers are ``at_northstar_shape``). (b) Each leg timed: a
   warm-up, then BENCH_ROUNDS rounds from the same initial state and the
   same draws, the card synchronised before the host clock stops;
   rounds/s, final global accuracy, the kernels' launches (counts set to
   0 just before), one profiled round's idle share. (c) The paper
   examples' network model
   (``UniformDelay(0, 10)``, 10% drops, 20% online, ``sampling_eval=0.1``)
   in 10-round card-against-CPU runs: on the single-pass deliver with a
   bf16 ring (K2), with PUSH_PULL on the single-pass deliver (K1 in the
   reply phase) and on the per-slot one (K3), and with async nodes. On
   the card every merge call of these runs is held, as it happens,
   against its plain version on the same tables (ring cells older than
   the round's own, the reply box's tables), and each run must launch
   its kernels.

8. flagship: the 100-node CIFAR-10 configuration of
   ``examples/main_cifar10_100nodes.py`` (and
   ``examples/configs/cifar10_100nodes.json``), built by its twin
   ``gossipy_tpu_torch.examples.main_cifar10_100nodes``: the synthetic
   CIFAR-10 stand-in normalised by the training statistics,
   ``label_dirichlet_skew(0.5)``, CIFAR10Net under weight decay 1e-3 and
   SGD 0.05, batch 32, MERGE_UPDATE, PUSH on ``random_regular(100, 20,
   seed=42)``, a 10% sampled eval every round, common init, the
   single-pass deliver. (a) 16 nodes, 2048 images, FLAG_CHECK_ROUNDS
   rounds on the card
   and on the CPU from the same seeds, fp32 compute with an fp32 ring,
   then bf16 compute with fp32, bf16 and int8 rings: accounting, boxes
   and ages equal, params by the rule of PERF.md §2 (a ReLU or max-pool
   decision near a tie may flip between the two: the fp32 run's median
   element within REF_TOL and its largest within what bf16 compute moves
   the run; a bf16 run within twice that), and every K1 and
   K2 call of the card runs held bit-equal to its plain version as it
   happens (``MergeAudit``). K1 and K2 (bf16, int8) against their plain
   versions, timed, at the flagship's shape (100 rows of CIFAR10Net's
   stride, the derived K, a two-cell ring). (b) The full width: 100
   nodes, all 50,000 training images split by the Dirichlet skew, 10,000
   test images, bf16 compute, on three ring legs (fp32: K1; bf16, int8:
   K2): a warm-up round, FLAG_ROUNDS timed rounds with the card
   synchronised before the host clock stops, the launches (counts set to
   0 just before; one per round with messages), the final sampled
   accuracy, ``memory_budget()`` beside ``max_memory_allocated``, one
   profiled round's idle share and the phase times.

9. papers: the four paper examples on the vanilla simulator, built by
   their twins (``gossipy_tpu_torch/examples/main_ormandi_2013.py``,
   ``main_berta_2014.py``, ``main_hegedus_2020.py``,
   ``main_danner_2023.py``): Ormandi (Pegasos over AdaLine, one node per
   training sample, a clique, async PUSH, ``UniformDelay(0, 10)``, 20%
   online, 10% drops, the single-pass deliver: K1), Berta (k-means with
   Hungarian matching, one node per sample, sync PUSH, ``delta=1000``),
   Hegedus (MF on the ml-100k stand-in, one user a node,
   ``random_regular(943, 20)``) and Danner (limited merging of LogReg
   under weight decay and SGD 1.0, 100 nodes); the last three take the
   plain path. (a) Each at a cut size (64 nodes; Hegedus 64 users;
   Danner 16) for PAPER_CHECK_ROUNDS rounds on the card and on the CPU
   from the same seeds: accounting, boxes and ages equal, params within
   REF_TOL plus REF_TOL of their magnitude, every K1 call of the Ormandi
   run bit-equal to its plain version (``MergeAudit``), no launch on the
   plain path. K1 against its plain version, timed, at the Ormandi shape
   (4,141 rows of the 60-column stride, the derived K, the ring's 3
   cells). (b) Each at full width (4,141 nodes, 4,601, 943 users, 100)
   for PAPER_ROUNDS rounds: ms/round, the final metric (accuracy, NMI,
   local RMSE, accuracy), K1's launches against the rounds with messages,
   one profiled round's idle share, the phase times, and
   ``memory_budget()`` beside ``max_memory_allocated``.

10. variants: the node-behaviour, token-account and all-to-all
   simulators through the twins of the four paper examples they carry
   (``gossipy_tpu_torch/examples/main_giaretta_2019.py``,
   ``main_hegedus_2021.py``, ``main_onoszko_2021.py``,
   ``main_all2all.py``), and the token simulator over the north star:
   Giaretta 2019 (Pegasos on ``barabasi_albert(n, 10)``, async PUSH) in
   its three node behaviours (vanilla on the single-pass deliver: K1;
   pass-through and neighbour cache on the plain path), Hegedus 2021
   (100 LogReg nodes under UPDATE; the partitioned exchange under token
   accounts and the sampled one), All2All under uniform and
   Metropolis-Hastings mixing (one ``W_eff @ P`` a round), Onoszko 2021
   (PENS over 5 CIFAR10Net nodes), and ``TokenizedGossipSimulator`` on
   the per-slot fused deliver with an fp32 ring (K3) and a bf16 ring
   (K4). (a) Each at a cut size (64 nodes; 32; 3 nodes and 96 images for
   Onoszko; the north star's 100) for VARIANT_CHECK_ROUNDS rounds on the
   card and on the CPU from the same seeds, with token accounts under
   which nodes send from the first rounds: accounting, both boxes, ages,
   the ring's ages and ``aux`` equal; params within REF_TOL plus
   REF_TOL of their magnitude (Onoszko by the decision-flip rule);
   launches as the path makes them (K1 once a round with messages on
   Giaretta vanilla, K3 or K4 once per occupied slot on the token runs,
   none elsewhere), every call bit-equal to its plain version
   (``MergeAudit``). K1 against its plain version, timed, at Giaretta's
   shape (4,141 rows of the 60-column stride, K = 59), K3 and K4 (bf16
   and int8) at the token north star's (100 rows of 116 columns, one
   slot), each one kernel a call. (b)
   Each at full width (4,141 nodes; 100; 5 nodes
   and 50,000 images) for VARIANT_ROUNDS rounds (Onoszko: a window of
   ONOSZKO_ROUNDS phase-1 rounds holding its first PENS merge, which
   must move exactly the nodes that merged, and its ms per local step):
   ms/round, the final sampled accuracy, the
   launches, one profiled round's idle share (Onoszko: of 30 local
   steps), the phase times, ``memory_budget()`` beside
   ``max_memory_allocated``.

11. telemetry: the events, gossip-dynamics probes, numerics sentinels and
   scheduled faults of ``gossipy_tpu_torch.simulation.events``,
   ``telemetry.probes``, ``telemetry.health`` and ``simulation.faults``,
   switched on with ``ProbeConfig()``, ``SentinelConfig()`` and the
   examples' ``--chaos`` scenario (``examples/_common.py::
   demo_chaos_config``: the population partitioned in half over the
   middle third of the run, then healed). (a) On the card and on the CPU
   from the same seeds, TEL_CHECK_ROUNDS rounds each: the north star on
   the single-pass deliver (K1), the flagship at TEL_FLAG_CHECK_NODES
   nodes and TEL_FLAG_CHECK_SUBSAMPLE images with fp32 compute and a
   bf16 ring (K2, TEL_FLAG_CHECK_ROUNDS rounds) and All2All at
   TEL_A2A_CHECK_NODES nodes: accounting, ``failed_chaos``, boxes and
   ages equal; every probe, health and chaos integer array (staleness
   histograms, accepted counts, non-finite counts, first bad slot,
   divergence flags, trips, watermarks, component counts) equal; the
   float arrays within REF_TOL plus REF_TOL of their magnitude (the
   flagship's plus the most bf16 compute moves each in a round on the
   CPU, the decision-flip rule); K1 or K2 once a round with messages,
   every call
   bit-equal to its plain version (``MergeAudit``: the probes read the
   merged rows the deliver's own launch produced, so no second launch).
   Then the north star with a NaN written into one node's params after 2
   clean rounds: both trip in round 3 with the same first bad slot and
   per-leaf counts. (b) The north star's three timed legs on K1, each a
   warm-up and TEL_BENCH_ROUNDS rounds in two halves, interleaved (the
   legs in order, then in reverse, so a drift of the host's speed falls
   on each alike): telemetry off, probes and sentinels, and the chaos
   added (its gap's peak and ``rounds_to_reconverge``), rounds/s of each
   and its share of the first; the full-width flagship (FLAG_NODES nodes, bf16 compute, bf16
   ring) with all three on for FLAG_ROUNDS rounds, its ms/round beside
   phase 8's bf16 leg. In (b) no call of K1's or K3's plain version is
   allowed, and the launches are K1 or K2 once a round with messages.

12. sparse: the population-scale configurations of the JAX package's
   ``bench.py --scale`` and ``--scale-all2all`` (and the last rung of
   ``scripts/scale_ladder.py``), built by their twin
   ``gossipy_tpu_torch/examples/scale.py``: the synthetic spambase-shaped
   set (4 samples a node, the eval capped at 2048), LogReg under SGD 0.1,
   batch 4, MERGE_UPDATE, PUSH on ``SparseTopology.random_regular(N, 20,
   seed=42)`` (CSR, no ``[N, N]`` anywhere), a 1% sampled eval on the
   last round, an fp32 ring, the default deliver (K1). (a) The native
   generator (``gossipy_tpu_torch/native``, built by g++ here) gives the
   edge sets whose digests ``NATIVE_DIGESTS`` pins to the JAX package's
   generator; then at SPARSE_CHECK_NODES nodes, SPARSE_CHECK_ROUNDS
   rounds on the card and on the CPU from the same seeds: the vanilla
   row on the single-pass deliver, the same under a partition and churn
   (the sparse chaos draw over the alive neighbour slots), the neighbour
   cache, All2All over ``SparseMixing`` in its segment and padded forms:
   accounting, boxes, ages and ``aux`` equal, params within REF_TOL plus
   REF_TOL of their magnitude, K1 once a round with messages and every
   call bit-equal to its plain version (``MergeAudit``). (b) The vanilla
   row at SCALE_NODES nodes (a warm-up round, SCALE_ROUNDS timed rounds:
   rounds/s, the final accuracy, the topology's build time, K1's
   launches against the rounds with messages, one profiled round's idle
   share, the phase times, ``memory_budget()`` beside
   ``max_memory_allocated``), K1 against its plain version, timed, at
   that shape (``at_scale_shape``), the LADDER_NODES rung on the same
   path (LADDER_ROUNDS rounds; K1 at its shape, ``at_ladder_shape``), and
   the All2All row at SCALE_NODES nodes,
   SCALE_A2A_ROUNDS rounds, in the segment and the padded form.

13. sequential: the sequential high-fidelity engine
   (``SequentialGossipSimulator``), which launches no merge kernel. (a)
   On the card and on the CPU from the same seeds (``TorchDraws(3)``),
   SEQ_CHECK_ROUNDS rounds at SEQ_CHECK_NODES nodes of the audit twin's
   configuration (``examples/audit_fidelity.py``) in each of SEQ_CHECKS:
   PUSH with drops and offline receivers, PUSH_PULL with random delays,
   async nodes, the randomised token account, pass-through and the
   neighbour cache (on a Barabasi-Albert graph), chaos (outage,
   partition, drop and delay spikes) with probes and sentinels: the same
   per-message event stream, accounting, causes, total size, balances
   and ages; params within REF_TOL plus REF_TOL of their magnitude; the
   telemetry as phase 11 holds it; each run's feature seen; no kernel
   launch. (b) The north-star configuration (``northstar_parts``)
   through the sequential engine on the card: a warm-up round, one round
   measured, then the rounds that fit SEQ_TARGET_S (at most
   SEQ_MAX_ROUNDS): ms/round, messages/s, the final accuracy beside
   phase 7's default leg after as many rounds; one profiled round's
   device launches per message and idle share. (c) The audit twin at its
   defaults, plain and ``--tokenized``: its JSON line; K1 launches in the
   plain twin's bulk leg (the tokenized bulk simulator defaults to the
   plain deliver, which launches none).

14. configs, checkpoints and recovery: ``gossipy_tpu_torch.config``,
   ``checkpoint``, the engine's ``save``/``load``/``check_memory_budget``
   and ``tracing=``, and ``telemetry.health.FlightRecorder`` with
   ``replay_bundle``. (a) ``models/nn.py::_lecun_normal``'s values at
   LECUN_PIN's seed and shape from the card machine's torch, which must
   be the pinned bits; every ``examples/configs/*.json`` (not
   ``service/``) read as it is and built through ``build_experiment`` on
   the card and on the CPU: equal knobs (the simulator's class and timing,
   the handler's hyperparameters, the partition), topology edges, shards
   and mixing weights; CONFIG_CHECKED (LogReg, linear, k-means and MF
   configs at their own widths) CONFIG_CHECK_ROUNDS rounds card against
   CPU from the configs' seeds as phase 9 holds them, K1 once a round on
   ``spambase_100``'s single pass (``MergeAudit``), no launch on the plain
   paths; CONFIG_CARD_ONLY (the 100-node CIFAR10Net flagship)
   CONFIG_CARD_ROUNDS rounds on the card with their launches counted
   (Onoszko's config is built and compared only: phase 10 runs the same
   PENS simulator at the same width through its first merge). (b) Checkpoints: ``spambase_100``
   as 2 x CKPT_ROUNDS rounds straight against CKPT_ROUNDS, ``save``, a
   fresh simulator's ``load`` and CKPT_ROUNDS more, bit-equal in every
   leaf with equal accounting and K1 in both; the same on a bf16 and an
   int8 ring (K2, CKPT_SHORT) and on ``hegedus_2021``'s tokens (``aux``,
   CKPT_TOKEN); an int8 checkpoint of the card loaded on the CPU and the
   reverse, equal to the element with the draw state; phase 13's
   sequential configuration through ``CheckpointManager`` (CKPT_SEQ),
   the message stream and state of the same chunks run straight; save
   and load ms and the bytes. (c) Recovery: ``spambase_100`` with
   sentinels and a NaN written into one node before a known round
   (REC_NAN_AT) under ``FlightRecorder(chunk=REC_CHUNK)``: the bundle
   (the JAX bundle's five files) of the last healthy chunk start, and
   ``replay_bundle`` on a fresh simulator matching it with the leaf, the
   node and the phase. (d) The flagship config's ``check_memory_budget``
   against ``torch.cuda.mem_get_info``, then a limit one byte below the
   budget: ``MemoryBudgetExceeded`` with no launch. (e)
   ``spambase_100.json`` through ``run_experiment`` on the card:
   CONFIG_TIMED_ROUNDS rounds after a warm-up, the build and pre-training inside
   the clock, then ``start`` alone, beside phase 7's legs; the final
   accuracy, K1's launches, one round's idle share; ``tracing=`` on
   against off in interleaved halves of TRACE_HALF_ROUNDS rounds.

15. performance, metrics and the run ledger: the engine's ``perf=``,
   ``metrics=`` and ``ledger=``, ``start(profile_dir=...)`` and the phase
   ranges (``telemetry.cost``, ``metrics``, ``ledger``, ``scopes``). (a)
   The north star on K1 as PERF_CHUNKS segments, once with every
   host-side option on (``tracing=`` too), once with all off, from the
   same seeds: every state leaf bit-equal, every report array equal, K1
   once a round with messages in both. (b) Three north-star legs on K1
   in PERF_TURNS interleaved turns of PERF_TURN_ROUNDS rounds: off, all
   on, and off with the phase ranges made null (this script only): each
   leg's rounds/s and its share. (c) The north star with ``perf=`` for
   PERF_NS_ROUNDS rounds and the flagship config (``cifar10_100nodes``)
   with ``perf=`` for PERF_FLAG_ROUNDS rounds, each one ``start``: the card's name and its peak from the peak
   table, the analytic FLOPs a round equal to the same configuration's
   count on the CPU, perf's ms/round within PERF_AGREE of the host clock
   around the same ``start``, ``mfu_est`` = flops / (s x peak), the
   banked ``hbm_peak_bytes`` beside ``memory_budget()``. (d)
   PROFILE_ROUNDS north-star rounds under ``start(profile_dir=...)``: the
   trace holds the four round phases, ``phase_times_from_trace`` gives
   each a positive device time, their sum within the trace's device
   time; ``examples/profile_round.py``'s ``profile`` at
   ATTRIBUTION_ROUNDS rounds: its three legs sum to the whole round
   within PERF_AGREE. (e) The metrics registry of (a) against the
   reports' sent and failed by cause; its ledger, one row a segment
   under one run id; phase 14's recovery run under
   ``GOSSIPY_TPU_LEDGER``: one bundle row.

16. cohort: active-cohort rounds over a host pool
   (``gossipy_tpu_torch.simulation.cohort``: ``CohortConfig``,
   ``CohortPool``, ``NominalTopology``, ``PoolStore``, the prefetch
   pipeline). (a) ``bench.py::bench_cohort``'s configuration at its
   defaults: ``NominalTopology(COHORT_NOMINAL)``,
   ``CohortConfig(size=COHORT_SIZE)``, LogReg(57, 2) under SGD 0.1,
   batch 4, one local epoch, PUSH, ``delta=100``, a 1% sampled eval on
   the run's last round, an fp32 ring, a bank of 4C shards (node ``i``
   reads shard ``i % 4C``), the default deliver (K1 once a round). The
   pool's init time; COHORT_ROUNDS warm-up rounds and COHORT_ROUNDS timed
   ones (the card synchronised before the host clock stops, the counts
   set to 0 just before), serial and with ``prefetch=2``, from one pool:
   rounds/s, their ratio, the streamed pool bit-identical to the serial
   one, K1's launches, a profiled ``start``'s idle share; a traced serial
   and a traced streamed run of COHORT_TRACE_ROUNDS rounds
   (``trace_report``'s ``overlap_frac`` and ``host_blocked_frac``); the
   coverage after both runs monotone and within (0.5, 1] of R C / N;
   an lr = 0 run of COHORT_AVG_ROUNDS rounds that must shrink the pool's
   param variance; ``memory_budget()``'s cohort numbers beside
   ``max_memory_allocated``. (b) At COHORT_PLAIN_NOMINAL, one pool and
   one draw state, COHORT_PLAIN_ROUNDS rounds on K1 (every call bit-equal
   to its plain version, ``MergeAudit``), on the same path with K1's
   plain version in its place (the pool bit-equal, no launch), and on the
   plain deliver (the same cohorts, touched rows, coverage and sends).
   (c) The ``examples/cohort_smoke.py`` configuration (N = 96, C = 24)
   on the CPU and on the card from one pool and draw state,
   COHORT_CHECK_ROUNDS rounds on an fp32 ring (K1) and a bf16 ring (K2):
   accounting, ages, phases and touched rows equal, params within
   REF_TOL (plus half a bf16 step), every merge call audited. (d) The
   twin's eight checks on the card, its 100M-node disk pool included.
   (e) K1 against its plain version, timed, at the cohort shape
   (``at_cohort_shape``: C rows of LogReg's stride, the derived K, the
   ring's cells).
17. service: the multi-tenant service (``gossipy_tpu_torch.service``:
   ``RunRequest``, the shape packer, ``GossipService``,
   ``ServiceSession``, the SLO harness), each lane of a bucket its own
   simulator and state, stepped in turn. (a) The ``main_service`` twin at
   its defaults (4 tenants, 64 nodes, 30 rounds, slices of 10): two
   buckets, mallory evicted with a bundle that replays on the card,
   alice and bob DONE, alice's report bit-equal to her solo
   ``run_experiment``. (b) Four tenants of ``spambase_100.json`` at full
   width (seeds SERVICE_SEEDS, ``drop_prob`` SERVICE_DROPS) as one
   bucket, SERVICE_ROUNDS rounds in slices of SERVICE_SLICE:
   tenant-rounds/s over the slices beside phase 7's solo K1 rounds/s,
   each tenant's TTFR, ``service_host_blocked_frac``. (c) The
   ``loadgen`` twin (its default pool, 6 tenants, time scale
   SERVICE_TIME_SCALE, traced): the ``service_slo`` row, no missing
   TTFR, ``trace_report``'s ``host_blocked_frac``. (d)
   ``tests/test_torch_service.py``'s bucket on the CPU and on the card
   from the same seeds, SERVICE_CHECK_ROUNDS rounds, on an fp32 ring (K1)
   and a bf16 ring (K2): statuses, accounting, boxes, ages and the
   eviction round equal, params within REF_TOL (plus half a bf16 step).
   In every run K1 (K2) launches once per lane round with messages (the
   rounds a lane ran, read as the scheduler copies each slice to the
   host; counts set to 0 just before each ``serve``); in (a) and (d)
   every call is bit-equal to its plain version (``ServiceAudit``).

18. parallel: the parallel layer (``gossipy_tpu_torch.parallel``: the
   rule registry, meshes, the ring collectives) on a virtual mesh of
   MESH_POSITIONS positions on the one card, every hop a kernel launch.
   (a) ``sharded_gather_merge_multi`` at the north star's shape (100
   rows, 116 columns, K = 6, 25 rows a position) and the flagship's (100
   rows of CIFAR10Net's stride): the ring with K1 on every hop bit-equal
   to the same ring with K1's plain version on every hop, within
   MESH_TOL of the unsharded K1 call, 16 launches a call, device ms of
   the ring, the plain ring and the unsharded call beside the bound
   (K1's ``at_sharded_shape``). (b) ``spambase_100.json`` at full width
   with ``mesh=``, MESH_ROUNDS rounds: the card against the same virtual
   mesh on the CPU (accounting exact, params within REF_TOL), against the
   card's unsharded K1 run (sent and failed equal, params within
   MESH_TOL, accuracy within 1e-4), its rounds/s beside phase 7's K1
   leg; a bf16-ring run widened before the ring (K1 on every hop, no K2)
   against the unsharded bf16 run (K2), within MESH_TOL plus half a bf16
   step. (c) ``All2AllGossipSimulator(mesh=, ring_mix=True)`` at the
   ``main_all2all`` twin's width against the dense mix, MESH_A2A_ROUNDS
   rounds. (d) ``ring_attention(flash=True)`` at S = ATTN_S, D = Dv =
   ATTN_D in f32 and bf16, causal and not, against the unsharded
   ``flash_attention`` (f32 within 1e-4 of its largest magnitude, bf16
   within one bf16 step), 16 hops (launches) a call, its device ms
   beside the unsharded call and the bound (K5's ``at_ring_shape``); the
   f32 gradients of q, k and v through the ring against the unsharded
   ones, under a fixed unit-scale upstream gradient (within 1e-3 of the
   gradients' largest magnitude). (e) The demo twin with ``--devices 4`` (960 K5 launches in 60
   steps) against ``--devices 1``.
19. analysis and forensics (``gossipy_tpu_torch.analysis`` and the twins
   of the JAX scripts), each part's launch counts set to 0 just before
   it and read just after, ``LAUNCHES`` equal to the kernel-entry log
   (``ENTRIES``) for every kernel. (a) ``examples/program_gate.py`` on
   the card: the launch gate (unfused 0, fused multi 1, fused compact 1
   kernel entries a round), the eleven identity pairs of the JAX gate
   (every op of two rounds of ``start`` equal, the host syncs included),
   the eleven fingerprints logged (the golden holds the host's torch
   only). (b) ``examples/fused_smoke.py``: the directed-cycle parity at
   K = 4 (fp32 multi bit-equal to the unfused deliver, the int8 ring
   through K2 within 1e-6, accounting equal), the launch property, and
   the deliver A/B on a 16-node CIFAR10Net clique (``receive_merge`` ms
   a round from the profiler, multi below per_slot). (c)
   ``examples/scale_ladder.py`` at LADDER_RUNGS (LADDER_RUNG_ROUNDS
   rounds each; predicted budget, FLOPs and linear-in-N time beside the
   measured ms/round, rounds/s, ``mfu_est`` and the run's peak
   allocation), then a ``--fail-at`` run over FAIL_RUNGS whose verdict
   must name the failing rung, its budget and peak and the last healthy
   rung, its bundle written. (d) ``examples/microbench_components.py``
   at the flagship's widths, MICRO_REPS timed calls a component. (e)
   ``examples/chaos_smoke.py`` (the gap opens and closes, the chunked
   run bit-identical, the sequential engine's story) and
   ``examples/ci_smoke_artifact.py`` (its artifacts and self-checks, and
   a poisoned run that trips and writes its bundle). (f)
   ``examples/baseline.py``'s MLP for BASELINE_EPOCHS epochs on the card
   and on the CPU from the same seeds: it learns (accuracy above
   BASELINE_MIN_ACC), and the two agree within REF_TOL on params and
   BASELINE_METRIC_TOL on the metrics.
20. the contract entry twin (``gossipy_tpu_torch/entry.py``, the
   counterpart of ``__graft_entry__.py``). (a) ``entry()`` on the card:
   ``fn(*args)`` gives finite ``[8, 10]`` logits; on a numpy-seeded batch
   the card's logits within REF_TOL of the largest |logit| of the CPU's
   from the same params. (b) ``dryrun_multichip(ENTRY_DEVICES)`` on a
   virtual 2 x 2 (nodes, model) mesh of the card, its summary line and
   launches; then each of its four legs on the card (counts set to 0
   just before and read just after) against the same leg on the CPU from
   the same draws: the main round (clique, PUSH_PULL, ``UniformDelay(0,
   15)``, pinned compaction; K1) and the sparse round (K1) with equal
   accounting, boxes and ages, params within REF_TOL and accuracy within
   ENTRY_ACC_TOL; causal ring attention, K5's f32 route on every hop,
   within 1e-5 of the plain ring and REF_TOL of the CPU's; the All2All
   ring-mix round, a product with no launch. (c) The API reference
   generator (``examples/gen_api_docs.py``) renders every page here.
21. one gossip run across processes: the parent (its kernels built in
   phase 2) starts RANKS processes of this script (``--rank``), both on
   ``cuda:0``; each joins the process group by
   ``parallel.init_distributed`` (ranks that share a card take gloo, a
   chunk crossing through pinned host buffers) and builds a 2-position
   mesh over every rank's positions, each rank holding its own rows of
   every node-axis leaf. On that mesh: (a) phase 7's north star at full
   width (100 nodes, 50 a rank, the multi deliver: K1 a position a hop of
   the sharded merge), a 2-round warm-up, a fresh init, then
   RANK_NS_ROUNDS rounds timed; (b) phase 4's 64-node CIFAR10Net clique
   (rows of 73,420 floats), a warm-up round, a fresh init, then
   RANK_FLAG_ROUNDS rounds; (c) ``ring_attention`` in f32, causal, at
   phase 18's shape (K5's f32 route on every hop). Each leg runs the same
   way in the parent on a 2-position virtual mesh of the card, and (a)
   unsharded too: both ranks' accounting equal to the virtual mesh's,
   their rows of every leaf, their metrics and their ring outputs
   bit-equal to it, the ring within 1e-4 of the output's largest
   magnitude of the unsharded ``flash_attention``; rounds/s of the two
   ranks beside the virtual mesh and the unsharded run, K1 and K5
   launches per rank (counts set to 0 just before each leg), the
   transport and the bytes a hop moves. On the same two ranks: (d) (b)'s
   clique on a 2 x 2 ``(nodes, model)`` mesh (``make_mesh_tp``, two
   positions a rank); (f) phase 18's 100-node All2All, ``ring_mix`` and
   dense, RANK_A2A_ROUNDS rounds; (g) the north star with probes,
   sentinels, a chaos scenario (an outage of rank 0's every node, a
   partition across the ranks) and a live ``CallbackReceiver``, and the
   same run without them, RANK_TEL_ROUNDS rounds; (h) the north star
   saved by both ranks after RANK_CKPT_ROUNDS rounds (one file, written
   by rank 0 after a gather), a fresh simulator on the ranks restoring
   it, and the file the virtual mesh saved (a one-process checkpoint),
   and running RANK_CKPT_ROUNDS more, and the same on an int8 ring at
   RANK_CKPT_SHORT rounds: each file equal leaf for leaf and in its draw
   state to the virtual mesh's, each resume bit-equal to the
   uninterrupted virtual mesh run, the ranks' file restored unsharded in
   the parent within REF_TOL of it (the ring sums in another order),
   save and load ms and the bytes a rank; (i) the north star with
   sentinels and a NaN written into a row of rank 1 before round
   RANK_REC_NAN[1] under ``FlightRecorder(chunk=RANK_REC_CHUNK)``: one
   bundle, its checkpoint and verdict equal to the virtual mesh run's,
   ``replay_bundle`` of it in the parent finding the same first bad
   round, and the recorder's start-state gathers timed; (j) the north
   star with ``perf=``, ``metrics=``, ``ledger=`` and ``tracing=`` on and
   all off, RANK_HOST_ROUNDS rounds each in two interleaved halves: the
   analytic cost and the population counters equal to the virtual
   mesh's, a ledger row a rank a ``start()``, the ranks' traces merged
   under both pids, the manifest's process count and index, rounds/s on
   against off (no bound); (k) the north star through a user's subclass
   of the engine (``quota_simulator``: ``_init_aux``, ``_pre_send`` and a
   ``_send_gate`` that reads a per-node ``aux`` value),
   RANK_VARIANT_ROUNDS rounds; (l) ``bench.py::bench_cohort``'s
   configuration (nominal COHORT_NOMINAL, C = COHORT_SIZE, C/2 rows a
   rank), serially and with ``prefetch=COHORT_PREFETCH``,
   RANK_COHORT_ROUNDS rounds after RANK_COHORT_WARM, every round a
   segment: pools and reports bit-equal, the streamed pool equal to the
   serial one; (m) four ``spambase_100.json`` tenants in one service, one
   submitted after the first slice (by rank 1 a slice later still) and
   one poisoned: every tenant's status, rounds and report, the
   admissions, the buckets and the eviction equal, rank 0 alone writing
   the output directory (audit events), tenant-rounds/s a rank; (n)
   (l)'s configuration with ``CohortConfig(pool_dir=)``, each rank in
   its own replica of the store (rank 0's the directory itself, rank 1's
   ``<dir>.rank1``): the store created and RANK_POOL_ROUNDS rounds
   serially, re-opened with ``prefetch=COHORT_PREFETCH`` and
   RANK_POOL_ROUNDS more, saved across the ranks (rank 0 writes), loaded
   into each rank's work directory and RANK_POOL_ROUNDS more: reports
   and the digests of the written rows bit-equal after every segment,
   the replicas equal, rows written, apparent and allocated bytes,
   ``fs_keeps_holes``, peak RSS and rounds/s a rank beside (l)'s. Then
   GRID_RANKS
   processes: (e) (b)'s clique on a 4 x 2 ``(dcn, nodes)`` mesh
   (``make_mesh_2d``, two positions a rank). Each is held against the
   same leg on a virtual mesh of its shape (for (d) and (e) one that
   splits its update as the ranks do): accounting, rows, report and live
   rows bit-equal (the two chaos vitals the card sums with atomics within
   1e-5 of the value plus 1e-6), K1's launches a rank, ms/round beside
   the virtual mesh's, staged bytes.

The last lines are the card's name and power limit, one JSON object with
every kernel's numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

ROUNDS = 3          # timed rounds of the fp32 single-pass path
LEG_ROUNDS = 2      # timed rounds of each other path
N_NODES = 64
SLOTS = 4
KERNEL_TOL = 0.0    # --fmad=false: the kernels round as the plain versions
REF_TOL = 1e-4      # card vs CPU params: matmul reduction order differs

# Device memory rate of each H100 part (NVIDIA data sheets), by a
# substring of torch.cuda.get_device_name().
MEMORY_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                      ("H100", 3.35e12))
# fp32 outside the tensor cores, H100 SXM (NVIDIA's data sheet); the folds
# are elementwise, so no tensor-core rate applies.
FP32_FLOPS = 67e12
L2_BYTES = 50 * 2**20   # the H100's L2 cache
# The dense bf16 tensor-core rate of each H100 part is the port's
# telemetry.cost.PEAK_FLOPS (NVIDIA data sheets), read by tensor_rate: the
# bound of attention's two products (a bf16 x bf16 product is exact in
# f32) and the MFU's denominator are one table.
# The TF32 tensor-core rate is half the bf16 one on every H100 part (the
# same data sheets): the bound of the 3xTF32 route's three products.
TF32_PER_BF16 = 0.5
# The north-star configuration (bench.py:29-35, 228-260).
NS_NODES = 100
NS_DEGREE = 20
NS_CHECK_ROUNDS = 10
NS_WARMUP_ROUNDS = 20
# Timed rounds of each phase-7 north-star leg: bench.py times 2000; 150
# (300 until phase 21 (k)-(m) needed the time) keep the script inside its
# time limit on a slow host.
BENCH_ROUNDS = 150
ATTN_S = 8192       # the JAX bench's flash-attention regime:
ATTN_D = 128        # one head, head dim 128, causal (bench.py:1093)
# The flagship (examples/main_cifar10_100nodes.py,
# examples/configs/cifar10_100nodes.json) through its twin,
# gossipy_tpu_torch/examples/main_cifar10_100nodes.py.
FLAG_NODES = 100
FLAG_ROUNDS = 5             # timed rounds of each ring leg
FLAG_CHECK_NODES = 16       # the card-against-CPU runs
FLAG_CHECK_SUBSAMPLE = 2048
FLAG_CHECK_ROUNDS = 1       # one round of messages (K1/K2 audited); the
                            # second round's CPU update pass paid for
                            # phase 16
FLAG_WIRES = ("float32", "bfloat16", "int8")

# The paths of phase 4 after the first: (label, fused_merge, history_dtype).
LEGS = (("plain", False, "float32"),
        ("per_slot", "per_slot", "float32"),
        ("per_slot-bf16", "per_slot", "bfloat16"),
        ("per_slot-int8", "per_slot", "int8"),
        ("multi-bf16", "multi", "bfloat16"),
        ("multi-int8", "multi", "int8"))
ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}

# The native generators' edge sets that phase 12 holds the card machine's
# build to: sha256 of the int32 [E, 2] edge list of
# random_regular_edges(2048, 20, 42) and barabasi_albert_edges(4141, 10,
# 42), pinned equal to the JAX package's generator by
# tests/test_torch_sparse.py.
NATIVE_DIGESTS = {
    ("random_regular", (2048, 20, 42)):
        "a74f85469ed4827b25d96f55ad7cb667959a6aaaad32bb38e48d5656a31e0739",
    ("barabasi_albert", (4141, 10, 42)):
        "547ee97e7aae343ce97c1fea261e79164285c8dd63bfa8a4044c0620e1a521d9",
}


# ``models/nn.py::_lecun_normal((57, 2), 57, Generator().manual_seed(0))``:
# its first six values as float32 bit patterns. Phase 14 draws them with
# the card machine's torch and fails unless they are these
# (``tests/test_torch_models.py::test_lecun_normal_pinned`` holds the
# same values on the host's torch).
LECUN_PIN = {"seed": 0, "shape": (57, 2),
             "bits": (1048290957, 1033913533, 3161465076, 1044841987,
                      1029340760, 1038873588)}


def edge_digest(edges) -> str:
    """sha256 of an edge list as contiguous int32."""
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(edges, dtype=np.int32)
                          .tobytes()).hexdigest()


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def memory_rate(name: str) -> float:
    for key, rate in MEMORY_BYTES_PER_S:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate known for {name!r}")


def time_ms(torch, fn, reps: int = 20, iters: int = 50) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed ``iters`` times between CUDA events; the median replay over
    ``reps``. The graph removes the host's launch overhead from the
    window, so this is the time the card spends on the call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def time_ms_cold(torch, fn, args, nbytes: int, iters: int = 50) -> float:
    """As ``time_ms``, with no call finding its inputs in the L2: the
    calls rotate over copies of ``args`` (each tensor cloned), enough that
    the calls between two on one copy move 3 L2s or more (``nbytes``: one
    call's). On the engine's path a round's other work comes between two
    merges, so a call there starts cold, as here."""
    copies = max(2, -(-4 * L2_BYTES // nbytes))
    sets = [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
            for _ in range(copies)]
    turn = itertools.count()

    def call():
        return fn(*sets[next(turn) % copies])
    return time_ms(torch, call, reps=copies * -(-20 // copies), iters=iters)


def call_ms(torch, fn, iters: int = 50) -> float:
    """Median host-clock time of one eager call, launch overhead included
    (synchronised after each call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes: int, flops: int, rate: float):
    """The least time for ``nbytes`` and ``flops``, and which bounds it."""
    bytes_ms, flops_ms = nbytes / rate * 1e3, flops / FP32_FLOPS * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations")


def merge_tables(rng, n: int, d: int, k: int):
    """Tables as one round of the main path builds them: each of ``n``
    senders picks one peer of a clique; slots fill in sender order; an
    empty slot is (ws, wp) = (1, 0) with an index into the older ring
    cell."""
    peers = (np.arange(n) + rng.integers(1, n, n)) % n
    idx = np.full((n, k), n, np.int64)  # empty: a row of the other cell
    wp = np.zeros((n, k), np.float32)
    fill = np.zeros(n, np.int64)
    for s, r in enumerate(peers):
        if fill[r] < k:
            idx[r, fill[r]] = s
            wp[r, fill[r]] = 0.5
            fill[r] += 1
    idx = np.where(wp == 0, n + rng.integers(0, (d - 1) * n, (n, k)), idx)
    return idx, (1.0 - wp).astype(np.float32), wp


def sweep_tables(rng, n: int, d: int, k: int, live: float):
    """Tables with each slot live with probability ``live``, naming a row
    of the first ring cell; an empty slot names a row of another cell and
    carries wp = 0 and, in one of four, ws = 0.75 (the kernel may not take
    an empty slot's ws for 1)."""
    on = rng.uniform(size=(n, k)) < live
    idx = np.where(on, rng.integers(0, n, (n, k)),
                   n + rng.integers(0, (d - 1) * n, (n, k)))
    wp = np.where(on, rng.uniform(0.1, 0.9, (n, k)), 0.0).astype(np.float32)
    ws = np.where(on, 1.0 - wp,
                  np.where(rng.uniform(size=(n, k)) < 0.25, 0.75, 1.0))
    return idx.astype(np.int64), ws.astype(np.float32), wp


def check_equal(torch, name, got, want, shape) -> float:
    """Raise unless ``got`` is finite and bit-equal to ``want`` (a zero's
    sign included); returns the max abs error."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name} output is not finite (NaN rows leaked) "
                           f"at {shape}")
    err = float((got - want).abs().max())
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    if err > KERNEL_TOL or bad:
        raise RuntimeError(f"{name} disagrees with its plain version: max "
                           f"abs err {err} > {KERNEL_TOL} or {bad} elements "
                           f"of other bits at {shape}")
    return err


def wire_ring(torch, rng, m, f, n_leaves, wire, dev):
    """A ``[m, f]`` ring in ``wire`` format and, for int8, its ``[m, L]``
    scales (else None), on ``dev``."""
    if wire == "int8":
        q = rng.integers(-127, 128, (m, f)).astype(np.int8)
        scale = rng.uniform(0.001, 0.02, (m, n_leaves)).astype(np.float32)
        return torch.from_numpy(q).to(dev), scale
    h = torch.from_numpy(rng.normal(size=(m, f)).astype(np.float32))
    return h.to(dev, getattr(torch, wire)), None


def check_flat(torch, merge, wire, n, d, f, starts, seed, rate,
               label: str = "", timed: bool = True) -> dict:
    """K3 (float32 ring) or K4 against its plain version, bit for bit, at
    one shape (``label``); a call of ``gather_merge_flat`` must be one
    kernel (one kernel node in a CUDA graph that captured it, one launch
    counted). Timed (``timed``): the wrapper's device time, the plain
    version's, the bound and the share; where a call moves more than a
    quarter of the L2, these times are ``time_ms_cold``'s, the path's,
    and ``warm_ms``/``warm_plain_ms`` are ``time_ms``'s back-to-back
    calls, whose inputs may stay in the L2."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    m = d * n
    p = rng.normal(size=(n, f)).astype(np.float32)
    p[::3, f // 2] = -0.0
    p = torch.from_numpy(p).to(dev)
    h, scale = wire_ring(torch, rng, m, f, len(starts), wire, dev)
    idx, ws, wp = merge_tables(rng, n, d, 1)
    scale_t = None if scale is None else torch.from_numpy(scale).to(dev)
    starts_t = None if scale is None else torch.tensor(
        starts, dtype=torch.int32, device=dev)
    args = (p, h, *(torch.from_numpy(a[:, 0]).to(dev) for a in (idx, ws, wp)))
    name = merge.KERNEL_FLAT if wire == "float32" else merge.KERNEL_FLAT_DQ
    plan = merge.flat_plan(n, f, h.dtype, True, scale is not None)

    def kernel(*a):
        return merge.gather_merge_flat(*(a or args), scale_t, starts_t)

    def plain(*a):
        return merge.gather_merge_reference(*(a or args), scale_t, starts_t)
    shape = (n, m, f, len(starts))
    err = check_equal(torch, f"{name} [{wire}] {label}", kernel(), plain(),
                      shape)
    before = merge.LAUNCHES[name]
    types = graph_node_types(torch, kernel)
    counted = merge.LAUNCHES[name] - before
    if types != [GRAPH_KERNEL_NODE] or counted != 1:
        raise RuntimeError(f"{name} [{wire}] at {shape}: a call captured in "
                           f"a CUDA graph holds nodes of types {types} and "
                           f"counted {counted} launches, not one kernel")
    route = (f"{'vec' if plan.vec else 'scalar'} "
             + (f"wide grid {plan.grid} tile={plan.tile} "
                f"words_per_lane={plan.words_per_lane}" if plan.wide else
                f"rows G={plan.group} {plan.rows_per_block} a block grid "
                f"{plan.grid}"))
    head = (f"[kernels] {name} [{wire}] {label} n={n} m={m} f={f} "
            f"leaves={len(starts)} {route} one kernel a call "
            f"max_abs_err={err}")
    # Least work: p read once, out written once, each receiver's ring row
    # once at wire width (no zero-weight mask) with its L scales, the
    # tables and leaf starts once. Per element: a multiply (the scale,
    # int8 only), a multiply and the blend's multiply and add.
    n_scales = 0 if scale is None else len(starts)
    rows = len(np.unique(idx[:, 0]))
    flops = f * 3 * n + (0 if scale is None else f * n)
    nbytes = (4 * f * 2 * n + ITEMSIZE[wire] * f * rows + n * (8 + 4 + 4)
              + 4 * n_scales * rows + 4 * n_scales)
    bound_ms, bound_by = bound(nbytes, flops, rate)
    if not timed:
        log(head)
        return dict(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by)
    out = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by)
    ms = time_ms(torch, kernel)
    plain_ms = time_ms(torch, plain)
    warm = ""
    if nbytes > L2_BYTES // 4:
        out.update(warm_ms=ms, warm_plain_ms=plain_ms)
        warm = (f" (cold L2; back to back warm_ms={ms:.5f} warm_plain_ms="
                f"{plain_ms:.5f} warm_share={bound_ms / ms:.3f})")
        ms = time_ms_cold(torch, kernel, args, nbytes)
        plain_ms = time_ms_cold(torch, plain, args, nbytes)
    log(f"{head} ms={ms:.5f} plain_ms={plain_ms:.5f} bound_ms={bound_ms:.5f} "
        f"share={bound_ms / ms:.3f}{warm} ({nbytes} bytes, {flops} flops, "
        f"bound by {bound_by})")
    out.update(ms=ms, plain_ms=plain_ms, share=bound_ms / ms)
    return out


# Phase 3's K1/K2 sweep: (label, n, ring cells, F (None: CIFAR10Net's
# stride), K, the K2 rings it also runs). Giaretta's and Ormandi's rows are
# the shapes phases 10 and 9 derive (4,141 nodes of AdaLine(57)'s 60
# columns; K = 59 over 2 cells, K = 8 over 3), the north star's and the
# flagship's phases 7 and 8's (K = 6), the scale and ladder rows phase
# 12's, the last the first slice's (phase 4's 64 CIFAR10Net nodes).
SWEEP = (("scale", 50_000, 2, 116, 6, ("bfloat16",)),
         ("ladder", 100_000, 2, 116, 6, ()),
         ("giaretta", 4141, 2, 60, 59, ("bfloat16",)),
         ("ormandi", 4141, 3, 60, 8, ("bfloat16",)),
         ("northstar", 100, 2, 116, 6, ("bfloat16",)),
         ("flagship", 100, 2, None, 6, ("bfloat16", "int8")),
         ("phase3", N_NODES, 2, None, SLOTS, ("bfloat16", "int8")))
# The routes' edges, each with K1 and K2 on bf16 and int8 rings: rows of 1
# to 132 columns (1 and 3: the scalar form; 132: the first wide row), 1 to
# 64 slots, half of them live, SWEEP_EDGE_N rows (a multiple of no
# route's rows per block).
# The sweep's timed replays a median is taken over (phase 3's own checks
# take 50): cut to pay for phase 19.
SWEEP_ITERS = 15
SWEEP_EDGE_F = (1, 3, 4, 60, 116, 128, 132)
SWEEP_EDGE_K = (1, 59, 64)
SWEEP_EDGE_N = 37
SWEEP_EDGE_LIVE = 0.5


def multi_inputs(torch, rng, wire, n, d, f, k, starts, live=None):
    """K1's or K2's operands on the card and the least bytes and operations
    of the call. Every ring row past the first cell (named by empty slots
    only) is NaN or Inf (an int8 ring's scales there); -0.0 in a column of
    every third row of p and of the first cell, so the sign of a zero
    shows whether every slot was folded. Tables: ``live`` as
    :func:`sweep_tables`, None as :func:`merge_tables`. Least work: p read
    once, out written once, each live ring row once at wire width with its
    scales, the tables once (int64 indices); a live slot a multiply (the
    scale, if any), a multiply and the blend's multiply and add per
    element, an empty one the blend's two."""
    p = rng.normal(size=(n, f)).astype(np.float32)
    h = rng.normal(size=(d * n, f)).astype(np.float32)
    p[::3, f // 2] = -0.0
    h[:n, f // 2] = -0.0
    h[n:] = np.nan
    h[n::5] = np.inf
    idx, ws, wp = (merge_tables(rng, n, d, k) if live is None
                   else sweep_tables(rng, n, d, k, live))
    p, h, idx_t, ws_t, wp_t = (torch.from_numpy(a).cuda()
                               for a in (p, h, idx, ws, wp))
    scale = st = None
    if wire == "int8":
        m = d * n
        h = torch.from_numpy(rng.integers(-127, 128, (m, f)).astype(
            np.int8)).cuda()
        sc = rng.uniform(0.001, 0.02, (m, len(starts))).astype(np.float32)
        sc[n:] = np.nan
        sc[n::5] = np.inf
        scale = torch.from_numpy(sc).cuda()
        st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    elif wire != "float32":
        h = h.to(getattr(torch, wire))
    on = wp != 0
    live_n = int(on.sum())
    rows = len(np.unique(idx[on]))
    n_scales = 0 if scale is None else len(starts)
    nbytes = (4 * f * 2 * n + ITEMSIZE[wire] * f * rows + n * k * (8 + 4 + 4)
              + 4 * n_scales * (rows + 1))
    flops = f * (3 * live_n + 2 * (n * k - live_n))
    if scale is not None:
        flops += f * live_n
    return (p, h, idx_t, ws_t, wp_t, scale, st), nbytes, flops, live_n


def check_multi(torch, merge, label, wire, n, d, f, k, seed, rate,
                starts=(0,), live=None, plain=True, timed=True,
                iters: int = 50) -> dict:
    """K1 (float32 ring) or K2 at one shape (``label``) against its plain
    version, bit for bit; its device time (and the plain version's, with
    ``plain``), bound and share; for K1 also the host-clock time of one
    eager call (``eager_call_ms``: the wrapper's Python, its launch and
    the kernel); ``timed=False`` checks the bits only (the route edges).
    ``starts``: the int8 ring's leaf starts; ``iters``: the timed
    replays (and eager calls) a median is taken over. At the sweep's
    scale shape (``label`` "scale", phase 3's first profiler session) a
    call must put one kernel on the card and nothing else
    (:func:`one_launch`)."""
    rng = np.random.default_rng(seed)
    args, nbytes, flops, live_n = multi_inputs(torch, rng, wire, n, d, f, k,
                                               starts, live)
    name = merge.KERNEL if wire == "float32" else \
        f"{merge.KERNEL_MULTI_DQ}[{wire}]"
    n_leaves = 0 if args[5] is None else args[5].shape[1]
    plan = merge.launch_plan(n, f, k, args[1].dtype, True,
                             args[5] is not None)

    def kernel():
        return merge.gather_merge_multi(*args[:5], args[5], args[6])
    err = check_equal(torch, f"{name} {label}", kernel(),
                      merge.gather_merge_multi_reference(*args),
                      (n, d * n, f, k, n_leaves))
    if label == "scale":  # one launch a call: no kernel beside it
        one_launch(torch, merge, kernel, f"{name} {label}", "multi_rows")
    bound_ms, bound_by = bound(nbytes, flops, rate)
    if not timed:
        log(f"[kernels] {label} {name} n={n} m={d * n} f={f} k={k} "
            f"leaves={n_leaves} live_slots={live_n} max_abs_err={err}")
        return dict(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by)
    out = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
               ms=time_ms(torch, kernel, iters=iters))
    if wire == "float32":
        out["eager_call_ms"] = call_ms(torch, kernel, iters=iters)
    if plain:
        out["plain_ms"] = time_ms(
            torch, lambda: merge.gather_merge_multi_reference(*args),
            iters=iters)
    out["share"] = bound_ms / out["ms"]
    route = (f"slot walk grid {plan.grid}" if plan.slots else
             f"wide grid {plan.grid}" if plan.wide else
             f"rows G={plan.group} {plan.rows_per_block} a block") + \
        f" in_flight={plan.in_flight}"
    extra = "".join(f" {key}={out[key]:.5f}" for key in (
        "plain_ms", "eager_call_ms") if key in out)
    log(f"[kernels] {label} {name} n={n} m={d * n} f={f} k={k} "
        f"leaves={n_leaves} live_slots={live_n} "
        f"{'vec' if plan.vec else 'scalar'} {route} max_abs_err={err} "
        f"ms={out['ms']:.5f}{extra} bound_ms={bound_ms:.5f} "
        f"share={out['share']:.3f} ({nbytes} bytes, bound by {bound_by})")
    return out


def merge_sweep(torch, merge, rate, stride, starts) -> dict:
    """Phase 3's sweep of K1 and K2 over SWEEP and the route edges; returns
    ``{(label, wire): numbers}`` for SWEEP's shapes. ``stride`` and
    ``starts``: CIFAR10Net's row and leaves."""
    numbers = {}
    for seed, (label, n, d, f, k, wires) in enumerate(SWEEP, start=71):
        f = stride if f is None else f
        st = starts if f == stride else [0, f // 2]
        for wire in ("float32",) + wires:
            numbers[(label, wire)] = check_multi(
                torch, merge, label, wire, n, d, f, k, seed, rate, st,
                iters=SWEEP_ITERS)
    seed = 90
    for f in SWEEP_EDGE_F:
        st = sorted({0, f // 3, 2 * f // 3})
        for k in SWEEP_EDGE_K:
            for wire in ("float32", "bfloat16", "int8"):
                seed += 1
                check_multi(torch, merge, "edge", wire, SWEEP_EDGE_N, 2, f,
                            k, seed, rate, st, live=SWEEP_EDGE_LIVE,
                            plain=False, timed=False)
    return numbers


def cifar_sim(torch, n: int, per_node: int, batch: int, device, eval_every,
              seed: int = 0, fused_merge="multi", history_dtype="float32",
              compact_deliver=None, mesh=None):
    from gossipy_tpu_torch.core import AntiEntropyProtocol, Topology
    from gossipy_tpu_torch.data import (ClassificationDataHandler,
                                        DataDispatcher)
    from gossipy_tpu_torch.handlers import SGDHandler, losses
    from gossipy_tpu_torch.models import CIFAR10Net
    from gossipy_tpu_torch.random import TorchDraws
    from gossipy_tpu_torch.simulation import GossipSimulator

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n * per_node, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, n * per_node)
    disp = DataDispatcher(ClassificationDataHandler(X, y, test_size=0.2),
                          n=n, eval_on_user=False)
    handler = SGDHandler(CIFAR10Net(), losses.cross_entropy,
                         learning_rate=0.05, local_epochs=1,
                         batch_size=batch, n_classes=10,
                         input_shape=(32, 32, 3))
    sim = GossipSimulator(handler, Topology.clique(n), disp.stacked(),
                          delta=100, protocol=AntiEntropyProtocol.PUSH,
                          eval_every=eval_every, fused_merge=fused_merge,
                          compact_deliver=compact_deliver,
                          history_dtype=history_dtype,
                          mailbox_slots=SLOTS, draws=TorchDraws(seed),
                          mesh=mesh, device=device)
    state = sim.init_nodes(torch.Generator().manual_seed(seed),
                           common_init=True)
    return sim, state


def dev_us(e) -> float:
    """A profiler row's device time in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return getattr(e, attr)
    return 0.0


# Profiler sessions the one-launch check runs before it falls back on a
# CUDA graph; CU_GRAPH_NODE_TYPE_KERNEL.
PROFILE_TRIES = 3
GRAPH_KERNEL_NODE = 0


def device_rows(torch, fn):
    """``fn`` once under torch.profiler: its rows of device work (kernels,
    copies) and the call's wall time in microseconds. The engine's phase
    ranges (``telemetry.scopes``) also come back as device rows, each
    spanning the kernels it holds; they are not work and are left out."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    from gossipy_tpu_torch.telemetry import scopes
    ranges = set(scopes.ROUND_PHASES) | {scopes.PHASE_REPLY}
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and e.key not in ranges]
    return rows, wall_us


def one_launch(torch, merge, fn, label: str, marker: str) -> None:
    """One ``fn()`` call puts one kernel on the card (its name holding
    ``marker``) and nothing else. The profiler shows it; a session of it
    may record no device work at all (CUPTI drops a session now and then),
    so up to PROFILE_TRIES sessions are run, and when none records any,
    the call is captured in a CUDA graph, which must hold one node, a
    kernel node, while the wrapper counts one launch."""
    for attempt in range(1, PROFILE_TRIES + 1):
        rows, _ = device_rows(torch, fn)
        ran = [(e.key, e.count) for e in rows
               if not e.key.startswith("Activity")]
        if ran:
            break
        log(f"[kernels] {label}: profiler session {attempt} of "
            f"{PROFILE_TRIES} recorded no device work")
    else:
        before = sum(merge.LAUNCHES.values())
        types = graph_node_types(torch, fn)
        counted = sum(merge.LAUNCHES.values()) - before
        if types != [GRAPH_KERNEL_NODE] or counted != 1:
            raise RuntimeError(f"{label}: a call captured in a CUDA graph "
                               f"holds nodes of types {types} and counted "
                               f"{counted} launches, not one kernel")
        log(f"[kernels] {label}: one call, one kernel node in a CUDA graph "
            "that captured it (the profiler recorded nothing)")
        return
    if len(ran) != 1 or ran[0][1] != 1 or marker not in ran[0][0]:
        raise RuntimeError(f"{label}: a call ran {ran} on the card, not one "
                           "launch of its kernel")
    log(f"[kernels] {label}: one call, one kernel on the card "
        f"({ran[0][0][:60]}...)")


def graph_node_types(torch, fn) -> list:
    """The node types (CUgraphNodeType; 0 a kernel) of a CUDA graph that
    captured one ``fn()`` call, read through libcuda: what the call puts
    on its stream, counted without the profiler. ``fn`` must have run
    once already (its module loaded, its plan cached)."""
    import ctypes
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:    # a release that keeps the graph anyway
        graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    rc = cuda.cuGraphGetNodes(raw, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    if rc == 0 and count.value:
        rc = cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(count))
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        rc = rc or cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                           ctypes.byref(kind))
        types.append(kind.value)
    graph.reset()
    if rc != 0:
        raise RuntimeError(f"reading a captured CUDA graph: CUresult {rc}")
    return types


def profile(torch, fn, label: str):
    """``fn`` once under torch.profiler: the kernels that take the card's
    time, in order (and K1/K2's row wherever it falls), and the card's
    idle share of the call's wall time, which it returns (None when the
    profiler saw no device time)."""
    kernels, wall_us = device_rows(torch, fn)
    busy = sum(dev_us(e) for e in kernels)
    if busy <= 0:
        log("[profile] the profiler recorded no device time")
        return None
    log(f"[profile] {label}: wall {wall_us / 1e3:.3f} ms, "
        f"device busy {busy / 1e3:.3f} ms, idle share "
        f"{1 - busy / wall_us:.3f}")
    ranked = sorted(kernels, key=dev_us, reverse=True)
    for e in ranked[:8] + [e for e in ranked[8:] if "::multi_" in e.key]:
        log(f"[profile]   {dev_us(e) / 1e3:8.3f} ms {e.count:5d}x "
            f"{e.key[:90]}")
    return 1 - busy / wall_us


def phase_times(torch, sim, state, label: str, rounds: int = 3) -> None:
    """Host-clock ms of each phase of a round, synchronised around each
    phase, averaged over ``rounds`` rounds (eval every round here, where
    the timed runs evaluate once per run)."""
    tot = {"pre_send": 0.0, "snapshot": 0.0, "send": 0.0, "deliver": 0.0,
           "reply": 0.0, "eval": 0.0}
    for _ in range(rounds):
        r = state.round
        steps = (("pre_send", lambda: sim._pre_send(state, r)),
                 ("snapshot", lambda: sim._snapshot(state, r)),
                 ("send", lambda: sim._send_phase(state, r)),
                 ("deliver", lambda: sim._deliver_phase(state, r)),
                 ("reply", lambda: sim._reply_phase(state, r)),
                 ("eval", lambda: sim._eval_phase(state, r)))
        for name, fn in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            tot[name] += (time.perf_counter() - t0) * 1e3
        state.round = r + 1
    log(f"[phases] {label}: ms per round: " + ", ".join(
        f"{k} {v / rounds:.3f}" for k, v in tot.items()))


def check_path_output(torch, sim, state, rep, label: str) -> None:
    stride = sim.handler.layout.stride
    acc = rep.final("accuracy")
    if not torch.isfinite(state.model.params).all():
        raise RuntimeError(f"{label}: non-finite params")
    if state.model.params.shape != (N_NODES, stride) or not np.isfinite(acc):
        raise RuntimeError(f"{label}: output has the wrong shape or a "
                           "non-finite accuracy")


def run_leg(torch, merge, label: str, fused, wire: str) -> dict:
    """One path of phase 4 after the first: a warm-up round, LEG_ROUNDS
    timed rounds with the launch counts checked against the path, the
    phase times. Returns the launches per kernel of the timed rounds."""
    sim, state = cifar_sim(torch, N_NODES, 64, 32, "cuda", LEG_ROUNDS + 1,
                           fused_merge=fused, history_dtype=wire)
    state, _ = sim.start(state, n_rounds=1)     # warm-up round
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=LEG_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    compact, wide = rep.compact_slots_per_round, rep.wide_slots_per_round
    occupied = int((compact + wide).sum())
    with_msgs = int(((compact + wide) > 0).sum())
    log(f"[path] {label}: {N_NODES}-node CIFAR10Net, fused_merge={fused!r}, "
        f"history_dtype={wire}, compaction cap {sim._compact_cap}, "
        f"{LEG_ROUNDS} rounds: {wall / LEG_ROUNDS * 1e3:.3f} ms/round; sent "
        f"{rep.sent_per_round.tolist()} failed {rep.failed_per_round.tolist()}"
        f"; compact_slots {compact.tolist()} wide_slots {wide.tolist()}; "
        f"launches {launches}; final global accuracy "
        f"{rep.final('accuracy')}")
    if fused is False:
        want = {}
        if sim._compact_cap is None or int(compact.sum()) == 0:
            raise RuntimeError(f"{label}: compaction did not run")
    elif fused == "per_slot":
        kernel = merge.KERNEL_FLAT if wire == "float32" \
            else merge.KERNEL_FLAT_DQ
        want = {kernel: occupied}
    else:
        want = {merge.KERNEL_MULTI_DQ: with_msgs}
    if launches != want or (fused and occupied == 0):
        raise RuntimeError(f"{label}: launches {launches}, the path must "
                           f"make {want}")
    check_path_output(torch, sim, state, rep, label)
    phase_times(torch, sim, state, label)
    return launches


def card_vs_cpu(torch, merge, label: str, fused, wire: str) -> None:
    """The same 8-node, 3-round run on the CPU and on the card: equal
    accounting and launch counts as the path needs, params within
    REF_TOL plus one encoding step of the ring (half a bf16 step of the
    value, or half an int8 quantum of the leaf, after the 0.5 blend)."""
    runs = {}
    # The plain path takes an explicit capacity here (auto compaction
    # needs N >= 48), so the compacted pass runs in the comparison too.
    compact = 3 if fused is False else None
    for dev in ("cpu", "cuda"):
        merge.reset_launch_counts()
        s_sim, s_state = cifar_sim(torch, 8, 8, 4, dev, 3, seed=7,
                                   fused_merge=fused, history_dtype=wire,
                                   compact_deliver=compact)
        s_state, s_rep = s_sim.start(s_state, n_rounds=3)
        runs[dev] = (s_sim, s_state, s_rep, sum(merge.LAUNCHES.values()))
    (sim, st_c, r_c, l_c), (_, st_g, r_g, l_g) = runs["cpu"], runs["cuda"]
    for field in ("sent_per_round", "failed_per_round",
                  "compact_slots_per_round", "wide_slots_per_round"):
        if not np.array_equal(getattr(r_c, field), getattr(r_g, field)):
            raise RuntimeError(f"{label}: card and CPU runs differ in "
                               f"{field}")
    p_c, p_g = st_c.model.params, st_g.model.params.cpu()
    tol = REF_TOL + ring_step(torch, sim, st_c, wire)
    diff = (p_c - p_g).abs()
    worst = float((diff - tol).max())
    log(f"[reference] {label}: 8-node CIFAR10Net, 3 rounds, card vs CPU: max "
        f"abs param diff {float(diff.max()):.3e}, worst margin to the "
        f"tolerance {worst:.3e} (<= 0 passes); launches card {l_g}, CPU "
        f"{l_c}; slots {(r_g.compact_slots_per_round + r_g.wide_slots_per_round).tolist()}")
    if worst > 0 or l_c != 0 or (l_g == 0) != (fused is False):
        raise RuntimeError(f"{label}: card run does not agree with the CPU "
                           "run")


def northstar_parts():
    """``bench.py::build_sim``'s data, topology and handler through the
    port's entry points: ``(stacked, topology, handler)``."""
    from gossipy_tpu_torch.core import CreateModelMode, Topology
    from gossipy_tpu_torch.data import (ClassificationDataHandler,
                                        DataDispatcher,
                                        load_classification_dataset)
    from gossipy_tpu_torch.handlers import SGDHandler, losses
    from gossipy_tpu_torch.models import LogisticRegression

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the offline stand-in's note
        X, y = load_classification_dataset("spambase")
    dh = ClassificationDataHandler(X, y, test_size=0.2, seed=42)
    stacked = DataDispatcher(dh, n=NS_NODES, eval_on_user=False).stacked()
    topology = Topology.random_regular(NS_NODES, NS_DEGREE, seed=42,
                                       backend="networkx")
    d = X.shape[1]
    handler = SGDHandler(LogisticRegression(d, 2), losses.cross_entropy,
                         learning_rate=0.1, local_epochs=1, batch_size=32,
                         n_classes=2, input_shape=(d,),
                         create_model_mode=CreateModelMode.MERGE_UPDATE)
    return stacked, topology, handler


def northstar_sim(torch, device, seed: int = 42, cls=None, **kw):
    """``bench.py::build_sim`` through the port's entry points, on
    ``device``, with the draws of ``TorchDraws(seed)`` and the initial
    weights of a generator seeded with ``seed``; ``cls`` the simulator
    class (default ``GossipSimulator``); ``kw`` goes to the simulator (the
    default deliver unless it names another)."""
    from gossipy_tpu_torch.core import AntiEntropyProtocol
    from gossipy_tpu_torch.random import TorchDraws
    from gossipy_tpu_torch.simulation import GossipSimulator

    stacked, topology, handler = northstar_parts()
    kw = {"fused_merge": False, "protocol": AntiEntropyProtocol.PUSH, **kw}
    sim = (cls or GossipSimulator)(handler, topology, stacked, delta=100,
                                   draws=TorchDraws(seed), device=device,
                                   **kw)
    state = sim.init_nodes(torch.Generator().manual_seed(seed))
    return sim, state


class MergeAudit:
    """Holds every merge kernel call of one card run, as it happens,
    against its plain version on the same tables: the kernel's own output
    on the path's own inputs (the plain version launches nothing). Counts,
    per kernel, the calls, the tables that read ring cells older than the
    round's own (delayed messages), the reply phase's tables, and the
    worst error."""

    def __init__(self, torch, merge, sim):
        from gossipy_tpu_torch.simulation import engine
        self.torch, self.merge, self.sim, self.engine = \
            torch, merge, sim, engine
        self.phase, self.r = "deliver", 0
        self.stats = {}

    def __enter__(self):
        e, m = self.engine, self.merge
        self._saved = (e.gather_merge_multi, e.gather_merge_flat)
        e.gather_merge_multi = self._wrap(e.gather_merge_multi,
                                          m.gather_merge_multi_reference)
        e.gather_merge_flat = self._wrap(e.gather_merge_flat,
                                         m.gather_merge_reference)
        self._tag_phases()
        return self

    def __exit__(self, *exc):
        self.engine.gather_merge_multi, self.engine.gather_merge_flat = \
            self._saved
        self._untag_phases()
        return False

    def _tag_phases(self) -> None:
        """Tag each merge call with the phase and round that made it."""
        for phase in ("deliver", "reply"):
            run = getattr(self.sim, f"_{phase}_phase")

            def tagged(state, r, run=run, phase=phase):
                self.phase, self.r = phase, r
                return run(state, r)
            setattr(self.sim, f"_{phase}_phase", tagged)

    def _untag_phases(self) -> None:
        del self.sim._deliver_phase, self.sim._reply_phase

    def _wrap(self, fn, plain):
        def call(p, h, idx, w_self, w_peer, scale=None, leaf_starts=None):
            before = dict(self.merge.LAUNCHES)
            out = fn(p, h, idx, w_self, w_peer, scale, leaf_starts)
            launched = [k for k, v in self.merge.LAUNCHES.items()
                        if v != before.get(k, 0)]
            if len(launched) != 1:
                raise RuntimeError(f"a merge call launched {launched}")
            want = plain(p, h, idx, w_self, w_peer, scale, leaf_starts)
            # Bit-equal, a NaN where the plain version has a NaN (a run
            # with a NaN written into its params merges NaN rows).
            same = (out == want) | (out.isnan() & want.isnan())
            err = 0.0 if bool(same.all()) else \
                float((out - want).abs()[~same].max())
            n = self.sim.n_nodes
            cells = idx.long()[w_peer != 0] // n
            depth = h.shape[0] // n
            s = self.stats.setdefault(launched[0], {
                "calls": 0, "older_cells": 0, "reply": 0, "max_abs_err": 0.0})
            s["calls"] += 1
            s["older_cells"] += int(bool((cells != self.r % depth).any()))
            s["reply"] += int(self.phase == "reply")
            if not err <= s["max_abs_err"]:
                s["max_abs_err"] = err
            if not err <= KERNEL_TOL:
                raise RuntimeError(f"{launched[0]}: {err} off its plain "
                                   f"version on the {self.phase} tables of "
                                   f"round {self.r}")
            return out
        return call


def check_same_accounting(torch, label, st_c, st_g, r_c, r_g) -> None:
    """The CPU run (``st_c``, ``r_c``) and the card run: equal per-round
    accounting, failures by cause, both boxes and ages."""
    for field in ("sent_per_round", "failed_per_round",
                  "mailbox_hwm_per_round", "compact_slots_per_round",
                  "wide_slots_per_round"):
        if not np.array_equal(getattr(r_c, field), getattr(r_g, field)):
            raise RuntimeError(f"{label}: card and CPU differ in {field}")
    for cause, v in r_c.failed_per_cause.items():
        if not np.array_equal(v, r_g.failed_per_cause[cause]):
            raise RuntimeError(f"{label}: card and CPU differ in {cause}")
    for box in ("mailbox", "reply_box"):
        for a, b in zip(getattr(st_c, box), getattr(st_g, box)):
            if not torch.equal(a, b.cpu()):
                raise RuntimeError(f"{label}: card and CPU {box} differ")
    if not torch.equal(st_c.model.n_updates, st_g.model.n_updates.cpu()):
        raise RuntimeError(f"{label}: card and CPU ages differ")


def ns_card_vs_cpu(torch, merge, label: str, wire: str = "float32",
                   **kw) -> dict:
    """NS_CHECK_ROUNDS rounds of the north-star configuration (with
    ``kw``) on the CPU and on the card from the same seeds: equal
    accounting and boxes, params within REF_TOL (plus half a bf16 step of
    the value for a bf16 ring); on the card, every merge call held to its
    plain version (:class:`MergeAudit`). Returns the audit's stats and
    the card run's launches per kernel."""
    runs = {}
    for dev in ("cpu", "cuda"):
        sim, state = northstar_sim(torch, dev, seed=3, history_dtype=wire,
                                   **kw)
        merge.reset_launch_counts()
        audit = MergeAudit(torch, merge, sim)
        with audit if dev == "cuda" else contextlib.nullcontext():
            state, rep = sim.start(state, n_rounds=NS_CHECK_ROUNDS)
        runs[dev] = (state, rep, {k: v for k, v in merge.LAUNCHES.items()
                                  if v}, audit.stats)
    (st_c, r_c, l_c, _), (st_g, r_g, l_g, stats) = runs["cpu"], runs["cuda"]
    check_same_accounting(torch, label, st_c, st_g, r_c, r_g)
    p_c, p_g = st_c.model.params, st_g.model.params.cpu()
    tol = REF_TOL + ring_step(torch, sim, st_c, wire)
    diff = (p_c - p_g).abs()
    worst = float((diff - tol).max())
    causes = {c: int(v.sum()) for c, v in r_g.failed_per_cause.items()}
    log(f"[northstar] {label}: {NS_CHECK_ROUNDS} rounds, card vs CPU: sent "
        f"{int(r_g.sent_per_round.sum())}, failed {causes}, slots "
        f"{(r_g.compact_slots_per_round + r_g.wide_slots_per_round).tolist()}"
        f", max abs param diff {float(diff.max()):.3e}, worst margin to the "
        f"tolerance {worst:.3e} (<= 0 passes); final accuracy card "
        f"{r_g.final('accuracy')}, CPU {r_c.final('accuracy')}; launches "
        f"card {l_g}, CPU {l_c}; merge calls held to the plain versions "
        f"{stats}")
    if worst > 0 or l_c or not np.isfinite(r_g.final("accuracy")):
        raise RuntimeError(f"{label}: card run does not agree with the CPU "
                           "run")
    if bool(l_g) != bool(kw.get("fused_merge", False)):
        raise RuntimeError(f"{label}: launches {l_g} on the card; a fused "
                           "path launches its kernel, the plain one none")
    return {"stats": stats, "launches": l_g}


def ns_timed(torch, merge, label: str, fused) -> dict:
    """One leg of the north-star configuration timed as ``bench.py``
    times it: a warm-up, then BENCH_ROUNDS rounds from the same initial
    state and the same draws, the card synchronised before the host clock
    stops. Launch counts are set to 0 just before the timed rounds."""
    import copy

    from gossipy_tpu_torch.random import TorchDraws
    sim, state0 = northstar_sim(torch, "cuda", fused_merge=fused)
    warm, _ = sim.start(copy.deepcopy(state0), n_rounds=NS_WARMUP_ROUNDS)
    torch.cuda.synchronize()
    sim.draws = TorchDraws(42)
    state = copy.deepcopy(state0)
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=BENCH_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    compact, wide = rep.compact_slots_per_round, rep.wide_slots_per_round
    with_msgs = int(((compact + wide) > 0).sum())
    acc = rep.final("accuracy")
    if not torch.isfinite(state.model.params).all() or not np.isfinite(acc):
        raise RuntimeError(f"{label}: non-finite params or accuracy")
    want = {merge.KERNEL: with_msgs} if fused == "multi" else {}
    if launches != want or (fused == "multi" and with_msgs == 0):
        raise RuntimeError(f"{label}: launches {launches}, the path must "
                           f"make {want}")
    idle = profile(torch, lambda: sim._round(state),
                   f"north star {label}, one round with eval")
    log(f"[northstar] {label}: {BENCH_ROUNDS} rounds in {wall:.3f} s = "
        f"{BENCH_ROUNDS / wall:.2f} rounds/s ({wall / BENCH_ROUNDS * 1e3:.4f}"
        f" ms/round); sent {int(rep.sent_per_round.sum())}, failed "
        f"{int(rep.failed_per_round.sum())}, slots compact "
        f"{int(compact.sum())} wide {int(wide.sum())}; final global accuracy"
        f" {acc}; launches {launches}; idle share of one round {idle}")
    phase_times(torch, sim, state, f"north star {label}")
    return {"rounds_per_s": BENCH_ROUNDS / wall, "accuracy": acc,
            "launches": launches, "idle_share": idle,
            "curve": rep.curves(local=False)["accuracy"]}


def northstar_phase(torch, merge, rate) -> tuple:
    """Phase 7 (a)-(c); returns the launches per path of each (kernel,
    ring format), K1's numbers at the north star's shape and each timed
    leg's numbers (``ns_timed``) by label."""
    from gossipy_tpu_torch.core import AntiEntropyProtocol, UniformDelay
    paths = {}
    # (a) the two legs, card against CPU
    for label, fused in (("default", False), ("multi", "multi")):
        ns_card_vs_cpu(torch, merge, label, fused_merge=fused)
    # K1, K2 and K3 against their plain versions, timed, at the shapes the
    # north star gives them: 100 rows of LogReg's stride, the derived K
    # slots (one for K3), a two-cell ring.
    sim, _ = northstar_sim(torch, "cpu")
    layout = sim.handler.layout
    starts = [layout.offsets[leaf] for leaf, _ in layout.leaves]
    at_shape = check_multi(torch, merge, "north star", "float32", NS_NODES,
                           2, layout.stride, sim.K, 21, rate)
    check_multi(torch, merge, "north star", "bfloat16", NS_NODES, 2,
                layout.stride, sim.K, 22, rate, starts)
    check_flat(torch, merge, "float32", NS_NODES, 2, layout.stride, starts,
               23, rate)
    # (b) rounds per second of each leg
    legs = {}
    for label, fused in (("default", False), ("multi", "multi")):
        out = legs[label] = ns_timed(torch, merge, label, fused)
        for k, v in out["launches"].items():
            paths.setdefault((k, "float32"), {})[f"northstar-{label}"] = v
    # (c) the paper examples' network model
    net = dict(delay=UniformDelay(0, 10), drop_prob=0.1, online_prob=0.2,
               sampling_eval=0.1)
    push_pull = AntiEntropyProtocol.PUSH_PULL
    cases = (("danner-multi-bf16", "bfloat16", dict(fused_merge="multi")),
             ("danner-push_pull-multi", "float32",
              dict(fused_merge="multi", protocol=push_pull)),
             ("danner-push_pull-per_slot", "float32",
              dict(fused_merge="per_slot", protocol=push_pull)),
             ("danner-async-multi", "float32",
              dict(fused_merge="multi", sync=False)))
    need = {"danner-multi-bf16": (merge.KERNEL_MULTI_DQ, "older_cells"),
            "danner-push_pull-multi": (merge.KERNEL, "reply"),
            "danner-push_pull-per_slot": (merge.KERNEL_FLAT, "reply"),
            "danner-async-multi": (merge.KERNEL, "older_cells")}
    for label, wire, kw in cases:
        out = ns_card_vs_cpu(torch, merge, label, wire=wire, **net, **kw)
        kernel, what = need[label]
        s = out["stats"].get(kernel, {})
        if not s.get(what) or not out["launches"].get(kernel):
            raise RuntimeError(f"{label}: {kernel} never ran on {what} "
                               f"tables ({out['stats']})")
        for k, v in out["launches"].items():
            paths.setdefault((k, wire), {})[label] = v
    return paths, at_shape, legs


def flagship_run(torch, merge, flag, stacked, n, bf16, wire, device,
                 rounds, audit=False):
    """The flagship's multi path from its twin's functions, on ``device``
    with ``TorchDraws(42)`` and initial weights seeded with 42, ``rounds``
    rounds after ``init_nodes``; on the card with ``audit``, every merge
    call held to its plain version (:class:`MergeAudit`). Returns the
    simulator, the state, the report, the launches per kernel and the
    audit's stats."""
    sim = flag.flagship_sim(stacked, n, bf16, "multi", wire, device=device)
    state = sim.init_nodes(torch.Generator().manual_seed(42),
                           common_init=True)
    merge.reset_launch_counts()
    check = MergeAudit(torch, merge, sim) if audit \
        else contextlib.nullcontext()
    with check:
        state, rep = sim.start(state, n_rounds=rounds)
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    return sim, state, rep, launches, (check.stats if audit else None)


def ring_step(torch, sim, state, wire):
    """One encoding step of the ring per param (half a bf16 step of the
    value, half an int8 quantum of the leaf), 0 for an fp32 ring."""
    p = state.model.params
    if wire == "bfloat16":
        return 2.0 ** -8 * p.abs()
    if wire == "int8":
        quantum = 0.5 * state.history_scale.amax(dim=(0, 1))
        return quantum[sim._col_leaf.cpu()].expand_as(p)
    return torch.zeros_like(p)


def flagship_card_vs_cpu(torch, merge, flag, sets) -> dict:
    """Phase 8 (a): FLAG_CHECK_ROUNDS rounds of the flagship at
    FLAG_CHECK_NODES nodes and FLAG_CHECK_SUBSAMPLE images on the CPU and
    on the card from the same seeds, fp32 compute with an fp32 ring, then
    bf16 compute with fp32, bf16 and int8 rings. Accounting and both boxes
    equal; every K1 and K2 call of the card runs bit-equal to its plain
    version on the same tables; the params by the rule of PERF.md §2,
    against ``effect``, what bf16 compute moves the CPU's fp32 run:

    - fp32: the median element within REF_TOL, the largest within the
      largest effect (a ReLU or max-pool decision near a tie may go the
      other way on the card: a whole gradient term on one node, which
      the later steps and merges carry on; an fp32 run may not stray
      further than bf16 compute moves it);
    - bf16: the largest and the median element within twice the effect's
      (two bf16 runs are each a perturbation of the fp32 run), plus one
      encoding step of a bf16 or int8 ring; and the card's bf16 run moves
      at least half the median effect away from the fp32 run.

    Returns the launches per (kernel, ring) of the card runs."""
    stacked = flag.flagship_data(FLAG_CHECK_NODES, FLAG_CHECK_SUBSAMPLE,
                                 sets=sets)
    cases = (("fp32", False, "float32"), ("bf16", True, "float32"),
             ("bf16-ring-bf16", True, "bfloat16"),
             ("bf16-ring-int8", True, "int8"))
    runs = {}
    for label, bf16, wire in cases:
        t0 = time.perf_counter()
        cpu = flagship_run(torch, merge, flag, stacked, FLAG_CHECK_NODES,
                           bf16, wire, "cpu", FLAG_CHECK_ROUNDS)
        t1 = time.perf_counter()
        card = flagship_run(torch, merge, flag, stacked, FLAG_CHECK_NODES,
                            bf16, wire, "cuda", FLAG_CHECK_ROUNDS,
                            audit=True)
        runs[label] = (cpu, card, t1 - t0, time.perf_counter() - t1)
    p32 = runs["fp32"][0][1].model.params
    effect = (runs["bf16"][0][1].model.params - p32).abs()
    eff_max, eff_med = float(effect.max()), float(effect.median())
    paths = {}
    for label, bf16, wire in cases:
        (sim, st_c, r_c, l_c, _), (_, st_g, r_g, l_g, stats), t_c, t_g = \
            runs[label]
        check_same_accounting(torch, f"flagship {label}", st_c, st_g, r_c,
                              r_g)
        kernel = merge.KERNEL if wire == "float32" else merge.KERNEL_MULTI_DQ
        with_msgs = int(((r_g.compact_slots_per_round
                          + r_g.wide_slots_per_round) > 0).sum())
        calls = stats.get(kernel, {}).get("calls", 0)
        if l_c or l_g != {kernel: with_msgs} or calls != with_msgs \
                or with_msgs == 0:
            raise RuntimeError(f"flagship {label}: launches card {l_g}, CPU "
                               f"{l_c}, audited calls {stats}; the path "
                               f"makes {{{kernel}: {with_msgs}}}")
        p_c, p_g = st_c.model.params, st_g.model.params.cpu()
        diff = (p_c - p_g).abs()
        step = ring_step(torch, sim, st_c, wire)
        d_max, d_med = float(diff.max()), float(diff.median())
        if bf16:
            lim_max = 2 * eff_max + float(step.max())
            lim_med = 2 * eff_med + float(step.median())
            moved = float((p_g - p32).abs().median())
            ok = d_max <= lim_max and d_med <= lim_med \
                and moved >= 0.5 * eff_med
        else:
            lim_max, lim_med, moved = eff_max, REF_TOL, None
            ok = d_max <= lim_max and d_med <= lim_med
        finite = bool(torch.isfinite(p_g).all()) and \
            np.isfinite(r_g.final("accuracy"))
        log(f"[flagship] card vs CPU {label} (ring {wire}): "
            f"{FLAG_CHECK_NODES} nodes, {FLAG_CHECK_SUBSAMPLE} images, S = "
            f"{sim.data['mtr'].shape[1]}, {FLAG_CHECK_ROUNDS} rounds: sent "
            f"{int(r_g.sent_per_round.sum())}, slots "
            f"{r_g.wide_slots_per_round.tolist()}; params max abs diff "
            f"{d_max:.3e} (limit {lim_max:.3e}), median {d_med:.3e} (limit "
            f"{lim_med:.3e}); bf16 effect max {eff_max:.3e} median "
            f"{eff_med:.3e}; card bf16 run from CPU fp32, median {moved}; "
            f"accuracy card {r_g.final('accuracy')}, CPU "
            f"{r_c.final('accuracy')}; launches {l_g}; merge calls held "
            f"to the plain versions {stats}; CPU {t_c:.1f} s, card "
            f"{t_g:.1f} s")
        if not (ok and finite):
            raise RuntimeError(f"flagship {label}: the card run does not "
                               "agree with the CPU run")
        paths.setdefault((kernel, wire), {})[f"flagship-check-{label}"] = \
            l_g[kernel]
    return paths


def flagship_timed(torch, merge, flag, stacked, wire: str) -> dict:
    """Phase 8 (b), one ring leg: the full-width flagship (FLAG_NODES
    nodes, bf16 compute, multi), a warm-up round, then FLAG_ROUNDS timed
    rounds, the card synchronised before the host clock stops; launches
    (counts set to 0 just before the timed rounds), the final sampled
    accuracy, the memory budget and the peak allocation, one profiled
    round and the phase times."""
    kernel = merge.KERNEL if wire == "float32" else merge.KERNEL_MULTI_DQ
    label = f"multi-{wire}"
    sim = flag.flagship_sim(stacked, FLAG_NODES, True, "multi", wire,
                            device="cuda")
    torch.cuda.reset_peak_memory_stats()
    state = sim.init_nodes(torch.Generator().manual_seed(42),
                           common_init=True)
    state, _ = sim.start(state, n_rounds=1)     # warm-up round
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=FLAG_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    with_msgs = int(((rep.compact_slots_per_round
                      + rep.wide_slots_per_round) > 0).sum())
    if launches != {kernel: with_msgs} or with_msgs != FLAG_ROUNDS:
        raise RuntimeError(f"flagship {label}: launches {launches}, the "
                           f"path must make {{{kernel}: {with_msgs}}} in "
                           f"{FLAG_ROUNDS} rounds with messages")
    acc = rep.final("accuracy")
    stride = sim.handler.layout.stride
    if state.model.params.shape != (FLAG_NODES, stride) or not \
            torch.isfinite(state.model.params).all() or not np.isfinite(acc):
        raise RuntimeError(f"flagship {label}: output has the wrong shape "
                           "or is not finite")
    budget = sim.memory_budget()
    idle = profile(torch, lambda: sim._round(state),
                   f"flagship {label}, one round with eval")
    log(f"[flagship] {label}: {FLAG_NODES}-node CIFAR10Net (stride "
        f"{stride}), bf16 compute, S = {sim.data['mtr'].shape[1]}, K = "
        f"{sim.K}, {FLAG_ROUNDS} rounds in {wall:.3f} s = "
        f"{wall / FLAG_ROUNDS * 1e3:.3f} ms/round; sent "
        f"{int(rep.sent_per_round.sum())}, failed "
        f"{int(rep.failed_per_round.sum())}; final sampled accuracy {acc}; "
        f"launches {launches}; idle share of one round {idle}; memory "
        f"budget {budget['total_bytes']} B ({budget['total_bytes'] / 2**30:.3f}"
        f" GiB: data {budget['data_bytes']}, ring "
        f"{budget['history_ring_bytes']}, model and optimizer "
        f"{budget['model_and_opt_bytes']}, eval {budget['eval_peak_bytes']})"
        f"; peak allocated {peak} B ({peak / 2**30:.3f} GiB)")
    phase_times(torch, sim, state, f"flagship {label}")
    return {"ms_per_round": wall / FLAG_ROUNDS * 1e3, "accuracy": acc,
            "launches": launches, "idle_share": idle,
            "budget_bytes": budget["total_bytes"], "peak_bytes": peak}


def flagship_phase(torch, merge, rate) -> tuple:
    """Phase 8: (a) the card against the CPU at a reduced size, K1 and K2
    at the flagship's shape, (b) the three timed ring legs at full width.
    Returns the launches per (kernel, ring) and path, K1's and K2's
    numbers at the flagship shape and the bf16 ring leg's ms/round
    (phase 11 runs that leg again)."""
    from gossipy_tpu_torch.data import get_CIFAR10, to_device
    from gossipy_tpu_torch.examples import main_cifar10_100nodes as flag

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the synthetic stand-in's note
        sets = get_CIFAR10()
    log(f"[flagship] CIFAR-10 stand-in, 50,000 + 10,000 images, made in "
        f"{time.perf_counter() - t0:.1f} s")
    paths = flagship_card_vs_cpu(torch, merge, flag, sets)
    t0 = time.perf_counter()
    stacked = to_device(flag.flagship_data(FLAG_NODES, sets=sets), "cuda")
    del sets
    log(f"[flagship] {FLAG_NODES} Dirichlet(0.5) shards padded to "
        f"{stacked['mtr'].shape[1]} rows and on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    # K1 and K2 at the flagship's shape: 100 rows of CIFAR10Net's stride,
    # the derived K, the two-cell ring.
    probe = flag.flagship_sim(stacked, FLAG_NODES, True, "multi",
                              device="cuda")
    layout = probe.handler.layout
    starts = [layout.offsets[leaf] for leaf, _ in layout.leaves]
    at_shape = {("multi", wire): check_multi(
        torch, merge, "flagship", wire, FLAG_NODES, 2, layout.stride,
        probe.K, seed, rate, starts)
        for seed, wire in enumerate(FLAG_WIRES, start=31)}
    del probe
    legs = {}
    for wire in FLAG_WIRES:
        legs[wire] = flagship_timed(torch, merge, flag, stacked, wire)
        for k, v in legs[wire]["launches"].items():
            paths.setdefault((k, wire), {})[f"flagship-{wire}"] = v
        torch.cuda.empty_cache()
    return paths, at_shape, legs["bfloat16"]["ms_per_round"]


PAPERS = ("ormandi", "berta", "hegedus", "danner")
PAPER_CHECK_SIZE = {"ormandi": 64, "berta": 64, "hegedus": 64, "danner": 16}
PAPER_CHECK_ROUNDS = 8
# Timed rounds at full width: 50 of the reference's 100 for Ormandi, 25
# of Hegedus's 100, 50 of Berta's 500 and 150 of Danner's 1000 (each
# halved when phase 21 (k)-(m) needed the time).
PAPER_ROUNDS = {"ormandi": 50, "berta": 50, "hegedus": 25, "danner": 150}
PAPER_METRIC = {"ormandi": ("accuracy", False), "berta": ("nmi", False),
                "hegedus": ("rmse", True), "danner": ("accuracy", False)}


def paper_sets():
    """The data the four paper examples read, made once: the normalised
    spambase stand-in and the ml-100k stand-in's ratings."""
    from gossipy_tpu_torch.data import (load_classification_dataset,
                                        load_recsys_dataset)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the stand-ins' notes
        return {"spambase": load_classification_dataset("spambase"),
                "ml-100k": load_recsys_dataset("ml-100k")}


def paper_sim(torch, name: str, sets: dict, size: int, device,
              seed: int = 42):
    """Example ``name``'s simulator, built by its twin's own functions on
    ``device`` with ``TorchDraws(seed)``, at ``size`` nodes (users for
    Hegedus; 0 = the example's full width), and its ``init_nodes`` state
    under a generator seeded with ``seed``."""
    from gossipy_tpu_torch.examples import main_berta_2014 as berta
    from gossipy_tpu_torch.examples import main_danner_2023 as danner
    from gossipy_tpu_torch.examples import main_hegedus_2020 as hegedus
    from gossipy_tpu_torch.examples import main_ormandi_2013 as ormandi
    if name == "ormandi":
        stacked, dim = ormandi.ormandi_data(size, seed, sets["spambase"])
        sim = ormandi.ormandi_sim(stacked, dim, seed=seed, device=device)
    elif name == "berta":
        stacked, dim = berta.berta_data(size, sets["spambase"])
        sim = berta.berta_sim(stacked, dim, seed, device=device)
    elif name == "hegedus":
        stacked, n_items = hegedus.hegedus_data(seed=seed, users=size,
                                                sets=sets["ml-100k"])
        sim = hegedus.hegedus_sim(stacked, n_items, seed, device=device)
    else:
        stacked, dim = danner.danner_data(size or 100, seed,
                                          sets["spambase"])
        sim = danner.danner_sim(stacked, dim, seed, device=device)
    state = sim.init_nodes(torch.Generator().manual_seed(seed))
    return sim, state


def rounds_with_messages(rep) -> int:
    return int(((rep.compact_slots_per_round
                 + rep.wide_slots_per_round) > 0).sum())


def paper_card_vs_cpu(torch, merge, name: str, sets: dict) -> dict:
    """Phase 9 (a), one example: PAPER_CHECK_ROUNDS rounds at
    PAPER_CHECK_SIZE nodes on the CPU and on the card from the same
    seeds. Accounting, both boxes and ages equal; params within REF_TOL
    plus REF_TOL of their magnitude (Pegasos's weights reach hundreds);
    Ormandi launches K1 once a round with messages on the card, every
    call bit-equal to its plain version (``MergeAudit``); the three
    others take the plain path and launch nothing. Returns the card run's
    launches."""
    runs = {}
    for dev in ("cpu", "cuda"):
        sim, state = paper_sim(torch, name, sets, PAPER_CHECK_SIZE[name],
                               dev, seed=3)
        merge.reset_launch_counts()
        audit = MergeAudit(torch, merge, sim)
        t0 = time.perf_counter()
        with audit if dev == "cuda" else contextlib.nullcontext():
            state, rep = sim.start(state, n_rounds=PAPER_CHECK_ROUNDS)
        runs[dev] = (sim, state, rep, {k: v for k, v in
                                       merge.LAUNCHES.items() if v},
                     audit.stats, time.perf_counter() - t0)
    (sim, st_c, r_c, l_c, _, t_c), (_, st_g, r_g, l_g, stats, t_g) = \
        runs["cpu"], runs["cuda"]
    label = f"papers {name}"
    check_same_accounting(torch, label, st_c, st_g, r_c, r_g)
    p_c, p_g = st_c.model.params, st_g.model.params.cpu()
    diff = (p_c - p_g).abs()
    worst = float((diff - REF_TOL * (1.0 + p_c.abs())).max())
    metric, local = PAPER_METRIC[name]
    m_c, m_g = r_c.final(metric, local), r_g.final(metric, local)
    with_msgs = rounds_with_messages(r_g)
    want = {merge.KERNEL: with_msgs} if sim.fused_merge == "multi" else {}
    calls = stats.get(merge.KERNEL, {}).get("calls", 0)
    log(f"[papers] {name} card vs CPU: {sim.n_nodes} nodes, S = "
        f"{sim.data['mtr'].shape[1]}, K = {sim.K}, deliver "
        f"{sim.fused_merge or 'plain'}, {PAPER_CHECK_ROUNDS} rounds: sent "
        f"{int(r_g.sent_per_round.sum())}, failed "
        f"{ {c: int(v.sum()) for c, v in r_g.failed_per_cause.items()} }, "
        f"slots compact {int(r_g.compact_slots_per_round.sum())} wide "
        f"{int(r_g.wide_slots_per_round.sum())}; max abs param diff "
        f"{float(diff.max()):.3e} (largest param {float(p_c.abs().max()):.3e}"
        f"), worst margin to the tolerance {worst:.3e} (<= 0 passes); final "
        f"{metric} card {m_g}, CPU {m_c}; launches card {l_g}, CPU {l_c}; "
        f"merge calls held to the plain versions {stats}; CPU {t_c:.1f} s, "
        f"card {t_g:.1f} s")
    if worst > 0 or not np.isfinite(m_g) or not \
            torch.isfinite(st_g.model.params).all():
        raise RuntimeError(f"{label}: the card run does not agree with the "
                           "CPU run")
    if l_c or l_g != want or (want and (with_msgs == 0
                                        or calls != with_msgs)):
        raise RuntimeError(f"{label}: launches card {l_g}, CPU {l_c}, "
                           f"audited calls {calls}; the path makes {want}")
    return l_g


def paper_timed(torch, merge, name: str, sets: dict) -> dict:
    """Phase 9 (b), one example at full width on the card: a warm-up
    round, then PAPER_ROUNDS timed rounds (every round's sampled eval
    included), the card synchronised before the host clock stops; the
    final metric, the launches (counts set to 0 just before the timed
    rounds; Ormandi's K1 once a round with messages), the memory budget
    beside the peak allocation, one profiled round's idle share and the
    phase times."""
    rounds = PAPER_ROUNDS[name]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim, state = paper_sim(torch, name, sets, 0, "cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    state, _ = sim.start(state, n_rounds=1)     # warm-up round
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    with_msgs = rounds_with_messages(rep)
    want = {merge.KERNEL: with_msgs} if sim.fused_merge == "multi" else {}
    metric, local = PAPER_METRIC[name]
    final = rep.final(metric, local)
    if launches != want or (want and with_msgs == 0):
        raise RuntimeError(f"papers {name}: launches {launches}, the path "
                           f"must make {want}")
    if not torch.isfinite(state.model.params).all() or \
            not np.isfinite(final):
        raise RuntimeError(f"papers {name}: non-finite params or {metric}")
    budget = sim.memory_budget()
    idle = profile(torch, lambda: sim._round(state),
                   f"papers {name}, one round with eval")
    log(f"[papers] {name}: {sim.n_nodes} nodes (stride "
        f"{sim.handler.layout.stride}, S = {sim.data['mtr'].shape[1]}, K = "
        f"{sim.K}, D = {state.history_ages.shape[0]}), deliver "
        f"{sim.fused_merge or 'plain'}, {rounds} rounds in {wall:.3f} s = "
        f"{wall / rounds * 1e3:.3f} ms/round (set-up {setup:.1f} s); sent "
        f"{int(rep.sent_per_round.sum())}, failed "
        f"{int(rep.failed_per_round.sum())}, slots compact "
        f"{int(rep.compact_slots_per_round.sum())} wide "
        f"{int(rep.wide_slots_per_round.sum())}; final "
        f"{'local' if local else 'global'} {metric} {final}; launches "
        f"{launches} for {with_msgs} rounds with messages; idle share of one "
        f"round {idle}; memory budget {budget['total_bytes']} B ("
        f"{budget['total_bytes'] / 2**20:.1f} MiB: data "
        f"{budget['data_bytes']}, ring {budget['history_ring_bytes']}, model "
        f"{budget['model_and_opt_bytes']}); peak allocated {peak} B ("
        f"{peak / 2**20:.1f} MiB)")
    phase_times(torch, sim, state, f"papers {name}")
    return {"ms_per_round": wall / rounds * 1e3, metric: final,
            "launches": launches, "idle_share": idle,
            "budget_bytes": budget["total_bytes"], "peak_bytes": peak}


def papers_phase(torch, merge, rate) -> tuple:
    """Phase 9: the four paper examples. (a) each on the card against the
    CPU at a cut size; K1 against its plain version, timed, at the
    Ormandi shape; (b) each timed at full width. Returns the launches per
    (kernel, ring) and run, and K1's numbers at the Ormandi shape."""
    t0 = time.perf_counter()
    sets = paper_sets()
    log(f"[papers] spambase and ml-100k stand-ins made in "
        f"{time.perf_counter() - t0:.1f} s")
    paths = {}
    for name in PAPERS:
        launched = paper_card_vs_cpu(torch, merge, name, sets)
        for k, v in launched.items():
            paths.setdefault((k, "float32"), {})[f"{name}-check"] = v
    # K1 at the Ormandi shape: 4,141 rows of AdaLine(57)'s 60-column
    # stride, the derived K, the ring's D cells.
    probe, state = paper_sim(torch, "ormandi", sets, 0, "cpu")
    depth = state.history_ages.shape[0]
    at_ormandi = check_multi(torch, merge, "Ormandi", "float32",
                             probe.n_nodes, depth,
                             probe.handler.layout.stride, probe.K, 41, rate)
    del probe, state
    for name in PAPERS:
        out = paper_timed(torch, merge, name, sets)
        for k, v in out["launches"].items():
            paths.setdefault((k, "float32"), {})[name] = v
        torch.cuda.empty_cache()
    return paths, at_ormandi


# -- phase 10: the variant simulators and the four examples they carry ------

# The configurations: (label, example, variant). Giaretta's three node
# behaviours, Hegedus 2021's two exchanges, All2All's two mixings,
# Onoszko's PENS, and the token-account simulator over the north star on
# the per-slot fused deliver with an fp32 ring (K3) and a bf16 ring (K4).
VARIANTS = (("giaretta-vanilla", "giaretta", "vanilla"),
            ("giaretta-passthrough", "giaretta", "passthrough"),
            ("giaretta-cacheneigh", "giaretta", "cacheneigh"),
            ("hegedus2021-partitioning", "hegedus2021", "partitioning"),
            ("hegedus2021-sampling", "hegedus2021", "sampling"),
            ("all2all-uniform", "all2all", "uniform"),
            ("all2all-metropolis", "all2all", "metropolis"),
            ("onoszko", "onoszko", None),
            ("tokenized-float32", "tokenized", "float32"),
            ("tokenized-bfloat16", "tokenized", "bfloat16"))
# Card-against-CPU sizes (nodes; Onoszko: 3 nodes and 96 images).
VARIANT_CHECK_SIZE = {"giaretta": 64, "hegedus2021": 32, "all2all": 32,
                      "onoszko": 3, "tokenized": NS_NODES}
VARIANT_CHECK_ROUNDS = 8
ONOSZKO_CHECK = dict(subsample=96, step1_rounds=3, rounds=5)
# Timed rounds at full width: 25 of Giaretta's and All2All's reference
# 100, 25 of Hegedus 2021's 1000, 25 of the tokenized north star's (each
# 100 until phase 21's checkpoint, recorder and host telemetry legs
# needed the time, 50 until its (k)-(m) did). Onoszko's
# window is cut to ONOSZKO_STEP1 phase-1 rounds (of 100): 3 local epochs
# at batch 8 make 3,750 steps an update pass. Its phase-2 rounds (~20 s
# each at full width) are left to the card-against-CPU run at 3 nodes
# (ONOSZKO_CHECK: 2 of them), which paid for phase 17. Under seed 42 the
# first phase-1 merge falls in round 2 (the message flow does not depend
# on the weights: a host run with the updates stubbed out finds it); the
# timed run fails if it holds none, or if the params moved on other
# nodes than those that merged.
# Its profile covers ONOSZKO_PROFILE_ROWS samples of each shard (30
# local steps), not a round of ~7,500 steps and ~2 million kernels.
VARIANT_ROUNDS = {"giaretta": 25, "hegedus2021": 25, "all2all": 25,
                  "tokenized": 25}
ONOSZKO_STEP1 = 3
ONOSZKO_ROUNDS = ONOSZKO_STEP1
ONOSZKO_PROFILE_ROWS = 80


def variant_sets() -> dict:
    """The spambase stand-in and the CIFAR-10 stand-in, made once."""
    from gossipy_tpu_torch.data import get_CIFAR10, \
        load_classification_dataset
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the stand-ins' notes
        return {"spambase": load_classification_dataset("spambase"),
                "cifar10": get_CIFAR10()}


def variant_sim(torch, label: str, sets: dict, full: bool, device,
                seed: int = 42, bf16: bool = False):
    """Configuration ``label`` of VARIANTS built by its twin's functions
    (the tokenized north star by ``northstar_sim``'s recipe) on
    ``device`` with ``TorchDraws(seed)``, at full width or at
    VARIANT_CHECK_SIZE, and its ``init_nodes`` state under a generator
    seeded with ``seed``. The checks run the token accounts as
    ``RandomizedTokenAccount(C=2, A=1)`` (Hegedus 2021) and
    ``SimpleTokenAccount(C=1)`` (north star), under which nodes send from
    the first rounds; the full-width Hegedus 2021 keeps the example's
    ``RandomizedTokenAccount(C=20, A=10)``."""
    from gossipy_tpu_torch.examples import main_all2all as all2all
    from gossipy_tpu_torch.examples import main_giaretta_2019 as giaretta
    from gossipy_tpu_torch.examples import main_hegedus_2021 as hegedus
    from gossipy_tpu_torch.examples import main_onoszko_2021 as onoszko
    from gossipy_tpu_torch.flow_control import RandomizedTokenAccount, \
        SimpleTokenAccount
    from gossipy_tpu_torch.random import TorchDraws
    _, example, variant = next(v for v in VARIANTS if v[0] == label)
    size = 0 if full else VARIANT_CHECK_SIZE[example]
    draws = TorchDraws(seed)
    if example == "giaretta":
        stacked, dim = giaretta.giaretta_data(size, seed, sets["spambase"])
        sim = giaretta.giaretta_sim(stacked, dim, variant, seed, draws,
                                    device)
    elif example == "hegedus2021":
        stacked, dim = hegedus.hegedus2021_data(size or 100, seed,
                                                sets["spambase"])
        account = None if full else RandomizedTokenAccount(C=2, A=1)
        sim = hegedus.hegedus2021_sim(stacked, dim, variant, seed, draws,
                                      device, token_account=account)
    elif example == "all2all":
        stacked, dim = all2all.all2all_data(size or 100, seed,
                                            sets["spambase"])
        sim = all2all.all2all_sim(stacked, dim, variant, seed, draws, device)
    elif example == "onoszko":
        sub = 0 if full else ONOSZKO_CHECK["subsample"]
        step1 = ONOSZKO_STEP1 if full else ONOSZKO_CHECK["step1_rounds"]
        stacked = onoszko.onoszko_data(size or 5, sub, sets["cifar10"])
        sim = onoszko.onoszko_sim(stacked, step1, seed, draws, device,
                                  bf16=bf16)
    else:
        return tokenized_northstar(torch, device, seed, variant)
    # Onoszko's timed window at full width starts without the pre-training
    # pass (an update pass, ~22 s, outside the window; its first merge
    # falls in round 2 whatever the weights): paid for phase 16. The cut
    # checks pre-train as the example does.
    state = sim.init_nodes(torch.Generator().manual_seed(seed),
                           local_train=not (full and example == "onoszko"))
    return sim, state


def tokenized_northstar(torch, device, seed: int, wire: str):
    """The north-star configuration (``northstar_sim``) on the token
    simulator, ``SimpleTokenAccount(C=1)``, the per-slot fused deliver,
    ring ``wire``."""
    from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
        Topology
    from gossipy_tpu_torch.data import ClassificationDataHandler, \
        DataDispatcher, load_classification_dataset
    from gossipy_tpu_torch.flow_control import SimpleTokenAccount
    from gossipy_tpu_torch.handlers import SGDHandler, losses
    from gossipy_tpu_torch.models import LogisticRegression
    from gossipy_tpu_torch.random import TorchDraws
    from gossipy_tpu_torch.simulation import TokenizedGossipSimulator
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the offline stand-in's note
        X, y = load_classification_dataset("spambase")
    dh = ClassificationDataHandler(X, y, test_size=0.2, seed=42)
    stacked = DataDispatcher(dh, n=NS_NODES, eval_on_user=False).stacked()
    d = X.shape[1]
    handler = SGDHandler(LogisticRegression(d, 2), losses.cross_entropy,
                         learning_rate=0.1, local_epochs=1, batch_size=32,
                         n_classes=2, input_shape=(d,),
                         create_model_mode=CreateModelMode.MERGE_UPDATE)
    sim = TokenizedGossipSimulator(
        handler, Topology.random_regular(NS_NODES, NS_DEGREE, seed=42,
                                         backend="networkx"),
        stacked, token_account=SimpleTokenAccount(C=1), delta=100,
        protocol=AntiEntropyProtocol.PUSH, fused_merge="per_slot",
        history_dtype=wire, draws=TorchDraws(seed), device=device)
    state = sim.init_nodes(torch.Generator().manual_seed(seed))
    return sim, state


def variant_want(merge, sim, rep) -> dict:
    """The launches a run of ``sim`` must make: the single-pass deliver
    one K1 a round with messages, the per-slot one a K3 (fp32 ring) or a
    K4 (bf16, int8) per occupied slot, every other path none."""
    slots = rep.compact_slots_per_round + rep.wide_slots_per_round
    if sim.fused_merge == "multi":
        return {merge.KERNEL: int((slots > 0).sum())}
    if sim.fused_merge == "per_slot":
        kernel = merge.KERNEL_FLAT if sim.history_dtype == "float32" \
            else merge.KERNEL_FLAT_DQ
        return {kernel: int(slots.sum())}
    return {}


def check_same_aux(torch, label, st_c, st_g, tol) -> None:
    """Equal ``aux``: integers and masks exactly, floats (infinities in
    the same places) within ``tol`` plus ``tol`` of the value; a parked
    model in a bf16 or int8 wire format within one encoding step."""
    if sorted(st_c.aux) != sorted(st_g.aux):
        raise RuntimeError(f"{label}: card and CPU aux differ in keys")
    for k, a in st_c.aux.items():
        b = st_g.aux[k].cpu()
        if a.dtype in (torch.bfloat16, torch.int8):
            # One step of the wire format (an int8 code, a bf16 ulp).
            a, b = a.to(torch.float32), b.to(torch.float32)
            ok = ((a - b).abs() <= 1.0 + 2.0 ** -7 * a.abs()).all()
        elif a.is_floating_point():
            same_inf = torch.equal(torch.isinf(a), torch.isinf(b))
            fin = torch.isfinite(a)
            ok = same_inf and bool(((a - b).abs()[fin]
                                    <= tol * (1.0 + a.abs()[fin])).all())
        else:
            ok = torch.equal(a, b)
        if not ok:
            raise RuntimeError(f"{label}: card and CPU aux[{k!r}] differ")


def variant_run(torch, merge, label, sets, device, rounds, audit, seed=3,
                bf16=False):
    """``rounds`` rounds of ``label`` at its check size from the same
    seeds, counts set to 0 just before; on the card with ``audit``, every
    merge call held to its plain version (:class:`MergeAudit`)."""
    sim, state = variant_sim(torch, label, sets, False, device, seed, bf16)
    merge.reset_launch_counts()
    check = MergeAudit(torch, merge, sim) if audit \
        else contextlib.nullcontext()
    t0 = time.perf_counter()
    with check:
        state, rep = sim.start(state, n_rounds=rounds)
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    return (sim, state, rep, launches, check.stats if audit else None,
            time.perf_counter() - t0)


def variant_card_vs_cpu(torch, merge, label: str, sets: dict) -> dict:
    """Phase 10 (a), one configuration at its check size on the CPU and
    on the card from the same seeds: accounting, both boxes, ages and
    ``aux`` equal; params within REF_TOL plus REF_TOL of their magnitude
    (plus one encoding step of a bf16 ring); Onoszko's CIFAR10Net by the
    decision-flip rule of PERF.md §2 (the median element within REF_TOL,
    the largest within what bf16 compute moves the CPU's run); the
    launches the path makes (:func:`variant_want`), every merge call
    bit-equal to its plain version. Returns the card run's launches."""
    rounds = (ONOSZKO_CHECK["rounds"] if label == "onoszko"
              else VARIANT_CHECK_ROUNDS)
    sim, st_c, r_c, l_c, _, t_c = variant_run(torch, merge, label, sets,
                                              "cpu", rounds, False)
    _, st_g, r_g, l_g, stats, t_g = variant_run(torch, merge, label, sets,
                                                "cuda", rounds, True)
    tag = f"variants {label}"
    check_same_accounting(torch, tag, st_c, st_g, r_c, r_g)
    check_same_aux(torch, tag, st_c, st_g, REF_TOL)
    if not torch.equal(st_c.history_ages, st_g.history_ages.cpu()):
        raise RuntimeError(f"{tag}: card and CPU ring ages differ")
    p_c, p_g = st_c.model.params, st_g.model.params.cpu()
    diff = (p_c - p_g).abs()
    if label == "onoszko":
        bf = variant_run(torch, merge, label, sets, "cpu", rounds, False,
                         bf16=True)[1].model.params
        effect = float((bf - p_c).abs().max())
        rule = (f"median {float(diff.median()):.3e} (limit {REF_TOL}), max "
                f"{float(diff.max()):.3e} (limit: bf16's effect {effect:.3e})")
        ok = float(diff.median()) <= REF_TOL and float(diff.max()) <= effect
    else:
        tol = REF_TOL * (1.0 + p_c.abs()) + ring_step(torch, sim, st_c,
                                                      sim.history_dtype)
        worst = float((diff - tol).max())
        rule = (f"max abs diff {float(diff.max()):.3e} (largest param "
                f"{float(p_c.abs().max()):.3e}), worst margin {worst:.3e} "
                "(<= 0 passes)")
        ok = worst <= 0
    metric = "accuracy"
    m_c, m_g = r_c.final(metric), r_g.final(metric)
    want = variant_want(merge, sim, r_g)
    calls = {k: s["calls"] for k, s in (stats or {}).items()}
    log(f"[variants] {label} card vs CPU: {sim.n_nodes} nodes, "
        f"{type(sim).__name__}, K = {sim.K}, deliver "
        f"{sim.fused_merge or 'plain'}, ring {sim.history_dtype}, {rounds} "
        f"rounds: sent {int(r_g.sent_per_round.sum())}, failed "
        f"{ {c: int(v.sum()) for c, v in r_g.failed_per_cause.items()} }, "
        f"slots compact {int(r_g.compact_slots_per_round.sum())} wide "
        f"{int(r_g.wide_slots_per_round.sum())}; params {rule}; final "
        f"{metric} card {m_g}, CPU {m_c}; launches card {l_g}, CPU {l_c}; "
        f"merge calls held to the plain versions {stats}; CPU {t_c:.1f} s, "
        f"card {t_g:.1f} s")
    if not ok or not np.isfinite(m_g) or not torch.isfinite(p_g).all():
        raise RuntimeError(f"{tag}: the card run does not agree with the "
                           "CPU run")
    if l_c or l_g != want or calls != want or (want and not
                                                sum(want.values())):
        raise RuntimeError(f"{tag}: launches card {l_g}, CPU {l_c}, "
                           f"audited calls {calls}; the path makes {want}")
    if int(r_g.sent_per_round.sum()) == 0:
        raise RuntimeError(f"{tag}: no message was sent")
    return l_g


def onoszko_steps(torch, sim, state):
    """A local update of every node over the first ONOSZKO_PROFILE_ROWS
    samples of its shard (3 epochs of 10 steps), as a function, and its
    step count: Onoszko's round is these steps, 3,750 an update pass."""
    h = sim.handler
    data = tuple(d[:, :ONOSZKO_PROFILE_ROWS] for d in sim._local_data())
    perms = sim.draws.update_permutations(
        state.round, [0], torch.zeros(sim.n_nodes, dtype=torch.int64,
                                      device=sim.device),
        h.local_epochs, ONOSZKO_PROFILE_ROWS)
    steps = h.local_epochs * -(-ONOSZKO_PROFILE_ROWS // h.batch_size)
    return (lambda: h.update(state.model, data, perms)), steps


def variant_timed(torch, merge, label: str, sets: dict) -> dict:
    """Phase 10 (b), one configuration at full width on the card: a
    warm-up round, then the timed rounds (every round's sampled eval
    included), the card synchronised before the host clock stops; the
    final metric, the launches (counts set to 0 just before the timed
    rounds), the memory budget beside the peak allocation, one profiled
    round's idle share and the phase times. Onoszko's window runs from
    round 0 (its first phase is what is timed) and must hold a phase-1
    merge that moved exactly the params of the nodes that merged; its ms
    per local step is printed."""
    example = next(v[1] for v in VARIANTS if v[0] == label)
    onoszko = example == "onoszko"
    rounds = ONOSZKO_ROUNDS if onoszko else VARIANT_ROUNDS[example]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim, state = variant_sim(torch, label, sets, True, "cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    if not onoszko:
        state, _ = sim.start(state, n_rounds=1)     # warm-up round
    p0 = state.model.params.clone() if onoszko else None
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    want = variant_want(merge, sim, rep)
    metric = "accuracy"
    final = rep.final(metric)
    if launches != want or (want and not sum(want.values())):
        raise RuntimeError(f"variants {label}: launches {launches}, the "
                           f"path must make {want}")
    if not torch.isfinite(state.model.params).all() or \
            not np.isfinite(final) or rep.sent_messages == 0:
        raise RuntimeError(f"variants {label}: non-finite params or "
                           f"{metric}, or no message sent")
    extra = ""
    if onoszko:
        merged = int(state.aux["neigh_counter"].sum())
        moved = (state.model.params != p0).any(dim=1)
        merged_nodes = state.aux["neigh_counter"].sum(dim=-1) > 0
        if merged == 0 or not torch.equal(moved, merged_nodes):
            raise RuntimeError(
                "variants onoszko: the timed window holds no phase-1 merge, "
                f"or params moved on nodes {moved.nonzero().flatten()} "
                f"against merged {merged_nodes.nonzero().flatten()}")
        steps_fn, steps = onoszko_steps(torch, sim, state)
        steps_fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        steps_fn()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) * 1e3 / steps
        extra = (f"; phase-1 merged models {merged} (params moved on nodes "
                 f"{moved.nonzero().flatten().tolist()}, those that "
                 f"merged), best neighbours "
                 f"{int(state.aux['best'].sum())}; {step_ms:.4f} ms per "
                 f"local step of the 5 nodes ({steps} steps timed): "
                 f"{step_ms * 3750 / 1e3:.2f} s an update pass")
    budget = sim.memory_budget()
    if onoszko:
        idle = profile(torch, steps_fn, f"variants {label}, {steps} local "
                       "steps")
    else:
        idle = profile(torch, lambda: sim._round(state),
                       f"variants {label}, one round with eval")
    log(f"[variants] {label}: {sim.n_nodes} nodes, {type(sim).__name__} "
        f"(stride {sim.handler.layout.stride}, S = "
        f"{sim.data['mtr'].shape[1]}, K = {sim.K}, D = "
        f"{state.history_ages.shape[0]}), deliver "
        f"{sim.fused_merge or 'plain'}, ring {sim.history_dtype}, {rounds} "
        f"rounds in {wall:.3f} s = {wall / rounds * 1e3:.3f} ms/round "
        f"(set-up {setup:.1f} s); sent {int(rep.sent_per_round.sum())}, "
        f"failed {int(rep.failed_per_round.sum())}, slots compact "
        f"{int(rep.compact_slots_per_round.sum())} wide "
        f"{int(rep.wide_slots_per_round.sum())}; final sampled {metric} "
        f"{final}; launches {launches}; idle share of "
        f"{'the profiled steps' if onoszko else 'one round'} {idle}; "
        f"memory budget {budget['total_bytes']} B "
        f"({budget['total_bytes'] / 2**20:.1f} MiB: aux "
        f"{budget['aux_bytes']}, data {budget['data_bytes']}, ring "
        f"{budget['history_ring_bytes']}, model "
        f"{budget['model_and_opt_bytes']}); peak allocated {peak} B "
        f"({peak / 2**20:.1f} MiB){extra}")
    if example != "all2all" and not onoszko:
        phase_times(torch, sim, state, f"variants {label}")
    return {"ms_per_round": wall / rounds * 1e3, metric: final,
            "launches": launches, "idle_share": idle,
            "budget_bytes": budget["total_bytes"], "peak_bytes": peak}


def variants_phase(torch, merge, rate) -> tuple:
    """Phase 10: (a) each configuration on the card against the CPU at
    its check size; K1 against its plain version, timed, at Giaretta's
    shape, K3 and K4 (bf16, int8) at the token north star's; (b) each timed at
    full width. Returns the launches per (kernel, ring) and run, and the
    kernels' numbers at those shapes."""
    t0 = time.perf_counter()
    sets = variant_sets()
    log(f"[variants] spambase and CIFAR-10 stand-ins made in "
        f"{time.perf_counter() - t0:.1f} s")
    paths = {}
    for label, _, _ in VARIANTS:
        for k, v in variant_card_vs_cpu(torch, merge, label, sets).items():
            wire = "bfloat16" if label.endswith("bfloat16") else "float32"
            paths.setdefault((k, wire), {})[f"{label}-check"] = v
    # K1 at Giaretta's shape: 4,141 rows of AdaLine(57)'s 60-column
    # stride, the derived K of the hubs' fan-in, the ring's cells; K3 and
    # K4 at the token north star's: 100 rows of LogReg's 116, one slot.
    probe, state = variant_sim(torch, "giaretta-vanilla", sets, True, "cpu")
    shapes = {"giaretta": check_multi(
        torch, merge, "Giaretta", "float32", probe.n_nodes,
        state.history_ages.shape[0], probe.handler.layout.stride, probe.K,
        51, rate)}
    probe, state = variant_sim(torch, "tokenized-float32", sets, True, "cpu")
    layout = probe.handler.layout
    starts = [layout.offsets[leaf] for leaf, _ in layout.leaves]
    for seed, wire in enumerate(("float32", "bfloat16", "int8"), start=52):
        shapes[("tokenized", wire)] = check_flat(
            torch, merge, wire, probe.n_nodes, state.history_ages.shape[0],
            layout.stride, starts, seed, rate, "token north star")
    del probe, state
    for label, _, _ in VARIANTS:
        out = variant_timed(torch, merge, label, sets)
        for k, v in out["launches"].items():
            wire = "bfloat16" if label.endswith("bfloat16") else "float32"
            paths.setdefault((k, wire), {})[label] = v
        torch.cuda.empty_cache()
    return paths, shapes


# -- phase 11: events, probes, sentinels and chaos ---------------------------

TEL_CHECK_ROUNDS = 12       # the card-against-CPU runs
TEL_FLAG_CHECK_ROUNDS = 6
TEL_FLAG_CHECK_NODES = 16
TEL_FLAG_CHECK_SUBSAMPLE = 256
TEL_A2A_CHECK_NODES = 32
TEL_NAN_CLEAN = 2           # clean rounds before the NaN is written
TEL_NAN_ROUNDS = 3          # rounds after it
TEL_NAN_AT = (7, 0)         # (node, column) the NaN is written to
TEL_BENCH_ROUNDS = 100      # the interleaved legs' shares sit inside the
                            # host's noise at 300 as at 150; 150 paid for
                            # phase 16, 100 for phase 21 (k)-(m)


def telemetry_kw(nodes: int, rounds: int) -> dict:
    """``ProbeConfig(True)``, ``SentinelConfig(True)`` and the examples'
    ``--chaos`` scenario (``demo_chaos_config``: a half/half partition
    over the middle third of ``rounds``) as simulator arguments, and the
    heal round."""
    import argparse

    from gossipy_tpu_torch.examples._common import demo_chaos_config
    from gossipy_tpu_torch.telemetry import ProbeConfig, SentinelConfig
    args = argparse.Namespace(chaos=True, nodes=nodes, rounds=rounds)
    chaos = demo_chaos_config(args)
    return dict(probes=ProbeConfig(), sentinels=SentinelConfig(),
                chaos=chaos), args._chaos_heal


def rounded(arr):
    """A per-round array as a list for the log (6 decimals), or None."""
    return None if arr is None else np.round(np.asarray(arr, np.float64),
                                             6).tolist()


def telemetry_fields(rep) -> list:
    """The report's probe, health and chaos arrays that the run filled."""
    from gossipy_tpu_torch.simulation.report import PER_ROUND_FIELDS
    return [f for f in PER_ROUND_FIELDS
            if f.startswith(("probe_", "health_", "chaos_"))
            and getattr(rep, f) is not None]


def check_same_telemetry(label, r_c, r_g, extra=None) -> float:
    """The CPU run's and the card run's probe, health and chaos arrays:
    the same set filled; integer arrays (staleness histograms, accepted
    counts, non-finite counts, first bad slot, divergence flags, trip,
    watermarks, component counts) equal; float arrays within REF_TOL plus
    REF_TOL of their magnitude, plus ``extra[field]`` (the decision-flip
    rule's allowance), NaN where the other is NaN. Returns the worst
    margin to the tolerance (<= 0)."""
    fields = telemetry_fields(r_c)
    if fields != telemetry_fields(r_g) or not fields:
        raise RuntimeError(f"{label}: telemetry arrays differ: CPU {fields}, "
                           f"card {telemetry_fields(r_g)}")
    worst = -np.inf
    for f in fields:
        a, b = np.asarray(getattr(r_c, f)), np.asarray(getattr(r_g, f))
        if a.shape != b.shape:
            raise RuntimeError(f"{label}: {f} shapes {a.shape}, {b.shape}")
        if a.dtype.kind in "iub":
            if not np.array_equal(a, b):
                raise RuntimeError(f"{label}: card and CPU differ in {f}")
            continue
        tol = REF_TOL + REF_TOL * np.abs(a)
        if extra is not None:
            tol = tol + extra[f]
        both_nan = np.isnan(a) & np.isnan(b)
        margin = np.where(both_nan, -np.inf, np.abs(a - b) - tol)
        if np.isnan(margin).any() or float(margin.max()) > 0:
            raise RuntimeError(f"{label}: card and CPU differ in {f}: "
                               f"{a.tolist()} vs {b.tolist()}")
        worst = max(worst, float(margin.max()))
    return worst


def telemetry_run(torch, merge, build, device, rounds, nan_at=None):
    """``rounds`` rounds of ``build(device)``'s simulator; on the card
    every merge call held to its plain version (:class:`MergeAudit`).
    With ``nan_at = (clean, node, column)``, a NaN is written into that
    param after ``clean`` rounds and the run goes on in a second
    ``start()``. Returns the simulator, the state, the report (the two
    segments concatenated), the launches and the audit's stats."""
    from gossipy_tpu_torch.simulation import SimulationReport
    sim, state = build(device)
    merge.reset_launch_counts()
    audit = MergeAudit(torch, merge, sim)
    with audit if device == "cuda" else contextlib.nullcontext():
        if nan_at is None:
            state, rep = sim.start(state, n_rounds=rounds)
        else:
            clean, node, col = nan_at
            state, first = sim.start(state, n_rounds=clean)
            state.model.params[node, col] = float("nan")
            state, rest = sim.start(state, n_rounds=rounds - clean)
            rep = SimulationReport.concatenate([first, rest])
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    return sim, state, rep, launches, audit.stats


def telemetry_card_vs_cpu(torch, merge, label, build, rounds, kernel,
                          nan_at=None, extra_build=None) -> dict:
    """One configuration with probes, sentinels and chaos on the CPU and
    on the card from the same seeds: accounting (``failed_chaos``
    included), boxes and ages equal; params within REF_TOL plus REF_TOL
    of their magnitude, or, where ``extra_build`` gives the same run
    with bf16 compute, by the decision-flip rule for an fp32 run (PERF.md
    §2: the largest element within the largest of what bf16 compute
    moves the CPU's run, the median within REF_TOL, each plus one ring
    step; each telemetry float array within REF_TOL plus REF_TOL of its
    magnitude plus the most bf16 compute moves it in any round on the
    CPU);
    the telemetry arrays by :func:`check_same_telemetry`; ``kernel``
    launched once a round with
    messages on the card, none on the CPU, every call bit-equal to its
    plain version. Returns the card run's report and launches."""
    t0 = time.perf_counter()
    sim, st_c, r_c, l_c, _ = telemetry_run(torch, merge, build, "cpu",
                                           rounds, nan_at)
    t1 = time.perf_counter()
    _, st_g, r_g, l_g, stats = telemetry_run(torch, merge, build, "cuda",
                                             rounds, nan_at)
    t2 = time.perf_counter()
    check_same_accounting(torch, label, st_c, st_g, r_c, r_g)
    p_c, p_g = st_c.model.params, st_g.model.params.cpu()
    diff = (p_c - p_g).abs()
    if nan_at is not None:
        same_nan = torch.equal(torch.isnan(p_c), torch.isnan(p_g))
        diff = torch.where(torch.isnan(p_c) & torch.isnan(p_g), 0.0, diff)
        if not same_nan:
            raise RuntimeError(f"{label}: card and CPU NaN params differ")
    extra, rule = None, "REF_TOL plus REF_TOL of the magnitude"
    if extra_build is None:
        over = float((diff - REF_TOL
                      - REF_TOL * p_c.abs().nan_to_num(0.0)).max())
    else:
        # The decision-flip rule: against what bf16 compute
        # (``extra_build``) moves the CPU's fp32 run.
        _, st_e, r_e, _, _ = telemetry_run(torch, merge, extra_build, "cpu",
                                           rounds)
        effect = (p_c - st_e.model.params).abs()
        step = ring_step(torch, sim, st_c, sim.history_dtype)
        lim_max = float(effect.max()) + float(step.max())
        lim_med = REF_TOL + float(step.median())
        extra = {f: float(np.nanmax(np.abs(
            np.asarray(getattr(r_e, f), np.float64)
            - np.asarray(getattr(r_c, f), np.float64))))
            for f in telemetry_fields(r_c)}
        over = max(float(diff.max()) - lim_max,
                   float(diff.median()) - lim_med)
        rule = (f"decision-flip rule: largest {float(diff.max()):.3e} "
                f"(limit {lim_max:.3e}), median {float(diff.median()):.3e} "
                f"(limit {lim_med:.3e})")
    ok = over <= 0
    worst = check_same_telemetry(label, r_c, r_g, extra)
    with_msgs = int(((r_g.compact_slots_per_round
                      + r_g.wide_slots_per_round) > 0).sum())
    calls = stats.get(kernel, {}).get("calls", 0)
    if l_c or l_g != {kernel: with_msgs} or calls != with_msgs \
            or with_msgs == 0:
        raise RuntimeError(f"{label}: launches card {l_g}, CPU {l_c}, "
                           f"audited {stats}; the path makes "
                           f"{{{kernel}: {with_msgs}}}")
    causes = {c: int(v.sum()) for c, v in r_g.failed_per_cause.items()}
    log(f"[telemetry] {label}: {rounds} rounds, card vs CPU: sent "
        f"{int(r_g.sent_per_round.sum())}, failed {causes}; params max abs "
        f"diff {float(diff.max()):.3e} ({rule}; worst margin {over:.3e}); "
        f"telemetry arrays {len(telemetry_fields(r_g))}, worst float margin "
        f"{worst:.3e} (<= 0 passes); trips {rounded(r_g.health_trip)}, "
        f"first bad slot {rounded(r_g.health_first_bad_slot)}; gap "
        f"{rounded(r_g.chaos_component_gap)}; launches "
        f"{l_g}; merge calls held to the plain versions {stats}; CPU "
        f"{t1 - t0:.1f} s, card {t2 - t1:.1f} s")
    if not ok:
        raise RuntimeError(f"{label}: card params do not agree with the "
                           "CPU's")
    return {"report": r_g, "launches": l_g}


def telemetry_timed(torch, merge, legs, rounds, kernel,
                    warmup: int = 1) -> dict:
    """Timed legs, ``legs`` a list of ``(label, build, heal)``: each leg
    ``warmup`` rounds on its own simulator, then ``rounds`` rounds on a
    fresh one from the same seeds, in two halves (two ``start()`` calls,
    the round counter and the carry going on): the legs in order, then in
    reverse, so that a drift of the host's speed falls on each leg alike;
    the card synchronised before the host clock stops each half. Each
    leg: the kernel once a round with messages (counts set to 0 just
    before each half), no call of K1's or K3's plain version (a telemetry
    hook may not stand in for the kernel), finite params, no sentinel
    trip; with ``heal``, the partition's gap peak and
    ``rounds_to_reconverge``. Returns, per label, ms/round, rounds/s and
    the launches."""
    from gossipy_tpu_torch.simulation import SimulationReport, \
        rounds_to_reconverge
    for _, build, _ in legs:
        sim, state = build("cuda")
        sim.start(state, n_rounds=warmup)
        torch.cuda.synchronize()
        del sim, state
    runs = {label: list(build("cuda")) + [0.0, {}, []]
            for label, build, _ in legs}
    plain_calls = []
    saved = merge.gather_merge_multi_reference, merge.gather_merge_reference

    def count(fn):
        def call(*a, **kw):
            plain_calls.append(fn.__name__)
            return fn(*a, **kw)
        return call
    merge.gather_merge_multi_reference = count(saved[0])
    merge.gather_merge_reference = count(saved[1])
    order = [label for label, _, _ in legs]
    try:
        for half, n in ((order, rounds // 2),
                        (order[::-1], rounds - rounds // 2)):
            for label in half:
                run = runs[label]
                merge.reset_launch_counts()
                t0 = time.perf_counter()
                run[1], rep = run[0].start(run[1], n_rounds=n)
                torch.cuda.synchronize()
                run[2] += time.perf_counter() - t0
                for k, v in merge.LAUNCHES.items():
                    if v:
                        run[3][k] = run[3].get(k, 0) + v
                run[4].append(rep)
    finally:
        merge.gather_merge_multi_reference, merge.gather_merge_reference = \
            saved
    out = {}
    for label, _, heal in legs:
        _, state, wall, launches, reps = runs[label]
        rep = SimulationReport.concatenate(reps)
        with_msgs = int(((rep.compact_slots_per_round
                          + rep.wide_slots_per_round) > 0).sum())
        acc = rep.final("accuracy")
        if launches != {kernel: with_msgs} or with_msgs == 0 or plain_calls:
            raise RuntimeError(f"{label}: launches {launches}, plain calls "
                               f"{plain_calls}; the path makes "
                               f"{{{kernel}: {with_msgs}}} and no plain call")
        if not torch.isfinite(state.model.params).all() or \
                not np.isfinite(acc):
            raise RuntimeError(f"{label}: non-finite params or accuracy")
        extra = ""
        if rep.health_trip is not None:
            extra += f"; trips {int(rep.health_trip.sum())}"
            if rep.health_trip.sum():
                raise RuntimeError(f"{label}: a sentinel tripped on a clean "
                                   "run")
        if rep.probe_consensus_mean is not None:
            extra += (f"; consensus first "
                      f"{float(rep.probe_consensus_mean[0]):.6f} last "
                      f"{float(rep.probe_consensus_mean[-1]):.6f}")
        out[label] = {"ms_per_round": wall / rounds * 1e3,
                      "rounds_per_s": rounds / wall, "launches": launches,
                      "accuracy": acc, "with_msgs": with_msgs}
        if heal is not None:
            gap = rep.chaos_component_gap
            r2r = rounds_to_reconverge(gap, heal)
            out[label].update(gap_peak=float(np.nanmax(gap)),
                              rounds_to_reconverge=r2r)
            extra += (f"; failed_chaos "
                      f"{int(rep.failed_per_cause['chaos'].sum())}, gap peak "
                      f"{float(np.nanmax(gap)):.6f}, last {float(gap[-1]):.6f}"
                      f", rounds_to_reconverge after the heal at round "
                      f"{heal}: {r2r}")
        log(f"[telemetry] {label}: {rounds} rounds in {wall:.3f} s = "
            f"{rounds / wall:.2f} rounds/s ({wall / rounds * 1e3:.4f} "
            f"ms/round); final accuracy {acc}; launches {launches} in "
            f"{with_msgs} rounds with messages; plain calls 0{extra}")
    return out


def telemetry_phase(torch, merge, flag_ms) -> dict:
    """Phase 11: (a) the north star (K1), the flagship at 16 nodes on a
    bf16 ring (K2, fp32 compute) and All2All at 32 nodes, with probes,
    sentinels and the demo chaos, on the card against the CPU; the north
    star with a NaN written mid-run; (b) the north star's three legs of
    TEL_BENCH_ROUNDS rounds (telemetry off, probes and sentinels, and the
    chaos added) and the full-width flagship on its bf16 ring with all
    three on. Returns the launches per (kernel, ring) and path."""
    from gossipy_tpu_torch.examples import main_all2all as all2all
    from gossipy_tpu_torch.examples import main_cifar10_100nodes as flag
    from gossipy_tpu_torch.random import TorchDraws
    paths = {}
    k1, k2 = merge.KERNEL, merge.KERNEL_MULTI_DQ

    # (a) the card against the CPU
    kw, _ = telemetry_kw(NS_NODES, TEL_CHECK_ROUNDS)

    def ns(device):
        return northstar_sim(torch, device, seed=3, fused_merge="multi",
                             **kw)
    out = telemetry_card_vs_cpu(torch, merge, "north star multi", ns,
                                TEL_CHECK_ROUNDS, k1)
    paths.setdefault((k1, "float32"), {})["telemetry-ns-check"] = \
        out["launches"][k1]
    # The NaN: written into node 7's first column after 2 clean rounds;
    # both trip in the third round, naming the same slot and leaf.
    nan_kw = dict(kw, chaos=None)

    def ns_nan(device):
        return northstar_sim(torch, device, seed=3, fused_merge="multi",
                             **nan_kw)
    out = telemetry_card_vs_cpu(
        torch, merge, "north star multi, NaN before round 3", ns_nan,
        TEL_NAN_CLEAN + TEL_NAN_ROUNDS, k1,
        nan_at=(TEL_NAN_CLEAN,) + TEL_NAN_AT)
    rep = out["report"]
    trip_round = int(np.argmax(rep.health_trip > 0))
    if rep.health_trip[:TEL_NAN_CLEAN].any() or trip_round != TEL_NAN_CLEAN \
            or rep.health_nonfinite_params[TEL_NAN_CLEAN, 0] < 1:
        raise RuntimeError(f"NaN run: trips {rep.health_trip.tolist()}, "
                           "the sentinel must trip in round 3")
    log(f"[telemetry] NaN run: tripped in round {trip_round + 1}, first bad "
        f"slot {int(rep.health_first_bad_slot[trip_round])}, non-finite "
        f"params per leaf {rep.health_nonfinite_params[trip_round].tolist()}"
        f", the same on the card and the CPU")

    from gossipy_tpu_torch.data import get_CIFAR10, to_device
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the synthetic stand-in's note
        sets = get_CIFAR10()
    fstack = flag.flagship_data(TEL_FLAG_CHECK_NODES,
                                TEL_FLAG_CHECK_SUBSAMPLE, sets=sets)
    flag_stacked = to_device(flag.flagship_data(FLAG_NODES, sets=sets),
                             "cuda")
    del sets
    fkw, _ = telemetry_kw(TEL_FLAG_CHECK_NODES, TEL_FLAG_CHECK_ROUNDS)

    def flagship(bf16):
        def build(device):
            sim = flag.flagship_sim(fstack, TEL_FLAG_CHECK_NODES, bf16,
                                    "multi", "bfloat16", device=device,
                                    **fkw)
            return sim, sim.init_nodes(torch.Generator().manual_seed(42),
                                       common_init=True)
        return build
    out = telemetry_card_vs_cpu(
        torch, merge, f"flagship {TEL_FLAG_CHECK_NODES} nodes, bf16 ring",
        flagship(False), TEL_FLAG_CHECK_ROUNDS, k2,
        extra_build=flagship(True))
    paths.setdefault((k2, "bfloat16"), {})["telemetry-flagship-check"] = \
        out["launches"][k2]

    akw, _ = telemetry_kw(TEL_A2A_CHECK_NODES, TEL_CHECK_ROUNDS)
    astack, dim = all2all.all2all_data(TEL_A2A_CHECK_NODES, 3)

    def a2a(device):
        sim = all2all.all2all_sim(astack, dim, "uniform", 3, TorchDraws(3),
                                  device, **akw)
        return sim, sim.init_nodes(torch.Generator().manual_seed(3))
    t0 = time.perf_counter()
    runs = [telemetry_run(torch, merge, a2a, dev, TEL_CHECK_ROUNDS)
            for dev in ("cpu", "cuda")]
    (_, st_c, r_c, l_c, _), (_, st_g, r_g, l_g, _) = runs
    check_same_accounting(torch, "all2all", st_c, st_g, r_c, r_g)
    worst = check_same_telemetry("all2all", r_c, r_g)
    diff = (st_c.model.params - st_g.model.params.cpu()).abs()
    if float((diff - REF_TOL - REF_TOL * st_c.model.params.abs()).max()) > 0 \
            or l_c or l_g:
        raise RuntimeError(f"all2all: params differ by {float(diff.max())} "
                           f"or launches {l_c}, {l_g}")
    log(f"[telemetry] all2all {TEL_A2A_CHECK_NODES} nodes: "
        f"{TEL_CHECK_ROUNDS} rounds, card vs CPU: failed "
        f"{ {c: int(v.sum()) for c, v in r_g.failed_per_cause.items()} }, "
        f"mixing non-finite {int(r_g.health_mix_nonfinite.sum())}, params max "
        f"abs diff {float(diff.max()):.3e}, worst float margin {worst:.3e}; "
        f"gap {rounded(r_g.chaos_component_gap)}; "
        f"{time.perf_counter() - t0:.1f} s")

    # (b) full width: the north star's three legs, interleaved
    legs = []
    for leg, on, chaos in (("off", False, False),
                           ("probes+sentinels", True, False),
                           ("probes+sentinels+chaos", True, True)):
        tkw, heal = telemetry_kw(NS_NODES, TEL_BENCH_ROUNDS)
        if not chaos:
            tkw["chaos"], heal = None, None
        if not on:
            tkw = {}

        def build(device, tkw=tkw):
            return northstar_sim(torch, device, fused_merge="multi", **tkw)
        legs.append((f"north star multi, {leg}", build, heal))
    timed = telemetry_timed(torch, merge, legs, TEL_BENCH_ROUNDS, k1,
                            warmup=NS_WARMUP_ROUNDS)
    base = timed[legs[0][0]]["rounds_per_s"]
    for label, v in timed.items():
        leg = label.split(", ")[-1]
        paths.setdefault((k1, "float32"), {})[f"telemetry-ns-{leg}"] = \
            v["launches"][k1]
    log("[telemetry] north star rounds/s: " + ", ".join(
        f"{label.split(', ')[-1]} {v['rounds_per_s']:.2f} "
        f"({v['rounds_per_s'] / base:.3f} of off)"
        for label, v in timed.items()))
    fkw, heal = telemetry_kw(FLAG_NODES, FLAG_ROUNDS)

    def flag_full(device):
        sim = flag.flagship_sim(flag_stacked, FLAG_NODES, True, "multi",
                                "bfloat16", device=device, **fkw)
        return sim, sim.init_nodes(torch.Generator().manual_seed(42),
                                   common_init=True)
    label = (f"flagship {FLAG_NODES} nodes, bf16 ring, "
             "probes+sentinels+chaos")
    out = telemetry_timed(torch, merge, [(label, flag_full, heal)],
                          FLAG_ROUNDS, k2)[label]
    if out["with_msgs"] != FLAG_ROUNDS:
        raise RuntimeError("flagship: a round without messages")
    paths.setdefault((k2, "bfloat16"), {})["telemetry-flagship"] = \
        out["launches"][k2]
    log(f"[telemetry] flagship bf16 ring: {out['ms_per_round']:.3f} ms/round "
        f"with probes, sentinels and chaos, {flag_ms:.3f} without (phase 8)")
    del flag_stacked
    torch.cuda.empty_cache()
    return paths


# -- phase 12: sparse topologies at population scale ------------------------

SCALE_NODES = 50_000        # bench.py --scale, --scale-all2all
SCALE_ROUNDS = 100          # bench.py --scale's rounds
SCALE_A2A_ROUNDS = 50       # bench.py --scale-all2all's rounds
LADDER_NODES = 100_000      # scripts/scale_ladder.py's last rung
LADDER_ROUNDS = 20
SPARSE_CHECK_NODES = 512
SPARSE_CHECK_ROUNDS = 8
# The card-against-CPU runs of phase 12 (a): (label, configuration, the
# deliver path or the All2All form).
SPARSE_CHECKS = (("vanilla-multi", "vanilla", "multi"),
                 ("chaos-multi", "chaos", "multi"),
                 ("cacheneigh", "cacheneigh", None),
                 ("all2all-segment", "all2all", "segment"),
                 ("all2all-padded", "all2all", "padded"))


def sparse_check_sim(torch, kind: str, form, device, seed: int = 3):
    """Phase 12 (a): the scale twin's configuration
    (``gossipy_tpu_torch/examples/scale.py``) at SPARSE_CHECK_NODES nodes
    of ``SparseTopology.random_regular(n, 20, seed=42)``, on ``device``
    with ``TorchDraws(seed)``, and its ``init_nodes`` state: the vanilla
    row on deliver ``form``; the same under a partition of the first
    third of the nodes and churn (the slot form of the sparse chaos
    draw); the neighbour cache (async, plain path); All2All in ``form``
    with 10% drops and 80% online."""
    from gossipy_tpu_torch.core import SparseTopology
    from gossipy_tpu_torch.examples import scale
    from gossipy_tpu_torch.random import TorchDraws
    from gossipy_tpu_torch.simulation import CacheNeighGossipSimulator
    from gossipy_tpu_torch.simulation.faults import ChaosConfig, \
        ChurnProcess, PartitionEpisode
    n, rounds = SPARSE_CHECK_NODES, SPARSE_CHECK_ROUNDS
    topo = SparseTopology.random_regular(n, scale.DEGREE, seed=42)
    draws = TorchDraws(seed)
    if kind == "all2all":
        sim = scale.build_all2all(n, rounds, topo, draws=draws,
                                  device=device, sparse_mix_form=form,
                                  drop_prob=0.1, online_prob=0.8)
    elif kind == "cacheneigh":
        sim = CacheNeighGossipSimulator(
            scale.scale_handler(), topo, scale.scale_data(n),
            delta=scale.ROUND_LEN, sync=False, sampling_eval=0.1,
            draws=draws, device=device)
    else:
        kw = {}
        if kind == "chaos":
            kw["chaos"] = ChaosConfig(
                partitions=(PartitionEpisode(
                    components=(tuple(range(n // 3)),), start=1, stop=5),),
                churn=ChurnProcess(keep_frac=0.5, start=3, stop=7,
                                   period=2, seed=1))
        sim = scale.build_vanilla(n, rounds, topo, draws=draws,
                                  device=device, fused_merge=form,
                                  drop_prob=0.1, **kw)
    state = sim.init_nodes(torch.Generator().manual_seed(seed))
    return sim, state


def sparse_card_vs_cpu(torch, merge, label: str, kind: str, form) -> dict:
    """Phase 12 (a), one configuration on the CPU and on the card from
    the same seeds: accounting, both boxes, ages and ``aux`` equal,
    params within REF_TOL plus REF_TOL of their magnitude (the segment
    form's ``index_add_`` sums with atomics on the card, in another
    order), K1 once a round with messages on the single-pass deliver and
    every call bit-equal to its plain version (``MergeAudit``). Returns
    the card run's launches."""
    runs = []
    for device in ("cpu", "cuda"):
        sim, state = sparse_check_sim(torch, kind, form, device)
        merge.reset_launch_counts()
        audit = MergeAudit(torch, merge, sim) if device == "cuda" \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with audit:
            state, rep = sim.start(state, n_rounds=SPARSE_CHECK_ROUNDS)
        launches = {k: v for k, v in merge.LAUNCHES.items() if v}
        runs.append((sim, state, rep, launches,
                     audit.stats if device == "cuda" else None,
                     time.perf_counter() - t0))
    (sim, st_c, r_c, l_c, _, t_c), (_, st_g, r_g, l_g, stats, t_g) = runs
    tag = f"sparse {label}"
    check_same_accounting(torch, tag, st_c, st_g, r_c, r_g)
    check_same_aux(torch, tag, st_c, st_g, REF_TOL)
    p_c, p_g = st_c.model.params, st_g.model.params.cpu()
    diff = (p_c - p_g).abs()
    worst = float((diff - REF_TOL * (1.0 + p_c.abs())).max())
    want = variant_want(merge, sim, r_g)
    calls = {k: s["calls"] for k, s in (stats or {}).items()}
    errs = {k: s["max_abs_err"] for k, s in (stats or {}).items()}
    m_c, m_g = r_c.final("accuracy"), r_g.final("accuracy")
    failed = {c: int(v.sum()) for c, v in r_g.failed_per_cause.items()}
    log(f"[sparse] {label} card vs CPU: {sim.n_nodes} nodes, "
        f"{type(sim).__name__}, deliver {sim.fused_merge or 'plain'}"
        f"{', form ' + form if kind == 'all2all' else ''}, K = {sim.K}, "
        f"{SPARSE_CHECK_ROUNDS} rounds: sent {int(r_g.sent_per_round.sum())}"
        f", failed {failed}"
        f"; params max abs diff {float(diff.max()):.3e}, worst margin "
        f"{worst:.3e} (<= 0 passes); final accuracy card {m_g}, CPU {m_c}; "
        f"launches card {l_g}, CPU {l_c}; merge calls held to the plain "
        f"version {calls}, max abs err {errs}; CPU {t_c:.1f} s, card "
        f"{t_g:.1f} s")
    if worst > 0 or not torch.isfinite(p_g).all() or not np.isfinite(m_g):
        raise RuntimeError(f"{tag}: the card run does not agree with the "
                           "CPU run")
    if l_c or l_g != want or calls != want or any(errs.values()) or \
            (sim.fused_merge == "multi" and not sum(want.values())):
        raise RuntimeError(f"{tag}: launches card {l_g}, CPU {l_c}, "
                           f"audited calls {calls} (errors {errs}); the "
                           f"path makes {want}")
    if int(r_g.sent_per_round.sum()) == 0:
        raise RuntimeError(f"{tag}: no message was sent")
    return l_g


def scale_timed(torch, merge, n: int, rounds: int, all2all: bool = False,
                form: str = "auto", phases: bool = True) -> dict:
    """Phase 12 (b), one scale row at ``n`` nodes on the card, built as
    ``examples/scale.py`` builds it: the topology's build time, a
    warm-up round, then ``rounds`` timed rounds (the last one evaluates),
    the card synchronised before the host clock stops; rounds/s, the
    final accuracy, the launches against the rounds with messages
    (counts set to 0 just before), ``memory_budget()`` beside
    ``max_memory_allocated``, one profiled round's idle share and the
    phase times."""
    from gossipy_tpu_torch.core import SparseTopology
    from gossipy_tpu_torch.examples import scale
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    topo = SparseTopology.random_regular(n, scale.DEGREE, seed=42)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if all2all:
        sim = scale.build_all2all(n, rounds + 1, topo, device="cuda",
                                  sparse_mix_form=form)
    else:
        sim = scale.build_vanilla(n, rounds + 1, topo, device="cuda")
    state = sim.init_nodes(torch.Generator().manual_seed(42))
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    state, _ = sim.start(state, n_rounds=1)     # warm-up round
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    want = variant_want(merge, sim, rep)
    with_msgs = int(((rep.compact_slots_per_round
                      + rep.wide_slots_per_round) > 0).sum())
    acc = rep.final("accuracy")
    if launches != want or (not all2all and (sim.fused_merge != "multi"
                                             or want[merge.KERNEL]
                                             != with_msgs
                                             or with_msgs == 0)):
        raise RuntimeError(f"scale {n}: launches {launches}, the path must "
                           f"make {want} ({with_msgs} rounds with "
                           "messages)")
    if not torch.isfinite(state.model.params).all() or \
            not np.isfinite(acc) or rep.sent_messages == 0:
        raise RuntimeError(f"scale {n}: non-finite params or accuracy, or "
                           "no message sent")
    budget = sim.memory_budget()
    row = (f"all2all {sim.n_nodes} nodes, form "
           f"{'padded' if sim._sparse_padded else 'segment'}" if all2all
           else f"vanilla {sim.n_nodes} nodes")
    idle = profile(torch, lambda: sim._round(state), f"scale {row}, one "
                   "round without eval")
    log(f"[sparse] scale {row}: degree {scale.DEGREE}, K = {sim.K}, D = "
        f"{state.history_ages.shape[0]}, deliver "
        f"{sim.fused_merge or 'plain'}, stride "
        f"{sim.handler.layout.stride}: topology built in {build_s:.3f} s, "
        f"simulator and init_nodes {setup:.1f} s; {rounds} rounds in "
        f"{wall:.3f} s = {rounds / wall:.2f} rounds/s "
        f"({wall / rounds * 1e3:.3f} ms/round); sent {rep.sent_messages}, "
        f"failed {rep.failed_messages}; final global accuracy {acc}; "
        f"launches {launches} for {with_msgs} rounds with messages; idle "
        f"share of one round {idle}; memory budget {budget['total_bytes']} "
        f"B ({budget['total_bytes'] / 2**20:.1f} MiB), peak allocated "
        f"{peak} B ({peak / 2**20:.1f} MiB); a dense [N, N] float64 fan-in "
        f"would take {8 * n * n / 2**30:.1f} GiB on the host")
    if phases and not all2all:
        phase_times(torch, sim, state, f"scale vanilla {n}")
    out = {"rounds_per_s": rounds / wall, "accuracy": acc,
           "build_s": build_s, "launches": launches, "idle_share": idle,
           "budget_bytes": budget["total_bytes"], "peak_bytes": peak,
           "K": sim.K, "D": int(state.history_ages.shape[0]),
           "stride": sim.handler.layout.stride}
    del sim, state
    torch.cuda.empty_cache()
    return out


def sparse_phase(torch, merge, rate) -> tuple:
    """Phase 12: (a) the native generator's edge sets against the pinned
    digests, each SPARSE_CHECKS configuration on the card against the
    CPU; (b) the vanilla scale row at SCALE_NODES nodes, K1 timed at its
    shape, the LADDER_NODES rung, the All2All row in both sparse forms.
    Returns the launches per (kernel, ring) and run, and K1's numbers at
    the scale row's and the ladder rung's shapes."""
    from gossipy_tpu_torch import native
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("the native graph generators did not build")
    log(f"[sparse] native generators built (g++) in "
        f"{time.perf_counter() - t0:.1f} s: {native.library_path().name}")
    for (kind, args), want in NATIVE_DIGESTS.items():
        t0 = time.perf_counter()
        edges = getattr(native, f"{kind}_edges")(*args)
        got = edge_digest(edges)
        log(f"[sparse] native {kind}_edges{args}: {len(edges)} edges in "
            f"{time.perf_counter() - t0:.3f} s, sha256 {got[:16]}... "
            f"{'equal to' if got == want else 'DIFFERENT FROM'} the pinned "
            "digest")
        if got != want:
            raise RuntimeError(f"native {kind}{args}: edge set differs from "
                               "the JAX package's generator")
    paths = {}
    for label, kind, form in SPARSE_CHECKS:
        for k, v in sparse_card_vs_cpu(torch, merge, label, kind,
                                       form).items():
            paths.setdefault((k, "float32"), {})[f"sparse-{label}"] = v
    out = scale_timed(torch, merge, SCALE_NODES, SCALE_ROUNDS)
    paths.setdefault((merge.KERNEL, "float32"), {})[
        f"scale-{SCALE_NODES}"] = out["launches"][merge.KERNEL]
    # K1 at the scale row's shape: 50,000 rows of LogReg's stride, the
    # derived K, the ring's cells.
    at_scale = check_multi(torch, merge, "scale row", "float32",
                           SCALE_NODES, out["D"], out["stride"], out["K"],
                           61, rate)
    ladder = scale_timed(torch, merge, LADDER_NODES, LADDER_ROUNDS,
                         phases=False)
    paths[(merge.KERNEL, "float32")][f"scale-{LADDER_NODES}"] = \
        ladder["launches"][merge.KERNEL]
    at_ladder = check_multi(torch, merge, "ladder rung", "float32",
                            LADDER_NODES, ladder["D"], ladder["stride"],
                            ladder["K"], 62, rate)
    a2a = {form: scale_timed(torch, merge, SCALE_NODES, SCALE_A2A_ROUNDS,
                             all2all=True, form=form)
           for form in ("segment", "padded")}
    log(f"[sparse] rounds/s: vanilla {SCALE_NODES} "
        f"{out['rounds_per_s']:.2f}, vanilla {LADDER_NODES} "
        f"{ladder['rounds_per_s']:.2f}, all2all {SCALE_NODES} segment "
        f"{a2a['segment']['rounds_per_s']:.2f}, padded "
        f"{a2a['padded']['rounds_per_s']:.2f}")
    return paths, at_scale, at_ladder


# -- phase 13: the sequential high-fidelity engine ---------------------------

SEQ_CHECK_NODES = 16        # the card-against-CPU runs
SEQ_CHECK_ROUNDS = 6
# Phase 13 (a)'s configurations of the sequential engine.
SEQ_CHECKS = ("push-drop-online", "push_pull-delay", "async", "tokenized",
              "passthrough", "cache_neigh", "chaos")
SEQ_TARGET_S = 15.0         # the timed north-star run's aim (one round
SEQ_MAX_ROUNDS = 100        # measured first decides its rounds)


def message_log():
    """A receiver keeping every per-message event, ``(failed, t, round,
    sender, receiver, type, size)``."""
    from gossipy_tpu_torch.simulation import SimulationEventReceiver

    class MessageLog(SimulationEventReceiver):
        def __init__(self):
            self.events = []

        def update_single_message(self, failed, msg):
            self.events.append((bool(failed), msg.t, msg.round, msg.sender,
                                msg.receiver, int(msg.msg_type), msg.size))
    return MessageLog()


def seq_check_sim(torch, label: str, device):
    """Phase 13 (a)'s configuration ``label`` of the sequential engine at
    SEQ_CHECK_NODES nodes: the audit twin's data and handler
    (``examples/audit_fidelity.py``), its random regular graph (a
    Barabasi-Albert one for the two variants, whose degrees then
    differ), draws from ``TorchDraws(3)``, weights from a generator
    seeded with 3. Returns the simulator, its state and its message
    log."""
    from gossipy_tpu_torch.core import AntiEntropyProtocol, Topology, \
        UniformDelay
    from gossipy_tpu_torch.examples.audit_fidelity import DELTA, \
        audit_data, audit_handler
    from gossipy_tpu_torch.flow_control import RandomizedTokenAccount
    from gossipy_tpu_torch.random import TorchDraws
    from gossipy_tpu_torch.simulation import ChaosConfig, FaultSpike, \
        OutageEpisode, PartitionEpisode, SequentialGossipSimulator
    n, half = SEQ_CHECK_NODES, SEQ_CHECK_NODES // 2
    stacked, topo = audit_data(n, 7)
    delay = UniformDelay(0, 10)
    chaos = ChaosConfig(
        outages=(OutageEpisode(nodes=(0, 1, 2), start=1, stop=3),),
        partitions=(PartitionEpisode(components=(
            tuple(range(half)), tuple(range(half, n))), start=2, stop=4),),
        spikes=(FaultSpike(start=1, stop=3, drop_prob=0.3,
                           delay_scale=2.0),),
        horizon=SEQ_CHECK_ROUNDS)
    kw = {"push-drop-online": dict(drop_prob=0.2, online_prob=0.8),
          "push_pull-delay": dict(protocol=AntiEntropyProtocol.PUSH_PULL,
                                  delay=UniformDelay(0, 30)),
          "async": dict(sync=False, delay=delay),
          "tokenized": dict(token_account=RandomizedTokenAccount(C=4, A=2),
                            delay=delay),
          "passthrough": dict(variant="passthrough"),
          "cache_neigh": dict(variant="cache_neigh", delay=delay),
          "chaos": dict(chaos=chaos, probes=True, sentinels=True,
                        delay=delay)}[label]
    if label in ("passthrough", "cache_neigh"):
        topo = Topology.barabasi_albert(n, 2, seed=1, backend="networkx")
    sim = SequentialGossipSimulator(audit_handler(), topo, stacked,
                                    delta=DELTA, draws=TorchDraws(3),
                                    device=device, **kw)
    messages = message_log()
    sim.add_receiver(messages)
    return sim, sim.init_nodes(torch.Generator().manual_seed(3)), messages


def seq_card_vs_cpu(torch, merge, label: str) -> None:
    """SEQ_CHECK_ROUNDS rounds of configuration ``label`` on the CPU and
    on the card from the same seeds: the same message stream (every
    per-message event, in order), per-round accounting and causes, total
    size, token balances and ages; params within REF_TOL plus REF_TOL of
    their magnitude; the probe, health and chaos arrays as phase 11 holds
    them; the run's own feature seen (drops and offline receivers,
    replies, off-phase sends, same-tick reactions, chaos failures). The
    sequential path launches no kernel."""
    from gossipy_tpu_torch.core import MessageType
    runs = {}
    for dev in ("cpu", "cuda"):
        sim, state, messages = seq_check_sim(torch, label, dev)
        merge.reset_launch_counts()
        t0 = time.perf_counter()
        state, rep = sim.start(state, n_rounds=SEQ_CHECK_ROUNDS)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = (state, rep, messages.events,
                     {k: v for k, v in merge.LAUNCHES.items() if v},
                     time.perf_counter() - t0)
    (st_c, r_c, ev_c, _, s_c), (st_g, r_g, ev_g, l_g, s_g) = \
        runs["cpu"], runs["cuda"]
    if ev_c != ev_g:
        first = next(i for i, (a, b) in enumerate(zip(ev_c, ev_g)) if a != b) \
            if len(ev_c) == len(ev_g) else min(len(ev_c), len(ev_g))
        raise RuntimeError(f"sequential {label}: card and CPU message streams "
                           f"differ at event {first} ({len(ev_c)} and "
                           f"{len(ev_g)} events)")
    for field in ("sent_per_round", "failed_per_round"):
        if not np.array_equal(getattr(r_c, field), getattr(r_g, field)):
            raise RuntimeError(f"sequential {label}: card and CPU differ in "
                               f"{field}")
    for cause, v in r_c.failed_per_cause.items():
        if not np.array_equal(v, r_g.failed_per_cause[cause]):
            raise RuntimeError(f"sequential {label}: card and CPU differ in "
                               f"{cause}")
    if r_c.total_size != r_g.total_size or not torch.equal(
            st_c.model.n_updates, st_g.model.n_updates.cpu()):
        raise RuntimeError(f"sequential {label}: card and CPU differ in "
                           "total size or ages")
    if (st_c.balance is None) != (st_g.balance is None) or (
            st_c.balance is not None
            and not np.array_equal(st_c.balance, st_g.balance)):
        raise RuntimeError(f"sequential {label}: token balances differ")
    p_c, p_g = st_c.model.params, st_g.model.params.cpu()
    diff = (p_c - p_g).abs()
    worst = float((diff - REF_TOL - REF_TOL * p_c.abs()).max())
    tel = (check_same_telemetry(f"sequential {label}", r_c, r_g)
           if telemetry_fields(r_c) else None)
    acc_c, acc_g = r_c.final("accuracy"), r_g.final("accuracy")
    causes = {c: int(v.sum()) for c, v in r_g.failed_per_cause.items()}
    sends = [e for e in ev_g if not e[0]]
    replies = sum(e[5] == int(MessageType.REPLY) for e in sends)
    phase = st_g.phase
    off_phase = sum(e[1] % sim.delta != int(phase[e[3]]) for e in sends) \
        if sim.sync else None
    log(f"[sequential] {label}: {SEQ_CHECK_ROUNDS} rounds, card vs CPU: "
        f"{len(ev_g)} message events equal, sent "
        f"{int(r_g.sent_per_round.sum())}, failed {causes}, replies "
        f"{replies}, off-phase sends {off_phase}, balances "
        f"{None if st_g.balance is None else int(st_g.balance.sum())}, max "
        f"abs param diff {float(diff.max()):.3e}, worst margin to the "
        f"tolerance {worst:.3e} (<= 0 passes), telemetry margin {tel}; final "
        f"accuracy card {acc_g}, CPU {acc_c}; {s_g:.2f} s card, {s_c:.2f} s "
        f"CPU; launches {l_g}")
    if worst > 0 or not np.isfinite(acc_g) or not sends:
        raise RuntimeError(f"sequential {label}: the card run does not "
                           "agree with the CPU run")
    if l_g:
        raise RuntimeError(f"sequential {label}: launches {l_g}; the "
                           "sequential path launches no kernel")
    need = {"push-drop-online": causes["drop"] > 0 and causes["offline"] > 0,
            "push_pull-delay": replies > 0,
            "tokenized": bool(off_phase),
            "chaos": causes.get("chaos", 0) > 0}.get(label, True)
    if not need:
        raise RuntimeError(f"sequential {label}: the run shows none of what "
                           "the configuration is there for")
    if st_g.model.params.device.type != "cuda":
        raise RuntimeError(f"sequential {label}: the card run's state is on "
                           f"{st_g.model.params.device}")


def seq_timed(torch, merge, bulk: dict) -> dict:
    """The north-star configuration (``northstar_parts``) through the
    sequential engine on the card: a warm-up round, one measured round,
    then as many rounds as fit SEQ_TARGET_S (at most SEQ_MAX_ROUNDS),
    timed; one more round profiled for its kernel launches per message
    and the card's idle share. ``bulk`` is phase 7's default-deliver
    leg (``ns_timed``): its accuracy after as many rounds is printed
    beside."""
    from gossipy_tpu_torch.core import AntiEntropyProtocol
    from gossipy_tpu_torch.random import TorchDraws
    from gossipy_tpu_torch.simulation import SequentialGossipSimulator
    stacked, topology, handler = northstar_parts()
    t0 = time.perf_counter()
    sim = SequentialGossipSimulator(handler, topology, stacked, delta=100,
                                    protocol=AntiEntropyProtocol.PUSH,
                                    draws=TorchDraws(42), device="cuda")
    state = sim.init_nodes(torch.Generator().manual_seed(42))
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    state, _ = sim.start(state, n_rounds=1)        # warm-up round
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, one = sim.start(state, n_rounds=1)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    rounds = max(1, min(SEQ_MAX_ROUNDS, int(SEQ_TARGET_S / one_s)))
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    sent = int(rep.sent_per_round.sum())
    acc = rep.final("accuracy")
    done = int(state.round)
    if launches or not np.isfinite(acc) or sent == 0 \
            or not torch.isfinite(state.model.params).all():
        raise RuntimeError(f"sequential north star: launches {launches}, "
                           f"sent {sent}, accuracy {acc}")
    box = {}

    def profiled():
        box["rep"] = sim.start(state, n_rounds=1)[1]
    rows, wall_us = device_rows(torch, profiled)
    busy = sum(dev_us(e) for e in rows)
    n_launch = sum(e.count for e in rows)
    msgs = int(box["rep"].sent_per_round.sum())
    idle = 1 - busy / wall_us if busy > 0 else None
    curve = bulk["curve"]
    at_bulk = float(curve[done - 1]) if done <= len(curve) else None
    log(f"[sequential] north star, one measured round {one_s * 1e3:.1f} ms, "
        f"set-up {setup:.2f} s; {rounds} timed rounds in {wall:.3f} s = "
        f"{wall / rounds * 1e3:.3f} ms/round, {sent / wall:.1f} messages/s "
        f"({sent} sent, {int(rep.failed_per_round.sum())} failed); final "
        f"global accuracy after {done} rounds {acc}, the bulk engine's "
        f"(phase 7, default deliver) after {done} rounds {at_bulk} and after "
        f"{len(curve)} {bulk['accuracy']}; merge-kernel launches {launches}")
    log(f"[sequential] north star, one profiled round with eval: wall "
        f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, idle "
        f"share {idle}, {n_launch} device launches for {msgs} messages = "
        f"{n_launch / max(msgs, 1):.1f} a message")
    for e in sorted(rows, key=dev_us, reverse=True)[:6]:
        log(f"[profile]   {dev_us(e) / 1e3:8.3f} ms {e.count:6d}x "
            f"{e.key[:90]}")
    return {"ms_per_round": wall / rounds * 1e3, "messages_per_s": sent / wall,
            "rounds": rounds, "accuracy": acc, "bulk_accuracy": at_bulk,
            "launches_per_message": n_launch / max(msgs, 1),
            "idle_share": idle}


def audit_twin(torch, merge) -> dict:
    """The audit twin at its defaults on the card, plain and
    ``--tokenized``: its JSON line, and the merge kernels its legs
    launched (the sequential legs none: (a) and (b) hold that). The plain
    twin's bulk leg takes the single-pass deliver: K1 must launch. The
    tokenized bulk simulator's token hook refuses the single pass, so its
    default is the plain deliver. Returns the launches by run."""
    from gossipy_tpu_torch.examples import audit_fidelity
    out = {}
    for label, argv in (("audit-twin", []),
                        ("audit-twin-tokenized", ["--tokenized"])):
        merge.reset_launch_counts()
        t0 = time.perf_counter()
        summary = audit_fidelity.main(argv)
        torch.cuda.synchronize()
        launches = out[label] = {k: v for k, v in merge.LAUNCHES.items()
                                 if v}
        log(f"[sequential] {label}: {time.perf_counter() - t0:.2f} s, "
            f"launches {launches}, max accuracy gap "
            f"{summary['max_accuracy_gap']}")
        acc = summary["final"]
        if not (np.isfinite(acc["accuracy_bulk"])
                and np.isfinite(acc["accuracy_sequential"])):
            raise RuntimeError(f"{label}: non-finite accuracy {summary}")
    if not out["audit-twin"].get(merge.KERNEL):
        raise RuntimeError(f"audit twin: K1 never launched in the bulk leg "
                           f"({out['audit-twin']})")
    return out


def sequential_phase(torch, merge, bulk: dict) -> dict:
    """Phase 13: (a) each SEQ_CHECKS configuration on the card against
    the CPU; (b) the north star through the sequential engine, timed;
    (c) the audit twin. Returns the launches per (kernel, ring) and
    run."""
    for label in SEQ_CHECKS:
        seq_card_vs_cpu(torch, merge, label)
    seq_timed(torch, merge, bulk)
    paths = {}
    for run, launches in audit_twin(torch, merge).items():
        for k, v in launches.items():
            paths.setdefault((k, "float32"), {})[run] = v
    return paths


# -- phase 14: configs, checkpoints and recovery ------------------------------

CONFIG_CHECKED = ("spambase_100", "all2all", "berta_2014", "danner_2023",
                  "giaretta_2019", "hegedus_2020", "hegedus_2021")
CONFIG_CHECK_ROUNDS = 5
CONFIG_CARD_ONLY = ("cifar10_100nodes",)
# Onoszko's config is built on both devices and compared; its 3 rounds on
# the card (~21 s: the first PENS merge and its ~20 s update pass) ran the
# simulator phase 10 times at the same width through the same merge, and
# were cut to pay for phase 17.
CONFIG_CARD_ROUNDS = {"cifar10_100nodes": 2}
CKPT_ROUNDS = 10            # spambase_100: 2 x 10 rounds against 20
CKPT_SHORT = 5              # the bf16 and int8 rings
CKPT_TOKEN = 15             # the token config (its nodes bank tokens
                            # before they send)
CKPT_SEQ = ("push-drop-online", 3, 2, 9)   # phase 13's label, interval,
                                            # kept, rounds
REC_NAN_AT = (3, 7)         # (node, round) of the recorder run's NaN
REC_CHUNK = 5
REC_ROUNDS = 15
TRACE_HALF_ROUNDS = 50      # tracing's cost sits inside the host's noise
                            # at any length; 50 pays for phase 16
CONFIG_TIMED_ROUNDS = 50    # (e): run_experiment's and start's timed
                            # rounds (300 until phase 21 needed the time,
                            # 100 until its (n) did: the same config as
                            # phase 7's legs)


def config_names() -> list:
    """The shipped configs, ``examples/configs/*.json`` (not
    ``service/``), by name."""
    import glob
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    return sorted(os.path.basename(p)[:-5] for p in glob.glob(
        os.path.join(here, "examples", "configs", "*.json")))


def load_config(name: str, **changes):
    import dataclasses
    import os

    from gossipy_tpu_torch.config import ExperimentConfig
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = ExperimentConfig.from_json(os.path.join(here, "examples",
                                                  "configs", name + ".json"))
    return dataclasses.replace(cfg, **changes)


@contextlib.contextmanager
def images_once(copies: bool = False):
    """The image stand-ins made once for the phase (each build of an image
    config would make its 60,000 images again); with ``copies`` each call
    gets its own copy of them (phases that may write into their data)."""
    from gossipy_tpu_torch import data
    saved = data.get_CIFAR10, data.get_FashionMNIST
    cache = {}

    def once(name, fn):
        def get(allow_synthetic=True):
            if name not in cache:
                cache[name] = fn(allow_synthetic)
            if not copies:
                return cache[name]
            return tuple((x.copy(), y.copy()) for x, y in cache[name])
        return get
    data.get_CIFAR10 = once("cifar10", saved[0])
    data.get_FashionMNIST = once("fmnist", saved[1])
    try:
        yield
    finally:
        data.get_CIFAR10, data.get_FashionMNIST = saved


def build_config(name: str, device, **changes):
    """``build_experiment`` of a shipped config on ``device``."""
    from gossipy_tpu_torch.config import build_experiment
    cfg = load_config(name, **changes)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the offline stand-ins' notes
        sim, disp = build_experiment(cfg, device=device)
    return cfg, sim, disp


def sim_knobs(sim) -> dict:
    """The simulator's class and timing knobs and its handler's
    hyperparameters, as comparable values."""
    h = sim.handler
    out = {"class": type(sim).__name__, "handler": type(h).__name__,
           "protocol": int(sim.protocol), "delay": repr(sim.delay),
           "account": repr(getattr(sim, "account", None))}
    for a in ("n_nodes", "delta", "drop_prob", "online_prob",
              "sampling_eval", "sync", "eval_every", "K", "Kr", "F",
              "history_dtype", "fused_merge", "_compact_cap", "n_sampled",
              "m_top", "step1_rounds"):
        if hasattr(sim, a):
            out[a] = getattr(sim, a)
    for a in ("mode", "local_epochs", "batch_size", "n_classes",
              "input_shape", "learning_rate", "k", "alpha", "matching",
              "reg", "lr", "L", "sample_size", "compute_dtype"):
        if hasattr(h, a):
            out["handler." + a] = str(getattr(h, a))
    part = getattr(h, "partition", None)
    if part is not None:
        out["partition"] = part.part_of.tolist()
    return out


def check_same_build(torch, name, a, b) -> None:
    """Two builds of one config (CPU and card): the same knobs, topology
    edges, shards, and (All2All) mixing weights."""
    if sim_knobs(a) != sim_knobs(b):
        raise RuntimeError(f"config {name}: the builds' knobs differ: "
                           f"{sim_knobs(a)} against {sim_knobs(b)}")
    if not np.array_equal(np.asarray(a.topology.adjacency),
                          np.asarray(b.topology.adjacency)):
        raise RuntimeError(f"config {name}: the builds' edges differ")
    if sorted(a.data) != sorted(b.data) or not all(
            torch.equal(a.data[k].cpu(), b.data[k].cpu()) for k in a.data):
        raise RuntimeError(f"config {name}: the builds' shards differ")
    if hasattr(a, "mixing") and not torch.equal(
            torch.as_tensor(a.mixing).cpu(), torch.as_tensor(b.mixing).cpu()):
        raise RuntimeError(f"config {name}: the builds' mixing differs")


def config_card_vs_cpu(torch, merge, name: str, cpu, card) -> dict:
    """Phase 14 (a), one config at its own width: CONFIG_CHECK_ROUNDS
    rounds on the CPU and on the card from the config's seeds; equal
    accounting, boxes, ages and ``aux``, params within REF_TOL plus
    REF_TOL of their magnitude, K1 once a round with messages on the
    single-pass deliver (every call bit-equal to its plain version,
    ``MergeAudit``), no launch elsewhere. Returns the card run's
    launches."""
    from gossipy_tpu_torch import set_seed
    runs = {}
    for dev, sim in (("cpu", cpu), ("cuda", card)):
        cfg = load_config(name)
        state = sim.init_nodes(set_seed(cfg.seed),
                               common_init=cfg.common_init)
        merge.reset_launch_counts()
        audit = MergeAudit(torch, merge, sim)
        t0 = time.perf_counter()
        with audit if dev == "cuda" else contextlib.nullcontext():
            state, rep = sim.start(state, n_rounds=CONFIG_CHECK_ROUNDS)
        runs[dev] = (state, rep, {k: v for k, v in merge.LAUNCHES.items()
                                  if v}, audit.stats,
                     time.perf_counter() - t0)
    (st_c, r_c, l_c, _, t_c), (st_g, r_g, l_g, stats, t_g) = \
        runs["cpu"], runs["cuda"]
    label = f"config {name}"
    check_same_accounting(torch, label, st_c, st_g, r_c, r_g)
    check_same_aux(torch, label, st_c, st_g, REF_TOL)
    p_c, p_g = st_c.model.params, st_g.model.params.cpu()
    diff = (p_c - p_g).abs()
    worst = float((diff - REF_TOL * (1.0 + p_c.abs())).max())
    with_msgs = rounds_with_messages(r_g)
    kernel = {"float32": merge.KERNEL}.get(card.history_dtype,
                                           merge.KERNEL_MULTI_DQ)
    want = {kernel: with_msgs} if card.fused_merge == "multi" else {}
    log(f"[config] {name} card vs CPU: {type(card).__name__}, "
        f"{card.n_nodes} nodes, deliver {card.fused_merge or 'plain'}, "
        f"{CONFIG_CHECK_ROUNDS} rounds: sent {int(r_g.sent_per_round.sum())}"
        f", failed {int(r_g.failed_per_round.sum())}; max abs param diff "
        f"{float(diff.max()):.3e}, worst margin to the tolerance "
        f"{worst:.3e} (<= 0 passes); launches card {l_g}, CPU {l_c}; merge "
        f"calls held to the plain versions {stats}; CPU {t_c:.2f} s, card "
        f"{t_g:.2f} s")
    if worst > 0 or not torch.isfinite(st_g.model.params).all():
        raise RuntimeError(f"{label}: the card run does not agree with the "
                           "CPU run")
    if l_c or l_g != want or (want and with_msgs == 0):
        raise RuntimeError(f"{label}: launches card {l_g}, CPU {l_c}; the "
                           f"path makes {want}")
    return l_g


def config_card_only(torch, merge, name: str, sim) -> dict:
    """Phase 14 (a), a CIFAR10Net config at its full width on the card
    only: CONFIG_CARD_ROUNDS rounds from the config's seeds, finite params
    and accuracy, params moved, K1 launches counted. Returns the launches
    and the state."""
    from gossipy_tpu_torch import set_seed
    cfg = load_config(name)
    state = sim.init_nodes(set_seed(cfg.seed), common_init=cfg.common_init)
    rounds = CONFIG_CARD_ROUNDS[name]
    p0 = state.model.params.clone()
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    acc = rep.final("accuracy")
    with_msgs = rounds_with_messages(rep)
    want = {merge.KERNEL: with_msgs} if sim.fused_merge == "multi" else {}
    moved = (state.model.params != p0).any(dim=1).cpu()
    log(f"[config] {name} on the card: {type(sim).__name__}, {sim.n_nodes}"
        f" nodes, {int(sim.data['mtr'].sum())} training images, deliver "
        f"{sim.fused_merge or 'plain'}, bf16 compute "
        f"{sim.handler.compute_dtype is not None}, {rounds} "
        f"rounds in {wall:.2f} s; sent {int(rep.sent_per_round.sum())}; "
        f"final sampled accuracy {acc}; params moved on "
        f"{int(moved.sum())} of {sim.n_nodes} nodes; launches {launches}")
    if not torch.isfinite(state.model.params).all() or not np.isfinite(acc):
        raise RuntimeError(f"config {name}: non-finite params or accuracy")
    if not moved.any():
        raise RuntimeError(f"config {name}: no params moved")
    if launches != want:
        raise RuntimeError(f"config {name}: launches {launches}; the path "
                           f"makes {want}")
    return launches, state


def memory_budget_check(torch, merge, sim) -> None:
    """Phase 14 (d): the flagship config's budget against the card's total
    memory (``torch.cuda.mem_get_info``), then a limit one byte below
    the budget: ``MemoryBudgetExceeded`` before any launch."""
    from gossipy_tpu_torch.simulation.engine import MemoryBudgetExceeded
    budget = sim.check_memory_budget()
    total = budget["total_bytes"]
    free, card = torch.cuda.mem_get_info()
    merge.reset_launch_counts()
    before = dict(merge.LAUNCHES)
    try:
        sim.check_memory_budget(limit_bytes=total - 1)
    except MemoryBudgetExceeded as e:
        err = e
    else:
        raise RuntimeError("memory budget: a limit below the budget passed")
    if dict(merge.LAUNCHES) != before or any(merge.LAUNCHES.values()):
        raise RuntimeError("memory budget: a kernel launched during the "
                           "check")
    log(f"[memory] flagship config: budget {total} bytes "
        f"({total / 2**30:.3f} GiB; dominant {err.dominant_term} "
        f"{budget[err.dominant_term]} bytes) against the card's "
        f"{card} bytes ({free} free): passes; with limit {total - 1}: "
        f"MemoryBudgetExceeded ({err}); launches before and after "
        f"{ {k: v for k, v in merge.LAUNCHES.items() if v} }")


def states_equal(torch, a, b) -> bool:
    from gossipy_tpu_torch.checkpoint import flatten_state
    fa, fb = flatten_state(a), flatten_state(b)
    if sorted(fa) != sorted(fb):
        return False
    for k, v in fa.items():
        w = fb[k]
        if isinstance(v, torch.Tensor):
            if v.dtype != w.dtype or v.shape != w.shape or not torch.equal(
                    v.cpu(), w.cpu()):
                return False
        elif isinstance(v, np.ndarray):
            if not np.array_equal(v, w):
                return False
        elif v != w:
            return False
    return True


def ckpt_resume(torch, merge, label: str, name: str, rounds: int,
                tmp: str, **params) -> dict:
    """Phase 14 (b): a config's run of ``2 rounds`` rounds straight, and
    again as ``rounds`` rounds, ``save``, a FRESH simulator's ``load`` and
    ``rounds`` more, on the card: bit-equal states (every leaf, the ring
    and ``aux`` included), equal accounting, the merge kernel launched in
    both. Returns the launches of each run."""
    import os

    from gossipy_tpu_torch import set_seed
    from gossipy_tpu_torch.simulation.report import SimulationReport
    changes = {"simulator_params": params} if params else {}
    cfg, sim, _ = build_config(name, "cuda", **changes)
    state = sim.init_nodes(set_seed(cfg.seed))
    merge.reset_launch_counts()
    full, r_full = sim.start(state, n_rounds=2 * rounds)
    l_full = {k: v for k, v in merge.LAUNCHES.items() if v}
    _, sim_a, _ = build_config(name, "cuda", **changes)
    part = sim_a.init_nodes(set_seed(cfg.seed))
    merge.reset_launch_counts()
    part, r_a = sim_a.start(part, n_rounds=rounds)
    torch.cuda.synchronize()
    path = os.path.join(tmp, label)
    t0 = time.perf_counter()
    sim_a.save(path, part)
    t_save = time.perf_counter() - t0
    _, sim_b, _ = build_config(name, "cuda", **changes)
    t0 = time.perf_counter()
    resumed, _ = sim_b.load(path)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    resumed, r_b = sim_b.start(resumed, n_rounds=rounds)
    l_split = {k: v for k, v in merge.LAUNCHES.items() if v}
    r_split = SimulationReport.concatenate([r_a, r_b])
    same = states_equal(torch, full, resumed)
    for field in ("sent_per_round", "failed_per_round",
                  "mailbox_hwm_per_round", "compact_slots_per_round",
                  "wide_slots_per_round"):
        same = same and np.array_equal(getattr(r_full, field),
                                       getattr(r_split, field))
    log(f"[checkpoint] {label}: {type(sim).__name__}, ring "
        f"{sim.history_dtype}, deliver {sim.fused_merge or 'plain'}, "
        f"{2 * rounds} rounds straight against {rounds} + save + load + "
        f"{rounds}: bit-equal {same}; launches straight {l_full}, split "
        f"{l_split}; checkpoint {os.path.getsize(path)} bytes, save "
        f"{t_save * 1e3:.1f} ms, load {t_load * 1e3:.1f} ms (its template "
        f"included)")
    kernel = {"float32": merge.KERNEL}.get(sim.history_dtype,
                                           merge.KERNEL_MULTI_DQ)
    if not same:
        raise RuntimeError(f"checkpoint {label}: the resumed run is not "
                           "the straight run")
    if sim.fused_merge == "multi" and not (l_full.get(kernel)
                                           and l_split.get(kernel)):
        raise RuntimeError(f"checkpoint {label}: {kernel} did not launch "
                           "in both runs")
    return {"straight": l_full, "resumed": l_split}


def ckpt_cross_device(torch, tmp: str) -> None:
    """Phase 14 (b): a card checkpoint loaded on the CPU and a CPU one on
    the card, equal to the element."""
    import os

    from gossipy_tpu_torch import set_seed
    for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
        cfg, sim, _ = build_config("spambase_100", src,
                                   simulator_params={
                                       "history_dtype": "int8"})
        state, _ = sim.start(sim.init_nodes(set_seed(cfg.seed)), 3)
        path = os.path.join(tmp, f"cross-{src}")
        sim.save(path, state)
        _, other, _ = build_config("spambase_100", dst,
                                   simulator_params={
                                       "history_dtype": "int8"})
        loaded, draws = other.load(path)
        same = states_equal(torch, state, loaded)
        where = loaded.model.params.device.type == other.device.type
        gen = torch.equal(draws.get_state()["generator"],
                          sim.draws.get_state()["generator"])
        ok = same and where and gen
        log(f"[checkpoint] a {src} checkpoint (int8 ring, 3 rounds) loaded "
            f"on the {dst}: equal to the element {same}, on the {dst} "
            f"{where}, the draw state equal {gen}")
        if not ok:
            raise RuntimeError(f"checkpoint: {src} -> {dst} differs")


def ckpt_sequential(torch, tmp: str) -> None:
    """Phase 14 (b): the sequential engine (phase 13's configuration
    ``CKPT_SEQ[0]``, 16 nodes) through ``CheckpointManager`` (interval 3,
    2 kept) to round 6, then a fresh simulator and manager resume from the
    latest to round 9: the message stream and the state equal the same
    3-round chunks run straight (a sequential ``start`` begins with empty
    queues, as in the JAX engine)."""
    import os

    from gossipy_tpu_torch.checkpoint import CheckpointManager
    label, interval, keep, rounds = CKPT_SEQ
    ref, st, ref_log = seq_check_sim(torch, label, "cuda")
    for _ in range(rounds // interval):
        st, _ = ref.start(st, n_rounds=interval)
    a, st_a, log_a = seq_check_sim(torch, label, "cuda")
    d = os.path.join(tmp, "seq")
    mgr = CheckpointManager(d, interval=interval, max_to_keep=keep)
    mgr.run(a, st_a, until_round=rounds - interval)
    resumed_from = mgr.latest()
    b, _, log_b = seq_check_sim(torch, label, "cuda")
    mgr2 = CheckpointManager(d, interval=interval, max_to_keep=keep)
    final = mgr2.run(b, b.init_nodes(local_train=False), until_round=rounds)
    ok = (log_a.events + log_b.events == ref_log.events
          and states_equal(torch, st, final))
    log(f"[checkpoint] sequential {label}, {a.n_nodes} nodes: manager to "
        f"round {rounds - interval}, a fresh manager from round "
        f"{resumed_from} to {final.round} (kept {mgr2.checkpoints()}): "
        f"{len(ref_log.events)} messages, the straight chunks' stream and "
        f"state {ok}")
    if not ok or mgr2.checkpoints() != [rounds - interval, rounds]:
        raise RuntimeError("checkpoint: the sequential run through the "
                           "manager differs")


def poison(sim, node: int, at: int) -> None:
    """Write a NaN into ``node``'s first parameter before round ``at``'s
    snapshot (an instance hook: the round and the replay's per-phase
    re-run both call it); on a mesh across ranks the rank holding the
    node's row writes it."""
    pre_send = sim._pre_send

    def hook(state, r):
        pre_send(state, r)
        rows = sim._rows or slice(0, sim.n_nodes)
        if r == at and rows.start <= node < rows.stop:
            state.model.params[node - rows.start, 0] = float("nan")
    sim._pre_send = hook


def recovery(torch, merge, tmp: str) -> dict:
    """Phase 14 (c): the north-star config with sentinels, a NaN written
    into node REC_NAN_AT[0] before round REC_NAN_AT[1], under
    ``FlightRecorder(chunk=REC_CHUNK)``: the bundle of the last healthy
    chunk start, then ``replay_bundle`` on a fresh simulator. Returns the
    recorded run's launches."""
    import json
    import os

    from gossipy_tpu_torch import set_seed
    from gossipy_tpu_torch.telemetry import FlightRecorder, replay_bundle
    node, at = REC_NAN_AT
    cfg, sim, _ = build_config("spambase_100", "cuda",
                               simulator_params={"sentinels": True})
    poison(sim, node, at)
    state = sim.init_nodes(set_seed(cfg.seed))
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    _, reports, bundle = FlightRecorder(os.path.join(tmp, "fr"),
                                        chunk=REC_CHUNK).run(sim, state,
                                                             REC_ROUNDS)
    t_rec = time.perf_counter() - t0
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    verdict = json.load(open(os.path.join(bundle, "verdict.json")))
    _, fresh, _ = build_config("spambase_100", "cuda",
                               simulator_params={"sentinels": True})
    poison(fresh, node, at)
    t0 = time.perf_counter()
    replay = replay_bundle(bundle, fresh)
    t_rep = time.perf_counter() - t0
    files = sorted(os.listdir(bundle))
    log(f"[recovery] NaN into node {node} before round {at}, chunks of "
        f"{REC_CHUNK}: {len(reports)} chunks recorded in {t_rec:.2f} s, "
        f"bundle {os.path.basename(bundle)} {files}; verdict "
        f"{json.dumps(verdict)}; replay on a fresh simulator ({t_rep:.2f} "
        f"s) {json.dumps(replay)}; launches {launches}")
    want_start = (at // REC_CHUNK) * REC_CHUNK
    ok = (verdict["kind"] == "sentinel"
          and verdict["chunk_start_round"] == want_start
          and verdict["first_bad_round"] == at
          and replay["matches_recorded"] is True
          and replay["leaf"] == "Dense_0/bias" and node in replay["nodes"]
          and replay["phase"] == "send"
          and files == ["checkpoint", "checkpoint.meta.json",
                        "events.jsonl", "manifest.json", "verdict.json"]
          and launches.get(merge.KERNEL, 0) > 0)
    if not ok:
        raise RuntimeError("recovery: the bundle or its replay is not what "
                           "the run recorded")
    return launches


def config_timed(torch, merge, ns_legs: dict) -> dict:
    """Phase 14 (e): ``spambase_100.json`` through ``run_experiment`` on
    the card, BENCH_ROUNDS rounds after a warm-up (the build and the
    pre-training pass inside the clock, the card synchronised before it
    stops), then ``start`` alone on a built state, beside phase 7's legs;
    one profiled round's idle share; then ``tracing=`` on against off in
    interleaved halves of TRACE_HALF_ROUNDS rounds. Returns the launches
    of the timed run."""
    from gossipy_tpu_torch import set_seed
    from gossipy_tpu_torch.config import run_experiment
    from gossipy_tpu_torch.telemetry import Tracer, trace_report
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run_experiment(load_config("spambase_100",
                                   n_rounds=NS_WARMUP_ROUNDS))
        torch.cuda.synchronize()
        merge.reset_launch_counts()
        t0 = time.perf_counter()
        state, rep = run_experiment(load_config(
            "spambase_100", n_rounds=CONFIG_TIMED_ROUNDS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    with_msgs = rounds_with_messages(rep)
    acc = rep.final("accuracy")
    if launches != {merge.KERNEL: with_msgs} or \
            with_msgs != CONFIG_TIMED_ROUNDS \
            or not np.isfinite(acc):
        raise RuntimeError(f"config timed: launches {launches} for "
                           f"{with_msgs} rounds with messages, accuracy "
                           f"{acc}")
    cfg, sim, _ = build_config("spambase_100", "cuda")
    st = sim.init_nodes(set_seed(cfg.seed))
    st, _ = sim.start(st, n_rounds=NS_WARMUP_ROUNDS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, rep2 = sim.start(st, n_rounds=CONFIG_TIMED_ROUNDS)
    torch.cuda.synchronize()
    wall_start = time.perf_counter() - t0
    idle = profile(torch, lambda: sim._round(st),
                   "spambase_100 config, one round with eval")
    legs = {k: (round(v["rounds_per_s"], 2), v["accuracy"])
            for k, v in ns_legs.items()}
    log(f"[config] spambase_100.json through run_experiment on the card: "
        f"build, pre-training and {CONFIG_TIMED_ROUNDS} rounds in "
        f"{wall:.3f} s = {CONFIG_TIMED_ROUNDS / wall:.2f} rounds/s; start "
        f"alone {CONFIG_TIMED_ROUNDS} rounds in {wall_start:.3f} s = "
        f"{CONFIG_TIMED_ROUNDS / wall_start:.2f} rounds/s; final global "
        f"accuracy "
        f"{acc}; K1 launches {launches}; idle share of one round {idle}; "
        f"phase 7's legs (rounds/s, accuracy) {legs}")
    # tracing= on against off, interleaved halves on one process.
    runs = {}
    for label, kw in (("off", {}), ("on", {"tracing": Tracer()})):
        _, s, _ = build_config("spambase_100", "cuda", simulator_params=kw)
        runs[label] = [s, s.init_nodes(set_seed(cfg.seed)), 0.0]
        runs[label][1], _ = s.start(runs[label][1], NS_WARMUP_ROUNDS)
    torch.cuda.synchronize()
    for label in ("off", "on", "on", "off"):
        s, state, _ = runs[label]
        t0 = time.perf_counter()
        state, _ = s.start(state, n_rounds=TRACE_HALF_ROUNDS)
        torch.cuda.synchronize()
        runs[label][1] = state
        runs[label][2] += time.perf_counter() - t0
    rate = {k: 2 * TRACE_HALF_ROUNDS / v[2] for k, v in runs.items()}
    totals = trace_report(runs["on"][0].tracer.snapshot())["totals"]
    log(f"[config] tracing on against off, {2 * TRACE_HALF_ROUNDS} rounds "
        f"each in interleaved halves: off {rate['off']:.2f} rounds/s, on "
        f"{rate['on']:.2f} rounds/s, share of off "
        f"{rate['on'] / rate['off']:.4f}; trace totals {json.dumps(totals)}")
    return launches


def config_phase(torch, merge, ns_legs: dict) -> dict:
    """Phase 14 (a)-(e); returns the launches per (kernel, ring format)
    and run."""
    import shutil
    import tempfile

    from gossipy_tpu_torch.models import nn as tnn
    x = tnn._lecun_normal(LECUN_PIN["shape"], LECUN_PIN["shape"][0],
                          torch.Generator().manual_seed(LECUN_PIN["seed"]))
    bits = tuple(x.flatten()[:6].numpy().view(np.uint32).tolist())
    log(f"[weights] _lecun_normal{LECUN_PIN['shape']} at seed "
        f"{LECUN_PIN['seed']} on torch {torch.__version__}: "
        f"{[float(v) for v in x.flatten()[:6]]}, bits {list(bits)}, pinned "
        f"{list(LECUN_PIN['bits'])}: equal {bits == LECUN_PIN['bits']}")
    if bits != LECUN_PIN["bits"]:
        raise RuntimeError("the initial weights differ from the pinned "
                           "ones on this torch")
    paths = {}

    def keep(run, launches, wire="float32"):
        """The launches of ``run`` on a ``wire`` ring, by (kernel, ring)."""
        for k, v in launches.items():
            quantized = k in (merge.KERNEL_MULTI_DQ, merge.KERNEL_FLAT_DQ)
            paths.setdefault((k, wire if quantized else "float32"),
                             {})[run] = v

    # (a) every shipped config built on the card and on the CPU
    t0 = time.perf_counter()
    with images_once():
        for name in config_names():
            _, cpu, _ = build_config(name, "cpu")
            _, card, _ = build_config(name, "cuda")
            check_same_build(torch, name, cpu, card)
            log(f"[config] {name}: {type(card).__name__}, {card.n_nodes} "
                "nodes, built alike on the card and the CPU")
            if name in CONFIG_CHECKED:
                keep(f"config-{name}",
                     config_card_vs_cpu(torch, merge, name, cpu, card))
            elif name in CONFIG_CARD_ONLY:
                launches, _ = config_card_only(torch, merge, name, card)
                keep(f"config-{name}", launches)
                if name == "cifar10_100nodes":
                    # (d) the memory budget
                    memory_budget_check(torch, merge, card)
            del cpu, card
            torch.cuda.empty_cache()
    log(f"[config] (a) and (d) took {time.perf_counter() - t0:.1f} s")
    # (b) checkpoints
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="gossipy-ckpt-")
    try:
        out = ckpt_resume(torch, merge, "spambase_100", "spambase_100",
                          CKPT_ROUNDS, tmp)
        keep("ckpt-spambase_100", out["resumed"])
        for wire in ("bfloat16", "int8"):
            out = ckpt_resume(torch, merge, f"spambase_100-{wire}",
                              "spambase_100", CKPT_SHORT, tmp,
                              history_dtype=wire)
            keep(f"ckpt-spambase_100-{wire}", out["resumed"], wire)
        ckpt_resume(torch, merge, "hegedus_2021", "hegedus_2021",
                    CKPT_TOKEN, tmp)
        ckpt_cross_device(torch, tmp)
        ckpt_sequential(torch, tmp)
        log(f"[checkpoint] (b) took {time.perf_counter() - t0:.1f} s")
        # (c) recovery
        keep("recorder-spambase_100", recovery(torch, merge, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # (e) timed
    keep("config-spambase_100-timed", config_timed(torch, merge, ns_legs))
    return paths


# -- phase 15: performance, metrics and the run ledger ----------------------

PERF_CHUNKS = (10, 10)      # (a), (e): the north star's two segments
PERF_TURNS = 4              # (b): the legs' turns (in order, then in
PERF_TURN_ROUNDS = 25       # reverse, and again), and the rounds of each
                            # (50 until phase 16 needed the time)
PERF_NS_ROUNDS = 100        # (c): the north star's rounds with perf=
PERF_FLAG_ROUNDS = 2        # (c): the flagship config's rounds
PROFILE_ROUNDS = 3          # (d): the profiled north-star rounds
ATTRIBUTION_ROUNDS = 50     # (d): each leg of profile_round's attribution
                            # (100 until phase 21 (n) needed the time; the
                            # exchange leg is the remainder, so the legs'
                            # sum holds at any depth)
PERF_AGREE = 0.05           # (c): perf's ms/round against the host clock;
                            # (d): the legs' sum against the whole round


def perf_kw(torch, ledger_path: str) -> dict:
    """Every host-side option on: ``perf``, ``metrics``, ``ledger`` (at
    ``ledger_path``) and ``tracing`` (a tracer of its own)."""
    from gossipy_tpu_torch.telemetry import Tracer
    return {"perf": True, "metrics": True, "ledger": ledger_path,
            "tracing": Tracer()}


def report_arrays(rep) -> dict:
    """Every per-round array of a report (and its total size) by name."""
    d = rep.to_dict()
    return {k: v for k, v in d.items() if not k.startswith("perf")}


def perf_equality(torch, merge, tmp: str) -> dict:
    """Phase 15 (a) and the first half of (e): two fresh north-star runs
    on K1 from the same seeds, each as PERF_CHUNKS segments, one with
    every host-side option on, one with all off: every leaf of the state
    bit-equal, every report array equal, equal K1 launches (once a round
    with messages); the fresh metrics registry's engine counters equal
    the reports' sent and failed by cause; the ledger holds one row a
    segment under one run id. Returns the launches by run."""
    import os

    from gossipy_tpu_torch.simulation import SimulationReport
    from gossipy_tpu_torch.telemetry import MetricsRegistry, RunLedger, \
        set_registry
    ledger_path = os.path.join(tmp, "ledger-a.jsonl")
    registry = MetricsRegistry()
    prev = set_registry(registry)
    runs = {}
    try:
        for label, kw in (("off", {}), ("on", perf_kw(torch, ledger_path))):
            sim, state = northstar_sim(torch, "cuda", fused_merge="multi",
                                       **kw)
            merge.reset_launch_counts()
            reps = []
            for n in PERF_CHUNKS:
                state, rep = sim.start(state, n_rounds=n)
                reps.append(rep)
            torch.cuda.synchronize()
            launches = {k: v for k, v in merge.LAUNCHES.items() if v}
            runs[label] = (sim, state, SimulationReport.concatenate(reps),
                           launches)
    finally:
        set_registry(prev)
    (_, st_off, rep_off, l_off), (sim, st_on, rep_on, l_on) = \
        runs["off"], runs["on"]
    same_state = states_equal(torch, st_off, st_on)
    a_off, a_on = report_arrays(rep_off), report_arrays(rep_on)
    same_report = sorted(a_off) == sorted(a_on) and all(
        json.dumps(a_off[k]) == json.dumps(a_on[k]) for k in a_off)
    with_msgs = rounds_with_messages(rep_off)
    rounds = sum(PERF_CHUNKS)
    perf_rows = rep_on.perf_round_ms is not None and \
        rep_off.perf_round_ms is None
    log(f"[perf] (a) north star on K1, {rounds} rounds in segments "
        f"{list(PERF_CHUNKS)}, all host-side options on against off: state "
        f"bit-equal {same_state}, report arrays equal {same_report}, perf "
        f"rows only with perf= {perf_rows}; launches on {l_on}, off {l_off}"
        f" for {with_msgs} rounds with messages")
    if not (same_state and same_report and perf_rows) or l_on != l_off \
            or l_on != {merge.KERNEL: with_msgs} or with_msgs == 0:
        raise RuntimeError("perf (a): the run with the host-side options on "
                           "differs from the run with them off")
    # (e) the metrics registry and the ledger of the same run
    snap = registry.snapshot()["metrics"]

    def counter(name, **labels):
        want = {"simulator": "GossipSimulator", **labels}
        rows = [r["value"] for r in snap[name]["series"]
                if r["labels"] == want]
        return rows[0] if rows else None
    got = {"rounds": counter("engine_rounds_total"),
           "sent": counter("engine_messages_sent_total")}
    want = {"rounds": float(rounds), "sent": float(rep_on.sent_messages)}
    for cause, arr in rep_on.failed_per_cause.items():
        got[cause] = counter("engine_messages_failed_total", cause=cause)
        want[cause] = float(np.asarray(arr).sum())
    rows = RunLedger(ledger_path).read()
    ids = {r["run_id"] for r in rows["rows"]}
    segs = [r["extra"] for r in rows["rows"]]
    log(f"[perf] (e) metrics registry {got}, the reports {want}; ledger "
        f"{len(rows['rows'])} rows ({rows['skipped']} skipped), run ids "
        f"{sorted(ids)}, segments {segs}, headline "
        f"{rows['rows'][-1]['metrics'] if rows['rows'] else None}")
    if got != want or len(rows["rows"]) != len(PERF_CHUNKS) or \
            len(ids) != 1 or rows["skipped"] or \
            [s["rounds"] for s in segs] != list(PERF_CHUNKS):
        raise RuntimeError("perf (e): the registry or the ledger does not "
                           "hold the run")
    return {"perf-off": l_off[merge.KERNEL], "perf-on": l_on[merge.KERNEL]}


def null_scopes(sim):
    """``sim`` with ``telemetry.scopes.phase_scope`` a null context while
    its ``start`` runs (this script only: the scopes' own cost)."""
    from gossipy_tpu_torch.telemetry import scopes
    start = sim.start

    def run(*a, **kw):
        saved = scopes.phase_scope
        scopes.phase_scope = lambda name: contextlib.nullcontext()
        try:
            return start(*a, **kw)
        finally:
            scopes.phase_scope = saved
    sim.start = run
    return sim


def perf_timed(torch, merge, tmp: str) -> dict:
    """Phase 15 (b) and the north star of (c): three legs of the north
    star on K1, each a warm-up round on its own simulator, then
    PERF_TURNS x PERF_TURN_ROUNDS rounds on a fresh one in interleaved
    turns (the legs in order, then in reverse, and again; the card
    synchronised before the host clock stops each ``start``): every
    option off; every option on; off with the phase ranges made null.
    K1 once a round with messages, no other launch. Then (c): the north
    star with ``perf=`` alone, a warm-up round and PERF_NS_ROUNDS rounds
    in one ``start``, its ``perf_summary`` held by :func:`perf_check`.
    Returns the launches by leg."""
    import os

    from gossipy_tpu_torch.telemetry import analytic_round_cost

    def build(label):
        kw = perf_kw(torch, os.path.join(tmp, "ledger-b.jsonl")) \
            if label == "on" else {}
        sim, state = northstar_sim(torch, "cuda", fused_merge="multi", **kw)
        return (null_scopes(sim) if label == "scopes-off" else sim), state
    order = ["off", "on", "scopes-off"]
    for label in order:
        sim, state = build(label)
        sim.start(state, n_rounds=1)
    torch.cuda.synchronize()
    runs = {label: list(build(label)) + [0.0, {}, []] for label in order}
    for turn in range(PERF_TURNS):
        for label in (order if turn % 2 == 0 else order[::-1]):
            run = runs[label]
            merge.reset_launch_counts()
            t0 = time.perf_counter()
            run[1], rep = run[0].start(run[1], n_rounds=PERF_TURN_ROUNDS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run[2] += wall
            for k, v in merge.LAUNCHES.items():
                if v:
                    run[3][k] = run[3].get(k, 0) + v
            run[4].append((wall, rep))
    rate, out = {}, {}
    for label in order:
        sim, state, wall, launches, calls = runs[label]
        with_msgs = sum(rounds_with_messages(rep) for _, rep in calls)
        acc = calls[-1][1].final("accuracy")
        if launches != {merge.KERNEL: with_msgs} or with_msgs == 0 or \
                not torch.isfinite(state.model.params).all() or \
                not np.isfinite(acc):
            raise RuntimeError(f"perf (b) {label}: launches {launches} for "
                               f"{with_msgs} rounds with messages, accuracy "
                               f"{acc}")
        rate[label] = PERF_TURNS * PERF_TURN_ROUNDS / wall
        out[f"perf-timed-{label}"] = launches[merge.KERNEL]
        log(f"[perf] (b) {label}: {PERF_TURNS * PERF_TURN_ROUNDS} rounds "
            f"in {wall:.3f} s = {rate[label]:.2f} rounds/s; final accuracy "
            f"{acc}; launches {launches}")
    log(f"[perf] (b) share of off: every option on "
        f"{rate['on'] / rate['off']:.4f}; the phase ranges' own cost, off "
        f"against off with null ranges: {rate['off'] / rate['scopes-off']:.4f}"
        " of the null-range rate")
    # (c) perf= alone: the host clock around one start holds the rounds
    # and the report (the ledger's fsync'd append and manifest, some
    # 30-60 ms a start on the card's machine, would sit in it too).
    sim, state = northstar_sim(torch, "cuda", fused_merge="multi",
                               perf=True)
    state, _ = sim.start(state, n_rounds=1)
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=PERF_NS_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    if launches != {merge.KERNEL: rounds_with_messages(rep)}:
        raise RuntimeError(f"perf (c) north star: launches {launches}")
    out["perf-northstar"] = launches[merge.KERNEL]
    cpu_sim, _ = northstar_sim(torch, "cpu", fused_merge="multi")
    cpu_flops = analytic_round_cost(cpu_sim)["flops_per_round"]
    perf_check(torch, "north star", sim.perf_summary(),
               torch.cuda.get_device_name(0), cpu_flops,
               wall / PERF_NS_ROUNDS, sim.memory_budget())
    return out


def perf_check(torch, label, summary, name, cpu_flops, host_s_per_round,
               budget) -> None:
    """Phase 15 (c) on one simulator's ``perf_summary`` after a timed
    ``start``."""
    from gossipy_tpu_torch.telemetry import cost
    last = summary["last_run"]
    flops = summary["analytic"]["flops_per_round"]
    s = last["ms_per_round"] / 1e3
    mfu = flops / (s * cost.PEAK_FLOPS[name])
    agree = abs(s - host_s_per_round) / host_s_per_round
    log(f"[perf] (c) {label}: device {summary['device_kind']!r} peak "
        f"{summary['peak_flops']:.4g} FLOP/s; analytic FLOPs a round "
        f"{flops:.6g} (the CPU's count {cpu_flops:.6g}; executed "
        f"{summary['analytic']['flops_per_round_executed']:.6g}, bytes "
        f"{summary['analytic']['bytes_per_round']:.6g}); perf ms/round "
        f"{last['ms_per_round']:.4f} against the host clock's "
        f"{host_s_per_round * 1e3:.4f} ({agree:.2%} apart); mfu_est "
        f"{last['mfu_est']:.6e} (flops / (s x peak) = {mfu:.6e}); "
        f"hbm_peak_bytes {summary['hbm_peak_bytes']} beside memory_budget() "
        f"{budget['total_bytes']}; cold {last['cold']}")
    if summary["device_kind"] != name or \
            summary["peak_flops"] != cost.PEAK_FLOPS[name] or \
            flops != cpu_flops or agree > PERF_AGREE or \
            abs(last["mfu_est"] - mfu) > 1e-6 * mfu or \
            not summary["hbm_peak_bytes"]:
        raise RuntimeError(f"perf (c) {label}: the perf summary does not "
                           "hold what the run measured")


def perf_flagship(torch, merge) -> dict:
    """Phase 15 (c) on the flagship: the CIFAR10Net config of phase 14
    with ``perf=``, PERF_FLAG_ROUNDS rounds on the card after its
    pre-training pass, its perf summary held as the north star's, the
    analytic count against the same config built on the CPU. Returns the
    launches."""
    from gossipy_tpu_torch import set_seed
    from gossipy_tpu_torch.telemetry import analytic_round_cost
    name = torch.cuda.get_device_name(0)
    with images_once():
        _, cpu, _ = build_config("cifar10_100nodes", "cpu")
        cpu_flops = analytic_round_cost(cpu)["flops_per_round"]
        del cpu
        cfg, sim, _ = build_config("cifar10_100nodes", "cuda",
                                   simulator_params={"perf": True})
    state = sim.init_nodes(set_seed(cfg.seed), common_init=cfg.common_init)
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=PERF_FLAG_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    with_msgs = rounds_with_messages(rep)
    if launches != {merge.KERNEL: with_msgs} or with_msgs == 0 or \
            not torch.isfinite(state.model.params).all():
        raise RuntimeError(f"perf (c) flagship: launches {launches} for "
                           f"{with_msgs} rounds with messages")
    perf_check(torch, "flagship config", sim.perf_summary(), name,
               cpu_flops, wall / PERF_FLAG_ROUNDS, sim.memory_budget())
    del sim, state
    torch.cuda.empty_cache()
    return {"perf-flagship": launches[merge.KERNEL]}


def trace_device_us(path: str) -> float:
    """The summed duration of a Chrome trace's device events (kernels,
    copies, fills), in µs."""
    with open(path) as fh:
        doc = json.load(fh)
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    return sum(float(e.get("dur", 0.0)) for e in events
               if isinstance(e, dict) and e.get("ph") == "X"
               and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))


def perf_phases(torch, merge, tmp: str) -> dict:
    """Phase 15 (d): PROFILE_ROUNDS north-star rounds under
    ``start(profile_dir=...)`` after a warm-up round: the trace holds the
    four round phases, ``phase_times_from_trace`` gives each a positive
    device time (the route it took named), their sum no greater than the
    profiled rounds' device time; then ``examples/profile_round.py``'s
    ``profile`` at ATTRIBUTION_ROUNDS rounds: the three legs sum to the
    whole round within PERF_AGREE. Returns the launches."""
    import os

    from gossipy_tpu_torch.examples import profile_round
    from gossipy_tpu_torch.telemetry import ROUND_PHASES, \
        phase_times_from_trace, phases_in_trace_dir
    trace_dir = os.path.join(tmp, "profile")
    sim, state = northstar_sim(torch, "cuda", fused_merge="multi")
    state, _ = sim.start(state, n_rounds=1)
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    state, rep = sim.start(state, n_rounds=PROFILE_ROUNDS,
                           profile_dir=trace_dir)
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    detail: dict = {}
    phase_ms = phase_times_from_trace(trace_dir, detail=detail)
    found = phases_in_trace_dir(trace_dir)
    device_ms = trace_device_us(detail["file"]) / 1e3 if detail else None
    total = sum(phase_ms.values()) if phase_ms else None
    log(f"[perf] (d) {PROFILE_ROUNDS} profiled north-star rounds: phases "
        f"in the trace {found}; device ms by phase "
        f"{ {k: round(v, 4) for k, v in (phase_ms or {}).items()} } (route "
        f"{detail.get('route')}), sum {total} of the trace's device "
        f"{device_ms} ms; launches {launches}")
    if found != list(ROUND_PHASES) or phase_ms is None or \
            sorted(phase_ms) != sorted(ROUND_PHASES) or \
            min(phase_ms.values()) <= 0 or total > device_ms or \
            launches != {merge.KERNEL: rounds_with_messages(rep)}:
        raise RuntimeError("perf (d): the profiled trace does not give the "
                           "four phases' device time")
    merge.reset_launch_counts()
    row = profile_round.profile(n_nodes=NS_NODES, rounds=ATTRIBUTION_ROUNDS,
                                device="cuda")
    k1 = merge.LAUNCHES[merge.KERNEL]
    att = row["attribution"]
    legs = sum(att["phases_ms"].values())
    agree = abs(legs - att["full_ms"]) / att["full_ms"]
    log(f"[perf] (d) profile_round at {ATTRIBUTION_ROUNDS} rounds: "
        f"{json.dumps(row['ms_per_round'])}; legs sum {legs:.4f} against "
        f"the whole {att['full_ms']:.4f} ms ({agree:.2%} apart); analytic "
        f"FLOPs a round {row['analytic']['flops_per_round']:.6g}, achieved "
        f"{row['achieved_gflops_per_s']} GFLOP/s; K1 launches {k1}")
    if agree > PERF_AGREE or k1 == 0:
        raise RuntimeError("perf (d): the attribution's legs do not sum to "
                           "the whole round")
    return {"perf-profiled": launches[merge.KERNEL],
            "perf-attribution": k1}


def perf_recovery(torch, merge, tmp: str) -> dict:
    """Phase 15 (e), the flight recorder: phase 14's recovery run with
    ``GOSSIPY_TPU_LEDGER`` naming a ledger: one bundle row (the sentinel
    verdict inline, the bundle and its verdict as artifacts) beside the
    engine rows the recorded and the replayed simulators append. Returns
    the launches."""
    import os

    from gossipy_tpu_torch.telemetry import RunLedger
    path = os.path.join(tmp, "ledger-e.jsonl")
    saved = os.environ.get("GOSSIPY_TPU_LEDGER")
    os.environ["GOSSIPY_TPU_LEDGER"] = path
    try:
        launches = recovery(torch, merge, os.path.join(tmp, "rec"))
    finally:
        if saved is None:
            del os.environ["GOSSIPY_TPU_LEDGER"]
        else:
            os.environ["GOSSIPY_TPU_LEDGER"] = saved
    rows = RunLedger(path).rows()
    bundles = [r for r in rows if r.get("kind") == "bundle"]
    engine = [r for r in rows if r.get("kind") == "engine"]
    log(f"[perf] (e) recovery under GOSSIPY_TPU_LEDGER: {len(rows)} rows, "
        f"{len(bundles)} bundle row(s) "
        f"{[(r['failure']['kind'], sorted(r['artifacts'])) for r in bundles]}"
        f", {len(engine)} engine rows under "
        f"{len({r['run_id'] for r in engine})} run ids")
    if len(bundles) != 1 or bundles[0]["failure"]["kind"] != "sentinel" or \
            sorted(bundles[0]["artifacts"]) != ["bundle", "verdict"]:
        raise RuntimeError("perf (e): the recorder did not append its "
                           "bundle row")
    return {"perf-recovery": launches.get(merge.KERNEL, 0)}


def perf_phase(torch, merge) -> dict:
    """Phase 15 (a)-(e); returns K1's launches by run."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="gossipy-perf-")
    runs = {}
    try:
        for step in (perf_equality, perf_timed, perf_phases,
                     perf_recovery):
            t0 = time.perf_counter()
            runs.update(step(torch, merge, tmp))
            log(f"[perf] {step.__name__} took "
                f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        runs.update(perf_flagship(torch, merge))
        log(f"[perf] perf_flagship took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {(merge.KERNEL, "float32"): runs}


# -- phase 16: active-cohort rounds --------------------------------------------

COHORT_NOMINAL = 1_000_000  # bench.py::bench_cohort's defaults
COHORT_SIZE = 1024
COHORT_ROUNDS = 50          # the warm-up's and the timed run's rounds
COHORT_PREFETCH = 2
COHORT_FEATURES = 57
COHORT_TRACE_ROUNDS = 20    # each traced run's rounds
COHORT_PROFILE_ROUNDS = 4   # the profiled start's rounds (idle share)
COHORT_AVG_ROUNDS = 30      # the lr = 0 run (tests/test_cohort.py's
                            # TestMillionNodePool)
COHORT_PLAIN_NOMINAL = 100_000  # (b): K1 against the plain leg
COHORT_PLAIN_ROUNDS = 10
COHORT_CHECK_ROUNDS = 10    # (c): the twin's configuration, card vs CPU


_COHORT_DATA = {}


def cohort_data() -> dict:
    """``bench.py::bench_cohort``'s data bank: P = 4C = 4096 shards of 4
    synthetic 57-feature samples with a linear label (node ``i`` reads
    shard ``i % P``), the eval set capped at 2048 samples."""
    if "stacked" not in _COHORT_DATA:
        from gossipy_tpu_torch.data import ClassificationDataHandler, \
            DataDispatcher
        rng = np.random.default_rng(42)
        w = rng.normal(size=COHORT_FEATURES)
        shards = 4 * COHORT_SIZE
        X = rng.normal(size=(4 * shards, COHORT_FEATURES)).astype(
            np.float32)
        y = (X @ w > 0).astype(np.int64)
        eval_cap = min(2048, int(0.2 * len(X)))
        _COHORT_DATA["stacked"] = DataDispatcher(
            ClassificationDataHandler(X, y, test_size=eval_cap / len(X)),
            n=shards, eval_on_user=False).stacked()
    return _COHORT_DATA["stacked"]


def cohort_sim(torch, nominal: int, device, lr: float = 0.1,
               prefetch: int = 0, rounds: int = COHORT_ROUNDS, draws=None,
               pool_dir=None, **kw):
    """``bench.py::bench_cohort``'s simulator: ``NominalTopology``,
    ``CohortConfig(size=1024)``, LogReg(57, 2) under SGD ``lr``, batch
    4, one local epoch, MERGE_UPDATE, PUSH, ``delta=100``, a 1% sampled
    eval on the run's last round, an fp32 ring; ``TorchDraws(42)`` moved
    to the state ``draws`` when given; the pool on disk under
    ``pool_dir`` when given."""
    from gossipy_tpu_torch.handlers import SGDHandler, losses
    from gossipy_tpu_torch.models import LogisticRegression
    from gossipy_tpu_torch.random import TorchDraws
    from gossipy_tpu_torch.simulation import CohortConfig, GossipSimulator, \
        NominalTopology
    h = SGDHandler(LogisticRegression(COHORT_FEATURES, 2),
                   losses.cross_entropy, learning_rate=lr, local_epochs=1,
                   batch_size=4, n_classes=2,
                   input_shape=(COHORT_FEATURES,))
    sim = GossipSimulator(h, NominalTopology(nominal), cohort_data(),
                          delta=100, sampling_eval=0.01, eval_every=rounds,
                          cohort=CohortConfig(size=COHORT_SIZE,
                                              prefetch=prefetch,
                                              pool_dir=pool_dir),
                          draws=TorchDraws(42), device=device, **kw)
    if draws is not None:
        sim.draws.set_state(draws)
    return sim


def pool_variance(torch, params) -> float:
    """The pool's total param variance, in float64 on the card."""
    p = torch.from_numpy(params).cuda().double()
    return float(((p - p.mean(0)) ** 2).sum())


def cohort_launch_check(merge, label, rep, launches, kernel) -> int:
    """``kernel`` launched once a round with messages, nothing else."""
    with_msgs = int(((rep.compact_slots_per_round
                      + rep.wide_slots_per_round) > 0).sum())
    if launches != {kernel: with_msgs} or with_msgs == 0:
        raise RuntimeError(f"cohort {label}: launches {launches}, the path "
                           f"makes {kernel} once a round with messages "
                           f"({with_msgs})")
    return with_msgs


def cohort_timed(torch, merge) -> dict:
    """Phase 16 (a): the full-width configuration on the card, serial and
    ``prefetch=2``, from one pool."""
    from gossipy_tpu_torch.examples import cohort_smoke as cs
    from gossipy_tpu_torch.telemetry.tracing import Tracer, trace_report
    torch.cuda.empty_cache()
    sim = cohort_sim(torch, COHORT_NOMINAL, "cuda")
    t0 = time.perf_counter()
    pool0 = sim.init_cohort_pool(torch.Generator().manual_seed(42))
    init_s = time.perf_counter() - t0
    draws0 = sim.draws.get_state()
    budget = sim.memory_budget()
    torch.cuda.reset_peak_memory_stats()
    legs = {}
    for tag, prefetch in (("serial", 0), ("stream", COHORT_PREFETCH)):
        s = sim if prefetch == 0 else cohort_sim(
            torch, COHORT_NOMINAL, "cuda", prefetch=prefetch, draws=draws0)
        warm, rep_w = s.start(pool0, n_rounds=COHORT_ROUNDS)
        torch.cuda.synchronize()
        merge.reset_launch_counts()
        t0 = time.perf_counter()
        pool, rep = s.start(warm, n_rounds=COHORT_ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in merge.LAUNCHES.items() if v}
        cohort_launch_check(merge, tag, rep, launches, merge.KERNEL)
        idle = profile(torch, lambda: s.start(pool, COHORT_PROFILE_ROUNDS),
                       f"cohort {tag}, {COHORT_PROFILE_ROUNDS} rounds")
        legs[tag] = dict(warm=warm, pool=pool, rep_w=rep_w, rep=rep,
                         wall=wall, launches=launches, idle=idle, sim=s)
    ser, st = legs["serial"], legs["stream"]
    if not (cs.same_pools(ser["warm"], st["warm"])
            and cs.same_pools(ser["pool"], st["pool"])):
        raise RuntimeError("cohort: the streamed pool is not bit-identical "
                           "to the serial pool")
    peak = torch.cuda.max_memory_allocated()
    cov = np.concatenate([ser["rep_w"].cohort_coverage,
                          ser["rep"].cohort_coverage])
    expected = 2 * COHORT_ROUNDS * COHORT_SIZE / COHORT_NOMINAL
    acc = ser["rep"].final("accuracy")
    if not ((np.diff(cov) >= 0).all() and 0.5 * expected < cov[-1]
            <= expected + 1e-9):
        raise RuntimeError(f"cohort: coverage {cov[-1]} not monotone within "
                           f"(0.5, 1] x {expected}")
    if not (np.isfinite(ser["pool"].model.params).all()
            and np.isfinite(acc)):
        raise RuntimeError("cohort: non-finite params or accuracy")
    traced = {}
    for tag, prefetch in (("serial", 0), ("stream", COHORT_PREFETCH)):
        tr = Tracer(process_name=f"chip_smoke.cohort.{tag}")
        s = cohort_sim(torch, COHORT_NOMINAL, "cuda", prefetch=prefetch,
                       draws=draws0, tracing=tr)
        s.start(pool0, n_rounds=COHORT_TRACE_ROUNDS)
        report = trace_report(tr.snapshot())
        traced[tag] = report["totals"]
        log(f"[cohort] traced {tag}: critical path " + ", ".join(
            f"{row['name']} {row['ms']:.1f} ms"
            for row in report["critical_path"][:8]))
    avg = cohort_sim(torch, COHORT_NOMINAL, "cuda", lr=0.0,
                     rounds=COHORT_AVG_ROUNDS, draws=draws0)
    v0 = pool_variance(torch, pool0.model.params)
    pool_avg, _ = avg.start(pool0, n_rounds=COHORT_AVG_ROUNDS)
    v1 = pool_variance(torch, pool_avg.model.params)
    if not 0 < v1 < v0:
        raise RuntimeError(f"cohort: lr = 0 rounds did not shrink the pool's "
                           f"variance ({v0} -> {v1})")
    rates = {tag: COHORT_ROUNDS / legs[tag]["wall"] for tag in legs}
    log(f"[cohort] nominal {COHORT_NOMINAL}, C {COHORT_SIZE}, K {sim.K}, "
        f"D {sim._history_depth(sim._model_size())}, deliver "
        f"{sim.fused_merge}: pool init {init_s:.3f} s; {COHORT_ROUNDS} "
        f"rounds serial {legs['serial']['wall']:.3f} s = "
        f"{rates['serial']:.2f} rounds/s, prefetch={COHORT_PREFETCH} "
        f"{legs['stream']['wall']:.3f} s = {rates['stream']:.2f} rounds/s, "
        f"stream/serial {rates['stream'] / rates['serial']:.4f}; streamed "
        f"pool bit-identical to serial; K1 launches serial "
        f"{ser['launches']}, stream {st['launches']}; idle share serial "
        f"{ser['idle']}, stream {st['idle']}; traced {COHORT_TRACE_ROUNDS} "
        f"rounds: overlap_frac serial {traced['serial']['overlap_frac']}, "
        f"stream {traced['stream']['overlap_frac']}, host_blocked_frac "
        f"serial {traced['serial']['host_blocked_frac']}, stream "
        f"{traced['stream']['host_blocked_frac']}; coverage after "
        f"{2 * COHORT_ROUNDS} rounds {float(cov[-1])} (R C / N = "
        f"{expected}); final accuracy {acc}; lr = 0, "
        f"{COHORT_AVG_ROUNDS} rounds: pool variance {v0:.6f} -> {v1:.6f} "
        f"({v1 / v0:.6f}); memory budget: cohort_pool_resident "
        f"{budget['cohort_pool_resident']} B, cohort_active_total "
        f"{budget['cohort_active_total']} B, "
        f"cohort_materialized_prediction "
        f"{budget['cohort_materialized_prediction']} B; "
        f"max_memory_allocated {peak} B")
    shape = (sim._history_depth(sim._model_size()),
             sim.handler.layout.stride, sim.K)
    return {"serial": ser["launches"][merge.KERNEL],
            "stream": st["launches"][merge.KERNEL], "shape": shape,
            "draws": draws0}


def cohort_plain_leg(torch, merge) -> dict:
    """Phase 16 (b): the same pool and seed at nominal
    COHORT_PLAIN_NOMINAL on K1 (every call held to its plain version on
    its own tables), on the same path with K1's plain version in its
    place (params bit-equal), and on the plain deliver
    (``fused_merge=False``: the same cohorts, touched rows, coverage and
    sends; its own updates)."""
    from gossipy_tpu_torch.examples import cohort_smoke as cs
    from gossipy_tpu_torch.simulation import engine
    base = cohort_sim(torch, COHORT_PLAIN_NOMINAL, "cuda",
                      rounds=COHORT_PLAIN_ROUNDS)
    pool0 = base.init_cohort_pool(torch.Generator().manual_seed(7))
    draws0 = base.draws.get_state()
    runs = {}
    for label, fused in (("k1", None), ("k1-plain-version", None),
                         ("plain", False)):
        kw = {} if fused is None else {"fused_merge": fused}
        sim = cohort_sim(torch, COHORT_PLAIN_NOMINAL, "cuda",
                         rounds=COHORT_PLAIN_ROUNDS, draws=draws0, **kw)
        merge.reset_launch_counts()
        audit = MergeAudit(torch, merge, sim)
        saved = engine.gather_merge_multi
        if label == "k1-plain-version":
            engine.gather_merge_multi = merge.gather_merge_multi_reference
        try:
            with audit if label == "k1" else contextlib.nullcontext():
                pool, rep = sim.start(pool0, n_rounds=COHORT_PLAIN_ROUNDS)
        finally:
            engine.gather_merge_multi = saved
        runs[label] = (pool, rep, {k: v for k, v in merge.LAUNCHES.items()
                                   if v}, audit.stats)
    (pk, rk, lk, stats), (pp, rp, lp, _), (pd, rd, ld, _) = (
        runs["k1"], runs["k1-plain-version"], runs["plain"])
    launches = cohort_launch_check(merge, "k1 leg", rk, lk, merge.KERNEL)
    if lp or ld:
        raise RuntimeError(f"cohort: the plain legs launched {lp}, {ld}")
    if not cs.same_pools(pk, pp):
        raise RuntimeError("cohort: K1's pool differs from its plain "
                           "version's on the same path")
    for field in ("sent_per_round", "failed_per_round",
                  "compact_slots_per_round", "wide_slots_per_round",
                  "cohort_coverage"):
        if not np.array_equal(getattr(rk, field), getattr(rp, field)):
            raise RuntimeError(f"cohort: K1 and its plain version differ in "
                               f"{field}")
    for field in ("sent_per_round", "cohort_coverage",
                  "cohort_active_nodes"):
        if not np.array_equal(getattr(rk, field), getattr(rd, field)):
            raise RuntimeError(f"cohort: the K1 and plain legs differ in "
                               f"{field}")
    if not np.array_equal(pk.touched, pd.touched):
        raise RuntimeError("cohort: the K1 and plain legs sampled other "
                           "cohorts")
    log(f"[cohort] (b) nominal {COHORT_PLAIN_NOMINAL}, "
        f"{COHORT_PLAIN_ROUNDS} rounds from one pool: K1 launches {lk}, "
        f"every call bit-equal to its plain version ({stats}); K1's pool "
        f"bit-equal to the same path with K1's plain version (launches "
        f"{lp}); the plain deliver (launches {ld}) samples the same "
        f"cohorts (touched {int(pd.touched.sum())} rows) and sends "
        f"{int(rd.sent_per_round.sum())}, fails "
        f"{int(rd.failed_per_round.sum())} (K1 leg "
        f"{int(rk.failed_per_round.sum())}); final accuracy K1 "
        f"{rk.final('accuracy')}, plain {rd.final('accuracy')}")
    return {"plain-check": launches}


def cohort_twin_sim(torch, device, wire: str):
    """``examples/cohort_smoke.py``'s N = 96, C = 24 configuration on a
    ``wire`` ring."""
    from gossipy_tpu_torch.core import Topology
    from gossipy_tpu_torch.examples import cohort_smoke as cs
    from gossipy_tpu_torch.random import TorchDraws
    from gossipy_tpu_torch.simulation import CohortConfig, GossipSimulator
    return GossipSimulator(
        cs.handler(), Topology.random_regular(cs.N_NOMINAL, 6, seed=3),
        cs.stacked(cs.N_NOMINAL, 6, cs.D, 0.25), delta=20,
        cohort=CohortConfig(size=cs.C), history_dtype=wire,
        draws=TorchDraws(cs.SEED), device=device)


def cohort_card_vs_cpu(torch, merge, wire: str) -> int:
    """Phase 16 (c): the twin's configuration on the CPU and on the card
    from one pool and one draw state: the same cohorts and accounting
    exactly, params within REF_TOL plus a ring step; every merge call of
    the card run bit-equal to its plain version."""
    from gossipy_tpu_torch.examples import cohort_smoke as cs
    runs = {}
    pool0 = draws0 = None
    for dev in ("cpu", "cuda"):
        sim = cohort_twin_sim(torch, dev, wire)
        if pool0 is None:
            pool0 = sim.init_cohort_pool(torch.Generator().manual_seed(11))
            draws0 = sim.draws.get_state()
        sim.draws.set_state(draws0)
        merge.reset_launch_counts()
        audit = MergeAudit(torch, merge, sim)
        with audit if dev == "cuda" else contextlib.nullcontext():
            pool, rep = sim.start(pool0, n_rounds=COHORT_CHECK_ROUNDS)
        runs[dev] = (pool, rep, {k: v for k, v in merge.LAUNCHES.items()
                                 if v}, audit.stats)
    (pc, rc, lc, _), (pg, rg, lg, stats) = runs["cpu"], runs["cuda"]
    label = f"card vs CPU {wire}"
    kernel = merge.KERNEL if wire == "float32" else merge.KERNEL_MULTI_DQ
    launches = cohort_launch_check(merge, label, rg, lg, kernel)
    for field in ("sent_per_round", "failed_per_round",
                  "mailbox_hwm_per_round", "compact_slots_per_round",
                  "wide_slots_per_round", "cohort_coverage"):
        if not np.array_equal(getattr(rc, field), getattr(rg, field)):
            raise RuntimeError(f"cohort {label}: {field} differs")
    for a, b in zip(cs.pool_leaves(pc)[1:], cs.pool_leaves(pg)[1:]):
        if not np.array_equal(a, b):
            raise RuntimeError(f"cohort {label}: ages, phases, keys or "
                               "touched rows differ")
    p_c, p_g = pc.model.params, pg.model.params
    tol = REF_TOL + (2.0 ** -8 * np.abs(p_c) if wire == "bfloat16" else 0)
    diff = np.abs(p_c - p_g)
    worst = float((diff - tol).max())
    log(f"[cohort] (c) {label}: {COHORT_CHECK_ROUNDS} rounds, sent "
        f"{int(rg.sent_per_round.sum())}, coverage "
        f"{float(rg.cohort_coverage[-1])}; max abs param diff "
        f"{float(diff.max()):.3e}, worst margin {worst:.3e} (<= 0 passes); "
        f"launches card {lg}, CPU {lc}; merge calls held to the plain "
        f"version {stats}")
    if worst > 0 or lc:
        raise RuntimeError(f"cohort {label}: card and CPU disagree")
    return launches


def cohort_phase(torch, merge, rate) -> tuple:
    """Phase 16: (a) the full-width configuration (``cohort_timed``),
    (b) K1 against the plain leg (``cohort_plain_leg``), (c) card against
    CPU on an fp32 and a bf16 ring (K2), (d) the ``examples/
    cohort_smoke.py`` twin's eight checks, (e) K1 alone at the cohort
    shape. Returns the launches by (kernel, ring) and run and K1's
    numbers at the cohort shape."""
    import shutil

    from gossipy_tpu_torch.ops import _build
    t0 = time.perf_counter()
    timed = cohort_timed(torch, merge)
    log(f"[cohort] (a) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths = {(merge.KERNEL, "float32"): {
        "cohort-serial": timed["serial"], "cohort-stream": timed["stream"],
        **{f"cohort-{k}": v for k, v in cohort_plain_leg(torch,
                                                         merge).items()},
        "cohort-card-vs-cpu": cohort_card_vs_cpu(torch, merge,
                                                 "float32")},
        (merge.KERNEL_MULTI_DQ, "bfloat16"): {
            "cohort-card-vs-cpu": cohort_card_vs_cpu(torch, merge,
                                                     "bfloat16")}}
    log(f"[cohort] (b), (c) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # A process of its own, as a user runs it (its peak RSS is the disk
    # pool's check), writing inside the checkout (the build directory).
    out = _build.BUILD_DIR / "cohort_smoke"
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "gossipy_tpu_torch.examples.cohort_smoke",
             "--out", str(out)], capture_output=True, text=True,
            timeout=600, cwd=str(_build.PKG_DIR.parent))
        if proc.returncode != 0:
            raise RuntimeError("the cohort_smoke twin failed:\n"
                               + proc.stdout[-3000:] + proc.stderr[-3000:])
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    log(f"[cohort] (d) the cohort_smoke twin: all eight checks passed in "
        f"{time.perf_counter() - t0:.1f} s: sent {rec['sent_per_round']}, "
        f"sequential replay {rec['seq_replay_sent']}, coverage "
        f"{rec['coverage_final']}, trace {rec['trace']}, stream A/B "
        f"{rec['stream_ab']}, disk pool {rec['pool_100m']}")
    d, stride, k = timed["shape"]
    at_cohort = check_multi(torch, merge, "cohort", "float32", COHORT_SIZE,
                            d, stride, k, 64, rate)
    return paths, at_cohort


# -- phase 17: the multi-tenant service -------------------------------------

SERVICE_ROUNDS = 50         # (b): each tenant's rounds of spambase_100
SERVICE_SLICE = 25          # (b): the rounds of a slice
SERVICE_SEEDS = (42, 43, 44, 45)
SERVICE_DROPS = (0.0, 0.02, 0.05, 0.1)
SERVICE_TIME_SCALE = 0.01   # (c): the loadgen twin's arrival compression
SERVICE_CHECK_ROUNDS = 4    # (d): tests/test_torch_service.py's bucket
SERVICE_CHECK = dict(n_nodes=16, model="logreg", handler="sgd",
                     topology="random_regular",
                     topology_params={"degree": 4}, delta=20,
                     n_rounds=SERVICE_CHECK_ROUNDS, batch_size=8)
# (d)'s buckets: (tenant, seed, drop_prob, data seed, poisoned).
SERVICE_BUCKETS = {"float32": (("good", 1, 0.0, 1, False),
                               ("bad", 2, 0.0, 2, True)),
                   "bfloat16": (("p", 3, 0.0, 3, False),
                                ("q", 4, 0.1, 4, False))}


class ServiceAudit(MergeAudit):
    """:class:`MergeAudit` over every lane of a service run: the lanes'
    simulators are built inside the service, so the deliver and reply
    phases are tagged on the engine class."""

    def __init__(self, torch, merge, n_nodes: int):
        import types
        super().__init__(torch, merge, types.SimpleNamespace(n_nodes=n_nodes))

    def _tag_phases(self) -> None:
        cls = self.engine.GossipSimulator
        self._phases = {p: cls.__dict__[f"_{p}_phase"]
                        for p in ("deliver", "reply")}
        for phase, run in self._phases.items():
            def tagged(sim, state, r, run=run, phase=phase):
                self.phase, self.r = phase, r
                return run(sim, state, r)
            setattr(cls, f"_{phase}_phase", tagged)

    def _untag_phases(self) -> None:
        for phase, run in self._phases.items():
            setattr(self.engine.GossipSimulator, f"_{phase}_phase", run)


@contextlib.contextmanager
def lane_rounds():
    """The lane rounds with messages of a service run, by ring format, as
    the scheduler copies each lane's slice to the host (every round a lane
    ran, those past its request included): what the lanes' deliver
    launches K1 (fp32) or K2 (bf16, int8) for."""
    from gossipy_tpu_torch.service import scheduler
    saved = scheduler._rows_to_host
    counts: dict = {}

    def record(sim, rows):
        host = saved(sim, rows)
        live = (host["compact_slots"] + host["wide_slots"]) > 0
        counts[sim.history_dtype] = counts.get(sim.history_dtype, 0) + \
            int(live.sum())
        return host
    scheduler._rows_to_host = record
    try:
        yield counts
    finally:
        scheduler._rows_to_host = saved


@contextlib.contextmanager
def serve_launches(merge):
    """The launches of every ``GossipService.serve`` call inside the
    block: the counts set to 0 just before the call, read just after."""
    from gossipy_tpu_torch.service import GossipService
    saved = GossipService.serve
    seen: dict = {}

    def serve(svc, queue):
        merge.reset_launch_counts()
        out = saved(svc, queue)
        for k, v in merge.LAUNCHES.items():
            if v:
                seen[k] = seen.get(k, 0) + v
        return out
    GossipService.serve = serve
    try:
        yield seen
    finally:
        GossipService.serve = saved


def want_launches(merge, lanes: dict) -> dict:
    """One K1 launch per fp32 lane round with messages, one K2 per bf16
    or int8 one (the lanes' single-pass deliver)."""
    want = {}
    if lanes.get("float32"):
        want[merge.KERNEL] = lanes["float32"]
    dq = lanes.get("bfloat16", 0) + lanes.get("int8", 0)
    if dq:
        want[merge.KERNEL_MULTI_DQ] = dq
    return want


@contextlib.contextmanager
def fresh_registry():
    """A fresh process metrics registry for a twin run (a user runs the
    twin in a process of its own), the earlier one restored after."""
    from gossipy_tpu_torch.telemetry import metrics
    saved = metrics.get_registry()
    metrics.set_registry(metrics.MetricsRegistry())
    try:
        yield metrics.get_registry()
    finally:
        metrics.set_registry(saved)


def same_report(a, b) -> bool:
    """Every array of two reports bit for bit (NaN rows included)."""
    return json.dumps(a.to_dict(), sort_keys=True) == \
        json.dumps(b.to_dict(), sort_keys=True)


def service_demo(torch, merge, tmp: str) -> dict:
    """Phase 17 (a): the ``main_service`` twin at its defaults on the card
    (4 tenants, 64 nodes, 30 rounds, slices of 10): two buckets, mallory
    evicted with a bundle that replays on the card, alice and bob DONE,
    alice's report bit-equal to her solo ``run_experiment``; K1 once per
    lane round with messages, every call of both buckets bit-equal to
    its plain version."""
    from gossipy_tpu_torch.config import build_experiment
    from gossipy_tpu_torch.examples import main_service as ms
    from gossipy_tpu_torch.service import RunStatus
    from gossipy_tpu_torch.telemetry.health import replay_bundle
    audit = ServiceAudit(torch, merge, 64)
    t0 = time.perf_counter()
    with fresh_registry(), lane_rounds() as lanes, \
            serve_launches(merge) as launches, audit:
        row, handles, summary, solo = ms.run(["--out", tmp])
    wall = time.perf_counter() - t0
    want = want_launches(merge, lanes)
    if launches != want or merge.KERNEL not in want:
        raise RuntimeError(f"service (a): launches {launches}, the lanes "
                           f"make {want}")
    status = {t: h.status for t, h in handles.items()}
    if summary["n_buckets"] != 2 or status["mallory"] is not \
            RunStatus.EVICTED or status["alice"] is not RunStatus.DONE or \
            status["bob"] is not RunStatus.DONE:
        raise RuntimeError(f"service (a): {summary['n_buckets']} buckets, "
                           f"statuses {status}")
    if not same_report(handles["alice"].report, solo):
        raise RuntimeError("service (a): alice's served report is not "
                           "bit-equal to her solo run")
    m = handles["mallory"]
    sim, _ = build_experiment(m.request.config,
                              ms.tenant_data(4, poison=True),
                              device="cuda")
    verdict = replay_bundle(m.bundle_path, sim, localize=False)
    if verdict["matches_recorded"] is not True:
        raise RuntimeError(f"service (a): mallory's bundle replays to "
                           f"{verdict}")
    log(f"[service] (a) main_service twin: {summary['n_buckets']} buckets "
        f"({[b['tenants'] for b in summary['buckets']]}), "
        f"{summary['wall_seconds']} s served, {wall:.1f} s with alice's "
        f"solo run and the audit; statuses "
        f"{ {t: s.value for t, s in status.items()} }; alice bit-equal to "
        f"her solo run_experiment (final accuracy "
        f"{handles['alice'].report.final('accuracy')}); mallory evicted at "
        f"round {verdict['first_bad_round']}, her bundle replayed on the "
        f"card: {verdict['trip']} in {verdict['leaf']}, matches_recorded "
        f"{verdict['matches_recorded']}; lane rounds with messages "
        f"{lanes}, launches {launches}; merge calls held to the plain "
        f"version {audit.stats}")
    return launches


def service_northstar(torch, merge, tmp: str, solo_rps: float) -> dict:
    """Phase 17 (b): four tenants of ``examples/configs/spambase_100.json``
    at full width (seeds SERVICE_SEEDS, ``drop_prob`` SERVICE_DROPS) as
    one bucket, SERVICE_ROUNDS rounds in slices of SERVICE_SLICE (a
    ``ServiceSession`` polled to the end, the counts set to 0 just
    before): K1 once per lane round with messages; tenant-rounds/s over
    the slices and over the whole run, beside phase 7's solo K1
    rounds/s; each tenant's TTFR; the bucket's
    ``service_host_blocked_frac``; the idle share of a profiled round of
    each lane in turn."""
    from gossipy_tpu_torch.service import GossipService, RunQueue, \
        RunRequest, RunStatus
    from gossipy_tpu_torch.telemetry import MetricsRegistry
    reg = MetricsRegistry()
    q = RunQueue()
    handles = [q.submit(RunRequest(
        f"ns-{seed}", load_config("spambase_100", seed=seed, drop_prob=p,
                                  n_rounds=SERVICE_ROUNDS)))
               for seed, p in zip(SERVICE_SEEDS, SERVICE_DROPS)]
    svc = GossipService(tmp, slice_rounds=SERVICE_SLICE, registry=reg)
    sess = svc.session(q)
    with lane_rounds() as lanes, warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the offline stand-in's note
        merge.reset_launch_counts()
        t0 = time.perf_counter()
        while sess.poll():
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    summary = sess.finish()
    want = want_launches(merge, lanes)
    if launches != want or merge.KERNEL not in want:
        raise RuntimeError(f"service (b): launches {launches}, the lanes "
                           f"make {want}")
    acc = [h.report.final("accuracy") if h.report is not None else None
           for h in handles]
    if summary["n_buckets"] != 1 or any(
            h.status is not RunStatus.DONE
            or h.rounds_completed != SERVICE_ROUNDS for h in handles) \
            or not all(a is not None and np.isfinite(a) for a in acc):
        raise RuntimeError(f"service (b): {summary['n_buckets']} buckets, "
                           f"{[h.to_dict() for h in handles]}")
    snap = reg.snapshot()["metrics"]
    slices = sum(s["sum"] for s in snap["service_slice_seconds"]["series"])
    blocked = snap["service_host_blocked_frac"]["series"][0]["value"]
    tenant_rounds = len(handles) * SERVICE_ROUNDS
    rps = tenant_rounds / slices
    ttfr = {h.tenant: round(h.first_round_at - h.submitted_at, 4)
            for h in handles}
    # The card's idle share over one round of each lane in turn, as a
    # slice runs them.
    (rt,) = sess.runtimes
    idle = profile(torch, lambda: [
        run.sim._run_rounds(rt.states[i], 1)
        for i, run in enumerate(rt.bucket.runs)],
        "service bucket, one round of each of the 4 lanes")
    log(f"[service] (b) spambase_100.json x {len(handles)} tenants (seeds "
        f"{list(SERVICE_SEEDS)}, drop_prob {list(SERVICE_DROPS)}), one "
        f"bucket, {SERVICE_ROUNDS} rounds in slices of {SERVICE_SLICE}: "
        f"{tenant_rounds} tenant-rounds in {slices:.3f} s of slices = "
        f"{rps:.2f} tenant-rounds/s ({tenant_rounds / wall:.2f} over the "
        f"whole run, {wall:.3f} s with the builds and inits); phase 7's "
        f"solo K1 leg {solo_rps:.2f} rounds/s, ratio {rps / solo_rps:.4f}; "
        f"TTFR {ttfr} s; service_host_blocked_frac {blocked}; idle share "
        f"of a lane round in turn {idle}; final "
        f"accuracy {acc}; launches {launches} for lane rounds with "
        f"messages {lanes}")
    return launches


def service_loadgen(torch, merge, tmp: str) -> dict:
    """Phase 17 (c): the ``loadgen`` twin at its default pool, 6 tenants,
    time scale SERVICE_TIME_SCALE, traced: the ``service_slo`` row, no
    missing TTFR, ``trace_report``'s ``host_blocked_frac``; K1 once per
    lane round with messages (counts set to 0 just before the run)."""
    from gossipy_tpu_torch.examples import loadgen
    with fresh_registry(), lane_rounds() as lanes, \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the offline stand-in's note
        merge.reset_launch_counts()
        row, report, queue, ok = loadgen.run(
            ["--out", tmp, "--time-scale", str(SERVICE_TIME_SCALE)])
        launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    raw = row["raw"]
    want = want_launches(merge, lanes)
    if not ok or raw["ttfr_missing"] or raw["n_done"] != 6:
        raise RuntimeError(f"service (c): the SLO row fails its invariant: "
                           f"{row}")
    if launches != want or merge.KERNEL not in want:
        raise RuntimeError(f"service (c): launches {launches}, the lanes "
                           f"make {want}")
    log(f"[service] (c) loadgen twin, 6 tenants, time scale "
        f"{SERVICE_TIME_SCALE}: service_slo {row['value']} tenants/hour "
        f"(offered {raw['offered_rate_per_hour']}), TTFR p50 "
        f"{raw['ttfr_p50_ms']} ms, p99 {raw['ttfr_p99_ms']} ms, round p50 "
        f"{raw['round_p50_ms']} ms, p99 {raw['round_p99_ms']} ms, queue "
        f"wait p99 {raw['queue_wait_p99_ms']} ms, wall "
        f"{raw['wall_seconds']} s; ttfr_missing {raw['ttfr_missing']}; "
        f"trace_report host_blocked_frac {raw['host_blocked_frac']}, "
        f"overlap_frac {raw['trace_overlap_frac']}, windows "
        f"{report['n_windows']}; launches {launches} for lane rounds with "
        f"messages {lanes}")
    return launches


def service_check_data(seed: int, poison: bool):
    """``tests/test_torch_service.py``'s ``tenant_data``: 240 samples of 8
    synthetic features, non-finite rows when ``poison``."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(240, 8)).astype(np.float32)
    y = (X @ rng.normal(size=8) > 0).astype(np.int64)
    if poison:
        X[:30] = np.inf
    return X, y


def service_card_vs_cpu(torch, merge, wire: str, tmp: str) -> int:
    """Phase 17 (d): the CPU test's bucket on a ``wire`` ring, served on
    the CPU and on the card from the same seeds for SERVICE_CHECK_ROUNDS
    rounds: equal statuses, accounting, boxes, ages and eviction round,
    params within REF_TOL (plus half a bf16 step); every K1/K2 call of
    the card run bit-equal to its plain version. Returns the card's
    launches."""
    import os

    from gossipy_tpu_torch.config import ExperimentConfig
    from gossipy_tpu_torch.service import GossipService, RunQueue, \
        RunRequest, RunStatus
    from gossipy_tpu_torch.telemetry import MetricsRegistry
    sp = {} if wire == "float32" else {"history_dtype": wire}
    runs = {}
    for dev in ("cpu", "cuda"):
        q = RunQueue()
        handles = {t: q.submit(RunRequest(t, ExperimentConfig(
            **SERVICE_CHECK, seed=seed, drop_prob=p, simulator_params=sp),
            data=service_check_data(ds, poison)))
                   for t, seed, p, ds, poison in SERVICE_BUCKETS[wire]}
        svc = GossipService(os.path.join(tmp, f"{wire}-{dev}"),
                            slice_rounds=SERVICE_CHECK_ROUNDS,
                            registry=MetricsRegistry(), device=dev)
        sess = svc.session(q)
        audit = ServiceAudit(torch, merge, SERVICE_CHECK["n_nodes"])
        merge.reset_launch_counts()
        with lane_rounds() as lanes, \
                audit if dev == "cuda" else contextlib.nullcontext():
            while sess.poll():
                pass
        launches = {k: v for k, v in merge.LAUNCHES.items() if v}
        sess.finish()
        (rt,) = sess.runtimes
        states = {run.tenant: rt.states[i]
                  for i, run in enumerate(rt.bucket.runs)}
        runs[dev] = (handles, states, launches, lanes, audit.stats)
    (h_c, s_c, l_c, _, _), (h_g, s_g, l_g, lanes, stats) = \
        runs["cpu"], runs["cuda"]
    label = f"service card vs CPU {wire}"
    want = want_launches(merge, lanes)
    if l_c or l_g != want or not want:
        raise RuntimeError(f"{label}: launches card {l_g}, CPU {l_c}; the "
                           f"lanes make {want}")
    worst, evicted = -1.0, {}
    for t, hc in h_c.items():
        hg = h_g[t]
        if (hc.status, hc.rounds_completed) != (hg.status,
                                                 hg.rounds_completed):
            raise RuntimeError(f"{label}: {t} {hc.status} after "
                               f"{hc.rounds_completed} rounds on the CPU, "
                               f"{hg.status} after {hg.rounds_completed} "
                               "on the card")
        if not np.array_equal(hc.report.health_trip, hg.report.health_trip):
            raise RuntimeError(f"{label}: {t}'s sentinel trips differ")
        if hc.status is RunStatus.EVICTED:
            rounds = []
            for h in (hc, hg):
                with open(os.path.join(h.bundle_path, "verdict.json")) as fh:
                    rounds.append(json.load(fh)["first_bad_round"])
            if rounds[0] != rounds[1]:
                raise RuntimeError(f"{label}: {t} evicted at rounds "
                                   f"{rounds}")
            evicted[t] = rounds[0]
            continue
        st_c, st_g = s_c[t], s_g[t]
        check_same_accounting(torch, f"{label} {t}", st_c, st_g, hc.report,
                              hg.report)
        p_c, p_g = st_c.model.params, st_g.model.params.cpu()
        tol = REF_TOL + (2.0 ** -8 * p_c.abs() if wire == "bfloat16"
                         else 0.0)
        worst = max(worst, float(((p_c - p_g).abs() - tol).max()))
    log(f"[service] (d) {label}: tenants "
        f"{ {t: h.status.value for t, h in h_g.items()} }, evicted at "
        f"{evicted}; worst margin to the tolerance {worst:.3e} (<= 0 "
        f"passes); launches card {l_g}, CPU {l_c}, lane rounds with "
        f"messages {lanes}; merge calls held to the plain version {stats}")
    if worst > 0:
        raise RuntimeError(f"{label}: card and CPU params disagree")
    kernel = merge.KERNEL if wire == "float32" else merge.KERNEL_MULTI_DQ
    return l_g[kernel]


def service_phase(torch, merge, solo_rps: float) -> dict:
    """Phase 17: the multi-tenant service on the card: (a) the
    ``main_service`` twin (``service_demo``), (b) the north star's
    configuration as a bucket of four tenants (``service_northstar``),
    (c) the ``loadgen`` twin (``service_loadgen``), (d) card against CPU
    on an fp32 and a bf16 ring (``service_card_vs_cpu``). Returns the
    launches by (kernel, ring) and run."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="gossipy-service-")
    paths = {}

    def keep(run, launches, wire="float32"):
        for k, v in launches.items():
            paths.setdefault((k, wire), {})[run] = v
    try:
        for tag, step in (
                ("a", lambda d: keep("service-demo",
                                     service_demo(torch, merge, d))),
                ("b", lambda d: keep("service-northstar", service_northstar(
                    torch, merge, d, solo_rps))),
                ("c", lambda d: keep("service-loadgen",
                                     service_loadgen(torch, merge, d))),
                ("d", lambda d: [keep("service-card-vs-cpu", {
                    k: service_card_vs_cpu(torch, merge, w, d)}, w)
                    for w, k in (("float32", merge.KERNEL),
                                 ("bfloat16", merge.KERNEL_MULTI_DQ))])):
            t0 = time.perf_counter()
            step(tempfile.mkdtemp(dir=tmp))
            log(f"[service] ({tag}) took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return paths


def tensor_rate(name: str) -> float:
    """The card's dense bf16 tensor-core rate: the port's peak table
    (``telemetry.cost.PEAK_FLOPS``), by ``torch.cuda.get_device_name``."""
    from gossipy_tpu_torch.telemetry.cost import peak_flops
    rate = peak_flops(name)
    if rate is None:
        raise RuntimeError(f"no tensor-core rate known for {name!r}")
    return rate


def hop_arrays(sl_q, sl_k, dim, dv, carry, seed, neg, masked_rows=0):
    """float32 numpy operands of one attention hop from
    ``default_rng(seed)``: q, k_c, v_c and the initial carry (m = ``neg``,
    l = 0, acc = 0) or a mid-stream one (normal m, softplus l, normal acc),
    whose first ``masked_rows`` rows enter with m = ``neg``, l = 0,
    acc = 0. ``tests/test_torch_attention.py`` builds its cases with it."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((sl_q, dim), (sl_k, dim), (sl_k, dv)))
    if carry == "initial":
        m = np.full(sl_q, neg, np.float32)
        l = np.zeros(sl_q, np.float32)
        acc = np.zeros((sl_q, dv), np.float32)
    else:
        m = rng.normal(size=sl_q).astype(np.float32)
        l = np.log1p(np.exp(rng.normal(size=sl_q))).astype(np.float32)
        acc = rng.normal(size=(sl_q, dv)).astype(np.float32)
        m[:masked_rows] = neg
        l[:masked_rows] = 0.0
        acc[:masked_rows] = 0.0
    return q, k, v, m, l, acc


def hop_operands(torch, attn, sl_q, sl_k, dim, dv, dtype, carry, seed,
                 masked_rows=0):
    """:func:`hop_arrays` on the card, q, k_c, v_c in ``dtype``."""
    arrays = hop_arrays(sl_q, sl_k, dim, dv, carry, seed, attn._NEG,
                        masked_rows)
    dev = torch.device("cuda")
    return ([torch.from_numpy(a).to(dev, dtype) for a in arrays[:3]]
            + [torch.from_numpy(a).to(dev) for a in arrays[3:]])


def bf16_steps(torch, a, b):
    """The largest ``|a - b|`` of two ``[rows, cols]`` bf16 outputs in
    units of the bf16 step (the spacing of bf16 values) at the row's
    largest magnitude. An element near 0 has a far finer step of its own,
    below the rounding of the f32 sums that precede the cast."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).amax(dim=1, keepdim=True)
    step = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126)))
                      - 7)
    return float(((a - b).abs() / step).max())


def check_hop(torch, attn, label, sl_q, sl_k, dim, dv, dtype, causal, offs,
              carry, seed, masked_rows=0) -> dict:
    """K5 against its plain version on the same operands: m within
    1e-5 max(1, |m|); l, acc and the normalized f32 output within 1e-4 of
    their largest magnitude; the bf16 output within one bf16 step at each
    row's largest magnitude."""
    ops = hop_operands(torch, attn, sl_q, sl_k, dim, dv, dtype, carry, seed,
                       masked_rows)
    scale = 1.0 / float(np.sqrt(dim))
    got = attn.flash_hop_update_cuda(*ops, *offs, scale, causal)
    want = attn.flash_hop_update_reference(*ops, *offs, scale, causal)
    torch.cuda.synchronize()
    (m_g, l_g, a_g), (m_w, l_w, a_w) = got, want
    if not all(torch.isfinite(t).all() for t in got):
        raise RuntimeError(f"K5 {label}: output is not finite")
    m_err = float(((m_g - m_w).abs() / m_w.abs().clamp_min(1.0)).max())
    out_g = a_g / l_g.clamp_min(1e-30)[:, None]
    out_w = a_w / l_w.clamp_min(1e-30)[:, None]
    errs = {name: float((g - w).abs().max()) for name, g, w in
            (("l", l_g, l_w), ("acc", a_g, a_w), ("out", out_g, out_w))}
    mags = {name: max(float(w.abs().max()), 1e-30) for name, w in
            (("l", l_w), ("acc", a_w), ("out", out_w))}
    out_bf16 = bf16_steps(torch, out_g.to(torch.bfloat16),
                          out_w.to(torch.bfloat16))
    log(f"[attention] K5 {attn.route(dtype, dim, dv)} {label}: sl_q={sl_q} "
        f"sl_k={sl_k} D={dim} Dv={dv} "
        f"{str(dtype).split('.')[-1]} causal={causal} offs={offs} "
        f"carry={carry}: m rel err {m_err:.3e}, "
        + ", ".join(f"{n} err {errs[n]:.3e} (of {mags[n]:.3e})"
                    for n in errs)
        + f", bf16 output steps {out_bf16}")
    if m_err > 1e-5 or any(errs[n] > 1e-4 * mags[n] for n in errs) \
            or out_bf16 > 1.0:
        raise RuntimeError(f"K5 {label} disagrees with its plain version")
    if masked_rows:
        if not (bool((l_g[:masked_rows] == 0).all())
                and bool((m_g[:masked_rows] == attn._NEG).all())):
            raise RuntimeError(f"K5 {label}: a wholly masked row with m = "
                               "_NEG did not keep l = 0 and m = _NEG")
    return dict(max_abs_err=errs["out"])


def dense_attention(torch, q, k, v, causal):
    """softmax(q k^T / sqrt(D)) v in f32 with the -1e30 causal mask, the
    JAX bench's dense yardstick (bench.py::bench_ring_attention)."""
    s = (q @ k.T) / float(np.sqrt(q.shape[1]))
    if causal:
        i = torch.arange(q.shape[0], device=q.device)
        s = torch.where(i[None, :] > i[:, None], -1e30, s)
    return torch.softmax(s, dim=-1) @ v


def attention_parity(torch, attn, q, k, v, tol: float = 5e-3) -> dict:
    """``bench.py::_attention_parity``'s rule, in f32 through autograd:
    forward max abs error < tol; gradient max abs error of mean(out^2)
    w.r.t. q, k, v < max(2 tol * grad scale, 1e-7), the scale being the
    dense gradients' largest magnitude."""
    def grads(fn):
        inputs = [t.float().detach().requires_grad_(True) for t in (q, k, v)]
        out = fn(*inputs)
        g = torch.autograd.grad((out.float() ** 2).mean(), inputs)
        return out.detach().float(), g

    attn.LAUNCHES.clear()
    o_f, g_f = grads(lambda a, b, c: attn.flash_attention(a, b, c,
                                                          causal=True))
    torch.cuda.synchronize()
    launches = attn.LAUNCHES[attn.KERNEL]
    o_d, g_d = grads(lambda a, b, c: dense_attention(torch, a, b, c, True))
    fwd_err = float((o_d - o_f).abs().max())
    grad_err = max(float((a - b).abs().max()) for a, b in zip(g_d, g_f))
    g_scale = max(float(g.abs().max()) for g in g_d)
    ok = (np.isfinite(fwd_err) and np.isfinite(grad_err) and fwd_err < tol
          and grad_err < max(2 * tol * g_scale, 1e-7))
    log(f"[attention] gradient check, flash_attention vs dense through "
        f"autograd, S={q.shape[0]} D={q.shape[1]} f32 causal: fwd max abs "
        f"err {fwd_err:.3e}, grad max abs err {grad_err:.3e}, grad scale "
        f"{g_scale:.3e}, K5 launches in forward + backward {launches}: "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok or launches != 1:
        raise RuntimeError("flash_attention's gradient check failed (or K5 "
                           "did not launch exactly once)")
    return dict(fwd_err=fwd_err, grad_err=grad_err)


def attention_bound(rate, flop_rate, s_len, dim, causal, itemsize):
    """Least time of one ``flash_attention`` call at ``[s_len, dim]``: the
    unmasked (q, k) pairs' 2 (D + Dv) flops at ``flop_rate``; q, k, v read
    once at input width, the f32 carry read and written once."""
    pairs = s_len * (s_len + 1) // 2 if causal else s_len * s_len
    flops = 2 * pairs * (dim + dim)
    nbytes = 3 * s_len * dim * itemsize + 2 * 4 * (2 * s_len + s_len * dim)
    bytes_ms, flops_ms = nbytes / rate * 1e3, flops / flop_rate * 1e3
    return (max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms
            else "operations", nbytes, flops)


def sdpa_backend(torch, fn) -> str:
    """The name of the kernel that takes most of the device time of one
    ``fn()`` call under torch.profiler (SDPA's backend). When the profiler
    shows no device kernel (a later profiler session in one process may
    record none), the backend the dispatcher chooses for ``fn``'s
    operands, ``fn.sdpa_args``, by name."""
    fn()
    rows, _ = device_rows(torch, fn)
    kernels = [e for e in rows if dev_us(e) > 0 and not e.key.startswith(
        ("Activity", "Memcpy", "Memset"))]
    if kernels:
        return max(kernels, key=dev_us).key
    from torch.nn.attention import SDPBackend
    choice = torch._fused_sdp_choice(*fn.sdpa_args)
    return f"{SDPBackend(choice).name} (the dispatcher's choice)"


def f32_route_times(torch, attn, rate, name) -> dict:
    """The 3xTF32 route at the training shape (S = 8192, D = 128,
    non-causal, the demo's width): ``flash_attention`` with K5 (pre-pass
    included), through the plain version, and SDPA in f32 (TF32 off) as it
    chooses its backend and forced to the memory-efficient one, with the
    backend's kernel named; beside the bound at the TF32 tensor-core rate
    for three products a pair (the route's arithmetic) and at the f32 rate
    outside the tensor cores. Then ``flash_attention`` at the causal bench
    shape in f32 beside SDPA."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q, k, v = hop_operands(torch, attn, ATTN_S, ATTN_S, ATTN_D, ATTN_D,
                           torch.float32, "initial", 40)[:3]
    err = check_output(torch, f"f32 route S={ATTN_S} D=Dv={ATTN_D} "
                       "non-causal", attn.flash_attention(q, k, v),
                       attn.flash_attention_reference(q, k, v))
    ms = time_ms(torch, lambda: attn.flash_attention(q, k, v), iters=10)
    plain_ms = time_ms(torch, lambda: attn.flash_attention_reference(q, k, v),
                       iters=10)
    q4, k4, v4 = (t[None, None] for t in (q, k, v))

    def sdpa(causal=False):
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    sdpa.sdpa_args = (q4, k4, v4)
    sdpa_ms = time_ms(torch, sdpa, iters=10)
    backend = sdpa_backend(torch, sdpa)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        sdpa_eff_ms = time_ms(torch, sdpa, iters=10)
    tf32_rate = tensor_rate(name) * TF32_PER_BF16
    f32_rate_ms, _, nbytes, flops = attention_bound(rate, FP32_FLOPS, ATTN_S,
                                                    ATTN_D, False, 4)
    bound_ms, bound_by, _, _ = attention_bound(rate, tf32_rate / 3, ATTN_S,
                                               ATTN_D, False, 4)
    causal_ms = time_ms(torch, lambda: attn.flash_attention(q, k, v,
                                                            causal=True),
                        iters=10)
    sdpa_causal_ms = time_ms(torch, lambda: sdpa(True), iters=10)
    causal_bound = attention_bound(rate, tf32_rate / 3, ATTN_S, ATTN_D, True,
                                   4)[0]
    log(f"[attention] f32 route at the training shape S={ATTN_S} "
        f"D=Dv={ATTN_D} f32 non-causal: flash_attention (K5 "
        f"{attn.route(torch.float32, ATTN_D, ATTN_D)}, pre-pass included) "
        f"{ms:.5f} ms, through the plain hop {plain_ms:.5f} ms, SDPA f32 "
        f"{sdpa_ms:.5f} ms (kernel {backend}), SDPA forced to "
        f"EFFICIENT_ATTENTION {sdpa_eff_ms:.5f} ms; bound {bound_ms:.5f} ms "
        f"({nbytes} bytes, 3 x {flops} flops at the TF32 rate "
        f"{tf32_rate / 1e12:.1f} TFLOP/s, bound by {bound_by}), "
        f"{f32_rate_ms:.5f} ms at the f32 rate; K5 reaches "
        f"{bound_ms / ms:.4f} of its bound, {f32_rate_ms / ms:.4f} of the "
        f"f32-rate one. Causal bench shape f32: flash_attention "
        f"{causal_ms:.5f} ms, SDPA {sdpa_causal_ms:.5f} ms, bound "
        f"{causal_bound:.5f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by,
                bound_f32_rate_ms=f32_rate_ms, sdpa_backend=backend)


def split_diffs(torch, attn, q, k, v) -> int:
    """The 32-bit words in which the pre-pass's planes differ from its
    plain version's on the same q, k, v (-1 when their shapes differ)."""
    got = attn.tf32_split(q, k, v)
    want = attn.tf32_split_reference(q, k, v)
    torch.cuda.synchronize()
    if any(g.shape != w.shape for g, w in zip(got, want)):
        return -1
    return sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
               for g, w in zip(got, want))


def check_output(torch, label, got, want) -> float:
    """``flash_attention``'s f32 output against its plain version's on the
    same inputs: finite, of its shape, within 1e-4 of the plain output's
    largest magnitude (``PERF.md`` §2). Returns the max abs error."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    mag = float(want.abs().max())
    log(f"[attention] {label}: flash_attention vs its plain version max abs "
        f"err {err:.3e} (of {mag:.3e})")
    if got.shape != want.shape or not bool(torch.isfinite(got).all()) \
            or err > 1e-4 * mag:
        raise RuntimeError(f"{label}: flash_attention disagrees with its "
                           "plain version")
    return err


def check_tf32_split(torch, attn, rate) -> dict:
    """The 3xTF32 routes' pre-pass against its plain version, bit for bit:
    ragged shapes for G = 3, 5, 6, 7 and 8 groups of 32 columns (1000 x 72
    q, 777 x 72 k, 777 x 40 v; 300 x 150 q with 261-key k and v of 150,
    130, 180, 200 and 256 columns) holding normal values, both zeros,
    negatives, exact rounding ties of the hi and of the lo part, values
    that round up into the next binade and subnormals; then, at the
    training shape (S = 8192, D = Dv = 128), bit for bit again and its
    device time beside the plain version and the bound (bytes: q, k, v
    read once, their planes written once)."""
    rng = np.random.default_rng(50)

    def edge(rows, cols):
        x = rng.normal(size=(rows, cols)).astype(np.float32)
        bits = x.view(np.uint32)
        n = bits.size
        picks = rng.choice(n, size=6 * (n // 7), replace=False).reshape(6, -1)
        bits.flat[picks[0]] = (bits.flat[picks[0]] & ~np.uint32(0x1FFF)) \
            | np.uint32(0x1000)                      # hi tie
        bits.flat[picks[1]] = (bits.flat[picks[1]] & ~np.uint32(0xFFF)) \
            | np.uint32(0x800)                       # lo tie
        bits.flat[picks[2]] |= np.uint32(0x7FFFFF)   # rounds to 2^(e+1)
        bits.flat[picks[3]] = np.uint32(0x80000000) * (picks[3] % 2)  # +-0
        bits.flat[picks[4]] = (bits.flat[picks[4]] & np.uint32(0x807FFFFF))
        bits.flat[picks[4][::2]] |= np.uint32(0x1000)  # subnormal ties
        bits.flat[picks[5]] ^= np.uint32(0x80000000)   # sign flips
        return torch.from_numpy(x).cuda()

    same, diffs, groups = True, 0, []
    for (sl_q, sl_k, dim, dv) in ((1000, 777, 72, 40), (300, 261, 150, 130),
                                  (300, 261, 150, 180), (300, 261, 150, 200),
                                  (300, 261, 150, 256)):
        n = split_diffs(torch, attn, edge(sl_q, dim), edge(sl_k, dim),
                        edge(sl_k, dv))
        groups.append(attn.tf32_groups(dim, dv))
        same = same and n == 0
        diffs += max(n, 0)
    q, k, v = hop_operands(torch, attn, ATTN_S, ATTN_S, ATTN_D, ATTN_D,
                           torch.float32, "initial", 41)[:3]
    timed_diffs = split_diffs(torch, attn, q, k, v)
    same = same and timed_diffs == 0
    ms = time_ms(torch, lambda: attn.tf32_split(q, k, v))
    plain_ms = time_ms(torch, lambda: attn.tf32_split_reference(q, k, v),
                       iters=10)
    nbytes = 3 * ATTN_S * ATTN_D * 4 * 3
    bound_ms, bound_by = bound(nbytes, 0, rate)
    log(f"[attention] tf32_split: kernel vs plain bit-equal {same} "
        f"({diffs} words differ) on ragged edge values at G = {groups}; at "
        f"S={ATTN_S} D=Dv={ATTN_D}: {timed_diffs} words differ, {ms:.5f} "
        f"ms, plain {plain_ms:.5f} ms, bound "
        f"{bound_ms:.5f} ms ({nbytes} bytes, bound by {bound_by}); reaches "
        f"{bound_ms / ms:.4f} of its bound")
    if not same:
        raise RuntimeError("tf32_split's kernel disagrees with its plain "
                           "version")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def f32_wide_run(torch, attn, rate, name) -> dict:
    """The wide f32 route's run: 3 ``flash_attention`` calls at S = 2048,
    D = Dv = 256, f32, causal (heads wider than ``flash_hop[f32]`` takes),
    launches counted from 0 (3 of ``flash_hop[f32-wide]``, 3 of its
    pre-pass), finite [S, Dv] outputs, the first held to the plain
    version's on the same q, k, v (:func:`check_output`), the pre-pass on
    them bit for bit to its plain version; then the device time of one call
    and of its pre-pass alone beside the plain version, SDPA in f32 and
    the bound at the TF32 rate for three products (the f32-rate bound
    printed beside it)."""
    import torch.nn.functional as F
    s_len, dim = 2048, 256
    q, k, v = hop_operands(torch, attn, s_len, s_len, dim, dim,
                           torch.float32, "initial", 42)[:3]
    attn.LAUNCHES.clear()
    outs = [attn.flash_attention(q, k, v, causal=True) for _ in range(3)]
    torch.cuda.synchronize()
    launches = dict(attn.LAUNCHES)
    if launches.get(attn.F32_WIDE_ROUTE) != 3 or launches.get(
            attn.SPLIT_KERNEL) != 3 or launches.get(
            attn.F32_ROUTE) or not all(
            o.shape == (s_len, dim) and bool(torch.isfinite(o).all())
            for o in outs):
        raise RuntimeError(f"the wide f32 run launched {launches} for 3 "
                           "calls, or its output is not finite [S, Dv]")
    err = check_output(torch, f"wide f32 run S={s_len} D=Dv={dim} causal",
                       outs[0], attn.flash_attention_reference(q, k, v,
                                                               causal=True))
    del outs
    split_words = split_diffs(torch, attn, q, k, v)
    if split_words:
        raise RuntimeError(f"the wide run's pre-pass differs from its plain "
                           f"version in {split_words} words")
    ms = time_ms(torch, lambda: attn.flash_attention(q, k, v, causal=True),
                 iters=10)
    split_ms = time_ms(torch, lambda: attn.tf32_split(q, k, v), iters=10)
    plain_ms = time_ms(torch, lambda: attn.flash_attention_reference(
        q, k, v, causal=True), iters=10)
    q4, k4, v4 = (t[None, None] for t in (q, k, v))
    sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), iters=10)
    bound_ms, bound_by, _, flops = attention_bound(
        rate, tensor_rate(name) * TF32_PER_BF16 / 3, s_len, dim, True, 4)
    f32_rate_ms = attention_bound(rate, FP32_FLOPS, s_len, dim, True, 4)[0]
    log(f"[attention] wide f32 run S={s_len} D=Dv={dim} causal: "
        f"{launches.get(attn.F32_WIDE_ROUTE)} launches of "
        f"{attn.F32_WIDE_ROUTE} and {launches.get(attn.SPLIT_KERNEL)} of "
        f"{attn.SPLIT_KERNEL} in 3 calls, output max abs err {err:.3e}, "
        f"pre-pass bit-equal; flash_attention {ms:.5f} ms "
        f"(pre-pass alone {split_ms:.5f} ms), plain {plain_ms:.5f} ms, SDPA "
        f"f32 {sdpa_ms:.5f} ms; bound {bound_ms:.5f} ms (3 x {flops} flops "
        f"at the TF32 rate), {f32_rate_ms:.5f} ms at the f32 rate; K5 "
        f"reaches {bound_ms / ms:.4f} of its bound")
    return dict(launches=launches[attn.F32_WIDE_ROUTE], max_abs_err=err,
                ms=ms,
                plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_f32_rate_ms=f32_rate_ms)


def check_f32_wide(torch, attn) -> None:
    """Every instance of the wide f32 route against the plain version
    (:func:`check_hop`): G = 5 (Dv 150, D not a multiple of 8), 6 (D 64,
    Dv 180: D <= 128 < Dv), 7 (D 200, Dv 40: Dv <= 128 < D) and 8 (Dv 256,
    16-key tiles; the others take 32-key tiles); ragged and causal at
    G = 7; wholly masked rows and a hop whose two 64-row query tiles are
    each cut into many pieces merged in the launch, at G = 8."""
    f32 = torch.float32
    check_hop(torch, attn, "Dv 150", 1000, 777, 150, 150, f32, False,
              (0, 0), "mid", 30)
    check_hop(torch, attn, "G 6 D 64", 300, 500, 64, 180, f32, True,
              (200, 0), "mid", 36)
    check_hop(torch, attn, "G 7 Dv 40", 300, 500, 200, 40, f32, False,
              (0, 0), "initial", 37)
    check_hop(torch, attn, "ragged", 1000, 777, 200, 200, f32, True,
              (300, 0), "mid", 38)
    check_hop(torch, attn, "masked rows", 256, 256, 256, 256, f32, True,
              (0, 128), "mid", 39, masked_rows=128)
    sched = attn.hop_schedule(128, 4096, 4096, 0, True,
                              attn.tf32_tiles(256, 256)[1],
                              torch.cuda.get_device_properties(0)
                              .multi_processor_count,
                              attn.TF32_WIDE_BLOCK_Q)
    pieces = min(it[4] for it in sched.items)
    if pieces < 3:
        raise RuntimeError("the wide split case cut a query tile into fewer "
                           "than 3 pieces")
    check_hop(torch, attn, f"split ({pieces}+ pieces a tile)", 128, 4096,
              256, 256, f32, True, (4096, 0), "mid", 43)
    check_hop(torch, attn, "Dv 256", 1000, 777, 256, 256, f32, True,
              (300, 0), "mid", 32)


def check_graph_replay(torch, attn) -> None:
    """K5's work list outlives a CUDA graph that captured it: capture one
    hop (a wide f32 one and a bf16 one), call 70 hops of other offsets
    (each a work list of its own), allocate blocks of the captured table's
    own size filled with -1 (were the table freed, the caching allocator
    would hand its block to one of them), replay the graph and compare
    its output with an eager call of the same hop, bit for bit."""
    for label, dim, dtype, seed in (("f32-wide", 256, torch.float32, 44),
                                    ("bf16", 128, torch.bfloat16, 45)):
        bq, bk = (attn.tf32_tiles(dim, dim) if dtype == torch.float32 else
                  (attn.SM90_BLOCK_Q, attn.sm90_tiles(dim, dim)[1]))
        ops = hop_operands(torch, attn, 300, 500, dim, dim, dtype, "mid",
                           seed)
        scale = 1.0 / float(np.sqrt(dim))

        def hop(q_off=400):
            return attn.flash_hop_update_cuda(*ops, q_off, 0, scale, True)

        hop()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            hop()
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            captured = hop()
        cached = len(attn._SCHEDULES)
        table = attn._device_schedule(ops[0].device, 300, 500, 400, 0, True,
                                      bk, bq)[0]
        n_ints, table_ptr = table.numel(), table.data_ptr()
        del table
        if len(attn._SCHEDULES) != cached:
            raise RuntimeError("the graph check did not find the captured "
                               "hop's work list")
        for i in range(70):
            hop(1000 + 7 * i)
        torch.cuda.synchronize()
        junk = [torch.full((n_ints,), -1, dtype=torch.int32, device="cuda")
                for _ in range(4000)]
        reused = any(t.data_ptr() == table_ptr for t in junk)
        graph.replay()
        torch.cuda.synchronize()
        want = hop()
        torch.cuda.synchronize()
        diff = max(float((g - w).abs().max()) for g, w in zip(captured, want))
        log(f"[attention] graph replay ({label}, {attn.route(dtype, dim, dim)}"
            f"): captured one hop with {cached} work lists cached, called 70 "
            f"other hops ({len(attn._SCHEDULES)} cached), allocated "
            f"{len(junk)} blocks of {n_ints} int32 = -1 (one at the captured "
            f"table's address: {reused}); replay vs eager max abs diff "
            f"{diff}")
        if diff != 0.0 or not all(bool(torch.isfinite(t).all())
                                  for t in captured):
            raise RuntimeError(f"a replayed {label} hop disagrees with the "
                               "eager call: its work list was not kept")
        del junk, graph, captured


def check_split(torch, attn, seed) -> dict:
    """A bf16 hop whose query tiles are each cut into at least 3 pieces,
    merged in the launch: 256 query rows (2 tiles) after a 4096-key chunk
    wholly in their past (offsets (4096, 0), causal), a mid-stream
    carry."""
    sched = attn.hop_schedule(256, 4096, 4096, 0, True,
                              attn.sm90_tiles(ATTN_D, ATTN_D)[1],
                              torch.cuda.get_device_properties(0)
                              .multi_processor_count)
    pieces = min(it[4] for it in sched.items)
    log(f"[attention] split case: {len(sched.items)} items on "
        f"{sched.n_cta} CTAs, at least {pieces} pieces per query tile")
    if pieces < 3:
        raise RuntimeError("the split case cut a query tile into fewer than "
                           "3 pieces")
    return check_hop(torch, attn, "split", 256, 4096, ATTN_D, ATTN_D,
                     torch.bfloat16, True, (4096, 0), "mid", seed)


def attention_phase(torch, rate: float, name: str):
    """Phase 6: K5's routes against their plain version, their times beside
    SDPA and their bounds, the bf16 route's main run, the gradient check
    and the training demo. Returns the ``kernels`` entries of the two
    routes."""
    import torch.nn.functional as F

    from gossipy_tpu_torch.examples import demo_ring_attention as demo
    from gossipy_tpu_torch.ops import attention as attn

    bf16, bf16_route = torch.bfloat16, attn.BF16_ROUTE
    f32_route, wide_route = attn.F32_ROUTE, attn.F32_WIDE_ROUTE
    s_len, dim = ATTN_S, ATTN_D
    split = check_tf32_split(torch, attn, rate)
    bench = check_hop(torch, attn, "bench", s_len, s_len, dim, dim, bf16,
                      True, (0, 0), "initial", 21)
    check_hop(torch, attn, "bench-f32", s_len, s_len, dim, dim,
              torch.float32, True, (0, 0), "initial", 22)
    for seed, offs in ((23, (s_len, 0)), (24, (4096, 2048))):
        check_hop(torch, attn, f"mid-stream {offs}", s_len, s_len, dim, dim,
                  bf16, True, offs, "mid", seed)
    for seed, (causal, offs) in enumerate(((False, (0, 0)),
                                           (True, (300, 0))), start=25):
        for dtype in (torch.float32, bf16):
            check_hop(torch, attn, "ragged", 1000, 777, 72, 72, dtype,
                      causal, offs, "mid", seed)
    for dtype in (torch.float32, bf16):
        check_hop(torch, attn, "masked rows", 256, 256, dim, dim, dtype,
                  True, (0, 128), "mid", 27, masked_rows=128)
    check_split(torch, attn, 34)
    # Every instance of each route: the bf16 route's 64-column groups
    # G = 1-4 (128-key tiles up to G = 2, 64-key tiles above: D = 32, 150
    # and 256 here), the 3xTF32 route's 32-column groups G = 1-4 (D = Dv =
    # 32 the demo's own shape, 72 ragged above, 128 the bench cases), the
    # wide f32 route's G = 5-8 (check_f32_wide).
    check_hop(torch, attn, "G 2", 300, 200, 64, 40, torch.float32, True,
              (100, 0), "mid", 35)
    for seed, dtype in enumerate((torch.float32, bf16), start=28):
        check_hop(torch, attn, "demo shape", 256, 256, 32, 32, dtype, False,
                  (0, 0), "initial", seed)
    check_hop(torch, attn, "Dv 150", 1000, 777, 150, 150, bf16, False,
              (0, 0), "mid", 31)
    check_hop(torch, attn, "Dv 256", 1000, 777, 256, 256, bf16, True,
              (300, 0), "mid", 33)
    check_f32_wide(torch, attn)
    check_graph_replay(torch, attn)

    # The bf16 route's main run: flash_attention at the bench shape, as the
    # JAX bench calls it, with the launches counted; then its device time
    # beside the plain version and SDPA, which computes the same function.
    q, k, v = hop_operands(torch, attn, s_len, s_len, dim, dim, bf16,
                           "initial", 21)[:3]
    attn.LAUNCHES.clear()
    outs = [attn.flash_attention(q, k, v, causal=True) for _ in range(3)]
    torch.cuda.synchronize()
    main_launches = attn.LAUNCHES[bf16_route]
    if main_launches != 3 or attn.LAUNCHES[f32_route] or not all(
            o.shape == (s_len, dim) and o.dtype == bf16
            and bool(torch.isfinite(o).all()) for o in outs):
        raise RuntimeError(f"the bf16 route's main run launched "
                           f"{dict(attn.LAUNCHES)} for 3 calls, or its "
                           "output is not finite [S, D] bf16")
    del outs
    fa_ms = time_ms(torch, lambda: attn.flash_attention(q, k, v, causal=True))
    fa_plain_ms = time_ms(torch, lambda: attn.flash_attention_reference(
        q, k, v, causal=True))
    q4, k4, v4 = (t[None, None] for t in (q, k, v))
    sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True))
    sdpa = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)[0, 0]
    fa = attn.flash_attention(q, k, v, causal=True)
    sdpa_diff = float((fa.float() - sdpa.float()).abs().max())
    # Least work at the bf16 tensor-core rate (a bf16 product is exact in
    # f32).
    bound_ms, bound_by, nbytes, flops = attention_bound(
        rate, tensor_rate(name), s_len, dim, True, 2)
    f32_core_ms = flops / FP32_FLOPS * 1e3
    log(f"[attention] bench shape S={s_len} D=Dv={dim} bf16 causal, main "
        f"run: {main_launches} launches of {bf16_route} in 3 calls; "
        f"flash_attention (K5) {fa_ms:.5f} ms, through the plain hop "
        f"{fa_plain_ms:.5f} ms, SDPA {sdpa_ms:.5f} ms (K5 output vs SDPA: "
        f"max abs diff {sdpa_diff:.3e}); bound {bound_ms:.5f} ms ({nbytes} "
        f"bytes, {flops} flops, bound by {bound_by}; {f32_core_ms:.5f} ms "
        f"at the f32 CUDA-core rate); K5 reaches {bound_ms / fa_ms:.4f} of "
        f"its bound")
    del q, k, v, q4, k4, v4, sdpa, fa
    torch.cuda.empty_cache()
    f32 = f32_route_times(torch, attn, rate, name)
    wide = f32_wide_run(torch, attn, rate, name)

    # The gradient check, at the bench shape in f32.
    q, k, v = hop_operands(torch, attn, s_len, s_len, dim, dim, bf16,
                           "initial", 21)[:3]
    attention_parity(torch, attn, q, k, v)
    del q, k, v
    torch.cuda.empty_cache()

    # The training demo at its defaults (f32), K5 once per step.
    attn.LAUNCHES.clear()
    t0 = time.perf_counter()
    rec = demo.run(device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, demo_launches, split_launches = (
        attn.LAUNCHES[attn.KERNEL], attn.LAUNCHES[f32_route],
        attn.LAUNCHES[attn.SPLIT_KERNEL])
    log(f"[attention] demo at its defaults (S=256, D=32, 60 adam steps): "
        f"{json.dumps(rec)}; {wall:.3f} s; K5 launches {launches} "
        f"({demo_launches} of {f32_route}, {attn.LAUNCHES[wide_route]} of "
        f"{wide_route}), {split_launches} of {attn.SPLIT_KERNEL}")
    if not rec["learned"] or launches != 60 or demo_launches != 60 \
            or split_launches != 60 or not (
            np.isfinite(rec["loss_first"]) and np.isfinite(rec["loss_last"])):
        raise RuntimeError("the demo did not learn, or K5's 3xTF32 route and "
                           "its pre-pass did not launch once per step")

    # 3 training steps at the bench width in f32, with K5 and with the
    # plain version: the same losses within 1e-4 relative.
    start, x, tgt = bench_task(torch, demo)
    lk, _ = demo.train(start, x, tgt, 3, attention=attn.flash_attention)
    lp, _ = demo.train(start, x, tgt, 3,
                       attention=attn.flash_attention_reference)
    rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    log(f"[attention] 3 steps at S={s_len} D={dim} f32: losses with K5 {lk}, "
        f"with the plain version {lp}; max rel diff {rel:.3e}")
    if rel > 1e-4 or not all(np.isfinite(lk)):
        raise RuntimeError("training losses with K5 and with the plain "
                           "version disagree")
    replaces = "gossipy_tpu/ops/attention.py:77"
    return [{"name": bf16_route, "route": "cuda",
             "source": "gossipy_tpu_torch/csrc/flash_hop_sm90.cu",
             "replaces": replaces, "launches": main_launches,
             "max_abs_err": bench["max_abs_err"], "ms": fa_ms,
             "plain_ms": fa_plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": sdpa_ms},
            {"name": f32_route, "route": "cuda",
             "source": "gossipy_tpu_torch/csrc/flash_hop_tf32.cu",
             "replaces": replaces, "launches": demo_launches,
             "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
             "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
             "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
             "bound_f32_rate_ms": f32["bound_f32_rate_ms"],
             "library": f32["sdpa_backend"]},
            {"name": attn.SPLIT_KERNEL, "route": "cuda",
             "source": "gossipy_tpu_torch/csrc/flash_hop_tf32.cu",
             "replaces": replaces, "launches": split_launches, **split},
            {"name": wide_route, "route": "cuda",
             "source": "gossipy_tpu_torch/csrc/flash_hop_tf32.cu",
             "replaces": replaces, "launches": wide["launches"],
             "max_abs_err": wide["max_abs_err"], "ms": wide["ms"],
             "plain_ms": wide["plain_ms"], "bound_ms": wide["bound_ms"],
             "bound_by": wide["bound_by"], "library_ms": wide["library_ms"],
             "bound_f32_rate_ms": wide["bound_f32_rate_ms"]}]


def f32_wide_times(torch, attn, rate, name) -> None:
    """The wide f32 route at S = 8192, D = Dv = 256, f32, non-causal and
    causal: ``flash_attention`` (pre-pass included) beside SDPA in f32 and
    the bound at the TF32 rate for three products."""
    import torch.nn.functional as F
    tf32_rate = tensor_rate(name) * TF32_PER_BF16
    q, k, v = hop_operands(torch, attn, ATTN_S, ATTN_S, 256, 256,
                           torch.float32, "initial", 46)[:3]
    q4, k4, v4 = (t[None, None] for t in (q, k, v))
    for causal in (False, True):
        ms = time_ms(torch, lambda: attn.flash_attention(q, k, v,
                                                         causal=causal),
                     iters=10)
        sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal), iters=10)
        bound_ms = attention_bound(rate, tf32_rate / 3, ATTN_S, 256, causal,
                                   4)[0]
        log(f"[diagnostics] wide f32 S={ATTN_S} D=Dv=256 causal={causal}: "
            f"flash_attention ({attn.route(torch.float32, 256, 256)}) "
            f"{ms:.5f} ms, SDPA f32 {sdpa_ms:.5f} ms; bound {bound_ms:.5f} ms,"
            f" K5 reaches {bound_ms / ms:.4f} of it")


def bench_task(torch, demo):
    """The demo's task and initial params at the bench width (S = 8192,
    D = 128, f32) on the card: ``(params, x, target)``."""
    x_np, tgt_np, rng = demo.make_task(ATTN_S, ATTN_D, 5)
    start = demo.params_from_numpy(demo.init_params(ATTN_D, rng), "cuda")
    return start, torch.from_numpy(x_np).cuda(), torch.from_numpy(tgt_np).cuda()


def attention_diagnostics(torch) -> None:
    """Where K5's time goes, at the bench shape; not part of the smoke run.
    Run on the card after :func:`attention_phase` has held K5 to its plain
    version (``python3 -c "import torch, chip_smoke as cs;
    cs.attention_diagnostics(torch)"``). Prints the device time of the bare
    bf16 hop (K5 and plain), of causal and non-causal ``flash_attention``
    with the bf16 route and SDPA, and their non-causal/causal ratios (twice
    the pairs: a balanced causal schedule takes about half the non-causal
    time); the 3xTF32 route at the training shape beside SDPA in f32, its
    pre-pass alone and its bare hop (causal and not); the wide f32 route at
    S = 8192, D = 256 beside SDPA in f32 (:func:`f32_wide_times`); the
    host-clock time and peak memory of 3
    training steps at S = 8192, D = 128, f32, in turns plain, K5, K5,
    plain (so neither side alone pays the first use of the backward's
    shapes); and one profiled step with K5."""
    import torch.nn.functional as F

    from gossipy_tpu_torch.examples import demo_ring_attention as demo
    from gossipy_tpu_torch.ops import attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False
    s_len, dim = ATTN_S, ATTN_D
    name = torch.cuda.get_device_name(0)
    log(f"[diagnostics] {nvidia_smi_line()}")
    q, k, v, m, l, acc = hop_operands(torch, attn, s_len, s_len, dim, dim,
                                      torch.bfloat16, "initial", 21)
    scale = 1.0 / float(np.sqrt(dim))
    hop_ms = time_ms(torch, lambda: attn.flash_hop_update_cuda(
        q, k, v, m, l, acc, 0, 0, scale, True))
    hop_plain_ms = time_ms(torch, lambda: attn.flash_hop_update_reference(
        q, k, v, m, l, acc, 0, 0, scale, True))
    q4, k4, v4 = (t[None, None] for t in (q, k, v))
    times = {}
    for causal in (True, False):
        times[causal] = (
            time_ms(torch, lambda: attn.flash_attention(q, k, v,
                                                        causal=causal)),
            time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal)))
    (fa_c, sd_c), (fa_n, sd_n) = times[True], times[False]
    bound_n = attention_bound(memory_rate(name), tensor_rate(name), s_len,
                              dim, False, 2)[0]
    log(f"[diagnostics] S={s_len} D=Dv={dim} bf16: causal hop alone, K5 "
        f"{hop_ms:.5f} ms, plain {hop_plain_ms:.5f} ms; flash_attention "
        f"(K5 {attn.BF16_ROUTE}) causal {fa_c:.5f} ms, "
        f"non-causal {fa_n:.5f} ms (bound {bound_n:.5f}, reaches "
        f"{bound_n / fa_n:.4f}), non-causal/causal {fa_n / fa_c:.3f}; SDPA "
        f"causal {sd_c:.5f} ms, non-causal {sd_n:.5f} ms, ratio "
        f"{sd_n / sd_c:.3f}")
    del q, k, v, m, l, acc, q4, k4, v4
    torch.cuda.empty_cache()
    f32_route_times(torch, attn, memory_rate(name), name)
    # The 3xTF32 route's parts at the training shape: the pre-pass alone,
    # the bare hop (pre-pass and hop kernel, no carry fills or division).
    q, k, v, m, l, acc = hop_operands(torch, attn, s_len, s_len, dim, dim,
                                      torch.float32, "initial", 40)
    split_ms = time_ms(torch, lambda: attn.tf32_split(q, k, v))
    hop32_ms = time_ms(torch, lambda: attn.flash_hop_update_cuda(
        q, k, v, m, l, acc, 0, 0, scale, False), iters=10)
    hop32_c_ms = time_ms(torch, lambda: attn.flash_hop_update_cuda(
        q, k, v, m, l, acc, 0, 0, scale, True), iters=10)
    log(f"[diagnostics] S={s_len} D=Dv={dim} f32, {attn.F32_ROUTE}: "
        f"pre-pass {split_ms:.5f} ms; hop (pre-pass included) non-causal "
        f"{hop32_ms:.5f} ms, causal {hop32_c_ms:.5f} ms")
    del q, k, v, m, l, acc
    torch.cuda.empty_cache()
    f32_wide_times(torch, attn, memory_rate(name), name)

    start, x, tgt = bench_task(torch, demo)

    def steps(attention):
        """3 steps; host-clock ms per step and peak device GiB."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        demo.train(start, x, tgt, 3, attention=attention)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) / 3 * 1e3,
                torch.cuda.max_memory_allocated() / 2 ** 30)

    runs = [steps(f) for f in (attn.flash_attention_reference,
                               attn.flash_attention, attn.flash_attention,
                               attn.flash_attention_reference)]
    log(f"[diagnostics] 3 steps at S={s_len} D={dim} f32, host-clock ms/step "
        f"(forward, backward and adam) in turns plain, K5, K5, plain: "
        f"{', '.join(f'{r[0]:.3f}' for r in runs)}; peak memory "
        f"{', '.join(f'{r[1]:.2f}' for r in runs)} GiB")
    profile(torch, lambda: demo.train(start, x, tgt, 1),
            f"one training step with K5 at S={s_len} D={dim} f32")



# -- phase 18: the parallel layer on a virtual mesh ----------------------------

MESH_POSITIONS = 4          # a virtual mesh of 4 positions on cuda:0
MESH_ROUNDS = 20            # (b): the engine's mesh= run
MESH_A2A_ROUNDS = 10        # (c)
MESH_TOL = (1e-5, 1e-4)     # (abs, rel): the composed form's reassociation
                            # (tests/test_parallel.py:179-227)


def virtual_mesh(device, n: int = MESH_POSITIONS):
    from gossipy_tpu_torch import parallel
    return parallel.make_mesh(n, devices=[device] * n)


def within(a, b, tol=MESH_TOL) -> float:
    """The worst margin of ``|a - b| <= abs + rel |b|`` (<= 0 passes)."""
    return float(((a - b).abs() - tol[0] - tol[1] * b.abs()).max())


def sharded_merge_check(torch, merge, label, n, f, k, seed, rate) -> dict:
    """Phase 18 (a) at one shape: ``sharded_gather_merge_multi`` on a
    4-position virtual mesh, K1 on every hop, bit-equal to the same ring
    with K1's plain version on every hop, within MESH_TOL of the unsharded
    K1 call; device ms a call of the ring (K1 and its plain ring) and of
    the unsharded call, launches a call, and the bound of the work (that
    of the unsharded call: the same function)."""
    from gossipy_tpu_torch.parallel import collectives as coll
    mesh = virtual_mesh("cuda")
    d = 2
    rng = np.random.default_rng(seed)
    idx, ws, wp = merge_tables(rng, n, d, k)
    p = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).cuda()
    h = torch.from_numpy(rng.normal(size=(d, n, f)).astype(np.float32)).cuda()
    idx_t, ws_t, wp_t = (torch.from_numpy(a).cuda() for a in (idx, ws, wp))

    def ring(fold):
        return coll._sharded_merge(p, h, idx_t, ws_t, wp_t, mesh, None, None,
                                   None, fold)

    def kernel_ring():
        return coll.sharded_gather_merge_multi(p, h, idx_t, ws_t, wp_t, mesh)

    def flat():
        return merge.gather_merge_multi(p, h.view(d * n, f), idx_t, ws_t,
                                        wp_t)

    merge.reset_launch_counts()
    got = kernel_ring()
    torch.cuda.synchronize()
    launches = dict(merge.LAUNCHES)
    err = check_equal(torch, f"K1 ring {label}", got,
                      ring(merge.gather_merge_multi_reference),
                      (n, d * n, f, k, MESH_POSITIONS))
    want = flat()
    worst = within(got, want)
    on = wp != 0
    rows = len(np.unique(idx[on]))
    nbytes = 4 * f * 2 * n + 4 * f * rows + n * k * (8 + 4 + 4)
    flops = f * (3 * int(on.sum()) + 2 * (n * k - int(on.sum())))
    bound_ms, bound_by = bound(nbytes, flops, rate)
    out = dict(max_abs_err=err, max_abs_err_vs_unsharded=float(
        (got - want).abs().max()), margin_vs_unsharded=worst,
        launches_per_call=launches.get(merge.KERNEL, 0),
        positions=MESH_POSITIONS, rows_per_position=n // MESH_POSITIONS,
        ms=time_ms(torch, kernel_ring),
        plain_ms=time_ms(torch, lambda: ring(
            merge.gather_merge_multi_reference)),
        unsharded_ms=time_ms(torch, flat), unsharded_launches=1,
        bound_ms=bound_ms, bound_by=bound_by)
    log(f"[parallel] (a) {label}: sharded_gather_merge_multi n={n} f={f} "
        f"k={k} on {MESH_POSITIONS} positions ({n // MESH_POSITIONS} rows "
        f"each): K1 ring vs plain ring max_abs_err={err}; vs the unsharded "
        f"K1 call max abs diff {out['max_abs_err_vs_unsharded']:.3e}, "
        f"margin {worst:.3e} (<= 0 passes); launches {launches} a call "
        f"(one unsharded); ms ring {out['ms']:.5f}, plain ring "
        f"{out['plain_ms']:.5f}, unsharded {out['unsharded_ms']:.5f}, bound "
        f"{bound_ms:.5f} ({bound_by})")
    if worst > 0 or launches != {merge.KERNEL: MESH_POSITIONS ** 2}:
        raise RuntimeError(f"K1 ring {label}: off the unsharded call or "
                           f"launched {launches}")
    return out


def mesh_config_run(torch, merge, device, mesh, wire="float32",
                    rounds=MESH_ROUNDS):
    """``spambase_100.json`` at full width on ``device`` (``mesh``: the
    sharded fused deliver, else the unsharded K1 one), ``rounds`` rounds
    from the config's seed: ``(sim, state, report, wall s, launches)``."""
    from gossipy_tpu_torch import parallel, set_seed
    from gossipy_tpu_torch.config import build_experiment
    cfg = load_config("spambase_100", n_rounds=rounds, simulator_params={
        "fused_merge": "multi", "history_dtype": wire})
    gen = set_seed(cfg.seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the offline stand-in's note
        sim, _ = build_experiment(cfg, device=device, mesh=mesh)
    state = sim.init_nodes(gen)
    if mesh is not None:
        state = parallel.shard_state(state, mesh)
    if device == "cuda":
        torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=rounds)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return sim, state, rep, wall, {k: v for k, v in merge.LAUNCHES.items()
                                   if v}


def mesh_engine_check(torch, merge, ns_k1_rps) -> dict:
    """Phase 18 (b): ``GossipSimulator(mesh=)`` on ``spambase_100.json``
    at full width, MESH_ROUNDS rounds: the card against the same virtual
    mesh on the CPU (phase 7's rule, accounting exact), against the
    card's unsharded K1 run (sent and failed equal, params within
    MESH_TOL, accuracy within 1e-4), its rounds/s beside phase 7's K1
    leg, and one bf16-ring run (widened before the ring: K1 on every hop,
    no K2) against the unsharded bf16 run (K2)."""
    runs = {}
    for tag, device, sharded, wire in (
            ("card", "cuda", True, "float32"), ("cpu", "cpu", True,
                                                "float32"),
            ("flat", "cuda", False, "float32"),
            ("card-bf16", "cuda", True, "bfloat16"),
            ("flat-bf16", "cuda", False, "bfloat16")):
        mesh = virtual_mesh(device) if sharded else None
        runs[tag] = mesh_config_run(torch, merge, device, mesh, wire)
    sim, st_g, r_g, wall, l_g = runs["card"]
    _, st_c, r_c, _, l_c = runs["cpu"]
    check_same_accounting(torch, "mesh card vs CPU", st_c, st_g, r_c, r_g)
    tol = REF_TOL + ring_step(torch, sim, st_c, "float32")
    cpu_margin = float(((st_c.model.params - st_g.model.params.cpu()).abs()
                        - tol).max())
    with_msgs = int(((r_g.compact_slots_per_round
                      + r_g.wide_slots_per_round) > 0).sum())
    want = {merge.KERNEL: with_msgs * MESH_POSITIONS ** 2}
    if cpu_margin > 0 or l_c or l_g != want:
        raise RuntimeError(f"mesh run: card vs CPU margin {cpu_margin}, "
                           f"launches card {l_g} (want {want}), CPU {l_c}")
    out = {"rounds": MESH_ROUNDS, "launches": l_g,
           "rounds_per_s": MESH_ROUNDS / wall, "cpu_margin": cpu_margin,
           "northstar_k1_rounds_per_s": ns_k1_rps}
    for tag, flat_tag in (("card", "flat"), ("card-bf16", "flat-bf16")):
        _, st_s, r_s, wall_s, l_s = runs[tag]
        _, st_f, r_f, wall_f, l_f = runs[flat_tag]
        # A bf16 ring adds one encoding step: a merged value within
        # rounding of a bf16 boundary encodes one step apart.
        step = ring_step(torch, sim, st_f, "bfloat16" if "bf16" in tag
                         else "float32")
        margin = float(((st_s.model.params - st_f.model.params).abs()
                        - MESH_TOL[0] - MESH_TOL[1] * st_f.model.params.abs()
                        - step).max())
        acc_diff = abs(r_s.final("accuracy") - r_f.final("accuracy")) \
            if tag == "card" else 0.0
        same = (np.array_equal(r_s.sent_per_round, r_f.sent_per_round)
                and np.array_equal(r_s.failed_per_round, r_f.failed_per_round))
        log(f"[parallel] (b) {tag}: spambase_100.json, {MESH_ROUNDS} rounds "
            f"on {MESH_POSITIONS} positions: {MESH_ROUNDS / wall_s:.2f} "
            f"rounds/s (unsharded {MESH_ROUNDS / wall_f:.2f}; phase 7's K1 "
            f"leg {ns_k1_rps:.2f}); sent {int(r_s.sent_per_round.sum())} "
            f"failed {int(r_s.failed_per_round.sum())} (unsharded "
            f"{int(r_f.sent_per_round.sum())}, "
            f"{int(r_f.failed_per_round.sum())}); params vs unsharded max "
            f"abs diff {float((st_s.model.params - st_f.model.params).abs().max()):.3e}"
            f", margin {margin:.3e}; accuracy {r_s.final('accuracy')} vs "
            f"{r_f.final('accuracy')}; launches {l_s} (unsharded {l_f})")
        if not same or margin > 0 or acc_diff > 1e-4 or set(l_s) != {
                merge.KERNEL}:
            raise RuntimeError(f"mesh run {tag}: off the unsharded run")
        out[tag] = {"rounds_per_s": MESH_ROUNDS / wall_s,
                    "unsharded_rounds_per_s": MESH_ROUNDS / wall_f,
                    "margin": margin, "accuracy": r_s.final("accuracy"),
                    "launches": l_s, "unsharded_launches": l_f}
    log(f"[parallel] (b) card vs CPU on the virtual mesh: accounting equal, "
        f"params margin {cpu_margin:.3e} (<= 0 passes)")
    return out


def mesh_all2all_check(torch, merge) -> dict:
    """Phase 18 (c): ``All2AllGossipSimulator(mesh=, ring_mix=True)`` at
    the ``main_all2all`` twin's width (100 nodes, uniform mixing) against
    the dense mix from the same seeds: accounting equal, params within
    MESH_TOL; no merge kernel launches (the mix is a product)."""
    from gossipy_tpu_torch.examples import main_all2all as a2a
    stacked, dim = a2a.all2all_data(100)
    mesh = virtual_mesh("cuda")
    runs = {}
    for ring in (False, True):
        sim = a2a.all2all_sim(stacked, dim, device="cuda", mesh=mesh,
                              ring_mix=ring)
        state = sim.init_nodes(torch.Generator().manual_seed(42))
        merge.reset_launch_counts()
        t0 = time.perf_counter()
        state, rep = sim.start(state, n_rounds=MESH_A2A_ROUNDS)
        torch.cuda.synchronize()
        runs[ring] = (state, rep, time.perf_counter() - t0,
                      {k: v for k, v in merge.LAUNCHES.items() if v})
    (st_d, r_d, w_d, l_d), (st_r, r_r, w_r, l_r) = runs[False], runs[True]
    margin = within(st_r.model.params, st_d.model.params)
    same = all(np.array_equal(getattr(r_d, f), getattr(r_r, f)) for f in (
        "sent_per_round", "failed_per_round"))
    log(f"[parallel] (c) All2All ring_mix=True, 100 nodes on "
        f"{MESH_POSITIONS} positions, {MESH_A2A_ROUNDS} rounds: "
        f"{w_r / MESH_A2A_ROUNDS * 1e3:.3f} ms/round (dense "
        f"{w_d / MESH_A2A_ROUNDS * 1e3:.3f}); sent "
        f"{int(r_r.sent_per_round.sum())} (dense "
        f"{int(r_d.sent_per_round.sum())}); params vs dense margin "
        f"{margin:.3e}; accuracy {r_r.final('accuracy')} vs "
        f"{r_d.final('accuracy')}; launches {l_r}")
    if not same or margin > 0 or l_r or l_d:
        raise RuntimeError("All2All ring_mix: off the dense mix")
    return {"margin": margin, "ms_per_round": w_r / MESH_A2A_ROUNDS * 1e3}


def ring_attention_check(torch, rate, name) -> dict:
    """Phase 18 (d): ``ring_attention(flash=True)`` on a 4-position virtual
    mesh at S = ATTN_S, D = Dv = ATTN_D, in f32 (the 3xTF32 route) and
    bf16, causal and not, against the unsharded ``flash_attention`` on the
    card (f32 within 1e-4 of the output's largest magnitude; bf16 within
    one bf16 step at each row's largest magnitude); the gradients of q, k
    and v through the ring in f32 against the unsharded ones, both
    pulled back from one fixed upstream gradient of unit scale, within
    1e-3 of the gradients' largest magnitude (a zero or wrong gradient
    through the ring is off by that magnitude); device ms a call,
    launches a call
    (counts set to 0 just before), beside the unsharded call and the
    bound of the work."""
    from gossipy_tpu_torch.ops import attention as attn
    from gossipy_tpu_torch.parallel.collectives import ring_attention
    mesh = virtual_mesh("cuda")
    s_len, dim = ATTN_S, ATTN_D
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        route = attn.route(dtype, dim, dim)
        q, k, v = hop_operands(torch, attn, s_len, s_len, dim, dim, dtype,
                               "initial", 50)[:3]
        for causal in (False, True):
            attn.LAUNCHES.clear()
            got = ring_attention(q, k, v, mesh, causal=causal, flash=True)
            torch.cuda.synchronize()
            launches = {kk: v_ for kk, v_ in attn.LAUNCHES.items() if v_}
            want = attn.flash_attention(q, k, v, causal=causal)
            if dtype == torch.bfloat16:
                err = bf16_steps(torch, got, want)
                ok = err <= 1.0
            else:
                err = float((got - want).abs().max())
                ok = err <= 1e-4 * float(want.abs().max())
            hops = MESH_POSITIONS ** 2
            want_l = {attn.KERNEL: hops, route: hops}
            if dtype == torch.float32:
                want_l[attn.SPLIT_KERNEL] = hops
            ms = time_ms(torch, lambda: ring_attention(
                q, k, v, mesh, causal=causal, flash=True), reps=4, iters=10)
            flat_ms = time_ms(torch, lambda: attn.flash_attention(
                q, k, v, causal=causal), reps=4, iters=10)
            flop_rate = tensor_rate(name) * (
                1.0 if dtype == torch.bfloat16 else TF32_PER_BF16 / 3)
            bound_ms, bound_by = attention_bound(
                rate, flop_rate, s_len, dim, causal,
                2 if dtype == torch.bfloat16 else 4)[:2]
            key = f"{route}{'-causal' if causal else ''}"
            out[key] = dict(route=route, causal=causal, err=err,
                            launches_per_call=launches, ms=ms,
                            unsharded_ms=flat_ms, bound_ms=bound_ms,
                            bound_by=bound_by, positions=MESH_POSITIONS)
            log(f"[parallel] (d) ring_attention flash=True S={s_len} "
                f"D=Dv={dim} {str(dtype).split('.')[-1]} causal={causal} on "
                f"{MESH_POSITIONS} positions: vs unsharded flash_attention "
                f"{'bf16 steps' if dtype == torch.bfloat16 else 'max abs err'}"
                f" {err:.3e}; launches {launches} a call; {ms:.5f} ms a call"
                f" (unsharded {flat_ms:.5f}); bound {bound_ms:.5f} "
                f"({bound_by})")
            if not ok or launches != want_l or not bool(
                    torch.isfinite(got).all()):
                raise RuntimeError(f"ring_attention {key}: off the unsharded "
                                   f"call or launched {launches}")
        del q, k, v
        torch.cuda.empty_cache()
    q, k, v = hop_operands(torch, attn, s_len, s_len, dim, dim,
                           torch.float32, "initial", 51)[:3]
    g_out = torch.randn(s_len, dim, generator=torch.Generator().manual_seed(
        52)).cuda()
    for causal in (False, True):
        def grads(fn):
            inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
            return torch.autograd.grad(fn(*inputs), inputs, g_out)
        attn.LAUNCHES.clear()
        g_r = grads(lambda a, b, c: ring_attention(a, b, c, mesh,
                                                   causal=causal, flash=True))
        torch.cuda.synchronize()
        launches = attn.LAUNCHES[attn.KERNEL]
        g_f = grads(lambda a, b, c: attn.flash_attention(a, b, c,
                                                         causal=causal))
        errs = [float((a - b).abs().max()) for a, b in zip(g_r, g_f)]
        scales = [float(g.abs().max()) for g in g_f]
        ok = all(np.isfinite(e) and e < 1e-3 * sc
                 for e, sc in zip(errs, scales))
        log(f"[parallel] (d) gradients of q, k, v through the ring, f32 "
            f"causal={causal}, unit-scale upstream gradient: max abs err "
            + ", ".join(f"{e:.3e} of {sc:.3e}" for e, sc in zip(errs,
                                                                 scales))
            + f" (limit 1e-3 of each scale) vs the unsharded gradients; "
            f"K5 launches in forward + backward {launches}")
        if not ok or launches != MESH_POSITIONS ** 2:
            raise RuntimeError("ring_attention's gradient is off the "
                               "unsharded one")
        out[f"grad{'-causal' if causal else ''}"] = dict(err=errs,
                                                          scale=scales)
        del g_r, g_f
    torch.cuda.empty_cache()
    return out


def ring_demo_check(torch) -> dict:
    """Phase 18 (e): the demo twin with ``--devices 4`` (a virtual mesh of 4
    positions on the card, K5 on every hop) against ``--devices 1``: the
    loss falls and every step's loss agrees within 1e-4 relative."""
    from gossipy_tpu_torch.examples import demo_ring_attention as demo
    from gossipy_tpu_torch.ops import attention as attn
    attn.LAUNCHES.clear()
    ring = demo.run(devices=MESH_POSITIONS, device="cuda")
    launches = attn.LAUNCHES[attn.KERNEL]
    one = demo.run(devices=1, device="cuda")
    x_np, tgt_np, rng = demo.make_task(256, 32, 42)
    params = demo.params_from_numpy(demo.init_params(32, rng), "cuda")
    x, tgt = torch.from_numpy(x_np).cuda(), torch.from_numpy(tgt_np).cuda()
    l4, _ = demo.train(params, x, tgt, 10, attention=demo.ring_attention_on(
        MESH_POSITIONS, "cuda"))
    l1, _ = demo.train(params, x, tgt, 10)
    rel = max(abs(a - b) / abs(b) for a, b in zip(l4, l1))
    log(f"[parallel] (e) demo --devices {MESH_POSITIONS}: {json.dumps(ring)}"
        f"; --devices 1: {json.dumps(one)}; K5 launches "
        f"{launches} in 60 steps; 10 steps' losses max rel diff {rel:.3e}")
    if not ring["learned"] or rel > 1e-4 or launches != 60 * \
            MESH_POSITIONS ** 2:
        raise RuntimeError("the ring demo did not learn, or it is off the "
                           "one-device demo")
    return {"launches": launches, "rel": rel}


# Phase 19: the analysis layer and the forensic twins.
LADDER_RUNGS = (1_000, 10_000, 100_000)
LADDER_RUNG_ROUNDS = 5
FAIL_RUNGS = (1_000, 2_000)          # the --fail-at run fails the second
MICRO_REPS = 10
BASELINE_EPOCHS = 2
BASELINE_MIN_ACC = 0.8               # the spambase stand-in's Bayes: 0.90
BASELINE_METRIC_TOL = 1e-3


def _counted(merge, label: str, fn, need: tuple = ()) -> tuple:
    """Run ``fn()`` with the launch counts set to 0 just before and read
    just after; ``LAUNCHES`` must equal the kernel-entry log for every
    kernel, and every kernel in ``need`` must have launched. Returns
    ``(fn's result, {kernel: launches})``."""
    from gossipy_tpu_torch.analysis import program
    merge.reset_launch_counts()
    out = fn()
    launches = {k: merge.LAUNCHES[k] for k in program.kernel_ids()
                if merge.LAUNCHES[k]}
    bad = program.launch_mismatches()
    if bad:
        raise RuntimeError(f"{label}: LAUNCHES != kernel entries {bad}")
    missing = [k for k in need if not launches.get(k)]
    if missing:
        raise RuntimeError(f"{label}: {missing} never launched")
    log(f"[analysis] {label}: launches {launches} (= kernel entries)")
    return out, launches


def analysis_gate(torch, merge, tmp: str) -> dict:
    """(a): the program gate on the card."""
    from gossipy_tpu_torch.examples import program_gate
    path = os.path.join(tmp, "gate.json")
    rc, launches = _counted(
        merge, "(a) program gate",
        lambda: program_gate.main(["--report", path]), (merge.KERNEL,))
    report = json.loads(open(path).read())
    if rc != 0:
        raise RuntimeError(f"(a) program gate failed: {report['failures']}")
    return {"launches": launches, "report": report}


def analysis_fused(torch, merge, tmp: str) -> dict:
    """(b): the fused smoke (K1 and K2)."""
    from gossipy_tpu_torch.examples import fused_smoke
    out = os.path.join(tmp, "fused")
    rc, launches = _counted(
        merge, "(b) fused smoke",
        lambda: fused_smoke.main(["--out", out, "--ledger",
                                  os.path.join(tmp, "ledger.jsonl")]),
        (merge.KERNEL, merge.KERNEL_MULTI_DQ))
    report = json.loads(open(os.path.join(out, "fused_smoke.json")).read())
    if rc != 0:
        raise RuntimeError(f"(b) fused smoke failed: {report['failures']}")
    log(f"[analysis] (b) parity {json.dumps(report['parity'])}")
    log(f"[analysis] (b) deliver A/B "
        f"{json.dumps(report['ab']['raw']['deliver_ms_per_round'])} ms a "
        f"round ({report['ab']['config']}); train "
        f"{json.dumps(report['ab']['raw']['train_ms_per_round'])}")
    return {"launches": launches, "report": report}


def analysis_ladder(torch, merge, tmp: str) -> dict:
    """(c): the ladder and its --fail-at verdict."""
    from gossipy_tpu_torch.examples import scale_ladder
    out = os.path.join(tmp, "ladder")
    rc, launches = _counted(
        merge, "(c) ladder",
        lambda: scale_ladder.main([
            "--rungs", ",".join(str(n) for n in LADDER_RUNGS),
            "--rounds", str(LADDER_RUNG_ROUNDS), "--out", out]),
        (merge.KERNEL,))
    ladder = json.loads(open(os.path.join(out, "ladder.json")).read())
    if rc != 0:
        raise RuntimeError(f"(c) ladder failed: {ladder['verdict']}")
    for row in ladder["rungs"]:
        p, m = row["predicted"], row["measured"]
        log(f"[analysis] (c) rung {row['n_nodes']}: predicted "
            f"{p['total_bytes']} bytes, {p['flops_per_round']} FLOPs a "
            f"round, {p['ms_per_round']} ms/round; measured "
            f"{m['ms_per_round']:.3f} ms/round, {m['rounds_per_sec']:.2f} "
            f"rounds/s, mfu_est {m['mfu_est']}, peak {m['hbm_peak_bytes']} "
            f"bytes (budget/peak "
            f"{row.get('memory_predicted_over_measured')}; time "
            f"predicted/measured {row.get('time_predicted_over_measured')})")
    for line in open(os.path.join(out, "ladder.md")).read().splitlines():
        log(f"[analysis] (c) {line}")
    fail_out = os.path.join(tmp, "ladder_fail")
    rc = scale_ladder.main([
        "--rungs", ",".join(str(n) for n in FAIL_RUNGS), "--rounds", "3",
        "--out", fail_out, "--fail-at", str(FAIL_RUNGS[-1])])
    verdict = json.loads(open(os.path.join(fail_out, "ladder.json"))
                         .read())["verdict"]
    ok = (rc == 1 and verdict is not None
          and verdict["failed_rung"] == FAIL_RUNGS[-1]
          and verdict["last_healthy_rung"] == FAIL_RUNGS[0]
          and verdict["budget_bytes"] and verdict["peak_bytes"]
          and verdict["bundle"] and os.path.isdir(verdict["bundle"]))
    log(f"[analysis] (c) --fail-at {FAIL_RUNGS[-1]}: rc {rc}, verdict "
        f"rung {verdict and verdict['failed_rung']}, last healthy "
        f"{verdict and verdict['last_healthy_rung']}, budget "
        f"{verdict and verdict['budget_bytes']}, peak "
        f"{verdict and verdict['peak_bytes']}, bundle "
        f"{verdict and verdict['bundle']}")
    if not ok:
        raise RuntimeError(f"(c) the --fail-at verdict is wrong: {verdict}")
    return {"launches": launches, "ladder": ladder, "verdict": verdict}


def analysis_micro(torch) -> dict:
    """(d): the flagship round's components."""
    from gossipy_tpu_torch.examples import microbench_components
    out = microbench_components.run(small=False, reps=MICRO_REPS)
    log(f"[analysis] (d) {json.dumps(out)}")
    comp = out["components"]
    if not all(v is None or (isinstance(v, (int, float)) and v > 0)
               for v in comp.values()):
        raise RuntimeError(f"(d) a component did not time: {comp}")
    return out


def analysis_smokes(torch, merge, tmp: str) -> dict:
    """(e): the chaos smoke and the artifact smoke (and its trip)."""
    from gossipy_tpu_torch.examples import chaos_smoke, ci_smoke_artifact
    rc, chaos_launches = _counted(
        merge, "(e) chaos smoke",
        lambda: chaos_smoke.main(["--out", os.path.join(tmp, "chaos")]),
        (merge.KERNEL,))
    verdict = json.loads(open(os.path.join(tmp, "chaos",
                                           "chaos_verdict.json")).read())
    if rc != 0:
        raise RuntimeError(f"(e) chaos smoke failed: {verdict['checks']}")
    log(f"[analysis] (e) chaos gap {verdict['gap_per_round']}, "
        f"reconverged {verdict['rounds_to_reconverge_after_heal']} "
        "round(s) after the heal")
    art, art_launches = _counted(
        merge, "(e) artifact smoke",
        lambda: ci_smoke_artifact.main(["--out", os.path.join(tmp, "ci")]),
        (merge.KERNEL,))
    trip = os.path.join(tmp, "ci_trip")
    try:
        ci_smoke_artifact.main(["--out", trip, "--poison", "3"])
        code = 0
    except SystemExit as e:
        code = e.code
    bundles = [d for d in os.listdir(trip) if d.startswith("bundle_")]
    log(f"[analysis] (e) artifacts {art}; the poisoned run exited {code} "
        f"with {bundles}")
    if code != 2 or not bundles:
        raise RuntimeError("(e) the poisoned artifact run did not trip and "
                           "write its bundle")
    return {"launches": {"chaos": chaos_launches,
                         "artifact": art_launches}}


def analysis_baseline(torch) -> dict:
    """(f): the baseline MLP on the card and on the CPU."""
    from gossipy_tpu_torch.data import ClassificationDataHandler, \
        load_classification_dataset
    from gossipy_tpu_torch.examples import baseline
    X, y = load_classification_dataset("spambase")
    dh = ClassificationDataHandler(X, y, test_size=0.1, seed=42)
    t0 = time.perf_counter()
    card = baseline.torch_mlp(dh, n_epochs=BASELINE_EPOCHS, seed=42,
                              device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = baseline.torch_mlp(dh, n_epochs=BASELINE_EPOCHS, seed=42,
                             device="cpu")
    cpu_s = time.perf_counter() - t0
    a = card.pop("_state").params.cpu().double()
    b = cpu.pop("_state").params.double()
    err = float((a - b).abs().max())
    tol = REF_TOL + REF_TOL * float(b.abs().max())
    gaps = {k: abs(card[k] - cpu[k]) for k in card}
    log(f"[analysis] (f) baseline MLP, {BASELINE_EPOCHS} epochs: card "
        f"{json.dumps(card)} in {card_s:.2f} s, cpu {json.dumps(cpu)} in "
        f"{cpu_s:.2f} s; params max |card - cpu| {err:.3e} (tol "
        f"{tol:.3e}), metric gaps {json.dumps(gaps)}")
    if card["accuracy"] < BASELINE_MIN_ACC or err > tol or \
            max(gaps.values()) > BASELINE_METRIC_TOL:
        raise RuntimeError("(f) the baseline MLP did not learn, or the card "
                           "and the CPU disagree")
    return {"card": card, "cpu": cpu, "param_err": err}


def analysis_phase(torch, merge) -> dict:
    """Phase 19: (a)-(f). Returns the launches per path of each (kernel,
    ring format)."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p19_")
    timings = {}
    t0 = time.perf_counter()
    gate = analysis_gate(torch, merge, tmp)
    timings["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused = analysis_fused(torch, merge, tmp)
    timings["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ladder = analysis_ladder(torch, merge, tmp)
    timings["c"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    analysis_micro(torch)
    timings["d"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    smokes = analysis_smokes(torch, merge, tmp)
    timings["e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    analysis_baseline(torch)
    timings["f"] = time.perf_counter() - t0
    log(f"[analysis] seconds by part {json.dumps(timings)}")
    k1 = merge.KERNEL
    paths = {(k1, "float32"): {
        "gate": gate["launches"].get(k1, 0),
        "fused-smoke": fused["launches"].get(k1, 0),
        "ladder": ladder["launches"].get(k1, 0),
        "chaos-smoke": smokes["launches"]["chaos"].get(k1, 0),
        "artifact-smoke": smokes["launches"]["artifact"].get(k1, 0)},
        (merge.KERNEL_MULTI_DQ, "int8"): {
        "fused-smoke-int8": fused["launches"].get(merge.KERNEL_MULTI_DQ, 0)}}
    return paths


# Phase 20: the contract entry twin.
ENTRY_DEVICES = 4           # dryrun_multichip(4): a 2 x 2 (nodes, model)
                            # virtual mesh on cuda:0
ENTRY_ACC_TOL = 1e-4
ENTRY_LEGS = ("main", "ring", "sparse", "all2all")


def entry_forward_check(torch) -> dict:
    """Phase 20 (a): ``entry()`` on the card gives finite ``[8, 10]``
    logits on its zeros; on a numpy-seeded batch the card's logits from
    those params against the CPU's from the same params (copied) within
    REF_TOL of the largest |logit|; the CPU ``entry`` makes the same
    params bit for bit."""
    from gossipy_tpu_torch import entry as tentry
    fn, (params, x) = tentry.entry()
    out = fn(params, x)
    torch.cuda.synchronize()
    if tuple(out.shape) != (8, 10) or out.device.type != "cuda" or not bool(
            torch.isfinite(out).all()):
        raise RuntimeError(f"entry(): logits {tuple(out.shape)} on "
                           f"{out.device}, finite {bool(torch.isfinite(out).all())}")
    _, (cpu_params, _) = tentry.entry(device="cpu")
    same = all(torch.equal(params[k].cpu(), cpu_params[k]) for k in params)
    x_np = np.random.default_rng(20).normal(size=(8, 32, 32, 3)).astype(
        np.float32)
    card = fn(params, torch.from_numpy(x_np).cuda()).cpu()
    cpu = fn(cpu_params, torch.from_numpy(x_np))
    err = float((card - cpu).abs().max())
    scale = float(cpu.abs().max())
    log(f"[entry] (a) entry(): fn(*args) {tuple(out.shape)} on {out.device}"
        f", finite; a numpy-seeded batch: card vs CPU logits max abs err "
        f"{err:.3e} of largest |logit| {scale:.3e} (limit {REF_TOL} of "
        f"it); params equal to the CPU entry's: {same}")
    if not same or not err <= REF_TOL * scale:
        raise RuntimeError("entry(): the card's forward step is off the "
                           "CPU's")
    return {"max_abs_err": err, "scale": scale}


def entry_leg_check(torch, merge, name, card_setup, cpu_setup) -> dict:
    """One dryrun leg on the card (counts set to 0 just before and read
    just after) and on the CPU from the same draws and seeds: accounting,
    boxes and ages equal, params within REF_TOL, accuracy within
    ENTRY_ACC_TOL; the ring's card output within REF_TOL of the CPU's.
    On the card every kernel entry launches its kernel, and the card's
    kernel entries equal the CPU's."""
    from gossipy_tpu_torch import entry as tentry
    from gossipy_tpu_torch.analysis import program
    fn = getattr(tentry, f"{name}_leg")
    merge.reset_launch_counts()
    card = fn(card_setup)
    torch.cuda.synchronize()
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    unlaunched = program.launch_mismatches()
    cpu = fn(cpu_setup)
    label = f"entry leg {name}"
    if launches != card.launches or unlaunched:
        raise RuntimeError(f"{label}: counted {launches}, the leg "
                           f"{card.launches}; launches != entries "
                           f"{unlaunched}")
    if name == "ring":
        err = float((card.flash.cpu() - cpu.flash).abs().max())
        margin = err - REF_TOL
        out = {"max_diff_flash_plain": card.max_diff, "card_vs_cpu": err}
        msg = (f"flash vs plain max diff {card.max_diff:.3e} (limit "
               f"{tentry.RING_ATOL}); card vs CPU ring {err:.3e}")
    else:
        check_same_accounting(torch, label, cpu.state, card.state,
                              cpu.report, card.report)
        diff = (card.state.model.params.cpu() - cpu.state.model.params).abs()
        margin = float((diff - REF_TOL).max())
        acc_diff = abs(card.accuracy - cpu.accuracy)
        if acc_diff > ENTRY_ACC_TOL:
            margin = max(margin, acc_diff)
        out = {"accuracy": card.accuracy, "cpu_accuracy": cpu.accuracy,
               "params_max_abs_diff": float(diff.max())}
        msg = (f"accuracy {card.accuracy} (CPU {cpu.accuracy}); sent "
               f"{int(card.report.sent_per_round.sum())}, accounting equal; "
               f"params vs CPU max abs diff {float(diff.max()):.3e} (limit "
               f"{REF_TOL})")
    log(f"[entry] (b) leg {name}: {msg}; launches {launches} (CPU kernel "
        f"entries {cpu.entries})")
    if margin > 0 or card.entries != cpu.entries:
        raise RuntimeError(f"{label}: off the CPU leg or launched "
                           f"{launches} against {cpu.entries} entries")
    out["launches"] = launches
    return out


def entry_phase(torch, merge) -> dict:
    """Phase 20: (a) ``entry()``, (b) ``dryrun_multichip(ENTRY_DEVICES)``
    on a virtual mesh of the card and each of its legs against the same
    leg on the CPU, (c) the API reference generator. Returns the launches
    per path of each (kernel, ring format) and K5 f32's."""
    import tempfile
    from gossipy_tpu_torch import entry as tentry
    from gossipy_tpu_torch.examples import gen_api_docs
    from gossipy_tpu_torch.ops import attention as attn
    timings = {}
    t0 = time.perf_counter()
    entry_forward_check(torch)
    timings["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    merge.reset_launch_counts()
    whole = tentry.dryrun_multichip(ENTRY_DEVICES)
    torch.cuda.synchronize()
    total = {k: v for k, v in merge.LAUNCHES.items() if v}
    log(f"[entry] (b) dryrun_multichip({ENTRY_DEVICES}): {json.dumps(whole)}"
        f"; launches in all {total}")
    card_setup = tentry.dryrun_setup(ENTRY_DEVICES)
    cpu_setup = tentry.dryrun_setup(ENTRY_DEVICES, device="cpu")
    legs = {}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=r"mailbox_slots=")
        for name in ENTRY_LEGS:
            legs[name] = entry_leg_check(torch, merge, name, card_setup,
                                         cpu_setup)
    f32 = attn.route(torch.float32, tentry.RING_DIM, tentry.RING_DIM)
    k1 = merge.KERNEL
    by_leg = {name: (leg["launches"].get(k1, 0),
                     leg["launches"].get(f32, 0))
              for name, leg in legs.items()}
    log(f"[entry] (b) launches by leg (K1, {f32}): "
        + ", ".join(f"{n} {a}, {b}" for n, (a, b) in by_leg.items()))
    if not (by_leg["main"][0] and by_leg["sparse"][0] and by_leg["ring"][1]
            and not any(legs["all2all"]["launches"].values())
            and whole["launches"] == {n: leg["launches"]
                                      for n, leg in legs.items()}):
        raise RuntimeError(f"dryrun: a leg's kernel did not launch, the "
                           f"product leg launched, or the whole dryrun's "
                           f"launches differ from its legs': {by_leg}")
    timings["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p20_") as tmp:
        with contextlib.redirect_stdout(io.StringIO()):
            pages = gen_api_docs.main(out_dir=tmp)
        files = sorted(os.listdir(tmp))
    want = sorted([gen_api_docs.page_name(m) for m in gen_api_docs.MODULES]
                  + ["index.md"])
    log(f"[entry] (c) the API reference: {pages} module pages and the "
        f"index rendered here, no JAX")
    if files != want:
        raise RuntimeError("the API reference did not render every page")
    timings["c"] = time.perf_counter() - t0
    log(f"[entry] seconds by part {json.dumps(timings)}")
    return {(k1, "float32"): {"entry": by_leg["main"][0]
                              + by_leg["sparse"][0]},
            (f32, "float32"): {"entry": by_leg["ring"][1]}}


def parallel_phase(torch, merge, rate, name, ns_k1_rps) -> tuple:
    """Phase 18: (a) K1 on the ring at the north star's and the
    flagship's shapes, (b) the engine's mesh=, (c) All2All's ring_mix,
    (d) K5 on the ring, (e) the ring demo. Returns the launches per path
    of each (kernel, ring format), K1's ``at_sharded_shape`` and K5's
    ``at_ring_shape`` numbers."""
    from gossipy_tpu_torch.handlers import SGDHandler, losses
    from gossipy_tpu_torch.models import CIFAR10Net
    flag_stride = SGDHandler(CIFAR10Net(), losses.cross_entropy,
                             input_shape=(32, 32, 3)).layout.stride
    at_sharded = {
        "northstar": sharded_merge_check(torch, merge, "northstar", NS_NODES,
                                         116, 6, 81, rate),
        "flagship": sharded_merge_check(torch, merge, "flagship", FLAG_NODES,
                                        flag_stride, 6, 82, rate)}
    engine = mesh_engine_check(torch, merge, ns_k1_rps)
    mesh_all2all_check(torch, merge)
    at_ring = ring_attention_check(torch, rate, name)
    ring_demo_check(torch)
    paths = {(merge.KERNEL, "float32"): {
        "mesh-engine": engine["launches"][merge.KERNEL],
        "mesh-engine-bf16": engine["card-bf16"]["launches"][merge.KERNEL]}}
    return paths, at_sharded, at_ring


# -- phase 21: one gossip run across processes ---------------------------------

RANKS = 2                   # processes, both on cuda:0
GRID_RANKS = 4              # (e): the (dcn, nodes) spawn's processes
RANK_NS_ROUNDS = 100        # (a): the north star's timed rounds
RANK_FLAG_ROUNDS = 3        # (b), (d), (e): the CIFAR10Net clique's rounds
RANK_A2A_ROUNDS = 20        # (f): All2All's rounds, each form
RANK_TEL_ROUNDS = 50        # (g): the north star with telemetry on and off
RANK_RING_CALLS = 10        # (c): timed ring calls (host clock)
RANK_CKPT_ROUNDS = 50       # (h): the north star's rounds before the save
RANK_CKPT_SHORT = 10        # (h): the int8 ring's, and after it
RANK_REC_CHUNK = 2          # (i): the flight recorder's chunk
RANK_REC_ROUNDS = 8         # (i): its rounds (the NaN trips the second chunk)
RANK_REC_NAN = (75, 3)      # (i): (node, round) of the NaN: a row of rank 1
RANK_HOST_ROUNDS = 50       # (j): each leg's rounds, in two halves
RANK_TIMEOUT_S = 420        # the ranks' whole run, reaped at the limit
RANK_GROUP_TIMEOUT_S = 300  # a collective that waits longer fails


def split_update(torch, handler, parts: int) -> None:
    """Make ``handler.update`` run its rows in ``parts`` equal batches, one
    call each, as ``parts`` ranks run theirs: the single-process
    reference of a run across ranks for a model whose update rounds by
    its batch count on the card (CIFAR10Net's does; LogReg's does
    not)."""
    from gossipy_tpu_torch.handlers import ModelState
    whole = handler.update

    def update(model, data, perms):
        h = model.params.shape[0] // parts
        outs = [whole(ModelState(
            model.params[i * h:(i + 1) * h],
            tuple(t[i * h:(i + 1) * h] for t in model.opt_state),
            model.n_updates[i * h:(i + 1) * h]),
            tuple(d[i * h:(i + 1) * h] for d in data),
            None if perms is None else perms[i * h:(i + 1) * h])
            for i in range(parts)]
        return ModelState(torch.cat([o.params for o in outs]),
                          tuple(torch.cat(ts) for ts in zip(
                              *[o.opt_state for o in outs])),
                          torch.cat([o.n_updates for o in outs]))

    handler.update = update


def rank_timed(torch, merge, sim, state, rounds) -> dict:
    """``rounds`` rounds of ``sim`` timed (the card synchronised on both
    sides), launch counts and transfers set to 0 just before: what this
    process holds after them (its rows of every leaf, on the host), the
    report, the wall time, the launches and the transfers."""
    from gossipy_tpu_torch.parallel import rules
    from gossipy_tpu_torch.parallel.collectives import TRANSFERS
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    TRANSFERS.clear()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(leaves={p: x.detach().cpu().clone() for p, x in
                        rules.named_leaves(state)
                        if isinstance(x, torch.Tensor)},
                report=rep.to_dict(), wall=wall,
                launches={k: v for k, v in merge.LAUNCHES.items() if v},
                transfers=dict(TRANSFERS))


def tp_mesh(devices):
    """(d): a ``(nodes, model)`` mesh of 2 x 2 positions."""
    from gossipy_tpu_torch import parallel
    return parallel.make_mesh_tp(2, 2, devices=devices)


def grid_mesh(devices):
    """(e): a ``(dcn, nodes)`` mesh of 4 x 2 positions."""
    from gossipy_tpu_torch import parallel
    return parallel.make_mesh_2d(GRID_RANKS, 2, devices=devices)


def rank_positions(per: int) -> list:
    """Every rank's card as ``per`` positions of its own, in rank order."""
    from gossipy_tpu_torch import parallel
    return [parallel.Position(p.device, p.rank, per * p.id + j)
            for p in parallel.devices("cuda:0") for j in range(per)]


def flagship_leg(torch, merge, mesh, split: int = 0) -> dict:
    """Phase 4's 64-node CIFAR10Net clique on ``mesh``: a warm-up round, a
    fresh init, then RANK_FLAG_ROUNDS rounds timed; ``split`` (a virtual
    mesh) runs the update in that many batches (:func:`split_update`)."""
    sim, state = cifar_sim(torch, N_NODES, 64, 32, "cuda",
                           RANK_FLAG_ROUNDS + 1, mesh=mesh)
    if split:
        split_update(torch, sim.handler, split)
    sim.start(state, n_rounds=1)       # warm-up
    state = sim.init_nodes(torch.Generator().manual_seed(0),
                           common_init=True)
    out = rank_timed(torch, merge, sim, state, RANK_FLAG_ROUNDS)
    out.update(mesh=repr(mesh), rows=str(mesh.node_rows(N_NODES)))
    del sim, state
    torch.cuda.empty_cache()
    return out


def all2all_legs(torch, merge, mesh) -> dict:
    """(f): phase 18's All2All twin (100 nodes, uniform mixing) on
    ``mesh`` with ``ring_mix`` on and off: a warm-up round, a fresh init,
    then RANK_A2A_ROUNDS rounds timed, each form."""
    from gossipy_tpu_torch.examples import main_all2all as a2a
    stacked, dim = a2a.all2all_data(100)
    out = {}
    for form in ("ring", "dense"):
        sim = a2a.all2all_sim(stacked, dim, device="cuda", mesh=mesh,
                              ring_mix=form == "ring")
        sim.start(sim.init_nodes(torch.Generator().manual_seed(42)),
                  n_rounds=1)
        state = sim.init_nodes(torch.Generator().manual_seed(42))
        out[form] = rank_timed(torch, merge, sim, state, RANK_A2A_ROUNDS)
    return out


def rank_telemetry_kw() -> dict:
    """(g)'s options: probes, sentinels and a chaos scenario (an outage of
    every node of rank 0, rounds 10-19; a partition into even and odd
    nodes, each component on both ranks, rounds 25-34)."""
    from gossipy_tpu_torch.simulation import ChaosConfig, OutageEpisode, \
        PartitionEpisode
    return dict(probes=True, sentinels=True, chaos=ChaosConfig(
        outages=(OutageEpisode(nodes=tuple(range(NS_NODES // RANKS)),
                               start=10, stop=20),),
        partitions=(PartitionEpisode(components=(
            tuple(range(0, NS_NODES, 2)), tuple(range(1, NS_NODES, 2))),
            start=25, stop=35),), horizon=RANK_TEL_ROUNDS))


def telemetry_legs(torch, merge, mesh) -> dict:
    """(g): the north star on ``mesh`` with :func:`rank_telemetry_kw` and
    a live ``CallbackReceiver`` (``on``), and the same run without them
    (``off``): a 2-round warm-up, a fresh init, RANK_TEL_ROUNDS rounds
    timed; ``on`` keeps the live rows."""
    from gossipy_tpu_torch.simulation import CallbackReceiver
    out = {}
    for label, kw in (("on", rank_telemetry_kw()), ("off", {})):
        sim, state = northstar_sim(torch, "cuda", fused_merge="multi",
                                   mesh=mesh, **kw)
        sim.start(state, n_rounds=2)       # warm-up
        rows: list = []
        if kw:
            sim.add_receiver(CallbackReceiver(rows.append, live=True))
        state = sim.init_nodes(torch.Generator().manual_seed(42))
        out[label] = rank_timed(torch, merge, sim, state, RANK_TEL_ROUNDS)
        out[label]["live"] = json.loads(json.dumps(rows, default=float))
    return out


def state_bytes(torch, state) -> int:
    """The bytes of a state's tensors (this rank's rows on a mesh across
    ranks)."""
    from gossipy_tpu_torch.parallel import rules
    return sum(x.numel() * x.element_size()
               for _, x in rules.named_leaves(state)
               if isinstance(x, torch.Tensor))


def ckpt_legs(torch, merge, mesh, workdir: str) -> dict:
    """(h): the north star on ``mesh`` on a float32 ring (RANK_CKPT_ROUNDS
    rounds, ``sim.save``, RANK_CKPT_ROUNDS more) and an int8 ring
    (RANK_CKPT_SHORT each side): the save timed into ``workdir``
    (``h-ranks-*`` across ranks, ``h-virtual-*`` in one process), then a
    fresh simulator loads a file (timed) and runs the rounds after it,
    counts set to 0 just before (:func:`rank_timed`): across ranks the
    ranks' file and the one the virtual mesh saved (a one-process
    checkpoint). In one process the saving simulator runs on instead
    (the uninterrupted run). Returns, per ring, those runs, the save and
    load ms, the file's bytes, this process's state bytes and the draw
    state at the save."""
    from gossipy_tpu_torch.checkpoint import draw_record
    across = mesh.spans_ranks()
    tag = "ranks" if across else "virtual"
    out = {}
    for ring, rounds in (("float32", RANK_CKPT_ROUNDS),
                         ("int8", RANK_CKPT_SHORT)):
        sim, state = northstar_sim(torch, "cuda", fused_merge="multi",
                                   mesh=mesh, history_dtype=ring)
        state, _ = sim.start(state, n_rounds=rounds)
        path = os.path.join(workdir, f"h-{tag}-{ring}.pt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.save(path, state)
        leg = dict(save_ms=(time.perf_counter() - t0) * 1e3,
                   file_bytes=os.path.getsize(path),
                   rank_bytes=state_bytes(torch, state),
                   draws=draw_record(sim.draws))
        if not across:
            leg["straight"] = rank_timed(torch, merge, sim, state, rounds)
            out[ring] = leg
            continue
        del sim, state
        for src in ("ranks", "virtual"):
            fresh, _ = northstar_sim(torch, "cuda", fused_merge="multi",
                                     mesh=mesh, history_dtype=ring)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = fresh.load(os.path.join(workdir, f"h-{src}-{ring}.pt"))
            torch.cuda.synchronize()
            leg[f"load_ms_{src}"] = (time.perf_counter() - t0) * 1e3
            leg[src] = rank_timed(torch, merge, fresh, st, rounds)
            del fresh, st
        out[ring] = leg
        torch.cuda.empty_cache()
    return out


def recorder_leg(torch, merge, mesh, workdir: str) -> dict:
    """(i): the north star on ``mesh`` with sentinels and a NaN written
    into node RANK_REC_NAN[0] (a row of rank 1) before round
    RANK_REC_NAN[1], under ``FlightRecorder(chunk=RANK_REC_CHUNK)`` for
    RANK_REC_ROUNDS rounds (counts set to 0 just before): the bundle, the
    chunks run, the recorder's gathers and their ms, the wall time, the
    launches and the chunks' report."""
    from gossipy_tpu_torch.simulation import SimulationReport
    from gossipy_tpu_torch.telemetry import FlightRecorder
    tag = "ranks" if mesh.spans_ranks() else "virtual"
    sim, state = northstar_sim(torch, "cuda", fused_merge="multi",
                               mesh=mesh, sentinels=True)
    poison(sim, *RANK_REC_NAN)
    rec = FlightRecorder(os.path.join(workdir, f"i-{tag}"),
                         chunk=RANK_REC_CHUNK)
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    _, reports, bundle = rec.run(sim, state, RANK_REC_ROUNDS)
    torch.cuda.synchronize()
    return dict(bundle=bundle, chunks=len(reports), gathers=rec.gathers,
                gather_ms=rec.gather_seconds * 1e3,
                wall=time.perf_counter() - t0,
                launches={k: v for k, v in merge.LAUNCHES.items() if v},
                report=SimulationReport.concatenate(reports).to_dict())


def host_legs(torch, merge, mesh, workdir: str) -> dict:
    """(j): the north star on ``mesh`` with ``perf=``, ``metrics=`` (into
    a registry of its own), ``ledger=`` (a file in ``workdir``) and
    ``tracing=`` all on, and the same run with all four off, each
    RANK_HOST_ROUNDS rounds in two halves, the legs in order and then in
    reverse (as :func:`telemetry_timed` times them), the card
    synchronised before each half's clock stops. Returns, per leg, the
    wall time, the launches, this rank's rows, the report without its
    timing rows; for ``on`` the perf summary, the engine counters, the
    trace and the manifest's backend block."""
    from gossipy_tpu_torch.simulation import SimulationReport
    from gossipy_tpu_torch.telemetry import MetricsRegistry, Tracer, metrics
    from gossipy_tpu_torch.parallel import rules
    tag = "ranks" if mesh.spans_ranks() else "virtual"
    prev = metrics.set_registry(MetricsRegistry())
    try:
        tracer = Tracer()
        legs = {}
        for label, kw in (("on", dict(
                perf=True, metrics=True, tracing=tracer,
                ledger=os.path.join(workdir, f"j-{tag}.jsonl"))),
                          ("off", {})):
            sim, state = northstar_sim(torch, "cuda", fused_merge="multi",
                                       mesh=mesh, **kw)
            legs[label] = dict(sim=sim, state=state, wall=0.0, launches={},
                               reports=[])
        half = RANK_HOST_ROUNDS // 2
        for order in (("on", "off"), ("off", "on")):
            for label in order:
                leg = legs[label]
                torch.cuda.synchronize()
                merge.reset_launch_counts()
                t0 = time.perf_counter()
                leg["state"], rep = leg["sim"].start(leg["state"],
                                                     n_rounds=half)
                torch.cuda.synchronize()
                leg["wall"] += time.perf_counter() - t0
                leg["reports"].append(rep)
                for k, v in merge.LAUNCHES.items():
                    if v:
                        leg["launches"][k] = leg["launches"].get(k, 0) + v
        snap = metrics.get_registry().snapshot()["metrics"]
    finally:
        metrics.set_registry(prev)
    out = {}
    for label, leg in legs.items():
        rep = SimulationReport.concatenate(leg["reports"]).to_dict()
        out[label] = dict(
            wall=leg["wall"], launches=leg["launches"],
            report={k: v for k, v in rep.items()
                    if not k.startswith("perf_")},
            leaves={p: x.detach().cpu().clone() for p, x in
                    rules.named_leaves(leg["state"])
                    if isinstance(x, torch.Tensor)})
    on = legs["on"]["sim"]
    out["on"].update(
        perf=on.perf_summary(), trace=tracer.snapshot(),
        metrics={k: v for k, v in snap.items() if k.startswith("engine_")},
        backend=on.run_manifest().to_dict()["backend"])
    return out


def persist_legs(torch, mesh, workdir: str) -> dict:
    """Phase 21 (h)-(j) on ``mesh``, each leg's seconds beside it."""
    from gossipy_tpu_torch.ops import merge
    out, seconds = {}, {}
    for key, fn in (("ckpt", ckpt_legs), ("recorder", recorder_leg),
                    ("host", host_legs)):
        t0 = time.perf_counter()
        out[key] = fn(torch, merge, mesh, workdir)
        seconds[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["seconds"] = seconds
    return out


# -- phase 21 (k)-(n): a user's subclass, a cohort, the service, a disk pool -

RANK_VARIANT_ROUNDS = 50    # (k): the north star through a user's subclass
RANK_COHORT_ROUNDS = 20     # (l): each leg's timed rounds (phase 16: 50)
RANK_COHORT_WARM = 2        # (l): each leg's warm-up rounds
RANK_POOL_ROUNDS = 10       # (n): each of the disk pool's three segments
RANK_SERVICE_LATE = 3       # (m): the tenant (an index of SERVICE_SEEDS)
                            # submitted after the first slice
RANK_SERVICE_POISON = 2     # (m): the poisoned tenant (an index)


def quota_simulator():
    """(k)'s user subclass of the engine, which keeps the base receive
    path: a node earns a send credit each round, up to its cap ``1 + id %
    3``, and sends only while it holds two, which a send costs; every
    param decays by a factor 0.999 before the snapshot. ``_init_aux``
    builds this rank's rows (``self._own``); ``_pre_send`` and
    ``_send_gate`` see the whole population."""
    import torch
    from gossipy_tpu_torch.handlers import ModelState
    from gossipy_tpu_torch.simulation import GossipSimulator

    class Quota(GossipSimulator):
        def _init_aux(self, model):
            ids = torch.arange(self.n_nodes, device=model.params.device)
            cap = self._own(1 + ids % 3).to(torch.int32)
            return {"credit": torch.zeros_like(cap), "cap": cap}

        def _pre_send(self, state, r):
            credit = state.aux["credit"]
            credit.add_(1)
            torch.minimum(credit, state.aux["cap"], out=credit)
            m = state.model
            state.model = ModelState(m.params * 0.999, m.opt_state,
                                     m.n_updates)

        def _send_gate(self, state, active, peers, r, f):
            send = active & (state.aux["credit"] >= 2)
            state.aux["credit"] = state.aux["credit"] - 2 * send.to(
                torch.int32)
            return send

    return Quota


def variant_leg(torch, merge, mesh) -> dict:
    """(k): ``bench.py``'s north star through :func:`quota_simulator` on
    ``mesh`` (the multi deliver): a 2-round warm-up, a fresh init, then
    RANK_VARIANT_ROUNDS rounds timed."""
    sim, state = northstar_sim(torch, "cuda", fused_merge="multi", mesh=mesh,
                               cls=quota_simulator())
    sim.start(state, n_rounds=2)       # warm-up
    state = sim.init_nodes(torch.Generator().manual_seed(42))
    return rank_timed(torch, merge, sim, state, RANK_VARIANT_ROUNDS)


def pool_digest(pool) -> str:
    """One hash of every leaf of a cohort pool and its round."""
    import hashlib
    h = hashlib.sha256(str(int(pool.round)).encode())
    for leaf in (pool.model.params, *pool.model.opt_state,
                 pool.model.n_updates, pool.phase, pool.node_key,
                 pool.touched):
        h.update(memoryview(np.ascontiguousarray(leaf)).cast("B"))
    return h.hexdigest()


def cohort_rank_legs(torch, merge, mesh) -> dict:
    """(l): ``bench.py::bench_cohort``'s configuration (phase 16's
    :func:`cohort_sim`, nominal COHORT_NOMINAL, C = COHORT_SIZE) built on
    ``mesh``, whose rounds run the ring deliver: a pool from one
    generator, then serially and with ``prefetch=COHORT_PREFETCH`` from
    it, each a warm-up of RANK_COHORT_WARM rounds and RANK_COHORT_ROUNDS
    rounds timed (every round a segment). Each leg's report, final pool
    digest, wall, launches and transfers."""
    from gossipy_tpu_torch.parallel.collectives import TRANSFERS
    torch.cuda.empty_cache()
    rss0 = rss_bytes()
    sim = cohort_sim(torch, COHORT_NOMINAL, "cuda",
                     rounds=RANK_COHORT_ROUNDS, mesh=mesh)
    t0 = time.perf_counter()
    pool0 = sim.init_cohort_pool(torch.Generator().manual_seed(42))
    out = {"init_s": time.perf_counter() - t0, "rss0": rss0}
    draws0 = sim.draws.get_state()
    for tag, prefetch in (("serial", 0), ("stream", COHORT_PREFETCH)):
        s = sim if not prefetch else cohort_sim(
            torch, COHORT_NOMINAL, "cuda", prefetch=prefetch,
            rounds=RANK_COHORT_ROUNDS, draws=draws0, mesh=mesh)
        warm, _ = s.start(pool0, n_rounds=RANK_COHORT_WARM)
        torch.cuda.synchronize()
        merge.reset_launch_counts()
        TRANSFERS.clear()
        t0 = time.perf_counter()
        pool, rep = s.start(warm, n_rounds=RANK_COHORT_ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[tag] = dict(report=rep.to_dict(), digest=pool_digest(pool),
                        wall=wall, transfers=dict(TRANSFERS),
                        launches={k: v for k, v in merge.LAUNCHES.items()
                                  if v},
                        finite=bool(np.isfinite(pool.model.params).all()))
        del warm, pool
    out["rss"] = rss_bytes()
    del pool0
    return out


def rss_bytes() -> tuple:
    """This process's resident set now (``VmRSS``) and its peak so far
    (``ru_maxrss``), in bytes: on a 9p mount they count a disk pool's
    mapped pages."""
    import resource
    now = 0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                now = int(line.split()[1]) * 1024
    return now, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def store_view(store) -> dict:
    """A disk pool's store as (n) holds it: one hash of the manifest's
    round on disk, the ``inited`` and ``touched`` masks and every leaf's
    rows where ``inited`` is set (the rest are holes), whether those
    params are finite, and how many rows that is."""
    import hashlib
    with open(os.path.join(store.path, "pool_manifest.json")) as f:
        rnd = json.load(f)["round"]
    on = np.flatnonzero(store.inited)
    pool = store.pool()
    h = hashlib.sha256(str(int(rnd)).encode())
    for leaf in (store.inited, pool.touched):
        h.update(memoryview(np.ascontiguousarray(leaf)).cast("B"))
    params = np.asarray(pool.model.params[on])
    for leaf in (params, *(l[on] for l in pool.model.opt_state),
                 pool.model.n_updates[on], pool.phase[on],
                 pool.node_key[on]):
        h.update(memoryview(np.ascontiguousarray(leaf)).cast("B"))
    return dict(digest=h.hexdigest(), rows=int(on.size), round=int(rnd),
                finite=bool(np.isfinite(params).all()))


def pool_rank_leg(torch, merge, mesh, workdir: str) -> dict:
    """(n): :func:`cohort_rank_legs`' configuration with
    ``CohortConfig(pool_dir=)`` on ``mesh``, each rank keeping its own
    replica of the store (``cohort.rank_pool_dir``): the store created,
    RANK_POOL_ROUNDS rounds serially; re-opened with
    ``prefetch=COHORT_PREFETCH`` and RANK_POOL_ROUNDS more; saved across
    the ranks, loaded into each rank's work directory and RANK_POOL_ROUNDS
    more. Each segment's report, launches, transfers and wall (counts set
    to 0 just before it) and the store after it (:func:`store_view`); the
    seconds of the create, re-open, save and load; the live store's
    paths, rows, apparent and allocated bytes, whether its filesystem
    keeps holes, and this process's RSS (:func:`rss_bytes`) before the
    leg and at its end."""
    from gossipy_tpu_torch.parallel.collectives import TRANSFERS
    from gossipy_tpu_torch.simulation.cohort import fs_keeps_holes
    root = os.path.join(workdir, "n-ranks" if mesh.spans_ranks()
                        else "n-virtual")
    pool_dir = os.path.join(root, "pool")
    torch.cuda.empty_cache()
    out, seconds = {"rss0": rss_bytes()}, {}

    def build(prefetch=0, draws=None):
        return cohort_sim(torch, COHORT_NOMINAL, "cuda", prefetch=prefetch,
                          rounds=RANK_POOL_ROUNDS, draws=draws, mesh=mesh,
                          pool_dir=pool_dir)

    def timed(key, fn):
        t0 = time.perf_counter()
        got = fn()
        seconds[key] = time.perf_counter() - t0
        return got

    def segment(tag, sim, pool):
        torch.cuda.synchronize()
        merge.reset_launch_counts()
        TRANSFERS.clear()
        t0 = time.perf_counter()
        pool, rep = sim.start(pool, n_rounds=RANK_POOL_ROUNDS)
        torch.cuda.synchronize()
        out[tag] = dict(report=rep.to_dict(), wall=time.perf_counter() - t0,
                        transfers=dict(TRANSFERS),
                        launches={k: v for k, v in merge.LAUNCHES.items()
                                  if v},
                        **store_view(sim._pool_store))
        return pool

    sim = build()
    pool = timed("create", lambda: sim.init_cohort_pool(
        torch.Generator().manual_seed(42)))
    replica = sim._pool_store.path
    pool = segment("serial", sim, pool)
    sim = build(COHORT_PREFETCH, sim.draws.get_state())
    pool = timed("open", lambda: sim.init_cohort_pool(
        torch.Generator().manual_seed(42)))
    out["opened_round"] = int(pool.round)
    pool = segment("reopen", sim, pool)
    ckpt = timed("save", lambda: sim.save(os.path.join(root, "ckpt"),
                                          pool))
    sim = build(COHORT_PREFETCH)
    pool, _ = timed("load", lambda: sim.load(ckpt))
    out["loaded_round"] = int(pool.round)
    pool = segment("loaded", sim, pool)
    store = sim._pool_store
    apparent = allocated = 0
    for name in store.files():
        st = os.stat(os.path.join(store.path, name))
        apparent += st.st_size
        allocated += st.st_blocks * 512
    out.update(seconds=seconds, ckpt=ckpt, live=store.path,
               replica=replica, rows=store.rows_written(),
               row_bytes=store.row_bytes(), apparent=apparent,
               allocated=allocated, holes=fs_keeps_holes(store.path),
               rss=rss_bytes())
    del sim, pool, store
    return out


class FileWrites:
    """The files and directories this process creates, writes or renames
    under ``root`` while ``on`` (Python's audit events)."""

    def __init__(self, root: str):
        self.root, self.seen, self.on = os.path.abspath(root), [], False
        sys.addaudithook(self._hook)

    def _hook(self, event, args):
        if not self.on or event not in ("open", "os.mkdir", "os.rename"):
            return
        path = args[0]
        if not isinstance(path, (str, bytes, os.PathLike)):
            return
        path = os.fsdecode(path)
        if not path.startswith(self.root):
            return
        if event == "open" and not (
                (isinstance(args[1], str) and set(args[1]) & set("wax+"))
                or args[2] & (os.O_WRONLY | os.O_RDWR)):
            return
        self.seen.append(path)


def service_requests() -> list:
    """(m)'s tenants: ``spambase_100.json`` at SERVICE_SEEDS and
    SERVICE_DROPS (phase 17 (b)'s), SERVICE_ROUNDS rounds each; the
    tenant RANK_SERVICE_POISON's data has an eighth of its samples set to
    inf."""
    from gossipy_tpu_torch.data import load_classification_dataset
    from gossipy_tpu_torch.service import RunRequest
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the offline stand-in's note
        X, y = load_classification_dataset("spambase")
    out = []
    for i, (seed, p) in enumerate(zip(SERVICE_SEEDS, SERVICE_DROPS)):
        data = None
        if i == RANK_SERVICE_POISON:
            Xp = np.array(X, copy=True)
            Xp[: len(Xp) // 8] = np.inf
            data = (Xp, y)
        out.append(RunRequest(f"ns-{seed}", load_config(
            "spambase_100", seed=seed, drop_prob=p, n_rounds=SERVICE_ROUNDS),
            data=data))
    return out


def service_rank_leg(torch, merge, mesh, workdir: str) -> dict:
    """(m): :func:`service_requests`' tenants served on ``mesh`` in slices
    of SERVICE_SLICE, all but RANK_SERVICE_LATE submitted at the start and
    that one after the first slice (so admission runs twice; rank 1 of a
    mesh across ranks submits it a slice later still, and its queue runs
    rank 0's request meanwhile), the counts set to 0 just before: each
    tenant's status, rounds, report and the cycle that admitted it, the
    buckets, the launches and the lane rounds with messages, the wall and
    the slices' seconds, the summary, the status of the handle the late
    submit returned, and the files this process wrote under its output
    directory."""
    from gossipy_tpu_torch.service import GossipService, RunQueue
    from gossipy_tpu_torch.telemetry import MetricsRegistry
    out_dir = os.path.join(workdir, "m-ranks" if mesh.spans_ranks()
                           else "m-virtual")
    writes = FileWrites(out_dir)
    reg = MetricsRegistry()
    reqs = service_requests()
    late = reqs.pop(RANK_SERVICE_LATE)
    q = RunQueue()
    for req in reqs:
        q.submit(req)
    svc = GossipService(out_dir, slice_rounds=SERVICE_SLICE, registry=reg,
                        mesh=mesh)
    sess = svc.session(q)
    admitted, cycle, late_status = {}, 0, None
    lag = int(mesh.spans_ranks() and torch.distributed.get_rank() == 1)
    with lane_rounds() as lanes, warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the offline stand-in's note
        writes.on = True
        torch.cuda.synchronize()
        merge.reset_launch_counts()
        t0 = time.perf_counter()
        while True:
            live = sess.poll()
            for rt in sess.runtimes:
                for t in rt.bucket.tenants:
                    admitted.setdefault(t, cycle)
            cycle += 1
            if cycle == 1 + lag:
                late_status = q.submit(late).status.value
            if cycle == 1:
                live = True
            if not live:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in merge.LAUNCHES.items() if v}
        summary = sess.finish()
        writes.on = False
    snap = reg.snapshot()["metrics"]
    slices = sum(x["sum"] for x in snap["service_slice_seconds"]["series"])
    handles = {h.tenant: dict(status=h.status.value,
                              rounds=h.rounds_completed,
                              report=None if h.report is None
                              else h.report.to_dict(),
                              bundle=h.bundle_path)
               for h in q.handles()}
    return dict(handles=handles, admitted=admitted,
                buckets=[sorted(rt.bucket.tenants) for rt in sess.runtimes],
                launches=launches, lanes=dict(lanes), wall=wall,
                slices=slices, summary=summary, writes=writes.seen,
                late_status=late_status, queued=len(q.handles()),
                tenant_rounds=sum(h["rounds"] for h in handles.values()))


def more_legs(torch, mesh, workdir: str) -> dict:
    """Phase 21 (k)-(n) on ``mesh``, each leg's seconds beside it ((n),
    the disk pool, before (l), so that its peak RSS is not the RAM
    pool's)."""
    from gossipy_tpu_torch.ops import merge
    out, seconds = {}, {}
    for key, fn in (("variant", lambda: variant_leg(torch, merge, mesh)),
                    ("pool", lambda: pool_rank_leg(torch, merge, mesh,
                                                   workdir)),
                    ("cohort", lambda: cohort_rank_legs(torch, merge, mesh)),
                    ("service", lambda: service_rank_leg(torch, merge, mesh,
                                                         workdir))):
        t0 = time.perf_counter()
        out[key] = fn()
        seconds[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["more_seconds"] = seconds
    return out


def more_checks(torch, merge, smi, pair, ref) -> dict:
    """Phase 21 (k)-(n): each rank against the 2-position virtual mesh's
    legs (``ref``, :func:`more_legs`): bit-equal rows, reports, pools,
    disk pool stores and tenant reports, the same admissions and
    evictions, K1 on every rank, only rank 0 writing the service's files.
    Returns K1's launches by leg and rank."""
    k1: dict = {}
    # (k) a user's subclass
    for r, mine in enumerate(pair):
        leg, want = mine["variant"], ref["variant"]
        diff = rank_against(torch, "variant", r, leg, want)
        k1[f"ranks-variant-rank{r}"] = k1_launches(merge, "variant", r, leg,
                                                   want, 2, 4)
        sent = leg["report"]["sent_per_round"]
        if max(sent) >= NS_NODES:
            raise RuntimeError(f"ranks (k) rank {r}: the subclass's gate "
                               f"did not hold back a send: {sent}")
        log(f"[ranks] (k) north star through a user's subclass (_init_aux, "
            f"_pre_send, a _send_gate that reads a per-node aux value), "
            f"rank {r}: {RANK_VARIANT_ROUNDS} rounds, accounting, rows "
            f"(aux among them) and report bit-equal to the 2-position "
            f"virtual mesh (params max abs diff {diff:.3e}); "
            f"{RANK_VARIANT_ROUNDS / leg['wall']:.2f} rounds/s on this rank "
            f"(virtual mesh {RANK_VARIANT_ROUNDS / want['wall']:.2f}); sent "
            f"{sum(sent)} ({min(sent)}-{max(sent)} a round of "
            f"{NS_NODES} nodes); final accuracy "
            f"{leg['report']['global_evals'][-1]}; K1 launches "
            f"{leg['launches']} (virtual mesh {want['launches']}); "
            f"{leg_line(leg, want, RANK_VARIANT_ROUNDS)}; {smi}")
    # (l) the cohort
    for r, mine in enumerate(pair):
        leg, want = mine["cohort"], ref["cohort"]
        for tag in ("serial", "stream"):
            a, b = leg[tag], want[tag]
            off = same_fields(a["report"], b["report"])
            if off or a["digest"] != b["digest"] or not a["finite"]:
                raise RuntimeError(f"ranks (l) {tag} rank {r}: report "
                                   f"fields {sorted(set(off))} or the pool "
                                   "differ from the virtual mesh's")
            k1[f"ranks-cohort-{tag}-rank{r}"] = k1_launches(
                merge, f"cohort-{tag}", r, a, b, 2, 4)
        if leg["serial"]["digest"] != leg["stream"]["digest"]:
            raise RuntimeError(f"ranks (l) rank {r}: the streamed pool is "
                               "not bit-identical to the serial pool")
        rate = {t: RANK_COHORT_ROUNDS / leg[t]["wall"]
                for t in ("serial", "stream")}
        ref_rate = {t: RANK_COHORT_ROUNDS / want[t]["wall"]
                    for t in ("serial", "stream")}
        log(f"[ranks] (l) cohort, nominal {COHORT_NOMINAL}, C "
            f"{COHORT_SIZE} ({COHORT_SIZE // RANKS} rows a rank), K1, rank "
            f"{r}: pool init {leg['init_s']:.3f} s (virtual mesh "
            f"{want['init_s']:.3f}); {RANK_COHORT_ROUNDS} rounds after "
            f"{RANK_COHORT_WARM} of warm-up (phase 16 times 50), every "
            f"round a segment: serial {rate['serial']:.2f} rounds/s, "
            f"prefetch={COHORT_PREFETCH} {rate['stream']:.2f} rounds/s on "
            f"this rank (virtual mesh {ref_rate['serial']:.2f} and "
            f"{ref_rate['stream']:.2f}; one process: this run's phase 16 "
            f"line above); pools and "
            f"reports bit-equal to the virtual mesh's, the streamed pool "
            f"bit-identical to the serial one; coverage "
            f"{leg['serial']['report']['cohort_coverage'][-1]}; final "
            f"accuracy {leg['serial']['report']['global_evals'][-1]}; K1 "
            f"launches serial {leg['serial']['launches']}, stream "
            f"{leg['stream']['launches']} (virtual mesh "
            f"{want['serial']['launches']}); "
            f"{leg_line(leg['serial'], want['serial'], RANK_COHORT_ROUNDS)}"
            f"; RSS {leg['rss0'][0] / 1e9:.3f} GB before the leg, "
            f"{leg['rss'][0] / 1e9:.3f} with the pool held, peak "
            f"{leg['rss'][1] / 1e9:.3f}; {smi}")
    k1.update(pool_checks(merge, smi, pair, ref))
    # (m) the service
    want = ref["service"]
    poison = f"ns-{SERVICE_SEEDS[RANK_SERVICE_POISON]}"
    late = f"ns-{SERVICE_SEEDS[RANK_SERVICE_LATE]}"
    if want["handles"][poison]["status"] != "evicted" or any(
            h["status"] != "done" for t, h in want["handles"].items()
            if t != poison) or want["admitted"][late] != 1:
        raise RuntimeError(f"ranks (m): the virtual mesh service's "
                           f"tenants {want['handles']}, admitted "
                           f"{want['admitted']}")
    if pair[1]["service"]["writes"] or not any(
            p.endswith("service_summary.json")
            for p in pair[0]["service"]["writes"]):
        raise RuntimeError(f"ranks (m): rank 1 wrote "
                           f"{pair[1]['service']['writes'][:5]}, rank 0 "
                           f"{len(pair[0]['service']['writes'])} files")
    if pair[0]["service"]["summary"] != pair[1]["service"]["summary"]:
        raise RuntimeError("ranks (m): the ranks returned other summaries")
    for r, mine in enumerate(pair):
        leg = mine["service"]
        for t, h in want["handles"].items():
            got = leg["handles"][t]
            off = same_fields(got["report"], h["report"])
            if off or got["status"] != h["status"] or \
                    got["rounds"] != h["rounds"]:
                raise RuntimeError(f"ranks (m) rank {r} tenant {t}: "
                                   f"{got['status']} after {got['rounds']} "
                                   f"rounds, report fields "
                                   f"{sorted(set(off))} off the virtual "
                                   "mesh's")
        if leg["admitted"] != want["admitted"] or \
                leg["buckets"] != want["buckets"] or \
                leg["queued"] != len(want["handles"]) or \
                leg["late_status"] != ("running" if r else "queued"):
            raise RuntimeError(f"ranks (m) rank {r}: admitted "
                               f"{leg['admitted']} in {leg['buckets']}, "
                               f"the virtual mesh {want['admitted']}; "
                               f"{leg['queued']} handles, the late submit "
                               f"returned one {leg['late_status']}")
        rounds = leg["lanes"].get("float32", 0)
        if not rounds or leg["launches"] != {merge.KERNEL: 2 * rounds} or \
                want["launches"] != {merge.KERNEL: 4 * rounds}:
            raise RuntimeError(f"ranks (m) rank {r}: launches "
                               f"{leg['launches']} (virtual mesh "
                               f"{want['launches']}) for {rounds} lane "
                               "rounds with messages")
        k1[f"ranks-service-rank{r}"] = leg["launches"][merge.KERNEL]
        log(f"[ranks] (m) spambase_100.json x {len(want['handles'])} "
            f"tenants (seeds {list(SERVICE_SEEDS)}, drop_prob "
            f"{list(SERVICE_DROPS)}), {SERVICE_ROUNDS} rounds in slices of "
            f"{SERVICE_SLICE}, {late} submitted after the first slice "
            f"(rank 1: the second, its handle then "
            f"{pair[1]['service']['late_status']}), {poison} poisoned, rank "
            f"{r}: buckets {leg['buckets']}, "
            f"admitted in cycles {leg['admitted']}, statuses "
            f"{ {t: h['status'] for t, h in leg['handles'].items()} }, "
            f"every tenant's report bit-equal to the virtual mesh "
            f"service's; {leg['tenant_rounds']} tenant-rounds in "
            f"{leg['slices']:.3f} s of slices = "
            f"{leg['tenant_rounds'] / leg['slices']:.2f} tenant-rounds/s on "
            f"this rank (virtual mesh "
            f"{want['tenant_rounds'] / want['slices']:.2f}; four tenants "
            f"on one process: this run's phase 17 (b) line above); whole "
            f"run {leg['wall']:.3f} s; files written by this rank "
            f"{len(leg['writes'])}; K1 launches {leg['launches']} for "
            f"{rounds} lane rounds with messages (virtual mesh "
            f"{want['launches']}); {smi}")
    return {(merge.KERNEL, "float32"): k1}


POOL_SEGMENTS = ("serial", "reopen", "loaded")


def pool_checks(merge, smi, pair, ref) -> dict:
    """Phase 21 (n): each rank's segments against the virtual mesh's
    (reports and store digests bit-equal, so the replicas are equal),
    K1 twice a round with messages a rank (the virtual mesh four times),
    the store re-opened and loaded at the rounds it was left at, each
    rank in its own replica and work directory, the checkpoint one path.
    Returns K1's launches by segment and rank."""
    from gossipy_tpu_torch.simulation.cohort import rank_pool_dir
    k1 = {}
    want = ref["pool"]
    ckpt = pair[0]["pool"]["ckpt"]
    for r, mine in enumerate(pair):
        leg = mine["pool"]
        for tag in POOL_SEGMENTS:
            a, b = leg[tag], want[tag]
            off = same_fields(a["report"], b["report"])
            if off or a["digest"] != b["digest"] or not a["finite"] \
                    or a["rows"] != b["rows"]:
                raise RuntimeError(f"ranks (n) {tag} rank {r}: report "
                                   f"fields {sorted(set(off))} or the "
                                   f"store ({a['rows']} rows) differ from "
                                   f"the virtual mesh's ({b['rows']})")
            if a["digest"] != pair[0]["pool"][tag]["digest"]:
                raise RuntimeError(f"ranks (n) {tag}: the replicas differ")
            k1[f"ranks-pool-{tag}-rank{r}"] = k1_launches(
                merge, f"pool-{tag}", r, a, b, 2, 4)
        base = pair[0]["pool"]["replica"]
        if (leg["opened_round"], leg["loaded_round"]) != (
                RANK_POOL_ROUNDS, 2 * RANK_POOL_ROUNDS) or \
                leg["loaded"]["round"] != 3 * RANK_POOL_ROUNDS or \
                leg["replica"] != rank_pool_dir(base, r) or \
                leg["ckpt"] != ckpt or \
                leg["live"] != rank_pool_dir(ckpt + ".live", r):
            raise RuntimeError(
                f"ranks (n) rank {r}: re-opened at round "
                f"{leg['opened_round']}, loaded at {leg['loaded_round']}, "
                f"replica {leg['replica']}, checkpoint {leg['ckpt']}, work "
                f"directory {leg['live']}")
        rate = {t: RANK_POOL_ROUNDS / leg[t]["wall"] for t in POOL_SEGMENTS}
        ref_rate = {t: RANK_POOL_ROUNDS / want[t]["wall"]
                    for t in POOL_SEGMENTS}
        ram = mine["cohort"]
        sec = leg["seconds"]
        log(f"[ranks] (n) disk-backed cohort pool, nominal "
            f"{COHORT_NOMINAL}, C {COHORT_SIZE} ({COHORT_SIZE // RANKS} rows "
            f"a rank), K1, rank {r}, replica {leg['replica']}: created in "
            f"{sec['create']:.3f} s, {RANK_POOL_ROUNDS} rounds serial "
            f"{rate['serial']:.2f} rounds/s, re-opened in {sec['open']:.3f} s "
            f"and {RANK_POOL_ROUNDS} rounds with prefetch={COHORT_PREFETCH} "
            f"{rate['reopen']:.2f} rounds/s, saved in {sec['save']:.3f} s "
            f"(rank 0 writes), loaded into {leg['live']} in "
            f"{sec['load']:.3f} s and {RANK_POOL_ROUNDS} rounds "
            f"{rate['loaded']:.2f} rounds/s on this rank (virtual mesh "
            f"{ref_rate['serial']:.2f}, {ref_rate['reopen']:.2f}, "
            f"{ref_rate['loaded']:.2f}; (l)'s RAM pool serial "
            f"{RANK_COHORT_ROUNDS / ram['serial']['wall']:.2f}, prefetch="
            f"{COHORT_PREFETCH} {RANK_COHORT_ROUNDS / ram['stream']['wall']:.2f}"
            f"); reports and store digests bit-equal to the virtual mesh's "
            f"after every segment, the replicas equal; rows written "
            f"{leg['rows']} of {leg['row_bytes']} B each, files "
            f"{leg['apparent']} B apparent, {leg['allocated']} B allocated, "
            f"fs_keeps_holes {leg['holes']}; RSS "
            f"{leg['rss0'][0] / 1e9:.3f} GB before the leg, "
            f"{leg['rss'][0] / 1e9:.3f} at its end, peak "
            f"{leg['rss'][1] / 1e9:.3f} by then ((l)'s RAM pool: "
            f"{ram['rss0'][0] / 1e9:.3f} before, {ram['rss'][0] / 1e9:.3f} "
            f"with the pool held, peak {ram['rss'][1] / 1e9:.3f}); "
            f"coverage {leg['loaded']['report']['cohort_coverage'][-1]}; "
            f"final accuracy {leg['loaded']['report']['global_evals'][-1]}; "
            f"K1 launches {[leg[t]['launches'] for t in POOL_SEGMENTS]} "
            f"(virtual mesh {[want[t]['launches'] for t in POOL_SEGMENTS]}); "
            f"{leg_line(leg['serial'], want['serial'], RANK_POOL_ROUNDS)}"
            f"; {smi}")
    return k1


def more_phase(torch, merge, smi) -> dict:
    """Phase 21 (k)-(n) alone (the full phase runs them in its ``pair``
    spawn): the legs on a 2-position virtual mesh of the card, then on
    RANKS processes (the ``more`` spawn), held by :func:`more_checks`.
    Returns K1's launches by leg and rank."""
    import shutil
    import tempfile
    workdir = tempfile.mkdtemp(prefix="gossipy-more-")
    try:
        ref = more_legs(torch, virtual_mesh("cuda", RANKS), workdir)
        got, seconds = run_spawn(torch, workdir, "more")
        paths = more_checks(torch, merge, smi, got, ref)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"[ranks] (k)-(n): the virtual mesh's legs "
        + ", ".join(f"{k} {v:.1f} s" for k, v in
                    ref["more_seconds"].items())
        + f"; {RANKS} ranks started, ran and reaped in {seconds:.1f} s "
        "(rank 0's legs " + ", ".join(
            f"{k} {v:.1f} s" for k, v in got[0]["more_seconds"].items())
        + ")")
    return paths


def ranks_legs(torch, merge, mesh, split: bool = False) -> dict:
    """Phase 21's legs (a)-(c) on ``mesh`` (``None``: the unsharded north
    star alone): what this process holds after each (its rows of every
    leaf, on the host), the report, the launches and the transfers of
    each leg (counts set to 0 just before it), and its times. ``split``
    (a virtual mesh) runs the CIFAR10Net leg alone, its update in
    RANKS batches (:func:`split_update`)."""
    from gossipy_tpu_torch.ops import attention as attn
    from gossipy_tpu_torch.parallel.collectives import TRANSFERS, \
        ring_attention

    out = {}
    if not split:
        sim, state = northstar_sim(torch, "cuda", fused_merge="multi",
                                   mesh=mesh)
        sim.start(state, n_rounds=2)       # warm-up
        state = sim.init_nodes(torch.Generator().manual_seed(42))
        out["northstar"] = rank_timed(torch, merge, sim, state,
                                      RANK_NS_ROUNDS)
        del sim, state
    if mesh is None:
        return out
    out["flagship"] = flagship_leg(torch, merge, mesh,
                                   RANKS if split else 0)
    if split:
        return out
    q, k, v = hop_operands(torch, attn, ATTN_S, ATTN_S, ATTN_D, ATTN_D,
                           torch.float32, "initial", 50)[:3]
    sl = mesh.node_rows(ATTN_S)
    q, k, v = (t[sl].contiguous() for t in (q, k, v))

    def ring():
        return ring_attention(q, k, v, mesh, causal=True, flash=True)

    torch.cuda.synchronize()
    merge.reset_launch_counts()
    TRANSFERS.clear()
    got = ring()
    torch.cuda.synchronize()
    out["ring"] = dict(out=got.cpu(), launches={
        kk: vv for kk, vv in merge.LAUNCHES.items() if vv},
        transfers=dict(TRANSFERS), ms=call_ms(torch, ring,
                                              iters=RANK_RING_CALLS))
    return out


def rank_main(argv) -> int:
    """One rank of phase 21 (``chip_smoke.py --rank RANK PORT WORKDIR
    SPAWN``): join the group on ``cuda:0`` and save what this rank holds
    after its legs. The ``pair`` spawn (RANKS processes) runs
    :func:`ranks_legs` on the mesh over every rank's positions, then (d)
    on a 2 x 2 ``(nodes, model)`` mesh, (f), (g), (h)-(j)
    (:func:`persist_legs`, with the files in WORKDIR) and (k)-(n)
    (:func:`more_legs`); the ``grid`` spawn (GRID_RANKS processes) runs
    (e) on a 4 x 2 ``(dcn, nodes)`` mesh, two positions a rank; the
    ``persist`` and ``more`` spawns (RANKS processes) run (h)-(j) alone
    (:func:`persist_phase`) and (k)-(n) alone (:func:`more_phase`)."""
    import datetime

    import torch
    from gossipy_tpu_torch import parallel
    from gossipy_tpu_torch.ops import merge
    rank, port, workdir, spawn = int(argv[0]), argv[1], argv[2], argv[3]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = parallel.init_distributed(
        f"localhost:{port}", GRID_RANKS if spawn == "grid" else RANKS, rank,
        device="cuda:0",
        timeout=datetime.timedelta(seconds=RANK_GROUP_TIMEOUT_S))
    try:
        if spawn == "pair":
            mesh = parallel.make_mesh(devices=parallel.devices("cuda:0"))
            out = ranks_legs(torch, merge, mesh)
            out["tp"] = flagship_leg(torch, merge,
                                     tp_mesh(rank_positions(2)))
            out["a2a"] = all2all_legs(torch, merge, mesh)
            out["telemetry"] = telemetry_legs(torch, merge, mesh)
            out.update(persist_legs(torch, mesh, workdir))
            out.update(more_legs(torch, mesh, workdir))
        elif spawn == "persist":
            mesh = parallel.make_mesh(devices=parallel.devices("cuda:0"))
            out = persist_legs(torch, mesh, workdir)
        elif spawn == "more":
            mesh = parallel.make_mesh(devices=parallel.devices("cuda:0"))
            out = more_legs(torch, mesh, workdir)
        else:
            mesh = grid_mesh(rank_positions(2))
            out = {"grid": flagship_leg(torch, merge, mesh)}
        out.update(backend=backend, mesh=repr(mesh),
                   rows=str(mesh.node_rows(NS_NODES if spawn != "grid"
                                           else N_NODES)))
        torch.save(out, os.path.join(workdir, f"{spawn}{rank}.pt"))
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    return 0


def start_ranks(workdir: str, spawn: str = "pair") -> list:
    """The processes of one phase-21 spawn (``pair``, ``persist`` and
    ``more``: RANKS, ``grid``: GRID_RANKS), on a free port of this
    host."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    here = os.path.abspath(__file__)
    world = GRID_RANKS if spawn == "grid" else RANKS
    return [subprocess.Popen(
        [sys.executable, here, "--rank", str(r), str(port), workdir, spawn],
        cwd=os.path.dirname(here), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def run_spawn(torch, workdir: str, spawn: str) -> tuple:
    """Start one spawn, reap it, and load what each rank saved; raises
    when a rank failed. Returns ``(outputs by rank, seconds)``."""
    t0 = time.perf_counter()
    procs = start_ranks(workdir, spawn)
    outs = reap_ranks(procs)
    seconds = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{spawn} rank {r} exited {p.returncode}:\n"
                               f"{text[-4000:]}")
    return [torch.load(os.path.join(workdir, f"{spawn}{r}.pt"),
                       map_location="cpu", weights_only=False)
            for r in range(len(procs))], seconds


def reap_ranks(procs) -> list:
    """Each rank's output, read together; a rank still running at
    RANK_TIMEOUT_S is killed (so is every rank when one fails)."""
    import threading
    outs = [""] * len(procs)

    def drain(i):
        outs[i] = procs[i].communicate()[0]

    threads = [threading.Thread(target=drain, args=(i,), daemon=True)
               for i in range(len(procs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=RANK_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for t in threads:
        t.join(timeout=10)
    return outs


ACCOUNTING = ("sent_per_round", "failed_per_round", "failed_per_cause",
              "mailbox_hwm_per_round", "compact_slots_per_round",
              "wide_slots_per_round", "sent_messages", "failed_messages",
              "total_size")


# The report fields (and their live-row names) the card sums with atomics
# (``index_add_`` in ``simulation/faults.py::chaos_round_stats``): in no
# fixed order, so one process's reruns differ in their last bits (3.4e-08
# at the north star). They are held within
# ``torch_pairs.assert_same_telemetry``'s tolerance, 1e-5 of the value
# plus 1e-6; every other field bit for bit.
ATOMIC_FIELDS = ("chaos_component_gap", "chaos_within_mean",
                 "component_gap", "within_mean")


def same_fields(a, b, key=None) -> list:
    """The fields where two JSON records differ: every field exactly,
    those in ATOMIC_FIELDS within 1e-5 relative plus 1e-6."""
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return [key or "keys"]
        return [f for k in a for f in same_fields(a[k], b[k], k)]
    if key in ATOMIC_FIELDS and a is not None and b is not None:
        x, y = np.asarray(a, float), np.asarray(b, float)
        ok = x.shape == y.shape and bool(np.all(
            np.abs(x - y) <= 1e-6 + 1e-5 * np.abs(y)))
        return [] if ok else [key]
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b) \
            and any(isinstance(v, dict) for v in a):
        return [f for u, v in zip(a, b) for f in same_fields(u, v, key)]
    same = json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    return [] if same else [key]


def rank_against(torch, label, rank, got, want, world: int = RANKS
                 ) -> float:
    """One rank's leg against a virtual mesh's: the accounting exact,
    every leaf's rows, the whole report and the live rows bit-equal.
    Returns the largest param difference."""
    half = {p: (1 if p.startswith(("history", "mailbox", "reply_box"))
                else 0) for p in want["leaves"]}
    for key in ACCOUNTING:
        if got["report"].get(key) != want["report"].get(key):
            raise RuntimeError(f"ranks {label} rank {rank}: {key} differs "
                               "from the virtual mesh run")
    worst = 0.0
    for path, x in want["leaves"].items():
        dim = half[path]
        n = x.shape[dim] // world
        mine = x.narrow(dim, rank * n, n)
        diff = float((got["leaves"][path].double() - mine.double()).abs()
                     .max()) if mine.numel() else 0.0
        if path == "model/params":
            worst = diff
        if not torch.equal(got["leaves"][path], mine):
            raise RuntimeError(f"ranks {label} rank {rank}: {path} differs "
                               f"from the virtual mesh's rows (max abs "
                               f"{diff:.3e})")
    off = same_fields(got["report"], want["report"])
    if off:
        raise RuntimeError(f"ranks {label} rank {rank}: the report differs "
                           f"from the virtual mesh's in {sorted(set(off))}")
    off = same_fields(got.get("live"), want.get("live"))
    if off:
        raise RuntimeError(f"ranks {label} rank {rank}: the live rows "
                           f"differ from the virtual mesh's in "
                           f"{sorted(set(off))}")
    return worst


def ranks_phase(torch, merge, smi) -> dict:
    """Phase 21: the legs on RANKS processes of the card against the same
    legs on a 2-position virtual mesh here (and the unsharded north
    star), (d) against a 2 x 2 virtual TP mesh and (e), on GRID_RANKS
    processes, against a 4 x 2 virtual ``(dcn, nodes)`` mesh; (h)-(j)
    (:func:`persist_checks`) and (k)-(n) (:func:`more_checks`) on the
    RANKS processes too; returns K1's and K5's launches by rank and
    leg."""
    import shutil
    import tempfile

    from gossipy_tpu_torch.ops import attention as attn
    workdir = tempfile.mkdtemp(prefix="gossipy-ranks-")
    t_ref = time.perf_counter()
    want = ranks_legs(torch, merge, virtual_mesh("cuda", RANKS))
    flat = ranks_legs(torch, merge, None)["northstar"]
    # CIFAR10Net's update in one batch of 64 nodes rounds otherwise than
    # in two of 32 on the card: the ranks are held bit-equal to a virtual
    # mesh that splits its update as they do, and their distance to the
    # whole-batch one is printed beside that of the split reference.
    split = ranks_legs(torch, merge, virtual_mesh("cuda", RANKS),
                       split=True)["flagship"]
    split_gap = float((split["leaves"]["model/params"]
                       - want["flagship"]["leaves"]["model/params"]).abs()
                      .max())
    q, k, v = hop_operands(torch, attn, ATTN_S, ATTN_S, ATTN_D, ATTN_D,
                           torch.float32, "initial", 50)[:3]
    unsharded = attn.flash_attention(q, k, v, causal=True).cpu()
    del q, k, v
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # (d) and (e): the virtual meshes of the same shapes, each splitting
    # its update as the ranks split theirs (the distance to (b)'s
    # whole-batch run is printed); (f) and (g) on the 2-position virtual
    # mesh.
    more = {"tp": flagship_leg(torch, merge, tp_mesh(["cuda"] * 4), RANKS),
            "whole": want["flagship"],
            "grid": flagship_leg(torch, merge, grid_mesh(["cuda"] * 8),
                                 GRID_RANKS),
            "a2a": all2all_legs(torch, merge, virtual_mesh("cuda", RANKS)),
            "telemetry": telemetry_legs(torch, merge,
                                        virtual_mesh("cuda", RANKS))}
    # (h)-(j) and (k)-(n) on the 2-position virtual mesh, their files
    # (the checkpoints a rank restores among them) in the spawn's
    # directory.
    try:
        more["persist"] = persist_legs(torch, virtual_mesh("cuda", RANKS),
                                       workdir)
        more["more"] = more_legs(torch, virtual_mesh("cuda", RANKS),
                                 workdir)
        log(f"[ranks] the parent's references took "
            f"{time.perf_counter() - t_ref:.1f} s ((h)-(j): "
            + ", ".join(f"{k} {v:.1f} s" for k, v in
                        more["persist"]["seconds"].items()) + "; (k)-(n): "
            + ", ".join(f"{k} {v:.1f} s" for k, v in
                        more["more"]["more_seconds"].items()) + ")")
        got, ranks_s = run_spawn(torch, workdir, "pair")
        grid, grid_s = run_spawn(torch, workdir, "grid")
        t0 = time.perf_counter()
        paths = persist_checks(torch, merge, smi, got, more["persist"],
                               workdir)
        log(f"[ranks] (h)-(j) checks here took "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for checks in (more_ranks_checks(torch, merge, smi, got, grid, more),
                   more_checks(torch, merge, smi, got, more["more"])):
        for key, by_leg in checks.items():
            paths.setdefault(key, {}).update(by_leg)
    log("[ranks] the rank legs' seconds (rank 0): " + ", ".join(
        f"{k} {v:.1f} s" for k, v in {**got[0]["seconds"],
                                       **got[0]["more_seconds"]}.items()))
    route = attn.route(torch.float32, ATTN_D, ATTN_D)
    for r, mine in enumerate(got):
        log(f"[ranks] rank {r}: {mine['mesh']}, transport "
            f"{mine['backend']}, rows {mine['rows']} of the north star")
        if mine["backend"] != "gloo":
            raise RuntimeError(f"rank {r}: ranks on one card joined by "
                               f"{mine['backend']}")
        for leg in ("northstar", "flagship"):
            ref = split if leg == "flagship" else want[leg]
            diff = rank_against(torch, leg, r, mine[leg], ref)
            whole_gap = float((mine[leg]["leaves"]["model/params"]
                               - want[leg]["leaves"]["model/params"].narrow(
                                   0, r * N_NODES // RANKS if leg ==
                                   "flagship" else r * NS_NODES // RANKS,
                                   mine[leg]["leaves"]["model/params"]
                                   .shape[0])).abs().max())
            t = mine[leg]["transfers"]
            rounds = RANK_NS_ROUNDS if leg == "northstar" else \
                RANK_FLAG_ROUNDS
            l_r, l_v = mine[leg]["launches"], want[leg]["launches"]
            rep = mine[leg]["report"]
            with_msgs = sum(1 for a, b in zip(rep["compact_slots_per_round"],
                                              rep["wide_slots_per_round"])
                            if a + b)
            if l_r != {merge.KERNEL: 2 * with_msgs} or l_v != {
                    merge.KERNEL: 4 * with_msgs} or not with_msgs:
                raise RuntimeError(f"ranks {leg} rank {r}: launches {l_r} "
                                   f"(virtual mesh {l_v}) for {with_msgs} "
                                   "rounds with messages")
            hop = t.get("ring_bytes", 0) / max(t.get("ring_hops", 1), 1)
            log(f"[ranks] ({'a' if leg == 'northstar' else 'b'}) {leg} rank "
                f"{r}: {rounds} rounds in {mine[leg]['wall']:.3f} s = "
                f"{rounds / mine[leg]['wall']:.2f} rounds/s (2-position "
                f"virtual mesh {rounds / want[leg]['wall']:.2f}"
                + (f", unsharded {rounds / flat['wall']:.2f}"
                   if leg == "northstar" else "")
                + f"); accounting, rows and report bit-equal to the virtual "
                f"mesh{' with its update split as the ranks split it' if leg == 'flagship' else ''}"
                f" (params max abs diff {diff:.3e}; to the virtual mesh's "
                f"whole-batch update {whole_gap:.3e}"
                + (f", the split reference's own {split_gap:.3e}"
                   if leg == "flagship" else "") + "); sent "
                f"{sum(rep['sent_per_round'])} failed "
                f"{sum(rep['failed_per_round'])}; final accuracy "
                f"{rep['global_evals'][-1]}; K1 launches {l_r} on this rank "
                f"(virtual mesh {l_v}); transport {mine['backend']}: "
                f"{t.get('ring_hops', 0)} ring hops across the ranks, "
                f"{hop:.0f} B a hop, staged through host buffers "
                f"{t.get('staged_bytes', 0)} B, {t.get('gathers', 0)} "
                f"gathers ({t.get('gather_bytes', 0)} B), "
                f"{t.get('reduces', 0)} sums; {smi}")
            paths.setdefault((merge.KERNEL, "float32"), {})[
                f"ranks-{leg}-rank{r}"] = l_r[merge.KERNEL]
        ring, ring_v = mine["ring"], want["ring"]
        sl = slice(r * ATTN_S // RANKS, (r + 1) * ATTN_S // RANKS)
        err = float((ring["out"] - unsharded[sl]).abs().max())
        scale = float(unsharded.abs().max())
        same = torch.equal(ring["out"], ring_v["out"][sl])
        want_l = {attn.KERNEL: RANKS, route: RANKS, attn.SPLIT_KERNEL: RANKS}
        t = ring["transfers"]
        log(f"[ranks] (c) ring_attention f32 causal S={ATTN_S} D={ATTN_D} "
            f"rank {r}: vs the unsharded flash_attention max abs err "
            f"{err:.3e} of {scale:.3e} (limit 1e-4 of it); bit-equal to the "
            f"virtual mesh's ring {same}; launches {ring['launches']} on "
            f"this rank (virtual mesh {ring_v['launches']}); "
            f"{ring['ms']:.3f} ms a call (host clock; virtual mesh "
            f"{ring_v['ms']:.3f}); {t.get('ring_hops', 0)} hop across the "
            f"ranks, {t.get('ring_bytes', 0)} B, staged "
            f"{t.get('staged_bytes', 0)} B; {smi}")
        if not same or err > 1e-4 * scale or ring["launches"] != want_l:
            raise RuntimeError(f"ranks ring rank {r}: off the virtual mesh "
                               f"or the unsharded call, or launched "
                               f"{ring['launches']}")
        paths.setdefault((route, "float32"), {})[f"ranks-ring-rank{r}"] = \
            ring["launches"][route]
    log(f"[ranks] {RANKS} ranks started, ran and reaped in {ranks_s:.1f} s; "
        f"{GRID_RANKS} ranks of (e) in {grid_s:.1f} s")
    return paths


def same_checkpoint(torch, a: str, b: str) -> bool:
    """Two checkpoint files hold equal leaves and draw states."""
    x, y = (torch.load(p, map_location="cpu", weights_only=True)
            for p in (a, b))
    if sorted(x["state"]) != sorted(y["state"]):
        return False
    for k, v in y["state"].items():
        u = x["state"][k]
        if isinstance(v, torch.Tensor):
            if not (isinstance(u, torch.Tensor) and u.dtype == v.dtype
                    and torch.equal(u, v)):
                return False
        elif u != v:
            return False
    dx, dy = x.get("draws"), y.get("draws")
    if (dx is None) != (dy is None):
        return False
    return dx is None or torch.equal(dx["state"]["generator"],
                                     dy["state"]["generator"])


def persist_checks(torch, merge, smi, pair, ref, workdir: str) -> dict:
    """Phase 21 (h)-(j): each rank against the 2-position virtual mesh's
    legs (``ref``, :func:`persist_legs`), the files they wrote in
    ``workdir`` held here. Returns K1's launches by leg and rank."""
    from gossipy_tpu_torch.telemetry import RunLedger, replay_bundle
    from gossipy_tpu_torch.telemetry.tracing import merge_traces
    k1: dict = {}
    # (h) the files, and each rank's resumed runs
    for ring, rounds in (("float32", RANK_CKPT_ROUNDS),
                         ("int8", RANK_CKPT_SHORT)):
        mine_f = os.path.join(workdir, f"h-ranks-{ring}.pt")
        if not same_checkpoint(torch, mine_f,
                               os.path.join(workdir, f"h-virtual-{ring}.pt")):
            raise RuntimeError(f"ranks (h) {ring}: the ranks' checkpoint "
                               "differs from the virtual mesh's")
        straight = ref["ckpt"][ring]["straight"]
        for r, mine in enumerate(pair):
            leg = mine["ckpt"][ring]
            if not torch.equal(leg["draws"]["state"]["generator"],
                               ref["ckpt"][ring]["draws"]["state"][
                                   "generator"]):
                raise RuntimeError(f"ranks (h) {ring} rank {r}: the draw "
                                   "state at the save differs")
            for src in ("ranks", "virtual"):
                rank_against(torch, f"ckpt-{ring}-{src}", r, leg[src],
                             straight)
                k1[f"ranks-ckpt-{ring}-{src}-rank{r}"] = k1_launches(
                    merge, f"ckpt-{ring}", r, leg[src], straight, 2, 4)
            log(f"[ranks] (h) north star, {ring} ring, rank {r}: "
                f"{rounds} rounds, save {leg['save_ms']:.1f} ms (virtual "
                f"mesh {ref['ckpt'][ring]['save_ms']:.1f}), one file of "
                f"{leg['file_bytes']} B equal leaf for leaf and in its draw "
                f"state to the virtual mesh's ({ref['ckpt'][ring]['file_bytes']}"
                f" B); this rank's state {leg['rank_bytes']} B (virtual "
                f"mesh {ref['ckpt'][ring]['rank_bytes']} B); a fresh "
                f"simulator's load of the ranks' file "
                f"{leg['load_ms_ranks']:.1f} ms, of the one-process file "
                f"{leg['load_ms_virtual']:.1f} ms; {rounds} "
                f"more rounds from each bit-equal to the uninterrupted "
                f"virtual mesh run ({rounds / leg['ranks']['wall']:.2f} "
                f"rounds/s); K1 launches {leg['ranks']['launches']} "
                f"(virtual mesh {straight['launches']}); {smi}")
        # ranks -> one process, unsharded: the ring sums in another order,
        # so the run is held to the card/CPU tolerance.
        sim, _ = northstar_sim(torch, "cuda", fused_merge="multi",
                               history_dtype=ring)
        st, _ = sim.load(mine_f)
        flat = rank_timed(torch, merge, sim, st, rounds)
        del sim, st
        for key in ACCOUNTING:
            if flat["report"].get(key) != straight["report"].get(key):
                raise RuntimeError(f"ranks (h) {ring} unsharded resume: "
                                   f"{key} differs")
        a = flat["leaves"]["model/params"]
        b = straight["leaves"]["model/params"]
        diff = float((a - b).abs().max())
        if not bool(((a - b).abs() <= REF_TOL + REF_TOL * b.abs()).all()):
            raise RuntimeError(f"ranks (h) {ring} unsharded resume: params "
                               f"off by {diff:.3e}")
        log(f"[ranks] (h) {ring}: the ranks' file restored unsharded here, "
            f"{rounds} rounds: accounting equal to the uninterrupted "
            f"virtual mesh run, params max abs diff {diff:.3e} (the ring "
            f"sums in another order; limit 1e-4 + 1e-4 of the value); K1 "
            f"launches {flat['launches']}; {smi}")
    # (i) one bundle, and its replay here
    rec_ref = ref["recorder"]
    bundle = pair[0]["recorder"]["bundle"]
    listing = sorted(os.listdir(os.path.join(workdir, "i-ranks")))
    if any(m["recorder"]["bundle"] != bundle for m in pair) or \
            listing != [os.path.basename(bundle)] or not same_checkpoint(
                torch, os.path.join(bundle, "checkpoint"),
                os.path.join(rec_ref["bundle"], "checkpoint")):
        raise RuntimeError(f"ranks (i): bundles {listing}, or its "
                           "checkpoint differs from the virtual mesh's")
    verdicts = [json.load(open(os.path.join(b, "verdict.json")))
                for b in (bundle, rec_ref["bundle"])]
    if verdicts[0] != verdicts[1]:
        raise RuntimeError(f"ranks (i): verdict {verdicts[0]} against "
                           f"{verdicts[1]}")
    replays = []
    for b in (bundle, rec_ref["bundle"]):
        sim, _ = northstar_sim(torch, "cuda", fused_merge="multi",
                               sentinels=True)
        poison(sim, *RANK_REC_NAN)
        replays.append(replay_bundle(b, sim))
        del sim
    keys = ("first_bad_round", "trip", "leaf", "nodes", "phase")
    if replays[0]["first_bad_round"] != RANK_REC_NAN[1] or \
            replays[0]["matches_recorded"] is not True or \
            any(replays[0][k] != replays[1][k] for k in keys):
        raise RuntimeError(f"ranks (i): replay {replays[0]} against the "
                           f"virtual mesh bundle's {replays[1]}")
    for r, mine in enumerate(pair):
        leg = mine["recorder"]
        off = same_fields(leg["report"], rec_ref["report"])
        if off or leg["chunks"] != rec_ref["chunks"]:
            raise RuntimeError(f"ranks (i) rank {r}: the chunks' report "
                               f"differs from the virtual mesh's in {off}")
        k1[f"ranks-recorder-rank{r}"] = k1_launches(
            merge, "recorder", r, leg, rec_ref, 2, 4)
        log(f"[ranks] (i) north star with sentinels, a NaN into node "
            f"{RANK_REC_NAN[0]} (rank 1's row) before round "
            f"{RANK_REC_NAN[1]}, FlightRecorder(chunk={RANK_REC_CHUNK}), "
            f"rank {r}: {leg['chunks']} chunks in {leg['wall']:.3f} s, "
            f"{leg['gathers']} start-state gathers of "
            f"{leg['gather_ms'] / max(leg['gathers'], 1):.2f} ms each; one "
            f"bundle {os.path.basename(bundle)}, its checkpoint and verdict "
            f"equal to the virtual mesh run's; replayed here unsharded: "
            f"first bad round {replays[0]['first_bad_round']}, leaf "
            f"{replays[0]['leaf']}, phase {replays[0]['phase']} (the "
            f"virtual mesh bundle's replay the same); K1 launches "
            f"{leg['launches']} (virtual mesh {rec_ref['launches']}); {smi}")
    # (j) host telemetry on against off
    on_ref = ref["host"]["on"]
    rows = RunLedger(os.path.join(workdir, "j-ranks.jsonl")).rows()
    index = sorted(row["extra"]["process_index"] for row in rows)
    if index != sorted(list(range(RANKS)) * 2) or any(
            row["extra"]["process_count"] != RANKS for row in rows):
        raise RuntimeError(f"ranks (j): ledger rows of ranks {index}")
    traces = [mine["host"]["on"]["trace"] for mine in pair]
    pids = sorted({e["pid"] for t in traces for e in t["traceEvents"]})
    merged = merge_traces(*traces)
    if merged["otherData"]["merged_pids"] != pids or len(pids) != RANKS:
        raise RuntimeError(f"ranks (j): merged trace pids "
                           f"{merged['otherData']['merged_pids']}")
    for r, mine in enumerate(pair):
        on, off = mine["host"]["on"], mine["host"]["off"]
        rank_against(torch, "host-on", r, on, on_ref)
        rank_against(torch, "host-off", r, off, ref["host"]["off"])
        perf = on["perf"]
        if perf["analytic"] != on_ref["perf"]["analytic"] or \
                on["metrics"] != on_ref["metrics"] or \
                on["backend"]["process_count"] != RANKS or \
                on["backend"]["process_index"] != r or \
                perf["last_run"]["mfu_est"] is None:
            raise RuntimeError(f"ranks (j) rank {r}: analytic, counters or "
                               f"manifest off the virtual mesh's: {perf}, "
                               f"{on['metrics']}, {on['backend']}")
        k1[f"ranks-host-rank{r}"] = k1_launches(merge, "host", r, on,
                                                on_ref, 2, 4)
        n = RANK_HOST_ROUNDS
        log(f"[ranks] (j) north star with perf=, metrics=, ledger= and "
            f"tracing= on, rank {r}: {n} rounds in two halves, "
            f"{n / on['wall']:.2f} rounds/s against {n / off['wall']:.2f} "
            f"with all four off, on {off['wall'] / on['wall']:.4f} of off "
            f"(virtual mesh {n / on_ref['wall']:.2f} and "
            f"{n / ref['host']['off']['wall']:.2f}); rows and report "
            f"bit-equal to the virtual mesh's; analytic "
            f"{perf['analytic']['flops_per_round']:.6g} FLOPs a round and "
            f"the population counters equal to the virtual mesh's; last run "
            f"{perf['last_run']['ms_per_round']:.3f} ms a round, mfu_est "
            f"{perf['last_run']['mfu_est']:.4g}, hbm_peak_bytes "
            f"{perf['hbm_peak_bytes']}; manifest process "
            f"{on['backend']['process_index']} of "
            f"{on['backend']['process_count']}; ledger rows {len(rows)} "
            f"(a row a rank a start()); merged trace pids {pids}; K1 "
            f"launches {on['launches']} (off {off['launches']}); {smi}")
    for r, mine in enumerate(pair):
        log(f"[ranks] (h)-(j) rank {r}: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in mine["seconds"].items()))
    return {(merge.KERNEL, "float32"): k1}


def persist_phase(torch, merge, smi) -> dict:
    """Phase 21 (h)-(j) alone (the full phase runs them in its ``pair``
    spawn): the legs on a 2-position virtual mesh of the card, then on
    RANKS processes (the ``persist`` spawn), held by
    :func:`persist_checks`. Returns K1's launches by leg and rank."""
    import shutil
    import tempfile
    workdir = tempfile.mkdtemp(prefix="gossipy-persist-")
    try:
        ref = persist_legs(torch, virtual_mesh("cuda", RANKS), workdir)
        got, seconds = run_spawn(torch, workdir, "persist")
        paths = persist_checks(torch, merge, smi, got, ref, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"[ranks] (h)-(j): the virtual mesh's legs "
        + ", ".join(f"{k} {v:.1f} s" for k, v in ref["seconds"].items())
        + f"; {RANKS} ranks started, ran and reaped in {seconds:.1f} s")
    return paths


def leg_line(mine, ref, rounds) -> str:
    """A leg's times and transfers on one rank, beside its reference's."""
    t = mine["transfers"]
    hop = t.get("ring_bytes", 0) / max(t.get("ring_hops", 1), 1)
    return (f"{mine['wall'] / rounds * 1e3:.3f} ms/round on this rank "
            f"(virtual mesh {ref['wall'] / rounds * 1e3:.3f}); "
            f"{t.get('ring_hops', 0)} ring hops across the ranks, "
            f"{hop:.0f} B a hop, staged through host buffers "
            f"{t.get('staged_bytes', 0)} B, {t.get('gathers', 0)} gathers "
            f"({t.get('gather_bytes', 0)} B), {t.get('reduces', 0)} sums")


def k1_launches(merge, label, rank, mine, ref, per_rank, per_ref) -> int:
    """K1's launches of a leg on a rank (``per_rank`` a round with
    messages) and on its virtual mesh (``per_ref``); raises otherwise."""
    rep = mine["report"]
    with_msgs = sum(1 for a, b in zip(rep["compact_slots_per_round"],
                                      rep["wide_slots_per_round"]) if a + b)
    got, want = mine["launches"], ref["launches"]
    if not with_msgs or got != {merge.KERNEL: per_rank * with_msgs} \
            or want != {merge.KERNEL: per_ref * with_msgs}:
        raise RuntimeError(f"ranks {label} rank {rank}: launches {got} "
                           f"(virtual mesh {want}) for {with_msgs} rounds "
                           "with messages")
    return got[merge.KERNEL]


def more_ranks_checks(torch, merge, smi, pair, grid, more) -> dict:
    """Phase 21 (d)-(g): each rank against its virtual mesh (accounting,
    rows, report and live rows bit-equal), K1's launches and the times;
    returns K1's launches by leg and rank."""
    paths: dict = {}
    k1 = paths.setdefault((merge.KERNEL, "float32"), {})
    whole = more["whole"]["leaves"]["model/params"]
    for label, ranks, world, ref, per in (
            ("tp", pair, RANKS, more["tp"], (2, 4)),
            ("grid", grid, GRID_RANKS, more["grid"], (16, 64))):
        for r, mine in enumerate(ranks):
            leg = mine[label]
            diff = rank_against(torch, label, r, leg, ref, world)
            n = N_NODES // world
            gap = float((leg["leaves"]["model/params"]
                         - whole[r * n:(r + 1) * n]).abs().max())
            k1[f"ranks-{label}-rank{r}"] = k1_launches(
                merge, label, r, leg, ref, *per)
            log(f"[ranks] ({'d' if label == 'tp' else 'e'}) CIFAR10Net "
                f"clique on a {leg['mesh']}, rows {leg['rows']}, "
                f"rank {r}: {RANK_FLAG_ROUNDS} rounds, accounting, rows "
                f"and report bit-equal to the virtual mesh with its update "
                f"split as the ranks split it (params max abs diff "
                f"{diff:.3e}; to (b)'s whole-batch run on 2 positions "
                f"{gap:.3e}); K1 "
                f"launches {leg['launches']} on this rank (virtual mesh "
                f"{ref['launches']}); {leg_line(leg, ref, RANK_FLAG_ROUNDS)}"
                f"; {smi}")
    for r, mine in enumerate(pair):
        for form in ("ring", "dense"):
            leg, ref = mine["a2a"][form], more["a2a"][form]
            rank_against(torch, f"a2a-{form}", r, leg, ref)
            if leg["launches"] or ref["launches"]:
                raise RuntimeError(f"ranks a2a-{form} rank {r}: a merge "
                                   f"kernel launched: {leg['launches']}")
            log(f"[ranks] (f) All2All {form}, 100 nodes, rank {r}: "
                f"{RANK_A2A_ROUNDS} rounds, accounting, rows and report "
                f"bit-equal to the 2-position virtual mesh; final accuracy "
                f"{leg['report']['global_evals'][-1]}; "
                f"{leg_line(leg, ref, RANK_A2A_ROUNDS)}; {smi}")
        on, off = mine["telemetry"]["on"], mine["telemetry"]["off"]
        ref_on, ref_off = more["telemetry"]["on"], more["telemetry"]["off"]
        rank_against(torch, "telemetry", r, on, ref_on)
        rank_against(torch, "telemetry-off", r, off, ref_off)
        k1[f"ranks-telemetry-rank{r}"] = k1_launches(
            merge, "telemetry", r, on, ref_on, 2, 4)
        rep = on["report"]
        if len(on["live"]) != RANK_TEL_ROUNDS or not sum(
                rep["failed_per_cause"]["chaos"]):
            raise RuntimeError(f"ranks telemetry rank {r}: "
                               f"{len(on['live'])} live rows, chaos "
                               f"failures {rep['failed_per_cause']['chaos']}")
        log(f"[ranks] (g) north star with probes, sentinels, chaos and a "
            f"live receiver, rank {r}: {RANK_TEL_ROUNDS} rounds, every "
            f"report field and live row equal to the virtual mesh's (bit "
            f"for bit; the chaos gap and within-mean, which the card sums "
            f"with atomics, within 1e-5 of the value plus 1e-6); "
            f"{RANK_TEL_ROUNDS / on['wall']:.2f} rounds/s on this rank "
            f"(the same run without them {RANK_TEL_ROUNDS / off['wall']:.2f}"
            f"; virtual mesh {RANK_TEL_ROUNDS / ref_on['wall']:.2f} and "
            f"{RANK_TEL_ROUNDS / ref_off['wall']:.2f}); K1 launches "
            f"{on['launches']} (without {off['launches']}); chaos "
            f"failures {sum(rep['failed_per_cause']['chaos'])}, consensus "
            f"{rep['probe_consensus_mean'][0]:.4f} -> "
            f"{rep['probe_consensus_mean'][-1]:.4f}, trips "
            f"{sum(rep['health_trip'])}; {leg_line(on, ref_on, RANK_TEL_ROUNDS)}"
            f"; {smi}")
    return paths


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from gossipy_tpu_torch import ops
    from gossipy_tpu_torch.ops import _build, merge
    started = time.perf_counter()

    def at(phase: int) -> None:
        log(f"[time] phase {phase} starts at "
            f"{time.perf_counter() - started:.1f} s")

    # 1. device
    at(1)
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}; TF32 off for matmul and "
        "cudnn (fp32 products in full fp32)")
    rate = memory_rate(name)
    log(f"[device] memory rate for the bound: {rate / 1e12} TB/s ({name})")

    # 2. build
    at(2)
    sources = ops.SOURCES
    t0 = time.perf_counter()
    _build.build(sources)
    log(f"[build] {', '.join(sources)} built in "
        f"{time.perf_counter() - t0:.1f} s")
    for src in sources:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line or \
                    "Compiling entry" in line:
                log(f"[build]   {src}: {line.strip()}")

    # The image stand-ins (60,000 images, ~5.6 s to make) made once for
    # every phase that reads them (phases 8, 10, 11 and 14); each call
    # gets a copy of its own.
    images = contextlib.ExitStack()
    images.enter_context(images_once(copies=True))

    # 3. kernels against their plain versions
    at(3)
    from gossipy_tpu_torch.handlers import SGDHandler, losses
    from gossipy_tpu_torch.models import CIFAR10Net
    layout = SGDHandler(CIFAR10Net(), losses.cross_entropy,
                        input_shape=(32, 32, 3)).layout
    stride = layout.stride
    starts = [layout.offsets[leaf] for leaf, _ in layout.leaves]
    # Ragged shapes: F = 37 (the scalar form) and F = 44 with leaf edges at
    # columns 5, 6, 13 and 30, inside 4-column words (the vector form).
    ragged = ((5, 37, [0, 5, 6, 17]), (6, 44, [0, 5, 6, 13, 30]))
    numbers = {}
    for wire in ("float32", "bfloat16", "int8"):
        numbers[("multi", wire)] = check_multi(
            torch, merge, "phase 4", wire, N_NODES, 2, stride, SLOTS, 11,
            rate, starts)
        numbers[("single", wire)] = check_flat(
            torch, merge, wire, N_NODES, 2, stride, starts, 11, rate,
            "phase 4")
        for seed, (n, f, st) in enumerate(ragged, start=12):
            check_multi(torch, merge, "ragged", wire, n, 2, f, 3, seed, rate,
                        st)
            check_flat(torch, merge, wire, n, 2, f, st, seed, rate,
                       "ragged")
        # K3/K4's route edges (the scalar form, narrow groups of 1 to 32
        # lanes, the first wide row), bit-equality only.
        for seed, f in enumerate(SWEEP_EDGE_F, start=200):
            check_flat(torch, merge, wire, SWEEP_EDGE_N, 2, f,
                       sorted({0, f // 3, 2 * f // 3}), seed, rate, "edge",
                       timed=False)
    check_multi(torch, merge, "ragged", "float32", N_NODES, 2, stride - 2,
                SLOTS, 2, rate)
    t0 = time.perf_counter()
    sweep = merge_sweep(torch, merge, rate, stride, starts)
    log(f"[kernels] K1/K2 sweep took {time.perf_counter() - t0:.1f} s")

    # 4. the paths: first the fp32 single-pass fused deliver
    at(4)
    sim, state = cifar_sim(torch, N_NODES, 64, 32, "cuda", ROUNDS + 1)
    state, _ = sim.start(state, n_rounds=1)     # warm-up round
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = merge.LAUNCHES[merge.KERNEL]
    others = sum(merge.LAUNCHES.values()) - launches
    rounds_with_msgs = int((rep.wide_slots_per_round > 0).sum())
    log(f"[main] {N_NODES}-node CIFAR10Net, {ROUNDS} rounds: "
        f"{wall / ROUNDS * 1e3:.3f} ms/round; sent "
        f"{rep.sent_per_round.tolist()} failed {rep.failed_per_round.tolist()}"
        f"; final global accuracy {rep.final('accuracy')}; K1 launches "
        f"{launches} for {rounds_with_msgs} rounds with messages; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches != rounds_with_msgs or launches == 0 or others:
        raise RuntimeError(f"K1 launched {launches} times for "
                           f"{rounds_with_msgs} rounds with messages "
                           f"({others} other launches)")
    check_path_output(torch, sim, state, rep, "multi")

    # Where a round's time goes (after the checks: it runs more rounds).
    profile(torch, lambda: sim._round(state), "one round without eval")
    phase_times(torch, sim, state, "multi")
    del sim, state

    leg_launches = {}
    for label, fused, wire in LEGS:
        leg_launches[label] = run_leg(torch, merge, label, fused, wire)
        torch.cuda.empty_cache()

    # 5. the card against the CPU on a small run from the same seeds
    at(5)
    card_vs_cpu(torch, merge, "multi", "multi", "float32")
    for label, fused, wire in LEGS:
        card_vs_cpu(torch, merge, label, fused, wire)

    # 6. attention: K5, its gradient and the training demo
    at(6)
    k5 = attention_phase(torch, rate, name)

    # 7. the north-star configuration and the examples' network model
    at(7)
    ns_paths, at_northstar, ns_legs = northstar_phase(torch, merge, rate)

    # 8. the 100-node CIFAR-10 flagship
    at(8)
    flag_paths, at_flagship, flag_ms = flagship_phase(torch, merge, rate)
    for key, by_path in flag_paths.items():
        ns_paths.setdefault(key, {}).update(by_path)

    # 9. the four paper examples on the vanilla simulator
    at(9)
    paper_paths, at_ormandi = papers_phase(torch, merge, rate)
    for key, by_path in paper_paths.items():
        ns_paths.setdefault(key, {}).update(by_path)

    # 10. the variant simulators and the four examples they carry
    at(10)
    t0 = time.perf_counter()
    variant_paths, at_variants = variants_phase(torch, merge, rate)
    for key, by_path in variant_paths.items():
        ns_paths.setdefault(key, {}).update(by_path)
    log(f"[variants] phase 10 took {time.perf_counter() - t0:.1f} s")

    # 11. events, probes, sentinels and chaos
    at(11)
    t0 = time.perf_counter()
    tel_paths = telemetry_phase(torch, merge, flag_ms)
    for key, by_path in tel_paths.items():
        ns_paths.setdefault(key, {}).update(by_path)
    log(f"[telemetry] phase 11 took {time.perf_counter() - t0:.1f} s")

    # 12. sparse topologies at population scale
    at(12)
    t0 = time.perf_counter()
    sparse_paths, at_scale, at_ladder = sparse_phase(torch, merge, rate)
    for key, by_path in sparse_paths.items():
        ns_paths.setdefault(key, {}).update(by_path)
    log(f"[sparse] phase 12 took {time.perf_counter() - t0:.1f} s")

    # 13. the sequential high-fidelity engine
    at(13)
    t0 = time.perf_counter()
    seq_paths = sequential_phase(torch, merge, ns_legs["default"])
    for key, by_path in seq_paths.items():
        ns_paths.setdefault(key, {}).update(by_path)
    log(f"[sequential] phase 13 took {time.perf_counter() - t0:.1f} s")

    # 14. experiment configs, checkpoints and the flight recorder
    at(14)
    t0 = time.perf_counter()
    cfg_paths = config_phase(torch, merge, ns_legs)
    for key, by_path in cfg_paths.items():
        ns_paths.setdefault(key, {}).update(by_path)
    log(f"[config] phase 14 took {time.perf_counter() - t0:.1f} s")

    # 15. performance, metrics and the run ledger
    at(15)
    t0 = time.perf_counter()
    perf_paths = perf_phase(torch, merge)
    for key, by_path in perf_paths.items():
        ns_paths.setdefault(key, {}).update(by_path)
    log(f"[perf] phase 15 took {time.perf_counter() - t0:.1f} s")

    # 16. active-cohort rounds over a host pool
    at(16)
    t0 = time.perf_counter()
    cohort_paths, at_cohort = cohort_phase(torch, merge, rate)
    for key, by_path in cohort_paths.items():
        ns_paths.setdefault(key, {}).update(by_path)
    log(f"[cohort] phase 16 took {time.perf_counter() - t0:.1f} s")

    # 17. the multi-tenant service
    at(17)
    t0 = time.perf_counter()
    service_paths = service_phase(torch, merge,
                                  ns_legs["multi"]["rounds_per_s"])
    for key, by_path in service_paths.items():
        ns_paths.setdefault(key, {}).update(by_path)
    log(f"[service] phase 17 took {time.perf_counter() - t0:.1f} s")

    # 18. the parallel layer on a virtual mesh
    at(18)
    t0 = time.perf_counter()
    par_paths, at_sharded, at_ring = parallel_phase(
        torch, merge, rate, name, ns_legs["multi"]["rounds_per_s"])
    for key, by_path in par_paths.items():
        ns_paths.setdefault(key, {}).update(by_path)
    log(f"[parallel] phase 18 took {time.perf_counter() - t0:.1f} s")

    # 19. the analysis layer and the forensic twins
    at(19)
    t0 = time.perf_counter()
    ana_paths = analysis_phase(torch, merge)
    for key, by_path in ana_paths.items():
        ns_paths.setdefault(key, {}).update(by_path)
    log(f"[analysis] phase 19 took {time.perf_counter() - t0:.1f} s")

    # 20. the contract entry twin
    at(20)
    t0 = time.perf_counter()
    entry_paths = entry_phase(torch, merge)
    for key, by_path in entry_paths.items():
        ns_paths.setdefault(key, {}).update(by_path)
    log(f"[entry] phase 20 took {time.perf_counter() - t0:.1f} s")

    # 21. one gossip run across two ranks on the card
    at(21)
    t0 = time.perf_counter()
    rank_paths = ranks_phase(torch, merge, smi)
    for key, by_path in rank_paths.items():
        ns_paths.setdefault(key, {}).update(by_path)
    log(f"[ranks] phase 21 took {time.perf_counter() - t0:.1f} s")
    images.close()

    def entry(kernel, wire, source, replaces, nums, launched):
        return {"name": kernel if wire is None else f"{kernel}[{wire}]",
                "route": "cuda", "source": f"gossipy_tpu_torch/csrc/{source}",
                "replaces": f"gossipy_tpu/ops/merge.py:{replaces}",
                "launches": launched, "max_abs_err": nums["max_abs_err"],
                "ms": nums["ms"], "plain_ms": nums["plain_ms"],
                "bound_ms": nums["bound_ms"], "bound_by": nums["bound_by"],
                "library_ms": None,
                **{k: nums[k] for k in ("warm_ms", "warm_plain_ms")
                   if k in nums},
                "launches_by_path": ns_paths.get((kernel, wire or "float32"),
                                                 {})}

    kernels = [entry(merge.KERNEL, None, "gather_merge_multi.cu", 76,
                     numbers[("multi", "float32")], launches)]
    kernels[0]["at_flagship_shape"] = at_flagship[("multi", "float32")]
    kernels[0]["at_ormandi_shape"] = at_ormandi
    kernels[0]["at_giaretta_shape"] = at_variants["giaretta"]
    kernels[0]["at_scale_shape"] = at_scale
    kernels[0]["at_northstar_shape"] = at_northstar
    kernels[0]["at_ladder_shape"] = at_ladder
    kernels[0]["at_cohort_shape"] = at_cohort
    kernels[0]["at_sharded_shape"] = at_sharded
    kernels[0]["sweep"] = {label: nums for (label, wire), nums
                           in sweep.items() if wire == "float32"}
    for slots, wire, label, kernel, source, line in (
            ("multi", "bfloat16", "multi-bf16", merge.KERNEL_MULTI_DQ,
             "gather_merge_multi.cu", 100),
            ("multi", "int8", "multi-int8", merge.KERNEL_MULTI_DQ,
             "gather_merge_multi.cu", 100),
            ("single", "float32", "per_slot", merge.KERNEL_FLAT,
             "gather_merge_flat.cu", 60),
            ("single", "bfloat16", "per_slot-bf16", merge.KERNEL_FLAT_DQ,
             "gather_merge_flat.cu", 65),
            ("single", "int8", "per_slot-int8", merge.KERNEL_FLAT_DQ,
             "gather_merge_flat.cu", 65)):
        kernels.append(entry(kernel, None if wire == "float32" else wire,
                             source, line, numbers[(slots, wire)],
                             leg_launches[label][kernel]))
        if (slots, wire) in at_flagship:
            kernels[-1]["at_flagship_shape"] = at_flagship[(slots, wire)]
        if slots == "multi":
            kernels[-1]["sweep"] = {label: nums for (label, w), nums
                                    in sweep.items() if w == wire}
        if slots == "single" and ("tokenized", wire) in at_variants:
            kernels[-1]["at_tokenized_shape"] = at_variants[("tokenized",
                                                             wire)]
    for entry in k5:
        if (entry["name"], "float32") in ns_paths:
            entry["launches_by_path"] = ns_paths[(entry["name"], "float32")]
        ring = {("causal" if v["causal"] else "noncausal"): v
                for v in at_ring.values()
                if isinstance(v, dict) and v.get("route") == entry["name"]}
        if ring:
            entry["at_ring_shape"] = ring
            if entry["name"] == "flash_hop[f32]":
                ring["gradient"] = {k: v for k, v in at_ring.items()
                                    if k.startswith("grad")}
    kernels.extend(k5)
    log(f"[time] all phases took {time.perf_counter() - started:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke for ``paddlebox_tpu_torch`` on one NVIDIA H100.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0] [--phase merge]

``--phase merge`` runs phases 1-3 and 22 alone.

Phases (any failure exits non-zero; nothing is caught and swallowed):

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA kernel from ``paddlebox_tpu_torch/ops/csrc`` with nvcc
   for sm_90a, one nvcc per source, all started together, and print what
   ptxas reports on each kernel (registers, shared memory, spills); beside
   them g++ builds the native host library from ``csrc/*.cc`` (the store,
   the parser, the packer) and its build time is printed;
3. kernel checks on the card, bitwise against the plain versions:
   ``pull_rows_cuda`` against ``pull_rows_ref`` and ``write_rows_cuda``
   against ``write_rows_ref`` at W = 21, W = 128 and W = 1 (U = 0 and
   U = 7), with repeated padding rows and int32 and int64 row ids; the
   writeback with out-of-range row ids must leave every other table row
   bitwise as it was, and int32 and int64 ids must give the same table;
   the gather with out-of-range row ids (-1, R, R+5, 2**31-1) mixed into
   valid ones must give NaN rows exactly there and the plain rows elsewhere.
   At the tile edges: U in (1, T-1, T, T+1, 2T+3) for each width's tile
   of T rows, W in (1, 4, 21, 128, 4100); the writeback from a
   ``new_rows`` view with ``data_ptr() % 16 == 4``; and both kernels on a
   table of 2**21 + 8 rows of 1024 (more than 2**31 elements);
4. the serving path at full width — DeepFM, 39 slots, embedx 16, hidden
   (512, 256, 128), batch 4096 — served by ``ScoreServer(device="cuda")``
   from phase 8's ``Follower`` once it has applied the published base of
   the trained table (so phases 4 and 5 run after phase 7). A few requests
   (full batches, smaller ones, some concurrent, keys drawn hot-head +
   uniform-tail over the trained keys, with misses). Preds must be finite
   in [0, 1], reruns and coalesced requests bitwise equal to direct
   scoring, the same request with the gather forced to ``pull_rows_ref``
   bitwise equal, and a small request within PRED_ATOL of the port's CPU
   path. Every kernel of the path must have launched during the served
   run;
5. serving numbers: the gather's time at the serving shape (CUDA events,
   median of ``TIMING_REPS``, with the L2 flushed and warm), the plain
   version's and ``torch.index_select``'s times, the HBM bound, the
   32-byte-sector floor of this batch's row ids, launches per scored batch
   and request latency p50/p99;
6. the training path at the same width, as bench.py drives it: bench.py's
   data (16 files x 8192 records, 39 one-key slots, a quarter from a
   4096-key hot head, the rest uniform over 1 << 22, 20% positive) written
   from ``--seed``, then the native ``HostSparseTable(n_shards=64)`` ->
   ``BoxPSDataset(batch_size=4096, shuffle_mode="local")`` through the
   native parser -> ``begin_pass(round_to=512)`` ->
   ``CTRTrainer.prepare_pass(n_batches=96)`` -> a warm-up
   ``train_pass(n_batches=8)`` -> the timed ``train_pass(n_batches=96)``
   (three epochs, about 2.5 M unique keys) on the resident feed, K = 8
   steps a dispatch. The same 96 steps run on the packer feed, and 8 on
   the slow feed over the Python tier (Python store, ``parse_line``) with
   its own end_pass. Every step of each feed must launch
   ``pull_rows_cuda`` twice and ``write_rows_cuda`` once and every loss
   must be finite. Then: 4 steps from one state through the resident feed
   (K = 4 and K = 1), the packer feed and the slow feed give bitwise-equal
   tables, params, Adam moments and losses; 4 packed steps run twice give
   bitwise-equal state (no float atomics anywhere on the path); the same
   steps with the writeback forced to ``write_rows_ref`` give a
   bitwise-equal table; the push without dedup is bitwise repeatable; a
   few steps at a small config on the card and on the port's CPU path
   agree within the stated tolerances; one resident superstep runs under
   ``torch.cuda.set_sync_debug_mode("warn")``, counting its host syncs and
   where they come from, and under the profiler for the card's busy time.
   Last, ``end_pass`` and the native host table must hold the pass's keys
   less those ``decay_and_shrink`` dropped, each its trained row decayed;
7. training numbers: samples/s of each feed (the resident and packer
   feeds over the timed pass, the slow feed over its steps after the
   first), each feed's host-clock split over 8 profiled steps, each
   feed's own device busy ms a step (the profiler over a train_pass of
   that feed: kernels, copies and fills) and the idle share it leaves in
   that feed's step, the pass boundaries' seconds, and
   ``write_rows_cuda`` and ``pull_rows_cuda`` at the resident feed's own
   batch shape (cold and warm L2) beside their plain versions,
   ``index_copy_`` / ``index_select``, the HBM bound and the sector floor;
8. publish, follow and resume, at full width after phase 6's
   ``end_pass``: ``CheckpointManager.save_base`` of the trained native
   table (about 2.5 M keys) and dense state; a ``Follower`` on the card
   (64 host shards) applies it, its version bitwise the trainer's table
   and params, and a ``ScoreServer`` over it answers requests drawn from
   the trained keys (1% absent) with preds bitwise equal to direct scoring
   against the trainer's table and params, one ``pull_rows_cuda`` a served
   batch; phases 4 and 5 run on this follower at the base. Then the
   device scoring tier on the base: ``Follower``s with
   ``device_scoring_tier`` on, one on one shard (cuda:0) and one on two
   shards sharing cuda:0, and the base's follower (the tier off) serve
   TIER_REQUESTS requests in turns, each key drawn in proportion to the
   base's decayed show (the tier's own selection signal): preds bitwise
   the tier-off preds, tier hits and misses counted apart from the absent
   keys (the follower's health snapshot counting them), one gather a
   served batch plus one a shard for the tier, exact request p50/p99/mean
   on each, and ``pull_rows_cuda`` at the tier's shape (shard 0's bucket
   of a full served batch) bitwise against its plain version and timed
   beside ``index_select``, the byte bound and the sector floor. A second day (bench.py's generator from ``--seed + 2``, as phase
   6's data took ``--seed + 1``; 4 files, 16 resident steps) ends with
   ``end_pass(need_save_delta=False)`` and ``CheckpointManager.save_delta``,
   whose delta holds exactly the day's keys; the follower reaches delta 1
   and serves it, bitwise again. A fresh stack (native table with
   ``spill_dir`` and ``mem_cap_rows`` half the keys, a fresh trainer)
   ``resume``s bitwise the live table, params and Adam state; both stacks train a third day (``--seed + 3``, 16 steps);
   the resumed one spills at its ``end_pass`` and promotes at the next
   ``begin_pass``, after which pass tables, host tables and dense state are
   bitwise the live stack's. Every step launches 2 gathers and 1 writeback.
   Printed: the saves' seconds, bytes and keys, the follower's applies,
   ``resume``, publish to first served batch, spilled and promoted rows;
9. the pass boundary on bench.py's path ("pass_boundary"), at full width
   on fresh stacks: bench.py's data (16 files x 8192 records) and its next
   pass (``reuse_pool``: three quarters of the cold draws from pass 1's
   keys). Run 1 takes bench.py's flags (bf16 wire, pipelined, carried): the
   load, ``begin_pass(512)``, the preload of pass 2, ``prepare_pass(96)``,
   a warm-up, 96 resident steps, then ``end_pass_async(
   trained_table_device())``, ``wait_preload_done``, ``begin_pass(512)``
   (the splice: the carried rows through ``pull_rows_cuda`` and
   ``write_rows_cuda``, the departing rows fetched, the new rows sent),
   ``end_pass(None)`` and ``drain_pending``. The spliced table must be
   bitwise what the plain versions build from the carried table and the
   host rows, and the launch counts of this boundary (from 0 before
   ``end_pass_async`` to after the drain) must hold both kernels. Run 2
   is bench.py's sequential ablation (``boundary_pipeline=0``), bitwise
   equal to run 1 in the pass-2 table and the drained host table. Run 3
   (4 files, 16 steps a pass, fp32 wire, ``shrink_threshold=0``) trains
   two passes carried and two classic: pass-2 tables, pass-2 losses and
   host tables bitwise equal. Printed: bench.py's ``writeback_s``,
   ``preload_join_s``, ``finalize2_s`` and ``boundary_s``, the
   ``boundary.*`` gauges, carried, departed and new keys, the wire's bytes
   each way beside their fp32 size, pass 1's training samples/s with the
   preload running beside phase 6's, ``load_into_memory`` split into read,
   shuffle and key collection, and ``prepare_pass`` split into the
   resident upload, the batch partition, its pad stats and the index
   partition;
10. the join/update day ("join_update"), bench.py's ``PBOX_BENCH_PV``
   shape on a fresh stack: bench.py's pv data (16 files x 8192 records,
   the logkey column grouping consecutive records into queries of 1-4
   ads, cmatch 222, ranks 1..n) from ``--seed + 6``, ``parse_logkey``,
   the native store and parser, local shuffle, ``begin_pass(512)``,
   ``set_current_phase(1)``, ``preprocess_instance(max_rank=4)``;
   ``RankDeepFM(DeepFM, 39 * 19, max_rank=4)`` with
   ``model_takes_rank_offset`` and a ``MetricRegistry`` of a join (phase
   1), an update (phase 0) and a ``cmatch_rank_auc`` over "222:1,222:2"
   metric: ``prepare_pass``, a warm-up epoch, two timed epochs and an eval
   epoch on the resident pv feed (asserted through ``last_feed``, and
   ``num_pv_batches()`` equal to the plan's), each epoch counting
   ``memory_data_size()`` real instances, the eval epoch leaving table,
   params and Adam state bitwise; the join metric 4 x that at the end of
   the join phase and the update metric 0. Then 4 steps from one state
   through the resident pv feed (K = 4 and K = 1), the pv packer feed and
   the record-level feed, bitwise alike; twins and the plain gather and
   writeback, bitwise; a resident pv superstep of 8 steps through the
   trainer's stepper and registry feed with 0 host syncs, then that
   trainer's host-clock split (8 steps, one a dispatch) and the card's
   busy ms a step (the profiler over 8 steps). Then
   ``handoff_table``, ``postprocess_instance``, ``set_current_phase(0)``,
   an update trainer (the join params, a fresh Adam state) for one epoch
   on the flat resident feed, ``end_pass``; and the day at a small size
   (2 files, batch 256, dense tower (32, 16)) on the card against the
   port's CPU path. Both kernels are held against their plain versions at
   the join and the update batch's shapes. Printed: join samples/s
   (bench.py's: 2 x ``memory_data_size()`` over the timed epochs'
   seconds), the warm-up, ``preprocess_instance``, ``pv_plan`` and
   ``prepare_pass`` seconds, pvs and batches an epoch, a join step's ms,
   busy ms, idle share and host-clock split, update samples/s and the
   three metrics' log lines;
11. the model zoo ("zoo") at the JAX classes' default widths on
   bench.py's data (4 files x 8192 records from ``--seed + 7``, one key a
   slot): ``LogisticRegression(39, 19)``, ``WideDeep(39, 19,
   dense_dim=13)`` fed by a 13-wide float slot, ``DCN(108, 19)`` on 108
   slots and ``task_head(MMoE(39, 19), 0)``. For each: ``prepare_pass``, a
   warm-up epoch and two timed epochs on the resident feed (2 gathers and
   1 writeback a step), samples/s, busy ms and idle share a step, 0 host
   syncs in a resident superstep of 8, 4 steps from one state through the
   resident feed (K = 4 and K = 1) and the packer feed (and the slow feed
   for WideDeep) bitwise, and 4 steps at a small size (2 files, batch
   256, small towers) on the card against the port's CPU path. Then async
   dense on WideDeep's packer feed: a deterministic drive (``merge_limit
   =1``, a wait on each update) twice on the card, bitwise, and against
   the CPU path, then a free-running pass at full width (samples/s,
   updates, ``opt_state`` untouched); a packer pass with a
   ``DumpWorkerPool`` and ``dump_params_at_end`` (steps x batch lines,
   each pred its step's under ``.6g``, one param line a leaf under the JAX
   names, the overhead); a day through ``BoxWrapper`` (a training pass,
   an eval pass under ``set_test_mode`` leaving the state bitwise,
   ``save_base``, ``load_model`` into a second wrapper bitwise,
   ``save_cache_model``); and ``pull_rows_cuda`` at DCN's batch shape
   against its plain version, ``index_select``, the byte bound and the
   sector floor, both kernels held bitwise there;
12. the mesh ("mesh", ``CTRTrainer(plan=...)``) at the same width on
   bench.py's data (16 files x 8192 records from ``--seed + 8``), a global
   batch of 4096 (``cfg.batch_size`` 4096 / world), every rank its own
   ``HostSparseTable(n_shards=64)`` and ``BoxPSDataset(n_mesh_shards=
   world)`` over the same files, in two worlds one after the other,
   spawned by ``fleet.launch.spawn``: an NCCL world of
   ``min(device_count, 4)`` ranks, one a card (1 on a one-card machine,
   where NCCL cannot put two ranks on one GPU), then a gloo world of 2
   ranks sharing cuda:0 (every line it prints says ``"backend": "gloo",
   "ranks_per_card": 2``), whose ranks route real buckets to each other.
   Each rank: load, ``begin_pass(512)``, ``prepare_pass``, a warm-up
   ``train_pass(8)``, a timed ``train_pass(32)`` on the resident mesh feed
   (K = 8), 8 packer steps, each step launching ``pull_rows_cuda`` twice
   and ``write_rows_cuda`` once with finite losses; one packer step in
   each mesh wire mode, whose value bytes must equal ``ici_wire_nbytes``;
   4 steps from one state through the resident feed (K = 4 and K = 1),
   the packer and the slow feed, twice on the packer and with the plain
   gather and writeback, all bitwise alike; kstep and ZeRO-1 4 steps each,
   ZeRO's params within 2e-4 of step mode's; both kernels bitwise at the
   owner's ``[world x K]`` ids into its shard; the host syncs of one
   resident mesh superstep (0 required on the NCCL world); ``end_pass``
   of the gathered table, every rank's host table then the same. The 4
   steps must match the one-device trajectory on the same data, and the
   gloo world the NCCL world, within ``tests/test_sharded.py``'s bounds.
   Printed: samples/s a rank and in all, ms a step, rank 0's busy ms and
   idle share, the host split (``pack_sharded`` of the global batch, the
   dispatch, the collectives' host time), the wire bytes a step in each
   mode, ``prepare_pass`` and ``end_pass`` seconds, and both kernels at
   each world's owner shape (cold and warm) beside ``index_select`` /
   ``index_copy_``, the byte bound and the sector floor; and kstep with
   ``check_nan`` against kstep alone (16 resident steps each, ms a step
   and the pass's all-reduces);
13. the join day and the trainer's options on the mesh ("mesh_join"), in
   the same two worlds (one spawned process a rank runs phase 12, then
   phase 13): bench.py's pv data (16 files x 8192 records from
   ``--seed + 9``), every rank a replica (``n_mesh_shards=world``,
   ``preprocess_instance(max_rank=4)``, the pv plan blocked for the
   world), ``RankDeepFM(DeepFM, 39 * 19, max_rank=4)`` with phase 10's
   registry on every rank: ``prepare_pass``, a warm-up epoch, two timed
   epochs and an eval epoch on the resident pv feed (2 gathers and 1
   writeback a training step, 1 gather an eval step, on every rank; each
   epoch ``memory_data_size()`` real instances; the eval epoch leaving the
   state bitwise; the join metric 4 x that); the host syncs of a resident
   pv superstep of 8 through the trainer's stepper and registry feed (0 on
   the NCCL world) and rank 0's busy ms a step; 4 steps from one state
   through the resident pv feed, the pv packer, the record-level feed and
   a twin, bitwise, which must also match one device trained on the same
   (globalized) pv batches within phase 12's bounds; both kernels bitwise
   at the join owner's ids; the update phase on the flat resident feed;
   async dense on its pass (rank 0's table, ``merge_limit=1`` and a wait,
   twice: bitwise, and the params every rank trained on alike every step)
   and a dump (the global batch's lines on rank 0 alone); the classic
   ``end_pass``; then two passes of bench.py's data (2 files each, the
   second reusing the first's keys, 8 steps a pass) carried
   (``end_pass(trained_table_device())``: each rank splices its shard, the
   departing rows all-gathered to every host table) and classic: pass-2
   tables, losses and drained host tables bitwise. Every rank's registry,
   losses and host tables must be alike. Printed: join and update
   samples/s in all and a rank, ms a step, busy ms and idle share,
   ``boundary_s`` (end_pass + the next begin_pass) a rank, both kernels
   at each world's join owner shape.

14. the supervised day ("supervised_day"), at the same width on bench.py's
   data from ``--seed + 14`` (14 files, and 6 more that a writer thread
   streams), on cuda:0. Ingest: the first 4 files through a
   ``MultiSlotDataGenerator`` script as ``pipe_command`` and through the
   native tier, records and working-set keys bitwise alike (load seconds,
   lines/s and ``PassStats`` printed); then a copy with a seeded 0.5% of
   one file's lines corrupted, an intact ``.gz`` part and a truncated one:
   ``bad_lines`` and ``bad_files`` exactly those injected, the dead letter
   exactly those lines and the torn part, the pass admitted. The day:
   ``PassSupervisor(dataset, CTRTrainer, checkpoint=CheckpointManager)
   .run_day`` over 3 passes of 4 files (8 resident steps a pass, 4 a
   dispatch), once clean and once under an ``fs.open_read`` flake, a
   ``step.device`` fault at step 5 of pass 2 and a torn ``checkpoint.save``:
   the incidents (train_error revert_retry, ckpt_save_error retry), and the
   table, params, Adam state, AUC tables and published chain bitwise the
   clean day's, as are bare ``train_pass``'s; the quarantined pass under
   ``on_poisoned="degrade"`` (its line threshold lowered under its loss)
   bitwise a pass over the pre-cleaned files; the flight recorder's bundle
   holds the step-5 incident and the metric series reads back.
   Observability: the profiler over a supervised pass, a quarantined
   load, profiled passes on the resident and the packer feed and a
   carried boundary: every span of the JAX package's trainer,
   dataset and table in the exported chrome trace, samples/s with the
   profiler on and off, and 2 steps under ``device_trace`` naming both
   kernels as often as ``launch_counts``. The AUC runner: ``slots_shuffle``
   over 3 slots on the trained table, an eval pass each (1 gather an eval
   step) beside the unshuffled one. The stream: 8192 records every 2 s
   into a directory, a ``StreamSupervisor`` (3 s micro-passes, compaction
   every 3 deltas) and a ``Follower`` polling its chain; a
   ``stream.cut_publish`` fault crashes cut 2 with its spool durable, the
   stack restarts from disk and replays it; after 4 cuts the table and
   dense state are bitwise an uninterrupted run over the same spools.
   Every training step launches 2 gathers and 1 writeback. Every
   supervisor enables ``<its checkpoint root>/compile_cache`` ("auto");
   this process loaded both kernels in phase 2, so the phase's cache
   requests and nvcc runs are printed (none expected). Printed: the
   day's samples/s supervised and bare, a retry's seconds, ``save_base``
   / ``save_delta`` s, the span counts, each slot's shuffled AUC, and the
   stream's ``serve.freshness_s`` p50 and p99, records a cut and backlog
   stretches;
15. the multi-host day ("multihost"), at the same width on bench.py's data
   from ``--seed + 15``: host processes of their own, each a rank of a
   gloo world on cuda:0 (NCCL refuses two ranks a card) and a node of the
   host plane (its own ``TcpTransport`` on a free 127.0.0.1 port), its
   stripe of the files in its own ``HostSparseTable`` and
   ``BoxPSDataset(transport=)``. Two hosts, 2,048 records each of the
   4,096 global batch: a resident pass of 8 + 32 steps (K = 8), 8 packer
   steps and 8 ZeRO-1 steps on its keys; an ``ins_id`` shuffle pass over
   ``TcpShuffleRouter`` with 9 files against 7 (the short host wraps the
   all-reduced batch count); two carried passes of 2 overlapping files a
   host (a ``MultiHostCarrier`` splice); the ``PBOX_BENCH_PV`` join day
   with 3 files against 1 (one join epoch, ghost batches on the short
   host, and the update epoch); and a small config (2 files a host, batch
   256, a (32, 16) tower, 4 steps) held against the same two hosts on the
   CPU within phase 12's mesh bounds. Then four hosts, 8 + 8 resident
   steps. Checked: the hosts' keys disjoint, their union the pass's
   referenced keys and every host's rows and capacity a single-process
   ``PassWorkingSet``'s exactly; every all-reduced count the same on every
   host; 2 gathers + 1 writeback a step on every host; both kernels
   bitwise at the owner's ids (this host's request buckets all-to-all'd).
   Printed: samples/s and ms a step a host, the key exchange's seconds in
   ``finalize``, the lockstep rounds' seconds and the transport's bytes
   over a pass, the carried ``boundary_s``, a host's pack of its own
   batch beside the replicated mesh's ``pack_sharded``, and both kernels
   timed at the owner's shapes. A failing host fails the spawn;
16. the supervisor over several ranks ("supervised_hosts"): two host
   processes on cuda:0 as in phase 15 (bench.py's data from ``--seed +
   16``, 2 files a host a pass, 2,048 records a host a step), each under
   ``PassSupervisor(transport=)`` with its chain under ``rank_root``, run
   ``run_day`` over 3 passes three times: clean; poisoned (2% of rank 1's
   pass-2 lines unparsable, ``on_poisoned="skip_pass"``: both hosts drop
   pass 2, each ending bitwise the clean day's pass 1); and faulted (rank
   1's gate rejects pass 1's first attempt once, through a harness
   subclass: rank 0 records ``peer_abort``, rank 1 ``gate_auc``, one
   revert each, both epochs 1, and every pass's table, dense state, AUC
   tables and AUC and the chain's arrays bitwise the clean day's). 2
   gathers + 1 writeback a step on every host, the reverted attempt's
   counted; both kernels bitwise at the owner's ids; each host's
   supervisor enables ``<rank root>/compile_cache`` before its first
   launch, so its libraries come through the cache, copied from the
   package's ``_build/`` (its stats printed; an nvcc run there fails the
   phase). Beside the spawn, in
   threads of this process and without the card, the JAX package's two
   elastic schedules through the port's supervisor over a real
   ``HostSparseTable``, ``DistributedWorkingSet`` and ``TcpTransport``
   (EL_RECORDS records a pass of EL_KEYS bench.py keys, embedx 16):
   kill-rank (4 ranks, rank 1 dies at pass 1) and join-rank (rank 1 dies,
   a new incarnation rejoins, 5 passes), each bitwise a fresh run (the
   ownership-filtered merged digest, every pass's AUC). Printed: samples/s
   over both hosts, the faulted attempt's s, the verdict rounds' s a pass,
   the saves' s, the membership rounds', adoptions' and migrations' s and
   keys;
17. the serving fleet ("serve_fleet"): a full-width producer publishes a
   base and a delta; a ``FleetStage`` mirrors them (a torn fetch under
   ``serve.fleet_stage`` never writes the stage watermark); two
   ``FleetFollower``s on cuda:0 and a ``FleetClient`` on a third transport
   rank; FL_REQUESTS requests of 256-4,096 records, half at each version,
   bitwise the trainer-direct scoring, one gather a served batch; the
   hedge rescuing a stalled follower, drain and admit confirmed by the
   follower's gossip, the typed overload refusal; the client's latencies
   beside one ``ScoreServer``'s on the first FL_DIRECT requests, and the
   gather at a follower's shape bitwise and timed;
18. the long tail ("long_tail"), at full width: the extended pull
   (``use_expand``) on ``ValueLayout(embedx_dim=16, expand_embed_dim=8)``
   (its width printed) with ``tests/test_replica_cache.py``'s expand model
   over bench.py's data from ``--seed + 18`` (2 files, 16,384 records, 4
   steps a feed): the resident feed at K = 4 and K = 1, the packer and the
   slow feed and a packer twin with the plain gather and writeback give
   bitwise-equal tables, params, Adam moments and losses; 2 gathers + 1
   writeback a step; the expand block and its g2 column train on the
   touched rows; a resident superstep makes no host sync; the card is
   within phase 6's bounds of the port's CPU path; both kernels timed at
   this W. In phase 12's spawned worlds (NCCL and gloo) the same trainer
   takes 4 resident steps on the mesh, within phase 12's bounds of one
   device fed the same global batches, both kernels bitwise at the
   owner's ids. ``pull_cache_value`` on a 1,048,576 x 16 ``ReplicaCache``
   at 4,096 x 39 ids (with ids at and past both ends) launches one
   ``pull_rows_cuda``, bitwise its plain version and the host rows where
   they are defined, NaN elsewhere, and an ``InputTable`` with its miss
   row answers as ``lookup_input``; the gather there is timed beside
   ``index_select``. The CONV, PCOC and per-slot-threshold seqpools,
   their transforms, ``batch_fc`` and ``fused_concat`` at the flagship
   shape against the CPU path; the strategy's ``recompute`` bitwise the
   plain DeepFM over a superstep, ``amp``'s logits against the CPU path
   within AMP_ULPS bf16 ulps, and ``gradient_merge`` (k = 4) over 8
   steps: params bitwise unchanged on the mini-steps that do not emit,
   the emitting ones within phase 6's params bound of the CPU path, no
   host sync in a ``MultiSteps`` superstep;
19. pipeline parallelism ("pipeline") at the width of DeepFM's dense
   tower, 741 -> 512 -> 256 -> 128 -> 1, as heterogeneous stages
   (``hetero_mlp_stage_init``; two stages are [[741, 512, 256], [256,
   128, 1]]), BATCH as 4 microbatches of 1024 from ``--seed + 19``, MSE
   of the output lane against tanh targets, 8 Adam steps (lr 1e-4, eps
   1e-3): in phase 12's worlds with pp = the world (the NCCL world of one
   rank a card shifts to itself when there is one card; the gloo world of
   2 on cuda:0), and in a new gloo world of 4 on cuda:0, pp 2 x dp 2 (``make_mesh_2d``), with
   plain Adam and with ZeRO-1 from ``DistributedStrategy(pipeline=True,
   sharding=True, pipeline_configs={"micro_batch": 4, "dp_degree":
   2})``. Each run is held against the unpadded tower in order on one
   device (loss rtol 5e-5; weights rtol 5e-4, atol 5e-5; the padding
   exactly 0, the gates untouched), ZeRO-1 against plain Adam (rtol 1e-6,
   atol 1e-7), the 2 x 2 world's first loss against the 2-rank world's
   (rtol 2e-5); a step's shifts and all-reduces are the tests' count, and
   no kernel launches. Each world's median ms a step and samples/s are
   printed;
20. sequence parallelism ("seqpar"): ``ring_attention`` and
   ``ulysses_attention`` at a 7B-class decoder's attention widths (32
   heads of 128, as Llama-2-7B's) over a global sequence of 8,192, B 1,
   q, k and v drawn on the card from ``--seed + 20``; in phase 12's
   worlds (the NCCL world of one rank a card, the gloo world of 2 on
   cuda:0) and in phase 19's gloo world of 4 on cuda:0 taken as one 1-D
   world after its pipeline, TF32 off. On every rank, against full
   attention computed plainly on one device, query block by query block
   in fp32: each function causal and not (rtol 2e-4, atol 2e-5), bf16
   inputs (bf16 out, under 0.02 of fp32) and the causal grads of
   sum(out) (rtol 5e-4, atol 5e-5); the later worlds' outputs against the
   NCCL world's (rtol 2e-4, atol 2e-5); a forward and backward makes 2 (n
   - 1) shifts (ring) or 4 all_to_alls (Ulysses) on every rank, and no
   kernel launches. Each world's median ms of a causal fp32 forward and of
   a forward + backward, and each rank's peak memory, are printed;
21. the compile cache ("compile_cache") over the kernels' nvcc builds:
   four fresh processes, each started in a fresh copy of the package (no
   ``_build/``), each a ``PassSupervisor`` over a ``CheckpointManager`` and
   one supervised pass at bench.py's width (DeepFM, 39 slots, embedx 16,
   hidden (512, 256, 128), batch 4096) of CC_FILES of bench.py's files
   from ``--seed + 21`` (cut from 16; 2 steps) on the Python tier, so
   that g++ builds nothing into the copy either. Under "auto" a cold
   process on a fresh checkpoint root (cache requests 2, misses 2, hits 0,
   nvcc run twice, 2 entries in ``<root>/compile_cache``), then a warm one
   on the same root (hits 2, misses 0, no nvcc, its ``_build/`` absent);
   the same pair with an explicit ``compile_cache_dir`` on fresh roots
   (nothing under ``<root>/compile_cache``); the two cold processes at
   once, then the two warm. Each: 2 gathers + 1 writeback a step, table,
   params, Adam state and losses bitwise the cold "auto" process's, both
   kernels bitwise at phase 7's training shape. Printed: the stats, the
   nvcc seconds, the first step's time (the kernels' build or load in it)
   and the later steps', cold and warm;
22. the push merge ("merge"): ``merge_rows_cuda`` at the step shape of
   each benchmark cell (``deepfm-criteo.steady``, ``widedeep-criteo.steady``,
   ``dlrm-dcnv2-criteo1tb.multihot``): one batch of the cell's traffic
   from ``--seed + 22`` (``bench_port``'s generators), flattened
   slot-major, deduplicated and padded as the resident feed pads it, with
   random gradients; bitwise against ``merge_rows_ref`` on the card, then
   the median of ``TIMING_REPS`` CUDA-event timings, L2 flushed and warm,
   of the kernel, the plain version, the former merge (with its sort) and
   ``torch.segment_reduce`` over the pre-sorted [L, PW + 2] rows, beside
   the byte bound, the rows' sector floor, the heavy rows' count and the
   light and heavy passes' device time under ``torch.profiler``.

Every number is printed beside the card's name and power limit; then the
``kernels`` line, the nvidia-smi line, and last ``{"ok": true, "device":
{...}}``. It exits non-zero without a result when no CUDA device is
present.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import faulthandler
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

NUM_SLOTS = 39
EMBEDX_DIM = 16
HIDDEN = (512, 256, 128)
BATCH = 4096
KEY_SPACE = 1 << 22
HOT_KEYS = 1 << 12  # bench.py's hot head
HOT_FRAC = 0.25
MISS_FRAC = 0.01
# the device tier's traffic (phase 8): requests of 8 to TIER_SERVE_BATCH
# records, each key drawn in proportion to the base's decayed show (the
# tier's own selection signal), served one at a time by a server whose
# batch is TIER_SERVE_BATCH records, the tier off and on in turns
TIER_REQUESTS = 150  # cut from 300 for the script's time
TIER_SERVE_BATCH = 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
TIMING_REPS = 30
KERNEL_NAMES = ("pull_rows_cuda", "write_rows_cuda", "merge_rows_cuda")  # the wrappers' launch counts
# phase 8: the training day's publish, follow and resume
PUB_DATE = "20261017"
DAY_FILES = 4  # part files of the second and third days (bench.py's generator)
DAY_STEPS = 16  # resident steps of the second and third passes: two epochs of 4 files
# bf16 MLP: cuBLAS and the CPU backend round the bf16 products at
# different places; preds are sigmoids, so a logit gap d moves them <= d/4
PRED_ATOL = 2e-2
GATHER_REPLACES = "paddlebox_tpu/ops/pallas_kernels.py:75"
WRITE_REPLACES = "paddlebox_tpu/ops/pallas_kernels.py:114"
MERGE_REPLACES = "none: the JAX package leaves the push merge to XLA; the original's PushMergeCopy"
# the training path (bench.py's shape)
N_FILES = 16
RECORDS_PER_FILE = 8192  # 131072 records = 32 batches per epoch
POS_FRAC = 0.2
TRAIN_BATCHES = 96  # bench.py's TRAIN_BATCHES: three epochs
WARM_BATCHES = 8
RESIDENT_K = 8  # resident_scan_batches: steps a superstep
PROFILE_BATCHES = 8  # steps of the host-clock split, one batch a dispatch
SLOW_BATCHES = 8  # the Python tier's slow feed, cut from 32 for time
SLOW_BUSY_STEPS = 4  # slow-feed steps under the profiler for its busy time
FEED_STEPS = 4
TWIN_STEPS = 4
REPO = os.path.dirname(os.path.abspath(__file__))
# phase 10: bench.py's join shape (PBOX_BENCH_PV=1)
MAX_RANK = 4  # the generator's ranks are 1..4
JOIN_TIMED_EPOCHS = 2
JOIN_FEED_STEPS = 4  # steps of the four-feed and twin checks
JOIN_SYNC_STEPS = 8  # one resident pv superstep at K = RESIDENT_K
JOIN_SMALL_FILES = 2  # the card against the CPU path
JOIN_SMALL_BATCH = 256
JOIN_SMALL_STEPS = 4  # steps of each phase there
# phase 6's small dense tower there: at full width the bf16 MLP's rounding,
# which differs between cuBLAS and the CPU, flips a few ReLU units within
# a few steps, and Adam moves each weight they feed by up to lr a step
JOIN_SMALL_HIDDEN = (32, 16)
# there the params differ by ~2e-5 after the update phase's first steps:
# its fresh Adam state divides each gradient element by its own magnitude,
# so an element near zero whose bf16 rounding differs moves its weight by
# up to lr (1e-3) a step; the bound is test_torch_train_step.py's, under
# that worst case. The table and the loss keep phase 6's bounds.
JOIN_PARAMS_ATOL = 2e-4
# card vs the port's CPU path, a few training steps at a small config. The
# bf16 MLP may round at other places in cuBLAS and the CPU backend, and a
# dense weight whose grad is near zero can then take another Adam step of
# up to lr = 1e-3. Measured on an H100 at 700 W: table max |diff| 7.5e-9,
# params 2.3e-10, loss relative 7.2e-8; the bounds leave 10x-1000x room
# and stay under one Adam step
SMALL_STEPS = 3
SMALL_TABLE_RTOL, SMALL_TABLE_ATOL = 1e-4, 1e-6
SMALL_PARAMS_ATOL = 1e-5
SMALL_LOSS_RTOL = 1e-5
# phase 11: the zoo at the JAX classes' default widths, bench.py's data
ZOO_NAMES = ("lr", "wide_deep", "dcn", "mmoe")
ZOO_FILES = 4  # x RECORDS_PER_FILE: 8 batches an epoch
ZOO_DENSE_DIM = 13  # Criteo-Kaggle's numeric columns, WideDeep's dense slot
DCN_SLOTS = 108  # BASELINE config 4
ZOO_TIMED_EPOCHS = 2
ZOO_FEED_STEPS = 4
ZOO_SMALL_FILES = 2  # the card against the CPU path
ZOO_SMALL_BATCH = 256
ZOO_SMALL_STEPS = 4
ZOO_PARAMS_ATOL = 2e-4  # phase 10's JOIN_PARAMS_ATOL, for the same reason
# an element whose gradients on the card and the CPU differ by more than
# this share of their size at some step is left to Adam's bound, 2 lr a
# step: the bf16 tower's rounding decides its update (DCN's first tower
# layer over 2,052 inputs has many; PERF.md, phase 11)
ZOO_GRAD_REL = 0.05
ZOO_BOX_FILES = 2  # the façade's day
# phase 3's tile-edge widths: the kernels' tile is TILE_FLOATS floats, so
# 4100 is past it and is cut into column slabs
EDGE_WIDTHS = (1, 4, 21, 128, 4100)
BIG_TABLE = (2**21 + 8, 1024)  # 2**31 + 8192 f32 elements, 8.6 GB
# phase 14: the supervised day, its ingest, observability, the AUC runner
# and the stream, on bench.py's data from --seed + 14
PUB14_DATE = "20261018"
SUP_PASSES = 3
SUP_FILES = 4  # x RECORDS_PER_FILE: 32768 records, 8 steps a pass
SUP_K = 4  # resident_scan_batches on the day: step 5 of a pass opens its second dispatch
AUC_FILES = 2  # the AUC runner's eval pass: 16384 records, 4 eval steps
AUC_SLOTS = ("s0", "s1", "s2")
STREAM_CHUNKS = 6  # the writer's chunk files, appended in turn
STREAM_EVERY_S = 2.0  # a chunk of RECORDS_PER_FILE records every 2 s
STREAM_MICRO_S = 3.0  # stream_micro_pass_s
STREAM_COMPACT = 3  # stream_compact_every
STREAM_CUTS = 4  # cut from 6 for the script's time; the fourth still compacts
STREAM_FAULT_HIT = 3  # stream.cut_publish's third fire: cut 2, its spool durable and untrained
STREAM_DEADLINE_S = 240.0  # a stream that stalls fails here instead of hanging


def smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, flush) -> float:
    """Device time of one call of ``fn``, from CUDA events.

    ``flush`` (a tensor larger than the 50 MB L2, or None for a warm L2) is
    read first, which evicts the inputs and leaves the cache clean. A
    sleep kernel then holds the card while the host enqueues the events and
    ``fn``'s launches, so the events time the device work and not the
    host's launch overhead."""
    if flush is not None:
        flush.sum()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def make_records(rng, keys, n, miss_frac=MISS_FRAC, cdf=None):
    """``n`` SlotRecords of one key per slot, ``miss_frac`` absent: a
    quarter from the hot head, the rest uniform over the committed keys;
    with ``cdf`` (the running sum of the keys' hotness) each key drawn in
    proportion to its hotness instead."""
    from paddlebox_tpu_torch.data import SlotRecord

    if cdf is None:
        idx = rng.integers(0, len(keys), (n, NUM_SLOTS))
        hot = rng.integers(0, HOT_KEYS, (n, NUM_SLOTS))
        idx = np.where(rng.random((n, NUM_SLOTS)) < HOT_FRAC, hot, idx)
    else:
        idx = np.searchsorted(cdf, rng.random((n, NUM_SLOTS)) * cdf[-1], side="right")
    k = keys[idx]
    # committed keys are < 2**63; these never are
    absent = rng.integers(1 << 63, (1 << 64) - 1, (n, NUM_SLOTS), dtype=np.uint64)
    k = np.where(rng.random((n, NUM_SLOTS)) < miss_frac, absent, k)
    labels = (rng.random(n) < 0.2).astype(np.float32)
    u_off = np.arange(NUM_SLOTS + 1, dtype=np.uint32)
    f_off = np.array([0, 1], dtype=np.uint32)
    return [
        SlotRecord(u64_values=k[i], u64_offsets=u_off, f_values=labels[i : i + 1], f_offsets=f_off)
        for i in range(n)
    ]


def check_gather(ck, table, rows, what):
    got = ck.pull_rows_cuda(table, rows)
    torch.cuda.synchronize()
    want = ck.pull_rows_ref(table, rows)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"pull_rows_cuda != pull_rows_ref at {what}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    print(f"kernel check pull_rows_cuda {what}: bitwise equal", flush=True)
    return err


def check_write(ck, table, rows, new_rows, what):
    """``write_rows_cuda`` against ``write_rows_ref`` on copies of ``table``,
    the ids outside [0, R) taken out of the plain side (the kernel skips
    them)."""
    got = ck.write_rows_cuda(table.clone(), rows, new_rows)
    torch.cuda.synchronize()
    want = ck.write_rows_ref(table.clone(), *ck.drop_out_of_range(table, rows, new_rows))
    if not torch.equal(got, want):
        raise AssertionError(f"write_rows_cuda != write_rows_ref at {what}")
    print(f"kernel check write_rows_cuda {what}: bitwise equal", flush=True)
    return float((got - want).abs().max()) if got.numel() else 0.0


def write_case(dev, g, R, W, U):
    """A table, U row ids unique but for padding-row repeats at the tail
    (R - 1), and new rows whose repeats carry identical contents."""
    table = torch.randn((R, W), device=dev, generator=g)
    rows = torch.randperm(R - 1, device=dev, generator=g)[:U].to(torch.int32)
    n_pad = max(U // 64, min(U, 3))
    rows[U - n_pad :] = R - 1
    new_rows = torch.randn((U, W), device=dev, generator=g)
    new_rows[U - n_pad :] = new_rows[U - 1].clone() if U else new_rows[:0]
    return table, rows, new_rows


def check_write_kernel(ck, dev, g):
    """Phase 3's writeback checks; returns the max abs error seen."""
    err = 0.0
    for R, W, U in ((160_000, 21, 122_624), (65_536, 128, 16_384), (100, 1, 0), (100, 1, 7)):
        table, rows, new_rows = write_case(dev, g, R, W, U)
        for r in (rows, rows.long()):
            err = max(err, check_write(ck, table, r, new_rows, f"R={R} W={W} U={U} {r.dtype}"))
        a = ck.write_rows_cuda(table.clone(), rows, new_rows)
        b = ck.write_rows_cuda(table.clone(), rows.long(), new_rows)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"int32 and int64 row ids give different tables at R={R} W={W}")
    print("kernel check write_rows_cuda: int32 and int64 row ids give the same table", flush=True)
    # out-of-range ids write nothing; every row outside the written set keeps its bytes
    R, W = 4096, 21
    table, rows, new_rows = write_case(dev, g, R, W, 512)
    bad = torch.tensor([-1, R, R + 5, 2**31 - 1], device=dev, dtype=torch.int64)
    rows64 = torch.cat([rows.long(), bad])
    new64 = torch.cat([new_rows, torch.randn((len(bad), W), device=dev, generator=g)])
    got = ck.write_rows_cuda(table.clone(), rows64, new64)
    got32 = ck.write_rows_cuda(table.clone(), rows64.clamp(max=2**31 - 1).to(torch.int32), new64)
    torch.cuda.synchronize()
    want = ck.write_rows_ref(table.clone(), rows, new_rows)
    if not (torch.equal(got, want) and torch.equal(got32, want)):
        raise AssertionError("write_rows_cuda with out-of-range row ids touched other rows")
    print("kernel check write_rows_cuda: out-of-range row ids write nothing, other rows bitwise unchanged", flush=True)
    return err


def check_tile_edges(ck, dev, g):
    """Phase 3's checks at the kernels' tile edges; returns the max abs
    error seen.

    U at and around each width's tile of T rows (a width past the tile
    budget is cut into column slabs: W = 4100) and a ``new_rows`` view that
    is not 16-byte aligned, with int32 and int64 row ids."""
    cases = []  # (what, the kernel's result, the plain version's)
    for W in EDGE_WIDTHS:
        T = ck.tile_geometry(1, W).tile_rows
        for U in (1, T - 1, T, T + 1, 2 * T + 3):
            R = 2 * U + 64
            table = torch.randn((R, W), device=dev, generator=g)
            rows = torch.randint(0, R - 1, (U,), device=dev, generator=g, dtype=torch.int32)
            rows[U - max(U // 64, 1) :] = R - 1
            wt, wrows, new_rows = write_case(dev, g, R, W, U)
            for dt in (torch.int32, torch.int64):
                r, wr = rows.to(dt), wrows.to(dt)
                what = f"T={T} R={R} W={W} U={U} {dt}"
                cases.append((f"pull_rows_cuda {what}", ck.pull_rows_cuda(table, r), ck.pull_rows_ref(table, r)))
                cases.append((f"write_rows_cuda {what}", ck.write_rows_cuda(wt.clone(), wr, new_rows),
                              ck.write_rows_ref(wt.clone(), wr, new_rows)))
    # new_rows as a view 4 bytes past a 16-byte boundary
    for W in (4, 21, 128):
        U = 2 * ck.tile_geometry(1, W).tile_rows + 3
        table, rows, aligned = write_case(dev, g, 2 * U + 64, W, U)
        view = torch.empty(U * W + 1, device=dev)[1:].view(U, W)
        view.copy_(aligned)
        if view.data_ptr() % 16 == 0:
            raise AssertionError("the misaligned view is aligned")
        for dt in (torch.int32, torch.int64):
            r = rows.to(dt)
            cases.append((f"write_rows_cuda misaligned new_rows W={W} U={U} {dt}",
                          ck.write_rows_cuda(table.clone(), r, view), ck.write_rows_ref(table.clone(), r, view)))
    torch.cuda.synchronize()
    err = 0.0
    for what, got, want in cases:
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"kernel != plain version at {what}")
        err = max(err, float((got - want).abs().max()) if got.numel() else 0.0)
    print(f"kernel check tile edges: {len(cases)} cases bitwise equal (U in (1, T-1, T, T+1, 2T+3) "
          f"at W in {EDGE_WIDTHS}; new_rows view at data_ptr % 16 == 4 at W in (4, 21, 128); "
          "int32 and int64 ids)", flush=True)
    return err


def check_gather_out_of_range(ck, dev, g):
    """The gather with out-of-range row ids mixed into valid ones: NaN rows
    exactly at those positions, the plain version's rows everywhere else."""
    R, W = 4096, 21
    table = torch.randn((R, W), device=dev, generator=g)
    bad_ids = torch.tensor([-1, R, R + 5, 2**31 - 1], device=dev).repeat(8)
    rows = torch.cat([torch.randint(0, R, (1000,), device=dev, generator=g), bad_ids])
    rows = rows[torch.randperm(len(rows), device=dev, generator=g)]
    bad = (rows < 0) | (rows >= R)
    for dt in (torch.int32, torch.int64):
        got = ck.pull_rows_cuda(table, rows.to(dt))
        torch.cuda.synchronize()
        if not (bool(torch.isnan(got[bad]).all()) and not bool(torch.isnan(got[~bad]).any())
                and torch.equal(got[~bad], ck.pull_rows_ref(table, rows[~bad]))):
            raise AssertionError(f"pull_rows_cuda with out-of-range {dt} row ids")
    print(f"kernel check pull_rows_cuda: {int(bad.sum())} out-of-range row ids (-1, R, R+5, 2**31-1) "
          "give NaN rows exactly there, the other rows bitwise equal, int32 and int64", flush=True)


def check_big_table(ck, dev, g):
    """Both kernels on a table of more than 2**31 elements (8.6 GB), with
    only the touched rows and their neighbours filled."""
    R, W = BIG_TABLE
    table = torch.empty((R, W), device=dev)
    rows = torch.cat([
        torch.tensor([0, R - 1, R - 2, R - 5, R // 2, min((1 << 31) // W, R - 3)], device=dev),
        torch.randperm(R - 8, device=dev, generator=g)[:250] + 4,
    ]).unique()
    rows = rows[torch.randperm(len(rows), device=dev, generator=g)]
    nbr = torch.cat([rows - 1, rows + 1]).clamp(0, R - 1).unique()
    nbr = nbr[~torch.isin(nbr, rows)]
    filled = torch.cat([rows, nbr])
    ck.write_rows_ref(table, filled, torch.randn((len(filled), W), device=dev, generator=g))
    for dt in (torch.int32, torch.int64):
        r = rows.to(dt)
        got = ck.pull_rows_cuda(table, r)
        torch.cuda.synchronize()
        if not torch.equal(got, ck.pull_rows_ref(table, r)):
            raise AssertionError(f"pull_rows_cuda on a table of {R * W} elements, {dt} ids")
        before = ck.pull_rows_ref(table, nbr)
        new_rows = torch.randn((len(rows), W), device=dev, generator=g)
        ck.write_rows_cuda(table, r, new_rows)
        torch.cuda.synchronize()
        if not (torch.equal(ck.pull_rows_ref(table, rows), new_rows)
                and torch.equal(ck.pull_rows_ref(table, nbr), before)):
            raise AssertionError(f"write_rows_cuda on a table of {R * W} elements, {dt} ids")
    print(f"kernel check table of {R} x {W} = {R * W} elements (> 2**31), rows up to {R - 1}, "
          "int32 and int64: gather bitwise equal, writeback sets exactly its rows", flush=True)
    del table
    torch.cuda.empty_cache()


def sector_floor_ms(rows, R, W, write):
    """Least time of a row copy at these row ids when memory moves in
    32-byte sectors: every distinct table sector the rows touch, the
    contiguous [U, W] side and the ids once, over the HBM rate. The
    writeback also reads each sector that its rows cover only in part,
    since the L2 must merge it before writing it back."""
    rows = rows.long()
    uniq = torch.unique(rows[(rows >= 0) & (rows < R)])
    start = (uniq * (W * 4))[:, None]
    sec = start // 32 + torch.arange((W * 4 + 31) // 32 + 1, device=rows.device)[None, :]
    cover = (torch.minimum(start + W * 4, sec * 32 + 32) - torch.maximum(start, sec * 32)).clamp(min=0)
    hit = cover > 0
    ids, inv = torch.unique(sec[hit], return_inverse=True)
    covered = torch.zeros(len(ids), dtype=torch.long, device=rows.device).index_add_(0, inv, cover[hit])
    table_bytes = 32 * len(ids) + (32 * int((covered < 32).sum()) if write else 0)
    U = rows.numel()
    return (table_bytes + U * W * 4 + 4 * U) / HBM_BYTES_PER_S * 1e3


def time_fns(fns, flush, restore=None):
    """Median device ms of each fn, L2 flushed (cold) and warm, in turns.

    ``restore`` runs before each cold call, outside the timed region (the
    flush evicts what it touched). The writeback is idempotent (the same
    bytes land on every call), so warm calls need no restore."""
    for fn in fns.values():
        fn()
    cold = {k: [] for k in fns}
    warm = {k: [] for k in fns}
    for rep in range(TIMING_REPS):
        order = list(fns) if rep % 2 == 0 else list(fns)[::-1]
        for k in order:
            if restore is not None:
                restore()
            cold[k].append(cuda_ms(fns[k], flush))
            warm[k].append(cuda_ms(fns[k], None))
    return (
        {k: float(np.median(v)) for k, v in cold.items()},
        {k: float(np.median(v)) for k, v in warm.items()},
    )


def bench_logkey(search_id: int, cmatch: int, rank: int) -> str:
    """bench.py's logkey: 11 pad chars, 3-hex cmatch, 2-hex rank, 16-hex
    search id (the reference's SlotRecord layout)."""
    return "0" * 11 + format(cmatch, "03x") + format(rank, "02x") + format(search_id, "016x")


def write_bench_files(tmpdir, rng, n_files=N_FILES, tag="part", reuse_pool=None, pv=False, n_slots=None,
                      dense_dim=0, ins_ids=False):
    """bench.py's ``write_files``: ``n_files`` x RECORDS_PER_FILE slot
    lines, one key a slot (``n_slots``, NUM_SLOTS by default), a quarter
    from the hot head, the rest uniform, POS_FRAC positive; with
    ``reuse_pool`` three quarters of the cold draws come from it (bench.py's
    next pass); with ``pv`` a logkey column first groups consecutive
    records into queries of 1-4 ads, cmatch 222, ranks 1..n (bench.py's
    join-phase data); with ``dense_dim`` a float slot of that many values
    follows the label (log1p of exponential counts, as Criteo's numeric
    columns are usually fed); with ``ins_ids`` an instance id column comes
    first (``ins-<tag>-<file>-<line>``, for the ins_id shuffle). Returns
    (files, this pass's cold keys)."""
    files, pool = [], []
    search_id = 1
    n_slots = n_slots or NUM_SLOTS
    for fi in range(n_files):
        n = RECORDS_PER_FILE
        hot = rng.integers(1, HOT_KEYS, (n, n_slots))
        cold = rng.integers(1, KEY_SPACE, (n, n_slots))
        if reuse_pool is not None:
            recur = reuse_pool[rng.integers(0, len(reuse_pool), (n, n_slots))]
            cold = np.where(rng.random((n, n_slots)) < 0.75, recur, cold)
        take_hot = rng.random((n, n_slots)) < HOT_FRAC
        keys = np.where(take_hot, hot, cold)
        pool.append(keys[~take_hot])
        labels = (rng.random(n) < POS_FRAC).astype(np.int32)
        dense = [""] * n
        if dense_dim:
            vals = np.log1p(rng.exponential(8.0, (n, dense_dim)))
            dense = [f"{dense_dim} " + " ".join(f"{v:.4f}" for v in row) + " " for row in vals]
        heads = [""] * n
        if pv:
            i = 0
            while i < n:
                n_ads = int(rng.integers(1, 5))
                for r in range(1, min(n_ads, n - i) + 1):
                    heads[i + r - 1] = f"1 {bench_logkey(search_id, 222, r)} "
                search_id += 1
                i += n_ads
        if ins_ids:
            heads = [f"1 ins-{tag}-{fi:03d}-{i:06d} " + h for i, h in enumerate(heads)]
        path = os.path.join(tmpdir, f"{tag}-{fi:03d}.txt")
        with open(path, "w") as f:
            for i in range(n):
                f.write(heads[i] + f"1 {labels[i]}.0 " + dense[i] + " ".join(f"1 {k}" for k in keys[i]) + "\n")
        files.append(path)
    return files, np.concatenate(pool)


def fresh_state(table0, params0, opt0, dev):
    """A training state on ``dev`` from copies of a host table, params and
    Adam state."""
    from paddlebox_tpu_torch.metrics import auc_init
    from paddlebox_tpu_torch.train import AdamState, TrainState

    return TrainState(
        table=torch.from_numpy(table0).to(dev, copy=True),
        params={k: v.clone() for k, v in params0.items()},
        opt_state=AdamState(
            opt0.count.clone(),
            {k: v.clone() for k, v in opt0.mu.items()},
            {k: v.clone() for k, v in opt0.nu.items()},
        ),
        auc=auc_init(1000, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def run_steps(step, table0, params0, opt0, feeds, dev):
    """``len(feeds)`` calls of ``step`` from a fresh copy of one state."""
    st = fresh_state(table0, params0, opt0, dev)
    losses = []
    for f in feeds:
        st, m = step(st, f)
        losses.append(m["loss"])
    return st, losses


def same_state(a, b) -> bool:
    return (
        torch.equal(a.table, b.table)
        and all(torch.equal(a.params[k], b.params[k]) for k in a.params)
        and all(torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]) for k in a.params)
        and all(torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]) for k in a.params)
    )


def small_card_vs_cpu(seed):
    """A few training steps at a small config on the card and on the port's
    CPU path, from one state; raises if they disagree."""
    from torch.func import functional_call

    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.table import SparseOptimizerConfig, ValueLayout
    from paddlebox_tpu_torch.train import Adam, TrainStepConfig, make_train_step

    S, B, D, R, lr = 5, 64, 4, 512, 1e-3
    lay = ValueLayout(embedx_dim=D)
    rng = np.random.default_rng(seed)
    table0 = (0.1 * rng.standard_normal((R, lay.width))).astype(np.float32)
    table0[:, lay.SHOW] = rng.integers(0, 30, R)
    table0[:, lay.CLK] = np.floor(table0[:, lay.SHOW] * rng.random(R))
    table0[:, lay.embed_g2_col :] = 0.0
    table0[R - 1] = 0.0
    batches = []
    for _ in range(SMALL_STEPS):
        lens = rng.integers(1, 3, S * B)
        seg = np.repeat(np.arange(S * B, dtype=np.int32), lens)
        n_u, L = 200, len(seg)
        batches.append({
            "uniq_rows": np.concatenate([rng.permutation(R - 1)[:n_u], np.full(8, R - 1)]).astype(np.int32),
            "inverse": np.concatenate([rng.integers(0, n_u, L), np.full(8, n_u + 7)]).astype(np.int32),
            "segments": np.concatenate([seg, np.full(8, S * B)]).astype(np.int32),
            "labels": (rng.random(B) < 0.3).astype(np.float32),
        })
    cfg = TrainStepConfig(
        num_slots=S, batch_size=B, layout=lay,
        sparse_opt=SparseOptimizerConfig(embedx_threshold=5.0), auc_buckets=1000,
    )
    out = {}
    for name in ("cuda", "cpu"):
        dev = torch.device(name)
        model = DeepFM(S, lay.pull_width, D, hidden=(32, 16), generator=torch.Generator().manual_seed(seed)).to(dev)
        step = make_train_step(lambda p, x, d, m=model: functional_call(m, p, (x, d)), cfg, Adam(lr))
        params = {k: v.detach().clone() for k, v in model.state_dict().items()}
        feeds = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in batches]
        st, losses = run_steps(step, table0, params, Adam(lr).init(params), feeds, dev)
        out[name] = (st, torch.stack(losses).cpu())
    (g, gl), (c, cl) = out["cuda"], out["cpu"]
    gt, ct = g.table.cpu(), c.table
    tab_err = float((gt - ct).abs().max())
    tab_ok = bool(torch.allclose(gt, ct, rtol=SMALL_TABLE_RTOL, atol=SMALL_TABLE_ATOL))
    par_err = max(float((g.params[k].cpu() - c.params[k]).abs().max()) for k in c.params)
    par_atol = SMALL_PARAMS_ATOL
    loss_err = float(((gl - cl).abs() / cl.abs()).max())
    print(
        f"training card vs CPU ({SMALL_STEPS} steps, S={S} B={B} D={D}): table max |diff| {tab_err:.3e} "
        f"(rtol {SMALL_TABLE_RTOL}, atol {SMALL_TABLE_ATOL}), params max |diff| {par_err:.3e} "
        f"(atol {par_atol}), loss max rel diff {loss_err:.3e} (rtol {SMALL_LOSS_RTOL})",
        flush=True,
    )
    if not (tab_ok and par_err <= par_atol and loss_err <= SMALL_LOSS_RTOL):
        raise AssertionError("training on the card and on the CPU path disagree")


def dir_bytes(root) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", choices=("all", "merge"), default="all",
                    help="merge: phases 1-3 and 22 only (the kernels' build and checks, the push merge)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from paddlebox_tpu_torch.data import SlotInfo, SlotSchema
    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.ops import cuda_kernels as ck
    from paddlebox_tpu_torch.ops import pull_push
    from paddlebox_tpu_torch import config
    from paddlebox_tpu_torch.serve import Scorer
    from paddlebox_tpu_torch.table import ValueLayout
    from paddlebox_tpu_torch.train import TrainStepConfig

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = smi_line()
    print(f"card: {card}", flush=True)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
        flush=True,
    )

    # ---- 2. build --------------------------------------------------------
    # the native host library (g++) builds beside the kernels (one nvcc a
    # source); any failed build raises here
    from paddlebox_tpu_torch.utils import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as ex:
        host_build = ex.submit(native.build)
        reports = ck.build_all()
        lib_path, host_s = host_build.result()
    native.load()
    print(f"build: {time.perf_counter() - t0:.3f} s; native host library {os.path.relpath(lib_path, REPO)} "
          f"built by g++ in {host_s:.3f} s", flush=True)
    for source, report in reports.items():
        print(f"{source}:\n{report}", flush=True)
    if config.get_flag("resident_scan_batches") != RESIDENT_K:
        raise AssertionError("resident_scan_batches is not bench.py's default")

    # ---- 3. kernel check -------------------------------------------------
    g = torch.Generator(device=dev).manual_seed(args.seed)
    max_err = 0.0
    for R, W, U in ((160_000, 21, 160_000), (65_536, 128, 16_384), (100, 1, 0), (100, 1, 7)):
        table = torch.randn((R, W), device=dev, generator=g)
        rows = torch.randint(0, R - 1, (U,), device=dev, generator=g, dtype=torch.int32)
        rows[U - U // 64 :] = R - 1  # the padding row, repeated at the tail
        for r in (rows, rows.long()):
            max_err = max(max_err, check_gather(ck, table, r, f"R={R} W={W} U={U} {r.dtype}"))
    write_err = check_write_kernel(ck, dev, g)
    check_gather_out_of_range(ck, dev, g)
    edge_err = check_tile_edges(ck, dev, g)
    check_big_table(ck, dev, g)
    max_err, write_err = max(max_err, edge_err), max(write_err, edge_err)
    if args.phase == "merge":
        merge_phase(args, dev, card, ck)
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    # ---- 6-8. the training day, then its publish, follow and resume; the
    # serving path (phases 4 and 5) runs on phase 8's follower at the
    # published base, as a serving replica gets its table
    lay = ValueLayout(embedx_dim=EMBEDX_DIM)
    schema = SlotSchema(
        [SlotInfo("label", type="float", dense=True, dim=1)]
        + [SlotInfo(f"s{i}") for i in range(NUM_SLOTS)],
        label_slot="label",
    )
    cfg = TrainStepConfig(num_slots=NUM_SLOTS, batch_size=BATCH, layout=lay)
    scorer = Scorer(
        DeepFM(NUM_SLOTS, lay.pull_width, lay.embedx_dim, hidden=HIDDEN,
               generator=torch.Generator().manual_seed(args.seed)),
        cfg, device="cuda",
    )
    walls = {"build_and_kernel_checks": time.perf_counter() - t_start}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = time.perf_counter() - t0
        return out

    train = timed("6-7 train", train_phase, args, dev, card, ck, pull_push, lay, schema)
    serve_counts, serve_err, published, tier_shape = timed(
        "8 publish (with 4-5 serve and the tier)", publish_phase, args, card, ck, pull_push, lay, schema, scorer, train)
    max_err = max(max_err, serve_err)
    boundary_counts = timed("9 boundary", boundary_phase, args, card, ck, lay, schema, train)
    join_counts, join_err = timed("10 join_update", join_update_phase, args, dev, card, ck, pull_push, lay)
    zoo_counts, dcn, zoo_err = timed("11 zoo", zoo_phase, args, dev, card, ck, lay)
    mesh_counts, owner, join_owner, mesh_err, mesh18, mesh19, mesh20 = timed("12-13 mesh", mesh_phases, args, dev,
                                                                             card, ck, lay)
    supervised_counts, sup_err = timed("14 supervised_day", supervised_phase, args, dev, card, ck, lay, schema)
    multihost_counts, mh_owner, mh_err = timed("15 multihost", multihost_phase, args, dev, card, ck, lay)
    sh_counts, sh_owner, sh_err = timed("16 supervised_hosts", supervised_hosts_phase, args, dev, card, ck, lay)
    fleet_counts, fleet_shape, fleet_err = timed("17 serve_fleet", serve_fleet_phase, args, dev, card, ck, lay,
                                                 schema)
    lt_counts, lt_shapes, lt_err = timed("18 long_tail", long_tail_phase, args, dev, card, ck, pull_push, mesh18)
    _, seqpar_worlds = timed("19 pipeline", pipeline_phase, args, dev, card, mesh19, mesh20)
    seqpar_counts = timed("20 seqpar", seqpar_phase, card, seqpar_worlds, mesh20[1])
    cc_counts, cc_err = timed("21 compile_cache", compile_cache_phase, args, card)
    merge_nums, merge_counts = timed("22 merge", merge_phase, args, dev, card, ck)
    emit({"card": card, "phase_wall_s": walls, "script_s": time.perf_counter() - t_start})

    by_path = {"serve": serve_counts, **train["counts"], **published, "boundary": boundary_counts, **join_counts,
               **zoo_counts, **mesh_counts, **supervised_counts, **multihost_counts, **sh_counts, **fleet_counts,
               **lt_counts, **seqpar_counts, **cc_counts, "merge": merge_counts}
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            # every main path, each counted from 0: serving, training on the
            # resident, the packer and the slow feed, then phase 8's serving
            # through the Follower and its passes on the live and the
            # resumed stacks, then phase 9's pass boundary, then phase 10's
            # join and update phases, then phase 11's zoo, async dense,
            # dump and façade runs, then phase 12's NCCL and gloo mesh
            # worlds (every rank's main path), then phase 13's mesh join
            # and update, boundary, async and dump runs, then phase 14's
            # supervised day, AUC runner and stream, then phase 15's host
            # processes (every host's passes: the resident pass of two
            # hosts and of four, packer, ZeRO-1, shuffle, carried, join and
            # update), then phase 16's supervised two-host days (clean,
            # faulted with its reverted attempt, poisoned) and phase 17's
            # fleet (its producer's passes and the followers' served
            # batches at the base and at delta 1), then phase 18's extended
            # trainer (its four feeds), the replica cache's pull_cache_value,
            # the strategy's recompute and gradient_merge runs and the
            # extended mesh in phase 12's worlds, then phase 20's sequence
            # parallelism in its three worlds (every rank's ring and
            # Ulysses runs, none launching a kernel), then phase 21's four
            # fresh processes (a supervised pass each, cold and warm, under
            # "auto" and an explicit cache); serve_tier is phase 8's tiered
            # serving
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": err,
            "ms": train[key]["ms"],
            "plain_ms": train[key]["plain_ms"],
            "bound_ms": train[key]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": train[key]["library_ms"],
            "bound_share": train[key]["bound_ms"] / train[key]["ms"],
            "sector_floor_ms": train[key]["sector_floor_ms"],
            # the gather at DCN's batch shape (phase 11), beside phase 7's
            **({"zoo_dcn_shape": {k: dcn[k] for k in ("U", "n_uniq", "ms", "plain_ms", "library_ms", "bound_ms",
                                                        "sector_floor_ms")}} if key == "gather" else {}),
            # both kernels at the mesh owner's shape (phase 12): world x K
            # received ids into the owner's shard; and at the mesh join
            # owner's (phase 13)
            "mesh_owner_shape": {w: owner[w][name] for w in owner},
            "mesh_join_owner_shape": {w: join_owner[w][name] for w in join_owner},
            # and at the multi-host owner's (phase 15): a host's shard,
            # hosts x K ids received over the mesh
            "multihost_owner_shape": {w: mh_owner[w][name] for w in mh_owner},
            # and at the supervised two-host day's owner (phase 16)
            "supervised_hosts_owner_shape": {w: sh_owner[w][name] for w in sh_owner},
            # the gather at a fleet follower's shape (phase 17): a full
            # served batch's working set
            **({"serve_fleet_shape": fleet_shape} if key == "gather" else {}),
            # the gather at the device scoring tier's shape (phase 8): one
            # shard's bucket of a full request
            **({"serve_tier_shape": tier_shape} if key == "gather" else {}),
            # both kernels at the extended training shape (phase 18, W with
            # the expand block), and the gather at pull_cache_value's
            "expand_train_shape": lt_shapes["expand_train"][name],
            **({"replica_cache_shape": lt_shapes["replica_cache"]} if key == "gather" else {}),
        }
        for name, source, replaces, key, err in (
            ("pull_rows_cuda", "paddlebox_tpu_torch/ops/csrc/gather_rows.cu", GATHER_REPLACES, "gather",
             max(max_err, train["gather_err"], join_err, zoo_err, mesh_err, sup_err, mh_err, sh_err, fleet_err, lt_err,
                 cc_err)),
            ("write_rows_cuda", "paddlebox_tpu_torch/ops/csrc/write_rows.cu", WRITE_REPLACES, "write",
             max(write_err, train["write_err"], join_err, zoo_err, mesh_err, sup_err, mh_err, sh_err, lt_err, cc_err)),
        )
    ]
    # the push merge replaces no TPU kernel; every path above checks its
    # count, phase 22 its bits and times at the three cells' step shapes
    kernels.append({
        "name": "merge_rows_cuda",
        "route": "cuda",
        "source": "paddlebox_tpu_torch/ops/csrc/merge_rows.cu",
        "replaces": MERGE_REPLACES,
        "launches": sum(c["merge_rows_cuda"] for c in by_path.values()),
        "launches_by_path": {p: c["merge_rows_cuda"] for p, c in by_path.items()},
        "max_abs_err": 0.0,
        "bound_by": "bytes",
        "cells": merge_nums,
    })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


@contextlib.contextmanager
def flags(**kw):
    """Port flags set for the block, restored after."""
    from paddlebox_tpu_torch import config

    before = {k: config.get_flag(k) for k in kw}
    for k, v in kw.items():
        config.set_flag(k, v)
    try:
        yield
    finally:
        for k, v in before.items():
            config.set_flag(k, v)


def records_view(ds, n_batches):
    """The dataset as the slow feed sees it: a shallow copy whose pass is
    the SlotRecord views of its first ``n_batches`` batches, in order (the
    same working set and pass table)."""
    view = copy.copy(ds)
    idx = np.concatenate(list(ds.batch_indices(n_batches)))
    view.records = [ds.store.record(int(i)) for i in idx]
    return view


def new_trainer(args, cfg, lay):
    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.train import Adam, CTRTrainer

    model = DeepFM(
        NUM_SLOTS, lay.pull_width, lay.embedx_dim, hidden=HIDDEN,
        generator=torch.Generator().manual_seed(args.seed),
    )
    tr = CTRTrainer(model, cfg, dense_opt=Adam(1e-3), device="cuda")
    tr.init_params()
    return tr


def timed_pass(trainer, ds, n_batches, ck):
    """One train_pass from launch counts of 0: (out, losses, wall s, counts)."""
    losses = []
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    out = trainer.train_pass(ds, n_batches=n_batches, on_batch=lambda i, m: losses.append(m["loss"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, torch.stack(losses).cpu(), wall, dict(ck.launch_counts)


def check_path(name, out, losses, counts, n_steps):
    if out["batches"] != n_steps or len(losses) != n_steps:
        raise AssertionError(f"{name}: {out['batches']} steps, want {n_steps}")
    if counts["pull_rows_cuda"] != 2 * n_steps or counts["write_rows_cuda"] != n_steps:
        raise AssertionError(f"{name}: launches {counts} for {n_steps} steps: want 2 gathers and 1 writeback a step")
    if not bool(torch.isfinite(losses).all()) or not np.isfinite(out["loss"]):
        raise AssertionError(f"{name}: non-finite training loss: {losses.tolist()}")
    print(f"{name}: {n_steps} steps, launches {counts} (2 gathers and 1 writeback a step), losses finite, "
          f"first {float(losses[0]):.5f} last {float(losses[-1]):.5f}, auc {out['auc']:.5f}", flush=True)


def four_feeds_bitwise(make_trainer, feeds, n_steps, what):
    """``n_steps`` steps from one state through each of ``feeds`` (name ->
    (flags, dataset, the ``last_feed`` the trainer must take)), each on a
    fresh trainer from ``make_trainer``: tables, params, Adam moments and
    losses must be bitwise equal."""
    got = {}
    for name, (kw, dataset, want_feed) in feeds.items():
        with flags(**kw):
            tr = make_trainer()
            losses = []
            tr.train_pass(dataset, n_batches=n_steps, on_batch=lambda i, m: losses.append(m["loss"]))
            if tr.last_feed != want_feed:
                raise AssertionError(f"{what}: the {name} run took the {tr.last_feed} feed, not {want_feed}")
            got[name] = (
                tr.trained_table(), {k: v.cpu() for k, v in tr.params.items()},
                {k: v.cpu() for k, v in tr.opt_state.mu.items()}, {k: v.cpu() for k, v in tr.opt_state.nu.items()},
                torch.stack(losses).cpu(),
            )
    ref_name, ref = next(iter(got.items()))
    for name, g in got.items():
        same = (
            g[0].tobytes() == ref[0].tobytes()
            and all(torch.equal(g[i][k], ref[i][k]) for i in (1, 2, 3) for k in ref[1])
            and g[4].numpy().tobytes() == ref[4].numpy().tobytes()
        )
        if not same:
            raise AssertionError(f"{what}: {n_steps} steps through the {name} feed differ from the {ref_name} feed")
    print(f"{what}: {n_steps} steps from one state through {', '.join(got)} give bitwise-equal "
          "tables, params, Adam moments and losses", flush=True)


def busy_ms_per_step(fn, n_steps) -> float:
    """Device ms a step of ``fn`` (``n_steps`` steps) under the profiler:
    every kernel, copy and fill the card ran, summed."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / n_steps


def host_syncs(fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``: (the
    host syncs it made, their sites). A sync is named by the innermost
    frame of this repo that led to it, then the frame the warning came
    from."""
    sites: dict = {}
    inside = [False]  # counting only while fn runs, not the mode switches

    def on_warning(message, category, filename, lineno, file=None, line=None):
        if not inside[0] or "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(REPO)]
        where = f"{os.path.relpath(ours[-1].filename, REPO)}:{ours[-1].lineno}" if ours else "?"
        site = f"{where} via {os.path.basename(filename)}:{lineno}"
        sites[site] = sites.get(site, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        inside[0] = True
        try:
            fn()
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum(sites.values()), sites


def superstep_probe(args, cfg, lay, ds, table0, params0, opt0, dev):
    """One resident superstep of RESIDENT_K steps outside the trainer, at
    the pads of the timed partition: run once warm, once under
    ``torch.cuda.set_sync_debug_mode("warn")`` counting the host syncs it
    makes (and where), once under the profiler for the card's busy time.
    Returns (the ResidentPass, its first batch's record indices on the
    card, sync count, sync sites, busy ms a step, device ops a step, the
    largest device ms a step by kernel)."""
    from torch.func import functional_call

    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.train import Adam, ResidentPass, make_resident_superstep

    rp = ResidentPass(ds.store, ds.ws, ds.schema, dev)
    blocks = [np.asarray(b, dtype=np.int32) for b in ds.batch_indices(TRAIN_BATCHES)]
    rp.ensure(blocks)
    idx = torch.from_numpy(np.stack(blocks[:RESIDENT_K])).to(dev)
    model = DeepFM(NUM_SLOTS, lay.pull_width, lay.embedx_dim, hidden=HIDDEN,
                   generator=torch.Generator().manual_seed(args.seed)).to(dev)
    sstep = make_resident_superstep(lambda p, x, d: functional_call(model, p, (x, d)), Adam(1e-3), cfg, rp)
    run_steps(sstep, table0, params0, opt0, [idx], dev)  # warm
    st0 = fresh_state(table0, params0, opt0, dev)  # the state's upload is not the superstep's
    torch.cuda.synchronize()
    n_syncs, sites = host_syncs(lambda: sstep(st0, idx))
    st0 = fresh_state(table0, params0, opt0, dev)  # set-up outside the trace
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        sstep(st0, idx)
        torch.cuda.synchronize()
    by_kernel: dict = {}
    n_ops = 0
    for e in prof.key_averages():
        name = e.key[:60]
        by_kernel[name] = by_kernel.get(name, 0.0) + e.self_device_time_total / 1e3 / RESIDENT_K
        n_ops += e.count
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    return rp, idx[0], n_syncs, sites, sum(by_kernel.values()), n_ops / RESIDENT_K, top


def python_tier_dataset(args, lay, sparse_opt, schema, files):
    """The Python tier over the same files: the pure-Python host store,
    ``parse_line``, the SlotRecord pass. Returns (dataset, table, load s,
    begin_pass s)."""
    from paddlebox_tpu_torch.data import BoxPSDataset
    from paddlebox_tpu_torch.table import HostSparseTable

    before = os.environ.get("PBOX_NATIVE_TABLE")
    os.environ["PBOX_NATIVE_TABLE"] = "0"
    try:
        table = HostSparseTable(lay, sparse_opt, n_shards=64, seed=args.seed)
    finally:
        if before is None:
            del os.environ["PBOX_NATIVE_TABLE"]
        else:
            os.environ["PBOX_NATIVE_TABLE"] = before
    if table.native:
        raise AssertionError("the Python-tier table is native")
    ds = BoxPSDataset(schema, table, batch_size=BATCH, shuffle_mode="local", seed=args.seed)
    ds.set_filelist(files)
    with flags(enable_native_parser=False):
        t0 = time.perf_counter()
        ds.load_into_memory()
        t1 = time.perf_counter()
    if ds.store is not None:
        raise AssertionError("the Python-tier dataset holds a columnar store")
    ds.begin_pass(round_to=512)
    return ds, table, t1 - t0, time.perf_counter() - t1


def train_phase(args, dev, card, ck, pull_push, lay, schema):
    """Phases 6 and 7: the training main path at full width on its three
    feeds, their checks and their numbers. Returns the launch counts by
    path and the kernel numbers for the ``kernels`` line."""
    from torch.func import functional_call

    from paddlebox_tpu_torch.data import BoxPSDataset, pack_batch
    from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig
    from paddlebox_tpu_torch.train import TrainStepConfig, build_device_batch, make_train_step

    rng = np.random.default_rng(args.seed + 1)
    sparse_opt = SparseOptimizerConfig(embedx_threshold=0.0)
    cfg = TrainStepConfig(
        num_slots=NUM_SLOTS, batch_size=BATCH, layout=lay, sparse_opt=sparse_opt, auc_buckets=100_000,
    )
    bounds = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmpdir:
        t0 = time.perf_counter()
        files, _ = write_bench_files(tmpdir, rng)
        write_s = time.perf_counter() - t0
        # bench.py's tier: the native store, the native parser
        table = HostSparseTable(lay, sparse_opt, n_shards=64, seed=args.seed)
        if not table.native:
            raise AssertionError("HostSparseTable is not on the native store")
        ds = BoxPSDataset(schema, table, batch_size=BATCH, shuffle_mode="local", seed=args.seed)
        ds.set_filelist(files)
        t0 = time.perf_counter()
        ds.load_into_memory()
        bounds["load_into_memory_s"] = time.perf_counter() - t0
        if ds.store is None:
            raise AssertionError("the native parser did not load the pass into a columnar store")
        t0 = time.perf_counter()
        dev_table = ds.begin_pass(round_to=512)
        bounds["begin_pass_s"] = time.perf_counter() - t0
        slow_ds, slow_table, py_load_s, py_begin_s = python_tier_dataset(args, lay, sparse_opt, schema, files)
    n_keys = ds.ws.n_keys
    print(
        f"training data: {N_FILES} files x {RECORDS_PER_FILE} records written in {write_s:.3f} s; native tier: "
        f"load_into_memory {bounds['load_into_memory_s']:.3f} s, begin_pass over {n_keys} unique keys "
        f"(table {dev_table.shape}) {bounds['begin_pass_s']:.3f} s; Python tier: load {py_load_s:.3f} s, "
        f"begin_pass {py_begin_s:.3f} s",
        flush=True,
    )
    if slow_ds.ws.n_keys != n_keys:
        raise AssertionError("the two tiers loaded different key sets")
    trainer = new_trainer(args, cfg, lay)
    table0 = dev_table.reshape(-1, lay.width).copy()
    params0 = {k: v.clone() for k, v in trainer.params.items()}
    opt0 = trainer.dense_opt.init(params0)
    counts, paths, busy = {}, {}, {}

    # ---- 6. bench.py's path: prepare_pass, warm-up, the timed resident pass
    trainer.prepare_pass(ds, n_batches=TRAIN_BATCHES)
    bounds["prepare_pass_s"] = trainer.last_prepare_s
    t0 = time.perf_counter()
    trainer.train_pass(ds, n_batches=WARM_BATCHES)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    out, losses, wall, counts["train_resident"] = timed_pass(trainer, ds, TRAIN_BATCHES, ck)
    check_path(f"resident feed (K = {RESIDENT_K}), after prepare_pass and a {WARM_BATCHES}-step warm-up "
               f"of {warm_s:.3f} s", out, losses, counts["train_resident"], TRAIN_BATCHES)
    prof = trainer.train_pass(ds, n_batches=PROFILE_BATCHES, profile=True)["profile"]
    paths["resident"] = (wall, TRAIN_BATCHES, prof)
    busy["resident"] = busy_ms_per_step(lambda: trainer.train_pass(ds, n_batches=RESIDENT_K), RESIDENT_K)

    # the packer feed over the same pass, from the pass-open table
    with flags(enable_resident_feed=0):
        ptrainer = new_trainer(args, cfg, lay)
        ptrainer.prepare_pass(ds, n_batches=TRAIN_BATCHES)
        ptrainer.train_pass(ds, n_batches=WARM_BATCHES)
        pout, plosses, pwall, counts["train_packer"] = timed_pass(ptrainer, ds, TRAIN_BATCHES, ck)
        check_path("packer feed", pout, plosses, counts["train_packer"], TRAIN_BATCHES)
        paths["packer"] = (pwall, TRAIN_BATCHES, ptrainer.train_pass(ds, n_batches=PROFILE_BATCHES,
                                                                     profile=True)["profile"])
        busy["packer"] = busy_ms_per_step(lambda: ptrainer.train_pass(ds, n_batches=RESIDENT_K), RESIDENT_K)
        del ptrainer

    # the Python tier on the slow feed, one batch a step waited for
    strainer = new_trainer(args, cfg, lay)
    stamps, slosses = [], []

    def on_slow(i, m):
        slosses.append(m["loss"])
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    ck.reset_launch_counts()
    sout = strainer.train_pass(slow_ds, n_batches=SLOW_BATCHES, on_batch=on_slow, profile=True)
    counts["train_slow"] = dict(ck.launch_counts)
    check_path("slow feed (Python tier)", sout, torch.stack(slosses).cpu(), counts["train_slow"], SLOW_BATCHES)
    timed = np.diff(stamps)  # steps after the first
    paths["slow"] = (float(np.sum(timed)), len(timed), sout["profile"])
    busy["slow"] = busy_ms_per_step(
        lambda: strainer.train_pass(slow_ds, n_batches=SLOW_BUSY_STEPS), SLOW_BUSY_STEPS
    )
    t0 = time.perf_counter()
    sended = slow_ds.end_pass(strainer.trained_table())
    py_end_s = time.perf_counter() - t0
    if len(slow_table) != n_keys - sended["dropped"]:
        raise AssertionError("the Python-tier host table after end_pass lost keys")
    print(f"slow feed end_pass (Python store) in {py_end_s:.3f} s: {len(slow_table)} keys kept", flush=True)
    del strainer, slow_ds, slow_table

    # ---- the same steps from one state: four feeds, twin, plain writeback, no dedup
    view = records_view(ds, max(FEED_STEPS, TWIN_STEPS))
    four_feeds_bitwise(lambda: new_trainer(args, cfg, lay), {
        f"resident K={FEED_STEPS}": (dict(enable_resident_feed=1, resident_scan_batches=FEED_STEPS), ds, "resident"),
        "resident K=1": (dict(enable_resident_feed=1, resident_scan_batches=1), ds, "resident"),
        "packer": (dict(enable_resident_feed=0), ds, "packer"),
        "slow": (dict(enable_resident_feed=0), view, "slow"),
    }, FEED_STEPS, "four feeds")
    dbs = [pack_batch(b, ds.ws, schema) for b in view.batches(TWIN_STEPS)]
    feeds = [{k: torch.from_numpy(v).to(dev) for k, v in db.as_dict().items()} for db in dbs]
    step = make_train_step(
        lambda p, x, d: functional_call(trainer.model, p, (x, d)), cfg, trainer.dense_opt
    )
    a, la = run_steps(step, table0, params0, opt0, feeds, dev)
    b, lb = run_steps(step, table0, params0, opt0, feeds, dev)
    torch.cuda.synchronize()
    if not same_state(a, b) or not torch.equal(torch.stack(la), torch.stack(lb)):
        raise AssertionError("two runs of the same training steps differ")
    print(f"training twin: {TWIN_STEPS} steps twice from one state give bitwise-equal "
          "tables, params and Adam moments", flush=True)
    pull_push.write_rows_cuda = ck.write_rows_ref
    try:
        c, _ = run_steps(step, table0, params0, opt0, feeds, dev)
    finally:
        pull_push.write_rows_cuda = ck.write_rows_cuda
    torch.cuda.synchronize()
    if not torch.equal(c.table, a.table):
        raise AssertionError("the table with write_rows_ref differs from the table with write_rows_cuda")
    print("training: bitwise-equal table with the writeback forced to write_rows_ref", flush=True)
    first = next(iter(view.batches(1)))
    flat_rows = torch.from_numpy(ds.ws.lookup(first.keys)).to(dev)  # duplicates kept
    g = torch.Generator(device=dev).manual_seed(args.seed)
    grads = torch.randn((len(flat_rows), lay.pull_width), device=dev, generator=g)
    ones = torch.ones(len(flat_rows), device=dev)
    with flags(enable_pullpush_dedup_keys=False):
        t_nd = [
            pull_push.push_sparse_rows(
                torch.from_numpy(table0).to(dev, copy=True), flat_rows, grads, ones, ones * 0.2,
                lay, sparse_opt,
            )
            for _ in range(2)
        ]
    torch.cuda.synchronize()
    if not torch.equal(t_nd[0], t_nd[1]):
        raise AssertionError("the push without dedup is not bitwise repeatable")
    print(f"training: push without dedup ({len(flat_rows)} rows with duplicates) bitwise repeatable", flush=True)
    small_card_vs_cpu(args.seed)
    rp, first_idx, n_syncs, sync_sites, busy_ms, ops_per_step, top = superstep_probe(
        args, cfg, lay, ds, table0, params0, opt0, dev
    )
    print(f"resident superstep of {RESIDENT_K} steps under set_sync_debug_mode('warn'): {n_syncs} host syncs "
          f"({n_syncs / RESIDENT_K:g} a step) at {sync_sites}", flush=True)

    # end_pass of bench.py's path: writeback into the native store, decay and shrink
    trained = trainer.trained_table()
    pass_keys, row_of = ds.ws.sorted_keys.copy(), ds.ws.row_of_sorted.copy()
    t0 = time.perf_counter()
    ended = ds.end_pass(trained)
    bounds["end_pass_s"] = time.perf_counter() - t0
    kept = np.sort(table.keys())
    if len(kept) != n_keys - ended["dropped"] or not np.all(np.isin(kept, pass_keys)):
        raise AssertionError(
            f"host table holds {len(kept)} keys; want the pass's {n_keys} less {ended['dropped']} dropped"
        )
    want = trained[row_of[np.searchsorted(pass_keys, kept)]]
    want[:, lay.SHOW] *= sparse_opt.show_clk_decay
    want[:, lay.CLK] *= sparse_opt.show_clk_decay
    if not np.array_equal(table.pull_or_create(kept), want) or len(table) != len(kept):
        raise AssertionError("host rows after end_pass are not the trained rows, decayed")
    print(f"end_pass in {bounds['end_pass_s']:.3f} s: the native host table holds {len(kept)} keys = {n_keys} "
          f"pass keys - {ended['dropped']} dropped, each its trained row decayed", flush=True)

    # ---- 7. numbers -----------------------------------------------------------
    emit({
        "card": card, "superstep_busy_ms_per_step": busy_ms, "steps": RESIDENT_K, "path": "train_resident",
        "device_ops_per_step": ops_per_step, "top_device_ms_per_step": top,
        "host_syncs_per_superstep": n_syncs, "host_sync_sites": sync_sites,
    })
    emit({"card": card, "pass_boundary_s": bounds, "python_tier_s": {
        "load_into_memory_s": py_load_s, "begin_pass_s": py_begin_s, "end_pass_s": py_end_s,
    }})
    for name, (secs, n, prof) in paths.items():
        step_ms = secs / n * 1e3
        n_prof = SLOW_BATCHES if name == "slow" else PROFILE_BATCHES
        # no clamp: a busy time longer than the step would show as negative
        emit({
            "card": card, "path": f"train_{name}", "train_samples_per_s": BATCH * n / secs, "steps_timed": n,
            "batch": BATCH, "ms_per_step": step_ms, "device_busy_ms_per_step": busy[name],
            "device_idle_share": 1.0 - busy[name] / step_ms,
            "host_clock_ms_per_step_profiled": {k: v / n_prof * 1e3 for k, v in prof.items()},
            "profiled_steps": n_prof,
        })
    # the kernels at the resident path's own batch shape
    tab = torch.from_numpy(table0).to(dev)
    rows = build_device_batch(rp, cfg, first_idx)["uniq_rows"]
    new_rows = ck.pull_rows_ref(tab, rows) + 0.5  # padding-row repeats stay identical
    R, W = tab.shape
    U = rows.shape[0]
    write_err = check_write(ck, tab, rows, new_rows, f"training path R={R} W={W} U={U} int32")
    gather_err = check_gather(ck, tab, rows, f"training path R={R} W={W} U={U} int32")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    rows64 = rows.long()
    pristine = tab.clone()
    bound_ms = (2 * U * W * 4 + 4 * U) / HBM_BYTES_PER_S * 1e3
    write_fns = {
        "kernel": lambda: ck.write_rows_cuda(tab, rows, new_rows),
        "plain": lambda: ck.write_rows_ref(tab, rows, new_rows),
        "library": lambda: tab.index_copy_(0, rows64, new_rows),
    }
    gather_fns = {
        "kernel": lambda: ck.pull_rows_cuda(tab, rows),
        "plain": lambda: ck.pull_rows_ref(tab, rows),
        "library": lambda: torch.index_select(tab, 0, rows),
    }
    n_uniq = int((rows != rp.pad_row).sum())
    res = {}
    for name, fns, restore in (
        ("write_rows_cuda", write_fns, lambda: tab.copy_(pristine)),
        ("pull_rows_cuda", gather_fns, None),
    ):
        med, med_warm = time_fns(fns, flush, restore)
        floor_ms = sector_floor_ms(rows, R, W, name == "write_rows_cuda")
        res[name] = {
            "ms": med["kernel"], "plain_ms": med["plain"], "library_ms": med["library"],
            "bound_ms": bound_ms, "sector_floor_ms": floor_ms,
        }
        emit({
            "card": card, "kernel": name, "path": "train_resident",
            "R": R, "W": W, "U": U, "n_uniq": n_uniq,
            "ms": med["kernel"], "plain_ms": med["plain"],
            ("index_copy_ms" if name == "write_rows_cuda" else "index_select_ms"): med["library"],
            "bound_ms": bound_ms, "bytes": 2 * U * W * 4 + 4 * U, "bound_share": bound_ms / med["kernel"],
            "sector_floor_ms": floor_ms, "reps": TIMING_REPS, "l2": "cold",
            "warm_l2_ms": med_warm["kernel"], "warm_l2_plain_ms": med_warm["plain"],
            "warm_l2_library_ms": med_warm["library"],
        })
    return {
        "counts": counts, "write": res["write_rows_cuda"], "gather": res["pull_rows_cuda"],
        "write_err": write_err, "gather_err": gather_err,
        "table": table, "trainer": trainer, "cfg": cfg, "sparse_opt": sparse_opt,
        "resident_samples_per_s": BATCH * TRAIN_BATCHES / paths["resident"][0],
    }


class PeekSource:
    """Direct scoring rows from a host table: the stored row of a key the
    table holds, the zero row of one it does not (what a served version
    gives it), and nothing created."""

    def __init__(self, table):
        self.table = table
        self.keys = np.sort(table.keys())

    def pull_or_create(self, keys):
        out = np.zeros((len(keys), self.table.layout.width), np.float32)
        pos = np.minimum(np.searchsorted(self.keys, keys), len(self.keys) - 1)
        hit = self.keys[pos] == keys
        if hit.any():
            out[hit] = self.table.pull_or_create(keys[hit])
        return out


def same_dense(a, b) -> bool:
    """Params and Adam state of two trainers, bitwise."""
    return (
        all(torch.equal(a.params[k], b.params[k]) for k in a.params)
        and torch.equal(a.opt_state.count, b.opt_state.count)
        and all(torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]) for k in a.params)
        and all(torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]) for k in a.params)
    )


def same_tables(a, b) -> bool:
    """Two host tables hold the same keys and bitwise-equal rows (reading a
    spilled row promotes it)."""
    ka, kb = np.sort(a.keys()), np.sort(b.keys())
    return np.array_equal(ka, kb) and np.array_equal(a.pull_or_create(ka), b.pull_or_create(kb))


def check_followed(fol, table, trainer, delta_idx, what):
    """The follower's version is the trainer's table and dense state."""
    v = fol.version()
    keys = np.sort(table.keys())
    if (v.date, v.delta_idx) != (PUB_DATE, delta_idx):
        raise AssertionError(f"{what}: the follower serves {v.date}/{v.delta_idx}")
    if not (np.array_equal(v.keys, keys) and np.array_equal(v.rows, table.pull_or_create(keys))):
        raise AssertionError(f"{what}: the followed keys or rows differ from the trainer's host table")
    if not all(torch.equal(v.params[k], trainer.params[k]) for k in trainer.params):
        raise AssertionError(f"{what}: the followed params differ from the trainer's")
    print(f"{what}: the followed version holds the trainer's {len(keys)} keys, rows and params bitwise",
          flush=True)


def serve_followed(fol, scorer, schema, table, trainer, rng, ck, what):
    """A few requests through a ScoreServer over the follower (full batches,
    small ones, some concurrent; keys from the trained table, 1% absent):
    preds bitwise equal to direct scoring against the trainer's table and
    params, one gather a served batch. Returns (launch counts, publish to
    first served seconds)."""
    from paddlebox_tpu_torch.serve import ScoreServer, table_source
    from paddlebox_tpu_torch.utils.monitor import STAT_GET

    keys = np.sort(table.keys())
    spread = keys[rng.permutation(len(keys))]
    reqs = [make_records(rng, spread, n) for n in (BATCH, BATCH // 4, BATCH // 40, 7)]
    conc = [make_records(rng, spread, BATCH // 8) for _ in range(4)]  # one coalesced batch
    srv = ScoreServer(fol, scorer, schema, device="cuda")
    batches0 = STAT_GET("serve.batches")
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    srv.start()
    try:
        served = [srv.score(r, timeout=300.0) for r in reqs]
        pend = [srv.submit(r) for r in conc]
        served += [p.result(timeout=300.0) for p in pend]
    finally:
        srv.stop()
    torch.cuda.synchronize()
    counts = dict(ck.launch_counts)
    n_batches = STAT_GET("serve.batches") - batches0
    if counts["pull_rows_cuda"] != n_batches or counts["write_rows_cuda"] != 0:
        raise AssertionError(f"{what}: launches {counts} for {n_batches} served batches: want one gather a batch")
    direct = table_source(fol.layout, PeekSource(table))
    for preds, recs in zip(served, reqs + conc):
        want = scorer.score_records(recs, schema, direct, trainer.params, trainer.opt_state)
        if preds.shape != (len(recs),) or not np.array_equal(preds, want):
            raise AssertionError(f"{what}: served preds differ from direct scoring against the trainer's table")
    (idx, lag), = srv.staleness
    print(f"{what}: {len(served)} requests in {n_batches} batches, launches {counts}; preds bitwise equal to "
          f"direct scoring against the trainer's table and params; publish to first served {lag:.3f} s",
          flush=True)
    return counts, lag


def day_pass(args, schema, table, trainer, files, ck, what, **end_kw):
    """One pass of ``files`` on a stack: begin, DAY_STEPS resident steps
    (2 gathers and 1 writeback each), end_pass. Returns (launch counts,
    the pass's sorted keys, end_pass's result)."""
    from paddlebox_tpu_torch.data import BoxPSDataset

    ds = BoxPSDataset(schema, table, batch_size=BATCH, shuffle_mode="local", seed=args.seed)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=512)
    keys = ds.ws.sorted_keys.copy()
    out, losses, _, counts = timed_pass(trainer, ds, DAY_STEPS, ck)
    check_path(what, out, losses, counts, DAY_STEPS)
    ended = ds.end_pass(trainer.trained_table(), **end_kw)
    if ended["dropped"]:
        raise AssertionError(f"{what}: end_pass dropped {ended['dropped']} keys; a delta records no drops")
    return counts, keys, ended


def serve_phase(args, card, ck, pull_push, fol, scorer, schema, keys):
    """Phases 4 and 5: the serving main path from ``fol``, a Follower at the
    published base, over requests drawn from ``keys`` (the trained keys):
    finite preds in [0, 1], reruns and coalesced requests bitwise equal to
    direct scoring, bitwise equal with the gather forced to
    ``pull_rows_ref``, a small request within PRED_ATOL of the port's CPU
    path; then the gather's numbers at the serving shape and the request
    latencies. Returns (launch counts, the gather's max abs error)."""
    from paddlebox_tpu_torch import config
    from paddlebox_tpu_torch.data import build_batch, pack_batch
    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.serve import ScoreServer, Scorer, version_source
    from paddlebox_tpu_torch.table import PassWorkingSet
    from paddlebox_tpu_torch.utils.monitor import STAT_GET

    dev = scorer.device
    lay = fol.layout
    version = fol.version()
    params = version.params
    source = version_source(lay, version)
    rng = np.random.default_rng(args.seed)
    keys_hot_first = keys[rng.permutation(len(keys))]  # the hot head spread over the trained keys

    full = make_records(rng, keys_hot_first, BATCH)
    small = [make_records(rng, keys_hot_first, n) for n in (1000, 100, 7)]
    mostly_absent = make_records(rng, keys_hot_first, 64, miss_frac=0.9)
    concurrent = [make_records(rng, keys_hot_first, 500) for _ in range(6)]

    t0 = time.perf_counter()
    scorer.score_records(full, schema, source, params)  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    print(f"warm-up batch: {time.perf_counter() - t0:.3f} s", flush=True)

    srv = ScoreServer(fol, scorer, schema, device="cuda")
    batches0 = STAT_GET("serve.batches")
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    srv.start()
    try:
        served = [srv.score(r, timeout=300.0) for r in [full, full, *small, mostly_absent]]
        pend = [srv.submit(r) for r in concurrent]
        served_conc = [p.result(timeout=300.0) for p in pend]
    finally:
        srv.stop()
    torch.cuda.synchronize()
    counts = dict(ck.launch_counts)
    n_batches = STAT_GET("serve.batches") - batches0
    lat = srv.latency_percentiles()
    print(f"served {lat['n']} requests in {n_batches} batches; kernel launches {counts}", flush=True)
    if counts["pull_rows_cuda"] == 0:
        raise AssertionError("kernel pull_rows_cuda was never launched on the serving path")
    if counts["write_rows_cuda"] != 0:
        raise AssertionError("the serving path wrote rows: scoring must not push")
    if counts["pull_rows_cuda"] != n_batches:
        raise AssertionError(f"{counts['pull_rows_cuda']} gather launches for {n_batches} batches")

    for preds, recs in zip(served + served_conc, [full, full, *small, mostly_absent, *concurrent]):
        if preds.shape != (len(recs),) or not np.all(np.isfinite(preds)):
            raise AssertionError("preds not finite or of the wrong shape")
        if preds.min() < 0.0 or preds.max() > 1.0:
            raise AssertionError("preds outside [0, 1]")
    if not np.array_equal(served[0], served[1]):
        raise AssertionError("two runs of the same request differ")
    for preds, recs in zip(served_conc, concurrent):
        if not np.array_equal(preds, scorer.score_records(recs, schema, source, params)):
            raise AssertionError("a coalesced request differs from scoring it alone")
    print("main path: preds finite in [0, 1]; reruns and coalesced requests bitwise equal", flush=True)

    # the same request with the gather forced to the plain version
    pull_push.pull_rows_cuda = ck.pull_rows_ref
    try:
        plain = scorer.score_records(full, schema, source, params)
    finally:
        pull_push.pull_rows_cuda = ck.pull_rows_cuda
    if not np.array_equal(plain, served[0]):
        raise AssertionError("preds with pull_rows_ref differ from preds with pull_rows_cuda")
    print("main path: bitwise equal with the gather forced to pull_rows_ref", flush=True)

    # reference on a small input: the port's CPU path on the same version
    cpu_scorer = Scorer(
        DeepFM(NUM_SLOTS, lay.pull_width, lay.embedx_dim, hidden=HIDDEN,
               generator=torch.Generator().manual_seed(args.seed)),
        scorer.cfg, device="cpu",
    )
    cpu_params = {k: v.cpu() for k, v in params.items()}
    cpu_preds = cpu_scorer.score_records(full[:64], schema, source, cpu_params)
    cpu_err = float(np.abs(cpu_preds - served[0][:64]).max())
    print(f"main path: CPU vs GPU preds max |diff| {cpu_err:.3e} (atol {PRED_ATOL})", flush=True)
    if not cpu_err <= PRED_ATOL:
        raise AssertionError(f"GPU preds differ from the CPU path by {cpu_err}")

    # ---- 5. numbers at the serving path's own gather shape ---------------
    # the full request's stages on the host clock, then the whole call
    t0 = time.perf_counter()
    batch = build_batch(full, schema)
    t1 = time.perf_counter()
    ws = PassWorkingSet(n_mesh_shards=1)
    ws.add_keys(batch.keys)
    table_np = ws.finalize(source, round_to=config.get_flag("serve_row_bucket"))
    t2 = time.perf_counter()
    db = pack_batch(batch, ws, schema, bucket=config.get_flag("serve_key_bucket"))
    t3 = time.perf_counter()
    table = torch.from_numpy(table_np.reshape(-1, lay.width)).to(dev)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    scorer.score_records(full, schema, source, params)
    t5 = time.perf_counter()
    emit({
        "card": card, "host_clock_ms": {
            "build_batch": (t1 - t0) * 1e3, "working_set_finalize": (t2 - t1) * 1e3,
            "pack_batch": (t3 - t2) * 1e3, "table_h2d": (t4 - t3) * 1e3,
            "score_records_total": (t5 - t4) * 1e3,
        },
    })
    uniq = torch.from_numpy(db.uniq_rows).to(dev)
    R, W = table.shape
    U = uniq.shape[0]
    max_err = check_gather(ck, table, uniq, f"main path R={R} W={W} U={U} int32")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    fns = {
        "kernel": lambda: ck.pull_rows_cuda(table, uniq),
        "plain": lambda: ck.pull_rows_ref(table, uniq),
        "library": lambda: torch.index_select(table, 0, uniq),
    }
    med, med_warm = time_fns(fns, flush)
    bytes_moved = 2 * U * W * 4 + 4 * U
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    emit({
        "card": card, "kernel": "pull_rows_cuda", "path": "serve", "R": R, "W": W, "U": U,
        "n_uniq": db.n_uniq, "ms": med["kernel"], "plain_ms": med["plain"],
        "index_select_ms": med["library"], "bound_ms": bound_ms, "bytes": bytes_moved,
        "bound_share": bound_ms / med["kernel"], "sector_floor_ms": sector_floor_ms(uniq, R, W, False),
        "reps": TIMING_REPS, "l2": "cold", "warm_l2_ms": med_warm["kernel"],
        "warm_l2_plain_ms": med_warm["plain"], "warm_l2_index_select_ms": med_warm["library"],
    })
    emit({
        "card": card, "launches_per_batch": counts["pull_rows_cuda"] / n_batches,
        "requests": lat["n"], "batches": n_batches, "request_p50_ms": lat["p50_ms"],
        "request_p99_ms": lat["p99_ms"], "request_max_ms": lat["max_ms"],
    })
    return counts, max_err


TIER_SHARDS = (("one shard", ("cuda:0",)), ("two shards", ("cuda:0", "cuda:0")))


def tier_phase(args, card, ck, root, lay, opt, cfg, scorer, schema, plain_fol, keys, hot):
    """The device scoring tier on phase 8's published base: Followers with
    ``device_scoring_tier`` on, on one shard and on two shards sharing
    cuda:0, beside ``plain_fol`` (the tier off). TIER_REQUESTS requests
    whose keys are drawn in proportion to ``hot`` (the base's decayed
    shows, aligned with ``keys``), each served by the three in turns (the
    first of them rotating): preds bitwise the tier-off preds, tier hits
    and misses counted apart from the key misses, one gather a served
    batch plus one a shard for the tier's hits; exact request p50/p99/mean
    on each; ``pull_rows_cuda`` at the tier's shape (shard 0's bucket of a
    full served batch) against its plain version, ``index_select``, the
    byte bound and the sector floor. Returns (the tier's launch counts,
    {shard setup: the gather's numbers}, its max abs error)."""
    from paddlebox_tpu_torch.data import build_batch
    from paddlebox_tpu_torch.serve import Follower, ScoreServer, Scorer
    from paddlebox_tpu_torch.utils.monitor import STAT_GET

    rng = np.random.default_rng(args.seed + 11)
    cdf = np.cumsum(hot, dtype=np.float64)
    sizes = rng.integers(8, TIER_SERVE_BATCH + 1, TIER_REQUESTS)
    reqs = [make_records(rng, keys, int(n), cdf=cdf) for n in sizes]
    full = make_records(rng, keys, TIER_SERVE_BATCH, cdf=cdf)  # a full served batch: warm-up and the gather's shape
    small = Scorer(scorer.model, dataclasses.replace(cfg, batch_size=TIER_SERVE_BATCH), device="cuda")

    setups = [("tier off", plain_fol, None, 0.0)]
    for name, devices in TIER_SHARDS:
        with flags(device_scoring_tier="on"):
            fol = Follower(root, lay, opt, n_host_shards=64, trainer=new_trainer(args, cfg, lay), device=list(devices))
            t0 = time.perf_counter()
            if not fol.poll_once():
                raise AssertionError(f"tier {name}: the follower applied nothing")
            apply_s = time.perf_counter() - t0
        tier = fol.version().device_tier
        if tier is None or tier.n_shards != len(devices) or tier.n_rows == 0:
            raise AssertionError(f"tier {name}: the version carries no tier on {devices}")
        setups.append((name, fol, tier, apply_s))
    if plain_fol.version().device_tier is not None:
        raise AssertionError("the tier-off follower's version carries a tier")

    stat_keys = ("serve.device_tier_hits", "serve.device_tier_misses", "serve.key_misses")
    servers = {name: ScoreServer(fol, small, schema, device="cuda") for name, fol, _, _ in setups}
    per = {name: {"ms": [], "preds": [], "launches": dict.fromkeys(ck.launch_counts, 0),
                  "stats": dict.fromkeys(stat_keys, 0)} for name in servers}
    b0 = STAT_GET("serve.batches")
    for srv in servers.values():
        srv.start()
    try:
        for srv in servers.values():  # warm-up: the batch shape's first forward
            srv.score(full, timeout=300.0)
        torch.cuda.synchronize()
        tallies0 = {name: (tier.hits, tier.misses) for name, _, tier, _ in setups if tier is not None}
        for i, rq in enumerate(reqs):
            for j in range(len(setups)):
                name = setups[(i + j) % len(setups)][0]
                s0 = {k: STAT_GET(k) or 0 for k in stat_keys}
                c0 = dict(ck.launch_counts)
                t0 = time.perf_counter()
                got = servers[name].score(rq, timeout=300.0)
                per[name]["ms"].append((time.perf_counter() - t0) * 1e3)
                per[name]["preds"].append(got)
                for k in stat_keys:
                    per[name]["stats"][k] += (STAT_GET(k) or 0) - s0[k]
                for k, v in ck.launch_counts.items():
                    per[name]["launches"][k] += v - c0[k]
    finally:
        for srv in servers.values():
            srv.stop()
    torch.cuda.synchronize()
    n_batches = STAT_GET("serve.batches") - b0
    if n_batches != len(setups) * (1 + len(reqs)):
        raise AssertionError(f"{n_batches} batches for {len(reqs)} requests (and a warm-up) on {len(setups)} servers")

    want = per["tier off"]
    if want["launches"] != want_launches(len(reqs), 0):
        raise AssertionError(f"tier off: launches {want['launches']} for {len(reqs)} batches")
    if want["stats"]["serve.device_tier_hits"] or want["stats"]["serve.device_tier_misses"]:
        raise AssertionError(f"tier off: the tier counters moved {want['stats']}")
    n_absent = want["stats"]["serve.key_misses"]
    counts = want_launches(0, 0)
    shapes, err = {}, 0.0
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    nums = {"requests": len(reqs), "request_records": [int(sizes.min()), int(sizes.max()), float(sizes.mean())],
            "serve_batch": TIER_SERVE_BATCH, "tier off": {"request_ms": request_ms(want["ms"]), "key_misses": n_absent}}
    for name, fol, tier, apply_s in setups[1:]:
        got = per[name]
        for g, w in zip(got["preds"], want["preds"]):
            if not np.array_equal(g, w):
                raise AssertionError(f"tier {name}: served preds differ from the tier-off preds")
        hits, misses = tier.hits - tallies0[name][0], tier.misses - tallies0[name][1]
        stats = got["stats"]
        if (hits, misses) != (stats["serve.device_tier_hits"], stats["serve.device_tier_misses"]):
            raise AssertionError(f"tier {name}: tallies {hits}/{misses} against the counters {stats}")
        if stats["serve.key_misses"] != n_absent:
            raise AssertionError(f"tier {name}: {stats['serve.key_misses']} key misses, the tier off {n_absent}")
        if not (hits > 0 and misses >= n_absent > 0):
            raise AssertionError(f"tier {name}: hits {hits}, tier misses {misses}, key misses {n_absent}: "
                                 "the tier must hit, and miss every absent key")
        c = got["launches"]
        if c != want_launches(len(reqs) * (1 + tier.n_shards), 0):
            raise AssertionError(f"tier {name}: launches {c} for {len(reqs)} batches over {tier.n_shards} shards")
        for k in counts:
            counts[k] += c[k]
        snap = fol.health_snapshot()
        if (snap["tier_rows"], snap["tier_hits"], snap["tier_misses"]) != (tier.n_rows, tier.hits, tier.misses):
            raise AssertionError(f"tier {name}: the health snapshot {snap} does not count the tier")

        # the gather at the tier's shape: shard 0's bucket of a full served batch
        hit, req, _, K = tier.route(np.unique(build_batch(full, schema).keys))
        tab = tier.tables[0]
        ids = torch.from_numpy(np.ascontiguousarray(req[:, 0, :].reshape(-1))).to(tab.device)
        R, W = tab.shape
        U = ids.numel()
        distinct = int(torch.unique(ids).numel())
        err = max(err, check_gather(ck, tab, ids, f"tier {name} shard 0 R={R} U={U} ({distinct} distinct)"))
        med, warm = time_fns({"kernel": lambda: ck.pull_rows_cuda(tab, ids), "plain": lambda: ck.pull_rows_ref(tab, ids),
                              "library": lambda: torch.index_select(tab, 0, ids)}, flush)
        moved = (U + distinct) * W * 4 + U * 4
        bound = moved / HBM_BYTES_PER_S * 1e3
        shapes[name] = {"R": R, "U": U, "distinct": distinct, "K": K, "batch_hits": int(hit.sum()),
                        "batch_keys": len(hit), "ms": med["kernel"], "plain_ms": med["plain"],
                        "library_ms": med["library"], "bound_ms": bound, "bytes": moved,
                        "sector_floor_ms": sector_floor_ms(ids, R, W, False), "warm_l2_ms": warm["kernel"],
                        "warm_l2_plain_ms": warm["plain"], "warm_l2_library_ms": warm["library"]}
        emit({"card": card, "kernel": "pull_rows_cuda", "path": "serve_tier", "shards": name, "W": W,
              **shapes[name], "bound_share": bound / med["kernel"], "reps": TIMING_REPS, "l2": "cold"})
        lat = request_ms(got["ms"])
        nums[name] = {"tier_rows": tier.n_rows, "tier_mem_mb": tier.mem_used_mb(), "apply_s": apply_s,
                      "tier_hits": hits, "tier_misses": misses, "hit_share": hits / (hits + misses),
                      "key_misses": n_absent, "launches": c, "request_ms": lat}
        print(f"device scoring tier, {name}: {tier.n_rows} rows ({tier.mem_used_mb():.1f} MB); {len(reqs)} requests "
              f"of {sizes.min()}-{sizes.max()} records, preds bitwise the tier-off preds; {hits} tier hits, {misses} "
              f"tier misses ({hits / (hits + misses):.1%} hit; {n_absent} keys absent); launches {c}; request "
              f"p50/p99/mean {lat['p50']:.3f}/{lat['p99']:.3f}/{lat['mean']:.3f} ms (tier off "
              f"{nums['tier off']['request_ms']['p50']:.3f}/{nums['tier off']['request_ms']['p99']:.3f}/"
              f"{nums['tier off']['request_ms']['mean']:.3f}); {card}", flush=True)
    emit({"card": card, "phase": "serve_tier", **nums})
    del setups, servers, tier, tab
    return counts, shapes, err


def request_ms(ms):
    """Exact request-latency statistics (ms) of one server's requests."""
    ms = np.asarray(ms)
    p50, p99 = np.percentile(ms, [50, 99])
    return {"p50": float(p50), "p99": float(p99), "mean": float(ms.mean()), "max": float(ms.max())}


def publish_phase(args, card, ck, pull_push, lay, schema, scorer, live):
    """Phase 8: publish, follow and resume the training day at full width,
    with phases 4 and 5 on the follower at the base. Returns the serving
    path's launch counts, its gather's max abs error, and phase 8's launch
    counts by path."""
    from paddlebox_tpu_torch.data import BoxPSDataset
    from paddlebox_tpu_torch.serve import Follower
    from paddlebox_tpu_torch.table import HostSparseTable
    from paddlebox_tpu_torch.train import CheckpointManager

    table, trainer, cfg, opt = live["table"], live["trainer"], live["cfg"], live["sparse_opt"]
    t_phase = time.perf_counter()
    nums, counts = {}, {}
    rng = np.random.default_rng(args.seed + 4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_publish_") as tmp:
        root = os.path.join(tmp, "ckpt")
        cm = CheckpointManager(root)
        t0 = time.perf_counter()
        cm.save_base(PUB_DATE, table, trainer)
        nums["save_base_s"] = time.perf_counter() - t0
        nums["save_base_keys"] = len(table)
        nums["save_base_bytes"] = dir_bytes(os.path.join(root, PUB_DATE, "base"))
        nums["dense_bytes"] = os.path.getsize(os.path.join(root, PUB_DATE, "dense-0000.npz"))
        fol = Follower(root, lay, opt, n_host_shards=64, trainer=new_trainer(args, cfg, lay))
        t0 = time.perf_counter()
        if not fol.poll_once():
            raise AssertionError("the follower applied nothing from the published base")
        nums["follower_base_apply_s"] = time.perf_counter() - t0
        check_followed(fol, table, trainer, 0, "follower at the base")
        counts["serve_follower_base"], nums["publish_to_served_base_s"] = serve_followed(
            fol, scorer, schema, table, trainer, rng, ck, "serving the base")
        t0 = time.perf_counter()
        serve_counts, serve_err = serve_phase(args, card, ck, pull_push, fol, scorer, schema, np.sort(table.keys()))
        serve_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tier_keys = np.sort(table.keys())
        counts["serve_tier"], tier_shape, tier_err = tier_phase(args, card, ck, root, lay, opt, cfg, scorer, schema,
                                                               fol, tier_keys, table.shows_peek(tier_keys))
        tier_s = time.perf_counter() - t0

        # the second day: part of the keys touched, some new, then a delta.
        # Phase 6's data came from --seed + 1, so each later day takes the
        # next seed: the same seed would replay phase 6's first files
        day2, _ = write_bench_files(tmp, np.random.default_rng(args.seed + 2), DAY_FILES, "day2")
        counts["train_day2"], pass_keys, _ = day_pass(
            args, schema, table, trainer, day2, ck, "second day (live stack)", need_save_delta=False)
        t0 = time.perf_counter()
        delta_dir = cm.save_delta(PUB_DATE, table, trainer)
        nums["save_delta_s"] = time.perf_counter() - t0
        shards = sorted(n for n in os.listdir(delta_dir) if n.startswith("shard-"))
        delta_keys = np.sort(np.concatenate([np.load(os.path.join(delta_dir, n))["keys"] for n in shards]))
        if not np.array_equal(delta_keys, pass_keys):
            raise AssertionError("the delta does not hold exactly the keys the second day touched")
        nums["save_delta_keys"] = len(delta_keys)
        nums["save_delta_bytes"] = dir_bytes(delta_dir)
        t0 = time.perf_counter()
        if not fol.poll_once():
            raise AssertionError("the follower applied nothing from delta 1")
        nums["follower_delta_apply_s"] = time.perf_counter() - t0
        check_followed(fol, table, trainer, 1, "follower at delta 1")
        counts["serve_follower_delta1"], nums["publish_to_served_delta1_s"] = serve_followed(
            fol, scorer, schema, table, trainer, rng, ck, "serving delta 1")
        del fol
        print(f"delta 1 holds exactly the second day's {len(delta_keys)} touched keys of {len(table)}", flush=True)

        # resume into a fresh process's stack whose memory tier holds half the keys
        rtable = HostSparseTable(lay, opt, n_shards=64, seed=args.seed, spill_dir=os.path.join(tmp, "spill"),
                                 mem_cap_rows=len(table) // 2)
        rtrainer = new_trainer(args, cfg, lay)
        t0 = time.perf_counter()
        st = CheckpointManager(root).resume(rtable, rtrainer)
        nums["resume_s"] = time.perf_counter() - t0
        if (st["date"], st["delta_idx"]) != (PUB_DATE, 1):
            raise AssertionError(f"resume landed on {st}")
        if not (same_tables(table, rtable) and same_dense(trainer, rtrainer)):
            raise AssertionError("the resumed table or dense state differs from the live one")
        print(f"resume in {nums['resume_s']:.3f} s: table, params and Adam state bitwise the live ones", flush=True)

        # the third day on both stacks; the resumed one spills at its end_pass
        day3, _ = write_bench_files(tmp, np.random.default_rng(args.seed + 3), DAY_FILES, "day3")
        counts["train_live"], _, _ = day_pass(args, schema, table, trainer, day3, ck, "third day (live stack)")
        counts["train_resumed"], _, _ = day_pass(args, schema, rtable, rtrainer, day3, ck,
                                                 "third day (resumed stack)")
        tier = rtable.tier_stats()
        if rtable.disk_rows == 0 or tier["spilled_total"] == 0:
            raise AssertionError("the resumed stack did not spill at its end_pass")
        nums["spilled_rows"], nums["disk_rows_after_end_pass"] = tier["spilled_total"], rtable.disk_rows
        nums["mem_cap_rows"] = rtable.mem_cap_rows
        devs = []
        for tab in (table, rtable):
            ds = BoxPSDataset(schema, tab, batch_size=BATCH, shuffle_mode="local", seed=args.seed)
            ds.set_filelist(day2)
            ds.load_into_memory()
            devs.append(ds.begin_pass(round_to=512))
        nums["promoted_rows"] = rtable.tier_stats()["promoted_total"]
        if nums["promoted_rows"] == 0:
            raise AssertionError("the next begin_pass promoted nothing")
        if not (np.array_equal(devs[0], devs[1]) and same_tables(table, rtable) and same_dense(trainer, rtrainer)):
            raise AssertionError("after the third day the resumed stack differs from the live one")
        print(f"third day: the resumed stack spilled {nums['spilled_rows']} rows at its end_pass and promoted "
              f"{nums['promoted_rows']} at the next begin_pass; pass tables, host tables and dense state bitwise "
              "the live stack's", flush=True)
    nums["phases_4_5_s"], nums["tier_s"] = serve_s, tier_s
    nums["phase_s"] = time.perf_counter() - t_phase - serve_s - tier_s  # phase 8's own seconds
    emit({"card": card, "phase": "publish_follow_resume", **nums})
    return serve_counts, max(serve_err, tier_err), counts, tier_shape


BOUNDARY_GAUGES = (
    "dedup", "premerge", "prefetch_pull", "splice", "pull", "writeback", "writeback_hidden", "overlap_hidden",
)
WIRE_STATS = tuple(f"wire.{d}_{k}_total" for d in ("fetch", "send") for k in ("rows", "bytes", "fp32_bytes"))


def wire_stats() -> dict:
    from paddlebox_tpu_torch.utils.monitor import STAT_GET

    return {k: STAT_GET(k) for k in WIRE_STATS}


def wire_delta(before: dict) -> dict:
    now = wire_stats()
    return {k[len("wire."):-len("_total")]: now[k] - before[k] for k in WIRE_STATS}


def plain_splice(ck, lay, ws1, dev1, ws2, table, decay, mode):
    """The spliced pass-2 table as the plain versions build it: the rows of
    keys in both passes gathered from the carried table, their show and
    click decayed once, and the new keys' host rows over the wire."""
    from paddlebox_tpu_torch.ops.wire_quant import send_rows

    dev = dev1.device
    k1, k2 = ws1.sorted_keys, ws2.sorted_keys
    pos = np.minimum(np.searchsorted(k1, k2), len(k1) - 1)
    common = k1[pos] == k2
    mult = torch.ones(lay.width, device=dev)
    mult[[lay.SHOW, lay.CLK]] = float(np.float32(decay))
    out = torch.zeros((ws2.n_mesh_shards * ws2.capacity, lay.width), device=dev)

    def ids(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    carried = ck.pull_rows_ref(dev1, ids(ws1.row_of_sorted[pos[common]])) * mult[None, :]
    ck.write_rows_ref(out, ids(ws2.row_of_sorted[common]), carried)
    new_rows = send_rows(table.pull_or_create(k2[~common]), lay, mode, dev)
    ck.write_rows_ref(out, ids(ws2.row_of_sorted[~common]), new_rows)
    return out


def bench_boundary_run(args, cfg, lay, schema, files1, files2, pipelined, ck):
    """One run of bench.py's pass and boundary at bench.py's flags (with
    ``boundary_pipeline=pipelined``) on a fresh native table and trainer.
    Returns (numbers, the boundary's launch counts, the pass-2 table on
    the host, the host table after the drain)."""
    from paddlebox_tpu_torch.data import BoxPSDataset
    from paddlebox_tpu_torch.table import HostSparseTable
    from paddlebox_tpu_torch.utils.monitor import STAT_GET, STAT_RESET

    for k in BOUNDARY_GAUGES:  # a gauge this run does not set reads 0
        STAT_RESET(f"boundary.{k}_s")
    opt = cfg.sparse_opt
    table = HostSparseTable(lay, opt, n_shards=64, seed=args.seed)
    ds = BoxPSDataset(schema, table, batch_size=BATCH, shuffle_mode="local", seed=args.seed)
    nums = {}
    ds.set_filelist(files1)
    t0 = time.perf_counter()
    ds.load_into_memory()
    nums["load_into_memory_s"] = time.perf_counter() - t0
    nums["load_into_memory_split_s"] = {
        "read": ds.stats.read_s, "shuffle": ds.stats.shuffle_s, "key_collection": ds.stats.keys_s,
    }
    t0 = time.perf_counter()
    ds.begin_pass(round_to=512)
    nums["begin_pass_s"] = time.perf_counter() - t0
    trainer = new_trainer(args, cfg, lay)
    if pipelined:
        ds.set_filelist(files2)
        ds.preload_into_memory()
    trainer.prepare_pass(ds, n_batches=TRAIN_BATCHES)
    nums["prepare_pass_s"] = trainer.last_prepare_s
    nums["prepare_pass_split_s"] = dict(trainer.last_prepare_parts)
    trainer.train_pass(ds, n_batches=WARM_BATCHES)
    torch.cuda.synchronize()
    nums["preload_running_at_train"] = bool(pipelined and ds._preload_thread.is_alive())
    t0 = time.perf_counter()
    out = trainer.train_pass(ds, n_batches=TRAIN_BATCHES)
    torch.cuda.synchronize()
    nums["train_samples_per_s"] = BATCH * TRAIN_BATCHES / (time.perf_counter() - t0)
    if out["batches"] != TRAIN_BATCHES or not np.isfinite(out["loss"]):
        raise AssertionError(f"pass 1 trained {out['batches']} steps, loss {out['loss']}")
    ws1, dev1 = ds.ws, trainer.trained_table_device()

    # bench.py's boundary, its launch counts from 0
    wire0 = wire_stats()
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    if pipelined:
        ds.end_pass_async(dev1)
        nums["writeback_s"] = time.perf_counter() - t0  # the dispatch
        t0 = time.perf_counter()
        ds.wait_preload_done()
        nums["preload_join_s"] = time.perf_counter() - t0
    else:
        ds.end_pass(dev1)
        nums["writeback_s"] = time.perf_counter() - t0
        ds.set_filelist(files2)
        t0 = time.perf_counter()
        ds.load_into_memory()
        nums["load2_s"] = time.perf_counter() - t0
        nums["preload_join_s"] = 0.0
    t0 = time.perf_counter()
    dev2 = ds.begin_pass(round_to=512)
    nums["finalize2_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    nums["finalize2_synced_s"] = time.perf_counter() - t0
    nums["boundary_s"] = nums["writeback_s"] + nums["finalize2_s"]
    nums["boundary_gauges_s"] = {k: STAT_GET(f"boundary.{k}_s") for k in BOUNDARY_GAUGES}
    nums["wire_boundary"] = wire_delta(wire0)
    ws2 = ds.ws
    if not isinstance(dev2, torch.Tensor) or dev2.device != dev1.device:
        raise AssertionError("begin_pass after a carried end_pass did not splice on the trained table's device")
    k1, k2 = ws1.sorted_keys, ws2.sorted_keys
    n_carried = len(np.intersect1d(k1, k2, assume_unique=True))
    nums["keys"] = {"pass1": len(k1), "pass2": len(k2), "carried": n_carried,
                    "departed": len(k1) - n_carried, "new": len(k2) - n_carried}
    want = plain_splice(ck, lay, ws1, dev1, ws2, table, opt.show_clk_decay, "bf16")
    if not torch.equal(want, dev2.reshape(-1, lay.width)):
        raise AssertionError("the spliced pass-2 table differs from the plain versions' splice")
    pass2 = dev2.reshape(-1, lay.width).cpu().numpy()
    wire1 = wire_stats()
    t0 = time.perf_counter()
    ended = ds.end_pass(None)
    nums["end_pass2_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nums["drained_keys"] = table.drain_pending()
    nums["drain_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = dict(ck.launch_counts)
    nums["wire_drain"] = wire_delta(wire1)
    nums["dropped"] = ended["dropped"]
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel of the boundary never launched: {counts}")
    # the boundary's other gathers against the plain version at their
    # shapes (these launches are not the path's): the departing rows and
    # the rows the drain flushed
    in2 = np.isin(k1, k2, assume_unique=True)
    for what, rows in (("departures", ws1.row_of_sorted[~in2]), ("drain", ws1.row_of_sorted[in2])):
        r = torch.from_numpy(np.ascontiguousarray(rows)).to(dev1.device)
        check_gather(ck, dev1, r, f"boundary {what} R={dev1.shape[0]} W={lay.width} U={len(rows)} int64")
    return nums, counts, pass2, table


def small_boundary_run(args, lay, schema, files1, files2, carried, ck):
    """Run 3: two passes of 16 resident steps at fp32 wire and
    ``shrink_threshold=0``, carried or classic. Returns (pass-2 table on
    the host, pass-2 losses, host table after the drain)."""
    from paddlebox_tpu_torch.data import BoxPSDataset
    from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig
    from paddlebox_tpu_torch.train import TrainStepConfig

    opt = SparseOptimizerConfig(embedx_threshold=0.0, shrink_threshold=0.0)
    cfg = TrainStepConfig(num_slots=NUM_SLOTS, batch_size=BATCH, layout=lay, sparse_opt=opt, auc_buckets=100_000)
    table = HostSparseTable(lay, opt, n_shards=64, seed=args.seed)
    ds = BoxPSDataset(schema, table, batch_size=BATCH, shuffle_mode="local", seed=args.seed)
    trainer = new_trainer(args, cfg, lay)
    out = {}
    with flags(wire_dtype="fp32", boundary_pipeline=0, enable_carried_table=int(carried)):
        for p, files in enumerate((files1, files2)):
            ds.set_filelist(files)
            ds.load_into_memory()
            dev = ds.begin_pass(round_to=512)
            if p == 1:
                if carried != isinstance(dev, torch.Tensor):
                    raise AssertionError(f"carried={carried} but begin_pass gave a {type(dev)}")
                out["pass2"] = (dev.cpu().numpy() if carried else dev).reshape(-1, lay.width)
            losses = []
            trainer.train_pass(ds, n_batches=DAY_STEPS, on_batch=lambda i, m: losses.append(m["loss"]))
            ds.end_pass(trainer.trained_table_device() if carried else trainer.trained_table())
        table.drain_pending()
    out["losses"] = torch.stack(losses).cpu().numpy()
    return out, table


def boundary_phase(args, card, ck, lay, schema, train):
    """Phase 9: bench.py's pass boundary at full width, pipelined (run 1),
    sequential (run 2) and, small, carried against classic (run 3).
    Returns run 1's boundary launch counts."""
    from paddlebox_tpu_torch.train import TrainStepConfig

    t_phase = time.perf_counter()
    cfg = TrainStepConfig(num_slots=NUM_SLOTS, batch_size=BATCH, layout=lay, sparse_opt=train["sparse_opt"],
                          auc_buckets=100_000)
    rng = np.random.default_rng(args.seed + 5)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_boundary_") as tmp:
        t0 = time.perf_counter()
        files1, pool = write_bench_files(tmp, rng, N_FILES)
        files2, _ = write_bench_files(tmp, rng, N_FILES, "p2", reuse_pool=pool)
        write_s = time.perf_counter() - t0
        for name, pipelined in (("pipelined", 1), ("sequential", 0)):
            with flags(wire_dtype="bf16", boundary_pipeline=pipelined, enable_carried_table=1):
                runs[name] = bench_boundary_run(args, cfg, lay, schema, files1, files2, pipelined, ck)
            nums = runs[name][0]
            print(f"pass boundary, {name}: writeback_s {nums['writeback_s']:.4f} preload_join_s "
                  f"{nums['preload_join_s']:.4f} finalize2_s {nums['finalize2_s']:.4f} boundary_s "
                  f"{nums['boundary_s']:.4f}; keys {nums['keys']}; launches {runs[name][1]}", flush=True)
        (n1, counts, t1, h1), (n2, _, t2, h2) = runs["pipelined"], runs["sequential"]
        if not (np.array_equal(t1, t2) and same_tables(h1, h2) and n1["dropped"] == n2["dropped"]):
            raise AssertionError("the pipelined and the sequential boundary differ")
        print("pass boundary: pipelined and sequential give bitwise-equal pass-2 tables and drained host tables",
              flush=True)
        del runs, h1, h2, t1, t2

        small1, pool = write_bench_files(tmp, rng, 4, "small")
        small2, _ = write_bench_files(tmp, rng, 4, "small2", reuse_pool=pool)
        (c, hc), (d, hd) = (small_boundary_run(args, lay, schema, small1, small2, carried, ck)
                            for carried in (False, True))
        if not (np.array_equal(c["pass2"], d["pass2"]) and np.array_equal(c["losses"], d["losses"])
                and same_tables(hc, hd)):
            raise AssertionError("carried and classic boundaries differ at fp32 and shrink_threshold=0")
        print(f"pass boundary: carried and classic at fp32, shrink_threshold=0 ({DAY_STEPS} steps a pass) give "
              "bitwise-equal pass-2 tables, pass-2 losses and host tables", flush=True)
    emit({
        "card": card, "phase": "pass_boundary", "data_write_s": write_s, "pipelined": n1, "sequential": n2,
        "phase6_train_samples_per_s": train["resident_samples_per_s"],
        "phase_s": time.perf_counter() - t_phase,
    })
    return counts


def pv_schema():
    from paddlebox_tpu_torch.data import SlotInfo, SlotSchema

    return SlotSchema(
        [SlotInfo("label", type="float", dense=True, dim=1)] + [SlotInfo(f"s{i}") for i in range(NUM_SLOTS)],
        label_slot="label", parse_logkey=True,
    )


def new_join_trainer(args, cfg, lay, registry=None, device="cuda", hidden=HIDDEN):
    """bench.py's join model: RankDeepFM(DeepFM, 39 * 19, max_rank=4),
    weights from ``--seed``."""
    from paddlebox_tpu_torch.models import DeepFM, RankDeepFM
    from paddlebox_tpu_torch.train import Adam, CTRTrainer

    g = torch.Generator().manual_seed(args.seed)
    model = RankDeepFM(
        DeepFM(NUM_SLOTS, lay.pull_width, lay.embedx_dim, hidden=hidden, generator=g),
        NUM_SLOTS * lay.pull_width, max_rank=MAX_RANK, generator=g,
    )
    tr = CTRTrainer(model, cfg, dense_opt=Adam(1e-3), device=device, metric_registry=registry)
    tr.init_params()
    return tr


def update_trainer(join_tr, cfg, registry=None):
    """The update phase's trainer: the join trainer's model and params, a
    fresh Adam state."""
    from paddlebox_tpu_torch.train import Adam, CTRTrainer

    tr = CTRTrainer(join_tr.model, cfg, dense_opt=Adam(1e-3), device=join_tr.device, metric_registry=registry)
    tr.params = {k: v.clone() for k, v in join_tr.params.items()}
    tr.opt_state = tr.dense_opt.init(tr.params)
    return tr


def join_registry(dev):
    """The three metrics of phase 10: the join phase's, the update
    phase's, and a cmatch/rank AUC over both."""
    from paddlebox_tpu_torch.metrics import MetricRegistry

    reg = MetricRegistry(device=dev)
    reg.init_metric("join_auc", phase=1)
    reg.init_metric("update_auc", phase=0)
    reg.init_metric("cmatch_rank_auc", method="cmatch_rank_auc", cmatch_rank_group="222:1,222:2")
    return reg


def counted(reg, name) -> int:
    st = reg[name].state
    return int(st.pos.sum() + st.neg.sum())


def device_state(tr):
    """Clones of a trainer's table, params and Adam moments on the card."""
    return (
        tr.trained_table_device().clone(), {k: v.clone() for k, v in tr.params.items()},
        {k: v.clone() for k, v in tr.opt_state.mu.items()}, {k: v.clone() for k, v in tr.opt_state.nu.items()},
    )


def same_device_state(a, b) -> bool:
    return torch.equal(a[0], b[0]) and all(torch.equal(a[i][k], b[i][k]) for i in (1, 2, 3) for k in a[1])


def load_pv_pass(args, lay, sparse_opt, files, batch, n_shards=64):
    """A native-tier pass over pv files at the join phase: (dataset, host
    table, {load, begin_pass, preprocess_instance, pv_plan seconds})."""
    from paddlebox_tpu_torch.data import BoxPSDataset
    from paddlebox_tpu_torch.table import HostSparseTable

    table = HostSparseTable(lay, sparse_opt, n_shards=n_shards, seed=args.seed)
    if not table.native:
        raise AssertionError("HostSparseTable is not on the native store")
    ds = BoxPSDataset(pv_schema(), table, batch_size=batch, shuffle_mode="local", seed=args.seed)
    ds.set_filelist(files)
    t = [time.perf_counter()]
    ds.load_into_memory()
    t.append(time.perf_counter())
    ds.begin_pass(round_to=512)
    t.append(time.perf_counter())
    if ds.store is None:
        raise AssertionError("the native parser did not load the pv pass into a columnar store")
    ds.set_current_phase(1)
    ds.preprocess_instance(max_rank=MAX_RANK)
    t.append(time.perf_counter())
    if ds.pv_plan() is None:
        raise AssertionError("a store-backed pass has no pv plan: the join phase would take the record-level feed")
    t.append(time.perf_counter())
    names = ("load_into_memory_s", "begin_pass_s", "preprocess_instance_s", "pv_plan_s")
    return ds, table, {k: b - a for k, a, b in zip(names, t, t[1:])}


def join_card_vs_cpu(args, lay, sparse_opt, files, dev):
    """The join then the update phase, JOIN_SMALL_STEPS steps each, at
    batch JOIN_SMALL_BATCH over ``files`` with the dense tower
    JOIN_SMALL_HIDDEN (the rank tower at full width), on the card ``dev``
    and on the port's CPU path from one state; raises if they disagree."""
    from paddlebox_tpu_torch.train import TrainStepConfig

    kw = dict(num_slots=NUM_SLOTS, batch_size=JOIN_SMALL_BATCH, layout=lay, sparse_opt=sparse_opt, auc_buckets=1000)
    out = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        ds, _, _ = load_pv_pass(args, lay, sparse_opt, files, JOIN_SMALL_BATCH, n_shards=8)
        jt = new_join_trainer(args, TrainStepConfig(**kw, model_takes_rank_offset=True), lay, device=device,
                              hidden=JOIN_SMALL_HIDDEN)
        losses = []
        jt.train_pass(ds, n_batches=JOIN_SMALL_STEPS, on_batch=lambda i, m: losses.append(m["loss"]))
        jt.handoff_table(ds)
        ds.postprocess_instance()
        ds.set_current_phase(0)
        ut = update_trainer(jt, TrainStepConfig(**kw))
        ut.train_pass(ds, n_batches=JOIN_SMALL_STEPS, on_batch=lambda i, m: losses.append(m["loss"]))
        if (jt.last_feed, ut.last_feed) != ("resident_pv", "resident"):
            raise AssertionError(f"join card vs CPU on {name}: feeds {jt.last_feed}, {ut.last_feed}")
        out[name] = (torch.from_numpy(ut.trained_table()), {k: v.cpu() for k, v in ut.params.items()},
                    torch.stack(losses).cpu())
    (gt, gp, gl), (ct, cp, cl) = out["card"], out["cpu"]
    tab_err = float((gt - ct).abs().max())
    tab_ok = bool(torch.allclose(gt, ct, rtol=SMALL_TABLE_RTOL, atol=SMALL_TABLE_ATOL))
    par_err, par_at = max((float((gp[k] - cp[k]).abs().max()), k) for k in cp)
    loss_err = float(((gl - cl).abs() / cl.abs()).max())
    print(
        f"join card vs CPU ({JOIN_SMALL_FILES} files, batch {JOIN_SMALL_BATCH}, hidden {JOIN_SMALL_HIDDEN}, "
        f"{JOIN_SMALL_STEPS} join + {JOIN_SMALL_STEPS} update steps): table max |diff| {tab_err:.3e} (rtol "
        f"{SMALL_TABLE_RTOL}, atol {SMALL_TABLE_ATOL}), params max |diff| {par_err:.3e} at {par_at} (atol "
        f"{JOIN_PARAMS_ATOL}), loss max rel diff {loss_err:.3e} (rtol {SMALL_LOSS_RTOL})",
        flush=True,
    )
    if not (tab_ok and par_err <= JOIN_PARAMS_ATOL and loss_err <= SMALL_LOSS_RTOL):
        raise AssertionError("the join day on the card and on the CPU path disagree")
    return {"table_max_abs_diff": tab_err, "params_max_abs_diff": par_err, "params_max_at": par_at,
            "loss_max_rel_diff": loss_err}


def join_twins(args, cfg, lay, ds, ck, pull_push, dev):
    """JOIN_FEED_STEPS resident join steps from one state, twice, and once
    with the writeback forced to ``write_rows_ref`` and the gather to
    ``pull_rows_ref``: tables, params and Adam moments bitwise equal."""
    runs = []
    for plain in (False, False, True):
        if plain:
            pull_push.write_rows_cuda, pull_push.pull_rows_cuda = ck.write_rows_ref, ck.pull_rows_ref
        try:
            tr = new_join_trainer(args, cfg, lay, device=dev)
            tr.train_pass(ds, n_batches=JOIN_FEED_STEPS)
            torch.cuda.synchronize()
        finally:
            pull_push.write_rows_cuda, pull_push.pull_rows_cuda = ck.write_rows_cuda, ck.pull_rows_cuda
        runs.append(device_state(tr))
    if not same_device_state(runs[0], runs[1]):
        raise AssertionError("two runs of the same join steps differ")
    if not same_device_state(runs[0], runs[2]):
        raise AssertionError("join steps with the plain gather and writeback differ from the kernels'")
    print(f"join twins: {JOIN_FEED_STEPS} steps twice from one state, and with pull_rows_ref and write_rows_ref, "
          "give bitwise-equal tables, params and Adam moments", flush=True)


def join_probe(args, cfg, lay, ds, dev):
    """A warm join trainer with a registry attached, on the resident pv
    feed: one superstep of JOIN_SYNC_STEPS steps through the trainer's
    stepper and its registry feed under ``set_sync_debug_mode("warn")``,
    then PROFILE_BATCHES steps one a dispatch for the host-clock split,
    then RESIDENT_K steps under the profiler for the card's busy time.
    Returns (host syncs, their sites, the split's ms a step, busy ms a
    step)."""
    from collections import defaultdict

    tr = new_join_trainer(args, cfg, lay, join_registry(dev), device=dev)
    with flags(resident_scan_batches=JOIN_SYNC_STEPS):
        tr.train_pass(ds, n_batches=JOIN_SYNC_STEPS)  # warm: the plan's upload, the logkey columns
        torch.cuda.synchronize()
        holder = {"state": tr._state}

        def superstep():
            losses: list = []
            for i, m, aux in tr._resident_stepper(ds, JOIN_SYNC_STEPS, holder, False, False, defaultdict(float), True):
                tr._consume_batch(i, m, aux, ds, None, losses, [])
            if len(losses) != JOIN_SYNC_STEPS or not aux:
                raise AssertionError("the probed superstep fed no registry inputs")

        n_syncs, sites = host_syncs(superstep)
    prof = tr.train_pass(ds, n_batches=PROFILE_BATCHES, profile=True)["profile"]
    busy = busy_ms_per_step(lambda: tr.train_pass(ds, n_batches=RESIDENT_K), RESIDENT_K)
    return n_syncs, sites, {k: v / PROFILE_BATCHES * 1e3 for k, v in prof.items()}, busy


def join_update_phase(args, dev, card, ck, pull_push, lay):
    """Phase 10: bench.py's join/update day at full width on its own
    stack. Returns the launch counts of the paths ``join`` and ``update``
    and the kernels' max abs error at those paths' shapes."""
    from paddlebox_tpu_torch.table import SparseOptimizerConfig
    from paddlebox_tpu_torch.train import ResidentPass, ResidentPvFeed, TrainStepConfig, build_device_batch

    t_phase = time.perf_counter()
    sparse_opt = SparseOptimizerConfig(embedx_threshold=0.0)
    kw = dict(num_slots=NUM_SLOTS, batch_size=BATCH, layout=lay, sparse_opt=sparse_opt, auc_buckets=100_000)
    join_cfg = TrainStepConfig(**kw, model_takes_rank_offset=True)
    upd_cfg = TrainStepConfig(**kw)
    rng = np.random.default_rng(args.seed + 6)
    counts, nums = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_join_") as tmp:
        t0 = time.perf_counter()
        files, _ = write_bench_files(tmp, rng, N_FILES, "pv", pv=True)
        small_files, _ = write_bench_files(tmp, rng, JOIN_SMALL_FILES, "pvsmall", pv=True)
        nums["data_write_s"] = time.perf_counter() - t0
        ds, table, setup = load_pv_pass(args, lay, sparse_opt, files, BATCH)
        nums.update(setup)
        n_rec, n_keys, n_pvs = ds.memory_data_size(), ds.ws.n_keys, len(ds.pvs)
        plan = ds.pv_plan()
        n_b = plan.n_batches
        if ds.num_pv_batches() != n_b:
            raise AssertionError(f"num_pv_batches() {ds.num_pv_batches()} != the plan's {n_b}")
        print(f"join data: {N_FILES} files x {RECORDS_PER_FILE} records, {n_pvs} pvs, {n_b} pv batches an epoch, "
              f"{n_keys} keys; load_into_memory {setup['load_into_memory_s']:.3f} s, begin_pass "
              f"{setup['begin_pass_s']:.3f} s, preprocess_instance {setup['preprocess_instance_s']:.3f} s, "
              f"pv_plan {setup['pv_plan_s']:.3f} s", flush=True)
        reg = join_registry(dev)
        jtr = new_join_trainer(args, join_cfg, lay, reg, device=dev)

        # ---- the join phase, bench.py's way: prepare, a warm-up epoch, two
        # timed epochs; then an eval epoch. Launch counts from 0.
        outs, feeds = [], []
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        jtr.prepare_pass(ds)
        t0 = time.perf_counter()
        outs.append(jtr.train_pass(ds))
        feeds.append(jtr.last_feed)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(JOIN_TIMED_EPOCHS):
            outs.append(jtr.train_pass(ds))
            feeds.append(jtr.last_feed)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trained = device_state(jtr)
        jtr.set_test_mode(True)
        outs.append(jtr.train_pass(ds))
        feeds.append(jtr.last_feed)
        jtr.set_test_mode(False)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        counts["join"] = dict(ck.launch_counts)
        nums.update(prepare_pass_s=jtr.last_prepare_s, prepare_parts=dict(jtr.last_prepare_parts),
                    warm_up_s=t1 - t0, train_s=t2 - t1, eval_s=t3 - t2)
        nums["join_samples_per_s"] = JOIN_TIMED_EPOCHS * n_rec / nums["train_s"]
        if feeds != ["resident_pv"] * len(feeds):
            raise AssertionError(f"the join epochs took the feeds {feeds}, not the resident pv feed")
        for i, o in enumerate(outs):
            if o["batches"] != n_b or o["ins_num"] != n_rec or not np.isfinite(o["loss"]):
                raise AssertionError(f"join epoch {i}: {o['batches']} batches (want {n_b}), ins_num {o['ins_num']} "
                                     f"(want memory_data_size() {n_rec}), loss {o['loss']}")
        n_train = (1 + JOIN_TIMED_EPOCHS) * n_b
        want = want_launches(2 * n_train + n_b, n_train)
        if counts["join"] != want:
            raise AssertionError(f"join path launches {counts['join']}, want {want} (2 gathers and 1 writeback a "
                                 "training step, 1 gather an eval step)")
        if not same_device_state(device_state(jtr), trained):
            raise AssertionError("the join eval epoch changed the table, params or Adam state")
        n_join = counted(reg, "join_auc")
        if n_join != 4 * n_rec or counted(reg, "update_auc") != 0:
            raise AssertionError(f"registry after the join phase: join {n_join} (want 4 x {n_rec}), "
                                 f"update {counted(reg, 'update_auc')} (want 0)")
        join_line = reg.get_metric_msg("join_auc")
        print(f"join phase (resident pv feed, K = {RESIDENT_K}): {n_b} steps an epoch, prepare_pass "
              f"{nums['prepare_pass_s']:.3f} s {nums['prepare_parts']}, warm-up epoch {nums['warm_up_s']:.3f} s, "
              f"{JOIN_TIMED_EPOCHS} timed epochs {nums['train_s']:.3f} s = {nums['join_samples_per_s']:.1f} "
              f"samples/s, eval epoch {nums['eval_s']:.3f} s; launches {counts['join']}; each epoch's ins_num = "
              f"memory_data_size() = {n_rec}; the eval epoch left the state bitwise; losses "
              f"{[round(o['loss'], 5) for o in outs]}; {card}", flush=True)
        print(f"registry, read at the end of the join phase: {join_line}", flush=True)

        # the kernels at the join path's shape, against their plain versions
        rp = ResidentPass(ds.store, ds.ws, ds.schema, dev)
        rp.ensure(plan.idx)
        rows = build_device_batch(rp, join_cfg, ResidentPvFeed(plan, rp.device).idx[0])["uniq_rows"]
        tab = jtr.trained_table_device().clone()
        what = f"join path R={tab.shape[0]} W={tab.shape[1]} U={rows.shape[0]} int32"
        errs = [check_gather(ck, tab, rows, what),
                check_write(ck, tab, rows, ck.pull_rows_ref(tab, rows) + 0.5, what)]
        del rp, tab

        # ---- the same steps from one state: four feeds, twins, the superstep's syncs
        view = copy.copy(ds)
        view.records = ds.records  # a pass held as SlotRecords: no plan, the record-level feed
        four_feeds_bitwise(lambda: new_join_trainer(args, join_cfg, lay, device=dev), {
            f"resident K={JOIN_FEED_STEPS}": (dict(enable_resident_feed=1, resident_scan_batches=JOIN_FEED_STEPS),
                                              ds, "resident_pv"),
            "resident K=1": (dict(enable_resident_feed=1, resident_scan_batches=1), ds, "resident_pv"),
            "pv packer": (dict(enable_resident_feed=0), ds, "pv_packer"),
            "pv records": (dict(enable_resident_feed=1), view, "pv_records"),
        }, JOIN_FEED_STEPS, "four join feeds")
        del view
        join_twins(args, join_cfg, lay, ds, ck, pull_push, dev)
        n_syncs, sync_sites, split, busy = join_probe(args, join_cfg, lay, ds, dev)
        step_ms = nums["train_s"] / (JOIN_TIMED_EPOCHS * n_b) * 1e3
        nums.update(join_ms_per_step=step_ms, join_host_clock_ms_per_step_profiled=split,
                    join_device_busy_ms_per_step=busy, join_device_idle_share=1.0 - busy / step_ms)
        print(f"resident pv superstep of {JOIN_SYNC_STEPS} steps with a registry attached, under "
              f"set_sync_debug_mode('warn'): {n_syncs} host syncs at {sync_sites}; a join step "
              f"{step_ms:.3f} ms (timed epochs), the card busy {busy:.3f} ms of it (idle "
              f"{nums['join_device_idle_share']:.3f}), host clock over {PROFILE_BATCHES} profiled steps "
              f"{ {k: round(v, 3) for k, v in split.items()} } ms a step; {card}", flush=True)
        if n_syncs:
            raise AssertionError(f"the resident pv superstep made {n_syncs} host syncs")

        # ---- the update phase on the flat resident feed, then end_pass
        jtr.handoff_table(ds)
        ds.postprocess_instance()
        ds.set_current_phase(0)
        utr = update_trainer(jtr, upd_cfg, reg)
        utr.prepare_pass(ds)
        n_u = ds.num_batches()
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        uout = utr.train_pass(ds)
        torch.cuda.synchronize()
        nums["update_s"] = time.perf_counter() - t0
        counts["update"] = dict(ck.launch_counts)
        nums["update_samples_per_s"] = BATCH * n_u / nums["update_s"]
        if utr.last_feed != "resident" or uout["batches"] != n_u or not np.isfinite(uout["loss"]):
            raise AssertionError(f"update phase: feed {utr.last_feed}, {uout['batches']} batches (want {n_u}), "
                                 f"loss {uout['loss']}")
        if counts["update"] != want_launches(2 * n_u, n_u):
            raise AssertionError(f"update path launches {counts['update']} for {n_u} steps")
        if not torch.equal(jtr.trained_table_device(), trained[0]):
            raise AssertionError("the update pass wrote the join trainer's table")
        if counted(reg, "update_auc") != BATCH * n_u or counted(reg, "join_auc") != 0:
            raise AssertionError(f"registry after the update phase: update {counted(reg, 'update_auc')} "
                                 f"(want {BATCH * n_u}), join {counted(reg, 'join_auc')} (want 0 after its read)")
        rp = ResidentPass(ds.store, ds.ws, ds.schema, dev)
        idx = next(iter(ds.batch_indices(1))).astype(np.int32)
        rp.ensure([idx])
        rows = build_device_batch(rp, upd_cfg, torch.from_numpy(idx).to(dev))["uniq_rows"]
        tab = utr.trained_table_device().clone()
        what = f"update path R={tab.shape[0]} W={tab.shape[1]} U={rows.shape[0]} int32"
        errs += [check_gather(ck, tab, rows, what),
                 check_write(ck, tab, rows, ck.pull_rows_ref(tab, rows) + 0.5, what)]
        del rp, tab
        t0 = time.perf_counter()
        ended = ds.end_pass(utr.trained_table())
        nums["end_pass_s"] = time.perf_counter() - t0
        if len(table) != n_keys - ended["dropped"]:
            raise AssertionError(f"host table holds {len(table)} keys; want {n_keys} less {ended['dropped']}")
        lines = {k: reg.get_metric_msg(k) for k in ("update_auc", "cmatch_rank_auc")}
        print(f"update phase (resident feed): {n_u} steps in {nums['update_s']:.3f} s = "
              f"{nums['update_samples_per_s']:.1f} samples/s; launches {counts['update']}; the join trainer's "
              f"table intact; end_pass {nums['end_pass_s']:.3f} s, {len(table)} keys kept; {card}", flush=True)
        for line in lines.values():
            print(f"registry: {line}", flush=True)
        nums["card_vs_cpu"] = join_card_vs_cpu(args, lay, sparse_opt, small_files, dev)
    emit({
        "card": card, "phase": "join_update", "records": n_rec, "pvs": n_pvs, "pv_batches_per_epoch": n_b,
        "update_batches": n_u, "keys": n_keys, **nums, "host_syncs_per_pv_superstep": n_syncs,
        "registry": {"join_auc": join_line, **lines}, "phase_s": time.perf_counter() - t_phase,
    })
    return counts, max(errs)


# ---- 11. the model zoo, async dense, dumps and the façade --------------------


def zoo_schema(n_slots, dense_dim):
    """bench.py's schema of ``n_slots`` one-key slots, with ``dense_dim`` a
    float slot "dense" after the label."""
    from paddlebox_tpu_torch.data import SlotInfo, SlotSchema

    dense = [SlotInfo("dense", type="float", dense=True, dim=dense_dim)] if dense_dim else []
    return SlotSchema(
        [SlotInfo("label", type="float", dense=True, dim=1)] + dense + [SlotInfo(f"s{i}") for i in range(n_slots)],
        label_slot="label",
    )


def zoo_model(name, lay, seed, small=False):
    """The zoo's model ``name`` at the JAX classes' default widths (with
    ``small``, the card-vs-CPU check's towers), weights from ``seed``.
    Returns (model, the dense slot's width it reads)."""
    from paddlebox_tpu_torch.models import DCN, MMoE, LogisticRegression, WideDeep, task_head

    g = torch.Generator().manual_seed(seed)
    pw = lay.pull_width
    if name == "lr":
        return LogisticRegression(NUM_SLOTS, pw, generator=g), 0
    if name == "wide_deep":
        return WideDeep(NUM_SLOTS, pw, dense_dim=ZOO_DENSE_DIM, hidden=(32, 16) if small else (512, 256, 128),
                        generator=g), ZOO_DENSE_DIM
    if name == "dcn":
        return DCN(DCN_SLOTS, pw, n_cross=3, hidden=(32, 16) if small else (256, 128), generator=g), 0
    mmoe = MMoE(NUM_SLOTS, pw, n_experts=4, n_tasks=2, expert_hidden=(32, 16) if small else (128, 64),
                tower_hidden=(8,) if small else (32,), generator=g)
    return task_head(mmoe, 0), 0


def zoo_cfg(name, lay, sparse_opt, batch, **kw):
    from paddlebox_tpu_torch.train import TrainStepConfig

    n_slots = DCN_SLOTS if name == "dcn" else NUM_SLOTS
    return TrainStepConfig(num_slots=n_slots, batch_size=batch, layout=lay, sparse_opt=sparse_opt,
                           auc_buckets=100_000, **kw)


def zoo_trainer(name, lay, cfg, seed, device="cuda", small=False, **kw):
    from paddlebox_tpu_torch.train import Adam, CTRTrainer

    model, dd = zoo_model(name, lay, seed, small)
    dense = dict(dense_slot="dense", dense_dim=dd) if dd else {}
    tr = CTRTrainer(model, cfg, dense_opt=Adam(1e-3), device=device, **dense, **kw)
    tr.init_params()
    return tr


def zoo_pass(args, lay, sparse_opt, files, schema, batch, n_shards=64):
    """A native-tier pass over ``files``: (dataset, host table)."""
    from paddlebox_tpu_torch.data import BoxPSDataset
    from paddlebox_tpu_torch.table import HostSparseTable

    table = HostSparseTable(lay, sparse_opt, n_shards=n_shards, seed=args.seed)
    ds = BoxPSDataset(schema, table, batch_size=batch, shuffle_mode="local", seed=args.seed)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=512)
    if ds.store is None or not table.native:
        raise AssertionError("the zoo's pass is not on the native tier")
    return ds, table


def zoo_syncs(tr, ds):
    """Host syncs of one resident superstep of RESIDENT_K steps through a
    warm trainer's stepper and its per-batch consumers."""
    from collections import defaultdict

    with flags(resident_scan_batches=RESIDENT_K):
        holder = {"state": tr._state}

        def superstep():
            losses: list = []
            for i, m, aux in tr._resident_stepper(ds, RESIDENT_K, holder, False, False, defaultdict(float), False):
                tr._consume_batch(i, m, aux, ds, None, losses, [])
            if len(losses) != RESIDENT_K:
                raise AssertionError(f"the probed superstep ran {len(losses)} steps")

        return host_syncs(superstep)


def noisy_grads(steps_a, steps_b):
    """Per param, the elements whose gradients on the two sides differ by
    more than ZOO_GRAD_REL of their own size at some step (a sign flip
    among them): the bf16 tower's rounding decides them."""
    out: dict = {}
    for ga, gb in zip(steps_a, steps_b):
        for k in gb:
            a, b = ga[k].cpu(), gb[k].cpu()
            n = (a - b).abs() > ZOO_GRAD_REL * b.abs()
            out[k] = out[k] | n if k in out else n
    return out


def params_within(card, cpu, noisy, n_steps, lr=1e-3):
    """Params on the card against the CPU path: within ZOO_PARAMS_ATOL, but
    for an element whose gradient the bf16 rounding decides (``noisy``):
    Adam's step is scale-free, lr times the gradient's sign at first, so
    such an element can move by up to 2 lr a step more on one side. Returns
    (ok, the largest |diff| of the other elements, where, the number of
    noisy elements, the largest |diff| of those)."""
    worst, at, ok, n_noisy, worst_noisy = 0.0, "", True, 0, 0.0
    for k, c in cpu.items():
        d = (card[k].cpu() - c).abs()
        f = noisy.get(k, torch.zeros_like(d, dtype=torch.bool))
        n_noisy += int(f.sum())
        rest = float(torch.where(f, 0.0, d).max()) if d.numel() else 0.0
        worst_noisy = max(worst_noisy, float(torch.where(f, d, 0.0).max()) if d.numel() else 0.0)
        if rest > worst:
            worst, at = rest, k
        ok &= rest <= ZOO_PARAMS_ATOL and bool((d <= 2 * lr * n_steps).all())
    return ok, worst, at, n_noisy, worst_noisy


def zoo_card_vs_cpu(name, lay, sparse_opt, ds, seed, dev):
    """ZOO_SMALL_STEPS training steps of ``name`` (small towers) from one
    state on the card and on the port's CPU path, over the first batches of
    ``ds`` packed on the host. Before each step the async-mode step takes
    the dense gradients on a copy of the state, to see where their signs
    part. Raises if the two disagree beyond the bounds."""
    import dataclasses

    from torch.func import functional_call

    from paddlebox_tpu_torch.data import pack_batch
    from paddlebox_tpu_torch.train import Adam, make_train_step

    cfg = zoo_cfg(name, lay, sparse_opt, ZOO_SMALL_BATCH)
    _, dd = zoo_model(name, lay, seed, small=True)
    view = records_view(ds, ZOO_SMALL_STEPS)
    dense = dict(dense_slot="dense", dense_dim=dd) if dd else {}
    dbs = [pack_batch(b, ds.ws, ds.schema, **dense).as_dict() for b in view.batches(ZOO_SMALL_STEPS)]
    table0 = np.ascontiguousarray(np.asarray(ds.device_table).reshape(-1, lay.width))
    out, grads = {}, {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = zoo_model(name, lay, seed, small=True)[0].to(device)

        def apply(p, x, d, m=model):
            return functional_call(m, p, (x, d))

        step = make_train_step(apply, cfg, Adam(1e-3))
        gstep = make_train_step(apply, dataclasses.replace(cfg, dense_sync_mode="async"))
        params = {k: v.detach().clone() for k, v in model.state_dict().items()}
        st = fresh_state(table0, params, Adam(1e-3).init(params), device)
        losses, gs = [], []
        for db in dbs:
            feed = {k: torch.from_numpy(v).to(device) for k, v in db.items()}
            gs.append(gstep(st._replace(table=st.table.clone()), feed)[1]["gparams"])
            st, m = step(st, feed)
            losses.append(m["loss"])
        out[where], grads[where] = (st, torch.stack(losses).cpu()), gs
    (g, gl), (c, cl) = out["card"], out["cpu"]
    tab_err = float((g.table.cpu() - c.table).abs().max())
    tab_ok = bool(torch.allclose(g.table.cpu(), c.table, rtol=SMALL_TABLE_RTOL, atol=SMALL_TABLE_ATOL))
    par_ok, par_err, par_at, n_noisy, noisy_err = params_within(
        g.params, c.params, noisy_grads(grads["card"], grads["cpu"]), ZOO_SMALL_STEPS
    )
    loss_err = float(((gl - cl).abs() / cl.abs()).max())
    res = {"table_max_abs_diff": tab_err, "params_max_abs_diff": par_err, "params_max_at": par_at,
           "noisy_grad_elements": n_noisy, "noisy_params_max_abs_diff": noisy_err,
           "params": sum(v.numel() for v in c.params.values()), "loss_max_rel_diff": loss_err}
    print(f"zoo {name} card vs CPU ({ZOO_SMALL_STEPS} steps, batch {ZOO_SMALL_BATCH}, small towers): {res} "
          f"(table rtol {SMALL_TABLE_RTOL} atol {SMALL_TABLE_ATOL}, params atol {ZOO_PARAMS_ATOL} where the "
          f"gradients agree within {ZOO_GRAD_REL:g} of their size, loss rtol {SMALL_LOSS_RTOL})", flush=True)
    if not (tab_ok and par_ok and loss_err <= SMALL_LOSS_RTOL):
        raise AssertionError(f"zoo {name}: the card and the CPU path disagree")
    return res


def zoo_model_run(args, name, lay, sparse_opt, ds, small_ds, ck, dev, card):
    """One zoo model on the card: prepare_pass, a warm-up epoch and two
    timed epochs on the resident feed, busy ms, the superstep's syncs, the
    feeds bitwise, then the small card-vs-CPU check. Returns (numbers,
    launch counts of the warm-up and timed epochs)."""
    t_model = time.perf_counter()
    cfg = zoo_cfg(name, lay, sparse_opt, BATCH)
    n_b, n_rec = ds.num_batches(), ds.memory_data_size()
    tr = zoo_trainer(name, lay, cfg, args.seed)
    losses = []

    def keep(i, m):
        losses.append(m["loss"])

    torch.cuda.synchronize()
    ck.reset_launch_counts()
    tr.prepare_pass(ds)
    t0 = time.perf_counter()
    outs = [tr.train_pass(ds, on_batch=keep)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs += [tr.train_pass(ds, on_batch=keep) for _ in range(ZOO_TIMED_EPOCHS)]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = dict(ck.launch_counts)
    if tr.last_feed != "resident":
        raise AssertionError(f"zoo {name}: the {tr.last_feed} feed, not the resident feed")
    check_path(f"zoo {name} (resident feed, a warm-up and {ZOO_TIMED_EPOCHS} timed epochs)",
               {"batches": sum(o["batches"] for o in outs), "loss": outs[-1]["loss"], "auc": outs[-1]["auc"]},
               torch.stack(losses).cpu(), counts, (1 + ZOO_TIMED_EPOCHS) * n_b)
    step_ms = (t2 - t1) / (ZOO_TIMED_EPOCHS * n_b) * 1e3
    busy = busy_ms_per_step(lambda: tr.train_pass(ds, n_batches=RESIDENT_K), RESIDENT_K)
    n_syncs, sites = zoo_syncs(tr, ds)
    if n_syncs:
        raise AssertionError(f"zoo {name}: the resident superstep made {n_syncs} host syncs at {sites}")
    nums = {
        "samples_per_s": ZOO_TIMED_EPOCHS * n_rec / (t2 - t1), "ms_per_step": step_ms,
        "device_busy_ms_per_step": busy, "device_idle_share": 1.0 - busy / step_ms,
        "prepare_pass_s": tr.last_prepare_s, "warm_up_s": t1 - t0, "host_syncs_per_superstep": n_syncs,
        "params": sum(v.numel() for v in tr.params.values()),
    }
    del tr
    feeds = {
        f"resident K={ZOO_FEED_STEPS}": (dict(enable_resident_feed=1, resident_scan_batches=ZOO_FEED_STEPS), ds,
                                         "resident"),
        "resident K=1": (dict(enable_resident_feed=1, resident_scan_batches=1), ds, "resident"),
        "packer": (dict(enable_resident_feed=0), ds, "packer"),
    }
    if name == "wide_deep":  # dense features on every feed
        feeds["slow"] = (dict(enable_resident_feed=0), records_view(ds, ZOO_FEED_STEPS), "slow")
    four_feeds_bitwise(lambda: zoo_trainer(name, lay, cfg, args.seed), feeds, ZOO_FEED_STEPS, f"zoo {name} feeds")
    nums["card_vs_cpu"] = zoo_card_vs_cpu(name, lay, sparse_opt, small_ds, args.seed, dev)
    nums["model_s"] = time.perf_counter() - t_model
    print(f"zoo {name} ({nums['params']} dense params): {n_b} steps an epoch, {ZOO_TIMED_EPOCHS} timed epochs "
          f"{nums['samples_per_s']:.1f} samples/s, {step_ms:.3f} ms a step, busy {busy:.3f} ms (idle "
          f"{nums['device_idle_share']:.3f}), prepare_pass {nums['prepare_pass_s']:.3f} s, warm-up "
          f"{nums['warm_up_s']:.3f} s, {n_syncs} host syncs in a superstep of {RESIDENT_K}; {card}", flush=True)
    return nums, counts


def async_det_pass(args, lay, sparse_opt, ds, device):
    """ZOO_SMALL_STEPS steps of a small WideDeep on the packer feed under
    async dense, driven deterministically: ``merge_limit=1`` and each
    batch's ``on_batch`` waits until its update is applied. Returns (the
    table, the final params, the losses, each step's gradients)."""
    from paddlebox_tpu_torch.train import AsyncDenseTable

    cfg = zoo_cfg("wide_deep", lay, sparse_opt, ZOO_SMALL_BATCH, dense_sync_mode="async")
    model, _ = zoo_model("wide_deep", lay, args.seed, small=True)
    adt = AsyncDenseTable(model.state_dict(), base_lr=1e-3, merge_limit=1)
    tr = zoo_trainer("wide_deep", lay, cfg, args.seed, device=device, small=True, async_dense=adt)
    losses, grads = [], []

    def wait(i, m):
        grads.append({k: v.cpu() for k, v in m["gparams"].items()})
        losses.append(m["loss"])
        if not adt.wait_for_updates(i + 1, timeout=600):
            raise AssertionError(f"async update {i + 1} never applied")

    with flags(enable_resident_feed=1):
        tr.train_pass(ds, n_batches=ZOO_SMALL_STEPS, on_batch=wait)
    if tr.last_feed != "packer" or adt.n_updates != ZOO_SMALL_STEPS:
        raise AssertionError(f"deterministic async pass: feed {tr.last_feed}, {adt.n_updates} updates")
    final = adt.finalize()
    return torch.from_numpy(tr.trained_table()), {k: torch.from_numpy(v) for k, v in final.items()}, \
        torch.stack(losses).cpu(), grads


def async_phase(args, lay, sparse_opt, ds, small_ds, ck, dev, card):
    """Async dense on WideDeep's packer feed: the deterministic drive
    (twins on the card, the card against the CPU path) at the small size,
    then a free-running pass at full width."""
    from paddlebox_tpu_torch.train import AsyncDenseTable

    runs = [async_det_pass(args, lay, sparse_opt, small_ds, d) for d in (dev, dev, torch.device("cpu"))]
    (t1, p1, l1, g1), (t2, p2, l2, _), (tc, pc, lc, gc) = runs
    if not (torch.equal(t1, t2) and torch.equal(l1, l2) and all(torch.equal(p1[k], p2[k]) for k in p1)):
        raise AssertionError("two deterministic async passes on the card differ")
    tab_ok = bool(torch.allclose(t1, tc, rtol=SMALL_TABLE_RTOL, atol=SMALL_TABLE_ATOL))
    par_ok, par_err, par_at, n_noisy, noisy_err = params_within(p1, pc, noisy_grads(g1, gc), ZOO_SMALL_STEPS)
    loss_err = float(((l1 - lc).abs() / lc.abs()).max())
    det = {"table_max_abs_diff": float((t1 - tc).abs().max()), "params_max_abs_diff": par_err,
           "params_max_at": par_at, "noisy_grad_elements": n_noisy, "noisy_params_max_abs_diff": noisy_err,
           "loss_max_rel_diff": loss_err}
    print(f"async dense, deterministic (merge_limit=1, a wait on each update; {ZOO_SMALL_STEPS} packer steps, "
          f"batch {ZOO_SMALL_BATCH}): twins on the card bitwise; card vs CPU {det}", flush=True)
    if not (tab_ok and par_ok and loss_err <= SMALL_LOSS_RTOL):
        raise AssertionError("the deterministic async pass on the card and on the CPU path disagree")

    # free-running at full width: the table merges whatever the queue holds
    cfg = zoo_cfg("wide_deep", lay, sparse_opt, BATCH, dense_sync_mode="async")
    model, _ = zoo_model("wide_deep", lay, args.seed)
    adt = AsyncDenseTable(model.state_dict(), base_lr=1e-3)
    tr = zoo_trainer("wide_deep", lay, cfg, args.seed, async_dense=adt)
    opt0 = copy.deepcopy(tr.opt_state)
    with flags(enable_resident_feed=1):
        tr.train_pass(ds)  # warm-up epoch
        losses = []
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        out = tr.train_pass(ds, n_batches=ZOO_TIMED_EPOCHS * ds.num_batches(),
                            on_batch=lambda i, m: losses.append(m["loss"]))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = dict(ck.launch_counts)
    n = len(losses)
    adt.finalize()
    n_upd = adt.n_updates
    check_path("async dense, free-running (packer feed)", out, torch.stack(losses).cpu(), counts, n)
    untouched = int(tr.opt_state.count) == int(opt0.count) and all(
        torch.equal(tr.opt_state.mu[k], opt0.mu[k]) and torch.equal(tr.opt_state.nu[k], opt0.nu[k]) for k in opt0.mu
    )
    if tr.last_feed != "packer" or not n_upd or not untouched:
        raise AssertionError(f"free-running async: feed {tr.last_feed}, {n_upd} updates, opt_state untouched "
                             f"{untouched}")
    nums = {"deterministic": det, "samples_per_s": BATCH * n / secs, "ms_per_step": secs / n * 1e3,
            "steps": n, "updates": n_upd}
    print(f"async dense, free-running (full width, packer feed): {n} steps {nums['samples_per_s']:.1f} samples/s, "
          f"{n_upd} updates over both epochs and the warm-up's {ds.num_batches()} pushes, opt_state untouched; "
          f"{card}", flush=True)
    return nums, counts


def dump_phase(args, lay, sparse_opt, ds, ck, card, tmp):
    """One WideDeep packer pass with a DumpWorkerPool (mode 0) and
    dump_params_at_end against the same pass without: lines, preds under
    ``.6g``, one param line a leaf under the JAX names, the overhead."""
    from paddlebox_tpu_torch.models.convert import jax_named_leaves
    from paddlebox_tpu_torch.utils.dump import DumpWorkerPool

    cfg = zoo_cfg("wide_deep", lay, sparse_opt, BATCH)
    n_b = ds.num_batches()
    secs = {}
    with flags(enable_resident_feed=0):
        tr = zoo_trainer("wide_deep", lay, cfg, args.seed)
        tr.train_pass(ds)  # warm-up epoch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_pass(ds)
        torch.cuda.synchronize()
        secs["plain_s"] = time.perf_counter() - t0
        pool = DumpWorkerPool(os.path.join(tmp, "dump"), n_threads=1)
        tr.dump_pool, tr.dump_params_at_end = pool, True
        preds = []
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        tr.train_pass(ds, on_batch=lambda i, m: preds.append(m["preds"].cpu()))
        pool.finalize()
        torch.cuda.synchronize()
        secs["dump_s"] = time.perf_counter() - t0
    counts = dict(ck.launch_counts)
    with open(os.path.join(tmp, "dump", "part-00000")) as f:
        lines = f.read().splitlines()
    field = [ln for ln in lines if "\tpreds:" in ln]
    params = [ln.split("\t", 1)[0] for ln in lines if "\tpreds:" not in ln]
    want = [f"{v:.6g}" for v in torch.cat(preds).tolist()]
    got = [ln.split("\tpreds:", 1)[1].split("\t", 1)[0] for ln in field]
    names = [name for name, _ in jax_named_leaves(tr.params)]
    if len(field) != n_b * BATCH or got != want:
        raise AssertionError(f"dump: {len(field)} field lines (want {n_b} x {BATCH}) or preds unlike the steps'")
    if params != names:
        raise AssertionError(f"dump: param lines {params}, want one a leaf {names}")
    if counts != want_launches(2 * n_b, n_b):
        raise AssertionError(f"dump pass launches {counts} for {n_b} steps")
    nums = {**secs, "overhead_s": secs["dump_s"] - secs["plain_s"], "field_lines": len(field),
            "param_lines": len(params), "bytes": os.path.getsize(os.path.join(tmp, "dump", "part-00000"))}
    print(f"dump (mode 0, one writer, packer feed, {n_b} steps): {len(field)} lines = steps x batch, every pred "
          f"its step's under .6g, {len(params)} param lines {params}; the pass {secs['dump_s']:.3f} s against "
          f"{secs['plain_s']:.3f} s without: overhead {nums['overhead_s']:.3f} s; {card}", flush=True)
    return nums, counts


def box_phase(args, lay, sparse_opt, files, ck, dev, card, tmp):
    """A day through the façade: BoxWrapper(embedx_dim=16) on the card, its
    dataset and metric, a trainer with ``box=``, a training pass, an eval
    pass under ``box.set_test_mode()`` (state bitwise), end_pass, save_base
    and load_model into a second wrapper (rows bitwise), save_cache_model."""
    from paddlebox_tpu_torch import BoxWrapper

    box = BoxWrapper(embedx_dim=EMBEDX_DIM, sparse_opt=sparse_opt, n_host_shards=64, seed=args.seed, device=dev)
    ds = box.make_dataset(zoo_schema(NUM_SLOTS, ZOO_DENSE_DIM), batch_size=BATCH, shuffle_mode="local",
                          seed=args.seed)
    ds.set_date(PUB_DATE)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=512)
    box.init_metric("auc", phase=1)
    cfg = zoo_cfg("wide_deep", lay, sparse_opt, BATCH)
    tr = zoo_trainer("wide_deep", lay, cfg, args.seed, box=box, metric_registry=box.metrics)
    n_b, n_rec = ds.num_batches(), ds.memory_data_size()
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    out = tr.train_pass(ds)
    trained = device_state(tr)
    box.set_test_mode()
    eout = tr.train_pass(ds)
    box.set_test_mode(False)
    torch.cuda.synchronize()
    counts = dict(ck.launch_counts)
    if not same_device_state(device_state(tr), trained) or int(tr.opt_state.count) != n_b:
        raise AssertionError("façade: the eval pass under box.set_test_mode() changed the state")
    if counts != want_launches(3 * n_b, n_b) or tr.last_feed != "resident":
        raise AssertionError(f"façade: launches {counts} for {n_b} training and {n_b} eval steps, feed {tr.last_feed}")
    metric = box.get_metric("auc")  # reads and resets
    if metric["ins_num"] != 2 * n_rec or not (np.isfinite(out["loss"]) and np.isfinite(eout["loss"])):
        raise AssertionError(f"façade: the metric counted {metric['ins_num']}, not both passes' {2 * n_rec}")
    line = f"auc {metric['auc']:.6f} over {metric['ins_num']} instances (the training and the eval pass)"
    ds.end_pass(tr.trained_table())
    root = os.path.join(tmp, "box_ckpt")
    t0 = time.perf_counter()
    box.save_base(root, PUB_DATE, tr)
    save_s = time.perf_counter() - t0
    box2 = BoxWrapper(embedx_dim=EMBEDX_DIM, sparse_opt=sparse_opt, n_host_shards=64, seed=args.seed, device=dev)
    t0 = time.perf_counter()
    got = box2.load_model(root)
    load_s = time.perf_counter() - t0
    keys = np.sort(box.table.keys())
    if got["date"] != PUB_DATE or not np.array_equal(np.sort(box2.table.keys()), keys) or \
            box2.table.pull_or_create(keys).tobytes() != box.table.pull_or_create(keys).tobytes():
        raise AssertionError("façade: the loaded base differs from the saved table")
    n_cache = box.save_cache_model(root, PUB_DATE, 0.1)
    if not 0 < n_cache <= len(keys):
        raise AssertionError(f"façade: save_cache_model wrote {n_cache} of {len(keys)} keys")
    nums = {"keys": len(keys), "save_base_s": save_s, "load_model_s": load_s, "cache_keys": n_cache,
            "metric": line}
    print(f"façade: BoxWrapper day over {len(files)} files ({n_rec} records, {len(keys)} keys): a training and "
          f"an eval pass under set_test_mode (state bitwise, launches {counts}), save_base {save_s:.3f} s, "
          f"load_model into a second wrapper {load_s:.3f} s (rows bitwise), save_cache_model {n_cache} keys; "
          f"{line}; {card}", flush=True)
    return nums, counts


def dcn_gather(args, lay, sparse_opt, ds, ck, dev, card):
    """``pull_rows_cuda`` at DCN's training shape (the unique rows of a
    108-slot batch) against its plain version, ``index_select``, the byte
    bound and the sector floor; both kernels held bitwise there."""
    from paddlebox_tpu_torch.train import ResidentPass, build_device_batch

    cfg = zoo_cfg("dcn", lay, sparse_opt, BATCH)
    rp = ResidentPass(ds.store, ds.ws, ds.schema, dev)
    idx = np.asarray(next(iter(ds.batch_indices(1))), dtype=np.int32)
    rp.ensure([idx])
    rows = build_device_batch(rp, cfg, torch.from_numpy(idx).to(dev))["uniq_rows"]
    tab = torch.from_numpy(np.ascontiguousarray(np.asarray(ds.device_table).reshape(-1, lay.width))).to(dev)
    R, W = tab.shape
    U = rows.shape[0]
    what = f"DCN path R={R} W={W} U={U} int32"
    errs = [check_gather(ck, tab, rows, what), check_write(ck, tab, rows, ck.pull_rows_ref(tab, rows) + 0.5, what)]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cold, warm = time_fns({
        "kernel": lambda: ck.pull_rows_cuda(tab, rows),
        "plain": lambda: ck.pull_rows_ref(tab, rows),
        "library": lambda: torch.index_select(tab, 0, rows),
    }, flush)
    bound_ms = (2 * U * W * 4 + 4 * U) / HBM_BYTES_PER_S * 1e3
    nums = {
        "R": R, "W": W, "U": U, "n_uniq": int((rows != rp.pad_row).sum()), "ms": cold["kernel"],
        "plain_ms": cold["plain"], "library_ms": cold["library"], "bound_ms": bound_ms,
        "bound_share": bound_ms / cold["kernel"], "sector_floor_ms": sector_floor_ms(rows, R, W, False),
        "warm_l2_ms": warm["kernel"], "warm_l2_plain_ms": warm["plain"], "warm_l2_library_ms": warm["library"],
    }
    emit({"card": card, "kernel": "pull_rows_cuda", "path": "zoo_dcn", "reps": TIMING_REPS, "l2": "cold", **nums})
    return nums, max(errs)


def zoo_phase(args, dev, card, ck, lay):
    """Phase 11: the zoo's four models at their default widths on the
    resident feed, async dense, dumps and the façade. Returns the launch
    counts by path, the gather's numbers at DCN's shape and the kernels'
    max abs error there."""
    from paddlebox_tpu_torch.table import SparseOptimizerConfig

    t_phase = time.perf_counter()
    sparse_opt = SparseOptimizerConfig(embedx_threshold=0.0)
    rng = np.random.default_rng(args.seed + 7)
    counts, nums = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as tmp:
        t0 = time.perf_counter()
        files, _ = write_bench_files(tmp, rng, ZOO_FILES, "zoo", dense_dim=ZOO_DENSE_DIM)
        dcn_files, _ = write_bench_files(tmp, rng, ZOO_FILES, "dcn", n_slots=DCN_SLOTS)
        small, _ = write_bench_files(tmp, rng, ZOO_SMALL_FILES, "zoosmall", dense_dim=ZOO_DENSE_DIM)
        small_dcn, _ = write_bench_files(tmp, rng, ZOO_SMALL_FILES, "dcnsmall", n_slots=DCN_SLOTS)
        nums["data_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        schema, dcn_schema = zoo_schema(NUM_SLOTS, ZOO_DENSE_DIM), zoo_schema(DCN_SLOTS, 0)
        ds, _ = zoo_pass(args, lay, sparse_opt, files, schema, BATCH)
        dcn_ds, _ = zoo_pass(args, lay, sparse_opt, dcn_files, dcn_schema, BATCH)
        small_ds, _ = zoo_pass(args, lay, sparse_opt, small, schema, ZOO_SMALL_BATCH, n_shards=8)
        small_dcn_ds, _ = zoo_pass(args, lay, sparse_opt, small_dcn, dcn_schema, ZOO_SMALL_BATCH, n_shards=8)
        nums["load_s"] = time.perf_counter() - t0
        zoo_counts = []
        for name in ZOO_NAMES:
            d, sd = (dcn_ds, small_dcn_ds) if name == "dcn" else (ds, small_ds)
            nums[name], c = zoo_model_run(args, name, lay, sparse_opt, d, sd, ck, dev, card)
            zoo_counts.append(c)
        counts["zoo"] = {k: sum(c[k] for c in zoo_counts) for k in zoo_counts[0]}
        nums["async"], counts["async"] = async_phase(args, lay, sparse_opt, ds, small_ds, ck, dev, card)
        nums["dump"], counts["dump"] = dump_phase(args, lay, sparse_opt, ds, ck, card, tmp)
        nums["box"], counts["box"] = box_phase(args, lay, sparse_opt, files[:ZOO_BOX_FILES], ck, dev, card, tmp)
        gather, err = dcn_gather(args, lay, sparse_opt, dcn_ds, ck, dev, card)
    nums["phase_s"] = time.perf_counter() - t_phase
    emit({"card": card, "phase": "zoo", "records_per_pass": RECORDS_PER_FILE * ZOO_FILES, "batch": BATCH, **nums,
          "dcn_gather": gather})
    print(f"phase 11 (zoo) in {nums['phase_s']:.3f} s; {card}", flush=True)
    return counts, gather, err


# ---- 12. the mesh ----------------------------------------------------------

MESH_NCCL_MAX = 4  # ranks of the NCCL world: one a card, at most this many
MESH_GLOO_RANKS = 2  # the gloo world's ranks, all on cuda:0
MESH_WARM = 8
MESH_TIMED = 32
MESH_PACKER = 8
MESH_FEED_STEPS = 4
MESH_WIRES = ("fp32", "bf16", "int8", "adaptive")
MESH_TIMEOUT_S = 300.0
MESH_KEY_STRIDE = 16  # every 16th unique key of the 4-step batches is compared across runs
MESH_LOSS_RTOL_FIRST, MESH_LOSS_RTOL = 1e-5, 6e-3  # tests/test_sharded.py's mesh-vs-one-device bounds
MESH_TABLE_RTOL, MESH_TABLE_ATOL = 2e-3, 1e-3
MESH_PARAMS_ATOL = 2e-4  # ZeRO-1 against step mode, tests/test_torch_train_step.py's bound
KSTEP_TIMED = 16  # resident steps of kstep with and without check_nan


def bench_schema():
    from paddlebox_tpu_torch.data import SlotInfo, SlotSchema

    return SlotSchema([SlotInfo("label", type="float", dense=True, dim=1)] + [SlotInfo(f"s{i}") for i in range(NUM_SLOTS)],
                      label_slot="label")


class _CollectiveMeter:
    """Host seconds in the plan's collectives and the bytes each rank's
    ``all_to_all`` sends, split into the int32 request buckets and the
    value payloads (patched onto ``MeshPlan`` in a rank's process only)."""

    def __init__(self):
        from paddlebox_tpu_torch.parallel import mesh

        self.reset()
        for name in ("all_to_all", "all_reduce", "all_gather"):
            orig = getattr(mesh.MeshPlan, name)

            def timed(plan, x, *a, _orig=orig, _name=name, **kw):
                t0 = time.perf_counter()
                out = _orig(plan, x, *a, **kw)
                self.secs += time.perf_counter() - t0
                if _name == "all_to_all":
                    key = "req_bytes" if x.dtype == torch.int32 else "value_bytes"
                    setattr(self, key, getattr(self, key) + x.numel() * x.element_size())
                return out

            setattr(mesh.MeshPlan, name, timed)

    def reset(self):
        self.secs, self.req_bytes, self.value_bytes = 0.0, 0, 0


def _mesh_key_rows(tr, ds, n_steps):
    """(keys, rows) of every MESH_KEY_STRIDE-th unique key of the first
    ``n_steps`` batches, from the trainer's whole trained table."""
    from paddlebox_tpu_torch.data.record_store import _ragged_indices

    counts = ds.store.key_counts()
    idx = np.concatenate(list(ds.batch_indices(n_steps)))
    keys = np.unique(ds.store.u64_values[_ragged_indices(ds.store.u64_base[idx], counts[idx])])[::MESH_KEY_STRIDE]
    table = tr.trained_table()
    rows = table.reshape(-1, table.shape[-1])[ds.ws.row_of_sorted[np.searchsorted(ds.ws.sorted_keys, keys)]]
    return keys, rows


def _mesh_tag(backend, ranks_per_card) -> str:
    """What every line of a mesh world names: its backend and ranks a card."""
    return json.dumps({"backend": backend, "ranks_per_card": ranks_per_card})


def _stderr_syncs(fn):
    """(``fn``'s result, the "synchronizing CUDA operation" warnings written
    to the process's stderr while it ran): the syncs that torch's sync
    debug mode reports from threads without Python, such as gloo's."""
    import tempfile as _tf

    sys.stderr.flush()
    saved = os.dup(2)
    with _tf.TemporaryFile(mode="w+b") as f:
        os.dup2(f.fileno(), 2)
        try:
            out = fn()
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
        f.seek(0)
        text = f.read().decode(errors="replace")
    sys.stderr.write(text)
    return out, text.count("synchronizing CUDA operation")


def mesh_rank(plan, spec):
    """Phase 12 on one rank of a world (spawned by ``fleet.launch.spawn``):
    load bench.py's data into this rank's replica, train on the mesh, check
    what a rank can check alone, write the rest to ``spec["out"]``. One
    trainer serves every run of step mode, its state reset between runs
    (its resident pass and packer are built once)."""
    import dataclasses
    import hashlib

    from paddlebox_tpu_torch.data import BoxPSDataset
    from paddlebox_tpu_torch.fleet import Zero1Optimizer
    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.ops import cuda_kernels as ck
    from paddlebox_tpu_torch.ops import pull_push
    from paddlebox_tpu_torch.ops import wire_quant as wq
    from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
    from paddlebox_tpu_torch.train import Adam, AdamState, CTRTrainer, TrainStepConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, r, dev = plan.world, plan.rank, plan.device
    tag = _mesh_tag(plan.backend, spec["ranks_per_card"])
    meter = _CollectiveMeter()
    lay = ValueLayout(embedx_dim=EMBEDX_DIM)
    sparse_opt = SparseOptimizerConfig(embedx_threshold=0.0)
    cfg = TrainStepConfig(num_slots=NUM_SLOTS, batch_size=BATCH // n, layout=lay, sparse_opt=sparse_opt,
                          auc_buckets=100_000)
    res = {"rank": r, "world": n, "backend": plan.backend, "device": str(dev), "ranks_per_card": spec["ranks_per_card"]}
    table = HostSparseTable(lay, sparse_opt, n_shards=64, seed=spec["seed"])
    ds = BoxPSDataset(bench_schema(), table, batch_size=BATCH, shuffle_mode="local", seed=spec["seed"], n_mesh_shards=n)
    ds.set_filelist(spec["files"])
    t0 = time.perf_counter()
    ds.load_into_memory()
    res["load_into_memory_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds.begin_pass(round_to=512)
    res["begin_pass_s"] = time.perf_counter() - t0
    res["cap"], res["n_keys"] = ds.ws.capacity, ds.ws.n_keys

    def trainer(dense_opt=None, cfg_=cfg):
        model = DeepFM(NUM_SLOTS, lay.pull_width, lay.embedx_dim, hidden=HIDDEN,
                       generator=torch.Generator().manual_seed(spec["seed"]))
        t = CTRTrainer(model, cfg_, dense_opt=dense_opt or Adam(1e-3), plan=plan)
        t.init_params()
        return t

    tr = trainer()
    p0 = {k: v.clone() for k, v in tr.params.items()}
    o0 = tr.opt_state

    def reset(t):
        """The next train_pass starts from the pass-open table and p0."""
        t._state = t._state_ws = None
        t.params = {k: v.clone() for k, v in p0.items()}
        t.opt_state = AdamState(o0.count.clone(), {k: v.clone() for k, v in o0.mu.items()},
                                {k: v.clone() for k, v in o0.nu.items()})

    def steps(t, data, k, **kw):
        losses = []
        out = t.train_pass(data, n_batches=k, on_batch=lambda i, m: losses.append(m["loss"]), **kw)
        return out, torch.stack(losses).cpu()

    def counted(name, fn, k):
        torch.cuda.synchronize(dev)
        ck.reset_launch_counts()
        meter.reset()
        t0 = time.perf_counter()
        out, losses = fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counts = dict(ck.launch_counts)
        if counts["pull_rows_cuda"] != 2 * k or counts["write_rows_cuda"] != k:
            raise AssertionError(f"mesh {tag} rank {r} {name}: launches {counts} for {k} steps")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"mesh {tag} rank {r} {name}: non-finite loss {losses.tolist()}")
        return out, losses, wall, counts

    def feed_is(want):
        if tr.last_feed != want:
            raise AssertionError(f"mesh {tag}: the trainer took the {tr.last_feed} feed, not {want}")

    # the main path: prepare_pass, a warm-up, the timed resident pass
    tr.prepare_pass(ds, n_batches=MESH_WARM + MESH_TIMED)
    res["prepare_pass_s"] = tr.last_prepare_s
    tr.train_pass(ds, n_batches=MESH_WARM)
    out, losses, wall, c_res = counted("resident", lambda: steps(tr, ds, MESH_TIMED), MESH_TIMED)
    feed_is("resident")
    res.update(resident_wall_s=wall, resident_coll_s=meter.secs, resident_loss=out["loss"], auc=out["auc"])
    # every rank steps (the collectives need all); rank 0's numbers are printed
    res["busy_ms_per_step"] = busy_ms_per_step(lambda: tr.train_pass(ds, n_batches=RESIDENT_K), RESIDENT_K)
    res["resident_profile_ms"] = {k: v / RESIDENT_K * 1e3 for k, v in tr.train_pass(
        ds, n_batches=RESIDENT_K, profile=True)["profile"].items()}

    # the host syncs of one resident mesh superstep: the sync debug mode's
    # warnings from Python and those written by threads without it
    rp = tr._resident_cache[2]
    sstep = tr._resident_superstep(rp, False)
    idx_dev = tr._idx_cache[2][:RESIDENT_K]
    plan.reset_calls()
    state = tr._state
    holder = {}

    def run():
        holder["st"] = sstep(state, idx_dev)[0]

    (n_syncs, sites), n_thread = _stderr_syncs(lambda: host_syncs(run))
    tr._state = holder["st"]
    res.update(superstep_host_syncs=n_syncs + n_thread, superstep_sync_sites=sites,
               superstep_thread_syncs=n_thread, superstep_collectives=dict(plan.calls))

    # the trained table for end_pass, and the owner's three id patterns:
    # the pull's received ids, the merge's old-row ids and its writeback ids
    trained = tr.trained_table()
    shard = tr._state.table
    with flags(enable_resident_feed=0):
        reset(tr)
        first = next(ds.batch_indices(1))
        packer = tr._get_packer(ds)
        packer.freeze_shapes([first], n_devices=n)
        db = packer.pack_sharded(first, n)
    recv = torch.from_numpy(np.ascontiguousarray(db.req_ranks[:, r, :].reshape(-1))).to(dev)
    uniq = torch.unique(recv)  # sorted: the merge's runs, one a distinct row
    tail = recv.numel() - uniq.numel()
    owner = {
        "pull": recv,
        "merge_old": torch.cat([uniq, torch.zeros(tail, dtype=uniq.dtype, device=dev)]),
        "merge_write": torch.cat([uniq.long(), torch.full((tail,), shard.shape[0], dtype=torch.long, device=dev)]),
    }
    what = (f"mesh {tag} rank {r} owner R={shard.shape[0]} "
            f"U={recv.numel()} ({uniq.numel()} distinct)")
    kerr = max(check_gather(ck, shard, owner["pull"], what + " pull ids"),
               check_gather(ck, shard, owner["merge_old"], what + " merge old-row ids"),
               check_write(ck, shard, owner["merge_write"], ck.pull_rows_ref(shard, owner["merge_old"]) + 0.5,
                           what + " merge writeback ids"))
    res.update(owner_R=shard.shape[0], kernel_err=kerr)

    # 8 packer steps
    with flags(enable_resident_feed=0):
        reset(tr)
        tr.prepare_pass(ds, n_batches=MESH_PACKER)
        pout, plosses, pwall, c_pack = counted("packer", lambda: steps(tr, ds, MESH_PACKER), MESH_PACKER)
        feed_is("packer")
        meter.reset()
        prof = tr.train_pass(ds, n_batches=MESH_PACKER, profile=True)["profile"]
        res["packer_profile_ms"] = {k: v / MESH_PACKER * 1e3 for k, v in prof.items()}
        res["packer_coll_ms"] = meter.secs / MESH_PACKER * 1e3
        packer = tr._packer_cache[2]
        idx = list(ds.batch_indices(MESH_PACKER))
        t0 = time.perf_counter()
        for b in idx:
            packer.pack_sharded(b, n)
        res["pack_sharded_ms"] = (time.perf_counter() - t0) / len(idx) * 1e3
        K = packer._K_pad
    res.update(counts={"resident": c_res, "packer": c_pack}, packer_wall_s=pwall, K=K)

    # the wire: one packer step in each mode, bytes sent against ici_wire_nbytes
    wires = {}
    for mode in MESH_WIRES:
        with flags(enable_resident_feed=0, ici_wire_dtype=mode):
            reset(tr)
            meter.reset()
            tr.train_pass(ds, n_batches=1)
            hot = wq.ici_hot_slots(K) if mode == "adaptive" else 0
            want = (wq.ici_wire_nbytes(n, K, lay.pull_width, lay.embed_w_col, 1, mode, hot)
                    + wq.ici_wire_nbytes(n, K, lay.push_width + 2, 2, 1, mode, hot))
            wires[mode] = {"K": K, "value_bytes": meter.value_bytes, "ici_wire_nbytes": want,
                           "req_bytes": meter.req_bytes, "fp32_bytes": n * K * (lay.pull_width + lay.push_width + 2) * 4}
            if meter.value_bytes != want or meter.req_bytes != 2 * n * K * 4:
                raise AssertionError(f"mesh {tag} wire {mode}: sent {meter.value_bytes} value bytes, "
                                     f"ici_wire_nbytes says {want}; req {meter.req_bytes}")
    res["wire"] = wires

    # 4 steps from one state through every flat feed: bitwise alike
    def four(kw, data, want_feed):
        with flags(**kw):
            reset(tr)
            _, ls = steps(tr, data, MESH_FEED_STEPS)
            feed_is(want_feed)
            st = tr._state
            return ({k: v.cpu() for k, v in st.params.items()}, {k: v.cpu() for k, v in st.opt_state.mu.items()},
                    {k: v.cpu() for k, v in st.opt_state.nu.items()}, st.table.cpu(), ls)

    runs = {"packer": four(dict(enable_resident_feed=0), ds, "packer")}
    res["four_keys"], res["four_rows"] = _mesh_key_rows(tr, ds, MESH_FEED_STEPS)
    runs["resident K=4"] = four(dict(resident_scan_batches=4), ds, "resident")
    runs["resident K=1"] = four(dict(resident_scan_batches=1), ds, "resident")
    runs["slow"] = four({}, records_view(ds, MESH_FEED_STEPS), "slow")
    runs["packer twin"] = four(dict(enable_resident_feed=0), ds, "packer")
    saved = pull_push.pull_rows_cuda, pull_push.write_rows_cuda
    pull_push.pull_rows_cuda = ck.pull_rows_ref
    # the owner names its idle runs R: the plain writeback takes them out first
    pull_push.write_rows_cuda = lambda t, i, v: ck.write_rows_ref(t, *ck.drop_out_of_range(t, i, v))
    try:
        runs["packer, plain gather and writeback"] = four(dict(enable_resident_feed=0), ds, "packer")
    finally:
        pull_push.pull_rows_cuda, pull_push.write_rows_cuda = saved
    ref = runs["packer"]
    for name, got in runs.items():
        same = (all(torch.equal(got[i][k], ref[i][k]) for i in (0, 1, 2) for k in ref[i])
                and torch.equal(got[3], ref[3]) and torch.equal(got[4], ref[4]))
        if not same:
            raise AssertionError(f"mesh {tag} rank {r}: {MESH_FEED_STEPS} steps through {name} differ from packer")
    res["feeds_bitwise"] = list(runs)
    res["four_losses"] = ref[4].tolist()

    # kstep and ZeRO-1, 4 steps each
    with flags(enable_resident_feed=0):
        ktr = trainer(cfg_=dataclasses.replace(cfg, dense_sync_mode="kstep", param_sync_step=2))
        _, kl = steps(ktr, ds, MESH_FEED_STEPS)
        ztr = trainer(dense_opt=Zero1Optimizer(Adam(1e-3), n_dev=n))
        _, zl = steps(ztr, ds, MESH_FEED_STEPS)
    for name, ls in (("kstep", kl), ("zero1", zl)):
        if not bool(torch.isfinite(ls).all()):
            raise AssertionError(f"mesh {tag} {name}: non-finite loss {ls.tolist()}")
    zd = max(float((ztr.params[k].cpu() - ref[0][k]).abs().max()) for k in ref[0])
    if zd > MESH_PARAMS_ATOL:
        raise AssertionError(f"mesh {tag} ZeRO-1 params differ from step mode's by {zd} > {MESH_PARAMS_ATOL}")
    res.update(kstep_losses=kl.tolist(), zero_losses=zl.tolist(), zero_vs_step_params_max_abs=zd)

    # the known cost of kstep with check_nan (ROADMAP Queue 3 item 1): its
    # dense average runs every step; ms a step on the resident feed (the
    # resident pass shared) against kstep alone, and the pass's all-reduces
    kms = {}
    for name, extra in (("kstep", {}), ("kstep_check_nan", {"check_nan": True})):
        kt = trainer(cfg_=dataclasses.replace(cfg, dense_sync_mode="kstep", param_sync_step=2, **extra))
        kt._resident_cache = tr._resident_cache
        kt.train_pass(ds, n_batches=RESIDENT_K)  # warm
        torch.cuda.synchronize(dev)
        plan.reset_calls()
        t0 = time.perf_counter()
        kt.train_pass(ds, n_batches=KSTEP_TIMED)
        torch.cuda.synchronize(dev)
        kms[name] = {"ms_per_step": (time.perf_counter() - t0) / KSTEP_TIMED * 1e3, "steps": KSTEP_TIMED,
                     "all_reduce_calls": plan.calls["all_reduce"]}
        del kt
    res["kstep_timing"] = kms

    # end_pass: every rank writes back the same gathered table
    t0 = time.perf_counter()
    ds.end_pass(trained)
    res["end_pass_s"] = time.perf_counter() - t0
    keys = np.sort(table.keys())
    h = hashlib.blake2b(digest_size=16)
    h.update(keys.tobytes())
    h.update(table.pull_or_create(keys).tobytes())
    res["host_digest"], res["host_keys"] = h.hexdigest(), int(len(keys))
    arrays = {k: res.pop(k) for k in ("four_keys", "four_rows")}
    arrays.update({f"owner_{k}": v.cpu().numpy() for k, v in owner.items()})
    np.savez(os.path.join(spec["out"], f"rank{r}.npz"), **arrays)
    with open(os.path.join(spec["out"], f"rank{r}.json"), "w") as f:
        json.dump(res, f)


def _mesh_compare(what, losses, rows, keys, ref_losses, ref_keys, ref_rows):
    """A 4-step trajectory against a reference: losses and the sampled
    table rows (by key) within the mesh-vs-one-device bounds."""
    losses, ref_losses = np.asarray(losses), np.asarray(ref_losses)
    if not np.allclose(losses[0], ref_losses[0], rtol=MESH_LOSS_RTOL_FIRST, atol=0):
        raise AssertionError(f"{what}: step-1 loss {losses[0]} vs {ref_losses[0]}")
    if not np.allclose(losses, ref_losses, rtol=MESH_LOSS_RTOL, atol=0):
        raise AssertionError(f"{what}: losses {losses} vs {ref_losses}")
    pos = np.searchsorted(ref_keys, keys)
    if not np.array_equal(ref_keys[np.minimum(pos, len(ref_keys) - 1)], keys):
        raise AssertionError(f"{what}: the sampled keys differ")
    d = np.abs(rows - ref_rows[pos])
    if not np.all(d <= MESH_TABLE_ATOL + MESH_TABLE_RTOL * np.abs(ref_rows[pos])):
        raise AssertionError(f"{what}: table rows differ by up to {d.max()}")
    return float(d.max()), float(np.max(np.abs(losses - ref_losses) / np.abs(ref_losses)))


def owner_kernel_rows(args, dev, card, ck, lay, r0, path, tag):
    """Both kernels at a mesh owner's ids (rank 0's ``owner_{pattern}``
    arrays, its shard's ``owner_R`` rows), timed here alone, cold and warm,
    beside the plain versions and ``index_select`` / ``index_copy_``: the
    pull's gather of the received ids, the merge's old-row gather (one id a
    distinct row, then row 0) and its writeback (one id a distinct row,
    then R, which writes nothing). Returns {kernel: {pattern: numbers}}."""
    R, W = int(r0["owner_R"]), lay.width
    g = torch.Generator(device=dev).manual_seed(args.seed)
    tab = torch.randn((R, W), device=dev, generator=g)
    pristine = tab.clone()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    kres = {}
    for pattern in ("pull", "merge_old", "merge_write"):
        ids = torch.from_numpy(r0[f"owner_{pattern}"]).to(dev)
        U = ids.numel()
        valid = ids[ids < R]
        distinct = int(torch.unique(valid).numel())
        what = f"{path} {json.dumps(tag)} {pattern} ids U={U} ({distinct} distinct) R={R}"
        if pattern == "merge_write":
            kname = "write_rows_cuda"
            new_rows = torch.randn((U, W), device=dev, generator=g)
            check_write(ck, tab, ids, new_rows, what)
            nv = valid.numel()
            fns = {"kernel": lambda: ck.write_rows_cuda(tab, ids, new_rows),
                   "plain": lambda: ck.write_rows_ref(tab, *ck.drop_out_of_range(tab, ids, new_rows)),
                   "library": lambda: tab.index_copy_(0, valid, new_rows[:nv])}
            restore = lambda: tab.copy_(pristine)
            moved = 2 * nv * W * 4 + U * ids.element_size()
        else:
            kname = "pull_rows_cuda"
            check_gather(ck, tab, ids, what)
            fns = {"kernel": lambda: ck.pull_rows_cuda(tab, ids),
                   "plain": lambda: ck.pull_rows_ref(tab, ids),
                   "library": lambda: torch.index_select(tab, 0, ids)}
            restore = None
            moved = (U + distinct) * W * 4 + U * ids.element_size()
        med, warm = time_fns(fns, flush, restore)
        bound = moved / HBM_BYTES_PER_S * 1e3
        row = {"pattern": pattern, "U": U, "distinct": distinct, "R": R, "ms": med["kernel"],
               "plain_ms": med["plain"], "library_ms": med["library"], "bound_ms": bound, "bytes": moved,
               "sector_floor_ms": sector_floor_ms(ids, R, W, kname == "write_rows_cuda"),
               "warm_l2_ms": warm["kernel"], "warm_l2_plain_ms": warm["plain"],
               "warm_l2_library_ms": warm["library"]}
        kres.setdefault(kname, {})[pattern] = row
        emit({"card": card, "kernel": kname, "path": path, **tag, "W": W, **row,
              "bound_share": bound / med["kernel"], "reps": TIMING_REPS, "l2": "cold"})
    return kres


MESH_WORLDS = (  # name, backend, ranks (None: one a card, at most MESH_NCCL_MAX), device, ranks a card
    ("nccl", "nccl", None, None, 1), ("gloo", "gloo", MESH_GLOO_RANKS, "cuda:0", MESH_GLOO_RANKS),
)
MESH_TAGS = {"nccl": {"backend": "nccl", "ranks_per_card": 1},
             "gloo": {"backend": "gloo", "ranks_per_card": MESH_GLOO_RANKS}}


def mesh_ranks(plan, spec12, spec13, spec18, spec19, spec20):
    """Phases 12 and 13, phase 18's extended mesh, phase 19's pipeline and
    phase 20's sequence parallelism over the world, on one rank of a
    world, in one spawned process (the process, its CUDA context and its
    collectives' set-up are paid once)."""
    mesh_rank(plan, spec12)
    mesh_join_rank(plan, spec13)
    mesh_expand_rank(plan, spec18)
    pipeline_rank(plan, spec19)
    seqpar_rank(plan, spec20)


def _read_ranks(out, world):
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            res = json.load(f)
        res.update({k: v for k, v in np.load(os.path.join(out, f"rank{r}.npz")).items()})
        ranks.append(res)
    return ranks


def mesh_phases(args, dev, card, ck, lay):
    """Phases 12 and 13 in the NCCL world (one rank a card) and the gloo
    world of two ranks on cuda:0, one spawn a world running both phases'
    rank functions, phase 18's extended mesh, phase 19's pipeline and
    phase 20's sequence parallelism. Returns the launch counts by path,
    the kernels' numbers at phase 12's and phase 13's owner shapes, their
    max abs error, phase 18's mesh results, phase 19's worlds and phase
    20's (its worlds and its reference)."""
    from paddlebox_tpu_torch.fleet.launch import spawn

    t_phase = time.perf_counter()
    p20 = seqpar_prepare(args, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        p12 = mesh_prepare(args, dev, lay, tmp)
        p13 = mesh_join_prepare(args, dev, lay, tmp)
        p18 = mesh_expand_prepare(args, dev, p12["files"][:LT_FILES])
        worlds12, worlds13, worlds18, worlds19, worlds20 = {}, {}, {}, {}, {}
        for name, backend, world, device, per_card in MESH_WORLDS:
            world = world or min(torch.cuda.device_count(), MESH_NCCL_MAX)
            outs = []
            for phase in ("12", "13", "18", "19", "20"):
                outs.append(os.path.join(tmp, f"{name}-{phase}"))
                os.makedirs(outs[-1])
            spec12 = {"files": p12["files"], "seed": args.seed + 8, "out": outs[0], "ranks_per_card": per_card}
            spec13 = {"pv_files": p13["pv_files"], "boundary_files": p13["boundary_files"],
                      "seed": args.seed + MESH_JOIN_SEED, "out": outs[1], "ranks_per_card": per_card}
            spec18 = {"files": p18["files"], "seed": args.seed + LT_SEED, "out": outs[2], "ranks_per_card": per_card}
            spec19 = {"kind": "pp", "seed": args.seed, "out": outs[3]}
            # the NCCL world runs first: its outputs are the ones the others are held against
            spec20 = seqpar_spec(p20, outs[4], write_base=name == "nccl")
            t0 = time.perf_counter()
            spawn(mesh_ranks, world, f"file://{tmp}/rdv-{name}", backend=backend, device=device,
                  args=(spec12, spec13, spec18, spec19, spec20), timeout_s=MESH_TIMEOUT_S)
            wall = time.perf_counter() - t0
            worlds12[name] = (_read_ranks(outs[0], world), wall)
            worlds13[name] = (_read_ranks(outs[1], world), wall)
            worlds18[name] = (_read_ranks(outs[2], world), wall)
            worlds19[name] = (_read_ranks(outs[3], world), wall)
            worlds20[name] = (_read_ranks(outs[4], world), wall)
        counts, owner, err = mesh_report(args, dev, card, ck, lay, worlds12, p12)
        counts13, join_owner, err13 = mesh_join_report(args, dev, card, ck, lay, worlds13, p13)
        mesh18 = mesh_expand_report(card, worlds18, p18)
    print(f"phases 12-13 (mesh) in {time.perf_counter() - t_phase:.3f} s; {card}", flush=True)
    return {**counts, **counts13}, owner, join_owner, max(err, err13), mesh18, worlds19, (worlds20, p20)


def mesh_prepare(args, dev, lay, tmp):
    """Phase 12's data (bench.py's, from ``--seed + 8``) and its one-device
    reference: the same 4 steps' losses and sampled rows."""
    from paddlebox_tpu_torch.data import BoxPSDataset
    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig
    from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig

    sparse_opt = SparseOptimizerConfig(embedx_threshold=0.0)
    files, _ = write_bench_files(tmp, np.random.default_rng(args.seed + 8), N_FILES, "mesh")
    # the one-device trajectory of the same 4 steps, the mesh's reference
    table = HostSparseTable(lay, sparse_opt, n_shards=64, seed=args.seed + 8)
    ds = BoxPSDataset(bench_schema(), table, batch_size=BATCH, shuffle_mode="local", seed=args.seed + 8)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=512)
    with flags(enable_resident_feed=0):
        model = DeepFM(NUM_SLOTS, lay.pull_width, lay.embedx_dim, hidden=HIDDEN,
                       generator=torch.Generator().manual_seed(args.seed + 8))
        one = CTRTrainer(model, TrainStepConfig(num_slots=NUM_SLOTS, batch_size=BATCH, layout=lay,
                                                sparse_opt=sparse_opt, auc_buckets=100_000),
                         dense_opt=Adam(1e-3), device=dev)
        one.init_params()
        losses = []
        one.train_pass(ds, n_batches=MESH_FEED_STEPS, on_batch=lambda i, m: losses.append(float(m["loss"])))
    ref_keys, ref_rows = _mesh_key_rows(one, ds, MESH_FEED_STEPS)
    del one, ds, table
    torch.cuda.empty_cache()
    return {"files": files, "ref": (losses, ref_keys, ref_rows)}


def mesh_report(args, dev, card, ck, lay, worlds, prep):
    """Phase 12's checks across each world's ranks and against the
    one-device reference, its lines, and both kernels at each world's
    owner shape. Returns (launch counts by path, owner numbers, max abs
    error)."""
    t_phase = time.perf_counter()
    ref_losses, ref_keys, ref_rows = prep["ref"]
    counts, tag = {}, MESH_TAGS
    for name, (ranks, wall) in worlds.items():
        world = len(ranks)
        r0 = ranks[0]
        if len({r["host_digest"] for r in ranks}) != 1:
            raise AssertionError(f"mesh {_mesh_tag(**tag[name])}: the ranks' host tables differ after end_pass")
        for r in ranks:
            if r["four_losses"] != r0["four_losses"]:
                raise AssertionError(f"mesh {_mesh_tag(**tag[name])}: the ranks' losses differ")
        rows = np.concatenate([r["four_rows"] for r in ranks])
        keys = np.concatenate([r["four_keys"] for r in ranks])
        keys, first = np.unique(keys, return_index=True)
        tab_d, loss_d = _mesh_compare(f"mesh {_mesh_tag(**tag[name])} vs one device", r0["four_losses"], rows[first], keys,
                                      ref_losses, ref_keys, ref_rows)
        if name == "nccl" and r0["superstep_host_syncs"] != 0:
            raise AssertionError(f"mesh nccl: a resident superstep made {r0['superstep_host_syncs']} host syncs: "
                                 f"{r0['superstep_sync_sites']}")
        counts[f"mesh_{name}"] = {k: sum(r["counts"][p][k] for r in ranks for p in r["counts"])
                                  for k in KERNEL_NAMES}
        step_ms = r0["resident_wall_s"] / MESH_TIMED * 1e3
        emit({
            "card": card, "phase": "mesh", **tag[name], "world": world, "spawn_wall_s": wall,
            "samples_per_s_all": BATCH * MESH_TIMED / max(r["resident_wall_s"] for r in ranks),
            "samples_per_s_rank": BATCH * MESH_TIMED / max(r["resident_wall_s"] for r in ranks) / world,
            "ms_per_step": step_ms, "device_busy_ms_per_step_rank0": r0["busy_ms_per_step"],
            "device_idle_share_rank0": 1.0 - r0["busy_ms_per_step"] / step_ms,
            "resident_collective_host_ms_per_step": r0["resident_coll_s"] / MESH_TIMED * 1e3,
            "resident_host_clock_ms_per_step_rank0": r0["resident_profile_ms"],
            "packer_host_clock_ms_per_step_rank0": r0["packer_profile_ms"],
            "pack_sharded_ms_per_global_batch": r0["pack_sharded_ms"],
            "packer_collective_host_ms_per_step": r0["packer_coll_ms"],
            "packer_samples_per_s_all": BATCH * MESH_PACKER / r0["packer_wall_s"],
            "load_into_memory_s": r0["load_into_memory_s"], "begin_pass_s": r0["begin_pass_s"],
            "prepare_pass_s": r0["prepare_pass_s"], "end_pass_s": r0["end_pass_s"],
            "K": r0["K"], "cap": r0["cap"], "n_keys": r0["n_keys"],
            "wire_bytes_per_step_rank0": r0["wire"],
            "superstep_host_syncs": r0["superstep_host_syncs"], "superstep_sync_sites": r0["superstep_sync_sites"],
            "superstep_collectives": r0["superstep_collectives"],
            "vs_one_device": {"table_max_abs": tab_d, "loss_max_rel": loss_d},
            "zero_vs_step_params_max_abs": max(r["zero_vs_step_params_max_abs"] for r in ranks),
            "kstep_losses": r0["kstep_losses"], "zero_losses": r0["zero_losses"],
            "kstep_timing_rank0": r0["kstep_timing"],
            "launches": counts[f"mesh_{name}"], "host_digest": r0["host_digest"],
        })
        print(f"mesh {_mesh_tag(**tag[name])} world {world}: launches 2 gathers and 1 writeback a step on every rank, losses finite, feeds "
              f"{', '.join(r0['feeds_bitwise'])} bitwise alike, the host tables of all ranks alike, within bounds "
              f"of one device (table {tab_d:.3g}, loss rel {loss_d:.3g}); {card}", flush=True)
    g_ranks, n_ranks = worlds["gloo"][0], worlds["nccl"][0]
    gk = np.unique(np.concatenate([r["four_keys"] for r in g_ranks]), return_index=True)
    nk = np.unique(np.concatenate([r["four_keys"] for r in n_ranks]), return_index=True)
    _mesh_compare("mesh gloo vs nccl", g_ranks[0]["four_losses"],
                  np.concatenate([r["four_rows"] for r in g_ranks])[gk[1]], gk[0],
                  n_ranks[0]["four_losses"], nk[0], np.concatenate([r["four_rows"] for r in n_ranks])[nk[1]])
    print(f"mesh {_mesh_tag(**tag['gloo'])}: the gloo world's 4 steps match the nccl world's within the mesh "
          "bounds", flush=True)

    # both kernels at each world's owner shapes, timed here alone
    owner = {name: owner_kernel_rows(args, dev, card, ck, lay, ranks[0], f"mesh_{name}_owner", tag[name])
             for name, (ranks, _) in worlds.items()}
    err = max(r["kernel_err"] for ranks, _ in worlds.values() for r in ranks)
    print(f"phase 12 (mesh): its checks and kernel timings in {time.perf_counter() - t_phase:.3f} s, its ranks in "
          f"the worlds' spawns (spawn_wall_s); {card}", flush=True)
    return counts, owner, err


# ---- 13. the join day, the trainer's options and the carried boundary on the mesh

MESH_JOIN_SEED = 9  # the pv data's seed offset (phase 10 took 6, phase 12 8)
MESH_BOUNDARY_FILES = 2  # bench.py's data a pass, the second reusing the first's keys
MESH_BOUNDARY_STEPS = 8
MESH_OPTION_STEPS = 4  # async twins and the dump


def _digest(*arrays) -> str:
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _registry_digest(reg) -> str:
    """The bucket tables of every metric of a registry, hashed."""
    return _digest(*[t.cpu().numpy() for name in reg.names() for t in (reg[name].state.pos, reg[name].state.neg)])


def _host_digest(table) -> str:
    keys = np.sort(table.keys())
    return _digest(keys, table.pull_or_create(keys))


def _pv_sample_keys(store, idx):
    """Every MESH_KEY_STRIDE-th unique key of the records ``idx``."""
    from paddlebox_tpu_torch.data.record_store import _ragged_indices

    counts = store.key_counts()
    return np.unique(store.u64_values[_ragged_indices(store.u64_base[idx], counts[idx])])[::MESH_KEY_STRIDE]


def globalize_pv_plan(plan):
    """A PvPlan blocked for ``plan.n_devices`` devices as one device's: the
    same global batches, each block's peer rows moved by its offset, so one
    device trains what the mesh trains."""
    from paddlebox_tpu_torch.data.pv_instance import PvPlan

    n_b, B = plan.idx.shape
    b = B // plan.n_devices
    ro = plan.rank_offset.copy()
    off = (np.arange(B) // b * b).astype(np.int32)[None, :, None]
    peers = ro[:, :, 2::2]
    ro[:, :, 2::2] = np.where(peers >= 0, peers + off, peers)
    return PvPlan(idx=plan.idx, rank_offset=ro, ins_weight=plan.ins_weight, n_devices=1)


def _join_model(seed, lay):
    from paddlebox_tpu_torch.models import DeepFM, RankDeepFM

    g = torch.Generator().manual_seed(seed)
    return RankDeepFM(DeepFM(NUM_SLOTS, lay.pull_width, lay.embedx_dim, hidden=HIDDEN, generator=g),
                      NUM_SLOTS * lay.pull_width, max_rank=MAX_RANK, generator=g)


def mesh_join_rank(plan, spec):
    """Phase 13 on one rank of a world: bench.py's join/update day on the
    mesh (a registry, the eval epoch, the three join feeds, the host syncs
    of a pv superstep), async dense and a dump on the update phase's pass,
    the classic end_pass, then two passes carried and two classic. Writes
    what a rank cannot check alone to ``spec["out"]``."""
    import dataclasses
    from collections import defaultdict

    from paddlebox_tpu_torch.data import BoxPSDataset
    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.ops import cuda_kernels as ck
    from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
    from paddlebox_tpu_torch.train import Adam, AsyncDenseTable, CTRTrainer, TrainStepConfig
    from paddlebox_tpu_torch.utils.dump import DumpWorkerPool

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, r, dev = plan.world, plan.rank, plan.device
    tag = _mesh_tag(plan.backend, spec["ranks_per_card"])
    lay = ValueLayout(embedx_dim=EMBEDX_DIM)
    sparse_opt = SparseOptimizerConfig(embedx_threshold=0.0, shrink_threshold=0.0)
    kw = dict(num_slots=NUM_SLOTS, batch_size=BATCH // n, layout=lay, sparse_opt=sparse_opt, auc_buckets=100_000)
    join_cfg, upd_cfg = TrainStepConfig(**kw, model_takes_rank_offset=True), TrainStepConfig(**kw)
    res = {"rank": r, "world": n, "backend": plan.backend}
    arrays = {}
    sections, t_sec = {}, [time.perf_counter()]

    def sync():
        torch.cuda.synchronize(dev)

    def section(name):
        """Wall seconds since the previous section ended, under ``name``."""
        now = time.perf_counter()
        sections[name] = now - t_sec[0]
        t_sec[0] = now

    def fail(msg):
        raise AssertionError(f"mesh join {tag} rank {r}: {msg}")

    t0 = time.perf_counter()
    table = HostSparseTable(lay, sparse_opt, n_shards=64, seed=spec["seed"])
    ds = BoxPSDataset(pv_schema(), table, batch_size=BATCH, shuffle_mode="local", seed=spec["seed"],
                      n_mesh_shards=n)
    ds.set_filelist(spec["pv_files"])
    ds.load_into_memory()
    ds.begin_pass(round_to=512)
    ds.set_current_phase(1)
    n_pvs = ds.preprocess_instance(max_rank=MAX_RANK)
    pvp = ds.pv_plan(n)
    n_rec, n_b = ds.memory_data_size(), pvp.n_batches
    res.update(setup_s=time.perf_counter() - t0, records=n_rec, pvs=n_pvs, pv_batches=n_b, keys=ds.ws.n_keys)
    section("setup")

    def join_trainer(registry=None, share=None):
        """A join trainer from the seed's weights; with ``share`` it takes
        that trainer's resident pass and pv plan on the card (no second
        upload)."""
        t = CTRTrainer(_join_model(spec["seed"], lay), join_cfg, dense_opt=Adam(1e-3), plan=plan,
                       metric_registry=registry)
        t.init_params()
        if share is not None:
            t._resident_cache, t._pv_feed_cache = share._resident_cache, share._pv_feed_cache
        return t

    # ---- the main path: prepare, a warm-up epoch, two timed epochs and an
    # eval epoch with a registry, launch counts from 0
    reg = join_registry(dev)
    jtr = join_trainer(reg)
    sync()
    ck.reset_launch_counts()
    jtr.prepare_pass(ds)
    outs, feeds = [], []
    t0 = time.perf_counter()
    outs.append(jtr.train_pass(ds))
    feeds.append(jtr.last_feed)
    sync()
    t1 = time.perf_counter()
    for _ in range(JOIN_TIMED_EPOCHS):
        outs.append(jtr.train_pass(ds))
        feeds.append(jtr.last_feed)
    sync()
    t2 = time.perf_counter()
    trained = device_state(jtr)
    jtr.set_test_mode(True)
    outs.append(jtr.train_pass(ds))
    feeds.append(jtr.last_feed)
    jtr.set_test_mode(False)
    sync()
    counts = {"join": dict(ck.launch_counts)}
    if feeds != ["resident_pv"] * len(feeds):
        fail(f"the join epochs took the feeds {feeds}")
    for i, o in enumerate(outs):
        if o["batches"] != n_b or o["ins_num"] != n_rec or not np.isfinite(o["loss"]):
            fail(f"join epoch {i}: {o['batches']} batches (want {n_b}), ins_num {o['ins_num']} (want {n_rec}), "
                 f"loss {o['loss']}")
    n_train = (1 + JOIN_TIMED_EPOCHS) * n_b
    want = want_launches(2 * n_train + n_b, n_train)
    if counts["join"] != want:
        fail(f"launches {counts['join']}, want {want}")
    if not same_device_state(device_state(jtr), trained):
        fail("the eval epoch changed the table shard, params or Adam state")
    if counted(reg, "join_auc") != 4 * n_rec or counted(reg, "update_auc") != 0:
        fail(f"registry after the join phase: join {counted(reg, 'join_auc')} (want 4 x {n_rec}), "
             f"update {counted(reg, 'update_auc')}")
    res.update(join_prepare_s=jtr.last_prepare_s, join_warm_up_s=t1 - t0, join_train_s=t2 - t1,
               join_losses=[o["loss"] for o in outs], join_registry_digest=_registry_digest(reg),
               join_line=reg.get_metric_msg("join_auc"))
    section("join_epochs")

    # the host syncs of one resident pv superstep through the trainer's
    # stepper and registry feed (the registry all-gathers each batch)
    holder = {"state": jtr._state}

    def superstep():
        losses: list = []
        for i, m, aux in jtr._resident_stepper(ds, RESIDENT_K, holder, False, False, defaultdict(float), True):
            jtr._consume_batch(i, m, aux, ds, None, losses, [])
        if len(losses) != RESIDENT_K or not aux:
            fail("the probed superstep fed no registry inputs")

    plan.reset_calls()
    (n_syncs, sites), n_thread = _stderr_syncs(lambda: host_syncs(superstep))
    jtr._state = holder["state"]
    res.update(pv_superstep_host_syncs=n_syncs + n_thread, pv_superstep_sync_sites=sites,
               pv_superstep_collectives=dict(plan.calls))
    res["join_busy_ms_per_step"] = busy_ms_per_step(lambda: jtr.train_pass(ds, n_batches=RESIDENT_K), RESIDENT_K)
    section("join_probes")

    # ---- the three join feeds over 4 steps from one state, and a twin
    def four(flag_kw, data, want_feed):
        with flags(**flag_kw):
            t = join_trainer(share=jtr)
            losses = []
            t.train_pass(data, n_batches=JOIN_FEED_STEPS, on_batch=lambda i, m: losses.append(m["loss"]))
            if t.last_feed != want_feed:
                fail(f"took the {t.last_feed} feed, not {want_feed}")
            return t, (*device_state(t), torch.stack(losses))

    view = copy.copy(ds)
    view.records = ds.records  # a pass held as SlotRecords: the record-level feed
    ref_tr, ref = four(dict(resident_scan_batches=JOIN_FEED_STEPS), ds, "resident_pv")
    packer_tr, packed = four(dict(enable_resident_feed=0), ds, "pv_packer")
    runs = {"pv packer": packed, "pv records": four({}, view, "pv_records")[1],
            "resident twin": four(dict(resident_scan_batches=JOIN_FEED_STEPS), ds, "resident_pv")[1]}
    del view
    for name, got in runs.items():
        if not (same_device_state(got[:4], ref[:4]) and torch.equal(got[4], ref[4])):
            fail(f"{JOIN_FEED_STEPS} join steps through {name} differ from the resident pv feed")
    keys = _pv_sample_keys(ds.store, pvp.idx[:JOIN_FEED_STEPS].reshape(-1))
    full = ref_tr.trained_table()
    arrays["four_keys"] = keys
    arrays["four_rows"] = full.reshape(-1, full.shape[-1])[ds.ws.row_of_sorted[np.searchsorted(ds.ws.sorted_keys, keys)]]
    res.update(four_losses=ref[4].cpu().tolist(), feeds_bitwise=["resident pv"] + list(runs))
    del ref_tr, runs, full

    # the owner's ids of the first join batch (the pv packer's frozen K),
    # and both kernels bitwise there
    db = packer_tr._packer_cache[2].pack_sharded(pvp.idx[0], n)
    del packer_tr
    shard = jtr.trained_table_device()
    recv = torch.from_numpy(np.ascontiguousarray(db.req_ranks[:, r, :].reshape(-1))).to(dev)
    uniq = torch.unique(recv)
    tail = recv.numel() - uniq.numel()
    owner = {"pull": recv, "merge_old": torch.cat([uniq, torch.zeros(tail, dtype=uniq.dtype, device=dev)]),
             "merge_write": torch.cat([uniq.long(), torch.full((tail,), shard.shape[0], dtype=torch.long,
                                                              device=dev)])}
    what = f"mesh join {tag} rank {r} owner R={shard.shape[0]} U={recv.numel()} ({uniq.numel()} distinct)"
    res["kernel_err"] = max(
        check_gather(ck, shard, owner["pull"], what + " pull ids"),
        check_gather(ck, shard, owner["merge_old"], what + " merge old-row ids"),
        check_write(ck, shard.clone(), owner["merge_write"], ck.pull_rows_ref(shard, owner["merge_old"]) + 0.5,
                    what + " merge writeback ids"))
    res["owner_R"] = shard.shape[0]
    arrays.update({f"owner_{k}": v.cpu().numpy() for k, v in owner.items()})

    section("feeds_and_owner")

    # ---- the update phase on the flat resident feed
    jtr.handoff_table(ds)
    ds.postprocess_instance()
    ds.set_current_phase(0)
    utr = CTRTrainer(jtr.model, upd_cfg, dense_opt=Adam(1e-3), plan=plan, metric_registry=reg)
    utr.params = {k: v.clone() for k, v in jtr.params.items()}
    utr.opt_state = utr.dense_opt.init(utr.params)
    utr.prepare_pass(ds)
    n_u = ds.num_batches()
    sync()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    uout = utr.train_pass(ds)
    sync()
    res["update_s"] = time.perf_counter() - t0
    counts["update"] = dict(ck.launch_counts)
    if utr.last_feed != "resident" or uout["batches"] != n_u or not np.isfinite(uout["loss"]):
        fail(f"update: feed {utr.last_feed}, {uout['batches']} batches (want {n_u}), loss {uout['loss']}")
    if counts["update"] != want_launches(2 * n_u, n_u):
        fail(f"update launches {counts['update']} for {n_u} steps")
    if counted(reg, "update_auc") != BATCH * n_u:
        fail(f"the update metric counted {counted(reg, 'update_auc')}, want {BATCH * n_u}")
    res.update(update_batches=n_u, update_loss=uout["loss"], update_registry_digest=_registry_digest(reg))

    section("update")

    # ---- async dense on the update phase's pass: rank 0 holds the table,
    # waits for each update; twice, from one state
    def async_run():
        model = DeepFM(NUM_SLOTS, lay.pull_width, lay.embedx_dim, hidden=HIDDEN,
                       generator=torch.Generator().manual_seed(spec["seed"]))
        adt = AsyncDenseTable(model.state_dict(), base_lr=1e-3, merge_limit=1) if r == 0 else None
        t = CTRTrainer(model, dataclasses.replace(upd_cfg, dense_sync_mode="async"), dense_opt=Adam(1e-3),
                       plan=plan, async_dense=adt)
        t.init_params()
        seen, pull = [], t._async_params

        def recorded(like):
            out = pull(like)
            seen.append(_digest(*[out[k].cpu().numpy() for k in sorted(out)]))
            return out

        t._async_params = recorded
        losses = []

        def on_batch(i, m):
            losses.append(m["loss"])
            if adt is not None and not adt.wait_for_updates(i + 1, timeout=60.0):
                fail(f"async update {i + 1} never applied")

        t.train_pass(ds, n_batches=MESH_OPTION_STEPS, on_batch=on_batch)
        if t.last_feed != "packer":
            fail(f"async took the {t.last_feed} feed")
        if adt is not None:
            adt.finalize()
        return seen, (t.trained_table_device().clone(), {k: v.clone() for k, v in t.params.items()},
                      torch.stack(losses))

    sync()
    ck.reset_launch_counts()
    seen, a1 = async_run()
    sync()
    counts["async"] = dict(ck.launch_counts)
    seen2, a2 = async_run()
    if not (torch.equal(a1[0], a2[0]) and all(torch.equal(a1[1][k], a2[1][k]) for k in a1[1])
            and torch.equal(a1[2], a2[2]) and seen == seen2):
        fail("two deterministic async runs differ")
    res.update(async_params_seen=seen, async_losses=a1[2].cpu().tolist())

    section("async")

    # ---- a dump: rank 0 writes every line once
    droot = os.path.join(spec["out"], f"dump-rank{r}")
    pool = DumpWorkerPool(droot, n_threads=1)
    dtr = CTRTrainer(jtr.model, upd_cfg, dense_opt=Adam(1e-3), plan=plan, dump_pool=pool)
    dtr.params = {k: v.clone() for k, v in jtr.params.items()}
    dtr.opt_state = dtr.dense_opt.init(dtr.params)
    dtr._resident_cache = utr._resident_cache
    sync()
    ck.reset_launch_counts()
    dtr.train_pass(ds, n_batches=MESH_OPTION_STEPS)
    sync()
    counts["dump"] = dict(ck.launch_counts)
    pool.finalize()
    lines = 0
    for name in os.listdir(droot) if os.path.isdir(droot) else []:
        with open(os.path.join(droot, name)) as f:
            lines += sum(1 for ln in f if ln.strip())
    res["dump_lines"] = lines

    t0 = time.perf_counter()
    ds.end_pass(utr.trained_table())
    res.update(end_pass_s=time.perf_counter() - t0, host_digest=_host_digest(table))
    del jtr, utr, dtr, ds, reg

    section("dump_and_end_pass")

    # ---- two passes carried and two classic on bench.py's flat data
    boundary = {}
    for mode in ("classic", "carried"):
        btable = HostSparseTable(lay, sparse_opt, n_shards=64, seed=spec["seed"])
        bds = BoxPSDataset(bench_schema(), btable, batch_size=BATCH, shuffle_mode="local", seed=spec["seed"],
                           n_mesh_shards=n)
        model = DeepFM(NUM_SLOTS, lay.pull_width, lay.embedx_dim, hidden=HIDDEN,
                       generator=torch.Generator().manual_seed(spec["seed"]))
        btr = CTRTrainer(model, upd_cfg, dense_opt=Adam(1e-3), plan=plan)
        btr.init_params()
        out = {"losses": []}
        with flags(enable_carried_table=1, carried_eager_flush=0, wire_dtype="fp32"):
            for i, files in enumerate(spec["boundary_files"]):
                bds.set_filelist(files)
                bds.load_into_memory()
                sync()
                t0 = time.perf_counter()
                dev_table = bds.begin_pass(round_to=512)
                sync()
                if i == 1:  # the boundary: end_pass, then this splice or upload
                    own = dev_table if isinstance(dev_table, torch.Tensor) else torch.from_numpy(dev_table[r])
                    out.update(spliced=isinstance(dev_table, torch.Tensor), begin2_s=time.perf_counter() - t0,
                               pass2_table=_digest(own.reshape(-1, lay.width).cpu().numpy()))
                    c = dict(ck.launch_counts)
                btr.prepare_pass(bds, MESH_BOUNDARY_STEPS)
                losses = []
                btr.train_pass(bds, n_batches=MESH_BOUNDARY_STEPS, on_batch=lambda i, m: losses.append(m["loss"]))
                out["losses"] += torch.stack(losses).cpu().tolist()
                sync()
                ck.reset_launch_counts()
                t0 = time.perf_counter()
                bds.end_pass(btr.trained_table_device() if mode == "carried" else btr.trained_table())
                out[f"end_pass{i + 1}_s"] = time.perf_counter() - t0
            bds.flush_carried()
            sync()
            if mode == "carried":  # the first boundary's splice and the last one's drain
                counts["boundary"] = {k: c[k] + v for k, v in ck.launch_counts.items()}
        out["boundary_s"] = out["end_pass1_s"] + out["begin2_s"]
        out["host"] = _host_digest(btable)
        boundary[mode] = out
        del btr, bds, btable
    c, k = boundary["carried"], boundary["classic"]
    if not c["spliced"] or k["spliced"]:
        fail("the carried run did not splice, or the classic one did")
    for key in ("pass2_table", "losses", "host"):
        if c[key] != k[key]:
            fail(f"carried vs classic: {key} differs")
    res["boundary"] = boundary
    section("boundary")
    res["sections_s"] = sections
    res["counts"] = counts
    np.savez(os.path.join(spec["out"], f"rank{r}.npz"), **arrays)
    with open(os.path.join(spec["out"], f"rank{r}.json"), "w") as f:
        json.dump(res, f)


def mesh_join_reference(args, lay, files, worlds, dev):
    """The one-device join trajectory of JOIN_FEED_STEPS steps a world
    size: the world's pv plan globalized, on the resident pv feed from the
    same weights. Returns {world: (losses, sampled keys, their rows)}."""
    from paddlebox_tpu_torch.data import BoxPSDataset
    from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig
    from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig

    sparse_opt = SparseOptimizerConfig(embedx_threshold=0.0, shrink_threshold=0.0)
    table = HostSparseTable(lay, sparse_opt, n_shards=64, seed=args.seed + MESH_JOIN_SEED)
    ds = BoxPSDataset(pv_schema(), table, batch_size=BATCH, shuffle_mode="local", seed=args.seed + MESH_JOIN_SEED)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=512)
    ds.set_current_phase(1)
    ds.preprocess_instance(max_rank=MAX_RANK)
    cfg = TrainStepConfig(num_slots=NUM_SLOTS, batch_size=BATCH, layout=lay, sparse_opt=sparse_opt,
                          auc_buckets=100_000, model_takes_rank_offset=True)
    out = {}
    for w in worlds:
        gplan = globalize_pv_plan(ds.pv_plan(w))
        ds._pv_plan_cache = (ds.pvs, {(1, 0): gplan})
        tr = CTRTrainer(_join_model(args.seed + MESH_JOIN_SEED, lay), cfg, dense_opt=Adam(1e-3), device=dev)
        tr.init_params()
        losses = []
        with flags(resident_scan_batches=JOIN_FEED_STEPS):
            tr.train_pass(ds, n_batches=JOIN_FEED_STEPS, on_batch=lambda i, m: losses.append(float(m["loss"])))
        if tr.last_feed != "resident_pv":
            raise AssertionError(f"the one-device reference took the {tr.last_feed} feed")
        keys = _pv_sample_keys(ds.store, gplan.idx[:JOIN_FEED_STEPS].reshape(-1))
        full = tr.trained_table()
        out[w] = (losses, keys, full.reshape(-1, full.shape[-1])[ds.ws.row_of_sorted[np.searchsorted(
            ds.ws.sorted_keys, keys)]])
        del tr
    return out


def mesh_join_prepare(args, dev, lay, tmp):
    """Phase 13's data (bench.py's pv data from ``--seed + 9`` and two
    passes of its flat data) and the one-device references for both
    world sizes."""
    rng = np.random.default_rng(args.seed + MESH_JOIN_SEED)
    pv_files, _ = write_bench_files(tmp, rng, N_FILES, "pv", pv=True)
    b1, pool = write_bench_files(tmp, rng, MESH_BOUNDARY_FILES, "b1")
    b2, _ = write_bench_files(tmp, rng, MESH_BOUNDARY_FILES, "b2", reuse_pool=pool)
    sizes = sorted({min(torch.cuda.device_count(), MESH_NCCL_MAX), MESH_GLOO_RANKS})
    t0 = time.perf_counter()
    refs = mesh_join_reference(args, lay, pv_files, sizes, dev)
    torch.cuda.empty_cache()
    return {"pv_files": pv_files, "boundary_files": [b1, b2], "refs": refs, "ref_s": time.perf_counter() - t0}


def mesh_join_report(args, dev, card, ck, lay, worlds, prep):
    """Phase 13's checks across each world's ranks and against one device,
    its lines, and both kernels at each world's join owner shape. Returns
    (launch counts by path, owner numbers, max abs error)."""
    t_phase = time.perf_counter()
    counts, owner, refs = {}, {}, prep["refs"]
    tags = MESH_TAGS
    for name, (ranks, wall) in worlds.items():
        world, r0, tag = len(ranks), ranks[0], _mesh_tag(**tags[name])
        for key in ("host_digest", "join_registry_digest", "update_registry_digest", "four_losses",
                    "join_losses", "async_params_seen", "async_losses"):
            if any(r[key] != r0[key] for r in ranks):
                raise AssertionError(f"mesh join {tag}: the ranks' {key} differ")
        for key in ("host", "losses"):  # pass2_table is each rank's own shard
            if any(r["boundary"][m][key] != r0["boundary"][m][key] for r in ranks for m in ("carried", "classic")):
                raise AssertionError(f"mesh boundary {tag}: the ranks' {key} differ")
        if r0["dump_lines"] != MESH_OPTION_STEPS * BATCH or any(r["dump_lines"] for r in ranks[1:]):
            raise AssertionError(f"mesh dump {tag}: lines {[r['dump_lines'] for r in ranks]}, want "
                                 f"{MESH_OPTION_STEPS * BATCH} on rank 0 alone")
        if name == "nccl" and r0["pv_superstep_host_syncs"] != 0:
            raise AssertionError(f"mesh join nccl: a resident pv superstep made {r0['pv_superstep_host_syncs']} "
                                 f"host syncs: {r0['pv_superstep_sync_sites']}")
        losses, keys, rows = refs[world]
        rows_all = np.concatenate([r["four_rows"] for r in ranks])
        keys_all, first = np.unique(np.concatenate([r["four_keys"] for r in ranks]), return_index=True)
        tab_d, loss_d = _mesh_compare(f"mesh join {tag} vs one device", r0["four_losses"], rows_all[first],
                                      keys_all, losses, keys, rows)
        for path in ("join", "update"):
            counts[f"mesh_{path}_{name}"] = {k: sum(r["counts"][path][k] for r in ranks)
                                             for k in ck.launch_counts}
        for path in ("boundary", "async", "dump"):
            c = counts.setdefault(f"mesh_{path}", want_launches(0, 0))
            for k in c:
                c[k] += sum(r["counts"][path][k] for r in ranks)
        n_train = (1 + JOIN_TIMED_EPOCHS) * r0["pv_batches"]
        train_s = max(r["join_train_s"] for r in ranks)
        step_ms = train_s / (JOIN_TIMED_EPOCHS * r0["pv_batches"]) * 1e3
        b = {m: [r["boundary"][m] for r in ranks] for m in ("carried", "classic")}
        emit({
            "card": card, "phase": "mesh_join", **tags[name], "world": world, "spawn_wall_s": wall,
            "records": r0["records"], "pvs": r0["pvs"], "pv_batches_per_epoch": r0["pv_batches"],
            "keys": r0["keys"], "setup_s_rank0": r0["setup_s"], "prepare_pass_s_rank0": r0["join_prepare_s"],
            "join_samples_per_s_all": JOIN_TIMED_EPOCHS * r0["records"] / train_s,
            "join_samples_per_s_rank": JOIN_TIMED_EPOCHS * r0["records"] / train_s / world,
            "join_ms_per_step": step_ms, "join_device_busy_ms_per_step_rank0": r0["join_busy_ms_per_step"],
            "join_warm_up_epoch_s_rank0": r0["join_warm_up_s"],
            "join_device_idle_share_rank0": 1.0 - r0["join_busy_ms_per_step"] / step_ms,
            "update_samples_per_s_all": BATCH * r0["update_batches"] / max(r["update_s"] for r in ranks),
            "update_ms_per_step": max(r["update_s"] for r in ranks) / r0["update_batches"] * 1e3,
            "pv_superstep_host_syncs": r0["pv_superstep_host_syncs"],
            "pv_superstep_sync_sites": r0["pv_superstep_sync_sites"],
            "pv_superstep_collectives": r0["pv_superstep_collectives"],
            "feeds_bitwise": r0["feeds_bitwise"], "vs_one_device": {"table_max_abs": tab_d, "loss_max_rel": loss_d},
            "join_losses": r0["join_losses"], "registry_join_line": r0["join_line"],
            "end_pass_s_rank0": r0["end_pass_s"], "dump_lines_rank0": r0["dump_lines"],
            "boundary_s_by_rank": {m: [x["boundary_s"] for x in v] for m, v in b.items()},
            "boundary_begin2_s_by_rank": {m: [x["begin2_s"] for x in v] for m, v in b.items()},
            "boundary_end_pass1_s_by_rank": {m: [x["end_pass1_s"] for x in v] for m, v in b.items()},
            "launches": {p: counts.get(f"mesh_{p}_{name}") for p in ("join", "update")},
            "sections_s_rank0": r0["sections_s"],
            "join_launch_rule": {"train_steps_a_rank": n_train, "eval_steps_a_rank": r0["pv_batches"]},
        })
        print(f"mesh join {tag} world {world}: {r0['pvs']} pvs, {r0['pv_batches']} pv batches an epoch; "
              f"launches 2 gathers + 1 writeback a training step and 1 gather an eval step on every rank; "
              f"the eval epoch left the state bitwise; ins_num = memory_data_size() = {r0['records']} every "
              f"epoch, the join metric 4 x that; every rank's registry, losses and host table alike; feeds "
              f"{', '.join(r0['feeds_bitwise'])} bitwise; within bounds of one device (table {tab_d:.3g}, loss "
              f"rel {loss_d:.3g}); async twins bitwise and the ranks' params alike every step; the dump's "
              f"{r0['dump_lines']} lines on rank 0 alone; carried vs classic bitwise (pass-2 table, losses, "
              f"drained host tables), every rank's host table alike; {card}", flush=True)
    for name, (ranks, _) in worlds.items():
        owner[name] = owner_kernel_rows(args, dev, card, ck, lay, ranks[0], f"mesh_join_{name}_owner", tags[name])
    err = max(r["kernel_err"] for ranks, _ in worlds.values() for r in ranks)
    emit({"card": card, "phase": "mesh_join", "report_s": time.perf_counter() - t_phase,
          "one_device_reference_s": prep["ref_s"]})
    print(f"phase 13 (mesh join, options, boundary): its checks and kernel timings in "
          f"{time.perf_counter() - t_phase:.3f} s, its ranks in the worlds' spawns; {card}", flush=True)
    return counts, owner, err


# ---- phase 14: the supervised day ---------------------------------------------

# the JAX trainer's spans, the dataset's and the table's (utils/trace.py):
# each must be in phase 14's chrome trace
SPAN_NAMES = (
    "pack+upload", "feed_wait", "train_step_dispatch", "device_step", "resident_prepare", "superstep_dispatch",
    "device_superstep", "boundary.premerge", "boundary.stage_pull", "boundary.writeback_kick",
    "boundary.end_pass_worker", "boundary.dedup", "boundary.pull", "boundary.splice", "data.quarantine.dead_letter",
)
# bench.py's slot lines in, the same slots out, through the port's
# MultiSlotDataGenerator: the pipe_command of phase 14's ingest check. It
# loads data_generator.py by its path: the module needs neither torch nor
# the rest of the package, which a generator process would otherwise
# import (seconds a file)
RELAY_SCRIPT = '''import importlib.util
spec = importlib.util.spec_from_file_location("data_generator", {path!r})
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)
MultiSlotDataGenerator = module.MultiSlotDataGenerator


class Relay(MultiSlotDataGenerator):
    def generate_sample(self, line):
        def it():
            t = line.split()
            yield [("label", [float(t[1])])] + [("s%d" % i, [int(t[3 + 2 * i])]) for i in range({n_slots})]

        return it


Relay().run_from_stdin()
'''


def _clocked(fn, into):
    """``fn``, appending (seconds, raised) to ``into`` at each call."""

    def run(*a, **kw):
        t0 = time.perf_counter()
        raised = True
        try:
            out = fn(*a, **kw)
            raised = False
            return out
        finally:
            into.append((time.perf_counter() - t0, raised))

    return run


class _DayClock:
    """A supervised stack whose saves (``save_base`` / ``save_delta``),
    pass attempts and reverts are timed, each call as (seconds, raised)."""

    def __init__(self, s):
        self.base, self.delta, self.attempts, self.reverts = [], [], [], []
        s.cm.save_base, s.cm.save_delta = _clocked(s.cm.save_base, self.base), _clocked(s.cm.save_delta, self.delta)
        s.sup._attempt, s.sup._revert = _clocked(s.sup._attempt, self.attempts), _clocked(s.sup._revert, self.reverts)

    def retry_s(self):
        """What the day's retries cost: the failed attempts and saves, and
        the reverts."""
        return sum(t for t, raised in self.attempts + self.base + self.delta if raised) + sum(
            t for t, _ in self.reverts)


def sup_stack(args, lay, schema, root, shuffle_mode="local", shrink_threshold=None, **sup_kw):
    """A fresh supervised stack at full width: the native table
    (n_shards=64; ``shrink_threshold`` when given, else the default), a
    dataset of BATCH (``shuffle_mode``), phase 6's DeepFM and Adam, a
    CheckpointManager at ``root`` and a PassSupervisor that never sleeps
    between retries."""
    from paddlebox_tpu_torch.data import BoxPSDataset
    from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig
    from paddlebox_tpu_torch.train import CheckpointManager, PassSupervisor, RetryPolicy, TrainStepConfig

    opt = SparseOptimizerConfig() if shrink_threshold is None else SparseOptimizerConfig(
        shrink_threshold=shrink_threshold)
    table = HostSparseTable(lay, opt, n_shards=64, seed=args.seed)
    ds = BoxPSDataset(schema, table, batch_size=BATCH, shuffle_mode=shuffle_mode, seed=args.seed)
    cfg = TrainStepConfig(num_slots=NUM_SLOTS, batch_size=BATCH, layout=lay, sparse_opt=opt)
    tr = new_trainer(args, cfg, lay)
    cm = CheckpointManager(root)
    sup = PassSupervisor(ds, tr, checkpoint=cm, retry=RetryPolicy(backoff_s=0.0, sleep=lambda s: None), **sup_kw)
    return SimpleNamespace(table=table, ds=ds, tr=tr, cm=cm, sup=sup, opt=opt, cfg=cfg)


def same_stack(a, b, what):
    """Host tables, params, Adam state and the last pass's AUC tables of two
    stacks, bitwise; raises otherwise."""
    auc_a, auc_b = a.tr._state.auc, b.tr._state.auc
    if not same_tables(a.table, b.table):
        raise AssertionError(f"{what}: the host tables differ")
    if not same_dense(a.tr, b.tr):
        raise AssertionError(f"{what}: the dense params or the Adam state differ")
    if not (torch.equal(auc_a.pos, auc_b.pos) and torch.equal(auc_a.neg, auc_b.neg)):
        raise AssertionError(f"{what}: the AUC tables differ")


def same_chain(root_a, root_b, lay, opt, seed, what):
    """Two published chains: the same files under the day (checkpoint.py's
    names), every npz's arrays equal, and a resume of each into a fresh
    table bitwise alike (npz members carry zip timestamps, so bytes are
    not compared)."""
    from paddlebox_tpu_torch.table import HostSparseTable
    from paddlebox_tpu_torch.train import CheckpointManager

    def files(root):
        out = set()
        for d, dirs, names in os.walk(root):
            rel = os.path.relpath(d, root)
            if rel.split(os.sep)[0] in ("obs", "quarantine", "compile_cache"):
                continue
            out |= {os.path.join(rel, n) for n in names}
        return out

    fa, fb = files(root_a), files(root_b)
    if fa != fb:
        raise AssertionError(f"{what}: the chains hold different files: {sorted(fa ^ fb)[:8]}")
    for rel in sorted(f for f in fa if f.endswith(".npz")):
        with np.load(os.path.join(root_a, rel)) as x, np.load(os.path.join(root_b, rel)) as y:
            if sorted(x.files) != sorted(y.files) or not all(np.array_equal(x[k], y[k]) for k in x.files):
                raise AssertionError(f"{what}: {rel} differs")
    ta, tb = (HostSparseTable(lay, opt, n_shards=64, seed=seed) for _ in range(2))
    sa, sb = CheckpointManager(root_a).resume(ta), CheckpointManager(root_b).resume(tb)
    if sa != sb or not same_tables(ta, tb):
        raise AssertionError(f"{what}: the chains resume to different states ({sa} vs {sb})")
    return len(fa)


def ingest_check(args, lay, schema, tmp, files, extra, card):
    """Phase 14's ingest: the day's first 4 files through a
    MultiSlotDataGenerator ``pipe_command`` and through the native tier,
    records and working-set keys bitwise; then a copy with a seeded 0.5%
    of one file's lines corrupted, an intact ``.gz`` part and a truncated
    one: the counts, the dead letter and the admission. Returns (the
    quarantined files, the pre-cleaned files, numbers)."""
    import gzip

    from paddlebox_tpu_torch.data import BoxPSDataset, read_dead_letter
    from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig

    script = os.path.join(tmp, "relay.py")
    with open(script, "w") as f:
        f.write(RELAY_SCRIPT.format(path=os.path.join(REPO, "paddlebox_tpu_torch", "data", "data_generator.py"),
                                    n_slots=NUM_SLOTS))
    nums, loaded = {}, {}
    for tier, kw in (("pipe", {"pipe_command": f"{sys.executable} {script}"}), ("native", {})):
        ds = BoxPSDataset(schema, HostSparseTable(lay, SparseOptimizerConfig(), n_shards=64, seed=args.seed),
                          batch_size=BATCH, **kw)
        ds.set_filelist(files)
        t0 = time.perf_counter()
        ds.load_into_memory()
        load_s = time.perf_counter() - t0
        if (ds.store is None) != (tier == "pipe"):
            raise AssertionError(f"the {tier} load took the wrong tier")
        st = ds.stats
        nums[f"{tier}_load_s"] = load_s
        nums[f"{tier}_lines_per_s"] = st.lines / load_s
        nums[f"{tier}_stats"] = {k: v for k, v in dataclasses.asdict(st).items() if k != "bad_by_file"}
        if ds.store is not None:
            vals, offs, fl = ds.store.u64_values, ds.store.u64_offsets, ds.store.f_values
        else:
            recs = ds.records
            vals = np.concatenate([r.u64_values for r in recs])
            offs = np.stack([r.u64_offsets for r in recs])
            fl = np.concatenate([r.f_values for r in recs])
        loaded[tier] = (vals, offs, fl, ds.ws.premerge(8))
    for a, b in zip(loaded["pipe"], loaded["native"]):
        if a.shape != b.shape or a.tobytes() != b.tobytes():
            raise AssertionError("the pipe_command load differs from the native load (records or working-set keys)")
    print(f"ingest: {len(files)} files through a MultiSlotDataGenerator pipe_command and through the native tier: "
          f"records and {len(loaded['native'][3])} working-set keys bitwise alike; pipe {nums['pipe_load_s']:.3f} s "
          f"({nums['pipe_lines_per_s']:.0f} lines/s), native {nums['native_load_s']:.3f} s "
          f"({nums['native_lines_per_s']:.0f} lines/s); {card}", flush=True)

    # the quarantined copy: 0.5% of file 0's lines corrupted in place, an
    # intact .gz of an extra file and a truncated .gz of another
    rng = np.random.default_rng(args.seed + 14)
    with open(files[0]) as f:
        lines = f.read().splitlines()
    bad = np.sort(rng.choice(len(lines), int(round(len(lines) * 0.005)), replace=False))
    corrupt = list(lines)
    for i in bad:  # a label no float parser takes: both tiers reject the line
        corrupt[i] = "1 not-a-float " + lines[i].split(" ", 2)[2]
    qdir = os.path.join(tmp, "quarantined")
    os.makedirs(qdir)
    f0_bad = os.path.join(qdir, "part-000-corrupt.txt")
    f0_clean = os.path.join(qdir, "part-000-clean.txt")
    with open(f0_bad, "w") as f:
        f.write("\n".join(corrupt) + "\n")
    keep = np.ones(len(lines), bool)
    keep[bad] = False
    with open(f0_clean, "w") as f:
        f.write("\n".join(np.asarray(lines, dtype=object)[keep]) + "\n")
    gz_ok, gz_torn = os.path.join(qdir, "extra-0.txt.gz"), os.path.join(qdir, "extra-1.txt.gz")
    with open(extra[0], "rb") as src, gzip.open(gz_ok, "wb") as dst:
        dst.write(src.read())
    with open(extra[1], "rb") as src:
        whole = gzip.compress(src.read())
    with open(gz_torn, "wb") as f:
        f.write(whole[: len(whole) // 2])
    quarantined = [f0_bad, *files[1:], gz_ok, gz_torn]
    precleaned = [f0_clean, *files[1:], extra[0]]
    ds = BoxPSDataset(schema, HostSparseTable(lay, SparseOptimizerConfig(), n_shards=64, seed=args.seed),
                      batch_size=BATCH, quarantine_dir=os.path.join(tmp, "dead-letters"))
    ds.set_date(PUB14_DATE)
    ds.set_filelist(quarantined)
    t0 = time.perf_counter()
    ds.load_into_memory()
    nums["quarantined_load_s"] = time.perf_counter() - t0
    st = ds.stats
    if (st.bad_lines, st.bad_files) != (len(bad), 1):
        raise AssertionError(f"quarantine counted {st.bad_lines} bad lines and {st.bad_files} bad files, "
                             f"injected {len(bad)} and 1")
    dl = read_dead_letter(st.dead_letter)
    got_lines = [(e["file"], e["line_no"], e["line"]) for e in dl["entries"] if e["kind"] == "line"]
    want_lines = [(f0_bad, int(i) + 1, corrupt[i]) for i in bad]
    got_files = [e["file"] for e in dl["entries"] if e["kind"] == "file"]
    if got_lines != want_lines or got_files != [gz_torn]:
        raise AssertionError("the dead letter does not hold exactly the corrupted lines and the torn part")
    rep = ds.admission_report()
    if rep["poisoned"]:
        raise AssertionError(f"the quarantined pass was not admitted: {rep['detail']}")
    nums["quarantine"] = {k: rep[k] for k in ("bad_lines", "bad_files", "lines", "files", "line_fraction",
                                             "file_fraction")}
    print(f"quarantine: {st.bad_lines} bad lines and {st.bad_files} bad file counted, exactly those injected; the "
          f"dead letter holds exactly those lines and the torn part; admitted (line fraction "
          f"{rep['line_fraction']:.5f}, file fraction {rep['file_fraction']:.3f}); PassStats "
          f"{ {k: v for k, v in dataclasses.asdict(st).items() if k not in ('bad_by_file', 'dead_letter')} }",
          flush=True)
    return quarantined, precleaned, nums


def resident_path_check(ck, tr, what, write=True):
    """Both kernels (the gather alone with ``write=False``) against their
    plain versions at the shape ``tr``'s last resident pass gave them: the
    unique rows of its first step, built from the trainer's own
    ResidentPass and index partition, into a copy of its trained device
    table. Returns the max abs error."""
    from paddlebox_tpu_torch.train import build_device_batch

    res, part = tr._resident_cache, tr._idx_cache
    if tr.last_feed != "resident" or res is None or part is None or part[0] is not res[2]:
        raise AssertionError(f"{what}: the last pass left no resident pass to take the kernels' ids from "
                             f"(feed {tr.last_feed})")
    rows = build_device_batch(res[2], tr.cfg, part[2][0])["uniq_rows"]
    tab = tr.trained_table_device().clone()
    what = f"{what} R={tab.shape[0]} W={tab.shape[1]} U={rows.shape[0]} int32"
    errs = [check_gather(ck, tab, rows, what)]
    if write:
        errs.append(check_write(ck, tab, rows, ck.pull_rows_ref(tab, rows) + 0.5, what))
    return max(errs)


def supervised_day(args, lay, schema, root, passes, ck, rules=()):
    """One supervised ``run_day`` on a fresh stack, under ``rules`` of the
    fault plan. Returns (stack, outs, wall s, launch counts, the plan,
    the day's clock)."""
    from paddlebox_tpu_torch.utils import faultinject as fault

    s = sup_stack(args, lay, schema, root)
    clock = _DayClock(s)
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    with flags(resident_scan_batches=SUP_K), fault.inject(*rules) as plan:
        t0 = time.perf_counter()
        outs = s.sup.run_day(PUB14_DATE, passes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return s, outs, wall, dict(ck.launch_counts), plan, clock


def bare_day(args, lay, schema, root, passes):
    """The same passes through bare train_pass (no supervisor, no guard,
    no saves), the classic boundary as a supervised pass has: (stack, wall
    s)."""
    s = sup_stack(args, lay, schema, root)
    with flags(resident_scan_batches=SUP_K):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for files in passes:
            s.ds.set_date(PUB14_DATE)
            s.ds.set_filelist(files)
            s.ds.load_into_memory()
            s.ds.begin_pass(round_to=512)
            s.tr.prepare_pass(s.ds)
            s.tr.train_pass(s.ds)
            s.ds.end_pass(s.tr.trained_table())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return s, wall


def want_launches(pull: int, write: int, merge=None) -> dict:
    """The launch counts a path should show: ``pull`` gathers, ``write``
    writebacks and ``merge`` push merges, by default one a writeback (a
    training step on the card merges once and writes back once)."""
    return {"pull_rows_cuda": pull, "write_rows_cuda": write, "merge_rows_cuda": write if merge is None else merge}


def kernel_events(prof, kernel: str) -> int:
    """Launches of ``kernel`` among the profiler's device events."""
    return sum(e.count for e in prof.key_averages() if kernel in e.key)


def observability(args, lay, schema, tmp, passes, quarantined, card, ck):
    """Phase 14's observability: the PROFILER over a supervised pass (the
    kick, the resident spans), the same pass with it off, a quarantined load (the dead letter), profiled passes on
    the resident and the packer feed (the device spans), a carried
    boundary (the splice) and 2 steps under ``device_trace``. Every span
    of SPAN_NAMES must be in the exported trace, and the kernels in the
    trace as many times as ``launch_counts``."""
    from paddlebox_tpu_torch.data import BoxPSDataset
    from paddlebox_tpu_torch.utils.trace import PROFILER, device_trace

    nums = {}
    sps = {}
    PROFILER.reset()
    for mode in ("on", "off"):
        # no shrink threshold: the feed stage prefetches the next pass's rows
        s = sup_stack(args, lay, schema, os.path.join(tmp, f"obs-{mode}"), shrink_threshold=0.0)
        if mode == "on":
            PROFILER.enable()
        try:
            with flags(resident_scan_batches=SUP_K):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = s.sup.run_day(PUB14_DATE, passes[:1], publish=False)
                torch.cuda.synchronize()
                sps[mode] = sum(o["batches"] for o in outs) * BATCH / (time.perf_counter() - t0)
        finally:
            PROFILER.disable()
        if mode == "on":
            on = s
    nums["samples_per_s_profiler_on"], nums["samples_per_s_profiler_off"] = sps["on"], sps["off"]
    PROFILER.enable()
    try:
        # the dead letter's span
        qds = BoxPSDataset(schema, on.table, batch_size=BATCH, quarantine_dir=os.path.join(tmp, "obs-dead"))
        qds.set_filelist(quarantined)
        qds.load_into_memory()
        # the device spans on both flat feeds, then a carried boundary
        ds, tr = on.ds, on.tr
        ds.set_date(PUB14_DATE)
        ds.set_filelist(passes[0])
        ds.load_into_memory()
        ds.begin_pass(round_to=512)
        tr.train_pass(ds, n_batches=2, profile=True)
        with flags(enable_resident_feed=0):
            tr.train_pass(ds, n_batches=2, profile=True)
        if tr.last_feed != "packer":
            raise AssertionError(f"the profiled packer pass took the {tr.last_feed} feed")
        # the next load while this pass is open: its feed stage pulls the
        # new keys' rows (a kicked preload may find the pass ended first)
        ds.set_filelist(passes[1])
        ds.load_into_memory()
        ds.end_pass(tr.trained_table_device())
        ds.begin_pass(round_to=512)  # the splice
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        with device_trace(os.path.join(tmp, "device-trace")) as prof:
            tr.train_pass(ds, n_batches=2)
        counts = dict(ck.launch_counts)
        ds.end_pass(None)
        on.table.drain_pending()
    finally:
        PROFILER.disable()
    events = {"pull_rows_cuda": kernel_events(prof, "gather_rows_kernel"),
              "write_rows_cuda": kernel_events(prof, "write_rows_kernel"),
              "merge_rows_cuda": kernel_events(prof, "merge_light_kernel")}
    if events != counts or counts != want_launches(4, 2):
        raise AssertionError(f"device_trace over 2 steps names the kernels {events} times, launch_counts says {counts}")
    trace_path = os.path.join(tmp, "supervised-trace.json")
    n_events = PROFILER.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        spans = {}
        for e in json.load(f)["traceEvents"]:
            if e.get("ph") == "X":
                spans[e["name"]] = spans.get(e["name"], 0) + 1
    missing = [n for n in SPAN_NAMES if n not in spans]
    if missing:
        raise AssertionError(f"the chrome trace misses the spans {missing}")
    PROFILER.reset()
    nums["trace_events"] = n_events
    nums["spans"] = dict(sorted(spans.items()))
    nums["device_trace_kernel_events"] = events
    print(f"observability: {n_events} trace events, every one of the {len(SPAN_NAMES)} spans present; samples/s "
          f"{sps['on']:.0f} profiler on, {sps['off']:.0f} off; device_trace over 2 steps names the kernels {events} "
          f"times, as launch_counts; {card}", flush=True)
    return nums


def auc_runner_check(args, s, schema, files, ck, card):
    """``slots_shuffle`` over AUC_SLOTS on the trained table, one eval
    pass each, beside the unshuffled eval pass; 1 gather an eval step.
    Returns (launch counts, numbers, the gather's max abs error at the
    eval path's shape)."""
    from paddlebox_tpu_torch.data import BoxPSDataset

    ds = BoxPSDataset(schema, s.table, batch_size=BATCH, shuffle_mode="local", seed=args.seed)
    ds.set_date(PUB14_DATE)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=512)
    s.tr.set_test_mode(True)
    aucs, secs = {}, {}
    steps = 0
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    try:
        for slot in (None, *AUC_SLOTS):
            t0 = time.perf_counter()
            if slot is not None:
                ds.slots_shuffle([slot])
            out = s.tr.train_pass(ds)
            torch.cuda.synchronize()
            secs[slot or "unshuffled"] = time.perf_counter() - t0
            aucs[slot or "unshuffled"] = out["auc"]
            steps += int(out["batches"])
        counts = dict(ck.launch_counts)
        # the eval path's gather at its own shape (an eval step writes no rows)
        err = resident_path_check(ck, s.tr, "AUC runner eval path", write=False)
        ds.slots_shuffle([])
    finally:
        s.tr.set_test_mode(False)
    ds.end_pass(None, shrink=False)
    if counts != want_launches(steps, 0) or not all(np.isfinite(list(aucs.values()))):
        raise AssertionError(f"AUC runner: launches {counts} for {steps} eval steps (want 1 gather each), "
                             f"aucs {aucs}")
    print(f"AUC runner: eval AUC unshuffled {aucs['unshuffled']:.5f}; "
          + ", ".join(f"{k} shuffled {v:.5f}" for k, v in aucs.items() if k != "unshuffled")
          + f"; {steps} eval steps, launches {counts}; {card}", flush=True)
    return counts, {"auc": aucs, "seconds": secs, "eval_steps": steps}, err


def stream_check(args, lay, schema, tmp, chunks, ck, card):
    """The stream: a writer thread appends STREAM_RECORDS bench lines every
    STREAM_EVERY_S s; a StreamSupervisor (STREAM_MICRO_S s micro-passes,
    compaction every STREAM_COMPACT deltas) cuts them while a Follower
    polls the chain; a ``stream.cut_publish`` fault crashes cut 2 with its
    spool durable and untrained, the stack restarts from disk and the
    stream goes on to STREAM_CUTS cuts. The final table and dense state
    must be bitwise an uninterrupted run over the same spools. Returns
    (launch counts, numbers, both kernels' max abs error at the stream's
    shape)."""
    import shutil
    import threading

    from paddlebox_tpu_torch.serve import Follower
    from paddlebox_tpu_torch.train import StreamSupervisor
    from paddlebox_tpu_torch.utils import faultinject as fault
    from paddlebox_tpu_torch.utils.monitor import STAT_GET

    stream_dir, keep = os.path.join(tmp, "stream"), os.path.join(tmp, "spools")
    os.makedirs(stream_dir)
    os.makedirs(keep)
    root = os.path.join(tmp, "stream-ckpt")
    cuts, steps = [], [0]

    def watched(stack):
        """Keep a copy of every spool the stack's supervisor trains (the
        stream's cuts, a recovery's replay too), and count the steps."""
        real = stack.sup.run_pass

        def run_pass(files, *a, **kw):
            (spool,) = files
            dst = os.path.join(keep, os.path.basename(spool))
            with open(spool, "rb") as f:
                data = f.read()
            if os.path.exists(dst):  # a replayed spool: the bytes first cut
                with open(dst, "rb") as f:
                    if f.read() != data:
                        raise AssertionError(f"the replayed spool {spool} differs from the first")
            shutil.copyfile(spool, dst)
            cuts.append((int(os.path.basename(spool)[4:10]), data.count(b"\n")))
            out = real(files, *a, **kw)
            steps[0] += int(out["batches"])
            return out

        stack.sup.run_pass = run_pass
        return stack

    stop_writer = threading.Event()

    def writer():
        # the chunks in turn until the stream has its cuts
        i = 0
        while not stop_writer.wait(0.0 if i == 0 else STREAM_EVERY_S):
            with open(chunks[i % len(chunks)]) as src, open(os.path.join(stream_dir, "events.txt"), "a") as dst:
                dst.write(src.read())
            i += 1

    stretches0 = STAT_GET("stream.backlog_stretches")
    fol = None
    stop_fol = threading.Event()
    fol_err = []
    fresh = []  # the exact serve.freshness_s of each head commit

    def poll():
        n = fol.freshness_commits
        fol.poll_once()
        if fol.freshness_commits != n:
            fresh.append(fol.last_freshness_s)

    def follow():
        while not stop_fol.wait(0.5):
            try:
                poll()
            except Exception as e:  # raised in the main thread below
                fol_err.append(e)
                return

    # no shuffle: a cut replayed after a restart has another pass_id, and
    # the local shuffle's permutation is seeded by it
    s = watched(sup_stack(args, lay, schema, root, shuffle_mode="none"))
    fol = Follower(root, lay, s.opt, n_host_shards=64)
    ss = StreamSupervisor(s.sup, stream_dir, PUB14_DATE, pattern="*.txt", micro_pass_s=STREAM_MICRO_S,
                          compact_every=STREAM_COMPACT)
    threads = [threading.Thread(target=writer, name="stream-writer"), threading.Thread(target=follow, name="follower")]
    stop = threading.Event()  # the stream's deadline: a stalled stream fails instead of hanging
    deadline = threading.Timer(STREAM_DEADLINE_S, stop.set)
    deadline.start()
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    try:
        with flags(resident_scan_batches=SUP_K):
            with fault.inject(fault.fail_nth("stream.cut_publish", STREAM_FAULT_HIT)) as plan:
                try:
                    ss.run(stop)
                except fault.InjectedFault:
                    pass
                else:
                    raise AssertionError("the stream.cut_publish fault did not crash the stream")
                if plan.failures("stream.cut_publish") != 1 or ss.cut_seq != 1:
                    raise AssertionError("the stream did not crash at cut 2")
            # the restart: a fresh stack from durable state only; recovery
            # replays cut 2 from its durable spool
            replays0 = STAT_GET("stream.replays")
            s = watched(sup_stack(args, lay, schema, root, shuffle_mode="none"))
            s.cm.resume(s.table, s.tr)
            ss = StreamSupervisor(s.sup, stream_dir, PUB14_DATE, pattern="*.txt", micro_pass_s=STREAM_MICRO_S,
                                  compact_every=STREAM_COMPACT)
            if STAT_GET("stream.replays") != replays0 + 1 or ss.cut_seq != 2:
                raise AssertionError("the restarted stream did not replay cut 2 from its spool")
            while ss.cut_seq < STREAM_CUTS:
                if stop.is_set():
                    raise AssertionError(f"the stream cut {ss.cut_seq} micro-passes in {STREAM_DEADLINE_S} s")
                ss.run(stop, max_cuts=1)
    finally:
        deadline.cancel()
        stop_writer.set()
        threads[0].join()
        time.sleep(1.0)  # a last poll of the follower
        stop_fol.set()
        threads[1].join()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = dict(ck.launch_counts)
    if fol_err:
        raise fol_err[0]
    if counts != want_launches(2 * steps[0], steps[0]):
        raise AssertionError(f"stream: launches {counts} for {steps[0]} steps: want 2 gathers and 1 writeback a step")
    poll()
    v = fol.version()
    cur = s.cm.cursor()
    if (v.date, v.delta_idx) != (cur["date"], cur["delta_idx"]) or not int(cur.get("compact") or 0):
        raise AssertionError(f"the follower serves {v.date}/{v.delta_idx}, the chain is at {cur}")

    # the uninterrupted run over the same spools
    ref = sup_stack(args, lay, schema, os.path.join(tmp, "stream-ref"), shuffle_mode="none")
    seqs = sorted({seq for seq, _ in cuts})
    with flags(resident_scan_batches=SUP_K):
        for seq in seqs:
            ref.sup.run_pass([os.path.join(keep, f"cut-{seq:06d}.txt")], date=PUB14_DATE)
    if seqs != list(range(1, ss.cut_seq + 1)):
        raise AssertionError(f"the stream trained the cuts {seqs}")
    if not (same_tables(s.table, ref.table) and same_dense(s.tr, ref.tr)):
        raise AssertionError("the crashed and restarted stream differs from an uninterrupted run over its spools")
    # both kernels at the shape of the stream's last cut
    err = resident_path_check(ck, s.tr, "stream path")
    if not fresh:
        raise AssertionError("the follower committed no stream head")
    # exact quantiles of the per-commit values (numpy's linear
    # interpolation: over a handful of commits p99 sits near the max)
    p50, p99 = (float(q) for q in np.percentile(fresh, (50, 99)))
    records = {seq: r for seq, r in cuts}
    nums = {
        "cuts": ss.cut_seq, "records_a_cut": [records[q] for q in seqs], "steps": steps[0],
        "backlog_stretches": STAT_GET("stream.backlog_stretches") - stretches0,
        "freshness_s": fresh, "freshness_s_p50": p50, "freshness_s_p99": p99, "freshness_s_max": max(fresh),
        "compact": int(cur.get("compact") or 0), "wall_s": wall,
    }
    print(f"stream: {ss.cut_seq} cuts ({nums['records_a_cut']} records), a stream.cut_publish crash at cut 2 "
          f"replayed from its spool: exactly once, the final table and dense state bitwise an uninterrupted run "
          f"over the same spools; serve.freshness_s exact over {len(fresh)} head commits: p50 {p50:.3f} s, "
          f"p99 {p99:.3f} s, max {max(fresh):.3f} s ({[round(x, 3) for x in fresh]}); "
          f"{nums['backlog_stretches']} backlog stretches; launches {counts}; {card}", flush=True)
    return counts, nums, err


def supervised_phase(args, dev, card, ck, lay, schema):
    """Phase 14: the ingest tier, the supervised day, observability, the
    AUC runner and the stream. Returns its launch counts by path and the
    kernels' max abs error at its paths' shapes."""
    from paddlebox_tpu_torch.obs.flight_recorder import FLIGHT_RECORDER
    from paddlebox_tpu_torch.obs.metrics_writer import read_series
    from paddlebox_tpu_torch.utils import compilecache
    from paddlebox_tpu_torch.utils import faultinject as fault

    t_phase = time.perf_counter()
    nums, by_path = {}, {}
    cc0, runs0 = compilecache.stats(), len(ck.nvcc_runs())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_supervised_") as tmp, flags(fs_open_backoff_s=0.0):
        rng = np.random.default_rng(args.seed + 14)
        day_files, _ = write_bench_files(tmp, rng, SUP_PASSES * SUP_FILES + 2, "day14")
        passes = [day_files[p * SUP_FILES : (p + 1) * SUP_FILES] for p in range(SUP_PASSES)]
        extra = day_files[SUP_PASSES * SUP_FILES :]
        chunks, _ = write_bench_files(tmp, rng, STREAM_CHUNKS, "stream14")

        # 1. ingest
        t0 = time.perf_counter()
        quarantined, precleaned, nums["ingest"] = ingest_check(args, lay, schema, tmp, passes[0], extra, card)
        nums["ingest_s"] = time.perf_counter() - t0

        # 2. the supervised day: clean, then under one fault plan
        t0 = time.perf_counter()
        clean, outs_c, wall_c, counts_c, probe, clock = supervised_day(
            args, lay, schema, os.path.join(tmp, "ckpt-clean"), passes, ck)
        steps_c = sum(int(o["batches"]) for o in outs_c)
        if clean.sup.incidents or counts_c != want_launches(2 * steps_c, steps_c) \
                or steps_c != SUP_PASSES * SUP_FILES * RECORDS_PER_FILE // BATCH:
            raise AssertionError(f"clean supervised day: incidents {clean.sup.incidents}, launches {counts_c} for "
                                 f"{steps_c} steps")
        # both kernels at the shape of the clean day's last pass
        errs = [resident_path_check(ck, clean.tr, "supervised path")]
        dispatches = probe.hits("step.device") // SUP_PASSES
        save_fires = probe.hits("checkpoint.save") // SUP_PASSES
        faulted, outs_f, wall_f, counts_f, plan, fclock = supervised_day(
            args, lay, schema, os.path.join(tmp, "ckpt-faulted"), passes, ck,
            rules=(
                fault.fail_once("fs.open_read"),
                # the dispatch of step 5 of pass 2 (SUP_K steps a dispatch)
                fault.fail_nth("step.device", dispatches + (5 - 1) // SUP_K + 1),
                fault.fail_nth("checkpoint.save", save_fires + 2),
            ),
        )
        incidents = [(i.kind, i.action, i.attempt) for i in faulted.sup.incidents]
        want = [("train_error", "revert_retry", 0), ("ckpt_save_error", "retry", 0)]
        if incidents != want or [plan.failures(k) for k in ("fs.open_read", "step.device", "checkpoint.save")] \
                != [1, 1, 1]:
            raise AssertionError(f"faulted day: incidents {incidents}, want {want}")
        steps_f = steps_c + (5 - 1) // SUP_K * SUP_K  # what the failed attempt trained before its revert
        if counts_f != want_launches(2 * steps_f, steps_f):
            raise AssertionError(f"faulted day: launches {counts_f} for {steps_f} steps")
        same_stack(faulted, clean, "the faulted supervised day against the clean one")
        n_files = same_chain(clean.cm.root, faulted.cm.root, lay, clean.opt, args.seed, "the published chains")
        if [o["loss"] for o in outs_f] != [o["loss"] for o in outs_c]:
            raise AssertionError("the faulted day's pass losses differ from the clean day's")
        # the supervisor dumps a bundle by itself only for a fatal incident
        # (as the reference does): an operator dumps the ring on demand
        bundle = FLIGHT_RECORDER.dump("chip_smoke_step_device", "step.device at step 5 of pass 2",
                                      dir_path=os.path.join(tmp, "incidents"))
        with open(bundle) as f:
            kinds = [i["kind"] for i in json.load(f)["incidents"]]
        if "supervisor:train_error" not in kinds:
            raise AssertionError(f"the flight recorder's bundle holds no step.device incident: {kinds}")
        series = [r["label"] for r in read_series(os.path.join(clean.cm.root, "obs"))]
        if [x for x in series if x.startswith("pass:")] != [f"pass:{p + 1}" for p in range(SUP_PASSES)]:
            raise AssertionError(f"the metric series reads back {series}")
        bare, wall_b = bare_day(args, lay, schema, os.path.join(tmp, "ckpt-bare"), passes)
        same_stack(bare, clean, "bare train_pass against the supervised day")
        by_path["supervised"] = counts_c
        samples = steps_c * BATCH
        failed = [t for t, raised in fclock.attempts if raised]
        torn = [t for t, raised in fclock.base + fclock.delta if raised]
        if len(failed) != 1 or len(fclock.reverts) != 1 or len(torn) != 1:
            raise AssertionError(f"faulted day: {len(failed)} failed attempts, {len(fclock.reverts)} reverts and "
                                 f"{len(torn)} failed saves timed, want 1 each")
        base_s, delta_s = [t for t, _ in clock.base], [t for t, _ in clock.delta]
        nums["day"] = {
            "samples_per_s_supervised": samples / wall_c, "samples_per_s_bare_train_pass": samples / wall_b,
            "day_s_clean": wall_c, "day_s_faulted": wall_f, "retry_cost_s": fclock.retry_s(),
            "failed_attempt_s": failed[0], "revert_s": fclock.reverts[0][0], "failed_save_s": torn[0],
            "save_base_s": base_s, "save_delta_s": delta_s, "incidents": incidents,
            "chain_files": n_files, "bundle_incident_kinds": kinds, "losses": [o["loss"] for o in outs_c],
            "aucs": [o["auc"] for o in outs_c],
        }
        print(f"supervised day: {SUP_PASSES} passes, {steps_c} steps, launches {counts_c}; under an fs.open_read "
              f"flake, a step.device fault at step 5 of pass 2 and a torn checkpoint save: incidents {incidents}, "
              f"launches {counts_f}, table, params, Adam state, AUC tables and the published chain ({n_files} "
              f"files) bitwise the clean day's; bare train_pass bitwise too. samples/s supervised "
              f"{samples / wall_c:.0f} (its saves included), bare {samples / wall_b:.0f}; a flight-recorder bundle "
              f"dumped on demand holds the step.device incident; the retries cost {fclock.retry_s():.3f} s (the "
              f"failed attempt {failed[0]:.3f} s, its revert {fclock.reverts[0][0]:.3f} s, the torn save "
              f"{torn[0]:.3f} s; the faulted day {wall_f:.3f} s, the clean {wall_c:.3f} s); save_base {base_s} s, "
              f"save_delta {delta_s} s; {card}", flush=True)

        # the quarantined pass under "degrade" against the pre-cleaned files
        with flags(max_bad_line_fraction=0.0005):
            deg = sup_stack(args, lay, schema, os.path.join(tmp, "ckpt-degrade"), on_poisoned="degrade")
            out_d = deg.sup.run_pass(quarantined, date=PUB14_DATE)
        pre = sup_stack(args, lay, schema, os.path.join(tmp, "ckpt-precleaned"))
        out_p = pre.sup.run_pass(precleaned, date=PUB14_DATE)
        if [(i.kind, i.action) for i in deg.sup.incidents] != [("data_poisoned", "degrade")] or pre.sup.incidents:
            raise AssertionError(f"degrade: incidents {deg.sup.incidents} and {pre.sup.incidents}")
        same_stack(deg, pre, "the quarantined pass under degrade against the pre-cleaned files")
        if out_d["loss"] != out_p["loss"] or out_d["quarantined_bad_lines"] != nums["ingest"]["quarantine"]["bad_lines"]:
            raise AssertionError("degrade: the loss or the loss accounting differs")
        print(f"degrade: the quarantined pass ({deg.tr.last_feed} feed) is bitwise the pre-cleaned files' pass "
              f"({pre.tr.last_feed} feed): table, dense, Adam, AUC tables and loss; {card}", flush=True)
        nums["day_s"] = time.perf_counter() - t0

        # 3. observability
        t0 = time.perf_counter()
        nums["observability"] = observability(args, lay, schema, tmp, passes[:2], quarantined, card, ck)
        nums["observability_s"] = time.perf_counter() - t0

        # 4. the AUC runner on the clean day's trained table
        t0 = time.perf_counter()
        by_path["auc_runner"], nums["auc_runner"], err = auc_runner_check(
            args, clean, schema, passes[-1][:AUC_FILES], ck, card)
        errs.append(err)
        nums["auc_runner_s"] = time.perf_counter() - t0

        # 5. the stream
        t0 = time.perf_counter()
        by_path["stream"], nums["stream"], err = stream_check(args, lay, schema, tmp, chunks, ck, card)
        errs.append(err)
        nums["stream_s"] = time.perf_counter() - t0
        # every supervisor enabled <its root>/compile_cache ("auto"); both
        # kernels were loaded before the phase, so none was built or copied
        cc = compilecache.stats()
        nums["compile_cache"] = {**{k: cc[k] - cc0[k] for k in ("hits", "misses", "requests")},
                                 "nvcc_runs": len(ck.nvcc_runs()) - runs0, "last_dir": cc["dir"]}
    compilecache.disable()
    print(f"supervised day: each supervisor enabled <its checkpoint root>/compile_cache ('auto'); over the phase "
          f"{nums['compile_cache']}; {card}", flush=True)
    nums["phase_s"] = time.perf_counter() - t_phase
    emit({"card": card, "phase": "supervised_day", **nums})
    print(f"phase 14 (supervised day, ingest, observability, AUC runner, stream): {nums['phase_s']:.3f} s; {card}",
          flush=True)
    return by_path, max(errs)


# ---- 15. the multi-host day: host processes of their own over the host plane

MH_SEED = 15  # the phase's data seed offset
MH_TIMED = 32  # resident steps of the two-host pass: one epoch of a host's 8 files
MH_WARM = 8
MH_PACKER = 8
MH_ZERO = 8
MH_SHUFFLE_FILES = (9, 7)  # the ins_id shuffle pass's unequal stripes
MH_CARRIED_FILES = 2  # a host a pass, two passes
MH_PV_FILES = (3, 1)  # the join day's unequal stripes
MH_FOUR = 8  # steps of the four-host world
MH_SMALL_FILES = 2  # a host, the card against the CPU
MH_SMALL_BATCH = 256
MH_SMALL_STEPS = 4
MH_SMALL_HIDDEN = (32, 16)
MH_TIMEOUT_S = 300.0
MH_REPLICATED_PACK_MS = (20.5, 23.0)  # the single-host replicated mesh's pack_sharded a step (PERF.md §5)


def host_list(mine, world):
    """A file list whose every rank's stripe (``[rank::world]``) is
    ``mine``: each rank hands its dataset its own list."""
    return [f for f in mine for _ in range(world)]


_PORTS_GIVEN = set()
_PORTS_LOCK = threading.Lock()


def _ports(n):
    """``n`` free loopback ports for TcpTransport listeners, each handed
    out once a run. They are drawn below the kernel's ephemeral range: a
    port that ``bind(0)`` picked and closed can be taken, before its
    listener binds it, by any outbound connection of the run (the gloo
    worlds' pairs run beside the elastic days), while a port below the
    range is never assigned by the kernel. A rejoining rank re-binds its
    own endpoint, which stays safe for the same reason."""
    import random
    import socket

    lo = 32768
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        pass
    first = max(1024, lo - 12000)
    if lo - first < 1000:
        raise RuntimeError(f"no port range below the ephemeral range, which starts at {lo}")
    rng = random.Random(os.getpid())
    ports = []
    with _PORTS_LOCK:
        for _ in range(50 * n):
            if len(ports) == n:
                break
            p = rng.randrange(first, lo)
            if p in _PORTS_GIVEN:
                continue
            with socket.socket() as s:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                try:
                    s.bind(("127.0.0.1", p))
                except OSError:
                    continue
            _PORTS_GIVEN.add(p)
            ports.append(p)
    if len(ports) < n:
        raise RuntimeError(f"found {len(ports)} of {n} free ports in [{first}, {lo})")
    return ports


class _HostPlaneMeter:
    """Wall seconds of a transport's rounds, by kind (``ws-`` tags: the
    key exchange; the rest: the lockstep), since ``reset`` and since the
    start (``total``), and every ``allreduce_max``'s result by tag
    (patched onto one rank's transport)."""

    def __init__(self, tp):
        self.reset()
        self.results = {}
        self.total = {"exchange_s": 0.0, "lockstep_s": 0.0}
        a2a, arm = tp.alltoall, tp.allreduce_max

        def alltoall(payloads, tag, timeout=None):
            t0 = time.perf_counter()
            out = a2a(payloads, tag, timeout)
            key = "exchange_s" if tag.startswith("ws-") else "lockstep_s"
            setattr(self, key, getattr(self, key) + time.perf_counter() - t0)
            self.total[key] += time.perf_counter() - t0
            self.rounds += 1
            return out

        def allreduce_max(value, tag, timeout=None):
            out = arm(value, tag, timeout)
            self.results.setdefault(tag, []).append(int(out))
            return out

        tp.alltoall, tp.allreduce_max = alltoall, allreduce_max

    def reset(self):
        self.exchange_s, self.lockstep_s, self.rounds = 0.0, 0.0, 0


def _owner_ids(plan, rp, cfg, idx, shard, dev):
    """The ids this rank's owner kernels see in one step: its request
    buckets for ``idx`` (built on the card), all-to-all'd, give the pull's
    received ids; the merge gathers each distinct one (then row 0) and
    writes it back (then R, which writes nothing)."""
    from paddlebox_tpu_torch.train import build_mesh_device_batch

    req = build_mesh_device_batch(rp, cfg, idx, rp.ws.n_mesh_shards, rp.ws.capacity)["req_ranks"]
    recv = plan.all_to_all(req).reshape(-1)
    uniq = torch.unique(recv)
    tail = recv.numel() - uniq.numel()
    return {
        "pull": recv,
        "merge_old": torch.cat([uniq, torch.zeros(tail, dtype=uniq.dtype, device=dev)]),
        "merge_write": torch.cat([uniq.long(), torch.full((tail,), shard.shape[0], dtype=torch.long, device=dev)]),
    }


def _owner_check(ck, shard, owner, what):
    """Both kernels bitwise against their plain versions at the owner's ids."""
    what = f"{what} owner R={shard.shape[0]} U={owner['pull'].numel()}"
    return max(check_gather(ck, shard, owner["pull"], what + " pull ids"),
               check_gather(ck, shard, owner["merge_old"], what + " merge old-row ids"),
               check_write(ck, shard, owner["merge_write"], ck.pull_rows_ref(shard, owner["merge_old"]) + 0.5,
                           what + " merge writeback ids"))


def _mh_context(plan, spec):
    """(transport, meter, layout, sparse config, dataset maker, trainer
    maker) of one host process: its node of the host plane, on its own
    endpoint."""
    from paddlebox_tpu_torch.data import BoxPSDataset
    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.parallel.transport import TcpShuffleRouter, TcpTransport
    from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
    from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp = TcpTransport(plan.rank, spec["endpoints"], timeout=MH_TIMEOUT_S)
    meter = _HostPlaneMeter(tp)
    lay = ValueLayout(embedx_dim=EMBEDX_DIM)
    sparse_opt = SparseOptimizerConfig(embedx_threshold=0.0)

    def dataset(mine, batch, date, schema=None, shuffle="none"):
        table = HostSparseTable(lay, sparse_opt, n_shards=64, seed=spec["seed"])
        ds = BoxPSDataset(schema or bench_schema(), table, batch_size=batch, n_mesh_shards=plan.world,
                          rank=plan.rank, nranks=plan.world, shuffle_mode=shuffle, seed=spec["seed"],
                          transport=tp, router=TcpShuffleRouter(tp))
        ds.set_filelist(host_list(mine, plan.world))
        ds.set_date(date)
        return ds, table

    def trainer(batch, hidden=HIDDEN, dense_opt=None, **cfg_kw):
        cfg = TrainStepConfig(num_slots=NUM_SLOTS, batch_size=batch, layout=lay, sparse_opt=sparse_opt,
                              auc_buckets=100_000, **cfg_kw)
        model = DeepFM(NUM_SLOTS, lay.pull_width, lay.embedx_dim, hidden=hidden,
                       generator=torch.Generator().manual_seed(spec["seed"]))
        t = CTRTrainer(model, cfg, dense_opt=dense_opt or Adam(1e-3), plan=plan)
        t.init_params()
        return t

    return tp, meter, lay, sparse_opt, dataset, trainer


def _mh_pass(plan, meter, name, fn, k=None):
    """Run one pass's training: wall, launches (every kernel count from 0),
    host-plane seconds and transport bytes; ``k`` steps: 2 gathers and 1
    writeback a step, checked."""
    from paddlebox_tpu_torch.ops import cuda_kernels as ck
    from paddlebox_tpu_torch.utils.monitor import STAT_GET

    dev = plan.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ck.reset_launch_counts()
    meter.reset()
    b0 = STAT_GET("wire.host_bytes_sent")
    t0 = time.perf_counter()
    out, losses = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = dict(ck.launch_counts)
    if k is not None and dev.type == "cuda" and (counts["pull_rows_cuda"] != 2 * k or counts["write_rows_cuda"] != k):
        raise AssertionError(f"multihost rank {plan.rank} {name}: launches {counts} for {k} steps")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"multihost rank {plan.rank} {name}: non-finite loss {losses.tolist()}")
    return out, losses, {"wall_s": wall, "counts": counts, "lockstep_s": meter.lockstep_s,
                         "exchange_s": meter.exchange_s, "rounds": meter.rounds,
                         "host_bytes_sent": STAT_GET("wire.host_bytes_sent") - b0}


def _pass_mark(meter):
    """The host plane's totals now: (transport bytes sent, round seconds)."""
    from paddlebox_tpu_torch.utils.monitor import STAT_GET

    return STAT_GET("wire.host_bytes_sent"), dict(meter.total)


def _pass_plane(meter, mark):
    """A whole pass's host plane since ``mark``: the bytes it sent (the
    shuffle, the key exchange, the lockstep) and its rounds' seconds."""
    b, t = _pass_mark(meter)
    return {"host_bytes_sent": b - mark[0], **{k: v - mark[1][k] for k, v in t.items()}}


def _steps(t, data, k, **kw):
    losses = []
    out = t.train_pass(data, n_batches=k, on_batch=lambda i, m: losses.append(m["loss"]), **kw)
    return out, torch.stack(losses).cpu()


def _layout_dump(ws, table, arrays, prefix):
    """A pass's layout and this host's table after end_pass."""
    arrays[f"{prefix}_sorted_keys"] = ws.sorted_keys
    arrays[f"{prefix}_rows"] = ws.row_of_sorted
    table.drain_pending()
    arrays[f"{prefix}_host_keys"] = np.sort(table.keys())


def multihost_rank(plan, spec):
    """Phase 15 on one host of the two-host world (spawned, one process a
    host, gloo on cuda:0): the resident, packer and ZeRO-1 passes, the
    ins_id shuffle pass, two carried passes, the join day, then the small
    config the CPU world repeats. Checks what a host can check alone and
    writes the rest to ``spec["out"]``; every transport closes in a
    ``finally``."""
    from paddlebox_tpu_torch.fleet import Zero1Optimizer
    from paddlebox_tpu_torch.models import DeepFM, RankDeepFM
    from paddlebox_tpu_torch.ops import cuda_kernels as ck
    from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig

    n, r, dev = plan.world, plan.rank, plan.device
    b = BATCH // n
    tp, meter, lay, sparse_opt, dataset, trainer = _mh_context(plan, spec)
    res, arrays = {"rank": r, "world": n}, {}
    try:
        # the main path: the striped pass, its key exchange, 32 resident steps
        ds, table = dataset(spec["files"][r], b, "20260301")
        mark = _pass_mark(meter)
        t0 = time.perf_counter()
        ds.load_into_memory()
        res["load_into_memory_s"] = time.perf_counter() - t0
        res["num_batches"] = ds.num_batches()
        t0 = time.perf_counter()
        ds.begin_pass(round_to=512)
        res.update(begin_pass_s=time.perf_counter() - t0, exchange_s=ds.ws.exchange_s, cap=ds.ws.capacity,
                   n_keys=ds.ws.n_keys, n_owned=int(sum(len(k) for k in ds.ws.owned_shard_keys)))
        ws = ds.ws
        tr = trainer(b)
        tr.prepare_pass(ds, n_batches=MH_TIMED)
        res["prepare_pass_s"] = tr.last_prepare_s
        tr.train_pass(ds, n_batches=MH_WARM)
        out, losses, res["resident"] = _mh_pass(plan, meter, "resident", lambda: _steps(tr, ds, MH_TIMED), MH_TIMED)
        if tr.last_feed != "resident":
            raise AssertionError(f"multihost rank {r}: the main pass took the {tr.last_feed} feed")
        rp = tr._resident_cache[2]
        res.update(resident_loss=out["loss"], auc=out["auc"], L_pad=rp.L_pad, K_pad=rp.K_pad,
                   resident_losses=losses.tolist())
        shard = tr._state.table
        owner = _owner_ids(plan, rp, tr.cfg, tr._idx_cache[2][0], shard, dev)
        res["kernel_err"] = _owner_check(ck, shard, owner, f"multihost 2 hosts rank {r}")
        res["owner_R"] = shard.shape[0]
        arrays.update({f"owner_{k}": v.cpu().numpy() for k, v in owner.items()})

        # 8 packer steps, and the pack of this host's batch alone
        with flags(enable_resident_feed=0):
            tr.prepare_pass(ds, n_batches=MH_PACKER)
            _, _, res["packer"] = _mh_pass(plan, meter, "packer", lambda: _steps(tr, ds, MH_PACKER), MH_PACKER)
            if tr.last_feed != "packer":
                raise AssertionError(f"multihost rank {r}: the packer pass took the {tr.last_feed} feed")
            packer = tr._packer_cache[2]
            idx = list(ds.batch_indices(MH_PACKER))
            t0 = time.perf_counter()
            for blk in idx:
                packer.pack_sharded(blk, 1)
            res.update(pack_ms_per_step=(time.perf_counter() - t0) / len(idx) * 1e3, packer_K=packer._K_pad,
                       packer_L=packer._L_pad)

        # ZeRO-1, 8 steps from the trained table
        tr.handoff_table(ds)
        ztr = trainer(b, dense_opt=Zero1Optimizer(Adam(1e-3), n_dev=n))
        _, zl, res["zero"] = _mh_pass(plan, meter, "zero1", lambda: _steps(ztr, ds, MH_ZERO), MH_ZERO)
        res["zero_losses"] = zl.tolist()
        t0 = time.perf_counter()
        ds.end_pass(ztr.trained_table(), shrink=False)
        res["end_pass_s"] = time.perf_counter() - t0
        res["main_pass_plane"] = _pass_plane(meter, mark)
        _layout_dump(ws, table, arrays, "main")
        del tr, ztr, ds, ws, rp, shard, owner

        # the ins_id shuffle over TcpShuffleRouter, 9 files against 7: the
        # short host wraps around the all-reduced batch count
        from paddlebox_tpu_torch.data import SlotInfo, SlotSchema

        ins_schema = SlotSchema([SlotInfo("label", type="float", dense=True, dim=1)]
                                + [SlotInfo(f"s{i}") for i in range(NUM_SLOTS)], label_slot="label", parse_ins_id=True)
        ds, table = dataset(spec["shuffle_files"][r], b, "20260302", schema=ins_schema, shuffle="ins_id")
        mark = _pass_mark(meter)
        t0 = time.perf_counter()
        ds.load_into_memory()
        res["shuffle_load_s"] = time.perf_counter() - t0
        nb = ds.num_batches()
        ds.begin_pass(round_to=512)
        st = trainer(b)
        st.prepare_pass(ds)
        _, _, res["shuffle"] = _mh_pass(plan, meter, "shuffle", lambda: _steps(st, ds, None), nb)
        res.update(shuffle_records=ds.memory_data_size(), shuffle_local_batches=ds.memory_data_size() // b,
                   shuffle_batches=nb, shuffle_feed=st.last_feed)
        ds.end_pass(st.trained_table(), shrink=False)
        res["shuffle_pass_plane"] = _pass_plane(meter, mark)
        del st, ds

        # two carried passes of 2 overlapping files a host, one dataset
        # (its carrier lives there) and one host table
        car = {}
        ctr = trainer(b)
        ds, table = dataset(spec["carried_files"][0][r], b, "20260303")
        for p, files in enumerate(spec["carried_files"]):
            if p:
                ds.set_filelist(host_list(files[r], n))
                ds.set_date(f"2026030{3 + p}")
            ds.load_into_memory()
            t0 = time.perf_counter()
            ds.begin_pass(round_to=512)
            boundary_s = time.perf_counter() - t0
            k = ds.num_batches()
            ctr.prepare_pass(ds)
            _, _, run = _mh_pass(plan, meter, f"carried pass {p + 1}", lambda: _steps(ctr, ds, k), k)
            run.update(begin_pass_s=boundary_s, splice=ds.ws.boundary_stats, steps=k)
            t0 = time.perf_counter()
            ds.end_pass(ctr.trained_table_device())
            run["end_pass_s"] = time.perf_counter() - t0
            car[f"pass{p + 1}"] = run
        if car["pass2"]["splice"] is None or car["pass2"]["splice"]["common"] == 0:
            raise AssertionError(f"multihost rank {r}: the second pass did not splice the carried block")
        t0 = time.perf_counter()
        car["flush_keys"] = ds.flush_carried()
        car["flush_s"] = time.perf_counter() - t0
        res["carried"] = car
        del ctr, ds

        # the join day: one join epoch and the update epoch, 3 files against 1
        ds, table = dataset(spec["pv_files"][r], b, "20260305", schema=pv_schema())
        ds.load_into_memory()
        ds.begin_pass(round_to=512)
        ds.set_current_phase(1)
        res["pvs"] = ds.preprocess_instance(max_rank=MAX_RANK)
        res["local_pv_batches"] = ds.num_pv_batches(n_devices=1)
        g = torch.Generator().manual_seed(spec["seed"])
        model = RankDeepFM(DeepFM(NUM_SLOTS, lay.pull_width, lay.embedx_dim, hidden=HIDDEN, generator=g),
                           NUM_SLOTS * lay.pull_width, max_rank=MAX_RANK, generator=g)
        jcfg = TrainStepConfig(num_slots=NUM_SLOTS, batch_size=b, layout=lay, sparse_opt=sparse_opt,
                               auc_buckets=100_000, model_takes_rank_offset=True)
        jtr = CTRTrainer(model, jcfg, dense_opt=Adam(1e-3), plan=plan)
        jtr.init_params()
        jout, _, res["join"] = _mh_pass(plan, meter, "join", lambda: _steps(jtr, ds, None))
        res.update(join_batches=jout["batches"], join_ins=jout["ins_num"], join_feed=jtr.last_feed)
        jtr.handoff_table(ds)
        ds.set_current_phase(0)
        ds.postprocess_instance()
        utr = CTRTrainer(model, dataclasses.replace(jcfg, model_takes_rank_offset=False), dense_opt=Adam(1e-3),
                         plan=plan)
        utr.params = {k: v.clone() for k, v in jtr.params.items()}
        utr.opt_state = utr.dense_opt.init(utr.params)
        uout, _, res["update"] = _mh_pass(plan, meter, "update", lambda: _steps(utr, ds, None))
        res.update(update_batches=uout["batches"], update_feed=utr.last_feed)
        ds.end_pass(utr.trained_table(), shrink=False)
        del jtr, utr, ds, model

        res["small"], small_arrays = multihost_small(plan, spec, (tp, meter, lay, sparse_opt, dataset, trainer))
        arrays.update(small_arrays)
        res["allreduce_results"] = meter.results
    finally:
        tp.close()
    np.savez(os.path.join(spec["out"], f"rank{r}.npz"), **arrays)
    with open(os.path.join(spec["out"], f"rank{r}.json"), "w") as f:
        json.dump(res, f)


def multihost_small(plan, spec, ctx=None):
    """The small config on this world's device (the card, or the CPU):
    2 files a host, a 256-record global batch, a (32, 16) tower, 4
    resident steps, over the host's context (``_mh_context``; its own when
    None). Returns (the losses, {every 16th owned key, its trained row})."""
    own = ctx is None
    tp, _, _, _, dataset, trainer = _mh_context(plan, spec) if own else ctx
    try:
        b = MH_SMALL_BATCH // plan.world
        ds, table = dataset(spec["small_files"][plan.rank], b, "20260306")
        ds.load_into_memory()
        ds.begin_pass(round_to=512)
        tr = trainer(b, hidden=MH_SMALL_HIDDEN)
        _, losses = _steps(tr, ds, MH_SMALL_STEPS)
        if tr.last_feed != "resident":
            raise AssertionError(f"multihost small: the {tr.last_feed} feed")
        # this host's one shard: its owned keys sit at rows 0.. in key order
        owned, block = ds.ws.owned_shard_keys[0], tr.trained_table()[0]
        pick = np.arange(0, len(owned), MESH_KEY_STRIDE)
        ds.end_pass(None)
        return {"losses": losses.tolist()}, {"small_keys": owned[pick], "small_rows": block[pick]}
    finally:
        if own:
            tp.close()


def multihost_cpu_rank(plan, spec):
    """The small config on the CPU: the reference of the card's."""
    r = plan.rank
    res, arrays = multihost_small(plan, spec)
    np.savez(os.path.join(spec["out"], f"rank{r}.npz"), **arrays)
    with open(os.path.join(spec["out"], f"rank{r}.json"), "w") as f:
        json.dump({"small": res}, f)


def multihost_four_rank(plan, spec):
    """The four-host world: the striped pass's key exchange and 8
    resident steps at a 1024-record host batch."""
    from paddlebox_tpu_torch.ops import cuda_kernels as ck

    n, r, dev = plan.world, plan.rank, plan.device
    b = BATCH // n
    tp, meter, lay, sparse_opt, dataset, trainer = _mh_context(plan, spec)
    res, arrays = {"rank": r, "world": n}, {}
    try:
        ds, table = dataset(spec["files"][r], b, "20260301")
        mark = _pass_mark(meter)
        ds.load_into_memory()
        res["num_batches"] = ds.num_batches()
        t0 = time.perf_counter()
        ds.begin_pass(round_to=512)
        res.update(begin_pass_s=time.perf_counter() - t0, exchange_s=ds.ws.exchange_s, cap=ds.ws.capacity)
        ws = ds.ws
        tr = trainer(b)
        tr.prepare_pass(ds, n_batches=MH_FOUR)
        tr.train_pass(ds, n_batches=RESIDENT_K)  # warm
        out, losses, res["resident"] = _mh_pass(plan, meter, "resident", lambda: _steps(tr, ds, MH_FOUR), MH_FOUR)
        if tr.last_feed != "resident":
            raise AssertionError(f"multihost four rank {r}: the {tr.last_feed} feed")
        rp = tr._resident_cache[2]
        res.update(resident_losses=losses.tolist(), auc=out["auc"], L_pad=rp.L_pad, K_pad=rp.K_pad)
        shard = tr._state.table
        owner = _owner_ids(plan, rp, tr.cfg, tr._idx_cache[2][0], shard, dev)
        res["kernel_err"] = _owner_check(ck, shard, owner, f"multihost 4 hosts rank {r}")
        res["owner_R"] = shard.shape[0]
        arrays.update({f"owner_{k}": v.cpu().numpy() for k, v in owner.items()})
        ds.end_pass(tr.trained_table(), shrink=False)
        res["main_pass_plane"] = _pass_plane(meter, mark)
        _layout_dump(ws, table, arrays, "main")
        res["allreduce_results"] = meter.results
    finally:
        tp.close()
    np.savez(os.path.join(spec["out"], f"rank{r}.npz"), **arrays)
    with open(os.path.join(spec["out"], f"rank{r}.json"), "w") as f:
        json.dump(res, f)


class _StubRows:
    """A row source of zeros: a PassWorkingSet's layout without a table."""

    def __init__(self, layout):
        self.layout = layout

    def pull_or_create(self, keys):
        return np.zeros((len(keys), self.layout.width), np.float32)


def _mh_layout_check(ranks, lay, what):
    """The hosts' key sets are disjoint, their union the pass's referenced
    keys, and every host's rows and capacity a single-process
    PassWorkingSet's over the same keys, exactly."""
    from paddlebox_tpu_torch.table import PassWorkingSet

    n = len(ranks)
    host = [rk["main_host_keys"] for rk in ranks]
    for a in range(n):
        for b in range(a + 1, n):
            if len(np.intersect1d(host[a], host[b])):
                raise AssertionError(f"{what}: hosts {a} and {b} hold common keys")
    referenced = np.unique(np.concatenate([rk["main_sorted_keys"] for rk in ranks]))
    if not np.array_equal(np.sort(np.concatenate(host)), referenced):
        raise AssertionError(f"{what}: the hosts' keys are not the pass's referenced keys")
    pws = PassWorkingSet(n_mesh_shards=n)
    pws.add_keys(referenced)
    pws.finalize(_StubRows(lay), round_to=512)
    for r, rk in enumerate(ranks):
        if rk["cap"] != pws.capacity:
            raise AssertionError(f"{what}: host {r}'s capacity {rk['cap']} != {pws.capacity}")
        if not np.array_equal(rk["main_rows"], pws.lookup(rk["main_sorted_keys"]).astype(np.int64)):
            raise AssertionError(f"{what}: host {r}'s rows differ from the single-process working set's")
    return len(referenced)


def _mh_counters_check(ranks, what):
    """Every host saw the same value of every all-reduced count."""
    ref = ranks[0]["allreduce_results"]
    for r, rk in enumerate(ranks[1:], 1):
        if rk["allreduce_results"] != ref:
            raise AssertionError(f"{what}: host {r}'s all-reduced counts differ from host 0's")
    return sorted(ref)


def multihost_phase(args, dev, card, ck, lay):
    """Phase 15: the two-host world (the multi-host day and the small
    config), the CPU world of the small config and the four-host world,
    each a spawn of host processes with their own TcpTransport endpoints
    on 127.0.0.1. Returns (launch counts by path, the kernels' numbers at
    the owner shapes, the max abs error)."""
    from paddlebox_tpu_torch.fleet.launch import spawn

    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + MH_SEED)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multihost_") as tmp:
        t0 = time.perf_counter()
        files, pool = write_bench_files(tmp, rng, N_FILES, "mh")
        ins_files, _ = write_bench_files(tmp, rng, sum(MH_SHUFFLE_FILES), "mhins", ins_ids=True)
        car2, _ = write_bench_files(tmp, rng, 2 * MH_CARRIED_FILES, "mhcar", reuse_pool=pool)
        pv_files, _ = write_bench_files(tmp, rng, sum(MH_PV_FILES), "mhpv", pv=True)
        write_s = time.perf_counter() - t0

        def stripes(fs, n):
            return [fs[r::n] for r in range(n)]

        s0 = MH_SHUFFLE_FILES[0]
        car1 = files[: 2 * MH_CARRIED_FILES]
        spec2 = {
            "seed": args.seed + MH_SEED, "files": stripes(files, 2),
            "shuffle_files": [ins_files[:s0], ins_files[s0:]],
            "carried_files": [stripes(car1, 2), stripes(car2, 2)],
            "pv_files": [pv_files[: MH_PV_FILES[0]], pv_files[MH_PV_FILES[0]:]],
            "small_files": stripes(files[: 2 * MH_SMALL_FILES], 2),
        }
        worlds = {}
        for name, world, device, fn in (("two_hosts", 2, "cuda:0", multihost_rank),
                                        ("cpu", 2, "cpu", multihost_cpu_rank),
                                        ("four_hosts", 4, "cuda:0", multihost_four_rank)):
            out = os.path.join(tmp, name)
            os.makedirs(out)
            spec = dict(spec2, out=out, endpoints=[f"127.0.0.1:{p}" for p in _ports(world)])
            if world == 4:
                spec["files"] = stripes(files, 4)
            t0 = time.perf_counter()
            spawn(fn, world, f"file://{tmp}/rdv-{name}", backend="gloo", device=device, args=(spec,),
                  timeout_s=MH_TIMEOUT_S)
            worlds[name] = (_read_ranks(out, world), time.perf_counter() - t0)

        two, two_wall = worlds["two_hosts"]
        four, four_wall = worlds["four_hosts"]
        counts, nums = {}, {"write_files_s": write_s}
        for name, ranks, wall in (("two_hosts", two, two_wall), ("four_hosts", four, four_wall)):
            what = f"multihost {name}"
            n_ref = _mh_layout_check(ranks, lay, what)
            tags = _mh_counters_check(ranks, what)
            k = MH_TIMED if name == "two_hosts" else MH_FOUR
            b = BATCH // len(ranks)
            walls = [rk["resident"]["wall_s"] for rk in ranks]
            nums[name] = {
                "hosts": len(ranks), "spawn_wall_s": wall, "referenced_keys": n_ref, "cap": ranks[0]["cap"],
                "samples_per_s_host": [b * k / w for w in walls], "ms_per_step_host": [w / k * 1e3 for w in walls],
                "samples_per_s_global": BATCH * k / max(walls),
                "exchange_s_host": [rk["exchange_s"] for rk in ranks],
                "begin_pass_s_host": [rk["begin_pass_s"] for rk in ranks],
                "resident_lockstep_s_host": [rk["resident"]["lockstep_s"] for rk in ranks],
                "pass_plane_host": [rk["main_pass_plane"] for rk in ranks],
                "num_batches": ranks[0]["num_batches"], "L_pad": ranks[0]["L_pad"], "K_pad": ranks[0]["K_pad"],
                "allreduce_tags": tags, "resident_losses": ranks[0]["resident_losses"],
            }
            counts[f"multihost_{name}"] = {kn: sum(rk["resident"]["counts"][kn] for rk in ranks)
                                            for kn in KERNEL_NAMES}
            print(f"multihost {name}: {len(ranks)} host processes on cuda:0, each its own TcpTransport; keys "
                  f"disjoint, their union the {n_ref} referenced keys, every host's rows the single-process working "
                  f"set's exactly; all-reduced counts alike on every host ({len(tags)} tags); {k} resident steps "
                  f"a host at {nums[name]['samples_per_s_global']:.0f} samples/s; {card}", flush=True)
        for path in ("packer", "zero", "shuffle", "join", "update"):
            counts[f"multihost_{path}"] = {kn: sum(rk[path]["counts"][kn] for rk in two)
                                          for kn in KERNEL_NAMES}
        counts["multihost_carried"] = {kn: sum(rk["carried"][p]["counts"][kn] for rk in two for p in ("pass1", "pass2"))
                                       for kn in KERNEL_NAMES}

        # the lockstep: the shuffle's short host wraps, the join day's ghosts
        sb = [rk["shuffle_batches"] for rk in two]
        local = [rk["shuffle_local_batches"] for rk in two]
        if len(set(sb)) != 1 or sb[0] != max(local) or sum(rk["shuffle_records"] for rk in two) != \
                sum(MH_SHUFFLE_FILES) * RECORDS_PER_FILE:
            raise AssertionError(f"multihost shuffle: batches {sb}, local {local}")
        jb = [rk["join_batches"] for rk in two]
        lp = [rk["local_pv_batches"] for rk in two]
        if len(set(jb)) != 1 or jb[0] != max(lp) or lp[0] == lp[1]:
            raise AssertionError(f"multihost join: batches {jb}, local pv batches {lp}")
        if len({rk["join_ins"] for rk in two}) != 1 or two[0]["join_ins"] != sum(MH_PV_FILES) * RECORDS_PER_FILE:
            raise AssertionError(f"multihost join: instances {[rk['join_ins'] for rk in two]}")
        for rk in two:
            if (rk["shuffle_feed"], rk["join_feed"], rk["update_feed"]) != ("resident", "resident_pv", "resident"):
                raise AssertionError(f"multihost: feeds {rk['shuffle_feed']}, {rk['join_feed']}, {rk['update_feed']}")

        # the card against the CPU at the small config
        cpu = worlds["cpu"][0]
        keys = np.concatenate([rk["small_keys"] for rk in cpu])
        order = np.argsort(keys)
        ref_rows = np.concatenate([rk["small_rows"] for rk in cpu])[order]
        tab_d, loss_d = _mesh_compare(
            "multihost two hosts, card vs CPU", two[0]["small"]["losses"],
            np.concatenate([rk["small_rows"] for rk in two]), np.concatenate([rk["small_keys"] for rk in two]),
            cpu[0]["small"]["losses"], keys[order], ref_rows)
        print(f"multihost two hosts: the small config on cuda:0 within the mesh bounds of the same hosts on the CPU "
              f"(table {tab_d:.3g}, loss rel {loss_d:.3g}); {card}", flush=True)

        r0 = two[0]
        nums["two_hosts"].update({
            "packer_ms_per_step": [rk["packer"]["wall_s"] / MH_PACKER * 1e3 for rk in two],
            "pack_ms_per_step_host": [rk["pack_ms_per_step"] for rk in two],
            "replicated_pack_sharded_ms_per_step": list(MH_REPLICATED_PACK_MS),
            "packer_lockstep_s": [rk["packer"]["lockstep_s"] for rk in two],
            "zero_ms_per_step": [rk["zero"]["wall_s"] / MH_ZERO * 1e3 for rk in two],
            "zero_losses": r0["zero_losses"],
            "shuffle": {"records_host": [rk["shuffle_records"] for rk in two], "batches": sb[0],
                        "load_s_host": [rk["shuffle_load_s"] for rk in two],
                        "ms_per_step_host": [rk["shuffle"]["wall_s"] / sb[0] * 1e3 for rk in two]},
            "carried": [rk["carried"] for rk in two],
            "join": {"local_pv_batches": lp, "batches": jb[0], "instances": r0["join_ins"],
                     "join_s_host": [rk["join"]["wall_s"] for rk in two],
                     "update_s_host": [rk["update"]["wall_s"] for rk in two],
                     "lockstep_s_host": [rk["join"]["lockstep_s"] + rk["update"]["lockstep_s"] for rk in two]},
            "shuffle_pass_plane_host": [rk["shuffle_pass_plane"] for rk in two],
            "load_into_memory_s": [rk["load_into_memory_s"] for rk in two],
            "prepare_pass_s": [rk["prepare_pass_s"] for rk in two], "end_pass_s": [rk["end_pass_s"] for rk in two],
            "card_vs_cpu": {"table_max_abs": tab_d, "loss_max_rel": loss_d},
        })
        emit({"card": card, "phase": "multihost", **nums, "launches": counts})
        car = r0["carried"]
        plane = nums["two_hosts"]["pass_plane_host"]
        print(f"multihost two hosts: resident {nums['two_hosts']['ms_per_step_host']} ms a step a host, key exchange "
              f"{nums['two_hosts']['exchange_s_host']} s in finalize, lockstep rounds "
              f"{[x['lockstep_s'] for x in plane]} s and host bytes {[x['host_bytes_sent'] for x in plane]} over the "
              f"main pass (shuffle pass: {[x['host_bytes_sent'] for x in nums['two_hosts']['shuffle_pass_plane_host']]} "
              f"bytes); the carried boundary_s {car['pass1']['end_pass_s'] + car['pass2']['begin_pass_s']:.3f} s "
              f"(end_pass + the splicing begin_pass; the first pass's classic begin_pass "
              f"{car['pass1']['begin_pass_s']:.3f} s); "
              f"packing {nums['two_hosts']['pack_ms_per_step_host']} ms a step a host against the replicated mesh's "
              f"pack_sharded {MH_REPLICATED_PACK_MS[0]}-{MH_REPLICATED_PACK_MS[1]} ms; {card}", flush=True)

        # both kernels at the owners' shapes, timed here alone
        owner = {name: owner_kernel_rows(args, dev, card, ck, lay, ranks[0], f"multihost_{name}_owner",
                                         {"hosts": len(ranks)})
                 for name, ranks in (("two_hosts", two), ("four_hosts", four))}
        err = max(rk["kernel_err"] for rk in two + four)
    print(f"phase 15 (multihost) in {time.perf_counter() - t_phase:.3f} s; {card}", flush=True)
    return counts, owner, err


# ---- 16. the supervisor over two host processes, and the elastic day -------

SH_SEED = 16  # the phase's data seed offset
SH_FILES = 2  # a host a pass: 16384 records, 8 steps of 2048
SH_PASSES = 3  # a base and two deltas
SH_DATE = "20260401"
SH_POISON_FRAC = 0.02  # of rank 1's pass-2 lines: past max_bad_line_fraction (0.01)
SH_FAULT_PASS = 2  # the supervisor's pass_seq of pass 1
SH_TIMEOUT_S = 300.0
EL_MESH = 8  # mesh shards of the elastic day (tests/test_elastic.py's N_MESH)
EL_RECORDS = 40960  # records a pass: beside an H100 the schedules took 73 s at 65,536 and 56.5-60.8 s at 49,152; their bound is 60 s
EL_KEYS = 16  # bench.py's keys a record
EL_DATE = "20260402"
EL_MEMBER_TIMEOUT_S = 30.0
EL_PEER_DEAD_S = 2.0  # a rank silent this long is dead (the tests' 0.6 s, widened for the day's larger rounds)


def _state_digest(table, tr):
    """sha256 digests of a host's table (keys and rows), its dense params
    and Adam state, and its AUC tables."""
    table.drain_pending()
    keys = np.sort(table.keys())
    out = {}
    h = hashlib.sha256(keys.tobytes())
    h.update(np.ascontiguousarray(table.pull_or_create(keys)).tobytes())
    out["table"] = h.hexdigest()
    h = hashlib.sha256()
    for k in sorted(tr.params):
        h.update(tr.params[k].detach().cpu().numpy().tobytes())
    st = tr.opt_state
    h.update(st.count.cpu().numpy().tobytes())
    for part in (st.mu, st.nu):
        for k in sorted(part):
            h.update(part[k].cpu().numpy().tobytes())
    out["dense"] = h.hexdigest()
    auc = tr._state.auc
    out["auc"] = hashlib.sha256(auc.pos.cpu().numpy().tobytes() + auc.neg.cpu().numpy().tobytes()).hexdigest()
    out["keys"] = len(keys)
    return out


def _host_day_supervisor():
    """The port's PassSupervisor with the harness's clocks: each verdict
    round, each attempt, each revert and each save timed, a state digest
    after each pass, and an optional one-shot gate rejection at pass_seq
    ``reject_pass`` (the harness's fault, as the JAX tests drive the gate
    with a trainer double)."""
    from paddlebox_tpu_torch.train import PassSupervisor
    from paddlebox_tpu_torch.train.supervisor import PassRejected

    class HostDaySupervisor(PassSupervisor):
        reject_pass = None

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.after, self.saves, self.verdicts, self.attempts, self.reverts = [], [], [], [], []
            exchange = self.coord.exchange_verdict

            def timed(key, ok, detail="", fatal=False):
                t0 = time.perf_counter()
                out = exchange(key, ok, detail, fatal=fatal)
                self.verdicts.append([key, time.perf_counter() - t0])
                return out

            self.coord.exchange_verdict = timed

        def _attempt(self, n_batches, prefetch=None):
            t0 = time.perf_counter()
            try:
                out = super()._attempt(n_batches, prefetch)
                self.attempts.append([self._pass_seq, t0, time.perf_counter(), out.get("batches", 0.0)])
                return out
            except Exception:
                self.attempts.append([self._pass_seq, t0, time.perf_counter(), None])
                raise

        def _revert(self, attempt, cause):
            t0 = time.perf_counter()
            super()._revert(attempt, cause)
            self.reverts.append([self._pass_seq, t0, time.perf_counter()])

        def _gate(self, out):
            if self.reject_pass == self._pass_seq:
                self.reject_pass = None
                raise PassRejected("auc", "a one-shot rejection of the harness")
            super()._gate(out)

        def _save_checkpoint(self, mode):
            t0 = time.perf_counter()
            super()._save_checkpoint(mode)
            self.saves.append([mode, time.perf_counter() - t0])

        def run_pass(self, *a, **kw):
            out = super().run_pass(*a, **kw)
            self.after.append(_state_digest(self.table, self.tr))
            return out

    return HostDaySupervisor


def _host_day(plan, spec, ctx, name, reject_pass=None, before_last_end=None):
    """One supervised three-pass day on this host: its own table, dataset,
    trainer and chain under ``rank_root(<day root>, rank)``. Every
    train_pass is counted (a reverted attempt's steps launch the kernels
    too); ``before_last_end(trainer)`` runs just before the last pass's
    end_pass. Returns the day's record and the trainer."""
    from paddlebox_tpu_torch.ops import cuda_kernels as ck
    from paddlebox_tpu_torch.train import CheckpointManager, HealthGates, RetryPolicy
    from paddlebox_tpu_torch.train.checkpoint import rank_root

    tp, meter, lay, sparse_opt, dataset, trainer = ctx
    n, r, dev = plan.world, plan.rank, plan.device
    b = BATCH // n
    passes = spec["passes"][name][r]
    ds, table = dataset(passes[0], b, SH_DATE)
    tr = trainer(b)
    trained = []
    train_pass, end_pass = tr.train_pass, ds.end_pass

    def counted_train_pass(*a, **kw):
        out = train_pass(*a, **kw)
        trained.append(out["batches"])
        return out

    def hooked_end_pass(*a, **kw):
        if before_last_end is not None and sup._pass_seq == SH_PASSES:
            before_last_end(tr)
        return end_pass(*a, **kw)

    tr.train_pass, ds.end_pass = counted_train_pass, hooked_end_pass
    root = os.path.join(spec["out"], name)
    sup = _host_day_supervisor()(
        ds, tr, checkpoint=CheckpointManager(rank_root(root, r)), gates=HealthGates(auc_min_history=99),
        retry=RetryPolicy(backoff_s=0.0, sleep=lambda s: None), round_to=512, transport=tp,
        on_poisoned="skip_pass",
    )
    if r == 1:
        sup.reject_pass = reject_pass
    torch.cuda.synchronize(dev)
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    outs = sup.run_day(SH_DATE, [host_list(files, n) for files in passes])
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = dict(ck.launch_counts)
    steps = sum(trained)
    if counts["pull_rows_cuda"] != 2 * steps or counts["write_rows_cuda"] != steps:
        raise AssertionError(f"supervised host {r} {name}: launches {counts} for {steps} steps")
    failed = [a for a in sup.attempts if a[3] is None]
    rec = {
        "wall_s": wall, "counts": counts, "steps": steps, "epoch": sup.coord.epoch,
        "confirmed_steps": sum(o["batches"] for o in outs if o is not None),
        "incidents": [[i.kind, i.action, i.attempt, i.detail] for i in sup.incidents],
        "outs": [None if o is None else {"batches": o["batches"], "loss": o["loss"], "auc": o["auc"]} for o in outs],
        "after": sup.after, "saves": sup.saves, "verdicts": sup.verdicts,
        "failed_attempt_s": [sup.reverts[i][2] - a[1] for i, a in enumerate(failed)],
        "root": rank_root(root, r),
    }
    return rec, tr


def supervised_hosts_rank(plan, spec):
    """Phase 16 on one host of the two-host world (spawned, one process a
    host, gloo on cuda:0): the clean, the poisoned and the faulted
    supervised days, and both kernels at the owner's ids of the clean
    day's last pass. Writes its record to ``spec["out"]``; the transport
    closes in a ``finally``."""
    from paddlebox_tpu_torch.ops import cuda_kernels as ck
    from paddlebox_tpu_torch.table import SparseOptimizerConfig, ValueLayout
    from paddlebox_tpu_torch.utils import compilecache

    r, dev = plan.rank, plan.device
    ctx = _mh_context(plan, spec)
    tp = ctx[0]
    res, arrays, held = {"rank": r}, {}, {}

    def owner_ids(tr):
        # this host's request buckets all-to-all'd: a collective, at the
        # same point of the day on every host
        held["shard"] = tr._state.table
        held["owner"] = _owner_ids(plan, tr._resident_cache[2], tr.cfg, tr._idx_cache[2][0], held["shard"], dev)

    try:
        res["clean"], _ = _host_day(plan, spec, ctx, "clean", before_last_end=owner_ids)
        # the supervisor enabled <rank root>/compile_cache before this
        # process's first kernel launch: its libraries came through it
        res["compile_cache"] = {**compilecache.stats(), "nvcc_runs": ck.nvcc_runs()}
        res["kernel_err"] = _owner_check(ck, held["shard"], held["owner"], f"supervised hosts rank {r}")
        res["owner_R"] = held["shard"].shape[0]
        arrays.update({f"owner_{k}": v.cpu().numpy() for k, v in held.pop("owner").items()})
        held.clear()
        res["poison"], _ = _host_day(plan, spec, ctx, "poison")
        # last: its revert raises the transport's stale-epoch floor, which a
        # later day's dataset (its pass_epoch from 0) would fall under
        res["fault"], _ = _host_day(plan, spec, ctx, "fault", reject_pass=SH_FAULT_PASS)
        res["fault_chain_files"] = same_chain(res["clean"]["root"], res["fault"]["root"],
                                              ValueLayout(embedx_dim=EMBEDX_DIM),
                                              SparseOptimizerConfig(embedx_threshold=0.0), spec["seed"],
                                              f"supervised host {r}: the faulted day's chain")
    finally:
        tp.close()
    np.savez(os.path.join(spec["out"], f"rank{r}.npz"), **arrays)
    with open(os.path.join(spec["out"], f"rank{r}.json"), "w") as f:
        json.dump(res, f)


def _poisoned_copies(files, tmp, rng):
    """Copies of ``files`` with SH_POISON_FRAC of each file's lines made
    unparsable (a label that is no float), past the admission threshold."""
    out = []
    for path in files:
        with open(path) as f:
            lines = f.read().splitlines()
        bad = rng.choice(len(lines), int(len(lines) * SH_POISON_FRAC), replace=False)
        for i in bad:
            lines[i] = "1 not-a-float " + lines[i].split(" ", 2)[2]
        dst = os.path.join(tmp, "poisoned-" + os.path.basename(path))
        with open(dst, "w") as f:
            f.write("\n".join(lines) + "\n")
        out.append(dst)
    return out


def _check_host_days(ranks):
    """The faulted day bitwise the clean day, pass by pass; the poisoned
    day's pass 2 dropped on both hosts and its end bitwise the clean day's
    after pass 1; the incidents the JAX package's."""
    for r, rk in enumerate(ranks):
        clean, fault, poison = rk["clean"], rk["fault"], rk["poison"]
        if any(i for i in clean["incidents"]) or clean["epoch"] != 0:
            raise AssertionError(f"supervised host {r}: the clean day recorded {clean['incidents']}")
        want = [["gate_auc", "revert_retry", 0]] if r == 1 else [["peer_abort", "revert_retry", 0]]
        if [i[:3] for i in fault["incidents"]] != want or fault["epoch"] != 1 or len(fault["failed_attempt_s"]) != 1:
            raise AssertionError(f"supervised host {r}: the faulted day recorded {fault['incidents']}, "
                                 f"epoch {fault['epoch']}")
        if fault["after"] != clean["after"]:
            raise AssertionError(f"supervised host {r}: the faulted day's state differs from the clean day's "
                                 f"({fault['after']} vs {clean['after']})")
        if [o and o["auc"] for o in fault["outs"]] != [o and o["auc"] for o in clean["outs"]]:
            raise AssertionError(f"supervised host {r}: the faulted day's AUCs differ")
        if [i[:3] for i in poison["incidents"]] != [["data_poisoned", "skip", 0]] or poison["outs"][2] is not None:
            raise AssertionError(f"supervised host {r}: the poisoned day recorded {poison['incidents']}, "
                                 f"pass 2 {poison['outs'][2]}")
        if r == 0 and "rank 1" not in poison["incidents"][0][3]:
            raise AssertionError(f"supervised host 0: the poison verdict does not name rank 1: {poison['incidents']}")
        if poison["after"][2] != clean["after"][1] or poison["after"][:2] != clean["after"][:2]:
            raise AssertionError(f"supervised host {r}: the poisoned day does not end on the clean day's pass 1")


# ---- the elastic day on the host plane (threads of this process, no card) --


_EL_CACHE = {}


def _el_records(seed, p):
    """One pass's global records, the same for every membership: EL_KEYS
    of bench.py's keys a record (a quarter from the hot head, the rest
    uniform over KEY_SPACE) and a label, POS_FRAC positive."""
    key = (seed, p)
    if key not in _EL_CACHE:
        rng = np.random.default_rng(1000 * seed + p)
        hot = rng.integers(1, HOT_KEYS, (EL_RECORDS, EL_KEYS))
        cold = rng.integers(1, KEY_SPACE, (EL_RECORDS, EL_KEYS))
        keys = np.where(rng.random((EL_RECORDS, EL_KEYS)) < HOT_FRAC, hot, cold).astype(np.uint64)
        _EL_CACHE[key] = (keys, (rng.random(EL_RECORDS) < POS_FRAC).astype(np.float32))
    return _EL_CACHE[key]


class _RankKilled(BaseException):
    """A scheduled death: escapes every ``except Exception`` of the
    supervisor, as a process's death does."""


class _ElasticDS:
    """The dataset double of the JAX package's elastic tests over a real
    HostSparseTable and DistributedWorkingSet: record i of a pass goes to
    ``sorted(live)[i % n_live]``, so a pass's records do not depend on the
    membership."""

    def __init__(self, transport, table, seed):
        self.transport, self.table, self.seed = transport, table, seed
        self.n_mesh_shards = EL_MESH
        self.ownership = None
        self.pass_epoch = 0
        self._in_pass = False
        self.pass_idx = -1
        self.ws = self.dev = None

    def set_date(self, date):
        pass

    def set_filelist(self, files):
        self._files = list(files)

    def load_into_memory(self):
        self.pass_idx = int(self._files[0].rsplit("-", 1)[1])

    def omap(self):
        from paddlebox_tpu_torch.parallel.membership import OwnershipMap

        return self.ownership or OwnershipMap.even(self.n_mesh_shards, self.transport.n_ranks)

    def begin_pass(self, round_to=8, enable_revert=True, trainer=None):
        from paddlebox_tpu_torch.table.dist_ws import DistributedWorkingSet

        omap = self.omap()
        live = list(omap.live_ranks)
        keys, labels = _el_records(self.seed, self.pass_idx)
        mine = np.nonzero(np.arange(EL_RECORDS) % len(live) == live.index(self.transport.rank))[0]
        self.my_keys, self.my_labels = keys[mine], labels[mine]
        ws = DistributedWorkingSet(self.transport, EL_MESH, pass_id=self.pass_idx, epoch=self.pass_epoch,
                                   ownership=omap)
        ws.add_keys(self.my_keys.reshape(-1))
        self.dev = ws.finalize(self.table, round_to=8)
        self.ws = ws
        self._in_pass = True

    def end_pass(self, table, shrink=True):
        self.ws.writeback(self.dev)
        self._in_pass = False

    def revert_pass(self):
        # the rows were only created (seeded a key), never trained
        self.ws = self.dev = None
        self._in_pass = False
        self.pass_epoch += 1


def _elastic_trainer(ds, recorder, kill_at=None):
    """The trainer double: one deterministic transform of the pass's rows,
    and a pred a record from its rows' global positions. A doomed rank
    closes its transport and dies at the top of its kill pass."""

    def train_pass(_ds, n_batches=None):
        if kill_at is not None and ds.pass_idx == kill_at:
            ds.transport.close()
            raise _RankKilled()
        ds.dev = ds.dev * np.float32(1.01) + np.float32(0.25)
        rows = ds.ws.lookup(ds.my_keys.reshape(-1)).astype(np.int64).reshape(ds.my_keys.shape).sum(1)
        recorder[(ds.transport.rank, ds.pass_idx)] = (((rows + ds.pass_idx) % 97) / 97.0).astype(np.float32), \
            ds.my_labels
        return {"batches": 1.0, "nan_batches": 0.0, "auc": 0.5}

    return SimpleNamespace(
        params=None, prepare_pass=lambda _ds, n: None, train_pass=train_pass, trained_table=lambda: None,
        init_params=lambda *a, **k: None, load_dense=lambda path: None, drop_device_state=lambda: None,
        save_dense=lambda path: np.savez(path, z=np.zeros(1, np.float32)),
    )


def _elastic_supervisor(tp, root, seed, recorder, clocks, kill_at=None):
    from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig, ValueLayout
    from paddlebox_tpu_torch.train import CheckpointManager, ElasticConfig, HealthGates, PassSupervisor, RetryPolicy
    from paddlebox_tpu_torch.train.checkpoint import rank_root

    class ElasticSupervisor(PassSupervisor):
        """The port's supervisor, its membership rounds and admissions timed."""

        def _membership_round(self, e):
            t0 = time.perf_counter()
            super()._membership_round(e)
            clocks.append(("membership_round", tp.rank, time.perf_counter() - t0))

        def _admit_joiner(self, joiner, omap):
            t0 = time.perf_counter()
            out = super()._admit_joiner(joiner, omap)
            clocks.append(("admission", tp.rank, time.perf_counter() - t0))
            return out

        def _join_attempt(self, offer):
            t0 = time.perf_counter()
            out = super()._join_attempt(offer)
            clocks.append(("admission", tp.rank, time.perf_counter() - t0))
            return out

    table = HostSparseTable(ValueLayout(embedx_dim=EMBEDX_DIM), SparseOptimizerConfig(embedx_threshold=0.0),
                            n_shards=8, seed=0)
    ds = _ElasticDS(tp, table, seed)
    return ElasticSupervisor(
        ds, _elastic_trainer(ds, recorder, kill_at), checkpoint=CheckpointManager(rank_root(root, tp.rank)),
        gates=HealthGates(auc_min_history=99), retry=RetryPolicy(max_retries=2, backoff_s=0.0, sleep=lambda s: None),
        round_to=8, transport=tp,
        elastic=ElasticConfig(shared_root=root, member_timeout=EL_MEMBER_TIMEOUT_S),
    )


def _run_threads(fn, n, limit):
    """``fn(rank)`` on a thread a rank; every failure raised, and a rank
    still running after ``limit`` seconds a failure of its own."""
    import threading

    out, errs = [None] * n, []

    def body(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # re-raised below
            errs.append((r, e))

    ths = [threading.Thread(target=body, args=(r,), daemon=True) for r in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(limit)
    if any(t.is_alive() for t in ths):
        raise AssertionError(f"elastic day: a rank still ran after {limit} s")
    if errs:
        raise errs[0][1]
    return out


def _elastic_day(n, root, seed, passes, recorder, clocks, kill=None, rejoin=False):
    """One elastic day of ``n`` ranks in threads, each its own
    TcpTransport; ``kill`` = (rank, pass) dies at that pass's top, and with
    ``rejoin`` a new incarnation of it joins once every survivor installed
    the shrink. Returns (supervisors, results)."""
    from paddlebox_tpu_torch.parallel.transport import TcpTransport

    eps = [f"127.0.0.1:{p}" for p in _ports(n)]
    tps = [TcpTransport(r, eps, timeout=60.0) for r in range(n)]
    sups = [_elastic_supervisor(tps[r], root, seed, recorder, clocks,
                                kill_at=kill[1] if kill and kill[0] == r else None) for r in range(n)]
    files = [[f"pass-{p}"] for p in range(passes)]

    def day(r):
        if kill is None or r != kill[0]:
            return sups[r].run_day(EL_DATE, files)
        try:
            sups[r].run_day(EL_DATE, files)
        except _RankKilled:
            if not rejoin:
                return "killed"
        else:
            raise AssertionError(f"elastic day: rank {r} was not killed")
        deadline = time.monotonic() + 120.0
        while not all(sups[q].ds.ownership is not None and sups[q].ds.ownership.epoch >= 1
                      for q in range(n) if q != r):
            if time.monotonic() >= deadline:
                raise AssertionError("elastic day: the survivors never installed the shrink")
            time.sleep(0.02)
        tps[r] = TcpTransport(r, eps, timeout=60.0)
        sups[r] = _elastic_supervisor(tps[r], root, seed, recorder, clocks)
        return sups[r].join_day(files, timeout=120.0)

    try:
        res = _run_threads(day, n, 300.0)
    finally:
        for t in tps:
            t.close()
    return sups, res


def _merged_digest(sups, ranks):
    """The ownership-filtered digest: every key once, under its owner."""
    from paddlebox_tpu_torch.table.sparse_table import key_to_shard

    keys, rows = [], []
    for r in ranks:
        s = sups[r]
        lo, hi = s.ds.omap().range_of(r)
        k = np.sort(s.table.keys())
        sh = key_to_shard(k, EL_MESH)
        k = k[(sh >= lo) & (sh < hi)]
        keys.append(k)
        rows.append(s.table.pull_or_create(k))
    keys, rows = np.concatenate(keys), np.concatenate(rows)
    order = np.argsort(keys, kind="stable")
    if len(keys) != len(np.unique(keys)):
        raise AssertionError("elastic day: ownership ranges overlap")
    return keys[order], rows[order]


def _pass_auc(recorder, p):
    from paddlebox_tpu_torch.metrics.auc import auc_compute, auc_init, auc_update

    entries = [v for (r, pp), v in sorted(recorder.items()) if pp == p]
    preds = torch.from_numpy(np.concatenate([e[0] for e in entries]))
    labels = torch.from_numpy(np.concatenate([e[1] for e in entries]))
    return auc_compute(auc_update(auc_init(1000, device="cpu"), preds, labels))


def _timed_membership(clocks):
    """Adoptions and migrations timed (and their keys counted) while the
    schedules run: the supervisor calls them through the module."""
    from paddlebox_tpu_torch.parallel import membership

    adopt, migrate = membership.adopt_dead_shards, membership.migrate_ranges

    def adopt_timed(*a, **kw):
        t0 = time.perf_counter()
        out = adopt(*a, **kw)
        clocks.append(("adoption", a[5], time.perf_counter() - t0, int(out)))
        return out

    def migrate_timed(tp, *a, **kw):
        t0 = time.perf_counter()
        out = migrate(tp, *a, **kw)
        clocks.append(("migration", tp.rank, time.perf_counter() - t0, int(out["recv_keys"]), int(out["sent_keys"])))
        return out

    def restore():
        membership.adopt_dead_shards, membership.migrate_ranges = adopt, migrate

    membership.adopt_dead_shards, membership.migrate_ranges = adopt_timed, migrate_timed
    return restore


def elastic_schedules(args, tmp, card):
    """tools/chaos_probe.py's two elastic schedules through the port's
    supervisor on the host plane: kill-rank (4 ranks, rank 1 dies at pass
    1, 3 passes) against a fresh 3-rank run, and join-rank (rank 1 dies at
    pass 1 and a new incarnation rejoins, 5 passes) against a fresh 4-rank
    run; each bitwise (the ownership-filtered merged digest and every
    pass's AUC). Returns its numbers."""
    seed = args.seed + SH_SEED
    nums = {"records_a_pass": EL_RECORDS, "keys_a_record": EL_KEYS, "mesh_shards": EL_MESH}
    t_all = time.perf_counter()
    for name, n, passes, kill, rejoin, fresh_n in (("kill_rank", 4, 3, (1, 1), False, 3),
                                                  ("join_rank", 4, 5, (1, 1), True, 4)):
        clocks, rec, rec_f = [], {}, {}
        restore = _timed_membership(clocks)
        try:
            with flags(transport_peer_dead_s=EL_PEER_DEAD_S, transport_heartbeat_s=0.05):
                t0 = time.perf_counter()
                sups, res = _elastic_day(n, os.path.join(tmp, f"el-{name}"), seed, passes, rec, clocks, kill, rejoin)
                day_s = time.perf_counter() - t0
        finally:
            restore()
        live = list(range(n)) if rejoin else [r for r in range(n) if r != kill[0]]
        if not rejoin and res[kill[0]] != "killed":
            raise AssertionError(f"elastic {name}: rank {kill[0]} was not killed")
        for r in live:
            omap = sups[r].ds.ownership
            if omap is None or list(omap.live_ranks) != live or omap.epoch != (2 if rejoin else 1):
                raise AssertionError(f"elastic {name}: rank {r} ends on {omap}")
            if r != kill[0] and (len(res[r]) != passes or any(o is None for o in res[r])):
                raise AssertionError(f"elastic {name}: rank {r} trained {res[r]}")
        t0 = time.perf_counter()
        sups_f, res_f = _elastic_day(fresh_n, os.path.join(tmp, f"el-{name}-fresh"), seed, passes, rec_f, [])
        fresh_s = time.perf_counter() - t0
        ek, ev = _merged_digest(sups, live)
        fk, fv = _merged_digest(sups_f, list(range(fresh_n)))
        if not (np.array_equal(ek, fk) and np.array_equal(ev, fv)):
            raise AssertionError(f"elastic {name}: the merged digest differs from a fresh {fresh_n}-rank run")
        aucs = [_pass_auc(rec, p)["auc"] for p in range(passes)]
        if aucs != [_pass_auc(rec_f, p)["auc"] for p in range(passes)]:
            raise AssertionError(f"elastic {name}: the per-pass AUCs differ from the fresh run's")
        deaths = [i.detail for r in live if r != kill[0] for i in sups[r].incidents
                  if i.kind == "rank_death" and i.action == "revert_retry"]
        adopted = [c[3] for c in clocks if c[0] == "adoption"]
        nums[name] = {
            "ranks": n, "passes": passes, "day_s": day_s, "fresh_run_s": fresh_s, "merged_keys": len(ek),
            "aucs": aucs, "membership_round_s": [c[2] for c in clocks if c[0] == "membership_round"],
            "adoption_s": [c[2] for c in clocks if c[0] == "adoption"], "adopted_keys": adopted,
            "admission_s": [c[2] for c in clocks if c[0] == "admission"],
            "migration_s": [c[2] for c in clocks if c[0] == "migration"],
            "migrated_keys": [c[3] for c in clocks if c[0] == "migration"], "death_incidents": deaths,
        }
        print(f"elastic {name}: {n} ranks, {passes} passes of {EL_RECORDS} records, bitwise a fresh {fresh_n}-rank "
              f"run ({len(ek)} keys, every pass's AUC); membership rounds {nums[name]['membership_round_s']} s, "
              f"adoptions {nums[name]['adoption_s']} s of {sum(adopted)} keys, migrations "
              f"{nums[name]['migration_s']} s of {nums[name]['migrated_keys']} keys; the day {day_s:.3f} s "
              f"(host plane only, no card); {card}", flush=True)
    nums["schedules_s"] = time.perf_counter() - t_all
    return nums


def supervised_hosts_phase(args, dev, card, ck, lay):
    """Phase 16: the coordinated two-host day (a spawn of two host
    processes on cuda:0, each its own TcpTransport, under PassSupervisor)
    clean, poisoned and faulted, and beside it the elastic schedules on
    the host plane. Returns (launch counts by path, the kernels at the owner's
    shape, the max abs error)."""
    from paddlebox_tpu_torch.fleet.launch import spawn
    from paddlebox_tpu_torch.utils import compilecache

    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + SH_SEED)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_suphosts_") as tmp:
        t0 = time.perf_counter()
        groups, pool = [], None
        for p in range(SH_PASSES):
            fs, cold = write_bench_files(tmp, rng, 2 * SH_FILES, f"sh{p}", reuse_pool=pool)
            pool = cold if pool is None else pool
            groups.append([fs[r::2] for r in range(2)])
        poisoned = [list(g) for g in groups]
        poisoned[2] = [groups[2][0], _poisoned_copies(groups[2][1], tmp, rng)]
        write_s = time.perf_counter() - t0
        passes = {"clean": [[g[r] for g in groups] for r in range(2)],
                  "fault": [[g[r] for g in groups] for r in range(2)],
                  "poison": [[g[r] for g in poisoned] for r in range(2)]}
        out = os.path.join(tmp, "hosts")
        os.makedirs(out)
        spec = {"seed": args.seed + SH_SEED, "passes": passes, "out": out,
                "endpoints": [f"127.0.0.1:{p}" for p in _ports(2)]}
        # the elastic schedules (threads of this process, no card) run
        # beside the host processes; a failure there is raised after the spawn
        elastic = {}

        def schedules():
            try:
                elastic["nums"] = elastic_schedules(args, tmp, card)
            except BaseException as e:  # re-raised below
                elastic["error"] = e

        import threading

        el_thread = threading.Thread(target=schedules, name="elastic-schedules")
        el_thread.start()
        t0 = time.perf_counter()
        try:
            spawn(supervised_hosts_rank, 2, f"file://{tmp}/rdv-suphosts", backend="gloo", device="cuda:0",
                  args=(spec,), timeout_s=SH_TIMEOUT_S)
        finally:
            spawn_s = time.perf_counter() - t0
            el_thread.join(SH_TIMEOUT_S)
        if el_thread.is_alive():
            raise AssertionError(f"elastic schedules still ran after {SH_TIMEOUT_S} s")
        if "error" in elastic:
            raise elastic["error"]
        ranks = _read_ranks(out, 2)
        _check_host_days(ranks)
        counts = {f"supervised_hosts_{d}": {k: sum(rk[d]["counts"][k] for rk in ranks)
                                            for k in KERNEL_NAMES}
                  for d in ("clean", "fault", "poison")}
        nums = {"write_files_s": write_s, "spawn_wall_s": spawn_s}
        for d in ("clean", "fault", "poison"):
            walls = [rk[d]["wall_s"] for rk in ranks]
            verdicts = [rk[d]["verdicts"] for rk in ranks]
            nums[d] = {
                "wall_s_host": walls, "steps_host": [rk[d]["steps"] for rk in ranks],
                # the samples of confirmed passes over the day's wall
                "samples_per_s_global": sum(rk[d]["confirmed_steps"] for rk in ranks) * (BATCH // 2) / max(walls),
                "verdict_round_s_a_pass": [sum(v[1] for v in vs) / SH_PASSES for vs in verdicts],
                "verdict_rounds": [len(vs) for vs in verdicts],
                "saves_s_host": [rk[d]["saves"] for rk in ranks],
                "failed_attempt_s_host": [rk[d]["failed_attempt_s"] for rk in ranks],
                "aucs": [o and o["auc"] for o in ranks[0][d]["outs"]],
                "incidents_host": [[i[:3] for i in rk[d]["incidents"]] for rk in ranks],
            }
        nums["chain_files_compared"] = [rk["fault_chain_files"] for rk in ranks]
        nums["compile_cache_host"] = [rk["compile_cache"] for rk in ranks]
        if any(rk["compile_cache"]["nvcc_runs"] for rk in ranks):
            raise AssertionError(f"supervised hosts: a host ran nvcc: {nums['compile_cache_host']}")
        print("supervised hosts: each host's supervisor enabled <rank root>/compile_cache ('auto'); "
              + "; ".join(f"host {r}: requests {c['requests']}, misses {c['misses']}, hits {c['hits']}, entries "
                          f"{c['entries']}, nvcc runs 0"
                          for r, c in enumerate(nums["compile_cache_host"])) + f"; {card}", flush=True)
        print(f"supervised hosts: clean {nums['clean']['samples_per_s_global']:.0f} samples/s over both hosts, "
              f"faulted {nums['fault']['samples_per_s_global']:.0f}; the faulted attempt (its steps, the verdict "
              f"round and the revert) {nums['fault']['failed_attempt_s_host']} s a host; verdict rounds "
              f"{nums['clean']['verdict_round_s_a_pass']} s a pass a host; saves {nums['clean']['saves_s_host']}; "
              f"the faulted and the poisoned days bitwise their clean references; {card}", flush=True)
        owner = {"two_hosts": owner_kernel_rows(args, dev, card, ck, lay, ranks[0], "supervised_hosts_owner",
                                                {"hosts": 2})}
        err = max(rk["kernel_err"] for rk in ranks)
        nums["elastic"] = elastic["nums"]
        emit({"card": card, "phase": "supervised_hosts", **nums, "launches": counts})
    # the elastic schedules' supervisors enabled their roots' caches here
    compilecache.disable()
    print(f"phase 16 (supervised_hosts) in {time.perf_counter() - t_phase:.3f} s; {card}", flush=True)
    return counts, owner, err


# ---- 17. the serving fleet on the card ---------------------------------------

FL_SEED = 17  # the phase's data seed offset
FL_FILES = 2  # a pass: 16384 records; the base, then one delta
FL_REQUESTS = 300  # half at the base, half at delta 1
FL_DIRECT = 60  # of the base's requests, also sent to one ScoreServer directly (phase 5's measurement)
FL_MIN_RECORDS, FL_MAX_RECORDS = 256, BATCH
# the fleet shares this process with the whole script: a collector or GIL
# pause of a few seconds is no dead follower, so the view's horizon is wide
FL_FLAGS = dict(serve_health_beat_s=0.05, serve_health_dead_s=30.0, serve_client_retries=4,
                serve_client_backoff_s=0.02, serve_request_timeout_ms=60000.0, transport_heartbeat_s=0.05)
FL_HEDGE_MS = 100.0  # the hedge check's budget
FL_DIAG_STATS = ("serve.request_loop_errors", "serve.fleet_deaths", "serve.client_retries", "serve.late_responses",
                 "transport.reader_disconnects", "transport.heartbeat_errors", "transport.incarnation_resets",
                 "transport.frame_stalls")
FL_STALL_S = 1.5  # the stalled follower's delay, well past FL_HEDGE_MS


def _request(rng, keys, n):
    """A request of ``n`` records as ``make_records`` draws them: its
    slot-format lines (a label, then one key a slot) and the SlotRecords
    they parse to."""
    records = make_records(rng, keys, n)
    mat = np.stack([r.u64_values for r in records]).astype(str)
    labels = [f"1 {float(r.f_values[0])} 1 " for r in records]
    return [lb + " 1 ".join(row) for lb, row in zip(labels, mat.tolist())], records


def _split(preds, sizes):
    return np.split(preds, np.cumsum(sizes)[:-1])


def _wait(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() >= deadline:
            raise AssertionError(f"serve fleet: {what} within {timeout} s")
        time.sleep(0.02)


def serve_fleet_phase(args, dev, card, ck, lay, schema):
    """Phase 17: a FleetStage mirroring a full-width DeepFM chain (a base
    and one delta), two FleetFollowers on cuda:0 (each its own Follower,
    ScoreServer and Scorer) and a FleetClient on a third transport rank:
    FL_REQUESTS requests of 256-4096 records bitwise the trainer-direct
    scoring at the base and at delta 1, one gather a served batch; the
    hedge, drain and admit, the typed overload refusal and a torn stage
    fetch; the client's latencies beside one ScoreServer's on the first
    FL_DIRECT of the same requests, and the gather at the follower's
    shape. Returns (launch counts by path, the gather's numbers, its max
    abs error)."""
    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.parallel.transport import TcpTransport
    from paddlebox_tpu_torch.serve import (
        FleetClient, FleetFollower, FleetStage, Follower, ScoreServer, Scorer, ServeOverloadError, table_source,
    )
    from paddlebox_tpu_torch.serve.fleet import ServeRequestError
    from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig
    from paddlebox_tpu_torch.train import CheckpointManager, TrainStepConfig, read_watermark
    from paddlebox_tpu_torch.utils import faultinject as fault
    from paddlebox_tpu_torch.utils.monitor import STAT_GET

    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + FL_SEED)
    nums, counts = {}, {}
    stalls0 = STAT_GET("transport.frame_stalls")  # frame bodies the transport dropped and replayed
    opt = SparseOptimizerConfig()
    cfg = TrainStepConfig(num_slots=NUM_SLOTS, batch_size=BATCH, layout=lay, sparse_opt=opt)

    def scorer():
        return Scorer(DeepFM(NUM_SLOTS, lay.pull_width, lay.embedx_dim, hidden=HIDDEN,
                             generator=torch.Generator().manual_seed(args.seed)), cfg, device="cuda")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp, flags(**FL_FLAGS):
        root, stage_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "stage")
        files0, pool = write_bench_files(tmp, rng, FL_FILES, "fl0")
        files1, _ = write_bench_files(tmp, rng, FL_FILES, "fl1", reuse_pool=pool)
        table = HostSparseTable(lay, opt, n_shards=64, seed=args.seed)
        trainer = new_trainer(args, cfg, lay)
        mgr = CheckpointManager(root)
        counts["serve_fleet_train"], _, _ = day_pass(args, schema, table, trainer, files0, ck, "fleet base pass")
        t0 = time.perf_counter()
        mgr.save_base(PUB_DATE, table, trainer)
        nums["save_base_s"] = time.perf_counter() - t0

        # a torn stage fetch never surfaces a partial version
        torn_dir = os.path.join(tmp, "stage-torn")
        torn = FleetStage(root, torn_dir)
        with fault.inject(fault.fail_always("serve.fleet_stage", times=2)) as plan:
            for _ in range(2):
                try:
                    torn.stage_once()
                except fault.InjectedFault:
                    pass
                else:
                    raise AssertionError("serve fleet: the torn stage fetch did not fail")
                if read_watermark(torn_dir) is not None:
                    raise AssertionError("serve fleet: a torn stage fetch wrote the stage watermark")
            if not torn.stage_once() or read_watermark(torn_dir) != read_watermark(root):
                raise AssertionError("serve fleet: the retried stage fetch did not catch up")
        if plan.failures("serve.fleet_stage") != 2:
            raise AssertionError("serve fleet: the stage fault site fired wrong")

        stage = FleetStage(root, stage_dir)
        t0 = time.perf_counter()
        stage.stage_once()
        nums["stage_base_s"] = time.perf_counter() - t0
        eps = [f"127.0.0.1:{p}" for p in _ports(3)]
        tps = [TcpTransport(r, eps, timeout=60.0) for r in range(3)]
        fleet = {}
        client = None
        try:
            for r in (1, 2):
                fol = Follower(stage_dir, lay, opt, n_host_shards=64, trainer=new_trainer(args, cfg, lay))
                fleet[r] = FleetFollower(tps[r], 0, fol, scorer(), schema, poll_interval_s=0.05, device="cuda")
                fleet[r].start()
            client = FleetClient(tps[0], [1, 2], schema)
            client.start()
            _wait(lambda: all(ff.follower.version().delta_idx == 0 for ff in fleet.values()), "the followers at the base")
            _wait(lambda: client.view.queryable() == [1, 2], "both followers queryable")
            keys = np.sort(table.keys())
            spread = keys[rng.permutation(len(keys))]
            sizes = rng.integers(FL_MIN_RECORDS, FL_MAX_RECORDS + 1, FL_REQUESTS)
            _, warm = _request(rng, spread, BATCH)
            for ff in fleet.values():  # the batch shape's first forward on each follower's scorer
                ff.server.scorer.score_records(warm, schema, table_source(lay, PeekSource(table)), trainer.params)
            ref_scorer = scorer()
            runs, lat_fleet, lat_direct = {}, [], []
            for idx, half in ((0, sizes[: FL_REQUESTS // 2]), (1, sizes[FL_REQUESTS // 2:])):
                if idx == 1:
                    counts["serve_fleet_train_delta"], _, _ = day_pass(args, schema, table, trainer, files1, ck,
                                                                       "fleet delta pass", need_save_delta=False)
                    t0 = time.perf_counter()
                    mgr.save_delta(PUB_DATE, table, trainer)
                    nums["save_delta_s"] = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    stage.stage_once()
                    nums["stage_delta_s"] = time.perf_counter() - t0
                    _wait(lambda: all(ff.follower.version().delta_idx == 1 for ff in fleet.values()),
                          "the followers at delta 1")
                    _wait(lambda: client.view.queryable() == [1, 2], "both followers queryable at delta 1")
                reqs = [_request(rng, spread, int(n)) for n in half]
                torch.cuda.synchronize()
                ck.reset_launch_counts()
                b0 = STAT_GET("serve.batches")
                with flags(serve_hedge_ms=0.0):  # the parity run: no hedged duplicates
                    served = []
                    for lines, _ in reqs:
                        t0 = time.perf_counter()
                        try:
                            preds, meta = client.score_lines(lines)
                        except ServeRequestError:
                            # what the client saw when it gave up, for the log
                            print(f"serve fleet: a request of {len(lines)} lines failed after "
                                  f"{time.perf_counter() - t0:.3f} s; view {client.view.snapshot()}, followers "
                                  f"in flight {[ff.inflight() for ff in fleet.values()]}, gossiped "
                                  f"{[client.view.gossip_state(r) for r in fleet]}; {card}", flush=True)
                            print(f"serve fleet: cuda memory allocated {torch.cuda.memory_allocated()} reserved "
                                  f"{torch.cuda.memory_reserved()}; threads {[t.name for t in threading.enumerate()]}",
                                  flush=True)
                            now = time.monotonic()
                            for r, tp in enumerate(tps):
                                print(f"serve fleet: transport {r}: dead {sorted(tp._dead)}, silent s "
                                      f"{ {k: round(now - v, 3) for k, v in tp._last_seen.items()} }, inbox "
                                      f"{sorted(tp._inbox)}", flush=True)
                            for r, tp in enumerate(tps):
                                socks = {f"to{d}": lk.sock for d, lk in tp._links.items() if lk.sock is not None}
                                socks.update({f"in{i}": c for i, c in enumerate(list(tp._conns))})
                                desc = {}
                                for k, sk in socks.items():
                                    fd = sk.fileno()
                                    try:
                                        desc[k] = (fd, os.readlink(f"/proc/self/fd/{fd}"), sk.getsockname()[1],
                                                   sk.getpeername()[1])
                                    except OSError as e:
                                        desc[k] = (fd, repr(e))
                                print(f"serve fleet: transport {r} sockets {desc}; retained "
                                      f"{ {d: len(lk.retained) for d, lk in tp._links.items()} }", flush=True)
                            print(f"serve fleet: client marked dead {sorted(client._marked_dead)}; stats "
                                  f"{ {k: STAT_GET(k) for k in FL_DIAG_STATS} }",
                                  flush=True)
                            faulthandler.dump_traceback(file=sys.stdout, all_threads=True)
                            raise
                        lat_fleet.append((time.perf_counter() - t0) * 1e3)
                        served.append((preds, meta))
                torch.cuda.synchronize()
                c = dict(ck.launch_counts)
                n_batches = STAT_GET("serve.batches") - b0
                if c["pull_rows_cuda"] != n_batches or c["write_rows_cuda"] != 0 or n_batches != len(reqs):
                    raise AssertionError(f"serve fleet delta {idx}: launches {c} for {n_batches} batches of "
                                         f"{len(reqs)} requests: want one gather a served batch")
                counts[f"serve_fleet_delta{idx}"] = c
                # the trainer-direct scoring of every request at once (a record's
                # pred does not depend on the batch it rides in: phase 5)
                want = _split(ref_scorer.score_records([r for _, recs in reqs for r in recs], schema,
                                                       table_source(lay, PeekSource(table)), trainer.params,
                                                       trainer.opt_state), [len(recs) for _, recs in reqs])
                srcs = set()
                for (lines, _), (preds, meta), w in zip(reqs, served, want):
                    if meta["delta_idx"] != idx or not np.array_equal(preds, w):
                        raise AssertionError(f"serve fleet: a request of {len(lines)} records at delta {idx} is not "
                                             f"the trainer-direct scoring (served at {meta['delta_idx']})")
                    srcs.add(meta["src"])
                if srcs != {1, 2}:
                    raise AssertionError(f"serve fleet: delta {idx}'s requests were served by {srcs} only")
                runs[f"delta{idx}"] = {"requests": len(reqs), "batches": n_batches, "launches": c,
                                       "records": int(sum(half))}
                print(f"serve fleet: {len(reqs)} requests at delta {idx} through the client, preds bitwise the "
                      f"trainer-direct scoring, one gather a served batch ({c}); {card}", flush=True)
                if idx == 0:
                    # the first FL_DIRECT of them through one ScoreServer over
                    # follower 1's follower, phase 5's measurement
                    srv = ScoreServer(fleet[1].follower, scorer(), schema, device="cuda")
                    srv.start()
                    try:
                        for _, recs in reqs[:FL_DIRECT]:
                            t0 = time.perf_counter()
                            srv.score(recs, timeout=300.0)
                            lat_direct.append((time.perf_counter() - t0) * 1e3)
                    finally:
                        srv.stop()
            nums["requests"] = runs
            nums["latency_ms"] = {"fleet_client": request_ms(lat_fleet),
                                  "fleet_client_first": request_ms(lat_fleet[:FL_DIRECT]),
                                  "one_score_server_first": request_ms(lat_direct),
                                  "fleet_client_histogram": client.latency_percentiles()}

            # the hedge: follower 1 stalls, the client re-sends to follower 2
            real = fleet[1].server.scorer.score_records

            def stalled(*a, **kw):
                time.sleep(FL_STALL_S)
                return real(*a, **kw)

            fleet[1].server.scorer.score_records = stalled
            h0 = STAT_GET("serve.hedges")
            hedged = []
            lines, recs = _request(rng, spread, 512)
            want = ref_scorer.score_records(recs, schema, table_source(lay, PeekSource(table)), trainer.params,
                                            trainer.opt_state)
            try:
                with flags(serve_hedge_ms=FL_HEDGE_MS):
                    for _ in range(2):  # round robin: follower 1 is the primary within two
                        t0 = time.perf_counter()
                        preds, meta = client.score_lines(lines)
                        hedged.append((time.perf_counter() - t0) * 1e3)
                        if not np.array_equal(preds, want):
                            raise AssertionError("serve fleet: a hedged answer differs")
            finally:
                fleet[1].server.scorer.score_records = real
            if STAT_GET("serve.hedges") <= h0 or max(hedged) >= FL_STALL_S * 1e3:
                raise AssertionError(f"serve fleet: the hedge did not rescue the stalled follower ({hedged} ms)")
            nums["hedge"] = {"request_ms": hedged, "stall_ms": FL_STALL_S * 1e3, "hedge_ms": FL_HEDGE_MS,
                             "hedges": STAT_GET("serve.hedges") - h0}
            time.sleep(FL_STALL_S)  # the stalled answer lands, and is counted away

            # drain, then admit, each confirmed by the follower's own gossip
            t0 = time.perf_counter()
            if not client.drain(1, wait_s=30.0) or client.view.gossip_state(1) not in ("draining", "drained"):
                raise AssertionError("serve fleet: the drain was not confirmed by follower 1's gossip")
            drain_s = time.perf_counter() - t0
            for _ in range(4):
                _, meta = client.score_lines(_request(rng, spread, 256)[0])
                if meta["src"] != 2:
                    raise AssertionError("serve fleet: a drained follower answered")
            t0 = time.perf_counter()
            if not client.admit(1, wait_s=30.0):
                raise AssertionError("serve fleet: the admit was not confirmed by follower 1's gossip")
            _wait(lambda: client.view.queryable() == [1, 2], "follower 1 back in rotation")
            nums["drain_s"], nums["admit_s"] = drain_s, time.perf_counter() - t0

            # overload: past serve_shed_queue_depth the follower's server refuses, typed
            srv = fleet[2].server
            recs = _request(rng, spread, 256)[1]
            real2 = srv.scorer.score_records

            def slow(*a, **kw):
                time.sleep(0.3)
                return real2(*a, **kw)

            srv.scorer.score_records = slow
            shed0 = STAT_GET("serve.shed_requests")
            pend, refused = [], None
            try:
                with flags(serve_shed_queue_depth=1):
                    pend.append(srv.submit(recs))
                    time.sleep(0.05)
                    try:
                        for _ in range(8):
                            pend.append(srv.submit(recs))
                    except ServeOverloadError as e:
                        refused = str(e)
                for p in pend:
                    p.result(60.0)
            finally:
                srv.scorer.score_records = real2
            if refused is None or STAT_GET("serve.shed_requests") <= shed0:
                raise AssertionError("serve fleet: overload was not refused with ServeOverloadError")
            nums["overload"] = {"admitted": len(pend), "refused": refused}
        finally:
            if client is not None:
                client.stop()
            for ff in fleet.values():
                ff.stop()
            for t in tps:
                t.close()

        # the gather at a follower's shape: a full served batch's working set
        from paddlebox_tpu_torch import config as pconfig
        from paddlebox_tpu_torch.data import build_batch, pack_batch
        from paddlebox_tpu_torch.serve import version_source
        from paddlebox_tpu_torch.table import PassWorkingSet

        full = make_records(rng, spread, BATCH)
        batch = build_batch(full, schema)
        ws = PassWorkingSet(n_mesh_shards=1)
        ws.add_keys(batch.keys)
        v = fleet[1].follower.version()
        tab = torch.from_numpy(ws.finalize(version_source(lay, v), round_to=pconfig.get_flag("serve_row_bucket"))
                               .reshape(-1, lay.width)).to(dev)
        db = pack_batch(batch, ws, schema, bucket=pconfig.get_flag("serve_key_bucket"))
        uniq = torch.from_numpy(db.uniq_rows).to(dev)
        R, W = tab.shape
        U = uniq.shape[0]
        err = check_gather(ck, tab, uniq, f"serve fleet follower R={R} W={W} U={U}")
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        med, warm_l2 = time_fns({"kernel": lambda: ck.pull_rows_cuda(tab, uniq),
                                 "plain": lambda: ck.pull_rows_ref(tab, uniq),
                                 "library": lambda: torch.index_select(tab, 0, uniq)}, flush)
        moved = 2 * U * W * 4 + 4 * U
        bound = moved / HBM_BYTES_PER_S * 1e3
        shape = {"R": R, "U": U, "n_uniq": db.n_uniq, "ms": med["kernel"], "plain_ms": med["plain"],
                 "library_ms": med["library"], "bound_ms": bound, "bytes": moved, "bound_share": bound / med["kernel"],
                 "sector_floor_ms": sector_floor_ms(uniq, R, W, False), "warm_l2_ms": warm_l2["kernel"],
                 "warm_l2_plain_ms": warm_l2["plain"], "warm_l2_library_ms": warm_l2["library"]}
        emit({"card": card, "kernel": "pull_rows_cuda", "path": "serve_fleet", "W": W, **shape, "reps": TIMING_REPS,
              "l2": "cold"})
        nums["transport_frame_stalls"] = STAT_GET("transport.frame_stalls") - stalls0
        emit({"card": card, "phase": "serve_fleet", **nums, "launches": counts})
        lat = nums["latency_ms"]
        first, one = lat["fleet_client_first"], lat["one_score_server_first"]
        print(f"serve fleet: client p50 {lat['fleet_client']['p50']:.3f} / p99 {lat['fleet_client']['p99']:.3f} "
              f"/ mean {lat['fleet_client']['mean']:.3f} ms over {FL_REQUESTS} requests; on the first {FL_DIRECT} "
              f"p50 {first['p50']:.3f} / p99 {first['p99']:.3f} / mean {first['mean']:.3f} ms against one "
              f"ScoreServer's p50 {one['p50']:.3f} / p99 {one['p99']:.3f} / mean {one['mean']:.3f} ms on the same "
              f"requests; hedge {nums['hedge']['request_ms']} "
              f"ms under a {FL_STALL_S * 1e3:.0f} ms stall; drain {nums['drain_s']:.3f} s, admit "
              f"{nums['admit_s']:.3f} s; {card}", flush=True)
    print(f"phase 17 (serve_fleet) in {time.perf_counter() - t_phase:.3f} s; {card}", flush=True)
    return counts, shape, err



# ---- 18. the long tail: the extended pull, the replica cache, the ops and the strategy

LT_SEED = 18  # the phase's data seed offset
LT_FILES = 2  # x RECORDS_PER_FILE: 16384 records, 4 steps of 4096 a feed
LT_STEPS = 4
LT_K = 4  # resident_scan_batches of the phase's resident runs
LT_EXPAND = 8  # expand_embed_dim: the reference compiles {0-8, 64} (SURVEY.md B3, box_wrapper.cc:444-457)
CACHE_ROWS, CACHE_DIM = 1 << 20, 16  # a 64 MiB replica cache
INPUT_KEYS = 4096  # the InputTable's keys besides its miss row
GM_K, GM_STEPS = 4, 8  # gradient_merge: k_steps, mini-steps
# card vs CPU for the ops: the seqpools sum each segment in key order on
# both and take the same logs (a log may round by an ulp on either);
# batch_fc is a matmul whose sums cuBLAS and the CPU order differently
OPS_POOL_RTOL, OPS_POOL_ATOL = 1e-6, 1e-6
OPS_FC_RTOL, OPS_FC_ATOL = 1e-5, 1e-5
# amp against the CPU path: both run the model's matmuls and sums in bf16,
# which cuBLAS and the CPU accumulate in other orders; the bound is this
# many bf16 ulps (2**-7 relative) at the logits' largest magnitude
AMP_ULPS = 4


class ExpandModel(torch.nn.Module):
    """``tests/test_replica_cache.py``'s expand model: a linear term over
    the slot features plus one over the pooled expand embeddings, fp32,
    its weights drawn from ``seed``. The JAX package ships no expand model,
    so the port does not either."""

    def __init__(self, n_slots, pull_width, expand_dim, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.w = torch.nn.Parameter(torch.randn(n_slots * pull_width, generator=g) * 0.05)
        self.we = torch.nn.Parameter(torch.randn(n_slots * expand_dim, generator=g) * 0.05)

    def forward(self, slot_feats, dense=None, expand=None):
        b = slot_feats.shape[0]
        return slot_feats.reshape(b, -1) @ self.w + expand.reshape(b, -1) @ self.we


def lt_layout():
    from paddlebox_tpu_torch.table import ValueLayout

    return ValueLayout(embedx_dim=EMBEDX_DIM, expand_embed_dim=LT_EXPAND)


def lt_dataset(seed, files, n_mesh_shards=1):
    """bench.py's tier over the phase's files: the native store and parser,
    an expand layout, ``begin_pass(round_to=512)``."""
    from paddlebox_tpu_torch.data import BoxPSDataset
    from paddlebox_tpu_torch.table import HostSparseTable, SparseOptimizerConfig

    table = HostSparseTable(lt_layout(), SparseOptimizerConfig(embedx_threshold=0.0), n_shards=64, seed=seed)
    ds = BoxPSDataset(bench_schema(), table, batch_size=BATCH, shuffle_mode="local", seed=seed,
                      n_mesh_shards=n_mesh_shards)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.begin_pass(round_to=512)
    return ds


def lt_trainer(seed, device="cuda", dense_opt=None, plan=None, world=1):
    """The extended trainer at full width: ExpandModel, ``use_expand``."""
    from paddlebox_tpu_torch.table import SparseOptimizerConfig
    from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig

    lay = lt_layout()
    cfg = TrainStepConfig(num_slots=NUM_SLOTS, batch_size=BATCH // world, layout=lay,
                          sparse_opt=SparseOptimizerConfig(embedx_threshold=0.0), auc_buckets=100_000,
                          use_expand=True)
    model = ExpandModel(NUM_SLOTS, lay.pull_width, lay.expand_dim, seed)
    tr = CTRTrainer(model, cfg, dense_opt=dense_opt or Adam(1e-3), device=None if plan else device, plan=plan)
    tr.init_params()
    return tr


def lt_state(tr):
    """(table, params, first moments, second moments) of a trainer, on the host."""
    adam = tr._state.opt_state
    return (tr.trained_table(), {k: v.cpu() for k, v in tr.params.items()},
            {k: v.cpu() for k, v in adam.mu.items()}, {k: v.cpu() for k, v in adam.nu.items()})


def lt_same(a, b) -> bool:
    return (a[0].tobytes() == b[0].tobytes()
            and all(torch.equal(a[i][k], b[i][k]) for i in (1, 2, 3) for k in a[1]))


def mesh_expand_prepare(args, dev, files):
    """Phase 18's one-device reference for its mesh run: the extended
    trainer's 4 packer steps over phase 12's first files."""
    seed = args.seed + LT_SEED
    ds = lt_dataset(seed, files)
    with flags(enable_resident_feed=0):
        one = lt_trainer(seed, device=dev)
        losses = []
        one.train_pass(ds, n_batches=LT_STEPS, on_batch=lambda i, m: losses.append(float(m["loss"])))
    keys, rows = _mesh_key_rows(one, ds, LT_STEPS)
    del one, ds
    torch.cuda.empty_cache()
    return {"files": files, "ref": (losses, keys, rows)}


def mesh_expand_rank(plan, spec):
    """Phase 18 on one rank of phase 12's worlds: the extended trainer on
    the mesh, LT_STEPS resident steps (K = LT_K) from its replica of the
    files; 2 gathers + 1 writeback a step; both kernels bitwise at the
    owner's ids of the expand shard."""
    from paddlebox_tpu_torch.ops import cuda_kernels as ck

    n, r, dev = plan.world, plan.rank, plan.device
    tag = _mesh_tag(plan.backend, spec["ranks_per_card"])
    ds = lt_dataset(spec["seed"], spec["files"], n_mesh_shards=n)
    tr = lt_trainer(spec["seed"], plan=plan, world=n)
    with flags(resident_scan_batches=LT_K):
        tr.prepare_pass(ds, n_batches=LT_STEPS)
        losses = []
        torch.cuda.synchronize(dev)
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        tr.train_pass(ds, n_batches=LT_STEPS, on_batch=lambda i, m: losses.append(m["loss"]))
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counts = dict(ck.launch_counts)
    if tr.last_feed != "resident":
        raise AssertionError(f"expand mesh {tag}: the trainer took the {tr.last_feed} feed")
    if counts["pull_rows_cuda"] != 2 * LT_STEPS or counts["write_rows_cuda"] != LT_STEPS:
        raise AssertionError(f"expand mesh {tag} rank {r}: launches {counts} for {LT_STEPS} steps")
    losses = torch.stack(losses).cpu()
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"expand mesh {tag} rank {r}: non-finite loss {losses.tolist()}")
    keys, rows = _mesh_key_rows(tr, ds, LT_STEPS)
    shard = tr._state.table
    with flags(enable_resident_feed=0):
        first = next(ds.batch_indices(1))
        packer = tr._get_packer(ds)
        packer.freeze_shapes([first], n_devices=n)
        db = packer.pack_sharded(first, n)
    recv = torch.from_numpy(np.ascontiguousarray(db.req_ranks[:, r, :].reshape(-1))).to(dev)
    uniq = torch.unique(recv)
    tail = recv.numel() - uniq.numel()
    old_ids = torch.cat([uniq, torch.zeros(tail, dtype=uniq.dtype, device=dev)])
    write_ids = torch.cat([uniq.long(), torch.full((tail,), shard.shape[0], dtype=torch.long, device=dev)])
    what = f"expand mesh {tag} rank {r} owner R={shard.shape[0]} W={shard.shape[1]} U={recv.numel()}"
    kerr = max(check_gather(ck, shard, recv, what + " pull ids"),
               check_gather(ck, shard, old_ids, what + " merge old-row ids"),
               check_write(ck, shard, write_ids, ck.pull_rows_ref(shard, old_ids) + 0.5, what + " merge writeback ids"))
    res = {"rank": r, "losses": losses.tolist(), "counts": counts, "wall_s": wall, "kernel_err": kerr,
           "W": int(shard.shape[1]), "owner_R": int(shard.shape[0]), "owner_U": int(recv.numel())}
    np.savez(os.path.join(spec["out"], f"rank{r}.npz"), four_keys=keys, four_rows=rows)
    with open(os.path.join(spec["out"], f"rank{r}.json"), "w") as f:
        json.dump(res, f)


def mesh_expand_report(card, worlds, prep):
    """Phase 18's mesh checks: each world's ranks alike and within phase
    12's bounds of one device fed the same global batches."""
    ref_losses, ref_keys, ref_rows = prep["ref"]
    counts, nums = {}, {}
    for name, (ranks, _) in worlds.items():
        tag = _mesh_tag(**MESH_TAGS[name])
        for rk in ranks:
            if rk["losses"] != ranks[0]["losses"]:
                raise AssertionError(f"expand mesh {tag}: the ranks' losses differ")
        keys, first = np.unique(np.concatenate([rk["four_keys"] for rk in ranks]), return_index=True)
        rows = np.concatenate([rk["four_rows"] for rk in ranks])[first]
        tab_d, loss_d = _mesh_compare(f"expand mesh {tag} vs one device", ranks[0]["losses"], rows, keys,
                                      ref_losses, ref_keys, ref_rows)
        counts[f"expand_mesh_{name}"] = {k: sum(rk["counts"][k] for rk in ranks)
                                         for k in KERNEL_NAMES}
        nums[name] = {"world": len(ranks), "W": ranks[0]["W"], "owner_R": ranks[0]["owner_R"],
                      "owner_U": ranks[0]["owner_U"], "losses": ranks[0]["losses"],
                      "samples_per_s_all": BATCH * LT_STEPS / max(rk["wall_s"] for rk in ranks),
                      "vs_one_device": {"table_max_abs": tab_d, "loss_max_rel": loss_d},
                      "launches": counts[f"expand_mesh_{name}"]}
        print(f"expand mesh {tag} world {len(ranks)}: {LT_STEPS} resident steps, 2 gathers and 1 writeback a step "
              f"on every rank, both kernels bitwise at the owner's ids (W={ranks[0]['W']}), within bounds of one "
              f"device (table {tab_d:.3g}, loss rel {loss_d:.3g}); {card}", flush=True)
    err = max(rk["kernel_err"] for ranks, _ in worlds.values() for rk in ranks)
    return {"counts": counts, "nums": nums, "err": err}


def kernel_shape_row(ck, dev, card, tab, rows, path, n_uniq, write):
    """One kernel timed at ``rows`` of ``tab``, cold and warm, beside its
    plain version and the library call, with the byte bound and the
    sector floor."""
    R, W = tab.shape
    U = rows.shape[0]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    if write:
        kname = "write_rows_cuda"
        new_rows = ck.pull_rows_ref(tab, rows) + 0.5  # padding-row repeats stay identical
        err = check_write(ck, tab, rows, new_rows, f"{path} R={R} W={W} U={U}")
        pristine, rows64 = tab.clone(), rows.long()
        fns = {"kernel": lambda: ck.write_rows_cuda(tab, rows, new_rows),
               "plain": lambda: ck.write_rows_ref(tab, rows, new_rows),
               "library": lambda: tab.index_copy_(0, rows64, new_rows)}
        restore = lambda: tab.copy_(pristine)
    else:
        kname = "pull_rows_cuda"
        err = check_gather(ck, tab, rows, f"{path} R={R} W={W} U={U}")
        fns = {"kernel": lambda: ck.pull_rows_cuda(tab, rows), "plain": lambda: ck.pull_rows_ref(tab, rows),
               "library": lambda: torch.index_select(tab, 0, rows)}
        restore = None
    med, warm = time_fns(fns, flush, restore)
    moved = 2 * U * W * 4 + 4 * U
    bound = moved / HBM_BYTES_PER_S * 1e3
    row = {"R": R, "W": W, "U": U, "n_uniq": n_uniq, "ms": med["kernel"], "plain_ms": med["plain"],
           "library_ms": med["library"], "bound_ms": bound, "bytes": moved, "bound_share": bound / med["kernel"],
           "sector_floor_ms": sector_floor_ms(rows, R, W, write), "warm_l2_ms": warm["kernel"],
           "warm_l2_plain_ms": warm["plain"], "warm_l2_library_ms": warm["library"]}
    emit({"card": card, "kernel": kname, "path": path, **row, "reps": TIMING_REPS, "l2": "cold"})
    return row, err


def expand_trainer_check(args, dev, card, ck, pull_push, ds):
    """The extended trainer on one card: the four feeds from one state, a
    plain-kernel twin, the launches, the expand block trained, the host
    syncs of a superstep, the CPU path and samples/s. Returns (counts by
    path, numbers, the trainer of the resident run)."""
    seed = args.seed + LT_SEED
    lay = lt_layout()
    table0 = ds.device_table.reshape(-1, lay.width).copy()
    counts, runs = {}, {}
    feeds = (("expand_resident", dict(resident_scan_batches=LT_K), ds, "resident"),
             ("expand_resident_k1", dict(resident_scan_batches=1), ds, "resident"),
             ("expand_packer", dict(enable_resident_feed=0), ds, "packer"),
             ("expand_slow", {}, records_view(ds, LT_STEPS), "slow"))
    trainers = {}
    for name, kw, data, want in feeds:
        with flags(**kw):
            tr = lt_trainer(seed, device=dev)
            out, losses, wall, counts[name] = timed_pass(tr, data, LT_STEPS, ck)
            if tr.last_feed != want:
                raise AssertionError(f"{name}: the trainer took the {tr.last_feed} feed, not {want}")
            check_path(name, out, losses, counts[name], LT_STEPS)
            runs[name] = (*lt_state(tr), losses)
            trainers[name] = tr
    saved = pull_push.pull_rows_cuda, pull_push.write_rows_cuda
    pull_push.pull_rows_cuda, pull_push.write_rows_cuda = ck.pull_rows_ref, ck.write_rows_ref
    try:
        with flags(enable_resident_feed=0):
            twin = lt_trainer(seed, device=dev)
            ck.reset_launch_counts()
            tl = []
            twin.train_pass(ds, n_batches=LT_STEPS, on_batch=lambda i, m: tl.append(m["loss"]))
            plain_counts = dict(ck.launch_counts)
    finally:
        pull_push.pull_rows_cuda, pull_push.write_rows_cuda = saved
    if any(plain_counts.values()):
        raise AssertionError(f"the plain twin launched kernels: {plain_counts}")
    runs["packer, plain gather and writeback"] = (*lt_state(twin), torch.stack(tl).cpu())
    ref = runs["expand_resident"]
    for name, got in runs.items():
        if not (lt_same(got, ref) and got[4].numpy().tobytes() == ref[4].numpy().tobytes()):
            raise AssertionError(f"expand: {LT_STEPS} steps through {name} differ from the resident feed's")
    print(f"expand (W={lay.width}): {LT_STEPS} steps from one state through {', '.join(runs)} give bitwise-equal "
          f"tables, params, Adam moments and losses; {card}", flush=True)
    t1 = ref[0].reshape(-1, lay.width)
    ec = slice(lay.expand_col, lay.expand_col + lay.expand_dim)
    moved = np.abs(t1[:, ec] - table0[:, ec]).max(axis=1) > 0
    touched = t1[:, lay.SHOW] > table0[:, lay.SHOW]
    # the expand block moves only on touched rows, and on all of them but
    # those whose summed expand gradient is exactly 0; its g2 grows with it
    if moved.sum() < 0.999 * touched.sum() or (moved & ~touched).any() \
            or not (t1[moved, lay.expand_g2_col] > table0[moved, lay.expand_g2_col]).all():
        raise AssertionError(f"expand: the expand block moved on {int(moved.sum())} rows, "
                             f"{int(touched.sum())} touched")
    # the host syncs of one resident superstep, on the resident run's trainer
    tr = trainers["expand_resident"]
    rp = tr._resident_cache[2]
    with flags(resident_scan_batches=LT_K):
        sstep = tr._resident_superstep(rp, False)
    idx_dev = tr._idx_cache[2][:LT_K]
    state = tr._state
    n_syncs, sites = host_syncs(lambda: sstep(state, idx_dev))
    if n_syncs:
        raise AssertionError(f"expand: a resident superstep made {n_syncs} host syncs: {sites}")
    # the port's CPU path on the same data
    with flags(enable_resident_feed=0):
        cpu = lt_trainer(seed, device="cpu")
        cl = []
        cpu.train_pass(ds, n_batches=LT_STEPS, on_batch=lambda i, m: cl.append(float(m["loss"])))
    c = lt_state(cpu)
    tab_err = float(np.abs(ref[0] - c[0]).max())
    tab_ok = np.allclose(ref[0], c[0], rtol=SMALL_TABLE_RTOL, atol=SMALL_TABLE_ATOL)
    par_err = max(float((ref[1][k] - c[1][k]).abs().max()) for k in c[1])
    rl = ref[4].numpy().astype(np.float64)
    loss_err = float(np.max(np.abs(rl - np.array(cl)) / np.abs(np.array(cl))))
    print(f"expand card vs CPU ({LT_STEPS} packer steps, full width): table max |diff| {tab_err:.3e} (rtol "
          f"{SMALL_TABLE_RTOL}, atol {SMALL_TABLE_ATOL}), params {par_err:.3e} (atol {SMALL_PARAMS_ATOL}), loss rel "
          f"{loss_err:.3e} (rtol {SMALL_LOSS_RTOL}); {card}", flush=True)
    if not (tab_ok and par_err <= SMALL_PARAMS_ATOL and loss_err <= SMALL_LOSS_RTOL):
        raise AssertionError("expand: the card and the CPU path disagree")
    # samples/s of the resident feed, after its first pass
    with flags(resident_scan_batches=LT_K):
        _, _, wall, _ = timed_pass(tr, ds, LT_STEPS, ck)
    nums = {"W": lay.width, "records": RECORDS_PER_FILE * LT_FILES, "steps": LT_STEPS,
            "feeds_bitwise": list(runs), "superstep_host_syncs": n_syncs,
            "resident_samples_per_s": BATCH * LT_STEPS / wall,
            "vs_cpu": {"table_max_abs": tab_err, "params_max_abs": par_err, "loss_max_rel": loss_err}}
    return counts, nums, tr


def replica_cache_check(args, dev, card, ck):
    """``pull_cache_value`` on a 64 MiB ``ReplicaCache`` and on an
    ``InputTable`` with its miss row: one ``pull_rows_cuda`` a call,
    bitwise the plain version and the host rows wherever they are
    defined, NaN rows elsewhere; timed beside ``index_select``."""
    from paddlebox_tpu_torch.table import InputTable, ReplicaCache, pull_cache_value
    from paddlebox_tpu_torch.table.replica_cache import cache_row_ids, pull_cache_value_ref

    rng = np.random.default_rng(args.seed + LT_SEED)
    R, W = CACHE_ROWS, CACHE_DIM
    cache = ReplicaCache(W)
    cache.add_batch(rng.standard_normal((R, W), dtype=np.float32))
    t0 = time.perf_counter()
    dev_cache = cache.to_device(device=dev)
    torch.cuda.synchronize()
    to_device_s = time.perf_counter() - t0
    ids = rng.integers(0, R, (BATCH, NUM_SLOTS))
    edge = np.array([-1, R, R + 7, -R, -R - 1, R - 1, 0, 2 * R, -2 * R])
    ids.reshape(-1)[: len(edge)] = edge
    wild = rng.random((BATCH, NUM_SLOTS)) < 0.01  # 1% anywhere in [-2R, 2R)
    ids = np.where(wild, rng.integers(-2 * R, 2 * R, (BATCH, NUM_SLOTS)), ids)
    ids_t = torch.from_numpy(ids).to(dev)
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    got = pull_cache_value(dev_cache, ids_t)  # the main path
    torch.cuda.synchronize()
    counts = dict(ck.launch_counts)
    if counts != want_launches(1, 0):
        raise AssertionError(f"pull_cache_value launched {counts}, want one pull_rows_cuda")
    rows = cache_row_ids(ids_t, R)
    plain = pull_cache_value_ref(dev_cache, rows).reshape(got.shape)
    if got.cpu().numpy().tobytes() != plain.cpu().numpy().tobytes():
        raise AssertionError("pull_cache_value on the card != its plain version")
    defined = (ids >= -R) & (ids < R)
    g = got.cpu().numpy()
    if not (np.array_equal(g[defined], cache.host_array()[ids[defined]]) and np.isnan(g[~defined]).all()):
        raise AssertionError("pull_cache_value != the host rows where they are defined, NaN elsewhere")
    # the InputTable: its miss row 0, the miss counter, the host lookup
    it = InputTable(W)
    vecs = rng.standard_normal((INPUT_KEYS, W), dtype=np.float32)
    for i in range(INPUT_KEYS):
        it.add_index_data(f"ad-{i}", vecs[i])
    n = len(it)
    if it.get_index_offset("ad-absent") != 0 or it.miss != 1 or it.get_index_offset("ad-7") != 8:
        raise AssertionError("InputTable: the miss row or the row ids are wrong")
    ids2 = rng.integers(-n - 3, n + 3, (BATCH, NUM_SLOTS))
    ids2.reshape(-1)[:3] = [0, -1, n]
    got2 = pull_cache_value(it.to_device(device=dev), torch.from_numpy(ids2).to(dev)).cpu().numpy()
    ok2 = (ids2 >= -n) & (ids2 < n)
    if not (np.array_equal(got2[ok2], it.lookup_input(ids2[ok2])) and np.isnan(got2[~ok2]).all()
            and not got2.reshape(-1, W)[0].any()):
        raise AssertionError("pull_cache_value on the InputTable != lookup_input where it is defined")
    print(f"replica cache: pull_cache_value over {R} x {W} rows at {BATCH} x {NUM_SLOTS} ids ({int((~defined).sum())} "
          f"outside [-R, R)) launches one pull_rows_cuda, bitwise its plain version and the host rows, NaN outside; "
          f"InputTable ({n} rows with its miss row) bitwise lookup_input; {card}", flush=True)
    # timings: the kernel at the wrapped ids, the whole wrapper, the plain
    # version and index_select at the same ids (clamped into the table)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    clamped = rows.clamp(0, R - 1)
    med, warm = time_fns({"kernel": lambda: ck.pull_rows_cuda(dev_cache, rows),
                          "wrapper": lambda: pull_cache_value(dev_cache, ids_t),
                          "plain": lambda: pull_cache_value_ref(dev_cache, rows),
                          "library": lambda: torch.index_select(dev_cache, 0, clamped)}, flush)
    U = rows.numel()
    moved = 2 * U * W * 4 + 4 * U
    bound = moved / HBM_BYTES_PER_S * 1e3
    shape = {"R": R, "W": W, "U": U, "ms": med["kernel"], "wrapper_ms": med["wrapper"], "plain_ms": med["plain"],
             "library_ms": med["library"], "bound_ms": bound, "bytes": moved, "bound_share": bound / med["kernel"],
             "sector_floor_ms": sector_floor_ms(rows, R, W, False), "warm_l2_ms": warm["kernel"],
             "warm_l2_wrapper_ms": warm["wrapper"], "warm_l2_plain_ms": warm["plain"],
             "warm_l2_library_ms": warm["library"], "to_device_s": to_device_s, "mem_used_mb": cache.mem_used_mb()}
    emit({"card": card, "kernel": "pull_rows_cuda", "path": "replica_cache", **shape, "reps": TIMING_REPS,
          "l2": "cold"})
    return {"replica_cache": counts}, shape


def ops_check(args, dev, card):
    """The CONV / PCOC / per-slot-threshold seqpools, their transforms,
    ``batch_fc`` and ``fused_concat`` at the flagship shape on the card
    against the port's CPU path."""
    from paddlebox_tpu_torch import ops

    rng = np.random.default_rng(args.seed + LT_SEED + 1)
    S, B, D = NUM_SLOTS, BATCH, EMBEDX_DIM
    L = S * B + S * B // 4  # a key a (slot, instance) and a quarter more
    seg = rng.permutation(np.concatenate([np.arange(S * B), rng.integers(0, S * B, L - S * B)])).astype(np.int32)

    def recs(width):
        return np.abs(rng.standard_normal((L, width), dtype=np.float32))

    thr = np.linspace(0.05, 0.5, S).astype(np.float32)
    pooled_conv = np.abs(rng.standard_normal((B, S, 3 + D), dtype=np.float32))
    pooled_pcoc = np.abs(rng.standard_normal((B, S, 4 + 3 + D), dtype=np.float32))
    x = rng.standard_normal((B, S * D), dtype=np.float32)
    w = rng.standard_normal((D, S * 8), dtype=np.float32)
    b = rng.standard_normal((S * 8,), dtype=np.float32)
    xs = [rng.standard_normal((B, 3 + D), dtype=np.float32) for _ in range(S)]
    conv, pcoc, diff = recs(3 + D), recs(4 + 3 + D), recs(3 + D)
    cases = {
        "cvm_with_conv_transform": (lambda t: ops.cvm_with_conv_transform(t(pooled_conv)), "pool"),
        "cvm_with_conv_transform show_filter": (
            lambda t: ops.cvm_with_conv_transform(t(pooled_conv), show_filter=True), "pool"),
        "cvm_with_pcoc_transform": (lambda t: ops.cvm_with_pcoc_transform(t(pooled_pcoc), pclk_num=3), "pool"),
        "fused_seqpool_cvm_with_conv": (
            lambda t: ops.fused_seqpool_cvm_with_conv(t(conv), t(seg), S, B, show_filter=True), "pool"),
        "fused_seqpool_cvm_with_pcoc": (
            lambda t: ops.fused_seqpool_cvm_with_pcoc(t(pcoc), t(seg), S, B, pclk_num=3), "pool"),
        "fused_seqpool_cvm_with_diff_thres": (
            lambda t: ops.fused_seqpool_cvm_with_diff_thres(t(diff), t(seg), S, B, t(thr)), "pool"),
        "batch_fc": (lambda t: ops.batch_fc(t(x), t(w), t(b), S), "fc"),
        "fused_concat": (lambda t: ops.fused_concat([t(a) for a in xs], 3, D), "exact"),
    }
    errs = {}
    for name, (fn, kind) in cases.items():
        got = fn(lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)).cpu()
        want = fn(lambda a: torch.from_numpy(np.ascontiguousarray(a)))
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}, or non-finite")
        errs[name] = float((got - want).abs().max())
        rtol, atol = {"pool": (OPS_POOL_RTOL, OPS_POOL_ATOL), "fc": (OPS_FC_RTOL, OPS_FC_ATOL),
                      "exact": (0.0, 0.0)}[kind]
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(f"{name}: card vs CPU max |diff| {errs[name]} past rtol {rtol} atol {atol}")
    print(f"ops at the flagship shape (B={B}, S={S}, D={D}, {L} keys): card vs CPU max |diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (seqpools rtol {OPS_POOL_RTOL} atol {OPS_POOL_ATOL}, batch_fc rtol {OPS_FC_RTOL} atol {OPS_FC_ATOL}, "
          f"fused_concat exact); {card}", flush=True)
    return errs


def strategy_check(args, dev, card, ck, ds, tr):
    """``recompute`` bitwise the plain model over a superstep; ``amp``
    against the CPU path; ``gradient_merge`` (k = GM_K) over GM_STEPS
    steps through ``CTRTrainer``: params bitwise unchanged on the
    mini-steps that do not emit, the emitting steps within phase 6's
    params bound of the CPU path, and a resident superstep with
    ``MultiSteps`` making no host sync."""
    from torch.func import functional_call

    from paddlebox_tpu_torch.fleet import DistributedStrategy
    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.train import Adam, MultiSteps, make_resident_superstep

    lay = lt_layout()
    seed = args.seed + LT_SEED
    # DeepFM at the flagship width over the expand table (its plain pull)
    cfg = dataclasses.replace(tr.cfg, use_expand=False)
    model = DeepFM(NUM_SLOTS, lay.pull_width, lay.embedx_dim, hidden=HIDDEN,
                   generator=torch.Generator().manual_seed(seed)).to(dev)
    plain_apply = lambda p, x, d: functional_call(model, p, (x, d))
    rp = tr._resident_cache[2]
    idx = tr._idx_cache[2][:LT_STEPS]
    table0 = ds.device_table.reshape(-1, lay.width).copy()
    params0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt0 = Adam(1e-3).init(params0)
    counts, out = {}, {}
    for name, strat in (("plain", None), ("recompute", DistributedStrategy(recompute=True))):
        apply = plain_apply if strat is None else strat.apply(cfg, Adam(1e-3), model_apply=plain_apply)[2]
        sstep = make_resident_superstep(apply, Adam(1e-3), cfg, rp)
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        st, m = sstep(fresh_state(table0, params0, opt0, dev), idx)
        torch.cuda.synchronize()
        counts[f"strategy_{name}"] = dict(ck.launch_counts)
        out[name] = (st, m["loss"].cpu())
    for name in ("plain", "recompute"):
        c = counts[f"strategy_{name}"]
        if c["pull_rows_cuda"] != 2 * LT_STEPS or c["write_rows_cuda"] != LT_STEPS:
            raise AssertionError(f"strategy {name}: launches {c} for {LT_STEPS} steps")
        if not bool(torch.isfinite(out[name][1]).all()):
            raise AssertionError(f"strategy {name}: non-finite loss")
    (a, la), (b, lb) = out["plain"], out["recompute"]
    if not (same_state(a, b) and torch.equal(la, lb)):
        raise AssertionError("recompute: the superstep differs from the plain model's")
    # amp: the bf16 model on the card against the CPU path, on pulled features
    amp_apply = DistributedStrategy(amp=True).apply(cfg, Adam(1e-3), model_apply=plain_apply)[2]
    cpu_model = DeepFM(NUM_SLOTS, lay.pull_width, lay.embedx_dim, hidden=HIDDEN,
                       generator=torch.Generator().manual_seed(seed))
    cpu_apply = DistributedStrategy(amp=True).apply(
        cfg, Adam(1e-3), model_apply=lambda p, x, d: functional_call(cpu_model, p, (x, d)))[2]
    g = torch.Generator().manual_seed(seed)
    # at the scale of pulled features after the CVM (logits of order 1)
    feats = 0.1 * torch.randn((BATCH, NUM_SLOTS, lay.pull_width), generator=g)
    got = amp_apply({k: v.to(dev) for k, v in params0.items()}, feats.to(dev), None).cpu()
    want = cpu_apply({k: v.cpu() for k, v in params0.items()}, feats, None)
    amp_err = float((got - want).abs().max())
    top = float(want.abs().max())
    amp_bound = AMP_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)
    print(f"amp: the bf16 DeepFM's logits at [{BATCH}, {NUM_SLOTS}, {lay.pull_width}] card vs CPU max |diff| "
          f"{amp_err:.4g} (bound {amp_bound:.4g}: {AMP_ULPS} bf16 ulps at |logit| <= {top:.3g}); {card}", flush=True)
    if got.dtype != torch.float32 or not amp_err <= amp_bound:
        raise AssertionError(f"amp: card vs CPU {amp_err} past {amp_bound}")
    # gradient_merge through the trainer, one step a train_pass
    merged = {}
    for device in (dev, "cpu"):
        opt = DistributedStrategy(gradient_merge=True, gradient_merge_configs={"k_steps": GM_K}).apply(
            tr.cfg, Adam(1e-3))[1]
        if not isinstance(opt, MultiSteps):
            raise AssertionError("gradient_merge did not give MultiSteps")
        t = lt_trainer(seed, device=device, dense_opt=opt)
        prev = {k: v.cpu() for k, v in t.params.items()}
        snaps = []
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        with flags(resident_scan_batches=1):
            for i in range(GM_STEPS):
                t.train_pass(ds, n_batches=1)
                cur = {k: v.cpu() for k, v in t.params.items()}
                same = all(torch.equal(cur[k], prev[k]) for k in cur)
                if same != bool((i + 1) % GM_K):
                    raise AssertionError(f"gradient_merge on {device}: mini-step {i + 1} params "
                                         f"{'unchanged' if same else 'moved'}")
                snaps.append(cur)
                prev = cur
        if device == dev:
            counts["strategy_gradient_merge"] = c = dict(ck.launch_counts)
            if c["pull_rows_cuda"] != 2 * GM_STEPS or c["write_rows_cuda"] != GM_STEPS:
                raise AssertionError(f"gradient_merge: launches {c} for {GM_STEPS} steps")
            rpm = t._resident_cache[2]
            with flags(resident_scan_batches=LT_K):
                sstep = t._resident_superstep(rpm, False)
            state, idx_m = t._state, t._idx_cache[2][:LT_K]
            gm_syncs, gm_sites = host_syncs(lambda: sstep(state, idx_m))
            if gm_syncs:
                raise AssertionError(f"gradient_merge: a resident superstep made {gm_syncs} host syncs: {gm_sites}")
        merged[str(device)] = snaps
    gm_err = max(float((merged[str(dev)][i][k] - merged["cpu"][i][k]).abs().max())
                 for i in range(GM_K - 1, GM_STEPS, GM_K) for k in merged["cpu"][i])
    if gm_err > SMALL_PARAMS_ATOL:
        raise AssertionError(f"gradient_merge: the emitting steps' params card vs CPU {gm_err} > {SMALL_PARAMS_ATOL}")
    print(f"strategy: recompute bitwise the plain DeepFM over a {LT_STEPS}-step superstep; gradient_merge "
          f"(k={GM_K}) over {GM_STEPS} steps: params bitwise unchanged on mini-steps 1-3 and 5-7, steps 4 and 8 "
          f"within {SMALL_PARAMS_ATOL} of the CPU path (max |diff| {gm_err:.3e}), 0 host syncs in a MultiSteps "
          f"superstep; {card}", flush=True)
    return counts, {"amp_logits_max_abs": amp_err, "amp_bound": amp_bound, "gradient_merge_params_max_abs": gm_err,
                    "gradient_merge_superstep_host_syncs": gm_syncs}


def long_tail_phase(args, dev, card, ck, pull_push, mesh18):
    """Phase 18: the extended trainer at full width, the replica cache,
    the ops and the strategy on the card, and the extended mesh's results
    (run in phase 12's worlds). Returns (launch counts by path, the
    kernels' rows at the phase's shapes, max abs error)."""
    from paddlebox_tpu_torch.train import build_device_batch

    t_phase = time.perf_counter()
    lay = lt_layout()
    print(f"phase 18: ValueLayout(embedx_dim={EMBEDX_DIM}, expand_embed_dim={LT_EXPAND}).width = {lay.width}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lt_") as tmp:
        files, _ = write_bench_files(tmp, np.random.default_rng(args.seed + LT_SEED), LT_FILES, "lt")
        ds = lt_dataset(args.seed + LT_SEED, files)
    counts, nums, tr = expand_trainer_check(args, dev, card, ck, pull_push, ds)
    # both kernels at the extended training shape: a resident batch's rows
    rp = tr._resident_cache[2]
    tab = torch.from_numpy(ds.device_table.reshape(-1, lay.width).copy()).to(dev)
    rows = build_device_batch(rp, tr.cfg, tr._idx_cache[2][0])["uniq_rows"]
    n_uniq = int((rows != rp.pad_row).sum())
    shapes = {}
    shapes["pull_rows_cuda"], gerr = kernel_shape_row(ck, dev, card, tab, rows, "expand_train", n_uniq, False)
    shapes["write_rows_cuda"], werr = kernel_shape_row(ck, dev, card, tab, rows, "expand_train", n_uniq, True)
    cache_counts, cache_shape = replica_cache_check(args, dev, card, ck)
    counts.update(cache_counts)
    op_errs = ops_check(args, dev, card)
    strat_counts, strat = strategy_check(args, dev, card, ck, ds, tr)
    counts.update(strat_counts)
    counts.update(mesh18["counts"])
    phase_s = time.perf_counter() - t_phase
    emit({"card": card, "phase": "long_tail", "expand": nums, "expand_mesh": mesh18["nums"],
          "replica_cache": cache_shape, "ops_card_vs_cpu_max_abs": op_errs, "strategy": strat,
          "launches": counts, "phase_s": phase_s})
    print(f"phase 18 (long_tail) in {phase_s:.3f} s, its mesh runs in phase 12's spawns; {card}", flush=True)
    return counts, {"expand_train": shapes, "replica_cache": cache_shape}, max(gerr, werr, mesh18["err"])



# ---- 19. pipeline parallelism: the GPipe step over a pp axis, pp x dp, ZeRO-1

PP_SEED = 19  # the phase's seed offset: the stages' weights and the data
PP_TOWER = (NUM_SLOTS * (3 + EMBEDX_DIM),) + HIDDEN + (1,)  # DeepFM's dense tower: 741 -> 512 -> 256 -> 128 -> 1
PP_MICRO = 4  # micro_batch: BATCH as 4 microbatches of 1024
PP_STEPS = 8
PP_LR = 1e-4  # Adam at 1e-3 moves the relu output below 0 for every sample in one step
# Adam's eps: at optax's 1e-8 the step is lr * sign(g) for any |g| >> 1e-8, so
# a gradient element near 0 whose sign fp32 summation order decides (cuBLAS
# sums the padded [741, 741] and the unpadded [741, 512] products apart)
# parts the two runs by 2 lr a step, past the weight bound. At 1e-3 the
# update is smooth in g and the comparison holds the schedule's arithmetic
PP_EPS = 1e-3
PP_2D = (2, 2)  # the new gloo world on cuda:0: pp x dp
PP_TIMEOUT_S = 120.0  # the spawned groups' timeout, well under the default 300 s
# tests/test_pipeline_hetero.py's bounds against the unpadded net on one
# device; tests/test_pipeline.py's for ZeRO-1 against plain Adam and for
# pp x dp against the 1-D pipeline
PP_LOSS_RTOL, PP_W_RTOL, PP_W_ATOL = 5e-5, 5e-4, 5e-5
PP_ZERO_RTOL, PP_ZERO_ATOL = 1e-6, 1e-7
PP_FIRST_RTOL = 2e-5


def pp_widths(n_pp):
    """The tower's 4 layers cut into ``n_pp`` stages, the earlier stages
    taking the extra layer: 2 stages are [[741, 512, 256], [256, 128, 1]]."""
    n_layers = len(PP_TOWER) - 1
    sizes = [n_layers // n_pp + (1 if i < n_layers % n_pp else 0) for i in range(n_pp)]
    cuts = np.cumsum([0] + sizes)
    return [list(PP_TOWER[cuts[i] : cuts[i + 1] + 1]) for i in range(n_pp)]


def pp_stages(seed, n_pp):
    """(padded stages, unpadded layers) of the tower cut into ``n_pp``
    stages; the layers are drawn in order, so every cut is one network."""
    from paddlebox_tpu_torch.parallel import hetero_mlp_stage_init

    return hetero_mlp_stage_init(torch.Generator().manual_seed(seed + PP_SEED), pp_widths(n_pp))


def pp_data(seed):
    """x [PP_MICRO, BATCH / PP_MICRO, 741] and tanh targets for lane 0."""
    rng = np.random.default_rng(seed + PP_SEED)
    mb = BATCH // PP_MICRO
    x = rng.normal(size=(PP_MICRO, mb, PP_TOWER[0])).astype(np.float32)
    return x, np.tanh(rng.normal(size=(PP_MICRO, mb, 1))).astype(np.float32)


def pp_loss(y, tgt):
    """tests/test_pipeline_hetero.py's loss: MSE of the output lane against tanh targets."""
    return ((y[..., :1] - tgt) ** 2).mean()


def pp_run(mesh, spec, opt, seed, x, t, dp_axis=None):
    """PP_STEPS steps on this rank: (losses, stage params, ms a step,
    the first step's collectives by axis, kernel launches)."""
    from paddlebox_tpu_torch.ops import cuda_kernels as ck
    from paddlebox_tpu_torch.parallel import hetero_mlp_stage_apply, init_pipeline_state, make_pipeline_train_step

    pp = mesh.along(spec.axis_name)
    stages, _ = pp_stages(seed, pp.world)
    state = init_pipeline_state(mesh, stages, opt, axis=spec.axis_name, dp_axis=dp_axis)
    step = make_pipeline_train_step(hetero_mlp_stage_apply, pp_loss, opt, spec, mesh, dp_axis=dp_axis)
    axes = [a for a in (spec.axis_name, dp_axis) if a]
    losses, ms, calls = [], [], []
    ck.reset_launch_counts()
    for _ in range(PP_STEPS):
        mesh.reset_calls()
        torch.cuda.synchronize(pp.device)
        t0 = time.perf_counter()
        state, loss = step(state, x, t)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
        calls.append({a: dict(mesh.along(a).calls) for a in axes})
    if any(c != calls[0] for c in calls):
        raise AssertionError(f"pipeline: the steps' collectives differ: {calls}")
    params = {k: v.cpu().numpy() for k, v in state[0].items()}
    return losses, params, ms, calls[0], dict(ck.launch_counts)


def pipeline_rank(plan, spec):
    """Phase 19 on one rank of a spawned world: the pipeline over the whole
    world as ``pp`` (``kind`` "pp"), or the pp x dp world run with plain
    Adam and with ZeRO-1 from the strategy (``kind`` "2d"). Writes the
    losses, this rank's stage params, its ms a step, the collectives and
    the kernel launches to ``spec["out"]``."""
    from paddlebox_tpu_torch.fleet import DistributedStrategy, Zero1Optimizer
    from paddlebox_tpu_torch.parallel import make_mesh_2d
    from paddlebox_tpu_torch.train import Adam

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x, t = (torch.from_numpy(a).to(plan.device) for a in pp_data(spec["seed"]))
    res, arrs = {"rank": plan.rank, "world": plan.world, "backend": plan.backend}, {}
    # the groups of the pipeline's axes time out after PP_TIMEOUT_S, so a
    # hung shift fails the spawn well before the world's own timeout
    if spec["kind"] == "pp":  # pp = the world, over a group of its own
        mesh = make_mesh_2d(plan.world, 1, backend=plan.backend, device=plan.device, timeout_s=PP_TIMEOUT_S)
        strategy = DistributedStrategy(pipeline=True, pipeline_configs={"micro_batch": PP_MICRO})
        runs = {"adam": (Adam(PP_LR, eps=PP_EPS), None)}
    else:
        mesh = make_mesh_2d(*PP_2D, backend=plan.backend, device=plan.device, timeout_s=PP_TIMEOUT_S)
        strategy = DistributedStrategy(pipeline=True, sharding=True,
                                       pipeline_configs={"micro_batch": PP_MICRO, "dp_degree": PP_2D[1]})
        runs = {"adam": (Adam(PP_LR, eps=PP_EPS), "dp"),
                "zero": (Zero1Optimizer(Adam(PP_LR, eps=PP_EPS), axis_name="dp", n_dev=strategy.pipeline_dp_degree),
                         "dp")}
    spec_pp = strategy.pipeline_spec()
    res["pp_rank"], res["n_pp"] = mesh.along("pp").rank, mesh.along("pp").world
    for name, (opt, dp_axis) in runs.items():
        losses, params, ms, calls, launches = pp_run(mesh, spec_pp, opt, spec["seed"], x, t, dp_axis)
        res[name] = {"losses": losses, "ms": ms, "calls": calls, "launches": launches}
        arrs.update({f"{name}:{k}": v for k, v in params.items()})
    np.savez(os.path.join(spec["out"], f"rank{plan.rank}.npz"), **arrs)
    with open(os.path.join(spec["out"], f"rank{plan.rank}.json"), "w") as f:
        json.dump(res, f)


def pp_reference(seed, dev, x, t):
    """The unpadded tower in order on one device with the port's Adam:
    (losses, the trained layers as numpy (w, b))."""
    from paddlebox_tpu_torch.train import Adam

    _, raw = pp_stages(seed, 1)
    layers = {f"{i}:{k}": torch.from_numpy(a).to(dev) for i, wb in enumerate(raw[0]) for k, a in zip("wb", wb)}
    opt = Adam(PP_LR, eps=PP_EPS)
    state = opt.init(layers)
    xs, ts = torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev)
    losses = []
    for _ in range(PP_STEPS):
        p = {k: v.detach().requires_grad_(True) for k, v in layers.items()}

        def net(h):
            for i in range(len(raw[0])):
                h = torch.relu(h @ p[f"{i}:w"] + p[f"{i}:b"])
            return h

        loss = torch.stack([pp_loss(net(xs[i]), ts[i]) for i in range(PP_MICRO)]).mean()
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        upd, state = opt.update(grads, state)
        layers = {k: layers[k] + upd[k] for k in layers}
        losses.append(float(loss.detach()))
    return losses, [(layers[f"{i}:w"].cpu().numpy(), layers[f"{i}:b"].cpu().numpy()) for i in range(len(raw[0]))]


def pp_check_world(what, ranks, run, ref_losses, ref_layers):
    """A world's run against the one-device reference: every rank's losses
    alike, within PP_LOSS_RTOL; each stage's real blocks within the weight
    bounds, its padding exactly 0 and its gates untouched. Returns
    (loss max rel, weight max abs)."""
    r0 = ranks[0][run]["losses"]
    for rk in ranks:
        if rk[run]["losses"] != r0:
            raise AssertionError(f"pipeline {what}: the ranks' losses differ")
    loss_d = float(np.max(np.abs(np.array(r0) - ref_losses) / np.abs(ref_losses)))
    if loss_d > PP_LOSS_RTOL:
        raise AssertionError(f"pipeline {what}: losses {r0} vs one device {ref_losses}: rel {loss_d} > {PP_LOSS_RTOL}")
    n_pp = ranks[0]["n_pp"]
    widths = pp_widths(n_pp)
    first = np.cumsum([0] + [len(w) - 1 for w in widths])
    w_d = 0.0
    for rk in ranks:
        s = rk["pp_rank"]
        w, b, g = rk[f"{run}:w"], rk[f"{run}:b"], rk[f"{run}:g"]
        L = w.shape[0]
        if g.tolist() != [1.0] * (len(widths[s]) - 1) + [0.0] * (L - len(widths[s]) + 1):
            raise AssertionError(f"pipeline {what} rank {rk['rank']}: the gates moved: {g.tolist()}")
        for l in range(len(widths[s]) - 1):
            d_in, d_out = widths[s][l], widths[s][l + 1]
            rw, rb = ref_layers[first[s] + l]
            for got, want in ((w[l, :d_in, :d_out], rw), (b[l, :d_out], rb)):
                w_d = max(w_d, float(np.abs(got - want).max()))
                if not np.allclose(got, want, rtol=PP_W_RTOL, atol=PP_W_ATOL):
                    raise AssertionError(f"pipeline {what} rank {rk['rank']} layer {l}: weights off the one-device "
                                         f"run by {np.abs(got - want).max()}")
            if w[l, d_in:].any() or w[l, :, d_out:].any() or b[l, d_out:].any():
                raise AssertionError(f"pipeline {what} rank {rk['rank']} layer {l}: the padding moved")
        for l in range(len(widths[s]) - 1, L):
            if w[l].any() or b[l].any():
                raise AssertionError(f"pipeline {what} rank {rk['rank']} gated layer {l}: moved")
    return loss_d, w_d


def pipeline_phase(args, dev, card, worlds, seqpar):
    """Phase 19: the GPipe step at the width of DeepFM's dense tower, in
    phase 12's worlds (``worlds``: pp = the world) and in a new gloo world
    of pp 2 x dp 2 on cuda:0, plain Adam and ZeRO-1; each against the
    unpadded tower on one device. Phase 20 runs in the new world's four
    ranks after it (``seqpar``: phase 20's worlds and reference). Returns
    the phase's numbers and phase 20's worlds with the new one."""
    from paddlebox_tpu_torch.fleet.launch import spawn

    t_phase = time.perf_counter()
    x, t = pp_data(args.seed)
    ref_losses, ref_layers = pp_reference(args.seed, dev, x, t)
    worlds20, p20 = seqpar
    n4 = PP_2D[0] * PP_2D[1]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pp_") as tmp:
        spec = {"kind": "2d", "seed": args.seed, "out": os.path.join(tmp, "19")}
        spec20 = seqpar_spec(p20, os.path.join(tmp, "20"), write_base=False)
        os.makedirs(spec["out"])
        os.makedirs(spec20["out"])
        t0 = time.perf_counter()
        spawn(pipeline_seqpar_rank, n4, f"file://{tmp}/rdv", backend="gloo", device="cuda:0",
              args=(spec, spec20), timeout_s=PP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        worlds = {**worlds, "gloo_2x2": (_read_ranks(spec["out"], n4), wall)}
        worlds20 = {**worlds20, "gloo_4": (_read_ranks(spec20["out"], n4), wall)}
    nums = {}
    for name, (ranks, wall) in worlds.items():
        n_pp = ranks[0]["n_pp"]
        n_dp = len(ranks) // n_pp
        for run in [r for r in ("adam", "zero") if r in ranks[0]]:
            what = f"{name} {run} (pp {n_pp} x dp {n_dp})"
            loss_d, w_d = pp_check_world(what, ranks, run, ref_losses, ref_layers)
            shifts = 2 * (PP_MICRO + n_pp - 2)
            want = {"pp": {"shift": shifts, "all_reduce": 1}}
            if n_dp > 1:
                want["dp"] = {"all_reduce": 1, "all_gather": 1 if run == "zero" else 0}
            for rk in ranks:
                got = {a: {k: rk[run]["calls"][a][k] for k in want[a]} for a in want}
                if got != want:
                    raise AssertionError(f"pipeline {what} rank {rk['rank']}: collectives {got}, want {want}")
                if any(rk[run]["launches"].values()):
                    raise AssertionError(f"pipeline {what}: launched kernels {rk[run]['launches']}")
            step_ms = float(np.median([max(rk[run]["ms"][i] for rk in ranks) for i in range(1, PP_STEPS)]))
            nums[f"{name}_{run}"] = {
                "n_pp": n_pp, "n_dp": n_dp, "widths": pp_widths(n_pp), "losses": ranks[0][run]["losses"],
                "vs_one_device": {"loss_max_rel": loss_d, "weights_max_abs": w_d},
                "step_ms_median": step_ms, "first_step_ms": max(rk[run]["ms"][0] for rk in ranks),
                "samples_per_s": BATCH / step_ms * 1e3, "shift_calls_per_step": shifts, "kernel_launches": 0,
                "spawn_wall_s": wall,
            }
            print(f"pipeline {what}: {PP_STEPS} steps of {PP_MICRO} x {BATCH // PP_MICRO} at {PP_TOWER}, within bounds "
                  f"of one device (loss rel {loss_d:.3g}, weights {w_d:.3g}), padding 0; median {step_ms:.3f} ms a "
                  f"step, {BATCH / step_ms * 1e3:.0f} samples/s, {shifts} shifts a step, 0 kernel launches; {card}",
                  flush=True)
    z, a = worlds["gloo_2x2"][0], "gloo_2x2"
    zd = 0.0
    for rk in z:
        zd = max(zd, float(np.max(np.abs(np.array(rk["zero"]["losses"]) - rk["adam"]["losses"])
                                  / np.abs(rk["adam"]["losses"]))))
        if zd > PP_ZERO_RTOL:
            raise AssertionError(f"pipeline {a} rank {rk['rank']}: ZeRO-1 losses off plain Adam's by rel {zd}")
        for k in ("w", "b", "g"):
            if not np.allclose(rk[f"zero:{k}"], rk[f"adam:{k}"], rtol=PP_ZERO_RTOL, atol=PP_ZERO_ATOL):
                raise AssertionError(f"pipeline {a} rank {rk['rank']}: ZeRO-1 {k} off plain Adam's")
    first2 = worlds["gloo"][0][0]["adam"]["losses"][0]
    first_d = abs(z[0]["adam"]["losses"][0] - first2) / abs(first2)
    if first_d > PP_FIRST_RTOL:
        raise AssertionError(f"pipeline: the 2x2 world's first loss is off the 2-rank pp world's by rel {first_d}")
    phase_s = time.perf_counter() - t_phase
    emit({"card": card, "phase": "pipeline", "tower": PP_TOWER, "micro_batch": PP_MICRO, "steps": PP_STEPS,
          "worlds": nums, "zero_vs_adam_max_rel": zd, "first_loss_2x2_vs_pp2_rel": first_d,
          "reference_losses": ref_losses, "phase_s": phase_s})
    print(f"phase 19 (pipeline) in {phase_s:.3f} s, its pp worlds in phase 12's spawns; {card}", flush=True)
    return nums, worlds20


# ---- 20. sequence parallelism: ring and Ulysses attention over the process group

SP_SEED = 20  # the phase's seed offset: q, k and v
# a 7B-class decoder's attention widths (Llama-2-7B: 32 heads of 128) over 8,192 positions
SP_B, SP_S, SP_H, SP_D = 1, 8192, 32, 128
SP_QBLOCK = 1024  # the plain reference's query block
SP_REPS = 3  # timed forwards, and forward + backward, a world
# tests/test_ring_attention.py's bounds
SP_FWD_RTOL, SP_FWD_ATOL = 2e-4, 2e-5
SP_GRAD_RTOL, SP_GRAD_ATOL = 5e-4, 5e-5
SP_BF16_MAX_ERR = 0.02
SP_IMPLS = ("ring", "ulysses")
SP_REF = ("out_nc", "out_c", "dq", "dk", "dv")  # fp32 full attention: outputs without and with the mask, causal grads


def sp_want_calls(impl, n):
    """The collectives of one forward and backward on every rank
    (``tests/test_torch_ring_attention.py``'s count)."""
    return {"shift": 2 * (n - 1), "all_to_all": 0} if impl == "ring" else {"shift": 0, "all_to_all": 4}


def sp_inputs(dev, seed):
    """q, k, v [SP_B, SP_S, SP_H, SP_D] fp32, drawn on ``dev`` from the seed
    (every rank draws the same values and keeps its block)."""
    g = torch.Generator(device=dev).manual_seed(seed + SP_SEED)
    return [torch.randn((SP_B, SP_S, SP_H, SP_D), generator=g, device=dev) for _ in range(3)]


def sp_plain(q, k, v, scale, allowed):
    """Full attention of a query block in plain ops, fp32: softmax of the
    scores, masked to -1e30 where ``allowed`` is False."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if allowed is not None:
        s = torch.where(allowed, s, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def seqpar_prepare(args, dev):
    """Phase 20's plain reference on one device, query block by query
    block: the outputs without and with the mask and the causal grads of
    sum(out), saved as ``.npy`` for the ranks; and empty files for the
    NCCL world's outputs, which the other worlds are held against.
    Returns the spec the ranks share."""
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_seqpar_")
    q, k, v = sp_inputs(dev, args.seed)
    kg, vg = k.clone().requires_grad_(True), v.clone().requires_grad_(True)
    pos = torch.arange(SP_S, device=dev)
    ref = {name: torch.empty_like(q) for name in ("out_nc", "out_c", "dq")}
    for lo in range(0, SP_S, SP_QBLOCK):
        hi = lo + SP_QBLOCK
        with torch.no_grad():
            ref["out_nc"][:, lo:hi] = sp_plain(q[:, lo:hi], k, v, SP_D ** -0.5, None)
        qb = q[:, lo:hi].clone().requires_grad_(True)
        ob = sp_plain(qb, kg, vg, SP_D ** -0.5, pos[lo:hi, None] >= pos[None, :])
        ob.sum().backward()
        ref["out_c"][:, lo:hi], ref["dq"][:, lo:hi] = ob.detach(), qb.grad
    ref["dk"], ref["dv"] = kg.grad, vg.grad
    paths = {name: os.path.join(tmp.name, f"{name}.npy") for name in SP_REF}
    for name in SP_REF:
        np.save(paths[name], ref[name].cpu().numpy())
    base = {}
    for impl in SP_IMPLS:
        for causal in (False, True):
            base[f"{impl}_{causal}"] = os.path.join(tmp.name, f"base_{impl}_{causal}.npy")
            np.lib.format.open_memmap(base[f"{impl}_{causal}"], mode="w+", dtype=np.float32,
                                      shape=(SP_B, SP_S, SP_H, SP_D)).flush()
    del q, k, v, kg, vg, ref, qb, ob
    torch.cuda.empty_cache()
    return {"tmp": tmp, "seed": args.seed, "ref": paths, "base": base, "prepare_s": time.perf_counter() - t0}


def seqpar_spec(prep, out, write_base):
    """One world's spec: ``write_base`` for the NCCL world, whose outputs
    the later worlds are held against."""
    return {"seed": prep["seed"], "ref": prep["ref"], "base": prep["base"], "out": out, "write_base": write_base}


def sp_check(what, got, want, rtol, atol):
    """Max abs error of ``got`` against ``want``; raises past rtol / atol."""
    d = (got.float() - want).abs()
    err = float(d.max())
    if bool((d > atol + rtol * want.abs()).any()):
        raise AssertionError(f"seqpar {what}: off by up to {err}, past rtol {rtol} / atol {atol}")
    return err


def sp_ms(fn, dev):
    """SP_REPS host-clock ms of ``fn``, each ended by a synchronize."""
    ms = []
    for _ in range(SP_REPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def seqpar_rank(plan, spec):
    """Phase 20 on one rank of a spawned world (the plan's own 1-D axis):
    ring and Ulysses attention on this rank's block of the sequence,
    causal and not, fp32 and bf16, and the causal grads of sum(out), each
    against the plain reference's block; the NCCL world writes its
    outputs, a later world is held against them. Writes the errors, the
    collectives, the timings, the peak memory and the kernel launches to
    ``spec["out"]``."""
    from paddlebox_tpu_torch.ops import cuda_kernels as ck
    from paddlebox_tpu_torch.parallel import ring_attention, ulysses_attention

    t_rank = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, n, r = plan.device, plan.world, plan.rank
    ck.reset_launch_counts()
    lo, hi = r * SP_S // n, (r + 1) * SP_S // n
    q, k, v = (x[:, lo:hi].contiguous() for x in sp_inputs(dev, spec["seed"]))
    # after the first allocation on the card, which sets up its allocator
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    def block(path):
        return torch.from_numpy(np.array(np.load(path, mmap_mode="r")[:, lo:hi])).to(dev)

    ref = {name: block(path) for name, path in spec["ref"].items()}
    what = f"{plan.backend} world {n} rank {r}"
    res = {"rank": r, "world": n, "backend": plan.backend, "err": {}, "calls": {},
           "section_s": {"inputs_and_reference": time.perf_counter() - t_rank}}
    arrs = {}
    for impl, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        t_impl = time.perf_counter()
        for causal in (False, True):
            with torch.no_grad():
                out = fn(q, k, v, plan, causal=causal)
            key = f"{impl}_{causal}"
            res["err"][f"{key}_vs_full"] = sp_check(f"{what} {key}", out, ref["out_c" if causal else "out_nc"],
                                                    SP_FWD_RTOL, SP_FWD_ATOL)
            if spec["write_base"]:
                mm = np.load(spec["base"][key], mmap_mode="r+")
                mm[:, lo:hi] = out.cpu().numpy()
                mm.flush()
                del mm
            else:
                res["err"][f"{key}_vs_nccl_world"] = sp_check(f"{what} {key} against the NCCL world", out,
                                                              block(spec["base"][key]), SP_FWD_RTOL, SP_FWD_ATOL)
            del out
        res["section_s"][f"{impl}_fp32_checks"] = time.perf_counter() - t_impl
        t_impl = time.perf_counter()
        with torch.no_grad():
            ob = fn(q.bfloat16(), k.bfloat16(), v.bfloat16(), plan, causal=True)
        if ob.dtype != torch.bfloat16:
            raise AssertionError(f"seqpar {what} {impl}: bf16 inputs gave {ob.dtype}")
        res["err"][f"{impl}_bf16_vs_full"] = err = float((ob.float() - ref["out_c"]).abs().max())
        if err >= SP_BF16_MAX_ERR:
            raise AssertionError(f"seqpar {what} {impl}: bf16 off fp32 full attention by {err}")
        del ob
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        plan.reset_calls()
        fn(*leaves, plan, causal=True).sum().backward()
        res["calls"][impl] = {c: plan.calls[c] for c in ("shift", "all_to_all")}
        if res["calls"][impl] != sp_want_calls(impl, n):
            raise AssertionError(f"seqpar {what} {impl}: collectives {res['calls'][impl]}, want "
                                 f"{sp_want_calls(impl, n)}")
        for x, name in zip(leaves, ("dq", "dk", "dv")):
            res["err"][f"{impl}_{name}"] = sp_check(f"{what} {impl} {name}", x.grad, ref[name], SP_GRAD_RTOL,
                                                    SP_GRAD_ATOL)
        del leaves
        res["section_s"][f"{impl}_bf16_and_grad_checks"] = time.perf_counter() - t_impl
        t_impl = time.perf_counter()

        def fwd():
            with torch.no_grad():
                fn(q, k, v, plan, causal=True)

        def fwd_bwd():
            fn(*(x.detach().requires_grad_(True) for x in (q, k, v)), plan, causal=True).sum().backward()

        arrs[f"{impl}_fwd_ms"], arrs[f"{impl}_step_ms"] = sp_ms(fwd, dev), sp_ms(fwd_bwd, dev)
        res["section_s"][f"{impl}_timing"] = time.perf_counter() - t_impl
    res["launches"] = dict(ck.launch_counts)
    if any(res["launches"].values()):
        raise AssertionError(f"seqpar {what}: launched kernels {res['launches']}")
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    res["rank_s"] = time.perf_counter() - t_rank
    np.savez(os.path.join(spec["out"], f"rank{r}.npz"), **arrs)
    with open(os.path.join(spec["out"], f"rank{r}.json"), "w") as f:
        json.dump(res, f)


def pipeline_seqpar_rank(plan, spec19, spec20):
    """Phase 19's pp x dp world, then phase 20 over the same four ranks as
    one 1-D world."""
    pipeline_rank(plan, spec19)
    seqpar_rank(plan, spec20)


def seqpar_phase(card, worlds, prep):
    """Phase 20: each world's ranks (run inside the spawns of phases 12-13
    and 19) checked their blocks, collectives and launches and raised on a
    failure; here the worlds' numbers are printed. Returns the kernels'
    launches over every rank (0)."""
    t0 = time.perf_counter()
    nums, launches = {}, dict.fromkeys(KERNEL_NAMES, 0)
    for name, (ranks, wall) in worlds.items():
        n = len(ranks)
        for rk in ranks:
            for kname, c in rk["launches"].items():
                launches[kname] += c
        err = {k: max(rk["err"][k] for rk in ranks) for k in ranks[0]["err"]}
        ms = {f"{impl}_{kind}": float(np.median([max(rk[f"{impl}_{kind}"][i] for rk in ranks)
                                                 for i in range(SP_REPS)]))
              for impl in SP_IMPLS for kind in ("fwd_ms", "step_ms")}
        nums[name] = {"world": n, "backend": ranks[0]["backend"], "max_abs_err": err, "median_ms": ms,
                      "collectives": ranks[0]["calls"],
                      "max_memory_allocated_gb": [rk["max_memory_allocated"] / 1e9 for rk in ranks],
                      "rank_s": max(rk["rank_s"] for rk in ranks),
                      "section_s_rank0": ranks[0]["section_s"], "spawn_wall_s": wall}
        mem = ", ".join(f"{m:.2f}" for m in nums[name]["max_memory_allocated_gb"])
        print(f"seqpar {name} world {n}: ring and Ulysses at B {SP_B}, S {SP_S}, H {SP_H}, D {SP_D}, causal and not, "
              f"fp32 within rtol {SP_FWD_RTOL} / atol {SP_FWD_ATOL} of full attention, bf16 under {SP_BF16_MAX_ERR}, "
              f"causal grads within rtol {SP_GRAD_RTOL} / atol {SP_GRAD_ATOL}, collectives "
              f"{ranks[0]['calls']}, 0 kernel launches; median ms causal fp32: ring fwd {ms['ring_fwd_ms']:.3f}, "
              f"fwd+bwd {ms['ring_step_ms']:.3f}, ulysses fwd {ms['ulysses_fwd_ms']:.3f}, fwd+bwd "
              f"{ms['ulysses_step_ms']:.3f}; max_memory_allocated {mem} GB a rank; {card}", flush=True)
    prep["tmp"].cleanup()
    report_s = time.perf_counter() - t0
    phase_s = prep["prepare_s"] + sum(w["rank_s"] for w in nums.values()) + report_s
    emit({"card": card, "phase": "seqpar", "shape": {"B": SP_B, "S": SP_S, "H": SP_H, "D": SP_D},
          "reps": SP_REPS, "worlds": nums, "prepare_s": prep["prepare_s"], "report_s": report_s,
          "phase_s": phase_s, "launches": launches})
    ranks_s = ", ".join(f"{k} {w['rank_s']:.3f}" for k, w in nums.items())
    print(f"phase 20 (seqpar) in {phase_s:.3f} s: the reference {prep['prepare_s']:.3f} s, the ranks {ranks_s} s "
          f"inside the spawns of phases 12-13 and 19; {card}", flush=True)
    return {"seqpar": launches}


# ---- 21. the compile cache: fresh copies of the package, cold and warm -----

CC_FILES = 1  # the pass's part files, bench.py's 16 cut for the phase's time: 2 steps
CC_DATE = "20261021"
CC_SEED = 21
CC_R, CC_U = 2_514_944, 122_880  # phase 7's training shape: the pass table's rows, a step's gather ids
CC_TIMEOUT_S = 300.0
CC_MODES = ("auto", "explicit")
# a fresh process started in a fresh copy: '' (its working directory)
# leads sys.path, so it imports the copy's package and this script's copy
CC_CHILD = "import sys, chip_smoke; sys.exit(chip_smoke.compile_cache_child(sys.argv[1]))"


def _fresh_copy(dst):
    """The package and this script as a checkout holds them: no ``_build/``
    and no bytecode. The pass runs on the Python tier, so the copy needs no
    native sources and g++ builds nothing into its ``_build/``."""
    shutil.copytree(os.path.join(REPO, "paddlebox_tpu_torch"), os.path.join(dst, "paddlebox_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), dst)


def compile_cache_child(spec_path) -> int:
    """Phase 21 in one fresh process, from its fresh copy of the package:
    ``compile_cache_dir`` as the spec says, a PassSupervisor over a
    CheckpointManager at the spec's root (which enables the cache before
    any kernel is built), one supervised pass of the spec's files at
    bench.py's width on the Python tier, each step timed to the card's
    end; then both kernels bitwise against their plain versions at phase
    7's training shape. Writes its record and its state's arrays to the
    spec's ``out``."""
    with open(spec_path) as f:
        spec = json.load(f)
    import paddlebox_tpu_torch

    here = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.dirname(os.path.abspath(paddlebox_tpu_torch.__file__))
    if pkg != os.path.join(here, "paddlebox_tpu_torch"):
        raise AssertionError(f"the child imported {pkg}, not its copy's package")
    from paddlebox_tpu_torch import config
    from paddlebox_tpu_torch.ops import cuda_kernels as ck
    from paddlebox_tpu_torch.table import ValueLayout
    from paddlebox_tpu_torch.utils import compilecache

    dev = torch.device("cuda")
    config.set_flag("compile_cache_dir", spec["cache_flag"])
    config.set_flag("enable_native_parser", False)
    lay = ValueLayout(embedx_dim=EMBEDX_DIM)
    t0 = time.perf_counter()
    s = sup_stack(SimpleNamespace(seed=spec["seed"]), lay, bench_schema(), spec["root"])
    if s.table.native or compilecache.enabled_dir() != spec["cache_dir"]:
        raise AssertionError(f"native table {s.table.native}, cache {compilecache.enabled_dir()} (want "
                             f"{spec['cache_dir']})")
    step, step_s, losses = s.tr._step, [], []

    def timed_step(state, feed):
        t1 = time.perf_counter()
        state, m = step(state, feed)
        losses.append(float(m["loss"]))  # waits for the step on the card
        step_s.append(time.perf_counter() - t1)
        return state, m

    s.tr._step = timed_step
    ck.reset_launch_counts()
    t1 = time.perf_counter()
    outs = s.sup.run_day(CC_DATE, [spec["files"]])
    rec = {"stack_s": t1 - t0, "pass_s": time.perf_counter() - t1, "launches": dict(ck.launch_counts),
           "steps": len(step_s), "step_s": step_s, "losses": losses, "incidents": len(s.sup.incidents),
           "feed": s.tr.last_feed, "batches": outs[0]["batches"], "stats": compilecache.stats(),
           "nvcc_runs": ck.nvcc_runs(), "pkg": pkg}
    build = os.path.join(here, "paddlebox_tpu_torch", "_build")
    rec["own_build"] = sorted(os.listdir(build)) if os.path.isdir(build) else None
    g = torch.Generator(device=dev).manual_seed(spec["seed"])
    table = torch.randn((CC_R, lay.width), device=dev, generator=g)
    rows = torch.randint(0, CC_R, (CC_U,), device=dev, generator=g, dtype=torch.int32)
    uniq = torch.randperm(CC_R, device=dev, generator=g)[:CC_U].to(torch.int32)
    new_rows = torch.randn((CC_U, lay.width), device=dev, generator=g)
    what = f"R={CC_R} U={CC_U} W={lay.width} ({spec['name']})"
    rec["kernel_err"] = max(check_gather(ck, table, rows, what), check_write(ck, table, uniq, new_rows, what))
    keys = np.sort(s.table.keys())
    arrays = {"keys": keys, "rows": s.table.pull_or_create(keys), "losses": np.asarray(losses)}
    for k, v in s.tr.params.items():
        arrays[f"param/{k}"] = v.cpu().numpy()
        arrays[f"mu/{k}"] = s.tr.opt_state.mu[k].cpu().numpy()
        arrays[f"nu/{k}"] = s.tr.opt_state.nu[k].cpu().numpy()
    arrays["count"] = s.tr.opt_state.count.cpu().numpy()
    np.savez(os.path.join(spec["out"], "state.npz"), **arrays)
    with open(os.path.join(spec["out"], "rec.json"), "w") as f:
        json.dump(rec, f)
    return 0


def _run_children(specs):
    """Each spec's child at once, each in its copy; waits for all, and
    kills every one still running when one fails or outlives
    CC_TIMEOUT_S. Returns each child's record and state by name."""
    env = dict(os.environ, PBOX_NATIVE_TABLE="0")
    procs = {}
    try:
        for spec in specs:
            path = os.path.join(spec["out"], "spec.json")
            with open(path, "w") as f:
                json.dump(spec, f)
            with open(os.path.join(spec["out"], "log.txt"), "w") as log:
                procs[spec["name"]] = subprocess.Popen([sys.executable, "-c", CC_CHILD, path], cwd=spec["copy"],
                                                       env=env, stdout=log, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + CC_TIMEOUT_S
        for spec in specs:
            rc = procs[spec["name"]].wait(timeout=max(1.0, deadline - time.monotonic()))
            if rc != 0:
                with open(os.path.join(spec["out"], "log.txt")) as f:
                    tail = f.read()[-4000:]
                raise AssertionError(f"compile cache child {spec['name']} exited {rc}:\n{tail}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {}
    for spec in specs:
        with open(os.path.join(spec["out"], "rec.json")) as f:
            rec = json.load(f)
        with np.load(os.path.join(spec["out"], "state.npz")) as z:
            out[spec["name"]] = (rec, {k: z[k] for k in z.files})
    return out


def compile_cache_phase(args, card):
    """Phase 21: the compile cache over the kernels' nvcc builds, in fresh
    processes from fresh copies of the package (each ``_build/`` empty).
    Under "auto" a cold process with a fresh checkpoint root, then a warm
    one on the same root; with an explicit directory a cold and a warm
    process on fresh roots sharing it; the two cold ones at once, then the
    two warm ones. Returns the launch counts by path and the kernels' max
    abs error."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + CC_SEED)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_compile_cache_") as tmp:
        files, _ = write_bench_files(tmp, rng, CC_FILES, "cc21")
        explicit = os.path.join(tmp, "explicit-cache")
        runs = {}
        for state in ("cold", "warm"):
            specs = []
            for mode in CC_MODES:
                name = f"{mode}_{state}"
                root = os.path.join(tmp, "auto-root" if mode == "auto" else f"{name}-root")
                spec = {"name": name, "seed": args.seed, "files": files, "root": root,
                        "cache_flag": "auto" if mode == "auto" else explicit,
                        "cache_dir": os.path.join(root, "compile_cache") if mode == "auto" else explicit,
                        "copy": os.path.join(tmp, f"copy-{name}"), "out": os.path.join(tmp, f"out-{name}")}
                _fresh_copy(spec["copy"])
                os.makedirs(spec["out"])
                specs.append(spec)
            t0 = time.perf_counter()
            got = _run_children(specs)
            for spec in specs:
                rec = got[spec["name"]][0]
                rec["wall_s"] = time.perf_counter() - t0
                rec["entries_dir"] = sorted(n for n in os.listdir(spec["cache_dir"]) if n.endswith(".so"))
                rec["auto_dir_exists"] = os.path.isdir(os.path.join(spec["root"], "compile_cache"))
            runs.update(got)
    counts, nums, errs = {}, {}, []
    ref_rec, ref = runs["auto_cold"]
    for name, (rec, arrays) in runs.items():
        cold = name.endswith("cold")
        st = rec["stats"]
        n_src = len(ck._LAUNCHERS)  # a supervised pass loads every kernel
        want = {"hits": 0, "misses": n_src} if cold else {"hits": n_src, "misses": 0}
        built = sorted(src for src, _ in rec["nvcc_runs"])
        checks = {
            "stats": {k: st[k] for k in want} == want and st["requests"] == n_src,
            "nvcc": built == (sorted(ck._LAUNCHERS) if cold else []),
            "entries": st["entries"] == n_src and len(rec["entries_dir"]) == n_src,
            "own _build/ empty": rec["own_build"] in (None, []),
            "auto dir only under auto": rec["auto_dir_exists"] == name.startswith("auto"),
            "launches": rec["launches"] == want_launches(2 * rec["steps"], rec["steps"]),
            "steps": rec["steps"] == CC_FILES * RECORDS_PER_FILE // BATCH == rec["batches"],
            "no incident": rec["incidents"] == 0,
            "bitwise the cold auto process": arrays.keys() == ref.keys()
            and all(np.array_equal(arrays[k], ref[k]) for k in ref),
        }
        if not all(checks.values()):
            raise AssertionError(f"compile cache {name}: failed {[k for k, v in checks.items() if not v]}: "
                                 f"stats {st}, nvcc {rec['nvcc_runs']}, entries {rec['entries_dir']}, own _build/ "
                                 f"{rec['own_build']}, launches {rec['launches']} for {rec['steps']} steps")
        counts[f"compile_cache_{name}"] = rec["launches"]
        errs.append(rec["kernel_err"])
        nums[name] = {"stats": st, "nvcc_runs": rec["nvcc_runs"], "first_step_s": rec["step_s"][0],
                      "later_step_s": rec["step_s"][1:], "stack_s": rec["stack_s"], "pass_s": rec["pass_s"],
                      "wall_s": rec["wall_s"], "feed": rec["feed"], "launches": rec["launches"]}
        nvcc = ", ".join(f"{src} {t:.3f} s" for src, t in rec["nvcc_runs"]) or "none"
        print(f"compile cache {name}: a fresh process from a fresh copy, {rec['steps']} supervised steps on the "
              f"{rec['feed']} feed; requests {st['requests']}, misses {st['misses']}, hits {st['hits']}, entries "
              f"{st['entries']}; nvcc runs: {nvcc}; its own _build/ {rec['own_build'] or 'absent'}; first step "
              f"{rec['step_s'][0]:.3f} s, later steps {[round(t, 4) for t in rec['step_s'][1:]]} s; the pass "
              f"{rec['pass_s']:.3f} s; launches {rec['launches']}; table, params, Adam state and losses bitwise the "
              f"cold auto process's; both kernels bitwise at R {CC_R}, U {CC_U}; {card}", flush=True)
    nums["phase_s"] = time.perf_counter() - t_phase
    emit({"card": card, "phase": "compile_cache", "files": CC_FILES, "records": CC_FILES * RECORDS_PER_FILE,
          **nums, "launches": counts})
    print(f"phase 21 (compile cache) in {nums['phase_s']:.3f} s; {card}", flush=True)
    return counts, max(errs)


MERGE_CELLS = ("deepfm-criteo.steady", "widedeep-criteo.steady", "dlrm-dcnv2-criteo1tb.multihot")
MERGE_BUCKET = 2048  # batch_bucket_rounding: L_pad and U_pad as the resident feed pads them


def merge_inputs(cell: str, seed: int):
    """One step's merge inputs at a benchmark cell's shape, in numpy: the
    cell's key draw for one batch (``bench_port``'s traffic), flattened
    slot-major as the resident builder lays the keys out, deduplicated
    (``inverse``), padded to the feed's buckets with pad keys on the trash
    segment and the ``U_pad - 1`` slot. Returns (S, B, PW, inverse int32,
    segments int32, U_pad)."""
    from bench_port.core import manifest, multihot, traffic
    from paddlebox_tpu_torch.table import ValueLayout

    bench = manifest.load_benchmark()
    wl = manifest.workload(bench, cell)
    cfg, mix = manifest.config(bench, wl["config"]), manifest.traffic(wl["traffic"])
    rng = np.random.default_rng(seed)
    S, B = cfg["num_slots"], mix["batch"]
    if mix["loop"] == "multihot":
        sizes = np.asarray(cfg["multi_hot_sizes"])
        keys = multihot.make_pass(rng, B, cfg, mix).keys
        col_slot = np.repeat(np.arange(S), sizes)
        flat = np.concatenate([keys[:, col_slot == s].reshape(-1) for s in range(S)])
        seg = np.concatenate([np.repeat(s * B + np.arange(B), sizes[s]) for s in range(S)])
    else:
        keys = traffic.make_pass(rng, B, S, cfg.get("dense_dim", 0), cfg["key_space"], mix).keys
        flat = keys.T.reshape(-1)
        seg = (np.arange(S)[:, None] * B + np.arange(B)[None, :]).reshape(-1)
    uniq, inv = np.unique(flat, return_inverse=True)
    L, U = len(flat), len(uniq)
    L_pad = max(MERGE_BUCKET, -(-L // MERGE_BUCKET) * MERGE_BUCKET)
    U_pad = max(MERGE_BUCKET, -(-(U + 1) // MERGE_BUCKET) * MERGE_BUCKET)
    inv = np.concatenate([inv, np.full(L_pad - L, U_pad - 1)]).astype(np.int32)
    seg = np.concatenate([seg, np.full(L_pad - L, S * B)]).astype(np.int32)
    return S, B, ValueLayout(embedx_dim=cfg["embedx_dim"]).pull_width, inv, seg, U_pad


def merge_phase(args, dev, card, ck):
    """Phase 22: the push merge (``merge_rows_cuda``) at each benchmark
    cell's step shape, one batch of its traffic drawn from ``--seed + 22``:
    bitwise against its plain version on the card, then the median device
    ms of ``TIMING_REPS`` calls, L2 flushed (cold) and warm, of the kernel,
    the plain version (``merge_rows_ref`` given the order), the former
    merge (the plain version after ``argsort`` of ``inverse``) and the
    library yardstick (``torch.segment_reduce`` over the pre-sorted [L,
    PW + 2] rows), beside the byte bound and the rows' sector floor, and the
    light and heavy passes' device time under ``torch.profiler``. Returns
    (numbers by cell, launches)."""
    from paddlebox_tpu_torch.ops.seqpool_cvm import segment_sum

    t_phase = time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    nums = {}
    ck.reset_launch_counts()
    for cell in MERGE_CELLS:
        S, B, PW, inv, seg, U_pad = merge_inputs(cell, args.seed + 22)
        L = len(inv)
        counts = np.bincount(inv, minlength=U_pad)
        heavy = counts > ck.MERGE_HEAVY_MIN
        g = torch.Generator(device=dev).manual_seed(args.seed + 22)
        gflat = torch.randn((L, PW), device=dev, generator=g)
        labels = (torch.rand((B,), device=dev, generator=g) < 0.2).float()
        inverse = torch.from_numpy(inv).to(dev)
        segments = torch.from_numpy(seg).to(dev)
        order, offsets = ck.merge_order(inverse, U_pad)
        margs = (gflat, order, offsets, segments, labels, S, B)
        got, want = ck.merge_rows_cuda(*margs), ck.merge_rows_ref(*margs)
        torch.cuda.synchronize()
        for name, a, b in zip(("guniq", "show", "clk"), got, want):
            if not torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)):
                raise AssertionError(f"merge {cell}: {name} differs from the plain merge")
        del got, want
        valid = (segments < S * B).float()
        lab = labels[(segments % B).long()] * valid
        ext_sorted = torch.cat([gflat, valid[:, None], lab[:, None]], dim=1)[order]
        lengths = (offsets[1:] - offsets[:-1]).long()

        fns = {
            "kernel": lambda: ck.merge_rows_cuda(*margs),
            "plain": lambda: ck.merge_rows_ref(*margs),
            "former": lambda: segment_sum(torch.cat([gflat * valid[:, None], valid[:, None], lab[:, None]], dim=1),
                                          inverse, U_pad),
            "library": lambda: torch.segment_reduce(ext_sorted, "sum", lengths=lengths, axis=0, unsafe=True),
        }
        med, med_warm = time_fns(fns, flush)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            ck.merge_rows_cuda(*margs)
            torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            for part in ("merge_light_kernel", "merge_heavy_kernel"):
                if part in e.key:
                    t_us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
                    split[part] = split.get(part, 0.0) + t_us / 1e3
        row_bytes = PW * 4
        starts = np.arange(L, dtype=np.int64) * row_bytes
        row_sectors = int((((starts + row_bytes - 1) // 32) - (starts // 32) + 1).sum()) * 32
        side = L * (8 + 4) + (U_pad + 1) * 4 + U_pad * (PW + 2) * 4
        bound_ms = (L * row_bytes + side) / HBM_BYTES_PER_S * 1e3
        floor_ms = (row_sectors + side) / HBM_BYTES_PER_S * 1e3
        nums[cell] = {
            "L": L, "U_pad": U_pad, "U": int((counts[:-1] > 0).sum()), "PW": PW, "geometry": ck.merge_geometry(PW)._asdict(),
            "heavy_rows": int(heavy.sum()), "heavy_keys": int(counts[heavy].sum()), "longest_run": int(counts.max()),
            "ms": med["kernel"], "warm_ms": med_warm["kernel"], "plain_ms": med["plain"],
            "plain_warm_ms": med_warm["plain"], "former_ms": med["former"], "library_ms": med["library"],
            "library_warm_ms": med_warm["library"], "bound_ms": bound_ms, "bound_by": "bytes",
            "sector_floor_ms": floor_ms, "bound_share": bound_ms / med["kernel"], "profiled_ms": split,
        }
        print(f"merge {cell}: L {L}, U_pad {U_pad}, PW {PW}, heavy rows {int(heavy.sum())} holding "
              f"{int(counts[heavy].sum())} keys (longest {int(counts.max())}); bitwise the plain merge; kernel "
              f"{med['kernel']:.4f} ms cold / {med_warm['kernel']:.4f} warm (light {split.get('merge_light_kernel', 0):.4f},"
              f" heavy {split.get('merge_heavy_kernel', 0):.4f}), plain {med['plain']:.4f}, former {med['former']:.4f},"
              f" segment_reduce {med['library']:.4f}; byte bound {bound_ms:.4f} ms ({bound_ms / med['kernel']:.1%}), "
              f"sector floor {floor_ms:.4f}; {card}", flush=True)
        del gflat, ext_sorted, margs, fns, order, offsets
        torch.cuda.empty_cache()
    launches = dict(ck.launch_counts)
    emit({"card": card, "phase": "merge", "cells": nums, "launches": launches,
          "phase_s": time.perf_counter() - t_phase})
    return nums, launches


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (mapreduce_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (it exits non-zero without one, and in a directory
that holds this script and nothing else of the repo).  Phases, each of
which raises on failure:

1. build the CUDA kernels from ``mapreduce_tpu_torch/csrc`` (one nvcc per
   source and one per variant of a tile size for the A/Bs of phases 2, 3
   and 6, all started together), print each kernel's registers and
   spill bytes as ptxas reports them (``ptxas`` line; a flash, onesweep,
   plan, tokenize or segreduce kernel that spills fails the run) and
   the card's name and power limit; then the libraries are copied into
   a build directory of this run's own (:func:`own_build_dir`), which
   ``$MAPREDUCE_TPU_CACHE`` names for the rest of the run and for every
   child, so that the CLI phases' shape registry starts empty and their
   capacities depend on this run alone, not on what earlier runs left
   in the checkout's ``build/kernels``;
2. the tokenize kernel against its plain PyTorch version on one
   full-width chunk (4,194,816 bytes of the synthetic corpus): bit
   equality, then kernel / plain times beside the memory bound (the
   kernel as 20 launches replayed from one CUDA graph, see
   :func:`kernel_ms`), an A/B of its tile size (variant builds with
   ``-DMR_TOKENIZE_TILE``, each bit-equal, timed in turns) and one call
   captured in a CUDA graph and replayed 50 times, every output
   bit-equal to the first;
3. the segmented-reduce kernel against its plain version at the main
   path's shapes (the per-chunk combiner, the local reduce, the fold,
   and the 3-lane collision-verify monoid as its per-lane codes), with
   the same timings, tile
   A/B (``-DMR_SEGREDUCE_TILE``) and replay check for each shape, the
   time of the wrapper's packing of the value lanes alone, and
   ``torch.unique_consecutive`` as the library yardstick of the unit
   case (timed here only; the port never calls it);
4. the slice: ``DeviceWordCount(device="cuda", chunk_len=1<<22,
   config=bench_engine_config())`` over 16M words of the synthetic
   Europarl-shaped corpus (24 chunks, two 12-chunk waves, so the
   accumulator carries across waves), counts held against
   ``collections.Counter(data.split())``, launch counters read around
   each run: first the flagship bench's staged path (``stage``, timed
   as ``ingress_s`` with residency included, ``warm``, then
   ``count_staged``: no ``upload_s``, and ``memory_allocated()`` falls
   by the staged bytes once the handle is consumed; the ``staged``
   line), then the streaming ``count_bytes`` (input bytes held at once
   at most ``STREAM_PREFETCH`` waves); then a small collision-verify
   count (its callable monoid on the monoid kernel);
5. one more slice run under ``torch.profiler``: device time and events
   by group (the kernels, the library sort, host-to-device copies,
   memsets, the rest), counted over device-side events only, and the
   device busy share (device time over the profiled run's wall time, a
   floor, since the profiler lengthens that wall time); each tokenize
   and segreduce wrapper call (and, in phase 7, each exchange plan) must
   show as exactly one kernel event; from the run's Chrome trace, every
   host-to-device copy must be pinned (``Memcpy HtoD (Pinned ->
   Device)``) and on another stream than the kernels (the ``*_upload``
   line: the copies' device ms and the share overlapping kernel time);
6. the radix kernels against their plain versions on inputs the radix
   path makes from the corpus: ``radix_sort_pairs`` (one C call: a
   memset, the upfront kernel and 8 onesweep passes) at the combiner's
   852,072 rows, the local sort's 262,144 and the fold's 1,310,720, also
   against ``torch.sort``'s stable permutation of the packed key (the
   library yardstick), with the function bound (20 B a row), the
   traffic bound (196 B a row), the tile count and an A/B of the sort's
   tile size (variant builds, timed in turns); the fold-shape sort
   replayed 50 times from one CUDA graph, every output bit-equal to the
   first; the upfront kernel and one onesweep pass at the combiner and
   fold shapes; and ``radix_partition_plan`` over ``[8, 262,144]`` with
   9 buckets (one C call: a memset and ``plan_kernel``): kernel, plain
   and library (``torch.bincount``, the counts alone) times beside the
   memory bound, 50 replays from one CUDA graph bit-equal, and an A/B
   of the plan's tile size (variant builds with ``-DMR_PLAN_TILE``);
7. the radix slice: ``DeviceWordCount(Partitions(8, "cuda"),
   chunk_len=1<<22, config=replace(bench_engine_config(),
   sort_impl="radix"))`` over the same corpus with ``waves=2``: counts
   against ``Counter(data.split())``, the 8 x 8 traffic matrix against
   ``host_exchange_matrix``, launches of all five kernels (8 onesweep
   launches for each upfront one: a sort is one C call) and no plain
   call, then a profiled run (no ``torch.sort`` device time) and a run
   under a ``plan_rebalance`` partition map (same counts, the matrix
   against the host recompute under that table); then the tier policy
   ``sort_impl='tiered-radix'`` at the same shape (the ``tiered``
   line): (a) warm, tier ``radix`` from the first wave, no swap, the
   radix kernels launched; (b) under ``tiering.force_cold()``, wave 0
   on tier 0 (``torch.sort`` calls, no radix launch), at most one swap,
   then, once the specializer is done, a run served by ``radix``; (c)
   truly cold: ``python3 chip_smoke.py --cold tiered-radix`` and
   ``--cold radix`` each in a subprocess with an empty temporary build
   directory (``compile_cache.disable_compile_cache``) over 1M words (``first_dispatch_s`` and
   each library's build seconds); counts and matrices equal everywhere,
   and no tier-1 build may fail;
8. the resident sessions (``EngineSession``, the ``session`` line), launch
   counters read around each part, every kernel of its path launched and
   no plain call: (a) ``bench.py``'s ``measure_sustained`` at full size
   (its config, 1<<20-byte chunks, three tenants fed a 1.5M-word corpus
   each, seeds 0-2, 3 interleaved rounds after a warm feed) at P = 1 and
   at P = 8 on the radix path; after every feed the tenant's snapshot
   equals ``Counter`` of its own words times its feeds; each tenant's
   first feed and snapshot, then 6 rounds alternating one overflow read
   a feed (the port's) with one after every wave (the JAX feed's sync,
   by a wrapper of the engine's wave here); records/s over each mode's
   feeds, feed wall p50/p99, snapshot seconds, staleness (feed end to
   snapshot end, also after the window), resident bytes a stream and
   the peak a feed adds; (b) the flagship config as a session at P = 8, radix,
   with a partition map: the 24 chunks in 4 feeds, a ``plan_rebalance``
   of the stream's bucket histogram after the first, the last two feeds
   profiled (uploads pinned and off the kernels' stream); counts against
   ``Counter``, the traffic matrix against the host recompute under the
   two tables; an evict to ``mem:`` storage and the lazy restore of the
   next snapshot, bit-equal (``session_spill_s``,
   ``session_restore_s``), and ``SpillPolicy(max_resident=1)`` evicting
   the colder stream; (c) ``TopKWords(k=100)`` over the corpus in 4
   feeds, equal to ``host_topk``;
9. the job plane (``jobplane`` lines): (a) ``mapreduce_tpu_torch.cli.
   main(["wordcount", FILES, "--device", ...])`` in this process over the
   slice's corpus written as 24 files of whole lines, at P = 1 variadic
   (with the CLI's controllers on, its default, and once more with
   ``--no-autotune --no-speculative-reclaim``: the same stdout byte for
   byte, and no control decision recorded) and at ``--partitions 8
   --sort-impl radix``: ``RESULT`` and the 76K
   stdout lines against ``Counter`` of the files' words, launches of the
   path's kernels (tokenize and segreduce, and at P = 8 the three radix
   kernels) above 0 and no plain call; then, on a copy of the inputs of
   the run's largest segreduce call (and at P = 8 its largest radix sort
   and exchange plan), each kernel held bit for bit against its plain
   version; the server's ``loop`` wall, the device phase's split
   (prepare, ``compute_s``, ``upload_s``, ``first_dispatch_s``, retries,
   waves, ``device_result``, the result write), ``finalfn`` and the
   unique count; (b) the host plane (4 worker threads, 4 reducers)
   against the device plane (the default ``Partitions(1)``, variadic) on
   a ``dir:`` board and ``shared:`` storage over 200K words in 3 files:
   equal ``RESULT`` s, equal to the naive oracle, and stats with map,
   reduce and device sections; (c) a two-iteration ``"loop"`` on the
   device plane.  Before each run the example's module state (its
   ``_conf`` and ``RESULT``) is reset to a fresh process's.  Each
   ``Server.loop`` with worker threads runs in a thread joined under a
   timeout;
10. the flash-attention kernels against their plain versions on the card
   at the transformer slice's shape ``[4, 8, 2048, 128]`` bf16 causal,
   plus a full (non-causal) case and a ragged ``T = 2000``, ``D = 64``
   case: out, lse, dq, dk and dv; kernel, plain and bound times at the
   slice's shape, and ``F.scaled_dot_product_attention`` as the library
   yardstick: its forward for ``flash_fwd``, its backward alone (one
   call for dq, dk and dv; its device time under the profiler) for
   ``flash_dq`` and ``flash_dkv``, and
   forward + backward (timed here only; the port never calls it); then
   the three kernels once more without the causal mask and with 4x the
   batch (``flash_scaling``: what bounds them);
11. the transformer slice: ``TransformerTrainer`` at the configuration of
   ``bench_train.bench_transformer`` (vocab 32768, embed 1024, 8 layers,
   8 heads x 128, ffn 4096, bf16 products on f32 parameters, B = 4, T =
   2048, SGD at lr 1e-3) on ``np.random.default_rng(0)`` tokens: a first
   step (loss within 2 of ln(32768) + s2/2, s2 the variance of the
   step-0 logits over the vocabulary) held against the same step with the
   flash wrappers swapped for their plain versions, then 5 timed steps
   with launch counters read around them (all three flash kernels
   launched, no plain call), step seconds, tokens/s and MFU, one step
   under ``torch.profiler``, and the logits product's cost three ways
   (bf16 operands with an f32 result, the port's; bf16 result; f32);
12. the training plane (``training_*`` lines): (a) the digits MLP at the
   reference width (256, 128, 10), bunch 128, ``n_data`` 1, measured as
   ``bench_train.bench_mlp`` measures it: ``mlp_train_steps_per_s``
   (eager ``step``), the fused rate (a 100-step epoch captured into one
   CUDA graph, the stacked batch copied into the graph's slots on the
   card each call) and ``flops_per_step = 6 * params * batch``; the
   captured epoch bit-equal to 100 eager steps on 100 batches; ``fit``
   on ``make_digits()`` (800 / 200, bunch 32) lowers the validation loss
   over 5 epochs; (b) ``fit`` 3 epochs under a ``mem://`` trainer lease
   into a ``mem:`` ``CheckpointManager``, then a successor acquires (the
   generation rises), restores step 3 and runs to epoch 5: its history
   and parameters bit-equal to an uninterrupted 5-epoch run's, with the
   acquire and ``mrtpu_trainer_recovery_seconds``; (c) ``train_digits``
   through the port's ``Server`` with two in-process workers: 3
   ``"loop"`` iterations of 4 map jobs, none failed, the validation loss
   falling; the loop wall and the seconds spent in ``mapfn`` (the MLP's
   gradients on the card); (d) the transformer slice's config with
   ``optimizer="adamw"`` (lr ``ADAMW_LR``): 3 ``step_opt`` calls with
   8 launches of each flash kernel a step and no plain call;
   ``_train_steps`` with S = 4 (one graph replay, 32 launches of each)
   bit-equal to 4 ``step_opt`` calls; ``save`` -> ``load_state``
   bit-equal and the next step bit-equal to the step without the round
   trip; step walls
   (host clock) against device time (events around a replay, the
   profiler's sum for an eager step), eager and captured, SGD beside
   (``profile_transformer_adamw`` / ``_sgd`` lines);
13. the networked job plane (``netplane`` lines), every process of it
   ``python -m mapreduce_tpu_torch.cli`` under ``$MAPREDUCE_TPU_AUTH``:
   (a) ``docserver`` and ``blobserver ROOT`` on port 0 (the bound
   address read from their first line); a tokenless ``/metrics`` and
   blob ``/list`` must get 401, ``/healthz`` 200; (b) the README's
   topology: two ``worker`` processes of two threads and a ``server``
   process with ``examples/wordcount_split`` over ``http://`` and
   ``http:`` on phase 9 (b)'s 200K words in 3 files, the result
   partitions read back from the blob server equal to the naive oracle,
   the server's control decisions (its controllers are on) as pushed to
   ``/clusterz``, none a re-claim, beside ``rpcs_per_job``, then
   ``drop`` clears the task's collections and blobs; (c) the device
   phase through ``Server(http://...)`` on phase 9's 24 files, P = 1
   variadic and P = 8 radix, its ``result.P00000`` (an HTTP PUT)
   byte-equal to the same run on a ``dir:`` board with ``shared:``
   storage, the path's kernels launched (counted around the http run)
   and held bit for bit against their plain versions on the inputs of
   their largest calls; prepare, engine, ``device_result``, the write
   and ``finalfn`` (its reads are HTTP GETs) beside phase 9's; (d)
   ``train_digits`` at phase 12 (c)'s shards, bunch, seed and
   iterations with its gradients computed in two ``worker`` processes on
   the card: the history bit-equal to phase 12's with worker threads;
   (e) ``/metrics`` and ``/clusterz``: each worker's jobs as pushed by
   its process equal to the board's job documents, the server's device
   spans present; (f) every process reaped under a timeout.  Each worker
   process's first-claim delay (its first job's claim stamp less its
   start) is reported;
14. the always-on service (``service`` lines): (a) ``bench.py``'s
   ``measure_failover`` on two in-process ``DocServer`` s over one HA
   directory, lease 1.0 s: ``board_failover_s`` from a silent kill of
   the primary to the first mutation the promoted standby acknowledges
   through one multi-endpoint ``HttpDocStore``, exactly once (n == 1,
   v == 2); (b) two ``docserver --ha-dir D --ha-lease 1`` processes, a
   ``runner`` over both (``--partitions 8 --max-inflight 2 --workers
   2``) and two tenants' device tasks of phase 9's 24 files through
   ``examples/wordcount`` submitted with ``submit --program wave``
   (``radix`` and ``variadic``), the primary SIGKILLed once both read
   RUNNING in
   ``tasks --json``: the standby promotes, both tasks reach DONE, each
   result equals ``Counter`` and the same task's bytes through
   ``Server`` on a ``dir:`` board, and, once the runner has stopped, a
   fresh replica's replay of the log equals the survivor's documents;
   kill to promotion, each task's submit to DONE, queue wait and admit
   to running (the runner's pushed SLO histograms, from the board's
   ``/clusterz``) and whether a task re-ran a phase; (c) the same two
   tasks with ``TaskRunner`` and the scheduled workers in this process
   over the survivor and a restarted replica, both in flight at once:
   the launches of the five word-count kernels counted around the run
   (equal to the two ``dir:`` runs' summed), no plain call, each kernel
   held bit for bit against its plain version on the inputs of its
   largest call; (d) the runner's admission advisor, fed the runner's
   own facts (``wave`` warm: phase 1 built the libraries), routes both
   tasks to its placement, each pick an ``admission`` decision counted
   on ``/clusterz``; every process reaped under a timeout.  Phase 8's
   sustained cases run ``measure_sustained``'s scheduler churn thread
   and report ``submit_first_snapshot_p99_s``;
15. the self-tuning controllers (``control`` lines): (a)
   ``bench.py``'s ``measure_skew_rebalance`` ported: a resident stream
   of ``control_map_fn`` records (the chunk values are the keys) on
   ``Partitions(8, "cuda")``, radix, with a partition map, every skewed
   key congruent to partition 5 under the identity map and spread over
   its buckets, ``out_capacity`` sized so the balanced population fits
   a partition and the skewed one cannot; a uniform and a skewed stream
   with ``AutoTuner(min_records=keys_per_round // 2)`` attached, a warm
   feed outside the timed window, then the skewed feeds again without a
   controller; at the bench's size (C = 4096, 4 rounds) and at a real
   stream's state (C = 1<<18 a partition, 8192 values a chunk, 4
   waves a feed): ``skewed_wall_ratio`` (skewed wall over uniform
   wall), each window's recv imbalance (the last below the first), at
   least one rebalance and a ``repartition`` decision resolved
   ``improved``, the snapshot equal to host truth (``np.unique`` over
   the fed keys), the uncontrolled run overflowing, the radix kernels
   launched (no plain call) and held against their plain versions on
   their largest inputs; the wall a round and each rebalance's host
   re-bin split (``lanes_to_host``, ``repartition_rows``,
   ``lanes_to_device``); (b) phase 8's first tenant at P = 1 under the
   sustained config with its exchange capacity 1<<15, which the
   tenant's feed overflows: an autotuned ``DeviceEngine`` run retries
   and teaches the controller, an ``EngineSession`` of the program is
   pre-sized at its door and feeds overflow-free, and a second run
   retries no more; one ``capacity`` decision, resolved ``improved``;
   counts against ``Counter``; tokenize and segreduce launched, no
   plain call;
16. the engine's device telemetry (the ``telemetry`` lines): the P = 1
   variadic and P = 8 radix slices of phases 4 and 7 again, warm, each
   under one root span: the wave, dispatch and retry counters, the span
   counts by name, checked to nest ``device_run ⊃ wave ⊃ {upload,
   compute, readback}`` with every child inside its wave and upload and
   compute carrying device intervals (``device_ms`` from CUDA events),
   each wave's compute ``device_ms`` beside the run's ``compute_s``, the
   analytic cost model's MFU and roofline share (failing unless 0 <
   ``roofline_frac`` <= 1), the allocator's memory sample beside
   ``torch.cuda.max_memory_allocated()``, ``upload_overlap_frac``,
   ``build_info()`` and the kernels' launches; the P = 1 slice once more
   under ``torch.cuda.set_sync_debug_mode("warn")``, failing if a
   synchronising call's stack passes through ``mapreduce_tpu_torch/
   obs/`` or a telemetry line of the engine (the line lists every sync
   site); a P = 1 run whose ``out_capacity`` (1<<16) the corpus's
   76,006 unique words overflow, so it retries once: the
   ``capacity_retry`` event's classification against the card's memory
   and its capacities; a profile bundle of the P = 1 run, loaded back;
   and one ``cli wordcount --device --trace-out`` job (phase 9 (b)'s
   200K words) whose trace holds ``device_run ⊃ wave ⊃ {upload,
   compute, readback}`` under the job's ``run`` span;
17. the remaining examples and the compile plane (the ``examples``
   lines), with the corpus written as 24 files of whole lines: (a)
   ``examples/wordspan`` through ``Server(device=True)`` at its own
   capacities (so it retries), at P = 1 and at P = 8 radix:
   ``[count, first, last]`` for every word against a host oracle built
   from the bytes alone (``span_oracle``), the path's kernels launched
   (the callable span monoid's segreduce kernel; at P = 8 the radix
   kernels) and no plain call, each kernel held bit for bit against its
   plain version on the inputs of its largest call, the loop wall,
   ``compute_s`` and ``device_result``; then, outside D's registry,
   each run again with the monoid as its per-lane codes (``("sum",
   "min", "max")``, the codes kernel): the same spans; (b) the compile
   plane in four processes: ``cli warmup --compile-cache D --sort-impl
   tiered-radix`` into an empty D (every library ``compiled``; the nvcc
   seconds), the same again (every library a ``persistent_hit``, no
   compiler), (a)'s callable runs recording their buckets in D's shape
   registry (with the runs' capacities, ``sizing``, and no replay spec,
   as the JAX engine's), then ``chip_smoke.py --wordspan-child D
   FILES`` (a fresh ``AutoTuner`` pre-sizes the P = 1 run from the
   callable's own buckets: no retry, a decision whose source is
   ``shape_registry``, the same spans, the span monoid's library a
   ``persistent_hit``) and ``warmup --replay`` (a row with seconds for
   every recorded device-engine bucket, none failed, wordspan's
   skipped); ``cold_compile_s`` and ``warm_start_s`` are
   the two warmups' seconds; (c) ``examples/wordcount_native`` through
   ``Server`` with 4 worker threads on a ``dir://`` board over a 2M-word
   corpus in 8 ``shared:`` blobs, against ``Counter``, the ``g++``
   library loaded by the map jobs;
18. the operator plane, status and diagnosis half (the ``operator``
   lines): (a) a ``docserver`` and a ``runner --partitions 8
   --trace-out F --telemetry-interval 0.5`` in processes, both with
   ``--slo submit_first_result:p99:120 --slo
   queue_wait:p99:0.000001`` (the second must breach), and two device
   word counts submitted to the board: the 24 files of the corpus, and
   24 files of a skewed corpus whose distinct words hash mostly to
   partition 0 (:func:`skewed_corpus`), each result against ``Counter``;
   (b) ``cli status``: the engine sections the runner pushed (device
   with waves and MFU, compile, memory, comms with only ``self`` bytes,
   equal to each task's traffic-matrix records times its row bytes),
   the scheduler, the breached objective, each task's device line;
   (c) ``cli diagnose --json``: the device phases and the ``device_run``
   window, the skewed task's partition 0 flagged and none of the
   uniform task's; (d) ``cli profile --out``, loaded back; (e) a
   SIGTERM to the runner: exit 143, a flight trace that validates and
   holds ``device_run ⊃ wave``, a flight ``.prom`` with the exchange
   counters and the runner's launches of the five kernels (and no
   plain call); the ``/statusz`` scrape seconds, the commands' walls
   and the tasks' ``compute_s`` beside phase 14 (c)'s;
19. callable monoids on the card (the ``monoid`` lines): every monoid
   library of the phase built at once (``build_all``: one ``nvcc`` a
   monoid) with its registers and spills; (a) the monoid kernel (a
   callable ``reduce_op`` lowered into the combine of
   ``csrc/segreduce.cuh``) against its plain ladder, bit for bit (the
   reduced lanes at run ends, ``end_csum`` everywhere), with kernel,
   plain and bound times: the span monoid at phase 3's verify shape
   (852,072 rows) and on phase 17's P = 1 wordspan local reduce
   (12,490,752 rows), each beside the codes kernel on the same rows
   (equal bits, both timed in turns), then ``testing/monoids.py``'s
   ``(sum, min, bitwise_or)``, 1-lane ``bitwise_xor``, the 5-lane
   argmin-count, the 8-lane ``bits`` (shifts, constants, unary ``-``,
   ``~`` and ``!``, every comparison, bool ops, ``where`` with a
   constant branch) and the 2-lane affine composition (which does not
   commute) at 852,072 rows, the last replayed 50 times from one CUDA
   graph; (b) ``DeviceWordCount(verify_collisions=True)`` at the flagship
   config over the 16M words at P = 1 variadic and P = 8 radix, with the
   callable and with its codes, each against ``Counter``, and phase 17's
   wordspan comparison; (c) an ``EngineSession`` at P = 1 with the
   ``(sum, min, bitwise_or)`` monoid over 4M records in 4 feeds, its
   snapshot against a numpy oracle, then evicted to ``mem:`` storage
   and restored bit for bit; (d) ``a // b`` refused by name before any
   launch;
20. the durable telemetry history and the alerting plane (the
   ``history`` and ``alerts`` lines): a ``docserver --history-dir D
   --alert-interval 0.5`` with an ``--alert-exec`` sink that appends
   each notification to a file, phase 18's objectives, and two rules:
   ``onesweep_ran`` (``increase(mrtpu_kernel_launches_total
   {kernel=radix_onesweep}[300]):gt:0``) and a burn rule on the breached
   ``queue_wait``; a P = 8 radix ``runner`` on the card runs phase 18's
   uniform and skewed word counts (each against ``Counter``); then
   ``cli alerts --json`` shows ``onesweep_ran`` firing and the sink holds
   one firing notification for it, ``cli top`` names a device or kernel
   family, and after a SIGTERM to the runner (its flight ``.prom`` holds
   its own counts) ``cli history --json`` gives increases of the onesweep
   kernel's launches and of ``mrtpu_device_waves_total`` equal to them as
   exact integers; then the docserver is SIGKILLed and restarted on the
   same port and directory: the same increases, the instance still
   firing from the replayed log, and after six evaluator sweeps still
   one notification in the sink;
21. the transformer's expert and ring paths and the pipeline (the
   ``axes_moe``, ``axes_ring`` and ``axes_pipeline`` lines, TF32 off):
   (a) the bench transformer with 8 experts (``n_model=8``, the flash
   path, B = 4, T = 2,048): step 0 through the kernels against the same
   step on the plain flash versions with the kernel step's experts
   pinned (how many tokens the plain attention routes to another expert,
   and the unpinned step's errors, printed beside), ``moe_experts=1``
   against the dense model on the same parameters (loss within 1e-3), 4
   steps as one captured replay against 4 eager steps (bit equality
   printed, losses within 1e-2), then 5 counted steps (8 launches of
   each flash kernel a step, tokens past capacity a layer, aux, peak
   memory); (b) ``bench_longctx``'s
   model (loss_block 2,048) on one 32,768-token sequence over 8
   sequence partitions (``flash=False``, the ring): one step against the
   flash path's on the same parameters, the ring through the kernels
   against the ring on the plain versions at T = 8,192 and 2 layers, 3
   counted steps (8 launches of each flash kernel a layer a step: one
   folded call a ring step) beside 3 of the flash path (MFU, peak
   memory, the step ratio); (c) ``PipelineConfig()`` at 8 stages and 16
   microbatches: the pipelined forward against the sequential stages,
   20 SGD steps whose loss falls, a pipelined step's time beside the
   sequential one's;
22. the engine-host fleet and multi-process meshes (the ``fleet_*``
   lines; ``probe_fleet.py`` runs this phase alone): (a) ``bench.py``'s
   ``measure_session_migration`` at full size on ``Partitions(8)``,
   radix: ``engine/migrate.migrate`` from one session to another over a
   ``mem:`` spill store, the destination's snapshot bit-equal to the
   source's before the move, the route flipped, ``session_migration_s``
   and ``spill_s``; (b) ``measure_fleet_sustained`` at full size: two
   fleet hosts in this process, each a resident P = 1 session on the
   card fed by its own thread (exchange capacity 131,072, the local
   capacity), the aggregate records/s beside phase 8's one-host rate
   (no gain asserted: both share the card), every tenant against
   ``Counter``, an overflowing stream failing the run; (c) kill a host:
   ``chip_smoke.py --fleet-victim`` joins the fleet over a ``dir://``
   board and feeds the corpus's chunks one at a time on
   ``Partitions(8)`` radix with a spill after each; after 4 spills it is
   SIGKILLed, ``Scheduler.recovery_sweep`` must re-home its stream to
   the spare within the 1 s lease plus 2 s, and a fresh session restores
   it, bit-equal to an uninterrupted stream over the committed chunks
   and equal to ``Counter`` of them; the migration counter and a
   ``fleet`` decision name the move; (d) a ``docserver`` and two
   ``runner`` processes on the card, three streams routed at runner A,
   ``cli drain A``: A steps down and exits 0, its streams are on B,
   ``status`` shows A ``LEFT``, ``diagnose`` names 3 drain migrations;
   (e) ``chip_smoke.py --mesh-rank`` twice: two controllers on the one
   card over a gloo group, 4 of the 8 partitions each, phase 7's radix
   slice (counts against ``Counter``, the traffic matrix bit-equal to
   phase 7's, each rank's launches and ``compute_s`` beside phase 7's),
   one step of the bench_train MLP at n_data 8 (the loss equal on both
   ranks, f32 within 1e-5 of the one-process step's, bf16 within 1e-2),
   then ``tests/multiproc_runner2.py``'s topology over an ``http://``
   docserver and a blob server.  Every child loads this run's libraries
   through ``$MAPREDUCE_TPU_CACHE`` (none runs ``nvcc``: checked), holds
   its kernels against their plain versions and reads 0 plain calls;
23. one JSON line of per-kernel numbers (the word-count kernels' with
   their phase 13, 14, 15, 16, 17, 18, 20 and 22 launches beside, the
   flash kernels' with phase 21's MoE and ring launches, and
   ``segreduce_monoid`` with its phase 17 and 19 launches), the smoke's
   wall and its wall before phases 20, 21 and 22, then the card and the
   result line.

The word-count comparisons are integer and exact (tolerance: none).  The
flash kernels sum in another order than their plain versions: out, dq,
dk and dv (bf16) are held to atol = rtol = 2e-2 and lse (f32) to atol
1e-3; the trainer's first step to a loss within 1e-2 and each
parameter's update within 5e-2 of its norm (the ring's and the MoE
model's steps too, and the ring's against the flash path's).  The
training plane's captured steps (the MLP's epoch, the transformer's S
AdamW steps), the resumed history and the step after a checkpoint
round trip are held bit for bit: a replay runs the eager step's
kernels on the same inputs, and no kernel on these paths sums in a
varying order (the flash kernels and cuBLAS's GEMMs use no atomics; the
embedding's backward is PyTorch's sort-based ``index_put_``).
"""

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from collections import Counter

#: the card's published memory rate (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
#: int32 ALU rate taken as the fp32 non-tensor peak (H100 SXM, 67 TFLOP/s)
INT_OPS_PER_S = 67e12
#: dense bf16 tensor-core rate (H100 SXM data sheet, 989 TFLOP/s)
BF16_FLOPS_PER_S = 989e12
CHUNK_LEN = 1 << 22
#: words of the smoke corpus: 24 chunks of 1<<22 bytes (a cut of
#: Europarl's 49M words to fit the smoke's time limit)
N_WORDS = 16_000_000
REPS = 20
#: the radix slice: partitions on the one card, and waves
RADIX_PARTS = 8
RADIX_WAVES = 2
#: the kernels of the word-count slices (phases 4 and 7)
WORDCOUNT_KERNELS = ("tokenize", "segreduce", "radix_plan", "radix_upfront",
                     "radix_onesweep")
#: the sort's tile sizes timed against each other (phase 6): the build's
#: own and variant builds of csrc/radix.cu with MR_ONESWEEP_TILE
SORT_TILE_AB = (1024, 2048, 4096)
#: the exchange plan's tile sizes timed against each other (phase 6): the
#: source's own and a variant build of csrc/radix.cu with MR_PLAN_TILE
PLAN_TILE_AB = (2048, 4096)
#: replays of one captured call in each determinism check (the radix
#: sort and plan, tokenize, segreduce)
REPLAYS = 50
#: the tile sizes of the tokenize and segreduce A/Bs (phases 2-3): the
#: source's own build and variant builds with its define set to each other
#: size
SCAN_TILE_AB = (1024, 2048, 4096)
SCAN_TILE_DEFINES = {"tokenize": "MR_TOKENIZE_TILE",
                     "segreduce": "MR_SEGREDUCE_TILE"}
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
#: the transformer slice: bench_train.bench_transformer's model and batch
TF_CONFIG = dict(vocab=32768, embed=1024, n_layers=8, n_heads=8,
                 head_dim=128, ffn=4096)
TF_B, TF_T, TF_LR, TF_STEPS = 4, 2048, 1e-3, 5
#: tolerances of the flash kernels against their plain versions
FLASH_TOL = dict(atol=2e-2, rtol=2e-2)
LSE_ATOL = 1e-3
#: the trainer's first step through the kernels against the plain one
STEP_LOSS_ATOL = 1e-2
STEP_UPDATE_RTOL = 5e-2
#: the sustained session (phase 8): bench.py's measure_sustained at its
#: full size (smoke=False): its config, 1<<20-byte chunks, a 1.5M-word
#: make_corpus slice a tenant (seeds 0-2, so tenants that mixed would
#: show), three tenants, 3 rounds a block
SESSION_CONFIG = dict(local_capacity=1 << 17, exchange_capacity=1 << 15,
                      out_capacity=1 << 17, tile=512, tile_records=104,
                      combine_in_scan=True, combine_capacity=1 << 17,
                      unit_values=True, reduce_op="sum")
SESSION_CHUNK_LEN = 1 << 20
SESSION_WORDS = 1_500_000
SESSION_TENANTS = ("t0", "t1", "t2")
SESSION_ROUNDS = 3
#: the flagship session feeds the 24-chunk corpus in this many feeds
SESSION_FEEDS = 4
TOPK_K = 100


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(torch, fn, reps=REPS, rounds=5):
    """Milliseconds per call of *fn*, for host-synchronising code (the
    plain versions, the library call): CUDA events around *reps* calls
    back to back after warm-up, divided by *reps*; the median of
    *rounds* such rounds."""
    for _ in range(min(3, reps)):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kernel_ms(torch, fn):
    """Device milliseconds per call of a kernel wrapper *fn*: REPS calls
    captured into one CUDA graph, so the replay runs the launches back to
    back with no host work (allocation, ctypes) between them; CUDA
    events around a replay, divided by REPS.  Returns the median of 5
    replays and their spread, (max - min) / median."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    del graph
    med = statistics.median(times)
    return med, (max(times) - min(times)) / med


def bound(nbytes, nops, ops_per_s=INT_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the ALU rate (or *ops_per_s*)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want):
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def tile_variants(kc, source, define, tiles):
    """``{label: defines}`` of a tile A/B over *tiles*: the tile that
    *source* sets with ``#define`` *define* is its own build, ``()``;
    each other tile a variant build.  The define may sit in the
    source's header of the same name (``segreduce.cuh``)."""
    text = "".join(p.read_text() for p in (kc.CSRC / f"{source}.cu",
                                          kc.CSRC / f"{source}.cuh")
                   if p.exists())
    own = re.search(rf"#define {define} (\d+)", text)
    check(own is not None, f"{source}.cu defines no {define}")
    return {f"tile={t}": (() if t == int(own.group(1)) else ((define, t),))
            for t in tiles}


def scan_variants(kc, source):
    """The tile A/B of tokenize or segreduce over SCAN_TILE_AB."""
    return tile_variants(kc, source, SCAN_TILE_DEFINES[source], SCAN_TILE_AB)


def plan_variants(kc):
    """The tile A/B of the exchange plan over PLAN_TILE_AB."""
    return tile_variants(kc, "radix", "MR_PLAN_TILE", PLAN_TILE_AB)


def tile_libraries(kc, source, signatures):
    """``{"tile=T": library}``: *source*'s build for each tile of
    SCAN_TILE_AB (phase 1's builds)."""
    return {v: kc.library(source, signatures, d)
            for v, d in scan_variants(kc, source).items()}


def timed_turns(torch, libs, label, call, same):
    """Each build of *libs* called through ``call(lib)``, its outputs
    checked by *same*, then timed in turns (A B C C B A): ``{name: [ms,
    ms]}``.  These launches are the A/B's, not the path's: uncounted."""
    names = list(libs)
    out = {v: [] for v in names}
    for v in names + names[::-1]:
        res = call(libs[v])
        torch.cuda.synchronize()
        check(same(res), f"{label}: the {v} build differs")
        out[v].append(kernel_ms(torch, lambda: call(libs[v]))[0])
    return out


def tokenize_call(torch, kc, tok, lib, chunk, mults):
    """One C call of ``mr_tokenize`` through *lib* (a tile variant's
    build), as ``tok._tokenize_cuda`` makes it, uncounted."""
    dev = chunk.device
    n, nl = chunk.numel(), len(mults)
    keys = torch.empty((n, nl), dtype=torch.int32, device=dev)
    is_end = torch.empty(n, dtype=torch.bool, device=dev)
    start = torch.empty(n, dtype=torch.int32, device=dev)
    length = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.mr_tokenize_scratch_bytes(n, nl),
                          dtype=torch.uint8, device=dev)
    a = [int(x) & kc.MASK32 for x in mults] + [0] * (3 - nl)
    kc.check("tokenize", lib.mr_tokenize(
        kc.ptr(chunk), n, nl, a[0], a[1], a[2], kc.ptr(keys),
        kc.ptr(is_end), kc.ptr(start), kc.ptr(length), kc.ptr(scratch),
        kc.stream(dev)))
    return tok.TokenStream(is_end, keys, start, length)


def tokenize_equal(torch, tok, chunk, mults, label):
    """The tokenizer kernel against its plain version on *chunk*, bit for
    bit in every field; returns the plain version's output and the
    largest |diff| (0)."""
    got = tok._tokenize_cuda(chunk, mults)
    want = tok._tokenize_plain(chunk, mults)
    torch.cuda.synchronize()
    err = 0
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        check(torch.equal(a, b), f"{label}: tokenize differs in {f}")
        err = max(err, max_abs_err(torch, a, b))
    return want, err


def tokenize_phase(torch, kc, tok, chunk):
    """Phase 2: returns the kernel's record for the JSON line."""
    mults = (tok.HASH_A1, tok.HASH_A2)
    want, err = tokenize_equal(torch, tok, chunk, mults, "tokenize kernel")
    n, nl = chunk.numel(), len(mults)
    ms, spread = kernel_ms(torch, lambda: tok._tokenize_cuda(chunk, mults))
    plain_ms = time_ms(torch, lambda: tok._tokenize_plain(chunk, mults))
    # bytes: 1 in; keys 4*lanes + is_end 1 + start 4 + length 4 out.
    # ops: ~12 classify/flag ops per byte plus 3 per byte and lane
    b_ms, b_by = bound(n * (1 + 4 * nl + 9), n * (12 + 3 * nl))
    libs = tile_libraries(kc, "tokenize", tok._SIGNATURES)
    def call(lib):
        return tokenize_call(torch, kc, tok, lib, chunk, mults)

    ab = timed_turns(torch, libs, "tokenize", call,
                     lambda out: all(torch.equal(getattr(out, f),
                                                 getattr(want, f))
                                     for f in want._fields))
    replay_check(torch, "tokenize_replay",
                 lambda: tok._tokenize_cuda(chunk, mults), n)
    print(f"tokenize n={n} lanes={nl}: equal; kernel {ms:.4f} ms (spread "
          f"{spread:.3f}), plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    print(json.dumps({"tokenize_case": {
        "n": n, "lanes": nl, "ms": ms, "spread": spread, "bound_ms": b_ms,
        "tile_ab_ms": ab}}))
    return {"name": "tokenize", "route": "cuda",
            "source": "mapreduce_tpu_torch/csrc/tokenize.cu",
            "replaces": "mapreduce_tpu/ops/tokenize.py:197",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def segreduce_call(torch, kc, seg, lib, k1s, k2s, vals, op, unit):
    """One C call of ``mr_segreduce`` through *lib* (a tile variant's
    build), as ``seg._segment_reduce_cuda`` makes it, uncounted."""
    dev, n = k1s.device, k1s.numel()
    if unit:
        d, codes, v = 1, [0, 0, 0], None
    else:
        d = len(vals)
        codes = ([seg._OP_CODES[o] for o in seg._lane_ops(op, d)]
                 + [0] * (3 - d))
        v = torch.stack(list(vals), dim=-1).contiguous()
    reduced = torch.empty((n, d), dtype=torch.int32, device=dev)
    end_csum = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.mr_segreduce_scratch_bytes(n, d),
                          dtype=torch.uint8, device=dev)
    kc.check("segreduce", lib.mr_segreduce(
        kc.ptr(k1s), kc.ptr(k2s), kc.ptr(v) if v is not None else None, n,
        d, int(unit), *codes, kc.ptr(reduced), kc.ptr(end_csum),
        kc.ptr(scratch), kc.stream(dev)))
    return [reduced[:, i] for i in range(d)], end_csum


def segreduce_case(torch, kc, seg, libs, label, k1s, k2s, vals, op, unit):
    """One segreduce shape: equality on the surface (reduced lanes at run
    ends, end_csum everywhere), timings, the tile A/B and the replay
    check."""
    got = seg._segment_reduce_cuda(k1s, k2s, vals, op, unit)
    want = seg._segment_reduce_plain(k1s, k2s, vals, op, unit)
    torch.cuda.synchronize()
    _, _, is_end = seg._run_flags(k1s, k2s)

    def same(out):
        return torch.equal(out[1], want[1]) and all(
            torch.equal(g[is_end], w[is_end]) for g, w in zip(out[0], want[0]))

    check(torch.equal(got[1], want[1]), f"segreduce {label}: end_csum")
    err = max_abs_err(torch, got[1], want[1])
    for g, w in zip(got[0], want[0]):
        check(torch.equal(g[is_end], w[is_end]),
              f"segreduce {label}: reduced lanes at run ends")
        err = max(err, max_abs_err(torch, g[is_end], w[is_end]))
    n, d = k1s.numel(), (1 if unit else len(vals))
    ms, spread = kernel_ms(torch, lambda: seg._segment_reduce_cuda(
        k1s, k2s, vals, op, unit))
    plain_ms = time_ms(torch, lambda: seg._segment_reduce_plain(
        k1s, k2s, vals, op, unit))
    # bytes: keys 8 + values 4*d in (none in unit mode); reduced 4*d +
    # end_csum 4 out.  ops: ~10 compare/flag ops per row plus 2 per lane
    in_lanes = 0 if unit else d
    b_ms, b_by = bound(n * (8 + 4 * in_lanes + 4 * d + 4), n * (10 + 2 * d))
    ab = timed_turns(torch, libs, f"segreduce {label}",
                     lambda lib: segreduce_call(torch, kc, seg, lib, k1s, k2s,
                                                vals, op, unit), same)
    replay_check(torch, f"segreduce_replay {label}",
                 lambda: seg._segment_reduce_cuda(k1s, k2s, vals, op, unit),
                 n)
    print(f"segreduce {label} n={n}: equal; kernel {ms:.4f} ms (spread "
          f"{spread:.3f}), plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    case = {"label": label, "n": n, "max_abs_err": err, "ms": ms,
            "spread": spread, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "tile_ab_ms": ab}
    if not unit:  # the wrapper's packing of the value lanes, part of ms
        case["pack_ms"] = kernel_ms(torch, lambda: torch.stack(
            list(vals), dim=-1).contiguous())[0]
    return case


def library_case(torch, seg, case, k1s, k2s, v):
    """A one-lane int32 sum case's library yardstick,
    ``torch.segment_reduce(v, "sum", lengths=...)``: its ms, or None and
    the library's refusal where it takes no int32."""
    fn = segment_reduce_call(torch, seg, k1s, k2s, v, "sum")
    try:
        fn()
    except RuntimeError as exc:
        case["library_ms"], case["library_refused"] = None, str(exc)[:160]
        return
    case["library_ms"] = time_ms(torch, fn)


def segreduce_phase(torch, kc, seg, wcmod, chunks_dev, cfg):
    """Phase 3 at the main path's shapes, on inputs the path itself
    makes from the corpus: the combiner's input (one chunk's records),
    the local reduce's (12 combined chunks), the fold's (accumulator +
    one exchange block), and the verify monoid's (3 value lanes)."""
    from dataclasses import replace

    def sorted_lanes(keys, valid, vals):
        k1 = torch.where(valid, keys[:, 0], seg.SENTINEL)
        k2 = torch.where(valid, keys[:, 1], seg.SENTINEL)
        perm = seg._sort_perm(k1, k2, "variadic")
        return (k1[perm].contiguous(), k2[perm].contiguous(),
                [v[perm].contiguous() for v in vals])

    libs = tile_libraries(kc, "segreduce", seg._SIGNATURES)
    ucfg = replace(cfg, unit_values=True, reduce_op="sum")
    keys, vals, pay, valid, _ = wcmod._wordcount_map_fn(chunks_dev[0], 0,
                                                        ucfg)
    k1s, k2s, _ = sorted_lanes(keys, valid, [])
    cases = [segreduce_case(torch, kc, seg, libs, "combiner/unit", k1s, k2s,
                            [], "sum", True)]
    # library yardstick of the unit case: runs and their lengths of the
    # sorted packed key
    packed = ((k1s.to(torch.int64) & 0xFFFFFFFF) << 32) | (
        k2s.to(torch.int64) & 0xFFFFFFFF)
    cases[0]["library_ms"] = time_ms(
        torch, lambda: torch.unique_consecutive(packed, return_counts=True))

    Tc = cfg.scan_combine_slots(keys.shape[0])
    bk, bv, bvalid = [], [], []
    for j in range(12):
        kj, vj, pj, mj, _ = wcmod._wordcount_map_fn(chunks_dev[j], j, ucfg)
        cu = seg.sorted_unique_reduce(kj, vj, pj, mj, Tc, "sum",
                                      unit_values=True)
        bk.append(cu.keys)
        bv.append(cu.values)
        bvalid.append(cu.valid)
    buf_k, buf_v, buf_valid = torch.cat(bk), torch.cat(bv), torch.cat(bvalid)
    k1s, k2s, vs = sorted_lanes(buf_k, buf_valid, [buf_v])
    cases.append(segreduce_case(torch, kc, seg, libs, "local/sum", k1s, k2s,
                                vs, "sum", False))
    library_case(torch, seg, cases[-1], k1s, k2s, vs[0])

    local = seg.sorted_unique_reduce(
        buf_k, buf_v, torch.zeros((buf_k.shape[0], 1), dtype=torch.int32,
                                  device=buf_k.device),
        buf_valid, cfg.out_capacity, "sum")
    ex = cfg.exchange_capacity
    fk = torch.cat([local.keys, local.keys[:ex]])
    fv = torch.cat([local.values, local.values[:ex]])
    fvalid = torch.cat([local.valid, local.valid[:ex]])
    k1s, k2s, vs = sorted_lanes(fk, fvalid, [fv])
    cases.append(segreduce_case(torch, kc, seg, libs, "fold/sum", k1s, k2s,
                                vs, "sum", False))
    library_case(torch, seg, cases[-1], k1s, k2s, vs[0])

    # the collision-verify monoid as its per-lane codes (phase 19 runs
    # it as the callable, on its monoid kernel)
    vcfg = replace(cfg, unit_values=False, reduce_op=VERIFY_CODES)
    keys, vals, pay, valid, _ = wcmod._wordcount_map_fn_verify(
        chunks_dev[0], 0, vcfg)
    k1s, k2s, vs = sorted_lanes(keys, valid,
                                [vals[:, i] for i in range(3)])
    cases.append(segreduce_case(torch, kc, seg, libs, "verify/(sum,min,max)",
                                k1s, k2s, vs, VERIFY_CODES, False))
    for c in cases:
        print(json.dumps({"segreduce_case": c}))
    head = cases[0]
    return {"name": "segreduce", "route": "cuda",
            "source": "mapreduce_tpu_torch/csrc/segreduce.cu",
            "replaces": "mapreduce_tpu/ops/segscan.py:193",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"]}


def _profile_group(name):
    if "mr_tokenize_kernels" in name:
        return "tokenize kernel"
    if "mr_segreduce_kernels" in name:
        return "segreduce kernel"
    if "mr_radix_kernels" in name:
        if "onesweep_kernel" in name:
            return "radix onesweep"
        if "upfront_kernel" in name:
            return "radix upfront"
        return "radix plan"
    low = name.lower()
    if "memset" in low:
        return "memset"
    if "sort" in low and "searchsorted" not in low:
        return "torch.sort"
    if "memcpy htod" in low:
        return "upload (memcpy HtoD)"
    return "other"


def trace_events(prof):
    """The device events (kernels, copies, memsets) of a finished
    profile, from its Chrome trace: ``[{"cat", "name", "stream", "ts",
    "dur"}]`` in microseconds."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [{"cat": e["cat"], "name": e["name"],
             "stream": (e.get("args") or {}).get("stream", e.get("tid")),
             "ts": float(e["ts"]), "dur": float(e.get("dur", 0.0))}
            for e in events
            if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def _covered(intervals, lo, hi):
    """Microseconds of [lo, hi) inside the union of sorted *intervals*."""
    return sum(max(0.0, min(hi, b) - max(lo, a)) for a, b in intervals)


def upload_report(label, events, expect=None):
    """Phase 5's check of a run's uploads: every host-to-device copy
    pinned and on another stream than the port's kernels; prints the
    copies' device ms, the share of it that overlaps kernel time, and
    beside the copies traced the *expect* ones issued (a wave each)."""
    h2d = [e for e in events
           if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    ours = [e for e in events if e["cat"] == "kernel"
            and _profile_group(e["name"]) != "other"]
    check(h2d and ours, f"{label}: {len(h2d)} uploads and {len(ours)} "
          "kernels of the port in the trace; both must be there")
    pageable = sorted({e["name"] for e in h2d if "Pinned" not in e["name"]})
    check(not pageable, f"{label}: pageable host-to-device copies: "
          f"{pageable}")
    kernel_streams = {e["stream"] for e in ours}
    copy_streams = {e["stream"] for e in h2d}
    check(not kernel_streams & copy_streams,
          f"{label}: uploads on the kernels' stream {kernel_streams}")
    # the union of every kernel's interval on the kernels' streams
    busy = []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e["cat"] == "kernel"
                       and e["stream"] in kernel_streams):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    h2d_us = sum(e["dur"] for e in h2d)
    overlap_us = sum(_covered(busy, e["ts"], e["ts"] + e["dur"])
                     for e in h2d)
    print(json.dumps({f"{label}_upload": {
        "h2d_ms": h2d_us / 1e3, "copies": len(h2d),
        "expected_copies": expect,
        "overlap_share": overlap_us / h2d_us,
        "copy_streams": sorted(copy_streams),
        "kernel_streams": sorted(kernel_streams)}}))


def device_profile(torch, label, run, group_of, on_trace=None):
    """Run *run* once under torch.profiler; prints device microseconds and
    events by ``group_of(kernel name)`` and the 12 largest device events
    under *label*, and returns both by group: ``(us, events)``.  With
    *on_trace*, calls it with the run's :func:`trace_events`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    groups, calls, rows = {}, {}, []
    for ev in prof.key_averages():
        # device-side events only: a CPU op also reports its kernels'
        # time, which would count them twice, and so does a user
        # annotation's device range (``Optimizer.step#AdamW.step``); the
        # profiler's own buffer requests are not the program's work
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)
                or ev.key == "Activity Buffer Request"):
            continue
        dev_us = float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
        if dev_us <= 0:
            continue
        g = group_of(ev.key)
        groups[g] = groups.get(g, 0.0) + dev_us
        calls[g] = calls.get(g, 0) + ev.count
        rows.append((dev_us, ev.count, ev.key[:100], g))
    rows.sort(reverse=True)
    device_us = sum(groups.values())
    print(json.dumps({label: {
        "wall_us": wall_us, "device_us_total": device_us,
        "busy_share": device_us / wall_us, "device_us": groups,
        "device_calls": calls,
        "top": [{"device_us": r[0], "calls": r[1], "name": r[2],
                 "group": r[3]} for r in rows[:12]]}}))
    if on_trace is not None:
        on_trace(trace_events(prof))
    return groups, calls


def profile_phase(torch, kc, wc, chunks, label="profile", waves=None,
                  need=("tokenize kernel", "segreduce kernel"), forbid=()):
    """One engine run of a slice under torch.profiler (printed).  Fails if
    a group in *need* shows no device time or one in *forbid* shows any,
    if the tokenize, segreduce or plan kernel events differ in number
    from their wrappers' launches in the run (one kernel a call), or if
    an upload is pageable or on the kernels' stream (:func:`
    upload_report`)."""
    engine = wc._engine_for(chunks.shape[1])
    kc.reset_counts()
    tm = {}
    groups, calls = device_profile(
        torch, label, lambda: engine.run(chunks, waves=waves, timings=tm),
        _profile_group,
        on_trace=lambda ev: upload_report(label, ev, expect=tm["waves"]))
    check(all(groups.get(g, 0) > 0 for g in need),
          f"{label}: profiled run shows no device time in {need}: {groups}")
    check(all(groups.get(g, 0) == 0 for g in forbid),
          f"{label}: profiled run shows device time in {forbid}: {groups}")
    for k, group in (("tokenize", "tokenize kernel"),
                     ("segreduce", "segreduce kernel"),
                     ("radix_plan", "radix plan")):
        check(calls.get(group, 0) == kc.LAUNCHES[k],
              f"{label}: {calls.get(group, 0)} {group} events for "
              f"{kc.LAUNCHES[k]} wrapper launches")


def radix_inputs(torch, seg, wcmod, chunks_dev, cfg):
    """Inputs the radix path makes from the corpus (phase 6): the key
    lanes of a combiner sort (one chunk's records, invalid rows as the
    sentinel pair), of a local sort (two combined chunks), of a fold sort
    (a local result followed by eight combined chunks: the accumulator
    and the eight exchange blocks), and the plan's destinations ``[8,
    local_capacity]`` (``k1 % 8`` of eight local results, 8 where
    invalid)."""
    from dataclasses import replace

    ucfg = replace(cfg, unit_values=True, reduce_op="sum")

    def lanes(keys, valid):
        return (torch.where(valid, keys[:, 0], seg.SENTINEL).contiguous(),
                torch.where(valid, keys[:, 1], seg.SENTINEL).contiguous())

    keys, _, _, valid, _ = wcmod._wordcount_map_fn(chunks_dev[0], 0, ucfg)
    Tc = cfg.scan_combine_slots(keys.shape[0])
    combiner = lanes(keys, valid)
    combined = []
    for j in range(2 * RADIX_PARTS):
        kj, vj, pj, mj, _ = wcmod._wordcount_map_fn(chunks_dev[j], j, ucfg)
        combined.append(seg.sorted_unique_reduce(kj, vj, pj, mj, Tc, "sum",
                                                 unit_values=True))
    locals_ = []
    for p in range(RADIX_PARTS):
        a, b = combined[2 * p], combined[2 * p + 1]
        lk = torch.cat([a.keys, b.keys])
        locals_.append(seg.sorted_unique_reduce(
            lk, torch.cat([a.values, b.values]),
            torch.zeros((lk.shape[0], 1), dtype=torch.int32,
                        device=lk.device),
            torch.cat([a.valid, b.valid]), cfg.local_capacity, "sum"))
    local = lanes(torch.cat([combined[0].keys, combined[1].keys]),
                  torch.cat([combined[0].valid, combined[1].valid]))
    fold_parts = [locals_[0]] + combined[2:2 + RADIX_PARTS]
    fold = lanes(torch.cat([u.keys for u in fold_parts]),
                 torch.cat([u.valid for u in fold_parts]))
    dest = torch.stack([
        torch.where(u.valid, (u.keys[:, 0].to(torch.int64) & 0xFFFFFFFF)
                    % RADIX_PARTS, RADIX_PARTS).to(torch.int32)
        for u in locals_]).contiguous()
    return {"combiner": combiner, "local": local, "fold": fold}, dest


def radix_pass_case(torch, rs, label, k1, k2):
    """The upfront kernel and one onesweep pass (the digit of a second
    pass, with a permutation lane) against the plain versions, and their
    times."""
    n = k1.numel()
    perm = torch.randperm(n, device=k1.device).to(torch.int32)
    got_t = rs._radix_upfront_cuda(k1, k2)
    want_t = rs._radix_upfront_plain(k1, k2)
    check(torch.equal(got_t, want_t), f"radix_upfront {label} differs")
    err = max_abs_err(torch, got_t, want_t)
    lane, shift = 1, 8
    counts = want_t[rs.PASSES.index((lane, shift))].contiguous()
    got = tuple(torch.empty(n, dtype=torch.int32, device=k1.device)
                for _ in range(3))
    want = tuple(torch.empty_like(g) for g in got)
    rs._radix_onesweep_cuda(k1, k2, perm, lane, shift, counts, got)
    rs._radix_onesweep_plain(k1, k2, perm, lane, shift, counts, want)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        check(torch.equal(g, w), f"radix_onesweep {label} differs")
        err = max(err, max_abs_err(torch, g, w))
    u_ms, u_spread = kernel_ms(torch, lambda: rs._radix_upfront_cuda(k1, k2))
    u_plain = time_ms(torch, lambda: rs._radix_upfront_plain(k1, k2),
                      reps=5, rounds=3)
    # library yardstick: one bincount over pass * R + digit (the index
    # made beforehand; the port never calls bincount on the card)
    idx = torch.cat([p * rs.RADIX + rs._pass_digits(k1, k2, ln, sh)
                     for p, (ln, sh) in enumerate(rs.PASSES)])
    u_lib = time_ms(torch, lambda: torch.bincount(
        idx, minlength=rs.RADIX_PASSES * rs.RADIX))
    o_ms, o_spread = kernel_ms(torch, lambda: rs._radix_onesweep_cuda(
        k1, k2, perm, lane, shift, counts, got))
    o_plain = time_ms(torch, lambda: rs._radix_onesweep_plain(
        k1, k2, perm, lane, shift, counts, want), reps=2, rounds=3)
    # the same pass (the sort's second) on the sort's own inputs, pass 0's
    # outputs, instead of the input order and a random perm
    p0 = tuple(torch.empty_like(g) for g in got)
    rs._radix_onesweep_cuda(k1, k2, None, *rs.PASSES[0], want_t[0], p0)
    rs._radix_onesweep_plain(*p0, lane, shift, counts, want)
    rs._radix_onesweep_cuda(*p0, lane, shift, counts, got)
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"radix_onesweep {label} differs on pass 0's outputs")
    o_sort_ms, _ = kernel_ms(torch, lambda: rs._radix_onesweep_cuda(
        *p0, lane, shift, counts, got))
    # bytes, each input read once and each output written once: upfront
    # reads (k1, k2) and writes the [8, 256] table; a pass reads (k1, k2,
    # perm) and the 256 counts and writes (k1, k2, perm).  ops: 8 digits
    # and 8 counts a row up front; ~12 a row in a pass
    table_bytes = 4 * rs.RADIX_PASSES * rs.RADIX
    ub_ms, ub_by = bound(8 * n + table_bytes, 16 * n)
    ob_ms, ob_by = bound(24 * n + 4 * rs.RADIX, 12 * n)
    case = {"label": label, "n": n, "max_abs_err": err,
            "tiles": -(-n // rs.RADIX_SORT_TILE),
            "upfront": {"ms": u_ms, "spread": u_spread, "plain_ms": u_plain,
                        "library_ms": u_lib, "bound_ms": ub_ms,
                        "bound_by": ub_by},
            "onesweep": {"ms": o_ms, "spread": o_spread, "plain_ms": o_plain,
                         "library_ms": None, "bound_ms": ob_ms,
                         "bound_by": ob_by,
                         "ms_on_pass0_outputs": o_sort_ms}}
    print(json.dumps({"radix_pass_case": case}))
    return case


def sort_variants(rs):
    """``{label: defines}`` of the sort's tile A/B: the build's own tile is
    the default library, ``()``; each other tile a variant build."""
    return {f"tile={t}": (() if t == rs.RADIX_SORT_TILE
                          else (("MR_ONESWEEP_TILE", t),))
            for t in SORT_TILE_AB}


def variant_sort(torch, kc, rs, defines, k1, k2):
    """The whole sort through the radix library built with *defines*: the
    C call of ``rs._radix_sort_cuda``, uncounted (an A/B launch is not
    the path's)."""
    lib = kc.library("radix", rs._SIGNATURES, defines)
    n = k1.numel()
    a = torch.empty((3, n), dtype=torch.int32, device=k1.device)
    b = torch.empty((3, n), dtype=torch.int32, device=k1.device)
    scratch = torch.empty(lib.mr_radix_sort_scratch_words(n),
                          dtype=torch.int32, device=k1.device)
    kc.check("radix_sort_pairs", lib.mr_radix_sort_pairs(
        kc.ptr(k1), kc.ptr(k2), n, *(kc.ptr(t) for t in a),
        *(kc.ptr(t) for t in b), kc.ptr(scratch), kc.stream(k1.device)))
    return b[0], b[1], b[2]


def sort_ab(torch, kc, rs, label, k1, k2, want):
    """Each tile's whole sort, checked bit-equal to *want*, then timed in
    turns (A B C C B A): ``{label: [ms, ms]}``."""
    variants = sort_variants(rs)
    names = list(variants)
    ab = {v: [] for v in names}
    for v in names + names[::-1]:
        d = variants[v]
        res = variant_sort(torch, kc, rs, d, k1, k2)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(res, want)),
              f"radix sort {label}: the {v} build differs")
        ab[v].append(kernel_ms(torch, lambda: variant_sort(
            torch, kc, rs, d, k1, k2))[0])
    return ab


def radix_sort_case(torch, kc, rs, label, k1, k2):
    """The whole sort against the plain passes and torch.sort, its time
    beside both bounds, and the A/B of the sort's tile size."""
    n = k1.numel()
    got = rs.radix_sort_pairs(k1, k2)
    want = rs._radix_sort_plain(k1, k2)
    packed = ((k1.to(torch.int64) & 0xFFFFFFFF) - 2 ** 31) * 2 ** 32 + (
        k2.to(torch.int64) & 0xFFFFFFFF)
    order = torch.sort(packed, stable=True).indices
    torch.cuda.synchronize()
    for g, w, lane in zip(got, want, ("k1", "k2", "perm")):
        check(torch.equal(g, w), f"radix sort {label}: {lane} differs "
              "from the plain passes")
    check(torch.equal(got[2].to(torch.int64), order),
          f"radix sort {label}: perm differs from torch.sort's")
    ms, spread = kernel_ms(torch, lambda: rs.radix_sort_pairs(k1, k2))
    plain_ms = time_ms(torch, lambda: rs._radix_sort_plain(k1, k2),
                       reps=1, rounds=3)
    lib_ms = time_ms(torch, lambda: torch.sort(packed, stable=True))
    # the sort as a function: reads (k1, k2), writes (k1s, k2s, perm)
    b_ms, b_by = bound(20 * n, 0)
    # the onesweep traffic: 8 B a row up front, 20 B in pass 0 (perm is
    # the row index), 24 B in each of passes 1-7
    t_ms, t_by = bound((8 + 20 + 24 * (rs.RADIX_PASSES - 1)) * n, 0)
    ab = sort_ab(torch, kc, rs, label, k1, k2, got)
    case = {"label": label, "n": n, "ms": ms, "spread": spread,
            "plain_ms": plain_ms, "torch_sort_ms": lib_ms,
            "vs_torch_sort": ms / lib_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "traffic_bound_ms": t_ms, "tile": rs.RADIX_SORT_TILE,
            "tiles": -(-n // rs.RADIX_SORT_TILE),
            "passes": rs.RADIX_PASSES,
            "tile_ab_ms": ab}
    print(json.dumps({"radix_sort_case": case}))
    return case


def replay_check(torch, label, fn, n):
    """*fn* (a kernel wrapper call) captured once in a CUDA graph and
    replayed REPLAYS times: every replay's outputs (a tensor or nested
    tuples and lists of them) bit-equal to the first.  A look-back race,
    or a flag or tile counter not zeroed inside the replay, shows here."""
    def flat(out):
        if isinstance(out, torch.Tensor):
            return [out]
        return [t for o in out for t in flat(o)]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flat(fn())
    graph.replay()
    first = [t.clone() for t in out]
    for i in range(REPLAYS):
        graph.replay()
        check(all(torch.equal(a, b) for a, b in zip(out, first)),
              f"{label} replay {i + 1} differs from the first")
    del graph
    print(json.dumps({label: {"n": n, "replays": REPLAYS,
                              "bit_equal": True}}))


def radix_replay_check(torch, rs, k1, k2):
    """The sort captured once in a CUDA graph and replayed REPLAYS
    times: every replay's outputs bit-equal to the first (the look-back
    flags and tile counters are zeroed inside each replay)."""
    replay_check(torch, "radix_replay", lambda: rs.radix_sort_pairs(k1, k2),
                 k1.numel())


def plan_call(torch, kc, lib, dest, nb):
    """One C call of ``mr_radix_plan`` through *lib* (a tile variant's
    build), as ``rs._radix_plan_cuda`` makes it, uncounted."""
    b, n = dest.shape
    scratch = torch.empty(lib.mr_radix_plan_scratch_words(n, b, nb),
                          dtype=torch.int32, device=dest.device)
    rank = torch.empty_like(dest)
    totals = torch.empty((b, nb), dtype=torch.int32, device=dest.device)
    kc.check("radix_plan", lib.mr_radix_plan(
        kc.ptr(dest), n, b, nb, kc.ptr(scratch), kc.ptr(rank),
        kc.ptr(totals), kc.stream(dest.device)))
    return rank, totals


def radix_plan_case(torch, kc, rs, dest):
    """The plan over [8, 262,144] with 9 buckets, one C call: rank and
    totals against the plain version, its time beside the memory bound,
    the plain version's and torch.bincount's (the counts alone), 50
    graph replays bit-equal, and the A/B of the plan's tile size."""
    b, n = dest.shape
    nb = RADIX_PARTS + 1
    got = rs._radix_plan_cuda(dest, nb)
    want = rs._radix_plan_plain(dest, nb)
    torch.cuda.synchronize()
    err = 0
    for g, w, what in zip(got, want, ("rank", "totals")):
        check(torch.equal(g, w), f"radix_plan: {what} differs from the "
              "plain version")
        err = max(err, max_abs_err(torch, g, w))
    ms, spread = kernel_ms(torch, lambda: rs._radix_plan_cuda(dest, nb))
    plain_ms = time_ms(torch, lambda: rs._radix_plan_plain(dest, nb),
                       reps=5, rounds=3)
    # library yardstick: the counts alone, one bincount over row * nb +
    # bucket (the index made beforehand)
    idx = (torch.arange(b, device=dest.device)[:, None] * nb
           + dest.to(torch.int64)).reshape(-1)
    lib_ms = time_ms(torch, lambda: torch.bincount(idx, minlength=b * nb))
    # reads dest and writes rank, 4 B a row each, and writes the totals
    b_ms, b_by = bound(8 * b * n + 4 * b * nb, 12 * b * n)
    replay_check(torch, "radix_plan_replay",
                 lambda: rs.radix_partition_plan(dest, RADIX_PARTS), b * n)
    libs = {v: kc.library("radix", rs._SIGNATURES, d)
            for v, d in plan_variants(kc).items()}
    ab = timed_turns(torch, libs, "radix plan",
                     lambda lib: plan_call(torch, kc, lib, dest, nb),
                     lambda res: all(torch.equal(g, w)
                                     for g, w in zip(res, want)))
    case = {"label": "plan", "shape": [b, n], "buckets": nb,
            "max_abs_err": err, "ms": ms, "spread": spread,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, "tile": rs.RADIX_TILE,
            "ctas": b * -(-n // rs.RADIX_TILE), "tile_ab_ms": ab}
    print(json.dumps({"radix_plan_case": case}))
    return case


def radix_phase(torch, kc, rs, inputs, dest):
    """Phase 6: returns the three radix kernels' records."""
    sorts = [radix_sort_case(torch, kc, rs, label, *inputs[label])
             for label in ("combiner", "local", "fold")]
    radix_replay_check(torch, rs, *inputs["fold"])
    passes = [radix_pass_case(torch, rs, label, *inputs[label])
              for label in ("combiner", "fold")]
    plan = radix_plan_case(torch, kc, rs, dest)
    err = max(c["max_abs_err"] for c in passes)
    head = passes[0]  # the combiner shape: 32 of the 64 sorts per run

    def record(name, lines, t, error):
        return {"name": name, "route": "cuda",
                "source": "mapreduce_tpu_torch/csrc/radix.cu",
                "replaces": ", ".join(f"mapreduce_tpu/ops/radix_sort.py:{ln}"
                                      for ln in lines),
                "max_abs_err": error, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    # the plan replaces the plan's use of _hist_kernel and _rank_kernel
    return ([record("radix_plan", (96, 112), plan, plan["max_abs_err"]),
             record("radix_upfront", (96,), head["upfront"], err),
             record("radix_onesweep", (119,), head["onesweep"], err)],
            {"sorts": sorts, "passes": passes, "plan": plan})


def radix_slice_phase(torch, kc, rs, wcmod, Partitions, data, want):
    """Phase 7: the radix slice over 8 partitions; returns the word count
    and the launch counts of its counted run."""
    from dataclasses import replace

    cfg = replace(wcmod.bench_engine_config(), sort_impl="radix")
    wc = wcmod.DeviceWordCount(Partitions(RADIX_PARTS, "cuda"),
                               chunk_len=CHUNK_LEN, config=cfg)
    wc.count_bytes(data, waves=RADIX_WAVES)  # warm
    kc.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tm = {}
    t0 = time.monotonic()
    got = wc.count_bytes(data, timings=tm, waves=RADIX_WAVES)
    wall = time.monotonic() - t0
    launches = dict(kc.LAUNCHES)
    plain = dict(kc.PLAIN_CALLS)
    check(got == want, "radix slice: counts differ from Counter")
    check(tm["waves"] == RADIX_WAVES, f"radix slice: {tm['waves']} waves")
    check(all(launches[k] > 0 for k in WORDCOUNT_KERNELS),
          f"radix slice: a kernel was never launched: {launches}")
    check(launches["radix_onesweep"]
          == rs.RADIX_PASSES * launches["radix_upfront"],
          f"radix slice: a sort is not one upfront and "
          f"{rs.RADIX_PASSES} onesweep launches: {launches}")
    check(all(v == 0 for v in plain.values()),
          f"radix slice: plain versions ran on the card path: {plain}")
    matrix = tm["exchange"]["matrix"]
    t0 = time.monotonic()
    host = wc.host_exchange_matrix(data, waves=RADIX_WAVES)
    host_s = time.monotonic() - t0
    check(host.tolist() == matrix, "radix slice: traffic matrix differs "
          "from host_exchange_matrix")
    PHASE_NUMBERS["slice_radix_compute_s"] = tm["compute_s"]
    n_words = sum(want.values())
    print(json.dumps({"slice_radix": {
        "partitions": RADIX_PARTS, "words": n_words, "unique": len(want),
        "waves": tm["waves"], "retries": tm["retries"],
        "compute_s": tm["compute_s"], "upload_s": tm["upload_s"],
        "readback_s": tm["readback_s"], "materialize_s": tm["materialize_s"],
        "wall_s": wall, "words_per_s_compute": n_words / tm["compute_s"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "matrix": matrix, "host_matrix_s": host_s,
        "launches": launches, "plain_calls": plain}}))
    return wc, launches, matrix


def partition_map_phase(torch, wcmod, Partitions, tok, plan_rebalance,
                        wc, data, want):
    """Phase 7, last part: the radix slice under a plan_rebalance table
    made from the corpus's bucket weights."""
    from dataclasses import replace

    chunks, L = wc._to_chunks(data)
    cfg = replace(wc.config, partition_map=True)
    B = wcmod.partition_buckets_for(cfg, RADIX_PARTS)
    hashes = tok.word_hashes_host(b" ".join(want))
    weights = [0] * B
    for word, c in want.items():
        weights[hashes[word][0] % B] += c
    table = plan_rebalance(weights, RADIX_PARTS)
    pwc = wcmod.DeviceWordCount(Partitions(RADIX_PARTS, "cuda"),
                                chunk_len=CHUNK_LEN, config=wc.config,
                                partition_map=table)
    tm = {}
    check(pwc.count_bytes(data, timings=tm, waves=RADIX_WAVES) == want,
          "partition map: counts differ from Counter")
    matrix = tm["exchange"]["matrix"]
    check(pwc.host_exchange_matrix(data, waves=RADIX_WAVES).tolist()
          == matrix, "partition map: traffic matrix differs from the "
          "host recompute under the table")
    print(json.dumps({"partition_map": {
        "buckets": B, "table": table.tolist(),
        "col_sums": tm["exchange"]["col_sums"],
        "compute_s": tm["compute_s"]}}))


def staged_phase(torch, kc, wc, data, want):
    """Phase 4's staged run in the flagship bench's order: ``stage``
    (ingress, residency included), ``warm``, then ``count_staged``: the
    counts, no upload charged, no plain call, and the staged bytes freed
    once the handle is consumed."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    handle = wc.stage(data)
    ingress_s = time.monotonic() - t0
    staged_bytes = sum(t.numel() * t.element_size() for t in handle[2][0])
    mem_staged = torch.cuda.memory_allocated()
    warm_s = wc.warm()
    kc.reset_counts()
    tm = {}
    t0 = time.monotonic()
    got = wc.count_staged(handle, timings=tm)
    wall = time.monotonic() - t0
    launches = dict(kc.LAUNCHES)
    plain = dict(kc.PLAIN_CALLS)
    del handle
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    check(got == want, "staged: counts differ from Counter")
    check("upload_s" not in tm, f"staged: upload charged: {tm}")
    check(all(v == 0 for v in plain.values()),
          f"staged: plain versions ran on the card path: {plain}")
    check(launches["tokenize"] > 0 and launches["segreduce"] > 0,
          f"staged: kernels not launched: {launches}")
    check(mem_staged - mem_after >= staged_bytes,
          f"staged: memory fell {mem_staged - mem_after} bytes, the "
          f"handle held {staged_bytes}")
    print(json.dumps({"staged": {
        "ingress_s": ingress_s, "warm_s": warm_s,
        "compute_s": tm["compute_s"], "readback_s": tm["readback_s"],
        "materialize_s": tm["materialize_s"], "wall_s": wall,
        "first_dispatch_s": tm["first_dispatch_s"], "waves": tm["waves"],
        "staged_bytes": staged_bytes, "memory_allocated_staged": mem_staged,
        "memory_allocated_after": mem_after,
        "launches": launches}}))


def count_sorts(torch):
    """Wrap ``torch.sort`` with a call counter (``tiered_phase``);
    returns ``(counter list, restore)``."""
    orig = torch.sort
    n = [0]

    def counted(*args, **kwargs):
        n[0] += 1
        return orig(*args, **kwargs)

    torch.sort = counted

    def restore():
        torch.sort = orig
    return n, restore


def tiered_phase(torch, kc, wcmod, tiering, Partitions, data, want,
                 matrix):
    """Phase 7b: ``sort_impl='tiered-radix'`` over 8 partitions, (a) warm,
    (b) forced cold, (c) truly cold in a subprocess; *matrix* is the
    radix slice's traffic matrix (already held against the host)."""
    from dataclasses import replace

    cfg = replace(wcmod.bench_engine_config(), sort_impl="tiered-radix")
    wc = wcmod.DeviceWordCount(Partitions(RADIX_PARTS, "cuda"),
                               chunk_len=CHUNK_LEN, config=cfg)
    out = {}
    # (a) warm: every library built, tier 1 (radix) from the first wave
    kc.reset_counts()
    tm = {}
    got = wc.count_bytes(data, timings=tm, waves=RADIX_WAVES)
    launches = dict(kc.LAUNCHES)
    check(got == want, "tiered warm: counts differ from Counter")
    check(tm["exchange"]["matrix"] == matrix,
          "tiered warm: traffic matrix differs")
    check((tm["serving_tier"], tm["tier_cold_start"], tm["tier_swaps"])
          == ("radix", False, 0), f"tiered warm: {tm}")
    check(all(launches[k] > 0 for k in WORDCOUNT_KERNELS),
          f"tiered warm: a kernel was never launched: {launches}")
    check(not any(kc.PLAIN_CALLS.values()), "tiered warm: plain calls")
    out["warm"] = {k: tm[k] for k in ("serving_tier", "tier_cold_start",
                                      "tier_swaps", "first_dispatch_s",
                                      "compute_s")}
    # (b) forced cold: tier 0 (torch.sort, no radix launch) serves wave 0
    engine = wc.engine
    orig_wave = engine._wave
    per_wave = []
    sorts, restore = count_sorts(torch)

    def spy(wave_cfg, *args):
        res = orig_wave(wave_cfg, *args)
        per_wave.append((wave_cfg.sort_impl, sorts[0],
                         kc.LAUNCHES["radix_upfront"]
                         + kc.LAUNCHES["radix_plan"]))
        return res

    engine._wave = spy
    kc.reset_counts()
    tm = {}
    try:
        with tiering.force_cold():
            got = wc.count_bytes(data, timings=tm, waves=RADIX_WAVES)
    finally:
        del engine._wave
        restore()
    check(got == want, "tiered cold: counts differ from Counter")
    check(tm["exchange"]["matrix"] == matrix,
          "tiered cold: traffic matrix differs")
    check(tm["tier_cold_start"] and tm["tier_swaps"] <= 1,
          f"tiered cold: {tm}")
    check(per_wave[0][0] == "argsort" and per_wave[0][1] > 0
          and per_wave[0][2] == 0,
          f"tiered cold: wave 0 did not run on tier 0 alone: {per_wave}")
    check(tm["tier_specialize_failed"] is None,
          f"tiered cold: {tm['tier_specialize_failed']}")
    check(not any(kc.PLAIN_CALLS.values()), "tiered cold: plain calls")
    key = kc.sources_for(replace(cfg, sort_impl="radix"))
    check(engine.specializer.wait(key, timeout=120),
          "tiered cold: the specializer did not finish")
    tm2 = {}
    check(wc.count_bytes(data, timings=tm2, waves=RADIX_WAVES) == want,
          "tiered after the build: counts differ")
    check(tm2["serving_tier"] == "radix",
          f"tiered after the build: served {tm2['serving_tier']}")
    out["forced_cold"] = {
        "per_wave": per_wave, "tier_swaps": tm["tier_swaps"],
        "serving_tier": tm["serving_tier"],
        "first_dispatch_s": tm["first_dispatch_s"],
        "compute_s": tm["compute_s"],
        "next_run_serving_tier": tm2["serving_tier"]}
    # (c) truly cold: fresh build directories, one subprocess each
    for impl in ("tiered-radix", "radix"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--cold", impl],
            capture_output=True, text=True, timeout=COLD_TIMEOUT_S)
        check(proc.returncode == 0, f"cold {impl} run failed "
              f"({proc.returncode}):\n{proc.stdout[-4000:]}"
              f"\n{proc.stderr[-4000:]}")
        out[f"cold_{impl}"] = json.loads(proc.stdout.strip().splitlines()[-1])
    check(TIER_FAILED_KEY not in json.dumps(out)
          and not tiering.TIER_COUNTS["specialize_failed"],
          "tiered: a specialization failed")
    out["tier_counts"] = dict(tiering.TIER_COUNTS)
    print(json.dumps({"tiered": out}))


#: what a cold child prints when its tier-1 build failed
TIER_FAILED_KEY = "specialize_failed_message"
#: words of the truly cold tiered count (phase 7b (c))
COLD_WORDS = 1_000_000
COLD_CHUNK_LEN = 1 << 18
COLD_TIMEOUT_S = 300


def cold_child(impl):
    """Phase 7b (c), in a process of its own: a fresh, empty build
    directory, then a ``COLD_WORDS`` count with ``sort_impl=impl`` at P =
    8, which builds what its first wave needs; prints one JSON line."""
    from dataclasses import replace

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mapreduce_tpu_torch.corpus import N_LINES
    from mapreduce_tpu_torch.corpus import N_WORDS as EUROPARL_WORDS
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.engine import tiering
    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from mapreduce_tpu_torch.ops import kernel_compat as kc
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.utils import compile_cache

    torch.zeros(1, device="cuda")  # the context, outside the timed run
    data = make_corpus(COLD_WORDS, COLD_WORDS * N_LINES // EUROPARL_WORDS,
                       seed=1)
    want = Counter(data.split())
    # a fresh, empty build directory of this process (removed at exit)
    compile_cache.disable_compile_cache()
    cfg = replace(wcmod.bench_engine_config(), sort_impl=impl)
    wc = wcmod.DeviceWordCount(Partitions(RADIX_PARTS, "cuda"),
                               chunk_len=COLD_CHUNK_LEN, config=cfg)
    tm = {}
    t0 = time.monotonic()
    got = wc.count_bytes(data, timings=tm, waves=3)
    wall = time.monotonic() - t0
    check(got == want, f"cold {impl}: counts differ from Counter")
    out = {"impl": impl, "words": COLD_WORDS, "wall_s": wall,
           "first_dispatch_s": tm["first_dispatch_s"],
           "compute_s": tm["compute_s"], "waves": tm["waves"],
           "build_s": dict(kc.BUILD_SECONDS)}
    if impl == "tiered-radix":
        key = kc.sources_for(replace(cfg, sort_impl="radix"))
        check(wc.engine.specializer.wait(key, timeout=COLD_TIMEOUT_S),
              "cold: the specializer did not finish")
        failed = wc.engine.specializer.failed(key)
        if failed:
            out[TIER_FAILED_KEY] = failed
        check(not failed, f"cold: the tier-1 build failed: {failed}")
        out.update(
            serving_tier=tm["serving_tier"],
            tier_cold_start=tm["tier_cold_start"],
            tier_swaps=tm["tier_swaps"],
            build_s=dict(kc.BUILD_SECONDS),
            specializer_s=wc.engine.specializer.seconds[key])
        tm2 = {}
        check(wc.count_bytes(data, timings=tm2, waves=3) == want,
              "cold: the second run's counts differ")
        out["next_run_serving_tier"] = tm2["serving_tier"]
        check(tm2["serving_tier"] == "radix",
              f"cold: the second run served {tm2['serving_tier']}")
    print(json.dumps(out))
    return 0


def flash_inputs(torch, fa, B, H, Tq, Tk, D, seed):
    """(q, k, v, q^, do) bf16 on the card from a seeded generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(T):
        return torch.randn((B, H, T, D), generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = mk(Tq), mk(Tk), mk(Tk), mk(Tq)
    return q, k, v, fa._prescale(q, D ** -0.5), do


def flash_case(torch, fa, label, B, H, Tq, Tk, D, causal):
    """The three kernels against their plain versions on one shape (the
    backward ones fed the kernel's own lse, so each is checked alone);
    returns the inputs and each kernel's max abs error."""
    q, k, v, qh, do = flash_inputs(torch, fa, B, H, Tq, Tk, D, seed=Tq + D)
    scale = D ** -0.5
    out, lse = fa._flash_fwd_cuda(qh, k, v, causal)
    w_out, w_lse = fa.flash_fwd_plain(qh, k, v, causal)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    dq = fa._flash_dq_cuda(qh, k, v, do, lse, delta, causal, scale)
    w_dq = fa.flash_dq_plain(qh, k, v, do, lse, delta, causal, scale)
    dk, dv = fa._flash_dkv_cuda(qh, k, v, do, lse, delta, causal)
    w_dk, w_dv = fa.flash_dkv_plain(qh, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    errs = {}
    for kern, name, got, want, tol in (
            ("flash_fwd", "out", out, w_out, FLASH_TOL),
            ("flash_fwd", "lse", lse, w_lse, dict(atol=LSE_ATOL, rtol=0)),
            ("flash_dq", "dq", dq, w_dq, FLASH_TOL),
            ("flash_dkv", "dk", dk, w_dk, FLASH_TOL),
            ("flash_dkv", "dv", dv, w_dv, FLASH_TOL)):
        g, w = got.float(), want.float()
        check(bool(torch.isfinite(g).all()), f"{label}: {name} not finite")
        check(torch.allclose(g, w, **tol), f"{label}: {name} differs from "
              f"the plain version beyond {tol}: max abs err "
              f"{float((g - w).abs().max())}")
        errs[kern] = max(errs.get(kern, 0.0), float((g - w).abs().max()))
    print(json.dumps({"flash_case": {
        "label": label, "shape": [B, H, Tq, Tk, D], "causal": causal,
        "max_abs_err": errs}}))
    return (q, k, v, qh, do, lse, delta), errs


def flash_phase(torch, fa):
    """Phase 10: returns the three flash kernels' records."""
    import torch.nn.functional as F

    B, H, T, D = TF_B, TF_CONFIG["n_heads"], TF_T, TF_CONFIG["head_dim"]
    (q, k, v, qh, do, lse, delta), errs = flash_case(
        torch, fa, "slice", B, H, T, T, D, True)
    for label, shape, causal in (("full", (2, 8, 1024, 1024, 128), False),
                                 ("ragged", (2, 8, 2000, 2000, 64), True)):
        _, e = flash_case(torch, fa, label, *shape, causal)
        for kern in e:
            errs[kern] = max(errs[kern], e[kern])
    scale = D ** -0.5
    # the work: the (query, key) pairs the causal mask keeps, 2*D FLOPs a
    # pair for each product; bytes of each input read once and each
    # output written once (one bf16 [B, H, T, D] tensor, one f32 [B, H,
    # T, 1] row)
    pairs = B * H * T * (T + 1) // 2
    tensor, row = 2 * B * H * T * D, 4 * B * H * T
    work = {  # (FLOPs, bytes)
        "flash_fwd": (2 * 2 * D * pairs, 4 * tensor + row),
        "flash_dq": (3 * 2 * D * pairs, 5 * tensor + 2 * row),
        "flash_dkv": (4 * 2 * D * pairs, 6 * tensor + 2 * row)}
    calls = {
        "flash_fwd": (lambda: fa._flash_fwd_cuda(qh, k, v, True),
                      lambda: fa.flash_fwd_plain(qh, k, v, True)),
        "flash_dq": (lambda: fa._flash_dq_cuda(qh, k, v, do, lse, delta,
                                               True, scale),
                     lambda: fa.flash_dq_plain(qh, k, v, do, lse, delta,
                                               True, scale)),
        "flash_dkv": (lambda: fa._flash_dkv_cuda(qh, k, v, do, lse, delta,
                                                 True),
                      lambda: fa.flash_dkv_plain(qh, k, v, do, lse, delta,
                                                 True))}
    # the library yardstick: SDPA on the unscaled q (it scales itself)
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), do)

    lib_fwd_bwd = time_ms(torch, sdpa_fwd_bwd)
    # SDPA's backward alone: one forward kept, the gradient call timed (one
    # call computes dq, dk and dv together: the yardstick of both
    # backward kernels).  Events around the calls read host time on a
    # slow host (the call's host work can exceed its device time), so the
    # yardstick is its device time under the profiler, like kernel_ms
    o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_bwd():
        torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True)

    lib_bwd = time_ms(torch, sdpa_bwd)
    groups, _ = device_profile(torch, "profile_sdpa_bwd",
                               lambda: [sdpa_bwd() for _ in range(REPS)],
                               lambda name: "sdpa backward")
    lib_bwd_device = groups["sdpa backward"] / REPS / 1e3
    del o
    library = {"flash_fwd": lib_fwd, "flash_dq": lib_bwd_device,
               "flash_dkv": lib_bwd_device}
    records = []
    for name, line in (("flash_fwd", 94), ("flash_dq", 153),
                       ("flash_dkv", 204)):
        kern, plain = calls[name]
        ms, spread = kernel_ms(torch, kern)
        plain_ms = time_ms(torch, plain, reps=2, rounds=3)
        flops, nbytes = work[name]
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        print(f"{name} [{B}, {H}, {T}, {D}] causal, tiles "
              f"{fa.TILES[name]}: kernel {ms:.4f} ms (spread {spread:.3f}, "
              f"{flops / ms / 1e9:.1f} TFLOP/s, {ms / library[name]:.2f}x "
              f"the SDPA yardstick {library[name]:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        records.append({
            "name": name, "route": "cuda",
            "source": "mapreduce_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"mapreduce_tpu/ops/flash_attention.py:{line}",
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library[name]})
    print(json.dumps({"flash_library": {
        "sdpa_fwd_ms": lib_fwd, "sdpa_fwd_bwd_ms": lib_fwd_bwd,
        "sdpa_bwd_ms": lib_bwd, "sdpa_bwd_device_ms": lib_bwd_device,
        "kernels_fwd_ms": records[0]["ms"],
        "kernels_bwd_ms": records[1]["ms"] + records[2]["ms"]}}))
    return records


def flash_scaling(torch, fa):
    """What bounds the wgmma kernels: each timed at the slice's shape
    without the causal mask (every CTA does the same work, so no tail of
    uneven tiles) and causal with 4x the batch (4x the CTAs over the same
    SMs, so the last wave is a smaller share).  Prints one JSON line of ms
    and TFLOP/s."""
    D = TF_CONFIG["head_dim"]
    scale = D ** -0.5
    out = {}
    for label, B, causal in (("causal", TF_B, True),
                             ("full", TF_B, False),
                             ("causal_4x_batch", 4 * TF_B, True)):
        H, T = TF_CONFIG["n_heads"], TF_T
        _, k, v, qh, do = flash_inputs(torch, fa, B, H, T, T, D, seed=7)
        o, lse = fa._flash_fwd_cuda(qh, k, v, causal)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
        for name, fn, flops in (
                ("flash_fwd", lambda: fa._flash_fwd_cuda(qh, k, v, causal),
                 4 * D * pairs),
                ("flash_dq", lambda: fa._flash_dq_cuda(
                    qh, k, v, do, lse, delta, causal, scale), 6 * D * pairs),
                ("flash_dkv", lambda: fa._flash_dkv_cuda(
                    qh, k, v, do, lse, delta, causal), 8 * D * pairs)):
            ms, _ = kernel_ms(torch, fn)
            out[f"{name}/{label}"] = {"shape": [B, H, T, D], "ms": ms,
                                      "tflops": flops / ms / 1e9}
        del k, v, qh, do, o, lse, delta
    print(json.dumps({"flash_scaling": out}))


def ptxas_report(kc, rs):
    """Phase 1: each kernel's registers and spill bytes from this run's
    builds (``nvcc -Xptxas -v``), one JSON line.  Fails if a flash kernel
    instantiation, the onesweep kernel of the radix library or of its
    tile-size variants, the plan kernel of the radix library or of its
    tile-size variant, or a tokenize or segreduce kernel of the default
    build or of a tile variant spills.  A library built by an earlier
    process left no log here, and is not checked."""
    usage = {name: kc.ptxas_usage(log)
             for name, log in kc.BUILD_LOGS.items()}
    print(json.dumps({"ptxas": usage}))

    def no_spills(kernels):
        return kernels and all(
            u.get("spill_stores") == 0 and u.get("spill_loads") == 0
            and u.get("registers", 0) > 0 for u in kernels.values())

    checked = {kc.build_label("radix", d)
               for d in [*sort_variants(rs).values(),
                         *plan_variants(kc).values()]}
    radix = {f"{lib}/{k}": u for lib, kernels in usage.items()
             if lib in checked for k, u in kernels.items()}
    if radix:
        for kernel in ("onesweep_kernel", "plan_kernel"):
            hot = {k: u for k, u in radix.items() if kernel in k}
            check(no_spills(hot), f"ptxas: a {kernel} spills or was not "
                  f"reported: {hot}")
    else:
        print("ptxas: radix.cu was built earlier; spills not checked")
    # the scan kernels: tokenize for 1-3 lanes, segreduce for 1-3 int32
    # lanes, unit mode and 1-3 float32 lanes, in the default build and
    # each tile variant
    for src, count in (("tokenize", 3), ("segreduce", 7)):
        for lib in [kc.build_label(src, d)
                    for d in scan_variants(kc, src).values()]:
            kernels = usage.get(lib)
            if kernels is None:
                print(f"ptxas: {lib} was built earlier; spills not checked")
                continue
            check(len(kernels) == count and no_spills(kernels),
                  f"ptxas: a {lib} kernel spills or was not reported: "
                  f"{kernels}")
    flash = usage.get("flash_attention")
    if flash is None:
        print("ptxas: flash_attention.cu was built earlier; spills not "
              "checked")
        return
    # three kernels, each for bf16 and fp16 and 64- and 128-wide heads
    check(len(flash) == 12 and no_spills(flash),
          f"ptxas: a flash kernel spills or was not reported: {flash}")


def _tf_group(name):
    if "mr_flash_kernels" in name:
        return "flash kernels"
    low = name.lower()
    if any(s in low for s in ("gemm", "xmma", "nvjet", "cutlass", "cublas")):
        return "matmul (cuBLAS)"
    if "copy" in low:
        return "copies and casts"
    if "reduce" in low:
        return "reductions"
    return "other elementwise"


def logits_phase(torch, cfg):
    """What the f32-result logits product costs: ``[B*T, E] @ [E, V]``
    with bf16 operands as one GEMM writing f32 (``torch.mm(out_dtype=)``,
    the port's choice), as the plain bf16 GEMM (bf16 result), and with
    both operands upcast to f32 (an f32 GEMM)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((TF_B * TF_T, cfg.embed), generator=g,
                    device="cuda").to(cfg.dtype)
    w = torch.randn((cfg.embed, cfg.vocab), generator=g,
                    device="cuda").to(cfg.dtype)
    xf, wf = x.float(), w.float()
    times = {
        "out_dtype_f32_ms": time_ms(torch, lambda: torch.mm(
            x, w, out_dtype=torch.float32)),
        "bf16_ms": time_ms(torch, lambda: torch.mm(x, w)),
        "upcast_f32_ms": time_ms(torch, lambda: torch.mm(xf, wf), reps=5,
                                 rounds=3)}
    print(json.dumps({"logits_matmul": dict(
        shape=[TF_B * TF_T, cfg.embed, cfg.vocab], **times)}))


def trainer_phase(torch, kc, fa, tmod):
    """Phase 11: the transformer slice; returns the flash launch counts of
    its counted steps."""
    import numpy as np

    cfg = tmod.TransformerConfig(**TF_CONFIG)
    tr = tmod.TransformerTrainer(cfg, learning_rate=TF_LR, seed=0,
                                 device="cuda")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(TF_B, TF_T + 1)).astype(np.int32)
    t0 = time.monotonic()
    params = tr.init_params()
    p0 = {n: t.clone() for n, t in params.state_dict().items()}
    n_params = sum(t.numel() for t in p0.values())
    init_s = time.monotonic() - t0

    # the step-0 loss on random targets is about ln(vocab) + s2 / 2, s2 the
    # logits' variance over the vocabulary: the model has no final norm,
    # so s2 is |hidden|^2 / embed, well above 0 at this depth
    with torch.no_grad():
        hidden, _ = tmod.forward_local(params, tr.place_batch(toks)[0], cfg)
        logits = torch.matmul(hidden.to(cfg.dtype).float(),
                              params.unembed.to(cfg.dtype).float())
        s2 = float(logits.var(dim=-1).mean())
        del hidden, logits
    expected = math.log(cfg.vocab) + s2 / 2

    # step 0 through the kernels (also the warm step), then the same step
    # with the flash wrappers swapped for their plain versions
    t0 = time.monotonic()
    params, loss = tr.step(params, toks)
    loss_k = float(loss)
    first_s = time.monotonic() - t0
    check(math.isfinite(loss_k) and abs(loss_k - expected) < 2,
          f"trainer: step-0 loss {loss_k} not within 2 of ln(vocab) + "
          f"s2/2 = {expected} (s2 = {s2})")
    ref = tmod.Transformer(cfg, device="cuda")
    ref.load_state_dict(p0)
    kernels = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)
    fa.flash_fwd, fa.flash_dq, fa.flash_dkv = (
        fa.flash_fwd_plain, fa.flash_dq_plain, fa.flash_dkv_plain)
    try:
        ref, loss = tr.step(ref, toks)
        loss_p = float(loss)
    finally:
        fa.flash_fwd, fa.flash_dq, fa.flash_dkv = kernels
    upd_err = {}
    pk, pp = params.state_dict(), ref.state_dict()
    for n in p0:
        dk, dp = pk[n] - p0[n], pp[n] - p0[n]
        upd_err[n] = float((dk - dp).norm() / dp.norm().clamp_min(1e-30))
    worst = max(upd_err, key=upd_err.get)
    check(abs(loss_k - loss_p) < STEP_LOSS_ATOL,
          f"trainer: step-0 loss {loss_k} through the kernels, {loss_p} "
          "through the plain versions")
    check(upd_err[worst] < STEP_UPDATE_RTOL,
          f"trainer: {worst}'s update differs by {upd_err[worst]} of its "
          "norm from the plain-attention step")
    del ref, pk, pp, p0

    # the counted run: TF_STEPS steps through the kernels
    kc.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(TF_STEPS):
        t0 = time.monotonic()
        params, loss = tr.step(params, toks)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        losses.append(float(loss))
    launches = {k: kc.LAUNCHES[k] for k in FLASH_KERNELS}
    plain = dict(kc.PLAIN_CALLS)
    check(all(launches[k] > 0 for k in FLASH_KERNELS),
          f"trainer: a flash kernel was never launched: {launches}")
    check(all(v == 0 for v in plain.values()),
          f"trainer: plain versions ran on the card path: {plain}")
    check(all(math.isfinite(x) for x in losses), f"trainer: {losses}")
    step_s = statistics.median(times)
    flops = tmod.train_flops(cfg, n_params, TF_B, TF_T)
    print(json.dumps({"slice_transformer": {
        "config": TF_CONFIG, "batch": TF_B, "seq_len": TF_T,
        "params": n_params, "init_s": init_s, "first_step_s": first_s,
        "step0_loss": loss_k, "step0_loss_plain": loss_p,
        "step0_logit_var": s2, "step0_loss_expected": expected,
        "step0_update_rel_err_max": upd_err[worst],
        "step0_update_rel_err_worst": worst,
        "losses": losses, "step_s": times, "step_s_median": step_s,
        "tokens_per_s": TF_B * TF_T / step_s, "flops_per_step": flops,
        "mfu": flops / step_s / BF16_FLOPS_PER_S,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches, "plain_calls": plain}}))

    state = {"params": params}

    def one_step():
        state["params"], _ = tr.step(state["params"], toks)

    groups, _ = device_profile(torch, "profile_transformer", one_step,
                               _tf_group)
    check(groups.get("flash kernels", 0) > 0,
          f"profile_transformer: no flash-kernel device time: {groups}")
    logits_phase(torch, cfg)
    return launches


def percentile(values, q):
    """The nearest-rank *q* quantile of *values*."""
    v = sorted(values)
    return v[min(len(v) - 1, max(0, math.ceil(q * len(v)) - 1))]


def acc_bytes(sess, task):
    """Device bytes of one resident stream's accumulator lanes."""
    return sum(t.numel() * t.element_size()
               for t in sess._streams[task].acc)


def check_launches(launches, plain, label, radix):
    need = WORDCOUNT_KERNELS if radix else ("tokenize", "segreduce")
    check(all(launches[k] > 0 for k in need),
          f"{label}: a kernel of the path was never launched: {launches}")
    check(not any(plain.values()),
          f"{label}: plain versions ran on the card path: {plain}")


def sustained_case(torch, kc, wcmod, smod, Partitions, parts, sort_impl,
                   tenants):
    """Phase 8a: bench.py's measure_sustained at full size on *parts*
    partitions.  Each tenant's first feed and snapshot (the first
    result), then 2 x SESSION_ROUNDS rounds of the three tenants' feeds
    interleaved, the rounds alternating between one overflow read a
    feed (the port's) and one after every wave (the JAX feed's, by a
    wrapper of the engine's wave here), each feed followed by the
    tenant's snapshot, and last every tenant's snapshot once more (the
    aged reads).  As in measure_sustained, a churn thread submits,
    ticks and cancels scheduler tasks all the while, and each tenant's
    first feed follows its own scheduler submit, whose stamp the first
    snapshot observes (``submit_first_snapshot_p99_s`` from this run's
    bucket deltas of ``merged_counts``).  After the timed work, every
    snapshot is held against Counter of exactly its tenant's words
    times the feeds it had folded.  Returns the case's numbers."""
    import threading
    from dataclasses import replace

    import numpy as np

    from mapreduce_tpu_torch.coord.docstore import MemoryDocStore
    from mapreduce_tpu_torch.engine.device_engine import EngineConfig
    from mapreduce_tpu_torch.obs import slo
    from mapreduce_tpu_torch.obs.metrics import estimate_percentile
    from mapreduce_tpu_torch.sched.scheduler import (
        Scheduler, SchedulerConfig)

    cfg = replace(EngineConfig(**SESSION_CONFIG), sort_impl=sort_impl)
    if parts == 1:
        # one partition routes every local unique to itself: the
        # bench's per-pair exchange capacity (1<<15) cannot hold a 1 MB
        # chunk's ~35K distinct words, so it takes the local capacity
        cfg = replace(cfg, exchange_capacity=cfg.local_capacity)
    sess = smod.EngineSession(Partitions(parts, "cuda"),
                              wcmod._wordcount_map_fn, cfg)
    first = tenants[SESSION_TENANTS[0]][0]
    row_bytes = first.nbytes // first.shape[0]
    # k from the full feed (bench.py's rule), not from the warm feed
    sess.k = max(1, min(sess.engine._rows_per_wave(row_bytes),
                        -(-first.shape[0] // parts)))
    sess.feed(first[:parts], task="warm")
    sess.snapshot("warm")
    sess.close("warm")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    fed = dict.fromkeys(SESSION_TENANTS, 0)
    done_at = {}
    snap_s, stale, peaks = [], [], []
    taken = []  # (label, task, feeds folded, snapshot), checked last
    real_wave = sess.engine._wave

    def wave_then_read(*args):
        out = real_wave(*args)
        int(out.overflow.sum())  # the JAX feed's per-wave readback
        return out

    def feed(task):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        sess.feed(tenants[task][0], task=task)
        done_at[task] = time.monotonic()
        peaks.append(torch.cuda.max_memory_allocated() - before)
        fed[task] += 1
        return done_at[task] - t0

    def snapshot(task, label):
        t0 = time.monotonic()
        snap = sess.snapshot(task)
        t1 = time.monotonic()
        snap_s.append(t1 - t0)
        stale.append(t1 - done_at[task])
        taken.append((label, task, fed[task], snap))
        return t1

    scheduler = Scheduler(MemoryDocStore(), config=SchedulerConfig(
        max_inflight=len(SESSION_TENANTS) + 1))
    bounds, sub_base = slo.merged_counts(slo.FIRST_RESULT_FAMILY,
                                         SESSION_TENANTS)
    churn_stop = threading.Event()
    churn = {"submitted": 0, "cancelled": 0}

    def churn_loop():
        i = 0
        while not churn_stop.is_set():
            doc = scheduler.submit("churn", db=f"churn_{i}",
                                   kind="session", est_jobs=1)
            scheduler.tick()
            churn["submitted"] += 1
            if scheduler.cancel(doc["_id"]) is not None:
                churn["cancelled"] += 1
            i += 1
            churn_stop.wait(0.02)

    churn_t = threading.Thread(target=churn_loop, daemon=True)
    kc.reset_counts()
    churn_t.start()
    first_result = []
    for task in SESSION_TENANTS:
        doc = scheduler.submit(task, db=f"sess_{task}", kind="session",
                               est_jobs=SESSION_ROUNDS)
        scheduler.tick()
        t0 = time.monotonic()
        feed(task)
        first_result.append(snapshot(task, "first") - t0)
        slo.observe_first_result(doc["_id"], task)
    resident = {t: acc_bytes(sess, t) for t in SESSION_TENANTS}
    torch.cuda.synchronize()
    per_stream = (torch.cuda.memory_allocated() - base) / len(
        SESSION_TENANTS)
    walls = {"feed": [], "wave": []}
    for r in range(2 * SESSION_ROUNDS):
        read = "wave" if r % 2 else "feed"
        sess.engine._wave = wave_then_read if r % 2 else real_wave
        try:
            for task in SESSION_TENANTS:
                walls[read].append(feed(task))
                snapshot(task, f"sustained P={parts} round {r}")
        finally:
            sess.engine._wave = real_wave
    for task in SESSION_TENANTS:  # the aged reads (bench.py phase 3)
        snapshot(task, f"sustained P={parts} aged")
    churn_stop.set()
    churn_t.join(timeout=5)
    check(not churn_t.is_alive(), "sustained: the churn thread hangs")
    _, sub_now = slo.merged_counts(slo.FIRST_RESULT_FAMILY,
                                   SESSION_TENANTS)
    sub_counts = [b - a for a, b in zip(sub_base, sub_now)]
    check(sum(sub_counts) == len(SESSION_TENANTS),
          f"sustained: {sum(sub_counts)} submit->first-snapshot "
          f"observations for {len(SESSION_TENANTS)} tenants")
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    check_launches(launches, plain, f"sustained P={parts}",
                   sort_impl == "radix")
    for label, task, n, snap in taken:
        chunks, want, _ = tenants[task]
        check(snap.overflow == 0, f"{label}: {task} overflowed")
        got = wcmod.materialize_counts(np.concatenate([chunks] * n), snap)
        check(got == {w: c * n for w, c in want.items()},
              f"{label}: tenant {task}'s counts differ from Counter of "
              f"its own words x {n}")
    records = SESSION_ROUNDS * sum(t[2] for t in tenants.values())
    waves = sum(sess.stats(t)["waves"] for t in SESSION_TENANTS)
    sess.close()
    return {
        "partitions": parts, "sort_impl": sort_impl, "k": sess.k,
        "exchange_capacity": cfg.exchange_capacity,
        "records_per_s": records / sum(walls["feed"]),
        "records_per_s_per_wave_read": records / sum(walls["wave"]),
        "records_a_mode": records, "feeds_a_mode": len(walls["feed"]),
        "waves": waves,
        "feed_wall_p50_s": percentile(walls["feed"], 0.5),
        "feed_wall_p99_s": percentile(walls["feed"], 0.99),
        "feed_wall_p50_s_per_wave_read": percentile(walls["wave"], 0.5),
        "first_snapshot_s": first_result,
        "submit_first_snapshot_p99_s": estimate_percentile(
            bounds, sub_counts, 0.99),
        "submit_first_snapshot_p50_s": estimate_percentile(
            bounds, sub_counts, 0.50),
        "churn": dict(churn),
        "snapshot_p50_s": percentile(snap_s, 0.5),
        "snapshot_p99_s": percentile(snap_s, 0.99),
        "staleness_p50_s": percentile(stale, 0.5),
        "staleness_p99_s": percentile(stale, 0.99),
        "resident_bytes_per_stream": resident,
        "memory_allocated_per_stream": per_stream,
        "feed_peak_over_resident_bytes": max(peaks),
        "launches": launches}


def session_host_matrix(hashes, chunks, feeds, k, P, tables):
    """The traffic matrix a session accumulates, recomputed on the host:
    per feed, per wave, entry [src][dst] counts the distinct word keys
    of partition src's real rows routed to dst through that feed's
    table (*hashes*: word -> (k1, k2))."""
    import numpy as np

    matrix = np.zeros((P, P), dtype=np.int64)
    for (lo, hi), table in zip(feeds, tables):
        B = table.shape[0]
        for w in range(-(-(hi - lo) // (k * P))):
            for d in range(P):
                a = lo + w * k * P + d * k
                words = set()
                for row in chunks[a:min(a + k, hi)]:
                    words.update(row.tobytes().split())
                for k1, _k2 in {hashes[wd] for wd in words}:
                    matrix[d, int(table[k1 % B])] += 1
    return matrix


def flagship_session(torch, kc, wcmod, smod, spill, router, Partitions,
                     plan_rebalance, tok, chunks, want):
    """Phase 8b: the flagship config as a session at P = 8 on the radix
    path with a partition map: the 24 chunks in SESSION_FEEDS feeds, a
    rebalance after the second to a plan_rebalance table of the
    stream's own bucket histogram after the first, the last two feeds
    profiled (uploads pinned and off the kernels' stream); then an evict
    and the lazy
    restore of the next snapshot (bench.py's measure_session_restore),
    and a resident cap of one evicting the colder stream."""
    from dataclasses import replace

    import numpy as np

    P = RADIX_PARTS
    cfg = replace(wcmod.bench_engine_config(), sort_impl="radix",
                  partition_map=True)
    store = spill.SessionSpillStore(router("mem:chip-smoke"))
    sess = smod.EngineSession(Partitions(P, "cuda"),
                              wcmod._wordcount_map_fn, cfg, spill=store)
    per = chunks.shape[0] // SESSION_FEEDS
    feeds = [(i * per, (i + 1) * per) for i in range(SESSION_FEEDS)]
    sess.feed(chunks[:P], task="warm")
    sess.close("warm")
    B = sess.engine.partition_buckets
    table = np.arange(B, dtype=np.int32) % P
    tables = []
    kc.reset_counts()
    for i, (lo, hi) in enumerate(feeds[:2]):
        if i == 1:
            table = plan_rebalance(sess.bucket_histogram("flag"), P)
            t0 = time.monotonic()
            sess.rebalance("flag", table)
            rebalance_s = time.monotonic() - t0
        tables.append(table)
        sess.feed(chunks[lo:hi], task="flag")
    tables += [table] * (len(feeds) - 2)

    def last_feeds():
        for lo, hi in feeds[2:]:
            sess.feed(chunks[lo:hi], task="flag")

    # the feeds after the table's upload (the second feed's), profiled
    waves0, before = sess.stats("flag")["waves"], dict(kc.LAUNCHES)
    _, events = device_profile(
        torch, "profile_session", last_feeds, _profile_group,
        on_trace=lambda ev: upload_report(
            "profile_session", ev,
            expect=sess.stats("flag")["waves"] - waves0))
    profiled = {k: kc.LAUNCHES[k] - before[k] for k in WORDCOUNT_KERNELS}
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    check_launches(launches, plain, "flagship session", True)
    check(np.array_equal(sess.partition_map("flag"), table)
          and not np.array_equal(table, tables[0]),
          "flagship session: the rebalance changed no routing")
    t0 = time.monotonic()
    snap = sess.snapshot("flag")
    snapshot_s = time.monotonic() - t0
    check(wcmod.materialize_counts(chunks, snap) == want,
          "flagship session: counts differ from Counter(data.split())")
    hashes = tok.word_hashes_host(b" ".join(want))
    matrix = sess.traffic_matrix("flag")
    check(np.array_equal(matrix, session_host_matrix(
        hashes, chunks, feeds, sess.k, P, tables)),
        "flagship session: traffic matrix differs from the host "
        "recompute under the two tables")
    resident = acc_bytes(sess, "flag")

    def same(a, b):
        return all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in ("keys", "values", "payload", "valid"))

    t0 = time.monotonic()
    sess.evict("flag")
    spill_s = time.monotonic() - t0
    check(sess.tasks() == [], "flagship session: evict left the stream")
    t0 = time.monotonic()
    restored = sess.snapshot("flag")  # the lazy restore
    restore_s = time.monotonic() - t0
    check(same(restored, snap), "flagship session: the restored snapshot "
          "differs from the one before the evict")
    sess.feed(chunks[:per], task="side")
    sess.spill_policy = spill.SpillPolicy(max_resident=1)
    sess.feed(chunks[per:2 * per], task="side")
    check(sess.tasks() == ["side"] and store.has("flag"),
          f"flagship session: the resident cap kept {sess.tasks()}")
    check(same(sess.snapshot("flag"), snap),
          "flagship session: restored after the cap, the snapshot differs")
    return {"partitions": P, "feeds": len(feeds), "k": sess.k,
            "buckets": B, "rebalance_s": rebalance_s,
            "snapshot_s": snapshot_s, "session_spill_s": spill_s,
            "session_restore_s": restore_s,
            "resident_bytes": resident,
            "spilled_bytes": sum(len(store.storage.read_bytes(n))
                                 for n in store.storage.list(r"\.npy$")),
            "col_sums": matrix.sum(axis=0).tolist(),
            "launches": launches, "profiled_launches": profiled,
            "profiled_events": events}


def topk_session(torch, kc, wcmod, topk, Partitions, data):
    """Phase 8c: TopKWords(k=100) over the corpus in SESSION_FEEDS
    feeds (cut at whitespace) on the radix path at P = 8, equal to
    host_topk."""
    from dataclasses import replace

    cfg = replace(wcmod.bench_engine_config(), sort_impl="radix")
    tk = topk.TopKWords(Partitions(RADIX_PARTS, "cuda"), k=TOPK_K,
                        chunk_len=CHUNK_LEN, config=cfg)
    parts, lo = [], 0
    for i in range(1, SESSION_FEEDS + 1):
        hi = len(data) * i // SESSION_FEEDS
        while hi < len(data) and data[hi] not in b" \n\t\r\x0b\x0c":
            hi += 1
        parts.append(data[lo:hi])
        lo = hi
    kc.reset_counts()
    t0 = time.monotonic()
    for part in parts:
        tk.feed(part)
    feed_s = time.monotonic() - t0
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    check_launches(launches, plain, "topk", True)
    t0 = time.monotonic()
    top = tk.topk()
    topk_s = time.monotonic() - t0
    check(top == topk.host_topk(data, TOPK_K),
          "topk: differs from host_topk")
    return {"k": TOPK_K, "feeds": len(parts), "feed_s": feed_s,
            "topk_s": topk_s, "top3": [[w.decode(), c] for w, c in top[:3]],
            "launches": launches}


def session_phase(torch, kc, wcmod, Partitions, plan_rebalance, tok, data,
                  chunks, want, smi):
    """Phase 8: the resident sessions (the ``session`` line).  Returns
    the tenants' records (phase 15 (b) feeds one again)."""
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.engine import session as smod
    from mapreduce_tpu_torch.engine import spill
    from mapreduce_tpu_torch.engine import topk
    from mapreduce_tpu_torch.storage.router import router

    tenants = {}
    for seed, task in enumerate(SESSION_TENANTS):
        text = make_corpus(SESSION_WORDS, SESSION_WORDS // 25, seed=seed)
        rows, _ = tok.shard_text(
            text, -(-len(text) // SESSION_CHUNK_LEN), pad_multiple=512,
            pad_to=SESSION_CHUNK_LEN + 512)
        tenant_want = Counter(text.split())
        tenants[task] = (rows, tenant_want, sum(tenant_want.values()))
    def part(name, value):
        # each part as it ends (a failure later keeps the earlier ones)
        print(json.dumps({"session_part": {name: value}}), flush=True)
        return value

    out = {"card": smi, "sustained": [
        part(f"sustained_p{parts}", sustained_case(
            torch, kc, wcmod, smod, Partitions, parts, impl, tenants))
        for parts, impl in ((1, "variadic"), (RADIX_PARTS, "radix"))]}
    PHASE_NUMBERS["sustained_p1_records_per_s"] = \
        out["sustained"][0]["records_per_s"]
    PHASE_NUMBERS["sustained_p8_records_per_s"] = \
        out["sustained"][1]["records_per_s"]
    out["flagship"] = part("flagship", flagship_session(
        torch, kc, wcmod, smod, spill, router, Partitions, plan_rebalance,
        tok, chunks, want))
    out["topk"] = part("topk", topk_session(torch, kc, wcmod, topk,
                                            Partitions, data))
    print(json.dumps({"session": out}))
    return tenants


#: the job plane's files: the slice's corpus cut into this many files of
#: whole lines
JOB_FILES = 24
#: the host-vs-device corpus: 3 files, this many words (seed 1)
JOB_SMALL_WORDS = 200_000
JOB_WORKERS = 4
JOB_REDUCERS = 4
#: seconds a Server.loop with worker threads may take before the phase
#: fails (its phase polling has no deadline of its own)
JOB_LOOP_TIMEOUT = 300
JOB_MODULE = "mapreduce_tpu_torch.examples.wordcount"


def write_line_files(data, n, root):
    """*data* cut at newlines into *n* files of whole lines whose
    ``b"\n"``-join is *data* again (the device phase joins them so)."""
    cuts = [0]
    for i in range(1, n):
        at = data.find(b"\n", i * len(data) // n)
        cuts.append(len(data) if at < 0 else at)
    cuts.append(len(data))
    files = []
    for i in range(n):
        lo = cuts[i] + (1 if i else 0)
        path = os.path.join(root, f"part-{i:03d}.txt")
        with open(path, "wb") as f:
            f.write(data[lo:cuts[i + 1]])
        files.append(path)
    joined = b"\n".join(open(f, "rb").read() for f in files)
    check(joined == data, "job plane: the files do not rejoin to the corpus")
    return files


class LoopRecorder:
    """Wraps ``Server.loop`` and the example's ``finalfn`` for the
    job-plane phase: the loop's wall, its server (for the device phase's
    timings) and the finalfn seconds of each run."""

    def __init__(self, server_mod, wcmod):
        self.server_mod, self.wcmod = server_mod, wcmod
        self.runs = []

    def __enter__(self):
        rec = self
        self.real_loop = real_loop = self.server_mod.Server.loop
        self.real_final = real_final = self.wcmod.finalfn

        def loop(server):
            t0 = time.monotonic()
            stats = real_loop(server)
            rec.runs.append({"loop_wall_s": time.monotonic() - t0,
                             "server": server, "stats": stats,
                             "finalfn_s": rec.final_s})
            rec.final_s = []
            return stats

        def finalfn(pairs):
            t0 = time.monotonic()
            reply = real_final(pairs)
            rec.final_s.append(time.monotonic() - t0)
            return reply

        self.final_s = []
        self.server_mod.Server.loop = loop
        self.wcmod.finalfn = finalfn
        return self

    def __exit__(self, *exc):
        self.server_mod.Server.loop = self.real_loop
        self.wcmod.finalfn = self.real_final
        return False


def loop_in_thread(server, timeout=JOB_LOOP_TIMEOUT):
    """``server.loop()`` in a thread joined under *timeout*: a loop still
    polling then fails the phase instead of hanging the run."""
    import threading

    box = {}

    def body():
        try:
            box["stats"] = server.loop()
        except BaseException as exc:  # re-raised below
            box["err"] = exc

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout)
    check(not t.is_alive(), f"job plane: Server.loop still running after "
          f"{timeout} s")
    if "err" in box:
        raise box["err"]
    return box["stats"]


class PathInputs:
    """Wraps the kernel wrappers that the job plane's engine calls (the
    segmented reduce and the radix sort through ``ops.segscan``, the
    exchange plan through ``parallel.shuffle``) and keeps a copy of the
    inputs of each one's largest call in the run (one ``clone`` on the
    stream each time a call is larger than any before it; with
    *latest*, also each time one is as large, so the last of the largest
    calls is kept: a session's first fold may route no row to a
    partition, its last ones do).  :func:`hold_path_inputs` then holds
    each kernel against its plain version on exactly those inputs."""

    def __init__(self, torch, seg, shuffle, latest=False):
        self.torch, self.seg, self.shuffle = torch, seg, shuffle
        self.latest = latest
        self.inputs = {}

    def _keep(self, name, n, args):
        have = self.inputs.get(name, (-1, None))[0]
        if n > have or (self.latest and n == have):
            def copy(a):
                if isinstance(a, self.torch.Tensor):
                    return a.clone()
                if isinstance(a, (list, tuple)):
                    return type(a)(copy(x) for x in a)
                return a
            self.inputs[name] = (n, copy(args))

    def __enter__(self):
        seg, shuffle, rec = self.seg, self.shuffle, self
        self.real = (seg.segment_reduce, seg.radix_sort_pairs,
                     shuffle.radix_partition_plan)
        real_seg, real_sort, real_plan = self.real

        def segment_reduce(k1s, k2s, vals_s, op, unit_values):
            rec._keep("segreduce", k1s.numel(),
                      (k1s, k2s, list(vals_s), op, unit_values))
            return real_seg(k1s, k2s, vals_s, op, unit_values)

        def radix_sort_pairs(k1, k2):
            rec._keep("radix_sort", k1.numel(), (k1, k2))
            return real_sort(k1, k2)

        def radix_partition_plan(dest, num_partitions):
            rec._keep("radix_plan", dest.numel(), (dest, num_partitions))
            return real_plan(dest, num_partitions)

        seg.segment_reduce = segment_reduce
        seg.radix_sort_pairs = radix_sort_pairs
        shuffle.radix_partition_plan = radix_partition_plan
        return self

    def __exit__(self, *exc):
        (self.seg.segment_reduce, self.seg.radix_sort_pairs,
         self.shuffle.radix_partition_plan) = self.real
        return False


def hold_path_inputs(torch, seg, rs, label, inputs, need):
    """Each kernel in *need* (``segreduce``, ``radix_sort``,
    ``radix_plan``) against its plain version, bit for bit, on the
    inputs of its largest call in the run (:class:`PathInputs`).  These
    launches come after the run's counts were read, so they are not
    counted as the path's."""
    missing = [k for k in need if k not in inputs]
    check(not missing, f"job plane {label}: no call of {missing} in the run")
    held = {}
    if "segreduce" in need:
        n, (k1s, k2s, vals, op, unit) = inputs["segreduce"]
        got = seg._segment_reduce_cuda(k1s, k2s, vals, op, unit)
        want = seg._segment_reduce_plain(k1s, k2s, vals, op, unit)
        _, _, is_end = seg._run_flags(k1s, k2s)
        check(torch.equal(got[1], want[1]),
              f"job plane {label}: segreduce end_csum differs at n={n}")
        for g, w in zip(got[0], want[0]):
            check(torch.equal(g[is_end], w[is_end]),
                  f"job plane {label}: segreduce lanes differ at run ends "
                  f"at n={n}")
        held["segreduce"] = {"n": n, "lanes": 1 if unit else len(vals),
                             "runs": int(is_end.sum()), "bit_equal": True}
    if "radix_sort" in need:
        n, (k1, k2) = inputs["radix_sort"]
        got = rs._radix_sort_cuda(k1.to(torch.int32).contiguous(),
                                  k2.to(torch.int32).contiguous())
        want = rs._radix_sort_plain(k1.to(torch.int32).contiguous(),
                                    k2.to(torch.int32).contiguous())
        for g, w, lane in zip(got, want, ("k1", "k2", "perm")):
            check(torch.equal(g, w), f"job plane {label}: radix sort {lane} "
                  f"differs from the plain passes at n={n}")
        held["radix_sort"] = {"n": n, "bit_equal": True}
    if "radix_plan" in need:
        n, (dest, parts) = inputs["radix_plan"]
        d2 = (dest[None] if dest.dim() == 1 else dest).to(
            torch.int32).contiguous()
        got = rs._radix_plan_cuda(d2, parts + 1)
        want = rs._radix_plan_plain(d2, parts + 1)
        for g, w, what in zip(got, want, ("rank", "totals")):
            check(torch.equal(g, w), f"job plane {label}: radix plan {what} "
                  f"differs from the plain version at {list(d2.shape)}")
        held["radix_plan"] = {"shape": list(d2.shape),
                              "buckets": parts + 1, "bit_equal": True}
    torch.cuda.synchronize()
    return held


def reset_example(spec, jwc, conf):
    """The example's module state as a fresh process has it: ``init``
    only updates ``_conf``, so one run's init_args (a sort impl) would
    otherwise carry into the next."""
    spec.clear_caches()
    jwc._conf.clear()
    jwc._conf.update(conf)
    jwc.RESULT.clear()


def jobplane_cli_run(torch, kc, seg, rs, shuffle, cli, spec, rec, conf,
                     label, argv, want_str, need, held_need):
    """One ``wordcount --device`` through the CLI in this process; its
    stdout (76K lines) is captured and checked, not printed.  The inputs
    of the largest call of each kernel in *held_need* are kept
    (:class:`PathInputs`) and the kernel held against its plain version
    on them once the run's counts are read."""
    import contextlib
    import hashlib
    import io

    from mapreduce_tpu_torch.obs.metrics import REGISTRY

    reset_example(spec, rec.wcmod, conf)
    decisions0 = REGISTRY.sum("mrtpu_control_decisions_total")
    kc.reset_counts()
    out, err = io.StringIO(), io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            PathInputs(torch, seg, shuffle) as cap:
        rc = cli.main(argv)
    wall = time.monotonic() - t0
    launches = dict(kc.LAUNCHES)
    plain = dict(kc.PLAIN_CALLS)
    check(rc == 0, f"job plane {label}: cli exit {rc}: {err.getvalue()}")
    run = rec.runs[-1]
    got = dict(rec.wcmod.RESULT)
    check(got == want_str, f"job plane {label}: RESULT differs from "
          "Counter over the files' words")
    lines = out.getvalue().splitlines()
    check(len(lines) == len(want_str), f"job plane {label}: {len(lines)} "
          f"stdout lines for {len(want_str)} words")
    top = min(want_str.items(), key=lambda wc: (-wc[1], wc[0]))
    check(lines[0] == f"{top[1]} {top[0]}",
          f"job plane {label}: first line {lines[0]!r}")
    check(all(launches[k] > 0 for k in need),
          f"job plane {label}: a kernel of the path was never launched: "
          f"{launches}")
    check(all(v == 0 for v in plain.values()),
          f"job plane {label}: plain versions ran on the card: {plain}")
    held = hold_path_inputs(torch, seg, rs, label, cap.inputs, held_need)
    del cap
    tm = run["server"]._last_device_timings
    server = run["server"]
    return {"run": label, "loop_wall_s": run["loop_wall_s"],
            "stdout_sha256": hashlib.sha256(
                out.getvalue().encode()).hexdigest(),
            "controllers": {"reclaim": server.reclaim is not None,
                            "autotune": server.autotune is not None},
            "control_decisions": REGISTRY.sum(
                "mrtpu_control_decisions_total") - decisions0,
            "cli_wall_s": wall, "prepare_s": tm["prepare_s"],
            "engine_s": tm["engine_s"], "compute_s": tm["compute_s"],
            "upload_s": tm["upload_s"], "readback_s": tm["readback_s"],
            "first_dispatch_s": tm["first_dispatch_s"],
            "retries": tm["retries"], "waves": tm["waves"],
            "device_result_s": tm["result_s"], "result_write_s":
            tm["write_s"], "finalfn_s": run["finalfn_s"][0],
            "unique": len(got), "launches": {k: launches[k] for k in need},
            "plain_calls": sum(plain.values()), "held": held,
            "summary": err.getvalue().strip().splitlines()[-1]}


def jobplane_phase(torch, kc, seg, rs, data, want, smi):
    """Phase 9: the job plane on the card (the ``jobplane`` lines)."""
    import tempfile
    import uuid

    from mapreduce_tpu_torch import cli, spec
    from mapreduce_tpu_torch import server as server_mod
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.examples import naive
    from mapreduce_tpu_torch.examples import wordcount as jwc
    from mapreduce_tpu_torch.parallel import shuffle
    from mapreduce_tpu_torch.worker import spawn_worker_threads

    # the example's module state before any run (no run has touched it)
    conf = dict(jwc._conf)
    root = tempfile.mkdtemp(prefix="chip_smoke_jobplane_")
    files = write_line_files(data, JOB_FILES, root)
    want_str = {w.decode(): c for w, c in want.items()}
    out = {"card": smi, "files": len(files), "bytes": len(data)}
    with LoopRecorder(server_mod, jwc) as rec:
        # (a) the flagship word count through the framework, with the
        # CLI's controllers on (its default), and once more at P = 1
        # with them off: the same stdout, byte for byte
        base = ["tokenize", "segreduce"]
        for label, extra, need, held_need in (
                ("p1_variadic", [], base, ["segreduce"]),
                ("p1_variadic_no_controllers",
                 ["--no-autotune", "--no-speculative-reclaim"], base,
                 ["segreduce"]),
                ("p8_radix", ["--partitions", str(RADIX_PARTS),
                              "--sort-impl", "radix"],
                 base + ["radix_upfront", "radix_onesweep", "radix_plan"],
                 ["segreduce", "radix_sort", "radix_plan"])):
            line = jobplane_cli_run(
                torch, kc, seg, rs, shuffle, cli, spec, rec, conf, label,
                ["wordcount", *files, "--device", *extra], want_str, need,
                held_need)
            print(json.dumps({"jobplane": line}), flush=True)
            out[label] = line
        on, off = out["p1_variadic"], out["p1_variadic_no_controllers"]
        check(on["controllers"] == {"reclaim": True, "autotune": True}
              and off["controllers"] == {"reclaim": False,
                                         "autotune": False},
              f"job plane: controllers {on['controllers']} / "
              f"{off['controllers']}")
        check(on["stdout_sha256"] == off["stdout_sha256"],
              "job plane: stdout with the controllers on differs from "
              "stdout with them off")
        check(off["control_decisions"] == 0, "job plane: a run without "
              f"controllers recorded {off['control_decisions']} decisions")

        # (b) the device plane against the host plane: a dir: board,
        # shared: storage, 4 worker threads, 4 reducers
        small = make_corpus(JOB_SMALL_WORDS, JOB_SMALL_WORDS // 25, seed=1)
        sroot = tempfile.mkdtemp(prefix="small_", dir=root)
        sfiles = write_line_files(small, 3, sroot)
        oracle = naive.wordcount(sfiles)
        params = {r: JOB_MODULE for r in ("taskfn", "mapfn", "partitionfn",
                                          "reducefn", "finalfn")}
        params["combinerfn"] = JOB_MODULE
        params["init_args"] = {"files": sfiles,
                               "num_reducers": JOB_REDUCERS}
        planes = {}
        for plane in ("host", "device"):
            reset_example(spec, jwc, conf)
            kc.reset_counts()
            connstr = f"dir://{os.path.join(root, plane + '_board')}"
            p = dict(params,
                     storage=f"shared:{os.path.join(root, plane + '_st')}")
            threads = []
            if plane == "device":
                p["device"] = True  # default Partitions(1): the card
            else:
                threads = spawn_worker_threads(connstr, "wc", JOB_WORKERS)
            server = server_mod.Server(connstr, "wc")
            server.configure(p)
            stats = loop_in_thread(server)
            for t in threads:
                t.join(timeout=JOB_LOOP_TIMEOUT)
                check(not t.is_alive(), f"job plane: worker {t.name} did "
                      "not exit")
            check(dict(jwc.RESULT) == oracle, f"job plane {plane} plane: "
                  "RESULT differs from the naive oracle")
            planes[plane] = {"result": dict(jwc.RESULT), "stats": stats,
                             "loop_wall_s": rec.runs[-1]["loop_wall_s"],
                             "launches": dict(kc.LAUNCHES),
                             "plain": dict(kc.PLAIN_CALLS)}
        check(planes["host"]["result"] == planes["device"]["result"],
              "job plane: host and device RESULTs differ")
        hs, ds = planes["host"]["stats"], planes["device"]["stats"]
        check(hs["map"]["count"] == 3 and hs["reduce"]["count"]
              == JOB_REDUCERS, f"job plane: host stats {hs}")
        check({"map", "reduce", "device"} <= set(ds),
              f"job plane: device stats sections {sorted(ds)}")
        check(planes["device"]["launches"]["tokenize"] > 0
              and not any(planes["device"]["plain"].values()),
              f"job plane: device plane launches "
              f"{planes['device']['launches']}, plain calls "
              f"{planes['device']['plain']}")
        line = {"run": "host_vs_device", "words": JOB_SMALL_WORDS,
                "unique": len(oracle), "workers": JOB_WORKERS,
                "reducers": JOB_REDUCERS,
                "host_loop_wall_s": planes["host"]["loop_wall_s"],
                "device_loop_wall_s": planes["device"]["loop_wall_s"],
                "host_map_cpu_s": hs["map"]["sum_cpu_time"],
                "host_reduce_cpu_s": hs["reduce"]["sum_cpu_time"],
                "device_compute_s": ds["device"]["compute_s"],
                "equal": True}
        print(json.dumps({"jobplane": line}), flush=True)
        out["host_vs_device"] = line

        # (c) a two-iteration "loop" on the device plane
        iterations = []
        looping_final = jwc.finalfn

        def loop_once(pairs):
            looping_final(pairs)
            iterations.append(dict(jwc.RESULT))
            return "loop" if len(iterations) < 2 else True

        jwc.finalfn = loop_once
        try:
            reset_example(spec, jwc, conf)
            server = server_mod.Server(f"mem://{uuid.uuid4().hex}", "wc")
            server.configure(dict(params, device=True,
                                  storage=f"mem:{uuid.uuid4().hex}"))
            stats = loop_in_thread(server)
        finally:
            jwc.finalfn = looping_final
        check(iterations == [oracle, oracle],
              f"job plane: loop ran {len(iterations)} iterations")
        check(stats["iteration"] == 2 and server.task.finished(),
              f"job plane: loop ended at iteration {stats['iteration']}")
        line = {"run": "loop", "iterations": len(iterations),
                "loop_wall_s": rec.runs[-1]["loop_wall_s"],
                "finished": True}
        print(json.dumps({"jobplane": line}), flush=True)
        out["loop"] = line
    reset_example(spec, jwc, conf)
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    return out


# -- phase 12: the training plane ---------------------------------------------

#: the phase's device (a CPU rehearsal of the phase sets "cpu")
DEV = "cuda"
#: the digits MLP at the reference width (examples/APRIL-ANN/init.lua:12)
#: and bench_train.bench_mlp's batch and fused epoch
MLP_SIZES = (256, 128, 10)
MLP_BUNCH, MLP_FUSED_STEPS = 128, 100
#: bench_train._timeit's warm-up and timed calls
TIMEIT_WARMUP, TIMEIT_STEPS = 3, 20
#: the transformer's adamw checks: steps of step_opt, S of _train_steps,
#: and the rate (the slice's SGD rate, 1e-3, diverges under Adam's
#: per-element steps: the loss rose from 14.5 to 32 in 4 steps on an
#: NVIDIA H100 80GB HBM3 at 700 W)
ADAMW_STEPS, ADAMW_S, ADAMW_LR = 3, 4, 1e-4


def timeit(torch, step, n=TIMEIT_STEPS):
    """``bench_train._timeit``: seconds per call of *step* over *n* calls
    after TIMEIT_WARMUP, host clock, the last result read back (every
    call depends on the one before it)."""
    for _ in range(TIMEIT_WARMUP):
        out = step()
    out.cpu()
    t0 = time.monotonic()
    for _ in range(n):
        out = step()
    out.cpu()
    return (time.monotonic() - t0) / n


def same_state(torch, a, b):
    """True when every tensor (or numpy array) of the dicts *a* and *b* is
    bit-equal."""
    import numpy as np

    return set(a) == set(b) and all(
        np.array_equal(a[n], b[n]) if isinstance(a[n], np.ndarray)
        else torch.equal(a[n], b[n]) for n in a)


def training_mlp(torch, tmodels):
    """Phase 12 (a): bench_train.bench_mlp's rates at the reference width,
    the captured epoch against eager steps, and fit on the digits."""
    import numpy as np

    cfg = tmodels.TrainConfig(bunch_size=MLP_BUNCH)
    mlp_cfg = tmodels.MLPConfig(sizes=MLP_SIZES)
    tr = tmodels.DistributedTrainer(mlp_cfg, cfg, device=DEV)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(MLP_BUNCH, 256)).astype(np.float32)
    y = (np.arange(MLP_BUNCH) % 10).astype(np.int32)
    xd, yd = tr.place_batch(x, y)
    state = list(tr.init_state())

    def step():
        state[0], state[1], loss = tr.step(state[0], state[1], xd, yd)
        return loss

    step_s = timeit(torch, step)
    S = MLP_FUSED_STEPS
    xs = xd.expand(S, -1, -1).contiguous()
    ys = yd.expand(S, -1).contiguous()

    def epoch():
        # the stacked batch is copied into the graph's slots on the card
        # each call: the device copy bench_mlp makes (JAX donates)
        state[0], state[1], losses = tr._train_epoch(state[0], state[1],
                                                     xs, ys)
        return losses

    t0 = time.monotonic()
    epoch()
    torch.cuda.synchronize()
    capture_s = time.monotonic() - t0
    fused_s = timeit(torch, epoch, n=3) / S
    n_params = sum(t.numel() for t in state[0].values())
    flops = 6.0 * n_params * MLP_BUNCH

    # the captured epoch against S eager steps, on S distinct batches
    xs2 = torch.from_numpy(rng.normal(size=(S, MLP_BUNCH, 256)).astype(
        np.float32)).to(DEV)
    ys2 = torch.from_numpy(rng.integers(0, 10, size=(S, MLP_BUNCH))).to(DEV)
    tr2 = tmodels.DistributedTrainer(mlp_cfg, cfg, device=DEV)
    a, b = tr2.init_state(), tr2.init_state()
    a = tr2._train_epoch(*a, xs2, ys2)
    eager = []
    for i in range(S):
        b = tr2.step(b[0], b[1], xs2[i], ys2[i])
        eager.append(b[2])
    bit_equal = (same_state(torch, a[0], b[0])
                 and same_state(torch, a[1], b[1])
                 and torch.equal(a[2], torch.stack(eager)))
    check(bit_equal, "training: the captured epoch differs from the same "
          f"{S} eager steps")

    # fit on the digits: 800 / 200, bunch 32, 5 epochs
    data = tmodels.make_digits()
    ftr = tmodels.DistributedTrainer(
        mlp_cfg, tmodels.TrainConfig(bunch_size=32, max_epochs=5,
                                     min_epochs=5), device=DEV)
    t0 = time.monotonic()
    fit = ftr.fit(*data)
    fit_s = time.monotonic() - t0
    hist = fit["history"]
    check(len(hist) == 5 and hist[-1]["val_loss"] < hist[0]["val_loss"],
          f"training: fit did not lower the validation loss: {hist}")
    out = {"sizes": MLP_SIZES, "global_batch": MLP_BUNCH,
           "params": n_params, "mlp_train_steps_per_s": 1.0 / step_s,
           "step_s": step_s, "fused_steps_per_s": 1.0 / fused_s,
           "fused_step_s": fused_s, "fused_epoch_steps": S,
           "first_epoch_with_capture_s": capture_s,
           "flops_per_step": flops,
           "mfu": flops / step_s / BF16_FLOPS_PER_S,
           "fused_mfu": flops / fused_s / BF16_FLOPS_PER_S,
           "captured_epoch_bit_equal_to_eager": bit_equal,
           "fit_s": fit_s, "fit_history": hist}
    print(json.dumps({"training_mlp": out}))
    return out


def training_resume(torch, tmodels):
    """Phase 12 (b): fit 3 epochs under a lease into mem: checkpoints; a
    successor acquires (the generation rises), restores step 3 and runs to
    epoch 5; the history equals an uninterrupted run's bit for bit."""
    import dataclasses
    import uuid

    from mapreduce_tpu_torch.coord import Connection, TrainerLease
    from mapreduce_tpu_torch.models.checkpoint import CheckpointManager
    from mapreduce_tpu_torch.obs.metrics import REGISTRY
    from mapreduce_tpu_torch.storage.router import router

    data = tmodels.make_digits()
    mlp_cfg = tmodels.MLPConfig(sizes=MLP_SIZES)
    cfg5 = tmodels.TrainConfig(bunch_size=32, max_epochs=5, min_epochs=1,
                               patience=100)
    cfg3 = dataclasses.replace(cfg5, max_epochs=3)
    board = f"mem://{uuid.uuid4().hex}"
    mgr = CheckpointManager(router(f"mem:{uuid.uuid4().hex}"), keep_n=2)
    pre = TrainerLease(Connection(board, "train"), holder="pre", lease=30.0)
    gen1 = pre.acquire(timeout=10)
    first = tmodels.DistributedTrainer(mlp_cfg, cfg3, device=DEV).fit(
        *data, manager=mgr, lease=pre)
    pre.release()
    suc = TrainerLease(Connection(board, "train"), holder="suc", lease=30.0)
    t0 = time.monotonic()
    gen2 = suc.acquire(timeout=10)
    acquire_s = time.monotonic() - t0
    second = tmodels.DistributedTrainer(mlp_cfg, cfg5, device=DEV).fit(
        *data, manager=mgr, lease=suc)
    resume_s = time.monotonic() - t0
    suc.release()
    check(gen2 > gen1, f"training: generation {gen2} after {gen1}")
    check(second["restored"] and second["start_epoch"] == 4
          and second["epochs_run"] == 2,
          f"training: the successor did not resume at epoch 4: {second}")
    ref = tmodels.DistributedTrainer(mlp_cfg, cfg5, device=DEV).fit(*data)
    resumed = first["history"] + second["history"]
    bit_equal = resumed == ref["history"] and same_state(
        torch, second["params"], ref["params"])
    check(bit_equal, "training: the resumed history differs from an "
          f"uninterrupted run: {resumed} vs {ref['history']}")
    out = {"generations": [gen1, gen2], "checkpoints": mgr.steps(),
           "acquire_s": acquire_s, "resume_to_epoch_5_s": resume_s,
           "trainer_recovery_s": REGISTRY.value(
               "mrtpu_trainer_recovery_seconds"),
           "history_bit_equal": bit_equal, "history": resumed}
    print(json.dumps({"training_resume": out}))
    return out


def training_jobboard(torch, smi):
    """Phase 12 (c): train_digits through the port's Server, two
    in-process workers, 3 "loop" iterations of 4 map jobs."""
    import uuid

    from mapreduce_tpu_torch import spec
    from mapreduce_tpu_torch.examples import train_digits as td
    from mapreduce_tpu_torch.server import Server
    from mapreduce_tpu_torch.worker import spawn_worker_threads

    spec.clear_caches()
    td.HISTORY.clear()
    td._data_cache.clear()
    real_map = td.mapfn
    map_s = []

    def mapfn(key, value, emit):
        t0 = time.monotonic()
        real_map(key, value, emit)  # reads its gradients back: synced
        map_s.append(time.monotonic() - t0)

    mod = "mapreduce_tpu_torch.examples.train_digits"
    params = {r: mod for r in ("taskfn", "mapfn", "partitionfn",
                               "reducefn", "finalfn")}
    params["storage"] = f"mem:{uuid.uuid4().hex}"
    params["init_args"] = {"storage": params["storage"], "n_shards": 4,
                           "bunch_size": 64, "learning_rate": 0.3,
                           "momentum": 0.5, "max_iterations": 3,
                           "device": DEV}
    connstr = f"mem://{uuid.uuid4().hex}"
    td.mapfn = mapfn
    try:
        threads = spawn_worker_threads(connstr, "sgd", 2)
        server = Server(connstr, "sgd")
        server.configure(params)
        t0 = time.monotonic()
        stats = loop_in_thread(server)
        wall = time.monotonic() - t0
        for t in threads:
            t.join(timeout=JOB_LOOP_TIMEOUT)
            check(not t.is_alive(), f"training: worker {t.name} did not exit")
    finally:
        td.mapfn = real_map
        spec.clear_caches()
    hist = list(td.HISTORY)
    check(len(hist) == 3 and stats["iteration"] == 3,
          f"training: train_digits ran {len(hist)} iterations: {hist}")
    check(stats["map"]["count"] == 4 and stats["map"]["failed"] == 0,
          f"training: map jobs {stats['map']}")
    check(hist[-1]["val_loss"] < hist[0]["val_loss"],
          f"training: train_digits' validation loss did not fall: {hist}")
    check(len(map_s) == 12, f"training: {len(map_s)} mapfn calls, not 12")
    out = {"card": smi, "workers": 2, "iterations": 3, "map_jobs": 4,
           "loop_wall_s": wall, "mapfn_s_sum": sum(map_s),
           "mapfn_s_median": statistics.median(map_s),
           "mapfn_share_of_wall": sum(map_s) / wall, "history": hist}
    print(json.dumps({"training_jobboard": out}))
    return out


def update_rel_err(torch, a, b, p0):
    """The largest, over parameters, of ``|a - b|`` over the norm of b's
    update from *p0* (state dicts), and its parameter."""
    errs = {n: float((a[n] - b[n]).norm()
                     / (b[n] - p0[n]).norm().clamp_min(1e-30)) for n in p0}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def training_adamw(torch, kc, tmod, smi):
    """Phase 12 (d): the transformer slice's config with optimizer="adamw":
    step_opt, _train_steps against step_opt, the checkpoint round trip,
    launches, and step walls against device time (SGD beside)."""
    import shutil
    import tempfile

    import numpy as np

    cfg = tmod.TransformerConfig(**TF_CONFIG)
    tr = tmod.TransformerTrainer(cfg, learning_rate=ADAMW_LR, seed=0,
                                 optimizer="adamw", device=DEV)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(ADAMW_S, TF_B, TF_T + 1))
    xs, ys = tr.place_batch(toks)
    params, opt = tr.init_state()
    p0 = {n: t.clone() for n, t in params.state_dict().items()}

    def fresh():
        """The initial state again: p0 and zero moments."""
        p = tmod.Transformer(cfg, device=DEV)
        p.load_state_dict(p0)
        return p, tr._opt_init(p)

    # ADAMW_STEPS step_opt calls, counted (the first is the warm one)
    kc.reset_counts()
    times, losses = [], []
    for i in range(ADAMW_STEPS):
        t0 = time.monotonic()
        params, opt, loss = tr.step_opt(params, opt, toks[i % ADAMW_S])
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        losses.append(float(loss))
    launches = {k: kc.LAUNCHES[k] for k in FLASH_KERNELS}
    plain = dict(kc.PLAIN_CALLS)
    check(all(launches[k] == ADAMW_STEPS * cfg.n_layers
              for k in FLASH_KERNELS),
          f"training: flash launches {launches} over {ADAMW_STEPS} "
          f"step_opt calls, not {cfg.n_layers} a step")
    check(all(v == 0 for v in plain.values()),
          f"training: plain versions ran on the card path: {plain}")
    check(all(math.isfinite(x) for x in losses), f"training: {losses}")
    del params, opt

    # _train_steps (S steps, one graph replay) against S step_opt calls
    a, oa = fresh()
    t0 = time.monotonic()
    a, oa, g_losses = tr._train_steps(a, oa, xs, ys)
    torch.cuda.synchronize()
    capture_s = time.monotonic() - t0
    b, ob = fresh()
    e_losses = []
    for i in range(ADAMW_S):
        b, ob, loss = tr.step_opt(b, ob, toks[i])
        e_losses.append(float(loss))
    sa, sb = a.state_dict(), b.state_dict()
    err, worst = update_rel_err(torch, sa, sb, p0)
    loss_err = max(abs(g - e) / abs(e)
                   for g, e in zip(g_losses.tolist(), e_losses))
    steps_bit_equal = (same_state(torch, sa, sb)
                       and g_losses.tolist() == e_losses)
    check(steps_bit_equal, f"training: _train_steps differs from "
          f"{ADAMW_S} step_opt calls: loss {loss_err}, {worst} {err}")

    # one more replay, counted alone: S launches of each flash kernel a
    # layer, no plain call
    kc.reset_counts()
    a, oa, _ = tr._train_steps(a, oa, xs, ys)
    torch.cuda.synchronize()
    replay_launches = {k: kc.LAUNCHES[k] for k in FLASH_KERNELS}
    replay_plain = dict(kc.PLAIN_CALLS)
    check(all(replay_launches[k] == ADAMW_S * cfg.n_layers
              for k in FLASH_KERNELS),
          f"training: one replay of the captured steps launched "
          f"{replay_launches}")
    check(all(v == 0 for v in replay_plain.values()),
          f"training: plain versions ran in the replay: {replay_plain}")

    # save -> load_state -> the next step, against the step without it
    root = tempfile.mkdtemp(prefix="chip_smoke_adamw_")
    try:
        t0 = time.monotonic()
        tr.save(root, b, step=ADAMW_S, opt_state=ob)
        save_s = time.monotonic() - t0
        t0 = time.monotonic()
        rb, rob, rstep = tr.load_state(root)
        load_s = time.monotonic() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(rstep == ADAMW_S and same_state(torch, rb.state_dict(), sb)
          and same_state(torch, tmod.adamw_state_to_numpy(rb, rob),
                         tmod.adamw_state_to_numpy(b, ob)),
          "training: load_state did not give back the saved state")
    nxt = toks[0]
    sb0 = {n: t.clone() for n, t in sb.items()}
    b, ob, l1 = tr.step_opt(b, ob, nxt)
    rb, rob, l2 = tr.step_opt(rb, rob, nxt)
    rt_err, rt_worst = update_rel_err(torch, rb.state_dict(),
                                      b.state_dict(), sb0)
    rt_loss_err = abs(float(l1) - float(l2)) / abs(float(l1))
    check(float(l1) == float(l2)
          and same_state(torch, rb.state_dict(), b.state_dict()),
          f"training: the step after the round trip differs: loss "
          f"{rt_loss_err}, {rt_worst} {rt_err}")
    del rb, rob, b, ob, sb, sb0

    # step walls (host clock to synchronize) against device time:
    # eager step_opt, and the captured steps a replay; SGD beside
    def replay_wall(fn):
        walls = []
        for _ in range(3):
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            walls.append((time.monotonic() - t0) / ADAMW_S)
        return statistics.median(walls)

    def events_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / ADAMW_S

    state = {"p": a, "o": oa}

    def adamw_steps():
        state["p"], state["o"], _ = tr._train_steps(state["p"], state["o"],
                                                    xs, ys)

    def adamw_eager():
        state["p"], state["o"], _ = tr.step_opt(state["p"], state["o"],
                                                toks[0])

    walls = {"adamw_captured_step_s": replay_wall(adamw_steps),
             "adamw_captured_replay_device_ms": events_ms(adamw_steps),
             "adamw_eager_step_s": statistics.median(
                 [timeit_wall(torch, adamw_eager) for _ in range(3)])}
    groups, _ = device_profile(torch, "profile_transformer_adamw",
                               adamw_eager, _tf_group)
    walls["adamw_eager_device_ms"] = sum(groups.values()) / 1e3
    del state, a, oa
    tr._graph = None

    sgd = tmod.TransformerTrainer(cfg, learning_rate=TF_LR, seed=0,
                                  device=DEV)
    sstate = {"p": sgd.init_params()}

    def sgd_steps():
        sstate["p"], _ = sgd._train_steps(sstate["p"], None, xs, ys)

    def sgd_eager():
        sstate["p"], _ = sgd.step(sstate["p"], toks[0])

    sgd_eager()
    sgd_steps()  # capture
    walls.update({
        "sgd_captured_step_s": replay_wall(sgd_steps),
        "sgd_captured_replay_device_ms": events_ms(sgd_steps),
        "sgd_eager_step_s": statistics.median(
            [timeit_wall(torch, sgd_eager) for _ in range(3)])})
    groups, _ = device_profile(torch, "profile_transformer_sgd", sgd_eager,
                               _tf_group)
    walls["sgd_eager_device_ms"] = sum(groups.values()) / 1e3
    del sstate, sgd
    out = {"card": smi, "config": TF_CONFIG, "batch": TF_B, "seq_len": TF_T,
           "adamw": dict(tmod.ADAMW, lr=ADAMW_LR),
           "step_opt_losses": losses,
           "step_opt_s": times, "launches": launches, "plain_calls": plain,
           "train_steps_S": ADAMW_S, "first_train_steps_with_capture_s":
           capture_s, "replay_launches": replay_launches,
           "replay_plain_calls": replay_plain,
           "train_steps_losses": g_losses.tolist(),
           "step_opt_losses_same_batches": e_losses,
           "train_steps_loss_rel_err": loss_err,
           "train_steps_update_rel_err_max": err,
           "train_steps_update_rel_err_worst": worst,
           "train_steps_bit_equal": steps_bit_equal,
           "save_s": save_s, "load_state_s": load_s,
           "round_trip_next_step_loss_rel_err": rt_loss_err,
           "round_trip_next_step_update_rel_err_max": rt_err,
           "walls": walls}
    print(json.dumps({"training_adamw": out}))
    return out


def timeit_wall(torch, fn):
    """Seconds of one call of *fn*, host clock to synchronize."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    return time.monotonic() - t0


def training_phase(torch, kc, tmod, smi):
    """Phase 12: the training plane (the ``training_*`` lines)."""
    from mapreduce_tpu_torch import models as tmodels

    training_mlp(torch, tmodels)
    training_resume(torch, tmodels)
    jobboard = training_jobboard(torch, smi)
    training_adamw(torch, kc, tmod, smi)
    return jobboard


# -- phase 13: the networked job plane ------------------------------------------

#: seconds a process of the netplane phase may take before the phase fails
NET_TIMEOUT = 300
#: the split-module example the README's topology names role by role
SPLIT_MODULE = "mapreduce_tpu_torch.examples.wordcount_split"
#: worker processes of (b) and (d); threads in each process of (b)
NET_PROCS = 2
NET_THREADS = 2
#: telemetry push period of every process of the phase, seconds
NET_PUSH_S = 0.5


class NetProcs:
    """The phase's subprocesses (``python -m mapreduce_tpu_torch.cli``),
    their output in files (a pipe nobody reads could fill and stall a
    process), each waited on with a timeout and killed after it."""

    def __init__(self, root, token, label="netplane"):
        here = os.path.dirname(os.path.abspath(__file__))
        self.root = root
        self.label = label
        self.env = dict(os.environ, MAPREDUCE_TPU_AUTH=token,
                        PYTHONPATH=here + os.pathsep
                        + os.environ.get("PYTHONPATH", ""))
        self.procs = {}

    def start(self, name, *args):
        out = open(os.path.join(self.root, f"{name}.out"), "w")
        err = open(os.path.join(self.root, f"{name}.err"), "w")
        p = subprocess.Popen(
            [sys.executable, "-m", "mapreduce_tpu_torch.cli", *args],
            env=self.env, stdout=out, stderr=err, text=True)
        out.close()
        err.close()
        self.procs[name] = p
        return p

    def text(self, name, stream="out"):
        with open(os.path.join(self.root, f"{name}.{stream}")) as f:
            return f.read()

    def wait_line(self, name, pattern, timeout=120):
        """The first match of *pattern* in *name*'s stdout."""
        p = self.procs[name]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            m = re.search(pattern, self.text(name))
            if m:
                return m
            check(p.poll() is None, f"{self.label}: {name} exited "
                  f"{p.returncode}: {self.text(name, 'err')[-2000:]}")
            time.sleep(0.05)
        check(False, f"{self.label}: no {pattern!r} from {name} in "
              f"{timeout} s")

    def wait(self, name, timeout=NET_TIMEOUT):
        """Wait for *name* to exit 0; a timeout or another code fails."""
        p = self.procs[name]
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=30)
            check(False, f"{self.label}: {name} still running after "
                  f"{timeout} s")
        check(p.returncode == 0, f"{self.label}: {name} exited "
              f"{p.returncode}: {self.text(name, 'err')[-2000:]}")

    def reap(self):
        """Stop every process still running (the servers), under a
        timeout each."""
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=30)


def net_status(url, token=None):
    """HTTP status of a GET of *url* (with the bearer token, if any)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, headers=(
        {"Authorization": f"Bearer {token}"} if token else {}))
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as exc:
        return exc.code


def wait_pushers(client, prefixes, timeout=120):
    """Wait until a process whose telemetry role starts with each of
    *prefixes* has pushed to the board's collector: the worker processes
    are up and polling."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        roles = [p["role"] for p in
                 client.clusterz()["mrtpuCluster"]["procs"].values()]
        if all(any(r.startswith(p) for r in roles) for p in prefixes):
            return
        time.sleep(0.1)
    check(False, f"netplane: workers {sorted(prefixes)} never pushed "
          f"telemetry in {timeout} s")


def blob_bytes(REGISTRY):
    """This process's blob-plane bytes: raw and on the wire, a
    direction."""
    return {f"{d}_{kind}": sum(
        REGISTRY.value(f"mrtpu_blob_{kind}_bytes_total", direction=d,
                       encoding=e) for e in ("gzip", "identity"))
        for d in ("put", "get") for kind in ("raw", "wire")}


def rpc_count(client):
    """Board RPCs the docserver has served so far (/metrics)."""
    from mapreduce_tpu_torch.obs.metrics import parse_prometheus

    return sum(v for (name, _), v in parse_prometheus(
        client.metrics_text()).items()
        if name == "mrtpu_docserver_requests_total")


def proc_jobs(docs, proc):
    """The jobs in *docs* that a thread of worker process *proc* ran
    (threads are named ``proc`` or ``proc-N``)."""
    return [d for d in docs if str(d.get("worker", "")) == proc
            or str(d.get("worker", "")).startswith(proc + "-")]


def map_split(docs, spawned, part):
    """Map jobs a worker process ran; fails unless every process in
    *spawned* ran at least one, so the run really had two processes at
    work."""
    split = {p: len(proc_jobs(docs, p)) for p in spawned}
    check(all(split.values()) and sum(split.values()) == len(docs),
          f"netplane ({part}): map jobs by process {split} of "
          f"{len(docs)}: a worker process ran none")
    return split


def first_claims(docs, spawned):
    """Each worker process's first-claim delay: its earliest job's
    ``started_time`` (the claim) less the earliest job's
    ``creation_time`` (the moment the task became claimable; both wall
    clock, one host), and its first job's run time beside the median of
    its later ones (the first carries the process's start-up on the
    card, the later ones do not)."""
    t_open = min(d["creation_time"] for d in docs)
    out = {}
    for name in spawned:
        mine = sorted(proc_jobs(docs, name), key=lambda d: d["started_time"])
        if not mine:
            out[name] = None
            continue
        later = sorted(d["real_time"] for d in mine[1:])
        out[name] = {
            "claim_s": mine[0]["started_time"] - t_open,
            "first_run_s": mine[0]["real_time"],
            "later_run_median_s": (later[len(later) // 2] if later
                                   else None)}
    return out


def netplane_split(procs, client, board, blob, token, data_small, root):
    """Phase 13 (b): the README's topology, two ``cli worker`` processes
    of NET_THREADS threads and a ``cli server`` with the split-module
    example over http:// and http:, on phase 9 (b)'s input."""
    from mapreduce_tpu_torch.examples import naive
    from mapreduce_tpu_torch.storage.httpstore import HttpStorage
    from mapreduce_tpu_torch.utils.serialization import parse_record

    files = write_line_files(data_small, 3, root)
    oracle = naive.wordcount(files)
    connstr, dsl = f"http://{board}", f"http:{blob}"
    spawned = [f"p{i}" for i in range(NET_PROCS)]
    for i in range(NET_PROCS):
        procs.start(f"split_worker{i}", "worker", connstr, "splitwc",
                    "--workers", str(NET_THREADS), "--name", f"p{i}",
                    "--max-iter", "400", "--max-sleep", "0.2",
                    "--claim-batch", "1", "--no-claim-ahead",
                    "--telemetry-interval", str(NET_PUSH_S))
    wait_pushers(client, [f"worker:p{i}-" for i in range(NET_PROCS)])
    rpcs0 = rpc_count(client)
    m = SPLIT_MODULE
    t0 = time.monotonic()
    procs.start("split_server", "server", connstr, "splitwc",
                f"{m}.taskfn", f"{m}.mapfn", f"{m}.partitionfn",
                f"{m}.reducefn", f"{m}.finalfn", f"{m}.reducefn", dsl,
                "--init-args", json.dumps({
                    "files": files, "num_reducers": JOB_REDUCERS,
                    "keep_results": True}),
                "--telemetry-interval", str(NET_PUSH_S))
    procs.wait("split_server")
    wall = time.monotonic() - t0
    for i in range(NET_PROCS):
        procs.wait(f"split_worker{i}")
    rpcs = rpc_count(client) - rpcs0
    # the blob plane's bytes of every process of the run, as they pushed
    # them (each process flushes once more as it exits)
    moved, decisions = Counter(), Counter()
    for name, labels, value in client.clusterz()["mrtpuCluster"]["metrics"]:
        if name.startswith("mrtpu_blob_"):
            kind = name.split("_")[2]  # raw | wire
            moved[f"{labels['direction']}_{kind}_{labels['encoding']}"] += value
        elif name == "mrtpu_control_decisions_total":
            # the server process runs the CLI's controllers (default on)
            decisions[f"{labels['controller']}/{labels['outcome']}"] += \
                value
    # no worker straggles here: the re-claimer must not have acted
    check(not any(k.startswith("reclaim/") for k in decisions),
          f"netplane (b): re-claim decisions without a straggler: "
          f"{dict(decisions)}")
    stats = json.loads(procs.text("split_server").strip().splitlines()[-1])
    st = HttpStorage(blob, auth_token=token)
    got = {}
    names = st.list(r"^splitwc\.result\.P\d+$")
    for name in names:
        for line in st.open_lines(name):
            key, values = parse_record(line)
            got[key] = values[0]
    check(got == oracle, "netplane (b): the result read back from the "
          "blob server differs from Counter over the files' words")
    map_docs = client.find("splitwc.map_jobs")
    docs = map_docs + client.find("splitwc.red_jobs")
    ran = Counter(d["worker"] for d in docs)
    maps_by_proc = map_split(map_docs, spawned, "b")
    n_jobs = stats["map"]["count"] + stats["reduce"]["count"]
    # drop: the task's collections and its storage, through the CLI
    procs.start("split_drop", "drop", connstr, "splitwc", "--storage", dsl)
    procs.wait("split_drop", timeout=120)
    check(not [c for c in client.collections()
               if c.startswith("splitwc.")] and not st.list(),
          "netplane (b): cli drop left collections or blobs")
    st.close()
    return {"run": "split_processes", "words": JOB_SMALL_WORDS,
            "unique": len(oracle), "worker_procs": NET_PROCS,
            "threads_per_proc": NET_THREADS, "reducers": JOB_REDUCERS,
            "server_cli_wall_s": wall, "map_jobs": stats["map"]["count"],
            "reduce_jobs": stats["reduce"]["count"],
            "board_rpcs": rpcs, "rpcs_per_job": rpcs / n_jobs,
            "control_decisions": dict(decisions),
            "blob_bytes": dict(moved),
            "jobs_by_worker": dict(ran), "map_jobs_by_proc": maps_by_proc,
            "result_blobs": len(names),
            "first_claim": first_claims(map_docs, spawned),
            "equal": True}, ran


def netplane_device(torch, kc, seg, rs, shuffle, spec, jwc, conf, files,
                    board, blob, token, root, jobplane, REGISTRY,
                    Partitions, Server):
    """Phase 13 (c): the device phase through ``Server(http://...)`` on
    phase 9's 24 files, P = 1 variadic and P = 8 radix, against the same
    run on a dir: board with shared: storage; result bytes compared,
    kernels counted and held against their plain versions."""
    base = ["tokenize", "segreduce"]
    lines, launches = {}, {}
    for label, parts, sort_impl, need, held_need in (
            ("p1_variadic", lambda: Partitions(1), None, base,
             ["segreduce"]),
            ("p8_radix", lambda: Partitions(RADIX_PARTS, "cuda"), "radix",
             base + ["radix_upfront", "radix_onesweep", "radix_plan"],
             ["segreduce", "radix_sort", "radix_plan"])):
        runs = {}
        for plane in ("dir", "http"):
            reset_example(spec, jwc, conf)
            if plane == "http":
                connstr, dsl = f"http://{board}", f"http:{blob}"
            else:
                connstr = f"dir://{os.path.join(root, label + '_board')}"
                dsl = f"shared:{os.path.join(root, label + '_st')}"
            init = {"files": files, "num_reducers": 15}
            if sort_impl:
                init["device_sort_impl"] = sort_impl
            params = {r: JOB_MODULE for r in ("taskfn", "mapfn",
                                              "partitionfn", "reducefn",
                                              "finalfn")}
            params.update(combinerfn=JOB_MODULE, storage=dsl,
                          init_args=init, device=True,
                          partitions=parts())
            got, final_s = {}, []
            real_final = jwc.finalfn

            def finalfn(pairs, dsl=dsl):
                from mapreduce_tpu_torch.storage.router import router

                st = router(dsl, auth=token)  # untimed: the comparison's
                got.update({n: st.read_bytes(n) for n in st.list(
                    r"^netwc\.result\.P\d+$")})
                t0 = time.monotonic()
                reply = real_final(pairs)
                final_s.append(time.monotonic() - t0)
                return reply

            jwc.finalfn = finalfn
            try:
                server = Server(connstr, "netwc", auth=token)
                server.telemetry_interval = (NET_PUSH_S if plane == "http"
                                             else 0.0)
                server.configure(params)
                before = blob_bytes(REGISTRY)
                kc.reset_counts()
                t0 = time.monotonic()
                if plane == "http":
                    with PathInputs(torch, seg, shuffle) as cap:
                        loop_in_thread(server)
                else:
                    loop_in_thread(server)
                wall = time.monotonic() - t0
            finally:
                jwc.finalfn = real_final
            counted = dict(kc.LAUNCHES)
            plain = dict(kc.PLAIN_CALLS)
            after = blob_bytes(REGISTRY)
            check(dict(jwc.RESULT) == jobplane["want_str"],
                  f"netplane (c) {label} {plane}: RESULT differs from "
                  "Counter over the files' words")
            check(list(got) == ["netwc.result.P00000"],
                  f"netplane (c) {label} {plane}: result blobs {list(got)}")
            runs[plane] = {"wall": wall, "final_s": final_s[0],
                           "tm": server._last_device_timings,
                           "bytes": got, "launches": counted,
                           "plain": plain,
                           "blob": {k: after[k] - before[k] for k in after}}
        h, d = runs["http"], runs["dir"]
        check(h["bytes"] == d["bytes"], f"netplane (c) {label}: the "
              "http: result.P00000 differs from the dir: run's")
        check(all(h["launches"][k] > 0 for k in need),
              f"netplane (c) {label}: a kernel of the path was never "
              f"launched: {h['launches']}")
        check(not any(h["plain"].values()),
              f"netplane (c) {label}: plain versions ran: {h['plain']}")
        held = hold_path_inputs(torch, seg, rs, f"netplane {label}",
                                cap.inputs, held_need)
        del cap
        launches[label] = {k: h["launches"][k] for k in need}
        p9 = jobplane[label]
        line = {"run": f"device_{label}", "result_bytes":
                len(h["bytes"]["netwc.result.P00000"]), "byte_equal": True,
                "loop_wall_s": {"http": h["wall"], "dir": d["wall"],
                                "phase9_cli_mem": p9["loop_wall_s"]},
                "prepare_s": {"http": h["tm"]["prepare_s"],
                              "dir": d["tm"]["prepare_s"],
                              "phase9": p9["prepare_s"]},
                "engine_s": {"http": h["tm"]["engine_s"],
                             "dir": d["tm"]["engine_s"],
                             "phase9": p9["engine_s"]},
                "device_result_s": {"http": h["tm"]["result_s"],
                                    "dir": d["tm"]["result_s"],
                                    "phase9": p9["device_result_s"]},
                "result_write_s": {"http_put": h["tm"]["write_s"],
                                   "dir": d["tm"]["write_s"],
                                   "phase9": p9["result_write_s"]},
                "finalfn_s": {"http_get": h["final_s"],
                              "dir": d["final_s"],
                              "phase9": p9["finalfn_s"]},
                "blob_bytes": h["blob"], "launches": launches[label],
                "plain_calls": 0, "held": held}
        print(json.dumps({"netplane": line}), flush=True)
        lines[label] = line
    reset_example(spec, jwc, conf)
    return lines, launches


STARTUP_PROBE = r"""
import json, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t2 = time.perf_counter()
from mapreduce_tpu_torch.models import mlp
from mapreduce_tpu_torch.models.digits import make_digits
t3 = time.perf_counter()
x_tr, y_tr, _, _ = make_digits(seed=0)
t4 = time.perf_counter()
cfg = mlp.MLPConfig(sizes=(256, 128, 10))
params = {k: v.requires_grad_() for k, v in mlp.init_params(
    cfg, torch.Generator().manual_seed(0), device="cuda").items()}
x = torch.from_numpy(x_tr[:64]).to("cuda")
y = torch.from_numpy(y_tr[:64]).to("cuda")
grads_s = []
for _ in range(3):
    t = time.perf_counter()
    loss = mlp.nll_loss(params, x, y, cfg)
    grads = torch.autograd.grad(loss, list(params.values()))
    [g.cpu() for g in grads]
    grads_s.append(time.perf_counter() - t)
print(json.dumps({"import_torch_s": t1 - t0, "cuda_init_s": t2 - t1,
                  "import_port_s": t3 - t2, "make_digits_s": t4 - t3,
                  "grads_s": grads_s}))
"""


def startup_probe(n):
    """A fresh process's start-up on the card, in the steps of a
    ``train_digits`` worker's first ``mapfn`` (import torch, the CUDA
    context, the port's modules, the data, three gradient calls): *n*
    such processes at once, each under a timeout."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    ps = [subprocess.Popen([sys.executable, "-c", STARTUP_PROBE], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True) for _ in range(n)]
    out = []
    for p in ps:
        try:
            so, se = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in ps:
                q.kill()
                q.communicate(timeout=30)
            check(False, "netplane (d): the start-up probe ran over 120 s")
        check(p.returncode == 0, f"netplane (d): the start-up probe exited "
              f"{p.returncode}: {se[-2000:]}")
        out.append(json.loads(so.strip().splitlines()[-1]))
    return out


def netplane_train(procs, client, board, blob, token, jobboard, Server):
    """Phase 13 (d): train_digits with the MLP's gradients computed in
    NET_PROCS ``cli worker`` processes on the card, at phase 12 (c)'s
    shards, bunch, seed and iterations; the history against phase 12's
    worker threads."""
    from mapreduce_tpu_torch import spec
    from mapreduce_tpu_torch.examples import train_digits as td

    spec.clear_caches()
    td.HISTORY.clear()
    td._data_cache.clear()
    connstr, dsl = f"http://{board}", f"http:{blob}"
    mod = "mapreduce_tpu_torch.examples.train_digits"
    params = {r: mod for r in ("taskfn", "mapfn", "partitionfn",
                               "reducefn", "finalfn")}
    params["storage"] = dsl
    params["init_args"] = {"storage": dsl, "n_shards": 4,
                           "bunch_size": 64, "learning_rate": 0.3,
                           "momentum": 0.5, "max_iterations": 3,
                           "device": DEV}
    spawned = [f"d{i}" for i in range(NET_PROCS)]
    for i in range(NET_PROCS):
        procs.start(f"train_worker{i}", "worker", connstr, "sgdnet",
                    "--name", f"d{i}", "--max-iter", "400",
                    "--max-sleep", "0.2", "--claim-batch", "1",
                    "--no-claim-ahead", "--telemetry-interval",
                    str(NET_PUSH_S))
    wait_pushers(client, [f"worker:d{i}" for i in range(NET_PROCS)])
    docs = {"map": [], "reduce": []}
    real_final = td.finalfn

    def finalfn(pairs):
        # this iteration's jobs, before "loop" drops them
        docs["map"].extend(client.find("sgdnet.map_jobs"))
        docs["reduce"].extend(client.find("sgdnet.red_jobs"))
        return real_final(pairs)

    td.finalfn = finalfn
    try:
        server = Server(connstr, "sgdnet", auth=token)
        server.telemetry_interval = NET_PUSH_S
        server.configure(params)
        t0 = time.monotonic()
        stats = loop_in_thread(server)
        wall = time.monotonic() - t0
    finally:
        td.finalfn = real_final
        spec.clear_caches()
    for i in range(NET_PROCS):
        procs.wait(f"train_worker{i}")
    hist = list(td.HISTORY)
    check(stats["iteration"] == 3 and stats["map"]["failed"] == 0,
          f"netplane (d): stats {stats}")
    all_docs = docs["map"] + docs["reduce"]
    ran = Counter(d["worker"] for d in all_docs)
    check(len(docs["map"]) == 12 and set(ran) <= set(spawned),
          f"netplane (d): jobs by worker {dict(ran)}")
    maps_by_proc = map_split(docs["map"], spawned, "d")
    threads_hist = jobboard["history"]
    equal = hist == threads_hist
    worst = max(abs(a[k] - b[k]) for a, b in zip(hist, threads_hist)
                for k in a)
    check(equal, f"netplane (d): the history with worker processes "
          f"differs from phase 12's with threads (max |diff| {worst}): "
          f"{hist} vs {threads_hist}")
    return {"run": "train_digits_processes", "worker_procs": NET_PROCS,
            "iterations": 3, "map_jobs": len(docs["map"]),
            "reduce_jobs": len(docs["reduce"]),
            "loop_wall_s": wall,
            "phase12_threads_loop_wall_s": jobboard["loop_wall_s"],
            "jobs_by_worker": dict(ran), "map_jobs_by_proc": maps_by_proc,
            "first_claim": first_claims(docs["map"], spawned),
            "startup_probe": {"alone": startup_probe(1),
                              "two_at_once": startup_probe(NET_PROCS)},
            "history_bit_equal": equal, "history": hist}, ran


def netplane_phase(torch, kc, seg, rs, data, want, smi, jobplane,
                   jobboard):
    """Phase 13: the networked job plane (the ``netplane`` lines)."""
    import shutil
    import tempfile
    import uuid

    from mapreduce_tpu_torch import spec
    from mapreduce_tpu_torch.coord.docserver import HttpDocStore
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.examples import wordcount as jwc
    from mapreduce_tpu_torch.obs.metrics import REGISTRY, parse_prometheus
    from mapreduce_tpu_torch.parallel import shuffle
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.server import Server

    conf = {"files": [], "num_reducers": 15}
    token = uuid.uuid4().hex
    root = tempfile.mkdtemp(prefix="chip_smoke_netplane_")
    procs = NetProcs(root, token)
    t_phase = time.monotonic()
    try:
        # (a) the board and the blob service, under MAPREDUCE_TPU_AUTH
        procs.start("docserver", "docserver", "--host", "127.0.0.1",
                    "--port", "0")
        procs.start("blobserver", "blobserver",
                    os.path.join(root, "blobs"), "--host", "127.0.0.1",
                    "--port", "0")
        board = procs.wait_line("docserver",
                                r"job board at http://([\d.]+:\d+)").group(1)
        blob = procs.wait_line("blobserver",
                               r"at http:([\d.]+:\d+)").group(1)
        tokenless = {"board_metrics": net_status(f"http://{board}/metrics"),
                     "board_healthz": net_status(f"http://{board}/healthz"),
                     "blob_list": net_status(f"http://{blob}/list")}
        check(tokenless == {"board_metrics": 401, "board_healthz": 200,
                            "blob_list": 401},
              f"netplane (a): tokenless requests answered {tokenless}")
        check(net_status(f"http://{board}/metrics", token) == 200,
              "netplane (a): the token is refused")
        client = HttpDocStore(board, auth_token=token)
        print(json.dumps({"netplane": {"run": "servers", "board": board,
                                       "blob": blob, "tokenless": tokenless,
                                       "card": smi}}), flush=True)

        # (b) the README's topology on phase 9 (b)'s 200K words
        small = make_corpus(JOB_SMALL_WORDS, JOB_SMALL_WORDS // 25, seed=1)
        sroot = tempfile.mkdtemp(prefix="small_", dir=root)
        split_line, split_ran = netplane_split(procs, client, board, blob,
                                               token, small, sroot)
        print(json.dumps({"netplane": split_line}), flush=True)

        # (c) the device phase over http:// and http: storage
        jobplane = dict(jobplane, want_str={w.decode(): c
                                            for w, c in want.items()})
        files = write_line_files(data, JOB_FILES,
                                 tempfile.mkdtemp(prefix="big_", dir=root))
        device_lines, launches = netplane_device(
            torch, kc, seg, rs, shuffle, spec, jwc, conf, files, board,
            blob, token, root, jobplane, REGISTRY, Partitions, Server)

        # (d) train_digits with its gradients in worker processes
        train_line, train_ran = netplane_train(procs, client, board, blob,
                                               token, jobboard, Server)
        print(json.dumps({"netplane": train_line}), flush=True)

        # (e) the board's exposition: every worker process's jobs and
        # the in-process server's spans reached it
        time.sleep(2 * NET_PUSH_S)
        metrics = parse_prometheus(client.metrics_text())
        device_job = ("mrtpu_board_jobs", (("db", "netwc"), ("phase", "map"),
                                           ("status", "WRITTEN")))
        check(metrics.get(device_job) == 1
              and any(n == "mrtpu_docserver_requests_total"
                      for n, _ in metrics),
              "netplane (e): /metrics lacks the board gauge of the device "
              "job or the docserver's request counters")
        cz = client.clusterz()
        pushed = Counter()
        for name, labels, value in cz["mrtpuCluster"]["metrics"]:
            if name == "mrtpu_worker_jobs_total":
                pushed[(labels["task"], labels["worker"])] += value
        want_jobs = Counter({("splitwc", w): n
                             for w, n in split_ran.items()})
        want_jobs.update({("sgdnet", w): n for w, n in train_ran.items()})
        got_jobs = Counter({k: v for k, v in pushed.items()
                            if k[0] in ("splitwc", "sgdnet")})
        check(got_jobs == want_jobs, f"netplane (e): /clusterz worker jobs "
              f"{dict(got_jobs)} against the board's {dict(want_jobs)}")
        roles = Counter(p["role"].split(":")[0]
                        for p in cz["mrtpuCluster"]["procs"].values())
        server_spans = Counter(
            e["name"] for e in cz["traceEvents"]
            if e.get("args", {}).get("job") == "__device__")
        check(server_spans["job"] >= 2 and server_spans["write"] >= 2,
              f"netplane (e): the server's device spans on /clusterz: "
              f"{dict(server_spans)}")
        rpc_spans = sum(1 for e in cz["traceEvents"]
                        if str(e.get("name", "")).startswith("rpc:"))
        client.close()
        line = {"run": "exposition", "roles": dict(roles),
                "worker_jobs": {f"{t}/{w}": n
                                for (t, w), n in sorted(got_jobs.items())},
                "server_device_spans": dict(server_spans),
                "board_rpc_spans": rpc_spans,
                "trace_events": len(cz["traceEvents"]),
                "metric_series": len(metrics),
                "phase_s": time.monotonic() - t_phase, "card": smi}
        print(json.dumps({"netplane": line}), flush=True)
    finally:
        # (f) every process reaped under a timeout
        procs.reap()
    shutil.rmtree(root, ignore_errors=True)
    return launches


# -- phase 14: the always-on service --------------------------------------------

#: the board-primary lease of the phase's HA pairs, seconds
SERVICE_LEASE = 1.0
#: seconds a task of the phase may take to reach DONE before it fails
SERVICE_TIMEOUT = 180
#: the two tenants and the sort each one's task asks for
SERVICE_TENANTS = (("alpha", "radix"), ("beta", "variadic"))
SERVICE_KERNELS = ("tokenize", "segreduce", "radix_plan", "radix_upfront",
                   "radix_onesweep")
#: the phase's device (a CPU rehearsal of the phase sets "cpu")
SERVICE_DEV = "cuda"


def service_failover():
    """Phase 14 (a): bench.py's measure_failover on the port: two
    in-process docservers over one HA directory; the primary is made
    dead to clients with its lease unreleased (its HA loop stopped, its
    validity horizon zeroed, its listener closed), and the clock runs to
    the first mutation the promoted standby acknowledges, through one
    multi-endpoint client carrying one rid across the rotation."""
    import shutil
    import tempfile

    from mapreduce_tpu_torch.coord.docserver import DocServer, HttpDocStore

    td = tempfile.mkdtemp(prefix="chip_smoke_ha_")
    a = DocServer(ha_dir=td, ha_lease=SERVICE_LEASE).start_background()
    b = DocServer(ha_dir=td, ha_lease=SERVICE_LEASE).start_background()
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
                a.ha.is_primary() or b.ha.is_primary()):
            time.sleep(0.01)
        check(a.ha.is_primary() or b.ha.is_primary(),
              "service (a): no replica became primary")
        prim, stby = (a, b) if a.ha.is_primary() else (b, a)
        cli = HttpDocStore(f"{a.host}:{a.port},{b.host}:{b.port}")
        try:
            cli.insert("bench.docs", {"_id": "x", "v": 0})
            cli.update("bench.docs", {"_id": "x"}, {"$inc": {"v": 1}})
            t0 = time.monotonic()
            prim.ha._stop.set()
            prim.ha._thread.join(timeout=10)
            prim.ha._valid_until = 0.0
            prim.httpd.shutdown()
            prim.httpd.server_close()
            n = cli.update("bench.docs", {"_id": "x"}, {"$inc": {"v": 1}})
            failover_s = time.monotonic() - t0
            check(n == 1 and stby.ha.is_primary(),
                  f"service (a): n {n}, standby {stby.ha.role}")
            v = cli.find_one("bench.docs", {"_id": "x"})["v"]
            check(v == 2, f"service (a): v {v} after the failover (not "
                  "exactly once)")
        finally:
            cli.close()
    finally:
        for srv in (a, b):
            try:
                srv.shutdown()
            except Exception:
                pass
        shutil.rmtree(td, ignore_errors=True)
    return {"run": "failover", "board_failover_s": failover_s,
            "board_failover_lease_s": SERVICE_LEASE, "n": n, "v": v,
            "exactly_once": True}


def service_params(files, impl, storage):
    """A submitted device task's params, as ``cli submit --device``
    stores them: phase 9's files through examples/wordcount, the sort in
    the task's own init_args, the result kept in storage."""
    params = {r: JOB_MODULE for r in ("taskfn", "mapfn", "partitionfn",
                                      "reducefn", "finalfn")}
    params.update(storage=storage, device=True, init_args={
        "files": files, "num_reducers": 15, "device_sort_impl": impl,
        "keep_results": True})
    return params


def result_bytes(storage_root, db):
    with open(os.path.join(storage_root, f"{db}.result.P00000"),
              "rb") as f:
        return f.read()


def result_counts(raw):
    from mapreduce_tpu_torch.utils.serialization import parse_record

    return {k: v[0] for k, v in (parse_record(line)
                                 for line in raw.decode().splitlines())}


def healthz(addr):
    import urllib.request

    with urllib.request.urlopen(f"http://{addr}/healthz", timeout=10) as r:
        return json.loads(r.read())


def tasks_json(procs, url, n):
    """One ``cli tasks URL --json`` in a process: the task docs by id."""
    name = f"tasks_{n}"
    procs.start(name, "tasks", url, "--json")
    procs.wait(name, timeout=60)
    return {t["_id"]: t for t in json.loads(procs.text(name))["tasks"]}


def cluster_slo(client):
    """The SLO lifecycle histograms the runner pushed, from the board's
    /clusterz: per tenant, each family's observation sum and count."""
    out = {}
    for name, labels, value in client.clusterz()["mrtpuCluster"]["metrics"]:
        for fam in ("queue_wait", "admit_to_running",
                    "submit_first_result"):
            base = f"mrtpu_slo_{fam}_seconds"
            for part in ("sum", "count"):
                if name == f"{base}_{part}":
                    out.setdefault(labels.get("tenant"), {})[
                        f"{fam}_{part}"] = value
    return out


def service_processes(procs, root, ha, files, token, refs, want_str):
    """Phase 14 (b): the reference's topology in processes: two
    ``docserver --ha-dir`` replicas, one ``runner`` over both at P = 8
    with two tasks in flight, both tenants' tasks submitted with
    ``submit``, and a SIGKILL of the primary once both read RUNNING."""
    from mapreduce_tpu_torch.coord.docserver import HttpDocStore
    from mapreduce_tpu_torch.coord.ha import HaController

    for i in range(2):
        procs.start(f"board{i}", "docserver", "--host", "127.0.0.1",
                    "--port", "0", "--ha-dir", ha, "--ha-lease",
                    str(SERVICE_LEASE), "--max-inflight", "2")
    addrs = [procs.wait_line(f"board{i}",
                             r"job board at http://([\d.]+:\d+)").group(1)
             for i in range(2)]
    deadline = time.monotonic() + 30
    roles = []
    while time.monotonic() < deadline:
        roles = [healthz(a)["primary"] for a in addrs]
        if sum(roles) == 1:
            break
        time.sleep(0.05)
    check(sum(roles) == 1, f"service (b): primaries {roles}")
    prim = roles.index(True)
    url = "http://" + ",".join(addrs)
    t0 = time.monotonic()
    procs.start("runner", "runner", url, "--partitions", str(RADIX_PARTS),
                "--torch-device", SERVICE_DEV,
                "--max-inflight", "2", "--workers", "2",
                "--telemetry-interval", "0.5")
    banner = procs.wait_line("runner", r"runner serving .* (\d+) "
                             r"partition\(s\) on (\w+)", timeout=120)
    runner_start_s = time.monotonic() - t0
    check(int(banner.group(1)) == RADIX_PARTS
          and banner.group(2) == SERVICE_DEV,
          f"service (b): the runner serves {banner.group(1)} partition(s) "
          f"on {banner.group(2)}, not {RADIX_PARTS} on {SERVICE_DEV}")
    for tenant, impl in SERVICE_TENANTS:
        p = service_params(files, impl,
                           f"shared:{os.path.join(root, 'svc_' + tenant)}")
        procs.start(f"submit_{tenant}", "submit", url, tenant,
                    *[p[r] for r in ("taskfn", "mapfn", "partitionfn",
                                     "reducefn", "finalfn", "storage")],
                    "--db", f"svc_{tenant}", "--device", "--est-jobs", "1",
                    "--program", "wave",
                    "--init-args", json.dumps(p["init_args"]))
    ids = {}
    for tenant, _ in SERVICE_TENANTS:
        procs.wait(f"submit_{tenant}", timeout=60)
        ids[tenant] = json.loads(
            procs.text(f"submit_{tenant}").strip().splitlines()[-1])["_id"]
    polls = 0
    deadline = time.monotonic() + SERVICE_TIMEOUT
    while True:
        polls += 1
        docs = tasks_json(procs, url, polls)
        states = {t: docs[tid]["state"] for t, tid in ids.items()}
        if all(st == "RUNNING" for st in states.values()):
            break
        check(not any(st in ("DONE", "FAILED", "CANCELLED")
                      for st in states.values())
              and time.monotonic() < deadline,
              f"service (b): tasks {states} before both read RUNNING")
    kill_wall = time.time()
    t_kill = time.monotonic()
    procs.procs[f"board{prim}"].kill()
    survivor = addrs[1 - prim]
    while not healthz(survivor)["primary"]:
        check(time.monotonic() - t_kill < 30,
              "service (b): the standby did not promote in 30 s")
        time.sleep(0.01)
    promotion_s = time.monotonic() - t_kill
    while True:
        polls += 1
        docs = tasks_json(procs, f"http://{survivor}", polls)
        states = {t: docs[tid]["state"] for t, tid in ids.items()}
        if all(st == "DONE" for st in states.values()):
            break
        check(all(st in ("ADMITTED", "RUNNING", "DONE")
                  for st in states.values())
              and time.monotonic() < deadline,
              f"service (b): tasks {states} after the kill: "
              f"{procs.text('runner', 'err')[-3000:]}")
        time.sleep(0.3)
    done_s = time.monotonic() - t_kill
    for tenant, impl in SERVICE_TENANTS:
        got = result_bytes(os.path.join(root, "svc_" + tenant),
                           f"svc_{tenant}")
        check(got == refs[impl]["bytes"], f"service (b): {tenant}'s result "
              f"differs from the same task on a dir: board")
        check(result_counts(got) == want_str, f"service (b): {tenant}'s "
              "result differs from Counter over the files' words")
    time.sleep(1.5)  # two pushes of the runner's telemetry
    client = HttpDocStore(survivor, auth_token=token)
    slo = cluster_slo(client)
    # (d) the runner's advisor: it registered its own facts, the libraries
    # phase 1 built make "wave" warm there, and a one-candidate pick is
    # recorded only when warm, so each task's admission is a decision
    admission = sum(
        v for n, labels, v in client.clusterz()["mrtpuCluster"]["metrics"]
        if n == "mrtpu_control_decisions_total"
        and labels.get("controller") == "admission")
    check(admission >= len(SERVICE_TENANTS), f"service (d): {admission} "
          "admission decisions on /clusterz for "
          f"{len(SERVICE_TENANTS)} tasks")
    meshes = {t: docs[ids[t]].get("mesh") for t, _ in SERVICE_TENANTS}
    check(len(set(meshes.values())) == 1 and None not in meshes.values(),
          f"service (d): the tasks' placements {meshes}")
    tasks = {}
    for tenant, impl in SERVICE_TENANTS:
        d = docs[ids[tenant]]
        db = f"svc_{tenant}"
        (job,) = client.find(f"{db}.map_jobs", {"_id": "__device__"})
        (task,) = client.find(f"{db}.task", {"_id": "unique"})
        row = slo.get(tenant, {})
        tasks[tenant] = {
            "sort_impl": impl, "task": ids[tenant],
            "submit_to_done_s": d["done_time"] - d["submit_time"],
            "queue_wait_s": (row.get("queue_wait_sum")
                             if row.get("queue_wait_count") == 1 else None),
            "admit_to_running_s": (
                row.get("admit_to_running_sum")
                if row.get("admit_to_running_count") == 1 else None),
            "submit_first_result_s": (
                row.get("submit_first_result_sum")
                if row.get("submit_first_result_count") == 1 else None),
            "device_phase_started_after_kill": job["started_time"]
            > kill_wall,
            "iteration": task["iteration"],
            "reran_a_phase": task["iteration"] != 1,
            "result_bytes": len(refs[impl]["bytes"]),
            "byte_equal_to_dir_run": True, "counter_equal": True}
        check(task["iteration"] == 1, f"service (b): {tenant}'s task ran "
              f"{task['iteration']} iterations")
    # stop the runner cleanly (it releases the admission lease), then a
    # fresh replica's replay of the log must equal the survivor's docs
    procs.procs["runner"].send_signal(__import__("signal").SIGINT)
    procs.wait("runner", timeout=120)
    fresh = HaController(ha, lease=SERVICE_LEASE)
    fresh._apply_new()
    colls = sorted(client.collections())
    check(colls == sorted(fresh.store.inner.collections()),
          "service (b): the replayed log has other collections than the "
          "survivor")
    for coll in colls:
        live = sorted(client.find(coll), key=lambda d: d["_id"])
        check(live == sorted(fresh.store.inner.find(coll),
                             key=lambda d: d["_id"]),
              f"service (b): the replayed log's {coll} differs from the "
              "survivor's documents")
    fresh.log.close()
    client.close()
    return survivor, {
        "run": "processes", "lease_s": SERVICE_LEASE,
        "runner_start_s": runner_start_s, "kill_to_promotion_s":
        promotion_s, "kill_to_both_done_s": done_s,
        "tasks_polls": polls, "tasks": tasks,
        "admission_decisions": admission, "placements": meshes,
        "replay_equal_collections": len(colls)}


def service_in_process(torch, kc, seg, rs, shuffle, spec, jwc, conf, procs,
                       root, ha, survivor, files, token, refs):
    """Phase 14 (c): the same two tasks with TaskRunner and the scheduled
    workers in this process, over the surviving board and a restarted
    replica, both in flight at once: the launches of rows 1-5 counted
    around the run (equal to the two dir: runs' launches summed), each
    kernel held bit for bit against its plain version on the inputs of
    its largest call."""
    from mapreduce_tpu_torch.coord import docstore
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.sched.scheduler import (
        DONE, Scheduler, SchedulerConfig)
    from mapreduce_tpu_torch.sched.service import (
        TaskRunner, spawn_scheduled_workers, wait_for_state)

    procs.start("board_restart", "docserver", "--host", "127.0.0.1",
                "--port", "0", "--ha-dir", ha, "--ha-lease",
                str(SERVICE_LEASE), "--max-inflight", "2")
    restarted = procs.wait_line(
        "board_restart", r"job board at http://([\d.]+:\d+)").group(1)
    check(healthz(restarted)["role"] == "replica",
          f"service (c): the restarted replica is {healthz(restarted)}")
    connstr = f"http://{survivor},{restarted}"
    store = docstore.connect(connstr, auth=token)
    sch = Scheduler(store, config=SchedulerConfig(max_inflight=2))
    reset_example(spec, jwc, conf)
    kc.reset_counts()
    t0 = time.monotonic()
    with PathInputs(torch, seg, shuffle) as cap:
        runner = TaskRunner(connstr, sch, auth=token, poll=0.02,
                            partitions=Partitions(RADIX_PARTS, SERVICE_DEV))
        pool = spawn_scheduled_workers(connstr, 2, auth=token)
        try:
            ids = {}
            for tenant, impl in SERVICE_TENANTS:
                ids[tenant] = sch.submit(tenant, db=f"svc2_{tenant}",
                                         est_jobs=1, params=service_params(
                    files, impl,
                    f"shared:{os.path.join(root, 'svc2_' + tenant)}"))["_id"]
            runner.start()
            both = False
            while not both:
                states = [sch.get(i)["state"] for i in ids.values()]
                both = all(st == "RUNNING" for st in states)
                if not both:
                    check("DONE" not in states
                          and time.monotonic() - t0 < SERVICE_TIMEOUT,
                          f"service (c): tasks {states} before both ran")
                    time.sleep(0.01)
            for tid in ids.values():
                wait_for_state(sch, tid, DONE, timeout=SERVICE_TIMEOUT)
            # each task's engine compute seconds, from its stats doc
            compute = {t: store.find_one(
                f"svc2_{t}.task", {"_id": "unique"})["stats"]["device"][
                    "compute_s"] for t, _ in SERVICE_TENANTS}
        finally:
            runner.stop(timeout=SERVICE_TIMEOUT)
            for w in pool:
                w.stop(timeout=SERVICE_TIMEOUT)
            store.close()
    wall = time.monotonic() - t0
    torch.cuda.synchronize()
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    check(not any(plain.values()), f"service (c): plain versions ran on "
          f"the card: {plain}")
    check(all(launches[k] > 0 for k in SERVICE_KERNELS),
          f"service (c): a kernel of the path was never launched: "
          f"{launches}")
    solo = {k: sum(r["launches"][k] for r in refs.values())
            for k in SERVICE_KERNELS}
    check({k: launches[k] for k in SERVICE_KERNELS} == solo,
          f"service (c): launches {launches} with two tasks at once, "
          f"{solo} from the two tasks one at a time")
    for tenant, impl in SERVICE_TENANTS:
        got = result_bytes(os.path.join(root, "svc2_" + tenant),
                           f"svc2_{tenant}")
        check(got == refs[impl]["bytes"], f"service (c): {tenant}'s "
              "result differs from the same task on a dir: board")
    held = hold_path_inputs(torch, seg, rs, "service", cap.inputs,
                            ["segreduce", "radix_sort", "radix_plan"])
    del cap
    reset_example(spec, jwc, conf)
    return {k: launches[k] for k in SERVICE_KERNELS}, {
        "run": "in_process", "both_running_at_once": True,
        "wall_s": wall, "launches": {k: launches[k]
                                     for k in SERVICE_KERNELS},
        "launches_equal_solo_sum": True, "plain_calls": 0,
        "byte_equal_to_dir_run": True, "held": held, "compute_s": compute}


def service_phase(torch, kc, seg, rs, data, want, smi):
    """Phase 14: the always-on service (the ``service`` lines)."""
    import shutil
    import tempfile
    import uuid

    from mapreduce_tpu_torch import spec
    from mapreduce_tpu_torch.examples import wordcount as jwc
    from mapreduce_tpu_torch.parallel import shuffle
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.server import Server

    t_phase = time.monotonic()
    conf = {"files": [], "num_reducers": 15}
    token = uuid.uuid4().hex
    root = tempfile.mkdtemp(prefix="chip_smoke_service_")
    procs = NetProcs(root, token, label="service")
    try:
        line = service_failover()
        line["card"] = smi
        print(json.dumps({"service": line}), flush=True)

        files = write_line_files(data, JOB_FILES,
                                 tempfile.mkdtemp(prefix="big_", dir=root))
        want_str = {w.decode(): c for w, c in want.items()}
        refs = {}
        for _, impl in SERVICE_TENANTS:
            # the same task through Server on a dir: board, counted
            reset_example(spec, jwc, conf)
            kc.reset_counts()
            st = os.path.join(root, f"ref_{impl}")
            server = Server(f"dir://{os.path.join(root, 'ref_board')}",
                            f"ref_{impl}")
            server.configure(dict(service_params(files, impl, f"shared:{st}"),
                                  partitions=Partitions(RADIX_PARTS,
                                                        SERVICE_DEV)))
            t0 = time.monotonic()
            loop_in_thread(server)
            refs[impl] = {"bytes": result_bytes(st, f"ref_{impl}"),
                          "launches": dict(kc.LAUNCHES),
                          "wall_s": time.monotonic() - t0}
            check(not any(kc.PLAIN_CALLS.values()),
                  f"service: plain versions ran in the dir: run "
                  f"{dict(kc.PLAIN_CALLS)}")
            check(result_counts(refs[impl]["bytes"]) == want_str,
                  f"service: the dir: run ({impl}) differs from Counter")
        reset_example(spec, jwc, conf)

        ha = os.path.join(root, "ha")
        survivor, line = service_processes(procs, root, ha, files, token,
                                           refs, want_str)
        line["dir_run_wall_s"] = {k: r["wall_s"] for k, r in refs.items()}
        print(json.dumps({"service": line}), flush=True)

        launches, line = service_in_process(
            torch, kc, seg, rs, shuffle, spec, jwc, conf, procs, root, ha,
            survivor, files, token, refs)
        line["phase_s"] = time.monotonic() - t_phase
        line["card"] = smi
        print(json.dumps({"service": line}), flush=True)
    finally:
        # (d) every process reaped under a timeout
        procs.reap()
    shutil.rmtree(root, ignore_errors=True)
    return launches, line["compute_s"]


# -- phase 15: the self-tuning controllers ------------------------------------

#: the phase's device (a CPU rehearsal of the phase sets "cpu")
CONTROL_DEV = "cuda"
#: phase 15 (a): bench.py's measure_skew_rebalance at its own size
#: (smoke=False: C = 4096 rows a partition, 4 rounds, 32-value chunks),
#: then a real stream's state: C = 1<<18 a partition (8 x 262,144
#: resident rows, ~420K distinct keys over the rounds) with 8192-value
#: chunks, so a feed is 4 waves
SKEW_SIZES = (("bench", 4096, 4, 32), ("stream", 1 << 18, 4, 8192))
#: chunks a partition a wave (bench.py's k)
SKEW_K = 2
#: the kernels of the skewed session's path (radix, no tokenizer)
SKEW_KERNELS = ("segreduce", "radix_plan", "radix_upfront",
                "radix_onesweep")


def control_map_fn(chunk, chunk_index, cfg):
    """Torch twin of ``bench._control_map_fn``: the chunk VALUES are the
    key_hi hashes verbatim, so the corpus chooses the partition and the
    bucket of every record (a skewed and a uniform corpus run the same
    program and differ only in routing)."""
    import torch

    c = chunk.to(torch.int64)
    keys = torch.stack([c, c % 17], dim=-1).to(torch.int32)
    vals = torch.ones(c.shape, dtype=torch.int32, device=c.device)
    pay = (c % 97).to(torch.int32)[:, None]
    valid = torch.ones(c.shape, dtype=torch.bool, device=c.device)
    return (keys, vals, pay, valid,
            torch.zeros((), dtype=torch.int32, device=c.device))


def skew_feeds(B, P, C, rounds, rows):
    """``bench.measure_skew_rebalance``'s corpus, in its draw order: the
    uniform run's warm feed and rounds, then the skewed run's.  Every
    skewed key is congruent to partition 5 under the identity map and
    spread over B / P buckets."""
    import numpy as np

    keys_per_round = max(64, int(C * 0.4))
    hot = 5 % P
    rng = np.random.default_rng(7)

    def corpus_round(r, skewed):
        ids = np.arange(r * keys_per_round, (r + 1) * keys_per_round,
                        dtype=np.int64)
        if skewed:
            group = ids % (B // P)
            k = ids * np.int64(B) + group * np.int64(P) + hot
        else:
            k = ids * np.int64(B) + (ids % np.int64(B))
        draw = rng.choice(k, size=keys_per_round * 4)
        pad = (-draw.size) % rows
        draw = np.concatenate([draw, draw[:pad]])
        return draw.reshape(-1, rows).astype(np.int32)

    out = {}
    for skewed in (False, True):
        out[skewed] = ([corpus_round(0, skewed)[:2]]
                       + [corpus_round(r, skewed) for r in range(rounds)])
    return out, keys_per_round


class RebalanceTimer:
    """Times a session's rebalances, split into the host re-bin's three
    steps (``lanes_to_host`` -> ``repartition_rows`` ->
    ``lanes_to_device``), by wrapping the session module's names while
    a rebalance runs."""

    STEPS = ("lanes_to_host", "repartition_rows", "lanes_to_device")

    def __init__(self, smod, sess):
        self.smod, self.sess = smod, sess
        self.calls = []
        self._on = False

    def __enter__(self):
        real = self.sess.rebalance
        self.real_steps = {n: getattr(self.smod, n) for n in self.STEPS}
        timer = self

        def step(name, fn):
            def timed(*a, **kw):
                if not timer._on:
                    return fn(*a, **kw)
                t0 = time.monotonic()
                out = fn(*a, **kw)
                timer.calls[-1][name] = (timer.calls[-1].get(name, 0.0)
                                         + time.monotonic() - t0)
                return out
            return timed

        def rebalance(task, pmap):
            self.calls.append({})
            self._on = True
            t0 = time.monotonic()
            try:
                return real(task, pmap)
            finally:
                self._on = False
                self.calls[-1]["total_s"] = time.monotonic() - t0

        for n, fn in self.real_steps.items():
            setattr(self.smod, n, step(n, fn))
        self.sess.rebalance = rebalance
        return self

    def __exit__(self, *exc):
        for n, fn in self.real_steps.items():
            setattr(self.smod, n, fn)
        del self.sess.rebalance
        return False


def skew_truth(feeds):
    """Host truth of a control stream: each key_hi and its count."""
    import numpy as np

    return np.unique(np.concatenate([f.reshape(-1) for f in feeds]),
                     return_counts=True)


def skew_snapshot_equal(torch, snap, truth):
    """The snapshot's (key, count) pairs against *truth*, and its second
    key lane and payload against their functions of the key."""
    import numpy as np

    valid = snap.valid.numpy()
    keys = snap.keys.numpy()[valid]
    order = np.argsort(keys[:, 0], kind="stable")
    k1 = keys[order, 0]
    vals = snap.values.numpy()[valid][order]
    want_k, want_n = truth
    return (snap.overflow == 0 and np.array_equal(k1, want_k)
            and np.array_equal(vals, want_n)
            and np.array_equal(keys[order, 1], k1 % 17)
            and np.array_equal(snap.payload.numpy()[valid][order, 0],
                               k1 % 97))


def skew_case(torch, kc, seg, rs, shuffle, smod, Partitions, label, C,
              rounds, rows):
    """Phase 15 (a) at one size: bench.py's measure_skew_rebalance
    ported (a uniform and a skewed stream, each with an ``AutoTuner``
    attached, the warm feed outside the timed window), then the skewed
    feeds once more without a controller."""
    from mapreduce_tpu_torch.engine.autotune import AutoTuner
    from mapreduce_tpu_torch.engine.device_engine import (
        EngineConfig, partition_buckets_for)
    from mapreduce_tpu_torch.obs.comms import matrix_stats
    from mapreduce_tpu_torch.obs.control import ControlLedger

    P = RADIX_PARTS
    if label == "bench":
        # bench.py's own capacities: local 4C, a pair's exchange 256
        # (each partition's wave holds k * 32 = 64 uniques)
        local, exchange = 4 * C, 256
    else:
        # what routes: a partition's wave holds k * rows records, so at
        # most that many uniques, all of which may go to one partition
        local = exchange = SKEW_K * rows
    cfg = EngineConfig(local_capacity=local, exchange_capacity=exchange,
                       out_capacity=C, tile=64, tile_records=32,
                       partition_map=True, sort_impl="radix")
    B = partition_buckets_for(cfg, P)
    feeds, keys_per_round = skew_feeds(B, P, C, rounds, rows)
    ledger = ControlLedger()

    def run(skewed, controlled):
        tuner = (AutoTuner(ledger=ledger, min_records=keys_per_round // 2)
                 if controlled else None)
        sess = smod.EngineSession(Partitions(P, CONTROL_DEV),
                                  control_map_fn, cfg, k=SKEW_K,
                                  autotune=tuner, task="skew-bench")
        task = "skewed" if skewed else "uniform"
        warm, *timed = feeds[skewed]
        on = "raise" if controlled else "count"
        kc.reset_counts()
        with RebalanceTimer(smod, sess) as reb, \
                PathInputs(torch, seg, shuffle, latest=True) as cap:
            sess.feed(warm, task=task, on_overflow=on)
            imb, walls = [], []
            last = sess.traffic_matrix(task).astype("int64")
            t0 = time.monotonic()
            for chunk in timed:
                t1 = time.monotonic()
                sess.feed(chunk, task=task, on_overflow=on)
                cur = sess.traffic_matrix(task).astype("int64")
                walls.append(time.monotonic() - t1)
                imb.append(matrix_stats((cur - last).tolist())
                           ["imbalance_recv"])
                last = cur
            wall = time.monotonic() - t0
        launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
        out = {"wall_s": wall, "round_wall_s": walls, "imbalance": imb,
               "stats": sess.stats(task), "rebalance_s": reb.calls,
               "launches": {k: launches[k] for k in SKEW_KERNELS},
               "plain_calls": sum(plain.values()), "inputs": cap.inputs,
               "resident_bytes": acc_bytes(sess, task)}
        if controlled and skewed:
            out["snapshot_equal"] = skew_snapshot_equal(
                torch, sess.snapshot(task), skew_truth(feeds[True]))
        sess.close()
        return out

    uniform = run(False, True)
    skewed = run(True, True)
    held = hold_path_inputs(torch, seg, rs, f"control {label}",
                            skewed.pop("inputs"),
                            ["segreduce", "radix_sort", "radix_plan"])
    uniform.pop("inputs")
    bare = run(True, False)
    bare.pop("inputs")
    imb = skewed["imbalance"]
    decs = ledger.decisions("repartition")
    check(imb[-1] < imb[0], f"control {label}: the skewed stream's "
          f"imbalance did not fall across windows: {imb}")
    check(skewed["stats"].get("rebalances", 0) >= 1,
          f"control {label}: no rebalance: {skewed['stats']}")
    check(any(d["outcome"] == "improved" for d in decs),
          f"control {label}: no repartition decision resolved improved: "
          f"{decs}")
    check(skewed["snapshot_equal"], f"control {label}: the skewed "
          "stream's snapshot differs from host truth")
    check(bare["stats"]["overflow"] > 0, f"control {label}: the skewed "
          "feeds without a controller did not overflow")
    check(all(v > 0 for v in skewed["launches"].values())
          and skewed["plain_calls"] == 0,
          f"control {label}: launches {skewed['launches']}, plain calls "
          f"{skewed['plain_calls']}")
    return {
        "size": label, "out_capacity": C, "local_capacity": local,
        "exchange_capacity": exchange, "rounds": rounds,
        "values_a_chunk": rows, "k": SKEW_K,
        "keys_per_round": keys_per_round,
        "records_a_round": int(feeds[True][1].size),
        "skewed_wall_ratio": skewed["wall_s"] / uniform["wall_s"],
        "skew_uniform_wall_s": uniform["wall_s"],
        "skew_skewed_wall_s": skewed["wall_s"],
        "skew_imbalance_first": imb[0], "skew_imbalance_last": imb[-1],
        "skew_imbalance": imb,
        "uniform_imbalance": uniform["imbalance"],
        "skew_rebalance_decisions": sum(
            1 for d in decs if d["outcome"] != "error"
            and d["task"] == "skewed"),
        "decisions": [{k: d.get(k) for k in (
            "task", "outcome", "evidence", "action", "outcome_evidence")}
            for d in decs],
        "skewed_round_wall_s": skewed["round_wall_s"],
        "uniform_round_wall_s": uniform["round_wall_s"],
        "rebalance_s": skewed["rebalance_s"],
        "skewed_stats": skewed["stats"],
        "resident_bytes": skewed["resident_bytes"],
        "uncontrolled_overflow_rows": bare["stats"]["overflow"],
        "launches": skewed["launches"], "plain_calls": 0, "held": held,
        "snapshot_equal_host_truth": True}


def capacity_case(torch, kc, seg, shuffle, wcmod, Partitions, tenant):
    """Phase 15 (b): a tenant of phase 8 at P = 1 under the sustained
    config, whose exchange capacity (1<<15) the tenant's one-wave feed
    overflows: (1) an autotuned run retries and teaches the controller,
    (2) a session of the same program pre-sized at its door feeds the
    tenant overflow-free, (3) another run retries no more."""
    from mapreduce_tpu_torch.engine import session as smod
    from mapreduce_tpu_torch.engine.autotune import AutoTuner
    from mapreduce_tpu_torch.engine.device_engine import (
        DeviceEngine, EngineConfig)
    from mapreduce_tpu_torch.obs.control import ControlLedger

    rows, want, _ = tenant
    cfg = EngineConfig(**SESSION_CONFIG)
    ledger = ControlLedger()
    tuner = AutoTuner(ledger=ledger, repartition=False)
    parts = Partitions(1, CONTROL_DEV)
    steps = {}
    kc.reset_counts()
    with PathInputs(torch, seg, shuffle) as cap:
        t0 = time.monotonic()
        eng = DeviceEngine(parts, wcmod._wordcount_map_fn, cfg,
                           task="capacity", autotune=tuner)
        tm1 = {}
        r1 = eng.run(rows, timings=tm1)
        steps["run_1_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        sess = smod.EngineSession(parts, wcmod._wordcount_map_fn, cfg,
                                  task="capacity", autotune=tuner)
        oflow = sess.feed(rows, task="t0")
        snap = sess.snapshot("t0")
        steps["session_feed_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        tm2 = {}
        r2 = DeviceEngine(parts, wcmod._wordcount_map_fn, cfg,
                          task="capacity", autotune=tuner).run(
            rows, timings=tm2)
        steps["run_2_s"] = time.monotonic() - t0
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    key = eng.autotune_key()
    learned = dict(tuner.capacity._state[key]["caps"])
    decs = ledger.decisions("capacity")
    check(tm1["retries"] >= 1, "control (b): the mis-sized run did not "
          "retry")
    check(sess.config.exchange_capacity > cfg.exchange_capacity,
          f"control (b): the session was not pre-sized: {sess.config}")
    check(oflow == 0 and snap.overflow == 0,
          f"control (b): the pre-sized session's first feed overflowed "
          f"{oflow} rows")
    check(tm2["retries"] == 0, f"control (b): the second run retried "
          f"{tm2['retries']} times")
    check(len(decs) == 1 and decs[0]["outcome"] == "improved",
          f"control (b): capacity decisions {decs}")
    for label, res in (("run 1", r1), ("run 2", r2), ("session", snap)):
        check(wcmod.materialize_counts(rows, res) == want,
              f"control (b): {label}'s counts differ from Counter")
    check_launches(launches, plain, "control (b)", False)
    held = hold_path_inputs(torch, seg, None, "control (b)", cap.inputs,
                            ["segreduce"])
    sess.close()
    return {
        "exchange_capacity": cfg.exchange_capacity,
        "retries_run_1": tm1["retries"], "retries_run_2": tm2["retries"],
        "learned": learned, "session_config": {
            k: getattr(sess.config, k) for k in (
                "local_capacity", "exchange_capacity", "out_capacity",
                "combine_capacity")},
        "session_first_feed_overflow": oflow,
        "decision": {k: decs[0].get(k) for k in (
            "outcome", "evidence", "action", "outcome_evidence", "note")},
        "seconds": steps, "compute_s_run_1": tm1["compute_s"],
        "compute_s_run_2": tm2["compute_s"],
        "launches": {k: launches[k] for k in ("tokenize", "segreduce")},
        "plain_calls": 0, "held": held}


def control_phase(torch, kc, seg, rs, wcmod, Partitions, tenants, smi):
    """Phase 15: the self-tuning controllers (the ``control`` lines).
    Returns the launches of (a)'s controlled skewed stream at the
    stream size and of (b)."""
    from mapreduce_tpu_torch.engine import session as smod
    from mapreduce_tpu_torch.parallel import shuffle

    t_phase = time.monotonic()
    launches = {}
    for label, C, rounds, rows in SKEW_SIZES:
        line = skew_case(torch, kc, seg, rs, shuffle, smod, Partitions,
                         label, C, rounds, rows)
        line["card"] = smi
        print(json.dumps({"control": {"skew": line}}), flush=True)
        launches[f"skew_{label}"] = line["launches"]
    line = capacity_case(torch, kc, seg, shuffle, wcmod, Partitions,
                         tenants[SESSION_TENANTS[0]])
    line["card"] = smi
    line["phase_s"] = time.monotonic() - t_phase
    print(json.dumps({"control": {"capacity": line}}), flush=True)
    launches["capacity"] = line["launches"]
    return launches


# -- phase 16: the engine's device telemetry ------------------------------------

#: identifiers of the engine's and the session's telemetry lines: a
#: synchronising call on such a line (or anywhere under obs/) fails
TELEMETRY_LINE = re.compile(
    r"\b(line\.|_memory_obs|_profile|_comms|_slo|TRACER|_WAVES|"
    r"_DISPATCHES|_RETRIES|_STAGE_SECONDS|_WAVE_SECONDS|_PARTITION_|"
    r"_SESSION|_FEEDS|_CHUNKS|_SNAPSHOTS|_LIVE_RECORDS|_OVERFLOWS|"
    r"_BACKPRESSURE|refresh_stream_age_gauges)")
#: phase 16's forced retry: below the corpus's 76,006 unique words
TELEMETRY_OUT_CAPACITY = 1 << 16
#: the device phase 16's retry and CLI runs use ("cpu" in a rehearsal)
TELEMETRY_DEV = "cuda"


def span_family(TRACER, trace_id):
    return [e for e in TRACER.events()
            if e["args"].get("trace_id") == trace_id]


def check_wave_tree(events, label, device_clock=True):
    """Check ``device_run ⊃ wave ⊃ {upload, compute, readback}`` in
    *events* (one trace): parent links, each child inside its parent
    (half a microsecond of rounding slack, as the JAX test allows), and
    device intervals on upload and compute.  Returns the span counts by
    name and each wave's ``(compute device_ms, upload device_ms)``."""
    by_id = {e["args"]["span_id"]: e for e in events}
    names = Counter(e["name"] for e in events)
    per_wave = {}

    def inside(outer, inner):
        return (outer["ts"] <= inner["ts"] + 0.5
                and inner["ts"] + inner["dur"]
                <= outer["ts"] + outer["dur"] + 0.5)

    for e in events:
        parent = by_id.get(e["args"]["parent_id"])
        name = e["name"]
        if name == "wave":
            check(parent is not None and parent["name"] == "device_run"
                  and inside(parent, e), f"{label}: a wave outside its "
                  "device_run")
            check("truncated" not in e["args"], f"{label}: a truncated "
                  "wave in a run that finished")
        elif name in ("upload", "compute") or (
                name == "readback" and "kind" in e["args"]):
            check(parent is not None and parent["name"] == "wave"
                  and inside(parent, e), f"{label}: {name} outside its "
                  "wave")
            if name in ("upload", "compute") and device_clock:
                check(e["args"].get("clock") == "device"
                      and e["args"]["device_ms"] > 0,
                      f"{label}: {name} without a device interval: "
                      f"{e['args']}")
            if name != "readback":
                w = parent["args"]["wave"]
                per_wave.setdefault(w, {})[f"{name}_device_ms"] = \
                    e["args"].get("device_ms")
    check(names["device_run"] >= 1 and names["wave"] >= 1
          and names["wave"] == names["upload"] == names["compute"],
          f"{label}: span counts {dict(names)}")
    return dict(names), [dict(wave=w, **per_wave[w])
                         for w in sorted(per_wave)]


def sync_sites(torch, run):
    """Run *run* under ``set_sync_debug_mode("warn")``: the count of
    synchronising calls by the innermost frame of the port, and the
    frames that are under obs/ or on a telemetry line."""
    import traceback
    import warnings

    stacks = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stacks.append(traceback.extract_stack()[:-1])

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    sites, bad = Counter(), []
    for st in stacks:
        ours = [fr for fr in st if "mapreduce_tpu_torch/" in
                fr.filename.replace(os.sep, "/")]
        if ours:
            fr = ours[-1]
            path = fr.filename.replace(os.sep, "/")
            sites[f"{path.split('mapreduce_tpu_torch/')[-1]}:"
                  f"{fr.lineno}"] += 1
        for fr in ours:
            path = fr.filename.replace(os.sep, "/")
            if "mapreduce_tpu_torch/obs/" in path or (
                    "mapreduce_tpu_torch/engine/" in path
                    and TELEMETRY_LINE.search(fr.line or "")):
                bad.append(f"{path}:{fr.lineno} {fr.line}")
    return len(stacks), dict(sites), bad


def telemetry_run(torch, kc, wc, data, want, label, waves, smi, need):
    """One warm slice under a root span: the ``telemetry`` line."""
    from mapreduce_tpu_torch.obs import memory
    from mapreduce_tpu_torch.obs.buildinfo import build_info
    from mapreduce_tpu_torch.obs.metrics import REGISTRY
    from mapreduce_tpu_torch.obs.trace import TRACER

    chunks, L = wc._to_chunks(data)
    eng = wc._engine_for(L)
    eng.task_label = f"telemetry_{label}"
    wc.count_bytes(data, waves=waves)  # warm, under this label too
    before = {f: REGISTRY.sum(f, task=eng.task_label) for f in (
        "mrtpu_device_waves_total", "mrtpu_device_dispatches_total",
        "mrtpu_device_retries_total")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kc.reset_counts()
    tm = {}
    with TRACER.span("root", phase="telemetry") as root:
        got = wc.count_bytes(data, timings=tm, waves=waves)
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated()
    check(got == want, f"telemetry {label}: counts differ from Counter")
    check(all(launches[k] > 0 for k in need),
          f"telemetry {label}: a kernel of the path was never launched: "
          f"{launches}")
    check(all(v == 0 for v in plain.values()),
          f"telemetry {label}: plain versions ran on the card: {plain}")
    events = span_family(TRACER, root.trace_id)
    names, per_wave = check_wave_tree(events, f"telemetry {label}")
    counters = {f.split("_device_")[1]: REGISTRY.sum(
        f, task=eng.task_label) - before[f] for f in before}
    check(counters == {"waves_total": tm["waves"],
                       "dispatches_total": tm["waves"],
                       "retries_total": 0},
          f"telemetry {label}: counters {counters}, {tm['waves']} waves")
    check(names["wave"] == tm["waves"], f"telemetry {label}: "
          f"{names['wave']} wave spans for {tm['waves']} waves")
    check(0.0 < tm["roofline_frac"] <= 1.0,
          f"telemetry {label}: roofline_frac {tm['roofline_frac']}")
    sample = memory.memory_snapshot()
    check(sample.get("device_source") == "measured",
          f"telemetry {label}: memory sample {sample}")
    dev_sample = next(iter(sample["devices"].values()))
    check(0 < dev_sample["bytes_in_use"] <= dev_sample["peak_bytes_in_use"]
          <= peak, f"telemetry {label}: memory sample {dev_sample} vs "
          f"max_memory_allocated {peak}")
    line = {
        "run": label, "card": smi, "counters": counters, "spans": names,
        "nested": True, "waves": per_wave, "compute_s": tm["compute_s"],
        "upload_s": tm["upload_s"], "readback_s": tm["readback_s"],
        "first_dispatch_s": tm["first_dispatch_s"],
        "wave_compute_device_ms_sum": sum(
            w["compute_device_ms"] or 0.0 for w in per_wave),
        **{k: tm[k] for k in (
            "flops", "cost_bytes", "cost_source", "peak_source",
            "model_flops_per_s", "arith_intensity", "mfu",
            "roofline_frac", "program_memory_bytes", "memory_source",
            "upload_overlap_frac")},
        "memory": {"sample": dev_sample, "max_memory_allocated": peak},
        "build_info": build_info(), "launches": launches}
    print(json.dumps({"telemetry": line}), flush=True)
    return tm, events, launches


def telemetry_retry(torch, wcmod, data, want, smi):
    """A P = 1 run whose out_capacity the corpus overflows: one retry,
    its ``capacity_retry`` event checked against the card's memory."""
    from dataclasses import replace

    from mapreduce_tpu_torch.obs.memory import HBM_PRESSURE_RATIO
    from mapreduce_tpu_torch.obs.trace import TRACER

    cfg = replace(wcmod.bench_engine_config(),
                  out_capacity=TELEMETRY_OUT_CAPACITY)
    wc = wcmod.DeviceWordCount(device=TELEMETRY_DEV, chunk_len=CHUNK_LEN,
                               config=cfg)
    chunks, L = wc._to_chunks(data)
    wc._engine_for(L).task_label = "telemetry_retry"
    tm = {}
    with TRACER.span("root", phase="telemetry") as root:
        got = wc.count_bytes(data, timings=tm)
    check(got == want, "telemetry retry: counts differ from Counter")
    events = span_family(TRACER, root.trace_id)
    retries = [e["args"] for e in events if e["name"] == "capacity_retry"]
    check(tm["retries"] == 1 and len(retries) == 1,
          f"telemetry retry: {tm['retries']} retries, {len(retries)} "
          "capacity_retry events")
    ev = retries[0]
    old, new = ev["old_capacities"], ev["new_capacities"]
    check(old["out_capacity"] == TELEMETRY_OUT_CAPACITY
          and new["out_capacity"] > TELEMETRY_OUT_CAPACITY
          and ev["overflow_rows"] > 0 and ev["attempt"] == 0,
          f"telemetry retry: event {ev}")
    dev_mem = next(iter(ev["device_memory"]["devices"].values()))
    limit = torch.cuda.mem_get_info()[1]
    check(dev_mem["bytes_limit"] == limit, f"telemetry retry: limit "
          f"{dev_mem['bytes_limit']} vs mem_get_info {limit}")
    footprint = ev["program_memory"]["total"]
    want_bound = ("hbm" if max(dev_mem["bytes_in_use"], footprint)
                  >= HBM_PRESSURE_RATIO * limit else "capacity")
    check(ev["bound"] == want_bound, f"telemetry retry: bound "
          f"{ev['bound']}, expected {want_bound}")
    names = Counter(e["name"] for e in events)
    check(names["device_run"] == 2, f"telemetry retry: spans {dict(names)}")
    line = {"run": "capacity_retry", "card": smi, "retries": tm["retries"],
            "bound": ev["bound"], "overflow_rows": ev["overflow_rows"],
            "old_capacities": old, "new_capacities": new,
            "device_memory": dev_mem, "program_memory_total": footprint,
            "spans": dict(names), "compute_s": tm["compute_s"]}
    print(json.dumps({"telemetry": line}), flush=True)


def telemetry_bundle(events, smi):
    """The P = 1 run's profile bundle, written and loaded back."""
    import shutil
    import tempfile

    from mapreduce_tpu_torch.obs import profile

    root = tempfile.mkdtemp(prefix="chip_smoke_bundle_")
    try:
        out = profile.write_bundle(
            os.path.join(root, "bundle"),
            trace_doc={"traceEvents": events, "displayTimeUnit": "ms"})
        b = profile.load_bundle(out)
        check(len(b["trace"]["traceEvents"]) == len(events)
              and b["statusz"]["device"]["waves"] > 0
              and b["statusz"]["memory"]["device_source"] == "measured",
              "telemetry bundle: loaded bundle differs")
        line = {"run": "bundle", "card": smi,
                "files": b["manifest"]["files"],
                "trace_events": len(events),
                "metric_samples": len(b["metrics"]),
                "statusz_device": b["statusz"]["device"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"telemetry": line}), flush=True)


def telemetry_cli(data, smi):
    """One ``cli wordcount --device --trace-out`` job: the device run's
    spans under the job's ``run`` span."""
    import contextlib
    import io
    import shutil
    import tempfile

    from mapreduce_tpu_torch import cli, spec
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.examples import wordcount as jwc

    small = make_corpus(JOB_SMALL_WORDS, JOB_SMALL_WORDS // 25, seed=1)
    root = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        files = write_line_files(small, 3, root)
        trace_path = os.path.join(root, "trace.json")
        reset_example(spec, jwc, jwc._DEFAULTS)
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli.main(["wordcount", *files, "--device",
                           "--torch-device", TELEMETRY_DEV,
                           "--trace-out", trace_path])
        check(rc == 0, f"telemetry cli: exit {rc}: {err.getvalue()}")
        want = Counter(w.decode() for w in small.split())
        check(dict(jwc.RESULT) == dict(want),
              "telemetry cli: RESULT differs from Counter")
        with open(trace_path, encoding="utf-8") as f:
            doc = json.load(f)
    finally:
        reset_example(spec, jwc, jwc._DEFAULTS)
        shutil.rmtree(root, ignore_errors=True)
    events = doc["traceEvents"]
    jobs = [e for e in events if e["name"] == "job"
            and e["args"].get("job") == "__device__"]
    check(jobs, "telemetry cli: no device job span in the trace")
    job = jobs[-1]
    fam = [e for e in events
           if e["args"].get("trace_id") == job["args"]["trace_id"]]
    runs = [e for e in fam if e["name"] == "run"
            and e["args"]["parent_id"] == job["args"]["span_id"]]
    check(len(runs) == 1, f"telemetry cli: {len(runs)} run spans")
    drs = [e for e in fam if e["name"] == "device_run"]
    check(drs and all(d["args"]["parent_id"] == runs[0]["args"]["span_id"]
                      for d in drs),
          "telemetry cli: a device_run outside the job's run span")
    names, per_wave = check_wave_tree(fam, "telemetry cli")
    line = {"run": "cli_trace_out", "card": smi, "words": JOB_SMALL_WORDS,
            "spans": names, "waves": per_wave,
            "under": ["job", "run", "device_run", "wave"],
            "trace_events": len(events)}
    print(json.dumps({"telemetry": line}), flush=True)


def telemetry_phase(torch, kc, wcmod, wc, rwc, data, want, smi):
    """Phase 16: the engine's device telemetry (the ``telemetry``
    lines).  Returns the launches of its two slices."""
    t_phase = time.monotonic()
    base = ("tokenize", "segreduce")
    tm1, events1, l1 = telemetry_run(torch, kc, wc, data, want, "p1_variadic",
                                     None, smi, base)
    _, _, l8 = telemetry_run(torch, kc, rwc, data, want, "p8_radix",
                             RADIX_WAVES, smi, WORDCOUNT_KERNELS)
    got = {}
    n_sync, sites, bad = sync_sites(
        torch, lambda: got.update(c=wc.count_bytes(data)))
    check(got["c"] == want, "telemetry sync: counts differ from Counter")
    check(n_sync > 0, "telemetry sync: sync-debug mode saw no sync")
    check(not bad, f"telemetry sync: synchronising calls through the "
          f"telemetry: {bad}")
    print(json.dumps({"telemetry": {
        "run": "sync_debug_p1_variadic", "card": smi, "syncs": n_sync,
        "sites": sites, "telemetry_frames": bad}}), flush=True)
    telemetry_retry(torch, wcmod, data, want, smi)
    telemetry_bundle(events1, smi)
    telemetry_cli(data, smi)
    print(json.dumps({"telemetry": {
        "run": "phase", "card": smi,
        "phase_s": time.monotonic() - t_phase}}), flush=True)
    return {"p1_variadic": l1, "p8_radix": l8}


#: the run's start, for the whole smoke's wall time

# -- phase 17: the remaining examples and the compile plane --------------------

WORDSPAN_MODULE = "mapreduce_tpu_torch.examples.wordspan"
NATIVE_MODULE = "mapreduce_tpu_torch.examples.wordcount_native"
#: the example's module state as a fresh process has it
WORDSPAN_CONF = {"files": [], "num_reducers": 8}
#: phase 17 (c): words, blobs and worker threads of the native word count
NATIVE_WORDS = 2_000_000
NATIVE_BLOBS = 8
NATIVE_WORKERS = 4
#: seconds a subprocess of phase 17 may take
EXAMPLES_CHILD_TIMEOUT = 300
#: the phase's device (a CPU rehearsal of the phase sets "cpu")
EXAMPLES_DEV = "cuda"
#: (label, partitions, sort, kernels that must launch, kernels held):
#: the callable span monoid runs on its monoid kernel
WORDSPAN_PATHS = (
    ("P1", 1, "variadic", ("tokenize", "segreduce_monoid"), ["segreduce"]),
    ("P8", RADIX_PARTS, "radix",
     ("tokenize", "segreduce_monoid", "radix_plan", "radix_upfront",
      "radix_onesweep"), ["segreduce", "radix_sort", "radix_plan"]))
#: the per-lane codes of the span and collision-verify monoid
VERIFY_CODES = ("sum", "min", "max")
#: the libraries ``warmup --sort-impl tiered-radix`` builds
WARMUP_LIBRARIES = ("nvcc:tokenize", "nvcc:segreduce", "nvcc:radix",
                    "g++:mr_native")


def span_oracle(data, want):
    """``[count, first, last]`` for every word of *data* (the stream the
    files rejoin to), from the bytes alone: ``bytes.split`` for the
    words, numpy for each word's start offset, a dict each for the first
    and last index; *want* is ``Counter(data.split())``."""
    import numpy as np

    words = data.split()
    is_ws = np.zeros(256, dtype=bool)
    is_ws[[32, 9, 10, 13, 11, 12]] = True
    ws = is_ws[np.frombuffer(data, dtype=np.uint8)]
    starts = np.flatnonzero(~ws & np.concatenate(([True], ws[:-1])))
    check(len(starts) == len(words), "span oracle: word starts and words "
          "differ in number")
    last = {w: i for i, w in enumerate(words)}
    # later keys overwrite: walking backwards leaves each word's first
    first = {w: i for i, w in zip(range(len(words) - 1, -1, -1),
                                  reversed(words))}
    oracle = {w.decode("utf-8", "replace"): [
        want[w], int(starts[i]), int(starts[last[w]])]
        for w, i in first.items()}
    check(len(oracle) == len(first), "span oracle: two words decode alike")
    return oracle


def span_digest(result):
    """One hash of a wordspan ``RESULT`` (compared across processes)."""
    import hashlib

    return hashlib.sha256(json.dumps(sorted(result.items())).encode()
                          ).hexdigest()


def wordspan_run(torch, kc, spec, tws, files, n_parts, sort_impl, label,
                 need, autotune=None, capture=None, codes=False):
    """One ``Server(device=True)`` run of ``examples/wordspan`` over
    *files* at the example's own capacities (with *codes*, its monoid as
    the per-lane codes instead of the callable); returns the run's line
    and its ``RESULT``."""
    import uuid

    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.server import Server

    if codes:
        span_op = tws.SPAN_REDUCE_OP
        tws.SPAN_REDUCE_OP = VERIFY_CODES
        try:
            return wordspan_run(torch, kc, spec, tws, files, n_parts,
                                sort_impl, label, need, autotune, capture)
        finally:
            tws.SPAN_REDUCE_OP = span_op
    reset_example(spec, tws, WORDSPAN_CONF)
    params = {r: WORDSPAN_MODULE for r in ("taskfn", "mapfn", "partitionfn",
                                           "reducefn", "finalfn")}
    params.update(combinerfn=WORDSPAN_MODULE, device=True,
                  storage=f"mem:{uuid.uuid4().hex}",
                  partitions=Partitions(n_parts, EXAMPLES_DEV),
                  init_args={"files": files, "device_sort_impl": sort_impl})
    server = Server(f"mem://{uuid.uuid4().hex}", f"ws_{label.lower()}")
    server.autotune = autotune
    server.configure(params)
    kc.reset_counts()
    with capture if capture is not None else _nothing():
        t0 = time.monotonic()
        loop_in_thread(server)
        wall = time.monotonic() - t0
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    got = dict(tws.RESULT)
    reset_example(spec, tws, WORDSPAN_CONF)
    tm = server._last_device_timings
    # a CPU rehearsal runs the plain versions: they stand for launches
    cuda = EXAMPLES_DEV == "cuda"
    ran = launches if cuda else plain
    check(all(ran[k] > 0 for k in need), f"wordspan {label}: a kernel "
          f"of the path was never launched: {ran}")
    check(not cuda or not any(plain.values()), f"wordspan {label}: plain "
          f"versions ran on the card: {plain}")
    return {"run": label, "sort_impl": sort_impl, "loop_wall_s": wall,
            "compute_s": tm["compute_s"], "upload_s": tm["upload_s"],
            "prepare_s": tm["prepare_s"], "engine_s": tm["engine_s"],
            "device_result_s": tm["result_s"], "write_s": tm["write_s"],
            "retries": tm["retries"], "waves": tm["waves"],
            "unique": len(got), "launches": {k: ran[k] for k in need},
            "plain_calls": 0}, got


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def wordspan_child(cache_dir, files_dir, device):
    """Phase 17 (b) 3, in a process of its own: the P = 1 wordspan run
    with a fresh ``AutoTuner`` on the build directory *cache_dir*;
    prints one JSON line (the result's digest, retries, the controller's
    capacity decision)."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mapreduce_tpu_torch import spec
    from mapreduce_tpu_torch.engine.autotune import AutoTuner
    from mapreduce_tpu_torch.examples import wordspan as tws
    from mapreduce_tpu_torch.obs.compile import LEDGER
    from mapreduce_tpu_torch.obs.control import ControlLedger
    from mapreduce_tpu_torch.ops import kernel_compat as kc
    from mapreduce_tpu_torch.utils import compile_cache

    global EXAMPLES_DEV
    EXAMPLES_DEV = device
    torch.zeros(1, device=device)  # the context, outside the run
    compile_cache.enable_compile_cache(cache_dir)
    files = sorted(os.path.join(files_dir, f) for f in os.listdir(files_dir))
    ledger = ControlLedger()
    label, n, impl, need, _ = WORDSPAN_PATHS[0]
    line, got = wordspan_run(
        torch, kc, spec, tws, files, n, impl, f"{label}_presized", need,
        autotune=AutoTuner(ledger=ledger, repartition=False))
    decs = ledger.decisions("capacity")
    line.update(digest=span_digest(got), decisions=[
        {k: d.get(k) for k in ("outcome", "evidence", "action", "note")}
        for d in decs], compile=LEDGER.snapshot())
    print(json.dumps({"wordspan_child": line}, default=float))
    return 0


def examples_child(argv, root):
    """A phase-17 subprocess (``cli warmup ...`` or this script's
    ``--wordspan-child``), its output in files under *root*; returns
    its last stdout line's one value, parsed, with the process's wall
    as ``_wall_s``."""
    out_path = os.path.join(root, f"child{len(os.listdir(root))}.out")
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.monotonic()
    with open(out_path, "w") as out, open(out_path + ".err", "w") as err:
        proc = subprocess.Popen([sys.executable, *argv], stdout=out,
                                stderr=err, cwd=here, env=env)
        try:
            rc = proc.wait(timeout=EXAMPLES_CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
            rc = None
    wall = time.monotonic() - t0
    text = open(out_path).read()
    check(rc == 0, f"examples: {' '.join(argv)} exited {rc}: "
          f"{open(out_path + '.err').read()[-3000:]}")
    (doc,) = json.loads(text.strip().splitlines()[-1]).values()
    doc["_wall_s"] = wall
    return doc


def warmup_argv(cache_dir, *extra):
    return ["-m", "mapreduce_tpu_torch.cli", "warmup", "--compile-cache",
            cache_dir, "--sort-impl", "tiered-radix", "--torch-device",
            EXAMPLES_DEV, "--json", *extra]


def native_phase(spec, smi):
    """Phase 17 (c): ``examples/wordcount_native`` through ``Server`` with
    worker threads on a ``dir://`` board and ``shared:`` storage."""
    import tempfile
    import uuid

    from mapreduce_tpu_torch.corpus import N_LINES
    from mapreduce_tpu_torch.corpus import N_WORDS as EUROPARL_WORDS
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.examples import wordcount_native as tnat
    from mapreduce_tpu_torch.obs.compile import LEDGER
    from mapreduce_tpu_torch.server import Server
    from mapreduce_tpu_torch.storage.router import router
    from mapreduce_tpu_torch.worker import spawn_worker_threads

    data = make_corpus(NATIVE_WORDS, NATIVE_WORDS * N_LINES // EUROPARL_WORDS,
                       seed=0)
    want = {w.decode(): c for w, c in Counter(data.split()).items()}
    root = tempfile.mkdtemp(prefix="chip_smoke_native_")
    try:
        dsl = f"shared:{os.path.join(root, 'blobs')}"
        st = router(dsl)
        files = write_line_files(data, NATIVE_BLOBS, root)
        names = []
        for f in files:
            name = os.path.basename(f)
            with open(f, "rb") as fh:
                st.write(name, fh.read().decode())
            names.append(name)
        reset_example(spec, tnat, {"blobs": [], "num_reducers": 15,
                                   "storage": None})
        tnat._handle = None
        params = {r: NATIVE_MODULE for r in ("taskfn", "mapfn", "partitionfn",
                                             "reducefn", "finalfn",
                                             "combinerfn")}
        params["storage"] = dsl
        params["init_args"] = {"blobs": names, "num_reducers": 4,
                               "storage": dsl}
        connstr = f"dir://{os.path.join(root, 'board')}"
        before = (LEDGER.snapshot().get("programs") or {}).get(
            "g++:mr_native", {})
        threads = spawn_worker_threads(connstr, "native", NATIVE_WORKERS)
        server = Server(connstr, "native")
        server.configure(params)
        t0 = time.monotonic()
        stats = loop_in_thread(server)
        wall = time.monotonic() - t0
        for t in threads:
            t.join(timeout=JOB_LOOP_TIMEOUT)
            check(not t.is_alive(), f"native: worker {t.name} did not exit")
        got = dict(tnat.RESULT)
        reset_example(spec, tnat, {"blobs": [], "num_reducers": 15,
                                   "storage": None})
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    check(got == want, "native: RESULT differs from Counter(corpus.split())")
    lib = (LEDGER.snapshot().get("programs") or {}).get("g++:mr_native", {})
    acquired = {o: lib.get(o, 0) - before.get(o, 0)
                for o in ("compiled", "persistent_hit")}
    check(sum(acquired.values()) == 1, f"native: the map jobs did not load "
          f"the g++ library: {lib}")
    line = {"run": "wordcount_native", "card": smi, "words": NATIVE_WORDS,
            "blobs": NATIVE_BLOBS, "workers": NATIVE_WORKERS,
            "unique": len(got), "loop_wall_s": wall,
            "map_jobs": stats["map"]["count"],
            "reduce_jobs": stats["reduce"]["count"],
            "library": {o: n for o, n in acquired.items() if n},
            "counter_equal": True}
    print(json.dumps({"examples": line}), flush=True)
    return line


def examples_phase(torch, kc, seg, rs, data, want, smi):
    """Phase 17: ``examples/wordspan`` on the card at P = 1 and P = 8
    radix, the compile plane in processes, and ``examples/
    wordcount_native`` (the ``examples`` lines).  Returns the wordspan
    runs' launches, the inputs of the P = 1 run's largest segmented
    reduce and the callable-against-codes comparison (for phase 19)."""
    import shutil
    import tempfile

    from mapreduce_tpu_torch import spec
    from mapreduce_tpu_torch.engine.autotune import AutoTuner
    from mapreduce_tpu_torch.examples import wordspan as tws
    from mapreduce_tpu_torch.obs.control import ControlLedger
    from mapreduce_tpu_torch.parallel import shuffle
    from mapreduce_tpu_torch.utils import compile_cache

    t_phase = time.monotonic()
    compare, ws_held = {}, None
    root = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    cache = os.path.join(root, "cache")
    os.makedirs(cache)
    procs = os.path.join(root, "procs")
    os.makedirs(procs)
    out = {}
    try:
        files_dir = os.path.join(root, "files")
        os.makedirs(files_dir)
        files = write_line_files(data, JOB_FILES, files_dir)
        t0 = time.monotonic()
        oracle = span_oracle(data, want)
        oracle_s = time.monotonic() - t0

        # (b) 1-2: warmup into the empty build directory, then again
        cold = examples_child(warmup_argv(cache), procs)
        warm = examples_child(warmup_argv(cache), procs)
        expect = (WARMUP_LIBRARIES if EXAMPLES_DEV == "cuda"
                  else WARMUP_LIBRARIES[-1:])
        for name, doc, outcome in (("first", cold, "compiled"),
                                   ("second", warm, "persistent_hit")):
            libs = doc["libraries"]
            check(sorted(libs) == sorted(expect),
                  f"compile plane: the {name} warmup acquired {sorted(libs)}")
            check(all(v["outcome"] == outcome for v in libs.values()),
                  f"compile plane: the {name} warmup's libraries: {libs}")
        check(all(v["compiler_s"] == 0 for v in warm["libraries"].values()),
              f"compile plane: the second warmup ran a compiler: "
              f"{warm['libraries']}")
        # the span monoid's library, built in phase 1, for (b) 3's process
        # (warmup builds only the word count's)
        src = compile_cache.build_dir()
        monoid_libs = [f for f in os.listdir(src)
                       if f.startswith(kc.MONOID) and f.endswith(".so")]
        for f in monoid_libs:
            shutil.copy2(os.path.join(src, f), cache)

        # (a) wordspan at P = 1 and P = 8 radix at the example's own
        # capacities, in this process, the build directory enabled so
        # that every attempt lands in its registry
        saved = compile_cache.save_state()
        compile_cache.enable_compile_cache(cache)
        try:
            for label, n, impl, need, held_need in WORDSPAN_PATHS:
                with PathInputs(torch, seg, shuffle) as cap:
                    line, got = wordspan_run(
                        torch, kc, spec, tws, files, n, impl, label, need,
                        capture=cap)
                check(got == oracle, f"wordspan {label}: spans differ from "
                      "the host oracle")
                check(line["retries"] >= 1, f"wordspan {label}: the "
                      "example's capacities did not retry")
                line["held"] = hold_path_inputs(torch, seg, rs,
                                                f"wordspan {label}",
                                                cap.inputs, held_need)
                if n == 1:  # phase 19 times both kernels on these rows
                    ws_held = cap.inputs["segreduce"]
                del cap
                line.update(card=smi, words=N_WORDS, files=JOB_FILES,
                            oracle_equal=True)
                print(json.dumps({"examples": {"wordspan": line}}),
                      flush=True)
                out[label] = line
            # the same P = 1 run pre-sized from the registry by a fresh
            # controller, warm like (a)'s: what the retries cost (the
            # callable's buckets carry its capacities, and no replay
            # spec, as the JAX engine's)
            label, n, impl, need, _ = WORDSPAN_PATHS[0]
            ledger = ControlLedger()
            presized, got = wordspan_run(
                torch, kc, spec, tws, files, n, impl, f"{label}_presized",
                need, autotune=AutoTuner(ledger=ledger, repartition=False))
            check(got == oracle and presized["retries"] == 0,
                  f"wordspan: the in-process pre-sized run retried "
                  f"{presized['retries']} times or differs")
            check(len(ledger.decisions("capacity")) == 1, "wordspan: no "
                  "capacity decision for the pre-sized run")
        finally:
            compile_cache.restore_state(saved)
        # each run again with the per-lane codes, outside the registry
        # (which the callable's runs alone pre-size from): the same spans
        for label, n, impl, need, _ in WORDSPAN_PATHS:
            cneed = tuple("segreduce" if k == "segreduce_monoid" else k
                          for k in need)
            cline, cgot = wordspan_run(
                torch, kc, spec, tws, files, n, impl, f"{label}_codes",
                cneed, codes=True)
            check(cgot == oracle, f"wordspan {label}: the codes' spans "
                  "differ from the callable's")
            compare[label] = {
                "callable_equal_codes": True, "oracle_equal": True,
                **{f"{k}_{w}": ln[k] for w, ln in (("callable", out[label]),
                                                   ("codes", cline))
                   for k in ("loop_wall_s", "compute_s", "retries")}}

        # (b) 3: a fresh process pre-sized from the registry
        child = examples_child([os.path.abspath(__file__),
                                "--wordspan-child", cache, files_dir,
                                EXAMPLES_DEV], procs)
        check(child["digest"] == span_digest(oracle), "compile plane: the "
              "pre-sized wordspan differs from the host oracle")
        check(child["retries"] == 0, f"compile plane: the pre-sized run "
              f"retried {child['retries']} times")
        built = {p: v["compiled"] for p, v in (
            child["compile"].get("programs") or {}).items()
            if p.startswith(("nvcc:", "g++:"))}
        check(not any(built.values()), f"compile plane: the pre-sized "
              f"process compiled {built}")
        hits = {p: v.get("persistent_hit", 0) for p, v in (
            child["compile"].get("programs") or {}).items()
            if p.startswith(f"nvcc:{kc.MONOID}")}
        check(EXAMPLES_DEV != "cuda" or (hits and all(hits.values())),
              f"compile plane: the pre-sized process did not load the span "
              f"monoid's library from the build directory: {hits}")
        sources = [d["evidence"]["source"] for d in child["decisions"]]
        check(len(sources) == 1 and "shape_registry" in sources[0],
              f"compile plane: capacity decisions {child['decisions']}")

        # (b) 4: replay every recorded bucket
        replay = examples_child(warmup_argv(cache, "--replay"), procs)
        rows = replay["replay"]
        with open(os.path.join(cache, "mrtpu_shape_registry.json")) as f:
            recorded = json.load(f)["buckets"]
        engine_buckets = {b for b, r in recorded.items()
                          if (r.get("replay") or {}).get("kind")
                          == "device_engine"}
        replayed = {r["bucket"] for r in rows if "seconds" in r}
        check(engine_buckets and engine_buckets <= replayed,
              f"compile plane: replay left {engine_buckets - replayed}")
        # wordspan's buckets: the callable's capacities, no replay spec
        sized = {b for b, r in recorded.items() if "sizing" in r}
        check(sized and all(
            recorded[b]["sizing"]["map_fn"].endswith("wordspan:device_map")
            and "replay" not in recorded[b] for b in sized),
            f"compile plane: wordspan's buckets {sorted(sized)}")
        check(sized <= {r["bucket"] for r in rows if "seconds" not in r},
              f"compile plane: replay did not skip wordspan's buckets: "
              f"{[r for r in rows if r['bucket'] in sized]}")
        check(not any("replay failed" in r.get("skipped", "") for r in rows),
              f"compile plane: {[r for r in rows if 'skipped' in r]}")
        compile_line = {
            "card": smi,
            "cold_compile_s": cold["seconds"],
            "warm_start_s": warm["seconds"],
            "nvcc_s": {k: v["compiler_s"]
                       for k, v in cold["libraries"].items()},
            "first_warmup": {k: v["outcome"]
                             for k, v in cold["libraries"].items()},
            "second_warmup": {k: v["outcome"]
                              for k, v in warm["libraries"].items()},
            "warmup_process_wall_s": [cold["_wall_s"], warm["_wall_s"],
                                      replay["_wall_s"]],
            "presized": {k: child[k] for k in (
                "retries", "loop_wall_s", "compute_s", "engine_s",
                "decisions")},
            "presized_process_wall_s": child["_wall_s"],
            "presized_in_process": {k: presized[k] for k in (
                "retries", "loop_wall_s", "compute_s", "engine_s")},
            "retrying_in_process": {k: out["P1"][k] for k in (
                "retries", "loop_wall_s", "compute_s", "engine_s")},
            "registry_buckets": len(recorded),
            "sizing_buckets": len(sized),
            "replayed": len(replayed),
            "replay_s": sum(r["seconds"] for r in rows if "seconds" in r),
            "oracle_s": oracle_s}
        print(json.dumps({"examples": {"compile_plane": compile_line}},
                         default=float), flush=True)

        # (c) the native word count
        native_phase(spec, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"examples": {"phase_s": time.monotonic() - t_phase}}),
          flush=True)
    return ({label: line["launches"] for label, line in out.items()},
            ws_held, compare)


# -- phase 18: the operator plane, status and diagnosis half ------------------

#: the objectives both processes take; the second must breach
OPERATOR_SLOS = ("submit_first_result:p99:120", "queue_wait:p99:0.000001")
#: seconds the two tasks may take to reach DONE, and the runner to exit
OPERATOR_TIMEOUT = 180
#: the phase's device (a CPU rehearsal of the phase sets "cpu")
OPERATOR_DEV = "cuda"
#: the skewed corpus: words, distinct words, the share of the distinct
#: words that hash to partition 0
SKEW_CORPUS = (4_000_000, 120_000, 0.8)
#: the five kernels of the P = 8 radix path
OPERATOR_KERNELS = SERVICE_KERNELS


def skewed_corpus(n_words, n_vocab, hot, P, seed=0):
    """*n_words* words (9 lowercase letters, 16 to a line) drawn from
    *n_vocab* distinct ones, a *hot* share of which hash to partition 0
    of *P* (``k1 % P``, the tokenizer's first lane), so partition 0
    receives most of the exchange's distinct keys."""
    import numpy as np

    from mapreduce_tpu_torch.ops.tokenize import HASH_A1

    rng = np.random.default_rng(seed)
    L = 9
    cand = rng.integers(97, 123, (n_vocab * P * 2, L), dtype=np.uint8)
    cand = np.unique(cand, axis=0)
    h = np.zeros(len(cand), np.uint64)
    for j in range(L):
        h = (h * np.uint64(HASH_A1) + cand[:, j].astype(np.uint64)
             + np.uint64(1)) & np.uint64(0xFFFFFFFF)
    dest = h % np.uint64(P)
    n_hot = int(n_vocab * hot)
    vocab = np.concatenate([cand[dest == 0][:n_hot],
                            cand[dest != 0][:n_vocab - n_hot]])
    check(len(vocab) == n_vocab, f"skewed corpus: {len(vocab)} words")
    buf = np.full((n_words, L + 1), ord(" "), np.uint8)
    buf[:, :L] = vocab[rng.integers(0, n_vocab, n_words)]
    buf[15::16, L] = ord("\n")
    return buf.tobytes()[:-1]


def prom_values(path, family):
    """``{labels: value}`` of *family* in a Prometheus text file."""
    from mapreduce_tpu_torch.obs.metrics import parse_prometheus

    with open(path, encoding="utf-8") as f:
        parsed = parse_prometheus(f.read())
    return {lk: v for (name, lk), v in parsed.items() if name == family}


def run_cli(argv):
    """``mapreduce_tpu_torch.cli.main(argv)`` in this process (the
    exposition commands import no torch): exit code, stdout, wall s."""
    import contextlib
    import io

    from mapreduce_tpu_torch import cli as tcli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tcli.main(argv)
    wall = time.monotonic() - t0
    check(rc == 0, f"operator: cli {argv[0]} exited {rc}: "
          f"{err.getvalue()[-2000:]}")
    return out.getvalue(), wall


def operator_status(url, token, client, dbs):
    """Phase 18 (b): ``cli status`` and the checks of its text; the
    scrape seconds of ``/statusz``."""
    scrapes = []
    for _ in range(5):
        t0 = time.monotonic()
        snap = client.statusz()
        scrapes.append(time.monotonic() - t0)
    text, wall = run_cli(["status", url, "--auth", token])
    for needle in ("device plane (", "  MFU ", "compile ledger (",
                   "device memory:", "comms (exchange & dataflow):",
                   "  bytes by link: ", "scheduler: ",
                   "serving SLOs (", "telemetry (cluster roll-ups"):
        check(needle in text, f"operator (b): no {needle!r} in status:\n"
              f"{text[-3000:]}")
    check(re.search(r"tenant \S+ p99 queue_wait: .*BREACHING", text),
          f"operator (b): no breached queue_wait objective:\n{text}")
    for db in dbs:
        m = re.search(rf"\[{db}\]  status=\S+.*\n((?:  .*\n)*)", text)
        check(m and re.search(r"  device: \d+ waves .* MFU", m.group(1)),
              f"operator (b): no device line with waves and MFU for "
              f"{db}:\n{text}")
    ex = snap["comms"]["exchange"]
    # one card: every pair is a transpose in HBM; the CPU's plain runs
    # class the off-diagonal pairs host
    links = {"self"} if OPERATOR_DEV == "cuda" else {"self", "host"}
    check(set(ex["bytes_by_link"]) == links,
          f"operator (b): link classes {ex['bytes_by_link']}")
    rows = client.clusterz()["mrtpuCluster"]["metrics"]

    def total(name, db, **want):
        return sum(v for n, labels, v in rows if n == name
                   and labels.get("task") == db
                   and all(labels.get(k) == w for k, w in want.items()))

    comms = {}
    for db in dbs:
        row_bytes = (total("mrtpu_device_partition_bytes", db)
                     / total("mrtpu_device_partition_records", db))
        records = total("mrtpu_exchange_records_total", db)
        by_link = {c: total("mrtpu_comms_bytes_total", db, link=c)
                   for c in ("self", "nvlink", "pcie", "host")}
        check(records > 0 and sum(by_link.values()) == records * row_bytes
              and {c for c, v in by_link.items() if v} == links,
              f"operator (b): {db}: bytes by link {by_link}, records "
              f"{records} x row bytes {row_bytes}")
        comms[db] = {"records": records, "row_bytes": row_bytes,
                     "bytes_by_link": by_link}
    check(sum(ex["bytes_by_link"].values()) == ex["records"] * comms[
        ex["task"]]["row_bytes"], f"operator (b): the comms section's "
        f"bytes {ex['bytes_by_link']} against {comms}")
    return snap, {"scrape_s": statistics.median(scrapes),
                  "scrape_s_all": scrapes, "status_wall_s": wall,
                  "comms": comms, "comms_section_task": ex["task"],
                  "modeled_exchange_s": ex["modeled_exchange_s"],
                  "exchange_frac_of_compute":
                  ex["exchange_frac_of_compute"]}


def operator_diagnose(url, token, dbs):
    """Phase 18 (c): ``cli diagnose --json``."""
    text, wall = run_cli(["diagnose", url, "--json", "--auth", token])
    rep = json.loads(text)
    dev = rep["phases"].get("device") or {}
    check(set(dev) == {"wave_s", "upload_s", "compute_s", "readback_s"}
          and dev["wave_s"] > 0 and dev["compute_s"] > 0,
          f"operator (c): device phases {dev}")
    check(rep["critical_path"].get("window_s", 0) > 0,
          f"operator (c): no device_run window: {rep['critical_path']}")
    flagged = [(s["task"], s["partition"]) for s in rep["skew"]
               if s["plane"] == "device"]
    check((dbs[1], "P00000") in flagged, f"operator (c): the skewed "
          f"task's partition 0 is not flagged: {rep['skew']}")
    check(not [s for s in rep["skew"] if s["task"] == dbs[0]],
          f"operator (c): the uniform task is flagged: {rep['skew']}")
    slo = [e for e in rep["slo"].get("objectives") or []
           if e["objective"] == "queue_wait" and e["breaching"]]
    check(slo, f"operator (c): no breaching queue_wait: {rep['slo']}")
    return {"diagnose_wall_s": wall, "device_phases": dev,
            "window_s": rep["critical_path"]["window_s"],
            "skew": [s for s in rep["skew"] if s["plane"] == "device"],
            "notes": rep["notes"]}


def operator_flight(procs, trace_out):
    """Phase 18 (e): SIGTERM the runner; its flight files."""
    import signal

    from mapreduce_tpu_torch.obs.profile import validate_trace
    from mapreduce_tpu_torch.ops.kernel_compat import KERNELS

    p = procs.procs["runner"]
    t0 = time.monotonic()
    p.send_signal(signal.SIGTERM)
    try:
        rc = p.wait(timeout=OPERATOR_TIMEOUT)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait(timeout=30)
        rc = None
    exit_s = time.monotonic() - t0
    check(rc == 143, f"operator (e): the runner exited {rc}: "
          f"{procs.text('runner', 'err')[-2000:]}")
    check(not os.path.exists(trace_out), "operator (e): a normal trace "
          "export ran on SIGTERM")
    with open(f"{trace_out}.flight.trace.json", encoding="utf-8") as f:
        doc = json.load(f)
    validate_trace(doc)
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    runs = {e["args"]["span_id"]: e for e in spans
            if e["name"] == "device_run"}
    waves = [e for e in spans if e["name"] == "wave"
             and e["args"].get("parent_id") in runs]
    for w in waves:
        r = runs[w["args"]["parent_id"]]
        check(r["ts"] <= w["ts"] + 0.5 and w["ts"] + w["dur"]
              <= r["ts"] + r["dur"] + 0.5, f"operator (e): a wave "
              f"outside its device_run: {w} {r}")
    check(runs and waves, f"operator (e): {len(runs)} device_run and "
          f"{len(waves)} wave spans under them in the flight trace")
    prom = f"{trace_out}.flight.metrics.prom"
    check(prom_values(prom, "mrtpu_exchange_records_total"),
          "operator (e): no mrtpu_exchange_records_total in the flight "
          ".prom")
    fam = ("mrtpu_kernel_launches_total" if OPERATOR_DEV == "cuda"
           else "mrtpu_kernel_plain_calls_total")
    counts = {dict(lk)["kernel"]: int(v)
              for lk, v in prom_values(prom, fam).items()}
    launches = {k: counts.get(k, 0) for k in KERNELS}
    check(all(launches[k] > 0 for k in OPERATOR_KERNELS),
          f"operator (e): the runner launched {launches}")
    plain = {} if OPERATOR_DEV != "cuda" else {
        dict(lk)["kernel"]: v for lk, v in prom_values(
            prom, "mrtpu_kernel_plain_calls_total").items() if v}
    check(not plain, f"operator (e): plain versions ran on the card: "
          f"{plain}")
    return launches, {"exit_code": rc, "sigterm_to_exit_s": exit_s,
                      "flight_spans": len(spans),
                      "device_runs": len(runs), "waves": len(waves),
                      "launches": launches, "plain_calls": 0}


def operator_phase(data, want, smi, service_compute):
    """Phase 18: the operator plane (the ``operator`` lines).  Returns
    the runner process's launches of every kernel."""
    import shutil
    import tempfile
    import uuid

    from mapreduce_tpu_torch.coord.docserver import HttpDocStore
    from mapreduce_tpu_torch.obs.profile import load_bundle
    from mapreduce_tpu_torch.sched.scheduler import SchedulerClient

    t_phase = time.monotonic()
    token = uuid.uuid4().hex
    root = tempfile.mkdtemp(prefix="chip_smoke_operator_")
    procs = NetProcs(root, token, label="operator")
    dbs = ("op_uniform", "op_skewed")
    try:
        skew = skewed_corpus(*SKEW_CORPUS, RADIX_PARTS)
        wants = {dbs[0]: {w.decode(): c for w, c in want.items()},
                 dbs[1]: {w.decode(): c
                          for w, c in Counter(skew.split()).items()}}
        files = {dbs[0]: write_line_files(data, JOB_FILES, tempfile.mkdtemp(
                     prefix="u_", dir=root)),
                 dbs[1]: write_line_files(skew, JOB_FILES, tempfile.mkdtemp(
                     prefix="s_", dir=root))}
        slo = [a for spec in OPERATOR_SLOS for a in ("--slo", spec)]
        # (a) the cluster
        t0 = time.monotonic()
        procs.start("board", "docserver", "--host", "127.0.0.1", "--port",
                    "0", "--max-inflight", "2", *slo)
        addr = procs.wait_line(
            "board", r"job board at http://([\d.]+:\d+)").group(1)
        url = f"http://{addr}"
        trace_out = os.path.join(root, "runner.trace.json")
        procs.start("runner", "runner", url, "--partitions",
                    str(RADIX_PARTS), "--torch-device", OPERATOR_DEV,
                    "--max-inflight", "2", "--workers", "2",
                    "--telemetry-interval", "0.5", "--trace-out",
                    trace_out, *slo)
        procs.wait_line("runner", r"runner serving", timeout=120)
        start_s = time.monotonic() - t0
        sched = SchedulerClient(addr, auth_token=token)
        client = HttpDocStore(addr, auth_token=token)
        try:
            t0 = time.monotonic()
            ids = {db: sched.submit(
                db.replace("_", "-"), db=db, est_jobs=1,
                params=service_params(files[db], "radix",
                                      f"shared:{os.path.join(root, db)}"),
            )["_id"] for db in dbs}
            while True:
                docs = {d["_id"]: d for d in sched.list()["tasks"]}
                states = {db: docs[i]["state"] for db, i in ids.items()}
                if all(st == "DONE" for st in states.values()):
                    break
                check(all(st in ("QUEUED", "ADMITTED", "RUNNING", "DONE")
                          for st in states.values())
                      and time.monotonic() - t0 < OPERATOR_TIMEOUT,
                      f"operator (a): tasks {states}: "
                      f"{procs.text('runner', 'err')[-3000:]}")
                time.sleep(0.1)
            done_s = time.monotonic() - t0
            tasks = {}
            for db in dbs:
                got = result_counts(result_bytes(os.path.join(root, db), db))
                check(got == wants[db], f"operator (a): {db}'s result "
                      "differs from Counter over its files' words")
                dev = client.find_one(f"{db}.task",
                                      {"_id": "unique"})["stats"]["device"]
                tasks[db] = {k: dev.get(k) for k in (
                    "compute_s", "waves", "retries", "upload_s",
                    "readback_s", "mfu", "exchange_records",
                    "exchange_imbalance", "modeled_exchange_s",
                    "exchange_frac_of_compute")}
                tasks[db]["unique"] = len(wants[db])
            time.sleep(1.5)  # the runner's last pushes (0.5 s apart)
            # (b) status, (c) diagnose, (d) profile
            _, status = operator_status(url, token, client, dbs)
            diag = operator_diagnose(url, token, dbs)
            bundle = os.path.join(root, "bundle")
            _, prof_wall = run_cli(["profile", url, "--out", bundle,
                                    "--auth", token])
            b = load_bundle(bundle)
            check(b["statusz"].get("comms") and b.get("diagnosis")
                  and b.get("cluster_trace"),
                  f"operator (d): bundle files {b['manifest']['files']}")
        finally:
            sched.close()
            client.close()
        # (e) the flight recorder
        launches, flight = operator_flight(procs, trace_out)
        line = {"run": "cluster", "card": smi, "start_s": start_s,
                "submit_to_both_done_s": done_s, "tasks": tasks,
                "service_compute_s": service_compute, **status,
                "profile_wall_s": prof_wall,
                "bundle_files": b["manifest"]["files"]}
        print(json.dumps({"operator": line}, default=float), flush=True)
        print(json.dumps({"operator": dict(diag, run="diagnose",
                                           card=smi)}, default=float),
              flush=True)
        print(json.dumps({"operator": dict(
            flight, run="flight", card=smi,
            phase_s=time.monotonic() - t_phase)}), flush=True)
    finally:
        procs.reap()
    shutil.rmtree(root, ignore_errors=True)
    return launches



# -- phase 19: callable monoids on the card --------------------------------------

#: the op-level cases of phase 19 (a): testing/monoids.py's monoids at
#: 852,072 rows (phase 3's verify shape), each against its plain ladder,
#: as (name, value lanes): the lane-wise xor also at 5 lanes, after the
#: 5-lane argmin-count (two libraries' kernels at one lane count)
MONOID_CASES = (("sum_min_or", 3), ("xor", 1), ("argmin_count", 5),
                ("xor", 5), ("bits", 8), ("affine", 2))
MONOID_ROWS = 852_072
#: phase 19 (a)'s keys: about 9 rows a run, as the verify shape's
MONOID_KEYS = 95_000
#: the verify path's runs in phase 19 (b): (label, partitions, sort)
VERIFY_PATHS = (("P1", 1, "variadic"), ("P8", RADIX_PARTS, "radix"))
#: phase 19 (c): the session's chunks (numpy seed 19), values a chunk,
#: keys, feeds
MONOID_SESSION = dict(chunks=64, rows=1 << 16, keys=1 << 18, feeds=4)
#: the phase's device (a CPU rehearsal of (b)-(d) sets "cpu")
MONOID_DEV = "cuda"


def monoid_lanes(torch, seg, lanes, n, key_range, seed):
    """Sorted key lanes (one in ten rows invalid) and *lanes* int32 value
    lanes over the whole int32 range, made from numpy seed *seed*, on the
    card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_range, size=(n, 2)).astype(np.uint32)
    valid = torch.from_numpy(rng.random(n) >= 0.1)
    k = torch.from_numpy(keys.view(np.int32).copy())
    k1 = torch.where(valid, k[:, 0], seg.SENTINEL)
    k2 = torch.where(valid, k[:, 1], seg.SENTINEL)
    perm = seg._sort_perm(k1, k2, "variadic")
    vals = torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31, size=(n, lanes), dtype=np.int64).astype(np.int32))
    vals = vals[perm]
    dev = torch.device(MONOID_DEV)
    return (k1[perm].contiguous().to(dev), k2[perm].contiguous().to(dev),
            [vals[:, i].contiguous().to(dev) for i in range(lanes)])


def monoid_case(torch, seg, monoid, label, op, k1s, k2s, vals, codes=None):
    """One monoid kernel case: bit-equal to the plain ladder (reduced
    lanes at run ends, end_csum everywhere), kernel ms (20 calls in one
    CUDA graph), plain ms and the bound.  With *codes*, the codes kernel
    on the same rows: bit-equal to the monoid kernel, and both timed in
    turns (codes, monoid, monoid, codes)."""
    n, d = k1s.numel(), len(vals)

    def call(o):
        return lambda: seg._segment_reduce_cuda(k1s, k2s, vals, o, False)

    got = call(op)()
    want = seg._segment_reduce_plain(k1s, k2s, vals, op, False)
    torch.cuda.synchronize()
    _, _, is_end = seg._run_flags(k1s, k2s)
    check(torch.equal(got[1], want[1]), f"monoid {label}: end_csum")
    err = max_abs_err(torch, got[1], want[1])
    for g, w in zip(got[0], want[0]):
        check(torch.equal(g[is_end], w[is_end]),
              f"monoid {label}: reduced lanes at run ends")
        err = max(err, max_abs_err(torch, g[is_end], w[is_end]))
    ir = monoid.lower(op)
    # bytes: keys 8 + values 4*d in; reduced 4*d + end_csum 4 out.  ops:
    # ~10 compare/flag ops a row and the combine's nodes a row
    ops_per_row = 10 + len(ir.nodes) * (d if ir.lanes is None else 1)
    b_ms, b_by = bound(n * (8 + 8 * d + 4), n * ops_per_row)
    case = {"label": label, "n": n, "lanes": d, "runs": int(is_end.sum()),
            "ir_nodes": len(ir.nodes), "max_abs_err": err,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    if codes is None:
        case["ms"], case["spread"] = kernel_ms(torch, call(op))
    else:
        other = call(codes)()
        torch.cuda.synchronize()
        check(torch.equal(other[1], got[1]) and all(
            torch.equal(a[is_end], b[is_end])
            for a, b in zip(other[0], got[0])),
            f"monoid {label}: the callable and the codes kernel differ")
        turns = [kernel_ms(torch, call(o))[0]
                 for o in (codes, op, op, codes)]
        case.update(codes=list(codes), codes_equal=True,
                    ms=statistics.median(turns[1:3]),
                    codes_ms=statistics.median([turns[0], turns[3]]),
                    turns_ms=turns)
    case["plain_ms"] = time_ms(torch, lambda: seg._segment_reduce_plain(
        k1s, k2s, vals, op, False), reps=3, rounds=3)
    print(json.dumps({"monoid_case": case}), flush=True)
    return case


def monoid_map_fn(chunk, chunk_index, cfg):
    """Phase 19 (c)'s records: keys (c % 65521, c % 7) of each chunk
    value c, value lanes [c % 101 + 1, c * 7919 - 40000, c & 0x5A5] for
    ``(sum, min, bitwise_or)``, payload a function of the key."""
    import torch

    c = chunk.to(torch.int64)
    k1 = (c % 65521).to(torch.int32)
    k2 = (c % 7).to(torch.int32)
    vals = torch.stack([c % 101 + 1, c * 7919 - 40_000, c & 0x5A5],
                       dim=-1).to(torch.int32)
    return (torch.stack([k1, k2], dim=-1), vals, (k1 * 7 + k2)[:, None],
            (c % 11) != 0, torch.zeros((), dtype=torch.int32))


def monoid_session_oracle(chunks):
    """``{(k1, k2): [sum, min, or]}`` of :func:`monoid_map_fn`'s records,
    with numpy (the sum wraps as int32)."""
    import numpy as np

    c = chunks.reshape(-1).astype(np.int64)
    c = c[c % 11 != 0]
    key = (c % 65521) * 7 + c % 7
    order = np.argsort(key, kind="stable")
    key, c = key[order], c[order]
    starts = np.flatnonzero(np.concatenate(([True], key[1:] != key[:-1])))
    v1 = np.add.reduceat(c % 101 + 1, starts)
    v2 = np.minimum.reduceat(c * 7919 - 40_000, starts)
    v3 = np.bitwise_or.reduceat(c & 0x5A5, starts)
    wrap = ((v1 + 2 ** 31) % 2 ** 32) - 2 ** 31
    return {(int(k // 7), int(k % 7)): [int(a), int(b), int(o)]
            for k, a, b, o in zip(key[starts], wrap, v2, v3)}


def monoid_snapshot_dict(snap):
    keys = snap.keys.cpu().reshape(-1, 2).tolist()
    vals = snap.values.cpu().reshape(-1, 3).tolist()
    valid = snap.valid.cpu().reshape(-1).tolist()
    return {tuple(k): v for k, v, ok in zip(keys, vals, valid) if ok}


def monoid_session(torch, kc, monoids, smi):
    """Phase 19 (c): an ``EngineSession`` at P = 1 with the ``(sum, min,
    bitwise_or)`` monoid: fed in feeds, a snapshot against the host
    oracle after each, then an evict to ``mem:`` storage and the lazy
    restore, bit-equal."""
    import numpy as np

    from mapreduce_tpu_torch.engine import session as smod
    from mapreduce_tpu_torch.engine import spill
    from mapreduce_tpu_torch.engine.device_engine import EngineConfig
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.storage.router import router

    ms = MONOID_SESSION
    chunks = np.random.default_rng(19).integers(
        0, ms["keys"], size=(ms["chunks"], ms["rows"])).astype(np.int32)
    cfg = EngineConfig(local_capacity=1 << 19, exchange_capacity=1 << 19,
                       out_capacity=1 << 19, tile=512, tile_records=512,
                       reduce_op=monoids.sum_min_or)
    store = spill.SessionSpillStore(router("mem:chip-smoke-monoid"))
    sess = smod.EngineSession(Partitions(1, MONOID_DEV), monoid_map_fn, cfg,
                              k=ms["chunks"] // ms["feeds"], spill=store)
    per = ms["chunks"] // ms["feeds"]
    kc.reset_counts()
    feed_s = []
    for f in range(ms["feeds"]):
        t0 = time.monotonic()
        check(sess.feed(chunks[f * per:(f + 1) * per], task="m") == 0,
              "monoid session: a feed overflowed")
        feed_s.append(time.monotonic() - t0)
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    snap = sess.snapshot("m")
    got = monoid_snapshot_dict(snap)
    check(got == monoid_session_oracle(chunks), "monoid session: the "
          "snapshot differs from the host oracle")
    sess.evict("m")
    restored = sess.snapshot("m")
    check(all(torch.equal(getattr(restored, f), getattr(snap, f))
              for f in ("keys", "values", "payload", "valid")),
          "monoid session: the restored snapshot differs")
    cuda = MONOID_DEV == "cuda"
    ran = launches if cuda else plain
    check(ran["segreduce_monoid"] > 0 and ran["tokenize"] == 0,
          f"monoid session: launches {ran}")
    check(not cuda or not any(plain.values()),
          f"monoid session: plain versions ran on the card: {plain}")
    line = {"run": "session", "card": smi, "records": int(chunks.size),
            "unique": len(got), "feeds": ms["feeds"], "feed_s": feed_s,
            "launches": {"segreduce_monoid": ran["segreduce_monoid"]},
            "oracle_equal": True, "restore_equal": True}
    print(json.dumps({"monoid": line}), flush=True)
    return ran["segreduce_monoid"]


def verify_run(torch, kc, wcmod, Partitions, data, want, label, n_parts,
               impl, op):
    """One ``DeviceWordCount(verify_collisions=True)`` count of *data* with
    monoid *op* (the callable or its codes), warm, counted."""
    from dataclasses import replace

    cfg = replace(wcmod.bench_engine_config(), sort_impl=impl)
    vwc = wcmod.DeviceWordCount(Partitions(n_parts, MONOID_DEV),
                                chunk_len=CHUNK_LEN, config=cfg,
                                verify_collisions=True)
    vwc.config = replace(vwc.config, reduce_op=op)
    vwc.warm()
    # a warm run first: a new engine's first run carries its allocations
    check(vwc.count_bytes(data) == want, f"verify {label}: the warm run "
          "differs from Counter")
    kc.reset_counts()
    tm = {}
    t0 = time.monotonic()
    got = vwc.count_bytes(data, timings=tm)
    wall = time.monotonic() - t0
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    check(got == want, f"verify {label}: counts differ from Counter")
    cuda = MONOID_DEV == "cuda"
    ran = launches if cuda else plain
    callable_op = callable(op)
    check(ran["segreduce_monoid" if callable_op else "segreduce"] > 0
          and ran["tokenize"] > 0, f"verify {label}: launches {ran}")
    check(not callable_op or ran["segreduce"] == 0,
          f"verify {label}: the callable ran on the codes kernel: {ran}")
    if impl == "radix":
        check(ran["radix_onesweep"] > 0 and ran["radix_plan"] > 0,
              f"verify {label}: launches {ran}")
    check(not cuda or not any(plain.values()),
          f"verify {label}: plain versions ran on the card: {plain}")
    return {"run": label, "op": "callable" if callable_op else list(op),
            "sort_impl": impl, "wall_s": wall, "compute_s": tm["compute_s"],
            "waves": tm["waves"], "retries": tm["retries"],
            "counter_equal": True,
            "launches": {k: v for k, v in ran.items() if v}}


def monoid_phase(torch, kc, seg, wcmod, chunks, data, want, ws_held,
                 ws_compare, smi):
    """Phase 19: callable monoids on the card (the ``monoid`` lines).
    Returns the ``kernels`` entry of ``segreduce_monoid``, the codes
    kernel's case on wordspan's local reduce and (b)'s verify runs."""
    from mapreduce_tpu_torch.obs.compile import LEDGER
    from mapreduce_tpu_torch.ops import monoid
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.testing import monoids

    t_phase = time.monotonic()
    libs = list(dict.fromkeys(
        kc.monoid_library(monoid.lower(monoids.MONOIDS[m][0]))
        for m in ("span",) + tuple(m for m, _ in MONOID_CASES)))
    t0 = time.monotonic()
    kc.build_all(names=libs)
    build = {"build_s": time.monotonic() - t0,
             "nvcc_s": {n: kc.BUILD_SECONDS.get(n) for n in libs},
             "ptxas": {n: kc.ptxas_usage(kc.BUILD_LOGS[n])
                       for n in libs if n in kc.BUILD_LOGS}}
    for n, kernels in build["ptxas"].items():
        check(all(u.get("spill_stores") == 0 and u.get("spill_loads") == 0
                  for u in kernels.values()),
              f"ptxas: a monoid kernel of {n} spills: {kernels}")
    print(json.dumps({"monoid": dict(build, run="build", card=smi)}),
          flush=True)

    # (a) the kernel against its plain version, and beside the codes
    cases = []
    dev = torch.device(MONOID_DEV)
    vcfg = wcmod.bench_engine_config()
    keys, vals, _, valid, _ = wcmod._wordcount_map_fn_verify(
        torch.from_numpy(chunks[0]).to(dev), 0, vcfg)
    k1 = torch.where(valid, keys[:, 0], seg.SENTINEL)
    k2 = torch.where(valid, keys[:, 1], seg.SENTINEL)
    perm = seg._sort_perm(k1, k2, "variadic")
    vl = [vals[perm, i].contiguous() for i in range(3)]
    cases.append(monoid_case(
        torch, seg, monoid, "verify/span", monoids.span,
        k1[perm].contiguous(), k2[perm].contiguous(), vl,
        codes=VERIFY_CODES))
    n, (wk1, wk2, wvals, _, _) = ws_held
    cases.append(monoid_case(torch, seg, monoid, "wordspan_local/span",
                             monoids.span, wk1, wk2, wvals,
                             codes=VERIFY_CODES))
    for i, (name, lanes) in enumerate(MONOID_CASES):
        op = monoids.MONOIDS[name][0]
        k1s, k2s, lanes_v = monoid_lanes(torch, seg, lanes, MONOID_ROWS,
                                         MONOID_KEYS, 190 + i)
        cases.append(monoid_case(torch, seg, monoid, f"{name}/{lanes}",
                                 op, k1s, k2s, lanes_v))
    replay_check(torch, "monoid_replay affine",
                 lambda: seg._segment_reduce_cuda(k1s, k2s, lanes_v, op,
                                                  False), MONOID_ROWS)

    # (b) the verify path at full width, callable and codes
    paths = []
    for label, n_parts, impl in VERIFY_PATHS:
        for op in (wcmod.VERIFY_REDUCE_OP, VERIFY_CODES):
            line = verify_run(torch, kc, wcmod, Partitions, data, want,
                              label, n_parts, impl, op)
            line["card"] = smi
            print(json.dumps({"monoid": {"verify": line}}), flush=True)
            paths.append(line)
    print(json.dumps({"monoid": {"wordspan": ws_compare}}), flush=True)

    # (c) a session with the (sum, min, bitwise_or) monoid
    session_launches = monoid_session(torch, kc, monoids, smi)

    # (d) an unsupported callable raises before any launch
    kc.reset_counts()
    try:
        seg._segment_reduce_cuda(wk1, wk2, wvals, torch.gcd, False)
        raised = None
    except NotImplementedError as exc:
        raised = str(exc)
    check(raised is not None and "gcd" in raised,
          f"monoid: torch.gcd did not raise by name ({raised!r})")
    check(kc.LAUNCHES["segreduce_monoid"] == 0,
          "monoid: a launch before the refusal")
    # each monoid library is its own compile-ledger program, loaded by a
    # build: compiled by this process in a fresh checkout, a
    # persistent_hit where its .so is already in the build directory
    # (phase 17's child loads the span's so)
    progs = {p: {o: n for o, n in v.items() if o in (
        "compiled", "persistent_hit", "cached")} for p, v in (
        LEDGER.snapshot().get("programs") or {}).items()
        if p.startswith(f"nvcc:{kc.MONOID}")}
    check(sorted(progs) == sorted(f"nvcc:{n}" for n in libs) and all(
        v.get("compiled") or v.get("persistent_hit")
        for v in progs.values()),
        f"monoid: the compile ledger's monoid programs: {progs}")
    print(json.dumps({"monoid": {"refused": raised[:200], "ledger": progs,
                                 "phase_s": time.monotonic() - t_phase}}),
          flush=True)

    head = cases[0]
    kernel = {"name": "segreduce_monoid", "route": "cuda",
              "source": "mapreduce_tpu_torch/csrc/segreduce.cuh",
              "replaces": "mapreduce_tpu/ops/segscan.py:193",
              "launches": paths[0]["launches"]["segreduce_monoid"],
              "max_abs_err": max(c["max_abs_err"] for c in cases),
              "ms": head["ms"], "plain_ms": head["plain_ms"],
              "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
              "library_ms": None, "codes_ms": head["codes_ms"],
              "cases": {c["label"]: c["ms"] for c in cases},
              "launches_verify": {f"{p['run']}": p["launches"].get(
                  "segreduce_monoid", 0) for p in paths
                  if p["op"] == "callable"},
              "launches_session": session_launches}
    ws = cases[1]
    codes_case = {"n": ws["n"], "lanes": 3, "op": list(VERIFY_CODES),
                  "ms": ws["codes_ms"], "monoid_ms": ws["ms"],
                  "plain_ms": None, "bound_ms": ws["bound_ms"],
                  "bound_by": ws["bound_by"], "library_ms": None}
    return kernel, codes_case, paths


# -- phase 20: the durable telemetry history and the alerting plane ----------

#: the phase's device (a CPU rehearsal of the phase sets "cpu")
HISTORY_DEV = "cuda"
#: the docserver's alert evaluator period, seconds
ALERT_INTERVAL = 0.5
#: evaluator sweeps the restarted docserver runs before the sink is
#: read again
SWEEPS_AFTER_RESTART = 6
#: seconds the alert may take to fire and be delivered
ALERT_TIMEOUT = 60


def history_family():
    """The family the runner counts its kernels in: its launches on the
    card (its plain calls in a CPU rehearsal)."""
    return ("mrtpu_kernel_launches_total" if HISTORY_DEV == "cuda"
            else "mrtpu_kernel_plain_calls_total")


def history_rules():
    """Phase 20's rules: the runner's onesweep kernel ran in the last
    300 s, and phase 18's breached queue_wait objective burns."""
    return (f"onesweep_ran:increase({history_family()}"
            "{kernel=radix_onesweep}[300]):gt:0",
            "queue_wait_burn:burn(queue_wait):gt:1")


def history_increases(url, token):
    """The history's increases over the last hour of the onesweep
    kernel's count and of ``mrtpu_device_waves_total``, through ``cli
    history --json`` (exact integers), and each query's wall."""
    out, walls = {}, {}
    for key, fam, labels in (
            ("radix_onesweep", history_family(),
             ["--label", "kernel=radix_onesweep"]),
            ("device_waves", "mrtpu_device_waves_total", [])):
        text, walls[key] = run_cli(["history", url, "--metric", fam,
                                    *labels, "--range", "3600", "--json",
                                    "--auth", token])
        doc = json.loads(text)
        total = sum(v for s in doc["series"] for _t, v in s["points"])
        check(total == int(total) and total > 0,
              f"history: {fam} increase {total}")
        out[key] = int(total)
    return out, walls


def sink_firings(path, rule):
    """The firing notifications for *rule* the exec sink appended."""
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        docs = [json.loads(line) for line in f if line.strip()]
    return [d for d in docs if d.get("rule") == rule
            and d.get("to") == "firing"]


def alert_state(url, token, rule):
    """``cli alerts --json``: the state of *rule*'s instance, the
    snapshot, and the command's wall."""
    text, wall = run_cli(["alerts", url, "--json", "--auth", token])
    snap = json.loads(text)["snapshot"]
    states = [i["state"] for i in snap["instances"] if i["rule"] == rule]
    return (states[0] if len(states) == 1 else states), snap, wall


def history_phase(data, want, smi):
    """Phase 20: a docserver with the durable history and two alert
    rules, a P = 8 radix runner on the card running phase 18's uniform
    and skewed word counts; the history's increases against the runner's
    own counts, ``top``, the alert fired and delivered once, and all of
    it again after a SIGKILL and a restart of the docserver on the same
    directory (the ``history`` and ``alerts`` lines).  Returns the
    runner's launches of every kernel."""
    import shutil
    import signal
    import tempfile
    import uuid

    from mapreduce_tpu_torch.coord.docserver import HttpDocStore
    from mapreduce_tpu_torch.sched.scheduler import SchedulerClient

    t_phase = time.monotonic()
    token = uuid.uuid4().hex
    root = tempfile.mkdtemp(prefix="chip_smoke_history_")
    procs = NetProcs(root, token, label="history")
    dbs = ("hist_uniform", "hist_skewed")
    hist_dir = os.path.join(root, "hist")
    sink = os.path.join(root, "alerts.ndjson")
    rule = "onesweep_ran"
    try:
        skew = skewed_corpus(*SKEW_CORPUS, RADIX_PARTS)
        wants = {dbs[0]: {w.decode(): c for w, c in want.items()},
                 dbs[1]: {w.decode(): c
                          for w, c in Counter(skew.split()).items()}}
        files = {dbs[0]: write_line_files(data, JOB_FILES, tempfile.mkdtemp(
                     prefix="u_", dir=root)),
                 dbs[1]: write_line_files(skew, JOB_FILES, tempfile.mkdtemp(
                     prefix="s_", dir=root))}
        slo = [a for spec in OPERATOR_SLOS for a in ("--slo", spec)]
        board = ["--history-dir", hist_dir, "--alert-interval",
                 str(ALERT_INTERVAL), "--alert-exec",
                 f"log=sh -c 'cat >> {sink}; echo >> {sink}'", *slo,
                 *[a for r in history_rules() for a in ("--alert", r)]]
        # (a) the cluster and the two tasks
        procs.start("board", "docserver", "--host", "127.0.0.1", "--port",
                    "0", "--max-inflight", "2", *board)
        m = procs.wait_line("board", r"job board at http://([\d.]+):(\d+)"
                            r".*durable history at /queryz.*alerting at "
                            r"/alertz \(2 rule")
        addr = f"{m.group(1)}:{m.group(2)}"
        url = f"http://{addr}"
        trace_out = os.path.join(root, "runner.trace.json")
        procs.start("runner", "runner", url, "--partitions",
                    str(RADIX_PARTS), "--torch-device", HISTORY_DEV,
                    "--max-inflight", "2", "--workers", "2",
                    "--telemetry-interval", "0.5", "--trace-out",
                    trace_out, *slo)
        procs.wait_line("runner", r"runner serving", timeout=120)
        sched = SchedulerClient(addr, auth_token=token)
        client = HttpDocStore(addr, auth_token=token)
        try:
            t0 = time.monotonic()
            ids = {db: sched.submit(
                db.replace("_", "-"), db=db, est_jobs=1,
                params=service_params(files[db], "radix",
                                      f"shared:{os.path.join(root, db)}"),
            )["_id"] for db in dbs}
            while True:
                docs = {d["_id"]: d for d in sched.list()["tasks"]}
                states = {db: docs[i]["state"] for db, i in ids.items()}
                if all(st == "DONE" for st in states.values()):
                    break
                check(all(st in ("QUEUED", "ADMITTED", "RUNNING", "DONE")
                          for st in states.values())
                      and time.monotonic() - t0 < OPERATOR_TIMEOUT,
                      f"history (a): tasks {states}: "
                      f"{procs.text('runner', 'err')[-3000:]}")
                time.sleep(0.1)
            done_s = time.monotonic() - t0
            for db in dbs:
                got = result_counts(result_bytes(os.path.join(root, db), db))
                check(got == wants[db], f"history (a): {db}'s result "
                      "differs from Counter over its files' words")
            # (b) the alert fires and is delivered once
            deadline = time.monotonic() + ALERT_TIMEOUT
            while not sink_firings(sink, rule):
                check(time.monotonic() < deadline, f"history (b): no "
                      f"{rule} notification in {ALERT_TIMEOUT} s: "
                      f"{procs.text('board', 'err')[-2000:]}")
                time.sleep(0.1)
            fired_s = time.monotonic() - t0
            state, snap, alerts_wall = alert_state(url, token, rule)
            check(state == "firing", f"history (b): {rule} is {state}: "
                  f"{snap}")
            # (c) top names a device or kernel family
            top, top_wall = run_cli(["top", url, "--k", "20", "--auth",
                                     token])
            families = sorted(set(re.findall(r"(mrtpu_\w+?)(?:\{|\s|$)",
                                             top)))
            check(any(f.startswith(("mrtpu_device_", "mrtpu_kernel_"))
                      for f in families), f"history (c): top:\n{top}")
        finally:
            sched.close()
            client.close()
        # (d) the runner stops (its flight dump holds its own counts);
        # every push it made is in the history by then
        launches, flight = operator_flight(procs, trace_out)
        prom = f"{trace_out}.flight.metrics.prom"
        own = {"radix_onesweep": launches["radix_onesweep"],
               "device_waves": int(sum(prom_values(
                   prom, "mrtpu_device_waves_total").values()))}
        got, query_walls = history_increases(url, token)
        check(got == own, f"history (d): the history's increases {got}, "
              f"the runner's own counts {own}")
        check(len(sink_firings(sink, rule)) == 1, "history (d): "
              f"{rule} delivered {len(sink_firings(sink, rule))} times")
        client = HttpDocStore(addr, auth_token=token)
        try:
            row = client.statusz()["history"]
        finally:
            client.close()
        # (e) SIGKILL the docserver and restart it on the same port and
        # directory
        p = procs.procs["board"]
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=30)
        t0 = time.monotonic()
        procs.start("board2", "docserver", "--host", "127.0.0.1",
                    "--port", m.group(2), "--max-inflight", "2", *board)
        procs.wait_line("board2", r"job board at http://")
        deadline = time.monotonic() + 30
        while net_status(f"{url}/healthz") != 200:
            check(time.monotonic() < deadline, "history (e): the "
                  "restarted docserver never answered /healthz")
            time.sleep(0.05)
        restart_s = time.monotonic() - t0
        again, restart_walls = history_increases(url, token)
        check(again == own, f"history (e): after the restart the "
              f"history's increases {again}, the runner's {own}")
        time.sleep(SWEEPS_AFTER_RESTART * ALERT_INTERVAL + ALERT_INTERVAL)
        state2, snap2, _ = alert_state(url, token, rule)
        check(state2 == "firing" and snap2["log"]["replayed"] > 0,
              f"history (e): after the restart {rule} is {state2}: "
              f"{snap2}")
        n_fired = len(sink_firings(sink, rule))
        check(n_fired == 1, f"history (e): {rule} delivered {n_fired} "
              "times across the restart")
        print(json.dumps({"history": {
            "run": "cluster", "card": smi, "submit_to_both_done_s": done_s,
            "increases": got, "runner_counts": own,
            "after_restart": again, "query_wall_s": query_walls,
            "query_wall_s_after_restart": restart_walls,
            "top_wall_s": top_wall, "top_families": families,
            "segments": row["segments"], "bytes": row["bytes"],
            "entries": row["entries"], "series": row["series"],
            "procs": row["procs"], "flight": flight}}, default=float),
            flush=True)
        print(json.dumps({"alerts": {
            "run": "cluster", "card": smi, "rule": rule,
            "submit_to_delivered_s": fired_s, "alerts_wall_s": alerts_wall,
            "counts": snap["counts"], "restart_s": restart_s,
            "counts_after_restart": snap2["counts"],
            "log_after_restart": snap2["log"],
            "sweeps_after_restart": SWEEPS_AFTER_RESTART,
            "firing_notifications": n_fired,
            "phase_s": time.monotonic() - t_phase}}, default=float),
            flush=True)
    finally:
        procs.reap()
    shutil.rmtree(root, ignore_errors=True)
    return launches


# -- phase 21: the expert, ring and pipeline paths ---------------------------

#: the phase's device (a CPU rehearsal of the phase sets "cpu")
AXES_DEV = "cuda"
#: (a) the bench transformer with one expert a model rank, its batch, the
#: counted steps and the steps of one captured replay
MOE_EXPERTS = 8
MOE_B, MOE_T, MOE_STEPS, MOE_S = TF_B, TF_T, 5, 4
#: (b) bench_train.bench_longctx: the bench model, loss_block 2048, one
#: 32,768-token sequence, here over RING_PARTS sequence partitions;
#: counted steps; the context and depth of the ring held against its
#: plain versions
RING_CONFIG = dict(TF_CONFIG, loss_block=2048)
RING_T, RING_PARTS, RING_STEPS = 32768, 8, 3
RING_SMALL_T, RING_SMALL_LAYERS = 8192, 2
#: (c) PipelineConfig()'s defaults, its stages and microbatches, SGD steps
#: and the timed steps of each schedule
PIPE_STAGES, PIPE_MICRO, PIPE_STEPS, PIPE_TIMED = 8, 16, 20, 10


def with_plain_flash(fa, fn):
    """``fn()`` with ``ops.flash_attention``'s wrappers swapped for their
    plain versions (which count nothing)."""
    kernels = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)
    fa.flash_fwd, fa.flash_dq, fa.flash_dkv = (
        fa.flash_fwd_plain, fa.flash_dq_plain, fa.flash_dkv_plain)
    try:
        return fn()
    finally:
        fa.flash_fwd, fa.flash_dq, fa.flash_dkv = kernels


def step_from(tmod, tr, p0, toks):
    """One SGD step of *tr* from the state dict *p0*: (loss, state)."""
    params = tmod.Transformer(tr.cfg, device=AXES_DEV)
    params.load_state_dict(p0)
    params, loss = tr.step(params, toks)
    return float(loss), params.state_dict()


def step_errors(a, b, p0):
    """The largest update errors of two one-step results ``(loss,
    state)`` from *p0*: ``|a - b|`` over the norm of b's update, by
    parameter, the 8 largest first."""
    errs = {n: float((a[1][n] - b[1][n]).norm()
                     / (b[1][n] - p0[n]).norm().clamp_min(1e-30))
            for n in p0}
    return dict(sorted(errs.items(), key=lambda kv: -kv[1])[:8])


def held_step(torch, label, a, b, p0, extra=None):
    """Check two one-step results ``(loss, state)`` from *p0* against
    each other at the smoke's step tolerances, after printing them (a
    ``step_check`` line: the losses and the largest update errors) with
    *extra*; returns the numbers."""
    top = step_errors(a, b, p0)
    worst = next(iter(top))
    out = {"loss": a[0], "loss_ref": b[0], "update_rel_err_max":
           top[worst], "update_rel_err_worst": worst}
    print(json.dumps({"step_check": dict(label=label, **out, largest=top,
                                         **(extra or {}))}), flush=True)
    check(math.isfinite(a[0]) and abs(a[0] - b[0]) < STEP_LOSS_ATOL,
          f"{label}: step loss {a[0]} against {b[0]}")
    check(top[worst] < STEP_UPDATE_RTOL, f"{label}: {worst}'s update "
          f"differs by {top[worst]} of its norm")
    return out


def counted_steps(torch, kc, tr, params, toks, n, per_step):
    """*n* SGD steps from the counters' zero: (params, step seconds,
    losses, flash launches, peak bytes); fails unless each flash kernel
    launched *per_step* times a step and no plain version ran."""
    kc.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(n):
        t0 = time.monotonic()
        params, loss = tr.step(params, toks)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        losses.append(float(loss))
    launches = {k: kc.LAUNCHES[k] for k in FLASH_KERNELS}
    plain = dict(kc.PLAIN_CALLS)
    check(all(launches[k] == n * per_step for k in FLASH_KERNELS),
          f"axes: flash launches {launches} over {n} steps, predicted "
          f"{per_step} each a step")
    check(not any(plain.values()), f"axes: plain versions ran: {plain}")
    check(all(math.isfinite(x) for x in losses), f"axes: {losses}")
    return params, times, losses, launches, torch.cuda.max_memory_allocated()


def with_routes(tmod, fn, pinned=None):
    """``(fn(), experts)``: the MoE router (``tmod._route``) records the
    experts of each call during ``fn()``; with *pinned* (such a
    recording), each call takes the recorded experts in order instead of
    its own argmax (its probabilities, so the gates, stay its own)."""
    route = tmod._route
    seen = []

    def recording(flat, w_router):
        probs, expert = route(flat, w_router)
        if pinned is not None:
            expert = pinned[len(seen)]
        seen.append(expert.detach())
        return probs, expert

    tmod._route = recording
    try:
        return fn(), seen
    finally:
        tmod._route = route


def moe_dropped(torch, tmod, params, x, cfg):
    """(tokens past capacity in each MoE layer, the summed aux, the
    routes) of one forward of *params* on *x*."""
    with torch.no_grad():
        (_, aux), routes = with_routes(
            tmod, lambda: tmod.forward_local(params, x, cfg))
    cap = tmod.moe_capacity(cfg, x.numel())
    ranks = torch.arange(cfg.moe_experts, device=x.device)
    dropped = [int((((r[..., None] == ranks).sum(dim=1) - cap)
                    .clamp(min=0)).sum()) for r in routes]
    return dropped, float(aux.sum()), routes


def moe_case(torch, kc, fa, tmod, smi):
    """Phase 21 (a): the bench transformer with MOE_EXPERTS experts on the
    flash path."""
    import numpy as np

    cfg = tmod.TransformerConfig(**TF_CONFIG, moe_experts=MOE_EXPERTS)
    tr = tmod.TransformerTrainer(cfg, learning_rate=TF_LR, seed=0,
                                 device=AXES_DEV, n_model=MOE_EXPERTS)
    check(tr.cfg.flash is True, f"moe: flash {tr.cfg.flash}")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, size=(MOE_B, MOE_T + 1)).astype(
        np.int32)
    params = tr.init_params()
    p0 = {n: t.clone() for n, t in params.state_dict().items()}
    n_params = sum(t.numel() for t in p0.values())
    x, _ = tr.place_batch(toks)

    # step 0 through the kernels against the same step on the plain
    # versions.  The two attentions differ in rounding, and a token whose
    # router logits are that close routes to another expert (and moves
    # the capacity cut of both): a discrete change the tolerances are not
    # for.  So the plain step takes the kernel step's experts (pinned);
    # the tokens routed differently, and the unpinned step's errors, are
    # printed beside it.
    dropped0, _, routes_k = moe_dropped(torch, tmod, params, x, tr.cfg)
    _, _, routes_p = with_plain_flash(
        fa, lambda: moe_dropped(torch, tmod, params, x, tr.cfg))
    changed = [int((a != b).sum()) for a, b in zip(routes_k, routes_p)]
    del params, routes_k, routes_p
    kernel_step, routes = with_routes(
        tmod, lambda: step_from(tmod, tr, p0, toks))
    unpinned = step_errors(kernel_step, with_plain_flash(
        fa, lambda: step_from(tmod, tr, p0, toks)), p0)
    plain_step, _ = with_plain_flash(fa, lambda: with_routes(
        tmod, lambda: step_from(tmod, tr, p0, toks), pinned=routes))
    step0 = held_step(torch, "moe", kernel_step, plain_step, p0,
                      {"routed_differently": changed,
                       "dropped_per_layer": dropped0,
                       "unpinned_largest": unpinned})
    del kernel_step, plain_step, routes

    # moe_experts=1 against the dense model on the same parameters
    tr1 = tmod.TransformerTrainer(tmod.TransformerConfig(
        **TF_CONFIG, moe_experts=1), seed=1, device=AXES_DEV)
    trd = tmod.TransformerTrainer(tmod.TransformerConfig(**TF_CONFIG),
                                  device=AXES_DEV)
    p1 = tr1.init_params()
    pd = tmod.Transformer(trd.cfg, device=AXES_DEV)
    pd.load_state_dict({n: t for n, t in p1.state_dict().items()
                        if not n.endswith("w_router")})
    loss_one = float(tr1.loss(p1, toks))
    loss_dense = float(trd.loss(pd, toks))
    check(abs(loss_one - loss_dense) < 1e-3, f"moe: one expert's loss "
          f"{loss_one}, the dense model's {loss_dense}")
    del p1, pd, tr1, trd

    # S steps as one captured replay against S eager steps
    stoks = rng.integers(0, cfg.vocab, size=(MOE_S, MOE_B, MOE_T + 1))
    a = tmod.Transformer(tr.cfg, device=AXES_DEV)
    a.load_state_dict(p0)
    b = tmod.Transformer(tr.cfg, device=AXES_DEV)
    b.load_state_dict(p0)
    a, replay = tr._train_steps(a, None, *tr.place_batch(stoks))
    eager = [float(tr.step(b, stoks[i])[1]) for i in range(MOE_S)]
    replay = replay.tolist()
    sa, sb = a.state_dict(), b.state_dict()
    bit_equal = replay == eager and same_state(torch, sa, sb)
    replay_diff = {
        "loss_max_abs": max(abs(r - e) for r, e in zip(replay, eager)),
        "param_max_abs": max(float((sa[n] - sb[n]).abs().max())
                             for n in sa)}
    check(replay_diff["loss_max_abs"] < STEP_LOSS_ATOL,
          f"moe: the captured replay's losses {replay}, eager {eager}")
    tr._graph = None
    del a, b, sa, sb

    params = tmod.Transformer(tr.cfg, device=AXES_DEV)
    params.load_state_dict(p0)
    del p0
    params, times, losses, launches, peak = counted_steps(
        torch, kc, tr, params, toks, MOE_STEPS, cfg.n_layers)
    dropped, aux, _ = moe_dropped(torch, tmod, params, x, tr.cfg)
    step_s = statistics.median(times)
    print(json.dumps({"axes_moe": {
        "config": dict(TF_CONFIG, moe_experts=MOE_EXPERTS),
        "n_model": MOE_EXPERTS, "batch": MOE_B, "seq_len": MOE_T,
        "params": n_params, "step0": step0,
        "tokens_routed_differently_plain": changed,
        "dropped_per_layer_step0": dropped0,
        "step0_unpinned_largest": unpinned,
        "tokens": MOE_B * MOE_T,
        "one_expert_loss": loss_one, "dense_loss": loss_dense,
        "replay_steps": MOE_S, "replay_bit_equal": bit_equal,
        "replay_losses": replay, "eager_losses": eager,
        "replay_diff": replay_diff,
        "losses": losses, "step_s": times, "step_s_median": step_s,
        "tokens_per_s": MOE_B * MOE_T / step_s,
        "capacity": tmod.moe_capacity(cfg, MOE_B * MOE_T),
        "dropped_per_layer": dropped, "aux": aux,
        "max_memory_allocated": peak,
        "launches_per_step": {k: v / MOE_STEPS for k, v in launches.items()},
        "plain_calls": dict(kc.PLAIN_CALLS), "card": smi}}), flush=True)
    return launches


def ring_case(torch, kc, fa, tmod, smi):
    """Phase 21 (b): bench_longctx's model and context over RING_PARTS
    sequence partitions, against the flash path."""
    import numpy as np

    cfg = tmod.TransformerConfig(**RING_CONFIG, flash=False)
    tr = tmod.TransformerTrainer(cfg, learning_rate=TF_LR, seed=0,
                                 device=AXES_DEV, n_data=RING_PARTS)
    trf = tmod.TransformerTrainer(tmod.TransformerConfig(**RING_CONFIG),
                                  learning_rate=TF_LR, device=AXES_DEV)
    check(trf.cfg.flash is True, f"ring: flash path {trf.cfg.flash}")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, size=(1, RING_T + 1)).astype(
        np.int32)
    params = tr.init_params()
    p0 = {n: t.clone() for n, t in params.state_dict().items()}
    n_params = sum(t.numel() for t in p0.values())
    del params
    ring_step = step_from(tmod, tr, p0, toks)
    against_flash = held_step(torch, "ring vs flash path", ring_step,
                              step_from(tmod, trf, p0, toks), p0)
    # phase 23 (c) holds the two-rank ring's first step against this one
    PHASE_NUMBERS["ring_step"] = (
        {n: t.cpu() for n, t in p0.items()},
        (ring_step[0], {n: t.cpu() for n, t in ring_step[1].items()}))
    del ring_step

    # the ring through the kernels against the ring on the plain versions
    small = tmod.TransformerTrainer(tmod.TransformerConfig(**dict(
        RING_CONFIG, n_layers=RING_SMALL_LAYERS,
        loss_block=RING_SMALL_T // RING_PARTS), flash=False),
        learning_rate=TF_LR, seed=1, device=AXES_DEV, n_data=RING_PARTS)
    stoks = rng.integers(0, cfg.vocab, size=(1, RING_SMALL_T + 1))
    s0 = {n: t.clone() for n, t in small.init_params().state_dict().items()}
    against_plain = held_step(torch, "ring vs plain versions", step_from(
        tmod, small, s0, stoks), with_plain_flash(fa, lambda: step_from(
            tmod, small, s0, stoks)), s0)
    del s0, small

    params = tmod.Transformer(tr.cfg, device=AXES_DEV)
    params.load_state_dict(p0)
    per_step = RING_PARTS * cfg.n_layers
    params, times, losses, launches, peak = counted_steps(
        torch, kc, tr, params, toks, RING_STEPS, per_step)
    del params
    fparams = tmod.Transformer(trf.cfg, device=AXES_DEV)
    fparams.load_state_dict(p0)
    del p0
    fparams, ftimes, _, _, fpeak = counted_steps(
        torch, kc, trf, fparams, toks, RING_STEPS, cfg.n_layers)
    del fparams
    step_s, fstep_s = statistics.median(times), statistics.median(ftimes)
    flops = tmod.train_flops(cfg, n_params, 1, RING_T)
    print(json.dumps({"axes_ring": {
        "config": RING_CONFIG, "seq_len": RING_T, "n_data": RING_PARTS,
        "params": n_params, "step0_vs_flash_path": against_flash,
        "plain_case": {"seq_len": RING_SMALL_T, "n_layers":
                       RING_SMALL_LAYERS, **against_plain},
        "losses": losses, "step_s": times, "step_s_median": step_s,
        "tokens_per_s": RING_T / step_s, "flops_per_step": flops,
        "mfu": flops / step_s / BF16_FLOPS_PER_S,
        "max_memory_allocated": peak,
        "flash_path_step_s": ftimes, "flash_path_step_s_median": fstep_s,
        "flash_path_mfu": flops / fstep_s / BF16_FLOPS_PER_S,
        "flash_path_max_memory_allocated": fpeak,
        "ring_to_flash_step_ratio": step_s / fstep_s,
        "launches_per_step": {k: v / RING_STEPS for k, v in launches.items()},
        "launches_predicted_per_step": per_step, "card": smi}}), flush=True)
    return launches


def median_step_s(torch, step, n=PIPE_TIMED):
    """Seconds of one *step* (the median of *n*, after a warm one), the
    card synchronised before and after each; and the *n* times."""
    times = []
    for i in range(n + 1):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        if i:
            times.append(time.monotonic() - t0)
    return statistics.median(times), times


def pipeline_batch(np, cfg):
    """Phase 21 (c)'s batch: PIPE_MICRO microbatches (seed 4), the label
    the argmax of the first n_classes inputs."""
    x = np.random.default_rng(4).standard_normal(
        (PIPE_MICRO * cfg.microbatch, cfg.n_in)).astype(np.float32)
    return x, x[:, :cfg.n_classes].argmax(-1)


def pipeline_case(torch, pmod, smi):
    """Phase 21 (c): the pipelined classifier at PipelineConfig()'s
    defaults, PIPE_STAGES stages, PIPE_MICRO microbatches."""
    import numpy as np

    cfg = pmod.PipelineConfig()
    tr = pmod.PipelinedTrainer(cfg, learning_rate=0.1, seed=0,
                               n_stages=PIPE_STAGES, device=AXES_DEV)
    params = tr.init_params()
    x, y = pipeline_batch(np, cfg)
    xd, yd = tr.place_batch(x, y)
    with torch.no_grad():
        got = pmod.pipeline_forward_local(params, xd, cfg).cpu()
    want = torch.from_numpy(pmod.pipeline_reference(params, x, cfg))
    err = float((got - want).abs().max())
    check(bool(((got - want).abs() <= FLASH_TOL["atol"] + FLASH_TOL["rtol"]
                * want.abs()).all()),
          f"pipeline: forward against the sequential stages, max |diff| "
          f"{err}")
    losses = [float(tr.step(params, x, y)[1]) for _ in range(PIPE_STEPS)]
    check(losses[-1] < losses[0], f"pipeline: the loss did not fall: "
          f"{losses}")

    def timed(loss_of):
        """Seconds of one SGD step (median_step_s), *loss_of* giving the
        loss of the current parameters."""
        names = list(params)

        def step():
            for n in names:
                params[n].requires_grad_(True)
            grads = torch.autograd.grad(loss_of(), [params[n] for n in names])
            with torch.no_grad():
                for n, g in zip(names, grads):
                    params[n].requires_grad_(False)
                    params[n].sub_(g * tr.lr)

        return median_step_s(torch, step)[0]

    pipe_s = timed(lambda: pmod.pipeline_loss(params, xd, yd, cfg))
    PHASE_NUMBERS["pipeline_step_s"] = pipe_s
    seq_s = timed(lambda: -pmod.sequential_forward(params, xd, cfg).gather(
        1, yd[:, None]).mean())
    S, M = PIPE_STAGES, PIPE_MICRO
    print(json.dumps({"axes_pipeline": {
        "config": {"n_in": cfg.n_in, "hidden": cfg.hidden,
                   "n_classes": cfg.n_classes,
                   "microbatch": cfg.microbatch, "dtype": str(cfg.dtype)},
        "stages": S, "microbatches": M, "ticks": M + S - 1,
        "forward_max_abs_err": err, "losses": losses,
        "pipelined_step_s": pipe_s, "sequential_step_s": seq_s,
        "pipelined_to_sequential": pipe_s / seq_s,
        "bubble_share": (S - 1) / (M + S - 1), "card": smi}}), flush=True)


def axes_phase(torch, kc, fa, tmod, pmod, smi):
    """Phase 21: the transformer's expert and ring paths and the pipeline
    on the card; returns the flash launches of (a)'s and (b)'s counted
    steps."""
    t_phase = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    moe = moe_case(torch, kc, fa, tmod, smi)
    ring = ring_case(torch, kc, fa, tmod, smi)
    pipeline_case(torch, pmod, smi)
    print(json.dumps({"axes": {"phase_s": time.monotonic() - t_phase}}),
          flush=True)
    return {"moe": moe, "ring": ring}


# -- phase 22: the engine-host fleet and multi-process meshes ------------------

#: bench.py's measure_session_migration at full size: its config and its
#: 8,000-repeat corpus in 4,096-byte shards
MIGRATION_CONFIG = dict(local_capacity=4096, exchange_capacity=2048,
                        out_capacity=4096, tile=512, tile_records=128,
                        combine_in_scan=True, unit_values=True,
                        reduce_op="sum")
MIGRATION_CORPUS = b"migrate gate alpha beta gamma delta " * 8000
MIGRATION_SHARD = 4096
#: bench.py's measure_fleet_sustained at full size: two hosts, each one
#: resident session at P = 1 on the card fed by a thread of its own,
#: SESSION_CONFIG with the exchange capacity at the local capacity
#: (131,072: one partition routes every local unique to itself, which
#: the bench's 1<<15 a pair cannot hold; the capacity phase 15 (b)'s
#: controller learns), 1<<20-byte chunks of a 1.5M-word corpus, 3 rounds
FLEET_HOSTS = ("bench-h0", "bench-h1")
FLEET_ROUNDS = 3
#: the kill-a-host case (tests/test_fleet_chaos.py's bound): the victim's
#: host lease, the spills it must commit before the SIGKILL, the re-home
#: bound (lease + 2 s) and the seconds the victim may take to get there
FLEET_LEASE = 1.0
FLEET_KILL_AFTER = 4
FLEET_REHOME_SLACK = 2.0
FLEET_TIMEOUT = 300
#: streams routed at runner A before `cli drain` takes it out
DRAIN_STREAMS = 3
#: the two controllers of (e): the world size and the seconds a gloo
#: collective may wait before it fails by name
MESH_WORLD = 2
MESH_GROUP_TIMEOUT = 300
#: the bench_train MLP's one step over the group: n_data 8 at bunch 128
MESH_N_DATA = 8
MESH_LOSS_RTOL = 1e-5
#: bf16 products (the bench's dtype) sum the two halves' gradients and
#: losses in another order than one batch: held only to bf16's rounding
MESH_BF16_LOSS_RTOL = 1e-2
#: the updated parameters against the one-process step's, by leaf (max
#: abs): on the H100 a sound step differs by at most 1.5e-8 (f32) and
#: 1.2e-6 (bf16), a step whose gradients are not all-reduced by at least
#: 2.6e-5 in every leaf (PERF.md, PR 22)
MESH_PARAM_ATOL = {"f32": 1e-6, "bf16": 5e-6}
MESH_TEXT = ("the quick brown fox jumps over the lazy dog " * 40
             + "pack my box with five dozen liquor jugs " * 25)

#: numbers earlier phases leave for phase 22 to print beside its own
PHASE_NUMBERS = {}


def free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def fleet_session_config(wcmod):
    """The victim's session config: the flagship config on the radix
    path (phase 8 (b)'s, without its partition map)."""
    from dataclasses import replace

    return replace(wcmod.bench_engine_config(), sort_impl="radix")


def migration_case(torch, kc, seg, rs, wcmod, Partitions):
    """Phase 22 (a): bench.py's measure_session_migration at full size on
    ``Partitions(8)``, radix: the clock runs from the evict on the source
    to the first snapshot on the destination (spill, guarded route flip,
    lazy restore, readback); the destination's snapshot bit-equal to the
    source's before the move, the route flipped, one ``fleet``
    decision."""
    from dataclasses import replace

    from mapreduce_tpu_torch.coord.docstore import MemoryDocStore
    from mapreduce_tpu_torch.coord.fleet import FleetMember, FleetRegistry
    from mapreduce_tpu_torch.engine.device_engine import EngineConfig
    from mapreduce_tpu_torch.engine.migrate import migrate
    from mapreduce_tpu_torch.engine.session import EngineSession
    from mapreduce_tpu_torch.engine.spill import SessionSpillStore
    from mapreduce_tpu_torch.obs import control
    from mapreduce_tpu_torch.ops.tokenize import shard_text
    from mapreduce_tpu_torch.parallel import shuffle
    from mapreduce_tpu_torch.storage import MemoryStorage

    cfg = replace(EngineConfig(**MIGRATION_CONFIG), sort_impl="radix")
    corpus = MIGRATION_CORPUS
    chunks, _ = shard_text(corpus, max(1, len(corpus) // MIGRATION_SHARD),
                           pad_multiple=512, pad_to=MIGRATION_SHARD + 512)
    board = MemoryDocStore()
    reg = FleetRegistry(board)
    hosts = [FleetMember(board, host_id=h) for h in ("bench-a", "bench-b")]
    for m in hosts:
        m.join(timeout=5.0, warm_programs=["wordcount"], hbm_frac=0.2)
    spill = SessionSpillStore(MemoryStorage())
    task = "migration-bench"
    parts = Partitions(RADIX_PARTS, "cuda")
    src = EngineSession(parts, wcmod._wordcount_map_fn, cfg, task=task,
                        spill=spill)
    dst = EngineSession(parts, wcmod._wordcount_map_fn, cfg, task=task,
                        spill=spill)
    reg.assign(task, "bench-a", program="wordcount")
    kc.reset_counts()
    with PathInputs(torch, seg, shuffle) as cap:
        src.feed(chunks)
        before = src.snapshot()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        moved = migrate(task, src, dst, registry=reg, src_host="bench-a",
                        dst_host="bench-b", reason="explicit")
        after = dst.snapshot()
        migration_s = time.monotonic() - t0
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    check_launches(launches, plain, "fleet (a)", True)
    held = hold_path_inputs(torch, seg, rs, "fleet (a)", cap.inputs,
                            ["segreduce", "radix_sort", "radix_plan"])
    route = reg.route(task)
    check(route and route["host"] == "bench-b", f"fleet (a): route {route}")
    for f in ("keys", "values", "payload", "valid"):
        check(torch.equal(getattr(after, f), getattr(before, f)),
              f"fleet (a): the migrated snapshot differs in {f}")
    check(wcmod.materialize_counts(chunks, after)
          == Counter(corpus.split()), "fleet (a): counts differ from "
          "Counter")
    dec = control.LEDGER.decisions(controller="fleet", task=task)[-1]
    check("bench-a -> bench-b" in dec["note"], f"fleet (a): {dec}")
    src.close(drop_spill=False)
    dst.close()
    for m in hosts:
        m.leave()
    PHASE_NUMBERS["session_migration_s"] = migration_s
    out = {"session_migration_s": migration_s, "spill_s": moved["spill_s"],
           "chunks": int(chunks.shape[0]), "partitions": RADIX_PARTS,
           "bit_equal": True, "routed": moved["routed"],
           "decision": dec["note"], "launches": launches,
           "plain_calls": plain, "held": held}
    print(json.dumps({"fleet_migration": out}), flush=True)
    return launches


def fleet_sustained_case(torch, kc, seg, wcmod, Partitions):
    """Phase 22 (b): bench.py's measure_fleet_sustained at full size: two
    fleet hosts in this process, each a resident session on the card fed
    by its own thread; records/s folded across both over the concurrent
    window (a stream that overflowed gives no number: it fails),
    printed beside phase 8's one-host rate.  Both hosts share the one
    card, so no gain is expected and none is asserted."""
    import threading
    from dataclasses import replace

    import numpy as np

    from mapreduce_tpu_torch.coord.docstore import MemoryDocStore
    from mapreduce_tpu_torch.coord.fleet import (
        FleetMember, FleetRegistry, fleet_snapshot)
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.engine.device_engine import EngineConfig
    from mapreduce_tpu_torch.engine.session import EngineSession
    from mapreduce_tpu_torch.ops.tokenize import shard_text
    from mapreduce_tpu_torch.parallel import shuffle

    cfg = EngineConfig(**SESSION_CONFIG)
    cfg = replace(cfg, exchange_capacity=cfg.local_capacity)
    board = MemoryDocStore()
    reg = FleetRegistry(board)
    members = [FleetMember(board, host_id=h) for h in FLEET_HOSTS]
    for m in members:
        m.join(timeout=5.0, warm_programs=["wordcount"], hbm_frac=0.3)
    corpus = make_corpus(SESSION_WORDS, max(SESSION_WORDS // 25, 1))
    want = Counter(corpus.split())
    chunks, _ = shard_text(corpus, -(-len(corpus) // SESSION_CHUNK_LEN),
                           pad_multiple=cfg.tile,
                           pad_to=SESSION_CHUNK_LEN + cfg.tile)
    sessions = []
    for h in FLEET_HOSTS:
        sess = EngineSession(Partitions(1, "cuda"),
                             wcmod._wordcount_map_fn, cfg, task=f"fleet-{h}")
        row_bytes = max(1, chunks.nbytes // len(chunks))
        sess.k = max(1, min(sess.engine._rows_per_wave(row_bytes),
                            len(chunks)))
        sess.feed(chunks[:1], task="warm")
        sess.snapshot("warm")
        sess.close("warm")
        reg.assign(f"tenant-{h}", h, program="wordcount")
        sessions.append(sess)
    snap = fleet_snapshot(board)
    check(len(snap.get("hosts", {})) == len(FLEET_HOSTS)
          and all(h["state"] == "live" for h in snap["hosts"].values()),
          f"fleet (b): {snap}")

    def total(sess, t):
        s = sess.snapshot(t)
        check(s.overflow == 0, f"fleet (b): stream {t} overflowed "
              f"{s.overflow} rows: no number from it")
        return int(s.values[s.valid].sum())

    errors = []

    def serve(sess, t, n):
        try:
            for _ in range(n):
                sess.feed(chunks, task=t)
        except BaseException as exc:  # raised again in the caller
            errors.append(exc)

    def concurrent(n):
        threads = [threading.Thread(target=serve,
                                    args=(sess, f"tenant-{h}", n))
                   for h, sess in zip(FLEET_HOSTS, sessions)]
        t0 = time.monotonic()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=FLEET_TIMEOUT)
        check(not any(th.is_alive() for th in threads),
              "fleet (b): a feeder thread hangs")
        if errors:
            raise errors[0]
        return time.monotonic() - t0

    for h, sess in zip(FLEET_HOSTS, sessions):
        sess.feed(chunks, task=f"tenant-{h}")
    concurrent(1)  # the first time both hosts feed at once, untimed
    before = [total(sess, f"tenant-{h}")
              for h, sess in zip(FLEET_HOSTS, sessions)]
    kc.reset_counts()
    with PathInputs(torch, seg, shuffle) as cap:
        wall = concurrent(FLEET_ROUNDS)
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    check_launches(launches, plain, "fleet (b)", False)
    held = hold_path_inputs(torch, seg, None, "fleet (b)", cap.inputs,
                            ["segreduce"])
    del cap
    records = 0
    for h, sess, b in zip(FLEET_HOSTS, sessions, before):
        t = f"tenant-{h}"
        records += total(sess, t) - b
        n = 2 + FLEET_ROUNDS
        # a word's representative offset counts over all n feeds' chunks
        got = wcmod.materialize_counts(np.concatenate([chunks] * n),
                                       sess.snapshot(t))
        check(got == {w: c * n for w, c in want.items()},
              f"fleet (b): {t}'s counts differ from Counter x {n}")
        sess.close()
    for m in members:
        m.leave()
    check(records == len(FLEET_HOSTS) * FLEET_ROUNDS * sum(want.values()),
          f"fleet (b): {records} records folded in the window")
    one_host = PHASE_NUMBERS.get("sustained_p1_records_per_s")
    out = {"fleet_sustained_records_per_s": records / wall,
           "fleet_sustained_hosts": len(FLEET_HOSTS),
           "fleet_sustained_records": records,
           "fleet_sustained_wall_s": wall,
           "fleet_sustained_rounds": FLEET_ROUNDS,
           "partitions": 1, "exchange_capacity": cfg.exchange_capacity,
           "phase8_one_host_records_per_s": one_host,
           "aggregate_over_one_host": (records / wall / one_host
                                       if one_host else None),
           "launches": launches, "plain_calls": plain, "held": held}
    print(json.dumps({"fleet_sustained": out}), flush=True)
    return launches


def fleet_victim(connstr, spill_dir, host_id, lease, chunks_path):
    """``chip_smoke.py --fleet-victim``: phase 22 (c)'s engine host.
    Joins the fleet, routes ``live`` here, then feeds the smoke corpus's
    chunks one at a time on ``Partitions(8)`` radix with a spill after
    each; its kernels are held against their plain versions on the first
    feed's largest inputs.  Progress (the path's launches, its plain
    calls, the libraries it built) is written after each spill commits;
    it idles heartbeating once the stream is fed, until SIGKILLed."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mapreduce_tpu_torch.coord import docstore
    from mapreduce_tpu_torch.coord.fleet import FleetMember, FleetRegistry
    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from mapreduce_tpu_torch.engine.session import EngineSession
    from mapreduce_tpu_torch.engine.spill import SessionSpillStore
    from mapreduce_tpu_torch.ops import kernel_compat as kc
    from mapreduce_tpu_torch.ops import radix_sort as rs
    from mapreduce_tpu_torch.ops import segscan as seg
    from mapreduce_tpu_torch.parallel import shuffle
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.storage.localdir import LocalDirStorage

    chunks = np.load(chunks_path)
    store = docstore.connect(connstr)
    member = FleetMember(store, host_id=host_id, lease=float(lease))
    member.join(timeout=30.0, warm_programs=["wave"], hbm_frac=0.2)
    FleetRegistry(store).assign("live", host_id, program="wave")
    sess = EngineSession(Partitions(RADIX_PARTS, "cuda"),
                         wcmod._wordcount_map_fn,
                         fleet_session_config(wcmod), task="live", k=1,
                         spill=SessionSpillStore(LocalDirStorage(spill_dir)))
    held, extra = None, {}
    for i in range(chunks.shape[0]):
        member.heartbeat(warm_programs=["wave"], hbm_frac=0.2)
        if held is None:
            with PathInputs(torch, seg, shuffle) as cap:
                sess.feed(chunks[i:i + 1])
        else:
            sess.feed(chunks[i:i + 1])
        step = sess.spill_stream()
        if held is None:
            # the comparison's launches are not the path's
            before = dict(kc.LAUNCHES)
            held = hold_path_inputs(torch, seg, rs, "fleet (c) victim",
                                    cap.inputs, ["segreduce", "radix_sort",
                                                 "radix_plan"])
            extra = {k: kc.LAUNCHES[k] - before[k] for k in kc.LAUNCHES}
            del cap
        store.update("__chaos__.progress", {"_id": host_id}, {"$set": {
            "spilled_chunks": i + 1, "step": step,
            "launches": {k: v - extra.get(k, 0)
                         for k, v in kc.LAUNCHES.items()},
            "plain_calls": dict(kc.PLAIN_CALLS),
            "built": sorted(kc.BUILD_LOGS), "held": held}}, upsert=True)
    while True:
        member.heartbeat(warm_programs=["wave"], hbm_frac=0.2)
        time.sleep(0.1)


def kill_host_case(torch, kc, wcmod, Partitions, chunks, root):
    """Phase 22 (c): the port's tests/test_fleet_chaos.py at full size on
    the card: a spare joins, the victim process feeds and spills, is
    SIGKILLed after FLEET_KILL_AFTER spills; ``recovery_sweep`` re-homes
    the stream within the lease plus FLEET_REHOME_SLACK; a fresh session
    restores it, bit-equal to an uninterrupted stream over the committed
    prefix and equal to Counter over those chunks; the migration counter
    and the ledger's ``fleet`` decision name the move."""
    import signal

    import numpy as np

    from mapreduce_tpu_torch.coord import docstore
    from mapreduce_tpu_torch.coord.fleet import FleetMember, FleetRegistry
    from mapreduce_tpu_torch.engine.autotune import AdmissionAdvisor
    from mapreduce_tpu_torch.engine.session import EngineSession
    from mapreduce_tpu_torch.engine.spill import SessionSpillStore
    from mapreduce_tpu_torch.obs import control
    from mapreduce_tpu_torch.obs.metrics import REGISTRY
    from mapreduce_tpu_torch.sched.scheduler import Scheduler
    from mapreduce_tpu_torch.storage.localdir import LocalDirStorage

    board_dir = os.path.join(root, "board")
    spill_dir = os.path.join(root, "spill")
    os.makedirs(board_dir)
    os.makedirs(spill_dir)
    chunks_path = os.path.join(root, "chunks.npy")
    np.save(chunks_path, chunks)
    connstr = f"dir://{board_dir}"
    out_f = open(os.path.join(root, "victim.out"), "w")
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--fleet-victim",
         connstr, spill_dir, "victim", str(FLEET_LEASE), chunks_path],
        stdout=out_f, stderr=subprocess.STDOUT)
    out_f.close()
    spare = None
    try:
        store = docstore.connect(connstr)
        reg = FleetRegistry(store)
        spare = FleetMember(store, host_id="spare", lease=60.0)
        spare.join(timeout=10.0, warm_programs=["wave"], hbm_frac=0.1)
        t0 = time.monotonic()
        while True:
            prog = store.find_one("__chaos__.progress",
                                  {"_id": "victim"}) or {}
            if prog.get("spilled_chunks", 0) >= FLEET_KILL_AFTER:
                break
            check(child.poll() is None and time.monotonic() - t0
                  < FLEET_TIMEOUT, "fleet (c): the victim never spilled "
                  f"{FLEET_KILL_AFTER} chunks: "
                  + open(os.path.join(root, "victim.out")).read()[-3000:])
            spare.heartbeat(warm_programs=["wave"], hbm_frac=0.1)
            time.sleep(0.05)
        victim_ready_s = time.monotonic() - t0
        t_kill = time.monotonic()
        os.kill(child.pid, signal.SIGKILL)
        child.wait(timeout=30)
        sched = Scheduler(store, use_lease=False,
                          advisor=AdmissionAdvisor(), fleet=reg)
        m0 = REGISTRY.sum("mrtpu_session_migrations_total", task="live",
                          reason="recovery")
        deadline = time.monotonic() + FLEET_LEASE + 5.0
        while True:
            spare.heartbeat(warm_programs=["wave"], hbm_frac=0.1)
            moves = sched.recovery_sweep()
            if moves:
                break
            check(time.monotonic() < deadline, "fleet (c): the recovery "
                  "sweep never re-homed the stream")
            time.sleep(0.05)
        recovered_s = time.monotonic() - t_kill
        check(moves == [("live", "spare")], f"fleet (c): moves {moves}")
        check(recovered_s <= FLEET_LEASE + FLEET_REHOME_SLACK,
              f"fleet (c): re-home took {recovered_s:.2f} s (lease "
              f"{FLEET_LEASE} s)")
        check(reg.route("live")["host"] == "spare", "fleet (c): route")
        doc = next(d for d in reg.hosts() if d["_id"] == "victim")
        check(doc.get("holder") is None, "fleet (c): victim not reaped")
        # the stream is servable now, from the last committed spill
        cfg = fleet_session_config(wcmod)
        kc.reset_counts()
        t0 = time.monotonic()
        dst = EngineSession(Partitions(RADIX_PARTS, "cuda"),
                            wcmod._wordcount_map_fn, cfg, task="live", k=1,
                            spill=SessionSpillStore(
                                LocalDirStorage(spill_dir)))
        got = dst.snapshot("live")
        restore_s = time.monotonic() - t0
        pos = dst.stats("live")["chunks"]
        check(pos >= FLEET_KILL_AFTER, f"fleet (c): restored {pos} chunks")
        ref = EngineSession(Partitions(RADIX_PARTS, "cuda"),
                            wcmod._wordcount_map_fn, cfg, task="ref", k=1)
        for i in range(pos):
            ref.feed(chunks[i:i + 1])
        want_snap = ref.snapshot("ref")
        launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
        check_launches(launches, plain, "fleet (c) restore", True)
        for f in ("keys", "values", "payload", "valid"):
            check(torch.equal(getattr(got, f), getattr(want_snap, f)),
                  f"fleet (c): the restored stream differs in {f} from "
                  f"an uninterrupted one over {pos} chunks")
        check(wcmod.materialize_counts(chunks[:pos], got)
              == Counter(chunks[:pos].tobytes().split()),
              "fleet (c): the restored counts differ from Counter")
        dst.close(drop_spill=False)
        ref.close()
        check(REGISTRY.sum("mrtpu_session_migrations_total", task="live",
                           reason="recovery") - m0 == 1,
              "fleet (c): the migration was not counted once")
        decs = [d["note"] for d in control.LEDGER.decisions(
            controller="fleet", task="live")]
        check(any("victim to spare" in n for n in decs),
              f"fleet (c): no ledger decision names the move: {decs}")
        victim = {"launches": prog["launches"],
                  "plain_calls": prog["plain_calls"],
                  "built": prog["built"], "held": prog["held"]}
        check_launches(victim["launches"], victim["plain_calls"],
                       "fleet (c) victim", True)
        check(not victim["built"], f"fleet (c): the victim ran nvcc for "
              f"{victim['built']}")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
        if spare is not None:
            spare.leave()
    out = {"lease_s": FLEET_LEASE, "victim_ready_s": victim_ready_s,
           "spilled_before_kill": prog["spilled_chunks"],
           "rehome_s": recovered_s, "restore_snapshot_s": restore_s,
           "restored_chunks": pos, "bit_equal": True, "victim": victim,
           "restore_launches": launches}
    print(json.dumps({"fleet_kill": out}), flush=True)
    return victim["launches"]


def drain_case(root, smi):
    """Phase 22 (d): a docserver and two runners on the card; three
    streams routed at runner A; ``cli drain A``: A sees the flag, steps
    down and exits 0, its streams are on B, ``status`` shows A left and
    ``diagnose`` names the drain migrations.  The runners run no task
    here (their kernels run in phases 14, 18 and 20)."""
    import signal
    import socket
    import uuid

    from mapreduce_tpu_torch.coord.docserver import HttpDocStore
    from mapreduce_tpu_torch.coord.fleet import FleetRegistry, host_state
    from mapreduce_tpu_torch.coord.docstore import now

    token = uuid.uuid4().hex
    procs = NetProcs(root, token, label="fleet (d)")
    try:
        procs.start("board", "docserver", "--host", "127.0.0.1", "--port",
                    "0")
        m = procs.wait_line("board", r"job board at http://([\d.]+):(\d+)")
        addr = f"{m.group(1)}:{m.group(2)}"
        url = f"http://{addr}"
        runner = ["--partitions", str(RADIX_PARTS), "--torch-device",
                  "cuda", "--workers", "1", "--max-inflight", "1",
                  "--telemetry-interval", "0.5"]
        pa = procs.start("runnerA", "runner", url, *runner)
        pb = procs.start("runnerB", "runner", url, *runner)
        for name in ("runnerA", "runnerB"):
            procs.wait_line(name, r"runner serving", timeout=180)
        host_a = f"{socket.gethostname()}:{pa.pid}"
        host_b = f"{socket.gethostname()}:{pb.pid}"
        client = HttpDocStore(addr, auth_token=token)
        try:
            reg = FleetRegistry(client)
            deadline = time.monotonic() + 60
            while {host_a, host_b} - {str(d["_id"])
                                      for d in reg.live_hosts()}:
                check(time.monotonic() < deadline, "fleet (d): the "
                      f"runners never joined: {reg.hosts()}")
                time.sleep(0.1)
            streams = [f"stream-{i}" for i in range(DRAIN_STREAMS)]
            for s in streams:
                reg.assign(s, host_a, program="wave")
            before, _ = run_cli(["status", url, "--auth", token])
            check("engine fleet: 2 host(s)" in before,
                  f"fleet (d): status before the drain:\n{before}")
            t0 = time.monotonic()
            procs.start("drain", "drain", url, host_a, "--timeout", "60")
            procs.wait("drain", timeout=120)
            drain_s = time.monotonic() - t0
            procs.wait("runnerA", timeout=60)  # exit code 0
            a_exit_s = time.monotonic() - t0
            check(f"drain requested for host {host_a}"
                  in procs.text("runnerA"), "fleet (d): runner A did not "
                  "see the drain flag")
            moved = sorted(str(r["_id"]) for r in reg.routes_for(host_b))
            check(moved == streams and not reg.routes_for(host_a),
                  f"fleet (d): routes after the drain: {moved}")
            doc_a = next(d for d in reg.hosts() if d["_id"] == host_a)
            check(host_state(doc_a, now()) == "left",
                  f"fleet (d): runner A's host doc {doc_a}")
        finally:
            client.close()
        status, status_wall = run_cli(["status", url, "--auth", token])
        line_a = [ln for ln in status.splitlines()
                  if f"host {host_a}:" in ln]
        check(line_a and "LEFT" in line_a[0], f"fleet (d): status:\n"
              f"{status}")
        deadline = time.monotonic() + 30
        while True:
            raw, diag_wall = run_cli(["diagnose", url, "--json",
                                      "--auth", token])
            report = json.loads(raw)
            drained = (report.get("fleet") or {}).get(
                "migrations", {}).get("drain", 0)
            if drained == DRAIN_STREAMS:
                break
            check(time.monotonic() < deadline, "fleet (d): diagnose "
                  f"names {drained} drain migrations: {report.get('fleet')}")
            time.sleep(0.25)
        pb.send_signal(signal.SIGINT)  # a clean exit leaves the fleet
        procs.wait("runnerB", timeout=60)
    finally:
        procs.reap()
    out = {"drain_s": drain_s, "runner_a_exit_s": a_exit_s,
           "streams": DRAIN_STREAMS, "status_wall_s": status_wall,
           "diagnose_wall_s": diag_wall,
           "diagnose_fleet": report.get("fleet"), "card": smi}
    print(json.dumps({"fleet_drain": out}), flush=True)


def mesh_rank(mode, rank, port, out_path, *args):
    """``chip_smoke.py --mesh-rank``: one of phase 22 (e)'s two
    controllers on the one card, joined by a gloo group.  ``engine``:
    the phase 7 radix slice over ``Partitions(8, group=WORLD)`` (4
    partitions here), warm once, then a counted run with its kernels
    held against their plain versions; then the bench_train MLP's one
    step at n_data 8 (f32 and the bench's bf16).  ``combined``:
    tests/multiproc_runner2.py's roles over an http docserver and a blob
    server.  Writes its numbers to *out_path* as JSON (and the MLP step's
    updated parameters to *out_path* ``.npz``)."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from mapreduce_tpu_torch.ops import kernel_compat as kc
    from mapreduce_tpu_torch.parallel.mesh import Partitions

    # the f32 step is held to 1e-5 of the one-process step: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, port = int(rank), int(port)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}",
        world_size=MESH_WORLD, rank=rank,
        timeout=datetime.timedelta(seconds=MESH_GROUP_TIMEOUT))
    out = {"rank": rank}
    try:
        parts = Partitions(RADIX_PARTS, "cuda", group=dist.group.WORLD)
        out["partitions"] = [parts.lo, parts.lo + parts.n_local]
        if mode == "engine":
            from dataclasses import replace

            from mapreduce_tpu_torch.models import (
                DistributedTrainer, MLPConfig, TrainConfig)
            from mapreduce_tpu_torch.ops import radix_sort as rs
            from mapreduce_tpu_torch.ops import segscan as seg
            from mapreduce_tpu_torch.parallel import shuffle

            with open(args[0], "rb") as f:
                data = f.read()
            cfg = replace(wcmod.bench_engine_config(), sort_impl="radix")
            wc = wcmod.DeviceWordCount(parts, chunk_len=CHUNK_LEN,
                                       config=cfg)
            wc.count_bytes(data, waves=RADIX_WAVES)  # warm
            kc.reset_counts()
            torch.cuda.synchronize()
            tm = {}
            with PathInputs(torch, seg, shuffle) as cap:
                t0 = time.monotonic()
                got = wc.count_bytes(data, timings=tm, waves=RADIX_WAVES)
                wall = time.monotonic() - t0
            out["launches"], out["plain_calls"] = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
            out["held"] = hold_path_inputs(
                torch, seg, rs, f"fleet (e) rank {rank}", cap.inputs,
                ["segreduce", "radix_sort", "radix_plan"])
            del cap
            out["counts"] = {w.decode("latin-1"): c for w, c in got.items()}
            out.update(matrix=tm["exchange"]["matrix"],
                       compute_s=tm["compute_s"], wall_s=wall,
                       waves=tm["waves"], retries=tm["retries"],
                       upload_s=tm["upload_s"],
                       readback_s=tm["readback_s"],
                       bytes_by_link=tm.get("exchange_bytes_by_link"))
            x, y = mesh_mlp_batch()
            updated = {}
            for name, dtype in (("f32", torch.float32),
                                ("bf16", torch.bfloat16)):
                tr = DistributedTrainer(
                    MLPConfig(sizes=MLP_SIZES, dtype=dtype),
                    TrainConfig(bunch_size=MLP_BUNCH), n_data=MESH_N_DATA,
                    device="cuda", group=dist.group.WORLD)
                params, opt = tr.init_state()
                params, _, loss = tr.step(params, opt,
                                          *tr.place_batch(x, y))
                out[f"loss_{name}"] = float(loss)
                updated.update({f"{name}.{n}": t.detach().cpu().numpy()
                                for n, t in params.items()})
            np.savez(out_path + ".npz", **updated)
        else:
            from mapreduce_tpu_torch.coord import docstore
            from mapreduce_tpu_torch.storage.httpstore import HttpStorage
            from mapreduce_tpu_torch.utils.serialization import (
                parse_record, serialize_record)

            board = docstore.connect(args[0])
            blobs = HttpStorage(args[1])
            corpus = blobs.read("corpus").encode("utf-8")
            kc.reset_counts()
            counts = wcmod.DeviceWordCount(parts, chunk_len=512).count_bytes(
                corpus)
            out["launches"], out["plain_calls"] = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
            if rank == 0:
                claimed = board.find_and_modify(
                    "xhost.jobs", {"_id": "wc", "status": "ENQUEUED"},
                    {"$set": {"status": "RUNNING", "worker": "p0"}})
                check(claimed is not None, "fleet (e): the claim failed")
                lines = [serialize_record(k.decode("utf-8"), [v])
                         for k, v in sorted(counts.items())]
                blobs.write("result", "\n".join(lines) + "\n")
                check(board.update("xhost.jobs", {"_id": "wc"},
                                   {"$set": {"status": "WRITTEN"}}) == 1,
                      "fleet (e): WRITTEN not set")
                out["served"] = True
            else:
                deadline = time.monotonic() + MESH_GROUP_TIMEOUT
                while (board.find_one("xhost.jobs", {"_id": "wc"})
                       or {}).get("status") != "WRITTEN":
                    check(time.monotonic() < deadline, "fleet (e): the "
                          "job never reached WRITTEN")
                    time.sleep(0.1)
                got = dict(parse_record(ln) for ln in
                           blobs.read("result").splitlines() if ln)
                check(got == {k.decode("utf-8"): [v]
                              for k, v in counts.items()},
                      "fleet (e): the published result differs")
                out["verified"] = True
            out["unique"] = len(counts)
        out["built"] = sorted(kc.BUILD_LOGS)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def mesh_mlp_batch():
    import numpy as np

    batch = MLP_BUNCH * MESH_N_DATA
    x = np.random.default_rng(0).normal(
        size=(batch, MLP_SIZES[0])).astype(np.float32)
    y = (np.arange(batch) % MLP_SIZES[-1]).astype(np.int32)
    return x, y


def mesh_ranks(root, mode, *args):
    """Start phase 22 (e)'s two controllers and wait for both; returns
    each rank's JSON."""
    port = free_port()
    procs, outs = [], []
    for r in range(MESH_WORLD):
        log = open(os.path.join(root, f"{mode}{r}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank", mode,
             str(r), str(port),
             os.path.join(root, f"{mode}{r}.json"), *args],
            stdout=log, stderr=subprocess.STDOUT))
        log.close()
    try:
        for r, p in enumerate(procs):
            rc = p.wait(timeout=MESH_GROUP_TIMEOUT + 120)
            with open(os.path.join(root, f"{mode}{r}.log")) as f:
                log = f.read()
            check(rc == 0, f"fleet (e): {mode} rank {r} exited {rc}: "
                  f"{log[-3000:]}")
            with open(os.path.join(root, f"{mode}{r}.json")) as f:
                outs.append(json.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return outs


def mesh_case(torch, data, want, rmatrix, root):
    """Phase 22 (e): two controllers on the one card over gloo, 4 of the
    8 partitions each: the radix count equal to ``want`` on both ranks,
    the traffic matrix bit-equal to phase 7's; each rank's launches and
    ``compute_s`` beside phase 7's; the MLP step's loss equal on both
    ranks and within MESH_LOSS_RTOL of the one-process n_data 8 step
    (f32), its updated parameters equal on both ranks and within
    MESH_PARAM_ATOL of the one-process step's; then the combined
    topology over an http docserver and a blob server."""
    import tempfile

    import numpy as np

    from mapreduce_tpu_torch.coord.docserver import DocServer
    from mapreduce_tpu_torch.models import (
        DistributedTrainer, MLPConfig, TrainConfig)
    from mapreduce_tpu_torch.storage.httpstore import BlobServer, HttpStorage

    corpus = os.path.join(root, "corpus")
    with open(corpus, "wb") as f:
        f.write(data)
    t0 = time.monotonic()
    ranks = mesh_ranks(root, "engine", corpus)
    engine_wall = time.monotonic() - t0
    want_str = {w.decode("latin-1"): c for w, c in want.items()}
    x, y = mesh_mlp_batch()
    one, one_params = {}, {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        tr = DistributedTrainer(MLPConfig(sizes=MLP_SIZES, dtype=dtype),
                                TrainConfig(bunch_size=MLP_BUNCH),
                                n_data=MESH_N_DATA, device="cuda")
        params, opt = tr.init_state()
        params, _, loss = tr.step(params, opt, *tr.place_batch(x, y))
        one[name] = float(loss)
        one_params.update({f"{name}.{n}": t.detach().cpu().numpy()
                           for n, t in params.items()})
    # each rank's updated parameters: equal to each other, and to the
    # one-process step's within MESH_PARAM_ATOL (the gradients' all-reduce
    # and its staging through host memory are on this path)
    rank_params = []
    for r in range(MESH_WORLD):
        with np.load(os.path.join(root, f"engine{r}.json.npz")) as z:
            rank_params.append(dict(z))
    param_err = {}
    for key, want_p in one_params.items():
        got = [p[key] for p in rank_params]
        check(np.array_equal(got[0], got[1]), f"fleet (e): the ranks' "
              f"updated {key} differ")
        param_err[key] = float(np.abs(got[0] - want_p).max())
        check(param_err[key] <= MESH_PARAM_ATOL[key.split(".")[0]],
              f"fleet (e): the updated {key} is {param_err[key]} from the "
              "one-process step's")
    for r in ranks:
        check(r.pop("counts") == want_str, f"fleet (e): rank {r['rank']}'s "
              "counts differ from Counter")
        check(r["matrix"] == rmatrix, f"fleet (e): rank {r['rank']}'s "
              "traffic matrix differs from phase 7's")
        check_launches(r["launches"], r["plain_calls"],
                       f"fleet (e) rank {r['rank']}", True)
        check(not r["built"], f"fleet (e): rank {r['rank']} ran nvcc for "
              f"{r['built']}")
    for name, rtol in (("f32", MESH_LOSS_RTOL),
                       ("bf16", MESH_BF16_LOSS_RTOL)):
        losses = [r[f"loss_{name}"] for r in ranks]
        check(losses[0] == losses[1], f"fleet (e): {name} losses {losses}")
        check(abs(losses[0] - one[name]) <= rtol * abs(one[name]),
              f"fleet (e): the {name} step's loss {losses[0]} against the "
              f"one-process step's {one[name]}")
    doc = DocServer(host="127.0.0.1", port=0).start_background()
    blob = BlobServer(tempfile.mkdtemp(prefix="xhost_", dir=root),
                      host="127.0.0.1", port=0).start_background()
    try:
        HttpStorage(blob.address).write("corpus", MESH_TEXT)
        doc.store.insert("xhost.jobs", {"_id": "wc", "status": "ENQUEUED"})
        t0 = time.monotonic()
        combined = mesh_ranks(root, "combined",
                              f"http://{doc.host}:{doc.port}", blob.address)
        combined_wall = time.monotonic() - t0
        final = doc.store.find("xhost.jobs", {"_id": "wc"})[0]
        check((final["status"], final["worker"]) == ("WRITTEN", "p0"),
              f"fleet (e): the job doc {final}")
    finally:
        doc.shutdown()
        blob.shutdown()
    check(combined[0].get("served") and combined[1].get("verified"),
          f"fleet (e): combined {combined}")
    for r in combined:
        check_launches(r["launches"], r["plain_calls"],
                       f"fleet (e) combined rank {r['rank']}", False)
    out = {"world": MESH_WORLD, "backend": "gloo",
           "ranks": ranks, "engine_wall_s": engine_wall,
           "phase7_compute_s": PHASE_NUMBERS.get("slice_radix_compute_s"),
           "matrix_bit_equal_phase7": True,
           "loss_one_process": one,
           "param_max_abs_err": param_err, "param_atol": MESH_PARAM_ATOL,
           "combined": combined, "combined_wall_s": combined_wall}
    print(json.dumps({"fleet_mesh": out}), flush=True)
    return {f"rank{r['rank']}": r["launches"] for r in ranks}


def fleet_phase(torch, kc, seg, rs, wcmod, Partitions, data, want, chunks,
                rmatrix, smi):
    """Phase 22: the engine-host fleet and multi-process meshes (the
    ``fleet_*`` lines).  Returns phase 22's launches by run."""
    import shutil
    import tempfile

    t_phase = time.monotonic()
    root = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    try:
        launches = {"migration": migration_case(torch, kc, seg, rs, wcmod,
                                                Partitions),
                    "sustained": fleet_sustained_case(torch, kc, seg,
                                                      wcmod, Partitions)}
        kill_root = os.path.join(root, "kill")
        os.makedirs(kill_root)
        launches["victim"] = kill_host_case(torch, kc, wcmod, Partitions,
                                            chunks, kill_root)
        drain_root = os.path.join(root, "drain")
        os.makedirs(drain_root)
        drain_case(drain_root, smi)
        mesh_root = os.path.join(root, "mesh")
        os.makedirs(mesh_root)
        launches.update(mesh_case(torch, data, want, rmatrix, mesh_root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"fleet": {"phase_s": time.monotonic() - t_phase,
                                "card": smi}}), flush=True)
    return launches


# -- phase 23: the session, fit and the ring over a gloo group --------------

#: the two ranks of phase 23 on the one card, and the seconds a gloo
#: collective may wait before it fails by name
GROUP_WORLD = 2
GROUP_TIMEOUT = 300
#: (b): make_digits' train and holdout rows (4 global batches of 1,024
#: an epoch at n_data 8, bench_train's MLP and batch), the epochs, and
#: the f32 run against one process's: each epoch's losses (relative)
#: and the final parameters (max abs a leaf)
GROUP_DIGITS = (4096, 512)
GROUP_EPOCHS = 3
GROUP_LOSS_RTOL = 1e-5
GROUP_PARAM_ATOL = 1e-5
#: (c): bench_longctx on the ring over RING_PARTS partitions, 4 a rank:
#: the timed steps after one warm step, and each rank's flash launches
#: a step, each kernel: causal, rank r's partitions [4r, 4r + 4) attend
#: at the ring steps s < 4 (r + 1), one folded call a step, 8 layers
GROUP_RING_STEPS = 3
GROUP_RING_PER_STEP = {0: 4 * 8, 1: 8 * 8}


def snapshot_digest(snap):
    """sha256 of a snapshot's four lanes and its overflow."""
    import hashlib

    h = hashlib.sha256()
    for f in ("keys", "values", "payload", "valid"):
        h.update(getattr(snap, f).numpy().tobytes())
    h.update(str(snap.overflow).encode())
    return h.hexdigest()


def group_session_config(wcmod):
    """Phase 8 (b)'s flagship session config: radix, a partition map."""
    from dataclasses import replace

    return replace(wcmod.bench_engine_config(), sort_impl="radix",
                   partition_map=True)


def group_stream(torch, sess, chunks, plan_rebalance):
    """Phase 23 (a)'s stream on *sess*, one process's or a group's:
    phase 8 (b)'s warm feed, then the 24 chunks in SESSION_FEEDS feeds
    with a rebalance to a plan_rebalance table of the stream's bucket
    histogram after the first, a snapshot after each feed, and a spill at
    the end.  Returns ``(snapshot digests, feed walls, spill step, the
    last snapshot)``."""
    per = chunks.shape[0] // SESSION_FEEDS
    sess.feed(chunks[:RADIX_PARTS], task="warm")
    sess.close("warm")
    digests, walls = [], []
    for i in range(SESSION_FEEDS):
        if i == 1:
            sess.rebalance("flag", plan_rebalance(
                sess.bucket_histogram("flag"), RADIX_PARTS))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        sess.feed(chunks[i * per:(i + 1) * per], task="flag")
        walls.append(time.monotonic() - t0)
        snap = sess.snapshot("flag")
        digests.append(snapshot_digest(snap))
    return digests, walls, sess.spill_stream("flag"), snap


def group_session(smod, spill, router, wcmod, parts, root, name):
    """(a)'s session over *parts*, spilling to ``ROOT/NAME``."""
    return smod.EngineSession(
        parts, wcmod._wordcount_map_fn, group_session_config(wcmod),
        spill=spill.SessionSpillStore(router(
            f"shared:{os.path.join(root, name)}")))


def group_fit_config(TrainConfig, **over):
    """(b)'s fit: the reference hyperparameters, bench_train's batch,
    GROUP_EPOCHS epochs, no early stop."""
    return TrainConfig(**dict(dict(bunch_size=MLP_BUNCH,
                                   max_epochs=GROUP_EPOCHS, min_epochs=1,
                                   patience=100), **over))


def group_rank(rank, port, root):
    """``chip_smoke.py --group-rank``: one of phase 23's two ranks on the
    one card, joined by a gloo group.  (a) the flagship stream as a
    session over ``Partitions(8, group=WORLD)``, its path's kernels held
    against their plain versions; (b) ``fit`` of the bench_train MLP at
    n_data 8 (f32), with a lease on rank 0, a resume and a fence; (c)
    bench_longctx's ring step over the group, one warm step and
    GROUP_RING_STEPS counted ones, the flash kernels held against their
    plain versions.  Then phase 24, in the same ranks: (a) phase 21
    (c)'s pipeline with its stages over the group; (b) (a)'s stream
    moved off the group and into it through the fleet.  Writes its
    numbers to ``ROOT/rank<r>.json``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mapreduce_tpu_torch.ops import kernel_compat as kc

    torch.backends.cuda.matmul.allow_tf32 = False
    rank, port = int(rank), int(port)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}",
        world_size=GROUP_WORLD, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    group = dist.group.WORLD
    out = {"rank": rank}
    try:
        out["session"] = group_session_part(torch, kc, np, rank, group, root)
        out["fit"] = group_fit_part(torch, np, rank, group, root)
        out["ring"] = group_ring_part(torch, kc, np, rank, group, root)
        # phase 24: the pipeline's stages and a fleet move over the group
        out["pipeline"] = group_pipeline_part(torch, np, rank, group, root)
        out["moves"] = group_moves_part(torch, kc, np, rank, group, root)
        out["built"] = sorted(kc.BUILD_LOGS)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def group_session_part(torch, kc, np, rank, group, root):
    """Phase 23 (a) in a rank."""
    from mapreduce_tpu_torch.engine import session as smod
    from mapreduce_tpu_torch.engine import spill
    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from mapreduce_tpu_torch.engine.autotune import plan_rebalance
    from mapreduce_tpu_torch.ops import radix_sort as rs
    from mapreduce_tpu_torch.ops import segscan as seg
    from mapreduce_tpu_torch.parallel import shuffle
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.storage.router import router

    chunks = np.load(os.path.join(root, "chunks.npy"))
    parts = Partitions(RADIX_PARTS, "cuda", group=group)
    sess = group_session(smod, spill, router, wcmod, parts, root, "spill")
    kc.reset_counts()
    with PathInputs(torch, seg, shuffle) as cap:
        digests, walls, step, _ = group_stream(torch, sess, chunks,
                                               plan_rebalance)
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    check_launches(launches, plain, f"group (a) rank {rank}", True)
    held = hold_path_inputs(torch, seg, rs, f"group (a) rank {rank}",
                            cap.inputs, ["segreduce", "radix_sort",
                                         "radix_plan"])
    return {"partitions": [parts.lo, parts.lo + parts.n_local],
            "k": sess.k, "digests": digests, "feed_s": walls,
            "spill_step": step, "stats": sess.stats("flag"),
            "launches": launches, "plain_calls": plain, "held": held}


def group_fit_part(torch, np, rank, group, root):
    """Phase 23 (b) in a rank: the fit with rank 0's lease, a fit to
    epoch 2 resumed to 3, and a fit whose lease a successor takes after
    epoch 2."""
    import uuid

    from mapreduce_tpu_torch.coord import (
        Connection, TrainerFencedError, TrainerLease)
    from mapreduce_tpu_torch.models import (
        DistributedTrainer, MLPConfig, TrainConfig, make_digits)
    from mapreduce_tpu_torch.models.checkpoint import CheckpointManager
    from mapreduce_tpu_torch.storage.router import router

    data = make_digits(*GROUP_DIGITS)

    def trainer(**over):
        return DistributedTrainer(
            MLPConfig(sizes=MLP_SIZES, dtype=torch.float32),
            group_fit_config(TrainConfig, **over), n_data=MESH_N_DATA,
            device="cuda", group=group)

    def manager(name):
        return CheckpointManager(router(
            f"shared:{os.path.join(root, name)}"))

    def lease_of(board, holder):
        """Rank 0's lease on *board* (None on the other rank)."""
        if rank:
            return None
        lease = TrainerLease(Connection(board, "train"), holder=holder,
                             lease=30.0)
        lease.acquire(timeout=10)
        return lease

    t0 = time.monotonic()
    got = trainer().fit(*data, manager=manager("fit"), lease=lease_of(
        f"mem://{uuid.uuid4().hex}", "rank0"))
    fit_s = time.monotonic() - t0
    np.savez(os.path.join(root, f"fit{rank}.npz"),
             **{n: t.detach().cpu().numpy()
                for n, t in got["params"].items()})
    trainer(max_epochs=2).fit(*data, manager=manager("resumed"))
    resumed = trainer().fit(*data, manager=manager("resumed"))
    check(resumed["restored"] and resumed["start_epoch"] == 3
          and resumed["history"] == got["history"][2:]
          and all(torch.equal(resumed["params"][n], got["params"][n])
                  for n in got["params"]),
          f"group (b) rank {rank}: the resume from epoch 2 differs from "
          "the uninterrupted fit")
    board = f"mem://{uuid.uuid4().hex}"
    lease = lease_of(board, "fenced")
    successor = TrainerLease(Connection(board, "train"), holder="successor",
                             lease=30.0)

    def take_over(rec):
        if rec["epoch"] == 2 and lease is not None:
            lease.lease = 0.2
            check(lease.heartbeat(), "group (b): the lease lapsed early")
            time.sleep(0.3)
            check(successor.try_acquire(), "group (b): no successor")

    try:
        trainer().fit(*data, manager=manager("fenced"), lease=lease,
                      on_epoch=take_over)
        fenced = None
    except TrainerFencedError as exc:
        fenced = f"{type(exc).__name__}: {exc}"
    check(fenced is not None, f"group (b) rank {rank}: no fence")
    return {"history": got["history"], "best_epoch": got["best_epoch"],
            "fit_s": fit_s, "resumed_history": resumed["history"],
            "fenced": fenced, "fenced_steps": manager("fenced").steps()}


def group_ring_part(torch, kc, np, rank, group, root):
    """Phase 23 (c) in a rank: bench_longctx's step over the group."""
    from mapreduce_tpu_torch.models import transformer as tmod
    from mapreduce_tpu_torch.ops import flash_attention as fa
    from mapreduce_tpu_torch.parallel import ring

    cfg = tmod.TransformerConfig(**RING_CONFIG, flash=False)
    tr = tmod.TransformerTrainer(cfg, learning_rate=TF_LR, seed=0,
                                 device="cuda", n_data=RING_PARTS,
                                 group=group)
    # phase 21 (b)'s tokens and (seed 0) parameters
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(1, RING_T + 1)).astype(np.int32)
    params = tr.init_params()
    t0 = time.monotonic()
    params, loss0 = tr.step(params, toks)
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    if rank == 0:
        torch.save({n: t.cpu() for n, t in params.state_dict().items()},
                   os.path.join(root, "ring_step.pt"))
    # the counted steps: the port's own step, nothing patched
    kc.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(GROUP_RING_STEPS):
        t0 = time.monotonic()
        params, loss = tr.step(params, toks)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        losses.append(float(loss))
    launches = {k: kc.LAUNCHES[k] for k in FLASH_KERNELS}
    plain = dict(kc.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated()
    hop = group_hop_step(torch, ring, lambda: tr.step(params, toks))
    want = GROUP_RING_PER_STEP[rank] * GROUP_RING_STEPS
    check(all(v == want for v in launches.values()),
          f"group (c) rank {rank}: flash launches {launches}, predicted "
          f"{want} each")
    check(not any(plain.values()), f"group (c) rank {rank}: plain "
          f"versions ran: {plain}")
    check(all(math.isfinite(x) for x in [float(loss0)] + losses),
          f"group (c) rank {rank}: losses {loss0} {losses}")
    del params
    Tl = RING_T // RING_PARTS
    # the kernels at a ring step's folded shape (4 partitions a call)
    _, errs = flash_case(torch, fa, f"group (c) rank {rank}", 4,
                         cfg.n_heads, Tl, Tl, cfg.head_dim, True)
    return {"loss0": float(loss0), "losses": losses, "warm_s": warm_s,
            "step_s": times, "step_s_median": statistics.median(times),
            "instrumented_step_s": hop["step_s"], "hop_s": hop["s"],
            "hop_share": hop["s"] / hop["step_s"],
            "hop_share_of_step_s_median": hop["s"] / statistics.median(
                times),
            "hop_moves_per_step": hop["moves"],
            "hop_bytes_per_step": hop["bytes"],
            "launches": launches, "launches_predicted": want,
            "plain_calls": plain, "max_memory_allocated": peak,
            "flash_max_abs_err": errs}


def group_hop_step(torch, ring, step):
    """One more *step* (a ring or a pipeline step), uncounted, with every
    hop timed alone: the card is synchronised before and after each
    transfer (the counted steps are not), so the hop's seconds exclude
    the kernels queued before it, and the step's own seconds include the
    syncs added.  Also counts the hops' moves and bytes."""
    hop = {"s": 0.0, "moves": 0, "bytes": 0}
    real = ring._Ring.shift

    def timed_shift(self, send, like, receive, forward):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        got = real(self, send, like, receive, forward)
        torch.cuda.synchronize()
        hop["s"] += time.monotonic() - t0
        moves = (send is not None) + bool(receive)
        hop["moves"] += moves
        hop["bytes"] += moves * like.numel() * like.element_size()
        return got

    ring._Ring.shift = timed_shift
    try:
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        hop["step_s"] = time.monotonic() - t0
    finally:
        ring._Ring.shift = real
    return hop


def group_references(torch, kc, wcmod, chunks, want, root):
    """Phases 23 and 24's one-process references on the card, run before
    the ranks start (so the ranks' timings are theirs alone): (a)'s
    stream over ``Partitions(8, "cuda")``, (b)'s fit, and phase 24 (a)'s
    pipeline step, timed as the ranks time theirs."""
    import numpy as np

    from mapreduce_tpu_torch.engine import session as smod
    from mapreduce_tpu_torch.engine import spill
    from mapreduce_tpu_torch.engine.autotune import plan_rebalance
    from mapreduce_tpu_torch.models import (
        DistributedTrainer, MLPConfig, TrainConfig, make_digits)
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.storage.router import router

    sess = group_session(smod, spill, router, wcmod,
                         Partitions(RADIX_PARTS, "cuda"), root, "one_spill")
    digests, walls, step, snap = group_stream(torch, sess, chunks,
                                              plan_rebalance)
    check(wcmod.materialize_counts(chunks, snap) == want,
          "group (a): the one-process stream's counts differ from Counter")
    got = DistributedTrainer(
        MLPConfig(sizes=MLP_SIZES, dtype=torch.float32),
        group_fit_config(TrainConfig), n_data=MESH_N_DATA,
        device="cuda").fit(*make_digits(*GROUP_DIGITS))
    from mapreduce_tpu_torch.models import pipeline as pmod

    cfg = pmod.PipelineConfig()
    tr = pmod.PipelinedTrainer(cfg, learning_rate=0.1, seed=0,
                               n_stages=PIPE_STAGES, device="cuda")
    params = tr.init_params()
    x, y = pipeline_batch(np, cfg)
    init = {n: t.cpu().numpy() for n, t in params.items()}
    params, loss = tr.step(params, x, y)
    pipe = {n: t.cpu().numpy() for n, t in params.items()}
    pipe_s, _ = median_step_s(torch, lambda: tr.step(params, x, y))
    return {"digests": digests, "feed_s": walls, "spill_step": step,
            "history": got["history"], "best_epoch": got["best_epoch"],
            "params": {n: t.detach().cpu().numpy()
                       for n, t in got["params"].items()},
            "pipe_init": init, "pipe_params": pipe, "pipe_loss": float(loss),
            "pipe_step_s": pipe_s}


def group_phase(torch, kc, wcmod, chunks, want, smi):
    """Phases 23 and 24: the session, fit and the ring, then the
    pipeline's stages and the fleet moves, over a gloo group of two
    ranks on the one card (the ``group_*`` lines).  Returns phase 23's
    launches by rank and phase 24 (b)'s by rank and in this process."""
    import shutil
    import tempfile

    import numpy as np

    from mapreduce_tpu_torch.engine import session as smod
    from mapreduce_tpu_torch.engine import spill
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.storage.router import router

    t_phase = time.monotonic()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_group_")
    try:
        np.save(os.path.join(root, "chunks.npy"), chunks)
        t0 = time.monotonic()
        ref = group_references(torch, kc, wcmod, chunks, want, root)
        ref_s = time.monotonic() - t0
        torch.cuda.empty_cache()
        port = free_port()
        procs = []
        t0 = time.monotonic()
        for r in range(GROUP_WORLD):
            log = open(os.path.join(root, f"rank{r}.log"), "w")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--group-rank",
                 str(r), str(port), root],
                stdout=log, stderr=subprocess.STDOUT))
            log.close()
        ranks = []
        try:
            for r, p in enumerate(procs):
                rc = p.wait(timeout=GROUP_TIMEOUT + 120)
                with open(os.path.join(root, f"rank{r}.log")) as f:
                    log = f.read()
                check(rc == 0, f"group: rank {r} exited {rc}: {log[-3000:]}")
                with open(os.path.join(root, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        ranks_wall = time.monotonic() - t0
        for r in ranks:
            check(not r["built"], f"group: rank {r['rank']} ran nvcc for "
                  f"{r['built']}")
        group_session_check(torch, wcmod, smod, spill, router, Partitions,
                            ranks, ref, root, smi)
        group_fit_check(np, ranks, ref, root, smi)
        group_ring_check(torch, ranks, root, smi)
        group_pipeline_check(np, ranks, ref, root, smi)
        moves = group_moves_check(torch, kc, wcmod, chunks, ranks, ref,
                                  root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"group": {
        "phase_s": time.monotonic() - t_phase, "references_s": ref_s,
        "ranks_wall_s": ranks_wall, "card": smi}}), flush=True)
    return ({f"rank{r['rank']}": dict(r["session"]["launches"],
                                      **r["ring"]["launches"])
             for r in ranks}, moves)


def group_session_check(torch, wcmod, smod, spill, router, Partitions,
                        ranks, ref, root, smi):
    """(a): each rank's snapshots bit-equal to one process's (whose
    counts are Counter's), the group's spill a one-process spill's files
    that restore bit-equal in one process; records/s beside it."""
    for r in ranks:
        s = r["session"]
        check(s["digests"] == ref["digests"], f"group (a): rank "
              f"{r['rank']}'s snapshots differ from one process's")
        check(s["spill_step"] == ref["spill_step"],
              f"group (a): spill steps {s['spill_step']} against "
              f"{ref['spill_step']}")
    gdir, odir = os.path.join(root, "spill"), os.path.join(root, "one_spill")
    files = sorted(n for n in os.listdir(gdir)
                   if os.path.isfile(os.path.join(gdir, n)))
    check(files == sorted(n for n in os.listdir(odir)
                          if os.path.isfile(os.path.join(odir, n))),
          "group (a): the spill's files differ from one process's")
    for n in files:
        with open(os.path.join(gdir, n), "rb") as a, \
                open(os.path.join(odir, n), "rb") as b:
            check(a.read() == b.read(), f"group (a): spilled {n} differs "
                  "from one process's")
    back = group_session(smod, spill, router, wcmod,
                         Partitions(RADIX_PARTS, "cuda"), root, "spill")
    t0 = time.monotonic()
    restored = snapshot_digest(back.snapshot("flag"))
    restore_s = time.monotonic() - t0
    check(restored == ref["digests"][-1], "group (a): the group's spill "
          "restored in one process differs")
    rates = [N_WORDS / sum(r["session"]["feed_s"]) for r in ranks]
    print(json.dumps({"group_session": {
        "world": GROUP_WORLD, "partitions": RADIX_PARTS,
        "feeds": SESSION_FEEDS, "snapshots_bit_equal": True,
        "spill_files": len(files), "spill_bytes_equal": True,
        "one_process_restore_s": restore_s,
        "records_per_s": rates,
        "one_process_records_per_s": N_WORDS / sum(ref["feed_s"]),
        "phase8_sustained_p8_records_per_s":
            PHASE_NUMBERS.get("sustained_p8_records_per_s"),
        "feed_s": [r["session"]["feed_s"] for r in ranks],
        "one_process_feed_s": ref["feed_s"],
        "held": [r["session"]["held"] for r in ranks],
        "launches": [r["session"]["launches"] for r in ranks],
        "card": smi}}), flush=True)


def group_fit_check(np, ranks, ref, root, smi):
    """(b): equal histories on both ranks, each epoch's losses within
    GROUP_LOSS_RTOL of one process's and the final parameters within
    GROUP_PARAM_ATOL, the resume, the fence on both ranks."""
    fits = [r["fit"] for r in ranks]
    check(fits[0]["history"] == fits[1]["history"]
          and fits[0]["best_epoch"] == fits[1]["best_epoch"],
          "group (b): the ranks' histories differ")
    check(fits[0]["best_epoch"] == ref["best_epoch"],
          f"group (b): best epoch {fits[0]['best_epoch']} against "
          f"{ref['best_epoch']}")
    loss_err = 0.0
    for g, w in zip(fits[0]["history"], ref["history"]):
        for key in ("train_loss", "val_loss"):
            err = abs(g[key] - w[key]) / abs(w[key])
            loss_err = max(loss_err, err)
            check(err <= GROUP_LOSS_RTOL, f"group (b): epoch {g['epoch']} "
                  f"{key} {g[key]} against one process's {w[key]}")
    params = [np.load(os.path.join(root, f"fit{r}.npz")) for r in range(2)]
    param_err = {}
    for n, want in ref["params"].items():
        check(np.array_equal(params[0][n], params[1][n]),
              f"group (b): the ranks' {n} differ")
        param_err[n] = float(np.abs(params[0][n] - want).max())
        check(param_err[n] <= GROUP_PARAM_ATOL, f"group (b): {n} is "
              f"{param_err[n]} from one process's")
    for f in fits:
        check(f["fenced"] and f["fenced"].startswith("TrainerFencedError")
              and f["fenced_steps"] == [1, 2],
              f"group (b): the fence {f['fenced']} {f['fenced_steps']}")
    print(json.dumps({"group_fit": {
        "n_data": MESH_N_DATA, "epochs": GROUP_EPOCHS,
        "history": fits[0]["history"], "history_equal_on_ranks": True,
        "loss_max_rel_err": loss_err, "loss_rtol": GROUP_LOSS_RTOL,
        "param_max_abs_err": param_err, "param_atol": GROUP_PARAM_ATOL,
        "resumed_bit_equal": True, "fenced": [f["fenced"] for f in fits],
        "fit_s": [f["fit_s"] for f in fits], "card": smi}}), flush=True)


def group_ring_check(torch, ranks, root, smi):
    """(c): the loss equal on both ranks, the first step within the
    smoke's step tolerances of phase 21 (b)'s one-process ring step."""
    rings = [r["ring"] for r in ranks]
    check(rings[0]["loss0"] == rings[1]["loss0"]
          and rings[0]["losses"] == rings[1]["losses"],
          f"group (c): the ranks' losses differ: {rings}")
    p0, one = PHASE_NUMBERS.pop("ring_step")
    state = torch.load(os.path.join(root, "ring_step.pt"))
    held = held_step(torch, "group ring vs one-process ring",
                     (rings[0]["loss0"], state), one, p0)
    del state
    print(json.dumps({"group_ring": {
        "config": RING_CONFIG, "seq_len": RING_T, "n_data": RING_PARTS,
        "world": GROUP_WORLD, "step0_vs_one_process": held,
        "ranks": rings, "card": smi}}), flush=True)


# -- phase 24: the pipeline's stages and a fleet move over a gloo group -------

#: (b): phase 23 (a)'s stream moves after this many of its SESSION_FEEDS
#: feeds; the fleet hosts: the group (its rank 0's id), a one-process
#: session in rank 0, and this process
GROUP_MOVE_AT = 2
GROUP_HOSTS = ("group", "solo", "parent")
#: (a): the loss's relative and every parameter's absolute limit after
#: one step against one process's (tests/test_torch_multiproc_train.py's
#: PIPE_PARAM_ATOL); a gradient summed over the ranks moves w_out by
#: some 6e-3, so FLASH_TOL would not see it
PIPE_GROUP_TOL = 1e-6


def group_pipeline_part(torch, np, rank, group, root):
    """Phase 24 (a) in a rank: phase 21 (c)'s pipeline (PipelineConfig(),
    PIPE_STAGES stages, PIPE_MICRO microbatches, seed 0) with its stages
    over the group: the forward against the sequential stages, one step
    (its parameters to ``ROOT/pipe<r>.npz``), the step timed, and one
    more step with every hop timed alone."""
    from mapreduce_tpu_torch.models import pipeline as pmod
    from mapreduce_tpu_torch.parallel import ring

    cfg = pmod.PipelineConfig()
    tr = pmod.PipelinedTrainer(cfg, learning_rate=0.1, seed=0,
                               n_stages=PIPE_STAGES, device="cuda",
                               group=group)
    params = tr.init_params()
    x, y = pipeline_batch(np, cfg)
    with torch.no_grad():
        got = pmod.pipeline_forward_local(params, tr.place_batch(x, y)[0],
                                          cfg, group=group).cpu()
    want = torch.from_numpy(pmod.pipeline_reference(params, x, cfg))
    err = float((got - want).abs().max())
    check(bool(((got - want).abs() <= FLASH_TOL["atol"] + FLASH_TOL["rtol"]
                * want.abs()).all()),
          f"group pipeline rank {rank}: forward against the sequential "
          f"stages, max |diff| {err}")
    params, loss = tr.step(params, x, y)
    np.savez(os.path.join(root, f"pipe{rank}.npz"),
             **{n: t.cpu().numpy() for n, t in params.items()})
    step_s, times = median_step_s(torch, lambda: tr.step(params, x, y))
    hop = group_hop_step(torch, ring, lambda: tr.step(params, x, y))
    return {"stages": [tr.layout.stages.start, tr.layout.stages.stop],
            "forward_max_abs_err": err, "loss": float(loss),
            "step_s": times, "step_s_median": step_s,
            "instrumented_step_s": hop["step_s"], "hop_s": hop["s"],
            "hop_share": hop["s"] / hop["step_s"],
            "hop_moves_per_step": hop["moves"],
            "hop_bytes_per_step": hop["bytes"]}


def move_feeds(torch, sess, chunks, task, feeds, plan_rebalance):
    """Feeds *feeds* (indices of SESSION_FEEDS) of phase 23 (a)'s stream
    into *task* on *sess*, the rebalance before feed 1 as there; the
    snapshot digest after each."""
    per = chunks.shape[0] // SESSION_FEEDS
    digests = []
    for i in feeds:
        if i == 1:
            sess.rebalance(task, plan_rebalance(
                sess.bucket_histogram(task), RADIX_PARTS))
        sess.feed(chunks[i * per:(i + 1) * per], task=task)
        digests.append(snapshot_digest(sess.snapshot(task)))
    torch.cuda.synchronize()
    return digests


def group_moves_part(torch, kc, np, rank, group, root):
    """Phase 24 (b) in a rank, over one spill store (``ROOT/moves``) and
    one ``dir://`` fleet board: phase 23 (a)'s stream fed GROUP_MOVE_AT
    feeds on the group and moved to the parent (which feeds the rest
    after the ranks exit), then the same stream fed GROUP_MOVE_AT feeds
    by a one-process session in rank 0, moved into the group and fed the
    rest there; the path's kernels (rows 1-5) held against their plain
    versions."""
    import torch.distributed as dist

    from mapreduce_tpu_torch.coord import docstore
    from mapreduce_tpu_torch.coord.fleet import FleetMember, FleetRegistry
    from mapreduce_tpu_torch.engine import session as smod
    from mapreduce_tpu_torch.engine import spill
    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from mapreduce_tpu_torch.engine.autotune import plan_rebalance
    from mapreduce_tpu_torch.engine.migrate import migrate
    from mapreduce_tpu_torch.ops import radix_sort as rs
    from mapreduce_tpu_torch.ops import segscan as seg
    from mapreduce_tpu_torch.ops import tokenize as tok
    from mapreduce_tpu_torch.parallel import shuffle
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.storage.router import router

    chunks = np.load(os.path.join(root, "chunks.npy"))
    reg = FleetRegistry(docstore.connect(
        f"dir://{os.path.join(root, 'board')}"))
    if rank == 0:
        for host in GROUP_HOSTS:
            FleetMember(reg.store, host_id=host, lease=GROUP_TIMEOUT).join(
                timeout=10.0)
        reg.assign("flag", "group")
        reg.assign("back", "solo")
    dist.barrier(group)

    def session(parts):
        return group_session(smod, spill, router, wcmod, parts, root,
                             "moves")

    sess = session(Partitions(RADIX_PARTS, "cuda", group=group))
    kc.reset_counts()
    with PathInputs(torch, seg, shuffle) as cap:
        flag = move_feeds(torch, sess, chunks, "flag",
                          range(GROUP_MOVE_AT), plan_rebalance)
        t0 = time.monotonic()
        out = migrate("flag", sess, None, registry=reg, src_host="group",
                      dst_host="parent")
        out_s = time.monotonic() - t0
        try:
            sess.snapshot("flag")
            busy = None
        except smod.SessionBusyError as exc:
            busy = type(exc).__name__
        into = None
        if rank == 0:
            solo = session(Partitions(RADIX_PARTS, "cuda"))
            solo_digests = move_feeds(torch, solo, chunks, "back",
                                      range(GROUP_MOVE_AT), plan_rebalance)
            t0 = time.monotonic()
            moved = migrate("back", solo, sess, registry=reg,
                            src_host="solo", dst_host="group")
            into = {"session_migration_s": time.monotonic() - t0,
                    "spill_s": moved["spill_s"], "routed": moved["routed"],
                    "digests": solo_digests}
        dist.barrier(group)
        sess.adopt("back")
        back = move_feeds(torch, sess, chunks, "back",
                          range(GROUP_MOVE_AT, SESSION_FEEDS),
                          plan_rebalance)
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    label = f"group moves rank {rank}"
    check_launches(launches, plain, label, True)
    held = hold_path_inputs(torch, seg, rs, label, cap.inputs,
                            ["segreduce", "radix_sort", "radix_plan"])
    # the tokenizer on one of the stream's chunks (uncounted: after the
    # path's counts)
    first = torch.from_numpy(chunks[0]).cuda()
    tokenize_equal(torch, tok, first, (tok.HASH_A1, tok.HASH_A2), label)
    held["tokenize"] = {"n": first.numel(), "bit_equal": True}
    return {"flag_digests": flag, "back_digests": back,
            "session_migration_s": out_s, "spill_s": out["spill_s"],
            "routed": out["routed"], "decision": out["decision"],
            "step": out["step"], "busy": busy, "into": into,
            "launches": launches, "plain_calls": plain, "held": held}


def group_pipeline_check(np, ranks, ref, root, smi):
    """Phase 24 (a): the loss equal on both ranks and within
    PIPE_GROUP_TOL of one process's; after one step every parameter
    within PIPE_GROUP_TOL of one process's, the shared ones equal on
    both ranks, the blocks a rank does not own as placed."""
    pipes = [r["pipeline"] for r in ranks]
    check(pipes[0]["loss"] == pipes[1]["loss"],
          f"group (pipeline): the ranks' losses differ: {pipes}")
    check(abs(pipes[0]["loss"] - ref["pipe_loss"])
          <= PIPE_GROUP_TOL * abs(ref["pipe_loss"]),
          f"group (pipeline): loss {pipes[0]['loss']} against one "
          f"process's {ref['pipe_loss']}")
    params = [np.load(os.path.join(root, f"pipe{r}.npz")) for r in range(2)]
    errs = {}
    for n, want in ref["pipe_params"].items():
        for r, got in enumerate(params):
            lo, hi = pipes[r]["stages"]
            if n in ("w_stage", "b_stage"):
                mine, theirs = got[n][lo:hi], np.delete(got[n],
                                                        range(lo, hi), 0)
                check(np.array_equal(theirs, np.delete(
                    ref["pipe_init"][n], range(lo, hi), 0)),
                      f"group (pipeline): rank {r} changed {n} blocks it "
                      "does not own")
                got_n, want_n = mine, want[lo:hi]
            else:
                check(np.array_equal(got[n], params[0][n]),
                      f"group (pipeline): the ranks' {n} differ")
                got_n, want_n = got[n], want
            err = float(np.abs(got_n - want_n).max())
            errs[f"{n}.rank{r}"] = err
            check(err <= PIPE_GROUP_TOL,
                  f"group (pipeline): rank {r}'s {n} is {err} from one "
                  "process's")
    S, M = PIPE_STAGES, PIPE_MICRO
    print(json.dumps({"group_pipeline": {
        "stages": S, "microbatches": M, "ticks": M + S - 1,
        "world": GROUP_WORLD, "stages_by_rank": [p["stages"] for p in pipes],
        "loss": pipes[0]["loss"], "one_process_loss": ref["pipe_loss"],
        "forward_max_abs_err": [p["forward_max_abs_err"] for p in pipes],
        "param_max_abs_err": errs, "forward_tolerance": FLASH_TOL,
        "step_tolerance": PIPE_GROUP_TOL,
        "step_s_median": [p["step_s_median"] for p in pipes],
        "step_s": [p["step_s"] for p in pipes],
        "one_process_step_s": ref["pipe_step_s"],
        "phase21_pipelined_step_s": PHASE_NUMBERS.get("pipeline_step_s"),
        "instrumented_step_s": [p["instrumented_step_s"] for p in pipes],
        "hop_s": [p["hop_s"] for p in pipes],
        "hop_share": [p["hop_share"] for p in pipes],
        "hop_moves_per_step": [p["hop_moves_per_step"] for p in pipes],
        "hop_bytes_per_step": [p["hop_bytes_per_step"] for p in pipes],
        "card": smi}}), flush=True)


def group_moves_check(torch, kc, wcmod, chunks, ranks, ref, root, smi):
    """Phase 24 (b): the group's stream bit-equal to one process's up to
    the move and refused after it on both ranks, one route flip and
    decision shared; here, the parent adopts it and feeds the rest, and
    ends bit-equal to the uninterrupted stream; the stream moved into
    the group ends so too.  Returns the launches by rank and here."""
    from mapreduce_tpu_torch.coord import docstore
    from mapreduce_tpu_torch.coord.fleet import FleetRegistry
    from mapreduce_tpu_torch.engine import session as smod
    from mapreduce_tpu_torch.engine import spill
    from mapreduce_tpu_torch.engine.autotune import plan_rebalance
    from mapreduce_tpu_torch.ops import segscan as seg
    from mapreduce_tpu_torch.parallel import shuffle
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.storage.router import router

    moves = [r["moves"] for r in ranks]
    want = ref["digests"]
    for m in moves:
        check(m["flag_digests"] == want[:GROUP_MOVE_AT]
              and m["back_digests"] == want[GROUP_MOVE_AT:],
              "group moves: a snapshot differs from one process's")
        check(m["busy"] == "SessionBusyError", f"group moves: after the "
              f"hand-off a snapshot gave {m['busy']}")
        for key in ("routed", "decision", "step"):
            check(m[key] == moves[0][key], f"group moves: {key} differs "
                  "between the ranks")
    into = moves[0]["into"]
    check(moves[0]["routed"] and into["routed"]
          and into["digests"] == want[:GROUP_MOVE_AT],
          f"group moves: {moves[0]['routed']} {into}")
    reg = FleetRegistry(docstore.connect(
        f"dir://{os.path.join(root, 'board')}"))
    check(reg.route("flag")["host"] == "parent"
          and reg.route("back")["host"] == "group",
          "group moves: the routes did not flip")
    dst = group_session(smod, spill, router, wcmod,
                        Partitions(RADIX_PARTS, "cuda"), root, "moves")
    dst.adopt("flag")
    kc.reset_counts()
    with PathInputs(torch, seg, shuffle):
        t0 = time.monotonic()
        first = snapshot_digest(dst.snapshot("flag"))
        first_s = time.monotonic() - t0
        rest = move_feeds(torch, dst, chunks, "flag",
                          range(GROUP_MOVE_AT, SESSION_FEEDS),
                          plan_rebalance)
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    check_launches(launches, plain, "group moves (parent)", True)
    check(first == want[GROUP_MOVE_AT - 1] and rest == want[GROUP_MOVE_AT:],
          "group moves: the stream moved to one process differs from the "
          "uninterrupted one")
    print(json.dumps({"group_moves": {
        "partitions": RADIX_PARTS, "feeds": SESSION_FEEDS,
        "moved_after": GROUP_MOVE_AT, "snapshots_bit_equal": True,
        "session_migration_s": [m["session_migration_s"] for m in moves],
        "spill_s": [m["spill_s"] for m in moves],
        "into_group_session_migration_s": into["session_migration_s"],
        "phase22_session_migration_s":
            PHASE_NUMBERS.get("session_migration_s"),
        "parent_first_snapshot_s": first_s, "routed": moves[0]["routed"],
        "decision": moves[0]["decision"], "spill_step": moves[0]["step"],
        "held": [m["held"] for m in moves],
        "launches": [m["launches"] for m in moves],
        "parent_launches": launches, "card": smi}}), flush=True)
    out = {f"rank{r['rank']}": r["moves"]["launches"] for r in ranks}
    out["parent"] = launches
    return out


# -- phase 25: float32 value lanes -----------------------------------------

#: phase 25 (c)'s per-lane codes over the float map's four lanes (the
#: codes kernel runs them as two launches, 3 lanes and 1)
FLOAT_CODES4 = ("sum", "min", "max", "sum")


def float_libraries(torch, kc, monoid):
    """The monoid libraries phase 25 launches (each typed monoid's, over
    its lanes' dtype, and ``float_span4``'s), for phase 1's build."""
    from mapreduce_tpu_torch.testing import monoids

    ops = [(op, dt) for op, _, dt in monoids.TYPED_MONOIDS.values()]
    ops.append((float_span4, torch.float32))
    return tuple(dict.fromkeys(kc.monoid_library(monoid.lower(op, dt))
                               for op, dt in ops))


def float_span4(a, b):
    """Phase 25's callable over the float map's lanes: ``[sum, min, max,
    sum]`` (the codes ``FLOAT_CODES4``)."""
    import torch

    return torch.stack([a[..., 0] + b[..., 0],
                        torch.minimum(a[..., 1], b[..., 1]),
                        torch.maximum(a[..., 2], b[..., 2]),
                        a[..., 3] + b[..., 3]], dim=-1)


def float_map_fn(chunk, chunk_index, cfg, welford=False):
    """Phase 25's map: wordspan's tokenize, hash and compact
    (``examples/wordspan.device_map``) with four float32 lanes ``[1,
    gstart, gstart, (gstart % 1000) * 1e-3]`` (gstart the word's offset
    in padded-chunk space); with *welford*, the three lanes ``[1, x, 0]``
    of x = the fourth.  Invalid rows carry zeros."""
    import torch

    from mapreduce_tpu_torch.ops.compaction import tile_compact
    from mapreduce_tpu_torch.ops.tokenize import tokenize_hash

    L = chunk.shape[0]
    toks = tokenize_hash(chunk, impl=cfg.tokenize_impl)
    gstart = (toks.start.to(torch.int64) + chunk_index * L).to(torch.int32)
    tc = tile_compact(toks.is_end, cfg.tile, cfg.tile_records,
                      toks.keys[:, 0], toks.keys[:, 1], gstart)
    k1, k2, gs = tc.arrays
    g = gs.to(torch.float32)
    one = torch.ones_like(g)
    # float32 of 1e-3 times each residue: one rounding, as the host's
    x = (gs % 1000).to(torch.float32) * torch.full_like(g, 1e-3)
    lanes = [one, x, torch.zeros_like(g)] if welford else [one, g, g, x]
    vals = torch.where(tc.valid[:, None], torch.stack(lanes, dim=-1), 0.0)
    return torch.stack([k1, k2], dim=-1), vals, gs[:, None], tc.valid, \
        tc.overflow


def welford_map_fn(chunk, chunk_index, cfg):
    return float_map_fn(chunk, chunk_index, cfg, welford=True)


def float_oracle(torch, monoids, chunks, data, want):
    """Each word's float64 reference of phase 25's lanes, from the bytes
    alone: the words of *data* in order (``bytes.split``), their
    padded-space offsets from *chunks* (numpy: a word starts at a
    non-space after a space or at a chunk's start), a word id each, then
    ``monoids.run_reference`` on the card: ``(ids, span, welford)``,
    *ids* ``{word: id}``, *span* the reference and bound of the float
    map's rows ``(1, g, g, x)`` under ``FLOAT_CODES4``, *welford* that
    of rows ``(1, x, 0)``."""
    import numpy as np

    words = data.split()
    is_ws = np.zeros(256, dtype=bool)
    is_ws[[32, 9, 10, 13, 11, 12]] = True
    ws = is_ws[chunks]
    head = ~ws & np.concatenate(
        [np.ones((ws.shape[0], 1), dtype=bool), ws[:, :-1]], axis=1)
    gstart = np.flatnonzero(head.reshape(-1))
    check(len(gstart) == len(words), "float oracle: word starts and words "
          "differ in number")
    ids = {w: i for i, w in enumerate(want)}
    run = torch.from_numpy(np.fromiter((ids[w] for w in words), np.int64,
                                       len(words))).to("cuda")
    g = torch.from_numpy(gstart).to("cuda")
    gf = g.to(torch.float32)
    one, nil = torch.ones_like(gf), torch.zeros_like(gf)
    # the map's lane 3, computed alike
    x = (g % 1000).to(torch.float32) * torch.full_like(gf, 1e-3)
    span = monoids.run_reference(
        FLOAT_CODES4, torch.stack([one, gf, gf, x], dim=-1), run, len(ids))
    wf = monoids.run_reference(
        "welford", torch.stack([one, x, nil], dim=-1), run, len(ids))
    return ids, span, wf


def float_result_check(torch, wcmod, chunks, res, oracle, label, welford):
    """Hold one phase 25 run's ``DeviceResult`` against the oracle: the
    words as ``Counter``'s; counts exact (float32 holds them: each is
    below 2**24); the min and max lanes float32 of the first and last
    offsets exactly (rounding is monotone); the sum lane within
    ``gamma_n * sum|v|``; welford's lanes within
    ``monoids.run_reference``'s bounds.  Returns the largest distance of
    lane 3 (welford: the mean) from the float64 reference."""
    import numpy as np

    ids, span, wf = oracle
    valid = res.valid.cpu().numpy().reshape(-1)
    pay = res.payload.cpu().numpy().reshape(-1, res.payload.shape[-1])
    words = wcmod.gather_words(chunks, pay[valid, 0].astype(np.int64))
    check(len(words) == len(ids) and len(set(words)) == len(words)
          and all(w in ids for w in words),
          f"float {label}: the words differ from Counter's")
    at = torch.tensor([ids[w] for w in words], device="cuda")
    vals = res.values.reshape(-1, res.values.shape[-1])[
        torch.from_numpy(valid).to(res.values.device)].to("cuda")
    check(vals.dtype == torch.float32, f"float {label}: values "
          f"{vals.dtype}")
    ref, tol = (wf if welford else span)
    v, ref, tol = vals.double(), ref[at], tol[at]
    off = ((v - ref).abs() - tol).max(dim=0).values
    check(bool((off <= 0).all()), f"float {label}: lanes past their "
          f"bounds by {off.tolist()}")
    check(torch.equal(v[:, 0], ref[:, 0]), f"float {label}: counts")
    lane = 1 if welford else 3
    return float((v[:, lane] - ref[:, lane]).abs().max())


def float_run(torch, kc, wcmod, Partitions, chunks, oracle, label, n_parts,
              impl, op, map_fn):
    """One ``DeviceEngine`` run of phase 25's map over the corpus's
    chunks with *op*, warm once, then counted and held."""
    from dataclasses import replace

    from mapreduce_tpu_torch.engine.device_engine import DeviceEngine

    cfg = replace(wcmod.bench_engine_config(), sort_impl=impl,
                  reduce_op=op)
    eng = DeviceEngine(Partitions(n_parts, "cuda"), map_fn, cfg)
    eng.run(chunks)  # a new engine's first run carries its allocations
    kc.reset_counts()
    tm = {}
    t0 = time.monotonic()
    res = eng.run(chunks, timings=tm)
    wall = time.monotonic() - t0
    launches, plain = dict(kc.LAUNCHES), dict(kc.PLAIN_CALLS)
    check(eng.value_dtype == torch.float32, f"float {label}: the map's "
          f"lanes are {eng.value_dtype}")
    err = float_result_check(torch, wcmod, chunks, res, oracle, label,
                             map_fn is welford_map_fn)
    kernel = "segreduce_monoid" if callable(op) else "segreduce"
    check(launches[kernel] > 0 and launches["tokenize"] > 0,
          f"float {label}: launches {launches}")
    check(not callable(op) or launches["segreduce"] == 0,
          f"float {label}: the callable ran on the codes kernel: {launches}")
    if impl == "radix":
        check(launches["radix_onesweep"] > 0 and launches["radix_plan"] > 0,
              f"float {label}: launches {launches}")
    check(not any(plain.values()),
          f"float {label}: plain versions ran on the card: {plain}")
    kind = ("welford" if map_fn is welford_map_fn
            else "callable" if callable(op) else "codes")
    return {"run": f"{label}/{kind}",
            "op": getattr(op, "__name__", None) or list(op),
            "sort_impl": impl, "wall_s": wall, "compute_s": tm["compute_s"],
            "waves": tm["waves"], "retries": tm["retries"],
            "max_abs_err": err,
            "launches": {k: v for k, v in launches.items() if v}}


def float_case(torch, seg, monoids, label, name, op, k1s, k2s, vals,
               codes=None, library=None):
    """One float kernel case: the kernel's lanes and the plain ladder's
    held by ``monoids.hold`` (exact lanes bit-equal, the rest within
    their bounds of each run's float64 fold), kernel ms (20 calls in one
    CUDA graph), plain ms and the bound.  With *codes*, the codes kernel
    on the same rows held too, and both timed in turns (codes, monoid,
    monoid, codes).  *library*: a call that computes the same function,
    timed beside it."""
    n, d = k1s.numel(), len(vals)

    def call(o):
        return lambda: seg._segment_reduce_cuda(k1s, k2s, vals, o, False)

    want = seg._segment_reduce_plain(k1s, k2s, vals, op, False)
    case = {"label": label, "n": n, "lanes": d, "dtype": str(
        vals[0].dtype).replace("torch.", "")}
    err = 0.0
    for o in (op,) if codes is None else (op, codes):
        got = call(o)()
        torch.cuda.synchronize()
        check(torch.equal(got[1], want[1]), f"float {label}: end_csum")
        err = max(err, monoids.hold(name, k1s, k2s, vals, got[0], want[0]))
    # bytes: keys 8 + values 4*d in; reduced 4*d + end_csum 4 out.  ops:
    # ~10 compare/flag ops a row plus a few a lane
    b_ms, b_by = bound(n * (8 + 8 * d + 4), n * (10 + 4 * d))
    case.update(max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                library_ms=library and time_ms(torch, library))
    if codes is None:
        case["ms"], case["spread"] = kernel_ms(torch, call(op))
    else:
        turns = [kernel_ms(torch, call(o))[0]
                 for o in (codes, op, op, codes)]
        case.update(codes=list(codes), ms=statistics.median(turns[1:3]),
                    codes_ms=statistics.median([turns[0], turns[3]]),
                    turns_ms=turns)
    case["plain_ms"] = time_ms(torch, lambda: seg._segment_reduce_plain(
        k1s, k2s, vals, op, False), reps=3, rounds=3)
    print(json.dumps({"float_case": case}), flush=True)
    return case


def segment_reduce_call(torch, seg, k1s, k2s, v, how):
    """``torch.segment_reduce`` of lane *v* over sorted key runs (the
    valid rows, sorted first): the library's one call for a one-lane sum
    or max at run ends; it takes the run lengths, which a separate pass
    (``torch.unique_consecutive``, untimed) makes."""
    valid, is_start, _ = seg._run_flags(k1s, k2s)
    nv = int(valid.sum())
    starts = torch.nonzero(is_start).reshape(-1)
    lengths = torch.diff(starts, append=torch.tensor(
        [nv], device=starts.device))
    vv = v[:nv]
    return lambda: torch.segment_reduce(vv, how, lengths=lengths)


def float_phase(torch, kc, seg, wcmod, Partitions, chunks, data, want,
                ws_held, verify_paths, smi):
    """Phase 25: float32 value lanes on both segreduce kernels (the
    ``float`` lines).  Returns the ``kernels`` entries of their float
    variants."""
    from mapreduce_tpu_torch.testing import monoids

    t_phase = time.monotonic()
    dev = torch.device("cuda")
    from mapreduce_tpu_torch.ops import monoid

    libs = float_libraries(torch, kc, monoid)
    ptxas = {n: kc.ptxas_usage(kc.BUILD_LOGS[n]) for n in libs
             if n in kc.BUILD_LOGS}
    for n, kernels in ptxas.items():
        check(all(u.get("spill_stores") == 0 and u.get("spill_loads") == 0
                  for u in kernels.values()),
              f"ptxas: a monoid kernel of {n} spills: {kernels}")
    print(json.dumps({"float": {"ptxas": ptxas, "card": smi}}), flush=True)

    def on_dev(k1, k2, vals):
        return k1.to(dev), k2.to(dev), [v.to(dev) for v in vals]

    # (a) each typed monoid's kernel and the float codes against their
    # plain versions, at phase 19's shape (852,072 rows, ~9 a run)
    cases = {}
    for i, name in enumerate(sorted(monoids.TYPED_MONOIDS)):
        op = monoids.TYPED_MONOIDS[name][0]
        k1s, k2s, vl = on_dev(*monoids.typed_lanes(
            name, MONOID_ROWS, MONOID_KEYS, seed=250 + i))
        cases[name] = float_case(torch, seg, monoids, name, name, op, k1s,
                                 k2s, vl,
                                 codes=monoids.TYPED_CODES.get(name))
        if name == "fsum_min_max":
            for j, how in enumerate(("sum", "max")):
                lane = vl[2 * j]
                cases[f"codes/{how}"] = float_case(
                    torch, seg, monoids, f"codes/{how}", (how,), how, k1s,
                    k2s, [lane],
                    library=segment_reduce_call(torch, seg, k1s, k2s, lane,
                                                how))
    # NaN runs and runs of -0.0 and +0.0: the codes, each op alone on
    # its lane, and the callable
    k1s, k2s, vl = on_dev(*monoids.typed_lanes(
        "fsum_min_max", MONOID_ROWS, MONOID_KEYS, seed=259, specials=True))
    codes = monoids.TYPED_CODES["fsum_min_max"]
    want_sp = seg._segment_reduce_plain(k1s, k2s, vl, codes, False)
    alone = [seg._segment_reduce_cuda(k1s, k2s, [v], o, False)
             for v, o in zip(vl, codes)]
    special_err = 0.0
    for got in (seg._segment_reduce_cuda(k1s, k2s, vl, codes, False),
                seg._segment_reduce_cuda(k1s, k2s, vl, monoids.fsum_min_max,
                                         False),
                ([a[0][0] for a in alone], alone[0][1])):
        torch.cuda.synchronize()
        check(torch.equal(got[1], want_sp[1]), "float specials: end_csum")
        special_err = max(special_err, monoids.hold(
            "fsum_min_max", k1s, k2s, vl, got[0], want_sp[0]))
    _, is_start, is_end = seg._run_flags(k1s, k2s)
    red = want_sp[0]
    specials = {"nan_runs": int(torch.isnan(red[0][is_end]).sum()),
                "neg_zero_min": int((red[1][is_end] == 0).logical_and(
                    torch.signbit(red[1][is_end])).sum()),
                "pos_zero_max": int((red[2][is_end] == 0).logical_and(
                    ~torch.signbit(red[2][is_end])).sum()),
                "max_abs_err": special_err}
    check(all(specials[k] > 0 for k in ("nan_runs", "neg_zero_min",
                                        "pos_zero_max")),
          f"float specials: no such run {specials}")
    print(json.dumps({"float": {"specials": specials}}), flush=True)

    # (b) 12,490,752 rows, wordspan's local reduce (rows 2 and 2b): its
    # count, first and last offset as float32 lanes, codes and callable
    _, (wk1, wk2, wvals, _, _) = ws_held
    wf = [v.to(torch.float32) for v in wvals]
    cases["wordspan_local"] = float_case(
        torch, seg, monoids, "wordspan_local", "fsum_min_max",
        monoids.fsum_min_max, wk1, wk2, wf, codes=codes)
    del wf

    # (c) the float map over the corpus at P = 1 and P = 8
    t0 = time.monotonic()
    oracle = float_oracle(torch, monoids, chunks, data, want)
    oracle_s = time.monotonic() - t0
    runs = []
    for label, n_parts, impl in VERIFY_PATHS:
        for op in (float_span4, FLOAT_CODES4):
            runs.append(float_run(torch, kc, wcmod, Partitions, chunks,
                                  oracle, label, n_parts, impl, op,
                                  float_map_fn))
    runs.append(float_run(torch, kc, wcmod, Partitions, chunks, oracle,
                          "P8", RADIX_PARTS, "radix", monoids.welford,
                          welford_map_fn))
    for r in runs:
        r["card"] = smi
        print(json.dumps({"float": {"run": r}}), flush=True)
    beside = {}
    for p in verify_paths:
        kind = "callable" if p["op"] == "callable" else "codes"
        beside[f"{p['run']}/{kind}"] = p["compute_s"]
    print(json.dumps({"float": {
        "compute_s": {r["run"]: r["compute_s"] for r in runs},
        "phase19_int32_verify_compute_s": beside, "oracle_s": oracle_s,
        "phase_s": time.monotonic() - t_phase, "card": smi}}), flush=True)

    codes_cases = [cases[k] for k in ("codes/sum", "codes/max")]
    codes_cases += [{"max_abs_err": c["max_abs_err"]} for c in cases.values()
                    if "codes_ms" in c]
    head = cases["codes/sum"]
    codes_kernel = {
        "name": "segreduce_f32", "route": "cuda",
        "source": "mapreduce_tpu_torch/csrc/segreduce.cu",
        "replaces": "mapreduce_tpu/ops/segscan.py:193",
        "launches": runs[1]["launches"]["segreduce"],
        "max_abs_err": max(c["max_abs_err"] for c in codes_cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "cases": {k: c.get("codes_ms", c.get("ms")) for k, c in cases.items()
                  if k.startswith("codes/") or "codes_ms" in c},
        "launches_p8": runs[3]["launches"]["segreduce"]}
    head = cases["fsum_min_max"]
    monoid_kernel = {
        "name": "segreduce_monoid_f32", "route": "cuda",
        "source": "mapreduce_tpu_torch/csrc/segreduce.cuh",
        "replaces": "mapreduce_tpu/ops/segscan.py:193",
        "launches": runs[0]["launches"]["segreduce_monoid"],
        "max_abs_err": max(c["max_abs_err"] for k, c in cases.items()
                           if not k.startswith("codes/")),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "cases": {k: c["ms"] for k, c in cases.items()
                  if not k.startswith("codes/")},
        "launches_p8": runs[2]["launches"]["segreduce_monoid"],
        "launches_welford": runs[4]["launches"]["segreduce_monoid"]}
    return [codes_kernel, monoid_kernel]


T_START = time.monotonic()


def own_build_dir():
    """A build directory of this run's own under ``$TMPDIR``, holding
    copies of the libraries phase 1 built, named by
    ``$MAPREDUCE_TPU_CACHE`` for this process and every child (removed
    at exit).  Every CLI command enables the build directory's shape
    registry by default, and the capacity controller pre-sizes from it:
    in the checkout's ``build/kernels`` a run would start from what
    earlier runs recorded there."""
    import atexit
    import shutil
    import tempfile

    from mapreduce_tpu_torch.utils import compile_cache

    src = compile_cache.build_dir()
    path = tempfile.mkdtemp(prefix="chip_smoke_build_")
    atexit.register(shutil.rmtree, path, ignore_errors=True)
    for name in os.listdir(src):
        if name.endswith(".so"):
            shutil.copy2(os.path.join(src, name), path)
    os.environ["MAPREDUCE_TPU_CACHE"] = path
    check(compile_cache.build_dir() == path, "the run's build dir is "
          f"{compile_cache.build_dir()}, not {path}")
    return path


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from mapreduce_tpu_torch.corpus import N_LINES
    from mapreduce_tpu_torch.corpus import N_WORDS as EUROPARL_WORDS
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.engine import tiering
    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from mapreduce_tpu_torch.engine.autotune import plan_rebalance
    from mapreduce_tpu_torch.models import transformer as tmod
    from mapreduce_tpu_torch.ops import flash_attention as fa
    from mapreduce_tpu_torch.ops import kernel_compat as kc
    from mapreduce_tpu_torch.ops import monoid
    from mapreduce_tpu_torch.ops import radix_sort as rs
    from mapreduce_tpu_torch.ops import segscan as seg
    from mapreduce_tpu_torch.ops import tokenize as tok
    from mapreduce_tpu_torch.parallel.mesh import Partitions

    # phase 1: build, and the card (with the span and collision-verify
    # monoid's library: phases 4 and 17 run it)
    t0 = time.monotonic()
    variants = [("radix", d) for d in [*sort_variants(rs).values(),
                                       *plan_variants(kc).values()] if d]
    variants += [(src, d) for src in SCAN_TILE_DEFINES
                 for d in scan_variants(kc, src).values() if d]
    span_lib = kc.monoid_library(monoid.lower(wcmod.VERIFY_REDUCE_OP))
    float_libs = float_libraries(torch, kc, monoid)
    kc.build_all(variants, names=kc.SOURCES + (span_lib,) + float_libs)
    print(f"build: {time.monotonic() - t0:.2f} s (nvcc, sm_90a, "
          f"{len(kc.SOURCES)} sources, the span monoid's library, phase "
          f"25's {len(float_libs)} and {len(variants)} variants in "
          "parallel)")
    print(f"build dir: {own_build_dir()} (this run's own)")
    ptxas_report(kc, rs)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.monotonic()
    data = make_corpus(N_WORDS, N_WORDS * N_LINES // EUROPARL_WORDS, seed=0)
    print(f"corpus: {len(data)} bytes, {N_WORDS} words (seed 0) in "
          f"{time.monotonic() - t0:.2f} s")
    cfg = wcmod.bench_engine_config()
    wc = wcmod.DeviceWordCount(device="cuda", chunk_len=CHUNK_LEN,
                               config=cfg)
    chunks, L = wc._to_chunks(data)
    check(chunks.shape[0] == 24, f"expected 24 chunks, got {chunks.shape}")
    chunks_dev = torch.from_numpy(chunks[:2 * RADIX_PARTS]).to(dev)

    # phases 2-3: each kernel against its plain version
    kernels = [tokenize_phase(torch, kc, tok, chunks_dev[0]),
               segreduce_phase(torch, kc, seg, wcmod, chunks_dev,
                               wc.config)]
    # the radix phase's inputs, made by the path from the same chunks
    radix_in, radix_dest = radix_inputs(torch, seg, wcmod, chunks_dev,
                                        wc.config)
    del chunks_dev

    # phase 4: the slice, warm once; the bench's staged path; then the
    # counted streaming run
    want = Counter(data.split())
    wc.count_bytes(data)
    staged_phase(torch, kc, wc, data, want)
    kc.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tm = {}
    t0 = time.monotonic()
    got = wc.count_bytes(data, timings=tm)
    wall = time.monotonic() - t0
    launches = dict(kc.LAUNCHES)
    plain = dict(kc.PLAIN_CALLS)
    check(got == want, "word counts differ from Counter(data.split())")
    k = chunks.shape[0] // tm["waves"]
    check(tm["waves"] == 2 and k == 12, f"expected 2 waves of 12 chunks, "
          f"got {tm['waves']}")
    check(launches["tokenize"] >= 24, f"tokenize launches {launches}")
    check(launches["segreduce"] >= 2 * (k + 2),
          f"segreduce launches {launches}")
    check(all(v == 0 for v in plain.values()),
          f"plain versions ran on the card path: {plain}")
    engine = wc.engine
    wave_bytes = k * engine.n_dev * chunks.nbytes // chunks.shape[0]
    check(tm["peak_input_wave_bytes"]
          <= engine.STREAM_PREFETCH * wave_bytes,
          f"streaming run held {tm['peak_input_wave_bytes']} input bytes, "
          f"over {engine.STREAM_PREFETCH} waves of {wave_bytes}")
    n_words = sum(want.values())
    print(json.dumps({"slice": {
        "words": n_words, "unique": len(want), "bytes": len(data),
        "waves": tm["waves"], "retries": tm["retries"],
        "compute_s": tm["compute_s"], "upload_s": tm["upload_s"],
        "readback_s": tm["readback_s"], "materialize_s": tm["materialize_s"],
        "wall_s": wall, "words_per_s_compute": n_words / tm["compute_s"],
        "first_dispatch_s": tm["first_dispatch_s"],
        "peak_input_wave_bytes": tm["peak_input_wave_bytes"],
        "input_bytes": tm["input_bytes"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches, "plain_calls": plain}}))

    # a small collision-verify count: the 3-lane callable monoid's kernel
    # through the engine
    part = data[:3_000_000]
    vwc = wcmod.DeviceWordCount(device="cuda", chunk_len=1 << 18,
                                verify_collisions=True)
    kc.reset_counts()
    check(vwc.count_bytes(part) == Counter(part.split()),
          "verify-mode counts differ")
    check(kc.LAUNCHES["segreduce_monoid"] > 0, "verify-mode count: no "
          f"monoid kernel launch: {kc.LAUNCHES}")
    print("verify_collisions count: equal")

    profile_phase(torch, kc, wc, chunks)

    # phase 6: the radix kernels against their plain versions
    radix_kernels, _ = radix_phase(torch, kc, rs, radix_in, radix_dest)
    del radix_in, radix_dest

    # phase 7: the radix slice over 8 partitions, profiled, and under a
    # partition map
    rwc, rlaunches, rmatrix = radix_slice_phase(torch, kc, rs, wcmod,
                                                Partitions, data, want)
    rchunks, _ = rwc._to_chunks(data)
    profile_phase(torch, kc, rwc, rchunks, label="profile_radix",
                  waves=RADIX_WAVES,
                  need=("tokenize kernel", "segreduce kernel",
                        "radix upfront", "radix onesweep", "radix plan"),
                  forbid=("torch.sort",))
    partition_map_phase(torch, wcmod, Partitions, tok, plan_rebalance, rwc,
                        data, want)
    tiered_phase(torch, kc, wcmod, tiering, Partitions, data, want, rmatrix)

    # phase 8: the resident sessions
    tenants = session_phase(torch, kc, wcmod, Partitions, plan_rebalance,
                            tok, data, chunks, want, smi)

    # phase 9: the job plane, through the CLI and the Server
    jobplane = jobplane_phase(torch, kc, seg, rs, data, want, smi)

    # phases 10-11: the flash kernels, then the transformer slice (the
    # plain f32 matmuls of the reference stay in full f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    flash_kernels = flash_phase(torch, fa)
    flash_scaling(torch, fa)
    flaunches = trainer_phase(torch, kc, fa, tmod)

    # phase 12: the training plane
    jobboard = training_phase(torch, kc, tmod, smi)

    # phase 13: the networked job plane, in processes
    net_launches = netplane_phase(torch, kc, seg, rs, data, want, smi,
                                  jobplane, jobboard)

    # phase 14: the always-on service
    service_launches, service_compute = service_phase(
        torch, kc, seg, rs, data, want, smi)

    # phase 15: the self-tuning controllers
    control_launches = control_phase(torch, kc, seg, rs, wcmod, Partitions,
                                     tenants, smi)

    # phase 16: the engine's device telemetry
    telemetry_launches = telemetry_phase(torch, kc, wcmod, wc, rwc, data,
                                         want, smi)

    # phase 17: the remaining examples and the compile plane
    wordspan_launches, ws_held, ws_compare = examples_phase(
        torch, kc, seg, rs, data, want, smi)

    # phase 18: the operator plane's status and diagnosis half
    operator_launches = operator_phase(data, want, smi, service_compute)

    # phase 19: callable monoids on the card
    monoid_kernel, ws_case, verify_paths = monoid_phase(
        torch, kc, seg, wcmod, chunks, data, want, ws_held, ws_compare, smi)

    # phase 20: the durable telemetry history and the alerting plane
    before_history_s = time.monotonic() - T_START
    history_launches = history_phase(data, want, smi)

    # phase 21: the expert, ring and pipeline paths
    from mapreduce_tpu_torch.models import pipeline as pmod

    before_axes_s = time.monotonic() - T_START
    axes_launches = axes_phase(torch, kc, fa, tmod, pmod, smi)

    # phase 22: the engine-host fleet and multi-process meshes
    before_fleet_s = time.monotonic() - T_START
    fleet_launches = fleet_phase(torch, kc, seg, rs, wcmod, Partitions,
                                 data, want, chunks, rmatrix, smi)
    # phases 23-24: the session, fit, the ring, the pipeline and the
    # fleet moves over a gloo group
    before_group_s = time.monotonic() - T_START
    group_launches, moves_launches = group_phase(torch, kc, wcmod, chunks,
                                                 want, smi)
    # phase 25: float32 value lanes through both segreduce kernels
    before_float_s = time.monotonic() - T_START
    float_kernels = float_phase(torch, kc, seg, wcmod, Partitions, chunks,
                                data, want, ws_held, verify_paths, smi)
    del ws_held
    monoid_kernel["launches_wordspan"] = {
        run: counts.get("segreduce_monoid", 0)
        for run, counts in wordspan_launches.items()}

    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
    for kern in radix_kernels:
        kern["launches"] = rlaunches[kern["name"]]
    for kern in flash_kernels:
        kern["launches"] = flaunches[kern["name"]]
        # and on phase 21's counted MoE and ring steps
        kern["launches_moe"] = axes_launches["moe"][kern["name"]]
        kern["launches_ring"] = axes_launches["ring"][kern["name"]]
        # and on phase 23 (c)'s counted steps, each rank's own counts
        kern["launches_group"] = {
            run: counts.get(kern["name"], 0)
            for run, counts in group_launches.items()}
    for kern in kernels + radix_kernels:
        # the same kernels on phase 13's device phase over http://
        kern["launches_netplane"] = {
            run: counts.get(kern["name"], 0)
            for run, counts in net_launches.items()}
        # and on phase 14 (c)'s two tasks in one in-process runner
        kern["launches_service"] = service_launches[kern["name"]]
        # and on phase 15's controlled skewed stream (both sizes) and
        # its capacity case
        kern["launches_control"] = {
            run: counts.get(kern["name"], 0)
            for run, counts in control_launches.items()}
        # and on phase 16's two slices with the tracer's root span
        kern["launches_telemetry"] = {
            run: counts.get(kern["name"], 0)
            for run, counts in telemetry_launches.items()}
        # and on phase 17's wordspan runs (the callable span monoid: on
        # segreduce_monoid, not here)
        kern["launches_wordspan"] = {
            run: counts.get(kern["name"], 0)
            for run, counts in wordspan_launches.items()}
        if kern["name"] == "segreduce":
            kern["wordspan_case"] = ws_case
        # and on phase 18's two tasks in the runner process (its flight
        # dump's mrtpu_kernel_launches_total)
        kern["launches_operator"] = operator_launches[kern["name"]]
        # and on phase 20's two tasks, whose counts the history held
        kern["launches_history"] = history_launches[kern["name"]]
        # and on phase 22's runs: the migration, the two fleet hosts, the
        # killed victim's committed feeds and each gloo controller
        kern["launches_fleet"] = {
            run: counts.get(kern["name"], 0)
            for run, counts in fleet_launches.items()}
        # and on phase 23 (a)'s stream, each rank's own counts
        kern["launches_group"] = {
            run: counts.get(kern["name"], 0)
            for run, counts in group_launches.items()}
        # and on phase 24 (b)'s moved streams: each rank's (rank 0's with
        # its one-process session's) and this process's
        kern["launches_group_moves"] = {
            run: counts.get(kern["name"], 0)
            for run, counts in moves_launches.items()}
    kernels += radix_kernels + flash_kernels + [monoid_kernel]
    kernels += float_kernels
    print(json.dumps({"smoke": {"wall_s": time.monotonic() - T_START,
                                "before_phase_20_wall_s":
                                before_history_s,
                                "before_phase_21_wall_s": before_axes_s,
                                "before_phase_22_wall_s": before_fleet_s,
                                "before_phase_23_wall_s": before_group_s,
                                "before_phase_25_wall_s": before_float_s}}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cold"]:
        sys.exit(cold_child(sys.argv[2]))
    if sys.argv[1:2] == ["--wordspan-child"]:
        sys.exit(wordspan_child(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--fleet-victim"]:
        sys.exit(fleet_victim(*sys.argv[2:7]))
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(*sys.argv[2:]))
    if sys.argv[1:2] == ["--group-rank"]:
        sys.exit(group_rank(*sys.argv[2:]))
    sys.exit(main())

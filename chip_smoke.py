#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``coda_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit. It imports nothing of JAX or of the ``coda_tpu`` package and:

1. builds the CUDA kernels from ``coda_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together) and prints the build time, the compiler's
   register/spill report and the card's name and power limit; then sweeps
   every fp32 p in [1e-12, 1] through the exact entropy's log term on the
   card and holds each to its contract, within 4 * 2^-24 * max(|t|, p) of
   t = p*log2(p) in float64 (beside it, the worst error of the full-precision
   ``logf`` term and of the bare ``lg2.approx``);
2. holds each kernel, in each flavour (fp32 or bf16 cache; exact or approx
   entropy), to its plain PyTorch version on the card at the headline
   shape (C, N, H) = (10, 50000, 1000) and at a ragged N = 50001, printing
   the largest error against the stated tolerance and, at the headline,
   the median time of 20 launches (CUDA events, after warm-up), the plain
   version's time (the median of 3 calls after one), the
   least time the card could take (bytes or operations over the card's
   peak rates) and, for the gather, the time of the PyTorch indexing
   expression that computes the same sum. Kernel 6 (the fused
   refresh-compute-score) also shows its row against the plain one, logs
   its tiling and shared memory (each of its launches' device ms is
   ``scripts/torch_kernel_times.py``'s ``k6_parts``), and runs once more at H = 4000 models
   (past its first design's shared-memory limit); its bound counts its
   products at the tensor cores' TF32 rate, as it runs them. The
   seed-batched kernels 4 and 5 and kernel 3 with a replica axis run at
   S = 5 replicas (the CLI's default seeds) of the same shapes, held to
   their plain versions and, bitwise, to kernels 1, 2 and 3 launched on
   each replica (kernels 4 and 5 timed at the headline only); kernel 3
   and its batched form are also held bitwise to
   the in-order fp32 sum over models (``gather_rows_sum_inorder``, the
   Pallas kernel's accumulator);
3. drives the main path — ``make_synthetic_task(0, H=1000, N=50000, C=10)``
   through ``run_seeds_compiled`` with CODA, one seed — once per
   configuration of MAIN_PATHS: the reference's default (precomputed
   refresh, fp32 cache), its headline-speed configuration (fused refresh,
   bf16 cache) and the precomputed refresh over a bf16 cache for 20
   rounds each, every other flavour for 5.
   Each run has every launch counter set to 0 just before and read just
   after, and must have launched kernel 1 once (init), kernel 3 once a
   round and kernel 2 (precomputed) or kernel 6 (fused) once a round, in
   the run's flavour, and nothing else. Then the seed-batched engine, once
   per configuration of BATCHED_PATHS: 5 seeds in one batch
   (``eig_mode='incremental'``, precomputed refresh), fp32 exact for 20
   rounds and the other three flavours for 5, each of which must have
   launched kernel 4 once and kernel 5 and the batched kernel 3 once a
   round, and nothing else;
   Then the "demo" phase (``coda_tpu_torch/demo/app.py``, the
   human-in-the-loop app, over real HTTP on an ephemeral port): the
   default factory (the committed ``data/digits_clip.npz`` with
   ``demo/digit_images``) for a start, 8 honest answers, a skip and an
   image fetch (the committed PNG's bytes), then one session at the
   headline for a start, 10 answers and a skip. Each run has the counters
   set to 0 just before and read just after: kernel 1 once, kernels 2 and
   3 once an answer, nothing else (added to the JSON line's). Each is held
   bitwise (item, selection probability, P(best)) against the same moves
   through an ``InteractiveSelector`` on the card, and against a session
   on the plain versions on the card (``eig_backend='plain'``): the same
   item at every step, or first a ``tie-break-flip`` whose runner-up gap
   is at most 2.34e-4, P(best) within 2.34e-4 until then. It prints a
   click's host ms (the HTTP round trip) at the headline, p50 and max,
   beside the card's name and power limit;
4. runs ``data/digits_h80.npz`` for 30 rounds on the kernel path and on the
   plain path, precomputed and fused, and requires identical trajectories;
   runs it for 100 rounds fused and precomputed on the kernels and requires
   the same chosen items and best models; runs it for 3 seeds x 30 rounds
   batched on the kernels, one seed after another on the kernels and
   batched on the plain versions, and requires identical trajectories;
   records ``data/digits.npz`` for 100 rounds x 3 seeds with the reference
   package's committed knobs, batched and one seed after another, into a
   temporary directory, holds each record to the schema and the committed
   dataset digest, and triages it against the committed record
   ``runs/surrogate_r17/exact`` with the port's ``compare_records`` at the
   cross-backend contract (2.34e-4): every seed must be at parity or
   diverge first as a ``tie-break-flip`` where the committed runner-up gap
   is at most 2.34e-4; each seed's triage line is printed;
5. runs the five baselines (IID, Uncertainty, ActiveTesting, VMA,
   ModelPicker) at the headline width, 1 seed x 20 rounds, twice each: the
   two runs must be identical; prints each one's init ms, ms per round
   (host clock) and peak memory; then runs each on ``digits_h80`` for 3
   seeds x 30 rounds on the card and on the CPU and triages the card's
   record against the CPU's as in 4;
6. records CODA at the headline with its default knobs, 1 seed x 20
   rounds, through the CLI's ``--record-dir`` into a temporary directory,
   holds the record to the schema and its decisions to the unrecorded
   run's, and prints the recording round's ms beside the unrecorded one.
   These runs are counted like the main path's (kernel 1 once, kernels 2
   and 3 once a round) and add to its launches;
7. the "tiers" phase, the rest of CODA, each run through
   ``run_seeds_recorded`` with the counters set to 0 just before and read
   just after: the paper's command at the headline (5 seeds in one batch,
   auto knobs, 5 rounds after an untimed one) must resolve to the
   factored tier and launch no kernel, its seed 0 bitwise a one-seed factored run, its round-0 scores
   within 2.34e-4 of the incremental tier's and its trajectories triaged
   against an ``eig_mode='incremental'`` batch; ``eig_precision`` high and
   default (2 rounds each: high bitwise highest, default's score and
   intermediate products' differences from highest, and TF32 off
   afterwards); rowscan at the headline (scores within 2.34e-4 of
   factored) and at the imagenet_sparse pool (500, 256, 1000) with 5
   seeds (auto must name rowscan); direct on ``digits_h80`` (3 seeds x 10
   rounds) triaged against factored; the pool's ``sparse:32`` and dense
   posteriors for 51 rounds on kernels 1-3, triaged against
   ``runs/imagenet_sparse_r12`` and held to them in every round with the
   records' items and labels forced (top-8 scores and posterior digests
   within 2.34e-4, the same best model, the sparse state bitwise a host
   mirror of its scatters; seeded labels that reach untracked columns
   drive the eviction and residual branches against the host mirror),
   ``sparse:1000`` bitwise dense and
   ``sparse:32`` fused on kernel 6 once a round (every launch on its
   short-axis split, both of its launches); the pool's 5 seeds as
   one batch with ``sparse:32`` and ``pi_update=exact`` (auto must name
   the incremental tier; 3 rounds after an untimed one: kernel 4 once,
   kernel 5 once a round, every launch on the class-chunk split); and at
   the headline, 1
   seed x 10 rounds, the amortized P(best) at multiplier 20 (kernel 2 once
   a round; the gate's engaged rounds; scores within 2.34e-4 of quad),
   ``pi_update=exact`` (kernel 3 never) triaged against delta,
   ``prefilter_n=4096`` (the factored tier) and the ``q`` ablations. Its
   launches add to the JSON line's. Every time and peak memory is
   printed.

8. the "batchq and surrogate" phase, each run with the counters set to 0
   just before and read just after, its launches checked and added to the
   JSON line's: at the headline, 1 seed, ``acq_batch`` q = 4 for 20 rounds
   and q = 8 for 10 (kernel 1 once a round and at init, kernel 3 q times
   a round, nothing else; ms per round and per label, peak memory, beside
   the q = 1 round), q = 4 in bf16 + approx and fused + bf16 (kernel 6
   and kernel 3 q times a round) for 5; 5 seeds at q = 4 for 5 rounds,
   one after another (kernel 1 once a round and at init, kernel 3 q times
   a round, for every seed; seed 0 bitwise the one-seed run), beside the
   5-seed q = 1 batch; ``data/digits.npz`` at q = 4 and q = 8 with
   ``runs/batchq_r14``'s knobs, triaged against those records (q4 against
   q1 by the acq-batch envelope); the five baselines at q = 4 on
   ``digits_h80``, card against CPU; the surrogate scorer
   (``surrogate:32``) on ``digits``, 3 seeds x 100 rounds, triaged
   against ``runs/surrogate_r17/surrogate`` and by the scorer envelope
   against ``.../exact``, kernel 1 once a full round; a donor session's
   pool prior seeding ``surrogate:16`` runs, triaged against
   ``runs/prior_r18`` and held to the reference's prior envelope; the
   surrogate's ms per round against the exact scorer's at the
   imagenet_sparse pool and the headline; and the CLI's tracking store in
   a temporary database, read back with the reference's analysis SQL,
   resumed ("Seed 0 finished. Skipping.") and re-logged with
   ``--force-rerun``. It prints the phase's wall time.
9. the "replay, checkpoint and suite" phase, each in-process run with the
   counters set to 0 just before and read just after, its launches
   checked and added to the JSON line's: three headline CODA records,
   made with ``--task`` on the headline task written as ``.npy`` files so
   that each replay loads them instead of rebuilding the task (1
   seed x 20 rounds with the default knobs; 5 seeds x 10 as one batch on
   the incremental tier, kernels 4, 5 and batched 3; ``--eig-refresh
   fused --eig-cache-dtype bfloat16``, 1 seed x 10, kernel 6), each
   re-executed by ``python -m coda_tpu_torch.cli replay`` in a subprocess
   (PARITY, bitwise, exit 0; its ms per round beside the recorded run's);
   the first record with one ``chosen_idx`` changed, replayed in-process
   (exit 2, DIVERGED at that round); ``runs/surrogate_r17/exact``
   re-executed on the card (each seed at parity or a ``tie-break-flip``
   within 2.34e-4); headline checkpoint runs (fp32 and bf16 CODA,
   ActiveTesting; 1 seed, every 10 rounds) cut after round 20 and resumed
   to 30, every trace bitwise the uninterrupted run, with a checkpoint's
   bytes and its save and restore seconds; the suite over ``data/`` (the
   six methods, 5 seeds x 10 rounds, ``runs/real.sqlite``'s sweep cut
   from 100 rounds) into
   a fresh database, its rerun skipping every pair, a 3-task x 2-seed x
   15-round subset under ``--task-batch --suite-devices 1`` bitwise the
   serial run, two pairs' rows bitwise the single-task CLI's, and a
   table of mean cumulative regret x100 at step 10 beside
   ``runs/real.sqlite``'s (information, not a gate). It prints the
   sweep's and the phase's wall time.
10. the "crowd and telemetry" phase, each in-process run with the
   counters set to 0 just before and read just after, its launches checked
   against the main path's for its configuration and added to the JSON
   line's: CODA at the headline under the reference's noisy crowd
   (``ROBUSTNESS_CPU_r18.json``'s spec) 1 seed x 20 rounds precomputed
   fp32 and fused bf16, 5 seeds x 10 as one batch (incremental) and q = 4
   x 5, each beside the clean run of its knobs (ms a round, peak memory)
   and the device events a round of crowd and clean (``torch.profiler``);
   ``digits_h80`` 3 seeds x 30 rounds under the noisy spec batched on the
   kernels, one seed after another and on the plain versions, identical
   with every ``CrowdAux`` array; the reference's reliability recovery
   (corr >= 0.8, mae <= 0.25, adversaries separated); the fused bf16 crowd
   run recorded, re-executed by ``cli replay`` in a subprocess (PARITY
   bitwise) and against a clean record the ``oracle-noise-envelope``
   within the reference's bounds; the CLI at the headline with
   ``--telemetry-dir`` and ``--profile-dir`` (the device peak of
   ``telemetry.json`` equal to ``torch.cuda.max_memory_allocated()``,
   ``metrics.prom`` clean by ``lint``, the ``load_dataset`` and
   ``experiment`` spans, kernels 1-3 in the profiler trace, each cost
   entry's bytes over those kernels' measured time under the card's
   memory rate), ms a round with telemetry off, on, and on with the
   profiler; and the suite with ``--telemetry-dir`` on a 2-task x
   2-method x 2-seed subset (spans on ``device:0``, the store flushed).
11. serves (``coda_tpu_torch/serve``): a bucket of 16 incremental CODA
   slots at the headline (seeds 0-15) and at ``digits_h80``, each in both
   step lowerings: the start of every slot, 10 full label rounds, timed
   rounds at 1 and 4 requested slots, a 5-of-16 set twice (every idle
   slot's state and key fingerprinted unchanged) and one profiled round at
   1 and 16 slots; the ``map`` run bitwise the port's
   ``InteractiveSelector`` on each seed (next item, its score, best, the
   P(best) digest), the ``batched`` run bitwise the ``map`` run; the
   plain versions' slab run identical or first a near-tie flip within
   2.34e-4; a fused bf16 bucket of 4 slots (kernel 6) bitwise its twins;
   dispatch ms (host clock) by occupancy and lowering, admission ms,
   device events of a dispatch and peak memory; then ``ServeApp`` behind
   ``AsyncHTTPServer`` in-process (``/healthz`` 503 before warm, 200
   after; 16 client threads each open -> 10 labels -> best -> trace ->
   close, every answer the slab run's; a duplicated ``request_id``
   deduped; a 17th open 503; ``/metrics`` clean under ``lint``; the
   label latency's p50/p99 and requests a second); a
   ``step_raise:after=5`` fault healed from the recorder streams with the
   sessions finishing bitwise the unfaulted run; and ``cli serve`` on
   ``digits_h80`` in a subprocess, two sessions labelled, drained by
   SIGTERM with exit 0. (Phase 12 runs before it.)
12. serve durability, tiers and quality (``serve/recovery.py``,
   ``tiering.py``, ``spill.py``, ``priors.py``, ``telemetry/quality.py``):
   one ``ServeApp`` of 16 incremental fp32 slots at the headline with its
   defaults (the ``batched`` lowering, tiering on with a spill directory,
   quality on, every closed session audited; no idle paging, the phase
   pages itself), driven through the Python API, each slab run counted.
   (4) 16 sessions x 3 rounds with quality on, off, off and on: the rows
   bitwise equal but ``pred_label_prob``, the 16-slot dispatch ms with
   and without the pre-dispatch hook. (1) 16 sessions (seeds 0-15) x 3
   labels; 8 demoted with one ``demote_batch`` beside 8-slot dispatches
   of the other half (their ms against without the wave), one of the 8
   labeled while its snapshot copy is in flight (that demotion loses, the
   other 7 demote, its rows and digest intact); 8
   more admitted past capacity; one hibernated to the spill store (its
   bytes and seconds); the 8 woken by labeling them (make_room paging the
   least recently used out), each woken slot bitwise a device copy taken
   before the demotion, through the snapshot path (wake ms from warm and
   from cold); 3 more 16-slot rounds; all 24 streams verified from init
   by ``verify_session_stream`` in a fresh slot, every label applied
   once. (2) one session exported (raw, then base64 JSON), closed and
   imported through the snapshot path, then through the replay path
   without its carries, its slot bitwise every time (ms); then one
   exported and imported over HTTP (``AsyncHTTPServer``) while 8 client
   threads label over HTTP, the slot bitwise (seconds, the clients' label
   ms alone and during each). (3) 4 closed sessions shadow-audited
   alone in free slots (kernel 2), each ``ok``, and a ``stream_tamper``
   audit ``diverged`` at the tampered round. (5) the
   app abandoned without closing its streams and a second app restoring
   every live session from the record directory through coalesced
   dispatches, each ``/best`` bitwise (seconds, dispatches). Then ``cli
   serve`` on ``digits_h80`` in subprocesses: an HTTP export/import round
   trip; ``crash_after_tick`` exiting 17 and ``--restore`` answering
   ``/best`` bitwise; ``cli replay-serve`` 0 on the streams and 2 on a
   copy tampered by one ulp; ``cli quality --url`` 0; the crowd's
   ``answer`` verb on a q = 4 bucket, out of order with an abstain and an
   ``oracle_poison``, committing the rows of the in-order ``labels`` verb
   with the same final labels; and the prior pool (``--eig-scorer
   surrogate:32 --surrogate-prior pool``): a closed donor contributes, the
   next session carries ``prior_fit`` and its import-replay reproduces
   it.
13. serves a fleet (``serve/router.py``, ``transport.py``,
   ``journal.py``, ``fleet.py``; after phase 11, its apps collected): 3
   in-process headline replicas of 6 incremental slots each, built by
   ``build_fleet`` from ``cli serve``'s arguments (tiering and quality
   on, no idle paging, ``--eig-mode incremental``), every run of the
   counters set to 0 just before it; every replica's ``/healthz`` is
   ``ok`` after each build, restart and revival (``Fleet`` refuses a
   replica whose warm-up failed). (1) The build, its memory a replica. (2) 12 sessions (seeds 0-11)
   opened through the ``SessionRouter``, each on its rendezvous owner, 3
   labels each. (3) One ``migrate_session`` through the snapshot path:
   epoch 1, the source fenced, the destination's slot bitwise a device
   copy taken before (ms). (4) ``rolling_restart`` while 8 client threads
   label through the router (a 0.25 s pause a label, at most 25 labels a
   session): nothing dropped, every answer exactly one more label; the
   seconds a replica, label p50/p99 before and during it, and
   ``max_memory_allocated`` during it within one replica of the peak of
   the same traffic before it. (5) A peer page under watermark pressure:
   a session demoted, its replica's warm watermark lowered to 0, and the
   tier sweeper offers it through the ``page_out`` hook to the least
   loaded peer, its slot there bitwise (ms from the watermark's drop).
   (6) ``kill_replica`` of one replica while the others' sessions take
   labels, ``revive_replica`` with crash restore, each of its sessions'
   ``/best`` bitwise its value before the kill. Then every session's
   stream replays from init bitwise in a fresh slot (every label once),
   and each session's rows are bitwise the same seed's on one 12-slot app
   with the same labels. (7) 12 closed-loop clients for 5 s against 1
   replica x 12 slots and 3 x 4, each replica as many sessions as slots
   (the default stream, a device busy share from one profiled second):
   labels a second, p50/p99. (8) The six fleet
   fault scenarios (``scripts/torch_fleet_chaos.py``) on ``digits_h80``,
   0 violations. (9) Two ``cli serve`` replicas on ``digits_h80`` behind
   ``HttpReplica`` handles and the router on ``make_server``: a traced
   session migrated over HTTP (hold, export, import, fence), its rows
   bitwise one app's; ``cli trace <id> --url`` with the router's and both
   replicas' lanes; ``cli quality --url`` 0; the router's ``/metrics``
   clean by ``lint``.
14. the N-axis mesh (``coda_tpu_torch/parallel``): the headline task
   written as ``<name>.npy`` into a temporary directory, then
   ``scripts/torch_mesh_run.py``'s jobs through ``cli --task <name>``,
   first unsharded in this process (the yardstick), then under
   ``python -m torch.distributed.run --standalone --nproc-per-node 2``
   (``--mesh data=2``: two ranks over gloo on the one card, each holding
   its half of N; a subprocess in its own session, killed at 420 s): CODA
   with the CLI's defaults, 1 seed x 20 rounds (kernels 1, 2, 3 on each
   rank's block); 5 seeds x 5 rounds as one batch on the incremental
   tier (kernels 4, 5 and the batched 3); the paper's 5-seed command
   (auto, the factored tier) x 3; the five baselines x 10; and ``cli
   suite --mesh`` over ``pyfiles`` (sharded) and ``iris`` (unsharded,
   the reference's warning), 2 seeds x 10. Each rank, seed by seed: the
   unsharded run's chosen items and best models, regret within 1e-7,
   each round's scores of its block within 2.34e-4 of the unsharded
   scores' slice, up to a first pick that differs only as a
   ``tie-break-flip`` (within 2.34e-4 of the round's best); the
   replicated state's fingerprint equal on both ranks; on the card
   kernels 1, 2, 3 (main) and 4, 5, batched 3 (batch) launched on both
   ranks (their counts, on their own line, add to the JSON line's); the
   suite's rows those of the unsharded suite. CODA 1 seed with
   ``--checkpoint-dir`` (every 5 rounds) cut after 10 of the 20 rounds and
   resumed: each rank's saves and restore at the expected rounds, its
   kernels 1-3 launched (the resumed run without the init's kernel 1),
   every result array bitwise the uninterrupted ``main`` run's; a rank's
   checkpoint bytes and its save and restore seconds. The yardstick
   records its CODA runs (``--record-dir``: phase 15's ``--against``
   side) and runs ``--debug-viz`` on ``digits_h80`` cut to its first 898
   items (N must split over data=2). CODA's knobs, each recorded
   (``--record-dir``) by the yardstick and by the ranks: ``--posterior
   sparse:32 --eig-chunk 64`` on the imagenet_sparse pool (``SPARSE_POOL``
   written as ``.npy`` files, 1 seed x 20: kernel 1 once, kernels 2 and 3
   a round on each rank), ``--prefilter-n 4096`` (1 seed x 10, the
   factored tier, no kernel), ``--acq-batch 4`` (1 seed x 10: kernel 1
   at init and a round, kernel 3 an answer), ``--eig-scorer surrogate:32``
   (1 seed x 20: kernel 1 at init and on each warmup or fallback round,
   kernel 3 a round; the hybrid rounds and the final fit the same on
   every rank) and the noisy crowd ``--oracle-noise CROWD_SPEC`` (1 seed
   x 10: kernels 1-3; the applied labels and weights bitwise the
   unsharded run's), and the confusion prior's data-group sum a model at
   a time bitwise the whole sum on each rank (the pool's ``sparse:32``
   rank at or below the unsharded run's peak memory, which the whole
   sum's gather exceeded); each rank's decisions and block scores as above
   (every rank the same picks at q = 4), the fingerprints, the launches,
   and rank 0's record held ``--against`` the yardstick's (parity, or a
   near-tie flip within 2.34e-4). It prints ms a round (a label at q =
   4), init ms and each rank's peak memory beside the unsharded run's
   (the surrogate's hybrid-round share too), with the card's name and
   power limit: gloo on one shared card checks the sharded program, it
   does not measure NCCL scaling.
15. the mesh's model axis (H sharded): first kernels 1 and 2, in the four
   flavours, at the blocks the ranks below hand them — ``(C, N/a, H/b)``
   = (10, 50000, 500), (10, 50000, 250), (10, 25000, 500), the
   imagenet_sparse pool's (1000, 256, 500) and (1000, 256, 250) — and at
   (126, 2048, 500) and (10, 8192, 1000), on both decompositions: the
   single launch (``class_chunks=1``) and the class-chunk split (the
   rule's chunk count, or 3 where the rule keeps one launch), whose
   scores and refreshed cache must be ``torch.equal`` to the single
   launch's; each held to its plain version and timed (CUDA events)
   beside its bound, with the chunks chosen and the load path it takes
   (16-byte vectors, or scalar where H/b is not a multiple of the
   vector's width); then kernels 4 and 5 at S = 5 replicas of the pool's
   (1000, 256, 500) and of (126, 2048, 500) the same way, both
   decompositions ``torch.equal`` to each other and to kernels 1 and 2
   launched per replica; then kernel 6 at the pool's (1000, 256, 500) and
   at (126, 2048, 500) in the four flavours: its single path held to its
   plain version, and its scoring launch's class-chunk split (the rule's
   count, 3 and 64) and its row launch's model-chunk split, on and off,
   ``torch.equal`` to the single path (scores, row c, the other rows), an
   out-of-range class NaN with no row written on every path, the single
   and the rules' path timed beside the bound. Then phase 14's jobs on
   the same task files,
   held to phase 14's unsharded yardstick (the same rounds), under
   ``--mesh model=2`` (two ranks, each 500 of the 1000 models: CODA 1
   seed x 20 with the recorder off and on, 5 seeds x 5 on the
   incremental tier recorded, the paper's command x 3, the five
   baselines x 10) and ``--mesh data=2,model=2`` (four ranks: CODA 1
   seed x 10, and ``--debug-viz`` on phase 14's ``digits_h80`` cut, rank
   0's P(best) bars within 2.34e-4 of the unsharded run's; the figures'
   data are kept in place of drawing them, as the card's machine has no
   matplotlib). The two model=2 records: re-executed by ``cli replay``
   on the same two ranks under ``torchrun`` (bitwise, exit 0 on every
   rank) and held ``--against`` the yardstick's records (parity, or a
   ``tie-break-flip`` within 2.34e-4); each record's bytes and a rank's
   ms a round with the recorder off and on (1 seed and the 5-seed batch)
   are printed. CODA's knobs at model=2, recorded: ``sparse:32`` on the
   pool (1 seed x 20; H/b = 250, kernels 1 and 2 on their scalar path),
   ``--eig-pbest amortized --multiplier 20`` (1 seed x 10: the gate's
   verdict each round on every rank the unsharded run's),
   ``--acq-batch 4`` (1 seed x 10), ``surrogate:32`` (1 seed x 20), the
   noisy crowd (1 seed x 10, and 5 seeds x 5 as one batch: kernels 4, 5
   and the batched 3), each record held ``--against`` phase 14's
   yardstick record (the ``sparse:32`` record also replayed bitwise on
   the ranks), with the launches and fingerprints as above.
   Each rank: its data block's decisions, regret
   and scores as phase 14's (a baseline's acquisition weights, sums over
   the models that the model axis adds in another order, within 2.34e-4
   of the job's largest weight); the fingerprint of the state its model
   group holds alike (pi-hat and its item rows, the scores, the mask)
   equal across the model group and of the state its data group holds
   alike (its models' posterior and P(best) rows) across the data group;
   on the card kernels 1, 2, 3 (main, recorded or not) and 4, 5,
   batched 3 (the recorded batch) launched on every rank (added to the
   JSON line's counts). It prints ms
   a round and each rank's peak memory beside the unsharded run's, and
   the bytes a rank sends into its model group's collectives a round.

It prints one JSON line with every kernel flavour (its ``launches`` summed
over the main-path runs, the mesh's ranks' included; kernels 1, 2, 4, 5
and 6 also split them by decomposition, ``launches_by_path``), then the card's
name
and power limit, and as its last line ``{"ok": true, "device": {...}}``. Any failed
check raises and the script exits non-zero; without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import traceback
import uuid
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
HEADLINE = (10, 50_000, 1000)        # (C, N, H)
RAGGED_N = 50_001
SEEDS = 5                            # replicas of the batched kernels and
#                                      engine: the CLI's default --seeds
REPS = 20
# the plain versions' timing (their plain_ms in the JSON line): 3 calls
# after 1 warm-up; each is a chain of PyTorch calls of 14-235 ms, so the
# median of 3 settles it (5 after 3 before; the kernels keep REPS)
PLAIN = {"reps": 3, "warmup": 1}
SCORE_RTOL = 1e-4


def log(*args):
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str) -> tuple[float, float, float]:
    """(memory bytes/s, fp32 non-tensor FLOP/s, dense TF32 tensor FLOP/s)
    of the card, from the package's table
    (``coda_tpu_torch.telemetry.costs.CARD_PEAKS``, NVIDIA's data sheets;
    H100 SXM: 3.35 TB/s, 67 and 495 TFLOP/s, also for a name it lacks)."""
    from coda_tpu_torch.telemetry import costs

    return costs.card_peaks(name) or costs.card_peaks("H100")


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, nops: float, peaks,
          tensor_ops: float = 0.0) -> tuple[float, str]:
    """The least time in ms (``costs.bound_ms``): bytes at the memory
    rate, or operations — ``nops`` on the fp32 CUDA cores and
    ``tensor_ops`` on the TF32 tensor cores, the two pipes overlapping —
    whichever is longer."""
    from coda_tpu_torch.telemetry import costs

    return costs.bound_ms(nbytes, nops, peaks, tensor_ops)


def work(kernel: str, *args, **kw) -> tuple[float, float, float]:
    """(bytes, fp32 ops, TF32 tensor ops) of one launch: the package's
    analytic model (``costs.kernel_work``), which the cost book reads
    too."""
    from coda_tpu_torch.telemetry import costs

    return costs.kernel_work(kernel, *args, **kw)


def score_atol(H: int) -> float:
    """Scores are differences of ~log2(H)-bit entropies, each a sum of H
    fp32 terms; two summation orders differ by about sqrt(H) ulps of the
    entropy, so the absolute tolerance is 4*sqrt(H)*2^-24*log2(H) (7.5e-5
    at H=1000), plus the reference's rtol 1e-4."""
    return 4 * math.sqrt(H) * 2.0 ** -24 * max(1.0, math.log2(H))


def random_cache(gen, C, N, H, dev, lead=()):
    """Random normalised (rows, hyp, pi, pi_xi, hyp_t), each with the
    leading axes ``lead`` (a batch of replicas)."""
    import torch

    def simplex(*shape):
        x = torch.rand((*lead, *shape), generator=gen, device=dev) + 0.1
        return x / x.sum(-1, keepdim=True)

    rows, hyp, pi_xi, hyp_t = (simplex(C, H), simplex(C, N, H),
                               simplex(N, C), simplex(N, H))
    pi = pi_xi.mean(-2)
    return rows, hyp, pi / pi.sum(-1, keepdim=True), pi_xi, hyp_t


FLAVOURS = [(dt, approx) for dt in ("float32", "bfloat16")
            for approx in (False, True)]
K6_RTOL, K6_ATOL = 1e-3, 2e-5        # kernel 6 scores: the reference's own
# kernel 6's fp32 row: the CPU tests' rtol 2e-5, and their atol 2e-6 (set
# for rows of H=10, elements about 0.1) scaled to elements about 1/H, so a
# product run at TF32 or bf16 fails
K6_ROW_RTOL = 2e-5


def _check_refresh_rows(hyp_k, hyp_p, hyp0, c_idx, C):
    """Kernel and plain cache after a refresh of row c: equal elsewhere,
    and equal to the input outside row c."""
    import torch

    others = [i for i in range(C) if i != c_idx]
    if not torch.equal(hyp_k[others], hyp0[others]):
        raise AssertionError("refresh kernel touched another class row")
    if not torch.equal(hyp_p[others], hyp0[others]):
        raise AssertionError("plain refresh touched another class row")


def _k12(dev, peaks, recs, N, dtype, approx, rows, hyp32, pi, pi_xi, hyp_t):
    """Kernels 1 and 2 in one flavour against their plain versions."""
    import torch

    from coda_tpu_torch.ops import eig_kernels as ek

    C, _, H = hyp32.shape
    headline = N == HEADLINE[1]
    tdt = getattr(torch, dtype)
    size = torch.finfo(tdt).bits // 8
    hyp = hyp32.to(tdt)
    atol = score_atol(H)
    tag = f"{dtype}{',approx' if approx else ''}"

    # kernel 1
    name = ek.flavour("eig_score", tdt, approx)
    got = ek.eig_scores_cache(rows, hyp, pi, pi_xi, approx=approx)
    want = ek.eig_scores_from_cache(rows, hyp, pi, pi_xi, chunk=1024,
                                    approx=approx)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=atol)
    r = recs.setdefault(name, dict(
        source="coda_tpu_torch/csrc/eig_score.cu",
        replaces="coda_tpu/ops/pallas_eig.py:163", max_abs_err=0.0))
    r["max_abs_err"] = max(r["max_abs_err"], err)
    nbytes, nops, _ = work("eig_score", C, N, H, size)
    b, by = bound(nbytes, nops, peaks)
    times = ""
    if headline:   # the kernels line keeps the headline's times only
        ms = time_ms(lambda: ek.eig_scores_cache(rows, hyp, pi, pi_xi,
                                                 approx=approx))
        plain = time_ms(lambda: ek.eig_scores_from_cache(
            rows, hyp, pi, pi_xi, chunk=1024, approx=approx), **PLAIN)
        r.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                 library_ms=None)
        times = f" ms={ms:.4f} plain_ms={plain:.4f}"
    log(f"kernel {name} N={N} ({tag}): max_abs_err={err:.3e} (tol atol="
        f"{atol:.2e} rtol={SCORE_RTOL}){times} bound_ms={b:.4f} ({by})")

    # kernel 2: refresh row c in place (rounded to the storage type), score
    name = ek.flavour("eig_refresh_score", tdt, approx)
    c_idx = C // 2
    c = torch.tensor(c_idx, dtype=torch.int32, device=dev)
    hyp_k = hyp.clone()
    got, _ = ek.eig_scores_refresh(rows, hyp_k, hyp_t, c, pi, pi_xi,
                                   approx=approx)
    hyp_p = hyp.clone()
    want, _ = ek.eig_scores_refresh_plain(rows, hyp_p, hyp_t, c, pi, pi_xi,
                                          chunk=1024, approx=approx)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=atol)
    if not torch.equal(hyp_k[c_idx], hyp_t.to(tdt)):
        raise AssertionError("refresh kernel: row c != hyp_t rounded")
    _check_refresh_rows(hyp_k, hyp_p, hyp, c_idx, C)
    if not torch.equal(hyp_k, hyp_p):
        raise AssertionError("refresh kernel cache != plain cache")
    del hyp_p
    r = recs.setdefault(name, dict(
        source="coda_tpu_torch/csrc/eig_score.cu",
        replaces="coda_tpu/ops/pallas_eig.py:646", max_abs_err=0.0))
    r["max_abs_err"] = max(r["max_abs_err"], err)
    nbytes, nops, _ = work("eig_refresh_score", C, N, H, size)
    b, by = bound(nbytes, nops, peaks)
    times = ""
    if headline:
        ms = time_ms(lambda: ek.eig_scores_refresh(rows, hyp_k, hyp_t, c, pi,
                                                   pi_xi, approx=approx))
        plain = time_ms(lambda: ek.eig_scores_refresh_plain(
            rows, hyp_k, hyp_t, c, pi, pi_xi, chunk=1024, approx=approx),
            **PLAIN)
        r.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                 library_ms=None)
        times = f" ms={ms:.4f} plain_ms={plain:.4f}"
    log(f"kernel {name} N={N} ({tag}): max_abs_err={err:.3e} (tol atol="
        f"{atol:.2e} rtol={SCORE_RTOL}) cache == plain cache, other rows "
        f"bitwise untouched{times} bound_ms={b:.4f} ({by})")
    del hyp, hyp_k


def _bf16_boundary_count(row_k, row_p, row32_k, row32_p) -> int:
    """bf16 rows from kernel and plain: where they differ, by one ulp and
    only where their fp32 rows round differently. Returns that count."""
    import torch

    bk, bp = row_k.view(torch.int16), row_p.view(torch.int16)
    differ = bk != bp
    straddle = row32_k.to(torch.bfloat16).view(torch.int16) != \
        row32_p.to(torch.bfloat16).view(torch.int16)
    if (differ & ~straddle).any():
        raise AssertionError("bf16 rows differ off a rounding boundary")
    gap = (bk.to(torch.int32) - bp.to(torch.int32)).abs()
    if (gap[differ] != 1).any():
        raise AssertionError("bf16 rows differ by more than one ulp")
    return int(differ.sum())


def _k6(dev, peaks, recs, N, gen, rows0, hyp32, pi, pi_xi):
    """Kernel 6 in all four flavours against its plain version."""
    import torch

    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops.beta import dirichlet_to_beta
    from coda_tpu_torch.ops.pbest import compute_pbest

    C, _, H = hyp32.shape
    G = 256
    headline = N == HEADLINE[1]
    c_idx = C // 2
    c = torch.tensor(c_idx, dtype=torch.int32, device=dev)
    d = torch.rand((H, C, C), generator=gen, device=dev) * 3 + 0.5
    a, b = dirichlet_to_beta(d)
    a_t, b_t = a[:, c_idx].contiguous(), b[:, c_idx].contiguous()
    rows = rows0.clone()
    rows[c_idx] = compute_pbest(a_t, b_t)
    hard = torch.randint(0, C, (N, H), generator=gen, device=dev,
                         dtype=torch.int32)
    args = (a_t, b_t, hard, c, pi, pi_xi)
    # the operations the function needs on these inputs: the base product
    # densely and the diff product only where eq = hard == c is 1, in the
    # design's 3xTF32 on the tensor cores (three TF32 products each); S
    # only where eq is 1 and the scoring of C*N*H elements on the fp32
    # CUDA cores
    nnz = int((hard == c_idx).sum())
    lay, split = ek.row_plan(
        C, N, H, G, torch.cuda.get_device_properties(dev).multi_processor_count)
    log(f"kernel 6 layout at (C, N, H, G) = ({C}, {N}, {H}, {G}): "
        f"{lay['items_per_block']} items a block ({lay['warpgroups']} "
        f"consumer warpgroup(s)), products in chunks of "
        f"{lay['models_per_chunk']} models x {lay['points_per_stage']} grid "
        f"points a stage, {lay['ring_stages']} ring stages, "
        f"{lay['smem_bytes']} bytes of shared memory a "
        f"block, {lay['blocks_per_sm']} blocks an SM, H up to "
        f"{lay['max_models']}, row split {'on' if split else 'off'}")
    rows32 = {}
    for dtype, approx in FLAVOURS:
        tdt = getattr(torch, dtype)
        size = torch.finfo(tdt).bits // 8
        name = ek.flavour("eig_refresh_compute_score", tdt, approx)
        hyp = hyp32.to(tdt)
        hyp_k, hyp_p = hyp.clone(), hyp.clone()
        got, _ = ek.eig_scores_refresh_compute(rows, hyp_k, *args,
                                               approx=approx)
        want, _ = ek.eig_scores_refresh_compute_plain(rows, hyp_p, *args,
                                                      approx=approx,
                                                      chunk=1024)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        atol = K6_ATOL + score_atol(H)
        torch.testing.assert_close(got, want, rtol=K6_RTOL, atol=atol)
        _check_refresh_rows(hyp_k, hyp_p, hyp, c_idx, C)
        row_k, row_p = hyp_k[c_idx], hyp_p[c_idx]
        if dtype == "float32":
            rows32[approx] = (row_k.clone(), row_p.clone())
            row_err = float((row_k - row_p).abs().max())
            rel = float(((row_k - row_p).abs() / row_p.abs().clamp_min(
                1e-30)).max())
            row_atol = K6_ROW_RTOL / H
            torch.testing.assert_close(row_k, row_p, rtol=K6_ROW_RTOL,
                                       atol=row_atol)
            row_note = (f"row max_abs_err={row_err:.3e} max_rel_err="
                        f"{rel:.3e} (tol rtol={K6_ROW_RTOL} atol="
                        f"{row_atol:.1e})")
        else:
            n_b = _bf16_boundary_count(row_k, row_p, *rows32[approx])
            row_note = (f"bf16 row == plain but for {n_b} of {N * H} "
                        "elements one ulp apart where the fp32 rows "
                        "straddle a rounding boundary")
        del hyp_p
        r = recs.setdefault(name, dict(
            source="coda_tpu_torch/csrc/eig_refresh_compute.cu",
            replaces="coda_tpu/ops/pallas_eig.py:320", max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        nbytes, nops, tensor_ops = work("eig_refresh_compute_score", C, N,
                                        H, size, G=G, nnz=nnz)
        b_ms, by = bound(nbytes, nops, peaks, tensor_ops)
        times = ""
        if headline:   # the kernels line keeps the headline's times only
            ms = time_ms(lambda: ek.eig_scores_refresh_compute(
                rows, hyp_k, *args, approx=approx))
            plain = time_ms(lambda: ek.eig_scores_refresh_compute_plain(
                rows, hyp_k, *args, approx=approx, chunk=1024), **PLAIN)
            r.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
                     library_ms=None)
            times = f" ms={ms:.4f} plain_ms={plain:.4f}"
        log(f"kernel {name} N={N}: max_abs_err={err:.3e} (tol atol="
            f"{atol:.2e} rtol={K6_RTOL}) {row_note}; other rows bitwise "
            f"untouched{times} bound_ms={b_ms:.4f} ({by}; eq nonzeros "
            f"{nnz} of {N * H})")
        del hyp, hyp_k
    del hard


WIDE_H = 4000   # past the first kernel 6's shared-memory limit (~3,300)


def _k6_wide(dev, gen):
    """Kernel 6 at the headline's C and N with H = WIDE_H models (fp32
    cache, exact entropy) against its plain version: scores, the refreshed
    row, the other rows untouched."""
    import torch

    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops.beta import dirichlet_to_beta
    from coda_tpu_torch.ops.pbest import compute_pbest

    C, N, H = HEADLINE[0], HEADLINE[1], WIDE_H
    c_idx = C // 2
    c = torch.tensor(c_idx, dtype=torch.int32, device=dev)
    hyp = torch.rand((C, N, H), generator=gen, device=dev).add_(0.1)
    hyp.div_(hyp.sum(-1, keepdim=True))
    pi_xi = torch.rand((N, C), generator=gen, device=dev) + 0.1
    pi_xi /= pi_xi.sum(-1, keepdim=True)
    pi = pi_xi.mean(0)
    pi /= pi.sum()
    d = torch.rand((H, C, C), generator=gen, device=dev) * 3 + 0.5
    a, b = dirichlet_to_beta(d)
    a_t, b_t = a[:, c_idx].contiguous(), b[:, c_idx].contiguous()
    rows = compute_pbest(a.T, b.T)
    rows[c_idx] = compute_pbest(a_t, b_t)
    hard = torch.randint(0, C, (N, H), generator=gen, device=dev,
                         dtype=torch.int32)
    args = (a_t, b_t, hard, c, pi, pi_xi)
    hyp_k = hyp.clone()
    got, _ = ek.eig_scores_refresh_compute(rows, hyp_k, *args)
    torch.cuda.synchronize()
    hyp_p = hyp.clone()
    want, _ = ek.eig_scores_refresh_compute_plain(rows, hyp_p, *args,
                                                  chunk=256)
    torch.cuda.synchronize()
    atol = K6_ATOL + score_atol(H)
    torch.testing.assert_close(got, want, rtol=K6_RTOL, atol=atol)
    _check_refresh_rows(hyp_k, hyp_p, hyp, c_idx, C)
    row_rel = float(((hyp_k[c_idx] - hyp_p[c_idx]).abs()
                     / hyp_p[c_idx].abs().clamp_min(1e-30)).max())
    torch.testing.assert_close(hyp_k[c_idx], hyp_p[c_idx], rtol=K6_ROW_RTOL,
                               atol=K6_ROW_RTOL / H)
    del hyp, hyp_p
    ms = time_ms(lambda: ek.eig_scores_refresh_compute(rows, hyp_k, *args),
                 reps=5)
    log(f"kernel eig_refresh_compute_score (C, N, H) = ({C}, {N}, {H}): "
        f"max_abs_err={float((got - want).abs().max()):.3e} (tol atol="
        f"{atol:.2e} rtol={K6_RTOL}), row max_rel_err={row_rel:.3e} (tol "
        f"rtol={K6_ROW_RTOL} atol={K6_ROW_RTOL / H:.1e}), other rows "
        f"bitwise untouched, ms={ms:.4f}")
    del hyp_k, hard
    torch.cuda.empty_cache()


def _k45(dev, peaks, recs, N, gen):
    """Kernels 4 and 5 (the seed-batched kernels 1 and 2) in all four
    flavours at S = SEEDS replicas: against their plain versions, and
    bitwise against kernels 1 and 2 launched on each replica; timed, with
    their plain versions, at the headline's N only."""
    import torch

    from coda_tpu_torch.ops import eig_kernels as ek

    S, (C, _, H) = SEEDS, HEADLINE
    headline = N == HEADLINE[1]
    rows, hyp32, pi, pi_xi, hyp_t = random_cache(gen, C, N, H, dev, lead=(S,))
    # each replica refreshes its own class row
    cls = torch.tensor([(3 * s + 1) % C for s in range(S)],
                       dtype=torch.int32, device=dev)
    atol = score_atol(H)
    for dtype, approx in FLAVOURS:
        tdt = getattr(torch, dtype)
        size = torch.finfo(tdt).bits // 8
        hyp = hyp32.to(tdt)
        tag = f"S={S} N={N} ({dtype}{',approx' if approx else ''})"

        # kernel 4
        name = ek.flavour("eig_score_batched", tdt, approx)
        got = ek.eig_scores_cache_batched(rows, hyp, pi, pi_xi, approx=approx)
        want = ek.eig_scores_from_cache_batched(rows, hyp, pi, pi_xi,
                                                chunk=1024, approx=approx)
        one = torch.stack([ek.eig_scores_cache(rows[s], hyp[s], pi[s],
                                               pi_xi[s], approx=approx)
                           for s in range(S)])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=atol)
        if not torch.equal(got, one):
            raise AssertionError(f"{name}: scores != kernel 1 per replica")
        r = recs.setdefault(name, dict(
            source="coda_tpu_torch/csrc/eig_score.cu",
            replaces="coda_tpu/ops/pallas_eig.py:556", max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        note = (f"kernel {name} {tag}: max_abs_err={err:.3e} (tol atol="
                f"{atol:.2e} rtol={SCORE_RTOL}) == kernel 1 per replica "
                "bitwise")
        # timed at the headline only: the plain versions' 5-replica calls
        # are the slow part of this phase
        if headline:
            nbytes, nops, _ = work("eig_score_batched", C, N, H, size, S)
            ms = time_ms(lambda: ek.eig_scores_cache_batched(
                rows, hyp, pi, pi_xi, approx=approx))
            plain = time_ms(lambda: ek.eig_scores_from_cache_batched(
                rows, hyp, pi, pi_xi, chunk=1024, approx=approx), **PLAIN)
            b, by = bound(nbytes, nops, peaks)
            note += (f" ms={ms:.4f} plain_ms={plain:.4f} bound_ms={b:.4f} "
                     f"({by})")
            r.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                     library_ms=None)
        log(note)

        # kernel 5: replica s refreshes row cls[s] in place, then scores
        name = ek.flavour("eig_refresh_score_batched", tdt, approx)
        hyp_k, hyp_p, hyp_q = hyp.clone(), hyp.clone(), hyp.clone()
        got, _ = ek.eig_scores_refresh_batched(rows, hyp_k, hyp_t, cls, pi,
                                               pi_xi, approx=approx)
        want, _ = ek.eig_scores_refresh_batched_plain(
            rows, hyp_p, hyp_t, cls, pi, pi_xi, chunk=1024, approx=approx)
        one = torch.stack([ek.eig_scores_refresh(
            rows[s], hyp_q[s], hyp_t[s], cls[s], pi[s], pi_xi[s],
            approx=approx)[0] for s in range(S)])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=atol)
        if not torch.equal(hyp_k, hyp_p):
            raise AssertionError(f"{name}: cache != plain cache")
        if not (torch.equal(got, one) and torch.equal(hyp_k, hyp_q)):
            raise AssertionError(f"{name}: scores or cache != kernel 2 per "
                                 "replica")
        for s in range(S):
            c_idx = int(cls[s])
            if not torch.equal(hyp_k[s, c_idx], hyp_t[s].to(tdt)):
                raise AssertionError(f"{name}: replica {s} row != hyp_t")
            _check_refresh_rows(hyp_k[s], hyp_p[s], hyp[s], c_idx, C)
        del hyp_p, hyp_q
        r = recs.setdefault(name, dict(
            source="coda_tpu_torch/csrc/eig_score.cu",
            replaces="coda_tpu/ops/pallas_eig.py:825", max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        note = (f"kernel {name} {tag}: max_abs_err={err:.3e} (tol atol="
                f"{atol:.2e} rtol={SCORE_RTOL}) cache == plain cache, == "
                "kernel 2 per replica bitwise, other rows untouched")
        if headline:
            nbytes, nops, _ = work("eig_refresh_score_batched", C, N, H,
                                   size, S)
            ms = time_ms(lambda: ek.eig_scores_refresh_batched(
                rows, hyp_k, hyp_t, cls, pi, pi_xi, approx=approx))
            plain = time_ms(lambda: ek.eig_scores_refresh_batched_plain(
                rows, hyp_k, hyp_t, cls, pi, pi_xi, chunk=1024,
                approx=approx), **PLAIN)
            b, by = bound(nbytes, nops, peaks)
            note += (f" ms={ms:.4f} plain_ms={plain:.4f} bound_ms={b:.4f} "
                     f"({by})")
            r.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                     library_ms=None)
        log(note)
        del hyp, hyp_k
        torch.cuda.empty_cache()
    del rows, hyp32, pi, pi_xi, hyp_t
    torch.cuda.empty_cache()


def _gather(dev, peaks, recs, N, gen):
    """Kernel 3, and kernel 3 with a replica axis at S = SEEDS (bitwise
    kernel 3 on each replica), against their plain versions."""
    import torch

    from coda_tpu_torch.ops import gather_kernels as gk

    S, (C, _, H) = SEEDS, HEADLINE
    headline = N == HEADLINE[1]
    pbc = torch.rand((C, H, N), generator=gen, device=dev)
    hidx = torch.arange(H, device=dev)
    s = torch.randint(0, C, (S, H), generator=gen, device=dev,
                      dtype=torch.int32)
    s64 = s.long()
    # H positive fp32 adds in two orders: |diff| <= H*2^-24*|sum|
    rtol = H * 2.0 ** -24
    for name, fn, plain_fn, lib_fn, sel in (
            ("row_gather", gk.gather_rows_sum, gk.gather_rows_sum_plain,
             lambda: pbc[s64[0], hidx].sum(0), s[0]),
            ("row_gather_batched", gk.gather_rows_sum_batched,
             gk.gather_rows_sum_batched_plain,
             lambda: pbc[s64, hidx].sum(1), s)):
        got = fn(pbc, sel)
        want = plain_fn(pbc, sel)
        inorder = gk.gather_rows_sum_inorder(pbc, sel)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=rtol, atol=0)
        # the kernel sums in h order from 0, as the Pallas kernel does
        if not torch.equal(got, inorder):
            raise AssertionError(f"{name}: != the in-order sum bitwise")
        note = "== the in-order sum bitwise, "
        if sel.dim() == 2:
            if not all(torch.equal(got[r], gk.gather_rows_sum(pbc, sel[r]))
                       for r in range(S)):
                raise AssertionError(f"{name}: != kernel 3 per replica")
            note += f"S={S}, == kernel 3 per replica bitwise, "
        r = recs.setdefault(name, dict(
            source="coda_tpu_torch/csrc/row_gather.cu",
            replaces="coda_tpu/ops/pallas_gather.py:66", max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        ms = time_ms(lambda: fn(pbc, sel))
        plain = time_ms(lambda: plain_fn(pbc, sel))
        lib = time_ms(lib_fn)
        # the distinct (class, model) rows these classes select, each read
        # once, the classes and the output
        rows_needed = int(torch.unique(sel.long() * H + hidx).numel())
        b, by = bound(*work(name, C, N, H, S=sel.numel() // H,
                            rows=rows_needed)[:2], peaks)
        log(f"kernel {name} N={N}: {note}max_abs_err={err:.3e} (tol rtol="
            f"{rtol:.2e}) ms={ms:.4f} plain_ms={plain:.4f} library_ms="
            f"{lib:.4f} bound_ms={b:.4f} ({by}; {rows_needed} distinct rows)")
        if headline:
            r.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                     library_ms=lib)
    del pbc
    torch.cuda.empty_cache()


LOG_SWEEP_CHUNK = 1 << 25


def phase_log_sweep(dev) -> dict:
    """Every fp32 p in [1e-12, 1] through the exact flavour's log term on
    the card (``eig_plogp_sweep_launch``), held to its error contract
    against ``p * log2(p)`` in float64; beside it the full-precision
    ``logf(p) * log2(e) * p`` and the bare ``lg2.approx`` term, below and
    above the threshold where the exact flavour leaves the latter. Returns
    the worst error of each in units of the contract; fails if the exact
    term breaks it."""
    import numpy as np
    import torch

    from coda_tpu_torch.ops import eig_kernels as ek

    lo = int(np.float32(1e-12).view(np.int32))
    hi = int(np.float32(1.0).view(np.int32))
    wide = int(np.float32(0.0625).view(np.int32))
    worst = {"exact": 0.0, "logf": 0.0, "lg2 p<=1/16": 0.0, "lg2 p>1/16": 0.0}
    at = {}
    t0 = time.perf_counter()
    for start in range(lo, hi + 1, LOG_SWEEP_CHUNK):
        bits = torch.arange(start, min(start + LOG_SWEEP_CHUNK, hi + 1),
                            dtype=torch.int32, device=dev)
        p = bits.view(torch.float32)
        for form in ek.PLOGP_FORMS:
            ratio = ek.plogp_error_units(p, ek.plogp_terms(p, form))
            parts = ([(form, ratio, p)] if form != "lg2" else
                     [("lg2 p<=1/16", ratio[bits <= wide], p[bits <= wide]),
                      ("lg2 p>1/16", ratio[bits > wide], p[bits > wide])])
            for key, r, pp in parts:
                if r.numel() == 0:
                    continue
                m, i = r.max(0)
                if float(m) > worst[key]:
                    worst[key], at[key] = float(m), float(pp[i])
            del ratio
        del bits, p
    torch.cuda.synchronize()
    n = hi - lo + 1
    log(f"log-term sweep: {n} fp32 p in [1e-12, 1] in "
        f"{time.perf_counter() - t0:.1f} s; worst |t - p*log2(p)| in units "
        f"of {ek.PLOGP_CONTRACT_ULPS}*2^-24*max(|t|, p): "
        + ", ".join(f"{k} {v:.4f} (p={at.get(k, float('nan')):.6e})"
                    for k, v in worst.items()))
    if worst["exact"] > 1.0:
        raise AssertionError(f"the exact log term breaks its contract: "
                             f"{worst['exact']:.4f} units at p={at['exact']}")
    return worst


def phase_kernels(dev, peaks):
    """Every kernel, in every flavour, against its plain version at the
    headline and a ragged shape. Returns per-flavour records (times at the
    headline)."""
    import torch

    recs = {}
    gen = torch.Generator(device=dev)
    C, _, H = HEADLINE
    for N in (HEADLINE[1], RAGGED_N):
        gen.manual_seed(N)
        rows, hyp, pi, pi_xi, hyp_t = random_cache(gen, C, N, H, dev)
        for dtype, approx in FLAVOURS:
            _k12(dev, peaks, recs, N, dtype, approx, rows, hyp, pi, pi_xi,
                 hyp_t)
        del hyp_t
        torch.cuda.empty_cache()
        _k6(dev, peaks, recs, N, gen, rows, hyp, pi, pi_xi)
        del rows, hyp, pi, pi_xi
        torch.cuda.empty_cache()
        _k45(dev, peaks, recs, N, gen)
        _gather(dev, peaks, recs, N, gen)
    _k6_wide(dev, gen)
    return recs


def reset_counts():
    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops import gather_kernels as gk

    for d in (ek.launch_counts, gk.launch_counts, ek.split_counts):
        for k in d:
            d[k] = 0


SPLIT = "/split"   # a flavour's key in a launch total: its split launches


def _tally(total: dict, by_flavour: dict, split: Optional[dict] = None):
    """Add a counted run's launches by flavour to ``total``, and its
    launches of kernels 1 and 2 that took the split decomposition (this
    process's since the last :func:`reset_counts`, or a rank's ``split``)
    under ``<flavour>/split``."""
    from coda_tpu_torch.ops import eig_kernels as ek

    for k, v in by_flavour.items():
        total[k] = total.get(k, 0) + v
    for k, v in (ek.split_counts if split is None else split).items():
        if v:
            total[k + SPLIT] = total.get(k + SPLIT, 0) + v


def read_counts() -> tuple[dict, dict]:
    """(launches by kernel, launches by flavour) since the last reset; a
    kernel's count is the sum over its flavours."""
    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops import gather_kernels as gk

    by_flavour = {**ek.launch_counts, **gk.launch_counts}
    by_kernel = dict.fromkeys(("eig_score", "eig_refresh_score",
                               "eig_refresh_compute_score", "row_gather",
                               "eig_score_batched",
                               "eig_refresh_score_batched",
                               "row_gather_batched"), 0)
    for name, n in by_flavour.items():
        kernel = name.split("[")[0]
        by_kernel[kernel] = by_kernel.get(kernel, 0) + n
    return by_kernel, {k: n for k, n in by_flavour.items() if n}


# (eig_refresh, eig_cache_dtype, eig_entropy, rounds): the two headline
# configurations and the precomputed bf16 exact one (the path of kernel 2's
# bf16 flavour) at 20 rounds, then every other flavour at 5
_DEEP = (("precomputed", "float32", "exact"),
         ("precomputed", "bfloat16", "exact"), ("fused", "bfloat16", "exact"))
MAIN_PATHS = [(*k, 20) for k in _DEEP] + [
    (r, d, e, 5) for r in ("precomputed", "fused")
    for d in ("float32", "bfloat16") for e in ("exact", "approx")
    if (r, d, e) not in _DEEP]
# (eig_cache_dtype, eig_entropy, rounds) of the seed-batched engine
# (precomputed refresh, SEEDS seeds in one batch): the reference's default
# at 20 rounds, the other flavours at 5
BATCHED_PATHS = [("float32", "exact", 20), ("float32", "approx", 5),
                 ("bfloat16", "exact", 5), ("bfloat16", "approx", 5)]


def _check_run(res, config, iters, N):
    """Finite, in range, no item chosen twice by a seed, regret >= 0."""
    import torch

    regret = res.regret.cpu()
    idx = res.chosen_idx.cpu()
    if not (torch.isfinite(regret).all() and torch.isfinite(
            res.select_prob.cpu()).all()):
        raise AssertionError(f"{config}: non-finite regret or select_prob")
    if not ((idx >= 0).all() and (idx < N).all()
            and all(len(set(row.tolist())) == iters for row in idx)):
        raise AssertionError(f"{config}: chosen indices out of range or "
                             f"repeated: {idx}")
    if (regret < 0).any():
        raise AssertionError(f"{config}: negative regret")


def phase_main_path(dev, task) -> dict:
    """The headline CODA run through the user's entry points, once per
    configuration of MAIN_PATHS (one seed) and of BATCHED_PATHS (SEEDS
    seeds in one batch), each with the launch counters set to 0 just
    before and read just after. Returns the launches by flavour, summed
    over the runs."""
    import torch

    from coda_tpu_torch.engine import run_seeds_compiled
    from coda_tpu_torch.ops.eig_kernels import flavour
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda

    C, N, H = HEADLINE
    seeds = 1
    total: dict = {}
    for refresh, dtype, entropy, iters in MAIN_PATHS:
        hp = CODAHyperparams(eig_chunk=1024, eig_refresh=refresh,
                             eig_cache_dtype=dtype, eig_entropy=entropy)
        timings = []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        res = run_seeds_compiled(lambda p: make_coda(p, hp, device=dev),
                                 task.preds, task.labels, iters=iters,
                                 seeds=seeds, device=dev, timings=timings)
        torch.cuda.synchronize()
        counts, by_flavour = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        fused = refresh == "fused"
        refresh_kernel = ("eig_refresh_compute_score" if fused
                          else "eig_refresh_score")
        tdt, approx = getattr(torch, dtype), entropy == "approx"
        want = {flavour("eig_score", tdt, approx): seeds,
                flavour(refresh_kernel, tdt, approx): iters * seeds,
                "row_gather": iters * seeds}
        config = f"eig_refresh={refresh} eig_cache_dtype={dtype} " \
                 f"eig_entropy={entropy}"
        if by_flavour != want:
            raise AssertionError(f"{config}: launch counts {by_flavour}, "
                                 f"expected {want}")
        _tally(total, by_flavour)
        _check_run(res, config, iters, N)
        regret = res.regret.cpu()
        init_ms = timings[0]["init_ms"]
        round_ms = timings[0]["rounds_ms"] / iters
        log(f"main path {config}, {iters} rounds: init_ms={init_ms:.1f} "
            f"ms_per_round={round_ms:.3f} "
            f"regret@{iters}={float(regret[0, -1]):.4f} "
            f"regret@0={float(res.regret_at_0[0]):.4f} "
            f"peak_mem_gb={peak_gb:.2f} launches={json.dumps(counts)}")
        del res

    # the seed-batched engine: SEEDS seeds in one round loop
    for dtype, entropy, iters in BATCHED_PATHS:
        hp = CODAHyperparams(eig_chunk=1024, eig_mode="incremental",
                             eig_cache_dtype=dtype, eig_entropy=entropy,
                             n_parallel=SEEDS)
        timings = []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        res = run_seeds_compiled(lambda p: make_coda(p, hp, device=dev),
                                 task.preds, task.labels, iters=iters,
                                 seeds=SEEDS, device=dev, timings=timings)
        torch.cuda.synchronize()
        counts, by_flavour = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        tdt, approx = getattr(torch, dtype), entropy == "approx"
        want = {flavour("eig_score_batched", tdt, approx): 1,
                flavour("eig_refresh_score_batched", tdt, approx): iters,
                "row_gather_batched": iters}
        config = f"batched seeds={SEEDS} eig_cache_dtype={dtype} " \
                 f"eig_entropy={entropy}"
        if by_flavour != want or len(timings) != 1:
            raise AssertionError(f"{config}: launch counts {by_flavour}, "
                                 f"expected {want}; timings {timings}")
        _tally(total, by_flavour)
        _check_run(res, config, iters, N)
        regret = res.regret.cpu()
        round_ms = timings[0]["rounds_ms"] / iters
        log(f"main path {config}, {iters} rounds: init_ms="
            f"{timings[0]['init_ms']:.1f} ms_per_round={round_ms:.3f} "
            f"ms_per_seed_round={round_ms / SEEDS:.3f} "
            f"regret@{iters} per seed="
            f"{[round(float(x), 4) for x in regret[:, -1]]} "
            f"regret@0={float(res.regret_at_0[0]):.4f} "
            f"peak_mem_gb={peak_gb:.2f} launches={json.dumps(counts)}")
        del res
    return total


DEMO_DIGITS_ANSWERS = 8                # honest answers, digits_clip
DEMO_HEADLINE_ANSWERS = 10             # honest answers at the headline


def _demo_moves(answers: int) -> list:
    """The demo's clicks after its start: ``answers`` honest answers with
    a skip after the first half."""
    half = answers // 2
    return ["label"] * half + ["skip"] + ["label"] * (answers - half)


def _demo_http(port: int, moves: list, image_dir=None) -> dict:
    """Drive one demo session over HTTP: ``/api/start``, then each move
    (an honest answer, the item's true label, or ``"skip"``), reading the
    server's session for the selection probability after each. With
    ``image_dir`` also fetch the last proposed item's image and hold it to
    the committed file. Returns ``{"idx", "prob", "pbest", "ms"}`` lists
    (``ms``: each click's HTTP round trip, host clock)."""
    import numpy as np

    from coda_tpu_torch.demo import app

    steps = {"idx": [], "prob": [], "pbest": [], "ms": []}

    def post(path, body):
        t0 = time.perf_counter()
        status, text = _http(port, "POST", path, body)
        steps["ms"].append(1e3 * (time.perf_counter() - t0))
        if status != 200:
            raise AssertionError(f"demo {path}: HTTP {status}: {text}")
        return json.loads(text)

    out = post("/api/start", {})
    token, state = out["token"], out["state"]
    sess = app._SESSIONS[token]

    def keep(state):
        steps["idx"].append(state["idx"])
        steps["prob"].append(sess.current_prob)
        steps["pbest"].append(np.asarray(state["pbest"], np.float32))

    keep(state)
    for move in moves:
        label = "skip" if move == "skip" else state["true_label"]
        state = post("/api/answer", {"token": token, "label": label})
        keep(state)
    n_skip = moves.count("skip")
    if (state["n_labeled"], state["n_skipped"]) != (len(moves) - n_skip,
                                                    n_skip):
        raise AssertionError(f"demo counts {state['n_labeled']}, "
                             f"{state['n_skipped']}")
    if state != post("/api/state", {"token": token}):
        raise AssertionError("demo /api/state differs from the last answer")
    steps["ms"].pop()
    if image_dir is not None:
        import urllib.request

        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/image?token={token}"
                f"&idx={state['idx']}", timeout=60) as resp:
            status, got = resp.status, resp.read()
        path = os.path.join(image_dir, f"digit_{state['idx']:04d}.png")
        with open(path, "rb") as f:
            if status != 200 or got != f.read():
                raise AssertionError(f"demo image: not {path}")
    return steps


def _demo_twin(selector, labels, moves: list, gaps: bool = False) -> dict:
    """The demo's moves through an ``InteractiveSelector`` driven directly
    (a skip clears the item from the pool, as the demo does): each step's
    ``idx``, ``prob``, ``pbest`` and, with ``gaps``, the runner-up gap of
    the scores the pick was made from (the select is run once more on the
    same key first; it reads the state only)."""
    import torch

    from coda_tpu_torch import random as trandom

    get_pbest = selector.selector.extras["get_pbest"]
    steps = {"idx": [], "prob": [], "pbest": [], "gap": []}

    def pick():
        if gaps:
            _, sub = trandom.split(selector._key)
            scores = selector.selector.select(selector.state, sub).scores
            top = torch.topk(scores.float(), 2).values
            steps["gap"].append(float(top[0] - top[1]))
        idx, prob = selector.get_next_item_to_label()
        steps["idx"].append(idx)
        steps["prob"].append(prob)
        steps["pbest"].append(get_pbest(selector.state).float().cpu()
                              .numpy())
        return idx, prob

    idx, prob = pick()
    for move in moves:
        if move == "skip":
            selector.state.unlabeled[idx] = False
        else:
            selector.add_label(idx, int(labels[idx]), prob)
        idx, prob = pick()
    return steps


def _hold_demo(what: str, http: dict, twin: dict, plain: dict) -> str:
    """The HTTP run bitwise its ``InteractiveSelector`` twin; against the
    plain versions the same item at every step, or first a tie-break flip
    whose gap (the plain run's) is at most the contract, P(best) within
    the contract until then. Returns the verdict."""
    import numpy as np

    for t in range(len(http["idx"])):
        if (http["idx"][t], http["prob"][t]) != (twin["idx"][t],
                                                 twin["prob"][t]) or \
                not np.array_equal(http["pbest"][t], twin["pbest"][t]):
            raise AssertionError(f"demo {what}: step {t} not bitwise the "
                                 "InteractiveSelector on the card")
    verdict = f"PARITY ({len(http['idx'])} steps)"
    for t in range(len(http["idx"])):
        if http["idx"][t] != plain["idx"][t]:
            gap = plain["gap"][t]
            if abs(gap) > CONTRACT:
                raise AssertionError(
                    f"demo {what}: step {t} picks {http['idx'][t]}, the "
                    f"plain versions {plain['idx'][t]} at a runner-up gap "
                    f"{gap:.3e}")
            verdict = (f"first divergence at step {t} [tie-break-flip], "
                       f"runner-up gap {gap:.3e}")
            break
        err = float(np.abs(http["pbest"][t] - plain["pbest"][t]).max())
        if err > CONTRACT:
            raise AssertionError(f"demo {what}: step {t} P(best) {err:.3e} "
                                 "from the plain versions'")
    return verdict


def phase_demo(dev, task, total: dict, smi: str) -> dict:
    """The human-in-the-loop demo over HTTP on the card: the out-of-the-box
    pool (digits_clip with its images) and one headline session, each with
    the launch counters set to 0 just before and read just after, held
    bitwise against an ``InteractiveSelector`` and by the triage's rule
    against the plain versions. Returns the headline clicks' host ms."""
    import argparse

    import torch

    from coda_tpu_torch.data import Dataset
    from coda_tpu_torch.demo import app
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.selectors.protocol import InteractiveSelector

    t_phase = time.perf_counter()
    args = argparse.Namespace(task=None, synthetic=None, data_dir="data",
                              images_dir=None, device=dev.type)
    clip = Dataset.from_file(app.REAL_POOL, device=dev)
    labels_clip = clip.labels.cpu().numpy()
    C, N, H = HEADLINE
    labels_head = task.labels.cpu().numpy()
    runs = (("digits_clip", app.default_factory(args), clip.preds,
             labels_clip, DEMO_DIGITS_ANSWERS, app.REAL_IMAGES),
            (f"headline ({H}, {N}, {C})",
             lambda: app.DemoSession(task.preds, task.labels, seed=0,
                                     device=dev),
             task.preds, labels_head, DEMO_HEADLINE_ANSWERS, None))
    out = {}
    for what, factory, preds, labels, answers, images in runs:
        moves = _demo_moves(answers)
        srv = app.make_server(factory, 0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            torch.cuda.synchronize()
            reset_counts()
            http = _demo_http(srv.server_address[1], moves, images)
            torch.cuda.synchronize()
            counts, by_flavour = read_counts()
        finally:
            srv.shutdown()
            srv.server_close()
            app._SESSIONS.clear()
        n = moves.count("label")
        want = {"eig_score": 1, "eig_refresh_score": n, "row_gather": n}
        if by_flavour != want:
            raise AssertionError(f"demo {what}: launches {by_flavour}, "
                                 f"expected {want}")
        _tally(total, by_flavour)
        twin = _demo_twin(InteractiveSelector(
            make_coda(preds, CODAHyperparams(), device=dev), seed=0),
            labels, moves)
        plain = _demo_twin(InteractiveSelector(
            make_coda(preds, CODAHyperparams(eig_backend="plain"),
                      device=dev), seed=0), labels, moves, gaps=True)
        verdict = _hold_demo(what, http, twin, plain)
        clicks = http["ms"][1:]
        log(f"demo {what}: start + {n} answers + 1 skip over HTTP, "
            f"launches={json.dumps(counts)}; bitwise the "
            f"InteractiveSelector on the card; against the plain versions "
            f"{verdict}; start {http['ms'][0]:.1f} ms, a click p50 "
            f"{statistics.median(clicks):.3f} max {max(clicks):.3f} ms "
            f"(host, HTTP round trip; {smi})")
        out[what] = {"start_ms": http["ms"][0], "click_ms": clicks}
        del twin, plain, http
        gc.collect()
        torch.cuda.empty_cache()
    log(f"demo phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def _same_run(a, b, fields, what):
    import torch

    for f in fields:
        if not torch.equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{what}: {f} differs")


def phase_parity(dev):
    """digits_h80: kernel path == plain path on the card, and the
    seed-batched engine == seeds one after another; digits: agree with the
    reference package's committed record, batched and one after another."""
    import dataclasses

    from coda_tpu_torch.data import Dataset
    from coda_tpu_torch.engine import run_seeds_compiled
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda

    ds = Dataset.from_file(os.path.join(HERE, "data", "digits_h80.npz"),
                           device=dev)

    def run(iters, seeds=1, sequential=False, **kw):
        hp = CODAHyperparams(eig_chunk=1024, n_parallel=seeds, **kw)

        def factory(p):
            sel = make_coda(p, hp, device=dev)
            # without its batched form, the engine runs seeds one after
            # another
            return dataclasses.replace(sel, batched=None) if sequential \
                else sel

        return run_seeds_compiled(factory, ds.preds, ds.labels, iters=iters,
                                  seeds=seeds, device=dev)

    trajectory = ("chosen_idx", "true_class", "best_model", "regret")
    for refresh, tol in (("precomputed", 1e-5), ("fused", 1e-4)):
        k = run(30, eig_refresh=refresh)
        p = run(30, eig_refresh=refresh, eig_backend="plain")
        _same_run(k, p, trajectory,
                  f"digits_h80 {refresh} kernel vs plain")
        dprob = float((k.select_prob - p.select_prob).abs().max())
        if dprob > tol:
            raise AssertionError(f"digits_h80 {refresh} select_prob differs "
                                 f"by {dprob}")
        log(f"parity digits_h80 {tuple(ds.shape)} eig_refresh={refresh}: "
            f"30 rounds kernel == plain (idx, class, best, regret "
            f"identical; max |d select_prob|={dprob:.3e} <= {tol}), "
            f"regret@30={float(k.regret[0, -1]):.4f}")
    # the reference's long-horizon pin of the fused numerics
    # (test_fused_compute_long_horizon_widepool_trace), on the kernels
    f100, p100 = run(100, eig_refresh="fused"), run(100)
    _same_run(f100, p100, ("chosen_idx", "best_model"),
              "digits_h80 fused vs precomputed, 100 rounds")
    log(f"parity digits_h80: 100 rounds eig_refresh=fused == precomputed on "
        f"the kernels (chosen_idx, best_model identical), regret@100="
        f"{float(f100.regret[0, -1]):.4f}")
    # the seed-batched engine (kernels 4, 5 and the batched kernel 3)
    # against seeds one after another on the kernels and against the
    # batched plain versions
    reset_counts()
    b = run(30, seeds=3)
    counts, _ = read_counts()
    if (counts["eig_score_batched"], counts["eig_refresh_score_batched"],
            counts["row_gather_batched"]) != (1, 30, 30):
        raise AssertionError(f"digits_h80 batched run: launches {counts}")
    for other, what in ((run(30, seeds=3, sequential=True),
                         "one seed after another on the kernels"),
                        (run(30, seeds=3, eig_backend="plain"),
                         "batched on the plain versions")):
        _same_run(b, other, trajectory, f"digits_h80 batched vs {what}")
        dprob = float((b.select_prob - other.select_prob).abs().max())
        if dprob > 1e-5:
            raise AssertionError(f"digits_h80 batched vs {what}: "
                                 f"select_prob differs by {dprob}")
        log(f"parity digits_h80: 3 seeds x 30 rounds batched on the kernels "
            f"== {what} (idx, class, best, regret identical; max |d "
            f"select_prob|={dprob:.3e} <= 1e-05)")

    phase_digits_triage(dev)


def _save_and_load(res, aux, ds, dev, out_dir, run, knobs):
    """Write ``(res, aux)`` as a record under ``out_dir`` the way
    ``--record-dir`` does, read it back and hold it to the schema."""
    from coda_tpu_torch.telemetry.recorder import (
        RunRecord,
        environment_fingerprint,
    )

    RunRecord.from_result(
        res, aux, environment_fingerprint(dataset=ds, knobs=knobs,
                                          device=dev), run=run).save(out_dir)
    rec = RunRecord.load(out_dir)
    bad = rec.violations()
    if bad:
        raise AssertionError(f"record {out_dir} breaks the schema: {bad}")
    return rec


def _triage(got, ref, what: str, tol: float) -> list:
    """The port's triage of ``got`` against ``ref``: every seed at parity,
    or first diverging as a ``tie-break-flip`` (at q > 1 also a near tie
    of a round's first pick, ``replay.first_pick_flip``) where ``ref``'s
    runner-up gap is at most ``tol``. Prints each seed's line; returns
    them."""
    from coda_tpu_torch.engine.replay import compare_records, first_pick_flip

    report = compare_records(got, ref, score_tol=tol)
    lines, bad = [], []
    for s in report.seeds:
        if s.parity:
            line = f"seed {s.seed}: PARITY ({got.rounds} rounds)"
        else:
            t0 = s.first_divergent_round
            gap = float(ref.arrays["runner_up_gap"][s.seed, t0])
            tie = s.classification == "tie-break-flip"
            first = (not tie and ref.acq_batch > 1
                     and first_pick_flip(ref, got, s.seed, t0, tol))
            flip = tie or first
            note = ", a first-pick near tie" if first else ""
            line = (f"seed {s.seed}: first divergence at round {t0}, "
                    f"{s.quantity} [{s.classification}{note}], recorded "
                    f"runner-up gap {gap:.3e}")
            if not flip or abs(gap) > tol:
                bad.append(line)
        lines.append(line)
        log(f"triage {what}: {line}")
    if bad:
        raise AssertionError(f"{what}: divergence not a near-tie flip: "
                             f"{bad}")
    return lines


def phase_digits_triage(dev):
    """digits (14, 899, 10), 100 rounds x 3 seeds with the committed
    record's knobs, batched and one seed after another on the kernels:
    each recorded, and triaged against the reference package's committed
    record ``runs/surrogate_r17/exact`` at the cross-backend contract."""
    import dataclasses
    import tempfile

    from coda_tpu_torch.data import Dataset
    from coda_tpu_torch.engine import run_seeds_recorded
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.telemetry.recorder import (
        CROSS_BACKEND_SCORE_TOL,
        RunRecord,
    )

    ref = RunRecord.load(os.path.join(HERE, "runs", "surrogate_r17",
                                      "exact"))
    ds = Dataset.from_file(os.path.join(HERE, "data", "digits.npz"),
                           device=dev)
    seeds, iters = ref.seeds, ref.rounds
    want_digest = ref.meta["fingerprint"]["dataset"]["digest"]
    run = {"task": ds.name, "synthetic": None, "data_dir": "data",
           "method": "coda", "loss": "acc", "iters": iters, "seeds": seeds,
           "acq_batch": 1}
    with tempfile.TemporaryDirectory() as tmp:
        for sequential, how in ((False, "seeds batched"),
                                (True, "one seed after another")):
            hp = CODAHyperparams(eig_chunk=1024,
                                 n_parallel=1 if sequential else seeds)

            def factory(p):
                sel = make_coda(p, hp, device=dev)
                return dataclasses.replace(sel, batched=None) \
                    if sequential else sel

            reset_counts()
            res, aux = run_seeds_recorded(factory, ds.preds, ds.labels,
                                          iters=iters, seeds=seeds,
                                          device=dev)
            counts, _ = read_counts()
            k1, k2, k3 = (("eig_score", "eig_refresh_score", "row_gather")
                          if sequential else
                          ("eig_score_batched", "eig_refresh_score_batched",
                           "row_gather_batched"))
            n = seeds if sequential else 1
            if (counts[k1], counts[k2], counts[k3]) != (n, n * iters,
                                                        n * iters):
                raise AssertionError(f"digits ({how}): launches {counts}")
            got = _save_and_load(
                res, aux, ds, dev, os.path.join(tmp, how.replace(" ", "_")),
                run, {"method": "coda", "eig_chunk": 1024, "seeds": seeds,
                      "n_parallel": hp.n_parallel})
            digest = got.meta["fingerprint"]["dataset"]["digest"]
            if digest != want_digest:
                raise AssertionError(f"digits digest {digest} != the "
                                     f"record's {want_digest}")
            _triage(got, ref, f"digits {tuple(ds.shape)} ({how}) vs "
                    "runs/surrogate_r17/exact", CROSS_BACKEND_SCORE_TOL)
    log(f"reference record digits: dataset digest {want_digest}, schema "
        f"v{got.meta['schema_version']} record clean, every seed at parity "
        "or a near-tie flip")


BASELINE_ROUNDS = 20
H80_SEEDS, H80_ROUNDS = 3, 30


def _baseline_factory(method, iters, dev):
    from coda_tpu_torch.selectors import DEFAULT_EPS, SELECTOR_FACTORIES

    kw = ({"budget": iters} if method in ("activetesting", "vma") else
          {"epsilon": DEFAULT_EPS} if method == "model_picker" else {})
    return lambda p: SELECTOR_FACTORIES[method](p, device=dev, **kw)


BASELINES = ("iid", "uncertainty", "activetesting", "vma", "model_picker")


def phase_baselines(dev, task) -> dict:
    """The five baselines at the headline width, 1 seed x BASELINE_ROUNDS
    rounds on the card, twice in one process (identical trajectories);
    then on digits_h80, 3 seeds x 30 rounds on the card and on the CPU,
    triaged. Returns {method: (init_ms, ms_per_round, peak_gb)} of the
    second headline run. None of them launches a kernel of this repo."""
    import numpy as np
    import torch

    from coda_tpu_torch.data import Dataset
    from coda_tpu_torch.engine import run_seeds_compiled, run_seeds_recorded
    from coda_tpu_torch.telemetry.recorder import (
        CROSS_BACKEND_SCORE_TOL,
        RunRecord,
    )

    C, N, H = HEADLINE
    iters = BASELINE_ROUNDS
    fields = ("chosen_idx", "true_class", "best_model", "regret",
              "select_prob", "regret_at_0", "stochastic")
    out = {}
    for method in BASELINES:
        runs, timings = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            timings.clear()
            reset_counts()
            res = run_seeds_compiled(_baseline_factory(method, iters, dev),
                                     task.preds, task.labels, iters=iters,
                                     seeds=1, device=dev, timings=timings)
            torch.cuda.synchronize()
            _, by_flavour = read_counts()
            if by_flavour:
                raise AssertionError(f"{method}: launched {by_flavour}")
            _check_run(res, method, iters, N)
            runs.append(res)
        _same_run(runs[0], runs[1], fields, f"{method} headline, run 1 vs 2")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        init_ms = timings[0]["init_ms"]
        round_ms = timings[0]["rounds_ms"] / iters
        out[method] = (init_ms, round_ms, peak_gb)
        log(f"baseline {method} ({H}, {N}, {C}), 1 seed x {iters} rounds: "
            f"two runs identical; second run init_ms={init_ms:.2f} "
            f"ms_per_round={round_ms:.3f} peak_mem_gb={peak_gb:.3f} "
            f"regret@{iters}={float(runs[1].regret[0, -1]):.4f}")
        del runs, res

    ds = {d: Dataset.from_file(os.path.join(HERE, "data", "digits_h80.npz"),
                               device=d) for d in (dev, "cpu")}
    for method in BASELINES:
        recs = {}
        for d in (dev, "cpu"):
            res, aux = run_seeds_recorded(
                _baseline_factory(method, H80_ROUNDS, d), ds[d].preds,
                ds[d].labels, iters=H80_ROUNDS, seeds=H80_SEEDS, device=d)
            recs[d] = RunRecord.from_result(res, aux, {}, {})
        lines = _triage(recs[dev], recs["cpu"],
                        f"digits_h80 {method} card vs CPU",
                        CROSS_BACKEND_SCORE_TOL)
        a, b = recs[dev].arrays, recs["cpu"].arrays
        # regrets are differences of mean losses over N, which the card
        # and the CPU sum in other orders
        same = all(np.array_equal(a[f], b[f]) for f in (
            "chosen_idx", "true_class", "best_model")) and np.allclose(
                a["regret"], b["regret"], rtol=0, atol=1e-6)
        log(f"baseline {method} digits_h80 {tuple(ds['cpu'].shape)}, "
            f"{H80_SEEDS} seeds x {H80_ROUNDS} rounds: card vs CPU "
            f"trajectories {'identical' if same else 'triaged'} "
            f"({'; '.join(lines)})")
    return out


def phase_recorded(dev, task, total: dict) -> None:
    """CODA at the headline with its default knobs, 1 seed x 20 rounds:
    unrecorded, then recorded through the CLI's ``--record-dir`` into a
    temporary directory (the record held to the schema and to the
    unrecorded trajectory), then recorded through ``run_seeds_recorded``
    for the recording round's time. Each run's launches are counted and
    added to ``total``."""
    import tempfile

    import numpy as np
    import torch

    from coda_tpu_torch import cli
    from coda_tpu_torch.engine import run_seeds_compiled, run_seeds_recorded
    from coda_tpu_torch.ops.eig_kernels import flavour
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.telemetry.recorder import RunRecord

    C, N, H = HEADLINE
    iters = 20
    hp = CODAHyperparams(eig_chunk=1024)
    want = {flavour("eig_score", torch.float32, False): 1,
            flavour("eig_refresh_score", torch.float32, False): iters,
            "row_gather": iters}

    def counted(what, fn):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        _, by_flavour = read_counts()
        if by_flavour != want:
            raise AssertionError(f"{what}: launches {by_flavour}, expected "
                                 f"{want}")
        _tally(total, by_flavour)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "record")
        counted("recorded run (CLI --record-dir)", lambda: cli.main([
            "--synthetic", f"{H},{N},{C}", "--method", "coda", "--iters",
            str(iters), "--seeds", "1", "--record-dir", out_dir,
            "--no-mlflow"]))
        rec = RunRecord.load(out_dir)
        bad = rec.violations()
        if bad:
            raise AssertionError(f"the CLI's record breaks the schema: {bad}")
    t_plain, t_rec = [], []
    plain = counted("unrecorded run", lambda: run_seeds_compiled(
        lambda p: make_coda(p, hp, device=dev), task.preds, task.labels,
        iters=iters, seeds=1, device=dev, timings=t_plain))
    res, aux = counted("recorded run", lambda: run_seeds_recorded(
        lambda p: make_coda(p, hp, device=dev), task.preds, task.labels,
        iters=iters, seeds=1, device=dev, timings=t_rec))
    for f in ("chosen_idx", "best_model", "regret"):
        if not (np.array_equal(rec.arrays[f], getattr(plain, f).cpu().numpy())
                and torch.equal(getattr(res, f), getattr(plain, f))):
            raise AssertionError(f"recording changed {f}")
    top = aux.trace.topk_score[0].cpu()
    if not torch.allclose(aux.trace.chosen_score[0].cpu(),
                          res.select_prob[0].cpu()):
        raise AssertionError("recorded chosen score != select_prob")
    log(f"recorded CODA ({H}, {N}, {C}), 1 seed x {iters} rounds: CLI "
        f"--record-dir record clean (schema v{rec.meta['schema_version']}, "
        f"digest {rec.meta['fingerprint']['dataset']['digest']}); chosen_idx, "
        f"best_model, regret == the unrecorded run's; ms_per_round "
        f"recorded={t_rec[0]['rounds_ms'] / iters:.3f} unrecorded="
        f"{t_plain[0]['rounds_ms'] / iters:.3f}; init_ms recorded="
        f"{t_rec[0]['init_ms']:.1f} unrecorded={t_plain[0]['init_ms']:.1f}; "
        f"round-0 top-2 scores {top[0, :2].tolist()}")
    del plain, res, aux


# -- the rest of CODA: the EIG tiers and knobs ------------------------------

TIER_ROUNDS = 5                    # the headline's 5-seed factored batch
SPARSE_POOL = (500, 256, 1000)     # (H, N, C): scripts/imagenet_sparse.py
SPARSE_ROUNDS, SPARSE_CHUNK = 51, 64
POOL_BATCH_ROUNDS = 3              # the pool's 5-seed batch on kernels 4, 5
REST_ROUNDS = 10
CONTRACT = 2.34e-4                 # the cross-backend score contract


def _tier_run(dev, task, iters, seeds, what, total=None, want=None,
              warmup=False, **knobs):
    """One recorded CODA run through ``run_seeds_recorded``, counters set
    to 0 just before and read just after; ``want`` (launches by flavour)
    is checked and added to ``total``. ``warmup`` runs one untimed round
    of the same configuration first (the first products of a shape load
    their cuBLAS kernels and grow the allocator's pool), so the timed
    window does not depend on which phases ran before it. Returns
    ``(record, timings, peak_gb, resolved eig_mode)``; the selector is
    dropped, so a later run's peak memory is its own."""
    import torch

    from coda_tpu_torch.engine import run_seeds_recorded
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.telemetry.recorder import RunRecord

    knobs.setdefault("eig_chunk", 1024)
    hp = CODAHyperparams(n_parallel=seeds, **knobs)
    sels, timings = [], []

    def factory(p):
        sels.append(make_coda(p, hp, device=dev))
        return sels[-1]

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if warmup:
        run_seeds_recorded(factory, task.preds, task.labels, iters=1,
                           seeds=seeds, device=dev)
        torch.cuda.synchronize()
        sels.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res, aux = run_seeds_recorded(factory, task.preds, task.labels,
                                  iters=iters, seeds=seeds, device=dev,
                                  timings=timings)
    torch.cuda.synchronize()
    _, by_flavour = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if want is not None:
        if by_flavour != want:
            raise AssertionError(f"{what}: launches {by_flavour}, expected "
                                 f"{want}")
        _tally(total, by_flavour)
    _check_run(res, what, iters, task.preds.shape[1])
    rec = RunRecord.from_result(res, aux, {}, {})
    return rec, timings, peak_gb, sels[0].extras["eig_mode"]


def _round_ms(timings, iters) -> float:
    return sum(t["rounds_ms"] for t in timings) / iters


def _same_record(a, b, what, seed_a=None):
    import numpy as np

    for f, arr in b.arrays.items():
        got = a.arrays[f] if seed_a is None else a.arrays[f][seed_a:seed_a + 1]
        if not np.array_equal(got, arr, equal_nan=True):
            raise AssertionError(f"{what}: {f} differs")


def _first_scores(sel, state, key):
    """The round-0 score vector of a selector's state (candidates only)."""
    import torch

    res = sel.select(state, key)
    s = res.scores
    return torch.where(torch.isfinite(s), s, torch.zeros_like(s))


def _score_gap(a, b) -> float:
    return float((a - b).abs().max())


def _precision_products(sel, state, precision: str, block: int = 1024):
    """The factored tier's intermediate products for the first ``block``
    items of every class row, on ``state``'s posterior, at an
    ``eig_precision``: ``(S, t_base, hyp)``, S the exclusive log-cdf sum
    ``(C, B, G)``, t_base the base product ``(C, B, H)`` and hyp the
    normalised hypothetical rows, each from its own precision's
    predecessors, as the tier computes them."""
    import torch

    from coda_tpu_torch.ops.pbest import (_bump_tables,
                                          _pbest_hyp_from_tables,
                                          _trapz_weights, eig_matmul,
                                          pbest_grid)
    from coda_tpu_torch.selectors.coda import _beta_rows, _class_eq

    hard = sel.extras["hard_preds"]
    aT, bT = _beta_rows(state.dirichlets)
    C, G = aT.shape[0], 256
    x = pbest_grid(G, aT.device)
    dx = x[1] - x[0]
    w = _trapz_weights(G, dx)
    tables = _bump_tables(aT, bT, x, dx, 1.0)
    S0, dlog, F_u, _ = tables
    eq = _class_eq(hard[:block], torch.arange(C, dtype=hard.dtype,
                                              device=hard.device))
    S = S0.unsqueeze(-2) + eig_matmul(eq, dlog, precision)
    wE = w * torch.exp(S - S.amax(-1, keepdim=True))
    t_base = eig_matmul(wE, F_u.transpose(-1, -2), precision)
    return S, t_base, _pbest_hyp_from_tables(tables, eq, w, precision)


def _forced_replay(dev, task, ref, **knobs) -> dict:
    """A one-seed run with a committed record's items and labels forced on
    it: each round scores the posterior the record's run had reached, then
    takes the record's item and label. Returns the largest |difference|
    from the record over every round of the top-k scores, ``pbest_max``
    and ``pbest_entropy``, and the rounds whose best model differs. A
    sparse posterior is also mirrored on the host from the card's initial
    state through the same ``scatter_row`` calls: ``sparse_equal`` says
    whether the card's state after the last round is bitwise the host's,
    ``untracked`` counts the model updates that hit an untracked column
    (the eviction and residual branches of K < C)."""
    import numpy as np
    import torch

    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.ops.masked import entropy2
    from coda_tpu_torch.ops.sparse_rows import SparseRows, scatter_row
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda

    A = ref.arrays
    hp = CODAHyperparams(**knobs)
    sel = make_coda(task.preds, hp, device=dev)
    state = sel.init()
    hard = sel.extras["hard_preds"]
    host = (None if state.sparse is None
            else SparseRows(*(t.cpu().clone() for t in state.sparse)))
    k = A["topk_score"].shape[-1]
    worst = {"topk_score": 0.0, "pbest_max": 0.0, "pbest_entropy": 0.0}
    best_differs = untracked = 0
    for t in range(A["chosen_idx"].shape[1]):
        key = torch.from_numpy(A["round_key"][0, t].astype(np.int64)).to(dev)
        k_sel, k_best = trandom.split(key)
        res = sel.select(state, k_sel)
        top = torch.topk(res.scores.float(), k).values.cpu().numpy()
        idx = torch.tensor(int(A["chosen_idx"][0, t]), device=dev)
        state = sel.update(state, idx, task.labels.take(idx), res.prob)
        c = int(A["true_class"][0, t])
        if int(task.labels[idx]) != c:
            raise AssertionError(f"round {t}: the task's label differs "
                                 "from the record's")
        if host is not None:
            pred = hard[idx].cpu()
            hit = (host.idx[:, c, :] == pred[:, None].to(host.idx.dtype)
                   ).any(-1)
            untracked += int(((pred != c) & ~hit).sum())
            scatter_row(host, torch.tensor(c), pred, hp.learning_rate)
        best, _ = sel.best(state, k_best)
        best_differs += int(best) != int(A["best_model"][0, t])
        pb = sel.extras["get_pbest"](state).float()
        got = {"topk_score": top, "pbest_max": float(pb.max()),
               "pbest_entropy": float(entropy2(pb))}
        for q, v in got.items():
            d = float(np.max(np.abs(np.asarray(v) - A[q][0, t])))
            if not d <= worst[q]:
                worst[q] = d
    worst["best_model_rounds"] = best_differs
    if host is not None:
        worst["sparse_equal"] = all(torch.equal(a.cpu(), b) for a, b in
                                    zip(state.sparse, host))
        worst["untracked"] = untracked
    return worst


def _scatter_branches(dev, pool, spec: str, rounds: int = 192) -> tuple:
    """The K < C scatter on the card against a host mirror: ``rounds``
    labels of two classes with seeded model predictions (most of them
    untracked columns) scattered into the pool's sparse prior on the card
    and on the host, at increments of 1 and 1e-3 in turn: the unit ones
    evict the prior's entries until a row holds only larger ones, and
    then a small one goes to the residual.
    Returns ``(bitwise equal, updates that hit an untracked column,
    entries evicted, the fields that differ)``."""
    import numpy as np
    import torch

    from coda_tpu_torch.ops.sparse_rows import SparseRows, scatter_row
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda

    card = make_coda(pool.preds, CODAHyperparams(
        eig_mode="incremental", eig_chunk=SPARSE_CHUNK, posterior=spec),
        device=dev).init().sparse
    host = SparseRows(*(t.cpu().clone() for t in card))
    H, C = host.diag.shape
    rng = np.random.default_rng(0)
    untracked = evicted = 0
    for t in range(rounds):
        lr = 1e-3 if t % 2 else 1.0
        c = int(rng.integers(2))
        pred = torch.from_numpy(rng.integers(C, size=H).astype(np.int32))
        hit = (host.idx[:, c, :] == pred[:, None]).any(-1)
        untracked += int(((pred != c) & ~hit).sum())
        before = host.idx[:, c, :].clone()
        scatter_row(card, torch.tensor(c, device=dev), pred.to(dev), lr)
        scatter_row(host, torch.tensor(c), pred, lr)
        evicted += int((host.idx[:, c, :] != before).sum())
    differ = [f for f, a, b in zip(SparseRows._fields, card, host)
              if not torch.equal(a.cpu(), b)]
    return not differ, untracked, evicted, differ


def phase_tiers(dev, task, total: dict) -> dict:
    """The rest of CODA on the card. The headline's CLI default (5 seeds
    in one batch, auto knobs) resolving to the factored tier and launching
    no kernel, held bitwise to a one-seed factored run and triaged against
    the incremental tier; eig_precision high/default; rowscan at the
    headline and at the imagenet_sparse pool; direct on digits_h80; the
    sparse posterior at the imagenet_sparse pool against the committed
    records; the amortized P(best), pi_update=exact, the prefilter and the
    q ablations at the headline. Returns the measured figures."""
    import numpy as np
    import torch

    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.data import Dataset, make_synthetic_task
    from coda_tpu_torch.ops.eig_kernels import flavour
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.selectors.coda import row_beta
    from coda_tpu_torch.telemetry.recorder import RunRecord

    C, N, H = HEADLINE
    f32 = torch.float32
    out: dict = {}
    key0 = trandom.PRNGKey(0)

    # 1. the CLI default at the headline: 5 seeds, auto -> factored
    rec_f, tm, peak, mode = _tier_run(dev, task, TIER_ROUNDS, SEEDS,
                                      "factored headline", total, {},
                                      warmup=True)
    if mode != "factored":
        raise AssertionError(f"auto at the headline with {SEEDS} seeds "
                             f"resolved to {mode}")
    out["factored"] = (tm[0]["init_ms"], _round_ms(tm, TIER_ROUNDS), peak)
    log(f"tiers: headline ({H}, {N}, {C}), CLI default knobs, {SEEDS} seeds "
        f"in one batch x {TIER_ROUNDS} rounds after an untimed one: "
        f"eig_mode auto -> factored, "
        f"0 kernel launches; init_ms={tm[0]['init_ms']:.1f} "
        f"ms_per_round={out['factored'][1]:.3f} ms_per_seed_round="
        f"{out['factored'][1] / SEEDS:.3f} peak_mem_gb={peak:.2f}")
    one, _, _, _ = _tier_run(dev, task, TIER_ROUNDS, 1, "factored one seed",
                             total, {}, eig_mode="factored")
    _same_record(rec_f, one, "factored seed 0 of 5 vs one seed", seed_a=0)
    log("tiers: factored seed 0 of the 5-seed batch == the one-seed "
        "factored run (every recorded array bitwise)")
    rec_i, tmi, peak_i, _ = _tier_run(
        dev, task, TIER_ROUNDS, SEEDS, "incremental headline", total,
        {flavour("eig_score_batched", f32, False): 1,
         flavour("eig_refresh_score_batched", f32, False): TIER_ROUNDS,
         "row_gather_batched": TIER_ROUNDS}, eig_mode="incremental")
    out["incremental"] = (tmi[0]["init_ms"], _round_ms(tmi, TIER_ROUNDS),
                          peak_i)
    fac1 = make_coda(task.preds, CODAHyperparams(eig_mode="factored",
                                                 eig_chunk=1024), device=dev)
    inc1 = make_coda(task.preds, CODAHyperparams(eig_mode="incremental",
                                                 eig_chunk=1024), device=dev)
    s_f = _first_scores(fac1, fac1.init(), key0)
    gap = _score_gap(s_f, _first_scores(inc1, inc1.init(), key0))
    del inc1
    if gap > CONTRACT:
        raise AssertionError(f"round-0 scores factored vs incremental "
                             f"differ by {gap}")
    lines = _triage(rec_f, rec_i, "headline factored vs incremental",
                    CONTRACT)
    log(f"tiers: round-0 scores factored vs incremental max |d|={gap:.3e} "
        f"<= {CONTRACT}; incremental batch init_ms={tmi[0]['init_ms']:.1f} "
        f"ms_per_round={out['incremental'][1]:.3f} peak_mem_gb="
        f"{peak_i:.2f}; triage {'; '.join(lines)}")
    # high is the fp32 product on this card: bitwise highest; default's
    # one TF32 pass reaches the products, and the scores by as much as
    # the hypothetical rows' relative error times the scores' size
    st0 = fac1.init()
    ref_p = _precision_products(fac1, st0, "highest")
    for prec in ("high", "default"):
        selp = make_coda(task.preds, CODAHyperparams(
            eig_mode="factored", eig_chunk=1024, eig_precision=prec),
            device=dev)
        d = _score_gap(_first_scores(selp, selp.init(), key0), s_f)
        del selp
        dp = [float((p - r).abs().max() / r.abs().max())
              for p, r in zip(_precision_products(fac1, st0, prec), ref_p)]
        if prec == "high" and (d != 0.0 or max(dp) != 0.0):
            raise AssertionError(f"eig_precision=high is not the fp32 "
                                 f"product: scores {d}, products {dp}")
        if prec == "default" and min(dp) == 0.0:
            raise AssertionError("eig_precision=default left a product "
                                 f"in fp32: {dp}")
        _, tp, _, _ = _tier_run(dev, task, 2, SEEDS, f"factored {prec}",
                                total, {}, warmup=True, eig_precision=prec)
        out[f"precision_{prec}"] = (d, _round_ms(tp, 2), dp)
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError(f"eig_precision={prec} left TF32 on")
        log(f"tiers: eig_precision={prec} factored {SEEDS} seeds x 2 rounds "
            f"after an untimed one: round-0 max |d score| vs highest="
            f"{d:.3e} (scores up to {float(s_f.abs().max()):.4f}); "
            f"first 1024 items' products vs highest, max |d| / max |.|: "
            f"S {dp[0]:.3e}, t_base {dp[1]:.3e}, hypothetical rows "
            f"{dp[2]:.3e}; ms_per_round={out[f'precision_{prec}'][1]:.3f}; "
            f"allow_tf32 after: {torch.backends.cuda.matmul.allow_tf32}")
    del st0, ref_p
    del fac1

    # 2. rowscan: at the headline, then the imagenet_sparse pool
    rows1 = make_coda(task.preds, CODAHyperparams(eig_mode="rowscan",
                                                  eig_chunk=1024), device=dev)
    d = _score_gap(_first_scores(rows1, rows1.init(), key0), s_f)
    del rows1, s_f
    if d > CONTRACT:
        raise AssertionError(f"rowscan vs factored round-0 scores: {d}")
    _, tr, pr, _ = _tier_run(dev, task, 2, 1, "rowscan headline", total, {},
                             eig_mode="rowscan")
    log(f"tiers: rowscan headline 1 seed x 2 rounds: round-0 max |d score| "
        f"vs factored={d:.3e}; ms_per_round={_round_ms(tr, 2):.3f} "
        f"peak_mem_gb={pr:.2f}")
    Hs, Ns, Cs = SPARSE_POOL
    pool = make_synthetic_task(seed=5, H=Hs, N=Ns, C=Cs, device=dev)
    _, trs, prs, mode = _tier_run(dev, pool, 3, SEEDS, "rowscan pool", total,
                                  {}, warmup=True)
    if mode != "rowscan":
        raise AssertionError(f"auto at {SPARSE_POOL} with {SEEDS} seeds "
                             f"resolved to {mode}")
    out["rowscan_pool"] = (trs[0]["init_ms"], _round_ms(trs, 3), prs)
    log(f"tiers: imagenet_sparse pool {SPARSE_POOL}, {SEEDS} seeds x 3 "
        f"rounds after an untimed one: eig_mode auto -> rowscan; init_ms={trs[0]['init_ms']:.1f} "
        f"ms_per_round={out['rowscan_pool'][1]:.3f} peak_mem_gb={prs:.2f}")

    # 3. direct on digits_h80, triaged against factored
    h80 = Dataset.from_file(os.path.join(HERE, "data", "digits_h80.npz"),
                            device=dev)
    rd, td, _, _ = _tier_run(dev, h80, 10, 3, "direct digits_h80", total, {},
                             eig_mode="direct")
    rfa, _, _, _ = _tier_run(dev, h80, 10, 3, "factored digits_h80", total,
                             {}, eig_mode="factored")
    lines = _triage(rd, rfa, "digits_h80 direct vs factored", CONTRACT)
    out["direct_h80"] = _round_ms(td, 10)
    log(f"tiers: direct digits_h80 {tuple(h80.shape)} 3 seeds x 10 rounds: "
        f"ms_per_round={out['direct_h80']:.3f}; triage {'; '.join(lines)}")

    # 4. the sparse posterior at the imagenet_sparse pool
    sp_knobs = dict(eig_mode="incremental", eig_chunk=SPARSE_CHUNK)
    want1 = {flavour("eig_score", f32, False): 1,
             flavour("eig_refresh_score", f32, False): SPARSE_ROUNDS,
             "row_gather": SPARSE_ROUNDS}
    recs = {}
    for spec in ("sparse:32", "dense", f"sparse:{Cs}"):
        recs[spec], ts, ps, _ = _tier_run(dev, pool, SPARSE_ROUNDS, 1,
                                          f"pool {spec}", total, want1,
                                          posterior=spec, **sp_knobs)
        out[f"pool_{spec}"] = (_round_ms(ts, SPARSE_ROUNDS), ps)
        log(f"tiers: pool {spec} 1 seed x {SPARSE_ROUNDS} rounds on kernels "
            f"1-3: ms_per_round={out[f'pool_{spec}'][0]:.3f} "
            f"peak_mem_gb={ps:.2f}")
    refs = {}
    for spec, ref_dir in (("sparse:32", "sparse"), ("dense", "dense")):
        refs[spec] = RunRecord.load(os.path.join(
            HERE, "runs", "imagenet_sparse_r12", ref_dir))
        lines = _triage(recs[spec], refs[spec], f"pool {spec} vs runs/"
                        f"imagenet_sparse_r12/{ref_dir}", CONTRACT)
    # the triage stops at the first divergence (round 0, a tie): every
    # round is held by forcing the record's items and labels on the card's
    # run, each record with its own posterior and the sparse record with
    # the dense posterior too (what the truncation moves)
    for spec, ref_spec in (("sparse:32", "sparse:32"), ("dense", "dense"),
                           ("dense", "sparse:32")):
        w = _forced_replay(dev, pool, refs[ref_spec], posterior=spec,
                           **sp_knobs)
        if ref_spec == spec and (w["best_model_rounds"] or max(
                w[q] for q in ("topk_score", "pbest_max", "pbest_entropy"))
                > CONTRACT or not w.get("sparse_equal", True)):
            raise AssertionError(f"pool {spec} forced on the {ref_spec} "
                                 f"record: {w}")
        out[f"forced_{spec}_on_{ref_spec}"] = w
        log(f"tiers: pool {spec} with the runs/imagenet_sparse_r12 "
            f"{ref_spec} record's {SPARSE_ROUNDS} items and labels forced: "
            f"max |d| over every round: top-8 scores "
            f"{w['topk_score']:.3e}, pbest_max {w['pbest_max']:.3e}, "
            f"pbest_entropy {w['pbest_entropy']:.3e}; best model differs in "
            f"{w['best_model_rounds']} rounds"
            + ("" if "untracked" not in w else
               f"; {w['untracked']} model updates hit an untracked column "
               f"(eviction or residual), the card's sparse state after the "
               f"last round bitwise the host's scatter_row mirror: "
               f"{w['sparse_equal']}")
            + ("" if spec == ref_spec else " (not checked: another "
               "posterior)"))
    # the records' labels may never reach an untracked column: the
    # eviction and residual branches get seeded labels of their own
    same, miss, evicted, differ = _scatter_branches(dev, pool, "sparse:32")
    if not same or not evicted or miss == evicted:
        raise AssertionError(f"sparse:32 scatter on the card: fields "
                             f"differing from the host {differ}, untracked "
                             f"{miss}, evicted {evicted}")
    log(f"tiers: pool sparse:32 scatter_row, 192 seeded labels: {miss} "
        f"model updates hit an untracked column, {evicted} evicted a "
        f"tracked entry, the rest went to the residual; the card's state "
        f"bitwise the host's")
    _same_record(recs[f"sparse:{Cs}"], recs["dense"],
                 f"sparse:{Cs} vs dense on the card")
    log(f"tiers: sparse:{Cs} == dense on the card (every recorded array "
        "bitwise)")
    from coda_tpu_torch.ops import eig_kernels as ek

    k6 = flavour("eig_refresh_compute_score", f32, False)
    _tier_run(dev, pool, SPARSE_ROUNDS, 1, "pool sparse:32 fused", total,
              {flavour("eig_score", f32, False): 1, k6: SPARSE_ROUNDS,
               "row_gather": SPARSE_ROUNDS},
              posterior="sparse:32", eig_refresh="fused", **sp_knobs)
    if ek.split_counts.get(k6, 0) != SPARSE_ROUNDS:
        raise AssertionError(f"pool sparse:32 fused: kernel 6's split "
                             f"launches {ek.split_counts.get(k6, 0)}, "
                             f"expected {SPARSE_ROUNDS}")
    log(f"tiers: pool sparse:32 eig_refresh=fused: kernel 6 launched once a "
        f"round ({SPARSE_ROUNDS}), every launch on its short-axis split")
    # the pool's 5 seeds in one batch: auto keeps the incremental tier
    # (pi_update=exact drops the delta layout), and kernels 4 and 5 take
    # the class-chunk split at its 5 x 256 items
    R5 = POOL_BATCH_ROUNDS
    k45 = (flavour("eig_score_batched", f32, False),
           flavour("eig_refresh_score_batched", f32, False))
    _, tb, pb, mode = _tier_run(
        dev, pool, R5, SEEDS, "pool sparse:32 5 seeds exact", total,
        {k45[0]: 1, k45[1]: R5}, warmup=True, posterior="sparse:32",
        pi_update="exact")
    split = {k: ek.split_counts.get(k, 0) for k in k45}
    if mode != "incremental" or split != {k45[0]: 1, k45[1]: R5}:
        raise AssertionError(f"pool sparse:32 {SEEDS} seeds pi_update=exact: "
                             f"eig_mode auto -> {mode}, split launches "
                             f"{split}")
    out["pool_batch"] = (tb[0]["init_ms"], _round_ms(tb, R5), pb)
    log(f"tiers: pool sparse:32 pi_update=exact {SEEDS} seeds in one batch "
        f"x {R5} rounds after an untimed one: eig_mode auto -> incremental; "
        f"kernels 4 / 5 launched {split[k45[0]]} / {split[k45[1]]} times, "
        f"all on the class-chunk split; init_ms={tb[0]['init_ms']:.1f} "
        f"ms_per_round={out['pool_batch'][1]:.3f} ms_per_seed_round="
        f"{out['pool_batch'][1] / SEEDS:.3f} peak_mem_gb={pb:.2f}")
    del pool

    # 5. the rest at the headline, 1 seed x REST_ROUNDS
    R = REST_ROUNDS
    inc_want = {flavour("eig_score", f32, False): 1,
                flavour("eig_refresh_score", f32, False): R,
                "row_gather": R}
    rq, _, _, _ = _tier_run(dev, task, R, 1, "quad multiplier 20", total,
                            inc_want, multiplier=20.0)
    # twice: the logistic-normal tables' special functions are compiled
    # at their first call on the card; the second run is timed
    for _ in range(2):
        ra, ta, _, _ = _tier_run(dev, task, R, 1, "amortized multiplier 20",
                                 total, inc_want, multiplier=20.0,
                                 eig_pbest="amortized")
    # the gate per round, from the recorded labels: min_h(a + b) of the
    # labelled row after its label, on the run's prior
    sela = make_coda(task.preds, CODAHyperparams(
        eig_mode="factored", multiplier=20.0), device=dev)
    st = sela.init()
    hard = sela.extras["hard_preds"]
    engaged = 0
    for t in range(R):
        c = torch.tensor(int(ra.arrays["true_class"][0, t]), device=dev)
        idx = int(ra.arrays["chosen_idx"][0, t])
        st.dirichlets[torch.arange(H, device=dev), c,
                      hard[idx].long()] += 0.01
        a_t, b_t = row_beta(st.dirichlets, c)
        engaged += int(float((a_t + b_t).min()) >= 32.0)
    del st, sela, hard
    shared = int(np.argmax(np.append(ra.arrays["chosen_idx"][0]
                                     != rq.arrays["chosen_idx"][0], True)))
    d_am = max(float(np.max(np.abs(ra.arrays[q][0, :shared]
                                   - rq.arrays[q][0, :shared])))
               for q in ("topk_score", "chosen_score")) if shared else 0.0
    if d_am > CONTRACT:
        raise AssertionError(f"amortized scores differ from quad by {d_am}")
    lines = _triage(ra, rq, "amortized vs quad", CONTRACT)
    out["amortized"] = (_round_ms(ta, R), engaged, d_am)
    log(f"tiers: eig_pbest=amortized (multiplier 20) 1 seed x {R} rounds: "
        f"kernel 2 once a round; gate engaged in {engaged}/{R} rounds; max "
        f"|d score| vs quad over the {shared} shared rounds={d_am:.3e}; "
        f"ms_per_round={out['amortized'][0]:.3f}; triage {'; '.join(lines)}")
    rd_, td_, _, _ = _tier_run(dev, task, R, 1, "delta", total, inc_want)
    rex, tex, pex, _ = _tier_run(
        dev, task, R, 1, "pi_update exact", total,
        {flavour("eig_score", f32, False): 1,
         flavour("eig_refresh_score", f32, False): R}, pi_update="exact")
    lines = _triage(rex, rd_, "pi_update exact vs delta", CONTRACT)
    out["pi_exact"] = (_round_ms(tex, R), _round_ms(td_, R), pex)
    log(f"tiers: pi_update=exact 1 seed x {R} rounds: kernel 3 0 launches; "
        f"ms_per_round={out['pi_exact'][0]:.3f} (delta "
        f"{out['pi_exact'][1]:.3f}); peak_mem_gb={pex:.2f}; triage "
        f"{'; '.join(lines)}")
    for what, kw in (("prefilter_n=4096", dict(prefilter_n=4096)),
                     ("q=iid", dict(q="iid")),
                     ("q=uncertainty", dict(q="uncertainty"))):
        _, tq, pq, mode = _tier_run(dev, task, R, 1, what, total, {}, **kw)
        if what.startswith("prefilter") and mode != "factored":
            raise AssertionError(f"{what} resolved to {mode}")
        out[what] = (_round_ms(tq, R), pq)
        log(f"tiers: {what} 1 seed x {R} rounds (eig_mode "
            f"{mode}): ms_per_round={out[what][0]:.3f} "
            f"peak_mem_gb={pq:.2f}; finite, in range, no repeats")
    return out


# -- batched acquisition, the surrogate scorer, the tracking store ----------

BATCHQ_PATHS = ((1, 20), (4, 20), (8, 10))   # (q, rounds), headline, 1 seed
BATCHQ_SEED_ROUNDS = 5                 # the 5-seed q = 4 batch
BATCHQ_FLAVOUR_ROUNDS = 5              # bf16 + approx; fused + bf16
BATCHQ_BASELINE_ROUNDS = 10            # the baselines at q = 4 on digits_h80
SURROGATE_ROUNDS = 20                  # the speed runs, 1 seed
DONOR_ROUNDS = 20                      # the pool's donor session
TRACKING_ROUNDS = 5

# the reference's analysis query (paper/common.py's _SQL), copied here:
# the smoke reads the port's database with sqlite3 alone
_PAPER_SQL = """
SELECT  e.name   AS task,
        rn.value AS run_name,
        m.value  AS value,
        m.step   AS step
FROM    metrics   m
JOIN    runs      r   ON m.run_uuid      = r.run_uuid
JOIN    experiments e ON r.experiment_id = e.experiment_id
JOIN    tags t_parent
       ON r.run_uuid = t_parent.run_uuid
      AND t_parent.key = 'mlflow.parentRunId'
LEFT JOIN tags rn
       ON r.run_uuid = rn.run_uuid
      AND rn.key     = 'mlflow.runName'
WHERE   m.key  = ?
  AND   m.is_nan = 0
  AND   r.lifecycle_stage = 'active'
  AND   e.lifecycle_stage = 'active'
"""


def _q_run(dev, preds, labels, iters, seeds, q, what, total, want,
           prior=None, **knobs):
    """One recorded CODA run at ``q`` labels a round, counters set to 0
    just before and read just after. ``want`` (launches by flavour, or a
    function of the run's ``(result, aux)`` giving them) is checked and
    added to ``total``. Returns ``(result, aux, timings, peak_gb,
    selector)``."""
    import torch

    from coda_tpu_torch.engine import run_seeds_recorded
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda

    knobs.setdefault("eig_chunk", 1024)
    # the replicas the engine batches: a q-wide run's seeds go one after
    # another
    hp = CODAHyperparams(n_parallel=seeds if q == 1 else 1, **knobs)
    sels, timings = [], []

    def factory(p):
        sels.append(make_coda(p, hp, device=dev, prior=prior))
        return sels[-1]

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res, aux = run_seeds_recorded(factory, preds, labels, iters=iters,
                                  seeds=seeds, device=dev, timings=timings,
                                  acq_batch=q)
    torch.cuda.synchronize()
    _, by_flavour = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if callable(want):
        want = want(res, aux)
    if by_flavour != want:
        raise AssertionError(f"{what}: launches {by_flavour}, expected "
                             f"{want}")
    _tally(total, by_flavour)
    idx = res.chosen_idx.cpu().reshape(seeds, -1)
    regret = res.regret.cpu()
    N = preds.shape[1]
    if not (torch.isfinite(regret).all() and (regret >= 0).all()
            and (idx >= 0).all() and (idx < N).all()
            and all(len(set(r.tolist())) == iters * q for r in idx)):
        raise AssertionError(f"{what}: regret not finite and >= 0, or an "
                             "index out of range or labelled twice")
    return res, aux, timings, peak_gb, sels[0]


def phase_batchq_surrogate(dev, task, total: dict) -> dict:
    """Batched acquisition (``acq_batch`` q), the surrogate scorer and the
    tracking store on the card (see the module docstring, item 8). Every
    run has the counters set to 0 just before and read just after, its
    launches checked and added to ``total``. Returns the measured
    figures."""
    import contextlib
    import io
    import sqlite3
    import tempfile

    import numpy as np
    import torch

    from coda_tpu_torch import cli
    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.data import Dataset, make_synthetic_task
    from coda_tpu_torch.engine import run_seeds_recorded
    from coda_tpu_torch.engine.replay import (
        compare_records,
        within_prior_envelope,
    )
    from coda_tpu_torch.ops.eig_kernels import flavour
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.selectors import surrogate as sg
    from coda_tpu_torch.telemetry.recorder import RunRecord

    t_phase = time.perf_counter()
    C, N, H = HEADLINE
    f32, bf16 = torch.float32, torch.bfloat16
    k1, k3 = flavour("eig_score", f32, False), "row_gather"
    out: dict = {}

    def warm_full(aux, credit=0):
        """A surrogate run's full-pass rounds over its seeds: the warmup
        rounds its prior's credit leaves, then every fallback."""
        fb = aux.trace.surrogate_fallback.cpu().numpy()
        T = fb.shape[1]
        warm = max(0, min(T, sg.SURROGATE_WARMUP_ROUNDS - credit))
        return fb.shape[0] * warm + int(fb.sum())

    def record(res, aux, ds, tmp, name, knobs, q=1):
        run = {"task": ds.name, "synthetic": None, "data_dir": "data",
               "method": "coda", "loss": "acc",
               "iters": int(res.regret.shape[1]),
               "seeds": int(res.regret.shape[0]), "acq_batch": q}
        return _save_and_load(res, aux, ds, dev, os.path.join(tmp, name),
                              run, dict(knobs, method="coda"))

    # 1. the headline at q labels a round, one seed (q = 1 first, in the
    # same window, for the comparison)
    one = {}
    for q, iters in BATCHQ_PATHS:
        want = ({k1: 1 + iters, k3: q * iters} if q > 1 else
                {k1: 1, flavour("eig_refresh_score", f32, False): iters,
                 k3: iters})
        res, aux, tm, peak, _ = _q_run(
            dev, task.preds, task.labels, iters, 1, q, f"headline q={q}",
            total, want)
        ms = _round_ms(tm, iters)
        one[q] = RunRecord.from_result(res, aux, {}, {})
        out[f"q{q}"] = (ms, ms / q, peak)
        log(f"batchq: headline ({H}, {N}, {C}), 1 seed, q={q} x {iters} "
            f"rounds, default knobs: launches {json.dumps(want)}, nothing "
            f"else; ms_per_round={ms:.3f} ms_per_label={ms / q:.3f} "
            f"peak_mem_gb={peak:.2f}; regret@{iters}="
            f"{float(res.regret[0, -1]):.4f} cumulative="
            f"{float(res.cumulative_regret[0, -1]):.4f}")
        del res, aux
    R = BATCHQ_FLAVOUR_ROUNDS
    for what, knobs, want in (
            ("bf16 + approx", dict(eig_cache_dtype="bfloat16",
                                   eig_entropy="approx"),
             {flavour("eig_score", bf16, True): 1 + R, k3: 4 * R}),
            ("fused + bf16", dict(eig_refresh="fused",
                                  eig_cache_dtype="bfloat16"),
             {flavour("eig_score", bf16, False): 1,
              flavour("eig_refresh_compute_score", bf16, False): 4 * R,
              k3: 4 * R})):
        res, aux, tm, peak, sel = _q_run(
            dev, task.preds, task.labels, R, 1, 4, f"headline q=4 {what}",
            total, want, **knobs)
        ms = _round_ms(tm, R)
        out[f"q4 {what}"] = (ms, ms / 4, peak)
        log(f"batchq: headline q=4 {what}, 1 seed x {R} rounds: launches "
            f"{json.dumps(want)}; ms_per_round={ms:.3f} ms_per_label="
            f"{ms / 4:.3f} peak_mem_gb={peak:.2f}; fused update_q "
            f"{'off (q updates a round)' if sel.update_q is None else 'on'}")
        del res, aux, sel

    # 2. SEEDS seeds at the headline, q = 4: one after another (a seed
    # batch refreshes its rows replica by replica and measured slower)
    R = BATCHQ_SEED_ROUNDS
    res, aux, tm, peak, _ = _q_run(
        dev, task.preds, task.labels, R, SEEDS, 4, "headline seeds q=4",
        total, {k1: SEEDS * (1 + R), k3: SEEDS * 4 * R},
        eig_mode="incremental")
    # the 5-seed q = 1 batch in the same window, for the comparison
    _, _, tm1, peak1, _ = _q_run(
        dev, task.preds, task.labels, R, SEEDS, 1, "headline seed batch q=1",
        total, {flavour("eig_score_batched", f32, False): 1,
                flavour("eig_refresh_score_batched", f32, False): R,
                "row_gather_batched": R}, eig_mode="incremental")
    ms1 = _round_ms(tm1, R)
    batch = RunRecord.from_result(res, aux, {}, {})
    ms = _round_ms(tm, R)      # one timing entry a seed, summed
    out["q4 seeds"] = (ms, ms / (4 * SEEDS), peak)
    seed0 = {f: v[:1, :R] for f, v in batch.arrays.items()
             if v.ndim >= 2 and f not in ("root_key", "init_key",
                                          "prior_key")}
    ref0 = {f: one[4].arrays[f][:1, :R] for f in seed0}
    for f in ("chosen_idx", "true_class", "best_model"):
        if not np.array_equal(seed0[f], ref0[f]):
            raise AssertionError(f"{SEEDS} seeds: seed 0's {f} differs "
                                 "from the one-seed q=4 run")
    diff = {f: float(np.max(np.abs(seed0[f].astype(np.float64)
                                   - ref0[f].astype(np.float64))))
            for f in seed0 if not np.array_equal(seed0[f], ref0[f],
                                                 equal_nan=True)}
    bitwise = not diff
    out["q4 seeds seed 0 bitwise"] = bitwise
    log(f"batchq: headline {SEEDS} seeds one after another, q=4 x {R} "
        f"rounds (eig_mode=incremental): kernel 1 x {SEEDS * (1 + R)}, "
        f"kernel 3 x {SEEDS * 4 * R}; ms_per_round (all seeds)={ms:.3f} "
        f"ms_per_seed_label={ms / (4 * SEEDS):.3f} peak_mem_gb={peak:.2f} "
        f"(the q=1 batch: ms_per_round={ms1:.3f} ms_per_seed_label="
        f"{ms1 / SEEDS:.3f} peak_mem_gb={peak1:.2f}); seed 0 vs the "
        f"one-seed q=4 run's first {R} rounds: "
        + ("bitwise" if bitwise else f"decisions equal, max |d| {diff}"))
    del res, aux, batch
    if not bitwise:
        raise AssertionError(f"{SEEDS} seeds: seed 0 not bitwise the "
                             f"one-seed q=4 run: {diff}")

    with tempfile.TemporaryDirectory() as tmp:
        # 3. the committed digits records at q = 4 and q = 8
        ds = Dataset.from_file(os.path.join(HERE, "data", "digits.npz"),
                               device=dev)
        q1_ref = RunRecord.load(os.path.join(HERE, "runs", "batchq_r14",
                                             "q1"))
        for name in ("q4", "q8"):
            ref = RunRecord.load(os.path.join(HERE, "runs", "batchq_r14",
                                              name))
            kn = ref.meta["fingerprint"]["knobs"]
            q, iters, seeds = ref.acq_batch, ref.rounds, ref.seeds
            res, aux, tm, _, _ = _q_run(
                dev, ds.preds, ds.labels, iters, seeds, q,
                f"digits {name}", total,
                {k1: seeds * (1 + iters), k3: seeds * q * iters},
                eig_chunk=kn["eig_chunk"])
            got = record(res, aux, ds, tmp, name,
                         {"eig_chunk": kn["eig_chunk"], "seeds": seeds,
                          "n_parallel": 1, "acq_batch": q}, q)
            digest = got.meta["fingerprint"]["dataset"]["digest"]
            if digest != ref.meta["fingerprint"]["dataset"]["digest"]:
                raise AssertionError(f"digits digest {digest}")
            _triage(got, ref, f"digits {name} vs runs/batchq_r14/{name}",
                    CONTRACT)
            if name == "q4":
                env = compare_records(q1_ref, got)
                if not all(s.classification == "acq-batch-envelope"
                           for s in env.seeds):
                    raise AssertionError("q1 vs q4: not the envelope")
                e = env.meta["batchq_envelope"]
                log(f"batchq: runs/batchq_r14/q1 vs the card's q4 by the "
                    f"acq-batch envelope: worst final cum-regret ratio "
                    f"{e['max_final_ratio_b_over_a']:.3f}, worst aligned "
                    f"gap {e['max_aligned_gap']:.4f}")

        # 4. the five baselines at q = 4, card against CPU
        R = BATCHQ_BASELINE_ROUNDS
        h80 = {d: Dataset.from_file(os.path.join(HERE, "data",
                                                 "digits_h80.npz"), device=d)
               for d in (dev, "cpu")}
        for method in BASELINES:
            recs = {}
            for d in (dev, "cpu"):
                reset_counts()
                res, aux = run_seeds_recorded(
                    _baseline_factory(method, 4 * R, d), h80[d].preds,
                    h80[d].labels, iters=R, seeds=H80_SEEDS, device=d,
                    acq_batch=4)
                if read_counts()[1]:
                    raise AssertionError(f"{method} q=4 launched "
                                         f"{read_counts()[1]}")
                recs[d] = RunRecord.from_result(res, aux, {}, {})
            lines = _triage(recs[dev], recs["cpu"],
                            f"digits_h80 {method} q=4 card vs CPU",
                            CONTRACT)
            log(f"batchq: {method} q=4 digits_h80, {H80_SEEDS} seeds x {R} "
                f"rounds: card vs CPU ({'; '.join(lines)})")

        # 5. the surrogate on digits, the committed record's knobs
        ref = RunRecord.load(os.path.join(HERE, "runs", "surrogate_r17",
                                          "surrogate"))
        exact_ref = RunRecord.load(os.path.join(HERE, "runs",
                                                "surrogate_r17", "exact"))
        seeds, iters = ref.seeds, ref.rounds
        res, aux, tm, _, _ = _q_run(
            dev, ds.preds, ds.labels, iters, seeds, 1, "digits surrogate:32",
            total, lambda r, a: {k1: seeds + warm_full(a),
                                 k3: seeds * iters},
            eig_scorer="surrogate:32")
        got = record(res, aux, ds, tmp, "surrogate",
                     {"eig_chunk": 1024, "seeds": seeds, "n_parallel": 1,
                      "eig_scorer": "surrogate:32"})
        fb = got.arrays["surrogate_fallback"]
        share = fb.sum() / (seeds * (iters - sg.SURROGATE_WARMUP_ROUNDS))
        out["digits surrogate fallback share"] = float(share)
        _triage(got, ref, "digits surrogate:32 vs "
                "runs/surrogate_r17/surrogate", CONTRACT)
        env = compare_records(exact_ref, got)
        if not all(s.classification == "eig-scorer-envelope"
                   for s in env.seeds):
            raise AssertionError("surrogate vs exact: not the envelope")
        e = env.meta["scorer_envelope"]
        log(f"surrogate: digits {tuple(ds.shape)} surrogate:32, {seeds} "
            f"seeds x {iters} rounds (seeds one after another): kernel 1 x "
            f"{seeds + warm_full(aux)} (1 + full rounds a seed), kernel 2 "
            f"x 0; fallback share {share:.4f} ({int(fb.sum())} of "
            f"{seeds * (iters - sg.SURROGATE_WARMUP_ROUNDS)} gated rounds; "
            f"the committed record's: {int(ref.arrays['surrogate_fallback'].sum())}); "
            f"vs runs/surrogate_r17/exact by the eig-scorer envelope: worst "
            f"final ratio {e['max_final_ratio_b_over_a']:.3f}")

        # 6. the pool-seeded surrogate: a donor session, then seeded and
        # cold runs
        hp16 = CODAHyperparams(eig_scorer="surrogate:16", eig_chunk=1024)
        donor_sel = make_coda(ds.preds, hp16, device=dev)
        st = donor_sel.init(None)
        key = trandom.PRNGKey(1)
        reset_counts()
        for _ in range(DONOR_ROUNDS):
            key, k = trandom.split(key)
            r = donor_sel.select(st, k)
            st = donor_sel.update(st, r.idx, ds.labels.take(r.idx), r.prob)
        _tally(total, read_counts()[1])
        fit = st.surrogate
        donor = sg.clip_prior(sg.prior_from_fit(fit.A, fit.b, fit.n,
                                                fit.rounds))
        digest = sg.prior_digest(donor)
        credit = sg.prior_warmup_credit(donor)
        del donor_sel, st
        runs = {}
        for name, prior, knobs in (
                ("cold", None, {"eig_scorer": "surrogate:16"}),
                ("seeded", donor, {"eig_scorer": "surrogate:16",
                                   "surrogate_prior": "pool",
                                   "surrogate_prior_digest": digest})):
            c = 0 if prior is None else credit
            res, aux, tm, _, _ = _q_run(
                dev, ds.preds, ds.labels, iters, seeds, 1,
                f"digits surrogate:16 {name}", total,
                lambda r, a, c=c: {k1: seeds + warm_full(a, c),
                                   k3: seeds * iters},
                prior=prior, eig_scorer="surrogate:16",
                surrogate_prior="off" if prior is None else "pool")
            runs[name] = (record(res, aux, ds, tmp, f"prior_{name}",
                                 dict(knobs, seeds=seeds, n_parallel=1)),
                          seeds + warm_full(aux, c))
        for name in ("cold", "seeded"):
            ref = RunRecord.load(os.path.join(HERE, "runs", "prior_r18",
                                              name))
            got = runs[name][0]
            if name == "cold":
                _triage(got, ref, "digits surrogate:16 cold vs "
                        "runs/prior_r18/cold", CONTRACT)
            rep = compare_records(ref, got, score_tol=CONTRACT)
            cls = {s.classification or "parity" for s in rep.seeds}
            log(f"surrogate prior: runs/prior_r18/{name} vs the card's "
                f"{name} run: {sorted(cls)}"
                + (f", worst final ratio "
                   f"{rep.meta['prior_envelope']['max_final_ratio_b_over_a']:.3f}"
                   if "prior_envelope" in rep.meta else ""))
            if name == "seeded" and cls != {"surrogate-prior-envelope"}:
                raise AssertionError("seeded vs the committed seeded record: "
                                     f"{cls}, not the prior envelope")
        cold_mean = float(runs["cold"][0].arrays["cumulative_regret"][
            :, -1].mean())
        seeded_mean = float(runs["seeded"][0].arrays["cumulative_regret"][
            :, -1].mean())
        env = compare_records(runs["cold"][0], runs["seeded"][0])
        if {s.classification for s in env.seeds} != {
                "surrogate-prior-envelope"}:
            raise AssertionError("cold vs seeded: not the prior envelope")
        ok = within_prior_envelope(cold_mean, seeded_mean)
        out["prior"] = (digest, credit, runs["cold"][1], runs["seeded"][1],
                        cold_mean, seeded_mean, ok)
        log(f"surrogate prior: donor {DONOR_ROUNDS} rounds -> digest "
            f"{digest} (the committed records': "
            f"{RunRecord.load(os.path.join(HERE, 'runs', 'prior_r18', 'seeded')).meta['fingerprint']['knobs']['surrogate_prior_digest']}), "
            f"warmup credit {credit}; kernel 1 cold x {runs['cold'][1]}, "
            f"seeded x {runs['seeded'][1]}; final cumulative regret mean "
            f"cold {cold_mean:.4f} seeded {seeded_mean:.4f}: "
            f"{'within' if ok else 'OUTSIDE'} the reference's envelope "
            f"(1.05 x cold + 0.02)")
        if not ok:
            raise AssertionError("the seeded run is outside the prior "
                                 "envelope")

    # 7. the surrogate's speed against the exact scorer
    pool = make_synthetic_task(5, H=SPARSE_POOL[0], N=SPARSE_POOL[1],
                               C=SPARSE_POOL[2], device=dev)
    for label, t, k in (("pool", pool, 16), ("headline", task, 32)):
        Ht, Nt, Ct = t.preds.shape
        got = {}
        for scorer in ("exact", f"surrogate:{k}"):
            ms = {}
            for iters in (sg.SURROGATE_WARMUP_ROUNDS, SURROGATE_ROUNDS
                          + sg.SURROGATE_WARMUP_ROUNDS):
                want = ((lambda r, a: {k1: 1 + warm_full(a), k3: iters})
                        if scorer != "exact" else
                        {k1: 1, flavour("eig_refresh_score", f32, False):
                         iters, k3: iters})
                res, aux, tm, peak, _ = _q_run(
                    dev, t.preds, t.labels, iters, 1, 1,
                    f"{label} {scorer}", total, want, eig_scorer=scorer)
                ms[iters] = tm[0]["rounds_ms"]
            fb = aux.trace.surrogate_fallback.cpu().numpy()
            gated = (ms[max(ms)] - ms[min(ms)]) / SURROGATE_ROUNDS
            got[scorer] = (gated, int(fb.sum()), peak)
            del res, aux
        ex, su = got["exact"], got[f"surrogate:{k}"]
        out[f"surrogate speed {label}"] = (ex, su)
        log(f"surrogate speed: {label} ({Ht}, {Nt}, {Ct}), 1 seed, rounds "
            f"{sg.SURROGATE_WARMUP_ROUNDS + 1}-"
            f"{sg.SURROGATE_WARMUP_ROUNDS + SURROGATE_ROUNDS} (past the "
            f"warmup): exact ms_per_round={ex[0]:.3f} peak_mem_gb="
            f"{ex[2]:.2f}; surrogate:{k} ms_per_round={su[0]:.3f} "
            f"fallbacks {su[1]} of {SURROGATE_ROUNDS} peak_mem_gb="
            f"{su[2]:.2f}; speed-up {ex[0] / su[0]:.2f}x")
    del pool

    # 8. the tracking store through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, "coda.sqlite")
        argv = ["--synthetic", f"{H},{N},{C}", "--method", "coda",
                "--iters", str(TRACKING_ROUNDS), "--seeds", "1",
                "--tracking-db", db]
        want = {k1: 1, flavour("eig_refresh_score", f32, False):
                TRACKING_ROUNDS, k3: TRACKING_ROUNDS}
        outs = []
        for extra in ([], [], ["--force-rerun"]):
            buf = io.StringIO()
            torch.cuda.synchronize()
            reset_counts()
            with contextlib.redirect_stdout(buf):
                cli.main(argv + extra)
            torch.cuda.synchronize()
            by_flavour = read_counts()[1]
            if by_flavour != want:
                raise AssertionError(f"tracking CLI run: launches "
                                     f"{by_flavour}")
            _tally(total, by_flavour)
            outs.append(buf.getvalue())
            with sqlite3.connect(db) as conn:
                rows = conn.execute(_PAPER_SQL + "  AND m.step = ?",
                                    ("cumulative regret",
                                     TRACKING_ROUNDS)).fetchall()
                n_metrics = conn.execute(
                    "SELECT COUNT(*) FROM metrics").fetchone()[0]
            name = f"synthetic_{H}x{N}x{C}-coda-0"
            if [(r[0], r[1], r[3]) for r in rows] != [
                    (f"synthetic_{H}x{N}x{C}", name, TRACKING_ROUNDS)] \
                    or n_metrics != 2 * TRACKING_ROUNDS \
                    or not math.isfinite(rows[0][2]):
                raise AssertionError(f"tracking DB: {rows}, {n_metrics} "
                                     "metric rows")
        if "Skipping" in outs[0] or "Seed 0 finished. Skipping." not in \
                outs[1] or "Skipping" in outs[2]:
            raise AssertionError("tracking: resume / --force-rerun")
        log(f"tracking: CLI at the headline, 1 seed x {TRACKING_ROUNDS} "
            f"rounds into a temporary --tracking-db: the reference's "
            f"analysis SQL reads run {name}, cumulative regret "
            f"{rows[0][2]:.4f} at step {TRACKING_ROUNDS}; the second run "
            f"printed 'Seed 0 finished. Skipping.'; --force-rerun re-logged "
            f"({n_metrics} metric rows, not doubled)")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"batchq and surrogate phase: {out['wall_s']:.1f} s")
    return out


# -- re-executing records, checkpoint/resume and the in-process suite -------

# (label, CLI flags, seeds, rounds) of the headline records re-executed
# through ``python -m coda_tpu_torch.cli replay`` in a subprocess
REPLAY_PATHS = (
    ("default", [], 1, 20),
    ("5 seeds batched", ["--eig-mode", "incremental"], SEEDS, 10),
    ("fused bf16", ["--eig-refresh", "fused", "--eig-cache-dtype",
                    "bfloat16"], 1, 10),
)
TAMPER_ROUND = 7
CKPT_ROUNDS, CKPT_EVERY, CKPT_CUT = 30, 10, 25   # the cut run saves 10, 20
# runs/real.sqlite's sweep (5 seeds x 100 rounds) cut to 10 rounds, its
# table read at step 10: the whole smoke must end within its time limit
SUITE_SEEDS, SUITE_ROUNDS = 5, 10
SUBSET = ("digits", "iris", "wine")              # --task-batch subset
SUBSET_SEEDS, SUBSET_ROUNDS = 2, 15              # 30 until PR 18
CLI_PAIRS = (("digits", "coda"), ("digits", "model_picker"))
SUITE_METHODS = ("iid", "uncertainty", "coda", "activetesting", "vma",
                 "model_picker")


def _headline_wants(argv, seeds, iters):
    """The launches a recorded headline run of ``argv`` must make."""
    import torch

    from coda_tpu_torch.ops.eig_kernels import flavour

    dt = (torch.bfloat16 if "bfloat16" in argv else torch.float32)
    if seeds > 1:
        return {flavour("eig_score_batched", dt, False): 1,
                flavour("eig_refresh_score_batched", dt, False): iters,
                "row_gather_batched": iters}
    refresh = ("eig_refresh_compute_score" if "fused" in argv
               else "eig_refresh_score")
    return {flavour("eig_score", dt, False): 1,
            flavour(refresh, dt, False): iters, "row_gather": iters}


def _counted(what, want, total, fn):
    """Run ``fn`` with the counters set to 0 just before and read just
    after; the launches must be ``want`` (a dict) or, for a callable,
    pass it; they add to ``total``."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    by_kernel, by_flavour = read_counts()
    ok = want(by_kernel) if callable(want) else by_flavour == want
    if not ok:
        raise AssertionError(f"{what}: launches {by_flavour}")
    _tally(total, by_flavour)
    return out


def _task_files(task, tmp: str) -> list:
    """``--task <name> --data-dir <tmp>`` for ``task`` written into
    ``tmp`` as the ``.npy`` files a user points the CLI at: a record made
    with these flags replays from the files (seconds) instead of
    rebuilding the synthetic task with numpy (about 23 s at the
    headline)."""
    import numpy as np

    np.save(os.path.join(tmp, f"{task.name}.npy"), task.preds.cpu().numpy())
    np.save(os.path.join(tmp, f"{task.name}_labels.npy"),
            task.labels.cpu().numpy())
    return ["--task", task.name, "--data-dir", tmp]


def _hold_replay(report: dict, record, what: str, tol: float) -> list:
    """Each seed of a replay report at parity, or first diverging as a
    ``tie-break-flip`` where the record's runner-up gap is at most
    ``tol``; prints and returns each seed's line."""
    lines, bad = [], []
    for s in report["seeds"]:
        if s["parity"]:
            line = f"seed {s['seed']}: PARITY"
        else:
            t0 = s["first_divergent_round"]
            gap = float(record.arrays["runner_up_gap"][s["seed"], t0])
            line = (f"seed {s['seed']}: first divergence at round {t0}, "
                    f"{s['quantity']} [{s['classification']}], recorded "
                    f"runner-up gap {gap:.3e}")
            if s["classification"] != "tie-break-flip" or abs(gap) > tol:
                bad.append(line)
        lines.append(line)
        log(f"replay {what}: {line}")
    if bad:
        raise AssertionError(f"{what}: not parity or a near-tie flip: {bad}")
    return lines


def _suite_rows(db: str, runs) -> dict:
    """``{run name: [(key, step, value), ...]}`` of the named runs."""
    import sqlite3

    with sqlite3.connect(db) as conn:
        out = {}
        for name in runs:
            out[name] = conn.execute(
                """SELECT m.key, m.step, m.value FROM metrics m
                   JOIN tags t ON t.run_uuid = m.run_uuid
                     AND t.key = 'mlflow.runName'
                   WHERE t.value = ? ORDER BY m.key, m.step""",
                (name,)).fetchall()
    return out


def _cum_regret_table(db: str, step: int) -> dict:
    """``{(task, method): mean over seed children of the cumulative
    regret at ``step``}`` (the paper's table entry, x100)."""
    import sqlite3

    with sqlite3.connect(db) as conn:
        rows = conn.execute(
            """SELECT t.value, m.value FROM metrics m
               JOIN tags t ON t.run_uuid = m.run_uuid
                 AND t.key = 'mlflow.runName'
               WHERE m.key = 'cumulative regret' AND m.step = ?
                 AND m.run_uuid IN (SELECT run_uuid FROM tags
                                    WHERE key = 'mlflow.parentRunId')""",
            (step,)).fetchall()
    acc: dict = {}
    for name, v in rows:
        task, method, _ = name.rsplit("-", 2)
        acc.setdefault((task, method), []).append(v)
    return {k: 100.0 * sum(v) / len(v) for k, v in acc.items()}


def phase_replay_checkpoint_suite(dev, task, total: dict) -> dict:
    """Re-executed records, checkpoint/resume and the in-process suite on
    the card (see the module docstring, item 9). Every in-process run has
    the counters set to 0 just before and read just after, its launches
    checked and added to ``total``. Returns the measured figures."""
    import contextlib
    import io
    import json as _json
    import shutil
    import tempfile

    import torch

    from coda_tpu_torch import cli
    from coda_tpu_torch.engine import (
        build_experiment_fn,
        make_resumable_runner,
        run_seeds_compiled,
    )
    from coda_tpu_torch.engine.replay import replay_main
    from coda_tpu_torch.ops.eig_kernels import flavour
    from coda_tpu_torch.oracle import true_losses
    from coda_tpu_torch.random import PRNGKey
    from coda_tpu_torch.selectors import (
        CODAHyperparams,
        make_activetesting,
        make_coda,
    )
    from coda_tpu_torch.telemetry.recorder import RunRecord

    t_phase = time.perf_counter()
    C, N, H = HEADLINE
    data = os.path.join(HERE, "data")
    out: dict = {"replay": {}, "checkpoint": {}, "suite": {}}
    tmp = tempfile.mkdtemp(prefix="coda_smoke_")
    try:
        # 1. record three headline runs, re-execute each in a subprocess
        files = _task_files(task, tmp)
        for label, flags, seeds, iters in REPLAY_PATHS:
            argv = files + ["--method", "coda",
                    "--iters", str(iters), "--seeds", str(seeds),
                    "--record-dir", os.path.join(tmp, label.replace(" ", "_")),
                    "--no-mlflow", "--device", dev.type] + flags
            args = cli.parse_args(argv)
            factory = cli.build_selector_factory(args, task.name)
            width = cli.hyperparams(args).n_parallel
            timings: list = []
            res, aux = _counted(
                f"recorded {label}", _headline_wants(flags, seeds, iters),
                total, lambda: run_seeds_compiled(
                    factory, task.preds, task.labels, iters=iters,
                    seeds=seeds, device=dev, trace_k=args.record_topk,
                    timings=timings))
            cli._write_record(args, task, res, aux, width, dev)
            rec_ms = sum(t["rounds_ms"] for t in timings) / iters
            report = os.path.join(tmp, "report.json")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "coda_tpu_torch.cli", "replay",
                 args.record_dir, "--out", report], cwd=HERE,
                capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(
                    f"replay {label}: exit {proc.returncode}\n"
                    f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            with open(report) as f:
                rep = _json.load(f)
            if not rep["parity"] or rep["score_tol"] != 0.0:
                raise AssertionError(f"replay {label}: {rep['seeds']}")
            rep_ms = sum(t["rounds_ms"] for t in rep["meta"]["timings"]) \
                / iters
            out["replay"][label] = {"recorded_ms": rec_ms,
                                    "replay_ms": rep_ms,
                                    "subprocess_s": wall, "width": width}
            log(f"replay {label} ({H}, {N}, {C}), {seeds} seed(s) x "
                f"{iters} rounds, n_parallel={width}: PARITY bitwise, exit "
                f"0; ms_per_round recorded={rec_ms:.3f} replayed="
                f"{rep_ms:.3f}; the replay subprocess took {wall:.1f} s")
            del res, aux

        # 2. the default record with one chosen_idx changed: exit 2
        rec = RunRecord.load(os.path.join(tmp, "default"))
        t, iters = TAMPER_ROUND, REPLAY_PATHS[0][3]
        rec.arrays["chosen_idx"][0, t] = rec.arrays["topk_idx"][0, t, 1]
        rec.save(os.path.join(tmp, "tampered"))
        report = os.path.join(tmp, "tampered.json")
        rc = _counted("tampered replay",
                      _headline_wants([], 1, iters), total,
                      lambda: replay_main([os.path.join(tmp, "tampered"),
                                           "--out", report]))
        with open(report) as f:
            seed0 = _json.load(f)["seeds"][0]
        if rc != 2 or seed0["parity"] or \
                seed0["first_divergent_round"] != t:
            raise AssertionError(f"tampered replay: exit {rc}, {seed0}")
        log(f"replay of the default record with chosen_idx changed at round "
            f"{t}: exit 2, DIVERGED at round {t} ({seed0['quantity']} "
            f"[{seed0['classification']}])")

        # 3. the committed digits record on the card
        r17 = os.path.join(HERE, "runs", "surrogate_r17", "exact")
        report = os.path.join(tmp, "r17.json")
        committed = RunRecord.load(r17)
        rc = _counted(
            "runs/surrogate_r17/exact replay",
            lambda k: k["eig_score_batched"] == 1 and
            k["eig_refresh_score_batched"] == committed.rounds ==
            k["row_gather_batched"], total,
            lambda: replay_main([r17, "--data-dir", data, "--out", report]))
        with open(report) as f:
            rep = _json.load(f)
        if rep["score_tol"] != CONTRACT or rc != (0 if rep["parity"] else 2):
            raise AssertionError(f"r17 replay: exit {rc}, tol "
                                 f"{rep['score_tol']}")
        out["replay"]["r17"] = _hold_replay(rep, committed,
                                            "runs/surrogate_r17/exact",
                                            CONTRACT)

        # 4. checkpoint/resume at the headline: cut after round 20 (the
        # cut run reaches round 25; its last save is step 20), resume,
        # every trace bitwise the uninterrupted run
        losses = true_losses(task.preds, task.labels)
        for label, make, dt in (
                ("fp32", lambda: make_coda(task.preds, CODAHyperparams(
                    eig_chunk=1024), device=dev), "float32"),
                ("bf16", lambda: make_coda(task.preds, CODAHyperparams(
                    eig_chunk=1024, eig_cache_dtype="bfloat16"),
                    device=dev), "bfloat16"),
                ("activetesting", lambda: make_activetesting(
                    task.preds, budget=CKPT_ROUNDS, device=dev), None)):
            def wants(rounds, init, dt=dt):
                if dt is None:
                    return {}
                tdt = getattr(torch, dt)
                w = {flavour("eig_refresh_score", tdt, False): rounds,
                     "row_gather": rounds}
                if init:
                    w[flavour("eig_score", tdt, False)] = 1
                return w

            sel = make()
            full = _counted(f"checkpoint {label} uninterrupted",
                            wants(CKPT_ROUNDS, True), total,
                            lambda: build_experiment_fn(
                                sel, task.labels, losses,
                                CKPT_ROUNDS)(PRNGKey(0)))
            ck = os.path.join(tmp, f"ck_{label}")
            timings: list = []
            _counted(f"checkpoint {label} cut", wants(CKPT_CUT, True), total,
                     lambda: make_resumable_runner(
                         sel, task.labels, losses, CKPT_CUT, CKPT_EVERY,
                         timings=timings)(0, ck))
            got = _counted(f"checkpoint {label} resumed",
                           wants(CKPT_ROUNDS - 20, False), total,
                           lambda: make_resumable_runner(
                               sel, task.labels, losses, CKPT_ROUNDS,
                               CKPT_EVERY, timings=timings)(0, ck))
            for f in full._fields:
                if not torch.equal(getattr(full, f), getattr(got, f)):
                    raise AssertionError(f"checkpoint {label}: resumed {f} "
                                         "differs from the uninterrupted run")
            saves = [x for x in timings if x["op"] == "save"]
            restore = [x for x in timings if x["op"] == "restore"]
            if [x["round"] for x in saves] != [10, 20] or \
                    [x["round"] for x in restore] != [20]:
                raise AssertionError(f"checkpoint {label}: {timings}")
            out["checkpoint"][label] = {
                "bytes": saves[-1]["bytes"],
                "save_s": [x["seconds"] for x in saves],
                "restore_s": restore[0]["seconds"]}
            log(f"checkpoint {label} ({H}, {N}, {C}), 1 seed, cut after "
                f"round 20 and resumed to {CKPT_ROUNDS}: every trace "
                f"bitwise the uninterrupted run; a checkpoint "
                f"{saves[-1]['bytes']} bytes, save "
                f"{', '.join(f'{x:.3f}' for x in out['checkpoint'][label]['save_s'])}"
                f" s, restore {restore[0]['seconds']:.3f} s")
            shutil.rmtree(ck)
            del sel, full, got
        torch.cuda.empty_cache()

        # 5. the suite over data/: the sweep of runs/real.sqlite
        def suite(db, *extra):
            buf = io.StringIO()
            argv = ["suite", "--pred-dir", data, "--db", db, "--methods",
                    ",".join(SUITE_METHODS)] + list(extra)
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            text = buf.getvalue()
            if rc != 0:
                raise AssertionError(f"suite {extra}: exit {rc}\n{text}")
            return text, _json.loads(text.strip().splitlines()[-1])

        def kernels_ran(k):
            return k["eig_score"] > 0 and k["eig_refresh_score"] > 0 and \
                k["row_gather"] > 0

        db = os.path.join(tmp, "suite.sqlite")
        full_args = ("--seeds", str(SUITE_SEEDS), "--iters",
                     str(SUITE_ROUNDS))
        text, line = _counted("suite sweep", kernels_ran, total,
                              lambda: suite(db, *full_args))
        n_pairs = line["tasks"] * line["methods"]
        if line["pairs_run"] != n_pairs:
            raise AssertionError(f"suite sweep: {line}")
        out["suite"]["wall_s"] = line["value"]
        out["suite"]["pairs"] = n_pairs
        # a pair whose seed-0 probe was deterministic logged it to every
        # seed (all False); the others ran seeds 1-4 too
        import sqlite3

        with sqlite3.connect(db) as conn:
            flags: dict = {}
            for name, v in conn.execute(
                    """SELECT t.value, p.value FROM params p
                       JOIN tags t ON t.run_uuid = p.run_uuid
                         AND t.key = 'mlflow.runName'
                       WHERE p.key = 'stochastic'"""):
                flags.setdefault(name.rsplit("-", 1)[0], []).append(
                    v == "True")
        n_stoch = sum(any(v) for v in flags.values())
        seed_rounds = SUITE_ROUNDS * (n_pairs + (SUITE_SEEDS - 1) * n_stoch)
        out["suite"].update(stochastic_pairs=n_stoch,
                            seed_rounds=seed_rounds)
        log(f"suite: {line['tasks']} tasks x {line['methods']} methods x "
            f"{SUITE_SEEDS} seeds x {SUITE_ROUNDS} rounds on the card in "
            f"{line['value']} s ({n_pairs} pairs; {n_stoch} stochastic, "
            f"whose seeds 1-{SUITE_SEEDS - 1} ran: {seed_rounds} "
            f"seed-rounds, {1e3 * line['value'] / seed_rounds:.3f} ms "
            "each)")
        for ln in text.splitlines():
            if " seeds x " in ln:
                log(f"  {ln}")
        text, line = suite(db, *full_args)
        if line["pairs_run"] != 0 or text.count("skip ") != n_pairs:
            raise AssertionError(f"suite rerun: {line}")
        log(f"suite rerun: every one of the {n_pairs} pairs skipped "
            f"({line['value']} s)")

        # the task-batch subset through the scheduler, against serial
        sub = ("--tasks", ",".join(SUBSET), "--seeds", str(SUBSET_SEEDS),
               "--iters", str(SUBSET_ROUNDS))
        db_ser = os.path.join(tmp, "subset_serial.sqlite")
        db_sch = os.path.join(tmp, "subset_sched.sqlite")
        _, l_ser = _counted("suite subset serial", kernels_ran, total,
                            lambda: suite(db_ser, *sub))
        _, l_sch = _counted("suite subset scheduled", kernels_ran, total,
                            lambda: suite(db_sch, *sub, "--task-batch",
                                          "--suite-devices", "1"))
        names = [f"{t}-{m}-{s}" for t in SUBSET for m in SUITE_METHODS
                 for s in range(SUBSET_SEEDS)]
        a, b = _suite_rows(db_ser, names), _suite_rows(db_sch, names)
        if a != b or not all(len(v) == 2 * SUBSET_ROUNDS
                             for v in a.values()):
            raise AssertionError("suite subset: --task-batch "
                                 "--suite-devices 1 differs from serial")
        log(f"suite subset {','.join(SUBSET)} x {len(SUITE_METHODS)} "
            f"methods x {SUBSET_SEEDS} seeds x {SUBSET_ROUNDS} rounds: "
            f"--task-batch --suite-devices 1 ({l_sch['value']} s, occupancy "
            f"{l_sch.get('occupancy')}) bitwise the serial run "
            f"({l_ser['value']} s), {len(names)} seed runs")

        # two pairs against the single-task CLI
        def batch_ran(k):   # CODA's 5 seeds as one batch
            return k["eig_score_batched"] == 1 and \
                k["eig_refresh_score_batched"] == SUITE_ROUNDS == \
                k["row_gather_batched"]

        for tname, method in CLI_PAIRS:
            db_cli = os.path.join(tmp, f"cli_{method}.sqlite")
            with contextlib.redirect_stdout(io.StringIO()):
                _counted(f"CLI {tname}/{method}",
                         batch_ran if method == "coda"
                         else (lambda k: not any(k.values())), total,
                         lambda: cli.main([
                             "--task", tname, "--data-dir", data,
                             "--method", method, "--iters",
                             str(SUITE_ROUNDS), "--seeds", str(SUITE_SEEDS),
                             "--tracking-db", db_cli]))
            runs = [f"{tname}-{method}-{s}" for s in range(SUITE_SEEDS)]
            a, b = _suite_rows(db, runs), _suite_rows(db_cli, runs)
            if a != b or not all(len(v) == 2 * SUITE_ROUNDS
                                 for v in a.values()):
                raise AssertionError(f"{tname}/{method}: the suite's rows "
                                     "differ from the single-task CLI's")
            log(f"suite {tname}/{method}: its {SUITE_SEEDS} seed runs' "
                "regret and cumulative regret rows bitwise the single-task "
                "CLI's")

        # the paper's table entry beside runs/real.sqlite (information)
        mine = _cum_regret_table(db, SUITE_ROUNDS)
        ref = _cum_regret_table(os.path.join(HERE, "runs", "real.sqlite"),
                                SUITE_ROUNDS)
        agree = 0
        log(f"mean cumulative regret x100 at step {SUITE_ROUNDS}, port "
            "(card) | runs/real.sqlite (an older reference on JAX's CPU):")
        for key in sorted(mine):
            r = ref.get(key)
            same = r is not None and round(mine[key], 1) == round(r, 1)
            agree += same
            log(f"  {key[0]:>14} {key[1]:>13}: {mine[key]:9.3f} | "
                + (f"{r:9.3f}" if r is not None else "      n/a")
                + ("  =" if same else ""))
        shared = sum(1 for k in mine if k in ref)
        out["suite"]["agree"] = (agree, shared)
        log(f"  {agree} of the {shared} pairs in both agree to the decimal")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"replay, checkpoint and suite phase: {out['wall_s']:.1f} s")
    return out


# -- the crowd oracle and the telemetry core --------------------------------

CROWD_SPEC = ("annotators=8,votes=3,acc=0.6:0.95,abstain=0.1,"
              "adversarial=1,trust=16,seed=0")     # ROBUSTNESS_CPU_r18 noisy
RELIABILITY_SPEC = ("annotators=8,votes=3,acc=0.55:0.95,abstain=0.05,"
                    "adversarial=2,trust=24,seed=1")
RELIABILITY_ROUNDS = 400
CORR_BOUND, MAE_BOUND = 0.8, 0.25                   # its reliability bounds
ENVELOPE_RATIO, ENVELOPE_ABS = 2.0, 1.0             # its oracle envelope
# (label, CODA knobs, seeds, rounds, labels a round)
CROWD_PATHS = (
    ("precomputed fp32", {}, 1, 20, 1),
    ("fused bf16", {"eig_refresh": "fused", "eig_cache_dtype": "bfloat16"},
     1, 20, 1),
    ("5 seeds batched", {"eig_mode": "incremental"}, SEEDS, 10, 1),
    ("q = 4", {}, 1, 5, 4),
)
CROWD_PARITY_SEEDS, CROWD_PARITY_ROUNDS = 3, 30     # digits_h80
TELEMETRY_ROUNDS = 20
SUITE_TELEMETRY = ("digits,iris", "iid,coda", 2, 10)   # tasks, methods, seeds,
#                                                        rounds


def _crowd_wants(knobs: dict, seeds: int, iters: int, q: int) -> dict:
    """The launches a headline crowd run of ``knobs`` must make: the main
    path's for the configuration."""
    import torch

    from coda_tpu_torch.ops.eig_kernels import flavour

    dt = getattr(torch, knobs.get("eig_cache_dtype", "float32"))
    if q > 1:
        return {flavour("eig_score", dt, False): 1 + iters,
                "row_gather": q * iters}
    if seeds > 1:
        return {flavour("eig_score_batched", dt, False): 1,
                flavour("eig_refresh_score_batched", dt, False): iters,
                "row_gather_batched": iters}
    refresh = ("eig_refresh_compute_score"
               if knobs.get("eig_refresh") == "fused"
               else "eig_refresh_score")
    return {flavour("eig_score", dt, False): 1,
            flavour(refresh, dt, False): iters, "row_gather": iters}


def _cuda_events(fn) -> int:
    """CUDA activities (kernels, copies, sets) ``fn`` puts on the card,
    counted by ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


class _headline_cli:
    """``cli.main`` with the headline task already built: ``load_dataset``
    returns ``task`` for ``--synthetic`` at its shape (the numpy build is
    deterministic and takes about 20 s on the host)."""

    def __init__(self, task):
        from coda_tpu_torch import cli

        self.cli, self.task = cli, task
        self.shape = ",".join(str(x) for x in task.shape)

    def __enter__(self):
        self.orig = self.cli.load_dataset
        self.cli.load_dataset = lambda args: (
            self.task if args.synthetic == self.shape else self.orig(args))
        return self.cli

    def __exit__(self, *exc):
        self.cli.load_dataset = self.orig
        return False


_KERNEL_NAMES = {   # kernel -> a pattern of its demangled name in a trace
    "kernel 1": r"score_kernel<float, \d+, false, false, false>",
    "kernel 2": r"score_kernel<float, \d+, true, false, false>",
    "kernel 3": r"gather_kernel<false>",
}


def _trace_kernels(path: str) -> list:
    """The CUDA kernel events (``cat`` kernel) of a profiler trace."""
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("cat") == "kernel"]


def phase_crowd_telemetry(dev, task, total: dict, smi: str, peaks) -> dict:
    """The crowd oracle and the telemetry core on the card (see the module
    docstring, item 10). Every in-process run has the counters set to 0
    just before and read just after, its launches checked and added to
    ``total``. Returns the measured figures."""
    import contextlib
    import dataclasses
    import io
    import json as _json
    import re
    import shutil
    import tempfile

    import numpy as np
    import torch

    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.crowd import (
        aggregate_votes,
        annotator_accuracy,
        init_reliability,
        make_annotators,
        parse_oracle_spec,
        run_seeds_crowd,
        run_seeds_crowd_recorded,
        sample_votes,
    )
    from coda_tpu_torch.data import Dataset
    from coda_tpu_torch.engine import run_seeds_compiled, run_seeds_recorded
    from coda_tpu_torch.engine.replay import compare_records
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.telemetry import Telemetry, costs, lint_prometheus
    from coda_tpu_torch.telemetry.recorder import RunRecord
    from coda_tpu_torch.tracking import TrackingStore
    from coda_tpu_torch.utils.profiling import TRACE_FILE
    from coda_tpu_torch.utils.profiling import trace as profiler_trace

    t_phase = time.perf_counter()
    C, N, H = HEADLINE
    cfg = parse_oracle_spec(CROWD_SPEC)
    out: dict = {"runs": {}, "telemetry": {}}
    log(f"crowd and telemetry on {smi}: --oracle-noise {CROWD_SPEC}")

    def factory_of(hp, sequential=False):
        def factory(p):
            sel = make_coda(p, hp, device=dev)
            return dataclasses.replace(sel, batched=None) if sequential \
                else sel
        return factory

    # 1. the crowd at the headline, each beside the clean run of its knobs
    for label, knobs, seeds, iters, q in CROWD_PATHS:
        hp = CODAHyperparams(eig_chunk=1024, n_parallel=seeds, **knobs)
        want = _crowd_wants(knobs, seeds, iters, q)
        # clean, crowd, clean, crowd: the second of each is timed (the
        # first pays the configuration's first uses)
        for rep in range(2):
            t_clean: list = []
            t_crowd: list = []
            clean = _counted(f"clean {label}", want, total,
                             lambda: run_seeds_compiled(
                                 factory_of(hp), task.preds, task.labels,
                                 iters=iters, seeds=seeds, device=dev,
                                 timings=t_clean, acq_batch=q))
            del clean
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            res, crowd = _counted(f"crowd {label}", want, total,
                                  lambda: run_seeds_crowd(
                                      factory_of(hp), task.preds,
                                      task.labels, cfg, iters=iters,
                                      seeds=seeds, device=dev,
                                      timings=t_crowd, acq_batch=q))
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if len(t_crowd) != len(t_clean):
            raise AssertionError(f"crowd {label}: {len(t_crowd)} timed "
                                 f"experiments, clean {len(t_clean)}")
        idx = res.chosen_idx.cpu()
        w = crowd.label_weight.cpu()
        if not (torch.isfinite(res.regret.cpu()).all()
                and ((w >= 0) & (w <= 1)).all()
                and (res.regret.cpu() >= 0).all()
                and all(len(set(r.reshape(-1).tolist())) == iters * q
                        for r in idx)
                and crowd.annotator_accuracy.shape[-1] == cfg.annotators):
            raise AssertionError(f"crowd {label}: bad trajectory")
        flips = int((crowd.applied_label != crowd.oracle_label).sum())
        ms = sum(t["rounds_ms"] for t in t_crowd) / iters
        ms_clean = sum(t["rounds_ms"] for t in t_clean) / iters
        out["runs"][label] = {"ms": ms, "clean_ms": ms_clean,
                              "peak_gb": peak_gb, "flips": flips}
        log(f"crowd {label} ({H}, {N}, {C}), {seeds} seed(s) x {iters} "
            f"rounds x {q} label(s): launches == the main path's "
            f"{_json.dumps(want)}; ms_per_round crowd={ms:.3f} "
            f"clean={ms_clean:.3f}; peak_mem_gb={peak_gb:.2f}; "
            f"{flips} of {w.numel()} applied labels differ from the truth, "
            f"mean weight {float(w.mean()):.4f}")
        del res, crowd
    torch.cuda.empty_cache()

    # device events a round, crowd against clean (precomputed fp32, rounds
    # 3-7: the difference of a 7-round and a 2-round run)
    hp = CODAHyperparams(eig_chunk=1024)
    ev = {}
    for name, run in (
            ("clean", lambda r: run_seeds_compiled(
                factory_of(hp), task.preds, task.labels, iters=r, seeds=1,
                device=dev)),
            ("crowd", lambda r: run_seeds_crowd(
                factory_of(hp), task.preds, task.labels, cfg, iters=r,
                seeds=1, device=dev))):
        counts = [_counted(f"events {name} {r}",
                           _crowd_wants({}, 1, r, 1), total,
                           lambda r=r: _cuda_events(lambda: run(r)))
                  for r in (2, 7)]
        ev[name] = (counts[1] - counts[0]) / 5
    out["events"] = ev
    log(f"device events a round (torch.profiler, precomputed fp32, 1 seed): "
        f"crowd={ev['crowd']:.1f} clean={ev['clean']:.1f}")

    # 2. digits_h80 under the noisy spec: kernels batched == kernels one
    # seed after another, bitwise with the crowd's arrays; the plain
    # versions batched at parity or first diverging at a near tie (the
    # kernels' scores differ from the plain ones within their tolerance),
    # identical before it
    ds = Dataset.from_file(os.path.join(HERE, "data", "digits_h80.npz"),
                           device=dev)
    S, T = CROWD_PARITY_SEEDS, CROWD_PARITY_ROUNDS

    def digits(sequential=False, **kw):
        hp = CODAHyperparams(eig_chunk=1024, n_parallel=S, **kw)
        return run_seeds_crowd_recorded(
            factory_of(hp, sequential), ds.preds, ds.labels, cfg, iters=T,
            seeds=S, device=dev)

    kb = _counted("digits_h80 crowd batched", {
        "eig_score_batched": 1, "eig_refresh_score_batched": T,
        "row_gather_batched": T}, total, digits)
    ks = _counted("digits_h80 crowd in turn", {
        "eig_score": S, "eig_refresh_score": S * T, "row_gather": S * T},
        total, lambda: digits(sequential=True))
    pb = _counted("digits_h80 crowd plain", {}, total,
                  lambda: digits(eig_backend="plain"))
    leaves = torch.utils._pytree.tree_leaves
    if not all(torch.equal(x, y) for x, y in zip(leaves(kb), leaves(ks))):
        raise AssertionError("digits_h80 crowd: the batch differs from the "
                             "seeds one after another")
    log(f"crowd parity digits_h80 {tuple(ds.shape)}: {S} seeds x {T} "
        f"rounds batched on the kernels == one seed after another, bitwise "
        f"(every result, trace and CrowdAux array)")

    def record(o):
        return RunRecord.from_result(o[0], o[1], {"backend": "torch-cuda"},
                                     {"iters": T}, crowd=o[2])

    kr, pr = record(kb), record(pb)
    _triage(pr, kr, "digits_h80 crowd plain versions vs kernels", CONTRACT)
    for sd in compare_records(pr, kr, score_tol=CONTRACT).seeds:
        t0 = T if sd.parity else sd.first_divergent_round
        for f in ("chosen_idx", "true_class", "best_model", "oracle_label",
                  "label_weight"):
            if not np.array_equal(kr.arrays[f][sd.seed, :t0],
                                  pr.arrays[f][sd.seed, :t0]):
                raise AssertionError(f"digits_h80 crowd plain seed "
                                     f"{sd.seed}: {f} differs before round "
                                     f"{t0}")
    log(f"crowd parity digits_h80: the plain versions batched hold the "
        f"kernels' decisions and crowd arrays bitwise up to each seed's "
        f"first divergence (above)")
    del kb, ks, pb, ds

    # 3. the learned reliability: the reference's recovery check
    rcfg = parse_oracle_spec(RELIABILITY_SPEC)
    conf = make_annotators(rcfg, 4, dev)
    rel = init_reliability(rcfg, 4, dev)
    keys = trandom.split(trandom.PRNGKey(7), RELIABILITY_ROUNDS)
    for t in range(RELIABILITY_ROUNDS):
        k_z, k_votes = trandom.split(keys[t])
        z = trandom.randint(k_z, (), 0, 4)
        rel = aggregate_votes(rel, *sample_votes(k_votes, conf, z, rcfg),
                              rcfg)[2]
    learned = annotator_accuracy(rel).cpu().numpy()
    planted = torch.diagonal(conf, dim1=-2, dim2=-1).mean(-1).cpu().numpy()
    honest = np.arange(rcfg.annotators) < rcfg.annotators - rcfg.adversarial
    corr = float(np.corrcoef(learned, planted)[0, 1])
    mae = float(np.abs(learned - planted).mean())
    separated = bool(learned[~honest].max() < learned[honest].min())
    if not (corr >= CORR_BOUND and mae <= MAE_BOUND and separated):
        raise AssertionError(f"reliability: corr {corr}, mae {mae}, "
                             f"separated {separated}")
    out["reliability"] = {"corr": corr, "mae": mae}
    log(f"reliability ({RELIABILITY_SPEC}, {RELIABILITY_ROUNDS} rounds on "
        f"the card): corr={corr:.4f} >= {CORR_BOUND}, mae={mae:.4f} <= "
        f"{MAE_BOUND}, adversaries separated; learned "
        f"{[round(float(x), 4) for x in learned]}")

    tmp = tempfile.mkdtemp(prefix="coda_smoke_crowd_")
    try:
        # 4. record the fused bf16 crowd run, replay it in a subprocess;
        # against a clean record it is the oracle-noise envelope
        with _headline_cli(task) as cli:
            fused = ["--eig-refresh", "fused", "--eig-cache-dtype",
                     "bfloat16"]
            iters = 20
            base = _task_files(task, tmp) + [
                "--method", "coda", "--iters", str(iters), "--seeds", "1",
                "--no-mlflow", "--device", dev.type] + fused
            recs = {}
            for name, extra in (("noisy", ["--oracle-noise", CROWD_SPEC]),
                                ("clean", [])):
                args = cli.parse_args(base + extra + [
                    "--record-dir", os.path.join(tmp, name)])
                fac = cli.build_selector_factory(args, task.name)
                want = _crowd_wants(dict(eig_refresh="fused",
                                         eig_cache_dtype="bfloat16"),
                                    1, iters, 1)
                if name == "noisy":
                    res, aux, crowd = _counted(
                        "recorded crowd fused bf16", want, total,
                        lambda: run_seeds_crowd_recorded(
                            fac, task.preds, task.labels, cfg, iters=iters,
                            seeds=1, device=dev,
                            trace_k=args.record_topk))
                else:
                    (res, aux), crowd = _counted(
                        "recorded clean fused bf16", want, total,
                        lambda: run_seeds_recorded(
                            fac, task.preds, task.labels, iters=iters,
                            seeds=1, device=dev,
                            trace_k=args.record_topk)), None
                cli._write_record(args, task, res, aux, 1, dev, crowd)
                recs[name] = RunRecord.load(args.record_dir)
                bad = recs[name].violations()
                if bad:
                    raise AssertionError(f"{name} record: {bad}")
        report = os.path.join(tmp, "replay.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "coda_tpu_torch.cli", "replay",
             os.path.join(tmp, "noisy"), "--out", report], cwd=HERE,
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"crowd replay: exit {proc.returncode}\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        with open(report) as f:
            rep = _json.load(f)
        if not rep["parity"] or rep["score_tol"] != 0.0:
            raise AssertionError(f"crowd replay: {rep['seeds']}")
        rep_ms = sum(t["rounds_ms"] for t in rep["meta"]["timings"]) / iters
        env = compare_records(recs["clean"], recs["noisy"])
        per_seed = env.meta["oracle_envelope"]["seeds"]
        ok = all(s.classification == "oracle-noise-envelope"
                 for s in env.seeds) and all(
            p["final_cum_b"] <= ENVELOPE_RATIO * p["final_cum_a"]
            + ENVELOPE_ABS for p in per_seed)
        if not ok:
            raise AssertionError(f"noisy vs clean: {env.to_dict()}")
        out["replay"] = {"replay_ms": rep_ms, "subprocess_s": wall}
        log(f"crowd record fused bf16 ({H}, {N}, {C}), 1 seed x {iters}: "
            f"schema clean, oracle_label/label_weight recorded; cli replay "
            f"in a subprocess: PARITY bitwise, exit 0, {rep_ms:.3f} ms a "
            f"round, {wall:.1f} s; against the clean record: "
            f"oracle-noise-envelope, final cum regret "
            f"{per_seed[0]['final_cum_b']:.4f} vs clean "
            f"{per_seed[0]['final_cum_a']:.4f} (envelope_ok: <= "
            f"{ENVELOPE_RATIO} x clean + {ENVELOPE_ABS})")

        # 5. telemetry at the headline: the CLI with --telemetry-dir and
        # --profile-dir
        tdir, pdir = os.path.join(tmp, "tel"), os.path.join(tmp, "prof")
        iters = TELEMETRY_ROUNDS
        with _headline_cli(task) as cli:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            costs.COSTS.clear()    # the book then holds this run's entry
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = _counted("telemetry CLI run",
                              _crowd_wants({}, 1, iters, 1), total,
                              lambda: cli.main([
                                  "--synthetic", f"{H},{N},{C}", "--method",
                                  "coda", "--iters", str(iters), "--seeds",
                                  "1", "--no-mlflow", "--telemetry-dir",
                                  tdir, "--profile-dir", pdir]))
            peak = torch.cuda.max_memory_allocated()
        if rc != 0:
            raise AssertionError(f"telemetry CLI run: exit {rc}\n"
                                 f"{buf.getvalue()}")
        with open(os.path.join(tdir, "telemetry.json")) as f:
            snap = _json.load(f)
        dev_peak = snap["devices"].get(str(dev.index or 0), {}).get(
            "peak_bytes_in_use")
        if dev_peak != peak:
            raise AssertionError(f"telemetry.json device peak {dev_peak} != "
                                 f"max_memory_allocated {peak}")
        with open(os.path.join(tdir, "metrics.prom")) as f:
            bad = lint_prometheus(f.read())
        if bad:
            raise AssertionError(f"metrics.prom: {bad}")
        with open(os.path.join(tdir, "trace.json")) as f:
            spans = {e["name"] for e in _json.load(f)["traceEvents"]
                     if e["ph"] == "X"}
        if not {"load_dataset", "experiment"} <= spans:
            raise AssertionError(f"trace.json spans {spans}")
        kern = _trace_kernels(os.path.join(pdir, TRACE_FILE))
        found = {k: sum(e["dur"] for e in kern if re.search(p, e["name"]))
                 for k, p in _KERNEL_NAMES.items()}
        if not all(found.values()):
            names = sorted({e["name"][:90] for e in kern
                            if "kernel" in e["name"]})[:20]
            raise AssertionError(f"profiler trace: kernels {found}; names "
                                 f"{names}")
        ours = sum(e["dur"] for e in kern if any(
            re.search(p, e["name"]) for p in _KERNEL_NAMES.values()))
        entries = snap["costs"]
        name = f"engine/run_seeds/coda/{H}x{N}x{C}/s1x{iters}"
        if list(entries) != [name]:
            raise AssertionError(f"telemetry.json cost entries {entries}")
        shares = {}
        for name, e in entries.items():
            rate = e["bytes_accessed"] / (ours * 1e-6)
            shares[name] = rate / peaks[0]
            if rate >= peaks[0] or e.get("source") != "analytic" or \
                    e.get("peak_source") != "table":
                raise AssertionError(f"cost entry {name}: {rate / 1e12:.3f} "
                                     f"TB/s over the kernels' measured "
                                     f"{ours / 1e3:.3f} ms, {e}")
        out["telemetry"].update(
            peak_bytes=peak, kernel_ms={k: v / 1e3 for k, v in found.items()},
            share=shares)
        log(f"telemetry CLI run ({H}, {N}, {C}), 1 seed x {iters}: "
            f"telemetry.json device peak {dev_peak} == max_memory_allocated; "
            f"metrics.prom lints clean; trace.json spans load_dataset, "
            f"experiment; the profiler trace names kernels 1-3, device ms "
            f"{ {k: round(v / 1e3, 3) for k, v in found.items()} }; cost "
            f"entries' bytes over those kernels' time, share of "
            f"{peaks[0] / 1e12:.2f} TB/s: "
            f"{ {k: round(v, 4) for k, v in shares.items()} }")

        # telemetry on and off, the same entry (run_seeds_compiled, 1 seed
        # x 20 rounds, precomputed fp32), in turns: plain; under the CLI's
        # span and cost harvest; then once under the profiler as well
        hp = CODAHyperparams(eig_chunk=1024)
        tele = Telemetry()
        ms: dict = {"off": [], "on": [], "on+profile": []}
        for mode in ("off", "on", "off", "on", "on+profile"):
            timings: list = []
            prof = (profiler_trace(os.path.join(tmp, "p2"), dev)
                    if mode == "on+profile" else contextlib.nullcontext())
            span = (tele.span("experiment", lane="host:main", annotate=True)
                    if mode != "off" else contextlib.nullcontext())
            with prof, span:
                _counted(f"telemetry {mode}", _crowd_wants({}, 1, iters, 1),
                         total, lambda: run_seeds_compiled(
                             factory_of(hp), task.preds, task.labels,
                             iters=iters, seeds=1, device=dev,
                             timings=timings,
                             cost_label=None if mode == "off" else "coda"))
            ms[mode].append(timings[0]["rounds_ms"] / iters)
        out["telemetry"]["ms"] = ms
        log(f"ms_per_round (off, on in turns; then on with the profiler): "
            f"off={[round(x, 3) for x in ms['off']]} "
            f"on={[round(x, 3) for x in ms['on']]} "
            f"on+profile={round(ms['on+profile'][0], 3)}")

        # 6. the suite with --telemetry-dir on a subset
        tasks, methods, seeds, rounds = SUITE_TELEMETRY
        sdir, db = os.path.join(tmp, "suite_tel"), os.path.join(tmp, "s.db")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = _counted(
                "suite telemetry",
                lambda k: k["eig_score"] > 0 and k["row_gather"] > 0, total,
                lambda: cli.main([
                    "suite", "--pred-dir", os.path.join(HERE, "data"),
                    "--tasks", tasks, "--methods", methods, "--seeds",
                    str(seeds), "--iters", str(rounds), "--db", db,
                    "--telemetry-dir", sdir]))
        if rc != 0:
            raise AssertionError(f"suite telemetry: exit {rc}\n"
                                 f"{buf.getvalue()}")
        with open(os.path.join(sdir, "trace.json")) as f:
            tr = _json.load(f)["traceEvents"]
        lanes = {e["args"]["name"] for e in tr if e["name"] == "thread_name"}
        n_spans = sum(1 for e in tr if e["ph"] == "X")
        store = TrackingStore(db)
        flushed = store.find_run("suite", "suite-telemetry")
        store.close()
        if lanes != {"device:0"} or n_spans != 4 or flushed is None:
            raise AssertionError(f"suite telemetry: lanes {lanes}, "
                                 f"{n_spans} spans, flushed {flushed}")
        log(f"suite --telemetry-dir ({tasks} x {methods} x {seeds} seeds x "
            f"{rounds} rounds): {n_spans} dispatch spans on device:0, the "
            f"scalars flushed to the store as suite-telemetry")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"crowd and telemetry phase: {out['wall_s']:.1f} s")
    return out



SERVE_CAPACITY = 16                  # the headline slab's slots
SERVE_ROUNDS = 10                    # full-occupancy label rounds
SERVE_OCCUPANCY = (1, 4)             # partial rounds timed (16 = the full)
SERVE_TIME_REPS = 3                  # timed rounds a partial occupancy
SERVE_PARTIAL = (0, 2, 3, 7, 11)     # 5 of 16 requested: four runs
SERVE_PLAIN_ROUNDS = 5               # the plain versions' slab run
SERVE_FUSED = (4, 3)                 # fused bf16 bucket: slots, rounds
SERVE_HTTP_LABELS = 10               # labels a client session
SERVE_FAULT = (4, 5)                 # fault app: slots, step_raise after
SERVE_CLI_ROUNDS = 3
SERVE_CLI_EXTRA: list = []           # extra `cli serve` flags (rehearsals)


def _f32_bits(x) -> bytes:
    import numpy as np

    return np.float32(x).tobytes()


def _same_row(a: dict, b: dict, keys=("next_idx", "best"),
              fkeys=("next_prob", "pbest_max", "pbest_entropy")) -> bool:
    """Two result rows equal: integers exactly, floats bit for bit."""
    return (all(a[k] == b[k] for k in keys)
            and all(_f32_bits(a[k]) == _f32_bits(b[k]) for k in fkeys))


def _serve_plan(cap: int) -> list:
    """The slab runs' dispatches: (tag, requested slots). The start of
    every slot, SERVE_ROUNDS full rounds, the partial occupancies, the
    5-of-16 set twice and one profiled round at 1 and at ``cap`` slots."""
    full = list(range(cap))
    plan = [("start", full)] + [("full", full)] * SERVE_ROUNDS
    for n in SERVE_OCCUPANCY:
        plan += [(f"occ{n}", list(range(min(n, cap))))] * SERVE_TIME_REPS
    part = [s for s in SERVE_PARTIAL if s < cap]
    plan += [("partial", part)] * 2
    plan += [("prof1", [0]), ("prof_full", full)]
    return plan


def _state_fp(state, key) -> tuple:
    """A fingerprint of a state and its key: every leaf's 32-bit word sum
    and odd-word sum on the device (bytes for small or odd leaves)."""
    import torch

    from coda_tpu_torch.serve.state import tree_leaves

    out = []
    for leaf in tree_leaves(state):
        if not isinstance(leaf, torch.Tensor):
            out.append(repr(leaf))
            continue
        flat = leaf.reshape(-1)
        if flat.numel() * flat.element_size() % 4 == 0 and flat.numel():
            w = flat.view(torch.uint8).view(torch.int32)
            out.append((int(w.sum(dtype=torch.int64)),
                        int(w[1::2].sum(dtype=torch.int64))))
        else:
            out.append(flat.cpu().view(torch.uint8).numpy().tobytes())
    out.append(tuple(key.tolist()))
    return tuple(out)


def _slot_fp(bucket, slot: int) -> tuple:
    """:func:`_state_fp` of one slot of ``bucket``."""
    with bucket.lock:
        return _state_fp(bucket.slot_state(slot), bucket.keys[slot])


_DISPATCH_PARTS = (   # part -> a pattern of its kernels' demangled names
    ("kernel 2", r"score_kernel<[^>]*, true, (?:true|false), false>"),
    ("kernel 5", r"score_kernel<[^>]*, true, (?:true|false), true>"),
    ("kernel 3", r"gather_kernel"),
    ("products", r"gemm|gemv|cutlass|xmma|sm90_|Kernel2|splitK"),
    ("copies", r"[Mm]emcpy|[Mm]emset|copy_kernel|CatArrayBatched"),
)


def _dispatch_profile(fn) -> dict:
    """``fn`` under ``torch.profiler``: its device events, their device ms
    by part (:data:`_DISPATCH_PARTS`, the rest ``other``) and in all."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    parts = dict.fromkeys([p for p, _ in _DISPATCH_PARTS] + ["other"], 0.0)
    n = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n += 1
        part = next((p for p, pat in _DISPATCH_PARTS
                     if re.search(pat, e.name)), "other")
        parts[part] += e.time_range.elapsed_us() / 1e3
    return {"events": n, "device_ms": sum(parts.values()),
            "parts_ms": {k: round(v, 3) for k, v in parts.items()}}


def _serve_drive(bucket, seeds, labels, plan, store, spec, task_name,
                 idle_check: bool = False) -> dict:
    """Admit one session a seed on ``bucket`` and run ``plan`` on it:
    each requested slot labels its current item with the oracle's label.
    Returns the rows per seed, the dispatch ms per tag, the admission ms,
    the idle-slot checks and the device events of the profiled rounds."""
    import torch

    def sync():
        if bucket.device.type == "cuda":
            torch.cuda.synchronize()

    admit_ms, sessions = [], []
    for s in seeds:
        sync()
        t0 = time.perf_counter()
        sess = store.open(task_name, spec, seed=s)
        with bucket.lock:
            bucket._apply_staged()
        sync()
        admit_ms.append((time.perf_counter() - t0) * 1e3)
        sessions.append(sess)
    by_slot = {sess.slot: i for i, sess in enumerate(sessions)}
    rows = [[] for _ in seeds]
    times: dict = {}
    events: dict = {}
    idle_checked = 0
    for tag, slots in plan:
        reqs = {}
        for slot in slots:
            i = by_slot[slot]
            if tag == "start":
                reqs[slot] = {"do_update": False}
            else:
                last = rows[i][-1]
                reqs[slot] = {"do_update": True, "idx": last["next_idx"],
                              "label": int(labels[last["next_idx"]]),
                              "prob": last["next_prob"]}
        idle = ([s for s in by_slot if s not in reqs]
                if idle_check and tag == "partial" else [])
        before = {s: _slot_fp(bucket, s) for s in idle}

        def run():
            with bucket.lock:
                return bucket.dispatch(reqs)

        sync()
        t0 = time.perf_counter()
        if tag.startswith("prof") and bucket.device.type == "cuda":
            box = {}
            events[tag] = _dispatch_profile(lambda: box.update(out=run()))
            res = box["out"]
        else:
            res = run()
        times.setdefault(tag, []).append((time.perf_counter() - t0) * 1e3)
        for s in idle:
            if _slot_fp(bucket, s) != before[s]:
                raise AssertionError(f"idle slot {s} changed in a "
                                     f"{tag} dispatch")
        idle_checked += len(idle)
        for slot, r in res.items():
            rows[by_slot[slot]].append(r)
    return {"rows": rows, "times": times, "admit_ms": admit_ms,
            "events": events, "idle_checked": idle_checked,
            "sessions": sessions}


def _twin_rows(selector, seed: int, n: int, labels, rows) -> tuple:
    """The sequential twin of a slab session: ``InteractiveSelector(
    selector, seed)`` driven through the slab's requests (its first ``n``
    rows); returns its rows and the fingerprint of its final state."""
    from coda_tpu_torch.ops.masked import entropy2
    from coda_tpu_torch.selectors.protocol import InteractiveSelector

    twin = InteractiveSelector(selector, seed=seed)
    get_pbest = selector.extras.get("get_pbest")
    out = []
    for j in range(n):
        if j:
            prev = rows[j - 1]
            twin.add_label(prev["next_idx"], int(labels[prev["next_idx"]]),
                           prev["next_prob"])
        idx, prob = twin.get_next_item_to_label()
        best = twin.get_best_model_prediction()
        pb = get_pbest(twin.state).float()
        out.append({"next_idx": idx, "next_prob": prob, "best": best,
                    "pbest_max": float(pb.max()),
                    "pbest_entropy": float(entropy2(pb))})
    fp = _state_fp(twin.state, twin._key)
    del twin
    return out, fp


def _hold_twins(bucket, seeds, labels, drive, what: str) -> None:
    """Every slab session bitwise its sequential twin, row for row, and
    its slot's final state and key the twin's (by fingerprint)."""
    for i, s in enumerate(seeds):
        rows = drive["rows"][i]
        twin, fp = _twin_rows(bucket.selector, s, len(rows), labels, rows)
        if _slot_fp(bucket, drive["sessions"][i].slot) != fp:
            raise AssertionError(f"{what}: seed {s}: the slot's state is "
                                 "not the InteractiveSelector's")
        for j, (a, b) in enumerate(zip(rows, twin)):
            if not _same_row(a, b):
                raise AssertionError(
                    f"{what}: seed {s} row {j}: slab {a} != "
                    f"InteractiveSelector {b}")
    log(f"serve {what}: {len(seeds)} sessions x "
        f"{len(drive['rows'][0])} rows bitwise the InteractiveSelector, "
        "the slots' final states and keys its")


def _hold_same(a: dict, b: dict, what: str) -> None:
    for i, (ra, rb) in enumerate(zip(a["rows"], b["rows"])):
        if len(ra) != len(rb):
            raise AssertionError(f"{what}: session {i} has {len(ra)} and "
                                 f"{len(rb)} rows")
        for j, (x, y) in enumerate(zip(ra, rb)):
            if not _same_row(x, y):
                raise AssertionError(f"{what}: session {i} row {j}: {x} "
                                     f"!= {y}")


def _hold_plain(kern: dict, plain: dict, selector, seeds, labels,
                what: str) -> list:
    """The plain versions' slab run against the kernels' one: each
    session identical (scores within the 2.34e-4 contract), or first
    diverging as a tie-break flip: the kernel's scores of the two picks
    within 2.34e-4 (read from the sequential twin at that row)."""
    from coda_tpu_torch.selectors.protocol import InteractiveSelector

    lines = []
    for i, s in enumerate(seeds):
        ka, pa = kern["rows"][i], plain["rows"][i]
        n = min(len(ka), len(pa))
        div = next((j for j in range(n)
                    if ka[j]["next_idx"] != pa[j]["next_idx"]
                    or ka[j]["best"] != pa[j]["best"]), None)
        worst = max(abs(ka[j]["next_prob"] - pa[j]["next_prob"])
                    for j in range(n if div is None else div) or [0])
        if worst > CONTRACT:
            raise AssertionError(f"{what}: seed {s} scores differ by "
                                 f"{worst:.3e} > {CONTRACT}")
        if div is None:
            lines.append(f"seed {s}: identical ({n} rows, scores within "
                         f"{worst:.3e})")
            continue
        twin = InteractiveSelector(selector, seed=s)
        for j in range(1, div + 1):
            prev = ka[j - 1]
            twin.add_label(prev["next_idx"], int(labels[prev["next_idx"]]),
                           prev["next_prob"])
        sc = twin.state.eig_scores_cached
        gap = float(sc[ka[div]["next_idx"]] - sc[pa[div]["next_idx"]])
        del twin
        line = (f"seed {s}: first divergence at row {div}, gap {gap:.3e} "
                "[tie-break-flip]")
        if ka[div]["best"] != pa[div]["best"] and \
                ka[div]["next_idx"] == pa[div]["next_idx"]:
            raise AssertionError(f"{what}: seed {s} row {div}: best "
                                 "differs with the same pick")
        if abs(gap) > CONTRACT:
            raise AssertionError(f"{what}: {line} beyond {CONTRACT}")
        lines.append(line)
    for line in lines:
        log(f"serve {what}: {line}")
    return lines


def _http(port: int, method: str, path: str, body=None):
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_bucket(dev, preds, spec, cap, impl):
    from coda_tpu_torch.serve.state import SessionStore

    store = SessionStore(capacity=cap, step_impl=impl, device=dev)
    store.register_task("t", preds)
    bucket = store._bucket_for("t", spec)
    info = bucket.warm()
    return store, bucket, info


def _ms(xs) -> str:
    return f"{statistics.median(xs):.3f}"


def phase_serve(dev, task, total: dict, smi: str) -> dict:
    """The serve slab, the batcher and the HTTP server on the card (see
    the module docstring, item 11). Every in-process slab run has the
    counters set to 0 just before and read just after, its launches
    checked and added to ``total``. Returns the measured figures."""
    import gc
    import signal
    import threading

    import numpy as np
    import torch

    from coda_tpu_torch.data import Dataset
    from coda_tpu_torch.serve import ServeApp, SelectorSpec, make_server
    from coda_tpu_torch.serve.state import DEFAULT_IMPL
    from coda_tpu_torch.telemetry import lint_prometheus

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    C, N, H = HEADLINE
    cap = SERVE_CAPACITY
    seeds = list(range(cap))
    labels = task.labels.cpu().numpy()
    preds = task.preds
    spec = SelectorSpec.create("coda", n_parallel=cap,
                               eig_mode="incremental")
    plan = _serve_plan(cap)
    out: dict = {"card": smi, "default_impl": DEFAULT_IMPL}
    log(f"serve on {smi}: headline ({H}, {N}, {C}), {cap} slots, "
        f"{SERVE_ROUNDS} full rounds; default lowering {DEFAULT_IMPL}")

    def free():
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def peak_reset():
        if cuda:
            torch.cuda.reset_peak_memory_stats()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0

    def want_map(k):
        return k["eig_refresh_score"] > 0 and k["row_gather"] > 0 \
            and k["eig_refresh_score_batched"] == 0

    def want_batched(k):   # lone requested slots take kernel 2
        return k["eig_refresh_score_batched"] > 0 \
            and k["row_gather_batched"] > 0

    def want_none(k):
        return not any(k.values())

    runs = {}
    # 1. the slab against its sequential twin, and the lowerings at the
    #    headline and at digits_h80
    h80 = Dataset.from_file(os.path.join(HERE, "data", "digits_h80.npz"),
                            name="digits_h80", device=dev)
    h80_labels = h80.labels.cpu().numpy()
    for where, p, labs in (("digits_h80", h80.preds, h80_labels),
                           ("headline", preds, labels)):
        shape_spec = SelectorSpec.create("coda", n_parallel=cap,
                                         eig_mode="incremental")
        for impl, want in (("map", want_map), ("batched", want_batched)):
            free()
            peak_reset()
            t0 = time.perf_counter()
            store, bucket, info = _serve_bucket(dev, p, shape_spec, cap,
                                                impl)
            setup_s = time.perf_counter() - t0
            drive = _counted(
                f"serve {where} {impl}", want, total,
                lambda: _serve_drive(bucket, seeds, labs, plan, store,
                                     shape_spec, "t", idle_check=True))
            drive["peak_gb"] = peak_gb()
            drive["setup_s"] = setup_s
            drive["warm"] = info
            if impl == "map":
                _hold_twins(bucket, seeds, labs, drive, f"{where} map")
            else:
                _hold_same(runs[(where, "map")], drive,
                           f"{where} batched == map")
                log(f"serve {where}: batched bitwise map over "
                    f"{len(plan)} dispatches (full, 1, 4 and "
                    f"{len(SERVE_PARTIAL)} of {cap} slots); "
                    f"{drive['idle_checked']} idle-slot checks unchanged")
            runs[(where, impl)] = {k: v for k, v in drive.items()
                                   if k != "sessions"}
            t = drive["times"]
            log(f"serve {where} {impl}: bucket + warm {setup_s:.2f} s "
                f"(warm {info['seconds']:.2f} s), admission ms median "
                f"{_ms(drive['admit_ms'])}, dispatch ms (host clock, "
                f"synchronized) {cap} slots {_ms(t['full'])}, "
                + ", ".join(f"{n} slot(s) {_ms(t[f'occ{n}'])}"
                            for n in SERVE_OCCUPANCY)
                + f", 5 of {cap} {_ms(t['partial'])}; peak "
                f"{drive['peak_gb']:.2f} GB")
            for tag, prof in drive["events"].items():
                log(f"serve {where} {impl} {tag} (profiled dispatch): "
                    f"{prof['events']} device events, "
                    f"{prof['device_ms']:.3f} device ms, by part "
                    f"{prof['parts_ms']}")
            del store, bucket, drive
    out["runs"] = {f"{w}/{i}": {"times": r["times"],
                                "admit_ms": r["admit_ms"],
                                "events": r["events"],
                                "peak_gb": r["peak_gb"]}
                   for (w, i), r in runs.items()}
    # 2. the plain versions on the slab; the fused bf16 bucket (kernel 6)
    free()
    plain_spec = SelectorSpec.create("coda", n_parallel=cap,
                                     eig_mode="incremental",
                                     eig_backend="jnp")
    pplan = plan[:1 + SERVE_PLAIN_ROUNDS]
    store, bucket, _ = _serve_bucket(dev, preds, plain_spec, cap, "map")
    plain = _counted("serve plain", want_none, total,
                     lambda: _serve_drive(bucket, seeds, labels, pplan,
                                          store, plain_spec, "t"))
    del store, bucket
    free()
    out["plain"] = _hold_plain(runs[("headline", "map")], plain,
                               spec.factory(dev)(preds), seeds, labels,
                               "kernels == plain")
    del plain
    free()
    fslots, frounds = SERVE_FUSED
    # n_parallel 1: the fused refresh runs one replica at a time (the
    # reference refuses it batched), as the map lowering does
    fspec = SelectorSpec.create("coda", n_parallel=1,
                                eig_mode="incremental", eig_refresh="fused",
                                eig_cache_dtype="bfloat16")
    fplan = [("start", list(range(fslots)))] + \
        [("full", list(range(fslots)))] * frounds
    store, bucket, _ = _serve_bucket(dev, preds, fspec, fslots, None)
    fused = _counted(
        "serve fused bf16", lambda k: k["eig_refresh_compute_score"] > 0
        and k["row_gather"] > 0, total,
        lambda: _serve_drive(bucket, list(range(fslots)), labels, fplan,
                             store, fspec, "t"))
    _hold_twins(bucket, list(range(fslots)), labels, fused,
                "fused bf16 map")
    out["fused_ms"] = fused["times"]["full"]
    del store, bucket, fused
    free()

    # 3. the HTTP front door in-process
    app = ServeApp(spec=spec, capacity=cap, tiering=False, quality=False,
                   device=dev)
    app.add_task("headline", preds)
    srv = make_server(app, 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    srv._started.wait(30)
    port = srv.server_address[1]
    ref = runs[("headline", "map")]["rows"]
    lat, errors = [], []
    try:
        code, _ = _http(port, "GET", "/healthz")
        if code != 503:
            raise AssertionError(f"/healthz before warm answered {code}")
        t0 = time.perf_counter()
        app.start(warm=True)
        out["http_warm_s"] = time.perf_counter() - t0
        code, _ = _http(port, "GET", "/healthz")
        if code != 200:
            raise AssertionError(f"/healthz after warm answered {code}")
        opened = threading.Barrier(cap + 1)
        go = threading.Barrier(cap + 1)

        def client(s):
            try:
                code, body = _http(port, "POST", "/session", {"seed": s})
                first = json.loads(body)
                if code != 200:
                    raise AssertionError(f"open {s}: {code} {body}")
                sid = first["session"]
                opened.wait(120)
                go.wait(120)
                got = [first]
                for k in range(SERVE_HTTP_LABELS):
                    t1 = time.perf_counter()
                    code, body = _http(
                        port, "POST", f"/session/{sid}/label",
                        {"label": int(labels[got[-1]["idx"]]),
                         "request_id": f"{s}-{k}"})
                    lat.append(time.perf_counter() - t1)
                    if code != 200:
                        raise AssertionError(f"label {s}/{k}: {code} {body}")
                    got.append(json.loads(body))
                code, body = _http(
                    port, "POST", f"/session/{sid}/label",
                    {"label": 0, "request_id": f"{s}-{SERVE_HTTP_LABELS - 1}"})
                if code != 200 or json.loads(body) != got[-1]:
                    raise AssertionError(f"dedupe {s}: {code} {body}")
                code, body = _http(port, "GET", f"/session/{sid}/best")
                best = json.loads(body)
                code, body = _http(port, "GET", f"/session/{sid}/trace")
                trace = json.loads(body)["rounds"]
                _http(port, "DELETE", f"/session/{sid}")
                want = ref[s][:len(got)]
                for j, (g, r) in enumerate(zip(got, want)):
                    if (g["idx"] != r["next_idx"] or g["best"] != r["best"]
                            or _f32_bits(g["prob"]) != _f32_bits(
                                r["next_prob"])):
                        raise AssertionError(f"http seed {s} answer {j}: "
                                             f"{g} != slab {r}")
                for j, (tr, r) in enumerate(zip(trace, want)):
                    if not _same_row(tr, r):
                        raise AssertionError(f"http seed {s} trace row {j}"
                                             f": {tr} != slab {r}")
                if best["n_labeled"] != SERVE_HTTP_LABELS or \
                        len(trace) != SERVE_HTTP_LABELS + 1 or \
                        len(best["pbest"]) != H:
                    raise AssertionError(f"http seed {s}: best {best}, "
                                         f"{len(trace)} trace rows")
            except BaseException as e:   # reported by the main thread
                errors.append(f"seed {s}: {e!r}")
                for b in (opened, go):
                    b.abort()

        threads = [threading.Thread(target=client, args=(s,))
                   for s in seeds]
        t0 = time.perf_counter()
        reset_counts()
        for t in threads:
            t.start()
        try:
            opened.wait(300)
            code, body = _http(port, "POST", "/session", {"seed": 99})
            if code != 503:
                raise AssertionError(f"a {cap + 1}th open answered {code}")
            go.wait(300)
        except threading.BrokenBarrierError:
            pass
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        if cuda:
            torch.cuda.synchronize()
        by_kernel, by_flavour = read_counts()
        if errors:
            raise AssertionError(f"http clients: {errors}")
        if not (by_kernel["eig_refresh_score"]
                or by_kernel["eig_refresh_score_batched"]):
            raise AssertionError(f"http: launches {by_flavour}")
        _tally(total, by_flavour)
        code, text = _http(port, "GET", "/metrics")
        problems = lint_prometheus(text)
        if code != 200 or problems:
            raise AssertionError(f"/metrics {code}: {problems[:5]}")
        stats = json.loads(_http(port, "GET", "/stats")[1])
        n_req = cap * (SERVE_HTTP_LABELS + 5)
        lat_ms = np.asarray(lat) * 1e3
        out["http"] = {
            "label_p50_ms": float(np.percentile(lat_ms, 50)),
            "label_p99_ms": float(np.percentile(lat_ms, 99)),
            "requests_per_s": n_req / wall, "wall_s": wall,
            "dispatches": stats["dispatches"],
            "mean_occupancy": stats["mean_occupancy"]}
        log(f"serve http ({smi}): {cap} clients x {SERVE_HTTP_LABELS} "
            f"labels, every answer the slab's; label latency p50 "
            f"{out['http']['label_p50_ms']:.3f} ms p99 "
            f"{out['http']['label_p99_ms']:.3f} ms; {n_req} requests in "
            f"{wall:.2f} s = {out['http']['requests_per_s']:.1f}/s; "
            f"{stats['dispatches']} dispatches, mean occupancy "
            f"{stats['mean_occupancy']}; duplicate request_id deduped, "
            f"open {cap + 1} -> 503, /healthz 503 -> 200, /metrics lint "
            f"clean; launches {by_flavour}")
    finally:
        srv.shutdown()
        app.drain()
        srv.server_close()
    del app
    free()

    # 4. a fault: step_raise quarantines the bucket, the healer rebuilds it
    fslots, after = SERVE_FAULT
    app = ServeApp(spec=spec, capacity=fslots, tiering=False,
                   quality=False, fault_spec=f"step_raise:after={after}",
                   device=dev)
    app.add_task("headline", preds)
    app.start(warm=True)
    try:
        got = {s: [app.open_session(seed=s)] for s in range(fslots)}
        sids = {s: got[s][0]["session"] for s in got}
        faults = 0
        for k in range(SERVE_HTTP_LABELS):
            for s in range(fslots):
                for _ in range(200):
                    try:
                        r = app.label(sids[s], int(labels[got[s][-1]["idx"]]),
                                      request_id=f"{s}-{k}")
                        break
                    except Exception as e:
                        faults += type(e).__name__ == "FaultInjected"
                        time.sleep(0.05)
                else:
                    raise AssertionError("the bucket never healed")
                got[s].append(r)
        bucket = app.store.buckets()[0]
        if faults != 1 or bucket.heals != 1:
            raise AssertionError(f"fault: {faults} injected, "
                                 f"{bucket.heals} heals")
        for s in range(fslots):
            for j, (g, r) in enumerate(zip(got[s], ref[s])):
                if (g["idx"] != r["next_idx"] or g["best"] != r["best"]
                        or _f32_bits(g["prob"]) != _f32_bits(r["next_prob"])):
                    raise AssertionError(f"healed seed {s} answer {j}: {g}"
                                         f" != unfaulted {r}")
        out["heal"] = dict(app.healer.last_report)
        log(f"serve fault: step_raise after {after} quarantined the "
            f"bucket, healed from the streams in "
            f"{out['heal']['seconds']:.3f} s ({out['heal']['rounds']} "
            f"rounds of {out['heal']['sessions']} sessions, digests "
            f"verified); {fslots} sessions x {SERVE_HTTP_LABELS} labels "
            "bitwise the unfaulted run")
    finally:
        app.drain()
    del app
    free()

    # 5. `cli serve` in a subprocess on the card, drained by SIGTERM
    port = _free_port()
    cmd = [sys.executable, "-m", "coda_tpu_torch.cli", "serve", "--task",
           "digits_h80", "--data-dir", os.path.join(HERE, "data"),
           "--capacity", "8", "--no-tiering", "--no-quality", "--port",
           str(port), *SERVE_CLI_EXTRA]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        for _ in range(1200):
            try:
                if _http(port, "GET", "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            if proc.poll() is not None:
                raise AssertionError(f"cli serve exited {proc.returncode}:"
                                     f" {proc.stdout.read()}")
            time.sleep(0.1)
        else:
            raise AssertionError("cli serve never became ready")
        ready_s = time.perf_counter() - t0
        for s in (0, 1):
            code, body = _http(port, "POST", "/session", {"seed": s})
            cur = json.loads(body)
            for k in range(SERVE_CLI_ROUNDS):
                code, body = _http(
                    port, "POST", f"/session/{cur['session']}/label",
                    {"label": int(h80_labels[cur["idx"]])})
                if code != 200:
                    raise AssertionError(f"cli label: {code} {body}")
                cur = json.loads(body)
            code, body = _http(port, "GET", f"/session/{cur['session']}"
                               "/best")
            if code != 200 or json.loads(body)["n_labeled"] != \
                    SERVE_CLI_ROUNDS:
                raise AssertionError(f"cli best: {code} {body}")
        proc.send_signal(signal.SIGTERM)
        text, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0 or "drained" not in text:
        raise AssertionError(f"cli serve exit {proc.returncode}: {text}")
    log(f"serve cli: `cli serve --task digits_h80 --capacity 8` ready in "
        f"{ready_s:.1f} s, 2 sessions x {SERVE_CLI_ROUNDS} labels, SIGTERM "
        "drained, exit 0")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serve phase: {out['phase_s']:.1f} s")
    return out



DURABLE_CAPACITY = 16                # the headline slab's slots
DURABLE_LABELS = 3                   # labels a session before the wave
DURABLE_AFTER = 3                    # full rounds after the wakes
DURABLE_AUDITS = 4                   # closed sessions shadow-audited
DURABLE_Q = 4                        # the answer verb's bucket width
DURABLE_POOL = "surrogate:32"        # the prior pool's scorer
DURABLE_CLI_EXTRA: list = []         # extra `cli` flags (rehearsals)


def _round(app, sids, labels, cur: dict, what: str):
    """One label for each of ``sids`` (for the item its last answer in
    ``cur`` proposed), the tickets submitted while the batcher is paused so
    they ride ONE dispatch (a parked session wakes at its submission, as a
    client's label wakes it); updates ``cur`` and returns the wall ms from
    the resume to the last answer."""
    pairs = []
    app.batcher.pause()
    try:
        for sid in sids:
            pairs.append(app._label_begin(sid, int(labels[cur[sid]["idx"]]),
                                          cur[sid]["idx"]))
    finally:
        t0 = time.perf_counter()
        app.batcher.resume()
    outs = [app._payload(s, t.wait(600)) for s, t in pairs]
    ms = (time.perf_counter() - t0) * 1e3
    for sid, o in zip(sids, outs):
        if o["session"] != sid or o["n_labeled"] != \
                cur[sid]["n_labeled"] + 1:
            raise AssertionError(f"{what}: {o} after {cur[sid]}")
        cur[sid] = o
    return ms


def _opens(app, seeds, task_name, cur: dict) -> list:
    """Admit one session a seed; their starts ride ONE dispatch. Their
    first answers land in ``cur``; returns the session ids."""
    pairs = []
    app.batcher.pause()
    try:
        for s in seeds:
            pairs.append(app._open_begin(task_name, s))
    finally:
        app.batcher.resume()
    for sess, t in pairs:
        cur[sess.sid] = app._payload(sess, t.wait(600))
    return [sess.sid for sess, _ in pairs]


def _slot_copy(bucket, slot):
    """A device copy of one slot's carries and its key (the exact
    reference a wake or an import is held to)."""
    with bucket.lock:
        bucket._apply_staged()
        return ([x.clone() for x in bucket._carries(slot)],
                bucket.keys[slot].clone())


def _slot_same(bucket, slot, copy) -> bool:
    """Whether a slot's carries and key are bitwise ``copy``'s (compared
    on the device as bytes)."""
    import torch

    leaves, key = copy
    with bucket.lock:
        bucket._apply_staged()
        cur = bucket._carries(slot)
        return (len(cur) == len(leaves) and torch.equal(
            bucket.keys[slot], key) and all(
                a.dtype == b.dtype and a.shape == b.shape and torch.equal(
                    a.reshape(-1).view(torch.uint8),
                    b.reshape(-1).view(torch.uint8))
                for a, b in zip(cur, leaves)))


def _rows_of(app, sid) -> list:
    from coda_tpu_torch.serve.recovery import data_rows

    return data_rows(app.recorder.history(sid))


def _strip(rows, drop=("pred_label_prob", "trace_id", "request_id")):
    return [{k: v for k, v in r.items() if k not in drop} for r in rows]


def _durable_http(app, bucket, sid, others, labels, cur: dict) -> dict:
    """``sid`` exported (``close``) and imported back through
    ``AsyncHTTPServer``, each while one client thread a session of
    ``others`` labels over HTTP in a closed loop; the slot must come back
    bitwise through the snapshot. Returns the export and import seconds,
    the body's bytes, and the label ms alone (3 a client), during the
    export and during the import."""
    import http.client
    import socket
    import threading

    from coda_tpu_torch.serve import make_server

    srv = make_server(app, 0)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    srv._started.wait(30)
    lat: dict = {"alone": [], "export": [], "import": []}
    errors: list = []

    def loaded(what, fn=None):
        stop = threading.Event()

        def client(s):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            try:
                # headers and body leave in two sends: without this the
                # body waits out the server's delayed ACK (about 40 ms)
                conn.connect()
                conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                     1)
                n, want = 0, 3 if fn is None else 1
                while n < want or (fn is not None and not stop.is_set()):
                    body = json.dumps(
                        {"label": int(labels[cur[s]["idx"]])}).encode()
                    t = time.perf_counter()
                    conn.request("POST", f"/session/{s}/label", body)
                    r = conn.getresponse()
                    text = r.read()
                    ms = (time.perf_counter() - t) * 1e3
                    o = json.loads(text)
                    if r.status != 200 or o["n_labeled"] != \
                            cur[s]["n_labeled"] + 1:
                        raise AssertionError(f"{what} label: {r.status} {o}")
                    cur[s] = o
                    lat[what].append(ms)
                    n += 1
            except BaseException as e:
                errors.append(e)
            finally:
                conn.close()

        ts = [threading.Thread(target=client, args=(s,)) for s in others]
        for t in ts:
            t.start()
        try:
            return fn() if fn is not None else None
        finally:
            stop.set()
            for t in ts:
                t.join()
            if errors:
                raise errors[0]

    def call(method, path, body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            t = time.perf_counter()
            conn.request(method, path, body)
            r = conn.getresponse()
            text = r.read()
            if r.status != 200:
                raise AssertionError(f"{path}: {r.status} {text[:300]}")
            return text, time.perf_counter() - t
        finally:
            conn.close()

    copy = _slot_copy(bucket, app.store.get(sid).slot)
    try:
        loaded("alone")
        body, export_s = loaded("export", lambda: call(
            "POST", f"/session/{sid}/export", b'{"close": true}'))
        text, import_s = loaded("import", lambda: call(
            "POST", "/session/import", body))
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(30)
    info = json.loads(text)
    if info["restored_via"] != "snapshot" or not _slot_same(
            bucket, app.store.get(sid).slot, copy):
        raise AssertionError(f"HTTP import {info}")
    res = {"export_s": export_s, "import_s": import_s,
           "body_bytes": len(body), "label_ms": lat}
    log(f"durable HTTP export/import: a {len(body)}-byte body exported in "
        f"{export_s:.3f} s and imported via the snapshot in "
        f"{import_s:.3f} s, the slot bitwise; {len(others)} clients' label "
        f"ms alone median {_ms(lat['alone'])} max "
        f"{max(lat['alone']):.1f}, during the export median "
        f"{_ms(lat['export'])} max {max(lat['export']):.1f} "
        f"({len(lat['export'])} labels), during the import median "
        f"{_ms(lat['import'])} max {max(lat['import']):.1f} "
        f"({len(lat['import'])} labels)")
    return res


def _durable_headline(dev, task, total: dict, tmp: str, out: dict) -> None:
    """Items 12.1-12.5 at the headline (see the module docstring)."""
    import gc
    import threading
    import types

    import torch

    from coda_tpu_torch.serve import SelectorSpec, ServeApp
    from coda_tpu_torch.serve.faults import FaultInjector
    from coda_tpu_torch.serve.recovery import (data_rows,
                                               iter_session_streams,
                                               last_digest,
                                               load_session_stream,
                                               verify_session_stream)
    from coda_tpu_torch.serve.state import SessionStore
    from coda_tpu_torch.telemetry import SessionRecorder

    import numpy as np

    cuda = dev.type == "cuda"
    cap, half = DURABLE_CAPACITY, DURABLE_CAPACITY // 2
    labels = task.labels.cpu().numpy()
    spec = SelectorSpec.create("coda", n_parallel=cap,
                               eig_mode="incremental")
    rec_dir = os.path.join(tmp, "rec")
    cur: dict = {}

    def free():
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def want_batched(k):
        return k["eig_refresh_score_batched"] > 0 \
            and k["row_gather_batched"] > 0

    def want_lone(k):   # a slot alone: kernels 2 and 3, no batch
        return k["eig_refresh_score"] > 0 and k["row_gather"] > 0 \
            and k["eig_refresh_score_batched"] == 0

    def make_app():
        # no idle demotion or hibernation: the phase pages sessions
        # itself, so its checks see the tiers it set up
        a = ServeApp(spec=spec, capacity=cap, device=dev,
                     tier_spill_dir=os.path.join(tmp, "spill"),
                     idle_warm_s=3600.0, idle_cold_s=3600.0,
                     quality_audit_frac=1.0,
                     recorder=SessionRecorder(out_dir=rec_dir))
        a.add_task("headline", task.preds)
        a.start(warm=True)
        return a

    t0 = time.perf_counter()
    app = _counted("durable app + warm", lambda k: k["eig_score"] > 0,
                   total, make_app)
    out["app_s"] = time.perf_counter() - t0
    bucket = app.store.buckets()[0]
    if app.tiers is None or app.quality is None or bucket.impl != "batched":
        raise AssertionError("the defaults: tiering and quality on, batched")

    # 12.4 quality on against off: the same 16 sessions, the same rows
    def q_run():
        sids = _opens(app, list(range(100, 100 + cap)), "headline", cur)
        times = [_round(app, sids, labels, cur, "quality")
                 for _ in range(DURABLE_LABELS)]
        rows = [data_rows(app.recorder.history(s)) for s in sids]
        for s in sids:
            app.close_session(s)
        return rows, times

    app.quality.audit_frac = 0.0      # these closes queue no audit
    hook_ms = []
    real_hook = app.quality.pre_dispatch

    def timed_hook(*a, **kw):
        t = time.perf_counter()
        v = real_hook(*a, **kw)
        hook_ms.append((time.perf_counter() - t) * 1e3)
        return v

    # on, off, off, on: an order effect (the app's first dispatches)
    # weighs on both sides alike
    runs = {"on": [], "off": []}
    for mode in ("on", "off", "off", "on"):
        app.batcher.quality = (types.SimpleNamespace(pre_dispatch=timed_hook)
                               if mode == "on" else None)
        runs[mode].append(_counted(f"quality {mode}", want_batched, total,
                                   q_run))
    del real_hook, timed_hook
    app.batcher.quality = app.quality
    app.quality.audit_frac = 1.0
    rows = {m: [sum(r, []) for r, _ in runs[m]] for m in runs}
    if any(_strip(r) != _strip(rows["on"][0])
           for m in rows for r in rows[m]):
        raise AssertionError("quality on changed a decision row")
    if not all("pred_label_prob" in r for rs in rows["on"] for r in rs
               if r["do_update"]) or any(
                   "pred_label_prob" in r for rs in rows["off"] for r in rs):
        raise AssertionError("pred_label_prob: on every labeled row with "
                             "quality on, on none with it off")
    t_on = [t for _, ts in runs["on"] for t in ts]
    t_off = [t for _, ts in runs["off"] for t in ts]
    out["quality_ms"] = {"on": t_on, "off": t_off, "hook": hook_ms,
                         "order": "on off off on"}
    log(f"durable quality: {cap} sessions x {DURABLE_LABELS} rounds with "
        f"quality on, off, off, on, rows bitwise equal but "
        f"pred_label_prob; {cap}-slot dispatch ms with the pre-dispatch "
        f"hook {[round(x, 3) for x in t_on]} (median {_ms(t_on)}), "
        f"without {[round(x, 3) for x in t_off]} (median {_ms(t_off)}); "
        f"the hook itself (one gather of {cap} P(best) rows, one copy) ms "
        f"{[round(x, 3) for x in hook_ms]}")

    # 12.1 demote, hibernate and wake; every woken slot is held to a
    # device copy of it taken before the demotion, at its wake
    wakes, copies, woke_same = [], {}, {}
    real_record, real_wake = app.metrics.record_tier, app.tiers._wake

    def record_tier(event, src=None, seconds=None, via=None):
        if event == "wake":
            wakes.append((src, seconds, via))
        return real_record(event, src=src, seconds=seconds, via=via)

    def checked_wake(sid):
        real_wake(sid)
        if sid in copies:
            woke_same[sid] = _slot_same(bucket, app.store.get(sid).slot,
                                        copies.pop(sid))

    app.metrics.record_tier, app.tiers._wake = record_tier, checked_wake
    res: dict = {}

    def step1():
        sids = _opens(app, list(range(cap)), "headline", cur)
        res["full"] = [_round(app, sids, labels, cur, "full")
                       for _ in range(DURABLE_LABELS)]
        low, high = sids[:half], sids[half:]
        # the wave beside 8-slot dispatches of the other half; the last of
        # the 8 gets a label while its snapshot copy is in flight, so its
        # demotion must lose, and the other 7 demote
        victim = res["victim"] = low[-1]
        v_slot, raced = app.store.get(victim).slot, []
        for s in low[:-1]:
            copies[s] = _slot_copy(bucket, app.store.get(s).slot)
        # on the card the label goes in just as the slot's copy is queued
        # on the side stream; on the CPU (copies under the lock) just
        # before the wave's copies
        hook = "_to_stage" if cuda else "snapshot_slots"
        real_copy = getattr(bucket, hook)

        def racing_copy(first, *a, **kw):
            if not raced and (first == v_slot if cuda else v_slot in first):
                raced.append(app._label_begin(
                    victim, int(labels[cur[victim]["idx"]]),
                    cur[victim]["idx"]))
            return real_copy(first, *a, **kw)

        res["alone"] = [_round(app, high, labels, cur, "alone")
                        for _ in range(2)]
        done = []
        setattr(bucket, hook, racing_copy)
        try:
            th = threading.Thread(target=lambda: done.append(
                (app.tiers.demote_batch(bucket, low),
                 time.perf_counter())))
            tw = time.perf_counter()
            th.start()
            during = []
            while th.is_alive() or not during:
                during.append(_round(app, high, labels, cur, "during"))
            th.join()
        finally:
            delattr(bucket, hook)
        n, t_end = done[0]
        if n != half - 1 or len(raced) != 1:
            raise AssertionError(
                f"the wave demoted {n} of {half}, {len(raced)} raced "
                f"({app.tiers.last_snapshot_error})")
        o = app._payload(raced[0][0], raced[0][1].wait(600))
        if o["n_labeled"] != cur[victim]["n_labeled"] + 1:
            raise AssertionError(f"the raced label: {o}")
        cur[victim] = o
        rows = _rows_of(app, victim)
        with bucket.lock:
            bucket._apply_staged()
            got = bucket.digest(app.store.get(victim).slot)
        if [r["n_labeled"] for r in rows] != list(range(len(rows))) \
                or np.float32(got).tobytes() != np.float32(
                    last_digest(rows)).tobytes():
            raise AssertionError("the raced session's rows or digest")
        res["wave"] = {"alone_ms": res["alone"], "during_ms": during,
                       "wave_s": t_end - tw,
                       "per_session_ms": (t_end - tw) * 1e3 / half}
        w = res["wave"]
        log(f"durable demotion wave: {half} sessions in {w['wave_s']:.3f} s"
            f" = {w['per_session_ms']:.1f} ms a session; {half}-slot "
            f"dispatch ms during the wave {[round(x, 3) for x in during]} "
            f"against {[round(x, 3) for x in res['alone']]} without it; a "
            "label during one session's snapshot copy: that demotion lost, "
            f"the other {n} demoted, its rows and digest intact")
        res["new"] = _opens(app, list(range(cap, cap + half)), "headline",
                            cur)
        t1 = time.perf_counter()
        if not app.tiers.hibernate(low[0]):
            raise AssertionError("hibernate")
        res["hibernate_s"] = time.perf_counter() - t1
        res["hibernate_bytes"] = app.tiers._spill.stats()["live_bytes"]
        log(f"durable hibernate: 1 session in {res['hibernate_s']:.3f} s, "
            f"{res['hibernate_bytes']} bytes in the spill log")
        n0 = len(wakes)
        t1 = time.perf_counter()
        _round(app, low, labels, cur, "wake")     # the 8 wake, then label
        res["wake_round_s"] = time.perf_counter() - t1
        res["wakes"] = wakes[n0:]
        res.update(sids=sids, low=low, high=high)
        hot = sorted(app.store._sessions)
        res["after"] = [_round(app, hot, labels, cur, "after")
                        for _ in range(DURABLE_AFTER)]

    try:
        _counted("durable tiers", want_batched, total, step1)
    finally:
        app.metrics.record_tier, app.tiers._wake = real_record, real_wake
    low, high, new = res["low"], res["high"], res["new"]
    m = app.metrics
    if sorted(woke_same) != sorted(low[:-1]) or not all(woke_same.values()):
        raise AssertionError(f"woken slots bitwise: {woke_same}")
    if m.wakes_via_replay or [w[0] for w in res["wakes"]].count("cold") != 1:
        raise AssertionError(f"wakes {res['wakes']}, {m.wakes_via_replay} "
                             "via replay")
    copies.clear()
    free()
    # every session's stream verifies from init through a fresh slot, and
    # its labels are the ones it was sent: none lost, none applied twice
    everyone = res["sids"] + new
    vstore = SessionStore(capacity=1, device=dev)
    vstore.register_task("headline", task.preds)
    vstore._bucket_for("headline", spec).warm()   # admissions copy the init
    t1 = time.perf_counter()

    def verify():
        n = 0
        for sid, path in iter_session_streams(rec_dir):
            if sid not in everyone:
                continue
            meta, rows, _ = load_session_stream(path)
            rows = data_rows(rows)
            t2 = time.perf_counter()
            verify_session_stream(vstore, meta, rows, sid=sid)
            per_stream.append((time.perf_counter() - t2) * 1e3)
            if [r["n_labeled"] for r in rows] != list(range(len(rows))) \
                    or len(rows) - 1 != cur[sid]["n_labeled"]:
                raise AssertionError(f"{sid}: labels lost or doubled")
            n += 1
            n_rows[0] += len(rows)
        return n

    n_rows, per_stream = [0], []

    n_ver = _counted("durable verify", want_lone, total, verify)
    verify_s = time.perf_counter() - t1
    if n_ver != len(everyone):
        raise AssertionError(f"{n_ver} of {len(everyone)} streams verified")
    del vstore
    free()
    w_warm = [w[1] * 1e3 for w in res["wakes"] if w[0] == "warm"]
    w_cold = [w[1] * 1e3 for w in res["wakes"] if w[0] == "cold"]
    out["tiers"] = {k: res[k] for k in ("full", "wave", "hibernate_s",
                                        "hibernate_bytes", "wake_round_s",
                                        "after")}
    out["tiers"].update(wake_warm_ms=w_warm, wake_cold_ms=w_cold,
                        verify_s=verify_s, verify_rounds=n_rows[0],
                        demotions=m.demotions, wakes=m.wakes,
                        peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                                 if cuda else 0.0))
    log(f"durable tiers ({len(everyone)} sessions on {cap} slots): "
        f"{cap}-slot dispatch ms {[round(x, 3) for x in res['full']]}; "
        f"1 session hibernated in {res['hibernate_s']:.3f} s "
        f"({res['hibernate_bytes']} bytes in the spill log); {half} woken "
        f"by a label round in {res['wake_round_s']:.3f} s (wake ms from "
        f"warm {[round(x, 1) for x in w_warm]}, from cold "
        f"{[round(x, 1) for x in w_cold]}), each slot bitwise its "
        f"pre-demotion copy, 0 via replay; {m.demotions} demotions; "
        f"{DURABLE_AFTER} more {cap}-slot rounds "
        f"{[round(x, 3) for x in res['after']]} ms; {n_ver} streams "
        f"({n_rows[0]} rounds) verified bitwise from init in "
        f"{verify_s:.2f} s (ms a stream: median {_ms(per_stream)}, max "
        f"{max(per_stream):.1f}), every label applied once")

    # after the wake round the 8 woken and the 8 admitted are hot, and the
    # make_room demotions paged the other 8 out
    if sorted(app.store._sessions) != sorted(low + new):
        raise AssertionError("the hot set after the wakes")

    # 12.2 export and import at the headline: the in-process payload (raw
    # host arrays) and the JSON one (base64, what HTTP sends), each
    # through the snapshot path, then the replay path without carries
    # (these closes queue no audit: step 3 counts its own)
    app.quality.audit_frac = 0.0
    sid = low[1]
    copy = _slot_copy(bucket, app.store.get(sid).slot)
    ex = {}
    for form in ("raw", "json"):
        t1 = time.perf_counter()
        payload = app.export_session(sid, close=True, raw=form == "raw")
        ex[f"export_{form}_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        info = app.import_session(payload)
        ex[f"import_{form}_s"] = time.perf_counter() - t1
        if info["restored_via"] != "snapshot" or not _slot_same(
                bucket, app.store.get(sid).slot, copy):
            raise AssertionError(f"import ({form} snapshot) {info}")
    app.close_session(sid)
    t1 = time.perf_counter()
    info = _counted("durable import replay", want_lone, total,
                    lambda: app.import_session(
                        dict(payload, carries=None, key=None)))
    replay_s = time.perf_counter() - t1
    if info["restored_via"] != "replay" or not _slot_same(
            bucket, app.store.get(sid).slot, copy):
        raise AssertionError(f"import (replay) {info}")
    app.close_session(sid)    # a free slot for the audits' scratch
    del copy, payload
    app.quality.audit_frac = 1.0
    free()
    out["export"] = dict(ex, import_replay_s=replay_s,
                         rounds=info["rounds"])
    log(f"durable export/import: raw payload export "
        f"{ex['export_raw_s'] * 1e3:.1f} ms, import via the snapshot "
        f"{ex['import_raw_s'] * 1e3:.1f} ms; JSON (base64) payload export "
        f"{ex['export_json_s'] * 1e3:.1f} ms, import "
        f"{ex['import_json_s'] * 1e3:.1f} ms; import via replay "
        f"({info['rounds']} rounds) {replay_s * 1e3:.1f} ms; the slot "
        "bitwise every time")

    # 12.2 over HTTP: one export and its import at the headline, each
    # while 8 clients label over HTTP (these closes queue no audit)
    app.quality.audit_frac = 0.0
    out["http"] = _counted(
        "durable http", lambda k: k["row_gather"] + k["row_gather_batched"]
        > 0, total, lambda: _durable_http(
            app, bucket, low[2], low[3:] + new[DURABLE_AUDITS + 1:],
            labels, cur))
    app.quality.audit_frac = 1.0
    free()

    # 12.3 shadow audits of sessions that ran in 16-slot batched
    # dispatches: each alone in a free slot (kernel 2)
    audit_ms = []
    real_audit = app.quality.auditor.audit

    def timed_audit(*a, **kw):
        t = time.perf_counter()
        v = real_audit(*a, **kw)
        audit_ms.append((time.perf_counter() - t) * 1e3)
        return v

    app.quality.auditor.audit = timed_audit
    audited, tampered = new[:DURABLE_AUDITS], new[DURABLE_AUDITS]

    def audits():
        for s in audited:
            app.close_session(s)
        if not app.quality.drain(300):
            raise AssertionError("the audits did not finish")

    _counted("durable audits", want_lone, total, audits)
    a = app.quality.snapshot()["audit"]
    if (a["audits_total"], a["divergences_total"], a["audits_skipped"]) \
            != (DURABLE_AUDITS, 0, 0):
        raise AssertionError(f"audits {a}")
    app.quality.auditor.faults = FaultInjector("stream_tamper:after=0")
    n_rows = len(data_rows(app.recorder.history(tampered)))
    _counted("durable tampered audit", want_lone, total,
             lambda: (app.close_session(tampered), app.quality.drain(300)))
    app.quality.auditor.faults = None
    a = app.quality.snapshot()["audit"]
    div = (a["last_divergences"] or [{}])[-1]
    if a["divergences_total"] != 1 or div.get("session") != tampered \
            or div.get("round") != n_rows // 2:
        raise AssertionError(f"tampered audit {a}")
    out["audit_ms"] = audit_ms
    log(f"durable audits: {DURABLE_AUDITS} closed sessions replayed alone "
        f"(kernel 2), each ok, ms {[round(x, 1) for x in audit_ms]}; "
        f"stream_tamper reported diverged at round {div['round']} of "
        f"{n_rows}")

    # 12.5 crash restore in process: the live sessions' answers before
    # the "crash", and after a second app restored them
    for s in list(app.tiers.parked_sids()):
        app.close_session(s)         # the restore stays one wave
    live = sorted(app.store._sessions)
    before = {s: app.best(s) for s in live}
    app.quiesce(hard=True)           # no close marker is written
    # nothing may keep the first app's slab alive: its audit worker, and
    # the wrappers this phase put around its methods
    app.quality.stop()
    worker = app.quality._worker
    del app, bucket, m, real_record, real_wake, real_audit, record_tier
    del checked_wake, timed_audit
    if worker is not None:
        worker.join(5)
    del worker
    free()
    mem_freed = torch.cuda.memory_allocated() / 1e9 if cuda else 0.0
    app = make_app()
    b2 = app.store.buckets()[0]
    h0 = b2.warm_hits
    t1 = time.perf_counter()
    report = _counted("durable restore", want_batched, total,
                      app.restore_sessions)
    restore_s = time.perf_counter() - t1
    n_disp = b2.warm_hits - h0
    try:
        if sorted(report["restored"]) != live or report["failed"]:
            raise AssertionError(f"restore {report}")
        for s in live:
            if app.best(s) != before[s]:
                raise AssertionError(f"restored {s}: best not bitwise")
    finally:
        app.drain()
    out["restore"] = {"sessions": len(live), "seconds": restore_s,
                      "dispatches": n_disp, "gb_before_app": mem_freed}
    log(f"durable crash restore: {len(live)} sessions restored in "
        f"{restore_s:.3f} s through {n_disp} coalesced dispatches, each "
        f"/best bitwise its pre-crash answer ({mem_freed:.2f} GB allocated "
        "once the first app was freed)")
    del app, b2
    free()


def _serve_proc(args, port):
    cmd = [sys.executable, "-m", "coda_tpu_torch.cli", "serve", "--task",
           "digits_h80", "--data-dir", os.path.join(HERE, "data"),
           "--port", str(port), *args, *DURABLE_CLI_EXTRA]
    return subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _ready(proc, port):
    for _ in range(1200):
        try:
            if _http(port, "GET", "/healthz")[0] == 200:
                return
        except OSError:
            pass
        if proc.poll() is not None:
            raise AssertionError(f"cli serve exited {proc.returncode}: "
                                 f"{proc.stdout.read()}")
        time.sleep(0.1)
    raise AssertionError("cli serve never became ready")


def _j(port, method, path, body=None, want=200):
    code, text = _http(port, method, path, body)
    if want is not None and code != want:
        raise AssertionError(f"{method} {path}: {code} {text}")
    return json.loads(text)


def _stop(proc):
    if proc.poll() is None:
        proc.send_signal(__import__("signal").SIGTERM)
        try:
            proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()


def _durable_cli(out: dict, tmp: str) -> None:
    """Item 12.6: ``cli serve`` on ``digits_h80`` in subprocesses (three
    servers started together), ``cli replay-serve`` and ``cli quality``."""
    from coda_tpu_torch import cli
    from coda_tpu_torch.data import Dataset
    from coda_tpu_torch.selectors import surrogate as sg
    from coda_tpu_torch.telemetry.quality import tamper_rows_ulp

    h80 = Dataset.from_file(os.path.join(HERE, "data", "digits_h80.npz"),
                            name="digits_h80", device="cpu")
    labels = h80.labels.numpy()
    C = int(h80.preds.shape[2])
    rec = os.path.join(tmp, "cli_rec")
    ports = [_free_port() for _ in range(3)]
    t0 = time.perf_counter()
    # the defaults (tiering and quality on): ticks 1-8 are two opens and
    # six labels, the 9th (an open) commits and the process exits 17
    procs = [_serve_proc(["--capacity", "8", "--record-dir", rec,
                          "--fault-spec", "crash_after_tick:after=8"],
                         ports[0]),
             _serve_proc(["--capacity", "4", "--acq-batch", str(DURABLE_Q),
                          "--fault-spec", "oracle_poison:after=6"],
                         ports[1]),
             _serve_proc(["--capacity", "4", "--eig-scorer", DURABLE_POOL,
                          "--surrogate-prior", "pool"], ports[2])]
    try:
        for p, port in zip(procs, ports):
            _ready(p, port)
        ready_s = time.perf_counter() - t0
        port = ports[0]

        def drive(seed, n):
            cur = _j(port, "POST", "/session", {"seed": seed})
            for _ in range(n):
                cur = _j(port, "POST", f"/session/{cur['session']}/label",
                         {"label": int(labels[cur["idx"]])})
            return cur

        a = drive(0, 3)
        exp = _j(port, "POST", f"/session/{a['session']}/export",
                 {"close": True})
        imp = _j(port, "POST", "/session/import", exp)
        if imp["restored_via"] != "snapshot" or imp["idx"] != a["idx"]:
            raise AssertionError(f"http import {imp}")
        b = drive(1, 3)
        before = {s: _j(port, "GET", f"/session/{s}/best")
                  for s in (a["session"], b["session"])}
        try:
            _http(port, "POST", "/session", {"seed": 2})
        except OSError:
            pass           # the process may exit before it answers
        procs[0].wait(timeout=120)
        procs[0].communicate()
        if procs[0].returncode != 17:
            raise AssertionError(f"crash exit {procs[0].returncode}")
        procs.append(_serve_proc(["--capacity", "8", "--record-dir", rec,
                                  "--restore"], port))
        _ready(procs[-1], port)
        for s, want in before.items():
            got = _j(port, "GET", f"/session/{s}/best")
            if got != want:
                raise AssertionError(f"restored {s}: {got} != {want}")
        # replay-serve on the streams (0) and on a one-ulp tamper (2)
        argv = ["replay-serve", rec, "--task", "digits_h80", "--data-dir",
                os.path.join(HERE, "data"), *DURABLE_CLI_EXTRA]
        if cli.main(argv) != 0:
            raise AssertionError("replay-serve on the streams")
        bad = os.path.join(tmp, "cli_tampered")
        os.makedirs(bad)
        name = f"session_{b['session']}.jsonl"
        with open(os.path.join(rec, name)) as f:
            rows = [json.loads(line) for line in f]
        at = [i for i, r in enumerate(rows) if not r.get("kind")]
        for i, r in zip(at, tamper_rows_ulp([rows[i] for i in at], 2)):
            rows[i] = r
        with open(os.path.join(bad, name), "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in rows))
        argv[1] = bad
        if cli.main(argv) != 2:
            raise AssertionError("replay-serve on a tampered copy")
        if cli.main(["quality", "--url", f"http://127.0.0.1:{port}"]) != 0:
            raise AssertionError("cli quality")
        _stop(procs[-1])
        if procs[-1].returncode != 0:
            raise AssertionError(f"restored server exit "
                                 f"{procs[-1].returncode}")

        # the crowd's answer verb on a q = 4 bucket: out of order, an
        # abstain, a redelivery and a poisoned answer (the 7th arrival);
        # the labels verb with the same final labels commits the same rows
        port = ports[1]
        x = _j(port, "POST", "/session", {"seed": 3})
        y = _j(port, "POST", "/session", {"seed": 3})
        poisoned = 0
        for r_i, order in enumerate(([2, 0, 3, 1], [1, 3, 0, 2])):
            ans = [int(labels[i]) for i in x["idx"]]
            if r_i == 0:
                r = _j(port, "POST", f"/session/{x['session']}/answer",
                       {"slot": 0, "abstain": True})
                if r["verb"] != "abstain":
                    raise AssertionError(f"abstain {r}")
            for j in order:
                r = _j(port, "POST", f"/session/{x['session']}/answer",
                       {"slot": j, "label": ans[j],
                        "request_id": f"x{r_i}-{j}"})
            if r["verb"] != "dispatched":
                raise AssertionError(f"answer round {r}")
            poisoned += sum(g == (t + 1) % C and g != t
                            for g, t in zip(r["applied"], ans))
            x = r
            y = _j(port, "POST", f"/session/{y['session']}/labels",
                   {"labels": r["applied"]})
        drop = ("request_id", "trace_id", "pred_label_prob")
        tx, ty = ([r for r in _j(port, "GET", f"/session/{v['session']}"
                                 "/trace")["rounds"] if not r.get("kind")]
                  for v in (x, y))
        if len(tx) != 3 or _strip(tx, drop) != _strip(ty, drop):
            raise AssertionError("answer rows != labels rows")
        oracle = _j(port, "GET", "/stats")["oracle"]
        if poisoned != 1 or oracle["poisoned"] != 1 \
                or oracle["abstentions"] != 1:
            raise AssertionError(f"oracle counters {oracle}, {poisoned}")

        # the prior pool: a donor contributes at close, the next session
        # carries prior_fit and its import-replay reproduces its rows
        port = ports[2]
        donor = _j(port, "POST", "/session", {"seed": 0})
        for _ in range(sg.SURROGATE_PRIOR_MIN_ROUNDS + 2):
            donor = _j(port, "POST", f"/session/{donor['session']}/label",
                       {"label": int(labels[donor["idx"]])})
        _j(port, "DELETE", f"/session/{donor['session']}")
        if _j(port, "GET", "/stats")["prior_pool"][
                "sessions_contributed"] != 1:
            raise AssertionError("the donor did not contribute")
        s = _j(port, "POST", "/session", {"seed": 1})
        for _ in range(3):
            s = _j(port, "POST", f"/session/{s['session']}/label",
                   {"label": int(labels[s["idx"]])})
        best = _j(port, "GET", f"/session/{s['session']}/best")
        exp = _j(port, "POST", f"/session/{s['session']}/export",
                 {"close": True})
        if not exp.get("prior_fit"):
            raise AssertionError("the next session carries no prior_fit")
        imp = _j(port, "POST", "/session/import",
                 dict(exp, carries=None, key=None))
        if imp["restored_via"] != "replay" or \
                _j(port, "GET", f"/session/{s['session']}/best") != best:
            raise AssertionError(f"prior import replay {imp}")
    finally:
        for p in procs:
            _stop(p)
    out["cli_ready_s"] = ready_s
    log(f"durable cli (digits_h80): 3 servers ready in {ready_s:.1f} s; "
        "HTTP export/import via the snapshot; crash_after_tick exit 17, "
        "--restore /best bitwise; replay-serve 0 and 2 (one ulp); cli "
        f"quality 0; q = {DURABLE_Q} answers out of order with an abstain "
        "and an oracle_poison commit the labels verb's rows bitwise; the "
        f"prior pool ({DURABLE_POOL}) seeds the next session, whose "
        "import-replay reproduces it")


def phase_durable(dev, task, total: dict, smi: str) -> dict:
    """Serve durability, tiers and quality (see the module docstring, item
    12). Returns the measured figures."""
    import shutil
    import tempfile

    import gc

    import torch

    def allocated_gb() -> float:
        gc.collect()
        return (torch.cuda.memory_allocated() / 1e9 if dev.type == "cuda"
                else 0.0)

    t_phase = time.perf_counter()
    out: dict = {"card": smi}
    tmp = tempfile.mkdtemp(prefix="durable_")
    try:
        log(f"durable on {smi}: headline {HEADLINE}, "
            f"{DURABLE_CAPACITY} slots, tiering and quality on; "
            f"{allocated_gb():.2f} GB allocated before it")
        _durable_headline(dev, task, total, tmp, out)
        _durable_cli(out, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"durable phase: {out['phase_s']:.1f} s; {allocated_gb():.2f} GB "
        "allocated after it")
    return out


# ---------------------------------------------------------------------------
# 13. the serve fleet
# ---------------------------------------------------------------------------

FLEET_REPLICAS = 3                   # in-process headline replicas
FLEET_CAPACITY = 6                   # slots a replica
FLEET_SESSIONS = 12                  # seeds 0-11
FLEET_LABELS = 3                     # labels a session before the moves
FLEET_CLIENTS = 8                    # client threads during the restart
FLEET_THINK_S = 0.25                 # a client's pause between labels
FLEET_CAP_LABELS = 25                # labels a session during the restart
FLEET_BEFORE_S = 3.0                 # traffic before the restart, seconds
FLEET_SCALE_S = 3.0                  # traffic a scaling configuration
#                                      (5 s until PR 18)
FLEET_HTTP_CAPACITY = 4              # slots of a `cli serve` replica
FLEET_CLI_EXTRA: list = []           # extra `cli serve` flags (rehearsals)
_ROW_BITS = ("next_idx", "next_prob", "best", "pbest_max", "pbest_entropy",
             "label")


def _fleet_args(cap: int, tmp: str):
    """``cli serve``'s arguments for a headline fleet: the reference's
    serve defaults (tiering and quality on), a record and a spill
    directory, no idle paging (the phase moves sessions itself) and the
    cached EIG tier (``--eig-mode incremental``: under ``auto`` the
    budget sees every slot, and 6 headline slots resolve ``factored``,
    which runs no kernel)."""
    from coda_tpu_torch.serve.server import parse_args

    C, N, H = HEADLINE
    return parse_args(["--synthetic", f"{H},{N},{C}", "--capacity", str(cap),
                       "--record-dir", os.path.join(tmp, "rec"),
                       "--tier-spill-dir", os.path.join(tmp, "spill"),
                       "--idle-warm-s", "3600", "--idle-cold-s", "3600",
                       "--eig-mode", "incremental", *FLEET_CLI_EXTRA])


class _Clients:
    """Client threads labeling sessions through a router in a closed loop
    (the true label of each proposed item, one request id a logical label,
    retried through a migration's hold, a dead replica or a full slab),
    each session at most ``cap`` labels; every answer must commit exactly
    one more label. Latencies (ms, the router call) are kept."""

    def __init__(self, router, sids, labels, cur: dict, threads: int,
                 think_s: float = 0.0, cap: Optional[int] = None):
        self.router, self.labels, self.cur = router, labels, cur
        self.think_s, self.cap = think_s, cap
        self.ms: list = []
        self.errors: list = []
        self.stop_ev = threading.Event()
        self.done = dict.fromkeys(sids, 0)
        self.threads = [threading.Thread(target=self._run,
                                         args=(sids[i::threads],),
                                         daemon=True)
                        for i in range(min(threads, len(sids)))]

    def _one(self, sid) -> None:
        from coda_tpu_torch.serve.state import BucketQuarantined, SlabFull

        prev = self.cur[sid]
        lab = int(self.labels[prev["idx"]])
        rid = uuid.uuid4().hex
        t0 = time.perf_counter()
        deadline = t0 + 300.0
        while True:
            try:
                o = self.router.label(sid, lab, request_id=rid)
                break
            except (SlabFull, BucketQuarantined, ConnectionError,
                    TimeoutError):
                if time.perf_counter() > deadline:
                    raise
                time.sleep(0.02)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        if o["n_labeled"] != prev["n_labeled"] + 1:
            raise AssertionError(f"label of {sid}: {o['n_labeled']} after "
                                 f"{prev['n_labeled']}")
        self.cur[sid] = o
        self.done[sid] += 1

    def _run(self, mine) -> None:
        try:
            while not self.stop_ev.is_set():
                todo = [s for s in mine
                        if self.cap is None or self.done[s] < self.cap]
                if not todo:
                    self.stop_ev.wait(0.05)
                    continue
                for sid in todo:
                    if self.stop_ev.is_set():
                        break
                    self._one(sid)
                    if self.think_s:
                        self.stop_ev.wait(self.think_s)
        except BaseException as e:
            self.errors.append(e)

    def __enter__(self):
        self.t0 = time.perf_counter()
        for t in self.threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self.stop_ev.set()
        for t in self.threads:
            t.join()
        self.router = None   # the fleet's memory is not the clients' to keep
        self.wall_s = time.perf_counter() - self.t0
        if self.errors and exc[0] is None:
            raise self.errors[0]

    def summary(self) -> str:
        xs = sorted(self.ms)
        if not xs:
            return "no labels"
        p99 = xs[min(len(xs) - 1, int(0.99 * len(xs)))]
        return (f"{len(xs)} labels, p50 {statistics.median(xs):.1f} ms, "
                f"p99 {p99:.1f} ms, max {xs[-1]:.1f} ms")

    def p(self, q: float) -> float:
        xs = sorted(self.ms)
        return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else float("nan")


def _label_all(router, sids, labels, cur: dict) -> None:
    """One label for every session of ``sids``, all in flight at once."""
    with _Clients(router, sids, labels, cur, len(sids), cap=1) as c:
        while any(c.done[s] < 1 for s in sids) and not c.errors:
            time.sleep(0.005)


def _same_rows(a: list, b: list, what: str) -> None:
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} rows against {len(b)}")
    for k, (x, y) in enumerate(zip(a, b)):
        for q in _ROW_BITS:
            u, v = x.get(q), y.get(q)
            same = (_f32_bits(u) == _f32_bits(v) if isinstance(u, float)
                    else u == v)
            if not same:
                raise AssertionError(f"{what} row {k}: {q} {u} != {v}")


def _best_same(a: dict, b: dict) -> bool:
    return (a["best"] == b["best"] and a["n_labeled"] == b["n_labeled"]
            and a["idx"] == b["idx"]
            and [_f32_bits(x) for x in a["pbest"]]
            == [_f32_bits(x) for x in b["pbest"]])


def _fleet_healthy(fleet, when: str) -> None:
    """Every live replica answers ``/healthz`` ``ok``: warm, no failed,
    quarantined or lazy bucket, no degraded stream. (``Fleet`` already
    refuses a replica whose warm-up failed.)"""
    for rid, app in fleet.apps.items():
        h = app.healthz()
        if h["status"] != "ok":
            raise AssertionError(f"fleet {when}: replica {rid} {h}")


def _fleet_headline(dev, task, labels, tmp: str, out: dict) -> dict:
    """Items 13.1-13.6 (see the module docstring). Returns each session's
    seed, rows and current replica."""
    import torch

    from coda_tpu_torch.serve import build_fleet, rendezvous_owner

    cuda = dev.type == "cuda"

    def alloc():
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
            return torch.cuda.memory_allocated()
        return 0

    def peak_reset():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        if cuda:
            torch.cuda.synchronize()
            return torch.cuda.max_memory_allocated()
        return 0

    args = _fleet_args(FLEET_CAPACITY, tmp)
    gb = 1e9
    before = alloc()
    peak_reset()
    t0 = time.perf_counter()
    fleet = build_fleet(args, FLEET_REPLICAS, dataset=task)
    fleet.start(warm=True)
    out["build_s"] = time.perf_counter() - t0
    r = fleet.router
    try:
        steady = alloc()
        replica_bytes = (steady - before) / FLEET_REPLICAS
        log(f"fleet: {FLEET_REPLICAS} replicas x {FLEET_CAPACITY} headline "
            f"slots built and warm in {out['build_s']:.1f} s (build_fleet, "
            f"tiering and quality on); {steady / gb:.2f} GB allocated "
            f"({replica_bytes / gb:.2f} GB a replica), peak "
            f"{peak() / gb:.2f} GB")
        if any(a.tiers is None or a.quality is None
               for a in fleet.apps.values()):
            raise AssertionError("fleet: the defaults (tiering, quality)")
        _fleet_healthy(fleet, "build")

        # 13.2 open and label through the router
        cur: dict = {}
        seeds: dict = {}
        for s in range(FLEET_SESSIONS):
            o = r.open_session(seed=s)
            cur[o["session"]] = o
            seeds[o["session"]] = s
        sids = list(cur)
        for sid in sids:
            owner = rendezvous_owner(sid, fleet.replica_ids)
            home = fleet.apps[owner]
            if r._locate(sid) != owner or not (
                    home.store.alive(sid) or home.tiers.parked(sid)):
                raise AssertionError(f"fleet: {sid} not on its owner")
        for _ in range(FLEET_LABELS):
            _label_all(r, sids, labels, cur)
        log(f"fleet: {len(sids)} sessions on their rendezvous owners "
            f"({sorted(map(r._locate, sids))}), {FLEET_LABELS} labels each")

        # 13.3 one explicit migration, the slot bitwise
        sid = sids[0]
        r.best(sid)      # resident (a full slab may have paged it out)
        src = r._locate(sid)
        dst = next(x for x in fleet.replica_ids if x != src)
        sess = fleet.apps[src].store.get(sid)
        copy = _slot_copy(sess.bucket, sess.slot)
        t0 = time.perf_counter()
        info = r.migrate_session(sid, src, dst)
        out["migrate_ms"] = (time.perf_counter() - t0) * 1e3
        sapp, dapp = fleet.apps[src], fleet.apps[dst]
        if info.get("migrated") != sid or info["via"] != "snapshot" or \
                info["epoch"] != 1 or sapp.store.alive(sid) or \
                sapp.tiers.parked(sid) or sapp.held(sid):
            raise AssertionError(f"fleet migration: {info}")
        sess = dapp.store.get(sid)
        if sess.epoch != 1 or not _slot_same(sess.bucket, sess.slot, copy):
            raise AssertionError("fleet migration: the slot is not bitwise")
        del copy, sess
        log(f"fleet: {src} -> {dst} migration via the snapshot in "
            f"{out['migrate_ms']:.1f} ms, epoch 1, the source fenced, the "
            "slot bitwise")

        # 13.4 rolling restart under traffic, against the same traffic
        # before it (the steady state's peak)
        peak_reset()
        with _Clients(r, sids, labels, cur, FLEET_CLIENTS,
                      think_s=FLEET_THINK_S) as calm:
            time.sleep(FLEET_BEFORE_S)
        steady = peak()
        peak_reset()
        with _Clients(r, sids, labels, cur, FLEET_CLIENTS,
                      think_s=FLEET_THINK_S, cap=FLEET_CAP_LABELS) as busy:
            t0 = time.perf_counter()
            rep = fleet.rolling_restart()
            out["rolling_s"] = time.perf_counter() - t0
        out["rolling_peak_gb"] = peak() / gb
        out["steady_gb"] = steady / gb
        out["replica_gb"] = replica_bytes / gb
        out["rolling_rounds"] = [x["seconds"] for x in rep["rounds"]]
        out["label_before"] = (calm.p(0.5), calm.p(0.99))
        out["label_during"] = (busy.p(0.5), busy.p(0.99))
        if rep["sessions_dropped"] or rep["migration_failures"] or \
                any(x["failed"] for x in rep["rounds"]):
            raise AssertionError(f"rolling restart: {rep}")
        _fleet_healthy(fleet, "rolling restart")   # every rebuilt replica
        if peak() - steady > replica_bytes:
            raise AssertionError(
                f"rolling restart peak {peak() / gb:.2f} GB past the steady "
                f"state's {steady / gb:.2f} GB plus one replica")
        log(f"fleet rolling restart: {out['rolling_s']:.1f} s, "
            f"{', '.join(f'{s:.1f}' for s in out['rolling_rounds'])} s a "
            f"replica, {rep['migrations']} migrations "
            f"({rep['migrations_via']}), 0 dropped; labels before "
            f"({FLEET_CLIENTS} clients, {FLEET_THINK_S} s think): "
            f"{calm.summary()}; during: {busy.summary()}; "
            f"max_memory_allocated {out['rolling_peak_gb']:.2f} GB against "
            f"{out['steady_gb']:.2f} GB under the traffic before it and "
            f"{out['replica_gb']:.2f} GB a replica")

        # 13.5 a peer page under watermark pressure: a session demoted
        # to a replica's warm tier, then that replica's warm watermark
        # lowered to 0, so its tier sweeper (its own thread) offers the
        # payload to the least loaded peer through the page_out hook. The
        # session is taken resident on a replica with nothing else warm,
        # so the sweep pages it alone
        sid = None
        for s in sids[1:]:
            r.best(s)    # resident (a full slab may have paged it out)
            a = fleet.apps[r._locate(s)]
            if a.store.alive(s) and not a.tiers.counts()["warm"]:
                sid = s
                break
        if sid is None:
            raise AssertionError("fleet peer page: every replica has a "
                                 "warm session")
        src = r._locate(sid)
        app = fleet.apps[src]
        sess = app.store.get(sid)
        copy = _slot_copy(sess.bucket, sess.slot)
        del sess
        pages = r.counters["peer_pages"]
        if not app.tiers.try_demote(sid):
            raise AssertionError("fleet peer page: the demotion lost")
        watermark = app.tiers.max_warm
        t0 = time.perf_counter()
        app.tiers.max_warm = 0
        app.tiers._wakeup.set()
        while r.counters["peer_pages"] == pages and \
                time.perf_counter() - t0 < 60:
            time.sleep(0.001)
        out["page_ms"] = (time.perf_counter() - t0) * 1e3
        app.tiers.max_warm = watermark
        peer = r._placed.get(sid)
        if r.counters["peer_pages"] != pages + 1 or \
                peer in (None, src) or app.tiers.parked(sid):
            with open(r.journal.path) as f:
                tail = f.read().splitlines()[-3:]
            raise AssertionError(f"fleet peer page: placed on {peer}, "
                                 f"{r.counters['peer_pages'] - pages} "
                                 "page(s), the journal's last records "
                                 f"{tail}")
        sess = fleet.apps[peer].store.get(sid)
        if not _slot_same(sess.bucket, sess.slot, copy):
            raise AssertionError("fleet peer page: the slot is not bitwise")
        del copy, sess
        _label_all(r, [sid], labels, cur)
        log(f"fleet peer page: {src} -> {peer} in {out['page_ms']:.1f} ms "
            "from the watermark's drop (the sweep, the hook's journaled "
            "hand-off and the peer's import), the slot bitwise on the peer, "
            "labeled there")

        # 13.6 kill and revive under traffic
        victim = r._locate(sids[2])
        # the victim's own sessions, hot and parked (the router's map may
        # lag a wake or a search)
        mine = fleet.apps[victim].list_sessions()["sessions"]
        rest = [s for s in sids if s not in mine]
        best = {s: r.best(s) for s in mine}
        with _Clients(r, rest, labels, cur, FLEET_CLIENTS,
                      think_s=FLEET_THINK_S, cap=5) as during:
            fleet.kill_replica(victim)
            killed = alloc()
            t0 = time.perf_counter()
            restore = fleet.revive_replica(victim)
            out["revive_s"] = time.perf_counter() - t0
            for _ in range(600):
                if victim in r.routable():
                    break
                time.sleep(0.05)
        if victim not in r.routable() or \
                set(mine) - set(restore.get("restored") or ()):
            raise AssertionError(f"fleet revive: {restore}")
        _fleet_healthy(fleet, "revival")
        for s in mine:
            if not _best_same(best[s], r.best(s)):
                raise AssertionError(f"fleet revive: /best of {s} moved")
        log(f"fleet kill/revive: {victim} killed under traffic "
            f"({killed / gb:.2f} GB allocated after it), revived with "
            f"crash restore of {len(restore['restored'])} session(s) in "
            f"{out['revive_s']:.1f} s, each /best bitwise; the others' "
            f"labels meanwhile: {during.summary()}")
        c = r.counters
        if c["sessions_dropped"] or c["peer_pages"] != 1:
            raise AssertionError(f"fleet counters: {c}")
        out["counters"] = {k: c[k] for k in ("migrations", "peer_pages",
                                             "sessions_dropped",
                                             "migration_failures",
                                             "evictions", "rejoins")}
        from coda_tpu_torch.serve.recovery import data_rows

        runs = {s: {"seed": seeds[s], "where": r._locate(s),
                    "rows": data_rows(r.trace(s)["rounds"])} for s in sids}
        for s, run in runs.items():
            if len(run["rows"]) != cur[s]["n_labeled"] + 1:
                raise AssertionError(f"fleet: {s} rows")
        return runs
    finally:
        fleet.close(timeout=60)
        del fleet, r


def _fleet_verify(dev, task, labels, tmp: str, runs: dict,
                  out: dict) -> None:
    """Every session's stream, on the replica that holds it last, replays
    from init bitwise in a fresh slot, each label applied once."""
    from coda_tpu_torch.serve.recovery import (data_rows,
                                               load_session_stream,
                                               verify_session_stream)
    from coda_tpu_torch.serve.state import SessionStore

    store = SessionStore(capacity=1, device=dev)
    store.register_task(task.name, task.preds)
    t0 = time.perf_counter()
    n = 0
    for sid, run in runs.items():
        meta, rows, _ = load_session_stream(os.path.join(
            tmp, "rec", run["where"], f"session_{sid}.jsonl"))
        rows = data_rows(rows)
        _same_rows(rows, run["rows"], f"stream of {sid}")
        for a, b in zip(rows, rows[1:]):
            if b["label"] != int(labels[a["next_idx"]]):
                raise AssertionError(f"stream of {sid}: a label twice")
        verify_session_stream(store, meta, rows, sid=sid)
        n += len(rows)
    out["verify_s"] = time.perf_counter() - t0
    log(f"fleet: {len(runs)} streams ({n} rows) verified from init in "
        f"{out['verify_s']:.1f} s, every label once")


def _fleet_scaling(dev, task, labels, tmp: str, runs: dict,
                   out: dict) -> None:
    """Item 13.7: the same 12 slots as 1 replica x 12 and 3 x 4 (each
    replica as many sessions as slots), 12 closed-loop clients through
    the router; the 1 x 12 run first holds the headline fleet's sessions
    bitwise (one app, the same labels). ``scripts/torch_fleet_scaling.py``
    measures where the 3 x 4 dispatch time goes."""
    import torch

    from coda_tpu_torch.serve import build_fleet
    from coda_tpu_torch.serve.recovery import data_rows

    slots = FLEET_SESSIONS
    for n_rep in (1, FLEET_REPLICAS):
        cap = slots // n_rep
        sub = os.path.join(tmp, f"scale{n_rep}")
        fleet = build_fleet(_fleet_args(cap, sub), n_rep, dataset=task)
        fleet.start(warm=True)
        r = fleet.router
        try:
            _fleet_healthy(fleet, f"{n_rep} x {cap} build")
            cur = {}
            for run in runs.values() if n_rep == 1 else ():
                o = r.open_session(seed=run["seed"])
                for _ in range(len(run["rows"]) - 1):
                    o = r.label(o["session"], int(labels[o["idx"]]))
                _same_rows(data_rows(r.trace(o["session"])["rounds"]),
                           run["rows"], f"one app, seed {run['seed']}")
                r.close_session(o["session"])
            if n_rep == 1:
                log(f"fleet: each of the {len(runs)} sessions bitwise the "
                    "same seed on one 12-slot app with the same labels")
            # every replica holds as many sessions as it has slots: a
            # session the hash puts on a full replica is closed again
            # (12 hashed sessions seldom split 4/4/4, and a replica with
            # more sessions than slots starves the parked ones of a
            # closed loop)
            held: dict = {}
            seed = 100
            while len(cur) < slots:
                o = r.open_session(seed=seed)
                seed += 1
                rid = r._locate(o["session"])
                if held.get(rid, 0) >= cap:
                    r.close_session(o["session"])
                    continue
                held[rid] = held.get(rid, 0) + 1
                cur[o["session"]] = o
            sids = list(cur)
            with _Clients(r, sids, labels, cur, slots) as c:
                time.sleep(FLEET_SCALE_S)
                # the timed window, then one profiled second
                wall = time.perf_counter() - c.t0
                timed = c.summary()
                rps, p50, p99 = len(c.ms) / wall, c.p(0.5), c.p(0.99)
                steps = [(a.stats()["step_latency"].get("p50_ms"),
                          a.stats()["mean_occupancy"])
                         for a in fleet.apps.values()]
                prof = _dispatch_profile(lambda: time.sleep(1.0))
            busy = prof["device_ms"] / 1e3
            out[f"scale_{n_rep}x{cap}"] = {"rps": rps, "p50": p50,
                                           "p99": p99, "busy": busy,
                                           "steps": steps}
            log(f"fleet scaling {n_rep} x {cap} slots, {slots} clients, "
                f"default stream: {rps:.1f} labels a second over "
                f"{wall:.1f} s, {timed}; a replica's dispatch step p50 ms "
                f"and mean occupancy "
                f"{[(round(s or 0, 1), round(o or 0, 2)) for s, o in steps]}; "
                f"device busy {busy:.2f} of a profiled second "
                f"({prof['events']} events)")
        finally:
            fleet.close(timeout=60)
            del fleet, r
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()


def _fleet_chaos(dev, out: dict) -> None:
    """Item 13.8: the six fleet fault scenarios on ``digits_h80``."""
    from coda_tpu_torch.data import Dataset, find_task_file
    from scripts import torch_fleet_chaos as chaos

    h80 = Dataset.from_file(find_task_file(os.path.join(HERE, "data"),
                                           "digits_h80"),
                            name="digits_h80", device=dev)
    t0 = time.perf_counter()
    res = chaos.run_matrix(h80, dev)
    out["chaos_s"] = time.perf_counter() - t0
    bad = [v for sc in res.values() for v in sc["violations"]]
    for name, sc in res.items():
        log(f"fleet chaos {name}: "
            f"{len(sc['violations'])} violation(s); "
            f"{ {k: v for k, v in sc.items() if k != 'violations'} }")
    if bad or len(res) != 6:
        raise AssertionError(f"fleet chaos: {bad}")
    log(f"fleet chaos: 6 scenarios on digits_h80, 0 violations, "
        f"{out['chaos_s']:.1f} s")


def _fleet_http(dev, tmp: str, out: dict) -> None:
    """Item 13.9: two ``cli serve`` replicas on ``digits_h80`` behind
    ``HttpReplica`` handles and a router on ``make_server``."""
    import threading as _th

    from coda_tpu_torch import cli
    from coda_tpu_torch.data import Dataset, find_task_file
    from coda_tpu_torch.serve import (HttpReplica, SelectorSpec, ServeApp,
                                      SessionRouter, make_server)
    from coda_tpu_torch.serve.recovery import data_rows
    from coda_tpu_torch.telemetry import lint_prometheus
    from coda_tpu_torch.telemetry.trace import TRACE_HEADER, mint

    t0 = time.perf_counter()
    procs, urls = [], {}
    router = srv = None
    try:
        # both replicas build the kernels into one empty directory at once
        # (a per-process temporary file, then os.replace)
        for rid in ("h0", "h1"):
            port = _free_port()
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "coda_tpu_torch.cli", "serve",
                 "--task", "digits_h80", "--data-dir",
                 os.path.join(HERE, "data"), "--port", str(port),
                 "--capacity", str(FLEET_HTTP_CAPACITY),
                 "--record-dir", os.path.join(tmp, "http", rid),
                 "--compilation-cache-dir", os.path.join(tmp, "build"),
                 *FLEET_CLI_EXTRA],
                cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
            urls[rid] = port
        for p, (rid, port) in zip(procs, urls.items()):
            _ready(p, port)
            h = _j(port, "GET", "/healthz")
            if h["status"] != "ok":
                raise AssertionError(f"HTTP replica {rid}: {h}")
        out["http_start_s"] = time.perf_counter() - t0
        router = SessionRouter({rid: HttpReplica(
            rid, f"http://127.0.0.1:{port}") for rid, port in urls.items()})
        srv = make_server(router, 0)
        _th.Thread(target=srv.serve_forever, daemon=True).start()
        srv._started.wait(30)
        rport = srv.server_address[1]
        base = f"http://127.0.0.1:{rport}"
        h80 = Dataset.from_file(find_task_file(os.path.join(HERE, "data"),
                                               "digits_h80"),
                                name="digits_h80", device="cpu")
        labels = h80.labels.numpy()
        ctx = mint()

        def traced(method, path, body):
            import urllib.request

            rq = urllib.request.Request(
                base + path, data=json.dumps(body).encode(), method=method,
                headers={TRACE_HEADER: ctx.header()})
            with urllib.request.urlopen(rq, timeout=300) as resp:
                return json.loads(resp.read())

        o = traced("POST", "/session", {"seed": 7})
        sid = o["session"]
        for _ in range(3):
            o = traced("POST", f"/session/{sid}/label",
                       {"label": int(labels[o["idx"]])})
        src = router._locate(sid)
        dst = next(x for x in urls if x != src)
        t1 = time.perf_counter()
        info = router.migrate_session(sid, src, dst)
        out["http_migrate_ms"] = (time.perf_counter() - t1) * 1e3
        if info.get("migrated") != sid or info["via"] != "snapshot" or \
                router.replicas[src].has_session(sid):
            raise AssertionError(f"HTTP migration: {info}")
        for _ in range(3):
            o = traced("POST", f"/session/{sid}/label",
                       {"label": int(labels[o["idx"]])})
        rows = data_rows(_j(rport, "GET", f"/session/{sid}/trace")["rounds"])
        app = ServeApp(capacity=FLEET_HTTP_CAPACITY, device=dev,
                       quality=False,
                       spec=SelectorSpec.create(
                           "coda", n_parallel=FLEET_HTTP_CAPACITY))
        app.add_task("digits_h80", h80.preds.to(dev))
        app.start(warm=False)
        try:
            c = app.open_session(seed=7)
            for _ in range(6):
                c = app.label(c["session"], int(labels[c["idx"]]))
            _same_rows(rows, data_rows(app.recorder.history(c["session"])),
                       "HTTP fleet against one app")
        finally:
            app.drain(timeout=30)
        trace_out = os.path.join(tmp, "trace.json")
        if cli.main(["trace", ctx.trace_id, "--url", base, "--out",
                     trace_out]) != 0:
            raise AssertionError("cli trace")
        with open(trace_out) as f:
            lanes = set(json.load(f)["processes"])
        if not {"router", src, dst} <= lanes:
            raise AssertionError(f"cli trace lanes: {lanes}")
        if cli.main(["quality", "--url", base]) != 0:
            raise AssertionError("cli quality")
        code, text = _http(rport, "GET", "/metrics")
        problems = lint_prometheus(text)
        if code != 200 or problems or 'replica="h0"' not in text:
            raise AssertionError(f"router /metrics: {code} {problems[:3]}")
        _j(rport, "DELETE", f"/session/{sid}")
        out["http_s"] = time.perf_counter() - t0
        log(f"fleet HTTP: 2 `cli serve` replicas on digits_h80, racing "
            f"to build the kernels into one empty directory, up in "
            f"{out['http_start_s']:.1f} s; a migration over HTTP (hold, "
            f"export, import, fence) in {out['http_migrate_ms']:.1f} ms, the "
            f"rows bitwise one app's; cli trace with lanes {sorted(lanes)}; "
            f"cli quality 0; /metrics lint-clean; {out['http_s']:.1f} s")
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if router is not None:
            router.drain()
        for p in procs:
            _stop(p)


def phase_fleet(dev, task, total: dict, smi: str) -> dict:
    """The serve fleet (see the module docstring, item 13). Returns the
    measured figures."""
    import shutil
    import tempfile

    import torch

    def want_serve(k):   # warm-up, runs of slots, lone slots
        return all(k[n] > 0 for n in ("eig_score", "eig_refresh_score",
                                      "row_gather",
                                      "eig_refresh_score_batched",
                                      "row_gather_batched"))

    def free():
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    t_phase = time.perf_counter()
    out: dict = {"card": smi}
    labels = task.labels.cpu().numpy()
    tmp = tempfile.mkdtemp(prefix="fleet_")
    try:
        free()
        runs = _counted("fleet headline", want_serve, total,
                        lambda: _fleet_headline(dev, task, labels, tmp, out))
        free()
        _counted("fleet verify", lambda k: k["eig_refresh_score"] > 0,
                 total, lambda: _fleet_verify(dev, task, labels, tmp, runs,
                                              out))
        free()
        _counted("fleet scaling", want_serve, total,
                 lambda: _fleet_scaling(dev, task, labels, tmp, runs, out))
        free()
        _counted("fleet chaos", want_serve, total,
                 lambda: _fleet_chaos(dev, out))
        free()
        _fleet_http(dev, tmp, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"fleet phase: {out['phase_s']:.1f} s")
    return out


MESH_D = 2                            # ranks of phase 14 (gloo, one card)
MESH_ROUNDS = {"main": 20, "batch": 5, "paper": 3, "baselines": 10,
               "suite": 10, "ckpt_cut": 10, "viz": 10,
               # CODA's knobs: sparse:32 on the imagenet_sparse pool, the
               # amortized P(best), the prefilter and q = 4 at the headline
               "sparse": 20, "amort": 10, "prefilter": 10, "q4": 10,
               # the surrogate scorer (past its 10 warmup rounds) and the
               # noisy crowd, one seed and a 5-seed batch
               "surr": 20, "crowd": 10, "crowd_batch": 5}
# digits_h80 (80, 899, 10) cut to its first 898 items: N must split over
# data=2 for the --debug-viz run at data=2,model=2
VIZ_TASK, VIZ_N = "digits_h80_n898", 898
MESH_SUITE_TASKS = "pyfiles,iris"     # N = 500 shards; N = 105 falls back
MESH_TIMEOUT_S = 420
MESH_REGRET_TOL = 1e-7
MESH_PREFILTER_N = 4096     # the prefilter job's subset
# the knobs' recorded jobs of each mesh phase (the pool's last: a run of
# jobs on one task reads it once, scripts/torch_mesh_run.loaded_once)
MESH_KNOBS = ("prefilter_rec", "q4_rec", "surr_rec", "crowd_rec",
              "sparse_rec")                                  # data=2
MODEL_KNOBS = ("amort_rec", "q4_rec", "surr_rec", "crowd_rec",
               "crowd_batch_rec", "sparse_rec")              # model=2
# the model=2 records `cli replay` re-executes on the ranks
MODEL_REPLAYS = ("main_rec", "batch_rec", "sparse_rec")
# a knob job's launches on a rank, from its rounds and its own result
# (kernels 1-3 as the one-seed run; no kernel on the prefilter's factored
# tier; kernel 1 once a round and kernel 3 once an answer at q = 4; under
# the surrogate kernel 1 at init and on each round that did not take the
# hybrid vector, no kernel 2; kernels 4, 5 and the batched 3 for the
# crowd's seed batch)
_KNOB_WANTS = {
    "sparse_rec": lambda it, r: {"eig_score": 1,
                                 "eig_refresh_score": it["sparse"],
                                 "row_gather": it["sparse"]},
    "amort_rec": lambda it, r: {"eig_score": 1,
                                "eig_refresh_score": it["amort"],
                                "row_gather": it["amort"]},
    "prefilter_rec": lambda it, r: {},
    "q4_rec": lambda it, r: {"eig_score": 1 + it["q4"],
                             "row_gather": 4 * it["q4"]},
    "surr_rec": lambda it, r: {"eig_score": 1 + it["surr"]
                               - sum(r["hybrid"]),
                               "row_gather": it["surr"]},
    "crowd_rec": lambda it, r: {"eig_score": 1,
                                "eig_refresh_score": it["crowd"],
                                "row_gather": it["crowd"]},
    "crowd_batch_rec": lambda it, r: {
        "eig_score_batched": 1,
        "eig_refresh_score_batched": it["crowd_batch"],
        "row_gather_batched": it["crowd_batch"]}}


def _mesh_driver():
    """``scripts/torch_mesh_run.py`` as a module (the ranks' program; this
    process runs its jobs unsharded as the yardstick)."""
    import importlib.util

    path = os.path.join(HERE, "scripts", "torch_mesh_run.py")
    spec = importlib.util.spec_from_file_location("torch_mesh_run", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, path


def _mesh_hold(job: str, rank: int, got: dict, arr, one_arr,
               block: Optional[int] = None, scaled: bool = False) -> tuple:
    """A rank's run of ``job`` against the unsharded run, seed by seed:
    the same chosen items and best models and regret within 1e-7, and
    each round's scores of the rank's block (its N block ``block``,
    default its rank) within 2.34e-4 of the unsharded scores' slice (the
    same items finite) — up to a seed's first differing pick, which must
    be a ``tie-break-flip``: the mesh's item within 2.34e-4 of the
    unsharded round's best score (the trajectories part there, as the
    replay triage's rule has it). A rank's run of fewer rounds is held
    to the unsharded run's first rounds. ``scaled``: the 2.34e-4 is
    relative to the job's largest unsharded score where that exceeds 1
    (a baseline's acquisition weights: sums over the models, which a
    model axis adds in another order). Returns ``(largest score
    difference, [(seed, round, gap), ...])``."""
    import numpy as np

    what = f"mesh {job} rank {rank}"
    if got["rc"] != 0:
        raise AssertionError(f"{what}: exit {got['rc']}")
    block = rank if block is None else block
    T = arr[f"{job}/chosen_idx"].shape[1]
    one_arr = {k: one_arr[k][:T] if k == "scores" else one_arr[k][:, :T]
               for k in ("chosen_idx", "best_model", "regret", "scores")}
    idx, idx1 = arr[f"{job}/chosen_idx"], one_arr["chosen_idx"]
    s, s1 = arr[f"{job}/scores"], one_arr["scores"]
    if s.ndim == 2:                      # one seed: (T, n) -> (T, 1, n)
        s, s1 = s[:, None], s1[:, None]
    n = s.shape[-1]
    fin1 = np.isfinite(s1)
    scale = max(1.0, float(np.abs(s1[fin1]).max())) \
        if scaled and fin1.any() else 1.0
    contract = CONTRACT * scale
    worst, flips = 0.0, []
    for seed in range(idx.shape[0]):
        diff = np.flatnonzero(idx[seed] != idx1[seed])
        t_end = int(diff[0]) if diff.size else idx.shape[1]
        if diff.size:
            t = t_end
            row = s1[t, seed]
            gap = float(row[np.isfinite(row)].max() - row[idx[seed, t]])
            if not gap <= contract:
                raise AssertionError(
                    f"{what}: seed {seed} picks {idx[seed, t]} at round {t}"
                    f", the unsharded run {idx1[seed, t]}, {gap} below the "
                    f"round's best (contract {contract})")
            flips.append((seed, t, gap))
        keep = slice(0, t_end)
        for k in ("best_model", "regret"):
            a, b = arr[f"{job}/{k}"][seed, keep], one_arr[k][seed, keep]
            if k == "best_model" and not np.array_equal(a, b):
                raise AssertionError(f"{what}: seed {seed} best models "
                                     f"{a.tolist()} vs {b.tolist()}")
            if k == "regret" and a.size and float(
                    np.abs(a - b).max()) > MESH_REGRET_TOL:
                raise AssertionError(f"{what}: seed {seed} regret differs "
                                     f"by {float(np.abs(a - b).max())}")
        got_s = s[:t_end + 1, seed]
        ref = s1[:t_end + 1, seed, block * n:(block + 1) * n]
        fin = np.isfinite(ref)
        if not np.array_equal(fin, np.isfinite(got_s)):
            raise AssertionError(f"{what}: the candidate sets differ")
        if fin.any():
            worst = max(worst, float(np.abs(got_s[fin] - ref[fin]).max()))
    if worst > contract:
        raise AssertionError(f"{what}: scores differ by {worst} > "
                             f"{contract}")
    return worst / scale, flips


def _mesh_ranks(script: str, tmp: str, task_name: str, dev, n: int,
                extra: list, out_dir: str, timeout_s: float) -> tuple:
    """``scripts/torch_mesh_run.py`` on ``n`` ranks under ``python -m
    torch.distributed.run`` (a subprocess in its own session, killed at
    ``timeout_s``): ``(each rank's JSON, each rank's arrays)``."""
    import signal

    import numpy as np

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), script, "--data-dir", tmp,
           "--task", task_name, "--out", out_dir,
           "--device", dev.type] + extra
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        log(text[-4000:])
        raise AssertionError(f"mesh ranks did not finish in {timeout_s} s")
    if proc.returncode != 0:
        log(text[-6000:])
        raise AssertionError(f"mesh ranks exited {proc.returncode}")
    for line in text.splitlines():
        if line.startswith(("mesh ", "  ", "[data]")):
            log(f"  | {line}")
    ranks, arrs = [], []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        arrs.append(np.load(os.path.join(out_dir, f"rank{r}.npz")))
    return ranks, arrs


def _rounds_arg(rounds: dict) -> list:
    return ["--rounds", ",".join(f"{k}={v}" for k, v in rounds.items())]


def _yard(one: dict, job: str) -> dict:
    """The unsharded yardstick's run of ``job`` (recorded or not: the
    recorder changes no decision)."""
    for name in (job, job + "_rec", job.removesuffix("_rec")):
        if name in one:
            return one[name]
    raise KeyError(job)


def _viz_task_file(tmp: str) -> None:
    """:data:`VIZ_TASK` as ``.npy`` files under ``tmp``."""
    import numpy as np

    with np.load(os.path.join(HERE, "data", "digits_h80.npz")) as z:
        np.save(os.path.join(tmp, f"{VIZ_TASK}.npy"),
                np.ascontiguousarray(z["preds"][:, :VIZ_N]))
        np.save(os.path.join(tmp, f"{VIZ_TASK}_labels.npy"),
                np.ascontiguousarray(z["labels"][:VIZ_N]))


MESH_CKPT_EVERY = 5          # scripts/torch_mesh_run.py's ckpt jobs


def _ckpt_ops(rounds: dict) -> dict:
    """Phase 14's checkpointed run: the cut run's saves (every 5 rounds,
    the last chunk unsaved), the resumed run's restore of the newest and
    its saves up to ``main``'s rounds (20 rounds cut after 10: save 5;
    restore 5, save 10 and 15)."""
    cut, full = rounds["ckpt_cut"], rounds["main"]
    saves = list(range(MESH_CKPT_EVERY, cut, MESH_CKPT_EVERY))
    return {"ckpt_cut": [("save", t) for t in saves],
            "ckpt": [("restore", saves[-1])] + [
                ("save", t) for t in range(saves[-1] + MESH_CKPT_EVERY,
                                           full, MESH_CKPT_EVERY)]}
_RESULT_FIELDS = ("chosen_idx", "true_class", "best_model", "regret",
                  "cumulative_regret", "select_prob")


def _hold_checkpoint(ranks, arrs, smi: str) -> dict:
    """Phase 14's checkpointed run on each rank: the cut run's save, the
    resumed run's restore and saves, and every result array of the
    resumed run bitwise the uninterrupted ``main`` run's; returns each
    rank's bytes and seconds."""
    import numpy as np

    out = []
    for r, (k, a) in enumerate(zip(ranks, arrs)):
        want = _ckpt_ops(MESH_ROUNDS)
        ops = {job: [(x["op"], x["round"]) for x in
                     k["jobs"][job]["checkpoint"]] for job in want}
        if ops != want:
            raise AssertionError(f"mesh checkpoint rank {r}: {ops}")
        for f in _RESULT_FIELDS:
            if not np.array_equal(a[f"ckpt/{f}"], a[f"main/{f}"]):
                raise AssertionError(f"mesh checkpoint rank {r}: the "
                                     f"resumed {f} is not the uninterrupted "
                                     "run's")
        ck = k["jobs"]["ckpt_cut"]["checkpoint"] + \
            k["jobs"]["ckpt"]["checkpoint"]
        rec = {"bytes": ck[0]["bytes"],
               "save_s": [x["seconds"] for x in ck if x["op"] == "save"],
               "restore_s": [x["seconds"] for x in ck
                             if x["op"] == "restore"],
               "peak_gb": k["jobs"]["ckpt"]["peak_gb"]}
        out.append(rec)
        log(f"mesh checkpoint rank {r}: cut after round "
            f"{MESH_ROUNDS['ckpt_cut']} and resumed to "
            f"{MESH_ROUNDS['main']}, every result bitwise the uninterrupted "
            "run; a checkpoint "
            f"{rec['bytes']} bytes, save "
            + ", ".join(f"{x:.3f}" for x in rec["save_s"])
            + f" s, restore {rec['restore_s'][0]:.3f} s; peak "
            f"{rec['peak_gb']:.3f} GB ({smi})")
    return out


def _hold_against(rec: str, yard: str, out: str, what: str) -> list:
    """A mesh record held ``--against`` the unsharded yardstick's record
    of the same rounds (``cli replay --against``, one process: the mesh
    knob differs, so the contract is 2.34e-4): parity, or a first
    divergence that is a near tie (:func:`_triage`'s rule, the q-wide
    first-pick near tie included)."""
    from coda_tpu_torch.engine.replay import replay_main
    from coda_tpu_torch.telemetry.recorder import RunRecord

    with contextlib.redirect_stdout(io.StringIO()):
        rc = replay_main([rec, "--against", yard, "--out", out])
    with open(out) as f:
        rep = json.load(f)
    if rep["score_tol"] != CONTRACT or rc != (0 if rep["parity"] else 2):
        raise AssertionError(f"{what}: exit {rc}, tol {rep['score_tol']}")
    return _triage(RunRecord.load(rec), RunRecord.load(yard), what,
                   CONTRACT)


def _hold_prints(what: str, b: int, jr: list) -> None:
    """The fingerprints of a job's ranks (``b`` a model group): of the
    state a model group holds alike, equal across each model group; of
    the state a data group holds alike, across each data group."""
    for key, group in (("fingerprint_model", lambda r: r // b),
                       ("fingerprint", lambda r: r % b)):
        prints: dict = {}
        for r, x in enumerate(jr):
            prints.setdefault(group(r), set()).add(x[key])
        if any(len(v) != 1 for v in prints.values()):
            raise AssertionError(f"{what}: {key} differs within a group: "
                                 f"{prints}")


def _hold_knobs(spec: str, b: int, jobs, ranks, arrs, one: dict, tmp: str,
                out_dir: str, smi: str, total: dict, rounds: dict,
                cuda: bool) -> dict:
    """The knobs' recorded jobs on a mesh (``b`` ranks a model group):
    each rank's decisions and its block's scores as :func:`_mesh_hold`
    holds them (the one-label jobs), every rank of a q-wide run the same
    picks; the fingerprints equal within each group; on the card each
    rank's launches as :data:`_KNOB_WANTS` (added to ``total``); the
    amortized gate's verdicts on every rank the unsharded run's; the
    surrogate's hybrid rounds and final fit the same on every rank; the
    crowd's applied labels and weights bitwise the unsharded run's up to a
    seed's first differing pick; rank 0's record held ``--against`` the
    yardstick's. Prints ms a round (a label at q = 4) and peak memory a
    rank beside the unsharded run's, and the surrogate's hybrid-round
    share a rank beside the unsharded run's."""
    import numpy as np

    n = len(ranks)
    out = {}
    for job in jobs:
        what = f"mesh {spec} {job}"
        jr = [r["jobs"][job] for r in ranks]
        yard = _yard(one, job)
        gaps = [0.0]
        if job == "q4_rec":
            for r in range(n):
                if jr[r]["rc"] != 0 or not np.array_equal(
                        arrs[r][f"{job}/chosen_idx"],
                        arrs[0][f"{job}/chosen_idx"]):
                    raise AssertionError(f"{what}: rank {r} picks differ")
        else:
            for r in range(n):
                gap, flips = _mesh_hold(job, r, jr[r], arrs[r],
                                        yard["arrays"], block=r // b)
                gaps.append(gap)
                if flips:
                    log(f"{what} rank {r}: tie-break-flips (seed, round, "
                        f"gap): {flips}")
                if job.startswith("crowd"):
                    _hold_crowd(what, r, arrs[r], yard["arrays"], job,
                                flips)
        _hold_prints(what, b, jr)
        if job == "sparse_rec" and cuda and any(
                x["peak_gb"] > yard["peak_gb"] for x in jr):
            raise AssertionError(f"{what}: a rank's peak "
                                 f"{[x['peak_gb'] for x in jr]} GB above the "
                                 f"unsharded run's {yard['peak_gb']}")
        hybrid = ""
        if "hybrid" in yard:
            if any(x["hybrid"] != jr[0]["hybrid"]
                   or x["fit_digest"] != jr[0]["fit_digest"] for x in jr):
                raise AssertionError(f"{what}: the hybrid rounds or the fit "
                                     "differ between ranks")
            hybrid = (f"; hybrid rounds {sum(yard['hybrid'])}/"
                      f"{len(yard['hybrid'])} unsharded, "
                      + ", ".join(f"{sum(x['hybrid'])}/{len(x['hybrid'])}"
                                  for x in jr)
                      + " ranks (the fit bitwise equal on every rank)")
        if "gates" in yard or any("gates" in x for x in jr):
            if any(x.get("gates") != yard.get("gates") for x in jr):
                raise AssertionError(
                    f"{what}: gate verdicts {[x.get('gates') for x in jr]}"
                    f" against the unsharded {yard.get('gates')}")
        if cuda:
            for r in range(n):
                want = _KNOB_WANTS[job](rounds, jr[r])
                if jr[r]["launches"] != want:
                    raise AssertionError(f"{what} rank {r} launches "
                                         f"{jr[r]['launches']}, want {want}")
                _tally(total, jr[r]["launches"],
                       jr[r].get("split_launches", {}))
        lines = _hold_against(os.path.join(out_dir, "records", job),
                              os.path.join(tmp, "one", job),
                              os.path.join(out_dir, f"against_{job}.json"),
                              f"{what} against unsharded")
        per = "ms_per_label" if job == "q4_rec" else "ms_per_round"
        out[job] = {"one": {k: yard[k] for k in (per, "init_ms",
                                                 "peak_gb")},
                    "ranks": [{k: x[k] for k in (per, "init_ms", "peak_gb",
                                                 "bytes_per_round")}
                              for x in jr],
                    "max_score_gap": max(gaps), "against": lines,
                    "gates": yard.get("gates"),
                    "hybrid": {"one": yard.get("hybrid"),
                               "ranks": [x.get("hybrid") for x in jr]}}
        engaged = (f"; gate engaged in {sum(yard['gates'])}/"
                   f"{len(yard['gates'])} rounds on every rank as unsharded"
                   if yard.get("gates") else "")
        log(f"{what}: {per.replace('_per_', '/')} {yard[per]:.3f} "
            "unsharded, " + ", ".join(f"{x[per]:.3f}" for x in jr)
            + f" ranks; init ms {yard['init_ms']:.1f} unsharded, "
            + ", ".join(f"{x['init_ms']:.1f}" for x in jr)
            + f"; peak GB {yard['peak_gb']:.3f} unsharded, "
            + ", ".join(f"{x['peak_gb']:.3f}" for x in jr)
            + f"; launches a rank {jr[0]['launches']}; max score gap "
            f"{max(gaps):.3e}{engaged}{hybrid}; against unsharded: "
            + "; ".join(lines) + f" ({smi})")
    return out


def _hold_crowd(what: str, rank: int, arr, one_arr, job: str,
                flips: list) -> None:
    """A crowd job's applied labels and weights on a rank: bitwise the
    unsharded run's, each seed up to its first differing pick (the votes
    depend on the picked item's label alone)."""
    import numpy as np

    first = {seed: t for seed, t, _ in flips}
    for f in ("applied_label", "label_weight"):
        a, b = arr[f"{job}/{f}"], one_arr[f]
        for seed in range(a.shape[0]):
            t = first.get(seed, a.shape[1])
            if a[seed, :t].tobytes() != b[seed, :t].tobytes():
                raise AssertionError(f"{what} rank {rank}: seed {seed}'s "
                                     f"{f} is not the unsharded run's")


def phase_mesh(dev, task, total: dict, smi: str,
               keep: Optional[dict] = None) -> dict:
    """The N-axis mesh (see the module docstring, item 14). Returns the
    measured figures. ``keep``: a dict that takes the task files'
    directory (``tmp``, left in place) and the unsharded yardstick
    (``one``) for phase 15."""
    import shutil
    import tempfile

    import torch

    from coda_tpu_torch.data import make_synthetic_task

    t_phase = time.perf_counter()
    drv, script = _mesh_driver()
    held = ("main", "batch", "paper") + BASELINES
    jobs = held + ("suite", "ckpt_cut", "ckpt", "prior_chunks") + MESH_KNOBS
    # the yardstick's CODA runs recorded (phase 15's --against side), and
    # --debug-viz's unsharded P(best); every knob's run recorded (the
    # --against side of both phases)
    yard = (("main_rec", "batch_rec", "paper") + BASELINES + ("suite",)
            + ("prefilter_rec", "q4_rec", "amort_rec", "surr_rec",
               "crowd_rec", "crowd_batch_rec", "sparse_rec", "viz"))
    tmp = tempfile.mkdtemp(prefix="mesh_")
    out: dict = {"card": smi}
    cuda = dev.type == "cuda"

    def free():
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    try:
        _task_files(task, tmp)
        _viz_task_file(tmp)
        Hs, Ns, Cs = SPARSE_POOL
        pool = make_synthetic_task(seed=5, H=Hs, N=Ns, C=Cs, device=dev)
        _task_files(pool, tmp)
        pool_task = pool.name           # the sparse job's task files
        del pool
        free()
        t0 = time.perf_counter()
        one = drv.run_jobs(yard, tmp, task.name, MESH_ROUNDS, dev, None,
                           os.path.join(HERE, "data"), MESH_SUITE_TASKS,
                           os.path.join(tmp, "one.sqlite"), log=log,
                           root=os.path.join(tmp, "one"), viz_task=VIZ_TASK,
                           pool_task=pool_task, prefilter_n=MESH_PREFILTER_N,
                           crowd_spec=CROWD_SPEC)
        out["unsharded_s"] = time.perf_counter() - t0
        one_rows = drv.suite_rows(os.path.join(tmp, "one.sqlite"))
        free()
        t0 = time.perf_counter()
        ranks, arrs = _mesh_ranks(
            script, tmp, task.name, dev, MESH_D,
            _rounds_arg(MESH_ROUNDS) + ["--suite-tasks", MESH_SUITE_TASKS,
                                        "--jobs", ",".join(jobs),
                                        "--pool-task", pool_task,
                                        "--prefilter-n",
                                        str(MESH_PREFILTER_N),
                                        "--crowd-spec", CROWD_SPEC],
            os.path.join(tmp, "ranks"), MESH_TIMEOUT_S)
        out["ranks_s"] = time.perf_counter() - t0
        gaps, flips = {}, {}
        for job in held:
            for r in range(MESH_D):
                gaps[(job, r)], flips[(job, r)] = _mesh_hold(
                    job, r, ranks[r]["jobs"][job], arrs[r],
                    _yard(one, job)["arrays"])
            if flips[(job, 0)]:
                log(f"mesh {job}: tie-break-flips (seed, round, gap to the "
                    f"round's best): {flips[(job, 0)]}")
            _hold_prints(f"mesh {job}", 1,
                         [ranks[r]["jobs"][job] for r in range(MESH_D)])
        if cuda:
            it = MESH_ROUNDS["main"], MESH_ROUNDS["batch"]
            for r in range(MESH_D):
                k = ranks[r]["jobs"]
                want = ({"eig_score": 1, "eig_refresh_score": it[0],
                         "row_gather": it[0]},
                        {"eig_score_batched": 1,
                         "eig_refresh_score_batched": it[1],
                         "row_gather_batched": it[1]})
                if (k["main"]["launches"], k["batch"]["launches"]) != want:
                    raise AssertionError(
                        f"mesh rank {r} launches: main "
                        f"{k['main']['launches']}, batch "
                        f"{k['batch']['launches']}")
                # the resumed run starts at the cut run's last save
                it_ck = MESH_ROUNDS["ckpt_cut"]
                start = _ckpt_ops(MESH_ROUNDS)["ckpt"][0][1]
                ck_want = {"ckpt_cut": {"eig_score": 1,
                                        "eig_refresh_score": it_ck,
                                        "row_gather": it_ck},
                           "ckpt": {"eig_refresh_score": it[0] - start,
                                    "row_gather": it[0] - start}}
                if {j: k[j]["launches"] for j in ck_want} != ck_want:
                    raise AssertionError(
                        f"mesh rank {r} checkpoint launches: "
                        + str({j: k[j]["launches"] for j in ck_want}))
                for job in ("main", "batch", "ckpt_cut", "ckpt"):
                    _tally(total, k[job]["launches"],
                           k[job].get("split_launches", {}))
            log("mesh launches by rank (main, batch, ckpt_cut, ckpt): "
                + "; ".join(f"rank {r} " + " ".join(
                    str(ranks[r]["jobs"][j]["launches"]) for j in
                    ("main", "batch", "ckpt_cut", "ckpt"))
                    for r in range(MESH_D)))
        out["checkpoint"] = _hold_checkpoint(ranks, arrs, smi)
        if not all(ranks[r]["jobs"]["prior_chunks"]["bitwise"]
                   for r in range(MESH_D)):
            raise AssertionError("mesh: the confusion prior summed over the "
                                 "data group a model at a time is not the "
                                 "whole sum")
        log("mesh prior_chunks: the confusion prior's data-group sum a "
            "model at a time bitwise the whole sum on every rank")
        out["knobs"] = _hold_knobs("data=2", 1, MESH_KNOBS, ranks, arrs,
                                   one, tmp, os.path.join(tmp, "ranks"),
                                   smi, total, MESH_ROUNDS, cuda)
        rows = ranks[0].get("suite_rows") or []
        if [x[:3] for x in rows] != [list(x[:3]) for x in one_rows] or any(
                abs(a[3] - b[3]) > MESH_REGRET_TOL
                for a, b in zip(rows, one_rows)):
            raise AssertionError("mesh suite: rank 0's rows differ from the "
                                 "unsharded suite's")
        if '"mesh": "data=2"' not in ranks[0]["jobs"]["suite"]["stdout"]:
            raise AssertionError("mesh suite: no result line on rank 0")
        for job in held:
            o = _yard(one, job)
            log(f"mesh {job}: ms/round {o['ms_per_round']:.3f} unsharded, "
                + ", ".join(f"{ranks[r]['jobs'][job]['ms_per_round']:.3f}"
                            for r in range(MESH_D))
                + f" ranks; init ms {o['init_ms']:.1f} unsharded, "
                + ", ".join(f"{ranks[r]['jobs'][job]['init_ms']:.1f}"
                            for r in range(MESH_D))
                + f"; peak GB {o['peak_gb']:.3f} unsharded, "
                + ", ".join(f"{ranks[r]['jobs'][job]['peak_gb']:.3f}"
                            for r in range(MESH_D))
                + "; max score gap "
                + f"{max(gaps[(job, r)] for r in range(MESH_D)):.3e}")
        out.update(
            suite_rows=len(rows),
            jobs={job: {"one": {k: _yard(one, job)[k] for k in
                                ("ms_per_round", "init_ms", "peak_gb")},
                        "ranks": [{k: ranks[r]["jobs"][job][k] for k in
                                   ("ms_per_round", "init_ms", "peak_gb")}
                                  for r in range(MESH_D)]}
                  for job in held})
        if keep is not None:
            keep.update(tmp=tmp, one=one, pool_task=pool_task)
    finally:
        if keep is None or "tmp" not in keep:
            shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"mesh phase: {out['phase_s']:.1f} s (unsharded yardstick "
        f"{out['unsharded_s']:.1f} s, {MESH_D} ranks {out['ranks_s']:.1f} "
        f"s; gloo on one shared card ({smi}): a correctness check, not a "
        "measure of NCCL scaling)")
    return out


# phase 15: the ranks' (C, N/a, H/b) blocks of the headline cache at
# model=2, model=4 and data=2,model=2, of the imagenet_sparse pool's cache
# unsharded and at model=2, DomainNet126's 126 classes at a small domain's
# 2048 items, and the headline's widths at 8192 items, where kernels 1 and
# 2 are timed on both of their decompositions
MODEL_BLOCKS = ((10, 50_000, 500), (10, 50_000, 250), (10, 25_000, 500),
                (1000, 256, 500), (1000, 256, 250), (126, 2048, 500),
                (10, 8192, 1000))
# the class chunks a block runs where the rule keeps the single launch, so
# the split is held bitwise there too (a last chunk shorter than the rest)
FORCED_CHUNKS = 3
# kernels 4 and 5 at SEEDS replicas of a block: the pool's (the rule
# splits) and DomainNet126's at N = 2048 (it keeps one launch)
BATCHED_BLOCKS = ((1000, 256, 500), (126, 2048, 500))
# kernel 6 at a short item axis: the pool's block (the rules split both of
# its launches) and DomainNet126's classes at N = 2048; beside the rules'
# class chunks, two forced counts (a short last chunk; 64 classes a chunk)
K6_BLOCKS = ((1000, 256, 500), (126, 2048, 500))
K6_FORCED_CHUNKS = (FORCED_CHUNKS, 64)
# (spec, ranks, jobs, rounds): phase 14's rounds, so its unsharded runs
# are the yardstick (the 4-rank run holds the first 10 of its 20 rounds)
MODEL_RUNS = (("model=2", 2, ("main", "main_rec", "batch", "batch_rec")
               + MODEL_KNOBS + ("replay", "paper") + BASELINES,
               {k: v for k, v in MESH_ROUNDS.items() if k != "suite"}),
              ("data=2,model=2", 4, ("main", "viz"),
               {"main": 10, "viz": MESH_ROUNDS["viz"]}))
MODEL_TIMEOUT_S = 300
# kernels 1-3 a one-seed run, 4, 5 and batched 3 a batch, of `rounds`
_MODEL_WANTS = {
    "main": lambda it: {"eig_score": 1, "eig_refresh_score": it["main"],
                        "row_gather": it["main"]},
    "batch": lambda it: {"eig_score_batched": 1,
                         "eig_refresh_score_batched": it["batch"],
                         "row_gather_batched": it["batch"]}}


def _block_paths(dev, peaks) -> list:
    """Kernels 1 and 2 at each block of :data:`MODEL_BLOCKS` in the four
    flavours, on the single launch (``class_chunks=1``) and split over
    class chunks (the rule's count, or :data:`FORCED_CHUNKS` where the rule
    keeps one launch): the two paths' scores and kernel 2's refreshed
    caches ``torch.equal``, each path held to the plain versions, each
    timed (CUDA events) beside its bound, with the load path each takes
    (16-byte vectors or scalar)."""
    import torch

    from coda_tpu_torch.ops import eig_kernels as ek

    gen = torch.Generator(device=dev).manual_seed(15)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for C, n, h in MODEL_BLOCKS:
        rows, hyp32, pi, pi_xi, hyp_t = random_cache(gen, C, n, h, dev)
        c = torch.tensor(3, device=dev)
        for dtype, approx in FLAVOURS:
            tdt = getattr(torch, dtype)
            hyp = hyp32.to(tdt)
            rule = ek.choose_class_chunks(C, n, h, approx, sms)
            split = rule if rule > 1 else FORCED_CHUNKS
            want1 = ek.eig_scores_from_cache(rows, hyp, pi, pi_xi,
                                             approx=approx)
            want2, _ = ek.eig_scores_refresh_plain(rows, hyp.clone(), hyp_t,
                                                   c, pi, pi_xi,
                                                   approx=approx)
            tol = SCORE_RTOL * float(want1.abs().max()) + score_atol(h)
            what = (f"block ({C}, {n}, {h}) {dtype}"
                    + (",approx" if approx else ""))
            got, caches = {}, {}
            for k in (1, split):
                caches[k] = hyp.clone()
                got[k] = (ek.eig_scores_cache(rows, hyp, pi, pi_xi,
                                              approx=approx, class_chunks=k),
                          ek.eig_scores_refresh(rows, caches[k], hyp_t, c,
                                                pi, pi_xi, approx=approx,
                                                class_chunks=k)[0])
            torch.cuda.synchronize()
            if not (torch.equal(got[1][0], got[split][0])
                    and torch.equal(got[1][1], got[split][1])
                    and torch.equal(caches[1], caches[split])):
                raise AssertionError(f"{what}: {split} class chunks are not "
                                     "bitwise the single launch")
            err = max(float((got[1][0] - want1).abs().max()),
                      float((got[1][1] - want2).abs().max()))
            if not err <= tol:
                raise AssertionError(f"{what}: kernels 1/2 differ from the "
                                     f"plain versions by {err} > {tol}")
            width = ek._vec(h, hyp, rows)
            rec = {"C": C, "N": n, "H": h, "dtype": dtype, "approx": approx,
                   "path": f"{width}-wide" if width > 1 else "scalar",
                   "rule_chunks": rule, "split_chunks": split,
                   "max_abs_err": err}
            for k, tag in ((1, "one"), (split, "split")):
                rec[f"k1_{tag}_ms"] = time_ms(lambda: ek.eig_scores_cache(
                    rows, hyp, pi, pi_xi, approx=approx, class_chunks=k))
                rec[f"k2_{tag}_ms"] = time_ms(lambda: ek.eig_scores_refresh(
                    rows, caches[k], hyp_t, c, pi, pi_xi, approx=approx,
                    class_chunks=k))
            for k, name in (("k1", "eig_score"),
                            ("k2", "eig_refresh_score")):
                nb, ops, tops = work(name, C, n, h, hyp.element_size())
                rec[k + "_bound_ms"] = bound(nb, ops, peaks, tops)[0]
            out.append(rec)
            log(f"mesh model: {what}: {rec['path']} loads, rule "
                f"{rule} class chunk(s), split path {split} bitwise the "
                f"single launch; kernel 1 {rec['k1_one_ms']:.4f} ms on one "
                f"launch, {rec['k1_split_ms']:.4f} split (bound "
                f"{rec['k1_bound_ms']:.4f}), kernel 2 {rec['k2_one_ms']:.4f} "
                f"/ {rec['k2_split_ms']:.4f} (bound "
                f"{rec['k2_bound_ms']:.4f}); max |kernel - plain| "
                f"{err:.3e} (tol {tol:.3e})")
            del hyp, caches, got
        del rows, hyp32, pi, pi_xi, hyp_t
        torch.cuda.empty_cache()
    return (out + _batched_block_paths(dev, peaks, gen, sms)
            + _k6_block_paths(dev, peaks, gen, sms))


def _k6_block_paths(dev, peaks, gen, sms: int) -> list:
    """Kernel 6 at each block of :data:`K6_BLOCKS` in the four flavours:
    the single path (``class_chunks=1, row_split=False``) held to the plain
    version at the ``K6_*`` tolerances, and every other path (the rules'
    class chunks and :data:`K6_FORCED_CHUNKS`, and one chunk, each with the
    row split on and off) ``torch.equal`` to it: the scores, the stored
    row c and the other rows untouched; an out-of-range class gives NaN
    scores and writes nothing on every path. The single path and the rules'
    are timed (CUDA events, the wrapper call) beside the bound."""
    import torch

    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops.pbest import compute_pbest

    out, c_idx = [], 3
    for C, n, h in K6_BLOCKS:
        rows, hyp32, pi, pi_xi, _ = random_cache(gen, C, n, h, dev)
        # the labelled class's Beta marginals, of random 10-entry
        # Dirichlet rows as at the headline
        d = torch.rand((h, 10), generator=gen, device=dev) * 3 + 0.5
        a_t = d[:, 0].contiguous()
        b_t = (d.sum(-1) - a_t).contiguous()
        rows[c_idx] = compute_pbest(a_t, b_t)
        hard = torch.randint(0, C, (n, h), generator=gen, device=dev,
                             dtype=torch.int32)
        c = torch.tensor(c_idx, dtype=torch.int32, device=dev)
        bad = torch.tensor(C, dtype=torch.int32, device=dev)
        nnz = int((hard == c_idx).sum())
        row_rule = ek.row_plan(C, n, h, 256, sms)[1]
        rows32 = {}
        for dtype, approx in FLAVOURS:
            tdt = getattr(torch, dtype)
            hyp = hyp32.to(tdt)
            rule = ek.choose_class_chunks(C, n, h, approx, sms)
            what = (f"kernel 6 block ({C}, {n}, {h}) {dtype}"
                    + (",approx" if approx else ""))

            def call(k, rs, cache, cls=c):
                return ek.eig_scores_refresh_compute(
                    rows, cache, a_t, b_t, hard, cls, pi, pi_xi,
                    approx=approx, class_chunks=k, row_split=rs)[0]

            hyp_one = hyp.clone()
            one = call(1, False, hyp_one)
            want, hyp_p = ek.eig_scores_refresh_compute_plain(
                rows, hyp.clone(), a_t, b_t, hard, c, pi, pi_xi,
                approx=approx)
            torch.cuda.synchronize()
            atol = K6_ATOL + score_atol(h)
            err = float((one - want).abs().max())
            torch.testing.assert_close(one, want, rtol=K6_RTOL, atol=atol)
            _check_refresh_rows(hyp_one, hyp_p, hyp, c_idx, C)
            row_k, row_p = hyp_one[c_idx], hyp_p[c_idx]
            if dtype == "float32":
                rows32[approx] = (row_k.clone(), row_p.clone())
                torch.testing.assert_close(row_k, row_p, rtol=K6_ROW_RTOL,
                                           atol=K6_ROW_RTOL / h)
            else:
                _bf16_boundary_count(row_k, row_p, *rows32[approx])
            del want, hyp_p, row_k, row_p
            counts = (1, rule, *(min(C, k) for k in K6_FORCED_CHUNKS))
            paths = sorted({(k, rs) for k in counts for rs in (False, True)}
                           - {(1, False)})
            for k, rs in [(1, False)] + paths:
                if (k, rs) != (1, False):
                    hyp_k = hyp.clone()
                    got = call(k, rs, hyp_k)
                    torch.cuda.synchronize()
                    if not (torch.equal(got, one)
                            and torch.equal(hyp_k, hyp_one)):
                        raise AssertionError(
                            f"{what}: {k} class chunk(s), row split {rs}: "
                            "not bitwise the single path")
                    del hyp_k
                hyp_b = hyp.clone()
                got = call(k, rs, hyp_b, bad)
                torch.cuda.synchronize()
                if not (bool(got.isnan().all()) and torch.equal(hyp_b, hyp)):
                    raise AssertionError(
                        f"{what}: {k} class chunk(s), row split {rs}: an "
                        "out-of-range class gave scores or wrote a row")
                del hyp_b
            rec = {"kernel": 6, "C": C, "N": n, "H": h, "dtype": dtype,
                   "approx": approx, "rule_chunks": rule,
                   "rule_row_split": row_rule, "max_abs_err": err,
                   "paths": [[1, False]] + [list(p) for p in paths]}
            for k, rs, tag in ((1, False, "one"), (rule, row_rule, "rule")):
                rec[f"k6_{tag}_ms"] = time_ms(
                    lambda: call(k, rs, hyp_one))
            nb, ops, tops = work("eig_refresh_compute_score", C, n, h,
                                 hyp.element_size(), G=256, nnz=nnz)
            rec["k6_bound_ms"], rec["k6_bound_by"] = bound(nb, ops, peaks,
                                                           tops)
            out.append(rec)
            log(f"mesh model: {what}: rule {rule} class chunk(s), row split "
                f"{'on' if row_rule else 'off'}; {len(paths)} other paths "
                f"(class chunks, row split) {paths} bitwise the single "
                "path, an out-of-range class NaN with no row written on "
                f"each; kernel 6 {rec['k6_one_ms']:.4f} ms on the single "
                f"path, {rec['k6_rule_ms']:.4f} on the rules' (bound "
                f"{rec['k6_bound_ms']:.4f}, {rec['k6_bound_by']}); max "
                f"|kernel - plain| {err:.3e} (tol atol={atol:.2e} "
                f"rtol={K6_RTOL}), the row at the K6 row tolerances")
            del hyp, hyp_one, one
        del rows, hyp32, pi, pi_xi, hard
        torch.cuda.empty_cache()
    return out


def _batched_block_paths(dev, peaks, gen, sms: int) -> list:
    """Kernels 4 and 5 at ``SEEDS`` replicas of each block of
    :data:`BATCHED_BLOCKS` in the four flavours, as :func:`_block_paths`
    holds kernels 1 and 2: the single batched launch and the split (the
    rule's count at S replicas, or :data:`FORCED_CHUNKS`) ``torch.equal``
    to each other and to kernels 1 and 2 launched per replica (scores,
    kernel 5's cache; each replica refreshing its own class), held to the
    plain versions, each path timed beside its bound."""
    import torch

    from coda_tpu_torch.ops import eig_kernels as ek

    S, out = SEEDS, []
    for C, n, h in BATCHED_BLOCKS:
        rows, hyp32, pi, pi_xi, hyp_t = random_cache(gen, C, n, h, dev,
                                                     lead=(S,))
        cls = torch.tensor([(3 * s + 1) % C for s in range(S)],
                           dtype=torch.int32, device=dev)
        for dtype, approx in FLAVOURS:
            tdt = getattr(torch, dtype)
            hyp = hyp32.to(tdt)
            rule = ek.choose_class_chunks(C, n, h, approx, sms, S)
            split = rule if rule > 1 else FORCED_CHUNKS
            what = (f"{S} x block ({C}, {n}, {h}) {dtype}"
                    + (",approx" if approx else ""))
            got, caches = {}, {}
            for k in (1, split):
                caches[k] = hyp.clone()
                got[k] = (ek.eig_scores_cache_batched(
                              rows, hyp, pi, pi_xi, approx=approx,
                              class_chunks=k),
                          ek.eig_scores_refresh_batched(
                              rows, caches[k], hyp_t, cls, pi, pi_xi,
                              approx=approx, class_chunks=k)[0])
            per_cache = hyp.clone()
            per = (torch.stack([ek.eig_scores_cache(
                       rows[s], hyp[s], pi[s], pi_xi[s], approx=approx)
                       for s in range(S)]),
                   torch.stack([ek.eig_scores_refresh(
                       rows[s], per_cache[s], hyp_t[s], cls[s], pi[s],
                       pi_xi[s], approx=approx)[0] for s in range(S)]))
            torch.cuda.synchronize()
            for k, ref, ref_cache, against in (
                    (split, got[1], caches[1], "the single batched launch"),
                    (1, per, per_cache, "kernels 1 and 2 per replica")):
                if not (torch.equal(got[k][0], ref[0])
                        and torch.equal(got[k][1], ref[1])
                        and torch.equal(caches[k], ref_cache)):
                    raise AssertionError(f"{what}: {k} class chunk(s) not "
                                         f"bitwise {against}")
            del per, per_cache
            want1 = ek.eig_scores_from_cache_batched(rows, hyp, pi, pi_xi,
                                                     approx=approx)
            want2, _ = ek.eig_scores_refresh_batched_plain(
                rows, hyp.clone(), hyp_t, cls, pi, pi_xi, approx=approx)
            tol = SCORE_RTOL * float(want1.abs().max()) + score_atol(h)
            err = max(float((got[1][0] - want1).abs().max()),
                      float((got[1][1] - want2).abs().max()))
            del want1, want2
            if not err <= tol:
                raise AssertionError(f"{what}: kernels 4/5 differ from the "
                                     f"plain versions by {err} > {tol}")
            width = ek._vec(h, hyp, rows)
            rec = {"S": S, "C": C, "N": n, "H": h, "dtype": dtype,
                   "approx": approx,
                   "path": f"{width}-wide" if width > 1 else "scalar",
                   "rule_chunks": rule, "split_chunks": split,
                   "max_abs_err": err}
            for k, tag in ((1, "one"), (split, "split")):
                rec[f"k4_{tag}_ms"] = time_ms(
                    lambda: ek.eig_scores_cache_batched(
                        rows, hyp, pi, pi_xi, approx=approx, class_chunks=k))
                rec[f"k5_{tag}_ms"] = time_ms(
                    lambda: ek.eig_scores_refresh_batched(
                        rows, caches[k], hyp_t, cls, pi, pi_xi,
                        approx=approx, class_chunks=k))
            for k, name in (("k4", "eig_score_batched"),
                            ("k5", "eig_refresh_score_batched")):
                nb, ops, tops = work(name, C, n, h, hyp.element_size(), S)
                rec[k + "_bound_ms"] = bound(nb, ops, peaks, tops)[0]
            out.append(rec)
            log(f"mesh model: {what}: {rec['path']} loads, rule "
                f"{rule} class chunk(s), split path {split} bitwise the "
                f"single batched launch and kernels 1/2 per replica; kernel "
                f"4 {rec['k4_one_ms']:.4f} ms on one launch, "
                f"{rec['k4_split_ms']:.4f} split (bound "
                f"{rec['k4_bound_ms']:.4f}), kernel 5 {rec['k5_one_ms']:.4f} "
                f"/ {rec['k5_split_ms']:.4f} (bound "
                f"{rec['k5_bound_ms']:.4f}); max |kernel - plain| "
                f"{err:.3e} (tol {tol:.3e})")
            del hyp, caches, got
        del rows, hyp32, pi, pi_xi, hyp_t, cls
        torch.cuda.empty_cache()
    return out


def _hold_mesh_records(spec: str, n: int, ranks, tmp: str, out_dir: str,
                       smi: str) -> dict:
    """Phase 15's records: the ranks' recorder cost (``main`` against
    ``main_rec``, ``batch`` against ``batch_rec``, ms a round) and the
    records' bytes; each record (rank 0's) re-executed by ``cli replay``
    on the record's ``n`` ranks under ``torchrun`` (the ranks' ``replay``
    job), bitwise: every rank's exit 0, rank 0's report at parity with
    the bitwise contract (the knobs' records of :data:`MODEL_REPLAYS`
    too);
    and ``main_rec`` and ``batch_rec`` held ``--against`` the unsharded
    yardstick's record of the same rounds: parity, or a
    ``tie-break-flip`` within 2.34e-4 (the ``mesh`` knob differs, so the
    contract is 2.34e-4)."""
    from coda_tpu_torch.engine.replay import replay_main
    from coda_tpu_torch.telemetry.recorder import RunRecord

    out: dict = {}
    for job in ("main", "batch"):
        off = [r["jobs"][job]["ms_per_round"] for r in ranks]
        on = [r["jobs"][job + "_rec"]["ms_per_round"] for r in ranks]
        out[job] = {"off_ms": off, "on_ms": on}
        log(f"mesh {spec} recorder, {job}: ms/round a rank with it off "
            + ", ".join(f"{x:.3f}" for x in off) + ", on "
            + ", ".join(f"{x:.3f}" for x in on) + f" ({smi})")
    for job in (j for j in MODEL_REPLAYS if j in MODEL_KNOBS):
        # a knob's record re-executed bitwise on the ranks (held
        # --against the yardstick by _hold_knobs)
        replays = [r["jobs"]["replay"]["records"][job] for r in ranks]
        with open(os.path.join(out_dir, "records",
                               f"replay_{job}.json")) as f:
            rep = json.load(f)
        if [x["rc"] for x in replays] != [0] * n or not rep["parity"] or \
                rep["score_tol"] != 0.0 or rep["meta"].get("mesh") != spec:
            log(replays[0]["stdout"][-4000:])
            raise AssertionError(
                f"mesh {spec} {job} replay: exits "
                f"{[x['rc'] for x in replays]}, parity {rep['parity']}")
        ms = sum(t["rounds_ms"] for t in rep["meta"]["timings"])
        out[job] = {"record_bytes": ranks[0]["jobs"][job]["record_bytes"],
                    "replay_wall_s": max(x["wall_s"] for x in replays),
                    "replay_ms_per_round": ms / rep["meta"]["run"]["iters"]}
        log(f"mesh {spec} {job}: record {out[job]['record_bytes']} bytes; "
            f"cli replay on the {n} ranks bitwise (PARITY, exit 0 on every "
            f"rank) in {out[job]['replay_wall_s']:.1f} s, "
            f"{out[job]['replay_ms_per_round']:.3f} ms a round on rank 0 "
            f"({smi})")
    for job in ("main_rec", "batch_rec"):
        rec = os.path.join(out_dir, "records", job)
        size = ranks[0]["jobs"][job]["record_bytes"]
        replays = [r["jobs"]["replay"]["records"][job] for r in ranks]
        with open(os.path.join(out_dir, "records",
                               f"replay_{job}.json")) as f:
            rep = json.load(f)
        if [x["rc"] for x in replays] != [0] * n or not rep["parity"] or \
                rep["score_tol"] != 0.0 or rep["meta"].get("mesh") != spec:
            log(replays[0]["stdout"][-4000:])
            raise AssertionError(
                f"mesh {spec} {job} replay: exits "
                f"{[x['rc'] for x in replays]}, parity {rep['parity']}, "
                f"tol {rep['score_tol']}")
        wall = max(x["wall_s"] for x in replays)
        ms = sum(t["rounds_ms"] for t in rep["meta"]["timings"])
        against = os.path.join(out_dir, f"against_{job}.json")
        yard = os.path.join(tmp, "one", job)
        with contextlib.redirect_stdout(io.StringIO()):
            rc2 = replay_main([rec, "--against", yard, "--out", against])
        with open(against) as f:
            rep2 = json.load(f)
        if rep2["score_tol"] != CONTRACT or rc2 != (0 if rep2["parity"]
                                                    else 2):
            raise AssertionError(f"mesh {spec} {job} against: exit {rc2}, "
                                 f"tol {rep2['score_tol']}")
        lines = _hold_replay(rep2, RunRecord.load(rec),
                             f"mesh {spec} {job} against unsharded",
                             CONTRACT)
        out[job] = {"record_bytes": size, "replay_wall_s": wall,
                    "replay_ms_per_round": ms / rep["meta"]["run"]["iters"],
                    "against": lines}
        log(f"mesh {spec} {job}: record {size} bytes; cli replay on the "
            f"{n} ranks bitwise (PARITY, exit 0 on every rank) in "
            f"{wall:.1f} s, {out[job]['replay_ms_per_round']:.3f} ms a "
            f"round on rank 0 ({smi})")
    return out


def _hold_viz(ranks, one: dict, spec: str, smi: str) -> dict:
    """Phase 15's ``--debug-viz`` run: rank 0 alone logs the P(best)
    bars, every model's, within 2.34e-4 of the unsharded run's."""
    import numpy as np

    drawn = [r["jobs"]["viz"]["pbest"] for r in ranks]
    want = np.asarray(one["pbest"])
    got = np.asarray(drawn[0])
    if got.shape != want.shape or any(d for d in drawn[1:]):
        raise AssertionError(f"mesh {spec} viz: bars {got.shape} on rank "
                             f"0 against {want.shape}; others "
                             f"{[len(d) for d in drawn[1:]]}")
    err = float(np.abs(got - want).max())
    if not err <= CONTRACT:
        raise AssertionError(f"mesh {spec} viz: P(best) differs by {err}")
    log(f"mesh {spec} --debug-viz on {VIZ_TASK}: rank 0 logged P(best) of "
        f"{got.shape[-1]} models within {err:.3e} of the unsharded run's; "
        f"ms/round a rank "
        + ", ".join(f"{r['jobs']['viz']['ms_per_round']:.3f}" for r in ranks)
        + f" ({smi})")
    return {"max_err": err}


def phase_mesh_model(dev, task, total: dict, smi: str, peaks,
                     kept: dict) -> dict:
    """The mesh's model axis (see the module docstring, item 15), on
    phase 14's task files and unsharded yardstick (``kept``). Returns the
    measured figures."""
    import shutil

    import torch

    from coda_tpu_torch.parallel.mesh import parse_spec

    t_phase = time.perf_counter()
    drv, script = _mesh_driver()
    tmp, one = kept["tmp"], kept["one"]
    out: dict = {"card": smi, "runs": {}}
    cuda = dev.type == "cuda"
    try:
        if cuda:
            out["blocks"] = _block_paths(dev, peaks)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        for spec, n, jobs, rounds in MODEL_RUNS:
            b = parse_spec(spec)["model"]      # the ranks of a model group
            t0 = time.perf_counter()
            ranks, arrs = _mesh_ranks(
                script, tmp, task.name, dev, n,
                ["--mesh", spec, "--jobs", ",".join(jobs),
                 "--viz-task", VIZ_TASK, "--pool-task", kept["pool_task"],
                 "--prefilter-n", str(MESH_PREFILTER_N),
                 "--crowd-spec", CROWD_SPEC,
                 "--replays", ",".join(MODEL_REPLAYS)]
                + _rounds_arg(rounds),
                os.path.join(tmp, spec.replace(",", "_").replace("=", "")),
                MODEL_TIMEOUT_S)
            run = {"ranks_s": time.perf_counter() - t0, "jobs": {}}
            for job in jobs:
                if job == "replay" or job in MODEL_KNOBS:
                    continue
                if job == "viz":
                    run["viz"] = _hold_viz(ranks, _yard(one, job), spec,
                                           smi)
                    continue
                gaps = []
                for r in range(n):
                    gap, flips = _mesh_hold(job, r, ranks[r]["jobs"][job],
                                            arrs[r],
                                            _yard(one, job)["arrays"],
                                            block=r // b,
                                            scaled=job in BASELINES)
                    gaps.append(gap)
                    if flips:
                        log(f"mesh {spec} {job} rank {r}: tie-break-flips "
                            f"(seed, round, gap): {flips}")
                jr = [ranks[r]["jobs"][job] for r in range(n)]
                _hold_prints(f"mesh {spec} {job}", b, jr)
                o = _yard(one, job)
                run["jobs"][job] = {
                    "one": {k: o[k] for k in ("ms_per_round", "init_ms",
                                              "peak_gb")},
                    "ranks": [{k: x[k] for k in
                               ("ms_per_round", "init_ms", "peak_gb",
                                "bytes_per_round")} for x in jr],
                    "max_score_gap": max(gaps)}
                log(f"mesh {spec} {job}: ms/round {o['ms_per_round']:.3f} "
                    "unsharded, " + ", ".join(
                        f"{x['ms_per_round']:.3f}" for x in jr)
                    + f" ranks; peak GB {o['peak_gb']:.3f} unsharded, "
                    + ", ".join(f"{x['peak_gb']:.3f}" for x in jr)
                    + "; bytes a rank sends into its model group a round "
                    + ", ".join(f"{x['bytes_per_round'].get('model', 0):.0f}"
                                for x in jr)
                    + f"; max score gap {max(gaps):.3e}"
                    + (" (relative)" if job in BASELINES else ""))
            kjobs = [j for j in jobs
                     if j.removesuffix("_rec") in _MODEL_WANTS]
            if cuda:
                for r in range(n):
                    k = ranks[r]["jobs"]
                    want = {j: _MODEL_WANTS[j.removesuffix("_rec")](rounds)
                            for j in kjobs}
                    if {j: k[j]["launches"] for j in kjobs} != want:
                        raise AssertionError(
                            f"mesh {spec} rank {r} launches: "
                            + str({j: k[j]["launches"] for j in k}))
                    for job in kjobs:
                        _tally(total, k[job]["launches"],
                               k[job].get("split_launches", {}))
                log(f"mesh {spec} launches by rank ({', '.join(kjobs)}): "
                    + "; ".join(
                        f"rank {r} " + " ".join(
                            str(ranks[r]["jobs"][j]["launches"])
                            for j in kjobs)
                        for r in range(n)))
            out_dir = os.path.join(tmp, spec.replace(",", "_")
                                   .replace("=", ""))
            if "main_rec" in jobs:
                run["records"] = _hold_mesh_records(spec, n, ranks, tmp,
                                                    out_dir, smi)
            knobs = [j for j in jobs if j in MODEL_KNOBS]
            if knobs:
                run["knobs"] = _hold_knobs(spec, b, knobs, ranks, arrs, one,
                                           tmp, out_dir, smi, total, rounds,
                                           cuda)
            out["runs"][spec] = run
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"mesh model phase: {out['phase_s']:.1f} s ("
        + ", ".join(f"{spec} ranks {r['ranks_s']:.1f} s"
                    for spec, r in out["runs"].items())
        + f"; gloo on one shared card ({smi}))")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "coda_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository (no "
              "coda_tpu_torch/csrc beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from coda_tpu_torch.ops import build
    from coda_tpu_torch.utils.platform import pin_fp32_matmul

    pin_fp32_matmul()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    peaks = card_peaks(name)
    log(f"card: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"peaks used for bounds: {peaks[0] / 1e12:.2f} TB/s, "
        f"{peaks[1] / 1e12:.0f} TFLOP/s fp32, {peaks[2] / 1e12:.0f} TFLOP/s "
        "TF32 tensor)")
    stamps = [("build", time.perf_counter())]

    def enter(name: str) -> str:
        stamps.append((name, time.perf_counter()))
        return name

    phase = "build"
    try:
        info = build.build_all()
        log(f"build: {info['seconds']:.1f} s for {len(info['logs'])} "
            "libraries (nvcc -gencode arch=compute_90a,code=sm_90a)")
        for lib, text in info["logs"].items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {lib}: {line.strip()}")
        phase = enter("log sweep")
        phase_log_sweep(dev)
        phase = enter("kernels")
        recs = phase_kernels(dev, peaks)
        from coda_tpu_torch.data import make_synthetic_task

        C, N, H = HEADLINE
        t0 = time.perf_counter()
        task = make_synthetic_task(0, H=H, N=N, C=C, device=dev)
        log(f"main path: synthetic task ({H}, {N}, {C}) built in "
            f"{time.perf_counter() - t0:.1f} s")
        phase = enter("main path")
        launches = phase_main_path(dev, task)
        phase = enter("demo")
        phase_demo(dev, task, launches, smi)
        phase = enter("parity")
        phase_parity(dev)
        phase = enter("baselines")
        phase_baselines(dev, task)
        phase = enter("recorded")
        phase_recorded(dev, task, launches)
        phase = enter("tiers")
        phase_tiers(dev, task, launches)
        phase = enter("batchq and surrogate")
        phase_batchq_surrogate(dev, task, launches)
        phase = enter("replay, checkpoint and suite")
        phase_replay_checkpoint_suite(dev, task, launches)
        phase = enter("crowd and telemetry")
        phase_crowd_telemetry(dev, task, launches, smi, peaks)
        # each of the two serve phases holds a 16-slot headline slab (32
        # GB), and a ServeApp's objects form reference cycles that only
        # the garbage collector frees: the durability phase collects
        # before it builds its app (a dropped app's slab otherwise
        # outlives it into the next phase), and runs first
        phase = enter("serve durability, tiers and quality")
        phase_durable(dev, task, launches, smi)
        phase = enter("serve")
        phase_serve(dev, task, launches, smi)
        gc.collect()
        log(f"after the serve phase: "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        phase = enter("serve fleet")
        phase_fleet(dev, task, launches, smi)
        phase = enter("mesh")
        kept: dict = {}
        phase_mesh(dev, task, launches, smi, keep=kept)
        phase = enter("mesh model axis")
        phase_mesh_model(dev, task, launches, smi, peaks, kept)
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' FAILED", file=sys.stderr)
        return 1
    ends = stamps[1:] + [("end", time.perf_counter())]
    log("phase seconds: " + json.dumps(
        {a: round(t1 - t0, 1) for (a, t0), (_, t1) in zip(stamps, ends)}))
    kernels = []
    for kname, r in recs.items():
        n = launches.get(kname, 0)
        kernels.append({"name": kname, "route": "cuda", "source": r["source"],
                        "replaces": r["replaces"], "launches": n,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
        if kname.split("[")[0] in ("eig_score", "eig_refresh_score",
                                   "eig_score_batched",
                                   "eig_refresh_score_batched",
                                   "eig_refresh_compute_score"):
            # kernels 1, 2, 4, 5 and 6: the launches on each decomposition
            split = launches.get(kname + SPLIT, 0)
            kernels[-1]["launches_by_path"] = {"single": n - split,
                                               "split": split}
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

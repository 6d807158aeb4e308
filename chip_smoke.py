#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--parent DIR]

It builds the hand-written kernels from ``src/repro_torch/csrc`` with nvcc,
holds each against its plain PyTorch version on the card, drives the main
paths -- single-case shape extraction (``ShapeFeatureExtractor``) over
the 20 synthetic Table-2 cases, the batched two-pass extractor
(``BatchedExtractor``) over a 60-case cohort of them, the same cohort
with the intensity families (shape, first-order, GLCM), the same cohort
streamed on the sync-free window path (``extract_stream``), the
out-of-core tiled path (``BatchedExtractor(tiled=True)``, ``TiledCase``),
the diameter variant axis with its autotuner, the cost model's auto
knobs with the multi-tenant service (``BatchedExtractor.serve``), and the
resilience layer (``ResilientRunner``, a soak under injected faults and a
preemption, a cluster job killed and resumed), data parallelism over a
mesh of slots (``BatchedExtractor(mesh=...)``), and the LLM scaffold's
serving path (every architecture reduced, qwen3-1.7b served at full width
and depth) and its training path (four families reduced, qwen3-1.7b trained
at full width and depth, a checkpoint written and resumed), and training over a mesh of
slots (the dry run, a data-parallel step, int8 gradient compression,
GPipe, elastic resume, the launcher over every card), tensor
parallelism over 'model', and the six architectures served at full width
and depth -- checks
the features against the port's CPU path or the in-core path, and prints the kernels
line and a last JSON status line.  The autotune cache is a fresh
temporary file, so no run reads another run's winners; an untimed pass
warms it, and no timed or sync-debug phase runs a sweep.  Any failed check raises, so the script exits
non-zero; without a CUDA device, or run from a directory without the port
beside it (``src/repro_torch``), it exits non-zero before printing any
result.

Phases:
  1. set-up: card, versions, TF32 flags, kernel build, a fresh autotune
     cache warmed by an untimed pass over every configuration phases 4-8
     run (the 60 cases single-case, batched, with the families, on the
     host-compaction and one-pass paths, extract_one, and 00001-1 tiled at
     the three prune levels; phase 11's soak, its three runs, and the
     cluster job's uninterrupted run, kept as 11c's reference);
     autotune.SWEEPS is then held still through
     phases 2-8, but for the 512^3 sphere's cold run (8c); prints the
     warm pass's sweep seconds by kind and each diameter winner beside
     seqacc at the default block at the same key; then, uncached, the
     diameter sweep at every warm key (M: a bucket, its probe 3/4 full;
     T: a static target, its probe 1/32 full) with the
     tuner's old candidates (seqacc, nomask: 8 a key) and its current ones
     (with tri_prefetch: 12), each key's two winners and the two sets'
     seconds
  2. marching-cubes kernel vs plain (case 00001-1 and a sphere), rtol 1e-5,
     two runs bitwise equal; kernel, plain and bound times
  3. diameter kernel vs plain, bitwise (00001-1's unpruned vertex list and
     random inputs with masked slots); times at the tuned block of
     00001-1's bucket, bound, a cdist yardstick
  4. main path: 20 Table-2 cases on the card (prune on) plus 00001-1 with
     prune off, launch counts reset just before and read just after;
     features against the CPU path at rtol 1e-4, prune on == off bitwise;
     then one traced case for the device's busy and idle share
  5. batched kernels: one uncounted run of the batched path over the cohort
     (table2_suite seeds 0, 1, 2: 60 cases) records every launch's inputs;
     each launch is held against its plain version (compaction bitwise at
     every tile, diameter bitwise, MC rtol 1e-5) and each case against a
     launch of its own, a batch of one (MC and diameter bitwise); the
     compaction kernel also on five keep patterns x B in {1, 3, 16} x M in
     {512, 4096, 131072}; times, device times, bounds and the library
     yardstick at the largest launch
  5b. the diameter kernels: their -Xptxas -v lines (no spills); per
     kernel the counts of its SASS hot loop (cuobjdump) a pair -- all
     instructions, FP32, LDS, F2F and DMMA, each kernel over its own
     FMNMX a pair (1 for a 'naive' launch's, else 4) -- and from them the
     instruction-rate ceiling (instructions a pair x the pairs the kernel
     computes at 132 SMs x 128 lanes x the SM clock) beside the FP32-peak
     bound, and gram's conversion ceiling (F2F at 16 a clock an SM); with
     a parent checkout (--parent, default build/ab_parent, unpacked there
     with git archive) the parent's diameter.cu built from it and called
     through its own C entries, every variant at block 256 against this
     tree's on 00001-1's unpruned list and the largest pass-2b stack, in
     turns (parent, change, change, parent), same bits (gram rtol 1e-6),
     CUDA events and trace device time; the redesigned kernel
     (AB_CHANGED, none against 038b638) below the parent's device time, the
     others printed as controls of the card's spread with their ratio
     against the 0.97-1.03 band (all of them where the parent's
     diameter.cu is this tree's); the masked tile kernels' SASS counts and
     instruction-rate ceilings; nvidia-smi's SM clock and power over the
     timed window; with a parent checkout, this tree's normal diameter
     library's SASS == the parent's, kernel for kernel; then (printed as
     [work]) diameter.cu built with its work counter (DIAMETER_COUNT_WORK,
     started beside phase 1's build) and bound to this tree's wrapper:
     every variant at blocks 256 and 512 on 00001-1's unpruned list and the
     largest pass-2b stack, 3 normal and 3 traced launches, each one's
     pairs == kernels/diameter.computed_pairs (x 4 for 'naive'), its
     maxima bitwise the normal build's
  5c. (run after 8b, whose inputs it shares with phases 5, 7 and 8b) the
     compaction, GLCM, first-order and MC kernels against the parent's:
     the -Xptxas -v lines of this tree's kernels (without spills) and the
     parent's; with a parent checkout (as for 5b) the parent's
     compact.cu, glcm.cu, firstorder.cu and marching_cubes.cu built from
     it and called through this tree's wrappers (the parent's C entries
     are this tree's), in turns with this tree's on the same inputs
     (parent, change, change, parent), every pair bitwise: compaction at
     the run's largest launch and GLCM at the largest three-family stack;
     first-order at that stack and the tiled run's touched-chunk fold; MC
     at 00001-1, the largest pass-2a stack, the tiled run's largest window
     and its finalize; each below the parent's where its source differs;
     CUDA-event ms a call, the trace's device time of the kernels and of
     the whole call, the bound, the compaction's launch floor (an empty
     kernel on its grid, twice), nvidia-smi's SM clock and power over the
     timed window
  6. batched main path: launch counts reset, BatchedExtractor().run over
     the 60 cases, counts read; rows == extract_one bitwise (seed 0), ==
     phase 4's CPU features at rtol 1e-4, device_compact off == on
     bitwise, prune off == on diameters bitwise on the 5 smallest cases;
     cases/s against the single-case loop (two interleaved rounds); one
     traced run for the busy and idle share; the default and the one-pass
     path under CUDA sync debugging, no host sync outside the counted
     fetches
  7. intensity families: one uncounted three-family run over the cohort
     records every first-order and GLCM launch and the masked range kernel
     (csrc/masked_range.cu) of each pool, taken once for both families and
     held equal to intensity_range by value; the range kernel timed
     against intensity_range at the largest pool (ms a call, device us,
     bound, its two-launch floor); each family launch is held
     against its plain version on the same inputs and range (first-order
     bitwise, GLCM exactly), each case against
     a batch of one, the first-order kernel at block 1024, 2048 and 8192
     bitwise, the GLCM kernel at blocks 1 to 64 exactly, the largest GLCM
     count below 2^24; then launch counts reset,
     BatchedExtractor(families=(shape, firstorder, glcm)).run over the 60
     cases, counts read (one range launch a shape pool); rows == extract_one bitwise (seed 0), the family
     columns of all 60 == the port's CPU path (GLCM and first-order min, max,
     percentiles and entropy exactly, the rest rtol 1e-4), the shape
     columns == phase 6's shape-only rows bitwise; the host-fetch census
     and no other sync under CUDA sync debugging; times, device times and
     bounds at the largest launch; cases/s against the shape-only run (two
     interleaved rounds) and one traced run's idle share
  7b. the sync-free window path: launch counts reset,
     BatchedExtractor(families=(shape, firstorder, glcm), prep='hint',
     schedule='static').extract_stream over the 60 cases in windows of 20,
     counts read; rows == phase 7's counted/count run, == the same
     extractor's run and == extract_one (seed 0) bitwise; the reference's
     fetch census (prep 0, pass1 0, pass2b_counts one per static-chain
     group, collect_counts one per case, the pass2b_retry and hint_retry
     counts printed); every submit_window under CUDA sync debugging with
     no fetch; the drain's isolation on two windows of one case (seed-1
     cases 0 and 1, whose launches fit the card's launch queue): a spin
     (torch.cuda._sleep) longer than a submit, queued ahead of window
     k+1's launches, is still running when window k's collect returns;
     the launch queue's depth (launches a busy card takes before a launch
     blocks the host); pass 2b's padded and extent-swept
     pairs against the counted run's (and plan.work_census); cases/s of
     the stream against phase 7's run and the same extractor's run (two
     interleaved rounds); one traced stream for the busy and idle share
     and the longest idle gaps, each placed in a submit, a collect or
     elsewhere; then launch counts reset, a stream of 9 cases with 00001-1
     as a TiledCase (8 MiB) between two in-core segments, counts read, the
     tiled row == in-core extract_one bitwise
  8. the tiled path: the marching-cubes window kernel (row 2) on case
     00001-1's bucket frame cut into 4 z-windows, each granule against the
     plain version (rtol 1e-5), the assembled partials' finalize == the
     in-core kernel bitwise and == plain (rtol 1e-5); launch counts reset,
     BatchedExtractor(families=(shape, firstorder), tiled=True,
     tile_mem_mb=8) runs 00001-1 out-of-core (10 tiles), counts read; the
     tiled row == in-core extract_one bitwise for prune levels none,
     occupancy and bounds, == the CPU path at rtol 1e-4; the same run under CUDA sync
     debugging; every window, finalize and touched-chunk fold launch held
     against its plain version; walls against extract_one (two
     interleaved rounds); the finalize beside torch.sum over the (2, n)
     stack, ms a call and device time; a 512^3 analytic sphere (FnSlabSource) under an
     8 MiB budget == its in-core extract_one bitwise; a 1024^3 sphere
     (4 GiB, never materialised) under 64 MiB, 'bounds', against the
     analytic volume and diameter, traced for the device's idle share.  The
     512^3 sphere runs the default 'auto': a first run on an empty cache
     of its own times the first use's sweeps (its pruned bucket is known
     only after a run), the timed run is warm.  The 1024^3 sphere runs
     'seqacc', so no sweep lands in its timed run; an untimed sweep at its
     pruned bucket follows it
  9. the variant axis and the autotuner: each variant's kernel against its
     plain version on the same prepared input -- 00001-1's unpruned list,
     the largest pass-2b stack and random inputs with masked slots at
     blocks 128, 256, 512 -- the direct variants bitwise (and bitwise
     seqacc's kernel), gram at rtol 1e-6 and under 1e-3 of an f64 oracle
     at paper scale; each stack row == its batch of one; the Fig. 1 table
     (variant x block at both inputs: ms/call, device time, the function's
     bound, the variant's counted work, one timed plain call) and
     tri_prefetch's device time against tri's at each; a cold
     sweep at two fresh (bucket, depth) keys stores the argmin of its own
     table, a second lookup launches nothing; three uncached sweeps each
     at 00001-1's unpruned list and the largest pass-2b stack show whether
     the winners hold; launch counts reset,
     BatchedExtractor(variant='auto') over the 60 cases == variant
     'seqacc' bitwise with phase 6's host-fetch census; per variant, launch
     counts reset, ShapeFeatureExtractor(diameter_variant=v) over the 20
     cases and 00001-1 unpruned and BatchedExtractor(variant=v) over the
     60, counts read, == seqacc bitwise (gram rtol 1e-6); a torch.cdist
     yardstick at 00001-1's list
  10. (run after 8c, before 9, whose cold sweeps add measured depths) the
     auto knobs and the service: (a) the sync/cuda and hw/cuda probes on an
     empty cache of their own, each value and its seconds beside the card's
     name and power limit, a second CostModel reading both back without
     probing (autotune.PROBES), the hw record carrying its revision, the
     bandwidth (one kernel over three 256 MiB streams) at most the data
     sheet's 3.35 TB/s and printed beside the probe before its repair (the
     eager two-kernel u + 0.5 * v over 16 MiB, counted as three streams);
     (f) (run after 12) the auto stream's windows (cases, resolved schedule)
     under the repaired figure and under the old one written into the
     cache's hw/cuda record, printed with whether any moved; (b) launch counts reset,
     BatchedExtractor(families=(shape, firstorder, glcm), schedule='auto',
     prep='hint').extract_stream(window='auto') over the 60 cases on the
     warm cache (its windows warmed in phase 1), counts read; rows == phase
     7's counted/count run bitwise; the fetch census; every submit of the
     stream's windows under CUDA sync debugging, fetching nothing but the
     counted schedule's pass-1 counts, with its cases, shape and cap
     buckets, resolved schedule and launches and copies queued; cases/s
     against phase 7's run and 7b's fixed-window stream (two interleaved
     rounds each); (c) per window the cost model's counted and static
     prices beside the window's measured wall under each fixed schedule
     (rows bitwise), and the tuned static pass-2b sweeps (device time, 3
     traced runs) at most 1.10x the same lists swept by seqacc alone; (d)
     BatchedExtractor(schedule='static', prep='hint',
     families=all).serve() with 4 client threads x 6 requests of 2 cases of
     mixed_traffic_stream(48, huge_every=16), after an untimed pass: launch
     counts reset, a plug parks the driver while a request's deadline
     expires in the queue (DeadlineExceeded rows, no window slot), one case
     poisoned (NaN mask: a NaN row and its error), counts read; every other
     served row == extract_stream's bitwise and no other error; p50/p99
     request latency, cases/s, the windows' cases and tenants, the most
     launches one served window's submit queues; (e) python -m
     repro_torch.launch.serve --smoke in a subprocess exits 0
  11. (run after 9) the resilience layer, on the warm cache (no sweep, no
     probe): (a) launch counts reset, ResilientRunner(BatchedExtractor(
     schedule='static', prep='hint', families=(shape, firstorder, glcm),
     retry=RetryPolicy(2)), window=20) over the 60 cases with one one-shot
     collect fault, the whole run under CUDA sync debugging, counts read;
     every manifest row's features, read back from the JSON, == phase 7's
     counted/count rows bitwise as float32, no prep or pass-1 fetch; (b)
     the soak: stream_cases(160, seed=0) in windows of 20 under one
     FaultPlan (load errors, NaN and emptied masks at 2% each, a collect
     fault in window 3, window 7 a straggler), A uninterrupted, B preempted
     by a real SIGTERM at case 96 with its in-flight window dropped
     (drain_on_preempt=False), that window run on a stream of its own
     with a 3 s torch.cuda._sleep spin between its launches and its
     copies (the copies still pending as C begins), C resumed with a
     fresh extractor: A's records == B + C's (window ordinals aside), no id
     lost or duplicated, windows B + C <= A + 1, one retry in A whose
     window's rows == a clean run of its cases bitwise, window 7 flagged,
     no prep or pass-1 fetch; (c) examples/cluster_pipeline_torch.py
     --cases 80 (the soak's first 80) --window 20 --schedule static
     --prep hint in two
     subprocesses at once on the warm cache, one sent SIGTERM and one
     SIGKILL once its manifest holds 2 windows of lines, each run again to
     the end: both manifests == the uninterrupted in-process run's
     records; (d) the runner's cases/s against extract_stream(window=20)
     over the 60 cases (two interleaved rounds), case_id's and record's
     host microseconds a case, the soak's collect seconds a window with
     their straggler flags, the retried window's against the median
  12. (run after 10, before 9; printed as [mesh]) data parallelism on the
     warm cache (its shard depths warmed in phase 1): a 4-slot mesh of the
     one card (parallel/sharding.Mesh, a stream a slot); launch counts
     reset, BatchedExtractor(mesh=..., families=(shape, firstorder, glcm))
     .run over the 60 cases, counts read: every kernel launched between 1x
     and 4x phase 7's counts (once for each slot a launch's rows fill),
     more in all than phase 7, rows == phase 7's counted/count run bitwise,
     stats['data_parallel'] == 4, the fetch census == phase 7's, the bytes
     each slot received; extract_stream(window=20) under static/hint with
     every submit under CUDA sync debugging (no sync, no fetch), rows and
     census == the unsharded stream's; extract_stream(window='auto') under
     schedule='auto'/prep='hint', rows and census == the unsharded auto
     stream's; cases/s of each against its unsharded twin (two
     interleaved rounds); a traced mesh run's busy share of each stream
     (the slots' and the first device's; a trace without device events
     fails); the slots overlap: data_parallel_map with every shard
     spinning ~50 ms takes under (N + 1) / 2 spins (N one after another);
     with two cards or more all of this again over make_host_mesh()
     (every card, its shards peer copies), else a line saying so;
     python -m repro_torch.launch.tiled_smoke in a subprocess exits 0
  13. (printed as [models]) the LLM scaffold's serving path, which runs
     none of the kernels, float32 checks with TF32 off: (a) every
     architecture at reduced(capacity_factor=8.0), and arctic and
     deepseek-moe at their own 1.25 in groups of 20 (padded), parameters
     made on the CPU from a seed and copied to the card: forward logits and
     aux == the CPU path at rtol/atol 1e-4; at capacity 8 teacher-forced
     decode_step == the card's own forward at 2e-3, and 8 greedy
     make_serve_step tokens after a 16-token prompt == the CPU path's (each
     step's top-2 gap above 1e-4); (b) qwen3-1.7b at full width and two
     layers, float32, 4 prompts of 32: forward == the CPU at rtol/atol 1e-4,
     teacher-forced decode == forward at 2e-3; (c) qwen3-1.7b at full width
     and depth, bf16, parameters drawn on the card: make_prefill_fn over 4
     prompts of 256 (ms, median of 3 after a warm-up), the prompts by
     decode into a max_len=512 cache, 64 greedy serve steps (ms a step,
     tokens/s); finite logits, every token below vocab_size, the cache
     position 320; the bf16 gap between the decode-filled last logits and
     the prefill fn's (not gated), max_memory_allocated, the card's name and
     power limit; (d) deepseek-moe-16b at full width and two layers, bf16,
     one forward over 2 x 512 tokens: finite logits, ms, max_memory_allocated
  14. (printed as [train]) the LLM scaffold's training path, which runs none
     of the kernels (their launch counts stay 0), float32 checks with TF32
     off: (a) qwen3-1.7b, deepseek-moe-16b, seamless-m4t-large-v2 and
     internvl2-26b at reduced(capacity_factor=8.0), parameters made on the
     CPU from a seed and copied to the card, one make_train_step step (lr
     1e-2, 2 x 17 tokens, stub inputs 0.1 + 0.01 N(0, 1)) on each: loss,
     ce, aux, lr, grad_norm at rtol 1e-4, every gradient and m at rtol 1e-4
     with an atol of 1e-4 of the leaf's largest entry, v at twice both, the
     parameters after at atol 2 lr where the gradient is under that floor
     (its sign is rounding) and rtol 1e-4 elsewhere (tests/test_torch_train.py);
     (b) the same for qwen3-1.7b at full width and two layers (724 M
     parameters) over 2 x 65 tokens; (c) qwen3-1.7b at full width and depth
     (2,032 M parameters), float32 parameters and moments, bf16 compute,
     remat, 8 steps on one batch of 4 x 257 tokens at lr 3e-4 (warm-up 2):
     every loss finite, the 8th below the first, step ms, the median after
     the first and tokens/s, max_memory_allocated, the work's bounds, and a
     traced step's launches and busy share; (d) the
     Trainer at full width and two layers, float32, in a temporary workdir
     (its free bytes printed first): 4 steps and an 8.7 GB checkpoint, a
     fresh Trainer resumed at step 4 with parameters, m, v and step bitwise
     equal to those saved, trained to 6; the host copy, write and restore
     seconds; the workdir removed
  15. (printed as [dist]) training over a mesh of slots, which runs none of
     the kernels (their launch counts stay 0): (a) the dry run of every
     (arch x shape x mesh) cell on meta, each ok or skipped with the
     reference's reason, the count over 80 GB a device; qwen3-1.7b's
     train cell on a one-slot mesh against the model and opt state on the
     card (every leaf's shape and dtype, the bytes); (b) qwen3-1.7b at
     full width and two layers, float32, TF32 off: one DataParallelStep
     over MESH_SLOTS (4) slots of the card against one slot on 4 x 65
     tokens, as phase 14b compares (the loss, the gradient mean, m and v,
     the parameters after), the replicas equal; (c) qwen3-1.7b at full
     width and four layers, bf16 compute, remat, float32 master and
     moments, 8 steps of 4 x 257 tokens over the 4 slots: losses finite
     and falling, step ms and tokens/s against one slot on the same
     global batch, a traced step's device items, streams and busy share
     (the union over streams), max_memory_allocated; over every card where
     there are several; (d) the twin of
     tests/test_compression_multidevice.py over the 4 slots, its
     assertions held, bitwise == 4 CPU slots; then compressed_psum_tree
     over the slots of each leaf of (c)'s last gradients, within one
     quantisation step of the plain mean; (e) GPipe: qwen3-1.7b's 28
     decoder layers at full width, bf16, 4 stages of 7 over 4 slots,
     n_micro 4, 8 x 256 tokens: bitwise == the stack microbatch by
     microbatch, the whole batch's stack within DIST_PIPE_TOL, the times
     of the three; (f) a Trainer over the 4 slots (qwen3-1.7b reduced)
     checkpoints at step 2, elastic_remesh onto the first 2 slots restores
     it bitwise and a Trainer there trains on from the tree it returned
     to step 4; python -m
     repro_torch.launch.train --arch qwen3-1.7b --smoke --steps 4 over
     every card in a subprocess (exit 0, metrics.jsonl steps 0-3); the
     phase's seconds
  16. (printed as [tp]) tensor parallelism over the 'model' axis, which
     runs none of the kernels (their launch counts stay 0): (a) qwen3-1.7b
     at full width and two layers, float32, TF32 off: one step over (1, 4)
     and over (2, 2) slots of the card (each run in a thread, failed if it
     has not ended in TP_HANG_S) against one slot on 4 x 65 tokens, as
     phase 15b compares, the data rows equal, a second run's bitwise
     equality printed; (b) qwen3-1.7b at two layers, float32: 8 greedy
     tokens over (1, 4) == one slot's; at full width and TP_SERVE_LAYERS
     of its 28 layers (full depth over (1, 4) is served by 17b and 18b),
     bf16, laid out over (1, 4): the prefill fn on 4 prompts of 256, the prompts by
     decode into a 512 cache, 32 greedy steps (finite logits, every token
     below vocab_size, every slot's cache at 288), ms a step and tokens/s
     beside 13c's one slot, each slot's bytes, a traced decode step;
     (c) qwen3-1.7b at full width and four layers, bf16 compute, remat,
     float32 master and moments, 8 steps of 4 x 257 tokens over (1, 4):
     losses finite and falling, step ms and tokens/s against one slot, a
     traced step's device items and busy share; (d) deepseek-moe-16b at
     full width and two layers, one forward over (1, 4) on 2 x 512 tokens:
     in float64 within TP_SHARE of one slot's largest logit, aux at rtol
     TP_SHARE; in float32 (TF32 off) its error against the float64 forward
     within TP_F32_BAND times one slot's own; in bf16 within
     TP_MOE_BF16_REL (relative Frobenius) of one slot's bf16 logits, its
     gap to the float32 forward printed beside one slot's; (e) with two cards or
     more, python -m repro_torch.launch.train --model-parallel 2 in a
     subprocess (exit 0, steps 0-3)
  17. (printed as [tp2]) tensor parallelism over 'model' for the hybrid,
     ssm and encoder-decoder families, and the train step's 'pod' axis,
     which run none of the kernels (their launch counts stay 0): (a)
     hymba-1.5b (over (1, 4) and (1, 2)), rwkv6-1.6b and
     seamless-m4t-large-v2 (2 encoder layers) at full width and two
     layers, float32, TF32 off, over (1, 4) slots of the card against one
     slot: the forward in float32 and float64, max|tp - one| beside one
     slot's own float32 error from the float64 forward (the float64 layout
     within TP_SHARE of one slot's largest logit; the float32 within it too,
     or within TP_F32_BAND times one slot's own error), 8 greedy tokens ==
     one slot's (each step's top-2 gap above the float32 forward's gap),
     one train step as 16a's (loss and grad_norm at 1e-4, gradient, m and v
     within TP2_GRAD_SHARE of the leaf's largest entry; where float32
     misses, as 16d: the laid-out float64 gradients within TP_SHARE of one
     slot's, the float32 ones within TP_F32_BAND times one slot's own error
     from them); (b) hymba-1.5b at full
     width and depth, bf16, over (1, 4): the prefill fn on 4 prompts of
     256 (ms, median of 3) and 16 greedy steps into a 512 cache, against
     one slot in the same run, each slot's bytes, max_memory_allocated, a
     traced decode step's device items and busy share, finite logits and
     every token below vocab_size; (c) DataParallelStep of qwen3-1.7b at
     full width and two layers over a (2, 1, 2) ('pod', 'data', 'model')
     mesh of 4 slots == the step over (2, 2) ('data', 'model'), bitwise
  18. (printed as [tp3]) a model laid out over 'model' from its own blocks,
     with no whole copy on the card, which runs none of the kernels (their
     launch counts stay 0): (a) internvl2-26b at full width and two
     layers, float32, TF32 off, laid out over (1, 4) slots of the card
     from a meta model and seed 0: every slot's blocks == the whole seed-0
     draw's, the forward on 2 x (1024 prefix embeddings + 64 tokens)
     bitwise lay_out(whole)'s, both builds' seconds; (b) internvl2-26b at
     full width and depth, bf16, built from the seed over (1, 4):
     the bytes requested from the allocator after the build == the
     slots' blocks (1 MiB; memory_allocated, with the allocator's slack,
     printed beside), the build's peak within the blocks + the largest
     float32 draw + 1 GiB;
     the prefill fn on 2 requests of 1024 patch embeddings + 128 tokens
     (ms, median of 3), 16 greedy steps into a 1280 cache (ms a step,
     tokens/s), finite logits, every token below vocab_size; (c) the
     Trainer of qwen3-1.7b at full width and two layers, float32, over
     (1, 4) from a meta model: the bytes requested after init_state ==
     the blocks + the owned moments (1 MiB), today's figure (a whole model
     laid out and kept) beside it; 2 steps, losses and parameters bitwise
     today's path's; the checkpoint's peak within the held bytes + one
     block; resumed over (1, 4) and on one slot, parameters and moments
     bitwise the saved ones, the third step bitwise the uninterrupted
     one; (d) with 4 cards or more, nemotron-4-15b at full width and
     depth, float32, one step over (1, 4) cards from a meta model, each
     card's max_memory_allocated (printed, not gated)
  19. (printed as [serve_full]) the six registry architectures not served
     at full size before -- rwkv6-1.6b, seamless-m4t-large-v2,
     granite-3-2b, minicpm-2b, nemotron-4-15b, deepseek-moe-16b -- from
     seed 0, smallest first, garbage collected and memory_allocated
     printed before each build, which run none of the kernels (their
     launch counts stay 0): (a) float32, TF32 off, at full width and depth
     or, where the float32 parameters, the largest leaf's float32 draw and
     1 GiB do not fit in the card's free bytes, the deepest depth that
     does (printed); 2 prompts of 16 (seamless: 128 stub frames): finite
     logits; the prompt decoded and 8 greedy tokens served as a user runs
     them, then, with teacher forcing at every layer (LayerForcing) under
     one forward over the prompt and those tokens, every layer's decode
     output within SERVE_FULL_TOL of the forward's largest entry, the
     decode's and the serve steps' logits == the forward's at
     SERVE_FULL_TOL and their tokens == its argmax where the top-2 gap
     clears it; the unforced gap printed beside the forward's own
     sensitivity to a one-rounding change of its embedding rows (a random
     stack of the reference's init amplifies each rounding layer by
     layer); an MoE model at capacity 8, and its own 1.25 printed; (b)
     bf16 at full width and depth, as 13c: the build's peak within the
     bytes before + held + the largest float32 draw + its cast, the
     prefill fn on 4 prompts of 256 (ms, median of 3), their first
     SERVE_FULL_FILL tokens by decode into a 512 cache, 32 greedy steps and
     twice 32 sampled steps at temperature 0.8 from copies of the cache and
     one torch.Generator seed, bitwise equal; finite logits, every token
     below vocab_size, every cache at SERVE_FULL_FILL + 32; ms a step,
     tokens/s, max_memory_allocated, a traced
     decode step's kernels and busy share; (c) examples/serve_clients_torch.py
     in-process on the card with sweeps off: each tenant's rows and
     deadline errors, the cohort's rows bitwise run's
  20. the kernels line (each variant at block 256, as phase 5b), after the
     script's seconds; 21. the status line
"""
import collections
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import gc
import importlib.util
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from unittest import mock

T_START = time.perf_counter()  # the script's seconds, printed before the kernels line

SRC = Path(__file__).resolve().parent / "src"
if not (SRC / "repro_torch").is_dir():
    raise SystemExit(f"chip_smoke: the port is not beside this script ({SRC / 'repro_torch'} "
                     f"is missing); run it from the root of a checkout of the repository")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(SRC))

from repro_torch.core import BatchedExtractor, ShapeFeatureExtractor, crop_to_roi  # noqa: E402
from repro_torch.core import TiledCase, mc_tables  # noqa: E402
from repro_torch.core import plan as planlib  # noqa: E402
from repro_torch.data.tiles import FnSlabSource  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    mixed_traffic_stream,
    stream_cases,
    table2_suite,
)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import compact as cp  # noqa: E402
from repro_torch.kernels import diameter as dm  # noqa: E402
from repro_torch.kernels import firstorder as fo  # noqa: E402
from repro_torch.kernels import glcm as gl  # noqa: E402
from repro_torch.kernels import marching_cubes as mc  # noqa: E402
from repro_torch.kernels import masked_range as mr  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.launch.mesh import grid_mesh, make_host_mesh  # noqa: E402
from repro_torch.launch.train import synthetic_data  # noqa: E402
from repro_torch.models import encdec, moe, rwkv6, transformer  # noqa: E402
from repro_torch.models.convert import opt_state_to_reference, params_to_reference  # noqa: E402
from repro_torch.models.encdec import enc_len_for  # noqa: E402
from repro_torch.models.registry import (  # noqa: E402
    get_config,
    get_model,
    list_archs,
    model_class,
)
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.models.tensor_parallel import lay_out  # noqa: E402
from repro_torch.parallel.sharding import Mesh, data_parallel_map  # noqa: E402
from repro_torch.runtime import autotune, costmodel  # noqa: E402
from repro_torch.runtime import roofline as rl  # noqa: E402
from repro_torch.runtime.resilience import (  # noqa: E402
    FaultPlan,
    ResilientRunner,
    RetryPolicy,
    RunManifest,
)
from repro_torch.serve.serve_step import make_prefill_fn, make_serve_step  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    Trainer,
    checkpoint_shardings,
    checkpoint_skeleton,
)
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.convert import stack_named  # noqa: E402
from repro_torch.models.params import get_path, tree_paths  # noqa: E402
from repro_torch.models.transformer import layer_apply  # noqa: E402
from repro_torch.parallel import compression  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.pipeline import pipeline_forward  # noqa: E402
from repro_torch.parallel.sharding import AbstractMesh  # noqa: E402
from repro_torch.parallel.sharding import PartitionSpec as P  # noqa: E402
from repro_torch.runtime.fault_tolerance import elastic_remesh  # noqa: E402
from repro_torch.train.train_step import DataParallelStep, make_loss_fn  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM bandwidth
# and float32 outside the tensor cores (the cost model's default profile).
H100 = autotune.H100_SXM_PROFILE
PEAK_BYTES_PER_S = H100["mem_bw"]
PEAK_FP32_PER_S = H100["peak_flops"]
# the kernels' operation counts (runtime/roofline.py, shared with the cost model)
DIAM_OPS_PER_PAIR = rl.DIAM_OPS_PER_PAIR
# H100 SXM FP64 tensor-core peak (NVIDIA data sheet, dense, 700 W): the
# 'gram' variant's products
PEAK_FP64_TC_PER_S = 67e12
VARIANT_BLOCKS = (128, 256, 512)
# a parent checkout unpacked with `git archive` for the A/Bs (phases 5b and
# 5c), unless --parent names another
AB_PARENT = Path(__file__).resolve().parent / "build" / "ab_parent"
# the reference's kernel body of each variant (src/repro/kernels/diameter.py)
VARIANT_REPLACES = {"fused": 122, "tri": 122, "naive": 122, "tri_prefetch": 150,
                    "nomask": 174, "gram": 88}
FAMS = ("shape", "firstorder", "glcm")
TILED_FAMS = ("shape", "firstorder")
TILED_BIG_N = 1024  # the out-of-core sphere's edge (4 GiB materialised)
STREAM_WINDOW = 20  # phase 7b's fixed window: the 60 cases in 3 windows
MESH_SLOTS = 4  # phase 12's mesh: slots of the one card
MESH_KERNELS = ("marching_cubes", "diameter", "compact", "firstorder", "glcm", "masked_range")
MESH_SPIN_CYCLES = 100_000_000  # phase 12's overlap check: ~50 ms a shard
# phase 13: the LLM scaffold's serving path
LLM_MOE = ("arctic-480b", "deepseek-moe-16b")  # 13a also at their own capacity 1.25
LLM_MOE_GROUP = 20  # 13a's groups at capacity 1.25: 2 x 24 tokens, the last padded
LLM_SMALL = (2, 24, 16)  # 13a: batch, tokens, prompt (then 8 greedy steps)
LLM_SERVED = "qwen3-1.7b"  # 13b at two layers, 13c at full depth
LLM_WIDE = (4, 32)  # 13b: prompts x tokens
LLM_SERVE = (4, 256, 64, 512)  # 13c: requests, prompt tokens, greedy steps, max_len
LLM_MOE_WIDE = (2, 512)  # 13d: deepseek-moe-16b's batch x tokens
# phase 14, the training path
TRAIN_FAMILIES = ("qwen3-1.7b", "deepseek-moe-16b", "seamless-m4t-large-v2", "internvl2-26b")
TRAIN_LR = 1e-2  # 14a-b: the compared step's rate (warm-up 1)
TRAIN_GRAD_SHARE = 1e-4  # gradient atol, a share of the leaf's largest |g| (tests/test_torch_train.py)
TRAIN_SMALL = (2, 17)  # 14a: rows x tokens
TRAIN_WIDE = (2, 65)  # 14b: rows x tokens at full width, 2 layers
TRAIN_DEEP = (4, 257, 8)  # 14c: rows x tokens, steps at full width and depth
TRAIN_CKPT = (2, 64, 4, 6)  # 14d: rows, tokens (+1 label), run 1's steps, run 2's
DIST_WIDE = (4, 65)  # 15b: rows x tokens at full width, 2 layers, float32 (a row a slot)
DIST_DEEP = (4, 257, 8, 4)  # 15c: rows x tokens, steps, layers at full width
DIST_PIPE = (8, 256, 4)  # 15e: rows x tokens, microbatches (4 stages of 7 layers)
DIST_PIPE_TOL = 5e-2  # 15e: whole batch against microbatched, relative Frobenius, bf16
DIST_ELASTIC = (4, 32, 2, 4)  # 15f: rows, tokens (+1 label), run 1's steps, run 2's
TP_SHAPES = ((1, 4), (2, 2))  # 16a: (data, model) meshes of 4 slots of the card
TP_WIDE = (4, 65)  # 16a: rows x tokens at full width, 2 layers, float32
TP_SERVE = (4, 256, 32, 512)  # 16b: as 13c: requests, prompt tokens, greedy steps, max_len
TP_SERVE_LAYERS = 4  # 16b: a seventh of qwen3-1.7b's depth; 17b and 18b serve at full depth
TP_GREEDY = (4, 16, 8)  # 16b: 2 layers, float32: requests, prompt, greedy steps
TP_DEEP = (4, 257, 8, 4)  # 16c: as 15c: rows x tokens, steps, layers at full width
TP_MOE = (2, 512)  # 16d: deepseek-moe-16b's batch x tokens, as 13d
TP_SHARE = 1e-4  # 16d: float64 logits over (1, 4) within this share of one slot's largest
TP_F32_BAND = 2.0  # 16d: float32 logits over (1, 4) within this many times one slot's own
# float32 error (both against the float64 forward; an H100 80GB HBM3 at 700 W read 3.20e-4
# and 3.88e-4)
TP_MOE_BF16_REL = 5e-2  # 16d: bf16 logits over (1, 4) from one slot's (relative Frobenius;
# every run on an H100 80GB HBM3 at 700 W read 4.897e-2)
TP_HANG_S = 600  # 16a: a step that has not ended by then hangs
SERVE_ONE: dict = {}  # 13c's one-slot serving numbers, printed beside 16b's
# phase 17: tensor parallelism for the hybrid, ssm and encoder-decoder families, pods
TP2_MODELS = {"hymba-1.5b": ((1, 4), (1, 2)), "rwkv6-1.6b": ((1, 4),),
              "seamless-m4t-large-v2": ((1, 4),)}  # 17a: each at 2 layers over these meshes
TP2_FWD = (4, 64)  # 17a: forward rows x tokens (seamless: 128 frames)
TP2_WIDE = (4, 65)  # 17a: train-step rows x tokens
TP2_GREEDY = (4, 16, 8)  # 17a: requests, prompt, greedy steps
TP2_GRAD_SHARE = 1e-5  # 17a: gradient, m and v within this share of the leaf's largest entry
TP2_SERVE = (4, 256, 16, 512)  # 17b: hymba-1.5b requests, prompt tokens, greedy steps, max_len
TP2_POD = ((2, 1, 2), (2, 2))  # 17c: ('pod', 'data', 'model') against ('data', 'model')
# phase 18: a model laid out over 'model' from its own blocks
TP3_MODEL = "internvl2-26b"  # 18a at 2 layers, float32; 18b at full depth, bf16
TP3_FWD = (2, 64)  # 18a: rows x tokens after the 1024 prefix embeddings
TP3_SERVE = (2, 128, 16, 1280)  # 18b: requests, prompt tokens, greedy steps, max_len
TP3_TRAIN = (4, 65)  # 18c: rows x tokens, qwen3-1.7b at 2 layers, float32
TP3_BIG = "nemotron-4-15b"  # 18d, with 4 cards: full width and depth, float32
TP3_BIG_BATCH = (1, 65)  # 18d: rows x tokens
MIB, GIB = 1 << 20, 1 << 30
BF16_PEAK = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet, 700 W)
# phase 10d's service traffic: clients x requests x cases a request
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_BATCH, SERVE_HUGE_EVERY = 4, 6, 2, 16
# phase 10c: the tuned static pass-2b sweeps against the same lists swept by
# seqacc alone (the static targets' own tuner keys)
STATIC_SWEEP_LIMIT = 1.10
# phase 11b's soak: stream_cases(SOAK_CASES, seed=0) in windows of STREAM_WINDOW
# under one fault plan (benchmarks/soak.py's kinds), preempted at SOAK_PREEMPT
SOAK_CASES, SOAK_PREEMPT = 160, 96
SOAK_FAULTS = dict(seed=20261017, load_error_rate=0.02, poison_nan_rate=0.02,
                   poison_empty_rate=0.02, fail_windows=(3,), straggle_windows=(7,),
                   straggle_seconds=0.25)
SOAK_SPIN_MS = 3000  # phase 11b's spin ahead of the abandoned window's copies
# phase 11c's cluster job (examples/cluster_pipeline_torch.py) and its flags:
# the soak's first CLUSTER_CASES cases, killed after two windows (a SIGTERM'd
# job drains its window in flight, so two more remain to resume)
CLUSTER_CASES = 80
CLUSTER = ["examples/cluster_pipeline_torch.py", "--cases", str(CLUSTER_CASES), "--window",
           str(STREAM_WINDOW), "--schedule", "static", "--prep", "hint"]
# the tuner's diameter candidates before 'tri_prefetch' rejoined them
OLD_DIAMETER_VARIANTS = ("seqacc", "nomask")
# the reference's census for the cohort: one family fetch per shape bucket
FAMILY_FETCHES = {"prep": 60, "pass1": 8, "pass2a": 26, "pass2b": 18,
                  "firstorder": 26, "glcm": 26}
KEYS = [
    "MeshVolume", "VoxelVolume", "SurfaceArea", "SurfaceVolumeRatio",
    "Sphericity", "Compactness1", "Compactness2", "SphericalDisproportion",
    "Maximum3DDiameter", "Maximum2DDiameterSlice", "Maximum2DDiameterColumn",
    "Maximum2DDiameterRow", "MajorAxisLength", "MinorAxisLength",
    "LeastAxisLength", "Elongation", "Flatness",
]
DIAM_KEYS = KEYS[8:12]
# the batched row's columns, by name in the single-case feature dict
ROW_KEYS = ["MeshVolume", "SurfaceArea", "Maximum3DDiameter", "Maximum2DDiameterSlice",
            "Maximum2DDiameterRow", "Maximum2DDiameterColumn", "_n_mesh_vertices"]
PATTERNS = ["random", "zero-survivor", "all-survivor", "cap-boundary", "overflow"]
CP_TILES = (512, 1024, 2048, 4096, 8192, 16384)  # every compaction tile the kernel takes
GL_BLOCKS = (1, 2, 4, 8, 16, 64)  # GLCM blocks an SM, 1 to glcm.MAX_BLOCK


def time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` single calls timed with CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_trace(fn, reps=1):
    """Per-call device time (us) of every kernel and copy ``fn`` runs, and
    the per-call wall time (ms), from a torch.profiler trace after warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    per_kernel = {e.key: e.device_time_total / reps for e in prof.key_averages()
                  if e.device_time_total > 0}
    return per_kernel, wall_ms


def device_us_per_call(fn, reps=5):
    """Device time (us) of one call of ``fn`` whose kernels each run once a
    call: :func:`device_split` summed over the call's kernels."""
    return sum(device_split(fn, reps).values())


def ratio(num, den):
    """``num / den`` as text, or "not measured" where a trace lost ``den``."""
    return f"{num / den:.3f}" if den > 0 else "not measured"


def kernel_us(per_kernel, names):
    total = sum(us for key, us in per_kernel.items() if any(n in key for n in names))
    return f"{total:.2f} us" if total > 0 else "not measured"


def zero_counts():
    """Sets every kernel's launch count to 0."""
    mc.LAUNCHES = cp.LAUNCHES = fo.LAUNCHES = gl.LAUNCHES = mr.LAUNCHES = 0
    mc.SLAB_LAUNCHES = mc.FINALIZE_LAUNCHES = fo.FOLD_LAUNCHES = 0
    dm.LAUNCHES.update(dict.fromkeys(dm.VARIANTS, 0))


def read_counts():
    """Launches of each kernel since :func:`zero_counts`: ``diameter`` over
    every variant, ``diameter[v]`` each variant's own.  The single-case
    wrappers launch the batched kernels with a batch of one, so each path
    is counted in a run of its own."""
    return {"marching_cubes": mc.LAUNCHES, "diameter": sum(dm.LAUNCHES.values()),
            "compact": cp.LAUNCHES, "firstorder": fo.LAUNCHES, "glcm": gl.LAUNCHES,
            "masked_range": mr.LAUNCHES,
            "mc_slab_partials": mc.SLAB_LAUNCHES, "mc_partials_finalize": mc.FINALIZE_LAUNCHES,
            "fold_packed_chunks": fo.FOLD_LAUNCHES,
            **{f"diameter[{v}]": n for v, n in dm.LAUNCHES.items()}}


def check_no_sweep(sweeps, phase):
    """Fails if an autotune sweep ran since ``sweeps`` was read."""
    check(autotune.SWEEPS == sweeps,
          f"{phase}: {autotune.SWEEPS - sweeps} autotune sweep(s) ran on a warm cache")
    print(f"[{phase}] autotune.SWEEPS unchanged ({sweeps}): cache hits only")


def tuned_vs_default(key, rec):
    """One cached diameter entry: its winner and seqacc at the default block
    at the same key
    (another kind's entry: its winner)."""
    if "variant" not in rec:
        return f"{key}: block {rec['block']} {rec['us']:.2f} us"
    table = rec["table"]
    base = table.get(f"{dm.DEFAULT_VARIANT}/{dm.DEFAULT_BLOCK}")
    return (f"{key.split('/', 2)[2]}: {rec['variant']}/{rec['block']} {rec['us']:.2f} us, "
            f"{dm.DEFAULT_VARIANT}/{dm.DEFAULT_BLOCK} "
            + (f"{base:.2f} us ({rec['us'] / base:.3f}x)" if base else "not swept"))


def sweep_seconds():
    return sum(autotune.SWEEP_SECONDS.values())


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def mc_bound_ms(vols, dev):
    """Least time (ms) of marching cubes over ``vols`` (a list of volumes):
    each voxel read once, or the FP32 operations of its cells and
    triangles, whichever is larger."""
    n_tris = cells = 0
    table = torch.as_tensor(mc_tables.N_TRIS, device=dev)
    for vol in vols:
        cube = ref._cell_cube_index(vol, 0.5).long()
        n_tris += int(table[cube].sum())
        cells += cube.numel()
    work = rl.mc_work(sum(v.numel() for v in vols), cells, n_tris, len(vols))
    return rl.bound_ms(work, H100), n_tris


def diam_bound_ms(masks):
    """Least time (ms) of the pair sweeps over (M,) or (B, M) masks: 13
    bytes per slot and 16 per result, or 14 FP32 operations per pair of
    valid vertices, whichever is larger."""
    masks = masks.reshape(-1, masks.shape[-1])
    valid = masks.sum(1).double()
    pairs = int((valid * (valid + 1) / 2).sum())
    return rl.bound_ms(rl.diameter_work(masks.numel(), len(masks), pairs), H100), pairs


def rate_ceiling_ms(pairs, per_pair, clock_mhz):
    """Least time (ms) of ``pairs`` pair evaluations at ``per_pair`` dispatched
    instructions each, one warp instruction per clock on each of an SM's 4
    schedulers (128 lanes an SM) at ``clock_mhz``: the diameter sweep's
    ceiling, since none of its per-pair operations can be an FMA."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return per_pair * pairs / (sms * 128 * clock_mhz * 1e6) * 1e3


def smi_sampler(period_s=0.1):
    """Samples nvidia-smi's SM clock, power draw and limit every
    ``period_s`` on a thread until :func:`smi_summary` stops it."""
    rows, stop = [], threading.Event()

    def run():
        while True:
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True).stdout
            for line in out.splitlines()[:1]:
                try:
                    rows.append([float(x) for x in line.split(",")])
                except ValueError:
                    pass
            if stop.wait(period_s):
                return

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, stop, rows


def smi_summary(sampler):
    """Stops a :func:`smi_sampler` and returns (min, median, max) of its SM
    clock (MHz) and power draw (W), the power limit and the sample count."""
    thread, stop, rows = sampler
    stop.set()
    thread.join(timeout=30)
    if not rows:
        return None
    stats = lambda xs: (min(xs), statistics.median(xs), max(xs))  # noqa: E731
    return {"clocks_sm_mhz": stats([r[0] for r in rows]),
            "power_draw_w": stats([r[1] for r in rows]), "power_limit_w": rows[0][2],
            "samples": len(rows)}


def ptxas_lines(log, name):
    """The ``-Xptxas -v`` lines of the kernels whose mangled names hold
    ``name``: each entry's name beside its registers, stack and spills."""
    out, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif entry and name in entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return out


def fmnmx_per_pair(fn):
    """FMNMX a pair in the kernel whose mangled name is ``fn``: 1 in a
    'naive' launch's (diameter_tile_kernel<R, c>, c < 4: one combo),
    else 4 (every combo)."""
    import re
    m = re.search(r"diameter_tile_kernelILi\d+ELi(\d+)E", fn)
    return 1 if m and int(m.group(1)) < 4 else 4


def sass_by_kernel(lib_path):
    """``{mangled kernel name: its SASS}`` of a library (``cuobjdump -sass``),
    the anonymous namespace's per-file hash taken out of every name (it
    differs between checkouts); None where cuobjdump is missing."""
    import re
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    sass = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_[0-9a-f]{8}(?=\d)", "_GLOBAL__N_", sass)
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
        elif cur is not None:
            funcs[cur].append(line)
    return {k: "\n".join(v) for k, v in funcs.items()}


def sass_loop_counts(lib_path, name):
    """Per kernel whose mangled name holds ``name``: the opcode counts of
    its hot loop in the SASS (``cuobjdump -sass``), the backward-branch
    region densest in FMNMX, and from them the instructions a pair (a pair
    runs :func:`fmnmx_per_pair` FMNMX in that kernel).  None where
    cuobjdump is missing."""
    import re
    sass = sass_by_kernel(lib_path)
    if sass is None:
        return None
    funcs = {}
    for fn in (fn for fn in sass if name in fn):
        d = funcs[fn] = {"ins": [], "labels": {}}
        for line in sass[fn].splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                d["labels"][lab.group(1)] = len(d["ins"])
                continue
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                text = m.group(2).strip()
                op = text.split()[1] if text.startswith("@") else text.split()[0]
                d["ins"].append((int(m.group(1), 16), op.split(".")[0], text))
    result = {}
    for fn, d in funcs.items():
        ins, addr_at = d["ins"], {a: k for k, (a, _, _) in enumerate(d["ins"])}
        best = None
        for k, (_, op, text) in enumerate(ins):
            if op != "BRA":
                continue
            m = re.search(r"\((\.L_x_\d+)\)|0x([0-9a-f]+)", text)
            if not m:
                continue
            start = d["labels"].get(m.group(1)) if m.group(1) else addr_at.get(int(m.group(2), 16))
            if start is None or start >= k:
                continue
            ops = collections.Counter(o for _, o, _ in ins[start:k + 1])
            density = ops["FMNMX"] / (k + 1 - start)
            if ops["FMNMX"] >= 16 and (best is None or density > best[0]):
                best = (density, ops, k + 1 - start)
        if best:
            _, ops, n = best
            pairs = ops["FMNMX"] / fmnmx_per_pair(fn)
            result[fn] = {"loop_instructions": n, "pairs": pairs,
                          "per_pair": n / pairs,
                          "fp32_per_pair": (ops["FADD"] + ops["FMUL"] + ops["FMNMX"]) / pairs,
                          "lds_per_pair": ops["LDS"] / pairs,
                          "f2f_per_pair": ops["F2F"] / pairs,
                          "dmma_per_pair": ops["DMMA"] / pairs,
                          "opcodes": dict(ops.most_common(8))}
    return result


def build_parent_libs(parent, signatures):
    """The parent checkout's ``csrc/<name>.cu`` for each name of
    ``signatures`` ({name: {entry: argtypes}}), built with this tree's flags
    into a library of its own, one nvcc each, all started at once:
    ``{name: (lib, build log)}``.  Every entry returns an ``int``."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in signatures:
        src = Path(parent) / "src" / "repro_torch" / "csrc" / f"{name}.cu"
        out = _build.BUILD_DIR / f"ab_parent_{name}.so"
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                                         str(src)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"the parent's {name}.cu did not build:\n{log}")
        lib = ctypes.CDLL(str(out))
        for entry, argtypes in signatures[name].items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = (lib, log)
    return libs


# the diameter work question (ROADMAP.md, Queue 3): diameter.cu built with
# its work counter (DIAMETER_COUNT_WORK) into a library of its own, bound to
# this tree's wrapper; every variant's count held to computed_pairs at these
# blocks (256: the A/B's; 512: where a traced turn read tri_prefetch below
# its instruction ceiling, PERF.md)
COUNT_BLOCKS = (256, 512)
COUNT_TURNS = 3  # normal and traced turns of each launch


def start_counting_build():
    """Starts ``nvcc`` on this tree's ``csrc/diameter.cu`` with the work
    counter compiled in, into a library of its own beside the normal ones
    (the normal library is built without it): ``(process, library path)``."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "diameter_count_work.so"
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-DDIAMETER_COUNT_WORK",
                             "-o", str(out), str(_build.CSRC / "diameter.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def load_counting_diameter(started):
    """Waits for :func:`start_counting_build`'s build and loads it with this
    tree's C entries and ``diameter_work_take``."""
    proc, out = started
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"the counting build of diameter.cu failed:\n{log}")
    lib = ctypes.CDLL(str(out))
    for entry, argtypes in {**dm._SIGNATURES,
                            "diameter_work_take": [ctypes.POINTER(ctypes.c_ulonglong)]}.items():
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def work_taken(lib) -> int:
    """The pairs the counting library's launches computed since the last
    call (after they finished); the counter is reset."""
    torch.cuda.synchronize()
    n = ctypes.c_ulonglong(0)
    _build.check(lib, lib.diameter_work_take(ctypes.byref(n)), "diameter_work_take")
    return n.value


def diameter_work_check(lib, inputs, blocks=COUNT_BLOCKS, turns=COUNT_TURNS):
    """Every diameter variant through the counting library on ``inputs``
    (``(label, verts, masks)``), at each of ``blocks``: ``turns`` normal and
    ``turns`` traced launches, each one's count of pairs equal to
    ``dm.computed_pairs`` summed over the lists (x 4 for 'naive's four
    launches), and its maxima bitwise the normal library's.  Returns rows
    ``(label, variant, block, pairs, traced device us of each turn)``."""
    from torch.profiler import ProfilerActivity, profile

    rows = []
    work_taken(lib)
    for label, x, m in inputs:
        for block in blocks:
            for variant in dm.VARIANTS:
                if variant in ("seqacc", "nomask"):  # raises the kernel's shared-memory limit
                    n = ctypes.c_int(0)
                    _build.check(lib, lib.diameter_sweep_resident(
                        block, int(variant == "nomask"), ctypes.byref(n)), "resident")
                want = sum(dm.computed_pairs(x.shape[1], block, variant, mask=m[b])
                           for b in range(len(x))) * (4 if variant == "naive" else 1)
                launch = with_lib("diameter", lib, lambda: dm.batch_launcher(
                    x, m, block=block, variant=variant))()
                normal = dm.batch_launcher(x, m, block=block, variant=variant)()
                counts, traced_us = [], []
                for _ in range(turns):
                    got = launch()
                    counts.append(work_taken(lib))
                    check(torch.equal(got, normal), f"[work] {variant}/{block} on {label}: the "
                                                    f"counting build's maxima differ")
                for _ in range(turns):
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        launch()
                        torch.cuda.synchronize()
                    counts.append(work_taken(lib))
                    traced_us.append(sum(e.device_time_total for e in prof.key_averages()
                                         if e.device_time_total > 0))
                check(all(c == want for c in counts),
                      f"[work] {variant}/{block} on {label}: pairs counted {counts} (normal "
                      f"turns, then traced) != computed_pairs {want}")
                rows.append((label, variant, block, want, traced_us))
    return rows


# The variants whose kernels this tree redesigned against the parent
# (038b638, whose csrc is 48a9a1d's): phase 5b holds each below the
# parent's device time; the other variants' kernels are the parent's,
# controls of the card's spread, each printed beside the band AB_BAND.
# This tree changes no kernel source, so every pair is a control.
AB_CHANGED = ()
AB_BAND = (0.97, 1.03)
AB_BLOCK = 256


def tile_kernels(rows):
    """Each masked tile variant's kernels at ``rows`` rows a thread (the
    mangled-name fragments of csrc/diameter.cu), for its SASS counts."""
    return {"fused": [f"diameter_tile_kernelILi{rows}ELi4ELb0E"],
            "tri": [f"diameter_tile_kernelILi{rows}ELi4ELb0E"],
            "naive": [f"diameter_tile_kernelILi{rows}ELi{c}ELb0E" for c in range(4)],
            "tri_prefetch": [f"diameter_tile_kernelILi{rows}ELi4ELb1E"],
            "gram": ["diameter_gram_kernel"]}


# sass_loop_counts' counts a pair, by the name phase 5b prints
SASS_LABELS = {"per_pair": "instructions", "fp32_per_pair": "FP32", "lds_per_pair": "LDS",
               "f2f_per_pair": "F2F", "dmma_per_pair": "DMMA"}
# The parent's C entries that phases 5b and 5c call: 038b638's are this
# tree's, the same names and argument lists, so its libraries are bound to
# this tree's wrappers, which pass those arguments (phase 7 times the
# masked range kernel against its plain version, not against the parent's).
PARENT_SIGNATURES = {
    "diameter": dm._SIGNATURES,
    "firstorder": fo._SIGNATURES,
    "marching_cubes": mc._SIGNATURES,
    "compact": cp._SIGNATURES,
    "glcm": gl._SIGNATURES,
}


def build_parent_diameter(parent):
    """The parent checkout's ``csrc/diameter.cu`` built with this tree's
    flags into its own library, with the parent's C entries: ``(lib, build
    log)``."""
    return build_parent_libs(parent, {"diameter": PARENT_SIGNATURES["diameter"]})["diameter"]


def with_lib(name, lib, fn):
    """``fn`` run with the library ``name`` bound to ``lib`` (a parent's
    build of a source whose C entries are this tree's)."""
    def call():
        saved = _build._LIBS.get(name)
        _build._LIBS[name] = lib
        try:
            return fn()
        finally:
            _build._LIBS[name] = saved
    return call


def parent_launcher(lib, verts, masks, block, variant):
    """A launch of the parent's ``variant`` kernel on this tree's prepared
    input, the input prepared once: this tree's launch
    (``diameter.batch_launcher``) bound to the parent's library."""
    return with_lib("diameter", lib, lambda: dm.batch_launcher(verts, masks, block=block,
                                                               variant=variant))()


def diameter_ab(parent, inputs, blocks, reps=10, variants=("seqacc", "nomask")):
    """The parent's ``variants`` kernels against this tree's, on the same
    prepared inputs, in turns (parent, change, change, parent): ms per
    call (CUDA events, median of ``reps``) and device time (a trace, every
    kernel of the call).  Both must give the same bits ('gram': rtol
    1e-6, its float64 products may round apart).  Returns rows ``(input,
    variant, block, parent ms, change ms, parent device us, change device
    us)`` and the nvidia-smi summary of the timed window."""
    lib, log = build_parent_diameter(parent)
    for line in ptxas_lines(log, "diameter_"):
        print(f"[diam-ab] parent ptxas: {line}")
    rows = []
    smi = smi_sampler()
    try:
        for label, x, m in inputs:
            for variant in variants:
                for block in blocks:
                    old = parent_launcher(lib, x, m, block, variant)
                    new = dm.batch_launcher(x, m, block=block, variant=variant)
                    a, b = old(), new()
                    what = f"parent vs change {variant}/{block} on {label}"
                    if variant == "gram":
                        np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(), rtol=1e-6,
                                                   err_msg=what)
                    else:
                        check(torch.equal(a, b), f"{what}: bits differ")
                    ms = {"old": [], "new": []}
                    us = {"old": [], "new": []}
                    for which in ("old", "new", "new", "old"):
                        fn = old if which == "old" else new
                        ms[which].append(time_ms(fn, reps=reps, warmup=2))
                        us[which].append(device_us_per_call(fn))
                    rows.append((label, variant, block, ms["old"], ms["new"], us["old"],
                                 us["new"]))
    finally:
        clocks = smi_summary(smi)
    return rows, clocks


def device_split(fn, reps=5, tries=3):
    """Device time (us) of each kernel or copy one call of ``fn`` runs: its
    traced total over its traced count, so a launch the profiler drops does
    not lower it.  A trace that lost every event is taken again, up to
    ``tries`` times; then the split is empty."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        split = {e.key: e.device_time_total / e.count for e in prof.key_averages()
                 if e.device_time_total > 0 and e.count}
        if split:
            return split
    return {}


def kernel_ab(entries, reps=20):
    """Phase 5c's A/B: per entry ``(label, parent call, change call, same,
    kernel names)``, ``same(parent out, change out)`` checks the results,
    then parent, change, change, parent in turns: ms per call (CUDA events,
    median of ``reps``), the device time of the named kernels and of the
    whole call (:func:`device_split`).  Returns the rows and the
    nvidia-smi summary of the timed window."""
    rows = []
    smi = smi_sampler()
    try:
        for label, old, new, same, names in entries:
            same(old(), new())
            turns = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                fn = old if which == "old" else new
                ms = time_ms(fn, reps=reps, warmup=2)
                split = device_split(fn)
                kern = {k: us for k, us in split.items() if any(n in k for n in names)}
                turns[which].append((ms, sum(kern.values()), sum(split.values()), kern))
            rows.append((label, turns))
    finally:
        clocks = smi_summary(smi)
    return rows, clocks


def intensity_bounds_ms(masks, glcm_out):
    """Least time (ms) of each intensity function on one launch's inputs.

    Bytes: the float32 mask at every voxel and the float32 image at the
    masked voxels only (neither function needs an unmasked intensity),
    the two (B,) range vectors, and the output rows, each once.
    Operations: what these inputs need (masked voxels, valid pairs; the
    pairs are half the symmetrised counts).
    """
    batch, voxels = masks.shape[0], masks.numel()
    masked = int((masks > 0).sum())
    pairs = int(glcm_out.double().sum()) // 2
    fo_b, gl_b = (rl.bound_ms(rl.intensity_work(f, batch, voxels, masked, pairs, fo.N_BINS), H100)
                  for f in ("firstorder", "glcm"))
    return fo_b, gl_b, masked, pairs


def keep_pattern(case, m, cap, rng):
    """The five keep patterns of tests/test_pipeline_device_compact.py."""
    if case == "random":
        return rng.random(m) < 0.3
    if case == "zero-survivor":
        return np.zeros(m, bool)
    if case == "all-survivor":
        return np.ones(m, bool)
    keep = np.zeros(m, bool)
    keep[rng.choice(m, size=cap if case == "cap-boundary" else cap + 57, replace=False)] = True
    return keep


class Recorder:
    """Wraps a module's kernel wrapper so that one run of the main path
    leaves a copy of every launch's inputs (for the kernel checks)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []
        self.kwargs = []  # each call's keyword arguments, beside ``calls``

    def __enter__(self):
        def copy(a):
            if isinstance(a, tuple):
                return tuple(copy(x) for x in a)
            return a.clone() if isinstance(a, torch.Tensor) else a

        def record(*args, **kwargs):
            self.calls.append(copy(args))
            self.kwargs.append({k: copy(v) for k, v in kwargs.items()})
            return self.fn(*args, **kwargs)

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def sphere_slabs(n, rfrac):
    """``fn(z0, z1)``: planes of an analytic sphere of radius ``rfrac * n``
    centred in an n^3 volume, made on demand (a ``FnSlabSource``)."""
    ax = ((np.arange(n) - n / 2) / (n * rfrac)) ** 2
    axy = ax[:, None] + ax[None, :]

    def fn(z0, z1):
        az = ((np.arange(z0, z1) - n / 2) / (n * rfrac)) ** 2
        return (axy[:, :, None] + az[None, None, :] < 1.0).astype(np.float32)

    return fn


def traced(fn):
    """``(result, wall seconds, device busy seconds)`` of one call of ``fn``
    under a torch.profiler trace of the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.device_time_total for e in prof.key_averages()) / 1e6
    return out, wall, busy


def warm_autotune(suite, cases, cohort_cases):
    """Runs, untimed, every configuration that phases 4-8 run on the
    cohort and 00001-1 with ``'auto'``, so each of their autotune lookups
    (diameter, compaction and family blocks at each launch's bucket and
    depth) is a cache hit.  Returns the seconds it took."""
    t0 = time.perf_counter()
    seed0 = cohort_cases[:len(suite)]
    single = ShapeFeatureExtractor()
    for img, msk, sp in cohort_cases:
        single.execute(img, msk, sp)
    img, msk, sp = cases["00001-1"]
    ShapeFeatureExtractor(prune=False).execute(img, msk, sp)
    for ext in (BatchedExtractor(), BatchedExtractor(families=FAMS)):
        ext.run(cohort_cases)
        ext.run(seed0)
        for case in seed0:
            ext.extract_one(*case)
    BatchedExtractor(device_compact=False).run(seed0)
    small = sorted(range(len(suite)), key=lambda i: suite[i][2].size)[:5]
    one = BatchedExtractor(prune=False)
    one.run([seed0[i] for i in small[:1]])
    one.run([seed0[i] for i in small])
    BatchedExtractor(families=TILED_FAMS).extract_one(img, msk, sp)
    for level in ("occupancy", "none", "bounds"):
        BatchedExtractor(families=TILED_FAMS, tiled=True, tile_mem_mb=8.0,
                         tile_prune=level).extract_tiled((img, msk, sp))
    # phase 7b: hint caps and static targets are keys of their own
    sext = stream_extractor(FAMS)
    sext.run(cohort_cases)
    list(sext.extract_stream(cohort_cases, window=STREAM_WINDOW))
    for window in iso_windows(cohort_cases):
        sext.run(window)
    list(stream_extractor(TILED_FAMS).extract_stream(tiled_stream(cohort_cases, cases),
                                                     window=4))
    # phase 10: the auto stream's windows, and each under both fixed schedules
    sizes, _ = auto_stream_windows(cohort_cases)
    cext = BatchedExtractor(families=FAMS, schedule="counted", prep="hint")
    for chunk in split(cohort_cases, sizes):
        cext.run(chunk)
        sext.run(chunk)
    # phase 12: each mesh's launches resolve at their shard depths
    for mesh in mesh_meshes():
        warm_mesh(mesh, cohort_cases)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def mesh_meshes():
    """Phase 12's meshes: MESH_SLOTS slots of the first card, and every card
    where there are two or more."""
    meshes = [Mesh([torch.device("cuda", 0)] * MESH_SLOTS)]
    if torch.cuda.device_count() >= 2:
        meshes.append(make_host_mesh())
    return meshes


def mesh_extractors(mesh):
    """Phase 12's drives over ``mesh`` (None: unsharded): the counted run,
    7b's static/hint stream and 10b's auto stream, three families."""
    return {"run": BatchedExtractor(mesh=mesh, families=FAMS),
            "stream": BatchedExtractor(mesh=mesh, families=FAMS, schedule="static",
                                       prep="hint"),
            "auto": BatchedExtractor(mesh=mesh, families=FAMS, schedule="auto", prep="hint")}


def mesh_drive(ext, which, cases):
    """One drive of phase 12: ``(rows, seconds, the run's stats or None)``."""
    t0 = time.perf_counter()
    stats = None
    if which == "run":
        rows, stats = ext.run(cases)
    else:
        rows = list(ext.extract_stream(iter(cases),
                                       window=STREAM_WINDOW if which == "stream" else "auto"))
    return np.stack(rows), time.perf_counter() - t0, stats


def warm_mesh(mesh, cohort_cases):
    """Phase 1's untimed pass over phase 12's mesh drives: until one pass
    sweeps nothing (a sweep can move an auto window's boundary)."""
    for _ in range(4):
        s0 = autotune.SWEEPS
        for which, ext in mesh_extractors(mesh).items():
            mesh_drive(ext, which, cohort_cases)
        if autotune.SWEEPS == s0:
            return
    raise AssertionError("phase 12's mesh drives still sweep after 4 passes")


def stream_busy(prof):
    """Device busy time (us) and items of each stream of a trace, keyed by
    (device, stream), with its count of host-to-device copies."""
    per = collections.defaultdict(lambda: [[], 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rec = per[(e.device_index, e.device_resource_id)]
            rec[0].append((e.time_range.start, e.time_range.end))
            rec[1] += "HtoD" in e.name
    out = {}
    for key, (iv, htod) in per.items():
        iv.sort()
        busy, end = 0.0, -np.inf
        for a, b in iv:
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        out[key] = {"busy_us": busy, "items": len(iv), "htod": htod}
    return out


def mesh_phase(mesh, label, cohort_cases, frows, plain, want_fetches, fam_launches):
    """Phase 12 over one mesh: the three drives, each against its unsharded
    twin in ``plain`` (rows, fetch census, cases/s), under counted launches,
    the stream's submits under strict syncs, a trace's busy share of each
    stream, the bytes each slot received."""
    n, slots = len(cohort_cases), mesh.shape["data"]
    exts = mesh_extractors(mesh)
    check(all(e.mesh is mesh and e.device == mesh.home for e in exts.values()),
          f"{label}: the extractors did not take the mesh")
    for which, ext in exts.items():
        ex = ext.executor
        f0 = dict(ex.transfer_log)
        mesh.received[...] = 0
        zero_counts()
        rows, secs, stats = mesh_drive(ext, which, cohort_cases)
        launches = read_counts()
        fetches = fetch_delta(ex.transfer_log, f0)
        check(np.array_equal(rows, frows), f"{label} {which}: rows != the unsharded rows")
        check(fetches == want_fetches[which],
              f"{label} {which}: host fetches {fetches} != the unsharded {want_fetches[which]}")
        check(all(launches[k] > 0 for k in MESH_KERNELS),
              f"{label} {which}: a kernel of the path never ran: {launches}")
        if which == "run":
            check(all(fam_launches[k] <= launches[k] <= slots * fam_launches[k]
                      for k in MESH_KERNELS)
                  and sum(launches[k] for k in MESH_KERNELS)
                  > sum(fam_launches[k] for k in MESH_KERNELS),
                  f"{label} run: launches {launches} are not 1x-{slots}x phase 7's "
                  f"{fam_launches}, more in all")
            check(stats["data_parallel"] == slots,
                  f"{label}: stats['data_parallel'] {stats['data_parallel']} != {slots}")
        print(f"[mesh] {label} {which}: {n} cases in {secs:.3f} s = {n / secs:.3f} cases/s "
              f"(first drive); rows == the unsharded rows bitwise; host_fetches == the "
              f"unsharded {fetches}; launches {({k: launches[k] for k in MESH_KERNELS})}; bytes "
              f"each slot received {mesh.received.ravel().tolist()}")
    # every submit of the stream under CUDA sync debugging, windows driven as
    # the stream drives them
    sex = exts["stream"].executor
    windows = [cohort_cases[s0:s0 + STREAM_WINDOW] for s0 in range(0, n, STREAM_WINDOW)]
    pending, loop_rows = None, []
    for chunk in windows + [None]:
        state = None
        if chunk is not None:
            f0 = dict(sex.transfer_log)
            with sex.strict_syncs():
                state = sex.submit_window(chunk)
            check(dict(sex.transfer_log) == f0, f"{label}: a static/hint submit fetched")
        if pending is not None:
            loop_rows += sex.collect_window(pending)[0]
        pending = state
    check(np.array_equal(np.stack(loop_rows), frows), f"{label}: the strict-sync loop's rows")
    print(f"[mesh] {label}: every static/hint submit_window under CUDA sync debugging "
          "('error'): no host sync, no fetch; rows bitwise")
    # cases/s: each drive against its unsharded twin, in turns
    rates = {}
    for which in exts:
        turns = {"mesh": [], "plain": []}
        for side in ("mesh", "plain", "plain", "mesh"):
            ext = exts[which] if side == "mesh" else plain[which]
            turns[side].append(n / mesh_drive(ext, which, cohort_cases)[1])
        rates[which] = turns
    print(f"[mesh] {label} cases/s over the {n} cases, turns mesh, unsharded, unsharded, mesh: "
          + "; ".join(f"{w} mesh {[round(r, 3) for r in t['mesh']]} unsharded "
                      f"{[round(r, 3) for r in t['plain']]} (mesh / unsharded "
                      f"{ratio(sum(t['mesh']), sum(t['plain']))}x)" for w, t in rates.items()))
    # a traced mesh run: the busy share of each stream
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exts["run"].run(cohort_cases)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = stream_busy(prof)
    check(busy, f"{label}: the traced run holds no device events")
    check(len(busy) >= slots + 1, f"{label}: the trace shows {len(busy)} streams, not "
                                  "a stream a slot and the first device's")
    print(f"[mesh] {label} traced run: wall {wall_us / 1e3:.3f} ms; busy share by (device, "
          "stream) (the one with the pinned host-to-device copies is the first device's "
          "stream, the others the slots' and, on other cards, their links'): "
          + "; ".join(f"{k} {v['busy_us'] / 1e3:.3f} ms = {v['busy_us'] / wall_us:.4f} "
                      f"({v['items']} items, {v['htod']} HtoD)"
                      for k, v in sorted(busy.items())))
    slot_overlap(mesh, label)


def spin_seconds(mesh):
    """Wall seconds of one data_parallel_map over ``mesh`` whose every shard
    spins MESH_SPIN_CYCLES on its slot's stream (its first call untimed)."""
    x = torch.arange(mesh.shape["data"] * 1024, dtype=torch.float32, device=mesh.home)

    def fn(x):
        torch.cuda._sleep(MESH_SPIN_CYCLES)
        return x * 2

    f = data_parallel_map(fn, mesh)
    check(torch.equal(f(x), x * 2), "the spinning map's output")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f(x)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def slot_overlap(mesh, label):
    """The slots' work overlaps: N spinning shards take well under the N
    spins they would one after another."""
    n = mesh.shape["data"]
    one = spin_seconds(Mesh([mesh.home]))
    wall = spin_seconds(mesh)
    check(wall < 0.5 * (n + 1) * one, f"{label}: {n} spinning slots took {wall * 1e3:.3f} ms, "
                                      f"one slot {one * 1e3:.3f} ms: the slots do not overlap")
    print(f"[mesh] {label}: {n} slots each spinning {MESH_SPIN_CYCLES} cycles: wall "
          f"{wall * 1e3:.3f} ms, one slot {one * 1e3:.3f} ms ({wall / one:.3f} spins; "
          f"{n} one after another)")


def data_parallel_phase(cohort_cases, frows, fstats, fam_launches):
    """Phase 12: the three drives unsharded (the census each mesh drive is
    held to), then over each of :func:`mesh_meshes`, then the tiled smoke."""
    t_mesh = time.perf_counter()
    sweeps_mesh = autotune.SWEEPS
    plain = mesh_extractors(None)
    want_fetches = {}
    for which, ext in plain.items():
        f0 = dict(ext.executor.transfer_log)
        unsharded_rows, _, _ = mesh_drive(ext, which, cohort_cases)
        check(np.array_equal(unsharded_rows, frows), f"unsharded {which}: rows != phase 7's")
        want_fetches[which] = fetch_delta(ext.executor.transfer_log, f0)
    check(want_fetches["run"] == fstats["host_fetches"],
          "the unsharded run's census != phase 7's")
    meshes = mesh_meshes()
    mesh_phase(meshes[0], f"{MESH_SLOTS} slots of {torch.cuda.get_device_name(0)}",
               cohort_cases, frows, plain, want_fetches, fam_launches)
    if len(meshes) > 1:
        mesh_phase(meshes[1], f"every card ({torch.cuda.device_count()})", cohort_cases, frows,
                   plain, want_fetches, fam_launches)
    else:
        print(f"[mesh] this machine has {torch.cuda.device_count()} card: the every-card "
              "mesh (make_host_mesh()) needs two or more, so that check is not run here")
    check_no_sweep(sweeps_mesh, "mesh")
    tiled_smoke_phase()
    print(f"[mesh] phase 12 took {time.perf_counter() - t_mesh:.3f} s")


def tiled_smoke_phase():
    """Phase 12's last step: ``python -m repro_torch.launch.tiled_smoke``
    exits 0 (its autotune cache a file of its own)."""
    root = Path(__file__).resolve().parent
    fd, cache = tempfile.mkstemp(prefix="repro_tiled_smoke_", suffix=".json")
    os.close(fd)
    os.unlink(cache)
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.tiled_smoke"], cwd=root,
                           env=dict(os.environ, PYTHONPATH=str(root / "src"),
                                    REPRO_AUTOTUNE_CACHE=cache),
                           capture_output=True, text=True, timeout=600)
    finally:
        if os.path.exists(cache):
            os.unlink(cache)
    for line in (r.stdout + r.stderr).strip().splitlines():
        print(f"[mesh] {line}")
    check(r.returncode == 0, f"python -m repro_torch.launch.tiled_smoke exited {r.returncode}")
    print(f"[mesh] python -m repro_torch.launch.tiled_smoke: exit 0 in "
          f"{time.perf_counter() - t0:.3f} s")


def stream_extractor(families):
    """Phase 7b's extractor: the sync-free window path (hint caps, static
    targets), with the tiled engine at phase 8's 8 MiB budget."""
    return BatchedExtractor(families=families, prep="hint", schedule="static",
                            tile_mem_mb=8.0)


def tiled_stream(cohort_cases, cases):
    """Phase 7b's stream with a tiled segment: 00001-1 as a TiledCase
    between two in-core segments of seed-1 cases."""
    img, msk, sp = cases["00001-1"]
    return cohort_cases[20:24] + [TiledCase(msk, image=img, spacing=sp)] + cohort_cases[24:28]


def cycles_per_ms():
    """Clock cycles of ``torch.cuda._sleep`` a millisecond, measured."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(50_000_000)
    end.record()
    end.synchronize()
    return 50_000_000 / start.elapsed_time(end)


def iso_windows(cohort_cases):
    """Phase 7b's isolation windows, one case each (seed-1 cases 0 and 1):
    a window's launches must fit the card's launch queue behind a spin,
    and a 4-case window's do not."""
    return cohort_cases[20:21], cohort_cases[21:22]


def queued_launches(fn):
    """``(kernels and copies one call of fn queues, its result)``, from a
    trace of the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA), out


def launch_queue_depth(limit=4096):
    """Kernel launches the card's queue takes behind a spin before a launch
    blocks the host (a launch over 20 ms), or ``limit``."""
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    torch.cuda._sleep(int(500 * cycles_per_ms()))
    n = limit
    for i in range(limit):
        t0 = time.perf_counter()
        x.add_(1.0)
        if time.perf_counter() - t0 > 0.02:
            n = i
            break
    torch.cuda.synchronize()
    return n


def fetch_delta(log, before):
    return {k: v - before.get(k, 0) for k, v in log.items() if v - before.get(k, 0)}


def labelled(fn, label):
    """``fn`` inside a ``torch.profiler.record_function`` span ``label``."""
    def run(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return run


def idle_gaps(prof):
    """Busy time, the idle gaps between the card's merged kernel and copy
    intervals, and the device time by kernel name, of a trace: ``(busy_us,
    gaps, per_kernel_us)``, each gap ``(us, the host span its midpoint
    falls in)`` ('submit', 'collect' or 'other', from the ``stream.*``
    spans), longest first.  The spans' own device-side annotations are not
    device work."""
    dev_iv, spans = [], []
    per_kernel = collections.Counter()
    for e in prof.events():
        if e.name.startswith("stream."):
            if e.device_type != torch.autograd.DeviceType.CUDA:
                spans.append((e.time_range.start, e.time_range.end, e.name[7:]))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            dev_iv.append((e.time_range.start, e.time_range.end))
            per_kernel[e.name] += e.time_range.end - e.time_range.start
    if not dev_iv:
        return 0.0, [], per_kernel
    dev_iv.sort()
    merged = [list(dev_iv[0])]
    for a, b in dev_iv[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps = []
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        where = next((name for s0, s1, name in spans if s0 <= mid <= s1), "other")
        gaps.append((b - a, where))
    return busy, sorted(gaps, reverse=True), per_kernel


def census_pairs(items):
    """Padded pairs of a plan's diameter work items (``plan.work_census``)."""
    return sum(it.depth * it.m * (it.m - 1) // 2 for it in items if it.kind == "diameter")


def pairs_of(calls):
    """Padded and extent pairs of recorded diameter launches: sum of B x
    M(M-1)/2 and of each list's extent(extent-1)/2 (``ref.list_extent``)."""
    padded = swept = 0
    for verts, masks, *_ in calls:
        b, m = masks.shape[:2]
        padded += b * m * (m - 1) // 2
        ext = ref.list_extent(masks).long()
        swept += int((ext * (ext - 1) // 2).sum())
    return padded, swept


def paper_scale_cloud(seed, m=384):
    """Vertices at KITS19-like physical scale (tests/test_gram_precision.py)."""
    rng = np.random.default_rng(seed)
    idx = rng.uniform(0.0, 1.0, size=(m, 3)) * np.array([512, 512, 512], np.float64)
    return (idx * np.array([0.7, 0.7, 5.0])).astype(np.float32)


def diameters_f64(verts):
    """The f64 oracle of the four diameters of a small cloud."""
    v = verts.astype(np.float64)
    q = (v[:, None, :] - v[None, :, :]) ** 2
    return np.sqrt([p.max() for p in (q.sum(-1), q[..., 0] + q[..., 1], q[..., 0] + q[..., 2],
                                      q[..., 1] + q[..., 2])])


def sphere_volume(n, r):
    g = np.arange(n) - (n - 1) / 2
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return np.pad((x * x + y * y + z * z <= r * r).astype(np.float32), 1)


def check_no_probe(probes, phase):
    """Fails if a sync or hardware probe ran since ``probes`` was read."""
    check(autotune.PROBES == probes,
          f"{phase}: {autotune.PROBES - probes} probe(s) ran on a warm cache")


class Plug:
    """A loader that parks the service's driver inside prep until released:
    whatever is submitted meanwhile is queued together."""

    def __init__(self, case):
        self.entered, self.release = threading.Event(), threading.Event()
        self._case = case

    def __call__(self):
        self.entered.set()
        check(self.release.wait(120), "the plug was never released")
        return self._case


def auto_stream_windows(cohort_cases):
    """The auto stream's window sizes over the cohort, run until a pass
    sweeps nothing (its own sweeps add measured depths, which can move a
    boundary); returns ``(sizes, passes)``."""
    for passes in range(1, 5):
        s0, sizes = autotune.SWEEPS, []
        list(auto_extractor().extract_stream(
            iter(cohort_cases), window="auto",
            stats_callback=lambda i, st: sizes.append(st["cases"])))
        if autotune.SWEEPS == s0:
            return sizes, passes
    raise AssertionError("the auto stream still sweeps after 4 passes")


def auto_extractor():
    """Phase 10's auto extractor: the cost model's schedule per window, hint caps."""
    return BatchedExtractor(families=FAMS, schedule="auto", prep="hint")


def split(cases, sizes):
    bounds = np.cumsum([0] + list(sizes))
    return [cases[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def serve_traffic():
    """Phase 10d's traffic: the clients' 48 cases of mixed_traffic_stream(.,
    huge_every=16), then two for the request that expires and one for the
    plug; and where the poisoned case sits (client, request, case)."""
    n = SERVE_CLIENTS * SERVE_REQUESTS * SERVE_BATCH
    traffic = [(img, msk, sp) for _, img, msk, sp in
               mixed_traffic_stream(n + 3, seed=0, huge_every=SERVE_HUGE_EVERY)]
    return traffic[:n], traffic[n:n + 2], traffic[n + 2], (1, 2, 0)


def client_requests(cases, poison_at):
    """Each client's requests, as (case indices, cases), the case at
    ``poison_at`` replaced by a copy with a NaN in its mask."""
    out = []
    for c in range(SERVE_CLIENTS):
        mine = list(range(c, len(cases), SERVE_CLIENTS))
        reqs = []
        for r in range(SERVE_REQUESTS):
            idx = mine[r * SERVE_BATCH:(r + 1) * SERVE_BATCH]
            batch = [cases[i] for i in idx]
            if (c, r) == poison_at[:2]:
                img, msk, sp = batch[poison_at[2]]
                bad = np.asarray(msk, np.float32).copy()
                bad[tuple(s // 2 for s in bad.shape)] = np.nan
                batch[poison_at[2]] = (img, bad, sp)
            reqs.append((idx, batch))
        out.append(reqs)
    return out


def old_bandwidth_probe(dev):
    """The bandwidth probe before its repair: the eager ``u + 0.5 * v`` (two
    kernels, five streams) over two 16 MiB streams, counted as three."""
    m = 1 << 22
    u = torch.ones(m, dtype=torch.float32, device=dev)
    v = torch.full((m,), 2.0, dtype=torch.float32, device=dev)
    return 3.0 * 4.0 * m / autotune._best_device_s(lambda: u + 0.5 * v, 8, 2)


def probe_phase(dev, smi):
    """Phase 10a: the sync and hardware probes, on an empty cache of their
    own, and the bandwidth probe before its repair; returns the old figure."""
    fd, probe_file = tempfile.mkstemp(prefix="repro_probe_", suffix=".json")
    os.close(fd)
    os.unlink(probe_file)
    pcache = autotune.AutotuneCache(probe_file)
    probes0, secs0 = autotune.PROBES, dict(autotune.PROBE_SECONDS)
    cm = costmodel.CostModel(dev, cache=pcache).resolve()
    prof, sync_us = cm.hw_profile(), cm.sync_cost_us()
    stored = json.load(open(probe_file))["entries"]
    check(autotune.PROBES == probes0 + 2 and prof["source"] == "measured"
          and set(stored) == {autotune.sync_key("cuda"), autotune.hw_key("cuda")},
          f"the probes: {autotune.PROBES - probes0} run, profile {prof}, stored {sorted(stored)}")
    again = costmodel.CostModel(dev, cache=pcache).resolve()
    check_no_probe(probes0 + 2, "probe")
    check(again.sync_cost_us() == sync_us and again.hw_profile() == prof,
          "a second CostModel read other values than the probes stored")
    check(stored[autotune.hw_key("cuda")].get("revision") == autotune.HW_PROBE_REVISION,
          f"the hw record carries no revision {autotune.HW_PROBE_REVISION}: {stored}")
    os.unlink(probe_file)
    secs = {k: autotune.PROBE_SECONDS[k] - secs0[k] for k in secs0}
    check(0 < prof["mem_bw"] <= H100["mem_bw"],
          f"the bandwidth probe reads {prof['mem_bw'] / 1e12:.3f} TB/s, past the data sheet's "
          f"{H100['mem_bw'] / 1e12:.2f}")
    old_bw = old_bandwidth_probe(dev)
    mib = autotune.HW_PROBE_COPY_ELEMS * 4 // 2**20
    print(f"[probe] card: {smi}; sync/cuda {sync_us:.3f} us ({secs['sync']:.3f} s), hw/cuda "
          f"peak FP32 {prof['peak_flops'] / 1e12:.3f} TFLOP/s (an N={autotune.HW_PROBE_MATMUL_N} "
          f"matmul, TF32 off) and bandwidth {prof['mem_bw'] / 1e12:.3f} TB/s (one kernel, "
          f"torch.add(u, v, alpha=0.5), {autotune.HW_PROBE_STREAMS} streams of {mib} MiB) "
          f"({secs['hw']:.3f} s), against the data sheet's "
          f"{H100['peak_flops'] / 1e12:.0f} and {H100['mem_bw'] / 1e12:.2f}; a second CostModel "
          f"read both from the cache: {autotune.PROBES - probes0} probes in all")
    print(f"[probe] the probe before its repair (eager u + 0.5 * v, two kernels, over 16 MiB, "
          f"counted as 3 streams): {old_bw / 1e12:.3f} TB/s; its 5 streams counted: "
          f"{old_bw * 5 / 3 / 1e12:.3f} TB/s; new / old {ratio(prof['mem_bw'], old_bw)}x")
    return old_bw


def probe_moves(cohort_cases, old_bw):
    """Phase 10f: the auto stream's windows (cases and resolved schedule)
    under the repaired bandwidth figure and under the old one, written in
    turn into the cache's hw/cuda record; prints whether any moved."""
    cache = autotune.AutotuneCache()
    key = autotune.hw_key("cuda")
    rec = dict(cache.get(key))

    def windows():
        out = []
        list(auto_extractor().extract_stream(
            iter(cohort_cases), window="auto",
            stats_callback=lambda i, st: out.append((st["cases"], st["schedule"]))))
        return out

    new = windows()
    cache.put(key, {**rec, "mem_bw": old_bw})
    try:
        old = windows()
    finally:
        cache.put(key, rec)
    check(windows() == new, "the auto stream's windows moved after the record was restored")
    moved = [k for k in range(max(len(new), len(old)))
             if new[k:k + 1] != old[k:k + 1]]
    print(f"[probe] the auto stream over {len(cohort_cases)} cases at the repaired "
          f"{rec['mem_bw'] / 1e12:.3f} TB/s: windows (cases, schedule) {new}; at the old "
          f"{old_bw / 1e12:.3f} TB/s: {old}; "
          + (f"windows {moved} moved" if moved else "no window's close or schedule moved"))


def auto_phase(cohort_cases, frows, fext, sext):
    """Phases 10b and 10c: the auto stream, and choose_schedule against the card."""
    sizes, passes = auto_stream_windows(cohort_cases)
    sweeps0, probes0 = autotune.SWEEPS, autotune.PROBES
    aext = auto_extractor()
    aex = aext.executor
    seen = []
    f0 = dict(aex.transfer_log)
    zero_counts()
    t0 = time.perf_counter()
    arows = list(aext.extract_stream(iter(cohort_cases), window="auto",
                                     stats_callback=lambda i, st: seen.append(st)))
    auto_s = [time.perf_counter() - t0]
    auto_launches = read_counts()
    auto_fetches = fetch_delta(aex.transfer_log, f0)
    check(all(auto_launches[k] > 0 for k in ("marching_cubes", "diameter", "compact",
                                             "firstorder", "glcm", "masked_range")),
          f"a kernel of the auto stream's path never ran: {auto_launches}")
    check(np.array_equal(np.stack(arows), frows),
          "auto stream rows != phase 7's counted/count three-family run")
    check([st["cases"] for st in seen] == sizes, "the auto stream's windows moved")
    windows = split(cohort_cases, sizes)
    print(f"[auto] extract_stream(window='auto') over {len(cohort_cases)} cases, "
          f"schedule='auto', prep='hint', families {FAMS}: {auto_s[0]:.3f} s = "
          f"{len(cohort_cases) / auto_s[0]:.3f} cases/s; rows == phase 7's counted/count run "
          f"bitwise; {len(windows)} windows ({passes} warm pass(es)); launches {auto_launches}")
    print(f"[auto] host_fetches {auto_fetches}")
    # every submit under CUDA sync debugging, the stream's windows driven as
    # it drives them; the cost model's decision recorded per window
    cm = aex.cost_model
    decided, choose = [], cm.choose_schedule
    cm.choose_schedule = lambda metas: decided.append(cm.schedule_costs(metas)) or choose(metas)
    pending, loop_rows, per_window = None, [], []
    try:
        for chunk in windows + [None]:
            state = None
            if chunk is not None:
                f0 = dict(aex.transfer_log)

                def submit():
                    with aex.strict_syncs():
                        return aex.submit_window(chunk)

                queued, state = queued_launches(submit)
                sub_fetches = fetch_delta(aex.transfer_log, f0)
                plan = state.plan.stats()
                want = ({"pass1": len(state.plan.cap_groups)}
                        if plan["schedule"] == "counted" and state.plan.cap_groups else {})
                check(sub_fetches == want, f"an auto submit fetched {sub_fetches}, "
                                           f"not the {plan['schedule']} schedule's {want}")
                per_window.append({"cases": len(chunk), "shape": plan["shape_buckets"],
                                   "cap": plan["cap_buckets"], "schedule": plan["schedule"],
                                   "queued": queued, "costs": decided[-1]})
            if pending is not None:
                loop_rows += aex.collect_window(pending)[0]
            pending = state
    finally:
        del cm.choose_schedule
    check(np.array_equal(np.stack(loop_rows), frows), "the strict-sync loop's rows differ")
    check_no_sweep(sweeps0, "auto")
    check_no_probe(probes0, "auto")
    print("[auto] every submit under CUDA sync debugging ('error'): no host sync but the "
          "counted schedule's own pass-1 fetches; per window (cases, shape/cap buckets, "
          "resolved schedule, launches and copies queued): "
          + "; ".join(f"{w['cases']} {w['shape']}/{w['cap']} {w['schedule']} {w['queued']}"
                      for w in per_window))
    print(f"[auto] resolved schedules {dict(collections.Counter(w['schedule'] for w in per_window))}, "
          f"the most queued in one window {max(w['queued'] for w in per_window)}")
    # cases/s: the auto stream against phase 7's run and 7b's fixed-window stream
    run_s, fixed_s = [], []
    for which in ("auto", "counted", "fixed", "fixed", "counted", "auto"):
        t0 = time.perf_counter()
        if which == "counted":
            fext.run(cohort_cases)
        else:
            ext, window = (aext, "auto") if which == "auto" else (sext, STREAM_WINDOW)
            for _ in ext.extract_stream(iter(cohort_cases), window=window):
                pass
        {"auto": auto_s, "counted": run_s, "fixed": fixed_s}[which].append(
            time.perf_counter() - t0)
    n = len(cohort_cases)
    print(f"[auto] cases/s over the {n} cases, rounds in order auto stream, run (counted/count), "
          f"stream (window={STREAM_WINDOW}, static/hint), the same, run, auto stream: auto "
          f"{[round(n / t, 3) for t in auto_s[1:]]} (counted run {n / auto_s[0]:.3f}), run "
          f"counted/count {[round(n / t, 3) for t in run_s]}, fixed-window stream "
          f"{[round(n / t, 3) for t in fixed_s]}; auto / run {ratio(sum(run_s), sum(auto_s[1:]))}x, "
          f"auto / fixed stream {ratio(sum(fixed_s), sum(auto_s[1:]))}x")
    check_no_sweep(sweeps0, "auto")

    # 10c. choose_schedule against the card: each window under both fixed schedules
    cext = BatchedExtractor(families=FAMS, schedule="counted", prep="hint")
    # the static lists swept by seqacc alone, an extent sweep whatever the
    # tuned variant of the key
    seq_ext = BatchedExtractor(families=FAMS, schedule="static", prep="hint", variant="seqacc")
    rows_out = 0
    for k, (chunk, w) in enumerate(zip(windows, per_window)):
        turns = {"counted": [], "static": []}
        for name in ("counted", "static", "static", "counted"):
            s0 = autotune.SWEEPS
            t0 = time.perf_counter()
            rows, _ = (cext if name == "counted" else sext).run(chunk)
            if autotune.SWEEPS == s0:  # a turn that swept a key is not timed
                turns[name].append(time.perf_counter() - t0)
            check(np.array_equal(np.stack(rows), frows[rows_out:rows_out + len(chunk)]),
                  f"window {k} under {name}: rows differ")
        check(all(turns.values()), f"window {k}: every turn of a schedule swept")
        walls = {name: statistics.median(t) for name, t in turns.items()}
        rows_out += len(chunk)
        # the device time the model prices: pass 2b's sweeps (and the rest)
        sweep_us, busy_us = {}, {}
        for name, ext in (("counted", cext), ("static", sext), ("static/seqacc", seq_ext)):
            per_kernel, _ = device_trace(lambda: ext.run(chunk), reps=3)
            sweep_us[name] = sum(us for key, us in per_kernel.items() if "diameter" in key)
            busy_us[name] = sum(per_kernel.values())
        sync_us = w["costs"]["groups"] * cm.sync_cost_us()
        device = {s_: sweep_us[s_] + (sync_us if s_ == "counted" else 0.0)
                  for s_ in ("counted", "static")}
        modeled = min(("counted", "static"), key=lambda s_: (w["costs"][s_], s_ != "counted"))

        def pick(d):
            return min(d, key=d.get)

        print(f"[choose] window {k} ({len(chunk)} cases, {w['cap']} cap groups): modeled "
              f"counted {w['costs']['counted']:.2f} us ({sync_us:.2f} of it fetches), static "
              f"{w['costs']['static']:.2f} us -> {w['schedule']}; measured pass-2b sweeps "
              f"(device) counted {sweep_us['counted']:.2f} us + the fetches, static "
              f"{sweep_us['static']:.2f} us -> {pick(device)} (model "
              f"{'agrees' if modeled == pick(device) else 'disagrees'}), static with every "
              f"list swept by seqacc {sweep_us['static/seqacc']:.2f} us; all device work "
              f"counted {busy_us['counted']:.2f} us, static {busy_us['static']:.2f} us; wall "
              f"(median of 2 turns) counted {walls['counted'] * 1e3:.3f} ms, static "
              f"{walls['static'] * 1e3:.3f} ms -> {pick(walls)} (model "
              f"{'agrees' if modeled == pick(walls) else 'disagrees'})")
        # the static targets' own tuner keys: the tuned sweeps as fast as the
        # same lists swept by seqacc alone, within 10%
        check(sweep_us["static"] <= STATIC_SWEEP_LIMIT * sweep_us["static/seqacc"],
              f"window {k}: the tuned static pass-2b sweeps take {sweep_us['static']:.2f} us, "
              f"over {STATIC_SWEEP_LIMIT}x seqacc's {sweep_us['static/seqacc']:.2f} us")
        print(f"[choose] window {k}: tuned static sweeps / seqacc alone "
              f"{ratio(sweep_us['static'], sweep_us['static/seqacc'])}x (limit "
              f"{STATIC_SWEEP_LIMIT}x)")


def serve_phase():
    """Phase 10d: the service, 4 clients x 6 requests of 2 cases."""
    cases, doomed, plug_case, poison_at = serve_traffic()
    reqs = client_requests(cases, poison_at)
    bx = BatchedExtractor(schedule="static", prep="hint", families=FAMS)
    want = np.stack(list(bx.extract_stream(iter(cases + doomed + [plug_case]),
                                           window=STREAM_WINDOW)))

    def drive(svc, lat, results):
        def client(c):
            for r, (idx, batch) in enumerate(reqs[c]):
                res = svc.submit(batch, tenant=f"client-{c}").result(timeout=600)
                lat.append(res.latency_s)
                results[c, r] = (idx, res)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        check(not any(t.is_alive() for t in threads), "a service client never finished")

    with bx.serve() as svc:  # untimed: the service's windows are keys of their own
        drive(svc, [], {})
    ex = bx.executor
    served, submit = [], ex.submit_prepped
    ex.submit_prepped = lambda prepped, batch_size=None: served.append(
        submit(prepped, batch_size)) or served[-1]
    lat, results = [], {}
    zero_counts()
    try:
        svc = bx.serve()
        plug = Plug(plug_case)
        f_plug = svc.submit([plug], tenant="plug")
        check(plug.entered.wait(120), "the driver never reached the plug")
        f_dead = svc.submit(doomed, tenant="hurried", deadline_s=0.005)
        time.sleep(0.05)  # the deadline passes while the request is queued
        plug.release.set()
        t0 = time.perf_counter()
        drive(svc, lat, results)
        serve_s = time.perf_counter() - t0
        dead, plugged = f_dead.result(timeout=600), f_plug.result(timeout=600)
        stats = svc.stats()
        svc.close(timeout=600)  # raises the driver's failure, if any
    finally:
        del ex.submit_prepped
    serve_launches = read_counts()
    check(all(serve_launches[k] > 0 for k in ("marching_cubes", "diameter", "compact",
                                              "firstorder", "glcm", "masked_range")),
          f"a kernel of the service's path never ran: {serve_launches}")
    check(set(dead.errors) == {0, 1} and all("DeadlineExceeded" in e for e in dead.errors.values())
          and np.isnan(np.stack(dead.rows)).all() and stats["expired_cases"] == 2,
          f"the expired request: errors {dead.errors}, expired {stats['expired_cases']}")
    check(sum(stats["window_cases"]) == len(cases) + 1,
          f"the windows hold {sum(stats['window_cases'])} cases, not the clients' "
          f"{len(cases)} and the plug")
    check(plugged.ok and np.array_equal(plugged.rows[0], want[-1]), "the plug's row differs")
    for (c, r), (idx, res) in sorted(results.items()):
        for j, i in enumerate(idx):
            if (c, r, j) == poison_at:
                check(list(res.errors) == [j] and "poisoned" in res.errors[j]
                      and np.isnan(res.rows[j]).all(),
                      f"the poisoned case: errors {res.errors}")
                continue
            check(j not in res.errors, f"client {c} request {r} case {j}: {res.errors.get(j)}")
            check(np.array_equal(res.rows[j], want[i]),
                  f"client {c} request {r} case {j}: served row != extract_stream's")
    top = sorted(served, key=lambda w: -w.plan.n_cases)[:3]
    most = 0
    for w in top:
        queued, again = queued_launches(lambda: ex.resubmit_window(w))
        ex.collect_window(again)
        most = max(most, queued)
    lat = np.asarray(lat)
    print(f"[serve] BatchedExtractor(schedule='static', prep='hint', families {FAMS}).serve(): "
          f"{SERVE_CLIENTS} clients x {SERVE_REQUESTS} requests of {SERVE_BATCH} cases "
          f"(mixed_traffic_stream, huge_every={SERVE_HUGE_EVERY}): {len(cases)} cases in "
          f"{serve_s:.3f} s = {len(cases) / serve_s:.3f} cases/s; request latency p50 "
          f"{np.percentile(lat, 50) * 1e3:.3f} ms, p99 {np.percentile(lat, 99) * 1e3:.3f} ms, "
          f"max {lat.max() * 1e3:.3f} ms; launches {serve_launches}")
    print(f"[serve] every served row == extract_stream's bitwise; the poisoned case all NaN "
          f"with its error, its co-tenant bitwise; the expired request {len(doomed)} "
          f"DeadlineExceeded rows, no window slot; {stats['windows']} windows, cases "
          f"{stats['window_cases']}, tenants {stats['window_tenants']}; the most launches and "
          f"copies one served window's submit queues (its three largest re-submitted): {most}")


def cli_phase():
    """Phase 10e: ``python -m repro_torch.launch.serve --smoke`` exits 0."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--smoke"], cwd=root,
                       env=dict(os.environ, PYTHONPATH=str(root / "src")), capture_output=True,
                       text=True, timeout=600)
    for line in (r.stdout + r.stderr).strip().splitlines():
        print(f"[cli] {line}")
    check(r.returncode == 0, f"python -m repro_torch.launch.serve --smoke exited {r.returncode}")
    print(f"[cli] python -m repro_torch.launch.serve --smoke: exit 0 in "
          f"{time.perf_counter() - t0:.3f} s")


class RunnerProbe:
    """The executor a phase-11 runner drives, seen through: records each
    window's raw cases (``windows``: a list of case lists, in submit
    order).  The submit numbered ``spin_at`` runs on a stream of its own,
    with a ``torch.cuda._sleep`` spin of ``spin_cycles`` queued after its
    launches and ahead of its copies into pinned memory (``dropped``: the
    copies' events); a spin ahead of the launches would fill the card's
    launch queue and block the submit itself, and one on the default
    stream would hold up the next collect's own launches.  Re-submits made
    by the executor's retry go to the executor itself and are not
    counted."""

    def __init__(self, ex, spin_at=None, spin_cycles=0):
        self._ex, self._spin_at, self._spin_cycles = ex, spin_at, spin_cycles
        self._cases, self.windows, self.dropped = [], [], []
        self._side = self._kept = None

    def __getattr__(self, name):
        return getattr(self._ex, name)

    def prep_case(self, case):
        self._cases.append(case)
        return self._ex.prep_case(case)

    def submit_prepped(self, prepped, batch_size=None):
        self.windows.append(self._cases[-len(prepped):])
        ex = self._ex
        if len(self.windows) - 1 != self._spin_at:
            return ex.submit_prepped(prepped, batch_size)
        stage = ex._stage_results

        def spin_then_stage(window):
            torch.cuda._sleep(self._spin_cycles)
            return stage(window)

        self._side = torch.cuda.Stream()
        self._side.wait_stream(torch.cuda.current_stream())  # the prepped cases
        ex._stage_results = spin_then_stage
        try:
            with torch.cuda.stream(self._side):
                state = ex.submit_prepped(prepped, batch_size)
        finally:
            del ex._stage_results
        # the window itself is dropped with the run; its inputs, read on the
        # side stream, are kept until the probe goes
        self._kept = prepped
        self.dropped = [f.done for _, f in state.mc_futs]
        return state


def strip_windows(rows):
    """Manifest records without their window ordinals (which restart on a
    resume), sorted by id."""
    return sorted([{k: v for k, v in r.items() if k != "window"} for r in rows],
                  key=lambda r: r["id"])


def soak(out, stream, spin_at=None, spin_cycles=0):
    """Phase 11b's three runs over ``stream`` (``stream_cases(SOAK_CASES,
    seed=0)``, made once) into ``out`` (a directory): A uninterrupted,
    B preempted by a real SIGTERM at case SOAK_PREEMPT with its in-flight
    window dropped (a spin ahead of submit ``spin_at``), C its resume with
    a fresh extractor; every run under the same SOAK_FAULTS plan.  Returns
    the runs' (report, manifest rows, probe, extractor, window census) by
    name and the abandoned window's staged state as C started."""
    runs, abandoned_done = {}, None
    for name in ("A", "B", "C"):
        fp = FaultPlan(**SOAK_FAULTS, preempt_at_case=SOAK_PREEMPT if name == "B" else None)
        ext = BatchedExtractor(schedule="static", prep="hint", transfer_callback=fp.transfer_hook,
                               retry=RetryPolicy(max_retries=3, base_delay=0.01))
        probe = RunnerProbe(ext.executor, spin_at if name == "B" else None, spin_cycles)
        census = {}
        man = RunManifest(out / ("soak_a.jsonl" if name == "A" else "soak_b.jsonl"))
        if name == "C":
            abandoned_done = all(e is None or e.query() for e in runs["B"][2].dropped)
        rep = ResilientRunner(probe, man, window=STREAM_WINDOW, fault_plan=fp,
                              drain_on_preempt=False,
                              stats_callback=lambda w, st: census.__setitem__(w, st)
                              ).run(stream)
        man.close()
        runs[name] = (rep, man.rows(), probe, ext, census)
    return runs, abandoned_done


def cluster_reference(out, stream):
    """Phase 11c's uninterrupted in-process run: the cluster job's own
    configuration (its default variant and retries) over the first
    ``CLUSTER_CASES`` of ``stream``, the cases the job streams; returns its
    manifest rows."""
    ext = BatchedExtractor(variant="seqacc", schedule="static", prep="hint",
                           retry=RetryPolicy(max_retries=2))
    man = RunManifest(out / "cluster_ref.jsonl")
    rep = ResilientRunner(ext, man, window=STREAM_WINDOW).run(stream[:CLUSTER_CASES])
    man.close()
    check(rep.status == "complete" and rep.processed == CLUSTER_CASES,
          f"the uninterrupted cluster run: {rep}")
    return man.rows()


def warm_resilience(out, stream):
    """Phase 1's untimed pass over phase 11's windows: the soak's three runs
    (the retry's re-submit and the resume's windows included) and the
    cluster job's uninterrupted run, whose rows phase 11c compares with,
    over ``stream``.  Returns ``(the soak's abandoned submit, the cluster
    run's rows)``."""
    runs, _ = soak(out / "warm", stream)
    return runs["B"][0].windows, cluster_reference(out, stream)


def soak_cases(threads=8):
    """``list(stream_cases(SOAK_CASES, seed=0))``, phase 11's cases, made on
    ``threads`` threads (numpy and scipy leave the GIL for most of a case):
    case i is the stream's i-th, the names before it skipped."""
    def case(i):
        return next(stream_cases(1, seed=0, skip={f"case-{j:05d}" for j in range(i)}))

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        return list(pool.map(case, range(SOAK_CASES)))


def spawn_cluster(root, manifest, cache_file):
    return subprocess.Popen(
        [sys.executable, *CLUSTER, "--out", str(manifest)], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src"), REPRO_AUTOTUNE_CACHE=cache_file),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def manifest_lines(path):
    return path.read_bytes().count(b"\n") if path.exists() else 0


def resil_phase(out, stream, cohort, frows, sext, abandoned, cluster_rows, cache_file):
    """Phase 11: the resilience layer on the card (11a full width, 11b the
    soak, 11c a real process kill, 11d what it costs)."""
    sweeps0, probes0 = autotune.SWEEPS, autotune.PROBES
    root = Path(__file__).resolve().parent
    t_phase = time.perf_counter()
    # -- 11a. the 60 cases, three families, the whole run under strict syncs
    per_seed = len(cohort) // 3  # the cohort is table2_suite of seeds 0, 1, 2
    names = [f"s{i // per_seed}-{name}" for i, (name, *_) in enumerate(cohort)]
    named = [(n, img, msk, sp) for n, (_, img, msk, sp) in zip(names, cohort)]
    fp = FaultPlan(fail_windows=(1,))
    ext = BatchedExtractor(schedule="static", prep="hint", families=FAMS,
                           transfer_callback=fp.transfer_hook,
                           retry=RetryPolicy(max_retries=2, base_delay=0.01))
    ex = ext.executor
    man = RunManifest(out / "full.jsonl")
    runner = ResilientRunner(ext, man, window=STREAM_WINDOW, fault_plan=fp,
                             feature_names=planlib.feature_names(FAMS))
    f0 = dict(ex.transfer_log)
    zero_counts()
    t0 = time.perf_counter()
    with ex.strict_syncs():
        rep = runner.run(named)
    full_s = time.perf_counter() - t0
    full_launches = read_counts()
    man.close()
    fetches = fetch_delta(ex.transfer_log, f0)
    check(all(full_launches[k] > 0 for k in ("marching_cubes", "diameter", "compact",
                                             "firstorder", "glcm", "masked_range")),
          f"a kernel of the runner's path never ran: {full_launches}")
    check(rep.status == "complete" and rep.processed == len(named) and rep.quarantined == 0
          and rep.window_retries == 1, f"the full-width run: {rep}")
    by_name = {r["name"]: r for r in RunManifest(out / "full.jsonl").__enter__().rows()}
    cols = planlib.feature_names(FAMS)
    got = np.array([[by_name[n]["features"][c] for c in cols] for n in names], np.float32)
    check(np.array_equal(got, frows), "11a: manifest features != phase 7's counted/count rows")
    check(fetches.get("prep", 0) == 0 and fetches.get("pass1", 0) == 0,
          f"11a fetched in prep or pass 1: {fetches}")
    print(f"[resil] 11a ResilientRunner(BatchedExtractor(schedule='static', prep='hint', "
          f"families {FAMS}, retry=RetryPolicy(2)), window={STREAM_WINDOW}) over "
          f"{len(named)} cases, the whole run under CUDA sync debugging ('error'): {full_s:.3f} "
          f"s, {rep.windows} windows, {rep.window_retries} retry (window 1's one-shot fault "
          f"at collect); every manifest row's features == phase 7's counted/count rows "
          f"bitwise as float32; host_fetches {fetches}; launches {full_launches}")

    # -- 11b. the soak: A uninterrupted, B preempted (in-flight window dropped
    # behind a spin), C the resume
    spin = int(SOAK_SPIN_MS * cycles_per_ms())
    t0 = time.perf_counter()
    runs, abandoned_done = soak(out, stream, spin_at=abandoned, spin_cycles=spin)
    soak_s = time.perf_counter() - t0
    (rep_a, rows_a, probe_a, ext_a, census_a) = runs["A"]
    rep_b, rep_c, rows_c = runs["B"][0], runs["C"][0], runs["C"][1]
    ids = [r["id"] for r in rows_c]
    # two emptied masks of one shape are one case by content: the second is skipped
    check(rep_a.status == "complete" and rep_a.processed + rep_a.skipped == SOAK_CASES
          and rep_a.processed == len(rows_a) and rep_a.quarantined > 0, f"soak A: {rep_a}")
    check(rep_b.status == "preempted" and 0 < rep_b.processed < SOAK_CASES, f"soak B: {rep_b}")
    check(len(runs["B"][2].windows) == abandoned + 1, "soak B's abandoned window moved")
    check(abandoned_done is False, "the abandoned window's copies had landed before the resume: "
                                   "the spin did not cover it")
    check(rep_c.status == "complete" and rep_b.processed + rep_c.processed == len(rows_a),
          f"soak C: {rep_c}")
    check(len(ids) == len(rows_a) == len(set(ids)), "soak: a case id lost or duplicated")
    check(rep_b.windows + rep_c.windows <= rep_a.windows + 1,
          f"soak: {rep_b.windows} + {rep_c.windows} windows against A's {rep_a.windows}")
    check(strip_windows(rows_c) == strip_windows(rows_a), "soak: A's records != B + C's")
    check(rep_a.window_retries == 1, f"soak A retried {rep_a.window_retries} times, not once")
    fail_w = SOAK_FAULTS["fail_windows"][0]
    retried = probe_a.windows[fail_w]
    clean, clean_stats = BatchedExtractor(schedule="static", prep="hint").run(retried)
    recs = [rec for rec in rows_a if rec.get("window") == fail_w]
    check(len(recs) == len(clean), f"soak: window {fail_w} holds {len(recs)} records")
    for j, rec in enumerate(recs):
        if rec["status"] == "error":
            check(j in clean_stats["errors"], f"soak: window {fail_w} case {j} quarantined")
            continue
        got = np.array([rec["features"][c] for c in planlib.feature_names()], np.float32)
        check(np.array_equal(got, clean[j]), f"soak: the retried window's case {j} differs")
    flagged = [w for w, _ in rep_a.stragglers]
    check(SOAK_FAULTS["straggle_windows"][0] in flagged, f"soak: stragglers {flagged}")
    for name in ("A", "C"):
        log = runs[name][3].executor.transfer_log
        check(log.get("prep", 0) == 0 and log.get("pass1", 0) == 0,
              f"soak {name} fetched in prep or pass 1: {dict(log)}")
    print(f"[resil] 11b soak over stream_cases({SOAK_CASES}, seed=0), window {STREAM_WINDOW}, "
          f"static/hint, faults {SOAK_FAULTS}: {soak_s:.3f} s for A+B+C; A {rep_a.processed} "
          f"rows ({rep_a.quarantined} quarantined, {rep_a.skipped} a repeat of a case's "
          f"content) in {rep_a.windows} windows, "
          f"{rep_a.cases_per_second:.3f} cases/s; B preempted at case {SOAK_PREEMPT} after "
          f"{rep_b.processed} rows, its window {abandoned} dropped, run on a stream of its own "
          f"with a {SOAK_SPIN_MS} ms spin ahead of its copies (still pending as C began); C "
          f"{rep_c.processed} rows, "
          f"{rep_c.skipped} skipped; B+C == A's records (window ordinals aside), {len(ids)} "
          f"ids, none lost or duplicated; windows B+C {rep_b.windows + rep_c.windows} <= A's "
          f"{rep_a.windows} + 1; A's {rep_a.window_retries} retry absorbed, the retried window's "
          f"rows == a clean run of its cases bitwise; stragglers {flagged}; prep and pass1 "
          f"fetches 0")

    # -- 11c. a real process kill: SIGTERM, then SIGKILL, each resumed
    t0 = time.perf_counter()
    procs, outputs = {}, {}
    paths = {"sigterm": out / "cluster_term.jsonl", "sigkill": out / "cluster_kill.jsonl"}
    try:
        for kind, path in paths.items():
            procs[kind] = spawn_cluster(root, path, cache_file)
        deadline = time.time() + 600
        pending = set(procs)
        while pending and time.time() < deadline:
            for kind in list(pending):
                if manifest_lines(paths[kind]) >= 2 * STREAM_WINDOW:
                    procs[kind].send_signal(15 if kind == "sigterm" else 9)
                    pending.discard(kind)
            time.sleep(0.01)
        check(not pending, f"11c: the cluster job never wrote 2 windows: {pending}")
        killed_at = {}
        for kind, p in procs.items():
            outputs[kind] = [p.communicate(timeout=600)[0]]
            killed_at[kind] = manifest_lines(paths[kind])
            want_rc = 0 if kind == "sigterm" else -9
            check(p.returncode == want_rc, f"11c {kind}: exit {p.returncode}\n{outputs[kind][0]}")
        check("preempted" in outputs["sigterm"][0],
              f"11c: the SIGTERM'd job did not stop as preempted:\n{outputs['sigterm'][0]}")
        for kind, path in paths.items():
            procs[kind] = spawn_cluster(root, path, cache_file)
        for kind, p in procs.items():
            outputs[kind].append(p.communicate(timeout=900)[0])
            check(p.returncode == 0 and "complete:" in outputs[kind][1],
                  f"11c {kind} resume: exit {p.returncode}\n{outputs[kind][1]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    kill_s = time.perf_counter() - t0
    want = strip_windows(cluster_rows)
    for kind, path in paths.items():
        rows = RunManifest(path).__enter__().rows()
        check(len(rows) == len(cluster_rows) == len({r["id"] for r in rows}),
              f"11c {kind}: {len(rows)} records")
        check(strip_windows(rows) == want,
              f"11c {kind}: the resumed manifest != the uninterrupted run's")
    print(f"[resil] 11c python {' '.join(CLUSTER)} in subprocesses (warm cache), two at once: "
          f"SIGTERM at {killed_at['sigterm']} manifest lines (exit 0, preempted), SIGKILL at "
          f"{killed_at['sigkill']} (exit -9), each resumed to the end (exit 0); both manifests "
          f"== the uninterrupted in-process run's {len(cluster_rows)} records (window ordinals "
          f"aside) in {kill_s:.3f} s")
    for kind in paths:
        for k, text in enumerate(outputs[kind]):
            tail = [ln for ln in text.strip().splitlines()
                    if ln.startswith(("complete", "preempted", "resuming"))]
            print(f"[resil] 11c {kind} run {k + 1}: {' | '.join(tail)}")

    # -- 11d. what it costs
    rounds = {"runner": [], "stream": []}
    rext = BatchedExtractor(schedule="static", prep="hint", families=FAMS,
                            retry=RetryPolicy(max_retries=2))
    for k, which in enumerate(("runner", "stream", "stream", "runner")):
        t0 = time.perf_counter()
        if which == "runner":
            m = RunManifest(out / f"cost_{k}.jsonl")
            ResilientRunner(rext, m, window=STREAM_WINDOW,
                            feature_names=planlib.feature_names(FAMS)).run(named)
            m.close()
        else:
            for _ in sext.extract_stream(iter([c[1:] for c in named]), window=STREAM_WINDOW):
                pass
        rounds[which].append(time.perf_counter() - t0)
    n = len(named)
    masks = [(msk, sp) for _, _, msk, sp in named]
    t0 = time.perf_counter()
    for msk, sp in masks:
        RunManifest.case_id(msk, sp)
    hash_us = (time.perf_counter() - t0) / n * 1e6
    mb = sum(np.asarray(msk).nbytes for msk, _ in masks) / n / 2**20
    m = RunManifest(out / "record_cost.jsonl")
    m.resume()
    feats = dict(zip(planlib.feature_names(FAMS), map(float, frows[0])))
    t0 = time.perf_counter()
    for i in range(n):
        m.record(f"id-{i}", "done", name=names[i], features=feats, window=0)
    record_us = (time.perf_counter() - t0) / n * 1e6
    m.close()
    secs = {w: st["seconds"] for w, st in sorted(census_a.items())}
    med = statistics.median(secs.values())
    print(f"[resil] 11d cases/s over the {n} cases, rounds in order runner, stream, stream, "
          f"runner: runner {[round(n / t, 3) for t in rounds['runner']]}, "
          f"extract_stream(window={STREAM_WINDOW}) {[round(n / t, 3) for t in rounds['stream']]}; "
          f"runner / stream {ratio(sum(rounds['stream']), sum(rounds['runner']))}x")
    print(f"[resil] 11d host cost a case: case_id {hash_us:.1f} us (mean mask {mb:.3f} MiB, "
          f"{mb / hash_us * 1e6:.1f} MiB/s), record {record_us:.1f} us ({len(feats)} features)")
    print(f"[resil] 11d soak A's collects (s, * = flagged straggler): "
          + ", ".join(f"w{w} {s_:.4f}{'*' if w in flagged else ''}" for w, s_ in secs.items())
          + f"; the retried window {fail_w}: {secs[fail_w]:.4f} s against the median "
          f"{med:.4f} s ({ratio(secs[fail_w], med)}x)")
    check_no_sweep(sweeps0, "resil")
    check_no_probe(probes0, "resil")
    print(f"[resil] phase 11 took {time.perf_counter() - t_phase:.3f} s")


# -- 13. the LLM scaffold's serving path -------------------------------------

def llm_inputs(cfg, batch, seq, seed=0):
    """Seeded tokens (batch, seq) and the frontend's stub input, if any:
    0.1 + 0.01 N(0, 1), after the reference tests' constant 0.1."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
    n = enc_len_for(seq) if cfg.n_encoder_layers else cfg.frontend_tokens
    if not n:
        return tokens, ()
    stub = (0.1 + 0.01 * rng.standard_normal((batch, n, cfg.d_model))).astype(np.float32)
    return tokens, (torch.from_numpy(stub),)


def llm_forward(model, cfg, tokens, extra, text_only=False):
    """``forward`` on the model's device: (logits on the host, aux)."""
    tokens = tokens.to(model.device)
    extra = [e.to(model.device) for e in extra]
    with torch.inference_mode():
        if cfg.frontend_tokens:
            out = model.forward(tokens) if text_only else model.forward(tokens, extra[0])
        else:
            out = model.forward(tokens, *extra)
    return out[0].float().cpu(), float(out[1])


def llm_cache(model, cfg, batch, max_len, extra, dtype=torch.float32):
    """A cache in ``dtype``, the encoder's cross K/V written where there is one."""
    if cfg.n_encoder_layers:
        cache = model.init_cache(batch, max_len, dtype=dtype, enc_len=extra[0].shape[1])
        with torch.inference_mode():
            return model.prefill_encoder(cache, extra[0].to(model.device))
    return model.init_cache(batch, max_len, dtype=dtype)


def llm_teacher_forced(model, cache, tokens):
    """Every token of ``tokens`` through ``decode_step``: the logits of
    each step, stacked on the sequence axis (on the model's device)."""
    tokens = tokens.to(model.device)
    out = []
    with torch.inference_mode():
        for t in range(tokens.shape[1]):
            logits, cache = model.decode_step(cache, tokens[:, t:t + 1])
            out.append(logits[:, 0])
    return torch.stack(out, dim=1)


def llm_greedy(model, cfg, cache, first, steps, **sampling):
    """``steps`` greedy serve steps from the tokens ``first`` (B, 1), or
    sampled ones where ``sampling`` gives ``make_serve_step`` a
    ``temperature`` and a ``generator``: the tokens (B, steps) and their
    logits (B, steps, vocab_size)."""
    step = make_serve_step(model, **sampling)
    nxt, toks, logits = first.to(model.device), [], []
    for _ in range(steps):
        nxt, lg, cache = step(cache, nxt)
        toks.append(nxt)
        logits.append(lg[:, -1, :cfg.vocab_size])
    return torch.cat(toks, dim=1), torch.stack(logits, dim=1)


def traced_launches(fn):
    """One call of ``fn`` after a warm-up, traced: (kernels launched, their
    device time in us, the call's wall in ms)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    return (sum(e.count for e in events), sum(e.device_time_total for e in events), wall_ms)


def gap_clears(logits, rtol, atol):
    """Where the top-2 gap of ``logits`` (..., vocab) clears ``atol + rtol
    |top1|``: where no near-tie decides the argmax."""
    top2 = logits.float().topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > atol + rtol * top2[..., 0].abs()


def top2_gap_ok(logits, rtol, atol):
    return bool(gap_clears(logits, rtol, atol).all())


def masked_argmax(logits, cfg):
    """Each row's greedy token over ``logits`` (..., vocab_padded), the
    padded slots masked as the serve step masks them."""
    valid = torch.arange(logits.shape[-1], device=logits.device) < cfg.vocab_size
    return torch.where(valid, logits.float(), -1e30).argmax(dim=-1)


def llm_reduced_check(name, capacity, dev):
    """Phase 13a for one architecture: the card against the port's CPU path."""
    cfg = get_config(name).reduced(capacity_factor=capacity)
    if capacity != 8.0:  # groups of 20 over 2 x 24 tokens: the last padded
        cfg = dataclasses.replace(cfg, moe_group_size=LLM_MOE_GROUP)
    b, s, prompt = LLM_SMALL
    cpu = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = get_model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    tokens, extra = llm_inputs(cfg, b, s)
    want, want_aux = llm_forward(cpu, cfg, tokens, extra)
    got, got_aux = llm_forward(card, cfg, tokens, extra)
    check(bool(torch.isfinite(got).all()), f"[models] {name}: card logits not finite")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4,
                               err_msg=f"[models] {name} forward, card vs CPU")
    np.testing.assert_allclose(got_aux, want_aux, rtol=1e-4, atol=1e-4,
                               err_msg=f"[models] {name} aux, card vs CPU")
    line = (f"{name} cf {capacity}: forward max|card - cpu| "
            f"{(got - want).abs().max().item():.3e} (rtol/atol 1e-4), aux {got_aux:.6f}")
    if capacity != 8.0:  # decode groups tokens otherwise: drops differ from forward's
        return line
    text, _ = llm_forward(card, cfg, tokens, extra, text_only=True)
    dec = llm_teacher_forced(card, llm_cache(card, cfg, b, s, extra), tokens).cpu()
    np.testing.assert_allclose(dec.numpy(), text.numpy(), rtol=2e-3, atol=2e-3,
                               err_msg=f"[models] {name} decode vs forward on the card")
    runs = []
    for model in (card, cpu):
        cache = llm_cache(model, cfg, b, s, extra)
        llm_teacher_forced(model, cache, tokens[:, :prompt - 1])
        toks, logits = llm_greedy(model, cfg, cache, tokens[:, prompt - 1:prompt], s - prompt)
        runs.append((toks.cpu(), logits.cpu()))
    (card_toks, _), (cpu_toks, cpu_logits) = runs
    check(top2_gap_ok(cpu_logits, 1e-4, 1e-4), f"[models] {name}: a near-tie decides a step")
    check(torch.equal(card_toks, cpu_toks),
          f"[models] {name}: greedy tokens {card_toks.tolist()} != CPU's {cpu_toks.tolist()}")
    return (line + f"; decode max|dec - fwd| {(dec - text).abs().max().item():.3e} (2e-3); "
            f"{s - prompt} greedy tokens == CPU's")


def models_phase(smi):
    """Phase 13: the LLM scaffold's serving path on the card (printed as
    [models]); fails on any check."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "[models] TF32 must be off for the float32 checks")
    # (a) every architecture, reduced, card against CPU
    t0 = time.perf_counter()
    for name, capacity in [(n, 8.0) for n in list_archs()] + [(n, 1.25) for n in LLM_MOE]:
        print(f"[models] 13a {llm_reduced_check(name, capacity, dev)}")
    print(f"[models] 13a: {len(list_archs()) + len(LLM_MOE)} reduced configurations, float32, "
          f"TF32 off: {time.perf_counter() - t0:.3f} s")

    # (b) qwen3-1.7b at full width, two layers, float32, card against CPU
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(LLM_SERVED), n_layers=2, dtype="float32")
    cpu = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = get_model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    b, s = LLM_WIDE
    tokens, _ = llm_inputs(cfg, b, s, seed=1)
    want, _ = llm_forward(cpu, cfg, tokens, ())
    got, _ = llm_forward(card, cfg, tokens, ())
    check(bool(torch.isfinite(got).all()), "[models] 13b: card logits not finite")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4,
                               err_msg="[models] 13b forward, card vs CPU")
    dec = llm_teacher_forced(card, llm_cache(card, cfg, b, s, ()), tokens).cpu()
    np.testing.assert_allclose(dec.numpy(), got.numpy(), rtol=2e-3, atol=2e-3,
                               err_msg="[models] 13b decode vs forward on the card")
    print(f"[models] 13b {LLM_SERVED} d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
          f"({cfg.vocab_padded} padded), 2 layers, float32, {b} prompts of {s}: forward "
          f"max|card - cpu| {(got - want).abs().max().item():.3e} (rtol/atol 1e-4), decode "
          f"max|dec - fwd| {(dec - got).abs().max().item():.3e} (2e-3); "
          f"{time.perf_counter() - t0:.3f} s")
    del cpu, card, want, got, dec

    # (c) qwen3-1.7b at full width and depth, bf16, served
    t0 = time.perf_counter()
    cfg = get_config(LLM_SERVED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg, device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    b, prompt, gen, max_len = LLM_SERVE
    tokens, _ = llm_inputs(cfg, b, prompt, seed=2)
    tokens = tokens.to(dev)
    prefill = make_prefill_fn(model)
    prefill(tokens)  # the first call pays cuBLAS' set-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        last = prefill(tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    prefill_ms = statistics.median(walls) * 1e3
    cache = model.init_cache(b, max_len, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    filled = llm_teacher_forced(model, cache, tokens)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t1
    dec_last = filled[:, -1:].float()
    first = masked_argmax(dec_last[:, -1], cfg)[:, None]
    t1 = time.perf_counter()
    out, logits = llm_greedy(model, cfg, cache, first, gen)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    # one traced decode step on a cache of its own: kernels, device time, wall
    spare = model.init_cache(b, max_len, dtype=torch.bfloat16)
    with torch.inference_mode():
        step_kernels, step_us, step_ms = traced_launches(
            lambda: model.decode_step(spare, tokens[:, :1]))
        pre_kernels, pre_us, pre_ms = traced_launches(lambda: prefill(tokens))
    del spare
    check(bool(torch.isfinite(last.float()).all() and torch.isfinite(dec_last).all()
               and torch.isfinite(logits.float()).all()), "[models] 13c: logits not finite")
    check(int(out.max()) < cfg.vocab_size and int(first.max()) < cfg.vocab_size,
          f"[models] 13c: a token at or past vocab_size {cfg.vocab_size}: the padded slots "
          f"were not masked")
    check(bool((cache["pos"] == prompt + gen).all()),
          f"[models] 13c: cache positions {cache['pos'].tolist()} != {prompt + gen}")
    gap = (dec_last - last.float()).abs().max().item()
    agree = bool((dec_last.argmax(-1) == last.float().argmax(-1)).all())
    print(f"[models] 13c {LLM_SERVED} full width and depth ({cfg.n_layers} layers, "
          f"{n_params:,} parameters), bf16, {b} requests: prefill fn over {b} x {prompt} "
          f"tokens {prefill_ms:.3f} ms (median of 3 after one warm-up; {[round(w * 1e3, 3) for w in walls]}); "
          f"the prompts by decode into a max_len={max_len} cache {fill_s * 1e3 / prompt:.3f} ms a "
          f"step ({b * prompt / fill_s:.1f} tokens/s); {gen} greedy serve steps "
          f"{gen_s * 1e3 / gen:.3f} ms a step, {b * gen / gen_s:.1f} tokens/s; cache pos "
          f"{cache['pos'].tolist()}; bf16 gap max|decode-filled last logits - prefill fn's| "
          f"{gap:.4f} (not gated), argmax agree {agree}; "
          f"max_memory_allocated {peak:,} B serving, {init_peak:,} B at init; card {smi}")
    SERVE_ONE.update(prefill_ms=prefill_ms, step_ms=gen_s * 1e3 / gen, tokens_s=b * gen / gen_s,
                     peak=peak, step_kernels=step_kernels)
    print(f"[models] 13c traced: a decode step {step_kernels} kernels, device "
          f"{step_us / 1e3:.3f} ms of {step_ms:.3f} ms wall (busy {ratio(step_us / 1e3, step_ms)}); "
          f"the prefill fn {pre_kernels} kernels, device {pre_us / 1e3:.3f} ms of "
          f"{pre_ms:.3f} ms wall (busy {ratio(pre_us / 1e3, pre_ms)})")
    print(f"[models] 13c took {time.perf_counter() - t0:.3f} s")
    del model, prefill, cache, filled, last, logits

    # (d) deepseek-moe-16b at full width, two layers, bf16, one forward
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), n_layers=2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg, device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(0))
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    b, s = LLM_MOE_WIDE
    tokens, _ = llm_inputs(cfg, b, s, seed=3)
    tokens = tokens.to(dev)
    with torch.inference_mode():
        model.forward(tokens)  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, aux = model.forward(tokens)
        torch.cuda.synchronize()
        moe_ms = (time.perf_counter() - t1) * 1e3
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(logits.float()).all()) and bool(torch.isfinite(aux)),
          "[models] 13d: logits not finite")
    cap = moe._capacity(cfg.moe_group_size, cfg.n_experts_per_token, cfg.n_experts,
                        cfg.capacity_factor)
    print(f"[models] 13d deepseek-moe-16b full width ({cfg.n_experts} experts of "
          f"{cfg.moe_d_ff}, top-{cfg.n_experts_per_token}, {cfg.n_shared_experts} shared), "
          f"2 layers, bf16, {b} x {s} tokens in groups of {cfg.moe_group_size} (capacity "
          f"{cap} a group and expert): forward {moe_ms:.3f} ms, aux {float(aux):.6f}, "
          f"max_memory_allocated {peak:,} B in the forwards, {init_peak:,} B at init; card {smi}")
    del model, logits
    torch.cuda.empty_cache()
    print(f"[models] phase 13 took {time.perf_counter() - t_phase:.3f} s")


# -- 14. the LLM scaffold's training path -------------------------------------

def train_batch(cfg, rows, tokens, device, seed=0):
    """Seeded tokens (rows, tokens) and the frontend's stub input, if any
    (0.1 + 0.01 N(0, 1), as phase 13's), on ``device``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (rows, tokens)).astype(np.int32)}
    n = enc_len_for(tokens) if cfg.n_encoder_layers else cfg.frontend_tokens
    if n:
        stub = (0.1 + 0.01 * rng.standard_normal((rows, n, cfg.d_model))).astype(np.float32)
        out["frames" if cfg.n_encoder_layers else "prefix"] = stub
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def train_one_step(model, batch):
    """One ``make_train_step`` step from zero moments at TRAIN_LR: the state,
    the metrics as floats and the step's seconds (host clock, synced)."""
    step = make_train_step(model, RunConfig(learning_rate=TRAIN_LR, warmup_steps=1))
    state = opt.init_opt_state(dict(model.named_parameters()))
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    out = {k: float(v) for k, v in metrics.items()}
    return state, out, time.perf_counter() - t0


def close_on_card(a, b, rtol, atol, what):
    """numpy's ``assert_allclose`` on the card: ``|a - b| <= atol + rtol
    |b|`` everywhere (a NaN fails), ``b`` copied to ``a``'s device; returns
    max |a - b|."""
    a, b = a.detach().float(), b.detach().to(a.device, torch.float32)
    if not b.numel():
        return 0.0
    d = (a - b).abs()
    bad = int((~(d <= atol + rtol * b.abs())).sum())
    check(bad == 0, f"{what}: {bad} of {b.numel()} elements past atol {atol:.3g} + rtol "
                    f"{rtol:g} |b|; max |a - b| {float(d.max()):.3g}")
    return float(d.max())


def train_compare(label, card, cpu, card_step, cpu_step):
    """A step on the card against the CPU's (the tests' tolerances): the
    metrics at rtol 1e-4; every gradient and m at rtol 1e-4 with an atol of
    TRAIN_GRAD_SHARE of the leaf's largest entry, v at twice both; the
    parameters after at atol 2 lr under the gradient floor (the sign of a
    gradient there is rounding), else rtol 1e-4 with atol 1e-6 + lr eps /
    floor.  Compared on the card.  Returns the largest gaps, each over its
    leaf's largest entry (the parameters' absolute)."""
    (cs, cmet, _), (ws, wmet, _) = card_step, cpu_step
    check(set(cmet) == set(wmet), f"{label}: metrics {sorted(cmet)} != {sorted(wmet)}")
    for k, w in wmet.items():
        np.testing.assert_allclose(cmet[k], w, rtol=1e-4, atol=1e-7, err_msg=f"{label} {k}")
    gaps = dict.fromkeys(("grad", "m", "v", "param"), 0.0)
    cpu_params = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        q = cpu_params[name]
        for what, a, b in (("grad", p.grad, q.grad), ("m", cs.m[name], ws.m[name]),
                           ("v", cs.v[name], ws.v[name])):
            k = 2 if what == "v" else 1
            top = max(float(b.abs().max()), 1e-30)
            d = close_on_card(a, b, k * 1e-4, k * TRAIN_GRAD_SHARE * top,
                              f"{label} {what} {name}")
            gaps[what] = max(gaps[what], d / top)
        g = ws.m[name].to(p.device).abs() / (1 - 0.9)
        floor = max(TRAIN_GRAD_SHARE * float(g.max()), 1e-30)
        noisy = g < floor
        a, b = p.detach(), q.detach().to(p.device)
        gaps["param"] = max(gaps["param"],
                            close_on_card(a[~noisy], b[~noisy], 1e-4,
                                          1e-6 + TRAIN_LR * 1e-8 / floor,
                                          f"{label} parameter {name}"),
                            close_on_card(a[noisy], b[noisy], 0.0, 2 * TRAIN_LR,
                                          f"{label} parameter {name} (under the floor)"))
    check(int(cs.step) == int(ws.step) == 1, f"{label}: steps {int(cs.step)}, {int(ws.step)}")
    return gaps


def train_pair(cfg, dev):
    """The same seeded weights on the CPU and on the card."""
    cpu = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = get_model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def train_spans(fn):
    """One call of ``fn`` (a train step) after a warm-up, traced with host
    and device events: each ``train_step.*`` span's host and device ms, and
    the six kernels with the most device time (name, us, calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    spans = {e.key: (e.cpu_time_total / 1e3, e.device_time_total / 1e3) for e in events
             if e.key.startswith("train_step.")}
    kern = sorted((e for e in events if e.self_device_time_total > 0 and not
                   e.key.startswith("train_step.")),
                  key=lambda e: -e.self_device_time_total)
    return {"spans": spans,
            "top": [(e.key, e.self_device_time_total, e.count) for e in kern[:6]]}


def metrics_lines(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def train_phase(smi):
    """Phase 14: the LLM scaffold's training path on the card (printed as
    [train]); fails on any check."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "[train] TF32 must be off for the float32 checks")
    zero_counts()

    # (a) four families, reduced, float32: one step, card against CPU
    t0 = time.perf_counter()
    for name in TRAIN_FAMILIES:
        cfg = get_config(name).reduced(capacity_factor=8.0)
        cpu, card = train_pair(cfg, dev)
        batch = train_batch(cfg, *TRAIN_SMALL, "cpu")
        ws = train_one_step(cpu, batch)
        cs = train_one_step(card, {k: v.to(dev) for k, v in batch.items()})
        gaps = train_compare(f"[train] 14a {name}", card, cpu, cs, ws)
        print(f"[train] 14a {name}: loss {cs[1]['loss']:.6f} (CPU {ws[1]['loss']:.6f}), "
              f"grad_norm {cs[1]['grad_norm']:.6f} (CPU {ws[1]['grad_norm']:.6f}), lr "
              f"{cs[1]['lr']:.6g}, aux {cs[1]['aux']:.6g}; largest gap over the leaf's largest "
              f"entry: grad {gaps['grad']:.2e}, m {gaps['m']:.2e}, v {gaps['v']:.2e}; "
              f"parameters after max|card - cpu| {gaps['param']:.2e}")
    print(f"[train] 14a: {len(TRAIN_FAMILIES)} reduced families, float32, TF32 off: "
          f"{time.perf_counter() - t0:.3f} s")

    # (b) qwen3-1.7b at full width, two layers, float32, card against CPU
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(LLM_SERVED), n_layers=2, dtype="float32")
    cpu, card = train_pair(cfg, dev)
    n_params = sum(p.numel() for p in card.parameters())
    batch = train_batch(cfg, *TRAIN_WIDE, "cpu", seed=1)
    ws = train_one_step(cpu, batch)
    cs = train_one_step(card, {k: v.to(dev) for k, v in batch.items()})
    gaps = train_compare("[train] 14b", card, cpu, cs, ws)
    print(f"[train] 14b {LLM_SERVED} full width, 2 layers ({n_params:,} parameters), float32, "
          f"{TRAIN_WIDE[0]} x {TRAIN_WIDE[1]} tokens: loss {cs[1]['loss']:.6f} (CPU "
          f"{ws[1]['loss']:.6f}), grad_norm {cs[1]['grad_norm']:.6f} (CPU "
          f"{ws[1]['grad_norm']:.6f}); largest gap over the leaf's largest entry: grad "
          f"{gaps['grad']:.2e}, m {gaps['m']:.2e}, v {gaps['v']:.2e}; parameters after "
          f"max|card - cpu| {gaps['param']:.2e}; the step card {cs[2] * 1e3:.3f} ms (first), "
          f"CPU {ws[2]:.3f} s; {time.perf_counter() - t0:.3f} s")
    del cpu, card, cs, ws
    torch.cuda.empty_cache()

    # (c) qwen3-1.7b at full width and depth: 8 steps on one batch
    t0 = time.perf_counter()
    cfg = get_config(LLM_SERVED)
    check(cfg.remat and cfg.dtype == "bfloat16", f"[train] 14c: {cfg.name} remat "
                                                 f"{cfg.remat}, dtype {cfg.dtype}")
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    rows, toks, n_steps = TRAIN_DEEP
    batch = train_batch(cfg, rows, toks, dev, seed=4)
    step = make_train_step(model, RunConfig(learning_rate=3e-4, warmup_steps=2))
    state = opt.init_opt_state(dict(model.named_parameters()))
    losses, walls = [], []
    for _ in range(n_steps):
        t1 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"[train] 14c: losses {losses}")
    check(losses[-1] < losses[0], f"[train] 14c: the 8th loss {losses[-1]} is not below the "
                                  f"first {losses[0]}")
    holder = [state]

    def one():
        holder[0], _ = step(holder[0], batch)

    kernels, busy_us, traced_ms = traced_launches(one)
    spans = train_spans(one)
    med = statistics.median(walls[1:])
    tokens = rows * toks
    flops = 8.0 * n_params * tokens  # 6 N T, and the remat forward's 2 N T
    adamw_bytes = 28.0 * n_params  # p, m, v read and written, g read, float32
    print(f"[train] 14c {LLM_SERVED} full width and depth ({cfg.n_layers} layers, "
          f"{n_params:,} parameters), float32 parameters and moments, bf16 compute, remat, "
          f"{rows} x {toks} tokens, lr 3e-4 (warm-up 2): losses {[round(x, 4) for x in losses]}; "
          f"step ms {[round(w * 1e3, 2) for w in walls]}, median after the first "
          f"{med * 1e3:.3f} ms = {tokens / med:.1f} tokens/s; max_memory_allocated {peak:,} B; "
          f"bounds: {flops / 1e12:.2f} TFLOP at the bf16 dense peak "
          f"{flops / BF16_PEAK * 1e3:.3f} ms, AdamW's {adamw_bytes / 1e9:.2f} GB at "
          f"{H100['mem_bw'] / 1e12:.2f} TB/s {adamw_bytes / H100['mem_bw'] * 1e3:.3f} ms; card {smi}")
    print(f"[train] 14c traced step: {kernels} kernels, device {busy_us / 1e3:.3f} ms of "
          f"{traced_ms:.3f} ms wall (busy {ratio(busy_us / 1e3, traced_ms)}); "
          f"{time.perf_counter() - t0:.3f} s")
    print(f"[train] 14c a step traced with host events too (the profiler's own cost on the "
          f"host): " + "; ".join(
              f"{name} host {h:.3f} ms, device "
              + (f"{d:.3f} ms" if d > 0 else "not measured")
              for name, (h, d) in spans["spans"].items())
          + f"; kernels by device time: " + ", ".join(
              f"{k[:48]} {us / 1e3:.3f} ms x{n}" for k, us, n in spans["top"]))
    del model, step, state, holder, batch
    held = torch.cuda.memory_allocated()
    gc.collect()  # anything 14c left in a reference cycle
    torch.cuda.empty_cache()
    print(f"[train] 14c held after its names are dropped: {held:,} B, "
          f"{torch.cuda.memory_allocated():,} B after a collection")

    # (d) the Trainer at full width (the launcher runs in phase 15f, over every card)
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="repro_train_"))
    try:
        t1 = time.perf_counter()
        cfg = dataclasses.replace(get_config(LLM_SERVED), n_layers=2, dtype="float32")
        rows, seq, first, total = TRAIN_CKPT
        run = RunConfig(steps=total, checkpoint_every=first, warmup_steps=2, learning_rate=3e-4)
        model = get_model(cfg, device=dev)
        n_params = sum(p.numel() for p in model.parameters())
        ckpt_bytes = 12 * n_params + 4  # params, m, v in float32, and the step
        free = shutil.disk_usage(work).free
        print(f"[train] 14d workdir {work}: {free:,} B free before writing; a checkpoint "
              f"{ckpt_bytes:,} B, two kept")
        check(free > 2.2 * ckpt_bytes, f"[train] 14d: {free:,} B free, two checkpoints of "
                                       f"{ckpt_bytes:,} B do not fit")
        trainer = Trainer(model, run, synthetic_data(cfg, rows, seq, device=dev), work / "run")
        timed = {"snapshot": [], "write": []}
        ckpt = trainer.ckpt
        write, save_async, checkpoint_tree = ckpt._write, ckpt.save_async, \
            trainer._checkpoint_tree

        def timed_write(*a):
            t = time.perf_counter()
            write(*a)
            timed["write"].append(time.perf_counter() - t)

        def timed_checkpoint_tree(*a):  # the host copy: the tree assembled on the host ...
            t = time.perf_counter()
            out = checkpoint_tree(*a)
            timed["snapshot"].append(time.perf_counter() - t)
            return out

        def timed_save_async(*a, **k):  # ... and handed to the writer's thread
            t = time.perf_counter()
            save_async(*a, **k)
            timed["snapshot"].append(time.perf_counter() - t)

        ckpt._write, ckpt.save_async = timed_write, timed_save_async
        trainer._checkpoint_tree = timed_checkpoint_tree
        _, state, last = trainer.train(steps=first)
        run1_s = time.perf_counter() - t1
        check(ckpt.latest_step() == first and np.isfinite(last["loss"]),
              f"[train] 14d run 1: latest {ckpt.latest_step()}, last {last}")
        saved = (params_to_reference(model), opt_state_to_reference(model, state))
        del trainer, model, state, ckpt
        gc.collect()  # the timing wrappers tie the trainer into a cycle
        torch.cuda.empty_cache()

        t1 = time.perf_counter()
        model = get_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
        trainer = Trainer(model, run, synthetic_data(cfg, rows, seq, seed=1, device=dev),
                          work / "run")
        t2 = time.perf_counter()
        start, _, state = trainer.resume_or_init()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t2
        check(start == first, f"[train] 14d run 2 resumed at {start}, not {first}")
        got = (params_to_reference(model), opt_state_to_reference(model, state))
        flat_got = dict(zip(["params", "m", "v"], (got[0], got[1].m, got[1].v)))
        flat_want = dict(zip(["params", "m", "v"], (saved[0], saved[1].m, saved[1].v)))
        for what in flat_want:
            for (path, a), (_, b) in zip(_walk(flat_got[what]), _walk(flat_want[what])):
                check(np.array_equal(a, b), f"[train] 14d restored {what} {path} != saved")
        check(int(got[1].step) == first, f"[train] 14d restored step {int(got[1].step)}")
        del got, flat_got
        _, state, last = trainer.train(steps=total)
        run2_s = time.perf_counter() - t1
        steps_logged = [x["step"] for x in metrics_lines(work / "run" / "metrics.jsonl")]
        check(steps_logged == list(range(total)), f"[train] 14d metrics steps {steps_logged}")
        check(trainer.ckpt.all_steps() == [first, total] and int(state.step) == total,
              f"[train] 14d checkpoints {trainer.ckpt.all_steps()}, step {int(state.step)}")
        print(f"[train] 14d Trainer, {LLM_SERVED} full width, 2 layers ({n_params:,} "
              f"parameters), float32, {rows} x {seq + 1} tokens: run 1 {first} steps and a "
              f"checkpoint of {ckpt_bytes:,} B in {run1_s:.3f} s (the host copy "
              f"{sum(timed['snapshot']):.3f} s, the write {sum(timed['write']):.3f} s on its "
              f"thread); run 2 a fresh Trainer resumed at step {start} (restore "
              f"{restore_s:.3f} s; parameters, m, v and step bitwise equal to those saved), "
              f"trained to {total} in {run2_s:.3f} s with a second checkpoint; metrics.jsonl "
              f"steps {steps_logged}; latest_step {trainer.ckpt.latest_step()}; card {smi}")
        del trainer, model, state, saved
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    launches = read_counts()
    check(not any(launches.values()), f"[train] the training path launched a kernel: {launches}")
    print(f"[train] 14d took {time.perf_counter() - t0:.3f} s; the phase launched none of the "
          f"hand kernels (rows 1-11, R); phase 14 took {time.perf_counter() - t_phase:.3f} s")


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


# ---------------------------------------------------------------------------
# phase 15: training over a mesh of slots
# ---------------------------------------------------------------------------

def traced_union(fn):
    """One call of ``fn`` after a warm-up, traced: (device items -- kernels
    and copies --, the device's busy us as the union of every stream's
    intervals, their summed us, the call's wall ms, the streams that ran)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    iv = sorted((e.time_range.start, e.time_range.end, e.device_resource_id)
                for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -np.inf
    for a, b, _ in iv:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return len(iv), busy, sum(b - a for a, b, _ in iv), wall_ms, len({r for _, _, r in iv})


def card_slots(n):
    """A ``data`` mesh of ``n`` slots of the first card."""
    return Mesh([torch.device("cuda", 0)] * n)


def dist_dryrun(dev):
    """15a: every dry-run cell on ``meta``; then qwen3-1.7b's train cell
    on a one-slot mesh against the real model and opt state on the card."""
    t0 = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="repro_dryrun_"))
    recs = []
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            for mk in ("single", "multi"):
                for arch in list_archs():
                    for shape in SHAPES:
                        recs.append(dryrun.run_cell(arch, shape, mk, out_dir=out_dir,
                                                    rules=dryrun.cell_rules(arch, shape)))
        written = len(list(out_dir.glob("*.json")))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    dry_s = time.perf_counter() - t0
    ok = [r for r in recs if r.get("status") == "ok"]
    skipped = [r for r in recs if "skipped" in r]
    check(len(recs) == written == 2 * len(list_archs()) * len(SHAPES)
          and len(ok) + len(skipped) == len(recs), f"[dist] 15a: {len(recs)} cells, {len(ok)} "
          f"ok, {len(skipped)} skipped, {written} files")
    for r in skipped:
        check(r["skipped"] == dryrun.skip_reason(r["arch"], r["shape"])
              and r["shape"] == "long_500k", f"[dist] 15a skipped {r}")
    over = [f"{r['arch']}/{r['shape']}/{r['mesh']}" for r in ok if not r["fits_hbm"]]
    big = max(ok, key=lambda r: r["bytes_per_device"]["total"])
    print(f"[dist] 15a dry run: {len(recs)} cells (10 archs x {len(SHAPES)} shapes x the (16, 16) "
          f"and (2, 16, 16) meshes) on meta in {dry_s:.3f} s: {len(ok)} ok, {len(skipped)} "
          f"skipped with the reference's reason (long_500k on full attention); {len(over)} over "
          f"80 GB a device (parameters, optimizer state, cache and batch; no activations) "
          f"{over}; the largest {big['arch']}/{big['shape']}/{big['mesh']} "
          f"{big['bytes_per_device']['total'] / 1e9:.3f} GB a device")

    t0 = time.perf_counter()
    cfg = get_config(LLM_SERVED)
    one_slot = AbstractMesh((1, 1), ("data", "model"))
    report, cell = dryrun.lower_cell(LLM_SERVED, "train_4k", one_slot)
    model = get_model(cfg, device=dev)
    state = opt.init_opt_state(dict(model.named_parameters()))
    names = {id(p): n for n, p in model.named_parameters()}
    params_abs, (step_abs, m_abs, v_abs) = cell["params"][0], cell["opt_state"][0]
    n_leaves = 0
    for path, _ in tree_paths(model.spec()):
        got = model.leaf(path)
        layers = got if isinstance(got, list) else [got]
        shape = ((len(layers),) if isinstance(got, list) else ()) + tuple(layers[0].shape)
        for what, tree, real in (("parameter", params_abs, layers),
                                 ("m", m_abs, [state.m[names[id(p)]] for p in layers]),
                                 ("v", v_abs, [state.v[names[id(p)]] for p in layers])):
            leaf = get_path(tree, path)
            check(tuple(leaf.shape) == shape and leaf.dtype == real[0].dtype and leaf.is_meta,
                  f"[dist] 15a {what} {'/'.join(path)}: cell {tuple(leaf.shape)} {leaf.dtype}, "
                  f"card {shape} {real[0].dtype}")
        n_leaves += 1
    p_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    o_bytes = sum(t.numel() * t.element_size() for d in (state.m, state.v) for t in d.values())
    o_bytes += state.step.numel() * state.step.element_size()
    held = report["bytes_per_device"]
    check(held["params"] == p_bytes and held["opt_state"] == o_bytes,
          f"[dist] 15a one-slot bytes: cell {held}, card parameters {p_bytes}, opt {o_bytes}")
    check(step_abs.dtype == state.step.dtype and tuple(step_abs.shape) == (), "[dist] 15a step")
    print(f"[dist] 15a {LLM_SERVED} train_4k on a one-slot mesh: {n_leaves} spec leaves (shape "
          f"and dtype of parameter, m and v) == the model and opt state on the card (phase 14c's "
          f"float32 full depth); parameters {p_bytes:,} B and optimizer state {o_bytes:,} B == "
          f"the cell's; its computed terms (data sheet, not measured): compute "
          f"{report['roofline']['compute_s']:.4f} s, memory "
          f"{report['roofline']['memory_s']:.4f} s; "
          f"{time.perf_counter() - t0:.3f} s")
    del model, state, cell
    torch.cuda.empty_cache()


def mean_grads(step):
    """The gradient mean of a DataParallelStep's replicas, added in slot
    order over their count, by parameter name (on the first replica's
    device)."""
    out = {}
    for name, p in step.model.named_parameters():
        acc = None
        for rep in step.replicas:
            g = rep.get_parameter(name).grad.to(p.device)
            acc = g.clone() if acc is None else acc.add_(g)
        out[name] = acc.div_(step.n)
    return out


def compressed_allreduce_twin(mesh):
    """The twin of tests/test_compression_multidevice.py's script over
    ``mesh`` (4 data slots), its assertions held here; every step's output
    and new error as numpy."""
    rng = np.random.default_rng(0)
    G = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))

    def sync(g, e):
        out, ne = compression.compressed_psum_tree({"g": g}, {"g": e}, axis_name="data")
        return out["g"], ne["g"]

    shmap = sharding.shard_map_compat(sync, mesh, (P("data"), P("data")), (P("data"), P("data")))
    err = torch.zeros((4, 64), device=mesh.home)
    acc = np.zeros((64,), np.float32)
    true_acc = np.zeros((64,), np.float32)
    trace = []
    for step in range(30):
        g = G.to(mesh.home) * (1.0 + 0.1 * step)
        out, err = shmap(g, err)
        o, gn = out.cpu().numpy(), g.cpu().numpy()
        trace.append((o, err.cpu().numpy()))
        check(np.abs(o[0] - o[1]).max() <= 1e-6, "[dist] 15d: the shards' means differ")
        acc = acc + o[0]
        true_acc = true_acc + gn.mean(0)
        step_size = float(np.abs(gn).max()) / 127.0
        check(np.abs(o[0] - gn.mean(0)).max() <= 2.0 * step_size,
              f"[dist] 15d step {step}: the reduced mean is over two quantisation steps off")
    drift = np.abs(acc - true_acc).max()
    bound = 4.0 * float(np.abs(G.numpy()).max() * 4.0) / 127.0
    check(drift < bound, f"[dist] 15d: drift {drift} over {bound}")
    return trace, drift, bound


def compress_replica_grads(step, mesh):
    """15d: the int8 error-feedback reduction of each leaf of the
    replicas' last gradients over ``mesh``, against their plain mean; the
    largest gap over the leaf's quantisation step and the seconds."""
    t0 = time.perf_counter()
    worst = 0.0
    plain = mean_grads(step)
    for name in plain:
        def f():
            g = step.replicas[sharding.axis_index("data")].get_parameter(name).grad
            out, _ = compression.compressed_psum_tree(g, compression.init_error_state(g), "data")
            return out

        red = sharding.shard_map_compat(f, mesh, (), P())()
        q_step = max(float(r.get_parameter(name).grad.abs().max()) for r in step.replicas) / 127
        gap = float((red - plain[name]).abs().max())
        check(gap <= q_step * (1 + 1e-5) + 1e-30,
              f"[dist] 15d {name}: compressed mean {gap:.3g} from the plain mean, over one "
              f"quantisation step {q_step:.3g}")
        worst = max(worst, gap / q_step if q_step else 0.0)
    torch.cuda.synchronize()
    return len(plain), worst, time.perf_counter() - t0


def mesh_train(model, batch, mesh, n_steps, run):
    """``n_steps`` DataParallelStep steps over ``mesh``: (step, state,
    losses, step walls in s)."""
    step = make_train_step(model, run, mesh)
    state = step.init_state()
    losses, walls = [], []
    for _ in range(n_steps):
        t1 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t1)
    return step, state, losses, walls


def dist_phase(smi):
    """Phase 15: training over a mesh of slots (printed as [dist]): the dry
    run, a mesh step against one slot, training over the mesh, int8
    compression, GPipe and elastic resume; fails on any check."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    check(not torch.backends.cuda.matmul.allow_tf32, "[dist] TF32 must be off")
    zero_counts()
    held = torch.cuda.memory_allocated()
    gc.collect()  # what earlier phases left in reference cycles
    torch.cuda.empty_cache()
    print(f"[dist] held at the phase's start: {held:,} B, {torch.cuda.memory_allocated():,} B "
          f"after a collection")
    mesh = card_slots(MESH_SLOTS)

    # (a) the dry run
    dist_dryrun(dev)

    # (b) one step over the mesh against one slot: qwen3-1.7b full width, 2 layers, float32
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(LLM_SERVED), n_layers=2, dtype="float32")
    one = get_model(cfg, device=dev)
    mod = get_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(5))
    mod.load_state_dict(one.state_dict())
    batch = train_batch(cfg, *DIST_WIDE, dev, seed=1)
    ws = train_one_step(one, batch)
    run = RunConfig(learning_rate=TRAIN_LR, warmup_steps=1)
    step = make_train_step(mod, run, mesh)
    check(isinstance(step, DataParallelStep) and len(step.replicas) == MESH_SLOTS,
          "[dist] 15b: not a data-parallel step")
    t1 = time.perf_counter()
    st, met = step(step.init_state(), batch)
    met = {k: float(v) for k, v in met.items()}
    cs = (step.gather(st), met, time.perf_counter() - t1)
    grads = mean_grads(step)
    for name, p in mod.named_parameters():
        p.grad = grads[name]
    gaps = train_compare("[dist] 15b", mod, one, cs, ws)
    for rep in step.replicas[1:]:
        check(all(torch.equal(a, b) for a, b in zip(rep.parameters(), mod.parameters())),
              "[dist] 15b: the replicas' parameters differ after the step")
    # the same mesh step again from the same state: bitwise, or at the tolerance
    first = [t.clone() for t in mod.parameters()] + \
        [cs[0].m[n].clone() for n in cs[0].m] + [cs[0].v[n].clone() for n in cs[0].v]
    del cs, grads
    with torch.no_grad():
        mod.load_state_dict(get_model(cfg, device=dev).state_dict())
    step.broadcast()
    st, met2 = step(step.init_state(), batch)
    again = step.gather(st)
    second = [t.detach() for t in mod.parameters()] + \
        [again.m[n] for n in again.m] + [again.v[n] for n in again.v]
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    rerun_gap = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                    for a, b in zip(first, second))
    check(same or rerun_gap <= 1e-4, f"[dist] 15b: a second run of the step is {rerun_gap:.3g} "
                                     f"of a leaf's largest entry from the first")
    del first, second, again
    print(f"[dist] 15b {LLM_SERVED} full width, 2 layers, float32, TF32 off, {DIST_WIDE[0]} x "
          f"{DIST_WIDE[1]} tokens: one step over {MESH_SLOTS} slots of the card against one "
          f"slot: loss {met['loss']:.6f} (one slot {ws[1]['loss']:.6f}), grad_norm "
          f"{met['grad_norm']:.6f} ({ws[1]['grad_norm']:.6f}); largest gap over the leaf's "
          f"largest entry: gradient mean {gaps['grad']:.2e}, m {gaps['m']:.2e}, v "
          f"{gaps['v']:.2e}; parameters after max|mesh - one| {gaps['param']:.2e}; the "
          f"replicas equal; the same step run again from the same state: "
          f"{'bitwise equal' if same else f'{rerun_gap:.3g} of a leaf largest entry apart'} "
          f"(parameters, m, v); {time.perf_counter() - t0:.3f} s")
    del one, mod, step, st, ws
    torch.cuda.empty_cache()

    # (c) training over the mesh: full width, 4 layers, bf16 compute, remat
    t0 = time.perf_counter()
    rows, toks, n_steps, n_layers = DIST_DEEP
    cfg = dataclasses.replace(get_config(LLM_SERVED), n_layers=n_layers)
    check(cfg.remat and cfg.dtype == "bfloat16", f"[dist] 15c: remat {cfg.remat}, {cfg.dtype}")
    batch = train_batch(cfg, rows, toks, dev, seed=4)
    run = RunConfig(learning_rate=3e-4, warmup_steps=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    step, state, losses, walls = mesh_train(model, batch, mesh, n_steps, run)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"[dist] 15c: losses {losses} (finite, the last below the first)")
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], batch)

    items, busy_us, sum_us, traced_ms, streams = traced_union(one_step)
    med = statistics.median(walls[1:])
    tokens = rows * toks

    # (d) compression: the reference test's twin on the card and the CPU, then
    # the replicas' last gradients
    t1 = time.perf_counter()
    card_trace, drift, bound = compressed_allreduce_twin(mesh)
    cpu_trace, _, _ = compressed_allreduce_twin(Mesh(["cpu"] * 4))
    for k, ((co, ce), (po, pe)) in enumerate(zip(card_trace, cpu_trace)):
        check(np.array_equal(co, po) and np.array_equal(ce, pe),
              f"[dist] 15d step {k}: the card's reduction != the CPU's bitwise")
    twin_s = time.perf_counter() - t1
    del holder, state
    torch.cuda.empty_cache()
    n_leaves, worst, comp_s = compress_replica_grads(step, mesh)
    del step
    torch.cuda.empty_cache()

    # the same global batch on one slot
    one_model = get_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    one = make_train_step(one_model, run)
    ostate = opt.init_opt_state(dict(one_model.named_parameters()))
    one_walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        ostate, m = one(ostate, batch)
        float(m["loss"])
        one_walls.append(time.perf_counter() - t1)
    oh = [ostate]

    def one_slot_step():
        oh[0], _ = one(oh[0], batch)

    o_items, o_busy, _, o_ms, _ = traced_union(one_slot_step)
    one_med = statistics.median(one_walls[1:])
    del one_model, one, ostate, oh
    torch.cuda.empty_cache()
    print(f"[dist] 15c {LLM_SERVED} full width, {n_layers} layers ({n_params:,} parameters), "
          f"float32 master and moments laid out by param_shardings, bf16 compute, remat, "
          f"{rows} x {toks} tokens (a row a slot) over {MESH_SLOTS} slots of the card, lr 3e-4: "
          f"losses {[round(x, 4) for x in losses]}; step ms {[round(w * 1e3, 2) for w in walls]}, "
          f"median after the first {med * 1e3:.3f} ms = {tokens / med:.1f} tokens/s; one slot "
          f"on the same global batch {one_med * 1e3:.3f} ms = {tokens / one_med:.1f} tokens/s "
          f"(mesh / one {med / one_med:.3f}x); max_memory_allocated {peak:,} B; card {smi}")
    print(f"[dist] 15c traced mesh step: {items} device items on {streams} streams, busy "
          f"(union) {busy_us / 1e3:.3f} ms (summed {sum_us / 1e3:.3f}) of {traced_ms:.3f} ms wall "
          f"(busy {ratio(busy_us / 1e3, traced_ms)}); one slot: {o_items} items, busy "
          f"{o_busy / 1e3:.3f} of {o_ms:.3f} ms ({ratio(o_busy / 1e3, o_ms)}); launch rate "
          f"{items / traced_ms:.1f} items/ms over the mesh, {o_items / o_ms:.1f} on one slot; "
          f"{time.perf_counter() - t0:.3f} s")
    print(f"[dist] 15d compression: the twin of test_compressed_allreduce_four_workers over "
          f"{MESH_SLOTS} slots of the card, 30 steps, its assertions held (drift {drift:.4g} < "
          f"{bound:.4g}), every step's output and error == {MESH_SLOTS} CPU slots' bitwise "
          f"({twin_s:.3f} s for both); 15c's last gradients ({n_leaves} leaves) through "
          f"compressed_psum_tree over the slots: within {worst:.3f} of a quantisation step of "
          f"the plain mean, {comp_s:.3f} s")
    if torch.cuda.device_count() > 1:
        t1 = time.perf_counter()
        every = make_host_mesh()
        model = get_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        step, state, losses, walls = mesh_train(model, batch, every, n_steps, run)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"[dist] 15c every card: losses {losses}")
        med_all = statistics.median(walls[1:])
        print(f"[dist] 15c over every card {every.shape}: losses "
              f"{[round(x, 4) for x in losses]}; median step {med_all * 1e3:.3f} ms = "
              f"{tokens / med_all:.1f} tokens/s; {time.perf_counter() - t1:.3f} s")
        del model, step, state
        torch.cuda.empty_cache()
    else:
        print("[dist] 15c over every card: one card here; the every-card mesh needs two or more")

    # (e) GPipe: the 28 layers at full width and depth, bf16, 4 stages
    t0 = time.perf_counter()
    cfg = get_config(LLM_SERVED)
    rows, toks, n_micro = DIST_PIPE
    model = get_model(cfg, device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (rows, toks)).astype(np.int64)).to(dev)
    with torch.no_grad():
        x = model.embed["embedding"][tokens].to(torch.bfloat16)
        stacked = stack_named(model, dict(model.named_parameters()))["layers"]
    windows = model.windows()
    check(not windows.any(), f"[dist] 15e: {LLM_SERVED} windows {windows}")
    del model
    torch.cuda.empty_cache()
    pod = Mesh([torch.device("cuda", 0)] * 4, ("pod",))

    def layer_fn(lp, h):
        pos = torch.arange(h.shape[1], device=h.device).expand(h.shape[0], h.shape[1])
        return layer_apply(lp, h, pos, cfg, 0)[0]

    def seq(h):
        for i in range(cfg.n_layers):
            h = layer_fn(sharding.tree_map(lambda p: p[i], stacked), h)
        return h

    def micro():
        return torch.cat([seq(m) for m in x.reshape(n_micro, rows // n_micro, toks, -1)])

    with torch.no_grad():
        got = pipeline_forward(layer_fn, stacked, x, pod, n_micro=n_micro)
        want = micro()
        whole = seq(x)
        check(got.shape == x.shape and torch.isfinite(got.float()).all(), "[dist] 15e output")
        check(torch.equal(got, want), f"[dist] 15e: the pipeline != the stack microbatch by "
                                      f"microbatch, max gap {float((got - want).abs().max())}")
        rel = float((whole.float() - got.float()).norm() / whole.float().norm())
        check(rel <= DIST_PIPE_TOL, f"[dist] 15e: whole batch vs pipeline relative gap {rel}")
        pipe_ms = time_ms(lambda: pipeline_forward(layer_fn, stacked, x, pod, n_micro=n_micro),
                          reps=3, warmup=1)
        micro_ms = time_ms(micro, reps=3, warmup=1)
        whole_ms = time_ms(lambda: seq(x), reps=3, warmup=1)
    print(f"[dist] 15e GPipe: {LLM_SERVED}'s {cfg.n_layers} decoder layers at full width, bf16, "
          f"4 stages of {cfg.n_layers // 4} over 4 slots of the card, n_micro {n_micro}, "
          f"{rows} x {toks} tokens: == the stack microbatch by microbatch bitwise; the whole "
          f"batch's stack within {rel:.3e} (relative Frobenius, bound {DIST_PIPE_TOL}); "
          f"pipeline {pipe_ms:.3f} ms, the microbatched stack {micro_ms:.3f} ms "
          f"({pipe_ms / micro_ms:.3f}x), the whole batch {whole_ms:.3f} ms; "
          f"{time.perf_counter() - t0:.3f} s")
    del stacked, x, got, want, whole
    torch.cuda.empty_cache()

    # (f) elastic: a Trainer over 4 slots checkpoints and stops; elastic_remesh
    # onto 2 slots restores it bitwise and a Trainer there trains on from the
    # tree elastic_remesh returned (not from a second restore)
    t0 = time.perf_counter()
    cfg = get_config(LLM_SERVED).reduced()
    rows, seq_len, first, total = DIST_ELASTIC
    run = RunConfig(steps=total, checkpoint_every=first, warmup_steps=2, learning_rate=3e-4,
                    async_checkpoint=False)
    work = Path(tempfile.mkdtemp(prefix="repro_elastic_"))
    try:
        model = get_model(cfg, device=dev)
        t1 = Trainer(model, run, synthetic_data(cfg, rows, seq_len, device=dev), work / "run",
                     mesh=mesh)
        _, state, last = t1.train(steps=first)
        check(t1.ckpt.latest_step() == first and np.isfinite(last["loss"]),
              f"[dist] 15f run 1: latest {t1.ckpt.latest_step()}, last {last}")
        saved = (params_to_reference(model),
                 opt_state_to_reference(model, t1.step_fn.gather(state)))
        skeleton = checkpoint_skeleton(model)

        def make_shardings(m):
            return checkpoint_shardings(model, m)

        out = elastic_remesh(t1.ckpt, skeleton, make_shardings, devices=[dev] * 2)
        check(out is not None, "[dist] 15f: elastic_remesh found no checkpoint")
        mesh2, step_k, placed, _ = out
        check(step_k == first and mesh2.shape == {"data": 2, "model": 1},
              f"[dist] 15f: step {step_k}, mesh {mesh2.shape}")
        back = sharding.tree_map(lambda s, sh: sh.gather(s, mesh2.home).cpu(), placed,
                                 make_shardings(mesh2))
        flat_got = dict(zip(["params", "m", "v"], (back[0], back[1].m, back[1].v)))
        flat_want = dict(zip(["params", "m", "v"], (saved[0], saved[1].m, saved[1].v)))
        n_cmp = 0
        for what in flat_want:
            for (path, a), (_, b) in zip(_walk(flat_got[what]), _walk(flat_want[what])):
                check(np.array_equal(a.numpy(), b), f"[dist] 15f restored {what} {path}")
                n_cmp += 1
        check(int(back[1].step) == first, f"[dist] 15f restored step {int(back[1].step)}")
        del t1, model, state, back
        m2 = get_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
        t2 = Trainer(m2, run, synthetic_data(cfg, rows, seq_len, seed=1, device=dev),
                     work / "run", mesh=mesh2)
        _, s2, last2 = t2.train(steps=total, restored=(step_k, placed))
        del placed
        steps_logged = [x["step"] for x in metrics_lines(work / "run" / "metrics.jsonl")]
        check(steps_logged == list(range(total)) and [int(s) for s in s2.step.flat] == [total] * 2
              and t2.ckpt.latest_step() == total and np.isfinite(last2["loss"]),
              f"[dist] 15f run 2: steps {steps_logged}, {[int(s) for s in s2.step.flat]}, "
              f"latest {t2.ckpt.latest_step()}")
        elastic_s = time.perf_counter() - t0

        t1_ = time.perf_counter()
        root = Path(__file__).resolve().parent
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", LLM_SERVED, "--smoke",
             "--steps", "4", "--workdir", str(work / "launch")],
            cwd=root, env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
            text=True, timeout=600)
        check(r.returncode == 0, f"[dist] 15f launcher exit {r.returncode}: "
                                 f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
        recs = metrics_lines(work / "launch" / "metrics.jsonl")
        check([x["step"] for x in recs] == [0, 1, 2, 3]
              and all(np.isfinite(x["loss"]) for x in recs), f"[dist] 15f launcher {recs}")
        head = [ln for ln in r.stdout.splitlines() if ln.startswith("[launch] arch")]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[dist] 15f elastic: {LLM_SERVED} reduced, a Trainer over {MESH_SLOTS} slots "
          f"trained {first} steps and checkpointed; elastic_remesh onto the first 2 slots "
          f"resumed at step {step_k} with {n_cmp} leaves (parameters, m, v) and the step bitwise "
          f"equal to those saved; a Trainer on those 2 slots trained on from that tree to "
          f"{total} "
          f"(metrics.jsonl steps {steps_logged}) in {elastic_s:.3f} s; python -m "
          f"repro_torch.launch.train --arch {LLM_SERVED} --smoke --steps 4 (every card: "
          f"{head[0] if head else '?'}) exit 0, steps 0-3, losses "
          f"{[round(x['loss'], 4) for x in recs]}, {time.perf_counter() - t1_:.3f} s")
    torch.cuda.empty_cache()
    launches = read_counts()
    check(not any(launches.values()), f"[dist] the phase launched a hand kernel: {launches}")
    print(f"[dist] the phase launched none of the hand kernels (rows 1-11, R); phase 15 took "
          f"{time.perf_counter() - t_phase:.3f} s")


# ---------------------------------------------------------------------------
# phase 16: tensor parallelism over the 'model' axis
# ---------------------------------------------------------------------------

def tp_mesh(shape):
    """A (data, model) mesh of slots of the first card."""
    data, model = shape
    return grid_mesh([torch.device("cuda", 0)] * (data * model), model)


def ends(fn, limit, what):
    """``fn()`` in a daemon thread, joined with a timeout: its result, or a
    failed check where it has not ended by then (a hang)."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:  # re-raised below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(limit)
    check(not t.is_alive(), f"{what}: did not end within {limit} s (a hang)")
    if err:
        raise err[0]
    return out[0]


def tp_mean_grads(step, model):
    """The rows' gradients of a tensor-parallel step gathered whole by the
    names of ``model``, added in row order over their count."""
    rows = [rep.gathered_grads(model) for rep in step.replicas]
    out = {}
    for name, g in rows[0].items():
        acc = g.clone()
        for r in rows[1:]:
            acc.add_(r[name])
        out[name] = acc.div_(len(rows))
    return out


def slot_bytes(tensors_by_slot):
    """Bytes of each slot's tensors."""
    return [sum(t.numel() * t.element_size() for t in ts) for ts in tensors_by_slot]


def tp_phase(smi):
    """Phase 16: tensor parallelism over the 'model' axis (printed as [tp]):
    a step over (1, 4) and (2, 2) against one slot, serving at full depth
    over (1, 4), training over (1, 4), an MoE forward, and the launcher over
    every card; fails on any check."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    check(not torch.backends.cuda.matmul.allow_tf32, "[tp] TF32 must be off")
    zero_counts()

    # (a) one step over (1, 4) and (2, 2) against one slot: full width, 2 layers, float32
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(LLM_SERVED), n_layers=2, dtype="float32")
    one = get_model(cfg, device=dev)
    batch = train_batch(cfg, *TP_WIDE, dev, seed=1)
    ws = train_one_step(one, batch)
    run = RunConfig(learning_rate=TRAIN_LR, warmup_steps=1)
    lines = []
    for shape in TP_SHAPES:
        mod = get_model(cfg, device=dev)
        step = make_train_step(mod, run, tp_mesh(shape))
        check(isinstance(step, DataParallelStep) and step.n_model == shape[1],
              f"[tp] 16a {shape}: not a tensor-parallel step")
        t1 = time.perf_counter()
        st, met = ends(lambda: step(step.init_state(), batch), TP_HANG_S, f"[tp] 16a {shape}")
        met = {k: float(v) for k, v in met.items()}
        cs = (step.gather(st, dev), met, time.perf_counter() - t1)
        grads = tp_mean_grads(step, mod)
        mod = step.collect(dev)  # the first row's blocks gathered, for the comparison
        for name, p in mod.named_parameters():
            p.grad = grads[name]
        del p  # a loop variable left bound keeps its tensors alive through 16b and 16c
        gaps = train_compare(f"[tp] 16a {shape}", mod, one, cs, ws)
        check(all(torch.equal(a, b) for rep in step.replicas[1:]
                  for a, b in zip(rep.parameters(), step.replicas[0].parameters())),
              f"[tp] 16a {shape}: the data rows' parameters differ after the step")
        first = [t.detach().clone() for t in mod.parameters()] + \
            [cs[0].m[n].clone() for n in cs[0].m] + [cs[0].v[n].clone() for n in cs[0].v]
        del cs, grads, mod
        step.laid.init(0)  # get_model's seed-0 draw, block by block
        st, _ = ends(lambda: step(step.init_state(), batch), TP_HANG_S, f"[tp] 16a {shape} rerun")
        again = step.gather(st, dev)
        mod = step.collect(dev)
        second = [t.detach() for t in mod.parameters()] + \
            [again.m[n] for n in again.m] + [again.v[n] for n in again.v]
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        lines.append(f"{shape}: loss {met['loss']:.6f} (one slot {ws[1]['loss']:.6f}), "
                     f"grad_norm {met['grad_norm']:.6f} ({ws[1]['grad_norm']:.6f}); largest "
                     f"gap over the leaf's largest entry: gradient {gaps['grad']:.2e}, m "
                     f"{gaps['m']:.2e}, v {gaps['v']:.2e}; parameters after max|tp - one| "
                     f"{gaps['param']:.2e}; the data rows equal; run again from the same state "
                     f"{'bitwise equal' if same else 'NOT bitwise equal'} (not gated)")
        del first, second, again, step, st, mod
        torch.cuda.empty_cache()
    print(f"[tp] 16a {LLM_SERVED} full width ({cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_padded} padded), 2 layers, float32, TF32 off, "
          f"{TP_WIDE[0]} x {TP_WIDE[1]} tokens: one step over 4 slots of the card against one "
          f"slot, each ended within {TP_HANG_S} s: " + "; ".join(lines)
          + f"; {time.perf_counter() - t0:.3f} s")
    del one, ws
    torch.cuda.empty_cache()

    # (b) serving over (1, 4): full width and depth, bf16; greedy tokens at 2 layers, float32
    t0 = time.perf_counter()
    b, prompt, n_new = TP_GREEDY
    cfg2 = dataclasses.replace(get_config(LLM_SERVED), n_layers=2, dtype="float32")
    one = get_model(cfg2, device=dev)
    laid = lay_out(get_model(cfg2, device="meta"), tp_mesh((1, 4)))
    toks, _ = llm_inputs(cfg2, b, prompt, seed=5)
    runs = []
    for served in (laid, one):
        cache = served.init_cache(b, prompt + n_new, dtype=torch.float32)
        llm_teacher_forced(served, cache, toks[:, :prompt - 1])
        runs.append(llm_greedy(served, cfg2, cache, toks[:, prompt - 1:prompt], n_new))
    del served, cache
    (tp_toks, _), (one_toks, one_logits) = runs
    check(top2_gap_ok(one_logits, 1e-4, 1e-4), "[tp] 16b: a near-tie decides a greedy step")
    check(torch.equal(tp_toks, one_toks), f"[tp] 16b: greedy tokens over (1, 4) "
                                          f"{tp_toks.tolist()} != one slot's {one_toks.tolist()}")
    del one, laid, runs
    torch.cuda.empty_cache()
    greedy_s = time.perf_counter() - t0

    cfg = dataclasses.replace(get_config(LLM_SERVED), n_layers=TP_SERVE_LAYERS)
    # a remat step's graph can sit in a reference cycle (torch.utils.checkpoint's
    # frames) until Python's collector runs: collect before measuring memory
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    laid = lay_out(get_model(cfg, device="meta", dtype=torch.bfloat16), tp_mesh((1, 4)), seed=0)
    torch.cuda.empty_cache()
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    b, prompt, gen, max_len = TP_SERVE
    tokens, _ = llm_inputs(cfg, b, prompt, seed=2)
    tokens = tokens.to(dev)
    prefill = make_prefill_fn(laid)
    prefill(tokens)  # the first call pays cuBLAS' set-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        last = prefill(tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    prefill_ms = statistics.median(walls) * 1e3
    cache = laid.init_cache(b, max_len, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    filled = llm_teacher_forced(laid, cache, tokens)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t1
    dec_last = filled[:, -1:].float()
    first = masked_argmax(dec_last[:, -1], cfg)[:, None]
    t1 = time.perf_counter()
    out, logits = llm_greedy(laid, cfg, cache, first, gen)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    held = slot_bytes([list(sl.parameters()) + [cache[k][0, m] for k in ("k", "v", "pos")]
                       for m, sl in enumerate(laid.groups[0].slots)])
    spare = laid.init_cache(b, max_len, dtype=torch.bfloat16)
    with torch.inference_mode():
        step_items, step_busy, _, step_ms, _ = traced_union(
            lambda: laid.decode_step(spare, tokens[:, :1]))
    del spare
    check(bool(torch.isfinite(last.float()).all() and torch.isfinite(dec_last).all()
               and torch.isfinite(logits.float()).all()), "[tp] 16b: logits not finite")
    check(int(out.max()) < cfg.vocab_size and int(first.max()) < cfg.vocab_size,
          f"[tp] 16b: a token at or past vocab_size {cfg.vocab_size}")
    pos = [p.tolist() for p in cache["pos"].flat]
    check(all(p == [prompt + gen] * b for p in pos),
          f"[tp] 16b: cache positions {pos} != {prompt + gen}")
    one_ = SERVE_ONE
    print(f"[tp] 16b {LLM_SERVED} full width, {cfg.n_layers} of "
          f"{get_config(LLM_SERVED).n_layers} layers, bf16, laid out "
          f"over (1, 4) slots of the card, {b} requests: prefill fn over {b} x {prompt} tokens "
          f"{prefill_ms:.3f} ms (median of 3; one slot at full depth, 13c: "
          f"{one_.get('prefill_ms', float('nan')):.3f} ms); the prompts by decode into a "
          f"max_len={max_len} cache {fill_s * 1e3 / prompt:.3f} ms a step; {gen} greedy serve "
          f"steps {gen_s * 1e3 / gen:.3f} ms a step, {b * gen / gen_s:.1f} tokens/s (one slot "
          f"at full depth, 13c: {one_.get('step_ms', float('nan')):.3f} ms, "
          f"{one_.get('tokens_s', float('nan')):.1f} tokens/s); cache pos {pos[0]} on every "
          f"slot; each slot holds {held} B (parameters and cache); max_memory_allocated "
          f"{peak:,} B serving on the card for the 4 slots, {init_peak:,} B laying out, "
          f"{base:,} B held before (one slot, 13c: {one_.get('peak', 0):,} B serving); a "
          f"traced decode step {step_items} "
          f"device items (one "
          f"slot, 13c: {one_.get('step_kernels', 0)} kernels), busy "
          f"{step_busy / 1e3:.3f} of {step_ms:.3f} ms ({ratio(step_busy / 1e3, step_ms)}); "
          f"at 2 layers, float32: {n_new} greedy tokens == one slot's ({greedy_s:.3f} s); "
          f"card {smi}; {time.perf_counter() - t0:.3f} s")
    del laid, prefill, cache, filled, last, logits
    torch.cuda.empty_cache()

    # (c) training over (1, 4): full width, 4 layers, bf16 compute, remat
    t0 = time.perf_counter()
    rows, toks_n, n_steps, n_layers = TP_DEEP
    cfg = dataclasses.replace(get_config(LLM_SERVED), n_layers=n_layers)
    check(cfg.remat and cfg.dtype == "bfloat16", f"[tp] 16c: remat {cfg.remat}, {cfg.dtype}")
    batch = train_batch(cfg, rows, toks_n, dev, seed=4)
    run = RunConfig(learning_rate=3e-4, warmup_steps=2)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg, device="meta")  # each slot draws its seed-0 blocks
    step = make_train_step(model, run, tp_mesh((1, 4)))
    state = step.init_state()
    losses, walls = [], []
    for _ in range(n_steps):
        t1 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"[tp] 16c: losses {losses} (finite, the last below the first)")
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], batch)

    items, busy_us, sum_us, traced_ms, streams = traced_union(one_step)
    del holder, state, step, model
    torch.cuda.empty_cache()
    one_model = get_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    one = make_train_step(one_model, run)
    ostate = opt.init_opt_state(dict(one_model.named_parameters()))
    one_walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        ostate, m = one(ostate, batch)
        float(m["loss"])
        one_walls.append(time.perf_counter() - t1)
    oh = [ostate]

    def one_slot_step():
        oh[0], _ = one(oh[0], batch)

    o_items, o_busy, _, o_ms, _ = traced_union(one_slot_step)
    del one_model, one, ostate, oh
    torch.cuda.empty_cache()
    med, one_med = statistics.median(walls[1:]), statistics.median(one_walls[1:])
    tokens = rows * toks_n
    print(f"[tp] 16c {LLM_SERVED} full width, {n_layers} layers, float32 master and moments, "
          f"bf16 compute, remat, {rows} x {toks_n} tokens over (1, 4) slots of the card, lr "
          f"3e-4: losses {[round(x, 4) for x in losses]}; step ms "
          f"{[round(w * 1e3, 2) for w in walls]}, median after the first {med * 1e3:.3f} ms = "
          f"{tokens / med:.1f} tokens/s; one slot on the same batch {one_med * 1e3:.3f} ms = "
          f"{tokens / one_med:.1f} tokens/s (tp / one {med / one_med:.3f}x); "
          f"max_memory_allocated {peak:,} B ({base:,} B held before); traced step: {items} "
          f"device items on {streams} "
          f"streams, busy (union) {busy_us / 1e3:.3f} ms (summed {sum_us / 1e3:.3f}) of "
          f"{traced_ms:.3f} ms ({ratio(busy_us / 1e3, traced_ms)}); one slot {o_items} items, "
          f"busy {o_busy / 1e3:.3f} of {o_ms:.3f} ms ({ratio(o_busy / 1e3, o_ms)}); card {smi}; "
          f"{time.perf_counter() - t0:.3f} s")

    # (d) deepseek-moe-16b at full width, 2 layers: one forward over (1, 4)
    # in float64 and float32 against one slot, then bf16 against one slot's
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), n_layers=2)
    model = get_model(cfg, device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(0))
    b, s = TP_MOE
    tokens, _ = llm_inputs(cfg, b, s, seed=3)
    tokens = tokens.to(dev)
    with torch.inference_mode():
        want, want_aux = model.forward(tokens)
        want = want.float()
    # the same (bf16-rounded) weights in float64, then float32: one slot and
    # laid out; float32's own error is this model's (~4e-4 of the largest
    # logit on one slot), so the layout is held at TP_SHARE in float64
    runs = {}
    for name, dt in (("float64", torch.float64), ("float32", torch.float32)):
        exact = get_model(dataclasses.replace(cfg, dtype=name), device=dev, dtype=dt)
        exact.load_state_dict({k: v.to(dt) for k, v in model.state_dict().items()})
        with torch.inference_mode():
            one_logits, one_aux = exact.forward(tokens)
        laid = lay_out(exact, tp_mesh((1, 4)))
        with torch.inference_mode():
            tp_logits, tp_aux = laid.forward(tokens)
        runs[name] = (one_logits, one_aux, tp_logits, tp_aux)
        del laid, exact
        torch.cuda.empty_cache()

    def share(a, b):  # max |a - b| over b's largest entry, in float64
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    one64, aux64, tp64, taux64 = runs["float64"]
    exact_logits, exact_aux, got32, aux32 = runs["float32"]
    del runs
    share64 = share(tp64, one64)
    aux_rel = abs(float(taux64) - float(aux64)) / abs(float(aux64))
    err_one, err_tp = share(exact_logits, one64), share(got32, one64)
    share32 = share(got32, exact_logits)
    top1_32 = float((got32.argmax(-1) == exact_logits.argmax(-1)).float().mean())
    del got32, tp64, one64
    check(share64 <= TP_SHARE and aux_rel <= TP_SHARE,
          f"[tp] 16d: float64 over (1, 4) max|tp - one| is {share64:.3e} of one slot's largest "
          f"logit, aux {aux_rel:.3e} relative; bound {TP_SHARE}")
    check(err_tp <= TP_F32_BAND * err_one,
          f"[tp] 16d: float32 over (1, 4) is {err_tp:.3e} (of the largest logit) from the "
          f"float64 forward, past {TP_F32_BAND} x one slot's own {err_one:.3e}")
    band = float((want - exact_logits).norm() / exact_logits.norm())
    laid = lay_out(model, tp_mesh((1, 4)))
    with torch.inference_mode():
        laid.forward(tokens)  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got, aux = laid.forward(tokens)
        torch.cuda.synchronize()
        moe_ms = (time.perf_counter() - t1) * 1e3
    got = got.float()
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(aux)), "[tp] 16d: not finite")
    rel = float((got - want).norm() / want.norm())
    off = float((got - exact_logits).norm() / exact_logits.norm())
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    check(rel <= TP_MOE_BF16_REL,
          f"[tp] 16d: the bf16 logits over (1, 4) are {rel:.4g} (relative Frobenius) from one "
          f"slot's bf16 logits, past {TP_MOE_BF16_REL}")
    print(f"[tp] 16d deepseek-moe-16b full width, 2 layers, {b} x {s} tokens over (1, 4) slots "
          f"(each slot {cfg.moe_d_ff // 4} of each expert's {cfg.moe_d_ff}): float64 "
          f"max|tp - one| {share64:.3e} of one slot's largest logit, aux {aux_rel:.2e} relative "
          f"(bound {TP_SHARE}); float32 (TF32 off) from the float64 forward {err_tp:.3e} "
          f"against one slot's own {err_one:.3e} (bound {TP_F32_BAND}x), max|tp - one| "
          f"{share32:.3e}, aux {float(aux32):.8f} (one slot {float(exact_aux):.8f}), top-1 "
          f"agree {top1_32:.4f}; bf16 forward {moe_ms:.3f} ms, against one slot's bf16 "
          f"logits {rel:.3e} relative Frobenius (bound {TP_MOE_BF16_REL}), max|tp - one| "
          f"{float((got - want).abs().max()):.4f}, top-1 agree {top1:.4f}, aux {float(aux):.6f} "
          f"(one slot {float(want_aux):.6f}); gap to the float32 forward of the same weights "
          f"{off:.3e}, one slot's {band:.3e} (not gated); {time.perf_counter() - t0:.3f} s")
    del model, laid, got, want, exact_logits
    torch.cuda.empty_cache()

    # (e) the launcher with --model-parallel over every card
    if torch.cuda.device_count() > 1:
        t0 = time.perf_counter()
        work = Path(tempfile.mkdtemp(prefix="repro_tp_launch_"))
        try:
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch", LLM_SERVED,
                 "--smoke", "--steps", "4", "--model-parallel", "2", "--workdir", str(work)],
                cwd=Path(__file__).resolve().parent, env=dict(os.environ, PYTHONPATH=str(SRC)),
                capture_output=True, text=True, timeout=600)
            check(r.returncode == 0, f"[tp] 16e launcher exit {r.returncode}: "
                                     f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
            recs = metrics_lines(work / "metrics.jsonl")
            check([x["step"] for x in recs] == [0, 1, 2, 3]
                  and all(np.isfinite(x["loss"]) for x in recs), f"[tp] 16e launcher {recs}")
            head = [ln for ln in r.stdout.splitlines() if ln.startswith("[launch] arch")]
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(f"[tp] 16e python -m repro_torch.launch.train --arch {LLM_SERVED} --smoke --steps 4 "
              f"--model-parallel 2 over every card ({head[0] if head else '?'}): exit 0, steps "
              f"0-3, losses {[round(x['loss'], 4) for x in recs]}; "
              f"{time.perf_counter() - t0:.3f} s")
    else:
        print("[tp] 16e the launcher with --model-parallel 2: one card here; it needs two or more")
    launches = read_counts()
    check(not any(launches.values()), f"[tp] the phase launched a hand kernel: {launches}")
    print(f"[tp] the phase launched none of the hand kernels (rows 1-11, R); phase 16 took "
          f"{time.perf_counter() - t_phase:.3f} s")


# ---------------------------------------------------------------------------
# phase 17: tensor parallelism for the hybrid, ssm and encoder-decoder families
# ---------------------------------------------------------------------------

def logits_share(a, b):
    """max |a - b| over b's largest entry, in float64."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def raw_forward(model, tokens, extra):
    """``forward``'s logits on the model's device in its own dtype."""
    with torch.inference_mode():
        return model.forward(tokens, *extra)[0]


def tp2_config(name, dtype="float32"):
    over = {"n_encoder_layers": 2} if get_config(name).n_encoder_layers else {}
    return dataclasses.replace(get_config(name), n_layers=2, dtype=dtype, **over)


def tp2_grads64(model, one64, batch):
    """The float64 gradients of ``model`` (``one64`` itself, or a group of
    shards of it) on ``batch``, by ``one64``'s names, and the loss."""
    b64 = {k: (v.double() if v.is_floating_point() else v) for k, v in batch.items()}
    model.zero_grad(set_to_none=True)
    loss, _ = make_loss_fn(model, RunConfig())(b64)
    loss.backward()
    if model is one64:
        out = {n: p.grad for n, p in one64.named_parameters()}
    else:
        model.sum_region_grads()
        out = model.gathered_grads(one64)
    model.zero_grad(set_to_none=True)
    return out, float(loss.detach())


def grads_gap(got, want) -> float:
    """The largest max|got - want| over the leaf's largest |want|."""
    return max(float((got[n].double() - w.double()).abs().max() / max(float(w.abs().max()), 1e-300))
               for n, w in want.items())


def tp2_family(name, dev):
    """Phase 17a for one architecture: the forward, greedy tokens and a
    train step over each of its meshes against one slot."""
    t0 = time.perf_counter()
    cfg = tp2_config(name)
    one = get_model(cfg, device=dev)
    cfg64 = tp2_config(name, "float64")
    one64 = get_model(cfg64, device=dev, dtype=torch.float64)
    one64.load_state_dict({k: v.double() for k, v in one.state_dict().items()})
    tokens, extra = llm_inputs(cfg, *TP2_FWD, seed=6)
    tokens, extra = tokens.to(dev), [e.to(dev) for e in extra]
    one32, f64 = raw_forward(one, tokens, extra), raw_forward(one64, tokens, extra)
    err_one = logits_share(one32, f64)
    b, prompt, n_new = TP2_GREEDY
    toks, gextra = llm_inputs(cfg, b, prompt + n_new, seed=8)
    runs = []  # one slot's greedy run, then each mesh's: (the laid-out model, tokens, logits)
    for served in [one] + [lay_out(one, tp_mesh(s)) for s in TP2_MODELS[name]]:
        cache = llm_cache(served, cfg, b, prompt + n_new, gextra)
        llm_teacher_forced(served, cache, toks[:, :prompt - 1])
        runs.append((served, *llm_greedy(served, cfg, cache, toks[:, prompt - 1:prompt], n_new)))
        del cache
    _, one_toks, one_logits = runs.pop(0)
    top2 = one_logits.float().topk(2, dim=-1).values
    min_gap = float((top2[..., 0] - top2[..., 1]).min())
    batch = train_batch(cfg, *TP2_WIDE, dev, seed=9)
    g64, loss64 = tp2_grads64(one64, one64, batch)
    ws = train_one_step(one, batch)
    lines = []
    for (laid, tp_toks, _), shape in zip(runs, TP2_MODELS[name]):
        label = f"[tp2] 17a {name} {shape}"
        tp32 = raw_forward(laid, tokens, extra)
        tp64 = raw_forward(lay_out(one64, tp_mesh(shape)), tokens, extra)
        share32, share64 = logits_share(tp32, one32), logits_share(tp64, f64)
        err_tp = logits_share(tp32, f64)
        gap32 = float((tp32.float() - one32.float()).abs().max())
        del tp32, tp64, laid
        check(share64 <= TP_SHARE, f"{label}: float64 max|tp - one| is {share64:.3e} of one "
                                   f"slot's largest logit; bound {TP_SHARE}")
        check(share32 <= TP_SHARE or err_tp <= TP_F32_BAND * err_one,
              f"{label}: float32 max|tp - one| {share32:.3e}, {err_tp:.3e} from the float64 "
              f"forward against one slot's own {err_one:.3e} (bound {TP_F32_BAND}x)")
        check(min_gap > gap32, f"{label}: a greedy step's top-2 gap {min_gap:.3e} is not above "
                               f"the float32 forward's gap {gap32:.3e}")
        check(torch.equal(tp_toks, one_toks), f"{label}: greedy tokens {tp_toks.tolist()} != "
                                              f"one slot's {one_toks.tolist()}")
        mod = get_model(cfg, device=dev)
        step = make_train_step(mod, RunConfig(learning_rate=TRAIN_LR, warmup_steps=1),
                               tp_mesh(shape))
        check(isinstance(step, DataParallelStep) and step.n_model == shape[1],
              f"{label}: not a tensor-parallel step")
        t1 = time.perf_counter()
        st, met = ends(lambda: step(step.init_state(), batch), TP_HANG_S, label)
        met = {k: float(v) for k, v in met.items()}
        cs = (step.gather(st, dev), met, time.perf_counter() - t1)
        grads = tp_mean_grads(step, mod)
        mod = step.collect(dev)  # the first row's blocks gathered, for the comparison
        for pname, p in mod.named_parameters():
            p.grad = grads[pname]
        del p, grads, st
        miss = None
        try:
            gaps = train_compare(label, mod, one, cs, ws)
            check(max(gaps["grad"], gaps["m"], gaps["v"]) <= TP2_GRAD_SHARE,
                  f"{label}: gradient {gaps['grad']:.2e}, m {gaps['m']:.2e}, v {gaps['v']:.2e} "
                  f"of the leaf's largest entry; bound {TP2_GRAD_SHARE}")
            held = (f"gradient {gaps['grad']:.2e}, m {gaps['m']:.2e}, v {gaps['v']:.2e} of the "
                    f"leaf's largest entry, parameters after max|tp - one| {gaps['param']:.2e}")
        except AssertionError as e:
            miss = str(e)[:300]
        # each float32 step's gradients against one slot's float64 ones
        gerr_one = grads_gap({n: p.grad for n, p in one.named_parameters()}, g64)
        gerr_tp = grads_gap({n: p.grad for n, p in mod.named_parameters()}, g64)
        if miss is not None:  # float32's own error: hold the layout in float64, as 16d does
            tp64, l64 = tp2_grads64(lay_out(one64, tp_mesh(shape)).groups[0], one64, batch)
            share = grads_gap(tp64, g64)
            del tp64
            check(share <= TP_SHARE and abs(l64 - loss64) <= 1e-6 * abs(loss64)
                  and gerr_tp <= TP_F32_BAND * gerr_one,
                  f"{label}: float32 missed ({miss}); in float64 the laid-out gradients are "
                  f"{share:.3e} of the leaf's largest entry (bound {TP_SHARE}), losses {l64!r} "
                  f"{loss64!r}; float32 {gerr_tp:.3e} from the float64 gradients against one "
                  f"slot's own {gerr_one:.3e} (bound {TP_F32_BAND}x)")
            held = (f"float32 missed ({miss}); held in float64: the laid-out gradients "
                    f"{share:.3e} of the leaf's largest entry, loss {l64:.12f} (one slot "
                    f"{loss64:.12f})")
        held += (f"; float32 gradients from one slot's float64 ones {gerr_tp:.3e}, one slot's "
                 f"own {gerr_one:.3e}")
        del cs, step, mod
        torch.cuda.empty_cache()
        lines.append(f"{shape}: float64 max|tp - one| {share64:.3e} of the largest logit; "
                     f"float32 max|tp - one| {share32:.3e} ({gap32:.3e} absolute), from the "
                     f"float64 forward {err_tp:.3e} against one slot's own {err_one:.3e}; "
                     f"{n_new} greedy tokens == one slot's (smallest top-2 gap {min_gap:.3e}); "
                     f"step loss {met['loss']:.6f} (one slot {ws[1]['loss']:.6f}), grad_norm "
                     f"{met['grad_norm']:.6f} ({ws[1]['grad_norm']:.6f}); {held}")
    del one, one64, ws, one32, f64, runs, g64
    torch.cuda.empty_cache()
    print(f"[tp2] 17a {name} full width ({cfg.d_model} wide, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_padded} padded), 2 layers"
          f"{', 2 encoder layers' if cfg.n_encoder_layers else ''}, float32, TF32 off: "
          + "; ".join(lines) + f"; {time.perf_counter() - t0:.3f} s")


def tp2_serve(served, cfg, tokens, gen, max_len, extra=()):
    """The prefill fn on ``tokens`` (and ``extra``: a VLM's prefix
    embeddings) (ms, median of 3 after a warm-up; its logits) and ``gen``
    greedy steps from its token into an empty ``max_len`` cache (every step
    reads every slot of the cache): (prefill ms, the last logits, ms a
    step, the tokens, their logits, the cache)."""
    prefill = make_prefill_fn(served)
    prefill(tokens, *extra)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        last = prefill(tokens, *extra)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    first = masked_argmax(last[:, -1], cfg)[:, None]
    cache = served.init_cache(len(tokens), max_len, dtype=torch.bfloat16)
    llm_greedy(served, cfg, cache, first, 2)  # warm-up
    cache = served.init_cache(len(tokens), max_len, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out, logits = llm_greedy(served, cfg, cache, first, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) * 1e3 / gen
    return statistics.median(walls) * 1e3, last, step_ms, out, logits, cache


def tp_families_phase(smi):
    """Phase 17: tensor parallelism over 'model' for hymba, rwkv6 and
    seamless at full width, hymba served at full depth over (1, 4), and
    the train step over a 'pod' axis (printed as [tp2]); fails on any
    check."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    check(not torch.backends.cuda.matmul.allow_tf32, "[tp2] TF32 must be off")
    zero_counts()

    # (a) full width, 2 layers, float32: each family over (1, 4) against one slot
    for name in TP2_MODELS:
        tp2_family(name, dev)

    # (b) hymba-1.5b at full width and depth, bf16, served over (1, 4) and on one slot
    t0 = time.perf_counter()
    cfg = get_config("hymba-1.5b")
    b, prompt, gen, max_len = TP2_SERVE
    tokens, _ = llm_inputs(cfg, b, prompt, seed=10)
    tokens = tokens.to(dev)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = get_model(cfg, device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(0))
    exact = get_model(dataclasses.replace(cfg, dtype="float32"), device=dev)
    exact.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    f32 = make_prefill_fn(exact)(tokens).float()
    del exact
    torch.cuda.empty_cache()
    one = tp2_serve(model, cfg, tokens, gen, max_len)
    with torch.inference_mode():
        o_items, o_busy, _, o_ms, _ = traced_union(lambda: model.decode_step(one[5], tokens[:, :1]))
    one = one[:5]
    torch.cuda.reset_peak_memory_stats()
    laid = lay_out(model, tp_mesh((1, 4)))  # its blocks copied: dropping model frees it
    split_heads = laid.layout.heads
    del model
    torch.cuda.empty_cache()
    prefill_ms, last, step_ms, out, logits, cache = tp2_serve(laid, cfg, tokens, gen, max_len)
    peak = torch.cuda.max_memory_allocated()
    held = slot_bytes([list(sl.parameters()) + [a[0, m] for a in sharding.tree_leaves(cache)]
                       for m, sl in enumerate(laid.groups[0].slots)])
    check(bool(torch.isfinite(last.float()).all() and torch.isfinite(logits.float()).all()),
          "[tp2] 17b: logits not finite")

    def rel(a, b):  # relative Frobenius
        return float((a.float() - b.float()).norm() / b.float().norm())

    # a random hymba's bf16 prefill is far from its float32 one on one slot too
    # (the CPU's 8-layer twins: 0.57-0.87): the layout's may be at most
    # TP_F32_BAND times as far
    gap_tp, gap_one, gap_pair = rel(last, f32), rel(one[1], f32), rel(last, one[1])
    check(gap_tp <= TP_F32_BAND * gap_one,
          f"[tp2] 17b: the bf16 prefill logits over (1, 4) are {gap_tp:.4g} (relative Frobenius) "
          f"from the float32 ones, past {TP_F32_BAND} x one slot's bf16 {gap_one:.4g}")
    check(int(out.max()) < cfg.vocab_size, f"[tp2] 17b: a token at or past vocab_size "
                                           f"{cfg.vocab_size}")
    check(all(p.tolist() == [gen] * b for p in cache["pos"].flat),
          f"[tp2] 17b: cache positions {[p.tolist() for p in cache['pos'].flat]} != {gen}")
    with torch.inference_mode():
        items, busy, _, traced_ms, _ = traced_union(lambda: laid.decode_step(cache, tokens[:, :1]))
    agree = float((out == one[3]).float().mean())
    print(f"[tp2] 17b hymba-1.5b full width and depth ({cfg.n_layers} layers, attention "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads {'split' if split_heads else 'whole on every slot'}"
          f", SSD columns {cfg.ssm_expand * cfg.d_model // 4} a slot), "
          f"bf16, over (1, 4) slots of the card, {b} requests: prefill fn over {b} x {prompt} "
          f"tokens {prefill_ms:.3f} ms (median of 3; one slot {one[0]:.3f} ms); {gen} greedy "
          f"serve steps into a max_len={max_len} cache {step_ms:.3f} ms a step, "
          f"{b * 1e3 / step_ms:.1f} tokens/s (one slot {one[2]:.3f} ms, "
          f"{b * 1e3 / one[2]:.1f} tokens/s; tp / one {step_ms / one[2]:.3f}x); the bf16 prefill "
          f"logits from the float32 ones {gap_tp:.4f} relative Frobenius, one slot's {gap_one:.4f} "
          f"(bound {TP_F32_BAND}x), from one slot's bf16 {gap_pair:.4f}; greedy tokens agree with "
          f"one slot's bf16 run {agree:.4f} (not gated); each slot holds {held} B (parameters "
          f"and cache); max_memory_allocated {peak:,} B serving laid out ({base:,} B held "
          f"before); a traced decode step {items} device items, busy {busy / 1e3:.3f} of "
          f"{traced_ms:.3f} ms ({ratio(busy / 1e3, traced_ms)}); one slot {o_items} items, busy "
          f"{o_busy / 1e3:.3f} of {o_ms:.3f} ms ({ratio(o_busy / 1e3, o_ms)}); card {smi}; "
          f"{time.perf_counter() - t0:.3f} s")
    del laid, cache, last, logits, one, f32
    torch.cuda.empty_cache()

    # (c) the train step over ('pod', 'data', 'model') (2, 1, 2) == over (2, 2), bitwise
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(LLM_SERVED), n_layers=2, dtype="float32")
    batch = train_batch(cfg, *TP2_WIDE, dev, seed=11)
    run = RunConfig(learning_rate=TRAIN_LR, warmup_steps=1)
    outs = []
    for shape in TP2_POD:
        devices = np.empty(4, dtype=object)
        devices[:] = [dev] * 4
        names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
        mod = get_model(cfg, device=dev)
        step = make_train_step(mod, run, Mesh(devices.reshape(shape), names))
        check(step.mesh.shape == {"data": 2, "model": 2}, f"[tp2] 17c {shape}: {step.mesh}")
        st, met = ends(lambda: step(step.init_state(), batch), TP_HANG_S, f"[tp2] 17c {shape}")
        got = step.gather(st, dev)
        mod = step.collect(dev)
        outs.append(([p.detach().clone() for p in mod.parameters()]
                     + [got.m[n] for n in got.m] + [got.v[n] for n in got.v],
                     {k: float(v) for k, v in met.items()}))
        del step, st, got, mod
        torch.cuda.empty_cache()
    (pod_t, pod_m), (dm_t, dm_m) = outs
    same = len(pod_t) == len(dm_t) and all(torch.equal(a, b) for a, b in zip(pod_t, dm_t))
    check(same and pod_m == dm_m, f"[tp2] 17c: the step over {TP2_POD[0]} ('pod', 'data', "
                                  f"'model') is not bitwise the step over {TP2_POD[1]}: metrics "
                                  f"{pod_m} against {dm_m}")
    del outs, pod_t, dm_t
    torch.cuda.empty_cache()
    print(f"[tp2] 17c {LLM_SERVED} full width, 2 layers, float32, {TP2_WIDE[0]} x {TP2_WIDE[1]} "
          f"tokens: a DataParallelStep over a {TP2_POD[0]} ('pod', 'data', 'model') mesh of 4 "
          f"slots of the card (pod folded into 2 data rows) == the step over {TP2_POD[1]} "
          f"('data', 'model'), bitwise: parameters, m, v and the metrics (loss "
          f"{pod_m['loss']:.6f}, grad_norm {pod_m['grad_norm']:.6f}); "
          f"{time.perf_counter() - t0:.3f} s")
    launches = read_counts()
    check(not any(launches.values()), f"[tp2] the phase launched a hand kernel: {launches}")
    print(f"[tp2] the phase launched none of the hand kernels (rows 1-11, R); phase 17 took "
          f"{time.perf_counter() - t_phase:.3f} s")


# ---------------------------------------------------------------------------
# phase 18: a model laid out over 'model' from its own blocks
# ---------------------------------------------------------------------------

def param_bytes(modules) -> int:
    """Bytes of the parameters of ``modules``."""
    return sum(p.numel() * p.element_size() for m in modules for p in m.parameters())


def largest_draw_bytes(cfg) -> int:
    """Bytes of the largest leaf's float32 draw: the one transient a build
    from a seed holds beside the blocks."""
    spec = model_class(cfg).build_spec(cfg)
    return max(4 * int(np.prod(leaf.shape)) for _, leaf in tree_paths(spec)
               if leaf.init == "normal")


def state_bytes(state) -> list:
    """Bytes of each tensor of an ``OptState`` laid out over a mesh."""
    return [t.numel() * t.element_size() for a in sharding.tree_leaves(state) for t in a.flat]


def requested_bytes() -> int:
    """The bytes the live tensors asked the card's caching allocator for:
    ``memory_allocated`` less the allocator's slack (a block past a
    request by up to 1 MiB is handed out whole, and counted so)."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def live_allocations() -> int:
    """The caching allocator's live allocations on the card."""
    return torch.cuda.memory_stats()["allocation.all.current"]


# the most a live allocation holds past its request: a request is rounded
# up to 512 B, and a block whose remainder is at most 1 MiB is not split
ALLOC_SLACK = MIB + 512


def check_slack(label, held, held_req, n_alloc):
    """Fails unless ``held`` (``memory_allocated``) is within the allocator's
    slack of ``held_req`` (the bytes requested) over ``n_alloc`` live
    allocations."""
    check(0 <= held - held_req <= n_alloc * ALLOC_SLACK,
          f"{label}: memory_allocated {held:,} B is past the {held_req:,} B requested by more "
          f"than {n_alloc:,} live allocations x {ALLOC_SLACK:,} B")


def tp_blocks_phase(smi):
    """Phase 18: a model laid out over 'model' from its own blocks, with no
    whole copy on the card (printed as [tp3]): the block draw against the
    whole draw, internvl2-26b served at full width and depth over (1, 4),
    the model-parallel Trainer's held bytes, steps, checkpoint and resumes;
    fails on any check."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    check(not torch.backends.cuda.matmul.allow_tf32, "[tp3] TF32 must be off")
    zero_counts()
    mesh = tp_mesh((1, 4))

    # (a) internvl2-26b at full width, 2 layers, float32: the blocks are the whole draw's
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TP3_MODEL), n_layers=2, dtype="float32")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    laid = lay_out(get_model(cfg, device="meta"), mesh, seed=0)
    torch.cuda.synchronize()
    meta_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    whole = get_model(cfg, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    twin = lay_out(whole, mesh)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t1
    params = dict(whole.named_parameters())
    n_blocks = 0
    for k, sl in enumerate(laid.groups[0].slots):
        for name, p in sl.named_parameters():
            check(torch.equal(p, params[name][laid.groups[0].slices(k, name)]),
                  f"[tp3] 18a: slot {k}'s {name} is not its block of the whole seed-0 draw")
            n_blocks += 1
    del params, whole, p
    torch.cuda.empty_cache()
    b, s = TP3_FWD
    tokens, extra = llm_inputs(cfg, b, s, seed=12)
    tokens, pre = tokens.to(dev), extra[0].to(dev)
    with torch.inference_mode():
        got, aux = laid.forward(tokens, prefix_embeds=pre)
        want, want_aux = twin.forward(tokens, prefix_embeds=pre)
    check(bool(torch.isfinite(got).all()), "[tp3] 18a: logits not finite")
    check(torch.equal(got, want) and float(aux) == float(want_aux),
          f"[tp3] 18a: the forward of the seed's blocks is not bitwise lay_out(whole)'s: "
          f"max|gap| {float((got - want).abs().max()):.3e}")
    shape = tuple(got.shape)
    del laid, twin, got, want
    torch.cuda.empty_cache()
    print(f"[tp3] 18a {TP3_MODEL} full width ({cfg.d_model} wide, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_padded} padded), 2 layers, "
          f"float32, TF32 off, over (1, 4) slots of the card from a meta model and seed 0: "
          f"{n_blocks} blocks == the whole seed-0 draw's, bitwise; the forward on {b} x "
          f"({cfg.frontend_tokens} prefix embeddings + {s} tokens), logits {shape}, bitwise "
          f"lay_out(whole)'s; built in {meta_s:.3f} s (lay_out(whole) {whole_s:.3f} s after "
          f"the whole draw's {draw_s:.3f} s); {time.perf_counter() - t0:.3f} s")

    # (b) internvl2-26b at full width and depth, bf16, served over (1, 4), built from the seed
    t0 = time.perf_counter()
    cfg = get_config(TP3_MODEL)
    gc.collect()
    torch.cuda.empty_cache()
    base, base_req, base_n = torch.cuda.memory_allocated(), requested_bytes(), live_allocations()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    laid = lay_out(get_model(cfg, device="meta", dtype=torch.bfloat16), mesh, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    gc.collect()
    held, held_req = torch.cuda.memory_allocated() - base, requested_bytes() - base_req
    n_alloc = live_allocations() - base_n
    build_peak = torch.cuda.max_memory_allocated() - base
    blocks = param_bytes(laid.shards())
    draw = largest_draw_bytes(cfg)
    check(abs(held_req - blocks) <= MIB,
          f"[tp3] 18b: {held_req:,} B requested after the build ({held:,} B allocated), the "
          f"slots' blocks are {blocks:,} B (bound 1 MiB apart)")
    check_slack("[tp3] 18b", held, held_req, n_alloc)
    check(build_peak <= blocks + draw + GIB,
          f"[tp3] 18b: the build's peak {build_peak:,} B is past the blocks {blocks:,} B + the "
          f"largest float32 draw {draw:,} B + 1 GiB")
    b, prompt, gen, max_len = TP3_SERVE
    tokens, extra = llm_inputs(cfg, b, prompt, seed=13)
    tokens, pre = tokens.to(dev), extra[0].to(dev)
    torch.cuda.reset_peak_memory_stats()
    prefill_ms, last, step_ms, out, logits, cache = tp2_serve(laid, cfg, tokens, gen, max_len,
                                                              (pre,))
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(last.float()).all() and torch.isfinite(logits.float()).all()),
          "[tp3] 18b: logits not finite")
    check(int(out.max()) < cfg.vocab_size, f"[tp3] 18b: a token at or past vocab_size "
                                           f"{cfg.vocab_size}")
    check(all(p.tolist() == [gen] * b for p in cache["pos"].flat),
          f"[tp3] 18b: cache positions {[p.tolist() for p in cache['pos'].flat]} != {gen}")
    n_params = sum(int(np.prod(leaf.shape)) for _, leaf in
                   tree_paths(model_class(cfg).build_spec(cfg)))
    print(f"[tp3] 18b {TP3_MODEL} full width and depth ({cfg.n_layers} layers, "
          f"{n_params:,} parameters), bf16, laid out over (1, 4) slots of the card from a "
          f"meta model and seed 0 in {build_s:.3f} s: after the build {held_req:,} B requested "
          f"from the allocator against the slots' blocks {blocks:,} B ({blocks / 1e9:.2f} GB; "
          f"bound 1 MiB apart), memory_allocated {held:,} B (the allocator's slack "
          f"{held - held_req:,} B over {n_alloc:,} live allocations, bound "
          f"{n_alloc * ALLOC_SLACK:,} B); the build's max_memory_allocated {build_peak:,} B "
          f"against the blocks + the largest float32 draw {draw:,} B + 1 GiB = "
          f"{blocks + draw + GIB:,} B (a whole "
          f"model laid out needs the whole model beside its blocks, >= {2 * blocks:,} B); "
          f"{b} requests of {cfg.frontend_tokens} patch embeddings + {prompt} tokens: prefill "
          f"fn {prefill_ms:.3f} ms (median of 3), {gen} greedy steps into a max_len={max_len} "
          f"cache {step_ms:.3f} ms a step, {b * 1e3 / step_ms:.1f} tokens/s; finite logits, "
          f"every token below vocab_size, tokens not gated (bf16 at this depth); "
          f"max_memory_allocated {peak:,} B serving ({base:,} B held before the phase's build); "
          f"card {smi}; {time.perf_counter() - t0:.3f} s")
    del laid, cache, last, logits, out
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the model-parallel Trainer: qwen3-1.7b at full width, 2 layers, float32 over (1, 4)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(LLM_SERVED), n_layers=2, dtype="float32")
    run = RunConfig(steps=3, checkpoint_every=2, warmup_steps=1, learning_rate=TRAIN_LR,
                    async_checkpoint=False)
    batches = [train_batch(cfg, *TP3_TRAIN, dev, seed=20 + i) for i in range(3)]
    work = Path(tempfile.mkdtemp(prefix="repro_tp3_"))
    try:
        # today's path: the whole seed-0 model drawn on the card and laid out, stepped by hand
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        whole = get_model(cfg, device=dev)
        step = make_train_step(whole, run, mesh)
        st = step.init_state()
        today = torch.cuda.memory_allocated() - base
        want = []
        for i, bt in enumerate(batches):
            st, met = step(st, bt)
            want.append(float(met["loss"]))
            if i == 1:
                want_p = [p.detach().clone() for p in step.laid.groups[0].parameters()]
        want_p3 = [p.detach().clone() for p in step.laid.groups[0].parameters()]
        del whole, step, st, met
        gc.collect()
        torch.cuda.empty_cache()
        base, base_req, base_n = (torch.cuda.memory_allocated(), requested_bytes(),
                                  live_allocations())
        trainer = Trainer(get_model(cfg, device="meta"), run, iter(batches[:2]), work,
                          mesh=mesh)
        _, state = trainer.init_state(0)
        held, held_req = torch.cuda.memory_allocated() - base, requested_bytes() - base_req
        n_alloc = live_allocations() - base_n
        blocks = param_bytes(trainer.step_fn.laid.shards())
        moments = state_bytes(state)
        check(abs(held_req - blocks - sum(moments)) <= MIB,
              f"[tp3] 18c: {held_req:,} B requested after init_state ({held:,} B allocated) "
              f"against the blocks {blocks:,} B + the owned moments {sum(moments):,} B (bound "
              f"1 MiB apart)")
        check_slack("[tp3] 18c", held, held_req, n_alloc)
        one_block = max([p.numel() * p.element_size()
                         for sl in trainer.step_fn.laid.shards() for p in sl.parameters()]
                        + moments)
        del state
        peaks = {}
        checkpoint_tree = trainer._checkpoint_tree

        def measured(state):
            torch.cuda.synchronize()
            peaks["held"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            tree = checkpoint_tree(state)
            peaks["save"] = torch.cuda.max_memory_allocated()
            peaks["copy_s"] = time.perf_counter() - t1
            return tree

        trainer._checkpoint_tree = measured
        _, state, _ = trainer.train(steps=2)
        losses = [json.loads(line)["loss"] for line in
                  (work / "metrics.jsonl").read_text().splitlines()]
        check(losses == want[:2], f"[tp3] 18c: losses {losses} != today's path's {want[:2]}")
        check(all(torch.equal(a, b) for a, b in zip(trainer.step_fn.laid.groups[0].parameters(),
                                                    want_p)),
              "[tp3] 18c: the parameters after step 2 are not bitwise today's path's")
        check(peaks["save"] <= peaks["held"] + one_block,
              f"[tp3] 18c: the save's peak {peaks['save']:,} B is past the held "
              f"{peaks['held']:,} B + one block {one_block:,} B")
        saved = CheckpointManager(work / "ckpt").restore(
            2, checkpoint_skeleton(trainer.model), mmap=True)[0]
        saved = sharding.tree_map(np.array, saved)
        del trainer, state
        gc.collect()
        torch.cuda.empty_cache()

        def same_as_saved(label, params, moments):
            flat = list(zip(sharding.tree_leaves((params, moments.m, moments.v)),
                            sharding.tree_leaves((saved[0], saved[1].m, saved[1].v))))
            check(all(np.array_equal(a, b) for a, b in flat) and
                  int(moments.step) == int(saved[1].step) == 2,
                  f"[tp3] 18c: {label}: the resumed parameters or moments are not the saved "
                  f"ones")

        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        again = Trainer(get_model(cfg, device="meta"), run, iter(batches[2:]), work, mesh=mesh)
        start, _, s2 = again.resume_or_init()
        restore_s = time.perf_counter() - t1
        restore_peak = torch.cuda.max_memory_allocated() - base
        restore_held = torch.cuda.memory_allocated() - base
        check(start == 2, f"[tp3] 18c: resumed at {start}")
        same_as_saved("(1, 4)", params_to_reference(again.step_fn.collect()),
                      opt_state_to_reference(again.model, again.step_fn.gather(s2)))
        one = Trainer(get_model(cfg, device=dev), run, iter(()), work)
        start1, _, s1 = one.resume_or_init()
        check(start1 == 2, f"[tp3] 18c: one slot resumed at {start1}")
        same_as_saved("one slot", params_to_reference(one.model),
                      opt_state_to_reference(one.model, s1))
        del one, s1
        gc.collect()
        torch.cuda.empty_cache()
        s2, met = again.step_fn(s2, batches[2])  # the third step, from the resumed state
        loss3 = float(met["loss"])
        check(loss3 == want[2] and all(
            torch.equal(a, b) for a, b in zip(again.step_fn.laid.groups[0].parameters(),
                                              want_p3)),
              f"[tp3] 18c: the resumed third step (loss {loss3!r}) is not bitwise the "
              f"uninterrupted one ({want[2]!r})")
        del again, s2, met, want_p, want_p3
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[tp3] 18c {LLM_SERVED} full width, 2 layers, float32 master and moments, TF32 off, "
          f"{TP3_TRAIN[0]} x {TP3_TRAIN[1]} tokens, a Trainer over (1, 4) slots of the card from "
          f"a meta model: after init_state {held_req:,} B requested (memory_allocated "
          f"{held:,} B, within {n_alloc:,} live allocations x {ALLOC_SLACK:,} B) == the blocks "
          f"{blocks:,} B + the owned moments {sum(moments):,} B "
          f"(bound 1 MiB; a whole model laid out and kept by its caller, today's path, held "
          f"{today:,} B); 2 steps, losses {losses} "
          f"bitwise today's path's, the parameters after too; the checkpoint at step 2 copied "
          f"to the host in {peaks['copy_s']:.3f} s with max_memory_allocated {peaks['save']:,} "
          f"B against {peaks['held']:,} B held + one block {one_block:,} B; resumed over (1, 4) "
          f"in {restore_s:.3f} s with max_memory_allocated {restore_peak:,} B ({restore_held:,} "
          f"B held after; held + one block {restore_held + one_block:,} B), and on one slot, "
          f"parameters and moments bitwise the saved ones; the third step after the resume "
          f"bitwise the uninterrupted one (loss {want[2]:.6f}); {time.perf_counter() - t0:.3f} s")

    # (d) with 4 cards or more: nemotron-4-15b at full width and depth, float32, over (1, 4) cards
    if torch.cuda.device_count() >= 4:
        t0 = time.perf_counter()
        cfg = get_config(TP3_BIG)
        cards = [torch.device("cuda", i) for i in range(4)]
        try:
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
            step = make_train_step(get_model(cfg, device="meta"),
                                   RunConfig(learning_rate=3e-4, warmup_steps=1),
                                   grid_mesh(cards, 4))
            st, met = step(step.init_state(), train_batch(cfg, *TP3_BIG_BATCH, cards[0], seed=30))
            loss = float(met["loss"])
            peaks_d = [torch.cuda.max_memory_allocated(c) for c in cards]
            outcome = (f"loss {loss:.6f}; max_memory_allocated a card "
                       f"{[f'{x:,}' for x in peaks_d]} B")
            del step, st, met
        except torch.OutOfMemoryError as e:  # printed, not gated: the driver has one card
            outcome = f"out of memory ({str(e)[:200]})"
        gc.collect()
        for c in cards:
            with torch.cuda.device(c):
                torch.cuda.empty_cache()
        print(f"[tp3] 18d {TP3_BIG} full width and depth ({cfg.n_params:,} parameters), "
              f"float32, one step over (1, 4) cards from a meta model on {TP3_BIG_BATCH[0]} x "
              f"{TP3_BIG_BATCH[1]} tokens (not gated): {outcome}; "
              f"{time.perf_counter() - t0:.3f} s")
    else:
        print(f"[tp3] 18d skipped: {torch.cuda.device_count()} card(s), it needs 4")
    launches = read_counts()
    check(not any(launches.values()), f"[tp3] the phase launched a hand kernel: {launches}")
    print(f"[tp3] the phase launched none of the hand kernels (rows 1-11, R); phase 18 took "
          f"{time.perf_counter() - t_phase:.3f} s")


# ---------------------------------------------------------------------------
# phase 19: every architecture one card holds, served at full width and depth
# ---------------------------------------------------------------------------

# the registry architectures not served at full depth before, smallest
# first; arctic-480b needs more cards than one
SERVE_FULL = ("rwkv6-1.6b", "seamless-m4t-large-v2", "granite-3-2b", "minicpm-2b",
              "nemotron-4-15b", "deepseek-moe-16b")
SERVE_FULL_F32 = (2, 16, 8)  # 19a: prompts, prompt tokens, greedy steps, float32
SERVE_FULL_BF16 = (4, 256, 32, 512)  # 19b: prompts, prompt tokens, greedy and sampled steps, max_len
# 19b: the tokens of each prompt decoded into the cache before serving.  A
# decode step reads every slot of the max_len cache whatever it holds, so
# its cost does not depend on this; all 256 took 147 s of the phase for the
# six models (an NVIDIA H100 80GB HBM3 at 700 W)
SERVE_FULL_FILL = 64
SERVE_FULL_TEMP = 0.8  # 19b: the sampled runs' temperature
SERVE_FULL_TOL = 2e-3  # 19a: decode against forward, as 13a-b (the reference's own)
SERVE_FULL_ROOM = GIB  # 19a: free bytes kept for the run beside the parameters and the draw
# 19c: the two-tenant radiomics service example, small
SERVE_CLIENTS_ARGS = ["--viewer-cases", "4", "--cohort-cases", "8", "--cohort-batch", "4"]


def fresh_card() -> int:
    """Collects garbage and empties the card's cache: the bytes still
    allocated after."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def spec_bytes(cfg, itemsize=4) -> int:
    """Bytes of ``cfg``'s parameters at ``itemsize`` bytes an entry."""
    spec = model_class(cfg).build_spec(cfg)
    return itemsize * sum(int(np.prod(leaf.shape)) for _, leaf in tree_paths(spec))


def deepest_f32(cfg, free) -> int:
    """The most layers of ``cfg`` whose float32 parameters, their largest
    leaf's float32 draw and ``SERVE_FULL_ROOM`` fit in ``free`` bytes."""
    for n in range(cfg.n_layers, 0, -1):
        c = dataclasses.replace(cfg, n_layers=n)
        if spec_bytes(c) + largest_draw_bytes(c) + SERVE_FULL_ROOM <= free:
            return n
    return 0


def clone_cache(cache):
    """A copy of a serving cache (dicts and lists of tensors)."""
    if isinstance(cache, dict):
        return {k: clone_cache(v) for k, v in cache.items()}
    if isinstance(cache, list):
        return [clone_cache(v) for v in cache]
    return cache.clone()


# each family's layer functions, which its model looks up by name at every
# call: (module, the forward's layer, the decode step's layer)
FORCED_LAYERS = {"Decoder": (transformer, "layer_apply", "decode_layer"),
                 "RWKV6": (rwkv6, "_layer", "decode_layer"),
                 "EncDec": (encdec, "_decoder_layer", "cross_decoder_layer")}


class LayerForcing:
    """Teacher forcing at every layer of a decode step (phase 19a).  Inside
    ``with LayerForcing(model, tol) as forcing``, :meth:`forward` runs the
    model's forward and records each (decoder) layer's input and output, and
    ``model.decode_step`` runs each layer on the forward's input to it at
    the step's position, in place of the layer below's output, and holds
    its output to the forward's within ``tol`` of the largest |forward|
    entry (the residual stream grows over a deep stack; ``worst``: the
    largest such share).  A random stack of the reference's
    init amplifies a rounding layer by layer, so over a whole depth the
    decode and the forward part by float32's own error; forced, each
    layer's cache write, cache read and mixing is held on its own."""

    def __init__(self, model, tol):
        self.mod, *self.names = FORCED_LAYERS[type(model).__name__]
        self.model, self.tol, self.ins, self.outs, self.worst = model, tol, [], [], 0.0

    def __enter__(self):
        fwd, dec = (getattr(self.mod, n) for n in self.names)

        def forward_layer(*args, **kw):
            out = fwd(*args, **kw)
            self.ins.append(args[1])
            self.outs.append(out[0] if isinstance(out, tuple) else out)
            return out

        def decode_layer(group, lps, xs, *args, **kw):
            caches, i = ((kw.get("caches"), kw.get("i")) if "cross" in self.names[1]
                         else args[:2])
            if caches is None:  # an encoder-decoder's forward runs the same layer
                return dec(group, lps, xs, *args, **kw)
            t = int(caches[0]["pos"][0])
            # (B, 1, d) a position, or (B, d) (rwkv6)
            ys = dec(group, lps, [self.ins[i][:, t:t + 1].reshape(xs[0].shape)], *args, **kw)
            got, want = ys[0].float(), self.outs[i][:, t:t + 1].reshape(ys[0].shape).float()
            share = ((got - want).abs().max() / want.abs().max()).item()
            self.worst = max(self.worst, share)
            check(share <= self.tol, f"forced layer {i}, position {t}: max|decode - forward| "
                                     f"is {share:.3e} of the largest |forward| (> {self.tol})")
            return ys

        self.saved = fwd, dec
        for n, fn in zip(self.names, (forward_layer, decode_layer)):
            setattr(self.mod, n, fn)
        return self

    def __exit__(self, *exc):
        for n, fn in zip(self.names, self.saved):
            setattr(self.mod, n, fn)

    def forward(self, tokens, extra):
        """``llm_forward`` over ``tokens``, each layer's input and output
        recorded for the decode steps that follow."""
        self.ins.clear()
        self.outs.clear()
        return llm_forward(self.model, self.model.cfg, tokens, extra)


def embedding_sensitivity(model, cfg, tokens, extra, logits):
    """The forward's own float32 sensitivity: max |forward - ``logits``|
    with the embedding rows of ``tokens`` scaled by 1 + 2^-23 (about one
    rounding of each), restored after."""
    rows = torch.unique(tokens).to(model.device)
    emb = model.embed["embedding"]
    with torch.no_grad():
        keep = emb[rows].clone()
        emb[rows] = keep * (1 + 2 ** -23)
    try:
        moved, _ = llm_forward(model, cfg, tokens, extra)
    finally:
        with torch.no_grad():
            emb[rows] = keep
    return (moved - logits).abs().max().item()


def serve_full_f32(name, dev):
    """Phase 19a for one architecture: float32 at full width and depth (or
    the deepest depth the card holds beside the largest leaf's draw), TF32
    off, on the card.  The prompt is decoded and 8 greedy tokens served as
    a user runs them; then, with teacher forcing at every layer
    (:class:`LayerForcing`) under one forward over the prompt and those
    tokens, the prompt is decoded again and the 8 serve steps fed the same
    tokens.  Gated: finite logits; every forced layer, the decode's and the
    serve steps' logits == the forward's at ``SERVE_FULL_TOL``, the serve
    steps' tokens == the forward's argmax wherever its top-2 gap clears the
    tolerance, every token below ``vocab_size``.  Printed: the unforced
    decode's gap to the forward and its tokens' agreement with the
    forward's argmax, beside the forward's own float32 sensitivity
    (:func:`embedding_sensitivity`).  An MoE model is gated at capacity 8,
    which drops no token, and its own capacity is printed beside.  Returns
    the line."""
    t0 = time.perf_counter()
    base = get_config(name)
    cfg = dataclasses.replace(base, dtype="float32",
                              **({"capacity_factor": 8.0} if base.n_experts else {}))
    before = fresh_card()
    free, _ = torch.cuda.mem_get_info()
    depth = deepest_f32(cfg, free)
    check(depth > 0, f"[serve_full] 19a {name}: not one float32 layer fits in {free:,} B")
    cfg = dataclasses.replace(cfg, n_layers=depth)
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    held, init_peak = param_bytes([model]), torch.cuda.max_memory_allocated()
    b, prompt, steps = SERVE_FULL_F32
    tokens, extra = llm_inputs(cfg, b, prompt, seed=19)
    got, _ = llm_forward(model, cfg, tokens, extra)
    check(bool(torch.isfinite(got).all()), f"[serve_full] 19a {name}: logits not finite")
    # the path as served, unforced: printed beside the forward's own sensitivity
    sens = embedding_sensitivity(model, cfg, tokens, extra, got)
    cache = llm_cache(model, cfg, b, prompt + steps, extra)
    dec = llm_teacher_forced(model, cache, tokens[:, :prompt - 1]).float().cpu()
    free_toks, _ = llm_greedy(model, cfg, cache, tokens[:, prompt - 1:prompt], steps)
    seq = torch.cat([tokens, free_toks.cpu()], dim=1)
    # every layer forced, one forward over the prompt and those tokens: the gates
    with LayerForcing(model, SERVE_FULL_TOL) as forcing:
        fwd, _ = forcing.forward(seq, extra)
        cache = llm_cache(model, cfg, b, prompt + steps, extra)
        head = llm_teacher_forced(model, cache, seq[:, :prompt - 1]).float().cpu()
        served = [llm_greedy(model, cfg, cache, seq[:, p:p + 1], 1)
                  for p in range(prompt - 1, prompt - 1 + steps)]
    toks = torch.cat([t for t, _ in served], dim=1).cpu()
    logits = torch.cat([lg for _, lg in served], dim=1).float().cpu()
    want = fwd[:, prompt - 1:prompt - 1 + steps, :cfg.vocab_size]
    forced_gap = max((head - fwd[:, :prompt - 1]).abs().max().item(),
                     (logits - want).abs().max().item())
    np.testing.assert_allclose(head.numpy(), fwd[:, :prompt - 1].numpy(), rtol=SERVE_FULL_TOL,
                               atol=SERVE_FULL_TOL,
                               err_msg=f"[serve_full] 19a {name}: forced decode vs forward")
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=SERVE_FULL_TOL,
                               atol=SERVE_FULL_TOL,
                               err_msg=f"[serve_full] 19a {name}: forced serve steps vs forward")
    clear = gap_clears(want, SERVE_FULL_TOL, SERVE_FULL_TOL)
    check(torch.equal(toks[clear], want.argmax(-1)[clear]),
          f"[serve_full] 19a {name}: greedy tokens {toks.tolist()} != the forward's argmax "
          f"{want.argmax(-1).tolist()} where the gap clears ({clear.tolist()})")
    check(bool((cache["pos"] == prompt - 1 + steps).all())
          and max(int(toks.max()), int(free_toks.max())) < cfg.vocab_size,
          f"[serve_full] 19a {name}: cache pos {cache['pos'].tolist()} or a token at or past "
          f"vocab_size {cfg.vocab_size}")
    free_agree = int((seq[:, prompt:] == want.argmax(-1)).sum())
    line = (f"{name} float32, TF32 off, {depth} of {base.n_layers} layers "
            f"({'full depth' if depth == base.n_layers else 'the deepest the card holds'}; "
            f"{held:,} B of parameters, init peak {init_peak:,} B, {before:,} B allocated "
            f"before, {free:,} B free), {b} prompts of {prompt}: finite logits; over the "
            f"prompt and {steps} served tokens, every layer forced: each layer's decode output "
            f"within {forcing.worst:.3e} of the largest |forward| entry (gate "
            f"{SERVE_FULL_TOL}), the decode and serve-step logits max|dec - fwd| "
            f"{forced_gap:.3e} ({SERVE_FULL_TOL}), the serve step's greedy tokens == the "
            f"forward's argmax at all {int(clear.sum())} of {b * steps} steps whose top-2 gap "
            f"clears {SERVE_FULL_TOL}; unforced (not gated): max|dec - fwd| "
            f"{(dec - got[:, :prompt - 1]).abs().max().item():.3e}, {free_agree} of {b * steps} "
            f"greedy tokens "
            f"the forward's argmax, the forward's own sensitivity to its embedding rows "
            f"scaled by 1 + 2^-23 {sens:.3e}")
    if base.n_experts:  # the config's own capacity on the same weights, not gated
        model.cfg = dataclasses.replace(cfg, capacity_factor=base.capacity_factor)
        try:
            low, _ = llm_forward(model, model.cfg, tokens, extra)
        finally:
            model.cfg = cfg
        line += (f"; gated at capacity 8 (no drop); at its own {base.capacity_factor} "
                 f"(groups of {cfg.moe_group_size}, not gated) the forward max|cf "
                 f"{base.capacity_factor} - cf 8| {(low - got).abs().max().item():.3e}")
    return line + f"; {time.perf_counter() - t0:.3f} s"


def serve_full_bf16(name, dev, smi):
    """Phase 19b for one architecture: bf16 at full width and depth, as
    13c serves qwen3-1.7b: the build's peak against the parameters + the
    largest leaf's float32 draw + its cast, the prefill fn over the
    prompts, their first ``SERVE_FULL_FILL`` tokens decoded into the cache,
    greedy steps, and seeded sampled steps run twice from copies of the
    cache, bitwise equal.  Returns the lines to print."""
    t0 = time.perf_counter()
    cfg = get_config(name)
    before = fresh_card()
    print(f"[serve_full] 19b {name}: memory_allocated {before:,} B (requested "
          f"{requested_bytes():,} B) before the build")
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    model = get_model(cfg, device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    held, init_peak = param_bytes([model]), torch.cuda.max_memory_allocated()
    draw = largest_draw_bytes(cfg)
    bound = before + held + draw + draw // 2
    check(init_peak <= bound,
          f"[serve_full] 19b {name}: the build's peak {init_peak:,} B is past {before:,} B "
          f"before + {held:,} B held + the largest draw {draw:,} B + its cast {draw // 2:,} B")
    torch.cuda.reset_peak_memory_stats()
    b, prompt, steps, max_len = SERVE_FULL_BF16
    tokens, extra = llm_inputs(cfg, b, prompt, seed=20)
    tokens, extra = tokens.to(dev), tuple(e.to(dev) for e in extra)
    prefill = make_prefill_fn(model)
    prefill(tokens, *extra)  # the first call pays cuBLAS' set-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        last = prefill(tokens, *extra)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    cache = llm_cache(model, cfg, b, max_len, extra, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dec_last = llm_teacher_forced(model, cache, tokens[:, :SERVE_FULL_FILL])[:, -1].float()
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t1
    first = masked_argmax(dec_last, cfg)[:, None]
    copies = [clone_cache(cache), clone_cache(cache)]
    t1 = time.perf_counter()
    out, logits = llm_greedy(model, cfg, cache, first, steps)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t1
    sampled, sample_s = [], []
    for copy in copies:
        gen = torch.Generator(device=dev).manual_seed(0)
        t1 = time.perf_counter()
        sampled.append(llm_greedy(model, cfg, copy, first, steps, temperature=SERVE_FULL_TEMP,
                                  generator=gen))
        torch.cuda.synchronize()
        sample_s.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated()
    (s_toks, s_logits), (s_toks2, s_logits2) = sampled
    check(all(bool(torch.isfinite(t.float()).all()) for t in (last, dec_last, logits, s_logits)),
          f"[serve_full] 19b {name}: logits not finite")
    check(max(int(t.max()) for t in (first, out, s_toks, s_toks2)) < cfg.vocab_size,
          f"[serve_full] 19b {name}: a token at or past vocab_size {cfg.vocab_size} "
          f"({cfg.vocab_padded} padded): the padded slots were not masked")
    check(torch.equal(s_toks, s_toks2) and torch.equal(s_logits, s_logits2),
          f"[serve_full] 19b {name}: two sampled runs from one cache and seed differ")
    for c in [cache] + copies:
        check(bool((c["pos"] == SERVE_FULL_FILL + steps).all()),
              f"[serve_full] 19b {name}: cache pos {c['pos'].tolist()} != "
              f"{SERVE_FULL_FILL + steps}")
    with torch.inference_mode():
        step_kernels, step_us, step_ms = traced_launches(
            lambda: model.decode_step(cache, tokens[:, :1]))
    prefill_ms = statistics.median(walls) * 1e3
    lines = [
        f"{name} bf16, full width and depth ({cfg.n_layers} layers"
        f"{f' + {cfg.n_encoder_layers} encoder layers' if cfg.n_encoder_layers else ''}, "
        f"{sum(p.numel() for p in model.parameters()):,} parameters, {held:,} B), vocab "
        f"{cfg.vocab_size} ({cfg.vocab_padded} padded), {b} requests: built in {build_s:.3f} s, "
        f"max_memory_allocated {init_peak:,} B at init against {before:,} B before + {held:,} "
        f"B held + the largest float32 draw {draw:,} B = {before + held + draw:,} B (gate: + "
        f"its cast, {bound:,} B); prefill fn over {b} x {prompt} tokens {prefill_ms:.3f} ms "
        f"(median of 3 after one warm-up; {[round(w * 1e3, 3) for w in walls]}); the first "
        f"{SERVE_FULL_FILL} tokens of each prompt by decode into a max_len={max_len} cache "
        f"{fill_s * 1e3 / SERVE_FULL_FILL:.3f} ms a step; "
        f"{steps} greedy steps {greedy_s * 1e3 / steps:.3f} ms a step, "
        f"{b * steps / greedy_s:.1f} tokens/s; {steps} sampled steps at temperature "
        f"{SERVE_FULL_TEMP} {[round(t * 1e3 / steps, 3) for t in sample_s]} ms a step, twice "
        f"from copies of the cache and one seed: bitwise equal, "
        f"{int((s_toks != out).sum())} of {b * steps} tokens differ from the greedy ones",
        f"{name} gates held: finite logits, every token below vocab_size, cache pos "
        f"{cache['pos'].tolist()} before the traced step; max_memory_allocated {peak:,} B "
        f"serving; a traced decode step {step_kernels} kernels, device {step_us / 1e3:.3f} ms "
        f"of {step_ms:.3f} ms wall (busy {ratio(step_us / 1e3, step_ms)}); card {smi}; "
        f"{time.perf_counter() - t0:.3f} s"]
    return lines


def serve_clients_card():
    """Phase 19c: ``examples/serve_clients_torch.py`` on the card, small,
    with sweeps off and an autotune cache of its own: each tenant's rows
    and deadline errors, the cohort's rows bitwise ``run``'s (the example
    checks it).  Returns the line."""
    spec = importlib.util.spec_from_file_location(
        "serve_clients_torch", Path(__file__).resolve().parent / "examples" /
        "serve_clients_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with tempfile.TemporaryDirectory(prefix="repro_serve_clients_") as tmp, mock.patch.dict(
            os.environ, REPRO_AUTOTUNE="0", REPRO_AUTOTUNE_CACHE=str(Path(tmp) / "autotune.json")):
        t0 = time.perf_counter()
        got = example.main(SERVE_CLIENTS_ARGS)
        secs = time.perf_counter() - t0
    want = int(SERVE_CLIENTS_ARGS[1]), int(SERVE_CLIENTS_ARGS[3])
    check((got["viewer_rows"], got["cohort_rows"]) == want and got["cohort_errors"] == 0,
          f"[serve_full] 19c the service example: {got}")
    return (f"19c python examples/serve_clients_torch.py {' '.join(SERVE_CLIENTS_ARGS)} on "
            f"the card (sweeps off): viewer {got['viewer_rows']} rows, {got['viewer_errors']} "
            f"deadline errors; cohort {got['cohort_rows']} rows, {got['cohort_errors']} errors, "
            f"bitwise run's; {got['served_cases']} cases in {got['windows']} windows "
            f"({sum(1 for t in got['window_tenants'] if t > 1)} cross-tenant), "
            f"{got['expired_cases']} expired; {got['wall_s']:.3f} s served, {secs:.3f} s in all")


def serve_full_phase(smi):
    """Phase 19: the six registry architectures one card holds, served at
    full width and depth (printed as [serve_full]): 19a float32 against
    the forward, 19b bf16 with greedy and sampled decode, then 19c the
    radiomics service example; fails on any check."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    check(not torch.backends.cuda.matmul.allow_tf32, "[serve_full] TF32 must be off")
    held = fresh_card()
    live = sorted(((t.numel() * t.element_size(), tuple(t.shape)) for t in gc.get_objects()
                   if isinstance(t, torch.Tensor) and t.is_cuda), reverse=True)
    print(f"[serve_full] before the phase: memory_allocated {held:,} B (requested "
          f"{requested_bytes():,} B), {len(live)} tensors on the card that the collector "
          f"reaches, {sum(n for n, _ in live):,} B, the largest (bytes, shape) {live[:4]}")
    zero_counts()
    for name in SERVE_FULL:
        print(f"[serve_full] 19a {serve_full_f32(name, dev)}")
        for line in serve_full_bf16(name, dev, smi):
            print(f"[serve_full] 19b {line}")
    fresh_card()
    launches = read_counts()
    check(not any(launches.values()), f"[serve_full] the phase launched a hand kernel: {launches}")
    print(f"[serve_full] 19a-b launched none of the hand kernels (rows 1-11, R) in "
          f"{time.perf_counter() - t_phase:.3f} s")
    print(f"[serve_full] {serve_clients_card()}")
    print(f"[serve_full] phase 19 took {time.perf_counter() - t_phase:.3f} s")


def main():
    import argparse
    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch port.")
    ap.add_argument("--parent", default=str(AB_PARENT),
                    help="a parent checkout (git archive) for the A/Bs of phases 5b and 5c")
    parent = ap.parse_args().parent
    # -- 1. set-up ----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[setup] card: {smi}")
    print(f"[setup] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"[setup] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    counting = start_counting_build()  # phase 5b's work counter, beside the normal build
    logs = _build.build()
    print(f"[setup] built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in ptxas_lines(log, ""):
            print(f"[setup] {name}: {line}")

    suite = table2_suite(seed=0)
    cases = {name: (img, msk, sp) for name, img, msk, sp in suite}
    cohort = [c for seed in (0, 1, 2) for c in table2_suite(seed=seed)]
    cohort_cases = [(img, msk, sp) for _, img, msk, sp in cohort]
    # a fresh autotune cache: no run reads another run's winners
    fd, cache_file = tempfile.mkstemp(prefix="repro_autotune_", suffix=".json")
    os.close(fd)
    os.unlink(cache_file)
    os.environ["REPRO_AUTOTUNE_CACHE"] = cache_file
    os.environ.pop("REPRO_AUTOTUNE", None)  # sweeps on, as the card's default
    print(f"[setup] autotune cache {cache_file} (fresh)")
    warm_s = warm_autotune(suite, cases, cohort_cases)
    resil_dir = Path(tempfile.mkdtemp(prefix="repro_resil_"))
    t0 = time.perf_counter()
    soak_stream = soak_cases()  # phase 11's cases, made once
    gen_s = time.perf_counter() - t0
    abandoned, cluster_rows = warm_resilience(resil_dir, soak_stream)
    warm_resil_s = time.perf_counter() - t0
    warm_s += warm_resil_s
    entries = json.load(open(cache_file))["entries"]
    sweeps_warm = autotune.SWEEPS
    print(f"[setup] warm pass (untimed): {warm_s:.3f} s ({warm_resil_s:.3f} s of it phase "
          f"11's soak and cluster run, {gen_s:.3f} s of that making their {SOAK_CASES} "
          f"cases), {sweeps_warm} sweeps taking "
          f"{sweep_seconds():.3f} s by kind "
          f"{ {k: round(v, 3) for k, v in autotune.SWEEP_SECONDS.items()} }, cache entries by "
          f"kind {dict(sorted(collections.Counter(k.split('/')[0] for k in entries).items()))}; "
          f"diameter winners "
          f"{dict(sorted(collections.Counter(e['variant'] + '/' + str(e['block']) for k, e in entries.items() if k.startswith('diameter/')).items()))}")
    for key in sorted(k for k in entries if k.startswith("diameter/")):
        print(f"[setup] warm {tuned_vs_default(key, entries[key])}")
    # the tuner's diameter sweep at every warm key with its old candidates
    # (seqacc, nomask: 8 a key) and its new ones (12), in turns, uncached
    cand_s = {"old": 0.0, "new": 0.0}
    for key in sorted(k for k in entries if k.startswith("diameter/")):
        kind = key.split("/")[2][0]  # M: a bucket, T: a static target
        bucket, depth = (int(x[1:]) for x in key.split("/")[2:4])
        extent = autotune.static_probe_extent(bucket) if kind == "T" else None
        wins = {}
        for which in ("old", "new"):
            variants = OLD_DIAMETER_VARIANTS if which == "old" else autotune.DEFAULT_VARIANTS
            saved, autotune.DEFAULT_VARIANTS = autotune.DEFAULT_VARIANTS, variants
            try:
                t0 = time.perf_counter()
                best, table = autotune.sweep_diameter(bucket, dev, batch=depth, extent=extent)
                cand_s[which] += time.perf_counter() - t0
            finally:
                autotune.DEFAULT_VARIANTS = saved
            wins[which] = f"{best.variant}/{best.block} {table[f'{best.variant}/{best.block}']:.1f} us"
        print(f"[setup] sweep {kind}{bucket}/B{depth}: {len(OLD_DIAMETER_VARIANTS)} variants -> "
              f"{wins['old']}; {len(autotune.DEFAULT_VARIANTS)} variants -> {wins['new']}")
    print(f"[setup] diameter sweeps over the warm keys: {len(OLD_DIAMETER_VARIANTS)} variants "
          f"{cand_s['old']:.3f} s, {len(autotune.DEFAULT_VARIANTS)} variants {cand_s['new']:.3f} s "
          f"({ratio(cand_s['new'], cand_s['old'])}x); the warm pass's own diameter sweeps "
          f"{autotune.SWEEP_SECONDS['diameter']:.3f} s")
    img, msk, sp = cases["00001-1"]
    _, big, _ = crop_to_roi(img, msk)
    big_dev = torch.from_numpy(big).to(dev)
    print(f"[setup] case 00001-1 crops to {big.shape} ({big.size} voxels)")

    # -- 2. marching cubes: kernel vs plain ---------------------------------
    mc_err = 0.0
    for label, vol, spacing in [("00001-1", big_dev, sp),
                                ("sphere96", torch.from_numpy(sphere_volume(96, 40.0)).to(dev),
                                 np.ones(3, np.float32))]:
        kv, ka = mc.mc_volume_area(vol, 0.5, spacing)
        kv2, ka2 = mc.mc_volume_area(vol, 0.5, spacing)
        pv, pa = ref.mc_volume_area(vol, 0.5, spacing)
        k = np.array([kv.item(), ka.item()])
        p = np.array([pv.item(), pa.item()])
        check(np.all(np.isfinite(k)) and k[0] > 0 and k[1] > 0, f"mc {label}: {k}")
        np.testing.assert_allclose(k, p, rtol=1e-5, err_msg=f"mc kernel vs plain, {label}")
        check(np.array_equal(k, [kv2.item(), ka2.item()]), f"mc {label}: runs differ")
        mc_err = max(mc_err, float(np.max(np.abs(k - p))))
        print(f"[mc] {label}: kernel (vol, area) = {k.tolist()}, plain = {p.tolist()}, "
              f"rtol 1e-5 ok, repeat bitwise ok")
    mc_ms = time_ms(lambda: mc.mc_volume_area(big_dev, 0.5, sp))
    mc_plain_ms = time_ms(lambda: ref.mc_volume_area(big_dev, 0.5, sp))
    mc_bound, n_tris = mc_bound_ms([big_dev], dev)
    mc_dev, _ = device_trace(lambda: mc.mc_volume_area(big_dev, 0.5, sp), reps=10)
    print(f"[mc] 00001-1: kernel {mc_ms:.4f} ms/call (device kernels "
          f"{kernel_us(mc_dev, ['mc_partials_kernel', 'mc_finalize_kernel'])}), plain "
          f"{mc_plain_ms:.4f} ms, bound {max(mc_bound.values()):.5f} ms "
          f"(bytes {mc_bound['bytes']:.5f}, ops {mc_bound['operations']:.5f}; "
          f"{n_tris} triangles)")

    # -- 3. diameter: kernel vs plain ---------------------------------------
    f = ref.vertex_fields(big_dev, 0.5, sp)
    n_big = int(ref.count_vertices(f))
    verts, vmask, _ = ref.compact_vertices(f, ops.vertex_bucket(n_big))
    print(f"[diam] 00001-1: {n_big} valid vertices in a {len(verts)}-slot bucket")
    rng = np.random.default_rng(0)
    diam_inputs = [("00001-1", verts, vmask)]
    for m in (1, 2, 513, 4096):
        v = torch.from_numpy((rng.normal(size=(m, 3)) * 60 + 100).astype(np.float32)).to(dev)
        keep = torch.from_numpy(rng.random(m) < 0.8).to(dev)
        keep[m // 2] = True
        diam_inputs.append((f"random M={m}", v, keep))
    diam_err = 0.0
    for label, v, keep in diam_inputs:
        k = dm.max_diameters_sq(v, keep)
        p = ref.max_diameters_sq(v, keep, dm.DEFAULT_BLOCK)
        check(bool(torch.isfinite(k).all()), f"diameter {label}: {k}")
        check(torch.equal(k, p), f"diameter kernel vs plain not bitwise, {label}: "
                                 f"{k.tolist()} vs {p.tolist()}")
        diam_err = max(diam_err, float((k - p).abs().max()))
        print(f"[diam] {label}: kernel == plain bitwise {k.tolist()}")
    # seqacc at the block the warm pass tuned for 00001-1's unpruned bucket
    tuned = autotune.get_diameter_config(len(verts), dev).block
    diam_ms = time_ms(lambda: dm.max_diameters_sq(verts, vmask, block=tuned))
    diam_plain_ms = time_ms(lambda: ref.max_diameters_sq(verts, vmask, tuned),
                            reps=5, warmup=1)
    diam_bound, pairs = diam_bound_ms(vmask)
    diam_dev, _ = device_trace(lambda: dm.max_diameters_sq(verts, vmask, block=tuned), reps=10)
    print(f"[diam] 00001-1 at the tuned block {tuned}: kernel {diam_ms:.4f} ms/call (device kernels "
          f"{kernel_us(diam_dev, ['diameter_sweep_kernel', 'diameter_finalize_kernel'])}), plain "
          f"{diam_plain_ms:.4f} ms, bound {max(diam_bound.values()):.5f} ms "
          f"({pairs} pairs x {DIAM_OPS_PER_PAIR} FP32 ops)")
    _, v4k, k4k = diam_inputs[-1]
    v4k_valid = v4k[k4k]
    yard_ms = time_ms(lambda: torch.cdist(v4k_valid, v4k_valid).amax())
    yard_kernel_ms = time_ms(lambda: dm.max_diameters_sq(v4k, k4k))
    print(f"[diam] yardstick, 3D combo only, random M=4096 ({len(v4k_valid)} valid): "
          f"torch.cdist(v, v).amax() {yard_ms:.4f} ms vs kernel (all 4 combos) "
          f"{yard_kernel_ms:.4f} ms")

    # -- 4. the main path ---------------------------------------------------
    ext = ShapeFeatureExtractor()  # default device: the card
    zero_counts()
    results = {}
    t0 = time.perf_counter()
    for name, img, msk, sp in suite:
        t1 = time.perf_counter()
        feats, times = ext.execute(img, msk, sp, with_times=True)
        wall_ms = (time.perf_counter() - t1) * 1e3
        results[name] = (feats, times, ext.last_prune_info, wall_ms)
    wall_s = time.perf_counter() - t0
    img, msk, sp = cases["00001-1"]
    unpruned, unpruned_t = ShapeFeatureExtractor(prune=False).execute(img, msk, sp,
                                                                      with_times=True)
    launches = read_counts()
    print(f"[main] {len(suite)} cases in {wall_s:.3f} s = {len(suite) / wall_s:.3f} cases/s; "
          f"launches {launches}; 00001-1 with prune=False: diameter_ms "
          f"{unpruned_t.diameter_ms:.3f}")
    # wall_ms: host clock around execute; it adds the untimed PCA and feature
    # assembly (and any first-use set-up) to the four stages' total_ms
    print("[main] case      shape            verts    kept  prep_ms  xfer_ms  mesh_ms  diam_ms"
          "  total_ms   wall_ms")
    for name, img, msk, sp in suite:
        feats, t, info, wall_ms = results[name]
        check(all(np.isfinite(feats[k]) for k in KEYS), f"{name}: non-finite features")
        print(f"[main] {name}  {str(img.shape):15s} {int(feats['_n_mesh_vertices']):7d} "
              f"{info.m_kept:7d} "
              f"{t.preprocess_ms:8.3f} {t.transfer_ms:8.3f} {t.mesh_ms:8.3f} "
              f"{t.diameter_ms:8.3f} {t.total_ms:9.3f} {wall_ms:9.3f}")
    pruned = results["00001-1"][0]
    check(all(pruned[k] == unpruned[k] for k in DIAM_KEYS),
          f"00001-1: prune on/off diameters differ: "
          f"{[pruned[k] for k in DIAM_KEYS]} vs {[unpruned[k] for k in DIAM_KEYS]}")
    print("[main] 00001-1: prune on == prune off diameters, bitwise")
    cpu = ShapeFeatureExtractor(device="cpu")
    cpu_feats = {}  # phase 6 holds the batched rows against these too
    for name, img, msk, sp in suite:
        ref_feats = cpu_feats[name] = cpu.execute(img, msk, sp)
        feats = results[name][0]
        for k in KEYS:
            np.testing.assert_allclose(feats[k], ref_feats[k], rtol=1e-4, err_msg=f"{name} {k}")
        check(feats["_n_mesh_vertices"] == ref_feats["_n_mesh_vertices"], f"{name}: vertex count")
    print(f"[main] all {len(suite)} cases: card == CPU path (17 features rtol 1e-4, "
          f"vertex counts exact)")
    check(launches["marching_cubes"] > 0 and launches["diameter"] > 0,
          f"a kernel of the path never ran: {launches}")
    # device busy and idle share of one traced execute (after the counted run)
    for name in ("00001-1", "00009-2"):
        img, msk, sp = cases[name]
        per_kernel, wall_ms = device_trace(lambda: ext.execute(img, msk, sp))
        busy_ms = sum(per_kernel.values()) / 1e3
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:4]
        print(f"[trace] {name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle "
              f"share {1 - busy_ms / wall_ms:.4f}, {len(per_kernel)} kernel names; top: "
              + "; ".join(f"{k[:48]} {us:.1f} us" for k, us in top))
    check_no_sweep(sweeps_warm, "main")

    # -- 5. batched kernels ---------------------------------------------------
    t0 = time.perf_counter()
    with Recorder(cp, "compact_batch") as rec_cp, \
            Recorder(mc, "mc_volume_area_batch") as rec_mc, \
            Recorder(dm, "max_diameters_sq_batch") as rec_dm:
        BatchedExtractor().run(cohort_cases)
    torch.cuda.synchronize()
    print(f"[batch] uncounted recording run over {len(cohort)} cases: "
          f"{time.perf_counter() - t0:.3f} s; launches recorded: compaction "
          f"{len(rec_cp.calls)}, MC {len(rec_mc.calls)}, diameter {len(rec_dm.calls)}")

    # compaction: five keep patterns, then every launch of the run, bitwise
    rng = np.random.default_rng(0)
    cp_err = 0.0
    for m in (512, 4096, 131072):
        for b in (1, 3, 16):
            cap = m // 2
            v = torch.from_numpy((rng.normal(size=(b, m, 3)) * 20).astype(np.float32)).to(dev)
            for pattern in PATTERNS:
                k = torch.from_numpy(np.stack([keep_pattern(pattern, m, cap, rng)
                                               for _ in range(b)])).to(dev)
                got, want = cp.compact_batch(v, k, cap), ref.compact_batch(v, k, cap)
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"compaction kernel vs plain, {pattern} B={b} M={m}")
                cp_err = max(cp_err, float((got[0] - want[0]).abs().max()))
    print(f"[batch] compaction == plain bitwise: 5 patterns x B in (1, 3, 16) x "
          f"M in (512, 4096, 131072)")
    for v, k, cap in rec_cp.calls:
        want = ref.compact_batch(v, k, cap)
        for tile in CP_TILES:
            got = cp.compact_batch(v, k, cap, block=tile)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"compaction kernel vs plain on the main path's launch B={len(v)} cap={cap} "
                  f"at tile {tile}")
            cp_err = max(cp_err, float((got[0] - want[0]).abs().max()))
    print(f"[batch] compaction == plain bitwise on all {len(rec_cp.calls)} launches of the "
          f"run at tiles {CP_TILES}: "
          + ", ".join(f"{tuple(v.shape[:2])}->{cap}" for v, _, cap in rec_cp.calls))
    cv, ck, ccap = max(rec_cp.calls, key=lambda c: c[0].numel())
    cp_ms = time_ms(lambda: cp.compact_batch(cv, ck, ccap))
    cp_plain_ms = time_ms(lambda: ref.compact_batch(cv, ck, ccap))
    cp_lib_ms = time_ms(lambda: [cv[b][ck[b]] for b in range(len(cv))])
    # bytes the function must move: every keep flag, the survivors below cap,
    # every output slot and mask byte, the counts
    cb, cm_ = ck.shape
    c_read = int(ck.sum(1).clamp(max=ccap).sum())
    cp_bound = rl.bound_ms(rl.compact_work(cb, cm_, ccap, c_read), H100)
    cp_dev, _ = device_trace(lambda: cp.compact_batch(cv, ck, ccap), reps=10)
    print(f"[batch] compaction at the largest launch (B={cb}, M={cm_}, cap={ccap}): kernel "
          f"{cp_ms:.4f} ms/call (device {kernel_us(cp_dev, ['compact_'])}: "
          + ", ".join(f"{n} {kernel_us(cp_dev, [n])}"
                      for n in ("compact_count_kernel", "compact_scatter_kernel"))
          + f"), tiles {cp.tiles(cm_, cp.DEFAULT_BLOCK)} a case, plain "
          f"{cp_plain_ms:.4f} ms, library (per-case boolean gather) {cp_lib_ms:.4f} ms, "
          f"bound {cp_bound['bytes']:.6f} ms (bytes; {c_read} survivors read)")

    # batched MC: every launch against the plain version and each case alone
    mcb_err = 0.0
    for vols, iso, sps in rec_mc.calls:
        got = mc.mc_volume_area_batch(vols, iso, sps)
        plain = ref.mc_volume_area_batch(vols, iso, sps)
        np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(), rtol=1e-5,
                                   err_msg=f"batched MC vs plain, bucket {tuple(vols.shape)}")
        mcb_err = max(mcb_err, float((got - plain).abs().max()))
        for b in range(len(vols)):
            one = torch.stack(mc.mc_volume_area(vols[b], iso, sps[b]))
            check(torch.equal(got[b], one),
                  f"batched MC vs batch of one, bucket {tuple(vols.shape)} case {b}")
    print(f"[batch] batched MC == batch of one bitwise and == plain at rtol 1e-5 on all "
          f"{len(rec_mc.calls)} launches ({sum(len(c[0]) for c in rec_mc.calls)} cases); "
          f"max |kernel - plain| = {mcb_err}")
    mv, miso, msps = max(rec_mc.calls, key=lambda c: c[0].numel())
    mcb_ms = time_ms(lambda: mc.mc_volume_area_batch(mv, miso, msps))
    mcb_plain_ms = time_ms(lambda: ref.mc_volume_area_batch(mv, miso, msps), reps=5, warmup=1)
    mcb_bound, mcb_tris = mc_bound_ms(list(mv), dev)
    mcb_dev, _ = device_trace(lambda: mc.mc_volume_area_batch(mv, miso, msps), reps=10)
    print(f"[batch] batched MC at the largest launch {tuple(mv.shape)}: kernel {mcb_ms:.4f} "
          f"ms/call (device "
          f"{kernel_us(mcb_dev, ['mc_partials_kernel', 'mc_finalize_kernel'])}), "
          f"plain {mcb_plain_ms:.4f} ms, bound {max(mcb_bound.values()):.5f} ms (bytes "
          f"{mcb_bound['bytes']:.5f}, ops {mcb_bound['operations']:.5f}; {mcb_tris} triangles)")

    # batched diameter: every launch against the plain version and each case alone
    dmb_err = 0.0
    for v, k in rec_dm.calls:
        got = dm.max_diameters_sq_batch(v, k)
        plain = ref.max_diameters_sq_batch(v, k, dm.DEFAULT_BLOCK)
        check(torch.equal(got, plain), f"batched diameter vs plain, stack {tuple(v.shape)}")
        dmb_err = max(dmb_err, float((got - plain).abs().max()))
        for b in range(len(v)):
            check(torch.equal(got[b], dm.max_diameters_sq(v[b], k[b])),
                  f"batched diameter vs batch of one, stack {tuple(v.shape)} case {b}")
    print(f"[batch] batched diameter == plain == batch of one bitwise on all "
          f"{len(rec_dm.calls)} launches: "
          + ", ".join(f"{tuple(v.shape[:2])}" for v, _ in rec_dm.calls))
    dv, dk = max(rec_dm.calls, key=lambda c: diam_bound_ms(c[1])[1])
    dmb_ms = time_ms(lambda: dm.max_diameters_sq_batch(dv, dk))
    dmb_plain_ms = time_ms(lambda: ref.max_diameters_sq_batch(dv, dk, dm.DEFAULT_BLOCK),
                           reps=5, warmup=1)
    dmb_bound, dmb_pairs = diam_bound_ms(dk)
    dmb_dev, _ = device_trace(lambda: dm.max_diameters_sq_batch(dv, dk), reps=10)
    dmb_valid = [dv[b][dk[b]] for b in range(len(dv))]
    dmb_lib_ms = time_ms(lambda: [torch.cdist(v, v).amax() for v in dmb_valid], reps=5)
    print(f"[batch] batched diameter at the launch with most pairs {tuple(dv.shape)}: kernel "
          f"{dmb_ms:.4f} ms/call (device "
          f"{kernel_us(dmb_dev, ['diameter_sweep_kernel', 'diameter_finalize_kernel'])}), "
          f"plain {dmb_plain_ms:.4f} ms, bound {max(dmb_bound.values()):.5f} ms "
          f"({dmb_pairs} pairs x {DIAM_OPS_PER_PAIR} FP32 ops); library (torch.cdist(v, v)"
          f".amax() per case, 3D combo only) {dmb_lib_ms:.4f} ms")
    del rec_cp, rec_mc, rec_dm

    # -- 5b. the diameter kernels: SASS, ceilings, the parent's ---------------
    diam_lib = _build.library_path("diameter")
    lines = ptxas_lines(diam_lib.with_suffix(".log").read_text(), "diameter_")
    for line in lines:
        print(f"[diam-ab] ptxas: {line}")
    check(lines and all("0 bytes spill stores, 0 bytes spill loads" in line
                        for line in lines if "spill" in line),
          f"diameter.cu: a kernel spills or printed no ptxas line: {lines}")
    sass = sass_loop_counts(diam_lib, "diameter_") or {}
    for fn, c in sorted(sass.items()):
        print(f"[diam-ab] SASS hot loop of {fn}: {json.dumps(c)}")
    ab_inputs = [("00001-1 unpruned", verts[None], vmask[None]),
                 (f"pass-2b stack {tuple(dv.shape[:2])}", dv, dk)]
    if (Path(parent) / "src" / "repro_torch" / "csrc" / "diameter.cu").exists():
        ab_rows, clocks = diameter_ab(parent, ab_inputs, (AB_BLOCK,), variants=dm.VARIANTS)
        print("[diam-ab] input                     variant       block  parent ms (2 turns)  "
              "change ms (2 turns)  parent device us  change device us  change/parent device")
        for label, variant, block, ms_o, ms_n, us_o, us_n in ab_rows:
            print(f"[diam-ab] {label:25s} {variant:12s} {block:5d}  "
                  f"{'/'.join(f'{t:.4f}' for t in ms_o):19s}  "
                  f"{'/'.join(f'{t:.4f}' for t in ms_n):19s}  "
                  f"{'/'.join(f'{t:.2f}' for t in us_o):16s}  "
                  f"{'/'.join(f'{t:.2f}' for t in us_n):16s}  "
                  f"{ratio(statistics.median(us_n), statistics.median(us_o))}")
        same_source = ((Path(parent) / "src/repro_torch/csrc/diameter.cu").read_bytes()
                       == (_build.CSRC / "diameter.cu").read_bytes())
        changed = () if same_source else AB_CHANGED
        for label, variant, _, ms_o, ms_n, us_o, us_n in ab_rows:
            # device time where both traces kept the kernels, else the events' ms
            got, was = ((statistics.median(us_n), statistics.median(us_o))
                        if min(us_n + us_o) > 0 else (statistics.median(ms_n),
                                                      statistics.median(ms_o)))
            if variant in changed:
                check(got < was, f"{variant} on {label}: the change ({got:.4f}) is not below "
                                 f"the parent ({was:.4f})")
            else:  # a control: the parent's kernel in both trees
                band = "within" if AB_BAND[0] <= got / was <= AB_BAND[1] else "OUTSIDE"
                print(f"[diam-ab] {variant} on {label}: a control (the parent's kernel); change "
                      f"{got:.4f}, parent {was:.4f} ({ratio(got, was)}, {band} the band "
                      f"{AB_BAND})")
        ours = sass_by_kernel(diam_lib)
        theirs = sass_by_kernel(_build.BUILD_DIR / "ab_parent_diameter.so")
        if ours is not None:  # the work counter is compiled out of the normal build
            differ = sorted(k for k in set(ours) | set(theirs) if ours.get(k) != theirs.get(k))
            first = next((pair for pair in zip((ours.get(differ[0]) or "").splitlines(),
                                               (theirs.get(differ[0]) or "").splitlines())
                          if pair[0] != pair[1]), None) if differ else None
            check(not differ, f"diameter.cu: the normal build's SASS differs from the parent's "
                              f"in {len(differ)} kernels, {differ[:3]}; first line apart {first}")
            print(f"[diam-ab] this tree's normal diameter library: the SASS of all {len(ours)} "
                  f"kernels identical to the parent's")
        print(f"[diam-ab] parent {parent} vs this tree, same inputs, same bits (gram rtol 1e-6); "
              f"redesigned {changed} each below the parent's; nvidia-smi over the timed window: "
              f"{clocks}")
    else:
        print(f"[diam-ab] no parent checkout at {parent} (unpack one with git archive, or pass "
              f"--parent): the A/B is not measured")
        sampler = smi_sampler()  # not `smi`: that is the card line the script ends on
        time_ms(lambda: dm.max_diameters_sq(verts, vmask), reps=40)
        clocks = smi_summary(sampler)
        print(f"[diam-ab] nvidia-smi over 40 timed calls at 00001-1: {clocks}")
    clock = clocks["clocks_sm_mhz"][1] if clocks else None
    # the main path's sweep, each at the block its phase timed: the tuned one, the default
    for label, n_pairs, block in (("00001-1 unpruned", pairs, tuned),
                                  ("pass-2b stack", dmb_pairs, dm.DEFAULT_BLOCK)):
        rows_r = dm.sweep_rows(block)
        loop = next((c for fn, c in sass.items()
                     if f"diameter_sweep_kernelILi{rows_r}ELb0E" in fn), None)
        if loop is None or not clock:
            print(f"[diam-ab] instruction-rate ceiling at {label}: not measured (SASS or clock missing)")
            continue
        print(f"[diam-ab] seqacc instruction-rate ceiling at {label} ({n_pairs} valid pairs): "
              f"{loop['fp32_per_pair']:.3f} non-FMA FP32 instructions a pair (SASS, block "
              f"{block}, R={rows_r}) at {clock:.0f} MHz = "
              f"{rate_ceiling_ms(n_pairs, loop['fp32_per_pair'], clock):.5f} ms; all "
              f"{loop['per_pair']:.3f} loop instructions a pair = "
              f"{rate_ceiling_ms(n_pairs, loop['per_pair'], clock):.5f} ms; the FP32 peak "
              f"bound {DIAM_OPS_PER_PAIR * n_pairs / PEAK_FP32_PER_S * 1e3:.5f} ms")
    # the masked tile kernels at block AB_BLOCK: their own SASS counts over
    # the pairs each computes (the mask's skips counted, computed_pairs)
    rows_r = dm.sweep_rows(AB_BLOCK)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kernels_of = tile_kernels(rows_r)
    for label, x, m in ab_inputs:
        for variant in kernels_of:
            loops = [next((c for fn, c in sass.items() if k in fn), None)
                     for k in kernels_of[variant]]
            n = sum(dm.computed_pairs(x.shape[1], AB_BLOCK, variant, mask=m[b])
                    for b in range(len(x)))
            fp32_bound = sum(dm.flop_estimate(x.shape[1], AB_BLOCK, variant, mask=m[b])
                             for b in range(len(x))) / PEAK_FP32_PER_S * 1e3
            if None in loops or not clock:
                print(f"[diam-ab] {variant} at {label}: ceilings not measured (SASS or clock "
                      f"missing)")
                continue
            per = {k: sum(c[k] for c in loops) for k in SASS_LABELS}
            conv = (f"; F2F ceiling (16 a clock an SM) "
                    f"{per['f2f_per_pair'] * n / (16 * sms * clock * 1e6) * 1e3:.5f} ms"
                    if per["f2f_per_pair"] else "")
            print(f"[diam-ab] {variant} at {label}, block {AB_BLOCK}: {n} pairs computed"
                  f"{' a launch (4 launches)' if variant == 'naive' else ''}; SASS a pair "
                  + ("(summed over the 4 launches) " if variant == "naive" else "")
                  + ", ".join(f"{SASS_LABELS[k]} {v:.3f}" for k, v in per.items())
                  + f"; instruction-rate ceiling at {clock:.0f} MHz "
                  f"{rate_ceiling_ms(n, per['per_pair'], clock):.5f} ms, FP32 bound (counted "
                  f"work) {fp32_bound:.5f} ms{conv}")

    # Queue 3's work question: every variant's pairs counted in normal and traced turns
    t0 = time.perf_counter()
    work_rows = diameter_work_check(load_counting_diameter(counting), ab_inputs)
    for label, variant, block, pairs, traced_us in work_rows:
        print(f"[work] {label:25s} {variant:12s} block {block:4d}: {pairs} pairs counted in each "
              f"of {COUNT_TURNS} normal and {COUNT_TURNS} traced turns == computed_pairs; traced "
              f"device us {'/'.join(f'{t:.1f}' for t in traced_us)}")
    print(f"[work] {len(work_rows)} (input, variant, block) launches, every count == "
          f"computed_pairs in normal and traced turns, maxima bitwise the normal build's; "
          f"{time.perf_counter() - t0:.3f} s; card {smi}")

    # -- 6. the batched main path -------------------------------------------
    ext = BatchedExtractor()  # default device: the card
    zero_counts()
    t0 = time.perf_counter()
    rows, stats = ext.run(cohort_cases)
    batch_s = [time.perf_counter() - t0]
    bmain_fetches = stats["host_fetches"]
    batch_launches = read_counts()
    print(f"[bmain] run over {len(cohort)} cases: {batch_s[0]:.3f} s = "
          f"{len(cohort) / batch_s[0]:.3f} cases/s; launches {batch_launches}")
    print(f"[bmain] host_fetches {stats['host_fetches']}; pruned_cases "
          f"{stats['pruned_cases']}; vertex_buckets {stats['vertex_buckets']}; "
          f"prune_seconds {stats['prune_seconds']:.4f}")
    print(f"[bmain] plan {json.dumps(stats['plan'])}")
    check(all(batch_launches[k] > 0 for k in ("marching_cubes", "diameter", "compact")),
          f"a kernel of the batched path never ran: {batch_launches}")
    rows = np.stack(rows)
    check(rows.shape == (len(cohort), 7) and np.isfinite(rows).all()
          and (rows[:, :6] > 0).all(), "batched rows: shape, finite, positive")
    for i, (name, img, msk, sp) in enumerate(cohort[:len(suite)]):
        one = ext.extract_one(img, msk, sp)
        check(np.array_equal(one, rows[i]), f"{name}: run != extract_one: {rows[i]} vs {one}")
        want = np.array([cpu_feats[name][k] for k in ROW_KEYS])
        np.testing.assert_allclose(rows[i, :6], want[:6], rtol=1e-4, err_msg=f"{name} vs CPU")
        check(rows[i, 6] == want[6], f"{name}: vertex count {rows[i, 6]} vs {want[6]}")
    print(f"[bmain] seed 0: run == extract_one bitwise and == phase 4's CPU features "
          f"(rtol 1e-4, vertex counts exact) on all {len(suite)} cases")
    host_rows, host_stats = BatchedExtractor(device_compact=False).run(cohort_cases[:len(suite)])
    check(np.array_equal(np.stack(host_rows), rows[:len(suite)]),
          "device_compact=False != True on the seed-0 window")
    print(f"[bmain] seed 0: device_compact=False == True bitwise (host_fetches "
          f"{host_stats['host_fetches']})")
    small = sorted(range(len(suite)), key=lambda i: suite[i][2].size)[:5]
    one_ext = BatchedExtractor(prune=False)
    one_ext.run([cohort_cases[i] for i in small[:1]])  # first use of the one-pass path
    with one_ext.executor.strict_syncs():
        one_rows, one_stats = one_ext.run([cohort_cases[i] for i in small])
    check(not one_stats["errors"] and np.array_equal(np.stack(one_rows)[:, 2:6], rows[small, 2:6]),
          f"prune=False != prune=True diameters on the 5 smallest seed-0 cases: "
          f"{one_stats['errors']}")
    print(f"[bmain] prune=False == prune=True diameters bitwise on "
          f"{[suite[i][0] for i in small]} (host_fetches {one_stats['host_fetches']}; "
          f"no other host sync under CUDA sync debugging)")

    single = ShapeFeatureExtractor()
    single_s = []
    for rnd in range(2):
        t0 = time.perf_counter()
        for img, msk, sp in cohort_cases:
            single.execute(img, msk, sp)
        single_s.append(time.perf_counter() - t0)
        if rnd == 0:
            t0 = time.perf_counter()
            ext.run(cohort_cases)
            batch_s.append(time.perf_counter() - t0)
    print("[bmain] cases/s over the 60 cases, rounds in order batched, single, batched, "
          f"single: batched {[round(len(cohort) / t, 3) for t in batch_s]}, single-case "
          f"loop {[round(len(cohort) / t, 3) for t in single_s]}")
    seed0 = cohort_cases[:len(suite)]
    per_kernel, wall_ms = device_trace(lambda: ext.run(seed0))
    busy_ms = sum(per_kernel.values()) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"[btrace] run over the 20 seed-0 cases: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}, {len(per_kernel)} "
          "kernel names; top: " + "; ".join(f"{k[:48]} {us:.1f} us" for k, us in top))
    # every host sync of a window is one of the executor's counted fetches
    with ext.executor.strict_syncs():
        strict_rows, strict_stats = ext.run(seed0)
    check(not strict_stats["errors"] and np.array_equal(np.stack(strict_rows), rows[:len(suite)]),
          f"seed-0 rows under CUDA sync debugging differ: {strict_stats['errors']}")
    print(f"[bmain] seed 0 under CUDA sync debugging ('error' outside the counted "
          f"fetches): no other host sync; host_fetches {strict_stats['host_fetches']}")
    check_no_sweep(sweeps_warm, "bmain")

    # -- 7. the intensity families ------------------------------------------
    t0 = time.perf_counter()
    with Recorder(fo, "firstorder_packed_batch") as rec_fo, \
            Recorder(gl, "glcm_matrix_batch") as rec_gl, \
            Recorder(mr, "masked_range_batch") as rec_mr:
        BatchedExtractor(families=FAMS).run(cohort_cases)
    torch.cuda.synchronize()
    print(f"[fam] uncounted recording run over {len(cohort)} cases: "
          f"{time.perf_counter() - t0:.3f} s; launches recorded: first-order "
          f"{len(rec_fo.calls)}, GLCM {len(rec_gl.calls)}, masked range {len(rec_mr.calls)}")
    # the masked range kernel of every pool == intensity_range by value
    mr_err = 0.0
    for imgs, msks in rec_mr.calls:
        flat = (len(imgs), -1)
        got = mr.masked_range_batch(imgs, msks)
        want = ref.intensity_range(imgs.reshape(flat), msks.reshape(flat), dim=1)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"the masked range kernel != intensity_range, bucket {tuple(imgs.shape)}")
        mr_err = max(mr_err, *(float((a - b).abs().max()) for a, b in zip(got, want)))
        for b in range(len(imgs)):
            one = mr.masked_range_batch(imgs[b:b + 1], msks[b:b + 1])
            check(all(torch.equal(o[0], g[b]) for o, g in zip(one, got)),
                  f"masked range batched vs batch of one, bucket {tuple(imgs.shape)} case {b}")
    print(f"[fam] masked range kernel == intensity_range (by value) == batch of one on all "
          f"{len(rec_mr.calls)} pools ({sum(len(c[0]) for c in rec_mr.calls)} cases)")
    fo_err = gl_err = 0.0
    for (imgs, msks), kw in zip(rec_fo.calls, rec_fo.kwargs):
        flat = (len(imgs), -1)
        check(all(torch.equal(a, b) for a, b in zip(
                  kw["value_range"], ref.intensity_range(imgs.reshape(flat), msks.reshape(flat),
                                                         dim=1))),
              f"the pool's masked range != intensity_range, bucket {tuple(imgs.shape)}")
        got = fo.firstorder_packed_batch(imgs, msks, **kw)
        plain = fo.firstorder_packed_batch_ref(imgs, msks, kw["n_bins"], kw["value_range"])
        check(torch.equal(got, plain),
              f"first-order kernel vs plain not bitwise, bucket {tuple(imgs.shape)}")
        fo_err = max(fo_err, float((got - plain).abs().max()))
        for blk in (1024, 8192):
            check(torch.equal(fo.firstorder_packed_batch(imgs, msks, block=blk), got),
                  f"first-order block {blk} vs {fo.DEFAULT_BLOCK}, bucket {tuple(imgs.shape)}")
        for b in range(len(imgs)):
            check(torch.equal(fo.firstorder_packed_batch(imgs[b:b + 1], msks[b:b + 1])[0],
                              got[b]),
                  f"first-order batched vs batch of one, bucket {tuple(imgs.shape)} case {b}")
    print(f"[fam] first-order kernel == plain == batch of one bitwise, and at block 1024, "
          f"2048 and 8192, on all {len(rec_fo.calls)} launches "
          f"({sum(len(c[0]) for c in rec_fo.calls)} cases)")
    gl_max = 0
    for (imgs, msks), kw in zip(rec_gl.calls, rec_gl.kwargs):
        got = gl.glcm_matrix_batch(imgs, msks, **kw)
        plain = gl.glcm_matrix_batch_ref(imgs, msks, kw["n_bins"], kw["value_range"])
        check(torch.equal(got, plain), f"GLCM kernel vs plain, bucket {tuple(imgs.shape)}")
        for blk in GL_BLOCKS:
            check(torch.equal(gl.glcm_matrix_batch(imgs, msks, **{**kw, "block": blk}), got),
                  f"GLCM block {blk} vs {kw['block']}, bucket {tuple(imgs.shape)}")
        gl_err = max(gl_err, float((got - plain).abs().max()))
        gl_max = max(gl_max, int(got.max()))
        for b in range(len(imgs)):
            check(torch.equal(gl.glcm_matrix_batch(imgs[b:b + 1], msks[b:b + 1])[0], got[b]),
                  f"GLCM batched vs batch of one, bucket {tuple(imgs.shape)} case {b}")
    check(gl_max < 2 ** 24, f"a GLCM count of {gl_max} is not exact in float32")
    print(f"[fam] GLCM kernel == plain == batch of one exactly, and at blocks {GL_BLOCKS}, on "
          f"all {len(rec_gl.calls)} launches; largest count {gl_max} < 2^24")
    # the largest launch, with the masked range its pool took for both families
    big = max(range(len(rec_fo.calls)), key=lambda j: rec_fo.calls[j][0].numel())
    (fi, fm), fkw = rec_fo.calls[big], rec_fo.kwargs[big]
    # the GLCM launch of the same pool, at the block its own lookup gave
    gkw = next(kw for (gi, _), kw in zip(rec_gl.calls, rec_gl.kwargs)
               if gi.shape == fi.shape and torch.equal(gi, fi))
    fo_ab_in = (fi, fm, fkw, gkw)  # phase 5c's first-order and GLCM input
    # the masked range at the same pool: the kernel against its plain version
    rng_args = (fi.reshape(len(fi), -1), fm.reshape(len(fi), -1))
    mr_ms = time_ms(lambda: mr.masked_range_batch(fi, fm))
    mr_plain_ms = time_ms(lambda: ref.intensity_range(*rng_args, dim=1))
    mr_split = device_split(lambda: mr.masked_range_batch(fi, fm))
    mr_plain_dev, _ = device_trace(lambda: ref.intensity_range(*rng_args, dim=1), reps=10)
    mr_floor = device_split(mr.launch_floor(len(fi), fi[0].numel()))
    mr_masked = int((fm > 0).sum())
    # bytes: every mask value, the image at the masked voxels, the (2, B) output
    mr_bound = rl.bound_ms(rl.masked_range_work(fm.numel(), mr_masked, len(fi)), H100)
    fo_ms = time_ms(lambda: fo.firstorder_packed_batch(fi, fm, **fkw))
    fo_plain_ms = time_ms(lambda: fo.firstorder_packed_batch_ref(fi, fm, fkw["n_bins"],
                                                                 fkw["value_range"]),
                          reps=5, warmup=1)
    fo_dev, _ = device_trace(lambda: fo.firstorder_packed_batch(fi, fm, **fkw), reps=10)
    gl_ms = time_ms(lambda: gl.glcm_matrix_batch(fi, fm, **gkw))
    gl_plain_ms = time_ms(lambda: gl.glcm_matrix_batch_ref(fi, fm, gkw["n_bins"],
                                                           gkw["value_range"]),
                          reps=5, warmup=1)
    gl_dev, _ = device_trace(lambda: gl.glcm_matrix_batch(fi, fm, **gkw), reps=10)
    fo_bound, gl_bound, masked, pairs = intensity_bounds_ms(fm, gl.glcm_matrix_batch(fi, fm,
                                                                                     **gkw))
    print(f"[fam] the pool's masked range at the largest launch {tuple(fi.shape)} ({mr_masked} "
          f"masked voxels), taken once for both families: kernel {mr_ms:.4f} ms/call (device "
          f"{kernel_us(mr_split, ['range_partials_kernel', 'range_fold_kernel'])}: "
          + ", ".join(f"{n} {kernel_us(mr_split, [n])}"
                      for n in ('range_partials_kernel', 'range_fold_kernel'))
          + f"; the whole call {sum(mr_split.values()):.2f} us), launch floor "
          f"{sum(mr_floor.values()):.2f} us (an empty kernel on both grids), plain "
          f"(intensity_range) {mr_plain_ms:.4f} ms/call, device "
          f"{sum(mr_plain_dev.values()):.2f} us over {len(mr_plain_dev)} kernel names; bound "
          f"{max(mr_bound.values()):.5f} ms (bytes {mr_bound['bytes']:.5f}, ops "
          f"{mr_bound['operations']:.5f})")
    for label, ms, plain_ms, per_kernel, names, bound in [
            ("first-order", fo_ms, fo_plain_ms, fo_dev,
             ["fo_partials_kernel", "fo_fold_kernel"], fo_bound),
            ("GLCM", gl_ms, gl_plain_ms, gl_dev,
             ["glcm_tile_kernel", "glcm_sum_kernel"], gl_bound)]:
        print(f"[fam] {label} at the largest launch {tuple(fi.shape)} ({masked} masked "
              f"voxels, {pairs} pairs): kernel {ms:.4f} ms/call (device kernels "
              f"{kernel_us(per_kernel, names)}: "
              + ", ".join(f"{n} {kernel_us(per_kernel, [n])}" for n in names)
              + f"; the whole call {sum(per_kernel.values()):.2f} us), plain "
              f"{plain_ms:.4f} ms, bound {max(bound.values()):.5f} ms (bytes "
              f"{bound['bytes']:.5f}, ops {bound['operations']:.5f}); kernel / bound "
              f"{ms / max(bound.values()):.1f}x")
    del rec_fo, rec_gl, rec_mr

    fext = BatchedExtractor(families=FAMS)  # default device: the card
    zero_counts()
    t0 = time.perf_counter()
    frows, fstats = fext.run(cohort_cases)
    fam_s = [time.perf_counter() - t0]
    fam_launches = read_counts()
    print(f"[fmain] three-family run over {len(cohort)} cases: {fam_s[0]:.3f} s = "
          f"{len(cohort) / fam_s[0]:.3f} cases/s; launches {fam_launches}")
    print(f"[fmain] host_fetches {fstats['host_fetches']}")
    check(all(fam_launches[k] > 0 for k in ("marching_cubes", "diameter", "compact",
                                            "firstorder", "glcm", "masked_range")),
          f"a kernel of the three-family path never ran: {fam_launches}")
    check(fam_launches["firstorder"] == fam_launches["glcm"] == fam_launches["masked_range"]
          == fstats["plan"]["shape_buckets"],
          f"one launch per family, and one masked range, per shape bucket: {fam_launches}")
    check(fstats["host_fetches"] == FAMILY_FETCHES,
          f"host fetches {fstats['host_fetches']} != the reference's {FAMILY_FETCHES}")
    frows = np.stack(frows)
    check(frows.shape == (len(cohort), 20) and np.isfinite(frows).all(),
          "three-family rows: shape, finite")
    check(np.array_equal(frows[:, :7], rows),
          "shape columns of the three-family run != the shape-only run")
    for i, (name, img, msk, sp) in enumerate(cohort[:len(suite)]):
        one = fext.extract_one(img, msk, sp)
        check(np.array_equal(one, frows[i]), f"{name}: run != extract_one: {frows[i]} vs {one}")
    t0 = time.perf_counter()
    cpu_fam, _ = BatchedExtractor(device="cpu", families=("firstorder", "glcm")).run(
        cohort_cases)
    cpu_fam = np.stack(cpu_fam)
    fam = frows[:, 7:]
    fo_exact = [2, 3, 4, 5, 6, 8]  # min, max, P10, median, P90, entropy
    check(np.array_equal(fam[:, 9:], cpu_fam[:, 9:]), "GLCM columns != the CPU path")
    check(np.array_equal(fam[:, fo_exact], cpu_fam[:, fo_exact]),
          "first-order min, max, percentiles or entropy != the CPU path")
    np.testing.assert_allclose(fam, cpu_fam, rtol=1e-4, err_msg="family columns vs the CPU path")
    fo_rel = float(np.max(np.abs(fam[:, :9] - cpu_fam[:, :9])
                          / np.maximum(np.abs(cpu_fam[:, :9]), 1e-30)))
    print(f"[fmain] seed 0: run == extract_one bitwise; all {len(cohort)} cases: shape "
          f"columns == the shape-only rows bitwise; family columns vs the port's CPU path "
          f"({time.perf_counter() - t0:.3f} s): GLCM and first-order min, max, percentiles, entropy exact, largest relative "
          f"first-order difference {fo_rel:.3e} (rtol 1e-4); bitwise equal: "
          f"{np.array_equal(fam, cpu_fam)}")
    with fext.executor.strict_syncs():
        strict_rows, strict_stats = fext.run(cohort_cases)
    check(not strict_stats["errors"] and np.array_equal(np.stack(strict_rows), frows),
          f"three-family rows under CUDA sync debugging differ: {strict_stats['errors']}")
    print(f"[fmain] the {len(cohort)} cases under CUDA sync debugging ('error' outside the "
          f"counted fetches): no other host sync; host_fetches {strict_stats['host_fetches']}")
    shape_s = []
    for which in ("shape", "fam", "fam", "shape"):
        t0 = time.perf_counter()
        (ext if which == "shape" else fext).run(cohort_cases)
        (shape_s if which == "shape" else fam_s).append(time.perf_counter() - t0)
    print("[fmain] cases/s over the 60 cases, rounds in order shape, three-family, "
          f"three-family, shape: three-family {[round(len(cohort) / t, 3) for t in fam_s[1:]]} "
          f"(counted run {len(cohort) / fam_s[0]:.3f}), shape-only "
          f"{[round(len(cohort) / t, 3) for t in shape_s]}")
    per_kernel, wall_ms = device_trace(lambda: fext.run(seed0))
    busy_ms = sum(per_kernel.values()) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"[ftrace] three-family run over the 20 seed-0 cases: wall {wall_ms:.3f} ms, device "
          f"busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}, {len(per_kernel)} "
          "kernel names; top: " + "; ".join(f"{k[:48]} {us:.1f} us" for k, us in top))
    check_no_sweep(sweeps_warm, "fmain")

    # -- 7b. the sync-free window path: hint caps, static targets, the stream --
    sext = stream_extractor(FAMS)
    sex = sext.executor
    fetches0 = dict(sex.transfer_log)
    seen_plans = []
    zero_counts()
    with Recorder(dm, "max_diameters_batch") as rec_sd:
        t0 = time.perf_counter()
        srows = list(sext.extract_stream(iter(cohort_cases), window=STREAM_WINDOW,
                                         stats_callback=lambda i, st: seen_plans.append(st)))
        stream_s = [time.perf_counter() - t0]
    stream_launches = read_counts()
    stream_fetches = fetch_delta(sex.transfer_log, fetches0)
    print(f"[stream] extract_stream(window={STREAM_WINDOW}) over {len(cohort)} cases, "
          f"prep='hint', schedule='static', families {FAMS}: {stream_s[0]:.3f} s = "
          f"{len(cohort) / stream_s[0]:.3f} cases/s; launches {stream_launches}")
    check(all(stream_launches[k] > 0 for k in ("marching_cubes", "diameter", "compact",
                                               "firstorder", "glcm", "masked_range")),
          f"a kernel of the stream's path never ran: {stream_launches}")
    srows = np.stack(srows)
    check(srows.shape == frows.shape and np.array_equal(srows, frows),
          "stream rows != phase 7's counted/count three-family run")
    s_run, s_run_stats = sext.run(cohort_cases)
    check(np.array_equal(np.stack(s_run), srows), "stream rows != the same extractor's run")
    for i, (name, img, msk, sp) in enumerate(cohort[:len(suite)]):
        check(np.array_equal(sext.extract_one(img, msk, sp), srows[i]),
              f"{name}: stream row != extract_one")
    print(f"[stream] rows == phase 7's counted/count run, == the same extractor's run (one "
          f"window) and == extract_one (seed 0), bitwise; windows' plans "
          + "; ".join(f"{st['cases']} cases {st['shape_buckets']} shape/{st['cap_buckets']} cap "
                      f"buckets" for st in seen_plans))
    # every submit under CUDA sync debugging, windows driven as the stream does
    windows = [cohort_cases[s0:s0 + STREAM_WINDOW]
               for s0 in range(0, len(cohort_cases), STREAM_WINDOW)]
    pending, per_window, loop_rows, chains, shapes = None, [], [], 0, 0
    for chunk in windows + [None]:
        state = None
        if chunk is not None:
            f0 = dict(sex.transfer_log)
            t0 = time.perf_counter()
            with sex.strict_syncs():
                state = sex.submit_window(chunk)
            sub_s = time.perf_counter() - t0
            check(dict(sex.transfer_log) == f0, "a hint + static submit fetched")
            chains += sum(t is not None for t in state.plan.static_targets.values())
            shapes += len(state.plan.shape_groups)
        if pending is not None:
            f0 = dict(sex.transfer_log)
            t0 = time.perf_counter()
            rows_k, _ = sex.collect_window(pending[0])
            per_window.append({"submit_s": pending[1], "collect_s": time.perf_counter() - t0,
                               "fetches": fetch_delta(sex.transfer_log, f0),
                               "census": pending[0].plan.work_census()})
            loop_rows += rows_k
        pending = None if state is None else (state, sub_s)
    check(np.array_equal(np.stack(loop_rows), srows), "the strict-sync loop's rows differ")
    want_fetches = {"pass2a": shapes, "firstorder": shapes, "glcm": shapes,
                    "pass2b_counts": chains, "collect_counts": len(cohort)}
    check(all(stream_fetches.get(k) == v for k, v in want_fetches.items())
          and "prep" not in stream_fetches and "pass1" not in stream_fetches,
          f"stream fetches {stream_fetches}: not the reference's census {want_fetches}, "
          "prep 0, pass1 0")
    print(f"[stream] host_fetches {stream_fetches}: prep 0, pass1 0, pass2b_counts one per "
          f"static-chain group ({chains}), collect_counts one per case; pass2b_retry "
          f"{stream_fetches.get('pass2b_retry', 0)}, hint_retry "
          f"{stream_fetches.get('hint_retry', 0)}")
    print("[stream] every submit_window under CUDA sync debugging ('error'): no host sync, "
          "no fetch; per window (submit s, collect s, fetches) "
          + "; ".join(f"{w['submit_s']:.3f}/{w['collect_s']:.3f} {w['fetches']}"
                      for w in per_window))
    # the drain of window k does not wait for window k+1's launches: a spin
    # queued ahead of window k+1 (a window small enough that its launches
    # fit the card's launch queue behind the spin) must still run when
    # window k's collect returns
    depth = launch_queue_depth()
    wk_cases, wk1_cases = iso_windows(cohort_cases)
    sex.collect_window(sex.submit_window(wk_cases))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wk1 = sex.submit_window(wk1_cases)
    iso_sub_s = time.perf_counter() - t0
    sex.collect_window(wk1)
    queued, wk1 = queued_launches(lambda: sex.submit_window(wk1_cases))
    sex.collect_window(wk1)
    queued_20, w20 = queued_launches(lambda: sex.submit_window(windows[0]))
    sex.collect_window(w20)
    sleep_ms = 3e3 * iso_sub_s + 50.0
    cycles = int(sleep_ms * cycles_per_ms())
    torch.cuda.synchronize()
    f0 = dict(sex.transfer_log)
    wk = sex.submit_window(wk_cases)
    torch.cuda._sleep(cycles)  # ahead of window k+1's launches
    gate = torch.cuda.Event()
    gate.record()
    t0 = time.perf_counter()
    wk1 = sex.submit_window(wk1_cases)
    sub_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    rows_k, _ = sex.collect_window(wk)
    collect_ms = 1e3 * (time.perf_counter() - t0)
    spinning = not gate.query()
    collect_fetches = fetch_delta(sex.transfer_log, f0)
    rows_k1, _ = sex.collect_window(wk1)
    check(np.array_equal(np.stack(rows_k + rows_k1), srows[20:22]),
          "the isolation windows' rows differ")
    check(not ({"pass2b_retry", "hint_retry"} & set(collect_fetches)),
          f"window k's collect launched a re-sweep: {collect_fetches}")
    check(spinning and collect_ms < sleep_ms / 4,
          f"window k's collect waited for window k+1's queued work: collect "
          f"{collect_ms:.1f} ms, submit of k+1 {sub_ms:.1f} ms ({queued} launches and copies; "
          f"launch queue depth {depth}), spin {sleep_ms:.1f} ms still running {spinning}")
    print(f"[stream] isolation (windows of one case, seed-1 cases 0 and 1): a "
          f"{sleep_ms:.1f} ms spin queued ahead of window k+1's {queued} launches and copies "
          f"(its submit {sub_ms:.1f} ms); window k's collect took {collect_ms:.2f} ms and "
          f"returned with the spin still running; the card's launch queue blocks the host "
          f"at {depth} pending launches, and a 20-case window's submit queues {queued_20}")
    # pairs pass 2b sweeps: the static schedule against the counted one
    with Recorder(dm, "max_diameters_batch") as rec_cd:
        fext.run(cohort_cases)
    c_pad, c_swept = pairs_of(rec_cd.calls)
    s_pad, s_swept = pairs_of(rec_sd.calls)
    # plan.work_census of the stream's windows: hint caps under the static
    # schedule, and count caps under each schedule (metadata only)
    count_metas = [fext.executor.case_meta(fext.executor.prep_case(c)) for c in cohort_cases]
    census = {"static/hint": sum(census_pairs(w["census"]) for w in per_window)}
    for schedule in ("static", "counted"):
        census[f"{schedule}/count"] = sum(
            census_pairs(planlib.build_plan(count_metas[s0:s0 + STREAM_WINDOW], schedule,
                                            families=FAMS).work_census())
            for s0 in range(0, len(cohort_cases), STREAM_WINDOW))
    print(f"[stream] pass 2b pairs over the 60 cases: static/hint stream {len(rec_sd.calls)} "
          f"launches, padded {s_pad}, extent-swept {s_swept}; counted/count run "
          f"{len(rec_cd.calls)} launches, padded {c_pad}, extent-swept {c_swept} (padded "
          f"{ratio(s_pad, c_pad)}x, swept {ratio(s_swept, c_swept)}x); plan.work_census "
          f"padded pairs of the windows of {STREAM_WINDOW} {census} (counted: at the "
          f"pre-compaction cap, an upper bound)")
    del rec_sd, rec_cd
    # cases/s: the stream against phase 7's run and the same extractor's run
    s_run_s, f_run_s = [], []
    for which in ("stream", "counted", "static", "static", "counted", "stream"):
        t0 = time.perf_counter()
        if which == "stream":
            for _ in sext.extract_stream(iter(cohort_cases), window=STREAM_WINDOW):
                pass
        else:
            (fext if which == "counted" else sext).run(cohort_cases)
        {"stream": stream_s, "counted": f_run_s, "static": s_run_s}[which].append(
            time.perf_counter() - t0)
    print("[stream] cases/s over the 60 cases, rounds in order stream, run (counted/count), "
          "run (static/hint), run (static/hint), run (counted/count), stream: stream "
          f"{[round(len(cohort) / t, 3) for t in stream_s[1:]]} (counted run "
          f"{len(cohort) / stream_s[0]:.3f}), run counted/count "
          f"{[round(len(cohort) / t, 3) for t in f_run_s]}, run static/hint "
          f"{[round(len(cohort) / t, 3) for t in s_run_s]}; stream / counted run "
          f"{ratio(sum(f_run_s), sum(stream_s[1:]))}x")
    # one traced stream: busy and idle share, the longest idle gaps and the
    # host span each falls in
    from torch.profiler import ProfilerActivity, profile
    sex.submit_window = labelled(sex.submit_window, "stream.submit")
    sex.collect_window = labelled(sex.collect_window, "stream.collect")
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in sext.extract_stream(iter(cohort_cases), window=STREAM_WINDOW):
                pass
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        del sex.submit_window, sex.collect_window
    busy_us, gaps, per_kernel = idle_gaps(prof)
    by_span = collections.Counter()
    for us, where in gaps:
        by_span[where] += us
    top = per_kernel.most_common(6)
    print(f"[strace] stream over the {len(cohort)} cases: wall {wall_us / 1e3:.3f} ms, device "
          f"busy {busy_us / 1e3:.3f} ms, idle share "
          + (f"{1 - busy_us / wall_us:.4f}" if busy_us else "not measured")
          + f"; idle between device intervals by host span (ms) "
          f"{ {k: round(v / 1e3, 3) for k, v in by_span.items()} }; longest gaps "
          + ", ".join(f"{us / 1e3:.3f} ms in {where}" for us, where in gaps[:6])
          + "; top device items: " + "; ".join(f"{k[:48]} {us:.1f} us" for k, us in top))
    # a stream with a tiled segment: 00001-1 as a TiledCase between two in-core segments
    text = stream_extractor(TILED_FAMS)
    tcases = tiled_stream(cohort_cases, cases)
    zero_counts()
    trows = list(text.extract_stream(iter(tcases), window=4))
    tstream_launches = read_counts()
    check(all(tstream_launches[k] > 0 for k in (
              "marching_cubes", "diameter", "compact", "firstorder", "mc_slab_partials",
              "mc_partials_finalize", "fold_packed_chunks")),
          f"a kernel of the tiled stream's path never ran: {tstream_launches}")
    img, msk, sp = cases["00001-1"]
    n_tiled = planlib.row_width(TILED_FAMS)
    check(np.array_equal(trows[4], text.extract_one(img, msk, sp))
          and np.array_equal(np.stack(trows[:4] + trows[5:]), frows[20:28, :n_tiled]),
          "the tiled stream's rows != extract_one (the tiled case) or phase 7's rows")
    print(f"[stream] tiled segment: {len(tcases)} cases (00001-1 a TiledCase at 8 MiB between "
          f"two in-core segments), window 4: the tiled row == in-core extract_one bitwise, the "
          f"in-core rows == phase 7's shape and first-order columns bitwise; launches "
          f"{tstream_launches}")
    check_no_sweep(sweeps_warm, "stream")

    # -- 8. the tiled path ----------------------------------------------------
    # 8a. the window kernel (row 2) on 00001-1's bucket frame, cut into 4 windows
    img, msk, sp = cases["00001-1"]
    _, m_roi, _ = crop_to_roi(msk, msk)
    bshape = planlib.shape_bucket(tuple(s - 2 for s in m_roi.shape))
    frame = np.pad(m_roi, [(0, b - s) for b, s in zip(bshape, m_roi.shape)])
    frame_dev = torch.from_numpy(frame).to(dev)
    cz = mc.DEFAULT_CHUNK_Z
    ngran, ppg = mc.layout(bshape, cz)
    zpad = np.pad(frame, ((0, 0), (0, 0), (0, ngran * cz + 1 - bshape[2])))
    bounds = np.linspace(0, ngran, 5).round().astype(int)
    parts, slab_err = [], 0.0
    for k0, k1 in zip(bounds[:-1], bounds[1:]):
        win = torch.from_numpy(np.ascontiguousarray(zpad[:, :, k0 * cz:k1 * cz + 1])).to(dev)
        kv, ka = mc.mc_slab_partials(win, 0.5, sp, full_shape=bshape, k0=int(k0), chunk_z=cz)
        kv2, ka2 = mc.mc_slab_partials(win, 0.5, sp, full_shape=bshape, k0=int(k0), chunk_z=cz)
        check(torch.equal(kv, kv2) and torch.equal(ka, ka2), f"window {k0}: runs differ")
        pv, pa = ref.mc_slab_partials(win, 0.5, sp, full_shape=bshape, k0=int(k0), chunk_z=cz)
        got = torch.stack([kv.reshape(len(kv), -1).sum(1),
                           ka.reshape(len(ka), -1).sum(1)]).cpu().numpy()
        want = torch.stack([pv, pa]).cpu().numpy()
        # a granule's signed volume can sit near zero: atol 1e-3 there
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3,
                                   err_msg=f"window kernel vs plain, granules {k0}..{k1}")
        slab_err = max(slab_err, float(np.max(np.abs(got - want))))
        parts.append((kv, ka))
    full_v, full_a = (torch.cat([p[i] for p in parts]) for i in range(2))
    tv, ta = mc.mc_partials_finalize(full_v, full_a)
    iv, ia = mc.mc_volume_area(frame_dev, 0.5, sp)
    check(torch.equal(torch.stack([tv, ta]), torch.stack([iv, ia])),
          f"assembled windows' finalize {[tv.item(), ta.item()]} != in-core kernel "
          f"{[iv.item(), ia.item()]}")
    pv, pa = ref.mc_volume_area(frame_dev, 0.5, sp)
    np.testing.assert_allclose([tv.item(), ta.item()], [pv.item(), pa.item()], rtol=1e-5,
                               err_msg="assembled windows' finalize vs plain")
    fv, fa = ref.mc_partials_fold(full_v, full_a)
    fin_err = float(max(abs(tv.item() - fv.item()), abs(ta.item() - fa.item())))
    np.testing.assert_allclose([tv.item(), ta.item()], [fv.item(), fa.item()], rtol=1e-5,
                               err_msg="finalize kernel vs plain fold")
    print(f"[tiled] 00001-1 frame {bshape}: {ngran} granules x {ppg} parts; windows at "
          f"granules {bounds.tolist()}: each granule == plain (rtol 1e-5; max |diff| "
          f"{slab_err:.3e}), repeat bitwise; assembled finalize == in-core kernel bitwise "
          f"{[tv.item(), ta.item()]}, == plain (rtol 1e-5)")

    # 8b. the main path: 00001-1 out-of-core at 8 MiB, then the checks
    text = BatchedExtractor(families=TILED_FAMS, tiled=True, tile_mem_mb=8.0,
                            tile_prune="occupancy")
    case_t = (img, msk, sp)
    zero_counts()
    t0 = time.perf_counter()
    trows, tstats = text.run([case_t])
    tiled_s = [time.perf_counter() - t0]
    tiled_launches = read_counts()
    tiles = tstats["tiled"]
    print(f"[tmain] 00001-1 out-of-core: {tiled_s[0]:.3f} s; tiled {json.dumps({k: v for k, v in tiles.items() if k != 'census'})}; "
          f"launches {tiled_launches}")
    check(tiles["cases"] == 1 and tiles["tiles"] >= 8, f"00001-1 not tiled into >= 8: {tiles}")
    check(all(tiled_launches[k] > 0 for k in ("mc_slab_partials", "mc_partials_finalize",
                                              "fold_packed_chunks", "diameter",
                                              "masked_range")),
          f"a kernel of the tiled path never ran: {tiled_launches}")
    incore = BatchedExtractor(families=TILED_FAMS)
    oracle = incore.extract_one(img, msk, sp)
    check(np.array_equal(trows[0], oracle), f"tiled != extract_one: {trows[0]} vs {oracle}")
    cpu_row = BatchedExtractor(device="cpu", families=TILED_FAMS).extract_one(img, msk, sp)
    fo_exact = [9, 10, 11, 12, 13, 15]  # first-order min, max, P10, median, P90, entropy
    check(trows[0][6] == cpu_row[6] and np.array_equal(trows[0][fo_exact], cpu_row[fo_exact]),
          "tiled vertex count or exact first-order columns != the CPU path")
    np.testing.assert_allclose(trows[0], cpu_row, rtol=1e-4, err_msg="tiled vs the CPU path")
    with Recorder(mc, "mc_slab_partials") as rec_sl, \
            Recorder(mc, "mc_partials_finalize") as rec_fin, \
            Recorder(fo, "fold_packed_chunks") as rec_fold:
        res_none = BatchedExtractor(families=TILED_FAMS, tile_mem_mb=8.0,
                                    tile_prune="none").extract_tiled(case_t)
    check(np.array_equal(res_none.row, oracle), "tile_prune='none' != extract_one")
    res_b = BatchedExtractor(families=TILED_FAMS, tile_mem_mb=8.0,
                             tile_prune="bounds").extract_tiled(case_t)
    check(np.array_equal(res_b.row, oracle),
          f"tile_prune='bounds' != extract_one: {res_b.row} vs {oracle}")
    with text.executor.strict_syncs():
        strict = text.extract_tiled(case_t)
    check(np.array_equal(strict.row, oracle), "tiled row under CUDA sync debugging differs")
    print(f"[tmain] tiled == extract_one bitwise for prune none, occupancy and bounds; "
          f"== the CPU path (rtol 1e-4; count and exact first-order columns equal); "
          f"no host sync outside the counted fetches {strict.stats['host_fetches']}; host "
          f"seconds {strict.stats['seconds']}; tiles "
          f"none {res_none.stats['tiles']}/{res_none.stats['tiles_skipped']} skipped, bounds "
          f"{res_b.stats['tiles_bounds_pruned']} pruned; staged peak "
          f"{strict.stats['staged_bytes_peak']} (census {strict.stats['census_bytes_peak']}) "
          f"<= {8 * 2**20}")
    check(strict.stats["staged_bytes_peak"] <= 8 * 2**20, "00001-1 staged over budget")

    # every launch of the 'none' run against its plain version
    for args, kw in zip(rec_sl.calls, rec_sl.kwargs):
        kv, ka = mc.mc_slab_partials(*args, **kw)
        pv, pa = ref.mc_slab_partials(*args, **{k: v for k, v in kw.items() if k != "block"})
        got = torch.stack([kv.reshape(len(kv), -1).sum(1),
                           ka.reshape(len(ka), -1).sum(1)]).cpu().numpy()
        want = torch.stack([pv, pa]).cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3,
                                   err_msg=f"window launch k0={kw['k0']} vs plain")
        slab_err = max(slab_err, float(np.max(np.abs(got - want))))
    for args, _ in zip(rec_fin.calls, rec_fin.kwargs):
        kv, ka = mc.mc_partials_finalize(*args)
        fv, fa = ref.mc_partials_fold(*args)
        np.testing.assert_allclose([kv.item(), ka.item()], [fv.item(), fa.item()], rtol=1e-5)
        fin_err = max(fin_err, abs(kv.item() - fv.item()), abs(ka.item() - fa.item()))
    fold_err = 0.0
    for (x, m, lo, hi), kw in zip(rec_fold.calls, rec_fold.kwargs):
        got = fo.fold_packed_chunks(x, m, lo, hi, **kw)
        stack = (1, x.shape[0], 1, fo.CANON_CHUNK)
        plain = fo.firstorder_packed_batch_ref(x.reshape(stack), m.reshape(stack),
                                               kw.get("n_bins", fo.N_BINS),
                                               (lo.reshape(1), hi.reshape(1)))[0]
        fold_err = max(fold_err, float((got - plain).abs().max()))
        check(torch.equal(got, plain), "fold_packed_chunks kernel vs plain not bitwise")
    print(f"[tmain] every launch of the 'none' run vs plain: {len(rec_sl.calls)} windows "
          f"(rtol 1e-5), {len(rec_fin.calls)} finalize (rtol 1e-5), {len(rec_fold.calls)} "
          f"touched-chunk fold over {rec_fold.calls[0][0].shape[0]} chunks (bitwise)")

    # times, device times and bounds at the main path's shapes
    sargs, skw = max(zip(rec_sl.calls, rec_sl.kwargs), key=lambda c: c[0][0].numel())
    sv = sargs[0]
    w = (sv.shape[2] - 1) // skw["chunk_z"]
    slab_ms = time_ms(lambda: mc.mc_slab_partials(*sargs, **skw))
    slab_plain_ms = time_ms(lambda: ref.mc_slab_partials(
        *sargs, **{k: v for k, v in skw.items() if k != "block"}), reps=5, warmup=1)
    slab_dev, _ = device_trace(lambda: mc.mc_slab_partials(*sargs, **skw), reps=10)
    slab_bound, slab_tris = mc_bound_ms([sv], dev)
    slab_bound["bytes"] += 8 * (w - 1) / PEAK_BYTES_PER_S * 1e3  # (vol, area) per granule
    print(f"[tiled] window kernel at the largest launch {tuple(sv.shape)} ({w} granules, "
          f"{slab_tris} triangles): {slab_ms:.4f} ms/call (device "
          f"{kernel_us(slab_dev, ['mc_partials_kernel'])}), plain {slab_plain_ms:.4f} ms, "
          f"bound {max(slab_bound.values()):.5f} ms (bytes {slab_bound['bytes']:.5f}, ops "
          f"{slab_bound['operations']:.5f}); launches {tiled_launches['mc_slab_partials']}")
    fin_args = rec_fin.calls[0]
    nparts = fin_args[0].numel()
    fin_ms = time_ms(lambda: mc.mc_partials_finalize(*fin_args))
    fin_plain_ms = time_ms(lambda: ref.mc_partials_fold(*fin_args))
    fin_stack = torch.stack([fin_args[0].reshape(-1), fin_args[1].reshape(-1)])
    fin_lib_ms = time_ms(lambda: torch.sum(fin_stack, dim=1))
    fin_lib_dev = sum(device_split(lambda: torch.sum(fin_stack, dim=1)).values())
    fin_dev, _ = device_trace(lambda: mc.mc_partials_finalize(*fin_args), reps=10)
    fin_bound = {"bytes": (8 * nparts + 8) / PEAK_BYTES_PER_S * 1e3,
                 "operations": 2 * nparts / PEAK_FP32_PER_S * 1e3}
    print(f"[tiled] finalize over {nparts} x 2 partials: {fin_ms:.4f} ms/call (device "
          f"{kernel_us(fin_dev, ['mc_finalize_kernel'])}; the whole call "
          f"{sum(fin_dev.values()):.2f} us), plain {fin_plain_ms:.4f} ms, library "
          f"(torch.sum over the (2, n) stack) {fin_lib_ms:.4f} ms (device "
          f"{fin_lib_dev:.2f} us), bound "
          f"{max(fin_bound.values()):.6f} ms; launches {tiled_launches['mc_partials_finalize']}")
    (fx, fm, flo, fhi), fkw = rec_fold.calls[0], rec_fold.kwargs[0]
    fstack = (1, fx.shape[0], 1, fo.CANON_CHUNK)
    fold_ms = time_ms(lambda: fo.fold_packed_chunks(fx, fm, flo, fhi, **fkw))
    fold_plain_ms = time_ms(lambda: fo.firstorder_packed_batch_ref(
        fx.reshape(fstack), fm.reshape(fstack), fo.N_BINS, (flo.reshape(1), fhi.reshape(1))),
        reps=5, warmup=1)
    fold_dev, _ = device_trace(lambda: fo.fold_packed_chunks(fx, fm, flo, fhi, **fkw), reps=10)
    fold_masked = int((fm > 0).sum())
    fold_bound = rl.bound_ms(rl.intensity_work("firstorder", 1, fm.numel(), fold_masked, 0,
                                               fo.N_BINS), H100)
    print(f"[tiled] touched-chunk fold over {fx.shape[0]} chunks ({fold_masked} masked "
          f"voxels): {fold_ms:.4f} ms/call (device "
          f"{kernel_us(fold_dev, ['fo_partials_kernel', 'fo_fold_kernel'])}), plain "
          f"{fold_plain_ms:.4f} ms, bound {max(fold_bound.values()):.6f} ms (bytes); launches "
          f"{tiled_launches['fold_packed_chunks']}")
    del rec_sl, rec_fin, rec_fold

    # -- 5c. compaction, GLCM, first-order and MC against the parent's -------
    # (run here, after 8b: it reuses the inputs of phases 5, 7 and 8b)
    ab_kernels = (("compact", "compact_"), ("glcm", "glcm_"), ("firstorder", "fo_"),
                  ("marching_cubes", "mc_"))
    for name, tag in ab_kernels:
        lines = ptxas_lines(_build.library_path(name).with_suffix(".log").read_text(), tag)
        for line in lines:
            print(f"[ab5c] ptxas: {line}")
        check(lines and all("0 bytes spill stores, 0 bytes spill loads" in line
                            for line in lines if "spill" in line),
              f"{name}.cu: a kernel spills or printed no ptxas line: {lines}")
    if (Path(parent) / "src" / "repro_torch" / "csrc" / "glcm.cu").exists():
        libs = build_parent_libs(parent, {name: PARENT_SIGNATURES[name] for name, _ in ab_kernels})
        for name, tag in ab_kernels:
            for line in ptxas_lines(libs[name][1], tag):
                print(f"[ab5c] parent ptxas: {line}")
        afi, afm, afkw, agkw = fo_ab_in
        _, _, sp1 = cases["00001-1"]
        cp_lib, gl_lib = libs["compact"][0], libs["glcm"][0]
        fo_lib, mc_lib = libs["firstorder"][0], libs["marching_cubes"][0]

        def bits(label):
            def same(old, new):
                pairs = zip(old, new) if isinstance(old, tuple) else [(old, new)]
                check(all(torch.equal(a, b) for a, b in pairs),
                      f"{label}: the change's bits != the parent's")
            return same

        # (label, parent call, change call, check, kernel names, bound, source)
        cp_call = lambda: cp.compact_batch(cv, ck, ccap)  # noqa: E731
        gl_call = lambda: gl.glcm_matrix_batch(afi, afm, **agkw)  # noqa: E731
        fo_call = lambda: fo.firstorder_packed_batch(afi, afm, **afkw)  # noqa: E731
        fold_call = lambda: fo.fold_packed_chunks(fx, fm, flo, fhi, **fkw)  # noqa: E731
        mc1_call = lambda: mc.mc_volume_area(big_dev, 0.5, sp1)  # noqa: E731
        mcb_call = lambda: mc.mc_volume_area_batch(mv, miso, msps)  # noqa: E731
        slab_call = lambda: mc.mc_slab_partials(*sargs, **skw)  # noqa: E731
        fin_call = lambda: mc.mc_partials_finalize(*fin_args)  # noqa: E731
        ab_entries = [
            (f"compaction B={cb} M={cm_} cap={ccap}", with_lib("compact", cp_lib, cp_call),
             cp_call, bits("compaction"), ["compact_"], cp_bound, "compact"),
            (f"GLCM {tuple(afi.shape)}", with_lib("glcm", gl_lib, gl_call), gl_call,
             bits("GLCM"), ["glcm_"], gl_bound, "glcm"),
            (f"first-order {tuple(afi.shape)}", with_lib("firstorder", fo_lib, fo_call), fo_call,
             bits("first-order"), ["fo_partials_kernel", "fo_fold_kernel"], fo_bound,
             "firstorder"),
            (f"fold {fx.shape[0]} chunks", with_lib("firstorder", fo_lib, fold_call), fold_call,
             bits("fold"), ["fo_partials_kernel", "fo_fold_kernel"], fold_bound, "firstorder"),
            (f"MC 00001-1 {tuple(big_dev.shape)}", with_lib("marching_cubes", mc_lib, mc1_call),
             mc1_call, bits("MC 00001-1"), ["mc_partials_kernel", "mc_finalize_kernel"],
             mc_bound, "marching_cubes"),
            (f"MC stack {tuple(mv.shape)}", with_lib("marching_cubes", mc_lib, mcb_call),
             mcb_call, bits("MC stack"), ["mc_partials_kernel", "mc_finalize_kernel"],
             mcb_bound, "marching_cubes"),
            (f"MC window {tuple(sv.shape)}", with_lib("marching_cubes", mc_lib, slab_call),
             slab_call, bits("MC window"), ["mc_partials_kernel"], slab_bound,
             "marching_cubes"),
            (f"MC finalize {nparts} x 2", with_lib("marching_cubes", mc_lib, fin_call), fin_call,
             bits("MC finalize"), ["mc_finalize_kernel"], fin_bound, "marching_cubes"),
        ]
        # row 9's launch floor: an empty kernel on the compaction's grid, twice
        floor = cp.launch_floor(cb, cm_)
        ab5c, ab_clocks = kernel_ab([e[:5] for e in ab_entries]
                                    + [("compaction launch floor", floor, floor,
                                        lambda old, new: None, ["compact_empty_kernel"])])
        print("[ab5c] input                              parent ms (2 turns)  change ms (2 "
              "turns)  parent kernels us  change kernels us  parent call us  change call us"
              "  bound us  change/parent kernels")
        for (label, turns), entry in zip(ab5c, ab_entries + [None]):
            old, new = turns["old"], turns["new"]
            dn, do = (statistics.median(t[1] for t in turns_) for turns_ in (new, old))
            bound = max(entry[5].values()) * 1e3 if entry else 0.0
            print(f"[ab5c] {label:36s} {'/'.join(f'{t[0]:.4f}' for t in old):19s}  "
                  f"{'/'.join(f'{t[0]:.4f}' for t in new):19s}  "
                  f"{'/'.join(f'{t[1]:.2f}' for t in old):17s}  "
                  f"{'/'.join(f'{t[1]:.2f}' for t in new):17s}  "
                  f"{'/'.join(f'{t[2]:.2f}' for t in old):14s}  "
                  f"{'/'.join(f'{t[2]:.2f}' for t in new):14s}  {bound:8.3f}  "
                  + (f"{ratio(dn, do)} ({'below' if dn < do else 'NOT below'} the parent's)"
                     if dn > 0 and do > 0 else "not measured (a trace lost its kernels)"))
            per = [json.dumps({k[:40]: round(us, 2) for k, us in t[0][3].items()})
                   for t in (old, new)]
            print(f"[ab5c]   per kernel, parent {per[0]}; change {per[1]}")
            source = entry and entry[6]
            if source and (Path(parent) / "src/repro_torch/csrc" / f"{source}.cu").read_bytes() \
                    == (_build.CSRC / f"{source}.cu").read_bytes():
                print(f"[ab5c]   the same {source}.cu in both trees: a control")
            elif source:
                # the device times where both traces kept the kernels, else the events' ms
                got, was = ((dn, do) if dn > 0 and do > 0 else
                            (statistics.median(t[0] for t in new),
                             statistics.median(t[0] for t in old)))
                check(got < was, f"{label}: the change ({got:.4f}) is not below the parent "
                                 f"({was:.4f})")
        floor_us = statistics.median(t[1] for t in ab5c[-1][1]["new"])
        print(f"[ab5c] compaction launch floor (an empty kernel on the grid of B={cb} M={cm_} at "
              f"tile {cp.DEFAULT_BLOCK}): device {floor_us:.2f} us a launch, "
              f"{2 * floor_us:.2f} us for the kernel's two")
        print(f"[ab5c] parent {parent} vs this tree, same inputs, same bits; nvidia-smi over the "
              f"timed window: {ab_clocks}")
    else:
        print(f"[ab5c] no parent checkout at {parent} (unpack one with git archive, or pass "
              f"--parent): the A/B is not measured")

    incore_s = []
    for which in ("incore", "tiled", "tiled", "incore"):
        t0 = time.perf_counter()
        if which == "incore":
            incore.extract_one(img, msk, sp)
        else:
            text.run([case_t])
        torch.cuda.synchronize()
        (incore_s if which == "incore" else tiled_s).append(time.perf_counter() - t0)
    print(f"[tmain] 00001-1 wall, rounds in order in-core, tiled, tiled, in-core: tiled run "
          f"{[round(t, 4) for t in tiled_s[1:]]} s (counted run {tiled_s[0]:.4f}), in-core "
          f"extract_one {[round(t, 4) for t in incore_s]} s")
    per_kernel, wall_ms = device_trace(lambda: text.run([case_t]))
    busy_ms = sum(per_kernel.values()) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    print(f"[ttrace] 00001-1 tiled run: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f}; top: "
          + "; ".join(f"{k[:48]} {us:.1f} us" for k, us in top))

    # 8c. a 512^3 analytic sphere under 8 MiB == its in-core extract_one
    n_mid = 512
    fn_mid = sphere_slabs(n_mid, 0.42)
    check_no_sweep(sweeps_warm, "tmain")
    sph = BatchedExtractor(mc_chunk=4, tiled=True, tile_mem_mb=8.0, tile_prune="occupancy")
    # the default ('auto') tiled path's first use, on an empty cache of its
    # own: every lookup of the run is cold
    cold_file = cache_file + ".cold"
    os.environ["REPRO_AUTOTUNE_CACHE"] = cold_file
    sweeps0, sweep_s0 = autotune.SWEEPS, sweep_seconds()
    t0 = time.perf_counter()
    sph.extract_tiled(TiledCase(FnSlabSource(fn_mid, (n_mid,) * 3)))
    mid_cold_s = time.perf_counter() - t0
    swept = json.load(open(cold_file))["entries"]
    os.environ["REPRO_AUTOTUNE_CACHE"] = cache_file
    os.unlink(cold_file)
    check(autotune.SWEEPS - sweeps0 == len(swept) > 0, f"{n_mid}^3 cold run: {swept}")
    print(f"[tbig] {n_mid}^3 sphere, cold 'auto' run (an empty cache): {mid_cold_s:.3f} s, of "
          f"it {autotune.SWEEPS - sweeps0} sweep(s) {sweep_seconds() - sweep_s0:.3f} s; "
          + "; ".join(tuned_vs_default(k, v) for k, v in sorted(swept.items())))
    sweeps_mid = autotune.SWEEPS
    t0 = time.perf_counter()
    res_mid = sph.extract_tiled(TiledCase(FnSlabSource(fn_mid, (n_mid,) * 3)))
    mid_s = time.perf_counter() - t0
    vol_mid = fn_mid(0, n_mid)  # 512 MiB, materialised for the in-core oracle only
    t0 = time.perf_counter()
    oracle_mid = sph.extract_one(None, vol_mid, (1.0, 1.0, 1.0))
    mid_incore_s = time.perf_counter() - t0
    del vol_mid
    check(np.array_equal(res_mid.row, oracle_mid),
          f"{n_mid}^3 tiled {res_mid.row} != in-core {oracle_mid}")
    check(res_mid.stats["staged_bytes_peak"] <= 8 * 2**20, f"{n_mid}^3 staged over budget")
    r = n_mid * 0.42
    check(abs(res_mid.row[0] / (4 / 3 * np.pi * r ** 3) - 1) < 0.01, f"{n_mid}^3 volume")
    check_no_sweep(sweeps_mid, "tbig")
    print(f"[tbig] {n_mid}^3 sphere under 8 MiB (occupancy, mc_chunk 4), warm 'auto' run: "
          f"{mid_s:.3f} s, "
          f"in-core extract_one {mid_incore_s:.3f} s, == bitwise; tiles "
          f"{res_mid.stats['tiles']} ({res_mid.stats['tiles_skipped']} skipped), staged peak "
          f"{res_mid.stats['staged_bytes_peak']} B (census {res_mid.stats['census_bytes_peak']} "
          f"B); host seconds {res_mid.stats['seconds']}; "
          f"row {res_mid.row.tolist()}")

    # 8d. the out-of-core case: a 1024^3 sphere (4 GiB) under 64 MiB, never materialised
    n_big = TILED_BIG_N
    budget = 4 * n_big ** 3 // 64
    big_ext = BatchedExtractor(mc_chunk=4, tiled=True, tile_mem_mb=budget / 2**20, variant="seqacc",
                               tile_prune="bounds")
    resolve, big_caps = big_ext.executor._resolve_diameter, []
    big_ext.executor._resolve_diameter = lambda cap, depth=1: (
        big_caps.append((cap, depth)), resolve(cap, depth))[1]
    torch.cuda.reset_peak_memory_stats()
    res_big, big_wall, big_busy = traced(lambda: big_ext.extract_tiled(
        TiledCase(FnSlabSource(sphere_slabs(n_big, 0.45), (n_big,) * 3))))
    r = n_big * 0.45
    st = res_big.stats
    check(st["staged_bytes_peak"] <= budget, f"{n_big}^3 staged {st['staged_bytes_peak']} B")
    check(abs(res_big.row[0] / (4 / 3 * np.pi * r ** 3) - 1) < 0.005,
          f"{n_big}^3 volume {res_big.row[0]}")
    check(abs(res_big.row[2] / (2 * r) - 1) < 0.01, f"{n_big}^3 diameter {res_big.row[2]}")
    check(np.isfinite(res_big.row).all(), f"{n_big}^3 row not finite")
    print(f"[tbig] {n_big}^3 sphere ({4 * n_big ** 3 / 2**30:.0f} GiB) under {budget} B "
          f"(bounds, mc_chunk 4): wall {big_wall:.3f} s (traced), device busy "
          f"{big_busy:.3f} s, idle share {1 - big_busy / big_wall:.4f}; tiles {st['tiles']} "
          f"({st['tiles_skipped']} skipped, {st['tiles_bounds_pruned']} bounds-pruned), staged "
          f"peak {st['staged_bytes_peak']} B (census {st['census_bytes_peak']} B), device "
          f"memory peak "
          f"{torch.cuda.max_memory_allocated()} B; volume {res_big.row[0]:.1f} (analytic "
          f"{4 / 3 * np.pi * r ** 3:.1f}), 3D diameter {res_big.row[2]:.3f} (analytic "
          f"{2 * r:.3f}); {st['n_vertices']} vertices, {st['emitted_vertices']} emitted; "
          f"host_fetches {st['host_fetches']}; host seconds {st['seconds']}")
    check_no_sweep(sweeps_mid, "tbig")
    # what 'auto' would add to that run: an untimed sweep at its pruned bucket
    for cap, depth in big_caps:
        key = autotune.sweep_key(cap, "cuda", depth)
        cached = autotune.AutotuneCache().get(key) is not None
        sweep_s0 = sweep_seconds()
        autotune.get_diameter_config(cap, dev, batch=depth)
        print(f"[tbig] {n_big}^3 sphere's streamed pair at M{cap}/B{depth}: "
              + ("already cached" if cached else
                 f"cold sweep {sweep_seconds() - sweep_s0:.3f} s; ")
              + tuned_vs_default(key, autotune.AutotuneCache().get(key)))

    # -- 10. the auto knobs and the service (before 9, whose cold sweeps add
    # measured depths that could move the auto stream's windows) -------------
    old_bw = probe_phase(dev, smi)
    auto_phase(cohort_cases, frows, fext, sext)
    serve_phase()
    cli_phase()

    # -- 12. data parallelism over a mesh (before 9, as 10) --------------------
    data_parallel_phase(cohort_cases, frows, fstats, fam_launches)
    # 10f. (after 12, before 9's cold sweeps) the auto windows under the old probe
    probe_moves(cohort_cases, old_bw)

    # -- 9. the variant axis and the autotuner --------------------------------
    variants = ("seqacc",) + tuple(v for v in dm.VARIANTS if v != "seqacc")

    def agree(got, want, variant, what):
        """Direct variants bitwise, gram at rtol 1e-6; returns max |got - want|."""
        if variant == "gram":
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-6,
                                       err_msg=what)
        else:
            check(torch.equal(got, want), f"{what}: {got.tolist()} vs {want.tolist()}")
        return float((got - want).abs().max())

    # 9a. each kernel against its plain version and seqacc's kernel
    var_err = dict.fromkeys(variants, 0.0)
    for variant in variants:
        for label, v, keep in diam_inputs[1:]:
            for block in VARIANT_BLOCKS:
                k = dm.max_diameters_sq(v, keep, block=block, variant=variant)
                p = ref.max_diameters_sq(v, keep, block, variant)
                var_err[variant] = max(var_err[variant], agree(
                    k, p, variant, f"{variant} kernel vs plain, {label}, block {block}"))
                agree(k, dm.max_diameters_sq(v, keep, block=block), variant,
                      f"{variant} kernel vs seqacc's kernel, {label}, block {block}")
    print(f"[var] random M in (1, 2, 513, 4096) with masked slots x blocks {VARIANT_BLOCKS}: "
          f"every direct variant == its plain version == seqacc's kernel bitwise; gram within "
          f"rtol 1e-6 of both (max |kernel - plain| {var_err['gram']:.3e})")
    big_inputs = [("00001-1 unpruned", verts[None], vmask[None]),
                  (f"pass-2b stack {tuple(dv.shape[:2])}", dv, dk)]
    var_plain_ms = {}
    for label, x, m in big_inputs:
        base = dm.max_diameters_sq_batch(x, m)
        for variant in variants:
            k = dm.max_diameters_sq_batch(x, m, variant=variant)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            p = ref.max_diameters_sq_batch(x, m, dm.DEFAULT_BLOCK, variant)
            end.record()
            end.synchronize()
            var_plain_ms[label, variant] = start.elapsed_time(end)
            var_err[variant] = max(var_err[variant],
                                   agree(k, p, variant, f"{variant} kernel vs plain, {label}"))
            agree(k, base, variant, f"{variant} kernel vs seqacc's kernel, {label}")
            for block in VARIANT_BLOCKS:  # the plain version's bits do not depend on the block
                kb = dm.max_diameters_sq_batch(x, m, block=block, variant=variant)
                agree(kb, p, variant, f"{variant} kernel vs plain, {label}, block {block}")
                agree(kb, base, variant, f"{variant} kernel vs seqacc's, {label}, block {block}")
            for b in range(len(x)):
                check(torch.equal(k[b], dm.max_diameters_sq(x[b], m[b], variant=variant)),
                      f"{variant}: stack row {b} != its batch of one, {label}")
        print(f"[var] {label}: every variant's kernel at blocks {VARIANT_BLOCKS} vs its plain "
              f"version and seqacc's kernel (direct bitwise, gram rtol 1e-6), each row == its "
              f"batch of one bitwise; plain "
              f"ms (one call) " + ", ".join(f"{v} {var_plain_ms[label, v]:.1f}" for v in variants))
    gram_rel = 0.0
    for seed in range(6):
        cloud = paper_scale_cloud(seed)
        t = torch.from_numpy(cloud).to(dev)
        got = dm.max_diameters(t, torch.ones(len(t), dtype=torch.bool, device=dev), block=128,
                               variant="gram").double().cpu().numpy()
        want = diameters_f64(cloud)
        gram_rel = max(gram_rel, float(np.max(np.abs(got - want) / want)))
    check(gram_rel < 1e-3, f"gram vs the f64 oracle at paper scale: {gram_rel:.3e}")
    print(f"[var] gram vs the f64 oracle on 6 paper-scale clouds (384 vertices, 0.7x0.7x5 mm "
          f"x 512^3): largest relative error {gram_rel:.3e} (< 1e-3)")

    # 9b. the Fig. 1 table on the card
    fig1, fig1_dev = {}, {}
    print("[fig1] input                     variant       block   ms/call  device_us  "
          "bound_ms  work_ms(flop_estimate)  plain_ms")
    for label, x, m in big_inputs:
        bound, pairs = diam_bound_ms(m)
        for variant in variants:
            for block in VARIANT_BLOCKS:
                def call():
                    return dm.max_diameters_sq_batch(x, m, block=block, variant=variant)
                ms = time_ms(call, reps=10, warmup=2)
                per_kernel, _ = device_trace(call, reps=3)
                dev_us = sum(us for key, us in per_kernel.items() if "diameter_" in key)
                # the work this input's lists need of the variant (mask skips counted)
                fp32 = sum(dm.flop_estimate(x.shape[1], block, variant, mask=m[b])
                           for b in range(len(x)))
                fp64 = sum(dm.tensor_flop_estimate(x.shape[1], block, variant, mask=m[b])
                           for b in range(len(x)))
                n_pairs = sum(dm.computed_pairs(x.shape[1], block, variant, mask=m[b])
                              for b in range(len(x)))
                work_ms = max(fp32 / PEAK_FP32_PER_S, fp64 / PEAK_FP64_TC_PER_S) * 1e3
                fig1[label, variant, block] = ms
                fig1_dev[label, variant, block] = dev_us
                print(f"[fig1] {label:25s} {variant:12s} {block:5d} {ms:9.4f} {dev_us:10.2f} "
                      f"{max(bound.values()):9.5f} {work_ms:10.5f} ({n_pairs} pairs a launch, "
                      f"{fp32:.4g} FP32{f', {fp64:.4g} FP64 TC' if fp64 else ''})  "
                      f"{var_plain_ms[label, variant]:.1f}")
        print(f"[fig1] {label}: bound {max(bound.values()):.5f} ms = {pairs} valid pairs x "
              f"{DIAM_OPS_PER_PAIR} FP32 ops / 67 TFLOP/s; fastest "
              f"{min((k for k in fig1 if k[0] == label), key=fig1.get)[1:]}")
        # the Fig. 1 order: the scheduled walk at or below 'tri''s full grid
        print(f"[fig1] {label}: tri_prefetch / tri device time at blocks {VARIANT_BLOCKS}: "
              + ", ".join(
                  f"{ratio(fig1_dev[label, 'tri_prefetch', b], fig1_dev[label, 'tri', b])} "
                  + ("(at or below)" if fig1_dev[label, "tri_prefetch", b]
                     <= fig1_dev[label, "tri", b] else "(above)")
                  for b in VARIANT_BLOCKS))

    # 9c. the autotuner on the card: cold sweeps at two fresh keys, then hits
    cache = autotune.AutotuneCache()
    cold = [(b, d) for b, d in ((1024, 16), (4096, 8), (16384, 4), (65536, 2), (1536, 3),
                                (12288, 1))
            if cache.get(autotune.sweep_key(b, "cuda", d)) is None][:2]
    check(len(cold) == 2, "no two cold diameter keys left")
    for bucket, depth in cold:
        sweeps0 = autotune.SWEEPS
        cfg = autotune.get_diameter_config(bucket, dev, batch=depth)
        rec = cache.get(autotune.sweep_key(bucket, "cuda", depth))
        table = rec["table"]
        won = f"{cfg.variant}/{cfg.block}"
        check(autotune.SWEEPS == sweeps0 + 1 and table[won] == min(table.values())
              and won == f"{rec['variant']}/{rec['block']}",
              f"cold sweep M{bucket}/B{depth}: winner {cfg} is not its table's argmin {table}")
        zero_counts()
        again = autotune.get_diameter_config(bucket, dev, batch=depth)
        check(again == cfg and not any(read_counts().values()) and autotune.SWEEPS == sweeps0 + 1,
              f"the second lookup of M{bucket}/B{depth} launched or swept: {read_counts()}")
        print(f"[tune] cold M{bucket}/B{autotune.batch_bucket(depth)}: winner {cfg.variant}/"
              f"{cfg.block} = argmin of its table (us) "
              + ", ".join(f"{k} {us:.1f}" for k, us in sorted(table.items(), key=lambda kv: kv[1]))
              + "; a second lookup launched nothing")
    # the same sweep three times, uncached, at 00001-1's unpruned list and the
    # largest pass-2b stack: do the winners hold?
    for bucket, depth in ((verts.shape[0], 1), (dv.shape[1], dv.shape[0])):
        wins, seq = [], []
        for _ in range(3):
            best, table = autotune.sweep_diameter(bucket, dev, batch=depth)
            wins.append(f"{best.variant}/{best.block}")
            seq.append("/".join(f"{table[f'seqacc/{b}']:.1f}" for b in VARIANT_BLOCKS
                                if f"seqacc/{b}" in table))
        print(f"[tune] three sweeps at M{bucket}/B{depth}: winners {wins}; seqacc at blocks "
              f"{VARIANT_BLOCKS} (us) {seq}; last table "
              + ", ".join(f"{k} {us:.1f}" for k, us in sorted(table.items(),
                                                               key=lambda kv: kv[1])))
    sweeps_tuned = autotune.SWEEPS
    zero_counts()
    a_rows, a_stats = BatchedExtractor(variant="auto").run(cohort_cases)
    auto_launches = read_counts()
    a_rows = np.stack(a_rows)
    check(np.array_equal(a_rows, rows) and a_stats["host_fetches"] == bmain_fetches,
          f"variant='auto' rows or host fetches {a_stats['host_fetches']} differ from phase 6's")
    print(f"[tune] BatchedExtractor(variant='auto') over the {len(cohort)} cases: launches "
          f"{auto_launches}; rows == phase 6's bitwise, host_fetches {a_stats['host_fetches']}")

    # 9d. each variant's own main paths, counted
    var_single, var_batch, var_feats = {}, {}, {}
    img, msk, sp = cases["00001-1"]
    for variant in variants:
        vx = ShapeFeatureExtractor(diameter_variant=variant)
        zero_counts()
        t0 = time.perf_counter()
        var_feats[variant] = [vx.execute(*c[1:]) for c in suite]
        var_feats[variant].append(ShapeFeatureExtractor(diameter_variant=variant, prune=False)
                                  .execute(img, msk, sp))
        single_s = time.perf_counter() - t0
        var_single[variant] = read_counts()
        zero_counts()
        t0 = time.perf_counter()
        v_rows, v_stats = BatchedExtractor(variant=variant).run(cohort_cases)
        batch_s_v = time.perf_counter() - t0
        var_batch[variant] = read_counts()
        key = f"diameter[{variant}]"
        check(var_single[variant][key] > 0 and var_batch[variant][key] > 0
              and var_single[variant]["diameter"] == var_single[variant][key]
              and var_batch[variant]["diameter"] == var_batch[variant][key],
              f"{variant}: its kernel did not carry the path: {var_single[variant]}, "
              f"{var_batch[variant]}")
        check(v_stats["host_fetches"] == bmain_fetches,
              f"{variant}: host fetches {v_stats['host_fetches']} != phase 6's {bmain_fetches}")
        v_rows = np.stack(v_rows)
        got = np.array([[f[k] for k in DIAM_KEYS] for f in var_feats[variant]])
        want = np.array([[f[k] for k in DIAM_KEYS] for f in var_feats["seqacc"]])
        if variant == "gram":
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg="gram single-case diameters")
            np.testing.assert_allclose(v_rows, rows, rtol=1e-6, err_msg="gram batched rows")
        else:
            check(np.array_equal(got, want) and np.array_equal(v_rows, rows),
                  f"{variant}: single-case diameters or batched rows != seqacc's")
        print(f"[vmain] {variant:12s} single-case 20 cases + 00001-1 unpruned {single_s:.3f} s, "
              f"launches {var_single[variant][key]}; batched 60 cases {batch_s_v:.3f} s, "
              f"launches {var_batch[variant][key]}; single-case diameters == seqacc's, rows "
              f"== phase 6's 'auto' rows, {'rtol 1e-6' if variant == 'gram' else 'bitwise'}; "
              f"host_fetches as phase 6")
    check_no_sweep(sweeps_tuned, "vmain")

    # 9e. the library yardstick at 00001-1's list: torch.cdist (3D combo only)
    torch.cuda.empty_cache()
    valid = verts[vmask]
    lib_ms = time_ms(lambda: torch.cdist(valid, valid).amax(), reps=3, warmup=1)
    torch.cuda.empty_cache()
    print(f"[var] yardstick at 00001-1's {len(valid)} valid vertices: torch.cdist(v, v).amax() "
          f"{lib_ms:.4f} ms (3D combo only) vs seqacc {fig1['00001-1 unpruned', 'seqacc', 256]:.4f} "
          f"ms (all 4 combos)")

    # -- 11. the resilience layer ---------------------------------------------
    resil_phase(resil_dir, soak_stream, cohort, frows, sext, abandoned, cluster_rows,
                cache_file)
    shutil.rmtree(resil_dir)
    os.unlink(cache_file)

    # -- 13. the LLM scaffold's serving path (runs none of the kernels) -------
    models_phase(smi)

    # -- 14. the LLM scaffold's training path (runs none of the kernels) ------
    train_phase(smi)

    # -- 15. training over a mesh of slots (runs none of the kernels) ---------
    dist_phase(smi)

    # -- 16. tensor parallelism over the 'model' axis (runs none of the kernels)
    tp_phase(smi)

    # -- 17. the same for the hybrid, ssm and encdec families; pods ---------
    tp_families_phase(smi)

    # -- 18. a model laid out from its own blocks: no whole copy on the card --
    tp_blocks_phase(smi)

    # -- 19. every architecture one card holds, served at full width and depth
    serve_full_phase(smi)

    # -- 20. kernels line ---------------------------------------------------
    print(f"[done] the script took {time.perf_counter() - T_START:.1f} s of its 1,200 s")
    def entry(name, source, replaces, launches, err, ms, plain_ms, bound, library_ms):
        return {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(bound.values()),
                "bound_by": max(bound, key=bound.get), "library_ms": library_ms}

    kernels = [
        entry("mc_volume_area", "marching_cubes.cu", "src/repro/kernels/marching_cubes.py:98",
              launches["marching_cubes"], mc_err, mc_ms, mc_plain_ms, mc_bound, None),
        entry("max_diameters_sq", "diameter.cu", "src/repro/kernels/diameter.py:137",
              var_single["seqacc"]["diameter[seqacc]"], diam_err, diam_ms, diam_plain_ms,
              diam_bound, lib_ms),
        entry("compact_batch", "compact.cu", "src/repro/kernels/compact.py:80",
              batch_launches["compact"], cp_err, cp_ms, cp_plain_ms, cp_bound, cp_lib_ms),
        entry("mc_volume_area_batch", "marching_cubes.cu",
              "src/repro/kernels/marching_cubes.py:330", batch_launches["marching_cubes"],
              mcb_err, mcb_ms, mcb_plain_ms, mcb_bound, None),
        entry("max_diameters_sq_batch", "diameter.cu", "src/repro/kernels/diameter.py:137",
              var_batch["seqacc"]["diameter[seqacc]"], dmb_err, dmb_ms, dmb_plain_ms, dmb_bound,
              dmb_lib_ms),
        entry("firstorder_packed_batch", "firstorder.cu", "src/repro/kernels/firstorder.py:227",
              fam_launches["firstorder"], fo_err, fo_ms, fo_plain_ms, fo_bound, None),
        entry("glcm_matrix_batch", "glcm.cu", "src/repro/kernels/glcm.py:146",
              fam_launches["glcm"], gl_err, gl_ms, gl_plain_ms, gl_bound, None),
        # the port's own kernel: the reference takes the range outside any Pallas kernel
        entry("masked_range_batch", "masked_range.cu", "src/repro/kernels/ref.py:337",
              fam_launches["masked_range"], mr_err, mr_ms, mr_plain_ms, mr_bound, None),
        entry("mc_slab_partials", "marching_cubes.cu", "src/repro/kernels/marching_cubes.py:98",
              tiled_launches["mc_slab_partials"], slab_err, slab_ms, slab_plain_ms, slab_bound,
              None),
        entry("mc_partials_finalize", "marching_cubes.cu",
              "src/repro/kernels/marching_cubes.py:315", tiled_launches["mc_partials_finalize"],
              fin_err, fin_ms, fin_plain_ms, fin_bound, fin_lib_ms),
        entry("fold_packed_chunks", "firstorder.cu", "src/repro/kernels/firstorder.py:227",
              tiled_launches["fold_packed_chunks"], fold_err, fold_ms, fold_plain_ms, fold_bound,
              None),
    ] + [
        entry(f"max_diameters_sq[{v}]", "diameter.cu",
              f"src/repro/kernels/diameter.py:{VARIANT_REPLACES[v]}",
              var_single[v][f"diameter[{v}]"], var_err[v],
              fig1["00001-1 unpruned", v, AB_BLOCK], var_plain_ms["00001-1 unpruned", v],
              diam_bound, lib_ms)
        for v in variants if v != "seqacc"
    ]
    print(json.dumps({"kernels": kernels}))
    # -- 21. status -----------------------------------------------------------
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
